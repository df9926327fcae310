"""Single-process real-time pipeline: the MIMO heatmap path.

The reference spreads one dataflow across five+ processes (fork'd C
receiver, multiprocessing producers, viewer — ``main.pyx:669-736``,
SURVEY.md §3.2).  Here each stage is a thread around a device program,
sharing queues with the reference's drop-oldest backpressure
(``main.pyx:639-650``).

Ported so far: the backend policy that picks the heatmap device program,
:class:`HeatmapProducer` — fresh frame -> steered-power map -> ``q_power``
(the ``_loop_mimo_*`` producers, ``main.pyx:172-380``) — and the full-rate
:class:`BatchedHeatmapProducer`, which beamforms every frame in K-frame
device batches.  Listening, camera and tracker stages are later slices
(ROADMAP).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F_

from ..config import Config
from ..ingest.receiver import Receiver
from ..ops import beamform
from ..utils.metrics import PipelineMetrics

# Byte cap for the equiv paths' response planes, reckoned as the JAX
# package's two FP32 planes of (F, 2M, D): 16*D*M*F.  The port's kernels
# hold one plane (half that), but the formula stays the JAX policy's, so
# the port picks the backend the JAX policy picks.  The JAX package capped
# them at 2.4e9 B, 15% of a 16 GB v5e; the same share of the H100's 80 GB.
_EQUIV_PLANE_CAP = 0.15 * 80e9


def put_drop_oldest(q: queue.Queue, item) -> bool:
    """The reference's backpressure: full queue -> drop the oldest
    (``main.pyx:639-650``).  Returns False if the item was dropped instead."""
    try:
        q.put_nowait(item)
        return True
    except queue.Full:
        try:
            q.get_nowait()
        except queue.Empty:
            pass
        try:
            q.put_nowait(item)
            return True
        except queue.Full:
            return False


def _equiv_bar(tables) -> bool:
    """The delay-spread MAC bar + response-plane memory cap shared by the
    equiv-path selectors.  Per direction the time path costs ~T*M*N MACs,
    the equiv path ~4*M*F, so the ratio scales with the delay spread T;
    the bar excludes degenerate single-tap spreads.  Sizes are predicted
    via ``freq_equiv.equiv_dims`` so they track ``make_equiv_tables``."""
    from ..ops import freq_equiv

    D, T, M = tables.W.shape
    _, F = freq_equiv.equiv_dims(tables)
    return (T * tables.n_samples > 2 * 4 * F
            and 16 * D * M * F <= _EQUIV_PLANE_CAP)


def _equiv_tables_if_favored(tables):
    """The exact frequency-domain tables at the ``high`` rung when the
    equiv bar holds, else None."""
    from ..ops import freq_equiv

    if tables.precision != "high" or not _equiv_bar(tables):
        return None
    return freq_equiv.make_equiv_tables(tables)


def _equiv_kernel_if_favored(tables, et=None):
    """The fused equiv kernel (``ops.equiv_kernel``) for a shape inside
    the equiv bar, else None (also when no shared-memory plan fits)."""
    if not _equiv_bar(tables):
        return None
    from ..ops import equiv_kernel

    try:
        return equiv_kernel.FusedEquivBeamformer(
            et if et is not None else tables)
    except ValueError:                  # no shared-memory plan for the shape
        return None


def _select_power_backend(tables):
    """Production backend selection for the heatmap stage.

    Returns ``(kind, obj)``:

    * ``("equiv_kernel", FusedEquivBeamformer)`` — the fused equiv CUDA
      kernel, at the ``high`` and ``bf16`` rungs on a CUDA device;
    * ``("freq_equiv", EquivFreqTables)`` — the exact plain-torch
      frequency-domain path, at ``high`` shapes the kernel has no
      shared-memory plan for;
    * ``("fused", FusedBeamformer)`` — the fused time-domain CUDA kernel
      (``ops.fused_kernel``), at shapes the equiv bar excludes;
    * ``("xla", None)`` — the exact time-domain product
      (:func:`beamform.steered_power`): the ``highest`` rung's
      ground-truth contract, and CPU tensors.  The name is the JAX
      package's.
    """
    if tables.precision != "highest" and tables.device.type == "cuda":
        et = _equiv_tables_if_favored(tables)
        if et is not None:
            k = _equiv_kernel_if_favored(tables, et)
            if k is not None:
                return "equiv_kernel", k
            return "freq_equiv", et
        if tables.precision == "default":
            k = _equiv_kernel_if_favored(tables)
            if k is not None:
                return "equiv_kernel", k
        from ..ops.fused_kernel import FusedBeamformer

        # a K-looped kernel fits every shape: no loud fallback to the
        # exact product as on the TPU (``fits_vmem``)
        return "fused", FusedBeamformer(tables)
    return "xla", None


def default_power_fn(tables):
    """Production policy for the heatmap stage's device program.  The
    returned callable takes ``(M, N)`` frames and ``(B, M, N)`` batches
    (tensors on the tables' device) and returns (X, Y) / (B, X, Y)."""
    kind, obj = _select_power_backend(tables)
    if kind in ("equiv_kernel", "fused"):
        return obj            # __call__ squeezes 2-D frames
    if kind == "freq_equiv":
        from ..ops import freq_equiv

        return lambda f: freq_equiv.equiv_steered_power(f, obj)
    return lambda f: beamform.steered_power(f, tables)


def _pad_full(frames: torch.Tensor, n_full: int) -> torch.Tensor:
    """Device prologue shared by the full-rate stages: upcast f16-transfer
    batches and pad channel-sliced transfers back to the full mic axis
    (the tail rows are always zero)."""
    frames = frames.float()
    pad = n_full - frames.shape[1]
    if pad > 0:
        frames = F_.pad(frames, (0, 0, 0, pad))
    return frames


def _batched_power_program(tables, n_full):
    """The ``(B, Mc, N) -> (B, X, Y)`` device program of the full-rate
    stage: the production policy (:func:`default_power_fn`) behind the
    :func:`_pad_full` prologue.

    The JAX package builds it from ``_power_program_parts`` so that the
    tables enter its jit as arguments; PyTorch runs eagerly, so the
    policy's callable serves as it is, and the input buffer the stage
    reuses takes the place of the jit's input donation."""
    fn = default_power_fn(tables)
    return lambda frames: fn(_pad_full(frames, n_full))


class Stage(threading.Thread):
    def __init__(self, name: str, metrics: PipelineMetrics):
        super().__init__(name=name, daemon=True)
        self.stop_event = threading.Event()
        self.metric = metrics.stage(name)

    def stop(self):
        self.stop_event.set()


class HeatmapProducer(Stage):
    def __init__(self, receiver: Receiver, tables, q_power: queue.Queue,
                 metrics: PipelineMetrics, power_fn=None):
        super().__init__("heatmap", metrics)
        self.receiver = receiver
        self.tables = tables
        self.q_power = q_power
        self.device = tables.device
        self.power_fn = power_fn or default_power_fn(tables)

    def run(self):
        seq = 0
        while not self.stop_event.is_set():
            try:
                frame, seq = self.receiver.read_frame(fresh=True,
                                                      last_seq=seq,
                                                      timeout=1.0)
            except TimeoutError:
                continue
            t0 = time.perf_counter()
            x = torch.from_numpy(frame).to(self.device)
            power = self.power_fn(x).cpu().numpy()      # waits for the device
            self.metric.tick(time.perf_counter() - t0)
            if not put_drop_oldest(self.q_power, (power, seq)):
                self.metric.drop()


class _Slot:
    """One of the two transfer slots of a CUDA batched stage: a pinned
    host buffer, the device buffer the stage reuses, the event of the
    host->device copy out of the pinned buffer, and the event of the last
    launch that read the device buffer.  The stage thread waits on events
    that block (sleep) rather than spin: the ingest and the emulator need
    the host's cores."""

    def __init__(self, shape, dtype, device):
        self.host = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.dev = torch.empty(shape, dtype=dtype, device=device)
        self.copied = torch.cuda.Event(blocking=True)
        self.read = torch.cuda.Event()
        self.used = False


class BatchedStage(Stage):
    """Shared machinery for the full-rate stages: drain the receiver's
    frame ring in counter-contiguous K-frame batches, keep two batches in
    flight on the device, and hand each completed batch to
    :meth:`consume`.

    On CUDA each batch goes through one of two slots (:class:`_Slot`):
    it is copied into the slot's pinned host buffer, sent to the slot's
    device buffer by a ``non_blocking`` copy on a side stream, and the
    compute stream waits on that copy's event.  The result comes back by
    a ``non_blocking`` copy into pinned memory, so batch *i+1* is copied
    and launched while batch *i*'s result is still in flight.  A pinned
    buffer is refilled only after its last copy completed, and a device
    buffer only after the launch that read it.

    Subclasses implement ``launch(frames_dev) -> device tensor`` (must not
    block) and ``consume(host_array, first_seq, skipped)``.  Accounting:
    ``processed`` frames through the device, ``skipped`` frames the ring
    overwrote unread (0 = full rate sustained), ``metric`` per-batch
    latency.
    """

    def __init__(self, name: str, receiver: Receiver,
                 metrics: PipelineMetrics, batch: int, channels: int = 0,
                 transfer: str = "f32", device="cuda"):
        super().__init__(name, metrics)
        if batch > receiver.ring_frames:
            # fail fast: read_batch would raise inside the stage thread,
            # killing it silently while the pipeline runs output-less
            raise ValueError(
                f"batch ({batch}) exceeds the receiver ring capacity "
                f"({receiver.ring_frames}); raise Pipeline(ring_frames=)")
        self.receiver = receiver
        self.batch = batch
        self.channels = channels
        self.processed = 0
        self.skipped = 0
        # "f16" halves host->device traffic (~1e-3 relative error on the
        # 24-bit-normalized samples), an explicit display-grade opt-in;
        # device programs upcast to f32 on arrival.  Default: exact f32.
        self.transfer_dtype = {"f32": torch.float32,
                               "f16": torch.float16}[transfer]
        self.device = beamform.resolve_device(device)
        self._slots = None
        self._next_slot = 0
        self._copy_stream = None

    def _slot_for(self, shape) -> _Slot:
        if self._slots is None or tuple(self._slots[0].host.shape) != shape:
            self._copy_stream = torch.cuda.Stream(self.device)
            self._slots = [_Slot(shape, self.transfer_dtype, self.device)
                           for _ in range(2)]
        slot = self._slots[self._next_slot]
        self._next_slot ^= 1
        return slot

    def launch(self, frames_dev):
        raise NotImplementedError

    def consume(self, out: np.ndarray, first_seq: int,
                skipped: int) -> None:
        raise NotImplementedError

    def _dispatch(self, batch: np.ndarray):
        """Copy ``batch`` to the device and launch on it; returns the
        (host output, done event) pair :meth:`_finish` waits on."""
        x = torch.from_numpy(batch)
        if self.device.type != "cuda":
            out = self.launch(x.to(self.device, self.transfer_dtype))
            return out, None
        slot = self._slot_for(tuple(x.shape))
        slot.copied.synchronize()         # the pinned buffer is free again
        slot.host.copy_(x)                # host copy (f16 rounding here)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            if slot.used:                 # the device buffer's last reader
                self._copy_stream.wait_event(slot.read)
            slot.dev.copy_(slot.host, non_blocking=True)
            slot.copied.record(self._copy_stream)
        compute.wait_event(slot.copied)
        out = self.launch(slot.dev)
        slot.read.record(compute)
        slot.used = True
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event(blocking=True)
        done.record(compute)
        return host, done

    def warmup(self):
        """Build the kernels and first-call state before any packets flow
        (a first build mid-run stalls the stage and drops frames)."""
        n_ch = self.channels or self.receiver.cfg.n_microphones
        zeros = np.zeros((self.batch, n_ch, self.receiver.cfg.n_samples),
                         np.float32)
        host, done = self._dispatch(zeros)
        if done is not None:
            done.synchronize()

    def _finish(self, pending):
        host, done, first, skipped, t0 = pending
        if done is not None:
            done.synchronize()                   # batch i-1 is on the host
        self.metric.tick(time.perf_counter() - t0)
        if skipped:
            self.skipped += skipped
            self.metric.drop(skipped)
        self.processed += self.batch
        self.consume(host.numpy(), first, skipped)

    def run(self):
        # stream-start anchor: consume everything the ring still holds,
        # but a pre-start backlog beyond the ring must not count as skips
        next_seq = self.receiver.stream_anchor_seq
        pending = None
        while not self.stop_event.is_set():
            try:
                batch, first, skipped = self.receiver.read_batch(
                    self.batch, next_seq, timeout=0.5,
                    channels=self.channels)
            except TimeoutError:
                if pending is not None:
                    self._finish(pending)
                    pending = None
                continue
            next_seq = first + self.batch
            t0 = time.perf_counter()
            host, done = self._dispatch(batch)   # copy + launch, no wait
            if pending is not None:
                self._finish(pending)           # batch i-1, in order
            pending = (host, done, first, skipped, t0)
        if pending is not None:
            self._finish(pending)


class BatchedHeatmapProducer(BatchedStage):
    """Full-line-rate heatmap stage: EVERY frame beamformed, not
    latest-frame sampling.

    The reference's consumer snapshots whichever frame is newest
    (``get_data``, ``api.c:830-859``) and silently discards the rest even
    though the receiver writes all of them (``receiver.c:94-151``).  This
    stage drains the receiver's frame ring in counter-contiguous batches
    of K and runs ONE batched ``(K, M, N) -> (K, X, Y)`` device program
    per batch (:class:`BatchedStage` keeps two in flight).

    ``sink(powers (K, X, Y) float32, first_seq)`` receives every batch in
    order; the default sink publishes the newest heatmap of each batch to
    ``q_power`` (display semantics).  Accounting: ``processed`` counts
    beamformed frames, ``skipped`` counts frames the ring overwrote unread
    (the drop metric; 0 = full rate sustained), ``metric`` records
    per-batch latency.
    """

    def __init__(self, receiver: Receiver, tables, q_power: queue.Queue,
                 metrics: PipelineMetrics, batch: int = 16,
                 power_fn=None, sink=None, channels: int = 0,
                 transfer: str = "f32"):
        super().__init__("heatmap_batched", receiver, metrics, batch,
                         channels, transfer, device=tables.device)
        self.tables = tables
        self.q_power = q_power
        self.sink = sink or self._default_sink
        n_full = receiver.cfg.n_microphones
        if power_fn is None:
            power_fn = _batched_power_program(tables, n_full)
        elif (channels and channels < n_full) or transfer != "f32":
            # a custom power_fn takes full-width f32 (B, M, N) batches:
            # restore them first, or the active-mic gather would index
            # past the sliced rows
            base_fn = power_fn
            power_fn = lambda frames: base_fn(_pad_full(frames, n_full))  # noqa: E731
        self.power_fn = power_fn

    def _default_sink(self, powers: np.ndarray, first_seq: int):
        # display drop only; processing was already counted
        put_drop_oldest(self.q_power,
                        (powers[-1], first_seq + len(powers) - 1))

    def launch(self, frames_dev):
        return self.power_fn(frames_dev)

    def consume(self, powers, first_seq: int, skipped: int):
        self.sink(powers, first_seq)


class Pipeline:
    """Owns the receiver + stages; the ``mimo()`` orchestration layer
    (``main.pyx:669-736``) as one object.

    ``device`` is explicit (``"cuda"`` by default); asking for CUDA with no
    GPU present raises.  ``power_backend``: ``"auto"`` (the policy of
    :func:`_select_power_backend`), ``"freq_equiv"`` (the exact plain-torch
    frequency path) or ``"equiv_kernel"`` (force the fused kernel, in the
    mode the tables' precision picks — ``f32`` at ``highest``).
    ``power_fn``: a callable of the heatmap stages' own, e.g.
    ``ops.fused_kernel.FusedBeamformer(tables)``, exclusive with a
    ``power_backend`` other than ``"auto"``.  ``ring_frames``: the
    receiver's frame ring, which bounds the full-rate stage's batch."""

    def __init__(self, cfg: Optional[Config] = None, algorithm: str = "lerp",
                 replay_mode: bool = False, backend: str = "auto",
                 power_backend: str = "auto", device="cuda",
                 power_fn=None, ring_frames: int = 64):
        self.cfg = cfg or Config()
        self.device = beamform.resolve_device(device)
        beamform.set_fp32_matmul()
        self.metrics = PipelineMetrics()
        if power_backend not in ("auto", "freq_equiv", "equiv_kernel"):
            raise ValueError(f"unknown power backend {power_backend!r}")
        if power_fn is not None and power_backend != "auto":
            # silently dropping the explicit backend request would leave
            # the user believing that backend is running
            raise ValueError(
                f"power_backend={power_backend!r} conflicts with a custom "
                f"power_fn: the backend flag selects how the time-domain "
                f"steered power is computed, which a custom power_fn "
                f"replaces entirely; pass one or the other")
        self.tables = beamform.make_tables(self.cfg, algorithm,
                                           device=self.device)
        if power_backend == "freq_equiv":
            from ..ops import freq_equiv

            et = freq_equiv.make_equiv_tables(self.tables)
            power_fn = lambda f: freq_equiv.equiv_steered_power(f, et)  # noqa: E731
        elif power_backend == "equiv_kernel":
            from ..ops import equiv_kernel

            power_fn = equiv_kernel.FusedEquivBeamformer(self.tables)
        self.receiver = Receiver(self.cfg, replay_mode=replay_mode,
                                 backend=backend, ring_frames=ring_frames)
        self.q_power: queue.Queue = queue.Queue(maxsize=2)
        self.stages = []
        self._power_fn = power_fn

    # -- bring-up -------------------------------------------------------------

    def connect(self, timeout: float = 30.0) -> int:
        return self.receiver.connect(timeout=timeout)

    def start_heatmap(self, warmup: bool = True):
        s = HeatmapProducer(self.receiver, self.tables, self.q_power,
                            self.metrics, power_fn=self._power_fn)
        if warmup:
            # build kernels and first-call state before the thread starts so
            # the first live frame is not delayed by them
            zeros = torch.zeros((self.cfg.n_microphones, self.cfg.n_samples),
                                device=self.device)
            s.power_fn(zeros).cpu()
        self.stages.append(s)
        s.start()
        return s

    def make_heatmap_batched(self, batch: int = 16, sink=None,
                             channels: int = 0, transfer: str = "f32"):
        """Build (but don't start) the full-line-rate stage, so callers can
        :meth:`BatchedHeatmapProducer.warmup` before any packets flow and
        :meth:`run_stage` it after :meth:`connect`."""
        return BatchedHeatmapProducer(self.receiver, self.tables,
                                      self.q_power, self.metrics,
                                      batch=batch, power_fn=self._power_fn,
                                      sink=sink, channels=channels,
                                      transfer=transfer)

    def run_stage(self, s):
        self.stages.append(s)
        s.start()
        return s

    def start_heatmap_batched(self, batch: int = 16, sink=None,
                              warmup: bool = True):
        """Full-line-rate variant of :meth:`start_heatmap`: every frame
        beamformed in K-frame device batches."""
        s = self.make_heatmap_batched(batch=batch, sink=sink)
        if warmup:
            s.warmup()
        return self.run_stage(s)

    # -- teardown --------------------------------------------------------------

    def stop(self):
        for s in self.stages:
            s.stop()
        for s in self.stages:
            s.join(timeout=2.0)
        self.receiver.disconnect()

    def report(self):
        rep = self.metrics.report()
        stats = self.receiver.native_stats
        rep["ingest"] = {"packets": stats.packets, "frames": stats.frames,
                         "gaps": stats.gaps}
        # full-rate stage accounting: frames through the device and frames
        # the ring overwrote unread
        for s in self.stages:
            if hasattr(s, "skipped"):
                rep.setdefault(s.name, {}).update(processed=s.processed,
                                                  skipped=s.skipped)
        return rep
