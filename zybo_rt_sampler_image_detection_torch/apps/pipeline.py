"""Single-process real-time pipeline: imaging and listening.

The reference spreads one dataflow across five+ processes (fork'd C
receiver, fork'd MISO child, multiprocessing producers, viewer —
``main.pyx:669-736``, SURVEY.md §3.2).  Here each stage is a thread around
a device program, sharing queues with the reference's drop-oldest
backpressure (``main.pyx:639-650``).

Stages ported so far:

* :class:`HeatmapProducer` — fresh frame -> steered-power map -> q_power
  (the ``_loop_mimo_*`` producers, ``main.pyx:172-380``), through the
  backend policy that picks the heatmap device program;
* :class:`BatchedHeatmapProducer` — every frame, in K-frame device batches;
* :class:`MisoProducer` — fresh frame -> steered beam -> gain -> audio
  sink, steerable live (``api.c:491-543`` miso_loop);
* :class:`BatchedMisoProducer` — gapless listening: every frame beamed;
* :class:`BatchedMimoMisoProducer` — heatmaps and the beam from one
  transfer per batch (``_loop_mimo_and_miso_*``, ``main.pyx:279-380``).

Steering: :meth:`Pipeline.steer_cartesian_degree` /
:meth:`Pipeline.steer_click` mirror ``main.pyx:498-528``; the direction
indexes the tables on the device, so a steer needs no host sync and no
rebuild.  The MVDR beam, camera and tracker stages are later slices
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
from ..utils import audio as audio_mod
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

    Subclasses implement ``launch(frames_dev) -> device tensor`` or a
    tuple of them (must not block) and ``consume(host_output, first_seq,
    skipped, stamps=None)``, which gets a NumPy array or a tuple of them
    in the same shape.  A subclass that sets ``want_stamps`` gets each
    batch's per-frame ring publish times (``time.perf_counter`` seconds)
    as ``stamps``.  Accounting: ``processed`` frames through the device,
    ``skipped`` frames the ring overwrote unread (0 = full rate
    sustained), ``metric`` per-batch latency.
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
        # subclasses that need per-frame ring publish times (the audio
        # e2e latency contract) set this before start()
        self.want_stamps = False

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

    def consume(self, out, first_seq: int, skipped: int,
                stamps=None) -> None:
        raise NotImplementedError

    def _dispatch(self, batch: np.ndarray):
        """Copy ``batch`` to the device and launch on it; returns the
        (host output, done event) pair :meth:`_finish` waits on.  Each
        tensor ``launch`` returns gets its own pinned host tensor; one
        event marks all of their copies done."""
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
        outs = out if isinstance(out, tuple) else (out,)
        hosts = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                      for o in outs)
        for h, o in zip(hosts, outs):
            h.copy_(o, non_blocking=True)
        done = torch.cuda.Event(blocking=True)
        done.record(compute)
        return (hosts if isinstance(out, tuple) else hosts[0]), done

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
        host, done, first, skipped, t0, stamps = pending
        if done is not None:
            done.synchronize()                   # batch i-1 is on the host
        self.metric.tick(time.perf_counter() - t0)
        if skipped:
            self.skipped += skipped
            self.metric.drop(skipped)
        self.processed += self.batch
        out = (tuple(np.asarray(h) for h in host) if isinstance(host, tuple)
               else np.asarray(host))
        self.consume(out, first, skipped, stamps)

    def run(self):
        # stream-start anchor: consume everything the ring still holds,
        # but a pre-start backlog beyond the ring must not count as skips
        next_seq = self.receiver.stream_anchor_seq
        pending = None
        while not self.stop_event.is_set():
            try:
                res = self.receiver.read_batch(
                    self.batch, next_seq, timeout=0.5,
                    channels=self.channels, with_stamps=self.want_stamps)
            except TimeoutError:
                if pending is not None:
                    self._finish(pending)
                    pending = None
                continue
            batch, first, skipped = res[:3]
            stamps = res[3] if self.want_stamps else None
            next_seq = first + self.batch
            t0 = time.perf_counter()
            host, done = self._dispatch(batch)   # copy + launch, no wait
            if pending is not None:
                self._finish(pending)           # batch i-1, in order
            pending = (host, done, first, skipped, t0, stamps)
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

    def consume(self, powers, first_seq: int, skipped: int, stamps=None):
        self.sink(powers, first_seq)


def _check_beam(beam: str) -> None:
    """The listening stages' beam backends: delay-and-sum only so far."""
    if beam == "mvdr":
        raise ValueError("beam='mvdr' (the streaming-MVDR beam) is not yet "
                         "ported (ROADMAP queue 1, item 10)")
    if beam != "time":
        raise ValueError(f"unknown beam backend {beam!r}")


class MisoProducer(Stage):
    """Live steered listening (``miso_loop``, ``api.c:491-543``): the
    newest frame -> its beam toward the steered direction -> the
    reference's gain chain -> the audio sink, one frame at a time
    (``get_data`` semantics: frames that arrive meanwhile are skipped)."""

    def __init__(self, receiver: Receiver, tables, cfg: Config,
                 sink: audio_mod.AudioSink, metrics: PipelineMetrics):
        super().__init__("miso", metrics)
        self.receiver = receiver
        self.tables = tables
        self.cfg = cfg
        self.sink = sink
        self._direction = 0
        self._lock = threading.Lock()

    def steer(self, direction: int):
        """``api.c:576-581``: mutate the steer offset live."""
        with self._lock:
            self._direction = int(direction)

    def beam(self, frame: np.ndarray) -> np.ndarray:
        """One (n_channels, N) frame's audio: its beam toward the steered
        direction, scaled by the gain chain (``api.c:517-522``)."""
        with self._lock:
            d = self._direction
        x = torch.from_numpy(frame).to(self.tables.device)
        beam = beamform.miso_beam(x, self.tables, d).cpu().numpy()
        out = audio_mod.miso_gain(beam, self.tables.n_mics,
                                  self.cfg.mic_gain,
                                  self.cfg.norm_factor_sound)
        return out.astype(np.float32)

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
            self.sink.write(self.beam(frame))     # waits for the device
            self.metric.tick(time.perf_counter() - t0)


class AudioLeg:
    """Gapless-audio accounting of the full-rate listening stages:
    zero-fills frames lost to ring overwrites so the stream stays
    sample-count exact, counts samples/underruns, and measures the
    packet->sink e2e latency contract from the ring publish stamps (the
    reference's PortAudio callback ran at ms scale, ``api.c:268-282``)."""

    def __init__(self, sink: audio_mod.AudioSink, post_fn,
                 n_samples: int):
        self.sink = sink
        self.post_fn = post_fn
        self.n_samples = n_samples
        self.underrun_frames = 0
        self.samples = 0
        self.lat_oldest_ms: list = []
        self.lat_newest_ms: list = []

    def write(self, beams: np.ndarray, skipped: int, stamps=None):
        if skipped:
            # keep the stream time-aligned: silence for the lost frames
            self.underrun_frames += skipped
            gap = np.zeros(skipped * self.n_samples, np.float32)
            self.sink.write(gap)
            self.samples += gap.size
        audio = self.post_fn(beams).reshape(-1).astype(np.float32)
        self.sink.write(audio)
        self.samples += audio.size
        if stamps is not None:
            s = stamps[stamps > 0]
            if s.size:
                now = time.perf_counter()
                self.lat_oldest_ms.append((now - float(s.min())) * 1e3)
                self.lat_newest_ms.append((now - float(s.max())) * 1e3)

    def latency(self) -> dict:
        """p50/p95 of the per-batch oldest-frame age at sink write — the
        measured end-to-end playback lag (packet ring -> audio sink)."""
        if not self.lat_oldest_ms:
            return {}
        old = np.asarray(self.lat_oldest_ms)
        new = np.asarray(self.lat_newest_ms)
        return {
            "audio_e2e_p50_ms": round(float(np.percentile(old, 50)), 2),
            "audio_e2e_p95_ms": round(float(np.percentile(old, 95)), 2),
            "audio_e2e_newest_p50_ms":
                round(float(np.percentile(new, 50)), 2),
        }


class BatchedMisoProducer(BatchedStage):
    """Full-rate (gapless) steered LISTENING: every frame beamed, in
    counter-contiguous batches.

    The reference's whole point of MISO is *continuous* playback — its
    miso_loop feeds a PortAudio ring at line rate (``api.c:491-543``).
    :class:`MisoProducer` keeps the reference's get_data semantics
    (latest-frame snapshots, ``api.c:830-859``), which can skip frames in
    the audio stream; this stage instead drains the frame ring in
    counter-contiguous K-frame batches, runs ONE batched ``(K, M, N) ->
    (K, N)`` beam program, and writes the concatenated samples to the
    sink — a gapless 48,828 samples/s stream.  Frames the ring overwrote
    unread are zero-filled (and counted in ``underrun_frames``) so the
    output stays sample-count exact.

    ``beam_fn(frames_dev (K, M, N), direction int) -> (K, N)``: the
    delay-and-sum default comes from :meth:`Pipeline.make_miso_batched`.
    Steering (:meth:`steer`) is live (``api.c:576-581``).

    Accounting: ``processed`` frames beamed, ``underrun_frames`` frames
    lost to ring overwrites (0 = gapless), ``samples`` written to the
    sink, ``metric`` per-batch latency, :meth:`audio_latency` the e2e
    playback lag from the ring publish stamps.
    """

    def __init__(self, receiver: Receiver, sink: audio_mod.AudioSink,
                 metrics: PipelineMetrics, batch: int, beam_fn, post_fn,
                 n_samples: int, channels: int = 0,
                 name: str = "miso_batched", transfer: str = "f32",
                 device="cuda"):
        super().__init__(name, receiver, metrics, batch, channels, transfer,
                         device=device)
        self.sink = sink
        self.beam_fn = beam_fn
        self.post_fn = post_fn
        self.n_samples = n_samples
        self._direction = 0
        self._lock = threading.Lock()
        # audio e2e latency contract: per-batch age (at sink.write) of
        # the batch's OLDEST and NEWEST frames, measured from their ring
        # publish stamps (AudioLeg).  The oldest-frame age is the
        # stream's playback lag — what a listener actually experiences.
        self.want_stamps = True
        self._audio = AudioLeg(sink, post_fn, n_samples)

    @property
    def underrun_frames(self) -> int:
        return self._audio.underrun_frames

    @property
    def samples(self) -> int:
        return self._audio.samples

    def steer(self, direction: int):
        with self._lock:
            self._direction = int(direction)

    def _steered(self) -> int:
        with self._lock:
            return self._direction

    def launch(self, frames_dev):
        return self.beam_fn(frames_dev, self._steered())

    def audio_latency(self) -> dict:
        return self._audio.latency()

    def consume(self, beams, first_seq: int, skipped: int, stamps=None):
        self._audio.write(beams, skipped, stamps)


class BatchedMimoMisoProducer(BatchedMisoProducer):
    """Combined full-rate MIMO + MISO: ONE host->device transfer per batch
    serves BOTH the heatmap and the listening output.

    The reference runs imaging and listening off the same shared-memory
    frames (``_loop_mimo_and_miso_*``, ``main.pyx:279-380``); here the
    shared resource is the host->device copy — two separate batched
    stages would each transfer the same frames — so this stage transfers
    once and runs ``process_fn(frames_dev, direction) -> (powers (K, X,
    Y), beams (K, N))`` on the one device batch.  Heatmaps go to
    ``power_sink`` (default: newest-of-batch to ``q_power``); audio
    follows the gapless zero-fill contract of :class:`BatchedMisoProducer`.
    """

    def __init__(self, receiver: Receiver, sink: audio_mod.AudioSink,
                 metrics: PipelineMetrics, batch: int, process_fn, post_fn,
                 n_samples: int, q_power: queue.Queue, power_sink=None,
                 channels: int = 0, transfer: str = "f32", device="cuda"):
        super().__init__(receiver, sink, metrics, batch, beam_fn=None,
                         post_fn=post_fn, n_samples=n_samples,
                         channels=channels, name="mimo_miso_batched",
                         transfer=transfer, device=device)
        self.process_fn = process_fn
        self.q_power = q_power
        self.power_sink = power_sink or self._default_power_sink

    def _default_power_sink(self, powers: np.ndarray, first_seq: int):
        put_drop_oldest(self.q_power,
                        (powers[-1], first_seq + len(powers) - 1))

    def launch(self, frames_dev):
        return self.process_fn(frames_dev, self._steered())

    def consume(self, out, first_seq: int, skipped: int, stamps=None):
        powers, beams = out
        self.power_sink(powers, first_seq)
        self._audio.write(beams, skipped, stamps)


class Pipeline:
    """Owns the receiver + stages; the ``mimo()``/``miso()`` orchestration
    layer (``main.pyx:669-736,824-864``) as one object.

    ``device`` is explicit (``"cuda"`` by default); asking for CUDA with no
    GPU present raises.  ``power_backend``: ``"auto"`` (the policy of
    :func:`_select_power_backend`), ``"freq_equiv"`` (the exact plain-torch
    frequency path) or ``"equiv_kernel"`` (force the fused kernel, in the
    mode the tables' precision picks — ``f32`` at ``highest``).
    ``power_fn``: a callable of the heatmap stages' own, e.g.
    ``ops.fused_kernel.FusedBeamformer(tables)``, exclusive with a
    ``power_backend`` other than ``"auto"``.  ``ring_frames``: the
    receiver's frame ring, which bounds the full-rate stage's batch.
    ``audio_sink``/``audio_path``: the listening stages' default sink
    (:func:`utils.audio.make_sink` kind and WAV path)."""

    def __init__(self, cfg: Optional[Config] = None, algorithm: str = "lerp",
                 replay_mode: bool = False, backend: str = "auto",
                 power_backend: str = "auto", device="cuda",
                 power_fn=None, ring_frames: int = 64,
                 audio_sink: str = "null", audio_path: Optional[str] = None):
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
        self._audio_sink_kind = audio_sink
        self._audio_path = audio_path
        # the listening stage that steering reaches (and whose sink
        # stop() closes)
        self._miso = None

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

    # -- listening ---------------------------------------------------------------

    def _sink(self, sink=None) -> audio_mod.AudioSink:
        if sink is not None:
            return sink
        return audio_mod.make_sink(self._audio_sink_kind,
                                   self.cfg.sample_rate, self._audio_path)

    def _gain(self, beams: np.ndarray) -> np.ndarray:
        """The reference's gain chain on raw beams (``api.c:517-522``)."""
        return audio_mod.miso_gain(beams, self.tables.n_mics,
                                   self.cfg.mic_gain,
                                   self.cfg.norm_factor_sound)

    def start_miso(self, warmup: bool = True,
                   sink: Optional[audio_mod.AudioSink] = None):
        """Live listening: the newest frame's beam to the audio sink."""
        s = MisoProducer(self.receiver, self.tables, self.cfg,
                         self._sink(sink), self.metrics)
        if warmup:
            s.beam(np.zeros((self.cfg.n_microphones, self.cfg.n_samples),
                            np.float32))
        self._miso = s
        self.stages.append(s)
        s.start()
        return s

    def make_miso_batched(self, batch: int = 16, beam: str = "time",
                          channels: int = 0,
                          sink: Optional[audio_mod.AudioSink] = None,
                          transfer: str = "f32"):
        """Build (don't start) the full-rate listening stage: batched
        delay-and-sum (:func:`beamform.miso_beam`) through this pipeline's
        tables, with the reference's gain chain (``api.c:517-522``)."""
        _check_beam(beam)
        tables, n_full = self.tables, self.cfg.n_microphones

        def beam_fn(frames, d):
            return beamform.miso_beam(_pad_full(frames, n_full), tables, d)

        s = BatchedMisoProducer(self.receiver, self._sink(sink),
                                self.metrics, batch, beam_fn, self._gain,
                                self.cfg.n_samples, channels=channels,
                                transfer=transfer, device=self.device)
        self._miso = s
        return s

    def make_mimo_miso_batched(self, batch: int = 16, beam: str = "time",
                               channels: int = 0,
                               sink: Optional[audio_mod.AudioSink] = None,
                               power_sink=None, transfer: str = "f32"):
        """Build (don't start) the combined full-rate imaging+listening
        stage: one transfer per batch, padded once on the device, feeding
        the heatmap program and the beam.  The heatmap half is the
        pipeline's ``power_fn`` when it has one (enabling audio must not
        switch the imaging semantics), else the policy's program
        (:func:`_batched_power_program`)."""
        _check_beam(beam)
        tables, n_full = self.tables, self.cfg.n_microphones
        power_fn = (self._power_fn if self._power_fn is not None
                    else _batched_power_program(tables, n_full))

        def process_fn(frames, d):
            frames = _pad_full(frames, n_full)
            return power_fn(frames), beamform.miso_beam(frames, tables, d)

        s = BatchedMimoMisoProducer(self.receiver, self._sink(sink),
                                    self.metrics, batch, process_fn,
                                    self._gain, self.cfg.n_samples,
                                    self.q_power, power_sink=power_sink,
                                    channels=channels, transfer=transfer,
                                    device=self.device)
        self._miso = s
        return s

    def start_miso_batched(self, batch: int = 16, beam: str = "time",
                           warmup: bool = True, channels: int = 0,
                           sink: Optional[audio_mod.AudioSink] = None):
        """Full-rate variant of :meth:`start_miso`: gapless line-rate
        listening."""
        s = self.make_miso_batched(batch=batch, beam=beam,
                                   channels=channels, sink=sink)
        if warmup:
            s.warmup()
        return self.run_stage(s)

    # -- steering (main.pyx:498-528 semantics) ---------------------------------

    def steer_cartesian_degree(self, azimuth: float, elevation: float) -> int:
        if not (-90 <= azimuth <= 90 and -90 <= elevation <= 90):
            raise ValueError(f"steering angles out of [-90, 90]: "
                             f"({azimuth}, {elevation})")
        d = beamform.steer_index(self.cfg, azimuth, elevation)
        if self._miso is not None:
            self._miso.steer(d)
        return d

    def steer_click(self, horizontal01: float, vertical01: float) -> int:
        """Normalized click coords -> grid cell (``stear_miso_beam``)."""
        az = int(np.clip(horizontal01 * self.cfg.max_res_x, 0,
                         self.cfg.max_res_x - 1))
        el = int(np.clip(vertical01 * self.cfg.max_res_y, 0,
                         self.cfg.max_res_y - 1))
        d = az * self.cfg.max_res_y + el
        if self._miso is not None:
            self._miso.steer(d)
        return d

    # -- teardown --------------------------------------------------------------

    def stop(self):
        for s in self.stages:
            s.stop()
        for s in self.stages:
            s.join(timeout=2.0)
        self.receiver.disconnect()
        if self._miso is not None:
            self._miso.sink.close()

    def report(self):
        rep = self.metrics.report()
        stats = self.receiver.native_stats
        rep["ingest"] = {"packets": stats.packets, "frames": stats.frames,
                         "gaps": stats.gaps}
        # full-rate stage accounting (frames through the device, frames
        # the ring overwrote unread, zero-filled audio frames) and the
        # audio sink's late-write and playback-underflow counters
        for s in self.stages:
            counts = {k: getattr(s, k) for k in
                      ("processed", "skipped", "underrun_frames")
                      if hasattr(s, k)}
            if hasattr(s, "audio_latency"):
                counts.update(s.audio_latency())
            sink = getattr(s, "sink", None)
            if sink is not None and hasattr(sink, "_dropped"):
                counts["sink_dropped_writes"] = sink._dropped
            if sink is not None and hasattr(sink, "underflow_samples"):
                counts["sink_underflow_samples"] = sink.underflow_samples
            if counts:
                rep.setdefault(s.name, {}).update(counts)
        return rep
