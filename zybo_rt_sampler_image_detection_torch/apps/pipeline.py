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
  transfer per batch (``_loop_mimo_and_miso_*``, ``main.pyx:279-380``);
* :class:`CameraProducer` — camera frames -> ``q_viewer`` and ``q_yolo``;
* :class:`TrackerStage` / :class:`BatchedTrackerStage` — YOLO (one device
  program per frame, or per K queued frames) -> SORT -> the overlay and
  ``rect_conf`` on ``q_inference`` (``yolo_smooth_tracking.py:275-348``).

:func:`make_mvdr_stream` is the streaming-MVDR state machine behind
``--algorithm mvdr`` and ``beam="mvdr"`` (Capon maps, adaptive
distortionless beams, or both from one state update).

Steering: :meth:`Pipeline.steer_cartesian_degree` /
:meth:`Pipeline.steer_click` mirror ``main.pyx:498-528``; the direction
indexes the tables on the device, so a steer needs no host sync and no
rebuild.  The fused display stage (``apps/fused.py``) builds on
:class:`Stage`, :class:`AudioLeg` and :func:`power_program`.
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
from ..ops import beamform, freq, fused_kernel, quad_form_kernel
from ..utils import audio as audio_mod
from ..utils.metrics import PipelineMetrics, history
from ..utils.profiling import annotate

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


def _equiv_kernel_if_favored(tables, et=None, channels: int = 0):
    """The fused equiv kernel (``ops.equiv_kernel``) for a shape inside
    the equiv bar, its plane over the mics below ``channels`` where a
    stage hands it channel-sliced frames, else None (also when no
    shared-memory plan fits)."""
    if not _equiv_bar(tables):
        return None
    from ..ops import equiv_kernel

    try:
        return equiv_kernel.FusedEquivBeamformer(
            et if et is not None else tables, channels=channels)
    except ValueError:                  # no shared-memory plan for the shape
        return None


def _select_power_backend(tables, channels: int = 0):
    """Production backend selection for the heatmap stage.

    Returns ``(kind, obj)``:

    * ``("fft", FreqTables)`` — the FFT-domain Bartlett program
      (:func:`freq.fft_steered_power`) of the ``fft`` route's tables;
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

    ``channels``: the rows of the channel-sliced batches a full-rate
    stage hands the program (0: whole frames).  The equiv kernel then
    builds its plane over the mics below it alone
    (``FusedEquivBeamformer(channels=)``); the other kinds take the
    batches padded back to whole frames.
    """
    if isinstance(tables, freq.FreqTables):
        return "fft", tables
    if tables.precision != "highest" and tables.device.type == "cuda":
        et = _equiv_tables_if_favored(tables)
        if et is not None:
            k = _equiv_kernel_if_favored(tables, et, channels)
            if k is not None:
                return "equiv_kernel", k
            return "freq_equiv", et
        if tables.precision == "default":
            k = _equiv_kernel_if_favored(tables, channels=channels)
            if k is not None:
                return "equiv_kernel", k
        # a K-looped kernel fits every shape: no loud fallback to the
        # exact product as on the TPU (``fits_vmem``)
        return "fused", fused_kernel.FusedBeamformer(tables)
    return "xla", None


def power_program(tables, n_full: int = 0, channels: int = 0,
                  backend: str = "auto", power_fn=None):
    """The one place that builds a heatmap stage's device program,
    fitted to the batch the stage reads: one whole f32 (M, N) frame where
    ``n_full`` is 0 (the live stage), else (B, ``channels`` or ``n_full``,
    N) batches in the transfer dtype.  It returns (X, Y) / (B, X, Y)
    maps.

    ``backend``: ``"auto"`` (the policy, :func:`_select_power_backend`,
    whose K1 spans the ``channels < n_full`` rows of a sliced stage and
    takes its batch as it comes), ``"freq_equiv"``, ``"equiv_kernel"``
    (``Pipeline(power_backend=)``) or ``"mvdr"`` (``power_fn`` is then the
    route's :func:`make_mvdr_stream`, which takes both forms as they
    come).  Else ``power_fn`` is a caller's program on whole f32 frames.
    A batched stage runs every other program behind :func:`_pad_full`,
    which keeps a stateful program's ``reset`` and names the program it
    wraps ``inner`` (:meth:`Pipeline.report` reads it)."""
    if backend == "mvdr":
        return power_fn
    sliced = 0 < channels < n_full
    if power_fn is None:
        from ..ops import equiv_kernel, freq_equiv

        if backend == "auto":
            kind, obj = _select_power_backend(tables,
                                              channels if sliced else 0)
            if kind == "equiv_kernel" and sliced:
                return obj
        elif backend == "equiv_kernel":
            kind, obj = backend, equiv_kernel.FusedEquivBeamformer(tables)
        else:
            kind, obj = backend, freq_equiv.make_equiv_tables(tables)
        if kind in ("equiv_kernel", "fused"):
            power_fn = obj            # __call__ squeezes 2-D frames
        elif kind == "freq_equiv":
            power_fn = lambda f: freq_equiv.equiv_steered_power(f, obj)  # noqa: E731
        elif kind == "fft":
            power_fn = lambda f: freq.fft_steered_power(f, obj)  # noqa: E731
        else:
            power_fn = lambda f: beamform.steered_power(f, tables)  # noqa: E731
    if not n_full:
        return power_fn

    def program(frames):
        return power_fn(_pad_full(frames, n_full))

    program.inner = power_fn
    if hasattr(power_fn, "reset"):
        program.reset = power_fn.reset
    return program


def _pad_full(frames: torch.Tensor, n_full: int) -> torch.Tensor:
    """Device prologue shared by the full-rate stages: upcast f16-transfer
    batches and pad channel-sliced transfers back to the full mic axis
    (the tail rows are always zero).  float64 frames stay float64 (the
    MVDR stream then runs in complex128).  Span ``power.pad``."""
    with annotate("power.pad"):
        if frames.dtype != torch.float64:
            frames = frames.float()
        pad = n_full - frames.shape[1]
        if pad > 0:
            frames = F_.pad(frames, (0, 0, 0, pad))
        return frames


def make_mvdr_stream(cfg: Config, kind: str = "maps", alpha: float = 0.9,
                     band_low: float = 100.0, device="cuda"):
    """The streaming-MVDR state machine shared by every production site
    (``demo --algorithm mvdr``, the full-rate listening stage, and the
    combined imaging+listening stage) — ONE implementation of the
    drift-critical cadence logic:

    * **alpha-aware exact refresh**: every Sherman-Morrison/Woodbury
      step divides P by alpha, so f32 drift amplifies ~1/alpha per
      frame; an exact Cholesky refresh runs every
      ``freq.refresh_interval(alpha)`` frames (a fixed 256-frame
      interval blows up mid-run at alpha=0.9).
    * **carried quadratic form**: the ``a^H P a`` evaluation (the
      O(F M^2 D) product of a batch) is carried across batched calls and
      re-measured every ``freq.d0_carry_interval(alpha)`` frames — the
      carried correction's error also amplifies 1/alpha per frame.
    * **reset/warmup** (``fn.reset()``): drop warmup pollution (a zero
      block scales P by alpha^-B and leaves R at 1e-12 I) and run the
      periodic programs once up front, so that the first Cholesky and
      the first full quadratic form do not stall the stage mid-run.

    ``kind`` selects what one call computes:

    * ``"maps"``: ``fn(frames (B, M, N)) -> (B, X, Y)`` exact per-frame
      Capon maps (``freq.mvdr_maps_scan``); also accepts a single
      ``(M, N)`` frame -> ``(X, Y)`` via the per-frame recursion (the
      live loop).
    * ``"beams"``: ``fn(frames, direction) -> (B, N)`` adaptive
      distortionless listening beams (``freq.mvdr_listen_step``).
    * ``"maps_beams"``: ``fn(frames, direction) -> (maps, beams)`` — one
      streaming-inverse update shared between the Capon maps and the beam
      weights (one host->device transfer serves both).

    Channel-sliced / f16 batches are padded back to the full mic axis
    inside ``fn``.  The products run at ``cfg.matmul_precision``'s rung
    (the tables', ``freq._products``).  The host counters are Python ints
    and nothing in a call reads the device back, so the stages keep two
    batches in flight.  Returns ``fn`` with ``fn.reset()``,
    ``fn.tables``, ``fn.state``, ``fn.tick(k)``, ``fn.alpha`` and
    ``fn.counts``.  On the card unless ``device="cpu"``.  Ref:
    ``api.c:576-581`` (live steer), ``api.c:491-543`` (miso_loop).

    Spans: ``power.mvdr_scan`` (a batch's ``freq.mvdr_maps_scan``, or the
    live frame's ``freq.update_precision``), ``power.mvdr_d0`` (a full
    quadratic form) and ``power.mvdr_refresh`` (an exact refresh).
    ``fn.counts``, over the stream's life (the up-front programs of
    ``reset`` left out): ``refreshes``, ``quad_forms`` (full quadratic
    forms measured), ``quad_form_launches`` (the quadratic form kernel's
    launches among them, ``quad_form_kernel.hermitian_quad_form.launches``
    read around each form: every form at ``highest`` and ``high`` on the
    card, none at ``default`` or on the CPU) and ``frames`` (frames
    absorbed).
    """
    if kind not in ("maps", "beams", "maps_beams"):
        raise ValueError(f"unknown mvdr stream kind {kind!r}")
    ft = freq.make_freq_tables(cfg, band_low, device=device)
    n_full = cfg.n_microphones
    state = {"p": freq.init_precision(ft), "n": 0, "r": 0, "dq": None,
             "dqc": 0}
    counts = {"refreshes": 0, "quad_forms": 0, "quad_form_launches": 0,
              "frames": 0}
    refresh_every = freq.refresh_interval(alpha)
    carry_max = freq.d0_carry_interval(alpha)

    def _quad_form(measure):
        kernel = quad_form_kernel.hermitian_quad_form
        launches = kernel.launches
        with annotate("power.mvdr_d0"):
            out = measure(state["p"], ft)
        counts["quad_forms"] += 1
        counts["quad_form_launches"] += kernel.launches - launches
        return out

    def _carried_dq():
        if state["dq"] is None or state["dqc"] >= carry_max:
            state["dq"] = _quad_form(freq.mvdr_d0)
            state["dqc"] = 0
        return state["dq"]

    def _tick(k: int):
        state["n"] += k
        state["dqc"] += k
        counts["frames"] += k
        if state["n"] - state["r"] >= refresh_every:
            with annotate("power.mvdr_refresh"):
                state["p"] = freq.refresh_precision(state["p"], ft)
            counts["refreshes"] += 1
            state["dq"] = None         # re-measure from the refreshed P
            state["r"] = state["n"]

    def _scan(frames):
        frames = _pad_full(frames, n_full)
        d0 = _carried_dq()
        with annotate("power.mvdr_scan"):
            maps, state["p"], state["dq"] = freq.mvdr_maps_scan(
                state["p"], frames, ft, alpha=alpha, d0=d0, return_d=True)
        return frames, maps

    def _frames(frames):
        return torch.as_tensor(frames, device=ft.device)

    if kind == "beams":
        def fn(frames, direction):
            frames = _pad_full(_frames(frames), n_full)
            beams, state["p"] = freq.mvdr_listen_step(
                state["p"], frames, ft, direction, alpha=alpha)
            _tick(frames.shape[0])
            return beams
    elif kind == "maps_beams":
        def fn(frames, direction):
            frames, maps = _scan(_frames(frames))
            beams = freq.mvdr_beam_precision(state["p"], ft, frames,
                                             direction)
            _tick(frames.shape[0])
            return maps, beams
    else:
        def fn(frames):
            frames = _frames(frames)
            if frames.ndim == 3:
                _, maps = _scan(frames)
                _tick(frames.shape[0])
            else:
                with annotate("power.mvdr_scan"):
                    state["p"] = freq.update_precision(state["p"], frames,
                                                       ft, alpha=alpha)
                state["dq"] = None  # P moved outside the carried recursion
                maps = _quad_form(freq.mvdr_power_precision)
                _tick(1)
            return maps

    def reset():
        state["p"] = freq.init_precision(ft)
        freq.refresh_precision(state["p"], ft)
        if kind != "beams":
            freq.mvdr_d0(state["p"], ft)
        if ft.device.type == "cuda":
            torch.cuda.synchronize(ft.device)
        state["dq"] = None
        state["n"] = state["r"] = state["dqc"] = 0

    fn.reset = reset
    fn.tables = ft
    fn.state = state
    # embedded-state consumers run the per-call step themselves but MUST
    # share this exact cadence: set state["p"] to the post-batch state,
    # then tick(k)
    fn.tick = _tick
    fn.alpha = alpha
    fn.counts = counts
    return fn


def _sharded_power_program(mesh, tables):
    """The mesh's twin of :func:`power_program`: the same backend
    policy (:func:`_select_power_backend`), each launch running the
    sharded form of the chosen path (``parallel.mesh``) on row shards the
    stage uploaded to the data devices.  Full-width f32 frames only."""
    from ..parallel import mesh as mesh_mod

    kind, obj = _select_power_backend(tables)
    if kind == "fft":
        raise ValueError("mesh is exclusive with the fft route")
    if kind == "equiv_kernel":
        return mesh_mod.sharded_equiv_kernel_power(mesh, tables)
    if kind == "freq_equiv":
        return mesh_mod.sharded_equiv_power(
            mesh, mesh_mod.shard_equiv_tables(obj, mesh))
    if kind == "fused":
        return mesh_mod.sharded_fused_power(
            mesh, mesh_mod.shard_tables(tables, mesh))
    return mesh_mod.sharded_steered_power(
        mesh, mesh_mod.shard_tables(tables, mesh))


def _identity(x):
    return x


class Stage(threading.Thread):
    def __init__(self, name: str, metrics: PipelineMetrics):
        super().__init__(name=name, daemon=True)
        self.stop_event = threading.Event()
        self.metric = metrics.stage(name)

    def stop(self):
        self.stop_event.set()


class HeatmapProducer(Stage):
    """The newest frame -> ``power_fn`` (one whole f32 (M, N) frame; the
    policy's from :func:`power_program` when None) -> q_power."""

    def __init__(self, receiver: Receiver, tables, q_power: queue.Queue,
                 metrics: PipelineMetrics, power_fn=None):
        super().__init__("heatmap", metrics)
        self.receiver = receiver
        self.tables = tables
        self.q_power = q_power
        self.device = tables.device
        self.power_fn = power_fn or power_program(tables)

    def run(self):
        seq = 0
        while not self.stop_event.is_set():
            try:
                with annotate("stage.frame", seq + 1):
                    seq = self._frame(seq)
            except TimeoutError:        # no fresh frame in the read's time
                continue

    def _frame(self, seq: int) -> int:
        """Beamform the newest frame after ``seq`` onto ``q_power``;
        returns its sequence number."""
        frame, seq = self.receiver.read_frame(fresh=True, last_seq=seq,
                                              timeout=1.0)
        t0 = time.perf_counter()
        x = torch.from_numpy(frame).to(self.device)
        with annotate("power.program", seq):
            power = self.power_fn(x)
        with annotate("stage.finish_wait", seq):
            power = power.cpu().numpy()         # waits for the device
        self.metric.tick(time.perf_counter() - t0)
        if not put_drop_oldest(self.q_power, (power, seq)):
            self.metric.drop()
        return seq


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
    in the same shape, and set ``stateful_fn`` to the device program they
    were given: when it has a ``reset`` (the MVDR stream), :meth:`warmup`
    calls it.  A subclass that sets ``want_stamps`` gets each batch's
    per-frame ring publish times (``time.perf_counter`` seconds) as
    ``stamps``.  Spans (``utils.profiling.annotate``), each with the
    batch's first sequence number: ``stage.batch`` around a loop
    iteration that read a batch, and inside it ``ingest.read_batch``,
    ``stage.slot_wait``, ``stage.slot_copy``, ``stage.h2d``,
    ``power.program``, ``stage.d2h``, then the batch before's
    ``stage.finish_wait`` and ``stage.consume``.  Accounting:
    ``processed`` frames through the device, ``skipped`` frames the ring
    overwrote unread (0 = full rate sustained), ``metric`` per-batch
    latency.

    With a ``mesh`` (``parallel.mesh.Mesh``) the batch splits over its
    ``data`` axis at upload: one ``non_blocking`` copy from one pinned
    host buffer to each data device, and ``launch`` gets the list of row
    shards.  The batch must divide the data axis.
    """

    def __init__(self, name: str, receiver: Receiver,
                 metrics: PipelineMetrics, batch: int, channels: int = 0,
                 transfer: str = "f32", device="cuda",
                 max_rate: float = 0.0, mesh=None):
        super().__init__(name, metrics)
        if mesh is not None and batch % mesh.shape["data"]:
            raise ValueError(
                f"batch ({batch}) must divide the data axis "
                f"({mesh.shape['data']}) for sharded transfers")
        self.mesh = mesh
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
        # max_rate (frames/s, 0 = line rate): throttle the stage, letting
        # the ring overwrite the frames it skips (counted in `skipped`).
        # A display consumer needs about twice the viewer's fps, not line
        # rate, and an uncapped stage takes the host<->device link and the
        # host's cores from the camera and compositing legs.
        self.max_rate = float(max_rate)
        self._rate_t0 = None
        self._slots = None
        self._next_slot = 0
        self._copy_stream = None
        self._pending = None              # the batch in flight
        # subclasses that need per-frame ring publish times (the audio
        # e2e latency contract) set this before start()
        self.want_stamps = False
        self.stateful_fn = None

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

    def _dispatch(self, batch: np.ndarray, first: Optional[int] = None):
        """Copy ``batch`` to the device and launch on it; returns the
        (host output, done event) pair :meth:`_finish` waits on.  Each
        tensor ``launch`` returns gets its own pinned host tensor; one
        event marks all of their copies done.  ``first``: the batch's
        first sequence number, for the spans (else the enclosing span's)."""
        x = torch.from_numpy(batch)
        if self.mesh is not None:
            devs = self.mesh.data_devices()
            if self.device.type != "cuda":
                shards = [r.to(d) for r, d in zip(x.chunk(len(devs)), devs)]
                with annotate("power.program", first):
                    return self.launch(shards), None
            # the caching host allocator keeps the pinned block until the
            # copies out of it are done
            host = x.pin_memory()
            shards = [r.to(d, non_blocking=True) for r, d in
                      zip(host.chunk(len(devs)), devs)]
            with annotate("power.program", first):
                out = self.launch(shards)
            compute = torch.cuda.current_stream(self.device)
        elif self.device.type != "cuda":
            x = x.to(self.device, self.transfer_dtype)
            with annotate("power.program", first):
                return self.launch(x), None
        else:
            slot = self._slot_for(tuple(x.shape))
            with annotate("stage.slot_wait", first):
                slot.copied.synchronize()   # the pinned buffer is free again
            with annotate("stage.slot_copy", first):
                slot.host.copy_(x)          # host copy (f16 rounding here)
            compute = torch.cuda.current_stream(self.device)
            with annotate("stage.h2d", first):
                with torch.cuda.stream(self._copy_stream):
                    if slot.used:           # the device buffer's last reader
                        self._copy_stream.wait_event(slot.read)
                    slot.dev.copy_(slot.host, non_blocking=True)
                    slot.copied.record(self._copy_stream)
                compute.wait_event(slot.copied)
            with annotate("power.program", first):
                out = self.launch(slot.dev)
            slot.read.record(compute)
            slot.used = True
        with annotate("stage.d2h", first):
            outs = out if isinstance(out, tuple) else (out,)
            hosts = tuple(torch.empty(o.shape, dtype=o.dtype,
                                      pin_memory=True) for o in outs)
            for h, o in zip(hosts, outs):
                h.copy_(o, non_blocking=True)
            done = torch.cuda.Event(blocking=True)
            done.record(compute)
        return (hosts if isinstance(out, tuple) else hosts[0]), done

    def warmup(self):
        """Build the kernels and first-call state before any packets flow
        (a first build mid-run stalls the stage and drops frames), then
        reset a stateful device program, whose state the zero batch
        polluted."""
        n_ch = self.channels or self.receiver.cfg.n_microphones
        zeros = np.zeros((self.batch, n_ch, self.receiver.cfg.n_samples),
                         np.float32)
        host, done = self._dispatch(zeros)
        if done is not None:
            done.synchronize()
        reset = getattr(self.stateful_fn, "reset", None)
        if reset is not None:
            reset()

    def _finish(self, pending):
        host, done, first, skipped, t0, stamps = pending
        if done is not None:
            with annotate("stage.finish_wait", first):
                done.synchronize()               # batch i-1 is on the host
        self.metric.tick(time.perf_counter() - t0)
        if skipped:
            self.skipped += skipped
            self.metric.drop(skipped)
        self.processed += self.batch
        out = (tuple(np.asarray(h) for h in host) if isinstance(host, tuple)
               else np.asarray(host))
        with annotate("stage.consume", first):
            self.consume(out, first, skipped, stamps)

    def _drain(self):
        """Finish the batch in flight, if there is one."""
        pending, self._pending = self._pending, None
        if pending is not None:
            self._finish(pending)

    def _step(self, next_seq: int) -> int:
        """Read the batch at ``next_seq``, copy and launch it, then finish
        the batch before it; returns the next batch's sequence number.
        Raises :class:`TimeoutError` (from the read alone) where no batch
        came."""
        res = self.receiver.read_batch(
            self.batch, next_seq, timeout=0.5,
            channels=self.channels, with_stamps=self.want_stamps)
        batch, first, skipped = res[:3]
        stamps = res[3] if self.want_stamps else None
        if self._rate_t0 is None:
            self._rate_t0 = time.perf_counter()
        t0 = time.perf_counter()
        host, done = self._dispatch(batch, first)   # copy + launch, no wait
        self._drain()                               # batch i-1, in order
        self._pending = (host, done, first, skipped, t0, stamps)
        return first + self.batch

    def run(self):
        # stream-start anchor: consume everything the ring still holds,
        # but a pre-start backlog beyond the ring must not count as skips
        next_seq = self.receiver.stream_anchor_seq
        while not self.stop_event.is_set():
            if self.max_rate and self._rate_t0 is not None:
                ahead = (self.processed / self.max_rate
                         - (time.perf_counter() - self._rate_t0))
                if ahead > 0.0:
                    self._drain()               # sync while throttled
                    time.sleep(min(ahead, 0.5))
            try:
                with annotate("stage.batch", next_seq):
                    next_seq = self._step(next_seq)
            except TimeoutError:
                self._drain()
        self._drain()


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

    ``power_fn``: the stage's program, fitted to the batches it reads
    (:func:`power_program`, which builds the policy's when it is None).
    ``mesh``: split every batch over the mesh's ``data`` axis and launch
    the sharded form of the production policy
    (:func:`_sharded_power_program`); exclusive with ``power_fn``, and
    only for full-width f32 transfers.
    """

    def __init__(self, receiver: Receiver, tables, q_power: queue.Queue,
                 metrics: PipelineMetrics, batch: int = 16,
                 power_fn=None, sink=None, channels: int = 0,
                 transfer: str = "f32", max_rate: float = 0.0, mesh=None):
        super().__init__("heatmap_batched", receiver, metrics, batch,
                         channels, transfer,
                         device=tables.device if mesh is None else mesh.first,
                         max_rate=max_rate, mesh=mesh)
        self.tables = tables
        self.q_power = q_power
        self.sink = sink or self._default_sink
        if mesh is not None:
            if power_fn is not None:
                raise ValueError("mesh and power_fn are exclusive")
            if channels or transfer != "f32":
                raise ValueError("sharded transfers need full-width f32 "
                                 "batches (channels=0, transfer='f32')")
            power_fn = _sharded_power_program(mesh, tables)
        elif power_fn is None:
            power_fn = power_program(tables, receiver.cfg.n_microphones,
                                     channels)
        self.power_fn = self.stateful_fn = power_fn

    def _default_sink(self, powers: np.ndarray, first_seq: int):
        # display drop only; processing was already counted
        put_drop_oldest(self.q_power,
                        (powers[-1], first_seq + len(powers) - 1))

    def launch(self, frames_dev):
        return self.power_fn(frames_dev)

    def consume(self, powers, first_seq: int, skipped: int, stamps=None):
        self.sink(powers, first_seq)


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
        self.lat_oldest_ms = history()
        self.lat_newest_ms = history()

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
        self.beam_fn = self.stateful_fn = beam_fn
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
        self.process_fn = self.stateful_fn = process_fn
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


class CameraProducer(Stage):
    def __init__(self, capture, q_viewer: queue.Queue, q_yolo: queue.Queue,
                 metrics: PipelineMetrics, fps_limit: float = 60.0):
        super().__init__("camera", metrics)
        self.capture = capture
        self.q_viewer = q_viewer
        self.q_yolo = q_yolo
        self.interval = 1.0 / fps_limit

    def run(self):
        n = 0
        while not self.stop_event.is_set():
            ok, frame = self.capture.read()
            if not ok:
                break
            n += 1
            self.metric.tick()
            put_drop_oldest(self.q_viewer, (n, frame))
            put_drop_oldest(self.q_yolo, (n, frame))
            time.sleep(self.interval)


def _rect_conf(tracks, dets, prev_rect_conf):
    """The newest [[x1,y1],[x2,y2],conf] (the ``rect_conf`` contract of
    ``process_video_track_boxes_only``, ``yolo_smooth_tracking.py:
    275-348``) without drawing."""
    from ..models.tracking import compute_iou
    rect_conf = prev_rect_conf
    for tr in tracks:
        x1, y1, x2, y2, tid = tr.astype(int)
        conf = 0.0
        for det in dets:
            if compute_iou([x1, y1, x2, y2], det[:4]) > 0.5:
                conf = float(det[4])
                break
        rect_conf = [[int(x1), int(y1)], [int(x2), int(y2)], conf]
    return rect_conf


def _draw_tracks(imaging, blank, tracks, dets, prev_rect_conf):
    """Draw ID boxes on the blank overlay and return the newest
    rect_conf (see :func:`_rect_conf`)."""
    for tr in tracks:
        x1, y1, x2, y2, tid = tr.astype(int)
        imaging.rectangle(blank, (x1, y1), (x2, y2), (0, 255, 0), 2)
    return _rect_conf(tracks, dets, prev_rect_conf)


def _tracks_payload(tracks) -> np.ndarray:
    """The int-cast (T, 5) boxes the host would draw, as the
    emit_boxes q_inference payload (``fusion.composite.DeviceCompositor``
    rasterizes cv2's thickness-2 rectangles from these exact
    coordinates)."""
    if len(tracks) == 0:
        return np.zeros((0, 5), np.float32)
    return np.asarray(tracks).astype(int).astype(np.float32)


class TrackerStage(Stage):
    """One YOLO program and one tracker step per camera frame.
    ``emit_boxes=True`` publishes the raw track boxes instead of a drawn
    canvas, for the device compositor (``demo sensorfusion --composite
    device``), which rasterizes them."""

    def __init__(self, detector, q_yolo: queue.Queue,
                 q_inference: queue.Queue, metrics: PipelineMetrics,
                 emit_boxes: bool = False, **tracker_kwargs):
        super().__init__("tracker", metrics)
        self.q_yolo = q_yolo
        self.q_inference = q_inference
        self.emit_boxes = emit_boxes
        from ..models.tracking import SmoothedTracker
        from ..utils import imaging
        self._imaging = imaging
        self.tracker = SmoothedTracker(detector, **tracker_kwargs)

    def run(self):
        rect_conf = [[0, 0], [0, 0], 0]
        while not self.stop_event.is_set():
            try:
                frame_no, frame = self.q_yolo.get(timeout=0.5)
            except queue.Empty:
                continue
            t0 = time.perf_counter()
            if frame.ndim == 2:
                frame = np.repeat(frame[..., None], 3, -1)
            tracks, dets = self.tracker.step(frame)
            if self.emit_boxes:
                rect_conf = _rect_conf(tracks, dets, rect_conf)
                payload = _tracks_payload(tracks)
            else:
                payload = np.zeros_like(frame)
                rect_conf = _draw_tracks(self._imaging, payload, tracks,
                                         dets, rect_conf)
            self.metric.tick(time.perf_counter() - t0)
            put_drop_oldest(self.q_inference,
                            (frame_no, payload, rect_conf))


class BatchedTrackerStage(Stage):
    """Batched detector stage (the vision twin of the batched heatmap
    stage, VERDICT round-2 #2): accumulate up to K queued camera frames,
    run ONE batched YOLO device program (preprocess + backbone + decode +
    batched NMS — ``YoloDetector.get_detections_batch``), then step the
    host-side SORT/hysteresis tracker per frame (O(tracks), cheap) and
    emit every frame's overlay in order.

    The single-frame :class:`TrackerStage` pays one device program and
    its host round trip per camera frame; this stage amortizes them K
    ways.  Partial batches are padded with zero images (one batch shape)
    and padded outputs discarded.  ``processed`` counts frames
    through the detector; every queued frame is processed exactly once.
    """

    def __init__(self, detector, q_yolo: queue.Queue,
                 q_inference: queue.Queue, metrics: PipelineMetrics,
                 batch: int = 4, emit_boxes: bool = False,
                 **tracker_kwargs):
        super().__init__("tracker_batched", metrics)
        self.q_yolo = q_yolo
        self.q_inference = q_inference
        self.batch = batch
        self.detector = detector
        self.processed = 0
        self.emit_boxes = emit_boxes
        from ..models.tracking import SmoothedTracker
        from ..utils import imaging
        self._imaging = imaging
        self.tracker = SmoothedTracker(detector, **tracker_kwargs)

    def warmup(self):
        c = self.detector.cfg
        zeros = [np.zeros((c.input_size, c.input_size, 3), np.uint8)]
        self.detector.get_detections_batch(zeros, pad_to=self.batch)

    def run(self):
        rect_conf = [[0, 0], [0, 0], 0]
        while not self.stop_event.is_set():
            items = []
            try:
                items.append(self.q_yolo.get(timeout=0.5))
            except queue.Empty:
                continue
            while len(items) < self.batch:
                try:
                    items.append(self.q_yolo.get_nowait())
                except queue.Empty:
                    break
            t0 = time.perf_counter()
            frames = []
            for no, f in items:
                if f.ndim == 2:
                    f = np.repeat(f[..., None], 3, -1)
                frames.append(f)
            dets_per_frame = self.detector.get_detections_batch(
                frames, conf_threshold=self.tracker.confl,
                pad_to=self.batch)
            self.metric.tick(time.perf_counter() - t0)
            for (no, _), frame, dets in zip(items, frames, dets_per_frame):
                tracks, kept = self.tracker.step_with_detections(frame,
                                                                 dets)
                if self.emit_boxes:
                    rect_conf = _rect_conf(tracks, kept, rect_conf)
                    payload = _tracks_payload(tracks)
                else:
                    payload = np.zeros_like(frame)
                    rect_conf = _draw_tracks(self._imaging, payload,
                                             tracks, kept, rect_conf)
                self.processed += 1
                put_drop_oldest(self.q_inference, (no, payload, rect_conf))


class Pipeline:
    """Owns the receiver + stages; the ``mimo()``/``miso()`` orchestration
    layer (``main.pyx:669-736,824-864``) as one object.

    ``algorithm``: a time-domain algorithm of :func:`beamform.make_tables`
    (``"lerp"``, ``"pad"``, ...); ``"fft"``, the web app's FFT-domain
    Bartlett backend: the heatmap stages then run
    :func:`freq.fft_steered_power` on ``freq.make_freq_tables(cfg)``
    (``power_tables``); or ``"mvdr"``, the streaming Capon maps: the
    heatmap stages share one :func:`make_mvdr_stream` ``"maps"`` stream,
    built at the first of them (``power_tables`` are then its tables).
    On both routes the time-domain tables of the listening stages
    (``tables``, of ``listen_algorithm``) are built at their first use.
    Every heatmap stage takes its program from :func:`power_program`.
    ``device`` is explicit (``"cuda"`` by default); asking for CUDA with no
    GPU present raises.  ``power_backend``: ``"auto"`` (the policy of
    :func:`_select_power_backend`), ``"freq_equiv"`` (the exact plain-torch
    frequency path) or ``"equiv_kernel"`` (force the fused kernel, in the
    mode the tables' precision picks — ``f32`` at ``highest``).
    ``power_fn``: a callable of the heatmap stages' own on whole f32
    frames, e.g. ``ops.fused_kernel.FusedBeamformer(tables)``, exclusive
    with a ``power_backend`` other than ``"auto"`` and with the mvdr
    route.  ``ring_frames``: the
    receiver's frame ring, which bounds the full-rate stage's batch.
    ``audio_sink``/``audio_path``: the listening stages' default sink
    (:func:`utils.audio.make_sink` kind and WAV path)."""

    def __init__(self, cfg: Optional[Config] = None, algorithm: str = "lerp",
                 replay_mode: bool = False, backend: str = "auto",
                 power_backend: str = "auto", device="cuda",
                 power_fn=None, ring_frames: int = 64,
                 audio_sink: str = "null", audio_path: Optional[str] = None,
                 listen_algorithm: str = "lerp"):
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
        if algorithm in ("fft", "mvdr"):
            if power_backend != "auto":
                raise ValueError(
                    f"power_backend={power_backend!r} reformulates the "
                    f"time-domain algorithms; the {algorithm} route "
                    f"computes power its own way")
            if algorithm == "mvdr" and power_fn is not None:
                raise ValueError("a custom power_fn replaces the mvdr "
                                 "route's stream; pass one or the other")
            self._tables = None
            self._listen_algorithm = listen_algorithm
        else:
            self._tables = beamform.make_tables(self.cfg, algorithm,
                                                device=self.device)
        self.power_tables = (freq.make_freq_tables(self.cfg,
                                                   device=self.device)
                             if algorithm == "fft" else self._tables)
        self._power_backend = ("mvdr" if algorithm == "mvdr"
                               else power_backend)
        self.receiver = Receiver(self.cfg, replay_mode=replay_mode,
                                 backend=backend, ring_frames=ring_frames)
        self.q_power: queue.Queue = queue.Queue(maxsize=2)
        self.q_viewer: queue.Queue = queue.Queue(maxsize=2)
        self.q_yolo: queue.Queue = queue.Queue(maxsize=2)
        self.q_inference: queue.Queue = queue.Queue(maxsize=2)
        self.stages = []
        self._power_fn = power_fn
        self._audio_sink_kind = audio_sink
        self._audio_path = audio_path
        # the listening stage that steering reaches (and whose sink
        # stop() closes)
        self._miso = None

    @property
    def tables(self):
        """The time-domain tables: the listening stages', and the heatmap
        stages' but on the fft and mvdr routes, where they are built at
        the first use."""
        if self._tables is None:
            self._tables = beamform.make_tables(
                self.cfg, self._listen_algorithm, device=self.device)
        return self._tables

    @property
    def connected_channels(self) -> int:
        """The frame's leading rows the connected boards fill: the
        stream's array count (else ``cfg.active_arrays``) of rows x columns
        mics, at most ``n_microphones``."""
        cfg = self.cfg
        n_arrays = self.receiver.n_arrays or cfg.active_arrays
        return min(n_arrays * cfg.rows * cfg.columns, cfg.n_microphones)

    def _power_program(self, n_full: int = 0, channels: int = 0):
        """The heatmap stage's program from :func:`power_program` (for
        the live stage where ``n_full`` is 0).  The mvdr route builds its
        stream at the first heatmap stage, and the next ones share it."""
        if self._power_backend == "mvdr" and self._power_fn is None:
            self._power_fn = make_mvdr_stream(self.cfg, "maps",
                                              device=self.device)
            self.power_tables = self._power_fn.tables
        return power_program(self.power_tables, n_full, channels,
                             self._power_backend, self._power_fn)

    # -- bring-up -------------------------------------------------------------

    def connect(self, timeout: float = 30.0) -> int:
        return self.receiver.connect(timeout=timeout)

    def start_heatmap(self, warmup: bool = True):
        power_fn = self._power_program()
        s = HeatmapProducer(self.receiver, self.power_tables, self.q_power,
                            self.metrics, power_fn=power_fn)
        if warmup:
            # build kernels and first-call state before the thread starts so
            # the first live frame is not delayed by them
            zeros = torch.zeros((self.cfg.n_microphones, self.cfg.n_samples),
                                device=self.device)
            s.power_fn(zeros).cpu()
            reset = getattr(s.power_fn, "reset", None)
            if reset is not None:
                # a stateful power_fn (the MVDR stream): drop the zero
                # frame's pollution and run its periodic programs once
                reset()
        self.stages.append(s)
        s.start()
        return s

    def make_heatmap_batched(self, batch: int = 16, sink=None,
                             channels: int = 0, transfer: str = "f32",
                             max_rate: float = 0.0, mesh=None):
        """Build (but don't start) the full-line-rate stage, so callers can
        :meth:`BatchedHeatmapProducer.warmup` before any packets flow and
        :meth:`run_stage` it after :meth:`connect`.  ``max_rate``
        (frames/s) throttles it for a display consumer (see
        :class:`BatchedStage`).  ``mesh``: split every batch over the
        mesh's ``data`` axis and launch the sharded production program."""
        if mesh is None:
            power_fn = self._power_program(self.cfg.n_microphones, channels)
        elif self._power_fn is not None or self._power_backend != "auto":
            raise ValueError("mesh is exclusive with a configured "
                             "power_fn/power_backend and the mvdr route")
        else:
            power_fn = None
        return BatchedHeatmapProducer(self.receiver, self.power_tables,
                                      self.q_power, self.metrics,
                                      batch=batch, power_fn=power_fn,
                                      sink=sink, channels=channels,
                                      transfer=transfer, max_rate=max_rate,
                                      mesh=mesh)

    def run_stage(self, s):
        self.stages.append(s)
        s.start()
        return s

    def start_heatmap_batched(self, batch: int = 16, sink=None,
                              warmup: bool = True, max_rate: float = 0.0,
                              mesh=None):
        """Full-line-rate variant of :meth:`start_heatmap`: every frame
        beamformed in K-frame device batches (at most ``max_rate``
        frames/s when it is set; over ``mesh`` when it is given)."""
        s = self.make_heatmap_batched(batch=batch, sink=sink,
                                      max_rate=max_rate, mesh=mesh)
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
                          channels: int = 0, alpha: float = 0.9,
                          sink: Optional[audio_mod.AudioSink] = None,
                          transfer: str = "f32"):
        """Build (don't start) the full-rate listening stage.

        ``beam='time'``: batched delay-and-sum (:func:`beamform.miso_beam`)
        through this pipeline's tables, with the reference's gain chain
        (``api.c:517-522``).  ``beam='mvdr'``: the adaptive distortionless
        beam — each batch is absorbed into the streaming inverse
        covariance and beamed with the refreshed MVDR weights
        (``freq.mvdr_listen_step`` through :func:`make_mvdr_stream`)."""
        tables, n_full = self.tables, self.cfg.n_microphones
        if beam == "time":
            def beam_fn(frames, d):
                return beamform.miso_beam(_pad_full(frames, n_full), tables,
                                          d)

            post_fn = self._gain
        elif beam == "mvdr":
            beam_fn = make_mvdr_stream(self.cfg, "beams", alpha=alpha,
                                       device=self.device)
            # the MVDR beam is distortionless (unit gain toward the steer
            # direction): no 1/n·MIC_GAIN rescale
            post_fn = _identity
        else:
            raise ValueError(f"unknown beam backend {beam!r}")
        s = BatchedMisoProducer(self.receiver, self._sink(sink),
                                self.metrics, batch, beam_fn, post_fn,
                                self.cfg.n_samples, channels=channels,
                                transfer=transfer, device=self.device)
        self._miso = s
        return s

    def make_mimo_miso_batched(self, batch: int = 16, beam: str = "time",
                               channels: int = 0, alpha: float = 0.9,
                               sink: Optional[audio_mod.AudioSink] = None,
                               power_sink=None, transfer: str = "f32"):
        """Build (don't start) the combined full-rate imaging+listening
        stage: one transfer per batch.

        ``beam='time'``: the heatmap program and the delay-and-sum beam.
        The heatmap half is the full-rate stage's program
        (:func:`power_program`: enabling audio must not switch the imaging
        semantics), on the batch as read; the beam pads its own copy.
        ``beam='mvdr'``:
        the MVDR stream's ``"maps_beams"`` kind — ONE streaming-inverse
        update per batch shared by the Capon maps and the beam weights."""
        tables, n_full = self.tables, self.cfg.n_microphones
        if beam == "time":
            power_fn = self._power_program(n_full, channels)

            def process_fn(frames, d):
                return (power_fn(frames),
                        beamform.miso_beam(_pad_full(frames, n_full),
                                           tables, d))

            if hasattr(power_fn, "reset"):       # a stateful power_fn
                process_fn.reset = power_fn.reset
            post_fn = self._gain
        elif beam == "mvdr":
            process_fn = make_mvdr_stream(self.cfg, "maps_beams",
                                          alpha=alpha, device=self.device)
            post_fn = _identity                  # distortionless
        else:
            raise ValueError(f"unknown beam backend {beam!r}")
        s = BatchedMimoMisoProducer(self.receiver, self._sink(sink),
                                    self.metrics, batch, process_fn,
                                    post_fn, self.cfg.n_samples,
                                    self.q_power, power_sink=power_sink,
                                    channels=channels, transfer=transfer,
                                    device=self.device)
        self._miso = s
        return s

    def start_miso_batched(self, batch: int = 16, beam: str = "time",
                           warmup: bool = True, channels: int = 0,
                           sink: Optional[audio_mod.AudioSink] = None):
        """Full-rate variant of :meth:`start_miso`: gapless line-rate
        listening (the warm-up resets an MVDR beam's state)."""
        s = self.make_miso_batched(batch=batch, beam=beam,
                                   channels=channels, sink=sink)
        if warmup:
            s.warmup()
        return self.run_stage(s)

    # -- vision ----------------------------------------------------------------

    def start_camera(self, capture, fps_limit: float = 60.0):
        s = CameraProducer(capture, self.q_viewer, self.q_yolo,
                           self.metrics, fps_limit=fps_limit)
        return self.run_stage(s)

    def start_tracker(self, detector, **tracker_kwargs):
        s = TrackerStage(detector, self.q_yolo, self.q_inference,
                         self.metrics, **tracker_kwargs)
        return self.run_stage(s)

    def start_tracker_batched(self, detector, batch: int = 4,
                              warmup: bool = True, **tracker_kwargs):
        """Batched variant of :meth:`start_tracker`: one YOLO device
        program per K queued camera frames."""
        s = BatchedTrackerStage(detector, self.q_yolo, self.q_inference,
                                self.metrics, batch=batch,
                                **tracker_kwargs)
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
            # a listening stage owns .sink; the fused display stage with
            # embedded listening keeps it on its AudioLeg
            leg = getattr(self._miso, "audio", None) or self._miso
            sink = getattr(leg, "sink", None)
            if sink is not None:
                sink.close()

    def report(self):
        rep = self.metrics.report()
        stats = self.receiver.native_stats
        rep["ingest"] = {"packets": stats.packets, "frames": stats.frames,
                         "gaps": stats.gaps}
        rep["ingest"].update(self.receiver.ring_counts)
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
        # the mvdr route's stream, once a heatmap stage has built it
        stream_counts = getattr(self._power_fn, "counts", None)
        if self._power_backend == "mvdr" and stream_counts is not None:
            rep["mvdr"] = dict(stream_counts)
        # the time-domain route's kernel (the policy's fused kind, or a
        # caller's FusedBeamformer), at the first stage that runs it
        for s in self.stages:
            fn = getattr(s, "power_fn", None)
            fn = getattr(fn, "inner", fn)
            if isinstance(fn, fused_kernel.FusedBeamformer):
                rep["time_power"] = fn.report()
                break
        return rep
