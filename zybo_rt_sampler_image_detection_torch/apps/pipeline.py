"""Single-process real-time pipeline: the MIMO heatmap path.

The reference spreads one dataflow across five+ processes (fork'd C
receiver, multiprocessing producers, viewer — ``main.pyx:669-736``,
SURVEY.md §3.2).  Here each stage is a thread around a device program,
sharing queues with the reference's drop-oldest backpressure
(``main.pyx:639-650``).

Ported so far: :class:`HeatmapProducer` — fresh frame -> steered-power map
-> ``q_power`` (the ``_loop_mimo_*`` producers, ``main.pyx:172-380``) — and
the backend policy that picks its device program.  Listening, camera,
tracker and the batched full-rate stages are later slices (ROADMAP).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import torch

from ..config import Config
from ..ingest.receiver import Receiver
from ..ops import beamform
from ..utils.metrics import PipelineMetrics

# Byte cap for the bin-major FP32 response planes of the equiv paths,
# 16*D*M*F (two planes of (F, 2M, D) float32).  The JAX package capped them
# at 2.4e9 B, 15% of a 16 GB v5e; the same share of the H100's 80 GB.
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
    * ``("xla", None)`` — the exact time-domain product
      (:func:`beamform.steered_power`): the ``highest`` rung's
      ground-truth contract, and CPU tensors.  The name is the JAX
      package's.

    Where the JAX policy would pick the time-domain fused kernel
    (``bf16`` shapes outside the equiv bar) this raises
    ``NotImplementedError``: that kernel is not ported yet.
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
        raise NotImplementedError(
            "the time-domain fused kernel ('fused' backend) is not ported "
            "yet (ROADMAP queue 2, K2); use matmul_precision='highest' or "
            "power_backend='equiv_kernel'")
    return "xla", None


def default_power_fn(tables):
    """Production policy for the heatmap stage's device program.  The
    returned callable takes ``(M, N)`` frames and ``(B, M, N)`` batches
    (tensors on the tables' device) and returns (X, Y) / (B, X, Y)."""
    kind, obj = _select_power_backend(tables)
    if kind == "equiv_kernel":
        return obj            # __call__ squeezes 2-D frames
    if kind == "freq_equiv":
        from ..ops import freq_equiv

        return lambda f: freq_equiv.equiv_steered_power(f, obj)
    return lambda f: beamform.steered_power(f, tables)


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


class Pipeline:
    """Owns the receiver + stages; the ``mimo()`` orchestration layer
    (``main.pyx:669-736``) as one object.

    ``device`` is explicit (``"cuda"`` by default); asking for CUDA with no
    GPU present raises.  ``power_backend``: ``"auto"`` (the policy of
    :func:`_select_power_backend`), ``"freq_equiv"`` (the exact plain-torch
    frequency path) or ``"equiv_kernel"`` (force the fused kernel, in the
    mode the tables' precision picks — ``f32`` at ``highest``)."""

    def __init__(self, cfg: Optional[Config] = None, algorithm: str = "lerp",
                 replay_mode: bool = False, backend: str = "auto",
                 power_backend: str = "auto", device="cuda"):
        self.cfg = cfg or Config()
        self.device = beamform.resolve_device(device)
        beamform.set_fp32_matmul()
        self.metrics = PipelineMetrics()
        if power_backend not in ("auto", "freq_equiv", "equiv_kernel"):
            raise ValueError(f"unknown power backend {power_backend!r}")
        self.tables = beamform.make_tables(self.cfg, algorithm,
                                           device=self.device)
        power_fn = None                 # auto: default_power_fn's policy
        if power_backend == "freq_equiv":
            from ..ops import freq_equiv

            et = freq_equiv.make_equiv_tables(self.tables)
            power_fn = lambda f: freq_equiv.equiv_steered_power(f, et)  # noqa: E731
        elif power_backend == "equiv_kernel":
            from ..ops import equiv_kernel

            power_fn = equiv_kernel.FusedEquivBeamformer(self.tables)
        self.receiver = Receiver(self.cfg, replay_mode=replay_mode,
                                 backend=backend)
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
        return rep
