"""Traffic kind ``stream``: the ``replay`` kind's closed loop, checked as
a stream.

A stateful heatmap program (the ``mvdr`` route's streaming estimator)
gives a map that depends on every frame before it and on where its
periodic refresh falls, so a sample of scattered maps cannot be checked
against a reference.  This driver runs the same system and the same
closed-loop replay as :mod:`portbench.drivers.replay` (its feeder, its
ring and its sink), and keeps for the check one contiguous run of
``check_maps`` maps, whole batches that followed one another, chosen from
the seed uniformly among the runs that finished inside the window; the
``history_frames`` frames before that run, as the ring published them;
and the count of frames the stream had absorbed before the history,
from the sequence numbers (the stage's first batch after the warm-up's
reset is the stream's first).

The mix's parameters: those of ``replay`` and ``history_frames``.
``run.frames`` is one :class:`StreamSample` whose ``len()`` is the
number of checked maps; the configuration's reference reads its
``frames``, ``first`` and ``mvdr`` (the configuration's ``"mvdr"``
block).  A batch of the window whose first sequence does not follow the
batch before counts as failed, every map of it.  The result line's
``backend`` note adds the stream's counters per batch
(``mvdr_per_batch``: refreshes, full quadratic forms and frames
absorbed), which ``common.launch_counts`` does not know; a program whose
stream keeps no counters (``make_mvdr_stream(...).counts``) cannot give
the line, and the run stops before the warm-up.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from portbench import common, trace as trace_mod
from portbench.drivers.replay import _Feeder, _feeding_ring, _Sink


class StreamSample:
    """The frames the check needs: ``frames`` (T, n_mics, N) float32 as
    delivered, the history then the checked run; ``first``, the frames the
    stream had absorbed before ``frames[0]``; ``n``, the checked frames
    (the last n); ``mvdr``, the configuration's estimator constants.  (A
    plain class: the harness loads a driver outside ``sys.modules``, where
    a dataclass cannot be built.)"""

    def __init__(self, frames: np.ndarray, first: int, n: int, mvdr: dict):
        self.frames, self.first, self.n, self.mvdr = frames, first, n, mvdr

    def __len__(self) -> int:
        return self.n


class _RunKeeper:
    """The window's sink sample: one run of ``n_batches`` contiguous
    batches, the newest runs held in a ring of batches, one kept by
    reservoir sampling over the runs that completed (from the seed)."""

    def __init__(self, n_batches: int, batch: int, shape, seed: int):
        self.n = n_batches
        self.buf = np.zeros((n_batches, batch) + tuple(shape), np.float32)
        self.firsts = np.zeros(n_batches, np.int64)
        self.offered = 0
        self.contiguous = 0           # batches in the run ending now
        self.next_seq = None
        self.complete = 0             # runs that completed so far
        self.rng = np.random.default_rng([int(seed) % (2 ** 63), 23])
        self.first = None
        self.maps = None

    def offer(self, maps: np.ndarray, first_seq: int) -> None:
        slot = self.offered % self.n
        self.buf[slot] = maps
        self.firsts[slot] = first_seq
        self.offered += 1
        self.contiguous = (self.contiguous + 1
                           if first_seq == self.next_seq else 1)
        self.next_seq = first_seq + len(maps)
        if self.contiguous < self.n:
            return
        self.complete += 1
        if self.rng.random() * self.complete < 1.0:
            order = (self.offered + np.arange(self.n)) % self.n
            self.first = int(self.firsts[order[0]])
            self.maps = self.buf[order].reshape(
                (-1,) + self.buf.shape[2:]).copy()


def window_counts(batches, w0: float, w1: float):
    """(attempted, failed) maps of the batches ``(finish time, first seq,
    K)`` that finished in ``[w0, w1)``: a batch whose first sequence does
    not follow the batch before it fails whole."""
    attempted = failed = 0
    prev_end = None
    for t, first, k in batches:
        if w0 <= t < w1:
            attempted += k
            if prev_end is not None and first != prev_end:
                failed += k
        prev_end = first + k
    return attempted, failed


def _drive(run, frames):
    from zybo_rt_sampler_image_detection_torch.apps import pipeline as pl
    from zybo_rt_sampler_image_detection_torch.ingest import receiver as rx

    tp, cfg = run.traffic, run.cfg
    K, cap = int(tp["batch"]), len(frames)
    n_check, n_hist = int(tp["check_maps"]), int(tp["history_frames"])
    if cap < 3 * K or cap % K or n_check % K:
        raise ValueError("capture_frames and check_maps must be whole "
                         "batches, three of them or more")
    channels = cfg.active_arrays * cfg.rows * cfg.columns
    p = pl.Pipeline(cfg, run.config["algorithm"], backend="python",
                    device=run.device, ring_frames=cap)
    ring = _feeding_ring(rx.FrameRing)(frames)
    del frames                            # the ring holds the recording
    p.receiver.buffer = ring
    keeper = _RunKeeper(n_check // K, K, (cfg.max_res_x, cfg.max_res_y),
                        run.seed)
    sink = _Sink(keeper)
    stage = p.make_heatmap_batched(batch=K, sink=sink, channels=channels)
    counts = getattr(stage.stateful_fn, "counts", None)
    if counts is None:
        raise RuntimeError("the stream cell reports the program's stream "
                           "counters, and this program keeps none")
    if run.break_fn is not None:
        stage.power_fn = run.break_fn(stage.power_fn)
    stage.warmup()
    feeder = _Feeder(ring, K)
    try:
        p.run_stage(stage)
        feeder.start()
        time.sleep(float(tp["settle_s"]))
        ready = time.perf_counter()
        with (contextlib.nullcontext() if run.trace else
              trace_mod.KernelClock()) as clock:
            l0, m0 = common.launch_counts(), dict(counts)
            c0 = common.thread_cpu_s(stage.native_id)
            calls0, starved0 = ring.calls, ring.starved
            sink.w0 = w0 = time.perf_counter()
            sink.w1 = w1 = w0 + run.seconds
            time.sleep(max(0.0, w1 - time.perf_counter()))
            c1 = common.thread_cpu_s(stage.native_id)
            l1, m1 = common.launch_counts(), dict(counts)
        calls, starved = ring.calls - calls0, ring.starved - starved0
        if run.trace:
            with trace_mod.DeviceTrace(stage.ident) as tr:
                tr.hold(float(tp["trace_s"]))
            run.trace_summary = tr.summary
            run.layer["traced_batches"] = sum(
                1 for t, _, _ in sink.batches if tr.t0 <= t < tr.t1)
    finally:
        feeder.stop = True
        with ring.fed:
            ring.fed.notify_all()
        p.stop()
        feeder.join(timeout=5)
    if feeder.error is not None:
        raise RuntimeError("the feeder failed") from feeder.error
    n_batches = sum(1 for t, _, _ in sink.batches if w0 <= t < w1)
    run.attempted, run.failed = window_counts(sink.batches, w0, w1)
    done = run.attempted - run.failed
    run.e2e["heatmaps_per_s"] = done / run.seconds
    if clock is not None:
        run.e2e["card_heatmaps_per_s"] = (done / clock.kernel_s
                                          if clock.kernel_s > 0
                                          else float("nan"))
        run.layer["window_kernel_s"] = clock.kernel_s
    run.e2e["setup_s"] = ready - run.t_start
    run.layer.update(batch=K, channels=channels, window_batches=n_batches,
                     stage_cpu_s=c1 - c0, reads=calls, starved_reads=starved)
    note = common.backend_note(l0, l1, n_batches)
    note["mvdr_per_batch"] = {k: (m1[k] - m0[k]) / max(n_batches, 1)
                              for k in m1}
    run.notes["backend"] = note
    common.say(f"yardstick: feeder starved {starved} of {calls} reads "
               f"({100.0 * starved / max(calls, 1):.3f}%)")
    common.say(f"yardstick: backend {note}")
    if keeper.maps is None:
        return None, None
    start = sink.batches[0][1]            # the stream's first frame
    h0 = max(start, keeper.first - n_hist)
    seqs = np.arange(h0, keeper.first + len(keeper.maps))
    run.layer.update(check_first_seq=keeper.first, stream_first_seq=start)
    return (StreamSample(frames=ring.frame_of(seqs), first=h0 - start,
                         n=len(keeper.maps), mvdr=dict(run.config["mvdr"])),
            keeper.maps)


def run(run):
    run.frames, run.maps = _drive(
        run, common.make_inputs(run, int(run.traffic["capture_frames"])))
    common.release_device(run)
