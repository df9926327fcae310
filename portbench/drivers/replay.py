"""Traffic kind ``replay``: a seeded recording replayed in a closed loop
into the full-rate stage, as fast as the stage takes it.

The mix's parameters: ``capture_frames`` (the recording's length; it
cycles, and the receiver's ring holds all of it), ``batch`` (the stage's
K), ``settle_s`` (run before the window opens), ``trace_s`` (the traced
window, after the measured one, in ``--trace 1`` runs), ``check_maps``
(how many maps of the window the check keeps, drawn from the seed) and
``field`` (:func:`portbench.signals.capture`'s keywords).

The system: ``Pipeline(cfg, algorithm, backend="python")`` (a receiver
that never opens a socket), its ``make_heatmap_batched(K, sink,
channels=<connected channels>)``, warmed up with ``warmup()``.  The
receiver's ``FrameRing`` holds the whole recording from set-up on, each
frame in the slot of the sequence numbers it is published under, so a
feeder thread publishes it without copying a byte: a batch at a time, up
to a ring past the last frame the stage has read, so that a read finds
its batch waiting and no frame is overwritten unread.  The host copies
the window sees are then the stage's own (the ring read, the channel
slice, the pinned slot).  The window counts the frames whose batch
finished in it.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np

from portbench import common, trace as trace_mod


class _Sink:
    """The stage's sink: records each finished batch and keeps the
    window's sample of maps."""

    def __init__(self, reservoir):
        self.batches = []                 # (finish time, first seq, K)
        self.reservoir = reservoir
        self.w0 = self.w1 = float("inf")

    def __call__(self, powers, first_seq):
        t = time.perf_counter()
        self.batches.append((t, first_seq, len(powers)))
        if self.w0 <= t < self.w1:
            self.reservoir.offer(powers, first_seq)


class _Feeder(threading.Thread):
    """Publishes the recording a batch at a time, as far ahead of the
    stage's reads as the ring holds."""

    def __init__(self, ring, batch):
        super().__init__(name="portbench-feeder", daemon=True)
        self.ring, self.batch = ring, batch
        self.published = 0
        self.stop = False
        self.error = None

    def _room(self) -> bool:
        return (self.ring.read_end + self.ring.capacity - self.published
                >= self.batch)

    def run(self):
        try:
            self._feed()
        except BaseException as e:        # reported by the driver
            self.error = e
            raise

    def _feed(self):
        import torch

        while not self.stop:
            with self.ring.fed:
                self.ring.fed.wait_for(lambda: self.stop or self._room(),
                                       timeout=0.5)
            with torch.profiler.record_function("portbench.feeder.publish"):
                while not self.stop and self._room():
                    self.ring.publish_batch(self.batch)
                    self.published += self.batch


def _feeding_ring(base):
    class FeedingRing(base):
        """The receiver's ring holding a whole recording, with the
        benchmark's publisher: the ring's slots are filled once, frame
        ``i`` of the recording in slot ``(i + 1) % capacity`` where
        sequence ``s`` lives in slot ``s % capacity``, so the recording
        cycles through the sequence numbers unchanged, and a batch is
        published with one stamp, one sequence step and one wake-up, and
        no copy.  It also counts the reads that found fewer than a batch
        waiting (the feeder starved the stage), and tells the feeder how
        far the stage has read."""

        def __init__(self, frames):
            super().__init__(frames.shape[1], frames.shape[2],
                             capacity=len(frames))
            self._buf = np.roll(frames, 1, axis=0)
            self.fed = threading.Condition()
            self.read_end = 0             # the last sequence copied out
            self.calls = 0
            self.starved = 0

        def frame_of(self, seqs):
            """The recording's frames published under sequences ``seqs``."""
            return self._buf[np.asarray(seqs) % self._cap]

        def publish_batch(self, k):
            first = (self._seq + 1) % self._cap
            head = min(k, self._cap - first)
            with self._cond:
                now = time.perf_counter()
                self._stamps[first:first + head] = now
                self._stamps[:k - head] = now
                self._seq += k
                self._cond.notify_all()

        def read_batch(self, k, next_seq, *a, **kw):
            self.calls += 1
            if self._seq - max(int(next_seq), 1) + 1 < k:
                self.starved += 1
            out = super().read_batch(k, next_seq, *a, **kw)
            if out[0] is not None:
                with self.fed:
                    self.read_end = out[1] + k - 1
                    self.fed.notify()
            return out

    return FeedingRing


def _drive(run, frames):
    from zybo_rt_sampler_image_detection_torch.apps import pipeline as pl
    from zybo_rt_sampler_image_detection_torch.ingest import receiver as rx

    tp, cfg = run.traffic, run.cfg
    K, cap = int(tp["batch"]), len(frames)
    if cap < 3 * K or cap % K:
        raise ValueError("capture_frames must be whole batches, three of "
                         "them or more")
    channels = cfg.active_arrays * cfg.rows * cfg.columns
    p = pl.Pipeline(cfg, run.config["algorithm"], backend="python",
                    device=run.device, ring_frames=cap)
    ring = _feeding_ring(rx.FrameRing)(frames)
    del frames                            # the ring holds the recording
    p.receiver.buffer = ring
    sink = _Sink(common.Reservoir(int(tp["check_maps"]),
                                  (cfg.max_res_x, cfg.max_res_y), run.seed))
    stage = p.make_heatmap_batched(batch=K, sink=sink, channels=channels)
    if run.break_fn is not None:
        stage.power_fn = run.break_fn(stage.power_fn)
    stage.warmup()
    feeder = _Feeder(ring, K)
    try:
        p.run_stage(stage)
        feeder.start()
        time.sleep(float(tp["settle_s"]))
        ready = time.perf_counter()
        # the untraced window's device time, for the card's rate; the
        # profiler starts before the window, outside the set-up
        with (contextlib.nullcontext() if run.trace else
              trace_mod.KernelClock()) as clock:
            l0 = common.launch_counts()
            c0 = common.thread_cpu_s(stage.native_id)
            calls0, starved0 = ring.calls, ring.starved
            sink.w0 = w0 = time.perf_counter()
            sink.w1 = w1 = w0 + run.seconds
            time.sleep(max(0.0, w1 - time.perf_counter()))
            c1 = common.thread_cpu_s(stage.native_id)
            l1 = common.launch_counts()
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
    inside = [(f, n) for t, f, n in sink.batches if w0 <= t < w1]
    done = sum(n for _, n in inside)
    run.attempted = (inside[-1][0] + inside[-1][1] - inside[0][0]
                     if inside else 0)
    run.failed = run.attempted - done
    run.e2e["heatmaps_per_s"] = done / run.seconds
    if clock is not None:
        run.e2e["card_heatmaps_per_s"] = (done / clock.kernel_s
                                          if clock.kernel_s > 0
                                          else float("nan"))
        run.layer["window_kernel_s"] = clock.kernel_s
    run.e2e["setup_s"] = ready - run.t_start
    run.layer.update(batch=K, channels=channels, window_batches=len(inside),
                     stage_cpu_s=c1 - c0, reads=calls, starved_reads=starved)
    run.notes["backend"] = common.backend_note(l0, l1, len(inside))
    bins = [0] * max(1, int(run.seconds))
    for t, _, n in sink.batches:
        if w0 <= t < w1:
            bins[min(len(bins) - 1, int(t - w0))] += n
    run.notes["per_second"] = bins
    common.say(f"yardstick: feeder starved {starved} of {calls} reads "
               f"({100.0 * starved / max(calls, 1):.3f}%)")
    common.say(f"yardstick: backend {run.notes['backend']}")
    keys, maps = sink.reservoir.kept()
    return ring.frame_of(keys), maps


def run(run):
    run.frames, run.maps = _drive(
        run, common.make_inputs(run, int(run.traffic["capture_frames"])))
    common.release_device(run)
