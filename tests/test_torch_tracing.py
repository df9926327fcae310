"""The port's spans (``utils/profiling.annotate``) and the frame ring's
counters, on the CPU:

* with no profiler a span is the shared no-op and records nothing;
* under ``profiling.trace()`` the full-rate stage's spans land in the
  Chrome trace, each nested in its ``stage.batch`` on the stage thread,
  with the aten ops inside them, and carry the batch's first sequence
  number as their ``record_function`` args;
* self time is the duration less the child spans';
* a ``Config.tiny()`` full-rate stage counts one ``stage.batch`` a batch
  and as many of every per-batch span;
* the ring's counters reach ``Pipeline.report()["ingest"]``;
* the session's timeline: a span ended with nothing recording leaves no
  record, the spans' clock maps onto the profiler's, the stage thread's
  spans carry its native id also where the session records the starting
  thread alone, and device activity is attributed to the spans that
  launched it (on synthetic records; the card test runs it on kernels).

No UDP: the frames are published into the receiver's ring directly."""

import dis
import glob
import json
import statistics
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from zybo_rt_sampler_image_detection_torch.apps import pipeline
from zybo_rt_sampler_image_detection_torch.config import Config
from zybo_rt_sampler_image_detection_torch.utils import profiling

torch.set_num_threads(2)

K = 4
N_FRAMES = 32
# spans the CPU branch of the stage opens once a batch
PER_BATCH = ("stage.batch", "ingest.read_batch", "power.program",
             "power.pad", "stage.consume")


class _Args:
    """Stands in for ``record_function``: keeps each range's name and
    args, in the order they open."""

    def __init__(self, monkeypatch):
        self.seen = []
        real = torch.autograd.profiler.record_function
        seen = self.seen

        class Recorded(real):
            def __init__(self, name, args=None):
                seen.append((name, args))
                super().__init__(name, args)

        monkeypatch.setattr(torch.autograd.profiler, "record_function",
                            Recorded)


def _stage_run(logdir):
    """A tiny full-rate stage (K=4, the Python ring, the CPU) over 32
    frames published before it starts, run inside ``profiling.trace``
    after its warm-up; returns the first sequence numbers of the batches
    the sink got, the spans' report, the Chrome trace's events, the
    pipeline's report, the session's timeline and the stage thread's
    native id."""
    cfg = Config.tiny()
    p = pipeline.Pipeline(cfg, "lerp", backend="python", device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(N_FRAMES):
        p.receiver.buffer.publish(rng.standard_normal(
            (cfg.n_microphones, cfg.n_samples)).astype(np.float32))
    firsts = []
    stage = p.make_heatmap_batched(
        batch=K, sink=lambda powers, first: firsts.append(first))
    stage.warmup()
    with profiling.trace(logdir):
        p.run_stage(stage)
        deadline = time.monotonic() + 30
        while len(firsts) < N_FRAMES // K and time.monotonic() < deadline:
            time.sleep(0.02)
        p.stop()
    (path,) = glob.glob(f"{logdir}/trace_*.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return (firsts, profiling.report(), events, p.report(),
            profiling.timeline(), stage.native_id)


@pytest.fixture(scope="module")
def stage_run(tmp_path_factory):
    return _stage_run(str(tmp_path_factory.mktemp("trace")))


def test_spans_off_without_a_profiler(tmp_path, monkeypatch):
    with profiling.trace(str(tmp_path)):     # a session empties the report
        pass
    assert profiling.report() == {}

    def refuse(*a, **kw):
        raise AssertionError("a span opened a range with nothing recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    span = profiling.annotate("stage.batch", 1)
    assert span is profiling.annotate("power.program")    # one shared no-op
    with span:
        with profiling.annotate("power.kernel"):
            torch.ones(8).sum()
    assert profiling.report() == {}


def test_trace_nests_the_stage_spans(tmp_path, monkeypatch):
    args = _Args(monkeypatch)
    firsts, rep, events, *_ = _stage_run(str(tmp_path))
    assert len(firsts) == N_FRAMES // K
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name") in rep]
    batches = [e for e in spans if e["name"] == "stage.batch"]
    # the trace also holds the iterations whose read timed out (the
    # report counts none of them)
    assert len(batches) >= len(firsts) == rep["stage.batch"]["n"]
    tid = batches[0]["tid"]

    def parent(e):
        return [b for b in batches if b["tid"] == e["tid"]
                and b["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= b["ts"] + b["dur"]]

    names = {e["name"] for e in spans}
    assert set(PER_BATCH) | {"ingest.wait"} <= names
    # every span of a batch inside one stage.batch, but the last batch's
    # consume: it runs after the next read timed out
    outside = [e["name"] for e in spans if e["ts"] >= batches[0]["ts"]
               and e["name"] not in ("stage.batch", "ingest.wait")
               and len(parent(e)) != 1]
    assert outside == ["stage.consume"]
    # the aten ops of the power program on the same thread and clock
    prog = [e for e in spans if e["name"] == "power.program"]
    aten = [e for e in events if e.get("cat") == "cpu_op"
            and e.get("tid") == tid]
    assert any(p["ts"] <= a["ts"] and a["ts"] + a["dur"] <= p["ts"] + p["dur"]
               for p in prog for a in aten)
    # each range's args: the first sequence number of its batch (the
    # reads that timed out ask for the one after the last)
    ids = {str(f) for f in firsts}
    idle = {str(N_FRAMES + 1)}
    opened = [(n, a) for n, a in args.seen if n in PER_BATCH]
    assert {a for n, a in opened if n == "stage.batch"} == ids | idle
    assert {a for _, a in opened} == ids | idle


def test_self_time_is_duration_less_children(tmp_path, monkeypatch):
    args = _Args(monkeypatch)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("outer", 7):
            time.sleep(0.004)
            for _ in range(2):
                with profiling.annotate("inner"):
                    time.sleep(0.003)
                    with profiling.annotate("leaf"):
                        time.sleep(0.001)
        with pytest.raises(RuntimeError):
            with profiling.annotate("failed"):
                raise RuntimeError("not counted")
    rep = profiling.report()
    outer, inner, leaf = rep["outer"], rep["inner"], rep["leaf"]
    assert (outer["n"], inner["n"], leaf["n"]) == (1, 2, 2)
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - inner["total_s"], abs=1e-9)
    assert inner["self_s"] == pytest.approx(
        inner["total_s"] - leaf["total_s"], abs=1e-9)
    assert leaf["self_s"] == leaf["total_s"] >= 0.002
    assert outer["self_s"] >= 0.004 and inner["self_s"] >= 0.006
    assert inner["max_s"] >= inner["total_s"] / 2
    assert "failed" not in rep
    # a span without an id takes its enclosing span's
    assert [a for n, a in args.seen if n in ("outer", "inner", "leaf")] \
        == ["7"] * 5


def test_tiny_stage_counts_one_span_a_batch(stage_run):
    firsts, rep, *_ = stage_run
    n = len(firsts)
    assert n == N_FRAMES // K
    for name in PER_BATCH:
        assert rep[name]["n"] == n, name
    # one wait a read; the reads that timed out count there alone
    assert rep["ingest.wait"]["n"] >= n
    for name, r in rep.items():
        assert 0.0 <= r["self_s"] <= r["total_s"] + 1e-12, name
        assert r["max_s"] <= r["total_s"] + 1e-12, name
    # no slot on the CPU branch
    assert "stage.slot_copy" not in rep and "stage.finish_wait" not in rep


def test_ring_counters_in_pipeline_report(stage_run):
    firsts, _, _, report, *_ = stage_run
    ingest = report["ingest"]
    assert {"packets", "frames", "gaps"} <= set(ingest)
    assert ingest["published"] == N_FRAMES
    assert ingest["batches_read"] == len(firsts)
    assert ingest["lag_max"] >= 0
    # the frames were all there before the stage started: its first read
    # saw the whole backlog, and only the reads past the end waited
    assert ingest["lag_max"] == N_FRAMES
    assert ingest["waits"] >= 1


def test_spans_from_many_threads_all_count(tmp_path):
    """The aggregate is shared by every thread: more threads than cores,
    with the interpreter switching threads often, lose no span."""
    import os
    import sys
    import threading

    n_threads, n_spans = 2 * (os.cpu_count() or 2) + 2, 300
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.trace(str(tmp_path)):
            def work(i):
                for j in range(n_spans):
                    with profiling.annotate("outer", i):
                        with profiling.annotate("inner"):
                            pass

            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    rep = profiling.report()
    assert rep["outer"]["n"] == rep["inner"]["n"] == n_threads * n_spans
    assert rep["outer"]["self_s"] == pytest.approx(
        rep["outer"]["total_s"] - rep["inner"]["total_s"], abs=1e-6)


def test_off_spans_record_nothing_on_the_timeline(tmp_path):
    """With no session a span is the shared no-op: ``annotate`` reads
    the flag and the shared span alone, allocates nothing, and nothing
    reaches the timeline."""
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("kept"):
            pass
    before = profiling.timeline()
    assert [r[0] for r in before] == ["kept"]
    # the off path: the flag, then the shared span
    loads = []
    for ins in dis.get_instructions(profiling.annotate):
        if ins.opname.startswith("RETURN"):
            break
        if ins.opname == "LOAD_GLOBAL":
            loads.append(ins.argval)
    assert loads == ["_on", "_OFF"]
    assert profiling.annotate("stage.batch", 1) is profiling._OFF

    def spans(n):
        for i in range(n):
            with profiling.annotate("stage.batch", i):
                with profiling.annotate("power.kernel"):
                    pass

    spans(100)                          # warm
    tracemalloc.start()
    try:
        snap0 = tracemalloc.take_snapshot()
        spans(2000)
        snap1 = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = tracemalloc.Filter(True, profiling.__file__)
    grew = [d for d in snap1.filter_traces([mine]).compare_to(
        snap0.filter_traces([mine]), "lineno") if d.size_diff > 0]
    assert grew == []
    assert profiling.timeline() == before
    assert profiling.session()["dropped"] == 0


def test_timeline_is_bounded(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "TIMELINE_CAP", 3)
    with profiling.trace(str(tmp_path)):
        for i in range(5):
            with profiling.annotate("s", i):
                pass
    assert [r[1] for r in profiling.timeline()] == [0, 1, 2]
    assert profiling.report()["s"]["n"] == 5
    assert profiling.session()["dropped"] == 2


def test_timeline_is_on_the_profiler_clock(tmp_path):
    """A span on the starting thread, mapped through ``timeline()``,
    brackets its own ``record_function`` range in the Chrome trace
    within 50 us at each end."""
    with profiling.trace(str(tmp_path)):
        for i in range(12):
            with profiling.annotate("probe", i):
                time.sleep(0.001)
    (path,) = glob.glob(f"{tmp_path}/trace_*.json")
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    ranges = sorted((round(e["ts"] * 1e3) + base,
                     round((e["ts"] + e["dur"]) * 1e3) + base)
                    for e in trace["traceEvents"]
                    if e.get("cat") == "user_annotation"
                    and e.get("name") == "probe")
    spans = sorted((t0, t1) for n, _, tid, t0, t1 in profiling.timeline()
                   if n == "probe" and tid == threading.get_native_id())
    assert len(ranges) == len(spans) == 12
    head = [a - t0 for (a, _), (t0, _) in zip(ranges, spans)]
    tail = [t1 - b for (_, b), (_, t1) in zip(ranges, spans)]
    # each range inside its span but for the calibration's few us, the
    # ends close (the first range pays for torch's first record_function)
    assert min(head) > -5e3 and min(tail) > -5e3, (head, tail)
    assert statistics.median(head) < 50e3 and \
        statistics.median(tail) < 50e3, (head, tail)


def test_stage_thread_spans_on_the_timeline(stage_run):
    firsts, rep, _, _, tl, native = stage_run
    mine = [r for r in tl if r[2] == native]
    assert native != threading.get_native_id()
    for name in PER_BATCH:
        assert sum(1 for r in mine if r[0] == name) == rep[name]["n"], name
    # the batches' spans nest: each program inside its batch
    batches = sorted((a, b) for n, _, _, a, b in mine if n == "stage.batch")
    for n, _, _, a, b in mine:
        if n == "power.program":
            assert any(a0 <= a and b <= b1 for a0, b1 in batches)
    assert all(a <= b for *_, a, b in tl)
    # the CPU records no device activity: the device fields read 0
    for name in PER_BATCH:
        assert rep[name]["device_s"] == rep[name]["device_self_s"] \
            == rep[name]["copy_s"] == rep[name]["idle_s"] == 0.0


def test_stage_thread_spans_without_every_thread():
    """A session that records the starting thread's ranges alone (as the
    benchmark's ``DeviceTrace`` opens one) still places the stage
    thread's spans on the timeline, under its native id."""
    from torch.profiler import ProfilerActivity, profile

    cfg = Config.tiny()
    p = pipeline.Pipeline(cfg, "lerp", backend="python", device="cpu")
    rng = np.random.default_rng(4)
    for _ in range(16):
        p.receiver.buffer.publish(rng.standard_normal(
            (cfg.n_microphones, cfg.n_samples)).astype(np.float32))
    firsts = []
    stage = p.make_heatmap_batched(
        batch=K, sink=lambda powers, first: firsts.append(first))
    stage.warmup()
    with profile(activities=[ProfilerActivity.CPU]):
        assert not profiling._every
        p.run_stage(stage)
        deadline = time.monotonic() + 30
        while len(firsts) < 16 // K and time.monotonic() < deadline:
            time.sleep(0.02)
        p.stop()
    tl = profiling.timeline()
    batches = [r for r in tl if r[0] == "stage.batch"]
    assert len(batches) == len(firsts) == 16 // K
    assert {r[2] for r in batches} == {stage.native_id}
    assert {r[1] for r in batches} == set(firsts)


def _attributed():
    """Synthetic records on one thread (tid 7): ``outer`` [0, 100]
    around ``inner`` [10, 40] and ``other`` [60, 90], ns.  A kernel
    launched at 20 inside ``inner`` runs [30, 50]; a copy launched at 70
    inside ``other`` runs [55, 58]; a memset launched at 95 in ``outer``
    runs [90, 92]; a kernel launched at 120, after every span, runs
    [120, 130]; window [0, 140]."""
    spans = [("inner", 1, 7, 10, 40), ("other", 1, 7, 60, 90),
             ("outer", 1, 7, 0, 100)]
    launches = {1: (7, 20), 2: (7, 70), 3: (7, 95), 4: (7, 120)}
    device = [(1, "kernel", 30, 50), (2, "memcpy", 55, 58),
              (3, "memset", 90, 92), (4, "kernel", 120, 130)]
    return profiling.attribute(spans, launches, device, (0, 140))


def test_kernel_counts_in_every_span_around_its_launch():
    by, tot = _attributed()
    ns = 1e-9
    assert by["inner"]["device_s"] == pytest.approx(20 * ns)
    assert by["inner"]["device_self_s"] == pytest.approx(20 * ns)
    # inclusive in the span around it, not its own
    assert by["outer"]["device_s"] == pytest.approx((20 + 2) * ns)
    assert by["outer"]["device_self_s"] == pytest.approx(2 * ns)
    assert by["other"]["device_s"] == by["other"]["device_self_s"] == 0.0
    assert tot["device_s"] == pytest.approx((20 + 2 + 10) * ns)
    assert tot["outside_device_s"] == pytest.approx(10 * ns)
    assert tot["launch_tid"] == 7


def test_copies_land_in_copy_s_only():
    by, tot = _attributed()
    assert by["other"]["copy_s"] == pytest.approx(3e-9)
    assert by["outer"]["copy_s"] == pytest.approx(3e-9)
    assert by["inner"]["copy_s"] == 0.0
    assert tot["copy_s"] == pytest.approx(3e-9)
    assert tot["device_s"] == pytest.approx(32e-9)


def test_idle_gap_is_split_by_overlap():
    """Idle stretches: [0, 30] (outer 10, inner 20), [50, 55] (outer),
    [58, 90] (outer 2, other 30), [92, 120] (outer 8, none 20) and
    [130, 140] (none)."""
    by, tot = _attributed()
    ns = 1e-9
    assert by["inner"]["idle_s"] == pytest.approx(20 * ns)
    assert by["other"]["idle_s"] == pytest.approx(30 * ns)
    assert by["outer"]["idle_s"] == pytest.approx((10 + 5 + 2 + 8) * ns)
    assert tot["idle_s"] == pytest.approx(105 * ns)
    assert tot["idle_outside_s"] == pytest.approx(30 * ns)
    assert sum(v["idle_s"] for v in by.values()) + tot["idle_outside_s"] \
        == pytest.approx(tot["idle_s"])
    # a session that recorded no device activity has no idle time
    by, tot = profiling.attribute([("a", 1, 7, 0, 10)], {}, [], None)
    assert by["a"]["idle_s"] == tot["idle_s"] == 0.0


def test_launch_from_a_thread_without_spans():
    """A launch from a thread that opened no span (autograd's device
    thread) goes to the span open then where one thread alone has one;
    with two threads' spans open it stays outside."""
    spans = [("train/backward", 1, 7, 0, 100)]
    by, tot = profiling.attribute(spans, {1: (9, 50)},
                                  [(1, "kernel", 60, 70)], (0, 100))
    assert by["train/backward"]["device_self_s"] == pytest.approx(10e-9)
    spans.append(("feeder", 1, 8, 40, 80))
    by, tot = profiling.attribute(spans, {1: (9, 50)},
                                  [(1, "kernel", 60, 70)], (0, 100))
    assert by["train/backward"]["device_self_s"] == 0.0
    assert tot["outside_device_s"] == pytest.approx(10e-9)


class _Event:
    """Stands in for a ``KinetoEvent`` of a session on the card."""

    def __init__(self, name, corr, t0, dur, device=False, tid=0,
                 annotation=False):
        from torch.autograd import DeviceType

        self._v = (name, corr, t0, dur, tid, annotation)
        self._dev = DeviceType.CUDA if device else DeviceType.CPU

    def name(self):
        return self._v[0]

    def correlation_id(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def device_resource_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]

    def device_type(self):
        return self._dev


def test_device_activity_of_a_session(monkeypatch):
    """Kernels, copies and memsets match the launching ``cu*`` calls by
    correlation id (a torch op's own id may be the same number); the
    device's spans of ranges are left out; a call's thread reads as the
    native id, also where the profiler gives the ``pthread_t`` cut to 32
    bits."""
    import types

    ident = 0x7F3A_9C41_B640
    monkeypatch.setitem(profiling._alias, profiling._cupti_tid(ident), 4242)
    assert profiling._cupti_tid(ident) == 0x9C41_B640 - (1 << 32)
    events = [
        _Event("aten::add", 1, 100, 50, tid=4242),
        _Event("cudaLaunchKernel", 1, 110, 5, tid=4242),
        _Event("cuLaunchKernel", 2, 120, 5,
               tid=profiling._cupti_tid(ident)),
        _Event("cudaMemcpyAsync", 3, 130, 5, tid=4242),
        _Event("cudaMemsetAsync", 4, 140, 5, tid=77),
        _Event("add_kernel", 1, 200, 10, device=True),
        _Event("gemm", 2, 210, 20, device=True),
        _Event("Memcpy HtoD (Pinned -> Device)", 3, 230, 4, device=True),
        _Event("Memset (Device)", 4, 240, 1, device=True),
        _Event("power.kernel", 9, 200, 30, device=True, annotation=True),
    ]
    prof = types.SimpleNamespace(kineto_results=types.SimpleNamespace(
        events=lambda: events))
    launches, device = profiling._device_activity(prof)
    assert launches == {1: (4242, 110), 2: (4242, 120), 3: (4242, 130),
                        4: (77, 140)}
    assert device == [(1, "kernel", 200, 210), (2, "kernel", 210, 230),
                      (3, "memcpy", 230, 234), (4, "memset", 240, 241)]


def test_a_failed_attribution_keeps_the_session(tmp_path, monkeypatch):
    """Where the session's device activity cannot be read, the profile
    ends as it would, the spans keep their host times and ``session()``
    says why."""
    def broken(prof):
        raise AttributeError("no such event field")

    monkeypatch.setattr(profiling, "_device_activity", broken)
    monkeypatch.setattr(profiling, "_records_cuda", lambda prof: True)
    with pytest.warns(RuntimeWarning, match="no device time by span"):
        with profiling.trace(str(tmp_path)):
            with profiling.annotate("kept"):
                pass
    assert glob.glob(f"{tmp_path}/trace_*.json")
    rep = profiling.report()
    assert rep["kept"]["n"] == 1 and "device_s" not in rep["kept"]
    assert "no such event field" in profiling.session()["error"]
