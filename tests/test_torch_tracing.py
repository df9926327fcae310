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
* the ring's counters reach ``Pipeline.report()["ingest"]``.

No UDP: the frames are published into the receiver's ring directly."""

import glob
import json
import time

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
    the sink got, the spans' report, the Chrome trace's events and the
    pipeline's report."""
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
    return firsts, profiling.report(), events, p.report()


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
    firsts, rep, events, _ = _stage_run(str(tmp_path))
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
    firsts, rep, _, _ = stage_run
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
    firsts, _, _, report = stage_run
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
