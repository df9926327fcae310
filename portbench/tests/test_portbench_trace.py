"""The reduction of a profiler window to busy time, device operations and
labelled idle gaps."""

import pytest

from portbench import trace


def test_trace_summary_of_a_synthetic_window():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.MARK,
           "ts": 0.0, "dur": 1000.0, "tid": 1}]
    # device: kernels 100-300 and 500-600, a copy 250-400
    ev += [{"ph": "X", "cat": "kernel", "name": "k", "ts": 100.0,
            "dur": 200.0},
           {"ph": "X", "cat": "kernel", "name": "k", "ts": 500.0,
            "dur": 100.0},
           {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 250.0,
            "dur": 150.0}]
    # host, thread 7 launches: a long op spans the gap 400-500, nothing
    # is open in 600-1000 but a sampled Python frame
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": 90.0,
            "dur": 5.0, "tid": 7},
           {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 380.0,
            "dur": 200.0, "tid": 7},
           {"ph": "X", "cat": "cpu_op", "name": "inner", "ts": 420.0,
            "dur": 60.0, "tid": 7},
           {"ph": "X", "cat": "cpu_op", "name": "early", "ts": 0.0,
            "dur": 10.0, "tid": 7}]
    s = trace.summarize(ev, samples=[(790.0, "a.py:f < b.py:g")])
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(400e-6)      # 100-400, 500-600
    assert s["kernel_s"] == pytest.approx(300e-6)
    assert dict(s["device_ops"]) == pytest.approx({"k": 300e-6,
                                                   "c": 150e-6})
    gaps = dict(s["idle_gaps"])
    assert gaps["inner"] == pytest.approx(100e-6)     # 400-500, mid 450
    assert gaps["py: a.py:f < b.py:g"] == pytest.approx(400e-6)
    assert gaps["(no traced op)"] == pytest.approx(100e-6)   # 0-100
