"""The replay driver at ``Config.tiny()`` on the CPU, and the faults the
check has to catch: a run with the timed path broken underneath comes
out not correct."""

import pytest
import torch

from portbench import harness
from portbench.tests.tinyrun import LIMIT, tiny_run


def _spec():
    return harness.load_spec(harness.os.path.dirname(harness.HERE))


def altered(fn):
    """Every other map of a batch off by 1% of its peak at one pixel."""
    def f(x):
        out = fn(x).clone()
        peak = out.flatten(-2).amax(-1)
        if out.ndim == 3:
            out[::2, 0, 0] += 0.01 * peak[::2]
        else:
            out[0, 0] += 0.01 * peak
        return out
    return f


def shifted(fn):
    """Each map keyed to the frame before (an off-by-one)."""
    def f(x):
        return torch.roll(fn(x), 1, dims=0)
    return f


def half_batch(fn):
    """The second half of a batch left out, the first half's maps in its
    place."""
    def f(x):
        h = (x.shape[0] + 1) // 2
        out = fn(x[:h])
        return torch.cat([out, out])[:x.shape[0]]
    return f


def stale(fn):
    """The previous call's maps (a step that returns its state)."""
    last = []

    def f(x):
        out = fn(x)
        prev = last[0] if last else torch.zeros_like(out)
        last[:] = [out]
        return prev
    return f


def test_replay_cell_is_correct_and_fed():
    run = tiny_run("replay", seconds=1.0)
    line = harness.execute(run, _spec())
    assert line["correct"] is True
    assert line["attempted"] > 1000 and line["failed"] == 0
    assert line["checks"]["map_gap"]["value"] < LIMIT / 10
    assert run.e2e["heatmaps_per_s"] > 0 and run.e2e["setup_s"] > 0
    assert run.layer["starved_reads"] <= 0.05 * run.layer["reads"]
    assert len(run.frames) == 32 == len(run.maps)


@pytest.mark.parametrize("fault", [altered, shifted, half_batch, stale])
def test_replay_check_catches(fault):
    line = harness.execute(tiny_run("replay", seconds=0.5, break_fn=fault),
                           _spec())
    assert line["correct"] is False
    assert line["checks"]["map_gap"]["value"] > LIMIT


def test_replay_traced_run_reads_its_layers():
    run = tiny_run("replay", seconds=0.5, trace=True)
    line = harness.execute(run, _spec())
    m = line["metrics"]
    # no card: no kernel time, so no roofline share; the rest reads
    assert "power_roofline" not in m
    assert m["device_idle_share.replay"]["value"] == 100.0
    assert m["stage_cpu_ms_per_batch.replay"]["value"] > 0
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
