"""The per-layer metrics that read the program's spans
(``utils.profiling.report()``): each on a synthetic report, where its
spans are missing, on a program with no report, and in a traced run of
the replay cell on the CPU; and their entries in ``BENCHMARK.json``."""

import math
import os

import pytest

from portbench import harness
from portbench.tests.tinyrun import tiny_run

# metric -> (the spans it reads, total or self time)
READS = {
    "ingest_copy_ms_per_batch.replay": (("ingest.read_batch",), "self_s"),
    "ingest_wait_ms_per_batch.replay": (("ingest.wait",), "total_s"),
    "stage_slot_copy_ms_per_batch.replay": (("stage.slot_copy",),
                                            "total_s"),
    "power_host_ms_per_batch.replay": (("power.program",), "total_s"),
    "stage_device_wait_ms_per_batch.replay": (
        ("stage.slot_wait", "stage.finish_wait"), "total_s"),
}
# the spans a CPU run of the full-rate stage opens (no pinned slot)
ON_THE_CPU = ("ingest_copy_ms_per_batch.replay",
              "ingest_wait_ms_per_batch.replay",
              "power_host_ms_per_batch.replay")


def _span(n, total, own=None):
    return {"n": n, "total_s": total, "self_s": total if own is None
            else own, "max_s": total / n}


REPORT = {
    "stage.batch": _span(200, 0.8, 0.02),
    "ingest.read_batch": _span(200, 0.34, 0.3),
    "ingest.wait": _span(200, 0.04),
    "stage.slot_wait": _span(200, 0.01),
    "stage.slot_copy": _span(200, 0.08),
    "power.program": _span(200, 0.06, 0.01),
    "stage.finish_wait": _span(200, 0.03),
}
EXPECTED = {                      # ms a batch of REPORT
    "ingest_copy_ms_per_batch.replay": 1.5,
    "ingest_wait_ms_per_batch.replay": 0.2,
    "stage_slot_copy_ms_per_batch.replay": 0.4,
    "power_host_ms_per_batch.replay": 0.3,
    "stage_device_wait_ms_per_batch.replay": 0.2,
}


def _with_report(monkeypatch, rep):
    from zybo_rt_sampler_image_detection_torch.utils import profiling

    monkeypatch.setattr(profiling, "report", lambda: rep)


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_on_a_synthetic_report(metric, monkeypatch):
    _with_report(monkeypatch, REPORT)
    value = harness.load_reader(metric).read(None)
    assert value == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_gives_none_without_its_spans(metric, monkeypatch):
    names, _ = READS[metric]
    _with_report(monkeypatch, {k: v for k, v in REPORT.items()
                               if k not in names})
    assert harness.load_reader(metric).read(None) is None
    # no batch to divide by
    _with_report(monkeypatch, {k: v for k, v in REPORT.items()
                               if k != "stage.batch"})
    assert harness.load_reader(metric).read(None) is None


def test_readers_give_none_on_a_program_without_spans(monkeypatch):
    """A tree before the spans (its ``profiling`` has no ``report``)."""
    from zybo_rt_sampler_image_detection_torch.utils import profiling

    monkeypatch.delattr(profiling, "report")
    for metric in READS:
        assert harness.load_reader(metric).read(None) is None


def test_a_traced_cpu_run_reads_the_spans_it_has():
    spec = harness.load_spec(os.path.dirname(harness.HERE))
    run = tiny_run("replay", seconds=0.5, trace=True)
    line = harness.execute(run, spec)
    m = line["metrics"]
    for metric in ON_THE_CPU:
        assert math.isfinite(m[metric]["value"]) and \
            m[metric]["value"] >= 0, metric
        assert m[metric]["unit"] == "ms"
    # no pinned slot, no device to wait on: left out of the line
    assert "stage_slot_copy_ms_per_batch.replay" not in m
    assert "stage_device_wait_ms_per_batch.replay" not in m


def test_the_span_metrics_entries():
    spec = harness.load_spec(os.path.dirname(harness.HERE))
    entries = {m["name"]: m for m in spec["per_layer"]}
    cells = [w["name"] for w in spec["workloads"]]
    for metric in READS:
        m = entries[metric]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == \
            ("ms", "lower", "host_clock", "card_heatmaps_per_s")
        assert m["workloads"] == ["cfgjson.replay", "onboard64.replay"]
        assert set(m["workloads"]) <= set(cells)
