"""The per-layer metrics that read the device time the program's spans
launched (``report()[name]["device_self_s"]``): each on a synthetic
report, ``None`` where the fields, the spans or the batches are missing
and on a program with no report, an error where the session's
attribution failed or found no device time on the card, and their
entries in ``BENCHMARK.json``."""

import os
import types

import pytest
import torch

from portbench import harness

REPLAY = ["cfgjson.replay", "onboard64.replay", "webfft.replay",
          "cfgjson_fine.replay"]
# metric -> (the spans it reads, its cells)
READS = {
    "power_prep_device_ms_per_batch.replay": (
        ("power.pad", "power.inputs", "power.fft_spectra"), REPLAY),
    "power_kernel_device_ms_per_batch.replay": (
        ("power.kernel", "power.fft_contract"), REPLAY),
    "mvdr_scan_device_ms_per_batch.stream": (
        ("power.mvdr_scan", "power.pad"), ["cfgjson_mvdr.stream"]),
    "mvdr_d0_device_ms_per_batch.stream": (
        ("power.mvdr_d0",), ["cfgjson_mvdr.stream"]),
    "mvdr_refresh_device_ms_per_batch.stream": (
        ("power.mvdr_refresh",), ["cfgjson_mvdr.stream"]),
}


def _span(n, device_self):
    return {"n": n, "total_s": 0.5, "self_s": 0.1, "max_s": 0.01,
            "device_s": device_self, "device_self_s": device_self,
            "copy_s": 0.0, "idle_s": 0.0}


REPORT = {
    "stage.batch": _span(400, 0.0),
    "power.program": _span(400, 0.004),
    "power.pad": _span(400, 0.002),
    "power.inputs": _span(400, 0.008),
    "power.fft_spectra": _span(400, 0.0),
    "power.kernel": _span(400, 0.12),
    "power.fft_contract": _span(400, 0.0),
    "power.mvdr_scan": _span(400, 0.16),
    "power.mvdr_d0": _span(200, 0.24),
    "power.mvdr_refresh": _span(100, 0.2),
}
EXPECTED = {                      # ms a batch of REPORT
    "power_prep_device_ms_per_batch.replay": 0.025,
    "power_kernel_device_ms_per_batch.replay": 0.3,
    "mvdr_scan_device_ms_per_batch.stream": 0.405,
    "mvdr_d0_device_ms_per_batch.stream": 0.6,
    "mvdr_refresh_device_ms_per_batch.stream": 0.5,
}


SESSION = {"device_s": 0.4, "copy_s": 0.01, "idle_s": 0.2,
           "idle_outside_s": 0.001, "outside_device_s": 0.0,
           "launch_tid": 4242, "offset_ns": 0, "dropped": 0,
           "attribute_s": 0.3}
ON_CARD = types.SimpleNamespace(device=torch.device("cuda", 0))


def _with_report(monkeypatch, rep, ses=SESSION):
    from zybo_rt_sampler_image_detection_torch.utils import profiling

    monkeypatch.setattr(profiling, "report", lambda: rep)
    monkeypatch.setattr(profiling, "session", lambda: ses)
    monkeypatch.setattr(profiling, "timeline", lambda: [
        ("stage.batch", 0, 4242, 0, 10), ("power.kernel", 0, 4242, 2, 8)])


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_on_a_synthetic_report(metric, monkeypatch):
    _with_report(monkeypatch, REPORT)
    value = harness.load_reader(metric).read(None)
    assert value == pytest.approx(EXPECTED[metric])
    assert harness.load_reader(metric).read(ON_CARD) == value


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_gives_none_without_its_fields(metric, monkeypatch):
    names, _ = READS[metric]
    # a program whose report keeps host times alone (the parent's)
    _with_report(monkeypatch, {
        k: {f: v[f] for f in ("n", "total_s", "self_s", "max_s")}
        for k, v in REPORT.items()})
    assert harness.load_reader(metric).read(None) is None
    # none of its spans ran
    _with_report(monkeypatch, {k: v for k, v in REPORT.items()
                               if k not in names})
    assert harness.load_reader(metric).read(None) is None
    # they ran and launched nothing
    _with_report(monkeypatch, {**REPORT, **{k: _span(400, 0.0)
                                            for k in names}})
    assert harness.load_reader(metric).read(None) is None
    # no batch to divide by
    _with_report(monkeypatch, {k: v for k, v in REPORT.items()
                               if k != "stage.batch"})
    assert harness.load_reader(metric).read(None) is None


@pytest.mark.parametrize("missing", ["report", "session"])
def test_readers_give_none_on_a_program_without_spans(missing,
                                                      monkeypatch):
    """A tree before the spans (its ``profiling`` has no ``report``), or
    before their device time (no ``session``)."""
    from zybo_rt_sampler_image_detection_torch.utils import profiling

    _with_report(monkeypatch, REPORT)
    monkeypatch.delattr(profiling, missing)
    for metric in READS:
        assert harness.load_reader(metric).read(ON_CARD) is None


@pytest.mark.parametrize("metric", sorted(READS))
def test_reader_raises_where_the_attribution_failed(metric, monkeypatch):
    """A failed attribution, a session on the card that attributed no
    device time, or one whose launches matched no spanning thread, is an
    error, not a metric left out."""
    _with_report(monkeypatch, REPORT, {"error": "Traceback: no field"})
    with pytest.raises(RuntimeError, match="no field"):
        harness.load_reader(metric).read(ON_CARD)
    with pytest.raises(RuntimeError, match="no field"):
        harness.load_reader(metric).read(None)
    _with_report(monkeypatch, REPORT, {**SESSION, "device_s": 0.0})
    with pytest.raises(RuntimeError, match="no device time"):
        harness.load_reader(metric).read(ON_CARD)
    # the launches' thread matched no thread that opened a span
    _with_report(monkeypatch, REPORT, {**SESSION, "launch_tid": 77})
    with pytest.raises(RuntimeError, match="opened no span"):
        harness.load_reader(metric).read(ON_CARD)
    # the CPU records no device time: nothing to read, no error
    assert harness.load_reader(metric).read(
        types.SimpleNamespace(device=torch.device("cpu"))) \
        == pytest.approx(EXPECTED[metric])


def test_the_span_device_entries():
    spec = harness.load_spec(os.path.dirname(harness.HERE))
    entries = {m["name"]: m for m in spec["per_layer"]}
    cells = [w["name"] for w in spec["workloads"]]
    for metric, (_, where) in READS.items():
        m = entries[metric]
        assert (m["unit"], m["better"], m["source"], m["layer"],
                m["moves"]) == ("ms", "lower", "device_trace",
                                "power program", "card_heatmaps_per_s")
        assert m["workloads"] == where
        assert set(m["workloads"]) <= set(cells)
