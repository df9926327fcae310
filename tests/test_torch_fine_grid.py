"""The upstream camera on a 4x finer grid (``portbench/configs/
cfgjson_fine.json``, 228x128): its configuration, the policy's choice of
the time-domain kernel there, the per-layer metric of that route, and
what ``Pipeline.report()`` says of it.  On the CPU: the full grid's
tables (1.46 GB of ``W``) are never built here; the equiv bar reads a
``device="meta"`` ``W`` of the full shape, with the tap span and
``tau_min`` of real tables at a small grid of the same window.  The card
half is ``portbench/tests/test_portbench_fine_card.py``."""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from portbench import harness, roofline
from zybo_rt_sampler_image_detection_torch import Config
from zybo_rt_sampler_image_detection_torch.apps import pipeline
from zybo_rt_sampler_image_detection_torch.ops import (beamform, fused_kernel,
                                                       geometry)
from zybo_rt_sampler_image_detection_torch.utils import profiling

ROOT = os.path.dirname(harness.HERE)
H100 = "NVIDIA H100 80GB HBM3"


def _fine(control=False):
    with open(os.path.join(ROOT, "portbench", "configs",
                           "cfgjson_fine.json")) as f:
        config = json.load(f)
    return config, harness.make_config(config, control=control)


def _small_tables(cfg):
    """Real lerp tables of ``cfg``'s window at a 12x8 grid."""
    return beamform.make_tables(cfg.replace(max_res_x=12, max_res_y=8),
                                "lerp", cache=False, device="cpu")


def _at_grid(t, X, Y):
    """``t`` with a ``W`` of X*Y directions on the meta device."""
    return dataclasses.replace(t, W=torch.empty(
        (X * Y,) + tuple(t.W.shape[1:]), device="meta"), res_x=X, res_y=Y)


class _OnCard:
    """Tables the policy takes for the card's."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda")

    def __getattr__(self, name):
        return getattr(self._t, name)


def test_fine_configuration_is_cfgjson_at_a_4x_grid():
    config, cfg = _fine()
    with open(os.path.join(ROOT, "portbench", "configs",
                           "cfgjson.json")) as f:
        base = json.load(f)
    changed = {k for k in base if config.get(k) != base[k]}
    assert changed <= {"source", "deployment", "assumed", "max_res_x",
                       "max_res_y", "control"}
    assert (cfg.max_res_x, cfg.max_res_y) == (228, 128)
    assert cfg.n_directions == 29184 == 16 * 1824
    assert (cfg.matmul_precision, cfg.matmul_dtype) == ("high", "float32")
    assert config["algorithm"] == "lerp" and config["reduced"] == []
    assert config["limits"] == {"map_gap": 1e-4}
    assert any("228" in a for a in config["assumed"])
    spec = harness.load_spec(ROOT)
    cell = harness.find_cell(spec, "cfgjson_fine.replay")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "cfgjson_fine", "replay", 1)
    # the replay cells' roofline, stage rate, stage CPU and idle share,
    # and the power program's device time by span; none of the fft or
    # mvdr routes'
    names = [m["name"] for m in harness.per_layer_of(spec,
                                                     "cfgjson_fine.replay")]
    assert names == ["power_roofline", "stage_heatmaps_per_s.replay",
                     "stage_cpu_ms_per_batch.replay",
                     "device_idle_share.replay",
                     "power_prep_device_ms_per_batch.replay",
                     "power_kernel_device_ms_per_batch.replay"]


def test_fine_control_builds_bf16_tables():
    _, cfg = _fine(control=True)
    assert (cfg.matmul_precision, cfg.matmul_dtype) == ("default",
                                                        "bfloat16")
    t = _small_tables(cfg)
    assert t.W.dtype == torch.bfloat16 and t.precision == "default"
    assert _small_tables(_fine()[1]).W.dtype == torch.float32


def test_small_grid_has_the_fine_grids_tap_span():
    """The window fixes the delays' span, so a 12x8 grid's tables have
    the taps and ``tau_min`` of the 228x128 one."""
    _, cfg = _fine()
    t = _small_tables(cfg)
    whole, _ = geometry.lerp_coefficients(cfg)
    assert t.tau_min == 0 and t.W.shape[1] == int(whole.max()) + 2 == 49
    assert t.W.shape[2] == cfg.n_microphones


@pytest.mark.parametrize("grid,holds", [((57, 32), True), ((171, 96), True),
                                        ((228, 128), False)])
def test_equiv_bar_leaves_k1_only_at_the_fine_grid(grid, holds):
    """The policy's plane, 16*D*M*F bytes, against its 12 GB cap: 1.15 GB
    (cfgjson), 10.35 GB, and 18.41 GB at 228x128, where K1 is left."""
    t = _at_grid(_small_tables(_fine()[1]), *grid)
    assert pipeline._equiv_bar(t) is holds
    from zybo_rt_sampler_image_detection_torch.ops import freq_equiv

    _, F = freq_equiv.equiv_dims(t)
    D, _, M = t.W.shape
    assert F == 154 and M == 256
    assert (16 * D * M * F <= pipeline._EQUIV_PLANE_CAP) is holds


@pytest.mark.parametrize("control", [False, True])
def test_policy_picks_the_time_domain_kernel_at_the_fine_grid(monkeypatch,
                                                              control):
    """On the card, the sound rung and the bf16 control both reach the
    ``fused`` kind (``FusedBeamformer``) at 228x128, at the connected
    channels too."""
    built = []
    monkeypatch.setattr(fused_kernel, "FusedBeamformer",
                        lambda tables: built.append(tables) or "K2")
    t = _at_grid(_small_tables(_fine(control)[1]), 228, 128)
    assert pipeline._select_power_backend(_OnCard(t), 192) == ("fused", "K2")
    assert len(built) == 1 and built[0].W.shape[0] == 29184


def _stub_run(kernel_s, batches, trace=True, kind=H100):
    _, cfg = _fine()
    return types.SimpleNamespace(
        cfg=cfg, trace_summary={"kernel_s": kernel_s} if trace else None,
        layer={"traced_batches": batches, "batch": 16, "channels": 192},
        notes={"device_kind": kind})


def test_power_roofline_reads_the_lerp_bound_over_kernel_time():
    """``power_roofline`` at the fine grid, whichever kernel the policy
    picks there."""
    read = harness.load_reader("power_roofline").read
    bound = roofline.lerp_bound_s(_fine()[1], 16, 192, H100)
    # 4 x 192 channels x 256 samples x 29,184 directions x 16 frames
    # = 91.8 GFLOP: 1.370 ms at the FP32 peak, bound by operations
    assert bound * 1e3 == pytest.approx(1.3705, rel=1e-3)
    assert read(_stub_run(0.5, 50)) == pytest.approx(
        100.0 * bound / (0.5 / 50))
    assert read(_stub_run(0.5, 50, trace=False)) is None
    assert read(_stub_run(0.5, 0)) is None
    assert read(_stub_run(0.0, 50)) is None
    assert read(_stub_run(0.5, 50, kind="some card")) is None


class _OnCardRows:
    """The kernel's rows as a card's tensor shows them to the launch
    count (``is_cuda``)."""
    is_cuda = True

    def __init__(self, s):
        self.s = s


@pytest.fixture
def counted_k2(monkeypatch):
    """``fused_power`` taking its rows as the card's and counting its
    calls as launches, on the CPU's plain version, on a card of
    ``fused_kernel.SMS`` SMs; ``counted.during`` runs inside the launch,
    as a second stage's thread may."""
    plain = fused_kernel.fused_power
    inputs = fused_kernel.FusedBeamformer.kernel_inputs

    def on_card(self, signals):
        s, sj = inputs(self, signals)
        return _OnCardRows(s), sj

    def counted(s, *a, **kw):
        counted.launches += 1
        if counted.during is not None:
            during, counted.during = counted.during, None
            during()
        return plain(s.s, *a, **kw)

    counted.launches, counted.during = 0, None
    monkeypatch.setattr(fused_kernel.FusedBeamformer, "kernel_inputs",
                        on_card)
    monkeypatch.setattr(fused_kernel, "device_sms",
                        lambda index: fused_kernel.SMS)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(fused_kernel, "fused_power", counted)
    return counted


def _tiny():
    return Config.tiny().replace(matmul_precision="high")


def _stage(route, monkeypatch):
    cfg = _tiny()
    algorithm = "fft" if route == "fft" else "lerp"
    backend = "freq_equiv" if route == "freq_equiv" else "auto"
    p = pipeline.Pipeline(cfg, algorithm, backend="python", device="cpu",
                          power_backend=backend)
    if route == "fused":
        monkeypatch.setattr(
            pipeline, "_select_power_backend",
            lambda tables, channels=0: (
                "fused", fused_kernel.FusedBeamformer(tables)))
    stage = p.make_heatmap_batched(batch=4, channels=cfg.n_microphones // 2)
    return p, stage


def _batch(cfg, stage, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((stage.batch, stage.channels,
                                 cfg.n_samples)) * 0.1).astype(np.float32)


def test_report_gives_the_time_domain_routes_launches_and_plan(
        monkeypatch, counted_k2):
    p, stage = _stage("fused", monkeypatch)
    k2 = stage.power_fn.inner
    assert isinstance(k2, fused_kernel.FusedBeamformer)
    stage.warmup()
    for i in range(3):
        stage.launch(torch.from_numpy(_batch(p.cfg, stage, i)))
    p.run_stage(stage)
    p.stop()
    rep = p.report()["time_power"]
    last = fused_kernel.plan(k2.N, k2.M, k2.TK, k2.DP, stage.batch, k2.NL,
                             4, k2.JM, k2.Tc)
    assert k2.last_plan == last
    assert rep == {"launches": 4, "M": k2.M, "TK": k2.TK, "DP": k2.DP,
                   "table_bytes": k2.table_bytes, "G": last.G,
                   "NS": last.NS, "MG": last.MG,
                   "stagings": -(-(k2.DP // 8) // last.G)}
    assert counted_k2.launches == 4
    assert rep["M"] == p.tables.n_mics and rep["DP"] % 8 == 0
    assert rep["table_bytes"] == (k2.Wp.numel() * 4 + k2.bases.numel() * 4
                                  + sum(t.numel() * t.element_size()
                                        for t in k2.wc))


def test_time_domain_spans_enclose_the_programs_host_work(
        monkeypatch, counted_k2, tmp_path):
    """One batch through the stage's ``_dispatch``: ``power.pad``,
    ``power.inputs`` and ``power.kernel`` once each, inside
    ``power.program``."""
    p, stage = _stage("fused", monkeypatch)
    stage.warmup()
    batch = _batch(p.cfg, stage)
    with profiling.trace(str(tmp_path)):
        stage._dispatch(batch, 1)
    rep = profiling.report()
    spans = ("power.pad", "power.inputs", "power.kernel")
    assert all(rep[s]["n"] == 1 for s in spans + ("power.program",))
    assert rep["power.program"]["total_s"] >= sum(rep[s]["total_s"]
                                                  for s in spans)


@pytest.mark.parametrize("route", ["exact", "freq_equiv", "fft"])
def test_report_has_no_time_domain_entry_on_other_routes(monkeypatch,
                                                         route):
    p, stage = _stage(route, monkeypatch)
    stage.warmup()
    p.run_stage(stage)
    p.stop()
    assert "time_power" not in p.report()
    assert not isinstance(getattr(stage.power_fn, "inner", None),
                          fused_kernel.FusedBeamformer)


def _tiny_k2_frames(B=2):
    t = beamform.make_tables(_tiny(), "lerp", cache=False, device="cpu")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy((rng.standard_normal(
        (B, t.n_mics, t.n_samples)) * 0.1).astype(np.float32))
    return t, frames


def test_launches_count_only_the_objects_own_calls(counted_k2):
    """A launch of another ``FusedBeamformer`` while this one's is in
    flight (a second stage's thread; the launch releases the GIL) adds
    to that object's count alone."""
    t, frames = _tiny_k2_frames()
    a, b = fused_kernel.FusedBeamformer(t), fused_kernel.FusedBeamformer(t)
    counted_k2.during = lambda: b(frames)
    assert a(frames).shape == (2, t.res_x, t.res_y)
    assert (a.launches, b.launches, counted_k2.launches) == (1, 1, 2)
    a(frames)
    assert (a.report()["launches"], b.report()["launches"]) == (2, 1)


def test_cpu_rows_count_no_launch():
    """On CPU rows ``fused_power`` runs its plain version: no launch."""
    t, frames = _tiny_k2_frames()
    k2 = fused_kernel.FusedBeamformer(t)
    before = fused_kernel.fused_power.launches
    k2(frames)
    assert k2.launches == 0 == fused_kernel.fused_power.launches - before
    assert k2.last_plan is None
    assert {k: k2.report()[k] for k in ("G", "NS", "MG", "stagings")} == \
        dict.fromkeys(("G", "NS", "MG", "stagings"))
