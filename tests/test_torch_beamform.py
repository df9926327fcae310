"""The port's time-domain steered power — the ground truth of the slice —
against the JAX package: its float64 oracle (rtol 1e-12,
``test_beamform.py:51``), the golden heatmaps (rtol 1e-5,
``test_golden.py:29-86``, reference-shape rows included) and its
``beamform.steered_power`` on identical tables."""

import os

import numpy as np
import pytest
import torch

from zybo_rt_sampler_image_detection_tpu.ops import beamform as jb
from zybo_rt_sampler_image_detection_tpu.ops import geometry as jg
from zybo_rt_sampler_image_detection_tpu.ops import oracle
from zybo_rt_sampler_image_detection_torch import Config
from zybo_rt_sampler_image_detection_torch.ops import beamform as tb

from conftest import synth_frame

torch.set_num_threads(2)

ALGOS = ["pad", "lerp", "convolve", "hybrid", "truncated"]
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def oracle_heatmap(cfg, frame, algorithm):
    """The JAX package's literal transcription of the C loops."""
    active, n = jg.active_microphones(cfg)
    if algorithm in ("pad", "truncated"):
        if algorithm == "pad":
            whole, _ = jg.calculate_coefficients(cfg)
        else:
            whole = jg.calculate_delays_angles(cfg)[:, :, active].astype(int)
        return oracle.mimo_pad(frame, whole, active)
    if algorithm == "lerp":
        whole, frac = jg.lerp_coefficients(cfg)
        return oracle.mimo_lerp(frame, whole, frac, active)
    if algorithm == "convolve":
        return oracle.mimo_convolve(frame, jg.convolve_coefficients(cfg),
                                    active)
    whole, taps = jg.hybrid_coefficients(cfg)
    return oracle.mimo_hybrid(frame, whole, taps, active)


@pytest.mark.parametrize("algorithm", ALGOS)
def test_float64_matches_oracle(tiny_cfg, frame, algorithm):
    """float64 end to end: delay-line matmul + boundary corrections equal
    the C loop semantics with no accumulation-order slack."""
    cfg = tiny_cfg.replace(matmul_dtype="float64")
    ref = oracle_heatmap(cfg, frame.astype(np.float64), algorithm)
    t = tb.make_tables(Config.tiny().replace(matmul_dtype="float64"),
                       algorithm, cache=False, device="cpu")
    got = tb.steered_power(torch.from_numpy(frame.astype(np.float64)),
                           t).numpy()
    assert got.dtype == np.float64
    assert got.shape == ref.shape == (cfg.max_res_x, cfg.max_res_y)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("algorithm", ALGOS)
def test_fp32_matches_jax_steered_power(tiny_cfg, rng, algorithm):
    """Identical (JAX-built) tables, a batch of three frames: the port's
    FP32 product equals JAX's HIGHEST-precision product to f32
    reassociation (the golden gate's rtol)."""
    frames = np.stack([synth_frame(tiny_cfg, rng) for _ in range(3)])
    jt = jb.make_tables(tiny_cfg, algorithm, cache=False)
    tt = tb.SteeringTables.from_numpy(
        np.asarray(jt.W), None if jt.Wc is None else np.asarray(jt.Wc),
        np.asarray(jt.adaptive), tau_min=jt.tau_min, corr_js=jt.corr_js,
        precision=jt.precision, n_samples=jt.n_samples, res_x=jt.res_x,
        res_y=jt.res_y, algorithm=jt.algorithm, device="cpu")
    ref = np.asarray(jb.steered_power(frames, jt), np.float64)
    got = tb.steered_power(torch.from_numpy(frames), tt).double().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12)
    one = tb.steered_power(torch.from_numpy(frames[0]), tt)
    assert one.shape == (tiny_cfg.max_res_x, tiny_cfg.max_res_y)
    np.testing.assert_allclose(one.double().numpy(), got[0], rtol=1e-6,
                               atol=1e-14)


@pytest.mark.parametrize("algorithm", ALGOS)
def test_golden_tiny(algorithm):
    golden = np.load(os.path.join(GOLDEN, "tiny_heatmaps.npz"))
    t = tb.make_tables(Config.tiny(), algorithm, cache=False, device="cpu")
    got = tb.steered_power(torch.from_numpy(golden["frame"]), t).numpy()
    ref = golden[algorithm]
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-9 * max(ref.max(), 1.0))


@pytest.mark.parametrize("algorithm", ALGOS)
def test_golden_reference_shape(algorithm):
    """The full reference shape (57x32 grid, 256 mics, 3 of 4 slots)."""
    golden = np.load(os.path.join(GOLDEN, "reference_heatmaps.npz"))
    t = tb.make_tables(Config(), algorithm, cache=False, device="cpu")
    got = tb.steered_power(torch.from_numpy(golden["frame"]), t).numpy()
    ref = golden[algorithm]
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-9 * max(ref.max(), 1.0))


def test_bf16_tables_match_jax(tiny_cfg, rng):
    """bf16 tables: bf16-rounded operands, FP32 sums on both sides."""
    cfg = tiny_cfg.replace(matmul_dtype="bfloat16",
                           matmul_precision="default")
    frames = np.stack([synth_frame(cfg, rng) for _ in range(2)])
    jt = jb.make_tables(cfg, "lerp", cache=False)
    tt = tb.make_tables(Config.tiny().replace(matmul_dtype="bfloat16",
                                              matmul_precision="default"),
                        "lerp", cache=False, device="cpu")
    ref = np.asarray(jb.steered_power(frames, jt), np.float64)
    got = tb.steered_power(torch.from_numpy(frames), tt).double().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12)


def test_delay_lines_edges():
    s = torch.arange(1.0, 6.0)[None]                     # (1, 5)
    d = tb.delay_lines(s, -2, 5)                           # shifts -2..2
    assert torch.equal(d[0, 0], torch.tensor([3., 4., 5., 0., 0.]))
    assert torch.equal(d[2, 0], s[0])
    assert torch.equal(d[4, 0], torch.tensor([0., 0., 1., 2., 3.]))
    far = tb.delay_lines(s, 5, 1)
    assert torch.equal(far[0], torch.zeros_like(s))
