"""The port's exact frequency-domain power and its fused equiv kernel
(the kernel's plain version on the CPU) against the JAX package, on the
JAX package's own tables: ``freq_equiv`` at rtol 2e-5
(``test_freq_equiv.py:24``); the kernel's ``high`` mode at 5e-5 against
``steered_power``, ``f32`` at 2e-6 against ``freq_equiv`` and ``bf16`` at
3e-2 with the peak equal (``test_equiv_kernel.py:26,62,71``).  The CUDA
kernel against its plain version is ``test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from zybo_rt_sampler_image_detection_tpu.ops import beamform as jb
from zybo_rt_sampler_image_detection_tpu.ops import equiv_kernel as jk
from zybo_rt_sampler_image_detection_tpu.ops import freq_equiv as jf
from zybo_rt_sampler_image_detection_torch import Config
from zybo_rt_sampler_image_detection_torch.ops import beamform as tb
from zybo_rt_sampler_image_detection_torch.ops import equiv_kernel as tk
from zybo_rt_sampler_image_detection_torch.ops import freq_equiv as tf

from conftest import synth_frame

torch.set_num_threads(2)

ALGORITHMS = ("pad", "lerp", "convolve", "hybrid", "truncated")


def _port(jt, device="cpu"):
    """The JAX package's tables carried into the port."""
    return tb.SteeringTables.from_numpy(
        np.asarray(jt.W), None if jt.Wc is None else np.asarray(jt.Wc),
        np.asarray(jt.adaptive), tau_min=jt.tau_min, corr_js=jt.corr_js,
        precision=jt.precision, n_samples=jt.n_samples, res_x=jt.res_x,
        res_y=jt.res_y, algorithm=jt.algorithm, device=device)


def _frames(cfg, rng, n=3):
    return np.stack([synth_frame(cfg, rng) for _ in range(n)])


def _np(x):
    return x.double().cpu().numpy()


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_equiv_power_matches_jax(tiny_cfg, rng, algorithm):
    frames = _frames(tiny_cfg, rng)
    jt = jb.make_tables(tiny_cfg, algorithm, cache=False)
    ref = np.asarray(jf.equiv_steered_power(frames, jf.make_equiv_tables(jt)),
                     np.float64)
    et = tf.make_equiv_tables(_port(jt))
    assert (et.L, et.n_bins) == tuple(jf.equiv_dims(jt))
    got = _np(tf.equiv_steered_power(torch.from_numpy(frames), et))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-14)
    # and the time-domain family it reformulates
    td = np.asarray(jb.steered_power(frames, jt), np.float64)
    np.testing.assert_allclose(got, td, rtol=2e-5, atol=1e-14)


def test_equiv_power_single_frame_squeeze(tiny_cfg, rng):
    frame = synth_frame(tiny_cfg, rng)
    jt = jb.make_tables(tiny_cfg, "lerp", cache=False)
    got = tf.equiv_steered_power(torch.from_numpy(frame),
                                 tf.make_equiv_tables(_port(jt)))
    assert got.shape == (tiny_cfg.max_res_x, tiny_cfg.max_res_y)
    ref = np.asarray(jb.steered_power(frame, jt), np.float64)
    np.testing.assert_allclose(_np(got), ref, rtol=2e-5, atol=1e-14)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_fused_high_matches_steered_power(tiny_cfg, rng, algorithm):
    frames = _frames(tiny_cfg, rng)
    jt = jb.make_tables(tiny_cfg, algorithm, cache=False)
    ref = np.asarray(jb.steered_power(frames, jt), np.float64)
    fused = tk.FusedEquivBeamformer(_port(jt), mode="high")
    got = _np(fused(torch.from_numpy(frames)))
    np.testing.assert_allclose(got, ref, rtol=5e-5, atol=1e-12)


@pytest.mark.parametrize("algorithm", ("lerp", "hybrid", "convolve"))
def test_fused_f32_matches_freq_equiv(tiny_cfg, rng, algorithm):
    frames = _frames(tiny_cfg, rng)
    jt = jb.make_tables(tiny_cfg, algorithm, cache=False)
    ref = np.asarray(jf.equiv_steered_power(frames, jf.make_equiv_tables(jt)),
                     np.float64)
    fused = tk.FusedEquivBeamformer(_port(jt), mode="f32")
    got = _np(fused(torch.from_numpy(frames)))
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-14)


def test_fused_f32_matches_jax_kernel_interpret(tiny_cfg, rng):
    """Against the JAX fused kernel itself (Pallas interpret mode)."""
    frames = _frames(tiny_cfg, rng)
    jt = jb.make_tables(tiny_cfg, "lerp", cache=False)
    ref = np.asarray(jk.FusedEquivBeamformer(jt, mode="f32")(frames),
                     np.float64)
    got = _np(tk.FusedEquivBeamformer(_port(jt), mode="f32")(
        torch.from_numpy(frames)))
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-14)


def test_fused_bf16_display_grade(tiny_cfg, rng):
    frames = _frames(tiny_cfg, rng)
    jt = jb.make_tables(tiny_cfg, "lerp", cache=False)
    ref = np.asarray(jb.steered_power(frames, jt), np.float64)
    fused = tk.FusedEquivBeamformer(_port(jt), mode="bf16")
    assert fused.H1.dtype == torch.bfloat16
    got = _np(fused(torch.from_numpy(frames)))
    np.testing.assert_allclose(got, ref, rtol=3e-2, atol=1e-10)
    for b in range(len(frames)):
        assert np.unravel_index(got[b].argmax(), got[b].shape) \
            == np.unravel_index(ref[b].argmax(), ref[b].shape)


@pytest.mark.parametrize("B,bt", [(5, 8), (3, 4), (2, 2), (1, 1), (11, 16)])
def test_fused_batch_padding_and_squeeze(tiny_cfg, rng, B, bt):
    """Batches pad to the frame tile with zero frames and slice back;
    2-D input squeezes."""
    jt = jb.make_tables(tiny_cfg, "lerp", cache=False)
    fused = tk.FusedEquivBeamformer(_port(jt), mode="high")
    assert fused.frame_tile(B) == bt
    frames = _frames(tiny_cfg, rng, B)
    got = fused(torch.from_numpy(frames))
    assert got.shape == (B, tiny_cfg.max_res_x, tiny_cfg.max_res_y)
    one = fused(torch.from_numpy(frames[0]))
    assert one.shape == (tiny_cfg.max_res_x, tiny_cfg.max_res_y)
    np.testing.assert_allclose(_np(one), _np(got[0]), rtol=1e-6, atol=1e-12)
    ref = np.asarray(jb.steered_power(frames, jt), np.float64)
    np.testing.assert_allclose(_np(got), ref, rtol=5e-5, atol=1e-12)


def test_fused_disabled_mics_gather(tiny_cfg, rng):
    """A non-identity active-mic set exercises the forward's gather."""
    cfg = tiny_cfg.replace(matmul_precision="high", unused_mics=(1, 5))
    frames = _frames(cfg, rng)
    jt = jb.make_tables(cfg, "lerp", cache=False)
    fused = tk.FusedEquivBeamformer(_port(jt), mode="high")
    assert fused.adaptive is not None
    ref = np.asarray(jb.steered_power(frames, jt), np.float64)
    got = _np(fused(torch.from_numpy(frames)))
    np.testing.assert_allclose(got, ref, rtol=5e-5, atol=1e-12)


def test_fused_default_mode_follows_tables():
    def mode(**kw):
        t = tb.make_tables(Config.tiny().replace(**kw), "lerp", cache=False,
                           device="cpu")
        return tk.FusedEquivBeamformer(t).mode

    assert mode(matmul_precision="high") == "high"
    assert mode(matmul_precision="highest") == "f32"
    assert mode(matmul_precision="default", matmul_dtype="bfloat16") == "bf16"


def test_fused_rejects_unknown_mode():
    t = tb.make_tables(Config.tiny(), "lerp", cache=False, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        tk.FusedEquivBeamformer(t, mode="highest")


def test_hopper_plan_fits_shared_memory():
    """Reference shape (lerp Tt=98 / hybrid Tt=106, K=2M=512, J*M<=768):
    every frame tile fits one block in FP32 and bf16 with a two-stage
    ring; an oversized tail/head count has no plan and raises (the policy
    then falls back to freq_equiv)."""
    for Tt, JM in ((98, 256), (106, 768)):
        for itemsize in (4, 2):
            for bt in tk.FRAME_TILES:
                assert tk.smem_bytes(bt, Tt, 512, JM, itemsize) <= tk.SMEM_MAX
    et = tf.make_equiv_tables(tb.make_tables(Config.tiny(), "lerp",
                                             cache=False, device="cpu"))
    huge = torch.zeros(et.n_bins, 8000)
    with pytest.raises(ValueError, match="shared-memory plan"):
        tk.FusedEquivBeamformer(dataclasses.replace(et, ib_re=huge,
                                                    ib_im=huge))


def _k1_shapes(cfg, algorithm):
    """``(F, KP, DP, Tt, Tc, JM)`` of K1 on ``cfg``'s tables, from the
    time-domain tables alone (``equiv_dims``), as ``FusedEquivBeamformer``
    pads them."""
    t = tb.make_tables(cfg, algorithm, cache=False, device="cpu")
    D, _, M = t.W.shape
    L, F = tf.equiv_dims(t)
    Tc = 0 if t.Wc is None else t.Wc.shape[2]
    JM = 0 if t.Wc is None else len(t.corr_js) * M
    return (F, tk._round_up(2 * M, tk.K_ALIGN), tk._round_up(D, tk.D_ALIGN),
            L - t.n_samples + Tc, Tc, JM)


def _bench_config(name):
    import json
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs", f"{name}.json")) as f:
        spec = json.load(f)
    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in spec.items() if k in names})


@pytest.mark.parametrize("config", ["default", "northstar", "cfgjson",
                                    "onboard64"])
@pytest.mark.parametrize("algorithm", ["lerp", "hybrid"])
def test_split_plan_fits_shared_memory(config, algorithm):
    """K1's FP32 route in two passes: every shape the repo's configurations
    reach, at 1, 16 and 37 frames (padded to each frame tile the class can
    pick), gets a product pass and a fold pass whose blocks fit 227 KB of
    shared memory (two product blocks to an SM), fold warps that cover
    every tail/head sample, and a P buffer that holds Br and Bi of every
    bin, frame and direction."""
    cfg = {"default": Config, "northstar": Config.northstar}.get(
        config, lambda: _bench_config(config))()
    F, KP, DP, Tt, Tc, JM = _k1_shapes(cfg, algorithm)
    for B, tiles in ((1, (1,)), (16, (16,)), (37, (8, 16))):
        for bt in tiles:
            BP = tk._round_up(B, bt)
            p = tk.split_plan(F, BP, KP, DP, Tt, Tc, JM)
            assert p.smem == tk.split_smem_bytes(p.fb, p.nc, p.stages)
            assert p.smem <= tk.SMEM_MAX and 2 <= p.stages <= tk.MAX_STAGES
            # two blocks an SM: 228 KB, less 1 KB the runtime keeps a block
            assert 2 * (p.smem + 1024) <= 233472
            assert p.stages <= KP // 2 // tk.SPLIT_KC
            assert p.fold_smem == tk.fold_smem_bytes(p.oq, Tt, Tc, JM)
            assert p.fold_smem <= tk.SMEM_MAX
            assert BP % p.fb == 0 and BP % p.oq == 0
            assert p.fb == max(b for b in tk.FRAME_TILES if BP % b == 0)
            n_fg, n_dg, n_f = p.product_grid
            assert n_fg * p.fb == BP and n_f == F
            assert (n_dg - 1) * 64 * p.nc < DP <= n_dg * 64 * p.nc
            assert p.nw <= tk.FOLD_MAX_WARPS
            assert Tt <= tk.FOLD_TQ * p.nw < Tt + tk.FOLD_TQ
            assert p.fold_grid == (-(-DP // 32), BP // p.oq)
            # P: Br and Bi of every bin, frame and direction, in direction
            # blocks of 32 and the fold's frame groups
            assert p.p_shape == (-(-DP // 32), BP // p.oq, F, 2, p.oq, 32)
            assert np.prod(p.p_shape) >= F * 2 * BP * DP


def test_split_plan_shapes_of_the_benchmark():
    """The two benchmark cells' shapes at their batch of 16: cfgjson (256
    mic slots, 57x32 grid) and onboard64 (64 mics, 65x65 grid)."""
    assert _k1_shapes(_bench_config("cfgjson"), "lerp") == (154, 512, 1824,
                                                            98, 48, 256)
    assert _k1_shapes(_bench_config("onboard64"), "lerp") == (139, 128, 4240,
                                                              38, 18, 64)
    cfg = tk.split_plan(154, 16, 512, 1824, 98, 48, 256)
    assert (cfg.fb, cfg.nc, cfg.stages, cfg.oq, cfg.nw) == (16, 3, 2, 4, 13)
    assert cfg.product_grid == (1, 10, 154) and cfg.fold_grid == (57, 4)
    ob = tk.split_plan(139, 16, 128, 4240, 38, 18, 64)
    assert (ob.fb, ob.nc, ob.stages, ob.oq, ob.nw) == (16, 4, 2, 4, 5)
    assert ob.product_grid == (1, 17, 139) and ob.fold_grid == (133, 4)
    with pytest.raises(ValueError, match="fold plan"):
        tk.split_plan(154, 16, 512, 1824, 8000, 48, 256)


def test_wrapper_uses_plain_version_only_on_cpu(tiny_cfg, rng):
    """CPU tensors take the plain version without counting a launch; a
    tensor on any other non-CUDA device raises instead of falling back."""
    t = tb.make_tables(Config.tiny(), "hybrid", cache=False, device="cpu")
    fused = tk.FusedEquivBeamformer(t)
    x = torch.from_numpy(_frames(tiny_cfg, rng, 2))
    S, sj, bt = fused.kernel_inputs(x)
    kw = dict(n_tail=fused.n_tail, Tc=fused.Tc, inv=fused.inv)
    args = (S, fused.H1, fused.ib1, fused.ib2, sj, fused.wc)
    before = tk.equiv_power.launches
    out = tk.equiv_power(*args, block_b=bt, **kw)
    assert tk.equiv_power.launches == before
    assert torch.equal(out, tk.equiv_power_plain(*args, **kw))
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in args]
    with pytest.raises(ValueError, match="device"):
        tk.equiv_power(*meta, block_b=bt, **kw)
