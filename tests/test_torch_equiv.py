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
