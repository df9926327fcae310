"""The port's time-domain ``FusedBeamformer`` (its plain version on the
CPU) against the JAX package's ``FusedBeamformer`` (Pallas interpret
mode, as ``test_pallas.py`` runs it) and ``beamform.steered_power``, on
the JAX package's own tables, at the JAX gates: rtol 1e-4 / atol 1e-9
(``test_pallas.py:21``), ``high`` within 2e-5 of exact (``:93``), the
reference shape at rtol 1e-4 / atol 1e-12 (``:152``).  The CUDA kernel
against its plain version is ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import zybo_rt_sampler_image_detection_tpu as zj
from zybo_rt_sampler_image_detection_tpu.ops import beamform as jb
from zybo_rt_sampler_image_detection_tpu.ops import pallas_kernels as jp
from zybo_rt_sampler_image_detection_torch import Config
from zybo_rt_sampler_image_detection_torch.ops import beamform as tb
from zybo_rt_sampler_image_detection_torch.ops import equiv_kernel as tk
from zybo_rt_sampler_image_detection_torch.ops import fused_kernel as tf

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


def _frames(cfg, rng, n=2):
    return np.stack([synth_frame(cfg, rng) for _ in range(n)])


def _np(x):
    return x.double().cpu().numpy()


def _dense_power(fused, frames):
    """``fused``'s tables through the degenerate plan, every window all T
    taps from base 0 (the TPU's dense contraction), as (B, X, Y)."""
    bases = torch.zeros_like(fused.bases)
    w = tf._prep_weights(fused.t.W, bases, fused.T, fused.tile_d, fused.DP,
                         fused.plane_dtype)
    s, sj = fused.kernel_inputs(torch.from_numpy(frames))
    out = tf.fused_power(s, w, bases, sj, fused.wc, **fused.kernel_kw)
    return _np(out[:, :fused.D].reshape(len(frames), fused.res_x,
                                        fused.res_y))


@pytest.mark.parametrize("window", [False, True], ids=["dense", "window"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_fused_matches_jax(tiny_cfg, rng, algorithm, window):
    """The port's planned windows against the JAX package's dense and
    windowed kernels."""
    frames = _frames(tiny_cfg, rng)
    jt = jb.make_tables(tiny_cfg, algorithm, cache=False)
    ref = np.asarray(jb.steered_power(frames, jt), np.float64)
    jfused = np.asarray(jp.FusedBeamformer(jt, tile_d=8, chunk_b=2,
                                           window=window or None)(frames),
                        np.float64)
    fused = tf.FusedBeamformer(_port(jt), tile_d=8)
    assert fused.TK <= jt.W.shape[1]
    got = _np(fused(torch.from_numpy(frames)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(got, jfused, rtol=1e-4, atol=1e-9)


def test_fused_single_frame(tiny_cfg, rng):
    frame = synth_frame(tiny_cfg, rng)
    jt = jb.make_lerp_tables(tiny_cfg)
    got = tf.FusedBeamformer(_port(jt), tile_d=8)(torch.from_numpy(frame))
    assert got.shape == (tiny_cfg.max_res_x, tiny_cfg.max_res_y)
    ref = np.asarray(jb.steered_power(frame, jt), np.float64)
    np.testing.assert_allclose(_np(got), ref, rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("algorithm", ["lerp", "hybrid"])
def test_dense_matches_both_jax_variants(tiny_cfg, rng, algorithm):
    """The degenerate plan (all T taps from base 0) covers K2 and K3: it
    matches the JAX full variant and the chunked-T one (``force_tchunk``),
    hybrid's cross-chunk corrections included, and so do the planned
    windows."""
    frames = _frames(tiny_cfg, rng, n=5)
    jt = jb.make_tables(tiny_cfg, algorithm, cache=False)
    full = jp.FusedBeamformer(jt, tile_d=8, chunk_b=2)
    tch = jp.FusedBeamformer(jt, force_tchunk=True)
    assert full.variant == "full" and tch.variant == "tchunk"
    fused = tf.FusedBeamformer(_port(jt))
    dense = _dense_power(fused, frames)
    planned = _np(fused(torch.from_numpy(frames)))
    for jf in (full, tch):
        want = np.asarray(jf(frames), np.float64)
        for got in (dense, planned):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-9)


def _sparse_taps(rng, run, D=37, T=23, M=8):
    """(D, T, M) weights with one run of ``run`` nonzero taps at a random
    offset per (direction, mic)."""
    W = np.zeros((D, T, M), np.float32)
    for d in range(D):
        for m in range(M):
            t0 = rng.integers(0, T - run + 1)
            W[d, t0:t0 + run, m] = rng.standard_normal(run)
    return W


def test_window_plan_matches_jax_at_align_8(rng):
    """The JAX plan is the port's rounded out to Mosaic's alignment 8
    (``test_pallas.py:40-59``): Tw and the tap axis to the multiple of 8
    that leaves 7 spare taps, each unclipped base down to a multiple of 8."""
    W, tile_d = _sparse_taps(rng, 2), 16
    T = W.shape[1]
    bases, Tw = tf._window_plan(W, tile_d)
    jbases, jTw, jT_pad = jp._window_plan(W, tile_d)
    assert jTw == tf._round_up(Tw + 7, 8)
    assert jT_pad == tf._round_up(T + 7, 8)
    unclipped = bases <= jT_pad - jTw
    assert unclipped.mean() > 0.5
    np.testing.assert_array_equal(jbases[unclipped],
                                  (bases // 8 * 8)[unclipped])


@pytest.mark.parametrize("run", [1, 8])
def test_window_plan_invariants(rng, run):
    """Windows cover every nonzero tap and stay in range, for runs of
    ``run`` nonzero taps at random offsets, and are never wider than the
    JAX plan's."""
    W, tile_d = _sparse_taps(rng, run), 16
    T = W.shape[1]
    bases, Tw = tf._window_plan(W, tile_d)
    assert (bases >= 0).all() and (bases + Tw <= T).all()
    d_idx, t_idx, m_idx = np.nonzero(W)
    tl = d_idx // tile_d
    assert (bases[tl, m_idx] <= t_idx).all()
    assert (t_idx < bases[tl, m_idx] + Tw).all()
    assert Tw <= jp._window_plan(W, tile_d)[1]


def test_window_plan_degenerates_to_dense(rng):
    """A tile whose taps spread over all T gets the dense plan: Tw = T and
    every base 0, and the planned weights are the tables' taps."""
    D, T, M, tile_d = 16, 11, 4, 8
    W = np.zeros((D, T, M), np.float32)
    W[:, 0, :] = rng.standard_normal((D, M))
    W[3, T - 1, 2] = 1.0
    bases, Tw = tf._window_plan(W, tile_d)
    assert Tw == T and (bases == 0).all()
    w = tf._prep_weights(torch.from_numpy(W), torch.from_numpy(bases), Tw,
                         tile_d, D, torch.float32)
    np.testing.assert_array_equal(
        w.numpy(), W.transpose(2, 1, 0).reshape(M * T, D))


@pytest.mark.parametrize("tile_d", [8, 16, 32])
@pytest.mark.parametrize("algorithm", ["lerp", "hybrid", "truncated"])
def test_window_variant_cuts_taps(tiny_cfg, rng, algorithm, tile_d):
    """The planned windows at every direction tile: fewer taps than T
    where the tile's delays spread little, the same power."""
    frames = _frames(tiny_cfg, rng, n=3)
    jt = jb.make_tables(tiny_cfg, algorithm, cache=False)
    ref = np.asarray(jb.steered_power(frames, jt), np.float64)
    win = tf.FusedBeamformer(_port(jt), tile_d=tile_d)
    assert win.TK <= jt.W.shape[1]
    if tile_d == 8:
        assert win.TK < jt.W.shape[1]
    np.testing.assert_allclose(_np(win(torch.from_numpy(frames))), ref,
                               rtol=1e-4, atol=1e-9)


def test_high_mode_within_2e5_of_exact(tiny_cfg, rng):
    """``high`` runs FP32 operands (no 3-pass split to emulate them): as
    close to the exact product as the JAX 3-pass gate demands."""
    frames = _frames(tiny_cfg, rng)
    exact = np.asarray(jb.steered_power(frames, jb.make_lerp_tables(tiny_cfg)),
                       np.float64)
    jt = jb.make_tables(tiny_cfg.replace(matmul_precision="high"), "lerp",
                        cache=False)
    fused = tf.FusedBeamformer(_port(jt), tile_d=8)
    assert fused.mode == "high" and fused.plane_dtype == torch.float32
    got = _np(fused(torch.from_numpy(frames)))
    assert np.abs(got - exact).max() / exact.max() < 2e-5


def test_bf16_tables_within_bf16_class(tiny_cfg, rng):
    """bf16 tables take bf16 operands with FP32 sums: within the bf16
    class of the exact product, the same peak, and the JAX bf16 kernel's
    result up to summation order."""
    frames = _frames(tiny_cfg, rng)
    exact = np.asarray(jb.steered_power(frames, jb.make_lerp_tables(tiny_cfg)),
                       np.float64)
    cfg_bf = tiny_cfg.replace(matmul_dtype="bfloat16",
                              matmul_precision="default")
    jt = jb.make_tables(cfg_bf, "lerp", cache=False)
    jgot = np.asarray(jp.FusedBeamformer(jt, tile_d=8, chunk_b=2)(frames),
                      np.float64)
    fused = tf.FusedBeamformer(_port(jt), tile_d=8)
    assert fused.mode == "bf16" and fused.Wp.dtype == torch.bfloat16
    got = _np(fused(torch.from_numpy(frames)))
    assert np.abs(got - exact).max() / exact.max() < 3e-2
    for b in range(len(frames)):
        assert got[b].argmax() == exact[b].argmax()
    np.testing.assert_allclose(got, jgot, rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("B", [1, 3, 5])
def test_batch_padding(tiny_cfg, rng, B):
    """The JAX kernel pads B to a multiple of its ``chunk_b``; the port's
    block holds one frame and takes B as it is.  Both give every frame
    its single-frame map."""
    frames = _frames(tiny_cfg, rng, n=B)
    jt = jb.make_tables(tiny_cfg, "hybrid", cache=False)
    jgot = np.asarray(jp.FusedBeamformer(jt, tile_d=8, chunk_b=2)(frames),
                      np.float64)
    fused = tf.FusedBeamformer(_port(jt), tile_d=16)
    s, sj = fused.kernel_inputs(torch.from_numpy(frames))
    assert s.shape == (B, fused.M, fused.NL) and sj.shape == (B, fused.JM)
    got = _np(fused(torch.from_numpy(frames)))
    assert got.shape == (B, tiny_cfg.max_res_x, tiny_cfg.max_res_y)
    np.testing.assert_allclose(got, jgot, rtol=1e-4, atol=1e-9)
    for b in range(B):
        one = _np(fused(torch.from_numpy(frames[b])))
        np.testing.assert_allclose(got[b], one, rtol=1e-6, atol=1e-12)


def test_wider_inputs_slice_to_active_mics(tiny_cfg, rng):
    """The identity active-mic set slices (B, C > M, N) inputs to M rows
    (``pallas_kernels.py:986-989``)."""
    frames = _frames(tiny_cfg, rng)
    t = tb.make_tables(tiny_cfg, "lerp", cache=False, device="cpu")
    fused = tf.FusedBeamformer(t)
    assert fused.adaptive is None
    wide = np.concatenate([frames, np.ones_like(frames)], axis=1)
    np.testing.assert_array_equal(_np(fused(wide)), _np(fused(frames)))


@pytest.mark.parametrize("window", [False, True], ids=["dense", "window"])
def test_reference_shape_parity(window):
    """``Config()`` (256 mics, 57x32 grid, T=49), lerp, 2 frames: the
    port's planned windows, and the degenerate dense plan, against JAX
    ``steered_power`` (``test_pallas.py:138-158``)."""
    cfg = Config()
    jt = jb.make_tables(zj.Config(), "lerp")
    rng = np.random.default_rng(7)
    frames = (rng.standard_normal(
        (2, cfg.n_microphones, cfg.n_samples)) * 0.1).astype(np.float32)
    ref = np.asarray(jb.steered_power(frames, jt), np.float64)
    fused = tf.FusedBeamformer(_port(jt))
    # the tile-8 windows the kernel plans at alignment 1
    assert fused.TK < 20
    got = (_np(fused(torch.from_numpy(frames))) if window
           else _dense_power(fused, frames))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("preset", ["tiny", "northstar", "reference"])
def test_plan_fits_every_preset_shape(preset):
    """Every preset and algorithm has a Hopper plan at every direction
    tile, at every (G, NS) the planner can pick and at the batches the
    stages use, up to the dense plan's T taps (a K-looped kernel fits
    where the TPU needed a VMEM fallback), and the plan's arithmetic
    matches the kernel's limits."""
    cfg = {"tiny": Config.tiny(), "northstar": Config.northstar(),
           "reference": Config()}[preset]
    N = cfg.n_samples
    for algo in ("lerp", "hybrid"):
        t = tb.make_tables(cfg, algo, cache=False, device="cpu")
        D, T, M = t.W.shape
        Tc, JM = t.Wc.shape[2], len(t.corr_js) * M
        lpad, NL = tf.row_layout(t.tau_min, T, N)
        splits = tf.sample_splits(N)
        for tile_d in tf.TILE_DS:
            DP = tf._round_up(D, tile_d)
            for isz in (4, 2):
                for B in (1, 3, 16, 37):
                    auto = tf.plan(N, M, T, DP, B, NL, isz, JM, Tc)
                    assert auto.NS in splits and auto.NI == splits[auto.NS]
                    assert auto == tf.block_plan(N, M, T, DP, B, NL, isz,
                                                 JM, Tc, auto.G, auto.NS)
                    for NS in splits:
                        for G in range(1, tf.MAX_WARPS // NS + 1):
                            p = tf.block_plan(N, M, T, DP, B, NL, isz, JM,
                                              Tc, G, NS)
                            assert p.G * p.NS <= tf.MAX_WARPS
                            assert 1 <= p.MG <= M and 1 <= p.bps
                            assert p.smem <= tf.SMEM_MAX
                            assert p.bps * (p.smem + tf.BLOCK_RESERVED) \
                                <= tf.SM_SHARED
                            assert p.bps * G * NS <= tf.WARPS_PER_SM
                            cover = tf.sample_cover(N, NS, p.NI)
                            assert N <= cover and NL >= lpad - t.tau_min + cover
                            assert p.blocks == B * -(-(DP // tf.DW) // G)
    with pytest.raises(ValueError, match="no shared-memory plan"):
        tf.plan(256, 256, 200000, 1824, 1, 304, 4)
    with pytest.raises(ValueError, match="split"):
        tf.block_plan(256, 256, 5, 1824, 1, 304, 4, 0, 0, 4, 4)


def _dense_corr(Wc, sf, corr_js, DP):
    """The dense correction product the kernel once took, (B, cc, DP):
    ``(B, J*M) @ (J*M, cc*DP)`` in FP32 (``pallas_kernels._prep_corr``)."""
    J, D, Tc, M = Wc.shape
    N = sf.shape[-1]
    cc = min(max(8, tf._round_up(Tc, 8)), N)
    wcp = torch.nn.functional.pad(Wc.float(), (0, 0, 0, cc - Tc, 0, DP - D))
    corr_w = wcp.permute(0, 3, 2, 1).reshape(J * M, cc * DP)
    sj = torch.stack([sf[:, :, j].float() for j in corr_js], dim=1)
    return (sj.reshape(len(sf), -1) @ corr_w).reshape(len(sf), cc, DP)


@pytest.mark.parametrize("algorithm", ["lerp", "hybrid"])
@pytest.mark.parametrize("preset", ["tiny", "reference"])
def test_list_corrections_match_dense_product(preset, algorithm):
    """The kernel's corrections from the sparse list (its plain version,
    ``corrections_plain``) equal the dense ``(B, J*M) @ (J*M, cc*DP)``
    product within 1e-6, and the class holds the list, not that table."""
    cfg = Config.tiny() if preset == "tiny" else Config()
    t = tb.make_tables(cfg, algorithm, cache=False, device="cpu")
    fused = tf.FusedBeamformer(t)
    assert not hasattr(fused, "corr_w")
    assert fused.wc.val.numel() == int((t.Wc != 0).sum())
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.standard_normal(
        (3, cfg.n_microphones, cfg.n_samples)) * 0.1).astype(np.float32))
    s, sj = fused.kernel_inputs(x)
    sf = x[:, :fused.M] if fused.adaptive is None else x[:, fused.adaptive]
    dense = _dense_corr(t.Wc, sf, t.corr_js, fused.DP)
    Tc = fused.Tc
    v = tk.corrections_plain(sj, fused.wc, Tc, fused.DP).permute(1, 0, 2)
    assert v.shape == (3, Tc, fused.DP) and not dense[:, Tc:].any()
    scale = float(dense.abs().max())
    np.testing.assert_allclose(v.numpy(), dense[:, :Tc].numpy(), rtol=1e-6,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("algorithm", ALGORITHMS + ("reference-lerp",))
def test_padded_rows_read_delay_lines(tiny_cfg, rng, algorithm):
    """The padded rows hold every frame's samples at ``lpad + n`` and
    zeros around them: tap t's read from ``lpad - tau_min - t`` gives
    ``delay_lines``' shifted row, and every read of every split's passes
    lies inside the row."""
    if algorithm == "reference-lerp":
        cfg, algorithm = Config(), "lerp"
    else:
        cfg = tiny_cfg
    t = tb.make_tables(cfg, algorithm, cache=False, device="cpu")
    fused = tf.FusedBeamformer(t)
    N, T = fused.N, fused.T
    x = torch.from_numpy(_frames(cfg, rng))
    s, _ = fused.kernel_inputs(x)
    sf = (x[:, :fused.M] if fused.adaptive is None
          else x[:, fused.adaptive]).float()
    lines = tb.delay_lines(sf, fused.tau_min, T, stack_axis=-2)
    assert s.shape[-1] == fused.NL and fused.NL % tf.ROW_ALIGN == 0
    np.testing.assert_array_equal(s[..., fused.lpad:fused.lpad + N].numpy(),
                                  sf.numpy())
    for tap in range(T):
        start = fused.lpad - fused.tau_min - tap
        assert start >= 0
        np.testing.assert_array_equal(s[..., start:start + N].numpy(),
                                      lines[:, :, tap].numpy())
    for NS, NI in tf.sample_splits(N).items():
        cover = tf.sample_cover(N, NS, NI)
        assert fused.lpad - fused.tau_min + cover <= fused.NL
        # the first read of the widest window: lpad - tau_min - max base
        # - (Tw - 1) >= 0 (the kernel's base check)
        assert int(fused.bases.max()) <= fused.lpad - fused.tau_min \
            - fused.TK + 1


@pytest.mark.parametrize("algorithm,tw", [("lerp", 5), ("hybrid", 11),
                                          ("pad", 4), ("convolve", 8)])
def test_window_plan_tile8_at_reference(algorithm, tw):
    """At ``Config()`` the one-warp tile of 8 directions gives windows of
    Tw lerp 5, hybrid 11, pad 4, convolve 8 taps, and they cover every
    nonzero tap of their (tile, mic)."""
    t = tb.make_tables(Config(), algorithm, cache=False, device="cpu")
    W = t.W.float().numpy()
    bases, Tw = tf._window_plan(W, 8)
    assert Tw == tw
    D, T, M = W.shape
    assert (bases >= 0).all() and (bases + Tw <= T).all()
    d_idx, t_idx, m_idx = np.nonzero(W)
    tl = d_idx // 8
    assert (bases[tl, m_idx] <= t_idx).all()
    assert (t_idx < bases[tl, m_idx] + Tw).all()
    assert tf.FusedBeamformer(t).TK == tw


def test_cpu_tensors_take_the_plain_version(tiny_cfg, rng, monkeypatch):
    """The wrapper takes its plain version only because the tensors lie on
    the CPU: no kernel is built or counted."""
    from zybo_rt_sampler_image_detection_torch.ops import _build

    def no_build(name):
        raise AssertionError("a CPU tensor must not build the kernel")

    monkeypatch.setattr(_build, "load", no_build)
    before = tf.fused_power.launches
    t = tb.make_tables(tiny_cfg, "lerp", cache=False, device="cpu")
    tf.FusedBeamformer(t)(torch.from_numpy(_frames(tiny_cfg, rng)))
    assert tf.fused_power.launches == before


def test_cuda_request_raises_without_gpu(tiny_cfg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tb.make_tables(tiny_cfg, "lerp", cache=False, device="cuda")
    t = tb.make_tables(tiny_cfg, "lerp", cache=False, device="cpu")
    fused = tf.FusedBeamformer(t)
    s, sj = fused.kernel_inputs(torch.zeros(1, 16, 64))
    with pytest.raises(ValueError, match="unsupported device"):
        tf.fused_power(s.to("meta"), fused.Wp.to("meta"),
                       fused.bases.to("meta"), None, None,
                       **fused.kernel_kw)
