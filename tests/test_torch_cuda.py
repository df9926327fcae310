"""The port's CUDA kernels (fused equiv power in both sweeps, fused
time-domain power) against their plain torch versions, on the card.
Every test is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False (the kernel has no CPU mode).

This file imports neither JAX nor the test conftest's helpers, so it also
runs on a machine with the card and no JAX::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from zybo_rt_sampler_image_detection_torch import Config
from zybo_rt_sampler_image_detection_torch.apps import pipeline
from zybo_rt_sampler_image_detection_torch.ops import bartlett_kernel as bk
from zybo_rt_sampler_image_detection_torch.ops import beamform as tb
from zybo_rt_sampler_image_detection_torch.ops import equiv_kernel as tk
from zybo_rt_sampler_image_detection_torch.ops import fused_kernel as tf

pytestmark = pytest.mark.cuda

# max cellwise relative error against the plain version, per mode (the JAX
# package's gates for the kernel: test_equiv_kernel.py:26,62,71)
TOL = {"f32": 2e-6, "high": 5e-5, "bf16": 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _frames(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.n_microphones, cfg.n_samples))
            * 0.1).astype(np.float32)


def _run(fused, x, block_b=None):
    S, sj, bt = fused.kernel_inputs(x, block_b)
    kw = dict(n_tail=fused.n_tail, Tc=fused.Tc, inv=fused.inv)
    args = (S, fused.H1, fused.ib1, fused.ib2, sj, fused.wc)
    before = tk.equiv_power.launches
    got = tk.equiv_power(*args, block_b=bt, **kw)
    torch.cuda.synchronize()
    assert tk.equiv_power.launches == before + 1
    return got, tk.equiv_power_plain(*args, **kw)


def _tiles(fused, B):
    """Every frame tile the plan can take for B frames: the planned tiles
    up to the one covering B, and the tile the class picks."""
    cover = min((bt for bt in fused.frame_tiles if bt >= B),
                default=fused.frame_tiles[0])
    return sorted({bt for bt in fused.frame_tiles if bt <= cover}
                  | {fused.frame_tile(B)})


@pytest.mark.parametrize("mode", ["f32", "high", "bf16"])
@pytest.mark.parametrize("algorithm", ["lerp", "hybrid", "convolve"])
@pytest.mark.parametrize("B", [1, 2, 3, 11, 16, 37])
def test_kernel_matches_plain_tiny(cuda, mode, algorithm, B):
    cfg = Config.tiny()
    t = tb.make_tables(cfg, algorithm, cache=False, device=cuda)
    fused = tk.FusedEquivBeamformer(t, mode=mode)
    x = torch.from_numpy(_frames(cfg, B)).to(cuda)
    for bt in _tiles(fused, B):
        got, ref = _run(fused, x, bt)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=TOL[mode], atol=1e-14,
                                   err_msg=f"frame tile {bt}")


_REF = {}


def _ref_fused(cuda, algorithm, mode, sweep="df"):
    """``FusedEquivBeamformer`` at ``Config()``, kept across tests (one
    at a time: the tables are large)."""
    key = (algorithm, mode, sweep)
    if key not in _REF:
        _REF.clear()
        t = tb.make_tables(Config(), algorithm, device=cuda)
        _REF[key] = (t, tk.FusedEquivBeamformer(t, mode=mode, sweep=sweep))
    return _REF[key]


@pytest.mark.parametrize("B", [1, 16, 37])
@pytest.mark.parametrize("mode", ["f32", "high", "bf16"])
@pytest.mark.parametrize("algorithm", ["lerp", "hybrid"])
def test_kernel_matches_plain_reference_shape(cuda, algorithm, mode, B):
    cfg = Config()
    t, fused = _ref_fused(cuda, algorithm, mode)
    x = torch.from_numpy(_frames(cfg, B) * 0.5).to(cuda)
    for bt in _tiles(fused, B):
        got, ref = _run(fused, x, bt)
        got, ref = got.cpu().numpy(), ref.cpu().numpy()
        if mode == "bf16":
            g, r = got[:B, :fused.D], ref[:B, :fused.D]
            assert np.abs(g / r - 1).max() <= TOL[mode], bt
            assert (g.argmax(1) == r.argmax(1)).all(), bt
        else:
            np.testing.assert_allclose(got, ref, rtol=TOL[mode], atol=1e-14,
                                       err_msg=f"frame tile {bt}")
    if mode == "f32":
        power = fused(x)
        exact = tb.steered_power(x, t)
        np.testing.assert_allclose(power.cpu().numpy(), exact.cpu().numpy(),
                                   rtol=1e-4, atol=1e-14)


def test_wrapper_rejects_bad_inputs(cuda):
    t = tb.make_tables(Config.tiny(), "lerp", cache=False, device=cuda)
    fused = tk.FusedEquivBeamformer(t, mode="f32")
    S, sj, bt = fused.kernel_inputs(torch.zeros(3, 16, 64, device=cuda))
    kw = dict(n_tail=fused.n_tail, Tc=fused.Tc, inv=fused.inv)
    rest = (fused.ib1, fused.ib2, sj)
    with pytest.raises(ValueError, match="dtype"):
        tk.equiv_power(S.double(), fused.H1, *rest, fused.wc, block_b=bt,
                       **kw)
    with pytest.raises(ValueError, match="block_b"):
        tk.equiv_power(S, fused.H1, *rest, fused.wc, block_b=16, **kw)
    with pytest.raises(ValueError, match="device"):
        tk.equiv_power(S, fused.H1.cpu(), *rest, fused.wc, block_b=bt, **kw)
    with pytest.raises(ValueError, match="H1"):
        tk.equiv_power(S, fused.H1[:, :, :64].contiguous(), *rest, fused.wc,
                       block_b=bt, **kw)


def test_wrappers_reject_bad_correction_list(cuda):
    """The sparse head-correction list: a wrong shape or dtype of any of
    its three arrays raises in both wrappers."""
    t = tb.make_tables(Config.tiny(), "hybrid", cache=False, device=cuda)
    for sweep, plan, fn, extra in (
            ("df", None, tk.equiv_power, {}),
            ("fd", (8, 3), tk.equiv_power_fd, {"n_fc": 3})):
        fused = tk.FusedEquivBeamformer(t, mode="f32", plan_override=plan,
                                        sweep=sweep)
        S, sj, bt = fused.kernel_inputs(torch.zeros(3, 16, 64, device=cuda))
        kw = dict(n_tail=fused.n_tail, Tc=fused.Tc, inv=fused.inv,
                  block_b=bt, **extra)
        wc = fused.wc
        bad = [wc._replace(ptr=wc.ptr.long()), wc._replace(idx=wc.idx.long()),
               wc._replace(val=wc.val.double()),
               wc._replace(ptr=wc.ptr[:-1].contiguous()),
               wc._replace(val=wc.val[:-1].contiguous()), tuple(wc)]
        for b in bad:
            with pytest.raises(ValueError, match="wc"):
                fn(S, fused.H1, fused.ib1, fused.ib2, sj, b, **kw)
        with pytest.raises(ValueError, match="wc"):
            fn(S, fused.H1, fused.ib1, fused.ib2, sj, None, **kw)


@pytest.mark.parametrize("mode", ["f32", "high", "bf16"])
def test_bf16_takes_tensor_cores(cuda, mode):
    """The route the library reports for the launch: bf16 on the tensor
    cores (mma.sync), f32/high FP32 FMAs on the CUDA cores, in two passes
    from ``SPLIT_MIN_FRAMES`` padded frames up."""
    t = tb.make_tables(Config.tiny(), "lerp", cache=False, device=cuda)
    fused = tk.FusedEquivBeamformer(t, mode=mode)
    B = tk.SPLIT_MIN_FRAMES
    fused(torch.from_numpy(_frames(Config.tiny(), B)).to(cuda))
    torch.cuda.synchronize()
    route = tk.equiv_power.last_route
    assert route == tk.route(fused.plane_dtype, fused.Tt, B)
    if mode == "bf16":
        assert route.startswith("tensor cores") and "mma" in route
    else:
        assert route.startswith("CUDA cores") and route == tk.SPLIT_ROUTE


@pytest.mark.parametrize("bf16", [0, 1])
@pytest.mark.parametrize("bt", [1, 2, 4, 8, 16])
def test_k1_blocks_per_sm(cuda, bf16, bt):
    """The runtime's occupancy of K1 at the reference shape: at least one
    block an SM with a two-stage ring; bad arguments come back as a
    negated CUDA error; the plan's ring fits."""
    lib = tk._lib("equiv_power")
    n = lib.zrt_equiv_power_blocks_per_sm(bf16, bt, 106, 512, 768, 2)
    assert 1 <= n <= 8
    assert lib.zrt_equiv_power_blocks_per_sm(bf16, 3, 106, 512, 768, 2) < 0
    assert lib.zrt_equiv_power_blocks_per_sm(bf16, bt, 106, 500, 768, 2) < 0
    assert lib.zrt_equiv_power_blocks_per_sm(bf16, bt, 106, 512, 768, 9) < 0
    waves, stages = tk._k1_plan(torch.device("cuda", 0), bf16, bt, 106, 512,
                                768, 228)
    assert waves >= 1 and 2 <= stages <= tk.MAX_STAGES
    assert tk.smem_bytes(bt, 106, 512, 768, 2 if bf16 else 4,
                         stages) <= tk.SMEM_MAX


def test_auto_policy_picks_kernel_at_high(cuda):
    t = tb.make_tables(Config().replace(matmul_precision="high"), "lerp",
                       device=cuda)
    kind, obj = pipeline._select_power_backend(t)
    assert kind == "equiv_kernel" and obj.mode == "high"


# --- K1's FP32 route in two passes (product, then fold and finish) --------


def _bench_config(name):
    """The port's ``Config`` of a benchmark configuration file."""
    import dataclasses
    import json
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs", f"{name}.json")) as f:
        spec = json.load(f)
    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in spec.items() if k in names})


_SPLIT = {}


def _split_fused(cuda, config, algorithm, corrections):
    """``FusedEquivBeamformer`` at a benchmark configuration's shape (its
    ``high`` rung) or at ``Config()`` (``f32``), with or without the head
    corrections; one kept at a time (the tables are large)."""
    import dataclasses

    key = (config, algorithm, corrections)
    if key not in _SPLIT:
        _SPLIT.clear()
        cfg = Config() if config == "default" else _bench_config(config)
        et = tk.make_equiv_tables(tb.make_tables(cfg, algorithm, device=cuda))
        if not corrections:
            et = dataclasses.replace(et, Wc=None,
                                     ib_re=et.ib_re[:, :et.n_tail],
                                     ib_im=et.ib_im[:, :et.n_tail])
        mode = "f32" if config == "default" else "high"
        _SPLIT[key] = (cfg, tk.FusedEquivBeamformer(et, mode=mode))
    return _SPLIT[key]


@pytest.mark.parametrize("corrections", [True, False])
@pytest.mark.parametrize("algorithm", ["lerp", "hybrid"])
@pytest.mark.parametrize("config", ["cfgjson", "onboard64", "default"])
def test_split_route_matches_plain(cuda, config, algorithm, corrections):
    """The FP32 route (the product pass, then the fold and finish) against
    its plain version at the benchmark cells' shapes and at ``Config()``,
    at 1, 5, 16 and 37 frames and every frame tile the class can pick, at
    the K1 gate of the mode; one launch counted a call, the route named
    (one frame takes the fused kernel)."""
    cfg, fused = _split_fused(cuda, config, algorithm, corrections)
    assert (fused.Tc > 0) == corrections
    for B in (1, 5, 16, 37):
        x = torch.from_numpy(_frames(cfg, B, seed=B) * 0.5).to(cuda)
        for bt in _tiles(fused, B):
            got, ref = _run(fused, x, bt)
            BP = got.shape[0]
            assert tk.equiv_power.last_route == (
                tk.SPLIT_ROUTE if BP >= tk.SPLIT_MIN_FRAMES
                else "CUDA cores (FP32 FMA)")
            np.testing.assert_allclose(
                got.cpu().numpy(), ref.cpu().numpy(), rtol=TOL[fused.mode],
                atol=1e-14, err_msg=f"B={B} frame tile {bt}")


def test_split_route_deterministic(cuda):
    """No atomics and a fixed order of every sum: two calls agree bit for
    bit."""
    cfg, fused = _split_fused(cuda, "onboard64", "lerp", True)
    x = torch.from_numpy(_frames(cfg, 16)).to(cuda)
    a, b = fused(x), fused(x)
    assert torch.equal(a, b)


def test_fd_f32_matches_split_route(cuda):
    """K5 at f32 still equals K1 (now the two passes) on the same inputs,
    at the onboard64 shape on the auto fd plan."""
    cfg = _bench_config("onboard64")
    t = tb.make_tables(cfg, "lerp", device=cuda)
    fused = tk.FusedEquivBeamformer(t, mode="f32", sweep="fd")
    assert fused.runs_fd and fused.n_fc > 1
    x = torch.from_numpy(_frames(cfg, 16)).to(cuda)
    got, ref, k1 = _run_fd(fused, x)
    assert tk.equiv_power.last_route == tk.SPLIT_ROUTE
    for other in (ref, k1):
        np.testing.assert_allclose(got.cpu().numpy(), other.cpu().numpy(),
                                   rtol=TOL["f32"], atol=1e-14)


# --- K1 on the connected channels of a channel-sliced stage -----------------

# max |trimmed - untrimmed| / max |untrimmed|: the two sum the same nonzero
# terms (the untrimmed plane adds exact zeros), in another order
TRIM_GAP = 1e-6


@pytest.mark.parametrize("mode,B", [("high", 16), ("high", 1),
                                    ("bf16", 16), ("bf16", 1)])
def test_trimmed_k1_matches_untrimmed(cuda, mode, B):
    """At cfgjson's shape (256 mic slots, 192 connected), K1 over the
    connected channels on the sliced batch against the untrimmed K1 on the
    batch padded back to the frame: 16 frames take the two passes in FP32,
    one frame the fused kernel; bf16 the tensor cores at both."""
    cfg = _bench_config("cfgjson")
    channels = cfg.active_arrays * cfg.rows * cfg.columns
    et = tk.make_equiv_tables(tb.make_tables(cfg, "lerp", device=cuda))
    full = tk.FusedEquivBeamformer(et, mode=mode)
    trim = tk.FusedEquivBeamformer(et, mode=mode, channels=channels)
    assert (full.KP, trim.KP, trim.channels) == (512, 384, channels)
    assert trim.inv == full.inv
    x = torch.from_numpy(_frames(cfg, B, seed=B)[:, :channels]).to(cuda)
    ref = full(pipeline._pad_full(x, cfg.n_microphones))
    route = tk.equiv_power.last_route
    got = trim(x)
    assert tk.equiv_power.last_route == route == (
        tk.SPLIT_ROUTE if mode == "high" and B >= tk.SPLIT_MIN_FRAMES
        else tk.route(trim.plane_dtype))
    gap = float((got - ref).abs().max() / ref.abs().max())
    assert gap <= TRIM_GAP, gap


def test_trim_counter_follows_the_channel_slice(cuda):
    """The full-rate stage of each benchmark configuration, sliced to its
    connected channels: cfgjson's program is K1 over the 192 connected
    mics (KP 384), onboard64's (64 channels of a 64-slot frame) the
    untrimmed K1 behind the pad, one launch a batch each; the fft route,
    sliced or not, launches ``fft_steered_power`` and the Bartlett kernel
    a batch and no K1."""
    from zybo_rt_sampler_image_detection_torch.ops import freq

    cases = (("cfgjson", "lerp", None), ("onboard64", "lerp", None),
             ("webfft", "fft", None), ("webfft", "fft", 192))
    for name, algorithm, channels in cases:
        cfg = _bench_config(name)
        channels = channels or cfg.active_arrays * cfg.rows * cfg.columns
        p = pipeline.Pipeline(cfg, algorithm, replay_mode=True,
                              backend="python", device="cuda")
        stage = p.make_heatmap_batched(batch=16, channels=channels)
        stage.warmup()
        k1, fft = tk.equiv_power.launches, freq.fft_steered_power.launches
        bart = bk.bartlett_power.launches
        for i in range(3):
            x = _frames(cfg, 16, seed=i)[:, :channels]
            _, done = stage._dispatch(np.ascontiguousarray(x))
            done.synchronize()
        k1 = tk.equiv_power.launches - k1
        fft = freq.fft_steered_power.launches - fft
        assert bk.bartlett_power.launches - bart == fft, (name, channels)
        trimmed = isinstance(stage.power_fn, tk.FusedEquivBeamformer)
        if name == "cfgjson":
            assert trimmed and (stage.power_fn.M, stage.power_fn.KP) == (
                192, 384)
        assert trimmed == (name == "cfgjson"), (name, channels)
        assert (k1, fft) == ((0, 3) if algorithm == "fft" else (3, 0)), (
            name, channels)


# --- the Bartlett kernel (csrc/bartlett_power.cu) ---------------------------

FFT_GATE = dict(rtol=2e-4, atol=1e-6)           # tests/test_torch_freq.py
# the widest gap of a map from the complex128 run over its largest value
# (portbench's map_gap); the eager complex64 route reads at most 9.3e-7
BARTLETT_GAP = 1e-5
# a strict subset of the frame's channels, in a band above bin 0
# (tests/test_torch_fft_route.py)
FFT_SMALL = Config.tiny().replace(
    n_microphones=32, array_slots=2, fft_mic_model="fft",
    camera_offset=0.11, freq_band_low=500.0, freq_band_high=18000.0)


def _bartlett_tables(name, dev):
    """``(cfg, tables, bin_weights)``: webfft's tables, the small ones, or
    webfft's laid out over four bin shards (rfft bins of their own, the
    repeated last bin masked by the weights)."""
    from zybo_rt_sampler_image_detection_torch.ops import freq
    from zybo_rt_sampler_image_detection_torch.parallel import mesh as pm

    cfg = FFT_SMALL if name == "small" else _bench_config("webfft")
    t = freq.make_freq_tables(cfg, device=dev)
    if name != "mesh":
        return cfg, t, None
    stp, w = pm.shard_freq_tables(t, pm.make_mesh(1, 4, devices=[dev] * 4))
    return cfg, stp.tables, w


def _gap(got, ref):
    err = (got.double() - ref).abs().reshape(len(ref), -1).amax(1)
    return (err / ref.reshape(len(ref), -1).amax(1)).max().item()


@pytest.mark.parametrize("B", [1, 5, 16, 37])
@pytest.mark.parametrize("name", ["webfft", "small", "mesh"])
def test_bartlett_kernel_matches_eager_and_complex128(cuda, name, B,
                                                      monkeypatch):
    """``fft_steered_power`` through the kernel against the eager
    complex64 route and the complex128 run, on the same frames: the FFT
    gate and the gap limit; two calls bitwise equal, one launch each; a
    lone frame (the live stage's call) at the FFT gate, and bit for bit
    the batch of one."""
    from zybo_rt_sampler_image_detection_torch.ops import freq

    cfg, t, w = _bartlett_tables(name, cuda)
    x = torch.from_numpy(_frames(cfg, B, seed=B)).to(cuda)
    before = bk.bartlett_power.launches
    got = freq.fft_steered_power(x, t, w)
    again = freq.fft_steered_power(x, t, w)
    one = freq.fft_steered_power(x[-1], t, w)
    torch.cuda.synchronize()
    assert bk.bartlett_power.launches == before + 3
    assert torch.equal(got, again)
    ref64 = freq.fft_steered_power(x.double(), t, w)
    monkeypatch.setattr(freq, "takes_bartlett_kernel", lambda *a: False)
    eager = freq.fft_steered_power(x, t, w)
    assert bk.bartlett_power.launches == before + 3
    np.testing.assert_allclose(got.cpu().numpy(), eager.cpu().numpy(),
                               **FFT_GATE)
    assert _gap(got, ref64) <= BARTLETT_GAP, (_gap(got, ref64),
                                              _gap(eager, ref64))
    assert one.shape == (t.res_x, t.res_y)
    assert B > 1 or torch.equal(one, got[0])
    np.testing.assert_allclose(one.cpu().numpy(), eager[-1].cpu().numpy(),
                               **FFT_GATE)


# --- fused time-domain power (csrc/time_power.cu) -------------------------

# max cellwise relative error of the kernel against its plain version, in
# every mode: the same operands, FP32 sums in another order
TIME_RTOL = 1e-4
# bf16 tables against the exact FP32 product: the bf16 class, equal peaks
BF16_CLASS = 3e-2


def _tables(cfg, algorithm, mode, device, cache=False):
    if mode == "bf16":
        cfg = cfg.replace(matmul_dtype="bfloat16", matmul_precision="default")
    elif mode == "high":
        cfg = cfg.replace(matmul_precision="high")
    return tb.make_tables(cfg, algorithm, cache=cache, device=device)


def _plan(fused, dense):
    """``(w, bases)``: the planned windows, or the degenerate dense plan
    (every window all T taps from base 0, the TPU's K2/K3 contraction)."""
    if not dense:
        return fused.Wp, fused.bases
    bases = torch.zeros_like(fused.bases)
    return tf._prep_weights(fused.t.W, bases, fused.T, fused.tile_d,
                            fused.DP, fused.plane_dtype), bases


def _fix_split(monkeypatch, fused, B, G, NS):
    """Make ``fused_power`` launch blocks of G warp tiles x NS sample
    splits for ``fused``'s windows; returns that plan."""
    p = tf.block_plan(fused.N, fused.M, fused.TK, fused.DP, B, fused.NL,
                      fused.Wp.element_size(), fused.JM, fused.Tc, G, NS)
    monkeypatch.setattr(tf, "plan", lambda *args: p)
    return p


def _run_time(fused, x, dense=False):
    s, sj = fused.kernel_inputs(x)
    w, bases = _plan(fused, dense)
    before = tf.fused_power.launches
    got = tf.fused_power(s, w, bases, sj, fused.wc, **fused.kernel_kw)
    torch.cuda.synchronize()
    assert tf.fused_power.launches == before + 1
    return got, tf.fused_power_plain(s, w, bases, sj, fused.wc,
                                     **fused.kernel_kw)


def _maps(fused, out, B):
    return out[:, :fused.D].reshape(B, fused.res_x, fused.res_y)


@pytest.mark.parametrize("window", [False, True], ids=["dense", "window"])
@pytest.mark.parametrize("mode", ["f32", "high", "bf16"])
@pytest.mark.parametrize("algorithm", ["lerp", "hybrid", "convolve"])
@pytest.mark.parametrize("B", [1, 3])
def test_time_kernel_matches_plain_tiny(cuda, window, mode, algorithm, B):
    cfg = Config.tiny()
    t = _tables(cfg, algorithm, mode, cuda)
    fused = tf.FusedBeamformer(t, tile_d=8)
    assert fused.mode == mode
    got, ref = _run_time(fused, torch.from_numpy(_frames(cfg, B)).to(cuda),
                         dense=not window)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=TIME_RTOL, atol=1e-12)


@pytest.mark.parametrize("tile_d", [8, 16, 32])
@pytest.mark.parametrize("B", [1, 5])
def test_time_kernel_tiles(cuda, tile_d, B):
    """Every direction tile, the planned windows and the dense plan."""
    cfg = Config.tiny()
    t = tb.make_tables(cfg, "hybrid", cache=False, device=cuda)
    x = torch.from_numpy(_frames(cfg, B)).to(cuda)
    fused = tf.FusedBeamformer(t, tile_d=tile_d)
    exact = tb.steered_power(x, t).cpu().numpy()
    for dense in (False, True):
        got, ref = _run_time(fused, x, dense=dense)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=TIME_RTOL, atol=1e-12)
        np.testing.assert_allclose(_maps(fused, got, B).cpu().numpy(),
                                   exact, rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(fused(x).cpu().numpy(), exact, rtol=1e-4,
                               atol=1e-12)


@pytest.mark.parametrize("window", [False, True], ids=["dense", "window"])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("algorithm", ["lerp", "hybrid"])
def test_time_kernel_matches_plain_reference_shape(cuda, window, mode,
                                                   algorithm):
    cfg = Config()
    t = _tables(cfg, algorithm, mode, cuda, cache=True)
    fused = tf.FusedBeamformer(t)
    x = torch.from_numpy(_frames(cfg, 2) * 0.5).to(cuda)
    got, ref = _run_time(fused, x, dense=not window)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=TIME_RTOL, atol=1e-14)
    exact = tb.steered_power(x, _tables(cfg, algorithm, "f32", cuda,
                                        cache=True))
    power = _maps(fused, got, 2).double().cpu().numpy()
    exact = exact.double().cpu().numpy()
    if mode == "f32":
        np.testing.assert_allclose(power, exact, rtol=1e-4, atol=1e-14)
    else:
        assert np.abs(power - exact).max() / exact.max() < BF16_CLASS
        for b in range(2):
            assert power[b].argmax() == exact[b].argmax()


@pytest.mark.parametrize("algorithm,mode", [("lerp", "f32"),
                                            ("hybrid", "bf16")])
@pytest.mark.parametrize("B", [1, 3, 16, 37])
def test_time_kernel_every_split(cuda, monkeypatch, algorithm, mode, B):
    """``Config()`` at every block split the planner can take (G warp
    tiles x NS sample splits), against the plain version, and the plan's
    own choice."""
    cfg = Config()
    t = _tables(cfg, algorithm, mode, cuda, cache=True)
    fused = tf.FusedBeamformer(t)
    x = torch.from_numpy(_frames(cfg, B) * 0.5).to(cuda)
    s, sj = fused.kernel_inputs(x)
    ref = tf.fused_power_plain(s, fused.Wp, fused.bases, sj, fused.wc,
                               **fused.kernel_kw).cpu().numpy()
    auto = fused.launch_plan(B)
    splits = [None] + [(G, NS) for NS in tf.sample_splits(fused.N)
                       for G in range(1, tf.MAX_WARPS // NS + 1)]
    for split in splits:
        p = (auto if split is None
             else _fix_split(monkeypatch, fused, B, *split))
        got = tf.fused_power(s, fused.Wp, fused.bases, sj, fused.wc,
                             **fused.kernel_kw)
        torch.cuda.synchronize()
        assert tf._lib().zrt_time_power_smem(
            int(mode == "bf16"), fused.NL, fused.TK, fused.M, fused.JM,
            fused.Tc, p.G, p.NS, p.MG) == p.smem
        np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=TIME_RTOL,
                                   atol=1e-14, err_msg=f"plan {p}")


@pytest.mark.parametrize("B", [1, 16])
def test_time_kernel_deterministic(cuda, B):
    """No atomics, a fixed order of every sum: two launches on the same
    inputs give the same bits, at one frame (sample splits) and 16."""
    cfg = Config()
    t = _tables(cfg, "hybrid", "f32", cuda, cache=True)
    fused = tf.FusedBeamformer(t)
    x = torch.from_numpy(_frames(cfg, B)).to(cuda)
    a, b = fused(x), fused(x)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_time_kernel_checks_bases(cuda, monkeypatch):
    """A base past the padded rows' margin would read outside them: the
    kernel writes NaN for its block instead, and the rest stays right."""
    t = tb.make_tables(Config.tiny(), "lerp", cache=False, device=cuda)
    fused = tf.FusedBeamformer(t)
    x = torch.from_numpy(_frames(Config.tiny(), 2)).to(cuda)
    s, sj = fused.kernel_inputs(x)
    bases = fused.bases.clone()
    bases[0, 0] = fused.lpad - fused.tau_min - fused.TK + 2
    _fix_split(monkeypatch, fused, 2, 1, 1)
    got = tf.fused_power(s, fused.Wp, bases, sj, fused.wc,
                         **fused.kernel_kw)
    ref = tf.fused_power(s, fused.Wp, fused.bases, sj, fused.wc,
                         **fused.kernel_kw)
    torch.cuda.synchronize()
    assert torch.isnan(got[:, :8]).all()
    assert torch.equal(got[:, 8:], ref[:, 8:])


def test_time_wrapper_rejects_bad_inputs(cuda):
    t = tb.make_tables(Config.tiny(), "hybrid", cache=False, device=cuda)
    fused = tf.FusedBeamformer(t, tile_d=8)
    s, sj = fused.kernel_inputs(torch.zeros(3, 16, 64, device=cuda))
    kw = fused.kernel_kw
    w, b, wc = fused.Wp, fused.bases, fused.wc
    with pytest.raises(ValueError, match="dtype"):
        tf.fused_power(s.double(), w, b, sj, wc, **kw)
    with pytest.raises(ValueError, match="bases"):
        tf.fused_power(s, w, b.long(), sj, wc, **kw)
    with pytest.raises(ValueError, match="device"):
        tf.fused_power(s, w.cpu(), b, sj, wc, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tf.fused_power(s.transpose(1, 2).contiguous().transpose(1, 2),
                       w, b, sj, wc, **kw)
    # the list without sj, sj without the list, and a bad list
    with pytest.raises(ValueError, match="sj"):
        tf.fused_power(s, w, b, None, wc, **kw)
    with pytest.raises(ValueError, match="wc"):
        tf.fused_power(s, w, b, sj, None, **kw)
    with pytest.raises(ValueError, match="sj"):
        tf.fused_power(s, w, b, sj.double(), wc, **kw)
    for bad in (wc._replace(ptr=wc.ptr.long()),
                wc._replace(val=wc.val[:-1].contiguous()),
                wc._replace(ptr=wc.ptr[:-1].contiguous()), tuple(wc)):
        with pytest.raises(ValueError, match="wc"):
            tf.fused_power(s, w, b, sj, bad, **kw)
    # rows too short for the shifted reads
    with pytest.raises(ValueError, match="rows"):
        tf.fused_power(s[..., :-8].contiguous(), w, b, sj, wc, **kw)
    with pytest.raises(ValueError, match="rows"):
        tf.fused_power(s, w, b, sj, wc, **{**kw, "lpad": 0})
    with pytest.raises(ValueError, match="split"):
        tf.block_plan(fused.N, fused.M, fused.TK, fused.DP, 3, fused.NL,
                      fused.Wp.element_size(), fused.JM, fused.Tc, 8, 2)


def test_fused_policy_launches_kernel(cuda, monkeypatch):
    """bf16 tables outside the equiv bar select the fused time-domain
    kernel, which launches on CUDA tables (no fallback)."""
    monkeypatch.setattr(pipeline, "_equiv_bar", lambda tables: False)
    t = _tables(Config.tiny(), "lerp", "bf16", cuda)
    kind, obj = pipeline._select_power_backend(t)
    assert kind == "fused" and isinstance(obj, tf.FusedBeamformer)
    before = tf.fused_power.launches
    out = pipeline.power_program(t)(
        torch.from_numpy(_frames(Config.tiny(), 4)).to(cuda))
    torch.cuda.synchronize()
    assert out.shape == (4, 9, 7) and tf.fused_power.launches == before + 1


# --- direction-innermost equiv power (csrc/equiv_power_fd.cu) -------------


def _run_fd(fused, x, block_b=None):
    """The fd kernel, its plain version and K1 on the same inputs."""
    S, sj, bt = fused.kernel_inputs(x, block_b)
    kw = dict(n_tail=fused.n_tail, Tc=fused.Tc, inv=fused.inv)
    args = (S, fused.H1, fused.ib1, fused.ib2, sj, fused.wc)
    before = tk.equiv_power_fd.launches
    got = tk.equiv_power_fd(*args, n_fc=fused.n_fc, block_b=bt, **kw)
    torch.cuda.synchronize()
    assert tk.equiv_power_fd.launches == before + 1
    k1 = tk.equiv_power(*args, block_b=bt, **kw)
    return got, tk.equiv_power_fd_plain(*args, n_fc=fused.n_fc, **kw), k1


@pytest.mark.parametrize("n_fc", [2, 3])
@pytest.mark.parametrize("mode", ["f32", "high", "bf16"])
@pytest.mark.parametrize("algorithm", ["lerp", "hybrid", "convolve"])
@pytest.mark.parametrize("B", [1, 3, 11, 16])
def test_fd_kernel_matches_plain_tiny(cuda, n_fc, mode, algorithm, B):
    """The fd kernel against its plain version and against K1, at the
    mode's gate (the sums run in other orders, never bit-identical), at
    every frame tile the plan can take."""
    cfg = Config.tiny()
    t = tb.make_tables(cfg, algorithm, cache=False, device=cuda)
    fused = tk.FusedEquivBeamformer(t, mode=mode, plan_override=(16, n_fc),
                                    sweep="fd")
    assert fused.runs_fd and fused.FP == fused.fc * n_fc >= fused.F
    x = torch.from_numpy(_frames(cfg, B)).to(cuda)
    for bt in _tiles(fused, B):
        got, ref, k1 = _run_fd(fused, x, bt)
        for other in (ref, k1):
            np.testing.assert_allclose(got.cpu().numpy(),
                                       other.cpu().numpy(), rtol=TOL[mode],
                                       atol=1e-14, err_msg=f"frame tile {bt}")


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("mode", ["f32", "high", "bf16"])
@pytest.mark.parametrize("algorithm", ["lerp", "hybrid"])
def test_fd_kernel_matches_plain_reference_shape(cuda, algorithm, mode, B):
    """``Config()`` on the auto fd plan (more than one chunk), every frame
    tile the plan can take."""
    cfg = Config()
    t, fused = _ref_fused(cuda, algorithm, mode, "fd")
    assert fused.runs_fd and fused.n_fc > 1
    x = torch.from_numpy(_frames(cfg, B) * 0.5).to(cuda)
    for bt in _tiles(fused, B):
        got, ref, k1 = _run_fd(fused, x, bt)
        for other in (ref, k1):
            g, r = got.cpu().numpy(), other.cpu().numpy()
            if mode == "bf16":
                g, r = g[:B, :fused.D], r[:B, :fused.D]
                assert np.abs(g / r - 1).max() <= TOL[mode], bt
                assert (g.argmax(1) == r.argmax(1)).all(), bt
            else:
                np.testing.assert_allclose(g, r, rtol=TOL[mode], atol=1e-14,
                                           err_msg=f"frame tile {bt}")
    if mode == "f32":
        power = fused(x)
        exact = tb.steered_power(x, t)
        np.testing.assert_allclose(power.cpu().numpy(), exact.cpu().numpy(),
                                   rtol=1e-4, atol=1e-14)


def test_fd_wrapper_rejects_bad_inputs(cuda):
    t = tb.make_tables(Config.tiny(), "lerp", cache=False, device=cuda)
    fused = tk.FusedEquivBeamformer(t, mode="f32", plan_override=(8, 3),
                                    sweep="fd")
    S, sj, bt = fused.kernel_inputs(torch.zeros(3, 16, 64, device=cuda))
    kw = dict(n_tail=fused.n_tail, Tc=fused.Tc, inv=fused.inv)
    args = (fused.H1, fused.ib1, fused.ib2, sj, fused.wc)
    with pytest.raises(ValueError, match="dtype"):
        tk.equiv_power_fd(S.double(), *args, n_fc=3, block_b=bt, **kw)
    with pytest.raises(ValueError, match="block_b"):
        tk.equiv_power_fd(S, *args, n_fc=3, block_b=8, **kw)
    with pytest.raises(ValueError, match="n_fc"):
        tk.equiv_power_fd(S, *args, n_fc=4, block_b=bt, **kw)
    with pytest.raises(ValueError, match="device"):
        tk.equiv_power_fd(S, fused.H1.cpu(), *args[1:], n_fc=3, block_b=bt,
                          **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tk.equiv_power_fd(S.transpose(1, 2).contiguous().transpose(1, 2),
                          *args, n_fc=3, block_b=bt, **kw)


@pytest.mark.parametrize("bf16", [0, 1])
@pytest.mark.parametrize("bt", [1, 2, 4, 8])
def test_fd_blocks_per_sm(cuda, bf16, bt):
    """The runtime's occupancy of the chunk kernel at the reference
    shape's fd plan: at least one block an SM, at most the threads allow;
    bad arguments come back as a negated CUDA error; the plan's direction
    groups and ring fit."""
    lib = tk._lib("equiv_power_fd")
    fc = 13 if bf16 else 8
    n = lib.zrt_equiv_power_fd_blocks_per_sm(bf16, bt, 512, fc, 106, 2)
    assert 1 <= n <= 2048 // (512 if bt >= 8 else 256)
    assert lib.zrt_equiv_power_fd_blocks_per_sm(bf16, 3, 512, fc, 106, 2) < 0
    assert lib.zrt_equiv_power_fd_blocks_per_sm(bf16, bt, 500, fc, 106, 2) < 0
    dev = torch.device("cuda", 0)
    assert tk._blocks_per_sm(lib, "zrt_equiv_power_fd_blocks_per_sm", dev,
                             bf16, bt, 512, fc, 106, 2) == n
    cost, stages, n_dg = tk._fd_plan(dev, bf16, bt, 512, fc, 106, 1, 11, 114)
    assert cost >= 1 and 2 <= stages <= tk.MAX_STAGES and 1 <= n_dg <= 114


# -- training (no kernel of its own: cuDNN FP32 convs with TF32 off) --------

TRAIN_LOSS_RTOL = 1e-4    # five steps' losses (tests/test_torch_train.py)
TRAIN_LEAF_RNORM = 3e-4   # every leaf after five steps (test_vision.py:451)


def _train_run(device, batches, order):
    from zybo_rt_sampler_image_detection_torch.models import train, yolo

    cfg = yolo.YoloConfig(input_size=64, width_mult=0.25)
    tr = train.Trainer(cfg, learning_rate=3e-3, seed=0, device=device)
    losses = [tr.train_step(im[order], [bx[i] for i in order])
              for im, bx in batches]
    return losses, tr.state.variables


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree, np.float64)


def test_train_steps_card_match_cpu(cuda):
    """Five train steps at the demo shape (64 px, width 0.25, B=8) from
    one seeded init on the card and on the CPU, each in the given batch
    order and seven fixed permutations of every batch: losses at rtol
    1e-4 and every leaf within a relative norm of 3e-4 for at least one
    (card order, CPU order) pair (a near-tie in a max-pool window turns an
    FP32 gradient one way or the other: tests/test_torch_train.py
    ``test_five_steps_match_jax``)."""
    from zybo_rt_sampler_image_detection_torch.models import data

    rng = np.random.default_rng(6)
    batches = [data.synthetic_detection_batch(rng, 8, 64) for _ in range(5)]
    orders = [np.arange(8)] + [np.random.default_rng(s).permutation(8)
                               for s in range(7)]
    cards = [_train_run("cuda", batches, o) for o in orders]
    cpus = [_train_run("cpu", batches, o) for o in orders]
    dists = []
    for got, got_vars in cards:
        assert np.isfinite(got).all()
        gl = dict(_leaves(got_vars))
        for ref, ref_vars in cpus:
            rl = dict(_leaves(ref_vars))
            leaf = max(np.linalg.norm(gl[p] - r)
                       / max(np.linalg.norm(r), 1e-12)
                       for p, r in rl.items())
            loss = np.max(np.abs(np.subtract(got, ref)) / np.abs(ref))
            dists.append((loss, leaf))
    assert any(loss < TRAIN_LOSS_RTOL and leaf < TRAIN_LEAF_RNORM
               for loss, leaf in dists), min(dists, key=lambda d: d[1])


# -- the device mesh on the card ----------------------------------------------------

def _card_mesh(cuda, n_data, n_model):
    """A mesh of ``cuda:0`` repeated: every block's kernel launches on the
    one card."""
    from zybo_rt_sampler_image_detection_torch.parallel import mesh

    return mesh.make_mesh(n_data, n_model,
                          devices=[torch.device("cuda", 0)] * (n_data
                                                               * n_model))


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (4, 2), (2, 4)])
@pytest.mark.parametrize("B", [8, 5])
def test_sharded_kernels_launch_per_block(cuda, shape, B):
    """K1 (``sharded_equiv_kernel_power``) and K2 (``sharded_fused_power``)
    launch once a block a call and equal the single-device product at the
    JAX gates (tests/test_parallel.py: rtol 5e-5 / atol 1e-8 and rtol 1e-4
    / atol 1e-10)."""
    from zybo_rt_sampler_image_detection_torch.parallel import mesh

    cfg = Config.tiny().replace(matmul_precision="high")
    t = tb.make_tables(cfg, "lerp", cache=False, device=cuda)
    x = torch.from_numpy(_frames(cfg, B, seed=2)).to(cuda)
    ref = tb.steered_power(x, t).cpu().numpy()
    m = _card_mesh(cuda, *shape)
    blocks = shape[0] * shape[1]
    k1 = mesh.sharded_equiv_kernel_power(m, t)
    before = tk.equiv_power.launches
    got = k1(x)
    torch.cuda.synchronize()
    assert tk.equiv_power.launches == before + blocks
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=5e-5, atol=1e-8)
    k2 = mesh.sharded_fused_power(m, mesh.shard_tables(t, m))
    before = tf.fused_power.launches
    got = k2(x)
    torch.cuda.synchronize()
    assert tf.fused_power.launches == before + blocks
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=1e-4,
                               atol=1e-10)


def test_sharded_reference_shape_parity(cuda):
    """At Config() (57x32 grid, 256 mics, lerp T=49) over a (2, 4) mesh:
    the exact product sharded equals one device (rtol 1e-6), the kernel a
    block (rtol 1e-4), and every block's plan is the one
    ``fused_kernel.plan`` gives for its shard (the port's counterpart of
    JAX's chunked-T selection at the reference shard shape)."""
    from zybo_rt_sampler_image_detection_torch.parallel import mesh

    cfg = Config()
    t = tb.make_tables(cfg, "lerp", device=cuda)
    x = torch.from_numpy(_frames(cfg, 2, seed=1)).to(cuda)
    ref = tb.steered_power(x, t)
    m = _card_mesh(cuda, 2, 4)
    st = mesh.shard_tables(t, m)
    got = mesh.sharded_steered_power(m, st)(x)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-6, atol=1e-12)
    fn = mesh.sharded_fused_power(m, st)
    np.testing.assert_allclose(fn(x).cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-4, atol=1e-10)
    for key, p in fn.plans(2).items():
        b = fn.beamformers[key]
        assert b.launch_plan(1) == p and b.TK < t.n_taps_line


def test_trainer_mesh_on_card_matches_single(cuda):
    """Trainer(mesh=(2, 1) over cuda:0) against Trainer(device="cuda") on
    one global batch: loss rtol 1e-4, every leaf within 3e-4."""
    from zybo_rt_sampler_image_detection_torch.models import data, train, yolo

    cfg = yolo.YoloConfig(input_size=64, width_mult=0.25)
    images, boxes = data.synthetic_detection_batch(
        np.random.default_rng(6), 8, 64)
    single = train.Trainer(cfg, learning_rate=3e-3, device="cuda")
    sharded = train.Trainer(cfg, learning_rate=3e-3,
                            mesh=_card_mesh(cuda, 2, 1))
    l1 = single.train_step(images, boxes)
    l2 = sharded.train_step(images, boxes)
    assert abs(l2 - l1) <= TRAIN_LOSS_RTOL * abs(l1)
    rl = dict(_leaves(single.state.variables))
    gl = dict(_leaves(sharded.state.variables))
    worst = max(np.linalg.norm(gl[p] - r) / max(np.linalg.norm(r), 1e-12)
                for p, r in rl.items())
    assert worst < TRAIN_LEAF_RNORM, worst


def test_dryrun_multichip_on_card(cuda):
    from zybo_rt_sampler_image_detection_torch.parallel import dryrun

    out = dryrun.dryrun_multichip(4, devices=[torch.device("cuda", 0)] * 4)
    assert out["mesh"] == [2, 2] and np.isfinite(out["train_loss"])


def test_web_monitor_on_card(cuda):
    """The web monitor on the card at the tiny preset's ``high`` rung: the
    pad backend runs K1, /monitor serves JPEGs, /metrics names the
    encoder.  UDP port 22187."""
    import json
    import threading
    import urllib.request

    from zybo_rt_sampler_image_detection_torch.apps import web
    from zybo_rt_sampler_image_detection_torch.ingest import streamer

    cfg = Config.tiny().replace(udp_port=22187, matmul_precision="high")
    streamer.stream_in_background(
        cfg, list(_frames(cfg, 3000, seed=4)), n_arrays=1, delay=0.5,
        exact_reference=False, rate=cfg.sample_rate)
    server = web.make_server(cfg, replay=True, port=0, device="cuda")
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        before = tk.equiv_power.launches
        urllib.request.urlopen(f"http://127.0.0.1:{port}/enableBackend1",
                               timeout=60).read()
        req = urllib.request.urlopen(f"http://127.0.0.1:{port}/monitor",
                                     timeout=15)
        data = req.read(200000)
        req.close()
        assert data.count(b"\r\n--frame\r\n") >= 1 and b"\xff\xd8" in data
        rep = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read())
        assert rep["running"] and rep["jpeg"] in ("cv2", "pil", "numpy")
        assert tk.equiv_power.launches > before
    finally:
        server.shutdown()
        server.server_close()
        server.camera.stop()


def test_spans_off_under_a_cuda_only_profile(cuda):
    """A profile of CUDA activity alone (the benchmark's kernel clock)
    leaves the spans off; one that records CPU activity turns them on,
    with a fresh report."""
    from torch.profiler import ProfilerActivity, profile

    from zybo_rt_sampler_image_detection_torch.utils import profiling

    x = torch.ones(1024, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]):
        assert profiling.annotate("x") is profiling.annotate("y")
        with profiling.annotate("cuda.only"):
            (x * 2).sum()
        torch.cuda.synchronize()
    assert "cuda.only" not in profiling.report()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profiling.annotate("cpu.too"):
            (x * 2).sum()
        torch.cuda.synchronize()
    rep = profiling.report()
    assert set(rep) == {"cpu.too"} and rep["cpu.too"]["n"] == 1


def test_spans_carry_the_device_time_they_launch(cuda):
    """A tiny full-rate stage on the card under a profile of CPU and CUDA
    activity that records the starting thread's ranges alone (as the
    benchmark's ``DeviceTrace`` opens it): the stage thread's
    ``power.kernel`` launched device time, and the spans' attributed
    device time covers the session's kernels and memsets."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from zybo_rt_sampler_image_detection_torch.utils import profiling

    cfg = Config.tiny().replace(matmul_precision="high")
    p = pipeline.Pipeline(cfg, "lerp", backend="python", device="cuda")
    frames = _frames(cfg, 64, seed=5)
    for f in frames:
        p.receiver.buffer.publish(f)
    firsts = []
    stage = p.make_heatmap_batched(
        batch=4, sink=lambda powers, first: firsts.append(first))
    stage.warmup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        assert not profiling._every
        p.run_stage(stage)
        deadline = time.monotonic() + 60
        while len(firsts) < 16 and time.monotonic() < deadline:
            time.sleep(0.02)
        p.stop()
        torch.cuda.synchronize()
    assert len(firsts) == 16
    rep, ses = profiling.report(), profiling.session()
    assert rep["power.kernel"]["device_self_s"] > 0
    assert rep["stage.batch"]["device_s"] >= rep["power.kernel"]["device_s"]
    spans = sum(v["device_self_s"] for v in rep.values())
    assert ses["device_s"] > 0 and spans >= 0.99 * ses["device_s"], (
        spans, ses)
    assert ses["launch_tid"] == stage.native_id
    assert sum(v["idle_s"] for v in rep.values()) + ses["idle_outside_s"] \
        == pytest.approx(ses["idle_s"], rel=1e-9, abs=1e-9)
    assert rep["stage.h2d"]["copy_s"] > 0


def test_invert_hermitian_on_the_card_solves_the_factor(cuda):
    """On the card the refresh's inverse is a triangular solve against
    the identity and one product (``freq._inverse_from_factor``): at the
    MVDR cell's shape (127 bins of 192 mics, complex64) it is as close to
    the complex128 inverse of the same factor as ``torch.cholesky_inverse``
    (MAGMA's batched potrs on the card) is."""
    from zybo_rt_sampler_image_detection_torch.ops import freq

    g = torch.Generator(device="cuda").manual_seed(23)
    X = torch.randn((127, 192, 40), dtype=torch.complex64, device=cuda,
                    generator=g)
    R = X @ X.mH
    R = R + (1e-3 * R.diagonal(dim1=-2, dim2=-1).real.sum(-1) / 192)[
        :, None, None] * torch.eye(192, device=cuda)
    P = freq.invert_hermitian(R)
    L, _ = torch.linalg.cholesky_ex(R)
    torch.testing.assert_close(P, freq._inverse_from_factor(L), rtol=0,
                               atol=0)
    truth = torch.cholesky_inverse(L.cpu().to(torch.complex128))
    scale = truth.abs().max()
    err = (P.cpu().to(torch.complex128) - truth).abs().max() / scale
    potrs = torch.cholesky_inverse(L).cpu().to(torch.complex128)
    err_potrs = (potrs - truth).abs().max() / scale
    assert err < max(4 * err_potrs, 1e-5), (err, err_potrs)
