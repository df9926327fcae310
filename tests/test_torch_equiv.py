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
from zybo_rt_sampler_image_detection_torch.apps import pipeline
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


def _k1_shapes(cfg, algorithm, channels=0):
    """``(F, KP, DP, Tt, Tc, JM)`` of K1 on ``cfg``'s tables, from the
    time-domain tables alone (``equiv_dims``), as ``FusedEquivBeamformer``
    pads them; with ``channels``, over the mics below that channel
    slice."""
    t = tb.make_tables(cfg, algorithm, cache=False, device="cpu")
    D, _, M = t.W.shape
    if channels:
        M = int((t.adaptive < channels).sum())
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
                                    "onboard64", "cfgjson.connected"])
@pytest.mark.parametrize("algorithm", ["lerp", "hybrid"])
def test_split_plan_fits_shared_memory(config, algorithm):
    """K1's FP32 route in two passes: every shape the repo's configurations
    reach (``.connected``: the plane over the connected channels of a
    channel-sliced stage, KP = 384 at cfgjson), at 1, 16 and 37 frames
    (padded to each frame tile the class can pick), gets a product pass and
    a fold pass whose blocks fit 227 KB of shared memory (two product
    blocks to an SM), fold warps that cover every tail/head sample, and a P
    buffer that holds Br and Bi of every bin, frame and direction."""
    name, _, part = config.partition(".")
    cfg = {"default": Config, "northstar": Config.northstar}.get(
        name, lambda: _bench_config(name))()
    channels = cfg.active_arrays * cfg.rows * cfg.columns if part else 0
    F, KP, DP, Tt, Tc, JM = _k1_shapes(cfg, algorithm, channels)
    assert KP // 2 % tk.SPLIT_KC == 0
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
    # cfgjson's stage slices its frames to the 192 connected channels
    assert _k1_shapes(_bench_config("cfgjson"), "lerp", 192) == (
        154, 384, 1824, 98, 48, 192)
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


# --- K1 on the connected channels only (FusedEquivBeamformer(channels=)) ----
# A full-rate stage that slices its frames to the connected channels hands
# the program (B, channels, N) batches, whose padded rows are exactly zero:
# the plane, the head corrections and the gather over the mics below the
# slice give the maps of the untrimmed tables on the same batches padded by
# ``_pad_full``, with the normalisation of every mic.  Unsliced programs keep
# the untrimmed tables, and a stage builds one plane.  The kernels on the
# card: ``tests/test_torch_cuda.py -k trim``.

# the trimmed and untrimmed products sum the same nonzero FP32 terms; the
# CPU's bmm blocks a K of 384 and one of 512 differently
REASSOC_RTOL = 1e-6


def _config(name):
    """``(cfg, channels)``: cfgjson's frame (4 slots, 3 boards connected)
    on a 5x3 grid; a 2-slot tiny frame with every second mic (so the kept
    mics are not the first rows of the frame) and one dead mic."""
    if name == "cfgjson":
        cfg = _bench_config("cfgjson").replace(max_res_x=5, max_res_y=3)
    else:
        cfg = Config.tiny().replace(n_microphones=32, array_slots=2,
                                    skip_n_mics=2, unused_mics=(2,),
                                    matmul_precision="high")
    return cfg, cfg.active_arrays * cfg.rows * cfg.columns


def _sliced(cfg, channels, B, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(
        (B, channels, cfg.n_samples)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("mode", ["high", "bf16"])
@pytest.mark.parametrize("config", ["cfgjson", "skip2"])
def test_trimmed_plane_equals_padded(config, mode):
    """The trimmed beamformer on sliced batches against the untrimmed one
    on the same batches padded back to the frame: the same maps (FP32
    reassociation), the same ``inv``, the kept mics' columns of the plane
    and corrections, and K = 2M shrunk with M."""
    cfg, channels = _config(config)
    t = tb.make_tables(cfg, "lerp", cache=False, device="cpu")
    full = tk.FusedEquivBeamformer(t, mode=mode)
    trim = tk.FusedEquivBeamformer(t, mode=mode, channels=channels)
    kept = t.adaptive < channels
    n_kept = int(kept.sum())
    assert 0 < n_kept < full.M and full.channels == 0
    assert trim.channels == channels and trim.M == n_kept
    assert trim.inv == full.inv
    assert trim.KP == tk._round_up(2 * n_kept, tk.K_ALIGN)
    assert trim.JM == len(trim.corr_js) * n_kept
    if config == "cfgjson":
        assert (full.M, full.KP, trim.KP) == (256, 512, 384)
        assert trim.adaptive is None        # the first 192 rows, in order
    else:
        assert not torch.equal(t.adaptive[kept],
                               torch.arange(n_kept))
        assert torch.equal(trim.adaptive, t.adaptive[kept])
    # the plane's columns: [Hr | -Hi] of the kept mics, each half padded
    hf, ht = tk.dense_plane(full.H1), tk.dense_plane(trim.H1)
    idx = torch.nonzero(kept).squeeze(1)
    assert torch.equal(ht[:, :n_kept], hf[:, idx])
    assert torch.equal(ht[:, trim.MP:trim.MP + n_kept],
                       hf[:, full.MP + idx])
    assert not ht[:, n_kept:trim.MP].any()
    for B in (1, 16):
        x = _sliced(cfg, channels, B, seed=B)
        ref = full(pipeline._pad_full(x, cfg.n_microphones))
        got = trim(x)
        assert got.shape == ref.shape
        np.testing.assert_allclose(_np(got), _np(ref),
                                   rtol=REASSOC_RTOL, atol=0,
                                   err_msg=f"B={B}")


def test_trimmed_plane_takes_f16_transfers():
    """An f16 transfer's sliced batch is upcast by the gather, as
    ``_pad_full`` upcasts it for the untrimmed tables."""
    cfg, channels = _config("skip2")
    t = tb.make_tables(cfg, "lerp", cache=False, device="cpu")
    x = _sliced(cfg, channels, 4).half()
    ref = tk.FusedEquivBeamformer(t)(pipeline._pad_full(x,
                                                        cfg.n_microphones))
    got = tk.FusedEquivBeamformer(t, channels=channels)(x)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=REASSOC_RTOL,
                               atol=0)


def test_trim_needs_a_mic_below_the_slice():
    cfg = Config.tiny().replace(n_microphones=32, array_slots=2,
                                unused_mics=(0, 1))
    t = tb.make_tables(cfg, "lerp", cache=False, device="cpu")
    with pytest.raises(ValueError, match="no active mic"):
        tk.FusedEquivBeamformer(t, channels=2)


class _OnCard:
    """CPU tables the policy takes for the card's: its equiv kernel then
    runs the plain version."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda")

    def __getattr__(self, name):
        return getattr(self._t, name)


@pytest.fixture
def card_policy(monkeypatch):
    """The policy as on the card, on CPU tables; the beamformers it
    builds are recorded."""
    built = []
    policy_kernel = pipeline._equiv_kernel_if_favored

    def recorded(*a, **kw):
        built.append(policy_kernel(*a, **kw))
        return built[-1]

    monkeypatch.setattr(pipeline, "_equiv_kernel_if_favored", recorded)
    monkeypatch.setattr(pipeline, "_equiv_tables_if_favored",
                        lambda tables: tf.make_equiv_tables(tables._t))
    return built


@pytest.fixture
def k1_planes(monkeypatch):
    """The plane width KP of every K1 call, in order (on the CPU, where
    ``equiv_power.launches`` counts nothing)."""
    planes = []
    k1 = tk.equiv_power

    def recorded(S, H1, *a, **kw):
        planes.append(H1.shape[2])          # (DP/TD, FP, KP, TD)
        return k1(S, H1, *a, **kw)

    monkeypatch.setattr(tk, "equiv_power", recorded)
    return planes


@pytest.fixture
def pads(monkeypatch):
    """The (input, output) shapes of every ``_pad_full`` call."""
    seen = []
    pad = pipeline._pad_full

    def recorded(frames, n_full):
        out = pad(frames, n_full)
        seen.append((tuple(frames.shape), tuple(out.shape)))
        return out

    monkeypatch.setattr(pipeline, "_pad_full", recorded)
    return seen


@pytest.mark.parametrize("sliced", [0, "full", "connected"])
def test_batched_program_trims_only_sliced_stages(card_policy, k1_planes,
                                                  pads, sliced):
    """The full-rate program builds one beamformer: over the connected
    channels where the stage slices its frames (the program is then the
    beamformer, and it takes the sliced batch unpadded), else the
    untrimmed tables behind ``_pad_full``.  One K1 call a batch."""
    cfg, connected = _config("cfgjson")
    n_full = cfg.n_microphones
    channels = {0: 0, "full": n_full, "connected": connected}[sliced]
    t = tb.make_tables(cfg, "lerp", cache=False, device="cpu")
    prog = pipeline.power_program(_OnCard(t), n_full, channels)
    assert len(card_policy) == 1
    k = card_policy[0]
    rows = channels or n_full
    x = _sliced(cfg, rows, 16)
    out = prog(x)
    if sliced == "connected":
        assert prog is k and (k.M, k.KP) == (connected, 384)
        assert not pads
    else:
        assert prog is not k and (k.M, k.KP) == (n_full, 512)
        assert pads == [((16, n_full, cfg.n_samples),) * 2]
    assert k1_planes == [k.KP]
    ref = tk.FusedEquivBeamformer(t)(pipeline._pad_full(x, n_full))
    np.testing.assert_allclose(_np(out), _np(ref), rtol=REASSOC_RTOL,
                               atol=0)


def test_trim_leaves_other_backends_padded(card_policy, k1_planes, pads):
    """The exact product (CPU tables) and the fft route take the padded
    batch at a channel slice: no beamformer, no trim."""
    from zybo_rt_sampler_image_detection_torch.ops import freq

    cfg, channels = _config("skip2")
    x = _sliced(cfg, channels, 2)
    n_full = cfg.n_microphones
    t = tb.make_tables(cfg, "lerp", cache=False, device="cpu")
    ft = freq.make_freq_tables(cfg, device="cpu")
    for tables, ref in ((t, tb.steered_power), (ft, freq.fft_steered_power)):
        prog = pipeline.power_program(tables, n_full, channels)
        del pads[:]
        got = prog(x)
        assert pads == [((2, channels, cfg.n_samples),
                         (2, n_full, cfg.n_samples))]
        np.testing.assert_allclose(
            _np(got), _np(ref(pipeline._pad_full(x, n_full), tables)),
            rtol=1e-6, atol=0)
    assert not card_policy and not k1_planes


def test_stages_hand_the_sliced_batch_to_the_trimmed_program(card_policy,
                                                             k1_planes,
                                                             pads,
                                                             monkeypatch):
    """The full-rate heatmap stage and the combined listening stage, both
    sliced to the connected channels: every batch runs the trimmed plane
    unpadded, the maps equal the untrimmed tables' on the padded batch,
    and the combined stage's beam pads its own copy."""
    cfg, channels = _config("skip2")
    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend="python",
                          device="cpu")
    policy = pipeline._select_power_backend
    monkeypatch.setattr(pipeline, "_select_power_backend",
                        lambda tables, channels=0: policy(_OnCard(tables),
                                                          channels))
    n_full = cfg.n_microphones
    n_kept = int((p.tables.adaptive < channels).sum())
    x = _sliced(cfg, channels, 4)
    full = tk.FusedEquivBeamformer(p.tables)
    ref = full(pipeline._pad_full(x, n_full))
    del pads[:], k1_planes[:]
    stage = p.make_heatmap_batched(batch=4, channels=channels)
    k = card_policy[-1]
    assert stage.power_fn is k and k.M == n_kept < full.M
    np.testing.assert_allclose(_np(stage.launch(x)), _np(ref),
                               rtol=REASSOC_RTOL, atol=0)
    combined = p.make_mimo_miso_batched(batch=4, channels=channels)
    assert len(card_policy) == 2 and card_policy[-1].M == n_kept
    maps, beams = combined.process_fn(x, 0)
    assert k1_planes == [k.KP, k.KP]
    # the beam's own pad, the one pad of the two batches
    assert pads == [((4, channels, cfg.n_samples),
                     (4, n_full, cfg.n_samples))]
    np.testing.assert_allclose(_np(maps), _np(ref), rtol=REASSOC_RTOL,
                               atol=0)
    torch.testing.assert_close(
        beams, tb.miso_beam(pipeline._pad_full(x, n_full), p.tables, 0),
        rtol=0, atol=0)


@pytest.mark.parametrize("name", ["cfgjson", "onboard64", "webfft"])
def test_each_cell_runs_its_program(card_policy, k1_planes, pads,
                                    monkeypatch, name):
    """The benchmark's full-rate stage of each configuration (its
    algorithm, sliced to its connected channels; the policy as on the card,
    on a 5x3 grid): cfgjson runs K1 over its 192 connected mics (KP 384) on
    the unpadded batch, onboard64 the untrimmed K1 behind ``_pad_full``,
    which pads nothing, and webfft ``fft_steered_power`` behind
    ``_pad_full``.  One kernel call a batch, and the maps of the untrimmed
    program on the padded batch."""
    from zybo_rt_sampler_image_detection_torch.ops import freq

    cfg = _bench_config(name).replace(max_res_x=5, max_res_y=3)
    algorithm = "fft" if name == "webfft" else "lerp"
    n_full, B = cfg.n_microphones, 16
    channels = cfg.active_arrays * cfg.rows * cfg.columns
    policy = pipeline._select_power_backend
    monkeypatch.setattr(
        pipeline, "_select_power_backend",
        lambda t, channels=0: policy(
            t if isinstance(t, freq.FreqTables) else _OnCard(t), channels))
    p = pipeline.Pipeline(cfg, algorithm, replay_mode=True, backend="python",
                          device="cpu")
    assert p.connected_channels == channels
    stage = p.make_heatmap_batched(batch=B, channels=channels)
    ffts = freq.fft_steered_power.launches
    outs, xs = [], []
    for i in range(3):
        xs.append(_sliced(cfg, channels, B, seed=i))
        outs.append(stage.launch(xs[-1]))
    padded = list(pads)
    if name == "webfft":
        assert not card_policy and not k1_planes
        assert freq.fft_steered_power.launches == ffts + 3
        ref = [freq.fft_steered_power(x, p.power_tables) for x in xs]
    else:
        k, = card_policy
        assert freq.fft_steered_power.launches == ffts
        assert k1_planes == [k.KP] * 3
        full = tk.FusedEquivBeamformer(p.tables)
        ref = [full(pipeline._pad_full(x, n_full)) for x in xs]
    if name == "cfgjson":
        assert stage.power_fn is k and (k.M, k.KP) == (192, 384)
        assert channels < n_full and not padded
    else:
        assert channels == n_full
        assert padded == [((B, n_full, cfg.n_samples),) * 2] * 3
    if name == "onboard64":
        assert stage.power_fn is not k and (k.M, k.KP) == (64, 128)
    for got, want in zip(outs, ref):
        np.testing.assert_allclose(_np(got), _np(want), rtol=REASSOC_RTOL,
                                   atol=0)
