"""The time-domain kernel's block plan (``fused_kernel.plan``): a pure
function of the launch's shape and the SM count that ranks every block
split by its model of the card (``fused_kernel.model_times``).  On the
CPU: what the model counts, the plan's limits at every preset, and the
splits it picks at the shapes ``scripts/profile_time_power.py --sweep``
timed.  On the card only (marker ``cuda``; skips elsewhere): at
``cfgjson_fine``'s shape the planned split's maps equal the one-tile
split's bit for bit.  This file imports no JAX, so the card half runs
with::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_time_plan.py
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from zybo_rt_sampler_image_detection_torch import Config
from zybo_rt_sampler_image_detection_torch.ops import beamform as tb
from zybo_rt_sampler_image_detection_torch.ops import fused_kernel as tf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kernel against its plain version (tests/test_torch_cuda.py TIME_RTOL)
TIME_RTOL = 1e-4
FINE_TK = 3          # taps of cfgjson_fine's tile-8 windows on the card


def _fine_config() -> Config:
    with open(os.path.join(ROOT, "portbench", "configs",
                           "cfgjson_fine.json")) as f:
        config = json.load(f)
    names = set(Config.__dataclass_fields__)
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in config.items() if k in names}
    return Config(**kw)


@functools.lru_cache(maxsize=None)
def _shape(preset: str, algorithm: str) -> dict:
    """The launch shape of a preset's tables but B and the item size.
    ``fine`` is cfgjson_fine: its W (1.46 GB) is not built here; a 12x8
    grid over the same window has its taps, ``tau_min`` and corrections,
    and the card's windows are FINE_TK taps over 29,184 directions."""
    cfg = {"tiny": Config.tiny(), "northstar": Config.northstar(),
           "reference": Config(), "fine": _fine_config()}[preset]
    small = (cfg.replace(max_res_x=12, max_res_y=8) if preset == "fine"
             else cfg)
    t = tb.make_tables(small, algorithm, cache=False, device="cpu")
    D, T, M = t.W.shape
    N = cfg.n_samples
    if preset == "fine":
        DP, TK = tf._round_up(cfg.n_directions, tf.DW), FINE_TK
    else:
        DP, TK = D, tf._window_plan(t.W, 8)[1]
    return dict(N=N, M=M, TK=TK, DP=DP, NL=tf.row_layout(t.tau_min, T, N)[1],
                JM=len(t.corr_js) * M, Tc=t.Wc.shape[2], T=T,
                tau_min=t.tau_min, D=D)


def _plan(sh: dict, B: int, isz: int, **kw) -> tf.Plan:
    return tf.plan(sh["N"], sh["M"], sh["TK"], sh["DP"], B, sh["NL"], isz,
                   sh["JM"], sh["Tc"], **kw)


def _split(sh: dict, B: int, isz: int, G: int, NS: int) -> tf.Plan:
    return tf.block_plan(sh["N"], sh["M"], sh["TK"], sh["DP"], B, sh["NL"],
                         isz, sh["JM"], sh["Tc"], G, NS)


def _staged(sh: dict, p: tf.Plan, B: int, isz: int) -> int:
    return tf.staged_bytes(p, sh["N"], sh["M"], sh["TK"], sh["DP"], B,
                           sh["NL"], isz)


@pytest.mark.parametrize("B", [1, 16])
def test_fine_plan_stages_a_frame_a_quarter_as_often(B):
    """At cfgjson_fine's launch shape the plan takes G >= 4 warp tiles a
    block: a frame's 311 KB of rows are staged a quarter as often as at
    G = 1 (the same sample split) or less.  At B = 16 the batch's staged
    bytes are at most a quarter of G = 1's too; at B = 1 the weights,
    which every split stages once, are a third of G = 4's."""
    sh = _shape("fine", "lerp")
    assert (sh["N"], sh["M"], sh["DP"], sh["NL"]) == (256, 256, 29184, 304)
    p = _plan(sh, B, 4)
    assert p.G >= 4
    one = _split(sh, B, 4, 1, p.NS)
    assert tf.stagings(one, sh["N"], sh["DP"]) == 3648
    assert tf.stagings(p, sh["N"], sh["DP"]) == -(-3648 // p.G) <= 912
    weights = B * sh["M"] * sh["TK"] * sh["DP"] * 4
    assert 4 * (_staged(sh, p, B, 4) - weights) <= (_staged(sh, one, B, 4)
                                                    - weights)
    if B == 16:
        assert 4 * _staged(sh, p, B, 4) <= _staged(sh, one, B, 4)


def test_staged_bytes_count_rows_and_weight_tiles():
    """G = 1 at cfgjson_fine, B = 16: 3,648 stagings of 256 rows of 304
    floats for each frame, and each direction's 256 x 3 weights once a
    frame: 18.2 GB and 1.43 GB."""
    sh = _shape("fine", "lerp")
    one = _split(sh, 16, 4, 1, 1)
    rows, weights = 16 * 3648 * 256 * 304 * 4, 16 * 256 * 3 * 29184 * 4
    assert _staged(sh, one, 16, 4) == rows + weights
    assert (rows, weights) == (18_169_724_928, 1_434_451_968)
    # bf16 planes stage half the bytes
    assert 2 * _staged(sh, one, 16, 2) == rows + weights


@pytest.mark.parametrize("preset", ["reference", "fine"])
@pytest.mark.parametrize("B", [1, 16, 37])
def test_model_times_the_same_fmas_and_the_staged_bytes(preset, B):
    """Every split does the same FMAs (B x DP x the covered samples x M x
    TK): the model's FMA time is at least their time at FMA_SHARE of the
    peak, its staging the staged bytes at L2_RATE, its rounds a whole
    number of stage rounds, and its total the longer of the first two
    plus the rounds."""
    sh = _shape(preset, "lerp")
    for NS in tf.sample_splits(sh["N"]):
        for G in range(1, tf.MAX_WARPS // NS + 1):
            p = _split(sh, B, 4, G, NS)
            fmas = (B * sh["DP"] * tf.sample_cover(sh["N"], NS, p.NI)
                    * sh["M"] * sh["TK"])
            t = tf.model_times(p, sh["N"], sh["M"], sh["TK"], sh["DP"], B,
                               sh["NL"], 4)
            assert t.fma >= 2 * fmas / (tf.FMA_PEAK * tf.FMA_SHARE) * (
                1 - 1e-12)
            assert t.stage == pytest.approx(_staged(sh, p, B, 4)
                                            / tf.L2_RATE)
            n = t.rounds / tf.ROUND_S
            assert n == pytest.approx(round(n)) and round(n) % (
                -(-sh["M"] // p.MG)) == 0
            assert t.total == max(t.fma, t.stage) + t.rounds


def test_model_idles_schedulers_for_blocks_of_3_5_6_7_warps():
    """A wave of two blocks of 6 warps keeps a scheduler as busy as two
    blocks of 8 (each takes an aligned run of 8 warp slots); blocks of 4
    and 8 warps fill all four schedulers evenly."""
    sh = _shape("fine", "lerp")
    t = {G: tf.model_times(_split(sh, 16, 4, G, 1)._replace(
        bps=2, blocks=2 * tf.SMS), sh["N"], sh["M"], sh["TK"], sh["DP"],
        16, sh["NL"], 4).fma for G in (4, 6, 8)}
    assert t[6] == t[8] == 2 * t[4]


# (preset, algorithm, item size, B) -> the plan's (G, NS, MG) where
# scripts/profile_time_power.py --sweep timed every split (PERF.md
# section 7): the sweep's fastest split, or one within 3% of it, but at
# reference hybrid f32 B=16, where the correction list's prologue (not in
# the launch's shape) makes 2x1/MG4 the fastest
SWEPT = {
    ("reference", "lerp", 4, 1): (1, 4, 16),
    ("reference", "lerp", 4, 16): (4, 1, 8),
    ("reference", "lerp", 2, 1): (1, 4, 16),
    ("reference", "lerp", 2, 16): (4, 1, 16),
    ("reference", "hybrid", 4, 1): (1, 4, 16),
    ("reference", "hybrid", 4, 16): (4, 1, 8),
    ("reference", "hybrid", 2, 1): (1, 4, 16),
    ("reference", "hybrid", 2, 16): (4, 1, 16),
    ("fine", "lerp", 4, 1): (4, 1, 8),
    ("fine", "lerp", 4, 16): (8, 1, 16),
}


@pytest.mark.parametrize("key", sorted(SWEPT), ids=str)
def test_plan_at_the_swept_shapes(key):
    preset, algorithm, isz, B = key
    p = _plan(_shape(preset, algorithm), B, isz)
    assert (p.G, p.NS, p.MG) == SWEPT[key]


@pytest.mark.parametrize("preset", ["tiny", "northstar", "reference"])
@pytest.mark.parametrize("algorithm", ["lerp", "hybrid"])
@pytest.mark.parametrize("B", [1, 3, 16, 37])
def test_plan_is_a_block_plan_within_the_kernels_limits(preset, algorithm,
                                                        B):
    """At every preset, algorithm and batch of the stages, at every
    direction tile and plane width, the plan is one of ``block_plan``'s
    splits and keeps every shared-memory and warp limit of the kernel."""
    sh = _shape(preset, algorithm)
    splits = tf.sample_splits(sh["N"])
    for tile_d in tf.TILE_DS:
        DP = tf._round_up(sh["D"], tile_d)
        for isz in (4, 2):
            p = tf.plan(sh["N"], sh["M"], sh["TK"], DP, B, sh["NL"], isz,
                        sh["JM"], sh["Tc"])
            assert p.NS in splits and p.NI == splits[p.NS]
            assert p == tf.block_plan(sh["N"], sh["M"], sh["TK"], DP, B,
                                      sh["NL"], isz, sh["JM"], sh["Tc"],
                                      p.G, p.NS)
            assert 1 <= p.G * p.NS <= tf.MAX_WARPS
            assert p.smem <= tf.SMEM_MAX and 1 <= p.MG <= sh["M"]
            assert p.bps * (p.smem + tf.BLOCK_RESERVED) <= tf.SM_SHARED
            assert 1 <= p.bps and p.bps * p.G * p.NS <= tf.WARPS_PER_SM
            assert p.blocks == B * -(-(DP // tf.DW) // p.G)


def test_plan_is_a_pure_function_of_the_shape():
    """Memoized on its arguments: the same shape gives the same object,
    and another SM count may give another plan but never raises."""
    sh = _shape("fine", "lerp")
    a = _plan(sh, 16, 4)
    assert _plan(sh, 16, 4) is a
    assert _plan(sh, 16, 4, sms=tf.SMS) is not None
    for sms in (1, 78, 114, 132, 264):
        p = _plan(sh, 16, 4, sms=sms)
        assert p == _split(sh, 16, 4, p.G, p.NS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fine_plan_maps_equal_the_one_tile_split_bit_for_bit(cuda,
                                                             monkeypatch):
    """cfgjson_fine's tables on the card (lerp at high, 29,184
    directions), 16 frames through ``FusedBeamformer``: the launch takes
    the plan's split, which ``report()`` names; its maps equal bit for
    bit those of the one-tile split at the same NS (G and MG leave the
    order of a direction's sums as it is), and both lie within TIME_RTOL
    of the plain version."""
    B = 16
    sh = _shape("fine", "lerp")
    fb = tf.FusedBeamformer(tb.make_tables(_fine_config(), "lerp",
                                           cache=False, device=cuda))
    assert (fb.N, fb.M, fb.TK, fb.DP, fb.NL, fb.JM, fb.Tc) == tuple(
        sh[k] for k in ("N", "M", "TK", "DP", "NL", "JM", "Tc"))
    rng = np.random.default_rng(2 ** 31 + 26)
    x = torch.from_numpy((rng.standard_normal((B, fb.M, fb.N)) * 0.1)
                         .astype(np.float32)).to(cuda)
    maps = fb(x)
    p = fb.launch_plan(B)
    assert p.G >= 4 and fb.last_plan == p
    rep = fb.report()
    assert {k: rep[k] for k in ("G", "NS", "MG", "stagings")} == {
        "G": p.G, "NS": p.NS, "MG": p.MG, "stagings": -(-3648 // p.G)}
    s, sj = fb.kernel_inputs(x)
    args = (s, fb.Wp, fb.bases, sj, fb.wc)
    planned = tf.fused_power(*args, **fb.kernel_kw)
    one = _split(sh, B, 4, 1, p.NS)
    monkeypatch.setattr(tf, "plan", lambda *a: one)
    single = tf.fused_power(*args, **fb.kernel_kw)
    torch.cuda.synchronize()
    assert torch.equal(planned, single)
    assert torch.equal(maps, planned[:, :fb.D].reshape(B, fb.res_x,
                                                       fb.res_y))
    plain = tf.fused_power_plain(*args, **fb.kernel_kw).cpu().numpy()
    for got in (planned, single):
        np.testing.assert_allclose(got.cpu().numpy(), plain,
                                   rtol=TIME_RTOL, atol=1e-14)
