"""The MVDR route's quadratic form kernel (``ops/quad_form_kernel.py``,
``csrc/quad_form.cu``).

On the CPU: the plain version (the Hermitian half-sum over 32-mic tiles)
against the eager form ``Re(vecdot(ph, conj(P) ph))``, the wrapper's
checks and the limits it shares with the kernel's source, the routing
rule of ``freq._quad_form``, and the stream's launch counter.  On the card
(marker ``cuda``; skips where ``torch.cuda.is_available()`` is False, the
kernel has no CPU mode): the kernel against the complex128 form at the
MVDR cell's shape, at ``Config()``'s 256 mics and at ragged shapes,
bitwise repeats, the launch counter against the stream's quadratic
forms, and the stream's maps against the benchmark's float64 reference.
No UDP, no JAX::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_quad_form.py
"""

import math
import os
import re

import numpy as np
import pytest
import torch

from zybo_rt_sampler_image_detection_torch.apps import pipeline
from zybo_rt_sampler_image_detection_torch.config import Config
from zybo_rt_sampler_image_detection_torch.ops import bartlett_kernel as bk
from zybo_rt_sampler_image_detection_torch.ops import freq
from zybo_rt_sampler_image_detection_torch.ops import quad_form_kernel as qk

# two 4x4 board slots, the second unconnected and listed as unused
# (tests/test_torch_mvdr_route.py): the covariance spans 16 mics
SMALL = Config.tiny().replace(n_microphones=32, array_slots=2,
                              unused_mics=tuple(range(16, 32)))
K = 16
# the MVDR cell's configuration: Config() with its fourth board unused
CELL = Config(unused_mics=tuple(range(192, 256)))
U32 = 2.0 ** -24                    # FP32 unit roundoff


def _eager(P, ph):
    """The form as the eager route computes it."""
    return torch.linalg.vecdot(ph, torch.matmul(P.conj(), ph), dim=1).real


def _inputs(F, M, D, kind, seed, device="cpu", dtype=torch.complex128):
    """``(P, phase)``: unit-modulus steering, and P the inverse of a loaded
    covariance of M + 8 snapshots ("hermitian") or a general complex
    matrix ("general")."""
    g = torch.Generator(device=device).manual_seed(seed)
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    ph = torch.polar(torch.ones((F, M, D), dtype=real, device=device),
                     2 * math.pi * torch.rand((F, M, D), dtype=real,
                                              device=device, generator=g))
    if kind == "general":
        return torch.randn((F, M, M), dtype=dtype, device=device,
                           generator=g), ph
    X = torch.randn((F, M, M + 8), dtype=dtype, device=device, generator=g)
    R = X @ X.mH / (M + 8)
    load = 1e-3 * R.diagonal(dim1=-2, dim2=-1).real.sum(-1) / M
    R = R + load[:, None, None] * torch.eye(M, dtype=dtype, device=device)
    return freq.invert_hermitian(R), ph


def _kernel(P, ph):
    """The wrapper on the tensor's tile layout, as the route calls it."""
    return qk.hermitian_quad_form(P, bk.make_phase_tiles(ph), D=ph.shape[2])


def _excess(got, P, ph):
    """The largest ``|d - d128|`` over its FP32 bound ``4 (M + 64) u
    |ph|^T |P| |ph|``: the rounding of a sum of products is at most the
    sum's length times the unit roundoff times the sum of the |terms|
    (Higham, Accuracy and Stability of Numerical Algorithms, sec. 3.1);
    here each entry sums at most M columns of a row of tiles, a 32-row
    fold, the rows of tiles and 8 warps' partial sums (M + 64 > M + 32 +
    8 + 8), and a complex product adds at most 4x.  A missing, doubled or
    misplaced tile is off by whole terms, orders of magnitude above."""
    P64, ph64 = P.to(torch.complex128), ph.to(torch.complex128)
    truth = _eager(P64, ph64)
    mag = (ph64.abs() * torch.matmul(P64.abs(), ph64.abs())).sum(dim=1)
    M = P.shape[-1]
    return ((got.double() - truth).abs()
            / (4 * (M + 64) * U32 * mag)).max().item()


# ---- the plain version and the wrapper on the CPU ---------------------------

@pytest.mark.parametrize("kind", ["hermitian", "general"])
@pytest.mark.parametrize("F,M,D", [(3, 5, 3), (2, 32, 64), (3, 40, 65),
                                   (2, 70, 130), (1, 33, 1), (2, 96, 17)])
def test_plain_half_sum_is_the_full_form_in_complex128(F, M, D, kind):
    """The half-sum over P's two triangles is ``Re(a^H P a)`` of the P it
    is given, Hermitian or not, at M and D on and off the tiles."""
    P, ph = _inputs(F, M, D, kind, seed=M * 1000 + D)
    got = qk.hermitian_quad_form_plain(P, ph)
    want = _eager(P, ph)
    assert got.dtype == torch.float64 and got.shape == (F, D)
    torch.testing.assert_close(got, want, rtol=1e-11,
                               atol=1e-12 * want.abs().max().item())


@pytest.mark.parametrize("F,M,D", [(3, 40, 65), (2, 70, 130), (2, 96, 17)])
def test_plain_half_sum_in_complex64_within_its_fp32_bound(F, M, D):
    """In complex64 the half-sum and the eager form are both inside the
    FP32 rounding bound of the complex128 form (``_excess``)."""
    P, ph = _inputs(F, M, D, "hermitian", seed=7 + M,
                    dtype=torch.complex64)
    got = qk.hermitian_quad_form_plain(P, ph)
    assert got.dtype == torch.float32
    assert _excess(got, P, ph) <= 1.0
    assert _excess(_eager(P, ph), P, ph) <= 1.0


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_plain_half_sum_of_a_woodbury_advanced_precision(dtype):
    """P advanced by Woodbury steps (``update_precision_block``) is
    Hermitian only up to rounding; the half-sum over ``(P + P^H) / 2`` is
    the same quantity as the eager form of that P, to rounding."""
    t = freq.make_freq_tables(SMALL, 100.0, device="cpu")
    rng = np.random.default_rng(2 ** 31 + 41)
    st = freq.init_precision(t, dtype=dtype)
    real = np.float64 if dtype == torch.complex128 else np.float32
    for _ in range(3):
        x = rng.standard_normal((K, SMALL.n_microphones,
                                 SMALL.n_samples)).astype(real)
        st = freq.update_precision_block(st, torch.from_numpy(x), t)
    P = st.P
    assert (P - P.mH).abs().max() > 0          # Hermitian to rounding only
    ph = freq._phase(t, dtype)
    got = qk.hermitian_quad_form_plain(P, ph)
    want = _eager(P, ph)
    if dtype == torch.complex128:
        torch.testing.assert_close(got, want, rtol=1e-11, atol=0.0)
    else:
        assert _excess(got, P, ph) <= 1.0
        assert _excess(want, P, ph) <= 1.0


@pytest.mark.parametrize("D", [65, 193, 1824])
def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing(D):
    """On CPU tensors the wrapper reads the tensor back out of its tile
    layout (chunks of up to 192 directions, zero past D) and runs the
    plain version."""
    P, ph = _inputs(2, 40, D, "hermitian", seed=3)
    before = qk.hermitian_quad_form.launches
    got = _kernel(P, ph)
    assert qk.hermitian_quad_form.launches == before
    torch.testing.assert_close(got, qk.hermitian_quad_form_plain(P, ph),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shapes", [((2, 5, 5), (1, 2, 6, 16), 7),
                                    ((2, 5, 5), (1, 3, 5, 16), 7),
                                    ((2, 5, 4), (1, 2, 5, 16), 7),
                                    ((5, 5), (1, 2, 5, 16), 7),
                                    ((2, 5, 5), (2, 5, 16), 7),
                                    ((2, 5, 5), (1, 2, 5, 16), 17),
                                    ((2, 5, 5), (2, 2, 5, 16), 7)])
def test_wrapper_refuses_shapes_that_do_not_match(shapes):
    p, t, D = shapes
    with pytest.raises(ValueError, match="hermitian_quad_form:"):
        qk.hermitian_quad_form(torch.zeros(p, dtype=torch.complex64),
                               torch.zeros(t, dtype=torch.complex64), D=D)


@pytest.mark.parametrize("limit", ["tile", "directions", "mics"])
def test_the_wrapper_shares_the_kernels_limits(limit):
    src = open(os.path.join(os.path.dirname(qk.__file__), "csrc",
                            "quad_form.cu")).read()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (\w+) = (\d+);", src)}
    if limit == "tile":
        assert const["TM"] == qk.TM
    elif limit == "directions":
        assert const["DT"] == qk.DT
    else:
        assert "M > MAX_TILES * TM" in src
        assert const["MAX_TILES"] * const["TM"] == qk.MAX_MICS


# ---- the routing rule ------------------------------------------------------

@pytest.mark.parametrize("device,dtype,precision,kernel", [
    ("cuda", torch.complex64, "highest", True),
    ("cuda", torch.complex64, "high", True),
    ("cuda", torch.complex64, "default", False),
    ("cuda", torch.complex128, "highest", False),
    ("cuda", torch.complex128, "high", False),
    ("cpu", torch.complex64, "highest", False),
    ("cpu", torch.complex64, "high", False),
    ("cpu", torch.complex128, "highest", False),
])
def test_routing_rule(device, dtype, precision, kernel):
    assert freq.takes_quad_form_kernel(dtype, device, precision) is kernel


def _state(cfg, dtype=torch.complex64):
    t = freq.make_freq_tables(cfg, 100.0, device="cpu")
    rng = np.random.default_rng(2 ** 31 + 43)
    x = rng.standard_normal((K, cfg.n_microphones, cfg.n_samples))
    real = np.float64 if dtype == torch.complex128 else np.float32
    st = freq.update_precision_block(freq.init_precision(t, dtype=dtype),
                                     torch.from_numpy(x.astype(real)), t)
    return t, st


@pytest.mark.parametrize("case", ["cpu", "complex128", "default"])
def test_eager_routes_never_take_the_kernel(case, monkeypatch):
    """CPU tensors, complex128 and the ``default`` rung run the eager
    code: the kernel's wrapper is never called."""
    called = []
    monkeypatch.setattr(qk, "hermitian_quad_form",
                        lambda *a, **k: called.append(a))
    cfg = SMALL.replace(matmul_precision="default") if case == "default" \
        else SMALL
    t, st = _state(cfg, torch.complex128 if case == "complex128"
                   else torch.complex64)
    d = freq.mvdr_d0(st, t)
    assert d.shape == t.phase.shape[::2] and not called


def test_kernel_route_plumbing_on_cpu(monkeypatch):
    """With the rule forced on CPU tensors (the wrapper then runs its
    plain version), every caller of the form hands the wrapper P and the
    tables' steering tensor: ``mvdr_d0``, ``mvdr_power_precision`` and
    ``mvdr_power``; each result within FP32 rounding of the eager one."""
    calls = []
    wrapper = qk.hermitian_quad_form

    def spy(P, tiles, D):
        calls.append((tiles, D))
        return wrapper(P, tiles, D=D)

    t, st = _state(SMALL)
    cov = freq.update_covariance(freq.init_covariance(t), torch.zeros(
        2, SMALL.n_microphones, SMALL.n_samples) + 0.1, t)
    runs = {"d0": lambda: freq.mvdr_d0(st, t),
            "power_precision": lambda: freq.mvdr_power_precision(st, t),
            "power": lambda: freq.mvdr_power(cov, t)}
    want = {k: f() for k, f in runs.items()}
    monkeypatch.setattr(qk, "hermitian_quad_form", spy)
    monkeypatch.setattr(freq, "takes_quad_form_kernel", lambda *a: True)
    for k, f in runs.items():
        got = f()
        (tiles, D), = calls
        calls.clear()
        assert tiles is t.phase_tiles and D == t.phase.shape[2], k
        torch.testing.assert_close(got, want[k], rtol=2e-4, atol=0.0)


# ---- the stream's counter --------------------------------------------------

def _stream_frames(cfg, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, cfg.n_microphones, cfg.n_samples))
    return torch.from_numpy((0.1 * x).astype(np.float32))


def test_stream_counts_no_kernel_launch_on_the_cpu():
    fn = pipeline.make_mvdr_stream(SMALL, "maps", device="cpu")
    fn.reset()
    before = qk.hermitian_quad_form.launches
    x = _stream_frames(SMALL, 8 * K, 2 ** 31 + 44)
    for i in range(0, len(x), K):
        fn(x[i:i + K])
    fn(x[0])
    assert fn.counts["quad_forms"] == 5
    assert fn.counts["quad_form_launches"] == 0
    assert qk.hermitian_quad_form.launches == before


def test_stream_counts_each_launch_of_the_kernel(monkeypatch):
    """With the rule forced and a stand-in kernel that counts its calls,
    the stream's ``quad_form_launches`` follows ``quad_forms`` (batches and
    the live frame), and ``reset``'s up-front form is left out of both."""

    wrapper = qk.hermitian_quad_form

    def stand_in(P, tiles, D):
        stand_in.launches += 1
        return wrapper(P, tiles, D=D)

    stand_in.launches = 0
    monkeypatch.setattr(qk, "hermitian_quad_form", stand_in)
    monkeypatch.setattr(freq, "takes_quad_form_kernel", lambda *a: True)
    fn = pipeline.make_mvdr_stream(SMALL, "maps", device="cpu")
    fn.reset()
    assert stand_in.launches == 1 and fn.counts["quad_form_launches"] == 0
    x = _stream_frames(SMALL, 8 * K, 2 ** 31 + 45)
    for i in range(0, len(x), K):
        fn(x[i:i + K])
    fn(x[0])
    assert fn.counts["quad_forms"] == 5
    assert fn.counts["quad_form_launches"] == 5 == stand_in.launches - 1


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _card_inputs(name, kind, dev):
    """(P, phase) complex64 on the card: the tables of the MVDR cell
    (127 bins, 192 mics, 1,824 directions) or of ``Config()`` (256 mics),
    or unit-modulus steering of a ragged shape."""
    if name in ("cell", "config256"):
        cfg = CELL if name == "cell" else Config()
        ph = freq.make_freq_tables(cfg, 100.0, device=dev).phase
        F, M, D = ph.shape
        P, _ = _inputs(F, M, 1, kind, seed=11, device=dev,
                       dtype=torch.complex64)
        return P, ph
    F, M, D = name
    return _inputs(F, M, D, kind, seed=F * 7 + M, device=dev,
                   dtype=torch.complex64)


CARD_SHAPES = ["cell", "config256", (3, 70, 100), (2, 33, 65), (1, 1, 1),
               (4, 16, 7), (2, 255, 1825), (5, 192, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hermitian", "general"])
@pytest.mark.parametrize("name", CARD_SHAPES, ids=str)
def test_kernel_within_its_fp32_bound_of_the_complex128_form(cuda, name,
                                                             kind):
    """The kernel against the complex128 form of the same inputs, inside
    the FP32 rounding bound of ``_excess``; the cuBLAS chain it replaced
    inside the same bound; and every launch counted."""
    if kind == "general" and name in ("cell", "config256"):
        pytest.skip("the tables' shapes run with the MVDR route's P only")
    P, ph = _card_inputs(name, kind, cuda)
    before = qk.hermitian_quad_form.launches
    got = _kernel(P, ph)
    torch.cuda.synchronize()
    assert qk.hermitian_quad_form.launches == before + 1
    assert got.shape == (ph.shape[0], ph.shape[2])
    assert torch.isfinite(got).all()
    assert _excess(got, P, ph) <= 1.0
    assert _excess(_eager(P, ph), P, ph) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cell", (2, 255, 1825)], ids=str)
def test_kernel_repeats_bit_for_bit(cuda, name):
    P, ph = _card_inputs(name, "hermitian", cuda)
    tiles = bk.make_phase_tiles(ph)
    first = qk.hermitian_quad_form(P, tiles, D=ph.shape[2])
    for _ in range(3):
        assert torch.equal(qk.hermitian_quad_form(P, tiles, D=ph.shape[2]),
                           first)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    P, ph = _inputs(2, 8, 5, "hermitian", 1, cuda, torch.complex64)
    tiles = bk.make_phase_tiles(ph)
    with pytest.raises(ValueError, match="complex64"):
        qk.hermitian_quad_form(P.to(torch.complex128), tiles, D=5)
    with pytest.raises(ValueError, match="contiguous"):
        qk.hermitian_quad_form(P.mT, tiles, D=5)
    with pytest.raises(ValueError, match="one CUDA device"):
        qk.hermitian_quad_form(P, tiles.cpu(), D=5)
    big = torch.zeros((1, 257, 257), dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError, match="257 mics"):
        qk.hermitian_quad_form(big, bk.make_phase_tiles(torch.zeros(
            (1, 257, 3), dtype=torch.complex64, device=cuda)), D=3)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_launches_follow_the_streams_quadratic_forms(cuda, precision):
    """Over a stream on the card the kernel's launches are its quadratic
    forms at ``highest`` and ``high``, and none at ``default``."""
    cfg = SMALL.replace(matmul_precision=precision)
    fn = pipeline.make_mvdr_stream(cfg, "maps", device=cuda)
    fn.reset()
    before = qk.hermitian_quad_form.launches
    x = _stream_frames(cfg, 8 * K, 2 ** 31 + 46).to(cuda)
    for i in range(0, len(x), K):
        fn(x[i:i + K])
    fn(x[0])
    torch.cuda.synchronize()
    forms = fn.counts["quad_forms"]
    assert forms == 5
    kernel = qk.hermitian_quad_form.launches - before
    assert fn.counts["quad_form_launches"] == kernel
    assert kernel == (forms if precision != "default" else 0)


@pytest.mark.cuda
def test_stream_maps_match_the_float64_reference(cuda):
    """The cell's stream on the card through the kernel, 320 frames from
    its reset, against ``portbench/references/mvdr.py``: the last 256 maps
    (four refresh epochs) inside the cell's ``map_gap`` limit, 2e-3, with
    a fourth of it to spare (the sound range on the H100 is 3.8e-5 to
    1.5e-4, PERF.md section 2)."""
    from portbench import harness, signals

    root = os.path.dirname(harness.HERE)
    config = harness.load_config(root, harness.load_spec(root),
                                 "cfgjson_mvdr")
    reference = harness.load_reference("mvdr")
    driver = harness.load_driver("stream")
    map_gap = harness.load_check("map_gap").value
    cfg = harness.make_config(config)
    frames = signals.frames_f32(cfg, signals.capture(cfg, 320, 2 ** 31 + 47,
                                                     cuda))
    fn = pipeline.make_mvdr_stream(cfg, "maps", device=cuda)
    fn.reset()
    before = qk.hermitian_quad_form.launches
    maps = torch.cat([fn(frames[i:i + K]) for i in range(0, 320, K)])
    assert qk.hermitian_quad_form.launches - before == \
        fn.counts["quad_forms"] > 0
    sample = driver.StreamSample(frames.cpu().numpy(), 0, 256,
                                 dict(config["mvdr"]))
    ref = reference.maps(cfg, cuda, sample)
    gap = map_gap(maps[64:].cpu().numpy(), ref)
    assert gap < config["limits"]["map_gap"] / 4, gap
