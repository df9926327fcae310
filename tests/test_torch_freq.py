"""The port's ``ops/freq.py`` (Bartlett, covariance MVDR, the streaming
inverse) against the JAX package, its NumPy oracles and float64 / complex128
ground truths, at the gates of ``tests/test_freq.py`` and
``tests/test_golden.py`` (quoted beside each).  Inputs are seeded NumPy
frames at ``Config.tiny()``; the golden rows and the table equality also
run at the reference shape.  No UDP."""

import os

import numpy as np
import pytest
import torch

import zybo_rt_sampler_image_detection_tpu as zj
from zybo_rt_sampler_image_detection_tpu.ops import freq as jf
from zybo_rt_sampler_image_detection_tpu.ops import oracle
from zybo_rt_sampler_image_detection_torch.config import Config
from zybo_rt_sampler_image_detection_torch.ops import freq, geometry

torch.set_num_threads(2)

FFT_GATE = dict(rtol=2e-4, atol=1e-6)           # test_freq.py:25
NORM_GATE = dict(rtol=1e-3, atol=1e-5)          # test_freq.py:37
FFT_REF_E2E_GATE = dict(rtol=2e-3, atol=1e-5)   # test_freq.py:207
PEAK_GATE = dict(rtol=1e-5, atol=1e-7)          # test_freq.py:225
COV_GATE = dict(rtol=2e-4, atol=1e-6)           # test_freq.py:154
SOLVE_GATE = dict(rtol=2e-3, atol=2e-4)         # test_freq.py:286,306
PREC_GATE = dict(rtol=5e-3, atol=5e-4)          # test_freq.py:348
BLOCK_GATE = dict(rtol=1e-4, atol=1e-5)         # test_freq.py:368-395
MAPS_GATE = dict(rtol=1e-3, atol=1e-6)          # test_freq.py:413,438
BEAM_GATE = dict(rtol=1e-3, atol=1e-5)          # test_freq.py:683
LISTEN_GATE = dict(rtol=1e-5, atol=1e-8)        # test_freq.py:699-703
SCALE_GATE = dict(rtol=5e-3, atol=5e-4)         # test_mvdr_stream.py:53-55
GOLDEN_RTOL = 1e-5                              # test_golden.py:29
DRIFT_GATE = 0.05                               # test_freq.py:570
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _jcfg(cfg):
    return zj.Config(**{f: getattr(cfg, f) for f in
                        cfg.__dataclass_fields__})


def _tables(cfg, *band):
    """The port's tables and the JAX package's, same config and band."""
    return (freq.make_freq_tables(cfg, *band, device="cpu"),
            jf.make_freq_tables(_jcfg(cfg), *band))


def synth_frame(cfg, rng, f0=8000.0, noise=0.3):
    """``conftest.synth_frame``: a tone on every mic plus per-mic noise."""
    t = np.arange(cfg.n_samples) / cfg.sample_rate
    frame = np.tile(np.sin(2 * np.pi * f0 * t).astype(np.float32),
                    (cfg.n_microphones, 1))
    if noise:
        frame = frame + noise * rng.standard_normal(
            (cfg.n_microphones, cfg.n_samples)).astype(np.float32)
    return frame.astype(np.float32)


def _frames(cfg, n, seed, f0=8000.0, step=0.0):
    rng = np.random.default_rng(seed)
    return np.stack([synth_frame(cfg, rng, f0 + step * i)
                     for i in range(n)])


def _delayed_source_frame(cfg, tx, ty, seed=11):
    """Frame containing a wideband source at grid cell (tx, ty)."""
    rng = np.random.default_rng(seed)
    delays = geometry.calculate_delays(cfg)
    active, _ = geometry.active_microphones(cfg)
    base = rng.standard_normal(cfg.n_samples * 3).astype(np.float32)
    frame = np.zeros((cfg.n_microphones, cfg.n_samples), np.float32)
    lag = (delays[tx, ty].max() - delays[tx, ty]).round().astype(int)
    for i, m in enumerate(active):
        s = cfg.n_samples - lag[i]
        frame[m] = base[s:s + cfg.n_samples]
    return frame


def _c(re, im):
    return np.asarray(re, np.float64) + 1j * np.asarray(im, np.float64)


def _np(x):
    return x.detach().cpu().numpy()


def _peak(img):
    return np.unravel_index(np.asarray(img).argmax(), np.asarray(img).shape)


# -- tables ------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["tiny", "default", "fft_reference"])
def test_tables_equal_jax(preset):
    """The steering tensor, the mic gather and the band, byte for byte:
    ``Config()`` at the MVDR stream's band (100 Hz to Nyquist: F = 127,
    M = 256, D = 1824), the fft profile at its own band."""
    cfg = {"tiny": Config.tiny, "default": Config,
           "fft_reference": Config.fft_reference}[preset]()
    band = () if preset == "fft_reference" else (100.0,)
    t, jt = _tables(cfg, *band)
    assert t.phase.dtype == torch.complex64 and t.device.type == "cpu"
    np.testing.assert_array_equal(_np(t.phase.real), np.asarray(jt.phase_re))
    np.testing.assert_array_equal(_np(t.phase.imag), np.asarray(jt.phase_im))
    np.testing.assert_array_equal(_np(t.adaptive), np.asarray(jt.adaptive))
    assert (t.lo, t.hi, t.res_x, t.res_y, t.n_samples) == \
        (jt.lo, jt.hi, jt.res_x, jt.res_y, jt.n_samples)
    if preset == "default":
        assert t.phase.shape == (127, 256, 1824)


def test_tables_from_numpy_and_device():
    cfg = Config.tiny()
    _, jt = _tables(cfg, 2000.0, 20000.0)
    t = freq.FreqTables.from_numpy(
        jt.phase_re, jt.phase_im, jt.adaptive, lo=jt.lo, hi=jt.hi,
        res_x=jt.res_x, res_y=jt.res_y, n_samples=jt.n_samples,
        device="cpu")
    np.testing.assert_array_equal(_np(t.phase.imag), np.asarray(jt.phase_im))
    assert t.adaptive.dtype == torch.int64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            freq.make_freq_tables(cfg)


# -- Bartlett ------------------------------------------------------------------

def test_fft_power_matches_oracle_and_jax():
    cfg = Config.tiny()
    frame = _frames(cfg, 1, seed=3)[0]
    t, jt = _tables(cfg, 100.0, 20000.0)
    phase, (lo, hi) = geometry.phase_shift_tensor(cfg, 100.0, 20000.0)
    active, _ = geometry.active_microphones(cfg)
    fft = np.fft.rfft(frame[active, :].T, axis=0)[lo:hi, :]
    want = (np.abs((fft[:, :, None, None] * phase).sum(axis=1)) ** 2).sum(0)
    got = freq.fft_steered_power(frame, t)
    assert got.shape == (cfg.max_res_x, cfg.max_res_y)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, **FFT_GATE)
    np.testing.assert_allclose(
        _np(got), np.asarray(jf.fft_steered_power(frame, jt)), **FFT_GATE)
    # a batch, and float64 frames through the same code in complex128
    frames = _frames(cfg, 3, seed=4)
    got = freq.fft_steered_power(torch.from_numpy(frames), t)
    np.testing.assert_allclose(
        _np(got), np.asarray(jf.fft_steered_power(frames, jt)), **FFT_GATE)
    g64 = freq.fft_steered_power(frames.astype(np.float64), t)
    assert g64.dtype == torch.float64
    np.testing.assert_allclose(_np(got), _np(g64), **FFT_GATE)


def test_fft_bin_weights():
    """Zero weights drop their bins from the sum, whatever the path."""
    cfg = Config.tiny()
    t, _ = _tables(cfg, 2000.0, 20000.0)
    frames = _frames(cfg, 2, seed=5)
    F = t.hi - t.lo
    w = torch.ones(F)
    w[F // 2:] = 0.0
    spec = freq.fft_power_spectrum(frames, t)                 # (B, F, X, Y)
    np.testing.assert_allclose(
        _np(freq.fft_steered_power(frames, t, bin_weights=w)),
        _np(spec[:, :F // 2].sum(1)), rtol=1e-5, atol=1e-9)
    st = freq.init_precision(t)
    st = freq.update_precision_block(st, frames, t)
    d = freq.mvdr_d0(st, t)
    np.testing.assert_allclose(
        _np(freq.mvdr_power_precision(st, t, bin_weights=w)),
        _np((1.0 / d[:F // 2]).sum(0).reshape(t.res_x, t.res_y)),
        rtol=1e-5, atol=1e-9)
    m_w, _ = freq.mvdr_maps_scan(st, frames, t, bin_weights=w)
    m_all, _ = freq.mvdr_maps_scan(st, frames, t)
    assert (_np(m_w) < _np(m_all)).all()


def test_golden_tiny_fft():
    """The tiny golden ``fft`` row (``test_golden.py:33-44``)."""
    golden = np.load(os.path.join(GOLDEN_DIR, "tiny_heatmaps.npz"))
    t, _ = _tables(Config.tiny(), 100.0, 20000.0)
    ref = golden["fft"]
    np.testing.assert_allclose(
        _np(freq.fft_steered_power(golden["frame"], t)), ref,
        rtol=GOLDEN_RTOL, atol=1e-9 * max(ref.max(), 1.0))


@pytest.mark.parametrize("row", ["fft", "fft_reference_profile"])
def test_golden_reference_shape(row):
    """The reference-shape golden rows (``test_golden.py:57-86``):
    ``Config()`` at 100-20000 Hz and the shipped web backend-3 profile."""
    golden = np.load(os.path.join(GOLDEN_DIR, "reference_heatmaps.npz"))
    if row == "fft":
        t = freq.make_freq_tables(Config(), 100.0, 20000.0, device="cpu")
    else:
        t = freq.make_freq_tables(Config.fft_reference(), device="cpu")
    ref = golden[row]
    np.testing.assert_allclose(
        _np(freq.fft_steered_power(golden["frame"], t)), ref,
        rtol=GOLDEN_RTOL, atol=1e-9 * max(ref.max(), 1.0))


def test_normalize_matches_reference():
    cfg = Config.tiny()
    frame = _frames(cfg, 1, seed=6)[0]
    t, _ = _tables(cfg, 100.0, 20000.0)
    phase, (lo, hi) = geometry.phase_shift_tensor(cfg, 100.0, 20000.0)
    active, _ = geometry.active_microphones(cfg)
    ref = oracle.fft_mimo(frame[active, :].T.astype(np.float64), phase,
                          lo, hi)
    got = freq.normalize_heatmap(freq.fft_steered_power(frame, t))
    np.testing.assert_allclose(_np(got), ref, **NORM_GATE)
    low = freq.normalize_heatmap(torch.full((3, 2), 0.1))
    assert (low == 0).all()


def test_fft_reference_backend_e2e():
    """Web backend-3 parity on the shipped config (``test_freq.py:196``)."""
    cfg = Config.fft_reference()
    rng = np.random.default_rng(33)
    frame = (rng.standard_normal(
        (cfg.n_microphones, cfg.n_samples)) * 0.3).astype(np.float32)
    t = freq.make_freq_tables(cfg, device="cpu")
    ref_phase, (lo, hi) = oracle.fft_phase_shift(_jcfg(cfg))
    ref = oracle.fft_mimo(frame.T.astype(np.float64), ref_phase, lo, hi)
    got = freq.normalize_heatmap(freq.fft_steered_power(frame, t))
    np.testing.assert_allclose(_np(got), ref, **FFT_REF_E2E_GATE)


def test_fft_broadside_peak():
    cfg = Config.tiny()
    f = synth_frame(cfg, None, noise=0.0)
    t, _ = _tables(cfg, 4000.0, 20000.0)
    x, y = _peak(_np(freq.fft_steered_power(f, t)))
    assert abs(x - (cfg.max_res_x - 1) / 2) <= 1
    assert abs(y - (cfg.max_res_y - 1) / 2) <= 1


@pytest.mark.parametrize("band", [(0.0, None), (2000.0, 20000.0)])
def test_peak_detection_matches_oracle(band):
    """Including the double slice by the lower band index (band[0] > 0)
    and the first-occurrence argmax."""
    cfg = Config.tiny()
    t, jt = _tables(cfg, *band)
    rng = np.random.default_rng(44)
    for _ in range(3):
        frame = (rng.standard_normal(
            (cfg.n_microphones, cfg.n_samples)) * 0.2).astype(np.float32)
        power_f = freq.fft_power_spectrum(frame, t)
        np.testing.assert_allclose(
            _np(power_f), np.asarray(jf.fft_power_spectrum(frame, jt)),
            **FFT_GATE)
        ref = oracle.fft_peak_detection(
            _np(power_f).astype(np.float64), 0.8, 0.1, t.lo,
            cfg.max_res_x, cfg.max_res_y)
        got = freq.peak_detection(power_f, t)
        np.testing.assert_allclose(_np(got), ref, **PEAK_GATE)
        np.testing.assert_allclose(
            _np(got), np.asarray(jf.peak_detection(_np(power_f), jt)),
            **PEAK_GATE)
    # ties go to the first cell, as C's argmax
    flat = torch.zeros(t.hi - t.lo + t.lo, cfg.max_res_x * cfg.max_res_y)
    flat[:, [5, 9]] = 1.0
    got = freq.peak_detection(flat.reshape(-1, cfg.max_res_x,
                                           cfg.max_res_y), t)
    assert _np(got).reshape(-1)[5] == 1.0 and _np(got).reshape(-1)[9] == 0


def test_peak_detection_threshold_gates():
    cfg = Config.tiny()
    t, _ = _tables(cfg, 0.0, None)
    power_f = torch.full((t.hi - t.lo, cfg.max_res_x, cfg.max_res_y), 1e-6)
    assert (freq.peak_detection(power_f, t, 0.8, 0.1) == 0).all()


# -- covariance MVDR ---------------------------------------------------------

def test_update_covariance_matches_jax_and_batch_mean():
    cfg = Config.tiny()
    t, jt = _tables(cfg, 100.0, 20000.0)
    frames = _frames(cfg, 3, seed=7)
    st = freq.update_covariance(freq.init_covariance(t), frames, t)
    jst = jf.update_covariance(jf.init_covariance(jt), frames, jt)
    assert st.count == 1 and st.R.dtype == torch.complex64
    np.testing.assert_allclose(_np(st.R), _c(jst.R_re, jst.R_im),
                               **COV_GATE)
    singles = [freq.update_covariance(freq.init_covariance(t), f, t)
               for f in frames]
    np.testing.assert_allclose(
        _np(st.R), np.mean([_np(s.R) for s in singles], axis=0), **COV_GATE)
    # the EMA step after the first-frame replacement
    st2 = freq.update_covariance(st, frames[:1], t, alpha=0.8)
    jst2 = jf.update_covariance(jst, frames[:1], jt, alpha=0.8)
    np.testing.assert_allclose(_np(st2.R), _c(jst2.R_re, jst2.R_im),
                               **COV_GATE)


def test_solve_hermitian_matches_numpy():
    rng = np.random.default_rng(8)
    F, M, K = 3, 6, 2
    A = rng.standard_normal((F, M, M)) + 1j * rng.standard_normal((F, M, M))
    R = A @ A.conj().transpose(0, 2, 1) + 0.1 * np.eye(M)
    b = rng.standard_normal((F, M, K)) + 1j * rng.standard_normal((F, M, K))
    got = freq._solve_hermitian(torch.from_numpy(R.astype(np.complex64)),
                                torch.from_numpy(b.astype(np.complex64)))
    np.testing.assert_allclose(_np(got), np.linalg.solve(R, b), **SOLVE_GATE)


def test_invert_hermitian_matches_numpy():
    rng = np.random.default_rng(42)
    for F, M in [(3, 32), (2, 7), (1, 16)]:
        A = (rng.standard_normal((F, M, M))
             + 1j * rng.standard_normal((F, M, M)))
        R = A @ A.conj().transpose(0, 2, 1) + 0.5 * np.eye(M)
        got = _np(freq.invert_hermitian(
            torch.from_numpy(R.astype(np.complex64))))
        np.testing.assert_allclose(got, np.linalg.inv(R), **SOLVE_GATE)
        np.testing.assert_allclose(got, got.conj().transpose(0, 2, 1),
                                   atol=1e-4)


def test_invert_hermitian_ill_conditioned():
    """``test_freq.py:724-743``: a rank-deficient-ish covariance, within 5e-5
    of the float64 inverse's scale."""
    rng = np.random.default_rng(9)
    F, M = 3, 48
    C = (rng.standard_normal((F, M, 2 * M))
         + 1j * rng.standard_normal((F, M, 2 * M)))
    R = np.einsum("fmk,fnk->fmn", C, C.conj()) / (2 * M) + 0.05 * np.eye(M)
    P = _np(freq.invert_hermitian(torch.from_numpy(R.astype(np.complex64))))
    truth = np.linalg.inv(R)
    assert abs(P - truth).max() / abs(truth).max() < 5e-5


def test_cholesky_info_zero_on_loaded_covariance():
    """The hot path never reads ``cholesky_ex``'s ``info``; the loaded
    covariances it factors must all be positive definite — also right
    after a zero-frame warm-up (R = 1e-12 I) and on a coherent single
    source at alpha -> 1."""
    cfg = Config.tiny()
    t, _ = _tables(cfg, 2000.0, 20000.0)
    st = freq.init_precision(t)
    zero = np.zeros((4, cfg.n_microphones, cfg.n_samples), np.float32)
    warm = freq.update_precision_block(st, zero, t)
    frame = _delayed_source_frame(cfg, 6, 2, seed=77)
    cov = freq.init_covariance(t)
    for _ in range(8):
        cov = freq.update_covariance(cov, frame, t, alpha=0.999)
    for R in (freq._loaded(warm.cov, warm.load), freq._loaded(cov, 1e-3)):
        _, info = torch.linalg.cholesky_ex(R)
        assert (info == 0).all()
    # a matrix that is not positive definite: NaN-free info, no raise
    _, info = torch.linalg.cholesky_ex(-torch.eye(3, dtype=torch.complex64))
    assert info.item() > 0


def test_mvdr_power_matches_jax():
    cfg = Config.tiny()
    t, jt = _tables(cfg, 2000.0, 20000.0)
    frames = np.stack([_delayed_source_frame(cfg, 4, 3, seed=30 + s)
                       for s in range(6)])
    frames += 0.05 * np.random.default_rng(1).standard_normal(
        frames.shape).astype(np.float32)
    st, jst = freq.init_covariance(t), jf.init_covariance(jt)
    for f in frames:
        st = freq.update_covariance(st, f, t)
        jst = jf.update_covariance(jst, f, jt)
    np.testing.assert_allclose(_np(freq.mvdr_power(st, t)),
                               np.asarray(jf.mvdr_power(jst, jt)), **BEAM_GATE)
    # beams of an ill-conditioned covariance: relative to their scale
    d = 4 * cfg.max_res_y + 3
    want = np.asarray(jf.mvdr_beam(jst, jt, frames[:2], d))
    scale = np.abs(want).max()
    np.testing.assert_allclose(
        _np(freq.mvdr_beam(st, t, frames[:2], d)) / scale, want / scale,
        **SCALE_GATE)


def test_mvdr_localizes_source():
    cfg = Config.tiny()
    tx, ty = 6, 2
    t, _ = _tables(cfg, 2000.0, 20000.0)
    state = freq.init_covariance(t)
    for seed in range(4):
        frame = _delayed_source_frame(cfg, tx, ty, seed=20 + seed)
        frame += 0.01 * np.random.default_rng(seed).standard_normal(
            frame.shape).astype(np.float32)
        state = freq.update_covariance(state, frame, t)
    x, y = _peak(_np(freq.mvdr_power(state, t)))
    assert abs(x - tx) <= 1 and abs(y - ty) <= 1


def test_mvdr_resolves_two_sources():
    """Two incoherent sources: two peaks, valley ratio < 0.7 (Capon) and
    < 0.9 (summed Bartlett), ``test_freq.py:80-123``."""
    cfg = Config.tiny()
    t, _ = _tables(cfg, 12000.0, 24000.0)
    a, b = (1, 2), (7, 2)
    state = freq.init_covariance(t)
    bart = np.zeros((cfg.max_res_x, cfg.max_res_y), np.float64)
    for seed in range(8):
        fa = _delayed_source_frame(cfg, *a, seed=100 + seed)
        fb = _delayed_source_frame(cfg, *b, seed=200 + seed)
        frame = fa + fb + 0.01 * np.random.default_rng(seed) \
            .standard_normal(fa.shape).astype(np.float32)
        state = freq.update_covariance(state, frame, t)
        bart += _np(freq.fft_steered_power(frame, t)).astype(np.float64)
    capon = _np(freq.mvdr_power(state, t)).astype(np.float64)

    def valley_ratio(img):
        xs = np.linspace(a[0], b[0], 7).round().astype(int)
        ys = np.linspace(a[1], b[1], 7).round().astype(int)
        valley = min(img[x, y] for x, y in zip(xs[1:-1], ys[1:-1]))
        return valley / min(img[a], img[b])

    for x, y in (a, b):
        patch = capon[max(0, x - 1):x + 2, max(0, y - 1):y + 2]
        assert patch.max() >= 0.8 * capon.max()
    assert valley_ratio(capon) < 0.7
    assert valley_ratio(bart) < 0.9


def test_mvdr_ill_conditioned_single_source():
    cfg = Config.tiny()
    tx, ty = 6, 2
    t, _ = _tables(cfg, 2000.0, 20000.0)
    state = freq.init_covariance(t)
    frame = _delayed_source_frame(cfg, tx, ty, seed=77)
    for _ in range(8):
        state = freq.update_covariance(state, frame, t, alpha=0.999)
    img = _np(freq.mvdr_power(state, t))
    assert np.isfinite(img).all()
    x, y = _peak(img)
    assert abs(x - tx) <= 1 and abs(y - ty) <= 1


def test_mvdr_loading_sweep():
    cfg = Config.tiny()
    tx, ty = 4, 3
    t, _ = _tables(cfg, 2000.0, 20000.0)
    state = freq.init_covariance(t)
    rng = np.random.default_rng(78)
    for seed in range(3):
        frame = _delayed_source_frame(cfg, tx, ty, seed=80 + seed)
        frame += 0.02 * rng.standard_normal(frame.shape).astype(np.float32)
        state = freq.update_covariance(state, frame, t)
    for load in (1e-5, 1e-3, 1e-1, 1.0):
        img = _np(freq.mvdr_power(state, t, diagonal_loading=load))
        assert np.isfinite(img).all(), load
        x, y = _peak(img)
        assert abs(x - tx) <= 1 and abs(y - ty) <= 1, load


def test_mvdr_beam_recovers_signal():
    cfg = Config.tiny()
    tx, ty = 4, 3
    t, _ = _tables(cfg, 0.0, None)
    frame = _delayed_source_frame(cfg, tx, ty)
    state = freq.update_covariance(freq.init_covariance(t), frame, t)
    beam = _np(freq.mvdr_beam(state, t, frame, tx * cfg.max_res_y + ty))
    active, _ = geometry.active_microphones(cfg)
    assert abs(np.corrcoef(beam, frame[active[0]])[0, 1]) > 0.7


# -- the streaming inverse -------------------------------------------------

def _manual_ema_inverse(frames, t, load, alpha):
    """NumPy ground truth: P_N = inv(M_N), M_0 = (1+load) I,
    M_t = alpha M + (1-alpha) s s^H per frame."""
    F, M = t.hi - t.lo, t.n_mics
    Mat = np.broadcast_to((1.0 + load) * np.eye(M), (F, M, M)).astype(
        np.complex128).copy()
    active = _np(t.adaptive)
    for fr in frames:
        s = np.fft.rfft(fr[active].astype(np.float64), axis=-1)[:, t.lo:t.hi].T
        Mat = alpha * Mat + (1 - alpha) * s[:, :, None] * s.conj()[:, None, :]
    return np.linalg.inv(Mat)


def test_update_precision_matches_jax_and_inverse():
    cfg = Config.tiny()
    t, jt = _tables(cfg, 2000.0, 20000.0)
    frames = _frames(cfg, 5, seed=10)
    st, jst = freq.init_precision(t, load=1e-2), jf.init_precision(jt, 1e-2)
    for fr in frames:
        st = freq.update_precision(st, fr, t, alpha=0.9)
        jst = jf.update_precision(jst, fr, jt, alpha=0.9)
    want = _manual_ema_inverse(frames, t, 1e-2, 0.9)
    np.testing.assert_allclose(_np(st.P), want, **PREC_GATE)
    np.testing.assert_allclose(_np(st.P), _c(jst.P_re, jst.P_im),
                               **PREC_GATE)
    assert st.cov.count == 5


def test_precision_block_matches_sequential():
    """The rank-B Woodbury block update equals B sequential Sherman-Morrison
    steps, on the first-ever batch (covariance replacement) and a warm
    state, and one batched ``update_precision`` equals the per-frame loop
    (``test_freq.py:351-396``); the block update against JAX's too."""
    cfg = Config.tiny()
    t, jt = _tables(cfg, 2000.0, 20000.0)
    frames = _frames(cfg, 6, seed=12)
    seq = freq.init_precision(t, load=1e-2)
    for fr in frames[:3]:
        seq = freq.update_precision(seq, fr, t, alpha=0.9)
    blk = freq.update_precision_block(freq.init_precision(t, load=1e-2),
                                      frames[:3], t, alpha=0.9)
    for a, b in ((seq.P, blk.P), (seq.cov.R, blk.cov.R)):
        np.testing.assert_allclose(_np(a), _np(b), **BLOCK_GATE)
    assert blk.cov.count == 3
    jblk = jf.update_precision_block(jf.init_precision(jt, load=1e-2),
                                     frames[:3], jt, alpha=0.9)
    np.testing.assert_allclose(_np(blk.P), _c(jblk.P_re, jblk.P_im),
                               **BLOCK_GATE)
    np.testing.assert_allclose(_np(blk.cov.R),
                               _c(jblk.cov.R_re, jblk.cov.R_im),
                               **BLOCK_GATE)
    for fr in frames[3:]:
        seq = freq.update_precision(seq, fr, t, alpha=0.9)
    blk = freq.update_precision_block(blk, frames[3:], t, alpha=0.9)
    np.testing.assert_allclose(_np(seq.P), _np(blk.P), **BLOCK_GATE)
    np.testing.assert_allclose(_np(seq.cov.R), _np(blk.cov.R), **BLOCK_GATE)
    one = freq.update_precision(freq.init_precision(t, load=1e-2), frames,
                                t, alpha=0.9)
    np.testing.assert_allclose(_np(one.P), _np(seq.P), **BLOCK_GATE)
    np.testing.assert_allclose(_np(one.cov.R), _np(seq.cov.R), **BLOCK_GATE)
    assert one.cov.count == seq.cov.count == len(frames)


def _sequential_maps(st, frames, t):
    s, maps = st, []
    for fr in frames:
        s = freq.update_precision(s, fr, t, alpha=0.9)
        maps.append(_np(freq.mvdr_power_precision(s, t)))
    return np.stack(maps), s


def test_mvdr_maps_scan_matches_jax_and_sequential():
    cfg = Config.tiny()
    t, jt = _tables(cfg, 2000.0, 20000.0)
    frames = _frames(cfg, 6, seed=13)
    st = freq.init_precision(t, load=1e-2)
    seq, s = _sequential_maps(st, frames, t)
    maps, s2 = freq.mvdr_maps_scan(st, frames, t, alpha=0.9)
    assert maps.shape == (6, cfg.max_res_x, cfg.max_res_y)
    np.testing.assert_allclose(_np(maps), seq, **MAPS_GATE)
    np.testing.assert_allclose(_np(s2.P), _np(s.P), **BLOCK_GATE)
    jm, js = jf.mvdr_maps_scan(jf.init_precision(jt, load=1e-2), frames, jt,
                               alpha=0.9)
    np.testing.assert_allclose(_np(maps), np.asarray(jm), **MAPS_GATE)
    np.testing.assert_allclose(_np(s2.P), _c(js.P_re, js.P_im), **BLOCK_GATE)


@pytest.mark.parametrize("dtype,B", [("float32", 24), ("float64", 40)])
def test_mvdr_maps_scan_deep_block(dtype, B):
    """Blocks across the 16-frame chunk boundary stress the coefficient
    recursion (its factors grow like alpha^-t, so a mis-ordered or
    mis-conjugated term shows).  float32 at B=24 against the sequential
    loop and JAX (the JAX gate's own depth, ``test_freq.py:419-441``);
    B=40 (not a multiple of 16) in complex128, where f32 drift does not
    mask the algebra, against the sequential loop in complex128."""
    cfg = Config.tiny()
    t, jt = _tables(cfg, 2000.0, 20000.0)
    frames = _frames(cfg, B, seed=14, f0=2500.0, step=450.0 * 24 / B)
    frames = frames.astype(dtype)
    ctype = torch.complex64 if dtype == "float32" else torch.complex128
    st = freq.init_precision(t, load=1e-2, dtype=ctype)
    seq, s = _sequential_maps(st, frames, t)
    maps, s2 = freq.mvdr_maps_scan(st, frames, t, alpha=0.9)
    assert s2.P.dtype == ctype
    np.testing.assert_allclose(_np(maps), seq, **MAPS_GATE)
    if dtype == "float32":
        np.testing.assert_allclose(_np(s2.P), _np(s.P), rtol=1e-3,
                                   atol=2e-4)        # test_freq.py:440
        jm, _ = jf.mvdr_maps_scan(jf.init_precision(jt, load=1e-2), frames,
                                  jt, alpha=0.9)
        # two f32 trajectories at this depth: JAX's own scan-vs-loop class
        np.testing.assert_allclose(_np(maps), np.asarray(jm), rtol=1e-2,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(_np(s2.P), _np(s.P), **BLOCK_GATE)


def test_mvdr_maps_scan_carried_d_matches_blocked():
    """Four B=16 calls threading d0/return_d against one B=64 call
    (``test_freq.py:444-477``)."""
    cfg = Config.tiny()
    t, _ = _tables(cfg, 2000.0, 20000.0)
    frames = _frames(cfg, 64, seed=31, f0=2500.0, step=120.0)
    st0 = freq.init_precision(t, load=1e-2)
    ref, st_ref = freq.mvdr_maps_scan(st0, frames, t, alpha=0.9)
    st, dq, parts = st0, freq.mvdr_d0(st0, t), []
    for b in range(4):
        m, st, dq = freq.mvdr_maps_scan(st, frames[b * 16:(b + 1) * 16], t,
                                        alpha=0.9, d0=dq, return_d=True)
        parts.append(_np(m))
    got = np.concatenate(parts)
    np.testing.assert_allclose(got[:16], _np(ref)[:16], rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose(got, _np(ref), rtol=5e-2, atol=1e-6)
    np.testing.assert_allclose(_np(st.P), _np(st_ref.P), rtol=5e-2,
                               atol=1e-4)


def _drift_frames(cfg, seed):
    rng = np.random.default_rng(seed)
    return np.stack([
        synth_frame(cfg, rng, 2300.0 + 37.0 * i)
        + 0.03 * rng.standard_normal(
            (cfg.n_microphones, cfg.n_samples)).astype(np.float32)
        for i in range(320)]).astype(np.float32)


def _stream_maps(t, frames, every, alpha=0.9, B=16):
    """The production cadence (``pipeline.make_mvdr_stream``): d carried up
    to ``d0_carry_interval`` frames, refreshed every ``every`` frames."""
    carry_max = freq.d0_carry_interval(alpha)
    st = freq.init_precision(t)
    out, n, r, dq, dqc = [], 0, 0, None, 0
    for b in range(len(frames) // B):
        if dq is None or dqc >= carry_max:
            dq, dqc = freq.mvdr_d0(st, t), 0
        m, st, dq = freq.mvdr_maps_scan(st, frames[b * B:(b + 1) * B], t,
                                        alpha=alpha, d0=dq, return_d=True)
        out.append(_np(m).reshape(B, -1))
        n += B
        dqc += B
        if n - r >= every:
            st, dq, r = freq.refresh_precision(st, t), None, n
    return np.concatenate(out)


def test_refresh_interval_bounds_long_run_drift():
    """320 frames in 16-frame blocks at alpha=0.9, at the alpha-aware
    cadence: every map finite and within 0.05 (worst direction) of a
    complex128 same-trajectory oracle (per-frame Sherman-Morrison, EMA
    covariance with the first-frame replacement, the same refresh points),
    ``test_freq.py:480-570``.  The fixed 256-frame cadence blows up on
    these frames: not to NaN, as the JAX package's run does, but into the
    1e-12 denominator clamp's 1e12-scale spikes."""
    cfg = Config.tiny()
    alpha = 0.9
    t, _ = _tables(cfg, 2000.0, 20000.0)
    frames = _drift_frames(cfg, seed=1234)
    bad = _stream_maps(t, frames, 256)
    assert not np.isfinite(bad).all() or np.abs(bad).max() > 1e9
    every = freq.refresh_interval(alpha)
    assert 32 <= every <= 128
    maps = _stream_maps(t, frames, every)
    assert np.isfinite(maps).all()

    active = _np(t.adaptive)
    S = np.fft.rfft(frames[:, active].astype(np.float64),
                    axis=-1)[..., t.lo:t.hi].transpose(0, 2, 1)
    a = _np(t.phase).astype(np.complex128).conj()           # (F, M, D)
    load = freq.init_precision(t).load
    F, M = S.shape[1], S.shape[2]
    eyeM = np.broadcast_to(np.eye(M), (F, M, M))
    cov = eyeM.astype(np.complex128)
    P = eyeM / (1.0 + load) + 0j
    beta = (1 - alpha) / alpha
    errs, r = [], 0
    for tt in range(len(frames)):
        s_t = S[tt]
        Ps = np.einsum("fmn,fn->fm", P, s_t)
        g = np.real(np.einsum("fm,fm->f", np.conj(s_t), Ps))
        kappa = beta / (1 + beta * g)
        P = (P - kappa[:, None, None] * Ps[:, :, None]
             * np.conj(Ps)[:, None, :]) / alpha
        outer = s_t[:, :, None] * np.conj(s_t)[:, None, :]
        cov = outer if tt == 0 else alpha * cov + (1 - alpha) * outer
        d = np.real(np.einsum("fmd,fmd->fd", np.conj(a),
                              np.einsum("fmn,fnd->fmd", P, a)))
        truth = (1.0 / np.maximum(d, 1e-12)).sum(axis=0)
        errs.append(np.max(np.abs(maps[tt] - truth)
                           / (np.abs(truth) + 1e-12)))
        n = tt + 1
        if n % 16 == 0 and n - r >= every:
            lf = load * np.real(np.einsum("fmm->f", cov)) / M + 1e-12
            P = np.linalg.inv(cov + lf[:, None, None] * eyeM)
            r = n
    assert max(errs) < DRIFT_GATE, (max(errs), int(np.argmax(errs)))


def test_refresh_interval_bounds_listening_drift():
    """320 frames of steered listening at the alpha-aware cadence: finite,
    ``|beam| < 10`` and correlated with the tone (corr > 0.5),
    ``test_freq.py:573-612``; at the fixed 256-frame cadence the beams
    overflow that bound (to ~1e25 on these frames, where the JAX package's
    run reaches NaN)."""
    cfg = Config.tiny()
    alpha = 0.9
    t, _ = _tables(cfg, 100.0)
    rng = np.random.default_rng(4321)
    tt = np.arange(cfg.n_samples) / cfg.sample_rate
    tone = np.sin(2 * np.pi * 2500.0 * tt).astype(np.float32)
    frames = np.stack([
        (np.tile(tone, (cfg.n_microphones, 1)) * 0.2
         + 0.02 * rng.standard_normal((cfg.n_microphones, cfg.n_samples))
         ).astype(np.float32) for _ in range(320)])
    d_center = (t.res_x // 2) * t.res_y + t.res_y // 2

    def run(every):
        st, outs, n, r = freq.init_precision(t), [], 0, 0
        for b in range(20):
            beams, st = freq.mvdr_listen_step(
                st, frames[b * 16:(b + 1) * 16], t, d_center, alpha=alpha)
            outs.append(_np(beams))
            n += 16
            if n - r >= every:
                st, r = freq.refresh_precision(st, t), n
        return np.concatenate(outs)

    bad = run(256)
    assert not np.isfinite(bad).all() or np.abs(bad).max() > 1e9
    beams = run(freq.refresh_interval(alpha))
    assert np.isfinite(beams).all()
    assert np.abs(beams).max() < 10.0
    corr = np.corrcoef(beams[-16:].ravel(), np.tile(tone, 16))[0, 1]
    assert corr > 0.5, corr


def test_precision_refresh_bounds_drift():
    cfg = Config.tiny()
    t, _ = _tables(cfg, 2000.0, 20000.0)
    st = freq.init_precision(t, load=1e-3)
    for fr in _frames(cfg, 4, seed=15):
        st = freq.update_precision(st, fr, t)
    st2 = freq.refresh_precision(st, t)
    R = _np(freq._loaded(st.cov, 1e-3)).astype(np.complex128)
    P = _np(st2.P)
    np.testing.assert_allclose(R @ P, np.broadcast_to(np.eye(R.shape[1]),
                                                      R.shape), atol=5e-3)
    np.testing.assert_allclose(P, np.linalg.inv(R), rtol=0.05, atol=0.05)


def test_mvdr_power_precision_localizes():
    cfg = Config.tiny()
    tx, ty = 6, 2
    t, _ = _tables(cfg, 2000.0, 20000.0)
    st = freq.init_precision(t)
    rng = np.random.default_rng(91)
    for seed in range(4):
        frame = _delayed_source_frame(cfg, tx, ty, seed=90 + seed)
        frame += 0.02 * rng.standard_normal(frame.shape).astype(np.float32)
        st = freq.update_precision(st, frame, t)
    img = _np(freq.mvdr_power_precision(st, t))
    assert np.isfinite(img).all()
    x, y = _peak(img)
    assert abs(x - tx) <= 1 and abs(y - ty) <= 1


def test_mvdr_beam_precision_matches_covariance_beam():
    """Weights straight from P after an exact refresh against the Cholesky
    solve on the identically loaded covariance (``test_freq.py:653-683``),
    and against JAX's beam on the same state."""
    cfg = Config.tiny()
    t, jt = _tables(cfg, 2000.0, 20000.0)
    st = freq.init_precision(t, load=1e-2)
    st = freq.update_precision_block(st, _frames(cfg, 5, seed=16), t)
    st = freq.refresh_precision(st, t)
    d = 3 * cfg.max_res_y + 2
    test = _frames(cfg, 3, seed=17)
    got = _np(freq.mvdr_beam_precision(st, t, test, d))
    R = freq._loaded(st.cov, st.load)
    a = t.phase[:, :, d].conj()
    x = freq._solve_hermitian(R, a[:, :, None])[..., 0]
    denom = torch.linalg.vecdot(a, x).real.clamp_min(1e-12)
    want = _np(freq._apply_beam_weights(torch.from_numpy(test), t,
                                        x / denom[:, None]))
    np.testing.assert_allclose(got, want, **BEAM_GATE)
    jst = jf.PrecisionState(
        P_re=_np(st.P.real), P_im=_np(st.P.imag),
        cov=jf.CovarianceState(R_re=_np(st.cov.R.real),
                               R_im=_np(st.cov.R.imag),
                               count=np.int32(st.cov.count)), load=st.load)
    np.testing.assert_allclose(
        got, np.asarray(jf.mvdr_beam_precision(jst, jt, test, d)),
        **BEAM_GATE)
    # a 0-d device index steers the same beam as the int
    np.testing.assert_array_equal(
        got, _np(freq.mvdr_beam_precision(st, t, test, torch.tensor(d))))


def test_mvdr_listen_step_is_update_then_beam():
    cfg = Config.tiny()
    t, _ = _tables(cfg, 2000.0, 20000.0)
    st = freq.init_precision(t)
    frames = _frames(cfg, 4, seed=18)
    d = 2 * cfg.max_res_y + 1
    beams, st2 = freq.mvdr_listen_step(st, frames, t, d, alpha=0.9)
    want_state = freq.update_precision_block(st, frames, t, alpha=0.9)
    want = freq.mvdr_beam_precision(want_state, t, frames, d)
    assert beams.shape == (4, cfg.n_samples)
    np.testing.assert_allclose(_np(beams), _np(want), **LISTEN_GATE)
    np.testing.assert_allclose(_np(st2.P), _np(want_state.P), **LISTEN_GATE)


def test_mvdr_listen_step_recovers_steered_source():
    cfg = Config.tiny()
    tx, ty = 4, 3
    t, _ = _tables(cfg, 0.0, None)
    frames = np.stack([_delayed_source_frame(cfg, tx, ty, seed=s)
                       for s in range(3)])
    beams, _ = freq.mvdr_listen_step(freq.init_precision(t), frames, t,
                                     tx * cfg.max_res_y + ty)
    active, _ = geometry.active_microphones(cfg)
    for i in range(3):
        c = np.corrcoef(_np(beams[i]), frames[i][active[0]])[0, 1]
        assert abs(c) > 0.6, (i, c)


def test_precision_state_from_numpy_continues_jax_stream():
    """A JAX state mid-stream, carried across by ``from_numpy``: one block
    step (and one scan) from it lands within the block gate of JAX's."""
    cfg = Config.tiny()
    t, jt = _tables(cfg, 2000.0, 20000.0)
    frames = _frames(cfg, 6, seed=19)
    jst = jf.init_precision(jt, load=1e-2)
    jst = jf.update_precision_block(jst, frames[:3], jt, alpha=0.9)
    st = freq.PrecisionState.from_numpy(
        jst.P_re, jst.P_im, jst.cov.R_re, jst.cov.R_im, int(jst.cov.count),
        jst.load, device="cpu")
    assert st.cov.count == 3 and st.P.dtype == torch.complex64
    nxt = freq.update_precision_block(st, frames[3:], t, alpha=0.9)
    jnxt = jf.update_precision_block(jst, frames[3:], jt, alpha=0.9)
    np.testing.assert_allclose(_np(nxt.P), _c(jnxt.P_re, jnxt.P_im),
                               **BLOCK_GATE)
    np.testing.assert_allclose(_np(nxt.cov.R),
                               _c(jnxt.cov.R_re, jnxt.cov.R_im), **BLOCK_GATE)
    maps, _ = freq.mvdr_maps_scan(st, frames[3:], t)
    jmaps, _ = jf.mvdr_maps_scan(jst, frames[3:], jt)
    np.testing.assert_allclose(_np(maps), np.asarray(jmaps), **MAPS_GATE)


def test_refresh_and_carry_intervals_equal_jax():
    for alpha in (0.5, 0.9, 0.95, 0.99, 0.999):
        assert freq.refresh_interval(alpha) == jf.refresh_interval(alpha)
        assert freq.d0_carry_interval(alpha) == jf.d0_carry_interval(alpha)
    assert freq.refresh_interval(0.9) == 63
    assert freq.d0_carry_interval(0.9) == 31


def test_grid_precision_names():
    cfg = Config.tiny()
    t, _ = _tables(cfg, 2000.0, 20000.0)
    st = freq.init_precision(t)
    for p in ("highest", "high", "default"):
        freq.mvdr_d0(st, t, grid_precision=p)
    with pytest.raises(ValueError, match="grid_precision"):
        freq.mvdr_d0(st, t, grid_precision="tf32")
