"""The port's heatmap display: the Kalman filters against the JAX
package's (rtol 1e-6), the viz and imaging functions equal to the JAX
package's byte for byte (``tests/test_viz_fusion.py:27-75``), with cv2
and with the NumPy fallbacks, the audio sinks, and the headless display
loops.  No UDP port."""

import queue
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zybo_rt_sampler_image_detection_tpu.ops import kalman as jkalman
from zybo_rt_sampler_image_detection_tpu.utils import audio as jaudio
from zybo_rt_sampler_image_detection_tpu.utils import imaging as jimaging
from zybo_rt_sampler_image_detection_tpu.utils import viz as jviz
from zybo_rt_sampler_image_detection_torch.apps import demo
from zybo_rt_sampler_image_detection_torch.ops import kalman
from zybo_rt_sampler_image_detection_torch.utils import audio, imaging, viz

torch.set_num_threads(2)


@pytest.fixture(params=["cv2", "numpy"])
def backend(request, monkeypatch):
    """Both packages' imaging on cv2, then on the NumPy fallback (what a
    host without cv2 runs)."""
    if request.param == "numpy":
        monkeypatch.setattr(imaging, "_HAS_CV2", False)
        monkeypatch.setattr(jimaging, "_HAS_CV2", False)
    return request.param


def _maps(seed=0, shape=(9, 7)):
    rng = np.random.default_rng(seed)
    return rng.random(shape) ** 4 * 1e-4


# -- ops.kalman ------------------------------------------------------------

def test_kalman_filter_matches_jax():
    rng = np.random.default_rng(0)
    a, b = kalman.KalmanFilter3D(), jkalman.KalmanFilter3D()
    for i in range(40):
        z = np.array([5.0 + 0.3 * i, 7.0 - 0.1 * i, 0.0]) + rng.normal(0, 1, 3)
        a.update(z)
        b.update(z)
        np.testing.assert_allclose(a.get_state(), b.get_state(), rtol=1e-6)
    np.testing.assert_allclose(a.P, b.P, rtol=1e-6)
    for n in (1, 3, 5):
        np.testing.assert_allclose(a.predict(n), b.predict(n), rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_batched_kf3d_update_matches_jax(dtype):
    """A bank of 5 filters over 10 updates, against JAX's update."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 6)).astype(dtype)
    P = np.tile(np.eye(6, dtype=dtype), (5, 1, 1))
    xt, Pt = torch.from_numpy(x), torch.from_numpy(P)
    xj, Pj = jnp.asarray(x), jnp.asarray(P)
    for _ in range(10):
        z = rng.standard_normal((5, 3)).astype(dtype) * 3
        xt, Pt = kalman.batched_kf3d_update(xt, Pt, torch.from_numpy(z))
        xj, Pj = jkalman.batched_kf3d_update(xj, Pj, jnp.asarray(z))
    assert xt.dtype == (torch.float64 if dtype == np.float64
                        else torch.float32)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=1e-6,
                               atol=1e-6)


def test_batched_kf3d_update_equals_the_filter():
    """One filter of the bank follows ``KalmanFilter3D`` step for step."""
    kf = kalman.KalmanFilter3D()
    x, P = torch.zeros(1, 6), torch.eye(6)[None]
    for i in range(20):
        z = [float(i), 2.0 * i, 0.5]
        kf.update(z)
        x, P = kalman.batched_kf3d_update(x, P, torch.tensor([z]))
    np.testing.assert_allclose(x[0].numpy(), kf.x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(P[0].numpy(), kf.P, rtol=1e-5, atol=1e-6)


# -- utils.viz -------------------------------------------------------------

def test_jet_lut_equals_jax():
    np.testing.assert_array_equal(viz.jet_lut(), jviz.jet_lut())
    np.testing.assert_array_equal(viz.COLORS, jviz.COLORS)


@pytest.mark.parametrize("amount,exponent", [(0.5, 5), (0.3, 2), (0.8, 1)])
def test_colorize_equals_jax(amount, exponent):
    img = np.random.default_rng(2).random((9, 7))
    got = viz.colorize_power(img, amount, exponent)
    assert got.dtype == np.uint8 and got.shape == (7, 9, 3)
    np.testing.assert_array_equal(
        got, jviz.colorize_power(img, amount, exponent))


def test_log_normalize_equals_jax():
    img = _maps(3)
    np.testing.assert_array_equal(viz.log_normalize(img),
                                  jviz.log_normalize(img))


@pytest.mark.parametrize("threshold", [0.0, 1e-7, 1.0])
def test_calculate_heatmap_equals_jax(backend, threshold):
    img = _maps(4)
    got, should = viz.calculate_heatmap(img, threshold=threshold,
                                        window=(64, 48))
    ref, rshould = jviz.calculate_heatmap(img, threshold=threshold,
                                          window=(64, 48))
    assert should == rshould and got.shape == (48, 64, 3)
    np.testing.assert_array_equal(got, ref)


def test_calculate_heatmap2_equals_jax(backend):
    kf, jkf = kalman.KalmanFilter3D(), jkalman.KalmanFilter3D()
    for seed in range(3):
        img = _maps(5 + seed)
        got, s = viz.calculate_heatmap2(img, kf=kf, window=(64, 48))
        ref, rs = jviz.calculate_heatmap2(img, kf=jkf, window=(64, 48))
        assert s == rs
        np.testing.assert_array_equal(got, ref)


def test_calculate_heatmap_fft_equals_jax(backend):
    for img in (_maps(8) * 1e4, np.full((13, 13), 1e-9)):
        got, s = viz.calculate_heatmap_fft(img, window=(52, 39))
        ref, rs = jviz.calculate_heatmap_fft(img, window=(52, 39))
        assert s == rs
        np.testing.assert_array_equal(got, ref)


def test_find_power_center_equals_jax(backend):
    img = np.zeros((20, 30))
    img[12, 18] = 1.0
    got = viz.find_power_center(img)
    assert got == jviz.find_power_center(img)
    assert abs(got[0] - 18) < 1.5 and abs(got[1] - 12) < 1.5
    img = _maps(9, (20, 30))
    assert viz.find_power_center(img) == jviz.find_power_center(img)


def test_heatmap_with_detection_equals_jax(backend):
    img = np.zeros((9, 7))
    img[6, 2] = 1e-4
    for im in (img, _maps(10)):
        got = viz.calculate_heatmap_with_detection(im, window=(128, 64))
        ref = jviz.calculate_heatmap_with_detection(im, window=(128, 64))
        assert got[2] == ref[2]
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    assert got[0].sum() > 0              # a box was drawn


# -- utils.imaging ---------------------------------------------------------

def _imaging_cases(m):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    canvas = np.zeros((40, 50, 3), np.uint8)
    out = {
        "resize": m.resize(img, (45, 17)),
        "resize_nearest": m.resize(img, (45, 17), nearest=True),
        "resize_same": m.resize(img, (32, 24)),
        "add_weighted": m.add_weighted(img, 0.5, img[::-1].copy(), 0.7, 3.0),
        "flip": m.flip_horizontal(img),
        "to_gray": m.to_gray(img),
        "gray_to_bgr": m.gray_to_bgr(gray),
        "blur": m.gaussian_blur(gray.astype(np.float32), 5, 1.0),
        "mean": np.float64(m.mean_brightness(img)),
    }
    for name, draw in (("rect", lambda c: m.rectangle(c, (5, 6), (30, 35),
                                                      (255, 0, 255), 3)),
                       ("circle", lambda c: m.circle(c, (20, 18), 9,
                                                     (0, 255, 0), 2)),
                       ("disc", lambda c: m.circle(c, (20, 18), 5,
                                                   (0, 0, 255), -1)),
                       ("text", lambda c: m.put_text(c, "hi", (3, 20),
                                                     (9, 9, 9)))):
        c = canvas.copy()
        draw(c)
        out[name] = c
    return out


def test_imaging_equals_jax(backend):
    got, ref = _imaging_cases(imaging), _imaging_cases(jimaging)
    assert got.keys() == ref.keys()
    for k in got:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# -- utils.audio -----------------------------------------------------------

def test_wav_sink_writes_clipped_int16(tmp_path):
    path = tmp_path / "a.wav"
    s = audio.WavFileSink(str(path), 48828.0)
    x = np.linspace(-2, 2, 1000).astype(np.float32)
    s.write(x)
    s.write(x[:10])
    s.close()
    s.write(x)                         # late writes are dropped and counted
    assert s._dropped == 1
    with wave.open(str(path)) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == \
            (1, 2, 48828)
        data = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    expect = (np.clip(np.concatenate([x, x[:10]]), -1, 1)
              * 32767).astype("<i2")
    np.testing.assert_array_equal(data, expect)


def test_mock_sink_counts_underflow():
    clock = iter([0.0, 0.5, 1.0]).__next__
    s = audio.MockCallbackSink(1000.0, prefill_ms=100.0)
    s._clock = clock
    s.write(np.zeros(100, np.float32))   # t=0: starts the consumer
    s.write(np.zeros(100, np.float32))   # t=0.5: demand 400, 100 written
    assert s.underflow_samples == 300 and s.written == 500
    s.write(np.zeros(1000, np.float32))  # t=1.0: demand 900, 500 written
    assert s.underflow_samples == 700 and s.written == 1900
    assert s.underflow_ms == pytest.approx(700.0)


def test_make_sink_kinds_and_gain(tmp_path):
    assert isinstance(audio.make_sink("null", 48828.0), audio.NullSink)
    assert isinstance(audio.make_sink("mock", 48828.0),
                      audio.MockCallbackSink)
    w = audio.make_sink("wav", 48828.0, str(tmp_path / "b.wav"))
    assert isinstance(w, audio.WavFileSink)
    w.close()
    auto = audio.make_sink("auto", 48828.0, str(tmp_path / "c.wav"))
    assert isinstance(auto, (audio.SoundDeviceSink, audio.WavFileSink))
    auto.close()
    with pytest.raises(ValueError, match="unknown audio sink"):
        audio.make_sink("nope", 48828.0)
    n = audio.NullSink()
    n.write(np.zeros(77, np.float32))
    assert n.frames == 77
    beam = np.random.default_rng(3).standard_normal(256).astype(np.float32)
    np.testing.assert_array_equal(audio.miso_gain(beam, 192, 128.0, 2e6),
                                  jaudio.miso_gain(beam, 192, 128.0, 2e6))


# -- the display loops -----------------------------------------------------

def test_front_multi_loop_headless(backend):
    """``Front.multi_loop`` composes camera + heatmap for every map it
    gets, headless, as the JAX package's does."""
    rng = np.random.default_rng(12)
    cams = [rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
            for _ in range(3)]
    maps = [_maps(20 + i) for i in range(6)]
    shown = []
    for mod in (viz, jviz):
        q = queue.Queue()
        for m in maps:
            q.put(m)
        disp = mod.ArrayDisplay(keep=10)
        front = mod.Front(q, queue.Queue(), True, window=(64, 48),
                          capture=mod.ArrayCapture(cams), display=disp)
        front.multi_loop(max_frames=len(maps))
        shown.append(disp.frames)
    assert len(shown[0]) == len(maps)
    for a, b in zip(*shown):
        assert a.shape == (48, 64, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_front_click_steers_and_display_keeps():
    q_out = queue.Queue()
    front = viz.Front(queue.Queue(), q_out, True, window=(100, 50),
                      capture=viz.ArrayCapture([]),
                      display=viz.ArrayDisplay())
    front._mouse(25, 10)
    assert q_out.get_nowait() == (0.2, 0.75)
    d = viz.ArrayDisplay(keep=2)
    for i in range(3):
        d.show(np.full((2, 2, 3), i, np.uint8))
    assert [f[0, 0, 0] for f in d.frames] == [1, 2]
    assert viz.ArrayCapture([]).read() == (False, None)


def test_demo_viewer_loop_headless():
    """``demo mimo``'s window loop on an injected display: one blended
    heatmap per map, the same pixels the JAX demo's blend gives."""

    class _P:
        q_power = queue.Queue()

    maps = [_maps(30 + i) for i in range(4)]
    for i, m in enumerate(maps):
        _P.q_power.put((m, i + 1))
    disp = viz.ArrayDisplay(keep=10)
    n = demo._viewer_loop(_P(), frames=4, display=disp)
    assert n == 4 and len(disp.frames) == 4
    prev = None
    for m, shown in zip(maps, disp.frames):
        heat, _ = jviz.calculate_heatmap(m, threshold=0, window=(720, 480))
        if prev is not None:
            heat = jimaging.add_weighted(prev, 0.5, heat, 0.5)
        prev = heat
        np.testing.assert_array_equal(shown, heat)
