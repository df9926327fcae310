"""The port's device compositor (``fusion/composite.py``) and the I420
helpers of the fused stage (``apps/fused.py``) on the CPU, without UDP.

* ``DeviceCompositor`` against the JAX package's on the same seeded
  inputs, at both resize conventions, with ``heatmap_color`` on and off
  and in boxes mode: composites, power centers and the EMA carry equal
  byte for byte, light/conf at atol 1e-6.
* The compositor against the port's own host chain (``Viewer.loop`` +
  ``SensorFusionDecider``) at the JAX package's gates
  (tests/test_composite.py:31-36), on cv2 as the JAX package's tests run
  it (the NumPy fallback draws the power box and circle unlike cv2, which
  the compositor follows; only the box-free case runs on both).
* Below-threshold, dark-camera, EMA-carry and padded-``count`` cases,
  the 5x5 blur, the box raster, ``DeviceViewer.loop``.
* The I420 helpers byte for byte against JAX's, and against cv2 at the
  gates of tests/test_fused.py:111-128.
"""

import queue
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zybo_rt_sampler_image_detection_tpu.apps import fused as jfused
from zybo_rt_sampler_image_detection_tpu.fusion import composite as jcomp
from zybo_rt_sampler_image_detection_tpu.utils import imaging as jimaging
from zybo_rt_sampler_image_detection_torch.apps import fused
from zybo_rt_sampler_image_detection_torch.apps.pipeline import _draw_tracks
from zybo_rt_sampler_image_detection_torch.fusion import composite
from zybo_rt_sampler_image_detection_torch.fusion.composite import (
    DeviceCompositor, DeviceViewer)
from zybo_rt_sampler_image_detection_torch.fusion.decider import (
    SensorFusionDecider)
from zybo_rt_sampler_image_detection_torch.utils import imaging, viz

torch.set_num_threads(2)

WINDOW = (160, 96)      # (W, H)
GRID = (9, 7)           # (Xg, Yg) power-map grid
CAM = (48, 64)          # (Hc, Wc) camera frames
YOLO = (48, 64)         # (Hy, Wy) tracker overlay frames
BOX_RATIO = 0.1
# the host chain's gates (the JAX package's tests/test_composite.py:31-36)
MAX_ABS, MEAN_ABS, FRAC_GT2 = 5, 0.6, 0.02
META_ATOL = 1e-6


@pytest.fixture(params=["cv2", "numpy"])
def backend(request, monkeypatch):
    """The host chains on cv2, then on the NumPy fallbacks (what a host
    without cv2, like the card's, runs)."""
    if request.param == "numpy":
        monkeypatch.setattr(imaging, "_HAS_CV2", False)
        monkeypatch.setattr(jimaging, "_HAS_CV2", False)
    return request.param


def _powers(rng, k, scale=1e-4):
    """Smooth Gaussian-bump maps with unambiguous peaks."""
    Xg, Yg = GRID
    xs, ys = np.arange(Xg)[:, None], np.arange(Yg)[None, :]
    out = []
    for _ in range(k):
        cx, cy = rng.uniform(1, Xg - 2), rng.uniform(1, Yg - 2)
        bump = rng.uniform(0.5, 2.0) * np.exp(
            -((xs - cx) ** 2 + (ys - cy) ** 2) / rng.uniform(1.5, 4.0))
        out.append(bump * scale + rng.uniform(0, 1e-2, (Xg, Yg)) * scale)
    return np.asarray(out, np.float32)


def _inputs(seed, k=5, boxes=False):
    rng = np.random.default_rng(seed)
    powers = _powers(rng, k)
    cams = rng.integers(40, 220, (k,) + CAM + (3,)).astype(np.uint8)
    if boxes:
        yolos = np.full((k, 4, 5), -100.0, np.float32)
        yolos[:, 0] = [5, 8, 30, 30, 1]
        yolos[1:, 1] = [20, 15, 55, 40, 2]
    else:
        yolos = np.zeros((k,) + YOLO + (3,), np.uint8)
        for i in range(k):
            yolos[i, 10 + i:30 + i, 8:40, 1] = 255
    return powers, cams, yolos


def _box_raster_mask(sx, sy, window):
    """Pixels the power box + center circle could touch at (sx, sy),
    dilated by 1, in display coordinates: a one-pixel center shift flips
    them 0 <-> 255."""
    Ww, Hw = window
    bw, bh = int(Ww * BOX_RATIO), int(Hw * BOX_RATIO)
    x1, y1 = max(0, sx - bw // 2), max(0, sy - bh // 2)
    x2, y2 = min(Ww, sx + bw // 2), min(Hw, sy + bh // 2)
    m = np.zeros((Hw, Ww), bool)
    for (ax1, ay1, ax2, ay2) in [(x1, y1, x2, y1), (x1, y2, x2, y2),
                                 (x1, y1, x1, y2), (x2, y1, x2, y2)]:
        m[max(0, ay1 - 4):ay2 + 5, max(0, ax1 - 4):ax2 + 5] = True
    m[max(0, sy - 7):sy + 8, max(0, sx - 7):sx + 8] = True
    return m[:, ::-1]


def _port(powers, cams, yolos, prev=None, count=None, **kw):
    comp = DeviceCompositor(GRID, CAM, window=WINDOW, yolo_shape=YOLO,
                            device="cpu", **kw)
    comps, prev2, meta = comp(powers, cams, yolos,
                              comp.init_prev() if prev is None else prev,
                              count=count)
    return comps.numpy(), prev2.numpy(), DeviceCompositor.meta_dict(meta)


def _centers_and_diff(a, b, ma, mb):
    """|a - b| with the raster region masked on frames whose centers
    differ; asserts the centers are within 1 px."""
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    for i in range(len(a)):
        pa = (int(ma["sx"][i]), int(ma["sy"][i]))
        pb = (int(mb["sx"][i]), int(mb["sy"][i]))
        assert abs(pa[0] - pb[0]) <= 1 and abs(pa[1] - pb[1]) <= 1, \
            f"frame {i}: center {pa} vs {pb}"
        if pa != pb and ma["should"][i]:
            diff[i][_box_raster_mask(*pa, WINDOW)
                    | _box_raster_mask(*pb, WINDOW)] = 0
    return diff


@pytest.mark.parametrize("boxes", [False, True], ids=["canvas", "boxes"])
@pytest.mark.parametrize("heatmap_color", [False, True])
@pytest.mark.parametrize("cv2_convention", [True, False])
def test_compositor_matches_jax(cv2_convention, heatmap_color, boxes):
    """The port's compositor against the JAX package's, same inputs."""
    powers, cams, yolos = _inputs(1, boxes=boxes)
    kw = dict(heatmap_color=heatmap_color, cv2_convention=cv2_convention,
              max_tracks=4 if boxes else 0)
    got, prev, meta = _port(powers, cams, yolos, **kw)
    jc = jcomp.DeviceCompositor(GRID, CAM, window=WINDOW, yolo_shape=YOLO,
                                **kw)
    ref, jprev, jmeta = jc(powers, cams, yolos, jc.init_prev())
    jmeta = jcomp.DeviceCompositor.meta_dict(jmeta)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(prev, np.asarray(jprev))
    for key in ("should", "sx", "sy"):
        np.testing.assert_array_equal(meta[key], jmeta[key])
    np.testing.assert_allclose(meta["light"], jmeta["light"], rtol=0,
                               atol=META_ATOL)
    np.testing.assert_allclose(meta["conf"], jmeta["conf"], rtol=0,
                               atol=META_ATOL)


def _host_frames(powers, cams, yolos, heatmap_color):
    """The port's REAL host viewer chain, every displayed frame."""
    q_power, q_viewer, q_inference = (queue.Queue() for _ in range(3))
    for i, (p, c, y) in enumerate(zip(powers, cams, yolos)):
        q_power.put((p, i))
        q_viewer.put((i, c))
        q_inference.put((i, y, 0.0))
    disp = viz.ArrayDisplay(keep=len(powers))
    v = viz.Viewer(window=WINDOW, display=disp, heatmap_color=heatmap_color)
    dec = SensorFusionDecider(WINDOW)
    v.loop(q_power, True, q_viewer=q_viewer, q_inference=q_inference,
           decider=dec, max_frames=len(powers))
    return np.asarray(disp.frames), dec


def _host_center(power):
    """The Viewer's sx/sy (visual.py:283-285 int truncation included)."""
    Ww, Hw = WINDOW
    Xg, Yg = GRID
    px, py = viz.find_power_center(np.clip(power, 1e-12, None))
    return (Ww - 1 - int(py / max(Xg - 1, 1) * Ww),
            Hw - 1 - int(px / max(Yg - 1, 1) * Hw))


def _assert_host_gates(host, dev, meta, powers):
    hmeta = {"sx": [], "sy": [], "should": meta["should"]}
    for p in powers:
        sx, sy = _host_center(p)
        hmeta["sx"].append(sx)
        hmeta["sy"].append(sy)
    diff = _centers_and_diff(dev, host, meta, hmeta)
    assert diff.max() <= MAX_ABS, diff.max()
    assert diff.mean() <= MEAN_ABS, diff.mean()
    assert (diff > 2).mean() <= FRAC_GT2


@pytest.mark.parametrize("heatmap_color", [False, True])
def test_compositor_matches_host_chain(heatmap_color):
    """The compositor (in the convention the host runs) against the
    port's ``Viewer.loop`` + ``SensorFusionDecider`` on real queues."""
    powers, cams, yolos = _inputs(2, k=4)
    host, dec = _host_frames(powers, cams, yolos, heatmap_color)
    dev, _, meta = _port(powers, cams, yolos, heatmap_color=heatmap_color)
    assert len(host) == 4
    _assert_host_gates(host, dev, meta, powers)
    assert abs(meta["light"][-1] - dec.last_light_level) < 0.01
    assert abs(meta["conf"][-1] - dec.last_entropy_confidence) < 1e-3
    assert meta["should"].all()


def test_below_threshold_draws_no_overlay(backend):
    """should_overlay False: no heatmap paint and no power box."""
    rng = np.random.default_rng(3)
    powers = _powers(rng, 2, scale=1e-9)
    cams = rng.integers(90, 200, (2,) + CAM + (3,)).astype(np.uint8)
    yolos = np.zeros((2,) + YOLO + (3,), np.uint8)
    host, _ = _host_frames(powers, cams, yolos, False)
    dev, prev, meta = _port(powers, cams, yolos)
    assert not meta["should"].any() and not prev.any()
    _assert_host_gates(host, dev, meta, powers)


def test_dark_camera_gates_yolo_modality():
    """A light level below 0.2 drops the YOLO overlay (decider.py:53-60)
    on the device as on the host."""
    rng = np.random.default_rng(4)
    powers = _powers(rng, 2)
    dark = np.full((2,) + CAM + (3,), 8, np.uint8)
    yolos = np.zeros((2,) + YOLO + (3,), np.uint8)
    yolos[:, 12:30, 8:40, 1] = 255
    host, dec = _host_frames(powers, dark, yolos, False)
    dev, _, meta = _port(powers, dark, yolos)
    assert meta["light"][-1] < 0.2 and dec.last_light_level < 0.2
    _assert_host_gates(host, dev, meta, powers)
    bright, _, _ = _port(powers, dark + 100, yolos)
    assert not np.array_equal(bright, dev)


def test_ema_state_carries_across_calls():
    """prev' of call N feeds call N+1: split batches equal one batch."""
    powers, cams, yolos = _inputs(5, k=4)
    full, _, _ = _port(powers, cams, yolos)
    a, prev, _ = _port(powers[:2], cams[:2], yolos[:2])
    b, _, _ = _port(powers[2:], cams[2:], yolos[2:],
                    prev=torch.from_numpy(prev))
    np.testing.assert_array_equal(full, np.concatenate([a, b]))


def test_padded_batch_count_discards_repeats():
    """count=n on a repeat-padded batch: the same leading outputs and the
    same EMA carry as the unpadded call; count 0 (a listening cycle with
    no camera frame) keeps the last frame's carry, as JAX's wrapped index
    -1 does."""
    powers, cams, yolos = _inputs(6, k=5)

    def pad(x, k):
        return np.concatenate([x[:3], np.repeat(x[2:3], k - 3, 0)])

    ref, prev_ref, _ = _port(powers[:3], cams[:3], yolos[:3])
    got, prev_got, _ = _port(pad(powers, 5), pad(cams, 5), pad(yolos, 5),
                             count=3)
    np.testing.assert_array_equal(ref, got[:3])
    np.testing.assert_array_equal(prev_ref, prev_got)
    _, prev0, _ = _port(powers, cams, yolos, count=0)
    _, prev5, _ = _port(powers, cams, yolos)
    np.testing.assert_array_equal(prev0, prev5)
    jc = jcomp.DeviceCompositor(GRID, CAM, window=WINDOW, yolo_shape=YOLO)
    _, jprev0, _ = jc(powers, cams, yolos, jc.init_prev(), count=0)
    np.testing.assert_array_equal(prev0, np.asarray(jprev0))


def test_gauss5_matches_imaging_blur(backend):
    """The in-program 5x5 reflect-101 Gaussian == imaging.gaussian_blur
    (cv2 or fallback), batched or not."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2,) + GRID).astype(np.float32) ** 2
    g = torch.from_numpy(composite._gauss_kernel5())
    got = DeviceCompositor._gauss5(torch.from_numpy(x), g).numpy()
    for i in range(2):
        want = imaging.gaussian_blur(x[i], 5, 1.0)
        np.testing.assert_allclose(got[i], want, rtol=2e-5, atol=2e-6)
        one = DeviceCompositor._gauss5(torch.from_numpy(x[i]), g).numpy()
        np.testing.assert_array_equal(one, got[i])


def test_box_raster_matches_host_drawn_overlay():
    """max_tracks mode: the track boxes rasterized in the program equal
    the host tracker's drawn canvas (``pipeline._draw_tracks``) through
    the whole chain."""
    rng = np.random.default_rng(8)
    k = 3
    powers = _powers(rng, k)
    cams = rng.integers(60, 200, (k,) + CAM + (3,)).astype(np.uint8)
    canvas = np.zeros((k,) + YOLO + (3,), np.uint8)
    per_frame = [np.array([[5, 8, 30, 30, 1], [20, 15, 55, 40, 2]], float),
                 np.array([[10, 12, 40, 35, 1]], float),
                 np.array([[50, 30, 62, 45, 3], [2, 2, 20, 20, 4]], float)]
    for i, t in enumerate(per_frame):
        _draw_tracks(imaging, canvas[i], t, [], [[0, 0], [0, 0], 0])
    host, _ = _host_frames(powers, cams, canvas, False)
    boxes = np.full((k, 4, 5), -100.0, np.float32)
    for i, t in enumerate(per_frame):
        boxes[i, :len(t)] = t
    dev, _, meta = _port(powers, cams, boxes, max_tracks=4)
    _assert_host_gates(host, dev, meta, powers)
    comp = DeviceCompositor(GRID, CAM, window=WINDOW, yolo_shape=YOLO,
                            max_tracks=4, device="cpu")
    raster = comp._raster_tracks(torch.from_numpy(boxes)).numpy()
    if imaging._HAS_CV2:                  # cv2's thick outline, exactly
        np.testing.assert_array_equal(raster.astype(np.uint8), canvas)


def test_device_viewer_loop_matches_host_viewer():
    """DeviceViewer.loop (queues -> batched composite -> display) shows
    the same frames, in order, as the host Viewer.loop, across a partial
    last batch."""
    k = 7
    powers, cams, yolos = _inputs(9, k=k)
    host, _ = _host_frames(powers, cams, yolos, False)
    comp = DeviceCompositor(GRID, CAM, window=WINDOW, yolo_shape=YOLO,
                            device="cpu")
    disp = viz.ArrayDisplay(keep=k)
    dv = DeviceViewer(comp, disp, batch=4)
    dv.warmup()
    q_power, q_viewer, q_inference = (queue.Queue() for _ in range(3))
    for i in range(k):
        q_power.put((powers[i], i))
        q_viewer.put((i, cams[i]))
        q_inference.put((i, yolos[i], 0.0))
    dv.loop(q_power, True, q_viewer=q_viewer, q_inference=q_inference,
            max_frames=k)
    assert dv.frames == k and len(disp.frames) == k
    dev, _, meta = _port(powers, cams, yolos)
    np.testing.assert_array_equal(np.asarray(disp.frames), dev)
    _assert_host_gates(host, dev, meta, powers)
    rep = dv.report()
    assert rep["latency_p50_ms"] is not None and rep["frames"] == k
    assert 0.0 <= rep["light"] <= 1.0 and 0.0 < rep["conf"] <= 1.0


def test_device_viewer_boxes_payload():
    """The boxes-mode viewer takes the tracker's emit_boxes payloads
    ((T, 5) of any length, or none) and pads them to max_tracks."""
    comp = DeviceCompositor(GRID, CAM, window=WINDOW, yolo_shape=YOLO,
                            max_tracks=2, device="cpu")
    dv = DeviceViewer(comp, viz.ArrayDisplay(), batch=2)
    three = np.array([[1, 2, 3, 4, 1], [5, 6, 7, 8, 2], [9, 9, 9, 9, 3]],
                     np.float32)
    np.testing.assert_array_equal(dv._as_yolo(three), three[:2])
    assert (dv._as_yolo(None) == -100).all()
    assert (dv._as_yolo(np.zeros((0, 5), np.float32)) == -100).all()


# -- the I420 helpers -------------------------------------------------------------

def _image(seed, h=48, w=80, k=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (k, h, w, 3)).astype(np.uint8)


def test_i420_helpers_match_jax(backend, monkeypatch):
    """The device forward and inverse byte for byte against JAX's (run
    op by op, as its tests run them), and the host pair against JAX's on
    cv2 and on the NumPy fallbacks (JAX's take them when cv2 does not
    import)."""
    if backend == "numpy":
        monkeypatch.setitem(sys.modules, "cv2", None)
    img = _image(11)
    h, w = img.shape[1:3]
    planes = fused._bgr_to_i420(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(
        planes, np.asarray(jfused._bgr_to_i420(jnp.asarray(img))))
    host_planes = fused._host_bgr_to_i420(img)
    np.testing.assert_array_equal(host_planes,
                                  jfused._host_bgr_to_i420(img))
    back = fused._dev_i420_to_bgr(torch.from_numpy(host_planes), h, w)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jfused._dev_i420_to_bgr(
            jnp.asarray(host_planes), h, w)))
    np.testing.assert_array_equal(fused._i420_to_bgr(planes, h, w),
                                  jfused._i420_to_bgr(planes, h, w))


def test_i420_against_cv2():
    """The device forward matches cv2's own I420 conversion within
    rounding, and the round trip sits in cv2's 4:2:0 loss class (the JAX
    package's gates, tests/test_fused.py:111-128)."""
    cv2 = pytest.importorskip("cv2")
    img = _image(11, k=1)
    h, w = img.shape[1:3]
    planes = fused._bgr_to_i420(torch.from_numpy(img)).numpy()
    ref = cv2.cvtColor(img[0], cv2.COLOR_BGR2YUV_I420).reshape(-1)
    assert np.abs(planes[0].astype(int) - ref.astype(int)).max() <= 1
    back = fused._i420_to_bgr(planes, h, w)
    cv2_rt = cv2.cvtColor(ref.reshape(h * 3 // 2, w), cv2.COLOR_YUV2BGR_I420)
    assert np.abs(back[0].astype(int) - cv2_rt.astype(int)).max() <= 6
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    sm = np.clip(np.stack([100 + 50 * np.sin(yy / 9),
                           80 + 60 * np.cos(xx / 11),
                           120 + 40 * np.sin((xx + yy) / 13)], axis=-1),
                 0, 255).astype(np.uint8)[None]
    back2 = fused._i420_to_bgr(
        fused._bgr_to_i420(torch.from_numpy(sm)).numpy(), h, w)
    err = np.abs(back2.astype(int) - sm.astype(int))
    assert err.mean() < 2.5 and err.max() <= 12, (err.mean(), err.max())
    # the device inverse against cv2's on the same planes
    dev = fused._dev_i420_to_bgr(
        torch.from_numpy(ref.reshape(1, h * 3 // 2, w)), h, w).numpy()
    assert np.abs(dev[0] - cv2_rt.astype(np.float32)).max() <= 6


def test_compositor_device_is_explicit():
    """The compositor defaults to the card: without a GPU it raises
    rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceCompositor(GRID, CAM, window=WINDOW)
