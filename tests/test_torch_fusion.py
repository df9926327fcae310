"""The port's host sensor-fusion chain: the decider and ``Viewer`` equal
to the JAX package's byte for byte (on cv2 and on the NumPy fallbacks),
the camera producer, the Pipeline's vision stages, ``demo sensorfusion
--composite host`` on loopback at the tiny preset, the refusal of the
argument a later slice owns, the arguments this slice ported reaching
their stages, and the UDP echo pair.  UDP ports 22150-22159
only."""

import queue
import threading
import time

import numpy as np
import pytest
import torch

from zybo_rt_sampler_image_detection_tpu.fusion import decider as jdecider
from zybo_rt_sampler_image_detection_tpu.utils import imaging as jimaging
from zybo_rt_sampler_image_detection_tpu.utils import viz as jviz
from zybo_rt_sampler_image_detection_torch.apps import demo, pipeline
from zybo_rt_sampler_image_detection_torch.config import Config
from zybo_rt_sampler_image_detection_torch.fusion.decider import (
    SensorFusionDecider)
from zybo_rt_sampler_image_detection_torch.ingest import streamer, udptools
from zybo_rt_sampler_image_detection_torch.models import data, detect
from zybo_rt_sampler_image_detection_torch.utils import imaging, viz
from zybo_rt_sampler_image_detection_torch.utils.metrics import (
    PipelineMetrics)

torch.set_num_threads(2)


@pytest.fixture(params=["cv2", "numpy"])
def backend(request, monkeypatch):
    """Both packages' imaging on cv2, then on the NumPy fallback (what a
    host without cv2 runs)."""
    if request.param == "numpy":
        monkeypatch.setattr(imaging, "_HAS_CV2", False)
        monkeypatch.setattr(jimaging, "_HAS_CV2", False)
    return request.param


def test_udp_echo_pair():
    """``udptools`` (the reference's ``udp/test_server.c`` /
    ``test_client.c``) on loopback."""
    t, addr, stop = udptools.echo_server(port=22150)
    try:
        assert udptools.echo_client(b"hello zybo", addr) == b"hello zybo"
        assert udptools.echo_client(b"\x00" * 1032, addr) == b"\x00" * 1032
    finally:
        stop()
        t.join(timeout=2.0)
    assert not t.is_alive()


# -- fusion.decider ---------------------------------------------------------------

def _layers(seed, hw=(72, 128)):
    rng = np.random.default_rng(seed)
    image = (rng.random(hw + (3,)) * 255).astype(np.uint8)
    yolo = np.zeros(hw + (3,), np.uint8)
    yolo[10:30, 20:60] = (0, 255, 0)
    power = (rng.random(hw + (3,)) * 80).astype(np.uint8)
    heat = (rng.random(hw[:1] + (hw[1] // 2, 3)) * 255).astype(np.uint8)
    return image, yolo, power, heat


def test_decider_matches_jax(backend):
    """create_image, the gating state and the entropy confidence on
    bright, dark, grey and float layers; focus_beam's steering angles."""
    d, jd = SensorFusionDecider((160, 90)), jdecider.SensorFusionDecider(
        (160, 90))
    for seed in range(3):
        image, yolo, power, heat = _layers(seed)
        if seed == 1:
            image //= 8                                    # below 0.2
        layers = (image, yolo, power, heat)
        if seed == 2:
            layers = (image[..., 0], yolo, power,
                      heat[..., 0].astype(np.float32) / 255)
        out = d.create_image(*layers)
        ref = jd.create_image(*layers)
        np.testing.assert_array_equal(out, ref)
        assert d.last_light_level == jd.last_light_level
        assert d.last_entropy_confidence == jd.last_entropy_confidence
    assert d.last_light_level > 0.2
    peaked = np.zeros((9, 7))
    peaked[4, 3] = 1.0
    for m in (peaked, np.ones((9, 7)), heat):
        assert d.get_entropy(m) == jd.get_entropy(m)
    assert d.get_entropy(peaked) > d.get_entropy(np.ones((9, 7)))
    for box in ([70, 30, 90, 60, 0.9], [0, 0, 10, 10, 0.2],
                [150, 80, 160, 90, 0.51]):
        calls, jcalls = [], []
        assert d.focus_beam(lambda h, v: calls.append((h, v)), box) == \
            jd.focus_beam(lambda h, v: jcalls.append((h, v)), box)
        assert calls == jcalls
    assert len(calls) == 1


# -- utils.viz.Viewer ---------------------------------------------------------------

class _Running:
    value = 1


def _viewer_queues(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    q_power, q_viewer, q_inf = (queue.Queue() for _ in range(3))
    for i in range(n):
        power = rng.random((cfg.max_res_x, cfg.max_res_y)) ** 4 * 1e-4
        q_power.put((power, i))
        q_viewer.put((i, (rng.random((60, 80, 3)) * 255).astype(np.uint8)))
        overlay = np.zeros((60, 80, 3), np.uint8)
        overlay[5:20, 10:40] = (0, 255, 0)
        q_inf.put((i, overlay, [[10, 5], [40, 20], 0.8]))
    return q_power, q_viewer, q_inf


@pytest.mark.parametrize("heatmap_color", [False, True])
def test_viewer_matches_jax(backend, heatmap_color):
    """Three composited frames of the port's ``Viewer`` equal the JAX
    ``Viewer``'s on the same queues."""
    cfg = Config.tiny()
    frames = []
    for mod in (viz, jviz):
        disp = mod.ArrayDisplay(keep=8)
        v = mod.Viewer(window=(160, 90), display=disp,
                       heatmap_color=heatmap_color)
        q_power, q_viewer, q_inf = _viewer_queues(cfg, 3)
        v.loop(q_power, _Running(), q_viewer=q_viewer, q_inference=q_inf,
               max_frames=3)
        frames.append(disp.frames)
    assert len(frames[0]) == 3
    for a, b in zip(*frames):
        assert a.shape == (360, 640, 3) and a.dtype == np.uint8   # decider
        np.testing.assert_array_equal(a, b)


def test_viewer_without_camera_or_detector():
    """Only the power queue: black camera frames, no overlay; the mouse
    callback maps a click to steering angles."""
    cfg = Config.tiny()
    q_power, _, _ = _viewer_queues(cfg, 2)
    disp = viz.ArrayDisplay()
    clicks = []
    v = viz.Viewer(cb=lambda h, vv: clicks.append((h, vv)), window=(160, 90),
                   display=disp)
    v.loop(q_power, _Running(), max_frames=2)
    assert len(disp.frames) == 2
    v._mouse(80, 45)
    assert clicks == [(0.0, 0.0)]


# -- apps.pipeline: camera and tracker stages -----------------------------------

def test_camera_producer_with_array_capture():
    frames = [np.full((8, 8, 3), i, np.uint8) for i in range(5)]
    qv, qy = queue.Queue(maxsize=2), queue.Queue(maxsize=2)
    cp = pipeline.CameraProducer(viz.ArrayCapture(frames), qv, qy,
                                 PipelineMetrics(), fps_limit=200.0)
    cp.start()
    time.sleep(0.2)
    cp.stop()
    cp.join(timeout=2.0)
    assert not cp.is_alive()
    assert not qv.empty() and not qy.empty()
    n, f = qy.get()
    assert f.shape == (8, 8, 3) and n >= 1


class _CountingQueue(queue.Queue):
    """A queue that counts the items the tracker stage takes from it (not
    the ones the camera drops as the oldest)."""

    def __init__(self, maxsize=0):
        super().__init__(maxsize)
        self.taken = 0

    def _get(self):
        if threading.current_thread().name.startswith("tracker"):
            self.taken += 1
        return super()._get()


def test_pipeline_vision_stages():
    """``start_camera`` + ``start_tracker_batched`` on the committed
    detector: every frame the tracker dequeued is processed, the overlays
    carry the scene object, ``report()`` counts the tracker's frames and
    ``stop()`` joins both stages."""
    p = pipeline.Pipeline(Config.tiny(), "lerp", replay_mode=True,
                          device="cpu")
    for q in (p.q_viewer, p.q_yolo, p.q_inference):
        assert q.maxsize == 2
    p.q_yolo = _CountingQueue(maxsize=2)
    det = detect.pretrained_demo_detector(device="cpu")
    cam = p.start_camera(data.SceneCamera((240, 320)), fps_limit=60.0)
    tr = p.start_tracker_batched(det, batch=4)
    items = []
    try:
        while len(items) < 8:
            items.append(p.q_inference.get(timeout=20.0))
    finally:
        p.stop()
    assert not cam.is_alive() and not tr.is_alive()
    assert tr.processed == p.q_yolo.taken > 0
    assert p.report()["tracker_batched"]["processed"] == tr.processed
    nos = [it[0] for it in items]
    assert nos == sorted(nos)
    assert any(it[2][2] > 0.3 for it in items)
    assert p.q_viewer.qsize() > 0


# -- apps.demo sensorfusion -----------------------------------------------------------

def _frame_gen(cfg, stop, n_max=5000):
    rng = np.random.default_rng(5)
    base = (rng.standard_normal((cfg.n_microphones, cfg.n_samples))
            * 0.05).astype(np.float32)
    i = 0
    while not stop.is_set() and i < n_max:
        yield (base * (1.0 + 0.01 * (i % 50))).astype(np.float32)
        i += 1


def _run_demo(port, extra, capsys):
    cfg = Config.tiny().replace(udp_port=port)
    stop = threading.Event()
    streamer.stream_in_background(cfg, _frame_gen(cfg, stop), n_arrays=1,
                                  delay=0.5, rate=cfg.sample_rate / 16)
    t0 = time.time()
    try:
        rc = demo.main(["sensorfusion", "--replay", "--preset", "tiny",
                        "--port", str(port), "--headless", "--device",
                        "cpu", "--backend", "python", "--frames", "6",
                        "--width", "160", "--height", "96", "--out", ""]
                       + extra)
    finally:
        stop.set()
    return rc, capsys.readouterr().out, time.time() - t0


@pytest.mark.parametrize("port,extra", [
    (22151, ["--camera", "-1", "--heatmap-batch", "4", "--tracker-batch",
             "2", "--detector-size", "96", "--detector-width", "0.25"]),
    (22152, ["--camera", "-2", "--heatmap-batch", "1", "--tracker-batch",
             "1"]),
])
def test_demo_sensorfusion_host(port, extra, capsys):
    """``demo sensorfusion --composite host --headless`` on loopback: the
    batched heatmap and tracker stages with a seeded detector on the
    synthetic camera, and the live stages with the committed detector on
    the detectable scene."""
    rc, out, elapsed = _run_demo(port, ["--composite", "host"] + extra,
                                 capsys)
    assert rc == 0, out
    assert "fused rate:" in out and "over 6 composited frames" in out
    assert "metrics:" in out and "latency_p50_ms" in out
    assert ("'tracker_batched'" in out) == ("2" in extra)
    assert elapsed < 120.0


@pytest.mark.parametrize("flag,steps", [
    # the id the case had when --pretrain was the last refused flag
    pytest.param(["--pretrain", "40"], 40, id="flag9-item 11"),
])
def test_demo_sensorfusion_refuses_later_slices(flag, steps, monkeypatch):
    """No argument of ``sensorfusion`` is refused any more: the last one a
    later slice owned, ``--pretrain N`` (the training slice), now trains
    the demo detector N steps through
    ``train.pretrained_demo_detector``.  A stand-in records its
    arguments and stops the demo there; no packet is needed."""
    from zybo_rt_sampler_image_detection_torch.models import train

    def stand_in(**kw):
        raise _Reached("pretrained_demo_detector", kw)

    monkeypatch.setattr(pipeline.Pipeline, "connect", lambda self: 1)
    monkeypatch.setattr(train, "pretrained_demo_detector", stand_in)
    with pytest.raises(_Reached) as hit:
        demo.main(["sensorfusion", "--replay", "--preset", "tiny",
                   "--device", "cpu", "--backend", "python", "--out", ""]
                  + flag)
    assert hit.value.kw["steps"] == steps
    assert str(hit.value.kw["device"]) == "cpu"


class _Reached(Exception):
    """Raised by a stand-in stage: the demo got there with ``kw``."""

    def __init__(self, what, kw):
        super().__init__(what)
        self.what, self.kw = what, kw


@pytest.mark.parametrize("flag,what,key,value", [
    (["--composite", "device"], "DeviceViewer", "batch", 16),
    (["--composite", "fused"], "FusedSensorStage", "batch", 16),
    (["--listen", "time"], "FusedSensorStage", "listen", "time"),
    (["--listen", "mvdr"], "FusedSensorStage", "listen", "mvdr"),
    (["--composite", "device", "--heatmap-rate", "100"],
     "start_heatmap_batched", "max_rate", 100.0),
    (["--mic-batch", "64"], "FusedSensorStage", "mic_batch", 64),
    (["--composite-batch", "16"], "FusedSensorStage", "batch", 16),
    (["--transfer", "f16"], "FusedSensorStage", "transfer", "f16"),
    (["--display-transport", "yuv420"], "FusedSensorStage",
     "display_transport", "yuv420"),
])
def test_demo_sensorfusion_accepts_ported_flags(flag, what, key, value,
                                                monkeypatch):
    """Each argument this slice ported is accepted and its value reaches
    the stage it configures: the fused stage, the device viewer, or the
    batched heatmap stage's throttle.  Stand-ins record the arguments and
    stop the demo there; no packet is needed (``connect`` is a stand-in
    too)."""
    from zybo_rt_sampler_image_detection_torch.apps import fused
    from zybo_rt_sampler_image_detection_torch.fusion import composite

    seen = {}

    def reach(name):
        def stand_in(*args, **kw):
            raise _Reached(name, kw)
        return stand_in

    def heatmap_batched(self, **kw):
        seen["start_heatmap_batched"] = kw

    monkeypatch.setattr(pipeline.Pipeline, "connect", lambda self: 1)
    monkeypatch.setattr(pipeline.Pipeline, "start_heatmap_batched",
                        heatmap_batched)
    monkeypatch.setattr(fused, "FusedSensorStage", reach("FusedSensorStage"))
    monkeypatch.setattr(composite, "DeviceViewer", reach("DeviceViewer"))
    with pytest.raises(_Reached) as hit:
        demo.main(["sensorfusion", "--replay", "--preset", "tiny",
                   "--device", "cpu", "--backend", "python", "--out", "",
                   "--detector-size", "64", "--detector-width", "0.25"]
                  + flag)
    kw = seen.get(what, hit.value.kw if hit.value.what == what else {})
    assert kw.get(key) == value, (hit.value.what, kw)


def test_demo_sensorfusion_out_needs_cv2(monkeypatch):
    monkeypatch.setattr(imaging, "_HAS_CV2", False)
    with pytest.raises(SystemExit, match="needs cv2"):
        demo.main(["sensorfusion", "--replay", "--preset", "tiny",
                   "--device", "cpu", "--out", "x.mp4"])
