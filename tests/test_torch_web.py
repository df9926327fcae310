"""The port's MJPEG web monitor (``apps/web.py``) on the CPU, at
``Config.tiny()`` with ``device="cpu"``: one test for each web test of
the JAX package's ``tests/test_pipeline.py`` (the same requests, status
codes, JSON keys and JPEG markers), the NumPy JPEG encoder with cv2 and
Pillow hidden (decoded by Pillow: SOI/EOI markers, PSNR >= 30 dB on a
camera frame and on a composite), the fused stages' bulk ``show_batch``
handover, an RSS-plateau soak and ``demo web`` on loopback.
UDP ports 22174-22179 and 22182-22186."""

import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from zybo_rt_sampler_image_detection_tpu.apps import web as jweb
from zybo_rt_sampler_image_detection_tpu.config import Config as JConfig
from zybo_rt_sampler_image_detection_torch.apps import fused, web
from zybo_rt_sampler_image_detection_torch.apps.pipeline import (
    BatchedMisoProducer)
from zybo_rt_sampler_image_detection_torch.config import Config
from zybo_rt_sampler_image_detection_torch.fusion.composite import (
    DeviceCompositor, DeviceViewer)
from zybo_rt_sampler_image_detection_torch.ingest import streamer
from zybo_rt_sampler_image_detection_torch.ingest.receiver import Receiver
from zybo_rt_sampler_image_detection_torch.models import detect, yolo
from zybo_rt_sampler_image_detection_torch.ops import beamform, geometry
from zybo_rt_sampler_image_detection_torch.utils import imaging, jpeg
from zybo_rt_sampler_image_detection_torch.utils.metrics import (
    PipelineMetrics)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG_PSNR_DB = 30.0
# the soak: seconds in all, the warm-up its growth is measured after,
# and the largest growth of VmRSS allowed after it
SOAK_S, SOAK_WARMUP_S, SOAK_GROWTH_MB = 20.0, 6.0, 48.0


def _source_frames(cfg, tx, ty, n=30, seed=3):
    """A source at grid cell (tx, ty): the JAX test's ``_source_frames``."""
    delays = geometry.calculate_delays(cfg)
    active, _ = geometry.active_microphones(cfg)
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(cfg.n_samples * 3).astype(np.float32) * 0.05
    lag = (delays[tx, ty].max() - delays[tx, ty]).round().astype(int)
    fr = np.zeros((cfg.n_microphones, cfg.n_samples), np.float32)
    for i, m in enumerate(active):
        s = cfg.n_samples - lag[i]
        fr[m] = base[s:s + cfg.n_samples]
    return [fr] * n


def _stream(cfg, n, delay=0.5, rate_x=2.0):
    return streamer.stream_in_background(
        cfg, _source_frames(cfg, 4, 3, n=n), n_arrays=1, delay=delay,
        exact_reference=False, rate=rate_x * cfg.sample_rate)


class _Serving:
    """A port server on a free HTTP port, served from a thread."""

    def __init__(self, cfg, **kw):
        self.server = web.make_server(cfg, replay=True, port=0,
                                      headless_camera=True, device="cpu",
                                      **kw)
        self.cam = self.server.camera
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def url(self, path):
        return f"http://127.0.0.1:{self.port}{path}"

    def get(self, path, timeout=30):
        return urllib.request.urlopen(self.url(path), timeout=timeout).read()

    def metrics(self):
        return json.loads(self.get("/metrics", timeout=5))

    def close(self):
        try:
            self.get("/disconnect", timeout=30)
        finally:
            self.server.shutdown()
            self.server.server_close()
            self.cam.stop()


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10.0 * np.log10(255.0 ** 2 / mse)


def _decode(buf: bytes) -> np.ndarray:
    """JPEG -> (H, W, 3) uint8 BGR, by Pillow."""
    return np.asarray(Image.open(io.BytesIO(buf)).convert("RGB"))[..., ::-1]


def _vmrss_kb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    raise RuntimeError("no VmRSS in /proc/self/status")


def test_web_server_routes():
    cfg = Config.tiny().replace(udp_port=22174)
    _stream(cfg, 200, delay=0.3)
    s = _Serving(cfg)
    try:
        html = s.get("/").decode()
        assert "enableBackend1" in html and "/monitor" in html
        s.get("/enableBackend1?threshold=0.1&amount=0.4")
        assert s.cam.threshold == pytest.approx(0.1)
        assert s.cam.amount == pytest.approx(0.4)
        assert s.cam.pipeline is not None
        # the MJPEG stream delivers at least one JPEG frame
        req = urllib.request.urlopen(s.url("/monitor"), timeout=15)
        assert req.headers["Content-Type"] == \
            "multipart/x-mixed-replace; boundary=frame"
        data = req.read(40000)
        assert b"\xff\xd8" in data           # JPEG SOI marker
        req.close()
        s.get("/disconnect")
        assert s.cam.pipeline is None
    finally:
        s.close()


def test_web_sound_route():
    """/sound starts the pad backend plus the MISO audio stage."""
    cfg = Config.tiny().replace(udp_port=22175)
    _stream(cfg, 300, delay=0.3)
    s = _Serving(cfg)
    try:
        s.get("/sound")
        assert s.cam.pipeline is not None
        assert s.cam.pipeline._miso is not None
        time.sleep(0.5)
        assert s.cam.pipeline._miso.sink.frames > 0
    finally:
        s.close()


def test_web_adaptive_sound_route():
    """/sound?beam=mvdr starts the gapless batched MVDR listening stage:
    its beam_fn is the stateful streaming-MVDR closure, audio flows, and
    /metrics reports the stage with its latency contract."""
    cfg = Config.tiny().replace(udp_port=22176)
    _stream(cfg, 3000)
    s = _Serving(cfg)
    try:
        s.get("/sound?beam=mvdr", timeout=60)
        p = s.cam.pipeline
        assert p is not None
        miso = p._miso
        assert isinstance(miso, BatchedMisoProducer)
        assert getattr(miso.beam_fn, "reset", None) is not None
        deadline = time.time() + 15
        while time.time() < deadline and miso.sink.frames == 0:
            time.sleep(0.2)
        assert miso.sink.frames > 0
        rep = s.metrics()
        assert rep["backend"] == "pad"          # the imaging half stays pad
        assert rep["running"] is True
        stage = rep["pipeline"]["miso_batched"]
        assert stage["processed"] > 0
        assert "audio_e2e_p50_ms" in stage
    finally:
        s.close()


def test_web_fullrate_optin():
    """?fullrate=1 swaps in the batched full-rate heatmap stage and
    /metrics gains its processed/skipped accounting."""
    cfg = Config.tiny().replace(udp_port=22177)
    _stream(cfg, 3000)
    s = _Serving(cfg)
    try:
        s.get("/enableBackend1?fullrate=1", timeout=60)
        deadline = time.time() + 15
        stage = {}
        while time.time() < deadline:
            stage = s.metrics().get("pipeline", {}).get("heatmap_batched",
                                                         {})
            if stage.get("processed", 0) > 0:
                break
            time.sleep(0.3)
        assert stage.get("processed", 0) > 0
        assert "skipped" in stage
    finally:
        s.close()


def test_web_fused_optin():
    """?fused=1 backs the MJPEG stream with FusedSensorStage composites
    and /metrics exposes the cycle's phase breakdown."""
    cfg = Config.tiny().replace(udp_port=22178)
    _stream(cfg, 3000)
    s = _Serving(cfg)
    # hermetic: a tiny untrained detector instead of the committed one
    s.cam.detector_factory = lambda: detect.YoloDetector(
        cfg=yolo.YoloConfig(input_size=64, width_mult=0.25), device="cpu")
    try:
        s.get("/enableBackend1?fused=1", timeout=120)
        assert s.cam._fused_stage is not None
        deadline = time.time() + 20
        rep = {}
        while time.time() < deadline:
            rep = s.metrics()
            if rep.get("fused", {}).get("frames", 0) > 0:
                break
            time.sleep(0.3)
        assert rep.get("fused", {}).get("frames", 0) > 0
        assert "phase_p50_ms" in rep["fused"]
        req = urllib.request.urlopen(s.url("/monitor"), timeout=15)
        data = req.read(40000)
        assert b"\xff\xd8" in data
        req.close()
    finally:
        s.close()


def test_web_replay_selection(tmp_path):
    """/replay lists captures and streaming one feeds the live pipeline."""
    cfg = Config.tiny().replace(udp_port=22179)
    sig = np.concatenate([_source_frames(cfg, 5, 4, n=1)[0]] * 60, axis=1)
    np.save(tmp_path / "cap.npy", sig)
    s = _Serving(cfg, capture_dir=str(tmp_path))
    try:
        assert "cap.npy" in s.get("/replay").decode()
        assert "replaying cap.npy" in s.get("/replay?file=cap.npy").decode()
        s.get("/enableBackend1")
        deadline = time.time() + 10
        while time.time() < deadline:
            p = s.cam.pipeline
            if p is not None and p.receiver.native_stats.frames > 0:
                break
            time.sleep(0.2)
        assert s.cam.pipeline.receiver.native_stats.frames > 0
    finally:
        s.close()


def test_web_rejects_malformed_slider():
    """A malformed threshold/amount gets a 400, starts no backend and
    leaves the state untouched (neither of two sliders applies)."""
    s = _Serving(Config.tiny().replace(udp_port=22182))
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            s.get("/enableBackend1?threshold=abc", timeout=10)
        assert exc.value.code == 400
        assert s.cam.pipeline is None
        assert s.cam.threshold == 0.0
        with pytest.raises(urllib.error.HTTPError):
            s.get("/enableBackend1?threshold=0.7&amount=xyz", timeout=10)
        assert s.cam.threshold == 0.0
    finally:
        s.close()


def test_web_mvdr_backend():
    """Backend 4: the route starts a pipeline whose power_fn is the
    streaming Capon map, and /metrics reports it."""
    cfg = Config.tiny().replace(udp_port=22183)
    _stream(cfg, 3000)
    s = _Serving(cfg)
    try:
        s.get("/enableBackend4")
        rep = s.metrics()
        assert rep["backend"] == "mvdr"
        assert rep["running"] is True
        assert s.cam.pipeline._power_fn is not None
        assert getattr(s.cam.pipeline._power_fn, "reset", None) is not None
    finally:
        s.close()


def test_web_metrics_and_hardened_routes():
    """/metrics returns the JAX monitor's JSON keys and names the JPEG
    encoder; malformed backend paths get 404 in both packages; /replay
    escapes untrusted file names."""
    cfg = Config.tiny().replace(udp_port=22184)
    s = _Serving(cfg)
    jserver = jweb.make_server(
        JConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}),
        replay=True, port=0, headless_camera=True)
    jport = jserver.server_address[1]
    threading.Thread(target=jserver.serve_forever, daemon=True).start()
    try:
        rep = s.metrics()
        jrep = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{jport}/metrics", timeout=5).read())
        assert rep["running"] is False
        assert rep["backend"] in ("pad", "none")
        assert "overlay_errors" in rep
        assert set(rep) == set(jrep) | {"jpeg"}
        assert rep["jpeg"] in ("cv2", "pil", "numpy")
        for bad in ("/enableBackendFoo", "/enableBackend9", "/nothing"):
            for port in (s.port, jport):
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(f"http://127.0.0.1:{port}{bad}",
                                           timeout=5)
                assert ei.value.code == 404
        evil = "<script>alert(1)</script>.npy"
        body = s.get("/replay?file=" + urllib.parse.quote(evil)).decode()
        assert "<script>" not in body
        assert "&lt;script&gt;" in body
    finally:
        jserver.shutdown()
        jserver.server_close()
        s.close()


def test_make_server_defaults_to_the_card():
    """The monitor runs on the card unless ``device="cpu"``: without a GPU
    the default raises when the server is made, not at its first route."""
    if torch.cuda.is_available():
        server = web.make_server(Config.tiny(), port=0)
        assert server.camera.device.type == "cuda"
        server.server_close()
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            web.make_server(Config.tiny(), port=0)


# -- the JPEG encoder ---------------------------------------------------------

def _hide_codecs(monkeypatch):
    """cv2 and Pillow hidden: importing either raises ImportError."""
    for name in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)


def _composite(cfg):
    """A display-ready composite of the device compositor (CPU): a source
    heatmap over a camera frame, with one track box."""
    rng = np.random.default_rng(5)
    power = np.zeros((1, cfg.max_res_x, cfg.max_res_y), np.float32)
    power[0, 4, 3] = 1.0
    ok, cam = web.SyntheticCamera((120, 160)).read()
    comp = DeviceCompositor((cfg.max_res_x, cfg.max_res_y), (120, 160),
                            window=(160, 120), yolo_shape=(120, 160),
                            max_tracks=2, threshold=0.0, device="cpu")
    boxes = np.full((1, 2, 5), -100.0, np.float32)
    boxes[0, 0] = [20, 20, 80, 70, 1]
    out, _, _ = comp(torch.from_numpy(power + 1e-3 * rng.random(
        power.shape, np.float32)), cam[None], boxes, comp.init_prev(),
        count=1)
    return out[0].numpy()


def test_numpy_jpeg_encoder_without_codecs(monkeypatch):
    """With cv2 and Pillow hidden the monitor takes the NumPy encoder, and
    /monitor serves its files.  Decoded by Pillow once it is back, they
    carry SOI and EOI and keep PSNR >= 30 dB on a camera frame, on a
    composite and on the frame /monitor served."""
    cfg = Config.tiny()
    ok, cam = web.SyntheticCamera((480, 720)).read()
    images = (cam, _composite(cfg), cam[:37, :53])
    _hide_codecs(monkeypatch)
    name, enc = web.jpeg_encoder()
    assert name == "numpy" and enc is jpeg.encode
    bufs = [enc(img) for img in images]
    s = _Serving(cfg)
    try:
        assert s.cam.jpeg_name == "numpy"
        assert s.metrics()["jpeg"] == "numpy"
        req = urllib.request.urlopen(s.url("/monitor"), timeout=15)
        data = req.read(60000)
        req.close()
    finally:
        s.close()
    monkeypatch.undo()
    for img, buf in zip(images, bufs):
        assert buf[:2] == b"\xff\xd8" and buf[-2:] == b"\xff\xd9"
        dec = _decode(buf)
        assert dec.shape == img.shape
        assert _psnr(dec, img) >= JPEG_PSNR_DB
    # the first MJPEG part is the server's first camera frame, resized to
    # the window (no backend runs, so no overlay)
    part = data.split(b"\r\n--frame\r\n")[0]
    served = _decode(
        part[part.index(b"\xff\xd8"):part.rindex(b"\xff\xd9") + 2])
    expect = imaging.resize(web.SyntheticCamera().read()[1],
                            (cfg.window_width, cfg.window_height))
    assert served.shape == expect.shape
    assert _psnr(served, expect) >= JPEG_PSNR_DB


def test_jpeg_encoder_prefers_cv2_then_pil(monkeypatch):
    """The encoder order: cv2 where it imports, else Pillow."""
    assert web.jpeg_encoder()[0] == "cv2"
    monkeypatch.setitem(sys.modules, "cv2", None)
    name, enc = web.jpeg_encoder()
    assert name == "pil"
    ok, cam = web.SyntheticCamera((48, 64)).read()
    assert _decode(enc(cam)).shape == cam.shape


# -- the bulk handover --------------------------------------------------------

class _CountingDisplay:
    def __init__(self):
        self.batches = []
        self.shown = 0

    def show(self, img):
        self.shown += 1

    def show_batch(self, comps):
        self.batches.append(len(comps))


def test_show_batch_once_a_batch():
    """FusedSensorStage and DeviceViewer hand each batch's composites to a
    display with ``show_batch`` once, and call no per-frame ``show``."""
    cfg = Config.tiny()
    tables = beamform.make_tables(cfg, "lerp", cache=False, device="cpu")
    det = detect.YoloDetector(cfg=yolo.YoloConfig(input_size=64,
                                                  width_mult=0.25),
                              device="cpu")
    comp = DeviceCompositor((cfg.max_res_x, cfg.max_res_y), (48, 64),
                            window=(80, 48), yolo_shape=(48, 64),
                            max_tracks=4, device="cpu")
    disp = _CountingDisplay()
    import queue
    stage = fused.FusedSensorStage(
        Receiver(cfg, replay_mode=True), tables, comp, det, queue.Queue(),
        disp, PipelineMetrics(), batch=3)
    rng = np.random.default_rng(2)
    for n in (3, 2):
        mic = (rng.standard_normal((3, cfg.n_microphones, cfg.n_samples))
               * 0.1).astype(np.float32)
        cams = rng.integers(0, 255, (3, 48, 64, 3)).astype(np.uint8)
        t0 = time.perf_counter()
        launched = stage._launch(mic, cams, n)
        stage._finish((launched, n, list(cams[:n]), [t0] * n, t0, 0, None))
    assert disp.batches == [3, 2] and disp.shown == 0

    grid = (cfg.max_res_x, cfg.max_res_y)
    comp2 = DeviceCompositor(grid, (48, 64), window=(80, 48),
                             yolo_shape=(48, 64), device="cpu")
    disp2 = _CountingDisplay()
    dv = DeviceViewer(comp2, disp2, batch=4)
    q_power, q_viewer, q_inference = (queue.Queue() for _ in range(3))
    for i in range(7):
        q_power.put((rng.random(grid).astype(np.float32), i))
        q_viewer.put((i, rng.integers(0, 255, (48, 64, 3)).astype(
            np.uint8)))
        q_inference.put((i, np.zeros((48, 64, 3), np.uint8), 0.0))
    dv.loop(q_power, True, q_viewer=q_viewer, q_inference=q_inference,
            max_frames=7)
    assert disp2.batches == [4, 3] and disp2.shown == 0
    assert dv.frames == 7


# -- memory -------------------------------------------------------------------

def test_web_soak_rss_plateau():
    """A line-rate stream into the live pad backend with one /monitor
    client reading for SOAK_S seconds: VmRSS grows by less than
    SOAK_GROWTH_MB after the first SOAK_WARMUP_S (a leak of the JAX
    server's rate, 7.5 MB/s, would add about 100 MB), every queue stays
    bounded, and the handled requests leave no thread behind."""
    cfg = Config.tiny().replace(udp_port=22185)
    frames = int((SOAK_S + 4.0) * cfg.sample_rate / cfg.n_samples)
    _stream(cfg, frames, delay=0.3, rate_x=1.0)
    s = _Serving(cfg)
    stop = threading.Event()
    got = [0]

    def client():
        req = urllib.request.urlopen(s.url("/monitor"), timeout=15)
        try:
            while not stop.is_set():
                got[0] += req.read(8192).count(b"\r\n--frame\r\n")
        finally:
            req.close()

    try:
        s.get("/enableBackend1")
        threads_before = threading.active_count()
        reader = threading.Thread(target=client, daemon=True)
        reader.start()
        t0 = time.time()
        rss = []
        while time.time() - t0 < SOAK_S:
            time.sleep(1.0)
            rss.append((time.time() - t0, _vmrss_kb()))
            s.metrics()                   # a finished request a second
        stop.set()
        reader.join(timeout=10)
        assert not reader.is_alive()
        base = min(kb for t, kb in rss if t >= SOAK_WARMUP_S)
        growth_mb = (rss[-1][1] - base) / 1024
        assert growth_mb < SOAK_GROWTH_MB, rss
        assert got[0] > 10 * SOAK_S        # frames kept flowing
        p = s.cam.pipeline
        assert all(q.maxsize > 0 for q in (p.q_power, p.q_viewer, p.q_yolo,
                                           p.q_inference))
        assert threading.active_count() <= threads_before + 1
    finally:
        stop.set()
        s.close()


# -- demo web -----------------------------------------------------------------

def test_demo_web_serves_metrics():
    """``demo web --device cpu --preset tiny`` starts, prints its port
    and answers /metrics on loopback (no backend running yet)."""
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "zybo_rt_sampler_image_detection_torch.apps.demo",
         "web", "--replay", "--device", "cpu", "--preset", "tiny",
         "--port", "22186", "--http-port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        rep = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read())
        assert rep["running"] is False and rep["jpeg"] == "cv2"
    finally:
        proc.terminate()
        proc.wait(timeout=10)
