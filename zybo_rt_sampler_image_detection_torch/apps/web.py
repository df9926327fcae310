"""Web application: MJPEG monitor with switchable beamformer backends.

Re-implements the reference Django app (``PC/application``) on the stdlib
``http.server`` with route parity (``application/urls.py:24-35``):

* ``/``                 — landing page with backend links + sliders
* ``/enableBackend1``   — pad delay-and-sum backend  (``views.py:49-55``)
* ``/enableBackend2``   — convolve backend
* ``/enableBackend3``   — FFT-domain backend         (``camera.py:68-73``)
* ``/enableBackend4``   — real-time MVDR backend (beyond the reference:
                          streaming-inverse Capon, see ``ops/freq``)
* ``/sound``            — pad + steered MISO audio   (``views.py``);
                          ``?beam=mvdr`` the adaptive gapless beam
* ``/monitor``          — multipart/x-mixed-replace MJPEG stream
                          (``camera.py:129-133`` gen)
* ``/replay``           — capture selection page
                          (``templates/replay_selection.html`` parity):
                          lists ``*.npy``/``*.pcap`` in the capture dir
                          and streams the chosen one to loopback
* ``/disconnect``       — stop producers and the receiver
* ``/metrics``          — JSON health snapshot (per-stage rate/latency/
                          drops, ingest gap counters, overlay errors, the
                          JPEG encoder; with ``?fused=1`` active, the fused
                          cycle's phase breakdown)

``?fullrate=1`` on an imaging backend beamforms EVERY frame (batched
stage); ``?fused=1`` serves the MJPEG stream from the fused display cycle
(``apps/fused.py``: steered power + YOLO + composite as one device
program per batch); the fft and mvdr backends stay on the host overlay.
Threshold/amount come from GET query params like the reference's sliders
(``views.py:20-30``); the heatmap overlay uses the same EMA blend
(``camera.py:76-104`` handle_image).

Frames are JPEG-encoded by cv2, else Pillow, else the port's NumPy
baseline encoder (:mod:`..utils.jpeg`); a server fixes its encoder when it
is made and names it in ``/metrics`` (``"jpeg"``).  Memory stays bounded:
the queues between the stages and the handler hold at most a few items,
``/replay`` runs one streamer at a time, and the server keeps no finished
request thread.

The pipeline runs on the card unless ``make_server(..., device="cpu")``.
Ported from ``zybo_rt_sampler_image_detection_tpu/apps/web.py``.
"""

from __future__ import annotations

import html
import json
import logging
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, quote, urlparse

import numpy as np

from ..config import Config
from ..ops.beamform import resolve_device
from ..utils import imaging, viz
from .pipeline import Pipeline

_log = logging.getLogger(__name__)

_PAGE = """<!doctype html><html><head><title>zybo-rt</title></head>
<body style="font-family:sans-serif">
<h2>zybo-rt — acoustic camera</h2>
<p>backend: <b>{backend}</b> | threshold {threshold} | amount {amount}</p>
<p>
 <a href="/enableBackend1?threshold={threshold}&amount={amount}">pad</a> |
 <a href="/enableBackend2?threshold={threshold}&amount={amount}">convolve</a> |
 <a href="/enableBackend3?threshold={threshold}&amount={amount}">fft</a> |
 <a href="/enableBackend4?threshold={threshold}&amount={amount}">mvdr</a> |
 <a href="/enableBackend1?threshold={threshold}&amount={amount}&fullrate=1">pad full-rate</a> |
 <a href="/enableBackend1?fused=1">fused cycle</a> |
 <a href="/sound?threshold={threshold}&amount={amount}">pad + sound</a> |
 <a href="/sound?threshold={threshold}&amount={amount}&beam=mvdr">adaptive sound</a> |
 <a href="/replay">replay</a> |
 <a href="/disconnect">disconnect</a>
</p>
<form action="{action}" method="get">
 threshold <input type="range" name="threshold" min="0" max="1" step="0.01"
   value="{threshold}">
 amount <input type="range" name="amount" min="0" max="1" step="0.01"
   value="{amount}">
 <input type="submit" value="apply">
</form>
<img src="/monitor" style="max-width:90%">
</body></html>"""

_BACKENDS = {1: "pad", 2: "convolve", 3: "fft", 4: "mvdr"}

_REPLAY_PAGE = """<!doctype html><html><body style="font-family:sans-serif">
<h2>replay a capture</h2><p>{status}</p><ul>{items}</ul>
<p><a href="/">back</a></p></body></html>"""

# seconds a rendered frame is served again to other /monitor clients
_FRAME_CACHE_S = 0.03


class SyntheticCamera:
    """Headless camera stand-in: moving gradient frames."""

    def __init__(self, size=(480, 640)):
        self.size = size
        self.i = 0

    def read(self):
        h, w = self.size
        self.i += 1
        x = np.linspace(0, 255, w, dtype=np.float32)[None, :]
        y = np.linspace(0, 255, h, dtype=np.float32)[:, None]
        img = np.stack([np.broadcast_to((x + self.i * 3) % 256, (h, w)),
                        np.broadcast_to(y, (h, w)),
                        np.full((h, w), 64, np.float32)], axis=-1)
        return True, img.astype(np.uint8)


def jpeg_encoder() -> tuple:
    """``(name, encode)``: cv2 where it imports, else Pillow, else the
    NumPy baseline encoder; ``encode((H, W, 3) uint8 BGR) -> bytes``."""
    try:
        import cv2

        def enc_cv2(img):
            ok, buf = cv2.imencode(".jpg", img)
            if not ok:
                raise RuntimeError("cv2.imencode failed")
            return buf.tobytes()

        return "cv2", enc_cv2
    except ImportError:
        pass
    try:
        import io

        from PIL import Image

        def enc_pil(img):
            b = io.BytesIO()
            Image.fromarray(np.ascontiguousarray(img[..., ::-1])).save(
                b, "JPEG")
            return b.getvalue()

        return "pil", enc_pil
    except ImportError:
        pass
    from ..utils import jpeg

    return "numpy", jpeg.encode


class VideoCamera:
    """Owns the pipeline + camera and renders monitor frames
    (``camera.py:16-133`` VideoCamera).  ``device``: where the pipeline
    runs (the card unless ``"cpu"``; without a GPU ``"cuda"`` raises
    here, before the server serves)."""

    def __init__(self, cfg: Config, replay: bool, headless_camera: bool,
                 camera_src=0, device="cuda"):
        self.cfg = cfg
        self.replay = replay
        self.device = resolve_device(device)
        self.threshold = 0.0
        self.amount = 0.5
        self.backend = 1
        self.pipeline: Pipeline | None = None
        self.camera = (SyntheticCamera() if headless_camera
                       else viz._CvCapture(camera_src))
        self.jpeg_name, self._encode = jpeg_encoder()
        self._prev_heat = None
        self._lock = threading.Lock()
        # frame rendering has its own lock: start() holds _lock for
        # seconds (connect + kernel builds) and the MJPEG streams must not
        # block on it
        self._frame_lock = threading.Lock()
        self._last_jpeg = None
        self._last_jpeg_t = 0.0
        self.overlay_errors = 0
        self.last_overlay_error = ""
        # ?fused=1 state: the MJPEG stream serves FusedSensorStage
        # composites (display-ready uint8) instead of the host overlay
        self._fused_stage = None
        self._fused_display = None
        # injectable for hermetic tests; the default loads the committed
        # demo detector (models/assets), which does not train
        self.detector_factory = None

    # -- backend lifecycle (views.py:32-98 semantics) -------------------------

    def start(self, backend: int, sound: bool = False,
              sound_beam: str = "time", fullrate: bool = False,
              fused: bool = False):
        with self._lock:
            self._stop_locked()
            algo = _BACKENDS.get(backend, "pad")
            if fused and algo in ("fft", "mvdr"):
                # the fused cycle runs the time-domain backend policy:
                # the fft/mvdr imaging backends stay on the host overlay
                fused = False
            # the fft and mvdr routes listen through pad tables
            p = Pipeline(self.cfg, algorithm=algo, replay_mode=self.replay,
                         audio_sink="null", device=self.device,
                         listen_algorithm="pad")
            p.connect()
            if fused:
                self._start_fused_locked(p)
            elif fullrate:
                # every frame beamformed by the batched stage; its default
                # sink publishes the newest map of a batch to q_power for
                # the overlay, and /metrics gains processed/skipped
                p.start_heatmap_batched()
            else:
                p.start_heatmap()
            if sound:
                if sound_beam == "mvdr":
                    # adaptive listening: the gapless batched MVDR beam
                    p.start_miso_batched(beam="mvdr")
                else:
                    p.start_miso()
            self.pipeline = p
            self.backend = backend

    def _start_fused_locked(self, p: Pipeline, batch: int = 8):
        from ..fusion.composite import DeviceCompositor
        from .fused import FusedSensorStage

        ok, probe = self.camera.read()
        cam_hw = probe.shape[:2] if ok else (480, 640)
        if self.detector_factory is not None:
            det = self.detector_factory()
        else:
            from ..models.detect import pretrained_demo_detector
            det = pretrained_demo_detector(device=self.device)
        p.q_yolo = queue.Queue(maxsize=2 * batch)
        p.start_camera(self.camera, fps_limit=30.0)
        grid = (self.cfg.max_res_x, self.cfg.max_res_y)
        comp = DeviceCompositor(
            grid, cam_hw,
            window=(self.cfg.window_width, self.cfg.window_height),
            yolo_shape=cam_hw, max_tracks=8, device=self.device)
        display = _LatestComposite()
        stage = FusedSensorStage(
            p.receiver, p.tables, comp, det, p.q_yolo, display,
            p.metrics, batch=batch, channels=p.connected_channels,
            steer_cb=lambda h, v: p.steer_cartesian_degree(h, v))
        stage.warmup()
        p.run_stage(stage)
        self._fused_stage = stage
        self._fused_display = display

    def stop(self):
        with self._lock:
            self._stop_locked()

    def _stop_locked(self):
        if self.pipeline is not None:
            self.pipeline.stop()
            self.pipeline = None
        self._fused_stage = None
        self._fused_display = None
        # a new backend must not EMA-blend with the old backend's last
        # heatmap (ghost hotspots, possibly minutes stale)
        self._prev_heat = None

    # -- frame rendering ------------------------------------------------------

    def get_frame(self) -> bytes:
        """camera frame + EMA heatmap overlay -> JPEG (handle_image,
        ``camera.py:76-104``).

        Serialized and briefly cached: each /monitor client runs its own
        loop against this SHARED camera, so without the lock concurrent
        clients race on camera.read()/_prev_heat, and without the cache
        they steal q_power maps from each other."""
        with self._frame_lock:
            now = time.monotonic()
            if (self._last_jpeg is not None
                    and now - self._last_jpeg_t < _FRAME_CACHE_S):
                return self._last_jpeg
            jpeg = self._render_frame()
            self._last_jpeg, self._last_jpeg_t = jpeg, time.monotonic()
            return jpeg

    def _render_frame(self) -> bytes:
        disp = self._fused_display
        if disp is not None:
            comp = disp.latest
            if comp is not None:
                return self._encode(comp)   # display-ready device composite
            self.overlay_errors += 1
            self.last_overlay_error = "fused stage produced nothing yet"
        ok, frame = self.camera.read()
        if not ok:
            frame = np.zeros((480, 640, 3), np.uint8)
        frame = imaging.resize(frame, (self.cfg.window_width,
                                       self.cfg.window_height))
        p = self.pipeline
        if p is not None:
            try:
                power, _ = p.q_power.get(timeout=0.5)
            except queue.Empty:
                # the pipeline produced nothing this tick: a camera-only
                # frame, visible in /metrics as overlay starvation
                self.overlay_errors += 1
                self.last_overlay_error = "q_power empty (pipeline stalled?)"
                return self._encode(frame)
            try:
                heat, should = viz.calculate_heatmap(
                    np.asarray(power), threshold=self.threshold,
                    amount=self.amount,
                    window=(self.cfg.window_width, self.cfg.window_height))
                if self._prev_heat is not None:
                    heat = imaging.add_weighted(self._prev_heat, 0.5,
                                                heat, 0.5)
                self._prev_heat = heat
                if should:
                    frame = imaging.add_weighted(frame, 0.9, heat, 0.9)
            except Exception as e:        # noqa: BLE001 — counted, served
                self.overlay_errors += 1
                self.last_overlay_error = repr(e)
                _log.warning("heatmap overlay failed: %r", e)
        return self._encode(frame)

    def metrics(self) -> dict:
        """Health/metrics snapshot for the /metrics endpoint."""
        rep = {"backend": _BACKENDS.get(self.backend, "none"),
               "running": self.pipeline is not None,
               "threshold": self.threshold, "amount": self.amount,
               "overlay_errors": self.overlay_errors,
               "last_overlay_error": self.last_overlay_error,
               "jpeg": self.jpeg_name}
        p = self.pipeline
        if p is not None:
            rep["pipeline"] = p.report()
        stage = self._fused_stage
        if stage is not None:
            # the fused cycle's own accounting: frames, e2e latency,
            # per-leg phase breakdown (which leg bottlenecks)
            rep["fused"] = stage.report()
        return rep


class _LatestComposite:
    """Display adapter for the fused stage: keeps the newest composite
    for the MJPEG generator (drop-everything-but-latest semantics, the
    reference monitor's behavior, ``camera.py:129-133``)."""

    def __init__(self):
        self.latest = None

    def show(self, img):
        self.latest = np.ascontiguousarray(img)

    def show_batch(self, comps):
        if len(comps):
            self.latest = np.ascontiguousarray(comps[-1])


class _Replays:
    """At most one capture streamer at a time (``/replay``)."""

    def __init__(self, cfg: Config, capture_dir: str):
        self.cfg = cfg
        self.capture_dir = capture_dir
        self._lock = threading.Lock()
        self._thread = None

    def list(self) -> list:
        import glob
        return sorted(os.path.basename(p) for pat in ("*.npy", "*.pcap")
                      for p in glob.glob(os.path.join(self.capture_dir,
                                                      pat)))

    def start(self, name: str) -> str:
        """Stream a capture to loopback in the background (the reference's
        udpreplay flow behind replay_selection.html)."""
        from ..ingest.streamer import Streamer

        path = os.path.join(self.capture_dir, os.path.basename(name))
        if not os.path.exists(path):
            return f"no such capture: {name}"
        cfg = self.cfg

        def run():
            s = Streamer(cfg)
            try:
                if path.endswith(".npy"):
                    s.send_header()
                    s.send_npy(path, rate=cfg.sample_rate)
                else:
                    s.send_pcap(path, realtime=True)
            finally:
                s.close()

        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return "a replay is already running"
            self._thread = threading.Thread(target=run, name="replay",
                                            daemon=True)
            self._thread.start()
        return f"replaying {name} to {cfg.udp_replay_ip}:{cfg.udp_port}"


class _Server(ThreadingHTTPServer):
    # request threads are daemons and are not kept once finished
    daemon_threads = True
    block_on_close = False


def make_server(cfg: Config = None, replay: bool = False, port: int = 8000,
                headless_camera: bool = True, host: str = "127.0.0.1",
                capture_dir: str = ".", device="cuda"):
    """The monitor's HTTP server (not started: call ``serve_forever``);
    ``server.camera`` is its :class:`VideoCamera`."""
    cfg = cfg or Config()
    cam = VideoCamera(cfg, replay, headless_camera, device=device)
    replays = _Replays(cfg, capture_dir)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):                    # quiet
            pass

        def _body(self, code: int, body: bytes, ctype: str = "text/html"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _page(self, action="/"):
            self._body(200, _PAGE.format(
                backend=_BACKENDS.get(cam.backend, "none"),
                threshold=cam.threshold, amount=cam.amount,
                action=action).encode())

        def _sliders(self, q) -> bool:
            """Apply the threshold/amount GET sliders (views.py:20-30).
            Returns False (after sending a 400) on a malformed value, and
            then applies neither: no half-updated state."""
            vals = {}
            for key in ("threshold", "amount"):
                if key in q:
                    try:
                        vals[key] = float(q[key][0])
                    except ValueError:
                        self._body(400, f"bad {key}: {q[key][0]!r}".encode(),
                                   "text/plain")
                        return False
            for key, v in vals.items():
                setattr(cam, key, v)
            return True

        def _monitor(self):
            self.send_response(200)
            self.send_header("Content-Type",
                             "multipart/x-mixed-replace; boundary=frame")
            self.end_headers()
            try:
                while True:
                    jpg = cam.get_frame()
                    self.wfile.write(b"--frame\r\n"
                                     b"Content-Type: image/jpeg\r\n\r\n")
                    self.wfile.write(jpg)
                    self.wfile.write(b"\r\n")
                    time.sleep(_FRAME_CACHE_S)
            except (BrokenPipeError, ConnectionResetError):
                pass

        def do_GET(self):
            u = urlparse(self.path)
            q = parse_qs(u.query)
            if u.path == "/":
                self._page()
            elif u.path.startswith("/enableBackend"):
                try:
                    n = int(u.path[len("/enableBackend"):])
                except ValueError:
                    n = None
                if n not in _BACKENDS:
                    self.send_response(404)
                    self.end_headers()
                    return
                if not self._sliders(q):
                    return
                cam.start(n, fullrate=q.get("fullrate",
                                            ["0"])[0] not in ("0", ""),
                          fused=q.get("fused", ["0"])[0] not in ("0", ""))
                self._page(action=u.path)
            elif u.path == "/sound":
                # ?beam=mvdr: the adaptive (streaming-MVDR) distortionless
                # beam; default the reference's pad + delay-and-sum MISO
                if not self._sliders(q):
                    return
                beam = q.get("beam", ["time"])[0]
                cam.start(1, sound=True,
                          sound_beam="mvdr" if beam == "mvdr" else "time")
                self._page(action="/sound")
            elif u.path == "/replay":
                status = replays.start(q["file"][0]) if "file" in q else ""
                items = "".join(
                    f'<li><a href="/replay?file={quote(f)}">'
                    f'{html.escape(f)}</a></li>'
                    for f in replays.list()) or "<li>(no captures)</li>"
                self._body(200, _REPLAY_PAGE.format(
                    status=html.escape(status), items=items).encode())
            elif u.path == "/disconnect":
                cam.stop()
                self._page()
            elif u.path == "/metrics":
                self._body(200, json.dumps(cam.metrics()).encode(),
                           "application/json")
            elif u.path == "/monitor":
                self._monitor()
            else:
                self.send_response(404)
                self.end_headers()

    server = _Server((host, port), Handler)
    server.camera = cam
    return server


def serve(replay: bool = False, port: int = 8000, udp_port=None,
          headless_camera: bool = True, device="cuda",
          cfg: Config = None):
    """Serve the monitor on ``http://127.0.0.1:port`` until ^C."""
    cfg = cfg or Config()
    if udp_port:
        cfg = cfg.replace(udp_port=udp_port)
    server = make_server(cfg, replay, port, headless_camera, device=device)
    print(f"serving on http://127.0.0.1:{server.server_address[1]}  "
          f"(routes: /, /monitor, /enableBackend1..4, /sound, /replay, "
          f"/disconnect, /metrics; jpeg {server.camera.jpeg_name})",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        server.camera.stop()
