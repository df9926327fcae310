"""The fused sensor-fusion stage: one device program per K-frame batch.

The whole display cycle of the sensor-fusion demo runs on the device in
one program per batch, with one packed host->device copy and one packed
device->host copy::

    mic frames ─┐                                 ┌─> composites (u8)
    camera u8  ─┼─ packed u8 ──> [ steered power  ├─> detections
    track boxes┘   (1 upload)     + YOLO detect   ├─> gating meta
                                  + composite ]   ┘   (1 packed download)

* steered power: the production backend policy
  (``pipeline.power_program``, the full-rate stage's program, so
  the display cannot drift from production; K1 at ``Config()`` lerp
  ``high`` on the card);
* detection: the camera frames resized on the device, then
  ``YoloDetector.program`` (backbone, decode, batched NMS);
* composite: :class:`~..fusion.composite.DeviceCompositor` (log-norm, jet
  LUT, resizes, power box, EMA, decider gating and blends).

The host keeps only O(tracks) work a frame: SORT/hysteresis stepping on
the downloaded detection table, and the decider's ``focus_beam`` steering
callback, on a finisher thread.  Track boxes drawn into the composite are
one batch stale (the tracker consumes batch *i*'s detections while batch
*i+1* composites), the magnitude of the reference's multi-process queue
latency (``main.pyx:669-736``).

With ``listen`` the same program also beams the steered listening
direction over counter-contiguous mic batches (gapless, like the
full-rate listening stage), and the beam rides the packed download.

A port of ``zybo_rt_sampler_image_detection_tpu/apps/fused.py`` (NumPy and
torch only).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..fusion.composite import (DeviceCompositor, _bilinear, _resize_tables,
                                _round_u8_)
from ..fusion.decider import SensorFusionDecider
from ..ops import beamform
from ..utils import imaging
from ..utils.metrics import PipelineMetrics, history
from .pipeline import (AudioLeg, Stage, _pad_full, _rect_conf,
                       power_program)

log = logging.getLogger(__name__)


# BT.601 studio-range pair of the yuv420 display transport: cv2's own I420
# convention (Y = 16 + 0.257R + 0.504G + 0.098B; U/V offset 128 with a
# 0.439 swing; chroma from the top-left pixel of each 2x2, not the mean),
# so a host with cv2 inverts with one cvtColor a frame.  The round trip
# loses chroma resolution and uint8 rounding only, the loss of the 4:2:0
# mp4 the demo writes.
def _bgr_to_i420(comps: torch.Tensor) -> torch.Tensor:
    """(K, H, W, 3) BGR u8 -> (K, H*W + 2*(H//2)*(W//2)) u8 planes in
    cv2's I420 byte order (Y plane, packed U quarter-plane, packed V), on
    the tensor's device."""
    f = comps.float()
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 16.0 + (25.064 * b + 129.057 * g + 65.738 * r) / 256.0
    bs, gs, rs = b[:, ::2, ::2], g[:, ::2, ::2], r[:, ::2, ::2]
    u = 128.0 + (112.439 * bs - 74.494 * gs - 37.945 * rs) / 256.0
    v = 128.0 + (-18.285 * bs - 94.154 * gs + 112.439 * rs) / 256.0
    K = comps.shape[0]
    return torch.cat([_round_u8_(c).to(torch.uint8).reshape(K, -1)
                      for c in (y, u, v)], dim=1)


def _host_bgr_to_i420(frames: np.ndarray) -> np.ndarray:
    """(K, H, W, 3) BGR u8 -> (K, H*3//2, W) u8 I420 on the host (the
    camera upload leg): one cv2.cvtColor a frame, NumPy without cv2."""
    K, h, w, _ = frames.shape
    if imaging._HAS_CV2:
        import cv2
        return np.stack([cv2.cvtColor(frames[i], cv2.COLOR_BGR2YUV_I420)
                         for i in range(K)])
    f = frames.astype(np.float32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 16.0 + (25.064 * b + 129.057 * g + 65.738 * r) / 256.0
    bs, gs, rs = b[:, ::2, ::2], g[:, ::2, ::2], r[:, ::2, ::2]
    u = 128.0 + (112.439 * bs - 74.494 * gs - 37.945 * rs) / 256.0
    v = 128.0 + (-18.285 * bs - 94.154 * gs + 112.439 * rs) / 256.0

    def q(c):
        return np.clip(np.round(c), 0, 255).astype(np.uint8)

    return np.concatenate([q(y).reshape(K, -1), q(u).reshape(K, -1),
                           q(v).reshape(K, -1)], axis=1) \
        .reshape(K, h * 3 // 2, w)


def _dev_i420_to_bgr(planes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(K, H*3//2, W) u8 I420 -> (K, H, W, 3) BGR f32 (integer-valued) on
    the tensor's device: the studio-range inverse of cv2's forward, nearest
    chroma upsample."""
    K = planes.shape[0]
    flat = planes.reshape(K, -1)
    n = h * w
    m = (h // 2) * (w // 2)
    y = flat[:, :n].reshape(K, h, w).float()
    u = flat[:, n:n + m].reshape(K, h // 2, w // 2).float()
    v = flat[:, n + m:].reshape(K, h // 2, w // 2).float()
    u = u.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
    v = v.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
    yl = 1.164 * (y - 16.0)
    b = yl + 2.017 * u
    g = yl - 0.392 * u - 0.813 * v
    r = yl + 1.596 * v
    return _round_u8_(torch.stack([b, g, r], dim=-1))


def _i420_to_bgr(planes: np.ndarray, h: int, w: int) -> np.ndarray:
    """(K, H*W + 2*(H//2)*(W//2)) u8 -> (K, H, W, 3) BGR u8 on the host.
    The plane order is cv2's I420 layout, so each frame converts with one
    ``cv2.cvtColor``; without cv2 the exact float inverse (nearest chroma
    upsample) in NumPy."""
    K = planes.shape[0]
    if imaging._HAS_CV2:
        import cv2
        return np.stack([
            cv2.cvtColor(planes[i].reshape(h * 3 // 2, w),
                         cv2.COLOR_YUV2BGR_I420) for i in range(K)])
    n = h * w
    m = (h // 2) * (w // 2)
    y = planes[:, :n].reshape(K, h, w).astype(np.float32)
    u = planes[:, n:n + m].reshape(K, h // 2, w // 2).astype(np.float32)
    v = planes[:, n + m:].reshape(K, h // 2, w // 2).astype(np.float32)
    u = np.repeat(np.repeat(u, 2, axis=1), 2, axis=2) - 128.0
    v = np.repeat(np.repeat(v, 2, axis=1), 2, axis=2) - 128.0
    yl = 1.164 * (y - 16.0)                        # studio-range inverse
    b = yl + 2.017 * u
    g = yl - 0.392 * u - 0.813 * v
    r = yl + 1.596 * v
    out = np.stack([b, g, r], axis=-1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 view."""
    return t.contiguous().reshape(-1).view(torch.uint8)


class FusedSensorStage(Stage):
    """The sensor-fusion demo as one device program per K-frame batch.

    Host work a batch: pack, upload, launch (no wait); on the finisher
    thread: wait for the packed download, unpack, step SORT/hysteresis a
    frame, display the composites, keep the track boxes for the next
    batch, ``focus_beam`` steering.  Batch *i+1* is collected, uploaded and
    launched while batch *i* downloads.

    ``device`` is the tables' (the compositor and the detector must be on
    it).  Accounting: ``processed`` displayed frames, ``skipped`` ring
    frames the display pass skipped (latest-frame display semantics, not
    an imaging drop), ``latency_ms`` camera-queue -> display a frame,
    ``light``/``conf`` the decider gating scalars of the newest frame,
    ``phase_s`` the host seconds a batch of each leg.
    """

    def __init__(self, receiver, tables, compositor: DeviceCompositor,
                 detector, q_cam: queue.Queue, display,
                 metrics: PipelineMetrics, batch: int = 16,
                 channels: int = 0, steer_cb=None,
                 transfer: str = "f32", display_transport: str = "rgb",
                 tracker_kwargs: Optional[dict] = None,
                 listen: Optional[str] = None, audio_sink=None,
                 mic_batch: int = 0, alpha: float = 0.9):
        super().__init__("fused", metrics)
        if not compositor.max_tracks:
            raise ValueError("FusedSensorStage needs a boxes-mode "
                             "compositor (max_tracks > 0)")
        self.device = tables.device
        for name, obj in (("compositor", compositor), ("detector", detector)):
            if obj.device.type != self.device.type:
                raise ValueError(f"the {name} is on {obj.device}, the "
                                 f"tables on {self.device}")
        if transfer not in ("f32", "f16"):
            raise ValueError(f"unknown transfer {transfer!r}")
        # "f16" halves the mic upload (~1e-3 relative error on the
        # 24-bit-normalized samples: display grade, the same opt-in as
        # BatchedStage(transfer=)); the program upcasts on the device
        self.transfer = transfer
        self._mic_dtype = {"f32": np.float32, "f16": np.float16}[transfer]
        self._mic_torch = {"f32": torch.float32,
                           "f16": torch.float16}[transfer]
        if display_transport not in ("rgb", "yuv420"):
            raise ValueError(f"unknown display_transport "
                             f"{display_transport!r}")
        # "yuv420" moves both video legs (camera upload, composite
        # download) as I420 planes (1.5 B/px against 3): chroma is
        # 2x2-subsampled like the 4:2:0 mp4 the demo writes; "rgb" keeps
        # the pixels byte-exact
        self.display_transport = display_transport
        if display_transport == "yuv420":
            Wd, Hd = compositor.window
            Hc_, Wc_ = compositor.cam_shape
            if Wd % 2 or Hd % 2 or Hc_ % 2 or Wc_ % 2:
                raise ValueError("yuv420 transport needs even "
                                 "window/camera dimensions")
        if listen not in (None, "time", "mvdr"):
            raise ValueError(f"unknown listen backend {listen!r}")
        self.receiver = receiver
        self.tables = tables
        self.comp = compositor
        self.detector = detector
        self.q_cam = q_cam
        self.display = display
        self.batch = int(batch)
        self.channels = int(channels)
        self.steer_cb = steer_cb
        self.processed = 0
        self.skipped = 0
        self.frames = 0
        self.latency_ms = history()
        self.light: Optional[float] = None
        self.conf: Optional[float] = None
        # the finisher's exception, if it died (the stage then stops)
        self.error: Optional[BaseException] = None
        # host seconds a batch of each leg: report() gives the p50s, so a
        # slow run names its leg
        self.phase_s: dict = {k: history() for k in
                              ("collect", "pack", "put", "dispatch",
                               "fetch", "unpack", "track")}

        from ..models.tracking import SmoothedTracker
        self.tracker = SmoothedTracker(detector, **(tracker_kwargs or {}))
        Hc, Wc = compositor.cam_shape
        self.decider = SensorFusionDecider(display_size=(Wc, Hc))
        self._rect_conf = [[0, 0], [0, 0], 0.0]

        # -- embedded listening: the mic batch is uploaded for the display
        # powers anyway; `listen` also beams it and the beam rides the
        # packed download.  The loop then reads counter-contiguous mic
        # batches of ``mic_batch`` (display pairs the cameras with the
        # newest K frames of it), so the audio stream is gapless at line
        # rate like the full-rate listening stage (ring overwrites
        # zero-filled and counted as underruns).  "time" = delay-and-sum
        # through this stage's tables + the reference gain chain
        # (api.c:517-522); "mvdr" = the adaptive distortionless beam, its
        # state and refresh cadence those of make_mvdr_stream.
        # Ref: main.pyx:279-380 (the combined mimo+miso loops).
        self.listen = listen
        self.alpha = alpha
        self.n_full = receiver.cfg.n_microphones
        self.n_samples = receiver.cfg.n_samples
        self.mc = self.channels or self.n_full
        # mic frames a cycle: with listening the cycle drains the ring at
        # line rate while display cycles run at camera pace (default 4x
        # the display batch); display only: one frame a camera frame
        self.Km = (int(mic_batch) or 4 * self.batch) if listen \
            else self.batch
        K, Mc, N, Km = self.batch, self.mc, self.n_samples, self.Km
        T = compositor.max_tracks
        mic_bytes = Km * Mc * N * np.dtype(self._mic_dtype).itemsize
        cam_bytes = (K * Hc * Wc * 3 if display_transport == "rgb"
                     else K * (Hc * 3 // 2) * Wc)
        # f32 parts first: each starts 4-byte aligned in the packed buffer
        self._sizes = dict(mic=mic_bytes, boxes=T * 5 * 4, cams=cam_bytes)

        self.audio = None
        self._mvdr = None
        if listen:
            from ..utils import audio as audio_mod
            cfg = receiver.cfg
            if audio_sink is None:
                audio_sink = audio_mod.NullSink()
            if listen == "time":
                n_mics = tables.n_mics
                post_fn = lambda b: audio_mod.miso_gain(   # noqa: E731
                    b, n_mics, cfg.mic_gain, cfg.norm_factor_sound)
            else:
                from .pipeline import make_mvdr_stream
                # the program runs the step itself; the state dict, the
                # refresh cadence and reset() are make_mvdr_stream's
                self._mvdr = make_mvdr_stream(cfg, "beams", alpha=alpha,
                                              device=self.device)
                post_fn = lambda b: b                      # noqa: E731
            self.audio = AudioLeg(audio_sink, post_fn, self.n_samples)
        # the detector's resize on the device, in the host path's
        # convention (cv2 INTER_LINEAR, or the align-corners fallback)
        S = detector.cfg.input_size
        self._det_tables = _resize_tables((Hc, Wc), (S, S),
                                          imaging._HAS_CV2, self.device)
        self._det_scale = (Wc / S, Hc / S)
        self._power = power_program(tables, self.n_full, self.channels)
        self._prev = None
        self._boxes = np.full((T, 5), -100.0, np.float32)
        self._direction = 0
        self._dir_lock = threading.Lock()
        self._last_cams = np.zeros((K, Hc, Wc, 3), np.uint8)
        Ww, Hw = compositor.window
        md = detector.max_det
        comp_bytes = (K * Hw * Ww * 3 if display_transport == "rgb"
                      else K * (Hw * Ww + 2 * (Hw // 2) * (Ww // 2)))
        self._out_sizes = dict(
            dets=K * md * 5 * 4, cls=K * md * 4,
            meta=K * len(DeviceCompositor.META_FIELDS) * 4,
            beams=Km * N * 4 if listen else 0, mask=K * md,
            comps=comp_bytes)

    # -- device program -------------------------------------------------------

    def _split(self, packed: torch.Tensor):
        """The packed upload's parts as device views: mic (Km, Mc, N),
        track boxes (T, 5), camera frames (K, Hc, Wc, 3) u8 or f32."""
        K, Mc, N, Km = self.batch, self.mc, self.n_samples, self.Km
        Hc, Wc = self.comp.cam_shape
        sz = self._sizes
        o = sz["mic"]
        mic = packed[:o].view(self._mic_torch).view(Km, Mc, N)
        boxes = packed[o:o + sz["boxes"]].view(torch.float32).view(
            self.comp.max_tracks, 5)
        o += sz["boxes"]
        if self.display_transport == "yuv420":
            cams = _dev_i420_to_bgr(
                packed[o:o + sz["cams"]].view(K, Hc * 3 // 2, Wc), Hc, Wc)
        else:
            cams = packed[o:o + sz["cams"]].view(K, Hc, Wc, 3)
        return mic, boxes, cams

    def detector_input(self, cams: torch.Tensor) -> torch.Tensor:
        """The detector's (K, S, S, 3) uint8 input: the camera frames
        resized on the device (bilinear, the host path's convention)."""
        return _round_u8_(_bilinear(cams.float(), self._det_tables)) \
            .to(torch.uint8)

    @torch.no_grad()
    def _run(self, packed: torch.Tensor, d: int, count: int):
        """One batch's device program on the packed upload; returns the
        packed uint8 output and the mvdr state after the batch."""
        K = self.batch
        mic, boxes, cams = self._split(packed)
        # display pairs the camera frames with the NEWEST K mic frames of
        # the (possibly larger, counter-contiguous) listening batch
        powers = self._power(mic[-K:])
        mic_p = _pad_full(mic, self.n_full) if self.listen else None
        beams, lst2 = None, None
        if self.listen == "time":
            beams = beamform.miso_beam(mic_p, self.tables, d)
        elif self.listen == "mvdr":
            from ..ops import freq
            beams, lst2 = freq.mvdr_listen_step(
                self._mvdr.state["p"], mic_p, self._mvdr.tables, d,
                alpha=self.alpha)
        dets, mask, cls_ids = self.detector.program(
            self.detector_input(cams))
        # composite: the same track overlay for every frame of the batch
        # (one-batch-stale boxes change slower than the batch)
        yolos = boxes.expand(K, *boxes.shape)
        comps, self._prev, metas = self.comp._run(powers, cams, yolos,
                                                  self._prev, count)
        if self.display_transport == "yuv420":
            comps = _bgr_to_i420(comps)
        parts = [dets.float(), cls_ids.to(torch.int32), metas.float()]
        if beams is not None:
            parts.append(beams.float())
        parts += [mask.to(torch.uint8), comps]
        return torch.cat([_as_bytes(p) for p in parts]), lst2

    def steer(self, direction: int):
        """Steer the embedded listening beam (``api.c:576-581``): the
        direction of the next launch."""
        with self._dir_lock:
            self._direction = int(direction)

    def _launch(self, mic: np.ndarray, cams: np.ndarray, n: int):
        """Pack, upload and launch one batch; returns (packed output on
        the host, its copy's done event or None) without waiting."""
        t0 = time.perf_counter()
        if self.display_transport == "yuv420":
            cams = _host_bgr_to_i420(cams)
        sz = self._sizes
        total = sz["mic"] + sz["boxes"] + sz["cams"]
        cuda = self.device.type == "cuda"
        buf = torch.empty(total, dtype=torch.uint8, pin_memory=cuda)
        hb = buf.numpy()
        o = sz["mic"]
        hb[:o] = np.ascontiguousarray(mic, self._mic_dtype) \
            .view(np.uint8).reshape(-1)
        hb[o:o + sz["boxes"]] = self._boxes.view(np.uint8).reshape(-1)
        o += sz["boxes"]
        hb[o:] = np.ascontiguousarray(cams).view(np.uint8).reshape(-1)
        if self._prev is None:
            self._prev = self.comp.init_prev()
        with self._dir_lock:
            d = self._direction
        t1 = time.perf_counter()
        packed = buf.to(self.device, non_blocking=True)
        t2 = time.perf_counter()
        out, lst2 = self._run(packed, d, n)
        if self._mvdr is not None:
            # the shared MVDR state machine: commit the post-batch state,
            # then advance its alpha-aware exact-refresh cadence
            self._mvdr.state["p"] = lst2
            self._mvdr.tick(self.Km)
        if cuda:
            host = torch.empty(out.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event(blocking=True)
            done.record()
        else:
            host, done = out, None
        t3 = time.perf_counter()
        self.phase_s["pack"].append(t1 - t0)
        self.phase_s["put"].append(t2 - t1)
        self.phase_s["dispatch"].append(t3 - t2)
        return host, done

    def warmup(self):
        """Build the program's kernels (K1's module among them) before any
        packets flow, then reset an MVDR state the zero batch polluted."""
        Hc, Wc = self.comp.cam_shape
        mic = np.zeros((self.Km, self.mc, self.n_samples), np.float32)
        cams = np.zeros((self.batch, Hc, Wc, 3), np.uint8)
        host, done = self._launch(mic, cams, 1)
        if done is not None:
            done.synchronize()
        self._prev = None
        if self._mvdr is not None:
            self._mvdr.reset()

    # -- host side ------------------------------------------------------------

    def _unpack(self, host_u8: np.ndarray):
        """The packed download -> (comps (K, Hw, Ww, 3) u8, dets (K, md,
        5), mask (K, md) bool, cls_ids (K, md) int32, metas (K, 5), beams
        (Km, N) or None)."""
        K = self.batch
        md = self.detector.max_det
        Ww, Hw = self.comp.window
        sz = self._out_sizes
        out = {}
        o = 0
        for key in ("dets", "cls", "meta", "beams", "mask", "comps"):
            out[key] = host_u8[o:o + sz[key]]
            o += sz[key]
        dets = out["dets"].view(np.float32).reshape(K, md, 5)
        cls_ids = out["cls"].view(np.int32).reshape(K, md)
        metas = out["meta"].view(np.float32).reshape(
            K, len(DeviceCompositor.META_FIELDS))
        beams = (out["beams"].view(np.float32).reshape(self.Km,
                                                       self.n_samples)
                 if self.listen else None)
        mask = out["mask"].reshape(K, md).astype(bool)
        if self.display_transport == "yuv420":
            comps = _i420_to_bgr(out["comps"].reshape(K, -1), Hw, Ww)
        else:
            comps = out["comps"].reshape(K, Hw, Ww, 3)
        return comps, dets, mask, cls_ids, metas, beams

    def _finish(self, pending):
        (host, done), n, cam_frames, t_ready, t0, skipped, stamps = pending
        tf0 = time.perf_counter()
        if done is not None:
            done.synchronize()              # one packed download a batch
        tf1 = time.perf_counter()
        self.metric.tick(tf1 - t0)
        comps, dets, mask, cls_ids, metas, beams = self._unpack(
            host.numpy())
        if self.audio is not None:
            # the gapless contract first: audio does not wait on display
            self.audio.write(beams, skipped, stamps)
        self.phase_s["fetch"].append(tf1 - tf0)
        self.phase_s["unpack"].append(time.perf_counter() - tf1)
        if n == 0:                  # a listening cycle with no camera frame
            return
        sx, sy = self._det_scale
        now = time.perf_counter()
        tracks = None
        tt0 = time.perf_counter()
        show_batch = getattr(self.display, "show_batch", None)
        if show_batch is not None:
            show_batch(comps[:n])          # one bulk handover, no copies
        for i in range(n):
            rows = []
            for row, ok in zip(dets[i], mask[i]):
                if ok and row[4] >= self.tracker.confl:
                    rows.append([float(row[0] * sx), float(row[1] * sy),
                                 float(row[2] * sx), float(row[3] * sy),
                                 float(row[4])])
            tracks, kept = self.tracker.step_with_detections(
                cam_frames[i], rows)
            self._rect_conf = _rect_conf(tracks, kept, self._rect_conf)
            if show_batch is None:
                self.display.show(comps[i])
            self.latency_ms.append((now - t_ready[i]) * 1e3)
        self.phase_s["track"].append(time.perf_counter() - tt0)
        # boxes for the NEXT batch's composite (one-batch staleness)
        boxes = np.full_like(self._boxes, -100.0)
        if tracks is not None and len(tracks):
            b = np.asarray(tracks, np.float32)[:len(boxes)]
            boxes[:len(b), :b.shape[1]] = b[:, :5]
        self._boxes = boxes
        self.processed += n
        self.frames += n
        self.light = float(metas[n - 1, 0])
        self.conf = float(metas[n - 1, 1])
        if self.steer_cb is not None:
            (p1, p2), c = self._rect_conf[:2], self._rect_conf[2]
            self.decider.focus_beam(
                self.steer_cb, [p1[0], p1[1], p2[0], p2[1], c])

    def _collect(self, timeout: float = 0.5):
        """Up to K queued camera frames (blocks for the first)."""
        items = []
        try:
            items.append(self.q_cam.get(timeout=timeout))
        except queue.Empty:
            return items
        while len(items) < self.batch:
            try:
                items.append(self.q_cam.get_nowait())
            except queue.Empty:
                break
        return items

    def run(self):
        # the downloads finish on their own thread, in order (bounded
        # queue): batch i's wait, unpack, tracking and display overlap
        # batch i+1's collect, pack and launch.  The track boxes
        # composited into a batch can then be up to two batches stale
        # (display overlay only).
        q_pend: queue.Queue = queue.Queue(maxsize=2)

        def _drain():
            while True:
                pend = q_pend.get()
                if pend is None:
                    return
                if self.error is not None:
                    continue                    # drain, so put() never blocks
                try:
                    self._finish(pend)
                except Exception as e:
                    log.exception("fused finisher died")
                    self.error = e
                    self.stop_event.set()

        finisher = threading.Thread(target=_drain, daemon=True,
                                    name="fused-finisher")
        finisher.start()
        # stream-start anchor: consume everything the ring still holds,
        # but a pre-start backlog beyond the ring must not be zero-filled
        # in as underruns
        next_seq = self.receiver.stream_anchor_seq
        try:
            while not self.stop_event.is_set():
                tc0 = time.perf_counter()
                if self.listen:
                    # mic-driven cycle (gapless listening): block for the
                    # next counter-contiguous Km frames, then composite
                    # however many camera frames are queued (0..K)
                    try:
                        mic, first, skipped, stamps = \
                            self.receiver.read_batch(
                                self.Km, next_seq, timeout=0.5,
                                channels=self.channels, with_stamps=True)
                    except TimeoutError:
                        continue
                    next_seq = first + self.Km
                    items = []
                    while len(items) < self.batch:
                        try:
                            items.append(self.q_cam.get_nowait())
                        except queue.Empty:
                            break
                else:
                    items = self._collect()
                    if not items:
                        continue
                self.phase_s["collect"].append(time.perf_counter() - tc0)
                t_ready = [time.perf_counter()] * len(items)
                cam_frames = []
                for _no, fr in items:
                    if fr.ndim == 2:
                        fr = np.repeat(fr[..., None], 3, -1)
                    cam_frames.append(fr.astype(np.uint8, copy=False))
                n = len(cam_frames)
                if n:
                    cams = np.stack(cam_frames)
                    if n < self.batch:
                        cams = np.concatenate(
                            [cams, np.repeat(cams[-1:], self.batch - n, 0)])
                    self._last_cams = cams
                else:           # a listening cycle with no camera frame
                    cams = self._last_cams
                if not self.listen:
                    try:
                        mic, first, skipped = self.receiver.read_batch(
                            self.batch, next_seq, timeout=1.0,
                            channels=self.channels)
                    except TimeoutError:
                        continue
                    next_seq = first + self.batch
                    stamps = None
                if skipped:
                    self.skipped += skipped
                t0 = time.perf_counter()
                out = self._launch(mic, cams, n)
                q_pend.put((out, n, cam_frames, t_ready, t0, skipped,
                            stamps))
        finally:
            q_pend.put(None)
            finisher.join(timeout=30.0)

    def report(self) -> dict:
        lat = np.asarray(self.latency_ms, np.float64)
        rep = {
            "frames": self.frames,
            "latency_p50_ms": round(float(np.percentile(lat, 50)), 2)
            if lat.size else None,
            "latency_p95_ms": round(float(np.percentile(lat, 95)), 2)
            if lat.size else None,
            "light": self.light, "conf": self.conf,
            # p50 milliseconds a batch of each leg: which leg is slow
            "phase_p50_ms": {
                k: round(float(np.percentile(v, 50)) * 1e3, 1)
                for k, v in self.phase_s.items() if v},
        }
        if self.audio is not None:
            rep.update(self.audio.latency())
            rep["audio_frames"] = self.audio.samples // self.n_samples
            rep["underrun_frames"] = self.audio.underrun_frames
        return rep
