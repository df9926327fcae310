"""Device display compositing: the sensor-fusion demo's per-frame pixel
chain as one batched torch program per K frames.

The chain (log-norm, jet-LUT colorize, the resizes to the window, EMA
smoothing, the power box, and the decider's gating and three blends and
flips; ``visual.py:227-293,405-484``, ``decider.py:26-68``) runs on K
frames at a time, each step one batched op on (K, H, W, 3) tensors.  The
host uploads the small power maps, the camera frames and the track boxes
and downloads finished uint8 composites; the gating decisions (light
level, entropy confidence) come back as per-frame scalars for the host
decider's steering callback.

The arithmetic is cv2's, as the JAX package's ``fusion/composite.py``
probed it: half-pixel-center bilinear resizes (or the align-corners
fallback tables when the host has no cv2), round-half-to-even saturating
``addWeighted``, thick rectangle outlines as the L1 ball of radius
``thickness - 1`` around the perimeter, filled circles as ``d^2 <=
r^2``, a ``BORDER_REFLECT_101`` Gaussian blur and per-pixel rounded
BGR -> gray.  The port computes in the JAX program's order: integer
powers as chains of products, the gray weights as an FP32 weighted sum,
divisions by device tensors (CUDA turns a division by a Python scalar
into a product with its reciprocal).  The horizontal flips of the camera
and of the tracker overlay are folded into the gather tables.

A port of ``zybo_rt_sampler_image_detection_tpu/fusion/composite.py``
(NumPy and torch only).
"""

from __future__ import annotations

import queue
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F_

from ..ops.beamform import resolve_device
from ..utils import imaging
from ..utils.metrics import history
from ..utils.viz import POWER_EXPONENT, jet_lut


_INV_LN10 = 0.4342944819032518         # 1 / log(10)
# cv2's BGR -> gray weights, as FP32 values
_GRAY_W = [float(w) for w in np.array([0.114, 0.587, 0.299], np.float32)]
# the colour blend's weight as the FP32 value the JAX program multiplies by
_BLEND_W = float(np.float32(0.9))


class CompositeTables(NamedTuple):
    """Gather indices and weights of the batched program, on the device.
    Each resize holds its source rows/columns (``*_y0``, ``*_y1``,
    ``*_x0``, ``*_x1``), fractions (``*_fy``, ``*_fx``) and their
    complements (``*_gy``, ``*_gx`` = 1 - fraction, in FP32)."""

    lut: torch.Tensor      # (256, 3) f32: reversed jet LUT (visual.py:43-44)
    gauss: torch.Tensor    # (5,) f32: cv2.getGaussianKernel(5, 1.0)
    heat: tuple            # colorized (Xg, Yg) map -> window, double flip folded
    cam: tuple             # camera (Hc, Wc) -> window, horizontal flip folded
    yolo: tuple            # overlay (Hy, Wy) -> window, decider flip folded


def _axis_tables(src: int, dst: int, cv2_convention: bool):
    """Bilinear gather indices + fractions for one axis.

    cv2 INTER_LINEAR maps dst pixel i to source coordinate
    ``(i + 0.5) * src/dst - 0.5`` (half-pixel centers, clipped at the
    border); the cv2-less ``imaging.resize`` fallback uses align-corners
    ``linspace``.  The compositor mirrors whichever convention the host
    path is running so parity holds either way."""
    if cv2_convention:
        xs = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
        xs = np.clip(xs, 0.0, src - 1)
    else:
        xs = np.linspace(0.0, src - 1, dst)
    i0 = np.floor(xs).astype(np.int32)
    f = (xs - i0).astype(np.float32)
    i1 = np.minimum(i0 + 1, src - 1).astype(np.int32)
    return i0, i1, f


def _gauss_kernel5(sigma: float = 1.0) -> np.ndarray:
    """cv2.getGaussianKernel(5, sigma) (find_power_center's blur,
    visual.py:295-322; same formula as the imaging fallback)."""
    x = np.arange(-2, 3, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _resize_tables(src_hw, dst_hw, cv2_convention: bool, device,
                   flip_src_x: bool = False, flip_src_y: bool = False,
                   flip_dst_x: bool = False) -> tuple:
    """Device tables ``(y0, y1, fy, gy, x0, x1, fx, gx)`` of one bilinear
    resize.  ``flip_src_*`` read a source flipped along that axis (index
    ``n - 1 - i``); ``flip_dst_x`` writes the result flipped along x."""
    (sh, sw), (dh, dw) = src_hw, dst_hw
    y0, y1, fy = _axis_tables(sh, dh, cv2_convention)
    x0, x1, fx = _axis_tables(sw, dw, cv2_convention)
    if flip_src_y:
        y0, y1 = sh - 1 - y0, sh - 1 - y1
    if flip_src_x:
        x0, x1 = sw - 1 - x0, sw - 1 - x1
    if flip_dst_x:
        x0, x1, fx = x0[::-1], x1[::-1], fx[::-1]
    out = []
    for i0, i1, f in ((y0, y1, fy), (x0, x1, fx)):
        out += [torch.as_tensor(np.ascontiguousarray(i0), dtype=torch.long,
                                device=device),
                torch.as_tensor(np.ascontiguousarray(i1), dtype=torch.long,
                                device=device),
                torch.as_tensor(np.ascontiguousarray(f), device=device),
                torch.as_tensor(np.ascontiguousarray(np.float32(1) - f),
                                device=device)]
    return tuple(out)


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to FP32, as the fused multiply-add the
    JAX program's compiler emits for a product feeding a sum.  Computed in
    FP64: for pixel-scale operands the product and the sum are exact there,
    so the one rounding is the FMA's.  A scalar ``b`` must be the FP32
    value the JAX program multiplies by (``float(np.float32(w))``), not
    the FP64 literal."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    return (a.double() * b).add_(c).float()


def _bilinear(img: torch.Tensor, t: tuple) -> torch.Tensor:
    """(K, H, W, C) f32 -> (K, h, w, C) f32 via two gather passes, in the
    JAX program's order: rows = a*(1-fy) + b*fy with the first product
    fused into the sum, then the same on x."""
    y0, y1, fy, gy, x0, x1, fx, gx = t
    fy, gy = fy[None, :, None, None], gy[None, :, None, None]
    rows = _fma(img.index_select(1, y0), gy, img.index_select(1, y1) * fy)
    fx, gx = fx[None, None, :, None], gx[None, None, :, None]
    return _fma(rows.index_select(2, x0), gx, rows.index_select(2, x1) * fx)


def _round_u8_(x: torch.Tensor) -> torch.Tensor:
    """cv2 saturate_cast in place: round half to even, clip to [0, 255]."""
    return x.round_().clamp_(0.0, 255.0)


class DeviceCompositor:
    """Owns the tables of the batched compositing program.

    ``__call__(powers (K, Xg, Yg) f32, cams (K, Hc, Wc, 3) u8, yolos (K,
    Hy, Wy, 3) u8 or boxes (K, max_tracks, 5), prev (Hw, Ww, 3) u8) ->
    (composites (K, Hw, Ww, 3) u8, prev', meta (K, 5) f32)``, all tensors
    on ``device`` (NumPy inputs are uploaded); nothing syncs the host.
    ``meta`` carries the per-frame gating scalars in ``META_FIELDS``
    order: light level, entropy confidence ``1/(1+H)``, should_overlay,
    and the power-center pixel (sx, sy).

    Semantics transcribed from the host chain it replaces:
    ``utils.viz.Viewer.loop`` + ``calculate_heatmap_with_detection``
    (``visual.py:227-293,405-484``) and
    ``fusion.decider.SensorFusionDecider.create_image``
    (``decider.py:26-51``).  ``device`` defaults to the card (``"cuda"``
    raises without a GPU).
    """

    META_FIELDS = ("light", "conf", "should", "sx", "sy")

    def __init__(self, grid_shape: Tuple[int, int],
                 cam_shape: Tuple[int, int],
                 window: Tuple[int, int] = (640, 360),
                 yolo_shape: Optional[Tuple[int, int]] = None,
                 threshold: float = 1e-7, amount: float = 0.5,
                 exponent: int = POWER_EXPONENT,
                 box_size_ratio: float = 0.1, light_gate: float = 0.2,
                 heatmap_color: bool = False, ema: float = 0.5,
                 cv2_convention: Optional[bool] = None,
                 max_tracks: int = 0, device="cuda"):
        """``max_tracks > 0`` switches the YOLO input from a drawn overlay
        image to per-frame track boxes ``(K, max_tracks, 5)`` f32 (x1, y1,
        x2, y2, id in camera pixels, padded with -100 rows): the green
        thickness-2 ID rectangles the host tracker draws
        (``pipeline._draw_tracks``) are rasterized on the device, so the
        upload is 20 floats a track instead of a canvas."""
        if cv2_convention is None:
            cv2_convention = imaging._HAS_CV2
        if int(exponent) < 1:
            raise ValueError(f"exponent must be a positive integer, "
                             f"got {exponent}")
        self.device = resolve_device(device)
        Xg, Yg = grid_shape
        Ww, Hw = window
        Hc, Wc = cam_shape
        Hy, Wy = yolo_shape if yolo_shape is not None else cam_shape
        self.grid_shape = (Xg, Yg)
        self.window = (Ww, Hw)
        self.cam_shape = (Hc, Wc)
        self.yolo_shape = (Hy, Wy)
        self.cv2_convention = bool(cv2_convention)
        self.threshold = float(threshold)
        self.amount = float(amount)
        self.exponent = int(exponent)
        # the power box is a fixed-size rectangle centered on the power
        # center (visual.py:227-293)
        self.bw = int(Ww * box_size_ratio)
        self.bh = int(Hw * box_size_ratio)
        self.light_gate = float(light_gate)
        self.heatmap_color = bool(heatmap_color)
        self.ema = float(ema)
        self.max_tracks = int(max_tracks)
        dev = self.device
        self.tables = CompositeTables(
            lut=torch.as_tensor(jet_lut().astype(np.float32), device=dev),
            gauss=torch.as_tensor(_gauss_kernel5(), device=dev),
            # the colorized map is indexed (x, y); the display wants
            # small[Yg-1-y, Xg-1-x]: read it transposed, both axes flipped
            heat=_resize_tables((Yg, Xg), (Hw, Ww), cv2_convention, dev,
                                flip_src_x=True, flip_src_y=True),
            cam=_resize_tables((Hc, Wc), (Hw, Ww), cv2_convention, dev,
                               flip_src_x=True),
            # the overlay only enters the blend flipped (decider.py:26-51)
            yolo=_resize_tables((Hy, Wy), (Hw, Ww), cv2_convention, dev,
                                flip_dst_x=True))

        def c(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        # divisors as device tensors: a true division on every device
        self._c = dict(amount=c(self.amount), xg1=c(max(Xg - 1, 1)),
                       yg1=c(max(Yg - 1, 1)), c255=c(255.0), one=c(1.0))
        self._iota = dict(
            rows=torch.arange(Xg, device=dev, dtype=torch.float32)[:, None],
            cols=torch.arange(Yg, device=dev, dtype=torch.float32)[None, :],
            xs_w=torch.arange(Ww, device=dev, dtype=torch.int32)[None, None],
            ys_w=torch.arange(Hw, device=dev,
                              dtype=torch.int32)[None, :, None],
            xs_y=torch.arange(Wy, device=dev,
                              dtype=torch.float32)[None, None, None],
            ys_y=torch.arange(Hy, device=dev,
                              dtype=torch.float32)[None, None, :, None])
        self._colors = dict(
            green=c([0.0, 255.0, 0.0]), magenta=c([255.0, 0.0, 255.0]),
            red=c([0.0, 0.0, 255.0]))

    # -- device program -----------------------------------------------------

    def init_prev(self) -> torch.Tensor:
        Ww, Hw = self.window
        return torch.zeros((Hw, Ww, 3), dtype=torch.uint8,
                           device=self.device)

    @torch.no_grad()
    def __call__(self, powers, cams, yolos, prev, count=None):
        """``count`` (host int) marks how many leading frames are real
        when the batch was padded to K (repeats of the last triple):
        outputs past ``count`` are for the caller to discard, and the
        returned EMA carry is the one after frame ``count-1``, so padding
        never advances the display state."""
        powers, cams, yolos, prev = (torch.as_tensor(x, device=self.device)
                                     for x in (powers, cams, yolos, prev))
        if count is None:
            count = len(powers)
        return self._run(powers, cams, yolos, prev, int(count))

    def empty_yolo(self, k: int = 1) -> np.ndarray:
        """A no-op YOLO input batch for this compositor's mode: an empty
        canvas, or an all-padding boxes array (rows at -100 raster
        nothing)."""
        if self.max_tracks:
            return np.full((k, self.max_tracks, 5), -100.0, np.float32)
        Hy, Wy = self.yolo_shape
        return np.zeros((k, Hy, Wy, 3), np.uint8)

    def warmup(self, k: int = 1) -> None:
        Xg, Yg = self.grid_shape
        Hc, Wc = self.cam_shape
        p = np.zeros((k, Xg, Yg), np.float32)
        c = np.zeros((k, Hc, Wc, 3), np.uint8)
        comps, _, _ = self(p, c, self.empty_yolo(k), self.init_prev(),
                           count=1)
        comps.cpu()

    @classmethod
    def meta_dict(cls, meta) -> dict:
        """The (K, 5) packed gating scalars as a dict of (K,) arrays."""
        m = meta.cpu().numpy() if isinstance(meta, torch.Tensor) \
            else np.asarray(meta)
        return {k: m[:, i] for i, k in enumerate(cls.META_FIELDS)}

    def _raster_tracks(self, boxes: torch.Tensor) -> torch.Tensor:
        """The tracker's green thickness-2 ID rectangles
        (``pipeline._draw_tracks`` -> ``imaging.rectangle(..., 2)``)
        rasterized on the device, as cv2 draws them: the L1 ball of radius
        thickness-1 around the perimeter.  ``boxes`` (K, T, 5) f32;
        padding rows at -100 touch no pixel.  -> (K, Hy, Wy, 3) f32."""
        xs, ys = self._iota["xs_y"], self._iota["ys_y"]
        b = boxes.float()[..., None, None]              # (K, T, 5, 1, 1)
        x1, y1, x2, y2 = b[:, :, 0], b[:, :, 1], b[:, :, 2], b[:, :, 3]
        dx_in = torch.maximum(x1 - xs, xs - x2).clamp_(min=0.0)
        dy_in = torch.maximum(y1 - ys, ys - y2).clamp_(min=0.0)
        d = torch.minimum(
            torch.minimum((ys - y1).abs_() + dx_in, (ys - y2).abs_() + dx_in),
            torch.minimum((xs - x1).abs_() + dy_in, (xs - x2).abs_() + dy_in))
        mask = (d <= 1.0).any(1)                        # thickness 2
        return mask[..., None] * self._colors["green"]

    @torch.no_grad()
    def _run(self, powers, cams, yolos, prev, count: int):
        """The batched program.  ``powers`` (K, Xg, Yg), ``cams`` (K, Hc,
        Wc, 3) u8 or f32, ``yolos`` canvases or boxes, ``prev`` (Hw, Ww, 3)
        u8; returns (composites u8, prev' u8, meta f32)."""
        t, c = self.tables, self._c
        K = powers.shape[0]
        Xg, Yg = self.grid_shape
        Ww, Hw = self.window
        powers = powers.float()

        # ---- calculate_heatmap_with_detection (visual.py:227-293) ----
        should = powers.amax((1, 2)) > self.threshold           # (K,)
        safe = powers.clamp(min=1e-12)
        # log_normalize (visual.py:164-166); log10 as jnp.log10 computes
        # it: log(x) times FP32 1/log(10)
        img = torch.log(safe).mul_(_INV_LN10)
        img -= torch.log(safe.amin((1, 2), keepdim=True)).mul_(_INV_LN10)
        imx = img.amax((1, 2), keepdim=True)
        img01 = torch.where(imx > 0, img / torch.where(imx > 0, imx,
                                                       c["one"]), img)
        # colorize_power (the reference paint loop, visual.py:170-184);
        # p ** exponent as JAX's integer_pow: square-and-multiply products
        p = ((img01 - self.amount) / c["amount"]).clamp_(min=0.0)
        pe = _integer_pow(p, self.exponent)
        cval = torch.floor(pe * 255.0).clamp_(0, 255).long()
        painted = (img01 >= self.amount) & should[:, None, None]
        small = torch.where(painted[..., None], t.lut[cval], 0.0)
        # small is (K, Xg, Yg, 3); the tables read it as (K, Yg, Xg, 3)
        res1 = _round_u8_(_bilinear(small.transpose(1, 2), t.heat))
        # EMA smoothing (visual.py:455: addWeighted(prev, .5, res1, .5)),
        # the one recurrence across frames: one short chain a frame
        res = torch.empty_like(res1)
        cur = prev.float()
        for k in range(K):
            torch.mul(res1[k], 1.0 - self.ema, out=res[k])
            res[k].add_(cur * self.ema)
            _round_u8_(res[k])
            cur = res[k]
        # (count 0, a listening cycle without a camera frame, keeps the
        # last frame's: index -1, which JAX's dynamic index wraps too)
        prev2 = res[count - 1].to(torch.uint8)

        # ---- find_power_center (visual.py:295-322) ----
        sm = self._gauss5(safe, t.gauss)
        mask = sm >= 0.95 * sm.amax((1, 2), keepdim=True)
        w = _integer_pow(sm, 3) * mask
        tw = w.sum((1, 2))
        rows, cols = self._iota["rows"], self._iota["cols"]
        am = sm.reshape(K, -1).argmax(1)
        am_r = torch.div(am, Yg, rounding_mode="floor").float()
        am_c = (am % Yg).float()
        pos = tw > 0
        safe_tw = torch.where(pos, tw, c["one"])
        peak_x = torch.where(pos, (rows * w).sum((1, 2)) / safe_tw, am_r)
        peak_y = torch.where(pos, (cols * w).sum((1, 2)) / safe_tw, am_c)
        sx = (Ww - 1) - torch.floor(peak_x / c["xg1"] * Ww).int()
        sy = (Hw - 1) - torch.floor(peak_y / c["yg1"] * Hw).int()

        # power box overlay: cv2 thick rect = L1 ball of radius t-1
        # around the perimeter; filled circle = d^2 <= r^2 (both probed)
        xs_w, ys_w = self._iota["xs_w"], self._iota["ys_w"]
        sxb, syb = sx[:, None, None], sy[:, None, None]
        x1 = (sxb - self.bw // 2).clamp(min=0)
        y1 = (syb - self.bh // 2).clamp(min=0)
        x2 = (sxb + self.bw // 2).clamp(max=Ww)
        y2 = (syb + self.bh // 2).clamp(max=Hw)
        dx_in = torch.maximum(x1 - xs_w, xs_w - x2).clamp_(min=0)
        dy_in = torch.maximum(y1 - ys_w, ys_w - y2).clamp_(min=0)
        d_edges = torch.minimum(
            torch.minimum((ys_w - y1).abs_() + dx_in,
                          (ys_w - y2).abs_() + dx_in),
            torch.minimum((xs_w - x1).abs_() + dy_in,
                          (xs_w - x2).abs_() + dy_in))
        show = should[:, None, None]
        rect = (d_edges <= 2) & show                     # thickness 3
        circ = (((xs_w - sxb) ** 2 + (ys_w - syb) ** 2) <= 25) & show
        power_img = torch.where(
            circ[..., None], self._colors["red"],
            torch.where(rect[..., None], self._colors["magenta"], 0.0))

        # ---- Viewer.loop camera path (visual.py:449-452) ----
        frame = _round_u8_(_bilinear(cams.float(), t.cam))
        if self.heatmap_color:
            image = _round_u8_(_fma(frame, _BLEND_W, res * 0.9))
        else:
            image = frame
        canvas = (self._raster_tracks(yolos) if self.max_tracks
                  else yolos.float())
        yolo_f = _round_u8_(_bilinear(canvas, t.yolo))  # already flipped

        # ---- decider (decider.py:26-68) ----
        # light level: cv2 BGR->gray rounds per pixel before the mean
        # (the JAX program's dot: b*w0, then two fused multiply-adds)
        gray = _fma(image[..., 2], _GRAY_W[2],
                    _fma(image[..., 1], _GRAY_W[1],
                         image[..., 0] * _GRAY_W[0])).round_()
        light = gray.mean((1, 2)) / c["c255"]
        gate = (light >= self.light_gate).float()
        # entropy of the (uint8-valued) EMA heatmap -> confidence
        s = res.sum((1, 2, 3))
        spos = s > 0
        pv = res / torch.where(spos, s, c["one"])[:, None, None, None]
        nz = res > 0
        ent = -torch.where(nz, pv * torch.log(torch.where(nz, pv, c["one"])),
                           0.0).sum((1, 2, 3))
        conf = torch.where(spos, c["one"] / (c["one"] + ent), c["one"])
        # gate, blend, flip (decider.py:26-51): sequential saturating
        # uint8 addWeighted steps, like the host
        yolo_f.mul_(gate[:, None, None, None]).mul_(0.7)
        comp = _round_u8_(image.add_(yolo_f))
        comp = _round_u8_(comp.add_(power_img.mul_(0.7)))
        comp = _round_u8_(comp.add_(res * 0.7))
        comps = comp.to(torch.uint8).flip(2)

        meta = torch.stack([light, conf, should.float(), sx.float(),
                            sy.float()], dim=1)
        return comps, prev2, meta

    @staticmethod
    def _gauss5(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """5x5 separable Gaussian with BORDER_REFLECT_101 (torch's
        'reflect' pad, matching cv2's default and the imaging fallback);
        (X, Y) or (K, X, Y)."""
        squeeze = x.ndim == 2
        x3 = x[None] if squeeze else x
        X, Y = x3.shape[1:]
        pz = F_.pad(x3[:, None], (2, 2, 2, 2), mode="reflect")[:, 0]
        tmp = sum(g[k] * pz[:, :, k:k + Y] for k in range(5))   # axis 1
        out = sum(g[k] * tmp[:, k:k + X, :] for k in range(5))  # axis 0
        return out[0] if squeeze else out


def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` for a positive int as JAX's ``lax.integer_pow`` computes
    it: binary exponentiation, each step one FP32 product (a library pow
    can differ by an ulp, which moves a LUT index)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


class DeviceViewer:
    """Drop-in replacement for ``utils.viz.Viewer.loop`` running the
    display chain on the device in K-frame batches.

    Same queue semantics as the host viewer (``visual.py:405-484``): per
    displayed frame one (power, camera, yolo-overlay) triple, items
    already dequeued carried across timeouts.  Triples are collected up
    to ``batch`` (a partial batch is padded with repeats of the last
    triple; the padded outputs are dropped through ``count``) and
    composited by one program.  On the card batch *i*'s composites come
    down by a ``non_blocking`` copy into a pinned buffer, with an event,
    while batch *i+1* is collected and launched.

    Accounting: ``frames`` composited, ``latency_ms`` per frame from
    triple-complete to display, ``light``/``conf`` mirror the host
    decider's ``last_light_level``/``last_entropy_confidence``.
    """

    def __init__(self, compositor: DeviceCompositor, display,
                 batch: int = 8):
        self.comp = compositor
        self.display = display
        self.batch = int(batch)
        self.frames = 0
        self.latency_ms = history()
        self.light: Optional[float] = None
        self.conf: Optional[float] = None

    def warmup(self) -> None:
        self.comp.warmup(self.batch)

    def _as_yolo(self, yolo):
        """A q_inference payload as this compositor's YOLO input: (T, 5)
        track boxes padded/truncated to max_tracks, or a 3-channel canvas
        image."""
        if self.comp.max_tracks:
            boxes = np.full((self.comp.max_tracks, 5), -100.0, np.float32)
            if yolo is not None and len(yolo):
                b = np.asarray(yolo, np.float32)[:self.comp.max_tracks]
                boxes[:len(b)] = b
            return boxes
        if yolo is None:
            return np.zeros(self.comp.yolo_shape + (3,), np.uint8)
        if yolo.ndim == 2:
            yolo = np.repeat(yolo[..., None], 3, -1)
        return yolo.astype(np.uint8, copy=False)

    def _collect(self, q_power, q_viewer, q_inference, pend, deadline,
                 running, remaining):
        """Gather up to min(batch, remaining) triples; blocks until at
        least one triple or the deadline/running flag stops it."""
        triples = []
        want = min(self.batch, remaining)
        while len(triples) < want:
            timeout = 0.5 if not triples else 0.0
            try:
                if pend["y"] is None and q_inference is not None:
                    pend["y"] = q_inference.get(timeout=timeout)
                if pend["p"] is None:
                    pend["p"] = q_power.get(timeout=timeout)
                if pend["f"] is None and q_viewer is not None:
                    pend["f"] = q_viewer.get(timeout=timeout)
            except queue.Empty:
                if triples:
                    break               # flush a partial batch
                if not _running(running) or time.time() > deadline:
                    break
                continue
            power, _seq = pend["p"]
            frame = pend["f"][1] if pend["f"] is not None else None
            yolo = pend["y"][1] if pend["y"] is not None else None
            pend["p"] = pend["f"] = pend["y"] = None
            Hc, Wc = self.comp.cam_shape
            if frame is None:
                frame = np.zeros((Hc, Wc, 3), np.uint8)
            elif frame.ndim == 2:
                frame = np.repeat(frame[..., None], 3, -1)
            triples.append((np.asarray(power, np.float32),
                            frame.astype(np.uint8, copy=False),
                            self._as_yolo(yolo),
                            time.perf_counter()))
        return triples

    def _launch(self, triples, prev):
        """Stack, pad to ``batch`` and composite one batch; returns (the
        pending download, prev')."""
        n = len(triples)
        parts = []
        for j in range(3):
            a = np.stack([t[j] for t in triples])
            if n < self.batch:                  # pad: one batch shape
                a = np.concatenate([a, np.repeat(a[-1:], self.batch - n, 0)])
            parts.append(a)
        comps, prev, meta = self.comp(*parts, prev, count=n)
        if self.comp.device.type == "cuda":
            host = torch.empty(comps.shape, dtype=torch.uint8,
                               pin_memory=True)
            host_meta = torch.empty(meta.shape, pin_memory=True)
            host.copy_(comps, non_blocking=True)
            host_meta.copy_(meta, non_blocking=True)
            done = torch.cuda.Event(blocking=True)
            done.record()
        else:
            host, host_meta, done = comps, meta, None
        return (host, host_meta, done, [t[3] for t in triples], n), prev

    def loop(self, q_power, running, q_viewer=None, q_inference=None,
             max_frames: Optional[int] = None):
        prev = self.comp.init_prev()
        pend = {"p": None, "f": None, "y": None}
        deadline = time.time() + 3600.0
        pending = None
        while _running(running) and (max_frames is None
                                     or self.frames < max_frames):
            remaining = (self.batch if max_frames is None
                         else max_frames - self.frames
                         - (pending[4] if pending else 0))
            if remaining <= 0:
                break
            triples = self._collect(q_power, q_viewer, q_inference, pend,
                                    deadline, running, remaining)
            if not triples:
                if pending is not None:
                    self._finish(pending)
                    pending = None
                if not _running(running):
                    break
                continue
            launched, prev = self._launch(triples, prev)
            if pending is not None:
                self._finish(pending)       # batch i-1, in order
            pending = launched
        if pending is not None:
            self._finish(pending)

    def _finish(self, pending):
        host, host_meta, done, t_ready, n = pending
        if done is not None:
            done.synchronize()              # one wait a batch
        comps = host.numpy()
        m = host_meta.numpy()
        now = time.perf_counter()
        show_batch = getattr(self.display, "show_batch", None)
        if show_batch is not None:
            show_batch(comps[:n])          # one bulk handover, no copies
        for i in range(n):
            if show_batch is None:
                self.display.show(comps[i])
            self.latency_ms.append((now - t_ready[i]) * 1e3)
        self.frames += n
        self.light = float(m[n - 1, 0])
        self.conf = float(m[n - 1, 1])

    def report(self) -> dict:
        lat = np.asarray(self.latency_ms, np.float64)
        return {
            "frames": self.frames,
            "latency_p50_ms": round(float(np.percentile(lat, 50)), 2)
            if lat.size else None,
            "latency_p95_ms": round(float(np.percentile(lat, 95)), 2)
            if lat.size else None,
            "light": self.light, "conf": self.conf,
        }


def _running(running) -> bool:
    return bool(getattr(running, "value", running))
