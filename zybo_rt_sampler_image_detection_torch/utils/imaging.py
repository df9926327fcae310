"""Small imaging toolbox: resize / blend / flip / blur / drawing.

Every operation prefers cv2 (the reference's dependency) and falls back to
a NumPy implementation so the whole pipeline stays runnable headless on a
host without cv2.  Only the primitives the pipeline actually uses exist
here.  A copy of ``zybo_rt_sampler_image_detection_tpu/utils/imaging.py``
(NumPy only), kept so that the port never imports the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except ImportError:                                   # pragma: no cover
    cv2 = None
    _HAS_CV2 = False


def resize(img: np.ndarray, size_wh: Tuple[int, int],
           nearest: bool = False) -> np.ndarray:
    """Resize to (width, height) — cv2 argument order."""
    w, h = size_wh
    if img.shape[1] == w and img.shape[0] == h:
        # same-size: skip the interpolation pass but keep cv2.resize's
        # fresh-buffer contract (callers draw on the result in place)
        return img.copy()
    if _HAS_CV2:
        interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
        return cv2.resize(img, (w, h), interpolation=interp)
    ys = np.linspace(0, img.shape[0] - 1, h)
    xs = np.linspace(0, img.shape[1] - 1, w)
    if nearest:
        return img[ys.round().astype(int)][:, xs.round().astype(int)]
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, img.shape[0] - 1)
    x1 = np.minimum(x0 + 1, img.shape[1] - 1)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    if img.ndim == 3:
        fy = fy[..., None]
        fx = fx[..., None]
    a = img[y0][:, x0].astype(np.float64)
    b = img[y0][:, x1].astype(np.float64)
    c = img[y1][:, x0].astype(np.float64)
    d = img[y1][:, x1].astype(np.float64)
    out = (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
           + c * fy * (1 - fx) + d * fy * fx)
    return out.astype(img.dtype)


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float,
                 gamma: float = 0.0) -> np.ndarray:
    if _HAS_CV2:
        return cv2.addWeighted(a, alpha, b, beta, gamma)
    out = a.astype(np.float64) * alpha + b.astype(np.float64) * beta + gamma
    return np.clip(out, 0, 255).astype(a.dtype)


def flip_horizontal(img: np.ndarray) -> np.ndarray:
    return img[:, ::-1].copy()


def to_gray(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return img
    if _HAS_CV2:
        return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    # BGR weights (cv2 channel order)
    w = np.array([0.114, 0.587, 0.299])
    return (img.astype(np.float64) @ w).astype(img.dtype)


def gray_to_bgr(img: np.ndarray) -> np.ndarray:
    if img.ndim == 3:
        return img
    if _HAS_CV2:
        return cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    return np.repeat(img[..., None], 3, axis=-1)


def gaussian_blur(img: np.ndarray, ksize: int = 5,
                  sigma: float = 1.0) -> np.ndarray:
    if _HAS_CV2:
        return cv2.GaussianBlur(img.astype(np.float32), (ksize, ksize),
                                sigmaX=sigma, sigmaY=sigma)
    r = ksize // 2
    x = np.arange(-r, r + 1)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    k /= k.sum()
    if img.ndim == 3:                     # color: blur each channel
        return np.stack([gaussian_blur(img[..., c], ksize, sigma)
                         for c in range(img.shape[-1])], axis=-1)
    pad = np.pad(img.astype(np.float64), ((r, r), (r, r)), mode="reflect")
    tmp = np.apply_along_axis(lambda m: np.convolve(m, k, "valid"), 0, pad)
    out = np.apply_along_axis(lambda m: np.convolve(m, k, "valid"), 1, tmp)
    return out.astype(np.float32)


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> None:
    """In-place rectangle outline."""
    if _HAS_CV2:
        cv2.rectangle(img, tuple(map(int, pt1)), tuple(map(int, pt2)),
                      color, thickness)
        return
    x1, y1 = map(int, pt1)
    x2, y2 = map(int, pt2)
    # clamp each corner independently (cv2 semantics): a box entirely
    # off one side degenerates to an edge sliver instead of a negative
    # slice start that would wrap drawing to the opposite edge
    x1, x2 = sorted((min(max(x1, 0), img.shape[1] - 1),
                     min(max(x2, 0), img.shape[1] - 1)))
    y1, y2 = sorted((min(max(y1, 0), img.shape[0] - 1),
                     min(max(y2, 0), img.shape[0] - 1)))
    t = max(1, thickness)
    img[y1:y1 + t, x1:x2 + 1] = color
    img[max(y2 - t + 1, 0):y2 + 1, x1:x2 + 1] = color
    img[y1:y2 + 1, x1:x1 + t] = color
    img[y1:y2 + 1, max(x2 - t + 1, 0):x2 + 1] = color


def circle(img: np.ndarray, center, radius: int, color,
           thickness: int = 1) -> None:
    if _HAS_CV2:
        cv2.circle(img, tuple(map(int, center)), int(radius), color,
                   thickness)
        return
    cx, cy = map(int, center)
    yy, xx = np.ogrid[:img.shape[0], :img.shape[1]]
    d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    mask = (np.abs(d - radius) <= max(1, thickness)) if thickness > 0 \
        else (d <= radius)
    img[mask] = color


def put_text(img: np.ndarray, text: str, org, color, scale: float = 0.6,
             thickness: int = 2) -> None:
    if _HAS_CV2:
        cv2.putText(img, text, tuple(map(int, org)),
                    cv2.FONT_HERSHEY_SIMPLEX, scale, color, thickness)
        return
    # headless fallback: a short tick instead of glyph rendering
    x, y = map(int, org)
    if 0 <= y < img.shape[0]:
        img[y, max(x, 0):min(x + 8 * len(text), img.shape[1])] = color


def mean_brightness(img: np.ndarray) -> float:
    return float(to_gray(img).mean())
