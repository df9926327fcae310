"""Small Kalman filters.

* :class:`KalmanFilter3D` — the 6-state constant-velocity position filter
  used to smooth the heatmap peak, numerically identical to the Eigen
  implementation in ``PC/src/kf.hpp:36-165`` (A/Q/H/R constants verbatim).
  The matrices are 6x6; NumPy is the right tool — no device round-trip for
  a per-frame 3-vector.  A copy of the JAX package's class.
* :func:`batched_kf3d_update` — the same update for a bank of filters,
  in torch on the inputs' device.
"""

from __future__ import annotations

import numpy as np
import torch


class KalmanFilter3D:
    """Linear 3-D constant-velocity filter (pos + vel)."""

    def __init__(self):
        A = np.eye(6, dtype=np.float32)
        A[0, 3] = A[1, 4] = A[2, 5] = 1.0
        self.A = A
        self.Q = np.eye(6, dtype=np.float32) * 0.1
        self.H = np.zeros((3, 6), dtype=np.float32)
        self.H[0, 0] = self.H[1, 1] = self.H[2, 2] = 1.0
        self.R = np.eye(3, dtype=np.float32) * 0.1
        self.P = np.eye(6, dtype=np.float32)
        self.x = np.zeros(6, dtype=np.float32)

    def update(self, measurement) -> None:
        """Predict + correct with a new (x, y, z) measurement
        (``kf.hpp:85-99``)."""
        z = np.asarray(measurement, dtype=np.float32)
        A, Q, H, R = self.A, self.Q, self.H, self.R
        self.x = A @ self.x
        self.P = A @ self.P @ A.T + Q
        S = H @ self.P @ H.T + R
        K = self.P @ H.T @ np.linalg.inv(S)
        y = z - H @ self.x
        self.x = self.x + K @ y
        self.P = (np.eye(6, dtype=np.float32) - K @ H) @ self.P

    def get_state(self) -> np.ndarray:
        """Current position estimate (``kf.hpp:106-109``)."""
        return self.x[:3].copy()

    def predict(self, n: int) -> np.ndarray:
        """Position n steps ahead (``kf.hpp:117-130``; useful horizon <= ~5
        steps per the reference's own note, ``kf.hpp:17-19``)."""
        An = self.A.copy()
        xn = self.x.copy()
        for _ in range(n):
            xn = An @ xn
            An = An @ self.A
        return xn[:3]


def batched_kf3d_update(x, P, z):
    """Vectorized update for (..., 6) states / (..., 6, 6) covariances /
    (..., 3) measurements: a bank of filters in one call, on the inputs'
    device.  Runs in FP32 with TF32 off (float64 inputs stay float64):
    covariance drift compounds every frame."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, P, z = (torch.as_tensor(v) for v in (x, P, z))
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    dev = x.device
    x, P, z = x.to(dt), P.to(dev, dt), z.to(dev, dt)
    A = torch.eye(6, dtype=dt, device=dev)
    A[0, 3] = A[1, 4] = A[2, 5] = 1.0
    Q = torch.eye(6, dtype=dt, device=dev) * 0.1
    H = torch.eye(6, dtype=dt, device=dev)[:3]
    R = torch.eye(3, dtype=dt, device=dev) * 0.1

    x = x @ A.T
    P = A @ P @ A.T + Q
    S = H @ P @ H.T + R
    K = P @ H.T @ torch.linalg.inv(S)
    y = z - x @ H.T
    x = x + (K @ y[..., None])[..., 0]
    P = (torch.eye(6, dtype=dt, device=dev) - K @ H) @ P
    return x, P
