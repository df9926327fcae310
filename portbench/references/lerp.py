"""The plain reference of the ``lerp`` heatmap: delay-and-sum in float64.

``lerp_and_sum.c`` runs, for direction d and active mic m with delay
``w + frac`` and ``h = 1 - frac``::

    out[w + i + 1] += s[i] + h * (s[i + 1] - s[i])     i in [0, N - w - 1)

and ``pad_and_sum.c`` turns the beam into the heatmap pixel
``sum((out / M) ** 2) / N``.  :func:`maps` runs exactly that, one mic at a
time over every direction and frame, in float64 torch on any device, from
:mod:`portbench.geometry`'s delays.  It imports nothing of the measured
package and takes nothing it made: only the frames the benchmark
generated.

A reference is found by the configuration's ``"algorithm"``:
``references/<algorithm>.py`` with ``maps(cfg, device, frames)``.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import geometry


def maps(cfg, device, frames: np.ndarray, block: int = 32) -> np.ndarray:
    """(B, n_mics, N) frames (any real dtype, full channel axis) ->
    (B, X, Y) float64 heatmaps, ``block`` frames at a time."""
    dev = torch.device(device)
    w, h = geometry.lerp_taps(cfg)
    active = torch.as_tensor(geometry.active_mics(cfg), device=dev)
    w = torch.as_tensor(w, device=dev)
    h = torch.as_tensor(h, dtype=torch.float64, device=dev)
    out = [_block(cfg, frames[i:i + block], active, w, h, dev)
           for i in range(0, len(frames), block)]
    return np.concatenate(out) if out else np.zeros(
        (0, cfg.max_res_x, cfg.max_res_y))


def _block(cfg, frames, active, w, h, dev) -> np.ndarray:
    s = torch.as_tensor(np.asarray(frames, np.float64),
                        device=dev)[:, active]                  # (B, M, N)
    B, M, N = s.shape
    n = torch.arange(N, device=dev)
    beam = torch.zeros((B, w.shape[0], N), dtype=torch.float64, device=dev)
    for m in range(M):
        i = n[None, :] - w[:, m, None] - 1                      # (D, N)
        valid = i >= 0
        i0 = i.clamp(min=0)
        i1 = (i + 1).clamp(min=0, max=N - 1)
        sm = s[:, m]                                            # (B, N)
        hm = h[:, m, None]
        term = sm[:, i0] + hm * (sm[:, i1] - sm[:, i0])         # (B, D, N)
        beam += torch.where(valid, term, 0.0)
    power = ((beam / M) ** 2).mean(dim=-1)
    return power.reshape(B, cfg.max_res_x, cfg.max_res_y).cpu().numpy()
