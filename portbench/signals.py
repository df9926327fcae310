"""Seeded array signals: broadband sources in a plane-wave field.

``capture`` makes, from ``--seed`` alone, what the array would record
from a few broadband sources at seeded points of the scanning window
plus independent sensor noise, as 24-bit integer samples (what the FPGA
streams before the receiver's ``/ 2**24``).  Every seed gives the same
sizes and the same kind of field; only the sources' points, spectra and
the noise differ.  It runs on the device it is given, in a few large
calls of one ``torch.Generator``: spectra drawn per source, steered to
each channel by a phase ramp, one inverse real FFT, noise added,
rounded.  The signal is periodic over its length, so a cycle of it
streams without a seam.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry

FULL_SCALE = 2 ** 23 - 1          # 24-bit signed samples


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def capture(cfg, n_frames: int, seed: int, device, n_sources: int = 3,
            band_hz=(300.0, 16000.0), noise: float = 0.1,
            rms: float = 2.0 ** 19) -> torch.Tensor:
    """(channels, n_frames * n_samples) int32 on ``device``: the connected
    channels (``active_arrays * rows * columns``, logical mic order) of a
    field of ``n_sources`` sources with a flat spectrum over ``band_hz``,
    each channel scaled to ``rms`` before noise of ``noise`` times that."""
    dev = torch.device(device)
    g = _generator(seed, dev)
    ch = cfg.active_arrays * cfg.rows * cfg.columns
    L = n_frames * cfg.n_samples
    K = L // 2 + 1
    xy = torch.as_tensor(geometry.mic_xy(cfg)[:, :ch], device=dev)
    x_max = cfg.z_scan * np.tan(np.deg2rad(cfg.view_angle / 2))
    y_max = x_max / cfg.aspect_ratio
    pos = (torch.rand((n_sources, 2), generator=g, device=dev,
                      dtype=torch.float64) * 1.6 - 0.8)
    sx, sy = pos[:, 0] * x_max, pos[:, 1] * y_max
    r = torch.sqrt(sx ** 2 + sy ** 2 + cfg.z_scan ** 2)
    # each channel leads by (fs/c)(x xi + y yi)/r samples (S, ch)
    lead = (cfg.sample_rate / cfg.propagation_speed) * (
        sx[:, None] * xy[0] + sy[:, None] * xy[1]) / r[:, None]
    gain = 0.5 + 0.5 * torch.rand(n_sources, generator=g, device=dev,
                                  dtype=torch.float64)
    spec = torch.randn((n_sources, K, 2), generator=g, device=dev)
    freq = torch.arange(K, device=dev, dtype=torch.float64) * (
        cfg.sample_rate / L)
    band = ((freq >= band_hz[0]) & (freq <= band_hz[1])).to(torch.float32)
    k = torch.arange(K, device=dev, dtype=torch.float64)
    Y = torch.zeros((ch, K), dtype=torch.complex64, device=dev)
    for s in range(n_sources):
        src = torch.view_as_complex(spec[s].contiguous()) * band * float(
            gain[s])
        # phase (ch, K) in float64, wrapped before the float32 exp
        ph = torch.remainder(2 * np.pi * lead[s][:, None] * k[None] / L,
                             2 * np.pi).to(torch.float32)
        Y += src[None] * torch.polar(torch.ones_like(ph), ph)
    sig = torch.fft.irfft(Y, n=L, dim=1)
    del Y
    sig = sig * (rms / sig.pow(2).mean(dim=1, keepdim=True).sqrt())
    sig += torch.randn(sig.shape, generator=g, device=dev) * (noise * rms)
    return sig.round().clamp(-FULL_SCALE, FULL_SCALE).to(torch.int32)


def frames_f32(cfg, samples: torch.Tensor) -> torch.Tensor:
    """(n_frames, n_microphones, n_samples) float32 frames on the samples'
    device, as the receiver delivers them: ``int / norm_factor`` in the
    connected rows (exact: |int| < 2**24), zeros in the rest."""
    ch, L = samples.shape
    n_frames = L // cfg.n_samples
    out = torch.zeros((n_frames, cfg.n_microphones, cfg.n_samples),
                      dtype=torch.float32, device=samples.device)
    out[:, :ch] = (samples.to(torch.float64) / cfg.norm_factor).to(
        torch.float32).reshape(ch, n_frames, cfg.n_samples).transpose(0, 1)
    return out
