"""Offline validation plots — the reference's golden harness.

``PC/plot.py:8-39`` injects a synthetic 8 kHz sine on every mic, runs each
MIMO wrapper (``benchmark.pyx``) and eyeballs ``imshow`` heatmaps.  Here the
same harness runs every beamformer (pad / lerp / convolve / hybrid /
truncated / fft / mvdr) and writes a comparison panel to PNG::

    python -m zybo_rt_sampler_image_detection_torch.apps.plot --out heatmaps.png
    python -m zybo_rt_sampler_image_detection_torch.apps.plot --npy capture.npy
    python -m zybo_rt_sampler_image_detection_torch.apps.plot --device cpu --algos fft mvdr

The maps are computed on the card unless ``--device cpu``; matplotlib is
imported only to draw the panel.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import Config
from ..ops import beamform, freq


def generate_sig(cfg: Config, frequency: float = 8000.0) -> np.ndarray:
    """``plot.py:8-20``: one sinusoid replicated onto every channel."""
    t = np.arange(cfg.n_samples) / cfg.sample_rate
    sig = np.sin(2 * np.pi * frequency * t).astype(np.float32)
    return np.tile(sig, (cfg.n_microphones, 1))


ALGOS = ("pad", "lerp", "convolve", "hybrid", "truncated", "fft", "mvdr")


def compute_heatmaps(cfg: Config, frame: np.ndarray, algos=ALGOS,
                     device="cuda") -> dict:
    """``{algorithm: (X, Y) float32 heatmap}`` of one (channels, N) frame;
    fft/mvdr over the 100-20000 Hz band, MVDR from the covariance of this
    one frame."""
    x = torch.as_tensor(np.asarray(frame, np.float32),
                        device=beamform.resolve_device(device))
    out = {}
    ft = None
    for algo in algos:
        if algo in ("fft", "mvdr"):
            if ft is None:
                ft = freq.make_freq_tables(cfg, 100.0, 20000.0, device=device)
            if algo == "fft":
                img = freq.fft_steered_power(x, ft)
            else:
                state = freq.update_covariance(freq.init_covariance(ft), x,
                                               ft)
                img = freq.mvdr_power(state, ft)
        else:
            tables = beamform.make_tables(cfg, algo, device=device)
            img = beamform.steered_power(x, tables)
        out[algo] = img.cpu().numpy()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="heatmaps.png")
    ap.add_argument("--npy", default=None,
                    help="use a recorded capture instead of the synthetic sine")
    ap.add_argument("--freq", type=float, default=8000.0)
    ap.add_argument("--algos", nargs="*", default=list(ALGOS))
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda raises when no GPU is present)")
    args = ap.parse_args(argv)

    cfg = Config()
    if args.npy:
        rec = np.load(args.npy).astype(np.float32)
        frame = rec[:, : cfg.n_samples]
    else:
        frame = generate_sig(cfg, args.freq)

    maps = compute_heatmaps(cfg, frame, args.algos, device=args.device)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(maps)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4))
    if n == 1:
        axes = [axes]
    for ax, (name, img) in zip(axes, maps.items()):
        ax.imshow(img.T[::-1], aspect="auto", cmap="jet")
        peak = np.unravel_index(img.argmax(), img.shape)
        ax.set_title(f"{name} (peak {peak})")
    fig.tight_layout()
    fig.savefig(args.out, dpi=100)
    print(f"wrote {args.out}: " + ", ".join(
        f"{k} peak={np.unravel_index(v.argmax(), v.shape)}"
        for k, v in maps.items()))


if __name__ == "__main__":
    main()
