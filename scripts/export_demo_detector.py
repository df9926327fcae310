"""Train the demo detector with the JAX package's recipe and export its
weights for the PyTorch port.

    JAX_PLATFORMS=cpu python scripts/export_demo_detector.py

Runs ``zybo_rt_sampler_image_detection_tpu.models.train.
pretrained_demo_detector`` (64 px, width 0.25, one class, 700 steps on the
synthetic task; about half a minute on a CPU) into a temporary cache,
prints its AP@0.5 on 48 held-out frames (``synthetic_detection_batch(
default_rng(999), 48, size=64)``, the gate of ``tests/test_vision.py``),
and writes its variables, flattened to ``/``-joined keys, to
``zybo_rt_sampler_image_detection_torch/models/assets/
demo_detector_s64_w025_c1.npz``, which the port's
``detect.pretrained_demo_detector`` loads.  The machine that runs the
port needs no JAX: the file is committed.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "..", "zybo_rt_sampler_image_detection_torch",
                   "models", "assets", "demo_detector_s64_w025_c1.npz")


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=700)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.join(HERE, ".."))
    from zybo_rt_sampler_image_detection_tpu.models import data
    from zybo_rt_sampler_image_detection_tpu.models import eval as ev
    from zybo_rt_sampler_image_detection_tpu.models import train

    with tempfile.TemporaryDirectory() as tmp:
        det = train.pretrained_demo_detector(
            cache_path=os.path.join(tmp, "demo.pkl"), steps=args.steps)
    imgs, boxes = data.synthetic_detection_batch(
        np.random.default_rng(999), 48, size=64)
    ap50 = ev.evaluate_detector(det, imgs, boxes)
    flat = flatten(jax.tree.map(np.asarray, det.variables))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **flat)
    n = sum(a.size for a in flat.values())
    print(f"held-out AP@0.5 {ap50:.4f} (48 frames, seed 999); {len(flat)} "
          f"arrays, {n} values -> {os.path.relpath(args.out)} "
          f"({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
