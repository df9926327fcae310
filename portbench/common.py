"""Pieces the traffic drivers share: inputs, the sample of outputs kept
for the check, the thread clock, the kernels' launch counters."""

from __future__ import annotations

import os
import sys

import numpy as np

from . import signals


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_inputs(run, n_frames: int):
    """(n_frames, n_mics, N) float32 frames on the host, generated on the
    run's device from the seed; the device's peak is reset afterwards, so
    that the generator's memory is not read as the system's."""
    import torch

    field = run.traffic.get("field", {})
    s = signals.capture(run.cfg, n_frames, run.seed, run.device, **field)
    frames = signals.frames_f32(run.cfg, s).cpu().numpy()
    del s
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return frames


class Reservoir:
    """A uniform sample, drawn from the seed, of at most ``size`` of the
    maps offered (Algorithm R, vectorized per offer)."""

    def __init__(self, size: int, shape, seed: int):
        self.size = size
        self.maps = np.zeros((size,) + tuple(shape), np.float32)
        self.keys = np.zeros(size, np.int64)
        self.seen = 0
        self.rng = np.random.default_rng([int(seed) % (2 ** 63), 17])

    def offer(self, maps: np.ndarray, first_key: int) -> None:
        n = len(maps)
        count = self.seen + 1 + np.arange(n)             # 1-based counts
        slot = np.where(count <= self.size, count - 1,
                        (self.rng.random(n) * count).astype(np.int64))
        for i in np.nonzero(slot < self.size)[0]:
            self.maps[slot[i]] = maps[i]
            self.keys[slot[i]] = first_key + i
        self.seen += n

    def kept(self):
        n = min(self.seen, self.size)
        return self.keys[:n].copy(), self.maps[:n].copy()


def thread_cpu_s(tid: int) -> float:
    """User + system CPU seconds of thread ``tid`` of this process."""
    with open(f"/proc/self/task/{tid}/stat") as f:
        rest = f.read().rsplit(")", 1)[1].split()
    return (int(rest[11]) + int(rest[12])) / os.sysconf("SC_CLK_TCK")


def launch_counts() -> dict:
    """The port's kernel launch counters (K1, K2-K4, K5)."""
    from zybo_rt_sampler_image_detection_torch.ops import (equiv_kernel,
                                                           fused_kernel)
    return {"equiv_power": equiv_kernel.equiv_power.launches,
            "equiv_power_fd": equiv_kernel.equiv_power_fd.launches,
            "fused_power": fused_kernel.fused_power.launches}


def backend_note(before: dict, after: dict, batches: int) -> dict:
    """Which kernel the policy's program launched, and how often a batch."""
    per = {k: (after[k] - before[k]) / batches if batches else 0.0
           for k in after}
    ran = [k for k, v in per.items() if v > 0]
    return {"kernel": ran[0] if len(ran) == 1 else (ran or "plain torch"),
            "launches_per_batch": per}


def release_device(run) -> None:
    """Read the device's peak, then free what the system held."""
    import gc

    import torch

    if run.device.type == "cuda":
        torch.cuda.synchronize()
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        gc.collect()
        torch.cuda.empty_cache()
