"""A cell of the benchmark at ``Config.tiny()`` on the CPU, for the tests:
the real drivers, harness and reference, with the search for a card
skipped and short windows."""

from __future__ import annotations

import dataclasses
import time

from portbench import harness

LIMIT = 1e-4

def tiny_config(**over) -> dict:
    from zybo_rt_sampler_image_detection_torch.config import Config

    cfg = Config.tiny()
    d = {k: (list(v) if isinstance(v, tuple) else v)
         for k, v in dataclasses.asdict(cfg).items()}
    d.update(algorithm="lerp", limits={"map_gap": LIMIT},
             control={"matmul_precision": "default"})
    d.update(over)
    return d


def tiny_run(kind: str, seconds: float = 1.0, trace: bool = False,
             seed: int = 2 ** 31 + 7, break_fn=None,
             bench_dir: str = harness.HERE, traffic=None, config=None,
             cell_name=None):
    import torch

    traffic = dict(traffic or harness.load_traffic(kind))
    traffic.update(capture_frames=64, settle_s=0.3, trace_s=0.3,
                   check_maps=32, batch=min(int(traffic["batch"]), 16))
    config = config or tiny_config()
    cell = {"name": cell_name or f"cfgjson.{kind}", "config": "tiny",
            "traffic": kind, "chips": 1}
    run = harness.Run(cell=cell, config=config, traffic=traffic, seed=seed,
                      seconds=seconds, trace=trace,
                      t_start=time.perf_counter(),
                      cfg=harness.make_config(config),
                      device=torch.device("cpu"), break_fn=break_fn,
                      bench_dir=bench_dir)
    return run
