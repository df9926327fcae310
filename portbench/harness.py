"""Find a cell's files by name, run its traffic driver, judge and report.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
The harness reads the configuration from the ``file`` its entry names,
the mix from ``traffic/<name>.json`` and the mix's driver from
``drivers/<kind>.py`` (``kind`` is the mix's ``"driver"``); with
``--trace 1`` it reads each per-layer metric of the cell with
``metrics/<name>.py``.  The check of a run's outputs is data too: the
configuration's ``"algorithm"`` names its plain reference,
``references/<algorithm>.py``, and each key of its ``"limits"`` a
comparison, ``checks/<name>.py``.  Nothing here knows a cell, a
configuration, an algorithm or a metric by name: a new one is new files
and new entries.

The driver runs the system and fills a :class:`Run`; the harness then
compares the outputs the driver kept with the reference, checks that
nothing loaded JAX, and prints the result line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from typing import Any, Callable, Optional

BANNED = ("jax", "jaxlib", "flax", "zybo_rt_sampler_image_detection_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Run:
    """One run of one cell: what the driver gets and what it fills in."""

    cell: dict
    config: dict                  # the configuration file as written
    traffic: dict                 # the traffic file as written
    seed: int
    seconds: float
    trace: bool
    t_start: float                # host clock at process start
    cfg: Any = None               # the port's Config built from `config`
    device: Any = None            # torch.device the system runs on
    break_fn: Optional[Callable] = None   # wraps the power program (tests)
    bench_dir: str = HERE         # where the cells' own files live
    # filled by the driver
    attempted: int = 0
    failed: int = 0
    e2e: dict = dataclasses.field(default_factory=dict)
    layer: dict = dataclasses.field(default_factory=dict)
    trace_summary: Optional[dict] = None
    frames: Any = None            # (n, n_mics, N) frames as delivered
    maps: Any = None              # (n, X, Y) the system's maps of them
    checks: list = dataclasses.field(default_factory=list)
    notes: dict = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(root: str, spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_traffic(name: str, bench_dir: str = HERE) -> dict:
    with open(os.path.join(bench_dir, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(kind: str, bench_dir: str = HERE):
    return _load_module(os.path.join(bench_dir, "drivers", f"{kind}.py"),
                        f"portbench_driver_{kind}")


def load_reader(metric: str, bench_dir: str = HERE):
    safe = "".join(c if c.isalnum() else "_" for c in metric)
    return _load_module(os.path.join(bench_dir, "metrics", f"{metric}.py"),
                        f"portbench_metric_{safe}")


def load_reference(algorithm: str, bench_dir: str = HERE):
    """The plain reference of ``algorithm``; raises where it has none."""
    path = os.path.join(bench_dir, "references", f"{algorithm}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no reference for algorithm {algorithm!r}: add {path} with "
            f"maps(cfg, device, frames)")
    return _load_module(path, f"portbench_reference_{algorithm}")


def load_check(name: str, bench_dir: str = HERE):
    """The comparison named by a key of a configuration's ``limits``."""
    path = os.path.join(bench_dir, "checks", f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no check {name!r}: add {path} with value(maps, ref)")
    return _load_module(path, f"portbench_check_{name}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_of(spec: dict, cell: str) -> list:
    return [m for m in spec["end_to_end"] if _applies(m, cell)]


def per_layer_of(spec: dict, cell: str) -> list:
    e2e = {m["name"] for m in end_to_end_of(spec, cell)}
    return [m for m in spec["per_layer"]
            if m["moves"] in e2e and _applies(m, cell)]


def make_config(config: dict, control: bool = False):
    """The port's ``Config`` of a configuration file (its keys that are
    ``Config`` fields);
    ``control`` applies the file's ``"control"`` overrides (the lower
    precision that the correctness check has to fail)."""
    from zybo_rt_sampler_image_detection_torch.config import Config

    names = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in config.items() if k in names}
    for k in ("disabled_mics", "unused_mics"):
        if k in kw:
            kw[k] = tuple(kw[k])
    if control:
        kw.update(config.get("control", {}))
    return Config(**kw)


def banned_modules() -> list:
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def judge(run: Run, ref_mod, checks: dict) -> None:
    """Compare the kept outputs with ``ref_mod``, the float64 reference of
    the configuration's algorithm, by ``checks``, those its ``limits``
    name; append each to ``run.checks`` as (name, value, limit, ok)."""
    limits = run.config["limits"]
    if run.frames is None or len(run.frames) == 0:
        run.checks.append(("outputs_kept", 0, 1, False))
        return
    t0 = time.perf_counter()
    ref = ref_mod.maps(run.cfg, run.device, run.frames)
    run.notes["reference_s"] = time.perf_counter() - t0
    for name, check in checks.items():
        v = check.value(run.maps, ref)
        run.checks.append((name, v, limits[name], bool(v <= limits[name])))


def result_line(spec: dict, run: Run, per_layer: dict,
                correct: bool) -> dict:
    dev = {"platform": "gpu" if run.device.type == "cuda" else
           run.device.type,
           "kind": run.notes.get("device_kind", str(run.device)),
           "count": 1,
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": bool(correct), "attempted": int(run.attempted),
            "failed": int(run.failed)}
    if run.trace:
        s = run.trace_summary or {}
        dev["busy_s"] = s.get("busy_s", 0.0)
        dev["window_s"] = s.get("window_s", 0.0)
        line["metrics"] = per_layer
    else:
        line["metrics"] = {
            m["name"]: {"value": run.e2e[m["name"]], "unit": m["unit"]}
            for m in end_to_end_of(spec, run.cell["name"])}
    line["device"] = dev
    if run.trace and run.trace_summary:
        line["breakdown"] = {
            "device_ops": run.trace_summary["device_ops"],
            "idle_gaps": run.trace_summary["idle_gaps"]}
    line["backend"] = run.notes.get("backend")
    line["reference_s"] = run.notes.get("reference_s")
    if "per_second" in run.notes:
        line["per_second"] = run.notes["per_second"]
    line["measured"] = dict(run.e2e)
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim, _ in run.checks}
    return line


def read_per_layer(spec: dict, run: Run) -> dict:
    out = {}
    for m in per_layer_of(spec, run.cell["name"]):
        value = load_reader(m["name"], run.bench_dir).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(run: Run, spec: dict) -> dict:
    """Drive ``run``'s cell, judge it and return the result line (without
    printing it).  Raises where the run cannot give one, before it starts
    where the configuration's reference or a check is missing."""
    ref_mod = load_reference(run.config["algorithm"], run.bench_dir)
    checks = {n: load_check(n, run.bench_dir) for n in run.config["limits"]}
    drv = load_driver(run.traffic["driver"], run.bench_dir)
    drv.run(run)
    missing = [m["name"] for m in end_to_end_of(spec, run.cell["name"])
               if not run.trace and m["name"] not in run.e2e]
    if missing:
        raise RuntimeError(f"the driver measured no {missing}")
    judge(run, ref_mod, checks)
    per_layer = read_per_layer(spec, run) if run.trace else {}
    correct = all(ok for *_, ok in run.checks)
    return result_line(spec, run, per_layer, correct)
