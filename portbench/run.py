"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Exits non-zero, printing no result, where there is no CUDA card (or
fewer than the cell asks for), where the measured package is missing,
where JAX or the JAX package is loaded once the window has closed, and
where a metric has no finite value (a tail of requests that more than
its share never finished).
``--control 1`` runs the configuration's ``"control"`` precision instead
(the comparison is expected to fail: see ``PERF.md``); the benchmark's
own runs never pass it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = os.path.join(ROOT, "build", "portbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")
    os.environ.setdefault("USE_FLAX", "0")


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_env()

    from portbench import harness

    spec = harness.load_spec(ROOT)
    cell = harness.find_cell(spec, args.workload)
    config = harness.load_config(ROOT, spec, cell["config"])
    traffic = harness.load_traffic(cell["traffic"])
    run = harness.Run(cell=cell, config=config, traffic=traffic,
                      seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), t_start=T_START)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        _say(f"portbench: needs {cell['chips']} CUDA device(s); "
             f"torch.cuda.is_available()={torch.cuda.is_available()}")
        return 2
    # one CPU thread for torch's own ops: the host's cores are shared,
    # and the stages' CPU copies gain nothing steady from a thread pool
    torch.set_num_threads(1)
    run.device = torch.device("cuda", 0)
    run.notes["device_kind"] = torch.cuda.get_device_name(0)
    run.cfg = harness.make_config(config, control=bool(args.control))
    line = harness.execute(run, spec)
    found = harness.banned_modules()
    if found:
        _say(f"portbench: loaded in the measuring process: {found}")
        return 3
    bad = [k for k, v in line["metrics"].items()
           if not math.isfinite(v["value"])]
    if bad:
        _say(f"portbench: no finite value for {bad} "
             f"({run.failed} of {run.attempted} failed)")
        return 4
    for name, value, limit, ok in run.checks:
        _say(f"check {name} = {value!r} (limit {limit!r}) "
             f"{'ok' if ok else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
