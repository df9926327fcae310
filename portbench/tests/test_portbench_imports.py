"""Nothing the benchmark runs loads JAX or the JAX package: each entry of
``portbench`` in a fresh interpreter, and a whole run of a cell on the
CPU, compared by top-level module names.  And a run with no card, or in
a directory that holds only the benchmark, prints no result."""

import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = os.path.dirname(harness.HERE)
ENTRIES = ["portbench.run", "portbench.harness", "portbench.geometry",
           "portbench.signals", "portbench.trace", "portbench.common",
           "portbench.roofline"]

PROBE = """
import sys
{body}
from portbench import harness
print("BANNED", harness.banned_modules())
"""


def _fresh(body: str, cwd=ROOT, env=None):
    env = dict(os.environ if env is None else env)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", PROBE.format(body=body)],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_loads_no_jax(entry):
    res = _fresh(f"import {entry}")
    assert res.returncode == 0, res.stderr
    assert "BANNED []" in res.stdout


def test_drivers_metrics_references_checks_load_no_jax():
    body = ("import os\nfrom portbench import harness\n"
            "for sub, load in (('drivers', harness.load_driver),\n"
            "                  ('metrics', harness.load_reader),\n"
            "                  ('references', harness.load_reference),\n"
            "                  ('checks', harness.load_check)):\n"
            "    for f in os.listdir(os.path.join(harness.HERE, sub)):\n"
            "        load(f[:-3]) if f.endswith('.py') else 0\n")
    res = _fresh(body)
    assert res.returncode == 0, res.stderr
    assert "BANNED []" in res.stdout


def test_a_whole_cpu_run_loads_no_jax():
    body = ("from portbench.tests.tinyrun import tiny_run\n"
            "from portbench import harness\n"
            "run = tiny_run('replay', seconds=0.3, trace=True)\n"
            "line = harness.execute(run, harness.load_spec(%r))\n"
            "assert line['correct'], line\n" % ROOT)
    res = _fresh(body)
    assert res.returncode == 0, res.stderr
    assert "BANNED []" in res.stdout


def test_the_guard_sees_jax_by_its_top_level_name():
    res = _fresh("import types\nsys.modules['jax.numpy'] = "
                 "types.ModuleType('jax.numpy')\n"
                 "sys.modules['zybo_rt_sampler_image_detection_tpu_x'] = "
                 "types.ModuleType('x')")
    assert "BANNED ['jax']" in res.stdout


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "cfgjson.replay", "--seed", str(2 ** 31 + 9), "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def test_no_card_no_result():
    if harness.sys.modules.get("torch") and \
            harness.sys.modules["torch"].cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = _cli(ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = _cli(tmp_path, env)
    assert res.returncode != 0 and res.stdout.strip() == ""
