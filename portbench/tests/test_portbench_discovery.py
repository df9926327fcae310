"""The harness finds a cell, its configuration, traffic mix, driver kind,
per-layer metrics, reference and checks by name: a cell added as files
and JSON entries alone runs, with no edit to a file that was there, also
where its configuration runs another algorithm.  And the benchmark's own
``BENCHMARK.json`` keeps to its contract."""

import json
import os
import re
import shutil

import pytest

from portbench import harness
from portbench.tests.tinyrun import tiny_config, tiny_run

ROOT = os.path.dirname(harness.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _copy_bench(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root, before


def test_a_cell_added_as_files_only_runs(tmp_path):
    root, before = _copy_bench(tmp_path)
    bench = root / "portbench"
    # new files: a configuration, a traffic mix, a driver kind, a metric
    (bench / "configs" / "tinycfg.json").write_text(json.dumps(
        tiny_config()))
    mix = harness.load_traffic("replay")
    mix.update(driver="replay_again", batch=8)
    (bench / "traffic" / "small.json").write_text(json.dumps(mix))
    (bench / "drivers" / "replay_again.py").write_text(
        (bench / "drivers" / "replay.py").read_text())
    (bench / "metrics" / "batches_in_window.py").write_text(
        "def read(run):\n    return run.layer.get('window_batches')\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tinycfg", "source": "tests",
                            "file": "portbench/configs/tinycfg.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tinycfg.small", "config": "tinycfg",
                              "traffic": "small", "chips": 1, "why": "test"})
    spec["per_layer"].append({
        "name": "batches_in_window", "unit": "batches", "better": "higher",
        "source": "program_counter", "layer": "full-rate stage",
        "moves": "card_heatmaps_per_s", "workloads": ["tinycfg.small"]})
    spec["end_to_end"][0]["workloads"].append("tinycfg.small")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    spec = harness.load_spec(str(root))
    cell = harness.find_cell(spec, "tinycfg.small")
    config = harness.load_config(str(root), spec, cell["config"])
    traffic = harness.load_traffic(cell["traffic"], str(bench))
    assert traffic["driver"] == "replay_again"
    names = [m["name"] for m in harness.per_layer_of(spec, cell["name"])]
    assert "batches_in_window" in names
    run = tiny_run("replay", seconds=0.5, trace=True, traffic=traffic,
                   config=config, cell_name=cell["name"],
                   bench_dir=str(bench))
    line = harness.execute(run, spec)
    assert line["correct"] is True
    assert line["metrics"]["batches_in_window"]["value"] == \
        run.layer["window_batches"] > 0
    assert run.layer["batch"] == 8
    # every file of the benchmark that was there is unchanged (only
    # BENCHMARK.json gained entries)
    for p, data in before.items():
        assert p.read_bytes() == data, p


# pad_and_sum.c: out[w + i] += s[i], w the whole part of each delay
PAD_REFERENCE = """
import numpy as np
from portbench import geometry


def maps(cfg, device, frames):
    D = cfg.max_res_x * cfg.max_res_y
    w = np.floor(geometry.sample_delays(cfg)).astype(np.int64).reshape(D, -1)
    s = np.asarray(frames, np.float64)[:, geometry.active_mics(cfg)]
    B, M, N = s.shape
    beam = np.zeros((B, D, N))
    n = np.arange(N)
    for m in range(M):
        i = n[None, :] - w[:, m, None]
        beam += np.where(i >= 0, s[:, m][:, np.clip(i, 0, None)], 0.0)
    return ((beam / M) ** 2).mean(-1).reshape(B, cfg.max_res_x,
                                               cfg.max_res_y)
"""

MEAN_GAP = """
import numpy as np


def value(maps, ref):
    return float(np.abs(np.asarray(maps, np.float64) - ref).mean()
                 / np.abs(ref).mean())
"""


def _add_pad_cell(root):
    """A configuration of another algorithm, with a check of its own, as
    new files and BENCHMARK.json entries; its cell's name."""
    bench = root / "portbench"
    (bench / "configs" / "tinypad.json").write_text(json.dumps(tiny_config(
        algorithm="pad", limits={"map_gap": 1e-4, "mean_gap": 1e-4})))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tinypad", "source": "tests",
                            "file": "portbench/configs/tinypad.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tinypad.replay", "config": "tinypad",
                              "traffic": "replay", "chips": 1, "why": "test"})
    spec["end_to_end"][0]["workloads"].append("tinypad.replay")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return "tinypad.replay"


def _pad_run(root, break_fn=None):
    spec = harness.load_spec(str(root))
    cell = harness.find_cell(spec, "tinypad.replay")
    config = harness.load_config(str(root), spec, cell["config"])
    run = tiny_run("replay", seconds=0.5, config=config,
                   cell_name=cell["name"], break_fn=break_fn,
                   bench_dir=str(root / "portbench"))
    return run, spec


def test_a_configuration_of_another_algorithm_added_as_files_only(tmp_path):
    root, before = _copy_bench(tmp_path)
    _add_pad_cell(root)
    (root / "portbench" / "references" / "pad.py").write_text(PAD_REFERENCE)
    (root / "portbench" / "checks" / "mean_gap.py").write_text(MEAN_GAP)
    run, spec = _pad_run(root)
    line = harness.execute(run, spec)
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"map_gap", "mean_gap"}
    assert line["checks"]["map_gap"]["value"] < 1e-5
    # the lerp reference would not pass these maps: the check follows
    # the configuration's algorithm
    lerp = harness.load_reference("lerp").maps(run.cfg, "cpu", run.frames)
    assert harness.load_check("map_gap").value(run.maps, lerp) > 1e-2
    for p, data in before.items():
        assert p.read_bytes() == data, p
    # and it catches a fault of that path
    from portbench.tests.test_portbench_drivers import altered

    run, spec = _pad_run(root, break_fn=altered)
    assert harness.execute(run, spec)["correct"] is False


def test_an_algorithm_with_no_reference_fails_loudly(tmp_path):
    root, _ = _copy_bench(tmp_path)
    _add_pad_cell(root)
    (root / "portbench" / "checks" / "mean_gap.py").write_text(MEAN_GAP)
    run, spec = _pad_run(root)
    with pytest.raises(FileNotFoundError, match="no reference.*'pad'"):
        harness.execute(run, spec)
    assert run.attempted == 0          # refused before the run


def test_benchmark_json_keeps_its_contract():
    spec = harness.load_spec(ROOT)
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"]
    assert 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"].startswith("portbench/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        harness.make_config(cfg)
        assert cfg["reduced"] == c["reduced"]
        assert cfg["limits"]
        harness.load_reference(cfg["algorithm"])
        for name in cfg["limits"]:
            harness.load_check(name)
    used = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in names
        names.add(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        used.add(w["config"])
        kind = harness.load_traffic(w["traffic"])["driver"]
        assert os.path.exists(os.path.join(harness.HERE, "drivers",
                                           f"{kind}.py"))
        e2e = harness.end_to_end_of(spec, w["name"])
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert harness.per_layer_of(spec, w["name"])
    assert used == {c["name"] for c in spec["configs"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           f"{m['name']}.py"))
        assert m["moves"] in [e["name"] for e in spec["end_to_end"]]
    assert len(json.dumps(spec)) < 64 * 1024
