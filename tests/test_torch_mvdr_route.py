"""The MVDR route as the benchmark measures it (``cfgjson_mvdr.stream``),
on the CPU:

* the route's stream (``make_mvdr_stream("maps")``) against the
  benchmark's float64 stream reference (``portbench/references/mvdr.py``)
  through several refresh epochs, and the reference from a truncated
  history against the one from the stream's reset;
* the configuration's estimator constants are the stream's defaults;
* the route's spans and counters, at their cadence;
* the precision rung of the route's products;
* the ``stream`` traffic driver: a tiny cell is correct, faults of the
  program fail its check, the contiguous sample and its count, a skipped
  batch counts as failed;
* the roofline counts and the benchmark's entries.

No UDP: the frames are published into the receiver's ring directly."""

import dataclasses
import inspect
import json
import math
import os

import numpy as np
import pytest
import torch

from portbench import harness, roofline_mvdr, signals
from portbench.tests.test_portbench_drivers import altered, shifted, stale
from portbench.tests.tinyrun import tiny_config, tiny_run
from zybo_rt_sampler_image_detection_torch.apps import pipeline
from zybo_rt_sampler_image_detection_torch.config import Config
from zybo_rt_sampler_image_detection_torch.ops import beamform, freq
from zybo_rt_sampler_image_detection_torch.utils import profiling

ROOT = os.path.dirname(harness.HERE)
SPEC = harness.load_spec(ROOT)
CONFIG = harness.load_config(ROOT, SPEC, "cfgjson_mvdr")
TRAFFIC = harness.load_traffic("stream")
reference = harness.load_reference("mvdr")
driver = harness.load_driver("stream")
map_gap = harness.load_check("map_gap").value
H100 = "NVIDIA H100 80GB HBM3"
K = 16

# two 4x4 board slots, the second unconnected and listed as unused, as
# cfgjson_mvdr lists its fourth board: the covariance spans 16 mics
SMALL = Config.tiny().replace(n_microphones=32, array_slots=2,
                              unused_mics=tuple(range(16, 32)))
CONNECTED = 16


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as the benchmark's process runs: the tiny
    stage and its reference are small, and a thread pool per test worker
    only contends for the cores the suite's other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sample(frames, first, n):
    """A stream sample as the driver hands it to the reference."""
    return driver.StreamSample(frames, first, n, dict(CONFIG["mvdr"]))


def _frames(cfg, n, seed):
    """(n, n_microphones, N) float32 frames of the benchmark's seeded
    field (the connected channels; zeros in the rest)."""
    return signals.frames_f32(cfg, signals.capture(cfg, n, seed,
                                                   "cpu")).numpy()


def _stream_maps(cfg, frames, dtype=np.float32):
    """The route's stream fed ``frames`` from its reset, K at a time, as
    the full-rate stage hands them over (the connected channels)."""
    fn = pipeline.make_mvdr_stream(cfg, "maps", device="cpu")
    fn.reset()
    return np.concatenate([
        fn(torch.from_numpy(frames[i:i + K, :CONNECTED].astype(dtype)))
        .numpy() for i in range(0, len(frames), K)])


# Gates of the route against the float64 reference at SMALL, 448 frames
# from the reset (seven refresh epochs).  Complex128 frames: the route's
# steering tensor is complex64 (relative 6e-8), which the loaded
# covariance's conditioning amplifies, most in the first epoch, before
# any refresh (4.3e-6 measured).  Float32 frames: the complex64 Woodbury
# recursion's drift between refreshes (9.1e-4 measured, 5.5e-6 in the
# first epoch).
STREAM_GATES = {np.float64: 2e-5, np.float32: 5e-3}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_stream_matches_the_reference_through_refreshes(dtype):
    frames = _frames(SMALL, 448, 2 ** 31 + 21)
    maps = _stream_maps(SMALL, frames, dtype)
    ref = reference.maps(SMALL, "cpu", _sample(frames, 0, len(frames)))
    assert ref.shape == maps.shape == (448, 9, 7)
    assert ref.dtype == np.float64
    gaps = [map_gap(maps[i:i + 64], ref[i:i + 64])
            for i in range(0, 448, 64)]
    assert max(gaps) < STREAM_GATES[dtype], gaps
    # the refreshes keep the drift from growing epoch over epoch
    assert max(gaps[4:]) < 2 * max(gaps[:4]) + 1e-6, gaps


def test_reference_from_a_truncated_history_equals_it_from_reset():
    frames = _frames(SMALL, 448, 2 ** 31 + 22)
    full = reference.maps(SMALL, "cpu", _sample(frames, 0, 32))
    # 96 frames in: the checked frames' refresh (384) lies 288 frames
    # after the history's start, so the left-out frames weigh 0.9^288
    cut = reference.maps(SMALL, "cpu", _sample(frames[96:], 96, 32))
    assert map_gap(cut, full) < 1e-12


def test_reference_refuses_a_history_short_of_the_refresh():
    frames = _frames(SMALL, 96, 2 ** 31 + 23)
    # checked frames 80..95 of the epoch that starts at 64, history from 72
    with pytest.raises(ValueError, match="history"):
        reference.maps(SMALL, "cpu", _sample(frames[72:], 72, 16))


def test_configuration_constants_are_the_stream_defaults():
    stream = inspect.signature(pipeline.make_mvdr_stream).parameters
    mvdr = CONFIG["mvdr"]
    assert mvdr["alpha"] == stream["alpha"].default == 0.9
    assert mvdr["band_low_hz"] == stream["band_low"].default == 100.0
    load = inspect.signature(freq.init_precision).parameters["load"]
    assert mvdr["load"] == load.default == 1e-3
    # the refresh is checked at batch ends: every 64 frames at K=16
    every = freq.refresh_interval(mvdr["alpha"])
    assert every == 63 and TRAFFIC["batch"] == K
    assert mvdr["refresh_frames"] == K * math.ceil(every / K) == 64
    cfg = harness.make_config(CONFIG)
    assert cfg == Config(unused_mics=tuple(range(192, 256)),
                         matmul_precision="highest")
    assert harness.make_config(CONFIG, control=True).matmul_precision == \
        "default"
    # 192 connected mics, 127 bins (100 Hz to Nyquist), 1,824 directions
    from zybo_rt_sampler_image_detection_torch.ops import geometry

    assert geometry.active_microphones(cfg)[1] == 192
    assert reference.band(cfg, mvdr["band_low_hz"]) == (1, 128)
    assert roofline_mvdr.bins(cfg, mvdr["band_low_hz"]) == 127


def _pipeline(frames, cfg=SMALL):
    p = pipeline.Pipeline(cfg, "mvdr", backend="python", device="cpu",
                          ring_frames=len(frames))
    for f in frames:
        p.receiver.buffer.publish(f)
    return p


def test_spans_and_counters_follow_the_cadence(tmp_path):
    """Eight batches of 16 from the reset: a refresh every 4th batch, a
    full quadratic form every 2nd, inside the stage's ``power.program``;
    the stream's counters and ``Pipeline.report()`` agree."""
    frames = _frames(SMALL, 8 * K, 2 ** 31 + 24)
    p = _pipeline(frames)
    stage = p.make_heatmap_batched(batch=K, sink=lambda *a: None,
                                   channels=CONNECTED)
    stage.warmup()
    fn = stage.stateful_fn
    before = dict(fn.counts)
    with profiling.trace(str(tmp_path)):
        nxt = 1
        for _ in range(8):
            nxt = stage._step(nxt)
        stage._drain()
    got = {k: fn.counts[k] - before[k] for k in before}
    assert got == {"refreshes": 2, "quad_forms": 4, "quad_form_launches": 0,
                   "frames": 8 * K}
    assert p.report()["mvdr"] == fn.counts
    rep = profiling.report()
    assert rep["power.program"]["n"] == 8
    assert rep["power.mvdr_scan"]["n"] == 8
    assert rep["power.mvdr_d0"]["n"] == 4
    assert rep["power.mvdr_refresh"]["n"] == 2
    inner = sum(rep[n]["total_s"] for n in
                ("power.mvdr_scan", "power.mvdr_d0", "power.mvdr_refresh"))
    assert inner <= rep["power.program"]["total_s"]


def test_live_frame_counts_a_quadratic_form():
    frames = _frames(SMALL, 2, 2 ** 31 + 25)
    fn = pipeline.make_mvdr_stream(SMALL, "maps", device="cpu")
    fn.reset()
    for f in frames:
        fn(torch.from_numpy(f))
    assert fn.counts == {"refreshes": 0, "quad_forms": 2,
                         "quad_form_launches": 0, "frames": 2}


def test_other_routes_report_no_stream():
    p = pipeline.Pipeline(SMALL, "fft", backend="python", device="cpu")
    assert "mvdr" not in p.report()


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_true_fp32_rungs_are_the_route_as_it_was(precision, monkeypatch):
    """At ``highest`` and ``high`` the route's maps equal, bit for bit,
    the route whose products pin true FP32 unconditionally (the rung's
    context replaced by ``set_fp32_matmul`` alone)."""
    cfg = SMALL.replace(matmul_precision=precision)
    frames = _frames(cfg, 6 * K, 2 ** 31 + 26)
    maps = _stream_maps(cfg, frames)

    class _Pinned:
        def __init__(self, t):
            pass

        def __enter__(self):
            beamform.set_fp32_matmul()

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(freq, "_products", _Pinned)
    np.testing.assert_array_equal(maps, _stream_maps(cfg, frames))


def test_default_rung_lets_cublas_take_tf32_in_its_block():
    matmul = torch.backends.cuda.matmul
    beamform.set_fp32_matmul()
    t = freq.FreqTables(phase=torch.zeros((1, 1, 1), dtype=torch.complex64),
                        adaptive=torch.zeros(1, dtype=torch.int64), lo=0,
                        hi=1, res_x=1, res_y=1, n_samples=2,
                        precision="default")
    try:
        with freq._products(t):
            assert matmul.allow_tf32
            with freq._products(t):             # nested: kept
                assert matmul.allow_tf32
            assert matmul.allow_tf32
        assert not matmul.allow_tf32            # restored
        with freq._products(dataclasses.replace(t, precision="high")):
            assert not matmul.allow_tf32
    finally:
        beamform.set_fp32_matmul()


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_inverse_from_the_factor_equals_lapacks(dtype):
    """The card's refresh inverse (a triangular solve and one product)
    against LAPACK's potri from the same factor, on the CPU."""
    g = torch.Generator().manual_seed(5)
    X = torch.randn((4, 24, 6), dtype=dtype, generator=g)
    R = X @ X.mH + 1e-2 * torch.eye(24, dtype=dtype)
    L = torch.linalg.cholesky(R)
    want = torch.cholesky_inverse(L)
    got = freq._inverse_from_factor(L)
    tol = 1e-10 if dtype == torch.complex128 else 2e-3
    assert ((got - want).abs().max() / want.abs().max()).item() < tol


# --- the stream traffic driver at tiny size ---------------------------------

def _stream_config(**over):
    config = tiny_config(n_microphones=32, array_slots=2,
                         unused_mics=list(SMALL.unused_mics))
    config.update(algorithm="mvdr", mvdr=dict(CONFIG["mvdr"]),
                  limits=dict(CONFIG["limits"]),
                  control=dict(CONFIG["control"]))
    config.update(over)
    return config


def _stream_run(trace=False, break_fn=None, seconds=1.0):
    run = tiny_run("stream", seconds=seconds, trace=trace,
                   config=_stream_config(), cell_name="cfgjson_mvdr.stream",
                   break_fn=break_fn)
    return run, harness.execute(run, SPEC)


def test_stream_cell_is_correct_and_its_sample_contiguous():
    run, line = _stream_run()
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 4 * K
    assert line["checks"]["map_gap"]["value"] < CONFIG["limits"]["map_gap"]
    # one contiguous run of 32 maps, at a batch boundary, with the frames
    # the stream absorbed before it (up to history_frames) and their count
    sample, lay = run.frames, run.layer
    assert len(sample) == 32 == len(run.maps)
    first = lay["check_first_seq"] - lay["stream_first_seq"]
    assert first % K == 0 and first > 0
    hist = len(sample.frames) - len(sample)
    assert hist == min(TRAFFIC["history_frames"], first)
    assert sample.first == first - hist
    assert sample.mvdr == CONFIG["mvdr"]
    rec = _frames(run.cfg, 64, run.seed)          # the seeded recording
    seqs = lay["stream_first_seq"] + sample.first + np.arange(
        len(sample.frames))
    np.testing.assert_array_equal(sample.frames, rec[(seqs - 1) % 64])
    # the counters over the window's batches, read at its edges while
    # the stage runs (a batch in flight either side)
    n = lay["window_batches"]
    total = {k: v * n for k, v in line["backend"]["mvdr_per_batch"].items()}
    assert abs(total["frames"] - K * n) <= 2 * K
    assert abs(total["refreshes"] - n / 4) <= 2
    assert abs(total["quad_forms"] - n / 2) <= 2


@pytest.mark.parametrize("fault", [altered, shifted, stale])
def test_stream_check_catches(fault):
    _, line = _stream_run(break_fn=fault, seconds=0.5)
    assert line["correct"] is False
    assert line["checks"]["map_gap"]["value"] > CONFIG["limits"]["map_gap"]


def test_traced_stream_run_reads_its_layers():
    _, line = _stream_run(trace=True, seconds=0.5)
    m = line["metrics"]
    assert m["mvdr_host_ms_per_batch.stream"]["value"] > 0
    assert m["mvdr_host_ms_per_batch.stream"]["unit"] == "ms"
    # no card: no kernel time, no peaks, so no roofline share
    assert "mvdr_roofline" not in m
    # the cell reads no metric of the other routes
    assert not {"power_roofline", "fft_roofline"} & set(m)


def test_stream_cell_needs_the_stream_counters(monkeypatch):
    """A program whose stream keeps no counters cannot give the cell's
    line: the run stops before the warm-up."""
    build = pipeline.make_mvdr_stream

    def without_counts(*a, **kw):
        fn = build(*a, **kw)
        del fn.counts
        return fn

    monkeypatch.setattr(pipeline, "make_mvdr_stream", without_counts)
    with pytest.raises(RuntimeError, match="counters"):
        _stream_run(seconds=0.3)


def test_a_batch_that_does_not_follow_fails():
    batches = [(0.5, 1, K), (1.0, 17, K), (1.5, 33, K), (2.0, 65, K),
               (2.5, 81, K), (3.5, 97, K)]
    assert driver.window_counts(batches, 1.0, 3.0) == (4 * K, K)
    assert driver.window_counts(batches[:3], 0.0, 3.0) == (3 * K, 0)


@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 27])
def test_run_keeper_keeps_a_contiguous_run(seed):
    keeper = driver._RunKeeper(3, 2, (1, 1), seed)
    firsts = [1, 3, 5, 7, 11, 13, 15, 17, 19]      # a gap after 7
    for f in firsts:
        keeper.offer(np.full((2, 1, 1), f, np.float32), f)
    assert keeper.complete == 5                   # runs ending at 5,7,15,..
    assert keeper.first in (1, 3, 11, 13, 15)
    np.testing.assert_array_equal(
        keeper.maps.ravel(), np.repeat(keeper.first + 2 * np.arange(3), 2))


def test_roofline_counts_of_cfgjson_mvdr():
    cfg = harness.make_config(CONFIG)
    ops, nbytes = roofline_mvdr.mvdr_counts(cfg, CONFIG["mvdr"], K, 192)
    F, M, D = 127, 192, 57 * 32
    assert ops == (8 * F * M * D * K + 8 * F * 4 * M * M * K
                   + (8 * F * M * M * D + 4 * F * M ** 3) * K / 64)
    assert nbytes == (8 * F * M * D + 32 * F * M * M + 4 * K * 192 * 256
                      + 4 * K * D)
    bound = roofline_mvdr.mvdr_bound_s(cfg, CONFIG["mvdr"], K, 192, H100)
    assert bound == pytest.approx(ops / 67e12)          # bound by operations
    assert bound * 1e3 == pytest.approx(0.3891, rel=1e-3)
    assert roofline_mvdr.mvdr_bound_s(cfg, CONFIG["mvdr"], K, 192,
                                      "a card") is None


def test_the_cfgjson_mvdr_entries():
    cell = harness.find_cell(SPEC, "cfgjson_mvdr.stream")
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("cfgjson_mvdr", "stream", 1)
    assert TRAFFIC["driver"] == "stream"
    assert (TRAFFIC["check_maps"], TRAFFIC["history_frames"]) == (256, 512)
    names = [m["name"] for m in harness.end_to_end_of(SPEC, cell["name"])]
    assert names == ["card_heatmaps_per_s", "setup_s"]
    assert {m["name"] for m in harness.per_layer_of(SPEC, cell["name"])} \
        == {"mvdr_roofline", "mvdr_host_ms_per_batch.stream",
            "mvdr_scan_device_ms_per_batch.stream",
            "mvdr_d0_device_ms_per_batch.stream",
            "mvdr_refresh_device_ms_per_batch.stream"}
    assert CONFIG["algorithm"] == "mvdr" and CONFIG["reduced"] == []
    # the keys of cfgjson, the estimator's block and the numbers it sets
    with open(os.path.join(ROOT, "portbench", "configs",
                           "cfgjson.json")) as f:
        base = json.load(f)
    assert set(CONFIG) - set(base) == {"mvdr", "limits_why"}
    changed = {k for k in base if CONFIG[k] != base[k]}
    assert changed == {"deployment", "source", "assumed", "unused_mics",
                       "matmul_precision", "algorithm", "limits"}
    assert reference.maps(harness.make_config(CONFIG), "cpu", _sample(
        np.zeros((0, 256, 256), np.float32), 0, 0)).shape == (0, 57, 32)
