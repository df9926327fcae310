"""The web app's FFT backend as a route of the port (``Pipeline(cfg,
"fft")``) on the CPU:

* both heatmap stages (the full-rate stage, with a channel-sliced
  transfer, and the live ``HeatmapProducer``) give
  ``freq.fft_steered_power``'s maps and the JAX package's, at the JAX
  gate;
* the benchmark's float64 reference (``portbench/references/fft.py``)
  agrees with the JAX package, at a small FFT configuration and at
  ``Config.fft_reference()``;
* the route follows ``matmul_precision``: the ``default`` rung leaves the
  reference by more than the benchmark's limit, ``highest`` stays far
  inside it;
* its spans and its launch counter, the roofline counts, and a run of an
  FFT configuration through the benchmark's harness.

No UDP: the frames are published into the receiver's ring directly."""

import numpy as np
import pytest
import torch

import zybo_rt_sampler_image_detection_tpu as zj
from portbench import harness, roofline_bartlett, signals
from portbench.tests.test_portbench_drivers import altered, shifted
from portbench.tests.tinyrun import tiny_config, tiny_run
from zybo_rt_sampler_image_detection_tpu.ops import freq as jf
from zybo_rt_sampler_image_detection_torch.apps import pipeline
from zybo_rt_sampler_image_detection_torch.config import Config
from zybo_rt_sampler_image_detection_torch.ops import freq
from zybo_rt_sampler_image_detection_torch.utils import profiling

FFT_GATE = dict(rtol=2e-4, atol=1e-6)           # tests/test_torch_freq.py
LIMIT = 1e-4                                    # configs/webfft.json
H100 = "NVIDIA H100 80GB HBM3"
reference = harness.load_reference("fft")
map_gap = harness.load_check("map_gap").value

# two 4x4 board slots, one connected: the frame carries 32 rows, the FFT
# stack's model 16 active mics lowered by the camera offset, in a band
SMALL = Config.tiny().replace(
    n_microphones=32, array_slots=2, fft_mic_model="fft",
    camera_offset=0.11, freq_band_low=500.0, freq_band_high=18000.0)
CONFIGS = {"small": SMALL, "fft_reference": Config.fft_reference()}


def _jcfg(cfg):
    return zj.Config(**{f: getattr(cfg, f) for f in
                        cfg.__dataclass_fields__})


def _frames(cfg, n, seed):
    """(n, n_microphones, N) float32 frames of the benchmark's seeded
    field (the connected channels; zeros in the rest)."""
    return signals.frames_f32(cfg, signals.capture(cfg, n, seed,
                                                   "cpu")).numpy()


def _jax_maps(cfg, frames):
    return np.asarray(jf.fft_steered_power(
        frames, jf.make_freq_tables(_jcfg(cfg))))


def _pipeline(frames):
    p = pipeline.Pipeline(SMALL, "fft", backend="python", device="cpu")
    for f in frames:
        p.receiver.buffer.publish(f)
    return p


def test_pipeline_fft_builds_the_freq_tables_alone():
    p = pipeline.Pipeline(SMALL, "fft", backend="python", device="cpu")
    assert isinstance(p.power_tables, freq.FreqTables)
    assert p.power_tables.precision == SMALL.matmul_precision
    assert p._tables is None                 # no time-domain tables yet
    assert p.tables.algorithm == "lerp"      # built at the first use
    web = pipeline.Pipeline(SMALL, "fft", backend="python", device="cpu",
                            listen_algorithm="pad")
    assert web.tables.algorithm == "pad"


@pytest.mark.parametrize("kw", [dict(power_backend="freq_equiv"),
                                dict(power_backend="equiv_kernel")])
def test_pipeline_fft_refuses_time_domain_backends(kw):
    with pytest.raises(ValueError, match="fft route"):
        pipeline.Pipeline(SMALL, "fft", backend="python", device="cpu",
                          **kw)


def test_pipeline_fft_refuses_a_mesh():
    from zybo_rt_sampler_image_detection_torch.parallel import mesh

    p = pipeline.Pipeline(SMALL, "fft", backend="python", device="cpu")
    m = mesh.make_mesh(1, 1, devices=[torch.device("cpu")])
    with pytest.raises(ValueError, match="fft route"):
        p.make_heatmap_batched(batch=4, mesh=m)


def test_full_rate_stage_runs_bartlett_on_sliced_batches():
    """K=4 batches of the 16 connected rows, padded back to the frame's 32
    before the gather: the maps of every frame, in order."""
    frames = _frames(SMALL, 12, 2 ** 31 + 11)
    p = _pipeline(frames)
    got = {}

    def sink(powers, first):
        for j, pw in enumerate(powers):
            got[first + j] = pw

    stage = p.make_heatmap_batched(batch=4, sink=sink, channels=16)
    stage.warmup()
    nxt = 1
    for _ in range(3):
        nxt = stage._step(nxt)
    stage._drain()
    maps = np.stack([got[s] for s in range(1, 13)])
    want = np.concatenate([freq.fft_steered_power(
        torch.from_numpy(frames[i:i + 4]), p.power_tables).numpy()
        for i in range(0, 12, 4)])
    np.testing.assert_array_equal(maps, want)
    np.testing.assert_allclose(maps, _jax_maps(SMALL, frames), **FFT_GATE)


def test_live_stage_runs_bartlett():
    frames = _frames(SMALL, 4, 2 ** 31 + 12)
    p = pipeline.Pipeline(SMALL, "fft", backend="python", device="cpu")
    p.start_heatmap()
    try:
        seen = {}
        for f in frames:
            p.receiver.buffer.publish(f)
            power, seq = p.q_power.get(timeout=30.0)
            seen[seq] = power
    finally:
        p.stop()
    assert seen
    want = _jax_maps(SMALL, frames)
    for seq, power in seen.items():
        np.testing.assert_allclose(
            power, freq.fft_steered_power(frames[seq - 1],
                                          p.power_tables).numpy(),
            rtol=0, atol=0)
        np.testing.assert_allclose(power, want[seq - 1], **FFT_GATE)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_agrees_with_jax(name):
    cfg = CONFIGS[name]
    frames = _frames(cfg, 3, 2 ** 31 + 13)
    ref = reference.maps(cfg, "cpu", frames, block=2)
    assert ref.shape == (3, cfg.max_res_x, cfg.max_res_y)
    assert ref.dtype == np.float64
    assert map_gap(_jax_maps(cfg, frames), ref) < 1e-5
    # its own transcription of the FFT stack's geometry: the JAX
    # package's tables, bins and mic selection
    jt = jf.make_freq_tables(_jcfg(cfg))
    assert reference.band(cfg) == (jt.lo, jt.hi)
    np.testing.assert_array_equal(reference.active_mics(cfg),
                                  np.asarray(jt.adaptive))
    ph = reference.phase(cfg)
    np.testing.assert_allclose(ph.real, np.asarray(jt.phase_re).reshape(
        ph.shape), rtol=0, atol=1e-7)
    np.testing.assert_allclose(ph.imag, np.asarray(jt.phase_im).reshape(
        ph.shape), rtol=0, atol=1e-7)


@pytest.mark.parametrize("precision,low,high", [
    ("highest", 0.0, 1e-5), ("high", 0.0, 1e-5), ("default", LIMIT, 1.0)])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_route_follows_the_precision(name, precision, low, high):
    cfg = CONFIGS[name].replace(matmul_precision=precision)
    frames = _frames(cfg, 4, 2 ** 31 + 14)
    t = freq.make_freq_tables(cfg, device="cpu")
    maps = pipeline.power_program(t)(torch.from_numpy(frames)).numpy()
    gap = map_gap(maps, reference.maps(cfg, "cpu", frames))
    assert low < gap < high, gap


def test_spans_and_launches(tmp_path):
    frames = _frames(SMALL, 8, 2 ** 31 + 15)
    p = _pipeline(frames)
    stage = p.make_heatmap_batched(batch=4, sink=lambda *a: None)
    stage.warmup()
    before = freq.fft_steered_power.launches
    with profiling.trace(str(tmp_path)):
        nxt = stage._step(1)
        stage._step(nxt)
        stage._drain()
    assert freq.fft_steered_power.launches - before == 2
    rep = profiling.report()
    for name in ("power.program", "power.fft_spectra", "power.fft_contract"):
        assert rep[name]["n"] == 2, name
    # both inside the stage's power.program, whose self time leaves them
    # out
    inner = rep["power.fft_spectra"]["total_s"] + \
        rep["power.fft_contract"]["total_s"]
    prog = rep["power.program"]
    assert inner <= prog["total_s"]
    assert prog["self_s"] < prog["total_s"]


def test_roofline_counts_of_webfft():
    cfg = Config.fft_reference()
    assert roofline_bartlett.bins(cfg) == 94
    ops, nbytes = roofline_bartlett.bartlett_counts(cfg, 16, 256)
    assert ops == 8 * 94 * 256 * 169 * 16 == 520_552_448
    assert nbytes == 36_739_648 == (4 * 16 * 256 * 256 + 8 * 94 * 256 * 169
                                    + 4 * 16 * 169)
    bound = roofline_bartlett.bartlett_bound_s(cfg, 16, 256, H100)
    assert bound == pytest.approx(nbytes / 3.35e12)       # bound by bytes
    assert bound * 1e6 == pytest.approx(10.97, rel=1e-3)
    assert roofline_bartlett.bartlett_bound_s(cfg, 16, 256, "a card") is None


def _fft_run(trace=False, break_fn=None):
    config = tiny_config(
        **{k: getattr(SMALL, k) for k in
           ("n_microphones", "array_slots", "fft_mic_model",
            "camera_offset", "freq_band_low", "freq_band_high")})
    config.update(algorithm="fft")
    run = tiny_run("replay", seconds=0.5, trace=trace, config=config,
                   cell_name="webfft.replay", break_fn=break_fn)
    return run, harness.execute(run, harness.load_spec(
        harness.os.path.dirname(harness.HERE)))


def test_harness_runs_an_fft_configuration():
    run, line = _fft_run(trace=True)
    assert line["correct"] is True and line["failed"] == 0
    assert line["checks"]["map_gap"]["value"] < LIMIT / 10
    assert run.layer["channels"] == 16 and len(run.frames) == 32
    m = line["metrics"]
    for name in ("fft_spectra_ms_per_batch.replay",
                 "fft_contract_ms_per_batch.replay"):
        assert m[name]["value"] > 0 and m[name]["unit"] == "ms"
    # no card: no kernel time, no peaks, so no roofline share
    assert "fft_roofline" not in m
    # the cell reads no metric of K1's route
    assert "power_roofline" not in m


@pytest.mark.parametrize("fault", [altered, shifted])
def test_harness_catches_a_fault_of_the_fft_route(fault):
    _, line = _fft_run(break_fn=fault)
    assert line["correct"] is False
    assert line["checks"]["map_gap"]["value"] > LIMIT


def test_the_webfft_entries():
    spec = harness.load_spec(harness.os.path.dirname(harness.HERE))
    cell = harness.find_cell(spec, "webfft.replay")
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("webfft", "replay", 1)
    config = harness.load_config(harness.os.path.dirname(harness.HERE),
                                 spec, "webfft")
    assert harness.make_config(config) == Config.fft_reference()
    assert harness.make_config(config, control=True).matmul_precision == \
        "default"
    names = [m["name"] for m in harness.end_to_end_of(spec, cell["name"])]
    assert names == ["card_heatmaps_per_s", "setup_s"]
    assert {m["name"] for m in harness.per_layer_of(spec, cell["name"])} \
        == {"fft_roofline", "fft_spectra_ms_per_batch.replay",
            "fft_contract_ms_per_batch.replay",
            "power_prep_device_ms_per_batch.replay",
            "power_kernel_device_ms_per_batch.replay"}
    assert reference.maps(Config.fft_reference(), "cpu",
                          np.zeros((0, 256, 256), np.float32)).shape == \
        (0, 13, 13)
