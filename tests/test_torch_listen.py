"""The port's listening slice: ``miso_beam`` and its helpers against the
JAX package (and its float64 oracle) at the gates of
``tests/test_beamform.py:89,156,166,187``; the audio accounting; and the
listening stages on loopback against JAX ``miso_beam`` on the
int32-quantized wire frames at the gates of ``tests/test_fullrate.py:204,
252,258`` (rtol 1e-4 / atol 1e-7 for the stream, 1e-4 for the maps).
UDP ports 22130-22139."""

import subprocess
import sys
import time
import wave

import numpy as np
import pytest
import torch

import zybo_rt_sampler_image_detection_tpu as zj
from zybo_rt_sampler_image_detection_tpu.ops import beamform as jb
from zybo_rt_sampler_image_detection_tpu.ops import geometry as jg
from zybo_rt_sampler_image_detection_tpu.ops import oracle
from zybo_rt_sampler_image_detection_tpu.utils import audio as jaudio
from zybo_rt_sampler_image_detection_torch.apps import demo, pipeline
from zybo_rt_sampler_image_detection_torch.config import Config
from zybo_rt_sampler_image_detection_torch.ingest import streamer
from zybo_rt_sampler_image_detection_torch.ops import beamform
from zybo_rt_sampler_image_detection_torch.utils.metrics import (
    PipelineMetrics)

torch.set_num_threads(2)

MISO_GATE = dict(rtol=2e-4, atol=1e-6)          # test_beamform.py:89
CONVOLVE_GATE = dict(rtol=2e-3, atol=1e-5)      # test_beamform.py:156
MULTI_GATE = dict(rtol=1e-6, atol=1e-8)         # test_beamform.py:166,187
STREAM_GATE = dict(rtol=1e-4, atol=1e-7)        # test_fullrate.py:204,258


def _jcfg(cfg):
    return zj.Config(**{f: getattr(cfg, f) for f in
                        cfg.__dataclass_fields__})


def _tables(cfg, algorithm):
    """The port's tables and the JAX package's, same config."""
    return (beamform.make_tables(cfg, algorithm, cache=False, device="cpu"),
            jb.make_tables(_jcfg(cfg), algorithm, cache=False))


def _frames(cfg, n, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, cfg.n_microphones, cfg.n_samples))
            * 0.3).astype(np.float32)


def _wire(cfg, frame):
    """The frame as the receiver rebuilds it from int32 samples."""
    return (np.round(frame.astype(np.float64) * cfg.norm_factor)
            / cfg.norm_factor).astype(np.float32)


class _CaptureSink:
    def __init__(self):
        self.chunks = []

    def write(self, samples):
        self.chunks.append(np.asarray(samples, np.float32).copy())

    def close(self):
        pass

    @property
    def stream(self):
        return (np.concatenate(self.chunks)
                if self.chunks else np.zeros(0, np.float32))


# -- ops.beamform -----------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["pad", "lerp", "hybrid"])
def test_miso_matches_oracle_and_jax(algorithm):
    cfg = Config.tiny()
    frame = _frames(cfg, 1)[0]
    t, jt = _tables(cfg, algorithm)
    active, n = jg.active_microphones(_jcfg(cfg))
    d = beamform.steer_index(cfg, 10.0, -5.0)
    if algorithm == "pad":
        whole, _ = jg.calculate_coefficients(_jcfg(cfg))
        ref = oracle.miso_pad(frame, active, whole.reshape(-1), n, d * n)
    elif algorithm == "lerp":
        whole, frac = jg.lerp_coefficients(_jcfg(cfg))
        ref = oracle.miso_lerp(frame, active, whole.reshape(-1),
                               frac.reshape(-1), n, d * n)
    else:
        whole, taps = jg.hybrid_coefficients(_jcfg(cfg))
        ref = oracle.miso_hybrid(frame, active, whole.reshape(-1),
                                 taps.reshape(-1), n, d * n, cfg.n_taps)
    got = beamform.miso_beam(frame, t, d)
    assert got.shape == (cfg.n_samples,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **MISO_GATE)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jb.miso_beam(frame, jt, d)),
                               **MISO_GATE)


def test_miso_convolve_matches_oracle_and_jax():
    """Negative delay-line shifts (convolve tables)."""
    cfg = Config.tiny()
    frame = _frames(cfg, 1, seed=12)[0]
    t, jt = _tables(cfg, "convolve")
    active, n = jg.active_microphones(_jcfg(cfg))
    d = 3 * cfg.max_res_y + 2
    taps = jg.convolve_coefficients(_jcfg(cfg))
    ref = oracle.miso_convolve(frame, active, taps.reshape(-1), n,
                               d * n * cfg.n_taps, cfg.n_taps)
    got = beamform.miso_beam(frame, t, d).numpy()
    np.testing.assert_allclose(got, ref, **CONVOLVE_GATE)
    np.testing.assert_allclose(got, np.asarray(jb.miso_beam(frame, jt, d)),
                               **CONVOLVE_GATE)


@pytest.mark.parametrize("algorithm", ["truncated", "lerp", "hybrid"])
def test_miso_batched_every_direction_matches_jax(algorithm):
    """A batch of frames, every direction of the grid, against JAX."""
    cfg = Config.tiny()
    frames = _frames(cfg, 3, seed=13)
    t, jt = _tables(cfg, algorithm)
    for d in range(cfg.n_directions):
        got = beamform.miso_beam(frames, t, d)
        assert got.shape == (3, cfg.n_samples)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jb.miso_beam(frames, jt, d)),
            **MISO_GATE, err_msg=f"d={d}")


def test_miso_beams_multi():
    """Multi-direction MISO equals per-direction calls, and JAX's."""
    cfg = Config.tiny()
    frame = _frames(cfg, 1, seed=14)[0]
    t, jt = _tables(cfg, "lerp")
    dirs = np.array([0, 5, 17])
    multi = beamform.miso_beams_multi(frame, t, dirs)
    assert multi.shape == (3, cfg.n_samples)
    singles = torch.stack([beamform.miso_beam(frame, t, int(d))
                           for d in dirs])
    np.testing.assert_allclose(multi.numpy(), singles.numpy(), **MULTI_GATE)
    np.testing.assert_allclose(
        multi.numpy(), np.asarray(jb.miso_beams_multi(frame, jt, dirs)),
        **MISO_GATE)


def test_miso_beams_multi_batched():
    """Batched signals come back (B, K, N), not direction-major."""
    cfg = Config.tiny()
    frames = _frames(cfg, 4, seed=23)
    t, jt = _tables(cfg, "lerp")
    dirs = torch.tensor([0, 5, 17])
    multi = beamform.miso_beams_multi(frames, t, dirs)
    assert multi.shape == (4, 3, cfg.n_samples)
    for b in range(4):
        for k, d in enumerate(dirs.tolist()):
            np.testing.assert_allclose(
                multi[b, k].numpy(),
                beamform.miso_beam(frames[b], t, d).numpy(), **MULTI_GATE)
    np.testing.assert_allclose(
        multi.numpy(),
        np.asarray(jb.miso_beams_multi(frames, jt, dirs.numpy())),
        **MISO_GATE)


def test_direction_as_tensor_equals_int():
    cfg = Config.tiny()
    frames = _frames(cfg, 2, seed=15)
    t, _ = _tables(cfg, "hybrid")
    for d in (0, 31, cfg.n_directions - 1):
        a = beamform.miso_beam(frames, t, d)
        b = beamform.miso_beam(frames, t, torch.tensor(d))
        assert torch.equal(a, b)


def test_make_miso_tables_equal_jax():
    cfg = Config.tiny()
    t = beamform.make_miso_tables(cfg, 10.0, -5.0, device="cpu")
    jt = jb.make_miso_tables(_jcfg(cfg), 10.0, -5.0)
    np.testing.assert_array_equal(t.W.numpy(), np.asarray(jt.W))
    np.testing.assert_array_equal(t.adaptive.numpy(), np.asarray(jt.adaptive))
    assert (t.tau_min, t.corr_js, t.Wc) == (jt.tau_min, (), None)
    assert (t.res_x, t.res_y) == (1, 1)
    frames = _frames(cfg, 2, seed=16)
    np.testing.assert_allclose(beamform.miso_beam(frames, t, 0).numpy(),
                               np.asarray(jb.miso_beam(frames, jt, 0)),
                               **MISO_GATE)


@pytest.mark.parametrize("preset", ["tiny", "default"])
def test_steer_index_equals_jax(preset):
    cfg = Config.tiny() if preset == "tiny" else Config()
    jcfg = _jcfg(cfg)
    for az in np.linspace(-90, 90, 37):
        for el in np.linspace(-90, 90, 19):
            assert beamform.steer_index(cfg, az, el) == \
                jb.steer_index(jcfg, az, el)


def test_miso_bf16_tables_within_bf16_class():
    """bf16 tables: bf16-rounded operands, FP32 sums, FP32 corrections;
    within 1% (norm) of the f32 beam."""
    cfg = Config.tiny()
    frames = _frames(cfg, 2, seed=17)
    t32, _ = _tables(cfg, "lerp")
    t16 = beamform.make_tables(cfg.replace(matmul_dtype="bfloat16"), "lerp",
                               cache=False, device="cpu")
    for d in (0, 20, 40):
        a = beamform.miso_beam(frames, t32, d)
        b = beamform.miso_beam(frames, t16, d)
        assert b.dtype == torch.float32
        assert (a - b).norm() / a.norm() < 1e-2


# -- the audio accounting --------------------------------------------------

class _FakeReceiver:
    ring_frames = 8

    def __init__(self, cfg):
        self.cfg = cfg


def test_audio_leg_zero_fill():
    """Frames lost to ring overwrites are zero-filled and counted, so the
    output stream stays time-aligned (``test_fullrate.py:261-290``)."""
    cfg = Config.tiny()
    N = cfg.n_samples
    sink = _CaptureSink()
    beams = torch.arange(2 * N, dtype=torch.float32).reshape(2, N)
    stage = pipeline.BatchedMisoProducer(
        _FakeReceiver(cfg), sink, PipelineMetrics(), batch=2,
        beam_fn=lambda f, d: f, post_fn=lambda b: b, n_samples=N,
        device="cpu")
    stamps = np.array([time.perf_counter() - 0.01, 0.0])
    stage._finish((beams, None, 1, 3, time.perf_counter(), stamps))
    assert stage.underrun_frames == 3
    assert stage.processed == 2
    assert stage.samples == 5 * N
    assert sink.stream.size == 5 * N
    np.testing.assert_array_equal(sink.stream[:3 * N], 0.0)
    np.testing.assert_array_equal(sink.stream[3 * N:], beams.reshape(-1))
    lat = stage.audio_latency()
    assert lat["audio_e2e_p50_ms"] >= 10.0     # the one nonzero stamp


def test_combined_stage_dispatches_a_tuple():
    """``launch`` may return a tuple: each output reaches ``consume`` as
    its own host array."""
    cfg = Config.tiny().replace(max_res_x=3, max_res_y=2)
    t = beamform.make_tables(cfg, "lerp", cache=False, device="cpu")
    got = {}
    stage = pipeline.BatchedMimoMisoProducer(
        _FakeReceiver(cfg), _CaptureSink(), PipelineMetrics(), batch=2,
        process_fn=lambda f, d: (beamform.steered_power(f, t),
                                 beamform.miso_beam(f, t, d)),
        post_fn=lambda b: b, n_samples=cfg.n_samples, q_power=None,
        power_sink=lambda p, s: got.update(p=p, s=s), device="cpu")
    stage.steer(4)
    batch = _frames(cfg, 2, seed=18)
    host, done = stage._dispatch(batch)
    assert done is None and isinstance(host, tuple) and len(host) == 2
    stage._finish((host, done, 7, 0, time.perf_counter(), None))
    assert got["s"] == 7 and got["p"].shape == (2, 3, 2)
    np.testing.assert_array_equal(
        stage.sink.stream,
        beamform.miso_beam(batch, t, 4).numpy().reshape(-1))


# -- the listening stages on loopback ----------------------------------------

def _stream(cfg, n_frames, seed):
    rng = np.random.default_rng(seed)
    base = (rng.standard_normal(
        (cfg.n_microphones, cfg.n_samples)) * 0.05).astype(np.float32)
    frames = [(base * (1.0 + 0.1 * i)).astype(np.float32)
              for i in range(n_frames)]
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.5,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    return frames


def _jax_audio(cfg, frames, d):
    jt = jb.make_tables(_jcfg(cfg), "lerp", cache=False)
    return np.concatenate([
        jaudio.miso_gain(np.asarray(jb.miso_beam(_wire(cfg, f), jt, d)),
                         jt.n_mics, cfg.mic_gain, cfg.norm_factor_sound)
        for f in frames])


def _wait(stage, n_frames):
    deadline = time.time() + 20.0
    while stage.processed < n_frames and time.time() < deadline:
        time.sleep(0.05)


@pytest.mark.parametrize("backend,port", [("python", 22130),
                                          ("native", 22131)])
def test_batched_miso_gapless_and_parity(backend, port):
    """Every frame beamed exactly once, a sample-count-exact stream, equal
    to JAX's per-frame beam + gain chain on the wire frames in counter
    order (``test_fullrate.py:147-204``, ``beam="time"``)."""
    cfg = Config.tiny().replace(udp_port=port)
    n_frames, K = 16, 4
    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend=backend,
                          device="cpu")
    p.receiver.exact_reference = False
    sink = _CaptureSink()
    frames = _stream(cfg, n_frames, seed=7)
    p.connect(timeout=5.0)
    # steered before the stage runs: every batch beams toward d
    stage = p.make_miso_batched(batch=K, sink=sink)
    d = p.steer_cartesian_degree(10.0, -5.0)
    assert stage.want_stamps and stage._steered() == d
    stage.warmup()
    p.run_stage(stage)
    _wait(stage, n_frames)
    rep = p.report()
    p.stop()

    assert stage.underrun_frames == 0, "gapless contract: zero underruns"
    assert stage.processed >= n_frames
    assert stage.samples == stage.processed * cfg.n_samples
    assert sink.stream.size == stage.samples
    expect = _jax_audio(cfg, frames, d)
    np.testing.assert_allclose(sink.stream[:expect.size], expect,
                               **STREAM_GATE)
    r = rep["miso_batched"]
    assert r["underrun_frames"] == 0 and r["skipped"] == 0
    assert r["audio_e2e_p50_ms"] > 0 and r["audio_e2e_p95_ms"] >= \
        r["audio_e2e_p50_ms"]


@pytest.mark.parametrize("backend,port", [("python", 22132),
                                          ("native", 22133)])
def test_combined_mimo_miso_stage(backend, port):
    """One transfer serves both outputs: every frame's map matches JAX
    ``steered_power`` and the stream JAX's beam + gain, with zero drops
    (``test_fullrate.py:207-258``)."""
    cfg = Config.tiny().replace(udp_port=port)
    n_frames, K = 16, 4
    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend=backend,
                          device="cpu")
    p.receiver.exact_reference = False
    a_sink = _CaptureSink()
    got = {}

    def power_sink(powers, first_seq):
        for j, pw in enumerate(powers):
            got[first_seq + j] = pw

    frames = _stream(cfg, n_frames, seed=9)
    p.connect(timeout=5.0)
    stage = p.make_mimo_miso_batched(batch=K, sink=a_sink,
                                     power_sink=power_sink)
    stage.warmup()
    p.run_stage(stage)
    _wait(stage, n_frames)
    p.stop()

    assert stage.skipped == 0 and stage.underrun_frames == 0
    assert stage.processed >= n_frames
    assert a_sink.stream.size == stage.samples == \
        stage.processed * cfg.n_samples
    assert set(range(1, n_frames + 1)) <= set(got)
    jt = jb.make_tables(_jcfg(cfg), "lerp", cache=False)
    for s in (1, n_frames // 2, n_frames):
        expect = np.asarray(jb.steered_power(_wire(cfg, frames[s - 1]), jt))
        np.testing.assert_allclose(got[s], expect, rtol=1e-4, atol=1e-10)
    expect_audio = _jax_audio(cfg, frames, 0)
    np.testing.assert_allclose(a_sink.stream[:expect_audio.size],
                               expect_audio, **STREAM_GATE)


def test_mimo_miso_batched_honors_power_fn():
    """Enabling audio must not switch the imaging semantics: the combined
    stage runs the pipeline's power_fn for the heatmap half
    (``test_pipeline.py:113-137``), on the padded f32 batch."""
    cfg = Config.tiny().replace(udp_port=22134)
    calls = []

    def custom_power(frames):
        calls.append((tuple(frames.shape), frames.dtype))
        return torch.full((frames.shape[0], cfg.max_res_x, cfg.max_res_y),
                          7.0)

    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend="python",
                          device="cpu", power_fn=custom_power)
    try:
        stage = p.make_mimo_miso_batched(batch=4, beam="time")
        frames = torch.ones((4, cfg.n_microphones - 3, cfg.n_samples),
                            dtype=torch.float16)
        maps, beams = stage.process_fn(frames, 0)
        assert calls == [((4, cfg.n_microphones, cfg.n_samples),
                          torch.float32)]
        assert maps[0, 0, 0] == 7.0
        assert beams.shape == (4, cfg.n_samples)
    finally:
        p.stop()


def test_start_miso_batched_runs_and_steers():
    """``start_miso_batched`` builds, warms up and starts the gapless stage,
    which steering reaches live and ``stop`` ends."""
    cfg = Config.tiny()
    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend="python",
                          device="cpu")
    sink = _CaptureSink()
    s = p.start_miso_batched(batch=4, sink=sink)
    try:
        assert s.is_alive() and p.stages == [s]
        d = p.steer_cartesian_degree(-30.0, 45.0)
        assert s._steered() == d == beamform.steer_index(cfg, -30.0, 45.0)
        assert p.steer_click(0.5, 0.5) == s._steered() == \
            (cfg.max_res_x // 2) * cfg.max_res_y + cfg.max_res_y // 2
    finally:
        p.stop()
    assert not s.is_alive()
    assert s.processed == 0 and sink.stream.size == 0


def test_mvdr_beam_not_yet_ported():
    """``beam="mvdr"`` builds both listening stages around the MVDR
    stream (no gain chain: the beam is distortionless); an unknown beam
    still raises."""
    p = pipeline.Pipeline(Config.tiny(), device="cpu")
    for make, kind in ((p.make_miso_batched, "beam_fn"),
                       (p.make_mimo_miso_batched, "process_fn")):
        stage = make(batch=4, beam="mvdr")
        fn = getattr(stage, kind)
        assert stage.stateful_fn is fn
        # the stream takes the stage's sliced f16 batch, padding it itself
        x = torch.ones((4, p.cfg.n_microphones - 3, p.cfg.n_samples),
                       dtype=torch.float16)
        fn.reset()
        sliced = fn(x, 0)
        fn.reset()
        full = fn(pipeline._pad_full(x, p.cfg.n_microphones), 0)
        torch.testing.assert_close(sliced, full, rtol=0, atol=0)
        assert fn.tables.device.type == "cpu" and fn.alpha == 0.9
        assert stage.post_fn(np.ones(3)).tolist() == [1.0] * 3
        with pytest.raises(ValueError, match="unknown beam"):
            make(batch=4, beam="nope")
    with pytest.raises(ValueError, match="out of"):
        p.steer_cartesian_degree(95.0, 0.0)


def test_live_miso_steering_and_wav_sink(tmp_path):
    """``start_miso`` beside ``start_heatmap``, steered live, writing whole
    frames to a WAV file (``test_pipeline.py:140-167``); one frame's
    audio equals JAX's beam + gain."""
    from zybo_rt_sampler_image_detection_torch.ops import geometry

    cfg = Config.tiny().replace(udp_port=22135)
    delays = geometry.calculate_delays(cfg)
    active, _ = geometry.active_microphones(cfg)
    tx, ty = 6, 2
    base = np.random.default_rng(3).standard_normal(
        cfg.n_samples * 3).astype(np.float32) * 0.05
    lag = (delays[tx, ty].max() - delays[tx, ty]).round().astype(int)
    fr = np.zeros((cfg.n_microphones, cfg.n_samples), np.float32)
    for i, m in enumerate(active):
        fr[m] = base[cfg.n_samples - lag[i]:2 * cfg.n_samples - lag[i]]
    path = tmp_path / "beam.wav"
    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend="python",
                          device="cpu", audio_sink="wav",
                          audio_path=str(path))
    p.receiver.exact_reference = False
    streamer.stream_in_background(cfg, [fr] * 30, n_arrays=1, delay=0.3,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    p.connect(timeout=5.0)
    p.start_heatmap()
    stage = p.start_miso()
    d = p.steer_cartesian_degree(10.0, -5.0)
    assert 0 <= d < cfg.n_directions
    power, seq = p.q_power.get(timeout=10.0)
    deadline = time.time() + 10.0
    while p.metrics.stage("miso").count < 2 and time.time() < deadline:
        time.sleep(0.05)
    rep = p.report()
    p.stop()
    x, y = np.unravel_index(power.argmax(), power.shape)
    assert abs(x - tx) <= 1 and abs(y - ty) <= 1
    assert rep["heatmap"]["count"] >= 1 and rep["miso"]["count"] >= 2
    assert rep["miso"]["sink_dropped_writes"] == 0
    with wave.open(str(path)) as w:
        n = w.getnframes()
    assert n >= 2 * cfg.n_samples and n % cfg.n_samples == 0
    got = stage.beam(fr)
    assert got.shape == (cfg.n_samples,) and got.dtype == np.float32
    np.testing.assert_allclose(got, _jax_audio(cfg, [fr], d),
                               **STREAM_GATE)


def test_demo_miso_fullrate_cpu(capsys):
    """``demo miso --fullrate --device cpu --preset tiny`` on the native
    emulator at line rate: gapless, exit code 0."""
    cfg = Config.tiny().replace(udp_port=22136)
    t = np.arange(cfg.n_samples * 64) / cfg.sample_rate
    sig = np.tile(np.sin(2 * np.pi * 2000.0 * t).astype(np.float32),
                  (cfg.n_microphones, 1)) * 0.1
    emu = streamer.NativeStreamer(cfg, n_arrays=1)
    emu.start(sig, rate=cfg.sample_rate)
    try:
        rc = demo.main(["miso", "--replay", "--device", "cpu", "--preset",
                        "tiny", "--fullrate", "--batch", "16", "--seconds",
                        "1.5", "--audio", "null", "--port", "22136",
                        "--backend", "native", "--azimuth", "20"])
    finally:
        emu.stop()
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "GAPLESS" in out and "underrun frames = 0" in out


def test_demo_miso_live_wav_cpu(capsys, tmp_path):
    cfg = Config.tiny().replace(udp_port=22137)
    _stream(cfg, 400, seed=20)
    out_wav = tmp_path / "m.wav"
    rc = demo.main(["miso", "--replay", "--device", "cpu", "--preset",
                    "tiny", "--seconds", "1", "--audio", "wav", "--out",
                    str(out_wav), "--port", "22137", "--backend", "python"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "beam audio written to" in out
    with wave.open(str(out_wav)) as w:
        assert w.getnframes() >= cfg.n_samples


@pytest.mark.parametrize("audio_only,port", [(False, 22138), (True, 22139)])
def test_demo_fullrate_audio_cpu(capsys, audio_only, port):
    """``demo fullrate --audio null`` (the combined stage) and
    ``--audio-only`` sustain line rate with 0 skipped, 0 gaps and 0
    underrun frames."""
    argv = ["fullrate", "--device", "cpu", "--preset", "tiny", "--seconds",
            "2", "--batch", "64", "--port", str(port), "--audio", "null"]
    rc = demo.main(argv + (["--audio-only"] if audio_only else []))
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "FULL RATE SUSTAINED" in out and "GAPLESS" in out
    assert "audio e2e latency" in out
    stage = "miso_batched" if audio_only else "mimo_miso_batched"
    assert f"'{stage}'" in out


@pytest.mark.parametrize("argv", [
    # --beam mvdr runs now (tests/test_torch_mvdr_stream.py); what still
    # exits is an MVDR or FFT imaging request with the time-domain equiv
    # flags, which it would ignore
    pytest.param(["miso", "--beam", "mvdr", "--algorithm", "mvdr",
                  "--equiv"], id="argv0"),
    pytest.param(["fullrate", "--audio", "null", "--beam", "mvdr",
                  "--algorithm", "fft", "--equiv-kernel"], id="argv1"),
])
def test_demo_mvdr_beam_exits(argv):
    with pytest.raises(SystemExit, match="reformulate"):
        demo.main(argv + ["--device", "cpu", "--preset", "tiny"])


def test_listening_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "from zybo_rt_sampler_image_detection_torch.apps import "
            "pipeline, demo; "
            "from zybo_rt_sampler_image_detection_torch.ops import kalman; "
            "from zybo_rt_sampler_image_detection_torch.utils import "
            "audio, imaging, viz; "
            "assert not any(m == 'jax' or m.startswith('jax.') or "
            "m.startswith('zybo_rt_sampler_image_detection_tpu') "
            "for m, v in sys.modules.items() if v is not None); "
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
