"""Listening inside the port's fused stage (``FusedSensorStage(listen=
"time"|"mvdr")``), and the pipeline pieces the fused demo needs.

* The gapless stream on loopback: every frame beamed once through the
  packed program, the sink stream equal to the oracle on the quantized
  wire frames (JAX ``miso_beam`` + the gain chain, or JAX
  ``mvdr_listen_step`` over the same Km-frame blocks; the JAX package's
  tests/test_fused_listen.py:131-145) at rtol 1e-4 / atol 1e-7, with 0
  underruns, the e2e latency measured, and ``Pipeline.stop`` closing the
  sink through the stage's ``AudioLeg``.
* ``steer()`` reaches the next launch.
* ``BatchedStage(max_rate=)``: the heatmap stage throttled below line
  rate skips the frames it leaves.

UDP ports 22162-22164."""

import queue
import time

import numpy as np
import pytest
import torch

import zybo_rt_sampler_image_detection_tpu as zj
from zybo_rt_sampler_image_detection_tpu.ops import beamform as jb
from zybo_rt_sampler_image_detection_tpu.ops import freq as jfreq
from zybo_rt_sampler_image_detection_tpu.utils import audio as jaudio
from zybo_rt_sampler_image_detection_torch.apps import fused
from zybo_rt_sampler_image_detection_torch.apps.pipeline import Pipeline
from zybo_rt_sampler_image_detection_torch.config import Config
from zybo_rt_sampler_image_detection_torch.fusion.composite import (
    DeviceCompositor)
from zybo_rt_sampler_image_detection_torch.ingest import streamer
from zybo_rt_sampler_image_detection_torch.models import detect, yolo
from zybo_rt_sampler_image_detection_torch.ops import beamform
from zybo_rt_sampler_image_detection_torch.utils import audio as audio_mod

# one intra-op thread: the stage reads the ring at line rate, and torch's
# thread pool stalls for hundreds of ms when the suite's other workers
# hold every core
torch.set_num_threads(1)

STREAM_GATE = dict(rtol=1e-4, atol=1e-7)     # test_fused_listen.py:145
CAM = (48, 64)


class _CaptureSink(audio_mod.AudioSink):
    def __init__(self):
        self.chunks = []
        self.closed = False

    def write(self, samples):
        self.chunks.append(np.asarray(samples, np.float32).copy())

    def close(self):
        self.closed = True

    @property
    def stream(self):
        return (np.concatenate(self.chunks) if self.chunks
                else np.zeros(0, np.float32))


class _NullDisplay:
    def show(self, img):
        pass


def _jcfg(cfg):
    return zj.Config(**{f: getattr(cfg, f) for f in
                        cfg.__dataclass_fields__})


def _make_stage(p, cfg, listen, sink, batch=2, mic_batch=4):
    comp = DeviceCompositor((cfg.max_res_x, cfg.max_res_y), CAM,
                            window=(80, 48), yolo_shape=CAM, max_tracks=4,
                            device="cpu")
    det = detect.YoloDetector(cfg=yolo.YoloConfig(input_size=64,
                                                  width_mult=0.25),
                              device="cpu")
    q_cam = queue.Queue(maxsize=64)
    stage = fused.FusedSensorStage(
        p.receiver, p.tables, comp, det, q_cam, _NullDisplay(), p.metrics,
        batch=batch, listen=listen, audio_sink=sink, mic_batch=mic_batch)
    return stage, q_cam


@pytest.mark.parametrize("listen,port", [("time", 22162), ("mvdr", 22163)])
def test_fused_listen_gapless_and_parity(listen, port):
    cfg = Config.tiny().replace(udp_port=port)
    n_frames, Km = 16, 4
    rng = np.random.default_rng(7)
    base = (rng.standard_normal((cfg.n_microphones, cfg.n_samples))
            * 0.05).astype(np.float32)
    frames = [(base * (1.0 + 0.1 * i)).astype(np.float32)
              for i in range(n_frames)]
    p = Pipeline(cfg, algorithm="lerp", replay_mode=True, backend="python",
                 device="cpu")
    p.receiver.exact_reference = False
    sink = _CaptureSink()
    stage, q_cam = _make_stage(p, cfg, listen, sink, batch=2, mic_batch=Km)
    # the demo wires the fused stage as the steer target; p.stop() closes
    # the sink through the stage's AudioLeg
    p._miso = stage
    for i in range(3):
        q_cam.put((i + 1, np.full(CAM + (3,), 40 * i, np.uint8)))
    stage.warmup()
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.5,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    p.connect(timeout=5.0)
    p.run_stage(stage)
    deadline = time.time() + 20.0
    while (stage.audio.samples < n_frames * cfg.n_samples
           and time.time() < deadline):
        time.sleep(0.05)
    p.stop()
    assert sink.closed, "Pipeline.stop left the fused stage's sink open"
    assert stage.error is None
    assert stage.audio.underrun_frames == 0, "gapless contract"
    beamed = stage.audio.samples // cfg.n_samples
    assert beamed >= n_frames
    assert sink.stream.size == stage.audio.samples
    lat = stage.audio.latency()
    assert lat and lat["audio_e2e_p50_ms"] > 0.0
    # the oracle on the quantized wire signal, from the JAX package
    jcfg = _jcfg(cfg)
    wires = [(np.round(f.astype(np.float64) * cfg.norm_factor)
              / cfg.norm_factor).astype(np.float32) for f in frames]
    if listen == "time":
        jt = jb.make_tables(jcfg, "lerp", cache=False)
        expect = np.concatenate([
            jaudio.miso_gain(np.asarray(jb.miso_beam(w, jt, 0)), jt.n_mics,
                             cfg.mic_gain, cfg.norm_factor_sound)
            for w in wires])
    else:
        ft = jfreq.make_freq_tables(jcfg, 100.0)
        st = jfreq.init_precision(ft)
        chunks = []
        for i in range(0, n_frames, Km):
            beams, st = jfreq.mvdr_listen_step(st, np.stack(wires[i:i + Km]),
                                               ft, 0)
            chunks.append(np.asarray(beams).reshape(-1))
        expect = np.concatenate(chunks)
    np.testing.assert_allclose(sink.stream[:expect.size], expect,
                               **STREAM_GATE)
    # the display legs kept working: composited frames flowed
    assert stage.frames >= 2
    rep = stage.report()
    assert rep["underrun_frames"] == 0 and rep["audio_frames"] == beamed
    assert "phase_p50_ms" in rep


def test_fused_listen_steer_reaches_next_launch():
    """steer() sets the direction of the next launch (api.c:576-581):
    the beams after it equal miso_beam toward the new direction, on the
    port and in the JAX package."""
    cfg = Config.tiny()
    p = Pipeline(cfg, algorithm="lerp", replay_mode=True, backend="python",
                 device="cpu")
    stage, _ = _make_stage(p, cfg, "time", _CaptureSink(), batch=2,
                           mic_batch=4)
    rng = np.random.default_rng(3)
    mic = (rng.standard_normal((4, cfg.n_microphones, cfg.n_samples))
           * 0.05).astype(np.float32)
    cams = np.zeros((2,) + CAM + (3,), np.uint8)
    out0, _ = stage._launch(mic, cams, 2)
    stage.steer(5)
    out1, _ = stage._launch(mic, cams, 2)
    *_, beams0 = stage._unpack(out0.numpy())
    *_, beams1 = stage._unpack(out1.numpy())
    expect = beamform.miso_beam(torch.from_numpy(mic), p.tables, 5).numpy()
    np.testing.assert_allclose(beams1, expect, **STREAM_GATE)
    jt = jb.make_tables(_jcfg(cfg), "lerp", cache=False)
    jexpect = np.stack([np.asarray(jb.miso_beam(m, jt, 5)) for m in mic])
    np.testing.assert_allclose(beams1, jexpect, **STREAM_GATE)
    assert not np.allclose(beams0, beams1)
    p.stop()


def test_max_rate_throttles_the_heatmap_stage():
    """``start_heatmap_batched(max_rate=)``: the stage processes at most
    about max_rate frames/s and the ring overwrites (counts as skipped)
    the frames it leaves, where the unthrottled stage keeps line rate."""
    cfg = Config.tiny().replace(udp_port=22164)
    rng = np.random.default_rng(1)
    base = (rng.standard_normal((cfg.n_microphones, cfg.n_samples))
            * 0.05).astype(np.float32)
    n = 1500                                # about 2 s at line rate
    streamer.stream_in_background(cfg, [base] * n, n_arrays=1, delay=0.5,
                                  exact_reference=False,
                                  rate=cfg.sample_rate)
    p = Pipeline(cfg, algorithm="lerp", replay_mode=True, backend="python",
                 device="cpu")
    got = []
    max_rate = 80.0
    try:
        p.connect(timeout=5.0)
        s = p.start_heatmap_batched(batch=8, max_rate=max_rate,
                                    sink=lambda pw, seq: got.append(seq))
        t0 = time.time()
        time.sleep(1.5)
        elapsed = time.time() - t0
    finally:
        p.stop()
    assert s.max_rate == max_rate
    assert 0 < s.processed <= max_rate * elapsed + 3 * s.batch
    assert s.skipped > 0, "a throttled stage must leave frames"
    assert got == sorted(got)
