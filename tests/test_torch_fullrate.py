"""The port's full-line-rate batched heatmap stage (``test_fullrate.py``'s
counterpart): every frame the receiver writes is beamformed exactly once,
in counter-contiguous K-frame batches, with zero drops, and each heatmap
matches the JAX package's ``steered_power`` on the int32-quantized wire
signal at rtol 1e-4 (``test_fullrate.py:86``).  UDP ports 22103-22107."""

import time

import numpy as np
import pytest
import torch

import zybo_rt_sampler_image_detection_tpu as zj
from zybo_rt_sampler_image_detection_tpu.ops import beamform as jb
from zybo_rt_sampler_image_detection_torch.apps import demo, pipeline
from zybo_rt_sampler_image_detection_torch.config import Config
from zybo_rt_sampler_image_detection_torch.ingest import streamer
from zybo_rt_sampler_image_detection_torch.ingest.receiver import FrameRing
from zybo_rt_sampler_image_detection_torch.ops import beamform, fused_kernel
from zybo_rt_sampler_image_detection_torch.utils.metrics import (
    PipelineMetrics)

torch.set_num_threads(2)


def _jax_power(cfg, frames):
    jcfg = zj.Config(**{f: getattr(cfg, f) for f in
                        cfg.__dataclass_fields__})
    t = jb.make_tables(jcfg, "lerp", cache=False)
    return np.asarray(jb.steered_power(np.asarray(frames, np.float32), t),
                      np.float64)


def _wire(cfg, frame):
    """The frame as the receiver rebuilds it from int32 samples."""
    return (np.round(frame.astype(np.float64) * cfg.norm_factor)
            / cfg.norm_factor).astype(np.float32)


def test_frame_ring_batch_semantics():
    ring = FrameRing(2, 4, capacity=8)
    for s in range(1, 21):                       # publish seqs 1..20
        ring.publish(np.full((2, 4), float(s), np.float32))

    # reader far behind: oldest surviving frame is seq 13 (20 - 8 + 1)
    batch, first, skipped = ring.read_batch(4, next_seq=1, timeout=0.0)
    assert first == 13 and skipped == 12
    assert [b[0, 0] for b in batch] == [13.0, 14.0, 15.0, 16.0]

    # contiguous follow-up read: no skips
    batch, first, skipped = ring.read_batch(4, next_seq=17, timeout=0.0)
    assert first == 17 and skipped == 0
    assert [b[0, 0] for b in batch] == [17.0, 18.0, 19.0, 20.0]

    # not enough frames yet -> timeout signalled as (None, next_seq, 0)
    batch, first, skipped = ring.read_batch(4, next_seq=21, timeout=0.05)
    assert batch is None and first == 21

    with pytest.raises(ValueError):
        ring.read_batch(9, next_seq=1)           # k > capacity


def _run_batched(cfg, backend, power_fn=None, n_frames=24, K=4, seed=21):
    rng = np.random.default_rng(seed)
    base = (rng.standard_normal(
        (cfg.n_microphones, cfg.n_samples)) * 0.05).astype(np.float32)
    frames = [(base * (1.0 + 0.1 * i)).astype(np.float32)
              for i in range(n_frames)]
    p = pipeline.Pipeline(cfg, algorithm="lerp", replay_mode=True,
                          backend=backend, device="cpu", power_fn=power_fn)
    p.receiver.exact_reference = False
    got = {}

    def sink(powers, first_seq):
        for j, pw in enumerate(powers):
            got[first_seq + j] = pw

    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.5,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    p.connect(timeout=5.0)
    stage = p.start_heatmap_batched(batch=K, sink=sink)
    deadline = time.time() + 20.0
    while stage.processed < n_frames and time.time() < deadline:
        time.sleep(0.05)
    p.stop()
    return p, stage, frames, got


def _check_every_frame(cfg, p, stage, frames, got):
    n_frames = len(frames)
    assert stage.skipped == 0, "full-rate contract: zero drops"
    assert stage.processed >= n_frames
    assert set(range(1, n_frames + 1)) <= set(got), \
        "every frame must be beamformed exactly once, in order"
    seqs = (1, n_frames // 2, n_frames)
    ref = _jax_power(cfg, [_wire(cfg, frames[s - 1]) for s in seqs])
    for r, s in zip(ref, seqs):
        np.testing.assert_allclose(got[s], r, rtol=1e-4, atol=1e-10)
    rep = p.report()
    assert rep["heatmap_batched"]["dropped"] == 0
    assert rep["heatmap_batched"]["skipped"] == 0
    assert rep["heatmap_batched"]["processed"] == stage.processed
    assert rep["heatmap_batched"]["latency_p50_ms"] > 0


@pytest.mark.parametrize("backend,port", [("python", 22103),
                                          ("native", 22104)])
def test_batched_pipeline_beamforms_every_frame(backend, port):
    """Emulator streams 24 distinct frames; the batched stage processes
    all of them (drop count 0) and each heatmap equals the JAX exact
    product on the quantized signal."""
    cfg = Config.tiny().replace(udp_port=port)
    _check_every_frame(cfg, *_run_batched(cfg, backend))


@pytest.mark.parametrize("backend,port", [("python", 22105),
                                          ("native", 22106)])
def test_batched_pipeline_through_fused_beamformer(backend, port):
    """The same contract through ``power_fn=FusedBeamformer(tables)``,
    the stage that carries the fused time-domain kernel on the card."""
    cfg = Config.tiny().replace(udp_port=port)
    t = beamform.make_tables(cfg, "lerp", cache=False, device="cpu")
    fused = fused_kernel.FusedBeamformer(t)
    _check_every_frame(cfg, *_run_batched(cfg, backend, power_fn=fused))


class _FakeReceiver:
    ring_frames = 8

    def __init__(self, cfg):
        self.cfg = cfg


@pytest.mark.parametrize("with_fused", [False, True])
def test_f16_transfer_and_channel_slicing_pad_back(rng, with_fused):
    """Channel-sliced f16 batches are upcast and padded back to the full
    mic axis before the policy's program or a custom power_fn sees them
    (``power_program`` fits the program to the stage's batches)."""
    cfg = Config.northstar().replace(max_res_x=9, max_res_y=7)
    t = beamform.make_tables(cfg, "lerp", cache=False, device="cpu")
    n_ch = 48
    batch = np.zeros((2, cfg.n_microphones, cfg.n_samples), np.float32)
    batch[:, :n_ch] = rng.standard_normal((2, n_ch, cfg.n_samples)) * 0.1
    power_fn = (pipeline.power_program(
        t, cfg.n_microphones, n_ch,
        power_fn=fused_kernel.FusedBeamformer(t)) if with_fused else None)
    stage = pipeline.BatchedHeatmapProducer(
        _FakeReceiver(cfg), t, None, PipelineMetrics(), batch=2,
        power_fn=power_fn, channels=n_ch, transfer="f16")
    host, done = stage._dispatch(batch[:, :n_ch])
    assert done is None and host.shape == (2, 9, 7)
    f16 = batch.astype(np.float16).astype(np.float32)
    exact = beamform.steered_power(torch.from_numpy(f16), t)
    np.testing.assert_allclose(host.numpy(), exact.numpy(), rtol=1e-4,
                               atol=1e-12)
    full = beamform.steered_power(torch.from_numpy(batch), t).numpy()
    assert np.abs(host.numpy() - full).max() / full.max() < 5e-3


def test_pad_full():
    x = torch.ones(2, 3, 4, dtype=torch.float16)
    y = pipeline._pad_full(x, 5)
    assert y.dtype == torch.float32 and y.shape == (2, 5, 4)
    assert (y[:, :3] == 1).all() and (y[:, 3:] == 0).all()
    assert pipeline._pad_full(y, 5).shape == (2, 5, 4)


def test_stage_rejects_batch_beyond_ring():
    cfg = Config.tiny()
    t = beamform.make_tables(cfg, "lerp", cache=False, device="cpu")
    with pytest.raises(ValueError, match="ring capacity"):
        pipeline.BatchedHeatmapProducer(_FakeReceiver(cfg), t, None,
                                        PipelineMetrics(), batch=16)


def test_pipeline_power_fn_conflicts_with_backend():
    cfg = Config.tiny()
    with pytest.raises(ValueError, match="conflicts with a custom"):
        pipeline.Pipeline(cfg, power_fn=lambda f: f,
                          power_backend="equiv_kernel", device="cpu")
    p = pipeline.Pipeline(cfg, device="cpu", ring_frames=32)
    assert p.receiver.ring_frames == 32


def test_demo_fullrate_cpu(capsys):
    """``demo fullrate --device cpu --preset tiny`` sustains line rate
    with zero drops and exits 0.  Batch 64 gives a 256-frame ring, a third
    of a second of slack at the tiny preset's 763 frames/s."""
    rc = demo.main(["fullrate", "--device", "cpu", "--preset", "tiny",
                    "--seconds", "2", "--batch", "64", "--port", "22107"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "FULL RATE SUSTAINED" in out and "skipped (ring overwrites) = 0" \
        in out


def test_demo_fullrate_audio_not_ported():
    """Every full-rate path is ported (``--beam mvdr`` runs in
    tests/test_torch_mvdr_stream.py); the MVDR imaging refuses the
    time-domain equiv flag it would ignore."""
    with pytest.raises(SystemExit, match="reformulate"):
        demo.main(["fullrate", "--device", "cpu", "--preset", "tiny",
                   "--audio", "null", "--beam", "mvdr", "--algorithm",
                   "mvdr", "--equiv"])
