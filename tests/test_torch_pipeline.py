"""The port's heatmap slice end to end: emulator -> receiver -> backend
policy -> fused equiv power (its plain version on the CPU) -> q_power,
held against the JAX package's ``beamform.steered_power`` on the same
frame.  UDP ports 22100-22119."""

import queue
import subprocess
import sys

import numpy as np
import pytest
import torch

import zybo_rt_sampler_image_detection_tpu as zj
from zybo_rt_sampler_image_detection_tpu.ops import beamform as jb
from zybo_rt_sampler_image_detection_torch.apps import demo, pipeline
from zybo_rt_sampler_image_detection_torch.config import Config
from zybo_rt_sampler_image_detection_torch.ingest import streamer
from zybo_rt_sampler_image_detection_torch.ops import (
    beamform, equiv_kernel, freq_equiv, fused_kernel, geometry)

torch.set_num_threads(2)


def _source_frames(cfg, tx, ty, n=30, seed=3):
    """Broadband source at grid cell (tx, ty) (``test_pipeline.py``)."""
    delays = geometry.calculate_delays(cfg)
    active, _ = geometry.active_microphones(cfg)
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(cfg.n_samples * 3).astype(np.float32) * 0.05
    lag = (delays[tx, ty].max() - delays[tx, ty]).round().astype(int)
    fr = np.zeros((cfg.n_microphones, cfg.n_samples), np.float32)
    for i, m in enumerate(active):
        s = cfg.n_samples - lag[i]
        fr[m] = base[s:s + cfg.n_samples]
    return [fr] * n


def _jax_power(cfg, frame):
    jcfg = zj.Config(**{f: getattr(cfg, f) for f in
                        cfg.__dataclass_fields__})
    t = jb.make_tables(jcfg, "lerp", cache=False)
    return np.asarray(jb.steered_power(frame.astype(np.float32), t),
                      np.float64)


def test_put_drop_oldest():
    q = queue.Queue(maxsize=2)
    for i in range(5):
        pipeline.put_drop_oldest(q, i)
    assert q.get() == 3 and q.get() == 4


@pytest.mark.parametrize("backend,port", [("python", 22100),
                                          ("native", 22101)])
def test_loopback_heatmap_matches_jax(backend, port):
    """Port streamer -> port Pipeline(power_backend='equiv_kernel',
    device='cpu') -> heatmap, vs JAX steered_power of the same frame at
    rtol 1e-4 (``test_pipeline.py:80``) with the peak within one cell."""
    cfg = Config.tiny().replace(udp_port=port)
    tx, ty = 6, 2
    frames = _source_frames(cfg, tx, ty, n=1000)
    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend=backend,
                          power_backend="equiv_kernel", device="cpu")
    p.receiver.exact_reference = False
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.3,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    try:
        p.connect(timeout=10.0)
        s = p.start_heatmap()
        assert isinstance(s.power_fn, equiv_kernel.FusedEquivBeamformer)
        maps = [p.q_power.get(timeout=20.0) for _ in range(3)]
        frame, _ = p.receiver.read_frame(timeout=5.0)
        rep = p.report()
    finally:
        p.stop()
    power = maps[-1][0]
    assert power.shape == (cfg.max_res_x, cfg.max_res_y)
    assert np.isfinite(power).all()
    x, y = np.unravel_index(power.argmax(), power.shape)
    assert abs(x - tx) <= 1 and abs(y - ty) <= 1
    assert rep["heatmap"]["count"] >= 3 and rep["ingest"]["frames"] >= 3
    # every streamed frame is the same source frame; the heatmap of the
    # received frame equals the JAX package's exact product
    ref = _jax_power(cfg, frame)
    got = s.power_fn(torch.from_numpy(frame)).double().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(power, ref, rtol=1e-4, atol=1e-12)


class _FakeTables:
    def __init__(self, D, T, M, N, tau_min=0, precision="high",
                 device="cuda"):
        self.W = np.zeros((D, T, M), np.float32)
        self.n_samples = N
        self.tau_min = tau_min
        self.precision = precision
        self.device = torch.device(device)


def test_equiv_bar_for_80gb():
    # reference-like: T=49 -> MAC ratio ~20x, 1.15 GB planes -> inside
    assert pipeline._equiv_bar(_FakeTables(1824, 49, 256, 256))
    # northstar-like short spread still clears the MAC bar
    assert pipeline._equiv_bar(_FakeTables(4225, 8, 64, 256))
    # degenerate single-tap spread -> outside
    assert not pipeline._equiv_bar(_FakeTables(4225, 1, 64, 256))
    # planes beyond 15% of 80 GB -> outside
    assert not pipeline._equiv_bar(_FakeTables(40000, 49, 512, 256))
    # the v5e cap would have excluded this; 80 GB admits it (3.9 GB)
    assert pipeline._equiv_bar(_FakeTables(6000, 49, 256, 256))


def test_policy_on_cuda_tables(monkeypatch):
    """Mirror of ``_select_power_backend`` with 'device is CUDA' for
    'backend is TPU': high/bf16 in the bar -> the equiv kernel; highest ->
    the exact product; bf16 outside the bar -> the fused time-domain
    kernel (JAX ``pipeline.py:151-155``)."""
    built = []

    class FakeFused:
        def __init__(self, t, *a, **kw):
            built.append(t)

    class FakeTimeFused:
        def __init__(self, t, *a, **kw):
            self.t = t

    sentinel = object()
    monkeypatch.setattr(equiv_kernel, "FusedEquivBeamformer", FakeFused)
    monkeypatch.setattr(fused_kernel, "FusedBeamformer", FakeTimeFused)
    monkeypatch.setattr(freq_equiv, "make_equiv_tables", lambda t: sentinel)
    kind, obj = pipeline._select_power_backend(
        _FakeTables(1824, 49, 256, 256, precision="high"))
    assert kind == "equiv_kernel" and built[-1] is sentinel
    kind, _ = pipeline._select_power_backend(
        _FakeTables(1824, 49, 256, 256, precision="default"))
    assert kind == "equiv_kernel"
    assert pipeline._select_power_backend(
        _FakeTables(1824, 49, 256, 256, precision="highest")) == ("xla", None)
    short = _FakeTables(4225, 1, 64, 256, precision="default")
    kind, obj = pipeline._select_power_backend(short)
    assert kind == "fused" and isinstance(obj, FakeTimeFused)
    assert obj.t is short
    # high outside the bar takes the fused kernel too, as in JAX
    kind, _ = pipeline._select_power_backend(
        _FakeTables(4225, 1, 64, 256, precision="high"))
    assert kind == "fused"
    # CPU tensors take the exact product at every rung
    assert pipeline._select_power_backend(
        _FakeTables(1824, 49, 256, 256, device="cpu")) == ("xla", None)


def test_policy_falls_back_to_freq_equiv_without_plan(monkeypatch):
    class NoPlan:
        def __init__(self, t, *a, **kw):
            raise ValueError("no shared-memory plan")

    sentinel = object()
    monkeypatch.setattr(equiv_kernel, "FusedEquivBeamformer", NoPlan)
    monkeypatch.setattr(freq_equiv, "make_equiv_tables", lambda t: sentinel)
    assert pipeline._select_power_backend(
        _FakeTables(1824, 49, 256, 256)) == ("freq_equiv", sentinel)


def test_default_power_fn_every_backend(monkeypatch, rng):
    """Every kind the policy can return, as the live stage's program and
    the full-rate stage's, takes (M, N) frames and (B, M, N) batches
    and matches the JAX exact product."""
    cfg = Config.tiny().replace(matmul_precision="high")
    t = beamform.make_tables(cfg, "lerp", cache=False, device="cpu")
    frame = (rng.standard_normal((cfg.n_microphones, cfg.n_samples))
             * 0.1).astype(np.float32)
    ref = _jax_power(cfg, frame)
    kinds = [("equiv_kernel", equiv_kernel.FusedEquivBeamformer(t)),
             ("freq_equiv", freq_equiv.make_equiv_tables(t)),
             ("fused", fused_kernel.FusedBeamformer(t)),
             ("xla", None)]
    x = torch.from_numpy(frame)
    for kind, obj in kinds:
        monkeypatch.setattr(pipeline, "_select_power_backend",
                            lambda tables, _k=kind, _o=obj: (_k, _o))
        fn = pipeline.power_program(t)
        out = fn(x).double().numpy()
        assert out.shape == ref.shape, kind
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-12,
                                   err_msg=kind)
        for fn in (fn, pipeline.power_program(t, cfg.n_microphones)):
            out3 = fn(x[None]).double().numpy()
            np.testing.assert_allclose(out3[0], ref, rtol=1e-4,
                                       atol=1e-12, err_msg=kind)


def test_pipeline_rejects_unknown_backend():
    cfg = Config.tiny()
    with pytest.raises(ValueError, match="power backend"):
        pipeline.Pipeline(cfg, power_backend="nope", device="cpu")


def test_pipeline_freq_equiv_backend():
    cfg = Config.tiny()
    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend="python",
                          power_backend="freq_equiv", device="cpu")
    out = p.make_heatmap_batched(batch=1).power_fn(
        torch.zeros(1, cfg.n_microphones, cfg.n_samples))
    assert out.shape == (1, cfg.max_res_x, cfg.max_res_y)


def test_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.Pipeline(Config.tiny(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        beamform.make_tables(Config.tiny(), "lerp", cache=False,
                             device="cuda")


@pytest.mark.parametrize("argv,msg", [
    # every path of the demo is ported; the frequency-domain algorithms
    # refuse the time-domain equiv flags, which they would ignore
    pytest.param(["mimo", "--replay", "--headless", "--algorithm", "fft",
                  "--equiv"], "reformulate", id="argv0-not yet ported"),
    pytest.param(["mimo", "--replay", "--headless", "--algorithm", "mvdr",
                  "--equiv-kernel"], "reformulate",
                 id="argv1-not yet ported"),
    pytest.param(["miso", "--replay", "--fullrate", "--beam", "mvdr",
                  "--algorithm", "mvdr", "--equiv"], "reformulate",
                 id="argv2-not yet ported"),
])
def test_demo_unported_paths_exit(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        demo.main(argv + ["--device", "cpu", "--preset", "tiny"])


def test_demo_mimo_headless(capsys):
    """``demo mimo --replay --headless --equiv-kernel`` on the CPU: the CLI
    entry point drives the slice and prints heatmap stats."""
    cfg = Config.tiny().replace(udp_port=22102)
    frames = _source_frames(cfg, 4, 3, n=1000)
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.5,
                                  rate=2 * cfg.sample_rate)
    demo.main(["mimo", "--replay", "--headless", "--equiv-kernel",
               "--frames", "3", "--preset", "tiny", "--port", "22102",
               "--backend", "python", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "heatmap #1" in out and "metrics:" in out


def test_port_imports_without_jax():
    """The port never imports jax (nor flax, optax, orbax or the JAX
    package), not even indirectly: the heatmap, listening and FFT/MVDR
    modules, the vision models and their training, fusion (the
    compositor too), the fused stage, recording, profiling, the demo, the
    web monitor with its JPEG encoder, and the device mesh with its dry
    run."""
    code = ("import sys; "
            "sys.modules.update(dict.fromkeys(['jax', 'flax', 'optax', "
            "'orbax', 'zybo_rt_sampler_image_detection_tpu'])); "
            "import zybo_rt_sampler_image_detection_torch as z; "
            "from zybo_rt_sampler_image_detection_torch.apps import "
            "pipeline, demo; "
            "from zybo_rt_sampler_image_detection_torch.ops import "
            "equiv_kernel, fused_kernel, _build, freq; "
            "from zybo_rt_sampler_image_detection_torch.apps import plot; "
            "from zybo_rt_sampler_image_detection_torch import models, "
            "fusion; "
            "from zybo_rt_sampler_image_detection_torch.models import "
            "detect, yolo, nms, sort, tracking, runner, eval, data, "
            "train; "
            "from zybo_rt_sampler_image_detection_torch.utils import "
            "profiling, recording; "
            "from zybo_rt_sampler_image_detection_torch.apps import web, "
            "fused; "
            "from zybo_rt_sampler_image_detection_torch.fusion import "
            "composite; "
            "from zybo_rt_sampler_image_detection_torch.ingest import "
            "udptools; "
            "from zybo_rt_sampler_image_detection_torch.utils import jpeg; "
            "from zybo_rt_sampler_image_detection_torch.parallel import "
            "mesh, dryrun; "
            "assert not any(m.split('.')[0] in ('jax', 'flax', 'optax', "
            "'orbax', 'zybo_rt_sampler_image_detection_tpu') "
            "for m, v in sys.modules.items() if v is not None); "
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
