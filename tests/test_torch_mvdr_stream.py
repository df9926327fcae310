"""The port's streaming-MVDR state machine (``pipeline.make_mvdr_stream``)
and the entry points that reach ``ops.freq``: the six contracts of
``tests/test_mvdr_stream.py``, the stream against JAX ``make_mvdr_stream``
(maps rtol 1e-4 / atol 1e-9, beams rtol 5e-3 / atol 5e-4 of their scale,
``test_mvdr_stream.py:52-55``), the MVDR demos on loopback, and
``apps.plot.compute_heatmaps`` against JAX's.  UDP ports 22140-22149."""

import numpy as np
import pytest
import torch

import zybo_rt_sampler_image_detection_tpu as zj
from zybo_rt_sampler_image_detection_tpu.apps import pipeline as jpipeline
from zybo_rt_sampler_image_detection_tpu.apps import plot as jplot
from zybo_rt_sampler_image_detection_torch.apps import demo, pipeline, plot
from zybo_rt_sampler_image_detection_torch.config import Config
from zybo_rt_sampler_image_detection_torch.ingest import streamer
from zybo_rt_sampler_image_detection_torch.ops import (
    beamform, freq, geometry)

torch.set_num_threads(2)

MAPS_GATE = dict(rtol=1e-4, atol=1e-9)          # test_mvdr_stream.py:52
BEAMS_GATE = dict(rtol=5e-3, atol=5e-4)         # test_mvdr_stream.py:54-55
FFT_GATE = dict(rtol=2e-4, atol=1e-6)           # test_freq.py:25
TIME_GATE = dict(rtol=1e-4, atol=1e-10)         # test_pipeline.py:80
MVDR_GATE = dict(rtol=1e-3, atol=1e-5)          # test_freq.py:683


def _jcfg(cfg):
    return zj.Config(**{f: getattr(cfg, f) for f in
                        cfg.__dataclass_fields__})


def _batches(cfg, seed, n_batches, b=8):
    """``test_mvdr_stream._batches``: a noisy tone frame repeated b times
    with fresh noise on each copy."""
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.n_samples) / cfg.sample_rate
    tone = np.tile(np.sin(2 * np.pi * 8000.0 * t).astype(np.float32),
                   (cfg.n_microphones, 1))
    out = []
    for _ in range(n_batches):
        f = tone + 0.3 * rng.standard_normal(tone.shape).astype(np.float32)
        batch = np.stack([f] * b) + 0.05 * rng.standard_normal(
            (b, cfg.n_microphones, cfg.n_samples)).astype(np.float32)
        out.append(batch.astype(np.float32))
    return out


def _direction(cfg):
    return (cfg.max_res_x // 2) * cfg.max_res_y + cfg.max_res_y // 2


def _stream(cfg, kind):
    return pipeline.make_mvdr_stream(cfg, kind, device="cpu")


def _np(x):
    return x.detach().cpu().numpy()


def test_kinds_agree():
    """The three kinds share one state trajectory: maps of 'maps' and
    'maps_beams' are the same scan; beams of 'beams' (one Woodbury block
    update) match 'maps_beams' (the chunked scan) to f32 reassociation."""
    cfg = Config.tiny()
    d = _direction(cfg)
    fm, fb, fmb = (_stream(cfg, k) for k in ("maps", "beams", "maps_beams"))
    for f in (fm, fb, fmb):
        f.reset()
    for batch in _batches(cfg, 7, 4):
        maps = _np(fm(batch)).astype(np.float64)
        beams = _np(fb(batch, d)).astype(np.float64)
        maps2, beams2 = (_np(x).astype(np.float64) for x in fmb(batch, d))
        assert maps.shape == (batch.shape[0], cfg.max_res_x, cfg.max_res_y)
        assert beams.shape == (batch.shape[0], cfg.n_samples)
        assert np.isfinite(maps).all() and np.isfinite(beams).all()
        np.testing.assert_allclose(maps2, maps, **MAPS_GATE)
        scale = np.abs(beams).max()
        np.testing.assert_allclose(beams2 / scale, beams / scale,
                                   **BEAMS_GATE)


def test_refresh_and_carry_cadence():
    """Streaming past ``refresh_interval`` frames fires the exact refresh
    (state['r'] advances) and the carried quadratic form is re-measured
    every ``d0_carry_interval`` frames (state['dqc'] wraps)."""
    cfg = Config.tiny()
    fn = _stream(cfg, "maps")
    fn.reset()
    refresh_every = freq.refresh_interval(0.9)
    carry_max = freq.d0_carry_interval(0.9)
    b = 8
    n_batches = refresh_every // b + 2
    seen_dqc = []
    for batch in _batches(cfg, 3, n_batches, b=b):
        fn(batch)
        seen_dqc.append(fn.state["dqc"])
    assert fn.state["n"] == n_batches * b
    assert fn.state["r"] >= refresh_every
    assert fn.state["n"] - fn.state["r"] < refresh_every
    assert max(seen_dqc) <= carry_max + b
    assert min(seen_dqc) == b
    assert all(isinstance(fn.state[k], int) for k in ("n", "r", "dqc"))


def test_reset_determinism():
    """``fn.reset()`` restores the initial state: replaying the same stream
    gives bit-identical outputs on the CPU."""
    cfg = Config.tiny()
    batches = _batches(cfg, 11, 3)
    for kind in ("maps", "beams", "maps_beams"):
        fn = _stream(cfg, kind)
        args = () if kind == "maps" else (_direction(cfg),)

        def run():
            fn.reset()
            out = [fn(b, *args) for b in batches]
            return [np.concatenate([_np(x).ravel() for x in o])
                    if isinstance(o, tuple) else _np(o) for o in out]

        for a, b in zip(run(), run()):
            np.testing.assert_array_equal(a, b)


def test_stream_declares_in_program_padding():
    """A stage takes the stream as it is and the stream pads
    channel-sliced f16 batches itself, to the same maps as the full f32
    batch; ``power_program``'s pad in front of a caller's stream changes
    no value and keeps its ``reset``."""
    cfg = Config.tiny()
    fn = _stream(cfg, "maps")

    class _Rx:
        ring_frames = 64

        def __init__(self, cfg):
            self.cfg = cfg

    from zybo_rt_sampler_image_detection_torch.utils.metrics import (
        PipelineMetrics)
    tables = beamform.make_tables(cfg, "lerp", cache=False, device="cpu")
    stage = pipeline.BatchedHeatmapProducer(
        _Rx(cfg), tables, None, PipelineMetrics(), batch=8, power_fn=fn,
        channels=cfg.n_microphones - 4, transfer="f16")
    assert stage.power_fn is fn and stage.stateful_fn is fn
    batch = _batches(cfg, 5, 1)[0]
    batch[:, -4:] = 0.0
    sliced = torch.from_numpy(batch[:, :-4]).half()
    fn.reset()
    a = _np(fn(sliced))
    fn.reset()
    b = _np(fn(torch.from_numpy(batch).half().float()))
    np.testing.assert_array_equal(a, b)
    prog = pipeline.power_program(tables, cfg.n_microphones,
                                  cfg.n_microphones - 4, power_fn=fn)
    assert prog is not fn and prog.reset is fn.reset
    prog.reset()
    np.testing.assert_array_equal(_np(prog(sliced)), a)


def test_heatmap_warmup_resets_stateful_backend():
    """``start_heatmap``'s zero-frame warm-up, and the batched stages'
    ``warmup``, must not pollute a stateful power_fn or beam: a zero frame
    scales P by alpha^-1 and consumes the covariance's first-frame
    replacement."""
    cfg = Config.tiny().replace(udp_port=22140)
    fn = _stream(cfg, "maps")
    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend="python",
                          device="cpu", power_fn=fn)
    try:
        s = p.start_heatmap(warmup=True)
        assert s.power_fn is fn
        assert fn.state["n"] == 0 and fn.state["p"].cov.count == 0
        stage = p.make_heatmap_batched(batch=8)
        stage.warmup()
        assert fn.state["n"] == 0 and fn.state["dq"] is None
        for make in (p.make_miso_batched, p.make_mimo_miso_batched):
            st = make(batch=8, beam="mvdr")
            st.warmup()
            assert st.stateful_fn.state["n"] == 0
        # the combined stage with beam="time" resets the pipeline's stream
        st = p.make_mimo_miso_batched(batch=8, beam="time")
        fn(_batches(cfg, 1, 1)[0])
        assert fn.state["n"] == 8
        st.warmup()
        assert fn.state["n"] == 0
    finally:
        p.stop()


@pytest.mark.parametrize("case", ["live", "sliced", "power_backend",
                                  "mesh"])
def test_mvdr_is_a_pipeline_algorithm(case):
    """``Pipeline(cfg, "mvdr")`` gives the maps of ``Pipeline(cfg, "lerp",
    power_fn=make_mvdr_stream(cfg, "maps"))``, the form the demo and the
    web monitor used: on the live frame, and on sliced f16 batches of the
    full-rate stage, whose stages share the route's one stream, taken as
    it is.  A ``power_backend`` and a ``mesh`` are refused, as on the fft
    route."""
    cfg = Config.tiny()
    if case == "power_backend":
        with pytest.raises(ValueError, match="mvdr route"):
            pipeline.Pipeline(cfg, "mvdr", device="cpu",
                              power_backend="equiv_kernel")
        return
    p = pipeline.Pipeline(cfg, "mvdr", replay_mode=True, backend="python",
                          device="cpu")
    if case == "mesh":
        from zybo_rt_sampler_image_detection_torch.parallel import mesh

        m = mesh.make_mesh(1, 1, devices=[torch.device("cpu")])
        with pytest.raises(ValueError, match="mvdr route"):
            p.make_heatmap_batched(batch=8, mesh=m)
        return
    q = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend="python",
                          device="cpu", power_fn=_stream(cfg, "maps"))
    batches = _batches(cfg, 7, 3)
    try:
        if case == "live":
            progs = [r.start_heatmap(warmup=True).power_fn for r in (p, q)]
            ins = [torch.from_numpy(b[0]) for b in batches]
        else:
            n_ch = cfg.n_microphones - 4
            stages = [r.make_heatmap_batched(batch=8, channels=n_ch,
                                             transfer="f16")
                      for r in (p, q)]
            for st in stages:
                st.warmup()
            progs = [st.power_fn for st in stages]
            assert p.make_heatmap_batched(batch=8).power_fn is progs[0]
            for b in batches:
                b[:, n_ch:] = 0.0
            ins = [torch.from_numpy(b[:, :n_ch]).half() for b in batches]
        stream = progs[0]
        assert stream.tables is p.power_tables and stream.state["n"] == 0
        for x in ins:
            np.testing.assert_array_equal(_np(progs[0](x)),
                                          _np(progs[1](x)))
    finally:
        p.stop()
        q.stop()


def test_single_frame_live_path():
    """kind='maps' also serves the live loop: an (M, N) frame takes the
    per-frame recursion, returns an (X, Y) map and drops the carried
    quadratic form; the next batched call re-measures it."""
    cfg = Config.tiny()
    fn = _stream(cfg, "maps")
    fn.reset()
    batch = _batches(cfg, 5, 1)[0]
    fn(batch)
    assert fn.state["dq"] is not None
    m = _np(fn(batch[0]))
    assert m.shape == (cfg.max_res_x, cfg.max_res_y)
    assert np.isfinite(m).all()
    assert fn.state["dq"] is None
    assert fn.state["n"] == batch.shape[0] + 1
    m2 = _np(fn(batch))
    assert np.isfinite(m2).all() and fn.state["dq"] is not None


def _sync(fn, jfn):
    """Carry JAX's stream state into the port's (``from_numpy``)."""
    js = jfn.state["p"]
    fn.state["p"] = freq.PrecisionState.from_numpy(
        js.P_re, js.P_im, js.cov.R_re, js.cov.R_im, int(js.cov.count),
        js.load, device="cpu")
    dq = jfn.state["dq"]
    fn.state["dq"] = None if dq is None else torch.from_numpy(
        np.array(dq, np.float32))


def test_stream_matches_jax():
    """Each kind against JAX ``make_mvdr_stream`` over 3 batches of 8, the
    host counters equal after every batch.  Each batch starts from JAX's
    state, carried across by ``from_numpy``: two free-running f32
    trajectories part by their rounding, amplified ~1/alpha a frame and by
    the conditioning of these near-repeated frames — by the third batch
    they differ by 2.1x the maps gate, where each of them is 0.2-2.3x the
    gate from a complex128 run of the same stream (the long free-running
    gates are in ``test_torch_freq.py``'s complex128 drift tests)."""
    cfg = Config.tiny()
    d = _direction(cfg)
    batches = _batches(cfg, 13, 3)
    for kind in ("maps", "beams", "maps_beams"):
        fn = _stream(cfg, kind)
        jfn = jpipeline.make_mvdr_stream(_jcfg(cfg), kind)
        fn.reset()
        jfn.reset()
        for batch in batches:
            _sync(fn, jfn)
            if kind == "maps":
                maps, jmaps = fn(batch), jfn(batch)
            elif kind == "beams":
                beams, jbeams = fn(batch, d), jfn(batch, d)
            else:
                (maps, beams), (jmaps, jbeams) = fn(batch, d), jfn(batch, d)
            if kind != "beams":
                np.testing.assert_allclose(_np(maps), np.asarray(jmaps),
                                           **MAPS_GATE, err_msg=kind)
            if kind != "maps":
                want = np.asarray(jbeams)
                scale = np.abs(want).max()
                np.testing.assert_allclose(_np(beams) / scale, want / scale,
                                           **BEAMS_GATE, err_msg=kind)
            assert all(fn.state[k] == jfn.state[k] for k in ("n", "r", "dqc"))
            assert (fn.state["dq"] is None) == (jfn.state["dq"] is None)
        assert fn.state["n"] == 24


def test_stream_device_is_explicit():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.make_mvdr_stream(Config.tiny())
    with pytest.raises(ValueError, match="kind"):
        pipeline.make_mvdr_stream(Config.tiny(), "nope", device="cpu")


# -- the demos on loopback ---------------------------------------------------

def _source_frames(cfg, tx, ty, n):
    delays = geometry.calculate_delays(cfg)
    active, _ = geometry.active_microphones(cfg)
    rng = np.random.default_rng(3)
    base = rng.standard_normal(cfg.n_samples * 3).astype(np.float32) * 0.05
    lag = (delays[tx, ty].max() - delays[tx, ty]).round().astype(int)
    fr = np.zeros((cfg.n_microphones, cfg.n_samples), np.float32)
    for i, m in enumerate(active):
        fr[m] = base[cfg.n_samples - lag[i]:2 * cfg.n_samples - lag[i]]
    noise = np.random.default_rng(4).standard_normal(
        (n, cfg.n_microphones, cfg.n_samples)).astype(np.float32) * 0.005
    return list(fr + noise)


def test_demo_mimo_mvdr_headless(capsys):
    """``demo mimo --algorithm mvdr --headless``: the live stage through
    the stream's single-frame recursion prints heatmaps."""
    cfg = Config.tiny().replace(udp_port=22141)
    th = streamer.stream_in_background(cfg, _source_frames(cfg, 4, 3, 1000),
                                       n_arrays=1, delay=0.5,
                                       rate=2 * cfg.sample_rate)
    demo.main(["mimo", "--replay", "--headless", "--algorithm", "mvdr",
               "--frames", "3", "--preset", "tiny", "--port", "22141",
               "--backend", "python", "--device", "cpu"])
    th.join(timeout=30.0)     # its packet loop would slow the next test
    assert not th.is_alive()
    out = capsys.readouterr().out
    assert "heatmap #1" in out and "metrics:" in out
    assert "'gaps': 0" in out


def test_demo_mimo_fft_headless(capsys):
    cfg = Config.tiny().replace(udp_port=22145)
    th = streamer.stream_in_background(cfg, _source_frames(cfg, 4, 3, 1000),
                                       n_arrays=1, delay=0.5,
                                       rate=2 * cfg.sample_rate)
    demo.main(["mimo", "--replay", "--headless", "--algorithm", "fft",
               "--frames", "3", "--preset", "tiny", "--port", "22145",
               "--backend", "python", "--device", "cpu"])
    th.join(timeout=30.0)
    assert not th.is_alive()
    out = capsys.readouterr().out
    assert "heatmap #1" in out and "metrics:" in out


@pytest.fixture
def one_thread():
    """One intra-op thread for a stage that must keep line rate on the
    CPU: with two, each batch waits on torch's thread pool, and when the
    suite's other workers hold every core a batch took 100 ms instead of
    25 and now and then stalled for 0.3-1.9 s, past the 256-frame ring
    (335 ms at the tiny preset's 763 frames/s), which then overwrote
    frames."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("extra,port", [
    (["--algorithm", "mvdr"], 22142),
    (["--audio", "null", "--beam", "mvdr"], 22143),
    (["--audio", "null", "--beam", "mvdr", "--audio-only"], 22146),
])
def test_demo_fullrate_mvdr_cpu(capsys, extra, port, one_thread):
    """``demo fullrate --algorithm mvdr`` (the batched Capon maps),
    ``--audio null --beam mvdr`` (maps and beams from one update) and
    ``--audio-only``: line rate with 0 skipped, 0 gaps, 0 underruns."""
    rc = demo.main(["fullrate", "--device", "cpu", "--preset", "tiny",
                    "--seconds", "2", "--batch", "64", "--port", str(port)]
                   + extra)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "FULL RATE SUSTAINED" in out
    assert "skipped (ring overwrites) = 0; ingest packet gaps = 0" in out
    if "--audio" in extra:
        assert "GAPLESS" in out and "underrun frames = 0" in out


def test_demo_miso_mvdr_cpu(capsys):
    """``demo miso --beam mvdr`` takes the gapless batched stage (no
    ``--fullrate`` needed) on the native emulator at line rate."""
    cfg = Config.tiny().replace(udp_port=22144)
    t = np.arange(cfg.n_samples * 64) / cfg.sample_rate
    sig = np.tile(np.sin(2 * np.pi * 2000.0 * t).astype(np.float32),
                  (cfg.n_microphones, 1)) * 0.1
    sig += np.random.default_rng(5).standard_normal(sig.shape).astype(
        np.float32) * 0.01
    emu = streamer.NativeStreamer(cfg, n_arrays=1)
    emu.start(sig, rate=cfg.sample_rate)
    try:
        rc = demo.main(["miso", "--replay", "--device", "cpu", "--preset",
                        "tiny", "--beam", "mvdr", "--batch", "64",
                        "--seconds", "1.5", "--audio", "null", "--port",
                        "22144", "--backend", "native", "--azimuth", "20"])
    finally:
        emu.stop()
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "GAPLESS" in out and "underrun frames = 0" in out


# -- apps/plot ---------------------------------------------------------------

@pytest.mark.parametrize("algo", list(plot.ALGOS))
def test_plot_compute_heatmaps_equal_jax(algo):
    cfg = Config.tiny()
    frame = plot.generate_sig(cfg)
    np.testing.assert_array_equal(frame, jplot.generate_sig(_jcfg(cfg)))
    got = plot.compute_heatmaps(cfg, frame, (algo,), device="cpu")[algo]
    want = np.asarray(jplot.compute_heatmaps(_jcfg(cfg), frame,
                                             (algo,))[algo])
    assert got.shape == want.shape == (cfg.max_res_x, cfg.max_res_y)
    gate = {"fft": FFT_GATE, "mvdr": MVDR_GATE}.get(algo, TIME_GATE)
    np.testing.assert_allclose(got, want, **gate)


def test_plot_main_writes_png(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(plot, "Config", Config.tiny)
    out = tmp_path / "h.png"
    plot.main(["--out", str(out), "--device", "cpu", "--algos", "lerp",
               "fft", "mvdr"])
    assert out.stat().st_size > 0
    text = capsys.readouterr().out
    assert "fft peak=" in text and "mvdr peak=" in text
