"""The port's direction-innermost equiv path (``sweep="fd"``, TPU K5; its
plain version ``equiv_power_fd_plain`` on the CPU) against the JAX
package: JAX ``FusedEquivBeamformer(..., sweep="fd")`` in interpret mode at
rtol 2e-6 in ``f32``; ``steered_power`` at 5e-5 in ``high`` and 3e-2 with
the peak equal in ``bf16`` (``test_equiv_kernel.py:26,62,71``).

The JAX package gates fd bit-identical to its default sweep
(``test_equiv_kernel.py:137-153``).  That gate does not carry over: the
port's fd sums each chunk's bins and then the chunks in order, K1 sums
every bin in one run, so the two round differently by design.  They are
held to each other at the mode's gate instead.  The CUDA kernel against
its plain version is ``test_torch_cuda.py``.  UDP ports 22120-22123."""

import time

import numpy as np
import pytest
import torch

from zybo_rt_sampler_image_detection_tpu.ops import beamform as jb
from zybo_rt_sampler_image_detection_tpu.ops import equiv_kernel as jk
from zybo_rt_sampler_image_detection_torch import Config
from zybo_rt_sampler_image_detection_torch.apps import pipeline
from zybo_rt_sampler_image_detection_torch.ingest import streamer
from zybo_rt_sampler_image_detection_torch.ops import beamform as tb
from zybo_rt_sampler_image_detection_torch.ops import equiv_kernel as tk

from conftest import synth_frame

torch.set_num_threads(2)

ALGORITHMS = ("pad", "lerp", "convolve", "hybrid", "truncated")
# max cellwise relative error per mode (the JAX kernel's gates)
TOL = {"f32": 2e-6, "high": 5e-5, "bf16": 3e-2}


def _port(jt):
    """The JAX package's tables carried into the port, on the CPU."""
    return tb.SteeringTables.from_numpy(
        np.asarray(jt.W), None if jt.Wc is None else np.asarray(jt.Wc),
        np.asarray(jt.adaptive), tau_min=jt.tau_min, corr_js=jt.corr_js,
        precision=jt.precision, n_samples=jt.n_samples, res_x=jt.res_x,
        res_y=jt.res_y, algorithm=jt.algorithm, device="cpu")


def _frames(cfg, rng, n=3):
    return np.stack([synth_frame(cfg, rng) for _ in range(n)])


def _np(x):
    return x.double().cpu().numpy()


@pytest.mark.parametrize("algorithm", ("lerp", "pad", "hybrid"))
def test_fd_f32_matches_jax_fd_interpret(tiny_cfg, rng, algorithm):
    """Against the JAX fd kernel itself (Pallas interpret mode) on the same
    plan: frame tile 8, three frequency chunks."""
    frames = _frames(tiny_cfg, rng)
    jt = jb.make_tables(tiny_cfg, algorithm, cache=False)
    ref = np.asarray(jk.FusedEquivBeamformer(
        jt, mode="f32", plan_override=(8, 3), sweep="fd")(frames),
        np.float64)
    fd = tk.FusedEquivBeamformer(_port(jt), mode="f32", plan_override=(8, 3),
                                 sweep="fd")
    assert fd.runs_fd and fd.n_fc == 3 and fd.FP == 3 * fd.fc >= fd.F
    got = _np(fd(torch.from_numpy(frames)))
    np.testing.assert_allclose(got, ref, rtol=TOL["f32"], atol=1e-14)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_fd_high_matches_steered_power(tiny_cfg, rng, algorithm):
    frames = _frames(tiny_cfg, rng)
    jt = jb.make_tables(tiny_cfg, algorithm, cache=False)
    ref = np.asarray(jb.steered_power(frames, jt), np.float64)
    fd = tk.FusedEquivBeamformer(_port(jt), mode="high", plan_override=(8, 3),
                                 sweep="fd")
    got = _np(fd(torch.from_numpy(frames)))
    np.testing.assert_allclose(got, ref, rtol=TOL["high"], atol=1e-12)


def test_fd_bf16_display_grade(tiny_cfg, rng):
    frames = _frames(tiny_cfg, rng)
    jt = jb.make_tables(tiny_cfg, "lerp", cache=False)
    ref = np.asarray(jb.steered_power(frames, jt), np.float64)
    fd = tk.FusedEquivBeamformer(_port(jt), mode="bf16", plan_override=(8, 3),
                                 sweep="fd")
    assert fd.H1.dtype == torch.bfloat16
    got = _np(fd(torch.from_numpy(frames)))
    np.testing.assert_allclose(got, ref, rtol=TOL["bf16"], atol=1e-10)
    for b in range(len(frames)):
        assert np.unravel_index(got[b].argmax(), got[b].shape) \
            == np.unravel_index(ref[b].argmax(), ref[b].shape)


@pytest.mark.parametrize("mode", ("f32", "high", "bf16"))
@pytest.mark.parametrize("n_fc", (2, 3, 5))
def test_fd_matches_df(tiny_cfg, rng, mode, n_fc):
    """fd against df (K1's plain version) at the mode's gate.  F = 37
    (lerp) or 41 (hybrid): no chunk count here divides it, so the zero
    bins past F are in every plan."""
    frames = _frames(tiny_cfg, rng, 5)
    for algorithm in ("lerp", "hybrid"):
        t = _port(jb.make_tables(tiny_cfg, algorithm, cache=False))
        fd = tk.FusedEquivBeamformer(t, mode=mode, plan_override=(8, n_fc),
                                     sweep="fd")
        df = tk.FusedEquivBeamformer(t, mode=mode)
        assert fd.FP > fd.F and df.FP == df.F
        # the padded bins are zero in the planes and the bases
        assert not fd.H1[:, fd.F:].any()
        assert not fd.ib1[fd.F:].any() and not fd.ib2[fd.F:].any()
        x = torch.from_numpy(frames)
        np.testing.assert_allclose(_np(fd(x)), _np(df(x)), rtol=TOL[mode],
                                   atol=1e-12, err_msg=algorithm)


def test_fd_one_chunk_equals_df(tiny_cfg, rng):
    """An fd plan of one chunk runs K1, as the JAX forward does."""
    frames = torch.from_numpy(_frames(tiny_cfg, rng))
    t = _port(jb.make_tables(tiny_cfg, "hybrid", cache=False))
    fd = tk.FusedEquivBeamformer(t, mode="f32", plan_override=(8, 1),
                                 sweep="fd")
    assert not fd.runs_fd
    assert torch.equal(fd(frames), tk.FusedEquivBeamformer(t, mode="f32")(
        frames))
    # and the tiny shape's auto fd plan is one chunk: everything fits
    assert tk.FusedEquivBeamformer(t, sweep="fd").n_fc == 1


def test_sweep_and_plan_are_checked():
    t = tb.make_tables(Config.tiny(), "lerp", cache=False, device="cpu")
    with pytest.raises(ValueError, match="sweep"):
        tk.FusedEquivBeamformer(t, sweep="xy")
    with pytest.raises(ValueError, match="plan_override"):
        tk.FusedEquivBeamformer(t, plan_override=(3, 2), sweep="fd")
    with pytest.raises(ValueError, match="plan_override"):
        tk.FusedEquivBeamformer(t, plan_override=(8, 0), sweep="fd")
    # the frame tile of the plan caps the tiles a call may take
    fd = tk.FusedEquivBeamformer(t, plan_override=(2, 3), sweep="fd")
    assert fd.frame_tiles == (2, 1) and fd.frame_tile(5) == 2


@pytest.mark.parametrize("F,Tt", [(154, 98), (158, 106)],
                         ids=["lerp", "hybrid"])
def test_fd_auto_plan_reference_shape(F, Tt):
    """``Config()`` (K = 2M = 512): lerp F=154 Tt=98, hybrid F=158 Tt=106.
    The fewest chunks that fit one block of frame tile 8 (S chunk, a
    two-stage H ring, the working set) are more than one, so the path runs
    the fd kernel and not K1; every frame tile up to 8 fits the chunk, and
    one chunk fewer would not."""
    for itemsize in (4, 2):                     # f32/high, bf16
        n_fc = tk.fd_chunks(F, Tt, 512, itemsize)
        fc = -(-F // n_fc)
        assert n_fc > 1
        for bt in tk.FRAME_TILES:
            if bt <= 8:
                assert tk.smem_bytes_fd(bt, fc, Tt, 512,
                                        itemsize) <= tk.SMEM_MAX
        assert tk.smem_bytes_fd(8, -(-F // (n_fc - 1)), Tt, 512,
                                itemsize) > tk.SMEM_MAX
    assert tk.fd_chunks(154, 98, 512, 4) == 20      # fc = 8 bins
    with pytest.raises(ValueError, match="fd shared-memory plan"):
        tk.fd_chunks(F, 8000, 512, 4)


def test_dir_groups_fill_the_card():
    """Waves of blocks x tiles a block, at its least with the fewest
    groups."""
    # one frame, 14 chunks, 228 tiles, 4 blocks an SM (528 slots): 33
    # groups of at most 7 tiles give 462 blocks, one wave
    assert tk.dir_groups(1, 14, 228, 528) == 33
    # 3 blocks an SM (396 slots): 462 blocks would need a second wave;
    # 26 groups of at most 9 tiles give 364 blocks, one wave
    assert tk.dir_groups(1, 14, 228, 396) == 26
    # two frame tiles of a 222 KB block, one an SM: 924 blocks = 7 full
    # waves of 7 tiles (5 groups would leave a second wave of 8 blocks)
    assert tk.dir_groups(2, 14, 228, 132) == 33
    # never more groups than tiles, never fewer than one
    assert tk.dir_groups(1, 2, 3, 528) == 3
    assert 1 <= tk.dir_groups(64, 32, 228, 132) <= 228
    assert tk.dir_groups(1, 14, 228, 0) >= 1


def test_fd_wrapper_uses_plain_version_only_on_cpu(tiny_cfg, rng):
    """CPU tensors take the plain version without counting a launch; a
    tensor on any other non-CUDA device raises instead of falling back."""
    t = _port(jb.make_tables(tiny_cfg, "hybrid", cache=False))
    fd = tk.FusedEquivBeamformer(t, plan_override=(8, 3), sweep="fd")
    x = torch.from_numpy(_frames(tiny_cfg, rng, 2))
    S, sj, bt = fd.kernel_inputs(x)
    assert S.shape[0] == fd.FP
    kw = dict(n_tail=fd.n_tail, Tc=fd.Tc, inv=fd.inv, n_fc=fd.n_fc)
    args = (S, fd.H1, fd.ib1, fd.ib2, sj, fd.wc)
    before = tk.equiv_power_fd.launches
    out = tk.equiv_power_fd(*args, block_b=bt, **kw)
    assert tk.equiv_power_fd.launches == before
    assert torch.equal(out, tk.equiv_power_fd_plain(*args, **kw))
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in args]
    with pytest.raises(ValueError, match="device"):
        tk.equiv_power_fd(*meta, block_b=bt, **kw)


def _source_frames(cfg, n, seed=7):
    rng = np.random.default_rng(seed)
    base = (rng.standard_normal((cfg.n_microphones, cfg.n_samples))
            * 0.05).astype(np.float32)
    return [(base * (1.0 + 0.1 * (i % 7))).astype(np.float32)
            for i in range(n)]


def _fd_pipeline(cfg, backend):
    """``Pipeline(power_fn=FusedEquivBeamformer(tables, sweep="fd"))``,
    on a three-chunk plan (the tiny shape's own plan is one chunk)."""
    tables = tb.make_tables(cfg, "lerp", cache=False, device="cpu")
    fd = tk.FusedEquivBeamformer(tables, plan_override=(8, 3), sweep="fd")
    assert fd.runs_fd
    p = pipeline.Pipeline(cfg, "lerp", replay_mode=True, backend=backend,
                          device="cpu", power_fn=fd)
    p.receiver.exact_reference = False
    return p


@pytest.mark.parametrize("backend,port", [("python", 22120),
                                          ("native", 22121)])
def test_live_stage_through_fd(backend, port):
    """The live stage with ``power_fn=FusedEquivBeamformer(tables,
    sweep="fd")``: its heatmaps equal ``steered_power`` of the received
    frame at rtol 1e-4 (``test_pipeline.py:80``)."""
    cfg = Config.tiny().replace(udp_port=port)
    p = _fd_pipeline(cfg, backend)
    streamer.stream_in_background(cfg, _source_frames(cfg, 1) * 1000,
                                  n_arrays=1, delay=0.3,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    try:
        p.connect(timeout=10.0)
        p.start_heatmap()
        maps = [p.q_power.get(timeout=20.0) for _ in range(3)]
        frame, _ = p.receiver.read_frame(timeout=5.0)
    finally:
        p.stop()
    ref = tb.steered_power(torch.from_numpy(frame), p.tables).double()
    power = maps[-1][0]
    assert power.shape == (cfg.max_res_x, cfg.max_res_y)
    np.testing.assert_allclose(power, ref.numpy(), rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("backend,port", [("python", 22122),
                                          ("native", 22123)])
def test_fullrate_stage_through_fd(backend, port):
    """The full-rate stage through the fd beamformer: every frame
    beamformed once (0 skipped), each within rtol 1e-4 of
    ``steered_power`` on the wire signal."""
    cfg = Config.tiny().replace(udp_port=port)
    p = _fd_pipeline(cfg, backend)
    frames = _source_frames(cfg, 24)
    got = {}

    def sink(powers, first_seq):
        for j, pw in enumerate(powers):
            got[first_seq + j] = pw

    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.5,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    p.connect(timeout=5.0)
    stage = p.start_heatmap_batched(batch=4, sink=sink)
    deadline = time.time() + 20.0
    while stage.processed < len(frames) and time.time() < deadline:
        time.sleep(0.05)
    p.stop()
    assert stage.skipped == 0 and stage.processed >= len(frames)
    assert set(range(1, len(frames) + 1)) <= set(got)
    for s in (1, 12, 24):
        wire = (np.round(frames[s - 1].astype(np.float64) * cfg.norm_factor)
                / cfg.norm_factor).astype(np.float32)
        ref = tb.steered_power(torch.from_numpy(wire), p.tables).double()
        np.testing.assert_allclose(got[s], ref.numpy(), rtol=1e-4,
                                   atol=1e-10)
