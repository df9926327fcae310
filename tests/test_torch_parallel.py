"""The port's device mesh (``parallel/mesh.py``) on CPU meshes built from
repeated ``torch.device("cpu")``: one test for each of the 11 tests of the
JAX package's ``tests/test_parallel.py``, at its shapes and tolerances.
Each sharded result is held to the port's single-device result at the JAX
gate and to the JAX sharded result on the 8-device virtual CPU mesh
(``conftest.py``) on the same tables; the kernel paths (K1 and K2 a block)
run their plain versions here.  The reference-shape test runs on the card
(``tests/test_torch_cuda.py``), as no full-size configuration runs on the
CPU.  Also: the sharded full-rate stage and its refusals
(``tests/test_fullrate.py:293-370``), ``Trainer(mesh=)`` against
``Trainer()`` and against JAX ``Trainer(mesh=make_mesh(4, 1))``,
``dryrun_multichip(8)`` and ``make_mesh()`` without a GPU.
UDP ports 22180-22181."""

import time

import jax
import numpy as np
import pytest
import torch

from conftest import synth_frame
from zybo_rt_sampler_image_detection_tpu.models import data as jdata
from zybo_rt_sampler_image_detection_tpu.models import train as jtrain
from zybo_rt_sampler_image_detection_tpu.models import yolo as jyolo
from zybo_rt_sampler_image_detection_tpu.ops import beamform as jb
from zybo_rt_sampler_image_detection_tpu.ops import freq as jfreq
from zybo_rt_sampler_image_detection_tpu.ops import freq_equiv as jfe
from zybo_rt_sampler_image_detection_tpu.parallel import mesh as jmesh
from zybo_rt_sampler_image_detection_torch.apps.pipeline import (
    BatchedHeatmapProducer, Pipeline)
from zybo_rt_sampler_image_detection_torch.config import Config
from zybo_rt_sampler_image_detection_torch.ingest import streamer
from zybo_rt_sampler_image_detection_torch.models import train, yolo
from zybo_rt_sampler_image_detection_torch.ops import beamform as tb
from zybo_rt_sampler_image_detection_torch.ops import freq, freq_equiv
from zybo_rt_sampler_image_detection_torch.ops import fused_kernel as fk
from zybo_rt_sampler_image_detection_torch.parallel import dryrun
from zybo_rt_sampler_image_detection_torch.parallel import mesh as pmesh
from zybo_rt_sampler_image_detection_torch.utils.metrics import (
    PipelineMetrics)

torch.set_num_threads(2)

SHAPES = [(8, 1), (1, 8), (4, 2), (2, 4)]
CPU8 = [torch.device("cpu")] * 8
# the port against the JAX package on one input: f32 reassociation, the
# golden gate (tests/test_torch_beamform.py)
JAX_RTOL = 1e-5
LEAF_RNORM = 3e-4         # every leaf after a step (tests/test_vision.py:451)
LOSS_RTOL = 1e-4          # the losses (tests/test_torch_train.py)


def _mesh(n_data, n_model):
    return pmesh.make_mesh(n_data, n_model, devices=CPU8)


def _port_tables(jt):
    """The port's tables on the JAX package's (identical weights)."""
    return tb.SteeringTables.from_numpy(
        np.asarray(jt.W), None if jt.Wc is None else np.asarray(jt.Wc),
        np.asarray(jt.adaptive), tau_min=jt.tau_min, corr_js=jt.corr_js,
        precision=jt.precision, n_samples=jt.n_samples, res_x=jt.res_x,
        res_y=jt.res_y, algorithm=jt.algorithm, device="cpu")


def _port_freq(jt):
    return freq.FreqTables.from_numpy(
        np.asarray(jt.phase_re), np.asarray(jt.phase_im),
        np.asarray(jt.adaptive), lo=jt.lo, hi=jt.hi, res_x=jt.res_x,
        res_y=jt.res_y, n_samples=jt.n_samples, device="cpu")


def _frames(cfg, rng, n):
    return np.stack([synth_frame(cfg, rng) for _ in range(n)])


def _close(got, ref, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_matches_single(tiny_cfg, rng, shape):
    frames = _frames(tiny_cfg, rng, 8)
    jt = jb.make_lerp_tables(tiny_cfg)
    t = _port_tables(jt)
    ref = tb.steered_power(torch.from_numpy(frames), t)
    m = _mesh(*shape)
    got = pmesh.sharded_steered_power(m, pmesh.shard_tables(t, m))(frames)
    assert got.shape == ref.shape
    _close(got, ref, 1e-6, 1e-12)
    jm = jmesh.make_mesh(*shape)
    jgot = jmesh.sharded_steered_power(jm, jmesh.shard_tables(jt, jm))(
        frames)
    _close(got, jgot, JAX_RTOL, 1e-12)


def test_mesh_uses_all_devices():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    m = pmesh.make_mesh(devices=CPU8)
    assert m.devices.size == 8 == jmesh.make_mesh().devices.size
    assert m.shape == {"data": 8, "model": 1}
    assert pmesh.make_mesh(2, 4, devices=CPU8).shape == {"data": 2,
                                                         "model": 4}
    with pytest.raises(ValueError, match="needs 16 devices"):
        pmesh.make_mesh(4, 4, devices=CPU8)


def test_make_mesh_defaults_to_the_card():
    """Without ``devices`` the mesh takes every CUDA device; with no GPU it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        m = pmesh.make_mesh()
        assert m.devices.size == torch.cuda.device_count()
        assert all(d.type == "cuda" for d in m.devices.flat)
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            pmesh.make_mesh()
        with pytest.raises(RuntimeError):
            pmesh.make_mesh(devices=["cuda"])


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_fused_matches_single(tiny_cfg, rng, shape):
    """The time-domain kernel (K2) a block, data x model, equals the
    single-device exact path; each block holds its own slice."""
    frames = _frames(tiny_cfg, rng, 8)
    jt = jb.make_lerp_tables(tiny_cfg)
    t = _port_tables(jt)
    ref = tb.steered_power(torch.from_numpy(frames), t)
    m = _mesh(*shape)
    st = pmesh.shard_tables(t, m)
    fn = pmesh.sharded_fused_power(m, st)
    got = fn(frames)
    _close(got, ref, 1e-4, 1e-10)
    assert len(fn.beamformers) == shape[1]      # one a model shard here
    assert all(b.D == st.d_loc for b in fn.beamformers.values())
    jm = jmesh.make_mesh(*shape)
    jgot = jmesh.sharded_fused_power(jm, jmesh.shard_tables(jt, jm),
                                     tile_d=8, chunk_b=2)(frames)
    _close(got, jgot, 1e-4, 1e-10)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_equiv_matches_single(tiny_cfg, rng, shape):
    """The exact frequency-domain path sharded data x model (the padded
    response, sliced before the reshape) equals the time-domain exact path
    and the single-device equiv path."""
    n_model = shape[1]
    frames = _frames(tiny_cfg, rng, 8)
    jt = jb.make_lerp_tables(tiny_cfg)
    t = _port_tables(jt)
    ref = tb.steered_power(torch.from_numpy(frames), t)
    et = freq_equiv.make_equiv_tables(t)
    m = _mesh(*shape)
    set_ = pmesh.shard_equiv_tables(et, m)
    assert set_.tables.H.shape[0] % n_model == 0
    got = pmesh.sharded_equiv_power(m, set_)(frames)
    _close(got, ref, 1e-4, 1e-8)
    single = freq_equiv.equiv_steered_power(frames, et)
    _close(got, single, 1e-5, 1e-9)
    jm = jmesh.make_mesh(*shape)
    jgot = jmesh.sharded_equiv_power(
        jm, jmesh.shard_equiv_tables(jfe.make_equiv_tables(jt), jm))(frames)
    _close(got, jgot, JAX_RTOL, 1e-9)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_equiv_kernel_matches_single(tiny_cfg, rng, shape):
    """The fused equiv kernel (K1) a block equals the single-device exact
    path; a batch that does not divide the data axis pads globally."""
    frames = _frames(tiny_cfg, rng, 8)
    jt = jb.make_tables(tiny_cfg.replace(matmul_precision="high"), "lerp",
                        cache=False)
    t = _port_tables(jt)
    ref = tb.steered_power(torch.from_numpy(frames), t)
    m = _mesh(*shape)
    fn = pmesh.sharded_equiv_kernel_power(m, t)
    got = fn(frames)
    _close(got, ref, 5e-5, 1e-8)
    _close(fn(frames[:5]), ref[:5], 5e-5, 1e-8)
    # every shard's slice is a whole number of FP32 direction tiles
    assert all(b.D % 8 == 0 for b in fn.beamformers.values())
    jm = jmesh.make_mesh(*shape)
    jgot = np.asarray(jmesh.sharded_equiv_kernel_power(jm, jt)(frames))
    _close(got, jgot, 5e-5, 1e-8)


def test_sharded_fft_power_matches_single(tiny_cfg, rng):
    """Frequency bins over ``model`` reproduce the single-device Bartlett
    map."""
    frames = _frames(tiny_cfg, rng, 8)
    jt = jfreq.make_freq_tables(tiny_cfg, 100.0)
    t = _port_freq(jt)
    ref = freq.fft_steered_power(frames, t)
    m = _mesh(2, 4)
    got = pmesh.sharded_fft_power(m, t)(frames)
    _close(got, ref, 1e-6, 1e-12)
    jgot = jmesh.sharded_fft_power(jmesh.make_mesh(2, 4), jt)(frames)
    _close(got, jgot, JAX_RTOL, 1e-12)


def test_sharded_mvdr_matches_single(tiny_cfg, rng):
    """The streaming-MVDR state split by bins over the whole mesh: the
    rank-1 and rank-B updates and the Capon map, and the per-frame map
    scan, equal the single-device numerics (padded bins masked)."""
    frames = _frames(tiny_cfg, rng, 4)
    jt = jfreq.make_freq_tables(tiny_cfg, 100.0)
    t = _port_freq(jt)
    m = _mesh(4, 2)
    stp, w = pmesh.shard_freq_tables(t, m, axes=("data", "model"))
    assert stp.tables.phase.shape[0] % 8 == 0 and float(w.sum()) == \
        t.phase.shape[0]
    for block in (False, True):
        step = freq.update_precision_block if block else \
            freq.update_precision
        st = step(freq.init_precision(t), frames, t)
        ref = freq.mvdr_power_precision(st, t)
        sp = pmesh.shard_precision_state(freq.init_precision(stp.tables),
                                         m)
        sp = pmesh.sharded_update_precision(sp, frames, stp, block=block)
        got = pmesh.sharded_mvdr_power_precision(sp, stp)
        _close(got, ref, 1e-5, 1e-10)
    maps_ref, _ = freq.mvdr_maps_scan(freq.init_precision(t), frames, t)
    maps, _ = pmesh.sharded_mvdr_maps_scan(
        pmesh.shard_precision_state(freq.init_precision(stp.tables), m),
        frames, stp)
    _close(maps, maps_ref, 1e-4, 1e-9)
    # the JAX package's sharded scan on the same frames
    jm = jmesh.make_mesh(4, 2)
    jtp, jw = jmesh.shard_freq_tables(jt, jm, axes=("data", "model"))
    jmaps, _ = jfreq.mvdr_maps_scan(
        jmesh.shard_precision_state(jfreq.init_precision(jtp), jm), frames,
        jtp, bin_weights=jw)
    _close(maps, np.asarray(jmaps), 1e-4, 1e-9)


def test_sharded_matches_single_hybrid(tiny_cfg, rng):
    """Model sharding with the hybrid algorithm: the 4-D correction tensor
    splits with the directions."""
    frames = _frames(tiny_cfg, rng, 4)
    jt = jb.make_tables(tiny_cfg, "hybrid", cache=False)
    t = _port_tables(jt)
    ref = tb.steered_power(torch.from_numpy(frames), t)
    m = _mesh(2, 4)
    st = pmesh.shard_tables(t, m)
    assert st.blocks[0][0].Wc.shape[1] == st.d_loc
    _close(pmesh.sharded_steered_power(m, st)(frames), ref, 1e-6, 1e-12)
    got2 = pmesh.sharded_fused_power(m, st)(frames)
    _close(got2, ref, 1e-4, 1e-10)
    jm = jmesh.make_mesh(2, 4)
    jgot = jmesh.sharded_fused_power(jm, jmesh.shard_tables(jt, jm),
                                     tile_d=8, chunk_b=2)(frames)
    _close(got2, jgot, 1e-4, 1e-10)


def test_sharded_fused_plans_on_mesh(tiny_cfg, rng):
    """The port's counterpart of JAX's chunked-T test: its time-domain
    kernel is one kernel with a K loop, so each block's plan is the one
    ``fused_kernel.plan`` gives for that block's shape and batch (windowed
    taps, TK < T), and the blocks run it to the single-device result."""
    frames = _frames(tiny_cfg, rng, 4)
    jt = jb.make_lerp_tables(tiny_cfg)
    t = _port_tables(jt)
    ref = tb.steered_power(torch.from_numpy(frames), t)
    m = _mesh(2, 4)
    fn = pmesh.sharded_fused_power(m, pmesh.shard_tables(t, m))
    plans = fn.plans(len(frames))
    assert set(plans) == set(fn.beamformers)
    for key, p in plans.items():
        b = fn.beamformers[key]
        assert p == fk.plan(b.N, b.M, b.TK, b.DP, 2, b.NL,
                            b.Wp.element_size(), b.JM, b.Tc)
        assert b.TK < t.n_taps_line and p.bps >= 1
    _close(fn(frames), ref, 1e-4, 1e-10)


def test_sharded_mvdr_real_127_bins(tiny_cfg, rng):
    """The per-frame map scan at the reference bin count: N=256 gives 127
    bins, which pad to 128 over 8 shards with a repeated bin; the masked
    maps equal single-device, on a second batch too, and JAX's."""
    cfg = tiny_cfg.replace(n_samples=256)
    jt = jfreq.make_freq_tables(cfg, 100.0)
    t = _port_freq(jt)
    assert t.hi - t.lo == 127
    frames = (np.random.default_rng(12).standard_normal(
        (4, cfg.n_microphones, cfg.n_samples)) * 0.1).astype(np.float32)
    maps_ref, st_ref = freq.mvdr_maps_scan(freq.init_precision(t), frames, t)
    m = _mesh(2, 4)
    stp, w = pmesh.shard_freq_tables(t, m, axes=("data", "model"))
    assert stp.tables.phase.shape[0] == 128
    sp = pmesh.shard_precision_state(freq.init_precision(stp.tables), m)
    maps, sp2 = pmesh.sharded_mvdr_maps_scan(sp, frames, stp)
    _close(maps, maps_ref, 1e-4, 1e-9)
    maps_ref2, _ = freq.mvdr_maps_scan(st_ref, frames * 1.1, t)
    maps2, _ = pmesh.sharded_mvdr_maps_scan(sp2, frames * 1.1, stp)
    _close(maps2, maps_ref2, 1e-4, 1e-9)
    jmaps, _ = jfreq.mvdr_maps_scan(jfreq.init_precision(jt), frames, jt)
    _close(maps, np.asarray(jmaps), 1e-4, 1e-9)


# -- the sharded full-rate stage ----------------------------------------------

def test_sharded_fullrate_pipeline():
    """Loopback stream -> ingest -> the batched stage over a (4, 2) mesh:
    every batch splits over the data devices and runs the sharded policy
    program; zero drops, and the maps equal the single-device product."""
    cfg = Config.tiny().replace(udp_port=22180)
    n_frames, K = 24, 8
    rng = np.random.default_rng(33)
    base = (rng.standard_normal((cfg.n_microphones, cfg.n_samples))
            * 0.05).astype(np.float32)
    frames = [(base * (1.0 + 0.1 * i)).astype(np.float32)
              for i in range(n_frames)]
    p = Pipeline(cfg, algorithm="lerp", replay_mode=True, device="cpu")
    p.receiver.exact_reference = False
    got = {}

    def sink(powers, first_seq):
        for j, pw in enumerate(powers):
            got[first_seq + j] = pw

    m = _mesh(4, 2)
    streamer.stream_in_background(cfg, frames, n_arrays=1, delay=0.5,
                                  exact_reference=False,
                                  rate=2 * cfg.sample_rate)
    p.connect(timeout=5.0)
    stage = p.start_heatmap_batched(batch=K, sink=sink, mesh=m)
    assert stage.mesh is m
    deadline = time.time() + 30.0
    while stage.processed < n_frames and time.time() < deadline:
        time.sleep(0.05)
    p.stop()
    assert stage.skipped == 0
    assert p.report()["ingest"]["gaps"] == 0
    assert set(range(1, n_frames + 1)) <= set(got)
    for s in (1, n_frames // 2, n_frames):
        wire = (np.round(frames[s - 1].astype(np.float64) * cfg.norm_factor)
                / cfg.norm_factor).astype(np.float32)
        expect = tb.steered_power(torch.from_numpy(wire), p.tables)
        _close(got[s], expect, 1e-4, 1e-10)


def test_sharded_stage_rejects_bad_config():
    """Mesh transfers need a batch that divides the data axis, full-width
    f32 batches, and no power_fn beside the mesh."""
    cfg = Config.tiny().replace(udp_port=22181)
    p = Pipeline(cfg, algorithm="lerp", replay_mode=True, device="cpu")
    m = _mesh(4, 2)
    with pytest.raises(ValueError, match="divide"):
        BatchedHeatmapProducer(p.receiver, p.tables, p.q_power,
                               PipelineMetrics(), batch=6, mesh=m)
    with pytest.raises(ValueError, match="full-width"):
        BatchedHeatmapProducer(p.receiver, p.tables, p.q_power,
                               PipelineMetrics(), batch=8, mesh=m,
                               channels=8)
    with pytest.raises(ValueError, match="exclusive"):
        BatchedHeatmapProducer(p.receiver, p.tables, p.q_power,
                               PipelineMetrics(), batch=8, mesh=m,
                               power_fn=lambda f: f)
    q = Pipeline(cfg, algorithm="lerp", replay_mode=True, device="cpu",
                 power_backend="freq_equiv")
    with pytest.raises(ValueError, match="exclusive"):
        q.make_heatmap_batched(batch=8, mesh=m)


# -- data-parallel training ---------------------------------------------------

def _rnorm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _assert_variables_close(got, ref):
    ref_leaves = dict(_leaves(ref))
    got_leaves = dict(_leaves(got))
    assert got_leaves.keys() == ref_leaves.keys()
    for path, r in ref_leaves.items():
        assert _rnorm(got_leaves[path], r) < LEAF_RNORM, path


def _batches(n, seed=5):
    rng = np.random.default_rng(seed)
    return [jdata.synthetic_detection_batch(rng, 8, 64, num_classes=2)
            for _ in range(n)]


def test_trainer_mesh_matches_single_and_jax():
    """Trainer(mesh=(4, 1)) against Trainer() and against JAX
    Trainer(mesh=make_mesh(4, 1)), all from JAX's init: BatchNorm's
    statistics and npos over the global batch, one AdamW step a step.
    Three steps at the trainer's gates (losses rtol 1e-4, every leaf
    within a relative norm of 3e-4, batch_stats included)."""
    jcfg = jyolo.YoloConfig(input_size=64, width_mult=0.25, num_classes=2)
    cfg = yolo.YoloConfig(input_size=64, width_mult=0.25, num_classes=2)
    jtr = jtrain.Trainer(jcfg, learning_rate=3e-3, seed=3,
                         mesh=jmesh.make_mesh(4, 1))
    single = train.Trainer(cfg, learning_rate=3e-3, device="cpu")
    sharded = train.Trainer(cfg, learning_rate=3e-3, mesh=_mesh(4, 1))
    assert sharded.device == torch.device("cpu")
    for tr in (single, sharded):
        tr.state.variables = jtr.state.variables
    for images, boxes in _batches(3):
        lj = jtr.train_step(images, boxes)
        l1 = single.train_step(images, boxes)
        l2 = sharded.train_step(images, boxes)
        assert l2 == pytest.approx(l1, rel=LOSS_RTOL)
        assert l2 == pytest.approx(lj, rel=LOSS_RTOL)
    _assert_variables_close(sharded.state.variables, single.state.variables)
    _assert_variables_close(sharded.state.variables,
                            jax.tree.map(np.asarray, jtr.state.variables))
    with pytest.raises(ValueError, match="divide"):
        sharded.train_step(images[:6], boxes[:6])


def test_sharded_batchnorm_is_global():
    """One sharded training forward: each block's BatchNorm normalises
    with the global batch's mean and biased variance, so the heads equal
    the one-device forward on the whole batch, and the running statistics
    move the same."""
    cfg = yolo.YoloConfig(input_size=64, width_mult=0.25)
    a = yolo.init_params(cfg, torch.Generator().manual_seed(1),
                         device="cpu").train()
    b = yolo.init_params(cfg, torch.Generator().manual_seed(1),
                         device="cpu").train()
    x = torch.from_numpy(np.random.default_rng(4).random(
        (8, 64, 64, 3), np.float32))
    with torch.no_grad():
        ref = a(x)
        got = b.forward_shards(list(x.chunk(4)))
    for r, shards in zip(ref, got):
        _close(torch.cat(shards), r, 1e-4, 1e-5)
    for (k, va), (_, vb) in zip(a.state_dict().items(),
                                b.state_dict().items()):
        if "running" in k:
            _close(vb, va, 1e-5, 1e-7)


def test_dryrun_multichip_cpu():
    """The port's dry run over 8 CPU devices: every sharded path at the
    JAX gates and one data-parallel training step."""
    out = dryrun.dryrun_multichip(8, devices=CPU8)
    assert out["mesh"] == [4, 2] and np.isfinite(out["train_loss"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            dryrun.dryrun_multichip(4)      # default devices: the card
