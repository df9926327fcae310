"""The port's fused sensor-fusion stage (``apps/fused.py``) on the CPU:
one packed program a batch against the separate paths it fuses (the
compositor on the stage's own powers: equal bytes; the detector on the
same device-resized input: atol 1e-5, equal masks and classes, the JAX
package's tests/test_fused.py:60-93), the whole batch against JAX
``FusedSensorStage._launch`` on the same inputs (composites within 1
count, detections at rtol 1e-5 / atol 1e-4), the yuv420 transport end to
end, the EMA carry, and ``demo sensorfusion --composite device|fused`` on
loopback at the tiny preset.  UDP ports 22160-22161."""

import queue
import threading
import time

import jax
import numpy as np
import pytest
import torch

import zybo_rt_sampler_image_detection_tpu as zj
from zybo_rt_sampler_image_detection_tpu.apps import fused as jfused
from zybo_rt_sampler_image_detection_tpu.fusion import composite as jcomp
from zybo_rt_sampler_image_detection_tpu.ingest.receiver import (
    Receiver as JReceiver)
from zybo_rt_sampler_image_detection_tpu.models import detect as jdetect
from zybo_rt_sampler_image_detection_tpu.models import yolo as jyolo
from zybo_rt_sampler_image_detection_tpu.ops import beamform as jb
from zybo_rt_sampler_image_detection_tpu.utils.metrics import (
    PipelineMetrics as JMetrics)
from zybo_rt_sampler_image_detection_torch.apps import demo, fused
from zybo_rt_sampler_image_detection_torch.apps.pipeline import (
    power_program)
from zybo_rt_sampler_image_detection_torch.config import Config
from zybo_rt_sampler_image_detection_torch.fusion.composite import (
    DeviceCompositor)
from zybo_rt_sampler_image_detection_torch.ingest import streamer
from zybo_rt_sampler_image_detection_torch.ingest.receiver import Receiver
from zybo_rt_sampler_image_detection_torch.models import detect, yolo
from zybo_rt_sampler_image_detection_torch.ops import beamform
from zybo_rt_sampler_image_detection_torch.utils.metrics import (
    PipelineMetrics)

torch.set_num_threads(2)

CAM = (48, 64)
WINDOW = (80, 48)
DET_ATOL = 1e-5                         # test_fused.py:93, same input
JAX_DET = dict(rtol=1e-5, atol=1e-4)    # test_vision.py:207, across packages


class _NullDisplay:
    def show(self, img):
        pass


def _jcfg(cfg):
    return zj.Config(**{f: getattr(cfg, f) for f in
                        cfg.__dataclass_fields__})


def _stage(tables, det, cfg, batch=3, **kw):
    comp = DeviceCompositor((cfg.max_res_x, cfg.max_res_y), CAM,
                            window=WINDOW, yolo_shape=CAM, max_tracks=4,
                            device="cpu")
    return fused.FusedSensorStage(
        Receiver(cfg, replay_mode=True), tables, comp, det, queue.Queue(),
        _NullDisplay(), PipelineMetrics(), batch=batch, **kw)


@pytest.fixture(scope="module")
def pair():
    """The port's stage and the JAX package's, same config, tables,
    detector weights and inputs."""
    cfg = Config.tiny()
    tables = beamform.make_tables(cfg, "lerp", cache=False, device="cpu")
    jdet = jdetect.YoloDetector(cfg=jyolo.YoloConfig(input_size=64,
                                                     width_mult=0.25))
    det = detect.YoloDetector(cfg=yolo.YoloConfig(input_size=64,
                                                  width_mult=0.25),
                              device="cpu")
    det.variables = jax.tree.map(np.asarray, jdet.variables)
    s = _stage(tables, det, cfg)
    jcfg = _jcfg(cfg)
    jcomp_ = jcomp.DeviceCompositor((cfg.max_res_x, cfg.max_res_y), CAM,
                                    window=WINDOW, yolo_shape=CAM,
                                    max_tracks=4)
    js = jfused.FusedSensorStage(
        JReceiver(jcfg, replay_mode=True),
        jb.make_tables(jcfg, "lerp", cache=False), jcomp_, jdet,
        queue.Queue(), _NullDisplay(), JMetrics(), batch=3)
    rng = np.random.default_rng(7)
    mic = (rng.standard_normal((3, cfg.n_microphones, cfg.n_samples))
           * 0.1).astype(np.float32)
    cams = rng.integers(0, 255, (3,) + CAM + (3,)).astype(np.uint8)
    boxes = np.full((4, 5), -100.0, np.float32)
    boxes[0] = [5.0, 5.0, 30.0, 30.0, 1.0]
    return s, js, cfg, tables, mic, cams, boxes


def _run(s, mic, cams, boxes, prev=None):
    s._boxes, s._prev = boxes.copy(), prev
    host, done = s._launch(mic.copy(), cams, s.batch)
    assert done is None                       # the CPU path does not wait
    return s._unpack(host.numpy())


def test_fused_program_parity(pair):
    s, _, cfg, tables, mic, cams, boxes = pair
    comps, dets, mask, cls_ids, metas, beams = _run(s, mic, cams, boxes)
    assert beams is None and comps.shape == (3, 48, 80, 3)
    # 1) the compositor on the separately computed powers: equal bytes
    powers = power_program(tables, cfg.n_microphones)(torch.from_numpy(mic))
    K = s.batch
    yolos = np.broadcast_to(boxes, (K,) + boxes.shape).copy()
    ref, _, ref_meta = s.comp(powers, cams, yolos, s.comp.init_prev(),
                              count=K)
    np.testing.assert_array_equal(comps, ref.numpy())
    np.testing.assert_allclose(metas, ref_meta.numpy(), rtol=0, atol=1e-6)
    # 2) the in-program resize + forward against the same resize fed
    # through the detector's program
    imgs = s.detector_input(torch.from_numpy(cams))
    rd, rm, rc = (t.numpy() for t in s.detector.program(imgs))
    np.testing.assert_allclose(dets, rd, rtol=0, atol=DET_ATOL)
    np.testing.assert_array_equal(mask, rm)
    np.testing.assert_array_equal(cls_ids, rc)


def test_fused_batch_matches_jax(pair):
    """The whole packed program against JAX ``_launch`` + ``_unpack`` on
    the same inputs: composites within one count, meta at atol 1e-6,
    detections at rtol 1e-5 / atol 1e-4, equal masks and classes."""
    s, js, cfg, tables, mic, cams, boxes = pair
    comps, dets, mask, cls_ids, metas, _ = _run(s, mic, cams, boxes)
    js._boxes, js._prev = boxes.copy(), None
    jc, jd, jm, jcls, jmeta, _ = js._unpack(
        np.asarray(js._launch(mic.copy(), cams, js.batch)))
    diff = np.abs(comps.astype(np.int32) - jc.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    np.testing.assert_allclose(metas, jmeta, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(mask, jm)
    np.testing.assert_array_equal(cls_ids, jcls)
    np.testing.assert_allclose(dets[mask], jd[jm], **JAX_DET)


def test_fused_yuv420_end_to_end(pair):
    """The yuv420 stage (with the f16 mic transfer) runs end to end and
    its composites sit in the 4:2:0 loss class of the rgb stage's given
    the same 4:2:0 camera (the JAX test's gate, test_fused.py:132-177)."""
    s, _, cfg, tables, mic, cams, boxes = pair
    sy = _stage(tables, s.detector, cfg, display_transport="yuv420",
                transfer="f16")
    comps_y, _, mask_y, *_ = _run(sy, mic, cams, boxes)
    h, w = cams.shape[1:3]
    cams_rt = fused._i420_to_bgr(
        fused._host_bgr_to_i420(cams).reshape(len(cams), -1), h, w)
    comps_r, _, mask_r, *_ = _run(s, mic, cams_rt, boxes)
    rt = fused._i420_to_bgr(
        fused._bgr_to_i420(torch.from_numpy(comps_r)).numpy(),
        comps_r.shape[1], comps_r.shape[2])
    diff = np.abs(comps_y.astype(int) - rt.astype(int))
    assert diff.mean() < 3.0, diff.mean()
    assert mask_y.shape == mask_r.shape


def test_fused_ema_carry_advances(pair):
    """Two launches: the EMA carry of batch 1 feeds batch 2, exactly as
    two sequential compositor calls."""
    s, _, cfg, tables, mic, cams, boxes = pair
    none = np.full_like(boxes, -100.0)
    c1, *_ = _run(s, mic, cams, none)
    s._boxes = none.copy()
    host, _ = s._launch(mic.copy(), cams, s.batch)
    c2 = s._unpack(host.numpy())[0]
    powers = power_program(tables, cfg.n_microphones)(torch.from_numpy(mic))
    yolos = np.broadcast_to(none, (s.batch,) + none.shape).copy()
    r1, prev, _ = s.comp(powers, cams, yolos, s.comp.init_prev())
    r2, _, _ = s.comp(powers, cams, yolos, prev)
    np.testing.assert_array_equal(c1, r1.numpy())
    np.testing.assert_array_equal(c2, r2.numpy())
    assert not np.array_equal(c1, c2)


@pytest.mark.parametrize("listen", [None, "time"])
def test_fused_stage_trims_a_sliced_stage(pair, monkeypatch, listen):
    """A stage sliced to its connected channels, under the card's pick of
    K1 at the ``high`` rung (a stand-in for the policy on CPU tables),
    runs the plane over those channels on the unpadded batch, one K1 call
    a batch: its composites within one count of the compositor on the
    untrimmed maps of the padded batch (the two sum the same FP32 terms
    in another order), the beam unchanged."""
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.ops import equiv_kernel

    s, _, _, _, _, cams, boxes = pair
    cfg = Config.tiny().replace(n_microphones=32, array_slots=2,
                                matmul_precision="high")
    tables = beamform.make_tables(cfg, "lerp", cache=False, device="cpu")
    built, planes = [], []
    k1 = equiv_kernel.equiv_power

    def policy(t, channels=0):
        built.append(equiv_kernel.FusedEquivBeamformer(t, channels=channels))
        return "equiv_kernel", built[-1]

    def recorded(S, H1, *a, **kw):
        planes.append(H1.shape[2])              # the plane's KP
        return k1(S, H1, *a, **kw)

    monkeypatch.setattr(pipeline, "_select_power_backend", policy)
    monkeypatch.setattr(equiv_kernel, "equiv_power", recorded)
    st = _stage(tables, s.detector, cfg, channels=16, listen=listen)
    k, = built
    n_kept = int((tables.adaptive < 16).sum())
    assert st._power is k and 0 < k.M == n_kept < tables.n_mics
    rng = np.random.default_rng(3)
    mic = (rng.standard_normal((st.Km, 16, cfg.n_samples))
           * 0.1).astype(np.float32)
    comps, _, _, _, _, beams = _run(st, mic, cams, boxes)
    assert planes == [k.KP]
    padded = torch.from_numpy(
        np.concatenate([mic, np.zeros_like(mic)], axis=1))
    powers = equiv_kernel.FusedEquivBeamformer(tables)(padded[-st.batch:])
    yolos = np.broadcast_to(boxes, (st.batch,) + boxes.shape).copy()
    ref, _, _ = st.comp(powers, cams, yolos, st.comp.init_prev(),
                        count=st.batch)
    diff = np.abs(comps.astype(np.int32) - ref.numpy().astype(np.int32))
    assert diff.max() <= 1, diff.max()
    if listen:
        np.testing.assert_array_equal(
            beams, beamform.miso_beam(padded, tables, 0).numpy())


def test_fused_stage_refuses_bad_arguments(pair):
    s, _, cfg, tables, *_ = pair
    for kw, what in ((dict(transfer="f8"), "transfer"),
                     (dict(display_transport="nv12"), "display_transport"),
                     (dict(listen="fft"), "listen")):
        with pytest.raises(ValueError, match=what):
            _stage(tables, s.detector, cfg, **kw)
    canvas = DeviceCompositor((cfg.max_res_x, cfg.max_res_y), CAM,
                              window=WINDOW, device="cpu")
    with pytest.raises(ValueError, match="max_tracks"):
        fused.FusedSensorStage(Receiver(cfg, replay_mode=True), tables,
                               canvas, s.detector, queue.Queue(),
                               _NullDisplay(), PipelineMetrics())


# -- demo sensorfusion ----------------------------------------------------------

def _frame_gen(cfg, stop, n_max=5000):
    rng = np.random.default_rng(5)
    base = (rng.standard_normal((cfg.n_microphones, cfg.n_samples))
            * 0.05).astype(np.float32)
    i = 0
    while not stop.is_set() and i < n_max:
        yield (base * (1.0 + 0.01 * (i % 50))).astype(np.float32)
        i += 1


@pytest.mark.parametrize("port,extra", [
    (22160, ["--composite", "device", "--composite-batch", "3",
             "--heatmap-batch", "4", "--heatmap-rate", "0",
             "--tracker-batch", "2", "--detector-size", "96",
             "--detector-width", "0.25", "--camera", "-1"]),
    (22161, ["--composite-batch", "3", "--camera", "-2",
             "--display-transport", "yuv420"]),
])
def test_demo_sensorfusion_device_and_fused(port, extra, capsys):
    """``demo sensorfusion --composite device`` (the batched compositor
    beside the heatmap and tracker stages) and the fused default (the
    committed detector on the detectable scene) on loopback: 6 frames
    composited, the stage's report printed, exit 0."""
    cfg = Config.tiny().replace(udp_port=port)
    stop = threading.Event()
    streamer.stream_in_background(cfg, _frame_gen(cfg, stop), n_arrays=1,
                                  delay=0.5, rate=cfg.sample_rate / 16)
    t0 = time.time()
    try:
        rc = demo.main(["sensorfusion", "--replay", "--preset", "tiny",
                        "--port", str(port), "--headless", "--device",
                        "cpu", "--backend", "python", "--frames", "6",
                        "--width", "160", "--height", "96", "--out", ""]
                       + extra)
    finally:
        stop.set()
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "fused rate:" in out and "composite: {'frames':" in out
    assert "latency_p50_ms" in out and "metrics:" in out
    if "device" in extra:
        assert "'tracker_batched'" in out and "'heatmap_batched'" in out
    else:
        assert "'fused'" in out and "phase_p50_ms" in out
    assert time.time() - t0 < 120.0
