"""The port's vision serving path against the JAX package: the tiny-YOLO
heads and decode on carried variables (rtol 1e-5 / atol 1e-5), NMS (equal
masks and indices, rows at 1e-6), the detector's tables
(``tests/test_vision.py:207``: rtol 1e-5 / atol 1e-4), the weights
formats, the AP / mAP / MOTA gates of ``tests/test_vision.py`` on weights
carried across with ``variables_to_state_dict``, SORT and the smoothed
tracker, the copied modules against their originals, the runner and the
tracker stages.  Everything on the CPU; no UDP port."""

import pickle
import queue
import time

import jax
import numpy as np
import pytest
import torch

from zybo_rt_sampler_image_detection_tpu.models import data as jdata
from zybo_rt_sampler_image_detection_tpu.models import detect as jdetect
from zybo_rt_sampler_image_detection_tpu.models import eval as jeval
from zybo_rt_sampler_image_detection_tpu.models import nms as jnms
from zybo_rt_sampler_image_detection_tpu.models import sort as jsort
from zybo_rt_sampler_image_detection_tpu.models import tracking as jtracking
from zybo_rt_sampler_image_detection_tpu.models import train as jtrain
from zybo_rt_sampler_image_detection_tpu.models import yolo as jyolo
from zybo_rt_sampler_image_detection_torch.apps.pipeline import (
    BatchedTrackerStage, TrackerStage)
from zybo_rt_sampler_image_detection_torch.fusion.decider import (
    SensorFusionDecider)
from zybo_rt_sampler_image_detection_torch.models import (
    data, detect, nms, runner, sort, tracking, yolo)
from zybo_rt_sampler_image_detection_torch.models import eval as ev
from zybo_rt_sampler_image_detection_torch.utils.metrics import (
    PipelineMetrics)

torch.set_num_threads(2)

HEAD_RTOL = HEAD_ATOL = 1e-5          # heads and decode, FP32
DET_RTOL, DET_ATOL = 1e-5, 1e-4       # detection tables (test_vision.py:207)
NMS_ATOL = 1e-6


def _jax_variables(size, width, classes, seed=0):
    """JAX ``TinyYolo`` variables with random BatchNorm scales, biases and
    statistics, as NumPy arrays."""
    cfg = jyolo.YoloConfig(input_size=size, width_mult=width,
                           num_classes=classes)
    model, v = jyolo.init_params(cfg, jax.random.PRNGKey(seed))
    v = jax.tree.map(np.asarray, v)
    rng = np.random.default_rng(seed + 100)
    for name, blk in v["params"].items():
        if "BatchNorm_0" not in blk:
            continue
        bn, st = blk["BatchNorm_0"], v["batch_stats"][name]["BatchNorm_0"]
        n = bn["scale"].shape
        bn["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        bn["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
        st["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
        st["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return cfg, model, v


def _port_cfg(jcfg):
    return yolo.YoloConfig(input_size=jcfg.input_size,
                           width_mult=jcfg.width_mult,
                           num_classes=jcfg.num_classes)


def _port_model(jcfg, variables):
    m = yolo.TinyYolo(_port_cfg(jcfg)).eval()
    m.load_state_dict(yolo.variables_to_state_dict(variables))
    return m


def _detector_pair(size=64, width=0.25, classes=2, max_det=8, seed=0):
    jcfg, _, v = _jax_variables(size, width, classes, seed)
    jdet = jdetect.YoloDetector(cfg=jcfg, max_det=max_det)
    jdet.variables = v
    det = detect.YoloDetector(cfg=_port_cfg(jcfg), max_det=max_det,
                            device="cpu")
    det.variables = v
    return jdet, det


def _frames(n, seed=3, hw=(100, 140)):
    rng = np.random.default_rng(seed)
    return [(rng.random((hw[0] + 10 * i, hw[1], 3)) * 255).astype(np.uint8)
            for i in range(n)]


def _assert_dets_close(got, ref):
    assert len(got) == len(ref)
    if ref:
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=DET_RTOL, atol=DET_ATOL)


# -- models.yolo ---------------------------------------------------------------

@pytest.mark.parametrize("size,width,classes,batch", [(64, 0.25, 2, 2),
                                                      (416, 1.0, 1, 1)])
def test_heads_and_decode_match_jax(size, width, classes, batch):
    """Heads against JAX ``model.apply`` on converted variables with
    random BatchNorm statistics, at the small test shape and at full
    width (416 px, width 1.0); ``decode_all`` against JAX's on the same
    heads.  (Decoded through each package's own heads, a box edge near 0
    px carries the head's rounding times its anchor, up to 344 px, which
    an absolute 1e-5 px does not allow for.)"""
    jcfg, model, v = _jax_variables(size, width, classes)
    x = np.random.default_rng(1).random((batch, size, size, 3)).astype(
        np.float32)
    jheads = model.apply(v, x, train=False)
    jdec = jyolo.decode_all(jcfg, jheads)
    m = _port_model(jcfg, v)
    with torch.no_grad():
        heads = m(torch.from_numpy(x))
        dec = yolo.decode_all(m.cfg, [torch.from_numpy(np.array(h))
                                      for h in jheads])
    for a, b in zip(heads, jheads):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=HEAD_RTOL, atol=HEAD_ATOL)
    for a, b in zip(dec, jdec):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=HEAD_RTOL, atol=HEAD_ATOL)


def test_forward_and_decode_shapes():
    cfg = yolo.YoloConfig(input_size=64, width_mult=0.25, num_classes=2)
    m = yolo.init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    with torch.no_grad():
        heads = m(torch.zeros(2, 64, 64, 3))
    assert heads[0].shape == (2, 2, 2, 3 * 7)     # /32
    assert heads[1].shape == (2, 4, 4, 3 * 7)     # /16
    boxes, obj, cls = yolo.decode_all(cfg, heads)
    n = 2 * 2 * 3 + 4 * 4 * 3
    assert boxes.shape == (2, n, 4) and obj.shape == (2, n)
    assert cls.shape == (2, n, 2)
    assert bool(((obj >= 0) & (obj <= 1)).all())


def test_variables_round_trip_and_seeded_init():
    """state_dict -> JAX layout -> state_dict is exact, the JAX module runs
    on the port's seeded weights, and one seed gives the same weights."""
    cfg = yolo.YoloConfig(input_size=64, width_mult=0.25, num_classes=2)
    m = yolo.init_params(cfg, torch.Generator().manual_seed(7),
                         device="cpu")
    v = yolo.state_dict_to_variables(m.state_dict())
    sd = yolo.variables_to_state_dict(v)
    for k, t in m.state_dict().items():
        assert torch.equal(sd[k], t), k
    again = yolo.init_params(cfg, torch.Generator().manual_seed(7),
                         device="cpu")
    for k, t in again.state_dict().items():
        assert torch.equal(m.state_dict()[k], t), k
    jcfg = jyolo.YoloConfig(input_size=64, width_mult=0.25, num_classes=2)
    x = np.random.default_rng(2).random((1, 64, 64, 3)).astype(np.float32)
    jheads = jyolo.TinyYolo(jcfg).apply(v, x, train=False)
    with torch.no_grad():
        heads = m(torch.from_numpy(x))
    for a, b in zip(heads, jheads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=HEAD_RTOL, atol=HEAD_ATOL)


def test_bn_momentum_is_flax_momentum():
    """flax's momentum 0.97 weighs the old statistics; the port's torch
    momentum weighs the new batch: one training-mode step moves the
    running mean by 3% of the batch mean."""
    blk = yolo.ConvBlock(3, 8).train()
    with torch.no_grad():
        blk(torch.ones(2, 3, 4, 4) * 2.0)
        y = torch.nn.functional.conv2d(torch.ones(2, 3, 4, 4) * 2.0,
                                       blk.conv.weight, padding=1)
    np.testing.assert_allclose(blk.bn.running_mean.numpy(),
                               0.03 * y.mean(dim=(0, 2, 3)).numpy(),
                               rtol=1e-5, atol=1e-7)


# -- models.nms ----------------------------------------------------------------

def _nms_case(seed, B=3, N=120):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (B, N, 2))
    wh = rng.uniform(5, 40, (B, N, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    # two-decimal scores tie often; rows 10 and 11 duplicate rows 3 and 5
    scores = np.round(rng.random((B, N)), 2).astype(np.float32)
    boxes[:, 10], scores[:, 10] = boxes[:, 3], scores[:, 3]
    boxes[:, 11] = boxes[:, 5]
    scores[:, :15] -= 0.6                      # some below 0 and invalid
    return boxes, scores


@pytest.mark.parametrize("seed,iou,score_thr,max_det", [
    (0, 0.45, 0.0, 32), (1, 0.5, 0.2, 16), (2, 0.3, 0.0, 64),
    (3, 0.7, 0.5, 8)])
def test_nms_matches_jax(seed, iou, score_thr, max_det):
    boxes, scores = _nms_case(seed)
    jout = [np.asarray(a) for a in jnms.batched_nms(
        boxes, scores, iou, score_thr, max_det)]
    out = [a.numpy() for a in nms.batched_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), iou, score_thr,
        max_det)]
    np.testing.assert_array_equal(out[1], jout[1])            # mask
    np.testing.assert_array_equal(out[2], jout[2])            # indices
    assert out[2].dtype == np.int32
    np.testing.assert_allclose(out[0], jout[0], rtol=0, atol=NMS_ATOL)
    for b in range(len(boxes)):                 # one frame at a time
        one = [a.numpy() for a in nms.nms(
            torch.from_numpy(boxes[b]), torch.from_numpy(scores[b]), iou,
            score_thr, max_det)]
        jone = [np.asarray(a) for a in jnms.nms(
            boxes[b], scores[b], iou, score_thr, max_det)]
        for a, r in zip(one, jone):
            np.testing.assert_array_equal(a, r)


def test_nms_suppresses_overlaps():
    boxes = torch.tensor([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60],
                          [0, 0, 10, 10]], dtype=torch.float32)
    scores = torch.tensor([0.9, 0.8, 0.7, 0.6])
    out, mask, idx = nms.nms(boxes, scores, iou_threshold=0.5, max_det=4)
    assert int(mask.sum()) == 2
    kept = out[mask]
    assert kept[0, 4].item() == pytest.approx(0.9)
    assert kept[1, 4].item() == pytest.approx(0.7)
    assert idx[mask].tolist() == [0, 2]
    assert torch.equal(out[~mask], torch.zeros(2, 5))
    assert idx[~mask].tolist() == [0, 0]


# -- models.detect ------------------------------------------------------------

@pytest.mark.parametrize("include_class", [False, True])
def test_detections_match_jax(include_class):
    """``get_detections``, ``get_detections_batch`` with a padded partial
    batch, and ``include_class``, against the JAX detector holding the
    same variables."""
    jdet, det = _detector_pair()
    frames = _frames(3)
    got = det.get_detections_batch(frames, pad_to=4,
                                   include_class=include_class)
    ref = jdet.get_detections_batch(frames, pad_to=4,
                                    include_class=include_class)
    assert len(got) == 3
    for g, r in zip(got, ref):
        _assert_dets_close(g, r)
    for f in frames:
        _assert_dets_close(
            det.get_detections(f, include_class=include_class),
            jdet.get_detections(f, include_class=include_class))
        _assert_dets_close(det.get_detections(f, conf_threshold=0.2),
                           jdet.get_detections(f, conf_threshold=0.2))
    assert det.get_detections_batch([]) == []


def test_batch_matches_single():
    """The port's batched program equals its per-frame calls, a padded
    partial batch included (``tests/test_vision.py:193-210``)."""
    _, det = _detector_pair(seed=4)
    frames = _frames(3, seed=5)
    batched = det.get_detections_batch(frames, pad_to=4)
    for f, dets in zip(frames, batched):
        _assert_dets_close(dets, det.get_detections(f))


def test_jax_weights_load_in_port_and_back(tmp_path):
    """A ``.pkl`` from JAX ``save_weights`` loads in the port (same
    detections), and one the port writes loads in JAX."""
    jdet, _ = _detector_pair(seed=2)
    path = str(tmp_path / "jax.pkl")
    jdetect.save_weights(path, jdet.variables)
    det = detect.YoloDetector(model_path=path, cfg=_port_cfg(jdet.cfg),
                              max_det=8, device="cpu")
    frame = _frames(1, seed=6)[0]
    _assert_dets_close(det.get_detections(frame), jdet.get_detections(frame))
    back = str(tmp_path / "port.pkl")
    detect.save_weights(back, det.variables)
    with open(back, "rb") as f:
        assert isinstance(pickle.load(f), dict)
    jdet2 = jdetect.YoloDetector(model_path=back, cfg=jdet.cfg, max_det=8)
    _assert_dets_close(jdet2.get_detections(frame),
                       jdet.get_detections(frame))


def test_detector_defaults_to_the_card():
    """No device given: the card, which raises here rather than running
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        detect.YoloDetector(cfg=yolo.YoloConfig(input_size=64,
                                                width_mult=0.25))
    with pytest.raises(RuntimeError, match="cuda"):
        detect.pretrained_demo_detector()
    with pytest.raises(RuntimeError, match="cuda"):
        runner.ObjectDetection()


# -- quality gates on carried weights -----------------------------------------

def _held_out(num_classes=1):
    return jdata.synthetic_detection_batch(np.random.default_rng(999), 48,
                                           size=64, num_classes=num_classes)


def test_demo_detector_ap_gate():
    """The committed demo detector: AP@0.5 >= 0.75 on the held-out set
    (``tests/test_vision.py:173-190``) in the port, equal to the JAX
    detector's AP on the same weights."""
    det = detect.pretrained_demo_detector(device="cpu")
    jdet = jdetect.YoloDetector(cfg=jyolo.YoloConfig(input_size=64,
                                                     width_mult=0.25))
    jdet.variables = detect.load_weights(detect.DEMO_WEIGHTS)
    imgs, boxes = _held_out()
    ap = ev.evaluate_detector(det, imgs, boxes)
    assert ap >= 0.75, f"AP@0.5 regressed: {ap:.3f}"
    assert ap == pytest.approx(jeval.evaluate_detector(jdet, imgs, boxes),
                               abs=1e-9)


@pytest.fixture(scope="module")
def jax_three_class():
    """A JAX 3-class detector trained with the recipe of
    ``tests/test_vision.py:272-275`` (700 steps, about 25 s)."""
    cfg = jyolo.YoloConfig(input_size=64, width_mult=0.25, num_classes=3)
    tr = jtrain.Trainer(cfg, learning_rate=3e-3)
    tr.fit(jdata.synthetic_dataset(0, n_batches=700, batch_size=8, size=64,
                                   num_classes=3), log_every=0)
    return cfg, jax.tree.map(np.asarray, tr.state.variables)


def test_multiclass_map_gate_on_carried_weights(jax_three_class):
    """mAP@0.5 >= 0.65 and every class >= 0.5 in the port, on the JAX
    detector's weights (``tests/test_vision.py:261-287``)."""
    jcfg, v = jax_three_class
    det = detect.YoloDetector(cfg=_port_cfg(jcfg), device="cpu")
    det.variables = v
    imgs, boxes = _held_out(num_classes=3)
    dets = [np.asarray(det.get_detections(
        (im * 255).astype(np.uint8), conf_threshold=0.05,
        include_class=True), np.float64).reshape(-1, 6) for im in imgs]
    aps, mAP = ev.per_class_average_precision(dets, boxes, 3)
    assert mAP >= 0.65, f"mAP@0.5 regressed: {mAP:.3f} (per-class {aps})"
    for c, ap in enumerate(aps):
        assert ap >= 0.5, f"class {c} AP regressed: {ap:.3f}"


def test_multiclass_detections_match_jax(jax_three_class):
    """The trained 3-class detector's tables in both packages."""
    jcfg, v = jax_three_class
    jdet = jdetect.YoloDetector(cfg=jcfg)
    jdet.variables = v
    det = detect.YoloDetector(cfg=_port_cfg(jcfg), device="cpu")
    det.variables = v
    imgs, _ = _held_out(num_classes=3)
    frames = [(im * 255).astype(np.uint8) for im in imgs[:8]]
    for g, r in zip(det.get_detections_batch(frames, include_class=True),
                    jdet.get_detections_batch(frames, include_class=True)):
        _assert_dets_close(g, r)


def test_scene_camera_detectable():
    """The demo's detectable scene (``--camera -2``) with the committed
    detector: the object found in at least 4 of 6 frames, and
    ``focus_beam`` steering at the confident detection
    (``tests/test_vision.py:290-325``)."""
    det = detect.pretrained_demo_detector(device="cpu")
    cam = data.SceneCamera((240, 320))
    hits, best = 0, None
    for _ in range(6):
        ok, frame = cam.read()
        assert ok and frame.shape == (240, 320, 3)
        good = [d for d in det.get_detections(frame, conf_threshold=0.3)
                if tracking.compute_iou(d[:4], cam.last_box) > 0.3]
        if good:
            hits += 1
            best = max(good, key=lambda d: d[4])
    assert hits >= 4, f"detector found the scene object in {hits}/6 frames"
    calls = []
    dec = SensorFusionDecider((320, 240))
    assert dec.focus_beam(lambda h, v: calls.append((h, v)), best) == 0
    assert len(calls) == 1


# -- models.sort / tracking / eval / data --------------------------------------

def test_sort_lifecycle():
    sort.KalmanBoxTracker.count = 0
    t = sort.Sort(max_age=1, min_hits=2)
    box = np.array([[10, 10, 30, 30, 0.9]])
    r1 = t.update(box)
    assert len(r1) == 1
    tid = r1[0, 4]
    for i in range(5):
        shifted = box.copy()
        shifted[0, [0, 2]] += 2 * (i + 1)
        r = t.update(shifted)
    assert len(r) == 1 and r[0, 4] == tid
    t.update(np.empty((0, 5)))
    t.update(np.empty((0, 5)))
    assert len(t.trackers) == 0


def test_sort_separate_objects_get_distinct_ids():
    sort.KalmanBoxTracker.count = 0
    t = sort.Sort(min_hits=1)
    r = t.update(np.array([[0, 0, 10, 10, 0.9], [100, 100, 130, 130, 0.8]]))
    assert len(set(r[:, 4].astype(int))) == 2


def test_correlation_revival():
    rng = np.random.default_rng(2)
    prev = (rng.random((80, 80, 3)) * 255).astype(np.uint8)
    prev[20:40, 20:40] = 255
    frame = np.roll(prev, 2, axis=1)
    candidates = [[21.0, 20.0, 41.0, 40.0, 0.3]]
    tracking.revive_candidates(candidates, [[20, 20, 40, 40, 0.9]], prev,
                               frame, confh=0.5)
    assert candidates[0][4] == 0.5


class _StubDetector:
    def get_detections(self, frame, conf_threshold=0.0):
        return [[10.0, 10.0, 30.0, 30.0, 0.9]]


def test_tracking_queue_loop():
    q_in, q_out = queue.Queue(), queue.Queue(maxsize=2)
    for i in range(4):
        q_in.put((i, np.zeros((64, 64, 3), np.uint8)))
    tracking.process_video_track_boxes_only(
        q_in, q_out, detector=_StubDetector(), max_frames=4)
    results = [q_out.get() for _ in range(q_out.qsize())]
    frame_no, overlay, rect = results[-1]
    assert overlay.shape == (64, 64, 3)
    assert rect[2] == pytest.approx(0.9)
    assert rect[0] == [10, 10] and rect[1] == [30, 30]


def _motion_sequence(rng, size=96, n_frames=40):
    """Two objects moving linearly on textured noise
    (``tests/test_vision.py:345-360``)."""
    frames, gts = [], []
    for f in range(n_frames):
        img = (rng.random((size, size, 3)) * 60).astype(np.uint8)
        x0, y0 = 4 + int(f * 1.5), 10
        img[y0:y0 + 20, x0:x0 + 20] = 230
        x1, y1 = size - 28 - int(f * 1.5), 62
        img[y1:y1 + 20, x1:x1 + 20] = 180
        frames.append(img)
        gts.append(np.asarray([[x0, y0, x0 + 20, y0 + 20, 0],
                               [x1, y1, x1 + 20, y1 + 20, 1]], np.float64))
    return frames, gts


class _NoisyOracle:
    """gt + pixel jitter; dropouts vanish (hard) or fall to a
    low-confidence candidate (``tests/test_vision.py:363-390``)."""

    def __init__(self, gts, rng, dropout=0.15, lowconf=True):
        self.gts, self.rng = gts, rng
        self.dropout, self.lowconf = dropout, lowconf
        self.i = -1

    def get_detections(self, frame, conf_threshold=0.0):
        self.i += 1
        dets = []
        for b in self.gts[self.i]:
            j = self.rng.normal(0, 1.0, 4)
            if self.rng.random() < self.dropout:
                if not self.lowconf:
                    continue
                conf = 0.3
            else:
                conf = 0.75 + 0.2 * self.rng.random()
            dets.append([b[0] + j[0], b[1] + j[1], b[2] + j[2],
                         b[3] + j[3], conf])
        return dets


_MOTA_CASES = [("clean", dict(dropout=0.0), {}, 0.95),
               ("lowconf", dict(dropout=0.15, lowconf=True), {}, 0.90),
               ("hard", dict(dropout=0.15, lowconf=False), {}, 0.55),
               ("hard_coasted", dict(dropout=0.15, lowconf=False),
                dict(max_age=3, report_coasted=True), 0.90)]


def _mota(tracking_mod, sort_mod, eval_mod, okw, tkw):
    sort_mod.KalmanBoxTracker.count = 0           # track ids from 1
    rng = np.random.default_rng(42)
    frames, gts = _motion_sequence(rng)
    st = tracking_mod.SmoothedTracker(_NoisyOracle(gts, rng, **okw), **tkw)
    tracks = [st.step(f)[0] for f in frames]
    return eval_mod.mota([gts], [tracks]), tracks


def test_smoothed_tracker_mota_gate():
    """The MOTA gates of ``tests/test_vision.py:396-423`` through the
    port's ``SmoothedTracker``, equal to the JAX package's run."""
    results = {}
    for name, okw, tkw, gate in _MOTA_CASES:
        (m, counts), tracks = _mota(tracking, sort, ev, okw, tkw)
        (jm, jcounts), jtracks = _mota(jtracking, jsort, jeval, okw, tkw)
        results[name] = (m, counts)
        assert m >= gate, f"{name}: MOTA {m:.3f} < {gate} ({counts})"
        assert (m, counts) == (jm, jcounts)
        for a, b in zip(tracks, jtracks):
            np.testing.assert_array_equal(a, b)
    assert results["clean"][1]["id_switches"] == 0
    assert results["hard_coasted"][0] > results["hard"][0]
    assert results["hard_coasted"][1]["id_switches"] == 0
    assert results["hard_coasted"][1]["false_positives"] == 0


def test_copied_sort_matches_jax():
    rng = np.random.default_rng(8)
    a, b = sort.Sort(max_age=2, min_hits=1), jsort.Sort(max_age=2,
                                                        min_hits=1)
    sort.KalmanBoxTracker.count = jsort.KalmanBoxTracker.count = 0
    for _ in range(30):
        k = int(rng.integers(0, 4))
        xy = rng.uniform(0, 80, (k, 2))
        dets = np.concatenate([xy, xy + 20, rng.random((k, 1))], 1)
        np.testing.assert_array_equal(a.update(dets), b.update(dets))
    boxes = rng.uniform(0, 50, (6, 4))
    boxes[:, 2:] += boxes[:, :2] + 1
    np.testing.assert_array_equal(sort.iou_batch(boxes, boxes[:3]),
                                  jsort.iou_batch(boxes, boxes[:3]))


def test_copied_data_and_eval_match_jax():
    """The synthetic data, the scene camera and the metrics equal the JAX
    package's, byte for byte."""
    for classes in (1, 3):
        imgs, boxes = data.synthetic_detection_batch(
            np.random.default_rng(5), 6, size=64, num_classes=classes)
        jimgs, jboxes = jdata.synthetic_detection_batch(
            np.random.default_rng(5), 6, size=64, num_classes=classes)
        np.testing.assert_array_equal(imgs, jimgs)
        for a, b in zip(boxes, jboxes):
            np.testing.assert_array_equal(a, b)
    cam, jcam = data.SceneCamera((60, 80)), jdata.SceneCamera((60, 80))
    for _ in range(3):
        np.testing.assert_array_equal(cam.read()[1], jcam.read()[1])
        assert cam.last_box == jcam.last_box
    rng = np.random.default_rng(6)
    dets = [np.concatenate([b[:, :4] + rng.normal(0, 2, (len(b), 4)),
                            rng.random((len(b), 1))], 1) for b in jboxes]
    assert ev.average_precision(dets, jboxes) == \
        jeval.average_precision(dets, jboxes)
    np.testing.assert_array_equal(
        ev.box_iou(dets[0][:, :4], jboxes[0][:, :4]),
        jeval.box_iou(dets[0][:, :4], jboxes[0][:, :4]))


def test_process_video_track_offline(tmp_path):
    """Offline tracked-video processing over a tiny mp4
    (``tests/test_runner_udptools.py:42-75``)."""
    cv2 = pytest.importorskip("cv2")
    src = str(tmp_path / "in.mp4")
    vw = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 64))
    rng = np.random.default_rng(0)
    for i in range(6):
        f = (rng.random((64, 64, 3)) * 40).astype(np.uint8)
        f[20:40, 5 + i * 3:25 + i * 3] = (0, 0, 255)
        vw.write(f)
    vw.release()

    class MovingStub:
        def get_detections(self, frame, conf_threshold=0.0):
            ys, xs = np.where(frame[:, :, 2] > 200)
            if len(xs) == 0:
                return []
            return [[float(xs.min()), float(ys.min()), float(xs.max()),
                     float(ys.max()), 0.9]]

    out = str(tmp_path / "out.mp4")
    assert tracking.process_video_track(src, detector=MovingStub(),
                                        out_path=out, rec=True) == 6
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
    cap.release()


# -- models.runner ---------------------------------------------------------------

def test_runner_queue_loop():
    r = runner.ObjectDetection.__new__(runner.ObjectDetection)
    r.detector = _StubDetector()
    q_in, q_out = queue.Queue(), queue.Queue()
    for i in range(3):
        q_in.put((i, np.zeros((32, 32, 3), np.uint8)))
    q_in.put((3, None))
    assert r.run_conf_n_inference(q_in, q_out) == 3
    assert q_out.qsize() == 3
    _, dets = q_out.get()
    assert dets[0][4] == 0.9


def test_runner_inference_matches_detector():
    r = runner.ObjectDetection(model_path=detect.DEMO_WEIGHTS,
                               cfg=detect.DEMO_CONFIG, device="cpu")
    ok, frame = data.SceneCamera((240, 320)).read()
    assert r.run_inference(frame, 0.3) == \
        detect.pretrained_demo_detector(device="cpu").get_detections(
            frame, 0.3)


# -- the tracker stages ------------------------------------------------------------

class _BatchStub:
    cfg = yolo.YoloConfig(input_size=64, width_mult=0.25, num_classes=2)

    def __init__(self):
        self.batch_calls = 0

    def get_detections_batch(self, frames, conf_threshold=0.0, pad_to=0):
        self.batch_calls += 1
        return [[[10.0, 10.0, 30.0, 30.0, 0.9]] for _ in frames]


def test_batched_tracker_stage_processes_every_frame():
    """Every queued frame processed once, in order, in at most 4 detector
    programs for 10 frames (``tests/test_vision.py:213-263``)."""
    det = _BatchStub()
    n_frames, K = 10, 4
    q_in, q_out = queue.Queue(), queue.Queue(maxsize=n_frames + 1)
    for i in range(1, n_frames + 1):
        q_in.put((i, np.zeros((64, 64, 3), np.uint8)))
    stage = BatchedTrackerStage(det, q_in, q_out, PipelineMetrics(), batch=K)
    stage.start()
    deadline = time.time() + 10.0
    while stage.processed < n_frames and time.time() < deadline:
        time.sleep(0.02)
    stage.stop()
    stage.join(timeout=2.0)
    assert not stage.is_alive()
    assert stage.processed == n_frames
    results = [q_out.get() for _ in range(q_out.qsize())]
    assert [r[0] for r in results] == list(range(1, n_frames + 1))
    for no, overlay, rect in results:
        assert overlay.shape == (64, 64, 3)
        assert rect[2] == pytest.approx(0.9)
    assert det.batch_calls <= 4


def test_tracker_stages_on_the_demo_detector():
    """Both tracker stages on the committed detector over the scene
    camera: the overlays carry the box the detector found, and
    ``emit_boxes`` publishes the int-cast track boxes instead."""
    det = detect.pretrained_demo_detector(device="cpu")
    cam = data.SceneCamera((240, 320))
    frames = [cam.read()[1] for _ in range(6)]
    for cls, kw in ((TrackerStage, {}),
                    (BatchedTrackerStage, dict(batch=3)),
                    (BatchedTrackerStage, dict(batch=3, emit_boxes=True))):
        q_in, q_out = queue.Queue(), queue.Queue(maxsize=10)
        for i, f in enumerate(frames, 1):
            q_in.put((i, f))
        stage = cls(det, q_in, q_out, PipelineMetrics(), **kw)
        stage.start()
        deadline = time.time() + 20.0
        while q_out.qsize() < len(frames) and time.time() < deadline:
            time.sleep(0.02)
        stage.stop()
        stage.join(timeout=5.0)
        assert not stage.is_alive()
        results = [q_out.get() for _ in range(q_out.qsize())]
        assert [r[0] for r in results] == list(range(1, len(frames) + 1))
        no, payload, rect = results[-1]
        if kw.get("emit_boxes"):
            assert payload.ndim == 2 and payload.shape[1] == 5
        else:
            assert payload.shape == (240, 320, 3) and payload.any()
        assert rect[2] > 0.3
