"""The JAX package's training gates, held by the port on the CPU at the
JAX values and step counts, each trained from the port's own seeded init:

* the loss falls over 12 steps (``tests/test_vision.py:77``);
* held-out AP@0.5 >= 0.75 after 600 steps (``:173``);
* 3-class mAP@0.5 >= 0.65 and each class >= 0.5 after 700 steps
  (``:266``);
* the scene camera detectable with 400 steps, the cache round trip in
  under 5 s, ``focus_beam`` firing (``:292``);
* the recipe's pool-gather step equals the per-step API: losses at rtol
  1e-5 / atol 1e-6, every leaf within a relative norm of 3e-4 (``:451``);
* the recipe end to end at CI shapes (``:523``) and its CLI;
* checkpoint resume, the next loss within 1e-5
  (``tests/test_checkpoint.py``);
* ``ObjectDetection.train``.

No UDP port."""

import os
import time

import numpy as np
import pytest
import torch

from zybo_rt_sampler_image_detection_torch.fusion.decider import (
    SensorFusionDecider)
from zybo_rt_sampler_image_detection_torch.models import (
    data, detect, runner, train, yolo)
from zybo_rt_sampler_image_detection_torch.models import eval as ev
from zybo_rt_sampler_image_detection_torch.models.tracking import (
    compute_iou)

torch.set_num_threads(2)

AP_GATE = 0.75                    # tests/test_vision.py:189
MAP_GATE, CLASS_AP_GATE = 0.65, 0.5   # :285-288
POOL_LOSS_RTOL, POOL_LOSS_ATOL = 1e-5, 1e-6   # :499
LEAF_RNORM = 3e-4                 # :516
RESUME_ATOL = 1e-5                # tests/test_checkpoint.py:26


def small_cfg(num_classes=2):
    return yolo.YoloConfig(input_size=64, width_mult=0.25,
                           num_classes=num_classes)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree, np.float64)


def test_training_reduces_loss():
    tr = train.Trainer(small_cfg(), learning_rate=3e-3, device="cpu")
    rng = np.random.default_rng(0)
    images = rng.random((4, 64, 64, 3)).astype(np.float32)
    boxes = [np.array([[8.0, 8.0, 40.0, 40.0, 0.0]]) for _ in range(4)]
    losses = [tr.train_step(images, boxes) for _ in range(12)]
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def _trained_detector(num_classes, steps):
    cfg = yolo.YoloConfig(input_size=64, width_mult=0.25,
                          num_classes=num_classes)
    tr = train.Trainer(cfg, learning_rate=3e-3, device="cpu")
    tr.fit(data.synthetic_dataset(0, n_batches=steps, batch_size=8, size=64,
                                  num_classes=num_classes), log_every=0)
    det = detect.YoloDetector(cfg=cfg, device="cpu")
    det.variables = tr.state.variables
    return det


def test_detector_ap_gate():
    """600 steps on the one-class synthetic task, AP@0.5 on a held-out
    set."""
    det = _trained_detector(1, 600)
    rng = np.random.default_rng(999)
    imgs, boxes = data.synthetic_detection_batch(rng, 48, size=64)
    ap = ev.evaluate_detector(det, imgs, boxes)
    assert ap >= AP_GATE, f"AP@0.5 {ap:.3f}"


def test_multiclass_detector_map_gate():
    """700 steps on the 3-class task, per-class AP and mAP@0.5."""
    det = _trained_detector(3, 700)
    rng = np.random.default_rng(999)
    imgs, boxes = data.synthetic_detection_batch(rng, 48, size=64,
                                                 num_classes=3)
    dets = [np.asarray(
        det.get_detections((im * 255).astype(np.uint8),
                           conf_threshold=0.05, include_class=True),
        np.float64).reshape(-1, 6) for im in imgs]
    aps, mAP = ev.per_class_average_precision(dets, boxes, 3)
    assert mAP >= MAP_GATE, f"mAP@0.5 {mAP:.3f} (per class {aps})"
    for c, ap in enumerate(aps):
        assert ap >= CLASS_AP_GATE, f"class {c} AP {ap:.3f}"


def test_scene_camera_detectable(tmp_path):
    """The demo's detectable scene with a detector trained 400 steps by
    ``train.pretrained_demo_detector``: found in most frames, the cache
    loads in under 5 s, ``focus_beam`` steers at the detection."""
    cache = str(tmp_path / "det.pkl")
    det = train.pretrained_demo_detector(cache_path=cache, steps=400,
                                         device="cpu")
    assert os.path.exists(cache)
    cam = data.SceneCamera((240, 320))
    hits, best = 0, None
    for _ in range(6):
        ok, frame = cam.read()
        assert ok and frame.shape == (240, 320, 3)
        gt = cam.last_box
        dets = det.get_detections(frame, conf_threshold=0.3)
        good = [d for d in dets if compute_iou(d[:4], gt) > 0.3]
        if good:
            hits += 1
            best = max(good, key=lambda d: d[4])
    assert hits >= 4, f"detector found the scene object in {hits}/6 frames"
    t0 = time.time()
    again = train.pretrained_demo_detector(cache_path=cache, steps=400,
                                           device="cpu")
    assert time.time() - t0 < 5.0
    for (path, a), (_, b) in zip(_leaves(det.variables),
                                 _leaves(again.variables)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    dec = SensorFusionDecider((320, 240))
    calls = []
    assert dec.focus_beam(lambda h, v: calls.append((h, v)), best) == 0
    assert len(calls) == 1


def test_pool_step_matches_per_step():
    """``train.pool_step`` (the recipe's step: a uint8 pool on the device,
    prebuilt targets, a host-drawn index) against ``train_step`` on the
    same batches in the same order."""
    cfg = small_cfg()
    rng = np.random.default_rng(3)
    P, B = 3, 4
    pool, boxes_all, tms = [], [], []
    for _ in range(P):
        images, boxes = data.synthetic_detection_batch(rng, B, 64,
                                                       num_classes=2)
        pool.append((images * 255.0).astype(np.uint8))
        boxes_all.append(boxes)
        tms.append(train.build_targets(cfg, boxes))
    pool_dev = torch.as_tensor(np.stack(pool))
    targets = [torch.as_tensor(np.stack([tm[h][0] for tm in tms]))
               for h in range(2)]
    masks = [torch.as_tensor(np.stack([tm[h][1] for tm in tms]))
             for h in range(2)]
    idxs = [0, 2, 1, 0, 1]

    tr_pool = train.Trainer(cfg, learning_rate=3e-3, seed=11, device="cpu")
    losses = [float(train.pool_step(tr_pool, pool_dev, targets, masks, i))
              for i in idxs]
    tr_ref = train.Trainer(cfg, learning_rate=3e-3, seed=11, device="cpu")
    ref = [tr_ref.train_step(pool[i].astype(np.float32) / 255.0,
                             boxes_all[i]) for i in idxs]
    np.testing.assert_allclose(losses, ref, rtol=POOL_LOSS_RTOL,
                               atol=POOL_LOSS_ATOL)
    assert tr_pool.state.step == tr_ref.state.step == len(idxs)
    for (path, a), (_, b) in zip(_leaves(tr_pool.state.variables),
                                 _leaves(tr_ref.state.variables)):
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
        assert err < LEAF_RNORM, (path, err)


def test_reference_recipe_smoke(tmp_path):
    """``train_reference_recipe`` end to end at CI shapes: pool build,
    chunks, throughput, held-out batched mAP, weights save, report."""
    out = str(tmp_path / "w.pkl")
    lines = []
    rep = train.train_reference_recipe(
        steps=10, batch_size=4, size=64, width=0.25, num_classes=2,
        pool_batches=4, chunk_steps=4, eval_images=8, map_gate=0.0,
        weights_out=out, progress=lines.append, device="cpu")
    assert rep["gate_ok"] and rep["steps"] == 10
    assert rep["steps_per_s"] is None or rep["steps_per_s"] > 0
    assert rep["imgs_per_s"] == pytest.approx(rep["steps_per_s"] * 4,
                                              rel=0.01)
    assert len(rep["aps"]) == 2 and rep["backend"] == "cpu"
    assert np.isfinite(rep["final_loss"])
    assert sum("steps/s" in ln for ln in lines) == 3      # 4 + 4 + 2
    det = detect.YoloDetector(model_path=out, cfg=small_cfg(), device="cpu")
    assert det.get_detections(np.zeros((64, 64, 3), np.uint8)) is not None


def test_recipe_cli_exit_code(tmp_path, capsys):
    """``python -m ...models.train`` prints the report and exits 1 when the
    mAP gate fails, 0 when it holds."""
    import json

    argv = ["--steps", "2", "--batch", "2", "--size", "64", "--width",
            "0.25", "--classes", "1", "--pool", "2", "--chunk", "2",
            "--eval-images", "2", "--device", "cpu"]
    with pytest.raises(SystemExit) as hit:
        train.main(argv + ["--gate", "1.01"])
    assert hit.value.code == 1
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not rep["gate_ok"] and rep["map_gate"] == 1.01
    with pytest.raises(SystemExit) as hit:
        train.main(argv + ["--gate", "0", "--out", str(tmp_path / "w.pkl")])
    assert hit.value.code == 0
    assert os.path.exists(tmp_path / "w.pkl")


def test_checkpoint_resume(tmp_path):
    cfg = yolo.YoloConfig(input_size=64, width_mult=0.25)
    tr = train.Trainer(cfg, device="cpu")
    rng = np.random.default_rng(0)
    imgs = rng.random((2, 64, 64, 3)).astype(np.float32)
    boxes = [np.array([[8.0, 8.0, 40.0, 40.0, 0.0]])] * 2
    tr.train_step(imgs, boxes)

    p = str(tmp_path / "ckpt")
    train.save_checkpoint(p, tr)
    tr2 = train.Trainer(cfg, seed=1, device="cpu")
    train.restore_checkpoint(p, tr2)
    assert tr2.state.step == 1
    la = tr.train_step(imgs, boxes)
    lb = tr2.train_step(imgs, boxes)
    assert abs(la - lb) < RESUME_ATOL


def test_object_detection_train():
    """``ObjectDetection.train`` fine-tunes the runner's detector in place
    from its current weights, and the loss falls."""
    od = runner.ObjectDetection(cfg=small_cfg(1), device="cpu")
    before = od.detector.variables
    losses = od.train(data.synthetic_dataset(2, n_batches=12, batch_size=4,
                                             size=64), learning_rate=3e-3)
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    after = od.detector.variables
    moved = [np.abs(a - b).max() for (_, a), (_, b)
             in zip(_leaves(after), _leaves(before))]
    assert max(moved) > 0
    assert od.run_inference(np.zeros((64, 64, 3), np.uint8)) is not None


def test_demo_detector_corrupt_cache_retrains(tmp_path):
    """A cache that does not unpickle is trained over, then loads."""
    cache = tmp_path / "det.pkl"
    cache.write_bytes(b"not a pickle")
    det = train.pretrained_demo_detector(cache_path=str(cache), steps=2,
                                         device="cpu")
    again = detect.load_weights(str(cache))
    for (path, a), (_, b) in zip(_leaves(det.variables), _leaves(again)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
