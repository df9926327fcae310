"""YOLO detector training in PyTorch: the port of the JAX package's
``models/train.py``.

Replaces the reference's Ultralytics ``model.train`` wrapper
(``image-detection/src/run_object_oriented.py:13-19``) with an explicit
loop: anchor/cell target assignment on the host (NumPy), the loss and an
AdamW step on the device, FP32 convolutions with TF32 off in the forward
and the backward.  The optimiser is optax's ``adamw`` restated for torch:
one parameter group, betas (0.9, 0.999), eps 1e-8 and weight decay 1e-4
on every parameter; the BatchNorm statistics move as flax's do
(``yolo.ConvBlock``).

``python -m zybo_rt_sampler_image_detection_torch.models.train`` runs the
reference-operating-point recipe (:func:`train_reference_recipe`).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.beamform import resolve_device
from ..utils.profiling import annotate
from .yolo import (TinyYolo, YoloConfig, _key_map, fp32_convs, init_params,
                   state_dict_to_variables, variables_to_state_dict)

# optax.adamw's defaults (torch's weight decay defaults to 1e-2)
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
WEIGHT_DECAY = 1e-4
DEMO_CACHE = "~/.cache/zrt_demo_detector_torch.pkl"


@dataclasses.dataclass
class TrainState:
    """The model (its ``state_dict`` is the variables), the optimiser and
    the step count.  ``variables`` reads and sets the weights in the JAX
    package's layout; setting them keeps the optimiser's state."""

    model: TinyYolo
    optimizer: torch.optim.AdamW
    step: int = 0

    @property
    def variables(self) -> dict:
        return state_dict_to_variables(self.model.state_dict())

    @variables.setter
    def variables(self, variables) -> None:
        self.model.load_state_dict(variables_to_state_dict(variables))


def build_targets(cfg: YoloConfig, boxes: Sequence[np.ndarray]):
    """Host-side target assignment: each gt box -> (head, cell, best anchor
    by wh-IoU).  boxes: per-image (n, 5) [x1,y1,x2,y2,cls] in input pixels.
    Returns per-head (target (B,H,W,A,5+C), mask (B,H,W,A))."""
    B = len(boxes)
    out = []
    for anchors, stride in zip(cfg.anchors, cfg.strides):
        g = cfg.input_size // stride
        A = len(anchors)
        t = np.zeros((B, g, g, A, 5 + cfg.num_classes), np.float32)
        m = np.zeros((B, g, g, A), np.float32)
        out.append((t, m))
    aw = [np.array([a[0] for a in h], np.float64) for h in cfg.anchors]
    ah = [np.array([a[1] for a in h], np.float64) for h in cfg.anchors]

    for b, bx in enumerate(boxes):
        for row in np.asarray(bx, np.float64).reshape(-1, 5):
            x1, y1, x2, y2, cls_id = row
            w, h = max(x2 - x1, 1.0), max(y2 - y1, 1.0)
            cx, cy = x1 + w / 2, y1 + h / 2
            # best (head, anchor) by wh IoU
            best = (-1.0, 0, 0)
            for hi in range(len(cfg.anchors)):
                inter = np.minimum(w, aw[hi]) * np.minimum(h, ah[hi])
                union = w * h + aw[hi] * ah[hi] - inter
                iou = inter / union
                ai = int(iou.argmax())
                if iou[ai] > best[0]:
                    best = (float(iou[ai]), hi, ai)
            _, hi, ai = best
            stride = cfg.strides[hi]
            g = cfg.input_size // stride
            gx, gy = min(int(cx / stride), g - 1), min(int(cy / stride), g - 1)
            t, m = out[hi]
            t[b, gy, gx, ai, 0] = cx / stride - gx              # tx target
            t[b, gy, gx, ai, 1] = cy / stride - gy              # ty target
            t[b, gy, gx, ai, 2] = np.log(max(w / aw[hi][ai], 1e-6))
            t[b, gy, gx, ai, 3] = np.log(max(h / ah[hi][ai], 1e-6))
            t[b, gy, gx, ai, 4] = 1.0                           # objectness
            t[b, gy, gx, ai, 5 + int(cls_id)] = 1.0
            m[b, gy, gx, ai] = 1.0
    return out


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor):
    """Elementwise sigmoid binary cross-entropy in optax's form,
    ``-y log(sigmoid(x)) - (1 - y) log(sigmoid(-x))``: its gradient rounds
    as the JAX package's does (``binary_cross_entropy_with_logits``'
    fused gradient differs by up to 2.4e-5 relative on small ones)."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def yolo_loss(cfg: YoloConfig, heads, targets, masks,
              box_w: float = 5.0, obj_w: float = 1.0, cls_w: float = 1.0):
    """Per-head BCE(objectness) + masked MSE(box params) + BCE(class).
    ``heads`` (B, H, W, A*(5+C)) as the model returns them; ``targets``
    and ``masks`` per head from :func:`build_targets`, as tensors."""
    total = 0.0
    A = len(cfg.anchors[0])
    for raw, tgt, m in zip(heads, targets, masks):
        B, H, W, _ = raw.shape
        raw = raw.reshape(B, H, W, A, 5 + cfg.num_classes).float()
        pxy = torch.sigmoid(raw[..., 0:2])
        pwh = raw[..., 2:4]
        npos = m.sum().clamp(min=1.0)
        nneg = (1.0 - m).sum().clamp(min=1.0)
        box_loss = ((m[..., None] * (pxy - tgt[..., 0:2]) ** 2).sum()
                    + (m[..., None] * (pwh - tgt[..., 2:4]) ** 2).sum()
                    ) / npos
        # Objectness is ~60:1 imbalanced (one assigned anchor per target):
        # normalize positives and negatives separately, else the optimum is
        # "predict the base rate" and nothing ever clears the conf threshold.
        obj_bce = _sigmoid_bce(raw[..., 4], tgt[..., 4])
        obj_loss = ((m * obj_bce).sum() / npos
                    + 0.5 * ((1.0 - m) * obj_bce).sum() / nneg)
        cls_loss = (m[..., None] * _sigmoid_bce(
            raw[..., 5:], tgt[..., 5:])).sum() / npos
        total = total + box_w * box_loss + obj_w * obj_loss + cls_w * cls_loss
    return total


class Trainer:
    """``device`` defaults to the card (``"cuda"`` raises without a GPU);
    the weights start from :func:`yolo.init_params` with ``seed``, as the
    detector's do.

    ``mesh`` (``parallel.mesh.Mesh``): data parallel over its ``data``
    axis, with the JAX package's semantics (its ``jit`` with batch
    ``in_shardings`` computes the one-device step on the global batch).
    The weights and the optimiser live on the mesh's first device; each
    step splits the batch over the data devices, runs the forward of each
    row shard on its device with the weights moved there, takes
    BatchNorm's batch statistics over the global batch
    (:meth:`yolo.TinyYolo.forward_shards`), gathers the heads on the
    first device for one loss (``npos`` over the global batch), and the
    gradients reach the one copy of the weights through autograd across
    the moves: one AdamW step a step.  The batch must divide the data
    axis."""

    def __init__(self, cfg: Optional[YoloConfig] = None,
                 learning_rate: float = 1e-3, seed: int = 0,
                 device="cuda", mesh=None):
        self.cfg = cfg or YoloConfig()
        self.mesh = mesh
        if mesh is not None:
            device = mesh.first
        self.device = resolve_device(device)
        model = init_params(self.cfg, torch.Generator().manual_seed(seed),
                            self.device).train()
        optimizer = torch.optim.AdamW(
            model.parameters(), lr=learning_rate, betas=ADAM_BETAS,
            eps=ADAM_EPS, weight_decay=WEIGHT_DECAY)
        self.state = TrainState(model=model, optimizer=optimizer)

    def _step(self, images: torch.Tensor, targets, masks) -> torch.Tensor:
        """One step on device tensors, without a host sync: the forward
        and the backward with FP32 convs (cuDNN reads the TF32 flag when
        the backward runs), then AdamW, each an ``annotate`` range
        (``train/forward``, ``train/backward``, ``train/optimizer``) for
        ``utils.profiling.trace``.  ``images`` may be a list of row shards
        on the mesh's data devices.  Returns the loss tensor."""
        model, opt = self.state.model, self.state.optimizer
        opt.zero_grad(set_to_none=True)
        with fp32_convs():
            with annotate("train/forward"):
                if isinstance(images, list):
                    heads = [torch.cat([h.to(self.device) for h in shards])
                             for shards in model.forward_shards(images)]
                else:
                    heads = model(images)
                loss = yolo_loss(self.cfg, heads, targets, masks)
            with annotate("train/backward"):
                loss.backward()
        with annotate("train/optimizer"):
            opt.step()
        self.state.step += 1
        return loss.detach()

    def train_step(self, images: np.ndarray, boxes: Sequence[np.ndarray]):
        """images: (B, S, S, 3) float32 in [0,1]; boxes: per-image (n, 5)."""
        tm = build_targets(self.cfg, boxes)
        dev = self.device
        targets = tuple(torch.as_tensor(t, device=dev) for t, _ in tm)
        masks = tuple(torch.as_tensor(m, device=dev) for _, m in tm)
        images = torch.as_tensor(np.asarray(images, np.float32))
        if self.mesh is None:
            images = images.to(dev)
        else:
            devs = self.mesh.data_devices()
            if len(images) % len(devs):
                raise ValueError(f"batch ({len(images)}) must divide the "
                                 f"data axis ({len(devs)})")
            images = [r.to(d) for r, d in
                      zip(images.chunk(len(devs)), devs)]
        return float(self._step(images, targets, masks))

    def fit(self, dataset, epochs: int = 1, log_every: int = 10):
        """dataset: iterable of (images, boxes) batches."""
        losses = []
        for _ in range(epochs):
            for i, (images, boxes) in enumerate(dataset):
                loss = self.train_step(images, boxes)
                losses.append(loss)
                if log_every and i % log_every == 0:
                    print(f"step {self.state.step}: loss {loss:.4f}")
        return losses


# -- carrying optimiser state across ----------------------------------------

def _param_paths(model: TinyYolo):
    """(parameter, its path in the JAX ``params`` tree, is a conv kernel)
    in the model's parameter order."""
    keys = _key_map()
    for name, p in model.named_parameters():
        path = keys[name]
        assert path[0] == "params", name
        yield p, path[1:], p.ndim == 4


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def optimizer_state_from_numpy(model: TinyYolo,
                               optimizer: torch.optim.AdamW, count: int,
                               mu, nu) -> None:
    """Set ``optimizer``'s Adam state from optax's ``ScaleByAdamState``
    leaves: ``count`` the step count, ``mu`` / ``nu`` trees of NumPy
    arrays in the JAX package's ``params`` layout (conv kernels HWIO).
    With :func:`yolo.variables_to_state_dict` it carries a JAX
    ``TrainState`` across."""
    for p, path, is_conv in _param_paths(model):
        state = {"step": torch.tensor(float(count))}
        for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
            a = np.asarray(_leaf(tree, path), np.float32)
            if is_conv:
                a = a.transpose(3, 2, 0, 1)
            state[key] = torch.tensor(np.ascontiguousarray(a),
                                      device=p.device)
        optimizer.state[p] = state


def optimizer_state_to_numpy(model: TinyYolo,
                             optimizer: torch.optim.AdamW):
    """The inverse of :func:`optimizer_state_from_numpy`: ``(count, mu,
    nu)`` with ``mu`` / ``nu`` in the JAX ``params`` layout."""
    count, mu, nu = 0, {}, {}
    for p, path, is_conv in _param_paths(model):
        st = optimizer.state.get(p, {})
        count = int(st["step"]) if "step" in st else 0
        for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
            t = st.get(key)
            a = (np.zeros(tuple(p.shape), np.float32) if t is None
                 else t.detach().float().cpu().numpy())
            if is_conv:
                a = a.transpose(2, 3, 1, 0)
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = np.ascontiguousarray(a)
    return count, mu, nu


# -- checkpoints --------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def save_checkpoint(path: str, trainer: Trainer) -> None:
    """``torch.save`` of the variables (the JAX package's layout, as CPU
    tensors), the optimiser's ``state_dict`` and the step: the
    checkpoint/resume capability the reference lacks entirely (SURVEY §5:
    coefficients and weights were recomputed or reloaded ad hoc)."""
    st = trainer.state
    torch.save({"variables": _tree_map(torch.from_numpy, st.variables),
                "optimizer": st.optimizer.state_dict(),
                "step": st.step}, os.path.abspath(path))


def restore_checkpoint(path: str, trainer: Trainer) -> Trainer:
    """Load :func:`save_checkpoint`'s file into ``trainer`` (its model,
    optimiser and step), on the trainer's device."""
    ck = torch.load(os.path.abspath(path), map_location=trainer.device,
                    weights_only=True)
    st = trainer.state
    st.variables = _tree_map(lambda t: t.cpu().numpy(), ck["variables"])
    st.optimizer.load_state_dict(ck["optimizer"])
    st.step = int(ck["step"])
    return trainer


# -- the demo detector and the reference recipe -----------------------------

def pretrained_demo_detector(cache_path: Optional[str] = None,
                             steps: int = 700, size: int = 64,
                             width: float = 0.25, num_classes: int = 1,
                             seed: int = 0, device="cuda"):
    """A tiny-YOLO that actually detects the synthetic task, trained here
    (the reference's deployed weights blob is missing upstream,
    ``image-detection/model/.MISSING_LARGE_BLOBS``) and cached as a
    pickle of the variables in the JAX package's layout.

    Returns a ready ``detect.YoloDetector`` on ``device``.  The cache
    defaults to ``~/.cache/zrt_demo_detector_torch.pkl``, the port's own,
    and is loaded when present, whatever ``steps`` it was trained with;
    delete it to retrain.  ``detect.pretrained_demo_detector`` loads the
    committed weights instead."""
    from . import data
    from .detect import YoloDetector, load_weights, save_weights

    cache = cache_path or os.path.expanduser(DEMO_CACHE)
    cfg = YoloConfig(input_size=size, width_mult=width,
                     num_classes=num_classes)
    det = YoloDetector(cfg=cfg, device=device)
    if os.path.exists(cache):
        try:
            det.variables = load_weights(cache)
            return det
        except (OSError, EOFError, pickle.UnpicklingError, KeyError,
                RuntimeError, ValueError):      # a corrupt cache: retrain
            pass
    trainer = Trainer(cfg, learning_rate=3e-3, seed=seed, device=device)
    trainer.fit(data.synthetic_dataset(seed, steps, batch_size=8,
                                       size=size,
                                       num_classes=num_classes),
                log_every=0)
    det.variables = trainer.state.variables
    cache_dir = os.path.dirname(cache)
    if cache_dir:                 # a bare filename has no dir to create
        os.makedirs(cache_dir, exist_ok=True)
    tmp = cache + ".tmp"
    save_weights(tmp, det.variables)
    os.replace(tmp, cache)
    return det


def pool_step(trainer: Trainer, pool: torch.Tensor, targets, masks,
              i: int) -> torch.Tensor:
    """One step of the recipe: batch ``i`` of the device-resident uint8
    pool (P, B, S, S, 3) and of its prebuilt per-head targets and masks,
    normalised to [0, 1] on the device, through the per-step API's
    :meth:`Trainer._step`.  Returns the loss tensor (no host sync)."""
    return trainer._step(pool[i].float() / 255.0, [t[i] for t in targets],
                         [m[i] for m in masks])


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def train_reference_recipe(steps: int = 3000, batch_size: int = 16,
                           size: int = 416, width: float = 1.0,
                           num_classes: int = 3,
                           learning_rate: float = 1e-3, seed: int = 0,
                           pool_batches: int = 96,
                           chunk_steps: int = 250,
                           eval_images: int = 192,
                           map_gate: float = 0.9,
                           conf_threshold: float = 0.05,
                           weights_out: Optional[str] = None,
                           progress=print, device="cuda") -> dict:
    """Train at the REFERENCE operating point: 416 px, full width,
    multi-class (the reference deployed full Ultralytics at this input
    size, ``image-detection/src/yolo_smooth_tracking.py:9-23``; its
    weights blob is missing upstream so quality is gated on the
    exact-label synthetic task instead: mAP@0.5 >= ``map_gate`` on a
    held-out set).

    The data pool lives on the device as uint8 (one upload) with targets
    built in advance; each step gathers its batch from the pool by a
    host-drawn index (with replacement), normalises u8 -> f32 on the
    device and runs the :class:`Trainer` step the per-step API runs, so
    the two paths cannot drift.  ``chunk_steps`` is the interval of the
    progress line and of the timing: the losses of a chunk come back in
    one download, and the throughput is a full-size chunk after the first
    (warm-up) one, on the host clock around work that ends in a sync.

    Returns a report dict: steps/s and img/s, the final loss, per-class
    AP@0.5 and mAP on the held-out set, the gate verdict, and ``backend``
    (the device's name).
    """
    import time

    from . import data, eval as eval_mod
    from .detect import YoloDetector, save_weights

    cfg = YoloConfig(input_size=size, width_mult=width,
                     num_classes=num_classes)
    trainer = Trainer(cfg, learning_rate=learning_rate, seed=seed,
                      device=device)
    dev = trainer.device
    rng = np.random.default_rng(seed + 1)

    # -- device-resident pool (uint8 images + prebuilt per-head targets)
    t0 = time.perf_counter()
    imgs_np = np.empty((pool_batches, batch_size, size, size, 3),
                       np.uint8)
    tgts_np, msks_np = None, None
    for p in range(pool_batches):
        images, boxes = data.synthetic_detection_batch(
            rng, batch_size, size, num_classes=num_classes)
        imgs_np[p] = (images * 255.0).astype(np.uint8)
        tm = build_targets(cfg, boxes)
        if tgts_np is None:
            tgts_np = [np.empty((pool_batches,) + t.shape, np.float32)
                       for t, _ in tm]
            msks_np = [np.empty((pool_batches,) + m.shape, np.float32)
                       for _, m in tm]
        for hi, (t, m) in enumerate(tm):
            tgts_np[hi][p] = t
            msks_np[hi][p] = m
    gen_s = time.perf_counter() - t0
    progress(f"pool: {pool_batches}x{batch_size} images at {size}px "
             f"generated in {gen_s:.1f}s "
             f"({imgs_np.nbytes / 1e6:.0f} MB)")
    pool = torch.as_tensor(imgs_np, device=dev)
    targets = [torch.as_tensor(t, device=dev) for t in tgts_np]
    masks = [torch.as_tensor(m, device=dev) for m in msks_np]
    del imgs_np, tgts_np, msks_np

    done = 0
    losses_tail = None
    throughput = None
    t_train0 = time.perf_counter()
    while done < steps:
        n = min(chunk_steps, steps - done)
        idxs = rng.integers(0, pool_batches, n)
        t0 = time.perf_counter()
        losses = [pool_step(trainer, pool, targets, masks, i)
                  for i in idxs]
        # one download a chunk; it waits for the chunk's last step
        losses_tail = torch.stack(losses).cpu().numpy()
        dt = time.perf_counter() - t0
        done += n
        # the timed-throughput chunk: the first full-size chunk after the
        # warm-up chunk
        if throughput is None and done > chunk_steps and n == chunk_steps:
            throughput = n / dt
        progress(f"step {done}/{steps}: loss {losses_tail[-1]:.4f} "
                 f"({n / dt:.1f} steps/s)")
    train_s = time.perf_counter() - t_train0

    det = YoloDetector(cfg=cfg, device=dev)
    det.variables = trainer.state.variables
    if weights_out:
        save_weights(weights_out, det.variables)

    # -- held-out eval (fresh seed), batched device inference
    rng_eval = np.random.default_rng(seed + 10_007)
    aps_dets, aps_gts = [], []
    eb = min(32, eval_images)
    for _ in range(-(-eval_images // eb)):
        images, boxes = data.synthetic_detection_batch(
            rng_eval, eb, size, num_classes=num_classes)
        frames = [(im * 255).astype(np.uint8) for im in images]
        dets = det.get_detections_batch(frames, conf_threshold,
                                        include_class=True)
        aps_dets += [np.asarray(d, np.float64).reshape(-1, 6)
                     for d in dets]
        aps_gts += [np.asarray(b, np.float64).reshape(-1, 5)
                    for b in boxes]
    aps, map50 = eval_mod.per_class_average_precision(
        aps_dets, aps_gts, num_classes)
    report = {
        "size": size, "width": width, "num_classes": num_classes,
        "steps": steps, "batch_size": batch_size,
        "train_s": round(train_s, 1),
        "steps_per_s": round(throughput, 2) if throughput else None,
        "imgs_per_s": round(throughput * batch_size, 1)
        if throughput else None,
        "final_loss": round(float(losses_tail[-1]), 4),
        "aps": [round(a, 4) for a in aps],
        "map50": round(map50, 4),
        "map_gate": map_gate,
        "gate_ok": bool(map50 >= map_gate),
        "backend": _device_name(dev),
    }
    progress(f"held-out mAP@0.5 = {map50:.4f} (per-class "
             f"{[f'{a:.3f}' for a in aps]}) gate >= {map_gate}: "
             f"{'OK' if report['gate_ok'] else 'FAIL'}")
    return report


def main(argv=None):
    """CLI for the reference-operating-point recipe:
    ``python -m zybo_rt_sampler_image_detection_torch.models.train``.
    Exits nonzero if the held-out mAP gate fails."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(description=train_reference_recipe.__doc__)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--classes", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pool", type=int, default=96,
                    help="device-resident pool size (batches)")
    ap.add_argument("--chunk", type=int, default=250,
                    help="steps between progress lines and timings")
    ap.add_argument("--eval-images", type=int, default=192)
    ap.add_argument("--gate", type=float, default=0.9)
    ap.add_argument("--out", default="",
                    help="weights .pkl output path")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda raises when no GPU is present)")
    args = ap.parse_args(argv)
    report = train_reference_recipe(
        steps=args.steps, batch_size=args.batch, size=args.size,
        width=args.width, num_classes=args.classes,
        learning_rate=args.lr, seed=args.seed, pool_batches=args.pool,
        chunk_steps=args.chunk, eval_images=args.eval_images,
        map_gate=args.gate, weights_out=args.out or None,
        device=args.device)
    print(json.dumps(report))
    sys.exit(0 if report["gate_ok"] else 1)


def dryrun_train_step(mesh) -> float:
    """One data-parallel training step over ``mesh`` at the demo shape
    (64 px, width 0.25), as the JAX package's dry run takes it; returns the
    loss, which must be finite."""
    cfg = YoloConfig(input_size=64, width_mult=0.25)
    trainer = Trainer(cfg, mesh=mesh)
    B = max(2, mesh.shape["data"]) * 2
    rng = np.random.default_rng(0)
    images = rng.random((B, 64, 64, 3), np.float32)
    boxes = [np.array([[8.0, 8.0, 40.0, 40.0, 0.0]]) for _ in range(B)]
    loss = trainer.train_step(images, boxes)
    if not np.isfinite(loss):
        raise RuntimeError(f"dry-run training step: loss {loss}")
    return loss


if __name__ == "__main__":
    main()
