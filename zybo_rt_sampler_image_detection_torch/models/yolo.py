"""Tiny-YOLO detector in PyTorch: the port of the JAX package's
``models/yolo.py`` (a flax module there), with a converter that carries its
variables across.

Architecture: a YOLOv3-tiny-shaped anchor-based single-stage detector —
conv/BN/leaky backbone to /32 with a /16 skip, two detection heads with 3
anchors each.  The module computes in NCHW inside, but takes and returns
the flax module's NHWC layout: ``(B, H, W, 3)`` in, heads ``(B, H, W,
A*(5+C))`` out, so that the decode's ``(A, 5+C)`` split and the HWA order
NMS indices refer to are the JAX package's.

bfloat16-friendly: the convs run in ``cfg.dtype``, BatchNorm and the decode
in float32, as in the flax module.  Float32 convs are meant to run at true
FP32 (TF32 off): :func:`fp32_convs` pins that around a forward.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (w, h) anchor priors in pixels of the input resolution, per head
# (coarse /32 head first), COCO-ish tiny-yolo priors.
DEFAULT_ANCHORS = (
    ((81, 82), (135, 169), (344, 319)),     # stride 32
    ((10, 14), (23, 27), (37, 58)),         # stride 16
)

BN_EPS = 1e-5
# flax's BatchNorm momentum 0.97 weighs the old statistics; torch's
# momentum weighs the new batch
BN_MOMENTUM = 1.0 - 0.97
LEAKY_SLOPE = 0.1
N_BLOCKS = 10


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    num_classes: int = 1                    # the reference tracks one class
    input_size: int = 416                   # square input
    width_mult: float = 1.0
    anchors: Tuple[Tuple[Tuple[int, int], ...], ...] = DEFAULT_ANCHORS
    dtype: torch.dtype = torch.float32

    @property
    def strides(self) -> Tuple[int, ...]:
        return (32, 16)

    @property
    def out_per_anchor(self) -> int:
        return 5 + self.num_classes

    def width(self, f: int) -> int:
        return max(8, int(f * self.width_mult))


@contextlib.contextmanager
def fp32_convs():
    """cuDNN convolutions at true FP32 inside the block (TF32 off),
    whatever the process-wide setting: cuDNN's default rounds float32
    operands to TF32 (~1e-3), three orders of magnitude past the heads'
    gate.  (``torch.backends.cudnn.flags`` is not used: its defaults turn
    cuDNN off.)"""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = prev


class ConvBlock(nn.Module):
    """Conv (no bias, "SAME" padding) -> BatchNorm in float32 -> leaky
    ReLU 0.1.

    In training mode the BatchNorm is flax's, not ``nn.BatchNorm2d``'s:
    it normalises with the biased batch variance ``E[y^2] - E[y]^2``, in
    flax's arithmetic (which keeps FP32 runs of the two packages
    closest), and moves the running statistics by ``0.97 * old + 0.03 *
    batch`` with that same biased variance (torch's train mode would
    update ``running_var`` with the unbiased one, n/(n-1) larger).  Eval
    mode is ``nn.BatchNorm2d`` on the running statistics."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(in_ch, features, kernel, padding=kernel // 2,
                              bias=False)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype), self.conv.weight.to(self.dtype),
                     padding=self.conv.padding).float()
        if not self.training:
            return F.leaky_relu(self.bn(y), LEAKY_SLOPE)
        bn = self.bn
        mean = y.mean((0, 2, 3))
        var = ((y * y).mean((0, 2, 3)) - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            bn.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean * BN_MOMENTUM)
            bn.running_var.mul_(1.0 - BN_MOMENTUM).add_(var * BN_MOMENTUM)
        # flax's _normalize: (y - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + BN_EPS) * bn.weight
        y = (y - mean[:, None, None]) * mul[:, None, None] \
            + bn.bias[:, None, None]
        return F.leaky_relu(y, LEAKY_SLOPE)

    def forward_shards(self, xs: list) -> list:
        """The training forward over the row shards of one batch (a tensor
        a data device): each shard's conv on its device against the
        weights moved there, the BatchNorm over the GLOBAL batch — the
        per-shard sums and sums of squares added on the weights' device,
        the biased variance from them — as one device's forward on the
        whole batch computes it, up to the order of the sums."""
        if not self.training:
            raise RuntimeError("forward_shards is the training forward")
        bn = self.bn
        dev0 = bn.weight.device
        ys = [F.conv2d(x.to(self.dtype),
                       self.conv.weight.to(x.device, self.dtype),
                       padding=self.conv.padding).float() for x in xs]
        n = sum(y.numel() // y.shape[1] for y in ys)
        mean = sum(y.sum((0, 2, 3)).to(dev0) for y in ys) / n
        sq = sum((y * y).sum((0, 2, 3)).to(dev0) for y in ys) / n
        var = (sq - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            bn.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean * BN_MOMENTUM)
            bn.running_var.mul_(1.0 - BN_MOMENTUM).add_(var * BN_MOMENTUM)
        mul = torch.rsqrt(var + BN_EPS) * bn.weight
        out = []
        for y in ys:
            d = y.device
            y = (y - mean.to(d)[:, None, None]) * mul.to(d)[:, None, None] \
                + bn.bias.to(d)[:, None, None]
            out.append(F.leaky_relu(y, LEAKY_SLOPE))
        return out


class TinyYolo(nn.Module):
    """Backbone + 2-scale detection heads.

    ``forward`` returns the raw heads: a list of (B, H, W, A*(5+C)), the
    /32 head first.  ``blocks[i]`` is flax's ``ConvBlock_i``, ``head32``
    its ``Conv_0`` and ``head16`` its ``Conv_1`` (creation order)."""

    def __init__(self, cfg: YoloConfig):
        super().__init__()
        self.cfg = cfg
        w, dt = cfg.width, cfg.dtype
        n_out = len(cfg.anchors[0]) * cfg.out_per_anchor
        # (in, out, kernel) of ConvBlock_0..9 in flax's creation order
        spec = [(3, w(16), 3), (w(16), w(32), 3), (w(32), w(64), 3),
                (w(64), w(128), 3), (w(128), w(256), 3),
                (w(256), w(512), 3), (w(512), w(256), 1),
                (w(256), w(512), 3),                      # /32 head branch
                (w(256), w(128), 1),                      # upsample branch
                (w(128) + w(256), w(256), 3)]             # /16 head branch
        self.blocks = nn.ModuleList(ConvBlock(i, o, k, dt)
                                    for i, o, k in spec)
        self.head32 = nn.Conv2d(w(512), n_out, 1)
        self.head16 = nn.Conv2d(w(256), n_out, 1)

    def _head(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        y = F.conv2d(x.to(dt), conv.weight.to(x.device, dt),
                     conv.bias.to(x.device, dt))
        # NCHW -> NHWC before any reshape of the channel axis
        return y.permute(0, 2, 3, 1).contiguous()

    def _graph(self, xs: list, block) -> list:
        """The network over a list of row shards; ``block(i, xs)`` runs
        block i on them.  Returns the two heads, each a list of shards."""
        def each(fn, *shards):
            return [fn(*z) for z in zip(*shards)]

        def pool(x):
            return F.max_pool2d(x, 2, 2)

        xs = each(lambda x: x.permute(0, 3, 1, 2), xs)  # NHWC -> NCHW
        for i in range(4):                              # /1 -> /16
            xs = each(pool, block(i, xs))
        x16 = block(4, xs)
        xs = block(6, block(5, each(pool, x16)))        # /32
        out32 = each(lambda x: self._head(self.head32, x), block(7, xs))
        up = each(lambda x: F.interpolate(x, scale_factor=2, mode="nearest"),
                  block(8, xs))
        out16 = each(lambda x: self._head(self.head16, x),
                     block(9, each(lambda u, s: torch.cat([u, s], dim=1),
                                   up, x16)))
        return [out32, out16]

    def forward(self, x: torch.Tensor) -> list:
        heads = self._graph([x], lambda i, xs: [self.blocks[i](xs[0])])
        return [h[0] for h in heads]

    def forward_shards(self, xs: list) -> list:
        """The training forward of one batch cut into row shards, each on
        its device (:meth:`ConvBlock.forward_shards`: BatchNorm over the
        whole batch).  Returns the heads, each a list of shards."""
        return self._graph(
            xs, lambda i, shards: self.blocks[i].forward_shards(shards))


def decode_head(raw: torch.Tensor, anchors, stride: int, num_classes: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raw head (B, H, W, A*(5+C)) -> (boxes_xyxy (B, HWA, 4),
    obj (B, HWA), cls (B, HWA, C)), in input-image pixels."""
    B, H, W, _ = raw.shape
    A = len(anchors)
    raw = raw.reshape(B, H, W, A, 5 + num_classes).float()
    dev = raw.device
    gy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(
        H, W)
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(
        H, W)
    xy = torch.sigmoid(raw[..., 0:2])
    cx = (xy[..., 0] + gx[None, :, :, None]) * stride
    cy = (xy[..., 1] + gy[None, :, :, None]) * stride
    anchor_w = torch.tensor([a[0] for a in anchors], dtype=torch.float32,
                            device=dev)
    anchor_h = torch.tensor([a[1] for a in anchors], dtype=torch.float32,
                            device=dev)
    bw = torch.exp(raw[..., 2].clamp(-8, 8)) * anchor_w
    bh = torch.exp(raw[..., 3].clamp(-8, 8)) * anchor_h
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                        dim=-1)
    obj = torch.sigmoid(raw[..., 4])
    cls = torch.sigmoid(raw[..., 5:])
    return (boxes.reshape(B, -1, 4), obj.reshape(B, -1),
            cls.reshape(B, -1, num_classes))


def decode_all(cfg: YoloConfig, heads: Sequence[torch.Tensor]):
    """All heads concatenated: (B, N, 4), (B, N), (B, N, C)."""
    parts = [decode_head(raw, anchors, stride, cfg.num_classes)
             for raw, anchors, stride in zip(heads, cfg.anchors,
                                             cfg.strides)]
    return tuple(torch.cat(p, 1) for p in zip(*parts))


def init_params(cfg: YoloConfig, generator: torch.Generator,
                device="cuda") -> TinyYolo:
    """A :class:`TinyYolo` in eval mode on ``device`` (the card unless
    ``device="cpu"``; without a GPU ``"cuda"`` raises), its weights drawn
    on the host from ``generator`` (flax's defaults: LeCun-normal conv
    kernels truncated at two standard deviations, zero head biases,
    BatchNorm at scale 1, bias 0, mean 0, variance 1), so one seed gives
    the same weights on every device."""
    from ..ops.beamform import resolve_device

    device = resolve_device(device)
    model = TinyYolo(cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                # flax's truncated normal keeps the variance 1/fan_in
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return model.to(device).eval()


# -- flax variables <-> state_dict ------------------------------------------

def _block_keys(i: int) -> Dict[str, Tuple[str, ...]]:
    return {
        f"blocks.{i}.conv.weight": ("params", f"ConvBlock_{i}", "Conv_0",
                                    "kernel"),
        f"blocks.{i}.bn.weight": ("params", f"ConvBlock_{i}", "BatchNorm_0",
                                  "scale"),
        f"blocks.{i}.bn.bias": ("params", f"ConvBlock_{i}", "BatchNorm_0",
                                "bias"),
        f"blocks.{i}.bn.running_mean": ("batch_stats", f"ConvBlock_{i}",
                                        "BatchNorm_0", "mean"),
        f"blocks.{i}.bn.running_var": ("batch_stats", f"ConvBlock_{i}",
                                       "BatchNorm_0", "var"),
    }


def _key_map() -> Dict[str, Tuple[str, ...]]:
    keys = {}
    for i in range(N_BLOCKS):
        keys.update(_block_keys(i))
    for name, flax_name in (("head32", "Conv_0"), ("head16", "Conv_1")):
        keys[f"{name}.weight"] = ("params", flax_name, "kernel")
        keys[f"{name}.bias"] = ("params", flax_name, "bias")
    return keys


def variables_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """The JAX package's ``TinyYolo`` variables (nested dicts of arrays:
    ``params`` and ``batch_stats``) as this module's ``state_dict``; conv
    kernels go from HWIO to OIHW."""
    sd = {}
    for key, path in _key_map().items():
        v = variables
        for p in path:
            v = v[p]
        a = np.asarray(v, np.float32)
        if a.ndim == 4:                                 # a conv kernel
            a = a.transpose(3, 2, 0, 1)
        sd[key] = torch.tensor(np.ascontiguousarray(a))
    for i in range(N_BLOCKS):
        sd[f"blocks.{i}.bn.num_batches_tracked"] = torch.tensor(0)
    return sd


def state_dict_to_variables(state_dict) -> dict:
    """The inverse of :func:`variables_to_state_dict`: nested dicts of
    float32 NumPy arrays in the JAX package's layout."""
    out: dict = {}
    for key, path in _key_map().items():
        a = state_dict[key].detach().float().cpu().numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return out
