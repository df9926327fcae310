"""Device mesh for the acoustic pipeline and the detector's training.

The JAX package lays its work out over a ``jax.sharding.Mesh`` from one
process: ``jit`` and ``shard_map`` run one block per device.  The port
keeps that single-controller model: one process holds a (n_data, n_model)
array of ``torch.device`` and issues each block's work to its device.
There is no ``torch.distributed``, no process group and no DTensor.  The
two axes:

* ``data``  — the frame batch (frames are independent);
* ``model`` — the steering-direction axis of the tables, each block
  computing its slice of the map; for the frequency paths, the bin axis,
  each block summing its bins.

Each shard's tables live on the shard's device.  A map is assembled on the
mesh's first device: a ``cat`` over directions for the model axis, a sum
of per-shard partials for the bin axis, and a ``cat`` over the data rows.
The global batch is padded with zero frames to a multiple of the data
axis and sliced back, so no shard pads rows into the assembled output.

:func:`sharded_equiv_kernel_power` launches K1 (``ops/csrc/equiv_power.cu``)
and :func:`sharded_fused_power` K2 (``ops/csrc/time_power.cu``) once per
block on the block's device; the other paths are plain torch.  A block
whose kernel cannot launch raises: nothing falls back to a plain version.
The JAX package's VMEM selector with its quiet XLA-SPMD fallback, and its
full / chunked-T variant choice, were TPU workarounds; the port's
time-domain kernel is one kernel with a K loop, and the direction axis
pads to the port kernels' own tiles (8 directions in FP32, 16 in bf16),
not to the TPU's 128/256.

A mesh may repeat a device: ``make_mesh(4, 2, devices=[torch.device("cpu")]
* 8)`` (the CPU tests), or ``cuda:0`` four times (one card).  Blocks on one
device share its copy of the tables and of the frames.

Ported from ``zybo_rt_sampler_image_detection_tpu/parallel/mesh.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import beamform, freq, freq_equiv
from ..ops.beamform import resolve_device

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: an (n_data, n_model) object array of ``torch.device``
    (``devices.size`` and ``devices.flat`` as on a JAX mesh)."""

    devices: np.ndarray

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.devices.shape))

    @property
    def first(self) -> torch.device:
        """The device a map (and the trainer's master weights) lands on."""
        return self.devices.flat[0]

    def data_devices(self) -> list:
        """Each data row's first device, where its frames are uploaded."""
        return list(self.devices[:, 0])


def _normalize(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every CUDA device;
    without a GPU and without ``devices`` it raises).  ``n_data`` defaults
    to as many rows as the devices fill; the first ``n_data * n_model``
    devices are used, row by row."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: torch.cuda.is_available() is False; pass "
                "devices=[torch.device('cpu')] * n for a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_normalize(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    n = n_data * n_model
    if n_data < 1 or n_model < 1 or n > len(devices):
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n} devices, "
                         f"{len(devices)} given")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(n_data, n_model))


# ---------------------------------------------------------------------------
# Batches and maps
# ---------------------------------------------------------------------------

def _pad_axis(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``x`` with zero rows appended along ``axis`` up to length ``n``."""
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _split_batch(mesh: Mesh, frames) -> tuple:
    """``(rows, B)``: the frames cut into ``n_data`` equal row shards (the
    global batch padded with zero frames) and the true batch.  ``frames``
    is a (B, C, N) array or tensor, or a list of ``n_data`` row shards
    already uploaded (the full-rate stage's)."""
    if isinstance(frames, (list, tuple)):
        if len(frames) != mesh.shape["data"]:
            raise ValueError(f"{len(frames)} row shards for a data axis of "
                             f"{mesh.shape['data']}")
        return list(frames), sum(r.shape[0] for r in frames)
    x = torch.as_tensor(frames)
    B = x.shape[0]
    n_data = mesh.shape["data"]
    b = max(-(-B // n_data), 1)
    x = _pad_axis(x, 0, b * n_data)
    return [x[i * b:(i + 1) * b] for i in range(n_data)], B


def _blocks(mesh: Mesh, rows, block_fn):
    """Yield ``(i, j, block_fn(i, j, x))`` for every block, ``x`` the row
    shard ``i`` on device (i, j), uploaded once a device and row."""
    for i, row in enumerate(rows):
        on = {}
        for j in range(mesh.shape["model"]):
            dev = mesh.devices[i, j]
            if dev not in on:
                on[dev] = row.to(dev)
            yield i, j, block_fn(i, j, on[dev])


def _assemble_dirs(mesh: Mesh, rows, block_fn, d_loc: int, D: int,
                   B: int) -> torch.Tensor:
    """(B, D) on the first device from blocks of (rows, >= d_loc) flat
    maps: directions ``cat`` over model, rows over data."""
    first = mesh.first
    parts = [[] for _ in rows]
    for i, _, out in _blocks(mesh, rows, block_fn):
        parts[i].append(out[:rows[i].shape[0], :d_loc].to(first))
    return torch.cat([torch.cat(p, dim=1) for p in parts])[:B, :D]


def _assemble_bins(mesh: Mesh, rows, block_fn, B: int) -> torch.Tensor:
    """Maps on the first device: each data row's per-block partials
    summed, rows ``cat`` over data."""
    first = mesh.first
    sums = [None] * len(rows)
    for i, _, out in _blocks(mesh, rows, block_fn):
        out = out.to(first)
        sums[i] = out if sums[i] is None else sums[i] + out
    return torch.cat(sums)[:B]


# ---------------------------------------------------------------------------
# Direction sharding: time-domain and exact frequency-domain tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedTables:
    """Tables laid out for a mesh.  ``tables``: the input's tables padded
    with zero directions to ``n_model * d_loc`` (zero power, sliced off).
    ``blocks[i][j]``: the j-th run of ``d_loc`` directions on device (i, j),
    with ``res_x = d_loc`` and ``res_y = 1`` (a block's map is flat).
    ``n_directions``, ``res_x``, ``res_y``: the true grid."""

    mesh: Mesh
    tables: object
    blocks: tuple
    d_loc: int
    n_directions: int
    res_x: int
    res_y: int


def _shard_dirs(t, mesh: Mesh, dir_axes: dict, d_loc: int) -> ShardedTables:
    """``t`` (a tables dataclass) padded to ``n_model * d_loc`` directions
    along ``dir_axes`` (field -> axis) and cut into per-block slices; its
    other tensors are copied to each block's device."""
    n_data, n_model = mesh.devices.shape
    D = t.res_x * t.res_y
    padded = {name: _pad_axis(getattr(t, name), axis, n_model * d_loc)
              for name, axis in dir_axes.items()
              if getattr(t, name) is not None}
    tp = dataclasses.replace(t, **padded)
    tensors = [f.name for f in dataclasses.fields(t)
               if isinstance(getattr(t, f.name), torch.Tensor)
               and f.name not in dir_axes]
    cache = {}
    blocks = []
    for i in range(n_data):
        row = []
        for j in range(n_model):
            dev = mesh.devices[i, j]
            if (dev, j) not in cache:
                fields = {name: x.narrow(dir_axes[name], j * d_loc, d_loc)
                          .contiguous().to(dev)
                          for name, x in padded.items()}
                fields.update({name: getattr(t, name).to(dev)
                               for name in tensors})
                cache[dev, j] = dataclasses.replace(
                    tp, res_x=d_loc, res_y=1, **fields)
            row.append(cache[dev, j])
        blocks.append(tuple(row))
    return ShardedTables(mesh, tp, tuple(blocks), d_loc, D, t.res_x,
                         t.res_y)


def shard_tables(t: beamform.SteeringTables, mesh: Mesh) -> ShardedTables:
    """Lay steering tables out for the mesh: the direction axis of ``W``
    (and of the correction tensor ``Wc``) splits over ``model``,
    zero-padded to a multiple of it; the active-mic index replicates."""
    D = t.res_x * t.res_y
    return _shard_dirs(t, mesh, {"W": 0, "Wc": 1},
                       -(-D // mesh.shape["model"]))


def sharded_steered_power(mesh: Mesh, st: ShardedTables):
    """The exact time-domain heatmap over the mesh (plain torch, the
    ``highest`` rung): frames split over ``data``, directions over
    ``model``.  Returns ``fn(frames (B, channels, N)) -> (B, X, Y)`` on
    the mesh's first device."""
    def block(i, j, x):
        return beamform.steered_power(x, st.blocks[i][j]).flatten(1)

    def run(frames):
        rows, B = _split_batch(mesh, frames)
        flat = _assemble_dirs(mesh, rows, block, st.d_loc, st.n_directions,
                              B)
        return flat.reshape(B, st.res_x, st.res_y)

    return run


def _per_device(mesh: Mesh, st: ShardedTables, make) -> dict:
    """``make(block tables)`` once a (device, model index)."""
    out = {}
    for i in range(mesh.shape["data"]):
        for j in range(mesh.shape["model"]):
            key = (mesh.devices[i, j], j)
            if key not in out:
                out[key] = make(st.blocks[i][j])
    return out


def sharded_fused_power(mesh: Mesh, st: ShardedTables, tile_d: int = 8):
    """The fused time-domain kernel (K2) on every block: each block runs
    ``fused_kernel.fused_power`` on its (data shard of frames) x (model
    shard of directions), on its device; the flat (B, DP) outputs are
    assembled on the first device.  ``st`` comes from
    :func:`shard_tables`; each shard's directions pad to the kernel's
    ``tile_d`` inside its :class:`~..ops.fused_kernel.FusedBeamformer`.

    Returns ``fn(frames) -> (B, X, Y)`` with ``fn.beamformers`` (the
    per-(device, model index) beamformers) and ``fn.plans(B)`` (the
    :class:`~..ops.fused_kernel.Plan` each block launches for a global
    batch of B)."""
    from ..ops import fused_kernel as fk

    beams = _per_device(mesh, st, lambda t: fk.FusedBeamformer(t, tile_d))

    def block(i, j, x):
        fb = beams[mesh.devices[i, j], j]
        s, sj = fb.kernel_inputs(x)
        return fk.fused_power(s, fb.Wp, fb.bases, sj, fb.wc, **fb.kernel_kw)

    def run(frames):
        rows, B = _split_batch(mesh, frames)
        flat = _assemble_dirs(mesh, rows, block, st.d_loc, st.n_directions,
                              B)
        return flat.reshape(B, st.res_x, st.res_y)

    def plans(B: int) -> dict:
        b = max(-(-B // mesh.shape["data"]), 1)
        out = {}
        for (dev, j), fb in beams.items():
            sms = (fk.device_sms(dev.index) if dev.type == "cuda"
                   else fk.SMS)
            out[dev, j] = fk.plan(fb.N, fb.M, fb.TK, fb.DP, b, fb.NL,
                                  fb.Wp.element_size(), fb.JM, fb.Tc, sms)
        return out

    run.beamformers = beams
    run.plans = plans
    return run


def shard_equiv_tables(et: freq_equiv.EquivFreqTables,
                       mesh: Mesh) -> ShardedTables:
    """Lay :class:`~..ops.freq_equiv.EquivFreqTables` out for the mesh: the
    direction axis of the response ``H`` (and of ``Wc``) splits over
    ``model``, zero-padded to a multiple of it (padded directions give
    zero power and are sliced off); the inverse-DFT bases replicate."""
    D = et.res_x * et.res_y
    return _shard_dirs(et, mesh, {"H": 0, "Wc": 1},
                       -(-D // mesh.shape["model"]))


def sharded_equiv_power(mesh: Mesh, set_: ShardedTables):
    """The exact frequency-domain heatmap over the mesh (plain torch, the
    ``high`` rung's exact path): frames over ``data``, directions over
    ``model``, each block through ``freq_equiv.equiv_power_flat``.
    Returns ``fn(frames) -> (B, X, Y)``."""
    def block(i, j, x):
        return freq_equiv.equiv_power_flat(x, set_.blocks[i][j])

    def run(frames):
        rows, B = _split_batch(mesh, frames)
        flat = _assemble_dirs(mesh, rows, block, set_.d_loc,
                              set_.n_directions, B)
        return flat.reshape(B, set_.res_x, set_.res_y)

    return run


def sharded_equiv_kernel_power(mesh: Mesh, t, mode: Optional[str] = None):
    """The fused equiv kernel (K1) on every block: each block runs
    ``equiv_kernel.equiv_power`` on its (data shard of frames) x (model
    shard of the response), on its device.  The direction axis pads so
    that every shard's slice is a whole number of the plane type's
    direction tiles (``equiv_kernel.tile_d``: 8 in FP32, 16 in bf16).

    ``t``: :class:`~..ops.beamform.SteeringTables` or
    :class:`~..ops.freq_equiv.EquivFreqTables`; ``mode`` as
    :class:`~..ops.equiv_kernel.FusedEquivBeamformer`'s.  Returns
    ``fn(frames) -> (B, X, Y)`` with ``fn.beamformers``."""
    from ..ops import equiv_kernel as ek

    et = (t if isinstance(t, freq_equiv.EquivFreqTables)
          else freq_equiv.make_equiv_tables(t))
    plane = (mode or {"high": "high", "highest": "f32"}.get(
        et.precision, "bf16"))
    td = ek.tile_d(torch.bfloat16 if plane == "bf16" else torch.float32)
    D = et.res_x * et.res_y
    d_loc = ek._round_up(-(-D // mesh.shape["model"]), td)
    set_ = _shard_dirs(et, mesh, {"H": 0, "Wc": 1}, d_loc)
    beams = _per_device(mesh, set_,
                        lambda b: ek.FusedEquivBeamformer(b, mode=mode))

    def block(i, j, x):
        fb = beams[mesh.devices[i, j], j]
        S, sj, bt = fb.kernel_inputs(x)
        return ek.equiv_power(S, fb.H1, fb.ib1, fb.ib2, sj, fb.wc,
                              n_tail=fb.n_tail, Tc=fb.Tc, inv=fb.inv,
                              block_b=bt)

    def run(frames):
        rows, B = _split_batch(mesh, frames)
        flat = _assemble_dirs(mesh, rows, block, d_loc, D, B)
        return flat.reshape(B, et.res_x, et.res_y)

    run.beamformers = beams
    return run


# ---------------------------------------------------------------------------
# Frequency-domain sharding: the bin axis is embarrassingly parallel
# ---------------------------------------------------------------------------

def _bin_shards(mesh: Mesh, axes: tuple) -> tuple:
    """``(n_shards, shard(i, j))``: the bin shard block (i, j) holds when
    the bins split over ``axes``."""
    if not axes or any(a not in AXES for a in axes) \
            or list(axes) != sorted(axes, key=AXES.index):
        raise ValueError(f"axes must be an ordered subset of {AXES}, got "
                         f"{axes!r}")
    n_data, n_model = mesh.devices.shape
    if axes == ("data",):
        return n_data, lambda i, j: i
    if axes == ("model",):
        return n_model, lambda i, j: j
    return n_data * n_model, lambda i, j: i * n_model + j


@dataclasses.dataclass(frozen=True)
class ShardedFreqTables:
    """:class:`~..ops.freq.FreqTables` with the bin axis over ``axes``.
    ``tables``: the input's tables with F padded to a multiple of the
    shard count by REPEATING the last bin (a zero-padded bin would make
    its Capon denominator blow up), on the input's device; ``w``: their
    bin weights (1 real, 0 padded).  ``blocks[i][j]``: ``(tables, w)`` of
    the bin shard block (i, j) holds, on its device."""

    mesh: Mesh
    axes: tuple
    tables: freq.FreqTables
    w: torch.Tensor
    blocks: tuple

    def shards(self) -> list:
        """``(tables, w)`` of each bin shard, from the first block holding
        it (where :func:`shard_precision_state` puts its state)."""
        n, shard = _bin_shards(self.mesh, self.axes)
        out = [None] * n
        n_data, n_model = self.mesh.devices.shape
        for i in range(n_data):
            for j in range(n_model):
                k = shard(i, j)
                if out[k] is None:
                    out[k] = self.blocks[i][j]
        return out


def shard_freq_tables(t: freq.FreqTables, mesh: Mesh,
                      axes: Sequence[str] = ("model",)) -> tuple:
    """Lay FFT tables out with the frequency-bin axis over ``axes``.

    Every frequency-domain op (Bartlett, covariance and precision updates,
    the Capon map) is per bin with one final sum over bins, so each block
    runs its bins alone and the maps add up on the first device.  F pads
    to a multiple of the shard count by repeating the last bin; the bin
    weights mask the duplicates out of the sums, through the ``bin_weights``
    arguments of ``freq.fft_steered_power``, ``freq.mvdr_power_precision``
    and ``freq.mvdr_maps_scan``.  Returns ``(ShardedFreqTables, w)``."""
    axes = tuple(axes)
    n, shard = _bin_shards(mesh, axes)
    F = t.phase.shape[0]
    FP = -(-F // n) * n
    dev = t.device
    idx = torch.cat([torch.arange(F, device=dev),
                     torch.full((FP - F,), F - 1, device=dev)])
    bins = (torch.arange(t.lo, t.hi, device=dev) if t.bins is None
            else t.bins)[idx]
    tp = dataclasses.replace(t, phase=t.phase[idx], bins=bins,
                             hi=t.lo + FP)
    w = (torch.arange(FP, device=dev) < F).float()
    Fl = FP // n
    n_data, n_model = mesh.devices.shape
    cache = {}
    blocks = []
    for i in range(n_data):
        row = []
        for j in range(n_model):
            d, k = mesh.devices[i, j], shard(i, j)
            if (d, k) not in cache:
                sl = slice(k * Fl, (k + 1) * Fl)
                cache[d, k] = (dataclasses.replace(
                    tp, phase=tp.phase[sl].to(d), bins=bins[sl].to(d),
                    adaptive=t.adaptive.to(d), lo=t.lo + k * Fl,
                    hi=t.lo + (k + 1) * Fl), w[sl].to(d))
            row.append(cache[d, k])
        blocks.append(tuple(row))
    return ShardedFreqTables(mesh, axes, tp, w, tuple(blocks)), w


def sharded_fft_power(mesh: Mesh, t: freq.FreqTables):
    """The FFT-domain Bartlett heatmap over the mesh: frames over
    ``data``, frequency bins over ``model``; each data row's per-block
    partial maps are summed on the first device.  Returns ``fn(frames
    (B, ch, N)) -> (B, X, Y)``."""
    stp, _ = shard_freq_tables(t, mesh, axes=("model",))

    def block(i, j, x):
        tj, wj = stp.blocks[i][j]
        return freq.fft_steered_power(x, tj, wj)

    def run(frames):
        rows, B = _split_batch(mesh, frames)
        return _assemble_bins(mesh, rows, block, B)

    return run


@dataclasses.dataclass(frozen=True)
class ShardedPrecisionState:
    """A streaming-MVDR state split by bins: ``shards[k]`` the
    :class:`~..ops.freq.PrecisionState` of bin shard k, on the device of
    the first block holding it."""

    shards: tuple


def shard_precision_state(st: freq.PrecisionState, mesh: Mesh,
                          axes: Sequence[str] = ("data", "model")
                          ) -> ShardedPrecisionState:
    """Split a streaming-MVDR state's per-bin matrices over ``axes`` (the
    RLS stream has no frame batch, so by default bins split over the whole
    mesh).  Build the state from tables padded by :func:`shard_freq_tables`
    with the same axes (``init_precision(stp.tables)``)."""
    n, shard = _bin_shards(mesh, tuple(axes))
    F = st.P.shape[0]
    if F % n:
        raise ValueError(f"a state of {F} bins does not split into {n} "
                         f"shards: build it from shard_freq_tables' "
                         f"tables with the same axes")
    Fl = F // n
    devs = [None] * n
    n_data, n_model = mesh.devices.shape
    for i in range(n_data):
        for j in range(n_model):
            k = shard(i, j)
            if devs[k] is None:
                devs[k] = mesh.devices[i, j]
    return ShardedPrecisionState(tuple(
        freq.PrecisionState(
            P=st.P[k * Fl:(k + 1) * Fl].to(d),
            cov=freq.CovarianceState(R=st.cov.R[k * Fl:(k + 1) * Fl].to(d),
                                     count=st.cov.count),
            load=st.load)
        for k, d in enumerate(devs)))


def _state_shards(sp: ShardedPrecisionState, stp: ShardedFreqTables):
    shards = stp.shards()
    if len(shards) != len(sp.shards):
        raise ValueError(f"a state of {len(sp.shards)} shards against "
                         f"tables of {len(shards)}")
    return zip(shards, sp.shards)


def sharded_update_precision(sp: ShardedPrecisionState, frames,
                             stp: ShardedFreqTables, alpha: float = 0.9,
                             block: bool = False) -> ShardedPrecisionState:
    """``freq.update_precision`` (``block=True``: the rank-B
    ``update_precision_block``) on every bin shard, on its device."""
    step = freq.update_precision_block if block else freq.update_precision
    x = torch.as_tensor(frames)
    return ShardedPrecisionState(tuple(
        step(s, x.to(t.device), t, alpha=alpha)
        for (t, _), s in _state_shards(sp, stp)))


def sharded_mvdr_power_precision(sp: ShardedPrecisionState,
                                 stp: ShardedFreqTables,
                                 grid_precision: str = "high"
                                 ) -> torch.Tensor:
    """The Capon map (X, Y) of a sharded state: each shard's
    ``freq.mvdr_power_precision`` over its bins (padded bins weighted 0),
    summed on the mesh's first device."""
    first = stp.mesh.first
    return sum(freq.mvdr_power_precision(s, t, grid_precision, w).to(first)
               for (t, w), s in _state_shards(sp, stp))


def sharded_mvdr_maps_scan(sp: ShardedPrecisionState, frames,
                           stp: ShardedFreqTables, alpha: float = 0.9,
                           grid_precision: str = "high") -> tuple:
    """``freq.mvdr_maps_scan`` on every bin shard: ``(maps (B, X, Y) on
    the first device, the new sharded state)``."""
    first = stp.mesh.first
    x = torch.as_tensor(frames)
    maps, states = None, []
    for (t, w), s in _state_shards(sp, stp):
        m, s2 = freq.mvdr_maps_scan(s, x.to(t.device), t, alpha=alpha,
                                    grid_precision=grid_precision,
                                    bin_weights=w)
        m = m.to(first)
        maps = m if maps is None else maps + m
        states.append(s2)
    return maps, ShardedPrecisionState(tuple(states))
