"""Dry run of the mesh: every sharded path once on ``Config.tiny()``.

The port's counterpart of the JAX package's ``__graft_entry__
.dryrun_multichip``::

    from zybo_rt_sampler_image_detection_torch.parallel import dryrun
    dryrun.dryrun_multichip(4)                                 # every card
    dryrun.dryrun_multichip(4, [torch.device("cuda", 0)] * 4)  # one card
    dryrun.dryrun_multichip(8, [torch.device("cpu")] * 8)      # the CPU
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..models import train
from ..ops import beamform, freq, freq_equiv
from . import mesh as pmesh


def _gate(got: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float,
          what: str) -> None:
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol, atol=atol, err_msg=what)


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> dict:
    """One step of each sharded path over an ``n_devices`` mesh (n_model 2
    when ``n_devices`` is even), each held to its single-device result at
    the JAX package's gates (``tests/test_parallel.py``): (a)
    ``sharded_steered_power``; (b) ``sharded_fused_power`` (K2 a block);
    (c) ``sharded_equiv_power`` and ``sharded_equiv_kernel_power`` (K1 a
    block); the Bartlett map with bins over ``model`` and the streaming
    MVDR map with bins over the whole mesh; (d) ``dryrun_train_step``.
    ``devices`` default: every CUDA device.  Returns the mesh shape and
    the training loss; raises on any mismatch."""
    n_model = 2 if n_devices % 2 == 0 else 1
    n_data = n_devices // n_model
    m = pmesh.make_mesh(n_data, n_model, devices=devices)
    dev = m.first
    cfg = Config.tiny()
    tables = beamform.make_lerp_tables(cfg, device=dev)
    frames = np.random.default_rng(0).standard_normal(
        (n_data * 2, cfg.n_microphones, cfg.n_samples)).astype(np.float32)
    x = torch.as_tensor(frames, device=dev)

    # (a) the exact time-domain map
    st = pmesh.shard_tables(tables, m)
    out = pmesh.sharded_steered_power(m, st)(frames)
    if out.shape != (n_data * 2, cfg.max_res_x, cfg.max_res_y):
        raise RuntimeError(f"sharded map of shape {tuple(out.shape)}")
    _gate(out, beamform.steered_power(x, tables), 1e-6, 1e-12,
          "sharded_steered_power")
    # (b) the time-domain kernel a block
    _gate(pmesh.sharded_fused_power(m, st)(frames), out, 1e-4, 1e-10,
          "sharded_fused_power")
    # (c) the exact frequency-domain path and the equiv kernel a block
    set_ = pmesh.shard_equiv_tables(freq_equiv.make_equiv_tables(tables), m)
    _gate(pmesh.sharded_equiv_power(m, set_)(frames), out, 1e-4, 1e-8,
          "sharded_equiv_power")
    high = beamform.make_tables(cfg.replace(matmul_precision="high"), "lerp",
                                cache=False, device=dev)
    _gate(pmesh.sharded_equiv_kernel_power(m, high)(frames),
          beamform.steered_power(x, high), 5e-5, 1e-8,
          "sharded_equiv_kernel_power")
    # frequency bins: Bartlett over model, MVDR over the whole mesh
    ft = freq.make_freq_tables(cfg, 100.0, device=dev)
    _gate(pmesh.sharded_fft_power(m, ft)(frames),
          freq.fft_steered_power(x, ft), 1e-5, 1e-10, "sharded_fft_power")
    stp, _ = pmesh.shard_freq_tables(ft, m, axes=("data", "model"))
    sp = pmesh.shard_precision_state(freq.init_precision(stp.tables), m)
    sp = pmesh.sharded_update_precision(sp, frames, stp)
    single = freq.update_precision(freq.init_precision(ft), x, ft)
    _gate(pmesh.sharded_mvdr_power_precision(sp, stp),
          freq.mvdr_power_precision(single, ft), 1e-5, 1e-10,
          "sharded_mvdr_power_precision")
    # (d) one data-parallel training step
    loss = train.dryrun_train_step(m)
    return {"mesh": [n_data, n_model], "devices": [str(d) for d in
                                                   m.devices.flat],
            "train_loss": loss}

