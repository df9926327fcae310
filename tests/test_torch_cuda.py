"""The fused equiv-power CUDA kernel against its plain torch version, on
the card.  Every test is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False (the kernel has no CPU mode).

This file imports neither JAX nor the test conftest's helpers, so it also
runs on a machine with the card and no JAX::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from zybo_rt_sampler_image_detection_torch import Config
from zybo_rt_sampler_image_detection_torch.apps import pipeline
from zybo_rt_sampler_image_detection_torch.ops import beamform as tb
from zybo_rt_sampler_image_detection_torch.ops import equiv_kernel as tk

pytestmark = pytest.mark.cuda

# max cellwise relative error against the plain version, per mode (the JAX
# package's gates for the kernel: test_equiv_kernel.py:26,62,71)
TOL = {"f32": 2e-6, "high": 5e-5, "bf16": 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _frames(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, cfg.n_microphones, cfg.n_samples))
            * 0.1).astype(np.float32)


def _run(fused, x):
    S, sj, bt = fused.kernel_inputs(x)
    kw = dict(n_tail=fused.n_tail, Tc=fused.Tc, inv=fused.inv)
    args = (S, fused.H1, fused.H2, fused.ib1, fused.ib2, sj, fused.Wc3)
    before = tk.equiv_power.launches
    got = tk.equiv_power(*args, block_b=bt, **kw)
    torch.cuda.synchronize()
    assert tk.equiv_power.launches == before + 1
    return got, tk.equiv_power_plain(*args, **kw)


@pytest.mark.parametrize("mode", ["f32", "high", "bf16"])
@pytest.mark.parametrize("algorithm", ["lerp", "hybrid", "convolve"])
@pytest.mark.parametrize("B", [1, 2, 3, 11])
def test_kernel_matches_plain_tiny(cuda, mode, algorithm, B):
    cfg = Config.tiny()
    t = tb.make_tables(cfg, algorithm, cache=False, device=cuda)
    fused = tk.FusedEquivBeamformer(t, mode=mode)
    got, ref = _run(fused, torch.from_numpy(_frames(cfg, B)).to(cuda))
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=TOL[mode], atol=1e-14)


@pytest.mark.parametrize("algorithm", ["lerp", "hybrid"])
def test_kernel_matches_plain_reference_shape(cuda, algorithm):
    cfg = Config()
    t = tb.make_tables(cfg, algorithm, device=cuda)
    fused = tk.FusedEquivBeamformer(t, mode="f32")
    x = torch.from_numpy(_frames(cfg, 5) * 0.5).to(cuda)
    got, ref = _run(fused, x)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=TOL["f32"], atol=1e-14)
    power = fused(x)
    exact = tb.steered_power(x, t)
    np.testing.assert_allclose(power.cpu().numpy(), exact.cpu().numpy(),
                               rtol=1e-4, atol=1e-14)


def test_wrapper_rejects_bad_inputs(cuda):
    t = tb.make_tables(Config.tiny(), "lerp", cache=False, device=cuda)
    fused = tk.FusedEquivBeamformer(t, mode="f32")
    S, sj, bt = fused.kernel_inputs(torch.zeros(3, 16, 64, device=cuda))
    kw = dict(n_tail=fused.n_tail, Tc=fused.Tc, inv=fused.inv)
    with pytest.raises(ValueError, match="dtype"):
        tk.equiv_power(S.double(), fused.H1, fused.H2, fused.ib1, fused.ib2,
                       sj, fused.Wc3, block_b=bt, **kw)
    with pytest.raises(ValueError, match="block_b"):
        tk.equiv_power(S, fused.H1, fused.H2, fused.ib1, fused.ib2, sj,
                       fused.Wc3, block_b=8, **kw)
    with pytest.raises(ValueError, match="device"):
        tk.equiv_power(S, fused.H1.cpu(), fused.H2, fused.ib1, fused.ib2,
                       sj, fused.Wc3, block_b=bt, **kw)


def test_auto_policy_picks_kernel_at_high(cuda):
    t = tb.make_tables(Config().replace(matmul_precision="high"), "lerp",
                       device=cuda)
    kind, obj = pipeline._select_power_backend(t)
    assert kind == "equiv_kernel" and obj.mode == "high"
