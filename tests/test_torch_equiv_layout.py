"""The equiv kernels' inputs on the CPU: the one response plane, the sparse
head-correction list, and ``FusedEquivBeamformer`` in both sweeps against
the JAX package's gates.

* The one-plane product (the 2B rows ``[sr | si]``, ``[si | -sr]`` times
  ``H1 = [Hr | -Hi]``) against the two-plane Br/Bi of the first kernel
  (``[Hr | -Hi]`` and ``[Hi | Hr]``), in float64 on integer-valued data,
  where every product and sum is exact: equal bit for bit.
* The sparse list against the JAX package's dense ``Wc3`` (every nonzero,
  nothing else), and its ``v`` against the dense ``einsum`` at 1e-6
  (FP32) and 1e-12 (float64).
* ``FusedEquivBeamformer`` (the plain versions on the CPU) at the JAX
  gates (``test_equiv_kernel.py:26,62,71``): f32 2e-6 against the JAX
  kernel in interpret mode, high 5e-5 against ``steered_power``, bf16 3e-2
  with the peak equal, for every algorithm, in both sweeps."""

import os

import numpy as np
import pytest
import torch

from zybo_rt_sampler_image_detection_tpu.ops import beamform as jb
from zybo_rt_sampler_image_detection_tpu.ops import equiv_kernel as jk
from zybo_rt_sampler_image_detection_torch.ops import beamform as tb
from zybo_rt_sampler_image_detection_torch.ops import equiv_kernel as tk
from zybo_rt_sampler_image_detection_torch.ops import freq_equiv as tf

from conftest import synth_frame

torch.set_num_threads(2)

ALGORITHMS = ("pad", "lerp", "convolve", "hybrid", "truncated")
TOL = {"f32": 2e-6, "high": 5e-5, "bf16": 3e-2}


def _port(jt):
    """The JAX package's tables carried into the port, on the CPU."""
    return tb.SteeringTables.from_numpy(
        np.asarray(jt.W), None if jt.Wc is None else np.asarray(jt.Wc),
        np.asarray(jt.adaptive), tau_min=jt.tau_min, corr_js=jt.corr_js,
        precision=jt.precision, n_samples=jt.n_samples, res_x=jt.res_x,
        res_y=jt.res_y, algorithm=jt.algorithm, device="cpu")


def _np(x):
    return x.double().cpu().numpy()


@pytest.mark.parametrize("shape", [(37, 3, 16, 63), (41, 5, 14, 40),
                                   (9, 1, 64, 16)],
                         ids=["lerp-tiny", "odd-mics", "wide-k"])
@pytest.mark.parametrize("td", [8, 16])
def test_one_plane_product_equals_two_planes(shape, td):
    """The kernels' one-plane product equals the two-plane Br/Bi exactly
    (float64, integer-valued spectra and response: no rounding)."""
    F, B, M, D = shape
    rng = np.random.default_rng(F * M + td)

    def ints(*s):
        return torch.from_numpy(rng.integers(-8, 9, s).astype(np.float64))

    H = torch.complex(ints(D, M, F), ints(D, M, F))               # (D, M, F)
    spec = torch.complex(ints(F, B, M), ints(F, B, M))            # (F, B, M)
    KP = -(-2 * M // tk.K_ALIGN) * tk.K_ALIGN
    DP = -(-D // tk.D_ALIGN) * tk.D_ALIGN
    H1 = tk.make_plane(H, torch.ones(F, dtype=torch.float64), KP, DP, F, td)
    S = tk.make_spectra(spec, F, B, KP, KP + 4)
    assert H1.shape == (DP // td, F, KP, td) and S.dtype == torch.float64
    P = torch.bmm(tk.spectra_rows(S, KP), tk.dense_plane(H1))     # (F, 2B, DP)
    # the first kernel's two planes and rows: s = [sr | si] over 2M
    Hr, Hi = H.real.permute(2, 1, 0), H.imag.permute(2, 1, 0)    # (F, M, D)
    s2 = torch.cat([spec.real, spec.imag], dim=2)                 # (F, B, 2M)
    Br = torch.bmm(s2, torch.cat([Hr, -Hi], dim=1))
    Bi = torch.bmm(s2, torch.cat([Hi, Hr], dim=1))
    assert torch.equal(P[:, :B, :D], Br) and torch.equal(P[:, B:, :D], Bi)
    assert not P[:, :, D:].any()
    # and the complex product itself
    Bc = torch.einsum("dmf,fbm->fbd", H, spec)
    assert torch.equal(Br, Bc.real) and torch.equal(Bi, Bc.imag)


def test_fused_plane_is_the_one_plane(tiny_cfg):
    """The class's H1 is sqrt(cf) * [Hr | -Hi] of its tables, FP32, and no
    second plane or dense Wc3 is held."""
    t = tb.make_tables(tiny_cfg, "hybrid", cache=False, device="cpu")
    et = tf.make_equiv_tables(t)
    fused = tk.FusedEquivBeamformer(et, mode="f32")
    assert not hasattr(fused, "H2") and not hasattr(fused, "Wc3")
    dense = tk.dense_plane(fused.H1)                              # (FP, KP, DP)
    scf = torch.sqrt(et.cf.double()).float()
    D, M, F = et.H.shape
    np.testing.assert_array_equal(
        dense[:F, :M, :D].numpy(),
        (et.H.real * scf).permute(2, 1, 0).numpy())
    np.testing.assert_array_equal(
        dense[:F, fused.MP:fused.MP + M, :D].numpy(),
        (-et.H.imag * scf).permute(2, 1, 0).numpy())
    assert fused.table_bytes == sum(
        x.numel() * x.element_size()
        for x in (fused.H1, fused.ib1, fused.ib2, *fused.wc))


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_list_holds_every_nonzero_of_wc(tiny_cfg, algorithm):
    """Every nonzero of the JAX package's dense Wc3 is in the list, at its
    (d, c) row and sj column, and the list holds nothing else."""
    jt = jb.make_tables(tiny_cfg, algorithm, cache=False)
    jf = jk.FusedEquivBeamformer(jt, mode="f32")
    fused = tk.FusedEquivBeamformer(_port(jt), mode="f32")
    if fused.Tc == 0:
        assert fused.wc is None and jf.kt.Wc3 is None
        return
    JM, Tc, D, DP = fused.JM, fused.Tc, fused.D, fused.DP
    w3 = np.asarray(jf.kt.Wc3)[:JM, :Tc, :D]                      # (JM, Tc, D)
    wc = fused.wc
    ptr, idx, val = (x.numpy() for x in wc)
    assert ptr.shape == (DP * Tc + 1,) and ptr[0] == 0
    assert (np.diff(ptr) >= 0).all() and ptr[-1] == len(idx) == len(val)
    assert (val != 0).all()
    rebuilt = np.zeros((JM, Tc, DP), np.float32)
    for r in range(DP * Tc):
        d, c = divmod(r, Tc)
        cols = idx[ptr[r]:ptr[r + 1]]
        assert (np.diff(cols) > 0).all()                          # in order
        rebuilt[cols, c, d] = val[ptr[r]:ptr[r + 1]]
    np.testing.assert_array_equal(rebuilt[:, :, :D], w3)
    assert not rebuilt[:, :, D:].any()
    assert len(val) == np.count_nonzero(w3)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("algorithm", ("lerp", "hybrid"))
def test_list_v_equals_dense_einsum(tiny_cfg, rng, algorithm, B, dtype, tol):
    """v from the sparse list equals the dense head-correction einsum of
    the first kernel's plain version (``bj,jcd->cbd`` over Wc3); lerp and
    hybrid are the algorithms with head corrections."""
    t = tb.make_tables(tiny_cfg, algorithm, cache=False, device="cpu")
    fused = tk.FusedEquivBeamformer(t, mode="f32")
    frames = torch.from_numpy(
        np.stack([synth_frame(tiny_cfg, rng) for _ in range(B)]))
    _, sj, _ = fused.kernel_inputs(frames)
    J, D, Tc, M = t.Wc.shape
    wc3 = torch.zeros(J * M, Tc, fused.DP, dtype=dtype)
    wc3[:, :, :D] = t.Wc.to(dtype).permute(0, 3, 2, 1).reshape(J * M, Tc, D)
    sj = sj.to(dtype)
    ref = torch.einsum("bj,jcd->cbd", sj, wc3)
    got = tk.corrections_plain(sj, fused.wc, Tc, fused.DP)
    assert got.dtype == dtype and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=tol,
                               atol=tol * ref.abs().max().item())


def _fused(t, mode, sweep):
    plan = (8, 3) if sweep == "fd" else None
    fused = tk.FusedEquivBeamformer(t, mode=mode, plan_override=plan,
                                    sweep=sweep)
    assert fused.runs_fd == (sweep == "fd")
    return fused


@pytest.mark.parametrize("sweep", ["df", "fd"])
@pytest.mark.parametrize("mode", ["f32", "high", "bf16"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_fused_meets_jax_gates(tiny_cfg, rng, algorithm, mode, sweep):
    """f32 against the JAX kernel (interpret mode, the same sweep and
    plan) at 2e-6; high against ``steered_power`` at 5e-5; bf16 at 3e-2
    with the peak equal."""
    frames = np.stack([synth_frame(tiny_cfg, rng) for _ in range(3)])
    jt = jb.make_tables(tiny_cfg, algorithm, cache=False)
    got = _np(_fused(_port(jt), mode, sweep)(torch.from_numpy(frames)))
    if mode == "f32":
        kw = dict(plan_override=(8, 3), sweep="fd") if sweep == "fd" else {}
        ref = np.asarray(jk.FusedEquivBeamformer(jt, mode="f32", **kw)(
            frames), np.float64)
    else:
        ref = np.asarray(jb.steered_power(frames, jt), np.float64)
    np.testing.assert_allclose(got, ref, rtol=TOL[mode],
                               atol=1e-10 if mode == "bf16" else 1e-12)
    if mode == "bf16":
        for b in range(len(frames)):
            assert got[b].argmax() == ref[b].argmax()


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    """The kernel library's build key changes with any ``csrc/*.cuh`` the
    source includes (through other headers too), and not with one it does
    not include: an edited shared header never loads a stale binary."""
    from zybo_rt_sampler_image_detection_torch.ops import _build

    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include "core.cuh"\nint k;\n')
    (tmp_path / "core.cuh").write_text('#include "inner.cuh"\nint c;\n')
    (tmp_path / "inner.cuh").write_text("int i;\n")
    (tmp_path / "other.cuh").write_text("int o;\n")
    src = str(tmp_path / "k.cu")
    key = _build._digest(src)
    assert _build._digest(src) == key
    (tmp_path / "other.cuh").write_text("int o2;\n")
    assert _build._digest(src) == key
    (tmp_path / "inner.cuh").write_text("int i2;\n")
    key2 = _build._digest(src)
    assert key2 != key
    (tmp_path / "core.cuh").write_text('#include "inner.cuh"\nint c2;\n')
    assert _build._digest(src) not in (key, key2)
    # the port's two equiv sources include the shared core
    monkeypatch.undo()
    for name in ("equiv_power", "equiv_power_fd"):
        with open(os.path.join(_build._CSRC, f"{name}.cu")) as f:
            assert '#include "equiv_core.cuh"' in f.read()
