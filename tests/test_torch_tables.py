"""The port's steering tables equal the JAX package's byte for byte, for
every algorithm at the tiny and the reference shape, and its on-disk cache
stays apart from the JAX package's."""

import os

import numpy as np
import pytest
import torch

import zybo_rt_sampler_image_detection_tpu as zj
from zybo_rt_sampler_image_detection_tpu.ops import beamform as jb
from zybo_rt_sampler_image_detection_torch import Config
from zybo_rt_sampler_image_detection_torch.ops import beamform as tb

torch.set_num_threads(2)

ALGORITHMS = ("pad", "lerp", "convolve", "hybrid", "truncated")


def _cfgs(preset):
    if preset == "tiny":
        return zj.Config.tiny(), Config.tiny()
    return zj.Config(), Config()


def _assert_same(jt, tt):
    assert np.asarray(jt.W).dtype == np.float32
    assert tt.W.dtype == torch.float32
    assert np.array_equal(np.asarray(jt.W), tt.W.numpy())
    assert (jt.Wc is None) == (tt.Wc is None)
    if jt.Wc is not None:
        assert np.array_equal(np.asarray(jt.Wc), tt.Wc.numpy())
    assert np.array_equal(np.asarray(jt.adaptive), tt.adaptive.numpy())
    for f in ("tau_min", "corr_js", "precision", "n_samples", "res_x",
              "res_y", "algorithm"):
        assert getattr(jt, f) == getattr(tt, f), f


@pytest.mark.parametrize("preset", ["tiny", "reference"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_tables_equal_jax_builders(preset, algorithm):
    jcfg, tcfg = _cfgs(preset)
    _assert_same(jb.make_tables(jcfg, algorithm, cache=False),
                 tb.make_tables(tcfg, algorithm, cache=False))


@pytest.mark.parametrize("algorithm", ("lerp", "hybrid"))
def test_from_numpy_carries_jax_tables(algorithm):
    """``SteeringTables.from_numpy`` of the JAX tables equals the port's
    own build (the compute tests feed JAX tables through it)."""
    jt = jb.make_tables(zj.Config.tiny(), algorithm, cache=False)
    tt = tb.SteeringTables.from_numpy(
        np.asarray(jt.W), None if jt.Wc is None else np.asarray(jt.Wc),
        np.asarray(jt.adaptive), tau_min=jt.tau_min, corr_js=jt.corr_js,
        precision=jt.precision, n_samples=jt.n_samples, res_x=jt.res_x,
        res_y=jt.res_y, algorithm=jt.algorithm, device="cpu")
    _assert_same(jt, tt)
    own = tb.make_tables(Config.tiny(), algorithm, cache=False)
    assert torch.equal(own.W, tt.W)


def test_from_numpy_bf16_tables():
    cfg = zj.Config.tiny().replace(matmul_dtype="bfloat16",
                                   matmul_precision="default")
    jt = jb.make_tables(cfg, "lerp", cache=False)
    tt = tb.SteeringTables.from_numpy(
        np.asarray(jt.W), np.asarray(jt.Wc), np.asarray(jt.adaptive),
        tau_min=jt.tau_min, corr_js=jt.corr_js, precision=jt.precision,
        n_samples=jt.n_samples, res_x=jt.res_x, res_y=jt.res_y,
        algorithm=jt.algorithm)
    assert tt.W.dtype == torch.bfloat16
    own = tb.make_tables(Config.tiny().replace(matmul_dtype="bfloat16"),
                         "lerp", cache=False)
    assert torch.equal(own.W, tt.W)
    np.testing.assert_array_equal(np.asarray(jt.W, np.float32),
                                  tt.W.float().numpy())


def test_table_cache_roundtrip_and_names(tmp_path, monkeypatch):
    """The cache serves identical tables, under file names of its own."""
    monkeypatch.setenv("ZRT_TORCH_TABLE_CACHE_DIR", str(tmp_path))
    cfg = Config.tiny()
    built = tb.make_tables(cfg, "hybrid", cache=True)
    names = os.listdir(tmp_path)
    assert len(names) == 1 and names[0].startswith("torch-hybrid-")
    loaded = tb.make_tables(cfg, "hybrid", cache=True)
    assert torch.equal(built.W, loaded.W) and torch.equal(built.Wc, loaded.Wc)
    assert loaded.corr_js == built.corr_js
    assert loaded.tau_min == built.tau_min
    # a corrupt entry falls through to a rebuild
    (tmp_path / names[0]).write_bytes(b"not an npz")
    again = tb.make_tables(cfg, "hybrid", cache=True)
    assert torch.equal(again.W, built.W)


def test_default_cache_dir_is_not_the_jax_one(monkeypatch):
    monkeypatch.delenv("ZRT_TORCH_TABLE_CACHE_DIR", raising=False)
    d = tb._cache_dir()
    assert "zrt_tables" not in d and d.endswith(os.path.join("build",
                                                             "tables"))
