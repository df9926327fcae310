"""The Bartlett kernel's CPU side (``ops/bartlett_kernel.py``): the
steering tensor's tile layout, the frame tile and the limits the wrapper
shares with the kernel's source, the wrapper's checks, the plain version
against the eager route, and the routing rule of
``freq.fft_steered_power``.  The kernel itself runs on the card
(``tests/test_torch_cuda.py -k bartlett``); no UDP, no JAX."""

import os
import re

import numpy as np
import pytest
import torch

from zybo_rt_sampler_image_detection_torch.config import Config
from zybo_rt_sampler_image_detection_torch.ops import bartlett_kernel as bk
from zybo_rt_sampler_image_detection_torch.ops import freq
from zybo_rt_sampler_image_detection_torch.parallel import mesh as pmesh

FFT_GATE = dict(rtol=2e-4, atol=1e-6)           # tests/test_torch_freq.py
# two 4x4 board slots, one connected, in a band above bin 0: the steering
# rows are a strict subset of the frame's channels
# (tests/test_torch_fft_route.py)
SMALL = Config.tiny().replace(
    n_microphones=32, array_slots=2, fft_mic_model="fft",
    camera_offset=0.11, freq_band_low=500.0, freq_band_high=18000.0)
CONFIGS = {"webfft": Config.fft_reference(), "small": SMALL,
           "tiny": Config.tiny()}


def _tables(name):
    """``(cfg, tables, bin_weights)``; "mesh": webfft's tables laid out
    over four bin shards (steering rows repeat the last bin, weights mask
    them)."""
    if name == "mesh":
        cfg = CONFIGS["webfft"]
        t = freq.make_freq_tables(cfg, device="cpu")
        m = pmesh.make_mesh(1, 4, devices=[torch.device("cpu")] * 4)
        stp, w = pmesh.shard_freq_tables(t, m)
        return cfg, stp.tables, w
    cfg = CONFIGS[name]
    return cfg, freq.make_freq_tables(cfg, device="cpu"), None


def _frames(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(
        (B, cfg.n_microphones, cfg.n_samples)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("D", [1, 15, 16, 63, 169, 192, 193, 1824, 4225])
def test_tile_layout_covers_the_directions(D):
    nc, dc = bk.tile_layout(D)
    assert dc % 16 == 0 and dc <= bk.DC_MAX
    assert (nc - 1) * dc < D <= nc * dc


@pytest.mark.parametrize("name", ["webfft", "small", "tiny", "mesh"])
def test_phase_tiles_reproduce_every_entry_and_zero_the_padding(name):
    _, t, _ = _tables(name)
    F, M, D = t.phase.shape
    tiles = t.phase_tiles
    nc, dc = bk.tile_layout(D)
    assert tiles.shape == (nc, F, M, dc) and tiles.is_contiguous()
    flat = tiles.permute(1, 2, 0, 3).reshape(F, M, nc * dc)
    assert torch.equal(flat[..., :D], t.phase)
    assert not flat[..., D:].any()


def test_kernel_indices():
    _, t, _ = _tables("small")
    adaptive, bins, extent = t.kernel_indices
    assert adaptive.dtype == bins.dtype == torch.int32
    assert torch.equal(adaptive.long(), t.adaptive)
    assert torch.equal(bins.long(), torch.arange(t.lo, t.hi))
    assert t.lo > 0 and len(t.adaptive) < SMALL.n_microphones
    assert extent == (int(t.adaptive.max()) + 1, t.hi)
    _, tm, _ = _tables("mesh")
    assert torch.equal(tm.kernel_indices[1].long(), tm.bins)
    assert tm.kernel_indices[2][1] == int(tm.bins.max()) + 1


@pytest.mark.parametrize("B", [1, 5, 16, 37])
@pytest.mark.parametrize("name", ["webfft", "small", "tiny", "mesh"])
def test_plain_version_matches_the_eager_route(name, B):
    """The kernel's plain version, from the kernel's inputs (the rfft of
    the whole batch, the tiles, the int32 rows and bins), against the
    eager complex64 route."""
    cfg, t, w = _tables(name)
    x = _frames(cfg, B, seed=B)
    adaptive, bins, _ = t.kernel_indices
    got = bk.bartlett_power_plain(torch.fft.rfft(x, dim=-1), t.phase_tiles,
                                  adaptive, bins, w, D=t.res_x * t.res_y)
    want = freq.fft_steered_power(x, t, w).reshape(B, -1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FFT_GATE)


@pytest.mark.parametrize("device,dtype,precision,kernel", [
    ("cuda", torch.float32, "highest", True),
    ("cuda", torch.float32, "high", True),
    ("cuda", torch.float32, "default", False),
    ("cuda", torch.float64, "highest", False),
    ("cpu", torch.float32, "highest", False),
    ("cpu", torch.float32, "high", False),
])
def test_routing_rule(device, dtype, precision, kernel):
    assert freq.takes_bartlett_kernel(dtype, device, precision) is kernel


@pytest.mark.parametrize("case", ["cpu", "float64", "default"])
def test_eager_routes_never_take_the_kernel(case, monkeypatch):
    """CPU frames, float64 frames and the ``default`` rung run the eager
    code: the kernel's wrapper is never called."""
    called = []
    monkeypatch.setattr(bk, "bartlett_power",
                        lambda *a, **k: called.append(a))
    cfg = SMALL.replace(matmul_precision="default") if case == "default" \
        else SMALL
    t = freq.make_freq_tables(cfg, device="cpu")
    x = _frames(cfg, 3)
    if case == "float64":
        x = x.double()
    before = freq.fft_steered_power.launches
    out = freq.fft_steered_power(x, t)
    assert out.shape == (3, t.res_x, t.res_y) and not called
    assert freq.fft_steered_power.launches == before + 1


@pytest.mark.parametrize("shape", ["batch", "frame"])
@pytest.mark.parametrize("name", ["small", "mesh"])
def test_kernel_route_plumbing_on_cpu(name, shape, monkeypatch):
    """The kernel route with the rule forced on CPU tensors (the wrapper
    then runs its plain version): one call a batch, handed the rfft of the
    whole frame (no gather, no band copy), the tables' tiles and indices
    and the weights; the maps of the eager route."""
    calls = []
    wrapper = bk.bartlett_power

    def spy(spec, tiles, adaptive, bins, weights=None, **kw):
        calls.append((spec.shape, tiles, weights, kw))
        return wrapper(spec, tiles, adaptive, bins, weights, **kw)

    monkeypatch.setattr(bk, "bartlett_power", spy)
    monkeypatch.setattr(freq, "takes_bartlett_kernel", lambda *a: True)
    cfg, t, w = _tables(name)
    x = _frames(cfg, 4)
    if shape == "frame":
        x = x[0]
    got = freq.fft_steered_power(x, t, w)
    (spec_shape, tiles, weights, kw), = calls
    frames = x[None] if shape == "frame" else x
    assert spec_shape == (len(frames), cfg.n_microphones,
                          cfg.n_samples // 2 + 1)
    assert tiles is t.phase_tiles and kw["D"] == t.res_x * t.res_y
    assert kw["extent"] == t.kernel_indices[2]
    assert (weights is None) == (w is None)
    monkeypatch.setattr(freq, "takes_bartlett_kernel", lambda *a: False)
    want = freq.fft_steered_power(x, t, w)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FFT_GATE)


@pytest.mark.parametrize("B,bt", [(1, 1), (2, 2), (3, 4), (5, 8), (16, 16),
                                  (17, 16), (37, 16)])
def test_frame_tile(B, bt):
    assert bk.frame_tile(B) == bt


@pytest.mark.parametrize("limit", ["frame_tiles", "chunk", "mics"])
def test_the_wrapper_shares_the_kernels_limits(limit):
    """The frame tiles the wrapper picks are the kernel's instantiations,
    and its widest chunk and most mics are the kernel's own checks."""
    src = open(os.path.join(os.path.dirname(bk.__file__), "csrc",
                            "bartlett_power.cu")).read()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (\w+) = (\d+);", src)}
    if limit == "frame_tiles":
        got = tuple(int(n) for n in re.findall(r"ZRT_BT\((\d+)\)", src))
        assert got == bk.FRAME_TILES
    elif limit == "chunk":
        assert "DC > 3 * WD" in src and 3 * const["WD"] == bk.DC_MAX
        assert "DC % 16 != 0" in src and bk.DC_ALIGN == 16
    else:
        assert "M > NQ * MC" in src
        assert const["NQ"] * const["MC"] == bk.MAX_MICS


@pytest.mark.parametrize("short", ["rows", "bins"])
def test_wrapper_refuses_a_spectrum_its_indices_overrun(short):
    """``extent`` is checked before any read: a spectrum with fewer rows
    or bins than the tables reach raises, on every device."""
    _, t, _ = _tables("small")
    adaptive, bins, (rows, nbins) = t.kernel_indices
    C = rows - 1 if short == "rows" else rows
    NF = nbins - 1 if short == "bins" else nbins
    spec = torch.zeros(2, C, NF, dtype=torch.complex64)
    with pytest.raises(ValueError, match="bartlett_power: the tables read"):
        bk.bartlett_power(spec, t.phase_tiles, adaptive, bins,
                          D=t.res_x * t.res_y, extent=(rows, nbins))


@pytest.mark.parametrize("shape", ["batch", "frame"])
@pytest.mark.parametrize("delta", [-2, 2])
@pytest.mark.parametrize("name", ["small", "mesh"])
def test_kernel_route_refuses_frames_of_another_length(name, delta, shape,
                                                       monkeypatch):
    """Frames shorter or longer than the tables' ``n_samples`` raise on
    the kernel route (their rfft bins are other frequencies), before the
    rfft or the wrapper run."""
    called = []
    monkeypatch.setattr(bk, "bartlett_power",
                        lambda *a, **k: called.append(a))
    monkeypatch.setattr(freq, "takes_bartlett_kernel", lambda *a: True)
    cfg, t, w = _tables(name)
    x = torch.zeros(3, cfg.n_microphones, cfg.n_samples + delta)
    with pytest.raises(ValueError, match="samples; the tables are for"):
        freq.fft_steered_power(x if shape == "batch" else x[0], t, w)
    assert not called
