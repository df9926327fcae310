"""The frozen geometry and the float64 lerp reference against the port's
own tables and eager path on the CPU."""

import numpy as np
import pytest
import torch

from portbench import geometry, harness, signals
from zybo_rt_sampler_image_detection_torch.config import Config
from zybo_rt_sampler_image_detection_torch.ops import beamform
from zybo_rt_sampler_image_detection_torch.ops import geometry as port_geo

lerp = harness.load_reference("lerp")
map_gap = harness.load_check("map_gap").value
CONFIGS = {"tiny": Config.tiny(), "cfgjson": Config(),
           "onboard64": Config.northstar()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_frozen_geometry_equals_the_ports(name):
    cfg = CONFIGS[name]
    act = geometry.active_mics(cfg)
    np.testing.assert_array_equal(act, port_geo.active_microphones(cfg)[0])
    np.testing.assert_allclose(geometry.mic_xy(cfg)[:, act],
                               port_geo.r_prime(cfg), rtol=0, atol=1e-15)
    np.testing.assert_allclose(geometry.sample_delays(cfg),
                               port_geo.calculate_delays(cfg), rtol=1e-12,
                               atol=1e-12)
    w, h = geometry.lerp_taps(cfg)
    pw, ph = port_geo.lerp_coefficients(cfg)
    np.testing.assert_array_equal(w, pw.reshape(w.shape))
    np.testing.assert_array_equal(h, ph.reshape(h.shape))


def _frames(cfg, n, seed):
    return signals.frames_f32(cfg, signals.capture(cfg, n, seed, "cpu"))


def test_reference_matches_the_ports_eager_path():
    cfg = Config.tiny()
    fr = _frames(cfg, 16, 2 ** 31 + 3)
    ref = lerp.maps(cfg, "cpu", fr.numpy(), block=5)
    t = beamform.make_tables(cfg, "lerp", device="cpu", cache=False)
    # FP32 eager path: within float32 rounding of the float64 reference
    p32 = beamform.steered_power(fr, t).numpy()
    assert map_gap(p32, ref) < 1e-6
    # the same path in float64 agrees to the last digits
    t64 = beamform.SteeringTables.from_numpy(
        t.W.double().numpy(), t.Wc.numpy(), t.adaptive.numpy(),
        tau_min=t.tau_min, corr_js=t.corr_js, precision="highest",
        n_samples=t.n_samples, res_x=t.res_x, res_y=t.res_y,
        algorithm="lerp", device="cpu")
    p64 = beamform.steered_power(fr.double(), t64).numpy()
    assert map_gap(p64, ref) < 1e-12


def test_map_gap_is_the_worst_frame_over_its_peak():
    ref = np.ones((2, 3, 3))
    ref[1, 0, 0] = 4.0
    maps = ref.copy()
    maps[1, 2, 2] += 0.2
    assert map_gap(maps, ref) == pytest.approx(0.05)


def test_capture_is_a_function_of_the_seed():
    cfg = Config.tiny()
    a = signals.capture(cfg, 8, 2 ** 33 + 1, "cpu")
    b = signals.capture(cfg, 8, 2 ** 33 + 1, "cpu")
    c = signals.capture(cfg, 8, 2 ** 33 + 2, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (16, 8 * cfg.n_samples) and a.dtype == torch.int32
    assert int(a.abs().max()) <= signals.FULL_SCALE
