"""On the card only (marker ``cuda``; skips elsewhere): ``cfgjson_fine``,
the upstream camera on a 228x128 grid, runs the policy's time-domain
kernel, and its program agrees with the float64 reference of
``references/lerp.py`` within the cell's ``map_gap`` limit, while the
bf16 control does not.  Run on the card with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
portbench/tests/test_portbench_fine_card.py``."""

import json
import os

import numpy as np
import pytest

from portbench import harness, signals
from portbench.tests.test_portbench_card import ROOT, card  # noqa: F401

SEED = 2 ** 31 + 211
FRAMES = 32
K = 16
CHANNELS = 192


def _config():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "cfgjson_fine.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def fine():
    """The frames (full and sliced to the connected channels) and the
    reference maps of the cell's configuration."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    config = _config()
    cfg = harness.make_config(config)
    full = signals.frames_f32(cfg, signals.capture(
        cfg, FRAMES, SEED, "cuda")).cpu().numpy()
    ref = harness.load_reference("lerp").maps(cfg, "cuda", full)
    return config, full, ref


def _program(config, control):
    from zybo_rt_sampler_image_detection_torch.apps import pipeline
    from zybo_rt_sampler_image_detection_torch.ops import beamform

    cfg = harness.make_config(config, control=control)
    t = beamform.make_tables(cfg, "lerp", cache=False)
    return pipeline.power_program(t, cfg.n_microphones, CHANNELS)


def _maps(prog, full):
    import torch

    out = [prog(torch.from_numpy(full[i:i + K, :CHANNELS]).cuda())
           for i in range(0, len(full), K)]
    return torch.cat(out).cpu().numpy()


@pytest.mark.cuda
def test_fine_program_runs_k2_and_meets_the_limit(card, fine):  # noqa: F811
    from zybo_rt_sampler_image_detection_torch.ops import fused_kernel

    config, full, ref = fine
    prog = _program(config, control=False)
    k2 = prog.inner
    assert isinstance(k2, fused_kernel.FusedBeamformer)
    assert (k2.D, k2.DP, k2.TK, k2.mode) == (29184, 29184, 3, "high")
    before, mine = fused_kernel.fused_power.launches, k2.launches
    got = _maps(prog, full)
    assert fused_kernel.fused_power.launches - before == FRAMES // K
    assert k2.launches - mine == FRAMES // K
    gap = harness.load_check("map_gap").value(got, ref)
    assert gap <= config["limits"]["map_gap"], gap
    # two runs of the same frames: bit for bit
    np.testing.assert_array_equal(_maps(prog, full), got)


@pytest.mark.cuda
def test_fine_bf16_control_fails_the_limit(card, fine):  # noqa: F811
    from zybo_rt_sampler_image_detection_torch.ops import fused_kernel

    config, full, ref = fine
    prog = _program(config, control=True)
    assert isinstance(prog.inner, fused_kernel.FusedBeamformer)
    assert prog.inner.mode == "bf16"
    gap = harness.load_check("map_gap").value(_maps(prog, full), ref)
    assert gap > config["limits"]["map_gap"], gap
