"""On the card only (marker ``cuda``; skips elsewhere): in
``cfgjson_mvdr.stream``, the control (TF32 operands in the streaming
Capon program's complex products) comes out not correct, and the same run
at the stated precision (complex64 at true FP32) comes out correct; and
at ``highest`` and ``high`` the route's maps equal, bit for bit, those of
the route whose products pin true FP32 unconditionally, as they did
before the ``default`` rung existed.  Run on the card with
``python -m pytest -m cuda portbench/tests``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench.tests.test_portbench_card import ROOT, card  # noqa: F401


def _run(seed, control):
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "cfgjson_mvdr.stream", "--seed", str(seed), "--seconds", "1",
         "--trace", "0", "--control", str(control)], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _limit():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "cfgjson_mvdr.json")) as f:
        return json.load(f)["limits"]["map_gap"]


@pytest.mark.cuda
def test_mvdr_control_fails_and_program_passes(card):  # noqa: F811
    line = _run(2 ** 31 + 105, control=1)
    assert line["correct"] is False
    assert line["checks"]["map_gap"]["value"] > _limit()
    line = _run(2 ** 31 + 106, control=0)
    assert line["correct"] is True and line["failed"] == 0
    assert line["checks"]["map_gap"]["value"] < _limit() / 4
    per = line["backend"]["mvdr_per_batch"]
    assert per["refreshes"] == pytest.approx(0.25, abs=0.02)
    assert per["quad_forms"] == pytest.approx(0.5, abs=0.02)


class _Pinned:
    """The rung's context as the route had it: true FP32 always."""

    def __init__(self, t):
        pass

    def __enter__(self):
        from zybo_rt_sampler_image_detection_torch.ops import beamform

        beamform.set_fp32_matmul()

    def __exit__(self, *exc):
        return False


def _maps(cfg, frames):
    import torch

    from zybo_rt_sampler_image_detection_torch.apps import pipeline

    fn = pipeline.make_mvdr_stream(cfg, "maps")
    fn.reset()
    out = [fn(torch.from_numpy(frames[i:i + 16]).cuda()).cpu().numpy()
           for i in range(0, len(frames), 16)]
    return np.concatenate(out)


@pytest.mark.cuda
def test_true_fp32_rungs_are_bit_equal_to_the_route_before_the_rung(
        card, monkeypatch):  # noqa: F811
    from portbench import signals
    from zybo_rt_sampler_image_detection_torch.config import Config
    from zybo_rt_sampler_image_detection_torch.ops import freq

    cfg = Config(unused_mics=tuple(range(192, 256)))
    frames = signals.frames_f32(cfg, signals.capture(
        cfg, 160, 2 ** 31 + 107, "cuda")).cpu().numpy()[:, :192]
    got = {p: _maps(cfg.replace(matmul_precision=p), frames)
           for p in ("highest", "high", "default")}
    with monkeypatch.context() as m:
        m.setattr(freq, "_products", _Pinned)
        before = _maps(cfg, frames)
    np.testing.assert_array_equal(got["highest"], before)
    np.testing.assert_array_equal(got["high"], before)
    # the default rung takes TF32 operands: its maps move
    assert np.abs(got["default"] - before).max() > 1e-4 * before.max()
