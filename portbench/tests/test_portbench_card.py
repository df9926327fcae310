"""On the card only (marker ``cuda``; skips elsewhere): the control, the
configuration's lower precision in the program's place, comes out not
correct at a cell's own size, and the same run at the stated precision
comes out correct.  Run on the card with
``python -m pytest -m cuda portbench/tests``."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _run(workload, seed, control):
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", "2", "--trace", "0",
         "--control", str(control)], cwd=ROOT, capture_output=True,
        text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["cfgjson.replay", "onboard64.replay"])
def test_control_fails_and_program_passes(card, workload):
    assert _run(workload, 2 ** 31 + 101, control=1)["correct"] is False
    assert _run(workload, 2 ** 31 + 102, control=0)["correct"] is True
