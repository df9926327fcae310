"""On the card only (marker ``cuda``; skips elsewhere): in
``webfft.replay``, the control (bf16 operands in the Bartlett
contraction) comes out not correct, and the same run at the stated
precision (complex64 at true FP32) comes out correct.  Run on the card
with ``python -m pytest -m cuda portbench/tests``."""

import pytest

from portbench.tests.test_portbench_card import _run, card  # noqa: F401


@pytest.mark.cuda
def test_webfft_control_fails_and_program_passes(card):  # noqa: F811
    line = _run("webfft.replay", 2 ** 31 + 103, control=1)
    assert line["correct"] is False
    assert line["checks"]["map_gap"]["value"] > 1e-4
    line = _run("webfft.replay", 2 ** 31 + 104, control=0)
    assert line["correct"] is True
    assert line["checks"]["map_gap"]["value"] < 1e-5
