"""The frozen roofline counts."""

import pytest

from portbench import roofline
from zybo_rt_sampler_image_detection_torch.config import Config

H100 = "NVIDIA H100 80GB HBM3"


def test_cfgjson_batch_of_16():
    ops, nbytes = roofline.lerp_counts(Config(), 16, 192)
    assert ops == 4 * 192 * 256 * 1824 * 16 == 5_737_807_872
    assert nbytes == 4 * (16 * 192 * 256 + 16 * 1824 + 1824 * 192)
    # bound by the FP32 operations: 0.0857 ms
    assert roofline.lerp_bound_s(Config(), 16, 192, H100) == \
        pytest.approx(ops / 67e12)
    assert roofline.lerp_bound_s(Config(), 16, 192, H100) * 1e3 == \
        pytest.approx(0.08565, rel=1e-3)


def test_onboard64_batch_of_16():
    ops, _ = roofline.lerp_counts(Config.northstar(), 16, 64)
    assert ops == 4 * 64 * 256 * 4225 * 16
    assert roofline.lerp_bound_s(Config.northstar(), 16, 64, H100) * 1e3 \
        == pytest.approx(0.06609, rel=1e-3)


def test_memory_bound_when_work_per_byte_is_small():
    cfg = Config.tiny().replace(max_res_x=1, max_res_y=1)
    ops, nbytes = roofline.lerp_counts(cfg, 1000, 16)
    assert roofline.lerp_bound_s(cfg, 1000, 16, H100) == \
        pytest.approx(nbytes / 3.35e12)


def test_unknown_card_has_no_bound():
    assert roofline.lerp_bound_s(Config(), 16, 192, "some card") is None

