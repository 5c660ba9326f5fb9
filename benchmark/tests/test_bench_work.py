"""The work arithmetic of benchmark/metrics/work.py against hand counts."""
import pytest

from benchmark.tests import tiny  # noqa: F401  (puts the checkout on the path)
from benchmark.metrics import work


def test_level_shapes_halve_up():
    assert work.level_shape(480, 640, 0) == (480, 640)
    assert work.level_shape(480, 640, 2) == (120, 160)
    assert work.level_shape(5, 7, 1) == (3, 4)


def test_k1_reads_and_writes_each_pixel_once():
    flops, nbytes = work.k1_work(2, 4, 8)
    assert nbytes == 2 * 4 * 8 * (4 + 4)
    assert flops == 12 * 2 * 4 * 8
    # two detected levels of 480x640 cut to 4x4 tiles: 480x640 and 240x320
    per = work.k1_detect_frame(1, 480, 640, 2, 4, 4)
    assert [b for _, b in per] == [480 * 640 * 8, 240 * 320 * 8]
    # a level of 6x10 cut to 4x4 tiles keeps 4x8
    assert work.k1_detect_frame(1, 6, 10, 1, 4, 4)[0][1] == 4 * 8 * 8


def test_k2_one_gauss_newton_step_per_feature_and_level():
    flops, nbytes = work.k2_work(3, 1, 100, 100, 1)
    win, foot = 9, 16  # 3x3 window, 4x4 bilinear footprint
    assert flops == 3 * win * 39
    assert nbytes == 3 * 4 * foot * 4 + 3 * (8 * 4 + 1)
    # the footprints cannot read more than the four whole images
    _, nbytes = work.k2_work(1000, 1, 10, 10, 1)
    assert nbytes == 4 * 100 * 4 + 1000 * 33
    assert len(work.k2_frame(5, 1, 480, 640, 2, 10)) == 3


def test_least_time_is_the_larger_bound():
    assert work.least_s(67e12, 0) == pytest.approx(1.0)
    assert work.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.least_s(67e12, 6.7e12) == pytest.approx(2.0)


def test_radio_bytes_count_a_vlad_per_pair_and_a_payload_per_hit():
    # 3 agents: 6 ordered pairs of 64-word VLADs, plus 2 hits of 1000 B
    assert work.round_radio_bytes(3, 64, 2, 1000) == 6 * 64 * 32 + 2000
    assert work.round_radio_bytes(1, 64, 0, 1000) == 0

