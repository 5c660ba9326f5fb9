"""The pyramid kernel's roofline reader on hand-made traces."""
from types import SimpleNamespace

import pytest

from benchmark.tests import tiny  # noqa: F401  (puts the checkout on the path)
from benchmark.metrics import pyramid_level_roofline as reader
from benchmark.metrics import work


def _run(launches, ms, frames=2, agents=64):
    trace = {"frames": frames, "kernel_launches": {"pyramid_level": launches},
             "kernel_ms": {"pyramid_level": ms}}
    config = {"image": {"height": 480, "width": 640}, "tracker": {"lk_max_level": 2}}
    return SimpleNamespace(trace=trace, config=config, agents=agents)


def test_frame_bytes_count_each_output_once():
    # 64 agents at 480x640: two base images read, levels 1-2 of both and the
    # three levels' dx, dy of one written
    assert reader.frame_bytes(64, 480, 640, 2) == 412_876_800
    # 1 agent of 5x7, one more level of 3x4: 2*35 + 2*12 + 2*(35+12) pixels
    assert reader.frame_bytes(1, 5, 7, 1) == 4 * (70 + 24 + 94)


def test_share_is_the_least_over_the_launches_time():
    least_ms = 1e3 * work.least_s(0, 412_876_800)
    run = _run(6, [least_ms / 3] * 6)
    assert reader.read(run) == pytest.approx(100.0)
    assert reader.read(_run(6, [least_ms / 1.5] * 6)) == pytest.approx(50.0)


@pytest.mark.parametrize("launches,ms", [(0, []), (5, [0.1] * 5), (6, [0.1] * 4)])
def test_nothing_to_read(launches, ms):
    assert reader.read(_run(launches, ms)) is None
    assert reader.read(SimpleNamespace(trace=None)) is None
