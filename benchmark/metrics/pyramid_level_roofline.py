"""The tracker's pyramid kernel (``csrc/pyramid.cu``, device function
``pyramid_level_kernel``): the least time the traced frames' pyramids need,
over the device time of the segment's ``pyramid_level`` launches in the
profiler's trace. The least counts what the frame's outputs need, whatever
builds them: per frame the two base images read once, levels 1 .. of both
pyramids and dx, dy of each level of the previous one written once, 4 bytes
a pixel (bytes bound it: the stencils' ~18 operations a written pixel take
about a seventh of the bytes' time). Not capped. None where the segment launched
none, the launches are not a whole number a frame, or the tracer kept
another number of its events than the program's counter launched."""
from . import work

KERNEL = "pyramid_level"


def frame_bytes(agents: int, h: int, w: int, lk_max_level: int) -> int:
    """Bytes one tracker frame's pyramids and gradients need at the least."""
    px = [a * b for a, b in (work.level_shape(h, w, lvl) for lvl in range(lk_max_level + 1))]
    return work.F32 * agents * (2 * px[0] + 2 * sum(px[1:]) + 2 * sum(px))


def read(run):
    t = run.trace
    if not t:
        return None
    n = t["kernel_launches"].get(KERNEL, 0)
    ms = t["kernel_ms"].get(KERNEL, [])
    if n == 0 or len(ms) != n or n % t["frames"]:
        return None
    img = run.config["image"]
    nbytes = frame_bytes(run.agents, img["height"], img["width"],
                         run.config["tracker"]["lk_max_level"])
    return 100.0 * t["frames"] * work.least_s(0.0, nbytes) / (sum(ms) / 1e3)
