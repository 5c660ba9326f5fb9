"""Kernel K1 (``csrc/fast.cu``, device function ``fast_score_nms_kernel``):
the least time its launches in the traced segment need, from their shapes
(``work.k1_detect_frame``), over their device time in the profiler's trace.
None where the segment launched none, or the tracer kept another number of
its events than the program's counter launched."""
from . import work

KERNEL = "fast_score_nms"


def read(run):
    t = run.trace
    if not t:
        return None
    n = t["kernel_launches"].get(KERNEL, 0)
    ms = t["kernel_ms"].get(KERNEL, [])
    tp, img = run.config["tracker"], run.config["image"]
    per = work.k1_detect_frame(run.agents, img["height"], img["width"], tp["pyramid_depth"],
                               tp["n_tiles_h"], tp["n_tiles_w"])
    if n == 0 or len(ms) != n or n % len(per):
        return None
    least = n // len(per) * sum(work.least_s(*fw) for fw in per)
    return 100.0 * least / (sum(ms) / 1e3)
