"""Kernel K2 (``csrc/lk.cu``, device function ``lk_level_kernel``): the
least time its launches in the traced segment need, one Gauss-Newton step
per tracked feature and level (``work.k2_frame``, a lower bound on the work,
so the share is a lower bound too), over their device time in the profiler's
trace. None where the segment launched none, or the tracer kept another
number of its events than the program's counter launched."""
from . import work

KERNEL = "lk_level"


def read(run):
    t = run.trace
    if not t:
        return None
    n = t["kernel_launches"].get(KERNEL, 0)
    ms = t["kernel_ms"].get(KERNEL, [])
    tp, img = run.config["tracker"], run.config["image"]
    live = t["live_features"]
    levels = tp["lk_max_level"] + 1
    if n == 0 or len(ms) != n or n != levels * len(live):
        return None
    least = sum(work.least_s(*fw) for f in live
                for fw in work.k2_frame(f, run.agents, img["height"], img["width"],
                                        tp["lk_max_level"], tp["win_half"]))
    return 100.0 * least / (sum(ms) / 1e3)
