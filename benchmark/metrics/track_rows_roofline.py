"""The filter's track-rows kernel (``csrc/track_rows.cu``, device function
``track_rows_kernel``): the least time its launches in the traced segment
need, from their shapes alone (:func:`frame_work`), over their device time in
the profiler's trace. None where the segment launched none (a program
without the kernel), or the tracer kept another number of its events than
the program's counter launched.

Each filter step launches it once per row builder and IEKF iteration, in
the order MSCKF (the merged stack of MSCKF and short tracks), MSCKF-SLAM
(the new SLAM features), SLAM. A launch's work, counted for every track
slot of its shapes:

  * operations: each track's gate, S = Hw P Hw^T over the columns its rows
    touch, as the product Hw P (2 r c^2 flops for r rows over c columns)
    and the symmetric half of (Hw P) Hw^T (r (r + 1) c flops). A window
    track has r = 2M - 3 rows over its c = 6M pose columns (about 0.5
    MFLOP at M = 15), a SLAM feature 2 rows over its current pose, its
    anchor pose and its own 3 columns (c = 15);
  * bytes: every output written once (the dense rows, the residuals, the
    gate's flags; MSCKF-SLAM's h1, h2 and r1, for which it also reads each
    observation's residual and 2 x 3 blocks), each track's flag read, and
    each agent's touched block of P read once: the 6M x 6M pose block for
    the window launches, the current pose's and the features' columns for
    SLAM (the anchors' pose columns vary with the data).

The time is the larger of the operations over 67 TFLOP/s fp32 and the bytes
over 3.35 TB/s, and the share that time over the device time, never capped.
A track its builder already rejected writes zeros and takes no gate, so a
launch whose slots are nearly all empty does less than this count and could
read above 100 %; the benchmark's fleets keep enough tracks that theirs read
well under it (PERF.md section 6)."""
from . import work

KERNEL = "track_rows"
CORE = 15  # error-state columns before the pose columns
SLAM_COLS = 15  # a SLAM feature's columns: current pose, anchor pose, its own


def gate_flops(rows: int, cols: int) -> float:
    """Flops of one gate's S = H P H^T for ``rows`` rows over ``cols``
    columns: H P, then the symmetric half of (H P) H^T."""
    return float(2 * rows * cols * cols + rows * (rows + 1) * cols)


def window_work(agents: int, tracks: int, m: int, d: int, itemsize: int,
                init: bool) -> tuple:
    """(flops, bytes) a window launch (MSCKF, or MSCKF-SLAM with ``init``)
    over ``agents`` x ``tracks`` tracks of a window of ``m`` poses, the
    state of ``d`` columns, takes."""
    r, c, n = 2 * m - 3, 6 * m, agents * tracks
    reads = n * (1 + ((2 * m * (1 + 3 * 5)) * itemsize + 4 if init else 0))
    reads += agents * c * c * itemsize
    writes = n * ((r * d + r + (3 * d + 9 + 3 if init else 0)) * itemsize + 2)
    return n * gate_flops(r, c), float(reads + writes)


def slam_work(agents: int, features: int, d: int, itemsize: int) -> tuple:
    """(flops, bytes) a SLAM launch takes: 2 rows a feature."""
    n = agents * features
    touched = 6 + 3 * features
    nbytes = n * (1 + (2 * d + 2) * itemsize + 1) + agents * touched * touched * itemsize
    return n * gate_flops(2, SLAM_COLS), float(nbytes)


def frame_work(config: dict, agents: int) -> list:
    """(flops, bytes) of each launch of one filter step of a configuration
    (its ``vio`` section and ``precision``), in launch order."""
    cfg = config["vio"]["cfg"]
    m, n = cfg["dims"]["n_poses"], cfg["dims"]["n_features"]
    tr = cfg["tracks"]
    d = CORE + 6 * m + 3 * n
    size = 8 if config["precision"]["dtype"] == "float64" else 4
    stack = tr["n_msckf"] + (tr["n_short"] if cfg["merge_short_into_stack"] else 0)
    step = [window_work(agents, stack, m, d, size, False),
            window_work(agents, tr["n_new_slam"], m, d, size, True),
            slam_work(agents, n, d, size)]
    return step * cfg["iekf_iter"]


def read(run):
    t = run.trace
    if not t:
        return None
    n = t["kernel_launches"].get(KERNEL, 0)
    ms = t["kernel_ms"].get(KERNEL, [])
    per = frame_work(run.config, run.agents)
    if n == 0 or len(ms) != n or n % len(per):
        return None
    least = n // len(per) * sum(work.least_s(*fw) for fw in per)
    return 100.0 * least / (sum(ms) / 1e3)
