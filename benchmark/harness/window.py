"""Set-up's warm-up and the measured window: a closed loop of fleet frames.

The fleet's next frame goes in when the frame two before it has finished on
the device (the host waits on that frame's end mark), so the device always
has the next frame queued and the host never runs more than two frames
ahead. A frame's latency is the device time from its start mark to its end
mark: from the start of its frame step to the end of the last work it
triggers (its keyframe step and its round)."""
from __future__ import annotations

import time
from dataclasses import dataclass, field

IN_FLIGHT = 2


def warm_up(fleet, clock, n_min: int, n_max: int, record0: dict) -> int:
    """Run frames 0.. until every program of the frame is built: at least
    ``n_min`` frames, and on the image path until the tracker has captured
    both branches of its detection gate (at most ``n_max`` frames; where the
    fleet's own frames have not taken the branch without detection by then,
    one extra frame that repeats the last image takes it, and the fleet's
    state is put back as it was). Frame 0's stages are cloned into
    ``record0`` (the judge's start). Returns the next frame's index."""
    def branches_missing() -> bool:  # graphs exist on a card only
        return fleet.image and clock.cuda and fleet.tracker_graphs.captured < 3

    k = 0
    while k < n_min or (branches_missing() and k < n_max):
        fleet.frame(k, record0 if k == 0 else None)
        k += 1
    if branches_missing():
        saved, rounds = fleet.state(), list(fleet.rounds)
        image = fleet.ring.frame(k - 1)["image"]
        x = fleet.ring.frame(k)
        fleet.step(fleet.tstate, fleet.fs, fleet.slots, image, x["times"], x["seqs"], x["w_m"],
                   x["a_m"], x["meas_time"])
        fleet.restore(saved)
        fleet.rounds = rounds
    clock.sync()
    return k


@dataclass
class Window:
    first: int  # index of the window's first frame
    frames: int  # fleet frames completed
    seconds: float  # device time from the first frame's start to the last frame's end
    frame_ms: list  # each frame's latency
    records: list = field(default_factory=list)  # the judge's sampled frames


def run(fleet, clock, first: int, seconds: float, sample_at: list) -> Window:
    """Frames ``first``.. for ``seconds`` of the host clock; a frame whose
    turn comes after each time in ``sample_at`` (seconds into the window;
    on a mix with rounds, the next frame with a round) is recorded for the
    judge, its state copied before it (outside its marks)."""
    starts, ends, records = [], [], []
    pending = sorted(sample_at)
    k = first
    clock.sync()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if len(ends) >= IN_FLIGHT:
            clock.wait(ends[-IN_FLIGHT])
        rec = None
        if pending and time.perf_counter() - t0 >= pending[0] and fleet.checkable(k):
            pending.pop(0)
            rec = {"k": k, "before": fleet.state()}
        starts.append(clock.mark())
        fleet.frame(k, rec)
        ends.append(clock.mark())
        if rec is not None:
            records.append(rec)
        k += 1
    clock.sync()
    frame_ms = [clock.ms(a, b) for a, b in zip(starts, ends)]
    return Window(first, len(frame_ms), clock.ms(starts[0], ends[-1]) / 1e3, frame_ms, records)
