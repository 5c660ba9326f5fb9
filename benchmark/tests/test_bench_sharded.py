"""The multi-rank driver (``benchmark/drivers/sharded.py``) rehearsed on the
CPU: the cell ``rcomm-sharded4-exchange`` at a tiny size (4 agents, one a
rank, 96x128 frames, a round every other frame) on 4 gloo ranks, rank 0 in
this process and ranks 1-3 spawned, as on the cards. It holds:

* the gathered records against the single-process round: each recorded
  round's state, database, hits and fused matches equal
  ``collab.request_response_round`` of the same agents from the recorded
  inputs, and the run is ``correct``;
* the whole fleet's state gathered and put back leaves the run ``correct``;
* a rank whose round returns its state unchanged makes the run not
  ``correct``;
* a rank that dies ends the run with an error, well inside the test's own
  time limit (a subprocess, which the driver's watchdog may end);
* a traced run reads the collaboration, filter and tracker layers, and the
  ranks' CPUs (:func:`placement`) do not overlap."""
import os
import subprocess
import sys

import torch

from benchmark.tests.tiny import ROOT, SEED

CELL = "rcomm-sharded4-exchange"
# no timed warm-up: the window starts at a fixed frame (the unchanged-round
# test needs the round in which rank 3's agent fuses a match)
OVERRIDES = {"agents": 4, "trace_frames": 2, "ring_frames": 20, "texture_size": 256,
             "image": {"height": 96, "width": 128},
             "camera": {"fx": 102.4, "fy": 102.4, "cx": 64.0, "cy": 48.0, "s": 0.0,
                        "width": 128, "height": 96},
             "warmup_frames": 4, "warmup_max": 8, "warmup_s": 0, "exchange_every": 2,
             "checks": 2, "timeout_s": 60}


def run(fault=None, seconds: float = 1.5, trace: bool = False, **overrides) -> dict:
    from benchmark.harness import main

    return main.run(CELL, SEED, seconds, trace, device="cpu", overrides={**OVERRIDES, **overrides},
                    fault=fault)


class Keep:
    """A fault that breaks nothing: keeps the fleet for the test."""

    def __call__(self, fleet):
        self.fleet = fleet


class StateRoundTrip:
    """The whole fleet's state gathered and put back before the first frame
    (``Fleet.state`` / ``restore``): the run goes on as if nothing
    happened."""

    def __call__(self, fleet):
        st = fleet.state()
        assert st[1].cov.shape[0] == fleet.agents
        fleet.restore(st)


class RoundUnchanged:
    """Rank ``rank``'s rounds run (their collectives with the others) but
    return the state and database they were given."""

    def __init__(self, rank: int):
        self.rank = rank

    def __call__(self, fleet):
        fleet.on_rank(self.rank, self.on_rank)

    @staticmethod
    def on_rank(rank):
        vocabulary = rank._vocabulary

        def patched(*args):
            vocabulary(*args)
            real = rank.round

            def unchanged(fs, slots, db):
                from benchmark.harness.tree import clone

                fs0, db0 = clone(fs), clone(db)
                _, _, hits, n = real(fs, slots, db)
                return fs0, db0, hits, n

            rank.round = unchanged

        rank._vocabulary = patched


def dies_at_frame_6(rank):
    """Rank's process exits at frame 6 (for ``Fleet.on_rank``)."""
    frame = rank.frame

    def dying(k, record=False):
        if k == 6:
            os._exit(1)
        frame(k, record)

    rank.frame = dying


def test_records_equal_the_single_process_round_and_the_run_is_correct():
    from x_multi_agent_torch.parallel import collab
    from x_multi_agent_torch.utils import tree

    keep = Keep()
    out = run(keep)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0
    fleet = keep.fleet
    rounds = [rec for rec in fleet.judged if "round" in rec]
    assert rounds and fleet.agents == 4 and fleet.fs.cov.shape[0] == 4
    for rec in rounds:
        fs, slots, db = rec["frame"]["fs"], rec["frame"]["slots"], rec["keyframe"]["db"]
        got = (rec["round"]["fs"], rec["round"]["db"], rec["round"]["hits"],
               rec["round"]["n_matches"])
        ref = collab.request_response_round(fleet.params, fleet.ccfg, fleet.words, fs, slots,
                                            db)
        for a, b in zip(tree.leaves(got), tree.leaves(ref)):
            if a.is_floating_point():
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, equal_nan=True)
            else:
                assert torch.equal(a, b)


def test_state_and_restore_leave_the_run_correct():
    out = run(StateRoundTrip())
    assert out["correct"], out["checks"]


def test_a_rank_whose_round_leaves_its_state_is_not_correct():
    # every round of the window judged (a sample time before each): at this
    # seed rank 3's agent fuses a match in the window's second round
    out = run(RoundUnchanged(3), seconds=3.0, checks=50)
    assert not out["correct"]
    assert out["checks"]["exchange_gap"]["value"] > out["checks"]["exchange_gap"]["limit"]


def test_a_dead_rank_ends_the_run_with_an_error():
    code = ("import sys; sys.path.insert(0, %r); "
            "from benchmark.tests.test_bench_sharded import run, dies_at_frame_6; "
            "run(lambda fleet: fleet.on_rank(3, dies_at_frame_6))" % str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=100, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode != 0
    assert "sharded driver:" in r.stderr or "Connection closed" in r.stderr, r.stderr[-6000:]


def test_a_traced_run_reads_its_layers():
    out = run(trace=True, warmup_s=0.5)  # and the timed warm-up (its frame count varies)
    assert out["correct"], out["checks"]
    for name in ("exchange_round_ms", "keyframe_ms_per_frame", "filter_ms_per_frame",
                 "tracker_ms_per_frame"):
        assert out["metrics"][name]["value"] > 0, name


def test_each_rank_gets_cpus_of_its_own():
    from benchmark.drivers.sharded import placement

    allowed = os.sched_getaffinity(0)
    cpus = placement(4, cuda=False)
    assert all(c and c <= allowed for c in cpus)
    if sum(map(len, cpus)) <= len(allowed):  # enough cores to split: disjoint
        assert len(set().union(*cpus)) == sum(map(len, cpus))
