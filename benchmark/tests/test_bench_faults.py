"""The judge's teeth, on the CPU at tiny sizes: the rest of a run driven with
the timed path broken underneath must come out not correct, once for each
fault a cell can have (a step that returns its state unchanged, half of the
batch left out, an answer altered where it is produced), and so must the
control (the reference in TF32 in the program's place). One cell has no
exchange between chips, so that fault has no case here."""
import pytest
import torch

from benchmark.tests import tiny
from benchmark.harness.tree import clone, leaves


def unchanged(fn, n_carry):
    """``fn`` that returns its first ``n_carry`` arguments (its state) as
    they came in."""
    def broken(*args, **kwargs):
        kept = clone(args[:n_carry])
        out = fn(*args, **kwargs)
        return (*kept, *out[n_carry:])
    return broken


def half_left_out(fn, n_carry):
    """``fn`` whose state comes back unchanged for the second half of the
    agents."""
    def broken(*args, **kwargs):
        kept = clone(args[:n_carry])
        out = fn(*args, **kwargs)
        for k, o in zip(kept, out[:n_carry]):
            ko = leaves(k)
            for path, x in leaves(o).items():
                x[x.shape[0] // 2:] = ko[path][x.shape[0] // 2:]
        return out
    return broken


def shifted_matches(fn, px):
    """The tracker with every valid match moved by ``px`` pixels."""
    def broken(*args, **kwargs):
        state, matches = fn(*args, **kwargs)
        matches.cur_pt.add_(matches.valid[..., None] * (px / 102.4))
        return state, matches
    return broken


def moved_positions(fn, metres):
    """The filter step with every buffered position moved by ``metres``."""
    def broken(*args, **kwargs):
        fs, slots, applied = fn(*args, **kwargs)
        fs.buffer[..., 2:5] += metres
        return fs, slots, applied
    return broken


def round_hits_flipped(fn):
    """The REQUEST_COMM round that reports every pair's hit the wrong way
    round (at this size a round fuses too little for a state left unchanged
    to show; the full-size readings are in PERF.md)."""
    def broken(*args, **kwargs):
        fs, db, hits, n = fn(*args, **kwargs)
        return fs, db, ~hits, n
    return broken


def _filter(fleet, make):
    if fleet.image:
        fleet.step.step = make(fleet.step.step)
    else:
        fleet.prog = make(fleet.prog)


FAULTS = {
    "filter_unchanged": (lambda fl: _filter(fl, lambda f: unchanged(f, 2)), "filter_gap"),
    "filter_half_left_out": (lambda fl: _filter(fl, lambda f: half_left_out(f, 2)), "filter_gap"),
    "filter_answer_moved": (lambda fl: _filter(fl, lambda f: moved_positions(f, 0.01)),
                            "filter_gap"),
    "tracker_unchanged": (lambda fl: setattr(fl.step, "tracker", unchanged(fl.step.tracker, 1)),
                          "track_off_share"),
    "tracker_half_left_out": (lambda fl: setattr(fl.step, "tracker",
                                                 half_left_out(fl.step.tracker, 1)),
                              "track_off_share"),
    "tracker_answer_moved": (lambda fl: setattr(fl.step, "tracker",
                                                shifted_matches(fl.step.tracker, 0.5)),
                             "track_off_share"),
    "round_hits_flipped": (lambda fl: setattr(fl, "round", round_hits_flipped(fl.round)),
                           "exchange_gap"),
}
CASES = [("flagship-fleet512-matches", f) for f in FAULTS if f.startswith("filter")] + [
    ("flagship-fleet64-image", f) for f in FAULTS if f.startswith(("filter", "tracker"))] + [
    ("rcomm-fleet16-exchange", "round_hits_flipped")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    plant, number = FAULTS[fault]
    out = tiny.run(cell, seconds=2.0, fault=plant)
    assert out["correct"] is False
    c = out["checks"][number]
    assert not c["value"] <= c["limit"], out["checks"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_control_is_not_correct(cell):
    out = tiny.run(cell, seconds=1.0, control=True)
    assert out["correct"] is True
    ctl = out["control_checks"]
    assert any(not c["value"] <= c["limit"] for c in ctl.values()), ctl


@pytest.mark.gpu
def test_the_solo_cell_on_the_card():
    """At its full size on the card: the sound run is correct, its control
    is not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.harness import main

    out = main.run("flagship-solo-matches", tiny.SEED, 2.0, False, control=True)
    assert out["correct"] is True
    assert any(not c["value"] <= c["limit"] for c in out["control_checks"].values())
