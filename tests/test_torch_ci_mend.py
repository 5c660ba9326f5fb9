"""PyTorch port: the descriptor fusion's CI update where S does not
factorize in float32 (ROADMAP C21).

``tests/data/rcomm_round17_fusion.npz`` holds the operands of one joint
SLAM-SLAM CI update (``vio/updates/multi_slam.apply_matches``) as the card
ran it: the benchmark's 16-agent REQUEST_COMM fleet (configuration
``rcomm-m10n10-vga``, seed 2500000005) in its 17th round, after frame 169,
the first fusion, agents 5 and 9, float32. There S's entries span 10^-2 to
10^6 and its smallest direction is lost to rounding: the update as it was
(an LU solve of S) turned both agents' covariance non-finite. These tests
hold, on the CPU:

* the update as it was, on those operands: non-finite;
* the mended update: no update for either agent (S does not factorize at
  the working precision), the covariance and state as they were;
* the same operands in float64: S factorizes and the matches apply, finite;
* the recorder's ``ci_dropped`` counts the matches the mend leaves unapplied;
* the mended update against the benchmark reference's plain copy
  (``benchmark/reference/mended_ci.py``), bit for bit, in float32 (no update)
  and float64 (updates applied).
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from x_multi_agent_torch.ekf import ci as ci_mod
from x_multi_agent_torch.ekf.state import CoreState, StateDims, VisionState
from x_multi_agent_torch.utils import timing, tree
from x_multi_agent_torch.vio.updates import multi_slam

DATA = Path(__file__).resolve().parent / "data" / "rcomm_round17_fusion.npz"
DIMS = StateDims(n_poses=10, n_features=10, buffer_size=128)
SIGMA_LANDMARK, CI_SLAM_W = 0.1, 0.01  # the configuration's CollabConfig
PEER = ("other_p_arr", "other_q_arr", "other_f_arr", "other_anchor", "other_lm_cov", "own_fid",
        "other_fid", "match_valid")


def _operands(dtype=torch.float32):
    z = np.load(DATA)

    def get(key):
        x = torch.from_numpy(z[key])
        return x.to(dtype) if x.is_floating_point() else x

    def fields(cls, prefix):
        return cls(**{f.name: get(f"{prefix}.{f.name}") for f in dataclasses.fields(cls)})

    return (fields(CoreState, "core"), fields(VisionState, "vision"), get("cov"),
            *(get(k) for k in PEER))


def _apply(operands):
    return multi_slam.apply_matches(DIMS, *operands, SIGMA_LANDMARK, CI_SLAM_W)


def _finite(cov):
    return torch.isfinite(cov).flatten(1).all(1)


def test_the_update_as_it_was_turns_both_agents_non_finite(monkeypatch):
    def lu(cov, ci_cov, h, res, s):  # the LU solve, applied wherever a match was kept
        corr, cov1 = ci_mod.apply_ci(cov, ci_cov, h, res, s)
        return corr, cov1, torch.ones(cov.shape[0], dtype=torch.bool)

    monkeypatch.setattr(ci_mod, "apply_ci_spd", lu)
    _, _, cov, n_app, _ = _apply(_operands())
    assert n_app.tolist() == [2, 4]
    assert not _finite(cov).any()


def test_the_mended_update_applies_nothing_where_s_does_not_factorize():
    ops = _operands()
    core, vision, cov, n_app, kept = _apply(ops)
    assert n_app.tolist() == [0, 0] and not kept.any()
    assert _finite(cov).all()
    for got, ref in zip(tree.leaves((core, vision, cov)), tree.leaves(ops[:3])):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype, dropped", [(torch.float32, 6), (torch.float64, 0)])
def test_the_recorder_counts_the_matches_the_mend_drops(dtype, dropped):
    # float32: the 2 + 4 matches the gates kept (as the LU solve applied
    # them, above) go unapplied; float64 drops none
    timing.disable()
    timing.start()
    timing.enable()
    try:
        _apply(_operands(dtype))
        assert timing.collect()["counters"]["ci_dropped"] == dropped
    finally:
        timing.disable()
        timing.start()


def test_in_float64_the_same_fusion_applies_and_stays_finite():
    _, _, cov, n_app, _ = _apply(_operands(torch.float64))
    assert (n_app > 0).all()
    assert _finite(cov).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_mended_update_equals_the_reference_copy(dtype):
    from benchmark.harness.tree import convert
    from benchmark.reference import mended_ci
    from benchmark.reference.steps import PACKAGE as REF

    ops = _operands(dtype)
    got = _apply(ops)
    ref_ops = convert(ops, "x_multi_agent_torch", REF)
    ref_dims = convert(DIMS, "x_multi_agent_torch", REF)
    ref = mended_ci.apply_matches(ref_dims, *ref_ops, SIGMA_LANDMARK, CI_SLAM_W)
    g, r = tree.leaves(got), tree.leaves(ref)
    assert len(g) == len(r)
    for a, b in zip(g, r):
        assert torch.equal(a, b)
