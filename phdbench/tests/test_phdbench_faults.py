"""A whole run on the CPU, the look for a card skipped, with the timed path
broken underneath: each fault the cells can have turns ``correct`` false,
and the same run unbroken is correct."""

import pytest
import torch

import phdslam_tpu_torch.filters.cphd as cphd
import phdslam_tpu_torch.filters.phd as phd
import phdslam_tpu_torch.slam as slam
from phdbench import harness

TINY = {"n_particles": 16, "n_steps": 8}
SEED = 2 ** 31 + 7


def _run(workload="ackerman-phd.replay"):
    return harness.run(workload, SEED, 0.0, False, device="cpu",
                       overrides=TINY, log=lambda msg: None)


def unchanged_state(monkeypatch):
    """A step that returns its state unchanged (its outputs computed)."""
    orig = slam.phd_step

    def step(state, *args, **kwargs):
        return (state,) + tuple(orig(state, *args, **kwargs)[1:])
    monkeypatch.setattr(slam, "phd_step", step)


def half_the_particles(monkeypatch):
    """The expected pose over half the particles, their weights
    renormalised."""
    orig = phd.extract

    def extract(state, cfg, mesh=None, log_weight=None, pose=None):
        ep, m = orig(state, cfg, mesh, log_weight, pose)
        h = state.pose.shape[0] // 2
        w = torch.softmax(state.log_weight[:h], 0)
        return w @ state.pose[:h], m
    monkeypatch.setattr(phd, "extract", extract)


def altered_pose(monkeypatch):
    """Every predicted pose moved by 1 cm where the motion model makes it."""
    orig = phd.vehicle.ackerman_predict

    def predict(*args, **kwargs):
        out = orig(*args, **kwargs).clone()
        out[:, 0] += 0.01
        return out
    monkeypatch.setattr(phd.vehicle, "ackerman_predict", predict)


def merge_skipped(monkeypatch):
    """The merge hands back its first K candidate lanes unmerged."""
    def merge2d(packed, min_sep, out_cap, sorted_w=True, metric=0):
        P, _, N = packed.shape
        lanes = packed[:, :, :out_cap]
        act = lanes[:, 1] > 0.5
        w = torch.where(act, lanes[:, 0], 0.0)
        out = [w] + [torch.where(act, lanes[:, i], 0.0) for i in (2, 3)]
        out += [torch.where(act, lanes[:, i], float(i != 5))
                for i in (4, 5, 6)]
        out += [torch.zeros_like(w), torch.zeros_like(w)]
        return torch.stack(out, 1)
    monkeypatch.setattr(phd, "merge2d", merge2d)


def over_merge(monkeypatch):
    """The merge run at ten times the configuration's min_separation."""
    orig = phd.merge2d

    def merge2d(packed, min_sep, *args, **kwargs):
        return orig(packed, 10.0 * min_sep, *args, **kwargs)
    monkeypatch.setattr(phd, "merge2d", merge2d)


def cardinality_unpredicted(monkeypatch):
    """The CPHD step hands on its updated cardinality without the births'
    convolution."""
    monkeypatch.setattr(cphd, "cardinality_predict_batch",
                        lambda log_cn, log_cn_birth: log_cn)


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["check"]
    assert res["attempted"] == 8 and res["failed"] == 0


@pytest.mark.parametrize("fault", [unchanged_state, half_the_particles,
                                   altered_pose, merge_skipped, over_merge],
                         ids=lambda f: f.__name__)
def test_fault_is_caught(monkeypatch, fault):
    fault(monkeypatch)
    res = _run()
    assert not res["correct"]
    failed = [k for k, v in res["check"].items()
              if v["value"] is not None and not v["value"] <= v["limit"]]
    assert failed, res["check"]
    if fault is over_merge:
        # the moments survive a merge whatever its clusters
        assert failed == ["map_w2_rel_q999"], res["check"]


def test_sound_cphd_run_is_correct():
    res = _run("ackerman-cphd.replay")
    assert res["correct"], res["check"]
    assert res["attempted"] == 8 and res["failed"] == 0
    assert res["check"]["card_rel"]["value"] is not None


@pytest.mark.parametrize("fault", [unchanged_state, half_the_particles,
                                   altered_pose, merge_skipped, over_merge,
                                   cardinality_unpredicted],
                         ids=lambda f: f.__name__)
def test_cphd_fault_is_caught(monkeypatch, fault):
    """The same faults in the CPHD cell, and a cardinality left
    unpredicted, which only the cardinality's number sees."""
    fault(monkeypatch)
    res = _run("ackerman-cphd.replay")
    assert not res["correct"]
    failed = [k for k, v in res["check"].items()
              if v["value"] is not None and not v["value"] <= v["limit"]]
    assert failed, res["check"]
    if fault is over_merge:
        assert failed == ["map_w2_rel_q999"], res["check"]
    if fault is cardinality_unpredicted:
        assert failed == ["card_rel"], res["check"]
