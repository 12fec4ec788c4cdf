"""The reference against the port's CPU path on tiny configurations (the
cells' own settings at 16 particles and 8 steps): every number the check
reads stays under the cell's limits, and the control, the reference in
TF32 in the program's place, exceeds at least one of them."""

import pytest
import torch

from phdbench import harness
from phdbench.reference import compare, step as ref

TINY = {"n_particles": 16, "n_steps": 8}


def _cell(workload, seed):
    cell = harness.load_cell(workload)
    bench = harness.Cell(cell, "cpu", TINY, checks=3, max_checks=3,
                         warmup_steps=1)
    bench.window(seed, 0.0)
    return cell, bench


@pytest.mark.parametrize("workload", ["ackerman-phd.replay",
                                      "dense-phd.online"])
def test_program_within_limits_control_outside(workload):
    cell, bench = _cell(workload, 2 ** 31 + 11)
    limits = cell["config_file"]["limits"]
    chk = bench.check(controls=True)
    assert chk["checked"] == 4
    prog = harness.verdict(chk["gaps"], limits)
    assert all(v["ok"] for v in prog.values()), prog
    ctrl = harness.verdict(chk["control"], limits)
    assert not all(v["ok"] for v in ctrl.values()), ctrl


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159265])
    y = ref.tf32_round(x)
    assert y[0] == 1.0 and y[1] == 1.0           # a tie goes to even
    assert y[2] == 1.0 + 2 ** -9
    assert abs(float(y[3]) + 3.14159265) < 2 ** -10 * 4
    assert ref.tf32_round(x.double()).dtype == torch.float64


def test_moments_survive_any_merge():
    g = torch.Generator().manual_seed(0)
    w = torch.rand(3, 40, generator=g, dtype=torch.float64)
    mean = torch.randn(3, 40, 2, generator=g, dtype=torch.float64) * 5
    a = torch.randn(3, 40, 2, 2, generator=g, dtype=torch.float64)
    cov = a @ a.transpose(-1, -2) + torch.eye(2, dtype=torch.float64)
    before = ref.map_moments(mean, cov, w)
    for sep in (0.5, 5.0, 1e9):
        ow, om, oc, *_ = ref.greedy_merge(w, mean, cov, sep, 40,
                                          ref.REFERENCE)
        after = ref.map_moments(om, oc, ow)
        assert torch.allclose(after[:, :6], before[:, :6], rtol=1e-12,
                              atol=1e-9)
    assert int(after[0, 6]) == 1        # everything within 1e9 merges


def test_squared_weights_see_the_merge():
    """The moments survive any merge; the squared weights do not, and the
    margin names the particles whose clusters rounding could change."""
    g = torch.Generator().manual_seed(1)
    w = torch.sort(torch.rand(3, 40, generator=g, dtype=torch.float64),
                   descending=True).values
    mean = torch.randn(3, 40, 2, generator=g, dtype=torch.float64) * 5
    cov = torch.eye(2, dtype=torch.float64).expand(3, 40, 2, 2).clone()
    w2 = []
    for sep in (5.0, 50.0, 1e9):
        ow, om, oc, margin, _ = ref.greedy_merge(w, mean, cov, sep, 40,
                                                 ref.REFERENCE)
        w2.append(ref.map_moments(om, oc, ow)[:, 7])
        assert bool((margin > 0).all())
    assert bool((w2[0] < w2[1]).all() and (w2[1] < w2[2]).all())
    assert torch.allclose(w2[2], w.sum(1) ** 2)
    # a lane at the threshold: d2 = |dx|^2 under unit covariances
    mean2 = torch.tensor([[[0.0, 0.0], [1.5, 0.0], [30.0, 0.0]]],
                         dtype=torch.float64)
    cov2 = torch.eye(2, dtype=torch.float64).expand(1, 3, 2, 2).clone()
    w3 = torch.tensor([[0.5, 0.3, 0.2]], dtype=torch.float64)
    m, tie = ref.greedy_merge(w3, mean2, cov2, 2.25, 3, ref.REFERENCE)[3:]
    assert float(m[0]) < ref.MERGE_GATE and not bool(tie[0])
    m, tie = ref.greedy_merge(w3, mean2, cov2, 5.0, 3, ref.REFERENCE)[3:]
    assert float(m[0]) > ref.MERGE_GATE and not bool(tie[0])
    # two leaders whose weights tie to rounding, each within reach of a
    # common lane: either may lead in float32, and the clusters change
    mean4 = torch.tensor([[[0.0, 0.0], [3.0, 0.0], [1.5, 0.0],
                           [30.0, 0.0]]], dtype=torch.float64)
    cov4 = torch.eye(2, dtype=torch.float64).expand(1, 4, 2, 2).clone()
    w4 = torch.tensor([[0.4, 0.4 * (1 - 1e-7), 0.1, 0.1]],
                      dtype=torch.float64)
    tie = ref.greedy_merge(w4, mean4, cov4, 4.0, 4, ref.REFERENCE)[4]
    assert bool(tie[0])
    # the same tie with nothing in common: the order changes nothing
    mean4[0, 1, 0] = 10.0
    tie = ref.greedy_merge(w4, mean4, cov4, 4.0, 4, ref.REFERENCE)[4]
    assert not bool(tie[0])


def test_reference_refuses_other_paths():
    body = harness.load_cell("dense-phd.replay")["config_file"]["config"]
    with pytest.raises(NotImplementedError):
        ref.Settings.from_config(dict(body, filter_type=1))


def test_first_copy_counts_each_ancestor_once():
    anc = torch.tensor([3, 3, 0, 5, 3, 0, 7])
    keep = compare.first_copy(anc)
    assert sorted(anc[keep].tolist()) == [0, 3, 5, 7]
    assert int(keep.sum()) == 4
