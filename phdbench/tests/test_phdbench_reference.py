"""The reference against the port's CPU path on tiny configurations (the
cells' own settings at 16 particles and 8 steps): every number the check
reads stays under the cell's limits, and the control, the reference in
TF32 in the program's place, exceeds at least one of them. The reference
module is the one the configuration names, and the captures copy the
filter's whole state."""

import itertools
import json
import math
import re
import shutil
from pathlib import Path

import pytest
import torch

from phdbench import harness
from phdbench.reference import compare, cphd, step as ref

ROOT = Path(__file__).resolve().parents[2]

TINY = {"n_particles": 16, "n_steps": 8}


def _cell(workload, seed):
    cell = harness.load_cell(workload)
    bench = harness.Cell(cell, "cpu", TINY, checks=3, max_checks=3,
                         warmup_steps=1)
    bench.window(seed, 0.0)
    return cell, bench


@pytest.mark.parametrize("workload", ["ackerman-phd.replay",
                                      "dense-phd.online",
                                      "ackerman-cphd.replay"])
def test_program_within_limits_control_outside(workload):
    cell, bench = _cell(workload, 2 ** 31 + 11)
    limits = cell["config_file"]["limits"]
    chk = bench.check(controls=True)
    assert chk["checked"] == 4
    assert set(bench.ref.NAMES) <= set(chk["gaps"])
    assert set(limits) <= set(bench.ref.NAMES)
    prog = harness.verdict(chk["gaps"], limits)
    assert all(v["ok"] for v in prog.values()), prog
    ctrl = harness.verdict(chk["control"], limits)
    assert not all(v["ok"] for v in ctrl.values()), ctrl
    if workload.startswith("ackerman-cphd"):
        # the cardinality is compared, and the control fails it alone too
        assert chk["gaps"]["card_rel"] is not None
        assert chk["control"]["card_rel"] > limits["card_rel"]


PHD_INPUTS = {"pose", "log_weight", "mean", "cov", "weight"}
PHD_OUTPUTS = {"pose", "lw_pre", "log_weight", "ancestors", "expected_pose",
               "n_eff", "resampled", "moments", "map_moments"}


@pytest.mark.parametrize("workload,extra", [
    ("dense-phd.replay", set()), ("ackerman-cphd.replay", {"cardinality"})])
def test_captures_copy_the_filter_state(workload, extra):
    """A PHD cell's captures hold the tensors they always held; a CPHD
    cell's add the log cardinality, before and after the step."""
    _, bench = _cell(workload, 3)
    caps = bench.probe.captures
    assert len(caps) == 4
    for cap in caps:
        assert set(cap["inp"]) == PHD_INPUTS | extra
        assert set(cap["out"]) == PHD_OUTPUTS | extra
        for k in extra:
            assert cap["inp"][k].shape == cap["out"][k].shape == (16, 65)
            assert cap["inp"][k].device.type == "cpu"


def test_load_cell_refuses_an_unknown_reference(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for sub in ("configs", "traffic"):
        shutil.copytree(ROOT / "phdbench" / sub, tmp_path / "phdbench" / sub)
    path = tmp_path / "phdbench/configs/ackerman-cphd.json"
    body = json.loads(path.read_text())
    assert harness.load_cell("ackerman-cphd.replay", tmp_path)[
        "reference"] == "cphd"
    for name in ("no_such_filter", "../step", 3):
        body["reference"] = name
        path.write_text(json.dumps(body))
        with pytest.raises(ValueError, match=re.escape(repr(name))):
            harness.load_cell("ackerman-cphd.replay", tmp_path)
    # a configuration that names none takes the static PHD reference
    assert harness.load_cell("ackerman-phd.replay", tmp_path)[
        "reference"] == "step"


def test_esf_is_the_polynomial_coefficients():
    """e_j of the values: the coefficients of prod (1 + L_m x), and each
    value left out."""
    L = [0.5, 2.0, 3.0, 0.0]
    ll = torch.log(torch.tensor(L, dtype=torch.float64))
    e = torch.exp(cphd.log_esf(ll, ref.REFERENCE))
    want = [sum(math.prod(c) for c in itertools.combinations(L, j))
            for j in range(5)]
    assert torch.allclose(e, torch.tensor(want, dtype=torch.float64))
    assert want[4] == 0.0 and e[4] == 0.0


def test_cardinality_terms_at_an_empty_map():
    """With no feature in range the predicted cardinality is 0: the
    updated one stays at 0, ip0 is the clutter's likelihood of the scan
    (and so is ip1, whose n = 1 term keeps p(1) / W = 1), and nothing is
    NaN."""
    body = harness.load_cell("ackerman-cphd.replay")["config_file"]["config"]
    s = cphd.Settings.from_config(body)
    n_z, M = 3, 5
    ll = torch.full((2, M), -math.inf, dtype=torch.float64)
    lw = torch.full((2,), -math.inf, dtype=torch.float64)
    ip0, ip1, ip1d, log_cn = cphd.cardinality_terms(s, ll, lw, lw, n_z,
                                                    ref.REFERENCE)
    kr = s.clutter_rate
    assert torch.allclose(ip0, torch.full_like(ip0, n_z * math.log(kr) - kr))
    assert torch.allclose(ip1, ip0)
    assert log_cn[:, 0].abs().max() < 1e-12 and torch.isneginf(
        log_cn[:, 1:]).all()
    assert not torch.isnan(ip1d).any()


def test_cardinality_prediction_convolves_with_the_births():
    body = harness.load_cell("ackerman-cphd.replay")["config_file"]["config"]
    s = cphd.Settings.from_config(dict(body, max_cardinality=6))
    log_b = cphd.birth_cardinality(s, 2, torch.float64, "cpu")
    p = s.birth_weight
    assert torch.allclose(torch.exp(log_b[:3]), torch.tensor(
        [(1 - p) ** 2, 2 * p * (1 - p), p * p], dtype=torch.float64))
    c = torch.log(torch.tensor([[0.5, 0.5, 0, 0, 0, 0, 0]],
                               dtype=torch.float64))
    got = torch.exp(cphd.predict_cardinality(c, log_b))[0]
    b = torch.exp(log_b)
    want = torch.tensor([0.5 * b[0], 0.5 * (b[1] + b[0]), 0.5 * (b[2] + b[1]),
                         0.5 * b[2], 0, 0, 0], dtype=torch.float64)
    assert torch.allclose(got, want)


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


def test_cphd_reference_refuses_other_paths():
    body = harness.load_cell("ackerman-cphd.replay")["config_file"]["config"]
    assert cphd.Settings.from_config(body).max_cardinality == 64
    for change in (dict(filter_type=0), dict(gate_births=1),
                   dict(feature_model=2)):
        with pytest.raises(NotImplementedError):
            cphd.Settings.from_config(dict(body, **change))


def test_first_copy_counts_each_ancestor_once():
    anc = torch.tensor([3, 3, 0, 5, 3, 0, 7])
    keep = compare.first_copy(anc)
    assert sorted(anc[keep].tolist()) == [0, 3, 5, 7]
    assert int(keep.sum()) == 4
