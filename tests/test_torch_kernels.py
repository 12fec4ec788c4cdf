"""Each kernel module of the port against the JAX package's Pallas kernel.

On the CPU the port's wrappers run their plain twins (the CUDA kernels
need the card), and the JAX kernels run in interpret mode. The CUDA
kernels are held against these twins in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.ops.pallas_detect import detection_topT_batch
from phdslam_tpu.ops.pallas_merge import gm_merge_pallas_batch_packed
from phdslam_tpu.ops.pallas_select import (onehot_cols_batch,
                                           onehot_rows_batch)
from detect_bench import DETECT_EDGES, MIN_SEP_EDGES, detect_edge_case
from merge_bench import (DISP_SEP, HELL_SEP, MIN_SEP, MIXED_SEP,
                         ROUND_PRINCIPALS, merge3d_inputs, merge4d_inputs,
                         merge_edge_case, merge_rounds)
from phdslam_tpu_torch.kernels import build
from phdslam_tpu_torch.kernels.detect import detect, detect_reference
from phdslam_tpu_torch.kernels.gather_cols import (gather_cols,
                                                   gather_cols_reference)
from phdslam_tpu_torch.kernels.gather_rows import gather_rows
from phdslam_tpu_torch.kernels.merge import (merge2d, merge2d_reference,
                                             merge3d_reference,
                                             merge4d_reference)
from phdslam_tpu_torch.ops.gm_merge import merge_out


# ----------------------------------------------------------------------------
# inputs (numpy, from a seed)
# ----------------------------------------------------------------------------

def detect_case(seed, P=6, K=32, M=8, n_valid=6):
    """tests/test_pallas_detect.py::make_case, as numpy."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(1, 10, (P, K)).astype(np.float32)
    bearing = rng.uniform(-np.pi, np.pi, (P, K)).astype(np.float32)
    si00 = rng.uniform(0.5, 4.0, (P, K)).astype(np.float32)
    si01 = rng.uniform(-0.2, 0.2, (P, K)).astype(np.float32)
    si11 = rng.uniform(0.5, 4.0, (P, K)).astype(np.float32)
    pref = np.where(rng.uniform(size=(P, K)) < 0.7,
                    rng.uniform(0.01, 1.0, (P, K)), 0.0).astype(np.float32)
    planes = np.stack([r, bearing, si00, si01, si11, pref], axis=1)
    zr = rng.uniform(1, 10, M).astype(np.float32)
    zb = rng.uniform(-np.pi, np.pi, M).astype(np.float32)
    valid = (np.arange(M) < n_valid).astype(np.float32)
    z4 = np.stack([zr, zb, valid, np.zeros(M, np.float32)], axis=1)
    return planes, z4


def merge_case(seed, P=4, N=64, spread=0.3):
    """Clustered candidates compacted into a weight-descending active
    prefix, as the top-cap selection hands them to the merge: planes
    [P, 7, N] (w, act, mx, my, c00, c01, c11)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 20, (P, 8, 2))
    mean = centers[np.arange(P)[:, None], rng.integers(0, 8, (P, N))] \
        + rng.normal(0, spread, (P, N, 2))
    A = rng.normal(0, 0.5, (P, N, 2, 2))
    cov = np.einsum("pnij,pnkj->pnik", A, A) + 0.3 * np.eye(2)
    w = rng.uniform(0, 1, (P, N))
    act = rng.random((P, N)) < 0.7
    order = np.argsort(np.where(act, -w, 1.0), axis=1, kind="stable")
    take = lambda x: np.take_along_axis(x, order, axis=1)
    act_s = take(act)
    planes = np.stack([np.where(act_s, take(w), 0.0), act_s,
                       take(mean[..., 0]), take(mean[..., 1]),
                       take(cov[..., 0, 0]), take(cov[..., 0, 1]),
                       take(cov[..., 1, 1])], axis=1)
    return planes.astype(np.float32)


# ----------------------------------------------------------------------------
# detect
# ----------------------------------------------------------------------------

DETECT_CASES = {
    "make_case": dict(seed=0),
    "wide_m": dict(seed=2, P=6, K=32, M=32, n_valid=5),
    "ragged_none_valid": dict(seed=1, P=3, K=16, M=4, n_valid=0),
}


def detect_args(case):
    """(planes, z4, T, min_fw, cb) of a DETECT_CASES entry (T 4, min_fw
    1e-4, cb 0.05) or of detect_bench.DETECT_EDGES: the selection's edges
    (live count exactly T and T + 1 at T 32 and 16, every lane dead, K 100,
    T = K, T 1, M 1, a NaN in a plane, duplicated features at T 32, K 1024
    at min_fw 0)."""
    if case in DETECT_CASES:
        return (*detect_case(**DETECT_CASES[case]), 4, 1e-4, 0.05)
    return detect_edge_case(case)


def pallas_and_twin(planes, z4, T, min_fw, cb, min_sep=0.0):
    """The Pallas kernel's outputs (interpret mode) and the twin's, numpy."""
    want = detection_topT_batch(jnp.asarray(planes), jnp.asarray(z4), T,
                                min_fw, cb, interpret=True, min_sep=min_sep)
    got = detect_reference(torch.from_numpy(planes), torch.from_numpy(z4),
                           T, min_fw, cb, min_sep)
    return ([np.asarray(x) for x in want], [x.numpy() for x in got])


@pytest.mark.parametrize("case", sorted(DETECT_CASES) + list(DETECT_EDGES))
def test_detect_twin_matches_pallas(case):
    planes, z4, T, min_fw, cb = detect_args(case)
    (kv, ki, kn, kc), (tv, ti, tn, tc) = pallas_and_twin(planes, z4, T,
                                                         min_fw, cb)
    np.testing.assert_allclose(tn, kn, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tv, kv, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(tc, kc)
    sel = kv > 0
    np.testing.assert_array_equal(ti[sel], ki[sel])
    # exhausted trips and invalid rows emit index 0, like the TPU kernel
    assert (ti[~sel] == 0).all() and (ki[~sel] == 0).all()
    assert ti.dtype == np.int32 and tc.dtype == np.int32
    opt = DETECT_EDGES.get(case, (0,) * 5 + ({},))[5]
    if "live" in opt:
        assert (tc[:, z4[:, 2] > 0.5] == opt["live"]).all()
    if opt.get("nan"):                   # the NaN particle's valid rows
        valid = z4[:, 2] > 0.5
        assert np.isnan(tn[1, valid]).all() and (tc[1] == 0).all()
        assert np.isfinite(tn[0]).all() and (tn[1, ~valid] == cb).all()


@pytest.mark.parametrize("case", list(DETECT_EDGES))
def test_detect_cons_twin_matches_pallas_edges(case):
    """The consolidating twin against the Pallas kernel's cons_ref branch at
    the selection's edges: top-T of the live non-member lanes, counts, and
    the cons planes (member counts, pers_in and head coordinates exactly,
    the moment sums to rtol 1e-4 / atol 1e-6)."""
    planes, z4, T, min_fw, cb = detect_edge_case(case, cons=True)
    (kv, ki, kn, kc, kcons), (tv, ti, tn, tc, tcons) = pallas_and_twin(
        planes, z4, T, min_fw, cb, MIN_SEP_EDGES)
    np.testing.assert_allclose(tn, kn, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tv, kv, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(tc, kc)
    sel = kv > 0
    np.testing.assert_array_equal(ti[sel], ki[sel])
    assert (ti[~sel] == 0).all() and (ki[~sel] == 0).all()
    np.testing.assert_array_equal(tcons[:, 6:], kcons[:, 6:])
    np.testing.assert_allclose(tcons[:, :6], kcons[:, :6], rtol=1e-4,
                               atol=1e-6)


def test_detect_ties_go_to_lowest_index():
    planes, z4 = detect_case(5, P=2, K=32, M=4, n_valid=4)
    planes[:, :, 8:16] = planes[:, :, 0:8]       # duplicated features
    planes[:, 5, :] = np.where(planes[:, 5, :] > 0, planes[:, 5, :], 0.5)
    T = 12
    kv, ki, _, _ = (np.asarray(x) for x in detection_topT_batch(
        jnp.asarray(planes), jnp.asarray(z4), T, 1e-6, 0.05,
        interpret=True))
    tv, ti, _, _ = (x.numpy() for x in detect_reference(
        torch.from_numpy(planes), torch.from_numpy(z4), T, 1e-6, 0.05))
    sel = kv > 0
    np.testing.assert_array_equal(ti[sel], ki[sel])
    np.testing.assert_allclose(tv, kv, rtol=1e-6)


def test_detect_wrapper_runs_twin_on_cpu():
    planes, z4 = (torch.from_numpy(x) for x in detect_case(0))
    build.reset_launch_counts()
    got = detect(planes, z4, 4, 1e-4, 0.05)
    want = detect_reference(planes, z4, 4, 1e-4, 0.05)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert build.launch_counts["detect"] == 0


# ----------------------------------------------------------------------------
# gather_cols and gather_rows
# ----------------------------------------------------------------------------

# the three call shapes of the update, cut to size: candidate tables t_k
# (C=16) and t_m (C=8), and the post-merge compaction (C=5, R=2K); then the
# CUDA kernel's edge cases, with indices from [-2, R + 2) (some out of
# range): C R not a multiple of 4 (its slab's bulk copy has a head and a
# tail), cap not a multiple of 4 (scalar index loads and stores), cap 1
# and a single particle
GATHER_SHAPES = {"t_k": (4, 16, 32, 64), "t_m": (4, 8, 8, 64),
                 "post": (4, 5, 64, 32)}
GATHER_EDGES = {"cr_ragged": (4, 5, 47, 64), "cap_ragged": (4, 5, 47, 61),
                "cap_1": (3, 16, 32, 1), "p_1": (1, 16, 32, 64)}


@pytest.mark.parametrize("shape",
                         sorted(GATHER_SHAPES) + sorted(GATHER_EDGES))
def test_gather_cols_twin_matches_pallas(shape):
    P, C, R, cap = GATHER_SHAPES.get(shape) or GATHER_EDGES[shape]
    rng = np.random.default_rng(C)
    lo, hi = (-2, R + 2) if shape in GATHER_EDGES else (0, R)
    idx = rng.integers(lo, hi, (P, cap)).astype(np.int32)
    tab = rng.normal(0, 10, (P, C, R)).astype(np.float32)
    want = np.asarray(onehot_cols_batch(jnp.asarray(idx), jnp.asarray(tab),
                                        interpret=True))
    got = gather_cols_reference(torch.from_numpy(idx),
                                torch.from_numpy(tab)).numpy()
    np.testing.assert_array_equal(got, want)


def test_gather_cols_out_of_range_gives_zero():
    tab = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    idx = torch.tensor([[0, 3, 4, -1], [2, 9, 1, 0]], dtype=torch.int32)
    got = gather_cols(idx, tab)
    want = np.asarray(onehot_cols_batch(jnp.asarray(idx.numpy()),
                                        jnp.asarray(tab.numpy()),
                                        interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, :, 2:] == 0).all() and (got[1, :, 1] == 0).all()


# the row gather's edge cases (P, cap, R, C), indices from [-2, R + 2): C
# and R C not multiples of 4 (scalar row copies, a slab with a head and a
# tail), cap not a multiple of 4, cap 1, a single particle
GATHER_ROWS_EDGES = {"c_ragged": (4, 64, 47, 5),
                     "cap_ragged": (4, 61, 32, 16),
                     "cap_1": (3, 1, 32, 16), "p_1": (1, 64, 47, 5)}


@pytest.mark.parametrize("shape", sorted(GATHER_ROWS_EDGES))
def test_gather_rows_twin_matches_pallas_edges(shape):
    P, cap, R, C = GATHER_ROWS_EDGES[shape]
    rng = np.random.default_rng(R)
    idx = rng.integers(-2, R + 2, (P, cap)).astype(np.int32)
    tab = rng.normal(0, 10, (P, R, C)).astype(np.float32)
    want = np.asarray(onehot_rows_batch(jnp.asarray(idx), jnp.asarray(tab),
                                        interpret=True))
    build.reset_launch_counts()
    got = gather_rows(torch.from_numpy(idx), torch.from_numpy(tab)).numpy()
    assert not build.launch_counts                       # twin: no launch
    np.testing.assert_array_equal(got, want)
    assert (got[(idx < 0) | (idx >= R)] == 0).all()


# ----------------------------------------------------------------------------
# merge2d
# ----------------------------------------------------------------------------

def _pallas_merge(planes, min_sep, K):
    return tuple(np.asarray(x) for x in gm_merge_pallas_batch_packed(
        jnp.asarray(planes), min_sep, K, interpret=True, sorted_w=True))


def _twin_merge(planes, min_sep, K):
    out = merge2d_reference(torch.from_numpy(planes), min_sep, K)
    return tuple(x.numpy() for x in merge_out(out, 2))


def assert_same_merge(got, want):
    """Same clusters in the same greedy emission order."""
    g_mean, g_cov, g_w, g_nm, g_nd = got
    w_mean, w_cov, w_w, w_nm, w_nd = want
    np.testing.assert_array_equal(g_nm, w_nm)
    np.testing.assert_array_equal(g_nd, w_nd)
    np.testing.assert_allclose(g_w, w_w, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g_mean, w_mean, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g_cov, w_cov, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_twin_matches_pallas(seed):
    planes = merge_case(seed)
    got = _twin_merge(planes, 4.0, 16)
    assert_same_merge(got, _pallas_merge(planes, 4.0, 16))
    assert (got[3] > 1).all()


def test_merge_twin_overflow_counts():
    """More clusters than capacity: the leftover count matches."""
    planes = merge_case(3, P=2, N=64, spread=100.0)
    got = _twin_merge(planes, 4.0, 4)
    want = _pallas_merge(planes, 4.0, 4)
    assert_same_merge(got, want)
    assert (got[4] > 0).all()


def test_merge_twin_terminates_on_nan_weights():
    """NaN and non-positive weights never enter, so the loop ends."""
    planes = merge_case(4, P=2)
    planes[0, 0] = np.nan            # a whole particle of NaN weights
    planes[1, 0, :8] = 0.0           # zero-weight active lanes
    got = _twin_merge(planes, 4.0, 16)
    assert_same_merge(got, _pallas_merge(planes, 4.0, 16))
    assert got[3][0] == 0 and got[4][0] == 0 and got[3][1] > 0


def test_merge_wrapper_runs_twin_on_cpu():
    planes = torch.from_numpy(merge_case(0))
    build.reset_launch_counts()
    assert torch.equal(merge2d(planes, 4.0, 16),
                       merge2d_reference(planes, 4.0, 16))
    assert build.launch_counts["merge2d"] == 0


# edges of merge_bench.MERGE_EDGES that the cases above do not reach, on
# their first 128 lanes (sorted_w False: the lanes in a random order): w <= 0
# lanes (absorbed, never leading) and NaN weights (the row stalls), equal
# weights (ties to the lowest lane), K binding, one all-covering cluster
MERGE_EDGE_RUNS = [("NaN and w <= 0 weights", False), ("equal weights", False),
                   ("every lane its own cluster, K binding", False),
                   ("every lane its own cluster, K binding", True),
                   ("all within min_sep of the first", False),
                   ("all within min_sep of the first", True)]


@pytest.mark.parametrize("name,sorted_w", MERGE_EDGE_RUNS)
def test_merge_twin_matches_pallas_edges(name, sorted_w):
    planes, K = merge_edge_case(name, sorted_w)
    planes = planes[:, :, :128]
    want = tuple(np.asarray(x) for x in gm_merge_pallas_batch_packed(
        jnp.asarray(planes), MIN_SEP, K, interpret=True, sorted_w=sorted_w))
    got = merge_out(merge2d_reference(torch.from_numpy(planes), MIN_SEP, K,
                                      sorted_w), 2)
    assert_same_merge(tuple(x.numpy() for x in got), want)
    if "NaN" in name:                 # stalled rows, and a w <= 0 row
        assert list(want[3][:2]) == [0, 0] and want[3][3] == 0
        assert want[3][2] > 0 and (want[3][4:] > 0).all()
    if "K binding" in name:
        assert (want[3] == K).all() and (want[4] > 0).all()
    if "all within" in name:
        assert (want[3] == 1).all() and (want[4] == 0).all()


@pytest.mark.parametrize("sorted_w", [True, False])
@pytest.mark.parametrize("metric", [0, 1])
def test_merge_round_replay_emits_the_sequential_clusters(sorted_w, metric):
    """The kernel's round-based chain (merge_bench.merge_rounds: R
    tentative principals a round, the validity chain) emits the clusters
    of the sequential twin, in fewer rounds than clusters."""
    planes = merge_case(5, P=6, N=256)
    if not sorted_w:
        planes = planes[:, :, np.random.default_rng(0).permutation(256)]
    planes = torch.from_numpy(planes)
    sep = HELL_SEP if metric else 4.0
    enter, trips, rounds = merge_rounds(planes, sep, 64, sorted_w, metric)
    want = merge_out(merge2d_reference(planes, sep, 64, sorted_w, metric), 2)
    assert torch.equal(trips, want[3])
    assert torch.equal(enter, (planes[:, 1] > 0.5).sum(dim=1))
    assert (rounds * ROUND_PRINCIPALS >= trips).all()
    assert (rounds < trips).all()


# merge_bench.MERGE_EDGES cases that merge3d and merge4d run, at a size the
# CPU tests take (:func:`active_first`); N 2048 and P 1 need the card
MERGE_EDGES_3D4D = ["no lane entering", "one lane",
                    "all within min_sep of the first",
                    "every lane its own cluster, K binding",
                    "NaN and w <= 0 weights", "equal weights",
                    "degenerate covariance"]


def active_first(planes, P=4, n=128):
    """The first P particles' active lanes moved first (stable, so the
    sorted contract's weight order holds), then the first n lanes."""
    order = np.argsort(planes[:P, 1] <= 0.5, axis=1, kind="stable")
    return np.ascontiguousarray(
        np.take_along_axis(planes[:P], order[:, None, :], axis=2)[..., :n])


def _merge_twin(D):
    return merge3d_reference if D == 3 else merge4d_reference


@pytest.mark.parametrize("D", [3, 4])
@pytest.mark.parametrize("case", ["clustered", "isolated"])
def test_merge_round_replay_3d_4d_emits_the_sequential_clusters(D, case):
    """merge_bench.merge_rounds at D = 3 and 4 (the round chain of
    csrc/merge_core.cuh, R tentative principals a round) emits the
    clusters of merge3d's and merge4d's sequential twins: clustered
    candidates at the disparity and mixed paths' spreads, and isolated
    ones (every lane its own cluster, K binding)."""
    if case == "clustered":
        cpu = torch.device("cpu")
        planes = (merge3d_inputs(cpu, P=6, N=256, seed=5) if D == 3
                  else merge4d_inputs(cpu, P=6, N=128, seed=5))
        sep, K = (DISP_SEP, 24) if D == 3 else (MIXED_SEP, 128)
    else:
        planes, K = merge_edge_case("every lane its own cluster, K binding",
                                    D=D)
        planes = torch.from_numpy(active_first(planes))
        sep = MIN_SEP
    enter, trips, rounds = merge_rounds(planes, sep, K)
    want = merge_out(_merge_twin(D)(planes, sep, K), D)
    assert torch.equal(trips, want[3])
    assert torch.equal(enter, ((planes[:, 1] > 0.5)
                               & (planes[:, 0] > 0)).sum(dim=1))
    assert (rounds * ROUND_PRINCIPALS >= trips).all()
    assert (rounds < trips).all()
    if case == "isolated":
        assert (trips == K).all() and (want[4] > 0).all()
