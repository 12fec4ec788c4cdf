"""Times the port's merge kernels at every shape the paths launch.

    python3 merge_bench.py [--root DIR] [--label NAME] [--out FILE]
                           [--expect FILE] [--expect-counts FILE]
                           [--keep DIR] [--only TEXT]

Needs one NVIDIA GPU; imports no jax. ``phdslam_tpu_torch`` is imported
from DIR (default: the directory of this script), so that two checkouts can
be held side by side on one card in one call, as with ``gather_bench.py``
and ``detect_bench.py``: unpack the other into a directory that
``.gitignore`` lists and run parent, change, change, parent.

The cases (``MERGE_TIMED``) are each merge2d variant on its scene (the
synthetic candidates of :func:`merge_inputs` and :func:`full_grid_inputs`,
and ``eval/scenes.py``'s tables at the Ackerman and dense shapes), merge4d
and merge3d on theirs (:func:`merge4d_inputs`, :func:`merge3d_inputs`),
and the exact inputs of real runs (``detect_bench.CAPTURED``: step 60 of
Ackerman P=512, dense P=1024 plain and fused + adaptive, the Ackerman full
grid at P=512, whose merge runs in argmax mode, and the mixed bench P=512,
whose dynamic map merges in merge4d; frame 20 of data/disparity P=512,
merge3d). For each it checks the kernel against its twin
(:func:`check_merge`: equal cluster and leftover counts, rtol 1e-4 / atol
1e-5) and prints one JSON line: the time per eager call, host included
(``call_ms``), the device time of calls replayed from a CUDA graph
(``graph_ms``), the bound, the entering lanes, clusters (trips) and rounds
a particle of the round-based greedy chain (:func:`merge_rounds`,
``ROUND_PRINCIPALS`` tentative principals a round), the valid principals a
round, the launch plan where the checkout reports one (threads, shared-
memory slots, blocks an SM, registers, waves), and a digest of the output
(``out_sha``). The edge cases (``MERGE_EDGES``) follow, through every
merge2d variant and both merge2d_tables metrics, and through merge3d and
merge4d up to their 2048 lanes, checked and digested the same way,
untimed. ``--out FILE`` keeps the lines; ``--expect FILE``
requires every case's digest to equal the one in FILE (another checkout's
run on the same inputs): the two kernels then agree bit for bit
(``--keep DIR`` makes the runs merge the same captured steps);
``--expect-counts FILE`` requires only the cluster and leftover counts
(``counts_sha``) to repeat FILE's: the same clusters, summed in another
order. The staged wide-lane variants are timed too: at the paths' shapes
(the mixed full grid's dynamic map at step 40 and the dense full grid's
whole launch at step 20, both argmax mode; their twins and the round
replay on the lanes that enter, :func:`entering_planes`) and at
``WIDE_EDGES`` in every merge2d variant and both merge2d_tables metrics
(``wide_runs``), held to the twin by :func:`check_merge_rows`.

This module is also the one home of the merges' synthetic inputs, their
bounds and their edge cases; ``chip_smoke.py`` and the tests import them.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from detect_bench import (bound, capture_step, digest, max_err, require)
from gather_bench import bench_parser, graph_ms, open_checkout, time_call

ROUND_PRINCIPALS = 8            # csrc/merge2d.cu, merge3d.cu, merge4d.cu::kR
MERGE_DIMS = {7: 2, 11: 3, 16: 4}  # input planes -> D
OUT_PLANES = {2: 8, 3: 12, 4: 16}  # D -> output planes
MIN_SEP = 5.0                   # cfg/ackerman.cfg and cfg/dense.cfg
HELL_SEP = 0.6                  # the Hellinger runs' min_separation
MIXED_SEP = 2.0                 # the mixed bench's min_separation (4D)
DISP_SEP = 20.0                 # cfg/disparity.cfg's min_separation (3D)


# ----------------------------------------------------------------------------
# inputs (numpy, from a seed)
# ----------------------------------------------------------------------------

def merge_inputs(dev, P=512, N=512, seed=0, spread=0.3):
    """Clustered candidates, active lanes as a weight-descending prefix."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 20, (P, 40, 2))
    mean = centers[np.arange(P)[:, None], rng.integers(0, 40, (P, N))] \
        + rng.normal(0, spread, (P, N, 2))
    A = rng.normal(0, 0.5, (P, N, 2, 2))
    cov = np.einsum("pnij,pnkj->pnik", A, A) + 0.3 * np.eye(2)
    w = rng.uniform(0, 1, (P, N))
    act = rng.random((P, N)) < 0.6
    order = np.argsort(np.where(act, -w, 1.0), axis=1, kind="stable")

    def take(x):
        return np.take_along_axis(x, order, axis=1)
    act_s = take(act)
    planes = np.stack([np.where(act_s, take(w), 0.0), act_s,
                       take(mean[..., 0]), take(mean[..., 1]),
                       take(cov[..., 0, 0]), take(cov[..., 0, 1]),
                       take(cov[..., 1, 1])], axis=1)
    return torch.tensor(planes, dtype=torch.float32, device=dev)


def full_grid_inputs(dev, P=512, N=6320, seed=0, frac=0.1, n_centers=40):
    """The full grid's merge planes (K + M K + M = 6320 lanes at K=128,
    M=48): ~``frac`` of the lanes active, spread over the lane axis in no
    weight order, clustered means (spread 0.3 about ``n_centers``
    centres), covariances 0.3 I + A A'."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 20, (P, n_centers, 2))
    mean = centers[np.arange(P)[:, None],
                   rng.integers(0, n_centers, (P, N))] \
        + rng.normal(0, 0.3, (P, N, 2))
    A = rng.normal(0, 0.5, (P, N, 2, 2))
    cov = np.einsum("pnij,pnkj->pnik", A, A) + 0.3 * np.eye(2)
    act = rng.random((P, N)) < frac
    w = np.where(act, rng.uniform(1e-3, 1, (P, N)), 0.0)
    planes = np.stack([w, act, mean[..., 0], mean[..., 1], cov[..., 0, 0],
                       cov[..., 0, 1], cov[..., 1, 1]], axis=1)
    return torch.tensor(planes, dtype=torch.float32, device=dev)


def merge4d_inputs(dev, P=512, N=128, seed=0):
    """Clustered 4D candidates (positions spread 0.3 m, velocities 0.3 m/s
    about ~0.5 m/s centres, as the bench's dynamic map holds them), active
    lanes a weight-descending prefix: planes [P, 16, N]."""
    rng = np.random.default_rng(seed)
    centers = np.concatenate([rng.normal(0, 8, (P, 30, 2)),
                              rng.normal(0, 0.5, (P, 30, 2))], axis=-1)
    mean = centers[np.arange(P)[:, None], rng.integers(0, 30, (P, N))] \
        + rng.normal(0, 0.3, (P, N, 4))
    A = rng.normal(0, 0.4, (P, N, 4, 4))
    cov = np.einsum("pnij,pnkj->pnik", A, A) + 0.2 * np.eye(4)
    w = rng.uniform(0, 1, (P, N))
    act = rng.random((P, N)) < 0.6
    order = np.argsort(np.where(act, -w, 1.0), axis=1, kind="stable")

    def take(x):
        return np.take_along_axis(x, order, axis=1)
    act_s = take(act)
    planes = [np.where(act_s, take(w), 0.0), act_s]
    planes += [take(mean[..., i]) for i in range(4)]
    planes += [take(cov[..., a, b]) for a in range(4) for b in range(a, 4)]
    return torch.tensor(np.stack(planes, axis=1), dtype=torch.float32,
                        device=dev)


def merge3d_inputs(dev, P=512, N=512, seed=0, n_centers=16, spread=3.0):
    """Clustered (u, v, d) candidates at the spread of min_separation 20
    (``n_centers`` clusters per particle in the image and d in 20-300,
    members ~3 px apart, covariances 16 px^2 + A A'), active lanes a
    weight-descending prefix: planes [P, 11, N]."""
    rng = np.random.default_rng(seed)
    centers = np.stack([rng.uniform(0, 640, (P, n_centers)),
                        rng.uniform(0, 480, (P, n_centers)),
                        rng.uniform(20, 300, (P, n_centers))], axis=-1)
    mean = centers[np.arange(P)[:, None],
                   rng.integers(0, n_centers, (P, N))] \
        + rng.normal(0, spread, (P, N, 3))
    A = rng.normal(0, 1.5, (P, N, 3, 3))
    cov = np.einsum("pnij,pnkj->pnik", A, A) + 16.0 * np.eye(3)
    w = rng.uniform(0, 1, (P, N))
    act = rng.random((P, N)) < 0.6
    order = np.argsort(np.where(act, -w, 1.0), axis=1, kind="stable")

    def take(x):
        return np.take_along_axis(x, order, axis=1)
    act_s = take(act)
    planes = [np.where(act_s, take(w), 0.0), act_s]
    planes += [take(mean[..., i]) for i in range(3)]
    planes += [take(cov[..., a, b]) for a in range(3) for b in range(a, 3)]
    return torch.tensor(np.stack(planes, axis=1), dtype=torch.float32,
                        device=dev)


# name: (P, N, K, options). Lanes: ~``frac`` active (default 0.6),
# weights descending along the lanes (the sorted contract; the argmax runs
# permute the lanes), means about ``centers`` centres (default 40) spread
# ``spread`` (default 0.3). Options: "one": one active lane a particle;
# "far": every lane its own centre, 1000 m apart; "nan": a NaN weight in
# particle 0 and NaN weights on a quarter of particle 1's active lanes
# (sorted mode: they never enter; argmax: the row stalls); "nonpos":
# w <= 0 on particle 2's heaviest half and on every lane of particle 3;
# "equal": every active weight 0.5 (argmax ties: the lowest lane leads);
# "degenerate": half the lanes without variance in their last coordinate
# (its covariance row and column 0, the mean on its centre there), a
# quarter without any (covariance 0, the mean on its centre), so that a
# pair of them hits the |det| > 1e-30 clamp of the 3D and 4D distances;
# "dims": the dimensions that run the case (default all; merge3d and
# merge4d only up to their narrow kernels' 2048 lanes)
MERGE_EDGES = {
    "no lane entering": (4, 512, 128, {"frac": 0.0}),
    "one lane": (4, 512, 128, {"one": True}),
    "all within min_sep of the first": (4, 512, 128,
                                        {"centers": 1, "spread": 0.01}),
    "every lane its own cluster, K binding": (4, 512, 16, {"far": True}),
    "NaN and w <= 0 weights": (8, 512, 128, {"nan": True, "nonpos": True}),
    "equal weights": (4, 512, 128, {"equal": True}),
    "N 2048": (64, 2048, 128, {}),
    "N 2049": (64, 2049, 128, {}),
    # every lane enters, 528 particles: 4 blocks an SM of 132, so the
    # shared-memory slots overflow (merge2d: L2; merge2d_tables: scratch)
    "N 8192 every lane entering": (528, 8192, 128, {"frac": 1.0}),
    "P 1": (1, 512, 128, {}),
    "degenerate covariance": (4, 512, 128, {"degenerate": True,
                                            "dims": (3, 4)}),
}


# the staged wide-lane variants' cases, in MERGE_EDGES' terms: just above
# merge2d's narrow 8192 lanes, and at its limit (the narrow kernel beside
# the staged one)
WIDE_EDGES = {
    "N 8448": (16, 8448, 128, {"dims": (2,)}),
    "N 8192": (16, 8192, 128, {"dims": (2,)}),
}


def edge_dims(name):
    """The dimensions D whose kernels run MERGE_EDGES[name]."""
    from phdslam_tpu_torch.kernels import merge
    # a checkout without the wide variants names its caps MAX_CANDIDATES
    narrow = getattr(merge, "NARROW_LANES", None) or merge.MAX_CANDIDATES
    P, N, K, opt = MERGE_EDGES[name]
    return tuple(D for D in opt.get("dims", (2, 3, 4)) if N <= narrow[D])


def _edge_lanes(name, seed, D=2):
    """(w, act, mean [P, N, D], cov [P, N, D, D], K) of MERGE_EDGES[name]
    (or WIDE_EDGES[name]), lanes weight-descending."""
    P, N, K, opt = MERGE_EDGES.get(name) or WIDE_EDGES[name]
    rng = np.random.default_rng(seed + N + 7 * P)
    n_c = N if opt.get("far") else opt.get("centers", 40)
    centers = rng.normal(0, 20, (P, n_c, D))
    if opt.get("far"):
        centers = np.zeros((P, N, D))
        centers[..., 0] = np.arange(N) * 1000.0
        which = np.broadcast_to(np.arange(N), (P, N))
    else:
        which = rng.integers(0, n_c, (P, N))
    on = centers[np.arange(P)[:, None], which]
    mean = on + rng.normal(0, opt.get("spread", 0.3), (P, N, D))
    A = rng.normal(0, 0.5, (P, N, D, D))
    cov = np.einsum("pnij,pnkj->pnik", A, A) + 0.3 * np.eye(D)
    w = -np.sort(-rng.uniform(0.01, 1.0, (P, N)), axis=1)
    act = rng.random((P, N)) < opt.get("frac", 0.6)
    if opt.get("one"):
        act = np.zeros((P, N), bool)
        act[np.arange(P), rng.integers(0, N, P)] = True
    if opt.get("equal"):
        w[:] = 0.5
    if opt.get("nan"):
        w[0, :] = np.nan
        w[1, rng.random(N) < 0.25] = np.nan
    if opt.get("nonpos"):
        w[2, :N // 2] = -0.5
        w[2, N // 2: N // 2 + 8] = 0.0
        w[3, :] = 0.0
    if opt.get("degenerate"):
        flat = rng.random((P, N)) < 0.5
        cov[flat, -1, :] = 0.0
        cov[flat, :, -1] = 0.0
        mean[flat, -1] = on[flat, -1]
        none = rng.random((P, N)) < 0.25
        cov[none] = 0.0
        mean[none] = on[none]
    return w, act, mean, cov, K


def merge_edge_case(name, sorted_w=True, seed=0, D=2):
    """(packed [P, C, N] f32 numpy, K) of MERGE_EDGES[name] at dimension D
    (C = 7, 11, 16: w, act, the mean planes, the upper-triangle covariance
    planes): lanes weight-descending for sorted mode, in a fixed random
    order for argmax mode."""
    w, act, mean, cov, K = _edge_lanes(name, seed, D)
    planes = np.stack([np.where(act, w, 0.0), act]
                      + [mean[..., i] for i in range(D)]
                      + [cov[..., a, b] for a in range(D)
                         for b in range(a, D)], axis=1)
    if not sorted_w:
        perm = np.random.default_rng(seed).permutation(planes.shape[2])
        planes = planes[:, :, perm]
    return np.ascontiguousarray(planes, dtype=np.float32), K


def tables_edge_case(name, seed=0):
    """(ints [P, 4, N] int32, flts [P, 2, N], t_k [P, 16, N], t_m [P, 8, 8],
    K) of MERGE_EDGES[name] as merge2d_tables' operands (numpy): feature
    column j holds lane j's mean and covariance, with small gains and an
    updated covariance near it; lanes persistent (1/2), detections (3/10,
    their measurement column drawn from 8, one in eight out of range: it
    reads 0) or births (1/5, measurement columns whose birth means sit at
    the first lanes' means). sel_act is the edge's act; cand_w its
    weights."""
    w, act, mean, cov, K = _edge_lanes(name, seed)
    P, N = w.shape
    Mt = 8
    rng = np.random.default_rng(seed + 1)
    t_k = np.zeros((P, 16, N))
    t_k[:, 0], t_k[:, 1] = mean[..., 0], mean[..., 1]
    t_k[:, 2], t_k[:, 3] = cov[..., 0, 0], cov[..., 0, 1]
    t_k[:, 4], t_k[:, 5] = cov[..., 1, 0], cov[..., 1, 1]
    t_k[:, 6:10] = 0.9 * t_k[:, 2:6]
    t_k[:, 10:14] = rng.normal(0, 0.01, (P, 4, N))
    t_k[:, 14] = rng.uniform(1, 10, (P, N))
    t_k[:, 15] = rng.uniform(-np.pi, np.pi, (P, N))
    t_m = np.zeros((P, Mt, Mt))
    t_m[:, 0] = rng.uniform(1, 10, (P, Mt))
    t_m[:, 1] = rng.uniform(-np.pi, np.pi, (P, Mt))
    t_m[:, 2:4] = mean[:, :Mt].transpose(0, 2, 1)
    t_m[:, 4], t_m[:, 7] = 0.5, 0.5
    kind = rng.choice(3, (P, N), p=(0.5, 0.3, 0.2))
    m_eff = rng.integers(0, Mt, (P, N))
    m_eff[(kind == 1) & (rng.random((P, N)) < 0.125)] = Mt
    ints = np.stack([np.broadcast_to(np.arange(N), (P, N)), m_eff,
                     kind == 0, kind == 1], axis=1).astype(np.int32)
    flts = np.stack([np.nan_to_num(w, nan=0.0), act], axis=1)
    return (ints, flts.astype(np.float32), t_k.astype(np.float32),
            t_m.astype(np.float32), K)


# ----------------------------------------------------------------------------
# bounds, the round count and the comparison with the twin
# ----------------------------------------------------------------------------

def merge_bound(packed, K, c_out, flop_per_lane):
    """A merge's bound on this input: it must read the act plane and, for
    the lanes that enter (act, and w > 0 in sorted mode; counted as act
    here), the other planes once, write its [P, c_out, K] planes, and
    evaluate each entering lane's distance and moments at least once."""
    P, C, N = packed.shape
    live = int((packed[:, 1] > 0.5).sum())
    return bound(4 * (P * N + live * (C - 1) + P * c_out * K),
                 flop_per_lane * live)


def tables_bound(ints, flts, K, flop_per_lane):
    """The fused merge's bound on this input: it must read the sel_act
    plane, and for each entering lane (sel_act and w > 0) its weight, its
    four ints and the 8 table values it combines; write [P, 8, K]; and
    evaluate each entering lane's distance and moments at least once."""
    P, _, N = ints.shape
    live = int(((flts[:, 1] > 0.5) & (flts[:, 0] > 0)).sum())
    return bound(4 * (P * N + 13 * live + P * 8 * K), flop_per_lane * live)


def merge_rounds(packed, min_sep, K, sorted_w=True, metric=0,
                 R=ROUND_PRINCIPALS):
    """Replays the kernels' round-based greedy chain on packed planes
    [P, C, N] of any dimension D (C = 7, 11, 16 at D = 2, 3, 4; any
    device): each round takes the R lowest unmerged lanes (sorted) or the
    R heaviest with w > 0, ties to the lowest lane (argmax, D = 2; a row
    with an unmerged NaN weight stalls) as tentative principals;
    principal r is valid when no earlier valid principal covers it; the
    first K - c valid ones emit their clusters, and a lane joins the first
    that covers it. The distance is the kernel's: Mahalanobis (2D, or the
    closed forms of merge3d and merge4d) or Hellinger (``metric`` 1).
    Returns per-particle int64 tensors (entering lanes, clusters, rounds
    that emitted). The clusters equal the sequential merge's (the twin's
    n_merged)."""
    from phdslam_tpu_torch.ops.gm_merge import unpack_planes
    from phdslam_tpu_torch.ops.math import (hellinger2, mahalanobis2,
                                            mahalanobis2_3d,
                                            mahalanobis2_4d)
    D = MERGE_DIMS[packed.shape[1]]
    dist = hellinger2 if metric else {2: mahalanobis2, 3: mahalanobis2_3d,
                                      4: mahalanobis2_4d}[D]
    mean, cov, w, act = unpack_planes(packed, D)
    P, N = w.shape
    dev = w.device
    unmerged = act.clone() if not sorted_w else act & (w > 0)
    enter = unmerged.sum(dim=1)
    lanes = torch.arange(N, device=dev)
    rows = torch.arange(P, device=dev)[:, None]
    c = torch.zeros(P, dtype=torch.int64, device=dev)
    rounds = torch.zeros_like(c)
    while True:
        if sorted_w:
            key = torch.where(unmerged, lanes.to(w.dtype), float("inf"))
            has_key = unmerged
        else:
            ok = unmerged & (w > 0)
            key = torch.where(ok, -w, float("inf"))
            has_key = ok
        order = torch.sort(key, dim=1, stable=True).indices[:, :R]
        has = torch.gather(has_key, 1, order)                    # [P, R]
        if not sorted_w:
            stall = (unmerged & torch.isnan(w)).any(dim=1)
            has &= ~stall[:, None]
        pm, pc = mean[rows, order], cov[rows, order]             # [P, R, ..]
        # pair[p, s, r]: lane r of the tentatives against principal s
        pair = dist(pm[:, :, None], pc[:, :, None], pm[:, None], pc[:, None])
        valid = torch.zeros_like(has)
        for r in range(order.shape[1]):
            covered = (valid[:, :r] & (pair[:, :r, r] < min_sep)).any(dim=1)
            valid[:, r] = has[:, r] & ~covered
        budget = (K - c)[:, None]
        emit = valid & (torch.cumsum(valid.long(), dim=1) <= budget)
        n_emit = emit.sum(dim=1)
        if not bool((n_emit > 0).any()):
            break
        d = dist(pm[:, :, None], pc[:, :, None], mean[:, None], cov[:, None])
        cover = ((d < min_sep) | (lanes[None, None] == order[..., None])) \
            & emit[..., None] & unmerged[:, None]                 # [P, R, N]
        unmerged &= ~cover.any(dim=1)
        c += n_emit
        rounds += n_emit > 0
    return enter, c, rounds


def round_stats(enter, trips, rounds):
    """Entering lanes, clusters (trips) and rounds a particle (mean, min,
    max of each) and the valid principals a round."""
    def stats(x):
        x = x.double()
        return {"mean": float(x.mean()), "min": int(x.min()),
                "max": int(x.max())}
    n_rounds = int(rounds.sum())
    return {"entering": stats(enter), "trips": stats(trips),
            "rounds": stats(rounds),
            "valid_a_round": float(trips.sum()) / n_rounds if n_rounds
            else 0.0}


def check_merge(got, want, label, D=2):
    """A merge's output planes [P, C, K] at dimension D against its twin's:
    equal cluster and leftover counts, rtol 1e-4 / atol 1e-5 on weights,
    means and covariances. Returns (max |err|, clusters a particle)."""
    from phdslam_tpu_torch.ops.gm_merge import merge_out
    g, w = merge_out(got, D), merge_out(want, D)
    require(torch.equal(g[3], w[3]), f"{label}: n_merged differs")
    require(torch.equal(g[4], w[4]), f"{label}: n_unmerged differs")
    for a, b in zip(g[:3], w[:3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    return max_err(list(zip(g[:3], w[:3]))), g[3]


def boundary_flip(row, sep, got, want, metric=0):
    """Whether one particle's merge outputs, the kernel's ``got`` and the
    twin's ``want`` (merge tuples of that row), part only where a lane
    lies at the merge threshold: replaying the twin's greedy rounds (its
    f32 distance) up to the first cluster that differs, the two clusters'
    weights must differ by the weight of lanes whose float64 distance to
    that cluster's principal is within 1e-5 of min_sep (an f32 quotient
    at min_sep decided in another order: the kernel evaluates the Pallas
    kernel's closed form in strict IEEE f32, the twin inverts the averaged
    covariance first). Returns (explained, the cluster, those lanes'
    distances). Any dimension (the planes' count says which) and either
    metric (``metric`` 1: Hellinger)."""
    from phdslam_tpu_torch.ops.gm_merge import unpack_planes
    from phdslam_tpu_torch.ops.math import (hellinger2, mahalanobis2,
                                            mahalanobis2_3d,
                                            mahalanobis2_4d)
    D = MERGE_DIMS[row.shape[0]]
    dist = hellinger2 if metric else {2: mahalanobis2, 3: mahalanobis2_3d,
                                      4: mahalanobis2_4d}[D]
    mean, cov, w, act = unpack_planes(row[None], D)
    mean, cov, w = mean[0], cov[0], w[0]
    unmerged = act[0] & (w > 0)
    off = ((got[0] - want[0]).abs().amax(-1) > 1e-5 + 1e-4 * want[0].abs()
           .amax(-1)) | ((got[2] - want[2]).abs() > 1e-5 + 1e-4 * want[2])
    c = int(torch.nonzero(off)[0])
    for k in range(c + 1):
        i = int(torch.argmax(torch.where(unmerged, w, -torch.inf)))
        d = dist(mean[i][None], cov[i][None], mean, cov)
        sel = (unmerged & (d < sep)) | (torch.arange(len(w)) == i)
        if k < c:
            unmerged &= ~sel
    d64 = dist(mean[i][None].double(), cov[i][None].double(), mean.double(),
               cov.double())
    edge = unmerged & ((d64 - sep).abs() <= 1e-5 * sep)
    gap = abs(float(got[2][c]) - float(want[2][c]))
    explained = bool(edge.any()) and gap <= float(w[edge].sum()) * 1.0001 \
        + 1e-7
    return explained, c, [round(float(x), 9) for x in d64[edge]]


def check_merge_rows(got, want, packed, sep, label, metric=0):
    """A merge's outputs ``got`` against the twin's ``want`` (merge
    tuples) on the same planes: equal cluster and leftover counts and
    rtol 1e-4 / atol 1e-5 in every particle, except a particle whose two
    merges part at a lane on the merge threshold (:func:`boundary_flip`).
    Returns the count of such particles and the largest |difference| of
    the others."""
    got = [x.cpu() for x in got]
    close = torch.ones(got[2].shape[0], dtype=torch.bool)
    for g, w in zip(got[:3], want[:3]):
        ok = torch.isclose(g, w, rtol=1e-4, atol=1e-5)
        close &= ok.reshape(ok.shape[0], -1).all(dim=1)
    close &= (got[3] == want[3]) & (got[4] == want[4])
    flips = []
    for p in torch.nonzero(~close)[:, 0].tolist():
        explained, c, dists = boundary_flip(
            packed[p].cpu(), sep, [x[p] for x in got], [x[p] for x in want],
            metric)
        require(explained, f"{label}: particle {p} parts from the twin at "
                f"cluster {c} with no lane at the merge threshold")
        flips.append((p, c, dists))
    err = max_err([(g[close], w[close]) for g, w in zip(got[:3], want[:3])])
    return flips, err


# ----------------------------------------------------------------------------
# the timed cases
# ----------------------------------------------------------------------------

# name: (source, sorted_w, metric). source: ("packed", maker) on
# merge_inputs / full_grid_inputs at their defaults, merge4d_inputs at
# N=128 (K=128, min_sep 2) or merge3d_inputs at N=512 (K=24, min_sep 20),
# the shapes of the mixed and disparity paths; ("tables", config, P, K, M,
# valid) on eval/scenes.py::tables_payload (seed 0; the packed variant
# merges the two-kernel route's planes of the same tables); or
# ("captured", run) from detect_bench.capture_step
_ACK_TABLES = ("tables", "cfg/ackerman.cfg", 512, 128, 48, 44)
_DENSE_TABLES = ("tables", "cfg/dense.cfg", 1024, 1024, 72, 65)
MERGE_TIMED = {
    "merge2d": (("packed", "merge"), True, 0),
    "merge2d_hellinger": (("packed", "merge"), True, 1),
    "merge2d_argmax": (("packed", "full grid"), False, 0),
    "merge2d_argmax_hellinger": (("packed", "full grid"), False, 1),
    "merge2d_tables": (_ACK_TABLES, True, 0),
    "merge2d_tables_hellinger": (_ACK_TABLES, True, 1),
    "merge2d dense": (("packed", _DENSE_TABLES), True, 0),
    "merge2d_tables dense": (_DENSE_TABLES, True, 0),
    "merge2d captured": (("captured", "ackerman"), True, 0),
    "merge2d dense captured": (("captured", "dense"), True, 0),
    "merge2d_tables dense captured": (("captured",
                                       "dense fused + adaptive"), True, 0),
    "merge2d_argmax full grid captured": (("captured", "full grid"), False,
                                          0),
    "merge4d": (("packed", "merge4d"), True, 0),
    "merge3d": (("packed", "merge3d"), True, 0),
    "merge4d mixed captured": (("captured", "mixed"), True, 0),
    "merge3d disparity captured": (("captured", "disparity"), True, 0),
    # the staged wide-lane variants where the paths launch them: the mixed
    # full grid's dynamic map (step 40 of the mixed bench with both caps 0,
    # P=512, N=4256) and the dense full grid's whole launch (step 20 of
    # data/dense with cap 0, P=1024, N=74 824), both in argmax mode
    "merge4d_argmax_wide mixed full grid captured": (
        ("captured", "mixed full grid"), False, 0),
    "merge2d_argmax_wide dense full grid captured": (
        ("captured", "dense full grid"), False, 0),
}
# the staged variants on WIDE_EDGES, timed: every merge2d variant and both
# merge2d_tables metrics above the narrow limit (N 8448), and forced at it
# (N 8192)
WIDE_TIMED = tuple(WIDE_EDGES)


def _scene_tables(dev, source):
    """(gather dict, tables operands, K) of a ("tables", ...) source."""
    from phdslam_tpu_torch import load_config
    from phdslam_tpu_torch.eval.scenes import map_scene, tables_payload
    _, path, P, K, M, n_valid = source
    cfg = load_config(path)
    g, ints, flts = tables_payload(cfg, map_scene(cfg, P, K, M, n_valid,
                                                  seed=0, device=dev))
    return g, (ints, flts, g["t_k"], g["t_m"]), K


def tables_planes(tabs):
    """The packed planes the two-kernel route merges for merge2d_tables'
    operands (kernels/merge.py::tables_packed), or None in a checkout
    that has no tables_packed."""
    from phdslam_tpu_torch.kernels import merge
    if not hasattr(merge, "tables_packed"):
        return None
    return merge.tables_packed(*tabs)


def kept_capture(dev, run, keep=None):
    """capture_step(dev, run), or with ``keep`` (a directory) the capture
    kept there by an earlier run, written there when there is none: the
    staged merges' paths feed their own outputs forward, so two checkouts
    whose kernels part in the last bits capture different steps; kept, both
    merge the same inputs."""
    if keep is None:
        return capture_step(dev, run)
    import os
    path = os.path.join(keep, run.replace(" ", "_") + ".pt")
    if os.path.exists(path):
        calls, step = torch.load(path, map_location=dev)
        return calls, step
    calls, step = capture_step(dev, run)
    os.makedirs(keep, exist_ok=True)
    torch.save((calls, step), path)
    return calls, step


def timed_case(dev, name, captured, keep=None):
    """(tables operands or None, packed planes or None, K, min_sep,
    sorted_w, metric, step) of MERGE_TIMED[name]: a tables case has the
    operands and no planes. ``keep``: :func:`kept_capture`'s directory."""
    from phdslam_tpu_torch.filters.phd import _finish_candidates_packed
    source, sorted_w, metric = MERGE_TIMED[name]
    sep = HELL_SEP if metric else MIN_SEP
    if source[0] == "captured":
        if source[1] not in captured:
            captured[source[1]] = kept_capture(dev, source[1], keep)
        calls, step = captured[source[1]]
        for name in ("merge3d", "merge4d"):
            if name in calls:
                (packed, sep, K), kw = calls[name]
                return (None, packed, K, sep, kw.get("sorted_w", True),
                        kw.get("metric", 0), step)
        if "merge2d_tables" in calls:
            args, kw = calls["merge2d_tables"]
            return (tuple(args[:4]), None, args[5], args[4], True,
                    kw.get("metric", 0), step)
        args, kw = calls["merge2d"]
        return (None, args[0], args[2], args[1], kw.get("sorted_w", True),
                kw.get("metric", 0), step)
    if source[0] == "tables":
        _, tabs, K = _scene_tables(dev, source)
        return tabs, None, K, sep, True, metric, None
    if source[1] == "merge":
        return None, merge_inputs(dev), 128, sep, sorted_w, metric, None
    if source[1] == "full grid":
        return None, full_grid_inputs(dev), 128, sep, sorted_w, metric, None
    if source[1] == "merge4d":
        return (None, merge4d_inputs(dev, N=128, seed=128), 128, MIXED_SEP,
                True, 0, None)
    if source[1] == "merge3d":
        return None, merge3d_inputs(dev, seed=24), 24, DISP_SEP, True, 0, None
    # the dense scene's candidates through the two-kernel route
    g, _, K = _scene_tables(dev, source[1])
    return (None, _finish_candidates_packed(g, 2), K, sep, sorted_w, metric,
            None)


def plan_of(P, N, sorted_w, metric, tables, D=2, wide=None):
    """The checkout's launch plan (None where it reports none)."""
    from phdslam_tpu_torch.kernels import merge
    kw = {} if wide is None else {"wide": wide}
    if D != 2:
        if not hasattr(merge, "merge_plan"):
            return None
        if sorted_w and metric == 0 and not kw:
            return merge.merge_plan(D, P, N)
        return merge.merge_plan(D, P, N, sorted_w=sorted_w, metric=metric,
                                **kw)
    if not hasattr(merge, "merge2d_plan"):
        return None
    return merge.merge2d_plan(P, N, sorted_w, metric, tables, **kw)


def wide_runs(dev):
    """(label, tables operands or None, packed, K, min_sep, sorted_w,
    metric, wide) of WIDE_TIMED: each case in every merge2d variant and in
    merge2d_tables at both metrics, the staged variant forced where the
    case is within the narrow kernel's lanes."""
    from phdslam_tpu_torch.kernels.merge import NARROW_LANES
    runs = []
    for name in WIDE_TIMED:
        N = WIDE_EDGES[name][1]
        wide = True if N <= NARROW_LANES[2] else None
        for sorted_w in (True, False):
            planes, K = merge_edge_case(name, sorted_w)
            packed = torch.from_numpy(planes).to(dev)
            for metric in (0, 1):
                runs.append((f"wide {name} merge2d sorted_w={sorted_w} "
                             f"metric={metric}", None, packed, K,
                             HELL_SEP if metric else MIN_SEP, sorted_w,
                             metric, wide))
        *tabs, K = tables_edge_case(name)
        tabs = tuple(torch.from_numpy(x).to(dev) for x in tabs)
        for metric in (0, 1):
            runs.append((f"wide {name} merge2d_tables metric={metric}", tabs,
                         None, K, HELL_SEP if metric else MIN_SEP, True,
                         metric, wide))
    return runs


def case_bound(tabs, packed, K, metric):
    """(bound ms, what bounds it) of a case: merge_bound at the kernel's
    output planes and f32 operations per entering lane (2D: 27
    Mahalanobis, 40 Hellinger; 3D: 70; 4D: 120), or tables_bound."""
    if tabs is not None:
        return tables_bound(tabs[0], tabs[1], K, 40 if metric else 27)
    D = MERGE_DIMS[packed.shape[1]]
    flops = {2: 40 if metric else 27, 3: 70, 4: 120}[D]
    return merge_bound(packed, K, OUT_PLANES[D], flops)


def entering_planes(packed):
    """The planes with only the lanes whose act > 0.5, in lane order,
    padded with inactive lanes to the largest count: no other lane enters
    a merge in either mode, so every merge gives the same output on them
    (the twin and the round replay at the full grid's 74 824 lanes)."""
    act = packed[:, 1] > 0.5
    n = max(int(act.sum(dim=1).max()), 1)
    order = torch.sort((~act).to(torch.int8), dim=1, stable=True).indices
    out = torch.gather(packed, 2, order[:, None, :n].expand(
        -1, packed.shape[1], -1))
    keep = torch.gather(act, 1, order[:, :n])[:, None]
    D = MERGE_DIMS[packed.shape[1]]
    blank = torch.zeros_like(out[:1, :, :1])
    for q, (a, b) in enumerate((a, b) for a in range(D)
                               for b in range(a, D)):
        blank[:, 2 + D + q] = float(a == b)
    return torch.where(keep, out, blank).contiguous()


# above this many lanes the twin and the round replay run on
# :func:`entering_planes`
TWIN_COMPACT_LANES = 8192


def run_case(tabs, packed, K, sep, sorted_w, metric, label, wide=None):
    """One merge call against its twin (``wide=True``: the staged variant
    forced). Returns (fn, launch name, output, max |err|)."""
    from phdslam_tpu_torch.kernels import build
    from phdslam_tpu_torch.kernels import merge
    from phdslam_tpu_torch.kernels.merge import (merge2d, merge2d_reference,
                                                 merge2d_tables,
                                                 merge2d_tables_reference,
                                                 merge2d_variant)
    D = 2 if tabs is not None else MERGE_DIMS[packed.shape[1]]
    kw_w = {} if wide is None else {"wide": wide}
    twin_in = packed
    if packed is not None and packed.shape[2] > TWIN_COMPACT_LANES:
        twin_in = entering_planes(packed)
    if D != 2 and sorted_w and metric == 0:
        kern = getattr(merge, f"merge{D}d")

        def fn():
            return kern(packed, sep, K, **kw_w)
        want = getattr(merge, f"merge{D}d_reference")(twin_in, sep, K)
        name = f"merge{D}d"
    elif D != 2:
        # the variants of merge.VARIANTS_3D4D (argmax 4D, Hellinger 3D/4D)
        kern = getattr(merge, f"merge{D}d")
        ref = getattr(merge, f"merge{D}d_reference")
        kw = dict(metric=metric) if D == 3 else dict(sorted_w=sorted_w,
                                                     metric=metric)

        def fn():
            return kern(packed, sep, K, **kw, **kw_w)
        want = ref(twin_in, sep, K, **kw)
        name = merge2d_variant(sorted_w, metric, D=D)
    elif tabs is not None:
        def fn():
            return merge2d_tables(*tabs, sep, K, metric, **kw_w)
        want = merge2d_tables_reference(*tabs, sep, K, metric)
        name = merge2d_variant(True, metric, tables=True)
    else:
        def fn():
            return merge2d(packed, sep, K, sorted_w, metric, **kw_w)
        want = merge2d_reference(twin_in, sep, K, sorted_w, metric)
        name = merge2d_variant(sorted_w, metric)
    N = (packed if tabs is None else tabs[0]).shape[2]
    if wide or (wide is None and hasattr(merge, "NARROW_LANES")
                and N > merge.NARROW_LANES[D]):
        name += "_wide"
    build.reset_launch_counts()
    got = fn()
    torch.cuda.synchronize()
    require(dict(build.launch_counts) == {name: 1},
            f"{label}: launched {dict(build.launch_counts)}, not {name}")
    if name.endswith("_wide"):
        # the staged variants' gate (another order of the sums): a row may
        # part from the twin only at a lane on the merge threshold
        from phdslam_tpu_torch.ops.gm_merge import merge_out
        planes = twin_in if tabs is None else tables_planes(tabs)
        _, err = check_merge_rows(merge_out(got, D),
                                  [x.cpu() for x in merge_out(want, D)],
                                  planes, sep, label, metric)
    else:
        err, _ = check_merge(got, want, label, D)
    return fn, name, got, err


def edge_runs(dev, names=tuple(MERGE_EDGES)):
    """(label, tables operands or None, packed, K, min_sep, sorted_w,
    metric) of the MERGE_EDGES cases ``names`` in every merge2d variant,
    in merge2d_tables at both metrics, and in merge3d and merge4d (at
    MIN_SEP; where the checkout builds them, also merge4d's argmax mode on
    the lanes in a random order and both Hellinger variants at HELL_SEP),
    as far as each runs the case (:func:`edge_dims`)."""
    from phdslam_tpu_torch.kernels import merge
    variants = getattr(merge, "VARIANTS_3D4D", {})
    runs = []
    for name in names:
        for D in (d for d in edge_dims(name) if d != 2):
            planes, K = merge_edge_case(name, True, D=D)
            runs.append((f"edge {name} merge{D}d", None,
                         torch.from_numpy(planes).to(dev), K, MIN_SEP, True,
                         0))
            for sorted_w, metric in variants.get(D, ()):
                if sorted_w and metric == 0:
                    continue
                lanes, K = merge_edge_case(name, sorted_w, D=D)
                runs.append((f"edge {name} "
                             f"{merge.merge2d_variant(sorted_w, metric, D=D)}",
                             None, torch.from_numpy(lanes).to(dev), K,
                             HELL_SEP if metric else MIN_SEP, sorted_w,
                             metric))
        if 2 not in edge_dims(name):
            continue
        for sorted_w in (True, False):
            planes, K = merge_edge_case(name, sorted_w)
            packed = torch.from_numpy(planes).to(dev)
            for metric in (0, 1):
                runs.append((f"edge {name} merge2d sorted_w={sorted_w} "
                             f"metric={metric}", None, packed, K,
                             HELL_SEP if metric else MIN_SEP, sorted_w,
                             metric))
        *tabs, K = tables_edge_case(name)
        tabs = tuple(torch.from_numpy(x).to(dev) for x in tabs)
        for metric in (0, 1):
            runs.append((f"edge {name} merge2d_tables metric={metric}", tabs,
                         None, K, HELL_SEP if metric else MIN_SEP, True,
                         metric))
    return runs


def main():
    ap = bench_parser(__doc__)
    ap.add_argument("--out", help="also write the JSON lines to this file")
    ap.add_argument("--expect", help="JSON lines of another run whose "
                    "output digests every case must repeat")
    ap.add_argument("--expect-counts", help="JSON lines of another run "
                    "whose cluster and leftover counts every case must "
                    "repeat (counts_sha)")
    ap.add_argument("--keep", help="directory of captured steps shared "
                    "between runs (kept_capture)")
    ap.add_argument("--only", help="run only the cases whose name holds "
                    "this text")
    args = ap.parse_args()
    card = open_checkout("merge_bench.py", args.root)
    from phdslam_tpu_torch.ops.gm_merge import merge_out
    expect = {}
    if args.expect:
        with open(args.expect) as f:
            expect = {d["case"]: d["out_sha"] for d in map(json.loads, f)}
    expect_counts = {}
    if args.expect_counts:
        with open(args.expect_counts) as f:
            expect_counts = {d["case"]: d.get("counts_sha")
                             for d in map(json.loads, f)}
    dev = torch.device("cuda:0")
    captured = {}
    lines = []
    mismatched = []

    def emit(line):
        line["matches_expected"] = None
        # a case the other run has no line for (a variant its checkout
        # does not build) is not compared
        if expect and line["case"] in expect:
            line["matches_expected"] = expect.get(line["case"]) == line[
                "out_sha"]
            if not line["matches_expected"]:
                mismatched.append(line["case"])
        if expect_counts and line["case"] in expect_counts:
            line["counts_match"] = expect_counts[line["case"]] == line.get(
                "counts_sha")
            if not line["counts_match"]:
                mismatched.append(f"{line['case']} (counts)")
        lines.append(json.dumps(line))
        print(lines[-1], flush=True)

    def counts_sha(got, D):
        return digest(merge_out(got, D)[3:5])

    def chosen(case):
        return args.only is None or args.only in case
    timed = [(name, *timed_case(dev, name, captured, args.keep), None)
             for name in MERGE_TIMED if chosen(name)]
    timed += [(label, tabs, packed, K, sep, sorted_w, metric, None, wide)
              for label, tabs, packed, K, sep, sorted_w, metric, wide
              in wide_runs(dev) if chosen(label)]
    for name, tabs, packed, K, sep, sorted_w, metric, step, wide in timed:
        fn, launched, got, err = run_case(tabs, packed, K, sep, sorted_w,
                                          metric, name, wide)
        calls_ms = [time_call(fn) for _ in range(2)]
        b_ms, b_by = case_bound(tabs, packed, K, metric)
        if tabs is not None:
            P, _, N = tabs[0].shape
            packed = tables_planes(tabs)
        else:
            P, _, N = packed.shape
        D = 2 if packed is None else MERGE_DIMS[packed.shape[1]]
        stats = None if packed is None else round_stats(*merge_rounds(
            entering_planes(packed) if N > TWIN_COMPACT_LANES else packed,
            sep, K, sorted_w, metric))
        emit({"label": args.label, "case": name, "launched": launched,
              "step": step, "P": P, "N": N, "K": K, "min_sep": sep,
              "call_ms": min(calls_ms), "graph_ms": graph_ms(fn),
              "bound_ms": b_ms, "bound_by": b_by, "lanes": stats,
              "plan": plan_of(P, N, sorted_w, metric, tabs is not None, D,
                              wide),
              "max_abs_err": err, "out_sha": digest((got,)),
              "counts_sha": counts_sha(got, D),
              "in_sha": digest(tabs if tabs is not None else (packed,)),
              "card": card})
        del fn, got
    failed = []
    for label, tabs, packed, K, sep, sorted_w, metric in edge_runs(dev):
        if not chosen(label):
            continue
        P, _, N = (packed if tabs is None else tabs[0]).shape
        try:
            _, launched, got, err = run_case(tabs, packed, K, sep, sorted_w,
                                             metric, label)
        except (AssertionError, RuntimeError, ValueError) as e:
            # the case is reported and the rest still run
            failed.append(label)
            emit({"label": args.label, "case": label, "P": P, "N": N,
                  "K": K, "error": str(e)[:300], "out_sha": None,
                  "card": card})
            continue
        if tabs is not None:
            packed = tables_planes(tabs)
        D = 2 if packed is None else MERGE_DIMS[packed.shape[1]]
        stats = None if packed is None else round_stats(
            *merge_rounds(packed, sep, K, sorted_w, metric))
        emit({"label": args.label, "case": label, "launched": launched,
              "P": P, "N": N, "K": K, "lanes": stats,
              "plan": plan_of(P, N, sorted_w, metric, tabs is not None, D),
              "max_abs_err": err, "out_sha": digest((got,)),
              "counts_sha": counts_sha(got, D), "card": card})
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(f"{line}\n" for line in lines))
    if failed or mismatched:
        sys.exit(f"merge_bench.py: failed at {failed}; outputs differ from "
                 f"{args.expect} at {mismatched}")


if __name__ == "__main__":
    main()
