"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips without a GPU. This file imports no jax,
so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest`` because tests/conftest.py imports jax for the JAX
package's tests.) Shapes are the Ackerman main path's: K=128, M=48, T=16,
merge_candidate_cap=512, the mixed path's: M=32, detect at min_fw=0 and
cb=0, the 4D merge at N=128 (the dynamic map's cap) and N=512, and the
disparity path's: the 3D merge at K=24 over N=512 (the compacted cap) and
N=624 (every lane of K + M K + M at M=24), and the full-grid route's: the
2D merge in argmax mode over N=6320 (K + M K + M at K=128, M=48) and at
its limit N=8192, with either metric, the Hellinger metric in both modes,
and sorted mode over N=4096. The knob variants run at the Ackerman shapes
and the dense configuration's (K=1024, M=72, T=32, cap 1536): the detect
kernel with adaptive trips and with pre-consolidation, the fused gather +
merge against the two-kernel route on the card, and the row gather. Both
gathers run at the paths' shapes and at ragged, unaligned, out-of-range
and above-budget cases, in both their modes. The detect kernel runs at
the selection's edges (``detect_bench.DETECT_EDGES``) in all four
variants, and the merge kernels at theirs (``merge_bench.MERGE_EDGES``:
merge2d's four variants, merge2d_tables in both metrics, merge3d and
merge4d, merge4d's argmax mode and both Hellinger variants), with the
launch plan of every path's merge shape one wave. merge4d's argmax mode
runs on lanes in a random order with w <= 0 lanes, a NaN row and a
binding out_cap, and the 3D / 4D Hellinger variants on sorted lanes, each
against its twin. The staged wide-lane variants (every merge mode
just above its narrow kernel's width, merge2d_tables at N=8448, detect at
K=2048 in all four modes and at K=1500 with trips) run against their
twins, detect also against the same call on the CPU, and each beside its
narrow kernel at the narrow limit (N=8192, 2048, K=1024); the staged
merges also where entries lie past a block's shared ones and over many
compacting rounds (P=264 / 528), detect_wide through both of its
candidate routes at K=2048, and the consolidating wide variant with its
planes staged (K=2048) and read from device memory (K=8192), each also
at min_fw 0, where a row's candidates overflow the warp's buffer and
the fall-back walks run. The spatially
tiled merge's gather_cols and merge2d launches run at its tile rows
([4 P, 7, ct], ct 128, 256 and 384) against their twins. The
resampling's fixed-order cumsum repeats its bits at P=10240, and the
CPHD cardinality prediction its twin's bits at P=512 and 10240 (whole, in
blocks and row by row) and at C1 33 and 257. A single-device dense step
makes no synchronizing call (the sync debug mode at "error").
"""

import numpy as np
import pytest
import torch

from detect_bench import (DETECT_EDGES, MIN_SEP_EDGES, compare_detect,
                          detect_edge_case)
from gather_bench import GATHER_CASES, gather_case
from phdslam_tpu_torch import load_config
from phdslam_tpu_torch.eval.scenes import (detect_planes, map_scene,
                                           tables_payload)
from phdslam_tpu_torch.filters.phd import _finish_candidates_packed
from phdslam_tpu_torch.filters import cphd as tcphd
from phdslam_tpu_torch.kernels import build
from phdslam_tpu_torch.kernels.cardinality import (
    cardinality_predict_batch, cardinality_predict_reference)
from phdslam_tpu_torch.kernels.detect import (detect, detect_reference,
                                              detect_variant,
                                              detect_wide_plan)
from phdslam_tpu_torch.kernels.gather_cols import (gather_cols,
                                                   gather_cols_reference)
from phdslam_tpu_torch.kernels.gather_rows import (gather_rows,
                                                   gather_rows_reference)
from merge_bench import (MERGE_EDGES, check_merge_rows, edge_runs,
                         run_case, tables_edge_case)
from phdslam_tpu_torch.kernels.merge import (NARROW_LANES, VARIANTS_3D4D,
                                             merge2d,
                                             merge2d_plan, merge2d_reference,
                                             merge2d_tables,
                                             merge2d_tables_reference,
                                             merge2d_variant, merge3d,
                                             merge3d_reference, merge4d,
                                             merge4d_reference, merge_plan,
                                             recip_check)
from phdslam_tpu_torch.ops import gm_merge as tgm
from phdslam_tpu_torch.ops.gm_merge import merge_out
from phdslam_tpu_torch.ops.resample import cumsum_fixed_order

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The first GPU; decided at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda:0")


def detect_inputs(dev, P=64, K=128, M=48, n_valid=40, seed=0):
    rng = np.random.default_rng(seed)
    planes = np.stack([
        rng.uniform(1, 10, (P, K)), rng.uniform(-np.pi, np.pi, (P, K)),
        rng.uniform(0.5, 4.0, (P, K)), rng.uniform(-0.2, 0.2, (P, K)),
        rng.uniform(0.5, 4.0, (P, K)),
        np.where(rng.uniform(size=(P, K)) < 0.7,
                 rng.uniform(0.01, 1.0, (P, K)), 0.0)], axis=1)
    z4 = np.stack([rng.uniform(1, 10, M), rng.uniform(-np.pi, np.pi, M),
                   (np.arange(M) < n_valid).astype(float), np.zeros(M)],
                  axis=1)
    return (torch.tensor(planes, dtype=torch.float32, device=dev),
            torch.tensor(z4, dtype=torch.float32, device=dev))


def merge_inputs(dev, P=32, N=512, seed=0):
    """Clustered candidates; active lanes a weight-descending prefix."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 20, (P, 40, 2))
    mean = centers[np.arange(P)[:, None], rng.integers(0, 40, (P, N))] \
        + rng.normal(0, 0.3, (P, N, 2))
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


def full_grid_inputs(dev, P=16, N=6320, seed=0, frac=0.1, n_centers=40):
    """The full grid's merge planes: ~``frac`` of the lanes active, spread
    over the lane axis in no weight order, clustered means (spread 0.3
    about ``n_centers`` centres), covariances 0.3 I + A A'."""
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


def assert_merge_matches(planes, min_sep, K, sorted_w=True, metric=0):
    """Kernel against twin: one launch counted under the variant's name,
    equal cluster and leftover counts, rtol 1e-4 / atol 1e-5 on weights,
    means and covariances. Returns the kernel's merge tuple."""
    build.reset_launch_counts()
    got = merge_out(merge2d(planes, min_sep, K, sorted_w, metric), 2)
    assert build.launch_counts[merge2d_variant(sorted_w, metric)] == 1
    want = merge_out(merge2d_reference(planes, min_sep, K, sorted_w, metric),
                     2)
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    return got


@pytest.mark.parametrize("metric", [0, 1])
@pytest.mark.parametrize("N", [6320, 8192])
def test_merge2d_argmax_full_grid_matches_twin(dev, N, metric):
    """The full grid (N = 6320) and the kernel's limit (N = 8192), in the
    256-thread build, with either metric (min_separation 5 Mahalanobis,
    0.6 Hellinger)."""
    min_sep = 0.6 if metric else 5.0
    got = assert_merge_matches(full_grid_inputs(dev, N=N, seed=N), min_sep,
                               128, sorted_w=False, metric=metric)
    assert (got[3] > 10).all()
    # one lane wider: the staged wide-lane variant, against the twin
    wide = full_grid_inputs(dev, P=2, N=NARROW_LANES[2] + 1)
    build.reset_launch_counts()
    got = merge2d(wide, min_sep, 128, sorted_w=False, metric=metric)
    assert dict(build.launch_counts) == {
        merge2d_variant(False, metric, wide=True): 1}
    assert_outputs_match(got, merge2d_reference(wide, min_sep, 128, False,
                                                metric), 2)


@pytest.mark.parametrize("sorted_w", [True, False])
def test_merge2d_hellinger_matches_twin(dev, sorted_w):
    planes = merge_inputs(dev) if sorted_w else \
        full_grid_inputs(dev, P=32, N=512, frac=0.6)
    assert_merge_matches(planes, 0.6, 128, sorted_w, metric=1)


@pytest.mark.parametrize("metric", [0, 1])
def test_merge2d_sorted_wide_matches_twin(dev, metric):
    """Sorted mode above N = 2048 (a det-route cap of 2049-6319 lanes):
    the 256-thread build."""
    assert_merge_matches(merge_inputs(dev, N=4096, seed=3),
                         0.6 if metric else 5.0, 128, metric=metric)


@pytest.mark.parametrize("name", list(MERGE_EDGES))
def test_merge_edges_match_twins(dev, name):
    """The merge kernels at merge_bench.MERGE_EDGES[name]: merge2d in its
    four variants, merge2d_tables in both metrics, merge3d and merge4d
    where they run the case (merge_bench.edge_dims), one launch each under
    its name, counts equal to the twin's, rtol 1e-4 / atol 1e-5
    (merge_bench.run_case)."""
    for label, tabs, packed, K, sep, sorted_w, metric in edge_runs(
            dev, (name,)):
        run_case(tabs, packed, K, sep, sorted_w, metric, label)


# (P, N, sorted_w, tables): the paths' widest merge launches: Ackerman and
# CPHD P=512 at the cap of 512 lanes, the dense det and fused routes at
# P=1024 and 1536 lanes, the full grid (argmax) at P=512 and 6320 lanes
PATH_MERGES = [(512, 512, True, False), (512, 512, True, True),
               (1024, 1536, True, False), (1024, 1536, True, True),
               (512, 6320, False, False)]


@pytest.mark.parametrize("P,N,sorted_w,tables", PATH_MERGES)
def test_merge2d_path_shapes_run_in_one_wave(dev, P, N, sorted_w, tables):
    """The launch plan holds every block of a path's merge resident at
    once, with shared memory for a few hundred entering lanes a
    particle."""
    for metric in (0, 1):
        plan = merge2d_plan(P, N, sorted_w, metric, tables, dev)
        assert plan["waves"] == 1, plan
        assert plan["entries"] >= min(N, 512), plan


# (D, P, N): merge4d on the mixed path's dynamic map (cap 128) at P=512
# and P=10240, merge3d on the disparity path's 512 lanes at P=200 and 512
PATH_MERGES_3D4D = [(4, 512, 128), (4, 10240, 128), (3, 200, 512),
                    (3, 512, 512)]


@pytest.mark.parametrize("D,P,N", PATH_MERGES_3D4D)
def test_merge3d4d_path_shapes_plan(dev, D, P, N):
    """merge3d's and merge4d's launch plan at the paths' shapes (the
    captured steps' among them): 64 threads, every lane's values in
    shared memory, P=512 in one wave (4 blocks an SM fit)."""
    plan = merge_plan(D, P, N, dev)
    assert plan["threads"] == 64 and plan["entries"] == N, plan
    assert plan["smem"] == 4 * (1 + D + D * (D + 1) // 2) * N, plan
    assert plan["blocks_per_sm"] >= 4, plan
    assert P > 512 or plan["waves"] == 1, plan


@pytest.mark.parametrize("mode", [0, 1])
def test_merge_recip_quotient_is_ieee(dev, mode):
    """merge3d's and merge4d's quotient (merge_core.cuh::Recip) equals IEEE
    f32 division in every bit wherever it does not decline, over 2^28
    pseudo-random pairs of any finite floats (mode 0) and of magnitudes
    2^-27 to 2^28 (mode 1, where it never declines)."""
    r = recip_check(1 << 28, seed=mode, mode=mode, device=dev)
    assert r["tested"] > 0 and r["differ"] == 0, r
    assert mode == 0 or r["declined"] == 0, r


def test_merge2d_argmax_overflow_and_nan_weights(dev):
    """Argmax mode: a NaN particle stalls and drops its lanes, active
    zero-weight lanes never lead but count as left when 16 slots bind."""
    planes = full_grid_inputs(dev, P=8, N=512, seed=1, frac=0.6)
    planes[0, 0] = float("nan")
    planes[1, 0, :64] = 0.0
    got = assert_merge_matches(planes, 5.0, 16, sorted_w=False)
    assert int(got[3][0]) == 0 and int(got[4][0]) == 0
    assert (got[4][1:] > 0).all()          # ~40 clusters into 16 slots


def merge4d_inputs(dev, P=32, N=128, seed=0):
    """Clustered 4D candidates (velocity spreads ~0.3 m/s); active lanes a
    weight-descending prefix: planes [P, 16, N]."""
    rng = np.random.default_rng(seed)
    centers = np.concatenate([rng.normal(0, 8, (P, 20, 2)),
                              rng.normal(0, 0.5, (P, 20, 2))], axis=-1)
    mean = centers[np.arange(P)[:, None], rng.integers(0, 20, (P, N))] \
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


def merge3d_inputs(dev, P=64, N=512, seed=0, spread=3.0):
    """Clustered (u, v, d) candidates at the spread of min_separation 20
    (covariances 16 px^2 + A A'); active lanes a weight-descending prefix:
    planes [P, 11, N]."""
    rng = np.random.default_rng(seed)
    centers = np.stack([rng.uniform(0, 640, (P, 30)),
                        rng.uniform(0, 480, (P, 30)),
                        rng.uniform(20, 300, (P, 30))], axis=-1)
    mean = centers[np.arange(P)[:, None], rng.integers(0, 30, (P, N))] \
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


def test_detect_matches_twin(dev):
    planes, z4 = detect_inputs(dev)
    build.reset_launch_counts()
    got = detect(planes, z4, 16, 1e-6, 0.05)
    assert build.launch_counts["detect"] == 1
    want = detect_reference(planes, z4, 16, 1e-6, 0.05)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    sel = want[0] > 0
    assert torch.equal(got[1][sel], want[1][sel])
    assert torch.equal(got[3], want[3])


def gather_named(dev, case):
    """(idx, tab) on the card for gather_bench.GATHER_CASES[case], and the
    launch name its slab's size selects."""
    kind, P, C, R, cap, _ = GATHER_CASES[case]
    idx, tab = gather_case(dev, case)
    return idx, tab, f"gather_{kind}" + (
        "" if build.gather_staged(C * R) else "_ldg")


@pytest.mark.parametrize("case", [c for c, v in GATHER_CASES.items()
                                  if v[0] == "cols"])
def test_gather_cols_matches_twin(dev, case):
    """Bit for bit, each launch counted under its mode's name."""
    idx, tab, name = gather_named(dev, case)
    build.reset_launch_counts()
    got = gather_cols(idx, tab)
    torch.cuda.synchronize()
    assert dict(build.launch_counts) == {name: 1}
    assert torch.equal(got, gather_cols_reference(idx, tab))


def test_merge_matches_twin(dev):
    planes = merge_inputs(dev)
    got = merge_out(merge2d(planes, 5.0, 128), 2)
    want = merge_out(merge2d_reference(planes, 5.0, 128), 2)
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_merge_overflow_and_nan_weights(dev):
    planes = merge_inputs(dev, P=8, seed=1)
    planes[0, 0] = float("nan")
    planes[1, 0, :8] = 0.0
    got = merge_out(merge2d(planes, 5.0, 16), 2)
    want = merge_out(merge2d_reference(planes, 5.0, 16), 2)
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    assert int(got[3][0]) == 0 and int(got[4][0]) == 0
    assert (got[4][2:] > 0).all()          # 40 clusters into 16 slots


def test_detect_unthresholded_matches_twin(dev):
    """The mixed update's mode: min_fw = 0, cb = 0, M = 32."""
    planes, z4 = detect_inputs(dev, M=32, n_valid=24)
    got = detect(planes, z4, 16, 0.0, 0.0)
    want = detect_reference(planes, z4, 16, 0.0, 0.0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    assert torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])


@pytest.mark.parametrize("N", [128, 512])
def test_merge4d_matches_twin(dev, N):
    planes = merge4d_inputs(dev, N=N)
    build.reset_launch_counts()
    got = merge_out(merge4d(planes, 2.0, 128), 4)
    assert build.launch_counts["merge4d"] == 1
    want = merge_out(merge4d_reference(planes, 2.0, 128), 4)
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_merge4d_overflow_and_nan_weights(dev):
    planes = merge4d_inputs(dev, P=8, N=128, seed=1)
    planes[0, 0] = float("nan")
    planes[1, 0, :8] = 0.0
    got = merge_out(merge4d(planes, 2.0, 8), 4)
    want = merge_out(merge4d_reference(planes, 2.0, 8), 4)
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    assert int(got[3][0]) == 0 and int(got[4][0]) == 0
    assert (got[4][2:] > 0).all()          # ~20 clusters into 8 slots


def _shuffled(planes, seed=0):
    """The planes' lanes in a fixed random order (argmax mode's input)."""
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(
        planes.shape[2])).to(planes.device)
    return planes[:, :, perm].contiguous()


def _near_threshold(planes, D, sep, metric):
    """Per particle: whether any pair of its entering lanes lies within
    1e-5 (relative) of ``sep`` (a f32 decision there may go either way)."""
    from phdslam_tpu_torch.ops.gm_merge import unpack_planes
    from phdslam_tpu_torch.ops.math import (hellinger2, mahalanobis2_3d,
                                            mahalanobis2_4d)
    mean, cov, w, act = unpack_planes(planes.double(), D)
    dist = hellinger2 if metric else {3: mahalanobis2_3d,
                                      4: mahalanobis2_4d}[D]
    d = dist(mean[:, :, None], cov[:, :, None], mean[:, None], cov[:, None])
    both = act[:, :, None] & act[:, None]
    return ((d - sep).abs() <= 1e-5 * sep).logical_and(both).flatten(1) \
        .any(dim=1)


@pytest.mark.parametrize("N", [128, 512])
def test_merge4d_argmax_matches_twin(dev, N):
    """merge4d's argmax mode (the mixed model's per-particle route) on
    lanes in a random order, with w <= 0 active lanes, a NaN row and
    out_cap binding, against the twin: equal counts, weights and means
    rtol 1e-4 / atol 1e-5, covariances rtol 1e-3 / atol 1e-5 (a cluster
    that absorbs negative weights divides a cancelling sum, whose
    reassociation moves a term by ~3e-4 of it)."""
    planes = _shuffled(merge4d_inputs(dev, P=64, N=N, seed=3))
    planes[0, 0] = float("nan")                 # the row stalls
    planes[1, 1] = 1.0                          # every lane active,
    planes[1, 0, : N // 2] = -0.5               # half of them w < 0
    planes[2, 1] = 1.0
    planes[2, 0] = 0.0                          # nothing can lead
    for K in (128, 8):
        build.reset_launch_counts()
        got = merge_out(merge4d(planes, 2.0, K, sorted_w=False), 4)
        assert dict(build.launch_counts) == {"merge4d_argmax": 1}
        want = merge_out(merge4d_reference(planes.cpu(), 2.0, K,
                                           sorted_w=False), 4)
        assert torch.equal(got[3].cpu(), want[3])
        assert torch.equal(got[4].cpu(), want[4])
        for g, w, rtol in zip(got[:3], want[:3], (1e-4, 1e-3, 1e-4)):
            torch.testing.assert_close(g.cpu(), w, rtol=rtol, atol=1e-5)
        assert int(got[3][0]) == 0 and int(got[4][0]) == 0
        assert int(got[3][2]) == 0 and int(got[4][2]) == 0
    assert (got[4][3:] > 0).any()               # K = 8 binds


@pytest.mark.parametrize("D,N,K,sep", [(3, 512, 24, 0.6), (4, 128, 128, 0.6),
                                       (4, 512, 16, 0.6)])
def test_merge_hellinger_3d4d_matches_twin(dev, D, N, K, sep):
    """merge3d's and merge4d's Hellinger variants on sorted lanes against
    the twin (ops/math.py::hellinger2 at D = 3, 4): rtol 1e-4 / atol 1e-5
    and equal counts in every particle with no pair of lanes within 1e-5
    of min_separation (a few particles at these seeds have one; they are
    left out, not failed)."""
    planes = (merge3d_inputs(dev, P=256, N=N, seed=7) if D == 3
              else merge4d_inputs(dev, P=256, N=N, seed=7))
    kern, ref = (merge3d, merge3d_reference) if D == 3 else (merge4d,
                                                              merge4d_reference)
    build.reset_launch_counts()
    got = merge_out(kern(planes, sep, K, metric=1), D)
    assert dict(build.launch_counts) == {f"merge{D}d_hellinger": 1}
    want = merge_out(ref(planes.cpu(), sep, K, metric=1), D)
    ok = ~_near_threshold(planes.cpu(), D, sep, 1)
    assert ok.sum() >= 240
    assert torch.equal(got[3].cpu()[ok], want[3][ok])
    assert torch.equal(got[4].cpu()[ok], want[4][ok])
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g.cpu()[ok], w[ok], rtol=1e-4, atol=1e-5)
    assert (want[3] > 1).all()                  # clusters formed


@pytest.mark.parametrize("D,sorted_w,metric", [(4, False, 0), (4, True, 1),
                                               (3, True, 1)])
def test_merge3d4d_variant_plans(dev, D, sorted_w, metric):
    """The new variants' launch plans at the paths' shapes: 64 threads,
    every lane in shared memory, at least 4 blocks an SM."""
    plan = merge_plan(D, 512, 512, dev, sorted_w=sorted_w, metric=metric)
    assert plan["threads"] == 64 and plan["entries"] == 512, plan
    assert plan["blocks_per_sm"] >= 4, plan


@pytest.mark.parametrize("N", [512, 624])
def test_merge3d_matches_twin(dev, N):
    planes = merge3d_inputs(dev, N=N, seed=N)
    build.reset_launch_counts()
    got_planes = merge3d(planes, 20.0, 24)
    assert build.launch_counts["merge3d"] == 1
    assert (got_planes[:, 11] == 0).all()
    got = merge_out(got_planes, 3)
    want = merge_out(merge3d_reference(planes, 20.0, 24), 3)
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


def test_merge3d_overflow_and_nan_weights(dev):
    planes = merge3d_inputs(dev, P=8, N=512, seed=1)
    planes[0, 0] = float("nan")
    planes[1, 0, :8] = 0.0
    got = merge_out(merge3d(planes, 20.0, 8), 3)
    want = merge_out(merge3d_reference(planes, 20.0, 8), 3)
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    assert int(got[3][0]) == 0 and int(got[4][0]) == 0
    assert (got[4][2:] > 0).all()          # ~30 clusters into 8 slots


def test_wrappers_reject_bad_input(dev):
    planes, z4 = detect_inputs(dev, P=2)
    with pytest.raises(ValueError):
        detect(planes.double(), z4.double(), 16, 1e-6, 0.05)
    with pytest.raises(ValueError):
        merge2d(merge_inputs(dev, P=2)[:, :, ::2], 5.0, 16)
    with pytest.raises(ValueError):
        merge4d(merge_inputs(dev, P=2), 5.0, 16)    # 7 planes, not 16
    with pytest.raises(ValueError):
        merge3d(merge_inputs(dev, P=2), 20.0, 24)   # 7 planes, not 11
    with pytest.raises(ValueError):
        merge3d(merge3d_inputs(dev, P=2), 20.0, 0)  # no output slot
    with pytest.raises(ValueError):
        merge3d(merge3d_inputs(dev, P=2).double(), 20.0, 24)
    idx, tab = gather_case(dev, "t_k")
    for bad in ((idx.long(), tab), (idx, tab.double()), (idx[:, ::2], tab),
                (idx[:2], tab), (idx.cpu(), tab)):
        with pytest.raises(ValueError):
            gather_cols(*bad)
        with pytest.raises(ValueError):
            gather_rows(*bad)


# ----------------------------------------------------------------------------
# the knob variants, at the Ackerman and the dense shapes
# ----------------------------------------------------------------------------

# config, P, K, M (padded), valid measurements, T
SHAPES = {"ackerman": ("cfg/ackerman.cfg", 64, 128, 48, 44, 16),
          "dense": ("cfg/dense.cfg", 32, 1024, 72, 65, 32)}


def shape_scene(dev, shape, seed=0):
    path, P, K, M, n_valid, T = SHAPES[shape]
    cfg = load_config(path)
    return cfg, map_scene(cfg, P, K, M, n_valid, seed, dev), T


def assert_detect_matches(got, want):
    """Kernel against twin: values rtol 1e-5, indices where selected, the
    counts (and member counts) exactly, the cons sums rtol 1e-4 / atol
    1e-6, index 0 where nothing is selected."""
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0)
    sel = want[0] > 0
    assert torch.equal(got[1][sel], want[1][sel])
    assert (got[1][~sel] == 0).all()
    assert torch.equal(got[3], want[3])
    if len(want) == 5:
        assert torch.equal(got[4][:, 6:], want[4][:, 6:])
        torch.testing.assert_close(got[4][:, :6], want[4][:, :6], rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_detect_adaptive_bit_equal_to_static(dev, shape):
    """T above many rows' live counts: the adaptive kernel writes the (0, 0)
    tail into its torch.empty outputs as the static trips do."""
    cfg, s, T = shape_scene(dev, shape)
    planes, z4 = detect_planes(cfg, s)
    args = (planes, z4, T, cfg.min_feature_weight,
            cfg.clutter_density + cfg.birth_weight)
    build.reset_launch_counts()
    got = detect(*args, adaptive=True)
    static = detect(*args)
    assert build.launch_counts == {"detect_adaptive": 1, "detect": 1}
    for a, b in zip(got, static):
        assert torch.equal(a, b)
    assert (got[3] < T).any() and (got[3] > 0).any()
    assert_detect_matches(got, detect_reference(*args))


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_detect_cons_matches_twin(dev, shape, adaptive):
    cfg, s, T = shape_scene(dev, shape, seed=1)
    planes, z4 = detect_planes(cfg, s, consolidate=True)
    args = (planes, z4, T, cfg.min_feature_weight,
            cfg.clutter_density + cfg.birth_weight, cfg.min_separation)
    build.reset_launch_counts()
    got = detect(*args, adaptive=adaptive)
    assert build.launch_counts[detect_variant(True, adaptive)] == 1
    assert_detect_matches(got, detect_reference(*args))
    cons = got[4]
    assert (cons[:, 8] > 1).any() and (cons[:, 9] > 0).any()
    # persistent heads (c = 0 with members) among the heavy first features
    assert ((cons[:, 8, :4] > 0) & (cons[:, 6, :4] == 0)).any()


def test_detect_cons_far_persistent(dev):
    """tests/test_consolidate.py's far-persistent scene: the column's
    persistent copy is live but beyond min_sep of the copy, so nothing
    consolidates there."""
    from phdslam_tpu_torch.eval.scenes import Scene
    cfg = load_config("cfg/ackerman.cfg", dict(
        min_separation=4.0, std_range=0.25, std_bearing=0.02, max_range=12.0,
        clutter_rate=1.0, pd=0.9, birth_weight=0.01, min_feature_weight=1e-5))
    P, K = 2, 8
    mean = torch.zeros((P, K, 2))
    mean[:, 0] = torch.tensor([5.0, 0.0])
    w = torch.zeros((P, K))
    w[:, 0] = 1.0
    s = Scene(torch.zeros((P, 6)), mean, torch.eye(2).expand(P, K, 2, 2),
              w, torch.tensor([[8.0, 0.0], [0.0, 0.0]]),
              torch.tensor([True, False]))
    s = Scene(*(x.contiguous().to(dev) for x in s))
    planes, z4 = detect_planes(cfg, s, consolidate=True)
    args = (planes, z4, 4, cfg.min_feature_weight,
            cfg.clutter_density + cfg.birth_weight, cfg.min_separation)
    got = detect(*args)
    assert_detect_matches(got, detect_reference(*args))
    # the copy heads (c = its innovation), no member, pers_in 0
    assert (got[3][:, 0] == 1).all() and (got[4][:, 8:, 0] == 0).all()
    assert (got[4][:, 6, 0] > 2).all()


@pytest.mark.parametrize("metric", [0, 1])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_merge2d_tables_matches_two_kernel_route(dev, shape, metric):
    """The fused kernel against the two-kernel route on the card
    (gather_cols twice, the combine, merge2d) and against its twin: equal
    counts, values rtol 1e-4 / atol 1e-5."""
    cfg, s, _ = shape_scene(dev, shape)
    min_sep = 0.6 if metric else cfg.min_separation
    K = s.mean.shape[1]
    g, ints, flts = tables_payload(cfg, s)
    build.reset_launch_counts()
    got = merge_out(merge2d_tables(ints, flts, g["t_k"], g["t_m"], min_sep,
                                   K, metric), 2)
    assert build.launch_counts[merge2d_variant(True, metric, True)] == 1
    for want in (merge_out(merge2d(_finish_candidates_packed(g, 2), min_sep,
                                   K, metric=metric), 2),
                 merge_out(merge2d_tables_reference(
                     ints, flts, g["t_k"], g["t_m"], min_sep, K, metric), 2)):
        assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
        for a, b in zip(got[:3], want[:3]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert (got[3] > 10).all()


def assert_outputs_match(got, want, D):
    """Merge planes at dimension D against another merge's: equal cluster
    and leftover counts, rtol 1e-4 / atol 1e-5 on weights, means and
    covariances. Returns got's merge tuple."""
    g, w = merge_out(got, D), merge_out(want, D)
    assert torch.equal(g[3], w[3]) and torch.equal(g[4], w[4])
    for a, b in zip(g[:3], w[:3]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    return g


def wide_planes(dev, D, N, sorted_w, seed=0):
    """Clustered planes at dimension D for the staged variants: weight-
    descending (sorted) or full-grid lanes in no order (argmax, 2D), or the
    4D argmax mode's lanes in a random order."""
    if D == 2:
        return merge_inputs(dev, P=16, N=N, seed=seed) if sorted_w else \
            full_grid_inputs(dev, P=16, N=N, seed=seed)
    planes = (merge4d_inputs if D == 4 else merge3d_inputs)(dev, P=16, N=N,
                                                            seed=seed)
    if not sorted_w:
        g = torch.Generator().manual_seed(seed)
        planes = planes[:, :, torch.randperm(N, generator=g).to(dev)]
    return planes.contiguous()


WIDE_VARIANTS = [(2, s, m) for s in (True, False) for m in (0, 1)] + [
    (D, s, m) for D in (3, 4) for s, m in VARIANTS_3D4D[D]]


def merge_call(D, planes, sep, K, sorted_w, metric, **kw):
    if D == 2:
        return merge2d(planes, sep, K, sorted_w, metric, **kw)
    if D == 3:
        return merge3d(planes, sep, K, metric, **kw)
    return merge4d(planes, sep, K, sorted_w, metric, **kw)


def merge_twin(D, planes, sep, K, sorted_w, metric):
    if D == 3:
        return merge3d_reference(planes, sep, K, metric)
    ref = merge2d_reference if D == 2 else merge4d_reference
    return ref(planes, sep, K, sorted_w, metric)


WIDE_SEP = {2: 5.0, 3: 20.0, 4: 2.0}


@pytest.mark.parametrize("D,sorted_w,metric", WIDE_VARIANTS)
def test_merge_wide_matches_twin(dev, D, sorted_w, metric):
    """Each staged wide-lane variant just above its narrow kernel's width
    (N = 8448 at D = 2, 2304 at D = 3 and 4), counted under its "_wide"
    name, against the twin: equal counts, rtol 1e-4 / atol 1e-5."""
    N = NARROW_LANES[D] + 256
    planes = wide_planes(dev, D, N, sorted_w, seed=N)
    sep = 0.6 if metric else WIDE_SEP[D]
    build.reset_launch_counts()
    got = merge_call(D, planes, sep, 128, sorted_w, metric)
    assert dict(build.launch_counts) == {
        merge2d_variant(sorted_w, metric, D=D, wide=True): 1}
    g = assert_outputs_match(got, merge_twin(D, planes, sep, 128, sorted_w,
                                             metric), D)
    assert (g[3] > 5).all()


@pytest.mark.parametrize("D,sorted_w,metric", WIDE_VARIANTS)
def test_merge_wide_at_the_narrow_limit(dev, D, sorted_w, metric):
    """The staged variant forced at its narrow kernel's limit (N = 8192,
    2048) beside the narrow kernel: the same clusters and counts, the sums
    to rtol 1e-4 / atol 1e-5 (their order differs)."""
    N = NARROW_LANES[D]
    planes = wide_planes(dev, D, N, sorted_w, seed=N)
    sep = 0.6 if metric else WIDE_SEP[D]
    build.reset_launch_counts()
    narrow = merge_call(D, planes, sep, 128, sorted_w, metric)
    wide = merge_call(D, planes, sep, 128, sorted_w, metric, wide=True)
    assert dict(build.launch_counts) == {
        merge2d_variant(sorted_w, metric, D=D): 1,
        merge2d_variant(sorted_w, metric, D=D, wide=True): 1}
    assert_outputs_match(wide, narrow, D)


@pytest.mark.parametrize("metric", [0, 1])
def test_merge2d_tables_wide_matches_twin(dev, metric):
    """merge2d_tables' staged variant at N = 8448 against its twin, and
    forced at N = 8192 beside the narrow fused kernel."""
    sep = 0.6 if metric else 5.0
    for name, wide in (("N 8448", None), ("N 8192", True)):
        *tabs, K = tables_edge_case(name)
        tabs = [torch.from_numpy(x).to(dev) for x in tabs]
        build.reset_launch_counts()
        got = merge2d_tables(*tabs, sep, K, metric, wide=wide)
        assert dict(build.launch_counts) == {
            merge2d_variant(True, metric, tables=True, wide=True): 1}
        g = assert_outputs_match(got, merge2d_tables_reference(
            *tabs, sep, K, metric), 2)
        assert (g[3] > 5).all()
        if wide:
            assert_outputs_match(got, merge2d_tables(*tabs, sep, K, metric),
                                 2)


def test_merge_wide_plans(dev):
    """The staged variants' plans: any N, entries past the shared ones
    read again (packed) or spilled (tables)."""
    for D in (2, 3, 4):
        plan = merge_plan(D, 512, 74824, device=dev) if D > 2 else \
            merge2d_plan(512, 74824, False, device=dev)
        assert plan["entries"] + plan["overflow"] == 74824
        assert plan["blocks_per_sm"] >= 1 and plan["waves"] >= 1
    plan = merge2d_plan(16, 8448, True, 0, tables=True, device=dev)
    assert plan["entries"] > 0


# (D, sorted_w, P, N, K, n_centers): every lane entering, at a P whose
# blocks share an SM (2 and 4 an SM of 132), so that entries spill past
# the shared ones; and hundreds of clusters into K = 1024, so that the
# rounds compact the free entries many times
WIDE_SPILL = {
    "2D sorted, spill": (2, True, 264, 8448, 128, 40),
    "2D argmax, spill": (2, False, 264, 8448, 128, 40),
    "2D argmax, spill, 4 blocks an SM": (2, False, 528, 8448, 128, 40),
    "2D argmax, 600 clusters into 1024": (2, False, 264, 8448, 1024, 600),
    "2D sorted, 600 clusters into 1024": (2, True, 264, 8448, 1024, 600),
    "4D argmax, spill": (4, False, 528, 2304, 128, 30),
}


@pytest.mark.parametrize("case", list(WIDE_SPILL))
def test_merge_wide_spill_and_compaction(dev, case):
    """The staged variants where entries lie past the block's shared ones
    (the plan's overflow, spilled to the wrapper's scratch) and over many
    compacting rounds, against the twin under chip_smoke.py's gate
    (merge_bench.check_merge_rows: equal counts, rtol 1e-4 / atol 1e-5,
    a row parting only at a lane on the merge threshold)."""
    D, sorted_w, P, N, K, n_centers = WIDE_SPILL[case]
    if D == 2:
        planes = full_grid_inputs(dev, P=P, N=N, seed=N, frac=1.0,
                                  n_centers=n_centers)
        if sorted_w:
            planes = tgm.sort_planes(planes, 2).contiguous()
        plan = merge2d_plan(P, N, sorted_w, device=dev)
    else:
        planes = merge4d_inputs(dev, P=P, N=N, seed=N)
        g = torch.Generator().manual_seed(N)
        planes = planes[:, :, torch.randperm(N, generator=g).to(dev)]
        planes = planes.contiguous()
        plan = merge_plan(D, P, N, device=dev, sorted_w=sorted_w)
    entering = int((planes[:, 1] > 0.5).sum(dim=1).max())
    assert entering > plan["entries"]
    sep = WIDE_SEP[D]
    build.reset_launch_counts()
    got = merge_out(merge_call(D, planes, sep, K, sorted_w, 0), D)
    assert dict(build.launch_counts) == {
        merge2d_variant(sorted_w, 0, D=D, wide=True): 1}
    want = [x.cpu() for x in merge_out(
        merge_twin(D, planes, sep, K, sorted_w, 0), D)]
    flips, _ = check_merge_rows(got, want, planes, sep, case)
    assert len(flips) <= P // 100
    assert (got[3] >= min(n_centers // 2, K)).all()


def wide_detect_args(dev, cons, K=2048, seed=4):
    """The dense scene at K features (T = 32, M = 72; consolidating
    planes with ``cons``)."""
    cfg = load_config("cfg/dense.cfg")
    s = map_scene(cfg, 32, K, 72, 65, seed, dev)
    planes, z4 = detect_planes(cfg, s, consolidate=cons)
    return (planes, z4, 32, cfg.min_feature_weight,
            cfg.clutter_density + cfg.birth_weight,
            cfg.min_separation if cons else 0.0)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("cons", [False, True])
def test_detect_wide_matches_twin(dev, cons, adaptive):
    """Each detect variant at K = 2048 (the wide variant, "_wide") against
    the twin, and the same call on CPU tensors (the twin the CPU runs)
    beside it: the card and the CPU give the same answer."""
    args = wide_detect_args(dev, cons)
    build.reset_launch_counts()
    got = detect(*args, adaptive=adaptive)
    assert dict(build.launch_counts) == {
        detect_variant(cons, adaptive, wide=True): 1}
    assert_detect_matches(got, detect_reference(*args))
    cpu = detect(*(a.cpu() if torch.is_tensor(a) else a for a in args),
                 adaptive=adaptive)
    assert_detect_matches([x.cpu() for x in got], cpu)
    assert (got[3] > 0).any()


@pytest.mark.parametrize("cons", [False, True])
def test_detect_wide_at_the_narrow_limit(dev, cons):
    """The wide variant forced at K = 1024 beside the narrow kernel: the
    same bits (the same pdw, normalizer order and selection)."""
    args = wide_detect_args(dev, cons, K=1024)
    narrow = detect(*args)
    wide = detect(*args, wide=True)
    for a, b in zip(narrow, wide):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.parametrize("thresholded", [True, False])
def test_detect_wide_candidate_routes(dev, thresholded):
    """detect_wide at K = 2048 on rows with at most 32 live lanes and rows
    with more (the dense scene's thresholds: the live lanes found among the
    row's candidates), and at min_fw 0 (every pdw > 0 lane a candidate,
    more than the warp's buffer holds: the whole row walked again),
    against the twin; forced at K = 1024 beside the narrow kernel, bit for
    bit."""
    for K in (2048, 1024):
        args = wide_detect_args(dev, False, K=K)
        if not thresholded:
            args = (*args[:3], 0.0, 0.0, 0.0)
        got = detect(*args, wide=True)
        if K == 1024:
            narrow = detect(*args)
            for a, b in zip(narrow, got):
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                assert torch.equal(a, b)
            continue
        assert_detect_matches(got, detect_reference(*args))
        live = got[3][:, args[1][:, 2] > 0.5]
        assert bool((live > 32).any())
        if thresholded:
            assert bool(((live > 0) & (live <= 32)).any())


@pytest.mark.parametrize("thresholded", [True, False])
@pytest.mark.parametrize("K", [2048, 8192])
def test_detect_cons_wide_routes(dev, K, thresholded):
    """The consolidating wide variant at K = 2048 (planes and live-lane
    bits in shared memory) and K = 8192 (both in device memory: the planes
    too large to stage), on the dense scene's thresholds and at min_fw 0
    (every pdw > 0 lane a candidate: pass 1's candidates overflow the
    warp's buffer and pass 3's survivors walk the row in tiles), static and
    adaptive, against the twin (assert_detect_matches' gates) and the same
    call on CPU tensors; its launch plan says which layout ran."""
    args = wide_detect_args(dev, True, K=K)
    if not thresholded:
        args = (*args[:3], 0.0, 0.0, args[5])
    plan = detect_wide_plan(K, dev, M=args[1].shape[0])
    assert plan["staged"] == (K == 2048)
    assert plan["blocks_per_sm"] >= 1
    for adaptive in (False, True):
        build.reset_launch_counts()
        got = detect(*args, adaptive=adaptive)
        torch.cuda.synchronize()
        assert dict(build.launch_counts) == {
            detect_variant(True, adaptive, wide=True): 1}
        assert_detect_matches(got, detect_reference(*args))
    cpu = detect(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    assert_detect_matches([x.cpu() for x in got], cpu)
    live = got[3][:, args[1][:, 2] > 0.5]
    assert bool((live > 0).any()) and bool((got[4][:, 8] > 0).any())
    if not thresholded:
        assert bool((live > 128).any())


@pytest.mark.parametrize("T", [40, 8])
def test_detect_wide_trips_and_small_t(dev, T):
    """The wide variant's trips (T > 32 with more than 32 live lanes, at
    min_fw 0) and a small T, against the twin at K = 1500."""
    planes, z4 = detect_inputs(dev, P=16, K=1500, M=24, n_valid=20)
    args = (planes, z4, T, 0.0, 0.0)
    got = detect(*args)
    assert_detect_matches(got, detect_reference(*args))
    assert (got[3] > 32).any()


def test_merge2d_dense_matches_twin(dev):
    """Sorted mode at the dense configuration's cap 1536 into K=1024."""
    got = assert_merge_matches(merge_inputs(dev, N=1536, seed=5), 5.0, 1024)
    assert (got[3] > 10).all()


@pytest.mark.parametrize("P,N,ct", [(1024, 256, 128), (256, 512, 256),
                                    (64, 512, 384), (512, 1024, 384)])
def test_tiled_merge_kernels_match_twins(dev, P, N, ct):
    """The spatially tiled merge's two launches at its tile row widths:
    the tile extraction (gather_cols over the tile-major order) bit for
    bit its twin, merge2d on the [4 P, 7, ct] rows (out_cap K / 4) within
    assert_merge_matches' gates, and the interleaved merge tuple the CPU
    route's."""
    planes = merge_inputs(dev, P=P, N=N, seed=ct)
    cpu = planes.cpu()
    layout = tgm.tile_layout(cpu)
    ct_need = tgm.tile_width(N, int(layout[1].max()))
    assert 0 < ct_need <= ct
    on_dev = tuple(x.to(dev) for x in layout)
    build.reset_launch_counts()
    rows = tgm.tile_rows(planes, on_dev, ct)
    assert build.launch_counts["gather_cols"] == 1
    assert rows.shape == (4 * P, 7, ct) and rows.is_contiguous()
    assert torch.equal(rows.cpu(), tgm.tile_rows(cpu, layout, ct))
    assert_merge_matches(rows, 5.0, 128 // 4)
    got = tgm.tiled_merge_packed(planes, on_dev, ct, 5.0, 128)
    want = tgm.tiled_merge_packed(cpu, layout, ct, 5.0, 128)
    assert torch.equal(got[3].cpu(), want[3]) \
        and torch.equal(got[4].cpu(), want[4])
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", [c for c, v in GATHER_CASES.items()
                                  if v[0] == "rows"])
def test_gather_rows_matches_twin(dev, case):
    """Bit for bit, zero rows for indices outside [0, R), each launch
    counted under its mode's name."""
    idx, tab, name = gather_named(dev, case)
    R = tab.shape[1]
    build.reset_launch_counts()
    got = gather_rows(idx, tab)
    torch.cuda.synchronize()
    assert dict(build.launch_counts) == {name: 1}
    assert torch.equal(got, gather_rows_reference(idx, tab))
    assert (got[(idx < 0) | (idx >= R)] == 0).all()


def test_detect_dense_matches_twin(dev):
    """The plain kernel at K=1024 (32 features per lane)."""
    cfg, s, T = shape_scene(dev, "dense", seed=2)
    planes, z4 = detect_planes(cfg, s)
    args = (planes, z4, T, cfg.min_feature_weight,
            cfg.clutter_density + cfg.birth_weight)
    assert_detect_matches(detect(*args), detect_reference(*args))


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("cons", [False, True])
@pytest.mark.parametrize("case", list(DETECT_EDGES))
def test_detect_edges_match_twin(dev, case, cons, adaptive):
    """The selection's edges (detect_bench.DETECT_EDGES: live count exactly
    T and T + 1 at T 32 and 16, every lane dead, K 100, T = K, T 1, M 1, a
    NaN in a plane, duplicated features at T 32, K 1024 at min_fw 0) in
    each variant: idx and the counts equal to the twin's, vals and norm to
    rtol 1e-5 (NaN where the twin's is), the cons planes to the gates of
    detect_bench.compare_detect; adaptive bit-equal to the static
    launch."""
    planes, z4, T, min_fw, cb = (
        torch.from_numpy(x).to(dev) if isinstance(x, np.ndarray) else x
        for x in detect_edge_case(case, cons))
    args = (planes, z4, T, min_fw, cb, MIN_SEP_EDGES if cons else 0.0)
    build.reset_launch_counts()
    got = detect(*args, adaptive=adaptive)
    torch.cuda.synchronize()
    assert dict(build.launch_counts) == {detect_variant(cons, adaptive): 1}
    compare_detect(got, detect_reference(*args), case, planes, z4, min_fw,
                   cb)
    if adaptive:                         # bit for bit, NaN norms too
        for a, b in zip(got, detect(*args)):
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b)
    opt = DETECT_EDGES[case][5]
    if "live" in opt and not cons:
        assert (got[3][:, z4[:, 2] > 0.5] == opt["live"]).all()


def test_resampling_cumsum_repeats_on_the_card(dev):
    """The resampling's fixed-order cumsum gives the same bits on every call
    at P=10240, where a 1D torch.cumsum spans several scan tiles, and stays
    within f32 rounding of the float64 cumsum."""
    g = torch.Generator(device=dev).manual_seed(3)
    w = torch.softmax(torch.randn((10240,), generator=g, device=dev) * 2.0,
                      dim=0)
    first = cumsum_fixed_order(w)
    for _ in range(50):
        assert torch.equal(cumsum_fixed_order(w), first)
    torch.testing.assert_close(first.cpu().double(),
                               torch.cumsum(w.cpu().double(), dim=0),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("P,C1", [(512, 65), (10240, 65), (300, 33),
                                  (70, 257)])
def test_cardinality_predict_fixed_order(dev, P, C1):
    """The CPHD cardinality prediction on the card, one launch: the same
    bits as its twin on the card, for the whole batch, four blocks and
    single rows alike (each sum j ascending, no fused multiply-add, the
    element-wise ops PyTorch's kernels run); within 1e-6 of max(1, |x|)
    of the twin on the CPU (PyTorch's CPU exp and log round otherwise)
    where a row is within 60 nats of its peak. Rows with a certain cardinality, every
    entry at LOG0 and a NaN are among them; filters/cphd.py's
    cardinality_predict_batch is the wrapper."""
    rng = np.random.default_rng(P + C1)
    log_cn = rng.uniform(-60, 0, (P, C1)).astype(np.float32)
    log_cn[1] = -1.0e30
    log_cn[1, 3] = 0.0
    log_cn[2] = -1.0e30
    log_cn[3, 5] = np.nan
    log_b = rng.uniform(-40, 0, C1).astype(np.float32)
    log_cn_d = torch.tensor(log_cn, device=dev)
    log_b_d = torch.tensor(log_b, device=dev)
    build.reset_launch_counts()
    got = tcphd.cardinality_predict_batch(log_cn_d, log_b_d)
    torch.cuda.synchronize()
    assert dict(build.launch_counts) == {"cardinality_predict": 1}
    want = cardinality_predict_reference(log_cn_d, log_b_d)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    blocks = torch.cat([cardinality_predict_batch(x, log_b_d)
                        for x in log_cn_d.split(max(1, P // 4))])
    assert torch.equal(got.view(torch.int32), blocks.view(torch.int32))
    for i in (0, 1, 2, 3, P // 3, P - 1):
        one = cardinality_predict_batch(log_cn_d[i:i + 1], log_b_d)
        assert torch.equal(one.view(torch.int32), got[i:i + 1].view(
            torch.int32))
    assert torch.isnan(got[3]).all() and torch.isfinite(got[4:]).all()
    cpu = cardinality_predict_reference(torch.tensor(log_cn),
                                        torch.tensor(log_b)).double()
    g = got.cpu().double()
    peak = cpu.amax(dim=1, keepdim=True)
    near = (cpu > peak - 60.0) & torch.isfinite(cpu)
    assert bool(((g - cpu).abs()[near]
                 <= 1e-6 * cpu.abs().clamp_min(1.0)[near]).all())


def test_dense_step_never_waits_for_the_card(dev):
    """A single-device dense step (cfg/dense.cfg at P=256, has_z from the
    schedule, tracing off) makes no call that synchronizes the stream:
    with the sync debug mode at "error", any such call inside
    ``phd_step`` (a device-to-host read, a pageable copy) raises. Its log
    P has the bits of ``torch.log`` of ``float(P)`` copied to the card."""
    from phdslam_tpu_torch.filters.phd import _log_count, phd_step
    from phdslam_tpu_torch.slam import SynthSLAMRunner
    build.library()
    cfg = load_config("cfg/dense.cfg", dict(n_particles=256, n_steps=8))
    r = SynthSLAMRunner(cfg, device=dev)
    state, n_updates = r.state, 0
    for n in range(r.n_steps):
        noise = r.noise()
        z, zm, control, dt, do_predict, has_z = r.step_args(n)
        n_updates += has_z
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, out = phd_step(state, z, zm, control, dt, do_predict,
                                  cfg, noise, has_z=has_z, consts=r.consts)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert n_updates >= 4
    assert torch.isfinite(out.expected_pose).all()
    assert out.map_mean.shape == (cfg.max_components, 2)
    for n in (256, 10240):
        want = torch.log(torch.tensor(float(n), device=dev))
        assert torch.equal(_log_count(n, out.n_eff).view(torch.int32),
                           want.view(torch.int32))
