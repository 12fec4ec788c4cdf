"""The knob variants of the port's kernels against the JAX package.

The same numpy inputs go through the JAX functions and their counterparts
in ``phdslam_tpu_torch``: the detect kernel with adaptive trips
(detect_adaptive) and with same-source pre-consolidation
(premerge_consolidate), its consolidating input planes, the candidate
tables and combine with the consolidated rows, the fused gather + merge
(fused_gather_merge, both metrics), the row gather, and the PHD update with
each knob. On the CPU the port's kernel wrappers run their plain twins; the
JAX Pallas kernels run in interpret mode (pallas_detect=2, pallas_merge=2,
``interpret=True``). Replayed filter steps with each knob are in
``tests/test_torch_knobs.py``.

Tolerances: detect values and normalizers to rtol 1e-6 (exp and the row
sums round differently in the two frameworks), indices, counts and member
counts exactly; the consolidation sums to rtol 1e-4 / atol 1e-6 (sums over
M taken in another order); merges with equal cluster and leftover counts,
values to rtol 1e-5; gathers and the tables exactly; updated states to
rtol 1e-4 / atol 1e-5 on weights and means, covariances to rtol 1e-3, the
overflow count exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.config import SlamConfig as JaxSlamConfig
from phdslam_tpu.filters import phd as jphd
from phdslam_tpu.ops import ekf as jekf
from phdslam_tpu.ops.pallas_detect import detection_topT_batch
from phdslam_tpu.ops.pallas_merge import gm_merge_pallas_batch_tables
from phdslam_tpu.ops.pallas_select import onehot_rows_batch, onehot_rows_xla
from phdslam_tpu_torch.config import SlamConfig
from phdslam_tpu_torch.filters import phd as tphd
from phdslam_tpu_torch.kernels import build
from phdslam_tpu_torch.kernels.detect import detect, detect_reference
from phdslam_tpu_torch.kernels.gather_rows import (gather_rows,
                                                   gather_rows_reference)
from phdslam_tpu_torch.kernels.merge import (merge2d, merge2d_tables,
                                             merge2d_tables_reference,
                                             tables_operands)
from phdslam_tpu_torch.models import measurement as tmeas
from phdslam_tpu_torch.ops import ekf as tekf
from phdslam_tpu_torch.ops.gm_merge import merge_out
from test_consolidate import base_cfg, make_scene
from test_torch_kernels import detect_case


def t(x):
    return torch.from_numpy(np.array(x))


def jnp_all(*xs):
    return tuple(jnp.asarray(x) for x in xs)


def assert_detect_equal(got, want):
    """(vals, idx, norm, count[, cons]) of the twin against the Pallas
    kernel's: values to rtol 1e-6, idx where selected and counts exactly,
    idx 0 elsewhere."""
    tv, ti, tn, tc = (np.asarray(x) for x in got[:4])
    kv, ki, kn, kc = (np.asarray(x) for x in want[:4])
    np.testing.assert_allclose(tn, kn, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tv, kv, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(tc, kc)
    sel = kv > 0
    np.testing.assert_array_equal(ti[sel], ki[sel])
    assert (ti[~sel] == 0).all() and (ki[~sel] == 0).all()


# ----------------------------------------------------------------------------
# detect: adaptive trips
# ----------------------------------------------------------------------------

def test_adaptive_detect_twin_bit_equal():
    """tests/test_pallas_detect.py::test_adaptive_trips_bitequal_to_static's
    case (T = 8 above the live counts, so trips run dry): the adaptive twin
    equals the static twin bit for bit and the Pallas kernel's adaptive
    trips as the plain twin does."""
    planes, z4 = detect_case(3)
    T, min_fw, cb = 8, 1e-3, 0.05
    tp, tz = t(planes), t(z4)
    got = detect_reference(tp, tz, T, min_fw, cb, adaptive=True)
    for a, s in zip(got, detect_reference(tp, tz, T, min_fw, cb)):
        assert torch.equal(a, s)
    want = detection_topT_batch(*jnp_all(planes, z4), T, min_fw, cb,
                                interpret=True, adaptive=True)
    assert_detect_equal(got, want)
    counts = got[3].numpy()
    assert (counts < T).any() and (counts > 0).any()    # dead trips ran
    build.reset_launch_counts()
    detect(tp, tz, T, min_fw, cb, adaptive=True)
    assert not build.launch_counts                       # twin: no launch


# ----------------------------------------------------------------------------
# detect: same-source pre-consolidation
# ----------------------------------------------------------------------------

def consolidating_planes(cfg, pose, mean, cov, w):
    return np.asarray(jax.vmap(
        lambda p, m, c, ww: jphd._detection_planes_single(
            p, m, c, ww, cfg, consolidate=True))(*jnp_all(pose, mean, cov,
                                                        w)))


def z4_of(z, zm):
    return np.stack([z[:, 0], z[:, 1], zm.astype(np.float32),
                     np.zeros(len(z), np.float32)], axis=1)


@pytest.mark.parametrize("seed,adaptive", [(0, False), (1, False), (2, False),
                                           (0, True)])
def test_consolidating_detect_twin_matches_pallas(seed, adaptive):
    """tests/test_consolidate.py's scenes: the twin's top-T (members left
    out), counts and the cons planes against the Pallas kernel's."""
    cfg = base_cfg()
    pose, mean, cov, w, z, zm = make_scene(seed)
    planes, z4 = consolidating_planes(cfg, pose, mean, cov, w), z4_of(z, zm)
    T, min_fw = cfg.detection_topk, float(cfg.min_feature_weight)
    cb, min_sep = float(cfg.clutter_density + cfg.birth_weight), \
        float(cfg.min_separation)
    want = detection_topT_batch(*jnp_all(planes, z4), T, min_fw, cb,
                                interpret=True, min_sep=min_sep,
                                adaptive=adaptive)
    got = detect(t(planes), t(z4), T, min_fw, cb, min_sep=min_sep,
                 adaptive=adaptive)
    assert_detect_equal(got, want)
    tc, kc = got[4].numpy(), np.asarray(want[4])
    np.testing.assert_array_equal(tc[:, 8:], kc[:, 8:])  # n_members, pers_in
    np.testing.assert_array_equal(tc[:, 6:8], kc[:, 6:8])  # head coords
    np.testing.assert_allclose(tc[:, :6], kc[:, :6], rtol=1e-4, atol=1e-6)
    assert (tc[:, 8] > 0).any() and (tc[:, 9] > 0).any()


def test_consolidating_detect_far_persistent_and_persistent_head():
    """A column whose live persistent copy lies beyond min_sep of the head
    copy keeps all its copies (tests/test_consolidate.py's far-persistent
    scene), and a column headed by a heavy persistent lane consolidates
    about (0, 0)."""
    cfg = base_cfg(max_features=8, max_measurements=2, detection_topk=4,
                   clutter_rate=1.0)
    P, K = 2, 8
    pose = np.zeros((P, 6), np.float32)
    mean = np.zeros((P, K, 2), np.float32)
    mean[:, 0] = [5.0, 0.0]
    cov = np.broadcast_to(np.eye(2, dtype=np.float32), (P, K, 2, 2)).copy()
    w = np.zeros((P, K), np.float32)
    w[:, 0] = 1.0
    z = np.array([[8.0, 0.0], [5.1, 0.02]], np.float32)
    zm = np.array([True, False])
    cov[1, 0] = 0.02 * np.eye(2)             # particle 1: a tight feature
    w[1, 0] = 50.0                           # whose persistent lane heads
    z_near = np.array([[5.05, 0.01], [0.0, 0.0]], np.float32)
    planes = consolidating_planes(cfg, pose, mean, cov, w)
    min_sep = float(cfg.min_separation)
    cb = float(cfg.clutter_density + cfg.birth_weight)
    for zz in (z, z_near):
        z4 = z4_of(zz, zm)
        want = detection_topT_batch(*jnp_all(planes, z4), 4,
                                    float(cfg.min_feature_weight), cb,
                                    interpret=True, min_sep=min_sep)
        got = detect(t(planes), t(z4), 4, float(cfg.min_feature_weight), cb,
                     min_sep=min_sep)
        assert_detect_equal(got, want)
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                                   rtol=1e-4, atol=1e-6)
    # the far column: live, but no member and pers_in 0
    far = detect(t(planes), t(z4_of(z, zm)), 4,
                 float(cfg.min_feature_weight), cb, min_sep=min_sep)
    assert far[3][0, 0] == 1 and far[4][0, 8, 0] == 0 and far[4][0, 9, 0] == 0
    # the persistent head: the copy is a member, about (0, 0)
    near = detect(t(planes), t(z4_of(z_near, zm)), 4,
                  float(cfg.min_feature_weight), cb, min_sep=min_sep)
    assert near[4][1, 8, 0] == 1 and near[4][1, 9, 0] == 1
    assert near[4][1, 6, 0] == 0 and near[3][1, 0] == 0


def port_pre(cfg, pose, mean, cov, w):
    """The port's in-range mask and EKF pre-update of a scene."""
    pose_b = t(pose)[:, None, :]
    cls = tmeas.classify_in_range(pose_b, t(mean), t(w), cfg)
    return (cls == tmeas.IN_RANGE,
            tekf.ekf_preupdate(pose_b, t(mean), t(cov), cfg))


def test_detection_planes_consolidate_matches_jax():
    cfg = base_cfg()
    pose, mean, cov, w, _, _ = make_scene(1)
    in_m, pre = port_pre(cfg, pose, mean, cov, w)
    got = tphd._detection_planes(in_m, pre, t(w), True, t(cov),
                                 cfg.min_feature_weight).numpy()
    want = consolidating_planes(cfg, pose, mean, cov, w)
    assert got.shape == want.shape == (4, 13, 32)
    # rows 8 and 11 are the off-diagonal q01 of the quadratics G' C^-1 G
    # (rows 7-9 and 10-12): a sum of three products that cancel, so both
    # frameworks' f32 values carry an error set by the diagonal, not by q01
    # itself. Against a float64 evaluation of the same formulas on the same
    # inputs, JAX's q01 lies up to 1.2e-6 and the port's up to 1.6e-6 of
    # sqrt(q00 q11) away (2.2e-4 absolute on a q01 of 12); so each q01 is
    # held to 4e-6 of its own column's sqrt(q00 q11), every other row to
    # rtol 1e-5.
    off = np.array([8, 11])
    rest = np.setdiff1d(np.arange(13), off)
    np.testing.assert_allclose(got[:, rest], want[:, rest], rtol=1e-5,
                               atol=1e-6)
    scale = np.sqrt(np.abs(want[:, off - 1] * want[:, off + 1]))
    assert (np.abs(got[:, off] - want[:, off]) <= 4e-6 * scale).all()
    assert (got[:, 6] > 0).any()


# ----------------------------------------------------------------------------
# tables with the consolidated rows
# ----------------------------------------------------------------------------

def test_tables_and_combine_with_cons_rows_match_jax():
    cfg = base_cfg()
    pose, mean, cov, w, z, _ = make_scene(2)
    P, K, _ = mean.shape
    M = z.shape[0]
    rng = np.random.default_rng(5)
    cons_rows = rng.normal(0, 1, (5, P, K)).astype(np.float32)
    b_mean = rng.normal(0, 5, (P, M, 2)).astype(np.float32)
    b_cov = np.broadcast_to(np.eye(2, dtype=np.float32), (P, M, 2, 2)).copy()

    def jax_tables(p, m, c, bm, bc, cr):
        pre = jekf.ekf_preupdate(p, m, c, cfg)
        return jekf.candidate_tables_T(m, c, pre, jnp.asarray(z), bm, bc,
                                       cons_rows=tuple(cr))
    jt_k, jt_m = jax.vmap(jax_tables, in_axes=(0, 0, 0, 0, 0, 1))(
        *jnp_all(pose, mean, cov, b_mean, b_cov, cons_rows))
    _, pre = port_pre(cfg, pose, mean, cov, w)
    tt_k, tt_m = tekf.candidate_tables_T(t(mean), t(cov), pre, t(z),
                                         t(b_mean), t(b_cov),
                                         tuple(t(cons_rows)))
    assert tt_k.shape == (P, 21, K)
    np.testing.assert_allclose(tt_k.numpy(), np.asarray(jt_k), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(tt_m.numpy(), np.asarray(jt_m))

    cap = 24
    r_k = rng.normal(0, 3, (P, 21, cap)).astype(np.float32)
    r_m = rng.normal(0, 3, (P, 8, cap)).astype(np.float32)
    kind = rng.integers(0, 3, (P, cap))
    is_p, is_d = kind == 0, kind == 1
    sel = rng.random((P, cap)) < 0.8
    want = jekf.combine_selected_planes(*jnp_all(r_k, r_m, is_p, is_d, sel),
                                        2, True, cons_rows=True)
    got = tekf.combine_selected_planes(t(r_k), t(r_m), t(is_p), t(is_d),
                                       t(sel), 2, True, cons_rows=True)
    for g, wnt in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


# ----------------------------------------------------------------------------
# the fused gather + merge
# ----------------------------------------------------------------------------

# tests/test_pallas_merge.py::test_fused_gather_merge_matches_two_kernel_route's
# configuration, as the PHD filter with cluster-process weighting (the
# port's PHD update) and the detect kernel in interpret mode
FUSED = dict(n_particles=8, max_features=16, max_measurements=8,
             filter_type=0, particle_weighting=0,
             motion_type=0, feature_model=0, max_range=15.0, std_range=0.25,
             std_bearing=0.02, clutter_rate=5.0, pd=0.95, birth_weight=0.05,
             min_separation=2.0, seed=0, pallas_merge=2, pallas_detect=2,
             merge_candidate_cap=64, detection_topk=4, merge_r_par=1)


def fused_scene():
    """The JAX fused-merge test's inputs."""
    rng = np.random.default_rng(0)
    P, K, M = 8, 16, 8
    pose = rng.normal(0, 1, (P, 6)).astype(np.float32)
    mean = rng.uniform(-10, 10, (P, K, 2)).astype(np.float32)
    cov = np.broadcast_to(np.eye(2, dtype=np.float32) * 0.3,
                          (P, K, 2, 2)).copy()
    weight = ((rng.random((P, K)) < 0.7).astype(np.float32)
              * rng.random((P, K)).astype(np.float32))
    z = rng.uniform(0, 8, (M, 2)).astype(np.float32)
    zm = np.arange(M) < 5
    return pose, mean, cov, weight, z, zm


def fused_inputs(metric):
    """The port's deferred-gather payload of the fused scene as the
    tables kernel takes it: ints, flts, t_k, t_m."""
    cfg = SlamConfig(**dict(FUSED, distance_metric=metric,
                            min_separation=0.6 if metric else 2.0))
    pre = tphd._update_pre(*(t(x) for x in fused_scene()), cfg)
    g = pre["gather"]
    ints, flts = tables_operands(g)
    return cfg, g, ints, flts, g["t_k"], g["t_m"]


@pytest.mark.parametrize("metric", [0, 1])
def test_merge2d_tables_twin_matches_pallas(metric):
    """The twin against the Pallas fused kernel on the same tables, and
    against the port's own two-kernel route (gather_cols twice, the
    combine, merge2d): equal counts, values to rtol 1e-5."""
    cfg, g, ints, flts, t_k, t_m = fused_inputs(metric)
    min_sep, K = float(cfg.min_separation), cfg.max_features
    build.reset_launch_counts()
    got = merge_out(merge2d_tables(ints, flts, t_k, t_m, min_sep, K,
                                   metric), 2)
    assert not build.launch_counts
    want = gm_merge_pallas_batch_tables(
        *jnp_all(ints.numpy(), flts.numpy(), t_k.numpy(), t_m.numpy()),
        min_sep, K, interpret=True, r_par=1, metric=metric, sorted_w=True)
    for name, gv, wv in zip(("mean", "cov", "w"), got[:3], want[:3]):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert (got[3] > 2).all()
    two = merge_out(merge2d(tphd._finish_candidates_packed(g, 2), min_sep, K,
                            metric=metric), 2)
    for a, b in zip(got, two):
        assert torch.equal(a, b)
    assert torch.equal(merge2d_tables_reference(ints, flts, t_k, t_m,
                                                min_sep, K, metric),
                       merge2d_tables(ints, flts, t_k, t_m, min_sep, K,
                                      metric))


# ----------------------------------------------------------------------------
# the row gather
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("P,cap,R,C", [
    (16, 64, 32, 16),     # K-table shape class
    (16, 64, 8, 8),       # M-table shape class (small R)
    (5, 33, 7, 3),        # ragged: P not a block multiple, odd dims
    (1, 8, 4, 2),         # single particle
])
def test_gather_rows_twin_matches_pallas(P, cap, R, C):
    """tests/test_pallas_select.py::test_rows_match_xla's shapes: exact."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, R, (P, cap)).astype(np.int32)
    tab = rng.normal(size=(P, R, C)).astype(np.float32)
    want = np.asarray(onehot_rows_batch(*jnp_all(idx, tab), interpret=True))
    build.reset_launch_counts()
    got = gather_rows(t(idx), t(tab)).numpy()
    assert not build.launch_counts
    np.testing.assert_array_equal(got, want)


def test_gather_rows_out_of_range_gives_zero_row():
    tab = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3)
    idx = torch.tensor([[0, 3, 4, -1], [2, 9, 1, 0]], dtype=torch.int32)
    got = gather_rows_reference(idx, tab)
    want = np.asarray(onehot_rows_xla(jnp.asarray(idx.numpy()),
                                      jnp.asarray(tab.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, 2:] == 0).all() and (got[1, 1] == 0).all()
    assert torch.equal(got[0, 1], tab[0, 3])


# ----------------------------------------------------------------------------
# the PHD update with each knob
# ----------------------------------------------------------------------------

def port_update(cfg, scene):
    out = tphd._batched_update(*(t(x) for x in scene), cfg)
    return [x.numpy() for x in out]


def jax_update(cfg, scene):
    out = jax.jit(lambda *a: jphd._batched_update(*a, cfg))(*jnp_all(*scene))
    return [np.asarray(x) for x in out]


def assert_update_close(got, want):
    """(mean, cov, w, dlog_w, overflow) within rtol 1e-4 / atol 1e-5
    (covariances rtol 1e-3), the overflow exactly. A slot may hold another
    component of the same particle where the two weights tie within that
    tolerance: the post-merge compaction sorts by weight, and two weights
    one ulp apart can round into either order."""
    g_mean, g_cov, g_w, g_dlw, g_ovf = got
    w_mean, w_cov, w_w, w_dlw, w_ovf = want
    np.testing.assert_allclose(g_w, w_w, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g_dlw, w_dlw, rtol=1e-4, atol=1e-5)
    same = np.isclose(g_mean, w_mean, rtol=1e-4, atol=1e-5).all(axis=-1)
    live = w_w > 1e-6
    for p, k in np.argwhere(live & ~same):
        tied = np.isclose(w_w[p], g_w[p, k], rtol=1e-4, atol=1e-5)
        there = np.isclose(w_mean[p], g_mean[p, k], rtol=1e-4,
                           atol=1e-5).all(axis=-1)
        assert (tied & there).any(), (p, k)
    keep = live & same
    np.testing.assert_allclose(g_cov[keep], w_cov[keep], rtol=1e-3,
                               atol=1e-5)
    assert (live & ~same).sum() <= 2
    np.testing.assert_array_equal(g_ovf, w_ovf)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consolidated_update_matches_jax(seed):
    """premerge_consolidate=1 on tests/test_consolidate.py's scenes, both
    packages with the knob on; the persistent lanes take the moment-matched
    member clusters, so the update differs from the plain one."""
    kw = dict(premerge_consolidate=1, pallas_merge=2, merge_r_par=1)
    scene = make_scene(seed)
    got = port_update(SlamConfig(**dataclasses.asdict(base_cfg(**kw))),
                      scene)
    assert_update_close(got, jax_update(base_cfg(**kw), scene))
    plain = port_update(SlamConfig(**dataclasses.asdict(base_cfg())), scene)
    assert not np.array_equal(got[0], plain[0])


def test_consolidation_skipped_when_persistent_far_matches_jax():
    """tests/test_consolidate.py's exactness gate: with the persistent copy
    beyond min_sep of the head, the consolidated update is bit-identical
    to the plain one, and both match JAX."""
    kw = dict(max_features=8, max_measurements=2, detection_topk=4,
              merge_candidate_cap=16, clutter_rate=1.0)
    P, K = 2, 8
    mean = np.zeros((P, K, 2), np.float32)
    mean[:, 0] = [5.0, 0.0]
    w = np.zeros((P, K), np.float32)
    w[:, 0] = 1.0
    scene = (np.zeros((P, 6), np.float32), mean,
             np.broadcast_to(np.eye(2, dtype=np.float32), (P, K, 2, 2)).copy(),
             w, np.array([[8.0, 0.0], [0.0, 0.0]], np.float32),
             np.array([True, False]))
    cons = port_update(SlamConfig(**dataclasses.asdict(base_cfg(
        premerge_consolidate=1, **kw))), scene)
    plain = port_update(SlamConfig(**dataclasses.asdict(base_cfg(**kw))),
                        scene)
    for a, b in zip(cons, plain):
        np.testing.assert_array_equal(a, b)
    assert_update_close(cons, jax_update(base_cfg(premerge_consolidate=1,
                                                  **kw), scene))


def test_fused_update_matches_jax():
    """fused_gather_merge=1 on the JAX fused-merge test's scene: the port's
    fused route against the JAX fused route, and equal to the port's
    two-kernel route bit for bit."""
    scene = fused_scene()
    cfg = SlamConfig(**dict(FUSED, fused_gather_merge=1))
    got = port_update(cfg, scene)
    assert_update_close(got, jax_update(
        JaxSlamConfig(**dict(FUSED, fused_gather_merge=1)), scene))
    two = port_update(dataclasses.replace(cfg, fused_gather_merge=0), scene)
    for a, b in zip(got, two):
        np.testing.assert_array_equal(a, b)


def test_check_supported_accepts_the_knobs():
    K, M = 32, 8
    for kw in (dict(premerge_consolidate=1), dict(fused_gather_merge=1),
               dict(detect_adaptive=1),
               dict(premerge_consolidate=1, fused_gather_merge=1,
                    detect_adaptive=1, distance_metric=1)):
        tphd.check_supported(SlamConfig(**dataclasses.asdict(base_cfg(**kw))),
                             K, M)
    assert tphd.consolidates(SlamConfig(premerge_consolidate=1,
                                        particle_weighting=0))
    assert not tphd.consolidates(SlamConfig(premerge_consolidate=1,
                                            distance_metric=1))
