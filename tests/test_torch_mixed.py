"""The mixed jump-Markov path of the port against the JAX package.

The same numpy inputs go through the JAX functions and their counterparts
in ``phdslam_tpu_torch``: the CV vehicle and the feature motion models, the
4D birth, the D=4 EKF tables, the 4D merge twin (against the Pallas 4D
kernel in interpret mode and the XLA merge), the detect twin in the mode
the mixed update runs it (min_fw = 0, cb = 0), ``mixed_update``, ten
replayed mixed filter steps, ``evaluate_mixed``, and the numpy copies of
``eval/simdata.py`` and ``eval/ospa.py``. On the CPU the port's kernel
wrappers run their plain twins; the JAX Pallas kernels run in interpret
mode (pallas_detect=2, pallas_merge=2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.config import SlamConfig as JaxSlamConfig
from phdslam_tpu.eval import ospa as jospa
from phdslam_tpu.eval import simdata as jsim
from phdslam_tpu.eval.parity import _mixed_world as jax_mixed_world
from phdslam_tpu.filters.mixed import mixed_update as jax_mixed_update
from phdslam_tpu.filters.phd import make_step_fn
from phdslam_tpu.models import feature_motion as jfm
from phdslam_tpu.models import measurement as jmeas
from phdslam_tpu.models import vehicle as jveh
from phdslam_tpu.ops import ekf as jekf
from phdslam_tpu.ops import math as jmath
from phdslam_tpu.ops.gm_merge import gm_merge_batch as jax_gm_merge_batch
from phdslam_tpu.ops.pallas_detect import detection_topT_batch
from phdslam_tpu.ops.pallas_merge import gm_merge_pallas_batch_packed_4d
from phdslam_tpu.types import init_state as jax_init_state
from phdslam_tpu_torch.config import SlamConfig
from phdslam_tpu_torch.eval import ospa as tospa
from phdslam_tpu_torch.eval import simdata as tsim
from phdslam_tpu_torch.eval.parity import _mixed_world, evaluate_mixed
from phdslam_tpu_torch.filters.mixed import mixed_update
from phdslam_tpu_torch.filters.phd import check_supported, phd_step
from phdslam_tpu_torch.kernels import build
from phdslam_tpu_torch.kernels.detect import detect_reference
from phdslam_tpu_torch.kernels.merge import merge4d, merge4d_reference
from phdslam_tpu_torch.models import feature_motion as tfm
from phdslam_tpu_torch.models import measurement as tmeas
from phdslam_tpu_torch.models import vehicle as tveh
from phdslam_tpu_torch.ops import ekf as tekf
from phdslam_tpu_torch.ops import math as tmath
from phdslam_tpu_torch.ops.gm_merge import (gm_merge_batch, merge_out,
                                            unpack_planes)
from phdslam_tpu_torch.types import init_state, state_from_jax, state_to_numpy
from merge_bench import MIN_SEP, merge_edge_case
from test_torch_kernels import MERGE_EDGES_3D4D, active_first, detect_case
from test_torch_step import jax_state_arrays, replay_noise

# tests/test_mixed_dynamic.py::base_cfg's shape, mixed model, the fast
# route's det mode (0 < T < K, cap < K + M K + M) and the JAX Pallas
# kernels in interpret mode. merge_r_par=1: the Pallas merge emits the same
# clusters for any R (R principals per trip only amortise TPU trips) and
# compiles twice as fast in interpret mode; the merge4d tests below run the
# kernel at its default R=8.
MIXED = dict(merge_r_par=1, n_particles=6, max_features=16, max_measurements=6,
             motion_type=0, feature_model=2, filter_type=0, max_range=25.0,
             std_range=0.25, std_bearing=0.02, clutter_rate=2.0, pd=0.95,
             birth_weight=0.05, min_separation=2.0, resample_threshold=0.3,
             ax=0.05, ay=0.05, ayaw=0.005, cov_vx_birth=1.0,
             cov_vy_birth=1.0, std_ax_map=0.2, std_ay_map=0.2, ps=0.98,
             beta=1.0, tau=0.5, merge_candidate_cap=64, detection_topk=8,
             pallas_detect=2, pallas_merge=2, seed=5)


def close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def t(x):
    return torch.from_numpy(np.array(x))


def scene4(seed=0, P=3, K=16, M=6):
    """Poses, a 4D map with empty slots, and measurements (numpy)."""
    rng = np.random.default_rng(seed)
    pose = np.zeros((P, 6), np.float32)
    pose[:, :2] = rng.normal(0, 0.5, (P, 2))
    pose[:, 2] = rng.uniform(-np.pi, np.pi, P)
    mean = np.concatenate([rng.uniform(-12, 12, (P, K, 2)),
                           rng.normal(0, 0.6, (P, K, 2))], axis=-1)
    A = rng.normal(0, 0.4, (P, K, 4, 4))
    cov = A @ A.transpose(0, 1, 3, 2) + 0.1 * np.eye(4)
    w = np.where(rng.uniform(size=(P, K)) < 0.7,
                 rng.uniform(0.05, 1.0, (P, K)), 0.0)
    mean[w == 0] = 0.0
    cov[w == 0] = np.eye(4)
    z = np.column_stack([rng.uniform(-1, 10, M),
                         rng.uniform(-np.pi, np.pi, M)])
    return tuple(x.astype(np.float32) for x in (pose, mean, cov, w, z))


# ----------------------------------------------------------------------------
# models and math
# ----------------------------------------------------------------------------

def test_cv_predict_with_given_eps():
    pose, *_ = scene4(1, P=64)
    pose[:, 3:] = np.random.default_rng(1).normal(0, 1, (64, 3))
    key = jax.random.PRNGKey(4)
    eps = np.array(jax.random.normal(key, (64, 3), dtype=jnp.float32))
    std = (0.9, 0.3, 0.09)
    want = jveh.cv_predict(jnp.asarray(pose), std, jnp.float32(0.15), key)
    got = tveh.cv_predict(t(pose), std, 0.15, t(eps))
    close(got, want, rtol=1e-5, atol=1e-5)


def test_feature_motion_matches_jax():
    _, mean, cov, w, _ = scene4(2, P=4, K=24)
    cfg = SlamConfig(**MIXED)
    scale = np.random.default_rng(2).uniform(0.2, 1.0, (2, 4, 24)).astype(
        np.float32)
    got = tfm.constant_velocity_predict(t(mean), t(cov), 0.2, 0.3, 0.5,
                                        t(scale[0]), t(scale[1]))
    want = jfm.constant_velocity_predict(
        jnp.asarray(mean), jnp.asarray(cov), 0.2, 0.3, jnp.float32(0.5),
        jnp.asarray(scale[0]), jnp.asarray(scale[1]))
    for g, j in zip(got, want):
        close(g, j, rtol=1e-5, atol=1e-5)
    got = tfm.mixed_model_predict(t(mean), t(cov), t(w), cfg, 0.5)
    want = jfm.mixed_model_predict(jnp.asarray(mean), jnp.asarray(cov),
                                   jnp.asarray(w), cfg, jnp.float32(0.5))
    for g3, j3 in zip(got, want):
        for g, j in zip(g3, j3):
            close(g, j, rtol=1e-5, atol=1e-5)
    close(tmath.logistic(t(mean[..., 2]), 0.0, 0.7, 1.5, 0.2),
          jmath.logistic(jnp.asarray(mean[..., 2]), 0.0, 0.7, 1.5, 0.2))


def test_birth_mean_cov_4d_matches_jax():
    pose, _, _, _, z = scene4(3)
    cfg = SlamConfig(**MIXED)
    got = tmeas.birth_mean_cov_4d(t(pose[:, None, :]), t(z), cfg)
    want = jmeas.birth_mean_cov_4d(jnp.asarray(pose[:, None, :]),
                                   jnp.asarray(z), cfg)
    assert got[0].shape == (3, 6, 4) and got[1].shape == (3, 6, 4, 4)
    for g, j in zip(got, want):
        close(g, j, rtol=1e-5, atol=1e-5)


def test_mahalanobis2_4d_matches_inverse_form():
    """The Schur form against JAX's ``jnp.linalg.inv`` form on
    well-conditioned covariances (they differ only in rounding)."""
    _, mean, cov, _, _ = scene4(4, P=2, K=32)
    got = tmath.mahalanobis2_4d(t(mean[:, :1]), t(cov[:, :1]), t(mean),
                                t(cov))
    want = jmath.mahalanobis2(jnp.asarray(mean[:, :1]),
                              jnp.asarray(cov[:, :1]), jnp.asarray(mean),
                              jnp.asarray(cov))
    close(got, want, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------------
# the D=4 EKF tables
# ----------------------------------------------------------------------------

def test_ekf_tables_and_combine_d4_match_jax():
    pose, mean, cov, _, z = scene4(5)
    cfg = SlamConfig(**MIXED)
    P, K, M, cap = 3, 16, 6, 40
    pb = pose[:, None, :]
    t_pre = tekf.ekf_preupdate(t(pb), t(mean), t(cov), cfg)
    j_pre = jekf.ekf_preupdate(jnp.asarray(pb), jnp.asarray(mean),
                               jnp.asarray(cov), cfg)
    for name in tekf.PreUpdate._fields:
        close(getattr(t_pre, name), getattr(j_pre, name), rtol=2e-5,
              atol=1e-6, msg=name)
    t_bm, t_bc = tmeas.birth_mean_cov_4d(t(pb), t(z), cfg)
    j_bm, j_bc = jmeas.birth_mean_cov_4d(jnp.asarray(pb), jnp.asarray(z),
                                         cfg)
    t_k, t_m = tekf.candidate_tables_T(t(mean), t(cov), t_pre, t(z), t_bm,
                                       t_bc)
    j_tabs = [jekf.candidate_tables_T(
        jnp.asarray(mean[p]), jnp.asarray(cov[p]),
        jax.tree.map(lambda x: x[p], j_pre), jnp.asarray(z), j_bm[p],
        j_bc[p]) for p in range(P)]
    # 4 mean + 16 cov + 16 cov_upd + 8 gain + r + bearing; z + birth
    assert t_k.shape == (P, 46, K) and t_m.shape == (P, 22, M)
    close(t_k, np.stack([np.asarray(a) for a, _ in j_tabs]), rtol=2e-5,
          atol=1e-5)
    close(t_m, np.stack([np.asarray(b) for _, b in j_tabs]), rtol=1e-5,
          atol=1e-5)

    rng = np.random.default_rng(5)
    flat = rng.integers(0, K + M * K + M, (P, cap))
    sel = rng.random((P, cap)) < 0.8
    k_eff, m_eff, is_p, is_d = (np.asarray(x) for x in
                                jekf.candidate_gather_indices(
                                    jnp.asarray(flat), K, M, True))
    r_k = np.take_along_axis(t_k.numpy(), k_eff[:, None, :], axis=2)
    r_m = np.take_along_axis(t_m.numpy(), m_eff[:, None, :], axis=2)
    tm, tc = tekf.combine_selected_planes(t(r_k), t(r_m), t(is_p), t(is_d),
                                          t(sel), 4, True)
    jm, jc = jekf.combine_selected_planes(
        jnp.asarray(r_k), jnp.asarray(r_m), jnp.asarray(is_p),
        jnp.asarray(is_d), jnp.asarray(sel), 4, True)
    assert len(tm) == 4 and len(tc) == 10     # the [P, 16, cap] planes
    for g, j in zip(tm + tc, jm + jc):
        close(g, j, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------------
# merge4d
# ----------------------------------------------------------------------------

def merge4d_case(seed, P=4, N=64, spread=0.3, vspread=0.3):
    """Clustered 4D candidates compacted into a weight-descending active
    prefix: planes [P, 16, N] (w, act, m0..m3, upper-triangle cov)."""
    rng = np.random.default_rng(seed)
    centers = np.concatenate([rng.normal(0, 20, (P, 8, 2)),
                              rng.normal(0, 1, (P, 8, 2))], axis=-1)
    mean = centers[np.arange(P)[:, None], rng.integers(0, 8, (P, N))] \
        + np.concatenate([rng.normal(0, spread, (P, N, 2)),
                          rng.normal(0, vspread, (P, N, 2))], axis=-1)
    A = rng.normal(0, 0.5, (P, N, 4, 4))
    cov = np.einsum("pnij,pnkj->pnik", A, A) + 0.3 * np.eye(4)
    w = rng.uniform(0, 1, (P, N))
    act = rng.random((P, N)) < 0.7
    order = np.argsort(np.where(act, -w, 1.0), axis=1, kind="stable")

    def take(x):
        return np.take_along_axis(x, order, axis=1)
    act_s = take(act)
    planes = [np.where(act_s, take(w), 0.0), act_s]
    planes += [take(mean[..., i]) for i in range(4)]
    planes += [take(cov[..., a, b]) for a in range(4) for b in range(a, 4)]
    return np.stack(planes, axis=1).astype(np.float32)


def _pallas_merge4d(planes, min_sep, K):
    return tuple(np.asarray(x) for x in gm_merge_pallas_batch_packed_4d(
        jnp.asarray(planes), min_sep, K, interpret=True, sorted_w=True))


def _twin_merge4d(planes, min_sep, K):
    out = merge4d_reference(t(planes), min_sep, K)
    assert out.shape == (planes.shape[0], 16, K)
    return tuple(x.numpy() for x in merge_out(out, 4))


def assert_same_merge(got, want):
    """Same clusters in the same greedy emission order, with the
    tolerances of tests/test_pallas_merge.py's 4D case."""
    g_mean, g_cov, g_w, g_nm, g_nd = got
    w_mean, w_cov, w_w, w_nm, w_nd = want
    np.testing.assert_array_equal(g_nm, w_nm)
    np.testing.assert_array_equal(g_nd, w_nd)
    np.testing.assert_allclose(g_w, w_w, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g_mean, w_mean, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g_cov, w_cov, rtol=1e-3, atol=2e-4)


# every case at one shape (P=4, N=64, K=16), so the interpret-mode kernel
# compiles once
MERGE4D_CASES = {
    "clustered": dict(seed=0),
    "clustered_seed1": dict(seed=1),
    "fast_movers": dict(seed=2, vspread=1.5),
}


@pytest.mark.parametrize("case", sorted(MERGE4D_CASES))
def test_merge4d_twin_matches_pallas(case):
    planes = merge4d_case(**MERGE4D_CASES[case])
    got = _twin_merge4d(planes, 4.0, 16)
    assert_same_merge(got, _pallas_merge4d(planes, 4.0, 16))
    assert (got[3] > 1).all()


def test_merge4d_twin_overflow_counts():
    """More clusters than capacity: the leftover count matches."""
    planes = merge4d_case(3, spread=100.0)
    got = _twin_merge4d(planes, 4.0, 16)
    assert_same_merge(got, _pallas_merge4d(planes, 4.0, 16))
    assert (got[3] == 16).all() and (got[4] > 0).all()


@pytest.mark.parametrize("name", MERGE_EDGES_3D4D)
def test_merge4d_twin_matches_pallas_edges(name):
    """merge_bench.MERGE_EDGES at D = 4 (P=4, the active lanes first, 128
    lanes): the twin against the Pallas kernel at its default r_par=8,
    with the tolerances above."""
    planes, K = merge_edge_case(name, D=4)
    planes = active_first(planes)
    want = _pallas_merge4d(planes, MIN_SEP, K)
    assert_same_merge(_twin_merge4d(planes, MIN_SEP, K), want)
    if "K binding" in name:
        assert (want[3] == K).all() and (want[4] > 0).all()
    if "all within" in name:
        assert (want[3] == 1).all() and (want[4] == 0).all()


def test_merge4d_twin_terminates_on_nan_weights():
    planes = merge4d_case(4)
    planes[0, 0] = np.nan            # a whole particle of NaN weights
    planes[1, 0, :8] = 0.0           # zero-weight active lanes
    got = _twin_merge4d(planes, 4.0, 16)
    assert_same_merge(got, _pallas_merge4d(planes, 4.0, 16))
    assert got[3][0] == 0 and got[4][0] == 0 and got[3][1] > 0


def test_merge4d_twin_matches_xla_merge():
    """Against the JAX XLA merge (``jnp.linalg.inv`` distance) on inputs
    where no candidate pair lies within 1e-3 of the threshold, so the two
    distance forms cannot split a decision."""
    planes = merge4d_case(5, P=3, N=48)
    mean, cov, w, act = (x.numpy() for x in unpack_planes(t(planes), 4))
    d = np.asarray(jmath.mahalanobis2(
        jnp.asarray(mean[:, :, None]), jnp.asarray(cov[:, :, None]),
        jnp.asarray(mean[:, None, :]), jnp.asarray(cov[:, None, :])))
    min_sep = 4.0
    assert np.abs(d - min_sep).min() > 1e-3
    got = gm_merge_batch(t(mean), t(cov), t(w), t(act), min_sep, 24)
    want = jax_gm_merge_batch(jnp.asarray(mean), jnp.asarray(cov),
                              jnp.asarray(w), jnp.asarray(act), min_sep, 24)
    assert_same_merge([x.numpy() for x in got], [np.asarray(x) for x in want])


def test_merge4d_wrapper_runs_twin_on_cpu():
    planes = t(merge4d_case(0))
    build.reset_launch_counts()
    assert torch.equal(merge4d(planes, 4.0, 16),
                       merge4d_reference(planes, 4.0, 16))
    assert build.launch_counts["merge4d"] == 0


# ----------------------------------------------------------------------------
# detect in the mixed mode
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_detect_twin_matches_pallas_unthresholded(seed):
    """min_fw = 0, cb = 0: the row sums are the raw pdw sums and every
    pdw > 0 lane is live (the mixed update thresholds afterwards). The
    inverse innovation covariances are scaled down so that no pdw lies in
    f32's subnormal range, where XLA's CPU exp flushes to zero and
    PyTorch's does not (a difference of the two CPU backends that would
    show in the live counts)."""
    planes, z4 = detect_case(seed, P=5, K=32, M=12, n_valid=9)
    planes[:, 2:5] *= 0.1
    T = 8
    kv, ki, kn, kc = (np.asarray(x) for x in detection_topT_batch(
        jnp.asarray(planes), jnp.asarray(z4), T, 0.0, 0.0, interpret=True))
    tv, ti, tn, tc = (x.numpy() for x in detect_reference(
        t(planes), t(z4), T, 0.0, 0.0))
    np.testing.assert_allclose(tn, kn, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tv, kv, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(tc, kc)
    np.testing.assert_array_equal(ti, ki.astype(np.int32))
    assert (tc[:, 9:] == 0).all() and (tc[:, :9] > 0).any()


# ----------------------------------------------------------------------------
# mixed_update and the mixed step
# ----------------------------------------------------------------------------

def mixed_state(cfg, seed=7, n_static=5, n_dyn=3):
    """tests/test_mixed_dynamic.py::_mixed_state_and_z as numpy: a
    multi-particle state with live features in both maps, and one scan."""
    K, M, P = cfg.max_features, cfg.max_measurements, cfg.n_particles
    rng = np.random.default_rng(seed)
    pose = np.zeros((P, 6), np.float32)
    pose[:, :2] = rng.normal(0, 0.3, (P, 2))
    ms = np.zeros((P, K, 2), np.float32)
    ws = np.zeros((P, K), np.float32)
    ms[:, :n_static] = rng.uniform(2, 9, (1, n_static, 2)) \
        + rng.normal(0, 0.05, (P, n_static, 2))
    ws[:, :n_static] = rng.uniform(0.4, 1.0, (P, n_static))
    md = np.zeros((P, K, 4), np.float32)
    wd = np.zeros((P, K), np.float32)
    md[:, :n_dyn, :2] = rng.uniform(-8, -2, (1, n_dyn, 2)) \
        + rng.normal(0, 0.05, (P, n_dyn, 2))
    md[:, :n_dyn, 2:] = rng.normal(0, 0.3, (P, n_dyn, 2))
    wd[:, :n_dyn] = rng.uniform(0.4, 1.0, (P, n_dyn))
    arrays = jax_state_arrays(jax_init_state(JaxSlamConfig(
        **dataclasses.asdict(cfg))), dynamic=True)
    arrays.update(
        pose=pose, map_mean=ms, map_weight=ws,
        map_cov=np.broadcast_to(np.eye(2, dtype=np.float32) * 0.3,
                                (P, K, 2, 2)).copy(),
        dyn_mean=md, dyn_weight=wd,
        dyn_cov=np.broadcast_to(np.eye(4, dtype=np.float32) * 0.4,
                                (P, K, 4, 4)).copy(),
        log_weight=rng.normal(0, 0.2, (P,)).astype(np.float32))
    targets = np.concatenate([ms[0, :2], md[0, :2, :2]])
    zr = rng.normal(0, cfg.std_range, 4) + np.linalg.norm(targets, axis=1)
    zb = rng.normal(0, cfg.std_bearing, 4) + np.arctan2(targets[:, 1],
                                                        targets[:, 0])
    z = np.zeros((M, 2), np.float32)
    z[:4] = np.stack([zr, zb], axis=1)
    return arrays, z, np.arange(M) < 4


def jax_state(cfg, arrays):
    s = jax_init_state(JaxSlamConfig(**dataclasses.asdict(cfg)))
    return s.replace(
        pose=jnp.asarray(arrays["pose"]),
        log_weight=jnp.asarray(arrays["log_weight"]),
        map_static=s.map_static.replace(
            mean=jnp.asarray(arrays["map_mean"]),
            cov=jnp.asarray(arrays["map_cov"]),
            weight=jnp.asarray(arrays["map_weight"])),
        map_dynamic=s.map_dynamic.replace(
            mean=jnp.asarray(arrays["dyn_mean"]),
            cov=jnp.asarray(arrays["dyn_cov"]),
            weight=jnp.asarray(arrays["dyn_weight"])))


def assert_states_close(got, want, msg=""):
    """Weights and means of both maps within rtol 1e-4 / atol 1e-5."""
    for name in ("pose", "log_weight", "map_weight", "map_mean",
                 "dyn_weight", "dyn_mean"):
        close(got[name], want[name], rtol=1e-4, atol=1e-5,
              msg=f"{name} {msg}")


@pytest.mark.parametrize("weighting,labeled", [(0, False), (1, False),
                                               (0, True), (1, True)])
def test_mixed_update_matches_jax(weighting, labeled):
    cfg = SlamConfig(**dict(MIXED, particle_weighting=weighting,
                            labeled_measurements=labeled))
    arrays, z, zm = mixed_state(cfg)
    labels = np.array([0, 0, 1, 1, 0, 1], np.int32)
    js, j_ovf = jax_mixed_update(jax_state(cfg, arrays), jnp.asarray(z),
                                 jnp.asarray(zm), cfg,
                                 z_label=jnp.asarray(labels))
    ts, t_ovf = mixed_update(state_from_jax(arrays), t(z), t(zm), cfg,
                             z_label=t(labels))
    got, want = state_to_numpy(ts), jax_state_arrays(js, dynamic=True)
    assert_states_close(got, want)
    for name in ("map_cov", "dyn_cov"):
        close(got[name], want[name], rtol=1e-3, atol=2e-4, msg=name)
    assert int(t_ovf) == int(j_ovf)
    if not labeled:     # every measurement births into the dynamic map too
        assert (got["dyn_weight"] > 0).sum() \
            > (arrays["dyn_weight"] > 0).sum()


MIXED_STEP = dict(MIXED, n_particles=8, max_features=16,
                  max_measurements=8, ax=0.3, ayaw=0.03, vx0=1.5, vyaw0=0.2,
                  max_range=12.0, std_range=0.5, clutter_rate=5.0, tau=0.2,
                  cov_vx_birth=0.25, cov_vy_birth=0.25, birth_weight=0.02,
                  std_ax_map=0.01, std_ay_map=0.01, particle_weighting=0,
                  resample_threshold=0.98)
N_MIXED_STEPS = 10


def test_mixed_phd_step_matches_jax():
    """Ten mixed steps from the same state with JAX's replayed draws:
    poses within 1e-5, weights and maps within rtol 1e-4 / atol 1e-5."""
    dt = 0.15
    w = jax_mixed_world(8, 2, N_MIXED_STEPS, dt, 3, 8)
    jcfg = JaxSlamConfig(**MIXED_STEP)
    tcfg = SlamConfig(**MIXED_STEP)
    step = make_step_fn(jcfg, donate=False)
    js = jax_init_state(jcfg)
    ts = state_from_jax(jax_state_arrays(js, dynamic=True))
    ctrl = np.zeros(2, np.float32)
    resampled = []
    for n in range(N_MIXED_STEPS):
        z, zm = w["z_all"][n], w["mask_all"][n]
        noise = replay_noise(js, jcfg)
        js, jout = step(js, jnp.asarray(z), jnp.asarray(zm),
                        jnp.asarray(ctrl), jnp.float32(dt),
                        jnp.asarray(n > 0))
        ts, tout = phd_step(ts, t(z), t(zm), (0.0, 0.0), dt, n > 0, tcfg,
                            noise)
        got, want = state_to_numpy(ts), jax_state_arrays(js, dynamic=True)
        close(got["pose"], want["pose"], rtol=0, atol=1e-5,
              msg=f"pose step {n}")
        assert_states_close(got, want, msg=f"step {n}")
        np.testing.assert_array_equal(got["resample_idx"],
                                      want["resample_idx"])
        assert int(tout.overflow) == int(jout.overflow)
        close(tout.expected_pose, jout.expected_pose, rtol=1e-4, atol=1e-5)
        resampled.append(bool(jout.resampled))
        assert bool(tout.resampled) == resampled[-1]
    assert any(resampled)
    got = state_to_numpy(ts)
    assert (got["map_weight"] > 0).sum(axis=1).min() > 0
    assert (got["dyn_weight"] > 0).sum(axis=1).min() > 0


def test_init_state_mixed_matches_jax():
    cfg = SlamConfig(**MIXED)
    got = state_to_numpy(init_state(cfg))
    want = jax_state_arrays(jax_init_state(JaxSlamConfig(**MIXED)),
                            dynamic=True)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert init_state(SlamConfig(**dict(MIXED, feature_model=0))) \
        .map_dynamic is None


@pytest.mark.parametrize("override,name", [
    (dict(feature_model=1), "feature_model"),
    (dict(birth_velocity_init=1), "birth_velocity_init"),
    (dict(particle_weighting=2), "particle_weighting"),
    (dict(compute_variance=True), "compute_variance"),
    (dict(mixed_fast_path=0), "mixed_fast_path"),
])
def test_check_supported_rejects_unported_mixed_options(override, name):
    """The options this path once refused are ported now: check_supported
    accepts each; all but the dynamic-only map (its own pipeline) and the
    two-scan births (either route) take the per-particle route."""
    from phdslam_tpu_torch.filters.mixed import uses_fast_route
    cfg = SlamConfig(**dict(MIXED, **override))
    check_supported(cfg, cfg.max_features, cfg.max_measurements)
    assert getattr(cfg, name) == override[name]
    assert uses_fast_route(cfg, cfg.max_features, cfg.max_measurements) \
        == (name in ("feature_model", "birth_velocity_init"))


# ----------------------------------------------------------------------------
# evaluate_mixed and the eval copies
# ----------------------------------------------------------------------------

def test_evaluate_mixed_on_cpu():
    r = evaluate_mixed(seed=0, n_particles=16, n_steps=6, device="cpu")
    assert r["pose_err"].shape == (6,)
    assert np.isfinite(r["pose_err"]).all() and r["mean_pose_err"] < 1.0
    assert np.isfinite(r["static_ospa"]) and np.isfinite(r["n_eff"])
    assert r["n_static_est"] > 0


def mc_rows(n_runs, seed=0):
    """Per-run evaluate_mixed rows to aggregate: random metrics, a run
    without visible movers (NaN dynamic OSPA and track error), movers of
    every speed stratum and below it."""
    rng = np.random.default_rng(seed)
    rows = []
    for s in range(n_runs):
        n_vis = 0 if s == 1 else int(rng.integers(1, 4))
        det = rng.uniform(size=n_vis) < 0.6
        rows.append({
            "mean_pose_err": float(rng.uniform(0.05, 0.3)),
            "static_ospa": float(rng.uniform(1, 3)),
            "dynamic_ospa": float(rng.uniform(1, 5)) if n_vis
            else float("nan"),
            "dyn_detected_frac": float(det.mean()) if n_vis
            else float("nan"),
            "dyn_track_err": float(rng.uniform(0.1, 1)) if det.any()
            else float("nan"),
            "vel_err": float(rng.uniform(0, 1)),
            "det_flags": [bool(d) for d in det],
            "det_any_flags": [bool(d or rng.uniform() < 0.5) for d in det],
            "det_speeds": [float(v) for v in rng.uniform(0.1, 0.8, n_vis)],
        })
    return rows


def test_evaluate_mixed_mc_aggregates_match_jax(monkeypatch):
    """The Monte-Carlo aggregate against the JAX package's on the same
    per-run rows (each module's evaluate_mixed returns them, since the two
    packages draw different noise): every mean and standard deviation
    over the runs with a value, the detection strata and the overall
    detection; the seeds and options pass through."""
    import phdslam_tpu.eval.parity as jparity
    import phdslam_tpu_torch.eval.parity as tparity
    rows = mc_rows(7)
    calls = {"jax": [], "port": []}

    def fake(which):
        def evaluate(seed, **kw):
            calls[which].append((seed, kw.get("cfg_overrides")))
            return dict(rows[seed])
        return evaluate
    monkeypatch.setattr(jparity, "evaluate_mixed", fake("jax"))
    monkeypatch.setattr(tparity, "evaluate_mixed", fake("port"))
    over = {"mixed_fast_path": 0}
    want = jparity.evaluate_mixed_mc(n_runs=7, cfg_overrides=over)
    got = tparity.evaluate_mixed_mc(n_runs=7, cfg_overrides=over,
                                    device="cpu")
    assert calls["jax"] == calls["port"] == [(s, over) for s in range(7)]
    assert got.keys() == want.keys()
    for k in want:
        if k != "runs":
            np.testing.assert_equal(got[k], want[k], err_msg=k)
    assert got["runs"] == rows
    assert np.isfinite(got["dynamic_ospa"]).all()
    assert sum(v["n"] for v in got["det_strata"].values()) \
        < sum(len(r["det_speeds"]) for r in rows)     # the slowest out


def test_evaluate_mixed_mc_on_cpu():
    """Two runs of six steps at P=8 on the CPU: the aggregate of
    evaluate_mixed's own rows."""
    from phdslam_tpu_torch.eval.parity import evaluate_mixed_mc
    r = evaluate_mixed_mc(n_runs=2, n_steps=6, n_particles=8, device="cpu")
    assert r["n_runs"] == 2 and len(r["runs"]) == 2
    poses = [run["mean_pose_err"] for run in r["runs"]]
    np.testing.assert_allclose(r["pose"], (np.mean(poses), np.std(poses)))
    assert np.isfinite(r["static_ospa"]).all() and r["pose"][0] < 1.0
    assert set(r["det_strata"]) == {"slow_0.2-0.35", "mid_0.35-0.5",
                                    "fast_0.5+"}


def test_mixed_world_and_simdata_copies_match_jax():
    want = jax_mixed_world(30, 2, 12, 0.15, 4, 32)
    got = _mixed_world(30, 2, 12, 0.15, 4, 32)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    sp = tsim.SensorParams(max_range=12.0, clutter_rate=5.0)
    jsp = jsim.SensorParams(max_range=12.0, clutter_rate=5.0)
    lm, traj = tsim.generate_world_cv(n_landmarks=20, n_steps=5, seed=2)
    jlm, jtraj = jsim.generate_world_cv(n_landmarks=20, n_steps=5, seed=2)
    np.testing.assert_array_equal(lm, jlm)
    np.testing.assert_array_equal(traj, jtraj)
    np.testing.assert_array_equal(tsim.true_measurements(traj[3], lm, sp),
                                  jsim.true_measurements(jtraj[3], jlm, jsp))
    np.testing.assert_array_equal(
        tsim.noisy_measurements(traj[3], lm, sp, np.random.default_rng(1)),
        jsim.noisy_measurements(jtraj[3], jlm, jsp,
                                np.random.default_rng(1)))
    a = np.linspace(-10, 10, 101)
    np.testing.assert_array_equal(tsim.wrap_angle(a), jsim.wrap_angle(a))


def test_ospa_copy_matches_jax():
    rng = np.random.default_rng(9)
    for m, n in ((5, 8), (8, 5), (0, 3), (0, 0), (6, 6)):
        X, Y = rng.uniform(-10, 10, (m, 2)), rng.uniform(-10, 10, (n, 2))
        for c in (1.0, 5.0):
            close(tospa.ospa_distance(X, Y, p=1, c=c),
                  jospa.ospa_distance(X, Y, p=1, c=c), rtol=1e-12, atol=0)
    w = rng.uniform(0, 1, 12) * (rng.random(12) < 0.7)
    means = rng.normal(0, 3, (12, 2))
    np.testing.assert_array_equal(tospa.extract_map_estimate(w, means),
                                  jospa.extract_map_estimate(w, means))
