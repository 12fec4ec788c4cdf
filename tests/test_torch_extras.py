"""The port's ``filters/extras.py`` (EAP map, MC map variance, scheme-2
weighting) and the ops it added, against the JAX package on the same numpy
inputs (Pallas merges in interpret mode, pallas_merge=2), plus
``check_supported``'s surface for them and the state's variance.

Tolerances: maps rtol 1e-4 / atol 1e-5 with equal cluster counts, the MC
estimators rtol 1e-4 on JAX's draws, scheme-2 increments atol 1e-4 in the
log domain, indices equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.config import SlamConfig as JaxSlamConfig
from phdslam_tpu.filters import extras as jex
from phdslam_tpu.ops import ekf as jekf
from phdslam_tpu.ops import gm_merge as jgm
from phdslam_tpu.ops import math as jmath
from phdslam_tpu.types import GMState as JGMState
from phdslam_tpu.types import init_state as jax_init_state
from phdslam_tpu_torch.config import SlamConfig
from phdslam_tpu_torch.filters import extras as tex
from phdslam_tpu_torch.filters.phd import check_supported
from phdslam_tpu_torch.ops import ekf as tekf
from phdslam_tpu_torch.ops import gm_merge as tgm
from phdslam_tpu_torch.ops import math as tmath
from phdslam_tpu_torch.types import GMState, state_from_jax, state_to_numpy
from test_torch_step import jax_state_arrays


def close(got, want, rtol=1e-4, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def random_maps(P, K, seed, sites=6, live=0.6, spread=0.4, scale=20.0):
    """P particle maps of K slots around a few shared sites (so the tree
    merges across particles), about ``live`` of the slots filled, weights
    in (0.05, 1), covariances 0.1-0.4 I with a random correlation."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-scale, scale, (sites, 2))
    mean = centers[rng.integers(0, sites, (P, K))] \
        + rng.normal(0, spread, (P, K, 2))
    w = np.where(rng.random((P, K)) < live, rng.uniform(0.05, 1.0, (P, K)),
                 0.0)
    a = rng.uniform(0.1, 0.4, (P, K, 2))
    c01 = rng.uniform(-0.5, 0.5, (P, K)) * np.sqrt(a[..., 0] * a[..., 1])
    cov = np.stack([np.stack([a[..., 0], c01], -1),
                    np.stack([c01, a[..., 1]], -1)], -2)
    cov = np.where(w[..., None, None] > 0, cov, np.eye(2))
    mean = np.where(w[..., None] > 0, mean, 0.0)
    lw = rng.normal(0, 0.5, P)
    lw = lw - np.log(np.exp(lw).sum())
    return (mean.astype(np.float32), cov.astype(np.float32),
            w.astype(np.float32), lw.astype(np.float32))


def both_maps(mean, cov, w):
    return (JGMState(mean=jnp.asarray(mean), cov=jnp.asarray(cov),
                     weight=jnp.asarray(w)),
            GMState(mean=t(mean), cov=t(cov), weight=t(w)))


def assert_maps_close(got, want, msg=""):
    gw, ww = got[2].numpy(), np.asarray(want[2])
    assert (gw > 0).sum() == (ww > 0).sum(), msg
    for g, j in zip(got[:3], want[:3]):
        close(g.numpy(), j, msg=msg)


# ----------------------------------------------------------------------------
# EAP
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("P,metric,tree_cap,out_cap", [
    (8, 0, 0, None), (7, 0, 0, None), (5, 1, 0, None), (6, 0, 48, 24)],
    ids=["even", "odd", "hellinger_odd", "tree_cap"])
def test_eap_tree_matches_jax(P, metric, tree_cap, out_cap):
    """The pairwise tree at even and odd P (the odd level's empty pad map
    in the last pair's second half), the Hellinger metric, a wider
    eap_tree_cap and another out_cap; return_dropped counts equal."""
    K = 16
    mean, cov, w, lw = random_maps(P, K, seed=P + 10 * metric)
    kw = dict(min_separation=0.6 if metric else 3.0, distance_metric=metric,
              eap_tree_cap=tree_cap)
    jg, tg = both_maps(mean, cov, w)
    want = jex.eap_expected_map(jg, jnp.asarray(lw),
                                JaxSlamConfig(pallas_merge=2, **kw),
                                out_cap=out_cap, return_dropped=True)
    got = tex.eap_expected_map(tg, t(lw), SlamConfig(**kw), out_cap=out_cap,
                               return_dropped=True)
    assert_maps_close(got, want)
    assert int(got[3]) == int(want[3])
    assert (got[2].numpy() > 0).sum() > 1


def test_eap_tree_dropped_mass_matches_jax():
    """The JAX package's dropped-mass scene (every pair holds 2K separate
    clusters over the K intermediate cap): the narrow tree drops, the
    wide eap_tree_cap = P K keeps the global top out_cap."""
    P, K = 8, 8
    rng = np.random.default_rng(5)
    mean = rng.uniform(-200, 200, (P, K, 2)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (P, K)).astype(np.float32)
    cov = np.broadcast_to(np.eye(2, dtype=np.float32) * 0.01,
                          (P, K, 2, 2)).copy()
    lw = np.full((P,), -np.log(P), np.float32)
    jg, tg = both_maps(mean, cov, w)
    for tree_cap in (0, P * K):
        kw = dict(min_separation=0.5, eap_tree_cap=tree_cap)
        want = jex.eap_expected_map(jg, jnp.asarray(lw),
                                    JaxSlamConfig(pallas_merge=2, **kw),
                                    out_cap=2 * K, return_dropped=True)
        got = tex.eap_expected_map(tg, t(lw), SlamConfig(**kw),
                                   out_cap=2 * K, return_dropped=True)
        assert_maps_close(got, want, msg=f"tree_cap {tree_cap}")
        assert int(got[3]) == int(want[3])
        if tree_cap == 0:
            assert int(got[3]) > 0


@pytest.mark.parametrize("P,metric", [(2, 0), (1, 0), (4, 0), (2, 1)])
def test_eap_flat_matches_jax(P, metric):
    """The flat form: one argmax-principal merge over all P K lanes (the
    tree's P <= 2 route, and called directly at P = 4)."""
    K = 16
    mean, cov, w, lw = random_maps(P, K, seed=20 + P, sites=4)
    kw = dict(min_separation=0.6 if metric else 3.0, distance_metric=metric)
    jg, tg = both_maps(mean, cov, w)
    jcfg, tcfg = JaxSlamConfig(pallas_merge=2, **kw), SlamConfig(**kw)
    want = jex.eap_expected_map_flat(jg, jnp.asarray(lw), jcfg)
    got = tex.eap_expected_map_flat(tg, t(lw), tcfg)
    assert_maps_close(got, want)
    if P <= 2:
        assert_maps_close(tex.eap_expected_map(tg, t(lw), tcfg),
                          jex.eap_expected_map(jg, jnp.asarray(lw), jcfg))


def test_sort_lanes_desc_matches_jax():
    """Weight-descending lanes with the payload carried; exact weight
    ties and the zero-weight tail keep their lane order."""
    rng = np.random.default_rng(3)
    B, N = 4, 24
    w = rng.choice([0.0, 0.25, 0.5, 0.7], (B, N)).astype(np.float32)
    mean = rng.normal(0, 5, (B, N, 2)).astype(np.float32)
    c = rng.uniform(0.1, 1.0, (B, N, 3)).astype(np.float32)
    cov = np.stack([np.stack([c[..., 0], c[..., 1]], -1),
                    np.stack([c[..., 1], c[..., 2]], -1)], -2)
    jm, jc, jw = jex._sort_lanes_desc(jnp.asarray(mean), jnp.asarray(cov),
                                      jnp.asarray(w))
    planes = torch.stack([t(w), t(w > 0).float(), t(mean[..., 0]),
                          t(mean[..., 1]), t(c[..., 0]), t(c[..., 1]),
                          t(c[..., 2])], dim=1)
    got = tex.sort_lanes_desc(planes).numpy()
    np.testing.assert_array_equal(got[:, 0], np.asarray(jw))
    np.testing.assert_array_equal(got[:, 1], np.asarray(jw) > 0)
    np.testing.assert_array_equal(got[:, 2:4], np.moveaxis(np.asarray(jm),
                                                           -1, 1))
    for i, (a, b) in enumerate(((0, 0), (0, 1), (1, 1))):
        np.testing.assert_array_equal(got[:, 4 + i], np.asarray(jc)[..., a, b])


# ----------------------------------------------------------------------------
# ops
# ----------------------------------------------------------------------------

def test_topk_compact_indices_matches_jax():
    """Indices, values, masks and the dropped count equal to lax.top_k's,
    with exact weight ties, inactive lanes and w <= 0 lanes."""
    rng = np.random.default_rng(4)
    P, N, cap = 5, 40, 12
    w = rng.choice([0.0, 0.1, 0.3, 0.3, 0.6, -0.2], (P, N)).astype(np.float32)
    act = rng.random((P, N)) < 0.8
    act[0] = False                       # nothing live
    got = tgm.topk_compact_indices(t(w), t(act), cap)
    for p in range(P):
        want = jgm.topk_compact_indices(jnp.asarray(w[p]), jnp.asarray(act[p]),
                                        cap)
        sel = np.asarray(want[2])
        np.testing.assert_array_equal(got[2][p].numpy(), sel)
        # lax.top_k orders the dead tail by index too
        np.testing.assert_array_equal(got[0][p].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1][p].numpy(), np.asarray(want[1]))
        assert int(got[3][p]) == int(want[3])


def test_gaussian_logpdf_and_means_at_match_jax():
    rng = np.random.default_rng(6)
    mean, cov, w, _ = random_maps(3, 10, seed=6)
    x = rng.normal(0, 10, (3, 10, 2)).astype(np.float32)
    close(tmath.gaussian_logpdf(t(x), t(mean), t(cov)).numpy(),
          jmath.gaussian_logpdf(jnp.asarray(x), jnp.asarray(mean),
                                jnp.asarray(cov)), rtol=1e-5, atol=1e-5)
    cfg = JaxSlamConfig(max_range=40.0)
    pose = np.zeros((3, 6), np.float32)
    pose[:, 2] = rng.uniform(-0.3, 0.3, 3)
    z = np.stack([rng.uniform(2, 30, 6), rng.uniform(-1, 1, 6)],
                 1).astype(np.float32)
    pre_t = tekf.ekf_preupdate(t(pose[:, None]), t(mean), t(cov), cfg)
    m_src, k_src = np.array([0, 5, 2]), np.array([9, 0, 4])
    got = tekf.ekf_detection_means_at(pre_t, t(mean), t(z), t(m_src),
                                      t(k_src))
    for p in range(3):
        pre_j = jekf.ekf_preupdate(jnp.asarray(pose[p]), jnp.asarray(mean[p]),
                                   jnp.asarray(cov[p]), cfg)
        want = jekf.ekf_detection_means_at(pre_j, jnp.asarray(mean[p]),
                                           jnp.asarray(z),
                                           jnp.asarray(m_src[p:p + 1]),
                                           jnp.asarray(k_src[p:p + 1]))
        close(got[p].numpy(), np.asarray(want)[0], rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------------
# MC variance on JAX's draws
# ----------------------------------------------------------------------------

def test_mc_variance_packed_matches_jax():
    P, N = 4, 48
    mean, cov, w, _ = random_maps(P, N, seed=7)
    planes = np.stack([w, (w > 0).astype(np.float32), mean[..., 0],
                       mean[..., 1], cov[..., 0, 0], cov[..., 0, 1],
                       cov[..., 1, 1]], axis=1)
    is_nd = np.random.default_rng(8).random((P, N)) < 0.3
    key = jax.random.PRNGKey(3)
    want = jex.mc_variance_packed(jnp.asarray(planes), jnp.asarray(is_nd), 16,
                                  key)

    def draw(s, shape):
        return t(jax.random.normal(jax.random.fold_in(key, s), shape,
                                   jnp.float32))
    got = tex.mc_variance_packed(t(planes), t(is_nd), 16, draw)
    close(got.numpy(), want, rtol=1e-4, atol=0)


def test_mc_variance_candidates_matches_jax():
    """Per particle with its own key, as the full grid draws them."""
    P, N, n_nd = 3, 40, 12
    mean, cov, w, _ = random_maps(P, N, seed=9, scale=5.0)
    keys = jax.random.split(jax.random.PRNGKey(4), P)
    want = jax.vmap(lambda m, c, ww, k: jex.mc_variance_candidates(
        m, c, ww, n_nd, 16, k))(jnp.asarray(mean), jnp.asarray(cov),
                                jnp.asarray(w), keys)

    def draw(s, shape):
        return t(np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(keys[p], s), shape[1:], jnp.float32))
            for p in range(shape[0])]))
    got = tex.mc_variance_candidates(t(mean), t(cov), t(w), n_nd, 16, draw)
    close(got.numpy(), want, rtol=1e-4, atol=0)


def test_map_variance_matches_jax():
    P, K, S = 3, 12, 8
    mean, cov, w, _ = random_maps(P, K, seed=11, scale=5.0)
    key = jax.random.PRNGKey(5)
    jg, tg = both_maps(mean, cov, w)
    want = jex.map_variance(jg, 4, key, JaxSlamConfig(n_samples=S))
    eps = np.asarray(jax.random.normal(key, (P, K, S, 2), jnp.float32))
    got = tex.map_variance(tg, 4, S, lambda s, shape: t(eps[:, :, s]))
    close(got.numpy(), want, rtol=1e-4, atol=0)


# ----------------------------------------------------------------------------
# scheme 2
# ----------------------------------------------------------------------------

S2_CFG = dict(pd=0.95, clutter_rate=2.0, max_range=20.0)


def test_single_feature_dlogw_point_matches_jax():
    P, K = 4, 12
    pm, pc, pw, _ = random_maps(P, K, seed=12, scale=4.0)
    um, uc, uw, _ = random_maps(P, K, seed=13, scale=4.0)
    rng = np.random.default_rng(14)
    x_star = (pm[:, 0] + rng.normal(0, 0.3, (P, 2))).astype(np.float32)
    max_like = rng.uniform(0.01, 2.0, P).astype(np.float32)
    m_valid = np.array([3.0, 1.0, 5.0, 0.0], np.float32)
    jcfg = JaxSlamConfig(**S2_CFG)
    want = jax.vmap(lambda *a: jex.single_feature_dlogw_point(*a, jcfg))(
        *(jnp.asarray(x) for x in (max_like, x_star, m_valid, pm, pc, pw,
                                   um, uc, uw)))
    got = tex.single_feature_dlogw_point(
        *(t(x) for x in (max_like, x_star, m_valid, pm, pc, pw, um, uc, uw)),
        SlamConfig(**S2_CFG))
    close(got.numpy(), want, rtol=0, atol=1e-4)


def test_single_feature_dlogw_matches_jax():
    """The grid form: the argmax over valid lanes (one particle with no
    valid lane), then the point form."""
    P, M, K = 3, 4, 12
    pm, pc, pw, _ = random_maps(P, K, seed=15, scale=4.0)
    um, uc, uw, _ = random_maps(P, K, seed=16, scale=4.0)
    rng = np.random.default_rng(17)
    log_like = rng.normal(-3, 2, (P, M, K)).astype(np.float32)
    mean_det = (pm[:, None] + rng.normal(0, 0.2, (P, M, K, 2))) \
        .astype(np.float32)
    valid = rng.random((P, M, K)) < 0.5
    valid[2] = False
    jcfg = JaxSlamConfig(**S2_CFG)
    want = jax.vmap(lambda *a: jex.single_feature_dlogw(*a, jcfg))(
        *(jnp.asarray(x) for x in (log_like, mean_det, valid, pm, pc, pw,
                                   um, uc, uw)))
    got = tex.single_feature_dlogw(
        *(t(x) for x in (log_like, mean_det, valid, pm, pc, pw, um, uc, uw)),
        SlamConfig(**S2_CFG))
    close(got.numpy(), want, rtol=0, atol=1e-4)


# ----------------------------------------------------------------------------
# check_supported and the state
# ----------------------------------------------------------------------------

K_CS, M_CS = 32, 8
BASE = dict(max_features=K_CS, max_measurements=M_CS, detection_topk=8,
            merge_candidate_cap=64, n_particles=16, filter_type=0,
            particle_weighting=0)


@pytest.mark.parametrize("over", [
    dict(map_estimate=2), dict(map_estimate=2, eap_every=5),
    dict(map_estimate=2, eap_tree_cap=4096), dict(map_estimate=0),
    dict(particle_weighting=2), dict(particle_weighting=2,
                                     merge_candidate_cap=0),
    dict(compute_variance=True), dict(compute_variance=True,
                                      merge_candidate_cap=0),
    dict(n_predict_particles=3), dict(n_predict_particles=3, filter_type=1),
    dict(n_predict_particles=2, feature_model=2, motion_type=0,
         particle_weighting=1),
    dict(detection_topk=K_CS), dict(detection_topk=K_CS, filter_type=1),
    dict(detection_topk=0, particle_weighting=2, compute_variance=True),
], ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_check_supported_accepts_the_estimators(over):
    check_supported(SlamConfig(**dict(BASE, **over)), K_CS, M_CS)


@pytest.mark.parametrize("over,name", [
    (dict(feature_model=2, motion_type=0, particle_weighting=2),
     "particle_weighting"),
    (dict(feature_model=2, motion_type=0, compute_variance=True),
     "compute_variance"),
    (dict(filter_type=1, compute_variance=True), "compute_variance"),
    (dict(feature_model=1), "feature_model"),
    (dict(merge_spatial_tiles=4), "merge_spatial_tiles"),
    (dict(map_estimate=2, eap_tree_cap=4097), "eap_tree_cap"),
    (dict(feature_model=2, motion_type=0, detection_topk=K_CS),
     "detection_topk"),
    (dict(particle_weighting=1), "particle_weighting"),
])
def test_check_supported_refuses_by_name(over, name):
    """Every option once refused by name (the mixed model's weighting 2,
    variance and top-cap lanes, CPHD's variance, the dynamic-only map, the
    tiled merge, Vo's weighting, and an EAP tree whose pair exceeds
    merge2d's narrow width: its staged wide-lane variant) is ported and
    accepted."""
    check_supported(SlamConfig(**dict(BASE, **over)), K_CS, M_CS)


def test_state_carries_variance():
    """init_state's zeros, the JAX state's ``variance`` through
    state_from_jax / state_to_numpy, and a missing key read as zeros."""
    jcfg = JaxSlamConfig(n_particles=6, max_features=8)
    arrays = jax_state_arrays(jax_init_state(jcfg))
    arrays["variance"] = np.linspace(0.1, 0.6, 6).astype(np.float32)
    back = state_to_numpy(state_from_jax(arrays))
    assert back.keys() == arrays.keys()
    np.testing.assert_array_equal(back["variance"], arrays["variance"])
    del arrays["variance"]
    np.testing.assert_array_equal(state_from_jax(arrays).variance.numpy(),
                                  np.zeros(6, np.float32))
    from phdslam_tpu_torch.types import init_state
    cfg = SlamConfig(**dataclasses.asdict(jcfg))
    np.testing.assert_array_equal(init_state(cfg).variance.numpy(),
                                  np.asarray(jax_init_state(jcfg).variance))
