"""The CPHD filter, the full-grid route and the Hellinger / argmax merge of
the port against the JAX package.

The same numpy inputs go through the JAX functions and their counterparts
in ``phdslam_tpu_torch``: the CPHD constants, the cardinality convolutions,
the binomial birth cardinality, the log-domain ESF scans and the Psi terms
(both the fused prefix / suffix branch and the omitted-ESF branch); the
merge2d twin in argmax mode and with the Hellinger metric against the
Pallas kernel in interpret mode; ``cphd_update`` on the det route and on
the full-grid route, with and without gated births; the PHD full-grid
update; and replayed filter steps (CPHD on ``data/ackerman``, PHD with the
Hellinger metric). On the CPU the port's kernel wrappers run their plain
twins; the JAX Pallas kernels run in interpret mode (pallas_detect=2,
pallas_merge=2).

Tolerances: the log-domain CPHD terms agree to rtol 1e-5 (relative to
max(1, |x|): the two sides' lgamma, exp and log1p differ by an ulp or two
and the sums run in another order); merges hold equal cluster and leftover
counts, weights and means to rtol 1e-4 and covariances to 1e-3 (the JAX
merge tests' tolerances, for reassociated f32 moment sums); updated states
to rtol 1e-4 / atol 1e-5 on weights and means (one f32 update from the same
inputs), cardinalities to atol 1e-4 in the log domain within 60 nats of
their peak (the ESF recursion and Psi contractions accumulate ~1e-6
relative error over ~50 terms of magnitude up to ~100) and as
probabilities below (``test_torch_step.assert_log_card_close``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.config import SlamConfig as JaxSlamConfig
from phdslam_tpu.filters import cphd as jcphd
from phdslam_tpu.filters.phd import update as jax_update
from phdslam_tpu.ops import math as jmath
from phdslam_tpu.ops.pallas_merge import gm_merge_pallas_batch
from phdslam_tpu.types import init_state as jax_init_state
from phdslam_tpu_torch.config import SlamConfig
from phdslam_tpu_torch.filters import cphd as tcphd
from phdslam_tpu_torch.filters.phd import (check_supported, update,
                                           update_route)
from phdslam_tpu_torch.kernels import build
from phdslam_tpu_torch.kernels.cardinality import (
    cardinality_predict_reference, cardinality_product_reference)
from phdslam_tpu_torch.kernels.merge import (merge2d, merge2d_reference,
                                             merge2d_variant)
from phdslam_tpu_torch.ops import math as tmath
from phdslam_tpu_torch.ops.gm_merge import merge_out
from phdslam_tpu_torch.types import state_from_jax, state_to_numpy
from test_torch_step import (assert_log_card_close, jax_state_arrays,
                             replay_dataset)


def t(x):
    return torch.from_numpy(np.array(x))


def close_log(got, want, rtol=1e-5, msg=""):
    """Log-domain values within rtol of max(1, |want|); LOG0 entries must
    be LOG0 on both sides, and NaN never counts as agreement."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all() and np.isfinite(want).all(), msg
    np.testing.assert_array_less(np.abs(got - want),
                                 rtol * np.maximum(1.0, np.abs(want)) + 1e-30,
                                 err_msg=msg)


# ----------------------------------------------------------------------------
# cardinality machinery
# ----------------------------------------------------------------------------

CARD_CFG = dict(max_cardinality=32, clutter_rate=3.0, max_range=10.0,
                max_bearing=np.pi)


def test_cphd_constants_match_jax():
    for clutter in (2.0, 20.0):
        cfg = dict(CARD_CFG, clutter_rate=clutter, max_cardinality=64)
        want = jcphd.cphd_constants(JaxSlamConfig(**cfg))
        got = tcphd.cphd_constants(SlamConfig(**cfg))
        for name, g, w in zip(want._fields, got, want):
            close_log(g.numpy(), w, msg=name)


def test_cardinality_predict_matches_jax():
    """Both forms: the per-particle log-domain convolution (gated births)
    and the Toeplitz product (shared birth cardinality), on log
    probabilities spread over many magnitudes. The product's entries
    within 60 nats of their row's peak agree in the log domain; below
    that, f32 subnormals (which XLA's CPU flushes and PyTorch keeps) may
    turn LOG0 into a finite value, so those need only stay below."""
    rng = np.random.default_rng(3)
    log_cn = rng.uniform(-60, 0, (16, 33)).astype(np.float32)
    log_b = rng.uniform(-40, 0, (16, 33)).astype(np.float32)
    want = np.stack([np.asarray(jcphd.cardinality_predict(
        jnp.asarray(c), jnp.asarray(b))) for c, b in zip(log_cn, log_b)])
    close_log(tcphd.cardinality_predict(t(log_cn), t(log_b)).numpy(), want)
    want = np.asarray(jcphd.cardinality_predict_batch(
        jnp.asarray(log_cn), jnp.asarray(log_b[0])), np.float64)
    got = tcphd.cardinality_predict_batch(t(log_cn), t(log_b[0])).numpy() \
        .astype(np.float64)
    peak = want.max(axis=1, keepdims=True)
    near = want > peak - 60.0
    close_log(got[near], want[near])
    assert ((got - peak)[~near] < -50.0).all()


def test_cardinality_predict_batch_rows_independent():
    """The Toeplitz product sums each row in a fixed order, so a row's bits
    do not depend on the batch around it: 512 rows at once equal four
    128-row blocks and one row at a time bit for bit (what makes a sharded
    CPHD step bit-equal to one process). The batch still matches the JAX
    function as test_cardinality_predict_matches_jax holds it."""
    rng = np.random.default_rng(16)
    log_cn = rng.uniform(-60, 0, (512, 49)).astype(np.float32)
    log_b = rng.uniform(-40, 0, 49).astype(np.float32)
    whole = tcphd.cardinality_predict_batch(t(log_cn), t(log_b)).numpy()
    blocks = np.concatenate([tcphd.cardinality_predict_batch(
        t(log_cn[i:i + 128]), t(log_b)).numpy() for i in range(0, 512, 128)])
    rows = np.concatenate([tcphd.cardinality_predict_batch(
        t(log_cn[i:i + 1]), t(log_b)).numpy() for i in range(512)])
    assert np.array_equal(whole.view(np.uint32), blocks.view(np.uint32))
    assert np.array_equal(whole.view(np.uint32), rows.view(np.uint32))
    want = np.asarray(jcphd.cardinality_predict_batch(
        jnp.asarray(log_cn), jnp.asarray(log_b)), np.float64)
    got = whole.astype(np.float64)
    peak = want.max(axis=1, keepdims=True)
    near = want > peak - 60.0
    close_log(got[near], want[near])
    assert ((got - peak)[~near] < -50.0).all()


@pytest.mark.parametrize("P,C1", [(512, 65), (9, 257)])
def test_cardinality_predict_twin_matches_jax(P, C1):
    """The prediction kernel's plain twin (the CPU path of
    cardinality_predict_batch) against JAX's cardinality_predict_batch at
    the CPHD path's C1 = 65 and at the default max_cardinality's 257, with
    a row of certain cardinality and a row at LOG0 among random ones:
    test_cardinality_predict_matches_jax's 60-nat rule."""
    rng = np.random.default_rng(P + C1)
    log_cn = rng.uniform(-60, 0, (P, C1)).astype(np.float32)
    log_cn[1] = tmath.LOG0
    log_cn[1, 3] = 0.0
    log_cn[2] = tmath.LOG0
    log_b = rng.uniform(-40, 0, C1).astype(np.float32)
    got = cardinality_predict_reference(t(log_cn), t(log_b)).numpy() \
        .astype(np.float64)
    assert np.array_equal(got, tcphd.cardinality_predict_batch(
        t(log_cn), t(log_b)).numpy())
    want = np.asarray(jcphd.cardinality_predict_batch(
        jnp.asarray(log_cn), jnp.asarray(log_b)), np.float64)
    # the row at LOG0 sits where f64 cannot resolve 60 nats: held whole
    at_log0 = want.max(axis=1) < 0.5 * tmath.LOG0
    close_log(got[at_log0], want[at_log0])
    got, want = got[~at_log0], want[~at_log0]
    peak = want.max(axis=1, keepdims=True)
    near = want > peak - 60.0
    close_log(got[near], want[near])
    assert ((got - peak)[~near] < -50.0).all()


def test_cardinality_product_order():
    """The prediction twin's product sums each output j ascending from 0
    in f32, a multiply and an add each rounded (the kernel's order):
    numpy's f32 loop in that order gives the same bits; the float64
    product is within 1e-6."""
    rng = np.random.default_rng(7)
    lin = rng.uniform(0, 1, (33, 65)).astype(np.float32)
    T = np.triu(rng.uniform(0, 1, (65, 65))).astype(np.float32)
    want = np.zeros((33, 65), np.float32)
    for j in range(65):
        want = want + lin[:, j, None] * T[j]
    got = cardinality_product_reference(t(lin), t(T)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    exact = lin.astype(np.float64) @ T.astype(np.float64)
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=0)


def test_binomial_birth_cardinality_matches_jax():
    for n in (0, 3, 44):
        want = jcphd.binomial_birth_cardinality(n, 0.05, 64)
        close_log(tcphd.binomial_birth_cardinality(n, 0.05, 64).numpy(),
                  want, msg=f"n={n}")
    # per-particle counts (gated births)
    n = np.array([0, 2, 5], np.int32)
    want = np.stack([np.asarray(jcphd.binomial_birth_cardinality(
        int(k), 0.25, 16)) for k in n])
    close_log(tcphd.binomial_birth_cardinality(t(n), 0.25, 16).numpy(), want)


ESF_CASES = {
    # tests/test_cphd.py::test_psi1d_pref_suf_route_matches_esfd_route
    "masked": (np.random.default_rng(5).uniform(-4, 2, 12), np.arange(12) < 9),
    # tests/test_cphd.py::test_log_esf_omit_wide_dynamic_range
    "wide_range": (np.array([10.0, -80.0, 5.0, -60.0]), np.ones(4, bool)),
    "none_valid": (np.zeros(4), np.zeros(4, bool)),
}


@pytest.mark.parametrize("case", sorted(ESF_CASES))
def test_log_esf_matches_jax(case):
    ll, zm = ESF_CASES[case]
    ll = np.where(zm, ll, jmath.LOG0).astype(np.float32)
    jl, jm = jnp.asarray(ll), jnp.asarray(zm)
    close_log(tcphd.log_esf(t(ll), t(zm)).numpy(), jcphd.log_esf(jl, jm))
    for g, w in zip(tcphd.log_esf_prefix_suffix(t(ll), t(zm)),
                    jcphd.log_esf_prefix_suffix(jl, jm)):
        close_log(g.numpy(), w)
    close_log(tcphd.log_esf_omit(t(ll), t(zm)).numpy(),
              jcphd.log_esf_omit(jl, jm))
    # batched over particles: each row as the single-particle scan
    lb = np.stack([ll, np.roll(ll, 1)])
    mb = np.stack([zm, np.roll(zm, 1)])
    got = tcphd.log_esf_prefix_suffix(t(lb), t(mb))
    for p in range(2):
        for g, w in zip(got, jcphd.log_esf_prefix_suffix(
                jnp.asarray(lb[p]), jnp.asarray(mb[p]))):
            close_log(g[p].numpy(), w)


@pytest.mark.parametrize("case", ["masked", "wide_range"])
@pytest.mark.parametrize("branch", ["pref_suf", "esfd"])
def test_psi_terms_match_jax(case, branch):
    """Both branches of psi_terms, single-particle and batched; the fused
    branch's one max per row before exp is pinned by the wide-range case."""
    ll, zm = ESF_CASES[case]
    ll = np.where(zm, ll, jmath.LOG0).astype(np.float32)
    M, n_meas = len(ll), int(zm.sum())
    cfg = dict(CARD_CFG, max_cardinality=12 if case == "wide_range" else 32)
    C1 = cfg["max_cardinality"] + 1
    rng = np.random.default_rng(M)
    cn = np.log(rng.dirichlet(np.ones(C1))).astype(np.float32)
    lq, lw = np.float32(np.log(0.8)), np.float32(np.log(2.0))
    jl, jm = jnp.asarray(ll), jnp.asarray(zm)
    tl, tm = t(ll), t(zm)
    j_kw, t_kw = {}, {}
    j_esfd = t_esfd = None
    if branch == "pref_suf":
        j_kw["pref_suf"] = jcphd.log_esf_prefix_suffix(jl, jm)
        t_kw["pref_suf"] = tcphd.log_esf_prefix_suffix(tl, tm)
    else:
        j_esfd, t_esfd = jcphd.log_esf_omit(jl, jm), tcphd.log_esf_omit(tl, tm)
    want = jcphd.psi_terms(
        jcphd.cphd_constants(JaxSlamConfig(**cfg)), jcphd.log_esf(jl, jm),
        j_esfd, jnp.asarray(cn), jnp.float32(lq), jnp.float32(lw), n_meas,
        jm, **j_kw)
    consts = tcphd.cphd_constants(SlamConfig(**cfg))
    got = tcphd.psi_terms(consts, tcphd.log_esf(tl, tm), t_esfd, t(cn),
                          t(lq), t(lw), n_meas, tm, **t_kw)
    for name, g, w in zip(("psi0", "ip0", "ip1", "ip1d"), got, want):
        close_log(g.numpy(), w, msg=name)
    # a batch of two particles, the second with another cardinality
    t_kw2 = {k: tuple(torch.stack([x, x]) for x in v)
             for k, v in t_kw.items()}
    got2 = tcphd.psi_terms(
        consts, torch.stack([tcphd.log_esf(tl, tm)] * 2),
        None if t_esfd is None else torch.stack([t_esfd] * 2),
        torch.stack([t(cn), t(np.roll(cn, 3))]), t([lq, lq]), t([lw, lw]),
        n_meas, tm, **t_kw2)
    for g1, g2 in zip(got, got2):
        close_log(g2[0].numpy(), g1.numpy(), rtol=1e-6)


# ----------------------------------------------------------------------------
# the merge2d twin's argmax mode and Hellinger metric
# ----------------------------------------------------------------------------

def random_case(P, N, seed, cluster=True):
    """tests/test_pallas_merge.py::random_case, as numpy."""
    rng = np.random.default_rng(seed)
    if cluster:
        centers = rng.normal(0, 20, (P, 8, 2))
        idx = rng.integers(0, 8, (P, N))
        mean = centers[np.arange(P)[:, None], idx] \
            + rng.normal(0, 0.3, (P, N, 2))
    else:
        mean = rng.normal(0, 20, (P, N, 2))
    A = rng.normal(0, 0.5, (P, N, 2, 2))
    cov = np.einsum("pnij,pnkj->pnik", A, A) + np.eye(2) * 0.3
    w = rng.uniform(0, 1, (P, N)).astype(np.float32)
    act = rng.random((P, N)) < 0.7
    return (mean.astype(np.float32), cov.astype(np.float32), w, act)


def pallas_merge(case, min_sep, K, metric=0, sorted_w=False):
    return [np.asarray(x) for x in gm_merge_pallas_batch(
        *(jnp.asarray(x) for x in case), min_sep, K, interpret=True,
        metric=metric, sorted_w=sorted_w)]


def twin_merge(case, min_sep, K, metric=0, sorted_w=False):
    mean, cov, w, act = case
    packed = torch.stack([t(w), t(act).float(), t(mean[..., 0]),
                          t(mean[..., 1]), t(cov[..., 0, 0]),
                          t(cov[..., 0, 1]), t(cov[..., 1, 1])], dim=1)
    out = merge2d(packed, min_sep, K, sorted_w=sorted_w, metric=metric)
    return [x.numpy() for x in merge_out(out, 2)]


def assert_same_merge(got, want):
    """Equal cluster and leftover counts; weights and means to rtol 1e-4,
    covariances to rtol 1e-3 (reassociated f32 moment sums)."""
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("metric", [0, 1])
@pytest.mark.parametrize("cluster", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("N", [64, 118])
def test_merge2d_argmax_twin_matches_pallas(N, seed, cluster, metric):
    """The argmax-mode twin (unsorted lanes) against the interpret-mode
    Pallas kernel with sorted_w=False, tests/test_pallas_merge.py's cases
    (min_separation 4 for Mahalanobis, 0.6 for Hellinger)."""
    case = random_case(4, N, seed, cluster)
    min_sep = 0.6 if metric else 4.0
    got = twin_merge(case, min_sep, 16, metric)
    assert_same_merge(got, pallas_merge(case, min_sep, 16, metric))
    assert (got[3] > 0).all()


def test_merge2d_hellinger_sorted_twin_matches_pallas():
    """The Hellinger metric in sorted mode, on a weight-descending active
    prefix."""
    mean, cov, w, act = random_case(4, 64, 2)
    order = np.argsort(np.where(act, -w, 1.0), axis=1, kind="stable")

    def take(x):
        return np.take_along_axis(
            x, order.reshape(order.shape + (1,) * (x.ndim - 2)), axis=1)
    act_s = take(act)
    case = (take(mean), take(cov), np.where(act_s, take(w), 0.0), act_s)
    got = twin_merge(case, 0.6, 16, 1, sorted_w=True)
    assert_same_merge(got, pallas_merge(case, 0.6, 16, 1, sorted_w=True))


def test_merge2d_argmax_overflow_counts_zero_weight_lanes():
    """More clusters than capacity, with active zero-weight lanes: argmax
    mode counts them as left (sorted mode never takes them in)."""
    rng = np.random.default_rng(3)
    P, N, K = 2, 64, 4
    mean = rng.normal(0, 100, (P, N, 2)).astype(np.float32)
    cov = np.broadcast_to(np.eye(2) * 0.1, (P, N, 2, 2)).astype(np.float32)
    w = rng.uniform(0.1, 1, (P, N)).astype(np.float32)
    w[:, ::5] = 0.0
    case = (mean, cov, w, np.ones((P, N), bool))
    got = twin_merge(case, 4.0, K)
    assert_same_merge(got, pallas_merge(case, 4.0, K))
    assert (got[4] == N - K).all()
    sorted_left = twin_merge(case, 4.0, K, sorted_w=True)[4]
    assert (sorted_left < got[4]).all()


def test_merge2d_argmax_terminates_on_nan_weights():
    """A whole particle of NaN weights stalls and drops its lanes; zero
    weights never lead."""
    mean, cov, w, act = random_case(2, 64, 0)
    w = w.copy()
    w[0, :] = np.nan
    w[1, :8] = 0.0
    case = (mean, cov, w, act)
    got = twin_merge(case, 4.0, 16)
    assert_same_merge(got, pallas_merge(case, 4.0, 16))
    assert got[3][0] == 0 and got[4][0] == 0 and got[3][1] > 0


def test_hellinger2_matches_jax():
    mean, cov, _, _ = random_case(2, 32, 4, cluster=False)
    cov[0, :4] = 0.0                         # tiny determinant: identity
    a, b = mean[:, :16], mean[:, 16:]
    ca, cb = cov[:, :16], cov[:, 16:]
    want = jmath.hellinger2(*(jnp.asarray(x) for x in (a, ca, b, cb)))
    got = tmath.hellinger2(t(a), t(ca), t(b), t(cb))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_masked_logsumexp_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(-50, 5, (4, 9)).astype(np.float32)
    mask = rng.random((4, 9)) < 0.5
    mask[2] = False
    for axis in (0, 1):
        want = jmath.masked_logsumexp(jnp.asarray(x), jnp.asarray(mask),
                                      axis=axis)
        got = tmath.masked_logsumexp(t(x), t(mask), dim=axis)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_merge2d_wrapper_counts_no_cpu_launch():
    case = random_case(2, 64, 0)
    packed = torch.stack([t(case[2]), t(case[3]).float()]
                         + [t(case[0][..., i]) for i in range(2)]
                         + [t(case[1][..., a, b])
                            for a, b in ((0, 0), (0, 1), (1, 1))], dim=1)
    build.reset_launch_counts()
    for sorted_w in (True, False):
        for metric in (0, 1):
            assert torch.equal(
                merge2d(packed, 2.0, 16, sorted_w, metric),
                merge2d_reference(packed, 2.0, 16, sorted_w, metric))
    assert not build.launch_counts
    assert {merge2d_variant(s, m) for s in (True, False) for m in (0, 1)} \
        == {"merge2d", "merge2d_argmax", "merge2d_hellinger",
            "merge2d_argmax_hellinger"}


# ----------------------------------------------------------------------------
# the updates
# ----------------------------------------------------------------------------

# tests/test_cphd.py::test_cphd_det_kernel_route_matches_grid_route's
# setup; merge_r_par=1: the Pallas merge emits the same clusters for any R
# (R principals per trip only amortise TPU trips) and compiles twice as
# fast in interpret mode
CPHD = dict(merge_r_par=1, n_particles=6, max_features=16, max_measurements=6,
            motion_type=0, feature_model=0, filter_type=1, max_cardinality=24,
            max_range=20.0, std_range=0.25, std_bearing=0.02,
            clutter_rate=2.0, pd=0.95, birth_weight=0.05, min_separation=2.0,
            merge_candidate_cap=48, detection_topk=8, resample_threshold=0.3,
            seed=1, pallas_detect=2, pallas_merge=2)


def scene(cfg):
    """Four features per particle near the measurements, jittered poses
    and log weights, five of six measurement slots valid."""
    rng = np.random.default_rng(3)
    js = jax_init_state(cfg)
    arrays = jax_state_arrays(js)
    P, K = cfg.n_particles, cfg.max_features
    mean = np.zeros((P, K, 2), np.float32)
    w = np.zeros((P, K), np.float32)
    mean[:, :4] = np.array([[5, 1], [8, -2], [3, 4], [6, 6]], np.float32) \
        + rng.normal(0, 0.05, (P, 4, 2))
    w[:, :4] = rng.uniform(0.4, 1.0, (P, 4))
    arrays.update(pose=rng.normal(0, 0.2, (P, 6)).astype(np.float32),
                  map_mean=mean, map_weight=w,
                  log_weight=rng.normal(0, 0.2, (P,)).astype(np.float32))
    z = np.zeros((6, 2), np.float32)
    z[:5] = [[5.1, 0.19], [8.2, -0.24], [5.0, 0.92], [8.5, 0.78],
             [4.0, -1.0]]
    zm = np.arange(6) < 5
    return arrays, z, zm


def jax_state(cfg, arrays):
    js = jax_init_state(cfg)
    gm = js.map_static.replace(mean=jnp.asarray(arrays["map_mean"]),
                               cov=jnp.asarray(arrays["map_cov"]),
                               weight=jnp.asarray(arrays["map_weight"]))
    js = js.replace(pose=jnp.asarray(arrays["pose"]), map_static=gm,
                    log_weight=jnp.asarray(arrays["log_weight"]))
    if "cardinality" in arrays:
        js = js.replace(cardinality=jnp.asarray(arrays["cardinality"]))
    return js


def assert_updates_close(got, want, t_ovf, j_ovf):
    for name in ("log_weight", "map_weight"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    live = want["map_weight"] > 1e-6
    np.testing.assert_allclose(got["map_mean"][live], want["map_mean"][live],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["map_cov"][live], want["map_cov"][live],
                               rtol=1e-3, atol=1e-5)
    if "cardinality" in want:
        assert_log_card_close(got["cardinality"], want["cardinality"])
    assert int(t_ovf) == int(j_ovf)


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("route", ["det", "full_grid"])
def test_cphd_update_matches_jax(route, gate):
    """cphd_update from the same state: the det route (cap 48, T=8) and the
    full-grid route (cap 0: every [K | M K] lane to the argmax merge), with
    gated births off and on."""
    cfg = SlamConfig(**dict(CPHD, gate_births=gate,
                            merge_candidate_cap=48 if route == "det" else 0))
    arrays, z, zm = scene(cfg)
    # jitted: one XLA program compiles ~6x faster than the eager op stream
    js, j_ovf = jax.jit(lambda *a: jcphd.cphd_update(*a, cfg))(
        jax_state(cfg, arrays), jnp.asarray(z), jnp.asarray(zm),
        jcphd.cphd_constants(cfg))
    ts, t_ovf = tcphd.cphd_update(state_from_jax(arrays), t(z), t(zm),
                                  tcphd.cphd_constants(cfg), cfg)
    got, want = state_to_numpy(ts), jax_state_arrays(js)
    want["cardinality"] = np.asarray(js.cardinality)
    assert_updates_close(got, want, t_ovf, j_ovf)
    # births from the scan joined, and the cardinality is a distribution
    assert (got["map_weight"] > 0).sum() > (arrays["map_weight"] > 0).sum()
    np.testing.assert_allclose(np.exp(got["cardinality"]).sum(axis=1), 1.0,
                               rtol=1e-4)


def test_phd_full_grid_update_matches_jax():
    """The PHD update with merge_candidate_cap 0: every [K | M K | M] lane
    to the argmax merge, against the JAX version's slow route."""
    cfg = SlamConfig(**dict(CPHD, filter_type=0, particle_weighting=0,
                            merge_candidate_cap=0))
    arrays, z, zm = scene(cfg)
    js, j_ovf = jax.jit(lambda *a: jax_update(*a, cfg))(
        jax_state(cfg, arrays), jnp.asarray(z), jnp.asarray(zm))
    ts, t_ovf = update(state_from_jax(arrays), t(z), t(zm), cfg)
    assert_updates_close(state_to_numpy(ts), jax_state_arrays(js), t_ovf,
                         j_ovf)


def test_check_supported_routes():
    K, M = 16, 6
    base = SlamConfig(**CPHD)
    for kw in (dict(), dict(merge_candidate_cap=0),
               dict(merge_candidate_cap=K + M * K),
               dict(filter_type=0, particle_weighting=0,
                    merge_candidate_cap=0),
               dict(filter_type=0, particle_weighting=0, distance_metric=1),
               # a binding cap without stage 1: the top-cap lane route
               dict(detection_topk=K),
               # the JAX CPHD update estimates no map variance: accepted,
               # the variance stays zero
               dict(compute_variance=True),
               # the mixed model's CPHD update runs on its static map, as
               # the JAX version's does
               dict(feature_model=2, filter_type=1)):
        check_supported(dataclasses.replace(base, **kw), K, M)
    # the full grid at M=64 but not at max_measurements=80: JAX's det
    # route, which the port then takes too
    kw = dict(merge_candidate_cap=K + 64 * K, max_measurements=80)
    check_supported(dataclasses.replace(base, **kw), K, 64)
    assert update_route(dataclasses.replace(base, **kw), K, 64) == "det"
    # the CPHD full grid above merge2d's narrow 8192 lanes (128 + 64 * 128
    # = 8320): accepted, on the staged wide-lane variant
    kw = dict(merge_candidate_cap=0, max_features=128)
    check_supported(dataclasses.replace(base, **kw), 128, 64)
    assert update_route(dataclasses.replace(base, **kw), 128, 64) == "full"
    with pytest.raises(NotImplementedError, match="distance_metric"):
        check_supported(dataclasses.replace(base, distance_metric=2), K, 64)


# ----------------------------------------------------------------------------
# replayed steps
# ----------------------------------------------------------------------------

STEP = dict(merge_r_par=1, n_particles=8, max_features=32, max_measurements=8,
            detection_topk=8, merge_candidate_cap=64, pallas_detect=2,
            pallas_merge=2, max_cardinality=24)


@pytest.fixture
def flush_subnormals():
    """XLA's CPU flushes f32 subnormal results to zero and PyTorch keeps
    them. The CPHD det route runs the detect kernel at min_fw = 0 and
    counts its pdw > 0 lanes in the overflow diagnostic, so on real data a
    pdw in the subnormal band is live on one side only; flush subnormals
    here too while the test runs."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.mark.parametrize("cap", [64, 0])
def test_cphd_step_matches_jax(cap, flush_subnormals):
    """cfg/ackerman_cphd.cfg on data/ackerman, four steps from the same
    state with JAX's replayed draws: poses, weights, maps, cardinalities
    and the MAP particle's cardinality output, on the det route (cap 64)
    and the full-grid route (cap 0)."""
    ts, _ = replay_dataset("cfg/ackerman_cphd.cfg", "data/ackerman",
                           dict(STEP, merge_candidate_cap=cap), 4)
    card = state_to_numpy(ts)["cardinality"]
    np.testing.assert_allclose(np.exp(card).sum(axis=1), 1.0, rtol=1e-4)


def test_hellinger_step_matches_jax():
    """cfg/ackerman.cfg with distance_metric 1 (min_separation 0.6, the
    JAX Hellinger test's value) on the det route, four replayed steps."""
    ts, _ = replay_dataset("cfg/ackerman.cfg", "data/ackerman",
                           dict(STEP, distance_metric=1, min_separation=0.6),
                           4)
    assert (state_to_numpy(ts)["map_weight"] > 0).sum(axis=1).min() > 0
