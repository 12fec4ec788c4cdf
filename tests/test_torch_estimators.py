"""The port's remaining PHD estimators and routes, step by step against the
JAX package: scheme-2 (single-feature) weighting, the MC map variance, EAP
extraction and the top-cap lane route (detection_topk >= K with a binding
cap).

Each case replays the first steps of ``data/ackerman`` (or the CPHD
configuration on it) through ``phdslam_tpu``'s ``phd_step`` (its Pallas
kernels in interpret mode) and the port's ``phd_step`` (its kernels'
plain twins on the CPU) from the same state with JAX's draws
(``test_torch_step.replay_dataset``: poses, weights and the map within
rtol 1e-4 / atol 1e-5, resampling and overflow equal). The variance and
the EAP map are held call by call on the port's own inputs (see their
tests).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phdslam_tpu.config import load_config as jax_load_config
from phdslam_tpu.filters import extras as jextras
from phdslam_tpu.types import GMState as jGMState
from phdslam_tpu_torch.filters import phd as tphd
from phdslam_tpu_torch.types import state_to_numpy
from test_torch_step import CFG, DATA, SMALL, replay_dataset

CPHD_CFG = "cfg/ackerman_cphd.cfg"
K = SMALL["max_features"]
FULL = dict(merge_candidate_cap=0)
VAR = dict(compute_variance=True, n_samples=6)
STEPS = 5


@pytest.mark.parametrize("over", [
    dict(particle_weighting=2),
    dict(particle_weighting=2, detection_topk=K),
    dict(particle_weighting=2, **FULL),
], ids=["det", "topk", "full_grid"])
def test_scheme2_step_matches_jax(over):
    """Scheme 2: the argmax lane located on the route's detection lanes
    (the selected top-T, the [M, K] grid of the top-cap route, or the
    full grid's log likelihoods), the increment from the map as predicted
    and the compacted updated map. Its weights are peaked (nEff 0.016
    after step 0 at P=8), so a step magnifies the f32 rounding that
    earlier steps left in the maps: every step starts from JAX's state."""
    ts, _ = replay_dataset(CFG, DATA, dict(SMALL, **over), STEPS,
                           resync=True)
    assert np.isfinite(state_to_numpy(ts)["log_weight"]).all()


def variance_oracle(mean, cov, w, n_nd, n_samples, keys):
    """float64 value of the full-grid estimator's definition
    (``mc_variance_candidates``: each live lane's w N(x; m, P) at its own
    sample x = m + L eps, ``val`` on the first n_nd lanes, ``val (1 -
    val)`` elsewhere, averaged over samples) on the given f32 inputs and
    JAX's f32 draws normal(fold_in(keys[p], s), (N, D))."""
    m, c, w = (np.asarray(x, np.float64) for x in (mean, cov, w))
    P, N, D = m.shape
    L = np.linalg.cholesky(c + 1e-9 * np.eye(D))
    c_inv, det = np.linalg.inv(c), np.linalg.det(c)
    is_nd = np.arange(N) < n_nd
    out = np.zeros(P)
    for p in range(P):
        for s in range(n_samples):
            eps = np.asarray(jax.random.normal(jax.random.fold_in(keys[p], s),
                                               (N, D), jnp.float32),
                             np.float64)
            off = np.einsum("nij,nj->ni", L[p], eps)
            maha = np.einsum("ni,nij,nj->n", off, c_inv[p], off)
            val = w[p] * np.exp(-0.5 * maha) / (2 * np.pi
                                                * np.sqrt(det[p]))
            contrib = np.where(is_nd, val, val * (1.0 - val))
            out[p] += np.where(w[p] > 0, contrib, 0.0).sum()
    return out / n_samples


def packed_oracle(planes, is_nd, n_samples, key):
    """float64 value of the selected-lane estimator's definition
    (``mc_variance_packed``) on the given f32 planes [P, 7, N] and JAX's
    draws normal(fold_in(key, s), (2, P, N))."""
    planes = np.asarray(planes, np.float64)
    w = planes[:, 0]
    live = (planes[:, 1] > 0.5) & (w > 0)
    det = np.maximum(planes[:, 4] * planes[:, 6] - planes[:, 5] ** 2, 1e-30)
    pref = w / (2 * np.pi * np.sqrt(det))
    out = np.zeros(w.shape[0])
    for s in range(n_samples):
        eps = np.asarray(jax.random.normal(jax.random.fold_in(key, s),
                                           (2,) + w.shape, jnp.float32),
                         np.float64)
        val = pref * np.exp(-0.5 * (eps[0] ** 2 + eps[1] ** 2))
        contrib = np.where(is_nd, val, val * (1.0 - val))
        out += np.where(live, contrib, 0.0).sum(axis=-1)
    return out / n_samples


@pytest.mark.parametrize("over", [VAR, dict(VAR, **FULL)],
                         ids=["det", "full_grid"])
def test_variance_step_matches_jax(over, monkeypatch):
    """The MC map variance in the replayed steps: every call of the port's
    estimator is held against the float64 value of the JAX estimator's
    definition on the same inputs and JAX's keys (rtol 1e-4 / atol 1e-5;
    over the selected packed lanes on the det route,
    :func:`packed_oracle`, over every candidate lane on the full grid,
    :func:`variance_oracle`), and the rest of the step against the JAX
    step as usual. The JAX estimate itself is no reference here: these
    steps hold thin covariances (c00 c11 / det up to ~3e4), whose f32
    determinant is off by up to ~2e-3, and the JAX step's jitted and eager
    evaluations of the estimate differ by up to 10%."""
    calls = []
    packed_fn, cands_fn = tphd.mc_variance_packed, tphd.mc_variance_candidates

    def packed(planes, is_nd, n_samples, draw):
        got = packed_fn(planes, is_nd, n_samples, draw)
        calls.append((got.numpy(), packed_oracle(
            planes.numpy(), is_nd.numpy(), n_samples, draw.keys[0])))
        return got

    def cands(mean, cov, w, n_nd, n_samples, draw):
        got = cands_fn(mean, cov, w, n_nd, n_samples, draw)
        calls.append((got.numpy(), variance_oracle(
            mean.numpy(), cov.numpy(), w.numpy(), n_nd, n_samples,
            draw.keys)))
        return got

    monkeypatch.setattr(tphd, "mc_variance_packed", packed)
    monkeypatch.setattr(tphd, "mc_variance_candidates", cands)
    ts, _ = replay_dataset(CFG, DATA, dict(SMALL, **over), STEPS)
    assert len(calls) == STEPS
    for n, (got, want) in enumerate(calls):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=f"variance step {n}")
    assert np.isfinite(state_to_numpy(ts)["variance"]).all()


@functools.lru_cache(maxsize=None)
def plain_state():
    """The plain configuration's state after the replayed steps (run once
    per test process)."""
    return state_to_numpy(replay_dataset(CFG, DATA, SMALL, STEPS)[0])


@pytest.mark.parametrize("every", [1, 3])
def test_eap_step_matches_jax(every, monkeypatch):
    """EAP extraction in the replayed steps: the tree runs on the steps
    where step % eap_every == 0 (the MAP map between) over the step's
    updated maps and weights, and each of its maps is held against the
    JAX tree (``phdslam_tpu.filters.extras.eap_expected_map``, its
    merges in interpret mode) on the same maps: same cluster count,
    weights, means and covariances within rtol 1e-4 / atol 1e-5. The
    state is the plain run's, bit for bit. The maps are not compared with
    the JAX step's: the tree merges every particle's map, and the f32
    rounding the update leaves in any of them can move a cluster across
    the merge threshold (the JAX step's own maps at P=8 hold clusters of
    weight ~1e-7)."""
    small = dict(SMALL, map_estimate=2, eap_every=every)
    jcfg = jax_load_config(CFG, small)
    calls = []
    eap = tphd.eap_expected_map

    def tree(gm, log_weight, cfg, mesh=None):
        assert mesh is None             # one process
        got = eap(gm, log_weight, cfg)
        want = jextras.eap_expected_map(
            jGMState(*(jnp.asarray(x.numpy())
                       for x in (gm.mean, gm.cov, gm.weight))),
            jnp.asarray(log_weight.numpy()), jcfg)
        calls.append((got, want))
        return got

    monkeypatch.setattr(tphd, "eap_expected_map", tree)
    ts, _ = replay_dataset(CFG, DATA, small, STEPS)
    assert len(calls) == len(range(0, STEPS, every))
    for got, want in calls:
        w = np.asarray(want[2])
        assert (got[2].numpy() > 0).sum() == (w > 0).sum()
        for g, j in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-4,
                                       atol=1e-5)
    got, want = state_to_numpy(ts), plain_state()
    for name in ("pose", "log_weight", "map_weight"):
        np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("cfg_path", [CFG, CPHD_CFG], ids=["phd", "cphd"])
def test_topk_route_step_matches_jax(cfg_path):
    """detection_topk = K with the binding cap: no stage 1, every lane
    ranked by weight (topk_compact_indices), then the deferred gather and
    the sorted merge."""
    ts, _ = replay_dataset(cfg_path, DATA, dict(SMALL, detection_topk=K),
                           STEPS)
    assert (state_to_numpy(ts)["map_weight"] > 0).sum(axis=1).min() > 0
