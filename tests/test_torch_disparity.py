"""The monocular SC-PHD (disparity) path of the port against the JAX package.

The same numpy inputs go through the JAX functions of
``phdslam_tpu/filters/disparity.py`` and their counterparts in
``phdslam_tpu_torch``: the camera transforms, the Gaussian fit, ``chol3``
and the sampling, the 3D distance, the 3D merge twin (against the Pallas
3D kernel in interpret mode in both of its modes, and the XLA merge), the
candidate compaction, the pre- and post-merge halves, replayed
``disparity_step`` runs in three configurations, the state conversions,
the loaders and ``simdata`` copies, and ``evaluate_disparity``. On the CPU
the port's merge3d wrapper runs its plain twin; the JAX 3D kernel runs in
interpret mode (pallas_merge=2).

The torch step takes its noise as an input; the tests replay JAX's key
schedule: fold_in(rng, step) -> split(3) -> (k_pred, k_upd, k_res), the
prediction draw normal(k_pred, (P, 6)), the cloud draws
normal(split(k_upd, P)[p], (K, N, 3)) and the resampling uniforms
uniform(k_res, (P,)).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.config import SlamConfig as JaxSlamConfig
from phdslam_tpu.eval import simdata as jsim
from phdslam_tpu.filters import disparity as jd
from phdslam_tpu.ops import gm_merge as jgm
from phdslam_tpu.ops import math as jmath
from phdslam_tpu.ops.pallas_merge import gm_merge_pallas_batch_3d
from phdslam_tpu.slam_disparity import \
    load_image_measurements as jax_load_image_measurements
from phdslam_tpu_torch.config import SlamConfig
from phdslam_tpu_torch.eval import simdata as tsim
from phdslam_tpu_torch.eval.parity import evaluate_disparity
from phdslam_tpu_torch.filters import disparity as td
from phdslam_tpu_torch.kernels import build
from phdslam_tpu_torch.kernels.merge import merge3d, merge3d_reference
from phdslam_tpu_torch.ops import gm_merge as tgm
from phdslam_tpu_torch.ops import math as tmath
from phdslam_tpu_torch.slam_disparity import (load_image_measurements,
                                              run_disparity)
from phdslam_tpu_torch.types import (disparity_state_from_jax,
                                     disparity_state_to_numpy)
from merge_bench import MIN_SEP, merge_edge_case
from test_torch_kernels import MERGE_EDGES_3D4D, active_first

# tests/test_disparity.py::cam_cfg's camera and noise at a small size:
# P=6, K=12 slots of N=8 points, M=8, so K + M K + M = 116 candidate lanes.
# merge_r_par=1: the Pallas merge emits the same clusters for any R and
# compiles faster in interpret mode.
DISP = dict(n_particles=6, max_features=12, max_measurements=8,
            particles_per_feature=8, fx=500.0, fy=500.0, u0=320.0, v0=240.0,
            image_width=640, image_height=480, std_u=1.0, std_v=1.0,
            disparity_birth=150.0, std_d_birth=100.0, clutter_rate=2.0,
            pd=0.95, birth_weight=0.05, min_separation=20.0,
            min_feature_weight=1e-5, particle_weighting=0,
            resample_threshold=0.5, ax=0.01, ay=0.01, az=0.01, aroll=0.001,
            apitch=0.001, ayaw=0.001, dt=0.5, vx0=0.08,
            merge_candidate_cap=48, pallas_merge=2, merge_r_par=1, seed=3)
# the replayed step configurations: the cap binds (48 < 116 lanes, top-cap
# compaction + sorted merge), does not bind (cap 0: JAX's argmax merge over
# all 116 lanes, the port's sort + merge), and Vo weighting
STEP_CFGS = {"cap_binds": {}, "no_cap": dict(merge_candidate_cap=0),
             "weighting1": dict(particle_weighting=1)}
N_STEPS = 8
M = 8


def close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def t(x):
    return torch.from_numpy(np.array(x))


def jax_arrays(s):
    return {"cam_pose": np.asarray(s.cam_pose),
            "log_weight": np.asarray(s.log_weight),
            "cloud": np.asarray(s.cloud),
            "feat_weight": np.asarray(s.feat_weight),
            "resample_idx": np.asarray(s.resample_idx),
            "step": np.asarray(s.step)}


def replay_noise(state, K, N):
    """The draws JAX's disparity_step makes from this state's key."""
    P = state.cam_pose.shape[0]
    key = jax.random.fold_in(state.rng, state.step)
    k_pred, k_upd, k_res = jax.random.split(key, 3)
    eps_pred = np.array(jax.random.normal(k_pred, (P, 6), jnp.float32))
    eps_sample = np.stack([np.array(jax.random.normal(k, (K, N, 3),
                                                      jnp.float32))
                           for k in jax.random.split(k_upd, P)])
    u = np.array(jax.random.uniform(k_res, (P,), jnp.float32))
    return td.DisparityNoise(t(eps_pred), t(eps_sample), t(u))


def scans(T=N_STEPS, seed=1):
    """A small camera world's scans padded to M (numpy)."""
    _, traj, ms = jsim.generate_disparity_world(
        n_landmarks=10, n_steps=T, dt=0.5, seed=seed, vx=0.08)
    z = np.zeros((T, M, 2), np.float32)
    mask = np.zeros((T, M), bool)
    for n, zz in enumerate(ms):
        k = min(len(zz), M)
        z[n, :k] = zz[:k]
        mask[n, :k] = True
    return z, mask, traj


def uvd64(cloud, cam_pose, cfg):
    """Cloud points [P, K, N, 3] in each particle's disparity space, in
    float64 (the space the filter fits and merges in; far points, whose
    disparity sits near min_disparity, carry the f32 error of d amplified
    by 1/d in world coordinates but not here)."""
    out = np.empty(cloud.shape, np.float64)
    for p in range(cloud.shape[0]):
        R = tsim.camera_rotation_np(*cam_pose[p, 3:6].astype(np.float64))
        pc = (cloud[p].astype(np.float64) - cam_pose[p, :3]) @ R
        zc = pc[..., 2]
        # empty slots (cloud 0) may sit on the camera plane
        with np.errstate(divide="ignore", invalid="ignore"):
            out[p, ..., 0] = cfg.u0 - cfg.fx * pc[..., 0] / zc
            out[p, ..., 1] = cfg.v0 - cfg.fy * pc[..., 1] / zc
            out[p, ..., 2] = -cfg.fx / zc
    return out


def match_clouds(got, want, cfg, rtol=1e-4, atol=2e-3, spread_rtol=7e-4):
    """Clouds slot by slot in disparity space (under the JAX camera), except
    that a slot may hold another feature of the same particle where the two
    weights tie within rtol 1e-5 / atol 1e-6 (the recombine sorts by
    weight, and f32 rounding can order two tied weights either way).
    Returns the number of such swapped slots.

    Each coordinate is held to atol + rtol |want| + spread_rtol times the
    standard deviation of the JAX slot's points in that coordinate. The
    points are drawn through the Gaussian fit's covariance, which differs
    by up to ~7e-4 relative between the frameworks (see
    test_update_halves_match_jax), so a drawn point moves by that share of
    its cloud's spread, and that spread (tens of pixels in d) is not
    bounded by the absolute atol. Against a float64 evaluation of the same
    step (the port's code in f64 from the same state and draws), JAX's own
    f32 points lie up to 4.6e-4 of the spread away and the port's up to
    4.1e-4, several times atol at d's spread."""
    cam = want["cam_pose"]
    live = want["feat_weight"] > 0
    g = uvd64(got["cloud"], cam, cfg)
    w = uvd64(want["cloud"], cam, cfg)
    with np.errstate(invalid="ignore"):     # empty slots: inf - inf
        tol = atol + rtol * np.abs(w) + spread_rtol * w.std(axis=2,
                                                             keepdims=True)
        err = np.abs(g - w)
    ok = (err <= tol).all(axis=(-1, -2)) | ~live
    for p, k in zip(*np.nonzero(~ok)):
        tied = np.isclose(want["feat_weight"][p], got["feat_weight"][p, k],
                          rtol=1e-5, atol=1e-6)
        same = (np.abs(w[p] - g[p, k][None]) <= tol[p]).all(axis=(-1, -2))
        assert (tied & same).any(), f"cloud of particle {p} slot {k}"
    return int((~ok).sum())


def assert_states_close(got, want, cfg, msg=""):
    """Poses within 1e-5, log weights and feature weights within rtol 1e-4
    / atol 1e-5, the same ancestors, clouds per :func:`match_clouds`."""
    close(got["cam_pose"], want["cam_pose"], rtol=0, atol=1e-5,
          msg=f"cam_pose {msg}")
    for name in ("log_weight", "feat_weight"):
        close(got[name], want[name], rtol=1e-4, atol=1e-5,
              msg=f"{name} {msg}")
    np.testing.assert_array_equal(got["resample_idx"], want["resample_idx"])
    return match_clouds(got, want, cfg)


def run_jax_steps(name):
    """JAX disparity_step over the small world in one configuration: per
    step the noise it drew, its outputs and its state after the step."""
    jcfg = JaxSlamConfig(**dict(DISP, **STEP_CFGS[name]))
    step = jd.make_disparity_step_fn(jcfg, donate=False)
    z, mask, _ = scans()
    js = jd.init_disparity_state(jcfg)
    rows = [dict(state=jax_arrays(js))]
    for n in range(N_STEPS):
        noise = replay_noise(js, jcfg.max_features,
                             jcfg.particles_per_feature)
        js, out = step(js, jnp.asarray(z[n]), jnp.asarray(mask[n]),
                       jnp.float32(jcfg.dt), jnp.asarray(n > 0))
        rows.append(dict(noise=noise, state=jax_arrays(js),
                         out=jax.tree.map(np.asarray, out)))
    return rows


@pytest.fixture(scope="module")
def jax_runs():
    """:func:`run_jax_steps` once per configuration (one JAX compile
    each), shared by the tests of this module."""
    cache = {}

    def run(name):
        if name not in cache:
            cache[name] = run_jax_steps(name)
        return cache[name]
    return run


# ----------------------------------------------------------------------------
# camera geometry, fit, sample, math
# ----------------------------------------------------------------------------

def cams_and_points(seed=0, P=4, K=5, N=6):
    rng = np.random.default_rng(seed)
    cam = np.zeros((P, 12), np.float32)
    cam[:, :3] = rng.normal(0, 2, (P, 3))
    cam[:, 3:6] = rng.normal(0, 0.3, (P, 3))
    R = np.stack([tsim.camera_rotation_np(*c[3:6]) for c in cam])
    pc = np.stack([rng.normal(0, 1, (P, K, N)), rng.normal(0, 1, (P, K, N)),
                   -rng.uniform(2, 10, (P, K, N))], axis=-1)
    pts = np.einsum("pij,pknj->pkni", R, pc) + cam[:, None, None, :3]
    return cam, pts.astype(np.float32)


def test_camera_transforms_match_jax():
    cfg = SlamConfig(**DISP)
    cam, pts = cams_and_points()
    cb = cam[:, None, None, :]
    close(td.camera_rotation(t(cam[:, 3]), t(cam[:, 4]), t(cam[:, 5])),
          jd.camera_rotation(cam[:, 3], cam[:, 4], cam[:, 5]), atol=1e-6)
    uvd = td.world_to_disparity(t(pts), t(cb), cfg)
    want = jd.world_to_disparity(jnp.asarray(pts), jnp.asarray(cb), cfg)
    close(uvd, want, rtol=1e-5, atol=1e-3)
    assert (uvd[..., 2] > 0).all()
    back = td.disparity_to_world(uvd, t(cb), cfg)
    close(back, jd.disparity_to_world(want, jnp.asarray(cb), cfg),
          rtol=1e-5, atol=1e-4)
    close(back, pts, rtol=1e-3, atol=1e-3)
    # the safe-divide clamps: a point on the camera plane, a zero disparity
    edge = np.array([[0.5, 0.5, 0.0], [1.0, 2.0, 0.0]], np.float32)
    zero = np.zeros(12, np.float32)
    close(td.world_to_disparity(t(edge), t(zero), cfg),
          jd.world_to_disparity(jnp.asarray(edge), jnp.asarray(zero), cfg),
          rtol=1e-6)
    close(td.disparity_to_world(t(edge), t(zero), cfg),
          jd.disparity_to_world(jnp.asarray(edge), jnp.asarray(zero), cfg),
          rtol=1e-6)


def test_fit_chol_and_sample_match_jax():
    rng = np.random.default_rng(1)
    uvd = (rng.normal(0, 1, (3, 5, 16, 3)) * [8.0, 5.0, 40.0]
           + [300.0, 200.0, 150.0]).astype(np.float32)
    mean, cov = td.fit_gaussians(t(uvd))
    j_mean, j_cov = jd.fit_gaussians(jnp.asarray(uvd))
    close(mean, j_mean, rtol=1e-6, atol=1e-4)
    close(cov, j_cov, rtol=1e-4, atol=1e-3)
    close(cov[0, 0].double(), np.cov(uvd[0, 0].T, ddof=1), rtol=1e-4)
    L = tmath.chol3(cov)
    close(L, jd.chol3(j_cov), rtol=1e-5, atol=1e-5)
    close(L @ L.transpose(-1, -2), cov, rtol=1e-4, atol=1e-2)
    # the 1e-20 floors under non-positive pivots
    bad = np.zeros((2, 3, 3), np.float32)
    bad[1] = -np.eye(3)
    close(tmath.chol3(t(bad)), jd.chol3(jnp.asarray(bad)), rtol=0, atol=0)
    key = jax.random.PRNGKey(7)
    eps = np.array(jax.random.normal(key, (3, 5, 16, 3), jnp.float32))
    got = td.sample_gaussians(mean, cov, t(eps))
    want = jd.sample_gaussians(j_mean, j_cov, 16, key)
    close(got, want, rtol=1e-5, atol=1e-3)


def test_mahalanobis2_3d_matches_inverse():
    """The adjugate form against float64 ``np.linalg.inv``."""
    rng = np.random.default_rng(2)
    A = rng.normal(0, 1, (64, 3, 3))
    cov = (A @ A.transpose(0, 2, 1) + 0.2 * np.eye(3)).astype(np.float32)
    mean = rng.normal(0, 3, (64, 3)).astype(np.float32)
    got = tmath.mahalanobis2_3d(t(mean[:1]), t(cov[:1]), t(mean), t(cov))
    s = 0.5 * (cov[:1].astype(np.float64) + cov)
    d = mean[:1].astype(np.float64) - mean
    want = np.einsum("ni,nij,nj->n", d, np.linalg.inv(s), d)
    close(got, want, rtol=1e-4, atol=1e-5)
    # a singular average hits the |det| > 1e-30 clamp: finite, not NaN
    z = torch.zeros((1, 3, 3))
    assert torch.isfinite(tmath.mahalanobis2_3d(
        torch.ones(1, 3), z, torch.zeros(1, 3), z)).all()


# ----------------------------------------------------------------------------
# merge3d
# ----------------------------------------------------------------------------

def merge3d_case(seed, P=4, N=64, spread=3.0, sort=True):
    """Clustered (u, v, d) candidates at the spread of min_separation 20
    (covariances ~16 px^2 + A A', members ~``spread`` px apart, so a
    member's squared distance is a few units), as planes [P, 11, N]; with
    ``sort`` the active lanes form a weight-descending prefix (compacted
    input), else they stay in place."""
    rng = np.random.default_rng(seed)
    centers = np.stack([rng.uniform(0, 640, (P, 8)),
                        rng.uniform(0, 480, (P, 8)),
                        rng.uniform(20, 300, (P, 8))], axis=-1)
    mean = centers[np.arange(P)[:, None], rng.integers(0, 8, (P, N))] \
        + rng.normal(0, spread, (P, N, 3))
    A = rng.normal(0, 1.5, (P, N, 3, 3))
    cov = np.einsum("pnij,pnkj->pnik", A, A) + 16.0 * np.eye(3)
    w = rng.uniform(0, 1, (P, N))
    act = rng.random((P, N)) < 0.7
    order = (np.argsort(np.where(act, -w, 1.0), axis=1, kind="stable")
             if sort else np.broadcast_to(np.arange(N), (P, N)))

    def take(x):
        return np.take_along_axis(x, order, axis=1)
    act_s = take(act)
    planes = [np.where(act_s, take(w), 0.0), act_s]
    planes += [take(mean[..., i]) for i in range(3)]
    planes += [take(cov[..., a, b]) for a in range(3) for b in range(a, 3)]
    return np.stack(planes, axis=1).astype(np.float32)


def _pallas_merge3d(planes, min_sep, K, sorted_w=True, r_par=1):
    mean, cov, w, act = (x.numpy() for x in tgm.unpack_planes(t(planes), 3))
    return tuple(np.asarray(x) for x in gm_merge_pallas_batch_3d(
        jnp.asarray(mean), jnp.asarray(cov), jnp.asarray(w),
        jnp.asarray(act), min_sep, K, interpret=True, r_par=r_par,
        sorted_w=sorted_w))


def _twin_merge3d(planes, min_sep, K):
    out = merge3d_reference(t(planes), min_sep, K)
    assert out.shape == (planes.shape[0], 12, K)
    assert (out[:, 11] == 0).all()                   # the pad plane
    return tuple(x.numpy() for x in tgm.merge_out(out, 3))


def assert_same_merge(got, want):
    """Same clusters in the same greedy emission order: counts equal,
    weights, means and covariances within rtol 1e-4 (atol 1e-6 / 1e-4 /
    1e-3 for values that reach 0: f32 sums in another order)."""
    g_mean, g_cov, g_w, g_nm, g_nd = got
    w_mean, w_cov, w_w, w_nm, w_nd = want
    np.testing.assert_array_equal(g_nm, w_nm)
    np.testing.assert_array_equal(g_nd, w_nd)
    close(g_w, w_w, rtol=1e-4, atol=1e-6)
    close(g_mean, w_mean, rtol=1e-4, atol=1e-4)
    close(g_cov, w_cov, rtol=1e-4, atol=1e-3)


# every sorted case at one shape (P=4, N=64, K=16), so the interpret-mode
# kernel compiles once per mode
MERGE3D_CASES = {
    "clustered": dict(seed=0),
    "clustered_seed1": dict(seed=1),
    "tight": dict(seed=2, spread=1.0),
    "overflow": dict(seed=3, spread=60.0),
}


@pytest.mark.parametrize("case", sorted(MERGE3D_CASES))
def test_merge3d_twin_matches_pallas_sorted(case):
    planes = merge3d_case(**MERGE3D_CASES[case])
    got = _twin_merge3d(planes, 20.0, 16)
    assert_same_merge(got, _pallas_merge3d(planes, 20.0, 16))
    if case == "overflow":     # more clusters than slots: leftovers counted
        assert (got[3] == 16).all() and (got[4] > 0).all()
    else:
        assert (got[3] > 1).all() and (got[4] == 0).all()


def test_merge3d_sort_route_matches_pallas_argmax_mode():
    """Unsorted lanes: JAX's argmax mode (sorted_w=False) against the
    port's route (sort_candidates, then the sorted twin) and against the
    twin on the unsorted lanes directly."""
    for seed, spread, K in ((4, 3.0, 16), (5, 60.0, 16)):
        planes = merge3d_case(seed, spread=spread, sort=False)
        want = _pallas_merge3d(planes, 20.0, K, sorted_w=False)
        assert_same_merge(_twin_merge3d(planes, 20.0, K), want)
        cand = tgm.unpack_planes(t(planes), 3)
        planes_s = td.pack_planes(*tgm.sort_candidates(*cand)).numpy()
        assert_same_merge(_twin_merge3d(planes_s, 20.0, K), want)


@pytest.mark.parametrize("name", MERGE_EDGES_3D4D)
def test_merge3d_twin_matches_pallas_edges(name):
    """merge_bench.MERGE_EDGES at D = 3 (P=4, the active lanes first, 128
    lanes): the twin against the Pallas kernel at its default r_par=8,
    with the tolerances above."""
    planes, K = merge_edge_case(name, D=3)
    planes = active_first(planes)
    want = _pallas_merge3d(planes, MIN_SEP, K, r_par=8)
    assert_same_merge(_twin_merge3d(planes, MIN_SEP, K), want)
    if "K binding" in name:
        assert (want[3] == K).all() and (want[4] > 0).all()
    if "all within" in name:
        assert (want[3] == 1).all() and (want[4] == 0).all()


def test_merge3d_twin_terminates_on_nan_weights():
    planes = merge3d_case(6)
    planes[0, 0] = np.nan            # a whole particle of NaN weights
    planes[1, 0, :8] = 0.0           # zero-weight active lanes
    got = _twin_merge3d(planes, 20.0, 16)
    assert_same_merge(got, _pallas_merge3d(planes, 20.0, 16))
    assert got[3][0] == 0 and got[4][0] == 0 and got[3][1] > 0


def test_merge3d_twin_matches_xla_merge():
    """Against the JAX XLA merge (``jnp.linalg.inv`` distance) on inputs
    where no candidate pair lies within 1e-3 of the threshold, so the two
    distance forms cannot split a decision."""
    planes = merge3d_case(7, P=3, N=48)
    mean, cov, w, act = (x.numpy() for x in tgm.unpack_planes(t(planes), 3))
    d = np.asarray(jmath.mahalanobis2(
        jnp.asarray(mean[:, :, None]), jnp.asarray(cov[:, :, None]),
        jnp.asarray(mean[:, None, :]), jnp.asarray(cov[:, None, :])))
    min_sep = 20.0
    assert np.abs(d - min_sep).min() > 1e-3
    got = tgm.gm_merge_batch(t(mean), t(cov), t(w), t(act), min_sep, 24)
    want = jgm.gm_merge_batch(jnp.asarray(mean), jnp.asarray(cov),
                              jnp.asarray(w), jnp.asarray(act), min_sep, 24)
    assert_same_merge([x.numpy() for x in got], [np.asarray(x) for x in want])


def test_merge3d_wrapper_runs_twin_on_cpu():
    planes = t(merge3d_case(0))
    build.reset_launch_counts()
    assert torch.equal(merge3d(planes, 20.0, 16),
                       merge3d_reference(planes, 20.0, 16))
    assert build.launch_counts["merge3d"] == 0


# ----------------------------------------------------------------------------
# compaction
# ----------------------------------------------------------------------------

def test_compact_candidates_with_ties_matches_jax():
    """Weights from three values, so most lanes tie: the order is
    lax.top_k's (descending, ties to the lowest lane) on every lane."""
    rng = np.random.default_rng(8)
    P, N, cap = 5, 40, 16
    mean = rng.normal(0, 50, (P, N, 3)).astype(np.float32)
    A = rng.normal(0, 1, (P, N, 3, 3))
    cov = (A @ A.transpose(0, 1, 3, 2)).astype(np.float32)
    w = rng.choice([0.1, 0.2, 0.3], (P, N)).astype(np.float32)
    act = rng.random((P, N)) < 0.6
    w[~act] = 0.0
    act[0, :3] = True              # active lanes of zero weight
    w[0, :3] = 0.0
    args = tuple(jnp.asarray(x) for x in (mean, cov, w, act))
    for c in (cap, N, 0):
        want = jax.vmap(lambda m, cv, wt, a: jgm.compact_candidates(
            m, cv, wt, a, c))(*args)
        got = tgm.compact_candidates(t(mean), t(cov), t(w), t(act), c)
        for g, j in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert (np.asarray(want[4]) == 0).all()
    s_mean, s_cov, s_w, s_act = tgm.sort_candidates(t(mean), t(cov), t(w),
                                                    t(act))
    assert torch.equal(s_act.sum(dim=1), t(act & (w > 0)).sum(dim=1))
    assert (s_w[:, 1:] <= s_w[:, :-1]).all()


# ----------------------------------------------------------------------------
# the update halves and the step
# ----------------------------------------------------------------------------

def pre_inputs(jax_runs, name):
    """A state with live features (the JAX run after step 5) with one
    feature cloud per particle moved behind the camera (out of range), and
    the scan of step 6."""
    rows = jax_runs(name)
    arrays = {k: v.copy() for k, v in rows[6]["state"].items()}
    live = np.argmax(arrays["feat_weight"] > 0, axis=1)
    for p, k in enumerate(live):
        arrays["cloud"][p, k, :, 2] = 2.0 + arrays["cloud"][p, k, :, 2] ** 2
    z, mask, _ = scans()
    return arrays, z[6], mask[6]


@pytest.mark.parametrize("name", sorted(STEP_CFGS))
def test_update_halves_match_jax(jax_runs, name):
    cfg = SlamConfig(**dict(DISP, **STEP_CFGS[name]))
    arrays, z, zm = pre_inputs(jax_runs, name)
    K, N = cfg.max_features, cfg.particles_per_feature
    cp, cl, fw = (arrays[k] for k in ("cam_pose", "cloud", "feat_weight"))
    j_pre = jax.jit(jax.vmap(lambda a, b, c: jd._disparity_update_pre(
        a, b, c, jnp.asarray(z), jnp.asarray(zm), cfg)))(cp, cl, fw)
    pre = td._disparity_update_pre(t(cp), t(cl), t(fw), t(z), t(zm), cfg)
    close(pre["dlog_w"], j_pre["dlog_w"], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(pre["out_m"].numpy(), j_pre["out_m"])
    assert pre["out_m"].sum() == len(cp)
    *cand, n_compact = td.order_candidates(pre["cand"],
                                           cfg.merge_candidate_cap)
    np.testing.assert_array_equal(n_compact.numpy(), j_pre["n_compact"])
    if 0 < cfg.merge_candidate_cap < K + M * K + M:
        assert cand[0].shape[1] == cfg.merge_candidate_cap
    else:                          # JAX keeps every lane, unsorted
        cand = pre["cand"]
        assert cand[0].shape[1] == K + M * K + M
    # the Gaussian fit sums N products of point offsets that are small
    # against the points' pixel coordinates, in another order than XLA:
    # its covariance differs by up to ~7e-4 relative, and the detection
    # weights exp(-dist / 2) through it by up to ~2e-4
    j_mean, j_cov, j_w, j_act = (np.asarray(x) for x in j_pre["cand"])
    np.testing.assert_array_equal(cand[3].numpy(), j_act)
    close(cand[2], j_w, rtol=1e-3, atol=1e-7)
    close(cand[0], j_mean, rtol=1e-5, atol=1e-3)
    close(cand[1], j_cov, rtol=2e-3, atol=1e-3)
    assert j_act.sum(axis=1).min() > 0

    # the post-half on the same merge output
    j_mg = jgm.merge_batch_dispatch(
        *j_pre["cand"], cfg, K,
        sorted_prefix=0 < cfg.merge_candidate_cap < K + M * K + M)
    mg = tuple(t(x) for x in j_mg)
    jkeys = jax.random.split(jax.random.PRNGKey(11), len(cp))
    eps = np.stack([np.array(jax.random.normal(k, (K, N, 3), jnp.float32))
                    for k in jkeys])
    j_post = jax.vmap(lambda m, p, a, b, c, k: jd._disparity_update_post(
        m, p, a, b, c, k, cfg))(j_mg, j_pre, cp, cl, fw, jkeys)
    post = td._disparity_update_post(
        mg, dict(pre, n_compact=n_compact), t(cp), t(cl), t(fw), t(eps), cfg)
    got = dict(cam_pose=cp, cloud=post[0].numpy(),
               feat_weight=post[1].numpy())
    want = dict(cam_pose=cp, cloud=np.asarray(j_post[0]),
                feat_weight=np.asarray(j_post[1]))
    close(got["feat_weight"], want["feat_weight"], rtol=1e-6, atol=0)
    assert match_clouds(got, want, cfg, rtol=1e-5, atol=1e-4,
                        spread_rtol=0.0) == 0
    close(post[2], j_post[2], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(post[3].numpy(), j_post[3])


@pytest.mark.parametrize("name", sorted(STEP_CFGS))
def test_disparity_step_matches_jax(jax_runs, name):
    """Eight steps from the same initial state with JAX's replayed draws,
    each torch step from the torch state before it: states per
    :func:`assert_states_close`, outputs within the same tolerances."""
    cfg = SlamConfig(**dict(DISP, **STEP_CFGS[name]))
    rows = jax_runs(name)
    z, mask, _ = scans()
    ts = disparity_state_from_jax(rows[0]["state"])
    resampled, overflow = [], []
    for n in range(N_STEPS):
        ts, out = td.disparity_step(ts, t(z[n]), t(mask[n]), cfg.dt, n > 0,
                                    cfg, rows[n + 1]["noise"])
        want, jout = rows[n + 1]["state"], rows[n + 1]["out"]
        got = disparity_state_to_numpy(ts)
        assert_states_close(got, want, cfg, msg=f"step {n}")
        close(out.expected_pose, jout.expected_pose, rtol=1e-4, atol=1e-5)
        close(out.map_weight, jout.map_weight, rtol=1e-4, atol=1e-5)
        close(out.n_eff, jout.n_eff, rtol=1e-4)
        assert bool(out.resampled) == bool(jout.resampled)
        assert int(out.overflow) == int(jout.overflow)
        assert got["step"] == want["step"]
        resampled.append(bool(jout.resampled))
        overflow.append(int(jout.overflow))
    if cfg.particle_weighting == 0:
        # the Vo weights stay equal over these particles (nEff 1): no
        # resampling there; weighting 0 resamples on some steps
        assert any(resampled) and not all(resampled)
    assert (got["feat_weight"] > 0).sum(axis=1).min() > 0


def test_init_disparity_state_matches_jax():
    jcfg = JaxSlamConfig(**DISP)
    want = jax_arrays(jd.init_disparity_state(jcfg))
    k_init, _ = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    eps = np.array(jax.random.normal(k_init, (jcfg.n_particles, 2)))
    got = disparity_state_to_numpy(td.init_disparity_state(
        SlamConfig(**DISP), t(eps)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_disparity_state_round_trip(jax_runs):
    arrays = jax_runs("cap_binds")[4]["state"]
    back = disparity_state_to_numpy(disparity_state_from_jax(arrays))
    assert back.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
        assert back[k].dtype == arrays[k].dtype


@pytest.mark.parametrize("override,name", [
    (dict(particle_weighting=2), "particle_weighting"),
    (dict(distance_metric=1), "distance_metric"),
    (dict(particles_per_feature=1), "particles_per_feature"),
    (dict(merge_candidate_cap=4096), "merge_candidate_cap"),
])
def test_check_supported_rejects_unported_disparity_options(override, name):
    """Weighting 2 (Vo's scheme there, as in the JAX version), the
    Hellinger merge (merge3d's variant), a merge above merge3d's narrow
    2048 lanes (its staged wide-lane variant) and a cloud of one point
    (NaN covariances, as in the JAX version) are accepted; a cloud of no
    points, which the JAX package does not define, is refused."""
    cfg = SlamConfig(**dict(DISP, **override))
    td.check_supported(cfg, 48, 48)
    if name == "particles_per_feature":
        with pytest.raises(NotImplementedError, match=name):
            td.check_supported(dataclasses.replace(
                cfg, particles_per_feature=0), 48, 48)


def test_one_point_clouds_match_jax_nan_pattern(tmp_path):
    """particles_per_feature 1: the JAX step divides the sample covariance
    by N - 1 = 0 and completes with NaN covariances; four replayed steps
    of the port give the same NaN entries in every state array (the
    finite ones within the step tolerances), both merge3d and the step
    terminate, and the runner's NaN policy reports the first step whose
    weights are NaN, as JAX's do."""
    over = dict(DISP, particles_per_feature=1)
    jcfg, cfg = JaxSlamConfig(**over), SlamConfig(**over)
    step = jd.make_disparity_step_fn(jcfg, donate=False)
    z, mask, _ = scans()
    js = jd.init_disparity_state(jcfg)
    ts = disparity_state_from_jax(jax_arrays(js))
    first_nan = None
    for n in range(4):
        noise = replay_noise(js, jcfg.max_features, 1)
        js, jout = step(js, jnp.asarray(z[n]), jnp.asarray(mask[n]),
                        jnp.float32(jcfg.dt), jnp.asarray(n > 0))
        ts, out = td.disparity_step(ts, t(z[n]), t(mask[n]), cfg.dt, n > 0,
                                    cfg, noise)
        want, got = jax_arrays(js), disparity_state_to_numpy(ts)
        for k in ("cam_pose", "log_weight", "cloud", "feat_weight"):
            np.testing.assert_array_equal(np.isnan(got[k]),
                                          np.isnan(want[k]), err_msg=k)
            ok = ~np.isnan(want[k])
            close(got[k][ok], want[k][ok], rtol=1e-4, atol=1e-4, msg=k)
        assert np.isnan(float(out.n_eff)) == np.isnan(float(jout.n_eff))
        if first_nan is None and np.isnan(float(jout.n_eff)):
            first_nan = n
    assert first_nan is not None
    cfg_run, data, _ = small_run_dir(tmp_path)
    res = run_disparity(dataclasses.replace(cfg_run, particles_per_feature=1,
                                            debug=False),
                        data_dir=data, device="cpu")
    assert res["nan_step"] is not None
    assert np.isnan(res["n_eff"][res["nan_step"]])
    assert np.isfinite(res["n_eff"][:res["nan_step"]]).all()


def test_check_supported_accepts_the_shipped_config():
    from phdslam_tpu_torch.config import load_config
    cfg = load_config("cfg/disparity.cfg")
    td.check_supported(cfg, cfg.max_features, cfg.max_measurements)


# ----------------------------------------------------------------------------
# the runner, loaders and eval copies
# ----------------------------------------------------------------------------

def test_load_image_measurements_matches_jax():
    path = "data/disparity/measurements.txt"
    got, want = load_image_measurements(path), \
        jax_load_image_measurements(path)
    assert len(got) == len(want) == 80
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert max(len(g) for g in got) == 28


def test_simdata_disparity_copies_match_jax(tmp_path):
    kw = dict(n_landmarks=12, n_steps=9, dt=0.5, seed=3, vx=0.08)
    for g, w in zip(tsim.generate_disparity_world(**kw),
                    jsim.generate_disparity_world(**kw)):
        if isinstance(g, list):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tsim.camera_rotation_np(0.1, -0.2, 0.3),
                                  jsim.camera_rotation_np(0.1, -0.2, 0.3))
    _, _, ms = tsim.generate_disparity_world(**kw)
    tsim.write_disparity_run_dir(str(tmp_path / "t"), ms)
    jsim.write_disparity_run_dir(str(tmp_path / "j"), ms)
    assert (tmp_path / "t" / "measurements.txt").read_text() \
        == (tmp_path / "j" / "measurements.txt").read_text()


def small_run_dir(tmp_path, T=6):
    cfg = SlamConfig(**dict(DISP, n_steps=T, debug=True))
    _, traj, ms = tsim.generate_disparity_world(
        n_landmarks=6, n_steps=T, dt=cfg.dt, seed=4, vx=cfg.vx0)
    data = tmp_path / "d"
    tsim.write_disparity_run_dir(str(data), ms)
    np.savetxt(str(data / "traj.txt"), traj[:, :6])
    return cfg, str(data), traj


def test_run_disparity_outputs_on_cpu(tmp_path):
    """timing=True: per-step loopTime.log; cfg.debug adds one particle
    .mat per step; trajectory.txt holds the expected poses."""
    import scipy.io as sio
    cfg, data, _ = small_run_dir(tmp_path)
    out = tmp_path / "run"
    res = run_disparity(cfg, data_dir=data, out_dir=str(out), timing=True,
                        device="cpu")
    assert res["est_poses"].shape == (6, 12)
    assert np.isfinite(res["est_poses"]).all()
    lt = np.loadtxt(out / "loopTime.log")
    assert len(lt) == 6 and np.allclose(lt, res["step_ms"], rtol=1e-5)
    np.testing.assert_allclose(np.loadtxt(out / "trajectory.txt"),
                               res["est_poses"], rtol=1e-5)
    mats = sorted(p.name for p in out.iterdir() if p.suffix == ".mat")
    assert len(mats) == 6
    d = sio.loadmat(str(out / mats[-1]))
    assert d["clouds"].shape == (6, 12, 8, 3)
    st = res["final_state"]
    assert (st.feat_weight > 0).sum() > 0 and st.step == 6
    # without timing: no mats, loopTime.log holds the mean
    res = run_disparity(cfg, data_dir=data, out_dir=str(tmp_path / "r2"),
                        device="cpu")
    assert res["step_ms"] is None
    assert not any(p.suffix == ".mat" for p in (tmp_path / "r2").iterdir())


def test_run_disparity_follow_trajectory(tmp_path):
    """Known poses: one particle at traj.txt's pose (padded to 12 columns)
    on every step, no prediction."""
    cfg, data, traj = small_run_dir(tmp_path)
    cfg = dataclasses.replace(cfg, follow_trajectory=True)
    res = run_disparity(cfg, data_dir=data, device="cpu")
    assert res["final_state"].cam_pose.shape == (1, 12)
    want = np.zeros((6, 12))
    want[:, :6] = traj[:, :6]
    np.testing.assert_allclose(res["est_poses"], want, rtol=1e-6,
                               atol=1e-7)
    assert cfg.n_particles == 6          # the caller's config is untouched


def test_evaluate_disparity_on_cpu():
    """tests/test_disparity.py::test_evaluate_disparity_mapping_accuracy's
    size and bounds: known-pose mapping must recover the landmark set
    (cardinality within 4, OSPA(1, c=1 m) < 0.97)."""
    r = evaluate_disparity(n_landmarks=15, n_steps=40, seed=0, device="cpu")
    assert r["n_true"] == 15
    assert abs(r["n_est"] - r["n_true"]) <= 4, r
    assert r["ospa"] < 0.97, r
    assert np.isfinite(r["n_eff"]).all()


def test_evaluate_disparity_full_slam_on_cpu():
    """tests/test_disparity.py::test_evaluate_disparity_filtered_pose's
    size and bound, at P=32 (cfg/disparity.cfg's count)."""
    r = evaluate_disparity(n_landmarks=15, n_steps=30, seed=1,
                           follow_trajectory=False, device="cpu")
    assert np.isfinite(r["pose_err"]).all()
    assert r["mean_pose_err"] < 1.0, r
