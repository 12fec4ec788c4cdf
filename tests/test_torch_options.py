"""The options the port used to refuse, against the JAX package: Vo's
empty-map weighting (particle_weighting 1) on the static map's three
routes, the CPHD update with compute_variance, the disparity filter's
weighting 2 and Hellinger merge, a checkpoint round trip that carries the
two-scan birth memory, and ``check_supported``'s surface.

The same numpy inputs (from a seed) go through the JAX functions and their
counterparts in ``phdslam_tpu_torch``; the JAX Pallas kernels run in
interpret mode where the JAX version reaches one, and the port's kernel
wrappers run their plain twins on the CPU. Each test states its
tolerance.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.config import SlamConfig as JaxSlamConfig
from phdslam_tpu.eval.parity import _mixed_world as jax_mixed_world
from phdslam_tpu.filters import disparity as jd
from phdslam_tpu.filters.phd import make_step_fn
from phdslam_tpu.types import init_state as jax_init_state
from phdslam_tpu_torch.config import SlamConfig
from phdslam_tpu_torch.eval.parity import _mixed_cfg, _mixed_world
from phdslam_tpu_torch.filters import disparity as td
from phdslam_tpu_torch.filters.phd import check_supported, phd_step
from phdslam_tpu_torch.slam import ScanRunner
from phdslam_tpu_torch.types import (disparity_state_from_jax,
                                     disparity_state_to_numpy, init_state,
                                     state_from_jax, state_to_numpy)
from test_consolidate import base_cfg, make_scene
from test_torch_disparity import DISP, M as DISP_M, N_STEPS as DISP_STEPS
from test_torch_disparity import assert_states_close as assert_disp_close
from test_torch_disparity import jax_arrays as disp_arrays
from test_torch_disparity import replay_noise as disp_noise
from test_torch_disparity import scans
from test_torch_step import jax_state_arrays, replay_noise
from test_torch_variants import assert_update_close, jax_update, port_update


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


# ----------------------------------------------------------------------------
# Vo's empty-map weighting on the static map
# ----------------------------------------------------------------------------

# the routes: det (0 < T < K, the cap binds: cn_det from the detect
# kernel's row sums), the top-cap lane route (T = K: from the pdw grid),
# the full grid (cap 0: the normalized grid's sum); with the knobs that
# act on the det route (fused gather + merge, consolidation)
WEIGHTING1 = {
    "det": {}, "topcap": dict(detection_topk=32),
    "full grid": dict(merge_candidate_cap=0),
    "det fused": dict(fused_gather_merge=1),
    "det consolidating": dict(premerge_consolidate=1),
    "topcap hellinger": dict(detection_topk=32, distance_metric=1,
                             min_separation=0.6),
}


@pytest.mark.parametrize("route", list(WEIGHTING1))
@pytest.mark.parametrize("seed", [0, 1])
def test_static_weighting1_update_matches_jax(route, seed):
    """particle_weighting=1 on tests/test_consolidate.py's scenes: merged
    maps, dlog_w and overflow per test_torch_variants.assert_update_close
    (weights, means and dlog_w rtol 1e-4 / atol 1e-5, covariances rtol
    1e-3, the overflow exactly), and dlog_w unlike the cluster process's."""
    kw = dict(particle_weighting=1, pallas_merge=2, merge_r_par=1,
              **WEIGHTING1[route])
    scene = make_scene(seed)
    jcfg = base_cfg(**kw)
    cfg = SlamConfig(**dataclasses.asdict(jcfg))
    got = port_update(cfg, scene)
    assert_update_close(got, jax_update(jcfg, scene))
    plain = port_update(dataclasses.replace(cfg, particle_weighting=0),
                        scene)
    assert not np.allclose(got[3], plain[3])


def test_static_weighting1_steps_match_jax():
    """Eight Ackerman-free CV steps at weighting 1 with JAX's replayed
    draws (the det route, resampling on): poses within 1e-5, log weights
    and maps rtol 1e-4 / atol 1e-5, the same ancestors."""
    dt = 0.15
    world = jax_mixed_world(8, 0, 8, dt, 5, 8)
    kw = dict(n_particles=8, max_features=16, max_measurements=8,
              motion_type=0, feature_model=0, filter_type=0, vx0=1.5,
              vyaw0=0.2, ax=0.3, ayaw=0.03, max_range=12.0, std_range=0.5,
              std_bearing=0.02, clutter_rate=5.0, pd=0.95, birth_weight=0.02,
              min_separation=2.0, resample_threshold=0.98,
              particle_weighting=1, detection_topk=8,
              merge_candidate_cap=64, pallas_detect=2, pallas_merge=2,
              merge_r_par=1, seed=3)
    jcfg, tcfg = JaxSlamConfig(**kw), SlamConfig(**kw)
    step = make_step_fn(jcfg, donate=False)
    js = jax_init_state(jcfg)
    ts = state_from_jax(jax_state_arrays(js))
    for n in range(8):
        z, zm = world["z_all"][n], world["mask_all"][n]
        noise = replay_noise(js, jcfg)
        js, jout = step(js, jnp.asarray(z), jnp.asarray(zm),
                        jnp.zeros(2, jnp.float32), jnp.float32(dt),
                        jnp.asarray(n > 0))
        ts, tout = phd_step(ts, t(z), t(zm), (0.0, 0.0), dt, n > 0, tcfg,
                            noise)
        got, want = state_to_numpy(ts), jax_state_arrays(js)
        close(got["pose"], want["pose"], rtol=0, atol=1e-5, msg=f"step {n}")
        for k in ("log_weight", "map_weight", "map_mean"):
            close(got[k], want[k], rtol=1e-4, atol=1e-5, msg=f"{k} {n}")
        np.testing.assert_array_equal(got["resample_idx"],
                                      want["resample_idx"])


# ----------------------------------------------------------------------------
# CPHD with compute_variance
# ----------------------------------------------------------------------------

CPHD = dict(n_particles=6, max_features=16, max_measurements=6,
            filter_type=1, particle_weighting=0, motion_type=0,
            max_range=12.0, std_range=0.5, std_bearing=0.02, clutter_rate=5.0,
            pd=0.95, birth_weight=0.02, min_separation=2.0, vx0=1.5,
            vyaw0=0.2, ax=0.3, ayaw=0.03, max_cardinality=24,
            detection_topk=8, merge_candidate_cap=64, pallas_detect=2,
            pallas_merge=2, merge_r_par=1, resample_threshold=0.9, seed=2)


def test_cphd_compute_variance_matches_jax_and_plain():
    """CPHD with compute_variance: four steps against JAX's with its
    replayed draws (poses within 1e-5, log weights and maps rtol 1e-4 /
    atol 1e-5), the variance zero in both; and the port's runner with and
    without the flag bit-equal (the second generator draws nothing)."""
    dt = 0.15
    world = jax_mixed_world(8, 0, 4, dt, 5, 6)
    kw = dict(CPHD, compute_variance=True)
    jcfg, tcfg = JaxSlamConfig(**kw), SlamConfig(**kw)
    check_supported(tcfg, 16, 6)
    step = make_step_fn(jcfg, donate=False)
    js = jax_init_state(jcfg)
    ts = state_from_jax(jax_state_arrays(js))
    for n in range(4):
        z, zm = world["z_all"][n], world["mask_all"][n]
        noise = replay_noise(js, jcfg)
        js, _ = step(js, jnp.asarray(z), jnp.asarray(zm),
                     jnp.zeros(2, jnp.float32), jnp.float32(dt),
                     jnp.asarray(n > 0))
        ts, _ = phd_step(ts, t(z), t(zm), (0.0, 0.0), dt, n > 0, tcfg,
                         noise)
        got, want = state_to_numpy(ts), jax_state_arrays(js)
        close(got["pose"], want["pose"], rtol=0, atol=1e-5, msg=f"step {n}")
        for k in ("log_weight", "map_weight", "map_mean"):
            close(got[k], want[k], rtol=1e-4, atol=1e-5, msg=f"{k} {n}")
        assert (got["variance"] == 0).all() and (want["variance"] == 0).all()
    runs = []
    for flag in (True, False):
        cfg = SlamConfig(**dict(CPHD, compute_variance=flag))
        r = ScanRunner(cfg, world["z_all"][:4], world["mask_all"][:4], dt,
                       device="cpu")
        res = r.run(collect_particles=True)
        runs.append((res, state_to_numpy(r.state)))
    for k in ("est_poses", "log_weights", "poses"):
        np.testing.assert_array_equal(runs[0][0][k], runs[1][0][k])
    assert (runs[0][1]["variance"] == 0).all()


# ----------------------------------------------------------------------------
# the disparity filter: weighting 2 and the Hellinger merge
# ----------------------------------------------------------------------------

DISP_OPTIONS = {"weighting2": dict(particle_weighting=2),
                "hellinger": dict(distance_metric=1, min_separation=0.6),
                "hellinger no cap": dict(distance_metric=1,
                                         min_separation=0.6,
                                         merge_candidate_cap=0)}


def _jax_hellinger_det_product(mean_a, cov_a, mean_b, cov_b):
    """The JAX package's ops/math.py::hellinger2 with det(A B) taken as
    det A det B, as the port takes it: on the disparity path's thin
    covariances (c22 ~ 9e3 with c02 ~ -4e2) the f32 LU determinant of the
    product A B loses its sign (step 1 of this run: -10066 where float64
    gives 55126), which turns a distance of 0.498 into 1.0."""
    from phdslam_tpu.ops import math as jm
    d = mean_a - mean_b
    sigma = cov_a + cov_b
    det_sigma = jm.det_nd(sigma)
    ok = (det_sigma > 1.1754944e-38)[..., None, None]
    eye = jnp.eye(sigma.shape[-1], dtype=sigma.dtype)
    S_inv = jnp.where(ok, jm.inv_nd(jnp.where(ok, sigma, eye)), eye)
    eps = -0.25 * jnp.einsum("...i,...ij,...j->...", d, S_inv, d)
    det_half = det_sigma / (2.0 ** sigma.shape[-1])
    det_prod = jm.det_nd(cov_a) * jm.det_nd(cov_b)
    ratio = jnp.sqrt(jnp.maximum(det_prod, 0.0)) / jnp.maximum(det_half,
                                                               1e-30)
    return 1.0 - jnp.sqrt(jnp.maximum(ratio, 0.0)) * jnp.exp(eps)


@pytest.mark.parametrize("name", list(DISP_OPTIONS))
def test_disparity_option_steps_match_jax(name):
    """Eight disparity steps from the same initial state with JAX's
    replayed draws: states per test_torch_disparity.assert_states_close
    (poses within 1e-5, log and feature weights rtol 1e-4 / atol 1e-5,
    the same ancestors, the clouds matched); weighting 2 is Vo's scheme in
    both, the Hellinger merge XLA's gm_merge there and merge3d's
    Hellinger twin here, with the one departure the port makes
    (:func:`_jax_hellinger_det_product`) applied to the JAX side."""
    from unittest import mock
    from phdslam_tpu.ops import gm_merge as jgm
    kw = dict(DISP, **DISP_OPTIONS[name])
    jcfg, cfg = JaxSlamConfig(**kw), SlamConfig(**kw)
    td.check_supported(cfg, cfg.max_features, DISP_M)
    z, mask, _ = scans()
    with mock.patch.object(jgm, "hellinger2", _jax_hellinger_det_product):
        step = jd.make_disparity_step_fn(jcfg, donate=False)
        js = jd.init_disparity_state(jcfg)
        ts = disparity_state_from_jax(disp_arrays(js))
        for n in range(DISP_STEPS):
            noise = disp_noise(js, jcfg.max_features,
                               jcfg.particles_per_feature)
            js, jout = step(js, jnp.asarray(z[n]), jnp.asarray(mask[n]),
                            jnp.float32(jcfg.dt), jnp.asarray(n > 0))
            ts, out = td.disparity_step(ts, t(z[n]), t(mask[n]), cfg.dt,
                                        n > 0, cfg, noise)
            assert_disp_close(disparity_state_to_numpy(ts), disp_arrays(js),
                              cfg, msg=f"step {n}")
            assert int(out.overflow) == int(jout.overflow)
    assert (disparity_state_to_numpy(ts)["feat_weight"] > 0).any()


def test_hellinger_3d_thin_covariance_matches_float64():
    """The pair of that run's step 1 on which the JAX formula's f32
    det(A B) turns negative: the port's 3D Hellinger distance (twin of
    merge3d's) is the float64 one to 1e-5."""
    from phdslam_tpu_torch.ops.math import hellinger2
    a = np.array([[0.94351989, 0.011324879, -21.573437],
                  [0.011324879, 0.33519194, -1.7412655],
                  [-21.573437, -1.7412655, 643.49951]], np.float32)
    b = np.array([[16.766031, 0.30264097, -383.80133],
                  [0.30264097, 0.50934905, -9.1571836],
                  [-383.80133, -9.1571836, 8939.3584]], np.float32)
    d = np.array([406.65924 - 402.21344, 178.96802 - 178.88818,
                  85.62143 - 187.3914], np.float32)
    got = float(hellinger2(t(d)[None], t(a)[None], torch.zeros(1, 3),
                           t(b)[None])[0])
    A, B, dd = a.astype(np.float64), b.astype(np.float64), d.astype(
        np.float64)
    q = dd @ np.linalg.inv(A + B) @ dd
    want = 1 - np.sqrt(np.sqrt(np.linalg.det(A) * np.linalg.det(B))
                       / np.linalg.det((A + B) / 2)) * np.exp(-q / 4)
    assert abs(got - want) < 1e-5
    assert float(jnp.linalg.det(jnp.asarray(a) @ jnp.asarray(b))) < 0


# ----------------------------------------------------------------------------
# checkpoints carry prev_z
# ----------------------------------------------------------------------------

def test_checkpoint_round_trip_carries_prev_z(tmp_path):
    """A mixed run with birth_velocity_init saved after 4 of 8 steps and
    resumed in a fresh runner repeats the uninterrupted run byte for byte
    (poses, weights, prev_z), and the checkpoint holds prev_z."""
    from phdslam_tpu_torch.runtime.checkpoint import load_checkpoint
    cfg = _mixed_cfg(6, 3, max_features=16, max_measurements=8,
                     merge_candidate_cap=64, detection_topk=8,
                     birth_velocity_init=1, resample_threshold=0.9)
    w = _mixed_world(8, 2, 8, 0.15, 3, 8)

    def runner():
        return ScanRunner(cfg, w["z_all"], w["mask_all"], 0.15,
                          device="cpu")
    full = runner()
    res_full = full.run(chunk=4, collect_particles=True)
    half = runner()
    half.run(chunk=4, checkpoint_every=4, checkpoint_dir=str(tmp_path))
    saved = load_checkpoint(str(tmp_path / "step00004"), init_state(cfg))
    assert saved.prev_z is not None and saved.prev_z[..., 2].any()
    resumed = runner()
    start = resumed.restore(str(tmp_path / "step00004"))
    res = resumed.run(chunk=4, start_step=start, collect_particles=True)
    for k in ("est_poses", "log_weights", "poses"):
        np.testing.assert_array_equal(res[k][4:], res_full[k][4:])
    a, b = state_to_numpy(resumed.state), state_to_numpy(full.state)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert "prev_z" in a


def test_state_round_trip_carries_prev_z():
    """init_state's prev_z matches the JAX state's (zeros [P, M, 3]) and
    goes through state_to_numpy / state_from_jax unchanged."""
    kw = dict(n_particles=4, max_features=8, max_measurements=6,
              feature_model=2, birth_velocity_init=1)
    js = jax_init_state(JaxSlamConfig(**kw))
    ts = init_state(SlamConfig(**kw))
    np.testing.assert_array_equal(ts.prev_z.numpy(), np.asarray(js.prev_z))
    arrays = state_to_numpy(ts)
    arrays["prev_z"] = np.random.default_rng(0).normal(
        size=arrays["prev_z"].shape).astype(np.float32)
    back = state_to_numpy(state_from_jax(arrays))
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    assert init_state(SlamConfig(**dict(kw, birth_velocity_init=0))) \
        .prev_z is None


# ----------------------------------------------------------------------------
# check_supported
# ----------------------------------------------------------------------------

K_CS, M_CS = 32, 8
CS = dict(max_features=K_CS, max_measurements=M_CS, detection_topk=8,
          merge_candidate_cap=64, n_particles=16, filter_type=0,
          particle_weighting=0)
MIXED_CS = dict(CS, feature_model=2, motion_type=0)


@pytest.mark.parametrize("over", [
    dict(particle_weighting=1), dict(particle_weighting=1,
                                     merge_candidate_cap=0),
    dict(filter_type=1, compute_variance=True), dict(feature_model=1),
    dict(feature_model=1, compute_variance=True),
    dict(feature_model=1, map_estimate=2, distance_metric=1),
    dict(MIXED_CS, particle_weighting=2), dict(MIXED_CS, compute_variance=True),
    dict(MIXED_CS, mixed_fast_path=0), dict(MIXED_CS, birth_velocity_init=1),
    dict(MIXED_CS, detection_topk=K_CS), dict(MIXED_CS, distance_metric=1),
    dict(MIXED_CS, filter_type=1),
    dict(merge_candidate_cap=K_CS + 8 * K_CS + 8, max_measurements=80),
], ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()
                          if CS.get(k) != v))
def test_check_supported_accepts_every_named_option(over):
    check_supported(SlamConfig(**dict(CS, **over)), K_CS, M_CS)


def test_check_supported_refuses_only_tiles_by_name():
    """No option is refused by name any more: the tiled merge (and any
    other merge_spatial_tiles, untiled as in the JAX package) is accepted,
    and only a value the JAX package does not define is refused."""
    for tiles in (4, 2, 0):
        check_supported(SlamConfig(**dict(CS, merge_spatial_tiles=tiles)),
                        K_CS, M_CS)
    with pytest.raises(NotImplementedError, match="distance_metric"):
        check_supported(SlamConfig(**dict(CS, merge_spatial_tiles=4,
                                          distance_metric=2)), K_CS, M_CS)


@pytest.mark.parametrize("over,M,D,width", [
    # the mixed full grid at the mixed bench's widths: 128 + 32 * 128 + 32
    (dict(MIXED_CS, max_features=128, max_measurements=32,
          merge_candidate_cap=0), 32, 4, 4256),
    # the dynamic-only map's full grid: 64 + 32 * 64 + 32 > 2048
    (dict(CS, feature_model=1, max_features=64, max_measurements=32,
          merge_candidate_cap=0), 32, 4, 2144),
    (dict(CS, max_features=256, max_measurements=32, merge_candidate_cap=0),
     32, 2, 8480),
], ids=["mixed full grid", "dynamic-only full grid", "static full grid"])
def test_check_supported_accepts_widths_by_route(over, M, D, width):
    """Merges wider than their narrow kernels are accepted: each takes the
    full-grid route (the mixed model's per-particle route), whose lanes
    exceed the narrow kernel's width, so the staged wide-lane variant runs
    on the card."""
    from phdslam_tpu_torch.filters.mixed import uses_fast_route
    from phdslam_tpu_torch.filters.phd import full_grid_width, update_route
    from phdslam_tpu_torch.kernels.merge import NARROW_LANES, uses_wide
    cfg = SlamConfig(**over)
    K = over["max_features"]
    check_supported(cfg, K, M)
    assert update_route(cfg, K, M) == "full"
    if cfg.feature_model == 2:
        assert not uses_fast_route(cfg, K, M)
    assert full_grid_width(cfg, K, M) == width > NARROW_LANES[D]
    assert uses_wide(D, width)


def test_disparity_check_supported_accepts_widths():
    """A disparity merge above merge3d's narrow 2048 lanes (cap 4096 at
    K = M = 48: every one of the 48 + 48 * 48 + 48 = 2400 lanes) is
    accepted; it takes the staged wide-lane variant. A cloud of one point
    is accepted (NaN covariances, as in the JAX package), one of no points
    refused."""
    from phdslam_tpu_torch.kernels.merge import NARROW_LANES, uses_wide
    base = dict(DISP, particle_weighting=2, distance_metric=1)
    td.check_supported(SlamConfig(**base), 48, 48)
    td.check_supported(SlamConfig(**dict(base, merge_candidate_cap=4096)),
                       48, 48)
    assert 48 + 48 * 48 + 48 == 2400 > NARROW_LANES[3] and uses_wide(3, 2400)
    td.check_supported(SlamConfig(**dict(base, particles_per_feature=1)),
                       48, 48)
    with pytest.raises(NotImplementedError, match="particles_per_feature"):
        td.check_supported(SlamConfig(**dict(base, particles_per_feature=0)),
                           48, 48)
