"""The mixed model's per-particle route, its two-scan velocity births, the
top-cap lane route, the dynamic-only 4D map and the 3D/4D merge variants
of the port against the JAX package.

The same numpy inputs (from a seed) go through the JAX functions and their
counterparts in ``phdslam_tpu_torch`` at the shapes of
tests/test_mixed_dynamic.py (P <= 8, K = 16, M = 6 or 8). On the JAX side
the Pallas kernels run in interpret mode (pallas_detect=2, pallas_merge=2)
where the JAX version reaches one (the static merge's and the 4D
Mahalanobis merge's argmax mode on the per-particle route), and XLA's
``gm_merge_batch`` where the JAX version takes it (the Hellinger distance
at D = 3 and 4). On the CPU the port's kernel wrappers run their plain
twins. Each test states its tolerance.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.config import SlamConfig as JaxSlamConfig
from phdslam_tpu.eval.parity import _mixed_world as jax_mixed_world
from phdslam_tpu.filters.mixed import mixed_update as jax_mixed_update
from phdslam_tpu.filters.phd import make_step_fn
from phdslam_tpu.models import measurement as jmeas
from phdslam_tpu.ops.gm_merge import gm_merge_batch as jax_gm_merge_batch
from phdslam_tpu.ops.pallas_merge import gm_merge_pallas_batch_packed_4d
from phdslam_tpu.types import init_state as jax_init_state
from phdslam_tpu_torch.config import SlamConfig
from phdslam_tpu_torch.filters.mixed import mixed_update, uses_fast_route
from phdslam_tpu_torch.filters.phd import phd_step
from phdslam_tpu_torch.kernels.merge import (merge3d_reference,
                                             merge4d_reference)
from phdslam_tpu_torch.models import measurement as tmeas
from phdslam_tpu_torch.ops.gm_merge import merge_out, unpack_planes
from phdslam_tpu_torch.types import state_from_jax, state_to_numpy
from merge_bench import HELL_SEP, MIN_SEP, merge_edge_case
from test_torch_kernels import active_first
from test_torch_mixed import (MIXED, MIXED_STEP, assert_states_close, close,
                              jax_state, mixed_state, t)
from test_torch_step import jax_state_arrays, replay_noise


def jax_arrays(js, prev_z=False):
    """jax_state_arrays with the dynamic map (and the JAX state's prev_z)."""
    out = jax_state_arrays(js, dynamic=True)
    if prev_z:
        out["prev_z"] = np.asarray(js.prev_z)
    return out


def slow_update(cfg, labels=None):
    """One mixed update of the same state in both packages (the route each
    takes for ``cfg``): (port state, port overflow, JAX state, JAX
    overflow)."""
    arrays, z, zm = mixed_state(cfg)
    lab = {} if labels is None else dict(z_label=labels)
    js, j_ovf = jax_mixed_update(
        jax_state(cfg, arrays), jnp.asarray(z), jnp.asarray(zm), cfg,
        **{k: jnp.asarray(v) for k, v in lab.items()})
    ts, t_ovf = mixed_update(state_from_jax(arrays), t(z), t(zm), cfg,
                             **{k: t(v) for k, v in lab.items()})
    return state_to_numpy(ts), int(t_ovf), jax_arrays(js), int(j_ovf)


# ----------------------------------------------------------------------------
# the per-particle route
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("weighting,labeled,extra", [
    (0, False, {}), (1, False, {}), (2, False, {}), (0, True, {}),
    (1, True, {}), (2, True, {}),
    (0, False, dict(merge_candidate_cap_dynamic=12)),
    (1, False, dict(merge_candidate_cap=0)),
    (0, False, dict(distance_metric=1, min_separation=0.6)),
    (2, False, dict(distance_metric=1, min_separation=0.6,
                    merge_candidate_cap=0)),
], ids=lambda v: str(v) if not isinstance(v, dict) else
    ",".join(f"{k}={x}" for k, x in v.items()) or "plain")
def test_slow_route_update_matches_jax(weighting, labeled, extra):
    """mixed_fast_path=0 (and weighting 2, which takes the route anyway):
    both maps, the log weights and the poses within rtol 1e-4 / atol 1e-5,
    the covariances rtol 1e-3 / atol 2e-4, the overflow exactly. The
    static merge is merge2d's argmax mode against the Pallas 2D kernel's,
    the dynamic one merge4d's argmax mode against _merge_kernel_4d's
    (Mahalanobis) or its Hellinger variant against XLA's gm_merge."""
    cfg = SlamConfig(**dict(MIXED, particle_weighting=weighting,
                            labeled_measurements=labeled, mixed_fast_path=0,
                            **extra))
    assert not uses_fast_route(cfg, cfg.max_features, cfg.max_measurements)
    labels = np.array([0, 0, 1, 1, 0, 1], np.int32)
    got, g_ovf, want, w_ovf = slow_update(cfg, labels)
    assert_states_close(got, want)
    for name in ("map_cov", "dyn_cov"):
        close(got[name], want[name], rtol=1e-3, atol=2e-4, msg=name)
    assert g_ovf == w_ovf
    assert (got["dyn_weight"] > 0).sum() > 0


def test_slow_route_compute_variance_leaves_zeros():
    """compute_variance takes the per-particle route, which estimates no
    variance in either package: the state's variance stays zero and the
    update equals the route's without the flag (rtol 1e-4 / atol 1e-5
    against JAX)."""
    cfg = SlamConfig(**dict(MIXED, compute_variance=True))
    assert not uses_fast_route(cfg, cfg.max_features, cfg.max_measurements)
    got, g_ovf, want, w_ovf = slow_update(cfg)
    assert_states_close(got, want)
    assert g_ovf == w_ovf
    assert (got["variance"] == 0).all() and (want["variance"] == 0).all()
    plain, _, _, _ = slow_update(dataclasses.replace(
        cfg, compute_variance=False, mixed_fast_path=0))
    for k in ("log_weight", "map_weight", "dyn_weight", "dyn_mean"):
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)


@pytest.mark.parametrize("weighting", [0, 1])
def test_fast_route_matches_slow_route(weighting):
    """The port's two routes on the same state, as the JAX package's
    test_mixed_fast_path_matches_slow holds its own: log weights within
    2e-5, map weights rtol 2e-4 / atol 2e-5, live means rtol 2e-4 / atol
    2e-4, live covariances rtol 2e-3 / atol 2e-4."""
    cfg = SlamConfig(**dict(MIXED, particle_weighting=weighting,
                            n_particles=5))
    arrays, z, zm = mixed_state(cfg)
    fast, _ = mixed_update(state_from_jax(arrays), t(z), t(zm), cfg)
    slow, _ = mixed_update(state_from_jax(arrays), t(z), t(zm),
                           dataclasses.replace(cfg, mixed_fast_path=0))
    close(fast.log_weight, slow.log_weight, rtol=2e-5, atol=2e-5)
    for name in ("map_static", "map_dynamic"):
        gf, gs = getattr(fast, name), getattr(slow, name)
        close(gf.weight, gs.weight, rtol=2e-4, atol=2e-5, msg=name)
        live = gs.weight.numpy() > 1e-6
        close(gf.mean.numpy()[live], gs.mean.numpy()[live], rtol=2e-4,
              atol=2e-4, msg=name)
        close(gf.cov.numpy()[live], gs.cov.numpy()[live], rtol=2e-3,
              atol=2e-4, msg=name)


# ----------------------------------------------------------------------------
# the top-cap lane route of the fast route
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("T,weighting", [(16, 0), (16, 1), (0, 0)])
def test_fast_route_topcap_lanes_match_jax(T, weighting):
    """detection_topk outside (0, K) with a binding cap: both maps' [M, K]
    grids ranked by weight (topk_compact_indices), no detect kernel; rtol
    1e-4 / atol 1e-5, covariances rtol 1e-3 / atol 2e-4, the overflow
    exactly."""
    cfg = SlamConfig(**dict(MIXED, detection_topk=T,
                            particle_weighting=weighting))
    assert uses_fast_route(cfg, cfg.max_features, cfg.max_measurements)
    got, g_ovf, want, w_ovf = slow_update(cfg)
    assert_states_close(got, want)
    for name in ("map_cov", "dyn_cov"):
        close(got[name], want[name], rtol=1e-3, atol=2e-4, msg=name)
    assert g_ovf == w_ovf


# ----------------------------------------------------------------------------
# two-scan velocity births
# ----------------------------------------------------------------------------

def test_seed_birth_velocity_matches_jax():
    """The nearest valid previous point within birth_velocity_max * dt,
    argmin ties to the lowest index, velocities to 1e-5."""
    rng = np.random.default_rng(3)
    cfg = SlamConfig(**dict(MIXED, birth_velocity_init=1, dt=0.15,
                            birth_velocity_max=3.0))
    P, M, Mp = 4, 6, 8
    b = np.zeros((P, M, 4), np.float32)
    b[..., :2] = rng.uniform(-5, 5, (P, M, 2))
    prev = np.zeros((P, Mp, 3), np.float32)
    prev[:, :M, :2] = b[..., :2] + rng.normal(0, 0.2, (P, M, 2))
    prev[:, :, 2] = rng.random((P, Mp)) < 0.8
    prev[:, M:, :2] = prev[:, :2, :2]          # exact ties to earlier ones
    prev[0, :, 2] = 0.0                        # no valid previous point
    zm = np.arange(M) < 5
    got = tmeas.seed_birth_velocity(t(b), t(prev), t(zm), cfg).numpy()
    want = np.stack([np.asarray(jmeas.seed_birth_velocity(
        jnp.asarray(b[p]), jnp.asarray(prev[p]), jnp.asarray(zm), cfg))
        for p in range(P)])
    close(got, want, rtol=1e-5, atol=1e-5)
    assert (got[0, :, 2:] == 0).all() and (got[1:, :5, 2:] != 0).any()
    assert (got[:, 5:, 2:] == 0).all()


@pytest.mark.parametrize("fast", [1, 0])
def test_two_scan_steps_carry_prev_z(fast):
    """Six mixed steps with birth_velocity_init from the same state with
    JAX's replayed draws, resampling on every step with measurements
    (threshold 0.98): prev_z (gathered by each resampling) within 1e-4,
    poses within 1e-5, weights and maps rtol 1e-4 / atol 1e-5, the same
    ancestors, on the fast route and the per-particle one."""
    dt = 0.15
    n_steps = 6
    world = jax_mixed_world(8, 2, n_steps, dt, 3, 8)
    kw = dict(MIXED_STEP, birth_velocity_init=1, mixed_fast_path=fast,
              birth_velocity_max=8.0, dt=dt)
    jcfg, tcfg = JaxSlamConfig(**kw), SlamConfig(**kw)
    step = make_step_fn(jcfg, donate=False)
    js = jax_init_state(jcfg)
    ts = state_from_jax(jax_arrays(js, prev_z=True))
    assert ts.prev_z is not None
    ctrl = np.zeros(2, np.float32)
    seeded = 0
    for n in range(n_steps):
        z, zm = world["z_all"][n], world["mask_all"][n]
        noise = replay_noise(js, jcfg)
        js, jout = step(js, jnp.asarray(z), jnp.asarray(zm),
                        jnp.asarray(ctrl), jnp.float32(dt),
                        jnp.asarray(n > 0))
        ts, tout = phd_step(ts, t(z), t(zm), (0.0, 0.0), dt, n > 0, tcfg,
                            noise)
        got, want = state_to_numpy(ts), jax_arrays(js, prev_z=True)
        close(got["pose"], want["pose"], rtol=0, atol=1e-5, msg=f"step {n}")
        assert_states_close(got, want, msg=f"step {n}")
        close(got["prev_z"], want["prev_z"], rtol=1e-5, atol=1e-4,
              msg=f"prev_z step {n}")
        np.testing.assert_array_equal(got["resample_idx"],
                                      want["resample_idx"])
        assert bool(tout.resampled) == bool(jout.resampled)
        seeded += int((np.abs(got["dyn_mean"][..., 2:]) > 1e-3).sum())
    assert seeded > 0


# ----------------------------------------------------------------------------
# the dynamic-only 4D map
# ----------------------------------------------------------------------------

FM1 = dict(MIXED_STEP, feature_model=1, resample_threshold=0.7)


@pytest.mark.parametrize("extra", [
    {}, dict(particle_weighting=1), dict(merge_candidate_cap=0),
    dict(detection_topk=16), dict(distance_metric=1, min_separation=0.6),
    dict(particle_weighting=2), dict(fused_gather_merge=1,
                                     premerge_consolidate=1),
    dict(compute_variance=True),
], ids=lambda v: ",".join(f"{k}={x}" for k, x in v.items()) or "det route")
def test_dynamic_only_map_steps_match_jax(extra):
    """feature_model=1: six phd_steps of the static pipeline on the 4D
    map (births from birth_mean_cov_4d, merge4d) with JAX's replayed
    draws: poses within 1e-5, log weights and the dynamic map within rtol
    1e-4 / atol 1e-5, the MAP map extracted from it (rtol 1e-4 / atol
    1e-5), the static map untouched. The 2D-only knobs (fused gather +
    merge, consolidation) do not act there, as in the JAX version; the
    variance (the per-particle full grid at D = 4 in both packages, on
    JAX's draws) within rtol 1e-4 / atol 1e-6."""
    dt = 0.15
    n_steps = 6
    world = jax_mixed_world(8, 2, n_steps, dt, 3, 8)
    kw = dict(FM1, **extra)
    jcfg, tcfg = JaxSlamConfig(**kw), SlamConfig(**kw)
    step = make_step_fn(jcfg, donate=False)
    js = jax_init_state(jcfg)
    ts = state_from_jax(jax_arrays(js))
    ctrl = np.zeros(2, np.float32)
    for n in range(n_steps):
        z, zm = world["z_all"][n], world["mask_all"][n]
        noise = replay_noise(js, jcfg, full_grid=True)
        js, jout = step(js, jnp.asarray(z), jnp.asarray(zm),
                        jnp.asarray(ctrl), jnp.float32(dt),
                        jnp.asarray(n > 0))
        ts, tout = phd_step(ts, t(z), t(zm), (0.0, 0.0), dt, n > 0, tcfg,
                            noise)
        got, want = state_to_numpy(ts), jax_arrays(js)
        close(got["pose"], want["pose"], rtol=0, atol=1e-5, msg=f"step {n}")
        assert_states_close(got, want, msg=f"step {n}")
        assert int(tout.overflow) == int(jout.overflow)
        close(got["variance"], want["variance"], rtol=1e-4, atol=1e-6,
              msg=f"variance step {n}")
        close(tout.map_weight, jout.map_weight, rtol=1e-4, atol=1e-5)
        assert tuple(tout.map_mean.shape) == (16, 4)
    assert (got["dyn_weight"] > 0).sum(axis=1).min() > 0
    assert (got["map_weight"] == 0).all()


# ----------------------------------------------------------------------------
# merge4d's argmax mode and the 3D / 4D Hellinger twins
# ----------------------------------------------------------------------------

ARGMAX_EDGES = ["NaN and w <= 0 weights", "equal weights",
                "every lane its own cluster, K binding",
                "all within min_sep of the first", "one lane"]


@pytest.mark.parametrize("name", ARGMAX_EDGES)
def test_merge4d_argmax_twin_matches_pallas(name):
    """merge4d's argmax twin against _merge_kernel_4d at sorted_w=False
    in interpret mode (r_par 8), on merge_bench.MERGE_EDGES' lanes in a
    random order (first 128 lanes): w <= 0 active lanes (absorbed, never
    leading), NaN rows (stalled), a binding out_cap; counts exactly,
    weights and means rtol 1e-4 / atol 1e-5, covariances rtol 1e-3 / atol
    1e-5."""
    planes, K = merge_edge_case(name, False, D=4)
    planes = np.ascontiguousarray(planes[:, :, :128])
    out = gm_merge_pallas_batch_packed_4d(jnp.asarray(planes), MIN_SEP, K,
                                          interpret=True, sorted_w=False)
    want = [np.asarray(x) for x in out]
    got = [x.numpy() for x in merge_out(merge4d_reference(
        torch.from_numpy(planes), MIN_SEP, K, sorted_w=False), 4)]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    close(got[2], want[2], rtol=1e-4, atol=1e-5)
    close(got[0], want[0], rtol=1e-4, atol=1e-5)
    close(got[1], want[1], rtol=1e-3, atol=1e-5)
    if "NaN" in name:                 # stalled rows, and a w <= 0 row
        assert list(want[3][:2]) == [0, 0] and want[3][3] == 0
        assert (want[4][:2] == 0).all() and want[3][2] > 0
    if "K binding" in name:
        assert (want[3] == K).all() and (want[4] > 0).all()


@pytest.mark.parametrize("D,name", [
    (3, "clustered"), (4, "clustered"),
    (3, "every lane its own cluster, K binding"),
    (4, "every lane its own cluster, K binding"),
    (4, "NaN and w <= 0 weights"), (3, "equal weights")])
def test_hellinger_3d4d_twins_match_xla_merge(D, name):
    """merge3d's and merge4d's Hellinger twins against the JAX package's
    XLA gm_merge_batch with distance_metric=1 (the route it takes at
    D = 3, 4) on weight-sorted lanes: counts exactly (no pair within 1e-5
    of min_separation at these seeds), weights and means rtol 1e-4 / atol
    1e-5, covariances rtol 1e-3 / atol 1e-5."""
    if name == "clustered":
        from merge_bench import merge3d_inputs, merge4d_inputs
        cpu = torch.device("cpu")
        planes = (merge3d_inputs(cpu, P=6, N=96, seed=4, spread=3.0)
                  if D == 3 else merge4d_inputs(cpu, P=6, N=96, seed=4))
        planes, K, sep = planes.numpy(), 12, 0.5
    else:
        planes, K = merge_edge_case(name, True, D=D)
        planes, sep = active_first(planes, n=96), HELL_SEP
    packed = torch.from_numpy(planes)
    mean, cov, w, act = (x.numpy() for x in unpack_planes(packed, D))
    want = [np.asarray(x) for x in jax_gm_merge_batch(
        jnp.asarray(mean), jnp.asarray(cov), jnp.asarray(w),
        jnp.asarray(act), sep, K, distance_metric=1)]
    ref = merge3d_reference if D == 3 else merge4d_reference
    got = [x.numpy() for x in merge_out(ref(packed, sep, K, metric=1), D)]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    close(got[2], want[2], rtol=1e-4, atol=1e-5)
    close(got[0], want[0], rtol=1e-4, atol=1e-5)
    close(got[1], want[1], rtol=1e-3, atol=1e-5)
    if name == "clustered":
        assert (want[3] > 1).all() and (want[3] < (w > 0).sum(1)).all()
