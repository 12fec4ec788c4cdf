"""The torch filter step and runner against the JAX package.

The same initial state and the same random draws go through
``phdslam_tpu.filters.phd.phd_step`` (its Pallas kernels in interpret mode:
pallas_detect=2, pallas_merge=2) and ``phdslam_tpu_torch``'s ``phd_step``
(its kernels' plain twins, since the tensors lie on the CPU). The torch
step takes its noise as an input; the test replays JAX's key schedule to
produce it: fold_in(rng, step) -> split(3) -> (k_pred, k_res, k_var), the
prediction draw from fold_in(k_pred, i) (P k rows under shotgunning), the
resampling uniforms from k_res and the MC variance samples from
split(k_var, P k).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phdslam_tpu.config import load_config as jax_load_config
from phdslam_tpu.filters.phd import make_step_fn
from phdslam_tpu.types import init_state as jax_init_state
from phdslam_tpu_torch import load_config
from phdslam_tpu_torch.filters.phd import StepNoise, phd_step, uses_full_grid
from phdslam_tpu_torch.runtime import io
from phdslam_tpu_torch.slam import SynthSLAMRunner, build_schedule
from phdslam_tpu_torch.types import state_from_jax, state_to_numpy

CFG = "cfg/ackerman.cfg"
DATA = "data/ackerman"
# the small Ackerman slice: det route needs 0 < T < K and the fast path
# cap < K + M K + M; =2 runs the JAX package's Pallas kernels in interpret
# mode on the CPU. nEff stays near 1 over the first steps at P=8, so the
# threshold is raised until steps 3 and 4 resample (nEff 0.99944, 0.99927).
SMALL = dict(n_particles=8, max_features=32, max_measurements=8,
             detection_topk=8, merge_candidate_cap=64, pallas_detect=2,
             pallas_merge=2, resample_threshold=0.9995)
N_STEPS = 5


def jax_state_arrays(s, dynamic=False):
    """Numpy copies of a JAX state under ``state_from_jax``'s keys; with
    ``dynamic``, the mixed model's 4D map as well."""
    out = {"pose": np.asarray(s.pose), "log_weight": np.asarray(s.log_weight),
           "map_mean": np.asarray(s.map_static.mean),
           "map_cov": np.asarray(s.map_static.cov),
           "map_weight": np.asarray(s.map_static.weight),
           "resample_idx": np.asarray(s.resample_idx),
           "variance": np.asarray(s.variance),
           "step": np.asarray(s.step)}
    if dynamic:
        out.update(dyn_mean=np.asarray(s.map_dynamic.mean),
                   dyn_cov=np.asarray(s.map_dynamic.cov),
                   dyn_weight=np.asarray(s.map_dynamic.weight))
    if s.cardinality is not None:
        out["cardinality"] = np.asarray(s.cardinality)
    return out


def assert_log_card_close(got, want, msg=""):
    """Log cardinalities [P, C+1]: entries within 60 nats of their row's
    peak to atol 1e-4 in the log domain; deeper ones need only stay more
    than 50 nats below it on both sides (probability < 2e-22 of the peak),
    since the Toeplitz convolution's f32 subnormals, which XLA's CPU
    flushes and PyTorch keeps, can turn LOG0 into a finite value there.
    NaN never counts as agreement."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.isfinite(got).all() and np.isfinite(want).all(), msg
    peak = want.max(axis=1, keepdims=True)
    near = want > peak - 60.0
    np.testing.assert_allclose(got[near], want[near], rtol=1e-5, atol=1e-4,
                               err_msg=msg)
    assert ((got - peak)[~near] < -50.0).all(), msg


def replay_noise(state, cfg, full_grid=False):
    """The draws JAX's phd_step makes from this state's key: per sub-step
    a [P k, 3] draw for the CV vehicle (motion_type 0), [P k, 2] for
    Ackerman (k = n_predict_particles), [P] resampling uniforms and, with
    compute_variance, the MC variance samples: sample s is
    normal(fold_in(keys[0], s), (2, P k, N)) on a capped route (the
    estimator over the selected lanes), normal(fold_in(keys[p], s),
    (N, D)) for each particle p on the full grid (``full_grid``), with
    keys = split(k_var, P k) (the source's ``keys``)."""
    P = state.pose.shape[0]
    n_ext = P * max(1, cfg.n_predict_particles)
    key = jax.random.fold_in(state.rng, state.step)
    k_pred, k_res, k_var = jax.random.split(key, 3)
    sub = max(1, cfg.subdivide_predict)
    width = 3 if cfg.motion_type == 0 else 2
    eps = np.stack([np.array(jax.random.normal(
        jax.random.fold_in(k_pred, i), (n_ext, width), dtype=jnp.float32))
        for i in range(sub)])
    u = np.array(jax.random.uniform(k_res, (P,), dtype=jnp.float32))
    var_draw = None
    if cfg.compute_variance:
        keys = jax.random.split(k_var, n_ext)

        def var_draw(s, shape):
            if full_grid:
                x = np.stack([np.array(jax.random.normal(
                    jax.random.fold_in(keys[p], s), tuple(shape[1:]),
                    dtype=jnp.float32)) for p in range(shape[0])])
            else:
                x = np.array(jax.random.normal(
                    jax.random.fold_in(keys[0], s), tuple(shape),
                    dtype=jnp.float32))
            return torch.from_numpy(x)
        var_draw.keys = keys
    return StepNoise(eps_pred=torch.from_numpy(eps),
                     u_resample=torch.from_numpy(u), var_draw=var_draw)


def dataset(m_max, data=DATA, dt=1.0):
    ms = io.load_measurements(f"{data}/measurements.txt")
    controls = (io.load_controls(f"{data}/controls.txt")
                if os.path.exists(f"{data}/controls.txt")
                else np.zeros((0, 2), np.float32))
    sched = build_schedule(
        len(ms), len(controls), io.load_timestamps(
            f"{data}/measurement_times.txt"),
        io.load_timestamps(f"{data}/control_times.txt"), dt, -1)
    z, mask = io.pad_measurements(ms, m_max)
    return z, mask, controls, sched


def replay_dataset(cfg_path, data, small, n_steps, resync=False):
    """Run the JAX step and the torch step side by side over the first
    ``n_steps`` of a dataset with JAX's replayed draws, holding poses,
    weights, the static map, the CPHD cardinality (log domain, atol 1e-4)
    and the step outputs equal; returns the final torch state and whether any
    step resampled. With ``resync`` every torch step starts from the JAX
    state, so each step is held from the same inputs (for weightings
    that amplify the earlier steps' f32 reassociation)."""
    jcfg = jax_load_config(cfg_path, small)
    tcfg = load_config(cfg_path, small)
    z_all, mask_all, controls, sched = dataset(tcfg.max_measurements, data,
                                               tcfg.dt)
    step = make_step_fn(jcfg, donate=False)
    js = jax_init_state(jcfg)
    ts = state_from_jax(jax_state_arrays(js))
    control = np.zeros(2, np.float32)
    resampled = []
    for n, plan in enumerate(sched[:n_steps]):
        if plan.c_idx >= 0:
            control = controls[plan.c_idx]
        z, zm = z_all[plan.z_idx], mask_all[plan.z_idx]
        if resync:
            ts = state_from_jax(jax_state_arrays(js))
        noise = replay_noise(js, jcfg, uses_full_grid(
            tcfg, tcfg.max_components, tcfg.max_measurements))
        js, jout = step(js, jnp.asarray(z), jnp.asarray(zm),
                        jnp.asarray(control), jnp.float32(plan.dt),
                        jnp.asarray(plan.do_predict))
        ts, tout = phd_step(ts, torch.from_numpy(z), torch.from_numpy(zm),
                            tuple(float(c) for c in control), plan.dt,
                            plan.do_predict, tcfg, noise)
        got, want = state_to_numpy(ts), jax_state_arrays(js)
        for name in ("pose", "log_weight", "map_weight"):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name} step {n}")
        if "cardinality" in want:
            assert_log_card_close(got["cardinality"], want["cardinality"],
                                  f"card step {n}")
            assert_log_card_close(tout.cardinality.numpy()[None],
                                  np.asarray(jout.cardinality)[None],
                                  f"MAP card step {n}")
        np.testing.assert_allclose(tout.expected_pose.numpy(),
                                   np.asarray(jout.expected_pose),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(tout.n_eff), float(jout.n_eff),
                                   rtol=1e-4)
        assert bool(tout.resampled) == bool(jout.resampled)
        np.testing.assert_array_equal(got["resample_idx"],
                                      want["resample_idx"])
        assert int(tout.overflow) == int(jout.overflow)
        resampled.append(bool(jout.resampled))
    return ts, resampled


def test_phd_step_matches_jax():
    ts, resampled = replay_dataset(CFG, DATA, SMALL, N_STEPS)
    # the steps exercised resampling, and a map took shape in every particle
    assert any(resampled)
    assert (state_to_numpy(ts)["map_weight"] > 0).sum(axis=1).min() > 0


def test_cv_dataset_step_matches_jax():
    """cfg/cv.cfg on data/cv (no controls, no timestamps): the static map
    with the constant-velocity vehicle, 5 replayed steps."""
    small = dict(SMALL, resample_threshold=0.9)
    ts, _ = replay_dataset("cfg/cv.cfg", "data/cv", small, 5)
    assert (state_to_numpy(ts)["map_weight"] > 0).sum(axis=1).min() > 0


def test_state_round_trip():
    js = jax_init_state(jax_load_config(CFG, SMALL))
    arrays = jax_state_arrays(js)
    back = state_to_numpy(state_from_jax(arrays))
    assert back.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)


def test_init_state_matches_jax():
    from phdslam_tpu_torch.types import init_state
    cfg = SMALL
    want = jax_state_arrays(jax_init_state(jax_load_config(CFG, cfg)))
    got = state_to_numpy(init_state(load_config(CFG, cfg)))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_build_schedule_matches_jax():
    from phdslam_tpu.slam import build_schedule as jax_build_schedule
    for args in ((331, 330, io.load_timestamps(
            f"{DATA}/measurement_times.txt"),
            io.load_timestamps(f"{DATA}/control_times.txt"), 1.0, -1),
            (12, 11, np.zeros(0), np.zeros(0), 0.1, 7)):
        got = [vars(p) for p in build_schedule(*args)]
        want = [vars(p) for p in jax_build_schedule(*args)]
        assert got == want


def test_runner_on_cpu_tracks_the_start():
    """The runner drives phd_step over the dataset schedule: finite, and
    close to the true track over the first steps."""
    cfg = load_config(CFG, dict(SMALL, n_steps=6))
    r = SynthSLAMRunner(cfg, DATA, device="cpu")
    res = r.run(chunk=4)
    assert res["est_poses"].shape == (6, 6)
    assert np.isfinite(res["est_poses"]).all()
    traj = np.load(f"{DATA}/groundtruth.npz")["traj"]
    err = np.linalg.norm(res["est_poses"][:, :2] - traj[:6, :2], axis=1)
    assert err.max() < 1.0


@pytest.mark.parametrize("over,refused", [
    (dict(filter_type=2), "filter_type"), (dict(merge_spatial_tiles=4), None)],
    ids=["undefined filter_type", "tiles accepted"])
def test_runner_rejects_unported_config(over, refused):
    """The runner refuses a value the JAX package does not define and
    takes the spatially tiled merge, which the JAX package runs."""
    cfg = load_config(CFG, dict(SMALL, **over))
    if refused is None:
        SynthSLAMRunner(cfg, DATA, device="cpu")
        return
    with pytest.raises(NotImplementedError, match=refused):
        SynthSLAMRunner(cfg, DATA, device="cpu")


def test_evaluate_dataset_on_cpu():
    from phdslam_tpu_torch.eval.parity import evaluate_dataset
    r = evaluate_dataset(CFG, ".", n_steps=4, overrides=SMALL, device="cpu")
    assert r["pose_err"].shape == (4,)
    assert np.isfinite(r["mean_pose_err"]) and r["mean_pose_err"] < 1.0
    # every-step OSPA(1, 5): bounded by c, and the first maps are partial
    assert r["ospa"].shape == (4,)
    assert ((r["ospa"] >= 0) & (r["ospa"] <= 5.0)).all()
    assert r["mean_ospa"] == float(np.mean(r["ospa"]))
