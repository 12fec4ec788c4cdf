"""Accuracy evaluation (port of ``phdslam_tpu/eval/parity.py``:
``evaluate_dataset``, ``evaluate_mixed`` with its world and configuration,
its Monte-Carlo aggregate ``evaluate_mixed_mc``, and
``evaluate_disparity``).

The dataset protocol: run the filter over the dataset, take the expected
pose on every step that carries a measurement set, and score its XY error
against ``groundtruth.npz`` ``traj`` at that measurement index (the ATE),
and the MAP map of every such step with OSPA(1, 5) against the landmarks
observed so far.
The mixed protocol generates a world of static landmarks and moving
targets from a seed and scores the pose error and the final static and
dynamic maps with OSPA. The disparity protocol generates a camera world
from a seed and scores the MAP particle's 3D landmark map with OSPA (and,
in full-SLAM mode, the camera position error).
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch

from ..config import SlamConfig, load_config
from ..slam import ScanRunner, SynthSLAMRunner
from ..slam_disparity import run_disparity
from . import simdata
from .ospa import extract_map_estimate, ospa_distance


def evaluate_dataset(cfg_path: str, repo_root: str = ".",
                     n_steps: Optional[int] = None,
                     overrides: Optional[dict] = None, device="cuda",
                     mesh=None):
    """Run the filter on a dataset and score it against its ground truth.

    OSPA(p=1, c=5) is scored on every measurement step, as the JAX version
    does by default: the MAP particle's map estimate against the landmarks
    observed up to that step (``groundtruth.npz`` ``cumulative_counts``,
    all landmarks when absent). Returns pose_err [T] (m) and ospa [T] with
    their mean/final (and the max pose error), est_poses, steps_per_s and
    the runner's result dict under "run". With a particle ``mesh`` this
    rank runs its block (``parallel/sharding.py``); every rank scores the
    same result.
    """
    cfg = load_config(cfg_path, overrides)
    data_dir = os.path.join(repo_root, cfg.data_directory)
    if n_steps:
        cfg.n_steps = n_steps
    gt = np.load(os.path.join(data_dir, "groundtruth.npz"))
    traj, landmarks = gt["traj"], gt["landmarks"]
    cum_counts = (gt["cumulative_counts"] if "cumulative_counts" in gt.files
                  else np.full(len(traj), len(landmarks)))

    r = SynthSLAMRunner(cfg, data_dir, device=device, mesh=mesh)
    res = r.run(collect_maps=True)

    midx = [i for i, p in enumerate(r.schedule) if p.z_idx >= 0]
    zidx = [p.z_idx for p in r.schedule if p.z_idx >= 0]
    est = res["est_poses"][midx]
    T = min(len(est), len(traj))
    pose_err = np.linalg.norm(est[:T, :2] - traj[np.asarray(zidx[:T]), :2],
                              axis=1)
    ospas = []
    for j in range(T):
        est_map = extract_map_estimate(res["map_weights"][midx[j]],
                                       res["map_means"][midx[j]])
        true_map = landmarks[:cum_counts[min(zidx[j], len(cum_counts) - 1)]]
        ospas.append(ospa_distance(true_map, est_map, p=1, c=5)[0])
    return {
        "pose_err": pose_err,
        "ospa": np.asarray(ospas),
        "est_poses": est,
        "final_pose_err": float(pose_err[-1]),
        "mean_pose_err": float(pose_err.mean()),
        "max_pose_err": float(pose_err.max()),
        "final_ospa": float(ospas[-1]),
        "mean_ospa": float(np.mean(ospas)),
        "steps_per_s": res["steps_per_s"],
        "run": res,
    }


def _mixed_cfg(n_particles, seed, **overrides):
    """The mixed-world configuration: CV vehicle without controls, PHD,
    static 2D + dynamic 4D maps (feature_model 2), cluster-process
    weighting, and the JAX package's tuned dynamic-birth settings."""
    base = dict(
        n_particles=n_particles, max_features=24, max_measurements=32,
        motion_type=0, feature_model=2, filter_type=0,
        vx0=1.5, vyaw0=0.2, ax=0.3, ayaw=0.03,
        max_range=12.0, std_range=0.5,
        std_bearing=0.02, clutter_rate=5.0, pd=0.95,
        min_separation=2.0, resample_threshold=0.5,
        # without odometry only the particle weights anchor the pose;
        # scheme 0 sums the log normalizers (the measurement likelihood)
        particle_weighting=0, tau=0.2, cov_vx_birth=0.25, cov_vy_birth=0.25,
        # birth_weight 0.02 keeps fresh clutter births in the dynamic map
        # below the extraction threshold; the near-zero CV process noise
        # keeps tracked movers' velocities from diffusing between detections
        birth_weight=0.02, std_ax_map=0.01, std_ay_map=0.01, seed=seed)
    base.update(overrides)
    return SlamConfig(**base)


def _mixed_world(n_landmarks, n_movers, n_steps, dt, seed, max_meas):
    """One mixed world and its whole measurement schedule, from a seed:
    landmarks, a CV loop trajectory, movers on constant-velocity tracks
    reflecting off the +-8.5 m field boundary, and unlabeled noisy scans
    of both per step."""
    rng = np.random.default_rng(seed)
    sp = simdata.SensorParams(max_range=12.0, std_range=0.5,
                              std_bearing=0.02, pd=0.95, clutter_rate=5.0)
    # yaw_rate 0.2 at v 1.5: a 7.5 m-radius loop inside the landmark field
    landmarks, traj = simdata.generate_world_cv(
        n_landmarks=n_landmarks, extent=12.0, n_steps=n_steps, dt=dt,
        seed=seed, v0=1.5, yaw_rate=0.2)
    movers = rng.uniform(-8.0, 8.0, size=(n_movers, 2))
    mover_v = rng.uniform(-0.5, 0.5, size=(n_movers, 2))

    z_all = np.zeros((n_steps, max_meas, 2), np.float32)
    mask_all = np.zeros((n_steps, max_meas), bool)
    mv = movers.copy()
    vel = mover_v.copy()
    mv_hist = np.zeros((n_steps, len(movers), 2))
    for n in range(n_steps):
        mv_hist[n] = mv
        targets = np.vstack([landmarks, mv])
        zs = simdata.noisy_measurements(traj[n], targets, sp, rng)
        m = min(len(zs), max_meas)
        z_all[n, :m] = zs[:m]
        mask_all[n, :m] = True
        if n < n_steps - 1:         # keep mv at the last-measured positions
            mv = mv + vel * dt
            for ax in range(2):
                hi = mv[:, ax] > 8.5
                lo = mv[:, ax] < -8.5
                vel[hi | lo, ax] *= -1.0
                mv[hi, ax] = 17.0 - mv[hi, ax]
                mv[lo, ax] = -17.0 - mv[lo, ax]

    seen = np.zeros(len(landmarks), bool)
    for t in range(n_steps):
        seen |= np.linalg.norm(landmarks - traj[t, :2], axis=1) \
            <= sp.max_range
    return dict(landmarks=landmarks, traj=traj, movers_final=mv,
                mover_v=vel, mv_hist=mv_hist, seen=seen,
                z_all=z_all, mask_all=mask_all)


def evaluate_mixed(n_landmarks: int = 30, n_movers: int = 2,
                   n_steps: int = 100, dt: float = 0.15, seed: int = 0,
                   n_particles: int = 256, ospa_c: float = 5.0,
                   cfg_overrides: Optional[dict] = None, device="cuda"):
    """End-to-end accuracy of the mixed (jump-Markov) filter on a world
    with static landmarks and moving targets, CV vehicle without controls,
    unlabeled range-bearing scans.

    Scores the pose error per step, the final static-map OSPA against the
    landmarks seen, the final dynamic map (weights above
    min_expected_feature_weight) against the movers in sensor range at the
    last step, and the dynamic map's velocity error (matched by position).
    Returns the JAX version's keys plus "run" (the runner's result dict).
    """
    w = _mixed_world(n_landmarks, n_movers, n_steps, dt, seed, 32)
    cfg = _mixed_cfg(n_particles, seed, **(cfg_overrides or {}))
    r = ScanRunner(cfg, w["z_all"], w["mask_all"], dt, device=device)
    run = r.run()
    ep = run["est_poses"]
    state = r.state

    traj = w["traj"]
    pose_err = np.linalg.norm(ep[:, :2] - traj[:n_steps, :2], axis=1)
    best = int(torch.argmax(state.log_weight))
    s_w = state.map_static.weight[best].cpu().numpy()
    s_m = state.map_static.mean[best].cpu().numpy()
    est_static = extract_map_estimate(s_w, s_m)
    o_s, _, _ = ospa_distance(w["landmarks"][w["seen"]], est_static,
                              p=1, c=ospa_c)

    d_w = state.map_dynamic.weight[best].cpu().numpy()
    d_full = state.map_dynamic.mean[best].cpu().numpy()
    # dynamic targets: weights above the expected-target threshold (fresh
    # clutter births sit near bw / (clutter density + bw) in this map)
    thr = cfg.min_expected_feature_weight
    est_dyn = d_full[d_w > thr][:, :2]
    est_dyn_full = d_full[d_w > thr]
    est_dyn_round = extract_map_estimate(d_w, d_full[:, :2])
    # dynamic truth: movers in sensor range at the last step (out-of-range
    # dynamic features are killed by design)
    vis = np.linalg.norm(w["movers_final"] - traj[len(w["mv_hist"]) - 1, :2],
                         axis=1) <= cfg.max_range
    truth_dyn = w["movers_final"][vis]
    if len(truth_dyn):
        o_d, _, _ = ospa_distance(truth_dyn, est_dyn, p=1, c=ospa_c)
        o_dr, _, _ = ospa_distance(truth_dyn, est_dyn_round, p=1, c=ospa_c)
    else:
        o_d = o_dr = float("nan")
    # track-level stats over visible movers: detected = an estimate within
    # 2 m, in the dynamic map or in either map
    speeds = np.linalg.norm(np.asarray(w["mover_v"]), axis=1)[vis]
    det, perr, det_any, det_speed = [], [], [], []
    for mvp, spd in zip(truth_dyn, speeds):
        dmin = (float(np.min(np.linalg.norm(est_dyn - mvp, axis=1)))
                if len(est_dyn) else float("inf"))
        det.append(dmin < 2.0)
        det_speed.append(spd)
        if dmin < 2.0:
            perr.append(dmin)
        dmin_s = (float(np.min(np.linalg.norm(est_static - mvp, axis=1)))
                  if len(est_static) else float("inf"))
        det_any.append(min(dmin, dmin_s) < 2.0)

    vel_errs = []
    for i, mvp in enumerate(w["movers_final"]):
        if not vis[i] or len(est_dyn_full) == 0:
            continue
        j = int(np.argmin(np.linalg.norm(est_dyn_full[:, :2] - mvp,
                                         axis=1)))
        if np.linalg.norm(est_dyn_full[j, :2] - mvp) < ospa_c:
            vel_errs.append(np.linalg.norm(
                est_dyn_full[j, 2:4] - w["mover_v"][i]))
    return {
        "static_ospa": float(o_s), "dynamic_ospa": float(o_d),
        "dynamic_ospa_round": float(o_dr),
        "n_dyn_visible": int(vis.sum()),
        "dyn_detected_frac": (float(np.mean(det)) if det
                              else float("nan")),
        "dyn_detected_any_frac": (float(np.mean(det_any)) if det_any
                                  else float("nan")),
        "det_flags": det, "det_any_flags": det_any,
        "det_speeds": det_speed,
        "dyn_track_err": (float(np.mean(perr)) if perr else float("nan")),
        "n_static_true": int(w["seen"].sum()),
        "n_static_est": len(est_static),
        "n_dyn_est": len(est_dyn),
        "pose_err": pose_err,
        "mean_pose_err": float(pose_err.mean()),
        "final_pose_err": float(pose_err[-1]),
        "vel_err": (float(np.mean(vel_errs)) if vel_errs else float("nan")),
        "n_eff": float(run["n_eff"][-1]),
        "run": run,
    }


DETECTION_STRATA = (("slow_0.2-0.35", 0.2, 0.35), ("mid_0.35-0.5", 0.35, 0.5),
                    ("fast_0.5+", 0.5, np.inf))     # mover speeds, m/s


def evaluate_mixed_mc(n_runs: int = 50, n_landmarks: int = 30,
                      n_movers: int = 2, n_steps: int = 100,
                      dt: float = 0.15, n_particles: int = 256,
                      ospa_c: float = 5.0,
                      cfg_overrides: Optional[dict] = None,
                      verbose: bool = False, device="cuda"):
    """Monte-Carlo accuracy of the mixed filter: :func:`evaluate_mixed` at
    seeds 0 .. n_runs - 1 (a fresh world and noise each), aggregated as
    the JAX version's ``evaluate_mixed_mc``: per metric the mean and
    standard deviation over the runs that have a value (a run whose
    movers all left the sensor's range has no dynamic OSPA), and the
    movers' detection (in the dynamic map, or in either map) over every
    visible mover of the campaign, overall and by speed
    (:data:`DETECTION_STRATA`). ``runs`` holds each run's result."""
    rows = []
    for s in range(n_runs):
        r = evaluate_mixed(n_landmarks=n_landmarks, n_movers=n_movers,
                           n_steps=n_steps, dt=dt, seed=s,
                           n_particles=n_particles, ospa_c=ospa_c,
                           cfg_overrides=cfg_overrides, device=device)
        rows.append(r)
        if verbose:
            print(f"run {s}: pose {r['mean_pose_err']:.2f} "
                  f"static {r['static_ospa']:.2f} "
                  f"dyn {r['dynamic_ospa']:.2f} vel {r['vel_err']:.2f}",
                  flush=True)

    def agg(k):
        v = np.asarray([r[k] for r in rows], np.float64)
        v = v[np.isfinite(v)]
        return ((float(v.mean()), float(v.std())) if len(v)
                else (float("nan"), float("nan")))

    def cat(k, dtype):
        return (np.concatenate([np.asarray(r[k], dtype) for r in rows])
                if rows else np.zeros(0, dtype))

    def frac(flags):
        return float(flags.mean()) if len(flags) else float("nan")
    flags, flags_any = cat("det_flags", bool), cat("det_any_flags", bool)
    spd = cat("det_speeds", np.float64)
    strata = {}
    for name, lo, hi in DETECTION_STRATA:
        m = (spd >= lo) & (spd < hi)
        strata[name] = {"n": int(m.sum()), "dyn": frac(flags[m]),
                        "either": frac(flags_any[m])}
    return {
        "n_runs": n_runs,
        "det_strata": strata,
        "det_overall": {"dyn": frac(flags), "either": frac(flags_any)},
        "pose": agg("mean_pose_err"),
        "static_ospa": agg("static_ospa"),
        "dynamic_ospa": agg("dynamic_ospa"),
        "dyn_detected_frac": agg("dyn_detected_frac"),
        "dyn_track_err": agg("dyn_track_err"),
        "vel_err": agg("vel_err"),
        "runs": rows,
    }


def observed_landmarks(landmarks, traj, cfg: SlamConfig):
    """Landmarks ever inside the image and in front of the camera (more
    than 0.5 m) along the trajectory [T, >= 6]."""
    observed = np.zeros(len(landmarks), bool)
    for t in range(len(traj)):
        R = simdata.camera_rotation_np(*traj[t, 3:6])
        pc = (landmarks - traj[t, :3]) @ R
        zc = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = cfg.u0 - cfg.fx * pc[:, 0] / zc
            v = cfg.v0 - cfg.fy * pc[:, 1] / zc
        observed |= ((zc < -0.5) & (u > 0) & (u < cfg.image_width)
                     & (v > 0) & (v < cfg.image_height))
    return observed


def disparity_map_estimate(state):
    """The MAP particle's landmark estimate: its feature clouds' means,
    the round(sum w) heaviest live features."""
    best = int(torch.argmax(state.log_weight))
    feat_means = state.cloud[best].mean(dim=1).cpu().numpy()     # [K, 3]
    return extract_map_estimate(state.feat_weight[best].cpu().numpy(),
                                feat_means)


def evaluate_disparity(cfg_path: str = "cfg/disparity.cfg",
                       n_landmarks: int = 25, n_steps: int = 60,
                       seed: int = 0, follow_trajectory: bool = True,
                       ospa_c: float = 1.0,
                       cfg_overrides: Optional[dict] = None, device="cuda"):
    """Mapping accuracy of the monocular SC-PHD pipeline.

    Generates a camera world (``simdata.generate_disparity_world``,
    intrinsics from ``cfg_path``), runs the disparity filter (by default
    in known-pose mapping mode, follow_trajectory, which isolates map
    accuracy from pose drift) and scores the MAP particle's 3D landmark
    estimate with OSPA(1, c=``ospa_c`` m) against the landmarks that were
    ever visible. Full-SLAM mode (``follow_trajectory=False``) adds the
    per-step camera position error. Returns the JAX version's keys plus
    "run" (the runner's result dict).
    """
    cfg = load_config(cfg_path, cfg_overrides)
    cfg.follow_trajectory = follow_trajectory
    cfg.n_steps = n_steps

    landmarks, traj, measurements = simdata.generate_disparity_world(
        n_landmarks=n_landmarks, n_steps=n_steps, dt=cfg.dt, seed=seed,
        fx=cfg.fx, fy=cfg.fy, u0=cfg.u0, v0=cfg.v0,
        width=int(cfg.image_width), height=int(cfg.image_height),
        std_uv=cfg.std_u, pd=cfg.pd, clutter_rate=cfg.clutter_rate,
        vx=cfg.vx0)
    observed = observed_landmarks(landmarks, traj, cfg)

    with tempfile.TemporaryDirectory(prefix="disparity_eval_") as tmp:
        simdata.write_disparity_run_dir(tmp, measurements)
        np.savetxt(os.path.join(tmp, "traj.txt"), traj)
        res = run_disparity(cfg, data_dir=tmp, device=device)
    est_map = disparity_map_estimate(res["final_state"])
    o, loc, cn = ospa_distance(landmarks[observed], est_map, p=1, c=ospa_c)
    out = {
        "ospa": float(o), "ospa_loc": float(loc), "ospa_cn": float(cn),
        "n_true": int(observed.sum()), "n_est": len(est_map),
        "steps_per_s": res["steps_per_s"], "n_eff": res["n_eff"],
        "run": res,
    }
    if not follow_trajectory:
        est = res["est_poses"][:, :3]
        err = np.linalg.norm(est - traj[:len(est), :3], axis=1)
        out["pose_err"] = err
        out["mean_pose_err"] = float(err.mean())
        out["final_pose_err"] = float(err[-1])
    return out
