"""Monte-Carlo batch validation (port of ``phdslam_tpu/eval/batch.py``).

Generates a ground truth and N noisy input sets, runs the filter over each
set in-process and scores every run's per-step XY pose error and
OSPA(p=1, c=5) of the MAP map against the ground truth, aggregated as
mean and standard deviation over runs. A run whose weights turn NaN
(``nan_step``) scores NaN from that step on, and the summary's nanmeans
leave those steps out, as the JAX version's do. The text-log half
(``parse_state_log``, ``analyze_log_dir``) scores a directory of
``state_estimateXXXXX.log`` files, such as the command line writes.

    python -m phdslam_tpu_torch.eval.batch <config.cfg> <data_root> \
        [--generate N_RUNS] [--runs N] [--steps T] [--motion ackerman|cv]
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config import SlamConfig
from ..slam import SynthSLAMRunner
from . import simdata
from .ospa import extract_map_estimate, ospa_distance


@dataclass
class BatchResult:
    pose_err: np.ndarray      # [R, T] per-run per-step XY error
    ospa: np.ndarray          # [R, S] per-run sampled OSPA
    n_eff: np.ndarray         # [R, T]
    steps_per_s: np.ndarray   # [R]

    def summary(self) -> dict:
        return {
            "mean_pose_err": float(np.nanmean(self.pose_err)),
            "std_pose_err": float(np.nanstd(np.nanmean(self.pose_err,
                                                       axis=1))),
            "final_pose_err": float(np.nanmean(self.pose_err[:, -1])),
            "mean_ospa": float(np.nanmean(self.ospa)),
            "std_ospa": float(np.nanstd(np.nanmean(self.ospa, axis=1))),
            "final_ospa": float(np.nanmean(self.ospa[:, -1])),
            "mean_steps_per_s": float(np.mean(self.steps_per_s)),
            "n_runs": int(len(self.pose_err)),
        }


def generate_batch_datasets(out_root: str, n_runs: int = 10,
                            n_landmarks: int = 40, n_steps: int = 150,
                            dt: float = 0.1, seed: int = 0,
                            sp: Optional[simdata.SensorParams] = None,
                            mp: Optional[simdata.AckermanParams] = None,
                            motion: str = "ackerman"):
    """Write ``groundtruth.npz`` and N Monte-Carlo input dirs
    ``run000``, ``run001``, ... under ``out_root``. Returns the ground
    truth's path.

    ``motion``: "ackerman" (controls + measurements per run) or "cv"
    (constant-velocity vehicle, measurements only).
    """
    sp = sp or simdata.SensorParams()
    mp = mp or simdata.AckermanParams()
    if motion == "cv":
        landmarks, traj = simdata.generate_world_cv(
            n_landmarks=n_landmarks, n_steps=n_steps, dt=dt, seed=seed)
        controls = np.zeros((0, 2))
    else:
        landmarks, traj, controls = simdata.generate_world(
            n_landmarks=n_landmarks, n_steps=n_steps, dt=dt, seed=seed,
            mp=mp)
    # order landmarks by first observation so landmarks[:cum[t]] is the true
    # map at step t (each step is scored against the map seen so far)
    first_seen = np.full(len(landmarks), n_steps)
    for t in range(n_steps - 1, -1, -1):
        d = np.linalg.norm(landmarks - traj[t, :2], axis=1)
        first_seen[d <= sp.max_range] = t
    order = np.argsort(first_seen, kind="stable")
    landmarks = landmarks[order]
    cum = np.searchsorted(first_seen[order], np.arange(n_steps),
                          side="right")
    os.makedirs(out_root, exist_ok=True)
    gt_path = os.path.join(out_root, "groundtruth.npz")
    np.savez(gt_path, landmarks=landmarks, traj=traj, controls=controls,
             cumulative_counts=cum)
    for r in range(n_runs):
        run_dir = os.path.join(out_root, f"run{r:03d}")
        if motion == "cv":
            rng = np.random.default_rng(seed + 1000 + r)
            measurements = [simdata.noisy_measurements(traj[t], landmarks,
                                                       sp, rng)
                            for t in range(len(traj))]
            os.makedirs(run_dir, exist_ok=True)
            with open(os.path.join(run_dir, "measurements.txt"), "w") as fh:
                fh.write("% measurements, one step per line, "
                         "range/bearing pairs\n")
                for Z in measurements:
                    fh.write(" ".join("%g %g" % (z[0], z[1]) for z in Z)
                             + " \n")
        else:
            noisy_controls, measurements = simdata.generate_run(
                landmarks, traj, controls, sp, mp, seed=seed + 1000 + r)
            simdata.write_run_dir(run_dir, noisy_controls, measurements)
    return gt_path


def run_batch(cfg: SlamConfig, data_root: str, n_runs: Optional[int] = None,
              ospa_every: int = 1, verbose: bool = False,
              device="cuda") -> BatchResult:
    """Run the filter over every run directory under ``data_root`` and score
    it against ``groundtruth.npz``.

    OSPA is scored on every step by default; raise ``ospa_every`` to
    subsample. Steps from a run's nan_step on score NaN."""
    gt = np.load(os.path.join(data_root, "groundtruth.npz"))
    traj, landmarks = gt["traj"], gt["landmarks"]
    cum = (gt["cumulative_counts"] if "cumulative_counts" in gt.files
           else np.full(len(traj), len(landmarks)))
    run_dirs = sorted(d for d in os.listdir(data_root)
                      if d.startswith("run"))
    if n_runs:
        run_dirs = run_dirs[:n_runs]

    all_pe, all_ospa, all_neff, all_sps = [], [], [], []
    for rd in run_dirs:
        runner = SynthSLAMRunner(cfg, os.path.join(data_root, rd),
                                 device=device)
        res = runner.run(collect_maps=True)
        est = res["est_poses"]
        T = min(len(est), len(traj))
        bad = res["nan_step"] if res["nan_step"] is not None else T
        pe = np.linalg.norm(est[:T, :2] - traj[:T, :2], axis=1)
        pe[bad:] = np.nan
        ospas = []
        for k in range(0, T, ospa_every):
            if k >= bad:
                ospas.append(float("nan"))
                continue
            est_map = extract_map_estimate(res["map_weights"][k],
                                           res["map_means"][k])
            true_map = landmarks[:cum[min(k, len(cum) - 1)]]
            o, _, _ = ospa_distance(true_map, est_map, p=1, c=5)
            ospas.append(o)
        all_pe.append(pe)
        all_ospa.append(ospas)
        all_neff.append(res["n_eff"][:T])
        all_sps.append(res["steps_per_s"])
        if verbose:
            print(f"{rd}: mean_pose_err={np.nanmean(pe):.3f} "
                  f"mean_ospa={np.nanmean(ospas):.3f} "
                  f"{res['steps_per_s']:.1f} steps/s")

    L = min(map(len, all_pe))
    S = min(map(len, all_ospa))
    return BatchResult(
        pose_err=np.asarray([p[:L] for p in all_pe]),
        ospa=np.asarray([o[:S] for o in all_ospa]),
        n_eff=np.asarray([n[:L] for n in all_neff]),
        steps_per_s=np.asarray(all_sps))


# ----------------------------------------------------------------------------
# Log-file analysis: scores the state_estimateXXXXX.log text format instead
# of in-memory results.
# ----------------------------------------------------------------------------

def parse_state_log(path: str) -> dict:
    """Parse one state_estimateXXXXX.log (6/7-line format).

    Returns dict with est_pose, static map (w, mean) arrays, particle log
    weights and nEff. The map estimate is the round(sum w) heaviest
    features.
    """
    with open(path) as fh:
        lines = fh.read().splitlines()
    pose = np.fromstring(lines[0], sep=" ")
    static = np.fromstring(lines[1], sep=" ") if len(lines) > 1 else np.empty(0)
    w = static[0::7]
    mx = static[1::7]
    my = static[2::7]
    means = np.column_stack([mx, my]) if w.size else np.zeros((0, 2))
    log_w = np.fromstring(lines[3], sep=" ") if len(lines) > 3 else np.empty(0)
    n_eff = (1.0 / np.sum(np.exp(log_w) ** 2) / max(1, len(log_w))
             if log_w.size else float("nan"))
    if w.size:
        n_est = int(round(w.sum()))
        order = np.argsort(w)[::-1]
        est_map = means[order[:n_est]]
    else:
        est_map = means
    return {"est_pose": pose[:3], "map_weights": w, "map_means": means,
            "est_map": est_map, "log_weights": log_w, "n_eff": n_eff}


def analyze_log_dir(log_dir: str, true_traj, landmarks,
                    ospa_every: int = 10) -> dict:
    """Score a directory of state logs against ground truth: the XY error
    of every log's pose at its step, and OSPA(1, 5) of every
    ``ospa_every``-th log's map against all the landmarks."""
    files = sorted(f for f in os.listdir(log_dir)
                   if f.startswith("state_estimate"))
    pose_err, ospas, n_effs = [], [], []
    for i, f in enumerate(files):
        rec = parse_state_log(os.path.join(log_dir, f))
        k = int(f[len("state_estimate"):-len(".log")])
        if k < len(true_traj):
            pose_err.append(float(np.linalg.norm(
                rec["est_pose"][:2] - true_traj[k, :2])))
        if i % ospa_every == 0:
            o, loc, cn = ospa_distance(landmarks, rec["est_map"], p=1, c=5)
            ospas.append(o)
        n_effs.append(rec["n_eff"])
    return {"pose_err": np.asarray(pose_err), "ospa": np.asarray(ospas),
            "n_eff": np.asarray(n_effs),
            "mean_pose_err": float(np.mean(pose_err)) if pose_err else
            float("nan"),
            "mean_ospa": float(np.mean(ospas)) if ospas else float("nan")}


if __name__ == "__main__":
    import argparse

    from ..config import load_config

    ap = argparse.ArgumentParser(prog="phdslam_tpu_torch.eval.batch")
    ap.add_argument("config")
    ap.add_argument("data_root")
    ap.add_argument("--generate", type=int, metavar="N_RUNS", default=0)
    ap.add_argument("--runs", type=int, default=None)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--motion", choices=("ackerman", "cv"),
                    default="ackerman")
    args = ap.parse_args()
    cfg = load_config(args.config)
    if args.generate:
        generate_batch_datasets(args.data_root, n_runs=args.generate,
                                n_steps=args.steps, motion=args.motion)
    res = run_batch(cfg, args.data_root, n_runs=args.runs, verbose=True)
    print(res.summary())
