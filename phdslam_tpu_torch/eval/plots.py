"""Result plots (a copy of ``phdslam_tpu/eval/plots.py``): error curves
over a Monte-Carlo batch, the SLAM view (map with 3-sigma covariance
ellipses, trajectories, particles), the 4-panel replay frame (view,
particle scatter, particle weights, cardinality) written as PNG frames or
an animation, and the per-step particle-weight inspector.

Matplotlib (Agg). This module imports matplotlib; nothing else in the port
imports this module except the command line's ``--replay`` branch, so a
machine without matplotlib runs everything else.
"""

from __future__ import annotations

import os
from typing import Optional

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402


def cov_ellipse(mean, cov, n_sigma=3.0, n_points=32):
    """3-sigma ellipse polyline for a 2x2 covariance."""
    vals, vecs = np.linalg.eigh(cov[:2, :2])
    vals = np.maximum(vals, 0.0)
    t = np.linspace(0, 2 * np.pi, n_points)
    circle = np.stack([np.cos(t), np.sin(t)])
    pts = vecs @ (n_sigma * np.sqrt(vals)[:, None] * circle)
    return pts[0] + mean[0], pts[1] + mean[1]


def plot_errors(batch_result, out_path: str, title: str = ""):
    """Mean +/- std error curves over runs."""
    pe, ospa = batch_result.pose_err, batch_result.ospa
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    t = np.arange(pe.shape[1])
    m, s = np.nanmean(pe, axis=0), np.nanstd(pe, axis=0)
    axes[0].plot(t, m, lw=1.5)
    axes[0].fill_between(t, m - s, m + s, alpha=0.3)
    axes[0].set_xlabel("time step")
    axes[0].set_ylabel("XY pose error [m]")
    axes[0].set_title("trajectory error")
    ts = np.arange(ospa.shape[1])
    m, s = np.nanmean(ospa, axis=0), np.nanstd(ospa, axis=0)
    axes[1].plot(ts, m, lw=1.5, color="tab:orange")
    axes[1].fill_between(ts, m - s, m + s, alpha=0.3, color="tab:orange")
    axes[1].set_xlabel("sample")
    axes[1].set_ylabel("OSPA(p=1, c=5)")
    axes[1].set_title("map error")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_slam_snapshot(ax, est_pose, map_weights, map_means, map_covs=None,
                       true_traj=None, est_traj=None, landmarks=None,
                       particle_poses=None, min_weight=0.25):
    """One frame of the plotPhdSlam-style view."""
    if landmarks is not None:
        ax.plot(landmarks[:, 0], landmarks[:, 1], "k*", ms=8, mew=0.5,
                label="true landmarks", alpha=0.6)
    if true_traj is not None:
        ax.plot(true_traj[:, 0], true_traj[:, 1], "k-", lw=1,
                label="true trajectory", alpha=0.6)
    if est_traj is not None:
        ax.plot(est_traj[:, 0], est_traj[:, 1], "b-", lw=1.2,
                label="estimated trajectory")
    if particle_poses is not None:
        ax.plot(particle_poses[:, 0], particle_poses[:, 1], ".",
                color="tab:green", ms=2, alpha=0.4, label="particles")
    live = map_weights > min_weight
    ax.plot(map_means[live, 0], map_means[live, 1], "r+", ms=8, mew=1.5,
            label="map estimate")
    if map_covs is not None:
        for i in np.flatnonzero(live):
            ex, ey = cov_ellipse(map_means[i], map_covs[i])
            ax.plot(ex, ey, "r-", lw=0.5, alpha=0.5)
    ax.plot([est_pose[0]], [est_pose[1]], "b^", ms=10, label="vehicle")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=7)


def plot_run(res: dict, out_path: str, gt: Optional[dict] = None,
             step: int = -1):
    """Final-state SLAM plot from a runner result dict
    (one frame of the SLAM view)."""
    fig, ax = plt.subplots(figsize=(7, 7))
    est_traj = res["est_poses"][:, :2]
    k = step if step >= 0 else len(est_traj) - 1
    plot_slam_snapshot(
        ax,
        est_pose=res["est_poses"][k],
        map_weights=res["map_weights"][k] if "map_weights" in res
        else np.zeros(1),
        map_means=res["map_means"][k] if "map_means" in res
        else np.zeros((1, 2)),
        map_covs=res.get("map_covs", [None] * (k + 1))[k]
        if "map_covs" in res else None,
        true_traj=gt.get("traj")[:, :2] if gt else None,
        landmarks=gt.get("landmarks") if gt else None,
        est_traj=est_traj[: k + 1],
        particle_poses=res["poses"][k] if "poses" in res else None)
    ax.set_title(f"step {k}")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_replay_frame(fig, res: dict, k: int, gt: Optional[dict] = None,
                      dynamic: Optional[dict] = None):
    """One 4-panel replay frame, the reference's replay layout: main SLAM
    view | particle scatter |
    particle weights | cardinality distribution."""
    import matplotlib.gridspec as gridspec
    fig.clf()
    gs = gridspec.GridSpec(2, 4, figure=fig)
    ax = fig.add_subplot(gs[:, 0:2])
    plot_slam_snapshot(
        ax,
        est_pose=res["est_poses"][k],
        map_weights=(res["map_weights"][k] if "map_weights" in res
                     else np.zeros(1)),
        map_means=(res["map_means"][k] if "map_means" in res
                   else np.zeros((1, 2))),
        map_covs=res["map_covs"][k] if "map_covs" in res else None,
        true_traj=gt.get("traj")[:, :2] if gt else None,
        landmarks=gt.get("landmarks") if gt else None,
        est_traj=res["est_poses"][: k + 1, :2],
        particle_poses=res["poses"][k] if "poses" in res else None)
    if dynamic is not None:   # mixed model: dynamic map as open circles
        dw, dm = dynamic["weights"][k], dynamic["means"][k]
        live = dw > 0.25
        ax.plot(dm[live, 0], dm[live, 1], "mo", ms=8, mfc="none",
                label="dynamic est")
    ax.set_title(f"step {k}")

    # particle scatterplot (zoomed)
    axp = fig.add_subplot(gs[0, 2])
    if "poses" in res:
        pp = res["poses"][k]
        axp.plot(pp[:, 0], pp[:, 1], ".", ms=2, color="tab:blue")
        axp.plot([res["est_poses"][k][0]], [res["est_poses"][k][1]], "rd")
    axp.set_title("particles", fontsize=8)
    axp.tick_params(labelsize=6)

    # particle weights (semilogy)
    axw = fig.add_subplot(gs[0, 3])
    if "log_weights" in res:
        w = np.exp(np.asarray(res["log_weights"][k], np.float64))
        axw.semilogy(np.maximum(w, 1e-30), ".", ms=2)
    axw.set_title("particle weights", fontsize=8)
    axw.tick_params(labelsize=6)

    # cardinality distribution
    axc = fig.add_subplot(gs[1, 2:])
    cn = res.get("cardinalities")
    if cn is not None and np.asarray(cn[k]).size > 1:
        p = np.exp(np.asarray(cn[k], np.float64))
        p = np.where(np.isfinite(p), p, 0.0)
        axc.bar(np.arange(len(p)), p, width=0.9)
        exp_n = float(np.nansum(p * np.arange(len(p))))
        axc.set_xlim(-0.5, min(len(p), 4 * max(1.0, exp_n)))
        axc.set_title("cardinality distribution", fontsize=8)
    elif "map_weights" in res:
        axc.bar([0], [float(np.sum(res["map_weights"][k]))])
        axc.set_title("expected cardinality (sum w)", fontsize=8)
    axc.tick_params(labelsize=6)


def animate_run(res: dict, out_dir: str, gt: Optional[dict] = None,
                every: int = 10, fmt: str = "png", fps: int = 5,
                dynamic: Optional[dict] = None):
    """Replay artifact (the reference's animation, offline):
    ``fmt="png"`` writes per-frame 4-panel PNGs; ``fmt="gif"``/``"mp4"``
    writes one animated file and returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    frames = range(0, len(res["est_poses"]), every)
    if fmt == "png":
        paths = []
        for k in frames:
            fig = plt.figure(figsize=(12, 6))
            plot_replay_frame(fig, res, k, gt=gt, dynamic=dynamic)
            p = os.path.join(out_dir, f"frame{k:05d}.png")
            fig.savefig(p, dpi=100)
            plt.close(fig)
            paths.append(p)
        return paths
    from matplotlib import animation
    fig = plt.figure(figsize=(12, 6))
    writer = (animation.PillowWriter(fps=fps) if fmt == "gif"
              else animation.FFMpegWriter(fps=fps))
    out_path = os.path.join(out_dir, f"replay.{fmt}")
    with writer.saving(fig, out_path, dpi=80):
        for k in frames:
            plot_replay_frame(fig, res, k, gt=gt, dynamic=dynamic)
            writer.grab_frame()
    plt.close(fig)
    return out_path


def plot_weight_inspector(log_weights, out_path: str, steps=None):
    """Per-step particle-weight inspection.

    ``log_weights`` [T, P]. Writes a two-panel figure: a log10-weight
    heatmap over (step, particle) and semilogy overlays of selected
    steps."""
    lw = np.asarray(log_weights, np.float64)
    T, P = lw.shape
    if steps is None:
        steps = [0, T // 4, T // 2, 3 * T // 4, T - 1]
    fig, axes = plt.subplots(1, 2, figsize=(12, 4.5))
    im = axes[0].imshow(lw / np.log(10.0), aspect="auto",
                        origin="lower", cmap="viridis",
                        interpolation="nearest")
    axes[0].set_xlabel("particle")
    axes[0].set_ylabel("step")
    axes[0].set_title("log10 particle weights")
    fig.colorbar(im, ax=axes[0], shrink=0.9)
    for s in steps:
        s = int(np.clip(s, 0, T - 1))
        axes[1].semilogy(np.maximum(np.exp(lw[s]), 1e-30), ".", ms=3,
                         label=f"step {s}")
    axes[1].set_xlabel("particle")
    axes[1].set_ylabel("weight")
    axes[1].set_title("per-step weights (examineWeights view)")
    axes[1].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
