"""Monocular SC-PHD SLAM in disparity space (port of
``phdslam_tpu/filters/disparity.py``).

Every particle carries a 6-DOF camera pose and, per feature slot, a cloud
of N world points with a linear feature weight (:class:`DisparityState`).
One step predicts the camera (constant velocity in 6 DOF); on a step with
measurements it then transforms each cloud to disparity space (u, v, d),
fits a Gaussian to it, updates the in-range Gaussians with a linear EKF
in (u, v, d) under the SC-PHD normalizer, adds births at the disparity
prior, merges the candidates (the merge3d kernel), draws fresh clouds from
the merged Gaussians, reflects them off ``min_disparity``, transforms them
back to the world and recombines them with the out-of-range clouds. The
particle weights are normalized, the particles resampled (before
extraction, unlike the range-bearing step) and the MAP particle extracted.

The JAX version vmaps a per-particle pre-half and post-half around a batch
merge; here every function carries the particle axis explicitly. Random
draws are inputs (:class:`DisparityNoise`), so a test can replay the JAX
version's keys.

Merge routing: when the candidate cap binds (0 < cap < K + M K + M) the
JAX version compacts the candidates to the top cap by weight and runs its
3D kernel on weight-sorted lanes; otherwise it runs the kernel's argmax
mode over every lane. Both are the same exact greedy (heaviest first, ties
to the lowest lane), so the port always hands merge3d weight-sorted lanes:
it compacts when the cap binds and only sorts when it does not. With the
Hellinger distance (distance_metric 1) the JAX version runs XLA's
``gm_merge`` (no Pallas kernel has that metric at D = 3); the port runs
merge3d's Hellinger variant on the same sorted lanes, which is XLA's
contract (``ops/gm_merge.py``). Every particle_weighting but 0 is Vo's
empty-map weighting, as in the JAX version.

Profiler ranges (``disp.predict``, ``disp.pre``, ``disp.compact``,
``disp.merge``, ``disp.post``, ``disp.resample_extract``) mark the layers
for ``torch.profiler``. Which branches run (predict, update) is decided on
the host; the resampling decision stays on the device. On a particle
mesh (``mesh``, ``parallel/sharding.py``) the state is this rank's block:
the normaliser, nEff, the ancestry, the expected pose and the MAP row go
through the mesh's collectives, and a resampling step (read on the host)
migrates the rows, the cloud leaf [P, K, N, 3] with them
(``parallel/migrate.py``; the JAX version's ``_gather_disparity_sharded``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import SlamConfig
from ..kernels.merge import merge3d
from ..ops.gm_merge import (compact_candidates, merge_out, pack_planes,
                            sort_candidates)
from ..ops.math import LOG0, chol3, logsumexp, safe_log, sym, wrap_angle
from ..ops.resample import (effective_sample_ratio, every_particle,
                            max_over_particles, particle_row,
                            particle_scalars, systematic_ancestors)
from ..runtime import profiling
from ..types import DisparityState


class DisparityNoise(NamedTuple):
    """The random draws of one step (all standard normal but the last)."""
    eps_pred: torch.Tensor      # [P, 6] camera accelerations
    eps_sample: torch.Tensor    # [P, K, N, 3] cloud resampling
    u_resample: torch.Tensor    # [P] uniform in [0, 1)


class DisparityOutputs(NamedTuple):
    expected_pose: torch.Tensor   # [12]
    map_cloud: torch.Tensor       # [K, N, 3] MAP particle's clouds
    map_weight: torch.Tensor      # [K]
    n_eff: torch.Tensor           # scalar normalized nEff
    resampled: torch.Tensor       # bool scalar
    overflow: torch.Tensor        # candidates and clusters dropped by caps


def check_supported(cfg: SlamConfig, K: int, M: int) -> None:
    """Raise for a value the JAX package does not define: a cloud of no
    points. A cloud of one point runs as there: its sample covariance
    divides by N - 1 = 0, the fitted covariances are NaN, the particle
    weights turn NaN on the first update with a live feature and the NaN
    policy reports that step. No merge width is refused: above merge3d's
    narrow 2048 lanes the staged wide-lane variant runs."""
    if cfg.particles_per_feature < 1:
        raise NotImplementedError(
            "configuration outside the ported disparity path: "
            f"particles_per_feature={cfg.particles_per_feature} "
            "(the JAX package defines clouds of 1 or more points)")


# ----------------------------------------------------------------------------
# Camera geometry
# ----------------------------------------------------------------------------

def camera_rotation(roll, pitch, yaw):
    """R such that world = R @ camera (+ translation); [..., 3, 3]."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    r00 = cp * cy
    r01 = cr * sy + sr * sp * cy
    r02 = sr * sy - cr * sp * cy
    r10 = -cp * sy
    r11 = cr * cy - sr * sp * sy
    r12 = sr * cy + cr * sp * sy
    r20 = sp
    r21 = -sr * cp
    r22 = cr * cp
    return torch.stack([
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1)], dim=-2)


def world_to_disparity(points, cam_pose, cfg: SlamConfig):
    """World xyz [..., 3] -> (u, v, d) [..., 3] for cam_pose [..., >= 6]
    (px, py, pz, roll, pitch, yaw, ...), broadcast against the points. The
    camera depth is kept at least 1e-6 away from 0."""
    R = camera_rotation(cam_pose[..., 3], cam_pose[..., 4], cam_pose[..., 5])
    pc = torch.einsum("...ji,...j->...i", R, points - cam_pose[..., :3])
    zc = pc[..., 2]
    zc_safe = torch.where(torch.abs(zc) > 1e-6, zc,
                          torch.where(zc < 0, -1e-6, 1e-6))
    u = cfg.u0 - cfg.fx * pc[..., 0] / zc_safe
    v = cfg.v0 - cfg.fy * pc[..., 1] / zc_safe
    d = -cfg.fx / zc_safe
    return torch.stack([u, v, d], dim=-1)


def disparity_to_world(uvd, cam_pose, cfg: SlamConfig):
    """(u, v, d) [..., 3] -> world xyz; the disparity is kept at least
    1e-9 away from 0."""
    u, v, d = uvd[..., 0], uvd[..., 1], uvd[..., 2]
    d_safe = torch.where(torch.abs(d) > 1e-9, d,
                         torch.where(d < 0, -1e-9, 1e-9))
    xc = (u - cfg.u0) / d_safe
    yc = cfg.fx / cfg.fy * (v - cfg.v0) / d_safe
    zc = -cfg.fx / d_safe
    pc = torch.stack([xc, yc, zc], dim=-1)
    R = camera_rotation(cam_pose[..., 3], cam_pose[..., 4], cam_pose[..., 5])
    return torch.einsum("...ij,...j->...i", R, pc) + cam_pose[..., :3]


# ----------------------------------------------------------------------------
# State and prediction
# ----------------------------------------------------------------------------

def init_disparity_state(cfg: SlamConfig, eps_jitter, device=None
                         ) -> DisparityState:
    """All particles at the configured camera pose with roll and yaw
    jittered by 0.03 * eps_jitter [P, 2] (standard normal draws), and
    empty maps. As in the JAX version, the yaw is jittered around yaw0
    (the reference seeds it from the pitch)."""
    device = eps_jitter.device if device is None else device
    P = eps_jitter.shape[0]
    K, N = cfg.max_features, cfg.particles_per_feature
    pose0 = torch.tensor([cfg.x0, cfg.y0, cfg.z0, cfg.roll0, cfg.pitch0,
                          cfg.yaw0, cfg.vx0, cfg.vy0, cfg.vz0, cfg.vroll0,
                          cfg.vpitch0, cfg.vyaw0], dtype=torch.float32,
                         device=device)
    pose = pose0.expand(P, 12).clone()
    jitter = 0.03 * eps_jitter.to(device)
    pose[:, 3] += jitter[:, 0]
    pose[:, 5] += jitter[:, 1]
    log_p = torch.log(torch.tensor(float(P), dtype=torch.float32,
                                   device=device))
    return DisparityState(
        cam_pose=pose,
        log_weight=(-log_p).expand(P).clone(),
        cloud=torch.zeros((P, K, N, 3), dtype=torch.float32, device=device),
        feat_weight=torch.zeros((P, K), dtype=torch.float32, device=device),
        resample_idx=torch.arange(P, dtype=torch.int32, device=device),
        step=0)


def disparity_predict(state: DisparityState, dt, cfg: SlamConfig, eps
                      ) -> DisparityState:
    """6-DOF constant-velocity camera prediction with accelerations
    eps [P, 6] x (ax, ay, az, aroll, apitch, ayaw): the translation
    increment is taken in the camera frame and rotated into the world."""
    pose = state.cam_pose
    dt32 = np.float32(dt)
    dt, dt2 = float(dt32), float(dt32 * dt32)
    noise = eps * torch.tensor([cfg.ax, cfg.ay, cfg.az, cfg.aroll,
                                cfg.apitch, cfg.ayaw], dtype=pose.dtype,
                               device=pose.device)
    d_cam = dt * pose[:, 6:9] + 0.5 * noise[:, :3] * dt2
    R = camera_rotation(pose[:, 3], pose[:, 4], pose[:, 5])
    d_world = torch.einsum("pij,pj->pi", R, d_cam)
    new_xyz = pose[:, :3] + d_world
    new_ang = wrap_angle(
        pose[:, 3:6] + dt * pose[:, 9:12] + 0.5 * noise[:, 3:] * dt2)
    new_vel = pose[:, 6:9] + dt * noise[:, :3]
    new_angvel = pose[:, 9:12] + dt * noise[:, 3:]
    return state.replace(cam_pose=torch.cat(
        [new_xyz, new_ang, new_vel, new_angvel], dim=-1))


# ----------------------------------------------------------------------------
# Gaussian fit / sample
# ----------------------------------------------------------------------------

def fit_gaussians(uvd):
    """Moment-match a Gaussian to each cloud: uvd [..., N, 3] ->
    (mean [..., 3], cov [..., 3, 3]) with the 1/(N-1) covariance."""
    N = uvd.shape[-2]
    mean = torch.mean(uvd, dim=-2)
    d = uvd - mean[..., None, :]
    cov = torch.einsum("...ni,...nj->...ij", d, d) / (N - 1)
    return mean, cov


def sample_gaussians(mean, cov, eps):
    """Points mean + L eps from each Gaussian (mean [..., 3], cov
    [..., 3, 3], eps [..., n, 3] standard normal; L = chol3(cov))."""
    L = chol3(cov)
    return mean[..., None, :] + torch.einsum("...ij,...nj->...ni", L, eps)


# ----------------------------------------------------------------------------
# Measurement update
# ----------------------------------------------------------------------------

def _disparity_update_pre(cam_pose, cloud, feat_w, z, z_mask,
                          cfg: SlamConfig):
    """Pre-merge half for all particles: world -> disparity, the Gaussian
    fit, the in-range mask on the fitted mean, the linear EKF in (u, v, d)
    (H = [I2 | 0]), the log-domain normalizer over [M, K + 2] (detections,
    clutter, birth), births at the disparity prior and the particle-weight
    increment. Returns dict(cand=(mean [P, L, 3], cov [P, L, 3, 3],
    w [P, L], act [P, L]) over the L = K + M K + M lanes
    [persistent | detections (m-major) | births], dlog_w [P], out_m [P, K])."""
    P, K, N, _ = cloud.shape
    M = z.shape[0]
    dtype, dev = cloud.dtype, cloud.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    uvd = world_to_disparity(cloud, cam_pose[:, None, None, :], cfg)
    g_mean, g_cov = fit_gaussians(uvd)                   # [P, K, 3], [.., 3]

    live = feat_w > 0
    u, v, d = g_mean[..., 0], g_mean[..., 1], g_mean[..., 2]
    in_m = live & (u > 0) & (u <= cfg.image_width) & (v >= 0) \
        & (v <= cfg.image_height) & (d >= 0)
    out_m = live & ~in_m

    g_cov = torch.where(in_m[..., None, None], sym(g_cov), eye3)
    g_mean = torch.where(in_m[..., None], g_mean, 0.0)

    var_u = cfg.std_u ** 2
    var_v = cfg.std_v ** 2
    R2 = torch.tensor([[var_u, 0.0], [0.0, var_v]], dtype=dtype, device=dev)
    S = g_cov[..., :2, :2] + R2
    det_S = S[..., 0, 0] * S[..., 1, 1] - S[..., 0, 1] * S[..., 1, 0]
    S_inv = torch.stack(
        [torch.stack([S[..., 1, 1], -S[..., 0, 1]], dim=-1),
         torch.stack([-S[..., 1, 0], S[..., 0, 0]], dim=-1)],
        dim=-2) / det_S[..., None, None]
    PHt = g_cov[..., :, :2]                              # H = [I2 | 0]
    gain = torch.einsum("pkij,pkjl->pkil", PHt, S_inv)   # [P, K, 3, 2]
    IKH = eye3 - torch.nn.functional.pad(gain, (0, 1))
    cov_upd = torch.einsum("pkij,pkjl,pkml->pkim", IKH, g_cov, IKH) \
        + torch.einsum("pkij,jl,pkml->pkim", gain, R2, gain)

    pd = torch.where(in_m, cfg.pd, 0.0)
    innov = z[None, :, None, :] - g_mean[:, None, :, :2]       # [P, M, K, 2]
    mean_det = g_mean[:, None] + torch.einsum("pkij,pmkj->pmki", gain,
                                              innov)            # [P, M, K, 3]
    dist = torch.einsum("pmki,pkij,pmkj->pmk", innov, S_inv, innov)
    logw_part = safe_log(pd)[:, None, :] + safe_log(feat_w)[:, None, :] \
        - 0.5 * dist - math.log(2.0 * math.pi) \
        - 0.5 * safe_log(det_S)[:, None, :]
    det_valid = z_mask[None, :, None] & in_m[:, None, :]       # [P, M, K]
    logw_part = torch.where(det_valid, logw_part, LOG0)

    # clutter density over the image
    clutter_density = cfg.clutter_rate / (cfg.image_width * cfg.image_height)
    log_cd = safe_log(torch.tensor(clutter_density, dtype=dtype, device=dev))
    log_bw = safe_log(torch.tensor(cfg.birth_weight, dtype=dtype,
                                   device=dev))
    all_logw = torch.cat([logw_part, log_cd.expand(P, M, 1),
                          log_bw.expand(P, M, 1)], dim=2)
    mmax = torch.amax(all_logw, dim=2, keepdim=True)
    log_norm = mmax.squeeze(2) + torch.log(
        torch.sum(torch.exp(all_logw - mmax), dim=2))          # [P, M]

    w_nd = torch.where(in_m, feat_w * (1.0 - pd), 0.0)
    w_det = torch.where(det_valid, torch.exp(logw_part - log_norm[..., None]),
                        0.0)

    # births at the disparity prior
    b_mean = torch.cat([z, torch.full((M, 1), cfg.disparity_birth,
                                      dtype=dtype, device=dev)], dim=-1)
    b_cov = torch.diag(torch.tensor([var_u, var_v, cfg.std_d_birth ** 2],
                                    dtype=dtype, device=dev))
    w_birth = torch.where(z_mask, torch.exp(log_bw - log_norm), 0.0)

    n_valid_z = z_mask.to(dtype).sum()
    if cfg.particle_weighting == 0:
        card_pred = torch.where(in_m, pd * feat_w, 0.0).sum(dim=1) \
            + n_valid_z * cfg.birth_weight
        dlog_w = torch.where(z_mask, log_norm, 0.0).sum(dim=1) - card_pred
    else:
        cn_predict = torch.where(in_m, feat_w, 0.0).sum(dim=1)
        cn_update = w_nd.sum(dim=1) + w_det.sum(dim=(1, 2)) \
            + w_birth.sum(dim=1)
        dlog_w = n_valid_z * clutter_density + cn_update - cn_predict \
            - cfg.clutter_rate

    min_fw = cfg.min_feature_weight
    act_a = in_m & (w_nd >= min_fw)
    act_b = det_valid & (w_det >= min_fw)
    act_c = z_mask & (w_birth >= min_fw)

    cand_mean = torch.cat([g_mean, mean_det.reshape(P, M * K, 3),
                           b_mean.expand(P, M, 3)], dim=1)
    cand_cov = torch.cat([g_cov, cov_upd[:, None].expand(P, M, K, 3, 3)
                          .reshape(P, M * K, 3, 3),
                          b_cov.expand(P, M, 3, 3)], dim=1)
    cand_w = torch.cat([w_nd, w_det.reshape(P, M * K), w_birth], dim=1)
    cand_act = torch.cat([act_a, act_b.reshape(P, M * K), act_c], dim=1)

    cand_mean = torch.where(cand_act[..., None], cand_mean, 0.0)
    cand_cov = torch.where(cand_act[..., None, None], cand_cov, eye3)
    cand_w = torch.where(cand_act, cand_w, 0.0)
    return dict(cand=(cand_mean, cand_cov, cand_w, cand_act), dlog_w=dlog_w,
                out_m=out_m)


def order_candidates(cand, cap):
    """Weight-descending candidate lanes for merge3d: the top ``cap`` when
    the cap binds (``compact_candidates``), else every lane sorted.
    Returns (mean, cov, w, act, n_compact [P])."""
    mean, cov, w, act = cand
    if 0 < cap < mean.shape[1]:
        return compact_candidates(mean, cov, w, act, cap)
    n_compact = torch.zeros((mean.shape[0],), dtype=torch.int64,
                            device=mean.device)
    return (*sort_candidates(mean, cov, w, act), n_compact)


def _disparity_update_post(mg, pre, cam_pose, cloud, feat_w, eps_sample,
                           cfg: SlamConfig):
    """Post-merge half for all particles: draw fresh clouds from the merged
    Gaussians (eps_sample [P, K, N, 3]), reflect them off the
    ``min_disparity`` floor, transform them to the world, and keep the K
    heaviest of [merged | out-of-range] features (one stable sort; ties to
    the lowest slot, as lax.top_k). ``pre`` holds out_m, dlog_w and
    n_compact. Returns (new_cloud, new_w, dlog_w, overflow [P])."""
    P, K, N, _ = cloud.shape
    mg_mean, mg_cov, mg_w, _, n_dropped = mg

    new_uvd = sample_gaussians(mg_mean, mg_cov, eps_sample)    # [P, K, N, 3]
    # reflect (not clamp) below-floor samples: see SlamConfig.min_disparity
    d_refl = cfg.min_disparity + torch.abs(new_uvd[..., 2]
                                           - cfg.min_disparity)
    new_uvd = torch.cat([new_uvd[..., :2], d_refl[..., None]], dim=-1)
    new_cloud_in = disparity_to_world(new_uvd, cam_pose[:, None, None, :],
                                      cfg)

    all_cloud = torch.cat([new_cloud_in, cloud], dim=1)        # [P, 2K, N, 3]
    all_w = torch.cat([mg_w, torch.where(pre["out_m"], feat_w, 0.0)], dim=1)
    order = torch.sort(-all_w, dim=1, stable=True).indices[:, :K]
    rows = torch.arange(P, device=cloud.device)[:, None]
    new_w = all_w[rows, order]
    new_cloud = all_cloud[rows, order]
    keep = new_w > 0
    new_w = torch.where(keep, new_w, 0.0)
    new_cloud = torch.where(keep[..., None, None], new_cloud, 0.0)

    overflow = torch.clamp_min((all_w > 0).sum(dim=1) - K, 0) + n_dropped \
        + pre["n_compact"]
    return new_cloud, new_w, pre["dlog_w"], overflow


def disparity_update(state: DisparityState, z, z_mask, cfg: SlamConfig,
                     eps_sample, mesh=None):
    """SC-PHD update of every particle's clouds; returns (state with the
    new clouds, feature weights and normalized log weights, overflow)."""
    K, M = state.cloud.shape[1], z.shape[0]
    check_supported(cfg, K, M)
    with profiling.span("disp.pre"):
        pre = _disparity_update_pre(state.cam_pose, state.cloud,
                                    state.feat_weight, z, z_mask, cfg)
    with profiling.span("disp.compact"):
        *cand, n_compact = order_candidates(pre["cand"],
                                            cfg.merge_candidate_cap)
        planes = pack_planes(*cand)
    with profiling.span("disp.merge"):
        mg = merge_out(merge3d(planes, float(cfg.min_separation), K,
                               metric=cfg.distance_metric), 3)
    with profiling.span("disp.post"):
        new_cloud, new_w, dlog_w, overflow = _disparity_update_post(
            mg, dict(pre, n_compact=n_compact), state.cam_pose, state.cloud,
            state.feat_weight, eps_sample, cfg)
    state = state.replace(cloud=new_cloud, feat_weight=new_w,
                          log_weight=state.log_weight + dlog_w)
    return state, max_over_particles(overflow, mesh)


# ----------------------------------------------------------------------------
# Full step
# ----------------------------------------------------------------------------

def _resample(state: DisparityState, cfg: SlamConfig, u, mesh=None,
              log_weight=None):
    """Systematic resampling when nEff/N <= threshold (on every step, as
    the reference's disparity loop does). The decision stays on the
    device; on a ``mesh`` (``log_weight``: every particle's) the host
    reads it and a resampling step migrates the rows. Returns (state,
    n_eff, resampled)."""
    lw = state.log_weight if mesh is None else log_weight
    P = lw.shape[0]
    dev = state.cam_pose.device
    n_eff = effective_sample_ratio(lw)
    do_resample = n_eff <= cfg.resample_threshold
    ancestors = systematic_ancestors(lw, u, P)
    idx = torch.where(do_resample, ancestors,
                      torch.arange(P, dtype=torch.int64, device=dev))
    log_p = torch.log(torch.tensor(float(P), dtype=state.log_weight.dtype,
                                   device=dev))
    log_w = torch.where(do_resample, -log_p, state.log_weight)
    if mesh is None:
        state = state.replace(
            cam_pose=state.cam_pose[idx], cloud=state.cloud[idx],
            feat_weight=state.feat_weight[idx])
    else:
        with profiling.host_sync("resample"):
            resample = bool(do_resample)
        if resample:
            from ..parallel.migrate import gather_particles_sharded
            state = gather_particles_sharded(state, idx, mesh, cfg)
    rows = slice(None) if mesh is None else mesh.rows(P)
    state = state.replace(log_weight=log_w,
                          resample_idx=idx[rows].to(torch.int32))
    return state, n_eff, do_resample


def disparity_step(state: DisparityState, z, z_mask, dt, do_predict: bool,
                   cfg: SlamConfig, noise: DisparityNoise, has_z=None,
                   mesh=None, return_updated: bool = False):
    """One SC-PHD step: predict -> update -> normalize -> resample ->
    extract. ``z`` [M, 2] padded (u, v) measurements with ``z_mask`` [M];
    ``has_z`` (whether z_mask has any True) is read from the device when
    not given. On a particle ``mesh`` the state and ``noise`` are this
    rank's block and rows (``parallel/sharding.py::
    make_sharded_disparity_step_fn`` takes the global draws); the outputs
    come out the same on every rank. ``return_updated`` adds a third
    output: every particle's normalized log weights before resampling."""
    if has_z is None:
        with profiling.host_sync("has_z"):
            has_z = bool(z_mask.any())
    if do_predict:
        with profiling.span("disp.predict"):
            state = disparity_predict(state, dt, cfg, noise.eps_pred)
    overflow = torch.zeros((), dtype=torch.int64,
                           device=state.cam_pose.device)
    if has_z:
        state, overflow = disparity_update(state, z, z_mask, cfg,
                                           noise.eps_sample, mesh)
    with profiling.span("disp.resample_extract"):
        every = every_particle(state.log_weight, mesh)
        lse = logsumexp(every, dim=0)
        state = state.replace(log_weight=state.log_weight - lse)
        updated = every - lse
        state, n_eff, resampled = _resample(state, cfg, noise.u_resample,
                                            mesh, updated)
        state = state.replace(step=state.step + 1)
        log_w, cam_pose = particle_scalars(state.log_weight, state.cam_pose,
                                           mesh)
        map_cloud, map_weight = particle_row(
            torch.argmax(log_w), [state.cloud, state.feat_weight], mesh)
        out = DisparityOutputs(
            expected_pose=torch.exp(log_w) @ cam_pose, map_cloud=map_cloud,
            map_weight=map_weight, n_eff=n_eff, resampled=resampled,
            overflow=overflow)
    return (state, out, updated) if return_updated else (state, out)
