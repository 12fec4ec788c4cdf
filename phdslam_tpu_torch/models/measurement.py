"""Range-bearing measurement model (port of
``phdslam_tpu/models/measurement.py``).

All functions broadcast: ``pose[..., 6]`` against feature ``mean[..., D]``
(the filter passes pose as [P, 1, 6] against [P, K, D] maps).
"""

from __future__ import annotations

import torch

from ..ops.math import wrap_angle

# in-range classes
OUT_OF_RANGE = 0      # bypasses update AND merge
IN_RANGE = 1          # full update
NEARLY_IN_RANGE = 2   # bypasses update, participates in merge


def predict_measurement(pose, mean):
    """h(x): predicted (range, bearing) of feature ``mean[..., >=2]``.

    Returns (r, bearing, dx, dy, r2).
    """
    dx = mean[..., 0] - pose[..., 0]
    dy = mean[..., 1] - pose[..., 1]
    r2 = dx * dx + dy * dy
    r = torch.sqrt(r2)
    bearing = wrap_angle(torch.atan2(dy, dx) - pose[..., 2])
    return r, bearing, dx, dy, r2


def detection_probability(r, bearing, cfg):
    """Pd = pd * 1{r <= max_range, |bearing| <= max_bearing} (no min_range,
    as in the reference)."""
    in_fov = (r <= cfg.max_range) & (torch.abs(bearing) <= cfg.max_bearing)
    return torch.where(in_fov, cfg.pd, 0.0).to(r.dtype)


def classify_in_range(pose, mean, weight, cfg):
    """Per-feature in-range class.

    class 1: min_range <= r <= max_range and |b| <= max_bearing
    class 2: 0.8 min_range <= r <= 1.2 max_range and |b| <= 1.2 max_bearing
    class 0: otherwise. Empty slots (weight 0) are class 0.
    """
    r, bearing, _, _, _ = predict_measurement(pose, mean)
    ab = torch.abs(bearing)
    cls1 = (r >= cfg.min_range) & (r <= cfg.max_range) \
        & (ab <= cfg.max_bearing)
    cls2 = (~cls1) & (r >= 0.8 * cfg.min_range) \
        & (r <= 1.2 * cfg.max_range) & (ab <= 1.2 * cfg.max_bearing)
    cls = torch.where(cls1, IN_RANGE,
                      torch.where(cls2, NEARLY_IN_RANGE, OUT_OF_RANGE))
    return torch.where(weight > 0, cls, OUT_OF_RANGE)


def measurement_jacobian(dx, dy, r, r2):
    """Jacobian of (r, bearing) wrt feature (x, y): J[..., 2, 2] with rows
    (dr/dx, dr/dy), (db/dx, db/dy)."""
    row_r = torch.stack([dx / r, dy / r], dim=-1)
    row_b = torch.stack([-dy / r2, dx / r2], dim=-1)
    return torch.stack([row_r, row_b], dim=-2)


def birth_mean_cov(pose, z, cfg):
    """Inverse measurement -> birth Gaussian, 2D.

    z[..., 2] = (range, bearing). Returns (mean[..., 2], cov[..., 2, 2]),
    cov = J (R * birth_noise_factor^2) J' with J = [[dx/r, -dy], [dy/r, dx]].
    """
    rng = z[..., 0]
    theta = pose[..., 2] + z[..., 1]
    dx = rng * torch.cos(theta)
    dy = rng * torch.sin(theta)
    mean = torch.stack([pose[..., 0] + dx, pose[..., 1] + dy], dim=-1)

    # clamp |range| so padded (zero) slots stay finite; keep the sign, since
    # the datasets hold negative-range clutter and dx/r must stay cos(theta)
    tiny = torch.where(rng < 0, -1e-6, 1e-6).to(rng.dtype)
    rng_safe = torch.where(torch.abs(rng) > 1e-6, rng, tiny)
    j0 = dx / rng_safe
    j1 = dy / rng_safe
    j2 = -dy
    j3 = dx
    var_r = (cfg.std_range * cfg.birth_noise_factor) ** 2
    var_b = (cfg.std_bearing * cfg.birth_noise_factor) ** 2
    c00 = j0 * j0 * var_r + j2 * j2 * var_b
    c01 = j0 * j1 * var_r + j2 * j3 * var_b
    c11 = j1 * j1 * var_r + j3 * j3 * var_b
    cov = torch.stack([torch.stack([c00, c01], dim=-1),
                       torch.stack([c01, c11], dim=-1)], dim=-2)
    return mean, cov


def birth_mean_cov_4d(pose, z, cfg):
    """Inverse measurement -> 4D (position, velocity) birth Gaussian.

    The position block is :func:`birth_mean_cov`'s; the velocity mean is
    zero with variances cov_vx_birth / cov_vy_birth and no cross terms.
    """
    mean2, cov2 = birth_mean_cov(pose, z, cfg)
    mean = torch.cat([mean2, torch.zeros_like(mean2)], dim=-1)
    cov = torch.zeros(mean2.shape[:-1] + (4, 4), dtype=mean2.dtype,
                      device=mean2.device)
    cov[..., :2, :2] = cov2
    cov[..., 2, 2] = cfg.cov_vx_birth
    cov[..., 3, 3] = cfg.cov_vy_birth
    return mean, cov


def seed_birth_velocity(b_mean_d, prev_z, z_mask, cfg):
    """Two-scan velocity initialization of the 4D dynamic births
    (birth_velocity_init): ``b_mean_d`` [..., M, 4] (world x, y, 0, 0),
    ``prev_z`` [..., Mp, 3] the previous scan's world positions (x, y,
    valid) of the same particles. A birth's velocity becomes (p - q) / dt
    for the nearest valid previous point q (argmin ties to the lowest
    index) within birth_velocity_max * dt, dt the nominal scan interval
    cfg.dt; it stays zero otherwise and on padded measurements."""
    dt = max(float(cfg.dt), 1e-6)
    p = b_mean_d[..., :2]                                  # [..., M, 2]
    q = prev_z[..., :2]                                    # [..., Mp, 2]
    valid = prev_z[..., 2] > 0.5
    d2 = ((p[..., :, None, :] - q[..., None, :, :]) ** 2).sum(dim=-1)
    d2 = torch.where(valid[..., None, :], d2, torch.inf)
    dmin2, j = torch.min(d2, dim=-1)                       # first minimum
    gate = cfg.birth_velocity_max * dt
    ok = z_mask & (dmin2 <= gate * gate)
    qj = torch.gather(q, -2, j[..., None].expand(j.shape + (2,)))
    v = torch.where(ok[..., None], (p - qj) / dt, 0.0)
    return torch.cat([b_mean_d[..., :2], v], dim=-1)
