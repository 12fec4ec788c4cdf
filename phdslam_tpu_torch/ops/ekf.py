"""Batched EKF pre-update for range-bearing measurements (port of
``phdslam_tpu/ops/ekf.py``, the parts the det and full-grid routes run).

The innovation covariance S, the gain and the Joseph-form covariance are
computed once per feature; only means and weights are per (measurement,
feature). Everything broadcasts over leading axes: the filter passes
pose [P, 1, 6] against maps [P, K, D]. The closed-form component-plane
arithmetic keeps the JAX version's operation order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.measurement import detection_probability, predict_measurement
from .math import LOG_2PI, safe_log, wrap_angle


class PreUpdate(NamedTuple):
    """Per-feature EKF quantities (batched over [..., K])."""
    r: torch.Tensor          # [..., K] predicted range
    bearing: torch.Tensor    # [..., K] predicted bearing
    pd: torch.Tensor         # [..., K] detection probability
    det_S: torch.Tensor      # [..., K]
    gain: torch.Tensor       # [..., K, D, 2] Kalman gain
    cov_upd: torch.Tensor    # [..., K, D, D] Joseph-form updated covariance
    si00: torch.Tensor       # [..., K] S^-1 component planes
    si01: torch.Tensor
    si11: torch.Tensor


def ekf_preupdate(pose, mean, cov, cfg) -> PreUpdate:
    """Measurement-independent EKF quantities for each feature.

    Joseph form: cov_upd = P - EP - (EP)^T + E P E^T + K R K^T with
    E = gain . H, H = [J | 0], built from symmetric terms.
    """
    r, bearing, dx, dy, r2 = predict_measurement(pose, mean)
    pd = detection_probability(r, bearing, cfg).to(mean.dtype)

    # clamp the Jacobian range: empty slots sit at the origin
    r_safe = torch.clamp_min(r, 1e-6)
    r2_safe = torch.clamp_min(r2, 1e-12)
    j00 = dx / r_safe
    j01 = dy / r_safe
    j10 = -dy / r2_safe
    j11 = dx / r2_safe

    vr = cfg.std_range ** 2
    vb = cfg.std_bearing ** 2

    p_a0 = cov[..., :, 0]                                   # [..., K, D]
    p_a1 = cov[..., :, 1]
    pht0 = p_a0 * j00[..., None] + p_a1 * j01[..., None]
    pht1 = p_a0 * j10[..., None] + p_a1 * j11[..., None]

    s00 = j00 * pht0[..., 0] + j01 * pht0[..., 1] + vr
    s11 = j10 * pht1[..., 0] + j11 * pht1[..., 1] + vb
    s01 = 0.5 * ((j00 * pht1[..., 0] + j01 * pht1[..., 1])
                 + (j10 * pht0[..., 0] + j11 * pht0[..., 1]))
    det_S = s00 * s11 - s01 * s01
    si00 = s11 / det_S
    si01 = -s01 / det_S
    si11 = s00 / det_S

    g0 = pht0 * si00[..., None] + pht1 * si01[..., None]
    g1 = pht0 * si01[..., None] + pht1 * si11[..., None]

    kh0 = g0 * j00[..., None] + g1 * j10[..., None]         # [..., K, D]
    kh1 = g0 * j01[..., None] + g1 * j11[..., None]
    p_0c = p_a0
    p_1c = p_a1
    ep = kh0[..., :, None] * p_0c[..., None, :] \
        + kh1[..., :, None] * p_1c[..., None, :]            # [..., K, D, D]
    ept = kh0[..., None, :] * p_0c[..., :, None] \
        + kh1[..., None, :] * p_1c[..., :, None]
    p00 = cov[..., 0, 0][..., None, None]
    p01 = cov[..., 0, 1][..., None, None]
    p11 = cov[..., 1, 1][..., None, None]
    epe = (kh0[..., :, None] * kh0[..., None, :]) * p00 \
        + (kh0[..., :, None] * kh1[..., None, :]
           + kh1[..., :, None] * kh0[..., None, :]) * p01 \
        + (kh1[..., :, None] * kh1[..., None, :]) * p11
    grg = vr * (g0[..., :, None] * g0[..., None, :]) \
        + vb * (g1[..., :, None] * g1[..., None, :])
    cov_upd = cov - ep - ept + epe + grg

    gain = torch.stack([g0, g1], dim=-1)                    # [..., K, D, 2]
    return PreUpdate(r=r, bearing=bearing, pd=pd, det_S=det_S, gain=gain,
                     cov_upd=cov_upd, si00=si00, si01=si01, si11=si11)


def _innovations(pre: PreUpdate, z):
    """Range and wrapped bearing innovations [..., M, K] of z [M, 2]
    against each feature's predicted measurement (pre [..., K])."""
    innov_r = z[:, None, 0] - pre.r[..., None, :]
    innov_b = wrap_angle(z[:, None, 1] - pre.bearing[..., None, :])
    return innov_r, innov_b


def ekf_detection_logw(pre: PreUpdate, weight, z):
    """Partial log-weights of every (measurement, feature) lane:
    log pd + log w - d'S^-1 d / 2 - log 2 pi - log det S / 2.

    pre / weight [..., K], z [M, 2] -> (log_w_partial [..., M, K],
    log_like [..., M, K]): the full grids of the uncapped route.
    """
    innov_r, innov_b = _innovations(pre, z)
    dist = (pre.si00[..., None, :] * innov_r * innov_r
            + 2.0 * pre.si01[..., None, :] * innov_r * innov_b
            + pre.si11[..., None, :] * innov_b * innov_b)
    log_like = -0.5 * dist - LOG_2PI \
        - 0.5 * safe_log(pre.det_S)[..., None, :]
    log_w_partial = safe_log(pre.pd)[..., None, :] \
        + safe_log(weight)[..., None, :] + log_like
    return log_w_partial, log_like


def ekf_detection_means(pre: PreUpdate, mean, z):
    """EKF-updated means of every (measurement, feature) lane:
    mean [..., K, D] -> [..., M, K, D]."""
    innov_r, innov_b = _innovations(pre, z)
    upd = pre.gain[..., None, :, :, 0] * innov_r[..., None] \
        + pre.gain[..., None, :, :, 1] * innov_b[..., None]
    return mean[..., None, :, :] + upd


def ekf_detection_terms(pre: PreUpdate, mean, weight, z):
    """(mean_upd [..., M, K, D], log_w_partial [..., M, K],
    log_like [..., M, K]) of every (measurement, feature) lane."""
    log_w_partial, log_like = ekf_detection_logw(pre, weight, z)
    return ekf_detection_means(pre, mean, z), log_w_partial, log_like


def ekf_detection_linear(pre: PreUpdate, weight, z):
    """Linear-domain detection terms pd * w * N(z; h(x), S) per lane.

    pre / weight [..., K], z [M, 2] -> [..., M, K]. This is the grid the
    detect kernel evaluates (kernels/detect.py, which folds pd, w and the
    normalizer into its ``pref`` plane); the top-cap lane route
    (detection_topk >= K) forms it whole.
    """
    innov_r, innov_b = _innovations(pre, z)
    dist = (pre.si00[..., None, :] * innov_r * innov_r
            + 2.0 * pre.si01[..., None, :] * innov_r * innov_b
            + pre.si11[..., None, :] * innov_b * innov_b)
    pref = pre.pd * weight / (2.0 * math.pi
                              * torch.sqrt(torch.clamp_min(pre.det_S, 1e-30)))
    return pref[..., None, :] * torch.exp(-0.5 * dist)


def ekf_detection_means_at(pre: PreUpdate, mean, z, m_src, k_src):
    """EKF-updated means of one (measurement, feature) lane per particle:
    pre [P, K], mean [P, K, D], z [M, 2], m_src / k_src [P] int ->
    [P, D]. The selected routes' scheme-2 weighting reads its argmax lane
    here, so the [P, M, K, D] mean grid is never formed."""
    rows = torch.arange(mean.shape[0], device=mean.device)
    k_src = k_src.to(torch.int64)
    m_src = m_src.to(torch.int64)
    innov_r = z[m_src, 0] - pre.r[rows, k_src]
    innov_b = wrap_angle(z[m_src, 1] - pre.bearing[rows, k_src])
    gain = pre.gain[rows, k_src]                            # [P, D, 2]
    return mean[rows, k_src] + gain[..., 0] * innov_r[:, None] \
        + gain[..., 1] * innov_b[:, None]


def candidate_gather_indices(idx, K, M, has_birth):
    """Flat candidate-lane ids -> source-row indices + masks.

    Lane layout: [K persistent | M*K detections | M births (optional)].
    Returns (k_eff in [0, K), m_eff in [0, M), is_p, is_d).
    """
    is_p = idx < K
    is_d = (idx >= K) & (idx < K + M * K)
    d_idx = torch.clamp(idx - K, 0, M * K - 1)
    k_src = d_idx % K
    m_src = d_idx // K
    p_idx = torch.clamp(idx, 0, K - 1)
    k_eff = torch.where(is_d, k_src, p_idx)
    if has_birth:
        b_idx = torch.clamp(idx - K - M * K, 0, M - 1)
        m_eff = torch.where(is_d, m_src, b_idx)
    else:
        m_eff = m_src
    return k_eff, m_eff, is_p, is_d


def candidate_tables_T(mean, cov, pre: PreUpdate, z, b_mean=None,
                       b_cov=None, cons_rows=None):
    """Gather source tables with the feature axis minor.

    mean [P, K, D] -> t_k [P, Ck, K] rows: mean | cov row-major | cov_upd |
    gain row-major | r | bearing (Ck = 16 at D = 2), then the 5 rows of
    ``cons_rows`` when given (same-source pre-consolidation: the
    consolidated mean x, y and upper-triangle covariance, [P, K] each).
    z [M, 2] (shared) with births [P, M, ...] -> t_m [P, Cm, M] rows:
    z | birth mean | birth cov (Cm = 8 at D = 2).
    """
    P, K, D = mean.shape
    rows_k = [mean[..., i] for i in range(D)]
    rows_k += [cov[..., a, b] for a in range(D) for b in range(D)]
    rows_k += [pre.cov_upd[..., a, b] for a in range(D) for b in range(D)]
    rows_k += [pre.gain[..., i, j] for i in range(D) for j in range(2)]
    rows_k += [pre.r, pre.bearing]
    if cons_rows is not None:
        rows_k += list(cons_rows)
    t_k = torch.stack(rows_k, dim=-2)
    M = z.shape[0]
    rows_m = [z[:, 0].expand(P, M), z[:, 1].expand(P, M)]
    if b_mean is not None:
        rows_m += [b_mean[..., i] for i in range(D)]
        rows_m += [b_cov[..., a, b] for a in range(D) for b in range(D)]
    t_m = torch.stack(rows_m, dim=-2)
    return t_k, t_m


def combine_selected_planes(r_k, r_m, is_p, is_d, sel_act, D, has_birth,
                            cons_rows=False, wrap=wrap_angle):
    """Plane-form candidate assembly from gathered table columns.

    r_k [..., Ck, cap], r_m [..., Cm, cap]; masks [..., cap]. Returns
    (mean_planes: D tensors [..., cap], cov_planes: D(D+1)/2 tensors in
    row-major upper-triangle order), empty lanes sanitized to (0, I).
    ``cons_rows``: persistent lanes take the 5 consolidated rows that
    :func:`candidate_tables_T` appended instead of the raw mean and cov.
    ``wrap``: the bearing wrap (the fused merge kernel's twin passes the
    Pallas kernel's floor form).
    """
    o_cov = D
    o_cov_upd = D + D * D
    o_gain = D + 2 * D * D
    o_r = D + 2 * D * D + 2 * D
    o_bear = o_r + 1
    o_cons = o_bear + 1     # 5 rows: mean x/y, c00, c01, c11 (cons_rows)

    def take_k(c):
        return r_k[..., c, :]

    def take_m(c):
        return r_m[..., c, :]

    innov_r = take_m(0) - take_k(o_r)
    innov_b = wrap(take_m(1) - take_k(o_bear))

    mean_planes = []
    for i in range(D):
        mean_k = take_k(o_cons + i) if cons_rows else take_k(i)
        mean_d = take_k(i) + take_k(o_gain + 2 * i) * innov_r \
            + take_k(o_gain + 2 * i + 1) * innov_b
        if has_birth:
            mp = torch.where(is_p, mean_k,
                             torch.where(is_d, mean_d, take_m(2 + i)))
        else:
            mp = torch.where(is_p, mean_k, mean_d)
        mean_planes.append(torch.where(sel_act, mp, 0.0))

    cov_planes = []
    tri = 0
    for a in range(D):
        for b in range(a, D):
            ck = take_k(o_cons + D + tri if cons_rows else o_cov + a * D + b)
            tri += 1
            cu = take_k(o_cov_upd + a * D + b)
            if has_birth:
                cb_ = take_m(2 + D + a * D + b)
                cp = torch.where(is_p, ck, torch.where(is_d, cu, cb_))
            else:
                cp = torch.where(is_p, ck, cu)
            cov_planes.append(
                torch.where(sel_act, cp, 1.0 if a == b else 0.0))
    return mean_planes, cov_planes
