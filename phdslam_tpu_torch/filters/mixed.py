"""Joint static + dynamic (jump-Markov mixed) GM-PHD measurement update
(port of ``phdslam_tpu/filters/mixed.py``, the batch fast route).

The per-measurement normalizer sums the detection terms of BOTH maps (the
static 2D map and the dynamic 4D constant-velocity map) plus clutter and
the birth weights: two birth terms when measurements are unlabeled, one
when labeled (then each measurement births only into the map its label
names). Each map then goes through the static filter's pipeline on its own
(``filters/phd.py``): two-stage candidate selection from the detect
kernel's top-T (run with min_fw = 0 and cb = 0, so the row sums feed the
joint normalizer and thresholding happens after the scale), the deferred
gather, the greedy merge (2D or 4D kernel) and the post-merge compaction.
Static out-of-range features are re-attached untouched; dynamic ones are
dropped.

Batched over particles explicitly (the JAX version vmaps a per-particle
pre-half). Not ported: the per-particle slow route (``_update_mixed_single``,
particle_weighting 2 or compute_variance) and the two-scan velocity birth
(``birth_velocity_init``); ``check_supported`` rejects both.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..config import SlamConfig
from ..kernels.detect import detect
from ..models import measurement
from ..ops import ekf
from ..ops.gm_merge import topcap_sort
from ..ops.math import logsumexp
from ..types import FilterState, GMState
from .phd import (_detection_planes, _post_compact_batched, check_supported,
                  deferred_gather, gather_merge)

STATIC_MEASUREMENT = 0
DYNAMIC_MEASUREMENT = 1


def _birth_weights(z_label, M, cfg: SlamConfig, dtype, device):
    """Per-measurement birth weights of each map [M] and the normalizer's
    birth term: labeled measurements birth only into the matching map (one
    term), unlabeled ones into both (two terms)."""
    bw = cfg.birth_weight
    if cfg.labeled_measurements:
        zeros = torch.zeros((M,), dtype=dtype, device=device)
        bw_s = torch.where(z_label == STATIC_MEASUREMENT, bw, zeros)
        bw_d = torch.where(z_label == DYNAMIC_MEASUREMENT, bw, zeros)
        return bw_s, bw_d, bw
    full = torch.full((M,), bw, dtype=dtype, device=device)
    return full, full, 2.0 * bw


def _classify_pre(pose_b, gm: GMState, cfg: SlamConfig):
    """In-range classes and the EKF pre-update of one map."""
    cls = measurement.classify_in_range(pose_b, gm.mean, gm.weight, cfg)
    in_m = cls == measurement.IN_RANGE
    near_m = cls == measurement.NEARLY_IN_RANGE
    out_m = (cls == measurement.OUT_OF_RANGE) & (gm.weight > 0)
    return in_m, near_m, out_m, ekf.ekf_preupdate(pose_b, gm.mean, gm.cov,
                                                  cfg)


def _det_select(det, norm, w_a, act_a, wb, act_c, K, T, cap, min_fw):
    """Stage 1 from the detect kernel's top-T, scaled by the joint
    normalizer and thresholded afterwards (order-exact: the normalizer is
    uniform per measurement), then the global top-cap sort over
    [K persistent | M*T detections | M births]. The kernel's count holds
    the pdw > 0 lanes, so the overflow diagnostic may overcount, as in the
    JAX version. Returns (idx, cand_w, sel_act, n_compact)."""
    vals, idx_d, _, count_d = det
    P, M, _ = vals.shape
    dev = vals.device
    w_sel = torch.where(vals > 0, vals / norm[..., None], 0.0)
    act_sel = (w_sel >= min_fw) & (vals > 0)
    w_sel = torch.where(act_sel, w_sel, 0.0)
    m_ids = torch.arange(M, dtype=torch.int64, device=dev)
    flat_d = K + m_ids[:, None] * K + idx_d.to(torch.int64)
    red_w = torch.cat([w_a, w_sel.reshape(P, M * T), wb], dim=1)
    red_act = torch.cat([act_a, act_sel.reshape(P, M * T), act_c], dim=1)
    red_flat = torch.cat([
        torch.arange(K, dtype=torch.int64, device=dev).expand(P, K),
        flat_d.reshape(P, M * T),
        (K + M * K + m_ids).expand(P, M)], dim=1)
    idx, cand_w, sel_act, n_drop = topcap_sort(red_w, red_act, red_flat, cap)
    n_extra = count_d.sum(dim=1) - torch.clamp_max(count_d, T).sum(dim=1)
    return idx, cand_w, sel_act, n_drop + n_extra


def _update_mixed_pre(pose, gs: GMState, gd: GMState, z, z_label, z_mask,
                      cfg: SlamConfig):
    """Pre-merge half of the mixed update for all particles: classes and
    EKF pre-updates of both maps, the two detect kernels, the joint
    normalizer, the particle-weight increment, and each map's two-stage
    selection and deferred-gather tables."""
    K = gs.mean.shape[-2]
    M = z.shape[0]
    dtype, dev = gs.mean.dtype, gs.mean.device
    T = cfg.detection_topk
    min_fw = cfg.min_feature_weight
    cap = cfg.merge_candidate_cap
    cap_d = cfg.merge_candidate_cap_dynamic or cap
    pose_b = pose[:, None, :]

    in_s, near_s, out_s, pre_s = _classify_pre(pose_b, gs, cfg)
    in_d, near_d, _, pre_d = _classify_pre(pose_b, gd, cfg)
    z4 = torch.stack([z[:, 0], z[:, 1], z_mask.to(dtype),
                      torch.zeros_like(z[:, 0])], dim=1)
    adaptive = bool(cfg.detect_adaptive)
    det_s = detect(_detection_planes(in_s, pre_s, gs.weight), z4, T, 0.0, 0.0,
                   adaptive=adaptive)
    det_d = detect(_detection_planes(in_d, pre_d, gd.weight), z4, T, 0.0, 0.0,
                   adaptive=adaptive)
    sum_s, sum_d = det_s[2], det_d[2]                          # [P, M]

    bw_s, bw_d, birth_norm = _birth_weights(z_label, M, cfg, dtype, dev)
    norm = sum_s + sum_d + cfg.clutter_density + birth_norm
    log_norm = torch.log(norm)

    w_nd_s = torch.where(in_s, gs.weight * (1.0 - pre_s.pd), 0.0)
    w_nd_d = torch.where(in_d, gd.weight * (1.0 - pre_d.pd), 0.0)
    wb_s = torch.where(z_mask, bw_s / norm, 0.0)
    wb_d = torch.where(z_mask, bw_d / norm, 0.0)

    n_valid_z = z_mask.to(dtype).sum()
    if cfg.particle_weighting == 0:
        # cluster process: the predicted cardinality holds the pd-scaled
        # persistent weights only (no birth terms, unlike the static path)
        card_pred = torch.where(in_s, pre_s.pd * gs.weight, 0.0).sum(dim=1) \
            + torch.where(in_d, pre_d.pd * gd.weight, 0.0).sum(dim=1)
        dlog_w = torch.where(z_mask, log_norm, 0.0).sum(dim=1) - card_pred
    else:
        # Vo empty map; the detection sums fold the kernels' row sums
        cn_predict = torch.where(in_s, gs.weight, 0.0).sum(dim=1) \
            + torch.where(in_d, gd.weight, 0.0).sum(dim=1) \
            + n_valid_z * cfg.birth_weight
        cn_update = w_nd_s.sum(dim=1) + w_nd_d.sum(dim=1) \
            + torch.where(z_mask, (sum_s + sum_d) / norm, 0.0).sum(dim=1) \
            + wb_s.sum(dim=1) + wb_d.sum(dim=1)
        dlog_w = n_valid_z * cfg.clutter_density + cn_update - cn_predict \
            - cfg.clutter_rate

    b_mean_s, b_cov_s = measurement.birth_mean_cov(pose_b, z, cfg)
    b_mean_d, b_cov_d = measurement.birth_mean_cov_4d(pose_b, z, cfg)

    def select(det, gm, pre, in_m, near_m, w_nd, wb, bw, cap_m, b_mean,
               b_cov):
        # nearly-in-range features are never pruned
        act_a = (in_m & (w_nd >= min_fw)) | near_m
        w_a = torch.where(in_m, w_nd, torch.where(near_m, gm.weight, 0.0))
        act_c = z_mask & (wb >= min_fw) & (bw > 0)
        idx, cand_w, sel_act, n_compact = _det_select(
            det, norm, w_a, act_a, wb, act_c, K, T, cap_m, min_fw)
        return deferred_gather(idx, cand_w, sel_act, gm.mean, gm.cov, pre, z,
                               b_mean, b_cov), n_compact

    g_s, nc_s = select(det_s, gs, pre_s, in_s, near_s, w_nd_s, wb_s, bw_s,
                       cap, b_mean_s, b_cov_s)
    g_d, nc_d = select(det_d, gd, pre_d, in_d, near_d, w_nd_d, wb_d, bw_d,
                       cap_d, b_mean_d, b_cov_d)
    return dict(g_s=g_s, g_d=g_d, dlog_w=dlog_w, out_s=out_s, nc_s=nc_s,
                nc_d=nc_d)


def _batched_mixed_update(pose, gs: GMState, gd: GMState, z, z_label,
                          z_mask, cfg: SlamConfig):
    """All-particle mixed update: pre-half, one gather + merge per map (2D
    static, 4D dynamic), then each map's post-merge compaction. Returns
    ((sm, sc, sw), (dm, dc, dw), dlog_w [P], overflow [P])."""
    K = gs.mean.shape[-2]
    with record_function("phd.pre"):
        pre = _update_mixed_pre(pose, gs, gd, z, z_label, z_mask, cfg)
    mg_s = gather_merge(pre["g_s"], 2, cfg, K)
    mg_d = gather_merge(pre["g_d"], 4, cfg, K)
    with record_function("phd.post"):
        bits_s = dict(out_m=pre["out_s"], dlog_w=pre["dlog_w"],
                      n_compact=pre["nc_s"])
        sm, sc, sw, dlog_w, ovf_s = _post_compact_batched(
            mg_s, bits_s, gs.mean, gs.cov, gs.weight, cfg)
        # dynamic out-of-range features are killed, not re-attached
        bits_d = dict(out_m=torch.zeros_like(gd.weight, dtype=torch.bool),
                      dlog_w=None, n_compact=pre["nc_d"])
        dm, dc, dw, _, ovf_d = _post_compact_batched(
            mg_d, bits_d, gd.mean, gd.cov, gd.weight, cfg)
    return (sm, sc, sw), (dm, dc, dw), dlog_w, ovf_s + ovf_d


def mixed_update(state: FilterState, z, z_mask, cfg: SlamConfig,
                 z_label=None):
    """Mixed-model measurement update over all particles; returns
    (state, overflow). ``z_label`` [M] (0 static, 1 dynamic) is read only
    with labeled_measurements; None means all static, as in the JAX
    version."""
    gs, gd = state.map_static, state.map_dynamic
    K, M = gs.mean.shape[-2], z.shape[0]
    check_supported(cfg, K, M)
    if z_label is None:
        z_label = torch.zeros((M,), dtype=torch.int32, device=z.device)
    (sm, sc, sw), (dm, dc, dw), dlog_w, overflow = _batched_mixed_update(
        state.pose, gs, gd, z, z_label, z_mask, cfg)
    log_w = state.log_weight + dlog_w
    log_w = log_w - logsumexp(log_w, dim=0)
    state = state.replace(
        map_static=GMState(mean=sm, cov=sc, weight=sw),
        map_dynamic=GMState(mean=dm, cov=dc, weight=dw),
        log_weight=log_w)
    return state, torch.amax(overflow)
