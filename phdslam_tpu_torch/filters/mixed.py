"""Joint static + dynamic (jump-Markov mixed) GM-PHD measurement update
(port of ``phdslam_tpu/filters/mixed.py``: the batch fast route and the
per-particle route, both batched over particles).

The per-measurement normalizer sums the detection terms of BOTH maps (the
static 2D map and the dynamic 4D constant-velocity map) plus clutter and
the birth weights: two birth terms when measurements are unlabeled, one
when labeled (then each measurement births only into the map its label
names). On the fast route each map then goes through the static filter's
pipeline on its own (``filters/phd.py``): two-stage candidate selection
from the detect kernel's top-T (run with min_fw = 0 and cb = 0, so the row
sums feed the joint normalizer and thresholding happens after the scale)
or, with detection_topk outside (0, K), one top-cap selection over the
whole [M, K] grid of each map (``topk_compact_indices``), the deferred
gather, the greedy merge (2D or 4D sorted-mode kernel) and the post-merge
compaction. Static out-of-range features are re-attached untouched;
dynamic ones are dropped.

The per-particle route (the JAX version's ``_update_mixed_single``,
vmapped there, written batched over P here: :func:`_update_mixed_full`)
materializes both maps' full candidate grids with the log-domain joint
normalizer, compacts each to its cap (merge_candidate_cap,
merge_candidate_cap_dynamic on the dynamic map) when the cap binds, and
merges in the JAX version's ``merge_dispatch`` modes
(``filters/phd.py::merge_full_grid``): the static map with merge2d in
argmax mode, the dynamic map with merge4d in argmax mode (Mahalanobis) or,
at distance_metric 1, where the JAX version runs XLA's ``gm_merge``, with
merge4d's Hellinger variant on weight-sorted lanes. It
runs where the JAX version routes to it (:func:`uses_fast_route`):
particle_weighting outside (0, 1), compute_variance (no variance is
estimated there: the state's stays at zeros), mixed_fast_path 0, or a cap
that does not bind on both maps.

Two-scan velocity births (birth_velocity_init): the dynamic births take
their velocity from the nearest point of the previous scan
(``models/measurement.py::seed_birth_velocity``, ``FilterState.prev_z``),
and every update records the scan's world positions for the next one.
"""

from __future__ import annotations

import torch

from ..config import SlamConfig
from ..kernels.detect import detect
from ..models import measurement
from ..ops import ekf
from ..ops.gm_merge import (compact_candidates, pack_planes, topcap_sort,
                            topk_compact_indices)
from ..ops.math import LOG0, safe_log
from ..ops.resample import max_over_particles, normalize_log_weights
from ..runtime import profiling
from ..types import FilterState, GMState
from .phd import (_detection_planes, _post_compact_batched, check_supported,
                  deferred_gather, full_grid_width, gather_merge,
                  merge_full_grid, tile_route)

STATIC_MEASUREMENT = 0
DYNAMIC_MEASUREMENT = 1


def uses_fast_route(cfg: SlamConfig, K: int, M: int) -> bool:
    """The JAX version's route choice (``mixed_update``): the batched fast
    route for weighting 0 or 1 without compute_variance, when
    mixed_fast_path is on and merge_candidate_cap binds on both maps (at
    M = max_measurements, as the JAX version pads), else the per-particle
    route."""
    M = max(M, cfg.max_measurements)
    return (cfg.particle_weighting in (0, 1) and not cfg.compute_variance
            and 0 < cfg.merge_candidate_cap < full_grid_width(cfg, K, M)
            and bool(cfg.mixed_fast_path))


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
                      cfg: SlamConfig, prev_z=None):
    """Pre-merge half of the mixed update for all particles: classes and
    EKF pre-updates of both maps, the two detect kernels (0 <
    detection_topk < K) or the two [P, M, K] detection grids, the joint
    normalizer, the particle-weight increment, and each map's selection
    (two-stage, or one top-cap over the grid) and deferred-gather tables.
    ``prev_z`` (birth_velocity_init) seeds the dynamic births'
    velocities."""
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
    det_route = 0 < T < K
    if det_route:
        z4 = torch.stack([z[:, 0], z[:, 1], z_mask.to(dtype),
                          torch.zeros_like(z[:, 0])], dim=1)
        adaptive = bool(cfg.detect_adaptive)
        det_s = detect(_detection_planes(in_s, pre_s, gs.weight), z4, T, 0.0,
                       0.0, adaptive=adaptive)
        det_d = detect(_detection_planes(in_d, pre_d, gd.weight), z4, T, 0.0,
                       0.0, adaptive=adaptive)
        sum_s, sum_d = det_s[2], det_d[2]                      # [P, M]
    else:
        # the top-cap lane route: both [P, M, K] grids, formed whole
        dv_s = z_mask[:, None] & in_s[:, None, :]
        dv_d = z_mask[:, None] & in_d[:, None, :]
        pdw_s = torch.where(dv_s, ekf.ekf_detection_linear(pre_s, gs.weight,
                                                           z), 0.0)
        pdw_d = torch.where(dv_d, ekf.ekf_detection_linear(pre_d, gd.weight,
                                                           z), 0.0)
        sum_s, sum_d = pdw_s.sum(dim=-1), pdw_d.sum(dim=-1)

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
    b_mean_d, b_cov_d = dynamic_births(pose_b, z, z_mask, cfg, prev_z)

    def select(which, gm, pre, in_m, near_m, w_nd, wb, bw, cap_m, b_mean,
               b_cov):
        # nearly-in-range features are never pruned
        act_a = (in_m & (w_nd >= min_fw)) | near_m
        w_a = torch.where(in_m, w_nd, torch.where(near_m, gm.weight, 0.0))
        act_c = z_mask & (wb >= min_fw) & (bw > 0)
        if det_route:
            idx, cand_w, sel_act, n_compact = _det_select(
                (det_s, det_d)[which], norm, w_a, act_a, wb, act_c, K, T,
                cap_m, min_fw)
        else:
            # every lane ranked by weight over [K | M K | M]
            pdw, dv = ((pdw_s, dv_s), (pdw_d, dv_d))[which]
            w_det = pdw / norm[..., None]
            act_b = dv & (w_det >= min_fw)
            P = w_a.shape[0]
            idx, cand_w, sel_act, n_compact = topk_compact_indices(
                torch.cat([w_a, w_det.reshape(P, M * K), wb], dim=1),
                torch.cat([act_a, act_b.reshape(P, M * K), act_c], dim=1),
                cap_m)
        return deferred_gather(idx, cand_w, sel_act, gm.mean, gm.cov, pre, z,
                               b_mean, b_cov), n_compact

    g_s, nc_s = select(0, gs, pre_s, in_s, near_s, w_nd_s, wb_s, bw_s,
                       cap, b_mean_s, b_cov_s)
    g_d, nc_d = select(1, gd, pre_d, in_d, near_d, w_nd_d, wb_d, bw_d,
                       cap_d, b_mean_d, b_cov_d)
    return dict(g_s=g_s, g_d=g_d, dlog_w=dlog_w, out_s=out_s, nc_s=nc_s,
                nc_d=nc_d)


def dynamic_births(pose_b, z, z_mask, cfg: SlamConfig, prev_z=None):
    """The dynamic map's 4D births [P, M, 4] / [P, M, 4, 4]: zero
    velocity, or seeded from ``prev_z`` (birth_velocity_init)."""
    b_mean, b_cov = measurement.birth_mean_cov_4d(pose_b, z, cfg)
    if prev_z is not None:
        b_mean = measurement.seed_birth_velocity(b_mean, prev_z, z_mask, cfg)
    return b_mean, b_cov


def _batched_mixed_update(pose, gs: GMState, gd: GMState, z, z_label,
                          z_mask, cfg: SlamConfig, prev_z=None, mesh=None):
    """All-particle mixed update, fast route: pre-half, one gather + merge
    per map (2D static, tiled where the JAX version tiles it; 4D
    dynamic), then each map's post-merge compaction. Returns ((sm, sc,
    sw), (dm, dc, dw), dlog_w [P], overflow [P]). ``mesh``: the particle
    mesh, whose batch-wide counts the tiled-or-untiled choice reads."""
    K = gs.mean.shape[-2]
    with profiling.span("phd.pre"):
        pre = _update_mixed_pre(pose, gs, gd, z, z_label, z_mask, cfg,
                                prev_z)
    mg_s = gather_merge(pre["g_s"], 2, cfg, K,
                        tiles=tile_route(cfg, 2, K, z.shape[0]), mesh=mesh)
    mg_d = gather_merge(pre["g_d"], 4, cfg, K)
    with profiling.span("phd.post"):
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


def _map_candidates(gm: GMState, pre, in_m, near_m, mean_det, w_det,
                    det_valid, w_nd, b_mean, b_cov, w_birth, birth_valid,
                    cfg: SlamConfig, cap):
    """One map's full candidate set on the per-particle route (the JAX
    version's ``_merge_map`` up to its merge): [K persistent | M K
    detections | M births] with the prune flags, inactive lanes sanitized
    to (0, I, 0), compacted to the top ``cap`` by weight when the cap
    binds. Returns (mean, cov, w, act, n_compact [P])."""
    P, K, D = gm.mean.shape
    M = w_det.shape[1]
    min_fw = cfg.min_feature_weight
    act_a = (in_m & (w_nd >= min_fw)) | near_m
    w_a = torch.where(in_m, w_nd, torch.where(near_m, gm.weight, 0.0))
    act_b = det_valid & (w_det >= min_fw)
    act_c = birth_valid & (w_birth >= min_fw)
    act = torch.cat([act_a, act_b.reshape(P, M * K), act_c], dim=1)
    mean = torch.cat([gm.mean, mean_det.reshape(P, M * K, D), b_mean], dim=1)
    cov = torch.cat([gm.cov, pre.cov_upd[:, None].expand(P, M, K, D, D)
                     .reshape(P, M * K, D, D), b_cov], dim=1)
    w = torch.cat([w_a, w_det.reshape(P, M * K), w_birth], dim=1)
    eye = torch.eye(D, dtype=mean.dtype, device=mean.device)
    mean = torch.where(act[..., None], mean, 0.0)
    cov = torch.where(act[..., None, None], cov, eye)
    w = torch.where(act, w, 0.0)
    return compact_candidates(mean, cov, w, act, cap)


def _update_mixed_full(pose, gs: GMState, gd: GMState, z, z_label, z_mask,
                       cfg: SlamConfig, prev_z=None):
    """All-particle mixed update, per-particle route (the JAX version's
    ``_update_mixed_single``, batched over P): both maps' full detection
    grids in the log domain, the joint normalizer over both maps, clutter
    and the birth term(s), the particle weight (cluster process at
    weighting 0, Vo's empty-map weighting otherwise), each map's
    candidates compacted to its cap and merged in the JAX version's
    ``merge_dispatch`` modes (``filters/phd.py::merge_full_grid``: merge2d's
    argmax mode, merge4d's argmax mode, or at distance_metric 1 merge4d's
    Hellinger variant on weight-sorted lanes, XLA's ``gm_merge`` there),
    then each map's post-merge compaction (static out-of-range features
    re-attached, dynamic ones dropped). Returns ((sm, sc, sw), (dm, dc,
    dw), dlog_w [P], overflow [P])."""
    K = gs.mean.shape[-2]
    M = z.shape[0]
    dtype, dev = gs.mean.dtype, gs.mean.device
    pose_b = pose[:, None, :]
    with profiling.span("phd.pre"):
        in_s, near_s, out_s, pre_s = _classify_pre(pose_b, gs, cfg)
        in_d, near_d, _, pre_d = _classify_pre(pose_b, gd, cfg)
        mdet_s, lw_s, _ = ekf.ekf_detection_terms(pre_s, gs.mean, gs.weight,
                                                  z)
        mdet_d, lw_d, _ = ekf.ekf_detection_terms(pre_d, gd.mean, gd.weight,
                                                  z)
        dv_s = z_mask[:, None] & in_s[:, None, :]
        dv_d = z_mask[:, None] & in_d[:, None, :]
        lw_s = torch.where(dv_s, lw_s, LOG0)
        lw_d = torch.where(dv_d, lw_d, LOG0)
        bw_s, bw_d, _ = _birth_weights(z_label, M, cfg, dtype, dev)
        n_birth_terms = 1.0 if cfg.labeled_measurements else 2.0

        def log_of(v):
            return safe_log(torch.tensor(v, dtype=dtype, device=dev))
        P = pose.shape[0]
        log_terms = torch.cat([
            lw_s, lw_d, log_of(cfg.clutter_density).expand(P, M, 1),
            (log_of(cfg.birth_weight) + log_of(n_birth_terms))
            .expand(P, M, 1)], dim=-1)
        mmax = torch.amax(log_terms, dim=-1, keepdim=True)
        log_norm = mmax.squeeze(-1) + torch.log(
            torch.sum(torch.exp(log_terms - mmax), dim=-1))      # [P, M]

        w_nd_s = torch.where(in_s, gs.weight * (1.0 - pre_s.pd), 0.0)
        w_nd_d = torch.where(in_d, gd.weight * (1.0 - pre_d.pd), 0.0)
        wdet_s = torch.where(dv_s, torch.exp(lw_s - log_norm[..., None]),
                             0.0)
        wdet_d = torch.where(dv_d, torch.exp(lw_d - log_norm[..., None]),
                             0.0)
        b_mean_s, b_cov_s = measurement.birth_mean_cov(pose_b, z, cfg)
        b_mean_d, b_cov_d = dynamic_births(pose_b, z, z_mask, cfg, prev_z)
        wb_s = torch.where(z_mask, torch.exp(safe_log(bw_s) - log_norm), 0.0)
        wb_d = torch.where(z_mask, torch.exp(safe_log(bw_d) - log_norm), 0.0)

        n_valid_z = z_mask.to(dtype).sum()
        if cfg.particle_weighting == 0:
            card_pred = torch.where(in_s, pre_s.pd * gs.weight, 0.0) \
                .sum(dim=1) \
                + torch.where(in_d, pre_d.pd * gd.weight, 0.0).sum(dim=1)
            dlog_w = torch.where(z_mask, log_norm, 0.0).sum(dim=1) \
                - card_pred
        else:
            cn_predict = torch.where(in_s, gs.weight, 0.0).sum(dim=1) \
                + torch.where(in_d, gd.weight, 0.0).sum(dim=1) \
                + n_valid_z * cfg.birth_weight
            cn_update = w_nd_s.sum(dim=1) + wdet_s.sum(dim=(1, 2)) \
                + wb_s.sum(dim=1) + w_nd_d.sum(dim=1) \
                + wdet_d.sum(dim=(1, 2)) + wb_d.sum(dim=1)
            dlog_w = n_valid_z * cfg.clutter_density + cn_update \
                - cn_predict - cfg.clutter_rate

        cap = cfg.merge_candidate_cap
        cand_s = _map_candidates(gs, pre_s, in_s, near_s, mdet_s, wdet_s,
                                 dv_s, w_nd_s, b_mean_s, b_cov_s, wb_s,
                                 z_mask & (bw_s > 0), cfg, cap)
        cand_d = _map_candidates(gd, pre_d, in_d, near_d, mdet_d, wdet_d,
                                 dv_d, w_nd_d, b_mean_d, b_cov_d, wb_d,
                                 z_mask & (bw_d > 0), cfg,
                                 cfg.merge_candidate_cap_dynamic or cap)
    mg_s = merge_full_grid(pack_planes(*cand_s[:4]), cfg, K)
    mg_d = merge_full_grid(pack_planes(*cand_d[:4]), cfg, K)
    with profiling.span("phd.post"):
        bits_s = dict(out_m=out_s, dlog_w=dlog_w, n_compact=cand_s[4])
        sm, sc, sw, _, ovf_s = _post_compact_batched(
            mg_s, bits_s, gs.mean, gs.cov, gs.weight, cfg)
        bits_d = dict(out_m=torch.zeros_like(gd.weight, dtype=torch.bool),
                      dlog_w=None, n_compact=cand_d[4])
        dm, dc, dw, _, ovf_d = _post_compact_batched(
            mg_d, bits_d, gd.mean, gd.cov, gd.weight, cfg)
    return (sm, sc, sw), (dm, dc, dw), dlog_w, ovf_s + ovf_d


def scan_positions(pose, z, z_mask, prev_z, cfg: SlamConfig):
    """The scan's world positions per particle (the 2D birth means) as the
    next step's ``prev_z`` [P, Mp, 3] (x, y, valid; slots past the scan's
    M zero)."""
    bpos = measurement.birth_mean_cov(pose[:, None, :], z, cfg)[0]
    P, M = pose.shape[0], z.shape[0]
    new = torch.zeros_like(prev_z)
    new[:, :M, :2] = bpos
    new[:, :M, 2] = z_mask.to(new.dtype)[None].expand(P, M)
    return new


def mixed_update(state: FilterState, z, z_mask, cfg: SlamConfig,
                 z_label=None, mesh=None):
    """Mixed-model measurement update over all particles; returns
    (state, overflow). ``z_label`` [M] (0 static, 1 dynamic) is read only
    with labeled_measurements; None means all static, as in the JAX
    version. The route is the JAX version's (:func:`uses_fast_route`).
    With birth_velocity_init the state's ``prev_z`` seeds the dynamic
    births and then holds this scan's world positions. On a particle
    ``mesh`` the state is this rank's block, its weights normalized over
    every rank's."""
    gs, gd = state.map_static, state.map_dynamic
    K, M = gs.mean.shape[-2], z.shape[0]
    check_supported(cfg, K, M)
    if z_label is None:
        z_label = torch.zeros((M,), dtype=torch.int32, device=z.device)
    prev_z = state.prev_z if cfg.birth_velocity_init else None
    args = (state.pose, gs, gd, z, z_label, z_mask, cfg, prev_z)
    (sm, sc, sw), (dm, dc, dw), dlog_w, overflow = (
        _batched_mixed_update(*args, mesh) if uses_fast_route(cfg, K, M)
        else _update_mixed_full(*args))
    log_w = normalize_log_weights(state.log_weight + dlog_w, mesh)
    state = state.replace(
        map_static=GMState(mean=sm, cov=sc, weight=sw),
        map_dynamic=GMState(mean=dm, cov=dc, weight=dw),
        log_weight=log_w)
    if state.prev_z is not None:
        state = state.replace(prev_z=scan_positions(state.pose, z, z_mask,
                                                    state.prev_z, cfg))
    return state, max_over_particles(overflow, mesh)
