"""Rao-Blackwellized GM-PHD SLAM filter step (port of
``phdslam_tpu/filters/phd.py``: the det route, the top-cap lane route and
the full-grid route).

One step runs particle shotgunning (n_predict_particles > 1: every
particle repeated k times before prediction), vehicle prediction, the
measurement update (GM-PHD here, or the CPHD update of
``filters/cphd.py``), map extraction (MAP, or the EAP tree of
``filters/extras.py``) and systematic resampling (a forced contraction
back to P after shotgunning) on fixed-capacity [P, K, D] state. The JAX
version writes the update for one particle and vmaps it; here every
function carries the particle axis explicitly. The update's device work
goes through the kernels of ``kernels/``: the fused detection + top-T, the
column gather (candidate tables and post-merge compaction) and the greedy
merges (2D for the static map and the EAP tree, 4D for the dynamic one).

Scope (:func:`check_supported`): every option of the JAX package's PHD,
CPHD and mixed updates, at any width (a merge wider than its narrow
kernel, such as the mixed, dynamic-only or dense full grid, and a detect
row above 1024 features take the staged wide-lane kernels):
  - the static 2D map (feature_model 0) or the dynamic-only 4D map
    (feature_model 1: the same pipeline on ``map_dynamic``, its births from
    ``birth_mean_cov_4d``, the 4D merge), Ackerman or constant-velocity
    vehicle, with the PHD update (filter_type 0; cluster-process (0), Vo's
    empty-map (1) or single-feature (2) weighting, the MC map variance) or
    the CPHD update (filter_type 1; compute_variance estimates nothing
    there, as in the JAX version), Mahalanobis or Hellinger merge
    distance, on any route: the compacted det route (0 < detection_topk <
    K, 0 < merge_candidate_cap < the full grid's width), the top-cap lane
    route (the same cap, detection_topk outside (0, K): every lane ranked
    by weight, no detect kernel) or the full-grid route
    (merge_candidate_cap 0 or at least the width K + M K + M, K + M K for
    CPHD, at M = max_measurements: every lane goes to the argmax merge, as
    the reference does);
  - the mixed jump-Markov static 2D + dynamic 4D maps (feature_model 2,
    ``filters/mixed.py``: the batched fast route, or the per-particle
    route batched over P where the JAX version takes it), with the
    two-scan velocity births (birth_velocity_init);
  - MAP or EAP extraction (map_estimate, eap_every, eap_tree_cap) and
    shotgunning on each of them;
  - the spatially tiled merge (merge_spatial_tiles 4,
    ``ops/gm_merge.py::tiled_merge_packed``) where the JAX version's
    packed merge dispatch tiles (:class:`TileRoute`).
The JAX version's live-width ``lax.switch`` families are exact prefix
slices, so this port runs everything at full width instead; only the
tiled-or-untiled choice reads the widths they pick, from one host read of
the batch's largest live counts a merge (:meth:`TileRoute.tile_width`).
Three kernel knobs act where they act in the JAX version:
``detect_adaptive`` (every detect call: trips stop once a row's lanes
are used up, same outputs),
``premerge_consolidate`` (the PHD det route with the Mahalanobis metric:
the detect kernel collapses same-source detection copies onto the
persistent lane, :func:`consolidates`) and ``fused_gather_merge`` (the
PHD det and top-cap routes without consolidation or the variance
estimator: one merge2d_tables kernel reads the deferred-gather tables;
the CPHD and mixed updates keep the two-kernel route).

Random draws are inputs (:class:`StepNoise`), so a test can replay the JAX
version's keys. Layer spans (``phd.predict``, ``phd.pre``, ``phd.gather``,
``phd.merge``, ``phd.variance``, ``phd.post``, ``phd.extract_resample``;
``runtime/profiling.py``) mark the layers for ``torch.profiler`` and for
the port's own tracing, which also counts each update's live map
components, the lanes entering each merge, the clusters out and the
candidates the top-cap drops. Which branches run (predict,
update, EAP or MAP extraction) is decided on the host; the resampling
decision stays on the device, so a step never waits for the GPU.

On a particle mesh (``mesh``, ``parallel/sharding.py``) the state is this
rank's block; the cross-particle points (the log-weight normaliser, the
overflow maximum, nEff, the ancestry, the expected pose, the MAP row, the
EAP tree and the resampling gather) go through the mesh's collectives, and
the host reads the resampling decision, since the migration's routes run
different collectives (``parallel/migrate.py``).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..kernels.detect import detect
from ..kernels.gather_cols import gather_cols
from ..kernels.merge import merge2d, merge2d_tables, merge4d, tables_operands
from ..models import feature_motion, measurement, vehicle
from ..ops import ekf
from ..ops.gm_merge import (MERGE_DIMS, TILES, compact_candidates,
                            merge_out, pack_planes, sort_planes,
                            switch_widths, switched_width, tile_layout,
                            tile_width, tiled_merge_packed, topcap_sort,
                            topk_compact_indices, unpack_planes)
from ..ops.math import LOG0, safe_log
from ..ops.resample import (effective_sample_ratio, every_particle,
                            max_over_particles, normalize_log_weights,
                            particle_row, particle_scalars,
                            systematic_ancestors)
from ..runtime import profiling
from ..types import FilterState, GMState
from .extras import (eap_expected_map, mc_variance_candidates,
                     mc_variance_packed, single_feature_argmax,
                     single_feature_dlogw_point)


class StepNoise(NamedTuple):
    """The random draws of one step."""
    eps_pred: torch.Tensor    # [subdivide_predict, P k, 3] standard normal
                              # for the CV vehicle, [.., P k, 2] for
                              # Ackerman (k = n_predict_particles)
    u_resample: torch.Tensor  # [P] uniform in [0, 1)
    # compute_variance: draw(s, shape) -> sample s of the MC variance
    # estimator (standard normal; the estimator asks for each s once, in
    # order, and holds one sample at a time)
    var_draw: Optional[Callable[[int, tuple], torch.Tensor]] = None


class StepOutputs(NamedTuple):
    expected_pose: torch.Tensor   # [6]
    map_mean: torch.Tensor        # [K, 2] MAP-particle map (argmax weight)
    map_cov: torch.Tensor         # [K, 2, 2]
    map_weight: torch.Tensor      # [K]
    n_eff: torch.Tensor           # scalar normalized nEff
    resampled: torch.Tensor       # bool scalar
    overflow: torch.Tensor        # candidates and clusters dropped by caps
    log_weight: torch.Tensor      # [P] particle log weights (post-step)
    poses: torch.Tensor           # [P, 6] particle poses (post-step)
    resample_idx: torch.Tensor    # [P] ancestor indices
    cardinality: Optional[torch.Tensor]  # [C+1] MAP particle's log
                                  # cardinality (post-step), CPHD only


def full_grid_width(cfg: SlamConfig, K: int, M: int) -> int:
    """Merge lanes of the uncapped route: [K persistent | M K detections |
    M births] for PHD, no birth lanes for CPHD (its births join after the
    merge)."""
    return K + M * K + (M if cfg.filter_type == 0 else 0)


def uses_full_grid(cfg: SlamConfig, K: int, M: int) -> bool:
    """True when the candidate cap does not bind (0, or at least the full
    grid's width): the JAX version's slow route, every lane merged. The
    width is taken at max_measurements, as the JAX version pads M, when
    the runner's padded M is smaller (a cap between the two widths takes
    the capped route there, so it does here)."""
    return not 0 < cfg.merge_candidate_cap < full_grid_width(
        cfg, K, max(M, cfg.max_measurements))


def update_route(cfg: SlamConfig, K: int, M: int) -> str:
    """The update's route: "full" (the uncapped grid), "det" (a binding
    cap with 0 < detection_topk < K: the detect kernel's stage 1, then
    the global top-cap) or "topk" (a binding cap otherwise: the top-cap
    lane route, every lane ranked by weight over the [P, M, K] grid)."""
    if uses_full_grid(cfg, K, M):
        return "full"
    return "det" if 0 < cfg.detection_topk < K else "topk"


def uses_eap(cfg: SlamConfig) -> bool:
    """EAP extraction: map_estimate bit 1 without bit 0 (bit 0, MAP,
    wins, as in the JAX version)."""
    return bool(cfg.map_estimate & 2) and not cfg.map_estimate & 1


def check_supported(cfg: SlamConfig, K: int, M: int) -> None:
    """Raise for a value the JAX package does not define. No width is
    refused: a merge wider than its narrow kernel
    (kernels/merge.py::NARROW_LANES) and a detect row wider than 1024
    features take the staged wide-lane variants."""
    bad = [f"{name}={getattr(cfg, name)!r} (the JAX package defines "
           f"{', '.join(map(str, values))})"
           for name, values in (("filter_type", (0, 1)),
                                ("feature_model", (0, 1, 2)),
                                ("motion_type", (0, 1)),
                                ("distance_metric", (0, 1)))
           if getattr(cfg, name) not in values]
    if bad:
        raise NotImplementedError(
            "configuration outside the ported path: " + "; ".join(bad))


# ----------------------------------------------------------------------------
# Prediction
# ----------------------------------------------------------------------------

def predict(state: FilterState, control, dt, cfg: SlamConfig,
            eps_pred) -> FilterState:
    """Vehicle prediction in ``subdivide_predict`` sub-steps of dt / sub,
    sub-step i drawing eps_pred[i]: constant velocity (motion_type 0, the
    noise at 3x the configured accelerations, as the reference's host code
    draws it) or Ackerman (1). The dynamic-only and mixed models
    (feature_model 1, 2) then predict the dynamic map over the whole dt;
    the static map is never predicted."""
    pose = state.pose
    sub = max(1, cfg.subdivide_predict)
    dt32 = np.float32(dt)
    dt_sub = float(dt32 / np.float32(sub))
    for i in range(sub):
        if cfg.motion_type == 0:
            noise_std = (3.0 * cfg.ax, 3.0 * cfg.ay, 3.0 * cfg.ayaw)
            pose = vehicle.cv_predict(pose, noise_std, dt_sub, eps_pred[i])
        else:
            geom = (cfg.l, cfg.h, cfg.a, cfg.b)
            noise_std = (cfg.std_encoder, cfg.std_alpha)
            pose = vehicle.ackerman_predict(pose, control, geom, noise_std,
                                            dt_sub, eps_pred[i])
    state = state.replace(pose=pose)
    if cfg.feature_model in (1, 2):
        dyn = state.map_dynamic
        (mean, cov, weight), _jump = feature_motion.mixed_model_predict(
            dyn.mean, dyn.cov, dyn.weight, cfg, float(dt32))
        state = state.replace(
            map_dynamic=GMState(mean=mean, cov=cov, weight=weight))
    return state


# ----------------------------------------------------------------------------
# Measurement update
# ----------------------------------------------------------------------------

def _detection_planes(in_m, pre: ekf.PreUpdate, weight, consolidate=False,
                      cov=None, min_fw=0.0):
    """Input planes of the detect kernel [P, 6, K]: r, bearing, si00, si01,
    si11, pref = pd w / (2 pi sqrt det S), zero out of range (the JAX
    version's ``_detection_planes_single``, batched over P).

    With ``consolidate`` (same-source pre-consolidation), [P, 13, K]: 7
    more rows from the map's covariance ``cov`` [P, K, 2, 2]: wp (the
    persistent candidate weight w (1 - pd), zero out of range or below
    ``min_fw``), the copy-copy quadratic G' cov_upd^-1 G and the
    copy-persistent quadratic G' ((cov + cov_upd) / 2)^-1 G in innovation
    coordinates (upper triangles), each inverse from the determinant
    clamped at 1e-30."""
    pref = torch.where(
        in_m,
        pre.pd * weight / (2.0 * math.pi
                           * torch.sqrt(torch.clamp_min(pre.det_S, 1e-30))),
        0.0)
    rows = [pre.r, pre.bearing, pre.si00, pre.si01, pre.si11, pref]
    if consolidate:
        w_nd = weight * (1.0 - pre.pd)
        rows.append(torch.where(in_m & (w_nd >= min_fw), w_nd, 0.0))
        g00, g01 = pre.gain[..., 0, 0], pre.gain[..., 0, 1]
        g10, g11 = pre.gain[..., 1, 0], pre.gain[..., 1, 1]

        def quad(c00, c01, c11):
            det = torch.clamp_min(c00 * c11 - c01 * c01, 1e-30)
            i00, i01, i11 = c11 / det, -c01 / det, c00 / det
            # G' Cinv G with G columns (g00, g10), (g01, g11)
            return (g00 * g00 * i00 + 2.0 * g00 * g10 * i01
                    + g10 * g10 * i11,
                    g00 * g01 * i00 + (g00 * g11 + g01 * g10) * i01
                    + g10 * g11 * i11,
                    g01 * g01 * i00 + 2.0 * g01 * g11 * i01
                    + g11 * g11 * i11)
        cu00 = pre.cov_upd[..., 0, 0]
        cu01 = pre.cov_upd[..., 0, 1]
        cu11 = pre.cov_upd[..., 1, 1]
        rows += quad(cu00, cu01, cu11)
        rows += quad(0.5 * (cov[..., 0, 0] + cu00),
                     0.5 * (cov[..., 0, 1] + cu01),
                     0.5 * (cov[..., 1, 1] + cu11))
    return torch.stack(rows, dim=1)


def consolidates(cfg: SlamConfig) -> bool:
    """Whether the PHD det route runs same-source pre-consolidation: where
    the JAX version does (premerge_consolidate on the 2D map, not with
    scheme-2 weighting or the Hellinger metric; the mixed and CPHD updates
    never read the knob)."""
    return bool(cfg.premerge_consolidate) and cfg.particle_weighting != 2 \
        and cfg.distance_metric == 0


def _fold_consolidated(cons, in_m, w_a, act_a, mean, cov, pre, min_fw):
    """Moment-match each column's members (their w_det moments about the
    head's innovation c, from the detect kernel) and, when ``pers_in``,
    the persistent copy into the persistent lane (the JAX version's fold in
    ``_update_single_pre``). Returns (w_a, act_a, cons_rows): the new
    persistent weights and actives and the 5 consolidated table rows (mean
    x, y, cov 00, 01, 11; the map's own where a column has no member)."""
    Sw, Sdur, Sdub, Srr, Srb, Sbb, c_r, c_b, n_mem, pers_in = cons.unbind(1)
    # the wp plane the kernel gated heads and membership on
    wp = torch.where(in_m & (w_a >= min_fw), w_a, 0.0)
    cons_on = n_mem > 0.5
    wpin = torch.where(pers_in > 0.5, wp, 0.0)
    W = Sw + wpin
    W_safe = torch.clamp_min(W, 1e-30)
    # mean: u-bar = (Sw c + S du) / W (the persistent copy sits at u = 0)
    ub_r = (Sw * c_r + Sdur) / W_safe
    ub_b = (Sw * c_b + Sdub) / W_safe
    g00, g01 = pre.gain[..., 0, 0], pre.gain[..., 0, 1]
    g10, g11 = pre.gain[..., 1, 0], pre.gain[..., 1, 1]
    mc_x = mean[..., 0] + g00 * ub_r + g01 * ub_b
    mc_y = mean[..., 1] + g10 * ub_r + g11 * ub_b
    # spread about u-bar, accumulated about c so the quadratic terms stay
    # O(min_sep)
    dc_r = ub_r - c_r
    dc_b = ub_b - c_b
    sp_rr = (Srr + wpin * c_r * c_r) / W_safe - dc_r * dc_r
    sp_rb = (Srb + wpin * c_r * c_b) / W_safe - dc_r * dc_b
    sp_bb = (Sbb + wpin * c_b * c_b) / W_safe - dc_b * dc_b
    cu00 = pre.cov_upd[..., 0, 0]
    cu01 = pre.cov_upd[..., 0, 1]
    cu11 = pre.cov_upd[..., 1, 1]
    base00 = (Sw * cu00 + wpin * cov[..., 0, 0]) / W_safe
    base01 = (Sw * cu01 + wpin * cov[..., 0, 1]) / W_safe
    base11 = (Sw * cu11 + wpin * cov[..., 1, 1]) / W_safe
    # + G spread G' (rows of G: (g00, g01), (g10, g11))
    cc00 = base00 + g00 * g00 * sp_rr + 2.0 * g00 * g01 * sp_rb \
        + g01 * g01 * sp_bb
    cc01 = base01 + g00 * g10 * sp_rr \
        + (g00 * g11 + g01 * g10) * sp_rb + g01 * g11 * sp_bb
    cc11 = base11 + g10 * g10 * sp_rr + 2.0 * g10 * g11 * sp_rb \
        + g11 * g11 * sp_bb
    cons_rows = (torch.where(cons_on, mc_x, mean[..., 0]),
                 torch.where(cons_on, mc_y, mean[..., 1]),
                 torch.where(cons_on, cc00, cov[..., 0, 0]),
                 torch.where(cons_on, cc01, cov[..., 0, 1]),
                 torch.where(cons_on, cc11, cov[..., 1, 1]))
    return torch.where(cons_on, W, w_a), act_a | cons_on, cons_rows


def birth_mean_cov(pose_b, z, cfg: SlamConfig, D: int):
    """The births of a D-dimensional map: 2D, or 4D (zero velocity) for
    the dynamic-only map."""
    if D == 4:
        return measurement.birth_mean_cov_4d(pose_b, z, cfg)
    return measurement.birth_mean_cov(pose_b, z, cfg)


def particle_dlogw(cfg: SlamConfig, in_m, pd, weight, z_mask, log_norm,
                   w_nd, cn_det, w_birth):
    """The PHD update's particle log-weight increment [P]: the cluster
    process (particle_weighting 0: sum of the log normalizers minus the
    predicted cardinality, the pd-scaled persistent weights and one birth
    weight per measurement) or Vo's empty-map weighting (any other scheme;
    scheme 2 replaces it after the merge): clutter density times the
    measurement count plus the updated cardinality (non-detections
    ``w_nd``, the normalized detection terms' sum ``cn_det``, births)
    minus the predicted one and the clutter rate. ``cn_det`` is read only
    by the latter (None under the cluster process)."""
    dtype = log_norm.dtype
    n_valid_z = z_mask.to(dtype).sum()
    if cfg.particle_weighting == 0:
        card_pred = torch.where(in_m, pd * weight, 0.0).sum(dim=1) \
            + n_valid_z * cfg.birth_weight
        return torch.where(z_mask, log_norm, 0.0).sum(dim=1) - card_pred
    cn_predict = torch.where(in_m, weight, 0.0).sum(dim=1)
    cn_update = w_nd.sum(dim=1) + cn_det + w_birth.sum(dim=1)
    return n_valid_z * cfg.clutter_density + cn_update - cn_predict \
        - cfg.clutter_rate


def _update_pre(pose, mean, cov, weight, z, z_mask, cfg: SlamConfig):
    """Pre-merge half of the update for all particles on a capped route
    (the JAX version's ``_update_single_pre``, batched over P instead of
    vmapped): in-range classes, EKF pre-update, normalizers and particle
    weights, the candidate selection and the deferred-gather tables. On
    the det route (0 < detection_topk < K) the detect kernel gives the
    normalizers and each measurement's top-T, and a global top-cap sort
    follows; with :func:`consolidates`, the kernel also collapses each
    column's same-source copies and the persistent lanes become their
    moment-matched clusters (:func:`_fold_consolidated`). On the top-cap
    lane route the [P, M, K] detection grid is formed here and every lane
    of [K persistent | M K detections | M births] is ranked by weight
    (``topk_compact_indices``). Under scheme 2 (particle_weighting 2) the
    argmax of the single-object likelihood over the route's detection
    lanes is located here (``s2``) for the post half.
    """
    P, K, D = mean.shape
    M = z.shape[0]
    dev = mean.device
    dtype = mean.dtype
    pose_b = pose[:, None, :]

    cls = measurement.classify_in_range(pose_b, mean, weight, cfg)
    in_m = cls == measurement.IN_RANGE
    near_m = cls == measurement.NEARLY_IN_RANGE
    out_m = (cls == measurement.OUT_OF_RANGE) & (weight > 0)
    pre = ekf.ekf_preupdate(pose_b, mean, cov, cfg)

    T = cfg.detection_topk
    min_fw = cfg.min_feature_weight
    det_route = 0 < T < K
    consolidate = det_route and consolidates(cfg) and D == 2
    if det_route:
        z4 = torch.stack([z[:, 0], z[:, 1], z_mask.to(dtype),
                          torch.zeros_like(z[:, 0])], dim=1)
        det = detect(
            _detection_planes(in_m, pre, weight, consolidate, cov, min_fw),
            z4, T, float(min_fw),
            float(cfg.clutter_density + cfg.birth_weight),
            min_sep=float(cfg.min_separation) if consolidate else 0.0,
            adaptive=bool(cfg.detect_adaptive))
        vals_d, idx_d, norm, count_d = det[:4]
    else:
        det_valid = z_mask[:, None] & in_m[:, None, :]          # [P, M, K]
        pdw = torch.where(det_valid, ekf.ekf_detection_linear(pre, weight, z),
                          0.0)
        norm = pdw.sum(dim=-1) + cfg.clutter_density + cfg.birth_weight

    log_norm = torch.log(norm)                                 # [P, M]
    w_birth = torch.where(z_mask, cfg.birth_weight / norm, 0.0)
    w_nd = torch.where(in_m, weight * (1.0 - pre.pd), 0.0)
    b_mean, b_cov = birth_mean_cov(pose_b, z, cfg, D)

    # Vo's empty-map weighting sums the normalized detection terms: from
    # the detect kernel's row sums (sum_k pdw = norm - clutter - birth) on
    # the det route, from the pdw grid on the top-cap lane route
    cn_det = None
    if cfg.particle_weighting != 0:
        cn_det = (((norm - cfg.clutter_density - cfg.birth_weight) / norm)
                  .sum(dim=1) if det_route
                  else (pdw.sum(dim=-1) / norm).sum(dim=1))
    dlog_w = particle_dlogw(cfg, in_m, pre.pd, weight, z_mask, log_norm,
                            w_nd, cn_det, w_birth)

    # nearly-in-range features are never pruned
    act_a = (in_m & (w_nd >= min_fw)) | near_m
    w_a = torch.where(in_m, w_nd, torch.where(near_m, weight, 0.0))
    act_c = z_mask & (w_birth >= min_fw)
    cons_rows = None
    if consolidate:
        w_a, act_a, cons_rows = _fold_consolidated(
            det[4], in_m, w_a, act_a, mean, cov, pre, min_fw)

    rows = torch.arange(P, device=dev)
    if det_route:
        # stage 1 (the detect kernel): heaviest T live detection lanes per
        # z; stage 2: global top-cap by weight over [K persistent | M*T |
        # M births]
        n_extra = count_d.sum(dim=1) - torch.clamp_max(count_d, T).sum(dim=1)
        m_ids = torch.arange(M, dtype=torch.int64, device=dev)
        flat_d = K + m_ids[:, None] * K + idx_d.to(torch.int64)  # [P, M, T]
        w_sel = torch.where(vals_d > 0, vals_d / norm[..., None], 0.0)
        red_w = torch.cat([w_a, w_sel.reshape(P, M * T), w_birth], dim=1)
        red_act = torch.cat([act_a, (vals_d > 0).reshape(P, M * T), act_c],
                            dim=1)
        red_flat = torch.cat([
            torch.arange(K, dtype=torch.int64, device=dev).expand(P, K),
            flat_d.reshape(P, M * T),
            (K + M * K + m_ids).expand(P, M)], dim=1)
        idx, cand_w, sel_act, n_drop = topcap_sort(
            red_w, red_act, red_flat, cfg.merge_candidate_cap)
        n_compact = n_drop + n_extra
        if cfg.particle_weighting == 2:
            # the argmax over the selected lanes: like = pdw / (pd w), pd
            # equal to cfg.pd on every live lane
            idx_f = idx_d.reshape(P, M * T).to(torch.int64)
            w_k = torch.gather(weight, 1, idx_f)
            like = torch.where(vals_d.reshape(P, M * T) > 0,
                               vals_d.reshape(P, M * T)
                               / torch.clamp_min(cfg.pd * w_k, 1e-30), 0.0)
            fl = torch.argmax(like, dim=1)
            m_src, k_src = fl // T, idx_f[rows, fl]
    else:
        w_det = pdw / norm[..., None]
        act_b = det_valid & (w_det >= min_fw)
        idx, cand_w, sel_act, n_compact = topk_compact_indices(
            torch.cat([w_a, w_det.reshape(P, M * K), w_birth], dim=1),
            torch.cat([act_a, act_b.reshape(P, M * K), act_c], dim=1),
            cfg.merge_candidate_cap)
        if cfg.particle_weighting == 2:
            like = torch.where(
                det_valid & (weight[:, None, :] > 0),
                pdw / torch.clamp_min(cfg.pd * weight[:, None, :], 1e-30),
                0.0).reshape(P, M * K)
            fl = torch.argmax(like, dim=1)
            m_src, k_src = fl // K, fl % K
    s2 = None
    if cfg.particle_weighting == 2:
        n_valid_z = z_mask.to(dtype).sum()
        s2 = dict(max_like=like[rows, fl],
                  x_star=ekf.ekf_detection_means_at(pre, mean, z, m_src,
                                                    k_src),
                  m_valid=n_valid_z * in_m.any(dim=1).to(dtype))
    gather = deferred_gather(idx, cand_w, sel_act, mean, cov, pre, z,
                             b_mean, b_cov, cons_rows)
    return dict(gather=gather, dlog_w=dlog_w, out_m=out_m,
                n_compact=n_compact, s2=s2)


def deferred_gather(idx, cand_w, sel_act, mean, cov, pre: ekf.PreUpdate, z,
                    b_mean, b_cov, cons_rows=None):
    """The deferred-gather dict of a stage-2 selection: flat candidate ids
    ``idx`` [P, cap] over [K persistent | M*K detections | M births] (no
    birth lanes when ``b_mean`` is None) as table columns and masks, plus
    the feature-minor source tables (with the 5 consolidated rows of
    ``cons_rows`` when given; ``cons`` says so)."""
    K, M = mean.shape[-2], z.shape[0]
    k_eff, m_eff, is_p, is_d = ekf.candidate_gather_indices(
        idx, K, M, b_mean is not None)
    t_k, t_m = ekf.candidate_tables_T(mean, cov, pre, z, b_mean, b_cov,
                                      cons_rows)
    return dict(k_eff=k_eff.to(torch.int32), m_eff=m_eff.to(torch.int32),
                is_p=is_p, is_d=is_d, sel_act=sel_act, cand_w=cand_w,
                t_k=t_k, t_m=t_m, cons=cons_rows is not None)


def _finish_candidates_packed(g, D, has_birth=True):
    """Run the deferred candidate gather (two column gathers) and pack the
    candidates as planes [P, 2 + D + D(D+1)/2, cap]: w, act, the means,
    the upper-triangle covariances. ``has_birth``: the lane layout holds
    the M birth lanes (PHD) or not (CPHD)."""
    r_k = gather_cols(g["k_eff"], g["t_k"])
    r_m = gather_cols(g["m_eff"], g["t_m"])
    mean_pl, cov_pl = ekf.combine_selected_planes(
        r_k, r_m, g["is_p"], g["is_d"], g["sel_act"], D, has_birth,
        cons_rows=g["cons"])
    planes = [g["cand_w"], g["sel_act"].to(g["cand_w"].dtype)] \
        + mean_pl + cov_pl
    return torch.stack(planes, dim=-2)


def gather_merge(gather, D, cfg: SlamConfig, out_cap, has_birth=True,
                 fused=False, tiles=None, mesh=None):
    """Gather + combine + greedy merge of a deferred-gather dict (the JAX
    version's ``gather_merge_width_switched`` at full width). ``fused``
    (the PHD capped routes with fused_gather_merge, no consolidated rows
    and no variance estimator): one merge2d_tables kernel instead of two
    column gathers, the combine and merge2d, never tiled (as the JAX
    version's fused dispatch); else ``tiles`` and ``mesh`` go to
    :func:`merge_packed`. Returns the merge tuple (mean, cov, w, n_merged,
    n_dropped)."""
    if fused:
        with profiling.span("phd.gather"):
            ints, flts = tables_operands(gather)
        with profiling.span("phd.merge"):
            profiling.add("merge.entering_lanes",
                          lambda: gather["sel_act"] & (gather["cand_w"] > 0),
                          gather["sel_act"].shape[0])
            return merge_out(merge2d_tables(
                ints, flts, gather["t_k"], gather["t_m"],
                float(cfg.min_separation), out_cap, cfg.distance_metric), 2)
    with profiling.span("phd.gather"):
        packed = _finish_candidates_packed(gather, D, has_birth)
    return merge_packed(packed, D, cfg, out_cap, tiles, mesh)


class TileRoute(NamedTuple):
    """What the JAX version's tiled-or-untiled choice reads on a capped
    route, whose candidates are a weight-sorted prefix of the stage-2
    top-cap selection. Its ``lax.switch`` families pick the merge's width:
    the PHD update's feature-width switch the map's live prefix K'
    (``feat_widths``, by the batch's largest live feature count
    ``n_feat``), its candidate-width switch the candidates' live prefix
    (by the largest live candidate count). The packed merge tiles at that
    width N >= 256 when the largest tile fits a tile row narrower than N
    (``ops/gm_merge.py::tile_width``)."""
    K: int                    # map features
    M: int                    # measurements as the JAX version pads them
    T: int                    # detection_topk (the det route: 0 < T < K')
    cap: int                  # merge_candidate_cap
    births: bool              # the lanes hold the M births (PHD, mixed)
    switch: bool              # the candidate-width switch runs
    from_cap: bool = False    # PHD: the switch's widths from cap (CPHD and
                              # mixed: from the selection's width)
    feat_widths: tuple = ()   # PHD: the feature-width switch ((K,) else)
    n_feat: Optional[torch.Tensor] = None     # [P] live map features

    def width(self, n_feat: int, n_live: int) -> int:
        """The JAX version's merge width at these batch maxima; 0 where
        its lanes are no sorted prefix (the cap does not bind at K')."""
        k = switched_width(self.feat_widths or (self.K,), n_feat)
        b = self.M if self.births else 0
        if not 0 < self.cap < k + self.M * k + b:
            return 0
        sel = (min(self.cap, k + self.M * self.T + b) if 0 < self.T < k
               else self.cap)
        base = self.cap if self.from_cap else sel
        widths = (switch_widths(base) if self.switch and base >= 256
                  else [base])
        return min(switched_width(widths, n_live), sel)

    def tile_width(self, packed, counts, mesh=None) -> int:
        """The tile row width for candidate planes [P, 7, N] whose tiles
        hold ``counts`` [P, 4] lanes (0: untiled), from one host read of
        the batch's largest live feature, live candidate and tile counts
        (the largest over every rank of a ``mesh``, as the JAX version's
        sharded step sees them)."""
        live = ((packed[:, 1] > 0.5) & (packed[:, 0] > 0)).sum(dim=1)
        n_feat = (self.n_feat if self.n_feat is not None
                  else torch.zeros_like(live))
        vals = torch.stack([n_feat.amax(), live.amax(), counts.amax()])
        if mesh is not None:
            vals = mesh.all_max(vals)
        with profiling.host_sync("tile_width"):
            n_feat, n_live, n_tile = vals.tolist()
        N = self.width(n_feat, n_live)
        return tile_width(N, n_tile)


def tile_route(cfg: SlamConfig, D: int, K: int, M: int, weight=None,
               births=True, variance=False) -> Optional[TileRoute]:
    """The :class:`TileRoute` of a capped route where the JAX version's
    packed merge dispatch may tile, else None: 2 x 2 quadrants
    (merge_spatial_tiles 4; any other value runs untiled) of the 2D map
    under the Mahalanobis metric, through its Pallas merge (pallas_merge 0
    runs its untiled XLA merge). ``weight`` [P, K]: the PHD update's map
    (its feature-width switch; None on the CPHD and mixed updates, which
    have none); ``births``: the lanes hold the M births; ``variance``: the
    PHD update's variance estimator runs (no width switch then)."""
    if not (cfg.merge_spatial_tiles == TILES and cfg.pallas_merge
            and D == 2 and cfg.distance_metric == 0):
        return None
    T, phd = cfg.detection_topk, weight is not None
    switch = bool(cfg.feature_width_switch) and not variance
    feat = (tuple(switch_widths(K, above=T)) if phd and switch and K >= 256
            else (K,))
    return TileRoute(K, max(M, cfg.max_measurements), T,
                     cfg.merge_candidate_cap, births, switch, from_cap=phd,
                     feat_widths=feat,
                     n_feat=(weight > 0).sum(dim=1) if phd else None)


def _count_entering(packed) -> None:
    """While tracing, the lanes entering a merge of candidate planes
    [P, C, N] (active, weight > 0) into the work count
    ``merge.entering_lanes``, over P particle-merges."""
    profiling.add("merge.entering_lanes",
                  lambda: (packed[:, 1] > 0.5) & (packed[:, 0] > 0),
                  packed.shape[0])


def merge_packed(packed, D, cfg: SlamConfig, out_cap, tiles=None,
                 mesh=None):
    """Greedy merge of selected candidate planes [P, C, cap] (the JAX
    version's packed merge dispatch: its width switch reduces here to the
    sorted-mode kernel of the feature dimension, which loops only over
    live lanes). On a ``tiles`` route (:class:`TileRoute`) with out_cap a
    multiple of 4, the spatially tiled merge runs where the JAX version's
    does (``ops/gm_merge.py::tiled_merge_packed``). Returns the merge
    tuple."""
    with profiling.span("phd.merge"):
        _count_entering(packed)
        if tiles is not None and out_cap % TILES == 0:
            layout = tile_layout(packed)
            ct = tiles.tile_width(packed, layout[1], mesh)
            if ct:
                return tiled_merge_packed(packed, layout, ct,
                                          cfg.min_separation, out_cap)
        if D == 2:
            out = merge2d(packed, float(cfg.min_separation), out_cap,
                          metric=cfg.distance_metric)
        else:
            out = merge4d(packed, float(cfg.min_separation), out_cap,
                          metric=cfg.distance_metric)
        return merge_out(out, D)


def merge_full_grid(packed, cfg: SlamConfig, out_cap):
    """Greedy merge of candidate planes [P, C, N] in any lane order (the
    full grid; the mixed per-particle route's maps), as the JAX version's
    ``merge_batch_dispatch(sorted_prefix=False)`` and ``merge_dispatch``
    run it: the argmax-mode 2D or 4D kernel (Mahalanobis; 2D
    Hellinger too), or, for the 4D Hellinger merge that the JAX version
    runs in XLA's gm_merge, the lanes sorted weight-descending first and
    the sorted-mode kernel (the same principals, XLA's contract). Returns
    the merge tuple."""
    D = MERGE_DIMS[packed.shape[1]]
    sep, metric = float(cfg.min_separation), cfg.distance_metric
    with profiling.span("phd.merge"):
        _count_entering(packed)
        if D == 2:
            return merge_out(merge2d(packed, sep, out_cap, sorted_w=False,
                                     metric=metric), 2)
        if metric == 0:
            return merge_out(merge4d(packed, sep, out_cap, sorted_w=False),
                             4)
        return merge_out(merge4d(sort_planes(packed, D), sep, out_cap,
                                 metric=1), 4)


def _update_pre_full(pose, mean, cov, weight, z, z_mask, cfg: SlamConfig,
                     var_draw=None):
    """Pre-merge half of the full-grid route for all particles (the JAX
    version's ``_update_single_pre`` with its cap not binding, batched over
    P): the log-domain normalizer over each measurement's detection lanes,
    clutter density and birth weight, and every lane of [K persistent |
    M K detections | M births] packed as merge planes [P, 7, N] (w, act,
    mean, upper-triangle cov) with inactive lanes sanitized to (0, 0, I).
    ``compact_candidates`` at such a cap is the identity, so nothing is
    dropped before the merge. Under scheme 2 the argmax search runs over
    the whole likelihood grid (``s2``); with compute_variance the MC
    estimator runs over every lane, its samples from ``var_draw``."""
    P, K, D = mean.shape
    M = z.shape[0]
    dev, dtype = mean.device, mean.dtype
    pose_b = pose[:, None, :]

    cls = measurement.classify_in_range(pose_b, mean, weight, cfg)
    in_m = cls == measurement.IN_RANGE
    near_m = cls == measurement.NEARLY_IN_RANGE
    out_m = (cls == measurement.OUT_OF_RANGE) & (weight > 0)
    pre = ekf.ekf_preupdate(pose_b, mean, cov, cfg)
    det_valid = z_mask[:, None] & in_m[:, None, :]              # [P, M, K]
    mean_det, logw_part, log_like = ekf.ekf_detection_terms(pre, mean,
                                                            weight, z)
    logw_part = torch.where(det_valid, logw_part, LOG0)

    # per-measurement normalizer: detections + clutter density + birth
    def log_of(v):
        return safe_log(torch.tensor(v, dtype=dtype, device=dev))
    log_bw = log_of(cfg.birth_weight)
    all_logw = torch.cat([logw_part,
                          log_of(cfg.clutter_density).expand(P, M, 1),
                          log_bw.expand(P, M, 1)], dim=-1)
    mmax = torch.amax(all_logw, dim=-1, keepdim=True)
    log_norm = mmax.squeeze(-1) + torch.log(
        torch.sum(torch.exp(all_logw - mmax), dim=-1))          # [P, M]
    w_det = torch.where(det_valid, torch.exp(logw_part - log_norm[..., None]),
                        0.0)
    w_birth = torch.where(z_mask, torch.exp(log_bw - log_norm), 0.0)
    w_nd = torch.where(in_m, weight * (1.0 - pre.pd), 0.0)
    b_mean, b_cov = birth_mean_cov(pose_b, z, cfg, D)

    # the particle weighting, as on the det route (Vo's sums the
    # normalized grid)
    dlog_w = particle_dlogw(
        cfg, in_m, pre.pd, weight, z_mask, log_norm, w_nd,
        None if cfg.particle_weighting == 0 else w_det.sum(dim=(1, 2)),
        w_birth)

    min_fw = cfg.min_feature_weight
    act_a = (in_m & (w_nd >= min_fw)) | near_m
    w_a = torch.where(in_m, w_nd, torch.where(near_m, weight, 0.0))
    act_b = det_valid & (w_det >= min_fw)
    act_c = z_mask & (w_birth >= min_fw)
    packed = full_grid_planes(
        [w_a, w_det, w_birth], [act_a, act_b, act_c],
        [mean, mean_det, b_mean],
        [cov, pre.cov_upd[:, None].expand(P, M, K, D, D), b_cov])
    s2 = None
    if cfg.particle_weighting == 2:
        max_like, x_star, m_valid = single_feature_argmax(log_like, mean_det,
                                                          det_valid)
        s2 = dict(max_like=max_like, x_star=x_star, m_valid=m_valid)
    variance = None
    if cfg.compute_variance:
        with profiling.span("phd.variance"):
            c_mean, c_cov, c_w, _ = unpack_planes(packed, D)
            variance = mc_variance_candidates(c_mean, c_cov, c_w, K,
                                              cfg.n_samples, var_draw)
    return dict(packed=packed, dlog_w=dlog_w, out_m=out_m, s2=s2,
                variance=variance,
                n_compact=torch.zeros((P,), dtype=torch.int64, device=dev))


def full_grid_planes(ws, acts, means, covs):
    """Merge planes [P, 2 + D + D(D+1)/2, N] of lane blocks concatenated
    in order (each block's weights / actives [P, ...], means [P, ..., D],
    covariances [P, ..., D, D], flattened to [P, n_b]): w, act, the means,
    the upper-triangle covariances, inactive lanes sanitized to w 0,
    mean 0, identity covariance (masked lanes can hold non-finite values,
    such as births from padded zero measurements)."""
    P = ws[0].shape[0]
    D = means[0].shape[-1]

    def cat(blocks):
        return torch.cat([b.reshape(P, -1) for b in blocks], dim=1)
    act = cat(acts)
    planes = [torch.where(act, cat(ws), 0.0), act.to(ws[0].dtype)]
    planes += [torch.where(act, cat([m[..., i] for m in means]), 0.0)
               for i in range(D)]
    planes += [torch.where(act, cat([c[..., a, b] for c in covs]),
                           1.0 if a == b else 0.0)
               for a in range(D) for b in range(a, D)]
    return torch.stack(planes, dim=1)


def _pre_merge_phase(pose, mean, cov, weight, z, z_mask, cfg: SlamConfig,
                     out_cap, var_draw=None, mesh=None):
    """Pre-half + gather + merge of a capped route. Returns (mg, bits,
    variance): the merge tuple, the post-half inputs (out_m, dlog_w,
    n_compact, s2) and, with compute_variance, the MC estimate over the
    selected lanes (else None). ``mesh``: the particle mesh, whose
    batch-wide counts the tiled-or-untiled choice reads."""
    with profiling.span("phd.pre"):
        pre = _update_pre(pose, mean, cov, weight, z, z_mask, cfg)
    g = pre["gather"]
    bits = dict(out_m=pre["out_m"], dlog_w=pre["dlog_w"],
                n_compact=pre["n_compact"], s2=pre["s2"])
    K, D = mean.shape[-2:]
    tiles = tile_route(cfg, D, K, z.shape[0], weight,
                       variance=cfg.compute_variance)
    if not cfg.compute_variance:
        # the fused route as the JAX version gates it: the 2D map only,
        # not over consolidated rows, which take the two-kernel route
        fused = bool(cfg.fused_gather_merge) and not g["cons"] and D == 2
        return gather_merge(g, D, cfg, out_cap, fused=fused, tiles=tiles,
                            mesh=mesh), bits, None
    # the estimator reads the selected planes, so the two-kernel route
    # runs whatever fused_gather_merge says (as in the JAX version)
    with profiling.span("phd.gather"):
        packed = _finish_candidates_packed(g, D)
    mg = merge_packed(packed, D, cfg, out_cap, tiles, mesh)
    with profiling.span("phd.variance"):
        variance = mc_variance_packed(packed, g["is_p"], cfg.n_samples,
                                      var_draw)
    return mg, bits, variance


def _post_compact_batched(mg, pre, mean, cov, weight, cfg: SlamConfig):
    """Post-merge half: re-attach out-of-range features and compact to
    capacity K with one stable [P, 2K] sort and a column gather; under
    scheme 2 (``pre["s2"]``) the single-feature weight increment replaces
    ``pre["dlog_w"]``. Returns (new_mean, new_cov, new_w, dlog_w,
    overflow)."""
    P, K, D = mean.shape
    mg_mean, mg_cov, mg_w, n_merged, n_dropped = mg
    out_m = pre["out_m"]
    profiling.add("merge.clusters", n_merged, P)
    profiling.add("select.dropped", pre["n_compact"], P)

    aw = torch.cat([mg_w, torch.where(out_m, weight, 0.0)], dim=1)
    neg_s, order = torch.sort(-aw, dim=-1, stable=True)
    new_w = torch.clamp_min(-neg_s[:, :K], 0.0)
    order = order[:, :K].to(torch.int32)
    rows = [torch.cat([mg_mean[..., i], mean[..., i]], dim=1)
            for i in range(D)]
    rows += [torch.cat([mg_cov[..., a, b], cov[..., a, b]], dim=1)
             for a in range(D) for b in range(a, D)]
    got = gather_cols(order, torch.stack(rows, dim=1))      # [P, 5, K]
    total_live = (aw > 0).sum(dim=1)

    empty = new_w <= 0
    new_mean = torch.stack([torch.where(empty, 0.0, got[:, i])
                            for i in range(D)], dim=-1)
    full = [[None] * D for _ in range(D)]
    i = D
    for a in range(D):
        for b in range(a, D):
            cp = torch.where(empty, 1.0 if a == b else 0.0, got[:, i])
            full[a][b] = full[b][a] = cp
            i += 1
    new_cov = torch.stack([torch.stack(row, dim=-1) for row in full], dim=-2)
    new_w = torch.where(empty, 0.0, new_w)

    overflow = torch.clamp_min(total_live - K, 0) + n_dropped \
        + pre["n_compact"]
    dlog_w = pre["dlog_w"]
    s2 = pre.get("s2")
    if cfg.particle_weighting == 2 and s2 is not None:
        # single-feature weighting reads the map as predicted (before the
        # update) and the compacted updated map
        dlog_w = single_feature_dlogw_point(
            s2["max_like"], s2["x_star"], s2["m_valid"], mean, cov, weight,
            new_mean, new_cov, new_w, cfg)
    return new_mean, new_cov, new_w, dlog_w, overflow


def _batched_update(pose, mean, cov, weight, z, z_mask, cfg: SlamConfig,
                    var_draw=None, mesh=None):
    """All-particle update: pre-half + merge at full width on a capped
    route or the full-grid route, then the post-half compaction (the JAX
    version's ``_update_single_post`` has the same arithmetic on the
    full-grid route). Returns (new_mean, new_cov, new_w, dlog_w,
    overflow [P]) and, with compute_variance, the variance [P] as a sixth,
    as the JAX version does. ``mesh``: see :func:`_pre_merge_phase`."""
    K, M, D = mean.shape[-2], z.shape[0], mean.shape[-1]
    check_supported(cfg, K, M)
    profiling.add("map.live_components", lambda: weight > 0, mean.shape[0])
    if cfg.compute_variance and var_draw is None:
        raise ValueError("compute_variance: the step's noise carries no "
                         "variance draws (StepNoise.var_draw)")
    full = uses_full_grid(cfg, K, M)
    if full or (cfg.compute_variance and D != 2):
        # the full grid; or, for the 4D map's variance, the JAX version's
        # per-particle route: the estimator over the full grid, then the
        # top-cap compaction and the sorted-mode merge
        with profiling.span("phd.pre"):
            bits = _update_pre_full(pose, mean, cov, weight, z, z_mask, cfg,
                                    var_draw)
        if full:
            mg = merge_full_grid(bits["packed"], cfg, K)
        else:
            *cand, bits["n_compact"] = compact_candidates(
                *unpack_planes(bits["packed"], D), cfg.merge_candidate_cap)
            mg = merge_packed(pack_planes(*cand), D, cfg, K)
        variance = bits["variance"]
    else:
        mg, bits, variance = _pre_merge_phase(
            pose, mean, cov, weight, z, z_mask, cfg, out_cap=K,
            var_draw=var_draw, mesh=mesh)
    with profiling.span("phd.post"):
        out = _post_compact_batched(mg, bits, mean, cov, weight, cfg)
    return out if variance is None else out + (variance,)


def update(state: FilterState, z, z_mask, cfg: SlamConfig, consts=None,
           var_draw=None, mesh=None):
    """Measurement update over all particles (this rank's block on a
    ``mesh``, normalized over every rank's); returns (state, overflow).
    The static pipeline updates the static map (feature_model 0) or the
    dynamic-only 4D map (1); the mixed model (2) updates both jointly; the
    CPHD
    filter (filter_type 1) runs ``filters/cphd.py::cphd_update`` with
    ``consts`` (built from cfg when None). With compute_variance the
    static PHD update also estimates each particle's map variance from the
    samples of ``var_draw`` (:class:`StepNoise`)."""
    if cfg.filter_type == 1:
        from .cphd import cphd_constants, cphd_update
        if consts is None:
            consts = cphd_constants(cfg, device=state.pose.device)
        return cphd_update(state, z, z_mask, consts, cfg, mesh=mesh)
    if cfg.feature_model == 2:
        from .mixed import mixed_update
        return mixed_update(state, z, z_mask, cfg, mesh=mesh)
    gm = state.map_dynamic if cfg.feature_model == 1 else state.map_static
    new_mean, new_cov, new_w, dlog_w, overflow, *var = _batched_update(
        state.pose, gm.mean, gm.cov, gm.weight, z, z_mask, cfg, var_draw,
        mesh)
    log_w = normalize_log_weights(state.log_weight + dlog_w, mesh)
    new_gm = GMState(mean=new_mean, cov=new_cov, weight=new_w)
    state = state.replace(
        log_weight=log_w, variance=var[0] if var else state.variance,
        **{"map_dynamic" if cfg.feature_model == 1 else "map_static":
           new_gm})
    return state, max_over_particles(overflow, mesh)


# ----------------------------------------------------------------------------
# Extraction + resampling
# ----------------------------------------------------------------------------

def extract(state: FilterState, cfg: SlamConfig, mesh=None,
            log_weight=None, pose=None):
    """Expected pose + the map estimate: the MAP map (the static map of the
    heaviest particle, for the mixed model too, its dynamic map for the
    dynamic-only model (feature_model 1); argmax ties go to the
    lowest index, as in the JAX version) or, under EAP extraction
    (:func:`uses_eap`), the EAP tree over every particle's map
    (``filters/extras.py::eap_expected_map``) on the steps where
    ``state.step % eap_every == 0`` and the MAP map in between. The step
    count lives on the host, so the choice reads nothing from the
    device. On a ``mesh`` the state is this rank's block, ``log_weight``
    and ``pose`` every particle's (``ops/resample.py::particle_scalars``,
    gathered here when not given), and the MAP row comes from the rank
    that holds it."""
    if log_weight is None:
        log_weight, pose = particle_scalars(state.log_weight, state.pose,
                                            mesh)
    w = torch.exp(log_weight)
    expected_pose = w @ pose
    gm = state.map_dynamic if cfg.feature_model == 1 else state.map_static
    if uses_eap(cfg) and state.step % max(1, cfg.eap_every) == 0:
        return expected_pose, eap_expected_map(gm, state.log_weight, cfg,
                                               mesh=mesh)
    i = torch.argmax(log_weight)
    return expected_pose, tuple(particle_row(i, [gm.mean, gm.cov,
                                                 gm.weight], mesh))


def take_particles(state: FilterState, idx) -> FilterState:
    """Every per-particle array gathered along the particle axis at idx
    (the weights too; the caller sets them)."""
    def take(x):
        return None if x is None else x[idx]

    def take_gm(gm):
        return (None if gm is None else
                GMState(mean=gm.mean[idx], cov=gm.cov[idx],
                        weight=gm.weight[idx]))
    return state.replace(
        pose=state.pose[idx], log_weight=state.log_weight[idx],
        map_static=take_gm(state.map_static),
        map_dynamic=take_gm(state.map_dynamic),
        cardinality=take(state.cardinality), variance=take(state.variance),
        prev_z=take(state.prev_z))


@functools.lru_cache(maxsize=64)
def _log_count_on(n: int, dtype, device):
    return torch.full((), float(n), dtype=dtype, device=device).log()


def _log_count(n, like):
    """log n, a 0-dim tensor in ``like``'s dtype on its device: filled and
    logged on the device (no host-to-device copy, so no wait for the card;
    the same bits as ``torch.log`` of ``float(n)`` there), made once per
    (n, dtype, device) and kept, so a step launches nothing for it. Shared
    by every caller: never written in place."""
    return _log_count_on(int(n), like.dtype, like.device)


def maybe_resample(state: FilterState, has_measurements: bool,
                   cfg: SlamConfig, u, mesh=None, log_weight=None):
    """Systematic resampling when nEff/N <= threshold on a step with
    measurements. The decision stays on the device: every particle array is
    gathered through ``where(resample, ancestors, arange(P))``. On a
    ``mesh`` (``log_weight``: every particle's) the host reads the
    decision and a resampling step migrates the rows
    (``parallel/migrate.py::gather_particles_sharded``); resample_idx holds
    this rank's rows' global ancestors. Returns (state, n_eff,
    resampled)."""
    lw = state.log_weight if mesh is None else log_weight
    P = lw.shape[0]
    dev = state.pose.device
    rows = slice(None) if mesh is None else mesh.rows(P)
    n_eff = effective_sample_ratio(lw)
    identity = torch.arange(P, dtype=torch.int64, device=dev)
    if not has_measurements:
        return (state.replace(resample_idx=identity[rows].to(torch.int32)),
                n_eff, torch.zeros((), dtype=torch.bool, device=dev))
    do_resample = n_eff <= cfg.resample_threshold
    ancestors = systematic_ancestors(lw, u, P)
    idx = torch.where(do_resample, ancestors, identity)
    log_w = torch.where(do_resample, -_log_count(P, state.log_weight),
                        state.log_weight)
    if mesh is None:
        state = take_particles(state, idx)
    else:
        with profiling.host_sync("resample"):
            resample = bool(do_resample)
        if resample:
            from ..parallel.migrate import gather_particles_sharded
            state = gather_particles_sharded(state, idx, mesh, cfg)
    state = state.replace(log_weight=log_w,
                          resample_idx=idx[rows].to(torch.int32))
    return state, n_eff, do_resample


def expand_particles(state: FilterState, k: int) -> FilterState:
    """Particle shotgunning: every particle array repeated k times (the
    copies of a particle adjacent), each copy's log weight minus log k,
    resample_idx the identity over the P k copies."""
    def rep(x):
        return None if x is None else torch.repeat_interleave(x, k, dim=0)

    def rep_gm(gm):
        return (None if gm is None else
                GMState(mean=rep(gm.mean), cov=rep(gm.cov),
                        weight=rep(gm.weight)))
    n = state.pose.shape[0] * k
    return state.replace(
        pose=rep(state.pose),
        log_weight=rep(state.log_weight) - _log_count(k, state.log_weight),
        map_static=rep_gm(state.map_static),
        map_dynamic=rep_gm(state.map_dynamic),
        cardinality=rep(state.cardinality), variance=rep(state.variance),
        prev_z=rep(state.prev_z),
        resample_idx=torch.arange(n, dtype=torch.int32,
                                  device=state.pose.device))


def resample_particles(state: FilterState, has_measurements: bool,
                       cfg: SlamConfig, u, n_particles: int, mesh=None,
                       log_weight=None):
    """The step's resampling of a state of ``n_particles`` particles (P k
    of them after :func:`expand_particles`): with shotgunning, the forced
    systematic contraction back to ``n_particles`` on every step (nEff
    taken at P k, uniform weights, resampled True); otherwise
    :func:`maybe_resample`. On a ``mesh`` ``n_particles`` is this rank's
    block and ``log_weight`` every particle's; the contraction takes the
    exact full gather, as the JAX version's does. Returns (state, n_eff,
    resampled)."""
    if max(1, cfg.n_predict_particles) == 1:
        return maybe_resample(state, has_measurements, cfg, u, mesh,
                              log_weight)
    lw = state.log_weight if mesh is None else log_weight
    n_out = n_particles * (1 if mesh is None else mesh.size)
    n_eff = effective_sample_ratio(lw)
    ancestors = systematic_ancestors(lw, u, n_out)
    log_w = (-_log_count(n_out, state.log_weight)).expand(n_particles)
    if mesh is None:
        state = take_particles(state, ancestors)
    else:
        from ..parallel.migrate import gather_particles_full
        ancestors = ancestors[mesh.rows(n_out)]
        state = gather_particles_full(state, ancestors, mesh)
    state = state.replace(log_weight=log_w.clone(),
                          resample_idx=ancestors.to(torch.int32))
    return state, n_eff, torch.ones((), dtype=torch.bool,
                                    device=state.pose.device)


# ----------------------------------------------------------------------------
# Full step
# ----------------------------------------------------------------------------

def phd_step(state: FilterState, z, z_mask, control, dt, do_predict: bool,
             cfg: SlamConfig, noise: StepNoise, has_z=None, consts=None,
             mesh=None, return_updated: bool = False):
    """One filter step: (shotgun) -> predict -> update -> extract ->
    resample.

    ``z`` [M, 2] padded measurements with ``z_mask`` [M] marking real ones;
    ``control`` = (v_encoder, alpha); ``do_predict`` gates the motion
    model. ``has_z`` (whether z_mask has any True) is read from the device
    when not given; the runner passes it from the host schedule, and the
    CPHD constants (``filters/cphd.py::cphd_constants``) it built once.
    With n_predict_particles = k > 1, the P particles are repeated k times
    before prediction (``noise.eps_pred`` holds P k draws), extraction
    sees all P k, and the step ends with the contraction back to P.
    On a particle ``mesh`` the state and ``noise`` are this rank's block
    and rows (``parallel/sharding.py::make_sharded_step_fn`` takes the
    global draws); the estimates come out the same on every rank.
    ``return_updated`` adds a third output: every particle's log weights
    as the resampling read them (a check of its ancestry needs them).
    """
    if has_z is None:
        with profiling.host_sync("has_z"):
            has_z = bool(z_mask.any())
    P = state.pose.shape[0]
    k_shot = max(1, cfg.n_predict_particles)
    if k_shot > 1:
        state = expand_particles(state, k_shot)
    if do_predict:
        with profiling.span("phd.predict"):
            state = predict(state, control, dt, cfg, noise.eps_pred)
    overflow = torch.zeros((), dtype=torch.int64, device=state.pose.device)
    if has_z:
        state, overflow = update(state, z, z_mask, cfg, consts,
                                 noise.var_draw, mesh)
    with profiling.span("phd.extract_resample"):
        log_weight, pose = particle_scalars(state.log_weight, state.pose,
                                            mesh)
        expected_pose, (mm, mc, mw) = extract(state, cfg, mesh, log_weight,
                                              pose)
        state, n_eff, resampled = resample_particles(
            state, has_z, cfg, noise.u_resample, P, mesh, log_weight)
        # the MAP particle's cardinality after resampling, argmax ties to
        # the lowest index, as the JAX version extracts it
        cn = None
        if state.cardinality is not None:
            i = torch.argmax(every_particle(state.log_weight, mesh))
            cn = particle_row(i, [state.cardinality], mesh)[0]
    state = state.replace(step=state.step + 1)
    out = StepOutputs(expected_pose=expected_pose, map_mean=mm, map_cov=mc,
                      map_weight=mw, n_eff=n_eff, resampled=resampled,
                      overflow=overflow, log_weight=state.log_weight,
                      poses=state.pose, resample_idx=state.resample_idx,
                      cardinality=cn)
    return (state, out, log_weight) if return_updated else (state, out)
