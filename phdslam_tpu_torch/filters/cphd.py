"""Cardinalized PHD (CPHD) SLAM update: Vo's analytic CPHD recursion
(port of ``phdslam_tpu/filters/cphd.py``).

Each particle carries, besides its GM map, a log cardinality distribution
over 0..max_cardinality. The update computes per measurement the
detection mass lambda_m, the log-domain elementary symmetric functions of
the lambdas (full, and with each measurement omitted through the prefix /
suffix decomposition), the Psi terms and their inner products with the
predicted cardinality; these scale the non-detection and detection
weights, update the cardinality and give the particle weight. Then the
map is merged and compacted as on the PHD path, births from this scan are
appended, and the cardinality is convolved with the binomial birth
cardinality for the next step.

Three routes, as in the JAX version: the det route (0 < detection_topk <
K, 0 < merge_candidate_cap < K + M K) runs the detect kernel at min_fw = 0,
cb = 0 (its row sums are the lambda numerators; the uniform CPHD scale
exp(ip1d - ip0) kr / kd is applied to the top-T values afterwards, then
thresholded), the two-stage selection, the column gathers and the sorted
merge; the top-cap lane route (the same cap, detection_topk outside
(0, K)) forms the [P, M, K] grid, ranks every [K | M K] lane by weight
(``topk_compact_indices``) and takes the same gathers and merge; the
full-grid route (cap 0 or at least K + M K) forms every [K | M K] lane and
runs the argmax merge. Everything is batched over the
particle axis; the ESF recursion is a Python loop of M steps running the
forward and reverse scans together. Profiler ranges: ``cphd.pre``,
``cphd.card`` (ESF and Psi terms), ``phd.gather``, ``phd.merge``,
``phd.post``, ``cphd.births``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..kernels.cardinality import cardinality_predict_batch
from ..kernels.detect import detect
from ..models import measurement
from ..ops import ekf
from ..ops.gm_merge import topcap_sort, topk_compact_indices
from ..ops.math import LOG0, logsumexp, masked_logsumexp, safe_log, wrap_angle
from ..ops.resample import max_over_particles, normalize_log_weights
from ..runtime import profiling
from ..types import FilterState, GMState
from .phd import (_detection_planes, _post_compact_batched, check_supported,
                  deferred_gather, full_grid_planes, gather_merge,
                  merge_full_grid, tile_route, update_route)


class CphdConstants(NamedTuple):
    log_factorial: torch.Tensor   # [C+1] log n!
    log_binom: torch.Tensor       # [C+1, C+1] log C(n, k) (LOG0 where k > n)
    log_cn_clutter: torch.Tensor  # [C+1] log Poisson(clutter_rate) pmf


def _f32(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def cphd_constants(cfg: SlamConfig, dtype=torch.float32,
                   device="cpu") -> CphdConstants:
    """Log factorials, log binomials and the log Poisson clutter
    cardinality over 0..max_cardinality, in f32 as the JAX version."""
    n = torch.arange(cfg.max_cardinality + 1, dtype=dtype, device=device)
    log_fact = torch.lgamma(n + 1.0)
    nn, kk = n[:, None], n[None, :]
    log_binom = torch.where(
        kk <= nn, torch.lgamma(nn + 1.0) - torch.lgamma(kk + 1.0)
        - torch.lgamma(nn - kk + 1.0), LOG0)
    log_cn_clutter = n * safe_log(_f32(cfg.clutter_rate, n)) \
        - cfg.clutter_rate - log_fact
    return CphdConstants(log_factorial=log_fact, log_binom=log_binom,
                         log_cn_clutter=log_cn_clutter)


# ----------------------------------------------------------------------------
# Cardinality prediction
# ----------------------------------------------------------------------------

# The shared birth cardinality's form, cardinality_predict_batch (one
# kernel launch a step), is kernels/cardinality.py's.

def cardinality_predict(log_cn, log_cn_birth):
    """Log-domain convolution cn_pred[n] = logsum_j cn_birth[n - j] + cn[j]
    over the last axis (log_cn, log_cn_birth [..., C+1]): the gated births'
    per-particle birth cardinality, in eager PyTorch."""
    C1 = log_cn.shape[-1]
    ar = torch.arange(C1, device=log_cn.device)
    diff = ar[:, None] - ar[None, :]                       # [n, j]
    valid = diff >= 0
    birth_term = torch.where(valid, log_cn_birth[..., diff.clamp_min(0)],
                             LOG0)
    return masked_logsumexp(birth_term + log_cn[..., None, :], valid, dim=-1)


def binomial_birth_cardinality(n_births, birth_weight, max_cardinality,
                               dtype=torch.float32, device="cpu"):
    """log B(k; n, p) over k = 0..max_cardinality for n = ``n_births``
    (an int or a tensor [...], giving [..., C+1]) and p = birth_weight."""
    k = torch.arange(max_cardinality + 1, dtype=dtype, device=device)
    n = torch.as_tensor(n_births, device=device).to(dtype)[..., None]
    log_p = safe_log(_f32(birth_weight, k))
    log_q = safe_log(_f32(1.0 - birth_weight, k))
    log_c = torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0) \
        - torch.lgamma(torch.clamp_min(n - k, 0.0) + 1.0)
    return torch.where(k <= n, log_c + k * log_p + (n - k) * log_q, LOG0)


# ----------------------------------------------------------------------------
# Elementary symmetric functions
# ----------------------------------------------------------------------------

def _esf_identity(shape, M, like):
    e0 = torch.full((*shape, M + 1), LOG0, dtype=like.dtype,
                    device=like.device)
    e0[..., 0] = 0.0
    return e0


def _esf_scans(log_lambda, lam_mask):
    """The forward and reverse ESF recursions e_k += lambda_m e_{k-1} (log
    domain; masked-out measurements contribute lambda = 0), run together
    as one loop of M steps over a stacked [2, ..., M+1] state.

    log_lambda / lam_mask [..., M] -> (esf [..., M+1] of all measurements,
    pref [..., M, M+1] with pref[m] = ESF({0..m-1}), suf [..., M, M+1]
    with suf[m] = ESF({m+1..M-1})).
    """
    M = log_lambda.shape[-1]
    ll = torch.where(lam_mask, log_lambda, LOG0)
    ll2 = torch.stack([ll, torch.flip(ll, dims=[-1])])     # [2, ..., M]
    e = _esf_identity(ll2.shape[:-1], M, ll)
    lo = torch.full_like(e[..., :1], LOG0)
    states = [e]
    for m in range(M):
        shifted = torch.cat([lo, e[..., :-1]], dim=-1)
        e = torch.logaddexp(e, ll2[..., m, None] + shifted)
        states.append(e)
    S = torch.stack(states, dim=-2)                        # [2, ..., M+1, M+1]
    pref = S[0, ..., :M, :]
    suf = torch.flip(S[1, ..., :M, :], dims=[-2])
    return S[0, ..., M, :], pref, suf


def log_esf(log_lambda, lam_mask):
    """Log-domain ESF coefficients e_0..e_M of {exp(log_lambda[m])} over
    the last axis; masked-out measurements contribute lambda = 0."""
    return _esf_scans(log_lambda, lam_mask)[0]


def log_esf_prefix_suffix(log_lambda, lam_mask):
    """(pref, suf) [..., M, M+1]: pref[m] = ESF({0..m-1}), suf[m] =
    ESF({m+1..M-1})."""
    return _esf_scans(log_lambda, lam_mask)[1:]


def log_esf_omit(log_lambda, lam_mask):
    """ESF with each measurement omitted, esfd[..., m, k] = e_k({lambda_n :
    n != m}) for k < M: the polynomial product of pref[m] and suf[m] as a
    max-subtracted linear convolution (one max per row m, so an order whose
    dominant term sits ~88 nats below the row's peak underflows to LOG0,
    as in the JAX version)."""
    M = log_lambda.shape[-1]
    pref, suf = log_esf_prefix_suffix(log_lambda, lam_mask)
    pmax = torch.amax(pref, dim=-1, keepdim=True)
    smax = torch.amax(suf, dim=-1, keepdim=True)
    pl = torch.exp(pref - pmax)
    sl = torch.exp(suf - smax)
    dev = log_lambda.device
    ki = torch.arange(M, device=dev)[:, None] \
        - torch.arange(M + 1, device=dev)[None, :]         # [k, i]
    shifted = torch.where(ki >= 0, sl[..., ki.clamp(0, M)], 0.0)
    esfd_lin = torch.einsum("...mki,...mi->...mk", shifted, pl)
    return safe_log(esfd_lin) + pmax + smax


# ----------------------------------------------------------------------------
# Psi terms
# ----------------------------------------------------------------------------

def psi_terms(consts: CphdConstants, log_esf_full, log_esfd, log_cn_predict,
              log_ip_qdw, log_wsum, n_measure, z_mask, pref_suf=None):
    """Vo's Psi0 / Psi1 terms and their inner products with the predicted
    cardinality, batched over leading axes.

    log_esf_full [..., M+1]; log_esfd [..., M, M] (or None with
    ``pref_suf`` = (pref, suf) [..., M, M+1], the fused route: the omitted
    ESF grid is consumed only through the per-measurement inner product,
    taken as one Toeplitz-of-H product against the suffix rows);
    log_cn_predict [..., C+1]; log_ip_qdw, log_wsum [...]; n_measure the
    number of valid measurements; z_mask [M].

    Returns (log_psi0 [..., C+1], log_ip_psi0 [...], log_ip_psi1 [...],
    log_ip_psi1d [..., M]).
    """
    lf, lb, lcc = consts.log_factorial, consts.log_binom, \
        consts.log_cn_clutter
    C1 = lf.shape[0]
    Mp1 = log_esf_full.shape[-1]
    dtype, dev = log_esf_full.dtype, log_esf_full.device
    n = torch.arange(C1, dtype=dtype, device=dev)[:, None]   # cardinality
    j = torch.arange(Mp1, dtype=dtype, device=dev)[None, :]  # ESF order
    nm = torch.as_tensor(n_measure, device=dev).to(dtype)
    lw = log_wsum[..., None, None]
    lq = log_ip_qdw[..., None, None]
    rows = torch.arange(C1, device=dev)[:, None]

    def log_perm(order):
        # log P(n, order) = log C(n, order) + log order!
        oi = order.to(torch.int32).clamp(0, C1 - 1).long()
        return lb[rows, oi] + lf[oi]

    # aux(n, j) = (M-j)! + cn_clutter[M-j] + esf[j] - n log_wsum
    mj = (nm - j).to(torch.int32).clamp(0, C1 - 1).long()
    aux = lf[mj] + lcc[mj] + log_esf_full[..., None, :] - n * lw
    valid_j = j <= torch.minimum(n, nm)

    tmp0 = aux + log_perm(j) + (n - j) * lq
    log_psi0 = masked_logsumexp(tmp0, valid_j, dim=-1)
    tmp1 = aux + log_perm(j + 1.0) + (n - (j + 1.0)) * lq
    log_psi1 = masked_logsumexp(tmp1, valid_j & ((j + 1.0) <= n), dim=-1)

    log_ip_psi0 = logsumexp(log_psi0 + log_cn_predict, dim=-1)
    log_ip_psi1 = logsumexp(log_psi1 + log_cn_predict, dim=-1)

    # psi1 detection terms per omitted measurement, separable as
    # ip1d[m] = logsum_j esfd[m, j] + H(j), H(j) = logsum_{n >= j+1}
    # G(n, j) + cn_predict(n), G independent of m
    M = z_mask.shape[-1]
    jd = torch.arange(M, dtype=dtype, device=dev)[None, :]   # [1, M]
    mjd = (nm - jd - 1.0).to(torch.int32).clamp(0, C1 - 1).long()
    g = lf[mjd] + lcc[mjd] - n * lw + log_perm(jd + 1.0) \
        + (n - (jd + 1.0)) * lq                              # [..., C+1, M]
    h = masked_logsumexp(g + log_cn_predict[..., :, None],
                         (jd + 1.0) <= n, dim=-2)            # [..., M]
    valid_jd = jd[0] <= nm - 1.0                             # [M]
    if pref_suf is not None:
        pref, suf = pref_suf                                 # [..., M, M+1]
        hm = torch.where(valid_jd, h, LOG0)
        hmax = torch.amax(hm, dim=-1, keepdim=True)
        h_lin = torch.exp(hm - hmax)                         # [..., M]
        Mp1_ = pref.shape[-1]
        ar = torch.arange(Mp1_, device=dev)
        idx = ar[:, None] + ar[None, :]
        Hmat = torch.where(idx <= M - 1, h_lin[..., idx.clamp(0, M - 1)],
                           0.0)                              # [..., M+1, M+1]
        pmax = torch.amax(pref, dim=-1, keepdim=True)        # [..., M, 1]
        smax = torch.amax(suf, dim=-1, keepdim=True)
        G = torch.exp(suf - smax) @ Hmat                     # [..., M, M+1]
        lin = torch.sum(torch.exp(pref - pmax) * G, dim=-1)
        log_ip_psi1d = safe_log(lin) + pmax[..., 0] + smax[..., 0] + hmax
    else:
        log_ip_psi1d = masked_logsumexp(log_esfd + h[..., None, :],
                                        valid_jd[None, :], dim=-1)
    log_ip_psi1d = torch.where(z_mask, log_ip_psi1d, LOG0)
    return log_psi0, log_ip_psi0, log_ip_psi1, log_ip_psi1d


# ----------------------------------------------------------------------------
# The update
# ----------------------------------------------------------------------------

def _cphd_update_pre(pose, mean, cov, weight, z, z_mask, consts,
                     cfg: SlamConfig):
    """Pre-merge half of the CPHD update for all particles (the JAX
    version's ``_cphd_update_single``, batched over P): classes, EKF
    pre-update, lambdas, ESF and Psi terms, the updated cardinality, the
    scaled weights and the merge candidates of the route. Returns a dict:
    either ``gather`` (the capped routes: deferred-gather dict) or
    ``packed`` (full-grid planes [P, 7, K + M K]), with log_cn [P, C+1],
    dlog_w [P], out_m [P, K], n_compact [P] and compat [P, M]."""
    route = update_route(cfg, mean.shape[1], z.shape[0])
    # three spans in a row (the profile gives each device op to one span)
    with profiling.span("cphd.pre"):
        pre = _pre_lambdas(pose, mean, cov, weight, z, z_mask, cfg,
                           route == "det")
    with profiling.span("cphd.card"):
        card = _card_terms(pre, z_mask, consts)
    with profiling.span("cphd.pre"):
        return _candidates(pre, card, mean, cov, weight, z, cfg, route)


def _pre_lambdas(pose, mean, cov, weight, z, z_mask, cfg: SlamConfig,
                 det_route):
    """Classes, EKF pre-update, the per-measurement log lambdas (from the
    detect kernel's row sums on the det route, from the [P, M, K] grid of
    partial log-weights otherwise), compatibility and the in-range sums."""
    dtype = mean.dtype
    pose_b = pose[:, None, :]
    T = cfg.detection_topk

    cls = measurement.classify_in_range(pose_b, mean, weight, cfg)
    in_m = cls == measurement.IN_RANGE
    near_m = cls == measurement.NEARLY_IN_RANGE
    out_m = (cls == measurement.OUT_OF_RANGE) & (weight > 0)
    pre = ekf.ekf_preupdate(pose_b, mean, cov, cfg)
    det_valid = z_mask[:, None] & in_m[:, None, :]           # [P, M, K]
    log_kr = safe_log(_f32(cfg.clutter_rate, mean))
    log_kd = safe_log(_f32(cfg.clutter_density, mean))
    out = dict(in_m=in_m, near_m=near_m, out_m=out_m, ekf=pre,
               det_valid=det_valid, log_kr=log_kr, log_kd=log_kd)
    if det_route:
        # min_fw = 0, cb = 0: the row sums are the lambda numerators
        z4 = torch.stack([z[:, 0], z[:, 1], z_mask.to(dtype),
                          torch.zeros_like(z[:, 0])], dim=1)
        out["det"] = detect(_detection_planes(in_m, pre, weight), z4, T,
                            0.0, 0.0, adaptive=bool(cfg.detect_adaptive))
        log_lambda = safe_log(out["det"][2]) + log_kr - log_kd
    else:
        out["logw_part"] = torch.where(
            det_valid, ekf.ekf_detection_logw(pre, weight, z)[0], LOG0)
        log_lambda = masked_logsumexp(out["logw_part"], det_valid, dim=-1) \
            + log_kr - log_kd
    out["log_lambda"] = torch.where(z_mask, log_lambda, LOG0)   # [P, M]

    # compatibleZ: a measurement with an in-range feature within
    # gate_threshold (measurement-space Mahalanobis) births nowhere
    if cfg.gate_births:
        ir_g = z[:, None, 0] - pre.r[:, None, :]
        ib_g = wrap_angle(z[:, None, 1] - pre.bearing[:, None, :])
        dist_g = (pre.si00[:, None, :] * ir_g * ir_g
                  + 2.0 * pre.si01[:, None, :] * ir_g * ib_g
                  + pre.si11[:, None, :] * ib_g * ib_g)
        out["compat"] = torch.any(
            det_valid & (dist_g < cfg.gate_threshold), dim=-1)
    else:
        out["compat"] = None

    # qdw = log(1 - pd) + log w per in-range feature
    log_qdw = torch.where(in_m, safe_log(1.0 - pre.pd) + safe_log(weight),
                          LOG0)
    out["log_ip_qdw"] = masked_logsumexp(log_qdw, in_m, dim=-1)
    out["w_sum"] = torch.where(in_m, weight, 0.0).sum(dim=-1)
    out["log_wsum"] = safe_log(out["w_sum"])
    return out


def _card_terms(pre, z_mask, consts: CphdConstants):
    """ESF scans, the predicted in-range cardinality ~ Poisson(sum w), the
    Psi inner products and the updated, normalized log cardinality.
    Returns (log_cn [P, C+1], ip0 [P], ip1 [P], ip1d [P, M])."""
    log_lambda = pre["log_lambda"]
    P, M = log_lambda.shape
    esf_full, pref, suf = _esf_scans(log_lambda, z_mask.expand(P, M))
    ncard = torch.arange(consts.log_factorial.shape[0],
                         dtype=log_lambda.dtype, device=log_lambda.device)
    log_cn_predict = ncard * pre["log_wsum"][:, None] \
        - pre["w_sum"][:, None] - consts.log_factorial
    log_psi0, ip0, ip1, ip1d = psi_terms(
        consts, esf_full, None, log_cn_predict, pre["log_ip_qdw"],
        pre["log_wsum"], z_mask.sum(), z_mask, pref_suf=(pref, suf))
    log_cn = log_cn_predict + log_psi0 - ip0[:, None]
    return log_cn - logsumexp(log_cn, dim=-1)[:, None], ip0, ip1, ip1d


def _candidates(pre, card, mean, cov, weight, z, cfg: SlamConfig, route):
    """The CPHD-scaled weights and the merge candidates of ``route``
    (``filters/phd.py::update_route``)."""
    P, K, D = mean.shape
    M = z.shape[0]
    dev = mean.device
    T = cfg.detection_topk
    min_fw = cfg.min_feature_weight
    in_m, near_m, ekf_pre = pre["in_m"], pre["near_m"], pre["ekf"]
    log_cn, ip0, ip1, ip1d = card
    # non-detections: w exp(ip1 - ip0) (1 - pd), the configured pd as the
    # reference has it
    w_nd = torch.where(in_m, weight * torch.exp(ip1 - ip0)[:, None]
                       * (1.0 - cfg.pd), 0.0)
    act_a = (in_m & (w_nd >= min_fw)) | near_m
    w_a = torch.where(in_m, w_nd, torch.where(near_m, weight, 0.0))
    out = dict(log_cn=log_cn, dlog_w=ip0, out_m=pre["out_m"],
               compat=pre["compat"])

    if route == "det":
        # the scale exp(ip1d - ip0) kr / kd is uniform per measurement, so
        # the kernel's top-T by pdw is the top-T by w_det; threshold after
        # scaling. The kernel counts pdw > 0 lanes, so n_live_d may
        # overcount, as in the JAX version.
        vals_p, idx_d, _, count_d = pre["det"]
        scale = torch.exp(ip1d - ip0[:, None]) \
            * (cfg.clutter_rate / cfg.clutter_density)       # [P, M]
        vals_d = vals_p * scale[..., None]
        act_sel = (vals_d >= min_fw) & (vals_p > 0)
        n_extra = count_d.sum(dim=1) - torch.clamp_max(count_d, T).sum(dim=1)
        m_ids = torch.arange(M, dtype=torch.int64, device=dev)
        flat_d = K + m_ids[:, None] * K + idx_d.to(torch.int64)
        red_w = torch.cat([w_a, torch.where(act_sel, vals_d, 0.0)
                           .reshape(P, M * T)], dim=1)
        red_act = torch.cat([act_a, act_sel.reshape(P, M * T)], dim=1)
        red_flat = torch.cat([
            torch.arange(K, dtype=torch.int64, device=dev).expand(P, K),
            flat_d.reshape(P, M * T)], dim=1)
        idx, cand_w, cand_act, n_drop = topcap_sort(
            red_w, red_act, red_flat, cfg.merge_candidate_cap)
        out.update(gather=deferred_gather(idx, cand_w, cand_act, mean, cov,
                                          ekf_pre, z, None, None),
                   n_compact=n_drop + n_extra)
        return out
    det_valid = pre["det_valid"]
    w_det = torch.where(det_valid, torch.exp(
        pre["logw_part"] + ip1d[..., None] - ip0[:, None, None]
        + pre["log_kr"] - pre["log_kd"]), 0.0)
    act_b = det_valid & (w_det >= min_fw)
    if route == "topk":
        idx, cand_w, cand_act, n_compact = topk_compact_indices(
            torch.cat([w_a, w_det.reshape(P, M * K)], dim=1),
            torch.cat([act_a, act_b.reshape(P, M * K)], dim=1),
            cfg.merge_candidate_cap)
        out.update(gather=deferred_gather(idx, cand_w, cand_act, mean, cov,
                                          ekf_pre, z, None, None),
                   n_compact=n_compact)
    else:
        out.update(
            packed=full_grid_planes(
                [w_a, w_det], [act_a, act_b],
                [mean, ekf.ekf_detection_means(ekf_pre, mean, z)],
                [cov, ekf_pre.cov_upd[:, None].expand(P, M, K, D, D)]),
            n_compact=torch.zeros((P,), dtype=torch.int64, device=dev))
    return out


def add_births(gm: GMState, pose, z, z_mask, cfg: SlamConfig, allowed=None):
    """Append a birth Gaussian of weight birth_weight for each measurement
    (``allowed`` [P, M] gates them per particle), keeping the K heaviest
    components: one stable sort of -w (ties in slot order, as lax.top_k)
    carrying the planes. Returns (GMState, overflow [P])."""
    P, K, D = gm.mean.shape
    M = z.shape[0]
    b_mean, b_cov = measurement.birth_mean_cov(pose[:, None, :], z, cfg)
    b_w = torch.where(z_mask, cfg.birth_weight, 0.0).to(gm.weight.dtype)
    b_w = b_w.expand(P, M)
    if allowed is not None:
        b_w = torch.where(allowed, b_w, 0.0)
    eye = torch.eye(D, dtype=gm.mean.dtype, device=gm.mean.device)
    b_mean = torch.where(z_mask[None, :, None], b_mean, 0.0)
    b_cov = torch.where(z_mask[None, :, None, None], b_cov, eye)

    all_w = torch.cat([gm.weight, b_w], dim=1)
    pairs = [(a, b) for a in range(D) for b in range(a, D)]
    planes = [torch.cat([gm.mean[..., i], b_mean[..., i]], dim=1)
              for i in range(D)]
    planes += [torch.cat([gm.cov[..., a, b], b_cov[..., a, b]], dim=1)
               for a, b in pairs]
    neg_s, order = torch.sort(-all_w, dim=-1, stable=True)
    got = torch.gather(torch.stack(planes, dim=1), 2,
                       order[:, None, :K].expand(P, len(planes), K))
    new_w = torch.clamp_min(-neg_s[:, :K], 0.0)
    empty = new_w <= 0
    new_mean = torch.where(empty[..., None], 0.0,
                           torch.stack([got[:, i] for i in range(D)], dim=-1))
    full = [[None] * D for _ in range(D)]
    for i, (a, b) in enumerate(pairs):
        full[a][b] = full[b][a] = got[:, D + i]
    new_cov = torch.stack([torch.stack(row, dim=-1) for row in full], dim=-2)
    new_cov = torch.where(empty[..., None, None], eye, new_cov)
    new_w = torch.where(empty, 0.0, new_w)
    overflow = torch.clamp_min((all_w > 0).sum(dim=1) - K, 0)
    return GMState(mean=new_mean, cov=new_cov, weight=new_w), overflow


def cphd_update(state: FilterState, z, z_mask, consts: CphdConstants,
                cfg: SlamConfig, mesh=None):
    """CPHD measurement update over all particles, birth injection for the
    next scan and the cardinality convolution with the binomial birth
    cardinality. On a particle ``mesh`` the state is this rank's block,
    its weights normalized over every rank's. Returns (state,
    overflow)."""
    gm = state.map_static
    K, M = gm.mean.shape[-2], z.shape[0]
    check_supported(cfg, K, M)
    pre = _cphd_update_pre(state.pose, gm.mean, gm.cov, gm.weight, z,
                           z_mask, consts, cfg)
    if "gather" in pre:
        mg = gather_merge(pre["gather"], 2, cfg, K, has_birth=False,
                          tiles=tile_route(cfg, 2, K, M, births=False),
                          mesh=mesh)
    else:
        mg = merge_full_grid(pre["packed"], cfg, K)
    with profiling.span("phd.post"):
        new_mean, new_cov, new_w, dlog_w, overflow = _post_compact_batched(
            mg, pre, gm.mean, gm.cov, gm.weight, cfg)
        log_w = normalize_log_weights(state.log_weight + dlog_w, mesh)

    with profiling.span("cphd.births"):
        # births from this scan feed the next update; gated births only
        # from measurements no in-range feature is compatible with
        allowed = (z_mask[None, :] & ~pre["compat"] if cfg.gate_births
                   else None)
        new_gm, b_overflow = add_births(
            GMState(mean=new_mean, cov=new_cov, weight=new_w), state.pose, z,
            z_mask, cfg, allowed=allowed)
        log_cn = pre["log_cn"]
        dtype, dev = log_cn.dtype, log_cn.device
        if cfg.gate_births:
            # the binomial n is each particle's gated count
            cn_birth = binomial_birth_cardinality(
                allowed.sum(dim=1), cfg.birth_weight, cfg.max_cardinality,
                dtype, dev)
            log_cn = cardinality_predict(log_cn, cn_birth)
        else:
            cn_birth = binomial_birth_cardinality(
                z_mask.sum(), cfg.birth_weight, cfg.max_cardinality, dtype,
                dev)
            log_cn = cardinality_predict_batch(log_cn, cn_birth)
    state = state.replace(map_static=new_gm, log_weight=log_w,
                          cardinality=log_cn)
    return state, max_over_particles(overflow, mesh) \
        + max_over_particles(b_overflow, mesh)
