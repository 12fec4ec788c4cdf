"""Auxiliary filter estimators (port of ``phdslam_tpu/filters/extras.py``):
the EAP expected map, the Monte-Carlo map variance and single-feature
(scheme-2) particle weighting, batched over the particle axis.

- EAP expected map (map_estimate bit 1): the particle-weight-scaled maps
  of all particles reduced by greedy merges, either flat (one merge over
  all P K lanes, for P <= 2) or as a log2(P)-level pairwise tree whose
  every level is one sorted-mode merge launch over P/2 particle pairs
  (merge2d; merge4d for the dynamic-only 4D map). The lanes stay as merge
  planes [B, 7, N] (w, act, mean x, y, cov 00, 01, 11; [B, 16, N] at
  D = 4) from start to finish.
- MC map variance (compute_variance): draw one sample from each
  component, evaluate the component at it, sum ``val`` over non-detection
  lanes and ``val (1 - val)`` over detection and birth lanes, averaged
  over n_samples draws. The draws come from ``draw(s, shape)``, a source
  that returns sample s (the runner backs it with its own generator, a
  test with the JAX version's keys); one sample is held at a time. The
  value at a component's own sample is taken in closed form, with the
  determinant in float64: the f32 arithmetic of the JAX version loses up
  to ~1e-2 of it on thin covariances.
- Single-feature weighting (particle_weighting 2): the predicted and
  updated maps evaluated at the updated mean of the (measurement,
  feature) lane with the largest single-object likelihood, scaled by the
  single-feature RB factor.
"""

from __future__ import annotations

import math

import torch

from ..config import SlamConfig
from ..kernels.merge import merge2d, merge4d
from ..ops.gm_merge import MERGE_DIMS, merge_out, pack_planes
from ..ops.math import det_nd, gaussian_logpdf, safe_log
from ..types import GMState


def merge_planes(w, mean, cov):
    """Merge planes [B, 2 + D + D(D+1)/2, N] of weights [B, N], means
    [B, N, D] and covariances [B, N, D, D] (D = 2: [B, 7, N]; 4: the
    dynamic-only map's [B, 16, N]): lanes with w > 0 are active, the
    others sanitized to (w 0, mean 0, identity covariance)."""
    act = w > 0
    eye = torch.eye(mean.shape[-1], dtype=mean.dtype, device=mean.device)
    return pack_planes(torch.where(act[..., None], mean, 0.0),
                       torch.where(act[..., None, None], cov, eye),
                       torch.where(act, w, 0.0), act)


def _merge(planes, cfg: SlamConfig, cap, sorted_w=True):
    """One merge launch over EAP planes: merge2d in either mode at D = 2;
    at D = 4 merge4d on weight-sorted lanes (the lanes sorted first where
    they are not), which picks the principals an argmax merge picks.
    Returns the merge tuple."""
    D = MERGE_DIMS[planes.shape[1]]
    sep, metric = float(cfg.min_separation), cfg.distance_metric
    if D == 2:
        return merge_out(merge2d(planes, sep, cap, sorted_w=sorted_w,
                                 metric=metric), 2)
    if not sorted_w:
        planes = sort_lanes_desc(planes)
    return merge_out(merge4d(planes, sep, cap, metric=metric), D)


def _scaled_planes(gm: GMState, log_weight):
    """Every particle's map scaled by its weight, as planes [P, 7, K]."""
    return merge_planes(torch.exp(log_weight)[:, None] * gm.weight, gm.mean,
                        gm.cov)


def eap_expected_map_flat(gm: GMState, log_weight, cfg: SlamConfig,
                          out_cap=None):
    """Expected a-posteriori map, flat form: one greedy merge (argmax
    principal, as the JAX version's XLA ``gm_merge``) over the particle-
    weight-scaled concatenation of all P K lanes, as one merge row.
    Returns (mean [out_cap, D], cov, weight)."""
    return _flat(_scaled_planes(gm, log_weight), cfg,
                 out_cap or gm.mean.shape[1])


def _flat(planes, cfg: SlamConfig, out_cap):
    """The flat form's merge of every particle's planes [P, C, K]."""
    P, C, K = planes.shape
    flat = planes.transpose(0, 1).reshape(1, C, P * K)
    mean, cov, w, _, _ = _merge(flat, cfg, out_cap, sorted_w=False)
    return mean[0], cov[0], w[0]


def sort_lanes_desc(planes):
    """Planes [B, C, N] (w, act, payload) with every row's lanes
    weight-descending: one stable sort on -w carrying the payload planes
    (ties keep lane order, as ``lax.sort`` does; every inactive lane holds
    w = 0, so -w = -0.0 throughout and they tie). act is re-derived as
    w > 0. The JAX version's ``_sort_lanes_desc`` on the plane layout."""
    B, C, N = planes.shape
    neg_s, order = torch.sort(-planes[:, 0], dim=-1, stable=True)
    w = torch.clamp_min(-neg_s, 0.0)
    rest = torch.gather(planes[:, 2:], 2,
                        order[:, None, :].expand(B, C - 2, N))
    return torch.cat([w[:, None], (w > 0).to(w.dtype)[:, None], rest],
                     dim=1)


def eap_expected_map(gm: GMState, log_weight, cfg: SlamConfig,
                     out_cap=None, return_dropped: bool = False, mesh=None):
    """Expected a-posteriori map via the log2(P)-level pairwise tree.

    Each level pairs particles 2i and 2i + 1 ([Pl, 7, L] -> [Pl/2, 2, 7,
    L] -> [Pl/2, 7, 2L], the first particle's lanes first: a permute, not
    a reshape of the planes), sorts each pair's 2L lanes weight-descending
    and merges them back to ``cfg.eap_tree_cap`` (default K) clusters with
    one sorted-mode merge2d launch (Mahalanobis or Hellinger,
    ``cfg.distance_metric``); the last level merges to ``out_cap``
    (default K). An odd level gets one empty map (w 0, mean 0, identity
    covariance) as its last pair's second half. P <= 2 takes the flat
    form. Fixed-capacity levels can drop the lightest clusters of a pair;
    ``return_dropped`` adds their count over all levels as a 4th output.

    On a particle ``mesh`` ``gm`` and ``log_weight`` are this rank's block
    of b particles. When b is a power of two the first log2(b) levels pair
    particles inside the block and run on the rank; the ranks then gather
    their one reduced map each and finish the last levels identically.
    Otherwise every rank gathers the scaled planes and runs the tree
    unchanged. Either way every rank returns the unsharded tree's map.

    Returns (mean [out_cap, D], cov, weight[, n_dropped]).
    """
    P, K, _ = gm.mean.shape
    size = 1 if mesh is None else mesh.size
    out_cap = out_cap or K
    mid_cap = cfg.eap_tree_cap or K
    planes = _scaled_planes(gm, log_weight)
    n_dropped = torch.zeros((), dtype=torch.int64, device=gm.mean.device)
    if size > 1:
        if P * size > 2 and P & (P - 1) == 0:
            planes, _, n_dropped = _tree(planes, cfg, out_cap, mid_cap,
                                         scale=size)
            n_dropped = mesh.all_gather(n_dropped[None]).sum()
        planes = mesh.all_gather(planes)
    if P * size <= 2:
        out = _flat(planes, cfg, out_cap)
    else:
        _, (mean, cov, w), drop = _tree(planes, cfg, out_cap, mid_cap)
        n_dropped = n_dropped + drop
        out = (mean[0], cov[0], w[0])
    return out + (n_dropped,) if return_dropped else out


def _tree(planes, cfg: SlamConfig, out_cap, mid_cap, scale=1):
    """The pairwise tree's levels on planes [Pl, C, L] down to one row,
    merging to ``out_cap`` at the level of 2 x ``scale`` particles (the
    whole tree's last) and to ``mid_cap`` before it. Returns (planes, the
    last merge's (mean, cov, w), the clusters dropped)."""
    n_dropped = torch.zeros((), dtype=torch.int64, device=planes.device)
    last = None
    while planes.shape[0] > 1:
        Pl, C, L = planes.shape
        if Pl % 2:
            D = MERGE_DIMS[C]
            empty = merge_planes(
                planes.new_zeros((1, 1)), planes.new_zeros((1, 1, D)),
                torch.eye(D, dtype=planes.dtype,
                          device=planes.device).expand(1, 1, D, D))
            planes = torch.cat([planes, empty.expand(1, C, L)])
            Pl += 1
        planes = planes.view(Pl // 2, 2, C, L).transpose(1, 2) \
            .reshape(Pl // 2, C, 2 * L)
        cap = out_cap if Pl * scale == 2 else mid_cap
        mean, cov, w, _, drop = _merge(sort_lanes_desc(planes), cfg, cap)
        n_dropped = n_dropped + drop.sum()
        planes = merge_planes(w, mean, cov)
        last = (mean, cov, w)
    return planes, last, n_dropped


def _peak_values(weight, cov):
    """w N(m; m, P) = w / sqrt((2 pi)^D det P) per lane, the determinant
    taken in float64 from the f32 entries and floored at 1e-30: a thin
    covariance (c00 c11 / det up to ~3e4 in real steps) loses most of an
    f32 determinant to cancellation."""
    D = cov.shape[-1]
    det = torch.clamp_min(det_nd(cov.double()), 1e-30)
    return (weight.double() / torch.sqrt((2.0 * math.pi) ** D * det)) \
        .to(weight.dtype)


def _mc_mean(pref, is_nd, live, n_samples, sq_norm):
    """The estimator's average over samples: component values at their
    own samples, pref exp(-|eps|^2 / 2) (a point drawn as m + L eps, L L'
    = P, lies at Mahalanobis distance |eps|^2 from m under P, so neither
    the sample nor an inverse is formed), ``val`` on non-detection lanes
    and ``val (1 - val)`` elsewhere, live lanes only, summed over lanes.
    ``sq_norm(s)`` [P, N]: |eps|^2 of sample s. Returns [P]."""
    acc = torch.zeros(pref.shape[0], dtype=pref.dtype, device=pref.device)
    for s in range(n_samples):
        val = pref * torch.exp(-0.5 * sq_norm(s))
        contrib = torch.where(is_nd, val, val * (1.0 - val))
        acc = acc + torch.where(live, contrib, 0.0).sum(dim=-1)
    return acc / n_samples


def map_variance(gm: GMState, n_nondetect, n_samples, draw):
    """MC map-variance estimate per particle over a map's components: the
    first ``n_nondetect`` slots count as non-detection terms (``val``),
    the rest as detection / birth terms (``val (1 - val)``), averaged over
    ``n_samples`` draws; sample s is ``draw(s, (P, K, D))``. Returns [P].
    """
    P, K, _ = gm.mean.shape
    is_nd = (torch.arange(K, device=gm.mean.device) < n_nondetect) \
        .expand(P, K)
    return _mc_mean(_peak_values(gm.weight, gm.cov), is_nd, gm.weight > 0,
                    n_samples,
                    lambda s: (draw(s, gm.mean.shape) ** 2).sum(dim=-1))


def mc_variance_candidates(mean, cov, weight, n_nondetect, n_samples, draw):
    """MC variance per particle over the full candidate grid before
    compaction (layout [K non-detections | M K detections | M births]):
    mean [P, N, D], cov [P, N, D, D], weight [P, N] (inactive lanes
    sanitized to w 0, mean 0, identity covariance); sample s is
    ``draw(s, (P, N, D))``, one held at a time. The JAX version evaluates
    each sample x = m + L eps (L the Cholesky factor of P + 1e-9 I) under
    N(x; m, P), rounding x at the mean's magnitude and subtracting m back;
    here the value at the sample is taken in closed form
    (:func:`_mc_mean`). Returns [P]."""
    P, N, _ = mean.shape
    is_nd = (torch.arange(N, device=mean.device) < n_nondetect).expand(P, N)
    return _mc_mean(_peak_values(weight, cov), is_nd, weight > 0, n_samples,
                    lambda s: (draw(s, mean.shape) ** 2).sum(dim=-1))


def mc_variance_packed(packed, is_nd, n_samples, draw):
    """MC variance per particle over the selected candidate lanes, packed
    planes [P, 7, N] (``filters/phd.py::_finish_candidates_packed``), as
    :func:`mc_variance_candidates` over those lanes. ``is_nd`` [P, N]:
    persistent (non-detection) lanes; sample s is ``draw(s, (2, P, N))``,
    one held at a time. Returns [P]."""
    w = packed[:, 0]
    cov = torch.stack([torch.stack([packed[:, 4], packed[:, 5]], dim=-1),
                       torch.stack([packed[:, 5], packed[:, 6]], dim=-1)],
                      dim=-2)

    def sq_norm(s):
        eps = draw(s, (2,) + tuple(w.shape))
        return eps[0] ** 2 + eps[1] ** 2
    return _mc_mean(_peak_values(w, cov), is_nd,
                    (packed[:, 1] > 0.5) & (w > 0), n_samples, sq_norm)


def eval_gm(gm_mean, gm_cov, gm_weight, x):
    """v(x) = sum_j w_j N(x; m_j, P_j) per particle: maps [P, K, ...],
    x [P, D] -> [P]."""
    val = gm_weight * torch.exp(gaussian_logpdf(x[:, None, :], gm_mean,
                                                gm_cov))
    return torch.where(gm_weight > 0, val, 0.0).sum(dim=-1)


def single_feature_dlogw_point(max_like, x_star, m_valid,
                               pred_mean, pred_cov, pred_w,
                               upd_mean, upd_cov, upd_w, cfg: SlamConfig):
    """Scheme-2 log-weight increment per particle from the located argmax
    lane: the predicted and merged-updated maps evaluated at ``x_star``
    [P, D] and scaled by the single-feature RB factor. ``max_like`` [P]:
    the largest single-object likelihood (linear); ``m_valid`` [P]: the
    measurement count the factor uses. Returns [P]."""
    cn_predict = pred_w.sum(dim=-1)
    cn_update = upd_w.sum(dim=-1)
    v_predict = eval_gm(pred_mean, pred_cov, pred_w, x_star)
    v_update = eval_gm(upd_mean, upd_cov, upd_w, x_star)
    cd = cfg.clutter_density
    a = (1.0 - cfg.pd) * cd * m_valid \
        + cfg.pd * m_valid * ((m_valid - 1.0) * cd * max_like)
    b = torch.exp(cn_update - cn_predict - cfg.clutter_rate)
    return safe_log((a * v_predict) / torch.clamp_min(b * v_update, 1e-30))


def single_feature_argmax(log_like, mean_det, det_valid):
    """The grid search of scheme 2 over every (measurement, feature) lane:
    log_like [P, M, K], mean_det [P, M, K, D], det_valid [P, M, K] ->
    (max_like [P], x_star [P, D], m_valid [P]: measurements with a valid
    lane). Ties go to the first lane, as ``jnp.argmax``."""
    P, _, _, D = mean_det.shape
    m_valid = det_valid.any(dim=-1).sum(dim=-1).to(log_like.dtype)
    ll = torch.where(det_valid, log_like, -torch.inf).reshape(P, -1)
    flat = torch.argmax(ll, dim=-1)
    rows = torch.arange(P, device=ll.device)
    return (torch.exp(ll[rows, flat]), mean_det.reshape(P, -1, D)[rows, flat],
            m_valid)


def single_feature_dlogw(log_like, mean_det, det_valid,
                         pred_mean, pred_cov, pred_w,
                         upd_mean, upd_cov, upd_w, cfg: SlamConfig):
    """Scheme-2 log-weight increment per particle, grid form: the argmax
    search over the whole [M, K] likelihood grid
    (:func:`single_feature_argmax`), then
    :func:`single_feature_dlogw_point`. Returns [P]."""
    return single_feature_dlogw_point(
        *single_feature_argmax(log_like, mean_det, det_valid),
        pred_mean, pred_cov, pred_w, upd_mean, upd_cov, upd_w, cfg)
