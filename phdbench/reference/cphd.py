"""Plain PyTorch reference of one step of Rao-Blackwellized CPHD SLAM: Vo,
Vo & Cantoni's analytic CPHD recursion ("Analytic implementations of the
cardinalized probability hypothesis density filter", IEEE TSP 55(7), 2007)
on each particle's static 2D map, as the cuda-PHDSLAM code's CPHD update
runs it (src/phdfilter.cu.bak:2516-2543).

For each particle, with Z the scan's |Z| valid measurements:

- Ackerman prediction, the EKF quantities and the detection terms
  g_mk = pd w_k N(z_m; h(x_k), S_k) of every measurement and in-range
  feature, as :mod:`step` computes them;
- the lambdas L_m = (kr / kd) sum_k g_mk (kr the clutter rate, kd the
  clutter density);
- the elementary symmetric functions e_j(Z) of the lambdas, and e_j(Z \\
  z_m) of the lambdas with measurement m left out, by the recursion
  e_j <- e_j + L e_(j-1) in the log domain;
- the predicted cardinality p(n) = Poisson(n; W) of the in-range features'
  weight sum W; with Q = sum (1 - pd) w over them, pK the clutter
  cardinality Poisson(kr) and P(n, r) = n! / (n - r)!:
  Psi0(n) = sum_j (|Z| - j)! pK(|Z| - j) P(n, j) Q^(n - j) W^-n e_j(Z),
  Psi1(n) = sum_j (|Z| - j)! pK(|Z| - j) P(n, j + 1) Q^(n - j - 1) W^-n
  e_j(Z), Psi1(n; m) the same with |Z| - 1 and e_j(Z \\ z_m), and their
  inner products with p in the log domain, ip0, ip1 and ip1d[m];
- the updated cardinality p(n) Psi0(n) / <Psi0, p>, normalized;
- the non-detection weights w (1 - pd) exp(ip1 - ip0) of the in-range
  features (those nearly in range kept as they are), and the detection
  weights g_mk exp(ip1d[m] - ip0) kr / kd;
- the top-cap candidates, the greedy merge, the re-attachment of the
  features out of range and the compaction to K, as :mod:`step`;
- a birth of weight birth_weight at each measurement, the K heaviest
  components kept (ties to the map, then to the earlier measurement);
- the next step's cardinality: the updated one convolved with the births'
  binomial cardinality B(|Z|, birth_weight);
- the particle's log weight plus ip0, normalized, and the resampling, as
  :mod:`step`.

Departures from the equations, each the program's:

- the cardinality lives on 0..max_cardinality: the convolution's mass
  past it is dropped, and the next cardinality is not renormalized;
- the step's cardinality is predicted from W alone (the carried
  cardinality is the state's estimate, which the next update does not
  read);
- each measurement keeps the detection terms of its T heaviest features
  (``detection_topk``), and the merge takes the cap heaviest lanes;
- births enter after the merge, not as its candidates.

The sums over the cardinality and over the ESF orders are taken in the
log domain, Psi1(n; m)'s inner product as sum_j e_j(Z \\ z_m) H(j) with
H(j) = sum_n p(n) G(n, j) (its factor that does not depend on m), which
is the same sum reordered. Precision and blocks of particles as
:mod:`step`; ``q`` rounds each stage's result, and every step of the
ESF recursion.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from . import compare
from . import step as phd
from .step import (CONTROL_TF32, REFERENCE, Precision, compact,
                   feature_terms, grid_block, map_moments, wrap)

__all__ = ["CONTROL_TF32", "REFERENCE", "NAMES", "Settings", "as_outputs",
           "gaps", "init_gap", "initial_state", "step"]

# the numbers compared: the static PHD path's and the cardinality's
NAMES = compare.NAMES + ("card_rel",)


@dataclass
class Settings(phd.Settings):
    max_cardinality: int

    PATH = "the CPHD path on a static map, births not gated"
    EXPECT = dict(phd.Settings.EXPECT, filter_type=1, gate_births=0)


def initial_state(s: Settings, device="cpu") -> dict:
    """:func:`step.initial_state` and a uniform log cardinality over
    0..max_cardinality [P, C+1]."""
    st = phd.initial_state(s, device)
    C1 = s.max_cardinality + 1
    st["cardinality"] = torch.full((s.n_particles, C1), -math.log(C1),
                                   dtype=torch.float64, device=device)
    return st


def pow_log(k, log_x):
    """k log x, with x^0 = 1 where x = 0 (log x = -inf)."""
    return torch.where(k == 0, torch.zeros_like(log_x), k * log_x)


def log_esf(ll, q: Precision):
    """log e_0..e_N [..., N + 1] of the values exp(ll) [..., N] (-inf: a
    value of 0), one measurement a step."""
    e = torch.full((*ll.shape[:-1], ll.shape[-1] + 1), -math.inf,
                   dtype=ll.dtype, device=ll.device)
    e[..., 0] = 0.0
    for m in range(ll.shape[-1]):
        e = q(torch.cat([e[..., :1], torch.logaddexp(
            e[..., 1:], ll[..., m, None] + e[..., :-1])], -1))
    return e


def cardinality_terms(s: Settings, log_lambda, log_w, log_q, n_z: int,
                      q: Precision):
    """For a block [B]: the log inner products ip0 [B], ip1 [B] and ip1d
    [B, M] and the updated, normalized log cardinality [B, C+1], from the
    log lambdas [B, M] (-inf at an invalid measurement) and the log sums
    W, Q [B] of the in-range features. Each Psi's factor W^-n is taken
    into the predicted cardinality, p(n) W^-n = exp(-W) / n!, which stays
    finite where W = 0."""
    B, M = log_lambda.shape
    dt, dev = log_lambda.dtype, log_lambda.device
    lg = torch.lgamma
    C1 = s.max_cardinality + 1
    n = torch.arange(C1, dtype=dt, device=dev)[:, None]          # [C1, 1]
    j = torch.arange(M + 1, dtype=dt, device=dev)[None, :]       # [1, M+1]
    log_kr = math.log(s.clutter_rate)

    def log_perm(r):
        return torch.where(r <= n, lg(n + 1) - lg((n - r).clamp_min(0) + 1),
                           -math.inf)

    def clutter(k):
        # log (k! pK(k)) = k log kr - kr, for k >= 0
        return torch.where(k >= 0, k * log_kr - s.clutter_rate, -math.inf)

    lq = log_q[:, None, None]                                     # [B, 1, 1]
    log_p = q(-torch.exp(log_w)[:, None] - lg(n[:, 0] + 1))       # [B, C1]
    esf = log_esf(log_lambda, q)                                  # [B, M+1]
    # each measurement left out: its lambda set to 0 on the diagonal
    omit = log_lambda[:, None, :].expand(B, M, M).clone()
    omit.diagonal(dim1=1, dim2=2).fill_(-math.inf)
    esf_d = log_esf(omit, q)[..., :M]                             # [B, M, M]

    t0 = clutter(n_z - j) + log_perm(j) \
        + pow_log((n - j).clamp_min(0), lq) + esf[:, None, :]
    log_psi0 = q(torch.logsumexp(torch.where((j <= n_z) & (j <= n), t0,
                                             -math.inf), -1))    # [B, C1]
    t1 = clutter(n_z - j) + log_perm(j + 1) \
        + pow_log((n - j - 1).clamp_min(0), lq) + esf[:, None, :]
    log_psi1 = torch.logsumexp(torch.where(
        (j <= n_z) & (j + 1 <= n), t1, -math.inf), -1)
    ip0 = q(torch.logsumexp(log_p + log_psi0, -1))
    ip1 = q(torch.logsumexp(log_p + log_psi1, -1))
    # Psi1(n; m) = sum_j G(n, j) e_j(Z \ z_m): H(j) = sum_n p(n) G(n, j)
    jd = j[:, :M]
    g = clutter(n_z - 1 - jd) + log_perm(jd + 1) \
        + pow_log((n - jd - 1).clamp_min(0), lq)                  # [B, C1, M]
    h = torch.logsumexp(torch.where((jd <= n_z - 1) & (jd + 1 <= n),
                                    g + log_p[..., None], -math.inf), 1)
    ip1d = q(torch.logsumexp(esf_d + h[:, None, :], -1))          # [B, M]
    log_cn = log_p + log_psi0 - ip0[:, None]
    return ip0, ip1, ip1d, q(log_cn - torch.logsumexp(log_cn, -1,
                                                      keepdim=True))


def candidates(s: Settings, pose, mean, cov, weight, z, z_mask,
               q: Precision):
    """For a block of particles: the log-weight increment ip0 [B], the
    updated log cardinality [B, C+1] and the merge candidates, the
    heaviest ``merge_candidate_cap`` live lanes of [K persistent | M x T
    detections] by weight (ties to the earlier lane), as
    :func:`step.candidates` gives them."""
    B, K, _ = mean.shape
    M, T, cap = z.shape[0], s.detection_topk, s.merge_candidate_cap
    f = feature_terms(s, pose, mean, cov, weight, q)
    in_m, near = f["in_m"], f["near"]
    pd = torch.where(in_m, s.pd, 0.0).to(mean.dtype)
    innov_r = z[None, :, 0, None] - f["r"][:, None, :]          # [B, M, K]
    innov_b = wrap(z[None, :, 1, None] - f["bearing"][:, None, :])
    Si = f["S_inv"][:, None]
    d2 = Si[..., 0, 0] * innov_r ** 2 + 2.0 * Si[..., 0, 1] * innov_r \
        * innov_b + Si[..., 1, 1] * innov_b ** 2
    pref = pd * weight / (2.0 * math.pi * f["sqrt_det"])
    valid = z_mask[None, :, None] & in_m[:, None, :]
    pdw = q(torch.where(valid, pref[:, None, :] * torch.exp(-0.5 * d2), 0.0))
    kr_kd = s.clutter_rate / s.clutter_density
    lam = q(pdw.sum(-1) * kr_kd)                                 # [B, M]
    log_lambda = torch.where(z_mask & (lam > 0), torch.log(lam), -math.inf)
    w_in = torch.where(in_m, weight, 0.0)
    log_w = q(torch.log(w_in.sum(-1)))
    log_q = q(torch.log((w_in * (1.0 - s.pd)).sum(-1)))
    ip0, ip1, ip1d, log_cn = cardinality_terms(
        s, log_lambda, log_w, log_q, int(z_mask.sum()), q)

    # the T heaviest detection terms of each measurement, ties to the
    # lowest feature, scaled
    key = torch.where(pdw > 0, pdw, -1.0)
    top_g, top_k = torch.sort(key, dim=-1, descending=True, stable=True)
    top_g, top_k = top_g[..., :T], top_k[..., :T]               # [B, M, T]
    scale = torch.exp(ip1d - ip0[:, None]) * kr_kd               # [B, M]
    w_det = q(torch.where(top_g > 0, top_g * scale[..., None], 0.0))
    det_act = (top_g > 0) & (w_det >= s.min_feature_weight)
    rows = torch.arange(B, device=mean.device)[:, None, None]
    ir = innov_r.gather(-1, top_k)
    ib = innov_b.gather(-1, top_k)
    g = f["gain"][rows, top_k]                                  # [B, M, T, 2, 2]
    det_mean = q(mean[rows, top_k] + g[..., 0] * ir[..., None]
                 + g[..., 1] * ib[..., None])
    det_cov = f["cov_upd"][rows, top_k]

    # persistent lanes: the missed-detection copy of an in-range feature,
    # a nearly-in-range feature unchanged
    w_nd = q(weight * (1.0 - s.pd) * torch.exp(ip1 - ip0)[:, None])
    w_p = torch.where(in_m, w_nd, torch.where(near, weight, 0.0))
    act_p = (in_m & (w_nd >= s.min_feature_weight)) | near

    lane_w = torch.cat([w_p, w_det.reshape(B, M * T)], 1)
    lane_act = torch.cat([act_p, det_act.reshape(B, M * T)], 1)
    lane_mean = torch.cat([mean, det_mean.reshape(B, M * T, 2)], 1)
    lane_cov = torch.cat([cov, det_cov.reshape(B, M * T, 2, 2)], 1)
    key = torch.where(lane_act & (lane_w > 0), lane_w, -1.0)
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    order = order[:, :cap]
    rows = torch.arange(B, device=mean.device)[:, None]
    out_w = torch.where(~in_m & ~near & (weight > 0), weight, 0.0)
    return dict(dlog_w=ip0, log_cn=log_cn, ambiguous=f["ambiguous"],
                w=key.gather(1, order).clamp_min(0.0),
                mean=lane_mean[rows, order], cov=lane_cov[rows, order],
                out_w=out_w)


def birth_cardinality(s: Settings, n_z: int, dtype, device):
    """log B(k; n_z, birth_weight) over k = 0..max_cardinality."""
    k = torch.arange(s.max_cardinality + 1, dtype=dtype, device=device)
    p = s.birth_weight
    lg = torch.lgamma
    log_b = math.lgamma(n_z + 1.0) - lg(k + 1) \
        - lg((n_z - k).clamp_min(0) + 1) + k * math.log(p) \
        + (n_z - k) * math.log1p(-p)
    return torch.where(k <= n_z, log_b, -math.inf)


def predict_cardinality(log_cn, log_b):
    """log sum_(j <= n) B(n - j) c(j) over n = 0..C of log_cn [B, C+1]
    and log_b [C+1]."""
    C1 = log_cn.shape[-1]
    ar = torch.arange(C1, device=log_cn.device)
    d = ar[:, None] - ar[None, :]                                # [n, j]
    terms = torch.where(d >= 0, log_b[d.clamp_min(0)], -math.inf)
    return torch.logsumexp(terms + log_cn[:, None, :], -1)


def step(s: Settings, state: dict, z, z_mask, control, dt, do_predict,
         has_z, eps, u, q: Precision = REFERENCE,
         device: Optional[torch.device] = None) -> dict:
    """One CPHD step from ``state`` (:func:`initial_state`'s keys) on the
    draws eps [P, 2] and u [P]: :func:`step.step`'s results, with the
    maps' moments taken after the births, and ``cardinality`` [P, C+1],
    each particle's next log cardinality before resampling."""
    dev = device or state["pose"].device
    P = state["pose"].shape[0]

    def get(x):
        return q(x.to(dev))
    pose, lw = get(state["pose"]), get(state["log_weight"])
    z, z_mask = get(z), z_mask.to(dev)
    if do_predict:
        pose = phd.predict_pose(s, pose, control, float(dt), get(eps), q)
    moments = torch.zeros((P, 8), dtype=torch.float64, device=dev)
    ambiguous = torch.zeros((P,), dtype=torch.bool, device=dev)
    margin = torch.full((P,), math.inf, dtype=torch.float64, device=dev)
    tie = torch.zeros((P,), dtype=torch.bool, device=dev)
    scale = lw.abs()
    card = get(state["cardinality"])
    if has_z:
        K, B = s.max_features, grid_block(s, z.shape[0])
        parts = []
        for lo in range(0, P, B):
            sl = slice(lo, min(P, lo + B))
            parts.append(candidates(
                s, pose[sl], get(state["mean"][sl]), get(state["cov"][sl]),
                get(state["weight"][sl]), z, z_mask, q))
        cat = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        del parts
        # equal missed-detection weights (features of equal weight under
        # one factor a particle, as the births of a scan are) tie exactly
        o_w, o_mean, o_cov, margin, tie = phd.greedy_merge(
            cat["w"], cat["mean"], cat["cov"], s.min_separation, K, q,
            origin=pose[:, :2], exact_ties_agree=True)
        b_mean, b_cov = phd.births(s, pose, z, q)
        b_w = torch.where(z_mask, s.birth_weight, 0.0).to(lw.dtype)
        for lo in range(0, P, B):
            sl = slice(lo, min(P, lo + B))
            nw, nm, nc = compact(o_w[sl], o_mean[sl], o_cov[sl],
                                 get(state["mean"][sl]),
                                 get(state["cov"][sl]), cat["out_w"][sl], K)
            nw, nm, nc = compact(nw, nm, nc, b_mean[sl], b_cov[sl],
                                 b_w.expand(nw.shape[0], -1), K)
            moments[sl] = map_moments(nm, nc, nw)
        n_z = int(z_mask.sum())
        card = q(predict_cardinality(cat["log_cn"], birth_cardinality(
            s, n_z, cat["log_cn"].dtype, dev)))
        ambiguous = cat["ambiguous"]
        scale = torch.maximum(lw.abs(), cat["dlog_w"].abs())
        lw = lw + cat["dlog_w"]
        lw = q(lw - torch.logsumexp(lw, 0))
    else:
        for lo in range(0, P, 4096):
            sl = slice(lo, min(P, lo + 4096))
            moments[sl] = map_moments(state["mean"][sl].to(dev),
                                      state["cov"][sl].to(dev),
                                      state["weight"][sl].to(dev))
    return dict(pose=pose, log_weight=lw, moments=moments,
                ambiguous=ambiguous, merge_margin=margin, merge_tie=tie,
                has_z=bool(has_z), cardinality=card,
                scale=torch.maximum(scale, lw.abs()).clamp_min(1.0),
                **phd.resampling(s, pose, lw, u, has_z))


def card_gap(got, want):
    """Per particle: the L1 distance of two log cardinalities' pmfs
    [..., C+1] (a share of the reference's mass, which is 1 but for what
    the prediction dropped past max_cardinality)."""
    return (torch.exp(got.to(torch.float64))
            - torch.exp(want.to(torch.float64))).abs().sum(-1)


def gaps(s: Settings, got: dict, ref: dict) -> dict:
    """:func:`compare.gaps`, and ``card_rel``: each particle's cardinality
    after the step (``got["cardinality"]`` [P, C+1], after resampling)
    against the reference's particle of the same ancestor, the largest
    over the particles :func:`compare.gaps` does not leave out."""
    out = compare.gaps(s, got, ref)
    anc = got["ancestors"].to(ref["pose"].device, torch.int64)
    g = card_gap(got["cardinality"].to(anc.device), ref["cardinality"][anc])
    out["card_rel"] = float(torch.where(~ref["ambiguous"][anc], g, 0.0).max())
    return out


def init_gap(s: Settings, inp) -> float:
    """:func:`compare.init_gap` against this filter's prior."""
    return compare.init_gap(s, inp, initial_state(s))


def as_outputs(res: dict, q) -> dict:
    """:func:`compare.as_outputs`, with the cardinality at the ancestors."""
    out = compare.as_outputs(res, q)
    out["cardinality"] = res["cardinality"][out["ancestors"]]
    return out
