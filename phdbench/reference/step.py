"""Plain PyTorch reference of one step of Rao-Blackwellized GM-PHD SLAM.

It implements the path the benchmark's configurations run: Ackerman
vehicle prediction, the PHD update of a static 2D map (cluster-process
particle weighting, range-bearing EKF, the top-T detection lanes per
measurement, the global top-cap candidate selection, births from every
measurement), the greedy Mahalanobis merge of the selected candidates,
re-attachment of the features out of range and compaction to K, the
expected pose, the MAP particle and systematic resampling. It is written
from the filter's equations and imports nothing of the program under test.

Every tensor takes the precision ``Precision`` gives: float64 for the
reference, float32 with each stage's results rounded to TF32 (10 mantissa
bits) for the control. The [P, M, K] detection grid is formed in blocks of
particles so that it fits on one card; the merge runs over every particle
at once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32's 10 mantissa bits (to nearest, ties to
    even), as the tensor cores round their operands."""
    if x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


@dataclass(frozen=True)
class Precision:
    dtype: torch.dtype
    round: Callable[[torch.Tensor], torch.Tensor]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.round(x.to(self.dtype))


REFERENCE = Precision(torch.float64, lambda x: x)
CONTROL_TF32 = Precision(torch.float32, tf32_round)


@dataclass
class Settings:
    """The configuration values the step reads, in the reference
    configuration file's names (``configs/<name>.json``)."""
    l: float
    h: float
    a: float
    b: float
    std_encoder: float
    std_alpha: float
    max_range: float
    min_range: float
    max_bearing: float
    std_range: float
    std_bearing: float
    clutter_rate: float
    pd: float
    birth_weight: float
    birth_noise_factor: float
    min_separation: float
    max_features: int
    min_feature_weight: float
    max_measurements: int
    detection_topk: int
    merge_candidate_cap: int
    resample_threshold: float
    n_particles: int
    initial_x: float
    initial_y: float
    initial_yaw: float

    @property
    def clutter_density(self) -> float:
        """Clutter per unit of range x bearing over the field of view."""
        return self.clutter_rate / (2.0 * self.max_bearing * self.max_range)

    # the values of the path this reference implements (a value a file
    # leaves out takes the program's default, which is the one here)
    PATH = "the static PHD path"
    EXPECT = dict(filter_type=0, feature_model=0, particle_weighting=0,
                  distance_metric=0, motion_type=1, map_estimate=1,
                  n_predict_particles=1, premerge_consolidate=0,
                  merge_spatial_tiles=0, compute_variance=0,
                  subdivide_predict=1)

    @classmethod
    def from_config(cls, values: dict) -> "Settings":
        """The settings of a configuration file's ``config`` object (which
        states every value the step reads)."""
        v = values
        bad = {k: v.get(k, want) for k, want in cls.EXPECT.items()
               if v.get(k, want) != want}
        if bad:
            raise NotImplementedError(f"the reference implements {cls.PATH} "
                                      f"only; got {bad}")
        K, T = int(v["max_features"]), int(v["detection_topk"])
        if not 0 < T < K:
            raise NotImplementedError("the reference selects 0 < T < K "
                                      "detection lanes per measurement")
        names = cls.__dataclass_fields__
        return cls(**{k: type_of(names[k].type)(v[k]) for k in names})


def type_of(name):
    return {"int": int, "float": float}[name]


def mm2(A, B):
    """Products of 2 x 2 matrices [..., 2, 2], entry by entry."""
    def e(i, j):
        return A[..., i, 0] * B[..., 0, j] + A[..., i, 1] * B[..., 1, j]
    return torch.stack([torch.stack([e(0, 0), e(0, 1)], -1),
                        torch.stack([e(1, 0), e(1, 1)], -1)], -2)


def t2(A):
    return A.transpose(-1, -2)


def diag2(a, b, like):
    z = torch.zeros_like(like)
    return torch.stack([torch.stack([z + a, z], -1),
                        torch.stack([z, z + b], -1)], -2)


# a feature whose range or bearing lies within this share of a class edge
# (the sensor's range, 1.2 times it, its bearing limits) is classified by
# rounding: float32 and float64 may put it on either side
GATE_REL = 1e-5


# a particle whose merge tested a lane within this share of min_separation
# may form other clusters in float32 (a lane joins a leader on one side
# and not on the other): the squared distance's float32 rounding, from
# differences of means tens of metres from the origin, reaches ~1e-5 of it;
# a rare lane flips past the gate, which the compared quantile of the maps'
# gaps leaves to the rest (compare.W2_QUANTILE)
MERGE_GATE = 1e-4
# two lanes whose weights lie within this share of each other may lead in
# either order in float32 (weights summed over many terms round to ~1e-6)
TIE_GATE = 1e-5


def near_edge(x, edge: float):
    return (x - edge).abs() <= GATE_REL * max(abs(edge), 1.0)


def wrap(a: torch.Tensor) -> torch.Tensor:
    """An angle in [-pi, pi)."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


# ----------------------------------------------------------------------------
# prediction and the per-feature EKF quantities
# ----------------------------------------------------------------------------

def predict_pose(s: Settings, pose, control, dt, eps, q: Precision):
    """Ackerman steering over dt with the encoder velocity and the steering
    angle perturbed by eps [P, 2] standard normal; the velocity components
    of the pose are zero."""
    x, y, th = pose[:, 0], pose[:, 1], pose[:, 2]
    ve = control[0] + eps[:, 0] * s.std_encoder
    alpha = control[1] + eps[:, 1] * s.std_alpha
    tan_a = torch.tan(alpha)
    vc = q(ve / (1.0 - tan_a * s.h / s.l))
    w = q(vc * tan_a / s.l)
    c, sn = torch.cos(th), torch.sin(th)
    x = x + dt * (vc * c - w * (s.a * sn + s.b * c))
    y = y + dt * (vc * sn + w * (s.a * c - s.b * sn))
    th = wrap(th + dt * w)
    z = torch.zeros_like(x)
    return q(torch.stack([x, y, th, z, z, z], dim=1))


def feature_terms(s: Settings, pose, mean, cov, weight, q: Precision):
    """Per feature [B, K]: predicted range and bearing, the in-range and
    nearly-in-range classes, S^-1, sqrt(det S), the Kalman gain [B, K, 2,
    2] and the Joseph-form updated covariance [B, K, 2, 2]."""
    dx = mean[..., 0] - pose[:, None, 0]
    dy = mean[..., 1] - pose[:, None, 1]
    r2 = dx * dx + dy * dy
    r = torch.sqrt(r2)
    bearing = wrap(torch.atan2(dy, dx) - pose[:, None, 2])
    ab = bearing.abs()
    live = weight > 0
    in_m = live & (r >= s.min_range) & (r <= s.max_range) \
        & (ab <= s.max_bearing)
    near = live & ~in_m & (r >= 0.8 * s.min_range) \
        & (r <= 1.2 * s.max_range) & (ab <= 1.2 * s.max_bearing)
    edge = live & (near_edge(r, s.max_range) | near_edge(r, 1.2 * s.max_range)
                   | near_edge(r, s.min_range)
                   | near_edge(r, 0.8 * s.min_range)
                   | near_edge(ab, s.max_bearing)
                   | near_edge(ab, 1.2 * s.max_bearing))
    # the measurement Jacobian of (range, bearing) in the feature's (x, y)
    rs = torch.clamp_min(r, 1e-6)
    r2s = torch.clamp_min(r2, 1e-12)
    J = q(torch.stack([torch.stack([dx / rs, dy / rs], -1),
                       torch.stack([-dy / r2s, dx / r2s], -1)], -2))
    R = diag2(s.std_range ** 2, s.std_bearing ** 2, r)
    PJt = q(mm2(cov, t2(J)))
    S = q(mm2(J, PJt) + R)
    detS = S[..., 0, 0] * S[..., 1, 1] - S[..., 0, 1] * S[..., 1, 0]
    S_inv = q(torch.stack([torch.stack([S[..., 1, 1], -S[..., 0, 1]], -1),
                           torch.stack([-S[..., 1, 0], S[..., 0, 0]], -1)],
                          -2) / detS[..., None, None])
    gain = q(mm2(PJt, S_inv))
    IKH = diag2(1.0, 1.0, r) - mm2(gain, J)
    cov_upd = q(mm2(mm2(IKH, cov), t2(IKH)) + mm2(mm2(gain, R), t2(gain)))
    return dict(r=q(r), bearing=q(bearing), in_m=in_m, near=near,
                ambiguous=edge.any(-1),
                S_inv=S_inv, sqrt_det=q(torch.sqrt(torch.clamp_min(detS,
                                                                    1e-30))),
                gain=gain, cov_upd=cov_upd)


def births(s: Settings, pose, z, q: Precision):
    """Birth Gaussians [B, M, 2], [B, M, 2, 2] from the inverse measurement
    model, the measurement noise inflated by birth_noise_factor."""
    rng, th = z[:, 0], pose[:, None, 2] + z[None, :, 1]
    c, sn = torch.cos(th), torch.sin(th)
    mean = torch.stack([pose[:, None, 0] + rng * c,
                        pose[:, None, 1] + rng * sn], -1)
    J = torch.stack([torch.stack([c, -rng * sn], -1),
                     torch.stack([sn, rng * c], -1)], -2)
    R = diag2((s.std_range * s.birth_noise_factor) ** 2,
              (s.std_bearing * s.birth_noise_factor) ** 2, c)
    return q(mean), q(mm2(mm2(J, R), t2(J)))


# ----------------------------------------------------------------------------
# the update's pre-merge half: weights, detection lanes and the candidates
# ----------------------------------------------------------------------------

def candidates(s: Settings, pose, mean, cov, weight, z, z_mask,
               q: Precision):
    """For a block of particles: the particle log-weight increment [B] and
    the merge candidates, the heaviest ``merge_candidate_cap`` live lanes of
    [K persistent | M x T detections | M births] ordered by weight (ties to
    the earlier lane): weights [B, cap] (0 past the live ones), means
    [B, cap, 2], covariances [B, cap, 2, 2], and the out-of-range features'
    weights [B, K] (re-attached after the merge)."""
    B, K, _ = mean.shape
    M, T, cap = z.shape[0], s.detection_topk, s.merge_candidate_cap
    f = feature_terms(s, pose, mean, cov, weight, q)
    in_m, near = f["in_m"], f["near"]
    pd = torch.where(in_m, s.pd, 0.0).to(mean.dtype)
    # detection terms pd w N(z; h(x), S) of every (measurement, feature)
    innov_r = z[None, :, 0, None] - f["r"][:, None, :]          # [B, M, K]
    innov_b = wrap(z[None, :, 1, None] - f["bearing"][:, None, :])
    Si = f["S_inv"][:, None]
    d2 = Si[..., 0, 0] * innov_r ** 2 + 2.0 * Si[..., 0, 1] * innov_r \
        * innov_b + Si[..., 1, 1] * innov_b ** 2
    pref = pd * weight / (2.0 * math.pi * f["sqrt_det"])
    valid = z_mask[None, :, None] & in_m[:, None, :]
    pdw = q(torch.where(valid, pref[:, None, :] * torch.exp(-0.5 * d2), 0.0))
    norm = q(pdw.sum(-1) + s.clutter_density + s.birth_weight)  # [B, M]
    n_valid = z_mask.to(mean.dtype).sum()
    dlog_w = q(torch.where(z_mask, torch.log(norm), 0.0).sum(-1)
               - (pd * weight).sum(-1) - n_valid * s.birth_weight)

    # the T heaviest live detection lanes of each measurement, ties to the
    # lowest feature
    live = (pdw > 0) & (pdw >= s.min_feature_weight * norm[..., None])
    key = torch.where(live, pdw, -1.0)
    top_w, top_k = torch.sort(key, dim=-1, descending=True, stable=True)
    top_w, top_k = top_w[..., :T], top_k[..., :T]               # [B, M, T]
    det_live = top_w > 0
    w_det = q(torch.where(det_live, top_w / norm[..., None], 0.0))
    rows = torch.arange(B, device=mean.device)[:, None, None]
    ir = innov_r.gather(-1, top_k)
    ib = innov_b.gather(-1, top_k)
    g = f["gain"][rows, top_k]                                  # [B, M, T, 2, 2]
    det_mean = q(mean[rows, top_k] + g[..., 0] * ir[..., None]
                 + g[..., 1] * ib[..., None])
    det_cov = f["cov_upd"][rows, top_k]

    # persistent lanes: the missed-detection copy of an in-range feature,
    # a nearly-in-range feature unchanged (never pruned)
    w_nd = weight * (1.0 - pd)
    w_p = q(torch.where(in_m, w_nd, torch.where(near, weight, 0.0)))
    act_p = (in_m & (w_nd >= s.min_feature_weight)) | near
    w_b = q(torch.where(z_mask, s.birth_weight / norm, 0.0))
    act_b = z_mask[None, :] & (w_b >= s.min_feature_weight)
    b_mean, b_cov = births(s, pose, z, q)

    lane_w = torch.cat([w_p, w_det.reshape(B, M * T), w_b], 1)
    lane_act = torch.cat([act_p, det_live.reshape(B, M * T), act_b], 1)
    lane_mean = torch.cat([mean, det_mean.reshape(B, M * T, 2), b_mean], 1)
    lane_cov = torch.cat([cov, det_cov.reshape(B, M * T, 2, 2), b_cov], 1)
    key = torch.where(lane_act & (lane_w > 0), lane_w, -1.0)
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    order = order[:, :cap]
    cw = key.gather(1, order).clamp_min(0.0)
    rows = torch.arange(B, device=mean.device)[:, None]
    out_w = torch.where(~in_m & ~near & (weight > 0), weight, 0.0)
    return dict(dlog_w=dlog_w, ambiguous=f["ambiguous"], w=cw,
                mean=lane_mean[rows, order],
                cov=lane_cov[rows, order], out_w=out_w)


def greedy_merge(w, mean, cov, min_sep, out_cap, q: Precision,
                 origin=None, exact_ties_agree: bool = False):
    """Greedy moment-matched merge of weight-sorted candidates [P, N]: the
    heaviest unmerged lane leads and absorbs every unmerged lane within
    squared Mahalanobis distance ``min_sep`` under the mean of the two
    covariances; at most ``out_cap`` clusters, weight 0 past them. The
    moments are summed about ``origin`` [P, 2] (each particle's pose), so
    that the merged covariance loses no precision to the map's extent.
    Merged lanes leave the working set every 32 clusters. Also returns,
    so that a particle whose clusters rounding could change is known, each
    particle's merge margin [P] (the least |d2 - min_sep| / min_sep of a
    lane it tested against a leader; :data:`MERGE_GATE`) and whether a
    leader had a tie [P] that could lead first and change the clusters
    (:data:`TIE_GATE`). With ``exact_ties_agree`` a lane whose weight
    equals the leader's exactly is no tie: the caller's lanes of equal
    weight come from equal inputs by the same operations, so they are
    equal in float32 too and lead in lane order on both sides."""
    P, N = w.shape
    dev, dt = w.device, w.dtype
    if origin is None:
        origin = torch.zeros((P, 2), dtype=dt, device=dev)
    mx = mean[..., 0] - origin[:, None, 0]
    my = mean[..., 1] - origin[:, None, 1]
    c00, c01, c11 = cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]
    # per lane: x, y, c00, c01, c11 and the raw moments w (1, x, y, c + m m')
    lane = torch.stack([mx, my, c00, c01, c11], -1)
    mom = torch.stack([w, w * mx, w * my, w * (c00 + mx * mx),
                       w * (c01 + mx * my), w * (c11 + my * my)], -1)
    todo = w > 0
    o_w = torch.zeros((P, out_cap), dtype=dt, device=dev)
    o_mean = torch.zeros((P, out_cap, 2), dtype=dt, device=dev)
    o_cov = torch.eye(2, dtype=dt, device=dev).expand(P, out_cap, 2, 2) \
        .clone()
    rows = torch.arange(P, device=dev)
    margin = torch.full((P,), math.inf, dtype=torch.float64, device=dev)
    tie = torch.zeros((P,), dtype=torch.bool, device=dev)
    for c in range(out_cap):
        if c % 32 == 0:
            n_left = int(todo.sum(1).amax())
            if n_left == 0:
                break
            keep = torch.sort((~todo).to(torch.uint8), dim=1,
                              stable=True).indices[:, :n_left]
            todo = todo.gather(1, keep)
            lane = lane[rows[:, None], keep]
            mom = mom[rows[:, None], keep]
            lanes = torch.arange(n_left, device=dev)
        live = todo.any(1)
        if not bool(live.any()):
            break
        lead = torch.argmax(todo.to(torch.uint8), 1)
        L = lane[rows, lead]                                     # [P, 5]
        d2 = pair_d2(lane, L)
        others = todo & (lanes != lead[:, None])
        margin = torch.minimum(margin, torch.where(
            others, (d2 - min_sep).abs() / min_sep, math.inf)
            .amin(1).to(torch.float64))
        # a lane whose weight ties the leader's to rounding may lead first
        # in float32; that changes the clusters where the two lie within
        # min_sep of each other or of a common lane (the tied lane
        # nearest the leader is the one tested)
        wl = mom[rows, lead, 0]
        near_tie = others & ((mom[..., 0] - wl[:, None]).abs()
                             <= TIE_GATE * wl[:, None])
        if exact_ties_agree:
            near_tie &= mom[..., 0] != wl[:, None]
        if bool(near_tie.any()):
            j = torch.argmin(torch.where(near_tie, d2, math.inf), 1)
            d2j = pair_d2(lane, lane[rows, j])
            common = others & (lanes != j[:, None]) & (d2 < min_sep) \
                & (d2j < min_sep)
            tie |= near_tie.any(1) & ((d2[rows, j] < min_sep)
                                      | common.any(1))
        sel = todo & ((d2 < min_sep) | (lanes == lead[:, None]))
        S = torch.bmm(sel.to(dt)[:, None, :], mom)[:, 0]         # [P, 6]
        W = S[:, 0].clamp_min(1e-30)
        mu = q(S[:, 1:3] / W[:, None])
        cm = q(torch.stack([S[:, 3] / W - mu[:, 0] * mu[:, 0],
                            S[:, 4] / W - mu[:, 0] * mu[:, 1],
                            S[:, 5] / W - mu[:, 1] * mu[:, 1]], -1))
        o_w[:, c] = torch.where(live, q(S[:, 0]), 0.0)
        o_mean[:, c] = torch.where(live[:, None], mu + origin, 0.0)
        o_cov[:, c] = torch.where(
            live[:, None, None],
            torch.stack([cm[:, :2], cm[:, 1:]], -2), o_cov[:, c])
        todo = todo & ~sel
    return o_w, o_mean, o_cov, margin, tie


def pair_d2(lane, L):
    """Squared Mahalanobis distance d' ((A + B) / 2)^-1 d of every lane
    [P, N, 5] (x, y, c00, c01, c11) from one lane L [P, 5] of its row."""
    s00 = lane[..., 2] + L[:, None, 2]
    s01 = lane[..., 3] + L[:, None, 3]
    s11 = lane[..., 4] + L[:, None, 4]
    dx = lane[..., 0] - L[:, None, 0]
    dy = lane[..., 1] - L[:, None, 1]
    return 2.0 * (s11 * dx * dx - 2.0 * s01 * dx * dy + s00 * dy * dy) \
        / (s00 * s11 - s01 * s01)


def compact(o_w, o_mean, o_cov, mean, cov, out_w, K):
    """The merged clusters and the out-of-range features, the K heaviest
    kept (ties to the merged clusters, then the lower slot)."""
    aw = torch.cat([o_w, out_w], 1)
    am = torch.cat([o_mean, mean], 1)
    ac = torch.cat([o_cov, cov], 1)
    order = torch.sort(aw, dim=1, descending=True, stable=True).indices[:,
                                                                        :K]
    rows = torch.arange(aw.shape[0], device=aw.device)[:, None]
    nw = aw.gather(1, order)
    keep = nw > 0
    eye = torch.eye(2, dtype=aw.dtype, device=aw.device)
    return (torch.where(keep, nw, 0.0),
            torch.where(keep[..., None], am[rows, order], 0.0),
            torch.where(keep[..., None, None], ac[rows, order], eye))


def map_moments(mean, cov, weight):
    """[..., 8] of a map [..., K]: total weight, first moments (x, y),
    second moments about the origin (xx, xy, yy) of the mixture's mass
    (each component's covariance included), the live component count and
    the sum of the squared weights, in float64. A moment-matched merge
    leaves the first six unchanged; the last grows with every lane it
    merges (by twice the product of the two weights)."""
    w = weight.to(torch.float64)
    m = mean.to(torch.float64)
    c = cov.to(torch.float64)
    live = w > 0
    w = torch.where(live, w, 0.0)
    m2 = c + m[..., :, None] * m[..., None, :]
    return torch.stack([
        w.sum(-1), (w * m[..., 0]).sum(-1), (w * m[..., 1]).sum(-1),
        (w * m2[..., 0, 0]).sum(-1), (w * m2[..., 0, 1]).sum(-1),
        (w * m2[..., 1, 1]).sum(-1), live.sum(-1).to(torch.float64),
        (w * w).sum(-1)], -1)


# ----------------------------------------------------------------------------
# the whole step
# ----------------------------------------------------------------------------

def grid_block(s: Settings, M: int) -> int:
    """Particles a block of the [B, M, K] grid holds (~2**25 entries)."""
    return max(1, (1 << 25) // max(1, M * s.max_features))


def initial_state(s: Settings, device="cpu"):
    """The filter's state before its first step: every particle at the
    prior pose with weight 1/P and an empty map."""
    P, K = s.n_particles, s.max_features
    pose = torch.zeros((P, 6), dtype=torch.float64, device=device)
    pose[:, 0], pose[:, 1], pose[:, 2] = s.initial_x, s.initial_y, \
        s.initial_yaw
    return dict(pose=pose,
                log_weight=torch.full((P,), -math.log(P), dtype=torch.float64,
                                      device=device),
                mean=torch.zeros((P, K, 2), dtype=torch.float64,
                                 device=device),
                cov=torch.eye(2, dtype=torch.float64, device=device)
                .expand(P, K, 2, 2).clone(),
                weight=torch.zeros((P, K), dtype=torch.float64,
                                   device=device))


def step(s: Settings, state: dict, z, z_mask, control, dt, do_predict,
         has_z, eps, u, q: Precision = REFERENCE,
         device: Optional[torch.device] = None) -> dict:
    """One filter step from ``state`` (pose [P, 6], log_weight [P], mean
    [P, K, 2], cov [P, K, 2, 2], weight [P, K]) on the draws eps
    [P, 2] and u [P]. Returns, before resampling: pose [P, 6], log_weight
    [P] (normalized), moments [P, 8] of each updated map
    (:func:`map_moments`), the expected pose [6], the MAP particle's index,
    nEff / P, ``ambiguous`` [P] (a particle with a live feature within
    rounding of a class edge, :data:`GATE_REL`), ``merge_margin`` [P]
    (:func:`greedy_merge`'s; infinite where nothing merged) and ``scale``
    [P] (the largest magnitude summed into each log weight, at least 1);
    and the resampling: whether it runs, the strata [P], the cumulative
    weights [P] in float64 and the ancestors [P]."""
    dev = device or state["pose"].device
    P = state["pose"].shape[0]

    def get(x):
        return q(x.to(dev))
    pose, lw = get(state["pose"]), get(state["log_weight"])
    z, z_mask = get(z), z_mask.to(dev)
    if do_predict:
        pose = predict_pose(s, pose, control, float(dt), get(eps), q)
    moments = torch.zeros((P, 8), dtype=torch.float64, device=dev)
    ambiguous = torch.zeros((P,), dtype=torch.bool, device=dev)
    margin = torch.full((P,), math.inf, dtype=torch.float64, device=dev)
    tie = torch.zeros((P,), dtype=torch.bool, device=dev)
    scale = lw.abs()
    if has_z:
        B = grid_block(s, z.shape[0])
        parts = []
        for lo in range(0, P, B):
            sl = slice(lo, min(P, lo + B))
            parts.append(candidates(
                s, pose[sl], get(state["mean"][sl]), get(state["cov"][sl]),
                get(state["weight"][sl]), z, z_mask, q))
        cat = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        del parts
        o_w, o_mean, o_cov, margin, tie = greedy_merge(cat["w"], cat["mean"], cat["cov"],
                                          s.min_separation, s.max_features,
                                          q, origin=pose[:, :2])
        for lo in range(0, P, B):
            sl = slice(lo, min(P, lo + B))
            nw, nm, nc = compact(o_w[sl], o_mean[sl], o_cov[sl],
                                 get(state["mean"][sl]),
                                 get(state["cov"][sl]), cat["out_w"][sl],
                                 s.max_features)
            moments[sl] = map_moments(nm, nc, nw)
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
                has_z=bool(has_z),
                scale=torch.maximum(scale, lw.abs()).clamp_min(1.0),
                **resampling(s, pose, lw, u, has_z))


def resampling(s: Settings, pose, lw, u, has_z) -> dict:
    """The step's tail from the normalized log weights lw [P]: the
    expected pose, the MAP particle's index, nEff / P, and the systematic
    resampling on the uniforms u [P] (whether it runs, the strata, the
    cumulative weights in float64 and the ancestors)."""
    P, dev = lw.shape[0], lw.device
    wts = torch.exp(lw)
    expected = (wts[:, None] * pose).sum(0)
    best = int(torch.argmax(lw))
    n_eff = 1.0 / (P * torch.exp(2.0 * lw).sum())
    cum = torch.cumsum(wts.to(torch.float64), 0)
    strata = (torch.arange(P, dtype=torch.float64, device=dev)
              + u.to(dev, torch.float64)) / P
    anc = torch.searchsorted(cum, strata, side="left")
    anc = torch.where(anc >= P, best, anc)
    return dict(expected_pose=expected, best=best, n_eff=float(n_eff),
                resample=bool(has_z) and float(n_eff) <= s.resample_threshold,
                cumulative=cum, strata=strata, ancestors=anc)


def __getattr__(name):
    """The comparison of this reference's results (``compare.py``: its
    ``NAMES``, ``gaps``, ``init_gap`` and ``as_outputs``), so that the
    harness finds a reference's whole interface in one module."""
    if name in ("NAMES", "gaps", "init_gap", "as_outputs"):
        from . import compare
        return getattr(compare, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
