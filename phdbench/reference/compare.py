"""The numbers that decide ``correct``: gaps between what a run's timed
path produced at a sampled step and what the reference computes from the
same input state and draws.

The program's step ends in resampling, so its particle j is its pre-
resampling particle ``ancestors[j]``. The ancestors are judged by where
their strata fall in the reference's cumulative weights, and every other
per-particle output is compared with the reference's particle of the same
ancestor. The maps are compared by their moments (:func:`step.
map_moments`), which a moment-matched merge keeps whatever clusters it
forms, and by the sum of their squared weights, which the merge's
clusters set: every lane merged adds twice the product of its weight and
its cluster's. A particle whose merge tested a lane within rounding of the
merge's threshold (:data:`step.MERGE_GATE`), which joins its leader on
one side and not on the other, or whose leader's weight ties another
lane's to rounding where their order changes the clusters
(:data:`step.TIE_GATE`), is left out of that number. A rare particle
still merges a lane past the gate on one side only (one of 9099 at 1.9e-4
of min_separation read 6.3e-4 where the rest read under 1e-6), so the
number compared is a high quantile (:data:`W2_QUANTILE`) over the
particles before resampling, each counted once however many copies
resampling made of it: a merge at fault in more than a thousandth of them
still shows. Component counts are not compared: a light lane at an
activity threshold changes them by one, but the squared weights by a
share of its weight.
"""

from __future__ import annotations

import math

import torch

from .step import MERGE_GATE, Settings, initial_state

# the numbers compared, in the order they are printed
NAMES = ("init", "pose_m", "expected_pose_m", "log_weight", "n_eff_rel",
         "ancestor", "map_rel", "map_w2_rel_q999", "map_est_rel")

# the quantile of the per-map squared-weight gaps that is compared
W2_QUANTILE = 0.999


def pose_gap(s: Settings, a, b):
    """Per row: the larger of the position gap (m) and the heading gap
    times the sensor's range (m)."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    dth = torch.remainder(a[..., 2] - b[..., 2] + math.pi, 2 * math.pi) \
        - math.pi
    return torch.maximum((a[..., :2] - b[..., :2]).abs().amax(-1),
                         s.max_range * dth.abs())


def moment_gap(got, want):
    """Per map: the weight gap over the reference's total weight, the first
    moments' over W L and the second moments' over W L^2 (L^2 the mass's
    mean squared distance from the origin), the largest of the three."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    W = want[..., 0]
    Ws = W.clamp_min(1e-30)
    L2 = ((want[..., 3] + want[..., 5]) / Ws).clamp_min(1e-12)
    g = torch.stack([
        (got[..., 0] - W).abs() / Ws,
        (got[..., 1:3] - want[..., 1:3]).abs().amax(-1) / (Ws * L2.sqrt()),
        (got[..., 3:6] - want[..., 3:6]).abs().amax(-1) / (Ws * L2)], -1)
    g = g.amax(-1)
    return torch.where(W > 0, g, got[..., 0].abs())


def w2_gap(got, want):
    """Per map: the gap of the sum of squared weights over the
    reference's."""
    got, want = got[..., 7].to(torch.float64), want[..., 7].to(torch.float64)
    return torch.where(want > 0, (got - want).abs() / want.clamp_min(1e-300),
                       got.abs())


def first_copy(anc):
    """[P] True at one particle of each ancestor, so that a map that the
    resampling copied counts once."""
    order = torch.argsort(anc, stable=True)
    a = anc[order]
    lead = torch.ones_like(a, dtype=torch.bool)
    lead[1:] = a[1:] != a[:-1]
    out = torch.zeros_like(lead)
    out[order[lead]] = True
    return out


def init_gap(s: Settings, inp, prior=None) -> float:
    """Largest difference between a run's initial state ``inp`` and the
    filter's prior (by default every particle at the initial pose, weight
    1 / P, empty maps: :func:`step.initial_state`) rounded to float32."""
    prior = initial_state(s) if prior is None else prior
    return max(float((inp[k].cpu().double() - prior[k].float().double())
                     .abs().max()) for k in prior)


def gaps(s: Settings, got: dict, ref: dict) -> dict:
    """The gaps of one step's outputs ``got`` from the reference's result
    ``ref`` (:func:`step.step`). ``got``: pose [P, 6] and map moments
    [P, 8] after resampling, the log weights before it (``lw_pre`` [P]),
    ancestors [P], the expected pose, n_eff, whether it resampled and the
    MAP map's moments [8].

    A particle the reference finds ``ambiguous`` (a feature within
    rounding of a class edge, which float32 may classify either way) is
    left out of the per-particle numbers, and the program's own log weight
    stands in for it where all particles' weights combine (nEff, the
    expected pose). The resampling is judged on the program's own weights:
    where each stratum falls in their cumulative sum."""
    P = ref["pose"].shape[0]
    dev = ref["pose"].device
    anc = got["ancestors"].to(dev, torch.int64)
    clean = ~ref["ambiguous"]
    out = {}
    out["pose_m"] = float(pose_gap(s, got["pose"].to(dev),
                                   ref["pose"][anc]).max())
    lw = got["lw_pre"].to(dev, torch.float64)
    lw_ref = ref["log_weight"].to(torch.float64)
    # log weights relative to the largest magnitude summed into them (the
    # prior log weight, the step's increment, the result), which sets
    # their rounding
    scale = ref["scale"].to(torch.float64)
    rel = (lw - lw_ref).abs() / scale
    out["log_weight"] = float(torch.where(clean, rel, 0.0).max())
    # after the step: 1 / P where it resampled, else the weights unchanged
    post = got["log_weight"].to(dev, torch.float64)
    want = (torch.full_like(post, -math.log(P)) if got["resampled"]
            else lw[anc])
    out["log_weight"] = max(out["log_weight"], float(
        ((post - want).abs() / torch.maximum(scale[anc], want.abs())).max()))
    mixed = torch.where(clean, lw_ref, lw)
    w = torch.softmax(mixed, 0)
    n_eff = float(1.0 / (P * (w * w).sum()))
    out["n_eff_rel"] = abs(got["n_eff"] - n_eff) / n_eff
    # the decision against the program's own nEff, in float64
    w_own = torch.softmax(lw, 0)
    n_own = float(1.0 / (P * (w_own * w_own).sum()))
    decide = ref["has_z"] and n_own <= s.resample_threshold
    if decide != got["resampled"] and abs(
            n_own - s.resample_threshold) > 1e-6 * s.resample_threshold:
        out["n_eff_rel"] = math.inf
    out["expected_pose_m"] = float(pose_gap(
        s, got["expected_pose"].to(dev)[None],
        (w[:, None] * ref["pose"]).sum(0)[None]).max())
    # ancestors: nothing to compare on a step that does not resample (its
    # ancestors must be the identity)
    out["ancestor"] = None
    if got["resampled"]:
        cum = torch.cumsum(w_own, 0)
        r = ref["strata"]
        hi = cum[anc]
        lo = torch.where(anc > 0, cum[(anc - 1).clamp_min(0)], 0.0)
        inside = torch.maximum(torch.maximum(lo - r, r - hi),
                               torch.zeros_like(r))
        # a stratum past the program's own weight sum takes the heaviest
        overrun = torch.where(anc == int(torch.argmax(lw)),
                              (cum[-1] - r).clamp_min(0),
                              torch.full_like(r, math.inf))
        out["ancestor"] = float(P * torch.minimum(inside, overrun).max())
    elif bool((anc != torch.arange(P, device=dev)).any()):
        out["ancestor"] = math.inf
    mom = got["moments"].to(dev)
    g = moment_gap(mom, ref["moments"][anc])
    out["map_rel"] = float(torch.where(clean[anc], g, 0.0).max())
    g2 = w2_gap(mom, ref["moments"][anc])
    sure = (ref["merge_margin"] > MERGE_GATE) & ~ref["merge_tie"]
    kept = g2[clean[anc] & sure[anc] & first_copy(anc)]
    out["map_w2_rel_q999"] = (float(torch.quantile(kept, W2_QUANTILE))
                              if kept.numel() else 0.0)
    # not compared: the largest of them, the same without the merge's
    # exclusions, and how many particles (before resampling) they leave out
    out["max_map_w2_rel"] = float(torch.where(clean[anc] & sure[anc], g2,
                                              0.0).max())
    out["all_map_w2_rel"] = float(torch.where(clean[anc], g2, 0.0).max())
    out["merge_unsure"] = float((~sure).sum())
    # not compared: what the ambiguous particles would read, and how many
    out["all_map_rel"] = float(g.max())
    out["all_log_weight"] = float(rel.max())
    out["ambiguous"] = float((~clean).sum())
    # the MAP particle: the program's heaviest (first of ties)
    best = int(torch.argmax(lw))
    out["map_est_rel"] = (None if not bool(clean[best]) else float(
        moment_gap(got["map_moments"].to(dev), ref["moments"][best])))
    return out


def as_outputs(res: dict, q) -> dict:
    """A reference-form result (:func:`step.step`, e.g. the control's,
    computed in precision ``q``) as the outputs of a step: its particles
    taken at its own ancestors when it resamples."""
    P = res["pose"].shape[0]
    dev = res["pose"].device
    anc = (res["ancestors"] if res["resample"]
           else torch.arange(P, device=dev))
    lw = (q(torch.full((P,), -math.log(P), dtype=torch.float64, device=dev))
          if res["resample"] else res["log_weight"])
    return dict(pose=res["pose"][anc], log_weight=lw,
                lw_pre=res["log_weight"],
                moments=res["moments"][anc], ancestors=anc,
                expected_pose=res["expected_pose"], n_eff=res["n_eff"],
                resampled=res["resample"],
                map_moments=res["moments"][res["best"]])
