"""Greedy moment-matched Gaussian-mixture merge and candidate selection
(port of ``phdslam_tpu/ops/gm_merge.py``, the parts the ported paths run).

The greedy merge repeats until no candidate is left or ``out_cap``
clusters are out: pick the heaviest unmerged component, gather every
unmerged component within ``min_separation`` (squared Mahalanobis distance
with averaged covariance, or the 2D Hellinger distance), emit their
moment-matched merge and mark them merged. :func:`gm_merge_batch` is the plain PyTorch form, batched over
particles, for 2D static, 3D disparity (u, v, d) and 4D constant-velocity
features; it is the twin of the CUDA merge kernels (kernels/merge.py).
The 3D and 4D Mahalanobis distances are the JAX merge kernels' closed forms
(``ops/math.py::mahalanobis2_3d``, ``mahalanobis2_4d``); the Hellinger
distance (``ops/math.py::hellinger2``) holds at D = 2, 3 and 4.

Which contract holds where: the JAX package merges 3D and 4D mixtures with
the Hellinger distance in XLA (its ``gm_merge``; no Pallas kernel has that
metric there), and the port's default (sorted) contract is XLA's: only
active lanes with w > 0 enter, the heaviest unmerged lane leads (ties to
the lowest lane), and the lanes left when ``out_cap`` clusters are out are
counted. The port runs those paths (the mixed model's dynamic map, the
dynamic-only 4D map and the disparity map at distance_metric 1) on
weight-sorted lanes through the sorted-mode kernels, so it follows XLA
there, not the Pallas argmax mode, where the two differ in the leftover
count (w <= 0 lanes) and in rows holding NaN weights.

Sorts are stable with the JAX version's key order (``lax.sort`` is stable),
so ties resolve to the lowest lane index exactly as there.

:func:`tiled_merge_packed` is the JAX version's spatially tiled merge
(``merge_spatial_tiles = 4``): each particle's live candidates split into
2 x 2 quadrants about their centroid and each quadrant merged on its own
(an approximation: a pair straddling a quadrant boundary stays unmerged
that step). :func:`switch_widths` and :func:`tile_width` give the widths
the JAX version's ``lax.switch`` families pick, which decide whether it
tiles.
"""

from __future__ import annotations

import torch

from .math import (hellinger2, mahalanobis2, mahalanobis2_3d,
                   mahalanobis2_4d, sym)


def gm_merge_batch(mean, cov, weight, active, min_separation, out_cap,
                   distance_metric=0, argmax=False):
    """Greedy merge of every particle's mixture.

    mean [P, N, D], cov [P, N, D, D], weight [P, N], active [P, N] bool
    with D 2, 3 or 4 -> (out_mean [P, out_cap, D], out_cov [P, out_cap, D, D],
    out_weight [P, out_cap], n_merged [P], n_dropped [P]). Empty slots have
    weight 0, mean 0 and identity covariance; ``n_dropped`` counts the
    candidates left unmerged when ``out_cap`` clusters were out.
    ``distance_metric`` 1 selects the Hellinger distance (any D).

    The default is the contract of the sorted-mode merge kernels: NaN and
    w <= 0 lanes never enter. ``argmax=True`` is the contract of the 2D
    kernel's argmax mode (the JAX package's ``_merge_core_2d`` with
    sorted_w=False, not its XLA ``gm_merge``): every active lane enters, a
    w <= 0 lane can be absorbed but never leads, and a particle stalls,
    dropping its remaining lanes, once no unmerged lane has w > 0 or any
    unmerged lane's w is NaN. The principal picks are the same in both
    modes; the leftover count differs when ``out_cap`` binds.
    """
    P, N, D = mean.shape
    dev, dtype = mean.device, mean.dtype
    if distance_metric == 1:
        distance = hellinger2
    else:
        distance = {2: mahalanobis2, 3: mahalanobis2_3d,
                    4: mahalanobis2_4d}[D]
    # sorted contract: NaN and w <= 0 lanes never join
    unmerged = active.clone() if argmax else active & (weight > 0)
    out_mean = torch.zeros((P, out_cap, D), dtype=dtype, device=dev)
    out_cov = torch.eye(D, dtype=dtype, device=dev).expand(
        P, out_cap, D, D).clone()
    out_w = torch.zeros((P, out_cap), dtype=dtype, device=dev)
    count = torch.zeros((P,), dtype=torch.int64, device=dev)
    rows = torch.arange(P, device=dev)
    lanes = torch.arange(N, device=dev)

    for c in range(out_cap):
        if argmax:
            w_act = torch.where(unmerged, weight, -1.0)
            live = (torch.amax(w_act, dim=1) > 0) \
                & ~torch.isnan(w_act).any(dim=1)
            unmerged = unmerged & live[:, None]               # stalled rows
        else:
            live = unmerged.any(dim=1)                        # [P]
            w_act = torch.where(unmerged, weight, -torch.inf)
        if not bool(live.any()):
            break
        imax = torch.argmax(w_act, dim=1)                     # first max
        max_mean = mean[rows, imax]
        max_cov = cov[rows, imax]
        dist = distance(max_mean[:, None], max_cov[:, None], mean, cov)
        sel = unmerged & (dist < min_separation)
        # the principal always merges with itself
        sel = (sel | (lanes[None, :] == imax[:, None])) & unmerged

        selw = torch.where(sel, weight, 0.0)
        W = selw.sum(dim=1)
        W_safe = torch.clamp_min(W, 1e-30)
        mu = torch.einsum("pn,pnd->pd", selw, mean) / W_safe[:, None]
        diff = mu[:, None, :] - mean
        spread = cov + diff[..., :, None] * diff[..., None, :]
        cov_m = sym(torch.einsum("pn,pnij->pij", selw, spread)
                    / W_safe[:, None, None])

        out_mean[:, c] = torch.where(live[:, None], mu, out_mean[:, c])
        out_cov[:, c] = torch.where(live[:, None, None], cov_m,
                                    out_cov[:, c])
        out_w[:, c] = torch.where(live, W, out_w[:, c])
        count += live
        unmerged = unmerged & ~sel
    n_dropped = unmerged.sum(dim=1)
    return out_mean, out_cov, out_w, count, n_dropped


MERGE_DIMS = {7: 2, 11: 3, 16: 4}      # input planes -> D


def _cov_from_planes(planes, D):
    """Upper-triangle planes (row-major order) -> symmetric [..., D, D]."""
    full = [[None] * D for _ in range(D)]
    i = 0
    for a in range(D):
        for b in range(a, D):
            full[a][b] = full[b][a] = planes[i]
            i += 1
    return torch.stack([torch.stack(row, dim=-1) for row in full], dim=-2)


def unpack_planes(packed, D):
    """Candidate planes [P, 2 + D + D(D+1)/2, N] (w, act, mean, upper-
    triangle cov: 7 planes at D=2, 11 at D=3, 16 at D=4) -> (mean [P, N, D],
    cov [P, N, D, D], weight [P, N], active [P, N])."""
    weight = packed[:, 0]
    active = packed[:, 1] > 0.5
    mean = torch.stack([packed[:, 2 + i] for i in range(D)], dim=-1)
    cov = _cov_from_planes([packed[:, 2 + D + i]
                            for i in range(D * (D + 1) // 2)], D)
    return mean, cov, weight, active


def pack_planes(mean, cov, weight, active):
    """(mean [P, N, D], cov [P, N, D, D], weight [P, N], active [P, N])
    -> candidate planes [P, 2 + D + D(D+1)/2, N], the inverse of
    :func:`unpack_planes`."""
    D = mean.shape[-1]
    planes = [weight, active.to(weight.dtype)]
    planes += [mean[..., i] for i in range(D)]
    planes += [cov[..., a, b] for a in range(D) for b in range(a, D)]
    return torch.stack(planes, dim=1)


def sort_planes(packed, D):
    """Candidate planes with every particle's lanes in
    :func:`sort_candidates`' order (heaviest active first, ties to the
    lowest lane; lanes past the live ones as w 0, mean 0, identity
    covariance): the input of a sorted-mode kernel that picks the
    principals an argmax merge would."""
    return pack_planes(*sort_candidates(*unpack_planes(packed, D)))


def pack_merge_out(om, oc, ow, n_dropped):
    """Merge results -> output planes [P, C, K]: w, mean, upper-triangle
    cov, lanes left unmerged (broadcast), then zero pads up to C = 8 at
    D = 2, 12 at D = 3 (the 2D and 3D kernels' layouts) or 16 at D = 4."""
    D = om.shape[-1]
    planes = [ow] + [om[..., i] for i in range(D)]
    planes += [oc[..., a, b] for a in range(D) for b in range(a, D)]
    planes.append(n_dropped.to(ow.dtype)[:, None].expand_as(ow))
    planes += [torch.zeros_like(ow)] * ({2: 8, 3: 12, 4: 16}[D] - len(planes))
    return torch.stack(planes, dim=1)


def merge_out(out, D):
    """Merge output planes (:func:`pack_merge_out`'s layout) -> (mean
    [P, K, D], cov [P, K, D, D], w [P, K], n_merged [P], n_dropped [P]),
    empty slots as (0, I)."""
    n_cov = D * (D + 1) // 2
    out_w = out[:, 0]
    out_mean = torch.stack([out[:, 1 + i] for i in range(D)], dim=-1)
    out_cov = _cov_from_planes([out[:, 1 + D + i] for i in range(n_cov)], D)
    empty = out_w <= 0
    eye = torch.eye(D, dtype=out.dtype, device=out.device)
    out_cov = torch.where(empty[..., None, None], eye, out_cov)
    out_mean = torch.where(empty[..., None], 0.0, out_mean)
    n_merged = (out_w > 0).sum(dim=-1)
    n_dropped = out[:, 1 + D + n_cov, 0].to(torch.int64)
    return out_mean, out_cov, out_w, n_merged, n_dropped


def _heaviest_lanes(mean, cov, weight, active, n):
    """The n heaviest active lanes, weight-descending, as lax.top_k orders
    them (ties to the lowest lane; inactive lanes keyed -1, so last): one
    stable sort, never ``torch.topk``, whose tie order is unspecified on
    CUDA. Lanes past the active ones come out as (0, I, 0, False)."""
    P, N, D = mean.shape
    w_act = torch.where(active, weight, -1.0)
    idx = torch.sort(-w_act, dim=-1, stable=True).indices[:, :n]
    w = torch.gather(weight, 1, idx)
    sel_act = torch.gather(active, 1, idx) & (w > 0)
    m = torch.gather(mean, 1, idx[..., None].expand(P, n, D))
    c = torch.gather(cov.reshape(P, N, D * D), 1,
                     idx[..., None].expand(P, n, D * D)).reshape(P, n, D, D)
    eye = torch.eye(D, dtype=mean.dtype, device=mean.device)
    return (torch.where(sel_act[..., None], m, 0.0),
            torch.where(sel_act[..., None, None], c, eye),
            torch.where(sel_act, w, 0.0), sel_act)


def compact_candidates(mean, cov, weight, active, cap):
    """Top-``cap``-by-weight compaction of every particle's candidate set
    (mean [P, N, D], cov [P, N, D, D], weight / active [P, N]). A cap that
    does not bind (cap <= 0 or cap >= N) returns the set unchanged.

    Returns (mean [P, cap, D], cov, weight, active, n_dropped_live [P]).
    """
    P, N, _ = mean.shape
    if cap <= 0 or cap >= N:
        return (mean, cov, weight, active,
                torch.zeros((P,), dtype=torch.int64, device=mean.device))
    n_live = (active & (weight > 0)).sum(dim=1)
    return (*_heaviest_lanes(mean, cov, weight, active, cap),
            torch.clamp_min(n_live - cap, 0))


def sort_candidates(mean, cov, weight, active):
    """Every lane of every particle in :func:`compact_candidates`' order
    (heaviest active first, ties to the lowest lane), nothing dropped: the
    sorted merge then picks the principals the argmax merge picks."""
    return _heaviest_lanes(mean, cov, weight, active, mean.shape[1])


def select_live_topT(grid, thr, T):
    """Heaviest-T live detection lanes per measurement.

    ``grid`` [..., M, K] >= 0, ``thr`` [..., M] > 0: live = grid >= thr.
    One stable sort along K (key -grid on live lanes, +1 on dead) keeps the
    T heaviest live lanes, ties in index order.

    Returns (vals [..., M, T], idx [..., M, T] int32, n_live [...],
    n_kept [...]).
    """
    live = grid >= thr[..., None]
    neg = torch.where(live, -grid, 1.0)
    neg_s, idx_s = torch.sort(neg, dim=-1, stable=True)
    vals = torch.clamp_min(-neg_s[..., :T], 0.0)
    idx = idx_s[..., :T].to(torch.int32)
    count = live.sum(dim=-1)
    n_live = count.sum(dim=-1)
    n_kept = torch.clamp_max(count, T).sum(dim=-1)
    return vals, idx, n_live, n_kept


def topcap_sort(red_w, red_act, red_flat, cap):
    """Global top-``cap``-by-weight lane selection (one stable sort on
    -w carrying the lane ids), batched over leading axes.

    Returns (idx [..., cap] from red_flat, cand_w [..., cap],
    sel_act [..., cap] bool, n_dropped_live [...]).
    """
    live = red_act & (red_w > 0)
    neg_w = torch.where(live, -red_w, 1.0)
    neg_s, order = torch.sort(neg_w, dim=-1, stable=True)
    idx = torch.gather(red_flat, -1, order[..., :cap])
    cand_w = torch.clamp_min(-neg_s[..., :cap], 0.0)
    sel_act = neg_s[..., :cap] < 0
    n_live = live.sum(dim=-1)
    return idx, cand_w, sel_act, torch.clamp_min(n_live - cap, 0)


def topk_compact_indices(weight, active, cap):
    """Top-``cap``-by-weight lane selection over weights alone, batched
    over leading axes (the top-cap lane route, detection_topk >= K): live
    lanes (active, w > 0) weight-descending, as ``lax.top_k`` orders them
    (ties to the lowest lane, dead lanes keyed -1, so last) - one stable
    sort, never ``torch.topk``, whose tie order is unspecified on CUDA.

    Returns (idx [..., cap], values [..., cap] (0 off sel_act),
    sel_act [..., cap] bool, n_dropped_live [...]).
    """
    live = active & (weight > 0)
    w_act = torch.where(live, weight, -1.0)
    neg_s, idx = torch.sort(-w_act, dim=-1, stable=True)
    vals = -neg_s[..., :cap]
    sel_act = vals > 0
    n_live = live.sum(dim=-1)
    return (idx[..., :cap], torch.where(sel_act, vals, 0.0), sel_act,
            torch.clamp_min(n_live - cap, 0))


# the JAX version's width-switch fractions (quarter steps of the width)
WIDTH_FRACS = (4, 2, 1.3333333)
TILES = 4                          # 2 x 2 quadrants
TILE_WIDTHS = (128, 256, 384)      # the tiled merge's lane widths


def switch_widths(n: int, above: int = 0) -> list:
    """The widths of the JAX version's width switch over n lanes: n over
    each of :data:`WIDTH_FRACS` rounded up to 128, those in (above, n),
    then n itself (ascending)."""
    widths = []
    for frac in WIDTH_FRACS:
        w = -(-int(n // frac) // 128) * 128
        if above < w < n and w not in widths:
            widths.append(w)
    return widths + [n]


def switched_width(widths, n_live: int) -> int:
    """The width the switch picks for the batch's largest live count: the
    narrowest that holds it, else the last."""
    return next((w for w in widths if n_live <= w), widths[-1])


def tile_width(N: int, n_tile: int) -> int:
    """The lanes a tile row gets in the JAX version's tiled merge of
    candidate width N (``_tiled_merge_packed``'s switch): the narrowest of
    :data:`TILE_WIDTHS` below N that holds the batch's largest tile
    ``n_tile``; 0 where the merge runs untiled (N < 256, or no such
    width)."""
    if N < 256:
        return 0
    return next((ct for ct in TILE_WIDTHS if ct < N and n_tile <= ct), 0)


def tile_layout(packed, T: int = TILES):
    """Each particle's live candidates (act > 0.5, w > 0) of 2D planes
    [P, 7, N] by quadrant about their centroid: tile 2 [x > cx] + [y > cy],
    dead lanes last. Returns (order [P, N]: the lanes in tile-major order,
    one stable sort, so each tile keeps the weight-descending order;
    counts [P, T]; starts [P, T], each tile's first position in order)."""
    w, act, mx, my = packed[:, 0], packed[:, 1], packed[:, 2], packed[:, 3]
    live = (act > 0.5) & (w > 0)
    livef = live.to(packed.dtype)
    cnt = torch.clamp_min(livef.sum(dim=1), 1.0)
    cx = (livef * mx).sum(dim=1) / cnt
    cy = (livef * my).sum(dim=1) / cnt
    tid = 2 * (mx > cx[:, None]).to(torch.int64) \
        + (my > cy[:, None]).to(torch.int64)
    tid = torch.where(live, tid, T)
    order = torch.sort(tid, dim=1, stable=True).indices
    counts = (tid[:, :, None] == torch.arange(T, device=tid.device)).sum(
        dim=1)
    return order, counts, torch.cumsum(counts, dim=1) - counts


def tile_index(layout, ct: int, N: int):
    """The column index of the tile rows: (idx [P, T ct] int32, lane j of
    tile t of particle p at order[p, starts[p, t] + j], clamped into
    [0, N); valid [P, T ct], j below the tile's count)."""
    order, counts, starts = layout
    P, T = counts.shape
    j = torch.arange(ct, device=order.device)
    flat = torch.clamp(starts[:, :, None] + j, 0, N - 1).reshape(P, T * ct)
    return (torch.gather(order, 1, flat).to(torch.int32),
            (j < counts[:, :, None]).reshape(P, T * ct))


def tile_rows(packed, layout, ct: int):
    """The tile rows [P T, 7, ct] of planes [P, 7, N]: tile t of particle
    p in row p T + t, its lanes first in weight-descending order, w and
    act zeroed past its count. One column gather (kernels/gather_cols.py)
    reads them through :func:`tile_index`."""
    from ..kernels.gather_cols import gather_cols
    P, C, N = packed.shape
    T = layout[1].shape[1]
    idx, valid = tile_index(layout, ct, N)
    g = gather_cols(idx, packed)                            # [P, 7, T ct]
    g = torch.cat([g[:, :2] * valid[:, None].to(g.dtype), g[:, 2:]], dim=1)
    return g.reshape(P, C, T, ct).transpose(1, 2).reshape(P * T, C, ct)


def interleave_tiles(mg, T: int = TILES):
    """Per-tile merge tuples of rows [P T, K / T] -> one [P, K] tuple,
    lane j T + t holding tile t's j-th cluster; n_merged is T times the
    largest tile's count (the live clusters' prefix bound), n_dropped the
    tiles' sum."""
    om, oc, ow, nm, nd = mg
    P = ow.shape[0] // T
    k = ow.shape[1]

    def weave(x):
        return x.reshape(P, T, k, *x.shape[2:]).transpose(1, 2).reshape(
            P, T * k, *x.shape[2:])
    return (weave(om), weave(oc), weave(ow),
            T * nm.reshape(P, T).amax(dim=1), nd.reshape(P, T).sum(dim=1))


def tiled_merge_packed(packed, layout, ct: int, min_separation: float,
                       out_cap: int):
    """The spatially tiled greedy merge of 2D planes [P, 7, N] (the JAX
    version's ``_tiled_merge_packed``): the quadrants of
    :func:`tile_layout` as rows of ct lanes (:func:`tile_rows`, ct at
    least the largest tile), each merged on its own by the sorted-mode
    merge2d kernel (Mahalanobis) with out_cap / 4 clusters, interleaved
    back (:func:`interleave_tiles`). Returns the merge tuple (mean, cov, w,
    n_merged, n_dropped)."""
    from ..kernels.merge import merge2d
    T = layout[1].shape[1]
    out = merge2d(tile_rows(packed, layout, ct), float(min_separation),
                  out_cap // T, sorted_w=True, metric=0)
    return interleave_tiles(merge_out(out, 2), T)
