"""Fused detection grid + normalizer + top-T selection.

Replaces ``phdslam_tpu/ops/pallas_detect.py::_detect_kernel`` (entry
``detection_topT_batch``) in all of its modes. For every particle p and
measurement m:

  pdw[m, k] = pref[k] * exp(-0.5 d' S^-1 d)   (d = (zr - r, wrap(zb - b)))
  norm[m]   = sum_k pdw[m, k] + cb             (cb = clutter + birth weight)
  live      = pdw >= min_fw * norm  and  pdw > 0  and  z valid
  vals/idx  = the T heaviest live lanes, ties to the lowest k
  count[m]  = number of live lanes

Trips past the live lanes, and rows whose measurement is invalid, give
vals = idx = 0; an invalid row's norm is cb. ``adaptive`` (detect_adaptive)
stops the Pallas kernel's trips once a block's lanes are used up: the same
outputs, bit for bit; here it launches the same kernel, whose selection
costs the same whatever the trip count. ``min_sep > 0`` (premerge_consolidate) takes planes [P, 13, K] and
collapses, per feature column, the detection copies within min_sep of the
column's greedy head (see :func:`_consolidate`): members leave the count
and the top-T, and a fifth output cons [P, 10, K] carries their moment
sums. :func:`detect` launches the CUDA kernel (csrc/detect.cu) for CUDA
tensors and runs the plain twin :func:`detect_reference` for CPU tensors;
each variant counts its launches under its own name
(:func:`detect_variant`). Above :data:`NARROW_FEATURES` features (or with
``wide=True``) a CUDA launch takes the wide variant of the same mode
(both: the particle's planes staged once where they fit, each pdw
evaluated once over the grid, the live lanes selected among the row's
candidates; the consolidating one keeps its live-lane bits in shared
memory beside the planes, or in a scratch tensor where they do not fit),
counted with "_wide" appended.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..runtime import profiling
from . import build

TWO_PI = 2.0 * math.pi
# the dispatch threshold: features the narrow kernels hold (32 a lane in
# registers); a wider launch takes the wide variant
NARROW_FEATURES = 1024
N_PLANES = {False: 6, True: 13}     # consolidating -> input planes


def detect_variant(cons: bool = False, adaptive: bool = False,
                   wide: bool = False) -> str:
    """The launch-count name of a detect variant: "detect",
    "detect_adaptive", "detect_cons", "detect_cons_adaptive", each with
    "_wide" appended for the wide variant."""
    return "detect" + ("_cons" if cons else "") \
        + ("_adaptive" if adaptive else "") + ("_wide" if wide else "")


def _wrap_angle_floor(a):
    """The Pallas kernel's wrap (floor-mod form, then the shifts of
    ops/math.py::wrap_angle); the CUDA kernel computes the same steps
    (csrc/wrap.cuh)."""
    r = a - TWO_PI * torch.floor(a / TWO_PI)
    r = torch.where((a < 0) & (r > 0), r - TWO_PI, r)
    r = torch.where(r > math.pi, r - TWO_PI, r)
    r = torch.where(r < -math.pi, r + TWO_PI, r)
    return r


def _plane(planes, i):
    return planes[:, i, None, :]                     # [P, 1, K]


def _consolidate(planes, ir, ib, pdw, norm, live, min_sep):
    """Same-source pre-consolidation of the Pallas kernel (its ``cons_ref``
    branch), op for op. Per feature column: the head is the heaviest of the
    live copies (w_det = pdw / norm, the lowest m among ties) and the
    persistent lane (wp, which wins ties); members are the live copies
    within min_sep of the head (the copy-persistent quadratic about (0, 0)
    when the persistent lane heads, the copy-copy one about the head copy's
    innovation otherwise), none when the persistent lane is live but not
    within min_sep of the head copy. Returns (cons [P, 10, K], member
    [P, M, K])."""
    M = pdw.shape[1]
    wp = _plane(planes, 6)
    q00, q01, q11 = (_plane(planes, i) for i in (7, 8, 9))
    p00, p01, p11 = (_plane(planes, i) for i in (10, 11, 12))
    w_det = pdw / norm[..., None]
    wdl = torch.where(live, w_det, 0.0)
    colmax = wdl.amax(dim=1, keepdim=True)                   # [P, 1, K]
    has_copy = colmax > 0.0
    iota_m = torch.arange(M, device=pdw.device)[None, :, None]
    am = torch.where((wdl == colmax) & live, iota_m, M).amin(dim=1,
                                                             keepdim=True)
    is_head = live & (iota_m == am)
    uh_r = torch.where(is_head, ir, 0.0).sum(dim=1, keepdim=True)
    uh_b = torch.where(is_head, ib, 0.0).sum(dim=1, keepdim=True)
    head_p = (wp >= colmax) & (wp > 0.0)
    c_r = torch.where(head_p, 0.0, uh_r)
    c_b = torch.where(head_p, 0.0, uh_b)
    du_r = ir - c_r
    du_b = ib - c_b
    quad_q = q00 * du_r * du_r + 2.0 * q01 * du_r * du_b + q11 * du_b * du_b
    quad_p = p00 * du_r * du_r + 2.0 * p01 * du_r * du_b + p11 * du_b * du_b
    quad = torch.where(head_p, quad_p, quad_q)
    pers_near = p00 * uh_r * uh_r + 2.0 * p01 * uh_r * uh_b \
        + p11 * uh_b * uh_b
    pers_in = (wp > 0.0) & (head_p | (pers_near < min_sep)) & has_copy
    flag = has_copy & ((wp <= 0.0) | pers_in)
    member = live & (quad < min_sep) & flag
    wm = torch.where(member, w_det, 0.0)

    def ssum(x):
        return x.sum(dim=1, keepdim=True)
    cons = torch.cat([
        ssum(wm), ssum(wm * du_r), ssum(wm * du_b), ssum(wm * du_r * du_r),
        ssum(wm * du_r * du_b), ssum(wm * du_b * du_b), c_r, c_b,
        ssum(member.to(pdw.dtype)), pers_in.to(pdw.dtype)], dim=1)
    return cons, member


def detection_grid(planes, z4):
    """The twin's [P, M, K] grid: the innovations (ir, ib) and pdw (0 on
    invalid measurements)."""
    zr = z4[None, :, 0:1]                            # [1, M, 1]
    zb = z4[None, :, 1:2]
    zvalid = z4[None, :, 2:3] > 0.5
    ir = zr - _plane(planes, 0)
    ib = _wrap_angle_floor(zb - _plane(planes, 1))
    dist = _plane(planes, 2) * ir * ir + 2.0 * _plane(planes, 3) * ir * ib \
        + _plane(planes, 4) * ib * ib
    pdw = torch.where(zvalid, _plane(planes, 5) * torch.exp(-0.5 * dist), 0.0)
    return ir, ib, pdw


def detect_reference(planes, z4, top_t, min_fw, cb, min_sep=0.0,
                     adaptive=False):
    """Plain PyTorch twin. planes [P, 6, K] (r, bearing, si00, si01, si11,
    pref; with ``min_sep > 0`` [P, 13, K]: then wp, q00, q01, q11, p00,
    p01, p11), z4 [M, 4] (zr, zb, valid, pad) -> (vals [P, M, T] f32,
    idx [P, M, T] int32, norm [P, M] f32, count [P, M] int32[, cons
    [P, 10, K] f32 with ``min_sep > 0``]).

    The selection is ``ops/gm_merge.py::select_live_topT``'s stable sort,
    which stops at the live lanes by itself. ``adaptive`` is unused: it is
    here so that :func:`detect` and its twin take the same arguments, and
    it changes nothing in the kernel's outputs either.
    """
    ir, ib, pdw = detection_grid(planes, z4)
    norm = pdw.sum(dim=-1) + cb                      # [P, M]
    live = (pdw >= min_fw * norm[..., None]) & (pdw > 0)
    cons = None
    if min_sep > 0:
        cons, member = _consolidate(planes, ir, ib, pdw, norm, live, min_sep)
        live = live & ~member
    neg = torch.where(live, -pdw, 1.0)
    neg_s, idx_s = torch.sort(neg, dim=-1, stable=True)
    vals = torch.clamp_min(-neg_s[..., :top_t], 0.0)
    idx = torch.where(vals > 0, idx_s[..., :top_t], 0).to(torch.int32)
    count = live.sum(dim=-1).to(torch.int32)
    if cons is None:
        return vals, idx, norm, count
    return vals, idx, norm, count, cons


WIDE_PLAN_KEYS = ("threads", "smem", "staged", "registers",
                  "blocks_per_sm")


def detect_wide_plan(K: int, device=None, M=None) -> dict:
    """A wide variant's launch at K features on a CUDA device: threads a
    block, dynamic shared memory a block (bytes), whether the particle's
    planes are staged in shared memory (1) or read from device memory (0),
    registers a thread, resident blocks an SM. The plain variant
    (csrc/detect.cu::detect_wide_kernel) by default; with M rows the
    consolidating one (detect_cons_wide_kernel, whose live-lane bits stay
    beside staged planes)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    out = (ctypes.c_int * len(WIDE_PLAN_KEYS))()
    lib = build.library()
    with torch.cuda.device(index):
        err = (lib.phd_detect_wide_plan(K, out) if M is None
               else lib.phd_detect_cons_wide_plan(K, M, out))
    build.check_launch(err, "detect_wide plan")
    return dict(zip(WIDE_PLAN_KEYS, out))


@functools.lru_cache(maxsize=None)
def _cons_wide_scratch(K: int, M: int) -> bool:
    """Whether the consolidating wide variant at (K, M) keeps its live-lane
    bits in a scratch tensor (its planes too large to stage with them; the
    rule does not depend on the device)."""
    return not detect_wide_plan(K, M=M)["staged"]


def detect(planes, z4, top_t: int, min_fw: float, cb: float,
           min_sep: float = 0.0, adaptive: bool = False, wide=None):
    """Batched detection + top-T; same contract as :func:`detect_reference`.

    A CPU tensor runs the twin; a CUDA tensor launches the kernel, the same
    one with or without ``adaptive`` (its selection does not depend on the
    trip count), counted under the variant's name: the narrow kernel up to
    NARROW_FEATURES features, the wide one above (or with ``wide``). The
    argument check formats its message only on a failure, so a passing call
    costs the host little.
    """
    if planes.is_cpu:
        return detect_reference(planes, z4, top_t, min_fw, cb, min_sep,
                                adaptive)
    cons_on = min_sep > 0
    P, C, K = planes.shape
    M = z4.shape[0]
    if not (planes.is_cuda and C == N_PLANES[cons_on]
            and z4.shape == (M, 4) and planes.dtype == torch.float32
            and z4.dtype == torch.float32 and z4.device == planes.device
            and planes.is_contiguous() and z4.is_contiguous()
            and 0 < top_t <= K):
        raise ValueError(
            f"detect: needs contiguous float32 planes [P, "
            f"{N_PLANES[cons_on]}, K] and z4 [M, 4] "
            f"on one CUDA device, 0 < T <= K; got planes "
            f"{tuple(planes.shape)} {planes.dtype} on {planes.device}, z4 "
            f"{tuple(z4.shape)} {z4.dtype} on {z4.device}, T={top_t}, "
            f"min_sep {min_sep}")
    vals = planes.new_empty((P, M, top_t))
    idx = planes.new_empty((P, M, top_t), dtype=torch.int32)
    norm = planes.new_empty((P, M))
    count = planes.new_empty((P, M), dtype=torch.int32)
    cons = planes.new_empty((P, 10, K)) if cons_on else None
    outs = (vals, idx, norm, count) + ((cons,) if cons_on else ())
    if P == 0 or M == 0:
        if cons_on:
            cons.zero_()                 # no measurement, no member
        return outs
    wide = K > NARROW_FEATURES if wide is None else bool(wide)
    ptrs = (planes.data_ptr(), z4.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), norm.data_ptr(), count.data_ptr(),
            cons.data_ptr() if cons_on else None)
    tail = (P, K, M, top_t, float(min_fw), float(cb), float(min_sep),
            build.stream_handle(planes.device))
    name = detect_variant(cons_on, adaptive, wide)
    if wide:
        # the consolidating passes' live-lane words, a row's K bits, where
        # they are not kept in shared memory
        words = planes.new_empty((P, M, (K + 31) // 32), dtype=torch.int32) \
            if cons_on and _cons_wide_scratch(K, M) else None
        with profiling.kernel(name):
            err = build.library().phd_detect_wide(
                *ptrs, None if words is None else words.data_ptr(), *tail)
    else:
        with profiling.kernel(name):
            err = build.library().phd_detect(*ptrs, *tail)
    build.check_launch(err, name)
    build.launch_counts[name] += 1
    return outs
