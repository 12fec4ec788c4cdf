"""Exact sequential greedy merge of 2D, 3D and 4D candidate planes.

``merge2d`` replaces ``phdslam_tpu/ops/pallas_merge.py::_merge_kernel`` ->
``_merge_core_2d`` (entries ``gm_merge_pallas_batch_packed`` and
``gm_merge_pallas_batch``) in its four variants: sorted_w True (the fast
paths' top-cap-compacted, weight-descending lanes) or False (argmax
principal over any lane order: the full candidate grid), Mahalanobis or
Hellinger metric. ``merge3d`` replaces ``_merge_kernel_3d`` (entry
``gm_merge_pallas_batch_3d``) and ``merge4d`` replaces ``_merge_kernel_4d``
(entries ``gm_merge_pallas_batch_packed_4d`` and, in argmax mode,
``gm_merge_pallas_one_4d``), in the closed forms of
``ops/math.py::mahalanobis2_3d`` and ``mahalanobis2_4d``: sorted_w=True
as the fast paths call them, and for merge4d also sorted_w=False (the
argmax mode of the mixed model's per-particle route, "merge4d_argmax").
Both also take the Hellinger metric on sorted lanes ("merge3d_hellinger",
"merge4d_hellinger"), which the JAX package runs in XLA's gm_merge at
D = 3 and 4 (``ops/gm_merge.py`` says which contract holds).

Input planes [P, C, N]: w, act, the D mean planes, the D(D+1)/2 upper-
triangle covariance planes (C = 7 at D = 2, 11 at D = 3, 16 at D = 4),
active lanes weight-descending. Output planes
(``ops/gm_merge.py::pack_merge_out``): w, mean, covariance, lanes left
unmerged (broadcast), zero pads ([P, 8, K] at D = 2, [P, 12, K] at D = 3,
[P, 16, K] at D = 4), clusters in greedy emission order, empty slots as
weight 0, mean 0, identity covariance. A wrapper launches its CUDA kernel
(csrc/merge2d.cu; merge3d.cu and merge4d.cu on the round core of
csrc/merge_core.cuh) for CUDA tensors and runs its plain twin
(``*_reference``) for CPU tensors. Each merge2d variant counts
its launches under its own name (:func:`merge2d_variant`).

Width: a CUDA launch of up to :data:`NARROW_LANES` lanes (8192 at D = 2,
2048 at D = 3 and 4) runs the narrow kernel, a wider one the staged
wide-lane variant of the same mode and metric (csrc/merge_wide.cuh: the
entering lanes compacted into one block-wide list, no lane cap; the
entries past a block's shared ones in a scratch the wrapper allocates),
counted under the variant's name with "_wide" appended. ``wide=True``
forces the staged variant at any width (its check against the narrow
kernel).

``merge2d_tables`` replaces ``_merge_tables_kernel`` (fused_gather_merge,
entry ``gm_merge_pallas_batch_tables``): the fused column gather + combine
+ sorted-mode merge, reading each entering lane straight from the
deferred-gather tables, with either metric. Its twin is the two-kernel
route in plain PyTorch (two ``gather_cols_reference``, the combine,
``merge2d_reference``) with the Pallas kernel's floor-form bearing wrap.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.ekf import combine_selected_planes
from ..ops.gm_merge import gm_merge_batch, pack_merge_out, unpack_planes
from ..runtime import profiling
from . import build
from .detect import _wrap_angle_floor
from .gather_cols import gather_cols_reference

# the dispatch threshold: lanes a particle the narrow kernels hold (one
# 32-bit mask word a thread: 64 threads in merge3d / merge4d, up to 256 in
# merge2d); a wider launch takes the staged wide-lane variant
NARROW_LANES = {2: 8192, 3: 2048, 4: 2048}
_PLANES = {2: (7, 8), 3: (11, 12), 4: (16, 16)}  # D -> (input, output)
TABLE_ROWS = (16, 8)     # t_k, t_m rows of the fused route (D = 2, births)


PLAN_KEYS = ("threads", "entries", "smem", "blocks_per_sm", "overflow",
             "registers", "waves")
_plans: dict = {}


def uses_wide(D: int, N: int, wide=None) -> bool:
    """Whether a merge of N lanes at dimension D takes the staged wide-lane
    variant: above :data:`NARROW_LANES`, or as ``wide`` forces."""
    return N > NARROW_LANES[D] if wide is None else bool(wide)


def merge2d_plan(P: int, N: int, sorted_w: bool = True, metric: int = 0,
                 tables: bool = False, device=None, wide=None) -> dict:
    """The launch plan of a merge2d variant (``tables``: merge2d_tables)
    for P particles of N lanes on a CUDA device (csrc/merge2d.cu::
    make_plan; above NARROW_LANES, or with ``wide``, the staged variant's,
    csrc/merge_wide.cuh::wide_plan): threads a block, entering lanes a
    block keeps in shared memory, dynamic shared memory a block (bytes),
    resident blocks an SM, entries that may lie past the shared ones
    (N - entries), registers a thread, waves. Cached."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    wide = uses_wide(2, N, wide)
    key = (index, P, N, bool(sorted_w), int(metric), bool(tables), wide)
    plan = _plans.get(key)
    if plan is None:
        out = (ctypes.c_int * len(PLAN_KEYS))()
        fn = build.library().phd_merge2d_wide_plan if wide \
            else build.library().phd_merge2d_plan
        with torch.cuda.device(index):
            err = fn(P, N, int(not sorted_w), int(metric), int(tables), out)
        build.check_launch(err, "merge2d plan")
        plan = _plans[key] = dict(zip(PLAN_KEYS, out))
    return plan


def merge_plan(D: int, P: int, N: int, device=None, sorted_w: bool = True,
               metric: int = 0, wide=None) -> dict:
    """The launch plan of a merge3d (D = 3) or merge4d (D = 4) variant for
    P particles of N lanes on a CUDA device (csrc/merge_core.cuh::plan; the
    staged variant's above NARROW_LANES or with ``wide``), in
    merge2d_plan's keys: threads a block, lanes a block keeps in shared
    memory (narrow: N), dynamic shared memory a block (bytes), resident
    blocks an SM, overflow (narrow: 0), registers a thread, waves.
    Cached."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    wide = uses_wide(D, N, wide)
    key = (index, P, N, D, bool(sorted_w), int(metric), wide)
    plan = _plans.get(key)
    if plan is None:
        out = (ctypes.c_int * len(PLAN_KEYS))()
        name = f"phd_merge{D}d" + ("_wide_plan" if wide else "_plan")
        with torch.cuda.device(index):
            err = getattr(build.library(), name)(
                P, N, int(not sorted_w), int(metric), out)
        build.check_launch(err, f"merge{D}d plan")
        plan = _plans[key] = dict(zip(PLAN_KEYS, out))
    return plan


def recip_check(n: int, seed: int = 0, mode: int = 0, device=None) -> dict:
    """csrc/merge_core_check.cu on a CUDA device: n pseudo-random operand
    pairs (mode 0: any finite floats; mode 1: magnitudes 2^-27 to 2^28)
    through the 3D and 4D merges' quotient (merge_core.cuh::Recip) beside
    IEEE f32 division. Returns the pairs tested, those Recip declines (the
    kernels divide those in IEEE f32) and those whose quotients differ in
    any bit (none, where the quotient is exact)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    err = build.library().phd_merge_recip_check(
        n, seed, mode, counts.data_ptr(), build.stream_handle(dev))
    build.check_launch(err, "merge recip check")
    tested, declined, differ = counts.tolist()
    return {"tested": tested, "declined": declined, "differ": differ}


def merge2d_variant(sorted_w: bool = True, metric: int = 0,
                    tables: bool = False, D: int = 2,
                    wide: bool = False) -> str:
    """The launch-count name of a merge variant: "merge2d" (sorted,
    Mahalanobis), "merge2d_argmax", "merge2d_hellinger",
    "merge2d_argmax_hellinger", the fused route's "merge2d_tables",
    "merge2d_tables_hellinger", and at D = 3 and 4 "merge3d",
    "merge3d_hellinger", "merge4d", "merge4d_argmax", "merge4d_hellinger"
    (the variants built, :data:`VARIANTS_3D4D`); each staged wide-lane
    variant with "_wide" appended ("merge2d_argmax_wide", ...)."""
    return f"merge{D}d" + ("_tables" if tables else "") \
        + ("" if sorted_w else "_argmax") \
        + ("_hellinger" if metric == 1 else "") + ("_wide" if wide else "")


# the merge3d and merge4d variants built: D -> ((sorted_w, metric), ...)
VARIANTS_3D4D = {3: ((True, 0), (True, 1)),
                 4: ((True, 0), (False, 0), (True, 1))}


def _reference(packed, min_separation, out_cap, D, sorted_w=True, metric=0):
    mean, cov, w, act = unpack_planes(packed, D)
    om, oc, ow, _, n_dropped = gm_merge_batch(
        mean, cov, w, act, min_separation, out_cap, distance_metric=metric,
        argmax=not sorted_w)
    return pack_merge_out(om, oc, ow, n_dropped)


def merge2d_reference(packed, min_separation: float, out_cap: int,
                      sorted_w: bool = True, metric: int = 0):
    """Plain PyTorch twin of merge2d: ``ops/gm_merge.py::gm_merge_batch``
    on [P, 7, N] planes, in sorted (``sorted_w``) or argmax mode, with the
    Mahalanobis (``metric`` 0) or Hellinger (1) distance."""
    return _reference(packed, min_separation, out_cap, 2, sorted_w, metric)


def merge3d_reference(packed, min_separation: float, out_cap: int,
                      metric: int = 0):
    """Plain PyTorch twin of merge3d: ``ops/gm_merge.py::gm_merge_batch``
    on [P, 11, N] planes, Mahalanobis (``metric`` 0) or Hellinger (1)."""
    return _reference(packed, min_separation, out_cap, 3, True, metric)


def merge4d_reference(packed, min_separation: float, out_cap: int,
                      sorted_w: bool = True, metric: int = 0):
    """Plain PyTorch twin of merge4d: ``ops/gm_merge.py::gm_merge_batch``
    on [P, 16, N] planes, in sorted (``sorted_w``) or argmax mode
    (Mahalanobis), or sorted with the Hellinger distance (``metric`` 1)."""
    return _reference(packed, min_separation, out_cap, 4, sorted_w, metric)


def _spill(P, n_vals, X, device):
    """A staged wide-lane launch's scratch for X entries a particle past
    its shared ones: values [P, n_vals, X] f32 and states [P, X] uint8
    (None, None when X is 0)."""
    if X <= 0:
        return None, None
    return (torch.empty((P, n_vals, X), dtype=torch.float32, device=device),
            torch.empty((P, X), dtype=torch.uint8, device=device))


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(packed, min_separation, out_cap, D, sorted_w=True, metric=0,
            wide=None):
    name = f"merge{D}d"
    c_in, c_out = _PLANES[D]
    build.require(packed.device.type == "cuda",
                  f"{name}: unsupported device {packed.device}")
    build.require(packed.dim() == 3 and packed.shape[1] == c_in,
                  f"{name}: planes {tuple(packed.shape)}, want "
                  f"[P, {c_in}, N]")
    build.require(packed.dtype == torch.float32 and packed.is_contiguous(),
                  f"{name}: contiguous float32 planes required")
    P, _, N = packed.shape
    build.require(out_cap > 0, f"{name}: out_cap={out_cap}")
    build.require(metric in (0, 1) and (
        D == 2 or (bool(sorted_w), metric) in VARIANTS_3D4D[D]),
        f"{name}: sorted_w={sorted_w}, metric={metric} not built")
    wide = uses_wide(D, N, wide)
    out = torch.empty((P, c_out, out_cap), dtype=torch.float32,
                      device=packed.device)
    if P == 0:
        return out
    args = (P, N, out_cap, float(min_separation), int(not sorted_w),
            int(metric), build.stream_handle(packed.device))
    variant = merge2d_variant(sorted_w, metric, D=D, wide=wide)
    if wide:
        # the values and states of the entries past the block's shared
        # ones (the plan's overflow X a particle)
        plan = (merge2d_plan(P, N, sorted_w, metric, device=packed.device,
                             wide=True) if D == 2 else
                merge_plan(D, P, N, packed.device, sorted_w, metric, True))
        spill, states = _spill(P, c_in - 1, plan["overflow"], packed.device)
        with profiling.kernel(variant):
            err = getattr(build.library(), f"phd_{name}_wide")(
                packed.data_ptr(), out.data_ptr(), _ptr(spill),
                _ptr(states), *args)
    else:
        with profiling.kernel(variant):
            err = getattr(build.library(), f"phd_{name}")(
                packed.data_ptr(), out.data_ptr(), *args)
    build.check_launch(err, variant)
    build.launch_counts[variant] += 1
    return out


def merge2d(packed, min_separation: float, out_cap: int,
            sorted_w: bool = True, metric: int = 0, wide=None):
    """Greedy 2D merge; same contract as :func:`merge2d_reference`.

    A CPU tensor runs the twin; a CUDA tensor launches the kernel (the
    staged wide-lane variant above 8192 lanes or with ``wide``).
    """
    if packed.device.type == "cpu":
        return merge2d_reference(packed, min_separation, out_cap, sorted_w,
                                 metric)
    return _launch(packed, min_separation, out_cap, 2, sorted_w, metric, wide)


def merge3d(packed, min_separation: float, out_cap: int, metric: int = 0,
            wide=None):
    """Greedy 3D (u, v, d) merge; same contract as
    :func:`merge3d_reference`.

    A CPU tensor runs the twin; a CUDA tensor launches the kernel (the
    staged wide-lane variant above 2048 lanes or with ``wide``).
    """
    if packed.device.type == "cpu":
        return merge3d_reference(packed, min_separation, out_cap, metric)
    return _launch(packed, min_separation, out_cap, 3, True, metric, wide)


def merge4d(packed, min_separation: float, out_cap: int,
            sorted_w: bool = True, metric: int = 0, wide=None):
    """Greedy 4D merge; same contract as :func:`merge4d_reference`.

    A CPU tensor runs the twin; a CUDA tensor launches the kernel (the
    staged wide-lane variant above 2048 lanes or with ``wide``).
    """
    if packed.device.type == "cpu":
        return merge4d_reference(packed, min_separation, out_cap, sorted_w,
                                 metric)
    return _launch(packed, min_separation, out_cap, 4, sorted_w, metric, wide)


def tables_packed(ints, flts, t_k, t_m):
    """The packed merge planes [P, 7, N] that the two-kernel route builds
    from merge2d_tables' operands (ints [P, 4, N] int: k_eff, m_eff, is_p,
    is_d; flts [P, 2, N] f32: cand_w, sel_act; t_k [P, 16, K], t_m
    [P, 8, M]): two column gathers and the combine, with the Pallas
    kernel's floor-form bearing wrap; w zeroed off sel_act."""
    r_k = gather_cols_reference(ints[:, 0], t_k)
    r_m = gather_cols_reference(ints[:, 1], t_m)
    sel = flts[:, 1] > 0.5
    mean_pl, cov_pl = combine_selected_planes(
        r_k, r_m, ints[:, 2] > 0, ints[:, 3] > 0, sel, 2, True,
        wrap=_wrap_angle_floor)
    return torch.stack([torch.where(sel, flts[:, 0], 0.0),
                        sel.to(flts.dtype)] + mean_pl + cov_pl, dim=1)


def merge2d_tables_reference(ints, flts, t_k, t_m, min_separation: float,
                             out_cap: int, metric: int = 0):
    """Plain PyTorch twin of merge2d_tables: the two-kernel route, the
    sorted-mode merge of :func:`tables_packed` -> merge planes
    [P, 8, out_cap]."""
    return merge2d_reference(tables_packed(ints, flts, t_k, t_m),
                             min_separation, out_cap, True, metric)


def tables_operands(gather):
    """merge2d_tables' lane operands from a deferred-gather dict
    (``filters/phd.py::deferred_gather``): ints [P, 4, N] int32 (k_eff,
    m_eff, is_p, is_d) and flts [P, 2, N] (cand_w, sel_act)."""
    g = gather
    ints = torch.stack([g["k_eff"].to(torch.int32),
                        g["m_eff"].to(torch.int32),
                        g["is_p"].to(torch.int32), g["is_d"].to(torch.int32)],
                       dim=1)
    flts = torch.stack([g["cand_w"], g["sel_act"].to(g["cand_w"].dtype)],
                       dim=1)
    return ints, flts


def merge2d_tables(ints, flts, t_k, t_m, min_separation: float,
                   out_cap: int, metric: int = 0, wide=None):
    """Fused column gather + combine + sorted greedy 2D merge; same
    contract as :func:`merge2d_tables_reference`.

    A CPU tensor runs the twin; a CUDA tensor launches the kernel (ints
    int32, the rest float32, all contiguous; the staged wide-lane variant
    above 8192 lanes or with ``wide``).
    """
    if flts.device.type == "cpu":
        return merge2d_tables_reference(ints, flts, t_k, t_m, min_separation,
                                        out_cap, metric)
    dev = flts.device
    wide = uses_wide(2, ints.shape[-1], wide)
    name = merge2d_variant(True, metric, tables=True, wide=wide)
    build.require(dev.type == "cuda", f"{name}: unsupported device {dev}")
    P, _, N = ints.shape
    build.require(ints.shape == (P, 4, N) and flts.shape == (P, 2, N)
                  and t_k.dim() == 3 and t_m.dim() == 3
                  and (t_k.shape[:2], t_m.shape[:2])
                  == ((P, TABLE_ROWS[0]), (P, TABLE_ROWS[1])),
                  f"{name}: ints {tuple(ints.shape)}, flts "
                  f"{tuple(flts.shape)}, t_k {tuple(t_k.shape)}, t_m "
                  f"{tuple(t_m.shape)}")
    build.require(ints.dtype == torch.int32 and all(
        x.dtype == torch.float32 for x in (flts, t_k, t_m)),
        f"{name}: int32 ints and float32 planes required")
    build.require(all(x.device == dev and x.is_contiguous()
                      for x in (ints, flts, t_k, t_m)),
                  f"{name}: contiguous inputs on one device required")
    build.require(out_cap > 0 and metric in (0, 1),
                  f"{name}: out_cap={out_cap}, metric={metric}")
    out = torch.empty((P, 8, out_cap), dtype=torch.float32, device=dev)
    if P == 0:
        return out
    # room for the entering lanes past the block's shared-memory entries,
    # written only where more lanes enter than the plan's entries
    plan = merge2d_plan(P, N, True, metric, tables=True, device=dev,
                        wide=wide)
    spill, states = _spill(P, 6, plan["overflow"], dev)
    ptrs = (ints.data_ptr(), flts.data_ptr(), t_k.data_ptr(), t_m.data_ptr())
    tail = (out.data_ptr(), P, N, t_k.shape[2], t_m.shape[2], out_cap,
            float(min_separation), int(metric), build.stream_handle(dev))
    with profiling.kernel(name):
        if wide:
            err = build.library().phd_merge2d_tables_wide(
                *ptrs, _ptr(spill), _ptr(states), *tail)
        else:
            err = build.library().phd_merge2d_tables(*ptrs, _ptr(spill),
                                                     *tail)
    build.check_launch(err, name)
    build.launch_counts[name] += 1
    return out
