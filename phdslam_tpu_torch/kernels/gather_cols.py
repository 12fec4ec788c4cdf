"""Batched column gather: out[p, c, j] = tab[p, c, idx[p, j]].

Replaces ``phdslam_tpu/ops/pallas_select.py::_cols_kernel`` (entry
``onehot_cols_batch``). The TPU kernel multiplied by a one-hot matrix on
the MXU because gathers serialize there; the result is an exact copy, and
an index outside [0, R) selects nothing and gives 0. :func:`gather_cols`
launches the CUDA kernel (csrc/gather_cols.cu) for CUDA tensors and runs
the plain twin :func:`gather_cols_reference` for CPU tensors.
"""

from __future__ import annotations

import torch

from ..runtime import profiling
from . import build


def gather_cols_reference(idx, tab):
    """Plain PyTorch twin. idx [P, cap] int, tab [P, C, R] f32 ->
    [P, C, cap] f32."""
    P, C, R = tab.shape
    ok = (idx >= 0) & (idx < R)
    safe = torch.where(ok, idx, 0).to(torch.int64)
    got = torch.gather(tab, 2, safe[:, None, :].expand(P, C, idx.shape[1]))
    return torch.where(ok[:, None, :], got, 0.0)


def gather_cols(idx, tab):
    """Column gather; same contract as :func:`gather_cols_reference`.

    A CPU tensor runs the twin; a CUDA tensor launches the kernel
    (idx must be int32), counted as ``gather_cols`` when each particle's
    [C, R] slab fits ``build.GATHER_SMEM_BUDGET`` (staged in shared memory)
    and as ``gather_cols_ldg`` above it (the table read through ``__ldg``).
    """
    if tab.is_cpu:
        return gather_cols_reference(idx, tab)
    P, C, R = tab.shape
    build.check_gather("gather_cols", idx, tab, C, R)
    cap = idx.shape[1]
    out = tab.new_empty((P, C, cap))
    if out.numel() == 0:
        return out
    # the [C, R] slab goes to shared memory when it fits the budget, else
    # a thread per output reads the table through __ldg; 16-byte index
    # loads and stores need cap % 4 == 0 and aligned idx and out
    staged = build.gather_staged(C * R)
    i_ptr, o_ptr = idx.data_ptr(), out.data_ptr()
    vec = cap % 4 == 0 and (i_ptr | o_ptr) % 16 == 0
    name = "gather_cols" if staged else "gather_cols_ldg"
    with profiling.kernel(name):
        err = build.library().phd_gather_cols(
            i_ptr, tab.data_ptr(), o_ptr, P, C, R, cap, staged, vec,
            build.stream_handle(tab.device))
    build.check_launch(err, "gather_cols")
    build.launch_counts[name] += 1
    return out
