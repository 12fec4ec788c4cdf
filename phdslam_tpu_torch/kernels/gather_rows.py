"""Batched row gather: out[p, c, :] = tab[p, idx[p, c], :].

Replaces ``phdslam_tpu/ops/pallas_select.py::_rows_kernel`` (entry
``onehot_rows_batch``). The TPU kernel multiplied by a one-hot matrix on
the MXU because gathers serialize there; the result is an exact row copy,
and an index outside [0, R) selects nothing and gives a zero row (as
``onehot_rows_xla``'s one-hot product does). No path of the JAX package
calls it; the port keeps it beside the column gather for callers that hold
feature-major tables. :func:`gather_rows` launches the CUDA kernel
(csrc/gather_rows.cu) for CUDA tensors and runs the plain twin
:func:`gather_rows_reference` for CPU tensors.
"""

from __future__ import annotations

import torch

from ..runtime import profiling
from . import build


def gather_rows_reference(idx, tab):
    """Plain PyTorch twin. idx [P, cap] int, tab [P, R, C] f32 ->
    [P, cap, C] f32."""
    P, R, C = tab.shape
    ok = (idx >= 0) & (idx < R)
    safe = torch.where(ok, idx, 0).to(torch.int64)
    got = torch.gather(tab, 1, safe[:, :, None].expand(P, idx.shape[1], C))
    return torch.where(ok[:, :, None], got, 0.0)


def gather_rows(idx, tab):
    """Row gather; same contract as :func:`gather_rows_reference`.

    A CPU tensor runs the twin; a CUDA tensor launches the kernel
    (idx must be int32), counted as ``gather_rows`` when each particle's
    [R, C] slab fits ``build.GATHER_SMEM_BUDGET`` (staged in shared memory)
    and as ``gather_rows_ldg`` above it (the table read through ``__ldg``).
    """
    if tab.is_cpu:
        return gather_rows_reference(idx, tab)
    P, R, C = tab.shape
    build.check_gather("gather_rows", idx, tab, C, R)
    cap = idx.shape[1]
    out = tab.new_empty((P, cap, C))
    if out.numel() == 0:
        return out
    # the [R, C] slab goes to shared memory when it fits the budget, else
    # the kernel reads the table through __ldg; 16-byte row copies need
    # C % 4 == 0 and aligned tab and out
    staged = build.gather_staged(R * C)
    t_ptr, o_ptr = tab.data_ptr(), out.data_ptr()
    vec = C % 4 == 0 and (t_ptr | o_ptr) % 16 == 0
    name = "gather_rows" if staged else "gather_rows_ldg"
    with profiling.kernel(name):
        err = build.library().phd_gather_rows(
            idx.data_ptr(), t_ptr, o_ptr, P, R, C, cap, staged, vec,
            build.stream_handle(tab.device))
    build.check_launch(err, "gather_rows")
    build.launch_counts[name] += 1
    return out
