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
    (idx must be int32).
    """
    if tab.device.type == "cpu":
        return gather_rows_reference(idx, tab)
    build.require(tab.device.type == "cuda",
                  f"gather_rows: unsupported device {tab.device}")
    P, R, C = tab.shape
    build.require(idx.dim() == 2 and idx.shape[0] == P,
                  f"gather_rows: idx {tuple(idx.shape)} vs tab "
                  f"{tuple(tab.shape)}")
    build.require(idx.dtype == torch.int32 and tab.dtype == torch.float32,
                  "gather_rows: int32 idx and float32 tab required")
    build.require(idx.device == tab.device, "gather_rows: idx on another "
                  "device")
    build.require(idx.is_contiguous() and tab.is_contiguous(),
                  "gather_rows: contiguous inputs required")
    cap = idx.shape[1]
    out = torch.empty((P, cap, C), dtype=torch.float32, device=tab.device)
    if out.numel() == 0:
        return out
    err = build.library().phd_gather_rows(
        idx.data_ptr(), tab.data_ptr(), out.data_ptr(), P, R, C, cap,
        build.stream_handle(tab.device))
    build.check_launch(err, "gather_rows")
    build.launch_counts["gather_rows"] += 1
    return out
