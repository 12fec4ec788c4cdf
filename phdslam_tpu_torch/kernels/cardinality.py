"""The CPHD cardinality prediction's product in one fixed order.

``cardinality_product(lin, T)`` is ``lin @ T`` for lin [P, J] and T
[J, N] (float32) with every output summed j ascending from 0, so that a
row's bits do not depend on the other rows of the batch: a sharded CPHD
step, whose ranks each hold a block of rows, repeats the one-process step
bit for bit. ``filters/cphd.py::cardinality_predict_batch`` runs it in
place of the JAX package's f32 dot (``phdslam_tpu/filters/cphd.py:105``,
XLA; no Pallas kernel there), whose library product picks its sum order
from the batch's shape. A CUDA tensor launches csrc/cardinality.cu,
counted as ``cardinality_product``; a CPU tensor runs the plain twin
:func:`cardinality_product_reference`, which sums in the same order.
"""

from __future__ import annotations

import torch

from . import build


def cardinality_product_reference(lin, T):
    """Plain PyTorch twin: lin [P, J] @ T [J, N], each output summed j
    ascending from 0 in element-wise f32 ops (the kernel's order)."""
    acc = lin.new_zeros((lin.shape[0], T.shape[1]))
    for j in range(lin.shape[1]):
        acc = acc + lin[:, j, None] * T[j]
    return acc


def cardinality_product(lin, T):
    """lin [P, J] @ T [J, N] in one fixed order; same contract as
    :func:`cardinality_product_reference`. A CUDA tensor launches the
    kernel (float32, on one device)."""
    if lin.is_cpu:
        return cardinality_product_reference(lin, T)
    P, J = lin.shape
    N = T.shape[1]
    build.require(
        lin.dtype == torch.float32 and T.dtype == torch.float32
        and T.shape[0] == J and T.device == lin.device,
        f"cardinality_product: needs float32 lin [P, J] and T [J, N] on one "
        f"device; got lin {tuple(lin.shape)} {lin.dtype} on {lin.device}, "
        f"T {tuple(T.shape)} {T.dtype} on {T.device}")
    lin, T = lin.contiguous(), T.contiguous()
    out = lin.new_empty((P, N))
    err = build.library().phd_cardinality_product(
        lin.data_ptr(), T.data_ptr(), out.data_ptr(), P, J, N,
        build.stream_handle(lin.device))
    build.check_launch(err, "cardinality_product")
    build.launch_counts["cardinality_product"] += 1
    return out
