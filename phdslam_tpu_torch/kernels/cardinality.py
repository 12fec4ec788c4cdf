"""The CPHD cardinality prediction in one launch, in one fixed order.

``cardinality_predict_batch(log_cn, log_cn_birth)`` convolves each row of
log_cn [P, C1] (float32 log cardinality distributions) with one shared
log_cn_birth [C1] as a linear-domain Toeplitz product: subtract each row's
max, exp, the [P, C1] x [C1, C1] product with every output summed j
ascending from 0, log back (LOG0 where the sum is not > 0), add the row's
max and the birth distribution's. It replaces the JAX package's
``cardinality_predict_batch`` (``phdslam_tpu/filters/cphd.py:87``, XLA; no
Pallas kernel there), whose library product picks its sum order from the
batch's shape: here a row's bits do not depend on the other rows, so a
sharded CPHD step, whose ranks each hold a block of rows, repeats the
one-process step bit for bit. A CUDA tensor launches csrc/cardinality.cu,
counted as ``cardinality_predict``; a CPU tensor runs the plain twin
:func:`cardinality_predict_reference`, whose product
:func:`cardinality_product_reference` sums in the kernel's order.
"""

from __future__ import annotations

import torch

from ..ops.math import safe_log
from ..runtime import profiling
from . import build


def cardinality_product_reference(lin, T):
    """lin [P, J] @ T [J, N], each output summed j ascending from 0 in
    element-wise f32 ops (the kernel's order)."""
    acc = lin.new_zeros((lin.shape[0], T.shape[1]))
    for j in range(lin.shape[1]):
        acc = acc + lin[:, j, None] * T[j]
    return acc


def cardinality_predict_reference(log_cn, log_cn_birth):
    """Plain PyTorch twin of :func:`cardinality_predict_batch`: the eager
    chain of ops the kernel computes, op for op."""
    C1 = log_cn.shape[-1]
    mx = torch.amax(log_cn, dim=-1, keepdim=True)
    lin = torch.exp(log_cn - mx)
    bmax = torch.amax(log_cn_birth)
    ar = torch.arange(C1, device=log_cn.device)
    diff = ar[None, :] - ar[:, None]                       # T[j, n]
    T = torch.where(diff >= 0,
                    torch.exp(log_cn_birth[diff.clamp_min(0)] - bmax), 0.0)
    return safe_log(cardinality_product_reference(lin, T)) + mx + bmax


def cardinality_predict_batch(log_cn, log_cn_birth):
    """The predicted log cardinality [P, C1] of log_cn [P, C1] under the
    shared birth cardinality log_cn_birth [C1]; same contract as
    :func:`cardinality_predict_reference`. A CUDA tensor launches the
    kernel (float32, on one device)."""
    if log_cn.is_cpu:
        return cardinality_predict_reference(log_cn, log_cn_birth)
    P, C1 = log_cn.shape
    # the message is formatted only on a failure: a passing check costs the
    # host little
    if not (log_cn.dtype == torch.float32
            and log_cn_birth.dtype == torch.float32
            and log_cn_birth.shape == (C1,)
            and log_cn_birth.device == log_cn.device):
        raise ValueError(
            f"cardinality_predict_batch: needs float32 log_cn [P, C1] and "
            f"log_cn_birth [C1] on one device; got log_cn "
            f"{tuple(log_cn.shape)} {log_cn.dtype} on {log_cn.device}, "
            f"log_cn_birth {tuple(log_cn_birth.shape)} {log_cn_birth.dtype} "
            f"on {log_cn_birth.device}")
    log_cn, log_cn_birth = log_cn.contiguous(), log_cn_birth.contiguous()
    out = log_cn.new_empty((P, C1))
    with profiling.kernel("cardinality_predict"):
        err = build.library().phd_cardinality_predict(
            log_cn.data_ptr(), log_cn_birth.data_ptr(), out.data_ptr(), P,
            C1, build.stream_handle(log_cn.device))
    build.check_launch(err, "cardinality_predict")
    build.launch_counts["cardinality_predict"] += 1
    return out
