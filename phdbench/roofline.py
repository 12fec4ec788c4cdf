"""The least time one H100 could take for a kernel's work, from the work's
own shapes: the larger of its bytes over HBM bandwidth and its float32
operations over the float32 peak (NVIDIA's H100 SXM data sheet, dense
rates at the 700 W power limit). The counts follow the operation, not an
implementation, so the bound is the same whichever kernel carries it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12       # HBM3, 80 GB part
F32_OPS_PER_S = 67e12           # float32 outside the tensor cores


def bound_s(n_bytes: float, n_ops: float) -> float:
    """Seconds: the larger of the memory and the compute bound."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def detect_bound_s(P: int, M: int, K: int, T: int) -> float:
    """One fused detection + top-T over P particles, M measurements and K
    features: its 6 input planes [P, 6, K] and the measurements [M, 4] read
    once; vals and idx [P, M, T] and norm and count [P, M] written once;
    21 float32 operations per (particle, measurement, feature) lane for the
    detection term pd w N(z; h(x), S) and its live test (one exp)."""
    n_bytes = 4 * (6 * P * K + 4 * M) + 8 * P * M * T + 8 * P * M
    return bound_s(n_bytes, 21 * P * M * K)


def merge_bound_s(P: int, N: int, K: int) -> float:
    """One greedy 2D merge of candidate planes [P, 7, N] into [P, 8, K]
    clusters, where the lanes that enter are not seen: the activity plane
    read once and the output planes written once (the entering lanes'
    other planes and their distances, which the run cannot count without
    reading the card, are left out, so this is a lower bound)."""
    return bound_s(4 * (P * N + 8 * P * K), 0)


def cardinality_bound_s(P: int, C1: int) -> float:
    """One CPHD cardinality prediction of P log cardinalities over C1 = C+1
    values under a shared birth cardinality: log_cn [P, C1] and the birth
    cardinality [C1] read once, the prediction [P, C1] written once; the
    convolution's C1 (C1 + 1) / 2 (n, j) lanes a particle, a multiply and
    an add each, and an exp and a log a value."""
    return bound_s(4 * (2 * P * C1 + C1), P * C1 * (C1 + 1) + 2 * P * C1)
