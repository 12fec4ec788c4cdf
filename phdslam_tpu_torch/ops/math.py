"""Core math (port of ``phdslam_tpu/ops/math.py``, plus the 3D distance
and ``chol3`` of ``filters/disparity.py``).

Batched over arbitrary leading axes on ``mean[..., D]`` / ``cov[..., D, D]``
layouts. ``jax.scipy.special.gammaln`` maps to ``torch.lgamma`` (f32 in,
f32 out). Every expression keeps the JAX version's operation order, so the
two agree to f32 rounding on the same inputs.
"""

from __future__ import annotations

import math

import torch

# finite stand-in for -FLT_MAX: exp(LOG0) == 0 in f32 without -inf arithmetic
LOG0 = -1.0e30

TWO_PI = 2.0 * math.pi


def safe_log(x: torch.Tensor) -> torch.Tensor:
    """NaN-safe log: log(x) for x > 0, LOG0 otherwise."""
    pos = x > 0
    return torch.where(pos, torch.log(torch.where(pos, x, 1.0)), LOG0)


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to [-pi, pi] with C-fmod semantics.

    Reproduces ``jnp.mod`` (fmod, then + 2 pi where the remainder is
    negative) followed by the JAX version's shifts step by step:
    ``torch.remainder`` computes ``a - 2 pi floor(a / 2 pi)``, which rounds
    differently and disagrees at +-pi and for tiny negative angles.
    """
    r = torch.fmod(a, TWO_PI)
    r = torch.where((r != 0) & (r < 0), r + TWO_PI, r)
    r = torch.where((a < 0) & (r > 0), r - TWO_PI, r)
    r = torch.where(r > math.pi, r - TWO_PI, r)
    r = torch.where(r < -math.pi, r + TWO_PI, r)
    return r


def logistic(x, lower, upper, beta, tau):
    """Generalized logistic (upper - lower) / (1 + exp(-beta (x - tau)))."""
    return (upper - lower) / (1.0 + torch.exp(-beta * (x - tau)))


def det2(A: torch.Tensor) -> torch.Tensor:
    """Determinant of batched 2x2 matrices ``A[..., 2, 2]``."""
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def inv2(A: torch.Tensor) -> torch.Tensor:
    """Inverse of batched 2x2 matrices."""
    d = det2(A)
    inv = torch.stack([
        torch.stack([A[..., 1, 1], -A[..., 0, 1]], dim=-1),
        torch.stack([-A[..., 1, 0], A[..., 0, 0]], dim=-1),
    ], dim=-2)
    return inv / d[..., None, None]


def det_nd(A: torch.Tensor) -> torch.Tensor:
    """Determinant of batched DxD matrices; closed form for D = 2."""
    return det2(A) if A.shape[-1] == 2 else torch.linalg.det(A)


def inv_nd(A: torch.Tensor) -> torch.Tensor:
    """Inverse of batched DxD matrices; closed form for D = 2."""
    return inv2(A) if A.shape[-1] == 2 else torch.linalg.inv(A)


# log(2 pi) as the JAX version evaluates it: the f32 log of f32(2 pi)
LOG_2PI = float(torch.log(torch.tensor(TWO_PI, dtype=torch.float32)))


def gaussian_logpdf(x, mean, cov) -> torch.Tensor:
    """log N(x; mean, cov) for batched inputs x, mean [..., D], cov
    [..., D, D]. The quadratic form is d' S^-1 d summed as the JAX
    version's contraction orders it, (d' S^-1) first, then with d."""
    d = x - mean
    t = (d[..., :, None] * inv_nd(cov)).sum(dim=-2)
    maha = (t * d).sum(dim=-1)
    return -0.5 * maha - 0.5 * safe_log(det_nd(cov)) \
        - 0.5 * x.shape[-1] * LOG_2PI


def sym(A: torch.Tensor) -> torch.Tensor:
    """Force symmetry: (A + A^T) / 2."""
    return 0.5 * (A + A.transpose(-1, -2))


def mahalanobis2(mean_a, cov_a, mean_b, cov_b) -> torch.Tensor:
    """Squared Mahalanobis distance with averaged covariance
    (Sigma = (cov_a + cov_b) / 2, returns d' Sigma^-1 d, 2D)."""
    sigma = 0.5 * (cov_a + cov_b)
    d = mean_a - mean_b
    S_inv = inv2(sigma)
    return torch.einsum("...i,...ij,...j->...", d, S_inv, d)


def mahalanobis2_3d(mean_a, cov_a, mean_b, cov_b) -> torch.Tensor:
    """Squared Mahalanobis distance with averaged covariance, 3D, in the
    closed-form adjugate inverse of the JAX package's 3D merge kernel
    (``ops/pallas_merge.py::_merge_kernel_3d``, ``mahal3``), operation for
    operation, with the determinant replaced by 1e-30 where its magnitude
    is not above 1e-30."""
    s = 0.5 * (cov_a + cov_b)
    d = mean_a - mean_b
    s00, s01, s02 = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
    s11, s12, s22 = s[..., 1, 1], s[..., 1, 2], s[..., 2, 2]
    d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
    det = (s00 * (s11 * s22 - s12 * s12)
           - s01 * (s01 * s22 - s12 * s02)
           + s02 * (s01 * s12 - s11 * s02))
    det = torch.where(torch.abs(det) > 1e-30, det, 1e-30)
    i00 = (s11 * s22 - s12 * s12) / det
    i01 = (s02 * s12 - s01 * s22) / det
    i02 = (s01 * s12 - s02 * s11) / det
    i11 = (s00 * s22 - s02 * s02) / det
    i12 = (s01 * s02 - s00 * s12) / det
    i22 = (s00 * s11 - s01 * s01) / det
    return (d0 * d0 * i00 + d1 * d1 * i11 + d2 * d2 * i22
            + 2.0 * (d0 * d1 * i01 + d0 * d2 * i02 + d1 * d2 * i12))


def chol3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form lower Cholesky factor of batched 3x3 SPD matrices, with
    the JAX version's 1e-20 floors under each pivot."""
    a = torch.clamp_min(A[..., 0, 0], 1e-20)
    l11 = torch.sqrt(a)
    l21 = A[..., 1, 0] / l11
    l31 = A[..., 2, 0] / l11
    l22 = torch.sqrt(torch.clamp_min(A[..., 1, 1] - l21 ** 2, 1e-20))
    l32 = (A[..., 2, 1] - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp_min(A[..., 2, 2] - l31 ** 2 - l32 ** 2,
                                     1e-20))
    z = torch.zeros_like(l11)
    return torch.stack([
        torch.stack([l11, z, z], dim=-1),
        torch.stack([l21, l22, z], dim=-1),
        torch.stack([l31, l32, l33], dim=-1)], dim=-2)


def mahalanobis2_4d(mean_a, cov_a, mean_b, cov_b) -> torch.Tensor:
    """Squared Mahalanobis distance with averaged covariance, 4D, in the
    2x2-block Schur form of the JAX package's 4D merge kernel
    (``ops/pallas_merge.py::_merge_kernel_4d``, ``mahal4``):

      d' S^-1 d = p' A^-1 p + u' (C - B' A^-1 B)^-1 u,  u = B' A^-1 p - q

    for S = [[A, B], [B', C]] and d = (p, q), with each 2x2 determinant
    replaced by 1e-30 where its magnitude is not above 1e-30. Only 2x2
    closed-form inverses appear, in the kernel's operation order.
    """
    return _schur4_quad(0.5 * (cov_a + cov_b), mean_a - mean_b)


def _schur4_quad(s, d) -> torch.Tensor:
    """d' s^-1 d of 4x4 matrices s in :func:`mahalanobis2_4d`'s Schur
    form."""
    s00, s01, s02, s03 = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2], s[..., 0, 3]
    s11, s12, s13 = s[..., 1, 1], s[..., 1, 2], s[..., 1, 3]
    s22, s23, s33 = s[..., 2, 2], s[..., 2, 3], s[..., 3, 3]
    d0, d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    det_a = s00 * s11 - s01 * s01
    det_a = torch.where(torch.abs(det_a) > 1e-30, det_a, 1e-30)
    ai00 = s11 / det_a
    ai01 = -s01 / det_a
    ai11 = s00 / det_a
    # G = A^-1 B, B = [[s02, s03], [s12, s13]]
    g00 = ai00 * s02 + ai01 * s12
    g01 = ai00 * s03 + ai01 * s13
    g10 = ai01 * s02 + ai11 * s12
    g11 = ai01 * s03 + ai11 * s13
    # the Schur complement C - B' G
    m00 = s22 - (s02 * g00 + s12 * g10)
    m01 = s23 - (s02 * g01 + s12 * g11)
    m11 = s33 - (s03 * g01 + s13 * g11)
    det_m = m00 * m11 - m01 * m01
    det_m = torch.where(torch.abs(det_m) > 1e-30, det_m, 1e-30)
    mi00 = m11 / det_m
    mi01 = -m01 / det_m
    mi11 = m00 / det_m
    v0 = ai00 * d0 + ai01 * d1
    v1 = ai01 * d0 + ai11 * d1
    pap = d0 * v0 + d1 * v1
    u0 = s02 * v0 + s12 * v1 - d2
    u1 = s03 * v0 + s13 * v1 - d3
    return pap + (u0 * u0 * mi00 + 2.0 * u0 * u1 * mi01 + u1 * u1 * mi11)


def _det3(s00, s01, s02, s11, s12, s22):
    """Determinant of symmetric 3x3 matrices (cofactors along row 0)."""
    return (s00 * (s11 * s22 - s12 * s12) - s01 * (s01 * s22 - s12 * s02)
            + s02 * (s01 * s12 - s11 * s02))


def _det4(s):
    """Determinant of symmetric 4x4 matrices s [..., 4, 4] by the 2x2
    minors of rows 0-1 and rows 2-3 (Laplace), as csrc/merge4d.cu::det4."""
    r = [[s[..., i, j] for j in range(4)] for i in range(4)]

    def minors(u, v):
        return {(a, b): u[a] * v[b] - u[b] * v[a]
                for a in range(4) for b in range(a + 1, 4)}
    a, b = minors(r[0], r[1]), minors(r[2], r[3])
    return (a[0, 1] * b[2, 3] - a[0, 2] * b[1, 3] + a[0, 3] * b[1, 2]
            + a[1, 2] * b[0, 3] - a[1, 3] * b[0, 2] + a[2, 3] * b[0, 1])


def _hell_tail(det_s, det_prod, quad_inv, quad_eye, D):
    """The Hellinger distance's last steps (csrc/merge_core.cuh::
    hell_tail): ``quad_inv`` is used where det(A + B) is above the
    smallest normal f32, the identity's ``quad_eye`` elsewhere."""
    ok = det_s > 1.1754944e-38
    eps = -0.25 * torch.where(ok, quad_inv, quad_eye)
    det_half = det_s / float(2 ** D)
    ratio = torch.sqrt(torch.clamp_min(det_prod, 0.0)) \
        / torch.clamp_min(det_half, 1e-30)
    return 1.0 - torch.sqrt(torch.clamp_min(ratio, 0.0)) * torch.exp(eps)


def hellinger2(mean_a, cov_a, mean_b, cov_b) -> torch.Tensor:
    """Hellinger-style distance of D-dimensional Gaussians, D = 2, 3 or 4
    (the JAX package's dimension-generic ``ops/math.py::hellinger2``):

      1 - sqrt( sqrt(det A det B) / det((A + B) / 2) ) exp(-d'(A + B)^-1 d / 4)

    with the identity in place of (A + B)^-1 where det(A + B) is not above
    the smallest normal f32, sqrt(max(., 0)) and det((A + B) / 2) floored
    at 1e-30. D = 2: the closed form of the 2D merge kernel
    (``ops/pallas_merge.py::_merge_core_2d``, ``pair_dist`` at metric 1),
    operation for operation. D = 3 and 4: the closed forms of
    csrc/merge3d.cu and merge4d.cu (``Hell3``, ``Hell4``), operation for
    operation, where the JAX version takes LU determinants and inverses
    (``det_nd``, ``inv_nd``) and det(A B) of the product: det A det B by
    cofactors (3D) or 2x2 minors (4D), the quadratic form through the
    adjugate of A + B (3D) or in :func:`mahalanobis2_4d`'s Schur form of
    A + B with its 1e-30 clamps (4D). The two agree to f32 rounding
    away from singular covariances."""
    D = mean_a.shape[-1]
    if D == 3:
        return _hellinger2_3d(mean_a, cov_a, mean_b, cov_b)
    if D == 4:
        return _hellinger2_4d(mean_a, cov_a, mean_b, cov_b)
    d = mean_a - mean_b
    dx, dy = d[..., 0], d[..., 1]
    a00, a01, a11 = cov_a[..., 0, 0], cov_a[..., 0, 1], cov_a[..., 1, 1]
    b00, b01, b11 = cov_b[..., 0, 0], cov_b[..., 0, 1], cov_b[..., 1, 1]
    s00 = a00 + b00
    s01 = a01 + b01
    s11 = a11 + b11
    det_s = s00 * s11 - s01 * s01
    ok = det_s > 1.1754944e-38
    det_safe = torch.where(ok, det_s, 1.0)
    quad_inv = (dx * dx * s11 - 2.0 * dx * dy * s01 + dy * dy * s00) \
        / det_safe
    quad_eye = dx * dx + dy * dy
    eps = -0.25 * torch.where(ok, quad_inv, quad_eye)
    det_half = det_s / 4.0
    det_prod = (a00 * a11 - a01 * a01) * (b00 * b11 - b01 * b01)
    ratio = torch.sqrt(torch.clamp_min(det_prod, 0.0)) \
        / torch.clamp_min(det_half, 1e-30)
    return 1.0 - torch.sqrt(torch.clamp_min(ratio, 0.0)) * torch.exp(eps)


def _upper3(c):
    return (c[..., 0, 0], c[..., 0, 1], c[..., 0, 2], c[..., 1, 1],
            c[..., 1, 2], c[..., 2, 2])


def _hellinger2_3d(mean_a, cov_a, mean_b, cov_b):
    d = mean_a - mean_b
    d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
    # A + B in the kernel's order: candidate + principal, equal bits
    s00, s01, s02, s11, s12, s22 = _upper3(cov_b + cov_a)
    det_s = _det3(s00, s01, s02, s11, s12, s22)
    j00 = s11 * s22 - s12 * s12
    j01 = s02 * s12 - s01 * s22
    j02 = s01 * s12 - s02 * s11
    j11 = s00 * s22 - s02 * s02
    j12 = s01 * s02 - s00 * s12
    j22 = s00 * s11 - s01 * s01
    q = (d0 * d0 * j00 + d1 * d1 * j11 + d2 * d2 * j22
         + 2.0 * (d0 * d1 * j01 + d0 * d2 * j02 + d1 * d2 * j12))
    quad_eye = d0 * d0 + d1 * d1 + d2 * d2
    det_safe = torch.where(det_s > 1.1754944e-38, det_s, 1.0)
    det_prod = _det3(*_upper3(cov_b)) * _det3(*_upper3(cov_a))
    return _hell_tail(det_s, det_prod, q / det_safe, quad_eye, 3)


def _hellinger2_4d(mean_a, cov_a, mean_b, cov_b):
    d = mean_a - mean_b
    s = cov_b + cov_a
    quad_eye = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
        + d[..., 2] * d[..., 2] + d[..., 3] * d[..., 3]
    return _hell_tail(_det4(s), _det4(cov_b) * _det4(cov_a),
                      _schur4_quad(s, d), quad_eye, 4)


def masked_logsumexp(logw: torch.Tensor, mask: torch.Tensor,
                     dim: int = -1) -> torch.Tensor:
    """Log-sum-exp over ``dim`` of the entries where ``mask``; LOG0 where
    nothing is selected (the max is floored at LOG0 / 2 so that LOG0 - LOG0
    never enters)."""
    logw = torch.where(mask, logw, LOG0)
    m = torch.amax(logw, dim=dim, keepdim=True)
    m_safe = torch.clamp_min(m, LOG0 * 0.5)
    s = torch.sum(torch.where(mask, torch.exp(logw - m_safe), 0.0), dim=dim)
    out = m_safe.squeeze(dim) + torch.log(torch.clamp_min(s, 1e-38))
    return torch.where(torch.any(mask, dim=dim), out, LOG0)


def logsumexp(logw: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """max + log(sum(exp(x - max))), as the JAX version computes it."""
    m = torch.amax(logw, dim=dim, keepdim=True)
    return m.squeeze(dim) + torch.log(torch.sum(torch.exp(logw - m), dim=dim))
