"""Systematic (low-variance) particle resampling (port of
``phdslam_tpu/ops/resample.py``).

Stratum j draws r_j = (j + u_j) / N with u_j ~ U(0, 1); its ancestor is the
first index whose cumulative weight reaches r_j. Strata past the weight sum
(an overrun from rounding) take the max-weight particle. The uniforms are
an argument, so a test can feed the port the JAX version's draws.
"""

from __future__ import annotations

import torch

SCAN_BLOCK = 1024


def cumsum_fixed_order(x):
    """Inclusive cumsum of a 1D tensor whose rounding is the same on every
    call. A 1D ``torch.cumsum`` on a CUDA tensor runs one single-pass scan
    whose tiles take their prefixes from whichever predecessors have
    finished, so past one tile the f32 sums change from call to call.
    Up to SCAN_BLOCK entries that plain scan is kept (one tile); beyond
    it, each row of SCAN_BLOCK entries is scanned on its own (a fixed
    order) and the exclusive cumsum of the row totals (one tile up to
    SCAN_BLOCK squared entries) is added to each row."""
    n, block = x.shape[0], SCAN_BLOCK
    if n <= block:
        return torch.cumsum(x, dim=0)
    nb = -(-n // block)
    rows = torch.cumsum(torch.nn.functional.pad(x, (0, nb * block - n))
                        .view(nb, block), dim=1)
    offs = torch.cat([torch.zeros_like(rows[:1, -1]),
                      torch.cumsum(rows[:-1, -1], dim=0)])
    return (rows + offs[:, None]).reshape(-1)[:n]


def systematic_ancestors(log_weight, u, n_out):
    """Ancestor indices [n_out] int64 for uniforms ``u`` [n_out]."""
    P = log_weight.shape[0]
    c = cumsum_fixed_order(torch.exp(log_weight))
    r = (torch.arange(n_out, dtype=log_weight.dtype,
                      device=log_weight.device) + u) / n_out
    idx = torch.searchsorted(c, r, side="left")
    max_idx = torch.argmax(log_weight)
    return torch.where(idx >= P, max_idx, idx)


def effective_sample_ratio(log_weight):
    """nEff / N = 1 / (N * sum exp(2 w))."""
    P = log_weight.shape[0]
    return 1.0 / (torch.sum(torch.exp(2.0 * log_weight)) * P)
