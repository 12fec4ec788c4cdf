"""Systematic (low-variance) particle resampling (port of
``phdslam_tpu/ops/resample.py``).

Stratum j draws r_j = (j + u_j) / N with u_j ~ U(0, 1); its ancestor is the
first index whose cumulative weight reaches r_j. Strata past the weight sum
(an overrun from rounding) take the max-weight particle. The uniforms are
an argument, so a test can feed the port the JAX version's draws.

On a particle mesh (``parallel/sharding.py``) the step gathers the P log
weights once and these functions run on the gathered vector, on every
rank, in the unsharded order; :func:`normalize_log_weights` and
:func:`max_over_particles` are the two reductions the updates end with,
:func:`particle_row` takes the MAP particle's row.
"""

from __future__ import annotations

import torch

from .math import logsumexp

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


def every_particle(x, mesh=None):
    """``x`` [b, ...], this rank's particles, gathered over the mesh
    ([P, ...] in global order); ``x`` itself without a mesh."""
    return x if mesh is None else mesh.all_gather(x)


def normalize_log_weights(log_w, mesh=None):
    """log_w - logsumexp over every particle: this rank's block normalized
    by the sum over the mesh's gathered log weights (the unsharded
    normalizer, bit for bit)."""
    return log_w - logsumexp(every_particle(log_w, mesh), dim=0)


def particle_scalars(log_weight, pose, mesh=None):
    """Every particle's log weights [P] and poses [P, D]: the arguments
    themselves without a mesh, else one all-gather of the ranks' blocks
    (rows in global order)."""
    if mesh is None:
        return log_weight, pose
    both = mesh.all_gather(torch.cat([log_weight[:, None], pose], dim=1))
    return both[:, 0].contiguous(), both[:, 1:].contiguous()


def particle_row(i, leaves, mesh=None):
    """Row ``i`` (a global particle index, a 0-dim tensor on the device)
    of every leaf: without a mesh a gather on the device
    (``index_select``), the same bits as ``x[i]`` but with no read of
    ``i`` to the host, so the step does not wait for the card here; on a
    mesh taken from the rank that holds it (``Mesh.take_row``)."""
    if mesh is None:
        at = i.reshape(1)
        return [torch.index_select(x, 0, at)[0] for x in leaves]
    return mesh.take_row(i, leaves)


def max_over_particles(x, mesh=None):
    """The largest entry of ``x`` over every particle of the mesh."""
    m = torch.amax(x)
    return m if mesh is None else mesh.all_max(m)
