"""Resampling migration over the particle mesh (port of
``phdslam_tpu/parallel/migrate.py``).

After resampling, rank r needs the rows of its ancestors, which may live on
other ranks. Gathering every rank's whole block to pick the few needed
(the exact full gather) moves the entire map state. Two facts make most of
that traffic avoidable:

1. the ancestry is replicated (every rank computes it from the same
   gathered log weights), so every rank knows which rows every other rank
   needs;
2. systematic resampling emits sorted ancestors, so in equilibrium a
   rank's ancestors lie in its own block and its ring neighbours'.

The neighbour exchange: rows whose ancestor is local are gathered in place;
for each ring neighbour the SENDER compacts exactly the rows that
neighbour needs into an [R]-row buffer, in the receiver's row order (both
sides derive it from the ancestry), and one point-to-point exchange with
each of ranks r + 1 and r - 1 (mod size) moves the buffers. A replicated
feasibility test (every ancestor within one rank of its row, at most R
rows on each edge) chooses between it and the exact full gather; it is
read on the host, since the two routes run different collectives.
"""

from __future__ import annotations

import torch

from ..runtime import profiling
from .sharding import Mesh, particle_leaves, replace_leaves


def default_row_budget(block: int) -> int:
    """Per-edge row budget: half a block, at least 8 rows."""
    return max(8, block // 2)


def neighbor_feasible(anc, n_dev: int, block: int, budget: int):
    """Replicated predicate (a bool tensor): every ancestor within one rank
    of its output row, and every (sender -> receiver) edge needing at most
    ``budget`` rows."""
    P = anc.shape[0]
    own = torch.arange(P, device=anc.device) // block
    diff = anc.to(torch.int64) // block - own
    ok = torch.all(torch.abs(diff) <= 1)
    for s in (-1, 1):
        per_recv = (diff == s).to(torch.int64).view(n_dev, block).sum(dim=1)
        ok = ok & torch.all(per_recv <= budget)
    return ok


def _pack(leaves):
    """Leaves [L, ...] of one dtype as one [L, F] buffer."""
    dtypes = {x.dtype for x in leaves}
    if len(dtypes) != 1:
        raise ValueError(f"migration packs leaves of one dtype, got {dtypes}")
    L = leaves[0].shape[0]
    return torch.cat([x.reshape(L, -1) for x in leaves], dim=1)


def _unpack(flat, like):
    out, at = [], 0
    for x in like:
        n = x[0].numel()
        out.append(flat[:, at:at + n].reshape((flat.shape[0],)
                                              + x.shape[1:]))
        at += n
    return out


def gather_rows_neighbor(mesh: Mesh, anc, leaves, budget=None):
    """Neighbour migration of per-particle leaves.

    ``anc`` [P] int (the replicated global ancestry), ``leaves``: this
    rank's blocks [L, ...] of one dtype, L = P / size. The caller has
    checked :func:`neighbor_feasible`. Returns the migrated blocks:
    row j of rank d holds global row anc[d L + j], bit for bit."""
    n_dev, d = mesh.size, mesh.rank
    P = anc.shape[0]
    L = P // n_dev
    R = budget or default_row_budget(L)
    anc = anc.to(torch.int64)
    flat = _pack(leaves)
    iota = torch.arange(L, device=anc.device)
    my_anc = anc[d * L:(d + 1) * L]
    src_dev = my_anc // L
    local_idx = torch.clamp(my_anc - d * L, 0, L - 1)
    out = torch.where((src_dev == d)[:, None], flat[local_idx], 0.0)

    pairs, ranks = [], []
    for s in (-1, 1):
        # sender: the rows receiver d + s needs from my block, in its
        # row order
        recv = (d + s) % n_dev
        recv_anc = anc[recv * L:(recv + 1) * L]
        keys = torch.where(recv_anc // L == d, iota, L)
        pos = torch.sort(keys).values[:R]
        src_rows = torch.clamp(recv_anc[torch.clamp(pos, max=L - 1)]
                               - d * L, 0, L - 1)
        pairs.append((recv, flat[src_rows], (d - s) % n_dev))
        # receiver: the same order, rebuilt from my ancestry
        needed = src_dev == (d - s) % n_dev
        ranks.append((needed,
                      torch.clamp(torch.cumsum(needed.to(torch.int64), 0)
                                  - 1, 0, R - 1)))
    for buf, (needed, rank) in zip(mesh.exchange(pairs), ranks):
        out = torch.where(needed[:, None], buf[rank], out)
    return _unpack(out, leaves)


def full_gather(mesh: Mesh, idx_local, leaves):
    """The exact full gather: every rank's blocks gathered, then the rows
    ``idx_local`` [L] (global indices) taken."""
    flat = mesh.all_gather(_pack(leaves), "full_gather")
    return _unpack(flat[idx_local.to(torch.int64)], leaves)


def _migrated(state):
    """The leaves a migration carries: every per-particle leaf but
    resample_idx, which the caller sets."""
    return [(p, x) for p, x in particle_leaves(state)
            if p != ("resample_idx",)]


def gather_particles_full(state, idx_local, mesh: Mesh):
    """``state``'s rows ``idx_local`` (global indices) by the full gather,
    every leaf but resample_idx (shotgunning's P k -> P contraction, and
    the fallback of :func:`gather_particles_sharded`)."""
    paths, leaves = zip(*_migrated(state))
    new = full_gather(mesh, idx_local, list(leaves))
    st = mesh.stats
    st.migrations["full"] += 1
    st.migration_bytes["full"] += sum(x.nbytes for x in leaves) \
        * (mesh.size - 1)
    return replace_leaves(state, dict(zip(paths, new)))


def gather_particles_sharded(state, ancestors, mesh: Mesh, cfg):
    """The resampling gather on a particle mesh: rank r's rows become the
    global rows ``ancestors`` [P] (replicated) of its block. The
    neighbour exchange when it is feasible; the exact full gather where
    the JAX version takes it: size <= 2, an infeasible ancestry, or
    ``neighbor_migration = 0`` (P % size != 0 never reaches here: the
    state is sharded in equal blocks). Carries pose, log_weight, both
    maps, variance, the CPHD cardinality and prev_z (every leaf of a
    disparity state likewise)."""
    P = ancestors.shape[0]
    n_dev = mesh.size
    block = P // n_dev
    idx_local = ancestors[mesh.rows(P)]
    if n_dev <= 2 or not getattr(cfg, "neighbor_migration", 1):
        return gather_particles_full(state, idx_local, mesh)
    budget = min(getattr(cfg, "migration_row_budget", 0)
                 or default_row_budget(block), block)
    with profiling.host_sync("migrate_feasible"):
        feasible = bool(neighbor_feasible(ancestors, n_dev, block, budget))
    if not feasible:
        return gather_particles_full(state, idx_local, mesh)
    paths, leaves = zip(*_migrated(state))
    new = gather_rows_neighbor(mesh, ancestors, list(leaves), budget)
    row_bytes = sum(x[0].nbytes for x in leaves)
    mesh.stats.migrations["neighbour"] += 1
    mesh.stats.migration_bytes["neighbour"] += 2 * budget * row_bytes
    return replace_leaves(state, dict(zip(paths, new)))
