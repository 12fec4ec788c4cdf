"""Particle-axis sharding over processes (port of
``phdslam_tpu/parallel/sharding.py``).

The JAX version annotates the state with ``NamedSharding`` and lets XLA's
SPMD partitioner insert the collectives. Here each process of a
``torch.distributed`` group holds one contiguous block of P / size
particles (rank r: global rows [r b, (r + 1) b)), runs the step's
per-particle work on its block through the ported kernels, and meets the
other ranks only at the step's cross-particle points, through the
collectives of :class:`Mesh`:

* log-weight normalisation, nEff, the systematic ancestry and the
  expected pose: an all-gather of the P log weights and poses, reduced on
  every rank in the unsharded order (so every rank derives the same
  ancestry, and the sums are the unsharded sums bit for bit);
* overflow counts: an all-reduce MAX;
* the MAP particle's map (and CPHD cardinality): an all-gather of one
  candidate row per rank, the owner's taken on the device (no host read of
  the argmax);
* the EAP tree: its levels inside a block stay on the rank, the last
  log2(size) levels run on the gathered per-rank maps
  (``filters/extras.py``);
* the resampling migration: the neighbour exchange or the exact full
  gather of ``migrate.py``.

Every rank draws the step's *global* noise from the same seeded generator
and keeps its own rows (:func:`local_noise`), so a sharded run sees the
unsharded run's draws.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..config import SlamConfig
from ..types import DisparityState, FilterState, init_state

PARTICLE_AXIS = "particle"


@dataclasses.dataclass
class CollectiveStats:
    """What this rank's collectives moved since the last :meth:`reset`:
    calls and bytes received from other ranks per kind, the resampling
    migrations by route (``migrations``: "neighbour" or "full") with their
    bytes, and, with ``timing`` (the device synchronised around every
    collective), wall milliseconds per kind."""
    timing: bool = False
    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    ms: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    migrations: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    migration_bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def reset(self) -> None:
        for c in (self.calls, self.bytes, self.ms, self.migrations,
                  self.migration_bytes):
            c.clear()


@dataclasses.dataclass(eq=False)
class Mesh:
    """A 1-D particle mesh: the ``size`` processes of the default group
    (``backend`` "nccl" or "gloo"), this one being ``rank``, each
    computing on ``device``. Under Gloo on a CUDA device each collective
    stages its buffers through host memory (``staged``). One process
    without a group has no mesh: ``mesh=None`` throughout."""
    size: int
    rank: int
    device: torch.device
    backend: str
    stats: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats)
    axis_names = (PARTICLE_AXIS,)

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def transport(self) -> str:
        """How the collectives move data: "nccl" (device buffers), "gloo"
        (host tensors) or "gloo via host" (device tensors staged through
        host memory on every call)."""
        return "gloo via host" if self.staged else self.backend

    def block(self, n: int) -> int:
        """Particles a rank holds of ``n``."""
        if n % self.size:
            raise ValueError(f"n_particles={n} must be divisible by mesh "
                             f"size {self.size}")
        return n // self.size

    def rows(self, n: int) -> slice:
        """This rank's global rows of ``n`` particles."""
        b = self.block(n)
        return slice(self.rank * b, (self.rank + 1) * b)

    # ------------------------------------------------------------------
    # collectives
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def _record(self, kind: str, nbytes: int):
        st = self.stats
        st.calls[kind] += 1
        st.bytes[kind] += nbytes
        if not st.timing:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        st.ms[kind] += (time.perf_counter() - t0) * 1000.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wire(self, x):
        x = x.contiguous()
        return x.cpu() if self.staged else x

    def _back(self, x):
        return x.to(self.device) if self.staged else x

    def all_gather(self, x, kind: str = "all_gather"):
        """[b, ...] on every rank -> [size b, ...], in rank order."""
        with self._record(kind, x.nbytes * (self.size - 1)):
            w = self._wire(x)
            if self.backend == "nccl":
                out = w.new_empty((self.size * w.shape[0],) + w.shape[1:])
                dist.all_gather_into_tensor(out, w)
            else:
                parts = [torch.empty_like(w) for _ in range(self.size)]
                dist.all_gather(parts, w)
                out = torch.cat(parts)
            return self._back(out)

    def all_max(self, x):
        """The elementwise maximum of ``x`` over the ranks."""
        with self._record("all_max", x.nbytes * (self.size - 1)):
            w = self._wire(x).clone()
            dist.all_reduce(w, op=dist.ReduceOp.MAX)
            return self._back(w)

    def take_row(self, i, leaves):
        """Row ``i`` (a global particle index, a 0-dim tensor on the
        device) of every leaf [b, ...] of one dtype, on every rank: each
        rank offers its row ``i - rank b`` (clamped into its block) and the
        owner's is taken on the device, so the argmax is never read on the
        host."""
        b = leaves[0].shape[0]
        local = torch.clamp(i - self.rank * b, 0, b - 1)
        flat = torch.cat([x[local].reshape(-1) for x in leaves])
        flat = self.all_gather(flat[None], "take_row")[
            torch.div(i, b, rounding_mode="floor")]
        out, at = [], 0
        for x in leaves:
            n = x[0].numel()
            out.append(flat[at:at + n].view(x.shape[1:]))
            at += n
        return out

    def exchange(self, pairs):
        """Point-to-point exchange: for each (dst, buf, src) send ``buf``
        to mesh rank ``dst`` and receive a buffer of its shape from mesh
        rank ``src``. Returns the received buffers."""
        ops, outs = [], []
        for dst, buf, src in pairs:
            w = self._wire(buf)
            r = torch.empty_like(w)
            ops += [dist.P2POp(dist.isend, w, dst),
                    dist.P2POp(dist.irecv, r, src)]
            outs.append(r)
        nbytes = sum(r.nbytes for r in outs)
        with self._record("exchange", nbytes):
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            return [self._back(r) for r in outs]


def make_mesh(n_devices: Optional[int] = None,
              device="cuda") -> Optional[Mesh]:
    """The 1-D particle mesh over every process of the group (one device a
    process); None, the unsharded path, when no group is initialized.
    ``n_devices``, when given, must be that count: more raises, as in the
    JAX version, and so does fewer (a mesh spans the whole group)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices not in (None, world):
        raise ValueError(f"requested {n_devices} mesh devices; the group "
                         f"has {world} processes (one device each)")
    if not dist.is_initialized():
        return None
    return Mesh(size=world, rank=dist.get_rank(),
                device=torch.device(device), backend=dist.get_backend())


# ----------------------------------------------------------------------------
# per-particle leaves
# ----------------------------------------------------------------------------

def particle_leaves(state):
    """(path, tensor) of every per-particle leaf of a state dataclass (each
    tensor field, nested dataclasses walked; None and ints skipped), in
    field order. Every such leaf has the particle axis first."""
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            out.append(((f.name,), v))
        elif dataclasses.is_dataclass(v):
            out += [((f.name,) + p, x) for p, x in particle_leaves(v)]
    return out


def replace_leaves(state, new: dict):
    """``state`` with the leaves at the paths of ``new`` replaced."""
    changes = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if (f.name,) in new:
            changes[f.name] = new[(f.name,)]
        elif dataclasses.is_dataclass(v):
            sub = {p[1:]: t for p, t in new.items() if p[0] == f.name}
            if sub:
                changes[f.name] = replace_leaves(v, sub)
    return dataclasses.replace(state, **changes)


def map_leaves(state, fn):
    return replace_leaves(state, {p: fn(x) for p, x in particle_leaves(state)})


def shard_state(mesh: Mesh, state):
    """This rank's block of a global state (``FilterState`` or
    ``DisparityState``), which every rank builds the same way: every
    per-particle leaf's rows [r b, (r + 1) b) on the mesh's device
    (resample_idx keeps its global ancestor indices)."""
    n = state.log_weight.shape[0]
    rows = mesh.rows(n)
    return map_leaves(state, lambda x: x[rows].to(mesh.device).clone())


def gather_state(mesh: Mesh, state):
    """The global state rebuilt on every rank from the ranks' blocks (for
    checkpoints, logs and comparisons)."""
    return map_leaves(state, mesh.all_gather)


def init_sharded_state(cfg: SlamConfig, mesh: Mesh,
                       n_particles: Optional[int] = None) -> FilterState:
    P_total = n_particles if n_particles is not None else cfg.n_particles
    mesh.block(P_total)
    return shard_state(mesh, init_state(cfg, P_total, device=mesh.device))


# ----------------------------------------------------------------------------
# noise
# ----------------------------------------------------------------------------

def _local_draw(draw, mesh: Mesh, n_local: int):
    """A variance-sample source that draws the global sample and keeps
    this rank's particles. The estimators ask for (P, N, D) over the
    candidate grid or (2, P, N) over the selected lanes
    (``filters/extras.py``); N >= 3 lanes keeps the two layouts apart."""
    def local(s, shape):
        shape = tuple(shape)
        axis = 1 if len(shape) == 3 and shape[0] == 2 \
            and shape[1] == n_local else 0
        if shape[axis] != n_local:
            raise ValueError(f"variance draw of shape {shape} has no "
                             f"particle axis of {n_local}")
        full = list(shape)
        full[axis] = n_local * mesh.size
        return draw(s, tuple(full)).narrow(axis, mesh.rank * n_local,
                                           n_local)
    return local


def local_noise(noise, mesh: Optional[Mesh]):
    """This rank's rows of a step's global draws: ``StepNoise`` (eps_pred
    [sub, P k, w] by particle, u_resample whole, var_draw sliced per
    sample) or ``DisparityNoise`` (eps_pred and eps_sample by particle,
    u_resample whole). The noise itself without a mesh."""
    if mesh is None or mesh.size == 1:
        return noise
    from ..filters.disparity import DisparityNoise
    if isinstance(noise, DisparityNoise):
        rows = mesh.rows(noise.eps_pred.shape[0])
        return DisparityNoise(noise.eps_pred[rows], noise.eps_sample[rows],
                              noise.u_resample)
    n_ext = noise.eps_pred.shape[1]
    rows = mesh.rows(n_ext)
    var_draw = noise.var_draw
    if var_draw is not None:
        var_draw = _local_draw(var_draw, mesh, n_ext // mesh.size)
    return noise._replace(eps_pred=noise.eps_pred[:, rows],
                          var_draw=var_draw)


# ----------------------------------------------------------------------------
# sharded steps
# ----------------------------------------------------------------------------

def make_sharded_step_fn(cfg: SlamConfig, mesh: Mesh):
    """The filter step on this rank's block of a particle mesh.

    Returns ``step(state, z, z_mask, control, dt, do_predict, noise,
    has_z=None, consts=None) -> (state, out)``: ``noise`` is the step's
    global ``StepNoise`` (every rank passes the same), ``state`` this
    rank's block. The outputs' estimates (expected pose, map, nEff, the
    resampling decision, overflow, the MAP cardinality) are the same on
    every rank; their per-particle fields (log_weight, poses,
    resample_idx) are this rank's rows, resample_idx in global indices."""
    from ..filters.cphd import cphd_constants
    from ..filters.phd import phd_step
    built = (cphd_constants(cfg, device=mesh.device)
             if cfg.filter_type == 1 else None)

    def step(state, z, z_mask, control, dt, do_predict, noise, has_z=None,
             consts=None):
        return phd_step(state, z, z_mask, control, dt, do_predict, cfg,
                        local_noise(noise, mesh), has_z=has_z,
                        consts=built if consts is None else consts,
                        mesh=mesh)
    return step


def shard_disparity_state(mesh: Mesh, state: DisparityState
                          ) -> DisparityState:
    """This rank's block of a global disparity state (cam_pose,
    log_weight, cloud [P, K, N, 3], feat_weight, resample_idx)."""
    return shard_state(mesh, state)


def init_sharded_disparity_state(cfg: SlamConfig, mesh: Mesh, eps_jitter
                                 ) -> DisparityState:
    """The global initial disparity state (``eps_jitter`` [P, 2], the same
    on every rank) and this rank's block of it."""
    from ..filters.disparity import init_disparity_state
    mesh.block(cfg.n_particles)
    return shard_state(mesh, init_disparity_state(cfg, eps_jitter,
                                                  device=mesh.device))


def make_sharded_disparity_step_fn(cfg: SlamConfig, mesh: Mesh):
    """The SC-PHD disparity step on this rank's block. Returns
    ``step(state, z, z_mask, dt, do_predict, noise, has_z=None) ->
    (state, out)``, ``noise`` the step's global ``DisparityNoise``; the
    outputs are the same on every rank."""
    from ..filters.disparity import disparity_step

    def step(state, z, z_mask, dt, do_predict, noise, has_z=None):
        return disparity_step(state, z, z_mask, dt, do_predict, cfg,
                              local_noise(noise, mesh), has_z=has_z,
                              mesh=mesh)
    return step
