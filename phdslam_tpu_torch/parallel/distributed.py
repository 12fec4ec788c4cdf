"""Multi-process runtime (port of ``phdslam_tpu/parallel/distributed.py``):
process-group initialisation and the global particle mesh.

One process per GPU. ``initialize`` wires the processes into one
``torch.distributed`` group, after which :func:`global_mesh` spans them
and the sharded step of :mod:`.sharding` runs on it: every rank holds one
contiguous block of particles, and the step's cross-particle points move
O(P) scalars between the ranks (the resampling migration moves map rows).

The backend follows the device and is never tried: NCCL for CUDA tensors
with one GPU per rank, Gloo for the CPU, and Gloo on CUDA tensors only
where the caller passes ``backend="gloo"`` (several ranks sharing one card,
which NCCL refuses; every collective then stages its buffers through host
memory, :class:`.sharding.Mesh`). A failed initialisation raises: nothing
falls back to another backend or to one process.

Launch (the same command on every rank)::

    torchrun --nproc-per-node N -m phdslam_tpu_torch cfg/ackerman.cfg \\
        synth --out-dir runs/dist --distributed

or programmatically::

    from phdslam_tpu_torch.parallel import distributed
    distributed.initialize()                 # False without a launcher
    mesh = distributed.global_mesh()
    step = make_sharded_step_fn(cfg, mesh)

Only the primary process (rank 0) writes logs and checkpoints
(:func:`is_primary`).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# a rank waits this long for its peers (at init and in every collective)
# before the group fails: a missing peer raises instead of hanging
DEFAULT_TIMEOUT_S = 120.0


def backend_for(device, backend: Optional[str] = None) -> str:
    """The process group's backend for ``device``: the caller's, else NCCL
    for a CUDA device and Gloo for the CPU. NCCL on the CPU is refused."""
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: the port runs nccl or gloo")
    if backend == "nccl" and kind != "cuda":
        raise ValueError("backend nccl needs a CUDA device")
    return backend


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None, device="cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Initialize the process group when running under a launcher.

    Reads torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT``, or the explicit arguments (e.g. a
    ``file://`` store for tests). Returns False, touching nothing, when
    neither is there (the single-process case: :func:`global_mesh` is then
    None); else initializes the group with a finite ``timeout_s``
    and returns whether it spans more than one process, as the JAX
    version does. Under NCCL each rank takes the GPU ``LOCAL_RANK`` and a
    node with fewer GPUs than local ranks raises. Any failure raises. A
    group already initialized is kept.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if init_method is None and "MASTER_ADDR" not in env:
        return False
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(env["RANK"]) if rank is None else rank
    backend = backend_for(device, backend)
    if backend == "nccl":
        local = local_rank()
        n_gpu = torch.cuda.device_count()
        local_world = int(env.get("LOCAL_WORLD_SIZE", local + 1))
        if n_gpu < local_world:
            raise RuntimeError(
                f"nccl: {local_world} local ranks but {n_gpu} GPUs; NCCL "
                "takes one GPU per rank (share one card with "
                "backend='gloo')")
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size() > 1


def local_rank() -> int:
    """This process's rank on its node (torchrun's ``LOCAL_RANK``, else the
    global rank)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device="cuda") -> torch.device:
    """The device this rank computes on: the CPU for a CPU run; under NCCL
    the GPU ``LOCAL_RANK``; otherwise (one process, or Gloo on CUDA) the
    one card ``cuda:0``, which every rank then shares."""
    kind = torch.device(device).type
    if kind != "cuda":
        return torch.device(kind)
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", local_rank())
    return torch.device("cuda", 0)


def is_primary() -> bool:
    """True on the process that writes logs and checkpoints (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(device="cuda"):
    """1-D particle mesh over every process of the group, each on its
    :func:`local_device`; None (the unsharded path) without a group."""
    from .sharding import make_mesh
    return make_mesh(device=local_device(device))


def process_local_batch(p_total: int) -> int:
    """Particles this process holds of ``p_total`` (one contiguous block)."""
    n = world_size()
    if p_total % n != 0:
        raise ValueError(f"n_particles={p_total} not divisible by "
                         f"{n} processes")
    return p_total // n
