"""Multi-process parallelism: the particle axis split into contiguous
blocks over a ``torch.distributed`` group (port of ``phdslam_tpu/parallel``).
Importing it initializes nothing."""

from . import distributed
from .sharding import (PARTICLE_AXIS, Mesh, gather_state,
                       init_sharded_disparity_state, init_sharded_state,
                       local_noise, make_mesh, make_sharded_disparity_step_fn,
                       make_sharded_step_fn, shard_disparity_state,
                       shard_state)

__all__ = [
    "PARTICLE_AXIS", "Mesh", "distributed", "gather_state",
    "init_sharded_disparity_state", "init_sharded_state", "local_noise",
    "make_mesh", "make_sharded_disparity_step_fn", "make_sharded_step_fn",
    "shard_disparity_state", "shard_state",
]
