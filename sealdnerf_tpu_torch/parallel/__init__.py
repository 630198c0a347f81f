"""Data parallelism on torch.distributed (port of sealdnerf_tpu/parallel)."""

from .mesh import (Mesh, all_gather_rows, barrier, from_rank0, make_mesh,
                   pmax, pmean, psum, replicate, shard_batch, world_size)

__all__ = ["Mesh", "all_gather_rows", "barrier", "from_rank0", "make_mesh",
           "pmax", "pmean", "psum", "replicate", "shard_batch",
           "world_size"]
