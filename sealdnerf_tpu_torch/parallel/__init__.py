"""Data parallelism on torch.distributed (port of sealdnerf_tpu/parallel)."""

from .mesh import (Mesh, all_gather_rows, barrier, broadcast_object,
                   from_rank0, gather_shares, make_mesh, pmax, pmean, psum,
                   replicate, shard_batch, share, world_size)

__all__ = ["Mesh", "all_gather_rows", "barrier", "broadcast_object",
           "from_rank0", "gather_shares", "make_mesh", "pmax", "pmean",
           "psum", "replicate", "shard_batch", "share", "world_size"]
