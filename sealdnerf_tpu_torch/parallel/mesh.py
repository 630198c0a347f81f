"""The data-parallel mesh (port of sealdnerf_tpu/parallel/mesh.py) on
torch.distributed.

One process per rank, each driving one device, as `torchrun` launches them:
a 1-D "data" axis over which every rank draws its own share of a step's
rays, sweeps its own share of the grid's cells and renders its own band of
a frame's rows; the collectives below bring the shares together. A mesh of
one rank has no process group and its collectives return their input
untouched, so that a run on one device calls nothing of torch.distributed.

The backend follows from the layout: NCCL when every rank has a card of its
own, gloo on the CPU and when ranks share a card (NCCL refuses two ranks on
one device). Gloo takes a CUDA tensor through host memory. A failed
rendezvous or collective raises; nothing is retried under another backend.

Every collective gives the same bits on every rank: all_reduce and
all_gather hand each rank the same reduced or gathered values, and the
division of pmean is the same elementwise operation everywhere.

Work that is a list of n items (the views of an edit's proxy, the chunks of
a teacher query) is split by `share`: rank r takes items r, r + N, ...;
`gather_shares` puts every rank's results back into the whole list, in
index order, on every rank. `broadcast_object` hands rank 0's picklable
object to every rank (the GUI's command stream).
"""

import os
import pickle
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass
class Mesh:
    """This process's place on the 1-D data mesh."""

    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None    # the process group; None for one rank
    backend: Optional[str] = None     # "nccl" or "gloo"; None for one rank
    axis_name: str = "data"
    owns_group: bool = False          # make_mesh initialised the group

    def close(self):
        """Destroy the process group that make_mesh initialised."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.group, self.owns_group = None, False


def backend_for(layout: Sequence) -> str:
    """The backend of a layout (every rank's device): NCCL when every rank
    has a card of its own, else gloo."""
    devs = [torch.device(d) for d in layout]
    cards = [d.index or 0 for d in devs if d.type == "cuda"]
    if len(cards) == len(devs) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def _join(device: torch.device, rank: int, size: int, backend: str,
          init_method: str) -> Mesh:
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size)
    if rank == 0:
        print(f"[INFO] data mesh: {size} ranks over {backend}", flush=True)
    return Mesh(rank, size, device, dist.group.WORLD, backend,
                owns_group=True)


def make_mesh(device=None, layout: Optional[Sequence] = None,
              rank: Optional[int] = None,
              init_method: Optional[str] = None) -> Mesh:
    """This process's mesh.

    - layout: an explicit layout, the device of every rank in rank order;
      this process is rank `rank` and meets the others at init_method
      ("file://..." or "tcp://host:port").
    - else a process group that is already initialised: its rank and size,
      this rank on `device`.
    - else torchrun's environment (WORLD_SIZE > 1): RANK and WORLD_SIZE, the
      env:// rendezvous, this rank on `device` (NCCL for a card, gloo for the
      CPU; the caller gives each rank a card of its own).
    - else one rank on `device` (default the CPU), with no process group.
    """
    if layout is not None:
        if rank is None or init_method is None:
            raise ValueError("an explicit layout needs rank and init_method")
        layout = [torch.device(d) for d in layout]
        if len(layout) == 1:
            return Mesh(0, 1, layout[0])
        return _join(layout[rank], rank, len(layout), backend_for(layout),
                     init_method)
    device = torch.device(device if device is not None else "cpu")
    if dist.is_initialized():
        return Mesh(dist.get_rank(), dist.get_world_size(), device,
                    dist.group.WORLD, dist.get_backend())
    size = world_size()
    if size > 1:
        return _join(device, int(os.environ["RANK"]), size,
                     "nccl" if device.type == "cuda" else "gloo", "env://")
    return Mesh(0, 1, device)


def world_size() -> int:
    """The ranks of this run: an initialised process group's size, else
    torchrun's WORLD_SIZE, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def _all_reduce(mesh: Mesh, t: torch.Tensor, op) -> torch.Tensor:
    if mesh.size == 1:
        return t
    if _staged(mesh, t):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=mesh.group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=mesh.group)
    return t


def psum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks, in place; returns t."""
    return _all_reduce(mesh, t, dist.ReduceOp.SUM)


def pmax(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the ranks, in place; returns t."""
    return _all_reduce(mesh, t, dist.ReduceOp.MAX)


def pmean(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks, in place: the sum, then a division (gloo
    has no AVG); returns t."""
    if mesh.size == 1:
        return t
    return psum(mesh, t).div_(mesh.size)


def all_gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's t (the same shape on each) concatenated along the first
    axis in rank order: the row-band gather."""
    if mesh.size == 1:
        return t
    src = t.detach().contiguous()
    staged = _staged(mesh, src)
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def replicate(mesh: Mesh, tensors: Iterable[torch.Tensor]):
    """Broadcast each tensor from rank 0, in place."""
    if mesh.size == 1:
        return
    for t in tensors:
        buf = t.detach()
        if _staged(mesh, buf):
            h = buf.cpu()
            dist.broadcast(h, 0, group=mesh.group)
            buf.copy_(h)
        else:
            dist.broadcast(buf, 0, group=mesh.group)


def from_rank0(mesh: Mesh, value: float) -> float:
    """Rank 0's value of a host number, on every rank."""
    if mesh.size == 1:
        return value
    dev = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    dist.broadcast(t, 0, group=mesh.group)
    return float(t.item())


def barrier(mesh: Mesh):
    """Wait for every rank."""
    if mesh.size > 1:
        dist.barrier(group=mesh.group)


def shard_batch(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """This rank's slice of t's leading axis, which the size divides."""
    n, r = divmod(t.shape[0], mesh.size)
    if r:
        raise ValueError(f"a leading axis of {t.shape[0]} does not split "
                         f"into {mesh.size} ranks")
    return t[mesh.rank * n:(mesh.rank + 1) * n]


def share(mesh: Mesh, n: int) -> range:
    """This rank's items of a list of n: r, r + N, r + 2N, ... below n."""
    return range(mesh.rank, n, mesh.size)


def gather_shares(mesh: Mesh, mine: Sequence[torch.Tensor], n: int):
    """The whole list of n tensors, in index order, on every rank, from each
    rank's results `mine` for its items (`share(mesh, n)`, in that order).
    The tensors share dtype and trailing shape; their leading lengths may
    differ. Each rank's results are sent once: the lengths in one
    collective, then the rows padded to the longest rank's in another
    (where n < N, rank 0 first tells the ranks without an item the dtype
    and trailing shape)."""
    mine = list(mine)
    if mesh.size == 1:
        return mine
    if len(mine) != len(share(mesh, n)):
        raise ValueError(f"rank {mesh.rank} holds {len(mine)} of the "
                         f"{len(share(mesh, n))} items it shares")
    if n == 0:
        return []
    proto = (mine[0].dtype, tuple(mine[0].shape[1:])) if mine else None
    if n < mesh.size:
        proto = broadcast_object(mesh, proto)
    dtype, tail = proto
    dev = mesh.device
    width = 1
    for d in tail:
        width *= d
    lens = torch.zeros(mesh.size, (n + mesh.size - 1) // mesh.size,
                       dtype=torch.int64)
    for j, t in enumerate(mine):
        lens[mesh.rank, j] = t.shape[0]
    lens = psum(mesh, lens.to(dev)).cpu()
    longest = int(lens.sum(dim=1).max())
    rows = torch.zeros((longest, width), dtype=dtype, device=dev)
    if mine:
        flat = torch.cat([t.reshape(t.shape[0], width) for t in mine])
        rows[:flat.shape[0]] = flat
    every = all_gather_rows(mesh, rows).reshape(mesh.size, longest, width)
    out = [None] * n
    for r in range(mesh.size):
        off = 0
        for j, i in enumerate(range(r, n, mesh.size)):
            k = int(lens[r, j])
            out[i] = every[r, off:off + k].reshape((k,) + tail)
            off += k
    return out


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's picklable `obj` on every rank (the others' is ignored)."""
    if mesh.size == 1:
        return obj
    dev = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    if mesh.rank == 0:
        data = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                dtype=torch.uint8).to(dev)
        size = torch.tensor([data.numel()], dtype=torch.int64, device=dev)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=dev)
    dist.broadcast(size, 0, group=mesh.group)
    if mesh.rank != 0:
        data = torch.empty(int(size.item()), dtype=torch.uint8, device=dev)
    dist.broadcast(data, 0, group=mesh.group)
    if mesh.rank == 0:
        return obj
    return pickle.loads(data.cpu().numpy().tobytes())
