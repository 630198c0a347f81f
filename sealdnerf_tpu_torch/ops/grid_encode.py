"""Multiresolution hash / tiled grid encoding, Instant-NGP style (port of
sealdnerf_tpu/ops/grid_encode.py).

- Per level l: scale = 2^(l * log2(per_level_scale)) * H - 1 and resolution
  ceil(scale) + 1, with per_level_scale from desired_resolution; table
  sizes min(2^log2_hashmap_size, (res + 1)^D) rounded up to a multiple of 8.
- Indexing: the linear index while the running stride fits the level's
  table; hash levels that overflow use the prime-XOR hash, tiled levels
  keep the (wrapped) linear index. The reference multiplies in uint32; here
  the products are taken in int64 and masked to 32 bits, which gives the
  same indices.
- d-linear (or smoothstep) interpolation over the 2^D corners (D = 2, 3 or
  5); inputs outside [0, 1] encode to zeros. Output [..., L * C], level
  after level.
- The table's gradient is autograd of the gather (an index_add into the
  table), the inputs' gradient autograd of the interpolation.
"""

import math
from dataclasses import dataclass, field
from typing import Tuple

import torch

_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
           2165219737)
_U32 = 0xFFFFFFFF

HASH = "hash"
TILED = "tiled"


@dataclass(frozen=True)
class GridEncodeConfig:
    input_dim: int = 3
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: int = 2048
    gridtype: str = HASH
    align_corners: bool = False
    interpolation: str = "linear"  # or "smoothstep"
    # derived in __post_init__
    per_level_scale: float = field(init=False)
    resolutions: Tuple[int, ...] = field(init=False)
    offsets: Tuple[int, ...] = field(init=False)

    def __post_init__(self):
        if self.num_levels > 1:
            s = math.exp2(math.log2(self.desired_resolution
                                    / self.base_resolution)
                          / (self.num_levels - 1))
        else:
            s = 1.0
        object.__setattr__(self, "per_level_scale", s)
        max_params = 2 ** self.log2_hashmap_size
        resolutions, offsets, offset = [], [0], 0
        for lvl in range(self.num_levels):
            resolutions.append(int(math.ceil(self.level_scale(lvl))) + 1)
            size_res = int(math.ceil(self.base_resolution * s ** lvl))
            n = min(max_params, (size_res if self.align_corners
                                 else size_res + 1) ** self.input_dim)
            offset += int(math.ceil(n / 8) * 8)
            offsets.append(offset)
        object.__setattr__(self, "resolutions", tuple(resolutions))
        object.__setattr__(self, "offsets", tuple(offsets))

    def level_scale(self, level: int) -> float:
        """The level's position scale (a host double, as the reference
        computes it)."""
        return math.exp2(level * math.log2(self.per_level_scale)) \
            * self.base_resolution - 1.0

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @property
    def table_size(self) -> int:
        return self.offsets[-1]


def init_grid_table(generator: torch.Generator, cfg: GridEncodeConfig):
    """Table [table_size, level_dim], U(-1e-4, 1e-4), drawn on the CPU."""
    u = torch.rand((cfg.table_size, cfg.level_dim), generator=generator,
                   dtype=torch.float32)
    return u * 2e-4 - 1e-4


def _grid_index(cpos, cfg: GridEncodeConfig, level: int):
    """Index into level `level`'s table (without its offset) of integer
    corner coordinates cpos [..., D] int64 -> [...] int64."""
    size = cfg.offsets[level + 1] - cfg.offsets[level]
    res_stride = cfg.resolutions[level] + (0 if cfg.align_corners else 1)
    stride, index = 1, torch.zeros_like(cpos[..., 0])
    for d in range(cfg.input_dim):
        if stride > size:
            break
        index = (index + cpos[..., d] * stride) & _U32
        stride *= res_stride
    if cfg.gridtype == HASH and stride > size:
        index = cpos[..., 0] * _PRIMES[0]
        for d in range(1, cfg.input_dim):
            index = index ^ ((cpos[..., d] * _PRIMES[d]) & _U32)
    return index % size


def _corner_combine(terms, op):
    """Per-dim terms [N, D, 2] (the cell's and its +1 neighbour's) -> the
    2^D corners' op-combination [N, 2^D], corner i taking bit d of i in dim
    d, combined over the dims in order."""
    n, dims = terms.shape[0], terms.shape[1]
    acc = terms[:, 0]
    for d in range(1, dims):
        acc = op(terms[:, d, :, None], acc[:, None, :]).reshape(
            n, 1 << (d + 1))
    return acc


def _corner_index(cells, cfg: GridEncodeConfig, level: int):
    """Indices (without the level's offset) of the 2^D corners of the cells
    [N, D] int64 -> [N, 2^D], as _grid_index gives them, from per-dim terms
    of the cell and its +1 neighbour."""
    size = cfg.offsets[level + 1] - cfg.offsets[level]
    res_stride = cfg.resolutions[level] + (0 if cfg.align_corners else 1)
    c2 = torch.stack([cells, cells + 1], dim=-1)               # [N, D, 2]
    strides, stride = [], 1
    for d in range(cfg.input_dim):
        if stride > size:
            break
        strides.append(stride)
        stride *= res_stride
    if cfg.gridtype == HASH and stride > size:
        primes = torch.tensor(_PRIMES[:cfg.input_dim], dtype=torch.int64,
                              device=cells.device)
        idx = _corner_combine((c2 * primes[:, None]) & _U32,
                              torch.bitwise_xor)
    else:
        st = torch.tensor(strides + [0] * (cfg.input_dim - len(strides)),
                          dtype=torch.int64, device=cells.device)
        idx = _corner_combine(c2 * st[:, None], torch.add) & _U32
    return idx % size


def _encode(x, table, cfg: GridEncodeConfig):
    """x [N, D] f32 -> [N, L * C]: every level's corner weights and indices,
    then one gather and one weighted sum over all levels."""
    n = x.shape[0]
    oob = ((x < 0.0) | (x > 1.0)).any(dim=-1)
    off = 0.0 if cfg.align_corners else 0.5
    ws, idxs = [], []
    for level in range(cfg.num_levels):
        pos = x * cfg.level_scale(level) + off
        pf = torch.floor(pos)
        frac = pos - pf
        if cfg.interpolation == "smoothstep":
            frac = frac * frac * (3.0 - 2.0 * frac)
        cell = pf.clamp(0.0, float(cfg.resolutions[level])).to(torch.int64)
        ws.append(_corner_combine(torch.stack([1.0 - frac, frac], dim=-1),
                                  torch.mul))                  # [N, 2^D]
        idxs.append(_corner_index(cell, cfg, level) + cfg.offsets[level])
    # level-major stacks are block copies; the output is turned once
    w = torch.stack(ws)                                        # [L, N, 2^D]
    vals = table.index_select(0, torch.stack(idxs).reshape(-1))
    out = (w[..., None] * vals.reshape(w.shape + (cfg.level_dim,))).sum(2)
    out = out.permute(1, 0, 2).reshape(n, cfg.output_dim)
    return torch.where(oob[:, None], torch.zeros_like(out), out)


def grid_encode(x01, table, cfg: GridEncodeConfig, chunk: int = 1 << 20):
    """Encode points x01 [..., D] (in [0, 1]; others encode to zeros) with
    the table [table_size, C] -> [..., L * C] f32, in chunks of `chunk`
    points."""
    prefix = x01.shape[:-1]
    x = x01.reshape(-1, cfg.input_dim).float()
    out = torch.cat([_encode(x[i:i + chunk], table, cfg)
                     for i in range(0, x.shape[0], chunk)]) \
        if x.shape[0] else x.new_zeros((0, cfg.output_dim))
    return out.reshape(*prefix, cfg.output_dim)


def grid_tv_loss(table, cfg: GridEncodeConfig, x01):
    """Sampled total-variation energy of the table: at the cells of points
    x01 [N, D], 0.5 * the mean squared difference to the +1 neighbour along
    each dim, summed over dims, averaged over levels. Its gradient is the
    reference CUDA encoder's injected TV gradient."""
    off = 0.0 if cfg.align_corners else 0.5
    total = 0.0
    for level in range(cfg.num_levels):
        pos = x01 * cfg.level_scale(level) + off
        hi = float(cfg.resolutions[level] - 1)
        cell = torch.floor(pos).clamp(0.0, hi).to(torch.int64)
        o = cfg.offsets[level]
        v0 = table[_grid_index(cell, cfg, level) + o]
        for d in range(cfg.input_dim):
            nb = cell.clone()
            nb[..., d] = (nb[..., d] + 1).clamp(0, int(hi))
            v1 = table[_grid_index(nb, cfg, level) + o]
            total = total + 0.5 * torch.mean(((v0 - v1) ** 2).sum(-1))
    return total / cfg.num_levels
