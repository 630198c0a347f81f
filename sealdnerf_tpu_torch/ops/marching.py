"""Occupancy-grid ray marching into a packed sample buffer (port of
sealdnerf_tpu/ops/marching.py).

1. Candidate lattice: every ray gets K = max_steps candidate positions,
   t_k = t0 + k * dt (dt_gamma = 0, the pitch dt_min * max(bound, 1)) or the
   step ladder t <- t + clamp(t * dt_gamma, dt_min, dt_max) (dt_gamma > 0).
   The reference runs the ladder as a K-step scan; here it is the closed
   form of ops/marching_dense.py:step_ladder, within a few f32 ulps of the
   scan.
2. Occupancy test: one gather per candidate against a bool
   [cascades, H, H, H] grid, in the cascade max(mip of the position, mip of
   the step).
3. Compaction: a global cumsum over the [N * K] validity mask gives each
   kept sample its slot in a packed buffer of m_budget slots. Samples past
   the budget are dropped, as the reference drops them. ray_id ascends, and
   each ray's samples ascend in t.

The candidate lattice takes N * K * 24 bytes of temporaries or more, so
callers march rays in chunks.
"""

from dataclasses import dataclass
from typing import Optional

import torch

from .marching_dense import _mip_from_val, step_ladder

SQRT3 = 1.7320508075688772


@dataclass(frozen=True)
class MarchConfig:
    bound: float = 1.0
    cascades: int = 1        # 1 + ceil(log2(bound)) in practice
    grid_size: int = 128     # H
    dt_gamma: float = 0.0    # cone angle: step growth factor
    max_steps: int = 1024    # K: candidate count and per-ray sample cap
    min_near: float = 0.2

    @property
    def dt_min(self) -> float:
        return 2.0 * SQRT3 / self.max_steps

    @property
    def dt_max(self) -> float:
        return 2.0 * SQRT3 * (1 << (self.cascades - 1)) / self.grid_size


def candidate_ts(nears, cfg: MarchConfig, noise=None):
    """The candidate lattice ts [N, K] and its step sizes dts [N, K]; noise
    [N] in [0, 1) shifts each ray's start by that share of its first
    step."""
    k = cfg.max_steps
    dt0 = (nears * cfg.dt_gamma).clamp(cfg.dt_min, cfg.dt_max)
    t0 = nears if noise is None else nears + dt0 * noise
    if cfg.dt_gamma == 0.0:
        # the pitch grows with the bound, so that K steps span the box
        dt = cfg.dt_min * max(cfg.bound, 1.0)
        return step_ladder(t0, k, 0.0, dt, dt)
    return step_ladder(t0, k, cfg.dt_gamma, cfg.dt_min, cfg.dt_max)


def occupancy_at(xyzs, dts, occ_grid, cfg: MarchConfig):
    """Occupancy of positions xyzs [..., 3] (clamped to the bound) with
    step sizes dts [...] in occ_grid [cascades, H, H, H] -> bool [...]."""
    h = cfg.grid_size
    mx = xyzs.abs().amax(dim=-1)
    level = torch.maximum(_mip_from_val(mx, cfg.cascades),
                          _mip_from_val(dts * h * 0.5, cfg.cascades))
    mip_bound = torch.exp2(level.float()).clamp(max=cfg.bound)
    nxyz = (0.5 * (xyzs / mip_bound[..., None] + 1.0) * h).clamp(
        0.0, h - 1).to(torch.int64)
    flat = ((level * h + nxyz[..., 0]) * h + nxyz[..., 1]) * h + nxyz[..., 2]
    return occ_grid.reshape(-1)[flat]


def march_rays(rays_o, rays_d, nears, fars, occ_grid, cfg: MarchConfig,
               m_budget: int, noise: Optional[torch.Tensor] = None):
    """March N rays into a packed buffer of m_budget samples.

    Args:
      rays_o, rays_d: [N, 3] f32. nears, fars: [N] (ops.ray).
      occ_grid: bool [cascades, H, H, H].
      noise: optional [N] in [0, 1): the start-offset perturbation.

    Returns dict: xyzs [M, 3], dirs [M, 3], dts [M], ts [M], ray_id [M]
    int64 (ascending), valid [M] bool, counts [N] int64 (kept samples per
    ray), total 0-d int64 (samples before the budget drop). Padding slots
    repeat the last candidate of the last ray, as the reference's do.
    """
    n = rays_o.shape[0]
    k = cfg.max_steps
    dev = rays_o.device
    ts, dts = candidate_ts(nears, cfg, noise)
    pos = (rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]).clamp(
        -cfg.bound, cfg.bound)
    valid = occupancy_at(pos, dts, occ_grid, cfg) & (ts < fars[:, None])
    del pos

    # row-major flattening keeps each ray's samples together, in t order
    vflat = valid.reshape(-1)
    cum = torch.cumsum(vflat, 0)
    keep = vflat & (cum <= m_budget)
    total = cum[-1]
    # the kept candidates' flat indices on their slots; the rest go to the
    # overflow slot m_budget, which is cut off
    tgt = torch.where(keep, cum - 1, torch.full_like(cum, m_budget))
    src = torch.full((m_budget + 1,), n * k, dtype=torch.int64, device=dev)
    src = src.scatter_(0, tgt, torch.arange(n * k, device=dev))[:m_budget]
    packed_valid = src < n * k
    src = src.clamp(max=n * k - 1)
    ray_id = src // k
    t_p = ts.reshape(-1)[src]
    d_p = rays_d[ray_id]
    return {
        "xyzs": (rays_o[ray_id] + t_p[:, None] * d_p).clamp(-cfg.bound,
                                                           cfg.bound),
        "dirs": d_p,
        "dts": dts.reshape(-1)[src],
        "ts": t_p,
        "ray_id": ray_id,
        "valid": packed_valid,
        "counts": keep.reshape(n, k).sum(dim=1),
        "total": total,
    }
