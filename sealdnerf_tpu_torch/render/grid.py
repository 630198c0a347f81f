"""Occupancy (density) grid state and maintenance (port of
sealdnerf_tpu/render/grid.py).

State: density_grid [CAS, H^3] f32 (-1 marks cells no training camera
sees), occ bool [CAS, H, H, H], mean_density, iter_density. Raster (x, y, z)
cell order.

- mark_untrained_grid: camera-frustum coverage; uncovered cells get -1.
- update_density_grid: density re-query of every cell (full=True), of
  given cells (`indices`) or of H^3/2 random cells, EMA max(grid * decay,
  new), mean-density threshold, occupancy refresh. The jitter inside each
  cell is drawn on the grid's device from a torch.Generator, or passed in
  as `noise_u` (uniform draws) so that a test can hand both packages the
  same numbers.
- refresh_indices: the cells of one in-loop refresh of training (the
  reference FastTrainer's grid_update): deterministic half-grid slabs for
  the first WARMUP_CALLS calls, then H^3/2 random cells.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass(frozen=True)
class GridConfig:
    bound: float = 1.0
    cascades: int = 1
    grid_size: int = 128
    density_thresh: float = 0.01
    density_scale: float = 1.0
    decay: float = 0.95


def init_grid_state(cfg: GridConfig, device=None):
    h3 = cfg.grid_size ** 3
    return {
        "density_grid": torch.zeros((cfg.cascades, h3), device=device),
        "occ": torch.zeros((cfg.cascades,) + (cfg.grid_size,) * 3,
                           dtype=torch.bool, device=device),
        "mean_density": torch.zeros((), device=device),
        "iter_density": torch.zeros((), dtype=torch.int32, device=device),
    }


# refresh calls that sweep deterministic half-grid slabs: two calls are one
# full sweep, 32 calls the reference's 16 full sweeps
WARMUP_CALLS = 32


def _coords_of(idx, h: int):
    """Raster-order cell indices -> [N, 3] int64 cell coords."""
    return torch.stack([idx // (h * h), (idx // h) % h, idx % h], dim=-1)


def _cell_coords(h: int, device):
    """[H^3, 3] int64 raster-order cell coords."""
    return _coords_of(torch.arange(h ** 3, device=device), h)


def refresh_indices(iter_density: int, cfg: GridConfig,
                    generator: Optional[torch.Generator] = None,
                    device=None):
    """Cells of one training refresh call: while iter_density <
    WARMUP_CALLS the slab (it % 2) * H^3/2 + arange(H^3/2), after that
    H^3/2 cells drawn uniformly from [0, H^3), duplicates allowed."""
    h3 = cfg.grid_size ** 3
    if iter_density < WARMUP_CALLS:
        return (iter_density % 2) * (h3 // 2) + torch.arange(h3 // 2,
                                                             device=device)
    return torch.randint(0, h3, (h3 // 2,), generator=generator,
                         device=device)


def _cas_bound(cfg: GridConfig, cas: int) -> float:
    return min(float(1 << cas), cfg.bound)


def mark_untrained_grid(state, poses, intrinsics, cfg: GridConfig,
                        chunk: int = 1 << 15):
    """Set cells never seen by any training camera to -1.
    poses: [B, 4, 4] cam2world tensor; intrinsics: [4] (fx, fy, cx, cy)."""
    h = cfg.grid_size
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    world = 2.0 * _cell_coords(h, poses.device).float() / (h - 1) - 1.0
    rot = poses[:, :3, :3]
    trans_cam = torch.einsum("bc,bcd->bd", poses[:, :3, 3], rot)
    grid = state["density_grid"].clone()
    for cas in range(cfg.cascades):
        bound = _cas_bound(cfg, cas)
        half = bound / h
        cas_world = world * (bound - half)
        seen = []
        for i in range(0, cas_world.shape[0], chunk):
            cam = torch.einsum("nc,bcd->bnd", cas_world[i:i + chunk], rot) \
                - trans_cam[:, None, :]
            mz = cam[..., 2] > 0
            mx = cam[..., 0].abs() < cx / fx * cam[..., 2] + half * 2
            my = cam[..., 1].abs() < cy / fy * cam[..., 2] + half * 2
            seen.append((mz & mx & my).any(dim=0))
        seen = torch.cat(seen)
        grid[cas] = torch.where(seen, grid[cas], torch.full_like(grid[cas],
                                                                 -1.0))
    return {**state, "density_grid": grid}


def update_density_grid(state, density_fn: Callable, cfg: GridConfig,
                        full: bool = False,
                        generator: Optional[torch.Generator] = None,
                        noise_u=None, indices=None):
    """One density-grid refresh. density_fn(x [N, 3]) -> sigma [N].

    full=True sweeps every cell; otherwise the cells `indices` [N] (raster
    order; duplicates allowed) are queried, or H^3/2 random cells when
    indices is None.
    generator: draws the cells and the in-cell jitter; it lives on the
    grid's device, so that the draws are made there.
    noise_u: optional [CAS, N, 3] uniform draws in [0, 1) that replace the
    jitter draws.
    """
    h = cfg.grid_size
    h3 = h ** 3
    grid = state["density_grid"]
    dev = grid.device
    tmp = torch.full_like(grid, -1.0)
    if full:
        indices = torch.arange(h3, device=dev)
    elif indices is None:
        indices = torch.randint(0, h3, (h3 // 2,), generator=generator,
                                device=dev)
    indices = indices.to(dev)
    coords = _coords_of(indices, h)
    n_pts = coords.shape[0]
    xyz01 = 2.0 * coords.float() / (h - 1) - 1.0
    for cas in range(cfg.cascades):
        bound = _cas_bound(cfg, cas)
        half = bound / h
        u = noise_u[cas] if noise_u is not None else \
            torch.rand((n_pts, 3), generator=generator, device=dev)
        noise = (u.to(dev) * 2.0 - 1.0) * half
        pts = xyz01 * (bound - half) + noise
        tmp[cas, indices] = density_fn(pts) * cfg.density_scale
    valid = (grid >= 0) & (tmp >= 0)
    grid = torch.where(valid, torch.maximum(grid * cfg.decay, tmp), grid)
    mean_density = grid.clamp(min=0.0).mean()
    thresh = torch.clamp(mean_density, max=cfg.density_thresh)
    return {
        "density_grid": grid,
        "occ": (grid > thresh).reshape((cfg.cascades,) + (h,) * 3),
        "mean_density": mean_density,
        "iter_density": state["iter_density"] + 1,
    }
