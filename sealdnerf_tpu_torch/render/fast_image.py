"""Tile-band whole-image rendering (port of `render_image_tiled` in
sealdnerf_tpu/render/fast_image.py).

1. March only the tile-center rays (one ray per tile_px x tile_px pixels)
   against a conservatively dilated occupancy grid: for a pinhole camera a
   sample at distance t on the tile-center ray lies within the tile's
   footprint of the same point on every ray of the tile, so the dilated
   interval set covers every pixel of the tile.
2. Broadcast each tile's intervals to its pixels and expand them into fine
   samples per pixel ray.
3. Evaluate the field on planar [3, M] samples (the fused kernel's layout)
   and composite densely.

The reference's bucketed variant (per-tile interval budgets, termination
trim) is not ported yet; this renderer is the exact one of the two.
"""

from typing import Callable

import torch

from ..data.rays import get_rays
from ..ops.composite import composite_rays
from ..ops.marching_dense import (DenseMarchConfig, dilate_occ,
                                  expand_intervals, march_intervals)
from ..ops.ray import near_far_from_aabb


def _march_tiles(to, td, tnear, tfar, occ_m, cfg: DenseMarchConfig,
                 dilate: int):
    """Tile-center coarse march on the dilated grid. Returns (t_entry
    [T, Sc], iv_valid [T, Sc], far [T]); far is padded by the dilation so
    that the pixel rays of a tile reach its band."""
    occ_d = dilate_occ(occ_m if occ_m.dim() == 3 else occ_m[0], dilate)
    far = tfar + cfg.voxel * (dilate + 1)
    t_entry, iv_valid = march_intervals(to, td, tnear, far, occ_d, cfg)
    return t_entry, iv_valid, far


def render_image_tiled(params, occ_m, pose, intr, rh: int, rw: int,
                       cfg: DenseMarchConfig, forward_fn: Callable, bg_color,
                       tile_px: int = 8, dilate: int = 1,
                       density_scale: float = 1.0, t_thresh: float = 1e-4,
                       extra=()):
    """Render a full image.

    Args:
      params: field params or packed tables, passed through to forward_fn.
      occ_m: bool [M, M, M] occupancy at cfg.march_res.
      pose: [4, 4] cam2world. intr: [4] fx fy cx cy (at render res).
      rh, rw: render resolution, multiples of tile_px.
      forward_fn: (params, x3 [3, M], d3 [3, M], *extra) -> out [>= 4, M]
        with rows (sigma, r, g, b).
      bg_color: [3] tensor.
      extra: further arguments of forward_fn: (t,) for a time-conditioned
        field, whose occ_m is then the slice of that time.

    Returns (image [rh, rw, 3], depth [rh, rw]).
    """
    if rh % tile_px or rw % tile_px:
        raise ValueError(f"{rh}x{rw} is not a multiple of tile {tile_px}")
    th, tw = rh // tile_px, rw // tile_px
    b = cfg.bound
    dev = pose.device
    aabb = torch.tensor([-b] * 3 + [b] * 3, dtype=torch.float32, device=dev)

    # tile-center rays: the image downsampled by tile_px
    tr = get_rays(pose[None], intr / tile_px, th, tw, -1)
    to, td = tr["rays_o"][0], tr["rays_d"][0]               # [T, 3]
    tnear, tfar = near_far_from_aabb(to, td, aabb, cfg.min_near)
    t_entry, iv_valid, tfar = _march_tiles(to, td, tnear, tfar, occ_m, cfg,
                                           dilate)

    # broadcast the tile intervals to pixels
    def to_pixels(a):
        return a.reshape(th, 1, tw, 1, -1).expand(
            th, tile_px, tw, tile_px, a.shape[-1]).reshape(rh * rw, -1)

    pe, pv = to_pixels(t_entry), to_pixels(iv_valid)
    pfar = to_pixels(tfar[:, None])[:, 0]

    # per-pixel rays and fine samples, planar [3, n*s]
    pr = get_rays(pose[None], intr, rh, rw, -1)
    ro, rd = pr["rays_o"][0], pr["rays_d"][0]               # [P, 3]
    mr = expand_intervals(pe, pv, pfar, cfg)
    ts, dts, valid = mr["ts"], mr["dts"], mr["valid"]
    n, s = ts.shape
    x3 = torch.empty((3, n * s), dtype=torch.float32, device=dev)
    d3 = torch.empty((3, n * s), dtype=torch.float32, device=dev)
    for a in range(3):
        da = rd[:, a]
        x3[a] = (ro[:, a][:, None] + ts * da[:, None]).clamp(-b, b).reshape(-1)
        d3[a] = da[:, None].expand(n, s).reshape(-1)
    out = forward_fn(params, x3, d3, *extra)
    del x3, d3
    sigma = torch.where(valid, out[0].reshape(n, s) * density_scale,
                        torch.zeros_like(ts))
    # channel rows as an [n, s, 3] view: no copy of the colours
    rgb = out[1:4].reshape(3, n, s).permute(1, 2, 0)
    comp = composite_rays(sigma, rgb, dts, ts=ts, t_thresh=t_thresh)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    image = (comp["image"] + (1.0 - comp["weights_sum"])[:, None] * bg
             ).clamp(0.0, 1.0)
    return image.reshape(rh, rw, 3), comp["depth"].reshape(rh, rw)
