"""Ray generation (port of `get_rays` and `rand_poses` in
sealdnerf_tpu/data/rays.py): the full-image case, uniform random pixels,
pixels drawn from an error map, p x p patches, and random orbit poses."""

from typing import Optional

import numpy as np
import torch


def _pixel_dirs(i, j, intrinsics):
    """Camera-space unit directions for pixel centers i (x), j (y)."""
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    d = torch.stack([(i - cx) / fx, (j - cy) / fy, torch.ones_like(i)],
                    dim=-1)
    norm = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                      + d[..., 2] * d[..., 2])
    return d / norm[..., None]


ERROR_MAP_RES = 128     # the error map's cells per side


def patch_inds(ix, iy, patch_size: int, w: int):
    """Flat pixel indices [B, P * p^2] of the p x p patches whose first
    pixels are (ix, iy) [B, P] (ix the row in [0, h - p), iy the column),
    patch-major: inds = (ix + px) * w + (iy + py), px slowest within a
    patch. patch_ssim_loss reshapes on this order."""
    p = patch_size
    ar = torch.arange(p, device=ix.device)
    px = ar.repeat_interleave(p)                       # [p^2]
    py = ar.repeat(p)
    gx = ix[..., None] + px
    gy = iy[..., None] + py
    return (gx * w + gy).reshape(ix.shape[0], -1)


def error_map_inds(error_map, h: int, w: int, n: int,
                   generator: Optional[torch.Generator] = None):
    """n pixels per row of error_map [B, 128 * 128], drawn by the map's
    weights (a categorical over its cells, with replacement), each cell
    jittered uniformly to a pixel of its (h / 128) x (w / 128) block and
    clipped to the image -> (inds [B, n], inds_coarse [B, n]), on the
    map's device."""
    r = ERROR_MAP_RES
    ic = torch.multinomial(error_map.clamp_min(1e-12), n, replacement=True,
                           generator=generator)
    cx, cy = torch.div(ic, r, rounding_mode="floor"), ic % r
    sx, sy = h / r, w / r
    u = torch.rand((2,) + ic.shape, generator=generator,
                   device=ic.device)
    ix = (cx * sx + u[0] * sx).long().clamp(0, h - 1)
    iy = (cy * sy + u[1] * sy).long().clamp(0, w - 1)
    return ix * w + iy, ic


def get_rays(poses, intrinsics, h: int, w: int, n: int = -1,
             generator: Optional[torch.Generator] = None,
             inds: Optional[torch.Tensor] = None,
             error_map: Optional[torch.Tensor] = None,
             patch_size: int = 1):
    """Generate rays for a batch of poses.

    Args:
      poses: [B, 4, 4] cam2world. intrinsics: [4] (fx, fy, cx, cy).
      h, w: image size. n: rays per image; -1 = every pixel in raster
        order, n > 0 = n random pixels drawn on the poses' device from
        `generator`, which must live there: uniform (shared by the batch),
        or with patch_size > 1 n // p^2 random p x p patches per image (n
        rounded down to whole patches; see patch_inds), or else with
        error_map [B, 128 * 128] by its weights (see error_map_inds).
      inds: optional [B, N] flat pixel indices to use instead.

    Returns dict(rays_o [B,N,3], rays_d [B,N,3], inds [B,N] or None,
    inds_coarse [B,N] (error-map draws) or None).
    """
    b = poses.shape[0]
    dev = poses.device
    out = {"inds": None, "inds_coarse": None}
    if inds is None and n > 0:
        n = min(n, h * w)
        if patch_size > 1:
            num_patch = n // (patch_size ** 2)
            ix = torch.randint(0, h - patch_size, (b, num_patch),
                               generator=generator, device=dev)
            iy = torch.randint(0, w - patch_size, (b, num_patch),
                               generator=generator, device=dev)
            inds = patch_inds(ix, iy, patch_size, w)
        elif error_map is None:
            inds = torch.randint(0, h * w, (n,), generator=generator,
                                 device=dev).expand(b, n)
        else:
            inds, out["inds_coarse"] = error_map_inds(error_map, h, w, n,
                                                      generator)
    if inds is not None:
        i = (inds % w).float() + 0.5
        j = torch.div(inds, w, rounding_mode="floor").float() + 0.5
        out["inds"] = inds
    else:
        flat = torch.arange(h * w, device=dev)
        i = ((flat % w).float() + 0.5).expand(b, h * w)
        j = (torch.div(flat, w, rounding_mode="floor").float()
             + 0.5).expand(b, h * w)
    d_cam = _pixel_dirs(i, j, intrinsics)                   # [B, N, 3]
    out["rays_d"] = d_cam @ poses[:, :3, :3].transpose(1, 2)
    out["rays_o"] = poses[:, None, :3, 3].expand(out["rays_d"].shape)
    return out


def rand_poses(rng, size: int, radius: float = 1.0,
               theta_range=(np.pi / 3, 2 * np.pi / 3),
               phi_range=(0.0, 2 * np.pi)):
    """Random orbit-camera poses [size, 4, 4] (numpy f32), y-up, looking at
    the origin, with theta and phi drawn uniformly from `rng` (a
    np.random.Generator)."""
    thetas = rng.uniform(theta_range[0], theta_range[1], size)
    phis = rng.uniform(phi_range[0], phi_range[1], size)
    centers = np.stack([radius * np.sin(thetas) * np.sin(phis),
                        radius * np.cos(thetas),
                        radius * np.sin(thetas) * np.cos(phis)], axis=-1)

    def normalize(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-10)

    forward = -normalize(centers)
    up = np.broadcast_to(np.array([0.0, -1.0, 0.0]), forward.shape)
    right = normalize(np.cross(forward, up))
    up = normalize(np.cross(right, forward))
    poses = np.tile(np.eye(4), (size, 1, 1))
    poses[:, :3, :3] = np.stack([right, up, forward], axis=-1)
    poses[:, :3, 3] = centers
    return poses.astype(np.float32)
