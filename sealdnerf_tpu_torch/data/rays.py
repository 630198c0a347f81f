"""Ray generation (port of `get_rays` and `rand_poses` in
sealdnerf_tpu/data/rays.py): the full-image case, uniform random pixel
sampling and random orbit poses."""

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


def get_rays(poses, intrinsics, h: int, w: int, n: int = -1,
             generator: Optional[torch.Generator] = None,
             inds: Optional[torch.Tensor] = None):
    """Generate rays for a batch of poses.

    Args:
      poses: [B, 4, 4] cam2world. intrinsics: [4] (fx, fy, cx, cy).
      h, w: image size. n: rays per image; -1 = every pixel in raster
        order, n > 0 = n uniform random pixels (shared by the batch) drawn
        on the poses' device from `generator`, which must live there.
      inds: optional [B, N] flat pixel indices to use instead.

    Returns dict(rays_o [B,N,3], rays_d [B,N,3], inds [B,N] or None).
    """
    b = poses.shape[0]
    dev = poses.device
    out = {"inds": None}
    if inds is None and n > 0:
        n = min(n, h * w)
        inds = torch.randint(0, h * w, (n,), generator=generator,
                             device=dev).expand(b, n)
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
