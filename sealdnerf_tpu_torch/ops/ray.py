"""Ray/AABB slab intersection and background-sphere coordinates (port of
sealdnerf_tpu/ops/ray.py)."""

import math

import torch

_MISS = 1e10


def near_far_from_aabb(rays_o, rays_d, aabb, min_near=0.2):
    """Slab-test rays against an AABB.

    Args:
      rays_o, rays_d: [..., 3] float. Directions need not be normalized.
      aabb: [6] float tensor (xmin, ymin, zmin, xmax, ymax, zmax).
      min_near: clamp for the near plane.

    Returns:
      nears, fars: [...] float. Misses get near = far = 1e10.
    """
    rd = 1.0 / rays_d  # inf on zero components is fine: IEEE slab test
    t0 = (aabb[:3] - rays_o) * rd
    t1 = (aabb[3:] - rays_o) * rd
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    miss = near > far
    near = near.clamp(min=min_near)
    near = torch.where(miss, torch.full_like(near, _MISS), near)
    far = torch.where(miss | (far < near), near, far)
    return near, far


def sph_from_ray(rays_o, rays_d, radius: float):
    """Where the rays leave the background sphere |o + t d| = radius, as
    [..., 2] coordinates (theta, phi) scaled to [-1, 1], y up (the larger
    root)."""
    a = (rays_d * rays_d).sum(-1)
    b = (rays_o * rays_d).sum(-1)
    c = (rays_o * rays_o).sum(-1) - radius * radius
    disc = (b * b - a * c).clamp(min=0.0)
    t = (-b + torch.sqrt(disc)) / a
    p = rays_o + t[..., None] * rays_d
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    theta = torch.atan2(torch.sqrt(x * x + z * z), y)
    phi = torch.atan2(z, x)
    return torch.stack([2.0 * theta / math.pi - 1.0, phi / math.pi], dim=-1)
