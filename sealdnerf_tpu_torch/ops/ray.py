"""Ray/AABB slab intersection (port of sealdnerf_tpu/ops/ray.py)."""

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
