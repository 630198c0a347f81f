"""Dense per-ray rendering: march_dense -> field -> dense composite (port of
sealdnerf_tpu/render/fast.py)."""

from typing import Callable

import torch

from ..ops.composite import composite_rays
from ..ops.marching_dense import DenseMarchConfig, march_dense
from ..ops.ray import near_far_from_aabb
from ..utils import profiling


def render_dense(params, occ_m, rays_o, rays_d, cfg: DenseMarchConfig,
                 forward_fn: Callable, bg_color=None, noise=None,
                 density_scale: float = 1.0, t_thresh: float = 1e-4,
                 extra=()):
    """Render a flat ray batch.

    Args:
      params: field params, passed through to forward_fn.
      occ_m: bool [M, M, M] occupancy at march resolution, or [CAS, M, M,
        M] for the cascade march (cfg.multi).
      rays_o, rays_d: [N, 3].
      forward_fn: (params, x [S, 3], d [S, 3], *extra) -> (sigma [S],
        rgb [S, 3]).
      bg_color: [3] or [N, 3] tensor, or None for white.
      noise: optional [N] fine-phase jitter in [0, 1).
      extra: further arguments of forward_fn: (t,) for a time-conditioned
        field, whose occ_m is then the slice of that time.

    Returns dict(image [N,3], depth [N], weights_sum [N], n_samples).
    """
    n = rays_o.shape[0]
    b = cfg.bound
    aabb = torch.tensor([-b] * 3 + [b] * 3, dtype=torch.float32,
                        device=rays_o.device)
    profiling.host_sync(rays_o)         # the copy from pageable host memory
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, cfg.min_near)
    mr = march_dense(rays_o, rays_d, nears, fars, occ_m, cfg, noise=noise)
    ts, dts, valid = mr["ts"], mr["dts"], mr["valid"]
    s = ts.shape[1]
    pos = (rays_o[:, None, :] + ts[..., None] * rays_d[:, None, :]).clamp(
        -b, b)
    dirs = rays_d[:, None, :].expand(n, s, 3)
    sigma, rgb = forward_fn(params, pos.reshape(-1, 3), dirs.reshape(-1, 3),
                            *extra)
    sigma = torch.where(valid, sigma.reshape(n, s) * density_scale,
                        torch.zeros_like(ts))
    comp = composite_rays(sigma, rgb.reshape(n, s, 3), dts, ts=ts,
                          t_thresh=t_thresh)
    bg = torch.ones(3, device=rays_o.device) if bg_color is None \
        else bg_color
    return {
        "image": comp["image"] + (1.0 - comp["weights_sum"])[:, None] * bg,
        "depth": comp["depth"],
        "weights_sum": comp["weights_sum"],
        "n_samples": mr["counts"].sum(),
    }
