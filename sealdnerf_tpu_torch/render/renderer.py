"""The reference's two render paths as plain functions (port of
sealdnerf_tpu/render/renderer.py).

- render_occ: occupancy-grid march -> packed field evaluation -> packed
  compositing: the `-O` path of the Instant-NGP and D-NeRF trainer and of
  the editing teacher. One code path serves training and inference; a
  chunk's packed budget (m_budget) decides which samples a dense chunk
  drops. The field runs on the kept samples only (the reference evaluates
  the padding too and weighs it by 0).
- render_uniform: uniform z sampling, optional PDF upsampling and dense
  compositing: the reference's differential oracle for render_occ.

A forward_fn(params, x [M, 3], d [M, 3], *extra) -> (sigma, rgb, ...) and
an optional bg_fn(params, sph, d) -> rgb are passed in, as in the
reference; a CP field's forward runs the port's kernels (K1, or K3 for a
time-conditioned field) on the card. Random draws (the march's start
offsets, the jitter of the uniform samples) come from a torch.Generator on
the rays' device, or are passed in.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..ops.composite import composite_packed, composite_rays
from ..ops.marching import MarchConfig, march_rays
from ..ops.ray import near_far_from_aabb, sph_from_ray


@dataclass(frozen=True)
class RenderSettings:
    march: MarchConfig
    density_scale: float = 1.0
    bg_radius: float = -1.0
    t_thresh: float = 1e-4
    num_steps: int = 128          # render_uniform
    upsample_steps: int = 128
    samples_per_ray: int = 48     # render_occ's packed budget per ray


def sample_pdf(bins, weights, n_samples: int, det: bool,
               generator: Optional[torch.Generator] = None, u=None):
    """Inverse-CDF sampling: bins [B, T] z midpoints, weights [B, T - 1]
    -> [B, n_samples]. det=False draws u from `generator` unless u is
    given."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    shape = cdf.shape[:-1] + (n_samples,)
    if det:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples,
                           n_samples, device=cdf.device).expand(shape)
    elif u is None:
        u = torch.rand(shape, generator=generator, device=cdf.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    bins_g0 = torch.gather(bins, -1, below)
    bins_g1 = torch.gather(bins, -1, above)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_g0 + (u - cdf_g0) / denom * (bins_g1 - bins_g0)


def _bg_color(bg_fn, params, settings, rays_o, rays_d, bg_color):
    if settings.bg_radius > 0 and bg_fn is not None:
        return bg_fn(params, sph_from_ray(rays_o, rays_d, settings.bg_radius),
                     rays_d)
    if bg_color is None:
        return torch.ones(3, device=rays_o.device)
    return bg_color


def _aabb(mc: MarchConfig, device):
    return torch.tensor([-mc.bound] * 3 + [mc.bound] * 3,
                        dtype=torch.float32, device=device)


def render_occ(params, occ, rays_o, rays_d, settings: RenderSettings,
               forward_fn: Callable, bg_fn: Optional[Callable] = None,
               bg_color=None, perturb: bool = False,
               generator: Optional[torch.Generator] = None, noise=None,
               m_budget: Optional[int] = None, extra=()):
    """The occupancy-grid path over a flat ray batch.

    Args:
      occ: bool [CAS, H, H, H] (a time-conditioned field's bin slice).
      rays_o, rays_d: [N, 3].
      bg_color: [3] or [N, 3] or None (white); bg_fn replaces it when
        settings.bg_radius > 0.
      perturb: shift each ray's start by U[0, 1) of its first step, drawn
        from `generator`, or by `noise` [N] when given.
      m_budget: the packed budget (default N * samples_per_ray).
      extra: passed on to forward_fn (the scalar time).

    Returns dict(image [N, 3], depth [N], weights_sum [N], n_samples: the
    samples before the budget drop, a 0-d tensor).
    """
    n = rays_o.shape[0]
    mc = settings.march
    if m_budget is None:
        m_budget = n * settings.samples_per_ray
    nears, fars = near_far_from_aabb(rays_o, rays_d,
                                     _aabb(mc, rays_o.device), mc.min_near)
    if perturb and noise is None:
        noise = torch.rand((n,), generator=generator, device=rays_o.device)
    pk = march_rays(rays_o, rays_d, nears, fars, occ, mc, m_budget,
                    noise=noise if perturb else None)
    live = int(torch.clamp(pk["total"], max=m_budget))
    out = forward_fn(params, pk["xyzs"][:live], pk["dirs"][:live], *extra)
    res = composite_packed(out[0] * settings.density_scale, out[1],
                           pk["dts"][:live], pk["ts"][:live],
                           pk["ray_id"][:live], pk["valid"][:live], n,
                           t_thresh=settings.t_thresh)
    bg = _bg_color(bg_fn, params, settings, rays_o, rays_d, bg_color)
    return {"image": res["image"] + (1.0 - res["weights_sum"])[:, None] * bg,
            "depth": res["depth"], "weights_sum": res["weights_sum"],
            "n_samples": pk["total"]}


def render_uniform(params, rays_o, rays_d, settings: RenderSettings,
                   density_fn: Callable, color_fn: Callable,
                   bg_fn: Optional[Callable] = None, bg_color=None,
                   perturb: bool = False,
                   generator: Optional[torch.Generator] = None, extra=()):
    """Uniform z samples in [near, far], PDF upsampling by the coarse
    weights (no gradient through the new z), dense compositing.
    density_fn(params, x, *extra) -> (sigma, geo_feat); color_fn(params, d,
    geo_feat) -> rgb. Depth is normalised to [0, 1] within [near, far]."""
    n = rays_o.shape[0]
    mc = settings.march
    steps = settings.num_steps
    aabb = _aabb(mc, rays_o.device)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, mc.min_near)
    nears, fars = nears[:, None], fars[:, None]
    z = torch.linspace(0.0, 1.0, steps, device=rays_o.device)[None, :]
    z_vals = nears + (fars - nears) * z
    sample_dist = (fars - nears) / steps
    if perturb:
        z_vals = z_vals + (torch.rand(z_vals.shape, generator=generator,
                                      device=rays_o.device) - 0.5) \
            * sample_dist

    def pts(zv):
        p = rays_o[:, None, :] + rays_d[:, None, :] * zv[..., None]
        return torch.maximum(torch.minimum(p, aabb[3:]), aabb[:3])

    xyzs = pts(z_vals)
    sigma, geo = density_fn(params, xyzs.reshape(-1, 3), *extra)[:2]
    sigma = sigma.reshape(n, steps)
    geo = geo.reshape(n, steps, -1)

    if settings.upsample_steps > 0:
        with torch.no_grad():
            deltas = z_vals[..., 1:] - z_vals[..., :-1]
            deltas = torch.cat([deltas, sample_dist.expand(n, 1)], -1)
            weights = composite_rays(
                sigma.detach() * settings.density_scale,
                torch.zeros(sigma.shape + (3,), device=rays_o.device),
                deltas)["weights"]
            z_mid = z_vals[..., :-1] + 0.5 * deltas[..., :-1]
            new_z = sample_pdf(z_mid, weights[:, 1:-1],
                               settings.upsample_steps, det=not perturb,
                               generator=generator)
        new_xyzs = pts(new_z)
        new_sigma, new_geo = density_fn(params, new_xyzs.reshape(-1, 3),
                                        *extra)[:2]
        z_vals = torch.cat([z_vals, new_z], dim=1)
        z_vals, order = torch.sort(z_vals, dim=1, stable=True)
        xyzs = torch.gather(torch.cat([xyzs, new_xyzs], 1), 1,
                            order[..., None].expand(-1, -1, 3))
        sigma = torch.gather(torch.cat(
            [sigma, new_sigma.reshape(n, -1)], 1), 1, order)
        new_geo = new_geo.reshape(n, settings.upsample_steps, -1)
        geo = torch.gather(torch.cat([geo, new_geo], 1), 1,
                           order[..., None].expand(-1, -1, geo.shape[-1]))

    t_total = z_vals.shape[1]
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, sample_dist.expand(n, 1)], -1)
    dirs = rays_d[:, None, :].expand(n, t_total, 3)
    rgbs = color_fn(params, dirs.reshape(-1, 3),
                    geo.reshape(-1, geo.shape[-1])).reshape(n, t_total, 3)
    out = composite_rays(sigma * settings.density_scale, rgbs, deltas)
    weights, weights_sum = out["weights"], out["weights_sum"]
    ori_z = ((z_vals - nears) / (fars - nears)).clamp(0.0, 1.0)
    depth = (weights * ori_z).sum(-1)
    image = (weights[..., None] * rgbs).sum(-2)
    bg = _bg_color(bg_fn, params, settings, rays_o, rays_d, bg_color)
    return {"image": image + (1.0 - weights_sum)[:, None] * bg,
            "depth": depth, "weights_sum": weights_sum}
