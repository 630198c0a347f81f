"""Model API (port of sealdnerf_tpu/models/api.py): a `Field` bundles the
parameters of an Instant-NGP or D-NeRF field with the functions that the
renderer and the trainer call.

    forward(params, x, d[, t]) -> (sigma, rgb[, deform])
    density(params, x[, t]) -> (sigma, geo_feat)
    color(params, d, geo_feat) -> rgb
    background(params, sph, d) -> rgb     (with bg_radius > 0, else None)
    tv_loss(params, x01) -> the hash table's TV energy (static NGP)
"""

from typing import Callable, Optional

import torch

from . import dnerf, ngp


class Field:
    def __init__(self, params, cfg, forward: Callable, density: Callable,
                 color: Callable, background: Optional[Callable] = None,
                 tv_loss: Optional[Callable] = None):
        self.params = params
        self.cfg = cfg
        self.forward = forward
        self.density = density
        self.color = color
        self.background = background
        self.tv_loss = tv_loss


def make_ngp_field(generator: torch.Generator, cfg: ngp.NGPConfig,
                   device=None) -> Field:
    """The Instant-NGP field, seeded from `generator`."""
    from ..ops.grid_encode import grid_tv_loss
    bg = None
    if cfg.bg_radius > 0:
        def bg(params, sph, d):
            return ngp.background(params, cfg, sph, d)
    return Field(
        ngp.init_ngp(generator, cfg, device), cfg,
        lambda params, x, d: ngp.ngp_forward(params, cfg, x, d),
        lambda params, x: ngp.ngp_density(params, cfg, x),
        lambda params, d, geo: ngp.color_tower(params, cfg, d, geo), bg,
        lambda params, x01: grid_tv_loss(params["grid"], cfg.grid_cfg, x01))


def make_dnerf_field(generator: torch.Generator, cfg: dnerf.DNeRFConfig,
                     device=None) -> Field:
    """The D-NeRF field (deform, basis or hyper), seeded from `generator`;
    forward and density take a trailing scalar time."""
    bg = None
    if cfg.bg_radius > 0:
        def bg(params, sph, d):
            return ngp.background(params, cfg, sph, d)
    return Field(
        dnerf.init_dnerf(generator, cfg, device), cfg,
        lambda params, x, d, t: dnerf.dnerf_forward(params, cfg, x, d, t),
        lambda params, x, t: dnerf.dnerf_density(params, cfg, x, t),
        lambda params, d, geo: ngp.color_tower(params, cfg, d, geo), bg)


def check_params(params, field: Field):
    """Raise ValueError unless `params` has the names and shapes of
    field.params (a checkpoint stores no field config)."""
    from .params import param_leaves
    want = {k: [tuple(t.shape) for t in param_leaves(v)]
            for k, v in field.params.items()}
    got = {k: [tuple(t.shape) for t in param_leaves(v)]
           for k, v in params.items()}
    if got != want:
        raise ValueError(f"checkpoint params {got} do not fit the field "
                         f"{want}")
