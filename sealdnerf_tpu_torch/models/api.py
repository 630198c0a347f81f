"""Model API (port of sealdnerf_tpu/models/api.py): a `Field` bundles the
parameters of an Instant-NGP, D-NeRF or TensoRF field with the functions
that the renderer and the trainer call.

    forward(params, x, d[, t]) -> (sigma, rgb[, deform])
    density(params, x[, t]) -> (sigma, geo_feat)
    color(params, d, geo_feat) -> rgb
    background(params, sph, d) -> rgb     (with bg_radius > 0, else None)
    tv_loss(params, x01) -> the hash table's TV energy (static NGP)
    forward_trunc(params, x, d, frac) -> (sigma, rgb) at the first
        ceil(frac * R) ranks (TensoRF: CCNeRF's rank-residual K-loss)
"""

from typing import Callable, Optional

import torch

from . import dnerf, ngp, tensorf
from .params import PackedTables


class Field:
    def __init__(self, params, cfg, forward: Callable, density: Callable,
                 color: Callable, background: Optional[Callable] = None,
                 tv_loss: Optional[Callable] = None,
                 forward_trunc: Optional[Callable] = None):
        self.params = params
        self.cfg = cfg
        self.forward = forward
        self.density = density
        self.color = color
        self.background = background
        self.tv_loss = tv_loss
        self.forward_trunc = forward_trunc


class NGPField(PackedTables, Field):
    """The Instant-NGP field, with the hash-grid kernel's packed operands
    (ops/field.py:pack_hash_tables) cached per parameter version, which
    FastTrainer's frames and grid refresh read."""

    def _pack(self, params):
        from ..ops.field import pack_hash_tables
        return pack_hash_tables(params, self.cfg)


def make_ngp_field(generator: torch.Generator, cfg: ngp.NGPConfig,
                   device=None) -> NGPField:
    """The Instant-NGP field, seeded from `generator`."""
    from ..ops.grid_encode import grid_tv_loss
    bg = None
    if cfg.bg_radius > 0:
        def bg(params, sph, d):
            return ngp.background(params, cfg, sph, d)
    return NGPField(
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


def make_tensorf_field(generator: Optional[torch.Generator],
                       cfg: tensorf.TensoRFConfig, device=None,
                       params=None) -> Field:
    """The TensoRF field (VM or CP), seeded from `generator` or on `params`,
    with the rank-truncated forward of CCNeRF's K-loss."""
    if params is None:
        params = tensorf.init_tensorf(generator, cfg, device=device)
    return Field(
        params, cfg,
        lambda params, x, d: tensorf.tensorf_forward(params, cfg, x, d),
        lambda params, x: tensorf.tensorf_density(params, cfg, x),
        lambda params, d, feat: tensorf.tensorf_color(params, cfg, d, feat),
        forward_trunc=lambda params, x, d, frac:
            tensorf.tensorf_forward_trunc(params, cfg, x, d, frac))


def _shapes(params, tensorf_grid: bool):
    """Leaf shapes per top-level name; with tensorf_grid the factors' grid
    extents read as "res" (a TensoRF field takes any resolution: its
    lerps read it off the tables)."""
    from .params import param_leaves
    out = {}
    for k, v in params.items():
        shapes = [tuple(t.shape) for t in param_leaves(v)]
        if tensorf_grid and k.endswith(("_planes", "_lines")):
            shapes = [s[:1] + ("res",) * (len(s) - 1) for s in shapes]
        out[k] = shapes
    return out


def check_params(params, field: Field):
    """Raise ValueError unless `params` has the names and shapes of
    field.params (a checkpoint stores no field config). A TensoRF field
    takes factors at any one grid resolution (a checkpoint saved after an
    upsample)."""
    from .params import param_leaves
    grid = isinstance(field.cfg, tensorf.TensoRFConfig)
    want, got = _shapes(field.params, grid), _shapes(params, grid)
    res = {n for k, v in params.items() if grid
           and k.endswith(("_planes", "_lines"))
           for t in param_leaves(v) for n in tuple(t.shape)[1:]}
    if got != want or len(res) > 1:
        raise ValueError(f"checkpoint params {_shapes(params, False)} do not "
                         f"fit the field {_shapes(field.params, False)}")
