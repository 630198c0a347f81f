"""Instant-NGP static field (port of sealdnerf_tpu/models/ngp.py).

- sigma tower: hash grid (16 levels x 2 channels, 2^19 entries a level,
  desired resolution 2048 * bound) -> 64 -> 1 + 15 geo features, bias-free,
  trunc_exp(sigma);
- colour tower: SH(degree 4) of the direction ++ geo features -> 64 -> 64
  -> 3, sigmoid;
- with bg_radius > 0, a background: a 2-D hash grid (4 levels, desired
  resolution 2048) on the sphere coordinates ++ SH(direction) -> 64 -> 3,
  sigmoid.

Params {"grid", "sigma_mlp", "color_mlp"[, "bg_grid", "bg_mlp"]} with the
reference pytree's names and layouts: grid [T, C] at the config's offsets,
towers {"w": [W_i [in, out]]}. The grid encoding and the towers are plain
PyTorch, as the reference computes them in plain XLA.
"""

from dataclasses import dataclass, field
from typing import Optional

import torch

from ..ops.activation import trunc_exp
from ..ops.grid_encode import GridEncodeConfig, grid_encode, init_grid_table
from ..ops.sh_encode import sh_encode, sh_output_dim
from .mlp import apply_tower, init_mlp
from .params import map_params


def bg_grid_config() -> GridEncodeConfig:
    """The background's 2-D hash grid."""
    return GridEncodeConfig(input_dim=2, num_levels=4, level_dim=2,
                            base_resolution=16, log2_hashmap_size=19,
                            desired_resolution=2048, gridtype="hash")


@dataclass(frozen=True)
class NGPConfig:
    bound: float = 1.0
    num_levels: int = 16
    level_dim: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    sh_degree: int = 4
    bg_radius: float = -1.0
    num_layers_bg: int = 2
    hidden_dim_bg: int = 64
    gridtype: str = "hash"
    # derived
    grid_cfg: GridEncodeConfig = field(init=False)
    bg_grid_cfg: Optional[GridEncodeConfig] = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "grid_cfg", GridEncodeConfig(
            input_dim=3, num_levels=self.num_levels,
            level_dim=self.level_dim, base_resolution=self.base_resolution,
            log2_hashmap_size=self.log2_hashmap_size,
            desired_resolution=int(2048 * self.bound),
            gridtype=self.gridtype))
        object.__setattr__(self, "bg_grid_cfg",
                           bg_grid_config() if self.bg_radius > 0 else None)

    @property
    def dir_dim(self) -> int:
        return sh_output_dim(self.sh_degree)


def tower_dims(cfg, in_dim: int, out_sigma: int, out_color: int):
    """(sigma tower dims, colour tower dims) of an NGP-shaped field."""
    sigma = [in_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1) + [out_sigma]
    color = [cfg.dir_dim + cfg.geo_feat_dim] \
        + [cfg.hidden_dim_color] * (cfg.num_layers_color - 1) + [out_color]
    return sigma, color


def bg_dims(cfg):
    return [cfg.bg_grid_cfg.output_dim + cfg.dir_dim] \
        + [cfg.hidden_dim_bg] * (cfg.num_layers_bg - 1) + [3]


def init_ngp(generator: torch.Generator, cfg: NGPConfig, device=None):
    """Seeded init, drawn on the CPU from `generator`: the tables
    U(-1e-4, 1e-4), the towers torch.nn.Linear's."""
    g = generator
    sigma, color = tower_dims(cfg, cfg.grid_cfg.output_dim,
                              1 + cfg.geo_feat_dim, 3)
    params = {"grid": init_grid_table(g, cfg.grid_cfg),
              "sigma_mlp": init_mlp(g, sigma),
              "color_mlp": init_mlp(g, color)}
    if cfg.bg_radius > 0:
        params["bg_grid"] = init_grid_table(g, cfg.bg_grid_cfg)
        params["bg_mlp"] = init_mlp(g, bg_dims(cfg))
    return map_params(lambda t: t.to(device), params)


def ngp_density(params, cfg: NGPConfig, x):
    """x [N, 3] in [-bound, bound] -> (sigma [N], geo_feat [N, G])."""
    x01 = (x + cfg.bound) / (2.0 * cfg.bound)
    h = apply_tower(params["sigma_mlp"],
                  grid_encode(x01, params["grid"], cfg.grid_cfg))
    return trunc_exp(h[..., 0]), h[..., 1:]


def color_tower(params, cfg, d, geo_feat):
    """d [N, 3] unit directions, geo_feat [N, G] -> rgb [N, 3] in [0, 1]."""
    h = torch.cat([sh_encode(d, degree=cfg.sh_degree), geo_feat], dim=-1)
    return apply_tower(params["color_mlp"], h, final_activation=torch.sigmoid)


def ngp_forward(params, cfg: NGPConfig, x, d):
    sigma, geo_feat = ngp_density(params, cfg, x)
    return sigma, color_tower(params, cfg, d, geo_feat)


def background(params, cfg, sph, d):
    """sph [N, 2] sphere coordinates in [-1, 1], d [N, 3] -> rgb [N, 3]."""
    feat = grid_encode((sph + 1.0) / 2.0, params["bg_grid"], cfg.bg_grid_cfg)
    h = torch.cat([sh_encode(d, degree=cfg.sh_degree), feat], dim=-1)
    return apply_tower(params["bg_mlp"], h, final_activation=torch.sigmoid)


ngp_background = background
