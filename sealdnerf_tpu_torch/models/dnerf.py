"""D-NeRF dynamic fields on the Instant-NGP towers (port of
sealdnerf_tpu/models/dnerf.py). Three variants:

- deform: freq(x, 10) ++ freq(t, 6) -> 8 x 128 bias-free tower -> dx; the
  canonical field is a tiled grid read at x + dx, then the NGP sigma and
  colour towers. t == 0 forces dx = 0 (the canonical frame).
- basis: a time tower emits sigma and colour basis coefficients that weigh
  per-point spatial bases; no deformation.
- hyper: a tower emits ambient_dim extra coordinates (tanh) appended to x
  before a (3 + A)-D hash grid.

Params carry the reference pytree's names: "grid", "sigma_mlp",
"color_mlp", and "deform_mlp" | "basis_mlp" | "ambient_mlp"[, "bg_grid",
"bg_mlp"].
"""

from dataclasses import dataclass, field
from typing import Optional

import torch

from ..ops.activation import trunc_exp
from ..ops.freq_encode import freq_encode, freq_output_dim
from ..ops.grid_encode import GridEncodeConfig, grid_encode, init_grid_table
from ..ops.sh_encode import sh_encode, sh_output_dim
from .mlp import apply_tower, init_mlp
from .ngp import background, bg_dims, bg_grid_config, color_tower, tower_dims
from .params import map_params


@dataclass(frozen=True)
class DNeRFConfig:
    bound: float = 1.0
    variant: str = "deform"  # deform | basis | hyper
    num_layers_deform: int = 8
    hidden_dim_deform: int = 128
    multires_deform: int = 10
    multires_time: int = 6
    sigma_basis_dim: int = 32
    color_basis_dim: int = 8
    num_layers_basis: int = 5
    hidden_dim_basis: int = 128
    ambient_dim: int = 2
    num_levels: int = 16
    level_dim: int = 2
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
    # derived
    grid_cfg: GridEncodeConfig = field(init=False)
    bg_grid_cfg: Optional[GridEncodeConfig] = field(init=False)

    def __post_init__(self):
        if self.variant not in ("deform", "basis", "hyper"):
            raise ValueError(f"unknown dnerf variant {self.variant}")
        dims = 3 + (self.ambient_dim if self.variant == "hyper" else 0)
        object.__setattr__(self, "grid_cfg", GridEncodeConfig(
            input_dim=dims, num_levels=self.num_levels,
            level_dim=self.level_dim, base_resolution=16,
            log2_hashmap_size=self.log2_hashmap_size,
            desired_resolution=int(2048 * self.bound),
            gridtype="tiled" if self.variant == "deform" else "hash"))
        object.__setattr__(self, "bg_grid_cfg",
                           bg_grid_config() if self.bg_radius > 0 else None)

    @property
    def dir_dim(self) -> int:
        return sh_output_dim(self.sh_degree)

    @property
    def deform_in_dim(self) -> int:
        return freq_output_dim(3, self.multires_deform) + \
            freq_output_dim(1, self.multires_time)


def init_dnerf(generator: torch.Generator, cfg: DNeRFConfig, device=None):
    """Seeded init, drawn on the CPU from `generator`."""
    g = generator
    basis = cfg.variant == "basis"
    sigma, color = tower_dims(
        cfg, cfg.grid_cfg.output_dim,
        (cfg.sigma_basis_dim if basis else 1) + cfg.geo_feat_dim,
        3 * cfg.color_basis_dim if basis else 3)
    params = {"grid": init_grid_table(g, cfg.grid_cfg),
              "sigma_mlp": init_mlp(g, sigma),
              "color_mlp": init_mlp(g, color)}
    tdim = freq_output_dim(1, cfg.multires_time)
    hidden = [cfg.hidden_dim_deform] * (cfg.num_layers_deform - 1)
    if cfg.variant == "deform":
        params["deform_mlp"] = init_mlp(g, [cfg.deform_in_dim] + hidden + [3])
    elif basis:
        params["basis_mlp"] = init_mlp(
            g, [tdim] + [cfg.hidden_dim_basis] * (cfg.num_layers_basis - 1)
            + [cfg.sigma_basis_dim + cfg.color_basis_dim])
    else:
        params["ambient_mlp"] = init_mlp(
            g, [cfg.deform_in_dim] + hidden + [cfg.ambient_dim])
    if cfg.bg_radius > 0:
        params["bg_grid"] = init_grid_table(g, cfg.bg_grid_cfg)
        params["bg_mlp"] = init_mlp(g, bg_dims(cfg))
    return map_params(lambda t: t.to(device), params)


def _as_time(t, like):
    return torch.as_tensor(t, dtype=torch.float32,
                           device=like.device).reshape(())


def _time_feat(cfg, t, n):
    """freq(t) of the scalar time, broadcast to [n, 1 + 2 * multires]."""
    enc = freq_encode(t.reshape(1, 1), degree=cfg.multires_time)
    return enc.expand(n, enc.shape[-1])


def _xt_features(cfg, x, t):
    return torch.cat([freq_encode(x, degree=cfg.multires_deform),
                      _time_feat(cfg, t, x.shape[0])], dim=-1)


def dnerf_deform(params, cfg: DNeRFConfig, x, t):
    """dx [N, 3] at time t; exactly zero at t == 0."""
    t = _as_time(t, x)
    deform = apply_tower(params["deform_mlp"], _xt_features(cfg, x, t))
    return torch.where(t == 0.0, torch.zeros_like(deform), deform)


def _canonical(params, cfg, x):
    x01 = (x + cfg.bound) / (2.0 * cfg.bound)
    return apply_tower(params["sigma_mlp"],
                     grid_encode(x01, params["grid"], cfg.grid_cfg))


def _ambient(params, cfg, x, t):
    """Ambient coordinates [N, A] in [-1, 1]."""
    return torch.tanh(apply_tower(params["ambient_mlp"],
                                _xt_features(cfg, x, t)))


def _hyper(params, cfg, x, amb):
    x01 = (x + cfg.bound) / (2.0 * cfg.bound)
    feat = grid_encode(torch.cat([x01, (amb + 1.0) / 2.0], dim=-1),
                       params["grid"], cfg.grid_cfg)
    return apply_tower(params["sigma_mlp"], feat)


def _basis_coeffs(params, cfg, t):
    enc = freq_encode(t.reshape(1, 1), degree=cfg.multires_time)
    return apply_tower(params["basis_mlp"], enc)[0]        # [SB + CB]


def _density_h(params, cfg, x, t):
    """(sigma, geo_feat, deform, time coefficients or None)."""
    t = _as_time(t, x)
    if cfg.variant == "deform":
        deform = dnerf_deform(params, cfg, x, t)
        h = _canonical(params, cfg, x + deform)
        return trunc_exp(h[..., 0]), h[..., 1:], deform, None
    if cfg.variant == "hyper":
        h = _hyper(params, cfg, x, _ambient(params, cfg, x, t))
        return trunc_exp(h[..., 0]), h[..., 1:], torch.zeros_like(x), None
    h = _canonical(params, cfg, x)
    sb = cfg.sigma_basis_dim
    tb = _basis_coeffs(params, cfg, t)
    sigma = trunc_exp((h[..., :sb] * tb[:sb][None]).sum(-1))
    return sigma, h[..., sb:], torch.zeros_like(x), tb


def dnerf_density(params, cfg: DNeRFConfig, x, t):
    """(sigma [N], geo_feat [N, G]) at scalar time t in [0, 1]."""
    sigma, geo, _, _ = _density_h(params, cfg, x, t)
    return sigma, geo


def dnerf_forward(params, cfg: DNeRFConfig, x, d, t):
    """(sigma [N], rgb [N, 3], deform [N, 3]) at scalar time t."""
    sigma, geo, deform, tb = _density_h(params, cfg, x, t)
    if tb is None:
        return sigma, color_tower(params, cfg, d, geo), deform
    n = x.shape[0]
    hc = torch.cat([sh_encode(d, degree=cfg.sh_degree), geo], dim=-1)
    rgb_b = apply_tower(params["color_mlp"], hc).reshape(
        n, 3, cfg.color_basis_dim)
    rgb = torch.sigmoid((rgb_b * tb[cfg.sigma_basis_dim:][None, None]).sum(-1))
    return sigma, rgb, deform


dnerf_background = background
