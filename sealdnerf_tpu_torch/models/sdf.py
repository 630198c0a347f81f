"""SDF-fitting network (port of sealdnerf_tpu/models/sdf.py): the hash grid
(16 levels x 2 channels, 2^19 entries a level, resolution 16 -> 2048) on
(x + 1) / 2, then a bias-free tower (3 x 64 by default, optional skips that
concatenate the grid features again) to one signed distance, clamped to
+-clip_sdf when set.

Params {"grid": [T, 2], "mlp": {"w": [W_l [in, out]]}} with the reference
pytree's names and layouts. The tower keeps the reference's bf16 rounding
points (the grid features rounded before the first product, f32
accumulation, each hidden activation rounded after its relu), as
models/mlp.apply_mlp does.
"""

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from ..ops.grid_encode import GridEncodeConfig, grid_encode, init_grid_table
from ..ops.hat import bf16_round
from .mlp import init_mlp
from .params import map_params


@dataclass(frozen=True)
class SDFConfig:
    num_layers: int = 3
    hidden_dim: int = 64
    skips: Tuple[int, ...] = ()
    clip_sdf: Optional[float] = None
    grid_cfg: GridEncodeConfig = field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "grid_cfg", GridEncodeConfig(
            input_dim=3, num_levels=16, level_dim=2, base_resolution=16,
            log2_hashmap_size=19, desired_resolution=2048, gridtype="hash"))


def init_sdf(generator: torch.Generator, cfg: SDFConfig, device=None):
    """Seeded init, drawn on the CPU: the table U(-1e-4, 1e-4), the tower
    torch.nn.Linear's (a skip layer takes hidden_dim + the grid's width)."""
    in_dim = cfg.grid_cfg.output_dim
    grid = init_grid_table(generator, cfg.grid_cfg)
    ws = []
    for l in range(cfg.num_layers):
        d_in = in_dim if l == 0 else cfg.hidden_dim + (
            in_dim if l in cfg.skips else 0)
        d_out = 1 if l == cfg.num_layers - 1 else cfg.hidden_dim
        ws.append(init_mlp(generator, [d_in, d_out])["w"][0])
    return map_params(lambda t: t.to(device),
                      {"grid": grid, "mlp": {"w": ws}})


def sdf_forward(params, cfg: SDFConfig, x):
    """x [N, 3] in [-1, 1] -> sdf [N] f32."""
    feat = bf16_round(grid_encode((x + 1.0) / 2.0, params["grid"],
                                  cfg.grid_cfg))
    ws = params["mlp"]["w"]
    h = feat
    for l, w in enumerate(ws):
        if l in cfg.skips:
            h = torch.cat([h, feat], dim=-1)
        h = h @ bf16_round(w.float())
        if l != len(ws) - 1:
            h = bf16_round(torch.relu(h))
    h = h[..., 0]
    if cfg.clip_sdf is not None:
        h = h.clamp(-cfg.clip_sdf, cfg.clip_sdf)
    return h
