"""TensoRF (CP / VM decompositions) and CCNeRF composition (port of
sealdnerf_tpu/models/tensorf.py).

Layout (the reference pytree's names and shapes, so that weights cross
unchanged):
- VM: per axis a, density planes [R_s, res, res] over the two other axes and
  lines [R_s, res] along a; appearance likewise with R_a ranks, then the
  basis matrix to color_feat_dim and the shared colour tower;
- CP: three lines per name (rank-R outer products), no planes.
Params {"sigma_planes", "sigma_lines", "app_planes", "app_lines" (lists of
three), "basis_grid", "color_mlp"} (CP: no "*_planes").

A point costs bilinear taps of three planes and linear taps of three lines
per name, read with `res - 1` scaling (align-corners sampling, the position
clipped to [0, 1]); the resolution is read off the tables, so a checkpoint
saved after an upsample loads into a field built at resolution0.
`upsample_tensorf` resizes with half-pixel centres, as jax.image.resize's
"linear" does: the two conventions differ, and the reference keeps both.
The towers go through apply_tower (bf16 inputs, f32 accumulation, apply_mlp
on the CPU and under autograd). Everything is plain PyTorch, as the
reference's is plain XLA.
"""

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.sh_encode import sh_encode, sh_output_dim
from .mlp import apply_tower, init_mlp
from .params import map_params

AXES = ((0, (1, 2)), (1, (0, 2)), (2, (0, 1)))  # (line axis, plane axes)
NAMES = ("sigma", "app")


@dataclass(frozen=True)
class TensoRFConfig:
    bound: float = 1.0
    decomposition: str = "vm"          # "vm" | "cp"
    resolution: int = 128              # grid resolution at init
    sigma_rank: Tuple[int, ...] = (16, 16, 16)
    color_rank: Tuple[int, ...] = (48, 48, 48)
    color_feat_dim: int = 27
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    sh_degree: int = 4
    degree: int = 0  # the reference CLI's placeholder

    @property
    def dir_dim(self) -> int:
        return sh_output_dim(self.sh_degree)


def init_tensorf(generator: torch.Generator, cfg: TensoRFConfig,
                 scale: float = 0.1, device=None):
    """Seeded init, drawn on the CPU from `generator`: factors N(0, 0.1^2),
    the basis matrix and the colour tower torch.nn.Linear's."""
    g, res = generator, cfg.resolution

    def normal(*shape):
        return scale * torch.randn(shape, generator=g)

    params = {}
    for name, ranks in zip(NAMES, (cfg.sigma_rank, cfg.color_rank)):
        if cfg.decomposition == "vm":
            params[f"{name}_planes"] = [normal(r, res, res) for r in ranks]
            params[f"{name}_lines"] = [normal(r, res) for r in ranks]
        else:
            params[f"{name}_lines"] = [normal(ranks[0], res)
                                       for _ in range(3)]
    n_app = (sum(cfg.color_rank) if cfg.decomposition == "vm"
             else cfg.color_rank[0])
    params["basis_grid"] = init_mlp(g, [n_app, cfg.color_feat_dim])
    params["color_mlp"] = init_mlp(
        g, [cfg.color_feat_dim + cfg.dir_dim]
        + [cfg.hidden_dim_color] * (cfg.num_layers_color - 1) + [3])
    return map_params(lambda t: t.to(device), params)


def _taps(u, res: int):
    """Lower tap index and fraction of positions u [N] (clipped to [0, 1],
    scaled by res - 1) -> (i0 [N] int64, f [N, 1])."""
    x = u.clamp(0.0, 1.0) * (res - 1)
    i0 = torch.floor(x).long().clamp(0, res - 2)
    return i0, (x - i0)[:, None]


def _lerp_1d(line, u):
    """line [R, res]; u [N] in [0, 1] -> [N, R]."""
    i0, f = _taps(u, line.shape[1])
    rows = line.t()                                   # [res, R]
    return rows[i0] * (1 - f) + rows[i0 + 1] * f


def _lerp_2d(plane, u, v):
    """plane [R, res, res] (u along the first grid axis, v the second); u,
    v [N] in [0, 1] -> [N, R]."""
    res = plane.shape[1]
    i0, fx = _taps(u, res)
    j0, fy = _taps(v, res)
    rows = plane.reshape(plane.shape[0], -1).t()      # [res * res, R]
    base = i0 * res + j0
    v00, v01 = rows[base], rows[base + 1]
    v10, v11 = rows[base + res], rows[base + res + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * (1 - fx) * fy
            + v10 * fx * (1 - fy) + v11 * fx * fy)


def _features(params, cfg: TensoRFConfig, x01, name: str):
    """Rank features [N, sum(R)] of `name` in {sigma, app}: VM concatenates
    plane x line per axis; CP is the product of the three lines."""
    if cfg.decomposition == "vm":
        return torch.cat([
            _lerp_2d(params[f"{name}_planes"][a], x01[:, pa], x01[:, pb])
            * _lerp_1d(params[f"{name}_lines"][a], x01[:, la])
            for a, (la, (pa, pb)) in enumerate(AXES)], dim=-1)
    f = None
    for a in range(3):
        fl = _lerp_1d(params[f"{name}_lines"][a], x01[:, a])
        f = fl if f is None else f * fl
    return f


def _density_from(params, sig_feat, app):
    return torch.relu(sig_feat.sum(-1)), apply_tower(params["basis_grid"], app)


def tensorf_density(params, cfg: TensoRFConfig, x):
    """x [N, 3] in [-bound, bound] -> (sigma [N], app_feat [N, F])."""
    x01 = (x + cfg.bound) / (2 * cfg.bound)
    return _density_from(params, _features(params, cfg, x01, "sigma"),
                         _features(params, cfg, x01, "app"))


def tensorf_color(params, cfg: TensoRFConfig, d, feat):
    """d [N, 3], app_feat [N, F] -> rgb [N, 3]: SH(d) after the features."""
    h = torch.cat([feat, sh_encode(d, degree=cfg.sh_degree)], dim=-1)
    return apply_tower(params["color_mlp"], h, final_activation=torch.sigmoid)


def tensorf_forward(params, cfg: TensoRFConfig, x, d):
    sigma, feat = tensorf_density(params, cfg, x)
    return sigma, tensorf_color(params, cfg, d, feat)


def upsample_tensorf(params, cfg: TensoRFConfig, new_resolution: int):
    """Progressive grid upsampling: every plane and line resized to
    new_resolution with half-pixel centres (jax.image.resize "linear";
    F.interpolate with align_corners=False gives the same weights, edge taps
    included, when enlarging). Returns (params, new cfg)."""
    out = dict(params)
    with torch.no_grad():
        for name in NAMES:
            if f"{name}_planes" in params:
                out[f"{name}_planes"] = [
                    F.interpolate(p[None], size=(new_resolution,) * 2,
                                  mode="bilinear", align_corners=False)[0]
                    for p in params[f"{name}_planes"]]
            out[f"{name}_lines"] = [
                F.interpolate(l[None], size=new_resolution, mode="linear",
                              align_corners=False)[0]
                for l in params[f"{name}_lines"]]
    return out, dataclasses.replace(cfg, resolution=new_resolution)


def tensorf_l1_reg(params):
    """L1 sparsity of the density factors: mean |x| over every entry of the
    sigma planes and lines."""
    total, count = 0.0, 0
    for name in ("sigma_planes", "sigma_lines"):
        for t in params.get(name, []):
            total = total + t.abs().sum()
            count += t.numel()
    return total / max(count, 1)


def _trunc_mask(frac: float, ranks, device=None):
    """Keep the first ceil(frac * R) ranks of EACH factor (at least one):
    VM features concatenate per axis, so one prefix over the concatenation
    would zero whole axes instead of truncating rank."""
    parts = []
    for r in ranks:
        keep = max(1, int(math.ceil(frac * r)))
        parts.append((torch.arange(r, device=device) < keep).float())
    return torch.cat(parts)


def _rank_layout(cfg: TensoRFConfig, name: str):
    ranks = cfg.sigma_rank if name == "sigma" else cfg.color_rank
    return tuple(ranks) if cfg.decomposition == "vm" else (ranks[0],)


def tensorf_forward_trunc(params, cfg: TensoRFConfig, x, d, frac: float):
    """CCNeRF's rank-truncated forward: only the first ceil(frac * R)
    components of each factor contribute."""
    x01 = (x + cfg.bound) / (2 * cfg.bound)
    sig = _features(params, cfg, x01, "sigma") * _trunc_mask(
        frac, _rank_layout(cfg, "sigma"), x.device)
    app = _features(params, cfg, x01, "app") * _trunc_mask(
        frac, _rank_layout(cfg, "app"), x.device)
    sigma, feat = _density_from(params, sig, app)
    return sigma, tensorf_color(params, cfg, d, feat)


# ------------------------------------------------------------------ CCNeRF
def cc_compose_forward(fields, transforms=None):
    """CCNeRF composition of several TensoRF fields in one scene: sigma
    adds, colour is the sigma-weighted mix. transforms: optional per-field
    [4, 4] world-to-model tensors; the directions go through the 3 x 3 block
    and are not renormalised before the SH encoding, as in the reference.
    Returns forward(params_list, x, d) -> (sigma, rgb)."""
    def forward(params_list, x, d):
        sigmas, rgbs = [], []
        for i, f in enumerate(fields):
            xi, di = x, d
            if transforms is not None:
                t = transforms[i].to(x.device)
                xi = (torch.cat([x, torch.ones_like(x[:, :1])], 1)
                      @ t.t())[:, :3]
                di = d @ t[:3, :3].t()
            s, c = f.forward(params_list[i], xi, di)
            sigmas.append(s)
            rgbs.append(c)
        sig = torch.stack(sigmas)                     # [K, N]
        total = sig.sum(0)
        w = sig / total.clamp(min=1e-8)[None]
        return total, (w[..., None] * torch.stack(rgbs)).sum(0)
    return forward
