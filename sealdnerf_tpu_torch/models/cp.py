"""Multiscale CP/VM factorized radiance field, static and time-conditioned
(port of sealdnerf_tpu/models/cp.py).

  per scale s:  f_axis = lerp(line_axis[s], x_axis)        [S, R_s]
                feat_s = f_x * f_y * f_z                    (CP product)
  per VM scale: plane(x_a, x_b) * line(x_e) per axis pair   [S, 3*C]
  feat = concat_s(feat_s) ++ concat_vm ++ freq(xyz)         [S, F]
  sigma tower: feat -> 64 -> 1 + geo_feat(15), trunc_exp
  color tower: SH(d) ++ geo_feat -> 64 -> 64 -> 3, sigmoid

The reference evaluates the interpolation as hat-basis matmuls; here it is
a gather of the two (lines) or four (planes) neighbouring table entries
with the same bf16-rounded weights (ops/hat.py). Parameters are a dict of
tensors with the reference pytree's names and layouts, so that
`params_from_jax` carries weights over unchanged:
lines[s][a] [res, rank], planes[s][p] [P, P, C], vm_lines[s][p] [P, C],
sigma_mlp/color_mlp["w"][i] [in, out].

The time-conditioned variant (CPDNeRFConfig) puts a D-NeRF deformation tower
in front of the canonical field: freq(x) ++ freq(t) -> 128 x 7 -> dx, zero at
t == 0, and the canonical field is read at x + dx. deform_mlp["w"][i] is
[in, out] like the other towers.

This module is the plain PyTorch version of the reference's XLA path (the
sigma tower reads every feature in bf16, the deform tower its 13 time inputs
too). The kernels' semantics, with the frequency features and the time bias
kept in f32, live in ops/field.py.
"""

from dataclasses import dataclass, replace
from typing import Tuple

import torch

from ..ops.activation import trunc_exp
from ..ops.freq_encode import freq_encode, freq_output_dim
from ..ops.hat import bf16_round, hat_taps, line_interp
from ..ops.sh_encode import sh_encode, sh_output_dim
from ..utils import profiling
from .mlp import apply_mlp, init_mlp
from .params import (PackedTables, map_params, param_leaves,  # noqa: F401
                     params_from_jax, params_to_numpy, unflatten_like)


@dataclass(frozen=True)
class CPConfig:
    bound: float = 1.0
    # (resolution, rank) per CP line scale
    scales: Tuple[Tuple[int, int], ...] = (
        (32, 32), (128, 48), (512, 64), (1024, 64))
    # (plane_res, channels) per VM scale: pairs XY*Z | XZ*Y | YZ*X
    planes: Tuple[Tuple[int, int], ...] = ((128, 8),)
    freq_degree: int = 4
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    sh_degree: int = 4
    bg_radius: float = -1.0
    init_scale: float = 0.2        # TensoRF CP factor init: 0.2 * randn

    @property
    def feat_dim(self) -> int:
        return sum(r for _, r in self.scales) + \
            sum(3 * c for _, c in self.planes) + \
            freq_output_dim(3, self.freq_degree)

    @property
    def grid_feat_dim(self) -> int:
        """Feature rows that come from the line and plane tables."""
        return self.feat_dim - freq_output_dim(3, self.freq_degree)

    @property
    def dir_dim(self) -> int:
        return sh_output_dim(self.sh_degree)


def default_planes(bound: float) -> Tuple[Tuple[int, int], ...]:
    """One (128, 8) VM scale for bound <= 1, none for bound > 1."""
    return ((128, 8),) if bound <= 1.0 else ()


def parse_planes(spec: str, bound: float):
    """--planes flag: 'auto' | 'off' | 'res,ch[;res,ch...]'."""
    s = (spec or "auto").strip().lower()
    if s == "auto":
        return default_planes(bound)
    if s in ("off", "none", ""):
        return ()
    return tuple(tuple(int(v) for v in part.split(","))
                 for part in s.split(";"))


# VM plane-line factor pairs: (plane axis a, plane axis b, line axis e)
VM_PAIRS = ((0, 1, 2), (0, 2, 1), (1, 2, 0))


def _tower_dims(cfg: CPConfig):
    sigma = [cfg.feat_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1) \
        + [1 + cfg.geo_feat_dim]
    color = [cfg.dir_dim + cfg.geo_feat_dim] \
        + [cfg.hidden_dim_color] * (cfg.num_layers_color - 1) + [3]
    return sigma, color


def init_cp(generator: torch.Generator, cfg: CPConfig, device=None):
    """Seeded init: 0.2 * randn tables, torch.nn.Linear-style towers.
    Drawn on the CPU from `generator`, then moved to `device`, so a seed
    gives the same field on every device."""
    g = generator

    def randn(*shape):
        return cfg.init_scale * torch.randn(shape, generator=g,
                                            dtype=torch.float32)

    params = {"lines": [[randn(res, rank) for _ in range(3)]
                        for res, rank in cfg.scales]}
    if cfg.planes:
        params["planes"], params["vm_lines"] = [], []
        for pres, ch in cfg.planes:
            params["planes"].append([randn(pres, pres, ch) for _ in range(3)])
            params["vm_lines"].append([randn(pres, ch) for _ in range(3)])
    sigma_dims, color_dims = _tower_dims(cfg)
    params["sigma_mlp"] = init_mlp(g, sigma_dims)
    params["color_mlp"] = init_mlp(g, color_dims)
    return map_params(lambda t: t.to(device), params) if device else params


def config_from_params(params, base: CPConfig) -> CPConfig:
    """`base` with the line and plane scales read off the parameter shapes.

    Checkpoints store no field config, so a checkpoint trained at other
    scales than the CLI defaults is served at the scales it was trained
    with. The towers and encodings must match `base`."""
    scales = tuple(tuple(ax[0].shape) for ax in params["lines"])
    planes = tuple((ps[0].shape[0], ps[0].shape[2])
                   for ps in params.get("planes", ()))
    if "deform_mlp" in params:
        # a time-conditioned checkpoint: depth and width of the deform tower
        # come off the shapes; multires_deform and multires_time cannot be
        # told apart from the input width, so `base` (or the defaults) must
        # already agree with it
        dw = params["deform_mlp"]["w"]
        fields = {k: getattr(base, k) for k in base.__dataclass_fields__}
        fields.update(scales=scales, planes=planes,
                      num_layers_deform=len(dw),
                      hidden_dim_deform=int(dw[0].shape[1]))
        cfg = CPDNeRFConfig(**fields)
        if int(dw[0].shape[0]) != cfg.deform_in_dim:
            raise ValueError(
                f"deform_mlp takes {int(dw[0].shape[0])} inputs, but "
                f"multires_deform={cfg.multires_deform} and multires_time="
                f"{cfg.multires_time} give {cfg.deform_in_dim}")
        got = [tuple(w.shape) for w in dw]
        dims = _deform_dims(cfg)
        if got != list(zip(dims[:-1], dims[1:])):
            raise ValueError(f"deform_mlp shapes {got} do not match the "
                             f"field config (expected {dims})")
    elif isinstance(base, CPDNeRFConfig):
        raise ValueError("a time-conditioned field needs params with a "
                         "deform_mlp; these have none")
    else:
        cfg = replace(base, scales=scales, planes=planes)
    sigma_dims, color_dims = _tower_dims(cfg)
    for name, dims in (("sigma_mlp", sigma_dims), ("color_mlp", color_dims)):
        got = [tuple(w.shape) for w in params[name]["w"]]
        if got != list(zip(dims[:-1], dims[1:])):
            raise ValueError(f"{name} shapes {got} do not match the field "
                             f"config (expected {dims})")
    return cfg


def _plane_interp(plane, x01a, x01b):
    """Bilinear read of plane [P, P, C] (bf16) at (x01a, x01b) -> [S, C]:
    the four taps with bf16-rounded hat weights, summed over the first
    axis, then the second, as the reference's chained contraction does."""
    pres = plane.shape[0]
    ia, ua0, ua1 = hat_taps(x01a, pres)
    ib, ub0, ub1 = hat_taps(x01b, pres)
    pl = bf16_round(plane.float())
    q0 = ua0[:, None] * pl[ia, ib] + ua1[:, None] * pl[ia + 1, ib]
    q1 = ua0[:, None] * pl[ia, ib + 1] + ua1[:, None] * pl[ia + 1, ib + 1]
    return ub0[:, None] * q0 + ub1[:, None] * q1


def cp_features(params, cfg: CPConfig, x, lod_skip=()):
    """x [S, 3] in [-bound, bound] -> features [S, feat_dim] f32.
    Line scales listed in lod_skip give zero features."""
    x01 = (x + cfg.bound) / (2.0 * cfg.bound)
    feats = []
    for s, (res, rank) in enumerate(cfg.scales):
        if s in lod_skip:
            feats.append(x.new_zeros((x.shape[0], rank)))
            continue
        prod = None
        for a in range(3):
            f = line_interp(x01[:, a], params["lines"][s][a])
            prod = f if prod is None else prod * f
        feats.append(prod)
    for s in range(len(cfg.planes)):
        for p, (a, b, e) in enumerate(VM_PAIRS):
            f = _plane_interp(params["planes"][s][p], x01[:, a], x01[:, b])
            l = line_interp(x01[:, e], params["vm_lines"][s][p])
            feats.append(f * l)
    feats.append(freq_encode(x, degree=cfg.freq_degree))
    return torch.cat(feats, dim=-1)


def cp_density(params, cfg: CPConfig, x, lod_skip=(), round_freq=True):
    """(sigma [S], geo_feat [S, geo_feat_dim]). round_freq=False keeps the
    frequency features in f32, as the fused kernel does."""
    feat = cp_features(params, cfg, x, lod_skip)
    if round_freq:
        feat = bf16_round(feat)
    else:
        g = cfg.grid_feat_dim
        feat = torch.cat([bf16_round(feat[:, :g]), feat[:, g:]], dim=-1)
    h = apply_mlp(params["sigma_mlp"], feat, round_input=False)
    return trunc_exp(h[:, 0]), h[:, 1:]


def cp_color(params, cfg: CPConfig, d, geo_feat):
    de = sh_encode(d, degree=cfg.sh_degree)
    h = torch.cat([de, geo_feat], dim=-1)
    return apply_mlp(params["color_mlp"], h, final_activation=torch.sigmoid)


def cp_forward(params, cfg: CPConfig, x, d, chunk: int = 1 << 18):
    """(sigma [S], rgb [S, 3]), evaluated in chunks of `chunk` samples so
    that a whole frame fits in memory."""
    sig, rgb = [], []
    for i in range(0, x.shape[0], chunk):
        s, geo = cp_density(params, cfg, x[i:i + chunk])
        sig.append(s)
        rgb.append(cp_color(params, cfg, d[i:i + chunk], geo))
    return torch.cat(sig), torch.cat(rgb)


class CPField(PackedTables):
    """Params + config of a CP field, with the kernel's packed bf16 tables
    cached per parameter version (PackedTables.kernel_tables)."""

    def __init__(self, params, cfg: CPConfig):
        self.params = params
        self.cfg = cfg
        self._tables = {}

    def _pack(self, params):
        from ..ops.field import pack_tables
        return pack_tables(params, self.cfg)


def make_cp_field(generator: torch.Generator, cfg: CPConfig, device=None):
    return CPField(init_cp(generator, cfg, device), cfg)


def flops_per_sample(cfg: CPConfig) -> int:
    """Matmul FLOPs (2 x MACs) of one forward field evaluation per sample,
    counted as the reference's hat-basis matmul formulation does (the
    gather formulation here does far fewer table MACs; the towers are the
    same). A CPDNeRFConfig adds its deform tower."""
    macs = 0
    for res, rank in cfg.scales:
        macs += 3 * res * rank
    for pres, ch in cfg.planes:
        macs += 3 * (pres * pres * ch + pres * ch + pres * ch)
    sigma_dims, color_dims = _tower_dims(cfg)
    towers = [sigma_dims, color_dims]
    if isinstance(cfg, CPDNeRFConfig):
        towers.append(_deform_dims(cfg))
    for dims in towers:
        macs += sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return 2 * macs


# ----------------------------------------------------------- dynamic variant
@dataclass(frozen=True)
class CPDNeRFConfig(CPConfig):
    """Time-conditioned CP field: a D-NeRF deformation tower in front of a
    canonical CP field."""

    num_layers_deform: int = 8
    hidden_dim_deform: int = 128
    multires_deform: int = 10
    multires_time: int = 6
    # The warp's gradient flows only through scales with res <= this cutoff:
    # the fine tables' piecewise-linear d(feat)/dx is large and flips sign,
    # and would drown the warp in noise. Fine scales are still read at the
    # warped point; they just do not drive the warp.
    deform_grad_res_cutoff: int = 256

    @property
    def deform_space_dim(self) -> int:
        """Inputs of the deform tower that come from the position."""
        return freq_output_dim(3, self.multires_deform)

    @property
    def deform_in_dim(self) -> int:
        return self.deform_space_dim + freq_output_dim(1, self.multires_time)


def _deform_dims(cfg: CPDNeRFConfig):
    return [cfg.deform_in_dim] \
        + [cfg.hidden_dim_deform] * (cfg.num_layers_deform - 1) + [3]


def init_cp_dnerf(generator: torch.Generator, cfg: CPDNeRFConfig,
                  device=None):
    """init_cp plus the deform tower, whose last matrix is scaled by 1e-3:
    the default init warps by O(0.3) units, which pollutes the canonical
    field for thousands of steps."""
    params = init_cp(generator, cfg)
    params["deform_mlp"] = init_mlp(generator, _deform_dims(cfg))
    params["deform_mlp"]["w"][-1] = params["deform_mlp"]["w"][-1] * 1e-3
    return map_params(lambda t: t.to(device), params) if device else params


def _as_time(t, like):
    """Scalar time (float or 0-d/1-element tensor) as a 0-d f32 tensor on
    `like`'s device, without a host round trip for a tensor."""
    if not (isinstance(t, torch.Tensor) and t.device == like.device):
        profiling.host_sync(like)       # the copy from pageable memory
    return torch.as_tensor(t, dtype=torch.float32,
                           device=like.device).reshape(())


def cp_dnerf_deform_raw(params, cfg: CPDNeRFConfig, x, t):
    """Raw output of the deform tower [S, 3], without the t == 0 gate."""
    t = _as_time(t, x)
    ex = freq_encode(x, degree=cfg.multires_deform)
    et = freq_encode(t.expand(x.shape[0], 1), degree=cfg.multires_time)
    return apply_mlp(params["deform_mlp"], torch.cat([ex, et], dim=-1))


def cp_dnerf_deform(params, cfg: CPDNeRFConfig, x, t):
    """Deform tower; t == 0 forces dx = 0 (the canonical frame)."""
    t = _as_time(t, x)
    h = cp_dnerf_deform_raw(params, cfg, x, t)
    return torch.where(t == 0.0, torch.zeros_like(h), h)


def _warped_density(params, cfg: CPDNeRFConfig, x, deform):
    """Canonical density at x + deform. The warp's gradient reaches only the
    scales and planes with res <= deform_grad_res_cutoff, and the frequency
    features; the finer ones are read at the detached point."""
    xw_grad = x + deform
    xw_stop = x + deform.detach()
    cut = cfg.deform_grad_res_cutoff
    x01g = (xw_grad + cfg.bound) / (2.0 * cfg.bound)
    x01s = (xw_stop + cfg.bound) / (2.0 * cfg.bound)
    feats = []
    for s, (res, _) in enumerate(cfg.scales):
        x01 = x01g if res <= cut else x01s
        prod = None
        for a in range(3):
            f = line_interp(x01[:, a], params["lines"][s][a])
            prod = f if prod is None else prod * f
        feats.append(prod)
    for s, (pres, _) in enumerate(cfg.planes):
        x01 = x01g if pres <= cut else x01s
        for p, (a, b, e) in enumerate(VM_PAIRS):
            f = _plane_interp(params["planes"][s][p], x01[:, a], x01[:, b])
            l = line_interp(x01[:, e], params["vm_lines"][s][p])
            feats.append(f * l)
    feats.append(freq_encode(xw_grad, degree=cfg.freq_degree))
    h = apply_mlp(params["sigma_mlp"], torch.cat(feats, dim=-1))
    return trunc_exp(h[:, 0]), h[:, 1:]


def cp_dnerf_forward(params, cfg: CPDNeRFConfig, x, d, t):
    """(sigma [S], rgb [S, 3], deform [S, 3]) at scalar time t."""
    deform = cp_dnerf_deform(params, cfg, x, t)
    sigma, geo = _warped_density(params, cfg, x, deform)
    return sigma, cp_color(params, cfg, d, geo), deform


def cp_dnerf_density(params, cfg: CPDNeRFConfig, x, t):
    """(sigma [S], geo_feat [S, geo_feat_dim]) at scalar time t."""
    deform = cp_dnerf_deform(params, cfg, x, t)
    return _warped_density(params, cfg, x, deform)


def make_cp_dnerf_field(generator: torch.Generator, cfg: CPDNeRFConfig,
                        device=None):
    """CPField of a seeded time-conditioned field; `deform_raw(params, x,
    t)` is the ungated tower output that the trainer regularises."""
    f = CPField(init_cp_dnerf(generator, cfg, device), cfg)
    f.deform_raw = lambda params, x, t: cp_dnerf_deform_raw(params, cfg, x, t)
    return f
