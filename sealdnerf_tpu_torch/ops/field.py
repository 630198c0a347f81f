"""Fused static CP/VM field forward: the wrapper of the Hopper kernel
ops/csrc/field_fwd.cu and its plain PyTorch version (port of the Pallas
kernel `_field_kernel`, sealdnerf_tpu/ops/pallas_field.py).

    field_forward(params, cfg, x3 [3, M], d3 [3, M]) -> out [4, M]
    rows: sigma, r, g, b (f32)

`params` is either a params dict or the `FieldTables` that `pack_tables`
builds from one: the bf16 tables and tower weights in the kernel's layouts.
Packing costs a pass over ~1.5 MB of parameters, so callers that evaluate
the field repeatedly pack once per parameter version (CPField.kernel_tables).

Device dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes
to the kernel, and a failed build or launch raises. `field_forward.launches`
counts kernel launches.

The plain version reproduces the kernel's rounding points: table taps and
hat weights in bf16, line/plane features rounded to bf16, frequency
features kept in f32 (the Pallas kernel's choice; the XLA path in
models/cp.py rounds them), bf16 hidden activations, f32 sums.
"""

import ctypes
from dataclasses import dataclass

import torch

from ..models.cp import CPConfig, cp_color, cp_density

_KERNEL_TOWERS = dict(num_layers=2, num_layers_color=3, hidden_dim=64,
                      hidden_dim_color=64, geo_feat_dim=15, sh_degree=4)


@dataclass
class FieldTables:
    """bf16 operands of the field for one parameter version.

    plain: params-like dict of bf16 tensors in the reference layouts.
    tab:   flat bf16 buffer of all line, plane and VM-line tables.
    wbuf:  flat bf16 buffer of the five tower matrices, in kernel layouts
           w0 [feat, 64] | w1^T [16, 64] | wc0 [31, 64] | wc1^T [64, 64] |
           wc2 [64, 3], padded to a multiple of 8 elements.
    meta:  int64 layout description read by the kernel's C entry point.
    """
    plain: dict
    tab: torch.Tensor
    wbuf: torch.Tensor
    meta: list


def pack_tables(params, cfg: CPConfig) -> FieldTables:
    bf = torch.bfloat16

    def b(t):
        return t.to(bf).contiguous()

    plain = {"lines": [[b(t) for t in ax] for ax in params["lines"]],
             "sigma_mlp": {"w": [b(w) for w in params["sigma_mlp"]["w"]]},
             "color_mlp": {"w": [b(w) for w in params["color_mlp"]["w"]]}}
    if cfg.planes:
        plain["planes"] = [[b(t) for t in ps] for ps in params["planes"]]
        plain["vm_lines"] = [[b(t) for t in ls] for ls in params["vm_lines"]]

    chunks, off = [], 0

    def put(t):
        nonlocal off
        chunks.append(t.reshape(-1))
        off += t.numel()
        return off - t.numel()

    scale_meta = []
    for s, (res, rank) in enumerate(cfg.scales):
        scale_meta += [res, rank] + [put(plain["lines"][s][a])
                                     for a in range(3)]
    plane_meta = []
    for s, (pres, ch) in enumerate(cfg.planes):
        po = [put(plain["planes"][s][p]) for p in range(3)]
        vo = [put(plain["vm_lines"][s][p]) for p in range(3)]
        plane_meta += [pres, ch] + po + vo
    tab = torch.cat(chunks)

    ws, wc = plain["sigma_mlp"]["w"], plain["color_mlp"]["w"]
    mats = [ws[0], ws[-1].t(), wc[0], wc[1].t(), wc[-1]] \
        if len(ws) == 2 and len(wc) == 3 else []
    w_off, parts, n = [], [], 0
    for mat in mats:
        w_off.append(n)
        parts.append(mat.contiguous().reshape(-1))
        n += mat.numel()
    pad = (-n) % 8
    if pad:
        parts.append(tab.new_zeros(pad))
    wbuf = torch.cat(parts) if parts else tab.new_zeros(0)
    w_off += [0] * (5 - len(w_off))
    meta = [len(cfg.scales), len(cfg.planes), cfg.freq_degree, cfg.feat_dim,
            n + pad] + w_off + scale_meta + plane_meta
    return FieldTables(plain=plain, tab=tab, wbuf=wbuf, meta=meta)


def field_forward_plain(tables: FieldTables, cfg: CPConfig, x3, d3,
                        lod_skip=(), density_only=False, chunk: int = 1 << 18):
    """Plain PyTorch version of the kernel, in chunks of `chunk` samples."""
    m = x3.shape[1]
    out = x3.new_zeros((4, m))
    x = x3.t()
    for i in range(0, m, chunk):
        sigma, geo = cp_density(tables.plain, cfg, x[i:i + chunk],
                                lod_skip=lod_skip, round_freq=False)
        out[0, i:i + chunk] = sigma
        if not density_only:
            rgb = cp_color(tables.plain, cfg, d3.t()[i:i + chunk], geo)
            out[1:4, i:i + chunk] = rgb.t()
    return out


def _check_kernel_cfg(cfg: CPConfig):
    for k, v in _KERNEL_TOWERS.items():
        if getattr(cfg, k) != v:
            raise NotImplementedError(
                f"the field kernel is built for {k}={v}, got "
                f"{getattr(cfg, k)}")
    if len(cfg.scales) > 8 or len(cfg.planes) > 4:
        raise NotImplementedError("the field kernel takes at most 8 line "
                                  "scales and 4 plane scales")


def _launch(tables: FieldTables, cfg: CPConfig, x3, d3, lod_skip,
            density_only):
    from .build import load_library
    _check_kernel_cfg(cfg)
    for name, t in (("tables", tables.tab), ("weights", tables.wbuf)):
        if t.device != x3.device or t.dtype != torch.bfloat16:
            raise ValueError(f"packed {name} must be bf16 on {x3.device}, "
                             f"got {t.dtype} on {t.device}")
    m = x3.shape[1]
    out = torch.empty((4, m), dtype=torch.float32, device=x3.device)
    if m == 0:
        return out
    lib = load_library()
    meta = (ctypes.c_longlong * len(tables.meta))(*tables.meta)
    mask = 0
    for s in lod_skip:
        mask |= 1 << int(s)
    stream = torch.cuda.current_stream(x3.device).cuda_stream
    rc = lib.sdn_field_fwd(
        x3.data_ptr(), (x3 if d3 is None else d3).data_ptr(), m,
        tables.tab.data_ptr(), tables.wbuf.data_ptr(), meta,
        float(cfg.bound), mask, int(bool(density_only)), out.data_ptr(),
        stream)
    if rc != 0:
        raise RuntimeError(f"field kernel launch failed: CUDA error {rc}")
    field_forward.launches += 1
    return out


def field_forward(params, cfg: CPConfig, x3, d3, lod_skip=(),
                  density_only=False):
    """Field forward on planar samples.

    Args:
      params: params dict or FieldTables (see pack_tables).
      x3, d3: [3, M] f32 contiguous positions and unit directions on one
        device. d3 may be None when density_only.
      lod_skip: line-scale indices whose features are treated as zero.
      density_only: compute sigma only; rows 1-3 of the output are zero.

    Returns out [4, M] f32, rows (sigma, r, g, b).
    """
    tables = params if isinstance(params, FieldTables) \
        else pack_tables(params, cfg)
    if d3 is None and not density_only:
        raise ValueError("d3 is required unless density_only")
    for name, t in (("x3", x3), ("d3", d3)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != 3:
            raise ValueError(f"{name} must be f32 [3, M], got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x3.device:
            raise ValueError("x3 and d3 must be on one device")
    if d3 is not None and d3.shape != x3.shape:
        raise ValueError(f"d3 {tuple(d3.shape)} != x3 {tuple(x3.shape)}")
    if x3.device.type == "cpu":
        return field_forward_plain(tables, cfg, x3, d3, lod_skip,
                                   density_only)
    if x3.device.type != "cuda":
        raise ValueError(f"unsupported device {x3.device}")
    return _launch(tables, cfg, x3, d3, lod_skip, density_only)


field_forward.launches = 0
