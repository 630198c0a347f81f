"""Fused CP/VM field: the wrappers of the Hopper kernels
ops/csrc/field_fwd.cu (K1, port of the Pallas `_field_kernel`),
ops/csrc/field_bwd.cu (K2, port of `_field_bwd_kernel`) and
ops/csrc/dyn_field_fwd.cu (K3, port of `_dyn_field_kernel`), their plain
PyTorch versions, and the autograd op that joins K1 and K2.

    field_forward(params, cfg, x3 [3, M], d3 [3, M]) -> out [4, M]
    rows: sigma, r, g, b (f32)
    dyn_field_forward(params, cfg, x3, d3, t) -> out [4, M]
    the time-conditioned field at scalar time t: deform tower, then the
    canonical field at x + dx (no gradient: the render path)
    field_backward(tables, cfg, x3, d3, g_out [4, M]) -> grads
    grads: f32 dict in the params' names and layouts
    field_train_forward(params, cfg, x3, d3) -> out [4, M], differentiable
    in the params (K1 forward, K2 backward; x3 and d3 get no gradient)

`params` is either a params dict or the `FieldTables` that `pack_tables`
builds from one: the bf16 tables and tower weights in the kernel's layouts.
Packing costs a pass over ~1.5 MB of parameters, so callers that evaluate
the field repeatedly pack once per parameter version (CPField.kernel_tables).

Device dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes
to the kernel, and a failed build or launch raises. `field_forward.launches`,
`field_backward.launches` and `dyn_field_forward.launches` count kernel
launches.

The plain versions reproduce the kernels' rounding points: table taps and
hat weights in bf16, line/plane features rounded to bf16, frequency
features kept in f32 (the Pallas kernel's choice; the XLA path in
models/cp.py rounds them), bf16 hidden activations, f32 sums. The backward
rounds both operands of every weight-gradient product to bf16, except the
frequency-feature rows of the first sigma matrix, which it sums in f32.
The deform tower of the dynamic kernel rounds freq(x) and every hidden
activation to bf16 and keeps the first layer's 13 time rows, and the bias
they give, in f32 (the XLA path in models/cp.py rounds those too).
"""

import ctypes
from dataclasses import dataclass, field

import torch

from ..models.cp import (VM_PAIRS, CPConfig, CPDNeRFConfig, cp_color,
                         cp_density, param_leaves)
from .freq_encode import freq_encode
from .hat import bf16_round, hat_taps
from .sh_encode import sh_encode

_KERNEL_TOWERS = dict(num_layers=2, num_layers_color=3, hidden_dim=64,
                      hidden_dim_color=64, geo_feat_dim=15, sh_degree=4)
# the dynamic kernel's deform tower: hidden width, rows of the padded last
# matrix, most matrices
_DEFORM_HID, _DEFORM_LAST_ROWS, _DEFORM_MAX_LAYERS = 128, 8, 16


@dataclass
class FieldTables:
    """bf16 operands of the field for one parameter version.

    plain: params-like dict of bf16 tensors in the reference layouts.
    tab:   flat bf16 buffer of all line, plane and VM-line tables.
    wbuf:  flat bf16 buffer of the five tower matrices, in kernel layouts
           w0 [feat, 64] | w1^T [16, 64] | wc0 [31, 64] | wc1^T [64, 64] |
           wc2 [64, 3], padded to a multiple of 8 elements.
    meta:  int64 layout description read by the kernel's C entry point.
    Of a time-conditioned field also (plain then has "deform_mlp" too):
    w0_time: f32 [time inputs, hidden], the first deform matrix's time rows.
    wdef:  flat bf16 buffer of the deform matrices, output-major (W^T):
           [hidden, in_pad] (spatial rows only, zero-padded to a multiple of
           16) | hidden matrices [hidden, hidden] | last [8, hidden] (rows
           3..7 zero). Empty when the tower is not one the kernel takes.
    dmeta: int64 n_layers, hidden, in_dim, in_pad, multires_deform, then the
           element offset of each matrix in wdef.
    """
    plain: dict
    tab: torch.Tensor
    wbuf: torch.Tensor
    meta: list
    w0_time: torch.Tensor = None
    wdef: torch.Tensor = None
    dmeta: list = field(default_factory=list)


@torch.no_grad()
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
    tables = FieldTables(plain=plain, tab=tab, wbuf=wbuf, meta=meta)
    if isinstance(cfg, CPDNeRFConfig):
        _pack_deform(tables, params, cfg)
    return tables


def _pack_deform(tables: FieldTables, params, cfg: CPDNeRFConfig):
    """Add the deform tower's operands to `tables`."""
    bf = torch.bfloat16
    wd = params["deform_mlp"]["w"]
    nx, hid = cfg.deform_space_dim, cfg.hidden_dim_deform
    tables.plain["deform_mlp"] = {"w": [w.to(bf).contiguous() for w in wd]}
    tables.w0_time = wd[0][nx:].detach().float().contiguous()
    in_pad = -(-nx // 16) * 16
    tables.wdef = tables.tab.new_zeros(0)
    if hid != _DEFORM_HID or in_pad > hid or \
            not 2 <= len(wd) <= _DEFORM_MAX_LAYERS:
        return                      # the launch raises for such a tower
    wb = tables.plain["deform_mlp"]["w"]
    first = wb[0].new_zeros((hid, in_pad))
    first[:, :nx] = wb[0][:nx].t()
    last = wb[0].new_zeros((_DEFORM_LAST_ROWS, hid))
    last[:3] = wb[-1].t()
    mats = [first] + [w.t() for w in wb[1:-1]] + [last]
    offs, n = [], 0
    for mat in mats:
        offs.append(n)
        n += mat.numel()
    tables.wdef = torch.cat([mat.contiguous().reshape(-1) for mat in mats])
    tables.dmeta = [len(wd), hid, nx, in_pad, cfg.multires_deform] + offs


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


def _check_samples(x3, d3, density_only):
    """Raise unless x3 (and d3, which may be None when density_only) are
    f32 [3, M], contiguous, on one device."""
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
    _check_samples(x3, d3, density_only)
    if x3.device.type == "cpu":
        return field_forward_plain(tables, cfg, x3, d3, lod_skip,
                                   density_only)
    if x3.device.type != "cuda":
        raise ValueError(f"unsupported device {x3.device}")
    return _launch(tables, cfg, x3, d3, lod_skip, density_only)


field_forward.launches = 0


# ------------------------------------------------------------------ dynamic
def _time_cond(tables: FieldTables, cfg: CPDNeRFConfig, t, device):
    """The frame's conditioning: the first deform layer's time bias
    W0[nx:]^T freq(t) [hidden] and the flag t != 0 [1], both f32 on
    `device`, computed there from a float or from a tensor that holds t."""
    t = torch.as_tensor(t, dtype=torch.float32, device=device).reshape(1, 1)
    tvec = freq_encode(t, degree=cfg.multires_time)[0]
    return tvec @ tables.w0_time, (t != 0.0).float().reshape(1)


def dyn_field_forward_plain(tables: FieldTables, cfg: CPDNeRFConfig, x3, d3,
                            t, lod_skip=(), density_only=False,
                            chunk: int = 1 << 17, return_deform=False):
    """Plain PyTorch version of the dynamic kernel, in chunks of `chunk`
    samples. return_deform=True also returns the warp dx [3, M]."""
    m = x3.shape[1]
    out = x3.new_zeros((4, m))
    dxs = x3.new_zeros((3, m)) if return_deform else None
    tb, flag = _time_cond(tables, cfg, t, x3.device)
    wd = [w.float() for w in tables.plain["deform_mlp"]["w"]]
    nx = cfg.deform_space_dim
    x = x3.t()
    for i in range(0, m, chunk):
        xc = x[i:i + chunk]
        h = bf16_round(freq_encode(xc, degree=cfg.multires_deform)) \
            @ wd[0][:nx] + tb
        for w in wd[1:]:
            h = bf16_round(torch.relu(h)) @ w
        dx = torch.where(flag != 0.0, h, torch.zeros_like(h))
        sigma, geo = cp_density(tables.plain, cfg, xc + dx,
                                lod_skip=lod_skip, round_freq=False)
        out[0, i:i + chunk] = sigma
        if not density_only:
            rgb = cp_color(tables.plain, cfg, d3.t()[i:i + chunk], geo)
            out[1:4, i:i + chunk] = rgb.t()
        if return_deform:
            dxs[:, i:i + chunk] = dx.t()
    return (out, dxs) if return_deform else out


def _launch_dyn(tables: FieldTables, cfg: CPDNeRFConfig, x3, d3, t, lod_skip,
                density_only):
    from .build import load_library
    _check_kernel_cfg(cfg)
    if not tables.dmeta:
        raise NotImplementedError(
            f"the dynamic field kernel is built for hidden_dim_deform="
            f"{_DEFORM_HID}, 2..{_DEFORM_MAX_LAYERS} deform layers and at "
            f"most {_DEFORM_HID} spatial inputs, got hidden "
            f"{cfg.hidden_dim_deform}, {cfg.num_layers_deform} layers, "
            f"{cfg.deform_space_dim} inputs")
    for name, buf in (("tables", tables.tab), ("weights", tables.wbuf),
                      ("deform weights", tables.wdef)):
        if buf.device != x3.device or buf.dtype != torch.bfloat16:
            raise ValueError(f"packed {name} must be bf16 on {x3.device}, "
                             f"got {buf.dtype} on {buf.device}")
    m = x3.shape[1]
    out = torch.empty((4, m), dtype=torch.float32, device=x3.device)
    if m == 0:
        return out
    tcond = torch.cat(_time_cond(tables, cfg, t, x3.device)).contiguous()
    lib = load_library()
    meta = (ctypes.c_longlong * len(tables.meta))(*tables.meta)
    dmeta = (ctypes.c_longlong * len(tables.dmeta))(*tables.dmeta)
    mask = 0
    for s in lod_skip:
        mask |= 1 << int(s)
    stream = torch.cuda.current_stream(x3.device).cuda_stream
    rc = lib.sdn_dyn_field_fwd(
        x3.data_ptr(), (x3 if d3 is None else d3).data_ptr(), m,
        tables.tab.data_ptr(), tables.wbuf.data_ptr(), meta,
        float(cfg.bound), tables.wdef.data_ptr(), dmeta, tcond.data_ptr(),
        mask, int(bool(density_only)), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"dynamic field kernel launch failed: CUDA error {rc}")
    dyn_field_forward.launches += 1
    return out


def dyn_field_forward(params, cfg: CPDNeRFConfig, x3, d3, t, lod_skip=(),
                      density_only=False):
    """Time-conditioned field forward on planar samples (render path, no
    gradient).

    Args:
      params: params dict or FieldTables (see pack_tables) of a field with
        a deform tower.
      x3, d3: [3, M] f32 contiguous positions and unit directions on one
        device. d3 may be None when density_only.
      t: the frame's time, a float or a tensor holding one value; a tensor
        on x3's device is read there, without a host round trip.
      lod_skip, density_only: as field_forward.

    Returns out [4, M] f32, rows (sigma, r, g, b).
    """
    if not isinstance(cfg, CPDNeRFConfig):
        raise TypeError("dyn_field_forward needs a CPDNeRFConfig")
    tables = params if isinstance(params, FieldTables) \
        else pack_tables(params, cfg)
    if tables.w0_time is None:
        raise ValueError("the tables hold no deform tower")
    _check_samples(x3, d3, density_only)
    if x3.device.type == "cpu":
        return dyn_field_forward_plain(tables, cfg, x3, d3, t, lod_skip,
                                       density_only)
    if x3.device.type != "cuda":
        raise ValueError(f"unsupported device {x3.device}")
    return _launch_dyn(tables, cfg, x3, d3, t, lod_skip, density_only)


dyn_field_forward.launches = 0


# ------------------------------------------------------------------ backward
def _zero_grads(plain, device):
    """f32 zeros shaped like the params (plain is the bf16 params dict)."""
    def z(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=device)
    out = {"lines": [[z(t) for t in ax] for ax in plain["lines"]],
           "sigma_mlp": {"w": [z(w) for w in plain["sigma_mlp"]["w"]]},
           "color_mlp": {"w": [z(w) for w in plain["color_mlp"]["w"]]}}
    if "planes" in plain:
        out["planes"] = [[z(t) for t in ps] for ps in plain["planes"]]
        out["vm_lines"] = [[z(t) for t in ls] for ls in plain["vm_lines"]]
    return out


def _lerp(t, i0, w0, w1):
    return w0[:, None] * t[i0] + w1[:, None] * t[i0 + 1]


def _bwd_chunk(tp, cfg: CPConfig, x, d, g_out, grads):
    """Recompute the forward on x, d [S, 3] and add the param grads of the
    cotangent g_out [4, S] into `grads`."""
    x01 = (x + cfg.bound) / (2.0 * cfg.bound)
    feats, lines, vms = [], [], []
    for s, (res, _) in enumerate(cfg.scales):
        taps = [hat_taps(x01[:, a], res) for a in range(3)]
        f = [_lerp(tp["lines"][s][a].float(), *taps[a]) for a in range(3)]
        lines.append((taps, f))
        feats.append(f[0] * f[1] * f[2])
    for s, (pres, _) in enumerate(cfg.planes):
        for p, (a, b, e) in enumerate(VM_PAIRS):
            (ia, ua0, ua1), (ib, ub0, ub1), te = (
                hat_taps(x01[:, k], pres) for k in (a, b, e))
            pl = tp["planes"][s][p].float()
            q0 = ua0[:, None] * pl[ia, ib] + ua1[:, None] * pl[ia + 1, ib]
            q1 = ua0[:, None] * pl[ia, ib + 1] + ua1[:, None] * pl[ia + 1,
                                                                 ib + 1]
            fv = ub0[:, None] * q0 + ub1[:, None] * q1
            lv = _lerp(tp["vm_lines"][s][p].float(), *te)
            vms.append(((ia, ua0, ua1), (ib, ub0, ub1), te, fv, lv))
            feats.append(fv * lv)
    grid = bf16_round(torch.cat(feats, dim=-1))              # [S, G]
    freq = freq_encode(x, degree=cfg.freq_degree)            # [S, 27] f32
    w0, w1 = (w.float() for w in tp["sigma_mlp"]["w"])
    wc0, wc1, wc2 = (w.float() for w in tp["color_mlp"]["w"])
    h0 = torch.cat([grid, freq], dim=-1) @ w0
    r0 = bf16_round(torch.relu(h0))
    h1 = r0 @ w1
    cin = bf16_round(torch.cat([sh_encode(d, degree=cfg.sh_degree),
                                h1[:, 1:]], dim=-1))         # [S, 31]
    hc0 = cin @ wc0
    rc0 = bf16_round(torch.relu(hc0))
    hc1 = rc0 @ wc1
    rc1 = bf16_round(torch.relu(hc1))
    rgb = torch.sigmoid(rc1 @ wc2)

    # chain; every transposed product takes bf16 operands, f32 sums
    g_hc2 = bf16_round(g_out[1:4].t() * rgb * (1.0 - rgb))
    g_hc1 = bf16_round((g_hc2 @ wc2.t()) * (hc1 > 0))
    g_hc0 = bf16_round((g_hc1 @ wc1.t()) * (hc0 > 0))
    g_geo = g_hc0 @ wc0[wc0.shape[0] - cfg.geo_feat_dim:].t()
    g_h1_0 = g_out[0] * torch.exp(h1[:, 0].clamp(-15.0, 15.0))
    g_h1 = bf16_round(torch.cat([g_h1_0[:, None], g_geo], dim=-1))
    g_h0 = (g_h1 @ w1.t()) * (h0 > 0)                        # f32
    g_h0b = bf16_round(g_h0)
    gs, gc = grads["sigma_mlp"]["w"], grads["color_mlp"]["w"]
    gc[2] += rc1.t() @ g_hc2
    gc[1] += rc0.t() @ g_hc1
    gc[0] += cin.t() @ g_hc0
    gs[1] += r0.t() @ g_h1
    n_grid = grid.shape[1]
    gs[0][:n_grid] += grid.t() @ g_h0b
    gs[0][n_grid:] += freq.t() @ g_h0          # frequency rows: f32 sums
    g_grid = g_h0b @ w0[:n_grid].t()                         # [S, G]

    row = 0
    for s, (_, rank) in enumerate(cfg.scales):
        taps, f = lines[s]
        g_prod = g_grid[:, row:row + rank]
        for a in range(3):
            g_f = bf16_round(g_prod * (f[(a + 1) % 3] * f[(a + 2) % 3]))
            i0, u0, u1 = taps[a]
            gt = grads["lines"][s][a]
            gt.index_add_(0, i0, g_f * u0[:, None])
            gt.index_add_(0, i0 + 1, g_f * u1[:, None])
        row += rank
    k = 0
    for s, (pres, ch) in enumerate(cfg.planes):
        for p in range(3):
            (ia, ua0, ua1), (ib, ub0, ub1), (ie, ue0, ue1), fv, lv = vms[k]
            k += 1
            g_vm = g_grid[:, row:row + ch]
            row += ch
            g_l = bf16_round(g_vm * fv)
            gl = grads["vm_lines"][s][p]
            gl.index_add_(0, ie, g_l * ue0[:, None])
            gl.index_add_(0, ie + 1, g_l * ue1[:, None])
            g_f = g_vm * lv
            gp = grads["planes"][s][p].view(pres * pres, ch)
            for jb, ub in ((ib, ub0), (ib + 1, ub1)):
                g_q = bf16_round(g_f * ub[:, None])
                gp.index_add_(0, ia * pres + jb, g_q * ua0[:, None])
                gp.index_add_(0, (ia + 1) * pres + jb, g_q * ua1[:, None])


def field_backward_plain(tables: FieldTables, cfg: CPConfig, x3, d3, g_out,
                         chunk: int = 1 << 17):
    """Plain PyTorch version of K2, in chunks of `chunk` samples."""
    grads = _zero_grads(tables.plain, x3.device)
    x, d = x3.t(), d3.t()
    with torch.no_grad():
        for i in range(0, x3.shape[1], chunk):
            _bwd_chunk(tables.plain, cfg, x[i:i + chunk], d[i:i + chunk],
                       g_out[:, i:i + chunk], grads)
    return grads


def _unpack_grads(tables: FieldTables, cfg: CPConfig, g_tab, g_w):
    """Views of the kernel's flat grad buffers in the params' layouts."""
    meta = tables.meta
    n_scales, n_planes, feat = meta[0], meta[1], meta[3]
    w_off = meta[5:10]
    q = 10
    out = {"lines": []}
    for s in range(n_scales):
        res, rank = meta[q], meta[q + 1]
        out["lines"].append([g_tab[o:o + res * rank].view(res, rank)
                             for o in meta[q + 2:q + 5]])
        q += 5
    if n_planes:
        out["planes"], out["vm_lines"] = [], []
        for s in range(n_planes):
            pres, ch = meta[q], meta[q + 1]
            n_pl, n_vl = pres * pres * ch, pres * ch
            out["planes"].append([g_tab[o:o + n_pl].view(pres, pres, ch)
                                  for o in meta[q + 2:q + 5]])
            out["vm_lines"].append([g_tab[o:o + n_vl].view(pres, ch)
                                    for o in meta[q + 5:q + 8]])
            q += 8
    hid, hc, sig_out = cfg.hidden_dim, cfg.hidden_dim_color, \
        1 + cfg.geo_feat_dim
    c_in = cfg.dir_dim + cfg.geo_feat_dim

    def mat(k, rows, cols):
        return g_w[w_off[k]:w_off[k] + rows * cols].view(rows, cols)
    out["sigma_mlp"] = {"w": [mat(0, feat, hid), mat(1, sig_out, hid).t()]}
    out["color_mlp"] = {"w": [mat(2, c_in, hc), mat(3, hc, hc).t(),
                              mat(4, hc, 3)]}
    return out


def _launch_bwd(tables: FieldTables, cfg: CPConfig, x3, d3, g_out):
    from .build import load_library
    _check_kernel_cfg(cfg)
    for name, t in (("tables", tables.tab), ("weights", tables.wbuf)):
        if t.device != x3.device or t.dtype != torch.bfloat16:
            raise ValueError(f"packed {name} must be bf16 on {x3.device}, "
                             f"got {t.dtype} on {t.device}")
    m = x3.shape[1]
    # zeroed on the launch stream: the kernel only adds into them
    g_tab = torch.zeros(tables.tab.numel(), dtype=torch.float32,
                        device=x3.device)
    g_w = torch.zeros(tables.wbuf.numel(), dtype=torch.float32,
                      device=x3.device)
    if m > 0:
        lib = load_library()
        meta = (ctypes.c_longlong * len(tables.meta))(*tables.meta)
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        rc = lib.sdn_field_bwd(
            x3.data_ptr(), d3.data_ptr(), g_out.data_ptr(), m,
            tables.tab.data_ptr(), tables.wbuf.data_ptr(), meta,
            float(cfg.bound), g_tab.data_ptr(), g_w.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(
                f"field backward kernel launch failed: CUDA error {rc}")
        field_backward.launches += 1
    return _unpack_grads(tables, cfg, g_tab, g_w)


def field_backward(tables, cfg: CPConfig, x3, d3, g_out):
    """Param gradients of the field at planar samples.

    Args:
      tables: params dict or FieldTables (see pack_tables).
      x3, d3: [3, M] f32 contiguous positions and unit directions.
      g_out: [4, M] f32 contiguous cotangent of field_forward's output
        (rows sigma, r, g, b).

    Returns an f32 dict in the params' names and layouts. On CUDA the
    tensors are views into two flat buffers (one for the tables, one for
    the tower weights). Samples whose four cotangents are zero add nothing.
    """
    tables = tables if isinstance(tables, FieldTables) \
        else pack_tables(tables, cfg)
    for name, t, rows in (("x3", x3, 3), ("d3", d3, 3), ("g_out", g_out, 4)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != rows \
                or t.shape[1] != x3.shape[1]:
            raise ValueError(f"{name} must be f32 [{rows}, M], got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x3.device:
            raise ValueError("x3, d3 and g_out must be on one device")
    if x3.device.type == "cpu":
        return field_backward_plain(tables, cfg, x3, d3, g_out)
    if x3.device.type != "cuda":
        raise ValueError(f"unsupported device {x3.device}")
    return _launch_bwd(tables, cfg, x3, d3, g_out)


field_backward.launches = 0


class FieldTrainFn(torch.autograd.Function):
    """Field forward (K1) whose backward is K2, the port of the reference's
    custom VJP `cp_train_fused`. Inputs: the packed tables of the current
    param values, the config, whether to run the plain versions instead of
    the kernels (for comparisons on the card), x3, d3 and the f32 param
    leaves in `param_leaves` order. Positions and directions get no
    gradient, as in the reference (static scenes)."""

    @staticmethod
    def forward(ctx, tables, cfg, plain, x3, d3, *leaves):
        ctx.tables, ctx.cfg, ctx.plain = tables, cfg, plain
        ctx.save_for_backward(x3, d3)
        if plain:
            return field_forward_plain(tables, cfg, x3, d3)
        return field_forward(tables, cfg, x3, d3)

    @staticmethod
    def backward(ctx, g_out):
        x3, d3 = ctx.saved_tensors
        bwd = field_backward_plain if ctx.plain else field_backward
        grads = bwd(ctx.tables, ctx.cfg, x3, d3, g_out.contiguous())
        return (None, None, None, None, None) + tuple(param_leaves(grads))


def field_train_forward(params, cfg: CPConfig, x3, d3, tables=None,
                        plain: bool = False):
    """Differentiable field forward: out [4, M] (rows sigma, r, g, b).
    `tables` must be packed from the current values of `params` (for
    example CPField.kernel_tables(params)); None packs them here.
    plain=True runs the plain versions on any device (no kernel launch)."""
    if tables is None:
        tables = pack_tables(params, cfg)
    return FieldTrainFn.apply(tables, cfg, plain, x3, d3,
                              *param_leaves(params))
