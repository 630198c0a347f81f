"""Fused CP/VM field: the wrappers of the Hopper kernels
ops/csrc/field_fwd.cu (K1, port of the Pallas `_field_kernel`),
ops/csrc/field_bwd.cu (K2, port of `_field_bwd_kernel`),
ops/csrc/dyn_field_fwd.cu (K3, port of `_dyn_field_kernel`) and
ops/csrc/dyn_field_bwd.cu (K4, port of `_dyn_field_bwd_kernel`), their plain
PyTorch versions, and the autograd ops that join K1 with K2 and K3 with K4.

    field_forward(params, cfg, x3 [3, M], d3 [3, M]) -> out [4, M]
    rows: sigma, r, g, b (f32)
    dyn_field_forward(params, cfg, x3, d3, t) -> out [4, M]
    the time-conditioned field at scalar time t: deform tower, then the
    canonical field at x + dx (no gradient: the render path)
    field_backward(tables, cfg, x3, d3, g_out [4, M]) -> grads
    grads: f32 dict in the params' names and layouts
    field_train_forward(params, cfg, x3, d3) -> out [4, M], differentiable
    in the params (K1 forward, K2 backward; x3 and d3 get no gradient)
    dyn_field_backward(tables, cfg, x3, d3, t, g_out) -> grads, with the
    deform tower's ("deform_mlp")
    dyn_field_train_forward(params, cfg, x3, d3, t) -> out [4, M],
    differentiable in the params (K3 forward, K4 backward; x3, d3 and t get
    no gradient)

`params` is either a params dict or the `FieldTables` that `pack_tables`
builds from one: the bf16 tables and tower weights in the kernels' layouts
(the forward kernels compute 16 samples a warp on the tensor cores and take
the matrices padded and in mma fragment order: TileLayout).
Packing costs a pass over ~1.5 MB of parameters, so callers that evaluate
the field repeatedly pack once per parameter version (CPField.kernel_tables).

Device dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes
to the kernel, and a failed build or launch raises. `field_forward.launches`,
`field_backward.launches`, `dyn_field_forward.launches` and
`dyn_field_backward.launches` count kernel launches.

The plain versions reproduce the kernels' rounding points: table taps and
hat weights in bf16, line/plane features rounded to bf16, frequency
features kept in f32 (the Pallas kernel's choice; the XLA path in
models/cp.py rounds them), bf16 hidden activations, f32 sums. The backward
rounds both operands of every weight-gradient product to bf16, except the
frequency-feature rows of the first sigma matrix, which it sums in f32.
The deform tower of the dynamic kernel rounds freq(x) and every hidden
activation to bf16 and keeps the first layer's 13 time rows, and the bias
they give, in f32 (the XLA path in models/cp.py rounds those too).
The dynamic backward sends the warp's gradient only through the line scales
and planes with res <= cfg.deform_grad_res_cutoff and through the frequency
features; it rounds both operands of the tower's products to bf16, and the
sum over all samples that feeds the first matrix's time rows once, after
summing in f32 (the Pallas kernel rounds it once per tile of its grid).
"""

import ctypes
import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.cp import (VM_PAIRS, CPConfig, CPDNeRFConfig, cp_color,
                         cp_density, cp_features, param_leaves)
from .freq_encode import freq_encode
from .hat import bf16_round, hat_slopes, hat_taps
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
    wbuf:  flat bf16 buffer of the five tower matrices, in the backward
           kernels' layouts w0 [feat, 64] | w1^T [16, 64] | wc0 [31, 64] |
           wc1^T [64, 64] | wc2 [64, 3], padded to a multiple of 8 elements.
    wfwd:  flat bf16 buffer of the same matrices for the forward kernels:
           padded, the first one's rows in the order of the kernels' feature
           segments, each in mma fragment order (see TileLayout). Empty when
           the config is not one the forward kernels take.
    meta:  int64 layout description read by the kernels' C entry points:
           the tables and wbuf, then the forward kernels' tile layout.
    Of a time-conditioned field also (plain then has "deform_mlp" too):
    w0_time: f32 [time inputs, hidden], the first deform matrix's time rows.
    wdef:  flat bf16 buffer of the deform matrices, output-major (W^T):
           [hidden, in_pad] (spatial rows only, zero-padded to a multiple of
           16) | hidden matrices [hidden, hidden] | last [8, hidden] (rows
           3..7 zero). Empty when the tower is not one the kernel takes.
    wdef_in: the hidden matrices once more, input-major [hidden, hidden],
           for the backward kernel's input gradients.
    dmeta: int64 n_layers, hidden, in_dim, in_pad, multires_deform, then the
           element offset of each matrix in wdef.
    """
    plain: dict
    tab: torch.Tensor
    wbuf: torch.Tensor
    meta: list
    wfwd: torch.Tensor = None
    w0_time: torch.Tensor = None
    wdef: torch.Tensor = None
    wdef_in: torch.Tensor = None
    dmeta: list = field(default_factory=list)


# segment kinds of the forward kernels' tile layout (csrc/field_fwd_body.cuh)
SEG_ZERO, SEG_LINE, SEG_PLANE, SEG_FREQ = 0, 1, 2, 3
_MAX_BLOCKS = 16


def _frag_index(idx):
    """idx [K, N] (K, N multiples of 16) -> flat [K * N] in the B-fragment
    order of mma.sync.m16n8k16: [k-step][pair of n-tiles][lane][8], the eight
    being rows k0 + 2t, 2t+1, 2t+8, 2t+9 of column n0 + g, then of column
    n0 + 8 + g (g = lane // 4, t = lane % 4, k0 = 16 k-step, n0 = 16 pair)."""
    k, n = idx.shape
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    rows = (16 * np.arange(k // 16))[:, None, None, None] \
        + (2 * t)[None, None, :, None] \
        + np.array([0, 1, 8, 9, 0, 1, 8, 9])[None, None, None, :]
    cols = (16 * np.arange(n // 16))[None, :, None, None] \
        + g[None, None, :, None] \
        + np.array([0, 0, 0, 0, 8, 8, 8, 8])[None, None, None, :]
    return idx[rows, cols].reshape(-1)


@dataclass(frozen=True, eq=False)
class TileLayout:
    """How the forward kernels see the field's features and matrices.

    A warp computes 16 samples; of the first sigma product's columns a thread
    holds eight at a time, a *segment*: eight neighbouring ranks of one line
    scale (three tables), eight channels of one VM pair (plane and line), or
    four values of the frequency encoding as (hi, lo) bf16 pairs. Four
    segments make a k-block of 32 columns; a block holds one kind, padded
    with zero segments.

    segs:  per segment (kind, sub, scale or plane index, first rank or
           channel): sub is the line scale, the VM pair, or the frequency
           segment (0: xyz; q > 0: the (sin, cos) pairs 2q-2 and 2q-1, pair u
           being degree u // 3 of axis u % 3).
    rows:  int64 [32 * n_blocks]: the row of the first sigma matrix that
           column 8 * segment + e multiplies, -1 for padding. A frequency
           value's hi and lo columns name the same row.
    index: int64 [w_elems]: wfwd = wbuf-and-eight-zeros[index]; the matrices
           w0 [32 n_blocks, 64] | w1 [64, 16] | wc0 [32, 64] | wc1 [64, 64] |
           wc2 [64, 16], input-major, zero-padded, each in fragment order
           (_frag_index). Column 32 b + 8 t + e of the layout sits at row
           32 b + 16 (e // 4) + 2 t + e % 2 + 8 (e // 2 % 2) of w0, where
           the mma's A fragment of thread t holds it. wc0's rows: SH
           component 4 t + c at row 2 t + c % 2 + 8 (c // 2), then a zero
           row for the density logit and the 15 geo rows.
    w_off: element offsets of the five matrices in wfwd.
    """
    segs: tuple
    rows: np.ndarray
    index: np.ndarray
    w_off: tuple

    @property
    def n_blocks(self):
        return len(self.segs) // 4

    def meta(self, scale_meta, plane_meta):
        """The tail of FieldTables.meta: n_blocks, w_elems, w_off[5], the
        kind of each block, then per segment kind, sub, res, stride and the
        element offsets of the rows it reads in `tab`."""
        out = [self.n_blocks, int(self.index.size)] + list(self.w_off)
        # a block's kind: that of its segments that are not padding (0)
        out += [max(sg[0] for sg in self.segs[4 * b:4 * b + 4])
                for b in range(self.n_blocks)]
        for kind, sub, s, first in self.segs:
            if kind == SEG_LINE:
                res, rank, *offs = scale_meta[5 * s:5 * s + 5]
                out += [kind, sub, res, rank] + [o + first for o in offs]
            elif kind == SEG_PLANE:
                pres, ch = plane_meta[8 * s:8 * s + 2]
                out += [kind, sub, pres, ch,
                        plane_meta[8 * s + 2 + sub] + first,
                        plane_meta[8 * s + 5 + sub] + first, 0]
            else:
                out += [kind, sub, 0, 0, 0, 0, 0]
        return out


@functools.lru_cache(maxsize=16)
def tile_layout(cfg: CPConfig):
    """TileLayout of `cfg`, or None for a config the forward kernels do not
    take: other towers than _KERNEL_TOWERS, a rank or a channel count that
    is not a multiple of 8 (a segment is eight columns, read with one
    16-byte load), or more than 16 k-blocks."""
    if any(getattr(cfg, k) != v for k, v in _KERNEL_TOWERS.items()):
        return None
    if any(r % 8 for _, r in cfg.scales) or any(c % 8 for _, c in cfg.planes):
        return None
    segs, rows = [], []

    def pad_block():
        while len(segs) % 4:
            segs.append((SEG_ZERO, 0, 0, 0))
            rows.extend([-1] * 8)

    row = 0
    for s, (_, rank) in enumerate(cfg.scales):
        for r0 in range(0, rank, 8):
            segs.append((SEG_LINE, s, s, r0))
            rows.extend(range(row + r0, row + r0 + 8))
        row += rank
    pad_block()
    for s, (_, ch) in enumerate(cfg.planes):
        for p in range(3):
            for c0 in range(0, ch, 8):
                segs.append((SEG_PLANE, p, s, c0))
                rows.extend(range(row + c0, row + c0 + 8))
            row += ch
    pad_block()
    # frequency rows of w0: x y z, then per degree 3 sin rows and 3 cos rows
    segs.append((SEG_FREQ, 0, 0, 0))
    rows.extend([row, row, row + 1, row + 1, row + 2, row + 2, -1, -1])
    pairs = 3 * cfg.freq_degree
    for q in range(1, 1 + (pairs + 1) // 2):
        segs.append((SEG_FREQ, q, 0, 0))
        for u in (2 * q - 2, 2 * q - 1):
            if u < pairs:
                sin = row + 3 + 6 * (u // 3) + u % 3
                rows.extend([sin, sin, sin + 3, sin + 3])
            else:
                rows.extend([-1] * 4)
    pad_block()
    n_blocks = len(segs) // 4
    if n_blocks > _MAX_BLOCKS:
        return None
    rows = np.asarray(rows, dtype=np.int64)

    # element indices into wbuf (see pack_tables); `zero`: the pad behind it
    hid, sig_out, c_in = 64, 16, 31
    sizes = [cfg.feat_dim * hid, sig_out * hid, c_in * hid, hid * hid,
             hid * 3]
    off = np.concatenate([[0], np.cumsum(sizes)])
    zero = int(off[5] + (-off[5]) % 8)
    n64 = np.arange(hid)[None, :]
    # w0: layout column -> the A fragment's column of its k-block
    col = np.arange(32 * n_blocks)
    b, t, e = col // 32, col % 32 // 8, col % 8
    kpos = 32 * b + 16 * (e // 4) + 2 * t + e % 2 + 8 * (e // 2 % 2)
    i0 = np.full((32 * n_blocks, hid), zero, dtype=np.int64)
    i0[kpos] = np.where(rows[:, None] >= 0, off[0] + rows[:, None] * hid + n64,
                        zero)
    # w1 [64, 16] from w1^T [16, 64]
    i1 = off[1] + np.arange(sig_out)[None, :] * hid + np.arange(hid)[:, None]
    # wc0 [32, 64]: SH rows in the threads' order, a zero row, the geo rows
    ic0 = np.full((32, hid), zero, dtype=np.int64)
    for tq in range(4):
        for c in range(4):
            ic0[2 * tq + c % 2 + 8 * (c // 2)] = off[2] + (4 * tq + c) * hid \
                + n64[0]
    ic0[17:32] = off[2] + (16 + np.arange(15))[:, None] * hid + n64
    # wc1 [64, 64] from wc1^T
    ic1 = off[3] + n64 * hid + np.arange(hid)[:, None]
    # wc2 [64, 16] from [64, 3]
    ic2 = np.full((hid, 16), zero, dtype=np.int64)
    ic2[:, :3] = off[4] + np.arange(hid)[:, None] * 3 + np.arange(3)[None, :]
    mats = [_frag_index(i) for i in (i0, i1, ic0, ic1, ic2)]
    w_off = np.concatenate([[0], np.cumsum([m.size for m in mats])])[:5]
    return TileLayout(segs=tuple(segs), rows=rows,
                      index=np.concatenate(mats),
                      w_off=tuple(int(o) for o in w_off))


@functools.lru_cache(maxsize=16)
def _device_index(layout: TileLayout, device: str):
    return torch.from_numpy(layout.index).to(device)


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
    # eight more zeros behind wbuf: the padding that wfwd gathers
    flat = torch.cat(parts + [tab.new_zeros(pad + 8)])
    wbuf = flat[:n + pad]
    w_off += [0] * (5 - len(w_off))
    meta = [len(cfg.scales), len(cfg.planes), cfg.freq_degree, cfg.feat_dim,
            n + pad] + w_off + scale_meta + plane_meta
    layout = tile_layout(cfg)
    if layout is None:
        wfwd = tab.new_zeros(0)
        meta += [0] * 7
    else:
        wfwd = flat[_device_index(layout, str(tab.device))]
        meta += layout.meta(scale_meta, plane_meta)
    tables = FieldTables(plain=plain, tab=tab, wbuf=wbuf, meta=meta,
                         wfwd=wfwd)
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
    tables.wdef = tables.wdef_in = tables.tab.new_zeros(0)
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
    tables.wdef_in = torch.cat([w.reshape(-1) for w in wb[1:-1]]) \
        if len(wb) > 2 else tables.wdef.new_zeros(8)
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
    bad = [r for _, r in cfg.scales if r % 8] \
        + [c for _, c in cfg.planes if c % 8]
    if bad:
        raise NotImplementedError(
            "the field kernel reads eight ranks or channels of a table row "
            f"with one 16-byte load: got {bad}, not multiples of 8")
    if tile_layout(cfg) is None:
        raise NotImplementedError(
            f"the field kernel takes at most {32 * _MAX_BLOCKS} padded "
            "feature columns")


def _check_packed(tables: FieldTables, device, deform=()):
    """Raise unless the packed buffers are bf16 on `device` and every table
    row that the forward kernels read starts 16-byte aligned."""
    for name, t in (("tables", tables.tab), ("weights", tables.wfwd)) \
            + tuple(deform):
        if t.device != device or t.dtype != torch.bfloat16:
            raise ValueError(f"packed {name} must be bf16 on {device}, "
                             f"got {t.dtype} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"packed {name} must be 16-byte aligned")
    for off in table_row_offsets(tables.meta):
        if off % 8:
            raise ValueError(f"a table starts at element {off} of the "
                             "packed buffer, not a multiple of 8")


def table_row_offsets(meta):
    """The element offsets in `tab` of every table that FieldTables.meta
    lists (three per line scale, six per plane scale). With ranks and
    channel counts that are multiples of 8, every row of a table starts
    16-byte aligned when these are multiples of 8 too."""
    out, q = [], 10
    for _ in range(meta[0]):
        out += meta[q + 2:q + 5]
        q += 5
    for _ in range(meta[1]):
        out += meta[q + 2:q + 8]
        q += 8
    return out


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
            density_only, feats=None):
    from .build import load_library
    _check_kernel_cfg(cfg)
    _check_packed(tables, x3.device)
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
        tables.tab.data_ptr(), tables.wfwd.data_ptr(), meta,
        float(cfg.bound), mask, int(bool(density_only)), out.data_ptr(),
        None if feats is None else feats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"field kernel launch failed: CUDA error {rc}")
    field_forward.launches += 1
    return out


def _feature_buffer(cfg: CPConfig, x3, parts):
    """The zeroed buffer that a forward kernel fills with the first sigma
    product's A operand, bf16 [M, 32 * n_blocks] in segment order (see
    TileLayout), or None when the caller asked for no parts."""
    if parts is None:
        return None
    _check_kernel_cfg(cfg)
    parts["features"] = torch.zeros(
        (x3.shape[1], 32 * tile_layout(cfg).n_blocks), dtype=torch.bfloat16,
        device=x3.device)
    return parts["features"]


def tile_features_plain(tables: FieldTables, cfg: CPConfig, x):
    """What `parts["features"]` of the forward kernels holds, by the plain
    version: (grid, freq), grid [S, grid_feat_dim] the bf16-rounded line and
    plane features at positions x [S, 3] and freq [S, 3 + 6 * freq_degree]
    the f32 frequency encoding, both in the first sigma matrix's row order,
    and cols, an int64 [feat_dim, 2] tensor: the buffer's column(s) that
    hold each row (a grid row one column, twice; a frequency row its hi and
    its lo column)."""
    feat = cp_features(tables.plain, cfg, x)
    g = cfg.grid_feat_dim
    rows = tile_layout(cfg).rows
    cols = np.zeros((cfg.feat_dim, 2), dtype=np.int64)
    for r in range(cfg.feat_dim):
        at = np.nonzero(rows == r)[0]
        cols[r] = at[0], at[-1]
    return bf16_round(feat[:, :g]), feat[:, g:], torch.from_numpy(cols)


def field_forward(params, cfg: CPConfig, x3, d3, lod_skip=(),
                  density_only=False, parts=None):
    """Field forward on planar samples.

    Args:
      params: params dict or FieldTables (see pack_tables).
      x3, d3: [3, M] f32 contiguous positions and unit directions on one
        device. d3 may be None when density_only.
      lod_skip: line-scale indices whose features are treated as zero.
      density_only: compute sigma only; rows 1-3 of the output are zero.
      parts: an optional dict that receives "features", the kernel's input
        to the first sigma product (CUDA only; see _feature_buffer), for
        holding it against tile_features_plain.

    Returns out [4, M] f32, rows (sigma, r, g, b).
    """
    tables = params if isinstance(params, FieldTables) \
        else pack_tables(params, cfg)
    _check_samples(x3, d3, density_only)
    if x3.device.type == "cpu":
        if parts is not None:
            raise ValueError("parts holds the kernel's features: on the CPU "
                             "call tile_features_plain instead")
        return field_forward_plain(tables, cfg, x3, d3, lod_skip,
                                   density_only)
    if x3.device.type != "cuda":
        raise ValueError(f"unsupported device {x3.device}")
    return _launch(tables, cfg, x3, d3, lod_skip, density_only,
                   _feature_buffer(cfg, x3, parts))


field_forward.launches = 0


# ------------------------------------------------------------------ dynamic
def _time_cond(tables: FieldTables, cfg: CPDNeRFConfig, t, device):
    """The frame's conditioning: the first deform layer's time bias
    W0[nx:]^T freq(t) [hidden] and the flag t != 0 [1], both f32 on
    `device`, computed there from a float or from a tensor that holds t."""
    tb, flag, _ = _time_cond_vec(tables, cfg, t, device)
    return tb, flag


def _time_cond_vec(tables: FieldTables, cfg: CPDNeRFConfig, t, device):
    """_time_cond plus freq(t) itself [time inputs], which the backward's
    time rows need."""
    t = torch.as_tensor(t, dtype=torch.float32, device=device).reshape(1, 1)
    tvec = freq_encode(t, degree=cfg.multires_time)[0]
    return tvec @ tables.w0_time, (t != 0.0).float().reshape(1), tvec


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
                density_only, feats=None):
    from .build import load_library
    _check_kernel_cfg(cfg)
    if not tables.dmeta:
        raise NotImplementedError(
            f"the dynamic field kernel is built for hidden_dim_deform="
            f"{_DEFORM_HID}, 2..{_DEFORM_MAX_LAYERS} deform layers and at "
            f"most {_DEFORM_HID} spatial inputs, got hidden "
            f"{cfg.hidden_dim_deform}, {cfg.num_layers_deform} layers, "
            f"{cfg.deform_space_dim} inputs")
    _check_packed(tables, x3.device, (("deform weights", tables.wdef),))
    m = x3.shape[1]
    out = torch.empty((4, m), dtype=torch.float32, device=x3.device)
    if m == 0:
        return out
    tcond = torch.cat(_time_cond(tables, cfg, t, x3.device)).contiguous()
    xw = torch.empty_like(x3)       # scratch: the warped positions
    lib = load_library()
    meta = (ctypes.c_longlong * len(tables.meta))(*tables.meta)
    dmeta = (ctypes.c_longlong * len(tables.dmeta))(*tables.dmeta)
    mask = 0
    for s in lod_skip:
        mask |= 1 << int(s)
    stream = torch.cuda.current_stream(x3.device).cuda_stream
    rc = lib.sdn_dyn_field_fwd(
        x3.data_ptr(), (x3 if d3 is None else d3).data_ptr(), m,
        tables.tab.data_ptr(), tables.wfwd.data_ptr(), meta,
        float(cfg.bound), tables.wdef.data_ptr(), dmeta, tcond.data_ptr(),
        mask, int(bool(density_only)), xw.data_ptr(), out.data_ptr(),
        None if feats is None else feats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            f"dynamic field kernel launch failed: CUDA error {rc}")
    dyn_field_forward.launches += 1
    return out


def dyn_field_forward(params, cfg: CPDNeRFConfig, x3, d3, t, lod_skip=(),
                      density_only=False, parts=None):
    """Time-conditioned field forward on planar samples (render path, no
    gradient).

    Args:
      params: params dict or FieldTables (see pack_tables) of a field with
        a deform tower.
      x3, d3: [3, M] f32 contiguous positions and unit directions on one
        device. d3 may be None when density_only.
      t: the frame's time, a float or a tensor holding one value; a tensor
        on x3's device is read there, without a host round trip.
      lod_skip, density_only, parts: as field_forward; the features are
        those at the warped positions.

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
        if parts is not None:
            raise ValueError("parts holds the kernel's features: on the CPU "
                             "call tile_features_plain instead")
        return dyn_field_forward_plain(tables, cfg, x3, d3, t, lod_skip,
                                       density_only)
    if x3.device.type != "cuda":
        raise ValueError(f"unsupported device {x3.device}")
    return _launch_dyn(tables, cfg, x3, d3, t, lod_skip, density_only,
                       _feature_buffer(cfg, x3, parts))


dyn_field_forward.launches = 0


# ------------------------------------------------------------------ backward
def _check_backward_inputs(x3, d3, g_out):
    for name, t, rows in (("x3", x3, 3), ("d3", d3, 3), ("g_out", g_out, 4)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != rows \
                or t.shape[1] != x3.shape[1]:
            raise ValueError(f"{name} must be f32 [{rows}, M], got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x3.device:
            raise ValueError("x3, d3 and g_out must be on one device")


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


def _bwd_chunk(tp, cfg: CPConfig, x, d, g_out, grads, grad_x_cutoff=None):
    """Recompute the forward on x, d [S, 3] and add the param grads of the
    cotangent g_out [4, S] into `grads`. With grad_x_cutoff also returns
    g_x [S, 3] = d(loss)/dx through the line scales and planes with
    res <= grad_x_cutoff (the hat taps' slopes times (res - 1) / (2 bound),
    zero outside |x| < bound) and through the frequency features."""
    x01 = (x + cfg.bound) / (2.0 * cfg.bound)
    want_gx = grad_x_cutoff is not None
    if want_gx:
        g_x = torch.zeros_like(x)
        inb = (x.abs() < cfg.bound).float()
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
    for s, (res, rank) in enumerate(cfg.scales):
        taps, f = lines[s]
        g_prod = g_grid[:, row:row + rank]
        for a in range(3):
            g_fr = g_prod * (f[(a + 1) % 3] * f[(a + 2) % 3])
            g_f = bf16_round(g_fr)
            i0, u0, u1 = taps[a]
            gt = grads["lines"][s][a]
            gt.index_add_(0, i0, g_f * u0[:, None])
            gt.index_add_(0, i0 + 1, g_f * u1[:, None])
            if want_gx and res <= grad_x_cutoff:
                d0, d1 = hat_slopes(x01[:, a], res, i0)
                dfa = _lerp(tp["lines"][s][a].float(), i0, d0, d1)
                g_x[:, a] += (g_fr * dfa).sum(-1) \
                    * ((res - 1.0) / (2.0 * cfg.bound)) * inb[:, a]
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
            g_qs = []
            for jb, ub in ((ib, ub0), (ib + 1, ub1)):
                g_q = bf16_round(g_f * ub[:, None])
                g_qs.append(g_q)
                gp.index_add_(0, ia * pres + jb, g_q * ua0[:, None])
                gp.index_add_(0, (ia + 1) * pres + jb, g_q * ua1[:, None])
            if want_gx and pres <= grad_x_cutoff:
                # cotangents of the two hat taps of each of the pair's axes
                a, b, e = VM_PAIRS[p]
                pl = tp["planes"][s][p].float()
                vl = tp["vm_lines"][s][p].float()
                g_ua = [(pl[ia + k, ib] * g_qs[0]
                         + pl[ia + k, ib + 1] * g_qs[1]).sum(-1)
                        for k in (0, 1)]
                q = [ua0[:, None] * pl[ia, ib + k]
                     + ua1[:, None] * pl[ia + 1, ib + k] for k in (0, 1)]
                g_ub = [(g_f * q[k]).sum(-1) for k in (0, 1)]
                g_ue = [(vl[ie + k] * g_l).sum(-1) for k in (0, 1)]
                sc = (pres - 1.0) / (2.0 * cfg.bound)
                for ax, i_ax, gv in ((a, ia, g_ua), (b, ib, g_ub),
                                     (e, ie, g_ue)):
                    d0, d1 = hat_slopes(x01[:, ax], pres, i_ax)
                    g_x[:, ax] += (gv[0] * d0 + gv[1] * d1) * sc * inb[:, ax]
    if want_gx:
        gp = g_h0b @ w0[n_grid:].t()                 # [S, 3 + 6 * freq_degree]
        g_x += gp[:, :3]
        for fd in range(cfg.freq_degree):
            k = 3 + 6 * fd
            g_x += (2.0 ** fd) * (gp[:, k:k + 3] * freq[:, k + 3:k + 6]
                                  - gp[:, k + 3:k + 6] * freq[:, k:k + 3])
        return g_x
    return None


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
    _check_backward_inputs(x3, d3, g_out)
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


# --------------------------------------------------------- dynamic backward
def dyn_warp_plain(tables: FieldTables, cfg: CPDNeRFConfig, x3, t):
    """First stage of K4's plain version: the deform tower's forward with
    every activation kept. Returns (xw [3, M] = x + dx, acts): acts[0] is
    bf16(freq(x)) [M, spatial inputs] and acts[l] the relu'd, bf16-rounded
    output [M, hidden] of matrix l - 1, all held in f32. At t == 0 the flag
    gates dx off."""
    wd = [w.float() for w in tables.plain["deform_mlp"]["w"]]
    tb, flag, _ = _time_cond_vec(tables, cfg, t, x3.device)
    with torch.no_grad():
        acts = [bf16_round(freq_encode(x3.t(), degree=cfg.multires_deform))]
        h = acts[0] @ wd[0][:cfg.deform_space_dim] + tb
        for w in wd[1:]:
            acts.append(bf16_round(torch.relu(h)))
            h = acts[-1] @ w
        xw = x3 + torch.where(flag != 0.0, h, torch.zeros_like(h)).t()
    return xw.contiguous(), acts


def dyn_canonical_backward_plain(tables: FieldTables, cfg: CPDNeRFConfig, xw3,
                                 d3, t, g_out, chunk: int = 1 << 16):
    """Second stage: the canonical backward at the warped positions xw3
    [3, M], in chunks of `chunk` samples (_bwd_chunk). Returns (grads of the
    tables and the canonical towers, g_x [3, M]), g_x being the position
    gradient that enters the tower's backward: 0 at t == 0."""
    grads = _zero_grads(tables.plain, xw3.device)
    flag = _time_cond_vec(tables, cfg, t, xw3.device)[1]
    g_x = torch.zeros_like(xw3)
    xw, d = xw3.t(), d3.t()
    with torch.no_grad():
        for i in range(0, xw3.shape[1], chunk):
            g_x[:, i:i + chunk] = (_bwd_chunk(
                tables.plain, cfg, xw[i:i + chunk], d[i:i + chunk],
                g_out[:, i:i + chunk], grads,
                grad_x_cutoff=cfg.deform_grad_res_cutoff) * flag).t()
    return grads, g_x


def dyn_tower_backward_plain(tables: FieldTables, cfg: CPDNeRFConfig, t, acts,
                             g_x):
    """Third stage: back through the tower from g_x [3, M] over the kept
    activations (see dyn_warp_plain): g_W[l] = acts[l]^T bf16(g_h) and
    g_h = (bf16(g_h) W[l]^T) * (acts[l] > 0), f32 sums. The first matrix's
    time rows are bf16(freq(t)) (x) bf16(sum of g_h over all samples).
    Returns the deform tower's grads {"w": [...]}."""
    wd = [w.float() for w in tables.plain["deform_mlp"]["w"]]
    tvec = _time_cond_vec(tables, cfg, t, g_x.device)[2]
    gd = [None] * len(wd)
    with torch.no_grad():
        g_h = g_x.t()
        for li in range(len(wd) - 1, 0, -1):
            gb = bf16_round(g_h)
            gd[li] = acts[li].t() @ gb
            g_h = (gb @ wd[li].t()) * (acts[li] > 0)
        gd[0] = torch.cat([
            acts[0].t() @ bf16_round(g_h),
            bf16_round(tvec)[:, None] * bf16_round(g_h.sum(dim=0))[None, :]])
    return {"w": gd}


def dyn_field_backward_plain(tables: FieldTables, cfg: CPDNeRFConfig, x3, d3,
                             t, g_out, chunk: int = 1 << 16):
    """Plain PyTorch version of K4: the explicit chain with the kernel's
    rounding points, in the kernel's three stages (dyn_warp_plain,
    dyn_canonical_backward_plain, dyn_tower_backward_plain). At t == 0 the
    flag zeroes g_x before the tower, so every deform gradient is exactly
    0."""
    xw, acts = dyn_warp_plain(tables, cfg, x3, t)
    grads, g_x = dyn_canonical_backward_plain(tables, cfg, xw, d3, t, g_out,
                                              chunk)
    grads["deform_mlp"] = dyn_tower_backward_plain(tables, cfg, t, acts, g_x)
    return grads


def _unpack_deform_grads(tables: FieldTables, cfg: CPDNeRFConfig, g_wdef,
                         g_wtime):
    """The kernel's deform-gradient buffers (g_wdef laid out like
    tables.wdef, g_wtime [time inputs, hidden]) in the params' layouts."""
    n_layers, hid, nx, in_pad = tables.dmeta[:4]
    offs = tables.dmeta[5:]
    first = g_wdef[offs[0]:offs[0] + hid * in_pad].view(hid, in_pad)
    out = [torch.cat([first[:, :nx].t(), g_wtime], dim=0)]
    for l in range(1, n_layers - 1):
        out.append(g_wdef[offs[l]:offs[l] + hid * hid].view(hid, hid).t())
    last = g_wdef[offs[-1]:offs[-1] + _DEFORM_LAST_ROWS * hid]
    out.append(last.view(_DEFORM_LAST_ROWS, hid)[:3].t())
    return {"w": out}


def _launch_dyn_bwd(tables: FieldTables, cfg: CPDNeRFConfig, x3, d3, t,
                    g_out, parts=None):
    from .build import load_library
    _check_kernel_cfg(cfg)
    if not tables.dmeta:
        raise NotImplementedError(
            f"the dynamic field kernels are built for hidden_dim_deform="
            f"{_DEFORM_HID}, 2..{_DEFORM_MAX_LAYERS} deform layers and at "
            f"most {_DEFORM_HID} spatial inputs, got hidden "
            f"{cfg.hidden_dim_deform}, {cfg.num_layers_deform} layers, "
            f"{cfg.deform_space_dim} inputs")
    for name, buf in (("tables", tables.tab), ("weights", tables.wbuf),
                      ("deform weights", tables.wdef),
                      ("deform weights", tables.wdef_in)):
        if buf.device != x3.device or buf.dtype != torch.bfloat16:
            raise ValueError(f"packed {name} must be bf16 on {x3.device}, "
                             f"got {buf.dtype} on {buf.device}")
    m, dev = x3.shape[1], x3.device
    f32 = dict(dtype=torch.float32, device=dev)
    tdim = tables.w0_time.shape[0]
    # zeroed on the launch stream: the kernel only adds into them
    g_tab = torch.zeros(tables.tab.numel(), **f32)
    g_w = torch.zeros(tables.wbuf.numel(), **f32)
    g_wdef = torch.zeros(tables.wdef.numel(), **f32)
    g_tsum = torch.zeros(_DEFORM_HID, **f32)
    g_wtime = torch.zeros((tdim, _DEFORM_HID), **f32)
    if m > 0:
        count = torch.zeros(1, dtype=torch.int32, device=dev)
        xw = torch.empty((3, m), **f32)
        gx = torch.empty((3, m), **f32)
        idx = torch.empty(m, dtype=torch.int32, device=dev)
        tcond = torch.cat(_time_cond_vec(tables, cfg, t, dev)).contiguous()
        n_layers = tables.dmeta[0]
        acts = None if parts is None else torch.zeros(
            (n_layers, m, _DEFORM_HID), dtype=torch.bfloat16, device=dev)
        lib = load_library()
        meta = (ctypes.c_longlong * len(tables.meta))(*tables.meta)
        dmeta = (ctypes.c_longlong * len(tables.dmeta))(*tables.dmeta)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdn_dyn_field_bwd(
            x3.data_ptr(), d3.data_ptr(), g_out.data_ptr(), m,
            tables.tab.data_ptr(), tables.wbuf.data_ptr(), meta,
            float(cfg.bound), tables.wdef.data_ptr(),
            tables.wdef_in.data_ptr(), dmeta, tcond.data_ptr(), tdim,
            int(cfg.deform_grad_res_cutoff), xw.data_ptr(), count.data_ptr(),
            idx.data_ptr(), gx.data_ptr(), g_tab.data_ptr(), g_w.data_ptr(),
            g_wdef.data_ptr(), g_tsum.data_ptr(), g_wtime.data_ptr(),
            None if acts is None else acts.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(
                f"dynamic field backward kernel launch failed: CUDA error "
                f"{rc}")
        dyn_field_backward.launches += 1
        if parts is not None:
            # the compact list back in sample order (reading its length
            # waits for the kernel)
            live = idx[:int(count)].long()
            g_x = torch.zeros((3, m), **f32)
            g_x[:, live] = gx[:, :live.numel()]
            nx = cfg.deform_space_dim
            parts.update(xw=xw, g_x=g_x, live=live, acts=[
                a[:live.numel(), :nx if l == 0 else None]
                for l, a in enumerate(acts)])
    grads = _unpack_grads(tables, cfg, g_tab, g_w)
    grads["deform_mlp"] = _unpack_deform_grads(tables, cfg, g_wdef, g_wtime)
    return grads


def dyn_field_backward(tables, cfg: CPDNeRFConfig, x3, d3, t, g_out,
                       parts=None):
    """Param gradients of the time-conditioned field at planar samples.

    Args:
      tables: params dict or FieldTables (see pack_tables) of a field with
        a deform tower.
      x3, d3: [3, M] f32 contiguous positions and unit directions.
      t: the frame's time, a float or a tensor holding one value; a tensor
        on x3's device is read there, without a host round trip.
      g_out: [4, M] f32 contiguous cotangent of dyn_field_forward's output
        (rows sigma, r, g, b).
      parts: an optional dict that receives the stages between the kernel's
        phases (CUDA only), for holding them against the plain version's
        stages one by one: "xw" [3, M], the warped positions; "g_x" [3, M],
        the position gradient that entered the tower's backward (0 where
        the cotangent is all zero); "live" [L], the samples that carry a
        cotangent, in the order the tower's backward walked them; "acts",
        the activations it recomputed for them, bf16, laid out as
        dyn_warp_plain's ([L, spatial inputs], then [L, hidden] a matrix).
        Filling it waits for the kernel.

    Returns an f32 dict in the params' names and layouts, "deform_mlp"
    included. The warp's gradient reaches the tower only through the line
    scales and planes with res <= cfg.deform_grad_res_cutoff and through
    the frequency features. At t == 0 every deform gradient is exactly 0.
    Samples whose four cotangents are zero add nothing.
    """
    if not isinstance(cfg, CPDNeRFConfig):
        raise TypeError("dyn_field_backward needs a CPDNeRFConfig")
    tables = tables if isinstance(tables, FieldTables) \
        else pack_tables(tables, cfg)
    if tables.w0_time is None:
        raise ValueError("the tables hold no deform tower")
    _check_backward_inputs(x3, d3, g_out)
    if x3.device.type == "cpu":
        if parts is not None:
            raise ValueError("parts holds the kernel's stages: on the CPU "
                             "call the plain version's stages instead")
        return dyn_field_backward_plain(tables, cfg, x3, d3, t, g_out)
    if x3.device.type != "cuda":
        raise ValueError(f"unsupported device {x3.device}")
    return _launch_dyn_bwd(tables, cfg, x3, d3, t, g_out, parts)


dyn_field_backward.launches = 0


class DynFieldTrainFn(torch.autograd.Function):
    """Dynamic field forward (K3) whose backward is K4, the port of the
    reference's custom VJP `cp_dnerf_train_fused`. Inputs: the packed tables
    of the current param values, the config, whether to run the plain
    versions instead of the kernels (for comparisons on the card), x3, d3,
    the time t (a float or a one-element tensor, which stays on its device)
    and the f32 param leaves in `param_leaves` order. A leaf may be a
    function of a trained tensor (the annealed first sigma matrix): autograd
    carries its gradient on. Positions, directions and t get no gradient, as
    in the reference."""

    @staticmethod
    def forward(ctx, tables, cfg, plain, x3, d3, t, *leaves):
        ctx.tables, ctx.cfg, ctx.plain, ctx.t = tables, cfg, plain, t
        ctx.save_for_backward(x3, d3)
        if plain:
            return dyn_field_forward_plain(tables, cfg, x3, d3, t)
        return dyn_field_forward(tables, cfg, x3, d3, t)

    @staticmethod
    def backward(ctx, g_out):
        x3, d3 = ctx.saved_tensors
        bwd = dyn_field_backward_plain if ctx.plain else dyn_field_backward
        grads = bwd(ctx.tables, ctx.cfg, x3, d3, ctx.t, g_out.contiguous())
        return (None,) * 6 + tuple(param_leaves(grads))


def dyn_field_train_forward(params, cfg: CPDNeRFConfig, x3, d3, t,
                            tables=None, plain: bool = False):
    """Differentiable dynamic field forward: out [4, M] (rows sigma, r, g,
    b) at time t. `tables` must be packed from the current values of
    `params`; None packs them here. plain=True runs the plain versions on
    any device (no kernel launch)."""
    if tables is None:
        tables = pack_tables(params, cfg)
    return DynFieldTrainFn.apply(tables, cfg, plain, x3, d3, t,
                                 *param_leaves(params))
