"""Fused CP/VM field: the wrappers of the Hopper kernels
ops/csrc/field_fwd.cu (K1, port of the Pallas `_field_kernel`),
ops/csrc/field_bwd.cu (K2, port of `_field_bwd_kernel`),
ops/csrc/dyn_field_fwd.cu (K3, port of `_dyn_field_kernel`) and
ops/csrc/dyn_field_bwd.cu (K4, port of `_dyn_field_bwd_kernel`), their plain
PyTorch versions, and the autograd ops that join K1 with K2 and K3 with K4;
and of ops/csrc/hash_field_fwd.cu (K5, the Instant-NGP hash-grid field's
forward on K1's tiles, which no TPU kernel had), with its plain version.

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
    hash_field_forward(params, cfg: NGPConfig, x3, d3) -> out [4, M]
    (no gradient: the render path and the grid's refresh)

`params` is either a params dict or the `FieldTables` that `pack_tables`
builds from one: the bf16 tables and tower weights in the kernels' layouts
(the kernels compute 16 samples a warp on the tensor cores and take the
matrices, and for the backward their transposes, padded and in mma fragment
order: TileLayout).
Packing costs a pass over ~1.5 MB of parameters, so callers that evaluate
the field repeatedly pack once per parameter version (CPField.kernel_tables).

Device dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes
to the kernel, and a failed build or launch raises. Each call opens the span
"sdn.k1" (field_forward), "sdn.k2" (field_backward), "sdn.k3"
(dyn_field_forward), "sdn.k4" (dyn_field_backward) or "sdn.k5"
(hash_field_forward) while a profiler session records, and adds its samples
to the counter "k<n>.samples" (and a density-only K5 call to
"k5.density_samples" too); a call that reached the kernel adds one to
"k<n>.calls" (utils/profiling.py: read them with
`profiling.tally(traced=False)["counters"]`).

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
from ..models.ngp import NGPConfig, color_tower as ngp_color, ngp_density
from ..utils import profiling
from .freq_encode import freq_encode
from .grid_encode import HASH, GridEncodeConfig
from .hat import bf16_round, hat_slopes, hat_taps
from .sh_encode import sh_encode

_KERNEL_TOWERS = dict(num_layers=2, num_layers_color=3, hidden_dim=64,
                      hidden_dim_color=64, geo_feat_dim=15, sh_degree=4)
# the dynamic kernels' deform tower: hidden width, rows of the padded last
# matrix (one k-step of the backward's transposed product), most matrices;
# samples of one tile of its scratch (csrc/deform_tower.cuh: kTile)
_DEFORM_HID, _DEFORM_LAST_ROWS, _DEFORM_MAX_LAYERS = 128, 16, 16
_DEFORM_TILE = 64
# the most device memory that K4's tower scratch (both images) may take; the
# kernel walks the listed samples in passes of as many tiles as fit
_TOWER_SCRATCH_BYTES = 1 << 29
# a block's shared memory on sm_90, and the backward body's spin locks in it
# (csrc/field_bwd_body.cuh: kMaxSmem, kMaxLocks)
_SMEM_PER_BLOCK, _BWD_LOCK_BYTES = 232448, 4 * 46


@dataclass
class FieldTables:
    """bf16 operands of the field for one parameter version.

    plain: params-like dict of bf16 tensors in the reference layouts.
    tab:   flat bf16 buffer of all line, plane and VM-line tables, each row
           padded with zero columns to a multiple of 8 (one 16-byte load
           reads eight ranks or channels; a kernel's table gradients come
           in the same layout).
    wfwd:  flat bf16 buffer of the five tower matrices for the kernels:
           padded, the first one's rows in the order of the kernels' feature
           segments, each in mma fragment order (see TileLayout). Empty when
           the config is not one the kernels take.
    wbwd:  the same matrices' transposes for the backward kernels' chain,
           in fragment order too (TileLayout.bwd_index).
    meta:  int64 layout description read by the kernels' C entry points:
           the tables and the weight-gradient buffer, the kernels' tile
           layout, then the offsets into wbwd.
    Of an Instant-NGP field (pack_hash_tables, K5): plain {"grid",
    "sigma_mlp", "color_mlp"} in bf16, tab the bf16 table [rows, 2] itself,
    wfwd as above, meta K5's (hash_tile_layout); wbwd None.
    Of a time-conditioned field also (plain then has "deform_mlp" too):
    w0_time: f32 [time inputs, hidden], the first deform matrix's time rows.
    wdef:  flat bf16 buffer of the deform matrices as the shared-memory
           images the kernels' wgmma products read (see sw128_positions):
           each output-major (W^T), first [hidden, in_pad rounded up to 64]
           (spatial rows only, zero-padded), hidden [hidden, hidden], last
           [16, hidden] (rows 3..15 zero). The forward reads them K-major,
           the backward's chain the same bytes transposed. Empty when the
           tower is not one the kernels take.
    dmeta: int64 n_layers, hidden, in_dim, in_pad (in_dim padded to a
           multiple of 16: the first matrix's k-steps), multires_deform, then
           the element offset of each matrix image in wdef.
    ex_cols: int64 [in_dim] on wdef's device, deform_ex_columns: the column
           of the first image (and of the backward's ex tiles) that holds
           each spatial input.
    """
    plain: dict
    tab: torch.Tensor
    meta: list
    wfwd: torch.Tensor = None
    wbwd: torch.Tensor = None
    w0_time: torch.Tensor = None
    wdef: torch.Tensor = None
    ex_cols: torch.Tensor = None
    dmeta: list = field(default_factory=list)


# segment kinds of the forward kernels' tile layout (csrc/field_fwd_body.cuh)
SEG_ZERO, SEG_LINE, SEG_PLANE, SEG_FREQ, SEG_HASH = 0, 1, 2, 3, 4
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
    """How the kernels see the field's features and matrices.

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
    index: int64 [w_elems]: wfwd = flat[index], flat being the five
           matrices w0 [feat, 64] | w1^T [16, 64] | wc0 [31, 64] | wc1^T
           [64, 64] | wc2 [64, 3] one after the other and then zeros; the
           matrices
           w0 [32 n_blocks, 64] | w1 [64, 16] | wc0 [32, 64] | wc1 [64, 64] |
           wc2 [64, 16], input-major, zero-padded, each in fragment order
           (_frag_index). Column 32 b + 8 t + e of the layout sits at row
           32 b + 16 (e // 4) + 2 t + e % 2 + 8 (e // 2 % 2) of w0, where
           the mma's A fragment of thread t holds it. wc0's rows: SH
           component 4 t + c at row 2 t + c % 2 + 8 (c // 2), then a zero
           row for the density logit and the 15 geo rows.
    w_off: element offsets of the five matrices in wfwd.
    bwd_index, bwd_off: the same for wbwd = flat[bwd_index], the B operands
           of the backward's chain, each [k, n] in fragment order: w0^T
           [64, 32 n_blocks], whose column 32 b + 8 i + 2 t + e is segment
           column 32 b + 8 t + 2 i + e (so that the C fragment of thread t
           holds the cotangents of its own segment's eight features) | w1^T
           [16, 64] | wc0^T [64, 16] (column 0, the density logit, zero;
           then the geo rows) | wc1^T [64, 64] | wc2^T [16, 64] (rows 3..
           zero).
    gw_off: element offsets of the five weight gradients in the backward
           kernels' f32 buffer g_w, row-major: w0 [32 n_blocks, 64] with its
           rows in the A fragments' order (the row of `index`'s w0) | w1
           [64, 16] | wc0 [32, 64] in the colour input's order | wc1
           [64, 64] | wc2 [64, 8]; gw_elems is its size.
    w0_rows: int64 [32 n_blocks]: the row of the first sigma matrix that row
           k of g_w's w0 belongs to (-1: padding; a frequency row's hi and lo
           rows both name it, and their sum is its gradient).
    wc0_rows: int64 [32]: the same for wc0 (-1: the density logit's row).
    """
    segs: tuple
    rows: np.ndarray
    index: np.ndarray
    w_off: tuple
    bwd_index: np.ndarray
    bwd_off: tuple
    gw_off: tuple
    gw_elems: int
    w0_rows: np.ndarray
    wc0_rows: np.ndarray

    @property
    def n_blocks(self):
        return len(self.segs) // 4

    def meta(self, scale_meta, plane_meta):
        """The tail of FieldTables.meta: n_blocks, w_elems, w_off[5], the
        kind of each block, then per segment kind, sub, res, stride and the
        element offsets of the rows it reads in `tab`; then the size of
        wbwd and the offsets of its five matrices."""
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
        return out + [int(self.bwd_index.size)] + list(self.bwd_off)


def _tower_indices(rows, feat_dim: int):
    """The forward kernels' five tower matrices as element indices into
    `flat` (see pack_tables): w0 [32 n_blocks, 64] whose column c of the
    layout multiplies row rows[c] of the first sigma matrix (-1: padding),
    w1 [64, 16], wc0 [32, 64], wc1 [64, 64], wc2 [64, 16], input-major and
    zero-padded (`zero`: the index of the pad behind the five matrices) ->
    ((i0, i1, ic0, ic1, ic2), w0's rows in segment order, the A fragment's
    row of each layout column, zero)."""
    hid, sig_out, c_in = 64, 16, 31
    sizes = [feat_dim * hid, sig_out * hid, c_in * hid, hid * hid, hid * 3]
    off = np.concatenate([[0], np.cumsum(sizes)])
    zero = int(off[5] + (-off[5]) % 8)
    n64 = np.arange(hid)[None, :]
    # w0: layout column -> the A fragment's column of its k-block
    col = np.arange(rows.size)
    b, t, e = col // 32, col % 32 // 8, col % 8
    kpos = 32 * b + 16 * (e // 4) + 2 * t + e % 2 + 8 * (e // 2 % 2)
    iseg = np.where(rows[:, None] >= 0, off[0] + rows[:, None] * hid + n64,
                    zero)                      # w0's rows in segment order
    i0 = np.full((rows.size, hid), zero, dtype=np.int64)
    i0[kpos] = iseg
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
    return (i0, i1, ic0, ic1, ic2), iseg, kpos, zero


@functools.lru_cache(maxsize=16)
def tile_layout(cfg: CPConfig):
    """TileLayout of `cfg`, or None for a config the kernels do not take:
    other towers than _KERNEL_TOWERS, or more than 16 k-blocks. A rank or a
    channel count that is not a multiple of 8 is padded to one: the last
    segment's spare columns read the zero columns that pack_tables appends
    to the table's rows and meet zero rows of the matrix."""
    if any(getattr(cfg, k) != v for k, v in _KERNEL_TOWERS.items()):
        return None
    segs, rows = [], []

    def segment_rows(first, r0, width):
        live = min(8, width - r0)
        return list(range(first + r0, first + r0 + live)) + [-1] * (8 - live)

    def pad_block():
        while len(segs) % 4:
            segs.append((SEG_ZERO, 0, 0, 0))
            rows.extend([-1] * 8)

    row = 0
    for s, (_, rank) in enumerate(cfg.scales):
        for r0 in range(0, rank, 8):
            segs.append((SEG_LINE, s, s, r0))
            rows.extend(segment_rows(row, r0, rank))
        row += rank
    pad_block()
    for s, (_, ch) in enumerate(cfg.planes):
        for p in range(3):
            for c0 in range(0, ch, 8):
                segs.append((SEG_PLANE, p, s, c0))
                rows.extend(segment_rows(row, c0, ch))
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
    (i0, i1, ic0, ic1, ic2), iseg, kpos, zero = _tower_indices(rows,
                                                               cfg.feat_dim)
    hid = 64
    col = np.arange(32 * n_blocks)
    b = col // 32
    mats = [_frag_index(i) for i in (i0, i1, ic0, ic1, ic2)]
    w_off = np.concatenate([[0], np.cumsum([m.size for m in mats])])[:5]
    # the chain's B operands: the transposes, w0^T's columns regrouped
    i_blk, t_seg, e_seg = col % 32 // 8, col % 8 // 2, col % 2
    seg_col = 32 * b + 8 * t_seg + 2 * i_blk + e_seg
    i2t = np.full((16, hid), zero, dtype=np.int64)
    i2t[:3] = ic2[:, :3].T
    tmats = [_frag_index(m) for m in (
        iseg[seg_col].T, i1.T, np.ascontiguousarray(ic0[16:32].T), ic1.T,
        i2t)]
    bwd_off = np.concatenate([[0], np.cumsum([m.size for m in tmats])])[:5]
    gw_sizes = [32 * n_blocks * hid, hid * 16, 32 * hid, hid * hid, hid * 8]
    gw_off = np.concatenate([[0], np.cumsum(gw_sizes)])
    w0_rows = np.full(32 * n_blocks, -1, dtype=np.int64)
    w0_rows[kpos] = rows
    wc0_rows = np.full(32, -1, dtype=np.int64)
    for tq in range(4):
        for c in range(4):
            wc0_rows[2 * tq + c % 2 + 8 * (c // 2)] = 4 * tq + c
    wc0_rows[17:32] = 16 + np.arange(15)
    return TileLayout(segs=tuple(segs), rows=rows,
                      index=np.concatenate(mats),
                      w_off=tuple(int(o) for o in w_off),
                      bwd_index=np.concatenate(tmats),
                      bwd_off=tuple(int(o) for o in bwd_off),
                      gw_off=tuple(int(o) for o in gw_off[:5]),
                      gw_elems=int(gw_off[5]), w0_rows=w0_rows,
                      wc0_rows=wc0_rows)


@functools.lru_cache(maxsize=16)
def _device_index(layout: TileLayout, device: str):
    """The layout's gather indices on `device`: (index, bwd_index), and for
    g_w's w0 and wc0 the rows that are not padding and the matrix rows they
    belong to."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    k0, kc0 = np.nonzero(layout.w0_rows >= 0)[0], \
        np.nonzero(layout.wc0_rows >= 0)[0]
    return (dev(layout.index), dev(layout.bwd_index), dev(k0),
            dev(layout.w0_rows[k0]), dev(kc0), dev(layout.wc0_rows[kc0]))


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
        """Append table t, its rows padded with zero columns to a multiple
        of 8; returns its element offset and its row length."""
        nonlocal off
        width = t.shape[-1] + (-t.shape[-1]) % 8
        if width != t.shape[-1]:
            t = torch.nn.functional.pad(t, (0, width - t.shape[-1]))
        chunks.append(t.reshape(-1))
        off += t.numel()
        return off - t.numel(), width

    scale_meta = []
    for s, (res, _) in enumerate(cfg.scales):
        offs = [put(plain["lines"][s][a]) for a in range(3)]
        scale_meta += [res, offs[0][1]] + [o for o, _ in offs]
    plane_meta = []
    for s, (pres, _) in enumerate(cfg.planes):
        po = [put(plain["planes"][s][p]) for p in range(3)]
        vo = [put(plain["vm_lines"][s][p])[0] for p in range(3)]
        plane_meta += [pres, po[0][1]] + [o for o, _ in po] + vo
    tab = torch.cat(chunks)

    layout = tile_layout(cfg)
    meta = [len(cfg.scales), len(cfg.planes), cfg.freq_degree, cfg.feat_dim]
    if layout is None:
        wfwd = wbwd = tab.new_zeros(0)
        meta += [0] * 6 + scale_meta + plane_meta + [0] * 7
    else:
        ws, wc = plain["sigma_mlp"]["w"], plain["color_mlp"]["w"]
        # the five matrices one after the other, then the zeros that the
        # layouts' padding gathers
        flat = torch.cat([m.contiguous().reshape(-1) for m in (
            ws[0], ws[1].t(), wc[0], wc[1].t(), wc[2])] + [tab.new_zeros(16)])
        index, bwd_index = _device_index(layout, str(tab.device))[:2]
        wfwd, wbwd = flat[index], flat[bwd_index]
        meta += [layout.gw_elems] + list(layout.gw_off) + scale_meta \
            + plane_meta + layout.meta(scale_meta, plane_meta)
    tables = FieldTables(plain=plain, tab=tab, meta=meta, wfwd=wfwd,
                         wbwd=wbwd)
    if isinstance(cfg, CPDNeRFConfig):
        _pack_deform(tables, params, cfg)
    return tables


def sw128_positions(rows: int, cols: int, device="cpu"):
    """Where each entry of a row-major bf16 [rows, cols] matrix (rows a
    multiple of 8, cols of 64) lies in its 128-byte-swizzled image, the
    layout of csrc/deform_tower.cuh's matrices and scratch tiles: blocks of
    64 columns one after another, each [rows][64] at 128 bytes a row, the
    16-byte chunk c of row r stored at chunk c ^ (r % 8). Returns an int64
    [rows * cols] of element positions: image[pos] = mat.reshape(-1)."""
    r = torch.arange(rows, device=device)[:, None]
    c = torch.arange(cols, device=device)[None, :]
    chunk = (c % 64) // 8
    return (((c // 64) * rows + r) * 64 + (chunk ^ (r % 8)) * 8
            + c % 8).reshape(-1)


def deform_ex_columns(n_freq: int, in_pad: int):
    """The column of the first deform matrix's image (and of the kernels' ex
    tile) that holds each spatial input, in freq_encode's order [x, sin(2^f
    x), cos(2^f x)] (csrc/deform_tower.cuh ex_pair): the inputs go in pairs,
    (sin, cos)(2^f x_a) as pair 3 f + a, then (x_0, x_1) and (x_2, 0); pair p
    sits at columns 16 (i // 2) + 8 (i % 2) + 2 t (+ 1 for the second of the
    pair), t = p // (2 K), i = p % (2 K), for the K = 4 or 8 k-steps of the
    inputs padded to 64 or 128. Returns an int64 [3 + 6 n_freq]."""
    k = 4 if in_pad <= 64 else 8

    def col(p, second):
        t, i = divmod(p, 2 * k)
        return 16 * (i // 2) + 8 * (i % 2) + 2 * t + second

    n3 = 3 * n_freq
    cols = [col(n3, 0), col(n3, 1), col(n3 + 1, 0)]
    for f in range(n_freq):
        cols += [col(3 * f + a, 0) for a in range(3)]
        cols += [col(3 * f + a, 1) for a in range(3)]
    return torch.tensor(cols, dtype=torch.int64)


@functools.lru_cache(maxsize=None)
def _deform_layout(n_layers: int, n_freq: int, in_pad: int, device: str):
    """The packing of the deform matrices, made once per tower shape and
    device (a train step repacks the tables, and a host-to-device copy would
    wait for the card): the image shapes (rows, cols) and element offsets,
    the gather index that turns the row-major matrices, concatenated, into
    their images, and deform_ex_columns, both on `device`."""
    hid = _DEFORM_HID
    shapes = [(hid, -(-in_pad // 64) * 64)] + [(hid, hid)] * (n_layers - 2) \
        + [(_DEFORM_LAST_ROWS, hid)]
    offs = np.cumsum([0] + [r * c for r, c in shapes]).tolist()
    gather = torch.empty(offs[-1], dtype=torch.int64)
    for (r, c), off in zip(shapes, offs):
        gather[off + sw128_positions(r, c)] = torch.arange(off, off + r * c)
    return (shapes, offs[:-1], gather.to(device),
            deform_ex_columns(n_freq, in_pad).to(device))


def unpack_deform(tables: FieldTables):
    """The deform matrices as the kernels read them from tables.wdef,
    unswizzled: output-major bf16 [first (hidden, in_pad up to 64) with its
    columns in the kernels' ex order (deform_ex_columns), hidden matrices
    (hidden, hidden)..., last (16, hidden)]."""
    n_layers, _, _, in_pad, n_freq = tables.dmeta[:5]
    shapes, offs, _, _ = _deform_layout(n_layers, n_freq, in_pad,
                                        str(tables.wdef.device))
    out = []
    for off, (r, c) in zip(offs, shapes):
        img = tables.wdef[off:off + r * c]
        out.append(img[sw128_positions(r, c, img.device)].view(r, c))
    return out


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
    shapes, offs, gather, tables.ex_cols = _deform_layout(
        len(wd), cfg.multires_deform, in_pad, str(wb[0].device))
    first = wb[0].new_zeros(shapes[0])
    first[:, tables.ex_cols] = wb[0][:nx].t()
    last = wb[0].new_zeros(shapes[-1])
    last[:3] = wb[-1].t()
    mats = [first] + [w.t() for w in wb[1:-1]] + [last]
    tables.wdef = torch.cat([mat.reshape(-1) for mat in mats])[gather]
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
    if tile_layout(cfg) is None:
        raise NotImplementedError(
            f"the field kernel takes at most {32 * _MAX_BLOCKS} padded "
            "feature columns")


def _check_packed(tables: FieldTables, device, deform=()):
    """Raise unless the packed buffers are bf16 on `device` and every table
    row that the kernels read starts 16-byte aligned."""
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
    lists (three per line scale, six per plane scale). The rows are padded
    to multiples of 8 columns, so every row of a table starts 16-byte
    aligned when these are multiples of 8 too."""
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
    profiling.count("k1.calls")
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
    with profiling.span("k1"):
        profiling.count("k1.samples", x3.shape[1])
        if x3.device.type == "cpu":
            if parts is not None:
                raise ValueError("parts holds the kernel's features: on the "
                                 "CPU call tile_features_plain instead")
            return field_forward_plain(tables, cfg, x3, d3, lod_skip,
                                       density_only)
        if x3.device.type != "cuda":
            raise ValueError(f"unsupported device {x3.device}")
        return _launch(tables, cfg, x3, d3, lod_skip, density_only,
                       _feature_buffer(cfg, x3, parts))


# ------------------------------------------------------- hash grid (K5)
# the hash-grid field kernel's grid: 16 levels of 2 features over 3-D points,
# one k-block of the first sigma product (csrc/field_fwd_body.cuh kHashLevels)
_HASH_GRID = dict(input_dim=3, num_levels=16, level_dim=2,
                  align_corners=False, interpolation="linear")


def _hash_levels(gc: GridEncodeConfig):
    """Per level of the grid (scale, res, s1, s2, size, offset, hashed), as
    grid_encode indexes it: the tiled index x + s1 y + s2 z (strides of the
    axes whose running stride fits the level's rows, 0 for the others)
    while it fits, else, on a hash grid, the prime-XOR hash."""
    out = []
    for lvl in range(gc.num_levels):
        size = gc.offsets[lvl + 1] - gc.offsets[lvl]
        res_stride = gc.resolutions[lvl] + (0 if gc.align_corners else 1)
        strides, stride = [], 1
        for _ in range(gc.input_dim):
            if stride > size:
                break
            strides.append(stride)
            stride *= res_stride
        strides += [0] * (3 - len(strides))
        out.append((gc.level_scale(lvl), gc.resolutions[lvl], strides[1],
                    strides[2], size, gc.offsets[lvl],
                    int(gc.gridtype == HASH and stride > size)))
    return out


def _check_hash_cfg(cfg: NGPConfig):
    """Raise unless K5 takes the field: the kernel's towers, a 3-D grid of
    16 linear levels of 2 features, each level's modulo a power-of-two mask
    (hashed) or one subtraction (tiled; csrc/hash_field_fwd.cu)."""
    for k, v in _KERNEL_TOWERS.items():
        if getattr(cfg, k) != v:
            raise NotImplementedError(
                f"the hash field kernel is built for {k}={v}, got "
                f"{getattr(cfg, k)}")
    gc = cfg.grid_cfg
    for k, v in _HASH_GRID.items():
        if getattr(gc, k) != v:
            raise NotImplementedError(
                f"the hash field kernel is built for a grid of {k}={v}, got "
                f"{getattr(gc, k)}")
    for _, res, s1, s2, size, _, hashed in _hash_levels(gc):
        if (size & (size - 1)) if hashed else \
                (res + 1) * (1 + s1 + s2) >= 2 * size:
            raise NotImplementedError(
                f"the hash field kernel takes no level of {size} rows at "
                f"resolution {res} ({'hashed' if hashed else 'tiled'})")


@functools.lru_cache(maxsize=16)
def hash_tile_layout(cfg: NGPConfig):
    """(index, meta) of K5 for `cfg`, which _check_hash_cfg takes: the gather
    index of wfwd (as TileLayout.index: the first sigma matrix's 32 rows in
    their own order, thread t's segment being levels 4t..4t+3) and the int64
    meta of csrc/hash_field_fwd.cu."""
    _check_hash_cfg(cfg)
    mats, *_ = _tower_indices(np.arange(32, dtype=np.int64), 32)
    mats = [_frag_index(i) for i in mats]
    w_off = np.concatenate([[0], np.cumsum([m.size for m in mats])])[:5]
    index = np.concatenate(mats)
    meta = [0, 0, 0, 32, 0] + [0] * 5 + [1, int(index.size)] \
        + [int(o) for o in w_off] + [SEG_HASH]
    for t in range(4):
        meta += [SEG_HASH, 4 * t, 0, 0, 0, 0, 0]
    for scale, res, s1, s2, size, off, hashed in _hash_levels(cfg.grid_cfg):
        bits = int(np.asarray(scale, np.float32).view(np.uint32))
        meta += [bits, res, s1, s2, size, off, hashed]
    return index, tuple(meta)


@torch.no_grad()
def pack_hash_tables(params, cfg: NGPConfig) -> FieldTables:
    """K5's operands of an Instant-NGP field's params: the bf16 table [rows,
    2] (plain["grid"], which is also tab), the bf16 towers, and wfwd, the
    five matrices packed as for K1 (empty for a config that K5 does not
    take; the launch raises for it)."""
    bf = torch.bfloat16
    plain = {"grid": params["grid"].to(bf).contiguous(),
             "sigma_mlp": {"w": [w.to(bf) for w in params["sigma_mlp"]["w"]]},
             "color_mlp": {"w": [w.to(bf) for w in params["color_mlp"]["w"]]}}
    tab = plain["grid"]
    try:
        index, meta = hash_tile_layout(cfg)
    except NotImplementedError:
        return FieldTables(plain=plain, tab=tab, meta=[],
                           wfwd=tab.new_zeros(0))
    ws, wc = plain["sigma_mlp"]["w"], plain["color_mlp"]["w"]
    flat = torch.cat([m.contiguous().reshape(-1) for m in (
        ws[0], ws[1].t(), wc[0], wc[1].t(), wc[2])] + [tab.new_zeros(16)])
    dev = torch.from_numpy(index).to(tab.device)
    return FieldTables(plain=plain, tab=tab, meta=list(meta),
                       wfwd=flat[dev])


def hash_field_forward_plain(tables: FieldTables, cfg: NGPConfig, x3, d3,
                             density_only=False, chunk: int = 1 << 18):
    """Plain PyTorch version of K5, in chunks of `chunk` samples: grid_encode
    on the bf16 table and the towers of models/ngp.py, which round the
    features, weights and hidden activations to bf16 as the kernel does."""
    m = x3.shape[1]
    out = x3.new_zeros((4, m))
    p = {"grid": tables.plain["grid"].float(),
         "sigma_mlp": tables.plain["sigma_mlp"],
         "color_mlp": tables.plain["color_mlp"]}
    x = x3.t()
    for i in range(0, m, chunk):
        sigma, geo = ngp_density(p, cfg, x[i:i + chunk])
        out[0, i:i + chunk] = sigma
        if not density_only:
            rgb = ngp_color(p, cfg, d3.t()[i:i + chunk], geo)
            out[1:4, i:i + chunk] = rgb.t()
    return out


def _launch_hash(tables: FieldTables, cfg: NGPConfig, x3, d3, density_only,
                 feats=None):
    from .build import load_library
    hash_tile_layout(cfg)              # raises for a config K5 does not take
    for name, t in (("table", tables.tab), ("weights", tables.wfwd)):
        if t.device != x3.device or t.dtype != torch.bfloat16:
            raise ValueError(f"packed {name} must be bf16 on {x3.device}, "
                             f"got {t.dtype} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"packed {name} must be 16-byte aligned")
    m = x3.shape[1]
    out = torch.empty((4, m), dtype=torch.float32, device=x3.device)
    if m == 0:
        return out
    lib = load_library()
    meta = (ctypes.c_longlong * len(tables.meta))(*tables.meta)
    stream = torch.cuda.current_stream(x3.device).cuda_stream
    rc = lib.sdn_hash_field_fwd(
        x3.data_ptr(), (x3 if d3 is None else d3).data_ptr(), m,
        tables.tab.data_ptr(), tables.wfwd.data_ptr(), meta,
        float(cfg.bound), int(bool(density_only)), out.data_ptr(),
        None if feats is None else feats.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hash field kernel launch failed: CUDA error "
                           f"{rc}")
    profiling.count("k5.calls")
    return out


def hash_field_forward(params, cfg: NGPConfig, x3, d3, density_only=False,
                       parts=None):
    """The Instant-NGP field forward on planar samples (K5 on the card).

    Args:
      params: params dict or FieldTables (see pack_hash_tables).
      x3, d3: [3, M] f32 contiguous positions and unit directions on one
        device. d3 may be None when density_only.
      density_only: compute sigma only; rows 1-3 of the output are zero.
      parts: an optional dict that receives "features", the kernel's input
        to the first sigma product, bf16 [M, 32] (CUDA only), for holding it
        against the plain grid encoding.

    Returns out [4, M] f32, rows (sigma, r, g, b).
    """
    tables = params if isinstance(params, FieldTables) \
        else pack_hash_tables(params, cfg)
    _check_samples(x3, d3, density_only)
    m = x3.shape[1]
    with profiling.span("k5"):
        profiling.count("k5.samples", m)
        if density_only:
            profiling.count("k5.density_samples", m)
        if x3.device.type == "cpu":
            if parts is not None:
                raise ValueError("parts holds the kernel's features: on the "
                                 "CPU call grid_encode instead")
            return hash_field_forward_plain(tables, cfg, x3, d3,
                                            density_only)
        if x3.device.type != "cuda":
            raise ValueError(f"unsupported device {x3.device}")
        feats = None
        if parts is not None:
            feats = parts["features"] = torch.zeros(
                (m, 32), dtype=torch.bfloat16, device=x3.device)
        return _launch_hash(tables, cfg, x3, d3, density_only, feats)


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
    if not (isinstance(t, torch.Tensor) and t.device == device):
        profiling.host_sync(device)     # the copy from pageable memory
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


# Samples per pass of K3's two device kernels. The warp writes the warped
# positions to a [3, chunk] f32 scratch that the canonical kernel reads back;
# a larger call runs chunk by chunk through staging copies of its samples and
# outputs, 52 bytes a sample of the chunk in all (54.5 MB at 2^20, against
# the 983 MB that a scratch for all 81.92 M samples of an 800x800 frame
# would take). Every sample's arithmetic is its own, so the chunked output
# equals the unchunked one bit for bit.
DYN_CHUNK = 1 << 20


def _launch_dyn(tables: FieldTables, cfg: CPDNeRFConfig, x3, d3, t, lod_skip,
                density_only, feats=None, chunk: int = DYN_CHUNK, parts=None):
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
    chunk = max(1, min(int(chunk), m))
    staged = chunk < m
    dev = x3.device

    def buf(rows):
        return torch.empty(rows * chunk, dtype=torch.float32, device=dev)

    xw = buf(3)                     # scratch: the warped positions
    xw_all = None if parts is None else torch.empty(
        (3, m), dtype=torch.float32, device=dev)
    if staged:
        xbuf, obuf = buf(3), buf(4)
        dbuf = None if d3 is None else buf(3)
    lib = load_library()
    meta = (ctypes.c_longlong * len(tables.meta))(*tables.meta)
    dmeta = (ctypes.c_longlong * len(tables.dmeta))(*tables.dmeta)
    mask = 0
    for s in lod_skip:
        mask |= 1 << int(s)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i0 in range(0, m, chunk):
        n = min(chunk, m - i0)
        if staged:
            xs = xbuf[:3 * n].view(3, n)
            xs.copy_(x3[:, i0:i0 + n])
            ds = xs
            if d3 is not None:
                ds = dbuf[:3 * n].view(3, n)
                ds.copy_(d3[:, i0:i0 + n])
            os_ = obuf[:4 * n].view(4, n)
        else:
            xs, ds, os_ = x3, (x3 if d3 is None else d3), out
        rc = lib.sdn_dyn_field_fwd(
            xs.data_ptr(), ds.data_ptr(), n, tables.tab.data_ptr(),
            tables.wfwd.data_ptr(), meta, float(cfg.bound),
            tables.wdef.data_ptr(), dmeta, tcond.data_ptr(), mask,
            int(bool(density_only)), xw.data_ptr(), os_.data_ptr(),
            None if feats is None else feats[i0:i0 + n].data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(
                f"dynamic field kernel launch failed: CUDA error {rc}")
        if staged:
            out[:, i0:i0 + n].copy_(os_)
        if xw_all is not None:
            xw_all[:, i0:i0 + n].copy_(xw[:3 * n].view(3, n))
    if parts is not None:
        parts["xw"] = xw_all
    profiling.count("k3.calls")
    return out


def dyn_field_forward(params, cfg: CPDNeRFConfig, x3, d3, t, lod_skip=(),
                      density_only=False, parts=None, chunk: int = DYN_CHUNK):
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
        those at the warped positions, and parts also receives "xw" [3, M],
        the warped positions that the kernel's warp wrote.
      chunk: samples per pass of the kernel's two device kernels (see
        DYN_CHUNK); the output does not depend on it.

    Returns out [4, M] f32, rows (sigma, r, g, b).
    """
    if not isinstance(cfg, CPDNeRFConfig):
        raise TypeError("dyn_field_forward needs a CPDNeRFConfig")
    tables = params if isinstance(params, FieldTables) \
        else pack_tables(params, cfg)
    if tables.w0_time is None:
        raise ValueError("the tables hold no deform tower")
    _check_samples(x3, d3, density_only)
    with profiling.span("k3"):
        profiling.count("k3.samples", x3.shape[1])
        if x3.device.type == "cpu":
            if parts is not None:
                raise ValueError("parts holds the kernel's features: on the "
                                 "CPU call tile_features_plain instead")
            return dyn_field_forward_plain(tables, cfg, x3, d3, t, lod_skip,
                                           density_only)
        if x3.device.type != "cuda":
            raise ValueError(f"unsupported device {x3.device}")
        return _launch_dyn(tables, cfg, x3, d3, t, lod_skip, density_only,
                           _feature_buffer(cfg, x3, parts), chunk, parts)


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
    """The kernel's flat grad buffers in the params' layouts: views of g_tab
    with the rows' padding cut away, and the five matrices gathered from
    g_w's layout (TileLayout.gw_off)."""
    meta = tables.meta
    q = 10
    out = {"lines": []}
    for res, rank in cfg.scales:
        width = meta[q + 1]
        out["lines"].append([
            g_tab[o:o + res * width].view(res, width)[:, :rank]
            for o in meta[q + 2:q + 5]])
        q += 5
    if cfg.planes:
        out["planes"], out["vm_lines"] = [], []
        for pres, ch in cfg.planes:
            width = meta[q + 1]
            n_pl, n_vl = pres * pres * width, pres * width
            out["planes"].append([
                g_tab[o:o + n_pl].view(pres, pres, width)[..., :ch]
                for o in meta[q + 2:q + 5]])
            out["vm_lines"].append([
                g_tab[o:o + n_vl].view(pres, width)[:, :ch]
                for o in meta[q + 5:q + 8]])
            q += 8
    layout = tile_layout(cfg)
    hid = cfg.hidden_dim
    _, _, k0, r0, kc0, rc0 = _device_index(layout, str(g_w.device))

    def mat(k, rows, cols):
        o = layout.gw_off[k]
        return g_w[o:o + rows * cols].view(rows, cols)
    # a frequency row's gradient is the sum of its hi and its lo row
    w0 = g_w.new_zeros((cfg.feat_dim, hid)).index_add_(
        0, r0, mat(0, 32 * layout.n_blocks, hid)[k0])
    wc0 = g_w.new_zeros((cfg.dir_dim + cfg.geo_feat_dim, hid)).index_add_(
        0, rc0, mat(2, 32, hid)[kc0])
    out["sigma_mlp"] = {"w": [w0, mat(1, hid, 16)]}
    out["color_mlp"] = {"w": [wc0, mat(3, hid, hid), mat(4, hid, 8)[:, :3]]}
    return out


def backward_shared_bytes(layout: TileLayout):
    """(bytes, w0_staged): the shared memory of a block of the backward
    kernels, and whether that holds the first sigma matrix and its transpose
    (csrc/field_bwd_body.cuh: field_bwd_smem). They are staged with the other
    matrices when everything fits a block, as at the default widths' 10
    k-blocks; a wider config leaves the two in device memory."""
    rest = 2 * (layout.index.size + layout.bwd_index.size) \
        + 4 * layout.gw_elems + _BWD_LOCK_BYTES
    if rest <= _SMEM_PER_BLOCK:
        return rest, True
    return rest - 2 * (layout.w_off[1] + layout.bwd_off[1]), False


def _backward_buffers(tables: FieldTables, cfg: CPConfig, x3):
    """Check the packed operands of a backward kernel against the device and
    a block's shared memory (backward_shared_bytes), and return its zeroed f32 gradient buffers
    (g_tab like the tables, g_w: TileLayout.gw_off) with the zeroed counter
    and the scratch of the list of samples that carry a cotangent. Zeroed on
    the launch stream: the kernels only add into them."""
    _check_kernel_cfg(cfg)
    _check_packed(tables, x3.device, (("transposed weights", tables.wbwd),))
    layout = tile_layout(cfg)
    need = backward_shared_bytes(layout)[0]
    if need > _SMEM_PER_BLOCK:
        raise NotImplementedError(
            f"the field backward kernel keeps the towers' matrices, their "
            f"transposes and a block's weight-gradient sums "
            f"({4 * layout.gw_elems} bytes) in shared memory: {need} bytes "
            f"for {layout.n_blocks} k-blocks of 32 feature columns, more "
            f"than the {_SMEM_PER_BLOCK} a block has")
    m, dev = x3.shape[1], x3.device
    g_tab = torch.zeros(tables.tab.numel(), dtype=torch.float32, device=dev)
    g_w = torch.zeros(layout.gw_elems, dtype=torch.float32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    idx = torch.empty(m, dtype=torch.int32, device=dev)
    return g_tab, g_w, count, idx


# fragile_samples_plain's allowances: for the order of an f32 sum, as a share
# of sum_k |a_k w_k| (eight roundings of 2^-24), and for a frequency feature
# that the kernels enter as a hi + lo bf16 pair, as a share of its value.
# Measured on an H100 (profiling/torch_fragile_margin.py, 262,181 random
# samples): with these values the set takes 4 % of the samples (7 % at narrow
# widths) and K2 lies 1.2e-3 to 2.0e-3 from its plain version on the others,
# 2.5e-2 on all; a quarter of both values still holds that, a sixteenth does
# not (the set then misses samples whose masks the kernel's sums flip).
SUM_NOISE = 2.0 ** -21
FREQ_NOISE = 2.0 ** -19


def _bf16_tie_distance(v):
    """Per f32 value: how far it lies from the nearest point at which its
    bf16 rounding changes (the midpoint of two neighbouring bf16 values),
    and the spacing of the bf16 values there."""
    _, e = torch.frexp(v.abs().clamp(min=1e-30))    # |v| = m 2^e, m in [.5, 1)
    ulp = torch.ldexp(torch.ones_like(v), e - 8)
    return 0.5 * ulp - (v - bf16_round(v)).abs(), ulp


def fragile_samples_plain(tables: FieldTables, cfg: CPConfig, x, d,
                          sum_noise: float = SUM_NOISE, freq_noise: float = FREQ_NOISE):
    """The samples (bool [S], at positions x and directions d [S, 3]) whose
    share of a gradient is not stable under a reordering of the forward's
    f32 sums, by the plain version alone: those at which a pre-activation of
    a relu (h0, hc0, hc1 of _bwd_chunk) lies within its noise bound of 0, so
    that the same arithmetic summed in another order (the kernels' mma) may
    put it on the other side, which changes the sample's whole share of
    every gradient.

    The bound of a product a @ w is sum_noise * (|a| @ |w|) + da @ |w|, da
    being how far the operand itself may differ: 2^-16 of a frequency
    feature (the kernels enter it as a hi + lo bf16 pair), nothing for a
    line or plane feature (the kernels' are the plain ones bit for bit), a
    few f32 ulps for an SH component, and for a bf16-rounded activation one
    bf16 spacing where its f32 value lies within its own bound of a point
    where the rounding changes, else nothing: rounding to bf16 wipes the
    noise out everywhere else."""
    tp = tables.plain
    w0, w1 = (w.float() for w in tp["sigma_mlp"]["w"])
    wc0, wc1, _ = (w.float() for w in tp["color_mlp"]["w"])

    def product(a, da, w):
        return a @ w, sum_noise * (a.abs() @ w.abs()) + da @ w.abs()

    def rounded(h, nb, relu):
        dist, ulp = _bf16_tie_distance(h)
        moves = (dist <= nb) & (h > -nb) if relu else dist <= nb
        return torch.where(moves, ulp, torch.zeros_like(ulp))

    with torch.no_grad():
        feat = cp_features(tp, cfg, x)
        g = cfg.grid_feat_dim
        a0 = torch.cat([bf16_round(feat[:, :g]), feat[:, g:]], dim=-1)
        da0 = torch.zeros_like(a0)
        da0[:, g:] = freq_noise * feat[:, g:].abs()
        h0, n0 = product(a0, da0, w0)
        h1, n1 = product(bf16_round(torch.relu(h0)), rounded(h0, n0, True),
                         w1)
        sh = sh_encode(d, degree=cfg.sh_degree)
        cin = torch.cat([sh, h1[:, 1:]], dim=-1)
        ncin = torch.cat([2.0 ** -21 * sh.abs() + 1e-7, n1[:, 1:]], dim=-1)
        hc0, nc0 = product(bf16_round(cin), rounded(cin, ncin, False), wc0)
        hc1, nc1 = product(bf16_round(torch.relu(hc0)),
                           rounded(hc0, nc0, True), wc1)
        return ((h0.abs() <= n0).any(dim=1) | (hc0.abs() <= nc0).any(dim=1)
                | (hc1.abs() <= nc1).any(dim=1))


def _launch_bwd(tables: FieldTables, cfg: CPConfig, x3, d3, g_out,
                parts=None):
    from .build import load_library
    g_tab, g_w, count, idx = _backward_buffers(tables, cfg, x3)
    m = x3.shape[1]
    if m > 0:
        rec_out = None if parts is None else torch.zeros_like(g_out)
        lib = load_library()
        meta = (ctypes.c_longlong * len(tables.meta))(*tables.meta)
        stream = torch.cuda.current_stream(x3.device).cuda_stream
        rc = lib.sdn_field_bwd(
            x3.data_ptr(), d3.data_ptr(), g_out.data_ptr(), m,
            tables.tab.data_ptr(), tables.wfwd.data_ptr(),
            tables.wbwd.data_ptr(), meta, float(cfg.bound), count.data_ptr(),
            idx.data_ptr(), g_tab.data_ptr(), g_w.data_ptr(),
            None if parts is None else rec_out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(
                f"field backward kernel launch failed: CUDA error {rc}")
        profiling.count("k2.calls")
        if parts is not None:
            # reading the list's length waits for the kernel
            parts.update(live=idx[:int(count)].long(), out=rec_out)
    return _unpack_grads(tables, cfg, g_tab, g_w)


def field_backward(tables, cfg: CPConfig, x3, d3, g_out, parts=None):
    """Param gradients of the field at planar samples.

    Args:
      tables: params dict or FieldTables (see pack_tables).
      x3, d3: [3, M] f32 contiguous positions and unit directions.
      g_out: [4, M] f32 contiguous cotangent of field_forward's output
        (rows sigma, r, g, b).
      parts: an optional dict that receives what the kernel recomputed
        (CUDA only; filling it waits for the kernel): "live" [L], the
        samples that carry a cotangent, in the order the kernel walked
        them; "out" [4, M], the forward's output at those samples (0
        elsewhere), to be held against field_forward's bit for bit.

    Returns an f32 dict in the params' names and layouts. On CUDA the
    tables' gradients are views into one flat buffer. Samples whose four
    cotangents are zero add nothing.
    """
    tables = tables if isinstance(tables, FieldTables) \
        else pack_tables(tables, cfg)
    _check_backward_inputs(x3, d3, g_out)
    with profiling.span("k2"):
        profiling.count("k2.samples", x3.shape[1])
        if x3.device.type == "cpu":
            if parts is not None:
                raise ValueError("parts holds what the kernel recomputed: "
                                 "there is none on the CPU")
            return field_backward_plain(tables, cfg, x3, d3, g_out)
        if x3.device.type != "cuda":
            raise ValueError(f"unsupported device {x3.device}")
        return _launch_bwd(tables, cfg, x3, d3, g_out, parts)


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
    """The kernel's deform-gradient buffers (g_wdef f32 [n_layers, hidden,
    hidden], matrix l output-major; g_wtime [time inputs, hidden]) in the
    params' layouts."""
    n_layers, hid = tables.dmeta[:2]
    g = g_wdef.view(n_layers, hid, hid)
    out = [torch.cat([g[0][:, tables.ex_cols].t(), g_wtime], dim=0)]
    out += [g[l].t() for l in range(1, n_layers - 1)]
    out.append(g[-1][:3].t())
    return {"w": out}


def _unswizzle_tiles(scr, n_layers, n):
    """The backward's scratch (bf16 [n_layers][tiles][64 x 128 tile image],
    see csrc/dyn_field_bwd.cu) as row-major [n_layers, n, 128] for its first
    n rows."""
    hid, tile = _DEFORM_HID, _DEFORM_TILE
    tiles = scr.view(n_layers, -1, tile * hid)[:, :-(-n // tile)]
    pos = sw128_positions(tile, hid, scr.device)
    return tiles[:, :, pos].reshape(n_layers, -1, hid)[:, :n]


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
    if tables.wdef.device != x3.device or tables.wdef.dtype != torch.bfloat16:
        raise ValueError(f"packed deform weights must be bf16 on {x3.device}, "
                         f"got {tables.wdef.dtype} on {tables.wdef.device}")
    g_tab, g_w, count, idx = _backward_buffers(tables, cfg, x3)
    m, dev = x3.shape[1], x3.device
    f32 = dict(dtype=torch.float32, device=dev)
    tdim = tables.w0_time.shape[0]
    n_layers = tables.dmeta[0]
    g_wdef = torch.zeros((n_layers, _DEFORM_HID, _DEFORM_HID), **f32)
    g_wtime = torch.zeros((tdim, _DEFORM_HID), **f32)
    if m > 0:
        xw = (torch.empty if parts is None else torch.zeros)((3, m), **f32)
        gx = torch.empty((3, m), **f32)
        tcond = torch.cat(_time_cond_vec(tables, cfg, t, dev)).contiguous()
        # the tower's scratch: output gradients and inputs of every matrix,
        # tile images of 64 listed samples, for one pass of `window` tiles
        # (for checks, the inputs of every pass)
        tiles = -(-m // _DEFORM_TILE)
        tile_elems = _DEFORM_TILE * _DEFORM_HID
        window = min(tiles, max(1, _TOWER_SCRATCH_BYTES
                                // (2 * n_layers * tile_elems * 2)))
        passes = -(-tiles // window)
        gscr, ascr = ((torch.empty if parts is None else torch.zeros)(
            n_layers * n * tile_elems, dtype=torch.bfloat16, device=dev)
            for n in (window, window if parts is None else tiles))
        # the tower backward's f64 time-row sums, a row of 128 a block (at
        # most one an SM) and pass
        tsum = torch.empty(passes * torch.cuda.get_device_properties(
            dev).multi_processor_count * _DEFORM_HID, dtype=torch.float64,
            device=dev)
        rec_out = None if parts is None else torch.zeros_like(g_out)
        lib = load_library()
        meta = (ctypes.c_longlong * len(tables.meta))(*tables.meta)
        dmeta = (ctypes.c_longlong * len(tables.dmeta))(*tables.dmeta)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sdn_dyn_field_bwd(
            x3.data_ptr(), d3.data_ptr(), g_out.data_ptr(), m,
            tables.tab.data_ptr(), tables.wfwd.data_ptr(),
            tables.wbwd.data_ptr(), meta, float(cfg.bound),
            tables.wdef.data_ptr(), dmeta, tcond.data_ptr(), tdim,
            int(cfg.deform_grad_res_cutoff), xw.data_ptr(), count.data_ptr(),
            idx.data_ptr(), gx.data_ptr(), g_tab.data_ptr(), g_w.data_ptr(),
            g_wdef.data_ptr(), tsum.data_ptr(), g_wtime.data_ptr(),
            gscr.data_ptr(), ascr.data_ptr(), window, int(parts is not None),
            None if parts is None else rec_out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(
                f"dynamic field backward kernel launch failed: CUDA error "
                f"{rc}")
        profiling.count("k4.calls")
        if parts is not None:
            # the compact list back in sample order; reading its length
            # waits for the kernel
            live = idx[:int(count)].long()
            parts.update(live=live, out=rec_out)
            g_x = torch.zeros((3, m), **f32)
            g_x[:, live] = gx[:, :live.numel()]
            acts = _unswizzle_tiles(ascr, n_layers, live.numel())
            parts.update(xw=xw, g_x=g_x, acts=[acts[0][:, tables.ex_cols]]
                         + list(acts[1:]))
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
        stages one by one: "xw" [3, M], the warped positions of the samples
        that carry a cotangent (0 elsewhere: the kernel warps only those,
        see dyn_warp_plain for the others); "g_x" [3, M],
        the position gradient that entered the tower's backward (0 where
        the cotangent is all zero); "live" [L], the samples that carry a
        cotangent, in the order the tower's backward walked them; "acts",
        the activations it recomputed for them, bf16, laid out as
        dyn_warp_plain's ([L, spatial inputs], then [L, hidden] a matrix);
        "out", what the canonical kernel recomputed at the warped
        positions, as field_backward's. Filling it waits for the kernel.

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
    with profiling.span("k4"):
        profiling.count("k4.samples", x3.shape[1])
        if x3.device.type == "cpu":
            if parts is not None:
                raise ValueError("parts holds the kernel's stages: on the "
                                 "CPU call the plain version's stages "
                                 "instead")
            return dyn_field_backward_plain(tables, cfg, x3, d3, t, g_out)
        if x3.device.type != "cuda":
            raise ValueError(f"unsupported device {x3.device}")
        return _launch_dyn_bwd(tables, cfg, x3, d3, t, g_out, parts)


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
