"""The kernels' packed operands (sealdnerf_tpu_torch/ops/field.py:
TileLayout, pack_tables' `wfwd`, `wbwd` and the tail of `meta`), checked on
the CPU by unpacking them with loops written from the layout's description,
and by running the kernels' tile arithmetic, forward and backward, in PyTorch
on the unpacked operands against the plain versions."""

import numpy as np
import pytest
import torch

from sealdnerf_tpu_torch.models.cp import (CPConfig, CPDNeRFConfig, CPField,
                                           cp_features, init_cp,
                                           init_cp_dnerf, param_leaves)
from sealdnerf_tpu_torch.ops.field import (SEG_FREQ, SEG_LINE, SEG_PLANE,
                                           SEG_ZERO, _backward_buffers,
                                           _bwd_chunk, _check_kernel_cfg,
                                           _unpack_grads, _zero_grads,
                                           backward_shared_bytes,
                                           field_forward_plain,
                                           fragile_samples_plain,
                                           pack_tables, table_row_offsets,
                                           tile_features_plain, tile_layout)
from sealdnerf_tpu_torch.ops.hat import bf16_round
from sealdnerf_tpu_torch.ops.sh_encode import sh_encode

CONFIGS = {
    "full": CPConfig(),
    # feat_dim 83: not a multiple of 16; one k-block mixes two line scales
    "narrow": CPConfig(scales=((16, 8), (64, 24)), planes=((16, 8),)),
    # no planes, another frequency degree, a rank of 40
    "lines": CPConfig(scales=((32, 40),), planes=(), freq_degree=3),
    # ranks and channels that are no multiples of 8: rows padded to 8, 24, 8
    "padded": CPConfig(scales=((16, 4), (64, 20)), planes=((16, 4),)),
}


def _pad8(n):
    return n + (-n) % 8


def _tables(cfg, seed=0):
    init = init_cp_dnerf if isinstance(cfg, CPDNeRFConfig) else init_cp
    return pack_tables(init(torch.Generator().manual_seed(seed), cfg), cfg)


def _unfrag(flat, k, n):
    """Inverse of the B-fragment order, one element at a time: entry
    [k-step][pair][lane][j] is row 16 ks + 2 t + (0, 1, 8, 9)[j % 4] of
    column 16 pair + g + 8 (j // 4), g = lane // 4, t = lane % 4."""
    flat = flat.float().numpy().reshape(k // 16, n // 16, 32, 8)
    out = np.full((k, n), np.nan, dtype=np.float32)
    for ks in range(k // 16):
        for pr in range(n // 16):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for j in range(8):
                    row = 16 * ks + 2 * t + (0, 1, 8, 9)[j % 4]
                    col = 16 * pr + g + 8 * (j // 4)
                    assert np.isnan(out[row, col])
                    out[row, col] = flat[ks, pr, lane, j]
    assert not np.isnan(out).any()
    return out


def _tile_meta(tables):
    """The forward tail of `meta` as (n_blocks, w_elems, w_off, blk_kind,
    segments)."""
    meta = tables.meta
    q = 10 + 5 * meta[0] + 8 * meta[1]
    nb, w_elems = meta[q], meta[q + 1]
    w_off = meta[q + 2:q + 7]
    kinds = meta[q + 7:q + 7 + nb]
    q += 7 + nb
    segs = [meta[q + 7 * i:q + 7 * i + 7] for i in range(4 * nb)]
    assert q + 28 * nb + (6 if nb else 0) == len(meta)    # wbwd's tail
    return nb, w_elems, w_off, kinds, segs


def _unpacked(tables):
    """The five matrices of wfwd, input-major; w0's rows back in segment
    order (column 8 * segment + e)."""
    nb, w_elems, w_off, _, _ = _tile_meta(tables)
    assert tables.wfwd.numel() == w_elems and w_elems % 8 == 0
    ends = list(w_off[1:]) + [w_elems]
    shapes = [(32 * nb, 64), (64, 16), (32, 64), (64, 64), (64, 16)]
    mats = [_unfrag(tables.wfwd[a:b], *shp)
            for a, b, shp in zip(w_off, ends, shapes)]
    w0 = np.empty_like(mats[0])
    for b in range(nb):
        for t in range(4):
            for e in range(8):
                kpos = 32 * b + 16 * (e // 4) + 2 * t + e % 2 \
                    + 8 * (e // 2 % 2)
                w0[32 * b + 8 * t + e] = mats[0][kpos]
    return [w0] + mats[1:]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_weights_unpack_to_the_five_matrices(name):
    cfg = CONFIGS[name]
    tables = _tables(cfg)
    w0, w1, wc0, wc1, wc2 = _unpacked(tables)
    ws = [w.float().numpy() for w in tables.plain["sigma_mlp"]["w"]]
    wc = [w.float().numpy() for w in tables.plain["color_mlp"]["w"]]
    rows = tile_layout(cfg).rows
    assert sorted(set(rows[rows >= 0])) == list(range(cfg.feat_dim))
    np.testing.assert_array_equal(w0[rows >= 0], ws[0][rows[rows >= 0]])
    assert not w0[rows < 0].any()
    # every grid row once, every frequency row twice (hi and lo)
    counts = np.bincount(rows[rows >= 0])
    assert (counts[:cfg.grid_feat_dim] == 1).all()
    assert (counts[cfg.grid_feat_dim:] == 2).all()
    np.testing.assert_array_equal(w1, ws[1])
    np.testing.assert_array_equal(wc1, wc[1])
    np.testing.assert_array_equal(wc2[:, :3], wc[2])
    assert not wc2[:, 3:].any()
    # colour input: thread t's SH components 4t..4t+3 sit at the columns of
    # its A fragment; then a zero row (the density logit) and the geo rows
    for t in range(4):
        for c in range(4):
            np.testing.assert_array_equal(
                wc0[2 * t + c % 2 + 8 * (c // 2)], wc[0][4 * t + c])
    assert not wc0[16].any()
    np.testing.assert_array_equal(wc0[17:], wc[0][16:])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_segments_point_at_16_byte_aligned_rows(name):
    cfg = CONFIGS[name]
    tables = _tables(cfg)
    assert all(v % 8 == 0 for v in table_row_offsets(tables.meta))
    nb, _, _, kinds, segs = _tile_meta(tables)
    assert nb == tile_layout(cfg).n_blocks
    tab = tables.tab.float()
    n_line = n_plane = 0
    for i, (kind, sub, res, stride, *off) in enumerate(segs):
        assert kind in (SEG_ZERO, kinds[i // 4])
        if kind == SEG_LINE:
            first = tile_layout(cfg).segs[i][3]
            rank = cfg.scales[sub][1]
            assert (res, stride) == (cfg.scales[sub][0], _pad8(rank))
            live = min(8, rank - first)
            for a in range(3):
                assert off[a] % 8 == 0
                want = tables.plain["lines"][sub][a].float()
                for row in (0, res - 1):
                    got = tab[off[a] + stride * row:][:8]
                    assert torch.equal(got[:live],
                                       want[row, first:first + live])
                    assert not got[live:].any()          # the row's padding
            n_line += live
        elif kind == SEG_PLANE:
            _, _, s, first = tile_layout(cfg).segs[i]
            ch = cfg.planes[s][1]
            assert (res, stride) == (cfg.planes[s][0], _pad8(ch))
            assert off[0] % 8 == 0 and off[1] % 8 == 0
            live = min(8, ch - first)
            pl = tables.plain["planes"][s][sub].float()
            vl = tables.plain["vm_lines"][s][sub].float()
            at = off[0] + (3 * res + 2) * stride
            assert torch.equal(tab[at:at + live],
                               pl[3, 2, first:first + live])
            assert torch.equal(tab[off[1] + stride:][:live],
                               vl[1, first:first + live])
            assert not tab[at + live:at + 8].any()
            assert not tab[off[1] + stride + live:off[1] + stride + 8].any()
            n_plane += live
    assert n_line == sum(r for _, r in cfg.scales)
    assert n_plane == sum(3 * c for _, c in cfg.planes)


def _samples(m, seed):
    """Seeded positions, unit directions and cotangents, a fifth of the
    cotangents' columns zero."""
    rng = np.random.default_rng(seed)
    x3 = torch.from_numpy(rng.uniform(-1, 1, (3, m)).astype(np.float32))
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 = torch.from_numpy(d3 / np.linalg.norm(d3, axis=0, keepdims=True))
    g = rng.normal(size=(4, m)).astype(np.float32)
    g[:, ::5] = 0.0
    return x3, d3, torch.from_numpy(g)


def _tile_forward(tables, cfg, x3, d3, lod_skip=()):
    """The kernels' tile arithmetic on the unpacked operands: features in
    segment order (frequency values as hi + lo bf16 pairs), f32 products,
    relu and bf16 between layers, the colour input as [SH in the threads'
    order | the sigma outputs with the logit zeroed]."""
    w0, w1, wc0, wc1, wc2 = (torch.from_numpy(w) for w in _unpacked(tables))
    layout = tile_layout(cfg)
    x = x3.t()
    grid, freq, cols = tile_features_plain(tables, cfg, x)
    if lod_skip:
        grid = bf16_round(cp_features(tables.plain, cfg, x, lod_skip)
                          [:, :cfg.grid_feat_dim])
    a = torch.zeros((x.shape[0], 32 * layout.n_blocks))
    g = cfg.grid_feat_dim
    a[:, cols[:g, 0]] = grid
    hi = bf16_round(freq)
    a[:, cols[g:, 0]] = hi
    a[:, cols[g:, 1]] = bf16_round(freq - hi)
    h = bf16_round(torch.relu(a @ w0))
    o = h @ w1
    sh = sh_encode(d3.t(), degree=cfg.sh_degree)
    cin = torch.zeros((x.shape[0], 32))
    for t in range(4):
        for c in range(4):
            cin[:, 2 * t + c % 2 + 8 * (c // 2)] = sh[:, 4 * t + c]
    cin[:, 17:] = o[:, 1:]
    hc = bf16_round(torch.relu(bf16_round(cin) @ wc0))
    hc = bf16_round(torch.relu(hc @ wc1))
    rgb = torch.sigmoid(hc @ wc2)[:, :3]
    return torch.cat([torch.exp(o[:, :1]), rgb], dim=1).t()


@pytest.mark.parametrize("lod_skip", [(), (1,)])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_tile_arithmetic_on_the_packed_operands_matches_plain(name, lod_skip):
    """What the kernels compute from wfwd is the plain version's function:
    the frequency rows as hi + lo pairs cost at most 2^-17 of a product."""
    cfg = CONFIGS[name]
    if len(cfg.scales) == 1:
        lod_skip = tuple(s - 1 for s in lod_skip)
    tables = _tables(cfg, seed=3)
    x3, d3, _ = _samples(257, 5)
    got = _tile_forward(tables, cfg, x3, d3, lod_skip)
    ref = field_forward_plain(tables, cfg, x3, d3, lod_skip=lod_skip)
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(got[1:], ref[1:], rtol=0, atol=2e-4)


@pytest.mark.parametrize("scales,planes,ok", [
    (((16, 8), (64, 24)), ((16, 8),), True),
    (((16, 8), (64, 20)), (), True),             # a rank of 20: padded to 24
    (((16, 8),), ((16, 4),), True),              # 4 plane channels: to 8
    (((8, 64),) * 8, ((8, 8),) * 4, False),      # 17 k-blocks
])
def test_check_kernel_cfg_takes_only_whole_segments(scales, planes, ok):
    """A rank or a channel count that is no multiple of 8 packs (the rows
    padded with zero columns that meet zero rows of the first matrix) and
    the tile arithmetic on the packed operands matches plain; only a config
    of more than 16 k-blocks is refused."""
    cfg = CPConfig(scales=scales, planes=planes)
    tables = _tables(cfg)
    assert (tile_layout(cfg) is not None) == ok
    assert (tables.wfwd.numel() > 0) == ok
    if not ok:
        with pytest.raises(NotImplementedError, match="feature columns"):
            _check_kernel_cfg(cfg)
        assert _tile_meta(tables)[0] == 0
        return
    _check_kernel_cfg(cfg)
    assert all(v % 8 == 0 for v in table_row_offsets(tables.meta))
    rows = tile_layout(cfg).rows
    assert (rows >= 0).sum() == cfg.grid_feat_dim + 2 * (cfg.feat_dim
                                                         - cfg.grid_feat_dim)
    assert not _unpacked(tables)[0][rows < 0].any()
    x3, d3, _ = _samples(257, 5)
    got = _tile_forward(tables, cfg, x3, d3)
    ref = field_forward_plain(tables, cfg, x3, d3)
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(got[1:], ref[1:], rtol=0, atol=2e-4)


def test_forward_buffers_of_a_dynamic_field():
    cfg = CPDNeRFConfig()
    tables = _tables(cfg)
    static = _tables(CPConfig())
    assert tables.wfwd.numel() == static.wfwd.numel() == 28672
    assert tables.meta == static.meta and tables.dmeta


def test_kernel_tables_repack_the_forward_weights_in_place_updates():
    cfg = CONFIGS["narrow"]
    params = init_cp(torch.Generator().manual_seed(0), cfg)
    field = CPField(params, cfg)
    t0 = field.kernel_tables(params)
    assert field.kernel_tables(params) is t0
    with torch.no_grad():
        for leaf in param_leaves(params):
            leaf.mul_(1.5)
    t1 = field.kernel_tables(params)
    assert t1 is not t0
    fresh = pack_tables(params, cfg)
    assert torch.equal(t1.wfwd, fresh.wfwd) and torch.equal(t1.tab, fresh.tab)
    assert torch.equal(t1.wbwd, fresh.wbwd)
    assert not torch.equal(t1.wfwd, t0.wfwd)
    np.testing.assert_array_equal(_unpacked(t1)[3],
                                  t1.plain["color_mlp"]["w"][1].float())


# ------------------------------------------------------------------ backward
def _bwd_meta(tables):
    """The backward tail of `meta`: (wb_elems, wb_off)."""
    meta = tables.meta
    nb = _tile_meta(tables)[0]
    q = 10 + 5 * meta[0] + 8 * meta[1] + 7 + 29 * nb
    assert q + 6 == len(meta)
    return meta[q], meta[q + 1:q + 6]


def _unpacked_bwd(tables):
    """The five B operands of the backward's chain from wbwd, each [k, n];
    w0^T's columns back in segment order (column 32 b + 8 i + 2 t + e of the
    buffer is segment column 32 b + 8 t + 2 i + e)."""
    nb = _tile_meta(tables)[0]
    wb_elems, wb_off = _bwd_meta(tables)
    assert tables.wbwd.numel() == wb_elems and wb_elems % 8 == 0
    ends = list(wb_off[1:]) + [wb_elems]
    shapes = [(64, 32 * nb), (16, 64), (64, 16), (64, 64), (16, 64)]
    mats = [_unfrag(tables.wbwd[a:b], *shp)
            for a, b, shp in zip(wb_off, ends, shapes)]
    w0t = np.empty_like(mats[0])
    for b in range(nb):
        for i in range(4):
            for t in range(4):
                for e in range(2):
                    w0t[:, 32 * b + 8 * t + 2 * i + e] = \
                        mats[0][:, 32 * b + 8 * i + 2 * t + e]
    return [w0t] + mats[1:]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_backward_weights_unpack_to_the_five_transposes(name):
    """wbwd holds the transposes of what wfwd holds, in the same padded
    layouts: padded rows and columns are zero, and the geo block of wc0^T
    has a zero column where the density logit sits."""
    cfg = CONFIGS[name]
    tables = _tables(cfg)
    w0, w1, wc0, wc1, wc2 = _unpacked(tables)
    w0t, w1t, wc0t, wc1t, wc2t = _unpacked_bwd(tables)
    np.testing.assert_array_equal(w0t, w0.T)
    np.testing.assert_array_equal(w1t, w1.T)
    np.testing.assert_array_equal(wc0t, wc0[16:].T)
    assert not wc0t[:, 0].any()
    np.testing.assert_array_equal(wc1t, wc1.T)
    np.testing.assert_array_equal(wc2t, wc2.T)
    assert not wc2t[3:].any()
    rows = tile_layout(cfg).rows
    assert not w0t[:, rows < 0].any()
    ws0 = tables.plain["sigma_mlp"]["w"][0].float().numpy()
    np.testing.assert_array_equal(w0t[:, rows >= 0], ws0[rows[rows >= 0]].T)


def _tile_backward(tables, cfg, x3, d3, g_out):
    """The backward kernels' tile arithmetic on the unpacked operands: the
    forward as _tile_forward, the chain with the transposes of wbwd, the
    weight gradients as products over the samples in g_w's layout (the
    frequency blocks with both operands as hi + lo bf16 pairs), and the
    cotangent of every feature column. Returns (g_w flat, g_feat [S, 32
    n_blocks] in segment order)."""
    w0, w1, wc0, wc1, wc2 = (torch.from_numpy(w) for w in _unpacked(tables))
    w0t, w1t, wc0t, wc1t, wc2t = (torch.from_numpy(w)
                                  for w in _unpacked_bwd(tables))
    layout = tile_layout(cfg)
    nb = layout.n_blocks
    x = x3.t()
    grid, freq, cols = tile_features_plain(tables, cfg, x)
    s_n, g_n = x.shape[0], cfg.grid_feat_dim
    a = torch.zeros((s_n, 32 * nb))
    a[:, cols[:g_n, 0]] = grid
    hi = bf16_round(freq)
    a[:, cols[g_n:, 0]] = hi
    a[:, cols[g_n:, 1]] = bf16_round(freq - hi)
    h0 = a @ w0
    r0 = bf16_round(torch.relu(h0))
    o = r0 @ w1
    sh = sh_encode(d3.t(), degree=cfg.sh_degree)
    cin = torch.zeros((s_n, 32))
    for t in range(4):
        for c in range(4):
            cin[:, 2 * t + c % 2 + 8 * (c // 2)] = sh[:, 4 * t + c]
    cin[:, 17:] = o[:, 1:]
    cin = bf16_round(cin)
    hc0 = cin @ wc0
    rc0 = bf16_round(torch.relu(hc0))
    hc1 = rc0 @ wc1
    rc1 = bf16_round(torch.relu(hc1))
    rgb = torch.sigmoid(rc1 @ wc2)[:, :3]
    # the chain
    g2 = torch.zeros((s_n, 16))
    g2[:, :3] = bf16_round(g_out[1:4].t() * rgb * (1.0 - rgb))
    g_hc1 = bf16_round((g2 @ wc2t) * (hc1 > 0))
    g_hc0 = bf16_round((g_hc1 @ wc1t) * (hc0 > 0))
    g_h1 = g_hc0 @ wc0t
    g_h1[:, 0] = g_out[0] * torch.exp(o[:, 0].clamp(-15.0, 15.0))
    g_h1 = bf16_round(g_h1)
    g_h0 = (g_h1 @ w1t) * (h0 > 0)
    g_hi = bf16_round(g_h0)
    g_lo = bf16_round(g_h0 - g_hi)
    # weight gradients in g_w's layout; w0's rows in the A fragments' order
    d_w0 = a.t() @ g_hi
    for i, (kind, *_) in enumerate(layout.segs):
        if kind == SEG_FREQ:
            d_w0[8 * i:8 * i + 8] += a[:, 8 * i:8 * i + 8].t() @ g_lo
    col = np.arange(32 * nb)
    b, t, e = col // 32, col % 32 // 8, col % 8
    kpos = 32 * b + 16 * (e // 4) + 2 * t + e % 2 + 8 * (e // 2 % 2)
    d_w0k = torch.zeros_like(d_w0)
    d_w0k[kpos] = d_w0
    d_wc2 = (rc1.t() @ g2)[:, :8]
    g_w = torch.cat([m.reshape(-1) for m in (
        d_w0k, r0.t() @ g_h1, cin.t() @ g_hc0, rc0.t() @ g_hc1, d_wc2)])
    assert g_w.numel() == layout.gw_elems == tables.meta[4]
    return g_w, g_hi @ w0t


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tile_backward_on_the_packed_operands_matches_plain(name):
    """One tile's backward on the packed operands against _bwd_chunk: the
    five weight gradients, read back through _unpack_grads, per matrix
    within 5e-3 of max |plain| (the frequency rows enter as hi + lo pairs,
    2^-16 a product; the sums run in another order, which flips a rare bf16
    rounding); the features' cotangents, sent through the chain rule of the
    tables without the plain version's bf16 roundings of g_f (2^-9 a term),
    within 1e-2; and nothing lands in a padded row or column."""
    cfg = CONFIGS[name]
    tables = _tables(cfg, seed=3)
    x3, d3, g_out = _samples(257, 6)
    g_w, g_feat = _tile_backward(tables, cfg, x3, d3, g_out)
    ref = _zero_grads(tables.plain, x3.device)
    _bwd_chunk(tables.plain, cfg, x3.t(), d3.t(), g_out, ref)
    rows = tile_layout(cfg).rows
    assert not g_feat[:, rows < 0].any()
    # table gradients: d(sum(features * g_grid)) / d(tables) by autograd
    leaves = {k: [[t.float().requires_grad_(True) for t in ts]
                  for ts in tables.plain[k]]
              for k in ("lines", "planes", "vm_lines") if k in tables.plain}
    feats = cp_features({**tables.plain, **leaves}, cfg, x3.t())
    g_n = cfg.grid_feat_dim
    first = np.array([np.nonzero(rows == r)[0][0] for r in range(g_n)])
    (feats[:, :g_n] * g_feat[:, first]).sum().backward()
    g_tab = torch.zeros(tables.tab.numel())
    got = _unpack_grads(tables, cfg, g_tab, g_w)
    for key in ("sigma_mlp", "color_mlp"):
        for a, b in zip(got[key]["w"], ref[key]["w"]):
            assert a.shape == b.shape
            assert (a - b).abs().max() <= 5e-3 * b.abs().max(), key
    for key, tabs in leaves.items():
        assert [tuple(t.shape) for ts in got[key] for t in ts] == \
            [tuple(t.shape) for ts in tabs for t in ts]
        for ts, rs in zip(tabs, ref[key]):
            for t, r in zip(ts, rs):
                assert (t.grad - r).abs().max() <= 1e-2 * r.abs().max(), key


@pytest.mark.parametrize("name", list(CONFIGS))
def test_unpack_grads_cuts_the_tables_padding(name):
    """g_tab comes back as views in the params' shapes with the rows' pad
    columns cut away: an entry written at (row, column) of a padded table
    is read at the same place of the unpadded view."""
    cfg = CONFIGS[name]
    tables = _tables(cfg)
    g_tab = torch.arange(tables.tab.numel(), dtype=torch.float32)
    got = _unpack_grads(tables, cfg, g_tab,
                        torch.zeros(tile_layout(cfg).gw_elems))
    offs = table_row_offsets(tables.meta)
    k = 0
    for s, (res, rank) in enumerate(cfg.scales):
        for a in range(3):
            t = got["lines"][s][a]
            assert t.shape == (res, rank)
            assert t[res - 1, rank - 1] == offs[k] + (res - 1) * _pad8(rank) \
                + rank - 1
            k += 1
    for s, (pres, ch) in enumerate(cfg.planes):
        for p in range(3):
            t = got["planes"][s][p]
            assert t.shape == (pres, pres, ch)
            assert t[1, 2, ch - 1] == offs[k] + (pres + 2) * _pad8(ch) \
                + ch - 1
            k += 1
        for p in range(3):
            t = got["vm_lines"][s][p]
            assert t.shape == (pres, ch)
            assert t[2, 0] == offs[k] + 2 * _pad8(ch)
            k += 1
    assert k == len(offs)


def _tile_masks(tables, cfg, x3, d3):
    """The relu masks [S, 192] (h0, hc0, hc1) of the kernels' tile
    arithmetic on the unpacked operands (see _tile_forward): the first
    product's columns in segment order, the frequency values as hi + lo
    pairs, so its f32 sums run in another order than the plain version's."""
    w0, w1, wc0, wc1, _ = (torch.from_numpy(w) for w in _unpacked(tables))
    layout = tile_layout(cfg)
    grid, freq, cols = tile_features_plain(tables, cfg, x3.t())
    g = cfg.grid_feat_dim
    a = torch.zeros((x3.shape[1], 32 * layout.n_blocks))
    a[:, cols[:g, 0]] = grid
    hi = bf16_round(freq)
    a[:, cols[g:, 0]] = hi
    a[:, cols[g:, 1]] = bf16_round(freq - hi)
    h0 = a @ w0
    o = bf16_round(torch.relu(h0)) @ w1
    sh = sh_encode(d3.t(), degree=cfg.sh_degree)
    cin = torch.zeros((x3.shape[1], 32))
    for t in range(4):
        for c in range(4):
            cin[:, 2 * t + c % 2 + 8 * (c // 2)] = sh[:, 4 * t + c]
    cin[:, 17:] = o[:, 1:]
    hc0 = bf16_round(cin) @ wc0
    hc1 = bf16_round(torch.relu(hc0)) @ wc1
    return torch.cat([h0 > 0, hc0 > 0, hc1 > 0], dim=1)


def _plain_masks(tables, cfg, x3, d3):
    """The same masks by the plain version's arithmetic (_bwd_chunk)."""
    tp = tables.plain
    w0, w1 = (w.float() for w in tp["sigma_mlp"]["w"])
    wc0, wc1, _ = (w.float() for w in tp["color_mlp"]["w"])
    feat = cp_features(tp, cfg, x3.t())
    g = cfg.grid_feat_dim
    h0 = torch.cat([bf16_round(feat[:, :g]), feat[:, g:]], dim=-1) @ w0
    h1 = bf16_round(torch.relu(h0)) @ w1
    cin = bf16_round(torch.cat([sh_encode(d3.t(), degree=cfg.sh_degree),
                                h1[:, 1:]], dim=-1))
    hc0 = cin @ wc0
    hc1 = bf16_round(torch.relu(hc0)) @ wc1
    return torch.cat([h0 > 0, hc0 > 0, hc1 > 0], dim=1)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fragile_samples_cover_the_masks_that_a_reordered_sum_flips(name):
    """fragile_samples_plain names, from the plain version alone, the
    samples whose relu masks a reordering of the f32 sums may flip: every
    sample at which the tile arithmetic on the packed operands (another
    column order, hi + lo frequency pairs) disagrees with the plain masks
    lies inside the set, some do disagree, and the set stays below a tenth
    of the samples."""
    cfg = CONFIGS[name]
    tables = _tables(cfg, seed=3)
    x3, d3, _ = _samples(1 << 16, 7)
    differ = (_tile_masks(tables, cfg, x3, d3)
              != _plain_masks(tables, cfg, x3, d3)).any(dim=1)
    fragile = fragile_samples_plain(tables, cfg, x3.t(), d3.t())
    assert differ.any()
    assert not (differ & ~fragile).any()
    assert fragile.float().mean().item() <= 0.1
    # without the sums' and the frequency features' noise only the SH
    # components' few ulps are left
    assert fragile_samples_plain(tables, cfg, x3.t(), d3.t(), 0.0, 0.0) \
        .float().mean().item() <= 5e-3


@pytest.mark.parametrize("extra,blocks,staged", [
    ((), 10, True), (((64, 32),), 11, False),
    (((64, 32), (256, 64), (256, 64), (64, 32)), 16, False)])
def test_backward_operands_must_fit_a_blocks_shared_memory(extra, blocks,
                                                           staged):
    """The backward kernels keep wfwd, wbwd and a block's weight-gradient
    sums in shared memory when they fit, as at the default widths (10
    k-blocks); a wider config leaves the first sigma matrix and its
    transpose in device memory, and then every config the forward kernels
    take (16 k-blocks) fits a block too."""
    cfg = CPConfig(scales=CPConfig().scales + extra)
    tables = _tables(cfg)
    layout = tile_layout(cfg)
    assert layout.n_blocks == blocks
    need, w0_staged = backward_shared_bytes(layout)
    assert w0_staged == staged and need <= 232448
    full = 2 * (tables.wfwd.numel() + tables.wbwd.numel()) \
        + 4 * layout.gw_elems + 4 * 46
    assert need == full - (0 if staged else 2 * 2 * 2048 * blocks)
    assert (full <= 232448) == staged
    x3 = torch.zeros((3, 5))
    g_tab, g_w, count, idx = _backward_buffers(tables, cfg, x3)
    assert g_tab.numel() == tables.tab.numel() and not g_tab.any()
    assert g_w.numel() == layout.gw_elems == 2048 * blocks + 7680
    assert int(count) == 0 and idx.shape == (5,)
