"""The forward kernels' packed operands (sealdnerf_tpu_torch/ops/field.py:
TileLayout, pack_tables' `wfwd` and the tail of `meta`), checked on the CPU
by unpacking them with loops written from the layout's description, and by
running the kernels' tile arithmetic in PyTorch on the unpacked operands
against the plain version."""

import numpy as np
import pytest
import torch

from sealdnerf_tpu_torch.models.cp import (CPConfig, CPDNeRFConfig, CPField,
                                           cp_features, init_cp,
                                           init_cp_dnerf, param_leaves)
from sealdnerf_tpu_torch.ops.field import (SEG_LINE, SEG_PLANE, SEG_ZERO,
                                           _check_kernel_cfg,
                                           field_forward_plain, pack_tables,
                                           table_row_offsets,
                                           tile_features_plain, tile_layout)
from sealdnerf_tpu_torch.ops.hat import bf16_round
from sealdnerf_tpu_torch.ops.sh_encode import sh_encode

CONFIGS = {
    "full": CPConfig(),
    # feat_dim 83: not a multiple of 16; one k-block mixes two line scales
    "narrow": CPConfig(scales=((16, 8), (64, 24)), planes=((16, 8),)),
    # no planes, another frequency degree, a rank of 40
    "lines": CPConfig(scales=((32, 40),), planes=(), freq_degree=3),
}


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
    assert q + 28 * nb == len(meta)
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
            assert (res, stride) == cfg.scales[sub] and stride % 8 == 0
            for a in range(3):
                assert off[a] % 8 == 0
                want = tables.plain["lines"][sub][a].float()
                assert torch.equal(tab[off[a]:off[a] + 8],
                                   want[0, first:first + 8])
                assert torch.equal(
                    tab[off[a] + stride * (res - 1):][:8],
                    want[res - 1, first:first + 8])
            n_line += 8
        elif kind == SEG_PLANE:
            _, _, s, first = tile_layout(cfg).segs[i]
            assert (res, stride) == cfg.planes[s] and stride % 8 == 0
            assert off[0] % 8 == 0 and off[1] % 8 == 0
            pl = tables.plain["planes"][s][sub].float()
            vl = tables.plain["vm_lines"][s][sub].float()
            at = off[0] + (3 * res + 2) * stride
            assert torch.equal(tab[at:at + 8], pl[3, 2, first:first + 8])
            assert torch.equal(tab[off[1] + stride:][:8],
                               vl[1, first:first + 8])
            n_plane += 8
    assert n_line == sum(r for _, r in cfg.scales)
    assert n_plane == sum(3 * c for _, c in cfg.planes)


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
    rng = np.random.default_rng(5)
    x3 = torch.from_numpy(rng.uniform(-1, 1, (3, 257)).astype(np.float32))
    d3 = rng.normal(size=(3, 257)).astype(np.float32)
    d3 = torch.from_numpy(d3 / np.linalg.norm(d3, axis=0, keepdims=True))
    got = _tile_forward(tables, cfg, x3, d3, lod_skip)
    ref = field_forward_plain(tables, cfg, x3, d3, lod_skip=lod_skip)
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(got[1:], ref[1:], rtol=0, atol=2e-4)


@pytest.mark.parametrize("scales,planes,ok", [
    (((16, 8), (64, 24)), ((16, 8),), True),
    (((16, 8), (64, 20)), (), False),
    (((16, 8),), ((16, 4),), False),
    (((8, 64),) * 8, ((8, 8),) * 4, False),      # 17 k-blocks
])
def test_check_kernel_cfg_takes_only_whole_segments(scales, planes, ok):
    cfg = CPConfig(scales=scales, planes=planes)
    tables = _tables(cfg)
    assert (tile_layout(cfg) is not None) == ok
    assert (tables.wfwd.numel() > 0) == ok
    if ok:
        _check_kernel_cfg(cfg)
    else:
        with pytest.raises(NotImplementedError,
                           match="multiples of 8|feature columns"):
            _check_kernel_cfg(cfg)
        assert _tile_meta(tables)[0] == 0


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
    assert torch.equal(t1.wbuf, fresh.wbuf)
    assert not torch.equal(t1.wfwd, t0.wfwd)
    np.testing.assert_array_equal(_unpacked(t1)[3],
                                  t1.plain["color_mlp"]["w"][1].float())
