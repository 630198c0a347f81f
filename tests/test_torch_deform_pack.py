"""The deform tower's operands as the dynamic kernels (K3 and K4,
sealdnerf_tpu_torch/ops/csrc/deform_tower.cuh and dyn_field_bwd.cu) read
them, on the CPU: the packed matrix images (128-byte swizzle included)
unpack to the tower's matrices, and a PyTorch emulation of the kernels'
arithmetic, working from those images and from the backward's scratch tile
images with the kernels' rounding points, agrees with the plain versions
(`dyn_warp_plain`, `dyn_tower_backward_plain`) and with the reference's
tower (`cp_dnerf_deform` of the JAX package).

Tolerances:
- emulation vs plain, forward: 2e-4 absolute on the warped positions, and at
  most 2e-3 of the hidden activations differing at all. Both round at the
  same points; their f32 sums run in another order, which can flip a bf16
  rounding now and then.
- emulation vs the reference's XLA tower: 2e-2 of max |dx|, the reference's
  own kernel-vs-XLA tolerance (XLA rounds the frequency features and the
  time inputs to bf16, the kernels keep the time bias in f32).
- emulation vs plain, backward, on the same activations and g_x: 1e-3 of
  max |plain| per matrix (the f32 sums of the weight gradients run over
  tiles in another order), 1e-2 for the time rows (their f32 sum is rounded
  to bf16 once, and one rounding that differs moves them by 2^-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sealdnerf_tpu.models import cp as jcp
from sealdnerf_tpu_torch.models import cp as tcp
from sealdnerf_tpu_torch.ops.field import (_DEFORM_HID, _DEFORM_LAST_ROWS,
                                           _DEFORM_TILE, _time_cond_vec,
                                           _unpack_deform_grads,
                                           _unswizzle_tiles,
                                           deform_ex_columns,
                                           dyn_tower_backward_plain,
                                           dyn_warp_plain, pack_tables,
                                           sw128_positions, unpack_deform)
from sealdnerf_tpu_torch.ops.hat import bf16_round

# (deform matrices, multires_deform): the default tower, one without hidden
# matrices, one deeper than the kernels' shared memory holds (its hidden
# matrices stream through the ring), one whose first matrix takes 128 inputs
CASES = {"default": (8, 10), "two": (2, 10), "sixteen": (16, 10),
         "wide": (4, 20)}
T = 0.37


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(layers, multires, seed=0, m=200):
    kw = dict(scales=((8, 4),), planes=(), num_layers_deform=layers,
              multires_deform=multires)
    jc, tc = jcp.CPDNeRFConfig(**kw), tcp.CPDNeRFConfig(**kw)
    params = jcp.init_cp_dnerf(jax.random.PRNGKey(seed), jc)
    wd = params["deform_mlp"]["w"]
    # undamped and re-gained, so that the tower warps visibly (~0.1)
    wd[-1] = wd[-1] * 1e3
    for k in range(1, len(wd) - 1):
        wd[k] = wd[k] * 6.0 ** 0.5
    tp = tcp.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    g_x = rng.normal(size=(m, 3)).astype(np.float32)
    return jc, tc, params, pack_tables(tp, tc), x, g_x


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return _setup(*CASES[request.param])


def _ex_kernel(x, tables):
    """ex as the kernels build it, pair by pair (deform_tower.cuh ex_pair):
    lane t of a quad holds pairs p = 2 K t + i, (sin, cos)(2^f x_a) for p =
    3 f + a, then (x_0, x_1), (x_2, 0), zeros, in A-fragment columns 16 (i //
    2) + 8 (i % 2) + 2 t (+ 1), rounded to bf16; [M, 128]."""
    n_freq, in_pad = tables.dmeta[4], tables.dmeta[3]
    k = 4 if in_pad <= 64 else 8
    ex = torch.zeros((x.shape[0], _DEFORM_HID))
    for t in range(4):
        for i in range(2 * k):
            p = 2 * k * t + i
            c = 16 * (i // 2) + 8 * (i % 2) + 2 * t
            if p < 3 * n_freq:
                v = x[:, p % 3] * float(1 << (p // 3))
                ex[:, c], ex[:, c + 1] = torch.sin(v), torch.cos(v)
            elif p == 3 * n_freq:
                ex[:, c], ex[:, c + 1] = x[:, 0], x[:, 1]
            elif p == 3 * n_freq + 1:
                ex[:, c] = x[:, 2]
    return bf16_round(ex)


def _emulated_forward(tables, cfg, x):
    """The kernels' tower forward from the packed images: (xw [M, 3], acts
    [n_layers] of [M, 128], ex first)."""
    mats = [w.float() for w in unpack_deform(tables)]
    k0 = mats[0].shape[1]
    tb, flag, _ = _time_cond_vec(tables, cfg, T, x.device)
    acts = [_ex_kernel(x, tables)]
    h = acts[0][:, :k0] @ mats[0].t() + tb
    for w in mats[1:]:
        acts.append(bf16_round(torch.relu(h)))
        h = acts[-1] @ w.t()
    dx = torch.where(flag != 0.0, h[:, :3], torch.zeros_like(h[:, :3]))
    return x + dx, acts


def _tile_images(rows):
    """[n_tiles * 64, 128] bf16 -> the flat tile images the kernels write."""
    pos = sw128_positions(_DEFORM_TILE, _DEFORM_HID)
    tiles = rows.reshape(-1, _DEFORM_TILE * _DEFORM_HID)
    out = torch.empty_like(tiles)
    out[:, pos] = tiles
    return out.reshape(-1)


def _emulated_backward(tables, cfg, acts, g_x):
    """The tower's backward as tower_bwd_kernel and tower_wgrad_kernel do it:
    the chain on the transposed images, masked by the kept activations, the
    output gradients and inputs written as scratch tile images, and the
    weight gradients as products over those tiles."""
    mats = [w.float() for w in unpack_deform(tables)]
    n_layers = len(mats)
    m = g_x.shape[0]
    tiles = -(-m // _DEFORM_TILE)
    pad = tiles * _DEFORM_TILE - m

    def padded(a):
        return torch.cat([a, a.new_zeros((pad, a.shape[1]))])

    G = [None] * n_layers
    G[-1] = g_x.new_zeros((m, _DEFORM_HID))
    G[-1][:, :3] = bf16_round(g_x)
    g = (G[-1][:, :_DEFORM_LAST_ROWS] @ mats[-1]) * (acts[-1] > 0)
    for l in range(n_layers - 2, 0, -1):
        G[l] = bf16_round(g)
        g = (G[l] @ mats[l]) * (acts[l] > 0)
    rowsum = g.sum(dim=0)
    G[0] = bf16_round(g)
    # the columns the kernel leaves unwritten (the last matrix's gradient past
    # its first 32, ex past the first matrix's inputs) hold whatever the
    # scratch held: NaN here, which must reach no flushed entry
    k0 = mats[0].shape[1]
    G[-1][:, 32:] = float("nan")
    acts = [acts[0].clone()] + acts[1:]
    acts[0][:, k0:] = float("nan")
    gscr = torch.cat([_tile_images(padded(a).to(torch.bfloat16)) for a in G])
    ascr = torch.cat([_tile_images(padded(a).to(torch.bfloat16))
                      for a in acts])
    gt = _unswizzle_tiles(gscr, n_layers, m).float()
    at = _unswizzle_tiles(ascr, n_layers, m).float()
    g_wdef = torch.zeros((n_layers, _DEFORM_HID, _DEFORM_HID))
    for l in range(n_layers):
        for t0 in range(0, m, _DEFORM_TILE):
            g_wdef[l] += gt[l, t0:t0 + _DEFORM_TILE].t() \
                @ at[l, t0:t0 + _DEFORM_TILE]
    g_wdef[0][:, k0:] = 0.0
    g_wdef[-1][3:] = 0.0
    tvec = _time_cond_vec(tables, cfg, T, g_x.device)[2]
    g_wtime = bf16_round(tvec)[:, None] * bf16_round(rowsum)[None, :]
    return _unpack_deform_grads(tables, cfg, g_wdef.reshape(-1),
                                g_wtime)["w"]


@pytest.mark.parametrize("name", list(CASES))
def test_packed_images_unpack_to_the_matrices(name):
    """Every matrix image of wdef, unswizzled, is the tower's matrix
    output-major; the first without its time rows, zero-padded to a
    multiple of 64 inputs; the last padded to 16 rows; the images 1024-byte
    aligned, as the kernels' bulk copies and descriptors need."""
    _, tc, _, tables, _, _ = _setup(*CASES[name], m=1)
    n_layers, hid, nx, in_pad, nfreq, *offs = tables.dmeta
    wd = tables.plain["deform_mlp"]["w"]
    assert (n_layers, hid, nx) == (len(wd), 128, 3 + 6 * nfreq)
    assert in_pad == -(-nx // 16) * 16
    assert all(o % 512 == 0 for o in offs)
    mats = unpack_deform(tables)
    assert mats[0].shape == (hid, -(-in_pad // 64) * 64)
    cols = deform_ex_columns(nfreq, in_pad)
    assert len(set(cols.tolist())) == nx and int(cols.max()) < in_pad
    assert torch.equal(mats[0][:, cols], wd[0][:nx].t())
    rest = torch.ones(mats[0].shape[1], dtype=torch.bool)
    rest[cols] = False
    assert not mats[0][:, rest].any()
    for l in range(1, n_layers - 1):
        assert torch.equal(mats[l], wd[l].t())
    assert mats[-1].shape == (16, hid)
    assert torch.equal(mats[-1][:3], wd[-1].t()) and not mats[-1][3:].any()
    sizes = [mat.numel() for mat in mats]
    assert offs == [sum(sizes[:l]) for l in range(n_layers)]
    assert tables.wdef.numel() == sum(sizes)


def test_swizzle_positions_are_a_permutation_of_the_128_byte_pattern():
    """sw128_positions: a permutation; each 8-row group of a block of 64
    columns fills one 1024-byte atom; chunk c of row r lands at c ^ r % 8."""
    pos = sw128_positions(16, 128)
    assert torch.equal(pos.sort().values, torch.arange(16 * 128))
    p = pos.view(16, 16, 8)                      # row, chunk of 8, element
    for r in range(16):
        for c in range(16):
            blk, ch = divmod(c, 8)
            want = (blk * 16 + r) * 64 + (ch ^ (r % 8)) * 8
            assert torch.equal(p[r, c], want + torch.arange(8))


def test_emulated_forward_matches_plain_and_the_reference(case):
    jc, tc, params, tables, x, _ = case
    xt = torch.from_numpy(x)
    xw, acts = _emulated_forward(tables, tc, xt)
    xw_p, acts_p = dyn_warp_plain(tables, tc, xt.t().contiguous(), T)
    nx = tc.deform_space_dim
    # the kernels' ex holds the reference's freq_encode entries, bit for bit
    cols = deform_ex_columns(tables.dmeta[4], tables.dmeta[3])
    assert torch.equal(acts[0][:, cols], acts_p[0])
    np.testing.assert_allclose(xw.numpy(), xw_p.t().numpy(), atol=2e-4,
                               rtol=0)
    hid_e, hid_p = torch.cat(acts[1:], 1), torch.cat(acts_p[1:], 1)
    assert (hid_e != hid_p).float().mean().item() <= 2e-3
    dx_ref = np.asarray(jcp.cp_dnerf_deform(params, jc, jnp.asarray(x), T))
    dx = (xw - xt).numpy()
    assert np.abs(dx).mean() > 1e-2             # the tower warps visibly
    np.testing.assert_allclose(dx, dx_ref, rtol=0,
                               atol=2e-2 * np.abs(dx_ref).max())


def test_emulated_backward_matches_plain(case):
    _, tc, _, tables, x, g_x = case
    xt, gt = torch.from_numpy(x), torch.from_numpy(g_x)
    _, acts = _emulated_forward(tables, tc, xt)
    got = _emulated_backward(tables, tc, acts, gt)
    nx = tc.deform_space_dim
    cols = deform_ex_columns(tables.dmeta[4], tables.dmeta[3])
    acts_plain = [acts[0][:, cols]] + acts[1:]
    ref = dyn_tower_backward_plain(tables, tc, T, acts_plain,
                                   gt.t().contiguous())["w"]
    assert [tuple(a.shape) for a in got] == [tuple(b.shape) for b in ref]

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    assert rel(got[0][:nx], ref[0][:nx]) <= 1e-3
    assert rel(got[0][nx:], ref[0][nx:]) <= 1e-2
    for l in range(1, len(ref)):
        assert rel(got[l], ref[l]) <= 1e-3, l
    assert all(w.abs().max() > 0 for w in got)
