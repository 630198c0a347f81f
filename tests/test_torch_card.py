"""Tests of the port's CUDA kernels on the card. They import no JAX, so
that they also run where only the port is installed:

    python3 -m pytest --noconftest -q tests/test_torch_card.py

Without a CUDA card every test here skips."""

import numpy as np
import pytest
import torch

from sealdnerf_tpu_torch.cli import base_parser, build_trainer, postprocess
from sealdnerf_tpu_torch.data.rays import get_rays
from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
from sealdnerf_tpu_torch.models.cp import (CPConfig, CPDNeRFConfig, CPField,
                                           init_cp, init_cp_dnerf,
                                           param_leaves)
from sealdnerf_tpu_torch.ops.field import (dyn_canonical_backward_plain,
                                           dyn_field_backward,
                                           dyn_field_backward_plain,
                                           dyn_field_forward,
                                           dyn_field_forward_plain,
                                           dyn_tower_backward_plain,
                                           dyn_warp_plain,
                                           field_backward,
                                           field_backward_plain,
                                           field_forward, field_forward_plain,
                                           field_train_forward, pack_tables,
                                           tile_features_plain)
from sealdnerf_tpu_torch.render.dynamic_grid import (DynGridConfig,
                                                     init_dyn_grid_state,
                                                     rebuild_dyn_density_grid)
from sealdnerf_tpu_torch.render.grid import (GridConfig, init_grid_state,
                                             update_density_grid)

pytestmark = pytest.mark.cuda

# the reference's own kernel tolerances (bf16 rounding, summation order)
SIGMA_TOL = dict(rtol=2e-2, atol=1e-4)
RGB_TOL = dict(rtol=2e-2, atol=1e-3)
# K2 vs plain, per grad leaf relative to max |plain|: atomics change the
# order of the f32 sums, and 1-ulp differences in exp, sigmoid, sin and cos
# can flip single bf16 roundings
GRAD_TOL = 1e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("kw", [{}, {"density_only": True},
                                {"lod_skip": (3,)}])
def test_field_kernel_matches_plain(card, kw):
    """K1 against its plain version at the full default config, on a
    ragged sample count."""
    cfg = CPConfig()
    tables = pack_tables(init_cp(torch.Generator().manual_seed(0), cfg, card),
                         cfg)
    rng = np.random.default_rng(1)
    m = 4096 + 37
    x3 = rng.uniform(-1, 1, (3, m)).astype(np.float32)
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    x3, d3 = torch.from_numpy(x3).to(card), torch.from_numpy(d3).to(card)
    before = field_forward.launches
    out = field_forward(tables, cfg, x3, d3, **kw).cpu()
    assert field_forward.launches == before + 1
    ref = field_forward_plain(tables, cfg, x3, d3, **kw).cpu()
    np.testing.assert_allclose(out[0], ref[0], **SIGMA_TOL)
    np.testing.assert_allclose(out[1:], ref[1:], **RGB_TOL)


def test_field_kernel_empty_input(card):
    cfg = CPConfig()
    tables = pack_tables(init_cp(torch.Generator().manual_seed(0), cfg, card),
                         cfg)
    x3 = torch.zeros((3, 0), device=card)
    assert field_forward(tables, cfg, x3, x3).shape == (4, 0)


def test_grid_sweep_on_card(card):
    """A full sweep with its jitter drawn on the card goes through one
    density-only kernel launch, and matches the plain field fed the same
    draws: density to the kernel tolerance, occupancy on >= 99.9 % of
    cells."""
    cfg = CPConfig()
    gcfg = GridConfig(grid_size=32)
    tables = pack_tables(init_cp(torch.Generator().manual_seed(0), cfg, card),
                         cfg)

    def density(fn):
        return lambda pts: fn(tables, cfg, pts.t().contiguous(), None,
                              density_only=True)[0]

    before = field_forward.launches
    got = update_density_grid(init_grid_state(gcfg, card),
                              density(field_forward), gcfg, full=True,
                              generator=torch.Generator(card).manual_seed(0))
    assert field_forward.launches == before + 1
    u = torch.rand((1, gcfg.grid_size ** 3, 3), device=card,
                   generator=torch.Generator(card).manual_seed(0))
    ref = update_density_grid(init_grid_state(gcfg, card),
                              density(field_forward_plain), gcfg, full=True,
                              noise_u=u)
    np.testing.assert_allclose(got["density_grid"].cpu(),
                               ref["density_grid"].cpu(), **SIGMA_TOL)
    assert (got["occ"] == ref["occ"]).float().mean().item() >= 0.999


# feat_dim 83, not a multiple of 16; one k-block of the forward kernels'
# layout mixes the two line scales
NARROW = dict(scales=((16, 8), (64, 24)), planes=((16, 8),))


def _unit_samples(card, m, seed):
    rng = np.random.default_rng(seed)
    x3 = rng.uniform(-1, 1, (3, m)).astype(np.float32)
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    return torch.from_numpy(x3).to(card), torch.from_numpy(d3).to(card)


@pytest.mark.parametrize("kw", [{}, {"density_only": True},
                                {"lod_skip": (1,)}])
@pytest.mark.parametrize("m", [1, 255, 257])
def test_field_kernel_narrow_config_and_ragged_counts(card, m, kw):
    """K1 at a config whose feat_dim is not a multiple of 16, on sample
    counts around its 16-sample tiles and 256-thread blocks."""
    cfg = CPConfig(**NARROW)
    tables = pack_tables(init_cp(torch.Generator().manual_seed(1), cfg, card),
                         cfg)
    x3, d3 = _unit_samples(card, m, 10 + m)
    out = field_forward(tables, cfg, x3, d3, **kw).cpu()
    ref = field_forward_plain(tables, cfg, x3, d3, **kw).cpu()
    np.testing.assert_allclose(out[0], ref[0], **SIGMA_TOL)
    np.testing.assert_allclose(out[1:], ref[1:], **RGB_TOL)


@pytest.mark.parametrize("narrow", [False, True])
def test_field_kernel_features_are_the_plain_ones(card, narrow):
    """Stage A of the forward kernels: the line and plane features that
    enter the first sigma product equal the plain version's bf16 features
    bit for bit, the frequency rows enter as hi + lo pairs that carry the
    f32 value to 2^-15 of it, padding columns are zero, and a skipped scale's
    columns stay zero."""
    cfg = CPConfig(**NARROW) if narrow else CPConfig()
    tables = pack_tables(init_cp(torch.Generator().manual_seed(2), cfg, card),
                         cfg)
    x3, d3 = _unit_samples(card, 4096 + 37, 11)
    x3[:, :3] = torch.tensor([[-1.0, 1.0, 0.0]] * 3, device=card)  # corners
    parts = {}
    field_forward(tables, cfg, x3, d3, parts=parts)
    feats = parts["features"].float()
    grid, freq, cols = tile_features_plain(tables, cfg, x3.t())
    g = cfg.grid_feat_dim
    assert torch.equal(feats[:, cols[:g, 0]], grid)
    hi, lo = feats[:, cols[g:, 0]], feats[:, cols[g:, 1]]
    # sin and cos may differ from torch's by an ulp of f32, which moves a
    # rare hi to the neighbouring bf16
    assert (hi != freq.to(torch.bfloat16).float()).float().mean() <= 1e-3
    assert ((hi + lo - freq).abs() <= 2.0 ** -15 * freq.abs() + 1e-6).all()
    used = torch.zeros(feats.shape[1], dtype=torch.bool)
    used[cols.reshape(-1)] = True
    assert not feats[:, ~used.to(card)].any()
    parts = {}
    field_forward(tables, cfg, x3, None, lod_skip=(1,), density_only=True,
                  parts=parts)
    r0 = cfg.scales[0][1]
    skipped = cols[r0:r0 + cfg.scales[1][1], 0]
    assert not parts["features"][:, skipped].any()
    assert torch.equal(parts["features"][:, cols[:r0, 0]].float(),
                       grid[:, :r0])


@pytest.mark.parametrize("kw", [{}, {"density_only": True},
                                {"lod_skip": (0,)}, {"lod_skip": (0, 1)}])
def test_dyn_field_kernel_at_t0_is_the_static_kernel(card, kw):
    """K3 at t = 0 equals K1 bit for bit at the narrow config too, on a count
    ragged against both kernels' tiles, and under density_only and
    lod_skip (a whole k-block skipped, and part of one)."""
    cfg = CPDNeRFConfig(**NARROW)
    params = init_cp_dnerf(torch.Generator().manual_seed(3), cfg, card)
    params["deform_mlp"]["w"][-1] *= 1e3
    tables = pack_tables(params, cfg)
    x3, d3 = _unit_samples(card, 3 * 256 + 19, 12)
    k3 = dyn_field_forward(tables, cfg, x3, d3, 0.0, **kw)
    assert torch.equal(k3, field_forward(tables, cfg, x3, d3, **kw))
    moved = dyn_field_forward(tables, cfg, x3, d3, 0.6, **kw)
    ref = dyn_field_forward_plain(tables, cfg, x3, d3, 0.6, **kw)
    assert not torch.equal(moved[0], k3[0])
    np.testing.assert_allclose(moved[0].cpu(), ref[0].cpu(), **SIGMA_TOL)
    np.testing.assert_allclose(moved[1:].cpu(), ref[1:].cpu(), **RGB_TOL)


def test_field_kernel_refuses_a_rank_that_is_no_multiple_of_8(card):
    cfg = CPConfig(scales=((16, 8), (64, 20)), planes=())
    tables = pack_tables(init_cp(torch.Generator().manual_seed(0), cfg, card),
                         cfg)
    x3, d3 = _unit_samples(card, 64, 13)
    with pytest.raises(NotImplementedError, match="multiples of 8"):
        field_forward(tables, cfg, x3, d3)


def _samples(card, m, seed):
    rng = np.random.default_rng(seed)
    x3 = rng.uniform(-1, 1, (3, m)).astype(np.float32)
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    g = rng.normal(size=(4, m)).astype(np.float32)
    g[:, ::3] = 0.0                    # samples with no cotangent
    return [torch.from_numpy(a).to(card) for a in (x3, d3, g)]


def test_field_backward_kernel_matches_plain(card):
    """K2 against its plain version at the full default config on a ragged
    sample count of mid size."""
    cfg = CPConfig()
    tables = pack_tables(init_cp(torch.Generator().manual_seed(0), cfg, card),
                         cfg)
    x3, d3, g = _samples(card, 8192 + 37, 2)
    before = field_backward.launches
    got = field_backward(tables, cfg, x3, d3, g)
    assert field_backward.launches == before + 1
    ref = field_backward_plain(tables, cfg, x3, d3, g)
    for a, b in zip(param_leaves(got), param_leaves(ref)):
        assert a.shape == b.shape
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= GRAD_TOL, (tuple(a.shape), err)


def test_one_train_step_kernel_matches_plain(card, tmp_path):
    """One step's loss and grads through K1/K2 and through their plain
    versions on the same rays, background and noise."""
    opt = postprocess(base_parser().parse_args(
        ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--ckpt",
         "scratch", "--workspace", str(tmp_path), "--num_rays", "1024"]))
    trainer, _ = build_trainer(opt, name="card")
    _, train, _ = make_synthetic_scene(n_train=4, n_val=1, res=64)
    trainer.mark_untrained_grid(train.poses, train.intrinsics)
    trainer.refresh_grid()
    batch = trainer.sample_batch(train.device(card), train.h, train.w)
    out = []
    for plain in (False, True):
        for p in param_leaves(trainer.params):
            p.grad = None
        k1, k2 = field_forward.launches, field_backward.launches
        loss, _ = trainer.loss_on(*batch, plain=plain)
        loss.backward()
        launched = (field_forward.launches - k1, field_backward.launches - k2)
        assert launched == ((0, 0) if plain else (1, 1)), launched
        out.append((loss.item(), [p.grad.clone()
                                  for p in param_leaves(trainer.params)]))
    (lk, gk), (lp, gp) = out
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    for a, b in zip(gk, gp):
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= GRAD_TOL, (tuple(a.shape), err)


def test_kernel_tables_follow_inplace_updates_on_card(card):
    cfg = CPConfig()
    params = init_cp(torch.Generator().manual_seed(0), cfg, card)
    leaves = [t.requires_grad_(True) for t in param_leaves(params)]
    field = CPField(params, cfg)
    x3, d3, _ = _samples(card, 4096, 3)
    t0 = field.kernel_tables(params)
    field_train_forward(params, cfg, x3, d3, t0).sum().backward()
    torch.optim.Adam(leaves, lr=0.1).step()
    t1 = field.kernel_tables(params)
    assert t1 is not t0
    assert torch.equal(t1.tab, pack_tables(params, cfg).tab)
    assert torch.equal(t1.wfwd, pack_tables(params, cfg).wfwd)
    assert not torch.equal(t1.wfwd, t0.wfwd)
    assert torch.equal(field_forward(t1, cfg, x3, d3),
                       field_forward(pack_tables(params, cfg), cfg, x3, d3))


def test_get_rays_with_a_card_generator(card):
    poses = torch.eye(4, device=card)[None]
    intr = torch.tensor([20.0, 20.0, 16.0, 16.0], device=card)
    rays = get_rays(poses, intr, 32, 32, 100,
                    generator=torch.Generator(card).manual_seed(3))
    assert rays["inds"].device.type == "cuda"
    assert rays["rays_d"].shape == (1, 100, 3)


def _dyn_tables(card, layers=8, gain=6.0 ** 0.5):
    """The full-width dynamic field from a seed, its deform tower re-gained
    so that it warps by ~0.1 (the undamped tower alone, gain 1, warps by
    ~6e-4)."""
    cfg = CPDNeRFConfig(num_layers_deform=layers)
    params = init_cp_dnerf(torch.Generator().manual_seed(0), cfg, card)
    wd = params["deform_mlp"]["w"]
    wd[-1] = wd[-1] * 1e3
    for k in range(1, len(wd) - 1):
        wd[k] = wd[k] * gain
    return cfg, pack_tables(params, cfg)


@pytest.mark.parametrize("kw", [{}, {"density_only": True},
                                {"lod_skip": (3,)}])
@pytest.mark.parametrize("t", [0.0, 0.37, 1.0])
def test_dyn_field_kernel_matches_plain(card, t, kw):
    """K3 against its plain version at the full default config, on a sample
    count that is ragged against its 256-sample tile; at t = 0 it equals K1
    bit for bit."""
    cfg, tables = _dyn_tables(card)
    rng = np.random.default_rng(2)
    m = 5 * 256 + 37
    x3 = rng.uniform(-1, 1, (3, m)).astype(np.float32)
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    x3, d3 = torch.from_numpy(x3).to(card), torch.from_numpy(d3).to(card)
    before, k1_before = dyn_field_forward.launches, field_forward.launches
    out = dyn_field_forward(tables, cfg, x3, d3, t, **kw)
    assert dyn_field_forward.launches == before + 1
    assert field_forward.launches == k1_before
    ref, dx = dyn_field_forward_plain(tables, cfg, x3, d3, t,
                                      return_deform=True, **kw)
    assert (dx.abs().mean().item() > 1e-2) == (t != 0.0)
    np.testing.assert_allclose(out[0].cpu(), ref[0].cpu(), **SIGMA_TOL)
    np.testing.assert_allclose(out[1:4].cpu(), ref[1:4].cpu(), **RGB_TOL)
    if t == 0.0:
        assert torch.equal(out, field_forward(tables, cfg, x3, d3, **kw))
    on_card = dyn_field_forward(tables, cfg, x3, d3,
                                torch.tensor(t, device=card), **kw)
    assert torch.equal(out, on_card)


def test_dyn_field_kernel_other_depths_and_refusals(card):
    """Two deform matrices (no hidden one) and a ragged tail shorter than a
    warp; a tower the kernel is not built for raises instead of falling
    back."""
    cfg, tables = _dyn_tables(card, layers=2)
    x3 = torch.rand((3, 19), device=card) * 2 - 1
    out = dyn_field_forward(tables, cfg, x3, None, 0.5, density_only=True)
    ref = dyn_field_forward_plain(tables, cfg, x3, None, 0.5,
                                  density_only=True)
    np.testing.assert_allclose(out[0].cpu(), ref[0].cpu(), **SIGMA_TOL)
    small = CPDNeRFConfig(hidden_dim_deform=64)
    ts = pack_tables(init_cp_dnerf(torch.Generator().manual_seed(0), small,
                                   card), small)
    with pytest.raises(NotImplementedError, match="hidden_dim_deform=128"):
        dyn_field_forward(ts, small, x3, None, 0.5, density_only=True)


def test_dyn_grid_rebuild_through_the_kernel(card):
    """A rebuild of a small dynamic grid on the card: one K3 launch per time
    bin, every bin occupied, no K1 launch."""
    cfg, tables = _dyn_tables(card)
    gcfg = DynGridConfig(grid_size=16, time_size=16, density_thresh=10.0)

    def density(pts, t):
        return dyn_field_forward(tables, cfg, pts.t().contiguous(), None, t,
                                 density_only=True)[0]

    before, k1_before = dyn_field_forward.launches, field_forward.launches
    st = rebuild_dyn_density_grid(
        init_dyn_grid_state(gcfg, card), density, gcfg,
        generator=torch.Generator(card).manual_seed(0))
    assert dyn_field_forward.launches == before + 16
    assert field_forward.launches == k1_before
    occ = st["occ"].reshape(16, -1)
    assert bool(occ.any(dim=1).all()) and int(st["iter_density"]) == 1


def _leaf_errs(got, ref):
    out = []
    for a, b in zip(param_leaves(got), param_leaves(ref)):
        assert a.shape == b.shape
        diff = (a - b).abs().max().item()
        out.append(diff / max(b.abs().max().item(), 1e-30) if diff else 0.0)
    return out


def _rel(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def _hold_k4_stages(tables, cfg, x3, d3, g, got, parts):
    """K4's stages, each on the kernel's own input, against the plain
    version's stages. The limits come from profiling/torch_dyn_bwd_seeds.py
    (three seeds, 8,229 and 262,181 samples, towers of eight and two
    matrices, undamped and re-gained).

    The activations that the tower's backward recomputes: an mma sums in
    another order than a matmul, so 3.8e-4 to 7.1e-4 of the hidden entries
    round to the neighbouring bf16 and about 1e-6 of them land on the other
    side of the relu, which 3.7e-4 to 1.5e-3 of the samples then hold. Such a
    sample's share of every earlier matrix's gradient changes as a whole, and
    with random cotangents an entry is a random-walk sum, so those samples
    move a leaf by about the root of their share whatever the sample count:
    2e-3 to 1.1e-2 of its maximum (2.1e-2 re-gained), the same distance at
    which the f32 plain chain lies from itself with f64 sums. On the
    kernel's own activations no mask can differ, and the tower's backward
    then lies 1.4e-4 to 4.9e-4 from the plain stage, with two matrices below
    3e-6. The time rows are rounded to bf16 after the sum over all samples:
    one rounding that differs moves them by up to 2^-7 (measured up to
    4.1e-3)."""
    nx = cfg.deform_space_dim
    xw, acts_p = dyn_warp_plain(tables, cfg, x3, 0.37)
    dxw = (parts["xw"] - xw).abs()
    ref, g_x = dyn_canonical_backward_plain(tables, cfg, parts["xw"], d3,
                                            0.37, g)
    assert max(_leaf_errs({k: got[k] for k in ref}, ref)) <= GRAD_TOL
    assert _rel(parts["g_x"], g_x) <= GRAD_TOL
    live = parts["live"]
    assert torch.equal(live.sort().values,
                       torch.nonzero(g.abs().amax(dim=0) > 0)[:, 0])
    acts_k = [a.float() for a in parts["acts"]]
    acts_p = [a[live] for a in acts_p]
    assert torch.equal(acts_k[0], acts_p[0])
    hid_k, hid_p = torch.cat(acts_k[1:], 1), torch.cat(acts_p[1:], 1)
    assert (hid_k != hid_p).float().mean().item() <= 2e-3
    assert ((hid_k > 0) != (hid_p > 0)).any(dim=1).float().mean().item() \
        <= 5e-3
    ref = dyn_tower_backward_plain(tables, cfg, 0.37, acts_k,
                                   parts["g_x"][:, live])["w"]
    kern = got["deform_mlp"]["w"]
    assert _rel(kern[0][nx:], ref[0][nx:]) <= GRAD_TOL
    errs = [_rel(kern[0][:nx], ref[0][:nx])] + [
        _rel(a, b) for a, b in zip(kern[1:], ref[1:])]
    assert max(errs) <= 1e-3, errs
    return xw, dxw


@pytest.mark.parametrize("layers", [8, 2])
def test_dyn_field_backward_kernel_matches_plain(card, layers):
    """K4 against its plain version at the full default config on a train
    step's sample count, ragged against all its tiles (64 and 256), a third
    of the cotangents zero, with the undamped tower, and with a tower of two
    matrices (no hidden one, warp 0.11).

    Each stage is held on the kernel's own input (_hold_k4_stages). End to
    end the whole is held to 5e-2: over three seeds the worst leaf lies up to
    1.4e-2 and, with the two-matrix tower's warp of 0.11, 2.4e-2 away."""
    cfg, tables = _dyn_tables(card, layers=layers, gain=1.0)
    x3, d3, g = _samples(card, 4096 * 64 + 37, 4)
    before = dyn_field_backward.launches
    parts = {}
    got = dyn_field_backward(tables, cfg, x3, d3, 0.37, g, parts=parts)
    assert dyn_field_backward.launches == before + 1
    assert all(w.abs().max().item() > 0 for w in got["deform_mlp"]["w"])
    assert parts["g_x"][:, ::3].abs().max().item() == 0.0
    ref = dyn_field_backward_plain(tables, cfg, x3, d3, 0.37, g)
    assert max(_leaf_errs(got, ref)) <= 5e-2, _leaf_errs(got, ref)
    _, dxw = _hold_k4_stages(tables, cfg, x3, d3, g, got, parts)
    assert dxw.max().item() <= 1e-3 and dxw.mean().item() <= 1e-6
    on_card = dyn_field_backward(tables, cfg, x3, d3,
                                 torch.tensor(0.37, device=card), g)
    assert max(_leaf_errs(on_card, got)) <= 1e-4     # atomics reorder sums


def test_dyn_field_backward_stages_with_a_warping_tower(card):
    """The re-gained tower (warp 0.1) at a train step's sample count: every
    stage on the kernel's own input."""
    cfg, tables = _dyn_tables(card)
    x3, d3, g = _samples(card, 4096 * 64 + 37, 5)
    parts = {}
    got = dyn_field_backward(tables, cfg, x3, d3, 0.37, g, parts=parts)
    xw, dxw = _hold_k4_stages(tables, cfg, x3, d3, g, got, parts)
    assert (xw - x3).abs().mean().item() > 1e-2
    assert dxw.mean().item() <= 1e-5


def test_dyn_field_backward_at_t0_and_zero_cotangents(card):
    """At t = 0 every deform gradient is exactly 0 and the canonical ones are
    K2's; all-zero cotangents give all-zero gradients; an empty input gives
    zeros of the params' shapes."""
    cfg, tables = _dyn_tables(card)
    x3, d3, g = _samples(card, 4096 + 37, 6)
    got = dyn_field_backward(tables, cfg, x3, d3, 0.0, g)
    assert all(w.abs().max().item() == 0.0 for w in got["deform_mlp"]["w"])
    k2 = field_backward(tables, cfg, x3, d3, g)
    assert max(_leaf_errs({k: got[k] for k in k2}, k2)) <= GRAD_TOL
    zero = dyn_field_backward(tables, cfg, x3, d3, 0.37, torch.zeros_like(g))
    assert all(w.abs().max().item() == 0.0 for w in param_leaves(zero))
    e = torch.zeros((3, 0), device=card)
    before = dyn_field_backward.launches
    empty = dyn_field_backward(tables, cfg, e, e, 0.37,
                               torch.zeros((4, 0), device=card))
    assert dyn_field_backward.launches == before
    assert [tuple(w.shape) for w in empty["deform_mlp"]["w"]] == \
        [(76, 128)] + [(128, 128)] * 6 + [(128, 3)]


def test_field_backward_unchanged_by_the_shared_body(card):
    """K2 after its per-sample body moved into a header shared with K4: the
    same gradients as the plain version at a train step's sample count, and
    K4 at t = 0 runs that body to K2's results."""
    cfg = CPConfig()
    tables = pack_tables(init_cp(torch.Generator().manual_seed(0), cfg, card),
                         cfg)
    x3, d3, g = _samples(card, 4096 * 16 + 5, 7)
    got = field_backward(tables, cfg, x3, d3, g)
    ref = field_backward_plain(tables, cfg, x3, d3, g)
    assert max(_leaf_errs(got, ref)) <= 1e-3, _leaf_errs(got, ref)


def test_one_dynamic_train_step_kernel_matches_plain(card, tmp_path):
    """One dynamic step's loss and grads through K3/K4 and through their
    plain versions on the same rays, time, background, noise and regulariser
    points, mid-anneal."""
    from sealdnerf_tpu_torch import main_dnerf
    opt = main_dnerf.parse_args(
        ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--ckpt",
         "scratch", "--workspace", str(tmp_path), "--num_rays", "1024"])
    trainer, _ = build_trainer(opt, name="card", dynamic=True,
                               lr_net=opt.lr_net)
    _, train, _ = make_synthetic_scene(n_train=4, n_val=1, res=64,
                                       dynamic=True)
    trainer.mark_untrained_grid(train.poses, train.intrinsics)
    trainer.global_step = 300
    trainer.refresh_grid()
    k3 = dyn_field_forward.launches
    trainer.refresh_grid()
    assert dyn_field_forward.launches == k3 + 8
    assert trainer._dyn_host_counts() == (2, 16)
    batch = trainer.sample_batch(train.device(card), train.h, train.w)
    out = []
    for plain in (False, True):
        for p in param_leaves(trainer.params):
            p.grad = None
        k3, k4 = dyn_field_forward.launches, dyn_field_backward.launches
        loss, _ = trainer.loss_on(*batch, plain=plain)
        loss.backward()
        launched = (dyn_field_forward.launches - k3,
                    dyn_field_backward.launches - k4)
        assert launched == ((0, 0) if plain else (1, 1)), launched
        out.append((loss.item(), [p.grad.clone()
                                  for p in param_leaves(trainer.params)]))
    (lk, gk), (lp, gp) = out
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    for a, b in zip(gk, gp):
        err = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        assert err <= GRAD_TOL, (tuple(a.shape), err)
