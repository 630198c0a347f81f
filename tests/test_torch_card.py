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
                                           field_train_forward,
                                           fragile_samples_plain, pack_tables,
                                           tile_features_plain)
from sealdnerf_tpu_torch.render.dynamic_grid import (DynGridConfig,
                                                     init_dyn_grid_state,
                                                     rebuild_dyn_density_grid)
from sealdnerf_tpu_torch.render.grid import (GridConfig, init_grid_state,
                                             update_density_grid)
from sealdnerf_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

# the reference's own kernel tolerances (bf16 rounding, summation order)
SIGMA_TOL = dict(rtol=2e-2, atol=1e-4)
RGB_TOL = dict(rtol=2e-2, atol=1e-3)
# K2 vs plain, per grad leaf relative to max |plain|: atomics change the
# order of the f32 sums, and 1-ulp differences in exp, sigmoid, sin and cos
# can flip single bf16 roundings
GRAD_TOL = 1e-2
# the same over ALL samples, those included whose relu masks the mma's
# summation order flips (_stable_cotangents): one such sample moves an entry
# of a fine table by its whole share (measured 2.1e-2 to 3.2e-2 on 262,181
# random samples and cotangents)
WHOLE_CALL_TOL = 5e-2


def _calls(k: int) -> int:
    """The calls that reached kernel K<k> in this process (the counter
    "k<k>.calls" of utils/profiling.py)."""
    return profiling.tally(traced=False)["counters"].get(f"k{k}.calls", 0)


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
    before = _calls(1)
    out = field_forward(tables, cfg, x3, d3, **kw).cpu()
    assert _calls(1) == before + 1
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

    before = _calls(1)
    got = update_density_grid(init_grid_state(gcfg, card),
                              density(field_forward), gcfg, full=True,
                              generator=torch.Generator(card).manual_seed(0))
    assert _calls(1) == before + 1
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
    """It refused such a rank once; now pack_tables pads the tables' rows to
    multiples of 8 columns, and K1 matches plain at a rank of 20 and a
    plane of 4 channels, on a ragged count."""
    cfg = CPConfig(scales=((16, 8), (64, 20)), planes=((16, 4),))
    tables = pack_tables(init_cp(torch.Generator().manual_seed(0), cfg, card),
                         cfg)
    x3, d3 = _unit_samples(card, 1000 + 13, 13)
    for kw in ({}, {"density_only": True}, {"lod_skip": (1,)}):
        out = field_forward(tables, cfg, x3, d3, **kw).cpu()
        ref = field_forward_plain(tables, cfg, x3, d3, **kw).cpu()
        np.testing.assert_allclose(out[0], ref[0], **SIGMA_TOL)
        np.testing.assert_allclose(out[1:], ref[1:], **RGB_TOL)
    parts = {}
    field_forward(tables, cfg, x3, d3, parts=parts)
    grid, _, cols = tile_features_plain(tables, cfg, x3.t())
    assert torch.equal(parts["features"].float()[:, cols[:cfg.grid_feat_dim,
                                                         0]], grid)


def _samples(card, m, seed):
    rng = np.random.default_rng(seed)
    x3 = rng.uniform(-1, 1, (3, m)).astype(np.float32)
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    g = rng.normal(size=(4, m)).astype(np.float32)
    g[:, ::3] = 0.0                    # samples with no cotangent
    return [torch.from_numpy(a).to(card) for a in (x3, d3, g)]


def _stable_cotangents(tables, cfg, positions, d3, g):
    """g with the cotangents zeroed of the samples that the plain version
    alone calls fragile at `positions`: a relu's pre-activation lies within
    its summation noise of 0 (fragile_samples_plain). The kernels recompute
    the forward as the forward kernels compute it, whose sums run in the
    mma's order: a few in ten thousand samples hold a pre-activation that
    the plain version's sums put on the other side of 0, and such a sample's
    share of every gradient changes as a whole. The set is chosen without
    the kernel: it takes 3 to 7 % of the samples."""
    fragile = fragile_samples_plain(tables, cfg, positions.t(), d3.t())
    assert fragile.float().mean().item() <= 0.1
    g = g.clone()
    g[:, fragile] = 0.0
    return g


# 16 k-blocks, the most the kernels take: the backward then leaves the first
# sigma matrix and its transpose in device memory
WIDE = dict(scales=CPConfig().scales + ((64, 32), (256, 64), (256, 64)),
            planes=CPConfig().planes + ((64, 8),))


@pytest.mark.parametrize("case", ["ragged", "all live", "none live",
                                  "one tile", "padded ranks", "wide"])
def test_field_backward_kernel_matches_plain(card, case):
    """K2 against its plain version on a ragged sample count of mid size, a
    third of the cotangents zero; with every sample live; with none; on
    fewer samples than a tile; at a narrow config whose ranks and channels
    are padded; and at the widest config the kernels take. What it recomputed equals K1's output bit for bit;
    every leaf lies within WHOLE_CALL_TOL of the plain version's, and within
    GRAD_TOL on the stable samples (_stable_cotangents)."""
    cfg = {"padded ranks": CPConfig(scales=((16, 4), (64, 20)),
                                    planes=((16, 4),)),
           "wide": CPConfig(**WIDE)}.get(case, CPConfig())
    tables = pack_tables(init_cp(torch.Generator().manual_seed(0), cfg, card),
                         cfg)
    x3, d3, g = _samples(card, 11 if case == "one tile" else 8192 + 37, 2)
    if case == "all live":
        g[:, ::3] = 1.0
    if case == "none live":
        g.zero_()
    before = _calls(2)
    parts = {}
    whole = field_backward(tables, cfg, x3, d3, g, parts=parts)
    assert _calls(2) == before + 1
    live = parts["live"]
    assert torch.equal(live.sort().values,
                       torch.nonzero(g.abs().amax(dim=0) > 0)[:, 0])
    k1 = field_forward(tables, cfg, x3, d3)
    assert torch.equal(parts["out"][:, live], k1[:, live])
    for tol, got, g_in in (
            (WHOLE_CALL_TOL, whole, g),
            (GRAD_TOL, None, _stable_cotangents(tables, cfg, x3, d3, g))):
        if got is None:
            got = field_backward(tables, cfg, x3, d3, g_in)
        ref = field_backward_plain(tables, cfg, x3, d3, g_in)
        for a, b in zip(param_leaves(got), param_leaves(ref)):
            assert a.shape == b.shape
            if case == "none live":
                assert a.abs().max().item() == 0.0 == b.abs().max().item()
                continue
            err = ((a - b).abs().max() / b.abs().max()).item()
            assert err <= tol, (tuple(a.shape), err, tol)


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
        k1, k2 = _calls(1), _calls(2)
        loss, _ = trainer.loss_on(*batch, plain=plain)
        loss.backward()
        launched = (_calls(1) - k1, _calls(2) - k2)
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
    before, k1_before = _calls(3), _calls(1)
    out = dyn_field_forward(tables, cfg, x3, d3, t, **kw)
    assert _calls(3) == before + 1
    assert _calls(1) == k1_before
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
    warp; sixteen matrices, whose hidden ones stream through the kernels'
    ring of shared-memory slots; K3 and K4 at both depths against their
    plain versions (K4 stage by stage on its own input); a tower the kernel
    is not built for raises instead of falling back."""
    for layers in (2, 16):
        cfg, tables = _dyn_tables(card, layers=layers, gain=1.0)
        x3 = torch.rand((3, 19), device=card) * 2 - 1
        out = dyn_field_forward(tables, cfg, x3, None, 0.5, density_only=True)
        ref = dyn_field_forward_plain(tables, cfg, x3, None, 0.5,
                                      density_only=True)
        np.testing.assert_allclose(out[0].cpu(), ref[0].cpu(), **SIGMA_TOL)
        x3, d3, g = _samples(card, 4096 * 4 + 37, 7)
        out = dyn_field_forward(tables, cfg, x3, d3, 0.37)
        ref = dyn_field_forward_plain(tables, cfg, x3, d3, 0.37)
        np.testing.assert_allclose(out[0].cpu(), ref[0].cpu(), **SIGMA_TOL)
        np.testing.assert_allclose(out[1:].cpu(), ref[1:].cpu(), **RGB_TOL)
        parts = {}
        got = dyn_field_backward(tables, cfg, x3, d3, 0.37, g, parts=parts)
        assert all(w.abs().max().item() > 0 for w in got["deform_mlp"]["w"])
        _hold_k4_stages(tables, cfg, x3, d3, g, got, parts)
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

    before, k1_before = _calls(3), _calls(1)
    st = rebuild_dyn_density_grid(
        init_dyn_grid_state(gcfg, card), density, gcfg,
        generator=torch.Generator(card).manual_seed(0))
    assert _calls(3) == before + 16
    assert _calls(1) == k1_before
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

    The canonical stage is held to WHOLE_CALL_TOL on all samples and to
    GRAD_TOL on those that are stable at the kernel's warped positions
    (_stable_cotangents), in a second call.

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
    4.1e-3). The share of samples that may hold a differing mask is 5e-3
    at the default tower's seven hidden activations; each entry flips as
    rarely at another depth, so the share scales with the count of hidden
    activations (measured 5.8e-3 at fifteen, against 1.07e-2 there)."""
    nx = cfg.deform_space_dim
    mask_share = 5e-3 * (cfg.num_layers_deform - 1) / 7
    xw, acts_p = dyn_warp_plain(tables, cfg, x3, 0.37)
    live = parts["live"]
    # the kernel warps the samples with a cotangent only
    dxw = (parts["xw"] - xw).abs()[:, live]
    ref, g_x = dyn_canonical_backward_plain(tables, cfg, parts["xw"], d3,
                                            0.37, g)
    assert max(_leaf_errs({k: got[k] for k in ref}, ref)) <= WHOLE_CALL_TOL
    assert _rel(parts["g_x"], g_x) <= WHOLE_CALL_TOL
    g2 = _stable_cotangents(tables, cfg, parts["xw"], d3, g)
    parts2 = {}
    got2 = dyn_field_backward(tables, cfg, x3, d3, 0.37, g2, parts=parts2)
    ref, g_x = dyn_canonical_backward_plain(tables, cfg, parts2["xw"], d3,
                                            0.37, g2)
    assert max(_leaf_errs({k: got2[k] for k in ref}, ref)) <= GRAD_TOL
    assert _rel(parts2["g_x"], g_x) <= GRAD_TOL
    assert torch.equal(live.sort().values,
                       torch.nonzero(g.abs().amax(dim=0) > 0)[:, 0])
    acts_k = [a.float() for a in parts["acts"]]
    acts_p = [a[live] for a in acts_p]
    assert torch.equal(acts_k[0], acts_p[0])
    hid_k, hid_p = torch.cat(acts_k[1:], 1), torch.cat(acts_p[1:], 1)
    assert (hid_k != hid_p).float().mean().item() <= 2e-3
    assert ((hid_k > 0) != (hid_p > 0)).any(dim=1).float().mean().item() \
        <= mask_share
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
    before = _calls(4)
    parts = {}
    got = dyn_field_backward(tables, cfg, x3, d3, 0.37, g, parts=parts)
    assert _calls(4) == before + 1
    assert all(w.abs().max().item() > 0 for w in got["deform_mlp"]["w"])
    assert parts["g_x"][:, ::3].abs().max().item() == 0.0
    ref = dyn_field_backward_plain(tables, cfg, x3, d3, 0.37, g)
    assert max(_leaf_errs(got, ref)) <= 5e-2, _leaf_errs(got, ref)
    _, dxw = _hold_k4_stages(tables, cfg, x3, d3, g, got, parts)
    assert dxw.max().item() <= 1e-3 and dxw.mean().item() <= 1e-6
    # t read on the card: the same gradients (atomics reorder the sums)
    on_card = dyn_field_backward(tables, cfg, x3, d3,
                                 torch.tensor(0.37, device=card), g)
    assert max(_leaf_errs(on_card, got)) <= 1e-4


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


def test_dyn_field_backward_warps_as_the_forward_kernel(card):
    """K4's warp (the listed samples of parts["xw"]) is K3's warp of the same
    samples bit for bit: both run one device function."""
    cfg, tables = _dyn_tables(card)
    x3, d3, g = _samples(card, 4096 * 16 + 37, 8)
    parts = {}
    dyn_field_backward(tables, cfg, x3, d3, 0.37, g, parts=parts)
    fwd = {}
    dyn_field_forward(tables, cfg, x3, d3, 0.37, parts=fwd)
    live = parts["live"]
    m = x3.shape[1]
    assert live.numel() == m - len(range(0, m, 3))
    assert torch.equal(parts["xw"][:, live], fwd["xw"][:, live])
    assert (fwd["xw"] - x3).abs().mean().item() > 1e-2


@pytest.mark.parametrize("with_parts", [False, True])
def test_dyn_field_backward_in_passes(card, monkeypatch, with_parts):
    """K4's tower backward walks the listed samples in passes of as many
    tiles as its scratch holds: with room for five tiles (26 passes, the
    last eight past the list's end) every gradient equals the one-pass
    call's up to the order of the f32 sums, and the activations it
    recomputed are the same bits."""
    import sealdnerf_tpu_torch.ops.field as field
    cfg, tables = _dyn_tables(card)
    x3, d3, g = _samples(card, 8229, 9)
    one = {}
    whole = dyn_field_backward(tables, cfg, x3, d3, 0.37, g, parts=one)
    tile_bytes = 64 * cfg.hidden_dim_deform * 2
    monkeypatch.setattr(field, "_TOWER_SCRATCH_BYTES",
                        5 * 2 * cfg.num_layers_deform * tile_bytes)
    parts = {} if with_parts else None
    got = dyn_field_backward(tables, cfg, x3, d3, 0.37, g, parts=parts)
    assert max(_leaf_errs(got, whole)) <= 1e-4, _leaf_errs(got, whole)
    if with_parts:  # the list's order is free: compare sample by sample
        o, o1 = parts["live"].argsort(), one["live"].argsort()
        assert torch.equal(parts["live"][o], one["live"][o1])
        assert all(torch.equal(a[o], b[o1])
                   for a, b in zip(parts["acts"], one["acts"]))


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
    before = _calls(4)
    empty = dyn_field_backward(tables, cfg, e, e, 0.37,
                               torch.zeros((4, 0), device=card))
    assert _calls(4) == before
    assert [tuple(w.shape) for w in empty["deform_mlp"]["w"]] == \
        [(76, 128)] + [(128, 128)] * 6 + [(128, 3)]


def test_field_backward_unchanged_by_the_shared_body(card):
    """K2 and K4 share one body: K4 at t = 0 runs it to K2's results at a
    train step's sample count, within 1e-3 (only the atomics' order
    differs). Against the plain version K2 is held as everywhere: to
    WHOLE_CALL_TOL on all samples, to GRAD_TOL on the stable ones. The
    per-sample body that this one replaced summed each product in
    sequential f32 order, as the plain version's matmul does, and lay 1e-3
    from it on all samples; the mma's order rounds 4e-4 to 7e-4 of the
    hidden activations to the neighbouring bf16, which alone moves a leaf
    by 2e-3, and flips a relu mask at a few in ten thousand samples."""
    cfg, tables = _dyn_tables(card)
    x3, d3, g = _samples(card, 4096 * 16 + 5, 7)
    got = field_backward(tables, cfg, x3, d3, g)
    k4 = dyn_field_backward(tables, cfg, x3, d3, 0.0, g)
    assert max(_leaf_errs({k: k4[k] for k in got}, got)) <= 1e-3
    ref = field_backward_plain(tables, cfg, x3, d3, g)
    assert max(_leaf_errs(got, ref)) <= WHOLE_CALL_TOL, _leaf_errs(got, ref)
    g = _stable_cotangents(tables, cfg, x3, d3, g)
    got = field_backward(tables, cfg, x3, d3, g)
    ref = field_backward_plain(tables, cfg, x3, d3, g)
    assert max(_leaf_errs(got, ref)) <= GRAD_TOL, _leaf_errs(got, ref)


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
    k3 = _calls(3)
    trainer.refresh_grid()
    assert _calls(3) == k3 + 8
    assert trainer._dyn_host_counts() == (2, 16)
    batch = trainer.sample_batch(train.device(card), train.h, train.w)
    out = []
    for plain in (False, True):
        for p in param_leaves(trainer.params):
            p.grad = None
        k3, k4 = _calls(3), _calls(4)
        loss, _ = trainer.loss_on(*batch, plain=plain)
        loss.backward()
        launched = (_calls(3) - k3,
                    _calls(4) - k4)
        assert launched == ((0, 0) if plain else (1, 1)), launched
        out.append((loss.item(), [p.grad.clone()
                                  for p in param_leaves(trainer.params)]))
    (lk, gk), (lp, gp) = out
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    for a, b in zip(gk, gp):
        err = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        assert err <= GRAD_TOL, (tuple(a.shape), err)


# ------------------------------------------------------------------ editing
@pytest.mark.parametrize("kw", [{}, {"density_only": True}])
def test_dyn_field_kernel_chunked_equals_unchunked(card, kw):
    """K3 through a [3, chunk] scratch for the warped positions, chunk by
    chunk with a ragged last chunk, equals K3 in one pass bit for bit, and
    counts one launch; the features that parts asks for too."""
    cfg, tables = _dyn_tables(card)
    rng = np.random.default_rng(3)
    m = 3 * 4096 + 37
    x3 = torch.from_numpy(rng.uniform(-1, 1, (3, m)).astype(
        np.float32)).to(card)
    d3 = torch.from_numpy(rng.normal(size=(3, m)).astype(np.float32))
    d3 = (d3 / d3.norm(dim=0, keepdim=True)).to(card)
    if kw:
        d3 = None
    whole_parts, chunk_parts = {}, {}
    whole = dyn_field_forward(tables, cfg, x3, d3, 0.37, chunk=m,
                              parts=whole_parts, **kw)
    before = _calls(3)
    chunked = dyn_field_forward(tables, cfg, x3, d3, 0.37, chunk=4096,
                                parts=chunk_parts, **kw)
    assert _calls(3) == before + 1
    assert torch.equal(chunked, whole)
    assert torch.equal(chunk_parts["features"], whole_parts["features"])
    assert torch.equal(dyn_field_forward(tables, cfg, x3, d3, 0.37, **kw),
                       whole)


def _edit_student(card, tmp_path, gain=6.0 ** 0.5):
    """A dynamic student around the seeded full-width field (its tower
    undamped, the hidden matrices times `gain`: the default re-gains it to
    warp by ~0.1; 32^3 grid rebuilt over its 64 bins) and the bbox
    move-and-recolour edit, on the card."""
    from sealdnerf_tpu_torch.editing.seal_utils import get_seal_mapper
    from sealdnerf_tpu_torch.editing.student import FastStudentTrainer
    from sealdnerf_tpu_torch.models.cp import (cp_dnerf_deform_raw,
                                               make_cp_dnerf_field,
                                               map_params)
    from sealdnerf_tpu_torch.train.fast import FastTrainer
    from sealdnerf_tpu_torch.train.trainer import TrainOptions
    cfg = CPDNeRFConfig()
    field = make_cp_dnerf_field(torch.Generator().manual_seed(0), cfg, card)
    wd = field.params["deform_mlp"]["w"]
    wd[-1] = wd[-1] * 1e3
    for k in range(1, len(wd) - 1):
        wd[k] = wd[k] * gain
    topt = TrainOptions(bound=1.0, dt_gamma=0.0, grid_size=32, march_res=16,
                        lr_net=5e-5, workspace=str(tmp_path))
    teacher = FastTrainer("ngp", topt, field, workspace=str(tmp_path / "t"),
                          use_checkpoint="scratch", device=card,
                          time_conditioned=True)
    _, train, _ = make_synthetic_scene(n_train=4, n_val=1, res=64,
                                       dynamic=True)
    teacher.mark_untrained_grid(train.poses, train.intrinsics)
    teacher.rebuild_grid()
    t = np.eye(4)
    t[1, 3] = 0.3
    gr = np.random.default_rng(3).normal(size=(256, 3))
    gr /= np.linalg.norm(gr, axis=-1, keepdims=True)
    mapper = get_seal_mapper("", {
        "type": "bbox", "raw": (gr * 0.36 + [0, 0.1, 0]).tolist(),
        "transform": t.tolist(), "scale": [1, 1, 1], "boundType": "both",
        "hsv": [0.3, 0.0, 0.0]})
    sfield = type(field)(map_params(lambda p: p.detach().clone(),
                                    teacher.params), cfg)
    sfield.deform_raw = lambda p, x, tt: cp_dnerf_deform_raw(p, cfg, x, tt)
    student = FastStudentTrainer("ngp", topt, sfield, teacher, mapper=mapper,
                                 workspace=str(tmp_path / "s"),
                                 use_checkpoint="scratch", device=card,
                                 time_conditioned=True)
    student.adopt_grid_state(teacher.grid_state)
    return student, train


def test_edit_teacher_through_the_kernel_matches_plain(card, tmp_path):
    """The wrapped teacher (mapper, then K3 at t = 0.5, then the recolour)
    against the same through K3's plain version, on points of the box and
    of the edit; then one view through the teacher's renderer both ways."""
    from sealdnerf_tpu_torch.editing.teacher import TeacherField
    student, train = _edit_student(card, tmp_path)
    tt = student.teacher_trainer
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(-1, 1, (4096, 3)),
                        rng.uniform(-0.4, 0.8, (4096, 3))]).astype(np.float32)
    d = rng.normal(size=x.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    x3 = torch.from_numpy(np.ascontiguousarray(x.T)).to(card)
    d3 = torch.from_numpy(np.ascontiguousarray(d.T)).to(card)
    kern = student.teacher_field
    plain = TeacherField(tt.field, student.mapper, time_conditioned=True,
                         plain=True)
    before = _calls(3)
    with torch.no_grad():
        got = kern.forward_planar(tt.params, x3, d3, 0.5)
        assert _calls(3) == before + 1
        ref = plain.forward_planar(tt.params, x3, d3, 0.5)
    assert _calls(3) == before + 1
    np.testing.assert_allclose(got[0].cpu(), ref[0].cpu(), **SIGMA_TOL)
    np.testing.assert_allclose(got[1:4].cpu(), ref[1:4].cpu(), **RGB_TOL)
    mask = student.mapper.map_to_origin_compact(x3.t())[2]
    assert 500 < int(mask.sum()) < 7000
    img_k, _ = student.render_teacher_image(train.poses[0], train.intrinsics,
                                            64, 64, time=0.5)
    img_p, _ = student.render_teacher_image(train.poses[0], train.intrinsics,
                                            64, 64, time=0.5, plain=True)
    assert np.abs(img_k - img_p).max() <= 2e-2


def test_one_dynamic_pretraining_step_kernel_matches_plain(card, tmp_path):
    """One pretraining step on the first batch of the local zone: the loss
    through K3 and through its plain version, and the L1's cotangents (of
    the plain forward) through K4 and through its plain version, with the
    undamped tower (warp 6e-4) at which K4 is held end to end to
    WHOLE_CALL_TOL (test_dyn_field_backward_kernel_matches_plain); the
    re-gained one moves a few positions by half a cell of the finest
    tables (chip_smoke.py phase 3d)."""
    from sealdnerf_tpu_torch.editing.student import pretrain_l1
    student, _ = _edit_student(card, tmp_path, gain=1.0)
    student.init_pretraining(time_frame=0.5, epochs=1, batch_size=8192,
                             local_point_step=0.02,
                             surrounding_point_step=0.05,
                             global_point_step=-1)
    batch = {k: v[0] for k, v in student.pretraining_data["local"].items()}
    cfg, tables = student.field.cfg, student.field.kernel_tables(
        student.params)
    x3 = batch["points"].t().contiguous()
    d3 = batch["dirs"].t().contiguous()
    k3, k4 = _calls(3), _calls(4)
    with torch.no_grad():
        out_p = dyn_field_forward_plain(tables, cfg, x3, d3, 0.5)
    out_p.requires_grad_(True)
    loss_p = pretrain_l1(out_p, batch)
    g = torch.autograd.grad(loss_p, out_p)[0].contiguous()
    ref = dyn_field_backward_plain(tables, cfg, x3, d3, 0.5, g)
    assert (_calls(3), _calls(4)) == \
        (k3, k4)
    with torch.no_grad():
        loss_k = pretrain_l1(dyn_field_forward(tables, cfg, x3, d3, 0.5),
                             batch)
    got = dyn_field_backward(tables, cfg, x3, d3, 0.5, g)
    assert (_calls(3), _calls(4)) == \
        (k3 + 1, k4 + 1)
    assert abs(loss_k.item() - loss_p.item()) <= 1e-4 * abs(loss_p.item())
    assert max(_leaf_errs(got, ref)) <= WHOLE_CALL_TOL, _leaf_errs(got, ref)


# ----------------------------------------- the CLI's default recipe (bound 2)
@pytest.mark.parametrize("kw", [{}, {"density_only": True},
                                {"lod_skip": (3,)}])
def test_field_kernels_without_planes_match_plain(card, kw):
    """K1 and K2 at the default line scales and no VM planes (what
    default_planes gives at bound > 1: the layout has no plane segment),
    on points of the bound-2 box."""
    cfg = CPConfig(bound=2.0, planes=())
    tables = pack_tables(init_cp(torch.Generator().manual_seed(5), cfg, card),
                         cfg)
    x3, d3, g = _samples(card, 8192 + 37, 6)
    x3 = x3 * 2.0
    out = field_forward(tables, cfg, x3, d3, **kw).cpu()
    ref = field_forward_plain(tables, cfg, x3, d3, **kw).cpu()
    np.testing.assert_allclose(out[0], ref[0], **SIGMA_TOL)
    np.testing.assert_allclose(out[1:], ref[1:], **RGB_TOL)
    if kw:
        return
    parts = {}
    whole = field_backward(tables, cfg, x3, d3, g, parts=parts)
    assert torch.equal(parts["out"][:, parts["live"]],
                       field_forward(tables, cfg, x3, d3)[:, parts["live"]])
    for tol, got, g_in in (
            (WHOLE_CALL_TOL, whole, g),
            (GRAD_TOL, None, _stable_cotangents(tables, cfg, x3, d3, g))):
        if got is None:
            got = field_backward(tables, cfg, x3, d3, g_in)
        ref_g = field_backward_plain(tables, cfg, x3, d3, g_in)
        for a, b in zip(param_leaves(got), param_leaves(ref_g)):
            err = ((a - b).abs().max() / b.abs().max()).item()
            assert err <= tol, (tuple(a.shape), err, tol)


def test_bound2_train_step_kernel_matches_plain(card, tmp_path):
    """One step of the CLI's default recipe (bound 2, dt_gamma 1/128, two
    cascades, no planes) through K1/K2 and through their plain versions."""
    opt = postprocess(base_parser().parse_args(
        ["synthetic", "-O", "--ckpt", "scratch", "--workspace",
         str(tmp_path), "--num_rays", "1024"]))
    trainer, field = build_trainer(opt, name="card")
    assert field.cfg.planes == () and trainer.march_cfg.multi
    _, train, _ = make_synthetic_scene(n_train=4, n_val=1, res=64)
    trainer.mark_untrained_grid(train.poses, train.intrinsics)
    trainer.refresh_grid()
    assert trainer._occ_m.shape[0] == 2
    batch = trainer.sample_batch(train.device(card), train.h, train.w)
    out = []
    for plain in (False, True):
        for p in param_leaves(trainer.params):
            p.grad = None
        loss, _ = trainer.loss_on(*batch, plain=plain)
        loss.backward()
        out.append((loss.item(), [p.grad.clone()
                                  for p in param_leaves(trainer.params)]))
    (lk, gk), (lp, gp) = out
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    for a, b in zip(gk, gp):
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err <= GRAD_TOL, (tuple(a.shape), err)


def _frame_psnr(a, b):
    mse = float(((a - b) ** 2).mean())
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


@pytest.mark.parametrize("dynamic", [False, True])
def test_bucketed_frame_through_the_kernel_matches_plain(card, dynamic):
    """A bucketed frame with the termination trim through K1 (or K3 at
    t = 0.5) and through its plain version, on a sparse ball occupancy:
    >= 40 dB between the two; the trim's probe launches the kernel once
    more than the buckets do."""
    from sealdnerf_tpu_torch.ops.marching_dense import DenseMarchConfig
    from sealdnerf_tpu_torch.render.fast_image import render_image_bucketed
    if dynamic:
        cfg, tables = _dyn_tables(card)
        kern = lambda tb, x3, d3, t: dyn_field_forward(tb, cfg, x3, d3, t)
        plain = lambda tb, x3, d3, t: dyn_field_forward_plain(tb, cfg, x3,
                                                              d3, t)
        counter, extra = 3, (0.5,)
    else:
        cfg = CPConfig()
        tables = pack_tables(
            init_cp(torch.Generator().manual_seed(0), cfg, card), cfg)
        kern = lambda tb, x3, d3: field_forward(tb, cfg, x3, d3)
        plain = lambda tb, x3, d3: field_forward_plain(tb, cfg, x3, d3)
        counter, extra = 1, ()
    g = torch.linspace(-1, 1, 64, device=card)
    x, y, z = torch.meshgrid(g, g, g, indexing="ij")
    occ = (x * x + y * y + z * z) < 0.35 ** 2
    rcfg = DenseMarchConfig(bound=1.0, march_res=64, n_intervals=32)
    pose = torch.eye(4, device=card)
    pose[2, 3] = -2.5
    intr = torch.tensor([320.0, 320.0, 128.0, 128.0], device=card)
    kw = dict(tile_px=8, term_probe=16, term_tau=7.0, term_stride=2,
              splits=((0.60, 32), (0.15, 16), (0.15, 4), (0.07, 2),
                      (1.0, 2)), extra=extra)
    frames = []
    for fwd in (kern, plain):
        before = _calls(counter)
        with torch.no_grad():
            img, _ = render_image_bucketed(tables, occ, pose, intr, 256, 256,
                                           rcfg, fwd, torch.ones(3,
                                                                 device=card),
                                           **kw)
        frames.append((img.cpu().numpy(), _calls(counter) - before))
    (img_k, n_k), (img_p, n_p) = frames
    assert n_p == 0 and n_k >= 2
    assert np.isfinite(img_k).all() and img_k.min() < 0.9
    assert _frame_psnr(img_k, img_p) >= 40.0


@pytest.mark.parametrize("dynamic", [False, True])
def test_termination_trim_probe_through_the_kernel(card, dynamic):
    """The trim's corner probe through K1 (K3 at t = 0.5) keeps the same
    intervals as through the plain version, but for taps within the
    kernel's noise of tau (at most 1 % of the tiles)."""
    from sealdnerf_tpu_torch.ops.marching_dense import DenseMarchConfig
    from sealdnerf_tpu_torch.render import fast_image as tfi
    if dynamic:
        cfg, tables = _dyn_tables(card)
        fwds = (lambda tb, x3, d3, t: dyn_field_forward(tb, cfg, x3, d3, t),
                lambda tb, x3, d3, t: dyn_field_forward_plain(tb, cfg, x3,
                                                              d3, t))
        extra = (0.5,)
    else:
        cfg = CPConfig()
        tables = pack_tables(
            init_cp(torch.Generator().manual_seed(0), cfg, card), cfg)
        fwds = (lambda tb, x3, d3: field_forward(tb, cfg, x3, d3),
                lambda tb, x3, d3: field_forward_plain(tb, cfg, x3, d3))
        extra = ()
    occ = torch.ones((64, 64, 64), dtype=torch.bool, device=card)
    rcfg = DenseMarchConfig(bound=1.0, march_res=64, n_intervals=32)
    pose = torch.eye(4, device=card)
    pose[2, 3] = -2.5
    intr = torch.tensor([320.0, 320.0, 128.0, 128.0], device=card)
    th = tw = 32
    to, td, tn, tf = tfi._tile_rays(pose, intr, th, tw, 8, rcfg)
    te, _, iv, _ = tfi._march_tiles(to, td, tn, tf, occ, rcfg, 1)
    kept = [tfi._termination_trim(tables, pose, intr / 8, th,
                                  tw, 8, te, iv, None, rcfg, f, 1.0, 0.05,
                                  16, extra, stride=2) for f in fwds]
    assert int(kept[1].sum()) < int(iv.sum())           # the trim acts
    differ = (kept[0] != kept[1]).any(dim=1).float().mean().item()
    assert differ <= 0.01, differ


@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_render_occ_over_a_cp_field_through_the_kernel(card, bound):
    """render_occ (the packed march, K1 on the kept samples, packed
    compositing) over the seeded default CP field against the same through
    K1's plain version: one launch, frames within the serving limit."""
    from sealdnerf_tpu_torch.models.cp import default_planes
    from sealdnerf_tpu_torch.ops.marching import MarchConfig
    from sealdnerf_tpu_torch.render.renderer import RenderSettings, render_occ
    cfg = CPConfig(bound=bound, planes=default_planes(bound))
    tables = pack_tables(init_cp(torch.Generator().manual_seed(0), cfg, card),
                         cfg)
    cas = 1 if bound <= 1 else 2
    settings = RenderSettings(march=MarchConfig(
        bound=bound, cascades=cas, dt_gamma=0.0 if bound <= 1 else 1 / 128))
    occ = torch.rand((cas, 128, 128, 128), generator=torch.Generator(
        card).manual_seed(1), device=card) < 0.2
    _, train, _ = make_synthetic_scene(n_train=1, n_val=1, res=64)
    rays = get_rays(torch.from_numpy(train.poses[:1]).to(card),
                    torch.from_numpy(train.intrinsics).to(card), 64, 64)

    def fwd(fn):
        def f(_, x, d):
            out = fn(tables, cfg, x.t().contiguous(), d.t().contiguous())
            return out[0], out[1:4].t()
        return f

    args = (None, occ, rays["rays_o"][0], rays["rays_d"][0], settings)
    before = _calls(1)
    got = render_occ(*args, fwd(field_forward), m_budget=4096 * 64)
    assert _calls(1) == before + 1
    ref = render_occ(*args, fwd(field_forward_plain), m_budget=4096 * 64)
    assert _calls(1) == before + 1
    assert int(got["n_samples"]) > 10000
    assert float((got["image"] - ref["image"]).abs().max()) <= 2e-2
    assert float((got["depth"] - ref["depth"]).abs().max()) <= 2e-2 * bound


def test_tower_on_tensor_cores_matches_apply_mlp(card):
    """apply_tower outside autograd on the card (bf16 GEMMs) against
    apply_mlp (f32 products of the bf16-rounded operands): the same
    rounding points, f32 sums in other orders."""
    from sealdnerf_tpu_torch.models.mlp import apply_mlp, apply_tower, \
        init_mlp
    params = init_mlp(torch.Generator().manual_seed(0),
                      [76, 128, 128, 128, 3])
    params = {"w": [w.to(card) for w in params["w"]]}
    x = torch.randn((100_003, 76), generator=torch.Generator(
        card).manual_seed(1), device=card)
    with torch.no_grad():
        got = apply_tower(params, x)
        ref = apply_mlp(params, x)
    np.testing.assert_allclose(got.cpu(), ref.cpu(), rtol=2e-2, atol=1e-3)
    with torch.enable_grad():
        assert torch.equal(apply_tower(params, x), apply_mlp(params, x))


def _cli_frames(tmp_path):
    """The seeded CLI field (main_nerf synthetic -O --bound 1 --dt_gamma
    0) on a ball of occupancy of radius 0.5, so that its frames take the
    bucketed renderer, and frame(turn): its 800x800 render_image from 2.5
    before the origin, looking at it, turned by `turn` degrees about y."""
    argv = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--ckpt",
            "scratch", "--workspace", str(tmp_path)]
    tr, _ = build_trainer(postprocess(base_parser().parse_args(argv)),
                          name="card")
    occ = tr.grid_state["occ"]
    g = torch.linspace(-1.0, 1.0, occ.shape[-1], device=occ.device)
    x, y, z = torch.meshgrid(g, g, g, indexing="ij")
    occ.copy_((x * x + y * y + z * z < 0.25).expand_as(occ))
    tr._occ_frac = None
    intr = np.array([800.0, 800.0, 400.0, 400.0], np.float32)

    def frame(turn=0.0):
        a = np.radians(turn)
        rot = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                        [-np.sin(a), 0.0, np.cos(a)]], np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = rot
        pose[:3, 3] = rot @ np.array([0.0, 0.0, -2.5], np.float32)
        return tr.render_image(pose, intr, 800, 800)
    return tr, frame


def test_frame_fetch_is_pinned_and_bitwise(card, tmp_path, monkeypatch):
    """FastTrainer.render_image's arrays on the card: in page-locked
    memory, bitwise the .cpu() of the tensors that the frame fetched; the
    frame fetch's bytes all went through pinned blocks
    (fetch_pinned_bytes / fetch_bytes over it is 1.0), and over the whole
    frame fetch_bytes holds besides them only the small fetches (the
    bucket counts')."""
    _, frame = _cli_frames(tmp_path)
    frame()                                         # builds the kernels
    real_frame, real_fetch = profiling.fetch_frame, profiling.fetch
    seen, small = [], []

    def counters():
        return dict(profiling.tally(traced=False)["counters"])

    def spy_frame(*tensors):
        seen.append([t.clone() for t in tensors])
        before = counters()
        out = real_frame(*tensors)
        seen.append((before, counters()))
        return out

    def spy_fetch(t):
        small.append(t.numel() * t.element_size())
        return real_fetch(t)
    monkeypatch.setattr(profiling, "fetch_frame", spy_frame)
    monkeypatch.setattr(profiling, "fetch", spy_fetch)
    before = counters()
    got = frame(25.0)
    after = counters()
    (img, depth), (in0, in1) = seen
    assert img.is_cuda and depth.is_cuda
    for a, t in zip(got, (img, depth)):
        assert torch.from_numpy(a).is_pinned()
        assert torch.equal(torch.from_numpy(a), t.cpu())

    def moved(k, b, a):
        return a.get(k, 0) - b.get(k, 0)
    pinned = moved("fetch_pinned_bytes", in0, in1)
    assert pinned == 800 * 800 * 4 * 4
    assert pinned / moved("fetch_bytes", in0, in1) == 1.0
    assert moved("host_syncs", in0, in1) == 1
    assert moved("fetch_pinned_bytes", before, after) == pinned
    assert small and moved("fetch_bytes", before, after) == \
        pinned + sum(small)


def test_kept_frame_unchanged_after_later_frames_on_card(card, tmp_path):
    """A frame kept on the host reads the same after three later frames
    from other cameras, which differ from it: each frame owns its pinned
    blocks."""
    _, frame = _cli_frames(tmp_path)
    kept = frame()
    snap = [a.copy() for a in kept]
    later = [frame(40.0 * i) for i in (1, 2, 3)]
    assert all(not np.array_equal(f[0], snap[0]) for f in later)
    for f in later:
        for a in kept:
            assert not any(np.shares_memory(a, b) for b in f)
    for a, s in zip(kept, snap):
        assert np.array_equal(a, s)


def test_steady_frames_fetch_from_the_host_cache(card, tmp_path):
    """Over 10 steady frames, each dropped as the next is asked for, the
    caching host allocator makes no new pinned block: every fetch is
    served from its cache."""
    _, frame = _cli_frames(tmp_path)
    out = frame()
    out = frame(10.0)

    def blocks():
        return torch.cuda.host_memory_stats()["num_host_alloc"]
    before = blocks()
    for i in range(10):
        out = frame(20.0 + 10.0 * i)
    assert np.isfinite(out[0]).all()
    assert blocks() == before


# ----------------------------------------------- K5: the hash-grid field
def _hash_tables(card, seed=0):
    """K5's operands at the published widths (Instant-NGP at bound 1: 16
    levels of 2 features, 2^19 rows a level, 64-wide towers) on a table of
    N(0, 0.5) entries: the seeded U(+-1e-4) table leaves the features at
    ~1e-4, which would hide a misread corner."""
    from sealdnerf_tpu_torch.models.ngp import NGPConfig, init_ngp
    from sealdnerf_tpu_torch.ops.field import pack_hash_tables
    cfg = NGPConfig(bound=1.0)
    params = init_ngp(torch.Generator().manual_seed(seed), cfg, card)
    params["grid"] = torch.randn(
        params["grid"].shape, device=card,
        generator=torch.Generator(card).manual_seed(seed + 1)) * 0.5
    return cfg, pack_hash_tables(params, cfg)


@pytest.mark.parametrize("kw", [{}, {"density_only": True}])
@pytest.mark.parametrize("m", [(1 << 20) + 37, 1, 255])
def test_hash_field_kernel_matches_plain(card, m, kw):
    """K5 against its plain version (grid_encode on the bf16 table and the
    towers with the kernel's roundings) at the published widths, on 2^20 +
    37 random samples, some outside the box (encoded to zero), and on
    ragged counts: the reference's kernel tolerances (bf16 roundings that an
    f32 sum in another order may flip)."""
    from sealdnerf_tpu_torch.ops.field import (hash_field_forward,
                                               hash_field_forward_plain)
    cfg, tables = _hash_tables(card)
    rng = np.random.default_rng(2)
    x3 = rng.uniform(-1.02, 1.02, (3, m)).astype(np.float32)
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    x3, d3 = torch.from_numpy(x3).to(card), torch.from_numpy(d3).to(card)
    before = _calls(5)
    out = hash_field_forward(tables, cfg, x3, d3, **kw).cpu()
    assert _calls(5) == before + 1
    ref = hash_field_forward_plain(tables, cfg, x3, d3, **kw).cpu()
    np.testing.assert_allclose(out[0], ref[0], **SIGMA_TOL)
    np.testing.assert_allclose(out[1:], ref[1:], **RGB_TOL)
    x0 = torch.zeros((3, 0), device=card)
    assert hash_field_forward(tables, cfg, x0, x0).shape == (4, 0)


def test_hash_field_kernel_features_are_the_plain_ones(card):
    """What K5 feeds its first product is grid_encode's encoding on the bf16
    table, rounded to bf16: the kernel sums a level's 8 corners in f32 in
    corner order, so an f32 sum in another order may round a feature to the
    neighbouring bf16 value (at most one in a thousand here, 2^-7 relative
    apart)."""
    from sealdnerf_tpu_torch.ops.field import hash_field_forward
    from sealdnerf_tpu_torch.ops.grid_encode import grid_encode
    cfg, tables = _hash_tables(card)
    x3 = torch.rand((3, 1 << 16), device=card,
                    generator=torch.Generator(card).manual_seed(3)) * 2 - 1
    parts = {}
    hash_field_forward(tables, cfg, x3, None, density_only=True, parts=parts)
    want = grid_encode((x3.t() + 1.0) / 2.0, tables.plain["grid"].float(),
                       cfg.grid_cfg).to(torch.bfloat16).float()
    got = parts["features"].float()
    assert int((got != want).sum()) <= got.numel() // 1000
    rel = (got - want).abs() / want.abs().clamp(min=1e-3)
    assert float(rel.max()) <= 2.0 ** -7


def test_hash_field_kernel_time_within_its_bound(card):
    """K5 alone on 2^20 random samples takes at least the least time that
    nerfbench/work_hash.py gives its work (its roofline share at most 100
    %): the count of its bytes and operations is no more than it does."""
    import time as _time
    from nerfbench import work_hash
    from sealdnerf_tpu_torch.ops.field import hash_field_forward
    cfg, tables = _hash_tables(card)
    fc = {k: getattr(cfg, k) for k in (
        "bound", "num_levels", "level_dim", "base_resolution",
        "log2_hashmap_size", "gridtype", "num_layers", "hidden_dim",
        "geo_feat_dim", "num_layers_color", "hidden_dim_color", "sh_degree")}
    fc["desired_resolution"] = cfg.grid_cfg.desired_resolution
    m = 1 << 20
    x3 = torch.rand((3, m), device=card) * 2 - 1
    d3 = torch.nn.functional.normalize(torch.randn((3, m), device=card),
                                       dim=0)
    for kw in ({}, {"density_only": True}):
        hash_field_forward(tables, cfg, x3, d3, **kw)
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        for _ in range(10):
            hash_field_forward(tables, cfg, x3, d3, **kw)
        ev1.record()
        torch.cuda.synchronize()
        s = ev0.elapsed_time(ev1) / 10 * 1e-3
        bound = work_hash.bound_seconds(fc, 1, m, m if kw else 0)
        print(f"K5 {kw}: {s * 1e3:.3f} ms, bound {bound * 1e3:.4f} ms "
              f"({100 * bound / s:.1f} %) at {_time.strftime('%H:%M')}")
        assert 0 < bound <= s


def test_fast_trainer_ngp_frame_through_k5(card, tmp_path):
    """main_nerf's route for --backbone ngp on the card: FastTrainer serves
    the seeded Instant-NGP field's GUI frame through K5, and the frame
    through K5's plain version is the same to 40 dB."""
    from sealdnerf_tpu_torch.train import fast
    from sealdnerf_tpu_torch.ops.field import hash_field_forward_plain
    opt = postprocess(base_parser().parse_args(
        ["synthetic", "-O", "--backbone", "ngp", "--bound", "1",
         "--dt_gamma", "0", "--workspace", str(tmp_path), "--ckpt",
         "scratch"]))
    tr, _ = build_trainer(opt)
    assert type(tr) is fast.FastTrainer
    _, train, val = make_synthetic_scene(n_train=4, n_val=1, res=64)
    tr.train_gui(train.device(card), 64, 64, step=32)
    before = _calls(5)
    got = tr.test_gui(val.poses[0], val.intrinsics, 64, 64)["image"]
    assert _calls(5) > before
    orig = fast.hash_field_forward
    try:
        fast.hash_field_forward = lambda tabs, cfg, x3, d3, **kw: \
            hash_field_forward_plain(tabs, cfg, x3, d3, **kw)
        want = tr.test_gui(val.poses[0], val.intrinsics, 64, 64)["image"]
    finally:
        fast.hash_field_forward = orig
    mse = float(np.mean((np.asarray(got) - np.asarray(want)) ** 2))
    assert mse == 0 or -10 * np.log10(mse) >= 40.0
