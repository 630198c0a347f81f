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
from sealdnerf_tpu_torch.models.cp import (CPConfig, CPField, init_cp,
                                           param_leaves)
from sealdnerf_tpu_torch.ops.field import (field_backward,
                                           field_backward_plain,
                                           field_forward, field_forward_plain,
                                           field_train_forward, pack_tables)
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
    assert torch.equal(field_forward(t1, cfg, x3, d3),
                       field_forward(pack_tables(params, cfg), cfg, x3, d3))


def test_get_rays_with_a_card_generator(card):
    poses = torch.eye(4, device=card)[None]
    intr = torch.tensor([20.0, 20.0, 16.0, 16.0], device=card)
    rays = get_rays(poses, intr, 32, 32, 100,
                    generator=torch.Generator(card).manual_seed(3))
    assert rays["inds"].device.type == "cuda"
    assert rays["rays_d"].shape == (1, 100, 3)
