"""The ported static CP training path against the JAX package.

Same inputs from seeded numpy for both packages, params carried over with
`params_from_jax` (through a checkpoint, so that the port's trainer comes
from `cli.build_trainer` as a user's would). Tolerances:

- Adam + lr schedule + EMA, 5 steps of identical grads: params and EMA
  rtol 1e-5 (the same f32 update in another operation order).
- One deterministic train step (fixed rays, background and occupancy, no
  march noise) against `value_and_grad` of the MSE of JAX `render_dense`
  through the fused Pallas field in interpret mode: loss rtol 1e-3, grads
  per leaf <= 1e-2 * max |ref| (bf16 rounding points are the same; f32 sums
  run in other orders).
- The grid refresh (slab and random variants) against the reference
  FastTrainer's grid_update arithmetic with the cells and jitter passed in:
  density within the field kernel's bf16 tolerance (rtol 2e-2, atol 1e-4),
  >= 99.9 % of occupancy cells equal.
- The slice as a whole: see test_training_matches_jax_band, at the
  single-cascade recipe (bound 1, dt_gamma 0, one plane scale) and at the
  CLI's default one (bound 2, dt_gamma 1/128, no planes: the cascade
  march).
- Checkpoints with optimizer state resume bit-exactly in both directions.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from sealdnerf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from sealdnerf_tpu.models.cp import CPConfig as JaxCPConfig, make_cp_field
from sealdnerf_tpu.ops.marching_dense import DenseMarchConfig as JaxMarchCfg
from sealdnerf_tpu.ops.pallas_field import (make_fused_forward_planar,
                                            make_fused_train_forward)
from sealdnerf_tpu.render.fast import render_dense as jax_render_dense
from sealdnerf_tpu.render.grid import init_grid_state as jax_init_grid
from sealdnerf_tpu.train import checkpoint as jax_ckpt
from sealdnerf_tpu.train.fast import FastTrainer
from sealdnerf_tpu.train.trainer import Trainer, TrainOptions
from sealdnerf_tpu_torch.cli import base_parser, build_trainer, postprocess
from sealdnerf_tpu_torch.data.rays import get_rays
from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
from sealdnerf_tpu_torch.models.cp import (CPConfig, param_leaves,
                                           params_from_jax)
from sealdnerf_tpu_torch.ops.field import field_forward, pack_tables
from sealdnerf_tpu_torch.render import grid as tgrid
from sealdnerf_tpu_torch.train.checkpoint import prune_checkpoints

NARROW = dict(grid_size=32, march_res=16, n_intervals=6, steps_per_interval=3)
SCALES = ((16, 8), (64, 16))
PLANES = ((16, 4),)
STEPS = 192                    # 3 epochs of 64 steps
SEEDS = (1, 2, 3)
BAND_DB = 0.75
# the recipes of the band test: (bound, dt_gamma, VM planes)
RECIPES = {"bound1": (1.0, 0.0, PLANES), "bound2": (2.0, 1.0 / 128, ())}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; a torch pool of
    every core in each makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_opts(ws, seed, recipe="bound1", **kw):
    bound, dt_gamma, _ = RECIPES[recipe]
    return TrainOptions(iters=STEPS, num_rays=256, bound=bound,
                        dt_gamma=dt_gamma, segment_steps=64,
                        update_extra_interval=8, eval_interval=1000,
                        workspace=ws, seed=seed, **NARROW, **kw)


def _port_trainer(ckpt, ws, seed=1, extra=(), recipe="bound1"):
    bound, dt_gamma, _ = RECIPES[recipe]
    opt = postprocess(base_parser().parse_args(
        ["synthetic", "-O", "--bound", str(bound), "--dt_gamma",
         str(dt_gamma), "--device", "cpu", "--ckpt", ckpt, "--workspace", ws,
         "--iters", str(STEPS), "--num_rays", "256",
         "--update_extra_interval", "8", "--seed", str(seed), *extra]))
    trainer, _ = build_trainer(opt, name="t", segment_steps=64, **NARROW)
    return trainer


def _jax_band(ws, recipe):
    """The JAX FastTrainer trained STEPS steps from PRNGKey(0)'s init of
    `recipe` for each seed; the init as a checkpoint for the port; val
    PSNRs; the seed-1 trainer and its full checkpoint."""
    bound, _, planes = RECIPES[recipe]
    _, train, val = jax_scene(n_train=6, n_val=1, res=32)
    field = make_cp_field(jax.random.PRNGKey(0), JaxCPConfig(
        bound=bound, scales=SCALES, planes=planes))
    tr = FastTrainer("t", _jax_opts(ws, SEEDS[0], recipe), field,
                     workspace=ws, use_checkpoint="scratch")
    init = {k: jax.tree_util.tree_map(np.asarray, v) for k, v in (
        ("params", tr.params), ("ema", tr.ema_params))}
    init_ckpt = os.path.join(ws, "init.npz")
    jax_ckpt.save_checkpoint(init_ckpt, {"model": init,
                                         "grid": tr.grid_state},
                             {"epoch": 0, "global_step": 0})
    psnrs, first = [], None
    for seed in SEEDS:
        # one trainer (one compile), reset to the init for each seed
        tr.rng = jax.random.PRNGKey(seed)
        tr.params = jax.tree_util.tree_map(jnp.asarray, init["params"])
        tr.ema_params = jax.tree_util.tree_map(jnp.asarray, init["ema"])
        tr.field.params = tr.params
        tr.opt_state = tr.tx.init(tr.params)
        tr.grid_state = jax_init_grid(tr.grid_cfg)
        tr.global_step = tr.local_step = tr.epoch = 0
        tr.train(train, None, max_epochs=STEPS // 64)
        assert tr.global_step == STEPS
        psnrs.append(float(tr.evaluate(val)))
        if first is None:
            first = os.path.join(ws, "checkpoints", "t_ep0003.npz")
            os.replace(first, os.path.join(ws, "seed1_full.npz"))
            first = os.path.join(ws, "seed1_full.npz")
            snap = (jax.tree_util.tree_map(np.asarray, tr.params),
                    jax.tree_util.tree_map(np.asarray, tr.opt_state))
    return dict(init_ckpt=init_ckpt, psnrs=psnrs, full_ckpt=first,
                snap=snap, val=val, train=train, opts=tr.opt)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """_jax_band of the single-cascade recipe."""
    return _jax_band(str(tmp_path_factory.mktemp("jax_train")), "bound1")


@pytest.fixture(scope="module")
def jax_runs_bound2(tmp_path_factory):
    """_jax_band of the CLI's default recipe (the cascade march)."""
    return _jax_band(str(tmp_path_factory.mktemp("jax_train2")), "bound2")


def test_synthetic_scenes_agree():
    _, a, _ = jax_scene(n_train=2, n_val=1, res=16)
    _, b, _ = make_synthetic_scene(n_train=2, n_val=1, res=16)
    np.testing.assert_array_equal(a.poses, b.poses)
    np.testing.assert_allclose(a.images, b.images, atol=1e-6)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_training_matches_jax_band(recipe, request, tmp_path):
    """The port trains STEPS steps from the same init through
    cli.build_trainer and FastTrainer.train on the CPU. Its val PSNR must
    lie within [min JAX - 0.75 dB, max JAX + 0.75 dB] over seeds 1-3, and
    at least 4 dB above the seeded field's PSNR at step 0. A band and not a
    tolerance: threefry and Philox draw different rays, pixels and noise,
    so the two runs are two samples of one training process. (For
    reference, measured on the CPU with this fixture and init: at bound 1
    JAX reached 15.32 / 16.43 / 16.77 dB at 192 steps for seeds 1-3 and the
    port 15.10 dB from 8.39 dB at step 0; at bound 2 JAX 13.41 / 13.64 /
    14.30 dB and the port 13.11 dB from 6.69 dB.)"""
    jax_runs = request.getfixturevalue(
        "jax_runs" if recipe == "bound1" else "jax_runs_bound2")
    _, train, val = make_synthetic_scene(n_train=6, n_val=1, res=32)
    t0 = _port_trainer(jax_runs["init_ckpt"], str(tmp_path / "p0"),
                       recipe=recipe)
    t0.mark_untrained_grid(train.poses, train.intrinsics)
    t0.rebuild_grid()
    psnr0 = t0.evaluate(val)

    tr = _port_trainer(jax_runs["init_ckpt"], str(tmp_path / "p1"),
                       recipe=recipe)
    assert tr.field.cfg.scales == SCALES
    assert tr.field.cfg.planes == RECIPES[recipe][2]
    assert tr.march_cfg.multi == (recipe == "bound2")
    tr.train(train, None, max_epochs=10)
    assert tr.global_step == STEPS and tr.epoch == 3
    assert len(tr.history["loss"]) == STEPS
    assert np.isfinite(tr.history["loss"]).all()
    psnr = tr.evaluate(val)
    lo, hi = min(jax_runs["psnrs"]) - BAND_DB, max(jax_runs["psnrs"]) + BAND_DB
    print(f"port {psnr:.3f} dB (step 0: {psnr0:.3f}); JAX "
          f"{jax_runs['psnrs']}")
    assert lo <= psnr <= hi, (psnr, jax_runs["psnrs"])
    assert psnr >= psnr0 + 4.0, (psnr, psnr0)
    # a full checkpoint at the end; before it at most one a minute (a slow
    # host may have written one), pruned to max_keep_ckpt
    ckpts = sorted(os.listdir(tmp_path / "p1" / "checkpoints"))
    assert ckpts[-1] == "t_ep0003.npz" and len(ckpts) <= 2, ckpts


def test_adam_schedule_and_ema_match_optax(jax_runs, tmp_path):
    opts = jax_runs["opts"]
    tr = _port_trainer(jax_runs["init_ckpt"], str(tmp_path))
    state, _ = jax_ckpt.load_checkpoint(jax_runs["init_ckpt"])
    params = jax.tree_util.tree_map(jnp.asarray, state["model"]["params"])
    ema = jax.tree_util.tree_map(jnp.asarray, state["model"]["ema"])
    tx = optax.adam(lambda c: opts.lr * 0.1 ** jnp.minimum(c / opts.iters,
                                                           1.0),
                    b1=0.9, b2=0.99, eps=1e-15)
    opt_state = tx.init(params)
    rng = np.random.default_rng(0)
    d = opts.ema_decay
    for step in range(5):
        assert abs(tr.current_lr()
                   - opts.lr * 0.1 ** min(step / opts.iters, 1.0)) < 1e-12
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jax.tree_util.tree_map(lambda e, p: d * e + (1.0 - d) * p,
                                     ema, params)
        for p, g in zip(param_leaves(tr.params),
                        jax.tree_util.tree_leaves(grads)):
            p.grad = torch.from_numpy(np.asarray(g))
        tr.apply_gradients()
    for mine, ref in ((tr.params, params), (tr.ema_params, ema)):
        for a, b in zip(param_leaves(mine), jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-7)
    assert tr._optimizer_count() == 5


def test_one_train_step_matches_jax(jax_runs, tmp_path):
    tr = _port_trainer(jax_runs["init_ckpt"], str(tmp_path))
    state, _ = jax_ckpt.load_checkpoint(jax_runs["init_ckpt"])
    params = jax.tree_util.tree_map(jnp.asarray, state["model"]["params"])
    train = jax_runs["train"]
    rng = np.random.default_rng(5)
    n = 128
    inds = rng.integers(0, train.h * train.w, (1, n))
    rays = get_rays(torch.from_numpy(train.poses[2:3]),
                    torch.from_numpy(train.intrinsics), train.h, train.w,
                    inds=torch.from_numpy(inds))
    ro, rd = (rays[k][0].contiguous().numpy() for k in ("rays_o", "rays_d"))
    bg = rng.random((n, 3)).astype(np.float32)
    gt = rng.random((n, 3)).astype(np.float32)
    occ = rng.random((16, 16, 16)) < 0.6

    jcfg = JaxMarchCfg(bound=1.0, march_res=16, n_intervals=6,
                       steps_per_interval=3, min_near=0.2)
    fwd = make_fused_train_forward(JaxCPConfig(bound=1.0, scales=SCALES,
                                               planes=PLANES),
                                   interpret=True, tile=256)

    def loss_j(p):
        res = jax_render_dense(p, jnp.asarray(occ), jnp.asarray(ro),
                               jnp.asarray(rd), jcfg, fwd,
                               bg_color=jnp.asarray(bg))
        return jnp.mean((res["image"] - gt) ** 2)

    l_j, g_j = jax.value_and_grad(loss_j)(params)
    assert tr.march_cfg.n_intervals == 6 and tr.march_cfg.min_near == 0.2
    tr._occ_m = torch.from_numpy(occ)
    loss, n_samples = tr.loss_on(torch.from_numpy(ro), torch.from_numpy(rd),
                                 torch.from_numpy(gt), torch.from_numpy(bg))
    loss.backward()
    assert int(n_samples) > n
    np.testing.assert_allclose(float(loss.detach()), float(l_j), rtol=1e-3)
    for (k, a), p in zip(jax.tree_util.tree_leaves_with_path(g_j),
                         param_leaves(tr.params)):
        a = np.asarray(a)
        err = np.abs(p.grad.numpy() - a).max() / (np.abs(a).max() + 1e-12)
        assert err <= 1e-2, (jax.tree_util.keystr(k), err)


def _jax_refresh(dg, params, cfg, indices, u, decay=0.95, thresh_cap=10.0):
    """The reference FastTrainer's grid_update (train/fast.py) for one
    device and one cascade, with the cells and the uniform jitter given."""
    hh = 32
    h3 = hh ** 3
    idx = jnp.asarray(indices, jnp.int32)
    coords = jnp.stack([idx // (hh * hh), (idx // hh) % hh, idx % hh],
                       -1).astype(jnp.float32)
    xyz01 = 2.0 * coords / (hh - 1) - 1.0
    half = 1.0 / hh
    pts = xyz01 * (1.0 - half) + (jnp.asarray(u) * 2 - 1) * half
    d3 = jnp.zeros((3, pts.shape[0])).at[2].set(1.0)
    sig = make_fused_forward_planar(cfg, interpret=True)(params, pts.T, d3)[0]
    tmp = jnp.full((h3,), -1.0).at[idx].set(sig)
    dgc = jnp.asarray(dg)[0]
    valid = (dgc >= 0) & (tmp >= 0)
    new = jnp.where(valid, jnp.maximum(dgc * decay, tmp), dgc)[None]
    mean = jnp.mean(jnp.clip(new, 0.0, None))
    occ = new > jnp.minimum(mean, thresh_cap)
    return np.asarray(new), np.asarray(occ).reshape(1, hh, hh, hh)


@pytest.mark.parametrize("it", [0, 1, 40])
def test_grid_refresh_matches_jax(jax_runs, it):
    """it < 32: the deterministic half-grid slab of warm-up; after that
    H^3/2 random cells (duplicates allowed; the jitter is a function of the
    cell here, so whichever duplicate lands gives the same value)."""
    state, _ = jax_ckpt.load_checkpoint(jax_runs["init_ckpt"])
    jcfg = JaxCPConfig(bound=1.0, scales=SCALES, planes=PLANES)
    tcfg = CPConfig(bound=1.0, scales=SCALES, planes=PLANES)
    params = jax.tree_util.tree_map(jnp.asarray, state["model"]["params"])
    tables = pack_tables(params_from_jax(state["model"]["params"]), tcfg)
    gcfg = tgrid.GridConfig(grid_size=32, density_thresh=10.0)
    h3 = 32 ** 3
    rng = np.random.default_rng(it)
    dg = rng.uniform(0.0, 30.0, (1, h3)).astype(np.float32)
    dg[0, rng.random(h3) < 0.2] = -1.0
    gen = torch.Generator().manual_seed(it)
    idx = tgrid.refresh_indices(it, gcfg, gen).numpy()
    if it < tgrid.WARMUP_CALLS:
        np.testing.assert_array_equal(idx, (it % 2) * (h3 // 2)
                                      + np.arange(h3 // 2))
    else:
        assert idx.shape == (h3 // 2,) and idx.min() >= 0 and idx.max() < h3
        assert len(np.unique(idx)) < len(idx)          # duplicates allowed
    cell_u = rng.random((h3, 3)).astype(np.float32)
    u = cell_u[idx]
    ref_dg, ref_occ = _jax_refresh(dg, params, jcfg, idx, u)

    st = tgrid.init_grid_state(gcfg)
    st["density_grid"] = torch.from_numpy(dg)
    st["iter_density"] = torch.tensor(it, dtype=torch.int32)
    got = tgrid.update_density_grid(
        st, lambda p: field_forward(tables, tcfg, p.t().contiguous(), None,
                                    density_only=True)[0],
        gcfg, indices=torch.from_numpy(idx),
        noise_u=torch.from_numpy(u)[None])
    np.testing.assert_allclose(got["density_grid"].numpy(), ref_dg,
                               rtol=2e-2, atol=1e-4)
    assert (got["occ"].numpy() == ref_occ).mean() >= 0.999
    assert int(got["iter_density"]) == it + 1


def test_get_rays_draws_on_the_generator_device():
    """Random pixels are drawn on the poses' device from the given
    generator (before, they were drawn on the host without a device)."""
    poses = torch.eye(4)[None]
    intr = torch.tensor([20.0, 20.0, 16.0, 16.0])
    a = get_rays(poses, intr, 32, 32, 100,
                 generator=torch.Generator(poses.device).manual_seed(3))
    ref = torch.randint(0, 32 * 32, (100,), device=poses.device,
                        generator=torch.Generator(poses.device).manual_seed(3))
    assert a["inds"].device == poses.device
    assert torch.equal(a["inds"][0], ref)


def test_dataset_device():
    _, train, _ = make_synthetic_scene(n_train=2, n_val=1, res=16)
    data = train.device("cpu")
    assert data["images"].shape == (2, 16 * 16, 4)
    assert data["images"].dtype == torch.float32
    np.testing.assert_array_equal(data["images"][1].numpy().reshape(16, 16, 4),
                                  train.images[1])
    assert data["poses"].shape == (2, 4, 4)


def test_prune_checkpoints(tmp_path):
    d = tmp_path / "checkpoints"
    d.mkdir()
    for ep in (1, 2, 10, 3):
        (d / f"ngp_ep{ep:04d}.npz").write_bytes(b"")
    prune_checkpoints(str(tmp_path), "ngp", 2)
    assert sorted(os.listdir(d)) == ["ngp_ep0003.npz", "ngp_ep0010.npz"]


def test_optimizer_checkpoint_round_trip(jax_runs, tmp_path):
    """A JAX full checkpoint resumes in the port with bit-equal Adam
    moments and counts, and the port's full checkpoint loads back into the
    JAX Trainer."""
    params_ref, opt_ref = jax_runs["snap"]
    tr = _port_trainer(jax_runs["full_ckpt"], str(tmp_path))
    assert tr.global_step == STEPS
    assert tr._optimizer_count() == STEPS and tr.scheduler.last_epoch == STEPS
    adam = opt_ref[0]
    leaves = param_leaves(tr.params)
    for p, m, v in zip(leaves, jax.tree_util.tree_leaves(adam.mu),
                       jax.tree_util.tree_leaves(adam.nu)):
        st = tr.optimizer.state[p]
        np.testing.assert_array_equal(st["exp_avg"].numpy(), np.asarray(m))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(v))
    for a, b in zip(leaves, jax.tree_util.tree_leaves(params_ref)):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    assert abs(tr.current_lr() - tr.opt.lr * 0.1) < 1e-12
    assert abs(tr.optimizer.param_groups[0]["lr"] - tr.opt.lr * 0.1) < 1e-12

    out = tr.save_checkpoint(str(tmp_path / "port_full.npz"), full=True)
    ws = str(tmp_path / "jws")
    field = make_cp_field(jax.random.PRNGKey(1), JaxCPConfig(
        bound=1.0, scales=SCALES, planes=PLANES))
    jt = Trainer("t", _jax_opts(ws, 1), field, workspace=ws,
                 use_checkpoint="scratch")
    jt.load_checkpoint(out)
    assert jt.global_step == STEPS
    got = jax.tree_util.tree_leaves(jt.opt_state)
    want = jax.tree_util.tree_leaves(opt_ref)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
