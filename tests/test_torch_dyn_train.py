"""The ported dynamic (CP-D-NeRF) training path against the JAX package.

Same inputs from seeded numpy for both packages; params go over through a
checkpoint, and the port's trainer comes from `cli.build_trainer` as a
user's would. Tolerances:

- The refresh schedule, the anneal mask and matrix, the time curriculum's
  resolution, sorting and image window: exactly equal (integers, booleans
  and one f32 multiply).
- One refresh call of training against the reference's `dyn_grid_update`
  arithmetic (rebuilt here from its lines, one device) with the cells, the
  jitter and the times passed to both, on an analytic density that moves
  with time: density grid rtol 1e-5, occupancy, cursor and call count equal.
- The two Adam groups against `optax.multi_transform`, 5 steps of identical
  gradients: params and EMA rtol 1e-5.
- A full checkpoint with `lr_net` resumes bit-exactly in both directions.
- The slice as a whole: see test_dynamic_training_matches_jax_band.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from sealdnerf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from sealdnerf_tpu.models.cp import CPDNeRFConfig as JaxDynConfig
from sealdnerf_tpu.models.cp import make_cp_dnerf_field
from sealdnerf_tpu.render.dynamic_grid import \
    init_dyn_grid_state as jax_init_dyn_grid
from sealdnerf_tpu.train import checkpoint as jax_ckpt
from sealdnerf_tpu.train.fast import FastTrainer
from sealdnerf_tpu.train.trainer import TrainOptions
from sealdnerf_tpu_torch import cli, main_dnerf
from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
from sealdnerf_tpu_torch.models.cp import cp_dnerf_deform, param_leaves
from sealdnerf_tpu_torch.ops.marching_dense import downsample_occ
from sealdnerf_tpu_torch.render import dynamic_grid as tdyn

NARROW = dict(grid_size=16, march_res=8, n_intervals=6, steps_per_interval=3)
# narrow field; the encodings keep their default degrees, which a checkpoint
# cannot carry. The (64, 16) scale is "fine" under dyn_anneal_res = 32.
FIELD = dict(bound=1.0, scales=((16, 8), (64, 16)), planes=((16, 4),),
             num_layers_deform=3, hidden_dim_deform=32)
DYN = dict(lr_net=1e-3, time_curriculum_steps=48, dyn_anneal_steps=64,
           dyn_anneal_res=32, deform_zero_reg=1e-3)
STEPS = 96                     # 3 segments of 32 steps
SEEDS = (1, 2, 3)
BAND_DB = 0.75


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; a torch pool of
    every core in each makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_opts(ws, seed=1, **kw):
    return TrainOptions(**{**dict(
        iters=STEPS, num_rays=256, bound=1.0, dt_gamma=0.0, segment_steps=32,
        update_extra_interval=8, eval_interval=1000, workspace=ws, seed=seed),
        **NARROW, **DYN, **kw})


def _jax_trainer(name, ws, seed=0, **kw):
    field = make_cp_dnerf_field(jax.random.PRNGKey(seed),
                                JaxDynConfig(**FIELD))
    return FastTrainer(name, _jax_opts(ws, **kw), field, workspace=ws,
                       use_checkpoint="scratch", time_conditioned=True)


def _port_trainer(ckpt, ws, seed=1, extra=(), **kw):
    opt = main_dnerf.parse_args(
        ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--device",
         "cpu", "--ckpt", ckpt, "--workspace", ws, "--iters", str(STEPS),
         "--num_rays", "256", "--update_extra_interval",
         str(kw.pop("update_extra_interval", 8)), "--seed", str(seed),
         *extra])
    over = {**NARROW, **DYN, "segment_steps": 32, **kw}
    trainer, _ = cli.build_trainer(opt, name="t", dynamic=True, **over)
    return trainer


def _save(jtr, epoch, full):
    """The reference trainer names a checkpoint by its epoch."""
    jtr.epoch = epoch
    jtr.save_checkpoint(full=full, remove_old=False)
    return os.path.join(jtr.workspace, "checkpoints",
                        f"{jtr.name}_ep{epoch:04d}.npz")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX dynamic FastTrainer trained STEPS steps from PRNGKey(0)'s init
    for each seed, one compile for all; the init and each trained state as a
    checkpoint; the seed-1 run's full checkpoint after 64 steps and its
    optimizer state."""
    ws = str(tmp_path_factory.mktemp("jax_dyn_train"))
    _, train, val = jax_scene(n_train=6, n_val=3, res=32, dynamic=True)
    tr = _jax_trainer("t", ws)
    init = {k: jax.tree_util.tree_map(np.asarray, v) for k, v in (
        ("params", tr.params), ("ema", tr.ema_params))}
    init_ckpt = os.path.join(ws, "init.npz")
    jax_ckpt.save_checkpoint(init_ckpt, {"model": init},
                             {"epoch": 0, "global_step": 0})
    sorted_train = tr.enable_time_curriculum(train)
    data = sorted_train.device()
    h, w, c, n = train.h, train.w, train.images.shape[-1], len(train)
    trained, mid = [], None
    for seed in SEEDS:
        tr.rng = jax.random.PRNGKey(seed)
        tr.params = jax.tree_util.tree_map(jnp.asarray, init["params"])
        tr.ema_params = jax.tree_util.tree_map(jnp.asarray, init["ema"])
        tr.field.params = tr.params
        tr.opt_state = tr.tx.init(tr.params)
        tr.grid_state = jax_init_dyn_grid(tr.dyn_grid_cfg)
        tr.global_step = tr.local_step = tr.epoch = 0
        tr.mark_untrained_grid(sorted_train.poses, sorted_train.intrinsics)
        for seg in range(STEPS // 32):
            tr.train_segment(data, h, w, c, n, 32)
            if mid is None and seg == 1:
                mid = _save(tr, 100, full=True)
                snap = (jax.tree_util.tree_map(np.asarray, tr.params),
                        jax.tree_util.tree_map(np.asarray, tr.opt_state),
                        jax.tree_util.tree_map(np.asarray, tr.grid_state))
        assert tr.global_step == STEPS
        trained.append(_save(tr, seed, full=False))
    return dict(init_ckpt=init_ckpt, trained=trained, mid_ckpt=mid, snap=snap,
                train=train, val=val, jtr=tr)


# ------------------------------------------------------------- the schedule
def _reference_due(jtr, step, calls):
    """The reference's in-loop predicate (train/fast.py, device_segment's
    body) on host integers, with its own thresholds."""
    upd = jtr._segment_update_interval()
    do = step % upd == 0
    do = do and (calls < jtr._warmup_calls() or step % (2 * upd) == 0)
    return do and calls < jtr._dyn_freeze_calls(upd)


@pytest.mark.parametrize("interval,curriculum", [(16, 512), (16, 0), (8, 48)])
def test_refresh_schedule_matches_reference(tmp_path, interval, curriculum):
    """Which steps refresh the grid, from step 0 to past the freeze, for the
    CLI's defaults (a chance every 2 steps; 128 warm-up calls; freeze at
    call 592 with the 512-step curriculum and 464 without) and for this
    module's narrow options. grid_state["iter_density"] counts the calls."""
    kw = dict(update_extra_interval=interval,
              time_curriculum_steps=curriculum)
    jtr = _jax_trainer("s", str(tmp_path / "j"), **kw)
    ptr = _port_trainer("scratch", str(tmp_path / "p"), **kw)
    upd = ptr._segment_update_interval()
    assert upd == jtr._segment_update_interval() == max(1, interval // 8)
    assert ptr._warmup_calls() == jtr._warmup_calls() == 128
    freeze = jtr._dyn_freeze_calls(upd)
    assert ptr._dyn_freeze_calls(upd) == freeze
    if (interval, curriculum) == (16, 512):
        assert (upd, freeze) == (2, 592)
    calls, fired = 0, []
    for step in range(2600):
        due = ptr.dyn_refresh_due(step, calls)
        assert due == _reference_due(jtr, step, calls), (step, calls)
        if due:
            calls += 1
            fired.append(step)
    assert calls == freeze                      # frozen well before the end
    assert fired[:128] == list(range(0, 128 * upd, upd))
    assert fired[128:131] == [128 * upd + 2 * upd * k for k in range(3)]
    if (interval, curriculum) == (16, 512):
        assert sum(s < 512 for s in fired) == 192 and fired[-1] == 2108


def test_iter_density_counts_refresh_calls(jax_runs, tmp_path):
    """Repair of the two conventions: a full checkpoint that the reference's
    FastTrainer wrote mid-training carries a CALL count (64 after 64 steps
    at one chance per step), and the port's training loop resumes it at the
    same point of the warm-up schedule; the port's own refresh adds one per
    call, and a rebuild does not move the count."""
    _, _, grid = jax_runs["snap"]
    assert int(grid["iter_density"]) == 64
    tr = _port_trainer(jax_runs["mid_ckpt"], str(tmp_path))
    assert tr.global_step == 64
    assert tr._dyn_host_counts() == (64, int(grid["bin_cursor"])) == (64, 0)
    jtr = jax_runs["jtr"]
    for step in range(64, 200):
        assert tr.dyn_refresh_due(step, 64 + (step - 64)) == \
            _reference_due(jtr, step, 64 + (step - 64))
    tr._occ_m = None
    tr.refresh_grid()
    assert int(tr.grid_state["iter_density"]) == 65
    assert int(tr.grid_state["bin_cursor"]) == 8
    assert tr._dyn_host_counts() == (65, 8)
    assert tr._occ_m.shape == (64, 8, 8, 8)
    tr.rebuild_grid()
    assert int(tr.grid_state["iter_density"]) == 65
    assert tr._dyn_host_counts() == (65, 8)


# ----------------------------------------------------------- one refresh call
def _density_jax(x, t):
    cx, cy, cz = 0.5 * jnp.cos(2.0 * t), 0.5 * jnp.sin(2.0 * t), 0.2 * t
    r2 = (x[:, 0] - cx) ** 2 + (x[:, 1] - cy) ** 2 + (x[:, 2] - cz) ** 2
    return 30.0 * jnp.exp(-r2 / 0.2)


def _density_torch(x, t):
    cx, cy, cz = 0.5 * torch.cos(2.0 * t), 0.5 * torch.sin(2.0 * t), 0.2 * t
    r2 = (x[:, 0] - cx) ** 2 + (x[:, 1] - cy) ** 2 + (x[:, 2] - cz) ** 2
    return 30.0 * torch.exp(-r2 / 0.2)


def _jax_dyn_refresh(grid, hh, warmup_calls, rand, u_xyz, u_t, tsize=64,
                     nb=8, bound=1.0, decay=0.95, thresh_cap=10.0):
    """The reference FastTrainer's dyn_grid_update for one device, with the
    random cells and the uniform draws given."""
    h3 = hh ** 3
    n_pts = h3 // 2
    per_pass = -(-tsize // nb)
    cursor = grid["bin_cursor"]
    bin_ids = (cursor + jnp.arange(nb)) % tsize
    dg = grid["density_grid"]
    it = grid["iter_density"]
    vc = it // per_pass
    warm = it < warmup_calls
    slab = (vc % 2) * (h3 // 2) + jnp.arange(n_pts, dtype=jnp.int32)
    half = bound / hh
    for j in range(nb):
        indices = jnp.where(warm, slab, jnp.asarray(rand[j], jnp.int32))
        coords = jnp.stack([indices // (hh * hh), (indices // hh) % hh,
                            indices % hh], -1).astype(jnp.float32)
        xyz01 = 2.0 * coords / (hh - 1) - 1.0
        noise = (jnp.asarray(u_xyz[j]) * 2 - 1) * half
        pts = xyz01 * (bound - half) + noise
        t_j = (bin_ids[j] + jnp.asarray(u_t[j])) / tsize
        sig = _density_jax(pts, t_j)
        tmp = jnp.full((h3,), -1.0).at[indices].set(sig)
        dgj = dg[bin_ids[j], 0]
        valid = (dgj >= 0) & (tmp >= 0)
        dgj = jnp.where(valid, jnp.maximum(dgj * decay, tmp), dgj)
        dg = dg.at[bin_ids[j], 0].set(dgj)
    mean_density = jnp.mean(jnp.clip(dg, 0.0, None))
    occ = (dg > jnp.minimum(mean_density, thresh_cap)).reshape(
        (tsize, 1) + (hh,) * 3)
    return {"density_grid": dg, "occ": occ, "mean_density": mean_density,
            "iter_density": it + 1, "bin_cursor": (cursor + nb) % tsize}


@pytest.mark.parametrize("calls,cursor", [(0, 0), (9, 8), (130, 16), (131, 60)])
def test_refresh_call_matches_reference(calls, cursor):
    """calls < 128: the half-grid slab of visit calls // 8 (9 -> the second
    half); after that the given random cells (duplicates allowed: the jitter
    is a function of the cell here, so whichever duplicate lands gives the
    same value). cursor 60 wraps around the last bin."""
    hh, h3 = 8, 512
    cfg = tdyn.DynGridConfig(bound=1.0, grid_size=hh, density_thresh=10.0)
    rng = np.random.default_rng(calls)
    dg = rng.uniform(0.0, 30.0, (64, 1, h3)).astype(np.float32)
    dg[rng.random((64, 1, h3)) < 0.2] = -1.0
    rand = rng.integers(0, h3, (8, h3 // 2))
    cell_u = rng.random((h3, 3)).astype(np.float32)
    slab = ((calls // 8) % 2) * (h3 // 2) + np.arange(h3 // 2)
    u_xyz = np.stack([cell_u[slab if calls < 128 else rand[j]]
                      for j in range(8)])
    u_t = rng.random(8).astype(np.float32)
    ref = _jax_dyn_refresh(
        {"density_grid": jnp.asarray(dg),
         "iter_density": jnp.asarray(calls, jnp.int32),
         "bin_cursor": jnp.asarray(cursor, jnp.int32)},
        hh, 128, rand, u_xyz, u_t)

    st = tdyn.init_dyn_grid_state(cfg)
    st["density_grid"] = torch.from_numpy(dg.copy())
    st["iter_density"] = torch.tensor(calls, dtype=torch.int32)
    st["bin_cursor"] = torch.tensor(cursor, dtype=torch.int32)
    draws = {"indices": torch.from_numpy(rand),
             "u_xyz": torch.from_numpy(u_xyz), "u_t": torch.from_numpy(u_t)}
    got, sums = tdyn.refresh_dyn_density_grid(st, _density_torch, cfg, 128,
                                              draws=draws)
    np.testing.assert_allclose(got["density_grid"].numpy(),
                               np.asarray(ref["density_grid"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got["occ"].numpy(), np.asarray(ref["occ"]))
    np.testing.assert_allclose(float(got["mean_density"]),
                               float(ref["mean_density"]), rtol=1e-5)
    assert int(got["iter_density"]) == calls + 1
    assert int(got["bin_cursor"]) == (cursor + 8) % 64
    bins = [(cursor + j) % 64 for j in range(8)]
    untouched = [b for b in range(64) if b not in bins]
    np.testing.assert_array_equal(got["density_grid"].numpy()[untouched],
                                  dg[untouched])

    # a second call that is handed the per-bin sums of the first sums only
    # the 8 bins it changed, and finds the same mean, bit for bit, as one
    # that sums all 64 again
    draws2 = {k: v.clone() for k, v in draws.items()}
    a, sums_a = tdyn.refresh_dyn_density_grid(
        {k: v.clone() for k, v in got.items()}, _density_torch, cfg, 128,
        draws=draws2, bin_sums=sums)
    b, sums_b = tdyn.refresh_dyn_density_grid(
        {k: v.clone() for k, v in got.items()}, _density_torch, cfg, 128,
        draws=draws2)
    assert sums.dtype == torch.float64 and sums.shape == (64,)
    assert torch.equal(sums_a, sums_b)
    assert torch.equal(a["mean_density"], b["mean_density"])
    assert torch.equal(a["occ"], b["occ"])


def test_refresh_draws_come_from_the_generator():
    """Without `draws` the cells, the jitter and the times come from the
    trainer's generator, on the grid's device: the same seed gives the same
    grid, another seed another."""
    cfg = tdyn.DynGridConfig(bound=1.0, grid_size=8, density_thresh=10.0)

    def run(seed, calls):
        st = tdyn.init_dyn_grid_state(cfg)
        st["iter_density"] += calls
        gen = torch.Generator().manual_seed(seed)
        out, _ = tdyn.refresh_dyn_density_grid(st, _density_torch, cfg, 128,
                                               generator=gen)
        return out["density_grid"]

    for calls in (0, 200):
        assert torch.equal(run(3, calls), run(3, calls))
        assert not torch.equal(run(3, calls), run(4, calls))
    # after the warm-up only the drawn cells are touched: about
    # 1 - exp(-1/2) of a bin
    touched = (run(3, 200)[:8] > 0).float().mean().item()
    assert 0.3 < touched < 0.5


# ------------------------------------------------------------------ the anneal
def test_anneal_mask_and_matrix_match_reference(jax_runs, tmp_path):
    jtr = jax_runs["jtr"]
    tr = _port_trainer(jax_runs["init_ckpt"], str(tmp_path))
    mask = np.asarray(jtr._anneal_mask)
    np.testing.assert_array_equal(tr._anneal_mask.numpy(), mask)
    assert mask.sum() == 16 and mask[8:24].all()     # the (64, 16) scale
    for step in (0, 1, 37, 63, 64, 500):
        init_j = jax.tree_util.tree_map(
            jnp.asarray, jax_ckpt.load_checkpoint(
                jax_runs["init_ckpt"])[0]["model"]["params"])
        want = jtr._anneal_params(init_j, jnp.asarray(step, jnp.int32))
        with torch.no_grad():
            got = tr._anneal_params(tr.params, step)
        if step >= 64:
            assert got is tr.params
        init, _ = jax_ckpt.load_checkpoint(jax_runs["init_ckpt"])
        want0 = init["model"]["params"]["sigma_mlp"]["w"][0] * np.where(
            mask, np.float32(min(step / 64, 1.0)), np.float32(1.0))[:, None]
        np.testing.assert_array_equal(
            got["sigma_mlp"]["w"][0].detach().numpy(), want0)
        np.testing.assert_array_equal(
            want0, np.asarray(want["sigma_mlp"]["w"][0]))
        for a, b in zip(param_leaves(got), param_leaves(init["model"]["params"])):
            if a.shape != want0.shape:
                np.testing.assert_array_equal(a.detach().numpy(), b)
    # off: no mask; nothing fine enough: no mask
    assert _port_trainer("scratch", str(tmp_path / "a"),
                         dyn_anneal_steps=0)._anneal_mask is None
    assert _port_trainer(jax_runs["init_ckpt"], str(tmp_path / "b"),
                         dyn_anneal_res=64)._anneal_mask is None


def test_anneal_scales_the_fine_rows_gradient(jax_runs, tmp_path):
    """The ramp sits inside the differentiated function: at step 0 the fine
    rows of the first sigma matrix get a gradient of exactly 0, mid-ramp the
    annealed matrix's gradient times the ramp, and from dyn_anneal_steps on
    the gradient of the unannealed function."""
    _, train, _ = make_synthetic_scene(n_train=6, n_val=3, res=32,
                                       dynamic=True)
    tr = _port_trainer(jax_runs["init_ckpt"], str(tmp_path))
    tr.mark_untrained_grid(train.poses, train.intrinsics)
    tr.rebuild_grid()
    tr._occ_m = downsample_occ(tr.grid_state["occ"][:, 0], 8)
    batch = tr.sample_batch(train.device("cpu"), train.h, train.w)
    assert len(batch) == 7 and batch[5].shape == () and \
        batch[6].shape == (1024, 3)
    mask = tr._anneal_mask.numpy()

    def w0_grad(step, params=None):
        for p in param_leaves(tr.params):
            p.grad = None
        tr.global_step = step
        loss, n = tr.loss_on(*batch, params=params)
        loss.backward()
        assert int(n) > 0
        g = tr.params["sigma_mlp"]["w"][0].grad
        return None if g is None else g.numpy().copy()

    g0 = w0_grad(0)
    assert np.abs(g0[mask]).max() == 0.0 and np.abs(g0[~mask]).max() > 0.0
    # mid-ramp: through a detached copy of the annealed matrix
    annealed = tr._anneal_params(tr.params, 16)
    wa = annealed["sigma_mlp"]["w"][0].detach().requires_grad_(True)
    p2 = dict(annealed)
    p2["sigma_mlp"] = {"w": [wa, annealed["sigma_mlp"]["w"][1]]}
    w0_grad(16, params=p2)
    g_annealed = wa.grad.numpy().copy()
    g16 = w0_grad(16)
    colw = np.where(mask, np.float32(0.25), np.float32(1.0))[:, None]
    np.testing.assert_allclose(g16, g_annealed * colw, rtol=1e-6, atol=1e-12)
    assert np.abs(g16[mask]).max() > 0.0
    # past the ramp: the unannealed function
    g_late = w0_grad(64)
    off = _port_trainer(jax_runs["init_ckpt"], str(tmp_path / "off"),
                        dyn_anneal_steps=0)
    off._occ_m = tr._occ_m
    loss, _ = off.loss_on(*batch)
    loss.backward()
    np.testing.assert_array_equal(
        g_late, off.params["sigma_mlp"]["w"][0].grad.numpy())


# ------------------------------------------------------------- the curriculum
def test_time_curriculum_matches_reference(jax_runs, tmp_path):
    tr = _port_trainer("scratch", str(tmp_path))
    train = jax_runs["train"]
    mono = np.linspace(0, 1, 7, dtype=np.float32)
    for steps, times in ((-1, mono), (-1, np.repeat(mono, 3)), (-1, None),
                         (0, mono), (300, None), (-1, train.times)):
        assert tr.resolve_time_curriculum(steps, times) == \
            FastTrainer.resolve_time_curriculum(steps, times)
    assert tr.resolve_time_curriculum(-1, train.times) == 512   # monocular

    # the sorted dataset
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(train))
    shuffled = dataclasses.replace(train, poses=train.poses[perm],
                                   images=train.images[perm],
                                   times=train.times[perm])
    _, ttrain, _ = make_synthetic_scene(n_train=6, n_val=3, res=32,
                                        dynamic=True)
    tshuf = dataclasses.replace(ttrain, poses=ttrain.poses[perm],
                                images=ttrain.images[perm],
                                times=ttrain.times[perm])
    jtr = _jax_trainer("c", str(tmp_path / "j"))
    want = jtr.enable_time_curriculum(shuffled)
    assert not tr._time_sorted
    got = tr.enable_time_curriculum(tshuf)
    assert tr._time_sorted
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_allclose(got.images, want.images, atol=1e-6)
    assert (np.diff(got.times) >= 0).all()

    # the window of allowed images, step by step
    for cur, n in ((48, 6), (512, 48), (100, 7)):
        tr.opt.time_curriculum_steps = cur
        for step in range(0, cur + 40):
            frac = jnp.clip(jnp.asarray(step, jnp.int32).astype(jnp.float32)
                            / cur, 0.0, 1.0)
            ref = int(jnp.clip(jnp.ceil(frac * n).astype(jnp.int32) + 1, 1,
                               n))
            assert tr.n_allowed_images(step, n) == ref, (cur, n, step)
    assert tr.n_allowed_images(0, 48) == 1 and \
        tr.n_allowed_images(512, 48) == 48
    tr.opt.time_curriculum_steps = 0
    assert tr.n_allowed_images(0, 48) == 48

    # early steps draw from the first frames only
    tr.opt.time_curriculum_steps = 48
    data = got.device("cpu")
    seen = set()
    for _ in range(40):
        seen.add(float(tr.sample_batch(data, got.h, got.w)[5]))
    assert seen == {float(got.times[0])}
    tr.global_step = 20
    for _ in range(60):
        seen.add(float(tr.sample_batch(data, got.h, got.w)[5]))
    assert seen == {float(t) for t in got.times[:4]}


# --------------------------------------------------------------- the optimizer
def test_two_adam_groups_match_optax_multi_transform(jax_runs, tmp_path):
    tr = _port_trainer(jax_runs["init_ckpt"], str(tmp_path))
    opts = jax_runs["jtr"].opt
    assert [g["lr"] for g in tr.optimizer.param_groups] == [1e-2, 1e-3]
    labels = tr._leaf_labels()
    assert labels.count("net") == 2 + 3 + 3 and labels.count("enc") == 12
    state, _ = jax_ckpt.load_checkpoint(jax_runs["init_ckpt"])
    params = jax.tree_util.tree_map(jnp.asarray, state["model"]["params"])
    ema = jax.tree_util.tree_map(jnp.asarray, state["model"]["ema"])

    def sched(base):
        return lambda c: base * 0.1 ** jnp.minimum(c / opts.iters, 1.0)

    tx = optax.multi_transform(
        {"enc": optax.adam(sched(opts.lr), b1=0.9, b2=0.99, eps=1e-15),
         "net": optax.adam(sched(opts.lr_net), b1=0.9, b2=0.99, eps=1e-15)},
        lambda p: {k: jax.tree_util.tree_map(
            lambda _: "net" if "mlp" in k else "enc", v)
            for k, v in p.items()})
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
    rates = [g["lr"] for g in tr.optimizer.param_groups]
    np.testing.assert_allclose(rates, [1e-2 * 0.1 ** (5 / STEPS),
                                       1e-3 * 0.1 ** (5 / STEPS)], rtol=1e-12)


def test_dynamic_optimizer_checkpoint_round_trip(jax_runs, tmp_path):
    """A full dynamic checkpoint of the JAX FastTrainer with lr_net (optax
    multi_transform's state: per label a masked Adam state) resumes in the
    port with bit-equal moments and counts, and the port's full checkpoint
    loads back into a JAX dynamic trainer."""
    params_ref, opt_ref, grid_ref = jax_runs["snap"]
    tr = _port_trainer(jax_runs["mid_ckpt"], str(tmp_path))
    assert tr.global_step == 64
    assert tr._optimizer_count() == 64 and tr.scheduler.last_epoch == 64
    leaves, labels = param_leaves(tr.params), tr._leaf_labels()
    inner = {k: v.inner_state[0] for k, v in opt_ref.inner_states.items()}
    its = {k: (iter(jax.tree_util.tree_leaves(v.mu)),
               iter(jax.tree_util.tree_leaves(v.nu)))
           for k, v in inner.items()}
    for p, lab in zip(leaves, labels):
        st = tr.optimizer.state[p]
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      np.asarray(next(its[lab][0])))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(next(its[lab][1])))
        assert float(st["step"]) == 64.0
    for a, b in zip(leaves, jax.tree_util.tree_leaves(params_ref)):
        np.testing.assert_array_equal(a.detach().numpy(), b)
    np.testing.assert_allclose(
        [g["lr"] for g in tr.optimizer.param_groups],
        [1e-2 * 0.1 ** (64 / STEPS), 1e-3 * 0.1 ** (64 / STEPS)], rtol=1e-12)

    out = tr.save_checkpoint(str(tmp_path / "port_full.npz"), full=True)
    jt = _jax_trainer("b", str(tmp_path / "jws"), seed=5)
    jt.load_checkpoint(out)
    assert jt.global_step == 64
    got = jax.tree_util.tree_leaves(jt.opt_state)
    want = jax.tree_util.tree_leaves(opt_ref)
    assert len(got) == len(want) == 2 * (2 + 20)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jax.tree_util.tree_structure(jt.opt_state) == \
        jax.tree_util.tree_structure(jax_runs["jtr"].opt_state)
    for k in ("density_grid", "iter_density", "bin_cursor"):
        np.testing.assert_array_equal(np.asarray(jt.grid_state[k]),
                                      grid_ref[k])
    # a trainer with one rate does not take the two-rate state, and says so
    one = _port_trainer(jax_runs["mid_ckpt"], str(tmp_path / "one"),
                        lr_net=None)
    assert one._optimizer_count() == 0 and one.global_step == 64
    assert "not loaded" in open(one.log_path).read()


# --------------------------------------------------------- the slice as a whole
def _mean_deform(tr, t=0.7):
    x = torch.from_numpy(np.random.default_rng(7).uniform(
        -1.0, 1.0, (4096, 3)).astype(np.float32))
    with torch.no_grad():
        return cp_dnerf_deform(tr._infer_params(), tr.field.cfg, x,
                               t).abs().mean().item()


def test_dynamic_training_matches_jax_band(jax_runs, tmp_path):
    """The port trains STEPS steps from the same init through
    cli.build_trainer and FastTrainer.train on the CPU, with every piece of
    the dynamic recipe on at a length that these steps reach (curriculum 48
    steps, anneal 64, zero-reg, two rates). Both packages' trained states
    are served by the port's renderer (held against the reference's in
    test_torch_dyn_slice.py), each val view at its own time. The port's PSNR
    must lie within [min JAX - 0.75 dB, max JAX + 0.75 dB] over seeds 1-3
    and above the seeded field's. A band and not a tolerance: threefry and
    Philox draw different rays, so the runs are samples of one process. The
    deform tower must be alive: mean |deform(x, 0.7)| over 4096 scene points
    larger than before training and above 1e-3. (Measured on the CPU with
    this fixture: JAX 9.43 / 9.45 / 9.38 dB for seeds 1-3, the port 9.28 dB
    from 7.50 dB at step 0; mean |deform| 5.7e-5 -> 8.5e-2.)"""
    _, train, val = make_synthetic_scene(n_train=6, n_val=3, res=32,
                                         dynamic=True)
    jax_psnrs = []
    for path in jax_runs["trained"]:
        served = _port_trainer(path, str(tmp_path / "serve"))
        assert served.global_step == STEPS
        jax_psnrs.append(served.evaluate(val))
    t0 = _port_trainer(jax_runs["init_ckpt"], str(tmp_path / "p0"))
    t0.mark_untrained_grid(train.poses, train.intrinsics)
    t0.rebuild_grid()
    psnr0, deform0 = t0.evaluate(val), _mean_deform(t0)

    tr = _port_trainer(jax_runs["init_ckpt"], str(tmp_path / "p1"))
    tr.train(train, None, max_epochs=10)
    assert tr.global_step == STEPS and tr.epoch == 3 and tr._time_sorted
    assert tr.opt.time_curriculum_steps == 48
    assert len(tr.history["loss"]) == STEPS
    assert np.isfinite(tr.history["loss"]).all()
    # one chance per step, all inside the warm-up: a refresh at every step
    assert int(tr.grid_state["iter_density"]) == STEPS
    assert int(tr.grid_state["bin_cursor"]) == (8 * STEPS) % 64
    psnr, deform = tr.evaluate(val), _mean_deform(tr)
    lo, hi = min(jax_psnrs) - BAND_DB, max(jax_psnrs) + BAND_DB
    print(f"port {psnr:.3f} dB (step 0: {psnr0:.3f}); JAX {jax_psnrs}; mean "
          f"|deform| {deform0:.3g} -> {deform:.3g}")
    assert lo <= psnr <= hi, (psnr, jax_psnrs)
    assert psnr > psnr0 + 1.0, (psnr, psnr0)
    assert deform > deform0 and deform > 1e-3, (deform0, deform)
    # a full checkpoint at the end, which --test then serves; before it at
    # most one a minute (a slow host may have written one)
    ckpts = sorted(os.listdir(tmp_path / "p1" / "checkpoints"))
    assert ckpts[-1] == "t_ep0003.npz" and len(ckpts) <= 2, ckpts
    again = _port_trainer("latest", str(tmp_path / "p1"), extra=["--test"])
    assert again.global_step == STEPS and again._optimizer_count() == STEPS
    np.testing.assert_array_equal(again.grid_state["occ"].numpy(),
                                  tr.grid_state["occ"].numpy())


def test_main_dnerf_trains_on_the_cpu(tmp_path, monkeypatch):
    """`main_dnerf synthetic -O --bound 1 --dt_gamma 0 --device cpu` end to
    end at a tiny size: the full-width seeded field, 48 steps (one epoch) of
    64 rays, evaluation, frames, and a checkpoint that --test serves."""
    monkeypatch.setattr(
        main_dnerf, "build_trainer",
        lambda opt, **kw: cli.build_trainer(opt, **kw, **NARROW,
                                            segment_steps=8))
    ws = str(tmp_path)
    base = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--device",
            "cpu", "--synthetic_res", "32", "--workspace", ws]
    main_dnerf.main(base + ["--ckpt", "scratch", "--iters", "16",
                            "--num_rays", "64"])
    assert len(os.listdir(os.path.join(ws, "results"))) == 6
    assert os.listdir(os.path.join(ws, "checkpoints")) == ["ngp_ep0001.npz"]
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert "[epoch 1]" in log and "step=48" in log and "PSNR" in log
    main_dnerf.main(base + ["--test"])
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert "loaded checkpoint" in log and "(epoch 1, step 48)" in log
