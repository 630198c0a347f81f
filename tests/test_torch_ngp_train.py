"""The port's Trainer (the Instant-NGP and D-NeRF trainer over render_occ)
and its CLI routes against the JAX package.

Narrow fields (4 levels, log2_hashmap_size 12), a 32^3 occupancy grid, the
synthetic scene at 32 px; inits carried across from the reference's.
Tolerances:
- one training step on the same rays, background, march offsets and
  occupancy: loss rtol 1e-3, gradients per leaf within 5e-2 in relative L2
  norm (test_torch_packed.py gives the reason), and Adam and the EMA on the
  same gradients rtol 1e-5;
- the two Adam groups (lr_net) of the D-NeRF trainer against optax's
  multi_transform over 3 steps of identical gradients: rtol 1e-5;
- _update_budget: the same budgets for the same measured means;
- checkpoints both ways: params equal, the optimizer state resumed; a
  JAX-trained NGP checkpoint served by the port within the serving slices'
  frame limit (max |diff| <= 2e-2);
- 192 narrow NGP steps: val PSNR within the band of three JAX seeds
  widened by 0.75 dB (threefry and Philox draw different rays);
- the reference's faults, pinned: its dynamic rebuild refreshes 8 of the 64
  time bins (the port's every bin), and a slim checkpoint loads into the
  port's dynamic trainer;
- main_nerf --backbone ngp and main_dnerf --bound 2 end to end with
  --device cpu; --basis and --hyper route to their variants; --backbone cp
  with --bg_radius still exits.
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from sealdnerf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from sealdnerf_tpu.models.api import make_dnerf_field as jax_dnerf_field
from sealdnerf_tpu.models.api import make_ngp_field as jax_ngp_field
from sealdnerf_tpu.models.dnerf import DNeRFConfig as JaxDNeRFConfig
from sealdnerf_tpu.models.ngp import NGPConfig as JaxNGPConfig
from sealdnerf_tpu.parallel.mesh import make_mesh
from sealdnerf_tpu.render import renderer as jr
from sealdnerf_tpu.train.trainer import Trainer as JaxTrainer
from sealdnerf_tpu.train.trainer import TrainOptions as JaxOptions
from sealdnerf_tpu_torch import cli, main_dnerf, main_nerf
from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
from sealdnerf_tpu_torch.models import dnerf as td
from sealdnerf_tpu_torch.models import ngp as tn
from sealdnerf_tpu_torch.models.api import make_dnerf_field, make_ngp_field
from sealdnerf_tpu_torch.models.params import param_leaves, params_from_jax
from sealdnerf_tpu_torch.train.fast import FastTrainer
from sealdnerf_tpu_torch.train.trainer import Trainer, TrainOptions

NARROW = dict(num_levels=4, log2_hashmap_size=12)
DYN_NARROW = dict(NARROW, num_layers_deform=3, hidden_dim_deform=32)
GRID = dict(grid_size=32, max_steps=256)
STEPS = 192
SEEDS = (1, 2, 3)
BAND_DB = 0.75
GRAD_TOL = 5e-2
FRAME_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _opts(cls, ws, **kw):
    return cls(**{**dict(iters=STEPS, num_rays=256, bound=2.0,
                         update_extra_interval=8, eval_interval=1000,
                         segment_steps=64, workspace=ws, **GRID), **kw})


def _jax_trainer(ws, dynamic=False, **kw):
    if dynamic:
        field = jax_dnerf_field(jax.random.PRNGKey(0), JaxDNeRFConfig(
            bound=2.0, **DYN_NARROW))
    else:
        field = jax_ngp_field(jax.random.PRNGKey(0), JaxNGPConfig(
            bound=2.0, **NARROW))
    return JaxTrainer("t", _opts(JaxOptions, ws, **kw), field, workspace=ws,
                      use_checkpoint="scratch",
                      mesh=make_mesh(jax.devices()[:1]),
                      time_conditioned=dynamic)


def _port_trainer(ws, jparams=None, dynamic=False, **kw):
    gen = torch.Generator().manual_seed(0)
    if dynamic:
        field = make_dnerf_field(gen, td.DNeRFConfig(bound=2.0, **DYN_NARROW))
    else:
        field = make_ngp_field(gen, tn.NGPConfig(bound=2.0, **NARROW))
    if jparams is not None:
        field.params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jparams))
    return Trainer("t", _opts(TrainOptions, ws, **kw), field, workspace=ws,
                   use_checkpoint="scratch", device="cpu",
                   time_conditioned=dynamic)


def _occ(cas, h=32, seed=1):
    c = (np.arange(h) + 0.5) / h * 2 - 1
    r = np.sqrt(sum(np.meshgrid(c * c, c * c, c * c, indexing="ij")))
    rng = np.random.default_rng(seed)
    return ((r < 0.7)[None] | (rng.uniform(size=(cas, h, h, h)) < 0.1))


def test_one_train_step_matches_jax(tmp_path):
    jt = _jax_trainer(str(tmp_path / "j"))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1e4 if a.ndim == 2 and a.shape[1] == 2
                                   else 1.0), jt.params)
    tt = _port_trainer(str(tmp_path / "t"), params)
    occ = _occ(2)
    tt.grid_state["occ"] = _t(occ)
    _, train, _ = jax_scene(n_train=2, n_val=1, res=32)
    rng = np.random.default_rng(3)
    inds = rng.integers(0, 32 * 32, 256)
    from sealdnerf_tpu_torch.data.rays import get_rays
    rays = get_rays(_t(train.poses[:1]), _t(train.intrinsics), 32, 32,
                    inds=_t(inds)[None])
    ro, rd = rays["rays_o"][0], rays["rays_d"][0]
    pix = train.images[0].reshape(-1, 4)[inds]
    bg = rng.uniform(size=(256, 3)).astype(np.float32)
    gt = pix[:, :3] * pix[:, 3:] + bg * (1 - pix[:, 3:])
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.uniform(key, (256,)))

    def jloss(p):
        res = jr.render_occ(p, jnp.asarray(occ), jnp.asarray(ro.numpy()),
                            jnp.asarray(rd.numpy()), jt.settings,
                            jt.field.forward, jt.field.background,
                            bg_color=jnp.asarray(bg), rng=key, perturb=True)
        return jnp.mean((res["image"] - gt) ** 2)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    lj, gj = jax.value_and_grad(jloss)(jp)
    lt, _ = tt.loss_on(ro, rd, _t(gt), _t(bg), _t(noise))
    tt.optimizer.zero_grad(set_to_none=True)
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-3)
    leaves = param_leaves(tt.params)
    errs = [float(np.linalg.norm(p.grad.numpy() - np.asarray(g))
                  / np.linalg.norm(np.asarray(g)))
            for p, g in zip(leaves, jax.tree_util.tree_leaves(gj))]
    assert max(errs) <= GRAD_TOL, errs
    # Adam, the schedule and the EMA on the reference's gradients
    for p, g in zip(leaves, jax.tree_util.tree_leaves(gj)):
        p.grad = _t(g)
    tt.apply_gradients()
    upd, _ = jt.tx.update(gj, jt.tx.init(jp), jp)
    want = optax.apply_updates(jp, upd)
    ema = jax.tree_util.tree_map(lambda e, p: 0.95 * e + 0.05 * p, jp, want)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)
    for a, b in zip(param_leaves(tt.ema_params),
                    jax.tree_util.tree_leaves(ema)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


def test_two_adam_groups_match_optax(tmp_path):
    jt = _jax_trainer(str(tmp_path / "j"), dynamic=True, lr=5e-4,
                      lr_net=5e-5)
    tt = _port_trainer(str(tmp_path / "t"), jt.params, dynamic=True,
                       lr=5e-4, lr_net=5e-5)
    assert [len(g["params"]) for g in tt.optimizer.param_groups] == [1, 8]
    jp, state = jt.params, jt.opt_state
    rng = np.random.default_rng(4)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(size=a.shape).astype(
                np.float32)), jp)
        upd, state = jt.tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(param_leaves(tt.params),
                        jax.tree_util.tree_leaves(grads)):
            p.grad = _t(g)
        tt.apply_gradients()
    for a, b in zip(param_leaves(tt.params), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-8)
    assert abs(tt.current_lr() - 5e-4 * 0.1 ** (3 / STEPS)) < 1e-12


def test_update_budget_matches_jax(tmp_path):
    jt = _jax_trainer(str(tmp_path / "j"))
    tt = _port_trainer(str(tmp_path / "t"))
    for mean in (0.0, 40.0, 20.0, 9.0, 4.0, 3.0, 15.0, 100.0):
        jt.mean_count = tt.mean_count = mean
        jt._update_budget()
        tt._update_budget()
        assert tt._cur_budget == jt._cur_budget, mean
    assert tt._cur_budget == 48


def _check_params_equal(a, b):
    for x, y in zip(param_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x.detach()), np.asarray(y))


def test_checkpoints_cross_both_ways(tmp_path):
    """A JAX-trained NGP checkpoint (full, with Adam's state) served and
    resumed by the port, and the port's read back by the reference."""
    _, train, val = jax_scene(n_train=4, n_val=1, res=32)
    jt = _jax_trainer(str(tmp_path / "j"), iters=64)
    jt.train(train, None, max_epochs=16)
    path = os.path.join(str(tmp_path / "j"), "checkpoints",
                        sorted(os.listdir(tmp_path / "j" / "checkpoints"))[-1])
    tt = _port_trainer(str(tmp_path / "t"))
    tt.load_checkpoint(path)
    _check_params_equal(tt.params, jt.params)
    assert tt.global_step == jt.global_step == 64
    assert tt._optimizer_count() == 64
    np.testing.assert_array_equal(tt.grid_state["occ"].numpy(),
                                  np.asarray(jt.grid_state["occ"]))
    img_j, dep_j = jt.render_image(val.poses[0], val.intrinsics, 32, 32)
    img_t, dep_t = tt.render_image(val.poses[0], val.intrinsics, 32, 32)
    assert np.abs(img_t - img_j).max() <= FRAME_TOL
    assert np.abs(dep_t - dep_j).max() <= FRAME_TOL * 4   # bound 2
    # the port's full checkpoint, read back by the reference
    out = tt.save_checkpoint(path=str(tmp_path / "port.npz"), full=True)
    jt2 = _jax_trainer(str(tmp_path / "j2"))
    jt2.load_checkpoint(out)
    _check_params_equal(tt.params, jt2.params)
    mu = jax.tree_util.tree_leaves(jt2.opt_state[0].mu)
    for a, p in zip(mu, param_leaves(tt.params)):
        np.testing.assert_array_equal(
            np.asarray(a), tt.optimizer.state[p]["exp_avg"].numpy())


def test_dynamic_rebuild_and_slim_checkpoint(tmp_path):
    """The reference's rebuild refreshes 8 of the 64 time bins; the port's
    every bin. A slim checkpoint (no density grid) does not load into the
    reference's dynamic trainer; the port's rebuilds its grid."""
    jt = _jax_trainer(str(tmp_path / "j"), dynamic=True)
    jt.rebuild_grid()
    touched = (np.asarray(jt.grid_state["density_grid"]) != 0).any(
        axis=(1, 2))
    assert touched.sum() == 8
    tt = _port_trainer(str(tmp_path / "t"), jt.params, dynamic=True)
    tt.rebuild_grid()
    assert (tt.grid_state["density_grid"] != 0).any(dim=2).any(dim=1).all()
    assert int(tt.grid_state["iter_density"]) == 0
    tt.stats["results"].append(10.0)
    slim = tt.save_checkpoint(best=True)
    with pytest.raises(Exception):
        _jax_trainer(str(tmp_path / "j2"), dynamic=True).load_checkpoint(
            slim)
    tt2 = _port_trainer(str(tmp_path / "t2"), dynamic=True)
    tt2.load_checkpoint(slim)
    _check_params_equal(tt2.params, jax.tree_util.tree_map(
        lambda x: x.detach().numpy(), tt.params))
    assert bool(tt2.grid_state["occ"].any(dim=(1, 2, 3, 4)).all())


def test_training_in_jax_band(tmp_path):
    """STEPS narrow NGP steps at bound 2 (dt_gamma 1/128, two cascades)
    from the reference's init: the port's val PSNR within the band of the
    reference's three seeds."""
    _, jtrain, jval = jax_scene(n_train=6, n_val=1, res=32)
    _, train, val = make_synthetic_scene(n_train=6, n_val=1, res=32)
    jt = _jax_trainer(str(tmp_path / "j"))
    init = jax.tree_util.tree_map(np.asarray, jt.params)
    band = []
    for seed in SEEDS:
        jt.rng = jax.random.PRNGKey(seed)
        jt.params = jax.tree_util.tree_map(jnp.asarray, init)
        jt.ema_params = jax.tree_util.tree_map(jnp.asarray, init)
        jt.field.params = jt.params
        jt.opt_state = jt.tx.init(jt.params)
        from sealdnerf_tpu.render.grid import init_grid_state
        jt.grid_state = init_grid_state(jt.grid_cfg)
        jt.global_step = jt.local_step = jt.epoch = 0
        jt.mean_count, jt._cur_budget = 0.0, jt.opt.samples_per_ray
        jt._train_sig = None
        jt.train(jtrain, None, max_epochs=STEPS // 6)
        assert jt.global_step == STEPS
        band.append(float(jt.evaluate(jval)))
    tt = _port_trainer(str(tmp_path / "t"), init, seed=1)
    tt.train(train, None, max_epochs=STEPS // 64)
    assert tt.global_step == STEPS and len(tt.history["loss"]) == STEPS
    got = tt.evaluate(val)
    print(f"port {got:.3f} dB; JAX {band}")
    assert min(band) - BAND_DB <= got <= max(band) + BAND_DB, (got, band)
    assert got > 14.0


# -------------------------------------------------------------- the CLIs
def _narrow_cli(monkeypatch, module):
    monkeypatch.setattr(tn, "NGPConfig",
                        functools.partial(tn.NGPConfig, **NARROW))
    monkeypatch.setattr(td, "DNeRFConfig",
                        functools.partial(td.DNeRFConfig, **DYN_NARROW))
    monkeypatch.setattr(module, "build_trainer", lambda opt, **kw:
                        cli.build_trainer(opt, **kw, grid_size=32,
                                          march_res=16, segment_steps=16))


def test_main_nerf_ngp_on_the_cpu(tmp_path, monkeypatch):
    """`main_nerf synthetic -O --backbone ngp --device cpu` (bound 2,
    dt_gamma 1/128) trains, evaluates and writes its frames on FastTrainer
    (the cascade march over both cascades; K5's plain version serves the
    frames); --test serves its checkpoint, and main_SealNeRF's teacher
    (Trainer) and student (StudentTrainer) take it over."""
    _narrow_cli(monkeypatch, main_nerf)
    ws = str(tmp_path)
    base = ["synthetic", "-O", "--backbone", "ngp", "--device", "cpu",
            "--synthetic_res", "32", "--workspace", ws, "--max_steps", "256"]
    monkeypatch.setattr(main_nerf, "MESH_RESOLUTION", 32)
    tr = main_nerf.main(base + ["--ckpt", "scratch", "--iters", "16",
                                "--num_rays", "64"])
    assert type(tr) is FastTrainer and tr.global_step == 48
    assert tr.march_cfg.cascades == 2 and tr.march_cfg.dt_gamma == 1 / 128
    assert len([f for f in os.listdir(os.path.join(ws, "results"))
                if f.endswith(".png")]) == 6
    assert os.listdir(os.path.join(ws, "meshes")) == ["ngp_1.ply"]
    assert np.isfinite(tr.history["loss"]).all()
    tr = main_nerf.main(base + ["--test"])
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert "loaded checkpoint" in log and "(epoch 1, step 48)" in log
    # main_SealNeRF edits it with the StudentTrainer (the CLI end to end:
    # tests/test_torch_ngp_edit_cli.py)
    import json
    from sealdnerf_tpu_torch import main_SealNeRF
    from sealdnerf_tpu_torch.editing.student import StudentTrainer
    from torch_edit_setup import seal_config
    os.makedirs(tmp_path / "edit")
    with open(tmp_path / "edit" / "seal.json", "w") as f:
        json.dump(seal_config(), f)
    _, st, _ = cli.build_edit_trainers(main_SealNeRF.parse_args(
        ["synthetic", "-O", "--backbone", "ngp", "--device", "cpu",
         "--teacher_workspace", ws, "--workspace", str(tmp_path / "edit"),
         "--log2_hashmap_size", "12"]), grid_size=32)
    assert type(st) is StudentTrainer and st.global_step == 0


def test_main_dnerf_bound2_on_the_cpu(tmp_path, monkeypatch):
    """`main_dnerf synthetic -O --bound 2 --device cpu` routes to the D-NeRF
    deform field and trains it end to end at the hash backbone's rates."""
    _narrow_cli(monkeypatch, main_dnerf)
    ws = str(tmp_path)
    main_dnerf.main(["synthetic", "-O", "--bound", "2", "--device", "cpu",
                     "--synthetic_res", "32", "--workspace", ws,
                     "--max_steps", "256", "--ckpt", "scratch", "--iters",
                     "16", "--num_rays", "64", "--update_extra_interval", "64"])
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert "[epoch 1]" in log and "step=48" in log and "PSNR" in log
    assert len(os.listdir(os.path.join(ws, "results"))) == 6


@pytest.mark.parametrize("flags,variant", [
    (["--basis"], "basis"), (["--hyper"], "hyper"),
    (["--backbone", "ngp", "--bound", "1"], "deform")])
def test_dynamic_routes(tmp_path, monkeypatch, flags, variant):
    _narrow_cli(monkeypatch, main_dnerf)
    opt = main_dnerf.parse_args(["synthetic", "-O", "--device", "cpu",
                                 "--workspace", str(tmp_path), "--ckpt",
                                 "scratch"] + flags)
    assert (opt.lr, opt.lr_net) == (5e-4, 5e-4)
    tr, field = cli.build_trainer(opt, dynamic=True, grid_size=32,
                                  lr_net=opt.lr_net)
    assert type(tr) is Trainer and field.cfg.variant == variant
    assert tr.time_conditioned


def test_cp_refusals_remain(tmp_path):
    opt = cli.postprocess(cli.base_parser().parse_args(
        ["synthetic", "-O", "--device", "cpu", "--backbone", "cp",
         "--bg_radius", "1", "--workspace", str(tmp_path)]))
    with pytest.raises(SystemExit):
        cli.build_trainer(opt)
    opt.backbone, opt.bound = "cp", 2.0
    opt.bg_radius = -1
    with pytest.raises(SystemExit):
        cli.build_trainer(opt, dynamic=True)
