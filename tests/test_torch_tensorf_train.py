"""The port's Trainer on the TensoRF field, CCNeRF's K-loss and
main_tensoRF (TensoRFTrainer) against the JAX package.

A narrow VM field (resolution 32, ranks 4 / 8) and a narrow CP one (rank
8), a 32^3 occupancy grid, the synthetic scene at 32 px, inits carried
across from the reference's. Tolerances:
- one training step on the same rays, background, march offsets and
  occupancy, and the same with k_rank_fracs (0.25, 0.5) (the reference's
  loss: every level renders with the step's one perturbation key): loss
  rtol 1e-3, gradients per leaf within 5e-2 in relative L2 norm (the
  packed march's sample sets may differ at a few cell boundaries, as in
  tests/test_torch_ngp_train.py); every level is given the same offsets;
- the two Adam groups (factors at lr0, basis_grid and color_mlp at lr1)
  against optax's multi_transform over 3 steps of identical gradients: rtol
  1e-5, atol 1e-7 (f32 rounding of updates of 2e-2 a step near 0);
- TensoRFTrainer: the reference's upsample resolutions and steps, the
  resize at its step, and afterwards a fresh Adam, EMA and schedule (the
  reference's tx.init);
- --upsample_model_steps appends to the default list, as in the reference;
- main_tensoRF end to end with --device cpu (resolution 16 -> 24 in two
  upsamples, 48 steps), then --test from the upsampled checkpoint;
- checkpoints both ways: a full JAX checkpoint saved after an upsample
  loads into a TensoRFTrainer built at resolution0, and the port's into
  the reference's trainer: params equal.
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import main_tensoRF as jax_main_tensoRF
from sealdnerf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from sealdnerf_tpu.models import tensorf as jt
from sealdnerf_tpu.parallel.mesh import make_mesh
from sealdnerf_tpu.render import renderer as jr
from sealdnerf_tpu.train.trainer import Trainer as JaxTrainer
from sealdnerf_tpu.train.trainer import TrainOptions as JaxOptions
from sealdnerf_tpu_torch import main_tensoRF
from sealdnerf_tpu_torch.data.rays import get_rays
from sealdnerf_tpu_torch.models import tensorf as tt
from sealdnerf_tpu_torch.models.api import make_tensorf_field
from sealdnerf_tpu_torch.models.params import (map_params, param_leaves,
                                               params_from_jax)
from sealdnerf_tpu_torch.train import trainer as trainer_mod
from sealdnerf_tpu_torch.train.trainer import Trainer, TrainOptions

NARROW = {"vm": dict(decomposition="vm", resolution=32, sigma_rank=(4, 4, 4),
                     color_rank=(8, 8, 8)),
          "cp": dict(decomposition="cp", resolution=32, sigma_rank=(8,),
                     color_rank=(8,))}
GRID = dict(grid_size=32, max_steps=256)
GRAD_TOL = 5e-2
FRACS = (0.25, 0.5)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _opts(cls, ws, **kw):
    return cls(**{**dict(iters=192, num_rays=256, bound=2.0, lr=2e-2,
                         update_extra_interval=8, eval_interval=1000,
                         workspace=ws, **GRID), **kw})


def _jax_trainer(ws, kind="vm", **kw):
    field = jt.make_tensorf_field(jax.random.PRNGKey(0), jt.TensoRFConfig(
        bound=2.0, **NARROW[kind]))
    return JaxTrainer("t", _opts(JaxOptions, ws, **kw), field, workspace=ws,
                      use_checkpoint="scratch",
                      mesh=make_mesh(jax.devices()[:1]))


def _port_trainer(ws, jparams, kind="vm", cls=Trainer, **kw):
    field = make_tensorf_field(
        None, tt.TensoRFConfig(bound=2.0, **NARROW[kind]),
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    extra = {k: kw.pop(k) for k in ("upsample_steps", "resolution1")
             if k in kw}
    return cls("t", _opts(TrainOptions, ws, **kw), field, workspace=ws,
               use_checkpoint="scratch", device="cpu", **extra)


def _occ(cas, h=32, seed=1):
    c = (np.arange(h) + 0.5) / h * 2 - 1
    r = np.sqrt(sum(np.meshgrid(c * c, c * c, c * c, indexing="ij")))
    rng = np.random.default_rng(seed)
    return (r < 0.7)[None] | (rng.uniform(size=(cas, h, h, h)) < 0.1)


def _step_inputs():
    _, train, _ = jax_scene(n_train=2, n_val=1, res=32)
    rng = np.random.default_rng(3)
    inds = rng.integers(0, 32 * 32, 256)
    rays = get_rays(_t(train.poses[:1]), _t(train.intrinsics), 32, 32,
                    inds=_t(inds)[None])
    ro, rd = rays["rays_o"][0], rays["rays_d"][0]
    pix = train.images[0].reshape(-1, 4)[inds]
    bg = rng.uniform(size=(256, 3)).astype(np.float32)
    gt = pix[:, :3] * pix[:, 3:] + bg * (1 - pix[:, 3:])
    return ro, rd, gt, bg


@pytest.mark.parametrize("kind,fracs", [("vm", ()), ("vm", FRACS),
                                        ("cp", FRACS)])
def test_one_train_step_matches_jax(tmp_path, kind, fracs, monkeypatch):
    jtr = _jax_trainer(str(tmp_path / "j"), kind, lr_net=1e-3)
    ttr = _port_trainer(str(tmp_path / "t"), jtr.params, kind, lr_net=1e-3,
                        k_rank_fracs=fracs)
    occ = _occ(2)
    ttr.grid_state["occ"] = _t(occ)
    ro, rd, gt, bg = _step_inputs()
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.uniform(key, (256,)))
    jf = jtr.field

    def jloss(p):
        # the reference's sample_and_loss: every level with the step's key
        def render(fwd):
            return jr.render_occ(p, jnp.asarray(occ), jnp.asarray(ro.numpy()),
                                 jnp.asarray(rd.numpy()), jtr.settings, fwd,
                                 None, bg_color=jnp.asarray(bg), rng=key,
                                 perturb=True)["image"]
        loss = jnp.mean((render(jf.forward) - gt) ** 2)
        for frac in fracs:
            loss = loss + jnp.mean((render(functools.partial(
                jf.forward_trunc, frac=frac)) - gt) ** 2)
        return loss / (1 + len(fracs))

    seen = []
    render_occ = trainer_mod.render_occ

    def spy(*a, **kw):
        seen.append(kw["noise"])
        return render_occ(*a, **kw)
    monkeypatch.setattr(trainer_mod, "render_occ", spy)
    lj, gj = jax.value_and_grad(jloss)(jtr.params)
    lt, _ = ttr.loss_on(ro, rd, _t(gt), _t(bg), _t(noise))
    ttr.optimizer.zero_grad(set_to_none=True)
    lt.backward()
    assert len(seen) == 1 + len(fracs)
    assert all(s is seen[0] for s in seen)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-3)
    errs = {}
    for name, p, g in zip([k for k in sorted(ttr.params)
                           for _ in param_leaves(ttr.params[k])],
                          param_leaves(ttr.params),
                          jax.tree_util.tree_leaves(gj)):
        g = np.asarray(g)
        errs[name] = float(np.linalg.norm(p.grad.numpy() - g)
                           / np.linalg.norm(g))
    assert max(errs.values()) <= GRAD_TOL, errs


def test_two_adam_groups_match_optax(tmp_path):
    jtr = _jax_trainer(str(tmp_path / "j"), lr=2e-2, lr_net=1e-3)
    ttr = _port_trainer(str(tmp_path / "t"), jtr.params, lr=2e-2,
                        lr_net=1e-3)
    # the towers (basis_grid, color_mlp) are "net", the factors "enc"
    labels = ttr._leaf_labels()
    names = [k for k in sorted(ttr.params)
             for _ in param_leaves(ttr.params[k])]
    assert [n for n, lab in zip(names, labels) if lab == "net"] == \
        ["basis_grid"] + ["color_mlp"] * 3
    assert [len(g["params"]) for g in ttr.optimizer.param_groups] == [12, 4]
    jp, state = jtr.params, jtr.opt_state
    rng = np.random.default_rng(4)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(size=a.shape).astype(
                np.float32)), jp)
        upd, state = jtr.tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(param_leaves(ttr.params),
                        jax.tree_util.tree_leaves(grads)):
            p.grad = _t(g)
        ttr.apply_gradients()
    for a, b in zip(param_leaves(ttr.params), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)


def test_upsample_schedule_and_reset(tmp_path):
    """The reference's resolutions for its default steps, then a resize at
    its step with a fresh Adam, EMA and 0.1 ** (step / iters) schedule."""
    steps = [2000, 3000, 4000, 5500, 7000]
    for r0, r1 in ((128, 300), (16, 24)):
        want = [int(round(np.exp(np.log(r0) + (np.log(r1) - np.log(r0))
                                 * (i + 1) / 5))) for i in range(5)]
        assert main_tensoRF.upsample_resolutions(r0, r1, 5) == want
    assert main_tensoRF.upsample_resolutions(128, 300, 5) == \
        [152, 180, 213, 253, 300]
    jfield = jt.make_tensorf_field(jax.random.PRNGKey(0), jt.TensoRFConfig(
        bound=2.0, **NARROW["vm"]))
    jtr = jax_main_tensoRF.TensoRFTrainer(
        "t", _opts(JaxOptions, str(tmp_path / "j"), lr_net=1e-3), jfield,
        workspace=str(tmp_path / "j"), use_checkpoint="scratch",
        mesh=make_mesh(jax.devices()[:1]), upsample_steps=[40, 20, 40],
        resolution1=48)
    ttr = _port_trainer(str(tmp_path / "t"), jfield.params, lr_net=1e-3,
                        cls=main_tensoRF.TensoRFTrainer,
                        upsample_steps=[40, 20, 40], resolution1=48)
    assert ttr.upsample_model_steps == jtr.upsample_model_steps == [20, 40]
    assert ttr.upsample_resolutions == jtr.upsample_resolutions == [39, 48]
    _, train, _ = jax_scene(n_train=2, n_val=1, res=32)
    data = {"poses": _t(train.poses), "intrinsics": _t(train.intrinsics),
            "images": _t(train.images)}
    ttr.opt.num_rays = 64
    ttr.grid_state["occ"] = _t(_occ(2))
    ttr.global_step = 19
    ttr.train_step_gt(data, 32, 32)
    assert ttr.field.cfg.resolution == 32 and ttr._optimizer_count() == 1
    up, _ = tt.upsample_tensorf(map_params(lambda t: t.detach().clone(),
                                           ttr.params), ttr.field.cfg, 39)
    ttr.train_step_gt(data, 32, 32)                          # step 20
    assert ttr.field.cfg.resolution == 39
    assert ttr.upsample_model_steps == [40]
    assert tuple(ttr.params["app_planes"][0].shape) == (8, 39, 39)
    assert ttr.field.params is ttr.params
    # a fresh Adam (one update since), the schedule from 0, the EMA from
    # the resized params
    assert ttr._optimizer_count() == 1 and ttr.scheduler.last_epoch == 1
    assert abs(ttr.current_lr() - 2e-2 * 0.1 ** (1 / 192)) < 1e-12
    for e, u, p in zip(param_leaves(ttr.ema_params), param_leaves(up),
                       param_leaves(ttr.params)):
        np.testing.assert_allclose(
            e.numpy(), 0.95 * u.detach().numpy() + 0.05 * p.detach().numpy(),
            rtol=1e-5, atol=1e-7)
    # the reference's fault, kept: a step past the pending one (a resumed
    # run) never upsamples again
    ttr.global_step = 41
    ttr.train_step_gt(data, 32, 32)
    assert ttr.field.cfg.resolution == 39 and ttr.upsample_model_steps == [40]


def test_upsample_steps_flag_appends():
    """Passing --upsample_model_steps adds steps to the default list, as
    the reference's action="append" over a list default does."""
    for argv in ([], ["--upsample_model_steps", "100"],
                 ["--upsample_model_steps", "100", "--upsample_model_steps",
                  "50"]):
        want = jax_main_tensoRF.build_parser().parse_args(
            ["synthetic"] + argv).upsample_model_steps
        got = main_tensoRF.build_parser().parse_args(
            ["synthetic"] + argv).upsample_model_steps
        assert got == want
    assert got == [2000, 3000, 4000, 5500, 7000, 100, 50]
    opt = main_tensoRF.build_parser().parse_args(["synthetic"])
    assert (opt.bound, opt.lr0, opt.lr1, opt.resolution0,
            opt.resolution1) == (2.0, 2e-2, 1e-3, 128, 300)


def test_main_tensorf_on_the_cpu(tmp_path, monkeypatch):
    """`main_tensoRF synthetic --device cpu` at resolution 16 -> 24 with
    upsamples at steps 16 and 32 of 48: frames written, the checkpoint at
    24^3; then --test serves it."""
    to_options = main_tensoRF.to_train_options
    monkeypatch.setattr(main_tensoRF, "to_train_options",
                        lambda opt, **kw: to_options(
                            opt, **kw, grid_size=32, segment_steps=16))
    ws = str(tmp_path)
    base = ["synthetic", "--device", "cpu", "--synthetic_res", "32",
            "--workspace", ws, "--resolution0", "16", "--resolution1", "24",
            "--num_rays", "64", "--max_steps", "256"]
    monkeypatch.setattr(main_tensoRF, "UPSAMPLE_STEPS", ())
    tr = main_tensoRF.main(base + ["--ckpt", "scratch", "--iters", "48",
                                   "--upsample_model_steps", "16",
                                   "--upsample_model_steps", "32"])
    assert tr.global_step == 48 and tr.field.cfg.resolution == 24
    assert np.isfinite(tr.history["loss"]).all()
    assert tuple(tr.params["sigma_planes"][0].shape) == (16, 24, 24)
    log = open(os.path.join(ws, "log_tensorf.txt")).read()
    assert "-> 20^3 at step 16" in log and "-> 24^3 at step 32" in log
    assert len([f for f in os.listdir(os.path.join(ws, "results"))
                if f.endswith(".png")]) == 6
    tr = main_tensoRF.main(base + ["--test"])
    log = open(os.path.join(ws, "log_tensorf.txt")).read()
    assert "(epoch 1, step 48)" in log
    assert tuple(tr.params["sigma_planes"][0].shape) == (16, 24, 24)
    assert tr.field.cfg.resolution == 16


def test_checkpoints_cross_both_ways(tmp_path):
    """A full JAX checkpoint saved after an upsample (32 -> 40) loads into
    the port's TensoRFTrainer built at resolution0, Adam's state included;
    the port's checkpoint loads back into the reference's trainer."""
    jtr = _jax_trainer(str(tmp_path / "j"), lr_net=1e-3)
    jp, _ = jt.upsample_tensorf(jtr.params, jtr.field.cfg, 40)
    jtr.params = jtr.ema_params = jtr.field.params = jp
    jtr.opt_state = jtr.tx.init(jp)
    jtr.global_step = 7
    jtr.save_checkpoint(full=True)
    path = sorted((tmp_path / "j" / "checkpoints").iterdir())[-1]
    field = make_tensorf_field(torch.Generator().manual_seed(0),
                               tt.TensoRFConfig(bound=2.0, **NARROW["vm"]))
    ttr = main_tensoRF.TensoRFTrainer(
        "t", _opts(TrainOptions, str(tmp_path / "t"), lr_net=1e-3), field,
        workspace=str(tmp_path / "t"), use_checkpoint=str(path),
        device="cpu", upsample_steps=[100], resolution1=48)
    assert ttr.global_step == 7 and ttr.upsample_resolutions == [48]
    for a, b in zip(param_leaves(ttr.params), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    assert tuple(ttr.params["app_planes"][2].shape) == (8, 40, 40)
    out = ttr.save_checkpoint(path=str(tmp_path / "port.npz"), full=True)
    jtr2 = _jax_trainer(str(tmp_path / "j2"), lr_net=1e-3)
    jtr2.load_checkpoint(out)
    for a, b in zip(param_leaves(ttr.params),
                    jax.tree_util.tree_leaves(jtr2.params)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
