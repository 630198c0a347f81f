"""The ported dynamic (time-conditioned) serving path as a whole, against the
JAX package.

A JAX FastTrainer(time_conditioned=True) trains the dynamic synthetic scene
at narrow sizes for two 16-step segments and saves a checkpoint. The port
loads it through its CLI (`cli.build_trainer(dynamic=True)`), and both
packages render the val views, each at its own time, with their
`render_image_tiled` on the occupancy slice of that time. The frames must
agree to max |diff| <= 2e-2 and their PSNR against ground truth to 0.1 dB
(the limits of the static slice). Checkpoints go both ways. Two faults of
the reference are pinned here: one `rebuild_grid` refreshes 8 of the 64 time
bins, and a slim checkpoint does not load into a dynamic trainer; the port
rebuilds every bin."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.data.synthetic import make_synthetic_scene
from sealdnerf_tpu.models.cp import CPDNeRFConfig, make_cp_dnerf_field
from sealdnerf_tpu.ops.marching_dense import downsample_occ
from sealdnerf_tpu.ops.pallas_field import make_fused_dyn_forward_planar
from sealdnerf_tpu.render.dynamic_grid import time_slice_index
from sealdnerf_tpu.render.fast_image import render_image_tiled
from sealdnerf_tpu.train import checkpoint as jax_ckpt
from sealdnerf_tpu.train.fast import FastTrainer
from sealdnerf_tpu.train.trainer import TrainOptions
from sealdnerf_tpu_torch import cli, main_dnerf
from sealdnerf_tpu_torch.data.synthetic import \
    make_synthetic_scene as torch_scene
from sealdnerf_tpu_torch.models.cp import CPConfig as TorchCPConfig
from sealdnerf_tpu_torch.models.cp import CPDNeRFConfig as TorchDynConfig
from sealdnerf_tpu_torch.models.cp import make_cp_field, params_to_numpy
from sealdnerf_tpu_torch.train.fast import FastTrainer as TorchFastTrainer
from sealdnerf_tpu_torch.train.metrics import psnr
from sealdnerf_tpu_torch.train.trainer import TrainOptions as TorchOptions

NARROW = dict(grid_size=16, march_res=8, n_intervals=6, steps_per_interval=3)
# narrow field; the encodings keep their default degrees, which a checkpoint
# cannot carry
FIELD = dict(bound=1.0, scales=((16, 8), (64, 16)), planes=((16, 4),),
             num_layers_deform=3, hidden_dim_deform=32)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; a torch pool of
    every core in each makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_trainer(name, ws, seed):
    opt = TrainOptions(iters=200, num_rays=256, bound=1.0, dt_gamma=0.0,
                       segment_steps=16, update_extra_interval=8,
                       workspace=ws, **NARROW)
    field = make_cp_dnerf_field(jax.random.PRNGKey(seed),
                                CPDNeRFConfig(**FIELD))
    return FastTrainer(name, opt, field, workspace=ws,
                       use_checkpoint="scratch", time_conditioned=True)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("jax_dyn_ws"))
    _, train, val = make_synthetic_scene(n_train=6, n_val=3, res=32,
                                         dynamic=True)
    tr = _jax_trainer("t", ws, 0)
    tr.mark_untrained_grid(train.poses, train.intrinsics)
    data = train.device()
    h, w, c, n = train.h, train.w, train.images.shape[-1], len(train)
    for _ in range(2):
        tr.train_segment(data, h, w, c, n, 16)
    tr.save_checkpoint(full=True)
    ckpt = os.path.join(ws, "checkpoints", "t_ep0000.npz")
    assert os.path.exists(ckpt)
    slim = os.path.join(ws, "slim.npz")
    jax_ckpt.save_checkpoint(slim, {
        "model": {"params": tr.params, "ema": tr.ema_params},
        "grid": {k: v for k, v in tr.grid_state.items()
                 if k not in ("density_grid", "occ")}},
        {"epoch": 1, "global_step": 32})
    return tr, train, val, ckpt, slim


def _opt(ws, *extra):
    return main_dnerf.parse_args(
        ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--device",
         "cpu", "--workspace", ws, *extra])


def _port_trainer(ckpt, ws):
    trainer, _ = cli.build_trainer(_opt(ws, "--test", "--ckpt", ckpt),
                                   name="t", dynamic=True, **NARROW)
    return trainer


def _gt(val, i):
    g = val.images[i]
    return g[..., :3] * g[..., 3:] + (1.0 - g[..., 3:])


@pytest.fixture(scope="module")
def port(trained, tmp_path_factory):
    return _port_trainer(trained[3], str(tmp_path_factory.mktemp("port_ws")))


@pytest.mark.parametrize("view", [0, 1, 2])
def test_render_matches_jax(trained, port, view):
    tr, _, val, _, _ = trained
    t = float(val.times[view])
    assert port.time_conditioned and port.field.cfg == TorchDynConfig(**FIELD)
    np.testing.assert_array_equal(port.grid_state["occ"].numpy(),
                                  np.asarray(tr.grid_state["occ"]))
    t_idx = int(time_slice_index(jnp.float32(t), tr.dyn_grid_cfg))
    occ_m = downsample_occ(tr.grid_state["occ"][t_idx, 0],
                           tr.render_cfg.march_res)
    img_j, dep_j = render_image_tiled(
        tr._infer_params(), occ_m, jnp.asarray(val.poses[view]),
        jnp.asarray(val.intrinsics), val.h, val.w, tr.render_cfg,
        make_fused_dyn_forward_planar(tr.field.cfg, interpret=True),
        jnp.ones(3), tile_px=port._pick_tile(val.h, val.w, val.poses[view],
                                             val.intrinsics),
        dilate=tr.opt.render_dilate, density_scale=tr.opt.density_scale,
        t_thresh=tr.opt.t_thresh, planar=True, extra=(jnp.float32(t),))
    img_j, dep_j = np.asarray(img_j), np.asarray(dep_j)
    img_t, dep_t = port.render_image(val.poses[view], val.intrinsics, val.h,
                                     val.w, time=t)
    assert img_t.shape == (val.h, val.w, 3) and np.isfinite(img_t).all()
    assert np.abs(img_t - img_j).max() <= 2e-2
    gt = _gt(val, view)
    assert abs(psnr(img_t, gt) - psnr(img_j, gt)) <= 0.1
    np.testing.assert_allclose(dep_t, dep_j, atol=2e-2)
    assert img_t.min() < 0.9                    # not a blank background


def test_time_reaches_the_field(trained, port):
    _, _, val, _, _ = trained
    a, _ = port.render_image(val.poses[0], val.intrinsics, val.h, val.w,
                             time=0.1)
    b, _ = port.render_image(val.poses[0], val.intrinsics, val.h, val.w,
                             time=0.9)
    c, _ = port.render_image(val.poses[0], val.intrinsics, val.h, val.w)
    z, _ = port.render_image(val.poses[0], val.intrinsics, val.h, val.w,
                             time=0.0)
    assert np.abs(a - b).max() > 1e-2
    np.testing.assert_array_equal(c, z)         # no time: the canonical frame


def test_evaluate_uses_each_views_time(trained, port):
    _, _, val, _, _ = trained
    seen = []
    orig = port.render_image

    def spy(*a, time=None, **kw):
        seen.append(time)
        return orig(*a, time=time, **kw)

    port.render_image = spy
    try:
        result = port.evaluate(val)
        port.test(val)
    finally:
        del port.render_image
    assert seen == list(val.times) * 2
    frames = [orig(val.poses[i], val.intrinsics, val.h, val.w,
                   time=val.times[i])[0] for i in range(len(val))]
    want = np.mean([psnr(f, _gt(val, i)) for i, f in enumerate(frames)])
    assert abs(result - want) < 1e-4
    assert len(os.listdir(os.path.join(port.workspace, "results"))) == 3


def test_checkpoint_round_trip(trained, port, tmp_path):
    tr, _, _, _, _ = trained
    # JAX -> port: bit-exact params (deform tower included), EMA and grid
    for mine, ref in ((port.params, tr.params), (port.ema_params,
                                                 tr.ema_params)):
        assert "deform_mlp" in mine
        for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(mine)),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(a, np.asarray(b))
    for k in ("density_grid", "bin_cursor", "iter_density"):
        np.testing.assert_array_equal(port.grid_state[k].numpy(),
                                      np.asarray(tr.grid_state[k]))
    assert port.grid_state["density_grid"].shape == (64, 1, 16 ** 3)
    assert port.global_step == tr.global_step == 32
    # port -> JAX: the port's checkpoint loads into a JAX dynamic trainer
    out = port.save_checkpoint(str(tmp_path / "port.npz"))
    jtr = _jax_trainer("b", str(tmp_path / "jws"), 1)
    jtr.load_checkpoint(out)
    for got, ref in ((jtr.params, tr.params), (jtr.ema_params,
                                               tr.ema_params)):
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(jtr.grid_state["occ"]),
                                  np.asarray(tr.grid_state["occ"]))
    assert jtr.global_step == 32
    # and back into the port
    again = _port_trainer(out, str(tmp_path / "ws2"))
    np.testing.assert_array_equal(again.grid_state["occ"].numpy(),
                                  port.grid_state["occ"].numpy())


def test_slim_checkpoint_rebuilds_every_time_bin(trained, tmp_path):
    """Faults of the reference, pinned: a slim checkpoint (no density grid)
    does not load into its dynamic trainer at all (the state is built with
    the static grid's shape), and one rebuild_grid refreshes only
    bins_per_call = 8 of the 64 time bins, so later times render as
    background. The port loads the slim checkpoint and rebuilds all 64."""
    tr, _, val, _, slim = trained
    jtr = _jax_trainer("s", str(tmp_path / "jws"), 1)
    with pytest.raises(ValueError, match="broadcast"):
        jtr.load_checkpoint(slim)
    jtr = _jax_trainer("r", str(tmp_path / "jws2"), 1)
    jtr.params, jtr.ema_params = tr.params, tr.ema_params
    jtr.rebuild_grid()
    per_bin = np.asarray(jtr.grid_state["occ"]).reshape(64, -1).any(axis=1)
    assert per_bin[:8].all() and not per_bin[8:].any()

    pt = _port_trainer(slim, str(tmp_path / "ws"))
    g = pt.grid_state
    occ = g["occ"].numpy().reshape(64, -1)
    assert occ.any(axis=1).all() and not occ.all()
    assert int(g["bin_cursor"]) == int(tr.grid_state["bin_cursor"])
    thresh = min(float(g["mean_density"]), pt.grid_cfg.density_thresh)
    np.testing.assert_array_equal(
        occ, g["density_grid"].numpy().reshape(64, -1) > thresh)
    # the rebuilt grid serves a frame close to the trained grid's
    full = _port_trainer(trained[3], str(tmp_path / "ws_full"))
    t = float(val.times[1])
    a, _ = pt.render_image(val.poses[1], val.intrinsics, val.h, val.w, time=t)
    b, _ = full.render_image(val.poses[1], val.intrinsics, val.h, val.w,
                             time=t)
    assert a.min() < 0.9 and psnr(a, b) > 25.0


def test_main_dnerf_serves_on_the_cpu(tmp_path, monkeypatch):
    """`main_dnerf synthetic -O --bound 1 --dt_gamma 0 --test --device cpu`
    end to end at 64 px: the full-width seeded field, a small grid and a
    short march."""
    monkeypatch.setattr(
        main_dnerf, "build_trainer",
        lambda opt, **kw: cli.build_trainer(opt, **kw, **NARROW))
    ws = str(tmp_path)
    main_dnerf.main(["synthetic", "-O", "--bound", "1", "--dt_gamma", "0",
                     "--test", "--device", "cpu", "--ckpt", "scratch",
                     "--synthetic_res", "64", "--workspace", ws])
    frames = sorted(os.listdir(os.path.join(ws, "results")))
    pngs = [f for f in frames if f.endswith(".png")]
    assert len(pngs) == 6 and all(f.endswith("_rgb.png") for f in pngs)
    assert len(os.listdir(os.path.join(ws, "validation"))) == 12
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    # the frames go to an mp4 too where an encoder imports
    assert "PSNR" in log and ("mp4 export unavailable" in log
                              or frames == pngs + ["ngp_ep0000_rgb.mp4"])


def test_what_is_not_ported_raises(trained, port, tmp_path):
    _, train, _ = torch_scene(n_train=6, n_val=1, res=32, dynamic=True)
    np.testing.assert_array_equal(train.times, trained[1].times)
    ws = str(tmp_path)
    data = train.device("cpu")
    assert data["times"].dtype == torch.float32
    np.testing.assert_array_equal(data["times"].numpy(), train.times)
    # dynamic training is ported (tests/test_torch_dyn_train.py), and so
    # are the main CLIs' sampling options, for a dynamic scene too; so is
    # --clip_text: as in the reference, the trainer builds, and with
    # --rand_pose 0 and no CLIP weights on the disk it logs that the
    # semantic steps are off
    tr, _ = cli.build_trainer(_opt(ws, "--ckpt", "scratch", "--clip_text",
                                   "a red car", "--rand_pose", "0"),
                              dynamic=True, **NARROW)
    assert tr.time_conditioned and tr.semantic_loss_fn is None
    with open(tr.log_path) as f:
        assert "CLIP weights are unavailable offline" in f.read()
    for flags, (key, want) in ((["--error_map"], ("error_map", True)),
                               (["--patch_size", "2"], ("patch_size", 2)),
                               (["--no_preload"], ("preload", False))):
        tr, _ = cli.build_trainer(_opt(ws, "--ckpt", "scratch", *flags),
                                  dynamic=True, **NARROW)
        assert getattr(tr.opt, key) == want and tr.time_conditioned
    # so is the GUI: --gui parses and opens the viewer
    # (tests/test_torch_gui_slice.py drives main_dnerf --gui)
    assert main_dnerf.parse_args(["synthetic", "--gui", "--test", "--device",
                                  "cpu", "--workspace", ws]).gui
    # the reference's D-NeRF fields are ported: these recipes route to
    # them on Trainer, as in the reference
    for flags, variant in ((["--basis"], "basis"), (["--hyper"], "hyper"),
                           (["--backbone", "ngp"], "deform"),
                           (["--bound", "2"], "deform"),
                           (["--bg_radius", "3"], "deform")):
        tr, field = cli.build_trainer(
            _opt(ws, "--test", "--ckpt", "scratch", *flags), dynamic=True,
            **NARROW)
        assert type(tr).__name__ == "Trainer" and tr.time_conditioned
        assert field.cfg.variant == variant
    with pytest.raises(SystemExit, match="--bound <= 1 for dynamic"):
        cli.build_trainer(_opt(ws, "--test", "--backbone", "cp", "--bound",
                               "2"), dynamic=True, **NARROW)
    # the lr defaults follow the backbone, as in the reference's main
    opt = _opt(ws, "--test")
    assert (opt.lr, opt.lr_net) == (1e-2, 1e-3)
    assert opt.update_extra_interval == 16 and opt.time_curriculum_steps == -1
    opt = _opt(ws, "--test", "--bound", "2")
    assert (opt.lr, opt.lr_net) == (5e-4, 5e-4)
    assert main_dnerf.build_parser().parse_args(["x"]).bound == 2.0
    # the trainer refuses a field of the other kind, and bound > 1
    topt = TorchOptions(workspace=ws, bound=1.0, dt_gamma=0.0, **NARROW)
    gen = torch.Generator().manual_seed(0)
    static = make_cp_field(gen, TorchCPConfig(scales=((8, 4),), planes=()))
    with pytest.raises(ValueError, match="time_conditioned goes with"):
        TorchFastTrainer("x", topt, static, use_checkpoint="scratch",
                         time_conditioned=True)
    with pytest.raises(ValueError, match="time_conditioned goes with"):
        TorchFastTrainer("x", topt, port.field, use_checkpoint="scratch")
    with pytest.raises(ValueError, match="bound <= 1"):
        TorchFastTrainer("x", TorchOptions(workspace=ws, bound=2.0,
                                           dt_gamma=0.0, **NARROW),
                         port.field, use_checkpoint="scratch",
                         time_conditioned=True)
    # a static trainer does not serve a dynamic checkpoint
    st = TorchFastTrainer("x", topt, static, use_checkpoint="scratch")
    with pytest.raises(ValueError, match="holds a time-conditioned field"):
        st.load_checkpoint(trained[3])
