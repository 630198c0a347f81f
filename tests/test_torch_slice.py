"""The ported static CP render path as a whole, against the JAX package.

A JAX FastTrainer trains the synthetic scene at narrow sizes for two
32-step segments and saves a checkpoint. The port loads it through its CLI
(`cli.build_trainer`, `load_checkpoint`), and both packages render the val
view with their `render_image_tiled` on the same occupancy. The frames must
agree to max |diff| <= 2e-2, and their PSNR against ground truth to 0.1 dB.
Checkpoints round-trip bit-exactly in both directions. The port's package
must import without JAX."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.data.synthetic import make_synthetic_scene
from sealdnerf_tpu.models.cp import CPConfig, make_cp_field
from sealdnerf_tpu.ops.marching_dense import downsample_occ
from sealdnerf_tpu.ops.pallas_field import make_fused_forward_planar
from sealdnerf_tpu.render.fast_image import render_image_tiled
from sealdnerf_tpu.train import checkpoint as jax_ckpt
from sealdnerf_tpu.train.fast import FastTrainer
from sealdnerf_tpu.train.trainer import TrainOptions
from sealdnerf_tpu_torch.cli import base_parser, build_trainer, postprocess
from sealdnerf_tpu_torch.models.cp import params_to_numpy
from sealdnerf_tpu_torch.train.metrics import psnr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the narrow sizes of the JAX package's FastTrainer fixture, plus one small
# VM plane scale so that the plane path of the field is exercised too
NARROW = dict(grid_size=32, march_res=16, n_intervals=6, steps_per_interval=3)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("jax_ws"))
    _, train, val = make_synthetic_scene(n_train=6, n_val=1, res=32)
    opt = TrainOptions(iters=200, num_rays=256, bound=1.0, dt_gamma=0.0,
                       segment_steps=32, update_extra_interval=8,
                       workspace=ws, **NARROW)
    cfg = CPConfig(bound=1.0, scales=((16, 8), (64, 16)), planes=((16, 4),))
    field = make_cp_field(jax.random.PRNGKey(0), cfg)
    tr = FastTrainer("t", opt, field, workspace=ws, use_checkpoint="scratch")
    tr.mark_untrained_grid(train.poses, train.intrinsics)
    data = train.device()
    h, w, c, n = train.h, train.w, train.images.shape[-1], len(train)
    for _ in range(2):
        tr.train_segment(data, h, w, c, n, 32)
    tr.save_checkpoint(full=True)
    ckpt = os.path.join(ws, "checkpoints", "t_ep0000.npz")
    assert os.path.exists(ckpt)
    return tr, val, ckpt


def _port_trainer(ckpt, ws):
    opt = postprocess(base_parser().parse_args(
        ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--test",
         "--device", "cpu", "--ckpt", ckpt, "--workspace", ws]))
    trainer, _ = build_trainer(opt, name="t", **NARROW)
    return trainer


def _gt(val):
    g = val.images[0]
    return g[..., :3] * g[..., 3:] + (1.0 - g[..., 3:])


def test_render_matches_jax(trained, tmp_path):
    tr, val, ckpt = trained
    pt = _port_trainer(ckpt, str(tmp_path))
    np.testing.assert_array_equal(pt.grid_state["occ"].numpy(),
                                  np.asarray(tr.grid_state["occ"]))
    assert pt.field.cfg.scales == tr.field.cfg.scales
    assert pt.field.cfg.planes == tr.field.cfg.planes

    occ_m = downsample_occ(tr.grid_state["occ"][0], tr.render_cfg.march_res)
    img_j, dep_j = render_image_tiled(
        tr._infer_params(), occ_m, jnp.asarray(val.poses[0]),
        jnp.asarray(val.intrinsics), val.h, val.w, tr.render_cfg,
        make_fused_forward_planar(tr.field.cfg, interpret=True),
        jnp.ones(3),
        tile_px=pt._pick_tile(val.h, val.w, val.poses[0], val.intrinsics),
        dilate=tr.opt.render_dilate, density_scale=tr.opt.density_scale,
        t_thresh=tr.opt.t_thresh, planar=True)
    img_j, dep_j = np.asarray(img_j), np.asarray(dep_j)
    img_t, dep_t = pt.render_image(val.poses[0], val.intrinsics, val.h,
                                   val.w)
    assert img_t.shape == (val.h, val.w, 3) and np.isfinite(img_t).all()
    assert np.abs(img_t - img_j).max() <= 2e-2
    gt = _gt(val)
    assert abs(psnr(img_t, gt) - psnr(img_j, gt)) <= 0.1
    assert psnr(img_t, gt) > 12.0               # a trained, non-blank frame
    np.testing.assert_allclose(dep_t, dep_j, atol=2e-2)


def test_checkpoint_round_trip(trained, tmp_path):
    tr, _, ckpt = trained
    pt = _port_trainer(ckpt, str(tmp_path))
    # JAX -> port: bit-exact params, EMA params and grid
    for mine, ref in ((pt.params, tr.params), (pt.ema_params,
                                               tr.ema_params)):
        for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(mine)),
                        jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(pt.grid_state["density_grid"].numpy(),
                                  np.asarray(tr.grid_state["density_grid"]))
    # port -> JAX: the port's checkpoint loads into the JAX package
    out = pt.save_checkpoint(str(tmp_path / "port.npz"))
    state, meta = jax_ckpt.load_checkpoint(out)
    assert meta["global_step"] == tr.global_step == 64
    for key, ref in (("params", tr.params), ("ema", tr.ema_params)):
        got = jax.tree_util.tree_leaves(state["model"][key])
        want = jax.tree_util.tree_leaves(ref)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(state["grid"]["occ"],
                                  np.asarray(tr.grid_state["occ"]))


def test_slim_checkpoint_rebuilds_grid(trained, tmp_path):
    """A checkpoint without a density grid (the reference's best/slim
    checkpoints) gets its grid rebuilt by a full sweep through the field
    kernel's density-only path."""
    tr, _, _ = trained
    slim = str(tmp_path / "slim.npz")
    jax_ckpt.save_checkpoint(slim, {
        "model": {"params": tr.params, "ema": tr.ema_params},
        "grid": {k: v for k, v in tr.grid_state.items()
                 if k not in ("density_grid", "occ")}},
        {"epoch": 1, "global_step": 64})
    pt = _port_trainer(slim, str(tmp_path / "ws"))
    g = pt.grid_state
    occ = g["occ"].numpy()
    assert 0 < occ.sum() < occ.size
    thresh = min(float(g["mean_density"]), pt.grid_cfg.density_thresh)
    np.testing.assert_array_equal(
        occ.reshape(-1), g["density_grid"].numpy().reshape(-1) > thresh)
    # the JAX package rebuilds the same slim checkpoint its own way (other
    # jitter draws); the two grids agree on almost every cell. (Loaded after
    # construction: the reference's FastTrainer cannot rebuild a grid from
    # inside its constructor.)
    jtr = FastTrainer("s", tr.opt, make_cp_field(jax.random.PRNGKey(1),
                                                 tr.field.cfg),
                      workspace=str(tmp_path / "jws"),
                      use_checkpoint="scratch")
    jtr.load_checkpoint(slim)
    assert (occ == np.asarray(jtr.grid_state["occ"])).mean() > 0.95


def test_cli_refuses_what_is_not_ported(tmp_path):
    # the GUI is ported: --gui parses, and main_nerf opens the viewer
    # (tests/test_torch_gui_slice.py drives main_nerf --gui)
    assert postprocess(base_parser().parse_args(
        ["synthetic", "--gui", "--device", "cpu"])).gui
    base = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0",
            "--device", "cpu", "--workspace", str(tmp_path)]
    # --clip_text is ported: as in the reference, the trainer builds, and
    # with --rand_pose 0 and no CLIP weights on the disk it logs that the
    # semantic steps are off
    opt = postprocess(base_parser().parse_args(base + ["--clip_text",
                                                       "a red car"]))
    tr, _ = build_trainer(opt)
    assert tr.opt.clip_text == "a red car" and tr.semantic_loss_fn is None
    opt = postprocess(base_parser().parse_args(
        base + ["--clip_text", "a red car", "--rand_pose", "0"]))
    tr, _ = build_trainer(opt)
    assert tr.opt.rand_pose == 0 and tr.semantic_loss_fn is None
    with open(tr.log_path) as f:
        assert "CLIP weights are unavailable offline" in f.read()
    # the main CLIs' sampling options are ported: they build, and reach the
    # trainer's options
    for flag, want in ((["--error_map"], ("error_map", True)),
                       (["--patch_size", "2"], ("patch_size", 2)),
                       (["--no_preload"], ("preload", False))):
        opt = postprocess(base_parser().parse_args(base + flag))
        tr, _ = build_trainer(opt)
        assert getattr(tr.opt, want[0]) == want[1], flag
    # the Instant-NGP backbone is ported (--backbone ngp builds the port's
    # FastTrainer, and Trainer with the background sphere); the CP backbone
    # with a background sphere still exits
    opt = postprocess(base_parser().parse_args(
        ["synthetic", "--test", "--device", "cpu", "--backbone", "ngp",
         "--workspace", str(tmp_path), "--ckpt", "scratch"]))
    assert type(build_trainer(opt, grid_size=32, march_res=16)[0]) \
        .__name__ == "FastTrainer"
    opt = postprocess(base_parser().parse_args(
        ["synthetic", "--test", "--device", "cpu", "--backbone", "ngp",
         "--bg_radius", "1", "--workspace", str(tmp_path), "--ckpt",
         "scratch"]))
    assert type(build_trainer(opt, grid_size=32)[0]).__name__ == "Trainer"
    opt = postprocess(base_parser().parse_args(
        ["synthetic", "--test", "--device", "cpu", "--backbone", "cp",
         "--bg_radius", "1", "--workspace", str(tmp_path)]))
    with pytest.raises(SystemExit, match="needs no --bg_radius"):
        build_trainer(opt)
    if not torch.cuda.is_available():
        opt = postprocess(base_parser().parse_args(
            ["synthetic", "--test", "--bound", "1", "--dt_gamma", "0",
             "--workspace", str(tmp_path)]))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_trainer(opt)


def test_port_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sealdnerf_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k.startswith('sealdnerf_tpu.') or k == 'sealdnerf_tpu']\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 20, mods\n"
        "print(len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
