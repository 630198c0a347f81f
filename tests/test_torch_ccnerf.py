"""main_CCNeRF in the port: rank-residual training and --compose, against
the JAX package.

A narrow CP field (rank 8 at resolution 128, main_CCNeRF's), a 32^3
occupancy grid, the synthetic scene at 32 px.
- Training: main_CCNeRF synthetic --device cpu, 96 steps with the K-loss at
  0.25 and 0.5: finite losses that fall, the 0.25 truncation renders a
  field that differs from full rank, the test frames written.
- --compose of the trained workspace twice (main_CCNeRF's default
  arrangement: scale 0.6, a circle of radius 0.5): the frames written under
  compose/. Against the reference's composition of the same params
  (cc_compose_forward with main_CCNeRF._transform, a full sweep of
  update_density_grid with PRNGKey(0)): the two sweeps jitter inside cells
  with other draws, so the occupancy is held by share (the occupied shares
  within 0.03); the viewer's sweep without jitter against the reference's
  composed density at the same points (rtol 1e-5); and the frames are
  compared on the reference's grid, copied into the port's viewer: max
  |diff| <= 2e-2 (the serving slices' frame limit,
  tests/test_torch_ngp_train.py).
- The reference's own --compose renders its viewer's EMA, the seeded params
  of the first field, and raises KeyError 0 (pinned here); the port's
  viewer renders the loaded params.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import main_CCNeRF as jax_main_cc
from sealdnerf_tpu.models import tensorf as jt
from sealdnerf_tpu.models.api import Field as JaxField
from sealdnerf_tpu.parallel.mesh import make_mesh
from sealdnerf_tpu.render.grid import update_density_grid
from sealdnerf_tpu.train.checkpoint import load_checkpoint as jax_load
from sealdnerf_tpu.train.checkpoint import resolve_checkpoint
from sealdnerf_tpu.train.trainer import Trainer as JaxTrainer
from sealdnerf_tpu.train.trainer import TrainOptions as JaxOptions
from sealdnerf_tpu_torch import main_CCNeRF
from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
from sealdnerf_tpu_torch.models import tensorf as tt
from sealdnerf_tpu_torch.render import grid as tgrid

FRAME_TOL = 2e-2
RANK = 8


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """main_CCNeRF synthetic --device cpu, 96 steps of 256 rays."""
    ws = str(tmp_path_factory.mktemp("cc"))
    mp = pytest.MonkeyPatch()
    to_options = main_CCNeRF.to_train_options
    mp.setattr(main_CCNeRF, "to_train_options", lambda opt, **kw: to_options(
        opt, **kw, grid_size=32, segment_steps=16))
    base = ["synthetic", "--device", "cpu", "--synthetic_res", "32",
            "--rank", str(RANK), "--max_steps", "256"]
    tr = main_CCNeRF.main(base + ["--workspace", ws, "--ckpt", "scratch",
                                  "--iters", "96", "--num_rays", "256"])
    out = str(tmp_path_factory.mktemp("compose"))
    viewer = main_CCNeRF.main(base + ["--workspace", out, "--compose",
                                      "--compose_models", ws, ws])
    mp.undo()
    return tr, ws, viewer, out


def test_ccnerf_training(trained):
    tr, ws, _, _ = trained
    assert tr.opt.k_rank_fracs == (0.25, 0.5) and tr.global_step == 96
    assert (tr.opt.lr, tr.opt.lr_net) == (2e-2, 1e-3)
    assert tr.field.cfg == tt.TensoRFConfig(
        bound=1.0, decomposition="cp", resolution=128, sigma_rank=(RANK,),
        color_rank=(RANK,))
    loss = np.asarray(tr.history["loss"])
    assert np.isfinite(loss).all() and loss[-32:].mean() < loss[:32].mean()
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -0.5, 0.5, (256, 3)).astype(np.float32))
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(256, 3)
    with torch.no_grad():
        lo = tr.field.forward_trunc(tr.params, x, d, 0.25)
        hi = tr.field.forward(tr.params, x, d)
    assert torch.isfinite(lo[0]).all() and not torch.allclose(lo[0], hi[0])
    assert len([f for f in os.listdir(os.path.join(ws, "results"))
                if f.endswith(".png")]) == 6


def test_compose_matches_jax(trained, tmp_path):
    _, ws, viewer, out = trained
    frames = sorted(f for f in os.listdir(os.path.join(out, "compose"))
                    if f.endswith(".png"))
    assert len(frames) == 6
    # the reference's composition of the same params
    state, _ = jax_load(resolve_checkpoint(ws, "ccnerf", "latest"))
    jp = jax.tree_util.tree_map(jnp.asarray, state["model"]["params"])
    cfg = jt.TensoRFConfig(bound=1.0, decomposition="cp", resolution=128,
                           sigma_rank=(RANK,), color_rank=(RANK,))
    fields = [jt.make_tensorf_field(jax.random.PRNGKey(i), cfg)
              for i in range(2)]
    pos = [[0.5 * np.cos(a), 0, 0.5 * np.sin(a)] for a in (0.0, np.pi)]
    transforms = [jax_main_cc._transform(0.6, p) for p in pos]
    for p, t in zip(pos, transforms):
        np.testing.assert_array_equal(
            main_CCNeRF.world_to_model(0.6, p).numpy(), np.asarray(t))
    composed = jt.cc_compose_forward(fields, transforms)
    jw = str(tmp_path / "j")
    jv = JaxTrainer("ccnerf", JaxOptions(bound=1.0, grid_size=32,
                                         max_steps=256, workspace=jw),
                    fields[0],
                    workspace=jw, use_checkpoint="scratch",
                    mesh=make_mesh(jax.devices()[:1]))
    jv.field = JaxField([jp, jp], composed, None, None, None, cfg)

    def density(params_list, x):
        return composed(params_list, x, jnp.tile(jnp.array([[0., 0., 1.]]),
                                                 (x.shape[0], 1)))
    jv.grid_state = update_density_grid(jv.grid_state, [jp, jp], density,
                                        jax.random.PRNGKey(0), jv.grid_cfg,
                                        full=True)
    occ_j = np.asarray(jv.grid_state["occ"])
    occ_t = viewer.grid_state["occ"].numpy()
    assert occ_j.mean() > 0.01
    assert abs(occ_t.mean() - occ_j.mean()) <= 0.03, (occ_t.mean(),
                                                     occ_j.mean())
    # the viewer's sweep queries the composition: its grid at the points
    # it swept (no jitter) holds the reference's density there
    seen = []

    def query(pts):
        seen.append(pts)
        return viewer._density_fn(viewer.params)(pts)
    with torch.no_grad():
        g = tgrid.update_density_grid(
            tgrid.init_grid_state(viewer.grid_cfg), query, viewer.grid_cfg,
            full=True, noise_u=torch.full((1, 32 ** 3, 3), 0.5))
    want = np.asarray(density([jp, jp], jnp.asarray(seen[0].numpy()))[0])
    np.testing.assert_allclose(g["density_grid"][0].numpy(), want,
                               rtol=1e-5, atol=1e-6)
    # the frames on the reference's grid
    viewer.grid_state = {k: torch.from_numpy(np.array(v))
                         for k, v in jv.grid_state.items()}
    _, _, val = make_synthetic_scene(n_train=48, n_val=6, res=32)
    img_t, _ = viewer.render_image(val.poses[0], val.intrinsics, 32, 32)
    img_j, _ = jv.render_image(val.poses[0], val.intrinsics, 32, 32,
                               params=[jp, jp])
    assert np.abs(img_t - img_j).max() <= FRAME_TOL
    assert img_t.std() > 1e-3
    # the reference's viewer renders its seeded EMA: a dict, not a list
    with pytest.raises(KeyError):
        jv.render_image(val.poses[0], val.intrinsics, 32, 32)
