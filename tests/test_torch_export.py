"""The port's export and GUI calls against the JAX package's: save_mesh,
test(write_video=...), train_gui and test_gui. Tolerances:
- save_mesh on narrow seeded fields carried over from JAX (the CP field
  through FastTrainer, its density through K1's plain version, which runs
  the towers on bf16 operands; the Instant-NGP field through Trainer): the
  density grid within 2e-2 x its largest value of the reference's
  extract_fields on the same points (the reference's density runs the CP
  towers in f32); at the grid's 95th percentile the vertex and face counts
  within 3 % of the reference's extract_geometry (run on the same mesher
  build; equal counts would be luck); the PLY read back by the reference's
  load_ply equals what was written; the mesher is built into the package's
  build directory, never into native/;
- test(write_video=True) writes the PNGs and, with an importable encoder
  (monkeypatched), the mp4 at 25 fps; without one it logs and keeps the
  PNGs;
- train_gui and test_gui on both trainers with --device cpu (FastTrainer
  on the CP and the Instant-NGP fields, Trainer on the Instant-NGP field
  with its background sphere): the steps taken, a finite loss, the lr of
  current_lr(), downscale snapped to 1, 2, 4 or 8, depth always from
  Trainer.test_gui.
"""

import os
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.models.api import make_ngp_field as jax_ngp_field
from sealdnerf_tpu.models.cp import CPConfig as JaxCPConfig
from sealdnerf_tpu.models.cp import make_cp_field as jax_cp_field
from sealdnerf_tpu.models.ngp import NGPConfig as JaxNGPConfig
from sealdnerf_tpu.utils import meshing as jmesh
from sealdnerf_tpu_torch import cli
from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
from sealdnerf_tpu_torch.models.api import make_ngp_field
from sealdnerf_tpu_torch.models.cp import CPConfig, make_cp_field
from sealdnerf_tpu_torch.models.ngp import NGPConfig
from sealdnerf_tpu_torch.models.params import params_from_jax
from sealdnerf_tpu_torch.train.fast import FastTrainer
from sealdnerf_tpu_torch.train.trainer import Trainer, TrainOptions
from sealdnerf_tpu_torch.utils import meshing

RES = 48
DENSITY_TOL = 2e-2
COUNT_TOL = 0.03
CP_NARROW = dict(bound=1.0, scales=((16, 8), (64, 16)), planes=((16, 4),))
NGP_NARROW = dict(bound=1.0, num_levels=4, log2_hashmap_size=12)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _trainers(kind, ws):
    """(port trainer, JAX field, JAX params): a narrow seeded field of the
    reference, its params carried to the port's trainer."""
    if kind == "cp":
        jf = jax_cp_field(jax.random.PRNGKey(0), JaxCPConfig(**CP_NARROW))
        field = make_cp_field(torch.Generator().manual_seed(0),
                              CPConfig(**CP_NARROW), "cpu")
        cls, grid = FastTrainer, dict(grid_size=32, march_res=16,
                                      dt_gamma=0.0)
    else:
        jf = jax_ngp_field(jax.random.PRNGKey(0), JaxNGPConfig(**NGP_NARROW))
        field = make_ngp_field(torch.Generator().manual_seed(0),
                               NGPConfig(**NGP_NARROW))
        cls, grid = Trainer, dict(grid_size=16, max_steps=256)
    params = jax.tree_util.tree_map(np.asarray, jf.params)
    field.params = params_from_jax(params)
    opt = TrainOptions(bound=1.0, workspace=ws, iters=64, num_rays=256,
                       segment_steps=16, eval_interval=1000, **grid)
    tr = cls("ngp", opt, field, workspace=ws, use_checkpoint="scratch",
             device="cpu")
    return tr, jf, params


@pytest.mark.parametrize("kind", ["cp", "ngp"])
def test_save_mesh_matches_reference(tmp_path, monkeypatch, kind):
    tr, jf, jparams = _trainers(kind, str(tmp_path))
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)

    def jquery(pts):
        return np.asarray(jf.density(jp, jnp.asarray(pts))[0])
    bmin, bmax = np.full(3, -1.0), np.full(3, 1.0)
    want = jmesh.extract_fields(bmin, bmax, RES, jquery)
    fn = tr._density_fn(tr._infer_params())
    got = meshing.extract_fields(bmin, bmax, RES, fn, "cpu")
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    print(f"{kind}: density max |port - JAX| / max {err:.2e} (max {scale:.3g})")
    assert err <= DENSITY_TOL
    thresh = float(np.percentile(want, 95))
    # the reference's extract_geometry on the same build of the mesher
    monkeypatch.setattr("sealdnerf_tpu.utils.native.load_native",
                        meshing.load_mesher)
    jv, jt = jmesh.extract_geometry(bmin, bmax, RES, thresh, jquery)
    path, verts, tris = tr.save_mesh(str(tmp_path / "m" / "mesh.ply"),
                                     resolution=RES, threshold=thresh)
    print(f"{kind}: port {len(verts)} verts {len(tris)} tris; JAX "
          f"{len(jv)} verts {len(jt)} tris")
    assert len(jt) > 100
    assert abs(len(verts) - len(jv)) <= COUNT_TOL * len(jv)
    assert abs(len(tris) - len(jt)) <= COUNT_TOL * len(jt)
    assert set(tr.mesh_seconds) == {"sweep", "tetrahedra"}
    rv, rt = jmesh.load_ply(path)
    np.testing.assert_array_equal(rv, verts)
    np.testing.assert_array_equal(rt, tris)
    # the vertices lie in the box; the extension sits in the build
    # directory, keyed by a hash
    assert np.abs(verts).max() <= 1.0 + 1e-6
    so = meshing.build_mesher()
    assert so.parent.parent == meshing.BUILD_DIR
    assert so.parent.name.startswith("mesher-")


def test_mesher_build_writes_nothing_beside_its_source(tmp_path,
                                                      monkeypatch):
    """A build (of a copy of native/mesher.cpp, in a directory of its own)
    writes into the build directory only, nothing beside the source."""
    src = tmp_path / "native" / "mesher.cpp"
    src.parent.mkdir()
    src.write_bytes(meshing.MESHER_SRC.read_bytes())
    monkeypatch.setattr(meshing, "MESHER_SRC", src)
    monkeypatch.setattr(meshing, "BUILD_DIR", tmp_path / "_build")
    so = meshing.build_mesher()
    assert so.exists() and so.parent.parent == tmp_path / "_build"
    assert os.listdir(src.parent) == ["mesher.cpp"]
    assert meshing.build_mesher() == so          # built once per hash


@pytest.mark.parametrize("encoder", [True, False],
                         ids=["with_encoder", "without_encoder"])
def test_test_writes_video_when_an_encoder_imports(tmp_path, monkeypatch,
                                                  encoder):
    tr, _, _ = _trainers("ngp", str(tmp_path))
    _, _, val = make_synthetic_scene(n_train=2, n_val=3, res=32)
    calls = []
    if encoder:
        fake = types.ModuleType("imageio")

        def mimwrite(path, frames, **kw):
            calls.append((frames.shape, frames.dtype, kw))
            with open(path, "wb") as f:
                f.write(b"mp4")
        fake.mimwrite = mimwrite
        monkeypatch.setitem(sys.modules, "imageio", fake)
    else:
        monkeypatch.setitem(sys.modules, "imageio", None)
    out = tr.test(val, save_path=str(tmp_path / "res"), name="v")
    files = sorted(os.listdir(tmp_path / "res"))
    pngs = [f for f in files if f.endswith(".png")]
    assert pngs == [f"v_{i:04d}_rgb.png" for i in range(3)]
    if encoder:
        assert out == str(tmp_path / "res" / "v_rgb.mp4")
        assert "v_rgb.mp4" in files
        (shape, dtype, kw), = calls
        assert shape == (3, 32, 32, 3) and dtype == np.uint8
        assert kw["fps"] == 25
    else:
        assert out is None and files == pngs
        log = open(os.path.join(tr.workspace, "log_ngp.txt")).read()
        assert "mp4 export unavailable" in log
    # write_video=False writes no video
    assert tr.test(val, save_path=str(tmp_path / "r2"),
                   write_video=False) is None
    assert all(f.endswith(".png") for f in os.listdir(tmp_path / "r2"))


@pytest.mark.parametrize("backbone", ["cp", "ngp", "ngp_bg"])
def test_train_gui_and_test_gui(tmp_path, backbone):
    """Both trainers as --device cpu builds them (narrow), on the GUI's
    calls: FastTrainer on the CP field and on the Instant-NGP field, Trainer
    on the Instant-NGP field with its background sphere."""
    argv = ["synthetic", "-O", "--device", "cpu", "--workspace",
            str(tmp_path), "--ckpt", "scratch", "--num_rays", "128",
            "--backbone", backbone[:3]]
    if backbone == "cp":
        argv += ["--bound", "1", "--dt_gamma", "0"]
    if backbone == "ngp_bg":
        argv += ["--bg_radius", "1"]
    opt = cli.postprocess(cli.base_parser().parse_args(argv))
    if backbone == "cp":
        # the CLI's options on a narrow field
        field = make_cp_field(torch.Generator().manual_seed(0),
                              CPConfig(**CP_NARROW), "cpu")
        tr = FastTrainer("ngp", cli.to_train_options(
            opt, grid_size=32, march_res=16), field,
            workspace=str(tmp_path), use_checkpoint="scratch", device="cpu")
    else:
        tr, _ = cli.build_trainer(opt, grid_size=16, march_res=8,
                                  max_steps=256)
    assert type(tr) is (Trainer if backbone == "ngp_bg" else FastTrainer)
    _, train, val = make_synthetic_scene(n_train=3, n_val=1, res=32)
    data = train.device("cpu")
    out = tr.train_gui(data, step=5, h=32, w=32)
    assert set(out) == {"loss", "lr", "time"}
    assert tr.global_step == 5 and np.isfinite(out["loss"])
    assert out["lr"] == tr.current_lr() == pytest.approx(
        opt.lr * 0.1 ** (5 / opt.iters))
    out = tr.train_gui(data, 32, 32, step=3)
    assert tr.global_step == 8 and np.isfinite(out["loss"])
    frame = tr.test_gui(val.poses[0], val.intrinsics, 32, 32, downscale=5)
    assert frame["image"].shape == (8, 8, 3)        # snapped to 4
    assert np.isfinite(frame["image"]).all()
    assert frame["depth"].shape == (8, 8)
    frame = tr.test_gui(val.poses[0], val.intrinsics, 32, 32, downscale=1,
                        need_depth=False)
    assert frame["image"].shape == (32, 32, 3)
    if backbone != "ngp_bg":
        assert frame["depth"] is None          # FastTrainer's LOD preview
    else:
        assert frame["depth"].shape == (32, 32)   # Trainer: always
