"""The port's data mesh (sealdnerf_tpu_torch/parallel/), its row-band frame
renderer and its sharded grid sweeps, at 2 and 4 ranks of a gloo mesh on
the CPU (tests/torch_parallel_ranks.py spawns them), against the JAX
package's `make_sharded_image_renderer` and FastTrainer sweep on meshes of
the conftest's virtual CPU devices, and against the port on one rank.

Tolerances:
- The collectives: exact, and the same bits on every rank.
- Row-band frames of narrow CP fields (static, and dynamic at t = 0.37)
  against the reference's sharded renderer on the same converted params
  (its XLA field): max |diff| 2e-2, the CPU frame tolerance of PERF.md
  section 2. Tiled against the port's own whole frame: image atol 1e-5,
  depth atol 1e-4, the tolerances of the reference's own test of its
  sharded renderer (tests/test_fast_path.py); a band's shifted principal
  point changes the float arithmetic of its ray directions, so the frames
  are not equal bit for bit. Bucketed against the whole bucketed frame at
  atol 1e-5, on an occupancy that no bucket truncates (there also against
  the reference, whose bands sort their own tiles) and on one that
  truncates tiles (the port's bands take the whole frame's buckets).
- The warm-up slabs at 2 ranks: each rank's cells equal the cells that
  the reference's FastTrainer sweeps on the matching device.
- The merged static and dynamic sweeps against the port's one-rank sweep
  over the union of the ranks' cells and jitter: within 1e-6 (a CPU GEMM
  may block a batch of another size differently); the merged grids, their
  occupancy and bin sums are the same bits on every rank.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from sealdnerf_tpu.models.cp import (CPConfig as JaxCPConfig,
                                     CPDNeRFConfig as JaxDynConfig,
                                     init_cp, init_cp_dnerf, make_cp_field,
                                     make_cp_dnerf_field)
from sealdnerf_tpu.ops.marching_dense import DenseMarchConfig as JaxMarchCfg
from sealdnerf_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sealdnerf_tpu.render.fast_image import \
    make_sharded_image_renderer as jax_sharded
from sealdnerf_tpu.train.fast import FastTrainer as JaxFastTrainer
from sealdnerf_tpu.train.trainer import TrainOptions as JaxOptions
from sealdnerf_tpu_torch.models.cp import params_from_jax
from sealdnerf_tpu_torch.ops.field import pack_tables
from sealdnerf_tpu_torch.ops.marching_dense import DenseMarchConfig
from sealdnerf_tpu_torch.parallel import (Mesh, all_gather_rows, make_mesh,
                                          pmax, pmean, psum, replicate,
                                          shard_batch, world_size)
from sealdnerf_tpu_torch.render import dynamic_grid as tdg
from sealdnerf_tpu_torch.render import grid as tgrid
from sealdnerf_tpu_torch.render.fast_image import (render_image_bucketed,
                                                   render_image_tiled)

import torch_parallel_ranks as ranks

FIELD_ATOL = 2e-2
IMG_ATOL, DEP_ATOL = 1e-5, 1e-4
SWEEP_ATOL = 1e-6
T = 0.37
RH = RW = 64
WORLDS = (2, 4)
GRID_H = 16


def _ball_occ(res, r):
    g = np.linspace(-1, 1, res)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return (x ** 2 + y ** 2 + z ** 2) < r ** 2


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def spec():
    """Narrow seeded fields of both kinds (JAX's init, numpy leaves), the
    camera, the occupancies, and the sweeps' grids and draws."""
    rng = np.random.default_rng(5)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3], pose[0, 3] = -2.2, 0.1
    h3 = GRID_H ** 3
    grid = rng.uniform(0.0, 30.0, (1, h3)).astype(np.float32)
    grid[0, rng.random(h3) < 0.2] = -1.0
    dyn_grid = rng.uniform(0.0, 30.0, (4, 1, h3)).astype(np.float32)
    dyn_grid[rng.random((4, 1, h3)) < 0.2] = -1.0
    half = h3 // 2
    return {
        "static": _np_tree(init_cp(jax.random.PRNGKey(1), JaxCPConfig(
            bound=1.0, scales=ranks.SCALES, planes=ranks.PLANES))),
        "dynamic": _np_tree(init_cp_dnerf(jax.random.PRNGKey(2), JaxDynConfig(
            bound=1.0, scales=ranks.SCALES, planes=ranks.PLANES,
            **ranks.DYN_KW))),
        "t": T, "rh": RH, "rw": RW, "pose": pose,
        "intr": np.array([64.0, 64.0, RW / 2, RH / 2], np.float32),
        "bg": np.array([0.1, 0.2, 0.3], np.float32),
        "occ": _ball_occ(32, 0.6), "occ_small": _ball_occ(32, 0.3),
        "h": GRID_H, "grid": grid, "dyn_grid": dyn_grid,
        # distinct cells, so that no two ranks query one cell
        "cells": rng.permutation(h3)[:half].astype(np.int64),
        "u": rng.random((half, 3)).astype(np.float32),
        "dyn_cells": np.stack([rng.permutation(h3)[:half]
                               for _ in range(2)]).astype(np.int64),
        "dyn_u": rng.random((2, half, 3)).astype(np.float32),
        "dyn_ut": rng.random(2).astype(np.float32),
    }


@pytest.fixture(scope="module")
def world_runs(spec, tmp_path_factory):
    """Every rank function at 2 ranks and the collectives and frames at
    4, one spawn per world."""
    tmp = tmp_path_factory.mktemp("mesh")
    return {2: ranks.run_ranks(ranks.world_checks, 2, tmp, spec, True),
            4: ranks.run_ranks(ranks.world_checks, 4, tmp, spec, False)}


# ----------------------------------------------------------- mesh, one rank
def test_one_rank_mesh_calls_no_collective(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh = make_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.group, mesh.backend) == \
        (0, 1, None, None)
    assert not torch.distributed.is_initialized()
    assert world_size() == 1
    x = torch.arange(4.0)
    for op in (psum, pmax, pmean, all_gather_rows):
        assert op(mesh, x) is x
    replicate(mesh, [x])
    assert torch.equal(shard_batch(mesh, x), x)
    single = make_mesh(layout=["cpu"], rank=0, init_method="unused")
    assert single.size == 1 and single.group is None


def test_backend_follows_the_layout():
    from sealdnerf_tpu_torch.parallel.mesh import backend_for
    assert backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert backend_for(["cuda:0", "cuda:0"]) == "gloo"   # a shared card
    assert backend_for(["cpu", "cpu"]) == "gloo"
    with pytest.raises(ValueError, match="rank and init_method"):
        make_mesh(layout=["cpu", "cpu"])


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_equal_on_every_rank(world_runs, world):
    got = [r["collectives"] for r in world_runs[world]]
    x = [np.arange(6, dtype=np.float32) * 0.1 + r for r in range(world)]
    np.testing.assert_allclose(got[0]["psum"], sum(x), rtol=1e-6)
    np.testing.assert_array_equal(
        got[0]["pmax"], np.max([-(v - 2.0) ** 2 for v in x], axis=0))
    np.testing.assert_allclose(got[0]["pmean"],
                               np.mean([v / 3.0 for v in x], axis=0),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        got[0]["gather"], np.repeat(np.arange(world) + 0.5, 2)[:, None]
        * np.ones((1, 3), np.float32))
    for r, g in enumerate(got):
        assert g["mesh"] == (r, world, "gloo", "data")
        assert g["from_rank0"] == 0.25
        np.testing.assert_array_equal(g["shard"],
                                      np.arange(4 * r, 4 * r + 4))
        assert g["shard_ragged"] == "refused"
        np.testing.assert_array_equal(g["replicate"]["f"], np.zeros((3, 4)))
        np.testing.assert_array_equal(g["replicate"]["b"], [True, False])
        assert int(g["replicate"]["i"]) == 0
        for k in ("psum", "pmax", "pmean", "gather"):
            assert g[k].tobytes() == got[0][k].tobytes(), (k, r)


# ----------------------------------------------------------- row-band frames
def _jax_forward(kind):
    if kind == "static":
        f = make_cp_field(jax.random.PRNGKey(0), JaxCPConfig(
            bound=1.0, scales=ranks.SCALES, planes=ranks.PLANES))
    else:
        f = make_cp_dnerf_field(jax.random.PRNGKey(0), JaxDynConfig(
            bound=1.0, scales=ranks.SCALES, planes=ranks.PLANES,
            **ranks.DYN_KW))
    return f.forward


def _whole(spec, kind, buckets, occ, field="cp"):
    """The port's whole frame on one rank."""
    cfg, fwd = ranks._forward(kind, field)
    tables = None if cfg is None else \
        pack_tables(params_from_jax(spec[kind]), cfg)
    render = render_image_bucketed if buckets else render_image_tiled
    kw = dict(splits=ranks.SPLITS) if buckets else {}
    img, dep = render(
        tables, torch.from_numpy(spec[occ]), torch.from_numpy(spec["pose"]),
        torch.from_numpy(spec["intr"]), RH, RW,
        DenseMarchConfig(**ranks.FRAME_CFG), fwd,
        torch.from_numpy(spec["bg"]), tile_px=8,
        extra=(T,) if kind == "dynamic" else (), **kw)
    return img.numpy(), dep.numpy()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["static", "dynamic"])
@pytest.mark.parametrize("case", sorted(ranks.FRAME_CASES))
def test_row_band_frame(world_runs, spec, world, kind, case):
    bands = [r["frames"][kind, case] for r in world_runs[world]]
    img, dep = bands[0]
    for other in bands[1:]:                      # every rank: the frame
        assert other[0].tobytes() == img.tobytes()
        assert other[1].tobytes() == dep.tobytes()
    assert img.shape == (RH, RW, 3) and np.isfinite(img).all()
    assert img.min() < 0.9 * img.max()           # not a blank background
    buckets, occ, field = ranks.FRAME_CASES[case]
    whole_img, whole_dep = _whole(spec, kind, buckets, occ, field)
    np.testing.assert_allclose(img, whole_img, atol=IMG_ATOL)
    if case == "tiled":
        np.testing.assert_allclose(dep, whole_dep, atol=DEP_ATOL)
    tiled = _whole(spec, kind, False, occ, field)[0]
    if case == "bucketed_truncating":
        # the buckets truncate tiles here: the reference's bands, each
        # sorting its own tiles, need not match its whole frame; the port's
        # take the whole frame's buckets
        assert np.abs(whole_img - tiled).max() > 1e-2
        return
    if buckets:
        # the occupancy truncates no bucket: the whole bucketed frame is the
        # whole tiled one
        np.testing.assert_allclose(whole_img, tiled, atol=IMG_ATOL)
    rfn = jax_sharded(
        jax_make_mesh(jax.devices()[:world]), RH, RW,
        JaxMarchCfg(**ranks.FRAME_CFG), _jax_forward(kind), tile_px=8,
        dilate=1, planar=False, buckets=buckets, splits=ranks.SPLITS,
        time_conditioned=kind == "dynamic")
    extra = (jnp.float32(T),) if kind == "dynamic" else ()
    img_j, dep_j = rfn(spec[kind], jnp.asarray(spec[occ]),
                       jnp.asarray(spec["pose"]), jnp.asarray(spec["intr"]),
                       jnp.asarray(spec["bg"]), *extra)
    assert np.abs(img - np.asarray(img_j)).max() <= FIELD_ATOL
    np.testing.assert_allclose(dep, np.asarray(dep_j), atol=FIELD_ATOL)


def test_row_bands_need_whole_tiles():
    from sealdnerf_tpu_torch.render.fast_image import \
        make_sharded_image_renderer
    mesh = Mesh(1, 4, torch.device("cpu"))
    with pytest.raises(ValueError, match="bands"):
        make_sharded_image_renderer(mesh, 48, 64, None, None, tile_px=8)


# ------------------------------------------------------------------ sweeps
@pytest.fixture(scope="module")
def jax_slab_owner(tmp_path_factory):
    """The device that the reference's FastTrainer has sweep each cell in
    its first two (warm-up) refresh calls on a 2-device mesh: a field whose
    density is its device's index + 1, two steps with a refresh at each."""
    field = make_cp_field(jax.random.PRNGKey(0), JaxCPConfig(
        bound=1.0, scales=ranks.SCALES, planes=ranks.PLANES))
    field.density = lambda params, x: (
        jnp.full(x.shape[:1], jax.lax.axis_index("data") + 1.0),)
    opt = JaxOptions(iters=2, num_rays=64, grid_size=GRID_H, march_res=8,
                     n_intervals=4, steps_per_interval=2,
                     update_extra_interval=1, density_thresh=10.0,
                     workspace=str(tmp_path_factory.mktemp("jax_slabs")))
    tr = JaxFastTrainer("t", opt, field, use_checkpoint="scratch",
                        mesh=jax_make_mesh(jax.devices()[:2]))
    _, train, _ = jax_scene(n_train=2, n_val=1, res=16)
    tr.train_segment(train.device(preload=True), 16, 16, 4, 2, 2)
    assert int(tr.grid_state["iter_density"]) == 2
    return np.asarray(tr.grid_state["density_grid"])[0] - 1.0


def test_warmup_slabs_match_the_reference(world_runs, jax_slab_owner):
    h3 = GRID_H ** 3
    owner = np.full(h3, -1.0)
    for r, run in enumerate(world_runs[2]):
        for it in (0, 1):
            owner[run["slabs"][it]] = r
    assert (owner >= 0).all()          # two calls sweep every cell once
    np.testing.assert_array_equal(owner, jax_slab_owner)


def _single_static(spec, case):
    gcfg = tgrid.GridConfig(grid_size=GRID_H, density_thresh=10.0)
    st = tgrid.init_grid_state(gcfg)
    st["density_grid"] = torch.from_numpy(spec["grid"].copy())
    it = 0 if case == "slab" else 40
    st["iter_density"] = torch.tensor(it, dtype=torch.int32)
    idx = tgrid.refresh_indices(0, gcfg) if case == "slab" else \
        torch.from_numpy(spec["cells"])
    return tgrid.update_density_grid(
        st, ranks._density("static", spec["static"]), gcfg, indices=idx,
        noise_u=torch.from_numpy(spec["u"])[None])


def _single_dynamic(spec, case):
    dcfg = tdg.DynGridConfig(grid_size=GRID_H, time_size=4, bins_per_call=2,
                             density_thresh=10.0)
    st = tdg.init_dyn_grid_state(dcfg)
    st["density_grid"] = torch.from_numpy(spec["dyn_grid"].copy())
    st["iter_density"] = torch.tensor(2 if case == "slab" else 40,
                                      dtype=torch.int32)
    st["bin_cursor"] = torch.tensor(1, dtype=torch.int32)
    draws = {"u_xyz": torch.from_numpy(spec["dyn_u"]),
             "u_t": torch.from_numpy(spec["dyn_ut"]),
             "indices": torch.from_numpy(spec["dyn_cells"])}
    got, sums = tdg.refresh_dyn_density_grid(
        st, ranks._density("dynamic", spec["dynamic"]), dcfg,
        warmup_calls=32, draws=draws)
    return {**got, "bin_sums": sums}


@pytest.mark.parametrize("kind", ["static", "dynamic"])
@pytest.mark.parametrize("case", ["slab", "cells"])
def test_merged_sweep_is_the_sweep_of_the_union(world_runs, spec, kind,
                                                 case):
    got = [r["sweeps"][kind, case] for r in world_runs[2]]
    for g in got[1:]:
        for k, v in got[0].items():
            if k != "indices":
                assert g[k].tobytes() == v.tobytes(), k
    if kind == "static" and case == "slab":
        np.testing.assert_array_equal(
            np.concatenate([g["indices"] for g in got]),
            np.arange(GRID_H ** 3 // 2))
    want = (_single_static if kind == "static" else _single_dynamic)(
        spec, case)
    np.testing.assert_allclose(got[0]["density_grid"],
                               want["density_grid"].numpy(), atol=SWEEP_ATOL)
    assert (got[0]["occ"] == want["occ"].numpy()).mean() >= 0.999
    assert int(got[0]["iter_density"]) == int(want["iter_density"])
    if kind == "dynamic":
        np.testing.assert_allclose(got[0]["bin_sums"],
                                   want["bin_sums"].numpy(), rtol=1e-6)
