"""SDF fitting in the port (models/sdf.py, data/sdf_provider.py, main_sdf)
against the JAX package.

Tolerances:
- sdf_forward at the full grid (16 levels x 2, 2^19 entries) and the 3 x 64
  tower, also with a skip: the NGP fields' bf16 tolerance (rtol 2e-2, atol
  1e-3: the same rounding points, f32 sums in other orders);
- SDFDataset.sample_batch: the points and sdfs equal to the reference's bit
  for bit on the same mesh and seed (numpy draws, the same BVH code);
- the BVH's signed distance against the plain point-triangle distance and
  the ray-parity inside test (editing/geometry.py) on 400 points off the
  surface: atol 1e-5, signs equal;
- main_sdf's optimizer (two Adam groups, weight decay 1e-6 on the tower
  added to the gradient, the x0.1-every-1000-steps staircase) and EMA
  against optax's chain over 3 steps of identical gradients: rtol 1e-5,
  atol 1e-8 (an f32 ulp of the tower's entries near 0.1); the schedule's
  values at 0, 999, 1000 and 2500: rtol 1e-6 (optax's are f32);
- main_sdf synthetic --device cpu end to end (2 epochs of 32 steps of
  1,024 points, a 32^3 export of the EMA), its checkpoint read by the
  reference, then --test (the latest checkpoint's params).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import main_sdf as jax_main_sdf
from sealdnerf_tpu.data.sdf_provider import SDFDataset as JaxSDFDataset
from sealdnerf_tpu.models import sdf as js
from sealdnerf_tpu.train.checkpoint import load_checkpoint as jax_load
from sealdnerf_tpu_torch import main_sdf
from sealdnerf_tpu_torch.data.sdf_provider import SDFDataset, load_mesh
from sealdnerf_tpu_torch.editing.geometry import (points_in_mesh,
                                                  points_mesh_distance)
from sealdnerf_tpu_torch.models import sdf as ts
from sealdnerf_tpu_torch.models.params import (param_leaves, params_from_jax,
                                               params_to_numpy)

SDF_TOL = dict(rtol=2e-2, atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sphere(tmp_path_factory):
    """The procedural sphere mesh, written by the port and by the
    reference: the same PLY bytes."""
    d = tmp_path_factory.mktemp("sphere")
    main_sdf.make_sphere_mesh(str(d / "port.ply"))
    jax_main_sdf._make_sphere_mesh(str(d / "jax.ply"))
    assert (d / "port.ply").read_bytes() == (d / "jax.ply").read_bytes()
    return str(d / "port.ply")


@pytest.mark.parametrize("skips", [(), (1,)])
def test_sdf_forward_matches_jax(skips):
    jcfg, tcfg = js.SDFConfig(skips=skips), ts.SDFConfig(skips=skips)
    jp = js.init_sdf(jax.random.PRNGKey(0), jcfg)
    # a table of the trained scale: the seeded U(+-1e-4) one gives ~0
    jp = dict(jp, grid=jp["grid"] * 1e4)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    own = ts.init_sdf(torch.Generator().manual_seed(0), tcfg)
    assert [tuple(a.shape) for a in param_leaves(own)] == \
        [b.shape for b in jax.tree_util.tree_leaves(jp)]
    for a, b in zip(param_leaves(params_from_jax(params_to_numpy(tp))),
                    param_leaves(tp)):
        assert torch.equal(a, b)
    x = np.random.default_rng(0).uniform(-1, 1, (400, 3)).astype(np.float32)
    want = np.asarray(js.sdf_forward(jp, jcfg, jnp.asarray(x)))
    got = ts.sdf_forward(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **SDF_TOL)
    assert np.abs(want).max() > 1e-2
    clip = ts.SDFConfig(skips=skips, clip_sdf=0.5 * float(np.abs(want).max()))
    np.testing.assert_allclose(
        ts.sdf_forward(tp, clip, torch.from_numpy(x)).numpy(),
        np.asarray(js.sdf_forward(jp, js.SDFConfig(skips=skips,
                                                   clip_sdf=clip.clip_sdf),
                                  jnp.asarray(x))), **SDF_TOL)


def test_sample_batch_equals_jax(sphere, tmp_path):
    jds = JaxSDFDataset(sphere, size=2, num_samples=4096, seed=3)
    tds = SDFDataset(sphere, size=2, num_samples=4096, seed=3)
    np.testing.assert_array_equal(tds.verts, jds.verts)
    for _ in range(2):
        a, b = tds.sample_batch(), jds.sample_batch()
        for k in ("points", "sdfs"):
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
    # the OBJ reader
    verts, faces = load_mesh(sphere)
    obj = tmp_path / "sphere.obj"
    obj.write_text("".join(f"v {x!r} {y!r} {z!r}\n" for x, y, z in
                           verts.tolist())
                   + "".join(f"f {a + 1}/1 {b + 1}/1 {c + 1}/1\n"
                             for a, b, c in faces.tolist()))
    v2, f2 = load_mesh(str(obj))
    np.testing.assert_array_equal(v2, verts)
    np.testing.assert_array_equal(f2, faces)


def test_bvh_against_the_plain_query(sphere):
    ds = SDFDataset(sphere, size=1, num_samples=8)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    tris = torch.from_numpy(ds.verts[ds.faces])
    dist = points_mesh_distance(torch.from_numpy(pts), tris).numpy()
    pts, dist = pts[dist > 1e-3][:400], dist[dist > 1e-3][:400]
    inside = points_in_mesh(torch.from_numpy(pts), tris).numpy()
    q = ds.query(pts)
    # the threads' split gives each point the single thread's value
    np.testing.assert_array_equal(ds.query(pts, threads=1), q)
    np.testing.assert_array_equal(ds.query(pts, threads=7), q)
    assert len(pts) == 400 and 0.05 < inside.mean() < 0.95
    np.testing.assert_allclose(np.abs(q), dist, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(q > 0, inside)
    # the reference's sign check: centre inside, corner outside
    q = ds.query(np.array([[0.0, 0.0, 0.0], [0.9, 0.9, 0.9]], np.float32))
    assert q[0] > 0 and q[1] < 0


def test_optimizer_and_ema_match_optax():
    cfg = js.SDFConfig()
    jp = js.init_sdf(jax.random.PRNGKey(0), cfg)
    fitter = main_sdf.SDFFitter(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)), ts.SDFConfig(), 1e-3)
    # the reference main_sdf's optimizer and EMA (main_sdf.py:259-285)
    sched = optax.exponential_decay(1e-3, transition_steps=10 * 100,
                                    decay_rate=0.1, staircase=True)
    tx = optax.multi_transform({
        "enc": optax.adam(sched, b1=0.9, b2=0.99, eps=1e-15),
        "net": optax.chain(optax.add_decayed_weights(1e-6),
                           optax.adam(sched, b1=0.9, b2=0.99, eps=1e-15)),
    }, lambda p: {k: jax.tree_util.tree_map(
        lambda _: "enc" if k == "grid" else "net", v) for k, v in p.items()})
    state, ema = tx.init(jp), jp
    rng = np.random.default_rng(2)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(size=a.shape).astype(
                np.float32)), jp)
        upd, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, upd)
        ema = jax.tree_util.tree_map(lambda e, p: 0.95 * e + 0.05 * p, ema,
                                     jp)
        for p, g in zip(param_leaves(fitter.params),
                        jax.tree_util.tree_leaves(grads)):
            p.grad = torch.from_numpy(np.asarray(g))
        fitter.apply_gradients()
    for tree, want in ((fitter.params, jp), (fitter.ema, ema)):
        for a, b in zip(param_leaves(tree), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-8)
    lam = fitter.scheduler.lr_lambdas[0]
    for k in (0, 999, 1000, 2500):
        np.testing.assert_allclose(1e-3 * lam(k), float(sched(k)),
                                   rtol=1e-6, err_msg=str(k))


def test_main_sdf_on_the_cpu(tmp_path, monkeypatch):
    """`main_sdf synthetic --device cpu`: 2 epochs (cut from 100 steps to
    32 each), the loss falls, a mesh is exported; the reference reads its
    checkpoint; --test exports the latest checkpoint."""
    monkeypatch.setattr(main_sdf, "STEPS_PER_EPOCH", 32)
    ws = str(tmp_path)
    base = ["synthetic", "--device", "cpu", "--workspace", ws,
            "--mesh_resolution", "32"]
    fitter, (verts, tris, _) = main_sdf.main(
        base + ["--epochs", "2", "--num_samples", "1024"])
    loss = np.asarray(fitter.history["loss"])
    assert len(loss) == 64 and np.isfinite(loss).all()
    assert loss[32:].mean() < loss[:32].mean()
    assert len(tris) > 0
    ply = os.path.join(ws, "results", "output.ply")
    assert os.path.exists(ply)
    state, meta = jax_load(os.path.join(ws, "checkpoints", "sdf_ep0002.npz"))
    assert meta["epoch"] == 2
    for a, b in zip(param_leaves(fitter.ema),
                    jax.tree_util.tree_leaves(state["ema"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert js.sdf_forward(jax.tree_util.tree_map(jnp.asarray,
                                                 state["params"]),
                          js.SDFConfig(), jnp.zeros((1, 3))).shape == (1,)
    os.remove(ply)
    # --test exports the latest checkpoint's params (the reference's pick)
    _, (verts2, tris2, _) = main_sdf.main(base + ["--test"])
    assert os.path.exists(ply) and len(tris2) > 0
    verts3, _, _ = main_sdf.export_mesh(fitter.params, ts.SDFConfig(), 32,
                                        ply)
    np.testing.assert_array_equal(verts2, verts3)
