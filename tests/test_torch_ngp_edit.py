"""The port's editing student on the Instant-NGP and D-NeRF fields
(StudentTrainer, make_teacher_field), its Morton codes and occupancy
bitfield, against the JAX package (the short distillation and the edit
CLIs at their defaults: tests/test_torch_ngp_edit_cli.py).

Narrow teachers at the edit CLIs' defaults (bound 2, dt_gamma 1/128, two
cascades; 4 levels, 2^12 entries a level, 32-wide towers, a 2 x 32 deform
tower, a 16^3 grid; the static field with the background sphere), trained
by the port on the CPU and carried to the JAX package by models/params.py
(tests/torch_edit_setup.py); the bbox edit of the reference's own tests.
Both packages get the same seeded numpy inputs. Tolerances:
- the wrapped forward and density (static, static with a secondary
  teacher, dynamic at t = 0 and t = 0.5) on points away from the edit
  mesh's faces: the bare fields' tolerance (test_torch_ngp.py), sigma rtol
  2e-2 with atol 1e-3, rgb and deform atol 2e-3;
- render_teacher_rays and proxy_dataset against the reference's
  StudentTrainer, both through render_occ on the force-filled occupancy
  (the static teacher with its background): the serving slices' frame
  limit, max |diff| <= 2e-2, depth within 2e-2;
- zone points equal; their ground truth (the port's teacher at the port's
  points and directions against the reference's teacher field at the
  same): the forward's tolerance;
- freeze labels: equal on the NGP (with background), deform, basis and
  hyper trees;
- one pretraining step (lr 0.07) against the reference's jitted step: loss
  rtol 1e-4; the encoder tables within 1e-4, apart from the entries whose
  gradient lies within f32 noise of 0 in the reference (at most 1 % of
  them: Adam's first step moves an entry by the lr times the sign of its
  gradient, and the two packages sum the gradient in other orders); the
  towers and the deform tower unchanged bit for bit in both;
- the deform tower bit for bit the teacher's across two train calls, with
  the other leaves' Adam state kept;
- morton3d, its inverse, packbits, unpackbits and occupancy_bitfield:
  equal.
"""

import dataclasses
import importlib
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.editing.student import StudentTrainer as JaxStudent
from sealdnerf_tpu.editing.teacher import make_teacher_field as jax_teacher
from sealdnerf_tpu_torch.data.rays import get_rays
from sealdnerf_tpu_torch.editing.student import freeze_labels
from sealdnerf_tpu_torch.editing.teacher import make_teacher_field
from sealdnerf_tpu_torch.models import dnerf as td
from sealdnerf_tpu_torch.models.params import (map_params, param_leaves,
                                               params_from_jax,
                                               params_to_numpy)
from sealdnerf_tpu_torch.render.dynamic_grid import time_slice_index

import torch_edit_setup as setup

SIGMA_TOL = dict(rtol=2e-2, atol=1e-3)
RGB_TOL = dict(rtol=0, atol=2e-3)
FRAME_TOL = 2e-2
STEP_TOL = 1e-4
FLIP_SHARE = 1e-2
ZONES = dict(local_point_step=0.05, surrounding_point_step=0.1,
             global_point_step=0.5)
PRE_BATCH = 1024


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def teachers(tmp_path_factory):
    return setup.ngp_teachers(tmp_path_factory)


@pytest.fixture(scope="module", params=["static", "dynamic"])
def edit(request, teachers):
    """Both packages' students around one teacher, their zones cached."""
    dynamic = request.param == "dynamic"
    ws, tt, jt = teachers(dynamic)
    mj, mt = setup.mappers(setup.seal_config())
    tf = setup.TIME_FRAME if dynamic else None
    st = setup.port_ngp_student(tt, ws + "/s", mt)
    st.init_pretraining(time_frame=tf, epochs=1, batch_size=PRE_BATCH,
                        **ZONES)
    np.random.seed(0)
    js = setup.jax_ngp_student(jt, ws + "/js", mj)
    js.init_pretraining(time_frame=tf, epochs=1, batch_size=PRE_BATCH,
                        **ZONES)
    return dict(dynamic=dynamic, tt=tt, jt=jt, mj=mj, mt=mt, st=st, js=js,
                tf=tf, val=setup.scene(dynamic)[1])


# ------------------------------------------------------------ the teacher
def _secondary():
    """A second static field, the same in both packages."""
    jf = setup.jax_ngp_field(False, seed=5)
    tf = setup.ngp_field(False)
    tf.params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       jf.params))
    return jf, tf


@pytest.mark.parametrize("case", ["plain", "secondary_or_t"])
@pytest.mark.parametrize("dynamic", [False, True],
                         ids=["static", "dynamic"])
def test_teacher_forward_and_density_match(teachers, dynamic, case):
    """Static: the bare edit, then with a secondary teacher; dynamic: at
    t = 0, then at t = 0.5 (its deform output kept)."""
    _, tt, jt = teachers(dynamic)
    mj, mt = setup.mappers(setup.seal_config())
    jsec = tsec = None
    if not dynamic and case == "secondary_or_t":
        jsec, tsec = _secondary()
    extra = ()
    if dynamic:
        extra = (0.0 if case == "plain" else setup.TIME_FRAME,)
    jtf = jax_teacher(jt.field, mj, secondary=jsec, time_conditioned=dynamic)
    ttf = make_teacher_field(tt.field, mt, secondary=tsec)
    assert ttf.background is tt.field.background
    pts, dirs = setup.edit_points(mj)
    jx = tuple(jnp.float32(e) for e in extra)
    out_j = jtf.forward(jt.params, jnp.asarray(pts), jnp.asarray(dirs), *jx)
    d_j = jtf.density(jt.params, jnp.asarray(pts), *jx)
    x, d = torch.from_numpy(pts), torch.from_numpy(dirs)
    with torch.no_grad():
        out_t = ttf.forward(tt.params, x, d, *extra)
        d_t = ttf.density(tt.params, x, *extra)
        bare = tt.field.forward(tt.params, x, d, *extra)
    assert len(out_t) == len(out_j) == (3 if dynamic else 2)
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]),
                               **SIGMA_TOL)
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]),
                               **RGB_TOL)
    if dynamic:
        np.testing.assert_allclose(out_t[2].numpy(), np.asarray(out_j[2]),
                                   **RGB_TOL)
    np.testing.assert_allclose(d_t[0].numpy(), np.asarray(d_j[0]),
                               **SIGMA_TOL)
    _, _, mask = mt.map_to_origin(x)
    assert 50 < int(mask.sum()) < len(pts) - 50
    # the edit changed the answer inside the mask and nowhere else
    moved = (bare[1] - out_t[1]).abs().amax(dim=1) > 1e-6
    assert bool(moved[mask].float().mean() > 0.5)
    assert not bool(moved[~mask].any())


def _val_rays(val, i):
    r = get_rays(torch.from_numpy(val.poses[i:i + 1]),
                 torch.from_numpy(val.intrinsics), val.h, val.w)
    return r["rays_o"][0].contiguous(), r["rays_d"][0].contiguous()


def test_render_teacher_rays_and_proxy_match(edit):
    """One val view through render_teacher_rays in chunks of 300 rays, and
    proxy_dataset over the val views, in both packages."""
    st, js, val = edit["st"], edit["js"], edit["val"]
    st.time_frame = js.time_frame = edit["tf"]
    ro, rd = _val_rays(val, 0)
    img_t, dep_t = st.render_teacher_rays(ro, rd, chunk=300)
    img_j, dep_j = js.render_teacher_rays(jnp.asarray(ro.numpy()),
                                          jnp.asarray(rd.numpy()), chunk=300)
    assert np.abs(img_t.numpy() - np.asarray(img_j)).max() <= FRAME_TOL
    assert np.abs(dep_t.numpy() - np.asarray(dep_j)).max() <= FRAME_TOL
    if not edit["dynamic"]:
        # rays that leave the scene show the teacher's background sphere,
        # not white
        assert float(img_t.min()) < 0.95
    pt = st.proxy_dataset(val)
    pj = js.proxy_dataset(val, time=edit["tf"])
    assert pt.images.shape == (len(val), val.h, val.w, 3)
    assert np.abs(pt.images - pj.images).max() <= FRAME_TOL
    if edit["dynamic"]:
        assert np.all(pt.times == np.float32(setup.TIME_FRAME))
    # the edit shows in the proxy
    bare, _ = st.render_teacher_image(val.poses[0], val.intrinsics, val.h,
                                      val.w, edited=False)
    assert np.abs(bare - pt.images[0]).max() > 1e-3


# ---------------------------------------------------------- pretraining
def _live(zone):
    w = np.asarray(zone["weight"]).reshape(-1) > 0
    return {k: np.asarray(v).reshape(w.shape[0], -1)[w]
            for k, v in zone.items()}


def test_zone_points_and_ground_truth_match(edit):
    st, js, jt = edit["st"], edit["js"], edit["jt"]
    assert set(st.pretraining_data) == set(js.pretraining_data) == {
        "local", "surrounding", "global"}
    dyn = edit["dynamic"]
    extra = (jnp.float32(edit["tf"]),) if dyn else ()
    jtf = jax_teacher(jt.field, edit["mj"], time_conditioned=dyn)
    for name in st.pretraining_data:
        mine = _live({k: v.numpy() for k, v in
                      st.pretraining_data[name].items()})
        ref = _live(js.pretraining_data[name])
        np.testing.assert_array_equal(mine["points"], ref["points"])
        assert len(mine["points"]) > 20
        fwd = jtf.forward if name == "local" else jt.field.forward
        s_j, c_j = fwd(jt.params, jnp.asarray(mine["points"]),
                       jnp.asarray(mine["dirs"]), *extra)[:2]
        np.testing.assert_allclose(mine["sigma"].reshape(-1),
                                   np.asarray(s_j), **SIGMA_TOL)
        np.testing.assert_allclose(mine["color"], np.asarray(c_j),
                                   **RGB_TOL)
    assert sorted(os.listdir(os.path.join(st.workspace, "pretrain_vis"))) \
        == ["global.ply", "local.ply", "surrounding.ply"]


def test_freeze_labels_on_ngp_trees():
    """The reference's labels on the NGP tree with its background and on
    the deform, basis and hyper D-NeRF trees."""
    trees = [params_to_numpy(setup.ngp_field(False).params)]
    for variant in ("deform", "basis", "hyper"):
        trees.append(params_to_numpy(td.init_dnerf(
            torch.Generator().manual_seed(0),
            td.DNeRFConfig(variant=variant, bg_radius=1.0,
                           **setup.NGP_NARROW))))
    st = object.__new__(JaxStudent)
    for params in trees:
        ref = JaxStudent._freeze_labels(st, params)
        got = freeze_labels(params)
        assert set(got) == set(ref)
        for k, lab in got.items():
            assert set(jax.tree_util.tree_leaves(ref[k])) == {lab}, k
    assert freeze_labels(trees[0]) == {
        "grid": "enc", "bg_grid": "enc", "sigma_mlp": "mlp",
        "color_mlp": "mlp", "bg_mlp": "mlp"}
    assert [freeze_labels(t).get(k) for t, k in zip(
        trees[1:], ("deform_mlp", "basis_mlp", "ambient_mlp"))] == [
        "deform"] * 3


def test_one_pretraining_step_matches(edit):
    st, js = edit["st"], edit["js"]
    js._build_pretrain_step()
    batch = {k: v[0] for k, v in st.pretraining_data["local"].items()}
    before = map_params(np.copy, params_to_numpy(st.params))
    jparams = jax.tree_util.tree_map(jnp.asarray, before)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    t = jnp.float32(edit["tf"] or 0.0)
    # the reference's gradient, to name the entries whose sign is noise
    g_j = jax.grad(lambda p: _jax_l1(js, p, jbatch, t))(jparams)
    new_j, _, loss_j = js._pretrain_step_fn(jparams, js._pretrain_state,
                                            jbatch, t)
    st.time_frame = edit["tf"]
    st._build_pretrain_optimizer()
    loss_t = st.pretrain_step(batch)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=STEP_TOL)
    labels = freeze_labels(st.params)
    after = params_to_numpy(st.params)
    for k in after:
        for a, b, p, g in zip(jax.tree_util.tree_leaves(after[k]),
                              jax.tree_util.tree_leaves(new_j[k]),
                              jax.tree_util.tree_leaves(before[k]),
                              jax.tree_util.tree_leaves(g_j[k])):
            if labels[k] == "enc":
                g = np.abs(np.asarray(g))
                noise = g <= 1e-5 * g.max()
                off = np.abs(a - np.asarray(b)) > STEP_TOL
                assert not (off & ~noise).any(), k
                assert off.mean() <= FLIP_SHARE, (k, off.mean())
                if k == "grid":
                    assert np.abs(a - p).max() > 1e-2      # it moved
            else:
                np.testing.assert_array_equal(a, p, err_msg=k)
                np.testing.assert_array_equal(np.asarray(b), p, err_msg=k)
    # restore the student for the other tests of the module
    with torch.no_grad():
        for q, p in zip(param_leaves(st.params), param_leaves(
                map_params(torch.from_numpy, before))):
            q.copy_(p)


def _jax_l1(js, params, batch, t):
    """The reference's pretraining loss (editing/student.py:357-366)."""
    extra = (t,) if js.time_conditioned else ()
    out = js.field.forward(params, batch["points"], batch["dirs"], *extra)
    w = batch["weight"]
    l_sig = jnp.sum(jnp.abs(out[0] - batch["sigma"]) * w) / \
        jnp.maximum(jnp.sum(w), 1.0)
    l_col = jnp.sum(jnp.abs(out[1] - batch["color"]) * w[:, None]) / \
        jnp.maximum(jnp.sum(w) * 3, 1.0)
    return l_sig + l_col


def test_deform_frozen_and_adam_state_kept(tmp_path, teachers):
    """Two train calls of a D-NeRF student: the deform leaves stay the
    teacher's bit for bit, the other leaves' Adam moments go on from the
    first call (the optimizer is never rebuilt), and the student's training
    rays march its occupancy with the edit forced on."""
    tt = teachers(True)[1]
    _, mt = setup.mappers(setup.seal_config())
    st = setup.port_ngp_student(tt, str(tmp_path / "s"), mt, iters=10_000,
                       segment_steps=8)
    st.time_frame = setup.TIME_FRAME
    train, _ = setup.scene(True)
    train = _first_views(train, 2)
    deform = [p.clone() for p in param_leaves(tt.params["deform_mlp"])]
    grid0 = tt.params["grid"].detach().clone()
    opt = st.optimizer
    st.train(train, None, max_epochs=1)
    leaf = st.params["grid"]
    count1 = int(opt.state[leaf]["step"])
    assert count1 == 8                            # one epoch of 8 steps
    st.train(train, None, max_epochs=1)
    assert st.optimizer is opt
    assert int(opt.state[leaf]["step"]) == 2 * count1
    for a, b in zip(param_leaves(st.params["deform_mlp"]), deform):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not a.requires_grad and a not in opt.state
    assert not torch.equal(st.params["grid"], grid0)
    t = torch.tensor(setup.TIME_FRAME)
    b = int(time_slice_index(t, st.dyn_grid_cfg))
    assert torch.equal(st._occ_at(t),
                       st.grid_state["occ"][b] | st.fill_mask[b])


def _first_views(ds, n):
    return dataclasses.replace(
        ds, poses=ds.poses[:n], images=ds.images[:n],
        times=None if ds.times is None else ds.times[:n])


# ------------------------------------------------- Morton codes, bitfield
def test_morton_and_packbits_match():
    jm = importlib.import_module("sealdnerf_tpu.ops.morton")
    jp = importlib.import_module("sealdnerf_tpu.ops.packbits")
    jg = importlib.import_module("sealdnerf_tpu.render.grid")
    from sealdnerf_tpu_torch.ops import morton as tm
    from sealdnerf_tpu_torch.ops import packbits as tp
    from sealdnerf_tpu_torch.render import grid as tg
    rng = np.random.default_rng(0)
    c = rng.integers(0, 1024, (4096, 3)).astype(np.int32)
    codes = tm.morton3d(torch.from_numpy(c))
    np.testing.assert_array_equal(codes.numpy(),
                                  np.asarray(jm.morton3d(jnp.asarray(c))))
    np.testing.assert_array_equal(tm.morton3d_invert(codes).numpy(), c)
    np.testing.assert_array_equal(
        tm.morton3d_invert(codes).numpy(),
        np.asarray(jm.morton3d_invert(jnp.asarray(codes.numpy()))))
    g = rng.normal(size=(2, 16 ** 3)).astype(np.float32)
    bits = tp.packbits(torch.from_numpy(g), 0.3)
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(jp.packbits(jnp.asarray(g), 0.3)))
    np.testing.assert_array_equal(tp.unpackbits(bits).numpy(), g > 0.3)
    state = {"density_grid": torch.from_numpy(g),
             "mean_density": torch.tensor(0.2)}
    cfg = tg.GridConfig(cascades=2, grid_size=16, density_thresh=0.5)
    from sealdnerf_tpu.ops.marching import MarchConfig
    jcfg = jg.GridConfig(march=MarchConfig(cascades=2, grid_size=16),
                         density_thresh=0.5)
    np.testing.assert_array_equal(
        tg.occupancy_bitfield(state, cfg).numpy(),
        np.asarray(jg.occupancy_bitfield(
            {k: jnp.asarray(v.numpy()) for k, v in state.items()}, jcfg)))
