"""The port's edit-aware teacher against the JAX package.

Narrow teachers (static and dynamic) are trained by the port on the CPU and
loaded into both packages from one checkpoint (tests/torch_edit_setup.py);
the edit is the bbox move-and-recolour of the reference's own tests. On the
CPU the port's teacher runs the kernels' plain versions, the reference's
its XLA field. Tolerances:
- the wrapped forward and density (static, static with a secondary
  teacher, dynamic at t = 0 and t = 0.5) on points away from the edit
  mesh's faces: the bare field's tolerance against the reference's XLA
  model (test_torch_dyn_field.py): rtol 2e-2 with atol 1e-3 (sigma) and
  2e-3 (rgb);
- render_teacher_rays and proxy_dataset against the reference's own, both
  through render_occ (the packed march on the force-filled occupancy, in
  chunks with a packed budget per chunk): the frames' limits of the
  serving slices (test_torch_slice.py), max |diff| <= 2e-2 and depth
  within 2e-2;
- force_fill_mask and hack_occ: equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.editing.student import StudentTrainer as JaxStudent
from sealdnerf_tpu.editing.teacher import hack_occ as jax_hack_occ
from sealdnerf_tpu.editing.teacher import make_teacher_field
from sealdnerf_tpu.models.cp import CPConfig as JaxCPConfig
from sealdnerf_tpu.models.cp import make_cp_field as jax_cp_field
from sealdnerf_tpu_torch.data.rays import get_rays
from sealdnerf_tpu_torch.editing.student import FastStudentTrainer
from sealdnerf_tpu_torch.editing.teacher import TeacherField, hack_occ
from sealdnerf_tpu_torch.models.cp import CPField, map_params, \
    params_from_jax
from sealdnerf_tpu_torch.render.dynamic_grid import time_slice_index

import torch_edit_setup as setup

SIGMA_TOL = dict(rtol=2e-2, atol=1e-3)
RGB_TOL = dict(rtol=2e-2, atol=2e-3)
FRAME_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["static", "dynamic"])
def edit(request, tmp_path_factory):
    """Port teacher, JAX teacher, both mappers, the port's student and the
    JAX student, around one trained teacher."""
    dynamic = request.param == "dynamic"
    ws = str(tmp_path_factory.mktemp(f"teacher_{request.param}"))
    tt = setup.train_port_teacher(ws, dynamic)
    jt = setup.jax_teacher(ws, dynamic)
    mj, mt = setup.mappers(setup.seal_config())
    field = CPField(map_params(lambda t: t.detach().clone(), tt.params),
                    tt.field.cfg)
    st = FastStudentTrainer(
        "ngp", setup.port_options(ws + "_s", dynamic), field, tt, mapper=mt,
        workspace=ws + "_s", use_checkpoint="scratch", device="cpu",
        time_conditioned=dynamic)
    st.adopt_grid_state(tt.grid_state)
    st.time_frame = setup.TIME_FRAME if dynamic else None
    js = JaxStudent("ngp", setup.jax_options(ws + "_js"), jt.field, jt,
                    mapper=mj, workspace=ws + "_js", use_checkpoint="scratch",
                    time_conditioned=dynamic)
    js.time_frame = st.time_frame
    return dict(dynamic=dynamic, tt=tt, jt=jt, mj=mj, mt=mt, st=st, js=js,
                val=setup.scene(dynamic)[1])


def _points(mj, n=3000, seed=0):
    from sealdnerf_tpu.editing.geometry import points_mesh_distance
    rng = np.random.default_rng(seed)
    b = np.asarray(mj.map_data["force_fill_bound"])
    pts = np.concatenate([rng.uniform(-1, 1, (n // 3, 3)),
                          rng.uniform(b[:, 0].min(0), b[:, 1].max(0),
                                      (n - n // 3, 3))]).astype(np.float32)
    far = np.asarray(points_mesh_distance(
        jnp.asarray(pts), jnp.asarray(mj.map_triangles))) > 1e-4
    pts = pts[far]
    d = rng.normal(size=pts.shape).astype(np.float32)
    return pts, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _secondary():
    """A second static field, the same in both packages."""
    jf = jax_cp_field(jax.random.PRNGKey(5), JaxCPConfig(**setup.STATIC_FIELD))
    tf = CPField(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        jf.params)),
                 setup.CPConfig(**setup.STATIC_FIELD))
    return jf, tf


@pytest.mark.parametrize("case", ["plain", "secondary_or_t"])
def test_teacher_forward_and_density_match(edit, case):
    """Static: the bare edit, then with a secondary teacher; dynamic: at
    t = 0, then at t = 0.5."""
    dyn = edit["dynamic"]
    jsec, tsec = (None, None)
    if not dyn and case == "secondary_or_t":
        jsec, tsec = _secondary()
    extra = ()
    if dyn:
        extra = (0.0 if case == "plain" else setup.TIME_FRAME,)
    jt, tt = edit["jt"], edit["tt"]
    jtf = make_teacher_field(jt.field, edit["mj"], secondary=jsec,
                             time_conditioned=dyn)
    ttf = TeacherField(tt.field, edit["mt"], secondary=tsec,
                       time_conditioned=dyn)
    pts, dirs = _points(edit["mj"])
    jx = tuple(jnp.float32(e) for e in extra)
    s_j, c_j = jtf.forward(jt.params, jnp.asarray(pts), jnp.asarray(dirs),
                           *jx)[:2]
    with torch.no_grad():
        s_t, c_t = ttf.forward(tt.params, torch.from_numpy(pts),
                               torch.from_numpy(dirs), *extra)
        d_t = ttf.density(tt.params, torch.from_numpy(pts), *extra)
    d_j = jtf.density(jt.params, jnp.asarray(pts), *jx)[0]
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **SIGMA_TOL)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **RGB_TOL)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), **SIGMA_TOL)
    _, _, mask = edit["mt"].map_to_origin(torch.from_numpy(pts))
    assert 50 < int(mask.sum()) < len(pts) - 50
    # the edit changed the answer inside the mask and nowhere else
    with torch.no_grad():
        bare = tt._render_forward()(tt.field.kernel_tables(tt.params),
                                    torch.from_numpy(pts.T.copy()),
                                    torch.from_numpy(dirs.T.copy()), *extra)
    moved = (bare[1:4].t() - c_t).abs().amax(dim=1) > 1e-6
    assert bool(moved[mask].float().mean() > 0.5) and not bool(moved[~mask].any())


def _val_rays(val, i):
    r = get_rays(torch.from_numpy(val.poses[i:i + 1]),
                 torch.from_numpy(val.intrinsics), val.h, val.w)
    return r["rays_o"][0].contiguous(), r["rays_d"][0].contiguous()


def test_teacher_fill_and_occupancy(edit):
    st, jt, js = edit["st"], edit["jt"], edit["js"]
    np.testing.assert_array_equal(st.fill_mask.numpy(),
                                  np.asarray(js.fill_mask))
    np.testing.assert_array_equal(
        st.teacher_occ().numpy(), np.asarray(js.teacher_occ()))
    occ = np.asarray(jt.grid_state["occ"])
    np.testing.assert_array_equal(
        hack_occ(torch.from_numpy(occ), st.fill_mask).numpy(),
        np.asarray(jax_hack_occ(jnp.asarray(occ), js.fill_mask)))
    assert not st.fill_mask.all() and st.fill_mask.any()
    # the student's march occupancy carries the fill, its grid does not
    tt = edit["tt"]
    np.testing.assert_array_equal(st.grid_state["occ"].numpy(),
                                  tt.grid_state["occ"].numpy())
    assert bool((st._occ_m >= st._march_occ()).all())


def test_render_teacher_rays_matches(edit):
    """Chunks of 300 rays, so that the packed budget of 300 * 64 samples
    a chunk binds where rays are dense, in both packages alike."""
    ro, rd = _val_rays(edit["val"], 0)
    img_t, dep_t = edit["st"].render_teacher_rays(ro, rd, chunk=300)
    img_j, dep_j = edit["js"].render_teacher_rays(
        jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()), chunk=300)
    assert img_t.shape == (ro.shape[0], 3)
    assert np.abs(img_t.numpy() - np.asarray(img_j)).max() <= FRAME_TOL
    np.testing.assert_allclose(dep_t.numpy(), np.asarray(dep_j), rtol=0,
                               atol=FRAME_TOL)
    assert img_t.min() < 0.9                  # not a blank background


def test_proxy_dataset_matches(edit):
    st, js, val = edit["st"], edit["js"], edit["val"]
    t = setup.TIME_FRAME if edit["dynamic"] else None
    mine = st.proxy_dataset(val)
    ref = js.proxy_dataset(val, time=t)
    assert mine.images.shape == (len(val), val.h, val.w, 3)
    if edit["dynamic"]:
        np.testing.assert_array_equal(mine.times, np.full(len(val), t))
        np.testing.assert_array_equal(ref.times, mine.times)
    else:
        assert mine.times is None
    for i in range(len(val)):
        diff = np.abs(mine.images[i] - np.asarray(ref.images[i])).max()
        print(f"view {i}: max |port - reference| {diff:.3g}")
        assert diff <= FRAME_TOL, (i, diff)
    # the edit shows: the proxied view differs from the unedited teacher's
    plain = np.stack([st.render_teacher_image(val.poses[i], val.intrinsics,
                                              val.h, val.w, edited=False)[0]
                      for i in range(len(val))])
    assert np.abs(plain - mine.images).max() > 0.1
    # the time bin the dynamic teacher marched
    if edit["dynamic"]:
        assert time_slice_index(t, st.teacher_trainer.dyn_grid_cfg) == 32
