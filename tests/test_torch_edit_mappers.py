"""The port's Seal mappers and their geometry against the JAX package.

Same seeded numpy inputs through sealdnerf_tpu.editing and
sealdnerf_tpu_torch.editing. Tolerances:
- colour utilities: 1e-6 (the same f32 arithmetic);
- host geometry (numpy in both): equal;
- sample-side geometry: the in-mesh predicates equal on points farther than
  1e-4 from every face (a point within float noise of a face, or of the
  plane a ray grazes, may fall on either side in sums of another order);
  projections and distances within 1e-5;
- mappers built from one config: map_mask equal (points away from faces,
  as above), map_to_origin and map_color within 1e-5; the port's chunked
  map_to_origin_compact equal to its own full-batch map_to_origin;
- force_fill_mask equal, static and dynamic;
- the config reader: the same dict as json5 on a config with comments and
  trailing commas.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import json5
import pytest
import torch

from sealdnerf_tpu.editing import color_utils as jcu
from sealdnerf_tpu.editing import geometry as jgeo
from sealdnerf_tpu.editing import seal_utils as jseal
from sealdnerf_tpu.editing.teacher import force_fill_mask as jax_fill
from sealdnerf_tpu_torch.editing import color_utils as tcu
from sealdnerf_tpu_torch.editing import geometry as tgeo
from sealdnerf_tpu_torch.editing import seal_utils as tseal
from sealdnerf_tpu_torch.editing.teacher import force_fill_mask as torch_fill
from sealdnerf_tpu_torch.utils.png import write_png

FACE_MARGIN = 1e-4
TOL = dict(rtol=0, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _n(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _rgb(n=512, seed=0):
    rgb = np.random.default_rng(seed).random((n, 3)).astype(np.float32)
    rgb[:8] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0],
               [0, 1, 0], [0, 0, 1], [1, 1, 0], [0.2, 0.2, 0.9]]
    return rgb


@pytest.mark.parametrize("fn", ["rgb_to_hsv", "hsv_to_rgb", "modify_hsv",
                                "modify_rgb", "modify_rgb_rows"])
def test_color_utils_match(fn):
    rgb = _rgb()
    if fn == "modify_hsv":
        args = (rgb, [0.3, -0.2, 0.1])
    elif fn == "modify_rgb":
        args = (rgb, [0.1, 0.7, 0.3], 0.05)
    elif fn == "modify_rgb_rows":
        fn, args = "modify_rgb", (rgb, _rgb(seed=1), -0.1)
    else:
        args = (rgb,)
    if fn == "hsv_to_rgb":
        # hues beyond [0, 1) and saturations beyond [0, 1] wrap and clip
        args = (rgb * np.float32([3.0, 1.4, 1.0]) - np.float32([1, 0.2, 0]),)
    ref = getattr(jcu, fn)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                             else a for a in args])
    got = getattr(tcu, fn)(*[_t(a) if isinstance(a, np.ndarray) else a
                             for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_modify_rgb_subset_with_batch_mean():
    """A subset recoloured with the batch's mean value is the batch's
    recolouring restricted to it."""
    rgb = _t(_rgb())
    whole = tcu.modify_rgb(rgb, [0.1, 0.7, 0.3])
    sub = tcu.modify_rgb(rgb[::3], [0.1, 0.7, 0.3],
                         v_mean=tcu.rgb_to_hsv(rgb)[..., 2].mean())
    torch.testing.assert_close(sub, whole[::3], rtol=0, atol=0)


def _shell(n=128, seed=3, r=0.36, c=(0.0, 0.1, 0.0)):
    g = np.random.default_rng(seed).normal(size=(n, 3))
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    return g * r + np.asarray(c)


def test_host_geometry_is_the_reference():
    pts = _shell() * np.array([1.0, 0.6, 0.3])
    for a, b in zip(jgeo.oriented_bounding_box(pts),
                    tgeo.oriented_bounding_box(pts)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jgeo.plane_best_fit(pts), tgeo.plane_best_fit(pts)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jgeo.uv_sphere_points(0.3),
                                  tgeo.uv_sphere_points(0.3))
    flat = pts * np.array([1.0, 1.0, 0.0])
    for a, b in zip(jgeo.extruded_surface_mesh(flat, [0, 0, 0.1]),
                    tgeo.extruded_surface_mesh(flat, [0, 0, 0.1])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jgeo.aabb_mesh([-1, -0.5, 0], [0.2, 0.3, 0.9]),
                    tgeo.aabb_mesh([-1, -0.5, 0], [0.2, 0.3, 0.9])):
        np.testing.assert_array_equal(a, b)
    v, f = tgeo.box_mesh(jgeo.oriented_bounding_box(pts)[0])
    np.testing.assert_array_equal(tgeo.mesh_triangles(v, f),
                                  jgeo.mesh_triangles(v, f))


def _away_from(points, tris):
    """Points farther than FACE_MARGIN from every triangle (reference
    distance)."""
    d = np.asarray(jgeo.points_mesh_distance(jnp.asarray(points),
                                             jnp.asarray(tris)))
    return d > FACE_MARGIN


def _mesh_case():
    verts, faces, _, _, _ = jgeo.oriented_bounding_box(
        _shell() * np.array([1.0, 0.7, 0.5]))
    tris = jgeo.mesh_triangles(verts, faces)
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.4, 0.5, (4000, 3)).astype(np.float32)
    return tris, pts


@pytest.mark.parametrize("test_dir", [None, (0.0, 0.2, 1.0)])
def test_points_in_mesh_match(test_dir):
    tris, pts = _mesh_case()
    keep = _away_from(pts, tris)
    assert keep.mean() > 0.99
    tdir = None if test_dir is None else np.asarray([test_dir], np.float32)
    ref = np.asarray(jgeo.points_in_mesh(
        jnp.asarray(pts), jnp.asarray(tris),
        None if tdir is None else jnp.asarray(tdir)))
    got = tgeo.points_in_mesh(_t(pts), _t(tris),
                              None if tdir is None else _t(tdir)).numpy()
    assert 0.05 < ref.mean() < 0.95
    np.testing.assert_array_equal(got[keep], ref[keep])


def test_moller_trumbore_match():
    tris, pts = _mesh_case()
    d = np.random.default_rng(2).normal(size=pts.shape).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = np.asarray(jgeo.moller_trumbore(jnp.asarray(pts), jnp.asarray(d),
                                          jnp.asarray(tris)))
    got = tgeo.moller_trumbore(_t(pts), _t(d), _t(tris)).numpy()
    keep = _away_from(pts, tris)
    # a ray that grazes an edge may hit on either side of it: bound those
    assert (got[keep] != ref[keep]).mean() < 1e-3
    assert 0.05 < ref.mean() < 0.95


def test_projection_and_distance_match():
    tris, pts = _mesh_case()
    n, p0 = np.float32([0.3, -0.5, 0.8]), np.float32([0.1, 0.2, -0.1])
    np.testing.assert_allclose(
        tgeo.project_points(_t(n), _t(p0), _t(pts)).numpy(),
        np.asarray(jgeo.project_points(jnp.asarray(n), jnp.asarray(p0),
                                       jnp.asarray(pts))), **TOL)
    np.testing.assert_allclose(
        tgeo.points_mesh_distance(_t(pts), _t(tris)).numpy(),
        np.asarray(jgeo.points_mesh_distance(jnp.asarray(pts),
                                             jnp.asarray(tris))), **TOL)


def test_mesh_surface_points_mask_match():
    tris, pts = _mesh_case()
    # points on the faces (the brush's border points) and off them
    w = np.random.default_rng(4).dirichlet([1, 1, 1], size=len(tris) * 8)
    on = np.einsum("nk,nkd->nd", w, np.repeat(tris, 8, axis=0))
    cand = np.concatenate([on, pts[:500]]).astype(np.float32)
    ref = np.asarray(jgeo.mesh_surface_points_mask(jnp.asarray(tris),
                                                   jnp.asarray(cand)))
    got = tgeo.mesh_surface_points_mask(_t(tris), _t(cand)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ref[:len(on)].all() and not ref[len(on):].all()


# ---------------------------------------------------------------- mappers
def _texture(tmp_path):
    rng = np.random.default_rng(5)
    img = (rng.random((6, 5, 4)) * 255).astype(np.uint8)
    img[..., 3] = np.where(rng.random((6, 5)) < 0.3, 0, 255)
    path = os.path.join(str(tmp_path), "tex.png")
    write_png(path, img)
    return {"path": path, "o": [-0.4, -0.3, 0.0], "w": [0.4, -0.3, 0.05],
            "h": [-0.4, 0.5, 0.0]}


def _configs(tmp_path):
    t = np.eye(4)
    t[1, 3] = 0.3
    t[:3, :3] = [[0.96, -0.28, 0], [0.28, 0.96, 0], [0, 0, 1]]
    shell = _shell().tolist()
    rng = np.random.default_rng(6)
    patch = np.stack([rng.uniform(-0.3, 0.3, 64), rng.uniform(-0.2, 0.2, 64),
                      0.05 * rng.normal(size=64) + 0.1], axis=-1)
    brush = {"type": "brush", "raw": patch.tolist(), "normal": [0, 0, 1],
             "brushDepth": 0.5, "brushPressure": 0.08,
             "attenuationDistance": 0.1, "hsv": [0.1, 0.2, -0.1]}
    return {
        "bbox": {"type": "bbox", "raw": shell, "transform": t.tolist(),
                 "scale": [1.2, 0.8, 1.0], "boundType": "both",
                 "hsv": [0.3, -0.1, 0.05]},
        "bbox_to_mapsource": {
            "type": "bbox", "raw": shell, "transform": t.tolist(),
            "scale": [1, 1, 1], "boundType": "to",
            "mapSource": [0.05, -0.6, 0.1], "rgb": [0.9, 0.2, 0.1],
            "rgbLightOffset": 0.05},
        "brush_line_linear": {**brush, "brushType": "line",
                              "attenuationMode": "linear"},
        "brush_line_dry": {**brush, "brushType": "line",
                           "attenuationMode": "dry"},
        "brush_curve_linear": {**brush, "brushType": "curve",
                               "attenuationMode": "linear"},
        "brush_curve_dry": {**brush, "brushType": "curve",
                            "attenuationMode": "dry"},
        "anchor": {"type": "anchor", "raw": patch.tolist(),
                   "translation": [0.05, 0.1, 0.3], "radius": 0.25,
                   "scale": [1.0, 1.1, 0.9]},
        "texture": {"type": "bbox", "raw": shell, "transform": t.tolist(),
                    "scale": [1, 1, 1], "boundType": "from",
                    "imageConfig": _texture(tmp_path),
                    "rgbLightOffset": -0.05},
    }


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    return _configs(tmp_path_factory.mktemp("seal_cfg"))


def _samples(mapper_j, n=6000, seed=7):
    """Uniform points of the box and points near the edit, with unit
    directions, away from the faces of the edit mesh."""
    rng = np.random.default_rng(seed)
    b = np.asarray(mapper_j.map_data["force_fill_bound"]).reshape(-1, 2, 3)
    lo, hi = b[:, 0].min(0) - 0.1, b[:, 1].max(0) + 0.1
    pts = np.concatenate([rng.uniform(-1, 1, (n // 3, 3)),
                          rng.uniform(lo, hi, (n - n // 3, 3))])
    pts = pts.astype(np.float32)
    pts = pts[_away_from(pts, np.asarray(mapper_j.map_triangles))]
    d = rng.normal(size=pts.shape).astype(np.float32)
    return pts, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("kind", ["bbox", "bbox_to_mapsource",
                                  "brush_line_linear", "brush_line_dry",
                                  "brush_curve_linear", "brush_curve_dry",
                                  "anchor", "texture"])
def test_mapper_matches(kind, configs, tmp_path):
    cfg = configs[kind]
    mj = jseal.get_seal_mapper(str(tmp_path / "j"), cfg)
    mt = tseal.get_seal_mapper(str(tmp_path / "t"), cfg)
    for k, v in mj.map_data.items():
        if isinstance(v, (str, bool, float)):
            assert mt.map_data[k] == v, k
        else:
            np.testing.assert_allclose(_n(mt.map_data[k]), np.asarray(v),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    # a curve brush's mesh is built on points projected in f32 by each
    # package's own sums
    np.testing.assert_allclose(_n(mt.map_triangles),
                               np.asarray(mj.map_triangles), rtol=0,
                               atol=1e-7)
    pts, dirs = _samples(mj)
    mask_j = np.asarray(mj.map_mask(jnp.asarray(pts)))
    mask_t = mt.map_mask(_t(pts)).numpy()
    np.testing.assert_array_equal(mask_t, mask_j)
    if kind != "anchor":
        assert mask_j.sum() > 50

    xj, dj, mj_ = mj.map_to_origin(jnp.asarray(pts), jnp.asarray(dirs))
    xt, dt, mt_ = mt.map_to_origin(_t(pts), _t(dirs))
    np.testing.assert_array_equal(mt_.numpy(), np.asarray(mj_))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
    if kind.startswith("brush") and kind.endswith("linear"):
        assert np.abs(xt.numpy() - pts).max() > 1e-2
    if kind == "anchor":
        assert np.asarray(mj_).sum() > 20

    # the chunked evaluation on the support equals the full batch
    mt._chunk = lambda: 97
    xc, dc, mc = mt.map_to_origin_compact(_t(pts), _t(dirs))
    torch.testing.assert_close(xc, xt, rtol=0, atol=0)
    torch.testing.assert_close(dc, dt, rtol=0, atol=0)
    torch.testing.assert_close(mc, mt_, rtol=0, atol=0)
    # a planar [3, N] batch through its transposed view keeps its layout
    x3 = _t(pts.T)
    xp, _, mp = mt.map_to_origin_compact(x3.t(), None)
    assert xp.t().is_contiguous()
    torch.testing.assert_close(xp, xt, rtol=0, atol=0)

    cols = np.random.default_rng(8).random(pts.shape).astype(np.float32)
    ref = np.asarray(mj.map_color(xj, dj, jnp.asarray(cols)))
    got = mt.map_color(xt, dt, _t(cols)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    # a subset recoloured with the whole batch's means is the batch's
    sub = mt_.nonzero()[:, 0]
    v_means = mt.color_means(xt, _t(cols), chunk=101)
    part = mt.map_color(xt[sub], dt[sub], _t(cols)[sub], v_means).numpy()
    np.testing.assert_allclose(part, ref[sub.numpy()], **TOL)
    if kind == "texture":
        assert set(v_means) == {"image"}
        assert np.abs(got - cols).max() > 0.1


@pytest.mark.parametrize("time_size", [0, 4])
def test_force_fill_mask_matches(configs, tmp_path, time_size):
    for kind in ("bbox", "brush_curve_linear", "anchor"):
        mj = jseal.get_seal_mapper("", configs[kind])
        mt = tseal.get_seal_mapper("", configs[kind])
        ref = np.asarray(jax_fill(mj, 32, 1, 1.0, time_size=time_size))
        got = torch_fill(mt, 32, 1, 1.0, time_size=time_size).numpy()
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        assert 0 < ref.mean() < 1


def test_brush_mode_refused(configs):
    cfg = {**configs["brush_line_linear"], "attenuationMode": "ease-in"}
    mt = tseal.get_seal_mapper("", cfg)
    with pytest.raises(NotImplementedError):
        mt.map_to_origin(_t(np.zeros((4, 3))), None)
    with pytest.raises(NotImplementedError):
        tseal.get_seal_mapper("", {"type": "lasso"})


def test_config_reader_matches_json5(tmp_path, configs):
    text = """// a seal config, as the editing tools write it
{
  "type": "bbox", /* the box of the raw points */
  "raw": [[0.1, 0.2, 0.3], [0.4, 0.5, 0.6], [-0.1, 0.0, 0.2],],
  "transform": [[1, 0, 0, 0], [0, 1, 0, 0.3], [0, 0, 1, 0],
                [0, 0, 0, 1],],  // moved up
  "note": "a // in a string, /* and this */, and a trailing ,]",
  "hsv": [0.5, 0, 0,],
}
"""
    path = tmp_path / "seal.json"
    path.write_text(text)
    with open(path) as f:
        ref = json5.load(f)
    assert tseal.load_config(str(path)) == ref
    path.write_text(json.dumps(configs["bbox"]))
    assert tseal.load_config(str(path)) == configs["bbox"]
