"""Parity of the port's dense march and renderers with the JAX package:
downsample_occ, dilate_occ, march_intervals, expand_intervals, march_dense,
render_dense and render_image_tiled on the same occupancy and rays.
Masks and counts must be exactly equal, sample positions within 1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.ops import marching_dense as jmd
from sealdnerf_tpu.ops.ray import near_far_from_aabb as jax_near_far
from sealdnerf_tpu.render.fast import render_dense as jax_render_dense
from sealdnerf_tpu.render.fast_image import (
    render_image_tiled as jax_render_tiled)
from sealdnerf_tpu_torch.ops import marching_dense as tmd
from sealdnerf_tpu_torch.render.fast import render_dense
from sealdnerf_tpu_torch.render.fast_image import render_image_tiled

TS_TOL = dict(rtol=0, atol=1e-6)
AABB = np.array([-1, -1, -1, 1, 1, 1], np.float32)


def _occ(rng, res):
    g = np.linspace(-1, 1, res)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    ball = (x ** 2 + y ** 2 + z ** 2) < 0.5 ** 2
    return ball | (rng.uniform(size=ball.shape) < 0.05)


def _rays(rng, n):
    o = rng.uniform(-1.8, 1.8, (n, 3)).astype(np.float32)
    o[:, 2] = -2.0
    tgt = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    d = tgt - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _near_far(o, d, min_near):
    n, f = jax_near_far(jnp.asarray(o), jnp.asarray(d), jnp.asarray(AABB),
                        min_near)
    return np.asarray(n), np.asarray(f)


def test_downsample_and_dilate(rng):
    occ = _occ(rng, 32)
    np.testing.assert_array_equal(
        tmd.downsample_occ(_t(occ), 16).numpy(),
        np.asarray(jmd.downsample_occ(jnp.asarray(occ), 16)))
    sparse = rng.uniform(size=(16, 16, 16)) < 0.02
    for r in (1, 2):
        np.testing.assert_array_equal(
            tmd.dilate_occ(_t(sparse), r).numpy(),
            np.asarray(jmd.dilate_occ(jnp.asarray(sparse), r)))


@pytest.mark.parametrize("sc", [4, 16])
def test_march_intervals_and_expand(rng, sc):
    cfg_j = jmd.DenseMarchConfig(bound=1.0, march_res=32, n_intervals=sc,
                                 steps_per_interval=3)
    cfg_t = tmd.DenseMarchConfig(bound=1.0, march_res=32, n_intervals=sc,
                                 steps_per_interval=3)
    occ = _occ(rng, 32)
    o, d = _rays(rng, 300)
    nears, fars = _near_far(o, d, cfg_j.min_near)
    te0, iv0 = jmd.march_intervals(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(nears), jnp.asarray(fars),
                                   jnp.asarray(occ), cfg_j)
    te1, iv1 = tmd.march_intervals(_t(o), _t(d), _t(nears), _t(fars),
                                   _t(occ), cfg_t)
    np.testing.assert_array_equal(iv1.numpy(), np.asarray(iv0))
    np.testing.assert_allclose(te1.numpy(), np.asarray(te0), **TS_TOL)
    assert int(iv1.sum()) > 0

    noise = rng.uniform(size=300).astype(np.float32)
    e0 = jmd.expand_intervals(te0, iv0, jnp.asarray(fars), cfg_j,
                              noise=jnp.asarray(noise))
    e1 = tmd.expand_intervals(te1, iv1, _t(fars), cfg_t, noise=_t(noise))
    np.testing.assert_array_equal(e1["valid"].numpy(), np.asarray(e0["valid"]))
    np.testing.assert_array_equal(e1["counts"].numpy(),
                                  np.asarray(e0["counts"]))
    np.testing.assert_allclose(e1["ts"].numpy(), np.asarray(e0["ts"]),
                               **TS_TOL)
    np.testing.assert_allclose(e1["dts"].numpy(), np.asarray(e0["dts"]),
                               **TS_TOL)


def test_march_dense(rng):
    cfg_j = jmd.DenseMarchConfig(bound=1.0, march_res=16, n_intervals=8,
                                 steps_per_interval=4)
    cfg_t = tmd.DenseMarchConfig(bound=1.0, march_res=16, n_intervals=8,
                                 steps_per_interval=4)
    occ = _occ(rng, 16)
    o, d = _rays(rng, 200)
    nears, fars = _near_far(o, d, cfg_j.min_near)
    r0 = jmd.march_dense(jnp.asarray(o), jnp.asarray(d), jnp.asarray(nears),
                         jnp.asarray(fars), jnp.asarray(occ), cfg_j)
    r1 = tmd.march_dense(_t(o), _t(d), _t(nears), _t(fars), _t(occ), cfg_t)
    for k in ("valid", "counts"):
        np.testing.assert_array_equal(r1[k].numpy(), np.asarray(r0[k]))
    np.testing.assert_allclose(r1["ts"].numpy(), np.asarray(r0["ts"]),
                               **TS_TOL)


def test_render_dense(rng):
    cfg_j = jmd.DenseMarchConfig(bound=1.0, march_res=32, n_intervals=16,
                                 steps_per_interval=4)
    cfg_t = tmd.DenseMarchConfig(bound=1.0, march_res=32, n_intervals=16,
                                 steps_per_interval=4)
    occ = _occ(rng, 32)
    o, d = _rays(rng, 128)

    def fwd_j(params, x, d_):
        r = jnp.linalg.norm(x, axis=-1)
        return jnp.where(r < 0.5, 40.0, 0.5), jnp.clip(x * 0.5 + 0.5, 0, 1)

    def fwd_t(params, x, d_):
        r = torch.linalg.vector_norm(x, dim=-1)
        return torch.where(r < 0.5, 40.0, 0.5), (x * 0.5 + 0.5).clamp(0, 1)

    bg = np.array([0.2, 0.3, 0.4], np.float32)
    ref = jax_render_dense(None, jnp.asarray(occ), jnp.asarray(o),
                           jnp.asarray(d), cfg_j, fwd_j,
                           bg_color=jnp.asarray(bg))
    got = render_dense(None, _t(occ), _t(o), _t(d), cfg_t, fwd_t,
                       bg_color=_t(bg))
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-5)
    assert int(got["n_samples"]) == int(ref["n_samples"])


@pytest.mark.parametrize("tile_px", [1, 8])
def test_render_image_tiled(rng, tile_px):
    """Whole-frame tiled render with an analytic planar field."""
    cfg_j = jmd.DenseMarchConfig(bound=1.0, march_res=32, n_intervals=16,
                                 steps_per_interval=4)
    cfg_t = tmd.DenseMarchConfig(bound=1.0, march_res=32, n_intervals=16,
                                 steps_per_interval=4)
    occ = _occ(rng, 32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, -0.05, -2.0]
    intr = np.array([30.0, 30.0, 16.0, 16.0], np.float32)

    def fwd_j(params, x3, d3):
        r = jnp.sqrt(jnp.sum(x3 * x3, axis=0))
        return jnp.concatenate([jnp.where(r < 0.5, 60.0, 0.2)[None],
                                jnp.clip(0.5 + 0.5 * x3, 0, 1)], axis=0)

    def fwd_t(params, x3, d3):
        r = torch.sqrt((x3 * x3).sum(dim=0))
        return torch.cat([torch.where(r < 0.5, 60.0, 0.2)[None],
                          (0.5 + 0.5 * x3).clamp(0, 1)], dim=0)

    bg = np.ones(3, np.float32)
    img0, dep0 = jax_render_tiled(None, jnp.asarray(occ), jnp.asarray(pose),
                                  jnp.asarray(intr), 32, 32, cfg_j, fwd_j,
                                  jnp.asarray(bg), tile_px=tile_px,
                                  planar=True)
    img1, dep1 = render_image_tiled(None, _t(occ), _t(pose), _t(intr), 32, 32,
                                    cfg_t, fwd_t, _t(bg), tile_px=tile_px)
    assert img1.shape == (32, 32, 3) and dep1.shape == (32, 32)
    np.testing.assert_allclose(img1.numpy(), np.asarray(img0), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(dep1.numpy(), np.asarray(dep0), rtol=1e-4,
                               atol=1e-5)
