"""The port's hash/tiled grid encoding and its Instant-NGP and D-NeRF fields
against the JAX package (ops/grid_encode.py, models/ngp.py,
models/dnerf.py, models/api.py).

Narrow configs (4 levels, log2_hashmap_size 12, as
tests/test_models_render.py), seeded numpy inputs, weights carried across
with params_from_jax. Tolerances:
- the table sizes, offsets and resolutions, and the hash and tiled indices
  (also at the full default widths): equal;
- grid_encode at 2, 3 and 5 dims, linear and smoothstep, the table's
  gradient against the reference's custom VJP (its scatter-add) and the
  inputs' gradient: 1e-4 relative to the largest entry (f32 sums in other
  orders; measured up to 2.1e-5);
- grid_tv_loss and its gradient: rtol 1e-5;
- the fields (NGP with and without the background, D-NeRF deform, basis
  and hyper at t = 0 and t = 0.37): the same bf16 rounding points, f32
  sums in other orders: sigma rtol 2e-2 with atol 1e-3, rgb and deform
  atol 2e-3 (the bare CP field's tolerance against the reference's XLA
  model);
- the parameter trees: the same names and shapes as the reference's init
  at the default widths, and equal after a round trip through numpy.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.models import dnerf as jd
from sealdnerf_tpu.models import ngp as jn
from sealdnerf_tpu.models.api import make_dnerf_field as jax_dnerf_field
from sealdnerf_tpu.models.api import make_ngp_field as jax_ngp_field
from sealdnerf_tpu_torch.models import dnerf as td
from sealdnerf_tpu_torch.models import ngp as tn
from sealdnerf_tpu_torch.models.api import make_dnerf_field, make_ngp_field
from sealdnerf_tpu_torch.models.params import (param_leaves, params_from_jax,
                                               params_to_numpy)

jg = importlib.import_module("sealdnerf_tpu.ops.grid_encode")
tg = importlib.import_module("sealdnerf_tpu_torch.ops.grid_encode")

NARROW = dict(num_levels=4, log2_hashmap_size=12)
SIGMA_TOL = dict(rtol=2e-2, atol=1e-3)
RGB_TOL = dict(rtol=0, atol=2e-3)
ENCODINGS = {
    "3d_hash": dict(input_dim=3),
    "3d_tiled": dict(input_dim=3, gridtype="tiled"),
    "5d_tiled": dict(input_dim=5, gridtype="tiled"),
    "2d_smoothstep": dict(input_dim=2, interpolation="smoothstep"),
    "5d_hash": dict(input_dim=5),
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; a torch pool of
    every core in each makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _enc_cfgs(**kw):
    kw = {**NARROW, "desired_resolution": 512, **kw}
    return jg.GridEncodeConfig(**kw), tg.GridEncodeConfig(**kw)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("name", sorted(ENCODINGS))
def test_grid_indices_equal(name, full):
    kw = dict(ENCODINGS[name])
    if full:
        # the default widths at bound 4: the finest levels' linear index
        # passes 2^31 on the tiled grids
        kw.update(num_levels=16, log2_hashmap_size=19,
                  desired_resolution=8192)
        jc, tc = jg.GridEncodeConfig(**kw), tg.GridEncodeConfig(**kw)
    else:
        jc, tc = _enc_cfgs(**kw)
    assert (jc.offsets, jc.resolutions) == (tc.offsets, tc.resolutions)
    assert jc.per_level_scale == tc.per_level_scale
    rng = np.random.default_rng(0)
    corners = np.array([[(i >> d) & 1 for d in range(jc.input_dim)]
                        for i in range(1 << jc.input_dim)])
    for lvl in range(jc.num_levels):
        cp = rng.integers(0, jc.resolutions[lvl] + 1, (2000, jc.input_dim))
        ref = jg._grid_index(jnp.asarray(cp, jnp.int32), jc, lvl)
        got = tg._grid_index(_t(cp), tc, lvl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        # the encoder's corner indices, from per-dim terms of the cells
        ref = jg._grid_index(jnp.asarray(cp[:, None] + corners, jnp.int32),
                             jc, lvl)
        got = tg._corner_index(_t(cp), tc, lvl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", sorted(ENCODINGS))
def test_grid_encode_matches(name):
    jc, tc = _enc_cfgs(**ENCODINGS[name])
    rng = np.random.default_rng(1)
    table = rng.uniform(-1, 1, (jc.table_size, 2)).astype(np.float32)
    # some points outside [0, 1], which encode to zeros
    x = rng.uniform(-0.05, 1.05, (3000, jc.input_dim)).astype(np.float32)
    g = rng.normal(size=(3000, jc.output_dim)).astype(np.float32)
    ref, vjp = jax.vjp(lambda xx, tb: jg.grid_encode(xx, tb, jc),
                       jnp.asarray(x), jnp.asarray(table))
    dx_j, dt_j = vjp(jnp.asarray(g))
    xt, tt = _t(x).requires_grad_(True), _t(table).requires_grad_(True)
    got = tg.grid_encode(xt, tt, tc, chunk=1000)
    (got * _t(g)).sum().backward()
    oob = ((x < 0) | (x > 1)).any(-1)
    assert 0 < oob.sum() < len(x) and not got[oob].any()
    for a, b in ((got.detach(), ref), (tt.grad, dt_j), (xt.grad, dx_j)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()


@pytest.mark.parametrize("name", ["3d_hash", "2d_smoothstep"])
def test_grid_tv_loss_matches(name):
    jc, tc = _enc_cfgs(**ENCODINGS[name])
    rng = np.random.default_rng(2)
    table = rng.uniform(-1, 1, (jc.table_size, 2)).astype(np.float32)
    x = rng.uniform(0, 1, (500, jc.input_dim)).astype(np.float32)
    ref, g_j = jax.value_and_grad(lambda tb: jg.grid_tv_loss(
        tb, jc, jnp.asarray(x)))(jnp.asarray(table))
    tt = _t(table).requires_grad_(True)
    got = tg.grid_tv_loss(tt, tc, _t(x))
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-9)


def _pts(n, bound, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-bound, bound, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=1, keepdims=True)


def _carry(jparams, tfield):
    """The reference's params, tables scaled to U(-1, 1), in both."""
    params = {k: (np.asarray(v) * 1e4 if "grid" in k else
                  jax.tree_util.tree_map(np.asarray, v))
              for k, v in jparams.items()}
    tfield.params = params_from_jax(params)
    return jax.tree_util.tree_map(jnp.asarray, params)


@pytest.mark.parametrize("bg", [False, True])
def test_ngp_field_matches(bg):
    kw = dict(bound=2.0, bg_radius=4.0 if bg else -1.0, **NARROW)
    jf = jax_ngp_field(jax.random.PRNGKey(1), jn.NGPConfig(**kw))
    tf = make_ngp_field(torch.Generator().manual_seed(1), tn.NGPConfig(**kw))
    jp = _carry(jf.params, tf)
    x, d = _pts(4000, 2.0, 3)
    s_j, c_j = jf.forward(jp, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        s_t, c_t = tf.forward(tf.params, _t(x), _t(d))
        d_t = tf.density(tf.params, _t(x))[0]
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **SIGMA_TOL)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(s_j), **SIGMA_TOL)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **RGB_TOL)
    assert np.asarray(s_j).std() > 0.05 * np.asarray(s_j).mean()
    if bg:
        sph = np.random.default_rng(4).uniform(-1, 1, (4000, 2)).astype(
            np.float32)
        b_j = jf.background(jp, jnp.asarray(sph), jnp.asarray(d))
        with torch.no_grad():
            b_t = tf.background(tf.params, _t(sph), _t(d))
        np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), **RGB_TOL)
    tv_j = jf.tv_loss(jp, jnp.asarray(x[:500] * 0.25 + 0.5))
    tv_t = tf.tv_loss(tf.params, _t(x[:500] * 0.25 + 0.5))
    np.testing.assert_allclose(float(tv_t), float(tv_j), rtol=1e-5)


@pytest.mark.parametrize("variant", ["deform", "basis", "hyper"])
def test_dnerf_field_matches(variant):
    kw = dict(bound=2.0, variant=variant, num_layers_deform=3,
              hidden_dim_deform=32, **NARROW)
    jf = jax_dnerf_field(jax.random.PRNGKey(2), jd.DNeRFConfig(**kw))
    tf = make_dnerf_field(torch.Generator().manual_seed(2),
                          td.DNeRFConfig(**kw))
    jp = _carry(jf.params, tf)
    x, d = _pts(3000, 2.0, 5)
    for t in (0.0, 0.37):
        s_j, c_j, df_j = jf.forward(jp, jnp.asarray(x), jnp.asarray(d),
                                    jnp.float32(t))
        with torch.no_grad():
            s_t, c_t, df_t = tf.forward(tf.params, _t(x), _t(d), t)
            d_t = tf.density(tf.params, _t(x), t)[0]
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **SIGMA_TOL)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(s_j), **SIGMA_TOL)
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), **RGB_TOL)
        np.testing.assert_allclose(df_t.numpy(), np.asarray(df_j), **RGB_TOL)
        if variant == "deform":
            assert (np.abs(df_t.numpy()).max() > 1e-3) == (t > 0)


@pytest.mark.parametrize("case", ["ngp", "ngp_bg", "deform", "basis",
                                  "hyper"])
def test_param_trees_match_the_reference_init(case):
    """The default widths: the names and shapes of the reference's init,
    and a round trip through numpy."""
    if case.startswith("ngp"):
        kw = dict(bound=2.0, bg_radius=4.0 if case == "ngp_bg" else -1.0)
        ref = jax.eval_shape(lambda: jn.init_ngp(jax.random.PRNGKey(0),
                                                 jn.NGPConfig(**kw)))
        got = tn.init_ngp(torch.Generator().manual_seed(0),
                          tn.NGPConfig(**kw))
        grid = got["grid"]
        assert grid.shape == (tn.NGPConfig(**kw).grid_cfg.table_size, 2)
        assert float(grid.abs().max()) <= 1e-4
    else:
        kw = dict(bound=2.0, variant=case)
        ref = jax.eval_shape(lambda: jd.init_dnerf(jax.random.PRNGKey(0),
                                                   jd.DNeRFConfig(**kw)))
        got = td.init_dnerf(torch.Generator().manual_seed(0),
                            td.DNeRFConfig(**kw))
    assert sorted(got) == sorted(ref)
    assert [tuple(t.shape) for t in param_leaves(got)] == \
        [tuple(s.shape) for s in jax.tree_util.tree_leaves(ref)]
    back = params_from_jax(params_to_numpy(got))
    for a, b in zip(param_leaves(back), param_leaves(got)):
        assert torch.equal(a, b)
