"""The port's TensoRF field and CCNeRF composition (models/tensorf.py,
models/api.make_tensorf_field, check_params) against the JAX package.

Narrow configs (resolution 32, ranks 4 / 8), seeded numpy inputs with
points on and beyond the box's faces (where the clip to [0, 1] matters),
weights carried across with params_from_jax. Tolerances:
- sigma (f32 taps and sums, no tower): rtol 1e-5, atol 1e-6;
- rgb (the bf16 basis matrix and colour tower, f32 sums in other orders):
  atol 2e-3, the tolerance of the NGP fields (tests/test_torch_ngp.py);
- the gradient of sum(sigma): every density factor within 1e-4 of its
  largest entry (f32); the gradient of a random projection of rgb: every
  leaf within 2e-2 in relative L2 norm (its cotangent crosses the bf16
  roundings of the towers in both packages);
- upsample_tensorf against jax.image.resize "linear" at 16 -> 32 and at
  128 -> 152 (the default schedule's first step), planes and lines: atol
  1e-6;
- tensorf_l1_reg: rtol 1e-6;
- tensorf_forward_trunc at 0.25, 0.5 and 1.0 and cc_compose_forward (with
  and without main_CCNeRF's world-to-model transforms): the forward's
  tolerances.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.models import tensorf as jt
from sealdnerf_tpu_torch.models import tensorf as tt
from sealdnerf_tpu_torch.models.api import check_params, make_tensorf_field
from sealdnerf_tpu_torch.models.params import (param_leaves, params_from_jax,
                                               params_to_numpy)

SIGMA_TOL = dict(rtol=1e-5, atol=1e-6)
RGB_TOL = dict(rtol=0, atol=2e-3)
CONFIGS = {
    "vm": dict(decomposition="vm", sigma_rank=(4, 4, 4),
               color_rank=(8, 8, 8)),
    "cp": dict(decomposition="cp", sigma_rank=(8,), color_rank=(8,)),
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(kind, bound=1.0, res=32):
    kw = dict(bound=bound, resolution=res, **CONFIGS[kind])
    return jt.TensoRFConfig(**kw), tt.TensoRFConfig(**kw)


def _params(jcfg, seed=0):
    jp = jt.init_tensorf(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def _inputs(n=300, bound=1.0, seed=0):
    """Random points, then points on the faces and corners of the box and
    beyond it; random unit directions."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-bound, bound, (n, 3))
    faces = rng.uniform(-bound, bound, (24, 3))
    faces[np.arange(24), np.arange(24) % 3] = np.where(
        np.arange(24) % 2 == 0, bound, -bound)
    beyond = rng.uniform(-1.1 * bound, 1.1 * bound, (16, 3))
    corners = np.array(np.meshgrid(*[[-bound, bound]] * 3)).reshape(3, -1).T
    x = np.concatenate([x, faces, beyond, corners]).astype(np.float32)
    d = rng.normal(size=x.shape)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return x, d


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_forward_and_density(kind):
    jcfg, tcfg = _cfgs(kind, bound=2.0)
    jp, tp = _params(jcfg)
    x, d = _inputs(bound=2.0)
    s_j, rgb_j = jt.tensorf_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(d))
    s_t, rgb_t = tt.tensorf_forward(tp, tcfg, _t(x), _t(d))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **SIGMA_TOL)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), **RGB_TOL)
    assert float(s_t.min()) >= 0 and (np.asarray(s_j) > 0).mean() > 0.3
    sd_j, f_j = jt.tensorf_density(jp, jcfg, jnp.asarray(x))
    sd_t, f_t = tt.tensorf_density(tp, tcfg, _t(x))
    np.testing.assert_allclose(sd_t.numpy(), np.asarray(sd_j), **SIGMA_TOL)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=2e-2,
                               atol=2e-3)
    # the field's functions are the model's
    field = make_tensorf_field(torch.Generator().manual_seed(0), tcfg)
    s_f, rgb_f = field.forward(tp, _t(x), _t(d))
    assert torch.equal(s_f, s_t) and torch.equal(rgb_f, rgb_t)
    assert torch.equal(field.density(tp, _t(x))[0], sd_t)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_gradients(kind):
    jcfg, tcfg = _cfgs(kind)
    jp, tp = _params(jcfg, seed=1)
    x, d = _inputs(seed=1)
    w = np.random.default_rng(2).normal(size=(x.shape[0], 3)).astype(
        np.float32)
    # sum(sigma): f32 all the way to the density factors
    g_j = jax.grad(lambda p: jnp.sum(jt.tensorf_forward(
        p, jcfg, jnp.asarray(x), jnp.asarray(d))[0]))(jp)
    leaves = [t.requires_grad_(True) for t in param_leaves(tp)]
    tt.tensorf_forward(tp, tcfg, _t(x), _t(d))[0].sum().backward()
    sigma_keys = [k for k in sorted(tp) for _ in param_leaves(tp[k])]
    for k, p, g in zip(sigma_keys, leaves, jax.tree_util.tree_leaves(g_j)):
        g = np.asarray(g)
        if k.startswith("sigma"):
            scale = np.abs(g).max()
            assert scale > 0, k
            np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                       atol=1e-4 * scale, err_msg=k)
        else:
            assert p.grad is None or not p.grad.any(), k
            assert not np.any(g), k
    # a projection of rgb: through the bf16 towers
    g_j = jax.grad(lambda p: jnp.sum(jt.tensorf_forward(
        p, jcfg, jnp.asarray(x), jnp.asarray(d))[1] * w))(jp)
    for p in leaves:
        p.grad = None
    (tt.tensorf_forward(tp, tcfg, _t(x), _t(d))[1] * _t(w)).sum().backward()
    for k, p, g in zip(sigma_keys, leaves, jax.tree_util.tree_leaves(g_j)):
        g = np.asarray(g)
        if k.startswith("sigma"):
            continue
        err = np.linalg.norm(p.grad.numpy() - g) / np.linalg.norm(g)
        assert err <= 2e-2, (k, err)


@pytest.mark.parametrize("sizes", [(16, 32), (128, 152)])
def test_upsample_matches_jax_resize(sizes):
    r0, r1 = sizes
    jcfg, tcfg = _cfgs("vm", res=r0)
    jp, tp = _params(jcfg, seed=3)
    jp2, jcfg2 = jt.upsample_tensorf(jp, jcfg, r1)
    tp2, tcfg2 = tt.upsample_tensorf(tp, tcfg, r1)
    assert tcfg2.resolution == jcfg2.resolution == r1
    for name in ("sigma_planes", "sigma_lines", "app_planes", "app_lines"):
        for a, b in zip(tp2[name], jp2[name]):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6, err_msg=name)
    # the towers are carried over untouched
    for name in ("basis_grid", "color_mlp"):
        for a, b in zip(param_leaves(tp2[name]), param_leaves(tp[name])):
            assert a is b
    # CP: lines only
    jcfg, tcfg = _cfgs("cp", res=r0)
    jp, tp = _params(jcfg, seed=4)
    jp2, _ = jt.upsample_tensorf(jp, jcfg, r1)
    tp2, _ = tt.upsample_tensorf(tp, tcfg, r1)
    assert "sigma_planes" not in tp2
    for a, b in zip(param_leaves(tp2), jax.tree_util.tree_leaves(jp2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_l1_reg_and_params():
    for kind in sorted(CONFIGS):
        jcfg, tcfg = _cfgs(kind)
        jp, tp = _params(jcfg, seed=5)
        np.testing.assert_allclose(float(tt.tensorf_l1_reg(tp)),
                                   float(jt.tensorf_l1_reg(jp)), rtol=1e-6)
        # the seeded init has the reference's names and shapes, and the
        # trees round-trip through numpy
        own = tt.init_tensorf(torch.Generator().manual_seed(0), tcfg)
        assert sorted(own) == sorted(jp)
        assert [tuple(a.shape) for a in param_leaves(own)] == \
            [b.shape for b in jax.tree_util.tree_leaves(jp)]
        back = params_from_jax(params_to_numpy(tp))
        for a, b in zip(param_leaves(back), param_leaves(tp)):
            assert torch.equal(a, b)
    # the default widths
    jdef = jt.init_tensorf(jax.random.PRNGKey(0), jt.TensoRFConfig())
    tdef = tt.init_tensorf(torch.Generator().manual_seed(0),
                           tt.TensoRFConfig())
    assert [tuple(a.shape) for a in param_leaves(tdef)] == \
        [b.shape for b in jax.tree_util.tree_leaves(jdef)]


def test_check_params_takes_any_grid_resolution():
    """A checkpoint saved after an upsample (here 32 -> 48) fits a field
    built at resolution0; other ranks, mixed resolutions or a missing leaf
    do not."""
    _, tcfg = _cfgs("vm")
    field = make_tensorf_field(torch.Generator().manual_seed(0), tcfg)
    up, _ = tt.upsample_tensorf(field.params, tcfg, 48)
    check_params(up, field)
    mixed = dict(up, sigma_lines=field.params["sigma_lines"])
    with pytest.raises(ValueError):
        check_params(mixed, field)
    _, other = _cfgs("vm")
    other = tt.TensoRFConfig(sigma_rank=(4, 4, 5), color_rank=(8, 8, 8),
                             resolution=32)
    with pytest.raises(ValueError):
        check_params(tt.init_tensorf(torch.Generator(), other), field)
    with pytest.raises(ValueError):
        check_params({k: v for k, v in up.items() if k != "basis_grid"},
                     field)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_forward_trunc(kind):
    jcfg, tcfg = _cfgs(kind)
    jp, tp = _params(jcfg, seed=6)
    x, d = _inputs(seed=6)
    field = make_tensorf_field(torch.Generator().manual_seed(0), tcfg)
    full = tt.tensorf_forward(tp, tcfg, _t(x), _t(d))
    for frac in (0.25, 0.5, 1.0):
        s_j, rgb_j = jt.tensorf_forward_trunc(jp, jcfg, jnp.asarray(x),
                                              jnp.asarray(d), frac)
        s_t, rgb_t = field.forward_trunc(tp, _t(x), _t(d), frac)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **SIGMA_TOL)
        np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j),
                                   **RGB_TOL)
        if frac == 1.0:
            assert torch.equal(s_t, full[0]) and torch.equal(rgb_t, full[1])
        else:
            assert not torch.allclose(s_t, full[0])
    # the masks: a prefix of each VM axis (not of the concatenation)
    m = tt._trunc_mask(0.25, (4, 4, 4))
    assert m.tolist() == [1, 0, 0, 0] * 3


def test_cc_compose_matches_jax():
    """cc_compose_forward over two CP fields, without transforms (sigma
    adds) and with main_CCNeRF's default arrangement (scale 0.6, a circle
    of radius 0.5)."""
    import main_CCNeRF
    from sealdnerf_tpu_torch import main_CCNeRF as port_cc
    jcfg, tcfg = _cfgs("cp")
    j1, t1 = _params(jcfg, seed=7)
    j2, t2 = _params(jcfg, seed=8)
    jf = jt.make_tensorf_field(jax.random.PRNGKey(0), jcfg)
    tf = make_tensorf_field(torch.Generator().manual_seed(0), tcfg)
    x, d = _inputs(seed=9)
    for transforms in (None, "circle"):
        jtr = ttr = None
        if transforms:
            jtr, ttr = [], []
            for i in range(2):
                angle = 2 * np.pi * i / 2
                pos = [0.5 * np.cos(angle), 0, 0.5 * np.sin(angle)]
                jtr.append(main_CCNeRF._transform(0.6, pos))
                ttr.append(port_cc.world_to_model(0.6, pos))
                np.testing.assert_allclose(ttr[-1].numpy(),
                                           np.asarray(jtr[-1]), rtol=1e-6)
        s_j, rgb_j = jt.cc_compose_forward([jf, jf], jtr)(
            [j1, j2], jnp.asarray(x), jnp.asarray(d))
        s_t, rgb_t = tt.cc_compose_forward([tf, tf], ttr)(
            [t1, t2], _t(x), _t(d))
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), **SIGMA_TOL)
        np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j),
                                   **RGB_TOL)
        if transforms is None:
            s1 = tf.forward(t1, _t(x), _t(d))[0]
            s2 = tf.forward(t2, _t(x), _t(d))[0]
            np.testing.assert_allclose(s_t.numpy(), (s1 + s2).numpy(),
                                       rtol=1e-6)
