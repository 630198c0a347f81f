"""Parity of the port's time-conditioned CP field with the JAX package.

`dyn_field_forward_plain` (the plain version of the dynamic field kernel,
sealdnerf_tpu_torch/ops/field.py) against the Pallas kernel
`cp_dnerf_forward_fused_planar` in interpret mode, and the port's XLA-style
model (`cp_dnerf_forward` and friends in models/cp.py) against the
reference's, values and gradients. Parameters come from the reference's
`init_cp_dnerf` through `params_from_jax`, at the small sizes of the
reference's own dynamic kernel test (scales (8,8),(16,16), 3 deform layers
of 32, multires_deform 4), once without and once with a small VM plane.

Tolerances:
- plain vs Pallas interpret: 2e-4 absolute on values of order 1. The two
  round at the same points, so nearly all samples agree to 1e-7; a sum taken
  in another order can flip one bf16 rounding of a hidden activation, which
  moves a sample by up to ~6e-5 (seen here).
- against the XLA model: the reference's own Pallas-vs-XLA tolerances, rtol
  2e-2 with atol 1e-3 (sigma) and 2e-3 (rgb): XLA rounds the frequency
  features and the 13 time inputs to bf16, the kernel keeps them in f32.
- port's XLA-style model vs the reference's: 1e-5 (same rounding points).
- gradients: 2e-2 of max |reference| per leaf: both packages round the
  cotangents to bf16 where the forward rounds, in products of another order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.models import cp as jcp
from sealdnerf_tpu.ops.pallas_field import cp_dnerf_forward_fused_planar
from sealdnerf_tpu_torch.models import cp as tcp
from sealdnerf_tpu_torch.ops.field import (dyn_field_forward,
                                           dyn_field_forward_plain,
                                           field_forward, pack_tables)

SMALL = dict(bound=1.0, scales=((8, 8), (16, 16)), num_layers_deform=3,
             hidden_dim_deform=32, multires_deform=4)
PLANE_CASES = {"cp": (), "vm": ((8, 2),)}
KERNEL_ATOL = 2e-4
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; a torch pool of
    every core in each makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(planes, undamp=1e3, **over):
    kw = dict(SMALL, planes=planes, **over)
    jc, tc = jcp.CPDNeRFConfig(**kw), tcp.CPDNeRFConfig(**kw)
    params = jcp.init_cp_dnerf(jax.random.PRNGKey(0), jc)
    # undo the 1e-3 damping of the last deform layer: the warp must matter
    params["deform_mlp"]["w"][-1] = params["deform_mlp"]["w"][-1] * undamp
    tp = tcp.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(0)
    m = 64 + 13                          # ragged against the 32-sample tile
    x = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    x[:3] = [[-1, -1, -1], [1, 1, 1], [0.98, -0.99, 0]]   # warped past the box
    d = rng.normal(size=(m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jc, tc, params, tp, x, d


@pytest.fixture(scope="module", params=list(PLANE_CASES))
def case(request):
    return _setup(PLANE_CASES[request.param])


def _planar(a):
    return torch.from_numpy(np.ascontiguousarray(a.T))


@pytest.mark.parametrize("lod_skip", [(), (1,)])
@pytest.mark.parametrize("t", [0.0, 0.37, 1.0])
def test_plain_matches_pallas_interpret(case, t, lod_skip):
    jc, tc, params, tp, x, d = case
    ref = np.asarray(cp_dnerf_forward_fused_planar(
        params, jc, jnp.asarray(x.T), jnp.asarray(d.T), t, tile=32,
        interpret=True, lod_skip=lod_skip))
    got = dyn_field_forward(tp, tc, _planar(x), _planar(d), t,
                            lod_skip=lod_skip).numpy()
    assert got.shape == (4, x.shape[0])
    np.testing.assert_allclose(got, ref[:4], rtol=0, atol=KERNEL_ATOL)
    assert not ref[4:].any()        # the rows the port does not carry
    dens = dyn_field_forward(tp, tc, _planar(x), None, t, lod_skip=lod_skip,
                             density_only=True).numpy()
    np.testing.assert_array_equal(dens[0], got[0])
    assert not dens[1:].any()


def test_plain_at_t0_is_the_static_field(case):
    _, tc, _, tp, x, d = case
    tables = pack_tables(tp, tc)
    out, dx = dyn_field_forward_plain(tables, tc, _planar(x), _planar(d), 0.0,
                                      return_deform=True)
    assert not dx.numpy().any()
    np.testing.assert_array_equal(
        out.numpy(), field_forward(tables, tc, _planar(x), _planar(d)).numpy())
    _, dx = dyn_field_forward_plain(tables, tc, _planar(x), _planar(d), 0.37,
                                    return_deform=True)
    assert np.abs(dx.numpy()).mean() > 1e-2   # the warp matters at t != 0


def test_time_from_a_tensor_equals_time_from_a_float(case):
    _, tc, _, tp, x, d = case
    a = dyn_field_forward(tp, tc, _planar(x), _planar(d), 0.37)
    b = dyn_field_forward(tp, tc, _planar(x), _planar(d),
                          torch.tensor([0.37]))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("t", [0.0, 0.37])
def test_plain_matches_xla_model(case, t):
    jc, tc, params, tp, x, d = case
    s0, r0, _ = jcp.cp_dnerf_forward(params, jc, jnp.asarray(x),
                                     jnp.asarray(d), t)
    got = dyn_field_forward(tp, tc, _planar(x), _planar(d), t).numpy()
    # samples warped out of the box: the kernel clips, the XLA model's hat
    # decays to zero there
    xw = x + np.asarray(jcp.cp_dnerf_deform(params, jc, jnp.asarray(x), t))
    inside = (np.abs(xw) <= 1.0).all(axis=-1)
    assert inside.sum() >= 60
    np.testing.assert_allclose(got[0][inside], np.asarray(s0)[inside],
                               rtol=2e-2, atol=1e-3)
    np.testing.assert_allclose(got[1:4].T[inside], np.asarray(r0)[inside],
                               rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("t", [0.0, 0.37, 1.0])
def test_model_matches_jax(case, t):
    jc, tc, params, tp, x, d = case
    xj, dj, xt, dt = jnp.asarray(x), jnp.asarray(d), torch.from_numpy(x), \
        torch.from_numpy(d)
    with torch.no_grad():
        raw = tcp.cp_dnerf_deform_raw(tp, tc, xt, t).numpy()
        dfm = tcp.cp_dnerf_deform(tp, tc, xt, t).numpy()
        sig, rgb, dfm2 = (a.numpy() for a in
                          tcp.cp_dnerf_forward(tp, tc, xt, dt, t))
        sig2, geo = (a.numpy() for a in tcp.cp_dnerf_density(tp, tc, xt, t))
    np.testing.assert_allclose(
        raw, np.asarray(jcp.cp_dnerf_deform_raw(params, jc, xj, t)),
        **MODEL_TOL)
    np.testing.assert_allclose(
        dfm, np.asarray(jcp.cp_dnerf_deform(params, jc, xj, t)), **MODEL_TOL)
    if t == 0.0:
        assert not dfm.any() and np.abs(raw).mean() > 1e-3
    s0, r0, d0 = jcp.cp_dnerf_forward(params, jc, xj, dj, t)
    np.testing.assert_allclose(sig, np.asarray(s0), **MODEL_TOL)
    np.testing.assert_allclose(rgb, np.asarray(r0), **MODEL_TOL)
    np.testing.assert_array_equal(dfm2, dfm)
    s1, g1 = jcp.cp_dnerf_density(params, jc, xj, t)
    np.testing.assert_allclose(sig2, np.asarray(s1), **MODEL_TOL)
    np.testing.assert_allclose(geo, np.asarray(g1), **MODEL_TOL)


def _grads(planes, cutoff):
    """Per-leaf gradients of sum(sigma) + sum(rgb) in both packages."""
    jc, tc, params, tp, x, d = _setup(planes, undamp=100.0,
                                      deform_grad_res_cutoff=cutoff)
    x = (x * 0.8).astype(np.float32)
    t = 0.61

    def loss_jax(p):
        sig, rgb, _ = jcp.cp_dnerf_forward(p, jc, jnp.asarray(x),
                                           jnp.asarray(d), t)
        return jnp.sum(sig) + jnp.sum(rgb)

    gj = jax.tree_util.tree_map(np.asarray, jax.grad(loss_jax)(params))
    tp = tcp.map_params(lambda a: a.requires_grad_(True), tp)
    sig, rgb, _ = tcp.cp_dnerf_forward(tp, tc, torch.from_numpy(x),
                                       torch.from_numpy(d), t)
    (sig.sum() + rgb.sum()).backward()
    gt = tcp.map_params(lambda a: a.grad.numpy(), tp)
    return gj, gt


@pytest.mark.parametrize("cutoff", [4, 8, 256])
@pytest.mark.parametrize("planes", list(PLANE_CASES))
def test_gradients_match_jax(planes, cutoff):
    gj, gt = _grads(PLANE_CASES[planes], cutoff)
    lj, lt = jax.tree_util.tree_leaves(gj), tcp.param_leaves(gt)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= GRAD_TOL * max(np.abs(a).max(), 1e-12)
    assert all(np.abs(w).max() > 0 for w in gt["deform_mlp"]["w"])


@pytest.mark.parametrize("planes", list(PLANE_CASES))
def test_fine_scales_do_not_drive_the_deform_tower(planes):
    """deform_grad_res_cutoff routes the warp's gradient. With the sigma
    tower's frequency rows zeroed, only the tables can carry d sigma / d
    deform: it is exactly zero with the cutoff below every scale, and comes
    from the scales and planes with res <= cutoff otherwise, as in the
    reference. The tables' own gradients do not depend on the routing."""
    grads = {}
    for cutoff in (4, 8, 256):
        jc, tc, params, tp, x, _ = _setup(
            PLANE_CASES[planes], deform_grad_res_cutoff=cutoff)
        n_grid = tc.grid_feat_dim
        params["sigma_mlp"]["w"][0] = \
            params["sigma_mlp"]["w"][0].at[n_grid:].set(0.0)
        tp["sigma_mlp"]["w"][0][n_grid:] = 0.0
        x = (x * 0.8).astype(np.float32)
        dfm = np.random.default_rng(1).uniform(
            -0.1, 0.1, x.shape).astype(np.float32)
        gj = np.asarray(jax.grad(lambda q: jnp.sum(jcp._warped_density(
            params, jc, jnp.asarray(x), q)[0]))(jnp.asarray(dfm)))
        q = torch.from_numpy(dfm).requires_grad_(True)
        lines = [[a.requires_grad_(True) for a in ax] for ax in tp["lines"]]
        tcp._warped_density({**tp, "lines": lines}, tc, torch.from_numpy(x),
                            q)[0].sum().backward()
        gt = q.grad.numpy()
        assert np.abs(gt - gj).max() <= GRAD_TOL * max(np.abs(gj).max(),
                                                       1e-12)
        grads[cutoff] = (gt, [a.grad.numpy() for ax in lines for a in ax])
    assert not grads[4][0].any()
    assert np.abs(grads[8][0]).max() > 0
    assert np.abs(grads[256][0] - grads[8][0]).max() > \
        1e-2 * np.abs(grads[256][0]).max()
    for a, b in zip(grads[4][1], grads[256][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dynamic", [False, True])
def test_flops_per_sample_equals_the_reference(dynamic):
    for kw in (dict(), dict(scales=((8, 8), (16, 16)), planes=((8, 2),))):
        if dynamic:
            a = tcp.flops_per_sample(tcp.CPDNeRFConfig(**kw))
            b = jcp.flops_per_sample(jcp.CPDNeRFConfig(**kw))
        else:
            a = tcp.flops_per_sample(tcp.CPConfig(**kw))
            b = jcp.flops_per_sample(jcp.CPConfig(**kw))
        assert a == b
    assert tcp.CPDNeRFConfig().deform_in_dim == 76 == \
        jcp.CPDNeRFConfig().deform_in_dim


def test_params_round_trip_with_deform_mlp(case):
    jc, tc, params, tp, _, _ = case
    assert [tuple(w.shape) for w in tp["deform_mlp"]["w"]] == \
        [(27 + 13, 32), (32, 32), (32, 3)]
    assert all(w.dtype == torch.float32 for w in tp["deform_mlp"]["w"])
    back = tcp.params_to_numpy(tp)
    ref = jax.tree_util.tree_map(np.asarray, params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    # the config comes back off the shapes, given the encodings' degrees
    base = tcp.CPDNeRFConfig(multires_deform=4)
    assert tcp.config_from_params(tp, base) == tc
    with pytest.raises(ValueError, match="deform_mlp takes 40 inputs"):
        tcp.config_from_params(tp, tcp.CPConfig())     # default degrees: 76
    static = {k: v for k, v in tp.items() if k != "deform_mlp"}
    with pytest.raises(ValueError, match="needs params with a deform_mlp"):
        tcp.config_from_params(static, base)
    assert type(tcp.config_from_params(static, tcp.CPConfig())) is \
        tcp.CPConfig


def test_default_checkpoint_gives_the_default_dynamic_config():
    cfg = tcp.CPDNeRFConfig(scales=((8, 4),), planes=())
    p = tcp.init_cp_dnerf(torch.Generator().manual_seed(0), cfg)
    assert tcp.config_from_params(p, tcp.CPConfig()) == cfg
    assert float(p["deform_mlp"]["w"][-1].abs().max()) <= 1e-3 / 128 ** 0.5
    q = tcp.make_cp_dnerf_field(torch.Generator().manual_seed(0), cfg)
    for a, b in zip(tcp.param_leaves(p), tcp.param_leaves(q.params)):
        assert torch.equal(a, b)
    x = torch.zeros(5, 3)
    assert q.deform_raw(q.params, x, 0.5).shape == (5, 3)


def test_kernel_tables_cover_the_deform_leaves(case):
    """The packed tables are cached per version of every leaf, the deform
    tower's included: an in-place update of one repacks."""
    _, tc, _, tp, x, d = case
    f = tcp.CPField(tcp.map_params(lambda a: a.clone(), tp), tc)
    t1 = f.kernel_tables(f.params)
    assert f.kernel_tables(f.params) is t1
    before = dyn_field_forward(t1, tc, _planar(x), _planar(d), 0.37)
    with torch.no_grad():
        f.params["deform_mlp"]["w"][1].mul_(0.5)
    t2 = f.kernel_tables(f.params)
    assert t2 is not t1
    after = dyn_field_forward(t2, tc, _planar(x), _planar(d), 0.37)
    assert not torch.equal(before, after)


def test_packed_deform_weights_layout():
    """The layout the dynamic kernel reads: output-major matrices, the first
    without its time rows and zero-padded to 16 inputs, the last padded to
    8 rows; the time rows stay f32."""
    cfg = tcp.CPDNeRFConfig(scales=((8, 4),), planes=())
    p = tcp.init_cp_dnerf(torch.Generator().manual_seed(1), cfg)
    tb = pack_tables(p, cfg)
    n_layers, hid, nx, in_pad, nfreq, *offs = tb.dmeta
    assert (n_layers, hid, nx, in_pad, nfreq) == (8, 128, 63, 64, 10)
    assert tb.wdef.dtype == torch.bfloat16
    assert tb.wdef.numel() == 128 * 64 + 6 * 128 * 128 + 8 * 128
    assert offs == [0] + [128 * 64 + k * 128 * 128 for k in range(7)]
    wd = [w.to(torch.bfloat16) for w in p["deform_mlp"]["w"]]
    first = tb.wdef[:128 * 64].view(128, 64)
    assert torch.equal(first[:, :63], wd[0][:63].t())
    assert not first[:, 63].any()
    assert torch.equal(tb.wdef[offs[3]:offs[4]].view(128, 128), wd[3].t())
    last = tb.wdef[offs[7]:].view(8, 128)
    assert torch.equal(last[:3], wd[7].t()) and not last[3:].any()
    assert tb.w0_time.dtype == torch.float32
    assert torch.equal(tb.w0_time, p["deform_mlp"]["w"][0][63:])
    # a tower the kernel is not built for packs no kernel operands
    small = tcp.CPDNeRFConfig(scales=((8, 4),), planes=(),
                              hidden_dim_deform=32)
    ts = pack_tables(tcp.init_cp_dnerf(torch.Generator().manual_seed(1),
                                       small), small)
    assert ts.dmeta == [] and ts.wdef.numel() == 0
