"""Parity of the port's dynamic field backward (ops/field.py) with the JAX
package.

`dyn_field_backward_plain` is the plain version of the dynamic backward
kernel (ops/csrc/dyn_field_bwd.cu). It is held against the Pallas backward
`cp_dnerf_train_fused` in interpret mode at the reference test's own small
config (scales (8,8) (16,16), planes ((8,2),), 3 deform layers of 16,
multires_deform 2, 64 samples, the last deform matrix x 100), with the time
traced so that t = 0.37 and t = 0 share one interpret-mode compile.

Tolerances:
- plain vs Pallas interpret, per leaf: max |diff| <= 1e-2 * max |ref|. The
  rounding points are the same; sums run in other orders, and a flipped
  bf16 rounding of one hidden activation or cotangent moves single entries
  (measured here: at most 4e-3). The first deform matrix's 13 time rows are
  under the same limit: the Pallas kernel rounds the sum of g_h over each
  32-sample tile to bf16 before the outer product, the port rounds the sum
  over all samples once, which differs by at most one bf16 ulp (2^-8) of
  the tile sums (measured here: 2e-3).
- at t = 0 every deform gradient is exactly 0 in both.
- against autograd through the XLA-semantics models (the port's and the
  reference's `cp_dnerf_forward`): the reference's own bf16 envelope of
  0.35 (tests/test_fast_path.py::TestDynFusedTrainKernel).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.models import cp as jcp
from sealdnerf_tpu.ops.pallas_field import cp_dnerf_train_fused
from sealdnerf_tpu_torch.models import cp as tcp
from sealdnerf_tpu_torch.ops.field import (DynFieldTrainFn,
                                           dyn_canonical_backward_plain,
                                           dyn_field_backward,
                                           dyn_field_backward_plain,
                                           dyn_field_train_forward,
                                           dyn_tower_backward_plain,
                                           dyn_warp_plain, field_backward,
                                           pack_tables)
from sealdnerf_tpu_torch.utils import profiling

SMALL = dict(bound=1.0, scales=((8, 8), (16, 16)), planes=((8, 2),),
             num_layers_deform=3, hidden_dim_deform=16, multires_deform=2)
BWD_TOL = 1e-2       # plain K4 vs the Pallas backward, relative to max |ref|
ENVELOPE = 0.35      # kernel semantics vs XLA semantics (bf16 noise)
TIMES = (0.37, 0.0)


def _calls(k: int) -> int:
    """The calls that reached kernel K<k> in this process (the counter
    "k<k>.calls" of utils/profiling.py)."""
    return profiling.tally(traced=False)["counters"].get(f"k{k}.calls", 0)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; a torch pool of
    every core in each makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed, s=64):
    rng = np.random.RandomState(seed)
    x = rng.rand(s, 3).astype(np.float32) * 1.6 - 0.8
    d = rng.randn(s, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    w = rng.rand(s).astype(np.float32)
    cw = rng.rand(s, 3).astype(np.float32)
    return x, d, w, cw


def _make(seed, **over):
    kw = dict(SMALL, **over)
    jc, tc = jcp.CPDNeRFConfig(**kw), tcp.CPDNeRFConfig(**kw)
    params = jcp.init_cp_dnerf(jax.random.PRNGKey(seed), jc)
    # fatten the near-zero deform init so that warp gradients are not noise
    params["deform_mlp"]["w"][-1] = params["deform_mlp"]["w"][-1] * 100.0
    tp = tcp.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return jc, tc, params, tp


@pytest.fixture(scope="module")
def setup():
    """The reference's losses and gradients at both times (one compile of
    each function), and the port's inputs."""
    jc, tc, params, tp = _make(0)
    x, d, w, cw = _inputs(2)
    xj, dj = jnp.asarray(x), jnp.asarray(d)

    def loss_fused(p, t):
        out = cp_dnerf_train_fused(jc, 32, True, p, xj.T, dj.T, t)
        return jnp.sum(out[0] * w) + jnp.sum(out[1:4].T * cw)

    def loss_xla(p, t):
        sig, rgb, _ = jcp.cp_dnerf_forward(p, jc, xj, dj, t)
        return jnp.sum(sig * w) + jnp.sum(rgb * cw)

    f_fused = jax.jit(jax.value_and_grad(loss_fused))
    f_xla = jax.jit(jax.value_and_grad(loss_xla))
    ref = {t: (f_fused(params, t), f_xla(params, t)) for t in TIMES}
    g_out = np.concatenate([w[None], cw.T], axis=0)       # d loss / d out
    return dict(jc=jc, tc=tc, params=params, tp=tp, x=x, d=d, w=w, cw=cw,
                ref=ref, g_out=np.ascontiguousarray(g_out))


def _planar(a):
    return torch.from_numpy(np.ascontiguousarray(a.T))


def _rel_errs(ref_tree, got_tree):
    """Per leaf (name, max |got - ref| / max |ref|), in JAX leaf order."""
    out = []
    for (k, a), b in zip(jax.tree_util.tree_leaves_with_path(ref_tree),
                         tcp.param_leaves(got_tree)):
        a = np.asarray(a)
        b = b.detach().numpy() if hasattr(b, "detach") else np.asarray(b)
        assert a.shape == b.shape, (jax.tree_util.keystr(k), a.shape, b.shape)
        out.append((jax.tree_util.keystr(k),
                    np.abs(a - b).max() / (np.abs(a).max() + 1e-12)))
    return out


@pytest.mark.parametrize("t", TIMES)
def test_plain_backward_matches_pallas(setup, t):
    s = setup
    (_, g_ref), _ = s["ref"][t]
    got = dyn_field_backward_plain(pack_tables(s["tp"], s["tc"]), s["tc"],
                                   _planar(s["x"]), _planar(s["d"]), t,
                                   torch.from_numpy(s["g_out"]), chunk=32)
    errs = _rel_errs(g_ref, got)
    assert len(errs) == 20
    for name, e in errs:
        assert e <= BWD_TOL, (t, name, e)
    # the time rows of the first deform matrix, on their own
    nx = s["tc"].deform_space_dim
    ref_t = np.asarray(g_ref["deform_mlp"]["w"][0])[nx:]
    got_t = got["deform_mlp"]["w"][0][nx:].numpy()
    assert ref_t.shape == (13, 16)
    assert np.abs(got_t - ref_t).max() <= BWD_TOL * (np.abs(ref_t).max()
                                                    + 1e-12)
    deform = [np.abs(g.numpy()).max() for g in got["deform_mlp"]["w"]]
    if t == 0.0:
        # the canonical frame: no deform gradient, in either package
        assert max(deform) == 0.0
        assert max(float(jnp.abs(g).max())
                   for g in g_ref["deform_mlp"]["w"]) == 0.0
    else:
        assert min(deform) > 0.0 and np.abs(ref_t).max() > 0.0


def test_plain_at_t0_gives_the_static_gradients(setup):
    s = setup
    tables = pack_tables(s["tp"], s["tc"])
    args = (_planar(s["x"]), _planar(s["d"]))
    g = torch.from_numpy(s["g_out"])
    dyn = dyn_field_backward(tables, s["tc"], *args, 0.0, g)
    static = field_backward(tables, s["tc"], *args, g)
    for k in static:
        for a, b in zip(tcp.param_leaves(dyn[k]), tcp.param_leaves(static[k])):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("t", TIMES)
def test_train_fn_matches_cp_dnerf_train_fused(setup, t):
    """DynFieldTrainFn (plain versions) under autograd against jax.grad
    through cp_dnerf_train_fused, and both against autograd through the
    XLA-semantics models inside the bf16 envelope."""
    s = setup
    (l_ref, g_ref), (l_xla, g_xla) = s["ref"][t]
    leaves = [q.clone().requires_grad_(True)
              for q in tcp.param_leaves(s["tp"])]
    p_t = tcp.unflatten_like(s["tp"], leaves)
    x3 = _planar(s["x"]).requires_grad_(True)
    d3 = _planar(s["d"]).requires_grad_(True)
    tt = torch.tensor(t, requires_grad=True)
    before = _calls(4)
    out = DynFieldTrainFn.apply(pack_tables(p_t, s["tc"]), s["tc"], True, x3,
                                d3, tt, *leaves)
    loss = (out[0] * torch.from_numpy(s["w"])).sum() + \
        (out[1:4].t() * torch.from_numpy(s["cw"])).sum()
    loss.backward()
    assert _calls(4) == before
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-4)
    grads = tcp.unflatten_like(s["tp"], [
        q.grad if q.grad is not None else torch.zeros_like(q)
        for q in leaves])
    for name, e in _rel_errs(g_ref, grads):
        assert e <= BWD_TOL, (t, name, e)
    # positions, directions and the time get no gradient
    for q in (x3, d3, tt):
        assert q.grad is None or float(q.grad.abs().max()) == 0.0

    # the bf16 envelope: the reference's XLA model, and the port's
    for name, e in _rel_errs(g_xla, grads):
        assert e < ENVELOPE, (t, name, e)
    leaves2 = [q.clone().requires_grad_(True)
               for q in tcp.param_leaves(s["tp"])]
    p2 = tcp.unflatten_like(s["tp"], leaves2)
    sig, rgb, _ = tcp.cp_dnerf_forward(p2, s["tc"], torch.from_numpy(s["x"]),
                                       torch.from_numpy(s["d"]), t)
    ((sig * torch.from_numpy(s["w"])).sum()
     + (rgb * torch.from_numpy(s["cw"])).sum()).backward()
    for a, b in zip(leaves2, leaves):
        ga = a.grad if a.grad is not None else torch.zeros_like(a)
        gb = b.grad if b.grad is not None else torch.zeros_like(b)
        err = (ga - gb).abs().max() / (ga.abs().max() + 1e-6)
        assert float(err) < ENVELOPE


def test_coarse_only_warp_grad_routing():
    """With deform_grad_res_cutoff below every scale and no planes, only the
    frequency features back-drive the warp: the port's plain backward and
    the reference's XLA model under the same policy agree on the first
    deform matrix inside the envelope, and raising the cutoff changes that
    gradient. (The reference's Pallas variant of this case is marked slow
    there for its interpret-mode compile; the policy is held against the
    XLA model here, and the Pallas kernel's routing in
    test_plain_backward_matches_pallas, whose scales and plane are below the
    default cutoff.)"""
    over = dict(hidden_dim_deform=32, multires_deform=4, planes=(),
                deform_grad_res_cutoff=4)
    jc, tc, params, tp = _make(1, **over)
    rng = np.random.RandomState(3)
    x = rng.rand(64, 3).astype(np.float32) * 1.6 - 0.8
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (64, 1))
    t = 0.61

    def loss_xla(p):
        sig, rgb, _ = jcp.cp_dnerf_forward(p, jc, jnp.asarray(x),
                                           jnp.asarray(d), t)
        return jnp.sum(sig) + jnp.sum(rgb)

    g0 = np.asarray(jax.grad(loss_xla)(params)["deform_mlp"]["w"][0])
    g_out = torch.ones((4, 64))
    got = dyn_field_backward(tp, tc, _planar(x), _planar(d), t, g_out)
    g1 = got["deform_mlp"]["w"][0].numpy()
    assert np.abs(g0 - g1).max() / (np.abs(g0).max() + 1e-9) < ENVELOPE
    tc_all = tcp.CPDNeRFConfig(**dict(SMALL, **dict(
        over, deform_grad_res_cutoff=256)))
    g2 = dyn_field_backward(tp, tc_all, _planar(x), _planar(d), t,
                            g_out)["deform_mlp"]["w"][0].numpy()
    assert np.abs(g2 - g1).max() > 1e-2 * np.abs(g1).max()
    # the canonical tables' gradients do not depend on the warp's routing
    for a, b in zip(tcp.param_leaves(got["lines"]), tcp.param_leaves(
            dyn_field_backward(tp, tc_all, _planar(x), _planar(d), t,
                               g_out)["lines"])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_zero_cotangent_adds_nothing(setup):
    s = setup
    tables = pack_tables(s["tp"], s["tc"])
    g = s["g_out"].copy()
    g[:, 10:30] = 0.0
    x3, d3 = s["x"].T, s["d"].T
    full = dyn_field_backward(tables, s["tc"], _planar(s["x"]),
                              _planar(s["d"]), 0.37, torch.from_numpy(g))
    keep = np.ones(x3.shape[1], bool)
    keep[10:30] = False
    part = dyn_field_backward(
        tables, s["tc"],
        *[torch.from_numpy(np.ascontiguousarray(a[:, keep]))
          for a in (x3, d3)], 0.37,
        torch.from_numpy(np.ascontiguousarray(g[:, keep])))
    for a, b in zip(tcp.param_leaves(full), tcp.param_leaves(part)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_time_on_a_tensor_equals_a_float(setup):
    s = setup
    tables = pack_tables(s["tp"], s["tc"])
    args = (_planar(s["x"]), _planar(s["d"]))
    g = torch.from_numpy(s["g_out"])
    a = dyn_field_backward(tables, s["tc"], *args, 0.37, g)
    b = dyn_field_backward(tables, s["tc"], *args, torch.tensor([0.37]), g)
    for u, v in zip(tcp.param_leaves(a), tcp.param_leaves(b)):
        np.testing.assert_array_equal(u.numpy(), v.numpy())


def test_train_forward_packs_and_differentiates(setup):
    """dyn_field_train_forward packs the tables itself, and a leaf that is a
    function of a trained tensor carries its gradient on."""
    s = setup
    leaves = [q.clone().requires_grad_(True)
              for q in tcp.param_leaves(s["tp"])]
    p_t = tcp.unflatten_like(s["tp"], leaves)
    scaled = dict(p_t)
    scaled["sigma_mlp"] = {"w": [p_t["sigma_mlp"]["w"][0] * 0.5,
                                 p_t["sigma_mlp"]["w"][1]]}
    out = dyn_field_train_forward(scaled, s["tc"], _planar(s["x"]),
                                  _planar(s["d"]), 0.37)
    out.sum().backward()
    direct = dyn_field_backward(scaled, s["tc"], _planar(s["x"]),
                                _planar(s["d"]), 0.37, torch.ones_like(out))
    np.testing.assert_allclose(
        p_t["sigma_mlp"]["w"][0].grad.numpy(),
        0.5 * direct["sigma_mlp"]["w"][0].numpy(), rtol=1e-6)
    np.testing.assert_array_equal(p_t["deform_mlp"]["w"][1].grad.numpy(),
                                  direct["deform_mlp"]["w"][1].numpy())


def test_stages_can_be_held_one_by_one(setup):
    """The plain version is its three stages in a row (warp, canonical
    backward with g_x, tower backward); each stage follows the input it is
    given, so a kernel's stage can be held on the kernel's own input. `parts`
    is the kernel's: the CPU path refuses it."""
    s = setup
    tables = pack_tables(s["tp"], s["tc"])
    x3, d3 = _planar(s["x"]), _planar(s["d"])
    g = torch.from_numpy(s["g_out"].copy())
    g[:, 5:9] = 0.0
    full = dyn_field_backward(tables, s["tc"], x3, d3, 0.37, g)
    xw, acts = dyn_warp_plain(tables, s["tc"], x3, 0.37)
    assert xw.shape == (3, 64) and len(acts) == len(s["tp"]["deform_mlp"]["w"])
    assert float((xw - x3).abs().mean()) > 1e-3               # it warps
    grads, g_x = dyn_canonical_backward_plain(tables, s["tc"], xw, d3, 0.37,
                                              g)
    assert float(g_x[:, 5:9].abs().max()) == 0.0
    assert float(g_x.abs().max()) > 0.0
    grads["deform_mlp"] = dyn_tower_backward_plain(tables, s["tc"], 0.37,
                                                   acts, g_x)
    for a, b in zip(tcp.param_leaves(full), tcp.param_leaves(grads)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the canonical stage at other positions, the tower stage on another g_x
    # and on the activations of the samples with a cotangent alone
    other, _ = dyn_canonical_backward_plain(tables, s["tc"], x3, d3, 0.37, g)
    static = field_backward(tables, s["tc"], x3, d3, g)
    for k in static:
        for a, b in zip(tcp.param_leaves(other[k]),
                        tcp.param_leaves(static[k])):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    live = torch.nonzero(g.abs().amax(dim=0) > 0)[:, 0]
    twice = dyn_tower_backward_plain(tables, s["tc"], 0.37,
                                     [a[live] for a in acts],
                                     2.0 * g_x[:, live])
    for a, b in zip(twice["w"], full["deform_mlp"]["w"]):
        np.testing.assert_allclose(a.numpy(), 2.0 * b.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()))
    xw0, _ = dyn_warp_plain(tables, s["tc"], x3, 0.0)
    _, g_x0 = dyn_canonical_backward_plain(tables, s["tc"], xw0, d3, 0.0, g)
    assert torch.equal(xw0, x3) and float(g_x0.abs().max()) == 0.0
    with pytest.raises(ValueError, match="kernel's stages"):
        dyn_field_backward(tables, s["tc"], x3, d3, 0.37, g, parts={})


@pytest.mark.parametrize("bad", ["g_rows", "g_layout", "g_dtype", "static_cfg",
                                 "no_tower"])
def test_backward_rejects_bad_inputs(setup, bad):
    s = setup
    x3, d3 = _planar(s["x"]), _planar(s["d"])
    g = torch.from_numpy(s["g_out"])
    cfg, params, exc = s["tc"], s["tp"], ValueError
    if bad == "g_rows":
        g = g[:3]
    elif bad == "g_layout":
        g = g.t()
    elif bad == "g_dtype":
        g = g.double()
    elif bad == "static_cfg":
        cfg, exc = tcp.CPConfig(bound=1.0, scales=SMALL["scales"],
                                planes=SMALL["planes"]), TypeError
    else:
        static_cfg = tcp.CPConfig(bound=1.0, scales=SMALL["scales"],
                                  planes=SMALL["planes"])
        params = pack_tables({k: v for k, v in params.items()
                              if k != "deform_mlp"}, static_cfg)
    with pytest.raises(exc):
        dyn_field_backward(params, cfg, x3, d3, 0.37, g)
