"""Parity of the port's field backward (ops/field.py) with the JAX package.

- trunc_exp: value and clamped gradient against the reference's custom VJP
  (rtol 1e-6).
- field_backward_plain (the plain version of K2) against the Pallas backward
  `_bwd_pallas_call` in interpret mode: per leaf max |diff| <= 5e-3 * max
  |ref|. The rounding points are the same and only the order of the f32
  sums differs; measured here: about 2e-7.
- FieldTrainFn (K1 forward, K2 backward; plain versions on the CPU) against
  `cp_train_fused` under value_and_grad of sum(sigma w) + sum(rgb cw): loss
  rtol 1e-4, grads per leaf <= 1e-2 * max |ref|; against autograd through
  the port's XLA-semantics `cp_forward` within the reference's bf16 envelope
  of 0.35 (test_fast_path.py::TestFusedTrainKernel); zero input grads.
- Faults repaired with the training slice: packed tables follow in-place
  updates, and the kernel build hash covers headers.
- The kernel build runs one nvcc per source, all at once, then one link
  (checked with a stand-in compiler, since the CPU has no nvcc)."""

import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.models.cp import CPConfig as JaxCPConfig, make_cp_field
from sealdnerf_tpu.ops.activation import trunc_exp as jax_trunc_exp
from sealdnerf_tpu.ops.pallas_field import _bwd_pallas_call, cp_train_fused
from sealdnerf_tpu_torch.models.cp import (CPConfig, CPField, cp_forward,
                                           param_leaves, params_from_jax,
                                           unflatten_like)
from sealdnerf_tpu_torch.ops import build
from sealdnerf_tpu_torch.ops.activation import trunc_exp
from sealdnerf_tpu_torch.ops.field import (field_backward,
                                           field_backward_plain,
                                           field_forward, field_train_forward,
                                           pack_tables)
from sealdnerf_tpu_torch.utils import profiling

SCALES = ((8, 8), (16, 16))
PLANES = ((8, 4), (16, 2))
BWD_TOL = 5e-3        # plain K2 vs the Pallas backward, relative to max|ref|
TRAIN_TOL = 1e-2      # FieldTrainFn vs cp_train_fused, relative to max|ref|


def _calls(k: int) -> int:
    """The calls that reached kernel K<k> in this process (the counter
    "k<k>.calls" of utils/profiling.py)."""
    return profiling.tally(traced=False)["counters"].get(f"k{k}.calls", 0)


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxCPConfig(bound=1.0, scales=SCALES, planes=PLANES)
    tcfg = CPConfig(bound=1.0, scales=SCALES, planes=PLANES)
    f = make_cp_field(jax.random.PRNGKey(7), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, f.params))
    rng = np.random.default_rng(0)
    m = 100 + 37                        # ragged against the 64-sample tile
    x = rng.uniform(-1, 1, (3, m)).astype(np.float32)
    x[:, :4] = np.array([[-1, -1, -1], [1, 1, 1], [1, -1, 0], [0, 0, 0]]).T
    d = rng.normal(size=(3, m)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    g = rng.normal(size=(4, m)).astype(np.float32)
    g[:, 10:30] = 0.0                   # samples with no cotangent
    return jcfg, tcfg, f, params, x, d, g


def _rel_errs(ref_tree, got_tree):
    """Per leaf max |got - ref| / max |ref|, in JAX leaf order."""
    out = []
    for (k, a), b in zip(jax.tree_util.tree_leaves_with_path(ref_tree),
                         param_leaves(got_tree)):
        a = np.asarray(a)
        b = b.detach().numpy() if hasattr(b, "detach") else np.asarray(b)
        assert a.shape == b.shape, (jax.tree_util.keystr(k), a.shape, b.shape)
        out.append((jax.tree_util.keystr(k),
                    np.abs(a - b).max() / (np.abs(a).max() + 1e-12)))
    return out


def test_trunc_exp_value_and_grad():
    x = np.linspace(-20.0, 20.0, 81).astype(np.float32)
    w = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    val_j, grad_j = jax.value_and_grad(
        lambda v: jnp.sum(jax_trunc_exp(v) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    val_t = (trunc_exp(xt) * torch.from_numpy(w)).sum()
    val_t.backward()
    np.testing.assert_allclose(trunc_exp(xt).detach().numpy(),
                               np.asarray(jax_trunc_exp(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_allclose(float(val_t.detach()), float(val_j),
                               rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grad_j),
                               rtol=1e-6)
    # above 15 the gradient is clamped while the value is not
    big = x > 15
    np.testing.assert_allclose(xt.grad.numpy()[big],
                               w[big] * np.exp(np.float32(15.0)), rtol=1e-6)


def test_plain_backward_matches_pallas(setup):
    jcfg, tcfg, f, params, x, d, g = setup
    g8 = np.concatenate([g, np.zeros_like(g)], axis=0)
    ref = _bwd_pallas_call(f.params, jcfg, jnp.asarray(x), jnp.asarray(d),
                           jnp.asarray(g8), 64, True)
    got = field_backward_plain(pack_tables(params, tcfg), tcfg,
                               torch.from_numpy(x), torch.from_numpy(d),
                               torch.from_numpy(g), chunk=64)
    errs = _rel_errs(ref, got)
    assert len(errs) == 23
    for name, e in errs:
        assert e <= BWD_TOL, (name, e)
    assert float(got["planes"][1][2].abs().max()) > 0.0
    assert float(got["vm_lines"][0][1].abs().max()) > 0.0


def test_zero_cotangent_adds_nothing(setup):
    _, tcfg, _, params, x, d, g = setup
    tables = pack_tables(params, tcfg)
    args = [torch.from_numpy(a) for a in (x, d)]
    full = field_backward(tables, tcfg, *args, torch.from_numpy(g))
    keep = np.ones(x.shape[1], bool)
    keep[10:30] = False
    part = field_backward(tables, tcfg,
                          *[torch.from_numpy(np.ascontiguousarray(a[:, keep]))
                            for a in (x, d, g)])
    for a, b in zip(param_leaves(full), param_leaves(part)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_field_train_fn_matches_cp_train_fused(setup):
    jcfg, tcfg, f, params, x, d, _ = setup
    rng = np.random.default_rng(1)
    w = rng.random(x.shape[1]).astype(np.float32)
    cw = rng.random((x.shape[1], 3)).astype(np.float32)

    def loss_j(p):
        out = cp_train_fused(jcfg, 64, True, p, jnp.asarray(x), jnp.asarray(d))
        return jnp.sum(out[0] * w) + jnp.sum(out[1:4].T * cw)

    l_j, g_j = jax.value_and_grad(loss_j)(f.params)

    leaves = [t.clone().requires_grad_(True) for t in param_leaves(params)]
    p_t = unflatten_like(params, leaves)
    x3 = torch.from_numpy(x).requires_grad_(True)
    d3 = torch.from_numpy(d).requires_grad_(True)
    before = _calls(2)
    out = field_train_forward(p_t, tcfg, x3, d3)
    l_t = (out[0] * torch.from_numpy(w)).sum() + \
        (out[1:4].t() * torch.from_numpy(cw)).sum()
    l_t.backward()
    assert _calls(2) == before        # CPU: plain version
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), rtol=1e-4)
    grads = unflatten_like(params, [t.grad for t in leaves])
    for name, e in _rel_errs(g_j, grads):
        assert e <= TRAIN_TOL, (name, e)
    # static scenes: positions and directions get no gradient
    for t in (x3, d3):
        assert t.grad is None or float(t.grad.abs().max()) == 0.0

    # against autograd through the XLA-semantics field: bf16 envelope
    leaves2 = [t.clone().requires_grad_(True) for t in param_leaves(params)]
    p2 = unflatten_like(params, leaves2)
    sig, rgb = cp_forward(p2, tcfg, torch.from_numpy(x.T.copy()),
                          torch.from_numpy(d.T.copy()))
    ((sig * torch.from_numpy(w)).sum()
     + (rgb * torch.from_numpy(cw)).sum()).backward()
    for a, b in zip(leaves2, leaves):
        err = (a.grad - b.grad).abs().max() / (a.grad.abs().max() + 1e-6)
        assert float(err) < 0.35


def test_backward_rejects_bad_inputs(setup):
    _, tcfg, _, params, x, d, g = setup
    x3, d3, g4 = (torch.from_numpy(a) for a in (x, d, g))
    with pytest.raises(ValueError):
        field_backward(params, tcfg, x3, d3, g4[:3])
    with pytest.raises(ValueError):
        field_backward(params, tcfg, x3, d3, g4.t())
    with pytest.raises(ValueError):
        field_backward(params, tcfg, x3, d3, g4.double())


def test_kernel_tables_follow_inplace_updates(setup):
    """An optimizer updates params in place; the packed tables must follow
    (they were cached by the params dict's identity before)."""
    _, tcfg, _, params, x, d, _ = setup
    p = {k: v for k, v in params.items()}
    leaves = [t.clone().requires_grad_(True) for t in param_leaves(p)]
    p = unflatten_like(p, leaves)
    field = CPField(p, tcfg)
    t0 = field.kernel_tables(p)
    assert field.kernel_tables(p) is t0              # cached while unchanged
    opt = torch.optim.Adam(leaves, lr=0.1)
    out = field_train_forward(p, tcfg, torch.from_numpy(x),
                              torch.from_numpy(d), field.kernel_tables(p))
    out.sum().backward()
    opt.step()
    t1 = field.kernel_tables(p)
    assert t1 is not t0
    np.testing.assert_array_equal(t1.tab.float().numpy(),
                                  pack_tables(p, tcfg).tab.float().numpy())
    assert not torch.equal(t1.wbwd, t0.wbwd)
    fresh = field_forward(pack_tables(p, tcfg), tcfg, torch.from_numpy(x),
                          torch.from_numpy(d))
    np.testing.assert_array_equal(
        field_forward(t1, tcfg, torch.from_numpy(x),
                      torch.from_numpy(d)).numpy(), fresh.numpy())
    with torch.no_grad():                            # an EMA-style update
        leaves[0].mul_(0.5)
    assert field.kernel_tables(p) is not t1


def test_source_hash_covers_headers(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    shutil.copytree(build.SRC_DIR, src)
    monkeypatch.setattr(build, "SRC_DIR", src)
    before = build.source_hash()
    headers = sorted(src.glob("*.cuh"))
    assert headers, "the kernels share a header"
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    assert build.source_hash() != before
    assert [p.suffix for p in build._sources()] == [".cu"] * len(
        build._sources())


# A stand-in for nvcc: it logs its arguments, writes its -o target, and a
# compile (-c) waits until every source's compile has started, so a build
# that ran them one after another would fail here.
_FAKE_NVCC = """#!/bin/sh
echo "$@" >> "$SDN_LOG"
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
case " $* " in
  *" -c "*)
    touch "$SDN_MARK/$$"
    case " $* " in *"$SDN_FAIL"*) exit 7;; esac
    n=0
    while [ "$(ls "$SDN_MARK" | wc -l)" -lt "$SDN_NSRC" ] && [ $n -lt 200 ]; do
      sleep 0.05; n=$((n+1))
    done
    [ "$(ls "$SDN_MARK" | wc -l)" -ge "$SDN_NSRC" ] || exit 3
    echo "ptxas info    : Used 1 registers";;
esac
: > "$out"
"""


@pytest.mark.parametrize("fail", ["", "field_fwd.cu"])
def test_build_compiles_sources_in_parallel(monkeypatch, tmp_path, fail):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    (tmp_path / "mark").mkdir()
    n_src = len(build._sources())
    assert n_src >= 2
    for k, v in (("SDN_LOG", tmp_path / "calls.log"),
                 ("SDN_MARK", tmp_path / "mark"), ("SDN_NSRC", n_src),
                 # "/name": dyn_field_fwd.cu also ends in field_fwd.cu
                 ("SDN_FAIL", f"/{fail}" if fail else "no-such-source")):
        monkeypatch.setenv(k, str(v))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    if fail:
        with pytest.raises(RuntimeError,
                           match=rf"nvcc failed: {fail} \(code 7\):"):
            build.build()
        assert not list((tmp_path / "_build").rglob(build.LIB_NAME))
        return
    lib = build.build()
    assert lib.exists() and lib.parent.parent == tmp_path / "_build"
    calls = (tmp_path / "calls.log").read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    links = [c for c in calls if "-shared" in c.split()]
    assert sorted(c.split()[-1] for c in compiles) == \
        [str(p) for p in build._sources()]
    assert len(links) == 1 and links[0].count(".o") == n_src
    log = (lib.parent / "nvcc.log").read_text()
    for p in build._sources():
        assert f"== {p.name}" in log
    assert "registers" in log and "== link" in log
    assert not list(lib.parent.glob("*.o"))            # objects removed
    assert build.build() == lib                        # built once per hash
    assert len((tmp_path / "calls.log").read_text().splitlines()) == \
        len(calls)
