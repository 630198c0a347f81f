"""Parity of the port's CP field and of the plain version of its fused
field kernel (sealdnerf_tpu_torch/ops/field.py) with the JAX package: the
XLA forward `cp_forward` and the Pallas kernel `cp_forward_fused_planar`
run in interpret mode. Parameters are converted with `params_from_jax`.

Tolerances: sigma rtol 2e-2 atol 1e-4, rgb rtol 2e-2 atol 1e-3 against the
XLA path (the reference's own Pallas-vs-XLA tolerances: the XLA path rounds
the frequency features to bf16, the kernel does not); 1e-5 against the
Pallas kernel, whose rounding points the plain version reproduces."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.models.cp import CPConfig as JaxCPConfig, make_cp_field
from sealdnerf_tpu.ops.pallas_field import cp_forward_fused_planar
from sealdnerf_tpu_torch.models.cp import (CPConfig, cp_forward, init_cp,
                                           make_cp_field as torch_cp_field,
                                           params_from_jax, params_to_numpy)
from sealdnerf_tpu_torch.ops import build
from sealdnerf_tpu_torch.ops.field import (field_forward, field_forward_plain,
                                           pack_tables)

SCALES = ((8, 8), (16, 16))
PLANES = ((8, 4), (16, 2))
SIGMA_TOL = dict(rtol=2e-2, atol=1e-4)
RGB_TOL = dict(rtol=2e-2, atol=1e-3)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxCPConfig(bound=1.0, scales=SCALES, planes=PLANES)
    tcfg = CPConfig(bound=1.0, scales=SCALES, planes=PLANES)
    f = make_cp_field(jax.random.PRNGKey(7), jcfg)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, f.params))
    rng = np.random.default_rng(0)
    m = 100 + 37                        # ragged against the 64-sample tile
    x = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    x[:4] = [[-1, -1, -1], [1, 1, 1], [1, -1, 0], [0, 0, 0]]  # clip edges
    d = rng.normal(size=(m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jcfg, tcfg, f, params, x, d


def _planar(a):
    return torch.from_numpy(np.ascontiguousarray(a.T))


def test_params_carry_over_exactly(setup):
    _, _, f, params, _, _ = setup
    back = params_to_numpy(params)
    ref = jax.tree_util.tree_map(np.asarray, f.params)
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_cp_forward_matches_xla(setup):
    """The port's plain CP field (XLA-path semantics) vs cp_forward."""
    _, tcfg, f, params, x, d = setup
    s0, r0 = f.forward(f.params, jnp.asarray(x), jnp.asarray(d))
    s1, r1 = cp_forward(params, tcfg, torch.from_numpy(x),
                        torch.from_numpy(d), chunk=64)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s0), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(r1.numpy(), np.asarray(r0), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("lod_skip", [(), (1,)])
def test_field_plain_matches_pallas_and_xla(setup, lod_skip):
    jcfg, tcfg, f, params, x, d = setup
    ref = np.asarray(cp_forward_fused_planar(
        f.params, jcfg, jnp.asarray(x.T), jnp.asarray(d.T), tile=64,
        interpret=True, lod_skip=lod_skip))
    out = field_forward(params, tcfg, _planar(x), _planar(d),
                        lod_skip=lod_skip).numpy()
    assert out.shape == (4, x.shape[0])
    np.testing.assert_allclose(out, ref[:4], **KERNEL_TOL)
    np.testing.assert_array_equal(ref[4:], 0.0)

    pz = f.params
    if lod_skip:
        pz = dict(f.params)
        pz["lines"] = [[jnp.zeros_like(a) for a in ax] if s in lod_skip
                       else ax for s, ax in enumerate(f.params["lines"])]
    s0, r0 = f.forward(pz, jnp.asarray(x), jnp.asarray(d))
    np.testing.assert_allclose(out[0], np.asarray(s0), **SIGMA_TOL)
    np.testing.assert_allclose(out[1:4], np.asarray(r0).T, **RGB_TOL)


def test_field_density_only(setup):
    jcfg, tcfg, f, params, x, d = setup
    full = field_forward(params, tcfg, _planar(x), _planar(d)).numpy()
    dens = field_forward(params, tcfg, _planar(x), None,
                         density_only=True).numpy()
    np.testing.assert_array_equal(dens[0], full[0])
    np.testing.assert_array_equal(dens[1:], 0.0)
    s0, _ = f.density(f.params, jnp.asarray(x))
    np.testing.assert_allclose(dens[0], np.asarray(s0), **SIGMA_TOL)


def test_packed_tables_give_the_same_result(setup):
    _, tcfg, _, params, x, d = setup
    tables = pack_tables(params, tcfg)
    assert tables.tab.dtype == torch.bfloat16
    assert tables.wfwd.numel() % 8 == 0 and tables.wbwd.numel() % 8 == 0
    np.testing.assert_array_equal(
        field_forward(tables, tcfg, _planar(x), _planar(d)).numpy(),
        field_forward_plain(tables, tcfg, _planar(x), _planar(d),
                            chunk=16).numpy())


def test_field_forward_rejects_bad_inputs(setup):
    _, tcfg, _, params, x, d = setup
    with pytest.raises(ValueError):
        field_forward(params, tcfg, torch.from_numpy(x), _planar(d))
    with pytest.raises(ValueError):
        field_forward(params, tcfg, _planar(x).double(), _planar(d))
    with pytest.raises(ValueError):
        field_forward(params, tcfg, _planar(x), None)


def test_cpu_tensor_never_launches(setup):
    _, tcfg, _, params, x, d = setup
    before = field_forward.launches
    field_forward(params, tcfg, _planar(x), _planar(d))
    assert field_forward.launches == before


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc -> a clear error, never a silent fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    build.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library()
    build.load_library.cache_clear()


def test_seeded_init_is_reproducible():
    cfg = CPConfig(bound=1.0, scales=SCALES, planes=PLANES)
    a = init_cp(torch.Generator().manual_seed(5), cfg)
    b = torch_cp_field(torch.Generator().manual_seed(5), cfg).params
    for s in range(len(SCALES)):
        assert a["lines"][s][0].shape == (SCALES[s][0], SCALES[s][1])
        assert torch.equal(a["lines"][s][2], b["lines"][s][2])
    assert a["planes"][1][0].shape == (16, 16, 2)
    assert [w.shape for w in a["sigma_mlp"]["w"]] == [(cfg.feat_dim, 64),
                                                      (64, 16)]
    assert [w.shape for w in a["color_mlp"]["w"]] == [(31, 64), (64, 64),
                                                      (64, 3)]
