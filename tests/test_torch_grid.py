"""Parity of the port's occupancy grid with the JAX package:
mark_untrained_grid (exactly equal) and a full update_density_grid sweep
with JAX's in-cell jitter rebuilt from the same key and passed in. Both
query the density through their field kernel (Pallas in interpret mode,
the port's plain K1). The density grid agrees to the kernel's bf16
tolerance (sigma rtol 2e-2, atol 1e-4), and at least 99.9 % of the
occupancy cells are equal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.data.synthetic import make_synthetic_scene
from sealdnerf_tpu.models.cp import CPConfig as JaxCPConfig, make_cp_field
from sealdnerf_tpu.ops.marching import MarchConfig
from sealdnerf_tpu.ops.pallas_field import make_fused_forward_planar
from sealdnerf_tpu.render import grid as jgrid
from sealdnerf_tpu_torch.models.cp import CPConfig, params_from_jax
from sealdnerf_tpu_torch.ops.field import field_forward, pack_tables
from sealdnerf_tpu_torch.render import grid as tgrid

SCALES = ((8, 8), (16, 16))
PLANES = ((8, 4),)


def _configs(bound, h):
    cas = 1 + max(0, int(np.ceil(np.log2(max(bound, 1.0)))))
    jcfg = jgrid.GridConfig(march=MarchConfig(bound=bound, cascades=cas,
                                              grid_size=h),
                            density_thresh=10.0)
    tcfg = tgrid.GridConfig(bound=bound, cascades=cas, grid_size=h,
                            density_thresh=10.0)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def scene():
    _, train, _ = make_synthetic_scene(n_train=6, n_val=1, res=16)
    return train


@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_mark_untrained_grid(scene, bound):
    jcfg, tcfg = _configs(bound, 16)
    ref = jgrid.mark_untrained_grid(jgrid.init_grid_state(jcfg),
                                    jnp.asarray(scene.poses),
                                    jnp.asarray(scene.intrinsics), jcfg)
    got = tgrid.mark_untrained_grid(tgrid.init_grid_state(tcfg),
                                    torch.from_numpy(scene.poses),
                                    torch.from_numpy(scene.intrinsics), tcfg)
    dg = got["density_grid"].numpy()
    np.testing.assert_array_equal(dg, np.asarray(ref["density_grid"]))
    assert (dg < 0).sum() < dg.size


@pytest.mark.parametrize("bound", [1.0, 2.0])
def test_full_density_sweep(scene, bound):
    h = 16
    jcfg, tcfg = _configs(bound, h)
    jf = make_cp_field(jax.random.PRNGKey(3), JaxCPConfig(
        bound=bound, scales=SCALES, planes=PLANES))
    fcfg = CPConfig(bound=bound, scales=SCALES, planes=PLANES)
    tables = pack_tables(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jf.params)), fcfg)

    state_j = jgrid.mark_untrained_grid(
        jgrid.init_grid_state(jcfg), jnp.asarray(scene.poses),
        jnp.asarray(scene.intrinsics), jcfg)
    state_t = tgrid.init_grid_state(tcfg)
    state_t["density_grid"] = torch.from_numpy(
        np.array(state_j["density_grid"]))

    # the reference's density query on its serving path: the Pallas field
    # kernel (interpret mode on the CPU), as the port's goes through K1
    fused = make_fused_forward_planar(jf.cfg, interpret=True)

    def jax_density(params, x):
        d3 = jnp.zeros_like(x.T).at[2].set(1.0)
        return (fused(params, x.T, d3)[0],)

    key = jax.random.PRNGKey(11)
    ref = jgrid.update_density_grid(state_j, jf.params, jax_density, key,
                                    jcfg, full=True)
    # JAX's jitter, rebuilt from the same key (grid.py: one split per cascade)
    rng, draws = key, []
    for _ in range(jcfg.cascades):
        rng, k = jax.random.split(rng)
        draws.append(np.asarray(jax.random.uniform(k, (h ** 3, 3))))

    def density(pts):
        return field_forward(tables, fcfg, pts.t().contiguous(), None,
                             density_only=True)[0]

    got = tgrid.update_density_grid(state_t, density, tcfg, full=True,
                                    noise_u=torch.from_numpy(np.stack(draws)))
    dg, dg0 = got["density_grid"].numpy(), np.asarray(ref["density_grid"])
    np.testing.assert_array_equal(dg < 0, dg0 < 0)
    np.testing.assert_allclose(dg, dg0, rtol=2e-2, atol=1e-4)
    occ, occ0 = got["occ"].numpy(), np.asarray(ref["occ"])
    assert occ.shape == occ0.shape
    assert (occ == occ0).mean() >= 0.999
    assert 0 < occ.sum() < occ.size
    assert int(got["iter_density"]) == 1


def test_partial_update_from_generator(scene):
    """The partial refresh (H^3/2 random cells) is reproducible from a
    seed and only raises visited cells (EMA max with decay)."""
    _, tcfg = _configs(1.0, 8)
    state = tgrid.init_grid_state(tcfg)
    state["density_grid"] += 0.5
    out = [tgrid.update_density_grid(state, lambda p: p.norm(dim=-1), tcfg,
                                     full=False,
                                     generator=torch.Generator().manual_seed(1))
           for _ in range(2)]
    assert torch.equal(out[0]["density_grid"], out[1]["density_grid"])
    changed = out[0]["density_grid"] != 0.5 * tcfg.decay
    assert 0 < int(changed.sum()) < 8 ** 3
