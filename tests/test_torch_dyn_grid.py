"""Parity of the port's time-conditioned occupancy grid
(sealdnerf_tpu_torch/render/dynamic_grid.py) with the JAX package's.

time_slice_index, grid_times and mark_untrained_dyn_grid must be exactly
equal. update_dyn_density_grid with full=True is compared call by call
(cursor, passes, EMA max, threshold, occupancy) on an analytic density that
moves with time; the jitter JAX draws from its key is rebuilt with the same
jax.random calls and handed to the port as `noise_u`. The density grid must
agree to 1e-5 (f32 arithmetic of two frameworks), the occupancy exactly.
The random-cell branch draws other cells in the two packages, so it is
checked by its invariants."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.data.synthetic import make_synthetic_scene
from sealdnerf_tpu.ops.marching import MarchConfig
from sealdnerf_tpu.render import dynamic_grid as jdyn
from sealdnerf_tpu_torch.render import dynamic_grid as tdyn

H = 8


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; a torch pool of
    every core in each makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(**kw):
    jcfg = jdyn.DynGridConfig(march=MarchConfig(bound=1.0, cascades=1,
                                                grid_size=H),
                              density_thresh=10.0, **kw)
    tcfg = tdyn.DynGridConfig(bound=1.0, cascades=1, grid_size=H,
                              density_thresh=10.0, **kw)
    return jcfg, tcfg


def _centre(t):
    return 0.5 * np.cos(2.0 * t), 0.5 * np.sin(2.0 * t), 0.2 * t


def _density_jax(params, x, t):
    cx, cy, cz = 0.5 * jnp.cos(2.0 * t), 0.5 * jnp.sin(2.0 * t), 0.2 * t
    r2 = (x[:, 0] - cx) ** 2 + (x[:, 1] - cy) ** 2 + (x[:, 2] - cz) ** 2
    return (params * jnp.exp(-r2 / 0.2),)


def _density_torch(scale):
    def fn(x, t):
        cx, cy, cz = 0.5 * torch.cos(2.0 * t), 0.5 * torch.sin(2.0 * t), \
            0.2 * t
        r2 = (x[:, 0] - cx) ** 2 + (x[:, 1] - cy) ** 2 + (x[:, 2] - cz) ** 2
        return scale * torch.exp(-r2 / 0.2)
    return fn


def _jax_draws(rng, nb, n_pts):
    """The uniform draws of the reference's update for one call: per bin
    (u_xyz [n_pts, 3], u_t), single cascade."""
    u_xyz, u_t = [], []
    for key in jax.random.split(rng, nb):
        _, _, k1, k2 = jax.random.split(key, 4)
        u_xyz.append(np.asarray(jax.random.uniform(k1, (n_pts, 3))))
        u_t.append(np.asarray(jax.random.uniform(k2, ())))
    return (torch.from_numpy(np.stack(u_xyz))[:, None],
            torch.from_numpy(np.stack(u_t))[:, None])


def _assert_state_equal(ts, js):
    np.testing.assert_allclose(ts["density_grid"].numpy(),
                               np.asarray(js["density_grid"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(ts["occ"].numpy(), np.asarray(js["occ"]))
    np.testing.assert_allclose(float(ts["mean_density"]),
                               float(js["mean_density"]), rtol=1e-5)
    assert int(ts["iter_density"]) == int(js["iter_density"])
    assert int(ts["bin_cursor"]) == int(js["bin_cursor"])


@pytest.mark.parametrize("time_size", [64, 10])
def test_time_slice_index_and_grid_times(time_size):
    jcfg, tcfg = _configs(time_size=time_size)
    np.testing.assert_array_equal(tdyn.grid_times(tcfg).numpy(),
                                  np.asarray(jdyn.grid_times(jcfg)))
    ts = np.concatenate([
        np.linspace(-0.1, 1.1, 241), np.arange(time_size + 1) / time_size,
        np.nextafter(np.arange(1, time_size) / time_size, 0.0),
        np.random.default_rng(0).uniform(0, 1, 200)]).astype(np.float32)
    for t in ts:
        want = int(jdyn.time_slice_index(jnp.float32(t), jcfg))
        got = tdyn.time_slice_index(float(t), tcfg)
        assert isinstance(got, int) and got == want, t
        got_t = tdyn.time_slice_index(torch.tensor(t), tcfg)
        assert got_t.dtype == torch.int64 and int(got_t) == want, t


def test_config_matches_the_reference():
    jcfg, tcfg = _configs()
    assert (tcfg.time_size, tcfg.bins_per_call, tcfg.freeze_after) == \
        (jcfg.time_size, jcfg.bins_per_call, jcfg.freeze_after) == (64, 8, 100)
    assert tcfg.freeze_calls == jcfg.freeze_calls == 800
    j2, t2 = _configs(time_size=10, bins_per_call=3, freeze_after=7)
    assert t2.freeze_calls == j2.freeze_calls == 28
    sv = tcfg.static_view()
    assert (sv.bound, sv.cascades, sv.grid_size, sv.density_thresh,
            sv.decay) == (1.0, 1, H, 10.0, 0.95)
    st = tdyn.init_dyn_grid_state(tcfg)
    js = jdyn.init_dyn_grid_state(jcfg)
    assert set(st) == set(js)
    for k in st:
        assert tuple(st[k].shape) == tuple(js[k].shape), k


def test_mark_untrained_matches_jax():
    jcfg, tcfg = _configs()
    _, train, _ = make_synthetic_scene(n_train=3, n_val=1, res=16,
                                       dynamic=True)
    poses = train.poses[:2]             # two cameras: part of the box unseen
    js = jdyn.mark_untrained_dyn_grid(jdyn.init_dyn_grid_state(jcfg),
                                      jnp.asarray(poses),
                                      jnp.asarray(train.intrinsics), jcfg)
    ts = tdyn.mark_untrained_dyn_grid(tdyn.init_dyn_grid_state(tcfg),
                                      torch.from_numpy(poses),
                                      torch.from_numpy(train.intrinsics),
                                      tcfg)
    g = ts["density_grid"].numpy()
    np.testing.assert_array_equal(g, np.asarray(js["density_grid"]))
    assert (g == -1).any() and (g == 0).any()
    assert (g == g[:1]).all()           # the same mask in every time bin


def test_full_update_matches_jax_call_by_call():
    """time_size 8, 3 bins per call: three calls wrap the cursor (bin 0 is
    refreshed twice, so the EMA max is exercised) and complete one pass."""
    jcfg, tcfg = _configs(time_size=8, bins_per_call=3)
    js = jdyn.init_dyn_grid_state(jcfg)
    ts = tdyn.init_dyn_grid_state(tcfg)
    # unseen cells stay -1 through every update
    mask = np.zeros((1, H ** 3), bool)
    mask[0, ::7] = True
    js["density_grid"] = jnp.where(mask[None], -1.0, js["density_grid"])
    ts["density_grid"][:, torch.from_numpy(mask)] = -1.0
    for call, scale in enumerate((30.0, 12.0, 9.0)):
        rng = jax.random.PRNGKey(call)
        js = jdyn.update_dyn_density_grid(js, jnp.float32(scale),
                                          _density_jax, rng, jcfg, full=True)
        ts = tdyn.update_dyn_density_grid(
            ts, _density_torch(scale), tcfg, full=True,
            noise_u=_jax_draws(rng, 3, H ** 3))
        _assert_state_equal(ts, js)
    assert int(ts["bin_cursor"]) == 1 and int(ts["iter_density"]) == 1
    g = ts["density_grid"].numpy()
    assert (g[:, mask] == -1).all() and (g[:, ~mask] >= 0).all()
    # calls 1-3 took bins (0,1,2) (3,4,5) (6,7,0): bin 0 holds the decayed
    # first reading (scale 30) where it beats the second (scale 9)
    assert g[0].max() > 9.0
    assert ts["occ"].numpy().reshape(8, -1).any(axis=1).all()


def test_random_cell_update_invariants():
    _, tcfg = _configs(time_size=8, bins_per_call=2)
    gen = torch.Generator().manual_seed(3)

    def flat(x, t):                     # constant in space, one value per bin
        return torch.full((x.shape[0],), 1.0) + torch.round(t * 8 - 0.5)

    st = tdyn.init_dyn_grid_state(tcfg)
    st["bin_cursor"] += 3
    seen = []

    def spy(x, t):
        seen.append((x.shape[0], float(t), float(x.abs().max())))
        return flat(x, t)

    out = tdyn.update_dyn_density_grid(st, spy, tcfg, full=False,
                                       generator=gen)
    assert out["density_grid"] is st["density_grid"]     # updated in place
    assert int(out["bin_cursor"]) == 5 and int(out["iter_density"]) == 0
    assert [n for n, _, _ in seen] == [H ** 3 // 2] * 2
    for (_, t, xmax), b in zip(seen, (3, 4)):
        assert abs(t - (b + 0.5) / 8) <= 0.5 / 8         # jittered bin centre
        assert xmax <= 1.0
    g = out["density_grid"].numpy()[:, 0]
    for b in range(8):
        if b in (3, 4):
            touched = g[b] > 0
            assert 0.3 < touched.mean() < 0.5            # 1 - exp(-1/2)
            assert (g[b][touched] == 1.0 + b).all()
        else:
            assert not g[b].any()
    np.testing.assert_allclose(float(out["mean_density"]),
                               g.clip(min=0).mean(), rtol=1e-6)
    np.testing.assert_array_equal(
        out["occ"].numpy().reshape(8, -1),
        g > min(float(out["mean_density"]), 10.0))
    # the same seed draws the same cells
    again = tdyn.update_dyn_density_grid(
        {**tdyn.init_dyn_grid_state(tcfg),
         "bin_cursor": torch.tensor(3, dtype=torch.int32)}, flat, tcfg,
        full=False, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(again["density_grid"].numpy()[:, 0], g)


def test_rebuild_fills_every_time_bin():
    """One reference-style full update refreshes bins_per_call = 8 of the 64
    bins; the port's rebuild sweeps until every bin is done."""
    jcfg, tcfg = _configs()
    once = tdyn.update_dyn_density_grid(tdyn.init_dyn_grid_state(tcfg),
                                        _density_torch(30.0), tcfg, full=True,
                                        generator=torch.Generator())
    assert once["occ"].numpy().reshape(64, -1).any(axis=1).sum() == 8
    js = jdyn.update_dyn_density_grid(jdyn.init_dyn_grid_state(jcfg),
                                      jnp.float32(30.0), _density_jax,
                                      jax.random.PRNGKey(0), jcfg, full=True)
    assert np.asarray(js["occ"]).reshape(64, -1).any(axis=1).sum() == 8
    st = tdyn.init_dyn_grid_state(tcfg)
    st["bin_cursor"] += 5               # from any cursor
    out = tdyn.rebuild_dyn_density_grid(st, _density_torch(30.0), tcfg,
                                        generator=torch.Generator())
    assert out["occ"].numpy().reshape(64, -1).any(axis=1).all()
    assert int(out["iter_density"]) == 1 and int(out["bin_cursor"]) == 5
    # the occupied blob follows the moving centre
    occ = out["occ"].numpy()[:, 0]
    for b in (0, 31, 63):
        cx, cy, cz = _centre((b + 0.5) / 64)
        idx = np.argwhere(occ[b]).mean(axis=0) / (H - 1) * 2 - 1
        assert np.abs(idx * (1 - 1 / H) - [cx, cy, cz]).max() < 0.25
