"""The port's cascade march (bound > 1 or dt_gamma > 0) against the JAX
package: DenseMarchConfig, _mip_from_val, the coarse ladder,
march_intervals_cascade, expand_intervals(iv_dt=), render_dense and
render_image_tiled on a cascade occupancy, the two-cascade grid refresh,
one bound-2 train step and main_nerf at the CLI's defaults.

Tolerances:
- The coarse ladder: the reference runs t <- t + clamp(t * g, lo, hi) as a
  sequential f32 scan, the port in closed form per phase
  (ops/marching_dense.py:coarse_ladder), which rounds once where the scan
  rounds at every step. Entries and steps within LADDER_TOL (a few f32
  ulps of t); the hit masks, counts and valid masks equal on the test rays.
- render_dense and the tiled frame: rtol 1e-4, atol 1e-5, as the
  single-cascade tests (tests/test_torch_march.py).
- The grid refresh, the train step: as tests/test_torch_train.py (the
  field kernel's bf16 tolerances, loss rtol 1e-3, grads 1e-2 of max |ref|).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.models.cp import CPConfig as JaxCPConfig, make_cp_field
from sealdnerf_tpu.ops import marching_dense as jmd
from sealdnerf_tpu.ops.marching import _mip_from_val as jax_mip
from sealdnerf_tpu.ops.pallas_field import (make_fused_forward_planar,
                                            make_fused_train_forward)
from sealdnerf_tpu.ops.ray import near_far_from_aabb as jax_near_far
from sealdnerf_tpu.render.fast import render_dense as jax_render_dense
from sealdnerf_tpu.render.fast_image import (
    render_image_tiled as jax_render_tiled)
from sealdnerf_tpu.render.grid import (GridConfig as JaxGridConfig,
                                       init_grid_state as jax_init_grid,
                                       mark_untrained_grid as jax_mark)
from sealdnerf_tpu.ops.marching import MarchConfig as JaxMarchConfig
from sealdnerf_tpu.train import checkpoint as jax_ckpt
from sealdnerf_tpu_torch import cli, main_nerf
from sealdnerf_tpu_torch.cli import base_parser, build_trainer, postprocess
from sealdnerf_tpu_torch.data.rays import get_rays
from sealdnerf_tpu_torch.models.cp import (CPConfig, CPDNeRFConfig,
                                           make_cp_dnerf_field, param_leaves,
                                           params_from_jax)
from sealdnerf_tpu_torch.ops import marching_dense as tmd
from sealdnerf_tpu_torch.ops.field import field_forward, pack_tables
from sealdnerf_tpu_torch.render import grid as tgrid
from sealdnerf_tpu_torch.render.fast import render_dense
from sealdnerf_tpu_torch.render.fast_image import render_image_tiled
from sealdnerf_tpu_torch.train.fast import FastTrainer
from sealdnerf_tpu_torch.train.trainer import TrainOptions

LADDER_TOL = dict(rtol=1e-6, atol=1e-6)
IMG_TOL = dict(rtol=1e-4, atol=1e-5)
BALL = np.array([1.4, 0.0, 0.0], np.float32)
CONFIGS = {
    "bound2": dict(bound=2.0, cascades=2, dt_gamma=1.0 / 128),
    "bound2_fixed": dict(bound=2.0, cascades=2, dt_gamma=0.0),
    "bound4": dict(bound=4.0, cascades=3, dt_gamma=1.0 / 128),
}
NARROW = dict(grid_size=32, march_res=16, n_intervals=6, steps_per_interval=3)
SCALES = ((16, 8), (64, 16))


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


def _cfgs(**kw):
    base = dict(march_res=64, n_intervals=32, steps_per_interval=4,
                min_near=0.05)
    base.update(kw)
    return jmd.DenseMarchConfig(**base), tmd.DenseMarchConfig(**base)


def _fwd_j(params, x, d):
    """The reference's TestCascadeMarch field: a ball at the origin (inside
    cascade 0) and one at radius 1.4 (cascade 1 only)."""
    r0 = jnp.linalg.norm(x, axis=-1)
    r1 = jnp.linalg.norm(x - jnp.asarray(BALL), axis=-1)
    sigma = jnp.where(r0 < 0.4, 60.0, 0.0) + jnp.where(r1 < 0.4, 60.0, 0.0)
    rgb = jnp.stack([jnp.where(r1 < 0.4, 0.9, 0.2),
                     jnp.where(r0 < 0.4, 0.8, 0.3),
                     jnp.broadcast_to(0.5, x.shape[:-1])], -1)
    return sigma, rgb


def _fwd_t(params, x, d):
    r0 = torch.linalg.vector_norm(x, dim=-1)
    r1 = torch.linalg.vector_norm(x - torch.from_numpy(BALL), dim=-1)
    sigma = torch.where(r0 < 0.4, 60.0, 0.0) + torch.where(r1 < 0.4, 60.0,
                                                           0.0)
    rgb = torch.stack([torch.where(r1 < 0.4, 0.9, 0.2),
                       torch.where(r0 < 0.4, 0.8, 0.3),
                       torch.full(x.shape[:-1], 0.5)], -1)
    return sigma, rgb


def _planar_j(params, x3, d3):
    sigma, rgb = _fwd_j(params, x3.T, d3.T)
    return jnp.concatenate([sigma[None], rgb.T], axis=0)


def _planar_t(params, x3, d3):
    sigma, rgb = _fwd_t(params, x3.t(), d3.t())
    return torch.cat([sigma[None], rgb.t()], dim=0)


def _occ_cas(hres, cascades, bound):
    """The two balls' occupancy per cascade (the reference test's)."""
    occs = []
    for c in range(cascades):
        cb = min(2.0 ** c, bound)
        g = (np.arange(hres) + 0.5) / hres * 2.0 - 1.0
        x, y, z = np.meshgrid(g * cb, g * cb, g * cb, indexing="ij")
        p = np.stack([x, y, z], -1)
        occs.append((np.linalg.norm(p, axis=-1) < 0.5)
                    | (np.linalg.norm(p - BALL, axis=-1) < 0.5))
    return np.stack(occs)


def _rays(n=128):
    """The reference test's rays: from a shell at radius 3.5, aimed near
    one ball or the other."""
    rng = np.random.RandomState(0)
    o = rng.randn(n, 3).astype(np.float32)
    o /= np.linalg.norm(o, axis=1, keepdims=True)
    o *= 3.5
    target = np.where(rng.rand(n, 1) < 0.5, np.zeros((n, 3), np.float32),
                      BALL[None])
    d = target + rng.randn(n, 3).astype(np.float32) * 0.1 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _near_far(o, d, bound, min_near):
    aabb = jnp.array([-bound] * 3 + [bound] * 3, jnp.float32)
    n, f = jax_near_far(jnp.asarray(o), jnp.asarray(d), aabb, min_near)
    return np.asarray(n), np.asarray(f)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_march_config_matches_reference(name):
    cj, ct = _cfgs(**CONFIGS[name])
    assert ct.multi and cj.multi
    for prop in ("voxel", "coarse_growth", "k_coarse", "samples_per_ray",
                 "dt"):
        assert getattr(ct, prop) == getattr(cj, prop), prop
    for c in range(ct.cascades):
        assert ct.cas_bound(c) == cj.cas_bound(c)
        assert ct.vox(c) == cj.vox(c)
    single = tmd.DenseMarchConfig(bound=1.0)
    assert not single.multi and single.k_coarse == jmd.DenseMarchConfig(
        bound=1.0).k_coarse


def test_mip_from_val_matches_reference():
    """At and between powers of two (frexp rounds exact powers up), and
    clamped to the cascades."""
    powers = 2.0 ** np.arange(-3, 5)
    vals = np.concatenate([powers, np.nextafter(powers, 0),
                           np.nextafter(powers, 10), powers * 1.5,
                           [0.0, 1e-12, 0.3, 7.9, 100.0]]).astype(np.float32)
    for cas in (1, 2, 3, 5):
        got = tmd._mip_from_val(_t(vals), cas).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jax_mip(jnp.asarray(vals), cas)))


@pytest.mark.parametrize("name", ["bound2", "bound4"])
def test_coarse_ladder_matches_the_scan(name):
    """The port's closed-form ladder against the reference's sequential
    scan, from 4096 near distances over the whole range."""
    _, ct = _cfgs(**CONFIGS[name])
    g, lo, hi = ct.coarse_growth, ct.vox(0), ct.vox(ct.cascades - 1)
    nears = np.random.default_rng(0).uniform(
        ct.min_near, 2 * 1.7320508 * ct.bound, 4096).astype(np.float32)

    def step(t, _):
        dt = jnp.clip(t * g, lo, hi)
        return t + dt, (t, dt)

    _, (t_ref, dt_ref) = jax.lax.scan(step, jnp.asarray(nears), None,
                                      length=ct.k_coarse)
    t_got, dt_got = tmd.coarse_ladder(_t(nears), ct)
    np.testing.assert_allclose(t_got.numpy(), np.asarray(t_ref).T,
                               **LADDER_TOL)
    np.testing.assert_allclose(dt_got.numpy(), np.asarray(dt_ref).T,
                               **LADDER_TOL)


@pytest.mark.parametrize("name", ["bound2", "bound2_fixed"])
def test_march_intervals_cascade_matches_reference(name):
    cj, ct = _cfgs(**CONFIGS[name])
    occ = _occ_cas(64, 2, 2.0)
    o, d = _rays()
    nears, fars = _near_far(o, d, 2.0, cj.min_near)
    te0, dt0, iv0 = jmd.march_intervals_cascade(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(nears),
        jnp.asarray(fars), jnp.asarray(occ), cj)
    te1, dt1, iv1 = tmd.march_intervals_cascade(_t(o), _t(d), _t(nears),
                                                _t(fars), _t(occ), ct)
    np.testing.assert_array_equal(iv1.numpy(), np.asarray(iv0))
    assert int(iv1.sum()) > 200
    np.testing.assert_allclose(te1.numpy(), np.asarray(te0), **LADDER_TOL)
    np.testing.assert_allclose(dt1.numpy(), np.asarray(dt0), **LADDER_TOL)
    # both cascades' steps were kept
    assert len(np.unique(dt1.numpy()[iv1.numpy()])) > 1 or \
        name == "bound2_fixed"


def test_expand_intervals_with_steps(rng):
    """expand_intervals(iv_dt=): each interval's samples at its own pitch
    dt / F, with the fine-phase noise."""
    cj, ct = _cfgs(**CONFIGS["bound2"])
    n, sc = 50, 32
    te = np.sort(rng.uniform(0.5, 6.0, (n, sc)), axis=1).astype(np.float32)
    iv = rng.random((n, sc)) < 0.6
    dt = rng.choice([ct.vox(0), ct.vox(1)], (n, sc)).astype(np.float32)
    fars = rng.uniform(3.0, 7.0, n).astype(np.float32)
    noise = rng.random(n).astype(np.float32)
    e0 = jmd.expand_intervals(jnp.asarray(te), jnp.asarray(iv),
                              jnp.asarray(fars), cj, noise=jnp.asarray(noise),
                              iv_dt=jnp.asarray(dt))
    e1 = tmd.expand_intervals(_t(te), _t(iv), _t(fars), ct, noise=_t(noise),
                              iv_dt=_t(dt))
    for k in ("valid", "counts"):
        np.testing.assert_array_equal(e1[k].numpy(), np.asarray(e0[k]))
    for k in ("ts", "dts"):
        np.testing.assert_allclose(e1[k].numpy(), np.asarray(e0[k]),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["bound2", "bound2_fixed"])
def test_render_dense_cascade(name):
    cj, ct = _cfgs(**CONFIGS[name])
    occ = _occ_cas(64, 2, 2.0)
    o, d = _rays()
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    ref = jax_render_dense(None, jnp.asarray(occ), jnp.asarray(o),
                           jnp.asarray(d), cj, _fwd_j,
                           bg_color=jnp.asarray(bg))
    got = render_dense(None, _t(occ), _t(o), _t(d), ct, _fwd_t,
                       bg_color=_t(bg))
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   **IMG_TOL)
    assert int(got["n_samples"]) == int(ref["n_samples"])
    assert float(got["weights_sum"].max()) > 0.9


def test_outer_cascade_geometry_is_reached():
    """A ray aimed only at the ball at radius 1.4 shades it: marching one
    cascade of bound 1 would miss everything beyond [-1, 1]."""
    cj, ct = _cfgs(**CONFIGS["bound2"])
    occ = _occ_cas(64, 2, 2.0)
    o = np.array([[1.4, 0.0, -3.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    got = render_dense(None, _t(occ), _t(o), _t(d), ct, _fwd_t,
                       bg_color=torch.zeros(3))
    ref = jax_render_dense(None, jnp.asarray(occ), jnp.asarray(o),
                           jnp.asarray(d), cj, _fwd_j, bg_color=jnp.zeros(3))
    img = got["image"].numpy()[0]
    assert img[0] > 0.5, img                                 # the red ball
    assert float(got["weights_sum"][0]) > 0.9
    np.testing.assert_allclose(img, np.asarray(ref["image"])[0], **IMG_TOL)


def test_render_image_tiled_cascade():
    """The tiled renderer on a cascade occupancy at tile 8: each cascade
    dilated on its own, the far side padded by the coarsest voxel."""
    cj, ct = _cfgs(**CONFIGS["bound2"])
    occ = _occ_cas(64, 2, 2.0)
    rh = rw = 64
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3], pose[0, 3] = -3.2, 0.7
    intr = np.array([rh * 0.9, rh * 0.9, rw / 2, rh / 2], np.float32)
    img0, dep0 = jax_render_tiled(None, jnp.asarray(occ), jnp.asarray(pose),
                                  jnp.asarray(intr), rh, rw, cj, _planar_j,
                                  jnp.zeros(3), tile_px=8, planar=True)
    img1, dep1 = render_image_tiled(None, _t(occ), _t(pose), _t(intr), rh, rw,
                                    ct, _planar_t, torch.zeros(3), tile_px=8)
    np.testing.assert_allclose(img1.numpy(), np.asarray(img0), **IMG_TOL)
    np.testing.assert_allclose(dep1.numpy(), np.asarray(dep0), **IMG_TOL)
    assert img1.numpy()[..., 0].max() > 0.5                 # outer ball


def _jax_init(tmp_path, bound=2.0):
    """A narrow JAX CP field at `bound` without planes, as a checkpoint for
    the port, and its params."""
    field = make_cp_field(jax.random.PRNGKey(0), JaxCPConfig(
        bound=bound, scales=SCALES, planes=()))
    params = jax.tree_util.tree_map(np.asarray, field.params)
    path = str(tmp_path / "init.npz")
    jax_ckpt.save_checkpoint(path, {"model": {"params": params,
                                              "ema": params}},
                             {"epoch": 0, "global_step": 0})
    return path, jax.tree_util.tree_map(jnp.asarray, params)


def _port_trainer(ckpt, ws, extra=()):
    """The port's trainer at the CLI's defaults (bound 2, dt_gamma 1/128)
    with the narrow grid and march."""
    opt = postprocess(base_parser().parse_args(
        ["synthetic", "-O", "--device", "cpu", "--ckpt", ckpt,
         "--workspace", ws, "--num_rays", "128", *extra]))
    return build_trainer(opt, name="t", **NARROW)[0]


def test_grid_refresh_two_cascades_matches_jax(tmp_path):
    """Frustum marking and one refresh of both cascades on fixed cells and
    jitter: each cascade swept over [-min(2^c, bound), ..]^3 with its own
    jitter (the reference FastTrainer's grid_update), the threshold over
    both."""
    ckpt, params = _jax_init(tmp_path)
    jcfg = JaxCPConfig(bound=2.0, scales=SCALES, planes=())
    tcfg = CPConfig(bound=2.0, scales=SCALES, planes=())
    tables = pack_tables(params_from_jax(jax.tree_util.tree_map(
        np.asarray, params)), tcfg)
    hh, cas, bound = 32, 2, 2.0
    h3 = hh ** 3
    rng = np.random.default_rng(3)
    dg = rng.uniform(0.0, 30.0, (cas, h3)).astype(np.float32)
    dg[rng.random((cas, h3)) < 0.2] = -1.0
    # duplicates allowed: the jitter is a function of the cell, so that
    # whichever duplicate lands gives the same value
    idx = rng.integers(0, h3, h3 // 2)
    u = rng.random((cas, h3, 3)).astype(np.float32)[:, idx]

    # the reference's sweep, one cascade after the other
    fwd = make_fused_forward_planar(jcfg, interpret=True)
    ij = jnp.asarray(idx, jnp.int32)
    coords = jnp.stack([ij // (hh * hh), (ij // hh) % hh, ij % hh],
                       -1).astype(jnp.float32)
    xyz01 = 2.0 * coords / (hh - 1) - 1.0
    new = []
    for c in range(cas):
        cb = min(float(1 << c), bound)
        half = cb / hh
        pts = xyz01 * (cb - half) + (jnp.asarray(u[c]) * 2 - 1) * half
        d3 = jnp.zeros((3, pts.shape[0])).at[2].set(1.0)
        sig = fwd(params, pts.T, d3)[0]
        tmp = jnp.full((h3,), -1.0).at[ij].set(sig)
        dgc = jnp.asarray(dg[c])
        valid = (dgc >= 0) & (tmp >= 0)
        new.append(jnp.where(valid, jnp.maximum(dgc * 0.95, tmp), dgc))
    ref_dg = jnp.stack(new)
    ref_occ = np.asarray(ref_dg > jnp.minimum(
        jnp.mean(jnp.clip(ref_dg, 0.0, None)), 10.0)).reshape(
        cas, hh, hh, hh)

    gcfg = tgrid.GridConfig(bound=bound, cascades=cas, grid_size=hh,
                            density_thresh=10.0)
    st = tgrid.init_grid_state(gcfg)
    st["density_grid"] = torch.from_numpy(dg)
    got = tgrid.update_density_grid(
        st, lambda p: field_forward(tables, tcfg, p.t().contiguous(), None,
                                    density_only=True)[0],
        gcfg, indices=torch.from_numpy(idx), noise_u=torch.from_numpy(u))
    np.testing.assert_allclose(got["density_grid"].numpy(),
                               np.asarray(ref_dg), rtol=2e-2, atol=1e-4)
    for c in range(cas):
        assert (got["occ"].numpy()[c] == ref_occ[c]).mean() >= 0.999
        assert (got["density_grid"].numpy()[c] != dg[c]).any()

    # frustum marking of both cascades
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -3.0
    intr = np.array([20.0, 20.0, 8.0, 8.0], np.float32)
    jst = jax_mark(jax_init_grid(JaxGridConfig(
        march=JaxMarchConfig(bound=bound, cascades=cas, grid_size=hh))),
        jnp.asarray(pose[None]), jnp.asarray(intr), JaxGridConfig(
            march=JaxMarchConfig(bound=bound, cascades=cas, grid_size=hh)))
    tst = tgrid.mark_untrained_grid(tgrid.init_grid_state(gcfg),
                                    _t(pose[None]), _t(intr), gcfg)
    np.testing.assert_array_equal(tst["density_grid"].numpy(),
                                  np.asarray(jst["density_grid"]))
    assert (tst["density_grid"].numpy() == -1).any(axis=1).all()


def test_one_bound2_train_step_matches_jax(tmp_path):
    """One deterministic train step of the CLI-default recipe (bound 2, two
    cascades, dt_gamma 1/128, no VM planes) against value_and_grad of the
    MSE of JAX render_dense through the fused Pallas field in interpret
    mode, on a two-cascade occupancy."""
    ckpt, params = _jax_init(tmp_path)
    tr = _port_trainer(ckpt, str(tmp_path / "p"))
    assert tr.field.cfg.planes == () and tr.field.cfg.scales == SCALES
    mc = tr.march_cfg
    assert (mc.bound, mc.cascades, mc.dt_gamma, mc.n_intervals) == (
        2.0, 2, 1.0 / 128, 12)
    rng = np.random.default_rng(5)
    n = 128
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -3.0
    intr = np.array([28.0, 28.0, 16.0, 16.0], np.float32)
    inds = rng.integers(0, 32 * 32, (1, n))
    rays = get_rays(_t(pose[None]), _t(intr), 32, 32, inds=_t(inds))
    ro, rd = (rays[k][0].contiguous().numpy() for k in ("rays_o", "rays_d"))
    bg = rng.random((n, 3)).astype(np.float32)
    gt = rng.random((n, 3)).astype(np.float32)
    occ = rng.random((2, 16, 16, 16)) < 0.5

    jcfg = jmd.DenseMarchConfig(bound=2.0, march_res=16, n_intervals=12,
                                steps_per_interval=3, min_near=0.2,
                                cascades=2, dt_gamma=1.0 / 128)
    fwd = make_fused_train_forward(JaxCPConfig(bound=2.0, scales=SCALES,
                                               planes=()),
                                   interpret=True, tile=256)

    def loss_j(p):
        res = jax_render_dense(p, jnp.asarray(occ), jnp.asarray(ro),
                               jnp.asarray(rd), jcfg, fwd,
                               bg_color=jnp.asarray(bg))
        return jnp.mean((res["image"] - gt) ** 2)

    l_j, g_j = jax.value_and_grad(loss_j)(params)
    tr._occ_m = _t(occ)
    loss, n_samples = tr.loss_on(_t(ro), _t(rd), _t(gt), _t(bg))
    loss.backward()
    assert int(n_samples) > n
    np.testing.assert_allclose(float(loss.detach()), float(l_j), rtol=1e-3)
    for (k, a), p in zip(jax.tree_util.tree_leaves_with_path(g_j),
                         param_leaves(tr.params)):
        a = np.asarray(a)
        err = np.abs(p.grad.numpy() - a).max() / (np.abs(a).max() + 1e-12)
        assert err <= 1e-2, (jax.tree_util.keystr(k), err)


def test_march_occ_takes_every_cascade(tmp_path):
    """The training march and the frames read the occupancy of both
    cascades (the reference's vmap over cascades), and a refresh writes
    cells of both."""
    tr = _port_trainer("scratch", str(tmp_path))
    occ = tr.grid_state["occ"]
    assert occ.shape == (2, 32, 32, 32)
    tr.refresh_grid()
    assert tr._occ_m.shape == (2, 16, 16, 16)
    dg = tr.grid_state["density_grid"]
    assert bool((dg[0] > 0).any()) and bool((dg[1] > 0).any())
    tr.grid_state["occ"][1] = False
    np.testing.assert_array_equal(
        FastTrainer.cascade_occ(tr.grid_state["occ"], tr.render_cfg)[1],
        np.zeros((16, 16, 16), bool))


def test_fast_trainer_scope(tmp_path):
    """A static field trains at bound 2 and at dt_gamma > 0; a dynamic one
    at bound > 1 is still refused, as in the reference."""
    _port_trainer("scratch", str(tmp_path / "s"))
    _port_trainer("scratch", str(tmp_path / "g"), extra=[
        "--bound", "1", "--dt_gamma", str(1 / 128)])
    field = make_cp_dnerf_field(torch.Generator().manual_seed(0),
                                CPDNeRFConfig(bound=2.0, planes=()), "cpu")
    with pytest.raises(ValueError, match="bound <= 1"):
        FastTrainer("t", TrainOptions(bound=2.0, workspace=str(tmp_path)),
                    field, use_checkpoint="scratch", device="cpu",
                    time_conditioned=True)


def test_main_nerf_at_the_cli_defaults_on_the_cpu(tmp_path, monkeypatch):
    """`main_nerf synthetic -O --device cpu` with no --bound or --dt_gamma
    (bound 2, dt_gamma 1/128, no VM planes) end to end at a tiny size: the
    full-width seeded field, one epoch of 16 steps of 64 rays, evaluation,
    frames, and a checkpoint that --test then serves."""
    monkeypatch.setattr(
        main_nerf, "build_trainer",
        lambda opt, **kw: cli.build_trainer(opt, **kw, **NARROW,
                                            segment_steps=16))
    monkeypatch.setattr(main_nerf, "MESH_RESOLUTION", 32)
    ws = str(tmp_path)
    base = ["synthetic", "-O", "--device", "cpu", "--synthetic_res", "32",
            "--workspace", ws]
    main_nerf.main(base + ["--ckpt", "scratch", "--iters", "16",
                           "--num_rays", "64"])
    assert len([f for f in os.listdir(os.path.join(ws, "results"))
                if f.endswith(".png")]) == 6
    assert os.listdir(os.path.join(ws, "meshes")) == ["ngp_1.ply"]
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert "[epoch 1]" in log and "step=48" in log and "PSNR" in log
    main_nerf.main(base + ["--test"])
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert "loaded checkpoint" in log and "(epoch 1, step 48)" in log
    opt = postprocess(base_parser().parse_args(base + ["--test"]))
    assert (opt.bound, opt.dt_gamma, opt.planes) == (2.0, 1 / 128, "auto")
