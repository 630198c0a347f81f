"""The port's bucketed renderer (render/fast_image.py:
render_image_bucketed, _termination_trim, _tile_major/_untile,
ops/marching_dense.py:subsample_intervals) and FastTrainer's pick of the
renderer, against the JAX package.

Tolerances:
- Frames of an analytic planar field (the same function in both packages):
  image atol 1e-5, depth atol 1e-4, as the reference's own bucketed tests
  hold bucketed against tiled.
- subsample_intervals and the tile layouts: equal.
- The termination trim on a narrow JAX-trained field: the trimmed interval
  masks equal (the plain field and the Pallas kernel in interpret mode
  agree to ~2.5e-4 in sigma, far from flipping a tap across tau).
- Frames of a CP field through the port's plain kernel versions against
  the reference's Pallas kernels in interpret mode: max |diff| 2e-2 (as
  tests/test_torch_dyn_slice.py holds served frames) and > 40 dB between
  the two frames (PERF.md's frame-fidelity rule).
- The tile pick (C6): the reference's 10 at 800x800 orbit views, 8 at the
  GUI's default camera; on narrow frames of small balls the pick's frame
  at least C6_MARGIN_DB (1 dB) closer to render_dense's per-ray frame than
  the reference's pick's.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from sealdnerf_tpu.models.cp import (CPConfig as JaxCPConfig,
                                     CPDNeRFConfig as JaxDynConfig,
                                     init_cp_dnerf, make_cp_field)
from sealdnerf_tpu.ops import marching_dense as jmd
from sealdnerf_tpu.ops.pallas_field import make_fused_dyn_forward_planar
from sealdnerf_tpu.render import fast_image as jfi
from sealdnerf_tpu.train import checkpoint as jax_ckpt
from sealdnerf_tpu.train.fast import FastTrainer as JaxFastTrainer
from sealdnerf_tpu.train.trainer import TrainOptions as JaxOptions
from sealdnerf_tpu_torch import cli
from sealdnerf_tpu_torch.models.cp import (CPDNeRFConfig, params_from_jax)
from sealdnerf_tpu_torch.ops import marching_dense as tmd
from sealdnerf_tpu_torch.ops.field import dyn_field_forward, pack_tables
from sealdnerf_tpu_torch.render import fast_image as tfi
from sealdnerf_tpu_torch.train.metrics import psnr

IMG_ATOL, DEP_ATOL = 1e-5, 1e-4
FIELD_ATOL = 2e-2
C6_MARGIN_DB = 1.0
SPLITS = ((0.55, 4), (0.30, 2), (1.0, 1))
TRIM_NARROW = dict(grid_size=32, march_res=16, n_intervals=8,
                   steps_per_interval=3)


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


def _ball_occ(res, r=0.5):
    g = np.linspace(-1, 1, res)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return (x ** 2 + y ** 2 + z ** 2) < r ** 2


def _ball_j(params, x3, d3):
    """TestBucketedRender's field, planar: a ball of radius 0.45."""
    r = jnp.sqrt(jnp.sum(x3 * x3, axis=0))
    return jnp.stack([jnp.where(r < 0.45, 80.0, 0.0),
                      jnp.clip(x3[0] + 0.5, 0, 1), jnp.clip(x3[1] + 0.5, 0, 1),
                      jnp.full_like(r, 0.5)])


def _ball_t(params, x3, d3):
    r = torch.sqrt((x3 * x3).sum(dim=0))
    return torch.stack([torch.where(r < 0.45, 80.0, 0.0),
                        (x3[0] + 0.5).clamp(0, 1), (x3[1] + 0.5).clamp(0, 1),
                        torch.full_like(r, 0.5)])


def _two_balls_j(params, x3, d3):
    """TestCascadeMarch's field, planar: balls at the origin and at 1.4."""
    r0 = jnp.sqrt(jnp.sum(x3 * x3, axis=0))
    dx = x3 - jnp.array([1.4, 0.0, 0.0])[:, None]
    r1 = jnp.sqrt(jnp.sum(dx * dx, axis=0))
    return jnp.stack([jnp.where(r0 < 0.4, 60.0, 0.0)
                      + jnp.where(r1 < 0.4, 60.0, 0.0),
                      jnp.where(r1 < 0.4, 0.9, 0.2),
                      jnp.where(r0 < 0.4, 0.8, 0.3), jnp.full_like(r0, 0.5)])


def _two_balls_t(params, x3, d3):
    r0 = torch.sqrt((x3 * x3).sum(dim=0))
    dx = x3 - torch.tensor([1.4, 0.0, 0.0])[:, None]
    r1 = torch.sqrt((dx * dx).sum(dim=0))
    return torch.stack([torch.where(r0 < 0.4, 60.0, 0.0)
                        + torch.where(r1 < 0.4, 60.0, 0.0),
                        torch.where(r1 < 0.4, 0.9, 0.2),
                        torch.where(r0 < 0.4, 0.8, 0.3),
                        torch.full_like(r0, 0.5)])


def _cam(rh, rw, z=-2.0, x=0.0, f=None):
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3], pose[0, 3] = z, x
    f = f or (float(rw), float(rh))
    return pose, np.array([f[0], f[1], rw / 2, rh / 2], np.float32)


def _cfgs(**kw):
    return jmd.DenseMarchConfig(**kw), tmd.DenseMarchConfig(**kw)


def _both(occ, cfgs, fwds, rh, rw, tp, pose, intr, bg, **kw):
    """The same bucketed frame through both packages, and the port's tiled
    one -> numpy (img_j, dep_j, img_b, dep_b, img_t, dep_t)."""
    (cj, ct), (fj, ft) = cfgs, fwds
    img_j, dep_j = jfi.render_image_bucketed(
        None, jnp.asarray(occ), jnp.asarray(pose), jnp.asarray(intr), rh, rw,
        cj, fj, jnp.asarray(bg), tile_px=tp, planar=True, **kw)
    img_b, dep_b = tfi.render_image_bucketed(
        None, _t(occ), _t(pose), _t(intr), rh, rw, ct, ft, _t(bg),
        tile_px=tp, **kw)
    img_t, dep_t = tfi.render_image_tiled(
        None, _t(occ), _t(pose), _t(intr), rh, rw, ct, ft, _t(bg),
        tile_px=tp)
    return (np.asarray(img_j), np.asarray(dep_j), img_b.numpy(),
            dep_b.numpy(), img_t.numpy(), dep_t.numpy())


def _tile_counts_and_budgets(occ, cfg, rh, rw, tp, pose, intr, splits):
    """The renderer's bucket assignment, replayed: each tile's interval
    count and the budget its bucket grants."""
    th, tw = rh // tp, rw // tp
    to, td, tnear, tfar = tfi._tile_rays(_t(pose), _t(intr), th, tw, tp, cfg)
    _, _, iv, _ = tfi._march_tiles(to, td, tnear, tfar, _t(occ), cfg, 1)
    counts = iv.sum(-1).numpy()
    order = np.argsort(counts, kind="stable")
    budgets = np.zeros(th * tw, np.int64)
    for s0, s1, sc_b in tfi.bucket_bounds(th * tw, cfg.n_intervals, splits):
        budgets[order[s0:s1]] = sc_b
    return counts, budgets


BALL_CFG = dict(bound=1.0, march_res=16, n_intervals=8, steps_per_interval=2)


def test_sparse_occupancy_matches_tiled_and_reference():
    """Every tile's count fits its bucket's budget: bucketed equals tiled,
    and the reference's bucketed frame."""
    occ = _ball_occ(16, r=0.3)
    cfgs = _cfgs(**BALL_CFG)
    pose, intr = _cam(32, 32)
    counts, budgets = _tile_counts_and_budgets(occ, cfgs[1], 32, 32, 4, pose,
                                               intr, SPLITS)
    assert (counts <= budgets).all() and (counts > 0).any()
    img_j, dep_j, img_b, dep_b, img_t, dep_t = _both(
        occ, cfgs, (_ball_j, _ball_t), 32, 32, 4, pose, intr,
        [0.1, 0.2, 0.3], splits=SPLITS)
    np.testing.assert_allclose(img_b, img_j, atol=IMG_ATOL)
    np.testing.assert_allclose(dep_b, dep_j, atol=DEP_ATOL)
    np.testing.assert_allclose(img_b, img_t, atol=IMG_ATOL)
    np.testing.assert_allclose(dep_b, dep_t, atol=DEP_ATOL)


def test_over_budget_occupancy_subsamples_like_the_reference():
    """A fat ball overflows the small buckets: the over-budget tiles are
    subsampled over their depth (the same frame as the reference's), the
    others equal the tiled frame, and geometry is coarsened, not cut."""
    occ = _ball_occ(16, r=0.85)
    cfgs = _cfgs(**BALL_CFG)
    pose, intr = _cam(32, 32)
    counts, budgets = _tile_counts_and_budgets(occ, cfgs[1], 32, 32, 4, pose,
                                               intr, SPLITS)
    over = counts > budgets
    assert over.any()
    img_j, dep_j, img_b, dep_b, img_t, dep_t = _both(
        occ, cfgs, (_ball_j, _ball_t), 32, 32, 4, pose, intr,
        [0.1, 0.2, 0.3], splits=SPLITS)
    np.testing.assert_allclose(img_b, img_j, atol=IMG_ATOL)
    np.testing.assert_allclose(dep_b, dep_j, atol=DEP_ATOL)
    diff = np.abs(img_b - img_t).max(axis=-1)
    tile_diff = diff.reshape(8, 4, 8, 4).max(axis=(1, 3)).reshape(-1)
    assert (tile_diff[~over] < IMG_ATOL).all()
    hit_t, hit_b = dep_t > 1e-3, dep_b > 1e-3
    assert (hit_t & ~hit_b).sum() <= 0.05 * hit_t.sum()
    assert np.abs(img_b - img_t).mean() < 0.01


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("splits", [SPLITS, ((0.55, 4), (0.30, 1), (1.0, 1))])
def test_empty_tiles_take_no_field_call(monkeypatch, group, splits):
    """A bucket renders its tiles from the first occupied one on, in whole
    groups of LIVE_TILE_GROUP, and adjacent buckets of one budget in one
    call: the field sees just those tiles' samples, in one call a run, and
    the frame equals the reference's, which renders every tile of a bucket
    that holds an interval."""
    occ = _ball_occ(16, r=0.3)
    cfgs = _cfgs(**BALL_CFG)
    pose, intr = _cam(32, 32)
    counts, _ = _tile_counts_and_budgets(occ, cfgs[1], 32, 32, 4, pose, intr,
                                         splits)
    first_live = int((counts == 0).sum())
    bounds = tfi.bucket_bounds(counts.size, 8, splits)
    want, budgets = 0, []
    for s0, s1, sc_b in bounds:
        live = s1 - min(max(s0, first_live), s1)
        n = min(s1 - s0, -(-live // group) * group)
        want += n * 16 * sc_b * 2
        if n and not (budgets and budgets[-1] == sc_b):
            budgets.append(sc_b)
    # some bucket holds empty tiles under its occupied ones
    assert 0 < want < sum((s1 - s0) * 16 * sc_b * 2 for s0, s1, sc_b in
                          bounds)
    seen = []

    def ball(params, x3, d3):
        seen.append(x3.shape[1])
        return _ball_t(params, x3, d3)
    monkeypatch.setattr(tfi, "LIVE_TILE_GROUP", group)
    img_j, dep_j, img_b, dep_b, _, _ = _both(
        occ, cfgs, (_ball_j, ball), 32, 32, 4, pose, intr,
        [0.1, 0.2, 0.3], splits=splits)
    # the bucketed frame's calls, then the tiled frame's one
    assert sum(seen[:-1]) == want and len(seen) - 1 == len(budgets)
    np.testing.assert_allclose(img_b, img_j, atol=IMG_ATOL)
    np.testing.assert_allclose(dep_b, dep_j, atol=DEP_ATOL)


def test_cascade_bucketed_matches_reference():
    """bound 2, two cascades, dt_gamma 1/128: the bucketed frame of the two
    balls equals the reference's, and lies near the tiled one (truncation
    only at the bucket boundaries)."""
    cfgs = _cfgs(bound=2.0, march_res=64, n_intervals=32,
                 steps_per_interval=4, min_near=0.05, cascades=2,
                 dt_gamma=1.0 / 128)
    occs = []
    for c in range(2):
        cb = min(2.0 ** c, 2.0)
        g = (np.arange(64) + 0.5) / 64 * 2.0 - 1.0
        x, y, z = np.meshgrid(g * cb, g * cb, g * cb, indexing="ij")
        p = np.stack([x, y, z], -1)
        occs.append((np.linalg.norm(p, axis=-1) < 0.5)
                    | (np.linalg.norm(p - [1.4, 0.0, 0.0], axis=-1) < 0.5))
    occ = np.stack(occs)
    pose, intr = _cam(64, 64, z=-3.2, x=0.7, f=(57.6, 57.6))
    img_j, dep_j, img_b, dep_b, img_t, _ = _both(
        occ, cfgs, (_two_balls_j, _two_balls_t), 64, 64, 8, pose, intr,
        [0.0, 0.0, 0.0], splits=SPLITS)
    np.testing.assert_allclose(img_b, img_j, atol=IMG_ATOL)
    np.testing.assert_allclose(dep_b, dep_j, atol=DEP_ATOL)
    assert np.quantile(np.abs(img_t - img_b), 0.98) < 0.05
    assert img_b[..., 0].max() > 0.5                # the outer ball


def test_subsample_intervals_identity_and_conservation():
    """Equal to the reference; an exact re-packing when count <= budget;
    coverage (sum of the stretched steps = count * voxel) kept and the
    entries an ascending subset when count > budget."""
    rng = np.random.RandomState(0)
    sc, vox = 12, 0.125
    counts = np.array([0, 1, 3, 4, 5, 7, 9, 12])
    te = np.zeros((len(counts), sc), np.float32)
    iv = np.zeros((len(counts), sc), bool)
    for r, c in enumerate(counts):
        te[r, :c] = np.sort(rng.rand(c)).astype(np.float32)
        iv[r, :c] = True
    for sc_b in (4, 6, 12):
        ref = jmd.subsample_intervals(jnp.asarray(te), jnp.asarray(iv), sc_b,
                                      voxel=vox)
        got = tmd.subsample_intervals(_t(te), _t(iv), sc_b, voxel=vox)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        o_te, o_iv, o_dt = (a.numpy() for a in got)
        for r, c in enumerate(counts):
            sel = o_te[r][o_iv[r]]
            np.testing.assert_allclose(o_dt[r][o_iv[r]].sum(), c * vox,
                                       rtol=1e-6)
            assert np.isin(sel, te[r, :c]).all()
            assert len(sel) <= 1 or (np.diff(sel) > 0).all()
            if c <= sc_b:
                assert len(sel) == c
                np.testing.assert_allclose(o_dt[r][o_iv[r]], vox)
            else:
                assert len(sel) == sc_b and sel[0] == te[r, 0]


def test_subsample_intervals_cascade_dt():
    """A run is priced at its first interval's step times its length."""
    te = np.arange(8, dtype=np.float32)[None] / 8.0
    iv = np.ones((1, 8), bool)
    dt = (np.arange(8, dtype=np.float32)[None] + 1) / 64
    got = tmd.subsample_intervals(_t(te), _t(iv), 4, iv_dt=_t(dt))
    ref = jmd.subsample_intervals(jnp.asarray(te), jnp.asarray(iv), 4,
                                  iv_dt=jnp.asarray(dt))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[1].all()
    np.testing.assert_allclose(got[2].numpy()[0], np.array([1, 3, 5, 7])
                               / 64 * 2)


def test_tile_major_round_trip():
    rng = np.random.default_rng(0)
    plane = rng.random((24, 40)).astype(np.float32)
    tiles = tfi._tile_major(_t(plane), 3, 5, 8)
    np.testing.assert_array_equal(
        tiles.numpy(), np.asarray(jfi._tile_major(jnp.asarray(plane), 3, 5,
                                                  8)))
    np.testing.assert_array_equal(tiles[7].numpy(),
                                  plane[8:16, 16:24].reshape(-1))
    np.testing.assert_array_equal(tfi._untile(tiles, 3, 5, 8).numpy(), plane)


def test_bucket_bounds_follow_the_reference_rounding():
    """round() of each split's share, the last split taking the rest."""
    b = tfi.bucket_bounds(6400, 64, ((0.60, 32), (0.15, 16), (0.15, 4),
                                     (0.07, 2), (1.0, 2)))
    assert b == [(0, 3840, 2), (3840, 4800, 4), (4800, 5760, 16),
                 (5760, 6208, 32), (6208, 6400, 32)]
    assert tfi.bucket_bounds(10, 8, ((0.25, 4), (0.25, 2), (1.0, 1))) == [
        (0, 2, 2), (2, 4, 4), (4, 10, 8)]


def test_use_buckets_gate():
    """FastTrainer._use_buckets, as the reference's: a broadly filled grid
    (early training) takes the tiled renderer, a sparse one the buckets;
    the share is read once and forgotten with the grid."""
    from sealdnerf_tpu_torch.train.fast import FastTrainer
    tr = object.__new__(FastTrainer)        # the gate reads only the grid
    tr.grid_state = {"occ": torch.ones((1, 16, 16, 16), dtype=torch.bool)}
    assert tr._use_buckets() is False and tr._occ_frac == 1.0
    occ = torch.zeros((1, 16, 16, 16), dtype=torch.bool)
    occ[0, 8, 8, 8] = True
    tr.grid_state = {"occ": occ}
    assert tr._occ_frac is None
    assert tr._use_buckets() is True


# --------------------------------------------- a narrow JAX-trained field
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The reference's termination-trim fixture (tests/test_models_render.
    py): a narrow CP field trained by the JAX FastTrainer for 6 segments
    of 64 steps on the 64 px scene, written as a checkpoint for the
    port."""
    ws = str(tmp_path_factory.mktemp("jax_trim"))
    _, train, val = jax_scene(n_train=8, n_val=1, res=64)
    opt = JaxOptions(iters=400, num_rays=512, bound=1.0, dt_gamma=0.0,
                     segment_steps=64, workspace=ws, preview_lod_min_res=48,
                     **TRIM_NARROW)
    field = make_cp_field(jax.random.PRNGKey(0), JaxCPConfig(
        bound=1.0, scales=((16, 8), (48, 16)), planes=()))
    tr = JaxFastTrainer("t", opt, field, workspace=ws,
                        use_checkpoint="scratch")
    tr.mark_untrained_grid(train.poses, train.intrinsics)
    data = train.device()
    h, w, c, n = train.h, train.w, train.images.shape[-1], len(train)
    for _ in range(6):
        tr.train_segment(data, h, w, c, n, 64)
    ckpt = os.path.join(ws, "trained.npz")
    jax_ckpt.save_checkpoint(ckpt, {
        "model": {"params": tr.params, "ema": tr.ema_params},
        "grid": tr.grid_state}, {"epoch": 6, "global_step": 384})
    return tr, val, ckpt


def _port(ckpt, ws):
    opt = cli.postprocess(cli.base_parser().parse_args(
        ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--device",
         "cpu", "--test", "--ckpt", ckpt, "--workspace", ws]))
    return cli.build_trainer(opt, name="t", preview_lod_min_res=48,
                             **TRIM_NARROW)[0]


@pytest.fixture(scope="module")
def port(trained, tmp_path_factory):
    return _port(trained[2], str(tmp_path_factory.mktemp("port_trim")))


def test_termination_trim_exact_and_effective(trained, port):
    """At tau 13.8 the trimmed frame equals the untrimmed one; at tau 0.02
    the trim acts; the trimmed interval sets equal the reference's."""
    tr, val, _ = trained
    rcfg = port.render_cfg
    occ_j = jmd.downsample_occ(tr.grid_state["occ"][0], rcfg.march_res)
    occ_t = port.cascade_occ(port.grid_state["occ"], rcfg)
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))
    tables = port.field.kernel_tables(port._infer_params())
    fwd = port._render_forward()
    pose, intr = _t(val.poses[0]), _t(val.intrinsics)
    kw = dict(tile_px=8, splits=((0.5, 4), (1.0, 1)))

    def render(term, tau=13.8):
        img, _ = tfi.render_image_bucketed(
            tables, occ_t, pose, intr, 64, 64, rcfg, fwd, torch.ones(3),
            term_probe=term, term_tau=tau, **kw)
        return img.numpy()

    base = render(0)
    np.testing.assert_array_equal(render(8), base)
    assert np.abs(render(8, tau=0.02) - base).max() > 0.05

    # the trimmed interval sets, tile by tile
    th = tw = 8
    to, td, tn, tf = tfi._tile_rays(pose, intr, th, tw, 8, rcfg)
    te, _, iv, _ = tfi._march_tiles(to, td, tn, tf, occ_t, rcfg, 1)
    jcfg = tr.render_cfg
    fj, _ = tr._render_forward_fn()
    for tau in (13.8, 7.0, 0.02):
        ref = jfi._termination_trim(
            tr._infer_params(), jnp.asarray(val.poses[0][:3, 3]),
            jnp.asarray(val.poses[0]), jnp.asarray(val.intrinsics) / 8, th,
            tw, 8, jnp.asarray(te.numpy()), jnp.asarray(iv.numpy()), None,
            jcfg, fj, True, 1.0, tau, 16, (), stride=2)
        got = tfi._termination_trim(
            tables, pose, intr / 8, th, tw, 8, te, iv, None,
            rcfg, fwd, 1.0, tau, 16, (), stride=2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(got.sum()) < int(iv.sum())


def test_trainer_picks_the_renderer_and_forgets_the_share(trained, port,
                                                          monkeypatch):
    """The pick below 15 % occupancy equals the reference's; the share is
    read once per grid version and forgotten whenever the grid changes."""
    tr, val, ckpt = trained
    share = float(np.mean(np.asarray(tr.grid_state["occ"])))
    tr._occ_frac = None
    assert share < 0.15                   # a trained field: the buckets
    assert port._use_buckets() and tr._use_buckets()
    assert port._occ_frac == pytest.approx(share)
    calls = []
    for name in ("render_image_tiled", "render_image_bucketed"):
        real = getattr(tfi, name)
        monkeypatch.setattr(
            "sealdnerf_tpu_torch.train.fast." + name,
            lambda *a, _n=name, _f=real, **kw: calls.append(_n) or _f(*a,
                                                                     **kw))
    port.render_image(val.poses[0], val.intrinsics, 32, 32)
    assert calls[-1] == "render_image_bucketed"
    port.render_image(val.poses[0], val.intrinsics, 30, 30)   # tile 1
    assert calls[-1] == "render_image_tiled"
    port.render_image(val.poses[0], val.intrinsics, 32, 32, buckets=False)
    assert calls[-1] == "render_image_tiled"
    # warm_renderers: one frame through each (at 64 px, where the pick
    # tiles the frame of its default camera; at 32 px it marches per ray)
    calls.clear()
    port.warm_renderers(64, 64)
    assert calls == ["render_image_tiled", "render_image_bucketed"]
    for change in (lambda: port.refresh_grid(), lambda: port.rebuild_grid(),
                   lambda: port.load_checkpoint(ckpt),
                   lambda: port.adopt_grid_state(port.grid_state),
                   lambda: port.mark_untrained_grid(val.poses,
                                                    val.intrinsics)):
        port._use_buckets()
        assert port._occ_frac is not None
        change()
        assert port._occ_frac is None
    port.load_checkpoint(ckpt)


def _reference_frame(tr, val, buckets, lod):
    """The reference trainer's inner renderer (before its wire packing) on
    view 0 at half resolution -> numpy (image, depth)."""
    inner = tr._build_renderer_inner(32, 32, tr._pick_tile(32, 32),
                                     buckets=buckets, lod=lod)
    occ = jmd.downsample_occ(tr.grid_state["occ"][0],
                             tr.render_cfg.march_res)
    img, dep = inner(tr._infer_params(), occ, jnp.asarray(val.poses[0]),
                     jnp.asarray(val.intrinsics) / 2, jnp.ones(3))
    return np.asarray(img), np.asarray(dep)


def _reference_pick(port, monkeypatch):
    """The port's trainer with the reference's tile pick (8 px at 32 px).
    The port's own pick tiles these 32 px frames by 2 (C6, see
    test_tile_pick_is_conservative). At 4 and 2 px tiles the reference's
    eval ladder subsamples tiles over their bucket's budget (the port's
    eval frames subsample none): there its bucketed frame lies 25.6 / 28.2
    dB from the per-ray frame, its one-bucket frame 45.1 / 50.1 dB. So the
    variants these tests hold are compared at the tile at which the
    reference serves them."""
    from sealdnerf_tpu_torch.train.fast import reference_tile
    monkeypatch.setattr(port, "_pick_tile", lambda rh, rw, *cam:
                        reference_tile(rh, rw, port.opt.render_tile_px))


@pytest.mark.parametrize("need_depth", [True, False])
def test_gui_frames_match_the_reference_inner_renderer(trained, port,
                                                       need_depth,
                                                       monkeypatch):
    """test_gui snaps the downscale to 1, 2, 4 or 8 (3 -> 2) and, without
    depth, renders the LOD preview (the res-48 line scale skipped, the
    preview ladder). It is the reference's inner renderer of the same
    variant, before its wire packing, on the same params and occupancy, at
    the reference's tile (_reference_pick)."""
    tr, val, _ = trained
    _reference_pick(port, monkeypatch)
    pose = val.poses[0]
    tr._occ_frac = None
    assert tr._use_buckets()
    want = _reference_frame(tr, val, True, not need_depth)
    out = port.test_gui(pose, val.intrinsics, 64, 64, downscale=3,
                        need_depth=need_depth)
    img = out["image"]
    assert img.shape == (32, 32, 3)
    assert (out["depth"] is None) == (not need_depth)
    assert np.abs(img - want[0]).max() <= FIELD_ATOL
    assert psnr(img, want[0]) > 40.0
    if need_depth:
        np.testing.assert_allclose(out["depth"], want[1], atol=FIELD_ATOL)
    # the LOD preview is another function of the field than the full frame
    other = port.test_gui(pose, val.intrinsics, 64, 64, downscale=3,
                          need_depth=not need_depth)["image"]
    assert np.abs(other - img).max() > 1e-3


def _orbit_800():
    """chip_smoke.py's 800x800 view (_orbit_view): radius 2, fov 0.9."""
    from sealdnerf_tpu_torch.data.rays import rand_poses
    fl = 800 / (2 * np.tan(0.45))
    return (rand_poses(np.random.default_rng(0), 1, radius=2.0)[0],
            np.array([fl, fl, 400, 400], np.float32))


@pytest.mark.parametrize("recipe", [["--bound", "1", "--dt_gamma", "0"], []],
                         ids=["bound1", "bound2-cascades"])
def test_tile_pick_is_conservative(recipe, tmp_path):
    """C6: at the CLI's render march (64^3, dilation 1) the pick keeps the
    reference's 10 at chip_smoke.py's 800x800 orbit views, and at the GUI's
    default camera (1920x1080, radius 5, fovy 50) a 10-px tile's footprint
    at the far corner of the box exceeds one march voxel, so it falls back
    to 8, which fits; the smaller GUI frames, which no tile of the
    reference's divides, stay per-ray."""
    from sealdnerf_tpu_torch.gui.orbit import OrbitCamera
    from sealdnerf_tpu_torch.train.fast import reference_tile, tile_fits
    opt = cli.postprocess(cli.base_parser().parse_args(
        ["synthetic", "--test", "--device", "cpu", "--ckpt", "scratch",
         "--workspace", str(tmp_path)] + recipe))
    tr = cli.build_trainer(opt, name="t")[0]
    rcfg = tr.render_cfg
    assert rcfg.march_res == 64 and tr.opt.render_dilate == 1
    pose, intr = _orbit_800()
    assert tr._pick_tile(800, 800, pose, intr) == 10 == \
        reference_tile(800, 800, 8)
    for seed in range(1, 9):             # other orbit views, also 10
        from sealdnerf_tpu_torch.data.rays import rand_poses
        p = rand_poses(np.random.default_rng(seed), 1, radius=2.0)[0]
        assert tr._pick_tile(800, 800, p, intr) == 10
    cam = OrbitCamera(1920, 1080, r=5.0, fovy=50.0)
    assert reference_tile(1080, 1920, 8) == 10
    assert not tile_fits(10, cam.pose, cam.intrinsics, rcfg, 1)
    assert tile_fits(8, cam.pose, cam.intrinsics, rcfg, 1)
    assert tr._pick_tile(1080, 1920, cam.pose, cam.intrinsics) == 8
    for ds in (2, 4, 8):
        assert tr._pick_tile(1080 // ds, 1920 // ds, cam.pose,
                             cam.intrinsics / ds) == 1


SPECKS = np.array([[0.3, 0.2, -0.4], [-0.5, 0.1, 0.2], [0.1, -0.6, 0.5],
                   [-0.2, -0.3, -0.6], [0.6, 0.5, 0.3], [0.0, 0.45, 0.0]],
                  np.float32)


def _specks_t(params, x3, d3):
    """Six balls of radius 0.05, the kind of detail a tile loses: density
    200 inside, each its own colour."""
    d2 = ((x3[None] - torch.from_numpy(SPECKS)[:, :, None]) ** 2).sum(1)
    inside = d2 < 0.05 ** 2
    k = inside.float().argmax(0).float() / len(SPECKS)
    sigma = torch.where(inside.any(0), 200.0, 0.0)
    return torch.stack([sigma, k, 1.0 - k, torch.full_like(k, 0.3)])


def test_tile_pick_frame_is_closer_to_per_ray():
    """C6 on narrow frames (64 and 128 px, fov 0.9, camera at 2.2) of small
    balls, at the CLI's render march (64^3, dilation 1): the reference's
    8-px tiles miss parts of the balls; the pick's tiles (1 and 2 px here)
    keep the frame at least C6_MARGIN_DB closer to render_dense's per-ray
    frame (measured: 95.5 against 27.0 dB at 64 px, 60.8 against 57.9 dB
    at 128 px)."""
    from types import SimpleNamespace
    from sealdnerf_tpu_torch.render.fast import render_dense
    from sealdnerf_tpu_torch.train.fast import FastTrainer, reference_tile
    cfg = tmd.DenseMarchConfig(bound=1.0, march_res=64, n_intervals=32,
                               steps_per_interval=4)
    picker = SimpleNamespace(
        opt=SimpleNamespace(render_tile_px=8, render_dilate=1),
        render_cfg=cfg)
    # the balls' voxels, conservatively: centres within r + a half voxel
    # diagonal
    g = (np.arange(64) + 0.5) / 64 * 2 - 1
    cells = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1)
    occ = np.zeros((64, 64, 64), bool)
    for c in SPECKS:
        occ |= np.linalg.norm(cells - c, axis=-1) < 0.05 + cfg.voxel * 0.87
    occ_t = torch.from_numpy(occ)
    bg = torch.ones(3)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -2.2

    def sfwd(params, x, d):
        out = _specks_t(params, x.t(), d.t())
        return out[0], out[1:4].t()
    for res, want in ((64, 1), (128, 2)):
        f = res / (2 * np.tan(0.45))
        intr = np.array([f, f, res / 2, res / 2], np.float32)
        tp = FastTrainer._pick_tile(picker, res, res, pose, intr)
        assert tp == want and reference_tile(res, res, 8) == 8
        rays = tfi.get_rays(_t(pose)[None], _t(intr), res, res, -1)
        exact = render_dense(None, occ_t, rays["rays_o"][0],
                             rays["rays_d"][0], cfg, sfwd,
                             bg_color=bg)["image"].clamp(0, 1)
        exact = exact.reshape(res, res, 3).numpy()
        p = {}
        for t in (tp, 8):
            img, _ = tfi.render_image_tiled(None, occ_t, _t(pose), _t(intr),
                                            res, res, cfg, _specks_t, bg,
                                            tile_px=t)
            p[t] = psnr(img.numpy(), exact)
        assert exact.min() < 0.5                  # the balls are in view
        assert p[tp] >= p[8] + C6_MARGIN_DB, (res, p)


@pytest.mark.parametrize("splits", [((1.0, 1),), ((0.5, 8), (1.0, 2))],
                         ids=["one-bucket", "harsh"])
def test_render_splits_reach_the_served_frame(trained, port, splits,
                                              monkeypatch):
    """TrainOptions.render_splits is the served frame's ladder: with one
    full-budget bucket (the trim alone) and with a harsher ladder than the
    default, render_image's bucketed frame is the reference's inner
    renderer under the same option, at the reference's tile
    (_reference_pick)."""
    import dataclasses
    tr, val, _ = trained
    _reference_pick(port, monkeypatch)
    opts = tr.opt, port.opt
    tr.opt = dataclasses.replace(tr.opt, render_splits=splits)
    port.opt = dataclasses.replace(port.opt, render_splits=splits)
    try:
        want = _reference_frame(tr, val, True, False)
        img, dep = port.render_image(val.poses[0], val.intrinsics, 64, 64,
                                     downscale=2, buckets=True)
    finally:
        tr.opt, port.opt = opts
    assert np.abs(img - want[0]).max() <= FIELD_ATOL
    assert psnr(img, want[0]) > 40.0
    np.testing.assert_allclose(dep, want[1], atol=FIELD_ATOL)
    assert img.min() < 0.9                   # not a blank background


def test_dynamic_bucketed_frame_matches_reference():
    """A narrow seeded time-conditioned field at t = 0.37, bucketed with
    the termination trim, through the port's plain K3 and the reference's
    Pallas kernel in interpret mode, on the same occupancy."""
    cfg_kw = dict(bound=1.0, scales=((16, 8), (64, 16)), planes=((16, 4),),
                  num_layers_deform=3, hidden_dim_deform=32)
    params = init_cp_dnerf(jax.random.PRNGKey(2), JaxDynConfig(**cfg_kw))
    tcfg = CPDNeRFConfig(**cfg_kw)
    tables = pack_tables(params_from_jax(jax.tree_util.tree_map(
        np.asarray, params)), tcfg)
    occ = _ball_occ(16, r=0.6)
    cj, ct = _cfgs(bound=1.0, march_res=16, n_intervals=8,
                   steps_per_interval=3)
    pose, intr = _cam(32, 32, z=-2.2, x=0.1)
    t = 0.37
    kw = dict(tile_px=8, splits=((0.5, 4), (1.0, 1)), term_probe=8,
              term_tau=7.0, term_stride=2)
    img_j, dep_j = jfi.render_image_bucketed(
        params, jnp.asarray(occ), jnp.asarray(pose), jnp.asarray(intr), 32,
        32, cj, make_fused_dyn_forward_planar(JaxDynConfig(**cfg_kw),
                                              interpret=True),
        jnp.ones(3), planar=True, extra=(jnp.float32(t),), **kw)
    img_t, dep_t = tfi.render_image_bucketed(
        tables, _t(occ), _t(pose), _t(intr), 32, 32, ct,
        lambda tb, x3, d3, tt: dyn_field_forward(tb, tcfg, x3, d3, tt),
        torch.ones(3), extra=(t,), **kw)
    img_j, img_t = np.asarray(img_j), img_t.numpy()
    assert np.abs(img_t - img_j).max() <= FIELD_ATOL
    assert psnr(img_t, img_j) > 40.0
    np.testing.assert_allclose(dep_t.numpy(), np.asarray(dep_j),
                               atol=FIELD_ATOL)
    assert img_t.min() < 0.9                   # not a blank background
