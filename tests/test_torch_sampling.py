"""The port's training samplers against the JAX package's: patches, the
error map and its update, and host-resident images (--no_preload).
Tolerances:
- patch indices: equal to the reference's formula (data/rays.py:55-66) for
  the same patch corners; the rays of any indices within 1e-6;
- error-map draws (both packages, 65,536 a row): the share landing in the
  map's top-decile cells within 5 binomial standard deviations of their
  mass, and every jittered pixel inside its cell's block and the image;
- update_error_map against the reference's `.at[ic].set` within 1e-6 on
  cells drawn once; on a cell drawn twice either package may keep either
  ray's value (scatter order is unspecified in both), so the port's value
  must be one of the candidates;
- --no_preload: the pixels gathered on the host equal the preloaded gather
  exactly; a narrow FastTrainer trained from host-resident images (96
  steps, with and without the error map) draws what the preloaded run of
  its seed draws, so its losses, error map and val PSNR equal that run's
  exactly on the CPU (the reference's own test, tests/test_train_e2e.py:
  96-205, can only ask for a loss within 4x and 1.5 dB: its host path
  draws from another generator); both learn;
- both trainers with --error_map: after a step the map moved exactly at
  the step's cells, to 0.1 + 0.9 x the rays' MSE; with --patch_size the
  loss carries the positive patch term.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.data import rays as jrays
from sealdnerf_tpu_torch.data.provider import host_pixels
from sealdnerf_tpu_torch.data.rays import (error_map_inds, get_rays,
                                           patch_inds)
from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
from sealdnerf_tpu_torch.models.cp import CPConfig, make_cp_field
from sealdnerf_tpu_torch.train.fast import FastTrainer
from sealdnerf_tpu_torch.train.trainer import (Trainer, TrainOptions,
                                               update_error_map)

N_DRAWS = 65536
SIGMAS = 5.0


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _reference_patch_inds(ix, iy, p, w):
    """The reference's patch layout (data/rays.py:55-66)."""
    b = ix.shape[0]
    px, py = jnp.meshgrid(jnp.arange(p), jnp.arange(p), indexing="ij")
    offs = jnp.stack([px.reshape(-1), py.reshape(-1)], -1)
    gx = ix[..., None] + offs[None, None, :, 0]
    gy = iy[..., None] + offs[None, None, :, 1]
    return np.asarray((gx * w + gy).reshape(b, -1))


@pytest.mark.parametrize("p", [2, 8])
def test_patch_layout_matches_reference(p):
    h, w = 40, 56
    rng = np.random.default_rng(p)
    ix = rng.integers(0, h - p, (2, 7))
    iy = rng.integers(0, w - p, (2, 7))
    got = patch_inds(torch.from_numpy(ix), torch.from_numpy(iy), p, w)
    want = _reference_patch_inds(jnp.asarray(ix), jnp.asarray(iy), p, w)
    np.testing.assert_array_equal(got.numpy(), want)
    # get_rays draws whole patches inside the image, patch-major
    _, ds, _ = make_synthetic_scene(n_train=2, n_val=1, res=32)
    g = torch.Generator().manual_seed(0)
    n = 5 * p * p + 3
    r = get_rays(torch.from_numpy(ds.poses[:1]),
                 torch.from_numpy(ds.intrinsics), h, w, n, generator=g,
                 patch_size=p)
    inds = r["inds"][0].numpy()
    assert inds.shape == (5 * p * p,) and r["rays_o"].shape == (1, 5 * p * p,
                                                                3)
    rows, cols = inds // w, inds % w
    patches = inds.reshape(5, p * p)
    np.testing.assert_array_equal(
        patches, _reference_patch_inds(jnp.asarray(rows[::p * p][None]),
                                       jnp.asarray(cols[::p * p][None]), p,
                                       w).reshape(5, p * p))
    assert rows.max() < h and cols.max() < w
    # the rays of the drawn pixels are the reference's
    jr = jrays.get_rays(None, jnp.asarray(ds.poses[:1]),
                        jnp.asarray(ds.intrinsics), h, w,
                        inds=jnp.asarray(inds[None]))
    np.testing.assert_allclose(r["rays_d"].numpy(), np.asarray(jr["rays_d"]),
                               atol=1e-6)


def _peaked_map(rows=2, seed=0):
    """[rows, 128^2] weights: the top decile of the cells (a random tenth)
    weighs 9, the rest 1 -> (map, top mask, the top cells' mass share)."""
    rng = np.random.default_rng(seed)
    emap = np.ones((rows, 128 * 128), np.float32)
    top = np.zeros_like(emap, bool)
    for r in range(rows):
        top[r, rng.choice(128 * 128, 128 * 128 // 10, replace=False)] = True
    emap[top] = 9.0
    mass = emap[0][top[0]].sum() / emap[0].sum()
    return emap, top, mass


def _check_share(ic, top, mass, tag):
    share = np.mean([top[r, ic[r]].mean() for r in range(ic.shape[0])])
    sigma = np.sqrt(mass * (1 - mass) / (ic.shape[0] * ic.shape[1]))
    assert abs(share - mass) <= SIGMAS * sigma, (tag, share, mass, sigma)


def test_error_map_draws_follow_the_map():
    h, w = 100, 150                 # no multiples of 128: uneven blocks
    emap, top, mass = _peaked_map()
    g = torch.Generator().manual_seed(1)
    inds, ic = error_map_inds(torch.from_numpy(emap), h, w, N_DRAWS, g)
    inds, ic = inds.numpy(), ic.numpy()
    _check_share(ic, top, mass, "port")
    # the jitter stays in the drawn cell's block and in the image
    ix, iy = inds // w, inds % w
    cx, cy = ic // 128, ic % 128
    sx, sy = h / 128, w / 128
    assert (ix >= np.floor(cx * sx)).all() and (ix < (cx + 1) * sx).all()
    assert (iy >= np.floor(cy * sy)).all() and (iy < (cy + 1) * sy).all()
    assert ix.max() <= h - 1 and iy.max() <= w - 1
    # get_rays returns the cells beside the pixels
    _, ds, _ = make_synthetic_scene(n_train=2, n_val=1, res=32)
    r = get_rays(torch.from_numpy(ds.poses[:2]),
                 torch.from_numpy(ds.intrinsics), h, w, 4096, generator=g,
                 error_map=torch.from_numpy(emap))
    assert r["inds_coarse"].shape == (2, 4096)
    # the reference's draws on the same map
    jr = jrays.get_rays(jax.random.PRNGKey(0), jnp.asarray(ds.poses[:2]),
                        jnp.asarray(ds.intrinsics), h, w, N_DRAWS,
                        error_map=jnp.asarray(emap))
    _check_share(np.asarray(jr["inds_coarse"]), top, mass, "reference")


def test_update_error_map_matches_reference():
    rng = np.random.default_rng(2)
    emap = rng.uniform(0.1, 2.0, (3, 128 * 128)).astype(np.float32)
    once = rng.choice(128 * 128, 500, replace=False)
    twice = once[:20]
    ic = np.concatenate([once, twice])
    err = rng.uniform(0, 0.5, ic.shape).astype(np.float32)
    # the reference's update (train/fast.py:519-528)
    row = jnp.asarray(emap[1])
    ic_j = jnp.asarray(ic)
    want = np.asarray(row.at[ic_j].set(0.1 * row[ic_j] + 0.9 * err))
    got = update_error_map(torch.from_numpy(emap.copy()), torch.tensor([1]),
                           torch.from_numpy(ic), torch.from_numpy(err))
    got = got.numpy()
    np.testing.assert_array_equal(got[[0, 2]], emap[[0, 2]])
    single = once[20:]
    np.testing.assert_allclose(got[1, single], want[single], rtol=1e-6)
    rest = np.setdiff1d(np.arange(128 * 128), once)
    np.testing.assert_array_equal(got[1, rest], emap[1, rest])
    for k, c in enumerate(twice):
        cands = 0.1 * emap[1, c] + 0.9 * np.array([err[k], err[500 + k]])
        assert np.isclose(got[1, c], cands, rtol=1e-6).any(), (c, cands)
        assert np.isclose(want[c], cands, rtol=1e-6).any()


def test_host_pixels_equal_the_preloaded_gather():
    _, ds, _ = make_synthetic_scene(n_train=4, n_val=1, res=32)
    pre = ds.device("cpu")
    host = ds.device("cpu", preload=False)
    assert "images" not in host and "host_images" in host
    assert host["host_images"].shape == (4, 32 * 32, 4)
    assert host["host_images"].device.type == "cpu"
    rng = np.random.default_rng(3)
    for img in range(4):
        inds = torch.from_numpy(rng.integers(0, 32 * 32, 500))
        got = host_pixels(host["host_images"], img, inds, "cpu")
        assert torch.equal(got, pre["images"][img][inds])


def _narrow_fast(ws, **kw):
    topt = TrainOptions(iters=96, num_rays=512, bound=1.0, dt_gamma=0.0,
                        grid_size=32, march_res=16, n_intervals=8,
                        steps_per_interval=2, segment_steps=32,
                        update_extra_interval=8, workspace=ws,
                        eval_interval=1000, **kw)
    field = make_cp_field(torch.Generator().manual_seed(0),
                          CPConfig(bound=1.0, scales=((16, 8), (32, 8)),
                                   planes=()), "cpu")
    return FastTrainer("cp", topt, field, workspace=ws,
                       use_checkpoint="scratch", device="cpu")


@pytest.mark.parametrize("error_map", [False, True],
                         ids=["uniform", "error_map"])
def test_no_preload_trains_as_preloaded(tmp_path, error_map):
    _, train, val = make_synthetic_scene(n_train=6, n_val=1, res=32)
    psnrs, trainers = [], []
    for preload in (True, False):
        tr = _narrow_fast(str(tmp_path / str(preload)), preload=preload,
                          error_map=error_map)
        tr.train(train, None, max_epochs=3)
        assert tr.global_step == 96
        assert tr.stats["loss"][-1] < 0.8 * tr.stats["loss"][0]
        psnrs.append(tr.evaluate(val))
        trainers.append(tr)
    pre, host = trainers
    print(f"preload {psnrs[0]:.3f} dB, host-resident {psnrs[1]:.3f} dB")
    assert host.history["loss"] == pre.history["loss"]
    assert psnrs[1] == psnrs[0]
    if error_map:
        assert torch.equal(host.error_map, pre.error_map)
        assert host.error_map.shape == (6, 128 * 128)
        assert float((host.error_map != 1).float().mean()) > 0.1
    with pytest.raises(ValueError, match="patch"):
        _narrow_fast(str(tmp_path / "p"), preload=False,
                     patch_size=4).train(train, None, max_epochs=1)


def _narrow_ngp(ws, **kw):
    from sealdnerf_tpu_torch.models.api import make_ngp_field
    from sealdnerf_tpu_torch.models.ngp import NGPConfig
    topt = TrainOptions(iters=64, num_rays=256, bound=2.0, grid_size=16,
                        max_steps=256, update_extra_interval=8,
                        segment_steps=16, workspace=ws, eval_interval=1000,
                        **kw)
    field = make_ngp_field(torch.Generator().manual_seed(0), NGPConfig(
        bound=2.0, num_levels=4, log2_hashmap_size=12))
    return Trainer("ngp", topt, field, workspace=ws,
                   use_checkpoint="scratch", device="cpu")


@pytest.mark.parametrize("kind", ["FastTrainer", "Trainer"])
def test_trainers_update_the_error_map_and_add_the_patch_term(tmp_path,
                                                              kind):
    make = _narrow_fast if kind == "FastTrainer" else _narrow_ngp
    _, train, _ = make_synthetic_scene(n_train=4, n_val=1, res=32)
    tr = make(str(tmp_path / "e"), error_map=True)
    data = train.device("cpu")
    tr.train_gui(data, step=3, h=32, w=32)
    emap = tr.error_map.clone()
    tr.train_step(data, 32, 32)
    img, ic = tr._draw
    err = tr._loss_per_ray
    moved = (tr.error_map != emap).nonzero().numpy()
    cells = ic.numpy()
    assert set(moved[:, 0]) <= {int(img)}
    assert set(moved[:, 1]) <= set(cells)
    uniq, counts = np.unique(cells, return_counts=True)
    once = np.isin(cells, uniq[counts == 1])
    np.testing.assert_allclose(
        tr.error_map[int(img)][ic[once]].numpy(),
        (0.1 * emap[int(img)][ic[once]] + 0.9 * err[once]).numpy(),
        rtol=1e-6)
    # the patch term: the same batch with and without it
    tp = make(str(tmp_path / "p"), patch_size=4)
    tp.train_gui(data, step=2, h=32, w=32)
    batch = tp.sample_batch(data, 32, 32)
    assert tp._draw[1] is None and batch[0].shape == (tp.opt.num_rays, 3)
    with torch.no_grad():
        with_term = float(tp.loss_on(*batch)[0])
        tp.opt.patch_size = 1
        without = float(tp.loss_on(*batch)[0])
    assert 0 < with_term - without <= 2e-3, (with_term, without)
