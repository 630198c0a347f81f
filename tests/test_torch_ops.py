"""Parity of the PyTorch port's ops with the JAX package: ray/AABB, freq
and SH encodings, the 2-tap hat lerp, compositing and ray generation.
Inputs come from a seeded numpy generator and go through both packages."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.data.rays import get_rays as jax_get_rays
from sealdnerf_tpu.ops.composite import composite_rays as jax_composite
from sealdnerf_tpu.ops.freq_encode import freq_encode as jax_freq
from sealdnerf_tpu.ops.hat import hat_basis
from sealdnerf_tpu.ops.ray import near_far_from_aabb as jax_near_far
from sealdnerf_tpu.ops.sh_encode import sh_encode as jax_sh
from sealdnerf_tpu_torch.data.rays import get_rays
from sealdnerf_tpu_torch.ops.composite import composite_rays
from sealdnerf_tpu_torch.ops.freq_encode import freq_encode
from sealdnerf_tpu_torch.ops.hat import line_interp
from sealdnerf_tpu_torch.ops.ray import near_far_from_aabb
from sealdnerf_tpu_torch.ops.sh_encode import sh_encode

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _unit(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_near_far_from_aabb(rng):
    o = rng.uniform(-2.5, 2.5, (256, 3)).astype(np.float32)
    d = _unit(rng, 256)
    d[:8, 0] = 0.0                      # axis-parallel rays: inf slabs
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    n0, f0 = jax_near_far(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabb),
                          0.05)
    n1, f1 = near_far_from_aabb(_t(o), _t(d), _t(aabb), 0.05)
    np.testing.assert_allclose(n1.numpy(), np.asarray(n0), **F32_TOL)
    np.testing.assert_allclose(f1.numpy(), np.asarray(f0), **F32_TOL)


@pytest.mark.parametrize("degree", [2, 4, 10])
def test_freq_encode(rng, degree):
    x = rng.uniform(-1, 1, (128, 3)).astype(np.float32)
    np.testing.assert_allclose(freq_encode(_t(x), degree).numpy(),
                               np.asarray(jax_freq(jnp.asarray(x), degree)),
                               **F32_TOL)


@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_encode(rng, degree):
    d = _unit(rng, 128)
    np.testing.assert_allclose(sh_encode(_t(d), degree).numpy(),
                               np.asarray(jax_sh(jnp.asarray(d), degree)),
                               **F32_TOL)


@pytest.mark.parametrize("res", [2, 8, 33, 1024])
def test_lerp_matches_hat_matmul(rng, res):
    """The 2-tap lerp with bf16 weights and table equals the reference's
    bf16 hat-basis matmul, including the clip and the end points."""
    x = np.concatenate([rng.uniform(0, 1, 200),
                        np.arange(res) / (res - 1),     # exact grid points
                        [0.0, 1.0, -0.5, 1.5]]).astype(np.float32)
    tab = rng.normal(size=(res, 16)).astype(np.float32)
    u = hat_basis(jnp.asarray(x), res)                   # [S, res] bf16
    ref = jnp.dot(u, jnp.asarray(tab).astype(jnp.bfloat16),
                  preferred_element_type=jnp.float32)
    got = line_interp(_t(x), _t(tab)).numpy()
    # two exact bf16 x bf16 products summed once in f32 on both sides
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("t_thresh", [0.0, 1e-4])
def test_composite_rays(rng, t_thresh):
    n, s = 64, 48
    sig = rng.exponential(3.0, (n, s)).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, s, 3)).astype(np.float32)
    dts = rng.uniform(0.005, 0.05, (n, s)).astype(np.float32)
    ts = np.cumsum(dts, axis=-1).astype(np.float32)
    ref = jax_composite(jnp.asarray(sig), jnp.asarray(rgb), jnp.asarray(dts),
                        ts=jnp.asarray(ts), t_thresh=t_thresh)
    got = composite_rays(_t(sig), _t(rgb), _t(dts), ts=_t(ts),
                         t_thresh=t_thresh)
    for k in ("weights", "weights_sum", "depth", "image"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   **F32_TOL)


def _poses(rng, b):
    from sealdnerf_tpu_torch.data.synthetic import _orbit_pose
    return np.stack([_orbit_pose(rng.uniform(0.5, 2.5), rng.uniform(0, 6.2),
                                 2.0) for _ in range(b)]).astype(np.float32)


def test_get_rays_full_image(rng):
    poses = _poses(rng, 2)
    intr = np.array([30.0, 31.0, 12.0, 10.5], np.float32)
    import jax
    ref = jax_get_rays(jax.random.PRNGKey(0), jnp.asarray(poses),
                       jnp.asarray(intr), 20, 24, -1)
    got = get_rays(_t(poses), _t(intr), 20, 24, -1)
    for k in ("rays_o", "rays_d"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   **F32_TOL)


def test_get_rays_random_pixels(rng):
    """Uniform random sampling: same pixel indices -> same rays; the
    port's own draw stays in range and is reproducible from a seed."""
    poses = _poses(rng, 2)
    intr = np.array([30.0, 30.0, 12.0, 12.0], np.float32)
    inds = rng.integers(0, 24 * 24, (2, 100)).astype(np.int32)
    import jax
    ref = jax_get_rays(jax.random.PRNGKey(0), jnp.asarray(poses),
                       jnp.asarray(intr), 24, 24, 100, inds=jnp.asarray(inds))
    got = get_rays(_t(poses), _t(intr), 24, 24, 100, inds=_t(inds).long())
    np.testing.assert_allclose(got["rays_d"].numpy(),
                               np.asarray(ref["rays_d"]), **F32_TOL)
    a = get_rays(_t(poses), _t(intr), 24, 24, 100,
                 generator=torch.Generator().manual_seed(3))
    b = get_rays(_t(poses), _t(intr), 24, 24, 100,
                 generator=torch.Generator().manual_seed(3))
    assert a["inds"].shape == (2, 100)
    assert int(a["inds"].min()) >= 0 and int(a["inds"].max()) < 24 * 24
    assert torch.equal(a["rays_d"], b["rays_d"])
