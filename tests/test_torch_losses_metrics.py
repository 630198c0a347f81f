"""The port's losses, meters and patch criterion against the JAX package's,
on the same numpy-seeded inputs. Tolerances:
- mape_loss, huber_loss, eff_distloss, patch_ssim_loss and patch_criterion:
  value and gradient within 1e-5 relative (f32 both sides; the sums run in
  other orders);
- ssim (torch conv2d in f64 against scipy's convolve2d in f64): 1e-6
  absolute, and SSIMMeter's mean over two images;
- LPIPSMeter without the lpips package: unavailable, with no connection
  attempted and no file written.
"""

import importlib.util
import os
import socket

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.ops import losses as jl
from sealdnerf_tpu.train import metrics as jm
from sealdnerf_tpu.train import patch_loss as jp
from sealdnerf_tpu_torch.ops import losses as tl
from sealdnerf_tpu_torch.train import metrics as tm
from sealdnerf_tpu_torch.train import patch_loss as tp

RTOL = 1e-5


def _check(jfn, tfn, *arrays, argnums=(0,)):
    """Value and gradient (w.r.t. the arrays at argnums) of a scalar loss
    in both packages."""
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.tensor(a, requires_grad=i in argnums)
             for i, a in enumerate(arrays)]
    vj, gj = jax.value_and_grad(lambda *a: jfn(*a), argnums=argnums)(*jargs)
    vt = tfn(*targs)
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=RTOL)
    for i, g in zip(argnums, gj):
        want = np.asarray(g)
        got = targs[i].grad.numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= RTOL * scale, (i, scale)


@pytest.mark.parametrize("name", ["mape", "huber"])
def test_pointwise_losses_match_reference(name):
    rng = np.random.default_rng(0)
    pred = rng.uniform(-1, 2, (512, 3)).astype(np.float32)
    target = rng.uniform(-1, 2, (512, 3)).astype(np.float32)
    # straddle huber's delta on purpose
    target[:64] = pred[:64] + rng.uniform(-0.2, 0.2, (64, 3)).astype(
        np.float32)
    jfn = {"mape": jl.mape_loss, "huber": jl.huber_loss}[name]
    tfn = {"mape": tl.mape_loss, "huber": tl.huber_loss}[name]
    _check(jfn, tfn, pred, target, argnums=(0, 1))
    np.testing.assert_allclose(
        tfn(torch.from_numpy(pred), torch.from_numpy(target),
            reduction="none").numpy(),
        np.asarray(jfn(jnp.asarray(pred), jnp.asarray(target),
                       reduction="none")), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["scalar_interval", "per_sample_interval"])
def test_eff_distloss_matches_reference(per_sample):
    rng = np.random.default_rng(1)
    w = rng.dirichlet(np.ones(48), size=(4, 64)).astype(np.float32) * 0.9
    m = np.sort(rng.uniform(0.2, 3.0, (4, 64, 48)), -1).astype(np.float32)
    interval = (rng.uniform(0.01, 0.05, (4, 64, 48)).astype(np.float32)
                if per_sample else np.float32(0.03))
    _check(jl.eff_distloss, tl.eff_distloss, w, m, interval,
           argnums=(0, 1))


def _images(seed, h=40, w=52):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(
        np.float32)
    return a, b


def test_ssim_matches_reference():
    for seed in range(3):
        a, b = _images(seed)
        assert abs(tm.ssim(a, b) - jm.ssim(a, b)) <= 1e-6
        assert abs(tm.ssim(a[..., 0], b[..., 0])
                   - jm.ssim(a[..., 0], b[..., 0])) <= 1e-6
    assert abs(tm.ssim(a, a) - 1.0) <= 1e-12
    mt, mj = tm.SSIMMeter(), jm.SSIMMeter()
    for seed in (3, 4):
        a, b = _images(seed)
        mt.update(a, b)
        mj.update(a, b)
    assert mt.n == 2 and abs(mt.measure() - mj.measure()) <= 1e-6
    assert mt.report().startswith("SSIM = ")
    mt.clear()
    assert mt.measure() == 0.0


def test_lpips_meter_unavailable_without_download(tmp_path, monkeypatch):
    """No lpips package here: the meter is disabled before any network is
    built, makes no connection and writes no file; report() says so."""
    def no_network(*args, **kw):
        raise AssertionError("LPIPSMeter tried to open a connection")
    monkeypatch.setattr(socket.socket, "connect", no_network)
    monkeypatch.setattr(socket, "create_connection", no_network)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "hub"))
    monkeypatch.chdir(tmp_path)
    before = sorted(os.listdir(tmp_path))
    m = tm.LPIPSMeter()
    assert m.available is False and m.name == "LPIPS (alex)"
    a, b = _images(5)
    m.update(a, b)
    assert m.n == 0 and m.measure() == 0.0
    assert "unavailable" in m.report()
    assert sorted(os.listdir(tmp_path)) == before
    assert tm.lpips_weight_files() is None     # the package is absent
    # the reference's protocol
    assert jm.LPIPSMeter().available is False
    # a package whose weights are not on the disk is not even imported
    fake = tmp_path / "site" / "lpips" / "__init__.py"
    fake.parent.mkdir(parents=True)
    fake.write_text("raise AssertionError('lpips was imported')\n")
    spec = importlib.util.spec_from_file_location("lpips", fake)
    monkeypatch.setattr(tm.importlib.util, "find_spec",
                        lambda name, *a: spec if name == "lpips" else None)
    files = tm.lpips_weight_files()
    assert files[0] == str(fake.parent / "weights" / "v0.1" / "alex.pth")
    assert files[1].startswith(str(tmp_path / "hub"))
    assert tm.LPIPSMeter().available is False
    assert not (tmp_path / "hub").exists()


@pytest.mark.parametrize("p", [2, 4, 8])
def test_patch_criterion_matches_reference(p):
    rng = np.random.default_rng(p)
    n = 8 * p * p
    pred = rng.uniform(size=(n, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(scale=0.2, size=pred.shape), 0,
                 1).astype(np.float32)
    _check(lambda a, b: jp.patch_ssim_loss(a, b, p),
           lambda a, b: tp.patch_ssim_loss(a, b, p), pred, gt,
           argnums=(0,))
    _check(lambda a, b: jp.patch_criterion(a, b, p),
           lambda a, b: tp.patch_criterion(a, b, p), pred, gt,
           argnums=(0,))
    assert tp.patch_criterion(torch.from_numpy(pred), torch.from_numpy(gt),
                              1) == 0.0
