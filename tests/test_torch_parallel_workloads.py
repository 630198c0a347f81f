"""main_tensoRF and main_CCNeRF on the port's data mesh, at 2 ranks of a
gloo mesh on the CPU (tests/torch_parallel_ranks.py spawns them), against
the port on one rank.

Narrow sizes: the synthetic scene at 32 px, a 32^3 grid, 64 packed samples
a ray, 128 rays a step; TensoRF at resolution 16, upsampled to 24 at step
8; CCNeRF at CP rank 4 with the K-loss at 0.25 and 0.5.

Tolerances:
- main_tensoRF across an upsample and main_CCNeRF: params, EMA, Adam
  moments, grid state and losses the same bits on both ranks; one
  checkpoint file a run.
- One step of a narrow TensoRF trainer across its upsample (the field,
  the EMA and Adam rebuilt at that step), and one CCNeRF K-loss step, on
  given per-rank batches: within 1e-6 of one Adam step on the mean of the
  two one-rank gradients (test_torch_parallel_train.py), the same bits on
  both ranks.
- main_CCNeRF --compose of the 2-rank run's model on 2 ranks: its union
  grid the same bits on both ranks and equal to the one-rank sweep's; the
  6 composed frames, written by rank 0 alone, the one-rank frames' PNG
  bytes.
"""

import os

import numpy as np
import pytest

from sealdnerf_tpu_torch import cli, main_CCNeRF
from sealdnerf_tpu_torch.models.params import param_leaves

import test_torch_parallel_edit as edit
import torch_parallel_ranks as ranks

STEP_ATOL = 1e-6
NARROW = dict(grid_size=32, segment_steps=8)
BASE = ["synthetic", "--device", "cpu", "--synthetic_res", "32",
        "--num_rays", "128", "--max_steps", "64"]

_one_thread = edit._one_thread


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("workloads")
    ws = str(root)
    spec = {
        "ws": ws, "narrow": NARROW,
        "tensorf": BASE + ["--workspace", ws + "/tf", "--ckpt", "scratch",
                           "--iters", "16", "--resolution0", "16",
                           "--resolution1", "24", "--upsample_model_steps",
                           "8"],
        "ccnerf": BASE + ["--workspace", ws + "/cc", "--ckpt", "scratch",
                          "--iters", "16", "--rank", "4"],
        "compose": BASE + ["--workspace", ws + "/compose2", "--compose",
                           "--rank", "4", "--compose_models", ws + "/cc",
                           ws + "/cc"],
        "batches": edit._distil_batches(False, 7)}
    return spec, ranks.run_ranks(ranks.workloads, 2, root, spec)


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None:
        assert b is None
    else:
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("name", ["tensorf", "ccnerf"])
def test_run_is_the_same_bits_on_both_ranks(runs, name):
    spec, (r0, r1) = runs
    _same(r0[name], r1[name])
    assert r0[name]["steps"] == 48               # one epoch of 48 views
    assert np.isfinite(r0[name]["loss"]).all()
    if name == "tensorf":
        assert r0[name]["res"] == 24             # upsampled at step 8
    ws = spec["ws"] + ("/tf" if name == "tensorf" else "/cc")
    assert len(os.listdir(os.path.join(ws, "checkpoints"))) == 1


@pytest.mark.parametrize("name", ["tensorf", "ccnerf"])
def test_step_is_the_mean_gradient_step(runs, name, tmp_path):
    spec, (r0, r1) = runs
    got = [r[name + "_step"] for r in (r0, r1)]
    tr = ranks.narrow_tensorf(str(tmp_path), cc=name == "ccnerf")
    assert tr.ndev == 1
    if name == "tensorf":
        tr.upsample()
        assert tr.field.cfg.resolution == 24
    leaves = param_leaves(tr.params)
    grads, losses = [], []
    for b in spec["batches"]:
        tr.optimizer.zero_grad(set_to_none=True)
        loss, _ = tr.loss_on(*ranks.distil_batch(b))
        loss.backward()
        grads.append([p.grad.clone() for p in leaves])
        losses.append(float(loss.detach()))
    for p, g0, g1 in zip(leaves, *grads):
        p.grad = (g0 + g1) / 2
    tr.apply_gradients()
    want = ranks.edit_state(tr)
    assert got[0]["loss"] == got[1]["loss"]
    np.testing.assert_allclose(got[0]["loss"], np.mean(losses), rtol=1e-6)
    for key in ("params", "ema", "mu", "nu"):
        assert len(got[0][key]) == len(want[key])
        for a, b, w in zip(got[0][key], got[1][key], want[key]):
            assert a.tobytes() == b.tobytes(), key
            np.testing.assert_allclose(a, w, atol=STEP_ATOL, rtol=0,
                                       err_msg=key)


def test_compose_writes_rank0_frames_equal_to_one_rank(runs, monkeypatch):
    spec, (r0, r1) = runs
    assert r0["compose"]["ndev"] == 2
    _same(r0["compose"]["grid"], r1["compose"]["grid"])
    monkeypatch.setattr(main_CCNeRF, "to_train_options",
                        lambda opt, **kw: cli.to_train_options(opt, **kw,
                                                               **NARROW))
    argv = [a.replace("/compose2", "/compose1") for a in spec["compose"]]
    viewer = main_CCNeRF.main(argv)
    assert viewer.ndev == 1
    grid = {k: v.numpy() for k, v in viewer.grid_state.items()}
    _same(r0["compose"]["grid"], grid)
    two = os.path.join(spec["ws"], "compose2", "compose")
    one = os.path.join(spec["ws"], "compose1", "compose")
    frames = sorted(f for f in os.listdir(one) if f.endswith(".png"))
    assert len(frames) == 6
    assert sorted(f for f in os.listdir(two) if f.endswith(".png")) == frames
    for f in frames:
        with open(os.path.join(one, f), "rb") as a, \
                open(os.path.join(two, f), "rb") as b:
            assert a.read() == b.read(), f
