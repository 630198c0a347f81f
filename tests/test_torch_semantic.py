"""The GT-free semantic step (--clip_text with --rand_pose) in the port's
Trainer, and train/clip_guidance.py, against the JAX package.

- train_step_semantic with an injected semantic_loss_fn (the image's mean
  square, as tests/test_regressions.py's test_semantic_rand_pose_branch
  injects one) on a narrow TensoRF field: finite losses that fall, params
  that move, global_step and the optimizer's count that count each step;
- one train_step_semantic against the reference's on the same params,
  occupancy and orbit pose (rand_poses fixed on both sides), with the
  full frame's intrinsics off centre so that their scaling to clip_res
  and the centred principal point show: loss rtol 1e-3, each leaf's
  gradient within 5e-2 in relative L2 norm (the tolerance of
  tests/test_torch_tensorf_train.py's train step);
- CLIPGuidance.loss_fn on stub models: clip_pixels against the reference's
  jax.image.resize "bilinear" and CLIP's mean and std (atol 5e-5 after the
  division by std, f32 sums of the resize weights; growing and shrinking),
  the loss against FlaxCLIPGuidance.loss_fn on the same stub (rtol 1e-5),
  and a finite nonzero gradient in the image;
- without local CLIP weights the trainer (Trainer and FastTrainer) builds,
  logs the reference's warning and takes no semantic step;
- the rand_pose cadence of the port's loop against the reference's loop
  (Trainer.train with its two steps recorded) for rand_pose 0, 1 and 3.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.data import rays as jax_rays
from sealdnerf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from sealdnerf_tpu.models import tensorf as jt
from sealdnerf_tpu.parallel.mesh import make_mesh
from sealdnerf_tpu.train.clip_guidance import FlaxCLIPGuidance
from sealdnerf_tpu.train.trainer import Trainer as JaxTrainer
from sealdnerf_tpu.train.trainer import TrainOptions as JaxOptions
from sealdnerf_tpu_torch.data.rays import rand_poses
from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
from sealdnerf_tpu_torch.models import tensorf as tt
from sealdnerf_tpu_torch.models.api import make_tensorf_field
from sealdnerf_tpu_torch.models.params import param_leaves, params_from_jax
from sealdnerf_tpu_torch.train import trainer as trainer_mod
from sealdnerf_tpu_torch.train.clip_guidance import CLIPGuidance, clip_pixels
from sealdnerf_tpu_torch.train.trainer import Trainer, TrainOptions

NARROW = dict(bound=1.0, decomposition="vm", resolution=16,
              sigma_rank=(4, 4, 4), color_rank=(8, 8, 8))
INTR = np.array([16.0, 16.0, 8.0, 8.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_OPTS = dict(iters=50, num_rays=64, bound=1.0, dt_gamma=0.0, grid_size=32,
             clip_res=16, max_steps=64, samples_per_ray=16, segment_steps=8)


def _opts(ws, **kw):
    return TrainOptions(**{**_OPTS, "workspace": ws, **kw})


def _trainer(ws, **kw):
    field = make_tensorf_field(torch.Generator().manual_seed(0),
                               tt.TensoRFConfig(**NARROW))
    return Trainer("sem", _opts(ws, **kw), field, workspace=ws,
                   use_checkpoint="scratch", device="cpu")


def test_semantic_step_with_an_injected_loss(tmp_path):
    tr = _trainer(str(tmp_path), rand_pose=0)
    assert tr.semantic_loss_fn is None          # no --clip_text
    tr.update_extra_state()
    tr.semantic_loss_fn = lambda img: torch.mean(img ** 2)
    assert tr.semantic_due(0) and tr.semantic_due(7)
    p0 = param_leaves(tr.params)[0].detach().clone()
    l0 = float(tr.train_step_semantic(INTR, 16))
    for _ in range(10):
        l1 = float(tr.train_step_semantic(INTR, 16))
    assert tr.global_step == 11 and tr._optimizer_count() == 11
    assert not torch.equal(p0, param_leaves(tr.params)[0])
    assert np.isfinite(l0) and np.isfinite(l1) and l1 < l0
    # through the loop's step: a semantic step, n_samples 0
    data = make_synthetic_scene(n_train=2, n_val=1, res=16)[1].device("cpu")
    loss, n = tr.train_step(data, 16, 16)
    assert tr.global_step == 12 and int(n) == 0 and torch.isfinite(loss)


def test_semantic_step_matches_the_reference(tmp_path, monkeypatch):
    """One semantic step of each package on the same params, occupancy and
    pose: the reference's render_occ at clip_res with a white background
    and no jitter, against the port's. The full frame is 32 px high with
    its principal point off centre; the step scales the focal lengths to
    clip_res (16) and centres the principal point."""
    intr_full = np.array([30.0, 28.0, 15.5, 17.0], np.float32)
    pose = rand_poses(np.random.default_rng(2), 1, radius=1.3)
    c = (np.arange(32) + 0.5) / 32 * 2 - 1
    r = np.sqrt(sum(np.meshgrid(c * c, c * c, c * c, indexing="ij")))
    occ = ((r < 0.8) | (np.random.default_rng(1).uniform(
        size=r.shape) < 0.1))[None]

    def mean_square(img):
        return (img ** 2).mean()
    jfield = jt.make_tensorf_field(jax.random.PRNGKey(0), jt.TensoRFConfig(
        **NARROW))
    params0 = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     jfield.params))
    ws = str(tmp_path / "j")
    jtr = JaxTrainer("j", JaxOptions(**{**_OPTS, "rand_pose": 0,
                                        "workspace": ws}),
                     jfield, workspace=ws, use_checkpoint="scratch",
                     mesh=make_mesh(jax.devices()[:1]))
    jtr.grid_state["occ"] = jnp.asarray(occ)
    jtr.semantic_loss_fn = mean_square
    monkeypatch.setattr(jax_rays, "rand_poses",
                        lambda key, n, radius=1.0: jnp.asarray(pose))
    jgrads = []

    class _SpyTx:
        """The reference's optimizer, recording the gradients it is given."""

        def __init__(self, tx):
            self.tx = tx

        def update(self, grads, state, params=None):
            jax.debug.callback(lambda g: jgrads.append(g), grads)
            return self.tx.update(grads, state, params)
    jtr.tx = _SpyTx(jtr.tx)
    lj = jtr.train_step_semantic(intr_full, 32)

    field = make_tensorf_field(None, tt.TensoRFConfig(**NARROW),
                               params=params0)
    ws = str(tmp_path / "t")
    tr = Trainer("t", _opts(ws, rand_pose=0), field, workspace=ws,
                 use_checkpoint="scratch", device="cpu")
    tr.grid_state["occ"] = torch.from_numpy(occ)
    tr.semantic_loss_fn = mean_square
    monkeypatch.setattr(trainer_mod, "rand_poses",
                        lambda rng, n, radius=1.0: pose)
    tgrads = []
    apply = tr.apply_gradients

    def spy_apply():
        tgrads.extend(p.grad.clone() for p in param_leaves(tr.params))
        apply()
    tr.apply_gradients = spy_apply
    lt = float(tr.train_step_semantic(intr_full, 32))
    assert tr.global_step == 1 and jtr.global_step == 1
    np.testing.assert_allclose(lt, lj, rtol=1e-3)
    names = [k for k in sorted(tr.params) for _ in param_leaves(tr.params[k])]
    errs = {}
    for name, gt, gj in zip(names, tgrads,
                            jax.tree_util.tree_leaves(jgrads[0])):
        gj = np.asarray(gj)
        errs[name] = max(errs.get(name, 0.0), float(
            np.linalg.norm(gt.numpy() - gj) / np.linalg.norm(gj)))
    assert len(tgrads) == len(jax.tree_util.tree_leaves(jgrads[0]))
    assert max(errs.values()) <= 5e-2, errs


class _StubTorch:
    """A stand-in for CLIP's image tower: the pixels' 8 x 8 block means
    through a fixed matrix."""

    def __init__(self, w):
        self.w = torch.from_numpy(w)

    def get_image_features(self, pixel_values):
        pooled = torch.nn.functional.avg_pool2d(pixel_values, 28)
        return pooled.reshape(1, -1) @ self.w


class _StubJax:
    def __init__(self, w):
        self.w = jnp.asarray(w)

    def get_image_features(self, pixel_values):
        p = pixel_values.reshape(1, 3, 8, 28, 8, 28).mean(axis=(3, 5))
        return p.reshape(1, -1) @ self.w


def test_clip_loss_matches_the_reference():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3 * 64, 16)).astype(np.float32)
    text = rng.normal(size=(1, 16)).astype(np.float32)
    guide = CLIPGuidance("a red car", model=_StubTorch(w),
                         text_features=torch.from_numpy(text))
    assert guide.available
    ref = object.__new__(FlaxCLIPGuidance)
    ref._model = _StubJax(w)
    ref._mean = jnp.array([0.48145466, 0.4578275, 0.40821073])
    ref._std = jnp.array([0.26862954, 0.26130258, 0.27577711])
    ref._text_features = jnp.asarray(text / np.linalg.norm(text))
    for res in (128, 300):
        img = rng.uniform(size=(res, res, 3)).astype(np.float32)
        want = (jax.image.resize(jnp.asarray(img), (224, 224, 3),
                                 method="bilinear") - ref._mean) / ref._std
        got = clip_pixels(torch.from_numpy(img))
        np.testing.assert_allclose(got[0].permute(1, 2, 0).numpy(),
                                   np.asarray(want), rtol=0, atol=5e-5)
        t = torch.from_numpy(img).requires_grad_(True)
        loss = guide.loss_fn(t)
        np.testing.assert_allclose(float(loss.detach()),
                                   float(ref.loss_fn(jnp.asarray(img))),
                                   rtol=1e-5)
        loss.backward()
        assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0


def test_without_local_weights_no_semantic_steps(tmp_path):
    """--clip_text with --rand_pose 0 and no CLIP files on the disk: the
    trainer builds, logs the reference's warning, and trains on the ground
    truth only."""
    ws = str(tmp_path)
    for name in (str(tmp_path / "no_model"), "no-such-org/no-such-model"):
        guide = CLIPGuidance("a red car", model_name=name)
        assert not guide.available and guide.reason
    tr = _trainer(ws, clip_text="a red car", rand_pose=0)
    assert tr.semantic_loss_fn is None and not tr.semantic_due(0)
    log = open(os.path.join(ws, "log_sem.txt")).read()
    assert "--clip_text set but CLIP weights are unavailable offline" in log
    tr.train_step_semantic = lambda *a: pytest.fail("a semantic step")
    _, train, _ = make_synthetic_scene(n_train=2, n_val=1, res=16)
    tr.train(train, None, max_epochs=1)
    assert tr.global_step == 8 and np.isfinite(tr.history["loss"]).all()
    # FastTrainer (the CP field's) builds the same way
    from sealdnerf_tpu_torch.models.cp import CPConfig, make_cp_field
    from sealdnerf_tpu_torch.train.fast import FastTrainer
    cp = make_cp_field(torch.Generator().manual_seed(0), CPConfig(
        bound=1.0, scales=((8, 4), (16, 8)), planes=()))
    ft = FastTrainer("fast", _opts(ws, clip_text="a red car", rand_pose=0),
                     cp, workspace=ws, use_checkpoint="scratch", device="cpu")
    assert ft.semantic_loss_fn is None
    assert open(os.path.join(ws, "log_fast.txt")).read().count(
        "CLIP weights are unavailable offline") == 1


@pytest.mark.parametrize("rand_pose", [0, 1, 3])
def test_rand_pose_cadence_matches_the_reference(tmp_path, rand_pose):
    """Which steps of the loop are semantic: the reference's Trainer.train
    with its steps recorded, against the port's."""
    _, jtrain, _ = jax_scene(n_train=4, n_val=1, res=16)
    field = jt.make_tensorf_field(jax.random.PRNGKey(0), jt.TensoRFConfig(
        **NARROW))
    ws = str(tmp_path / "j")
    jtr = JaxTrainer("c", JaxOptions(iters=16, num_rays=64, grid_size=32,
                                     rand_pose=rand_pose, workspace=ws),
                     field, workspace=ws, use_checkpoint="scratch",
                     mesh=make_mesh(jax.devices()[:1]))
    want = []

    def jstep(kind):
        def step(*a):
            want.append(kind)
            jtr.global_step += 1
            return 0.0 if kind else (0.0, 0)
        return step
    jtr.semantic_loss_fn = lambda img: 0.0
    jtr.train_step_semantic = jstep(True)
    jtr.train_step = jstep(False)
    jtr.update_extra_state = lambda: None
    jtr.mark_untrained_grid = lambda *a: None
    jtr.train(jtrain, None, max_epochs=4)
    assert len(want) == 16
    tr = _trainer(str(tmp_path / "t"), rand_pose=rand_pose, iters=16)
    tr.semantic_loss_fn = lambda img: img.sum()
    got = []

    def tstep(kind):
        def step(*a):
            got.append(kind)
            tr.global_step += 1
            return torch.zeros(()) if kind else (torch.zeros(()),
                                                 torch.zeros(()))
        return step
    tr.train_step_semantic = tstep(True)
    tr.train_step_gt = tstep(False)
    tr.update_extra_state = lambda: None
    _, train, _ = make_synthetic_scene(n_train=4, n_val=1, res=16)
    tr.train(train, None, max_epochs=2)
    assert got == want
    assert sum(want) == (16 if rand_pose == 0 else 16 // (rand_pose + 1))
