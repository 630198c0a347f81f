"""The Trainer (port of sealdnerf_tpu/train/trainer.py): the host loop, and
the reference trainer of the Instant-NGP, D-NeRF and TensoRF fields.

The host loop (FastTrainer in train/fast.py inherits it): the log, the
optimizer (Adam with betas 0.9/0.99 and eps 1e-15, the schedule lr * 0.1
** min(step / iters, 1), with lr_net the MLP towers in a group of their own
at that rate), the EMA of the params, frustum marking, epochs of
max(n_images, segment_steps) steps until opt.iters with evaluation every
eval_interval epochs, evaluate and test, and checkpoints in the reference's
.npz format.

The reference trainer, for a models.api Field (NGPConfig or TensoRFConfig,
or DNeRFConfig with time_conditioned=True). One step refreshes the
occupancy grid every update_extra_interval steps (a dynamic grid every 16 *
8 / 64 = 2 steps, eight of its 64 time bins a call): full sweeps for the
first 16 passes, then H^3 / 2 random cells, on the current params, and from
then on the packed budget follows the measured samples per ray
(_update_budget). It draws one image and num_rays pixels of it, a random
background per ray for RGBA images and the march's start offsets, renders
through render_occ (render/renderer.py: the packed march, the field, packed
compositing), and takes the MSE, plus tv_weight * the hash table's TV
energy at num_rays random points. Frames are rendered by render_occ in
chunks of 4 * max_ray_batch rays with a packed budget of
eval_samples_per_ray a ray.

Editing hooks (overridden by editing/student.py's StudentTrainer):
`_occ_at` (the occupancy a training ray batch marches: the student forces
its edit region on), `_param_groups` (the leaves the optimizer steps: the
student leaves its deform tower out) and `adopt_grid_state` (a grid state
taken over from another trainer, iter_density included).

Two faults of the reference are not copied: its rebuild sweeps 8 of the 64
time bins of a dynamic grid (here every bin), and a slim checkpoint (no
density grid) does not load into its dynamic trainer (here it does, and the
grid of every bin is rebuilt).

Training options of the main CLIs:
- error_map: pixels are drawn by a per-image [n, 128 * 128] error map that
  lives on the device (ones at the start), and after each step the drawn
  cells of the step's image are set to 0.1 x old + 0.9 x the rays' MSE
  (update_error_map);
- patch_size > 1: num_rays // p^2 random p x p patches, and the structural
  term patch_criterion (1e-3 x mean(1 - SSIM) per patch) on the loss;
- preload=False: the reference's Trainer warns and preloads, and so does
  this one (FastTrainer keeps the images on the host).
Export: test() writes PNG frames and, when an encoder can be imported, an
mp4; save_mesh() writes the density's iso-surface as PLY. The GUI's calls:
train_gui() and test_gui().

Data parallelism (mesh=, parallel/mesh.py; the reference's shard_map over
its "data" mesh): every rank holds the whole state and draws its own image,
num_rays / N pixels of it, background, march offsets and TV points from its
own stream (rank_generator); the gradients and the loss are averaged over
the ranks in one collective before Adam, and the error map takes the sum of
the ranks' row updates, so that params, EMA, Adam state and error map stay
the same bits on every rank. The packed budget follows rank 0's sample
count. The grid refresh is not sharded here: it draws from `generator`,
which is the same on every rank, as the reference draws it from its one
controller key; a static grid's rebuild (a full sweep) is, each rank
querying its block of the cells with the jitter drawn whole from
`generator` (render/grid.py). Rank 0 alone logs and writes checkpoints,
frames and meshes, and the ranks wait for its writes. On a mesh of one rank
both streams are `generator` and no collective is called.

CCNeRF's rank-residual K-loss (k_rank_fracs, on a field with
forward_trunc): each truncation level renders the step's rays with the same
march offsets, and the MSE is (L_full + sum of L_k) / (1 + K).

GT-free semantic steps (--clip_text with --rand_pose >= 0): the CLIP model
is loaded from local files only (train/clip_guidance.py); without them the
trainer logs the reference's warning and takes no semantic step. With a
semantic_loss_fn (CLIP's, or one a caller sets), a step whose index k gives
rand_pose == 0 or k % (rand_pose + 1) == rand_pose renders a random orbit
pose at clip_res x clip_res instead (train_step_semantic) and steps both
Adam groups and the EMA on semantic_loss_fn(image). FastTrainer's loop
takes no semantic step, as the reference's does not.
"""

import functools
import math
import os
import time
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.provider import host_pixels
from ..data.rays import ERROR_MAP_RES, get_rays, rand_poses
from ..models.api import check_params
from ..models.dnerf import DNeRFConfig
from ..models.ngp import NGPConfig
from ..models.tensorf import TensoRFConfig
from ..models.params import (map_params, param_leaves, params_from_jax,
                             unflatten_like)
from ..ops.marching import MarchConfig
from ..parallel.mesh import (barrier, from_rank0, make_mesh, pmean, psum,
                             replicate)
from ..render.dynamic_grid import (DynGridConfig, init_dyn_grid_state,
                                   mark_untrained_dyn_grid,
                                   rebuild_dyn_density_grid,
                                   time_slice_index, update_dyn_density_grid)
from ..render.grid import (GridConfig, init_grid_state, mark_untrained_grid,
                           update_density_grid)
from ..render.renderer import RenderSettings, render_occ
from ..utils import profiling
from ..utils.png import write_png
from .checkpoint import (load_checkpoint, prune_checkpoints,
                         resolve_checkpoint, save_checkpoint)
from .metrics import PSNRMeter
from .patch_loss import patch_criterion


@dataclass
class TrainOptions:
    """The subset of the reference's options that the port reads."""

    workspace: str = "workspace"
    name: str = "ngp"
    iters: int = 30000               # schedule length: lr * 0.1**(step/iters)
    lr: float = 1e-2
    lr_net: Optional[float] = None   # separate lr of the MLP towers (D-NeRF)
    # Dynamic training. The time curriculum trains on a growing window of
    # the time-sorted frames that reaches the full range after this many
    # steps: 0 off, -1 resolved from the data by FastTrainer.train (512 for
    # one camera per timestamp, else off).
    time_curriculum_steps: int = 0
    # Coarse-to-fine: the sigma tower's input rows of line scales and planes
    # with res > dyn_anneal_res ramp from 0 to 1 over dyn_anneal_steps steps
    # (0 off). Without it the canonical field bakes in motion ghosts before
    # the warp locks on.
    dyn_anneal_steps: int = 1024
    dyn_anneal_res: int = 256
    # Weight of mean |deform_raw(x, 0)|^2 at random scene points. It must
    # stay tiny: at 0.1 it pins the near-zero-initialised deform output at
    # zero and the tower never comes alive.
    deform_zero_reg: float = 1e-3
    num_rays: int = 4096             # rays per training step
    update_extra_interval: int = 16  # steps between grid refreshes
    ema_decay: float = 0.95
    eval_interval: int = 50          # epochs between evaluations
    segment_steps: int = 128         # floor of the steps of an epoch
    max_keep_ckpt: int = 2
    error_map: bool = False          # sample pixels by the error map
    patch_size: int = 1              # > 1: p x p patches, the patch term
    preload: bool = True             # False: images stay on the host
    # CCNeRF's rank-residual K-loss: truncation fractions trained jointly
    # with the full rank (a field with forward_trunc)
    k_rank_fracs: Tuple[float, ...] = ()
    clip_text: str = ""              # GT-free CLIP guidance prompt
    rand_pose: int = -1              # < 0 off; 0 every step; k every k+1th
    clip_res: int = 128              # the semantic step's render resolution
    bound: float = 1.0
    dt_gamma: float = 1.0 / 128
    min_near: float = 0.2
    density_thresh: float = 10.0
    density_scale: float = 1.0
    t_thresh: float = 1e-4
    seed: int = 0
    grid_size: int = 128             # occupancy grid resolution
    # the reference trainer's packed march (render/renderer.py)
    max_steps: int = 1024            # candidates and sample cap per ray
    samples_per_ray: int = 48        # packed budget per ray, training
    eval_samples_per_ray: int = 64   # packed budget per ray, frames
    max_ray_batch: int = 4096        # frames: chunks of 4x this many rays
    num_steps: int = 128             # render_uniform's samples
    upsample_steps: int = 128
    bg_radius: float = -1.0          # > 0: the NGP background sphere
    tv_weight: float = 0.0           # hash-table TV regulariser weight
    # FastTrainer's dense march
    march_res: int = 64              # coarse march grid resolution
    n_intervals: int = 16            # kept occupied voxel-steps per ray
    steps_per_interval: int = 4      # fine samples per interval
    # tile-band image rendering (render/fast_image.py)
    render_tile_px: int = 8          # pixels per march tile (1 = per-ray)
    render_dilate: int = 1           # occupancy dilation radius (voxels)
    render_march_res: int = 0        # 0 = use march_res
    render_n_intervals: int = 0      # 0 = 2x the training n_intervals
    render_steps_per_interval: int = 0
    # The bucketed renderer (render/fast_image.py:render_image_bucketed),
    # which FastTrainer.render_image takes below 15 % occupancy: (share of
    # the tiles, divisor of the render interval budget), the emptiest tiles
    # first, the last split taking the rest. The eval ladder and the LOD
    # preview's harsher one, with the reference's values (its TrainOptions
    # comment gives their measured trade-off on the TPU).
    render_splits: Tuple[Tuple[float, int], ...] = (
        (0.60, 32), (0.15, 16), (0.15, 4), (0.07, 2), (1.0, 2))
    render_splits_preview: Tuple[Tuple[float, int], ...] = (
        (0.60, 32), (0.18, 16), (0.12, 8), (0.07, 4), (1.0, 2))
    # the termination trim of bucketed frames: leading intervals probed per
    # tile (0 = off), the optical-depth cutoff at interval entry (exp(-7) ~
    # 1e-3 per corner probe), and every stride-th covered interval tapped
    render_term_intervals: int = 16
    render_term_tau: float = 7.0
    render_term_stride: int = 2
    # the LOD preview (FastTrainer.test_gui without depth): line scales with
    # res >= this are skipped in the field kernel; 0 disables
    preview_lod_min_res: int = 1024


def cascades_for(bound: float) -> int:
    return 1 + max(0, math.ceil(math.log2(max(bound, 1.0))))


DENSITY_CHUNK = 1 << 20    # points of one density query of a grid refresh
BUDGET_BUCKETS = (8, 12, 16, 24, 32)
GUI_DOWNSCALES = (1, 2, 4, 8)
VIDEO_FPS = 25


def update_error_map(emap, img_idx, inds_coarse, err):
    """The error map's update after a step, in place: row img_idx (a [1]
    tensor) of emap [n, 128 * 128] at the step's cells inds_coarse [N] is
    set to 0.1 x its old value + 0.9 x err [N], the rays' MSE (the
    reference's direction). Where a cell was drawn more than once, which
    ray's value lands is unspecified, as in the reference's scatter.
    Returns emap."""
    rows = img_idx.reshape(1).expand_as(inds_coarse)
    old = emap[rows, inds_coarse]
    emap.index_put_((rows, inds_coarse), 0.1 * old + 0.9 * err.to(old.dtype))
    return emap


class Trainer:
    def __init__(self, name: str, opt: TrainOptions, field,
                 metrics: Optional[Sequence] = None,
                 workspace: Optional[str] = None,
                 use_checkpoint: str = "latest", device=None,
                 time_conditioned: bool = False, mesh=None):
        self._check_field(field, opt, time_conditioned)
        self.time_conditioned = time_conditioned
        self.name = name
        self.opt = opt
        self.field = field
        self.metrics = list(metrics) if metrics is not None else [PSNRMeter()]
        self.workspace = workspace or opt.workspace
        self.device = torch.device(device) if device is not None \
            else param_leaves(field.params)[0].device
        # the data mesh: default, one rank on the device (or the ranks of
        # torchrun's environment, parallel/mesh.py:make_mesh)
        self.mesh = mesh if mesh is not None else make_mesh(self.device)
        self.ndev = self.mesh.size
        cascades = cascades_for(opt.bound)
        self.march = MarchConfig(
            bound=opt.bound, cascades=cascades, grid_size=opt.grid_size,
            dt_gamma=opt.dt_gamma, max_steps=opt.max_steps,
            min_near=opt.min_near)
        self.settings = RenderSettings(
            march=self.march, density_scale=opt.density_scale,
            bg_radius=opt.bg_radius, t_thresh=opt.t_thresh,
            num_steps=opt.num_steps, upsample_steps=opt.upsample_steps,
            samples_per_ray=opt.samples_per_ray)
        self.grid_cfg = GridConfig(
            bound=opt.bound, cascades=cascades, grid_size=opt.grid_size,
            density_thresh=opt.density_thresh,
            density_scale=opt.density_scale)
        self.dyn_grid_cfg = DynGridConfig(
            bound=opt.bound, cascades=cascades, grid_size=opt.grid_size,
            density_thresh=opt.density_thresh,
            density_scale=opt.density_scale) if time_conditioned else None
        self._configure()
        self._set_params(map_params(lambda t: t.to(self.device),
                                    field.params))
        self.ema_params = map_params(lambda t: t.detach().clone(),
                                     self.params)
        self.grid_state = self._init_grid_state()
        # `generator` is the same on every rank, `rank_generator` this
        # rank's own (the same object on a mesh of one rank)
        self.generator = torch.Generator(self.device).manual_seed(opt.seed)
        self.rank_generator = self.generator if self.ndev == 1 else \
            torch.Generator(self.device).manual_seed(int(
                np.random.SeedSequence([opt.seed, self.mesh.rank])
                .generate_state(1)[0]))
        self.error_map = None      # [n, 128 * 128] on the device
        self._draw = None          # the last step's (image, inds_coarse)
        self._loss_per_ray = None  # and its rays' MSE
        self._forget_dyn_host_state()
        self.epoch = 0
        self.global_step = 0
        self.stats = {"loss": [], "valid_loss": [], "results": [],
                      "best_result": None}
        # per-step losses and sample counts and per-epoch seconds of train()
        # (not checkpointed)
        self.history = {"loss": [], "n_samples": [], "epoch_s": []}
        os.makedirs(self.workspace, exist_ok=True)
        self.log_path = os.path.join(self.workspace, f"log_{name}.txt")
        # GT-free semantic guidance: image [H, W, 3] -> scalar,
        # differentiable; callers may set their own
        self.semantic_loss_fn = None
        self._pose_rng = np.random.default_rng(opt.seed)
        if opt.rand_pose >= 0 and opt.clip_text:
            from .clip_guidance import CLIPGuidance
            guide = CLIPGuidance(opt.clip_text, device=self.device)
            if guide.available:
                self.semantic_loss_fn = guide.loss_fn
            else:
                self.log("[WARN] --clip_text set but CLIP weights are "
                         "unavailable offline; GT-free semantic steps "
                         f"disabled ({guide.reason})")
        path = None if use_checkpoint == "scratch" else \
            resolve_checkpoint(self.workspace, name, use_checkpoint)
        if path is not None:
            self.load_checkpoint(path,
                                 model_only=use_checkpoint == "latest_model")
        else:
            if use_checkpoint != "scratch":
                self.log(f"[INFO] no checkpoint found for '{use_checkpoint}',"
                         " starting from the seeded init")
            self._replicate()

    # ---------------------------------------------- field-specific set-up
    def _check_field(self, field, opt, time_conditioned: bool):
        if not isinstance(field.cfg, (NGPConfig, DNeRFConfig, TensoRFConfig)):
            raise TypeError("Trainer takes an Instant-NGP, D-NeRF or TensoRF "
                            "field (models/api.py); FastTrainer the CP field")
        if time_conditioned != isinstance(field.cfg, DNeRFConfig):
            raise ValueError("time_conditioned goes with a DNeRFConfig "
                             "field, and only with one")

    def _configure(self):
        """Set-up of the subclass before the params are installed."""
        # the adaptive packed budget: the measured mean samples per ray,
        # kept as an EMA, and the budget of training steps
        self.mean_count = 0.0
        self.local_step = 0
        self._cur_budget = self.opt.samples_per_ray

    def _adopt_params(self, params, path: str):
        """Check a checkpoint's params against the field (a checkpoint
        stores no field config)."""
        check_params(params, self.field)

    # ------------------------------------------------------------- util
    def log(self, *msg):
        """Print and append to the workspace's log (rank 0 only)."""
        if not self._writes():
            return
        text = " ".join(str(m) for m in msg)
        print(text, flush=True)
        with open(self.log_path, "a") as f:
            f.write(text + "\n")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _replicate(self):
        """Rank 0's params, EMA, Adam moments and grid state on every rank
        (after the seeded init and after a checkpoint load)."""
        if self.ndev == 1:
            return
        leaves = param_leaves(self.params)
        ts = list(leaves)
        if self.ema_params is not None:
            ts += param_leaves(self.ema_params)
        for p in leaves:
            st = self.optimizer.state.get(p)
            if st:
                ts += [st["exp_avg"], st["exp_avg_sq"]]
        ts += [v for v in self.grid_state.values() if torch.is_tensor(v)]
        replicate(self.mesh, ts)
        self._forget_dyn_host_state()

    def _writes(self) -> bool:
        """Whether this rank writes the run's files: rank 0."""
        return self.mesh.rank == 0

    def _init_grid_state(self):
        if self.time_conditioned:
            return init_dyn_grid_state(self.dyn_grid_cfg, self.device)
        return init_grid_state(self.grid_cfg, self.device)

    def _forget_dyn_host_state(self):
        """Drop what a trainer keeps beside the dynamic grid's state: the
        host copies of iter_density and bin_cursor and the per-bin sums of
        the density grid (FastTrainer). To be called whenever the grid state
        is replaced or rewritten."""
        self._dyn_calls = self._dyn_cursor = self._dyn_bin_sums = None

    def _infer_params(self):
        """The EMA params (the params when there are none)."""
        return self.ema_params if self.ema_params is not None \
            else self.params

    # -------------------------------------------------------- optimizer
    def _set_params(self, params):
        """Install f32 leaf params that take gradients, and a fresh Adam
        (betas 0.9/0.99, eps 1e-15) over `_param_groups` with the schedule
        lr * 0.1 ** min(step / iters, 1), stepped after each update."""
        self.params = map_params(
            lambda t: t.detach().float().requires_grad_(True), params)
        self.field.params = self.params
        iters = self.opt.iters
        self.optimizer = torch.optim.Adam(self._param_groups(), lr=self.opt.lr,
                                          betas=(0.9, 0.99), eps=1e-15)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda k: 0.1 ** min(k / iters, 1.0))

    def _param_groups(self):
        """The optimizer's param groups: every leaf at lr, or with lr_net the
        MLP towers at lr_net and the tables at lr (the reference's
        optax.multi_transform over the same two labels)."""
        leaves = param_leaves(self.params)
        if self.opt.lr_net is None:
            return [{"params": leaves, "lr": self.opt.lr}]
        labels = self._leaf_labels()
        return [{"params": [p for p, lab in zip(leaves, labels)
                            if lab == name], "lr": lr}
                for name, lr in (("enc", self.opt.lr),
                                 ("net", self.opt.lr_net))]

    def _leaf_labels(self):
        """"net" or "enc" per leaf in param_leaves order: "net" for the
        leaves under a top-level key that contains "mlp" or "basis"."""
        out = []
        for k in sorted(self.params):
            lab = "net" if ("mlp" in k or "basis" in k) else "enc"
            out += [lab] * len(param_leaves(self.params[k]))
        return out

    def _optimizer_count(self) -> int:
        st = self.optimizer.state.get(param_leaves(self.params)[0])
        return int(st["step"]) if st else 0

    def current_lr(self) -> float:
        """The lr that the schedule gives at the optimizer's own update
        count (reference Trainer.current_lr)."""
        return float(self.opt.lr * 0.1 ** min(
            self._optimizer_count() / self.opt.iters, 1.0))

    def _optimizer_state(self):
        """Adam's state in the reference's optax layout, so that a full
        checkpoint resumes in either package. With one rate:
        ((count, mu, nu), (schedule count,)), mu and nu shaped like the
        params. With lr_net, optax.multi_transform's:
        ({label: (((count, mu, nu), (schedule count,)),)},) for the labels
        "enc" and "net", where mu and nu hold an empty tuple in place of
        every leaf of the other label."""
        leaves = param_leaves(self.params)
        st = [self.optimizer.state.get(p, {}) for p in leaves]
        mu = [s["exp_avg"] if s else torch.zeros_like(p)
              for s, p in zip(st, leaves)]
        nu = [s["exp_avg_sq"] if s else torch.zeros_like(p)
              for s, p in zip(st, leaves)]
        count = np.int32(self._optimizer_count())
        sched = np.int32(self.scheduler.last_epoch)
        if self.opt.lr_net is None:
            return ((count, unflatten_like(self.params, mu),
                     unflatten_like(self.params, nu)), (sched,))
        labels = self._leaf_labels()

        def only(vals, name):
            return unflatten_like(self.params, [
                v if lab == name else () for v, lab in zip(vals, labels)])
        return ({name: (((count, only(mu, name), only(nu, name)),
                         (sched,)),) for name in ("enc", "net")},)

    def _load_optimizer_state(self, opt_state):
        leaves = param_leaves(self.params)
        multi = isinstance(opt_state[0], dict)
        if multi != (self.opt.lr_net is not None):
            self.log("[WARN] the checkpoint's optimizer state is for "
                     f"{'two rates (lr_net)' if multi else 'one rate'}, this "
                     "trainer's is not; not loaded")
            return
        if multi:
            # merge the two labels' moments back into leaf order
            labels = self._leaf_labels()
            per = {}
            for name in ("enc", "net"):
                (count, m, v), (sched,) = opt_state[0][name][0]
                per[name] = (iter(param_leaves(m)), iter(param_leaves(v)))
            try:
                mu = [next(per[lab][0]) for lab in labels]
                nu = [next(per[lab][1]) for lab in labels]
            except StopIteration:
                mu = nu = []
        else:
            (count, mu, nu), (sched,) = opt_state
            mu, nu = param_leaves(mu), param_leaves(nu)
        if len(mu) != len(leaves) or len(nu) != len(leaves) or any(
                tuple(np.shape(a)) != tuple(p.shape)
                for a, p in zip(mu, leaves)):
            self.log("[WARN] optimizer state does not match the params; "
                     "not loaded")
            return
        count = int(count)
        if count > 0:
            for p, m, v in zip(leaves, mu, nu):
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": torch.as_tensor(np.asarray(m),
                                               device=self.device).clone(),
                    "exp_avg_sq": torch.as_tensor(np.asarray(v),
                                                  device=self.device).clone()}
        sched = int(sched)
        self.scheduler.last_epoch = sched
        for g, base, lam in zip(self.optimizer.param_groups,
                                self.scheduler.base_lrs,
                                self.scheduler.lr_lambdas):
            g["lr"] = base * lam(sched)

    @torch.no_grad()
    def _ema_update(self):
        """e = d * e + (1 - d) * p over every leaf."""
        leaves = param_leaves(self.params)
        if self.ema_params is None:
            self.ema_params = map_params(lambda t: t.detach().clone(),
                                         self.params)
            return
        d = self.opt.ema_decay
        ema = param_leaves(self.ema_params)
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, leaves, alpha=1.0 - d)

    def reduce_gradients(self, loss):
        """On a mesh of more than one rank: every stepped leaf's .grad and
        the loss averaged over the ranks, in one collective -> the loss (the
        ranks' mean; `loss` itself on one rank)."""
        if self.ndev == 1:
            return loss
        grads = [p.grad for g in self.optimizer.param_groups
                 for p in g["params"] if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [loss.detach().reshape(1).float()])
        pmean(self.mesh, flat)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return flat[-1]

    def apply_gradients(self):
        """Adam step on the leaves' .grad, then the schedule and the EMA."""
        self.optimizer.step()
        self.scheduler.step()
        self._ema_update()

    # ------------------------------------------------------------- grid
    def _density_fn(self, params):
        """The grid's density query on `params`: (pts [N, 3][, t]) -> sigma
        [N], in chunks of DENSITY_CHUNK points."""
        density = self.field.density

        def query(pts, *t):
            return torch.cat([density(params, pts[i:i + DENSITY_CHUNK], *t)[0]
                              for i in range(0, pts.shape[0], DENSITY_CHUNK)])
        return query

    def _update_interval(self) -> int:
        """Steps between grid refreshes; a dynamic refresh covers
        bins_per_call of time_size bins, so its interval shrinks in that
        proportion (16 * 8 / 64 = 2)."""
        if self.time_conditioned:
            d = self.dyn_grid_cfg
            return max(1, int(self.opt.update_extra_interval
                              * d.bins_per_call / d.time_size))
        return self.opt.update_extra_interval

    def _update_budget(self):
        """Shrink the packed budget toward 1.5 x the measured mean samples
        per ray, to the smallest of 8, 12, 16, 24, 32 and samples_per_ray
        that holds it (never above samples_per_ray)."""
        if self.mean_count <= 0:
            return
        want = 1.5 * self.mean_count
        bucket = self.opt.samples_per_ray
        for b in sorted(set(BUDGET_BUCKETS) | {self.opt.samples_per_ray}):
            if b >= want:
                bucket = b
                break
        if bucket != self._cur_budget:
            self.log(f"[INFO] packed sample budget {self._cur_budget} -> "
                     f"{bucket} (mean {self.mean_count:.1f} samples/ray)")
            self._cur_budget = bucket

    @torch.no_grad()
    def update_extra_state(self):
        """One grid refresh of training, on the current params: full sweeps
        while iter_density < 16 (a dynamic grid counts passes over its bins),
        then H^3 / 2 random cells; a dynamic grid freezes after
        freeze_calls. Past the first 16 the packed budget may shrink."""
        it = int(self.grid_state["iter_density"])
        if it >= 16:
            self._update_budget()
        if self.time_conditioned:
            if it >= self.dyn_grid_cfg.freeze_calls:
                return
            self.grid_state = update_dyn_density_grid(
                self.grid_state, self._density_fn(self.params),
                self.dyn_grid_cfg, full=it < 16, generator=self.generator)
            return
        self.grid_state = update_density_grid(
            self.grid_state, self._density_fn(self.params), self.grid_cfg,
            full=it < 16, generator=self.generator)

    @torch.no_grad()
    def rebuild_grid(self):
        """Full-sweep occupancy rebuild from the inference params; of a
        time-conditioned grid, of every time bin (its pass count kept)."""
        fn = self._density_fn(self._infer_params())
        if self.time_conditioned:
            passes = self.grid_state["iter_density"].clone()
            self.grid_state = rebuild_dyn_density_grid(
                self.grid_state, fn, self.dyn_grid_cfg,
                generator=self.generator)
            self.grid_state["iter_density"] = passes
            return
        self.grid_state = update_density_grid(
            self.grid_state, fn, self.grid_cfg, full=True,
            generator=self.generator, mesh=self.mesh)

    @torch.no_grad()
    def mark_untrained_grid(self, poses, intrinsics):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=self.device)
        if self.time_conditioned:
            self.grid_state = mark_untrained_dyn_grid(
                self.grid_state, t(poses), t(intrinsics), self.dyn_grid_cfg)
            self._forget_dyn_host_state()
            return
        self.grid_state = mark_untrained_grid(
            self.grid_state, t(poses), t(intrinsics), self.grid_cfg)

    def adopt_grid_state(self, grid_state):
        """Take over a copy of another trainer's grid state of the same kind
        (the editing student starts from its teacher's), iter_density
        included; the host copies of the dynamic grid's counters are
        dropped."""
        self.grid_state = {k: v.detach().clone().to(self.device)
                           for k, v in grid_state.items()}
        self._forget_dyn_host_state()

    def _occ_at(self, t):
        """The occupancy that a ray batch at time t marches: the grid of a
        static field, the bin of t (picked on the device) of a dynamic one."""
        occ = self.grid_state["occ"]
        if not self.time_conditioned:
            return occ
        return occ.index_select(
            0, time_slice_index(t, self.dyn_grid_cfg).reshape(1))[0]

    # --------------------------------------------------------- training
    def sample_batch(self, data, h: int, w: int):
        """One step's draws: an image, num_rays pixels of it (uniform, p x p
        patches, or by the error map), a background per ray (RGBA images)
        and per-ray march noise -> (rays_o, rays_d, gt, bg, noise), and for
        a time-conditioned field also the image's time t (a 0-d tensor on
        the device). The image and the error map's cells are kept in
        self._draw for the error map's update.

        Everything is drawn on the device from the rank's own stream
        (rank_generator), num_rays / N rays on a mesh of N ranks.
        With host-resident images (data["host_images"], preload=False) the
        image's index and the pixel indices then come back to the host in
        one fetch, which waits for the device, and only those pixels are
        gathered there and copied: the draws are the preloaded run's, so a
        seed trains the same field either way."""
        g, dev, n = self.rank_generator, self.device, self.n_local_rays
        n_img = self.n_allowed_images(self.global_step,
                                      data["poses"].shape[0])
        img = torch.randint(0, n_img, (1,), generator=g, device=dev)
        emap = None if self.error_map is None else self.error_map[img]
        rays = get_rays(data["poses"][img], data["intrinsics"], h, w, n,
                        generator=g, error_map=emap,
                        patch_size=self.opt.patch_size)
        inds, ic = rays["inds"][0], rays["inds_coarse"]
        if "images" in data:
            c = data["images"].shape[-1]
            pix = data["images"].reshape(-1, c)[img * (h * w) + inds]
        else:
            host = profiling.fetch(torch.cat([img, inds]))
            pix = host_pixels(data["host_images"], int(host[0]), host[1:],
                              dev)
            c = pix.shape[-1]
        self._draw = (img, None if ic is None else ic[0])
        if c == 4:
            bg = torch.rand((pix.shape[0], 3), generator=g, device=dev)
            gt = pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])
        else:
            bg = torch.ones(3, device=dev)
            gt = pix
        noise = torch.rand((pix.shape[0],), generator=g, device=dev)
        batch = (rays["rays_o"][0], rays["rays_d"][0], gt, bg, noise)
        if self.time_conditioned:
            batch += (data["times"][img].reshape(()),)
        return batch

    @property
    def n_local_rays(self) -> int:
        """This rank's rays of a step: num_rays // N."""
        return max(self.opt.num_rays // self.ndev, 1)

    def n_allowed_images(self, step: int, n_images: int) -> int:
        """How many of the frames step `step` may draw from: all of them
        (FastTrainer's time curriculum narrows this)."""
        return n_images

    def loss_on(self, rays_o, rays_d, gt, bg, noise=None, t=None, x_tv=None,
                params=None):
        """MSE of render_occ at the current packed budget, with the march's
        start offsets `noise`, on the current occupancy (of t's bin for a
        time-conditioned field), plus tv_weight * the table's TV energy at
        points x_tv [N, 3] in [0, 1] when given -> (loss, n_samples),
        differentiable in the params."""
        params = self.params if params is None else params
        extra = () if t is None else (t,)
        render = functools.partial(
            render_occ, params, self._occ_at(t), rays_o, rays_d,
            self.settings, bg_fn=self.field.background, bg_color=bg,
            perturb=True, noise=noise,
            m_budget=rays_o.shape[0] * self._cur_budget, extra=extra)
        res = render(self.field.forward)
        # CCNeRF's K-loss: every truncation level on the same samples
        trunc = self.field.forward_trunc
        levels = [render(functools.partial(trunc, frac=frac))["image"]
                  for frac in self.opt.k_rank_fracs] if trunc else []
        loss = self._image_loss(res["image"], gt, levels)
        if x_tv is not None and self.field.tv_loss is not None:
            loss = loss + self.opt.tv_weight * self.field.tv_loss(params,
                                                                  x_tv)
        return loss, res["n_samples"]

    def _image_loss(self, image, gt, levels=()):
        """The photometric loss of a step: the mean over the rays of their
        MSE over the channels (kept, detached, in self._loss_per_ray for the
        error map), averaged with the MSE of each truncation level's image
        in `levels` (CCNeRF's K-loss), plus with patch_size > 1 the patch
        term."""
        per_ray = torch.mean((image - gt) ** 2, dim=-1)
        self._loss_per_ray = per_ray.detach()
        loss = torch.mean(per_ray)
        if levels:
            loss = (loss + sum(torch.mean((im - gt) ** 2) for im in levels)
                    ) / (1 + len(levels))
        return loss + patch_criterion(image, gt, self.opt.patch_size)

    def _update_error_map(self):
        """After a step with the error map on: its update at the step's
        image and cells; on a mesh, the map plus the sum of the ranks'
        changes (the reference's psum of deltas)."""
        if self.error_map is None or self._draw[1] is None:
            return
        if self.ndev == 1:
            update_error_map(self.error_map, self._draw[0], self._draw[1],
                             self._loss_per_ray)
            return
        new = update_error_map(self.error_map.clone(), self._draw[0],
                               self._draw[1], self._loss_per_ray)
        self.error_map += psum(self.mesh, new - self.error_map)

    def semantic_due(self, step: int) -> bool:
        """Whether step `step` of the loop is a GT-free semantic step: with
        a semantic_loss_fn and rand_pose >= 0, every step (rand_pose 0) or
        every (rand_pose + 1)-th (step % (rand_pose + 1) == rand_pose)."""
        rp = self.opt.rand_pose
        return self.semantic_loss_fn is not None and rp >= 0 and \
            (rp == 0 or step % (rp + 1) == rp)

    def train_step(self, data, h: int, w: int):
        """One step of the loop -> (loss, n_samples) as device tensors: the
        grid refresh when it is due, then a semantic step when
        semantic_due (n_samples 0), else train_step_gt."""
        if self.global_step % self._update_interval() == 0:
            self.update_extra_state()
        if self.semantic_due(self.global_step):
            loss = self.train_step_semantic(data["intrinsics"], h)
            return loss, torch.zeros((), dtype=torch.int64,
                                     device=self.device)
        return self.train_step_gt(data, h, w)

    def train_step_gt(self, data, h: int, w: int):
        """One step on the ground truth: draw the rays, take the loss,
        Adam, the schedule and the EMA -> (loss, n_samples)."""
        batch = self.sample_batch(data, h, w)
        x_tv = None
        if self.opt.tv_weight > 0 and self.field.tv_loss is not None:
            x_tv = torch.rand((self.n_local_rays, 3),
                              generator=self.rank_generator,
                              device=self.device)
        ro, rd, gt, bg, noise = batch[:5]
        loss, n_samples = self.loss_on(ro, rd, gt, bg, noise, *batch[5:],
                                       x_tv=x_tv)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = self.reduce_gradients(loss)
        self.apply_gradients()
        self._update_error_map()
        self.global_step += 1
        self.local_step += 1
        if self.local_step % 16 == 0:
            # rank 0's count, so that every rank takes the same budget
            per_ray = from_rank0(self.mesh, float(n_samples)) \
                / self.n_local_rays
            self.mean_count = per_ray if self.mean_count == 0 else \
                0.8 * self.mean_count + 0.2 * per_ray
        return loss.detach(), n_samples

    def train_step_semantic(self, intrinsics, h: int):
        """One GT-free step: a random orbit pose (radius U(1, 1.5)) rendered
        at clip_res x clip_res through render_occ with a white background
        and no march jitter, on the current occupancy (a time-conditioned
        field at t = 0), with the intrinsics of an h-high frame scaled to
        it and the principal point at its centre; Adam, the schedule and the
        EMA on semantic_loss_fn(image [clip_res, clip_res, 3]) -> the loss,
        a 0-d device tensor."""
        res, dev = self.opt.clip_res, self.device
        intr = torch.as_tensor(intrinsics, dtype=torch.float32,
                               device=dev) * (res / float(h))
        intr = torch.cat([intr[:2], intr.new_full((2,), res / 2.0)])
        radius = self._pose_rng.uniform(1.0, 1.5)
        pose = torch.as_tensor(rand_poses(self._pose_rng, 1, radius=radius),
                               device=dev)
        rays = get_rays(pose, intr, res, res)
        t = torch.zeros((), device=dev) if self.time_conditioned else None
        out = render_occ(self.params, self._occ_at(t), rays["rays_o"][0],
                         rays["rays_d"][0], self.settings, self.field.forward,
                         self.field.background,
                         bg_color=torch.ones(3, device=dev),
                         extra=() if t is None else (t,))
        loss = self.semantic_loss_fn(out["image"].reshape(res, res, 3))
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.apply_gradients()
        self.global_step += 1
        self.local_step += 1
        return loss.detach()

    def _prepare_train(self, train_dataset):
        """The dataset that train() trains on (FastTrainer sorts a dynamic
        one by time for its curriculum)."""
        return train_dataset

    def _device_data(self, train_dataset):
        """The training data on the device. preload=False: as the
        reference's Trainer, warn and preload (FastTrainer keeps the images
        on the host)."""
        if not self.opt.preload:
            self.log("[WARN] preload=False is supported on the fast path "
                     "(FastTrainer) only; preloading to the device")
        return train_dataset.device(self.device)

    def _init_error_map(self, n_images: int, error_map=None):
        """With opt.error_map and no map yet: the map of the training
        images on the device, from the dataset's (error_map [n, 128 *
        128]) or ones."""
        if not self.opt.error_map or self.error_map is not None:
            return
        if error_map is None:
            error_map = np.ones((n_images, ERROR_MAP_RES ** 2), np.float32)
        self.error_map = torch.as_tensor(np.asarray(error_map, np.float32),
                                         device=self.device).clone()

    def _ready_for_steps(self, data):
        """Per-run state that training steps read, set before the first
        step of train() or train_gui() on the device data `data`."""
        self._init_error_map(data["poses"].shape[0])

    def train(self, train_dataset, valid_dataset=None, max_epochs: int = 1):
        """Epochs of max(n_images, segment_steps) steps until opt.iters;
        evaluation and the best checkpoint every eval_interval epochs, a
        full checkpoint at most once a minute and one at the end (a dynamic
        grid alone is 640 MB to fetch and write)."""
        train_dataset = self._prepare_train(train_dataset)
        self.mark_untrained_grid(train_dataset.poses,
                                 train_dataset.intrinsics)
        data = self._device_data(train_dataset)
        self._init_error_map(len(train_dataset), train_dataset.error_map)
        self._ready_for_steps(data)
        h, w = train_dataset.h, train_dataset.w
        steps_per_epoch = max(len(train_dataset), self.opt.segment_steps)
        last_ckpt = time.perf_counter()
        for _ in range(max_epochs):
            if self.global_step >= self.opt.iters:
                break
            self.epoch += 1
            self._sync()
            t0 = time.perf_counter()
            out = [self.train_step(data, h, w)
                   for _ in range(steps_per_epoch)]
            losses = torch.stack([o[0] for o in out]).tolist()
            self._sync()
            dt = time.perf_counter() - t0
            self.history["loss"] += losses
            self.history["n_samples"] += torch.stack(
                [torch.as_tensor(o[1]) for o in out]).tolist()
            self.history["epoch_s"].append(dt)
            mean_loss = float(np.mean(losses))
            self.stats["loss"].append(mean_loss)
            rays_s = steps_per_epoch * self.opt.num_rays / dt
            self.log(f"[epoch {self.epoch}] loss={mean_loss:.6f} "
                     f"{dt:.2f}s ({rays_s:,.0f} rays/s) "
                     f"step={self.global_step}")
            if valid_dataset is not None and \
                    self.epoch % self.opt.eval_interval == 0:
                self.evaluate_one_epoch(valid_dataset)
                self.save_checkpoint(best=True)
            # rank 0's clock decides, so that the ranks write together
            if from_rank0(self.mesh,
                          time.perf_counter() - last_ckpt) > 60.0:
                self.save_checkpoint(full=True)
                last_ckpt = time.perf_counter()
        self.save_checkpoint(full=True)

    # -------------------------------------------------------- rendering
    @torch.no_grad()
    def render_image(self, pose, intrinsics, h, w, bg_color=None,
                     downscale: int = 1, params=None, time=None):
        """Whole-frame render -> (rgb f32 [rh, rw, 3] in [0, 1], depth f32
        [rh, rw]) as numpy arrays: render_occ over chunks of 4 *
        max_ray_batch rays, each with a packed budget of
        eval_samples_per_ray per ray of a whole chunk (a last, shorter
        chunk keeps the budget of a whole one, as the reference's padded
        chunk does). A time-conditioned field renders at `time` (None: 0)
        on the occupancy of that time's bin.

        On a CUDA device the arrays live in page-locked host memory
        (profiling.fetch_frame), each in a block of its own: a caller who
        keeps many frames keeps that memory pinned."""
        with profiling.span("frame"):
            with profiling.span("frame.setup"):
                rh, rw = int(h // downscale), int(w // downscale)
                dev = self.device
                params = params if params is not None \
                    else self._infer_params()
                # copies from pageable host memory: each waits for the card
                pose_t = torch.as_tensor(np.asarray(pose, np.float32),
                                         device=dev)
                intr = torch.as_tensor(np.asarray(intrinsics, np.float32),
                                       device=dev) / downscale
                profiling.host_sync(dev, 2)
                rays = get_rays(pose_t[None], intr, rh, rw)
                ro, rd = rays["rays_o"][0], rays["rays_d"][0]
                occ, extra = self.grid_state["occ"], ()
                if self.time_conditioned:
                    if isinstance(time, torch.Tensor):
                        profiling.host_sync(time)   # float() reads the card
                    t = 0.0 if time is None else float(time)
                    occ = occ[time_slice_index(t, self.dyn_grid_cfg)]
                    extra = (t,)
                bg = None
                if bg_color is not None:
                    bg = torch.as_tensor(np.asarray(bg_color, np.float32),
                                         device=dev)
                    profiling.host_sync(dev)
            chunk = 4 * self.opt.max_ray_batch
            imgs, deps = [], []
            for i in range(0, ro.shape[0], chunk):
                res = render_occ(
                    params, occ, ro[i:i + chunk], rd[i:i + chunk],
                    self.settings, self.field.forward, self.field.background,
                    bg_color=bg,
                    m_budget=chunk * self.opt.eval_samples_per_ray,
                    extra=extra)
                imgs.append(res["image"])
                deps.append(res["depth"])
            with profiling.span("frame.stitch"):
                img = torch.cat(imgs).clamp(0.0, 1.0).reshape(rh, rw, 3)
                depth = torch.cat(deps).reshape(rh, rw)
            with profiling.span("frame.fetch"):
                return profiling.fetch_frame(img, depth)

    def _time_of(self, dataset, i):
        """The i-th view's time for a time-conditioned field, else None."""
        if self.time_conditioned and dataset.times is not None:
            return dataset.times[i]
        return None

    def evaluate_one_epoch(self, dataset, name: Optional[str] = None):
        self.log(f"++> Evaluate at epoch {self.epoch}")
        for m in self.metrics:
            m.clear()
        losses = []
        val_dir = os.path.join(self.workspace, "validation")
        os.makedirs(val_dir, exist_ok=True)
        name = name or f"{self.name}_ep{self.epoch:04d}"
        for i in range(len(dataset)):
            img, depth = self.render_image(dataset.poses[i],
                                           dataset.intrinsics, dataset.h,
                                           dataset.w,
                                           time=self._time_of(dataset, i))
            gt = dataset.images[i]
            if gt.shape[-1] == 4:
                gt = gt[..., :3] * gt[..., 3:] + 1.0 * (1 - gt[..., 3:])
            losses.append(float(np.mean((img - gt) ** 2)))
            for m in self.metrics:
                m.update(img, gt)
            if not self._writes():
                continue
            write_png(os.path.join(val_dir, f"{name}_{i:04d}_rgb.png"),
                      (np.clip(img, 0, 1) * 255).astype(np.uint8))
            dmax = float(depth.max())
            write_png(os.path.join(val_dir, f"{name}_{i:04d}_depth.png"),
                      (np.clip(depth / dmax if dmax > 0 else depth, 0, 1)
                       * 255).astype(np.uint8))
        barrier(self.mesh)
        result = self.metrics[0].measure()
        self.stats["results"].append(result)
        self.stats["valid_loss"].append(float(np.mean(losses)))
        self.log("++> " + " | ".join(m.report() for m in self.metrics))
        return result

    def evaluate(self, dataset, name=None):
        return self.evaluate_one_epoch(dataset, name)

    def test(self, dataset, save_path=None, name=None,
             write_video: bool = True):
        """Render every pose of the dataset and save the frames as PNG, and
        with write_video also as {name}_rgb.mp4 at 25 fps when an encoder
        (imageio with an ffmpeg backend) can be imported; else log that and
        keep the PNGs. Returns the mp4's path, or None."""
        save_path = save_path or os.path.join(self.workspace, "results")
        name = name or f"{self.name}_ep{self.epoch:04d}"
        os.makedirs(save_path, exist_ok=True)
        frames = []
        for i in range(len(dataset)):
            img, _ = self.render_image(dataset.poses[i], dataset.intrinsics,
                                       dataset.h, dataset.w,
                                       time=self._time_of(dataset, i))
            u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            if self._writes():
                write_png(os.path.join(save_path, f"{name}_{i:04d}_rgb.png"),
                          u8)
            frames.append(u8)
        video = None
        if write_video and frames and self._writes():
            video = self._write_video(
                os.path.join(save_path, f"{name}_rgb.mp4"), frames)
        barrier(self.mesh)
        self.log(f"==> Saved test results to {save_path}")
        return video

    def _write_video(self, path, frames):
        """frames as an mp4 at VIDEO_FPS through imageio -> path, or None
        (logged) when no encoder can be imported or it fails."""
        try:
            import imageio
            imageio.mimwrite(path, np.stack(frames), fps=VIDEO_FPS,
                             quality=8, macro_block_size=1)
        except Exception as e:
            if os.path.exists(path):
                os.remove(path)
            self.log(f"[WARN] mp4 export unavailable ({e!r}); frames saved "
                     "as PNG")
            return None
        return path

    # -------------------------------------------------------------- GUI
    def train_gui(self, data, h: int, w: int, step: int = 16):
        """`step` training steps for the GUI on data, a dataset's device()
        dict of h x w images -> {"loss": their mean loss, "lr":
        current_lr(), "time": seconds}."""
        t0 = time.perf_counter()
        self._ready_for_steps(data)
        losses = [self.train_step(data, h, w)[0] for _ in range(step)]
        loss = float(torch.stack(losses).mean())
        return {"loss": loss, "lr": self.current_lr(),
                "time": time.perf_counter() - t0}

    def test_gui(self, pose, intrinsics, w, h, bg_color=None, spp=1,
                 downscale=1, time=None, need_depth=True):
        """A GUI frame -> {"image": f32 [rh, rw, 3], "depth": f32 [rh,
        rw]}. downscale snaps to the nearest of 1, 2, 4 and 8; the depth is
        always returned (need_depth is advisory here). On a CUDA device the
        arrays are pinned, as render_image's are."""
        downscale = min(GUI_DOWNSCALES, key=lambda b: abs(b - downscale))
        img, depth = self.render_image(pose, intrinsics, h, w,
                                       bg_color=bg_color,
                                       downscale=downscale, time=time)
        return {"image": img, "depth": depth}

    # ------------------------------------------------------------- mesh
    def save_mesh(self, save_path=None, resolution: int = 256,
                  threshold: float = 10.0):
        """The inference field's density on a resolution^3 grid of the
        bound box (through _density_fn: K1 density-only on a CP field; a
        time-conditioned field at t = 0), its iso-surface at threshold by
        marching tetrahedra, written as PLY -> (path, verts, tris). The
        seconds of the sweep and of the tetrahedra are kept in
        self.mesh_seconds."""
        from ..utils.meshing import extract_fields, marching_tetrahedra, \
            save_ply
        save_path = save_path or os.path.join(
            self.workspace, "meshes", f"{self.name}_{self.epoch}.ply")
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        b = self.opt.bound
        bmin, bmax = np.full(3, -b), np.full(3, b)
        fn = self._density_fn(self._infer_params())
        query = (lambda pts: fn(pts, 0.0)) if self.time_conditioned else fn
        self._sync()
        t0 = time.perf_counter()
        field = extract_fields(bmin, bmax, resolution, query, self.device)
        t1 = time.perf_counter()
        verts, tris = marching_tetrahedra(field, threshold, bmin, bmax)
        t2 = time.perf_counter()
        if self._writes():
            save_ply(save_path, verts, tris)
        barrier(self.mesh)
        self.mesh_seconds = {"sweep": t1 - t0, "tetrahedra": t2 - t1}
        self.log(f"==> Saved mesh to {save_path} ({len(verts)} verts, "
                 f"{len(tris)} tris; sweep {t1 - t0:.2f} s, tetrahedra "
                 f"{t2 - t1:.2f} s)")
        return save_path, verts, tris

    # ------------------------------------------------------ checkpoints
    def save_checkpoint(self, path: Optional[str] = None, full: bool = False,
                        best: bool = False) -> Optional[str]:
        """Write params, EMA params and the grid in the reference's .npz
        format; full=True adds the optimizer state. best=True writes the
        slim {name}.npz (no density grid or occupancy) when the last
        evaluation is the best so far. The epoch files keep a rolling window
        of max_keep_ckpt. Returns the path written, or None."""
        ckpt_dir = os.path.join(self.workspace, "checkpoints")
        state = {"model": {"params": self.params, "ema": self.ema_params},
                 "grid": self.grid_state}
        if full:
            state["optimizer"] = self._optimizer_state()
        meta = {"epoch": self.epoch, "global_step": self.global_step,
                "stats": {k: v for k, v in self.stats.items()
                          if k != "best_result"}}
        if best:
            if not self.stats["results"]:
                return None
            result, prev = self.stats["results"][-1], self.stats["best_result"]
            if prev is not None and result <= prev:   # PSNR: bigger is better
                return None
            self.stats["best_result"] = result
            state["grid"] = {k: v for k, v in self.grid_state.items()
                             if k not in ("density_grid", "occ")}
            path = path or os.path.join(ckpt_dir, f"{self.name}.npz")
            self._write_checkpoint(path, state, meta)
            return path
        if path is None:
            path = os.path.join(ckpt_dir,
                                f"{self.name}_ep{self.epoch:04d}.npz")
            self._write_checkpoint(path, state, meta, prune=True)
            return path
        self._write_checkpoint(path, state, meta)
        return path

    def _write_checkpoint(self, path, state, meta, prune: bool = False):
        """Rank 0 writes (and with prune keeps the rolling window); the
        ranks wait for it."""
        if self._writes():
            save_checkpoint(path, state, meta)
            if prune:
                prune_checkpoints(self.workspace, self.name,
                                  self.opt.max_keep_ckpt)
        barrier(self.mesh)

    def load_checkpoint(self, path: str, model_only: bool = False):
        state, meta = load_checkpoint(path)
        dev = self.device
        self._adopt_params(state["model"]["params"], path)
        self._set_params(params_from_jax(state["model"]["params"], dev))
        if not model_only:
            # before the grid: FastTrainer's rebuild queries the params
            # annealed at the checkpoint's step
            self.epoch = meta.get("epoch", 0)
            self.global_step = meta.get("global_step", 0)
        if state["model"].get("ema") is not None:
            self.ema_params = params_from_jax(state["model"]["ema"], dev)
        else:
            self.ema_params = None
        if "grid" in state:
            # a grid of this trainer's kind: [T, CAS, H^3] for a
            # time-conditioned field, [CAS, H^3] for a static one
            g = self._init_grid_state()
            has_grid = "density_grid" in state["grid"]
            if has_grid and tuple(state["grid"]["density_grid"].shape) \
                    != tuple(g["density_grid"].shape):
                raise ValueError(
                    f"checkpoint density grid "
                    f"{tuple(state['grid']['density_grid'].shape)} does not "
                    f"fit this trainer's {tuple(g['density_grid'].shape)}")
            g.update({k: torch.as_tensor(np.asarray(v), device=dev)
                      for k, v in state["grid"].items()
                      if k in g and k != "occ"})
            if has_grid:
                thresh = torch.clamp(g["mean_density"],
                                     max=self.grid_cfg.density_thresh)
                g["occ"] = (g["density_grid"] > thresh).reshape(
                    g["occ"].shape)
            self.grid_state = g
            self._forget_dyn_host_state()
            if not has_grid:
                # slim checkpoints strip the grid: rebuild it from the
                # loaded params with a full density sweep (of every time
                # bin, for a time-conditioned field)
                self.rebuild_grid()
        if not model_only:
            if "stats" in meta:
                self.stats.update(meta["stats"])
                self.stats.setdefault("best_result", None)
            if "optimizer" in state:
                self._load_optimizer_state(state["optimizer"])
        self._replicate()
        self.log(f"[INFO] loaded checkpoint {path} "
                 f"(epoch {self.epoch}, step {self.global_step})")
