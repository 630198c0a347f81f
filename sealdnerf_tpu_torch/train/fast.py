"""FastTrainer for the CP field (port of sealdnerf_tpu/train/fast.py):
training and serving of the static field and of the time-conditioned one.

Training: a plain per-step loop (the reference's fori_loop segments only
amortised host-device transfers). One step refreshes the occupancy grid
every `update_extra_interval` steps (K1 density-only on the current
params), draws one image and `num_rays` random pixels on the device, a
random background per ray for RGBA images and per-ray march noise, renders
through `render_dense` with the field's forward K1 and backward K2
(ops/field.py), and applies Adam, the lr schedule and the EMA. All draws
come from the trainer's one device generator, seeded from `opt.seed`.

Serving: checkpoint loading, occupancy-grid rebuild and frustum marking,
whole-frame rendering through the tiled renderer, the evaluate/test loops.
On CPU tensors the field runs through the kernels' plain versions.

Time-conditioned fields (time_conditioned=True, a CPDNeRFConfig) use the
[T, CAS, H^3] grid of render/dynamic_grid.py and the dynamic kernels: K3
forward, K4 backward. A training step of one differs from the static step
in this:
- the grid refresh covers bins_per_call of the T time bins per call, so it
  may fire every update_extra_interval * bins_per_call / T steps: at every
  such step while warming up (the first 16 passes over all bins, on the
  deterministic half-grid slabs), at every other one after that, and never
  once the call count reaches `_dyn_freeze_calls`. grid_state["iter_density"]
  counts these calls. The refresh queries the current params, annealed;
- the image comes from a window of the time-sorted frames that grows to the
  full range over `time_curriculum_steps` steps, its time t stays on the
  device, and the step marches the occupancy of t's bin;
- coarse-to-fine: the first sigma matrix's rows of scales and planes with
  res > dyn_anneal_res are scaled by clip(step / dyn_anneal_steps, 0, 1)
  inside the differentiated function, so their gradient carries the same
  ramp; `_infer_params` applies it to the EMA params for rendering;
- `deform_zero_reg * mean(deform_raw(x, 0)^2)` at 1024 random scene points
  is added to the loss (plain PyTorch under autograd, as the reference
  computes it outside its kernels);
- with `lr_net` the MLP towers train at that rate and the tables at `lr`,
  as two Adam groups under one schedule.

Not ported yet: error-map and patch sampling, host-resident images
(preload=False), train_gui, the bucketed renderer (the reference switches
to it below 15 % occupancy; this port always renders tiled, the exact one
of the two) and the cascade march for bound > 1.
"""

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.rays import get_rays
from ..models.cp import (CPConfig, CPDNeRFConfig, _params_version,
                         config_from_params, map_params, param_leaves,
                         params_from_jax, unflatten_like)
from ..ops.field import (dyn_field_forward, dyn_field_train_forward,
                         field_forward, field_train_forward)
from ..ops.freq_encode import freq_output_dim
from ..ops.marching_dense import DenseMarchConfig, downsample_occ
from ..render.fast import render_dense
from ..render.dynamic_grid import (DynGridConfig, init_dyn_grid_state,
                                   mark_untrained_dyn_grid,
                                   rebuild_dyn_density_grid,
                                   refresh_dyn_density_grid,
                                   time_slice_index)
from ..render.fast_image import render_image_tiled
from ..render.grid import (GridConfig, init_grid_state, mark_untrained_grid,
                           refresh_indices, update_density_grid)
from ..utils.png import write_png
from .checkpoint import (load_checkpoint, prune_checkpoints,
                         resolve_checkpoint, save_checkpoint)
from .metrics import PSNRMeter
from .trainer import TrainOptions, cascades_for

N_ZERO_REG = 1024      # points of the deform regulariser per step


class FastTrainer:
    def __init__(self, name: str, opt: TrainOptions, field,
                 metrics: Optional[Sequence] = None,
                 workspace: Optional[str] = None,
                 use_checkpoint: str = "latest", device=None,
                 time_conditioned: bool = False):
        if not isinstance(field.cfg, CPConfig):
            raise NotImplementedError("only the CP field is ported")
        if time_conditioned != isinstance(field.cfg, CPDNeRFConfig):
            raise ValueError("time_conditioned goes with a CPDNeRFConfig "
                             "field, and only with one")
        if time_conditioned and opt.bound > 1.0:
            # the dynamic grid is single-cascade (D-NeRF recipes use bound 1)
            raise ValueError("the dynamic fast path serves bound <= 1 "
                             f"recipes (got bound={opt.bound})")
        self.time_conditioned = time_conditioned
        cascades = cascades_for(opt.bound)
        if cascades > 1 or opt.dt_gamma > 0.0:
            raise NotImplementedError(
                "bound > 1 or dt_gamma > 0 needs the cascade march, which is "
                "not ported yet")
        for flag, on in (("--error_map", opt.error_map),
                         ("--patch_size > 1", opt.patch_size > 1),
                         ("--no_preload", not opt.preload)):
            if on:
                raise NotImplementedError(f"{flag} is not yet ported")
        self.name = name
        self.opt = opt
        self.field = field
        self.metrics = list(metrics) if metrics is not None else [PSNRMeter()]
        self.workspace = workspace or opt.workspace
        self.device = torch.device(device) if device is not None \
            else field.params["lines"][0][0].device
        ni = opt.n_intervals * cascades
        self.march_cfg = DenseMarchConfig(
            bound=opt.bound, march_res=opt.march_res, n_intervals=ni,
            steps_per_interval=opt.steps_per_interval, min_near=opt.min_near,
            cascades=cascades, dt_gamma=opt.dt_gamma)
        self.render_cfg = DenseMarchConfig(
            bound=opt.bound,
            march_res=opt.render_march_res or opt.march_res,
            n_intervals=opt.render_n_intervals or 2 * ni,
            steps_per_interval=(opt.render_steps_per_interval
                                or opt.steps_per_interval),
            min_near=opt.min_near, cascades=cascades, dt_gamma=opt.dt_gamma)
        self.grid_cfg = GridConfig(
            bound=opt.bound, cascades=cascades, grid_size=opt.grid_size,
            density_thresh=opt.density_thresh,
            density_scale=opt.density_scale)
        self._set_params(map_params(lambda t: t.to(self.device),
                                    field.params))
        self.ema_params = map_params(lambda t: t.detach().clone(),
                                     self.params)
        self.dyn_grid_cfg = DynGridConfig(
            bound=opt.bound, cascades=cascades, grid_size=opt.grid_size,
            density_thresh=opt.density_thresh,
            density_scale=opt.density_scale) if time_conditioned else None
        self.grid_state = self._init_grid_state()
        self.generator = torch.Generator(self.device).manual_seed(opt.seed)
        self._occ_m = None
        self._time_sorted = False   # train() sorted the frames by time
        self._anneal_mask = self._build_anneal_mask()
        self._infer_cache = None    # (key, annealed inference params)
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
        if use_checkpoint != "scratch":
            path = resolve_checkpoint(self.workspace, name, use_checkpoint)
            if path is not None:
                self.load_checkpoint(path,
                                     model_only=use_checkpoint == "latest_model")
            else:
                self.log(f"[INFO] no checkpoint found for '{use_checkpoint}',"
                         " starting from the seeded init")

    def log(self, *msg):
        text = " ".join(str(m) for m in msg)
        print(text, flush=True)
        with open(self.log_path, "a") as f:
            f.write(text + "\n")

    def _init_grid_state(self):
        if self.time_conditioned:
            return init_dyn_grid_state(self.dyn_grid_cfg, self.device)
        return init_grid_state(self.grid_cfg, self.device)

    def _infer_params(self):
        """The EMA params (the params when there are none); of a dynamic
        field annealed at the current step, so that frames show the function
        that was trained. One annealed copy is kept per params version and
        step, so that the frames of an evaluation share its packed tables."""
        params = self.ema_params if self.ema_params is not None \
            else self.params
        if self._anneal_mask is None:
            return params
        key = (_params_version(params), self.global_step)
        if self._infer_cache is None or self._infer_cache[0] != key:
            with torch.no_grad():
                self._infer_cache = (
                    key, self._anneal_params(params, self.global_step))
        return self._infer_cache[1]

    # ------------------------------------------ coarse-to-fine (dynamic)
    def _build_anneal_mask(self):
        """Bool [feat_dim] over the rows of the first sigma matrix: True
        where the feature comes from a line scale or a plane with res >
        opt.dyn_anneal_res. None for a static field, with annealing off, or
        when no row is that fine."""
        if not self.time_conditioned or self.opt.dyn_anneal_steps <= 0:
            return None
        cfg = self.field.cfg
        rows = []
        for res, rank in cfg.scales:
            rows += [res > self.opt.dyn_anneal_res] * rank
        for pres, ch in cfg.planes:
            rows += [pres > self.opt.dyn_anneal_res] * (3 * ch)
        rows += [False] * freq_output_dim(3, cfg.freq_degree)
        if not any(rows):
            return None
        return torch.tensor(rows, dtype=torch.bool, device=self.device)

    def _anneal_ramp(self, step: int) -> float:
        """clip(step / dyn_anneal_steps, 0, 1), divided in f32 as the
        reference does."""
        return float(np.clip(np.float32(step)
                             / np.float32(self.opt.dyn_anneal_steps), 0, 1))

    def _anneal_params(self, params, step: int):
        """`params` with the fine rows of the first sigma matrix scaled by
        the ramp at `step` (a host integer). A parameter transform: scaling
        a feature equals scaling its row of the matrix, so the kernels see
        an ordinary matrix, and autograd through the multiply scales the
        row's gradient by the same ramp. At ramp 1 `params` itself comes
        back."""
        ramp = self._anneal_ramp(step) if self._anneal_mask is not None \
            else 1.0
        if ramp >= 1.0:
            return params
        colw = torch.where(self._anneal_mask, ramp, 1.0)[:, None]
        w = params["sigma_mlp"]["w"]
        out = dict(params)
        out["sigma_mlp"] = {**params["sigma_mlp"],
                            "w": [w[0] * colw] + list(w[1:])}
        return out

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -------------------------------------------------------- optimizer
    def _set_params(self, params):
        """Install f32 leaf params that take gradients, and a fresh Adam
        (betas 0.9/0.99, eps 1e-15) with the schedule
        lr * 0.1 ** min(step / iters, 1), stepped after each update."""
        self.params = map_params(
            lambda t: t.detach().float().requires_grad_(True), params)
        self.field.params = self.params
        iters = self.opt.iters
        groups = param_leaves(self.params)
        if self.opt.lr_net is not None:
            # the MLP towers at lr_net, the tables at lr (the reference's
            # optax.multi_transform over the same two labels)
            labels = self._leaf_labels()
            groups = [
                {"params": [p for p, lab in zip(groups, labels)
                            if lab == name], "lr": lr}
                for name, lr in (("enc", self.opt.lr),
                                 ("net", self.opt.lr_net))]
        self.optimizer = torch.optim.Adam(groups, lr=self.opt.lr,
                                          betas=(0.9, 0.99), eps=1e-15)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda k: 0.1 ** min(k / iters, 1.0))

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

    def apply_gradients(self):
        """Adam step on the leaves' .grad, then the schedule and the EMA."""
        self.optimizer.step()
        self.scheduler.step()
        self._ema_update()

    def _density_fn(self, params):
        """The grid's density query on `params`: (pts [N, 3]) -> sigma [N],
        with a second argument t for a time-conditioned field."""
        tables = self.field.kernel_tables(params)
        cfg = self.field.cfg

        if self.time_conditioned:
            return lambda pts, t: dyn_field_forward(
                tables, cfg, pts.t().contiguous(), None, t,
                density_only=True)[0]
        return lambda pts: field_forward(tables, cfg, pts.t().contiguous(),
                                         None, density_only=True)[0]

    def _render_forward(self):
        """The tiled renderer's forward_fn: (tables, x3, d3[, t]) -> out."""
        cfg = self.field.cfg
        if self.time_conditioned:
            return lambda tabs, x3, d3, t: dyn_field_forward(tabs, cfg, x3,
                                                             d3, t)
        return lambda tabs, x3, d3: field_forward(tabs, cfg, x3, d3)

    # ------------------------------------------------------------- grid
    def _forget_dyn_host_state(self):
        """Drop what the trainer keeps beside the dynamic grid's state: the
        host copies of iter_density and bin_cursor (read back from the state
        at the next refresh) and the per-bin sums of the density grid. To be
        called whenever the grid state is replaced or rewritten."""
        self._dyn_calls = self._dyn_cursor = self._dyn_bin_sums = None

    def _dyn_host_counts(self):
        """(refresh calls so far, next bin): host copies of the grid state's
        iter_density and bin_cursor, read from the device once and then kept
        in step, so that a training step does not wait for the device."""
        if self._dyn_calls is None:
            self._dyn_calls = int(self.grid_state["iter_density"])
            self._dyn_cursor = int(self.grid_state["bin_cursor"])
        return self._dyn_calls, self._dyn_cursor

    def _segment_update_interval(self) -> int:
        """Steps between refresh opportunities. A dynamic refresh call covers
        bins_per_call of time_size bins, so the interval shrinks in that
        proportion (16 * 8 / 64 = 2 by default)."""
        upd = self.opt.update_extra_interval
        if self.time_conditioned:
            d = self.dyn_grid_cfg
            upd = max(1, int(round(upd * d.bins_per_call / d.time_size)))
        return upd

    def _warmup_calls(self) -> int:
        """Refresh calls that sweep the deterministic half-grid slabs: 16
        passes over all bins for the dynamic grid (two visits of a bin sweep
        it once, so 8 full sweeps); 32 calls for the static one."""
        if self.time_conditioned:
            d = self.dyn_grid_cfg
            return 16 * -(-d.time_size // d.bins_per_call)
        return 32

    def _dyn_freeze_calls(self, upd: int) -> int:
        """The refresh-call count at which the dynamic grid freezes, set so
        that it falls on step 16 * freeze_after (1600), plus the length of
        the time curriculum: the late frames only enter training then, and
        an earlier freeze would lock their bins half trained. After the
        warm-up a call fires every 2 * upd steps. Defaults: 128 warm-up calls
        over 256 steps, then (1600 + 512 - 256) / 4 = 464 -> 592."""
        wc = self._warmup_calls()
        horizon = 16 * self.dyn_grid_cfg.freeze_after \
            + max(self.opt.time_curriculum_steps, 0)
        return wc + max(0, horizon - wc * upd) // (2 * upd)

    def dyn_refresh_due(self, step: int, calls: int) -> bool:
        """Whether the dynamic grid is refreshed before training step `step`
        after `calls` refresh calls (the reference's in-loop predicate)."""
        upd = self._segment_update_interval()
        if step % upd != 0 or calls >= self._dyn_freeze_calls(upd):
            return False
        return calls < self._warmup_calls() or step % (2 * upd) == 0

    @torch.no_grad()
    def refresh_grid(self, params=None):
        """One in-loop grid refresh of training, queried on the current
        params (not the EMA), then the march-resolution occupancy. Static:
        the warm-up slab or the random cells (render.grid.refresh_indices).
        Dynamic: the next bins_per_call time bins
        (render.dynamic_grid.refresh_dyn_density_grid) on `params` (None: the
        current params annealed at the current step)."""
        if self.time_conditioned:
            if params is None:
                params = self._anneal_params(self.params, self.global_step)
            calls, cursor = self._dyn_host_counts()
            dcfg = self.dyn_grid_cfg
            self.grid_state, self._dyn_bin_sums = refresh_dyn_density_grid(
                self.grid_state, self._density_fn(params), dcfg,
                self._warmup_calls(), generator=self.generator,
                bin_sums=self._dyn_bin_sums, calls=calls, cursor=cursor)
            self._dyn_calls = calls + 1
            self._dyn_cursor = (cursor + min(dcfg.bins_per_call,
                                             dcfg.time_size)) % dcfg.time_size
            self._occ_m = downsample_occ(self.grid_state["occ"][:, 0],
                                         self.march_cfg.march_res)
            return
        idx = refresh_indices(int(self.grid_state["iter_density"]),
                              self.grid_cfg, self.generator, self.device)
        self.grid_state = update_density_grid(
            self.grid_state, self._density_fn(self.params), self.grid_cfg,
            indices=idx, generator=self.generator)
        self._occ_m = downsample_occ(self.grid_state["occ"][0],
                                     self.march_cfg.march_res)

    @torch.no_grad()
    def rebuild_grid(self):
        """Full-sweep occupancy rebuild from the inference params; of a
        time-conditioned grid, of every time bin."""
        if self.time_conditioned:
            # iter_density counts training's refresh calls (see
            # render/dynamic_grid.py): a rebuild does not move it
            calls = self.grid_state["iter_density"].clone()
            self.grid_state = rebuild_dyn_density_grid(
                self.grid_state, self._density_fn(self._infer_params()),
                self.dyn_grid_cfg, generator=self.generator)
            self.grid_state["iter_density"] = calls
            self._forget_dyn_host_state()
            return
        self.grid_state = update_density_grid(
            self.grid_state, self._density_fn(self._infer_params()),
            self.grid_cfg, full=True, generator=self.generator)

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

    # --------------------------------------------------------- training
    def _train_forward(self, params, x, d, *t, plain=False):
        """render_dense's forward_fn: K1 forward and K2 backward, or with a
        time t K3 and K4 (or their plain versions)."""
        x3, d3 = x.t().contiguous(), d.t().contiguous()
        tables = self.field.kernel_tables(params)
        if t:
            out = dyn_field_train_forward(params, self.field.cfg, x3, d3,
                                          t[0], tables=tables, plain=plain)
        else:
            out = field_train_forward(params, self.field.cfg, x3, d3,
                                      tables=tables, plain=plain)
        return out[0], out[1:4].t()

    def n_allowed_images(self, step: int, n_images: int) -> int:
        """How many of the time-sorted frames step `step` may draw from:
        clip(ceil(step / time_curriculum_steps * n) + 1, 1, n) while the
        curriculum runs, else all of them."""
        cur = self.opt.time_curriculum_steps
        if not (self.time_conditioned and cur > 0 and self._time_sorted):
            return n_images
        frac = np.clip(np.float32(step) / np.float32(cur), 0.0, 1.0)
        return int(np.clip(int(np.ceil(frac * np.float32(n_images))) + 1, 1,
                           n_images))

    def sample_batch(self, data, h: int, w: int):
        """One step's draws: an image, num_rays pixels of it, a background
        per ray (RGBA images) and per-ray march noise.
        Returns (rays_o, rays_d, gt, bg, noise), and for a time-conditioned
        field also the image's time t (a 0-d tensor on the device) and the
        points x_reg [1024, 3] of the deform regulariser."""
        g, dev, n = self.generator, self.device, self.opt.num_rays
        images = data["images"]
        c = images.shape[-1]
        img = torch.randint(
            0, self.n_allowed_images(self.global_step, images.shape[0]), (1,),
            generator=g, device=dev)
        rays = get_rays(data["poses"][img], data["intrinsics"], h, w, n,
                        generator=g)
        pix = images.reshape(-1, c)[img * (h * w) + rays["inds"][0]]
        if c == 4:
            bg = torch.rand((pix.shape[0], 3), generator=g, device=dev)
            gt = pix[:, :3] * pix[:, 3:] + bg * (1.0 - pix[:, 3:])
        else:
            bg = torch.ones(3, device=dev)
            gt = pix
        noise = torch.rand((pix.shape[0],), generator=g, device=dev)
        batch = (rays["rays_o"][0], rays["rays_d"][0], gt, bg, noise)
        if not self.time_conditioned:
            return batch
        b = self.opt.bound
        x_reg = (torch.rand((N_ZERO_REG, 3), generator=g, device=dev)
                 * 2.0 - 1.0) * b
        return batch + (data["times"][img].reshape(()), x_reg)

    def loss_on(self, rays_o, rays_d, gt, bg, noise=None, t=None, x_reg=None,
                plain: bool = False, params=None):
        """MSE of render_dense through the field's kernels (plain=True: their
        plain versions) on the current occupancy -> (loss, n_samples),
        differentiable in the params. A time-conditioned field renders at
        time t on the occupancy of t's bin, through `params` (None: the
        current params annealed at the current step), and with x_reg adds
        deform_zero_reg * mean(deform_raw(x_reg, 0)^2)."""
        fwd = self._train_forward if not plain else \
            lambda p, x, d, *tt: self._train_forward(p, x, d, *tt, plain=True)
        occ_m, extra = self._occ_m, ()
        if params is None:
            params = self._anneal_params(self.params, self.global_step)
        if self.time_conditioned:
            t = torch.as_tensor(t, dtype=torch.float32,
                                device=self.device).reshape(())
            # the bin's slice, picked on the device
            occ_m = occ_m.index_select(
                0, time_slice_index(t, self.dyn_grid_cfg).reshape(1))[0]
            extra = (t,)
        res = render_dense(params, occ_m, rays_o, rays_d,
                           self.march_cfg, fwd, bg_color=bg,
                           noise=noise, density_scale=self.opt.density_scale,
                           t_thresh=self.opt.t_thresh, extra=extra)
        loss = torch.mean((res["image"] - gt) ** 2)
        if self.time_conditioned and x_reg is not None and \
                self.opt.deform_zero_reg > 0:
            h0 = self.field.deform_raw(params, x_reg, 0.0)
            loss = loss + self.opt.deform_zero_reg * torch.mean(h0 ** 2)
        return loss, res["n_samples"]

    def train_step(self, data, h: int, w: int):
        """One training step -> (loss, n_samples) as device tensors."""
        params = None
        if self.time_conditioned:
            params = self._anneal_params(self.params, self.global_step)
            if self.dyn_refresh_due(self.global_step,
                                    self._dyn_host_counts()[0]):
                self.refresh_grid(params)
        elif self.global_step % self.opt.update_extra_interval == 0:
            self.refresh_grid()
        loss, n_samples = self.loss_on(*self.sample_batch(data, h, w),
                                       params=params)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.apply_gradients()
        self.global_step += 1
        return loss.detach(), n_samples

    @staticmethod
    def resolve_time_curriculum(steps: int, times) -> int:
        """The curriculum length that -1 ("auto") stands for: 512 on
        monocular data (one camera per timestamp, the shape of the D-NeRF
        datasets, where training without the growing window peaks early and
        decays), 0 (off) where several cameras share a timestamp or there
        are no times. Any other value is returned as it is."""
        if steps >= 0:
            return steps
        if times is None:
            return 0
        t = np.round(np.asarray(times, np.float64).reshape(-1), 6)
        _, counts = np.unique(t, return_counts=True)
        return 512 if int(counts.max()) == 1 else 0

    def enable_time_curriculum(self, train_dataset):
        """Sort the frames by time and switch the growing time window on.
        Returns the sorted dataset: train on that one. train() does this
        when opt.time_curriculum_steps > 0; a caller that drives train_step
        itself calls this first."""
        import dataclasses
        order = np.argsort(train_dataset.times, kind="stable")
        self._time_sorted = True
        return dataclasses.replace(
            train_dataset, poses=train_dataset.poses[order],
            images=train_dataset.images[order],
            times=train_dataset.times[order])

    def train(self, train_dataset, valid_dataset=None, max_epochs: int = 1):
        """Epochs of max(n_images, segment_steps) steps until opt.iters;
        evaluation and the best checkpoint every eval_interval epochs, a
        full checkpoint at most once a minute and one at the end, as the
        reference trainer does (a dynamic grid alone is 640 MB to fetch and
        write). A time-conditioned field first resolves and switches on the
        time curriculum."""
        if self.time_conditioned:
            if self.opt.time_curriculum_steps != 0:
                self.opt.time_curriculum_steps = self.resolve_time_curriculum(
                    self.opt.time_curriculum_steps, train_dataset.times)
            if self.opt.time_curriculum_steps > 0 and \
                    train_dataset.times is not None:
                train_dataset = self.enable_time_curriculum(train_dataset)
        self.mark_untrained_grid(train_dataset.poses,
                                 train_dataset.intrinsics)
        data = train_dataset.device(self.device)
        h, w = train_dataset.h, train_dataset.w
        steps_per_epoch = max(len(train_dataset), self.opt.segment_steps)
        occ = self.grid_state["occ"]
        self._occ_m = downsample_occ(
            occ[:, 0] if self.time_conditioned else occ[0],
            self.march_cfg.march_res)
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
                [o[1] for o in out]).tolist()
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
            if time.perf_counter() - last_ckpt > 60.0:
                self.save_checkpoint(full=True)
                last_ckpt = time.perf_counter()
        self.save_checkpoint(full=True)

    # -------------------------------------------------------- rendering
    def _pick_tile(self, rh: int, rw: int) -> int:
        """March-tile size: render_tile_px (8), 10 at >= 800 px when the
        size divides, 1 (per-ray) when the size does not divide."""
        tp = self.opt.render_tile_px
        if (tp == 8 and min(rh, rw) >= 800 and rh % 10 == 0
                and rw % 10 == 0):
            return 10
        if rh % tp or rw % tp:
            return 1
        return tp

    @torch.no_grad()
    def render_image(self, pose, intrinsics, h, w, bg_color=None,
                     downscale: int = 1, params=None, time=None):
        """Whole-frame render -> (rgb f32 [rh, rw, 3], depth f32 [rh, rw])
        as numpy arrays. A time-conditioned field renders at `time` (None:
        0), marching the occupancy of that time's bin."""
        rh, rw = int(h // downscale), int(w // downscale)
        dev = self.device
        params = params if params is not None else self._infer_params()
        occ, extra = self.grid_state["occ"], ()
        if self.time_conditioned:
            t = 0.0 if time is None else float(time)
            occ = occ[time_slice_index(t, self.dyn_grid_cfg)]
            extra = (t,)
        occ_m = downsample_occ(occ[0], self.render_cfg.march_res)
        pose_t = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
        intr = torch.as_tensor(np.asarray(intrinsics, np.float32),
                               device=dev) / downscale
        bg = torch.ones(3, device=dev) if bg_color is None else \
            torch.as_tensor(np.asarray(bg_color, np.float32), device=dev)
        img, depth = render_image_tiled(
            self.field.kernel_tables(params), occ_m, pose_t, intr, rh, rw,
            self.render_cfg, self._render_forward(), bg,
            tile_px=self._pick_tile(rh, rw), dilate=self.opt.render_dilate,
            density_scale=self.opt.density_scale, t_thresh=self.opt.t_thresh,
            extra=extra)
        return img.cpu().numpy(), depth.cpu().numpy()

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
            write_png(os.path.join(val_dir, f"{name}_{i:04d}_rgb.png"),
                      (np.clip(img, 0, 1) * 255).astype(np.uint8))
            dmax = float(depth.max())
            write_png(os.path.join(val_dir, f"{name}_{i:04d}_depth.png"),
                      (np.clip(depth / dmax if dmax > 0 else depth, 0, 1)
                       * 255).astype(np.uint8))
        result = self.metrics[0].measure()
        self.stats["results"].append(result)
        self.stats["valid_loss"].append(float(np.mean(losses)))
        self.log("++> " + " | ".join(m.report() for m in self.metrics))
        return result

    def evaluate(self, dataset, name=None):
        return self.evaluate_one_epoch(dataset, name)

    def test(self, dataset, save_path=None, name=None):
        """Render every pose of the dataset and save the frames as PNG."""
        save_path = save_path or os.path.join(self.workspace, "results")
        name = name or f"{self.name}_ep{self.epoch:04d}"
        os.makedirs(save_path, exist_ok=True)
        for i in range(len(dataset)):
            img, _ = self.render_image(dataset.poses[i], dataset.intrinsics,
                                       dataset.h, dataset.w,
                                       time=self._time_of(dataset, i))
            write_png(os.path.join(save_path, f"{name}_{i:04d}_rgb.png"),
                      (np.clip(img, 0, 1) * 255).astype(np.uint8))
        self.log(f"==> Saved test results to {save_path}")

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
            save_checkpoint(path, state, meta)
            return path
        if path is None:
            path = os.path.join(ckpt_dir,
                                f"{self.name}_ep{self.epoch:04d}.npz")
            save_checkpoint(path, state, meta)
            prune_checkpoints(self.workspace, self.name,
                              self.opt.max_keep_ckpt)
            return path
        save_checkpoint(path, state, meta)
        return path

    def load_checkpoint(self, path: str, model_only: bool = False):
        state, meta = load_checkpoint(path)
        dev = self.device
        cfg = config_from_params(state["model"]["params"], self.field.cfg)
        if isinstance(cfg, CPDNeRFConfig) != self.time_conditioned:
            raise ValueError(
                f"{path} holds a "
                f"{'time-conditioned' if isinstance(cfg, CPDNeRFConfig) else 'static'}"
                " field, which this trainer does not serve")
        self.field.cfg = cfg
        self._anneal_mask = self._build_anneal_mask()
        self._set_params(params_from_jax(state["model"]["params"], dev))
        if not model_only:
            # before the grid: a rebuild queries the params annealed at the
            # checkpoint's step
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
        self.log(f"[INFO] loaded checkpoint {path} "
                 f"(epoch {self.epoch}, step {self.global_step})")
