"""FastTrainer for the static CP field (port of sealdnerf_tpu/train/fast.py).

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

Not ported yet: error-map and patch sampling, host-resident images
(preload=False), train_gui, the bucketed renderer (the reference switches
to it below 15 % occupancy; this port always renders tiled, the exact one
of the two), dynamic scenes and the cascade march for bound > 1.
"""

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.rays import get_rays
from ..models.cp import (CPConfig, config_from_params, map_params,
                         param_leaves, params_from_jax, unflatten_like)
from ..ops.field import field_forward, field_train_forward
from ..ops.marching_dense import DenseMarchConfig, downsample_occ
from ..render.fast import render_dense
from ..render.fast_image import render_image_tiled
from ..render.grid import (GridConfig, init_grid_state, mark_untrained_grid,
                           refresh_indices, update_density_grid)
from ..utils.png import write_png
from .checkpoint import (load_checkpoint, prune_checkpoints,
                         resolve_checkpoint, save_checkpoint)
from .metrics import PSNRMeter
from .trainer import TrainOptions, cascades_for


class FastTrainer:
    def __init__(self, name: str, opt: TrainOptions, field,
                 metrics: Optional[Sequence] = None,
                 workspace: Optional[str] = None,
                 use_checkpoint: str = "latest", device=None):
        if not isinstance(field.cfg, CPConfig):
            raise NotImplementedError("only the static CP field is ported")
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
        self.grid_state = init_grid_state(self.grid_cfg, self.device)
        self.generator = torch.Generator(self.device).manual_seed(opt.seed)
        self._occ_m = None
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

    def _infer_params(self):
        return self.ema_params if self.ema_params is not None else self.params

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
        self.optimizer = torch.optim.Adam(param_leaves(self.params),
                                          lr=self.opt.lr, betas=(0.9, 0.99),
                                          eps=1e-15)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda k: 0.1 ** min(k / iters, 1.0))

    def _optimizer_count(self) -> int:
        st = self.optimizer.state.get(param_leaves(self.params)[0])
        return int(st["step"]) if st else 0

    def current_lr(self) -> float:
        """The lr that the schedule gives at the optimizer's own update
        count (reference Trainer.current_lr)."""
        return float(self.opt.lr * 0.1 ** min(
            self._optimizer_count() / self.opt.iters, 1.0))

    def _optimizer_state(self):
        """Adam's state in the reference's optax layout:
        ((count, mu, nu), (schedule count,)), mu and nu shaped like the
        params, so that a full checkpoint resumes in either package."""
        leaves = param_leaves(self.params)
        st = [self.optimizer.state.get(p, {}) for p in leaves]
        mu = [s["exp_avg"] if s else torch.zeros_like(p)
              for s, p in zip(st, leaves)]
        nu = [s["exp_avg_sq"] if s else torch.zeros_like(p)
              for s, p in zip(st, leaves)]
        return ((np.int32(self._optimizer_count()),
                 unflatten_like(self.params, mu),
                 unflatten_like(self.params, nu)),
                (np.int32(self.scheduler.last_epoch),))

    def _load_optimizer_state(self, opt_state):
        (count, mu, nu), (sched,) = opt_state
        leaves = param_leaves(self.params)
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
        tables = self.field.kernel_tables(params)
        cfg = self.field.cfg

        def density(pts):                  # [N, 3] -> sigma [N]
            return field_forward(tables, cfg, pts.t().contiguous(), None,
                                 density_only=True)[0]
        return density

    # ------------------------------------------------------------- grid
    @torch.no_grad()
    def refresh_grid(self):
        """One in-loop grid refresh of training: the warm-up slab or the
        random cells (render.grid.refresh_indices), queried on the current
        params (not the EMA), then the march-resolution occupancy."""
        idx = refresh_indices(int(self.grid_state["iter_density"]),
                              self.grid_cfg, self.generator, self.device)
        self.grid_state = update_density_grid(
            self.grid_state, self._density_fn(self.params), self.grid_cfg,
            indices=idx, generator=self.generator)
        self._occ_m = downsample_occ(self.grid_state["occ"][0],
                                     self.march_cfg.march_res)

    @torch.no_grad()
    def rebuild_grid(self):
        """Full-sweep occupancy rebuild from the inference params."""
        self.grid_state = update_density_grid(
            self.grid_state, self._density_fn(self._infer_params()),
            self.grid_cfg, full=True, generator=self.generator)

    @torch.no_grad()
    def mark_untrained_grid(self, poses, intrinsics):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                      device=self.device)
        self.grid_state = mark_untrained_grid(
            self.grid_state, t(poses), t(intrinsics), self.grid_cfg)

    # --------------------------------------------------------- training
    def _train_forward(self, params, x, d, plain=False):
        """render_dense's forward_fn: K1 forward, K2 backward (or their
        plain versions)."""
        out = field_train_forward(params, self.field.cfg,
                                  x.t().contiguous(), d.t().contiguous(),
                                  tables=self.field.kernel_tables(params),
                                  plain=plain)
        return out[0], out[1:4].t()

    def sample_batch(self, data, h: int, w: int):
        """One step's draws: an image, num_rays pixels of it, a background
        per ray (RGBA images) and per-ray march noise.
        Returns (rays_o, rays_d, gt, bg, noise)."""
        g, dev, n = self.generator, self.device, self.opt.num_rays
        images = data["images"]
        c = images.shape[-1]
        img = torch.randint(0, images.shape[0], (1,), generator=g, device=dev)
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
        return rays["rays_o"][0], rays["rays_d"][0], gt, bg, noise

    def loss_on(self, rays_o, rays_d, gt, bg, noise=None,
                plain: bool = False):
        """MSE of render_dense through the field's kernels (plain=True: their
        plain versions) on the current occupancy -> (loss, n_samples),
        differentiable in the params."""
        fwd = self._train_forward if not plain else \
            lambda p, x, d: self._train_forward(p, x, d, plain=True)
        res = render_dense(self.params, self._occ_m, rays_o, rays_d,
                           self.march_cfg, fwd, bg_color=bg,
                           noise=noise, density_scale=self.opt.density_scale,
                           t_thresh=self.opt.t_thresh)
        return torch.mean((res["image"] - gt) ** 2), res["n_samples"]

    def train_step(self, data, h: int, w: int):
        """One training step -> (loss, n_samples) as device tensors."""
        if self.global_step % self.opt.update_extra_interval == 0:
            self.refresh_grid()
        loss, n_samples = self.loss_on(*self.sample_batch(data, h, w))
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.apply_gradients()
        self.global_step += 1
        return loss.detach(), n_samples

    def train(self, train_dataset, valid_dataset=None, max_epochs: int = 1):
        """Epochs of max(n_images, segment_steps) steps until opt.iters;
        evaluation and the best checkpoint every eval_interval epochs, a
        full checkpoint after every epoch."""
        self.mark_untrained_grid(train_dataset.poses,
                                 train_dataset.intrinsics)
        data = train_dataset.device(self.device)
        h, w = train_dataset.h, train_dataset.w
        steps_per_epoch = max(len(train_dataset), self.opt.segment_steps)
        self._occ_m = downsample_occ(self.grid_state["occ"][0],
                                     self.march_cfg.march_res)
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
                     downscale: int = 1, params=None):
        """Whole-frame render -> (rgb f32 [rh, rw, 3], depth f32 [rh, rw])
        as numpy arrays."""
        rh, rw = int(h // downscale), int(w // downscale)
        dev = self.device
        params = params if params is not None else self._infer_params()
        cfg = self.field.cfg
        occ_m = downsample_occ(self.grid_state["occ"][0],
                               self.render_cfg.march_res)
        pose_t = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
        intr = torch.as_tensor(np.asarray(intrinsics, np.float32),
                               device=dev) / downscale
        bg = torch.ones(3, device=dev) if bg_color is None else \
            torch.as_tensor(np.asarray(bg_color, np.float32), device=dev)
        img, depth = render_image_tiled(
            self.field.kernel_tables(params), occ_m, pose_t, intr, rh, rw,
            self.render_cfg,
            lambda tabs, x3, d3: field_forward(tabs, cfg, x3, d3), bg,
            tile_px=self._pick_tile(rh, rw), dilate=self.opt.render_dilate,
            density_scale=self.opt.density_scale, t_thresh=self.opt.t_thresh)
        return img.cpu().numpy(), depth.cpu().numpy()

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
                                           dataset.w)
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
                                       dataset.h, dataset.w)
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
        self.field.cfg = config_from_params(state["model"]["params"],
                                            self.field.cfg)
        self._set_params(params_from_jax(state["model"]["params"], dev))
        if state["model"].get("ema") is not None:
            self.ema_params = params_from_jax(state["model"]["ema"], dev)
        else:
            self.ema_params = None
        if "grid" in state:
            g = init_grid_state(self.grid_cfg, dev)
            g.update({k: torch.as_tensor(np.asarray(v), device=dev)
                      for k, v in state["grid"].items()})
            if "density_grid" in state["grid"]:
                thresh = torch.clamp(g["mean_density"],
                                     max=self.grid_cfg.density_thresh)
                g["occ"] = (g["density_grid"] > thresh).reshape(
                    g["occ"].shape)
            self.grid_state = g
            if "density_grid" not in state["grid"]:
                # slim checkpoints strip the grid: rebuild it from the
                # loaded params with a full density sweep
                self.rebuild_grid()
        if not model_only:
            self.epoch = meta.get("epoch", 0)
            self.global_step = meta.get("global_step", 0)
            if "stats" in meta:
                self.stats.update(meta["stats"])
                self.stats.setdefault("best_result", None)
            if "optimizer" in state:
                self._load_optimizer_state(state["optimizer"])
        self.log(f"[INFO] loaded checkpoint {path} "
                 f"(epoch {self.epoch}, step {self.global_step})")
