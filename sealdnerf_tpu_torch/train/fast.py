"""FastTrainer, inference half (port of sealdnerf_tpu/train/fast.py).

Serves a static CP field: checkpoint loading, occupancy-grid rebuild and
frustum marking, whole-frame rendering through the tiled renderer, and the
evaluate/test loops. The field is evaluated by the fused kernel
(ops/field.py) on CUDA tensors, and by its plain version on CPU tensors.

Not ported yet: training segments (they need the backward kernel), the
bucketed renderer (the reference switches to it below 15 % occupancy; this
port always renders tiled, the exact one of the two), dynamic scenes and
the cascade march for bound > 1.
"""

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.cp import (CPConfig, config_from_params, map_params,
                         params_from_jax)
from ..ops.field import field_forward
from ..ops.marching_dense import DenseMarchConfig, downsample_occ
from ..render.fast_image import render_image_tiled
from ..render.grid import (GridConfig, init_grid_state, mark_untrained_grid,
                           update_density_grid)
from ..utils.png import write_png
from .checkpoint import load_checkpoint, resolve_checkpoint, save_checkpoint
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
        self.name = name
        self.opt = opt
        self.field = field
        self.metrics = list(metrics) if metrics is not None else [PSNRMeter()]
        self.workspace = workspace or opt.workspace
        self.device = torch.device(device) if device is not None \
            else field.params["lines"][0][0].device
        ni = opt.n_intervals * cascades
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
        self.params = map_params(lambda t: t.to(self.device), field.params)
        self.field.params = self.params
        self.ema_params = map_params(torch.clone, self.params)
        self.grid_state = init_grid_state(self.grid_cfg, self.device)
        self.generator = torch.Generator(self.device).manual_seed(opt.seed)
        self.epoch = 0
        self.global_step = 0
        self.stats = {"loss": [], "valid_loss": [], "results": [],
                      "best_result": None}
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

    def _density_fn(self, params):
        tables = self.field.kernel_tables(params)
        cfg = self.field.cfg

        def density(pts):                  # [N, 3] -> sigma [N]
            return field_forward(tables, cfg, pts.t().contiguous(), None,
                                 density_only=True)[0]
        return density

    # ------------------------------------------------------------- grid
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
    def save_checkpoint(self, path: Optional[str] = None) -> str:
        """Write params, EMA params and the grid in the reference's .npz
        format (no optimizer state: training is not ported)."""
        path = path or os.path.join(self.workspace, "checkpoints",
                                    f"{self.name}_ep{self.epoch:04d}.npz")
        state = {"model": {"params": self.params, "ema": self.ema_params},
                 "grid": self.grid_state}
        meta = {"epoch": self.epoch, "global_step": self.global_step,
                "stats": {k: v for k, v in self.stats.items()
                          if k != "best_result"}}
        save_checkpoint(path, state, meta)
        return path

    def load_checkpoint(self, path: str, model_only: bool = False):
        state, meta = load_checkpoint(path)
        dev = self.device
        self.params = params_from_jax(state["model"]["params"], dev)
        self.field.cfg = config_from_params(self.params, self.field.cfg)
        self.field.params = self.params
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
        self.log(f"[INFO] loaded checkpoint {path} "
                 f"(epoch {self.epoch}, step {self.global_step})")
