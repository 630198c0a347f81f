"""Headless GUI controller (port of sealdnerf_tpu/gui/controller.py): the
train/render pacing logic of the reference viewers (nerf/gui.py:89-153),
separated from dearpygui, on the port's trainers.

- training interleave: 4..16 train steps per UI frame, auto-tuned to a 500 ms
  budget (nerf/gui.py:107-111), through Trainer.train_gui on the training
  set as the trainer's device holds it.
- rendering: dynamic downscale 1/8..1 targeting a 200 ms frame (:136-140,
  bucketed to powers of two) and SPP accumulation at a fixed view, through
  Trainer.test_gui, one synchronous frame at a time (the reference's
  pipelined preview is tunnel machinery and is not ported).

A view changes the controller only through its methods and attribute sets,
so that on a data mesh rank 0's view can drive every rank's controller
(gui/follow.py). The pacing reads rank 0's clock (from_rank0), so that
every rank takes the same number of steps and the same downscale.
"""

import time
from typing import Optional

import numpy as np

from ..parallel.mesh import from_rank0
from .orbit import OrbitCamera


class GUIController:
    def __init__(self, opt, trainer, train_dataset=None,
                 teacher_trainer=None):
        self.opt = opt
        self.trainer = trainer
        self.teacher_trainer = teacher_trainer
        self.render_trainer = trainer  # switchable (SealD gui trainer combo)
        self.train_dataset = train_dataset
        self.cam = OrbitCamera(opt.W, opt.H, r=opt.radius, fovy=opt.fovy)
        self.training = False
        self.time = 0.0  # dynamic scenes
        self.bg_color = np.ones(3, dtype=np.float32)
        self.downscale = 8
        self.spp = 1
        self.max_spp = getattr(opt, "max_spp", 64)
        self.render_buffer: Optional[np.ndarray] = None
        self.depth_buffer: Optional[np.ndarray] = None
        # the frames carry depth only while a back-projecting tool is
        # active (the edit controller toggles this); preview frames are
        # the depth-free LOD preview
        self.need_depth = False
        self.need_update = True
        self.train_steps = 16
        self._data_dev = None
        if train_dataset is not None:
            self._data_dev = train_dataset.device(trainer.device)

    def _rank0(self, value: float) -> float:
        """Rank 0's value of a clock reading on the trainer's mesh (the
        value itself without one)."""
        mesh = getattr(self.trainer, "mesh", None)
        return value if mesh is None else from_rank0(mesh, value)

    # ---------------------------------------------------------------- training
    def train_frame(self):
        """Run one UI frame worth of training; auto-tunes steps to 500 ms."""
        if not self.training or self.train_dataset is None:
            return None
        ds = self.train_dataset
        out = self.trainer.train_gui(self._data_dev, ds.h, ds.w,
                                     step=self.train_steps)
        t = out["time"] = self._rank0(out["time"])
        # nerf/gui.py:107-111 pacing
        full_t = t / self.train_steps * 16
        train_steps = min(16, max(4, int(16 * 500 / (full_t * 1000 + 1e-9))))
        if train_steps > self.train_steps * 1.2 or \
                train_steps < self.train_steps * 0.8:
            self.train_steps = train_steps
        self.need_update = True
        return out

    # --------------------------------------------------------------- rendering
    def _time_kw(self, trainer):
        return {"time": self.time} if getattr(trainer, "time_conditioned",
                                              False) else {}

    def render_frame(self):
        """Render one view frame -> (float [H, W, 3], seconds); (the buffer,
        0.0) when the view is still and its SPP is complete."""
        if self.need_update or self.spp < self.max_spp:
            t0 = time.time()
            out = self.render_trainer.test_gui(
                self.cam.pose, self.cam.intrinsics, self.opt.W, self.opt.H,
                bg_color=self.bg_color, spp=self.spp,
                downscale=self.downscale, need_depth=self.need_depth,
                **self._time_kw(self.render_trainer))
            dt = self._rank0(time.time() - t0)
            # dynamic resolution targeting 200 ms (nerf/gui.py:136-140),
            # power-of-two buckets
            if self.need_update:
                if dt > 0.25 and self.downscale < 8:
                    self.downscale *= 2
                elif dt < 0.08 and self.downscale > 1:
                    self.downscale //= 2
                self.render_buffer = self._upsample(out["image"])
                if out["depth"] is not None:
                    self.depth_buffer = out["depth"]
                elif self.need_depth is False:
                    self.depth_buffer = None  # stale depth: view moved
                self.spp = 1
                self.need_update = False
            else:
                # SPP accumulation at fixed view
                img = self._upsample(out["image"])
                self.render_buffer = (
                    self.render_buffer * self.spp + img) / (self.spp + 1)
                self.spp += 1
            return self.render_buffer, dt
        return self.render_buffer, 0.0

    def _upsample(self, img):
        if img.shape[0] == self.opt.H:
            return img
        reps = self.opt.H // img.shape[0]
        return np.repeat(np.repeat(img, reps, axis=0), reps, axis=1)[
            :self.opt.H, :self.opt.W]

    def display_frame(self, img: np.ndarray) -> np.ndarray:
        """Hook for view-layer overlays; editors blend tool state in."""
        return img

    # ------------------------------------------------------------------ events
    def on_drag(self, dx, dy):
        self.cam.orbit(dx, dy)
        self.need_update = True

    def on_scroll(self, delta):
        self.cam.scale(delta)
        self.need_update = True

    def on_pan(self, dx, dy):
        self.cam.pan(dx, dy)
        self.need_update = True

    def set_time(self, t: float):
        self.time = float(np.clip(t, 0.0, 1.0))
        self.need_update = True

    def set_fovy(self, fovy: float):
        self.cam.fovy = fovy
        self.need_update = True

    def toggle_training(self) -> bool:
        """Start or stop the training interleave -> whether it runs."""
        self.training = not self.training
        return self.training

    def save_checkpoint(self):
        """A full checkpoint of the trainer (rank 0 writes it)."""
        return self.trainer.save_checkpoint(full=True)

    def save_mesh(self):
        """The trainer's density iso-surface as PLY (rank 0 writes it)."""
        return self.trainer.save_mesh()

    def back_project(self, px: np.ndarray):
        """Pixel coords [N, 2] (x, y) -> (world positions [N, 3], mask [N]
        of the pixels with depth > 0) via the rendered depth (reference
        get_mask_pos, SealDNeRF/gui.py:229-235 + nerf/utils.py:826-830).
        Renders a depth frame on demand if the preview frames didn't carry
        one."""
        if self.depth_buffer is None:
            out = self.render_trainer.test_gui(
                self.cam.pose, self.cam.intrinsics, self.opt.W, self.opt.H,
                bg_color=self.bg_color, downscale=self.downscale,
                need_depth=True, **self._time_kw(self.render_trainer))
            self.depth_buffer = out["depth"]
        assert self.depth_buffer is not None
        h, w = self.depth_buffer.shape
        sx = w / self.opt.W
        sy = h / self.opt.H
        ix = np.clip((px[:, 0] * sx).astype(int), 0, w - 1)
        iy = np.clip((px[:, 1] * sy).astype(int), 0, h - 1)
        depth = self.depth_buffer[iy, ix]
        fx, fy, cx, cy = self.cam.intrinsics
        dirs = np.stack([(px[:, 0] - cx) / fx, (px[:, 1] - cy) / fy,
                         np.ones(len(px))], axis=-1)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        pose = self.cam.pose
        world_d = dirs @ pose[:3, :3].T
        origin = pose[:3, 3]
        mask = depth > 0
        return origin + depth[:, None] * world_d, mask
