"""The frames loop: closed-loop frames of a trained field, each through the
traffic's `entry` (`test_gui` or `render_image`), timed from the request to
the image on the host, the camera orbiting and the time stepping as the
traffic sets.

Traffic parameters: `rays_per_step`, `train_steps` (the field's training in
set-up), `check_steps` (its first steps, which the check follows from the
seed), `rebuild` (a full rebuild of the grid after training, which the
check compares; else the last refresh of the last `grid_capture_steps`
steps), `warmup_frames`, `width`, `height`, `downscale` (test_gui's, 1 when
absent), `camera` (`radius`, `polar_deg`, `fovy`, `deg_per_frame`),
`time_steps` (null: a static field), `check_frames` of the window's first
`check_span` frames compared with the reference's, drawn from the seed,
`frame_reference` (a module of reference/ whose `render_frame` takes the
field module's `reference_frame` arguments; absent: the field module's
own), `trace_units` and `trace_at`.
"""

import math
import time

import numpy as np
import torch

from nerfbench import capture, harness, scene
from nerfbench.reference import field as rf


class Loop(harness.Loop):

    def camera(self, k: int):
        """The traffic's k-th camera -> (pose [4, 4], intrinsics [4], h, w,
        time or None): on the orbit of the traffic's radius and polar
        angle, turned by deg_per_frame a frame, and with time_steps at time
        (k mod time_steps) / time_steps."""
        tr = self.tr
        cam = tr["camera"]
        phi = math.radians(cam["deg_per_frame"]) * (self.k0 + k)
        pose = scene.orbit_pose(math.radians(cam["polar_deg"]), phi,
                                cam["radius"])
        h, w = tr["height"], tr["width"]
        focal = h / (2 * math.tan(math.radians(cam["fovy"]) / 2))
        intr = np.array([focal, focal, w // 2, h // 2], np.float32)
        t = None
        if tr.get("time_steps"):
            t = ((self.k0 + k) % tr["time_steps"]) / tr["time_steps"]
        return pose, intr, h, w, t

    def frame(self, k: int):
        """The k-th frame through the traffic's entry -> (rgb [h, w, 3]
        numpy, its camera)."""
        cam = self.camera(k)
        pose, intr, h, w, t = cam
        if self.tr["entry"] == "test_gui":
            img = self.trainer.test_gui(
                pose, intr, w, h, time=t, need_depth=True,
                downscale=self.tr.get("downscale", 1))["image"]
        else:
            img = self.trainer.render_image(pose, intr, h, w, time=t)[0]
        return img, cam

    def grid_rows(self):
        """The time bins of the frames that the check compares."""
        if not self.tr.get("time_steps"):
            return None
        bins = self.trainer.dyn_grid_cfg.time_size
        return {self.fm.time_bin(self.camera(k)[4], bins)
                for k in self.sample}

    def set_up(self, mark):
        tr = self.tr
        seed = self.run.seed
        self.k0 = int(np.random.default_rng(seed + 1).integers(
            0, max(tr.get("time_steps") or 1, 1)))
        rng = np.random.default_rng(seed + 2)
        self.sample = set(rng.choice(tr["check_span"], tr["check_frames"],
                                     replace=False).tolist())
        self.train_to(mark, rebuild=bool(tr.get("rebuild")))
        for k in range(-tr["warmup_frames"], 0):
            self.frame(k)
        mark("warm frames")

    def window(self, seconds: float, trace: bool):
        tr, run = self.tr, self.run
        n_slice, at = tr["trace_units"], tr["trace_at"] * seconds
        traced = not trace
        stamps, lat, self.kept = [], [], []
        k = 0

        def frames(n):
            nonlocal k
            for _ in range(n):
                t1 = time.perf_counter()
                with torch.profiler.record_function("nb.frame"):
                    img, cam = self.frame(k)
                stamps.append(time.perf_counter())
                lat.append(stamps[-1] - t1)
                if k in self.sample:
                    self.kept.append((img,) + cam)
                k += 1
        harness.sync(self.device)
        t0 = time.perf_counter()
        while True:
            if not traced and time.perf_counter() - t0 >= at:
                run.traced(self.trainer, frames, n_slice)
                traced = True
            else:
                frames(1)
            if time.perf_counter() - t0 >= seconds and traced:
                break
        harness.sync(self.device)
        window_s = time.perf_counter() - t0
        self.units = len(lat)
        self.e2e = {"frames_per_s": self.units / window_s,
                    "frame_ms_p95": harness.quantile95(lat) * 1e3}
        harness.print_pace("frames", stamps, t0)
        self.failed = int(sum(not np.isfinite(img).all()
                              for img, *_ in self.kept))

    def release(self):
        from sealdnerf_tpu_torch.models.params import map_params
        t = self.trainer
        self.state = (map_params(lambda x: x.detach().clone(),
                                 t.ema_params),
                      t.grid_state["occ"].clone(), t.global_step)
        super().release()

    def render(self):
        name = self.tr.get("frame_reference")
        if not name:
            return self.fm.reference_frame
        return self.cell.module("reference", name).render_frame

    def frames_by(self, q):
        return self.fm.reference_frames(self.cell, self.kept, self.state,
                                        self.opt, q, self.render())

    def reference(self):
        super().reference()
        self.ref_frames = self.frames_by(rf.exact)
        self.ref_frames_bf16 = self.frames_by(rf.bf16)

    def check(self, first=None, grid=None, frames=None) -> dict:
        out = super().check(first, grid)
        out.update(capture.compare_frames(frames or self.kept,
                                          self.ref_frames,
                                          self.ref_frames_bf16))
        return out

    def readings(self) -> dict:
        out = super().readings()
        out["control"].update(capture.compare_frames(
            self.frames_by(rf.fp8), self.ref_frames, self.ref_frames_bf16))
        out["fault_altered"] = self.check(
            frames=capture.altered_frames(self.kept))
        return out
