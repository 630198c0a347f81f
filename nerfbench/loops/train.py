"""The training loop: FastTrainer.train_step back to back, as the trainer's
epoch loop issues it, from the step `train_steps` on; the window ends in
torch.cuda.synchronize().

Traffic parameters: `rays_per_step`; `train_steps` of set-up, which the
mix sets past every schedule of the program that changes a step's work
(the time curriculum, the coarse-to-fine ramp, the dynamic grid's
refreshes until it freezes), so that the window's steps all do the same
work whatever their pace; `check_steps` (the first steps, which the check
follows from the seed); `grid_capture_steps` (the last set-up steps, whose
last grid refresh the check compares); `follow_steps` (steps after the
window, which the check follows from the program's state); `trace_units`
and `trace_at` (the traced slice: its steps, and where in the window it
starts, a share).
"""

import sys
import time

import torch

from nerfbench import capture, harness
from nerfbench.reference import field as rf


class Loop(harness.Loop):

    def set_up(self, mark):
        self.train_to(mark)

    def window(self, seconds: float, trace: bool):
        tr, t, run = self.tr, self.trainer, self.run
        n_slice, at = tr["trace_units"], tr["trace_at"] * seconds
        # the grid's count of refresh calls, read before and after
        calls0 = int(t.grid_state["iter_density"])
        traced = not trace
        stamps, losses = [], []     # the host clock at the end of each step

        def steps(n):
            for _ in range(n):
                with torch.profiler.record_function("nb.step"):
                    losses.append(t.train_step(self.data, self.h,
                                               self.w)[0])
                stamps.append(time.perf_counter())
        first = t.global_step
        harness.sync(self.device)
        t0 = time.perf_counter()
        while True:
            if not traced and time.perf_counter() - t0 >= at and \
                    t.global_step % 16 == 0:
                run.traced(t, steps, n_slice)
                traced = True
            else:
                steps(1)
            if time.perf_counter() - t0 >= seconds and traced:
                break
        harness.sync(self.device)
        window_s = time.perf_counter() - t0
        refreshes = int(t.grid_state["iter_density"]) - calls0
        self.units = len(losses)
        self.e2e = {"train_rays_per_s":
                    self.units * tr["rays_per_step"] / window_s}
        harness.print_pace("steps", stamps, t0)
        self.failed = int((~torch.isfinite(torch.stack(losses))).sum())
        self.window_info = {"window_steps": [first, t.global_step - 1],
                            "window_grid_refreshes": refreshes}
        print(f"window: steps {first}-{t.global_step - 1}, "
              f"{refreshes} grid refreshes", file=sys.stderr,
              flush=True)
        self.steps_done = tr["train_steps"] + self.units
        self.follow = self.steps(tr["follow_steps"])

    def reference(self):
        super().reference()
        self.ref_follow = self.fm.reference_steps(
            self.cell, self.follow, self.params0, self.opt, rf.exact,
            step0=self.steps_done)

    def check(self, first=None, grid=None, follow=None) -> dict:
        out = super().check(first, grid)
        win = capture.compare_training(follow or self.follow,
                                       self.ref_follow, self.follow)
        out.update({"window_" + k: v for k, v in win.items()})
        return out

    def readings(self) -> dict:
        out = super().readings()
        fm, cap = self.fm, self.follow
        ctl = fm.reference_steps(self.cell, cap, self.params0, self.opt,
                                 rf.fp8, step0=self.steps_done)
        half = fm.reference_steps(self.cell, cap, self.params0, self.opt,
                                  rf.exact, step0=self.steps_done,
                                  batches=capture.half_batches(cap))
        unchanged = capture.unchanged_steps(cap)
        for key, f in (("control", ctl), ("fault_half_batch", half),
                       ("fault_unchanged", unchanged)):
            win = capture.compare_training(f, self.ref_follow, cap)
            out[key].update({"window_" + k: v for k, v in win.items()})
        out["look"]["window_losses"] = [float(x) for x in cap.losses]
        out["look"]["window_ref_losses"] = self.ref_follow.losses
        return out
