"""The benchmark's driver, led by data. A cell of BENCHMARK.json names a
configuration (`configs/<config>.json`: the field's widths, the dataset's
shape, the CLI flags, its source, and the field module that builds it,
`fields/<model>.py`) and a traffic mix (`traffic/<mix>.json`: the
parameters of one loop, `loops/<loop>.py`), and has its limits in
`limits/<cell>.json`; each per-layer metric is read by
`metrics/<metric>.py`. Every one of these is found by its name, so a new
cell, configuration, mix, loop, field or metric is a new file and a new
entry.

One run: the inputs from the seed (the scene's views on the device, the
field's weights on the device in two calls), the program's trainer built as
its CLI builds it, the loop's set-up, a window of `seconds` over the loop,
then the check against the plain reference and the result.

A loop module holds `Loop(run)`, a subclass of `harness.Loop`, with
`set_up(mark)`, `window(seconds, traced)`, `release()`, `reference()`,
`check(**put)` and `readings()` (the control's and faults' numbers, for
calibrate.py).
"""

import gc
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from . import capture, tracing
from .reference import field as rf

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(path):
    with open(path) as f:
        return json.load(f)


def load_module(bench_dir: str, kind: str, name: str):
    """The module `<bench_dir>/<kind>/<name>.py`, loaded from its file (so a
    copy of the benchmark runs its own files)."""
    path = os.path.join(bench_dir, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"nerfbench_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of BENCHMARK.json with its files."""

    def __init__(self, name: str, bench_dir: str = HERE):
        bench = _load(os.path.join(os.path.dirname(bench_dir),
                                   "BENCHMARK.json"))
        entry = [w for w in bench["workloads"] if w["name"] == name]
        if not entry:
            raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
        self.name, self.entry = name, entry[0]
        self.bench_dir = bench_dir
        self.chips = int(self.entry["chips"])
        self.config = _load(os.path.join(bench_dir, "configs",
                                         self.entry["config"] + ".json"))
        self.traffic = _load(os.path.join(bench_dir, "traffic",
                                          self.entry["traffic"] + ".json"))
        self.limits = _load(os.path.join(bench_dir, "limits", name + ".json"))

        def mine(m):
            return name in m.get("workloads", [name])
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    @property
    def field(self) -> dict:
        return self.config["field"]

    def module(self, kind: str, name: str):
        return load_module(self.bench_dir, kind, name)

    def field_module(self):
        return self.module("fields", self.config["model"])

    def loop_module(self):
        return self.module("loops", self.traffic["loop"])

    def metric_reader(self, name: str):
        return self.module("metrics", name).read


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def print_pace(what: str, stamps, t0: float, every: float = 2.0):
    """The window's pace on stderr: how many steps or frames the host
    finished in each `every` seconds."""
    counts = np.bincount(((np.asarray(stamps) - t0) // every).astype(int))
    print(f"window: {what} per {every:g} s: "
          + " ".join(str(int(c)) for c in counts), file=sys.stderr,
          flush=True)


def quantile95(values):
    """The 95th percentile of all values (statistics' exclusive method)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20)[18]


class Loop:
    """What every loop shares: the program's trainer on the seeded field,
    its first steps from the seed (which the check follows), training to
    the traffic's `train_steps` with its last grid update captured, and the
    checks of both."""

    def __init__(self, run):
        self.run, self.cell, self.tr = run, run.cell, run.cell.traffic
        self.fm = run.cell.field_module()
        self.device = run.device

    def train_to(self, mark, rebuild: bool = False):
        """Build the trainer, train `train_steps` steps and, with `rebuild`,
        rebuild the grid; the first `check_steps` steps and the last grid
        update (the rebuild, else a refresh of the last
        `grid_capture_steps` steps) are captured for the check."""
        tr, run = self.tr, self.run
        self.trainer, self.params0, self.opt = self.fm.build_trainer(
            self.cell, run.seed, self.device, os.path.join(run.tmp, "ws"),
            ["--num_rays", str(tr["rays_per_step"])])
        mark("trainer")
        self.data, self.h, self.w, self.views = self.fm.training_data(
            self.cell, self.trainer)
        mark("views")
        t = self.trainer
        self.first = self.steps(tr["check_steps"])
        mark("checked steps")
        n = tr["train_steps"] - tr["check_steps"]
        last = 0 if rebuild else min(tr["grid_capture_steps"], n)
        for _ in range(n - last):
            t.train_step(self.data, self.h, self.w)
        with capture.GridCapture(t, "params", self.grid_rows()) as g:
            for _ in range(last):
                t.train_step(self.data, self.h, self.w)
        mark("training")
        if rebuild:
            with capture.GridCapture(t, "ema", self.grid_rows()) as g:
                t.rebuild_grid()
            mark("rebuild")
        if g.last is None:
            raise RuntimeError(f"{self.cell.name}: no grid update in the last "
                               f"{last} set-up steps to check")
        self.grid, self.grid_full = g.last, rebuild
        self.steps_done = tr["train_steps"]

    def grid_rows(self):
        """The grid rows whose last update the check compares (None: all)."""
        return None

    def steps(self, n: int):
        """n training steps, captured for the check."""
        t = self.trainer
        with capture.StepCapture(t) as cap:
            for k in range(n):
                loss, _ = t.train_step(self.data, self.h, self.w)
                cap.losses.append(loss)
                cap.after_step(k)
        return cap

    def release(self):
        """Free the program's state that the check does not read (the
        reference runs after it is freed)."""
        self.trainer = self.data = None
        gc.collect()
        if self.run.is_cuda:
            torch.cuda.empty_cache()

    def reference(self):
        """The reference's side of the first steps and of the grid."""
        self.ref_first = self.fm.reference_steps(
            self.cell, self.first, self.params0, self.opt, rf.exact)
        self.ref_grid = self.fm.reference_grid(
            self.cell, self.grid, self.opt, rf.exact, self.views,
            self.grid_full)

    def check(self, first=None, grid=None) -> dict:
        """The numbers of the first steps and of the grid, of the program
        (or of `first` and `grid`, an occupancy, in its place)."""
        out = capture.compare_training(first or self.first, self.ref_first,
                                       self.first)
        out.update(capture.compare_grid(self.grid, self.ref_grid, grid))
        return out

    def readings(self) -> dict:
        """The numbers of the check of the control (the reference at the
        precision below the configuration's: float8 e4m3 operands) and of
        the faults the cell can have, each against the float32 reference,
        beside the program's."""
        fm, cap = self.fm, self.first
        out = {"program": self.check()}
        ctl_grid = fm.reference_grid(self.cell, self.grid, self.opt, rf.fp8,
                                     self.views, self.grid_full)
        ref = self.ref_grid
        ctl_occ = fm.grid_occupancy(self.grid, ctl_grid["sigma"],
                                    ref["covered"], ref["bounds"], self.opt)
        ctl = fm.reference_steps(self.cell, cap, self.params0, self.opt,
                                 rf.fp8)
        out["control"] = self.check(first=ctl, grid=ctl_occ)
        half = fm.reference_steps(self.cell, cap, self.params0, self.opt,
                                  rf.exact,
                                  batches=capture.half_batches(cap))
        out["fault_half_batch"] = self.check(first=half)
        out["fault_unchanged"] = self.check(
            first=capture.unchanged_steps(cap))
        out["fault_sparser_grid"] = self.check(
            grid=capture.sparser_grid(self.grid, self.run.seed))
        out["look"] = {"grid_occupied_cells": {
            int(k): int(v.sum()) for k, v in self.ref_grid["occ"].items()}}
        return out


class Run:
    """One run of a cell: set-up, window, check, result."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device, self.t_start = trace, device, t_start
        self.is_cuda = torch.device(device).type == "cuda"
        self.slice = None
        self.loop = None

    def traced(self, trainer, body, units: int):
        """`body(units)` inside a profiler session, with the probe's spans
        and counters: the traced slice of the window."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.is_cuda else [])
        probe = tracing.Probe(trainer).install()
        path = os.path.join(self.tmp, "slice.json")
        try:
            sync(self.device)
            with profile(activities=acts) as prof:
                probe.recording = True
                with torch.profiler.record_function("nb.slice"):
                    out = body(units)
                    sync(self.device)
                probe.recording = False
            prof.export_chrome_trace(path)
        finally:
            probe.remove()
        self.slice_path, self.slice_units = path, units
        self.slice_calls = probe.field_calls()
        return out

    def set_up(self):
        self.tmpdir = tempfile.TemporaryDirectory(prefix="nerfbench-")
        self.tmp = self.tmpdir.name
        marks = [("start", self.t_start)]

        def mark(name):
            sync(self.device)
            marks.append((name, time.perf_counter()))
        self.loop = self.cell.loop_module().Loop(self)
        self.loop.set_up(mark)
        self.setup_s = marks[-1][1] - self.t_start
        print("set-up: " + ", ".join(
            f"{n} {b - a:.3f} s" for (_, a), (n, b) in zip(marks, marks[1:])),
            file=sys.stderr, flush=True)

    def window(self):
        self.loop.window(self.seconds, self.trace)

    def end_to_end(self) -> dict:
        return dict(self.loop.e2e, setup_s=self.setup_s)

    def memory_peak(self) -> int:
        if not self.is_cuda:
            return 0
        return int(torch.cuda.max_memory_allocated())

    def per_layer(self) -> dict:
        s = tracing.read_trace(self.slice_path, self.cell.field,
                               self.slice_units, self.slice_calls)
        self.slice = s
        vals = {}
        for m in self.cell.per_layer:
            v = self.cell.metric_reader(m["name"])(s)
            if v is not None:
                vals[m["name"]] = v
        return vals

    def close(self):
        self.tmpdir.cleanup()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float) -> dict:
    """One run of the cell on `device` -> the result's fields (the caller
    checks for the card and prints)."""
    run = Run(cell, seed, seconds, trace, device, t_start)
    try:
        run.set_up()
        run.window()
        peak = run.memory_peak()
        loop = run.loop
        loop.release()
        t0 = time.perf_counter()
        loop.reference()
        checks = loop.check()
        print(f"reference and check: {time.perf_counter() - t0:.3f} s",
              file=sys.stderr, flush=True)
        units = {m["name"]: m["unit"] for m in
                 cell.end_to_end + cell.per_layer}
        vals = run.per_layer() if trace else run.end_to_end()
        limits = cell.limits
        correct = loop.failed == 0 and all(
            checks[k] <= limits[k] for k in limits)
        result = {
            "correct": bool(correct),
            "attempted": loop.units,
            "failed": loop.failed,
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in vals.items()},
            "device": {"platform": "gpu" if run.is_cuda else "cpu",
                       "kind": (torch.cuda.get_device_name(0)
                                if run.is_cuda else "cpu"),
                       "count": cell.chips, "memory_peak_bytes": peak},
        }
        if trace:
            s = run.slice
            result["device"].update(busy_s=s.busy_s, window_s=s.slice_s)
            result["breakdown"] = {"device_ops": [list(x) for x in
                                                  s.device_ops],
                                   "idle_gaps": [list(x) for x in
                                                 s.idle_gaps]}
        result.update(getattr(loop, "window_info", {}))
        result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                            for k in limits}
        return result
    finally:
        run.close()
