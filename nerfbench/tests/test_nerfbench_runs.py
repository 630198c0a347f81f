"""Whole runs of tiny cells on the CPU (the program's plain versions of its
kernels): the result's schema, cells, mixes and metrics found by name in
new files, and the check coming out false with the timed path broken
underneath."""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from conftest import write_tiny

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(bench_dir, name, trace=False, seed=2 ** 31 + 11, seconds=0.6):
    from nerfbench import harness
    torch.set_num_threads(2)
    return harness.run_cell(harness.Cell(name, bench_dir), seed, seconds,
                            trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", ["tiny_dyn.train", "tiny_static.gui",
                                  "tiny_dyn.frames"])
def test_result_schema(tiny_bench, name):
    r = run(tiny_bench, name)
    assert list(r)[:5] == RESULT_KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] > 0
    e2e = {"setup_s"} | ({"train_rays_per_s"} if name.endswith("train")
                         else {"frames_per_s", "frame_ms_p95"})
    assert set(r["metrics"]) == e2e
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(r)


def test_traced_run(tiny_bench):
    r = run(tiny_bench, "tiny_dyn.frames", trace=True)
    assert r["correct"] is True
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # a CPU trace has field calls to count, and no device to read
    assert r["metrics"]["samples_per_frame.view"]["value"] > 0
    assert "device_idle.view" not in r["metrics"]


def test_new_cell_mix_and_metric_are_found_by_name(tmp_path):
    """A configuration, a traffic mix with a loop of its own, a metric and
    a cell added as new files and entries run without an edit of the
    harness."""
    nb = write_tiny(str(tmp_path))
    cfg = json.load(open(os.path.join(nb, "configs", "tiny_static.json")))
    cfg["field"]["hidden_dim"] = 8
    json.dump(cfg, open(os.path.join(nb, "configs", "extra_cfg.json"), "w"))
    mix = json.load(open(os.path.join(nb, "traffic", "tiny_gui.json")))
    mix.update(width=48, height=32, loop="still")
    json.dump(mix, open(os.path.join(nb, "traffic", "extra_mix.json"), "w"))
    with open(os.path.join(nb, "loops", "still.py"), "w") as f:
        f.write("from nerfbench.loops import frames\n\n\n"
                "class Loop(frames.Loop):\n"
                "    def camera(self, k):\n"
                "        self.cameras = getattr(self, 'cameras', 0) + 1\n"
                "        return super().camera(0)\n")
    shutil.copy(os.path.join(nb, "limits", "tiny_static.gui.json"),
                os.path.join(nb, "limits", "extra.cell.json"))
    with open(os.path.join(nb, "metrics", "frames_traced.view.py"), "w") as f:
        f.write("def read(s):\n    return float(s.units)\n")
    path = os.path.join(str(tmp_path), "BENCHMARK.json")
    b = json.load(open(path))
    b["workloads"].append({"name": "extra.cell", "config": "extra_cfg",
                           "traffic": "extra_mix", "chips": 1, "why": "t"})
    b["per_layer"].append({"name": "frames_traced.view", "unit": "frames",
                           "better": "higher", "source": "program_counter",
                           "layer": "Frame renderer", "moves": "frames_per_s",
                           "workloads": ["extra.cell"]})
    json.dump(b, open(path, "w"))
    r = run(nb, "extra.cell", trace=True)
    assert r["correct"] is True
    assert r["metrics"]["frames_traced.view"]["value"] == 2.0
    r = run(nb, "tiny_static.gui", trace=True)
    assert "frames_traced.view" not in r["metrics"]


def test_check_fails_on_a_step_that_changes_nothing(tiny_bench,
                                                    monkeypatch):
    from sealdnerf_tpu_torch.train.fast import FastTrainer
    monkeypatch.setattr(FastTrainer, "apply_gradients", lambda self: None)
    r = run(tiny_bench, "tiny_dyn.train")
    assert r["correct"] is False
    assert r["checks"]["change_gap"]["value"] > 0.9


def test_check_fails_on_half_the_batch(tiny_bench, monkeypatch):
    """Half of each step's rays left out, the mean taken over the rest."""
    from sealdnerf_tpu_torch.train.fast import FastTrainer
    loss_on = FastTrainer.loss_on

    def half(self, rays_o, rays_d, gt, bg, noise=None, *a, **k):
        n = rays_o.shape[0] // 2
        bg = bg[:n] if bg.dim() == 2 else bg
        return loss_on(self, rays_o[:n], rays_d[:n], gt[:n], bg,
                       None if noise is None else noise[:n], *a, **k)
    monkeypatch.setattr(FastTrainer, "loss_on", half)
    r = run(tiny_bench, "tiny_dyn.train")
    assert r["correct"] is False
    assert r["checks"]["loss_gap"]["value"] > r["checks"]["loss_gap"]["limit"]


def test_check_fails_on_an_altered_frame(tiny_bench, monkeypatch):
    """Each frame altered where it is produced: its colour channels
    rotated."""
    from sealdnerf_tpu_torch.train.fast import FastTrainer
    render_image = FastTrainer.render_image

    def altered(self, *a, **k):
        img, depth = render_image(self, *a, **k)
        return np.ascontiguousarray(img[..., [1, 2, 0]]), depth
    monkeypatch.setattr(FastTrainer, "render_image", altered)
    r = run(tiny_bench, "tiny_dyn.frames")
    assert r["correct"] is False
    for k in ("frames_mse", "frames_err_p99", "frames_err_ratio"):
        assert r["checks"][k]["value"] > r["checks"][k]["limit"]


def test_check_fails_on_a_window_step_that_changes_nothing(tiny_bench,
                                                           monkeypatch):
    """The steps after set-up leave the state unchanged: the first steps
    pass, the steps followed after the window do not."""
    from sealdnerf_tpu_torch.train.fast import FastTrainer
    apply = FastTrainer.apply_gradients

    def late_noop(self):
        if self.global_step < 8:
            apply(self)
    monkeypatch.setattr(FastTrainer, "apply_gradients", late_noop)
    r = run(tiny_bench, "tiny_dyn.train")
    assert r["correct"] is False
    c = r["checks"]
    assert c["change_gap"]["value"] <= c["change_gap"]["limit"]
    assert c["window_change_gap"]["value"] > 0.9


@pytest.mark.parametrize("name", ["tiny_static.gui", "tiny_dyn.frames"])
def test_check_fails_on_a_sparser_grid(tiny_bench, monkeypatch, name):
    """Half of the occupied cells dropped where the grid's last update
    produces them (the rebuild, or a training refresh)."""
    from sealdnerf_tpu_torch.train.fast import FastTrainer
    fn = "rebuild_grid" if name == "tiny_dyn.frames" else "refresh_grid"
    orig = getattr(FastTrainer, fn)

    def sparser(self, *a, **k):
        out = orig(self, *a, **k)
        occ = self.grid_state["occ"]
        keep = torch.rand(occ.shape, generator=torch.Generator()
                          .manual_seed(0)) < 0.5
        occ &= keep.to(occ.device)
        return out
    monkeypatch.setattr(FastTrainer, fn, sparser)
    r = run(tiny_bench, name)
    assert r["correct"] is False
    c = r["checks"]["grid_occ_miss"]
    assert c["value"] > 0.3 > c["limit"]
