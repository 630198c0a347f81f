"""Fixtures of the benchmark's tests: a copy of the benchmark in a temporary
directory whose cells run at a tiny size on the CPU (the program's plain
versions of its kernels), and the card for the tests marked `cuda`."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_FIELD = {"bound": 1.0, "scales": [[8, 4], [32, 4]], "planes": [[8, 2]],
              "freq_degree": 2, "num_layers": 2, "hidden_dim": 16,
              "geo_feat_dim": 15, "num_layers_color": 3,
              "hidden_dim_color": 16, "sh_degree": 4, "bg_radius": -1.0,
              "init_scale": 0.2}
TINY_DEFORM = {"num_layers_deform": 3, "hidden_dim_deform": 16,
               "multires_deform": 2, "multires_time": 2,
               "deform_grad_res_cutoff": 16}
# a grid of 16^3 cells marched at 8^3, so that a refresh is small
# (a refresh every second step)
TINY_OPTIONS = {"grid_size": 16, "march_res": 8, "n_intervals": 4,
                "dyn_anneal_steps": 4, "dyn_anneal_res": 16,
                "update_extra_interval": 2}
# limits of the tiny cells, from their CPU readings (the program's plain
# versions against the reference: loss 1e-4, gradient and change 1e-2,
# densities 1e-3, frames 1e-9, no occupancy missed), far below the faults
# that the tests plant
TINY_LIMITS = {"loss_gap": 1e-2, "grad_gap": 0.1, "change_gap": 0.1,
               "ema_gap": 0.1, "refresh_sigma_p99": 0.05,
               "grid_occ_miss": 0.01, "grid_query_shortfall": 0.0}
TINY_WINDOW = {"window_change_gap": 0.1, "window_ema_gap": 0.1}


def write_tiny(dest: str):
    """A copy of the benchmark under dest/nerfbench with dest/BENCHMARK.json
    holding three tiny cells: "tiny_dyn.train", "tiny_static.gui" and
    "tiny_dyn.frames"."""
    shutil.copytree(BENCH, os.path.join(dest, "nerfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    nb = os.path.join(dest, "nerfbench")

    def put(sub, name, obj):
        with open(os.path.join(nb, sub, name + ".json"), "w") as f:
            json.dump(obj, f)
    ds = {"views": 4, "res": 32, "fov": 0.9, "radius": 2.0}
    cli = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0"]
    put("configs", "tiny_static", {"cli": cli, "field": TINY_FIELD,
                                   "model": "cp", "dataset": ds,
                                   "options": TINY_OPTIONS})
    put("configs", "tiny_dyn", {"cli": cli, "model": "cp",
                                "field": dict(TINY_FIELD, **TINY_DEFORM),
                                "dataset": ds, "options": TINY_OPTIONS})
    base = {"rays_per_step": 64, "check_steps": 3, "trace_units": 2,
            "trace_at": 0.3, "grid_capture_steps": 2}
    put("traffic", "tiny_train", dict(base, loop="train", train_steps=8,
                                      trace_units=16, follow_steps=3))
    frames = dict(base, loop="frames", train_steps=6, warmup_frames=1,
                  width=32, height=32, check_frames=2, check_span=3,
                  camera={"radius": 2.0, "polar_deg": 80.0, "fovy": 50.0,
                          "deg_per_frame": 3.0})
    put("traffic", "tiny_gui", dict(frames, entry="test_gui", rebuild=False,
                                    time_steps=None))
    put("traffic", "tiny_frames", dict(frames, entry="render_image",
                                       rebuild=True, time_steps=120))
    cells = [("tiny_dyn.train", "tiny_dyn", "tiny_train"),
             ("tiny_static.gui", "tiny_static", "tiny_gui"),
             ("tiny_dyn.frames", "tiny_dyn", "tiny_frames")]
    for name, _, traffic in cells:
        put("limits", name, dict(TINY_LIMITS, **TINY_WINDOW)
            if traffic == "tiny_train" else dict(TINY_LIMITS, frames_mse=1e-6, frames_err_p99=2e-3,
                           frames_err_ratio=3.0))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                           "why": "test"} for n, c, t in cells]
    # the training loop's metrics, for the tiny training cell
    bench["end_to_end"].append({"name": "train_rays_per_s", "unit": "rays/s",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock"})
    bench["per_layer"] += [
        {"name": f[:-3], "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "Trainer step",
         "moves": "train_rays_per_s"}
        for f in sorted(os.listdir(os.path.join(nb, "metrics")))
        if f.endswith(".train.py")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return nb


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    return write_tiny(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"
