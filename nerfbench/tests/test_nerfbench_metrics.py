"""The metric arithmetic: the rates over the whole window, the tail over
all frames, the reduction of a profiler trace, and the frozen work counts
against hand counts at the kernels' shapes."""

import json
import time

import numpy as np
import pytest
import torch

from nerfbench import harness, tracing, work


class _Trainer:
    """A trainer whose steps take 4 ms on the host clock."""

    def __init__(self):
        self.global_step = 0
        self.grid_state = {"iter_density": torch.tensor(0)}

    def train_step(self, *a):
        time.sleep(0.004)
        self.global_step += 1
        return torch.tensor(1.0), 0


def _loop(mod, traffic):
    lp = mod.Loop.__new__(mod.Loop)
    lp.tr, lp.device, lp.run = traffic, "cpu", None
    lp.data = lp.h = lp.w = None
    lp.steps = lambda n: None
    return lp


@pytest.mark.parametrize("loop", ["train", "frames"])
def test_rates_over_the_whole_window(loop):
    """The window's rate counts every step or frame over all its seconds,
    and the tail is over every frame's latency."""
    from nerfbench.loops import frames, train
    seconds = 0.3
    if loop == "train":
        lp = _loop(train, {"rays_per_step": 4096, "trace_units": 1,
                           "trace_at": 0.5, "train_steps": 10,
                           "follow_steps": 3})
        lp.trainer = _Trainer()
        t0 = time.perf_counter()
        lp.window(seconds, False)
        wall = time.perf_counter() - t0
        rate = lp.e2e["train_rays_per_s"]
        assert lp.units == lp.trainer.global_step
        assert lp.units * 4096 / wall <= rate <= lp.units * 4096 / seconds
        assert lp.window_info == {"window_steps": [0, lp.units - 1],
                                  "window_grid_refreshes": 0}
        return
    lp = _loop(frames, {"trace_units": 1, "trace_at": 0.5})
    lp.sample = set()
    # every tenth frame stalls: a tenth of the latencies lie above 20 ms
    delays = iter(([0.004] * 9 + [0.02]) * 1000)

    def frame(k):
        time.sleep(next(delays))
        return np.zeros((2, 2, 3)), (None,) * 5
    lp.frame = frame
    t0 = time.perf_counter()
    lp.window(seconds, False)
    wall = time.perf_counter() - t0
    assert lp.units / wall <= lp.e2e["frames_per_s"] <= lp.units / seconds
    assert lp.e2e["frame_ms_p95"] > 19.0


def test_p95_over_all_frames_moves_with_one_stall():
    lat = [0.030 + 0.0001 * (i % 7) for i in range(200)]
    base = harness.quantile95(lat)
    # a stall of 10 frames' worth among the slowest twentieth moves it
    stalled = list(lat)
    for i in range(0, 200, 20):
        stalled[i] = 0.5
    assert harness.quantile95(stalled) > base
    one = list(lat)
    one[3] = 0.5
    assert harness.quantile95(one) >= base
    # over all frames, not a median of chunks: 5 % of stalls show fully
    five = list(lat)
    for i in range(0, 200, 19):
        five[i] = 0.5
    assert harness.quantile95(five) > 0.1


def _ev(name, cat, ts, dur, tid=1, corr=None, ph="X"):
    e = {"name": name, "cat": cat, "ph": ph, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_reduction(tmp_path):
    """Device time under a span is what was launched inside it on the same
    thread, whatever the kernel's name; busy time is the union; idle gaps
    carry the span and the operator open on the main thread."""
    ev = [
        _ev("nb.slice", "user_annotation", 0, 1000),
        _ev("nb.step", "user_annotation", 0, 1000),
        _ev("aten::mul", "cpu_op", 10, 20),
        _ev("cudaLaunchKernel", "cuda_runtime", 12, 2, corr=1),
        _ev("nb.k3", "user_annotation", 100, 200),
        _ev("cudaLaunchKernel", "cuda_runtime", 110, 2, corr=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 150, 2, corr=3),
        _ev("aten::item", "cpu_op", 400, 300),
        _ev("aten::copy_", "cpu_op", 710, 10),
        # the backward's thread
        _ev("nb.k4", "user_annotation", 500, 100, tid=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 510, 2, tid=2, corr=4),
        # device
        _ev("mul_kernel", "kernel", 20, 30, tid=7, corr=1),
        _ev("warp_kernel", "kernel", 120, 100, tid=7, corr=2),
        _ev("field_fwd_kernel", "kernel", 200, 50, tid=7, corr=3),
        _ev("Memcpy DtoH", "gpu_memcpy", 250, 10, tid=7, corr=3),
        _ev("bwd", "kernel", 600, 110, tid=7, corr=4),
        # outside the slice
        _ev("late", "kernel", 1500, 100, tid=7, corr=9),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = tracing.read_trace(str(path), {}, 4, [])
    assert s.slice_s == pytest.approx(1e-3)
    assert s.n_kernels == 4
    assert s.busy_s == pytest.approx((30 + 140 + 110) * 1e-6)
    assert s.device_s("nb.k3") == pytest.approx(160e-6)
    assert s.device_s("nb.k4") == pytest.approx(110e-6)
    assert s.device_s("nb.step") == pytest.approx(190e-6)
    gaps = dict(s.idle_gaps)
    # 260 -> 600 starts inside nb.k3; the others inside nb.step alone
    assert gaps["nb.k3"] == pytest.approx(340e-6)
    assert gaps["nb.step"] == pytest.approx((20 + 70) * 1e-6)
    assert gaps["nb.step > aten::copy_"] == pytest.approx(290e-6)
    assert sum(gaps.values()) == pytest.approx(1e-3 - s.busy_s)
    assert s.device_ops[0][0] == "bwd"


# K1-K4 at the shapes of PERF.md's kernel table, whose bounds (ms) were
# computed by chip_smoke.py's _field_work
CP = {"bound": 1.0, "scales": [[32, 32], [128, 48], [512, 64], [1024, 64]],
      "planes": [[128, 8]], "freq_degree": 4, "num_layers": 2,
      "hidden_dim": 64, "geo_feat_dim": 15, "num_layers_color": 3,
      "hidden_dim_color": 64, "sh_degree": 4}
DYN = dict(CP, num_layers_deform=8, hidden_dim_deform=128,
           multires_deform=10, multires_time=6)


@pytest.mark.parametrize("cfg,m,kw,bound_ms", [
    (CP, 1048613, {}, 0.0930),
    (CP, 262181, {"mode": "bwd"}, 0.0698),
    (DYN, 1048613, {"mode": "dyn"}, 0.3213),
    (DYN, 262181, {"mode": "dyn_bwd", "m_live": 183223}, 0.1681)])
def test_work_counts(cfg, m, kw, bound_ms):
    assert work.bound_seconds(cfg, m, **kw) * 1e3 == pytest.approx(
        bound_ms, abs=6e-5)


def test_work_by_hand():
    """The towers' products counted by hand at the CP widths: sigma
    (32 + 48 + 64 + 64 + 3 x 8 + 27 = 259) -> 64 -> 16, colour (16 + 15)
    -> 64 -> 64 -> 3; the deform tower 76 -> 128 x 7 -> 3, of whose first
    matrix only the 63 position rows run a sample."""
    macs = 259 * 64 + 64 * 16 + 31 * 64 + 64 * 64 + 64 * 3
    _, tensor, _ = work.field_work(CP, 1000)
    assert tensor == 2 * macs * 1000
    dmacs = 63 * 128 + 6 * 128 * 128 + 128 * 3
    _, tensor, _ = work.field_work(DYN, 1000, mode="dyn")
    assert tensor == 2 * (macs + dmacs) * 1000
    _, tensor, _ = work.field_work(DYN, 1000, mode="dyn_bwd", m_live=10)
    assert tensor == 3 * 2 * (macs + dmacs) * 10
    _, tensor, _ = work.field_work(CP, 1000, density_only=True)
    assert tensor == 2 * (259 * 64 + 64 * 16) * 1000
