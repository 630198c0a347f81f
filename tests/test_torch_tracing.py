"""The port's own tracing (utils/profiling.py) on the frame and step paths:
spans off without a profiler session, the phases of a frame and of a step
nested in order inside one, the field calls' sample counters, the four
per-layer metrics of the benchmark that read them, the frame's fetch
(profiling.fetch_frame) on CPU tensors, and on the card the host_syncs
counter against the waits that PyTorch's sync debug mode reports. No JAX, so that the card tests run with --noconftest:

    python3 -m pytest --noconftest -q tests/test_torch_tracing.py
"""

import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sealdnerf_tpu_torch.models.cp import (CPConfig, CPDNeRFConfig,
                                           make_cp_dnerf_field,
                                           make_cp_field)
from sealdnerf_tpu_torch.train import fast
from sealdnerf_tpu_torch.train.fast import FastTrainer
from sealdnerf_tpu_torch.train.trainer import TrainOptions
from sealdnerf_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

NARROW = dict(grid_size=32, march_res=16, n_intervals=6, steps_per_interval=3)
STATIC_FIELD = dict(bound=1.0, scales=((16, 8), (64, 16)), planes=((16, 4),))
DYN_FIELD = dict(bound=1.0, scales=((16, 8), (64, 16)), planes=(),
                 num_layers_deform=3, hidden_dim_deform=16,
                 multires_deform=2)
# a bucketed frame's phases in the order they open, inside sdn.frame
FRAME_PHASES = ["sdn.frame.setup", "sdn.frame.march", "sdn.frame.trim",
                "sdn.frame.order", "sdn.frame.bucket", "sdn.frame.stitch",
                "sdn.frame.fetch"]
STEP_PHASES = ["sdn.step.sample", "sdn.step.forward", "sdn.step.backward",
               "sdn.step.update"]


@pytest.fixture(autouse=True)
def _clean_tally():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    profiling.reset_traced()
    yield
    profiling.reset_traced()
    torch.set_num_threads(n)


def _trainer(dynamic, ws, device="cpu"):
    """A seeded narrow CP trainer (dynamic: with the deform tower) whose
    occupancy is a ball of radius 0.6, so that frames take the bucketed
    renderer with the termination trim."""
    gen = torch.Generator().manual_seed(0)
    field = make_cp_dnerf_field(gen, CPDNeRFConfig(**DYN_FIELD)) if dynamic \
        else make_cp_field(gen, CPConfig(**STATIC_FIELD))
    opt = dict(iters=8, num_rays=64, bound=1.0, dt_gamma=0.0,
               update_extra_interval=2, segment_steps=4, workspace=ws,
               eval_interval=1000, **NARROW)
    if dynamic:
        opt.update(lr_net=1e-3, dyn_anneal_steps=0, time_curriculum_steps=0)
    tr = FastTrainer("t", TrainOptions(**opt), field, workspace=ws,
                     use_checkpoint="scratch", device=device,
                     time_conditioned=dynamic)
    _ball(tr, 0.6)
    return tr


def _ball(tr, radius):
    occ = tr.grid_state["occ"]
    h = occ.shape[-1]
    g = torch.linspace(-1.0, 1.0, h, device=occ.device)
    x, y, z = torch.meshgrid(g, g, g, indexing="ij")
    occ.copy_((x * x + y * y + z * z < radius ** 2).expand_as(occ))
    tr._occ_frac = None


def _frame(tr, dynamic, h=64, w=64, turn=0.0):
    """A frame from 2 before the origin, looking at it, the camera turned
    by `turn` degrees about the y axis."""
    a = np.radians(turn)
    rot = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                    [-np.sin(a), 0.0, np.cos(a)]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = rot
    pose[:3, 3] = rot @ np.array([0.0, 0.0, -2.0], np.float32)
    intr = np.array([0.6 * w, 0.6 * w, w / 2, h / 2], np.float32)
    return tr.render_image(pose, intr, h, w, time=0.3 if dynamic else None)


def _traced(fn, tmp_path):
    """fn() inside a CPU profiler session -> (its result, the trace's
    "sdn." spans as (start, end, name) sorted by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X"
                   and str(e.get("name", "")).startswith("sdn."))
    return out, spans


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("dynamic", [False, True])
def test_no_session_no_span(dynamic, tmp_path, monkeypatch):
    """Without a profiler session a frame opens no record_function and
    adds nothing to the traced tally; the process's counters still count
    its field samples."""
    tr = _trainer(dynamic, str(tmp_path))
    opened = []
    real = torch.profiler.record_function

    def spy(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    key = "k3.samples" if dynamic else "k1.samples"
    before = profiling.tally(traced=False)["counters"].get(key, 0)
    img, depth = _frame(tr, dynamic)
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    assert opened == []
    assert profiling.tally() == {"counters": {}, "spans": {}}
    assert profiling.tally(traced=False)["counters"][key] > before
    assert profiling.span("frame") is profiling.span("k1")


@pytest.mark.parametrize("dynamic", [False, True])
def test_frame_phases_nest_in_order(dynamic, tmp_path):
    """Inside a session: one sdn.frame holding its phases in order (a
    bucket at least twice), the field calls (the trim's and one a bucket)
    and the compositing under their phases; the tally counts them."""
    tr = _trainer(dynamic, str(tmp_path))
    _, spans = _traced(lambda: _frame(tr, dynamic), tmp_path)
    k = "sdn.k3" if dynamic else "sdn.k1"
    frames = [s for s in spans if s[2] == "sdn.frame"]
    assert len(frames) == 1
    phases = [s for s in spans if s[2].startswith("sdn.frame.")]
    assert all(_inside(p, frames[0]) for p in phases)
    names = [p[2] for p in phases]
    buckets = [p for p in phases if p[2] == "sdn.frame.bucket"]
    assert len(buckets) >= 2
    dedup = [n for i, n in enumerate(names) if i == 0 or n != names[i - 1]]
    assert dedup == FRAME_PHASES
    for a, b in zip(phases, phases[1:]):
        assert a[1] <= b[0], (a, b)            # one after another
    trim = [p for p in phases if p[2] == "sdn.frame.trim"][0]
    calls = [s for s in spans if s[2] == k]
    assert sum(_inside(c, trim) for c in calls) == 1
    for b in buckets:
        assert sum(_inside(c, b) for c in calls) == 1
        assert sum(_inside(c, b) for c in spans
                   if c[2] == "sdn.composite") == 1
    assert not [s for s in spans if s[2] in ("sdn.k2", "sdn.k4")]
    t = profiling.tally()
    assert t["spans"]["frame"]["n"] == 1
    assert t["spans"]["frame.bucket"]["n"] == len(buckets)
    assert t["spans"][k[4:]]["n"] == len(calls)
    assert t["spans"]["frame"]["stream_s"] is None      # no CUDA here
    assert t["spans"]["frame"]["host_s"] >= t["spans"]["frame.trim"]["host_s"]


@pytest.mark.parametrize("dynamic", [False, True])
def test_field_samples_are_the_calls_samples(dynamic, tmp_path, monkeypatch):
    """k1.samples (k3.samples) of a traced frame is the sum of the M of the
    frame's field calls, and no kernel call is counted on the CPU."""
    tr = _trainer(dynamic, str(tmp_path))
    name = "dyn_field_forward" if dynamic else "field_forward"
    real, ms = getattr(fast, name), []

    def counted(tables, cfg, x3, *a, **kw):
        ms.append(x3.shape[1])
        return real(tables, cfg, x3, *a, **kw)
    monkeypatch.setattr(fast, name, counted)
    _traced(lambda: _frame(tr, dynamic), tmp_path)
    k = "k3" if dynamic else "k1"
    counters = profiling.tally()["counters"]
    assert len(ms) >= 3 and counters[k + ".samples"] == sum(ms)
    assert k + ".calls" not in counters
    assert "host_syncs" not in counters and "fetch_bytes" not in counters


@pytest.mark.parametrize("dynamic", [False, True])
def test_step_phases_nest_in_order(dynamic, tmp_path):
    """A training step with its grid refresh: sdn.step holding
    sdn.grid.refresh, then the step's four phases in order; the forward's
    field call under step.forward, its backward's under step.backward."""
    from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
    tr = _trainer(dynamic, str(tmp_path))
    _, train, _ = make_synthetic_scene(n_train=2, n_val=1, res=16,
                                       dynamic=dynamic)
    data = tr._device_data(tr._prepare_train(train))
    tr._ready_for_steps(data)
    _, spans = _traced(lambda: tr.train_step(data, train.h, train.w),
                       tmp_path)
    steps = [s for s in spans if s[2] == "sdn.step"]
    assert len(steps) == 1
    inner = [s for s in spans if s[2] in STEP_PHASES + ["sdn.grid.refresh"]]
    assert all(_inside(s, steps[0]) for s in inner)
    assert [s[2] for s in inner] == ["sdn.grid.refresh"] + STEP_PHASES
    fwd, bwd = ("sdn.k3", "sdn.k4") if dynamic else ("sdn.k1", "sdn.k2")
    by = {s[2]: s for s in inner}
    assert any(_inside(s, by["sdn.step.forward"]) for s in spans
               if s[2] == fwd)
    assert any(_inside(s, by["sdn.step.forward"]) for s in spans
               if s[2] == "sdn.composite")
    assert any(s[2] == bwd for s in spans)
    assert profiling.tally()["counters"][bwd[4:] + ".samples"] > 0


# ------------------------------------------------------------------ fetch
FETCHED = [((7, 5, 3), torch.float32), ((7, 5), torch.float32),
           ((4, 6), torch.int32), ((9,), torch.bool)]


@pytest.mark.parametrize("shape,dtype", FETCHED)
def test_fetch_frame_of_cpu_tensors_is_their_numpy(shape, dtype):
    """On CPU tensors fetch_frame returns what .cpu().numpy() returns, in
    value, dtype and shape, and counts no transfer: no fetch_bytes, no
    fetch_pinned_bytes, no host_syncs, in a session or outside one."""
    gen = torch.Generator().manual_seed(0)
    ts = [(torch.rand(shape, generator=gen) * 10).to(dtype)
          for _ in range(2)]
    before = profiling.tally(traced=False)["counters"]
    with profile(activities=[ProfilerActivity.CPU]):
        got = profiling.fetch_frame(*ts)
    assert len(got) == len(ts)
    for a, t in zip(got, ts):
        want = t.cpu().numpy()
        assert a.dtype == want.dtype and a.shape == want.shape
        np.testing.assert_array_equal(a, want)
    assert profiling.tally()["counters"] == {}
    assert profiling.tally(traced=False)["counters"] == before


@pytest.mark.parametrize("dynamic", [False, True])
def test_successive_frames_share_no_memory(dynamic, tmp_path):
    """Two frames in a row, from one camera and from two: no array of one
    shares memory with an array of the other, nor rgb with depth."""
    tr = _trainer(dynamic, str(tmp_path))
    first = _frame(tr, dynamic)
    for turn in (0.0, 40.0):
        second = _frame(tr, dynamic, turn=turn)
        for a in first:
            for b in second:
                assert not np.shares_memory(a, b)
    assert not np.shares_memory(*first)


@pytest.mark.parametrize("dynamic", [False, True])
def test_kept_frame_is_unchanged_by_later_frames(dynamic, tmp_path):
    """A frame's arrays, kept, read the same after three later frames from
    other cameras, which differ from it."""
    tr = _trainer(dynamic, str(tmp_path))
    kept = _frame(tr, dynamic)
    snap = [a.copy() for a in kept]
    later = [_frame(tr, dynamic, turn=40.0 * i) for i in (1, 2, 3)]
    assert all(not np.array_equal(f[0], snap[0]) for f in later)
    for a, s in zip(kept, snap):
        np.testing.assert_array_equal(a, s)


# ---------------------------------------------------------------- readers
READERS = {"fetch_ms_per_frame.view": 1e3 * 0.048 / 4,
           "composite_ms_per_frame.view": 1e3 * 0.014 / 4,
           "host_syncs_per_frame.view": 56 / 4,
           "field_samples_per_frame.view": (3000 + 5000) / 4}


def _reader(name):
    from nerfbench import harness
    return harness.load_module(os.path.join(ROOT, "nerfbench"), "metrics",
                               name).read


@pytest.mark.parametrize("name", list(READERS))
def test_readers_read_the_tally(name, monkeypatch):
    """Each reader, on a hand-made slice of 4 frames and tally, returns its
    number; None where the tally is empty, has no stream seconds, or where
    the program keeps no tally at all."""
    from nerfbench import tracing
    s = tracing.Slice(units=4)
    full = {"counters": {"host_syncs": 56, "k1.samples": 3000,
                         "k3.samples": 5000, "k1.calls": 2},
            "spans": {"frame.fetch": {"n": 4, "host_s": 0.05,
                                      "stream_s": 0.048},
                      "composite": {"n": 12, "host_s": 0.002,
                                    "stream_s": 0.014}}}
    no_stream = {"counters": {}, "spans": {
        k: dict(v, stream_s=None) for k, v in full["spans"].items()}}
    read = _reader(name)
    for tally, want in ((full, READERS[name]),
                        ({"counters": {}, "spans": {}}, None),
                        (no_stream, None)):
        monkeypatch.setattr(profiling, "tally", lambda traced=True, t=tally: t)
        got = read(s)
        assert got == (None if want is None else pytest.approx(want))
    monkeypatch.delattr(profiling, "tally")
    assert read(s) is None


def test_reader_sums_static_and_dynamic_samples(monkeypatch):
    """field_samples_per_frame.view reads K1's or K3's samples alone where
    only one ran."""
    from nerfbench import tracing
    read = _reader("field_samples_per_frame.view")
    monkeypatch.setattr(profiling, "tally", lambda traced=True: {
        "counters": {"k3.samples": 1200}, "spans": {}})
    assert read(tracing.Slice(units=12)) == pytest.approx(100.0)


# ------------------------------------------------------------------- card
def _sync_warnings(fn):
    """fn() under sync debug mode "warn" -> (the waits that PyTorch
    reported, as the lines that made them, and the host_syncs that the
    program counted)."""
    torch.cuda.synchronize()
    before = profiling.tally(traced=False)["counters"].get("host_syncs", 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counted = profiling.tally(traced=False)["counters"].get(
        "host_syncs", 0) - before
    seen = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]
    return seen, counted


def _card_trainer(dynamic, ws):
    from sealdnerf_tpu_torch import main_dnerf
    from sealdnerf_tpu_torch.cli import base_parser, build_trainer, \
        postprocess
    argv = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--ckpt",
            "scratch", "--workspace", ws]
    if dynamic:
        opt = main_dnerf.parse_args(argv)
        tr, _ = build_trainer(opt, name="card", dynamic=True,
                              lr_net=opt.lr_net)
    else:
        tr, _ = build_trainer(postprocess(base_parser().parse_args(argv)),
                              name="card")
    _ball(tr, 0.5)
    return tr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["view1080", "view800"])
def test_host_syncs_are_the_waits_sync_debug_reports(cell, tmp_path):
    """One frame of each benchmark cell's shape on the seeded CLI field
    with a sparse grid (the bucketed renderer and its trim): a 1920x1080
    test_gui frame with depth of the static field, an 800x800
    render_image of the dynamic one at t = 0.3; the first frame after the
    grid changed (the occupancy's share read) and the next. host_syncs
    counts every wait that sync debug mode reports, and no other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dynamic = cell == "view800"
    tr = _card_trainer(dynamic, str(tmp_path))
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -2.5
    if dynamic:
        intr = np.array([800.0, 800.0, 400.0, 400.0], np.float32)

        def frame():
            tr.render_image(pose, intr, 800, 800, time=0.3)
    else:
        intr = np.array([1158.0, 1158.0, 960.0, 540.0], np.float32)

        def frame():
            tr.test_gui(pose, intr, 1920, 1080, need_depth=True)
    frame()                                         # builds the kernels
    _ball(tr, 0.5)
    for _ in range(2):
        seen, counted = _sync_warnings(frame)
        assert seen and counted == len(seen), (counted, seen)


@pytest.mark.cuda
@pytest.mark.parametrize("dynamic", [False, True])
def test_step_host_syncs_are_the_waits_sync_debug_reports(dynamic,
                                                          tmp_path):
    """Training steps of the seeded CLI field, one with a grid refresh
    and one without: host_syncs counts every wait that sync debug mode
    reports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = _card_trainer(dynamic, str(tmp_path))
    _, train, _ = make_synthetic_scene(n_train=4, n_val=1, res=64,
                                       dynamic=dynamic)
    data = tr._device_data(tr._prepare_train(train))
    tr._ready_for_steps(data)
    tr.train_step(data, train.h, train.w)           # builds the kernels
    for _ in range(4):
        seen, counted = _sync_warnings(
            lambda: tr.train_step(data, train.h, train.w))
        assert counted == len(seen), (tr.global_step, counted, seen)
