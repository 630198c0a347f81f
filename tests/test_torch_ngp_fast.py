"""The Instant-NGP field on FastTrainer: K5's plain version
(ops/field.py:hash_field_forward) against the benchmark's plain reference
(nerfbench/reference/ngp_field.py), K5's packed operands and index
arithmetic emulated from its meta, one FastTrainer step against the
reference's loss and gradients, the CLI's routes for --backbone ngp, the
k5 counters and span, and a tiny benchmark cell on the NGP field run end to
end on the CPU."""

import functools
import json
import os
import shutil
import time
import types

import numpy as np
import pytest
import torch

from nerfbench.reference import field as rfield
from nerfbench.reference import ngp_field as nf
from sealdnerf_tpu_torch import cli
from sealdnerf_tpu_torch.models import ngp as tn
from sealdnerf_tpu_torch.models.api import NGPField, make_ngp_field
from sealdnerf_tpu_torch.models.ngp import NGPConfig
from sealdnerf_tpu_torch.ops import field as F
from sealdnerf_tpu_torch.ops.grid_encode import grid_encode
from sealdnerf_tpu_torch.ops.hat import bf16_round
from sealdnerf_tpu_torch.ops.sh_encode import sh_encode
from sealdnerf_tpu_torch.train.fast import FastTrainer
from sealdnerf_tpu_torch.train.trainer import Trainer
from sealdnerf_tpu_torch.utils import profiling
from test_torch_field_pack import _unfrag

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 4 levels from 4 to 2048 over a table of 2^10 rows a level: level 0 indexes
# its 5^3 corners linearly, levels 1-3 hash
SMALL = dict(num_levels=4, base_resolution=4, log2_hashmap_size=10)
# K5's own widths (16 levels of 2 features, 64-wide towers) on a small
# table: levels 0-1 linear (125 and 512 rows), 2-15 hashed
KERNEL_SMALL = dict(base_resolution=4, log2_hashmap_size=10)


def _ref_cfg(cfg: NGPConfig) -> dict:
    """The reference's configuration dict of an NGPConfig."""
    out = {k: getattr(cfg, k) for k in (
        "bound", "num_levels", "level_dim", "base_resolution",
        "log2_hashmap_size", "gridtype", "sh_degree")}
    out["desired_resolution"] = cfg.grid_cfg.desired_resolution
    return out


def _params(cfg, seed=0, table_scale=0.5):
    """Seeded params with a table of N(0, table_scale) entries: the seeded
    U(+-1e-4) table leaves features of ~1e-4, which would hide a misread
    corner."""
    g = torch.Generator().manual_seed(seed)
    p = tn.init_ngp(g, cfg)
    p["grid"] = torch.randn(p["grid"].shape, generator=g) * table_scale
    return p


def _samples(m, seed, spill=0.0):
    """Positions in [-1 - spill, 1 + spill]^3 (a spill puts some outside the
    box, where the encoding is zero) and unit directions, [3, m] each."""
    rng = np.random.default_rng(seed)
    x3 = rng.uniform(-1 - spill, 1 + spill, (3, m)).astype(np.float32)
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    return torch.from_numpy(x3), torch.from_numpy(d3)


# --------------------------------------------- plain version vs reference
def test_grid_levels_are_the_references():
    """The port's level layout (offsets, resolutions) and the reference's,
    at the published widths and at the small test size: some levels linear,
    some hashed."""
    for kw in ({}, SMALL):
        cfg = NGPConfig(**kw)
        lv = nf.levels(_ref_cfg(cfg))
        gc = cfg.grid_cfg
        assert [off for *_, off in lv] == list(gc.offsets[:-1])
        assert nf.table_rows(_ref_cfg(cfg)) == gc.table_size
        hashed = [s is None for _, s, _, _ in lv]
        assert any(hashed) and not all(hashed)
    assert NGPConfig().grid_cfg.table_size == 6119864


@pytest.mark.parametrize("spill", [0.0, 0.1])
def test_encoding_equals_the_references(spill):
    """grid_encode and the reference's encode compute the same f32
    operations (8 corner products a level, summed over the corners), so
    they agree to f32 rounding of a sum of 8 terms; points outside the box
    encode to zeros in both."""
    cfg = NGPConfig(**SMALL)
    p = _params(cfg)
    x3, _ = _samples(4097, 1, spill)
    x01 = (x3.t() + 1.0) / 2.0
    got = grid_encode(x01, p["grid"], cfg.grid_cfg)
    want = nf.encode(p, _ref_cfg(cfg), x01)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    out = ((x01 < 0) | (x01 > 1)).any(-1)
    assert (spill == 0) == (not out.any())
    assert (want[out] == 0).all()


@pytest.mark.parametrize("density_only", [False, True])
def test_hash_field_plain_matches_reference(density_only):
    """K5's plain version against the reference. With the reference's
    operands rounded as the kernel rounds them (the bf16 quantiser: table,
    features, tower operands and hidden activations) the two compute the
    same products in the same order: they agree to f32 rounding (1e-6
    relative, a bf16 tie flipped by it at most moves one hidden activation
    by 2^-8, which the 1e-3 atol covers). Against the f32 reference they
    differ by the bf16 roundings, a few 2^-8 relative: 5e-2 on sigma (an
    exp of the logit), 2e-2 on the colours."""
    cfg = NGPConfig(**SMALL)
    p = _params(cfg)
    tables = F.pack_hash_tables(p, cfg)
    x3, d3 = _samples(2048, 2, spill=0.05)
    out = F.hash_field_forward(tables, cfg, x3, None if density_only else d3,
                               density_only=density_only)
    rc = _ref_cfg(cfg)
    for q, rtol, atol in ((rfield.bf16, 1e-6, 1e-3), (rfield.exact, 5e-2,
                                                      2e-2)):
        sig, rgb = nf.forward_chunked(p, rc, x3.t(), d3.t(), q=q,
                                      density_only=density_only)
        np.testing.assert_allclose(out[0], sig, rtol=rtol, atol=atol)
        if density_only:
            assert (out[1:] == 0).all()
        else:
            np.testing.assert_allclose(out[1:].t(), rgb, rtol=0,
                                       atol=max(atol, rtol))


# ------------------------------------------ K5's operands, emulated
def _kernel_index(meta_level, cells):
    """The corner rows of K5's hash segment, emulated from one level's meta
    (scale bits, res, s1, s2, size, off, hashed) in uint32 as the kernel
    computes them: cells [N, 3] -> rows [N, 8] of the packed table."""
    _, _, s1, s2, size, off, hashed = meta_level
    c = cells.astype(np.uint64)
    rows = []
    for i in range(8):
        x, y, z = (c[:, a] + ((i >> a) & 1) for a in range(3))
        if hashed:
            h = (x ^ ((y * 2654435761) & 0xFFFFFFFF)
                 ^ ((z * 805459861) & 0xFFFFFFFF)) & (size - 1)
        else:
            lin = (x + y * s1 + z * s2) & 0xFFFFFFFF
            h = np.where(lin >= size, lin - size, lin)
        rows.append(off + h)
    return np.stack(rows, -1).astype(np.int64)


def _hash_tile_forward(tables, cfg, x3, d3):
    """K5's tile arithmetic from its meta and wfwd: per level the cell and
    fractions from the meta's f32 scale, the corners at the emulated rows,
    the f32 trilinear sum rounded to bf16, then K1's towers on the unpacked
    matrices (the first one's rows in their natural order)."""
    meta = tables.meta
    lv = [meta[46 + 7 * l:53 + 7 * l] for l in range(16)]
    tab = tables.plain["grid"].float().numpy()
    u = ((x3.t() + 1.0) / 2.0).numpy()
    feats = np.zeros((u.shape[0], 32), np.float32)
    for lvl, m in enumerate(lv):
        scale = np.array([m[0]], np.uint32).view(np.float32)[0]
        pos = u * scale + np.float32(0.5)
        pf = np.floor(pos)
        fr = pos - pf
        cells = np.clip(pf, 0, m[1]).astype(np.int64)
        rows = _kernel_index(m, cells)
        f = np.zeros((u.shape[0], 2), np.float32)
        for i in range(8):
            w = np.ones(u.shape[0], np.float32)
            for a in range(3):
                w = w * (fr[:, a] if (i >> a) & 1 else 1 - fr[:, a])
            f = f + w[:, None] * tab[rows[:, i]]
        feats[:, 2 * lvl:2 * lvl + 2] = f
    feats[((u < 0) | (u > 1)).any(-1)] = 0
    w_off = meta[12:17]
    ends = list(w_off[1:]) + [tables.wfwd.numel()]
    shapes = [(32, 64), (64, 16), (32, 64), (64, 64), (64, 16)]
    w0, w1, wc0, wc1, wc2 = (torch.from_numpy(_unfrag(tables.wfwd[a:b], *s))
                             for a, b, s in zip(w_off, ends, shapes))
    kpos = [16 * (e // 4) + 2 * t + e % 2 + 8 * (e // 2 % 2)
            for t in range(4) for e in range(8)]
    w0 = w0[kpos]
    h = bf16_round(torch.relu(bf16_round(torch.from_numpy(feats)) @ w0))
    o = h @ w1
    sh = sh_encode(d3.t(), degree=4)
    cin = torch.zeros((u.shape[0], 32))
    for t in range(4):
        for c in range(4):
            cin[:, 2 * t + c % 2 + 8 * (c // 2)] = sh[:, 4 * t + c]
    cin[:, 17:] = o[:, 1:]
    hc = bf16_round(torch.relu(bf16_round(cin) @ wc0))
    hc = bf16_round(torch.relu(hc @ wc1))
    rgb = torch.sigmoid(hc @ wc2)[:, :3]
    return torch.cat([torch.exp(o[:, :1]), rgb], dim=1).t()


def test_k5_operands_and_index_arithmetic_match_plain():
    """What K5 computes from its packed operands and meta (one k-block of
    four hash segments, levels 4t..4t+3 of thread t; per level the f32
    scale, the clamp, the strides, the rows, the offset and the hash flag,
    with the modulo as a mask or one subtraction) is the plain version's
    function, at K5's widths on a small table that both indexes and hashes:
    the same roundings, so 2e-3 relative on sigma and 2e-4 on the colours
    cover f32 sums in another order."""
    cfg = NGPConfig(**KERNEL_SMALL)
    tables = F.pack_hash_tables(_params(cfg, seed=3), cfg)
    meta = tables.meta
    assert meta[10:12] == [1, tables.wfwd.numel()] and meta[17] == F.SEG_HASH
    assert [meta[18 + 7 * t:20 + 7 * t] for t in range(4)] == \
        [[F.SEG_HASH, 4 * t] for t in range(4)]
    assert len(meta) == 46 + 7 * 16
    hashed = [meta[46 + 7 * l + 6] for l in range(16)]
    assert hashed[:2] == [0, 0] and all(hashed[2:])
    x3, d3 = _samples(1025, 4, spill=0.05)
    got = _hash_tile_forward(tables, cfg, x3, d3)
    ref = F.hash_field_forward_plain(tables, cfg, x3, d3)
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(got[1:], ref[1:], rtol=0, atol=2e-4)


@pytest.mark.parametrize("kw", [dict(num_levels=8), dict(level_dim=4),
                                dict(hidden_dim=32),
                                dict(gridtype="tiled")])
def test_k5_refuses_what_it_does_not_take(kw):
    """Other level counts, feature widths, towers or a tiled grid whose
    index needs a general modulo: K5 raises, and the packed weights are
    empty."""
    cfg = NGPConfig(**dict(KERNEL_SMALL, **kw))
    with pytest.raises(NotImplementedError):
        F.hash_tile_layout(cfg)
    p = tn.init_ngp(torch.Generator().manual_seed(0), cfg)
    assert F.pack_hash_tables(p, cfg).wfwd.numel() == 0


# ------------------------------------------------------ counters and spans
class _FakeLib:
    def __init__(self):
        self.calls = []

    def sdn_hash_field_fwd(self, *args):
        self.calls.append(args)
        return 0


def test_k5_counters_and_span(tmp_path, monkeypatch):
    """k5.samples counts every call's samples, k5.density_samples those of
    density-only calls, k5.calls the calls that reached the kernel (on the
    CPU none; a launch, here with the library stubbed, adds one); the span
    sdn.k5 and the counters are recorded while a profiler session runs, and
    --profile's trace writes them to its counters.json."""
    cfg = NGPConfig(**SMALL)
    tables = F.pack_hash_tables(_params(cfg), cfg)
    x3, d3 = _samples(100, 5)

    def counters():
        return dict(profiling.tally(traced=False)["counters"])
    before = counters()
    F.hash_field_forward(tables, cfg, x3, d3)
    F.hash_field_forward(tables, cfg, x3, None, density_only=True)
    after = counters()

    def delta(k):
        return after.get(k, 0) - before.get(k, 0)
    assert (delta("k5.samples"), delta("k5.density_samples"),
            delta("k5.calls")) == (200, 100, 0)
    kcfg = NGPConfig(**KERNEL_SMALL)
    ktab = F.pack_hash_tables(_params(kcfg), kcfg)
    lib = _FakeLib()
    from sealdnerf_tpu_torch.ops import build
    monkeypatch.setattr(build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev:
                        types.SimpleNamespace(cuda_stream=0))
    n0 = counters().get("k5.calls", 0)
    F._launch_hash(ktab, kcfg, x3, d3, True)
    assert counters().get("k5.calls", 0) == n0 + 1 and len(lib.calls) == 1
    assert lib.calls[0][2] == 100 and lib.calls[0][7] == 1
    # --profile's trace: the span and the counters in counters.json
    with profiling.profile_trace(str(tmp_path), "cpu"):
        F.hash_field_forward(tables, cfg, x3, None, density_only=True)
    with open(profiling.counters_path(str(tmp_path), 0)) as f:
        t = json.load(f)
    assert t["spans"]["k5"]["n"] == 1
    assert t["counters"]["k5.samples"] == t["counters"][
        "k5.density_samples"] == 100


# ------------------------------------------------------------ the trainer
def _fast_trainer(tmp_path, **opts):
    cfg = NGPConfig(**SMALL)
    field = make_ngp_field(torch.Generator().manual_seed(0), cfg, "cpu")
    field.params["grid"] = _params(cfg, table_scale=0.1)["grid"]
    topt = cli.to_train_options(cli.postprocess(cli.base_parser().parse_args(
        ["synthetic", "-O", "--backbone", "ngp", "--bound", "1",
         "--dt_gamma", "0", "--num_rays", "256"])), grid_size=16,
        march_res=8, n_intervals=4, **opts)
    return FastTrainer("ngp", topt, field, workspace=str(tmp_path),
                       use_checkpoint="scratch", device="cpu")


def test_fast_trainer_step_matches_reference(tmp_path):
    """One FastTrainer step on the NGP field against the reference's step
    on the same rays, noise and occupancy (nerfbench's NGP field module: the
    dense march, compositing and Adam of the reference with its NGP field):
    the loss to 1e-3 and every leaf's gradient norm to 2e-2, the room of the
    bf16 tower operands and activations that the port's training forward
    rounds (the reference computes in f32)."""
    from nerfbench import capture
    from nerfbench.harness import load_module
    fm = load_module(os.path.join(ROOT, "nerfbench"), "fields", "ngp")
    tr = _fast_trainer(tmp_path)
    from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
    _, train, _ = make_synthetic_scene(n_train=3, n_val=1, res=32)
    data = train.device("cpu")
    tr._ready_for_steps(data)
    params0 = capture.clone_tree(tr.params)
    with capture.StepCapture(tr) as cap:
        loss, _ = tr.train_step(data, 32, 32)
        cap.losses.append(loss)
        cap.after_step(0)
    cell = types.SimpleNamespace(field=_ref_cfg(tr.field.cfg), name="test")
    ref = fm.reference_steps(cell, cap, params0, tr.opt, rfield.exact)
    out = capture.compare_training(cap, ref, cap)
    assert out["loss_gap"] < 1e-3 and out["grad_gap"] < 2e-2, out
    # the refresh before the step queried K5's plain version
    assert out["refresh_sigma_p99"] < 5e-2, out


def test_fast_trainer_serves_checkpoints_and_the_gui(tmp_path):
    """A FastTrainer NGP checkpoint loads back into a FastTrainer (its
    params checked against the field, as Trainer checks them) and into
    Trainer; the GUI's preview without depth renders the full field."""
    tr = _fast_trainer(tmp_path)
    from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
    _, train, val = make_synthetic_scene(n_train=3, n_val=1, res=32)
    tr.train_gui(train.device("cpu"), 32, 32, step=3)
    tr.save_checkpoint(full=True)
    t2 = _fast_trainer(tmp_path)
    t2.load_checkpoint(os.path.join(str(tmp_path), "checkpoints",
                                    sorted(os.listdir(tmp_path /
                                                      "checkpoints"))[-1]))
    assert t2.global_step == 3
    for a, b in zip(F.param_leaves(tr.params), F.param_leaves(t2.params)):
        assert torch.equal(a, b)
    full = tr.test_gui(val.poses[0], val.intrinsics, 32, 32)
    prev = tr.test_gui(val.poses[0], val.intrinsics, 32, 32,
                       need_depth=False)
    assert prev["depth"] is None and np.isfinite(prev["image"]).all()
    assert full["image"].shape == prev["image"].shape == (32, 32, 3)
    with pytest.raises(ValueError):
        _fast_trainer(tmp_path).load_checkpoint(
            _other_checkpoint(tmp_path / "other"))


def test_fast_trainer_adds_the_tables_tv_term(tmp_path):
    """With --tv_weight > 0 a FastTrainer step on the NGP field adds
    tv_weight x the table's TV energy at points drawn, as Trainer draws
    them, after the batch: one point a ray, in [0, 1]^3."""
    tr = _fast_trainer(tmp_path, tv_weight=0.5)
    from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
    _, train, _ = make_synthetic_scene(n_train=3, n_val=1, res=32)
    data = train.device("cpu")
    tr._ready_for_steps(data)
    seen = []
    tv = tr.field.tv_loss

    def spy(params, x01):
        seen.append(x01)
        return tv(params, x01)
    tr.field.tv_loss = spy
    tr.train_step(data, 32, 32)
    x, = seen
    assert x.shape == (256, 3) and float(x.min()) >= 0 and \
        float(x.max()) <= 1


def _other_checkpoint(ws):
    """A checkpoint of another hash table's size."""
    cfg = NGPConfig(num_levels=4, base_resolution=4, log2_hashmap_size=9)
    field = make_ngp_field(torch.Generator().manual_seed(0), cfg, "cpu")
    tr = Trainer("ngp", cli.to_train_options(cli.postprocess(
        cli.base_parser().parse_args(["synthetic", "--bound", "1"])),
        grid_size=16), field, workspace=str(ws), use_checkpoint="scratch",
        device="cpu")
    tr.save_checkpoint(full=True)
    d = os.path.join(str(ws), "checkpoints")
    return os.path.join(d, sorted(os.listdir(d))[-1])


@pytest.mark.parametrize("extra,edit,want", [
    ([], False, FastTrainer),
    (["--bound", "1", "--dt_gamma", "0"], False, FastTrainer),
    (["--bg_radius", "1"], False, Trainer),
    ([], True, Trainer)])
def test_backbone_ngp_routes(tmp_path, monkeypatch, extra, edit, want):
    """--backbone ngp builds FastTrainer on the NGP field at bg_radius <= 0
    (at the CLI's defaults, bound 2 and dt_gamma 1/128, on two cascades; at
    bound 1 and dt_gamma 0 on one), Trainer with the
    background sphere, and Trainer for an edit CLI's teacher (the field of
    the StudentTrainer that edits it)."""
    monkeypatch.setattr(tn, "NGPConfig", functools.partial(tn.NGPConfig,
                                                           **SMALL))
    opt = cli.postprocess(cli.base_parser().parse_args(
        ["synthetic", "-O", "--backbone", "ngp", "--device", "cpu",
         "--workspace", str(tmp_path), "--ckpt", "scratch"] + extra))
    if edit:
        opt.log2_hashmap_size = 10
    tr, field = cli.build_trainer(opt, edit=edit, grid_size=16, march_res=8)
    assert type(tr) is want and isinstance(field, NGPField)
    if want is FastTrainer:
        assert tr.march_cfg.cascades == (1 if "--bound" in extra else 2)


# ------------------------------------------------ the benchmark, tiny
TINY = dict(SMALL, hidden_dim=16, hidden_dim_color=16)


def test_tiny_ngp_cell_runs_correct(tmp_path, monkeypatch):
    """A tiny cell on the NGP field (nerfbench's fields/ngp.py on the CPU,
    the port's plain versions): its steps, grid update and frames against
    the reference come out correct, a traced run reports the K5 samples a
    frame, and the float8 control fails the check. The window's first frame
    is the one checked, so that a slow host's short window still has it."""
    from nerfbench import harness
    from nerfbench.reference import field as rf
    monkeypatch.setattr(tn, "NGPConfig", functools.partial(tn.NGPConfig,
                                                           **TINY))
    torch.set_num_threads(2)
    nb = os.path.join(str(tmp_path), "nerfbench")
    shutil.copytree(os.path.join(ROOT, "nerfbench"), nb,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))

    def put(sub, name, obj):
        with open(os.path.join(nb, sub, name + ".json"), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(nb, "configs", "ngp.json")) as f:
        conf = json.load(f)
    put("configs", "tiny_ngp", dict(
        conf, field=dict(conf["field"], **TINY),
        dataset={"views": 4, "res": 32, "fov": 0.9, "radius": 2.0},
        options={"grid_size": 16, "march_res": 8, "n_intervals": 4,
                 "update_extra_interval": 2}))
    put("traffic", "tiny_gui", {
        "loop": "frames", "entry": "test_gui", "rays_per_step": 64,
        "check_steps": 3, "train_steps": 6, "grid_capture_steps": 2,
        "rebuild": False, "time_steps": None, "warmup_frames": 1,
        "width": 32, "height": 32, "check_frames": 1, "check_span": 1,
        "trace_units": 2, "trace_at": 0.3,
        "camera": {"radius": 2.0, "polar_deg": 80.0, "fovy": 50.0,
                   "deg_per_frame": 3.0}})
    limits = {"loss_gap": 1e-2, "grad_gap": 0.1, "change_gap": 0.1,
              "ema_gap": 0.1, "refresh_sigma_p99": 0.05,
              "grid_occ_miss": 0.01, "grid_query_shortfall": 0.0,
              "frames_err_p99": 2e-3, "frames_err_ratio": 3.0}
    put("limits", "tiny_ngp.gui", limits)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"] = [{"name": "tiny_ngp.gui", "config": "tiny_ngp",
                           "traffic": "tiny_gui", "chips": 1, "why": "t"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    bench["per_layer"] = [m for m in bench["per_layer"] if m["name"] in (
        "k5_roofline.view", "mfu_hash.view", "k5_samples_per_frame.view")]
    with open(os.path.join(str(tmp_path), "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = harness.Cell("tiny_ngp.gui", nb)
    r = harness.run_cell(cell, 2 ** 31 + 11, 0.5, False, "cpu",
                         time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert set(r["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
    r = harness.run_cell(cell, 2 ** 31 + 11, 0.5, True, "cpu",
                         time.perf_counter())
    # the CPU has no stream to time and no kernel calls: the samples alone
    assert set(r["metrics"]) == {"k5_samples_per_frame.view"}
    assert r["metrics"]["k5_samples_per_frame.view"]["value"] > 0
    run = harness.Run(cell, 5, 0.5, False, "cpu", time.perf_counter())
    try:
        run.set_up()
        run.window()
        run.loop.release()
        run.loop.reference()
        ctl = run.loop.readings()["control"]
    finally:
        run.close()
    assert any(ctl[k] > v for k, v in limits.items()), ctl
    assert rf.fp8 is nf.fp8


def test_ngp_configuration_is_what_the_cli_runs():
    """The benchmark's ngp configuration holds the field that its flags give
    through the program's CLI (NGPConfig at --bound 1, no background), uncut;
    the cell ngp.view1080 runs it on one card; and work_hash.py counts the
    towers' 9,344 MACs a sample and the 6,119,864 x 2 table once a call."""
    import dataclasses
    from nerfbench import work_hash
    from nerfbench.harness import load_module
    with open(os.path.join(ROOT, "nerfbench", "configs", "ngp.json")) as f:
        conf = json.load(f)
    opt = cli.postprocess(cli.base_parser().parse_args(
        conf["cli"] + ["--device", "cpu"]))
    run = NGPConfig(bound=opt.bound, bg_radius=opt.bg_radius)
    want = {f.name: getattr(run, f.name) for f in dataclasses.fields(run)
            if f.init}
    want["desired_resolution"] = run.grid_cfg.desired_resolution
    assert conf["field"] == want
    assert conf["model"] == "ngp" and conf["reduced"] == []
    assert (opt.backbone, opt.bound, opt.dt_gamma) == ("ngp", 1.0, 0.0)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, = [w for w in bench["workloads"] if w["name"] == "ngp.view1080"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("ngp", "view1080", 1)
    fm = load_module(os.path.join(ROOT, "nerfbench"), "fields", "ngp")
    shapes = dict(fm.param_shapes(conf["field"]))
    assert shapes[("grid",)] == (6119864, 2)
    nbytes, tensor, fp32 = work_hash.hash_work(conf["field"], 1, 1)
    assert tensor == 2 * 9344
    assert nbytes == 40 + 2 * (6119864 * 2 + 9344)
    _, tensor_d, fp32_d = work_hash.hash_work(conf["field"], 1, 1, 1)
    assert tensor_d == 2 * (32 * 64 + 64 * 16) and fp32_d < fp32
