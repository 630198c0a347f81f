"""The port's editing student (FastStudentTrainer) and its CLIs against the
JAX package.

Narrow teachers trained by the port on the CPU, loaded into both packages
(tests/torch_edit_setup.py); the bbox edit of the reference's own tests.
Tolerances:
- zone points: equal; their ground truth (the port's teacher queries at the
  port's points and directions, against the reference's teacher field at
  the same): the bare field's tolerance against the reference's XLA model,
  rtol 2e-2 with atol 1e-3 (sigma) and 2e-3 (rgb);
- freeze labels: equal on CP, CP-D-NeRF and every encoder family;
- one pretraining step (lr 0.07) against the reference's jitted step, the
  reference's field through its fused Pallas train forward in interpret
  mode (the port's plain versions share its rounding points): loss rtol
  1e-4, encoder leaves within 1e-4, tower and deform leaves unchanged in
  both;
- a short narrow dynamic distillation: the student's val PSNR against its
  proxied views within the band of three JAX seeds widened by 0.75 dB (as
  test_torch_train.py: threefry and Philox draw different rays);
- the deform tower bit for bit the teacher's across two train calls, with
  the other leaves' Adam state kept;
- --planes that contradicts the teacher checkpoint is refused (the
  reference ignores the flag); main_seald and main_SealNeRF end to end on
  the CPU write their artefacts.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.editing.student import FastStudentTrainer as JaxFast
from sealdnerf_tpu.editing.student import StudentTrainer as JaxStudent
from sealdnerf_tpu.editing.student import sample_zone_points as jax_zones
from sealdnerf_tpu.editing.teacher import make_teacher_field
from sealdnerf_tpu.models.cp import CPConfig as JaxCPConfig
from sealdnerf_tpu.models.cp import CPDNeRFConfig as JaxDynConfig
from sealdnerf_tpu.models.cp import make_cp_dnerf_field as jax_dyn_field
from sealdnerf_tpu.models.cp import make_cp_field as jax_cp_field
from sealdnerf_tpu.ops.pallas_field import (make_fused_dyn_train_forward,
                                            make_fused_train_forward)
from sealdnerf_tpu_torch import cli, main_seald, main_SealNeRF
from sealdnerf_tpu_torch.editing.student import (FastStudentTrainer,
                                                 freeze_labels,
                                                 sample_zone_points)
from sealdnerf_tpu_torch.models.cp import (CPField, map_params, param_leaves,
                                           params_to_numpy)

import torch_edit_setup as setup

SIGMA_TOL = dict(rtol=2e-2, atol=1e-3)
RGB_TOL = dict(rtol=2e-2, atol=2e-3)
STEP_TOL = 1e-4
BAND_DB = 0.75
SEEDS = (1, 2, 3)
ZONES = dict(local_point_step=0.05, surrounding_point_step=0.1,
             global_point_step=0.25)
PRE_BATCH = 1024
DISTIL_STEPS = 64


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_student(tt, ws, dynamic, mapper, **kw):
    field = CPField(map_params(lambda t: t.detach().clone(), tt.params),
                    tt.field.cfg)
    if dynamic:
        from sealdnerf_tpu_torch.models.cp import cp_dnerf_deform_raw
        cfg = tt.field.cfg
        field.deform_raw = lambda p, x, t: cp_dnerf_deform_raw(p, cfg, x, t)
    st = FastStudentTrainer("ngp", setup.port_options(ws, dynamic, **kw),
                            field, tt, mapper=mapper, workspace=ws,
                            use_checkpoint="scratch", device="cpu",
                            time_conditioned=dynamic)
    st.adopt_grid_state(tt.grid_state)
    return st


def _jax_student(jt, ws, dynamic, mapper, cls=JaxStudent, **kw):
    cfg = JaxDynConfig(**setup.DYN_FIELD) if dynamic \
        else JaxCPConfig(**setup.STATIC_FIELD)
    field = (jax_dyn_field if dynamic else jax_cp_field)(
        jax.random.PRNGKey(1), cfg)
    field.params = jax.tree_util.tree_map(lambda x: x.copy(), jt.params)
    js = cls("ngp", setup.jax_options(ws, **kw), field, jt, mapper=mapper,
             workspace=ws, use_checkpoint="scratch", time_conditioned=dynamic)
    js.params = field.params
    js.grid_state = jax.tree_util.tree_map(lambda x: x.copy(), jt.grid_state)
    return js


@pytest.fixture(scope="module")
def teachers(tmp_path_factory):
    """teachers(dynamic) -> (workspace, port teacher, JAX teacher), trained
    once per module; the teacher's checkpoint is in workspace/teacher."""
    cache = {}

    def get(dynamic):
        if dynamic not in cache:
            ws = str(tmp_path_factory.mktemp(
                "dynamic" if dynamic else "static"))
            tt = setup.train_port_teacher(ws + "/teacher", dynamic)
            cache[dynamic] = (ws, tt,
                              setup.jax_teacher(ws + "/teacher", dynamic))
        return cache[dynamic]
    return get


@pytest.fixture(scope="module", params=["static", "dynamic"])
def edit(request, teachers):
    dynamic = request.param == "dynamic"
    ws, tt, jt = teachers(dynamic)
    mj, mt = setup.mappers(setup.seal_config())
    tf = setup.TIME_FRAME if dynamic else None
    st = _port_student(tt, ws + "/s", dynamic, mt)
    st.init_pretraining(time_frame=tf, epochs=1, batch_size=PRE_BATCH,
                        **ZONES)
    np.random.seed(0)
    js = _jax_student(jt, ws + "/js", dynamic, mj)
    js.init_pretraining(time_frame=tf, epochs=1, batch_size=PRE_BATCH,
                        **ZONES)
    return dict(dynamic=dynamic, tt=tt, jt=jt, mj=mj, mt=mt, st=st, js=js,
                ws=ws, tf=tf)


def _live(zone):
    w = np.asarray(zone["weight"]).reshape(-1) > 0
    return {k: np.asarray(v).reshape(w.shape[0], -1)[w]
            for k, v in zone.items()}


def test_sample_zone_points_match():
    b = np.array([[[-0.3, -0.2, -0.1], [0.2, 0.35, 0.3]],
                  [[0.5, 0.5, 0.5], [0.9, 0.6, 0.7]]])
    for a, c in zip(jax_zones(b, 0.05, 45), sample_zone_points(b, 0.05, 45)):
        np.testing.assert_array_equal(a, c)


def test_zone_points_and_ground_truth_match(edit):
    st, js, jt = edit["st"], edit["js"], edit["jt"]
    assert set(st.pretraining_data) == set(js.pretraining_data) == {
        "local", "surrounding", "global"}
    dyn = edit["dynamic"]
    extra = (jnp.float32(edit["tf"]),) if dyn else ()
    jtf = make_teacher_field(jt.field, edit["mj"], time_conditioned=dyn)
    for name in st.pretraining_data:
        mine = _live({k: v.numpy() for k, v in
                      st.pretraining_data[name].items()})
        ref = _live(js.pretraining_data[name])
        np.testing.assert_array_equal(mine["points"], ref["points"])
        assert len(mine["points"]) > 20
        fwd = jtf.forward if name == "local" else jt.field.forward
        s_j, c_j = fwd(jt.params, jnp.asarray(mine["points"]),
                       jnp.asarray(mine["dirs"]), *extra)[:2]
        np.testing.assert_allclose(mine["sigma"].reshape(-1),
                                   np.asarray(s_j), **SIGMA_TOL)
        np.testing.assert_allclose(mine["color"], np.asarray(c_j),
                                   **RGB_TOL)
    # directions from the fixed set, drawn from the seeded generator
    d = _live({k: v.numpy() for k, v in
               st.pretraining_data["local"].items()})["dirs"]
    assert np.allclose(np.linalg.norm(d, axis=1), 1 - 1e-5, atol=1e-6)
    assert len(np.unique(d.round(5), axis=0)) > 10
    vis = os.path.join(st.workspace, "pretrain_vis")
    assert sorted(os.listdir(vis)) == ["global.ply", "local.ply",
                                       "surrounding.ply"]


def test_freeze_labels_match():
    """The reference's labels on CP, CP-D-NeRF and the encoder families of
    tests/test_editing.py."""
    families = {k: np.zeros(1) for k in (
        "grid", "bg_grid", "sigma_mlp", "color_mlp", "deform_mlp",
        "ambient_mlp", "basis", "basis_mlp", "lines", "planes", "vm_lines",
        "sigma_lines", "app_planes", "basis_grid")}
    cp = params_to_numpy(setup.make_cp_field(
        torch.Generator().manual_seed(0),
        setup.CPConfig(**setup.STATIC_FIELD)).params)
    dyn = params_to_numpy(setup.make_cp_dnerf_field(
        torch.Generator().manual_seed(0),
        setup.CPDNeRFConfig(**setup.DYN_FIELD)).params)
    st = object.__new__(JaxStudent)
    for params in (families, cp, dyn):
        ref = JaxStudent._freeze_labels(st, params)
        got = freeze_labels(params)
        assert set(got) == set(ref)
        for k, lab in got.items():
            assert set(jax.tree_util.tree_leaves(ref[k])) == {lab}, k
    assert freeze_labels(dyn) == {"lines": "enc", "sigma_mlp": "mlp",
                                  "color_mlp": "mlp", "deform_mlp": "deform"}


def test_one_pretraining_step_matches(edit):
    st, js = edit["st"], edit["js"]
    dyn = edit["dynamic"]
    cfg = js.field.cfg
    js.field.forward = (make_fused_dyn_train_forward if dyn
                        else make_fused_train_forward)(cfg, interpret=True,
                                                       tile=256)
    js._build_pretrain_step()
    zone = st.pretraining_data["local"]
    batch = {k: v[0] for k, v in zone.items()}
    before = map_params(np.copy, params_to_numpy(st.params))
    jparams = jax.tree_util.tree_map(jnp.asarray, before)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    t = jnp.float32(edit["tf"] or 0.0)
    new_j, _, loss_j = js._pretrain_step_fn(jparams, js._pretrain_state,
                                            jbatch, t)
    st._build_pretrain_optimizer()
    loss_t = st.pretrain_step(batch)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=STEP_TOL)
    labels = freeze_labels(st.params)
    after = params_to_numpy(st.params)
    for k in after:
        for a, b, p in zip(jax.tree_util.tree_leaves(after[k]),
                           jax.tree_util.tree_leaves(new_j[k]),
                           jax.tree_util.tree_leaves(before[k])):
            if labels[k] == "enc":
                np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                           atol=STEP_TOL, err_msg=k)
                assert np.abs(a - p).max() > 1e-2, k     # it moved
            else:
                np.testing.assert_array_equal(a, p, err_msg=k)
                np.testing.assert_array_equal(np.asarray(b), p, err_msg=k)
    # restore the student for the other tests of the module
    with torch.no_grad():
        for q, p in zip(param_leaves(st.params), param_leaves(
                map_params(torch.from_numpy, before))):
            q.copy_(p)


def test_deform_frozen_and_adam_state_kept(tmp_path, teachers):
    """Two train calls of a dynamic student: the deform leaves stay the
    teacher's bit for bit, and the other leaves' Adam moments go on from
    the first call (the optimizer is never rebuilt)."""
    ws = str(tmp_path)
    tt = teachers(True)[1]
    _, mt = setup.mappers(setup.seal_config())
    st = _port_student(tt, ws + "/s", True, mt, iters=10_000)
    st.init_pretraining(time_frame=0.5, epochs=1, batch_size=PRE_BATCH,
                        **ZONES)
    train, _ = setup.scene(True)
    deform = [p.clone() for p in param_leaves(tt.params["deform_mlp"])]
    lines0 = tt.params["lines"][0][0].detach().clone()
    opt = st.optimizer
    st.train(train, None, max_epochs=2, time_frame=0.5)
    leaf = st.params["lines"][1][0]
    count1 = int(opt.state[leaf]["step"])
    assert count1 == 16                            # one epoch of 16 steps
    st.train(train, None, max_epochs=2, time_frame=0.5)
    assert st.optimizer is opt
    assert int(opt.state[leaf]["step"]) == 2 * count1
    for a, b in zip(param_leaves(st.params["deform_mlp"]), deform):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not a.requires_grad and a not in opt.state
    assert not torch.equal(st.params["lines"][0][0], lines0)
    assert all(not p.requires_grad
               for p in param_leaves(st.params["deform_mlp"]))
    # the proxied dataset is pinned to the edit's frame
    assert np.all(st.proxy_dataset(train).times == np.float32(0.5))


def test_distillation_in_jax_band(teachers, tmp_path):
    """A short narrow dynamic distillation (one pretraining epoch,
    DISTIL_STEPS ray steps): the port's student against its proxied val
    views, within the band of the reference's students over three seeds."""
    from sealdnerf_tpu.data.synthetic import make_synthetic_scene
    train, val = setup.scene(True)
    jtrain, jval = setup.scene(True, make_synthetic_scene)
    _, tt, jt = teachers(True)
    mj, mt = setup.mappers(setup.seal_config())
    ep = DISTIL_STEPS // 16
    # the reference main_seald's rates, in both packages; the teacher's
    # proxy renders a 32 px view (1,024 rays) in one chunk of 1,024 rays
    kw = dict(iters=10_000, lr=5e-4, lr_net=5e-5, max_ray_batch=1024)
    np.random.seed(0)
    js = _jax_student(jt, str(tmp_path / "js"), True, mj, cls=JaxFast, **kw)
    # both packages' proxies render through render_occ
    init = jax.tree_util.tree_map(np.asarray, js.params)
    grid0 = jax.tree_util.tree_map(lambda x: x.copy(), js.grid_state)
    js.init_pretraining(time_frame=0.5, epochs=1, batch_size=PRE_BATCH,
                        **ZONES)
    band = []
    for seed in SEEDS:
        js.rng = jax.random.PRNGKey(seed)
        js.params = jax.tree_util.tree_map(jnp.asarray, init)
        js.ema_params = jax.tree_util.tree_map(jnp.asarray, init)
        js.field.params = js.params
        js.opt_state = js.tx.init(js.params)
        js._pretrain_state = js._pretrain_tx.init(js.params)
        js.grid_state = jax.tree_util.tree_map(lambda x: x.copy(), grid0)
        js.global_step = js.epoch = 0
        js.train(jtrain, None, max_epochs=1 + ep, time_frame=0.5)
        gt = js.proxy_dataset(jval, time=0.5)
        band.append(float(js.evaluate(gt)))
    st = _port_student(tt, str(tmp_path / "s"), True, mt, **kw)
    st.init_pretraining(time_frame=0.5, epochs=1, batch_size=PRE_BATCH,
                        **ZONES)
    st.train(train, None, max_epochs=1 + ep, time_frame=0.5)
    assert st.global_step == DISTIL_STEPS + sum(
        z["points"].shape[0] for z in st.pretraining_data.values())
    got = st.evaluate(st.proxy_dataset(val))
    print(f"port {got:.3f} dB; JAX {band}")
    assert min(band) - BAND_DB <= got <= max(band) + BAND_DB, (got, band)


# -------------------------------------------------------------- the CLIs
def _narrow(fn):
    return lambda opt, **kw: fn(opt, **kw, **setup.NARROW, segment_steps=8)


def test_main_seald_refuses_contradicting_planes(tmp_path, teachers):
    """The reference builds CPDNeRFConfig(bound) and ignores --planes
    (main_seald.py:72); the port takes the teacher checkpoint's shapes and
    refuses a --planes that says otherwise."""
    tws = teachers(True)[0] + "/teacher"
    base = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--device",
            "cpu", "--teacher_workspace", tws, "--workspace",
            str(tmp_path / "s")]
    with pytest.raises(SystemExit, match="contradicts"):
        cli.build_edit_trainers(main_seald.parse_args(
            base + ["--planes", "16,4"]), dynamic=True, **setup.NARROW)
    for planes in ("off", "auto"):
        _, st, mapper = cli.build_edit_trainers(main_seald.parse_args(
            base + ["--planes", planes]), dynamic=True, **setup.NARROW)
        assert st.field.cfg.planes == () and mapper is None
        assert st.field.cfg.scales == setup.DYN_FIELD["scales"]
    with pytest.raises(SystemExit, match="no teacher checkpoint"):
        cli.build_edit_trainers(main_seald.parse_args(
            base + ["--teacher_workspace", str(tmp_path / "none")]),
            dynamic=True)


def test_main_seald_rates_follow_the_backbone():
    """The reference's main_seald keeps its hash backbone's lr 5e-4 and
    lr_net 5e-5 for the CP field too; the port resolves them by backbone as
    main_dnerf does."""
    base = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0"]
    opt = main_seald.parse_args(base)
    assert (opt.lr, opt.lr_net) == (1e-2, 1e-3)
    assert opt.update_extra_interval == 16 and opt.time_frame == 0.0
    assert opt.teacher_workspace == opt.workspace
    opt = main_seald.parse_args(base + ["--backbone", "ngp"])
    assert (opt.lr, opt.lr_net) == (5e-4, 5e-5)
    opt = main_seald.parse_args(base + ["--lr", "3e-3", "--lr_net", "2e-4"])
    assert (opt.lr, opt.lr_net) == (3e-3, 2e-4)


def _artefacts(ws):
    names = set(os.listdir(ws))
    assert {"seal.json", "options.json", "run.sh", "timer.json",
            "from.obj", "to.obj", "results"} <= names, names
    assert sorted(os.listdir(os.path.join(ws, "pretrain_vis"))) == [
        "local.ply", "surrounding.ply"]
    assert json.load(open(os.path.join(ws, "seal.json")))["type"] == "bbox"
    timer = json.load(open(os.path.join(ws, "timer.json")))
    assert len(timer["pretraining"]) == 1 and timer["training_total"] > 0
    return sorted(os.listdir(os.path.join(ws, "results")))


@pytest.mark.parametrize("case", ["dynamic", "static", "custom_pose"])
def test_main_edit_end_to_end_on_the_cpu(tmp_path, monkeypatch, teachers,
                                        case):
    """main_seald (dynamic) and main_SealNeRF (static, and on random orbit
    poses around the edit with --custom_pose) with --device cpu: one
    pretraining epoch and one epoch of distillation, then the test
    frames."""
    dynamic = case == "dynamic"
    mod = main_seald if dynamic else main_SealNeRF
    monkeypatch.setattr(mod, "build_edit_trainers",
                        _narrow(cli.build_edit_trainers))
    tws = teachers(dynamic)[0] + "/teacher"
    ws = str(tmp_path / "edit")
    os.makedirs(ws)
    with open(os.path.join(ws, "seal.json"), "w") as f:
        f.write("// the edit\n" + json.dumps(setup.seal_config())[:-1]
                + ",}\n")
    argv = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--device",
            "cpu", "--synthetic_res", "32", "--teacher_workspace", tws,
            "--workspace", ws, "--pretraining_epochs", "1",
            "--pretraining_batch_size", "2048",
            "--pretraining_local_point_step", "0.05",
            "--pretraining_surrounding_point_step", "0.1",
            "--extra_epochs", "1", "--num_rays", "128", "--max_steps", "256"]
    if dynamic:
        argv += ["--seal_config", "seal.json", "--time_frame", "0.5"]
    if case == "custom_pose":
        argv += ["--custom_pose"]
    st = mod.main(argv)
    frames = [f for f in _artefacts(ws) if f.endswith(".png")]
    assert len(frames) == 6 and frames[0].endswith("_rgb.png")
    assert st.global_step > 8 and st.epoch == 2
    proxied = st.proxied["train"]
    if case == "custom_pose":
        # 50 orbit poses around the edit's pose centre, imaged by the teacher
        assert len(proxied) == 50 and proxied.images.shape[1:] == (32, 32, 3)
        centre = np.asarray(st.mapper.map_data["pose_center"].cpu())
        dist = np.linalg.norm(proxied.poses[:, :3, 3] - centre, axis=1)
        np.testing.assert_allclose(dist, dist[0], rtol=1e-5)
    else:
        assert len(proxied) == 48
    log = open(os.path.join(ws, "log_ngp.txt")).read()
    assert "proxy_dataset" in log and "[pretrain epoch 1]" in log
    # the frames go to an mp4 too where an encoder imports
    assert "mp4 export unavailable" in log or any(
        f.endswith(".mp4") for f in _artefacts(ws))
