"""The GUI slice end to end on the CPU: the port's viewers and editor on its
trainers (sealdnerf_tpu_torch/gui over train/fast.py and editing/), against
the JAX package's renderers on the same fields.

Fields: the narrow static and dynamic CP teachers of
tests/torch_edit_setup.py (trained by the port on the CPU; the JAX package
loads the same checkpoint).

Tolerances:
- a scripted GUI session (drag, wheel, pan; the time slider at 0.5 for the
  dynamic field), three frames at downscales 8, 4 and 2 (frame times
  scripted): the last frame against the reference's renderer of the same
  variant (the LOD preview) at the same camera, downscale and pick (per
  ray at this size; tests/test_torch_bucketed.py holds the bucketed GUI
  frames): max |diff| <= 2e-2, as tests/test_torch_slice.py holds served
  frames;
- the editing session (brush on pixels with depth, start, one pretraining
  frame, one distillation frame, override): after the override the
  teacher's frame equals the student's bit for bit and differs from the
  pre-edit teacher's (a stale cache would render the pre-edit teacher).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_edit_setup as setup
from sealdnerf_tpu.ops import marching_dense as jmd
from sealdnerf_tpu.render import fast_image as jfi
from sealdnerf_tpu.render.dynamic_grid import \
    time_slice_index as jax_time_slice
from sealdnerf_tpu_torch.editing.student import FastStudentTrainer
from sealdnerf_tpu_torch.gui.controller import GUIController
from sealdnerf_tpu_torch.gui.edit_controller import EditController, EditState
from sealdnerf_tpu_torch.models.cp import (CPDNeRFConfig, CPField,
                                           cp_dnerf_deform_raw,
                                           make_cp_dnerf_field)
from sealdnerf_tpu_torch.models.params import map_params
from sealdnerf_tpu_torch.train.fast import FastTrainer

FIELD_ATOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; a torch pool of
    every core in each makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Opt:
    W = H = 32
    radius = 2.0
    fovy = 50.0
    max_spp = 4


@pytest.fixture(scope="module")
def teachers(tmp_path_factory):
    cache = {}

    def get(dynamic):
        if dynamic not in cache:
            ws = str(tmp_path_factory.mktemp("dyn" if dynamic else "static"))
            tt = setup.train_port_teacher(ws + "/teacher", dynamic)
            cache[dynamic] = (ws, tt,
                              setup.jax_teacher(ws + "/teacher", dynamic))
        return cache[dynamic]
    return get


def _recorded(trainer):
    """Wrap trainer.test_gui: every frame's camera, downscale and image."""
    frames = []
    real = trainer.test_gui

    def test_gui(pose, intrinsics, w, h, **kw):
        out = real(pose, intrinsics, w, h, **kw)
        frames.append((np.array(pose), np.array(intrinsics), kw, out))
        return out
    trainer.test_gui = test_gui
    return frames


def _reference_frame(jt, port, pose, intr, w, h, ds, time):
    """The JAX package's frame of the port's GUI variant at a size that the
    port's pick marches per ray: the LOD preview through its tiled
    renderer at tile 1."""
    rh, rw = h // ds, w // ds
    intr_r = np.asarray(intr, np.float32) / ds
    assert port._pick_tile(rh, rw, pose, intr_r) == 1
    occ = jt.grid_state["occ"]
    extra = ()
    if time is not None:
        t = jnp.float32(time)
        occ = occ[int(jax_time_slice(t, jt.dyn_grid_cfg))]
        extra = (t,)
    occ_m = jmd.downsample_occ(occ[0], jt.render_cfg.march_res)
    fwd, planar = jt._render_forward_fn(lod=True)
    img, _ = jfi.render_image_tiled(
        jt._infer_params(), occ_m, jnp.asarray(pose), jnp.asarray(intr_r),
        rh, rw, jt.render_cfg, fwd, jnp.ones(3), tile_px=1,
        dilate=port.opt.render_dilate, density_scale=port.opt.density_scale,
        t_thresh=port.opt.t_thresh, planar=planar, extra=extra)
    return np.asarray(img)


class _Clock:
    """The controller's time.time: every frame takes 25 ms, so the
    downscale halves after each (8, 4, 2)."""

    def __init__(self):
        self.now = 0.0

    def time(self):
        self.now += 0.0125
        return self.now


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_gui_session_frames_match_the_reference(teachers, dynamic,
                                                monkeypatch):
    """Three frames of a scripted orbit session through GUIController; the
    last one (16 px, which the pick marches per ray) against the
    reference's renderer at its camera."""
    from sealdnerf_tpu_torch.gui import controller as ctl_mod
    monkeypatch.setattr(ctl_mod.time, "time", _Clock().time)
    _, tt, jt = teachers(dynamic)
    frames = _recorded(tt)
    ctl = GUIController(_Opt(), tt)
    if dynamic:
        ctl.set_time(0.5)
    for event in (lambda: ctl.on_drag(30.0, -10.0),
                  lambda: ctl.on_scroll(0.5),
                  lambda: ctl.on_pan(12.0, -6.0)):
        event()
        img, _ = ctl.render_frame()
        assert img.shape == (32, 32, 3) and np.isfinite(img).all()
    del tt.test_gui
    assert [f[2]["downscale"] for f in frames] == [8, 4, 2]
    pose, intr, kw, out = frames[-1]
    assert not kw["need_depth"] and out["depth"] is None
    np.testing.assert_allclose(pose, ctl.cam.pose)
    time = kw.get("time")
    assert (time == 0.5) if dynamic else time is None
    ds = min((1, 2, 4, 8), key=lambda b: abs(b - kw["downscale"]))
    ref = _reference_frame(jt, tt, pose, intr, 32, 32, ds, time)
    assert out["image"].shape == ref.shape == (16, 16, 3)
    assert np.abs(out["image"] - ref).max() <= FIELD_ATOL
    assert out["image"].min() < 0.9             # the scene is in view


def _student(tt, ws):
    field = CPField(map_params(lambda t: t.detach().clone(), tt.params),
                    tt.field.cfg)
    cfg = tt.field.cfg
    field.deform_raw = lambda p, x, t: cp_dnerf_deform_raw(p, cfg, x, t)
    st = FastStudentTrainer("ngp", setup.port_options(ws, True), field, tt,
                            workspace=ws, use_checkpoint="scratch",
                            device="cpu", time_conditioned=True)
    st.adopt_grid_state(tt.grid_state)
    return st


def test_edit_session_commits_the_student(teachers, tmp_path):
    """brush -> start edit -> one pretraining frame -> one distillation
    frame (on the proxy) -> override: the teacher then renders the
    student's frame, bit for bit, not its pre-edit frame. The teacher is
    loaded from the dynamic teacher's checkpoint, so that the override
    leaves the module's teacher as it was."""
    ws, _, _ = teachers(True)
    tt = FastTrainer("ngp", setup.port_options(ws + "/teacher", True),
                     make_cp_dnerf_field(torch.Generator().manual_seed(0),
                                         CPDNeRFConfig(**setup.DYN_FIELD)),
                     workspace=ws + "/teacher", use_checkpoint="latest",
                     device="cpu", time_conditioned=True)
    assert tt.global_step == setup.TEACHER_STEPS
    train, _ = setup.scene(True)
    st = _student(tt, str(tmp_path / "student"))
    ctl = EditController(_Opt(), tt, st, train_dataset=train)
    ctl.set_time(setup.TIME_FRAME)
    ctl.downscale = 1
    ctl.set_state(EditState.BRUSH)             # frames carry depth
    img, _ = ctl.render_frame()
    depth = ctl.depth_buffer
    assert depth is not None and (depth > 0).any()
    ys, xs = np.nonzero(depth > 0)
    ctl.brush_size = 2
    for i in np.linspace(0, len(xs) - 1, 12).astype(int):
        ctl.paint(float(xs[i]), float(ys[i]))
    ctl.edit_color = [1.0, 0.1, 0.1]
    cam = (ctl.cam.pose, ctl.cam.intrinsics)

    def frame(trainer):
        return trainer.test_gui(*cam, 32, 32, downscale=1,
                                time=setup.TIME_FRAME,
                                need_depth=True)["image"]
    before = frame(tt)
    cfg = ctl.start_edit_training(pretraining_epochs=1,
                                  local_point_step=0.05,
                                  surrounding_point_step=0.1)
    assert cfg["type"] == "brush" and len(cfg["raw"]) >= 1
    assert ctl.state is EditState.TRAIN and st.time_frame == setup.TIME_FRAME
    assert np.all(ctl.proxy.times == setup.TIME_FRAME)
    ctl.train_steps = 4
    assert ctl.train_frame()["phase"] == "pretrain"
    out = ctl.train_frame()
    assert out["phase"] == "distill" and np.isfinite(out["loss"])
    ctl.override_teacher()
    assert ctl.state is EditState.PREVIEW and st.mapper is None
    after_t, after_s = frame(tt), frame(st)
    np.testing.assert_array_equal(after_t, after_s)
    assert np.abs(after_t - before).max() > 1e-3
    # the teacher's copies are its own
    assert tt.params["deform_mlp"]["w"][0] is not \
        st.params["deform_mlp"]["w"][0]
