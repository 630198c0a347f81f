"""The port's view layer (sealdnerf_tpu_torch/gui: nerf_gui, dnerf_gui,
seal_gui, seald_gui) on its headless dearpygui backend, with scripted mouse
and widget events: the three view tests of tests/test_gui_view.py re-run
against the port's views, and each view's headless item registry (tags,
labels, kinds, in order) against the JAX view's.

The stubs are the JAX test's, with what the port's controllers call beside
it: the trainer's `device`, the dataset's `device(torch_device)`, tensors
for the params and grid, `_set_params` / `adopt_grid_state` (the port's
override commits through them) and the student's `proxy_dataset` (the
port's editor distils on the edited teacher's renders). The reference's
test_pipelined_preview has no counterpart: render_image_async is tunnel
machinery that the port does not carry, so its controller renders
synchronously only.
"""

import numpy as np
import pytest
import torch

from sealdnerf_tpu.gui import headless_dpg as jdpg
from sealdnerf_tpu_torch.gui import headless_dpg as hdpg
from sealdnerf_tpu_torch.gui.edit_controller import EditState


class _Opt:
    W = H = 64
    radius = 2.0
    fovy = 60.0
    max_spp = 4


class _StubDataset:
    h = w = 64

    def __init__(self, value=0.0):
        self.images = np.full((3, 64, 64, 3), value, np.float32)

    def __len__(self):
        return 3

    def device(self, *args, **kw):
        return {"images": self.images}


class _StubTrainer:
    time_conditioned = False

    def __init__(self):
        self.device = torch.device("cpu")
        self.global_step = 0
        self.saved, self.meshed = 0, 0
        self.workspace = "/tmp/stub_ws"
        self.params = {"w": torch.zeros(4)}
        self.ema_params = {"w": torch.zeros(4)}
        self.grid_state = {"occ": torch.ones(8)}
        self.field = type("F", (), {"params": None})()
        self.mapper = None
        self.secondary_teacher = None
        self._occ_frac = None

    def test_gui(self, pose, intrinsics, w, h, bg_color=None, spp=1,
                 downscale=1, time=None, need_depth=True):
        d = h // downscale
        img = np.full((d, d, 3), 0.25, np.float32)
        dep = np.full((d, d), 2.0, np.float32) if need_depth else None
        return {"image": img, "depth": dep}

    def train_gui(self, data, h=None, w=None, step=16, **kw):
        self.global_step += step
        return {"loss": 0.5, "time": 0.01, "lr": 1e-2}

    def save_checkpoint(self, full=False):
        self.saved += 1

    def save_mesh(self):
        self.meshed += 1

    def _set_params(self, params):
        self.params = params
        self.field.params = params

    def adopt_grid_state(self, grid_state):
        self.grid_state = {k: v.clone() for k, v in grid_state.items()}


class _StubStudent(_StubTrainer):
    """Student-trainer surface the edit controller drives."""

    def __init__(self):
        super().__init__()
        self.pretraining_epochs = 1
        self.pretrained = 0
        self.init_calls = []
        self.teacher_field = None
        self.fill_mask = None

    def init_mapper(self, mapper):
        self.mapper = mapper
        self.init_calls.append("mapper")

    def init_pretraining(self, time_frame=None, epochs=1, **kw):
        self.pretraining_epochs = epochs
        self.init_calls.append(("pretrain", time_frame, epochs))

    def pretrain_one_epoch(self):
        self.pretrained += 1
        return 0.1

    def _ensure_deform_frozen(self):
        self.init_calls.append("freeze")

    def proxy_dataset(self, dataset, time=None):
        self.init_calls.append("proxy")
        return _StubDataset(0.75)


def test_nerf_gui_widgets_and_loop():
    """Build the static viewer headless, script user interactions, run the
    real render loop (nerf_gui.py render())."""
    from sealdnerf_tpu_torch.gui.nerf_gui import NeRFGUI

    tr = _StubTrainer()
    gui = NeRFGUI(_Opt(), tr, _StubDataset(), headless=True)
    assert gui.dpg is hdpg
    state = hdpg._S                       # keep a ref past destroy
    assert state.primary_window == "_primary_window"

    # widgets exist
    for tag in ("_texture", "_log_time", "_log_train", "_button_train"):
        assert hdpg.does_item_exist(tag)

    # camera events route to the controller
    p0 = gui.ctl.cam.pose.copy()
    hdpg.emit_drag(hdpg.mvMouseButton_Left, 40.0, 0.0)
    assert not np.allclose(gui.ctl.cam.pose, p0)
    r0 = gui.ctl.cam.radius
    hdpg.emit_wheel(1.0)
    assert gui.ctl.cam.radius != r0
    hdpg.emit_drag(hdpg.mvMouseButton_Middle, 5.0, 5.0)

    # fovy slider fires the callback chain
    hdpg.set_widget("fovy", 90.0)
    assert gui.ctl.cam.fovy == 90.0 and gui.ctl.need_update

    # train toggle flips controller state and relabels the button
    hdpg.click_item("_button_train")
    assert gui.ctl.training is True
    assert hdpg.get_item_label("_button_train") == "stop"

    # ckpt/mesh buttons hit the trainer
    hdpg.click_item("save ckpt")
    hdpg.click_item("save mesh")
    assert tr.saved == 1 and tr.meshed == 1

    # the real frame loop: trains, renders, updates texture + logs
    hdpg.configure(max_frames=3)
    gui.render()
    assert state.frame_count == 3
    assert tr.global_step > 0
    tex = state.items["_texture"].value
    assert isinstance(tex, np.ndarray) and tex.shape[-1] == 3
    assert "step=" in state.items["_log_train"].value
    assert gui.ctl.render_buffer is not None
    assert hdpg._S is None                # loop destroyed the context


def test_dnerf_gui_time_slider():
    from sealdnerf_tpu_torch.gui.dnerf_gui import DNeRFGUI

    tr = _StubTrainer()
    tr.time_conditioned = True
    gui = DNeRFGUI(_Opt(), tr, _StubDataset(), headless=True)
    hdpg.set_widget("time", 0.5)
    assert gui.ctl.time == 0.5 and gui.ctl.need_update
    hdpg.configure(max_frames=1)
    gui.render()


def test_seald_gui_edit_tools(monkeypatch):
    """The dynamic editor's widget wiring: tool-state buttons, brush
    painting via right-drag, eraser, undo/clear, texture/anchor inputs,
    teacher/student view toggle, start-edit + override buttons."""
    from sealdnerf_tpu_torch.gui.seald_gui import SealDGUI

    teacher, student = _StubTrainer(), _StubStudent()
    gui = SealDGUI(_Opt(), teacher, student, _StubDataset(), headless=True)
    ctl = gui.ctl
    state = hdpg._S
    assert ctl.render_trainer is teacher  # preview the teacher first

    # tool-state buttons
    hdpg.click_item("brush")
    assert ctl.state is EditState.BRUSH and ctl.need_depth
    hdpg.set_widget("brush pressure", 0.1)
    hdpg.set_widget("brush size", 2)
    assert ctl.brush_pressure == 0.1 and ctl.brush_size == 2

    # paint via the right-drag handler at the scripted mouse position
    hdpg.set_mouse_pos(30, 30)
    hdpg.emit_drag(hdpg.mvMouseButton_Right, 0.0, 0.0)
    assert ctl.brush_mask[30, 30] == 255
    # eraser checkbox routes into paint(erase=True)
    hdpg.set_value("_eraser", True)
    hdpg.emit_drag(hdpg.mvMouseButton_Right, 0.0, 0.0)
    assert ctl.brush_mask[30, 30] == 0
    hdpg.set_value("_eraser", False)
    hdpg.set_mouse_pos(32, 32)
    hdpg.emit_drag(hdpg.mvMouseButton_Right, 0.0, 0.0)
    hdpg.click_item("undo")
    assert not ctl.brush_mask.any()
    hdpg.set_mouse_pos(33, 33)
    hdpg.emit_drag(hdpg.mvMouseButton_Right, 0.0, 0.0)
    hdpg.click_item("clear")
    assert not ctl.brush_pixels

    # texture tool: right-clicks set the rect corners
    hdpg.click_item("texture")
    assert ctl.state is EditState.TEXTURE
    hdpg.set_mouse_pos(10, 10)
    hdpg.emit_click(hdpg.mvMouseButton_Right)
    hdpg.set_mouse_pos(20, 22)
    hdpg.emit_click(hdpg.mvMouseButton_Right)
    assert ctl.texture_rect == (10, 10, 20, 22)
    hdpg.set_widget("texture file", "/tmp/tex.png")
    assert ctl.texture_path == "/tmp/tex.png"

    # anchor tool: click pairs
    hdpg.click_item("anchor")
    hdpg.set_mouse_pos(40, 40)
    hdpg.emit_click(hdpg.mvMouseButton_Right)
    hdpg.set_mouse_pos(44, 40)
    hdpg.emit_click(hdpg.mvMouseButton_Right)
    assert ctl.anchors[-1] == ((40, 40), (44, 40))
    hdpg.set_widget("anchor radius", 0.2)
    assert ctl.anchor_radius == 0.2

    # color edit scales 0..255 -> 0..1
    hdpg.set_widget("edit color", (255, 0, 0, 255))
    assert ctl.edit_color == [1.0, 0.0, 0.0]

    # time slider (the SealD addition) pins the edit frame
    hdpg.set_widget("time", 0.25)
    assert ctl.time == 0.25

    # view toggle swaps between student and teacher
    hdpg.click_item("view teacher/student")
    assert ctl.render_trainer is student
    hdpg.click_item("view teacher/student")
    assert ctl.render_trainer is teacher

    # start edit: brush state again, paint, then the button drives
    # build_seal_config -> init_mapper -> init_pretraining -> the proxy
    # -> TRAIN
    monkeypatch.setattr(
        "sealdnerf_tpu_torch.editing.seal_utils.get_seal_mapper",
        lambda ws, cfg: ("mapper", cfg))
    hdpg.click_item("brush")
    for x in range(28, 36, 2):
        hdpg.set_mouse_pos(x, 30)
        hdpg.emit_drag(hdpg.mvMouseButton_Right, 0.0, 0.0)
    ctl.render_frame()                    # depth for back-projection
    hdpg.click_item("start edit")
    assert ctl.state is EditState.TRAIN
    assert student.init_calls == ["mapper", ("pretrain", None, 2),
                                  "freeze", "proxy"]

    # one pretrain frame, then override commits student -> teacher
    out = ctl.train_frame()
    assert out["phase"] == "pretrain"
    student.params = {"w": torch.full((4,), 7.0)}
    student.ema_params = {"w": torch.full((4,), 7.0)}
    student.grid_state = {"occ": torch.full((8,), 0.5)}
    hdpg.click_item("override teacher")
    assert ctl.state is EditState.PREVIEW
    np.testing.assert_allclose(teacher.params["w"].numpy(), 7.0)
    np.testing.assert_allclose(teacher.ema_params["w"].numpy(), 7.0)
    np.testing.assert_allclose(teacher.grid_state["occ"].numpy(), 0.5)
    assert teacher.params["w"] is not student.params["w"]   # copies
    assert student.mapper is None

    hdpg.configure(max_frames=1)
    gui.render()
    assert state.frame_count == 1


def _registry(dpg):
    """(tag, label, kind) of every item of a freshly built view, in
    creation order, and its handlers' kinds and buttons."""
    state = dpg._S
    items = [(it.tag, it.label, it.kind) for it in state.items.values()]
    handlers = [(h.kind, h.config.get("button")) for h in state.handlers]
    dpg.destroy_context()
    return items, handlers


@pytest.mark.parametrize("view", ["nerf_gui.NeRFGUI", "dnerf_gui.DNeRFGUI",
                                  "seal_gui.SealGUI", "seald_gui.SealDGUI"])
def test_view_registry_matches_the_reference(view):
    """The same widgets, tags, labels and handlers as the JAX view."""
    import importlib
    mod, cls = view.split(".")
    regs = []
    for pkg, dpg in (("sealdnerf_tpu_torch", hdpg), ("sealdnerf_tpu", jdpg)):
        klass = getattr(importlib.import_module(f"{pkg}.gui.{mod}"), cls)
        if cls.startswith("Seal"):
            klass(_Opt(), _StubTrainer(), _StubStudent(), _StubDataset(),
                  headless=True)
        else:
            klass(_Opt(), _StubTrainer(), _StubDataset(), headless=True)
        regs.append(_registry(dpg))
    assert regs[0] == regs[1]
    assert len(regs[0][0]) > 8


@pytest.mark.parametrize("pkg", ["sealdnerf_tpu_torch", "sealdnerf_tpu"])
def test_seald_gui_loop_runs_through_pretraining(pkg, monkeypatch):
    """The editor's own frame loop after "start edit": the port's logs the
    pretraining frames and goes on to distil; the reference's raises
    KeyError 'time' at its first pretraining frame (its pretraining frames
    report no seconds, which the loop's log line reads)."""
    import importlib
    dpg = importlib.import_module(f"{pkg}.gui.headless_dpg")
    SealDGUI = importlib.import_module(f"{pkg}.gui.seald_gui").SealDGUI
    monkeypatch.setattr(f"{pkg}.editing.seal_utils.get_seal_mapper",
                        lambda ws, cfg: ("mapper", cfg))
    student = _StubStudent()
    gui = SealDGUI(_Opt(), _StubTrainer(), student, _StubDataset(),
                   headless=True)
    state = dpg._S
    dpg.click_item("brush")
    dpg.set_mouse_pos(30, 30)
    dpg.emit_drag(dpg.mvMouseButton_Right, 0.0, 0.0)
    gui.ctl.render_frame()
    dpg.click_item("start edit")
    dpg.configure(max_frames=4)
    if pkg == "sealdnerf_tpu":
        with pytest.raises(KeyError, match="time"):
            gui.render()
        assert student.pretrained == 1
        return
    gui.render()
    assert state.frame_count == 4 and student.pretrained == 2
    assert student.global_step > 0                 # two distillation frames
    assert "loss=" in state.items["_log_train"].value
