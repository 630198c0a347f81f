"""The port's headless GUI controllers (sealdnerf_tpu_torch/gui: orbit.py,
controller.py, edit_controller.py) against the JAX package's, with the same
scripted events and stub trainers through both.

Tolerances:
- OrbitCamera pose and intrinsics after the same event script: 1e-6;
- the pacing decisions (downscale, spp, train_steps) under scripted frame
  and step times: equal to the JAX controller's synchronous path (stubs
  without render_image_async take it);
- back_project of the same depth buffer: 1e-5;
- build_seal_config for the same brush / texture / anchor state: 1e-5, and
  the two packages' get_seal_mapper of those configs map the same probe
  points within 1e-5 (as tests/test_torch_edit_mappers.py holds mappers);
- the brush mask's paint / erase / undo: equal.

The reference's edit distillation frames train on the raw training images;
the port's on the edited teacher's renders (edit_controller.py's docstring).
test_edit_distillation_trains_on_the_proxy runs both controllers on stub
students and pins that.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sealdnerf_tpu.editing import seal_utils as jseal
from sealdnerf_tpu.gui import controller as jctl_mod
from sealdnerf_tpu.gui.controller import GUIController as JaxController
from sealdnerf_tpu.gui.edit_controller import EditController as JaxEdit
from sealdnerf_tpu.gui.edit_controller import EditState as JaxState
from sealdnerf_tpu.gui.orbit import OrbitCamera as JaxOrbit
from sealdnerf_tpu_torch.editing import seal_utils as tseal
from sealdnerf_tpu_torch.gui import controller as tctl_mod
from sealdnerf_tpu_torch.gui.controller import GUIController
from sealdnerf_tpu_torch.gui.edit_controller import EditController, EditState
from sealdnerf_tpu_torch.gui.orbit import OrbitCamera
from sealdnerf_tpu_torch.utils.png import write_png

TOL = dict(rtol=0, atol=1e-5)

# drag, wheel, pan: the viewer's three mouse events, in a scripted order
EVENTS = [("orbit", (40.0, 0.0)), ("orbit", (-12.5, 33.0)), ("scale", (1.0,)),
          ("pan", (5.0, -7.0)), ("orbit", (3.0, 91.0)), ("scale", (-2.5,)),
          ("pan", (-20.0, 4.0, 1.5))]


class _Opt:
    W, H = 64, 48
    radius = 2.0
    fovy = 60.0
    max_spp = 4


def _depth(h, w):
    """A smooth depth buffer around 2 (the camera's distance to the
    origin), zero in one corner (background)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = 1.8 + 0.2 * np.sin(xx / w * 3.0) + 0.15 * np.cos(yy / h * 2.0)
    d[: h // 6, : w // 6] = 0.0
    return d.astype(np.float32)


class _Clock:
    """time.time of both controller modules: advanced by the stubs."""

    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now


class _StubTrainer:
    """test_gui and train_gui with scripted durations; the signature
    serves both packages' controllers."""

    def __init__(self, clock, frame_s, step_s, time_conditioned=False):
        self.clock, self.frame_s, self.step_s = clock, list(frame_s), step_s
        self.time_conditioned = time_conditioned
        self.device = torch.device("cpu")
        self.calls = []
        self.global_step = 0

    def test_gui(self, pose, intrinsics, w, h, bg_color=None, spp=1,
                 downscale=1, time=None, need_depth=True):
        self.calls.append(("frame", downscale, spp, need_depth, time))
        self.clock.now += self.frame_s.pop(0) if self.frame_s else 0.01
        rh, rw = h // downscale, w // downscale
        img = np.full((rh, rw, 3), 0.1 * len(self.calls), np.float32)
        return {"image": img,
                "depth": _depth(rh, rw) if need_depth else None}

    def train_gui(self, data, h=None, w=None, step=16, **kw):
        self.calls.append(("train", step, h, w))
        self.global_step += step
        return {"loss": 0.5, "lr": 1e-2, "time": self.step_s * step}


class _StubDataset:
    h, w = 48, 64

    def __init__(self, images=None):
        self.images = np.zeros((3, 48, 64, 3), np.float32) \
            if images is None else images

    def __len__(self):
        return len(self.images)

    def device(self, *args, **kw):
        return {"images": self.images}


def test_orbit_camera_matches():
    cams = (OrbitCamera(640, 480, r=2.5, fovy=55.0),
            JaxOrbit(640, 480, r=2.5, fovy=55.0))
    for name, args in EVENTS:
        for cam in cams:
            getattr(cam, name)(*args)
        np.testing.assert_allclose(cams[0].pose, cams[1].pose, rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(cams[0].intrinsics, cams[1].intrinsics,
                               rtol=0, atol=1e-6)
    assert cams[0].radius == pytest.approx(cams[1].radius, abs=1e-6)
    assert not np.allclose(cams[0].pose, np.asarray(
        OrbitCamera(640, 480, r=2.5).pose))


# frame seconds: slow frames raise the downscale, fast ones lower it; the
# step seconds move train_steps away from 16
FRAMES = [0.30, 0.30, 0.02, 0.02, 0.02, 0.05, 0.40, 0.01, 0.01, 0.01,
          0.01, 0.01, 0.2, 0.06, 0.03]


@pytest.mark.parametrize("step_s", [0.005, 0.05, 0.2])
def test_pacing_decisions_match(monkeypatch, step_s):
    """The same script through both controllers: train frames, renders,
    camera events and a time change; after every call the downscale, spp,
    train_steps, need_update and what the trainer was asked are equal."""
    clock = _Clock()
    monkeypatch.setattr(jctl_mod.time, "time", clock.time)
    monkeypatch.setattr(tctl_mod.time, "time", clock.time)
    stubs = [_StubTrainer(clock, FRAMES, step_s, time_conditioned=True)
             for _ in range(2)]
    ctls = [GUIController(_Opt(), stubs[0], _StubDataset()),
            JaxController(_Opt(), stubs[1], _StubDataset())]
    for c in ctls:
        c.training = True
    script = ["train", "render", "render", "render", "drag", "render",
              "train", "render", "render", "render", "time", "render",
              "render", "render", "render", "train", "render", "wheel",
              "render", "render", "train", "render", "render", "render"]
    for i, act in enumerate(script):
        outs = []
        for c in ctls:
            if act == "train":
                outs.append(c.train_frame()["loss"])
            elif act == "render":
                img, dt = c.render_frame()
                outs.append((img.shape, round(dt, 9),
                             None if img is None else float(img.mean())))
            elif act == "drag":
                c.on_drag(10.0, -4.0)
            elif act == "wheel":
                c.on_scroll(0.5)
            else:
                c.set_time(0.3 + 0.05 * i)
        if outs:
            assert outs[0] == outs[1], (i, act)
        a, b = ctls
        assert (a.downscale, a.spp, a.train_steps, a.need_update) == \
            (b.downscale, b.spp, b.train_steps, b.need_update), (i, act)
    assert stubs[0].calls == stubs[1].calls
    seen = {c[1] for c in stubs[0].calls if c[0] == "frame"}
    assert len(seen) > 1                       # the downscale moved
    assert ctls[0].train_steps != 16 or step_s == 0.005


def test_back_project_matches():
    clock = _Clock()
    ctls = [GUIController(_Opt(), _StubTrainer(clock, [], 0.01)),
            JaxController(_Opt(), _StubTrainer(clock, [], 0.01))]
    rng = np.random.default_rng(3)
    px = np.concatenate([rng.uniform(0, 64, (200, 1)),
                         rng.uniform(0, 48, (200, 1))], 1)
    for c in ctls:
        for name, args in EVENTS[:4]:
            getattr(c.cam, name)(*args)
        c.downscale = 2
    got = ctls[0].back_project(px)
    ref = ctls[1].back_project(px)
    np.testing.assert_allclose(got[0], ref[0], **TOL)
    np.testing.assert_array_equal(got[1], ref[1])
    assert 0 < got[1].sum() < len(px)          # the corner is background


def _paint_session(ctl, state_cls):
    ctl.set_state(state_cls.BRUSH)
    ctl.brush_size = 3
    for x, y in ((20, 20), (24, 21), (30, 30), (40, 33), (50, 40)):
        ctl.paint(float(x), float(y))
    ctl.paint(40.0, 33.0, erase=True)
    ctl.paint(10.0, 30.0)
    ctl.undo_stroke()
    ctl.paint(33.0, 12.0)


def _edit_pair(clock=None):
    clock = clock or _Clock()
    return [EditController(_Opt(), _StubTrainer(clock, [], 0.01),
                           _StubTrainer(clock, [], 0.01)),
            JaxEdit(_Opt(), _StubTrainer(clock, [], 0.01),
                    _StubTrainer(clock, [], 0.01))]


def test_brush_mask_paint_erase_undo_match():
    ctls = _edit_pair()
    _paint_session(ctls[0], EditState)
    _paint_session(ctls[1], JaxState)
    np.testing.assert_array_equal(ctls[0].brush_mask, ctls[1].brush_mask)
    assert ctls[0].brush_pixels == ctls[1].brush_pixels
    assert ctls[0]._stroke_log == ctls[1]._stroke_log
    assert ctls[0].brush_mask[20, 20] == 255
    assert ctls[0].brush_mask[33, 40] == 0     # erased
    assert ctls[0].brush_mask[30, 10] == 0     # undone
    img = np.full((48, 64, 3), 0.2, np.float32)
    for c in ctls:
        c.texture_rect = (2, 2, 12, 9)
        c.anchors = [((50.0, 30.0), (55.0, 35.0))]
    np.testing.assert_array_equal(ctls[0].display_frame(img),
                                  ctls[1].display_frame(img))
    for c in ctls:
        c.clear_tool()
    assert not ctls[0].brush_pixels and not ctls[0].brush_mask.any()


def _configs(ctls, states, tex_path):
    """Brush, texture and anchor configs of the same tool state in both
    controllers."""
    out = []
    for c, st in zip(ctls, states):
        for name, args in EVENTS[:3]:
            getattr(c.cam, name)(*args)
        c.downscale = 2
        _paint_session(c, st)
        c.edit_color = [0.9, 0.1, 0.2]
        brush = c.build_seal_config()
        c.set_state(st.TEXTURE)
        c.set_texture((14.0, 10.0, 50.0, 40.0), tex_path)
        texture = c.build_seal_config()
        c.set_state(st.ANCHOR)
        c.add_anchor((30.0, 24.0), None)
        assert c.build_seal_config() is None   # a click without its drag
        c.anchors[-1] = ((30.0, 24.0), (38.0, 20.0))
        anchor = c.build_seal_config()
        out.append({"brush": brush, "texture": texture, "anchor": anchor})
    return out


def _assert_same_config(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            _assert_same_config(got[k], v)
        elif isinstance(v, (list, tuple)) and v and \
                not isinstance(v[0], str):
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(v, np.float64), **TOL,
                                       err_msg=k)
        else:
            assert got[k] == v, k


def test_seal_configs_and_their_mappers_match(tmp_path):
    rng = np.random.default_rng(5)
    img = (rng.random((6, 5, 4)) * 255).astype(np.uint8)
    tex = os.path.join(str(tmp_path), "tex.png")
    write_png(tex, img)
    got, ref = _configs(_edit_pair(), (EditState, JaxState), tex)
    for kind in ("brush", "texture", "anchor"):
        _assert_same_config(got[kind], ref[kind])
        assert len(ref[kind]["raw"]) >= 4, kind
    assert ref["brush"]["rgb"] == [0.9, 0.1, 0.2]
    # the mappers of the configs map the same probe points
    for kind in ("brush", "texture", "anchor"):
        mt = tseal.get_seal_mapper(str(tmp_path / "t"), got[kind])
        mj = jseal.get_seal_mapper(str(tmp_path / "j"), ref[kind])
        raw = np.asarray(ref[kind]["raw"], np.float32)
        prng = np.random.default_rng(11)
        pts = np.concatenate([
            raw[prng.integers(0, len(raw), 600)]
            + prng.normal(scale=0.05, size=(600, 3)),
            prng.uniform(-1, 1, (400, 3))]).astype(np.float32)
        dirs = prng.normal(size=pts.shape).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        xj, dj, mj_ = mj.map_to_origin(jnp.asarray(pts), jnp.asarray(dirs))
        xt, dt, mt_ = mt.map_to_origin(torch.from_numpy(pts),
                                       torch.from_numpy(dirs))
        mask = np.asarray(mj_)
        # points within float noise of the edit's faces may fall either
        # side: compare where both agree on the mask, which is nearly all
        agree = mt_.numpy() == mask
        assert agree.mean() > 0.99, kind
        assert mask.sum() > 0, kind
        np.testing.assert_allclose(xt.numpy()[agree], np.asarray(xj)[agree],
                                   **TOL)
        np.testing.assert_allclose(dt.numpy()[agree], np.asarray(dj)[agree],
                                   **TOL)


class _StubStudent(_StubTrainer):
    """The student surface of both packages' edit controllers; the port's
    also proxies the training set (rendered images of value 0.75)."""

    def __init__(self, clock):
        super().__init__(clock, [], 0.01)
        self.workspace = "/nonexistent"
        self.pretraining_epochs = 0
        self.mapper = None
        self.data_seen = []
        self.proxied = 0

    def init_mapper(self, mapper):
        self.mapper = mapper

    def init_pretraining(self, time_frame=None, epochs=1, **kw):
        self.pretraining_epochs = epochs
        self.time_frame = time_frame

    def pretrain_one_epoch(self):
        return 0.1

    def _ensure_deform_frozen(self):
        pass

    def proxy_dataset(self, dataset, time=None):
        self.proxied += 1
        return _StubDataset(np.full_like(dataset.images, 0.75))

    def train_gui(self, data, h=None, w=None, step=16, **kw):
        self.data_seen.append(float(np.mean(data["images"])))
        return super().train_gui(data, h=h, w=w, step=step)


def test_edit_distillation_trains_on_the_proxy(monkeypatch):
    """After pretraining, the reference's editor trains the student on the
    raw images (0.25 here), the port's on the edited teacher's renders
    (0.75), proxied once when the edit starts."""
    monkeypatch.setattr(jseal, "get_seal_mapper", lambda ws, cfg: "mapper")
    monkeypatch.setattr(tseal, "get_seal_mapper", lambda ws, cfg: "mapper")
    clock = _Clock()
    raw = np.full((3, 48, 64, 3), 0.25, np.float32)
    seen = []
    for cls, state in ((EditController, EditState), (JaxEdit, JaxState)):
        st = _StubStudent(clock)
        ctl = cls(_Opt(), _StubTrainer(clock, [], 0.01), st,
                  _StubDataset(raw))
        ctl.render_frame()
        ctl.set_state(state.BRUSH)
        ctl.paint(30.0, 30.0)
        assert ctl.start_edit_training(pretraining_epochs=1) is not None
        assert ctl.train_frame()["phase"] == "pretrain"
        for _ in range(2):
            assert ctl.train_frame()["phase"] == "distill"
        seen.append((st.data_seen, st.proxied))
    assert seen[0] == ([0.75, 0.75], 1)       # the port: the proxy
    assert seen[1] == ([0.25, 0.25], 0)       # the reference: raw images
