"""Edit-tool state machine for the Seal editors, headless (port of
sealdnerf_tpu/gui/edit_controller.py, on the port's student trainers).

Parity with reference SealNeRF/gui.py:97-1241 and SealDNeRF/gui.py:62-986:
states PREVIEW / BRUSH / TEXTURE / ANCHOR / TRAIN; the brush paints a 2D mask
that is back-projected through the rendered depth into 3D stroke points; the
texture tool selects a screen rect + image file; anchors are placed as
(start, drag) pixel pairs. "Start training" converts the active tool state
into a seal config dict, initializes the teacher mapper + student
pretraining, and enters TRAIN; "override" commits the student weights into
the teacher (SealDNeRF/gui.py:408-424).

One fault of the reference is not carried over: its distillation frames
train the student on the raw training images (the controller's data, as
StudentTrainer has no train_gui of its own), which pulls the student back to
the unedited scene, while StudentTrainer.train distils on the edited
teacher's renders. Here the distillation frames train on
proxy_dataset(train_dataset) at the edit's time, made once when the edit
starts, as the student's train() does. And a pretraining frame reports its
seconds as a distillation frame does: the viewer's frame loop logs both,
and the reference's loop raises KeyError 'time' at its first pretraining
frame.
"""

import enum
import time
from typing import Optional

import numpy as np

from ..models.params import map_params
from .controller import GUIController


class EditState(enum.Enum):
    PREVIEW = 0
    BRUSH = 1
    TEXTURE = 2
    ANCHOR = 3
    TRAIN = 4


class EditController(GUIController):
    def __init__(self, opt, teacher_trainer, student_trainer,
                 train_dataset=None):
        super().__init__(opt, student_trainer, train_dataset,
                         teacher_trainer=teacher_trainer)
        self.render_trainer = teacher_trainer  # preview the teacher first
        self.state = EditState.PREVIEW
        self.brush_pixels = []        # list of (x, y) stroke centers
        self._brush_mask = None       # lazy [H, W] uint8 mask texture
        self._stroke_log = []         # (x, y, r, erase) for undo replay
        self.brush_size = 4           # stamp radius in pixels
        self.brush_pressure = 0.05
        self.brush_depth = 1.0
        self.attenuation_distance = 0.02
        self.attenuation_mode = "linear"
        self.texture_rect = None      # (x0, y0, x1, y1)
        self.texture_path = None
        self.anchors = []             # list of ((x0,y0), (x1,y1))
        self.anchor_radius = 0.1
        self.edit_color: Optional[list] = None  # rgb for brush recolor
        self.proxy = None             # the edited teacher's training set

    # ------------------------------------------------------------------- tools
    def set_state(self, state: EditState):
        self.state = state
        # paint tools back-project strokes through the rendered depth, so
        # their preview frames must carry the depth plane (controller
        # renders depth on demand otherwise)
        self.need_depth = state in (EditState.BRUSH, EditState.TEXTURE,
                                    EditState.ANCHOR)

    @property
    def brush_mask(self):
        """2-D brush mask [H, W] uint8, the reference editor's mask texture
        (SealDNeRF/gui.py brush painting; created lazily)."""
        if getattr(self, "_brush_mask", None) is None:
            self._brush_mask = np.zeros((self.opt.H, self.opt.W), np.uint8)
        return self._brush_mask

    def _stamp(self, xi: int, yi: int, r: int, erase: bool):
        """Write one disk stamp into the mask; returns True if in-frame.
        Shared by live painting and undo replay so the two can never
        diverge."""
        h, w = self.opt.H, self.opt.W
        y0, y1 = max(yi - r, 0), min(yi + r + 1, h)
        x0, x1 = max(xi - r, 0), min(xi + r + 1, w)
        if y0 >= y1 or x0 >= x1:
            return False
        yy, xx = np.mgrid[y0:y1, x0:x1]
        disk = (yy - yi) ** 2 + (xx - xi) ** 2 <= r * r
        self.brush_mask[y0:y1, x0:x1][disk] = 0 if erase else 255
        if erase:
            # prune stroke centers inside the erase DISK (not its
            # bounding square)
            self.brush_pixels = [
                p for p in self.brush_pixels
                if (p[0] - xi) ** 2 + (p[1] - yi) ** 2 > r * r]
        return True

    def paint(self, x: float, y: float, erase: bool = False):
        """Stamp a brush_size-radius disk into the 2-D mask (reference
        paints disks into its mask texture, not single pixels); erase=True
        removes. Also tracks the stroke pixel list for back-projection."""
        if self.state is not EditState.BRUSH:
            return
        r = max(int(round(getattr(self, "brush_size", 4))), 1)
        xi, yi = int(round(x)), int(round(y))
        if not self._stamp(xi, yi, r, erase):
            return
        if not erase:
            self.brush_pixels.append((x, y))
        self._stroke_log = getattr(self, "_stroke_log", [])
        self._stroke_log.append((xi, yi, r, erase))

    def undo_stroke(self):
        """Remove the last stroke stamp (reference editor's undo)."""
        log = getattr(self, "_stroke_log", [])
        if not log:
            if self.anchors:
                self.anchors.pop()
            return
        log.pop()
        self._brush_mask = None
        self.brush_pixels = []
        for (xi, yi, r, erase) in log:
            if self._stamp(xi, yi, r, erase) and not erase:
                self.brush_pixels.append((float(xi), float(yi)))

    def clear_tool(self):
        """Reset the active tool's state (reference 'clear' button)."""
        self.brush_pixels = []
        self._brush_mask = None
        self._stroke_log = []
        self.texture_rect = None
        self.anchors = []

    def display_frame(self, img: np.ndarray) -> np.ndarray:
        """Blend tool overlays into the preview frame: red half-alpha brush
        mask, texture rect outline, anchor arrows (the reference editor
        draws these into its displayed texture)."""
        out = img
        if getattr(self, "_brush_mask", None) is not None and \
                self._brush_mask.any():
            out = out.copy()
            m = self._brush_mask[:out.shape[0], :out.shape[1]] > 0
            out[m] = 0.5 * out[m] + 0.5 * np.array([1.0, 0.1, 0.1])
        if self.texture_rect is not None:
            out = out.copy() if out is img else out
            x0, y0, x1, y1 = [int(round(v)) for v in self.texture_rect]
            x0, x1 = sorted((max(x0, 0), min(x1, out.shape[1] - 1)))
            y0, y1 = sorted((max(y0, 0), min(y1, out.shape[0] - 1)))
            out[y0:y1 + 1, [x0, x1]] = [0.1, 1.0, 0.1]
            out[[y0, y1], x0:x1 + 1] = [0.1, 1.0, 0.1]
        for (start, end) in self.anchors:
            out = out.copy() if out is img else out
            for p, col in ((start, [1.0, 1.0, 0.1]), (end, [0.1, 0.5, 1.0])):
                if p is None:
                    continue
                xi = int(round(p[0])); yi = int(round(p[1]))
                y0, y1 = max(yi - 2, 0), min(yi + 3, out.shape[0])
                x0, x1 = max(xi - 2, 0), min(xi + 3, out.shape[1])
                out[y0:y1, x0:x1] = col
        return out

    def set_secondary_teacher(self, field):
        """Attach a secondary teacher (its density/color replace the edit
        region's source, main_SealNeRF.py:141-149 / reference gui combo)."""
        self.trainer.secondary_teacher = field
        if self.trainer.mapper is not None:
            self.trainer.init_mapper(self.trainer.mapper)  # rewrap teacher

    def load_secondary_teacher(self, workspace: str):
        """Load the latest checkpoint of `workspace` as the secondary
        teacher (main_SealNeRF.py:141-149 merge flow, bound to the editor):
        a field of the active teacher's family, seeded from torch.Generator
        0, then the checkpoint's params. A workspace without one is
        ignored."""
        import copy

        import torch

        from ..train.checkpoint import resolve_checkpoint
        path = resolve_checkpoint(workspace, "ngp", "latest")
        if path is None:
            return
        # build a field of the SAME family as the active teacher (the
        # editor may run on the CP kernels or on the Instant-NGP / D-NeRF
        # fields)
        tt = self.teacher_trainer
        tcfg = tt.field.cfg
        gen = torch.Generator().manual_seed(0)
        from ..models.cp import (CPConfig, CPDNeRFConfig,
                                 make_cp_dnerf_field, make_cp_field)
        if isinstance(tcfg, CPDNeRFConfig):
            field = make_cp_dnerf_field(gen, tcfg, tt.device)
        elif isinstance(tcfg, CPConfig):
            field = make_cp_field(gen, tcfg, tt.device)
        else:
            from ..models.api import make_dnerf_field, make_ngp_field
            from ..models.dnerf import DNeRFConfig
            make = make_dnerf_field if isinstance(tcfg, DNeRFConfig) \
                else make_ngp_field
            field = make(gen, tcfg, tt.device)
        probe = copy.copy(tt)
        probe.field = field
        probe.params = field.params
        probe.load_checkpoint(path, model_only=True)
        field.params = probe.params
        self.set_secondary_teacher(field)

    def set_texture(self, rect, path):
        self.texture_rect = rect
        self.texture_path = path

    def add_anchor(self, start, end):
        self.anchors.append((start, end))

    def on_click(self, x: float, y: float):
        """A right click at (x, y): a corner of the texture rect (the first
        click opens it, the next ones move its far corner), or an anchor's
        start, then its end."""
        if self.state is EditState.TEXTURE:
            if self.texture_rect is None:
                self.texture_rect = (x, y, x, y)
            else:
                self.texture_rect = self.texture_rect[:2] + (x, y)
        if self.state is EditState.ANCHOR:
            if not self.anchors or self.anchors[-1][1] is not None:
                self.anchors.append(((x, y), None))
            else:
                self.anchors[-1] = (self.anchors[-1][0], (x, y))

    def toggle_view(self):
        """Render the teacher or the student, whichever is not shown."""
        self.render_trainer = self.teacher_trainer \
            if self.render_trainer is self.trainer else self.trainer

    # -------------------------------------------------------- config conversion
    def build_seal_config(self) -> dict:
        """Active tool state -> seal config dict
        (SealDNeRF/gui.py:364-371)."""
        if self.state is EditState.BRUSH and self.brush_pixels:
            if getattr(self, "_brush_mask", None) is not None and \
                    self._brush_mask.any():
                # back-project the painted MASK pixels (reference
                # get_mask_pos over the mask texture), subsampled
                ys, xs = np.nonzero(self._brush_mask)
                px = np.stack([xs, ys], -1).astype(np.float32)
                if len(px) > 1024:
                    px = px[np.linspace(0, len(px) - 1, 1024).astype(int)]
            else:
                px = np.asarray(self.brush_pixels, dtype=np.float32)
            pts, mask = self.back_project(px)
            cfg = {
                "type": "brush",
                "raw": pts[mask].tolist(),
                "brushType": "line",
                "brushDepth": self.brush_depth,
                "brushPressure": self.brush_pressure,
                "attenuationDistance": self.attenuation_distance,
                "attenuationMode": self.attenuation_mode,
            }
            if self.edit_color is not None:
                cfg["rgb"] = list(self.edit_color)
            return cfg
        if self.state is EditState.TEXTURE and self.texture_rect is not None:
            x0, y0, x1, y1 = self.texture_rect
            xs = np.linspace(x0, x1, 16)
            ys = np.linspace(y0, y1, 16)
            gx, gy = np.meshgrid(xs, ys)
            px = np.stack([gx.ravel(), gy.ravel()], axis=-1)
            pts, mask = self.back_project(px)
            corners, cmask = self.back_project(
                np.array([[x0, y0], [x1, y0], [x0, y1]], dtype=np.float32))
            return {
                "type": "brush",
                "raw": pts[mask].tolist(),
                "brushType": "line",
                "brushDepth": self.brush_depth,
                "brushPressure": 1e-3,
                "attenuationDistance": 1e-3,
                "attenuationMode": "dry",
                "imageConfig": {
                    "path": self.texture_path,
                    "o": corners[0].tolist(),
                    "w": corners[1].tolist(),
                    "h": corners[2].tolist(),
                },
            }
        if self.state is EditState.ANCHOR and self.anchors \
                and self.anchors[-1][1] is not None:
            # a single click leaves ((x, y), None): wait for the drag end
            # before building a config
            start, end = self.anchors[-1]
            p, m = self.back_project(
                np.asarray([start, end], dtype=np.float32))
            # plane points: small disk of back-projections around the start
            ring = np.asarray(start, dtype=np.float32) + \
                8.0 * np.stack([np.cos(np.linspace(0, 2 * np.pi, 12)),
                                np.sin(np.linspace(0, 2 * np.pi, 12))], -1)
            rp, rm = self.back_project(ring.astype(np.float32))
            return {
                "type": "anchor",
                "raw": rp[rm].tolist(),
                "translation": (p[1] - p[0]).tolist(),
                "radius": self.anchor_radius,
                "scale": [1.0, 1.0, 1.0],
            }
        return None  # incomplete tool state: nothing to train yet

    # ---------------------------------------------------------------- training
    def start_edit_training(self, pretraining_epochs=2, **pretrain_kw):
        """Convert tool state -> mapper, init student pretraining, proxy the
        training set through the edited teacher at the edit's time, TRAIN
        (SealDNeRF/gui.py:349-402)."""
        from ..editing.seal_utils import get_seal_mapper
        cfg = self.build_seal_config()
        if cfg is None:
            return None
        st = self.trainer
        mapper = get_seal_mapper(st.workspace, cfg)
        st.init_mapper(mapper)
        kw = dict(local_point_step=0.01, surrounding_point_step=0.02,
                  global_point_step=-1)
        kw.update(pretrain_kw)
        st.init_pretraining(
            time_frame=self.time if getattr(
                st, "time_conditioned", False) else None,
            epochs=pretraining_epochs, **kw)
        if self.train_dataset is not None:
            # the distillation frames' data: the edited teacher's renders
            # (StudentTrainer.train's proxy), not the raw images
            st._ensure_deform_frozen()
            self.proxy = st.proxy_dataset(self.train_dataset)
            self._data_dev = self.proxy.device(st.device)
        self.render_trainer = st  # watch the student learn
        self.state = EditState.TRAIN
        self.training = True
        self._pretrain_done = 0
        return cfg

    def train_frame(self):
        if self.state is not EditState.TRAIN:
            return None
        st = self.trainer
        if self._pretrain_done < st.pretraining_epochs:
            t0 = time.time()
            loss = st.pretrain_one_epoch()
            self._pretrain_done += 1
            self.need_update = True
            return {"loss": loss, "phase": "pretrain",
                    "time": time.time() - t0}
        out = super().train_frame()
        if out is not None:
            out["phase"] = "distill"
        return out

    def override_teacher(self):
        """Commit the edit: copy the student's params, EMA and occupancy
        grid state into the teacher, drop every cache that the teacher's
        next frame would otherwise read stale, then drop the mapper. The
        reference's load_state_dict carries the density_grid/bitfield
        buffers along with the weights (SealDNeRF/gui.py:409-410); without
        the grid handover the teacher keeps a pre-edit grid and culls
        geometry the edit added in previously-empty cells.

        The caches: the packed kernel tables of the teacher's field, the
        annealed inference params, the occupied share of the grid and the
        march occupancy (FastTrainer), and the host copies of a dynamic
        grid's counters. The committed weights are the student's, which
        trained without the coarse-to-fine anneal, so the teacher renders
        them unannealed, as the student does."""
        tt, st = self.teacher_trainer, self.trainer
        tt._set_params(map_params(lambda t: t.detach().clone(), st.params))
        tt.ema_params = None if st.ema_params is None else map_params(
            lambda t: t.detach().clone(), st.ema_params)
        if hasattr(tt.field, "_tables"):
            tt.field._tables.clear()
        if hasattr(tt, "_infer_cache"):
            tt._infer_cache = None
            tt._anneal_mask = None
        # a copy of the grid; FastTrainer's also recomputes the march
        # occupancy, and the grid_state setter forgets the occupied share
        tt.adopt_grid_state(st.grid_state)
        st.mapper = None
        st.teacher_field = None
        st.fill_mask = None
        if getattr(st, "_occ_m", None) is not None:
            st._occ_m = st._march_occ()     # without the edit's fill
        self.state = EditState.PREVIEW
        self.training = False
        self.need_update = True
