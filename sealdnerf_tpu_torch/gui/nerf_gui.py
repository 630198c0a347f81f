"""dearpygui viewer for static NeRF (port of sealdnerf_tpu/gui/nerf_gui.py,
the reference viewer's nerf/gui.py:55-435).

Thin widget shell over gui.controller.GUIController, which it changes only
through the controller's methods and attribute sets (on a data mesh they
reach every rank: gui/follow.py). Uses real dearpygui when installed;
otherwise falls back to gui.headless_dpg (the same API without a display),
so the view layer runs -- and is scriptable -- on display-less hosts
(remote GPU machines, CI).
"""

import sys

import numpy as np

from .controller import GUIController


def _require_dpg(headless: bool = False):
    if not headless:
        try:
            import dearpygui.dearpygui as dpg
            return dpg
        except ImportError:
            print("[gui] dearpygui not installed; using the headless "
                  "backend (sealdnerf_tpu_torch.gui.headless_dpg)",
                  file=sys.stderr)
    from . import headless_dpg
    return headless_dpg


class NeRFGUI:
    def __init__(self, opt, trainer, train_dataset=None, controller=None,
                 headless=False):
        self.dpg = _require_dpg(headless)
        self.opt = opt
        self.ctl = controller or GUIController(opt, trainer, train_dataset)
        self.ctl.training = False
        self._build()

    # ------------------------------------------------------------------ layout
    def _build(self):
        dpg = self.dpg
        dpg.create_context()
        with dpg.texture_registry(show=False):
            dpg.add_raw_texture(self.opt.W, self.opt.H,
                                np.zeros((self.opt.H, self.opt.W, 3),
                                         dtype=np.float32),
                                format=dpg.mvFormat_Float_rgb,
                                tag="_texture")
        with dpg.window(tag="_primary_window", width=self.opt.W,
                        height=self.opt.H):
            dpg.add_image("_texture")
        with dpg.window(label="Control", tag="_control_window", width=400,
                        height=300):
            dpg.add_text("", tag="_log_time")
            dpg.add_text("", tag="_log_train")
            if self.ctl.train_dataset is not None:
                def toggle(sender, app_data):
                    dpg.set_item_label("_button_train",
                                       "stop" if self.ctl.toggle_training()
                                       else "start")
                dpg.add_button(label="start", tag="_button_train",
                               callback=toggle)
                dpg.add_button(label="save ckpt",
                               callback=lambda: self.ctl.save_checkpoint())
                dpg.add_button(label="save mesh",
                               callback=lambda: self.ctl.save_mesh())
            dpg.add_slider_float(
                label="fovy", default_value=self.ctl.cam.fovy, min_value=1,
                max_value=120, callback=lambda s, a: self.ctl.set_fovy(a))
            self._extra_widgets(dpg)

        with dpg.handler_registry():
            dpg.add_mouse_drag_handler(
                button=dpg.mvMouseButton_Left,
                callback=lambda s, a: self.ctl.on_drag(a[1], a[2]))
            dpg.add_mouse_wheel_handler(
                callback=lambda s, a: self.ctl.on_scroll(a))
            dpg.add_mouse_drag_handler(
                button=dpg.mvMouseButton_Middle,
                callback=lambda s, a: self.ctl.on_pan(a[1], a[2]))

        dpg.create_viewport(title="sealdnerf-tpu-torch", width=self.opt.W,
                            height=self.opt.H, resizable=False)
        dpg.setup_dearpygui()
        dpg.show_viewport()
        dpg.set_primary_window("_primary_window", True)

    def _extra_widgets(self, dpg):
        pass

    # -------------------------------------------------------------------- loop
    def render(self):
        dpg = self.dpg
        while dpg.is_dearpygui_running():
            out = self.ctl.train_frame()
            if out is not None:
                dpg.set_value(
                    "_log_train",
                    f"step={self.ctl.trainer.global_step} "
                    f"loss={out['loss']:.4f} ({out['time']*1000:.0f}ms)")
            img, dt = self.ctl.render_frame()
            if img is not None:
                img = self.ctl.display_frame(img)  # tool overlays (editors)
                dpg.set_value("_texture",
                              np.ascontiguousarray(img, dtype=np.float32))
                if dt > 0:
                    dpg.set_value("_log_time",
                                  f"render {dt*1000:.0f}ms "
                                  f"({1.0/max(dt,1e-6):.1f} fps) "
                                  f"downscale {self.ctl.downscale}")
            dpg.render_dearpygui_frame()
        dpg.destroy_context()
