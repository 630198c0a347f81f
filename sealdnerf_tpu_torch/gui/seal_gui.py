"""Interactive Seal editor for static scenes (port of
sealdnerf_tpu/gui/seal_gui.py, the reference editor's SealNeRF/gui.py:
97-1241): teacher + student trainers, brush painting, texture box select,
anchor drag, train/override buttons, all over the headless EditController,
which the view changes only through its methods and attribute sets."""

from .edit_controller import EditController, EditState
from .nerf_gui import NeRFGUI


class SealGUI(NeRFGUI):
    def __init__(self, opt, teacher_trainer, student_trainer,
                 train_dataset=None, headless=False, controller=None):
        ctl = controller or EditController(opt, teacher_trainer,
                                           student_trainer, train_dataset)
        super().__init__(opt, student_trainer, train_dataset,
                         controller=ctl, headless=headless)

    def _extra_widgets(self, dpg):
        ctl: EditController = self.ctl

        def set_state(state):
            def cb(sender, app_data):
                ctl.set_state(state)
            return cb

        with dpg.group(horizontal=True):
            dpg.add_button(label="preview", callback=set_state(
                EditState.PREVIEW))
            dpg.add_button(label="brush", callback=set_state(EditState.BRUSH))
            dpg.add_button(label="texture", callback=set_state(
                EditState.TEXTURE))
            dpg.add_button(label="anchor", callback=set_state(
                EditState.ANCHOR))
        dpg.add_slider_float(label="brush pressure", default_value=0.05,
                             min_value=-0.2, max_value=0.2,
                             callback=lambda s, a: setattr(
                                 ctl, "brush_pressure", a))
        dpg.add_slider_int(label="brush size", default_value=4,
                           min_value=1, max_value=32,
                           callback=lambda s, a: setattr(
                               ctl, "brush_size", a))
        dpg.add_checkbox(label="eraser", tag="_eraser", default_value=False)
        with dpg.group(horizontal=True):
            dpg.add_button(label="undo", callback=lambda: ctl.undo_stroke())
            dpg.add_button(label="clear", callback=lambda: ctl.clear_tool())
        dpg.add_input_text(
            label="secondary teacher ws", tag="_sec_ws",
            callback=lambda s, a: ctl.load_secondary_teacher(a))
        dpg.add_slider_float(label="anchor radius", default_value=0.1,
                             min_value=0.01, max_value=0.5,
                             callback=lambda s, a: setattr(
                                 ctl, "anchor_radius", a))
        dpg.add_color_edit(label="edit color", default_value=(255, 0, 0),
                           callback=lambda s, a: setattr(
                               ctl, "edit_color", [c / 255 for c in a[:3]]))
        dpg.add_input_text(label="texture file", tag="_texture_path",
                           callback=lambda s, a: setattr(
                               ctl, "texture_path", a))
        with dpg.group(horizontal=True):
            dpg.add_button(label="start edit",
                           callback=lambda: ctl.start_edit_training())
            dpg.add_button(label="override teacher",
                           callback=lambda: ctl.override_teacher())
            dpg.add_button(label="view teacher/student",
                           callback=lambda: ctl.toggle_view())

        # brush painting: right-drag while in BRUSH state stamps the mask
        with dpg.handler_registry():
            def on_paint(sender, app_data):
                if ctl.state in (EditState.BRUSH,):
                    x, y = dpg.get_mouse_pos(local=False)
                    ctl.paint(x, y, erase=bool(dpg.get_value("_eraser")))

            def on_rect(sender, app_data):
                if ctl.state in (EditState.TEXTURE, EditState.ANCHOR):
                    ctl.on_click(*dpg.get_mouse_pos(local=False))

            dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Right,
                                       callback=on_paint)
            dpg.add_mouse_click_handler(button=dpg.mvMouseButton_Right,
                                        callback=on_rect)
