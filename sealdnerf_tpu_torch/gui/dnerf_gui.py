"""dearpygui viewer for dynamic D-NeRF (port of
sealdnerf_tpu/gui/dnerf_gui.py, the reference viewer's dnerf/gui.py): the
static viewer plus a time slider (dnerf/gui.py:288-293)."""

from .nerf_gui import NeRFGUI


class DNeRFGUI(NeRFGUI):
    def _extra_widgets(self, dpg):
        dpg.add_slider_float(
            label="time", default_value=0.0, min_value=0.0, max_value=1.0,
            callback=lambda s, a: self.ctl.set_time(a))
