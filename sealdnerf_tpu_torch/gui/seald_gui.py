"""Interactive SealD editor for dynamic scenes (port of
sealdnerf_tpu/gui/seald_gui.py, the reference editor's
SealDNeRF/gui.py:62-986): the static Seal editor plus the time slider; edits
are pinned to the slider's time frame when training starts."""

from .edit_controller import EditState
from .seal_gui import SealGUI


class SealDGUI(SealGUI):
    def _extra_widgets(self, dpg):
        super()._extra_widgets(dpg)
        dpg.add_slider_float(
            label="time", default_value=0.0, min_value=0.0, max_value=1.0,
            callback=lambda s, a: self.ctl.set_time(a))
