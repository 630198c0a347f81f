"""Interactive GUI layer of the port (port of sealdnerf_tpu/gui/).

Parity with reference nerf/gui.py, dnerf/gui.py, SealNeRF/gui.py,
SealDNeRF/gui.py (dearpygui viewers with live training, dynamic-resolution
rendering, and the brush/texture/anchor edit tools), on the port's
trainers.

Architecture: the controller logic (orbit camera, train/render pacing,
dynamic downscale, SPP accumulation, edit-tool state machine, mask
back-projection) lives in headless classes (orbit.py, controller.py,
edit_controller.py), and the dearpygui views (nerf_gui.py, dnerf_gui.py,
seal_gui.py, seald_gui.py) are thin widget shells. dearpygui is imported
lazily: where it is not installed the views run on headless_dpg, the same
API without a display.

On a data mesh rank 0 alone opens the view, and its controller calls are
made by every rank (follow.py: run_view, Leader, follow).

Frames come from Trainer.test_gui (on a CP field the kernels K1 / K3, the
LOD preview when the frame needs no depth) with the downscale snapped to 1,
2, 4 or 8; the training interleave is Trainer.train_gui (K1 + K2 or K3 +
K4 on a CP field).
"""

from .orbit import OrbitCamera
from .controller import GUIController
from .edit_controller import EditController, EditState

__all__ = ["OrbitCamera", "GUIController", "EditController", "EditState"]
