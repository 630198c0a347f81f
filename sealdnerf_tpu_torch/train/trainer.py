"""Training options (port of `TrainOptions` in
sealdnerf_tpu/train/trainer.py).

Only the fields that the ported serving path reads: the grid, march and
render settings. Training fields come with the code that reads them.
"""

import math
from dataclasses import dataclass


@dataclass
class TrainOptions:
    """The subset of the reference's options that the port reads."""

    workspace: str = "workspace"
    name: str = "ngp"
    bound: float = 1.0
    dt_gamma: float = 1.0 / 128
    min_near: float = 0.2
    density_thresh: float = 10.0
    density_scale: float = 1.0
    t_thresh: float = 1e-4
    seed: int = 0
    grid_size: int = 128             # occupancy grid resolution
    march_res: int = 64              # coarse march grid resolution
    n_intervals: int = 16            # kept occupied voxel-steps per ray
    steps_per_interval: int = 4      # fine samples per interval
    # tile-band image rendering (render/fast_image.py)
    render_tile_px: int = 8          # pixels per march tile (1 = per-ray)
    render_dilate: int = 1           # occupancy dilation radius (voxels)
    render_march_res: int = 0        # 0 = use march_res
    render_n_intervals: int = 0      # 0 = 2x the training n_intervals
    render_steps_per_interval: int = 0


def cascades_for(bound: float) -> int:
    return 1 + max(0, math.ceil(math.log2(max(bound, 1.0))))
