"""Training options (port of `TrainOptions` in
sealdnerf_tpu/train/trainer.py).

Only the fields that the ported paths read: the grid, march and render
settings of serving, the static trainer's settings (step count, learning
rate and schedule, rays per step, grid-refresh interval, EMA, epochs,
evaluation and checkpoint cadence), and the dynamic trainer's (the MLP
learning rate, the time curriculum, the coarse-to-fine anneal and the
deform regulariser). The other training fields of the reference come with
the code that reads them.
"""

import math
from dataclasses import dataclass
from typing import Optional


@dataclass
class TrainOptions:
    """The subset of the reference's options that the port reads."""

    workspace: str = "workspace"
    name: str = "ngp"
    iters: int = 30000               # schedule length: lr * 0.1**(step/iters)
    lr: float = 1e-2
    lr_net: Optional[float] = None   # separate lr of the MLP towers (D-NeRF)
    # Dynamic training. The time curriculum trains on a growing window of
    # the time-sorted frames that reaches the full range after this many
    # steps: 0 off, -1 resolved from the data by FastTrainer.train (512 for
    # one camera per timestamp, else off).
    time_curriculum_steps: int = 0
    # Coarse-to-fine: the sigma tower's input rows of line scales and planes
    # with res > dyn_anneal_res ramp from 0 to 1 over dyn_anneal_steps steps
    # (0 off). Without it the canonical field bakes in motion ghosts before
    # the warp locks on.
    dyn_anneal_steps: int = 1024
    dyn_anneal_res: int = 256
    # Weight of mean |deform_raw(x, 0)|^2 at random scene points. It must
    # stay tiny: at 0.1 it pins the near-zero-initialised deform output at
    # zero and the tower never comes alive.
    deform_zero_reg: float = 1e-3
    num_rays: int = 4096             # rays per training step
    update_extra_interval: int = 16  # steps between grid refreshes
    ema_decay: float = 0.95
    eval_interval: int = 50          # epochs between evaluations
    segment_steps: int = 128         # floor of the steps of an epoch
    max_keep_ckpt: int = 2
    # not ported yet: FastTrainer raises when they are on
    error_map: bool = False
    patch_size: int = 1
    preload: bool = True
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
