"""Training options (port of `TrainOptions` in
sealdnerf_tpu/train/trainer.py).

Only the fields that the ported paths read: the grid, march and render
settings of serving (the bucket ladders, the termination trim and the LOD
preview among them), the static trainer's settings (step count, learning
rate and schedule, rays per step, grid-refresh interval, EMA, epochs,
evaluation and checkpoint cadence), and the dynamic trainer's (the MLP
learning rate, the time curriculum, the coarse-to-fine anneal and the
deform regulariser). The other training fields of the reference come with
the code that reads them.
"""

import math
from dataclasses import dataclass
from typing import Optional, Tuple


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
    # The bucketed renderer (render/fast_image.py:render_image_bucketed),
    # which FastTrainer.render_image takes below 15 % occupancy: (share of
    # the tiles, divisor of the render interval budget), the emptiest tiles
    # first, the last split taking the rest. The eval ladder and the LOD
    # preview's harsher one, with the reference's values (its TrainOptions
    # comment gives their measured trade-off on the TPU).
    render_splits: Tuple[Tuple[float, int], ...] = (
        (0.60, 32), (0.15, 16), (0.15, 4), (0.07, 2), (1.0, 2))
    render_splits_preview: Tuple[Tuple[float, int], ...] = (
        (0.60, 32), (0.18, 16), (0.12, 8), (0.07, 4), (1.0, 2))
    # the termination trim of bucketed frames: leading intervals probed per
    # tile (0 = off), the optical-depth cutoff at interval entry (exp(-7) ~
    # 1e-3 per corner probe), and every stride-th covered interval tapped
    render_term_intervals: int = 16
    render_term_tau: float = 7.0
    render_term_stride: int = 2
    # the LOD preview (FastTrainer.test_gui without depth): line scales with
    # res >= this are skipped in the field kernel; 0 disables
    preview_lod_min_res: int = 1024


def cascades_for(bound: float) -> int:
    return 1 + max(0, math.ceil(math.log2(max(bound, 1.0))))
