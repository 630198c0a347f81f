"""Static NeRF CLI of the port (counterpart of the repository's main_nerf.py).

    python -m sealdnerf_tpu_torch.main_nerf synthetic -O [--bound B] \\
        [--dt_gamma G] [--backbone ngp] [--bg_radius R] [--iters N] \\
        [--test] [--ckpt PATH] [--device cpu]

At the defaults (--bound 2, --dt_gamma 1/128) the CP field has no VM planes
(--planes auto) and marches two cascades with growing steps; --bound 1
--dt_gamma 0 is the single-cascade recipe with one (128, 8) plane scale.
--backbone ngp, or --bg_radius > 0, trains the Instant-NGP field (with the
background sphere) through Trainer's packed march instead, as the
reference routes them.

Training (no --test): builds the trainer (seeded init, or the checkpoint
that --ckpt selects), trains ceil(iters / n_train) epochs, evaluates PSNR
(and LPIPS where its weights are on the disk) on the val views as it goes
and on the test views at the end, writes the test frames as PNG (and an mp4
when an encoder is installed) and the density's iso-surface as a PLY mesh
(save_mesh on a 256^3 grid at density 10, as the reference). Frames of a
trained field (occupancy below 15 %) come from the bucketed renderer.
--error_map, --patch_size and --no_preload select the trainers' sampling.

Serving (--test): loads the checkpoint (or starts from the seeded init with
--ckpt scratch), rebuilds the occupancy grid when the checkpoint has none,
evaluates the test views when they have images, and writes the frames and
the mesh.

--gui opens the viewer (gui/nerf_gui.py) on the trainer instead: with
live training on the training set, or with --test on the served field
(after the same grid rebuild). It runs on dearpygui where that is
installed, else on the headless backend (gui/headless_dpg.py).

Under torchrun every rank trains and serves on the data mesh; rank 0 writes
the files and opens the viewer, whose calls every rank makes
(gui/follow.py). --profile writes a torch.profiler trace of the training
and serving calls to <workspace>/trace/rank{r}.pt.trace.json.
"""

import numpy as np

from .cli import (base_parser, build_trainer, load_datasets, postprocess,
                  profiled)
from .train.metrics import LPIPSMeter, PSNRMeter

MESH_RESOLUTION, MESH_THRESHOLD = 256, 10.0    # the reference's save_mesh


def main(argv=None):
    """Run the CLI on argv (None: sys.argv) -> the trainer."""
    opt = postprocess(base_parser().parse_args(argv))
    print(opt)
    trainer, _ = build_trainer(opt, name="ngp",
                               metrics=[PSNRMeter(), LPIPSMeter()])
    train, val, test = load_datasets(opt)
    if opt.gui and not opt.test:
        open_viewer(opt, trainer, train)
        return trainer
    with profiled(opt, trainer.device, trainer.mesh.rank):
        if not opt.test:
            trainer.train(train, val, int(np.ceil(opt.iters / len(train))))
        elif not bool(trainer.grid_state["occ"].any()):
            # a seeded field or a checkpoint without a grid: mark the
            # training cameras' frusta and sweep the density into the grid
            trainer.mark_untrained_grid(train.poses, train.intrinsics)
            trainer.rebuild_grid()
        if not opt.gui:
            if test.images is not None:
                trainer.evaluate(test)
            trainer.test(test, write_video=True)
            trainer.save_mesh(resolution=MESH_RESOLUTION,
                              threshold=MESH_THRESHOLD)
    if opt.gui:
        open_viewer(opt, trainer)
    return trainer


def open_viewer(opt, trainer, train=None, view=None):
    """The viewer (`view`, default NeRFGUI) on the trainer, with live
    training on `train` when given; on a mesh rank 0's window drives the
    other ranks (gui/follow.py)."""
    from .gui.controller import GUIController
    from .gui.follow import run_view
    from .gui.nerf_gui import NeRFGUI
    view = view or NeRFGUI
    run_view(lambda ctl: view(opt, trainer, train_dataset=train,
                              controller=ctl),
             GUIController(opt, trainer, train))


if __name__ == "__main__":
    main()
