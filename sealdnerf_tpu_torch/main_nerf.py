"""Static NeRF CLI of the port (counterpart of the repository's main_nerf.py).

    python -m sealdnerf_tpu_torch.main_nerf synthetic -O --bound 1 \\
        --dt_gamma 0 [--iters N] [--test] [--ckpt PATH] [--device cpu]

Training (no --test): builds the trainer (seeded init, or the checkpoint
that --ckpt selects), trains ceil(iters / n_train) epochs, evaluates PSNR on
the val views as it goes and on the test views at the end, and writes the
test frames as PNG.

Serving (--test): loads the checkpoint (or starts from the seeded init with
--ckpt scratch), rebuilds the occupancy grid when the checkpoint has none,
evaluates PSNR on the test views when they have images, and writes the
rendered frames as PNG.

Not ported yet: the GUI, mesh export and LPIPS.
"""

import numpy as np

from .cli import base_parser, postprocess, load_datasets, build_trainer
from .train.metrics import PSNRMeter


def main(argv=None):
    opt = postprocess(base_parser().parse_args(argv))
    if opt.gui:
        raise SystemExit("the GUI is not yet ported")
    print(opt)
    trainer, _ = build_trainer(opt, name="ngp", metrics=[PSNRMeter()])
    train, val, test = load_datasets(opt)
    if not opt.test:
        trainer.train(train, val, int(np.ceil(opt.iters / len(train))))
    elif not bool(trainer.grid_state["occ"].any()):
        # a seeded field or a checkpoint without a grid: mark the training
        # cameras' frusta and sweep the density into the grid
        trainer.mark_untrained_grid(train.poses, train.intrinsics)
        trainer.rebuild_grid()
    if test.images is not None:
        trainer.evaluate(test)
    trainer.test(test)
    if not opt.test:
        trainer.log("[INFO] mesh export (save_mesh) is not yet ported; "
                    "skipped")


if __name__ == "__main__":
    main()
