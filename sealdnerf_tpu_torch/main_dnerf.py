"""Dynamic D-NeRF CLI of the port (counterpart of the repository's
main_dnerf.py).

    python -m sealdnerf_tpu_torch.main_dnerf synthetic -O --bound 1 \\
        --dt_gamma 0 [--iters N] [--test] [--ckpt PATH] [--device cpu]

Builds the time-conditioned CP field and its trainer (the checkpoint that
--ckpt selects, or the seeded init with --ckpt scratch).

Training (the default): ceil(iters / n_train) epochs of FastTrainer.train
(which stops at --iters steps), then PSNR on the test views when they have
images, each at its own time, and the rendered frames as PNG.

Serving (--test): rebuilds every time bin of the occupancy grid when the
checkpoint has none, evaluates and writes the frames.

Not ported yet: the GUI, --basis and --hyper, and the mp4 export.
"""

import math

from .cli import base_parser, build_trainer, load_datasets, postprocess
from .train.metrics import PSNRMeter


def build_parser():
    # The lr defaults depend on the backbone and are resolved in main: the
    # CP/VM field trains at 1e-2 (tables) and 1e-3 (MLPs), the hash
    # backbone at 5e-4 for both.
    parser = base_parser(default_bound=2.0, default_lr=None,
                         default_iters=300000)
    parser.add_argument("--lr_net", type=float, default=None)
    parser.add_argument("--basis", action="store_true",
                        help="temporal-basis dynamic model")
    parser.add_argument("--hyper", action="store_true",
                        help="hyper-nerf ambient-dim dynamic model")
    # the round-robin bin refresh needs this cadence, not D-NeRF's 100, or
    # the time-sliced occupancy goes stale
    parser.set_defaults(update_extra_interval=16)
    parser.add_argument("--time_curriculum_steps", type=int, default=-1,
                        help="-1 auto (512 if monocular, else off); "
                             "0 off; >0 window length in steps")
    return parser


def parse_args(argv=None):
    """Parse, and resolve the lr defaults from the backbone the recipe
    selects."""
    opt = postprocess(build_parser().parse_args(argv))
    cp_route = (opt.backbone == "cp"
                or (opt.backbone == "auto" and opt.bg_radius <= 0
                    and opt.bound <= 1.0 and not (opt.basis or opt.hyper)))
    if opt.lr is None:
        opt.lr = 1e-2 if cp_route else 5e-4
    if opt.lr_net is None:
        opt.lr_net = 1e-3 if cp_route else 5e-4
    return opt


def main(argv=None):
    opt = parse_args(argv)
    if opt.gui:
        raise SystemExit("the GUI is not yet ported")
    print(opt)
    trainer, _ = build_trainer(opt, name="ngp", dynamic=True,
                               metrics=[PSNRMeter()], lr_net=opt.lr_net)
    train, val, test = load_datasets(opt, with_time=True)
    if not opt.test:
        trainer.train(train, val, math.ceil(opt.iters / len(train)))
    elif not bool(trainer.grid_state["occ"].any()):
        # a seeded field: mark the training cameras' frusta and sweep the
        # density of every time bin into the grid
        trainer.mark_untrained_grid(train.poses, train.intrinsics)
        trainer.rebuild_grid()
    if test.images is not None:
        trainer.evaluate(test)
    trainer.test(test)
    trainer.log("[INFO] mp4 export is not yet ported; frames saved as PNG")


if __name__ == "__main__":
    main()
