"""SealD-NeRF dynamic editing CLI of the port (counterpart of the
repository's main_seald.py).

    python -m sealdnerf_tpu_torch.main_seald synthetic -O \\
        --teacher_workspace T --workspace W --seal_config seal.json \\
        --time_frame 0.5 [--basis | --hyper] [--device cpu]

At the CLI's defaults (bound 2, dt_gamma 1/128) the teacher is the D-NeRF
field (deform, or --basis / --hyper; with the background sphere at
--bg_radius > 0) of the checkpoint that --teacher_ckpt selects in
--teacher_workspace, and the student a StudentTrainer on a copy of it, in
plain PyTorch. --bound 1 --dt_gamma 0 (or --backbone cp) edits the
time-conditioned CP field instead, through the kernels (FastStudentTrainer:
K3 forward, K4 backward). The student starts as the teacher's copy, with
its occupancy grid. The edit of --seal_config is pinned to --time_frame:
the teacher renders every view at that time, the student pretrains on the
teacher's point queries there and then distils on the proxied views, with
its deform tower frozen. Then the test views are rendered (each at its own
time) and written as PNG, and as an mp4 when an encoder is installed.
--test only renders the test views of the student as built.

Two faults of the reference are pinned. A CP field takes the teacher
checkpoint's shapes, and --planes other than 'auto' must agree with them
(the reference builds CPDNeRFConfig(bound) and ignores the flag). The rate
defaults follow the backbone as main_dnerf's do: 1e-2 (tables) and 1e-3
(MLPs) for the CP field (the reference keeps its hash backbone's 5e-4 and
5e-5 for every backbone, at which a CP student does not reach the edit in
hundreds of steps), the reference's 5e-4 and 5e-5 for the D-NeRF field.

--gui opens the interactive editor (gui/seald_gui.py) on the teacher and
the student right after they and the datasets are built: the brush,
texture and anchor tools, the edit at the time slider's frame, its
pretraining and distillation frames, and the override that commits the
student into the teacher; on dearpygui where that is installed, else on the
headless backend (gui/headless_dpg.py).

Under torchrun the teacher and the student share the data mesh: every rank
loads the teacher, the proxy's views, the teacher's point queries and each
pretraining batch are split over the ranks, the distillation takes the
trainers' sharded steps, and every rank renders its band of the test
frames, which rank 0 writes (editing/student.py). --gui opens the editor on
rank 0, whose calls every rank makes (gui/follow.py). --profile writes a
torch.profiler trace of the edit and the test frames to <workspace>/trace.
"""

import numpy as np

from .cli import (base_parser, build_edit_trainers, edit_cp_route,
                  load_datasets, postprocess, profiled)
from .train.metrics import PSNRMeter


def build_parser():
    # The rate defaults depend on the backbone and are resolved in
    # parse_args (see the module docstring).
    parser = base_parser(default_bound=2.0, default_lr=None)
    parser.add_argument("--lr_net", type=float, default=None)
    parser.add_argument("--basis", action="store_true")
    parser.add_argument("--hyper", action="store_true")
    parser.add_argument("--seal_config", type=str, default="")
    parser.add_argument("--time_frame", type=float, default=0.0,
                        help="time in [0,1] the edit is pinned to")
    parser.add_argument("--extra_epochs", type=int, default=None)
    parser.add_argument("--pretraining_epochs", type=int, default=100)
    parser.add_argument("--pretraining_batch_size", type=int, default=8192)
    parser.add_argument("--pretraining_lr", type=float, default=0.07)
    parser.add_argument("--pretraining_local_point_step", type=float,
                        default=0.001)
    parser.add_argument("--pretraining_surrounding_point_step", type=float,
                        default=0.01)
    parser.add_argument("--pretraining_global_point_step", type=float,
                        default=-1)
    parser.add_argument("--teacher_workspace", type=str, default="")
    parser.add_argument("--teacher_ckpt", type=str, default="latest")
    parser.add_argument("--eval_interval", type=int, default=50)
    # the round-robin bin refresh of the dynamic grid needs this cadence
    parser.set_defaults(update_extra_interval=16)
    return parser


def parse_args(argv=None):
    """Parse, and resolve the rate defaults from the backbone: 1e-2 and
    1e-3 for the CP field, the reference's 5e-4 and 5e-5 for the hash
    one."""
    opt = postprocess(build_parser().parse_args(argv))
    cp = edit_cp_route(opt, dynamic=True)
    if opt.lr is None:
        opt.lr = 1e-2 if cp else 5e-4
    if opt.lr_net is None:
        opt.lr_net = 1e-3 if cp else 5e-5
    if not opt.teacher_workspace:
        opt.teacher_workspace = opt.workspace
    return opt


def max_epochs(opt, n_train: int) -> int:
    """Pretraining epochs, then --extra_epochs or ceil(iters / n_train)."""
    return opt.pretraining_epochs + (
        opt.extra_epochs if opt.extra_epochs is not None
        else int(np.ceil(opt.iters / max(n_train, 1))))


def main(argv=None):
    opt = parse_args(argv)
    print(opt)
    teacher, trainer, mapper = build_edit_trainers(
        opt, dynamic=True, metrics=[PSNRMeter()], lr_net=opt.lr_net,
        eval_interval=opt.eval_interval)
    train, val, test = load_datasets(opt, with_time=True)
    if opt.gui:
        from .gui.edit_controller import EditController
        from .gui.follow import run_view
        from .gui.seald_gui import SealDGUI
        run_view(lambda ctl: SealDGUI(opt, teacher, trainer,
                                      train_dataset=train, controller=ctl),
                 EditController(opt, teacher, trainer, train))
        return trainer
    with profiled(opt, trainer.device, trainer.mesh.rank):
        if opt.test:
            trainer.test(test, write_video=True)
            return trainer
        if mapper is not None:
            trainer.init_pretraining(
                time_frame=opt.time_frame, epochs=opt.pretraining_epochs,
                batch_size=opt.pretraining_batch_size,
                lr=opt.pretraining_lr,
                local_point_step=opt.pretraining_local_point_step,
                surrounding_point_step=opt.pretraining_surrounding_point_step,
                global_point_step=opt.pretraining_global_point_step)
        trainer.train(train, val, max_epochs(opt, len(train)),
                      time_frame=opt.time_frame)
        trainer.test(test, write_video=True)
    return trainer


if __name__ == "__main__":
    main()
