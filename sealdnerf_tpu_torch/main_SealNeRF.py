"""Static Seal editing CLI of the port (counterpart of the repository's
main_SealNeRF.py).

    python -m sealdnerf_tpu_torch.main_SealNeRF synthetic -O \\
        --teacher_workspace T --workspace W [--seal_config seal.json] \\
        [--custom_pose] [--secondary_teacher_workspace S] [--device cpu]

At the CLI's defaults (bound 2, dt_gamma 1/128) the teacher is the
Instant-NGP field (2^--log2_hashmap_size entries a level; with the
background sphere at --bg_radius > 0) of the checkpoint that --teacher_ckpt
selects in --teacher_workspace, and the student a StudentTrainer on a copy
of it, in plain PyTorch. --bound 1 --dt_gamma 0 (or --backbone cp) edits
the static CP field instead, through the kernels (FastStudentTrainer: K1
forward, K2 backward). The mapper comes from --seal_config (default:
seal.json in --workspace). The student pretrains on the teacher's point
queries, then distils on the views the teacher renders; then the test views
are rendered and written as PNG. --custom_pose trains on random orbit poses
around the edit instead of the dataset's (the teacher provides their
images); --secondary_teacher_workspace answers the edited samples with a
second model.

A CP field takes the teacher checkpoint's shapes; --planes other than
'auto' must agree with them. The meters are PSNR and LPIPS (available only
where the lpips package and its weights are on the disk; nothing is
downloaded). The frames go to PNG, and to an mp4 when an encoder is
installed. --gui is accepted and ignored: the reference's main_SealNeRF
has no viewer either.

Under torchrun the teacher and the student share the data mesh, as in
main_seald (editing/student.py); rank 0 writes the files. --profile writes
a torch.profiler trace of the edit and the test frames to
<workspace>/trace.
"""

import numpy as np

from .cli import (base_parser, build_edit_trainers, load_datasets,
                  postprocess, profiled)
from .main_seald import max_epochs
from .train.metrics import LPIPSMeter, PSNRMeter


def build_parser():
    parser = base_parser()
    parser.add_argument("--seal_config", type=str, default="")
    parser.add_argument("--extra_epochs", type=int, default=None)
    parser.add_argument("--log2_hashmap_size", type=int, default=19)
    parser.add_argument("--dt_gamma_proxy", type=float, default=1 / 128)
    parser.add_argument("--pretraining_epochs", type=int, default=100)
    parser.add_argument("--pretraining_local_point_step", type=float,
                        default=0.001)
    parser.add_argument("--pretraining_local_angle_step", type=float,
                        default=45)
    parser.add_argument("--pretraining_surrounding_point_step", type=float,
                        default=0.01)
    parser.add_argument("--pretraining_surrounding_angle_step", type=float,
                        default=45)
    parser.add_argument("--pretraining_surrounding_bounds_extend", type=float,
                        default=0.1)
    parser.add_argument("--pretraining_global_point_step", type=float,
                        default=-1)
    parser.add_argument("--pretraining_global_angle_step", type=float,
                        default=45)
    parser.add_argument("--pretraining_batch_size", type=int, default=8192)
    parser.add_argument("--pretraining_lr", type=float, default=0.07)
    parser.add_argument("--custom_pose", action="store_true")
    parser.add_argument("--teacher_workspace", type=str, default="")
    parser.add_argument("--teacher_ckpt", type=str, default="latest")
    parser.add_argument("--secondary_teacher_workspace", type=str,
                        default=None)
    parser.add_argument("--secondary_teacher_ckpt", type=str,
                        default="latest")
    parser.add_argument("--eval_interval", type=int, default=50)
    parser.add_argument("--eval_count", type=int, default=10)
    parser.add_argument("--test_type", type=str, default="test")
    return parser


def parse_args(argv=None):
    opt = postprocess(build_parser().parse_args(argv))
    if not opt.teacher_workspace:
        opt.teacher_workspace = opt.workspace
    return opt


def main(argv=None):
    opt = parse_args(argv)
    if opt.gui:
        print("[INFO] main_SealNeRF has no viewer, as in the reference: "
              "--gui is ignored")
    print(opt)
    _, trainer, mapper = build_edit_trainers(
        opt, dynamic=False, metrics=[PSNRMeter(), LPIPSMeter()],
        eval_interval=opt.eval_interval)
    train, val, test = load_datasets(opt)
    if opt.custom_pose:
        # random orbit poses around the edit (the reference's
        # SealRandomDataset): the teacher renders their images
        from .data.provider import NeRFDataset
        md = mapper.map_data
        center = np.asarray(md["pose_center"].cpu() if "pose_center" in md
                            else np.zeros(3), np.float32)
        radius = float(md.get("pose_radius", 1.0))
        train = NeRFDataset.random_orbit(
            n=max(len(train), 50), h=train.h, w=train.w,
            intrinsics=train.intrinsics, center=center,
            radius=min(max(radius, 0.5), 2.0 * opt.bound), seed=opt.seed)
    with profiled(opt, trainer.device, trainer.mesh.rank):
        if opt.test:
            trainer.test(test, write_video=True)
            return trainer
        trainer.init_pretraining(
            epochs=opt.pretraining_epochs,
            batch_size=opt.pretraining_batch_size, lr=opt.pretraining_lr,
            local_point_step=opt.pretraining_local_point_step,
            local_angle_step=opt.pretraining_local_angle_step,
            surrounding_point_step=opt.pretraining_surrounding_point_step,
            surrounding_angle_step=opt.pretraining_surrounding_angle_step,
            surrounding_bounds_extend=(
                opt.pretraining_surrounding_bounds_extend),
            global_point_step=opt.pretraining_global_point_step,
            global_angle_step=opt.pretraining_global_angle_step)
        trainer.train(train, val, max_epochs(opt, len(train)))
        trainer.test(test, write_video=True)
    return trainer


if __name__ == "__main__":
    main()
