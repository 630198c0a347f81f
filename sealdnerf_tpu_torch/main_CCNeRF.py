"""CCNeRF CLI of the port (counterpart of the repository's main_CCNeRF.py).

    python -m sealdnerf_tpu_torch.main_CCNeRF synthetic [--rank R] \\
        [--rank_fracs F ...] [--iters N] [--test] [--device cpu]
    python -m sealdnerf_tpu_torch.main_CCNeRF synthetic --compose \\
        --compose_models WS [WS ...] [--workspace OUT] [--device cpu]

Training: a CP TensoRF field (rank --rank, resolution 128, bound 1 by
default) through Trainer with the rank-residual K-loss: each step renders
its rays at full rank and at each truncation level of --rank_fracs with the
same march offsets, and the MSE is their mean. The factors train at --lr0,
the towers at --lr1.

--compose: each workspace's checkpoint (--ckpt, the training params) is
loaded into its own field, placed by world_to_model (scale 0.6, on a circle
of radius 0.5 in the xz plane), and the composition (cc_compose_forward:
sigma adds, colour is the sigma-weighted mix) is served by a viewer
Trainer: a full density sweep of the composition into its grid, then the
test frames under <workspace>/compose. The reference's viewer renders its
EMA, the seeded params of the first field, and fails (KeyError 0); here the
viewer renders the loaded params.

Under torchrun the K-loss step is Trainer's sharded step on the data mesh.
Under --compose every rank loads the models, each rank sweeps its block of
the union grid's cells and the blocks are merged (Trainer.rebuild_grid),
and rank 0 writes the frames. --profile writes a torch.profiler trace of
the training (or the composition) and the test frames to
<workspace>/trace.
"""

import os

import numpy as np
import torch

from .cli import (base_parser, load_datasets, postprocess, profiled,
                  resolve_device, to_train_options)
from .models.api import Field, make_tensorf_field
from .models.tensorf import TensoRFConfig, cc_compose_forward
from .train.metrics import PSNRMeter
from .train.trainer import Trainer

COMPOSE_SCALE, COMPOSE_RADIUS = 0.6, 0.5


def build_parser():
    parser = base_parser(default_bound=1.0, default_lr=2e-2)
    parser.add_argument("--compose", action="store_true")
    parser.add_argument("--lr0", type=float, default=2e-2)
    parser.add_argument("--lr1", type=float, default=1e-3)
    parser.add_argument("--rank", type=int, default=64,
                        help="CP rank (rank-residual training truncates it)")
    parser.add_argument("--compose_models", type=str, nargs="*", default=[],
                        help="workspaces of trained models to compose")
    parser.add_argument("--rank_fracs", type=float, nargs="*",
                        default=[0.25, 0.5],
                        help="rank-residual K-loss truncation fractions "
                             "(trained jointly with the full rank)")
    return parser


def world_to_model(s, t, R=None):
    """The world-to-model [4, 4] f32 tensor of a model scaled by s, rotated
    by R (default none) and moved to t."""
    m = np.eye(4, dtype=np.float32)
    rot = np.eye(3) if R is None else np.asarray(R)
    m[:3, :3] = rot.T / s
    m[:3, 3] = -(rot.T @ np.asarray(t, dtype=np.float32)) / s
    return torch.from_numpy(m)


def compose(opt, cfg, device):
    """--compose -> the viewer Trainer, after it wrote the test frames."""
    models = opt.compose_models or [opt.workspace]
    fields, params_list, transforms = [], [], []
    for i, ws in enumerate(models):
        f = make_tensorf_field(torch.Generator().manual_seed(i), cfg, device)
        tr = Trainer("ccnerf", to_train_options(
            opt, name="ccnerf", workspace=ws, lr=opt.lr0, lr_net=opt.lr1),
            f, workspace=ws, use_checkpoint=opt.ckpt, device=device)
        fields.append(f)
        params_list.append(tr.params)
        angle = 2 * np.pi * i / max(len(opt.compose_models), 1)
        transforms.append(world_to_model(
            COMPOSE_SCALE, [COMPOSE_RADIUS * np.cos(angle), 0,
                            COMPOSE_RADIUS * np.sin(angle)]))
    composed = cc_compose_forward(fields, transforms)

    def density(params_list, x):
        d = x.new_tensor([0.0, 0.0, 1.0]).expand(x.shape[0], 3)
        return composed(params_list, x, d)

    viewer = Trainer("ccnerf", to_train_options(opt, name="ccnerf"),
                     fields[0], workspace=opt.workspace,
                     use_checkpoint="scratch", device=device)
    viewer.field = Field(params_list, cfg, composed, density, None)
    viewer.params = viewer.ema_params = params_list
    viewer.update_extra_state = lambda: None
    with profiled(opt, device, viewer.mesh.rank):
        viewer.rebuild_grid()        # a full sweep over the composition
        _, _, test = load_datasets(opt)
        viewer.test(test, save_path=os.path.join(opt.workspace, "compose"),
                    write_video=True)
    return viewer


def main(argv=None):
    """Run the CLI on argv (None: sys.argv) -> the trainer (with --compose
    the viewer)."""
    opt = postprocess(build_parser().parse_args(argv))
    if opt.gui:
        print("[INFO] main_CCNeRF has no viewer, as in the reference: "
              "--gui is ignored")
    opt.lr = opt.lr0
    print(opt)
    device = resolve_device(opt.device)
    cfg = TensoRFConfig(bound=opt.bound, decomposition="cp", resolution=128,
                        sigma_rank=(opt.rank,), color_rank=(opt.rank,))
    if opt.compose:
        return compose(opt, cfg, device)
    field = make_tensorf_field(torch.Generator().manual_seed(opt.seed), cfg,
                               device)
    topt = to_train_options(opt, name="ccnerf", lr=opt.lr0, lr_net=opt.lr1,
                            k_rank_fracs=tuple(opt.rank_fracs or ()))
    trainer = Trainer("ccnerf", topt, field, metrics=[PSNRMeter()],
                      workspace=opt.workspace, use_checkpoint=opt.ckpt,
                      device=device)
    train, val, test = load_datasets(opt)
    with profiled(opt, trainer.device, trainer.mesh.rank):
        if not opt.test:
            trainer.train(train, val, int(np.ceil(opt.iters / len(train))))
        trainer.test(test, write_video=True)
    return trainer


if __name__ == "__main__":
    main()
