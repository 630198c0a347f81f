"""TensoRF CLI of the port (counterpart of the repository's main_tensoRF.py).

    python -m sealdnerf_tpu_torch.main_tensoRF synthetic [--cp] \\
        [--iters N] [--resolution0 R0 --resolution1 R1] \\
        [--upsample_model_steps S ...] [--test] [--device cpu]

The VM field (--cp: CP) at bound 2 by default: density ranks 16 x 3 (CP
32), appearance 48 x 3 (CP 32), 27 appearance features, SH(4) and a 3 x 64
colour tower, trained by Trainer's packed march with the factors at --lr0
and the towers at --lr1. At each of the steps of --upsample_model_steps
(the flag adds steps to the default 2000, 3000, 4000, 5500 and 7000, as the
reference's action="append" does) every factor is resized to the next
resolution of the log schedule from --resolution0 to --resolution1; the
field is rebuilt, the EMA copied from the new params, and Adam and the
0.1 ** (step / iters) schedule start afresh (the reference's tx.init).
--l1_reg_weight parses and is not applied, as in the reference.

Training (no --test) trains ceil(iters / n_train) epochs, evaluates PSNR on
the val views as it goes and on the test views at the end, and writes the
test frames. --test loads the checkpoint that --ckpt selects (one saved
after an upsample included) and evaluates and writes the frames.

Under torchrun the trainer takes Trainer's sharded step on the data mesh;
an upsample fires at the same global step on every rank and rebuilds the
field, the EMA, Adam and its schedule there in the same bits. Rank 0
writes the files. --profile writes a torch.profiler trace of the training
and the test frames to <workspace>/trace.
"""

import numpy as np
import torch

from .cli import (base_parser, load_datasets, postprocess, profiled,
                  resolve_device, to_train_options)
from .models.api import make_tensorf_field
from .models.tensorf import TensoRFConfig, upsample_tensorf
from .models.params import map_params
from .train.metrics import PSNRMeter
from .train.trainer import Trainer

UPSAMPLE_STEPS = (2000, 3000, 4000, 5500, 7000)


def build_parser():
    parser = base_parser(default_bound=2.0, default_lr=2e-2)
    parser.add_argument("--lr0", type=float, default=2e-2,
                        help="embedding lr")
    parser.add_argument("--lr1", type=float, default=1e-3, help="network lr")
    parser.add_argument("--l1_reg_weight", type=float, default=1e-4,
                        help="parsed; not applied (as in the reference)")
    parser.add_argument("--cp", action="store_true", help="use TensorCP")
    parser.add_argument("--resolution0", type=int, default=128)
    parser.add_argument("--resolution1", type=int, default=300)
    parser.add_argument("--upsample_model_steps", type=int, action="append",
                        default=list(UPSAMPLE_STEPS))
    return parser


def upsample_resolutions(r0: int, r1: int, n: int):
    """The n resolutions of the log schedule from r0 (excluded) to r1."""
    return [int(round(np.exp(np.log(r0) + (np.log(r1) - np.log(r0))
                             * (i + 1) / n))) for i in range(n)]


class TensoRFTrainer(Trainer):
    """Trainer with progressive upsampling at upsample_steps."""

    def __init__(self, *a, upsample_steps=(), resolution1=300, **kw):
        super().__init__(*a, **kw)
        self.upsample_model_steps = sorted(set(upsample_steps))
        self.resolution1 = resolution1
        self.upsample_resolutions = upsample_resolutions(
            self.field.cfg.resolution, resolution1,
            len(self.upsample_model_steps))

    def train_step_gt(self, data, h: int, w: int):
        if self.upsample_model_steps and \
                self.global_step == self.upsample_model_steps[0]:
            self.upsample()
        return super().train_step_gt(data, h, w)

    def upsample(self):
        """Resize every factor to the next resolution of the schedule and
        start the EMA, Adam and its schedule afresh."""
        self.upsample_model_steps.pop(0)
        new_res = self.upsample_resolutions.pop(0)
        self.log(f"[INFO] upsample TensoRF grids -> {new_res}^3 at step "
                 f"{self.global_step}")
        params, cfg = upsample_tensorf(self.params, self.field.cfg, new_res)
        self.field = make_tensorf_field(None, cfg, params=params)
        self._set_params(params)
        self.ema_params = map_params(lambda t: t.detach().clone(),
                                     self.params)


def main(argv=None):
    """Run the CLI on argv (None: sys.argv) -> the trainer."""
    opt = postprocess(build_parser().parse_args(argv))
    if opt.gui:
        print("[INFO] main_tensoRF has no viewer, as in the reference: "
              "--gui is ignored")
    opt.lr = opt.lr0
    print(opt)
    device = resolve_device(opt.device)
    cfg = TensoRFConfig(bound=opt.bound,
                        decomposition="cp" if opt.cp else "vm",
                        resolution=opt.resolution0,
                        sigma_rank=(32,) if opt.cp else (16, 16, 16),
                        color_rank=(32,) if opt.cp else (48, 48, 48))
    field = make_tensorf_field(torch.Generator().manual_seed(opt.seed), cfg,
                               device)
    trainer = TensoRFTrainer(
        "tensorf", to_train_options(opt, name="tensorf", lr=opt.lr0,
                                    lr_net=opt.lr1),
        field, metrics=[PSNRMeter()], workspace=opt.workspace,
        use_checkpoint=opt.ckpt, device=device,
        upsample_steps=opt.upsample_model_steps,
        resolution1=opt.resolution1)
    train, val, test = load_datasets(opt)
    with profiled(opt, trainer.device, trainer.mesh.rank):
        if not opt.test:
            trainer.train(train, val, int(np.ceil(opt.iters / len(train))))
        if test.images is not None:
            trainer.evaluate(test)
        trainer.test(test, write_video=True)
    return trainer


if __name__ == "__main__":
    main()
