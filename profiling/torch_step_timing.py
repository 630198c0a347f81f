#!/usr/bin/env python3
"""ms/step of chip_smoke.py's phase-5 and phase-7 training, for comparing
two checkouts on one card.

    cd <checkout> && python3 /path/to/profiling/torch_step_timing.py TAG

The package is imported from the current directory, so two checkouts are
compared by running the script from each in turns within one call (parent,
change, change, parent). It builds the kernels, makes the procedural
scenes (48 views at 800x800), and trains through cli.build_trainer on one
rank, as phases 5 and 7 do: the static CP field 512 steps and the dynamic
one 256 steps of 4,096 rays; it prints ms/step over the epochs after the
first, the card's name and power limit, and TAG.
"""

import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402


def _run(argv, dynamic, train):
    from sealdnerf_tpu_torch import main_dnerf
    from sealdnerf_tpu_torch.cli import base_parser, build_trainer, \
        postprocess
    if dynamic:
        opt = main_dnerf.parse_args(argv)
        tr, _ = build_trainer(opt, name="ngp", dynamic=True,
                              lr_net=opt.lr_net)
    else:
        opt = postprocess(base_parser().parse_args(argv))
        tr, _ = build_trainer(opt, name="ngp")
    tr.train(train, None, int(np.ceil(opt.iters / len(train))))
    hist = tr.history
    steps = len(hist["loss"]) - max(len(train), tr.opt.segment_steps)
    return sum(hist["epoch_s"][1:]) * 1e3 / steps


def main():
    tag = sys.argv[1] if len(sys.argv) > 1 else os.getcwd()
    if not torch.cuda.is_available():
        raise SystemExit("torch_step_timing: no CUDA device available")
    import subprocess
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
    from sealdnerf_tpu_torch.ops import build
    build.load_library()
    ws = os.path.join(os.getcwd(), "workspace", "step_timing")
    out = {}
    for dynamic, steps in ((False, 512), (True, 256)):
        _, train, _ = make_synthetic_scene(n_train=48, n_val=6, res=800,
                                           dynamic=dynamic)
        argv = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0",
                "--iters", str(steps), "--synthetic_res", "800", "--ckpt",
                "scratch", "--workspace", ws]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["dynamic" if dynamic else "static"] = _run(argv, dynamic, train)
        print(f"{tag}: {'dynamic' if dynamic else 'static'} "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    print(f"{tag} on {card}: static {out['static']:.3f} ms/step, dynamic "
          f"{out['dynamic']:.3f} ms/step (epochs after the first)",
          flush=True)


if __name__ == "__main__":
    main()
