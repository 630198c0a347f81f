"""Where the time of the Instant-NGP / D-NeRF trainer goes (Trainer over
render_occ, the packed march), for the PyTorch/CUDA port on one GPU.

    python3 profiling/torch_ngp_profile.py [--steps 16] [--at 64]
                                           [--dynamic] [--frames 1]

Builds the trainer as chip_smoke.py's phase 10 does (`main_nerf synthetic
-O --backbone ngp` at the CLI's defaults: bound 2, dt_gamma 1/128, the
full-width hash grid; 48 train views at 800x800, 4096 rays a step) or, with
--dynamic, phase 10b's (`main_dnerf --bound 2`: the D-NeRF deform field).
It trains to each step count of --at, times a window of --steps steps
unprofiled, then profiles a second window with torch.profiler, and prints
per step: wall ms, device busy ms, the idle share (1 - busy / wall), the
packed samples, and the device ms of each part -- the grid refresh
(amortised over the window), sampling, the packed march, the field
forward, the packed compositing, the backward and Adam with the EMA. Then
--frames 800x800 frames of the trained field through Trainer.render_image,
unprofiled and profiled, split the same way (march / field / compositing).
The first line is the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import (ProfilerActivity, profile,  # noqa: E402
                            record_function)

import sealdnerf_tpu_torch.render.renderer as renderer  # noqa: E402
from sealdnerf_tpu_torch import main_dnerf  # noqa: E402
from sealdnerf_tpu_torch.cli import (base_parser, build_trainer,  # noqa: E402
                                     load_datasets, postprocess)

PARTS = ("grid_refresh", "sample", "march", "field", "composite",
         "backward", "adam_ema")


def _ranged(name, fn):
    def wrapped(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return wrapped


def step(trainer, data, h, w):
    """Trainer.train_step with a profiler range around each part."""
    if trainer.global_step % trainer._update_interval() == 0:
        with record_function("grid_refresh"):
            trainer.update_extra_state()
    with record_function("sample"):
        batch = trainer.sample_batch(data, h, w)
    ro, rd, gt, bg, noise = batch[:5]
    loss, n = trainer.loss_on(ro, rd, gt, bg, noise, *batch[5:])
    trainer.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    with record_function("adam_ema"):
        trainer.apply_gradients()
    trainer.global_step += 1
    trainer.local_step += 1
    return int(n)


def _device_ms(prof, names, n=1):
    """Per call of n: device ms of the kernels launched under each named
    range (its CPU-side event sums its children's kernels), and the busy
    device ms (all kernels; the ranges' own GPU-side spans left out)."""
    dev = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages()
               if e.device_type == dev and e.key not in PARTS]
    busy = sum(e.device_time_total for e in kernels) / 1e3 / n
    out = {}
    for e in prof.events():
        if e.device_type != dev and e.name in names:
            out[e.name] = out.get(e.name, 0.0) + e.device_time_total / 1e3 / n
    # the backward runs on autograd's thread, outside every range: the rest
    out["backward"] = busy - sum(out.values())
    return out, busy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--at", type=int, nargs="*", default=[64])
    ap.add_argument("--dynamic", action="store_true")
    ap.add_argument("--frames", type=int, default=1)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    argv = ["synthetic", "-O", "--synthetic_res", "800", "--ckpt", "scratch",
            "--iters", "512", "--workspace", "workspace/ngp_profile"]
    if args.dynamic:
        opt = main_dnerf.parse_args(argv + ["--bound", "2"])
    else:
        opt = postprocess(base_parser().parse_args(argv + ["--backbone",
                                                           "ngp"]))
    trainer, _ = build_trainer(opt, name="ngp", dynamic=args.dynamic,
                               **({"lr_net": opt.lr_net}
                                  if args.dynamic else {}))
    train, val, _ = load_datasets(opt, with_time=args.dynamic)
    trainer.mark_untrained_grid(train.poses, train.intrinsics)
    data = train.device(trainer.device)
    h, w = train.h, train.w
    renderer.march_rays = _ranged("march", renderer.march_rays)
    renderer.composite_packed = _ranged("composite",
                                        renderer.composite_packed)
    trainer.field.forward = _ranged("field", trainer.field.forward)
    for at in args.at:
        while trainer.global_step < at:
            step(trainer, data, h, w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(trainer, data, h, w)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            samples = [step(trainer, data, h, w) for _ in range(args.steps)]
            torch.cuda.synchronize()
        parts, busy = _device_ms(prof, PARTS, args.steps)
        print(f"step {at}: wall {wall:.3f} ms/step, device busy {busy:.3f}, "
              f"idle share {1 - busy / wall:.3f}, samples before the budget "
              f"{np.mean(samples):.0f} (budget {trainer._cur_budget}/ray); "
              "device ms: " + ", ".join(f"{k} {parts.get(k, 0.0):.3f}"
                                        for k in PARTS), flush=True)
    pose, intr = val.poses[0], val.intrinsics
    t = 0.5 if args.dynamic else None
    trainer.render_image(pose, intr, 800, 800, time=t)
    for _ in range(args.frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.render_image(pose, intr, 800, 800, time=t)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.render_image(pose, intr, 800, 800, time=t)
            torch.cuda.synchronize()
        parts, busy = _device_ms(prof, ("march", "field", "composite"))
        parts.pop("backward")
        print(f"800x800 frame at step {trainer.global_step}: wall {wall:.2f} "
              f"ms, device busy {busy:.2f}, idle share {1 - busy / wall:.3f}; "
              + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()),
              flush=True)
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=12, max_name_column_width=60),
          flush=True)


if __name__ == "__main__":
    main()
