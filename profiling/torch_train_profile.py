"""Where the time of a warm full-width training step goes, for the
PyTorch/CUDA port on one GPU.

    python3 profiling/torch_train_profile.py [--steps 16] [--at 64 448]

Builds the trainer as chip_smoke.py's training phase does (synthetic -O
--bound 1 --dt_gamma 0 --iters 512, seeded init, 48 train views at
800x800, 4096 rays per step) and trains. At each step count of `--at` it
times a window of `steps` steps unprofiled (one grid refresh per 16 steps
falls inside it), then profiles a second window of the same length with
torch.profiler. Per window it prints, per step: wall ms, device busy ms,
the idle share (1 - busy / wall), the mean field samples, the occupancy,
and the device ms of each part of the step -- grid refresh (amortised over
the window), ray and pixel sampling, the forward (march, K1, compositing),
the backward (K2 and the autograd of the march and compositing ops), Adam,
the lr schedule and the EMA -- then the top kernels by device time. The
first line is the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import (ProfilerActivity, profile,  # noqa: E402
                            record_function)

import sealdnerf_tpu_torch.render.fast as render_fast  # noqa: E402
from sealdnerf_tpu_torch.cli import (base_parser, build_trainer,  # noqa: E402
                                     load_datasets, postprocess)

# disjoint ranges of a step; march and composite lie inside forward
STEP_PARTS = ("grid_refresh", "sample", "forward", "adam", "schedule", "ema")
SUB_PARTS = ("march", "composite")


def _ranged(name, fn):
    def wrapped(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return wrapped


def step(trainer, data, h, w):
    """One training step, as FastTrainer.train_step runs it, with a
    profiler range around each part. Returns the step's field samples."""
    if trainer.global_step % trainer.opt.update_extra_interval == 0:
        with record_function("grid_refresh"):
            trainer.refresh_grid()
    with record_function("sample"):
        batch = trainer.sample_batch(data, h, w)
    with record_function("forward"):
        loss, n_samples = trainer.loss_on(*batch)
    trainer.optimizer.zero_grad(set_to_none=True)
    loss.backward()           # K2 launches from the autograd thread
    with record_function("adam"):
        trainer.optimizer.step()
    with record_function("schedule"):
        trainer.scheduler.step()
    with record_function("ema"):
        trainer._ema_update()
    trainer.global_step += 1
    return n_samples


def _is_annotation(e):
    return getattr(e, "is_user_annotation", False) or \
        e.key in STEP_PARTS + SUB_PARTS or e.key.startswith("Optimizer.")


def window(trainer, data, h, w, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ns = [step(trainer, data, h, w) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps           # unprofiled
    n_mean = float(torch.stack(ns).float().mean())

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(trainer, data, h, w)
        torch.cuda.synchronize()
    dev = torch.autograd.DeviceType.CUDA
    avg = [e for e in prof.key_averages() if e.device_type == dev]
    kernels = sorted((e for e in avg if not _is_annotation(e)),
                     key=lambda e: e.device_time_total, reverse=True)

    def per_step(total_us):
        return total_us / 1e3 / steps
    busy = per_step(sum(e.device_time_total for e in kernels))
    # kernel time launched inside each range (its CPU-side event sums the
    # kernels of its children; the GPU-side span would count idle gaps too)
    events = prof.events()
    ranges = {}
    for e in events:
        if e.device_type != dev and e.name in STEP_PARTS + SUB_PARTS:
            ranges[e.name] = ranges.get(e.name, 0.0) + \
                per_step(e.device_time_total)
    # the refresh launches K1 through ctypes under no torch op, so no CPU
    # event claims it: take the K1 launches inside the refresh's device span
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == dev and e.name == "grid_refresh"]
    ranges["grid_refresh"] = ranges.get("grid_refresh", 0.0) + per_step(sum(
        e.time_range.elapsed_us() for e in events
        if e.device_type == dev and "field_fwd_kernel" in e.name
        and any(a <= e.time_range.start < b for a, b in spans)))
    k1 = per_step(sum(e.device_time_total for e in kernels
                      if "field_fwd_kernel" in e.key))
    k2 = per_step(sum(e.device_time_total for e in kernels
                      if "field_bwd_kernel" in e.key))
    backward = busy - sum(ranges.get(p, 0.0) for p in STEP_PARTS)
    occ = trainer.grid_state["occ"].float().mean().item()
    print(f"train step at step {trainer.global_step - 2 * steps} "
          f"({trainer.opt.num_rays} rays, windows of {steps} steps): wall "
          f"{wall:.3f} ms/step (unprofiled), device busy {busy:.3f} ms/step "
          f"(profiled), idle share {1 - busy / wall:.3f}; mean field "
          f"samples {n_mean:.0f}/step; occupancy {occ:.4f}", flush=True)
    for part in STEP_PARTS[:3] + SUB_PARTS + STEP_PARTS[3:]:
        print(f"  {part:13s} {ranges.get(part, 0.0):9.3f} ms/step")
    print(f"  {'K1 (all)':13s} {k1:9.3f} ms/step (forward and grid refresh)")
    print(f"  {'backward':13s} {backward:9.3f} ms/step, of it K2 {k2:.3f} "
          f"ms/step ({n_mean / max(k2, 1e-9) * 1e3:.4g} samples/s)")
    for e in kernels[:12]:
        print(f"{per_step(e.device_time_total):10.3f} ms/step "
              f"{e.count:6d}x  {e.key[:90]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--at", type=int, nargs="+", default=[64, 448],
                    help="step counts at which a window starts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    ws = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "workspace", "train_profile")
    opt = postprocess(base_parser().parse_args(
        ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--iters",
         "512", "--synthetic_res", "800", "--ckpt", "scratch",
         "--workspace", ws]))
    train, _, _ = load_datasets(opt)
    trainer, _ = build_trainer(opt)
    trainer.mark_untrained_grid(train.poses, train.intrinsics)
    data = train.device(trainer.device)
    h, w = train.h, train.w
    render_fast.march_dense = _ranged("march", render_fast.march_dense)
    render_fast.composite_rays = _ranged("composite",
                                         render_fast.composite_rays)
    for start in sorted(args.at):
        while trainer.global_step < start:
            step(trainer, data, h, w)
        window(trainer, data, h, w, args.steps)


if __name__ == "__main__":
    main()
