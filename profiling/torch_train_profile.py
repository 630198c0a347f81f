"""Where the time of a warm full-width training step goes, for the
PyTorch/CUDA port on one GPU.

    python3 profiling/torch_train_profile.py [--steps 16] [--at 64 448]
                                             [--dynamic | --bound2]

Builds the trainer as chip_smoke.py's training phase does (synthetic -O
--bound 1 --dt_gamma 0 --iters 512, seeded init, 48 train views at
800x800, 4096 rays per step) and trains. At each step count of `--at` it
times a window of `steps` steps unprofiled (one grid refresh per 16 steps
falls inside it), then profiles a second window of the same length with
torch.profiler. Per window it prints, per step: wall ms, device busy ms,
the idle share (1 - busy / wall), the mean field samples, the occupancy,
the peak device memory that torch allocated over the unprofiled window,
and the device ms of each part of the step -- grid refresh (amortised over
the window), ray and pixel sampling, the forward (march, K1, compositing),
the backward (K2 and the autograd of the march and compositing ops), Adam,
the lr schedule and the EMA -- then the top kernels by device time. The
first line is the card's name and power limit.

--dynamic profiles dynamic (CP-D-NeRF) training instead: the trainer of
chip_smoke.py's dynamic training phase (main_dnerf's defaults: two learning
rates, time curriculum, anneal, deform regulariser). The forward is then
the march, K3 and compositing, the backward holds K4 (K3's two and K4's six
device kernels are listed one by one), a grid refresh is 8 time bins through K3
density-only and fires every 2 steps until step 256 and every 4 after it,
and the regulariser's tower (plain PyTorch) has a range of its own for its
forward; its backward is in the backward's rest.

--bound2 profiles the static step at the CLI's defaults instead (bound 2,
dt_gamma 1/128: no VM planes, two cascades, the cascade march), as
chip_smoke.py's phase 9 trains it.
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
SUB_PARTS = ("march", "composite", "zero_reg")
K4_KERNELS = ("compact_live_kernel", "warp_kernel", "field_bwd_kernel",
              "tower_bwd_kernel", "tower_wgrad_kernel", "time_rows_kernel")
# K3 runs two device kernels behind one entry: the warp, then K1's kernel
K3_KERNELS = ("deform_fwd_kernel", "field_fwd_kernel")


def _ranged(name, fn):
    def wrapped(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return wrapped


def step(trainer, data, h, w):
    """One training step, as FastTrainer.train_step runs it, with a
    profiler range around each part. Returns the step's field samples."""
    params = None
    if trainer.time_conditioned:
        params = trainer._anneal_params(trainer.params, trainer.global_step)
        if trainer.dyn_refresh_due(trainer.global_step,
                                   trainer._dyn_host_counts()[0]):
            with record_function("grid_refresh"):
                trainer.refresh_grid(params)
    elif trainer.global_step % trainer.opt.update_extra_interval == 0:
        with record_function("grid_refresh"):
            trainer.refresh_grid()
    with record_function("sample"):
        batch = trainer.sample_batch(data, h, w)
    with record_function("forward"):
        loss, n_samples = trainer.loss_on(*batch, params=params)
    trainer.optimizer.zero_grad(set_to_none=True)
    loss.backward()           # K2 / K4 launch from the autograd thread
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
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ns = [step(trainer, data, h, w) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps           # unprofiled
    peak = torch.cuda.max_memory_allocated() / 2**20
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
    # the refresh launches the forward kernel (K1, or K3 of a dynamic field)
    # through ctypes under no torch op, so no CPU event claims it: take its
    # launches inside the refresh's device span
    dyn = trainer.time_conditioned
    fwd_names = K3_KERNELS if dyn else ("field_fwd_kernel",)
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == dev and e.name == "grid_refresh"]
    in_refresh = per_step(sum(
        e.time_range.elapsed_us() for e in events
        if e.device_type == dev and any(k in e.name for k in fwd_names)
        and any(a <= e.time_range.start < b for a, b in spans)))
    ranges["grid_refresh"] = ranges.get("grid_refresh", 0.0) + in_refresh
    k1 = per_step(sum(e.device_time_total for e in kernels
                      if any(k in e.key for k in fwd_names)))
    k2 = per_step(sum(e.device_time_total for e in kernels
                      if any(k in e.key for k in K4_KERNELS)))
    backward = busy - sum(ranges.get(p, 0.0) for p in STEP_PARTS)
    occ = trainer.grid_state["occ"].float().mean().item()
    n_refresh = len(spans)
    print(f"train step at step {trainer.global_step - 2 * steps} "
          f"({trainer.opt.num_rays} rays, windows of {steps} steps): wall "
          f"{wall:.3f} ms/step (unprofiled), device busy {busy:.3f} ms/step "
          f"(profiled), idle share {1 - busy / wall:.3f}; mean field "
          f"samples {n_mean:.0f}/step; occupancy {occ:.4f}; {n_refresh} "
          f"grid refreshes in the profiled window; peak device memory "
          f"{peak:.1f} MiB (unprofiled window)", flush=True)
    for part in STEP_PARTS[:3] + SUB_PARTS + STEP_PARTS[3:]:
        print(f"  {part:13s} {ranges.get(part, 0.0):9.3f} ms/step")
    fwd, bwd = ("K3", "K4") if dyn else ("K1", "K2")
    print(f"  {fwd + ' (all)':13s} {k1:9.3f} ms/step: forward "
          f"{k1 - in_refresh:.3f}, grid refresh {in_refresh:.3f}")
    print(f"  {'backward':13s} {backward:9.3f} ms/step, of it {bwd} {k2:.3f} "
          f"ms/step ({n_mean / max(k2, 1e-9) * 1e3:.4g} samples/s)")
    if dyn:
        for tag, names in (("K3", K3_KERNELS), ("K4", K4_KERNELS)):
            for name in names:
                t = per_step(sum(e.device_time_total for e in kernels
                                 if name in e.key))
                print(f"    {tag} {name:18s} {t:9.3f} ms/step")
    for e in kernels[:12]:
        print(f"{per_step(e.device_time_total):10.3f} ms/step "
              f"{e.count:6d}x  {e.key[:90]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--at", type=int, nargs="+", default=[64, 448],
                    help="step counts at which a window starts")
    ap.add_argument("--dynamic", action="store_true",
                    help="profile dynamic (CP-D-NeRF) training")
    ap.add_argument("--bound2", action="store_true",
                    help="profile static training at the CLI's defaults "
                         "(bound 2, dt_gamma 1/128)")
    args = ap.parse_args()
    if args.dynamic and args.bound2:
        raise SystemExit("dynamic training serves bound <= 1 only")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    ws = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "workspace", "train_profile")
    recipe = [] if args.bound2 else ["--bound", "1", "--dt_gamma", "0"]
    argv = ["synthetic", "-O", *recipe, "--iters", "512", "--synthetic_res",
            "800", "--ckpt", "scratch", "--workspace", ws]
    if args.dynamic:
        from sealdnerf_tpu_torch import main_dnerf
        opt = main_dnerf.parse_args(argv)
        train, _, _ = load_datasets(opt, with_time=True)
        trainer, field = build_trainer(opt, dynamic=True, lr_net=opt.lr_net)
        # what FastTrainer.train does before its first step
        trainer.opt.time_curriculum_steps = trainer.resolve_time_curriculum(
            trainer.opt.time_curriculum_steps, train.times)
        train = trainer.enable_time_curriculum(train)
        field.deform_raw = _ranged("zero_reg", field.deform_raw)
    else:
        opt = postprocess(base_parser().parse_args(argv))
        train, _, _ = load_datasets(opt)
        trainer, _ = build_trainer(opt)
    trainer.mark_untrained_grid(train.poses, train.intrinsics)
    data = train.device(trainer.device)
    h, w = train.h, train.w
    if args.dynamic:
        from sealdnerf_tpu_torch.ops.marching_dense import downsample_occ
        trainer._occ_m = downsample_occ(trainer.grid_state["occ"][:, 0],
                                        trainer.march_cfg.march_res)
    render_fast.march_dense = _ranged("march", render_fast.march_dense)
    render_fast.composite_rays = _ranged("composite",
                                         render_fast.composite_rays)
    for start in sorted(args.at):
        while trainer.global_step < start:
            step(trainer, data, h, w)
        window(trainer, data, h, w, args.steps)


if __name__ == "__main__":
    main()
