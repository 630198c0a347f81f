"""Where the time of one served 800x800 frame and of one full occupancy-grid
sweep goes, for the PyTorch/CUDA port on one GPU.

    python3 profiling/torch_render_profile.py [--dynamic] [--trained
                                              [--bound2]]

Serves the seeded field as chip_smoke.py does (synthetic -O --bound 1
--dt_gamma 0 --test --synthetic_res 800) and rebuilds the occupancy grid.
For the 128^3 grid sweep and for one frame it times one warm unprofiled
run, then profiles one more with torch.profiler and prints device time by
kernel, the field kernels' share of it, and the idle share (1 - device busy
time of the profiled run / wall time of the unprofiled one). The first line
is the card's name and power limit.

--dynamic does the same for the time-conditioned field of chip_smoke.py's
dynamic phases (the seeded field with its deform tower re-gained): one
rebuild of all 64 time bins of the grid, and one frame at the first val
view's time.

--trained first trains the field 512 steps as chip_smoke.py's phase 5 (7
with --dynamic; 9, the CLI's defaults at bound 2, with --bound2) does, then
profiles three frames of the first val view (at t = 0.5 for the dynamic
field): tiled, bucketed with the termination trim (what render_image
serves below 15 % occupancy) and the LOD preview (test_gui without depth).
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from sealdnerf_tpu_torch.cli import (base_parser, build_trainer,  # noqa: E402
                                     load_datasets, postprocess)


def report(label, fn, top=15):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3     # unprofiled
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    # the dynamic entry runs the warp, then the static entry's kernel
    warp_ms = sum(e.device_time_total for e in events
                  if "deform_fwd_kernel" in e.key) / 1e3
    field_ms = warp_ms + sum(e.device_time_total for e in events
                             if "field_fwd_kernel" in e.key) / 1e3
    print(f"{label}: wall {wall_ms:.2f} ms (unprofiled), device busy "
          f"{busy_ms:.2f} ms (profiled run), idle share "
          f"{1 - busy_ms / wall_ms:.3f}; field kernel {field_ms:.2f} ms "
          f"({field_ms / busy_ms:.3f} of device busy), of it the deform "
          f"tower {warp_ms:.2f} ms")
    for e in events[:top]:
        print(f"{e.device_time_total / 1e3:10.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")


def trained(ws, recipe):
    from torch_bucket_ladder import train_field
    t0 = time.perf_counter()
    trainer, val = train_field(recipe, ws)
    occ = trainer.grid_state["occ"].float().mean().item()
    print(f"trained {trainer.global_step} steps in "
          f"{time.perf_counter() - t0:.1f} s (data included); occupancy "
          f"{occ:.4f}, bucketed pick {trainer._use_buckets()}")
    t = 0.5 if trainer.time_conditioned else None
    pose, intr = val.poses[0], val.intrinsics
    for label, kw in (("tiled", {"buckets": False}),
                      ("bucketed (eval ladder, trim)", {"buckets": True}),
                      ("LOD preview (preview ladder, trim)",
                       {"buckets": True, "lod": True})):
        report(f"trained frame {val.h}x{val.w}, {label}",
               lambda: trainer.render_image(pose, intr, val.h, val.w, time=t,
                                            **kw))


def dynamic(ws):
    import chip_smoke
    from sealdnerf_tpu_torch import main_dnerf
    opt = main_dnerf.parse_args(
        ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--test",
         "--synthetic_res", "800", "--ckpt", "scratch", "--workspace", ws])
    train, _, val = load_datasets(opt, with_time=True)
    trainer, field = build_trainer(opt, dynamic=True, lr_net=opt.lr_net)
    trainer._set_params(chip_smoke._dyn_seeded_params(0, field.cfg, "cuda"))
    trainer.ema_params = None
    trainer.mark_untrained_grid(train.poses, train.intrinsics)
    g = trainer.dyn_grid_cfg
    report(f"dynamic grid rebuild {g.time_size} x {g.grid_size}^3",
           trainer.rebuild_grid, top=10)
    t = float(val.times[0])
    report(f"dynamic frame {val.h}x{val.w} at t={t:.4f}",
           lambda: trainer.render_image(val.poses[0], val.intrinsics, val.h,
                                        val.w, time=t))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dynamic", action="store_true",
                    help="profile the time-conditioned field instead")
    ap.add_argument("--trained", action="store_true",
                    help="train 512 steps, then profile trained frames")
    ap.add_argument("--bound2", action="store_true",
                    help="with --trained: the CLI's default recipe")
    args = ap.parse_args()
    if args.dynamic and args.bound2:
        raise SystemExit("dynamic fields serve bound <= 1 only")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    ws = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "workspace", "render_profile")
    if args.trained:
        recipe = "dynamic" if args.dynamic else \
            "bound2" if args.bound2 else "static"
        return trained(ws + "_trained", recipe)
    if args.dynamic:
        return dynamic(ws + "_dyn")
    opt = postprocess(base_parser().parse_args(
        ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--test",
         "--synthetic_res", "800", "--ckpt", "scratch", "--workspace", ws]))
    train, val, _ = load_datasets(opt)
    trainer, _ = build_trainer(opt)
    trainer.mark_untrained_grid(train.poses, train.intrinsics)
    report(f"grid sweep {trainer.grid_cfg.grid_size}^3", trainer.rebuild_grid,
           top=10)
    report(f"frame {val.h}x{val.w}",
           lambda: trainer.render_image(val.poses[0], val.intrinsics, val.h,
                                        val.w))


if __name__ == "__main__":
    main()
