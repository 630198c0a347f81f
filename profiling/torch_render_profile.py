"""Where the time of one served 800x800 frame and of one full occupancy-grid
sweep goes, for the PyTorch/CUDA port on one GPU.

    python3 profiling/torch_render_profile.py

Serves the seeded field as chip_smoke.py does (synthetic -O --bound 1
--dt_gamma 0 --test --synthetic_res 800) and rebuilds the occupancy grid.
For the 128^3 grid sweep and for one frame it times one warm unprofiled
run, then profiles one more with torch.profiler and prints device time by
kernel and the idle share (1 - device busy time of the profiled run / wall
time of the unprofiled one). The first line is the card's name and power
limit.
"""

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
    print(f"{label}: wall {wall_ms:.2f} ms (unprofiled), device busy "
          f"{busy_ms:.2f} ms (profiled run), idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    for e in events[:top]:
        print(f"{e.device_time_total / 1e3:10.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    ws = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "workspace", "render_profile")
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
