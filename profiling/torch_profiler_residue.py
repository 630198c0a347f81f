"""Whether a torch.profiler session slows the steps that one process runs
after it, on one GPU.

    python3 profiling/torch_profiler_residue.py [--runs 2]

Serves the seeded static field as chip_smoke.py's phase 4 does, then, in one
process: `runs` times phase 5 (512 static training steps at 4096 rays, a
step bound by the host's launches), phase 14 (each device kernel of K3 and
K4 timed by itself under torch.profiler with CUDA activity), and `runs`
times phase 5 again. Each phase 5 prints its ms/step over epochs 2-4; the
last line sets the runs after the profiling session against those before
it. The first line is the card's name and power limit.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=2,
                    help="phase 5 runs before and after the profiling")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(chip_smoke._card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sealdnerf_tpu_torch.ops import build
    build.build()
    build.load_library()
    served = chip_smoke.phase_served_path(None)
    ms = {"before": [], "after": []}
    for when in ("before", "after"):
        if when == "after":
            chip_smoke.phase_device_kernels()
        for _ in range(args.runs):
            trainer, _, _ = chip_smoke.phase_training(served)
            del trainer
            torch.cuda.empty_cache()
            ms[when].append(chip_smoke.STEP_MS["5"])
    b, a = (sum(v) / len(v) for v in (ms["before"], ms["after"]))
    print(f"phase 5 ms/step before the profiling session "
          f"{', '.join(f'{v:.3f}' for v in ms['before'])} (mean {b:.3f}); "
          f"after it {', '.join(f'{v:.3f}' for v in ms['after'])} (mean "
          f"{a:.3f}); after / before {a / b:.3f}", flush=True)


if __name__ == "__main__":
    main()
