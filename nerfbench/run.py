"""Run one cell of the benchmark of sealdnerf_tpu_torch on this machine's
cards and print its result as the last line of standard output.

    python3 nerfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
metrics from a torch.profiler slice of the window. Either way the run
checks what its timed path produced against the plain reference
(nerfbench/reference/) and prints each number compared beside its limit,
as the last lines of standard error and under "checks" in the result.

Without a CUDA card, or with fewer than the cell asks for, it exits with an
error and prints no result. So it does if the process has loaded JAX or the
JAX package by the end of the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# modules that a run may not load, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "sealdnerf_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from nerfbench import harness
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("nerfbench: no CUDA device is available")
    if torch.cuda.device_count() < cell.chips:
        raise SystemExit(f"nerfbench: {cell.name} needs {cell.chips} CUDA "
                         f"devices, this machine has "
                         f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    from nerfbench.work import PEAK
    print(f"nerfbench: {cell.name} seed {args.seed} on {card_line()}; "
          f"rooflines and mfu against the H100 SXM data sheet's "
          f"{PEAK['tensor_flops'] / 1e12:g} TFLOP/s bf16 tensor, "
          f"{PEAK['fp32_flops'] / 1e12:g} TFLOP/s FP32, "
          f"{PEAK['bytes'] / 1e12:g} TB/s at 700 W", file=sys.stderr,
          flush=True)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"nerfbench: the run loaded {', '.join(bad)}")
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
