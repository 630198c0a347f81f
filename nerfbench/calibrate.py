"""Readings that the check's limits are set from: for each seed, the
numbers that the check compares, of the program's run, of the control
(the reference put in the program's place at the nearest precision below
the configuration's bf16 operands: float8 e4m3) and of the faults that
the cell can have, each against the float32 reference.

    python3 nerfbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--seconds 4] [--out chiprun_out/calibrate.jsonl]

All seeds run in one process; each prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell, seed: int, seconds: float, device: str) -> dict:
    """The run of one seed and its readings -> {"program", "control",
    "fault_*": {number: value}, "look", "metrics"}."""
    from nerfbench import harness
    run = harness.Run(cell, seed, seconds, False, device, time.perf_counter())
    try:
        run.set_up()
        run.window()
        metrics = run.end_to_end()
        loop = run.loop
        loop.release()
        loop.reference()
        out = {"seed": seed, "metrics": metrics}
        out.update(loop.readings())
        out.update(getattr(loop, "window_info", {}))
        return out
    finally:
        run.close()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default="")
    args = p.parse_args()
    import torch
    from nerfbench import harness
    if not torch.cuda.is_available():
        raise SystemExit("calibrate: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.Cell(args.workload)
    for s in args.seeds.split(","):
        line = json.dumps(readings(cell, int(s), args.seconds, "cuda"))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
