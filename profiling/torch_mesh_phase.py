#!/usr/bin/env python3
"""Phase 16 of chip_smoke.py (the data mesh) by itself, on the card(s).

    python3 profiling/torch_mesh_phase.py [--one-card]

Builds the kernels and runs chip_smoke.phase_data_parallel on its layout:
one rank a card (up to 4) on a machine with two cards or more, else two
ranks sharing the one card; 16e-h included (the edits of the fields that
the mesh trains, the editor, main_tensoRF and main_CCNeRF on the mesh). With --one-card the same phase first runs on
one rank alone (no process group), and the mesh's rays/s are printed
against that run's. The procedural scenes are made here (~13 s each at
800x800), as chip_smoke.py's earlier phases make them.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--one-card", action="store_true",
                    help="run the phase on one rank first, as the baseline")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_mesh_phase: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke._card(), flush=True)
    from sealdnerf_tpu_torch.ops import build
    t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    one = None
    if args.one_card:
        _, one = chip_smoke.phase_data_parallel(["cuda:0"])
    chip_smoke.phase_data_parallel(one_card=one)


if __name__ == "__main__":
    main()
