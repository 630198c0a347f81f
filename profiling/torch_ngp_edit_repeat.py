"""How often the Instant-NGP edit of chip_smoke.py's phase 11b passes, on
one GPU.

    python3 profiling/torch_ngp_edit_repeat.py [--runs 3]

Trains phase 10's Instant-NGP teacher once (main_nerf --backbone ngp at the
CLI's defaults, 512 steps), then runs phase 11b (main_SealNeRF at its
defaults on that teacher, 2 pretraining and 2 distillation epochs) `runs`
times from the same teacher. Prints, after each pretraining epoch, the
largest |entry| of the student's hash tables; after each run, whether it
passed or the assertion it failed; and at the end how many passed. The
first line is the card's name and power limit.
"""

import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(chip_smoke._card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sealdnerf_tpu_torch.editing.student import StudentTrainer
    chip_smoke.phase_ngp_training()
    pre = StudentTrainer.pretrain_one_epoch

    def watched(self):
        loss = pre(self)
        print(f"pretraining epoch: loss {loss:.5g}, max |hash entry| "
              f"{self.params['grid'].abs().max().item():.5g}", flush=True)
        return loss

    StudentTrainer.pretrain_one_epoch = watched
    passed = 0
    for run in range(args.runs):
        # a fresh student each run (main_SealNeRF resumes its workspace)
        shutil.rmtree(os.path.join(chip_smoke.REPO, "workspace",
                                   "chip_smoke_ngp_edit"), ignore_errors=True)
        try:
            chip_smoke.phase_ngp_edit(
                False, os.path.join(chip_smoke.REPO, "workspace",
                                    "chip_smoke_ngp"),
                chip_smoke.NGP_EDIT_EPOCHS_STATIC)
            passed += 1
            print(f"run {run}: passed", flush=True)
        except AssertionError as e:
            print(f"run {run}: failed: {e}", flush=True)
        torch.cuda.empty_cache()
    print(f"phase 11b passed {passed} of {args.runs} runs on one teacher",
          flush=True)


if __name__ == "__main__":
    main()
