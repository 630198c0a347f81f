"""How far the bucketed renderer's frame lies from the tiled one on trained
fields, and which part of it costs the fidelity, for the PyTorch/CUDA port
on one GPU.

    python3 profiling/torch_bucket_ladder.py [--recipes static dynamic bound2]

Trains each field 512 steps at full width as chip_smoke.py does (static:
phase 5, `--bound 1 --dt_gamma 0`; dynamic: phase 7, main_dnerf's defaults;
bound2: phase 9, the CLI's defaults), then renders the first val view (at
t = 0.5 for the dynamic field) tiled and bucketed in variants: the eval
ladder with and without the termination trim, the one-bucket ladder (every
tile at the full budget) with and without it, and the preview ladder. Per
variant: ms (host clock, synchronised, after a warm-up frame) and PSNR
against the tiled frame. Per field: the percentiles of the tiles' interval
counts before and after the trim, and the share of tiles whose count
exceeds its bucket's budget under each ladder (those are subsampled). The
first line is the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sealdnerf_tpu_torch.cli import (base_parser, build_trainer,  # noqa: E402
                                     load_datasets, postprocess)
from sealdnerf_tpu_torch.render import fast_image  # noqa: E402
from sealdnerf_tpu_torch.train.metrics import psnr  # noqa: E402

FULL = ((1.0, 1),)


def train_field(recipe, ws):
    """The trainer of `recipe` ("static", "dynamic" or "bound2") after 512
    steps at full width on the 800 px scene, and the val views."""
    from sealdnerf_tpu_torch import main_dnerf
    flags = [] if recipe == "bound2" else ["--bound", "1", "--dt_gamma", "0"]
    argv = ["synthetic", "-O", *flags, "--iters", "512", "--synthetic_res",
            "800", "--ckpt", "scratch", "--workspace", ws]
    if recipe == "dynamic":
        opt = main_dnerf.parse_args(argv)
        train, _, val = load_datasets(opt, with_time=True)
        trainer, _ = build_trainer(opt, dynamic=True, lr_net=opt.lr_net)
    else:
        opt = postprocess(base_parser().parse_args(argv))
        train, val, _ = load_datasets(opt)
        trainer, _ = build_trainer(opt)
    trainer.train(train, None, 16)
    return trainer, val


def _counts(trainer, pose, intr, h, w, t, trim):
    """The tiles' interval counts of the frame, after the trim if asked."""
    rcfg, opt = trainer.render_cfg, trainer.opt
    occ = trainer.grid_state["occ"]
    extra = ()
    if trainer.time_conditioned:
        from sealdnerf_tpu_torch.render.dynamic_grid import time_slice_index
        occ = occ[time_slice_index(t, trainer.dyn_grid_cfg)]
        extra = (t,)
    occ_m = trainer.cascade_occ(occ, rcfg)
    tp = trainer._pick_tile(h, w, pose, intr)
    th, tw = h // tp, w // tp
    pose_t = torch.as_tensor(pose, device=trainer.device)
    intr_t = torch.as_tensor(intr, device=trainer.device)
    to, td, tn, tf = fast_image._tile_rays(pose_t, intr_t, th, tw, tp, rcfg)
    te, dt, iv, _ = fast_image._march_tiles(to, td, tn, tf, occ_m, rcfg,
                                            opt.render_dilate)
    if trim:
        tables = trainer.field.kernel_tables(trainer._infer_params())
        iv = fast_image._termination_trim(
            tables, pose_t, intr_t / tp, th, tw, tp, te, iv,
            dt, rcfg, trainer._render_forward(), opt.density_scale,
            opt.render_term_tau, opt.render_term_intervals, extra,
            stride=opt.render_term_stride)
    return iv.sum(-1).cpu().numpy()


def _over_budget(counts, sc, splits):
    order = np.argsort(counts, kind="stable")
    budgets = np.zeros_like(counts)
    for s0, s1, sc_b in fast_image.bucket_bounds(len(counts), sc, splits):
        budgets[order[s0:s1]] = sc_b
    return float((counts > budgets).mean())


def probe(recipe, ws):
    t0 = time.perf_counter()
    trainer, val = train_field(recipe, ws)
    opt = trainer.opt
    t = 0.5 if trainer.time_conditioned else None
    pose, intr, h, w = val.poses[0], val.intrinsics, val.h, val.w
    occ = trainer.grid_state["occ"].float().mean().item()
    print(f"{recipe}: trained {trainer.global_step} steps in "
          f"{time.perf_counter() - t0:.1f} s "
          f"(data included); occupancy {occ:.4f}", flush=True)

    def frame(**kw):
        trainer.render_image(pose, intr, h, w, time=t, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img, _ = trainer.render_image(pose, intr, h, w, time=t, **kw)
        torch.cuda.synchronize()
        return img, (time.perf_counter() - t1) * 1e3

    tiled, ms_t = frame(buckets=False)
    print(f"  tiled {ms_t:.2f} ms", flush=True)
    eval_l, prev_l, term = (opt.render_splits, opt.render_splits_preview,
                            opt.render_term_intervals)
    rcfg = trainer.render_cfg
    occ = trainer.grid_state["occ"]
    extra = ()
    if trainer.time_conditioned:
        from sealdnerf_tpu_torch.render.dynamic_grid import time_slice_index
        occ = occ[time_slice_index(t, trainer.dyn_grid_cfg)]
        extra = (t,)
    occ_m = trainer.cascade_occ(occ, rcfg)
    pose_t = torch.as_tensor(pose, device=trainer.device)
    intr_t = torch.as_tensor(intr, device=trainer.device)
    for label, splits, trim, lod in (
            ("eval ladder, trim", eval_l, term, False),
            ("eval ladder, no trim", eval_l, 0, False),
            ("one bucket, trim", FULL, term, False),
            ("one bucket, no trim", FULL, 0, False),
            ("preview ladder, trim, LOD", prev_l, term, True)):
        tables = trainer.field.kernel_tables(trainer._infer_params())

        def bucketed():
            with torch.no_grad():
                img, _ = fast_image.render_image_bucketed(
                    tables, occ_m, pose_t, intr_t, h, w, rcfg,
                    trainer._render_forward(lod),
                    torch.ones(3, device=trainer.device),
                    tile_px=trainer._pick_tile(h, w, pose, intr),
                    dilate=opt.render_dilate,
                    density_scale=opt.density_scale, t_thresh=opt.t_thresh,
                    splits=splits, term_probe=trim,
                    term_tau=opt.render_term_tau,
                    term_stride=opt.render_term_stride, extra=extra)
            return img.cpu().numpy()

        bucketed()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = bucketed()
        ms = (time.perf_counter() - t1) * 1e3
        print(f"  {label}: {ms:.2f} ms, PSNR vs tiled {psnr(img, tiled):.2f}"
              " dB", flush=True)
    sc = trainer.render_cfg.n_intervals
    for trim in (False, True):
        c = _counts(trainer, pose, intr, h, w, t, trim)
        q = np.percentile(c, [50, 60, 75, 90, 97, 99, 100])
        print(f"  tile interval counts {'after' if trim else 'before'} the "
              f"trim (budget {sc}): p50/60/75/90/97/99/max "
              + "/".join(f"{v:.0f}" for v in q)
              + f"; over budget: eval ladder "
              f"{_over_budget(c, sc, opt.render_splits):.3f}, preview "
              f"{_over_budget(c, sc, opt.render_splits_preview):.3f}",
              flush=True)
    del trainer
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--recipes", nargs="+",
                    default=["static", "dynamic", "bound2"],
                    choices=["static", "dynamic", "bound2"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "workspace", "bucket_ladder")
    for recipe in args.recipes:
        probe(recipe, f"{root}_{recipe}")


if __name__ == "__main__":
    main()
