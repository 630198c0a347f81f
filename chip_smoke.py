#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--ckpt PATH]

Phases (any failure raises and exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit.
  2. build: compiles the port's CUDA kernels from sealdnerf_tpu_torch/ops/csrc.
  3. kernel vs plain: the field kernel (K1) against its plain PyTorch
     version at the full default CPConfig on 2^20 + 37 samples, in three
     variants (full, density_only, lod_skip=(3,)), with timings.
  4. served path: cli.build_trainer on `synthetic -O --bound 1 --dt_gamma 0
     --test --synthetic_res 800` (seeded init, or --ckpt), frustum marking
     and two full 128^3 occupancy sweeps (the first is timed cold, the
     second warm), evaluate on the val views at 800x800;
     the kernel must have been launched in the sweep and in the render, the
     frames must be finite, and one view rendered through the plain field
     must agree with the kernel frame to >= 40 dB PSNR.
The line before last is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# (rtol, atol) per output: sigma, rgb -- the reference package's own
# tolerances for this kernel (bf16 rounding and summation order)
TOL = {"sigma": (2e-2, 1e-4), "rgb": (2e-2, 1e-3)}


def _cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


def _check_close(name, got, ref):
    rtol, atol = TOL[name]
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()) or not bool(got.isfinite().all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} values outside "
            f"rtol {rtol} atol {atol}; max abs err {err.max().item():.3g}")
    return err.max().item()


def phase_kernel_vs_plain():
    import torch
    from sealdnerf_tpu_torch.models.cp import CPConfig, init_cp
    from sealdnerf_tpu_torch.ops.field import (field_forward,
                                               field_forward_plain,
                                               pack_tables)
    cfg = CPConfig()
    tables = pack_tables(init_cp(torch.Generator().manual_seed(0), cfg,
                                 "cuda"), cfg)
    m = (1 << 20) + 37
    rng = np.random.default_rng(0)
    x3 = rng.uniform(-1.0, 1.0, (3, m)).astype(np.float32)
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    x3, d3 = torch.from_numpy(x3).cuda(), torch.from_numpy(d3).cuda()
    max_err, rec = 0.0, {}
    for tag, kw in (("full", {}), ("density_only", {"density_only": True}),
                    ("lod_skip=(3,)", {"lod_skip": (3,)})):
        out = field_forward(tables, cfg, x3, d3, **kw)
        ref = field_forward_plain(tables, cfg, x3, d3, **kw)
        torch.cuda.synchronize()
        e_s = _check_close("sigma", out[0], ref[0])
        e_c = 0.0 if kw.get("density_only") else \
            _check_close("rgb", out[1:4], ref[1:4])
        ms = _cuda_ms(lambda: field_forward(tables, cfg, x3, d3, **kw), 10)
        pms = _cuda_ms(lambda: field_forward_plain(tables, cfg, x3, d3, **kw),
                       3)
        max_err = max(max_err, e_s, e_c)
        print(f"K1 {tag}: M={m} max|err| sigma {e_s:.3g} rgb {e_c:.3g}; "
              f"kernel {ms:.3f} ms ({m / ms * 1e3:.4g} samples/s), plain "
              f"{pms:.3f} ms ({m / pms * 1e3:.4g} samples/s)", flush=True)
        if tag == "full":
            rec = {"ms": ms, "plain_ms": pms}
    rec["max_abs_err"] = max_err
    return rec


def phase_served_path(ckpt):
    import torch
    from sealdnerf_tpu_torch.cli import (base_parser, build_trainer,
                                         load_datasets, postprocess)
    from sealdnerf_tpu_torch.ops.field import field_forward, \
        field_forward_plain
    from sealdnerf_tpu_torch.ops.marching_dense import downsample_occ
    from sealdnerf_tpu_torch.render.fast_image import render_image_tiled
    from sealdnerf_tpu_torch.train.metrics import psnr

    argv = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--test",
            "--synthetic_res", "800", "--ckpt", ckpt or "scratch",
            "--workspace", os.path.join(REPO, "workspace", "chip_smoke")]
    opt = postprocess(base_parser().parse_args(argv))
    t0 = time.perf_counter()
    train, val, _ = load_datasets(opt)
    print(f"data: {len(train)} train / {len(val)} val views at "
          f"{val.h}x{val.w} in {time.perf_counter() - t0:.2f} s", flush=True)

    field_forward.launches = 0
    trainer, field = build_trainer(opt, name="ngp")
    trainer.mark_untrained_grid(train.poses, train.intrinsics)
    sweep_ms = []
    for _ in range(2):                     # the first sweep is a cold start
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.rebuild_grid()
        torch.cuda.synchronize()
        sweep_ms.append((time.perf_counter() - t0) * 1e3)
    n_sweep = field_forward.launches
    occ = trainer.grid_state["occ"]
    print(f"grid sweep: {trainer.grid_cfg.grid_size}^3 cells in "
          f"{sweep_ms[0]:.2f} ms (first), {sweep_ms[1]:.2f} ms (second), "
          f"{n_sweep} kernel launches, occupancy "
          f"{occ.float().mean().item():.4f}", flush=True)

    result = trainer.evaluate(val)
    times, frames = [], []
    for i in range(len(val)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, depth = trainer.render_image(val.poses[i], val.intrinsics,
                                          val.h, val.w)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        frames.append(img)
    launches = field_forward.launches
    n_render = launches - n_sweep
    if n_sweep < 1 or n_render < 1:
        raise AssertionError(f"kernel launches: sweep {n_sweep}, render "
                             f"{n_render}; both must be >= 1")
    for img in frames:
        if img.shape != (val.h, val.w, 3) or not np.isfinite(img).all():
            raise AssertionError(f"bad frame {img.shape}")
    if not np.isfinite(result):
        raise AssertionError(f"evaluate PSNR {result}")
    spf = val.h * val.w * trainer.render_cfg.samples_per_ray
    ms_k = float(np.mean(times))
    print(f"render: {len(val)} frames at {val.h}x{val.w}, tile "
          f"{trainer._pick_tile(val.h, val.w)}, {spf} field samples/frame, "
          f"kernel path {ms_k:.2f} ms/frame (min {min(times):.2f}), "
          f"{n_render} kernel launches; PSNR vs GT {result:.3f} dB "
          f"(seeded field)", flush=True)

    # the same view through the plain field
    cfg, rcfg, dev = field.cfg, trainer.render_cfg, trainer.device
    occ_m = downsample_occ(occ[0], rcfg.march_res)
    pose = torch.as_tensor(val.poses[0], device=dev)
    intr = torch.as_tensor(val.intrinsics, device=dev)
    tables = field.kernel_tables(trainer._infer_params())

    def plain_frame():
        with torch.no_grad():
            img, _ = render_image_tiled(
                tables, occ_m, pose, intr, val.h, val.w, rcfg,
                lambda t, x3, d3: field_forward_plain(t, cfg, x3, d3),
                torch.ones(3, device=dev),
                tile_px=trainer._pick_tile(val.h, val.w),
                dilate=trainer.opt.render_dilate,
                density_scale=trainer.opt.density_scale,
                t_thresh=trainer.opt.t_thresh)
        return img

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img_p = plain_frame().cpu().numpy()
    ms_p = (time.perf_counter() - t0) * 1e3
    if field_forward.launches != launches:
        raise AssertionError("the plain render launched the kernel")
    p = psnr(frames[0], img_p)
    print(f"kernel frame vs plain frame: PSNR {p:.2f} dB, max|diff| "
          f"{np.abs(frames[0] - img_p).max():.3g}; plain path "
          f"{ms_p:.2f} ms/frame", flush=True)
    if p < 40.0:
        raise AssertionError(f"kernel vs plain frame PSNR {p:.2f} < 40 dB")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint to serve (default: seeded init)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from sealdnerf_tpu_torch.ops import build
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    regs = [l.strip() for l in (lib.parent / "nvcc.log").read_text()
            .splitlines() if "registers" in l or "spill" in l]
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}; "
          + " | ".join(regs), flush=True)

    rec = phase_kernel_vs_plain()
    launches = phase_served_path(args.ckpt)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "field_fwd", "route": "cuda",
        "source": "sealdnerf_tpu_torch/ops/csrc/field_fwd.cu",
        "replaces": "sealdnerf_tpu/ops/pallas_field.py:185",
        "launches": launches, "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
