#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--ckpt PATH]

Phases (any failure raises and exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit.
  2. build: compiles the port's CUDA kernels from sealdnerf_tpu_torch/ops/csrc
     (one nvcc per source, all at once, then one link).
  3. kernel vs plain: the field kernel (K1) against its plain PyTorch
     version at the full default CPConfig on 2^20 + 37 samples, in three
     variants (full, density_only, lod_skip=(3,)), with timings.
  3b. backward kernel vs plain: the field backward kernel (K2) against its
     plain version at the full default CPConfig on 4096 * 64 + 37 samples
     (one train step's worth plus a ragged tail), per param leaf within
     1e-2 * max |plain|, with timings.
  4. served path: cli.build_trainer on `synthetic -O --bound 1 --dt_gamma 0
     --test --synthetic_res 800` (seeded init, or --ckpt), frustum marking
     and two full 128^3 occupancy sweeps (the first is timed cold, the
     second warm), evaluate on the val views at 800x800;
     the kernel must have been launched in the sweep and in the render, the
     frames must be finite, and one view rendered through the plain field
     must agree with the kernel frame to >= 40 dB PSNR.
  5. training: cli.build_trainer on `synthetic -O --bound 1 --dt_gamma 0
     --iters 512 --ckpt scratch` and FastTrainer.train on phase 4's 48
     train views (800x800 RGBA) at 4096 rays per step, then evaluate on the
     val views. Losses must be finite, K2 must launch at least once per
     step, the mean loss of the last 64 steps must be below half that of
     the first 64, and the val PSNR at least 5 dB above phase 4's.
  5b. one train step, kernel vs plain: the same rays, background and noise
     through K1/K2 and through their plain versions on the card; loss
     within rtol 1e-4, grads per leaf within 1e-2 * max |plain|, and the
     plain run launches no kernel.
The launch counts of the kernels record are read from the main paths'
runs (phases 4 and 5), with the counters set to 0 just before each. The
line before last is a JSON record of the kernels; the last line is
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
# K2 vs plain, per grad leaf relative to max |plain|: atomics change the
# order of the f32 sums, and 1-ulp differences in exp, sigmoid, sin and cos
# can flip single bf16 roundings
GRAD_TOL = 1e-2
TRAIN_STEPS = 512


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


def _grad_errs(got, ref):
    """Max |got - ref| / max |ref| per leaf group, and the largest
    absolute difference of any leaf."""
    from sealdnerf_tpu_torch.models.cp import param_leaves
    groups = {"lines": ("lines",), "planes": ("planes",),
              "vm_lines": ("vm_lines",), "towers": ("sigma_mlp", "color_mlp")}
    ratios, max_abs = {}, 0.0
    for name, keys in groups.items():
        for k in keys:
            for a, b in zip(param_leaves(got.get(k, [])),
                            param_leaves(ref.get(k, []))):
                if a.shape != b.shape:
                    raise AssertionError(f"{k}: shape {tuple(a.shape)} != "
                                         f"{tuple(b.shape)}")
                diff = (a - b).abs().max().item()
                max_abs = max(max_abs, diff)
                ratios[name] = max(ratios.get(name, 0.0),
                                   diff / max(b.abs().max().item(), 1e-30))
    return ratios, max_abs


def phase_backward_vs_plain():
    import torch
    from sealdnerf_tpu_torch.models.cp import CPConfig, init_cp
    from sealdnerf_tpu_torch.ops.field import (field_backward,
                                               field_backward_plain,
                                               pack_tables)
    cfg = CPConfig()
    tables = pack_tables(init_cp(torch.Generator().manual_seed(0), cfg,
                                 "cuda"), cfg)
    m = 4096 * 64 + 37
    rng = np.random.default_rng(1)
    x3 = rng.uniform(-1.0, 1.0, (3, m)).astype(np.float32)
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    g = rng.normal(size=(4, m)).astype(np.float32)
    x3, d3, g = (torch.from_numpy(a).cuda() for a in (x3, d3, g))
    before = field_backward.launches
    got = field_backward(tables, cfg, x3, d3, g)
    ref = field_backward_plain(tables, cfg, x3, d3, g)
    torch.cuda.synchronize()
    if field_backward.launches != before + 1:
        raise AssertionError("K2 did not launch exactly once")
    ratios, max_abs = _grad_errs(got, ref)
    ms = _cuda_ms(lambda: field_backward(tables, cfg, x3, d3, g), 10)
    pms = _cuda_ms(lambda: field_backward_plain(tables, cfg, x3, d3, g), 3)
    print(f"K2: M={m} max|k-p|/max|p| "
          + " ".join(f"{k} {v:.3g}" for k, v in ratios.items())
          + f"; max|err| {max_abs:.3g}; kernel {ms:.3f} ms "
          f"({m / ms * 1e3:.4g} samples/s), plain {pms:.3f} ms "
          f"({m / pms * 1e3:.4g} samples/s); launches "
          f"{field_backward.launches}", flush=True)
    bad = {k: v for k, v in ratios.items() if not v <= GRAD_TOL}
    if bad:
        raise AssertionError(f"K2 vs plain beyond {GRAD_TOL}: {bad}")
    return {"ms": ms, "plain_ms": pms, "max_abs_err": max_abs}


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
    return {"launches": launches, "psnr": result, "train": train, "val": val}


def phase_training(served):
    import torch
    from sealdnerf_tpu_torch.cli import base_parser, build_trainer, postprocess
    from sealdnerf_tpu_torch.ops.field import field_backward, field_forward

    train, val = served["train"], served["val"]
    argv = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--iters",
            str(TRAIN_STEPS), "--ckpt", "scratch", "--workspace",
            os.path.join(REPO, "workspace", "chip_smoke_train")]
    opt = postprocess(base_parser().parse_args(argv))
    trainer, _ = build_trainer(opt, name="ngp")
    steps_per_epoch = max(len(train), trainer.opt.segment_steps)
    field_forward.launches = 0
    field_backward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(train, None, int(np.ceil(opt.iters / len(train))))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = field_forward.launches, field_backward.launches
    hist = trainer.history
    losses = np.asarray(hist["loss"])
    steps = len(losses)
    if steps != TRAIN_STEPS or trainer.global_step != TRAIN_STEPS:
        raise AssertionError(f"trained {steps} steps, not {TRAIN_STEPS}")
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite training loss")
    if k2 < steps:
        raise AssertionError(f"K2 launched {k2} times in {steps} steps")
    warm_s = sum(hist["epoch_s"][1:])
    warm_steps = steps - steps_per_epoch
    ms_step = warm_s / warm_steps * 1e3
    first, last = losses[:64].mean(), losses[-64:].mean()
    occ = trainer.grid_state["occ"].float().mean().item()
    print(f"train: {steps} steps x {trainer.opt.num_rays} rays in {wall:.2f} s"
          f" ({len(hist['epoch_s'])} epochs of {steps_per_epoch}); "
          f"{ms_step:.3f} ms/step, "
          f"{trainer.opt.num_rays * 1e3 / ms_step:.1f} rays/s over epochs "
          f"2-{len(hist['epoch_s'])}; first epoch {hist['epoch_s'][0]:.2f} s;"
          f" mean n_samples/step {np.mean(hist['n_samples']):.1f}; occupancy "
          f"{occ:.4f}; launches K1 {k1} K2 {k2}; loss first 64 {first:.6f} "
          f"last 64 {last:.6f}", flush=True)
    if not last < 0.5 * first:
        raise AssertionError(f"loss did not halve: {first} -> {last}")
    psnr = trainer.evaluate(val)
    print(f"train: val PSNR {psnr:.3f} dB after {steps} steps (seeded field "
          f"{served['psnr']:.3f} dB)", flush=True)
    if not psnr >= served["psnr"] + 5.0:
        raise AssertionError(f"val PSNR {psnr:.3f} not 5 dB above the seeded "
                             f"field's {served['psnr']:.3f}")
    return trainer, k1, k2


def phase_one_step(trainer, train):
    import torch
    from sealdnerf_tpu_torch.models.cp import param_leaves, unflatten_like
    from sealdnerf_tpu_torch.ops.field import field_backward, field_forward

    batch = trainer.sample_batch(train.device("cuda"), train.h, train.w)
    out = []
    for plain in (False, True):
        for p in param_leaves(trainer.params):
            p.grad = None
        k1, k2 = field_forward.launches, field_backward.launches
        loss, n = trainer.loss_on(*batch, plain=plain)
        loss.backward()
        torch.cuda.synchronize()
        launched = (field_forward.launches - k1, field_backward.launches - k2)
        if launched != ((0, 0) if plain else (1, 1)):
            raise AssertionError(f"plain={plain}: kernel launches {launched}")
        out.append((loss.item(), unflatten_like(
            trainer.params, [p.grad.clone()
                             for p in param_leaves(trainer.params)])))
    (lk, gk), (lp, gp) = out
    ratios, max_abs = _grad_errs(gk, gp)
    print(f"one step: {int(n)} samples; loss kernel {lk:.8f} plain {lp:.8f};"
          f" grads max|k-p|/max|p| "
          + " ".join(f"{k} {v:.3g}" for k, v in ratios.items()), flush=True)
    if abs(lk - lp) > 1e-4 * abs(lp):
        raise AssertionError(f"loss kernel {lk} vs plain {lp}")
    bad = {k: v for k, v in ratios.items() if not v <= GRAD_TOL}
    if bad:
        raise AssertionError(f"train-step grads beyond {GRAD_TOL}: {bad}")


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
            .splitlines()
            if l.startswith("== ") or "registers" in l or "spill" in l]
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}; "
          + " | ".join(regs), flush=True)

    rec = phase_kernel_vs_plain()
    rec_bwd = phase_backward_vs_plain()
    served = phase_served_path(args.ckpt)
    trainer, k1_train, k2_train = phase_training(served)
    phase_one_step(trainer, served["train"])

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "field_fwd", "route": "cuda",
        "source": "sealdnerf_tpu_torch/ops/csrc/field_fwd.cu",
        "replaces": "sealdnerf_tpu/ops/pallas_field.py:185",
        "launches": served["launches"] + k1_train,
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"]}, {
        "name": "field_bwd", "route": "cuda",
        "source": "sealdnerf_tpu_torch/ops/csrc/field_bwd.cu",
        "replaces": "sealdnerf_tpu/ops/pallas_field.py:574",
        "launches": k2_train, "max_abs_err": rec_bwd["max_abs_err"],
        "ms": rec_bwd["ms"], "plain_ms": rec_bwd["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
