#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--ckpt PATH]

Phases (any failure raises and exits non-zero):
  1. device: needs CUDA; prints the card's name and power limit.
  2. build: compiles the port's CUDA kernels from sealdnerf_tpu_torch/ops/csrc
     (one nvcc per source, all at once, then one link).
  3. kernel vs plain: the field kernel (K1) against its plain PyTorch
     version at the full default CPConfig on 2^20 + 37 random samples, in
     three variants (full, density_only, lod_skip=(3,)), with timings; the
     features that enter its first product against the plain version's, bit
     for bit; then at the main paths' own shapes, each with its bound: 2^20
     density-only queries of a grid slab in cell order (the unit of a grid
     refresh) and 8,388,608 ray-coherent samples of a pinhole frame (a tenth
     of a served frame).
  3b. backward kernel vs plain: the field backward kernel (K2) against its
     plain version at the full default CPConfig on 4096 * 64 + 37 samples
     (one train step's worth plus a ragged tail). K2 recomputes the forward
     with the forward kernel's own arithmetic: what it recomputed must equal
     K1's output bit for bit at every sample. Its relu masks are therefore
     the forward kernel's, whose sums run in the mma's order, and a few in
     ten thousand samples hold a pre-activation that the plain version's
     sums put on the other side of 0; such a sample's whole share of a
     gradient differs. Every param leaf of the whole call is held within
     5e-2 * max |plain|, and within 1e-2 on the samples that the plain
     version alone calls stable (fragile_samples_plain: no pre-activation
     within its summation noise of 0; the others' cotangents set to 0 for
     both). Timings on random samples and on the same count of ray-coherent
     ones; a narrow config with ranks and channels that are no multiples of
     8, through K1 and K2.
  3c. dynamic kernel vs plain: the dynamic field kernel (K3: deform tower,
     then the canonical field at the warped point) against its plain version
     at the full default CPDNeRFConfig on 2^20 + 37 samples, at t = 0, 0.37
     and 1 in three variants each (full, density_only, lod_skip=(3,)), within
     K1's tolerances, with timings. The seeded deform tower is re-gained
     (see _dyn_seeded_params) so that it warps by ~0.1: the mean |dx| of the
     plain version at t = 0.37 must exceed 1e-2. K3 at t = 0 must equal K1
     on the same canonical params bit for bit, in all three variants. Then
     the main paths' shapes as in phase 3.
  3d. dynamic backward kernel vs plain: the dynamic field backward kernel
     (K4: deform tower recomputed, canonical backward at the warped point,
     tower backward) against its plain version at the full default
     CPDNeRFConfig on 4096 * 64 + 37 samples, with random cotangents of
     which 30 % of the columns are all zero, at t = 0.37 and t = 0. With the
     merely undamped tower (warp 6e-4): per param leaf within 1e-2 * max
     |plain| (the first deform matrix's 13 time rows are under the same
     limit: both round the sum over all samples once) on the samples that
     are stable at the kernel's warped positions (see 3b), and within 5e-2
     on all. With the re-gained
     tower (warp 0.1) the tower's bf16 noise moves a few positions by up to
     half a cell of the finest tables, so end to end it is held to 0.35
     (the reference's envelope for its dynamic kernels against its XLA
     model). With either tower each stage is held on the kernel's own
     input: the warp; the canonical backward and g_x at the kernel's warped
     positions (1e-2); the activations that the tower's backward recomputed
     (at most 2e-3 of the entries differ from the plain chain's at all and
     at most 5e-3 of the samples hold a relu mask that differs); the
     tower's backward on the kernel's own g_x and activations (1e-3 per
     matrix; the time rows, rounded to bf16 after the sum, 1e-2). At t = 0
     every deform gradient must be exactly 0 and the canonical gradients
     within 1e-2 of K2's on the same inputs. Timings of K4, its plain
     version and K2.
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
  6. dynamic served path: a checkpoint of the seeded, re-gained dynamic field
     is written to a temporary directory; main_dnerf's parser and
     cli.build_trainer(dynamic=True) on `synthetic -O --bound 1 --dt_gamma 0
     --test --synthetic_res 800 --ckpt <it>`; frustum marking; a rebuild of
     all 64 time bins of the 128^3 grid through K3 density-only, timed;
     evaluate on the 6 val views at 800x800, each at its own time, timed per
     frame. K3 must have been launched in the rebuild and in the render and
     K1 not at all; every time bin must hold occupied cells; frames finite;
     one view through the plain field must agree with the kernel frame to
     >= 40 dB; one pose rendered at two times must differ.
  7. dynamic training: main_dnerf's parser and cli.build_trainer(
     dynamic=True) on `synthetic -O --bound 1 --dt_gamma 0 --iters 512
     --synthetic_res 800 --ckpt scratch` with the reference's defaults (lr
     1e-2, lr_net 1e-3, time curriculum auto = 512 steps, anneal 1024,
     deform_zero_reg 1e-3) and FastTrainer.train on phase 6's 48 train views
     at 4096 rays per step: the full width, the depth cut from 300,000 steps
     to 512. Losses must be finite; K4 must launch once per step and K2 and
     K1 not at all; K3 once per step and 8 times per grid refresh; the
     number of refresh calls must be what the reference's cadence gives for
     512 steps (192); the mean loss of the last 64 steps below half that of
     the first 64; the val PSNR (each view at its own time) at least 3 dB
     above the seeded field's; and the deform tower alive: mean
     |deform(x, 0.7)| over 4096 scene points larger after training than
     before and above 1e-3. Prints ms/step and rays/s without the first
     epoch, the refreshes' share of the time, the occupancy per bin and the
     ms of one trained 800x800 frame.
  7b. one dynamic train step, kernel vs plain: the same rays, time,
     background, noise and regulariser points through K3/K4 and through
     their plain versions on the card, twice: on the seeded field mid-anneal
     (before phase 7's training; the damped tower warps by 1e-6), loss
     within rtol 1e-4 and grads per leaf within 1e-2 * max |plain|; and on
     the trained field, whose tower warps by ~0.08, so that the tower's
     bf16 noise reaches the finest line tables (see 3d): 5e-2 there. The
     plain runs launch no kernel.
The launch counts of the kernels record are read from the main paths'
runs (phases 4, 5, 6 and 7), with the counters set to 0 just before each. Each
kernel's bound_ms is the least time the card could take for the work of its
vs-plain phase: the larger of bytes moved over the memory rate and
operations over the peak rate of their type (PEAK). The line before last is
a JSON record of the kernels; the last line is {"ok": true, "device": {...}}.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
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
# K2 and K4's canonical stage vs plain over ALL samples, those included whose
# relu masks the mma's summation order flips (see phase 3b): one such sample
# moves an entry of a fine table by its whole share (measured 2.1e-2 to 3.2e-2
# on 262,181 random samples and cotangents; on the stable ones 1.9e-3)
WHOLE_CALL_TOL = 5e-2
# K4 against its plain version end to end with a tower that warps by 0.1:
# the reference's own envelope for its dynamic kernels against its XLA model
# (see phase_dyn_backward_vs_plain)
REGAINED_TOL = 0.35
# K4's tower backward against its plain version on the kernel's own position
# gradient and recomputed activations, per deform matrix relative to max
# |plain| (measured 1.4e-4 to 4.9e-4 over seeds, sizes and towers:
# profiling/torch_dyn_bwd_seeds.py); the time rows apart, see phase 3d
TOWER_STAGE_TOL = 1e-3
# the share of the recomputed hidden activations that may differ at all from
# the plain chain's (measured up to 7.1e-4), and the share of samples that
# may hold a relu mask that differs (measured up to 1.5e-3)
ACT_DIFFER_TOL = 2e-3
ACT_MASK_TOL = 5e-3
# One train step, kernel vs plain, on the TRAINED dynamic field, whose tower
# warps by ~0.08: the same noise, on the few thousand samples of a step that
# carry weight; it shows in the finest line tables only (measured 0.019)
TRAINED_STEP_TOL = 5e-2
TRAIN_STEPS = 512
# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores (the towers' bf16 x
# bf16 -> f32 products), the FP32 pipe (taps, encodings, activations), HBM3
PEAK = {"tensor_flops": 989e12, "fp32_flops": 67e12, "bytes": 3.35e12}
# hidden deform matrices x sqrt(6): keeps the activations' variance through
# the bias-free relu tower (its U(+-1/sqrt(n)) init shrinks it by 6 a layer)
DEFORM_GAIN = 6.0 ** 0.5


def _field_work(cfg, m, mode="fwd", density_only=False, m_live=None,
                lod_skip=()):
    """Bytes moved (each input read once, each output written once) and
    operations, by type, of one field call on m samples. mode: "fwd" (K1),
    "bwd" (K2: recompute, then dX and dW of every product), "dyn" (K3) or
    "dyn_bwd" (K4: K2's work plus the deform tower's recompute, dX and dW).
    m_live: the samples whose cotangent is not all zero, which alone cost a
    backward kernel operations (default: all). lod_skip: line scales whose
    features are zero, which need no taps and no rows of the first matrix."""
    from sealdnerf_tpu_torch.models.cp import _deform_dims, _tower_dims
    sigma, color = _tower_dims(cfg)
    ranks = sum(r for s, (_, r) in enumerate(cfg.scales) if s not in lod_skip)
    skipped = sum(r for _, r in cfg.scales) - ranks
    towers = [sigma] if density_only else [sigma, color]
    macs = sum(a * b for dims in towers for a, b in zip(dims[:-1], dims[1:])) \
        - skipped * sigma[1]
    # gathers: per line rank 3 lerps (3 flops each) and 2 products; per plane
    # channel and pair two 2-tap rows, the cross lerp, the line lerp, 1 product
    taps = 11 * ranks + 13 * sum(3 * c for _, c in cfg.planes)
    enc = 2 * 6 * cfg.freq_degree + (0 if density_only else 60)
    tab_elems = sum(3 * res * r for res, r in cfg.scales) + sum(
        3 * (p * p * c + p * c) for p, c in cfg.planes)
    w_elems = sum(a * b for dims in (sigma, color)
                  for a, b in zip(dims[:-1], dims[1:]))
    nbytes = m * (12 + (0 if density_only else 12) + 16) \
        + 2 * (tab_elems + w_elems)
    tensor, fp32 = 2 * macs * m, (taps + enc) * m
    if mode in ("bwd", "dyn_bwd"):
        live = m if m_live is None else m_live
        tensor, fp32 = 3 * 2 * macs * live, 3 * (taps + enc) * live
        nbytes += m * 16 + 4 * (tab_elems + w_elems)      # g_out in, grads out
    if mode in ("dyn", "dyn_bwd"):
        dd = _deform_dims(cfg)
        nx = cfg.deform_space_dim
        dmacs = nx * dd[1] + sum(a * b for a, b in zip(dd[1:-1], dd[2:]))
        d_elems = dmacs + (dd[0] - nx) * dd[1]
        if mode == "dyn":
            tensor += 2 * dmacs * m
            fp32 += 2 * 6 * cfg.multires_deform * m
            nbytes += 2 * d_elems
        else:
            # the warp's recompute, dX and dW, each of the live samples only:
            # a sample whose cotangent is all zero needs no warp either
            tensor += 2 * dmacs * 3 * live
            fp32 += 2 * 6 * cfg.multires_deform * 2 * live
            nbytes += (2 + 4) * d_elems
    return nbytes, tensor, fp32


def _bound(cfg, m, **kw):
    nbytes, tensor, fp32 = _field_work(cfg, m, **kw)
    t_bytes = nbytes / PEAK["bytes"] * 1e3
    t_ops = (tensor / PEAK["tensor_flops"] + fp32 / PEAK["fp32_flops"]) * 1e3
    # beside it, for scale: the same operations all on the FP32 pipe
    t_fp32 = (tensor + fp32) / PEAK["fp32_flops"] * 1e3
    print(f"bound ({kw.get('mode', 'fwd')}, M={m}): {nbytes / 1e6:.2f} MB -> "
          f"{t_bytes:.4f} ms; {tensor / 1e9:.2f} GFLOP bf16 x bf16 -> f32 + "
          f"{fp32 / 1e9:.2f} GFLOP f32 -> {t_ops:.4f} ms at the tensor-core "
          f"peak, {t_fp32:.4f} ms with all of it on the FP32 pipe",
          flush=True)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


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


def _slab_samples(h=128, bound=1.0, seed=0):
    """x3 [3, h^3 / 2]: the queries of one bin of a dynamic grid refresh
    while it warms up, cell by cell in grid order, jittered inside the cell
    (render/dynamic_grid.py refresh_dyn_density_grid)."""
    import torch
    from sealdnerf_tpu_torch.render.grid import _coords_of
    half = bound / h
    idx = torch.arange(h ** 3 // 2, device="cuda")
    centres = (2.0 * _coords_of(idx, h).float() / (h - 1) - 1.0) \
        * (bound - half)
    u = torch.rand(centres.shape, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(seed))
    return (centres + (u * 2.0 - 1.0) * half).t().contiguous(), None


def _frame_samples(res=256, n_steps=128):
    """x3, d3 [3, res^2 * n_steps] of a pinhole frame seen from
    (0.3, 0.2, -2.5) towards the box, each ray sampled in order from 1.5 to
    3.5 and clipped to the box, in the tiled renderer's order (pixel-major):
    ray-coherent, as a served frame's samples are."""
    import torch
    px = (np.arange(res, dtype=np.float32) + 0.5) / res - 0.5
    u, v = np.meshgrid(px, px, indexing="xy")
    d = np.stack([u, v, np.ones_like(u)], axis=-1).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.array([0.3, 0.2, -2.5], np.float32)
    ts = np.linspace(1.5, 3.5, n_steps, dtype=np.float32)
    x = np.clip(o + ts[None, :, None] * d[:, None, :], -1, 1)
    x3 = np.ascontiguousarray(x.reshape(-1, 3).T.astype(np.float32))
    d3 = np.ascontiguousarray(np.repeat(d, n_steps, axis=0).T)
    return torch.from_numpy(x3).cuda(), torch.from_numpy(d3).cuda()


def _main_path_shapes(name, kernel, plain, cfg, mode):
    """Hold kernel(x3, d3, **kw) against plain(...) and time it at the two
    shapes the main paths give it; the bound of each from this run's
    inputs."""
    import torch
    worst = 0.0
    for label, (x3, d3), kw in (
            ("coherent density-only slab queries", _slab_samples(),
             {"density_only": True}),
            ("frame-like samples", _frame_samples(), {})):
        m = x3.shape[1]
        out = kernel(x3, d3, **kw)
        ref = plain(x3, d3, **kw)
        torch.cuda.synchronize()
        e_s = _check_close("sigma", out[0], ref[0])
        e_c = 0.0 if kw else _check_close("rgb", out[1:4], ref[1:4])
        worst = max(worst, e_s, e_c)
        del out, ref
        ms = _cuda_ms(lambda: kernel(x3, d3, **kw), 5)
        b = _bound(cfg, m, mode=mode, **kw)
        print(f"{name} on {m} {label}: max|err| sigma {e_s:.3g} rgb "
              f"{e_c:.3g}; kernel {ms:.3f} ms ({m / ms * 1e3:.4g} samples/s); "
              f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}", flush=True)
    return worst


def phase_kernel_vs_plain():
    import torch
    from sealdnerf_tpu_torch.models.cp import CPConfig, init_cp
    from sealdnerf_tpu_torch.ops.field import (field_forward,
                                               field_forward_plain,
                                               pack_tables,
                                               tile_features_plain)
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
        b = _bound(cfg, m, **kw)
        print(f"K1 {tag}: M={m} max|err| sigma {e_s:.3g} rgb {e_c:.3g}; "
              f"kernel {ms:.3f} ms ({m / ms * 1e3:.4g} samples/s), plain "
              f"{pms:.3f} ms ({m / pms * 1e3:.4g} samples/s); bound "
              f"{b['bound_ms']:.4f} ms by {b['bound_by']}", flush=True)
        if tag == "full":
            rec = {"ms": ms, "plain_ms": pms, **b}
    # stage A: what enters the first sigma product, on the first 2^16 samples
    parts = {}
    xs = x3[:, :1 << 16].contiguous()
    field_forward(tables, cfg, xs, None, density_only=True, parts=parts)
    grid, freq, cols = tile_features_plain(tables, cfg, xs.t())
    feats, g = parts["features"].float(), cfg.grid_feat_dim
    differ = int((feats[:, cols[:g, 0]] != grid).sum())
    e_f = (feats[:, cols[g:, 0]] + feats[:, cols[g:, 1]] - freq).abs().max() \
        .item()
    print(f"K1 features: {differ} of {grid.numel()} line and plane features "
          f"differ from the plain version's bf16 ones; frequency rows as "
          f"hi + lo pairs: max |hi + lo - f32| {e_f:.3g}", flush=True)
    if differ or not e_f <= 2.0 ** -15:
        raise AssertionError("the kernel's features are off the plain ones")
    max_err = max(max_err, _main_path_shapes(
        "K1", lambda a, b, **kw: field_forward(tables, cfg, a, b, **kw),
        lambda a, b, **kw: field_forward_plain(tables, cfg, a, b, **kw),
        cfg, "fwd"))
    rec["max_abs_err"] = max_err
    return rec


def _dyn_seeded_params(seed, cfg, device, gain=DEFORM_GAIN):
    """init_cp_dnerf from a seed with the deform tower re-gained: the last
    matrix multiplied back by 1e3 (undoing its damping) and the hidden
    matrices by `gain`. The undamped init alone (gain 1) warps by only
    ~6e-4 (the bias-free tower shrinks its input sixfold in variance per
    layer); re-gained it warps by ~0.1, so the tower matters to the
    output."""
    import torch
    from sealdnerf_tpu_torch.models.cp import init_cp_dnerf
    params = init_cp_dnerf(torch.Generator().manual_seed(seed), cfg, device)
    wd = params["deform_mlp"]["w"]
    wd[-1] = wd[-1] * 1e3
    for k in range(1, len(wd) - 1):
        wd[k] = wd[k] * gain
    return params


def phase_dyn_kernel_vs_plain():
    import torch
    from sealdnerf_tpu_torch.models.cp import CPDNeRFConfig
    from sealdnerf_tpu_torch.ops.field import (dyn_field_forward,
                                               dyn_field_forward_plain,
                                               field_forward, pack_tables)
    cfg = CPDNeRFConfig()
    tables = pack_tables(_dyn_seeded_params(0, cfg, "cuda"), cfg)
    m = (1 << 20) + 37
    rng = np.random.default_rng(0)
    x3 = rng.uniform(-1.0, 1.0, (3, m)).astype(np.float32)
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    x3, d3 = torch.from_numpy(x3).cuda(), torch.from_numpy(d3).cuda()
    max_err, rec = 0.0, {}
    for t in (0.0, 0.37, 1.0):
        for tag, kw in (("full", {}), ("density_only", {"density_only": True}),
                        ("lod_skip=(3,)", {"lod_skip": (3,)})):
            out = dyn_field_forward(tables, cfg, x3, d3, t, **kw)
            ref, dx = dyn_field_forward_plain(tables, cfg, x3, d3, t,
                                              return_deform=True, **kw)
            torch.cuda.synchronize()
            e_s = _check_close("sigma", out[0], ref[0])
            e_c = 0.0 if kw.get("density_only") else \
                _check_close("rgb", out[1:4], ref[1:4])
            max_err = max(max_err, e_s, e_c)
            mean_dx = dx.abs().mean().item()
            line = (f"K3 t={t} {tag}: M={m} max|err| sigma {e_s:.3g} rgb "
                    f"{e_c:.3g}; mean|dx| {mean_dx:.4g}")
            if t == 0.37:
                ms = _cuda_ms(lambda: dyn_field_forward(tables, cfg, x3, d3,
                                                        t, **kw), 10)
                pms = _cuda_ms(lambda: dyn_field_forward_plain(
                    tables, cfg, x3, d3, t, **kw), 2)
                b = _bound(cfg, m, mode="dyn", **kw)
                line += (f"; kernel {ms:.3f} ms ({m / ms * 1e3:.4g} "
                         f"samples/s), plain {pms:.3f} ms "
                         f"({m / pms * 1e3:.4g} samples/s); bound "
                         f"{b['bound_ms']:.4f} ms by {b['bound_by']}")
                if tag == "full":
                    rec = {"ms": ms, "plain_ms": pms, **b}
                    if not mean_dx > 1e-2:
                        raise AssertionError(
                            f"mean |dx| {mean_dx} <= 1e-2: the deform tower "
                            "does not matter to the output")
            print(line, flush=True)
            if t == 0.0 and dx.abs().max().item() != 0.0:
                raise AssertionError("the plain version warps at t == 0")
    for kw in ({}, {"density_only": True}, {"lod_skip": (3,)}):
        k3 = dyn_field_forward(tables, cfg, x3, d3, 0.0, **kw)
        k1 = field_forward(tables, cfg, x3, d3, **kw)
        if not torch.equal(k3, k1):
            raise AssertionError(f"K3 at t = 0 differs from K1 ({kw}): max "
                                 f"|diff| {(k3 - k1).abs().max().item():.3g}")
    t_dev = dyn_field_forward(tables, cfg, x3, d3,
                              torch.tensor(0.37, device="cuda"))
    t_host = dyn_field_forward(tables, cfg, x3, d3, 0.37)
    torch.cuda.synchronize()
    if not torch.equal(t_dev, t_host):
        raise AssertionError("K3 with t on the card differs from t on the "
                             "host")
    _, dx = dyn_field_forward_plain(
        pack_tables(_dyn_seeded_params(0, cfg, "cuda", gain=1.0), cfg), cfg,
        x3[:, :1 << 16].contiguous(), None, 0.37, density_only=True,
        return_deform=True)
    print(f"the undamped tower without the hidden gain warps by mean|dx| "
          f"{dx.abs().mean().item():.4g} at t = 0.37", flush=True)
    max_err = max(max_err, _main_path_shapes(
        "K3 t=0.37",
        lambda a, b, **kw: dyn_field_forward(tables, cfg, a, b, 0.37, **kw),
        lambda a, b, **kw: dyn_field_forward_plain(tables, cfg, a, b, 0.37,
                                                   **kw),
        cfg, "dyn"))
    rec["max_abs_err"] = max_err
    print("K3 at t = 0 equals K1 bit for bit; t read from the card equals t "
          "from the host", flush=True)
    return rec


def _grad_errs(got, ref):
    """Max |got - ref| / max |ref| per leaf group, and the largest
    absolute difference of any leaf."""
    from sealdnerf_tpu_torch.models.cp import param_leaves
    groups = {"lines": ("lines",), "planes": ("planes",),
              "vm_lines": ("vm_lines",), "towers": ("sigma_mlp", "color_mlp"),
              "deform": ("deform_mlp",)}
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
                ref_max = b.abs().max().item()
                ratios[name] = max(ratios.get(name, 0.0),
                                   diff / max(ref_max, 1e-30)
                                   if diff > 0.0 else 0.0)
    return ratios, max_abs


def _stable_cotangents(tag, tables, cfg, positions, d3, g):
    """g [4, M] with the cotangents zeroed of the samples that the plain
    version calls fragile at `positions` [3, M] (fragile_samples_plain: a
    relu's pre-activation within its summation noise of 0; chosen without
    the kernel), and their share of the samples that carry a cotangent."""
    import torch
    from sealdnerf_tpu_torch.ops.field import fragile_samples_plain
    live = torch.nonzero(g.abs().amax(dim=0) > 0)[:, 0]
    fragile = live[fragile_samples_plain(tables, cfg, positions.t()[live],
                                         d3.t()[live])]
    share = fragile.numel() / max(live.numel(), 1)
    print(f"{tag}: of {live.numel()} samples with a cotangent the plain "
          f"version calls {fragile.numel()} ({share:.3g}) fragile", flush=True)
    g = g.clone()
    g[:, fragile] = 0.0
    return g


def _held(tag, ratios, tol):
    bad = {k: v for k, v in ratios.items() if not v <= tol}
    if bad:
        raise AssertionError(f"{tag} beyond {tol}: {bad}")


def _padded_config_through_the_kernels():
    """A config whose ranks and plane channels are no multiples of 8 (rows
    padded by pack_tables) through K1 and K2 against their plain versions."""
    import torch
    from sealdnerf_tpu_torch.models.cp import CPConfig, init_cp
    from sealdnerf_tpu_torch.ops.field import (field_backward,
                                               field_backward_plain,
                                               field_forward,
                                               field_forward_plain,
                                               pack_tables)
    cfg = CPConfig(scales=((32, 4), (128, 20)), planes=((128, 4),))
    tables = pack_tables(init_cp(torch.Generator().manual_seed(3), cfg,
                                 "cuda"), cfg)
    m = 4096 * 4 + 5
    rng = np.random.default_rng(4)
    x3 = rng.uniform(-1.0, 1.0, (3, m)).astype(np.float32)
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    g = rng.normal(size=(4, m)).astype(np.float32)
    x3, d3, g = (torch.from_numpy(a).cuda() for a in (x3, d3, g))
    out, ref = (f(tables, cfg, x3, d3)
                for f in (field_forward, field_forward_plain))
    e_s = _check_close("sigma", out[0], ref[0])
    e_c = _check_close("rgb", out[1:4], ref[1:4])
    whole, _ = _grad_errs(field_backward(tables, cfg, x3, d3, g),
                          field_backward_plain(tables, cfg, x3, d3, g))
    g = _stable_cotangents("K2, padded config", tables, cfg, x3, d3, g)
    ratios, _ = _grad_errs(field_backward(tables, cfg, x3, d3, g),
                           field_backward_plain(tables, cfg, x3, d3, g))
    print(f"config with ranks (4, 20) and 4 plane channels, M={m}: K1 "
          f"max|err| sigma {e_s:.3g} rgb {e_c:.3g}; K2 max|k-p|/max|p| on the "
          "stable samples "
          + " ".join(f"{k} {v:.3g}" for k, v in ratios.items())
          + "; on all "
          + " ".join(f"{k} {v:.3g}" for k, v in whole.items()), flush=True)
    _held("padded config, K2 on the stable samples", ratios, GRAD_TOL)
    _held("padded config, K2 on all samples", whole, WHOLE_CALL_TOL)


def phase_backward_vs_plain():
    import torch
    from sealdnerf_tpu_torch.models.cp import CPConfig, init_cp
    from sealdnerf_tpu_torch.ops.field import (field_backward,
                                               field_backward_plain,
                                               field_forward, pack_tables)
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
    parts = {}
    got = field_backward(tables, cfg, x3, d3, g, parts=parts)
    ref = field_backward_plain(tables, cfg, x3, d3, g)
    torch.cuda.synchronize()
    if field_backward.launches != before + 1:
        raise AssertionError("K2 did not launch exactly once")
    whole, _ = _grad_errs(got, ref)
    # what K2 recomputed is what K1 computes, bit for bit
    live = parts["live"]
    k1 = field_forward(tables, cfg, x3, d3)
    off = int((parts["out"][:, live] != k1[:, live]).any(dim=0).sum())
    print(f"K2: M={m}; the forward it recomputed differs from K1's output "
          f"at {off} of {live.numel()} samples", flush=True)
    if off or live.numel() != m:
        raise AssertionError("K2's recompute is not the forward kernel's")
    g2 = _stable_cotangents("K2", tables, cfg, x3, d3, g)
    ratios, max_abs = _grad_errs(field_backward(tables, cfg, x3, d3, g2),
                                 field_backward_plain(tables, cfg, x3, d3,
                                                      g2))
    ms = _cuda_ms(lambda: field_backward(tables, cfg, x3, d3, g), 10)
    pms = _cuda_ms(lambda: field_backward_plain(tables, cfg, x3, d3, g), 3)
    xc, dc = (a[:, :m].contiguous() for a in _frame_samples(res=64,
                                                            n_steps=65))
    ms_c = _cuda_ms(lambda: field_backward(tables, cfg, xc, dc, g), 10)
    print(f"K2: max|k-p|/max|p| on the stable samples "
          + " ".join(f"{k} {v:.3g}" for k, v in ratios.items())
          + "; on all "
          + " ".join(f"{k} {v:.3g}" for k, v in whole.items())
          + f"; max|err| {max_abs:.3g}; kernel {ms:.3f} ms "
          f"({m / ms * 1e3:.4g} samples/s) on random samples, {ms_c:.3f} ms "
          f"on ray-coherent ones, plain {pms:.3f} ms "
          f"({m / pms * 1e3:.4g} samples/s); launches "
          f"{field_backward.launches}", flush=True)
    _held("K2 vs plain on the stable samples", ratios, GRAD_TOL)
    _held("K2 vs plain on all samples", whole, WHOLE_CALL_TOL)
    rec = {"ms": ms, "plain_ms": pms, "max_abs_err": max_abs}
    rec.update(_bound(cfg, m, mode="bwd"))
    print(f"K2 bound: {rec['bound_ms']:.4f} ms by {rec['bound_by']}",
          flush=True)
    _padded_config_through_the_kernels()
    return rec


def phase_dyn_backward_vs_plain():
    import torch
    from sealdnerf_tpu_torch.models.cp import CPDNeRFConfig
    from sealdnerf_tpu_torch.ops.field import (dyn_canonical_backward_plain,
                                               dyn_field_backward,
                                               dyn_field_backward_plain,
                                               dyn_tower_backward_plain,
                                               dyn_warp_plain, field_backward,
                                               pack_tables)
    cfg = CPDNeRFConfig()
    m = 4096 * 64 + 37
    rng = np.random.default_rng(2)
    x3 = rng.uniform(-1.0, 1.0, (3, m)).astype(np.float32)
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    g = rng.normal(size=(4, m)).astype(np.float32)
    g[:, rng.random(m) < 0.3] = 0.0            # samples the march left empty
    m_live = int((np.abs(g).max(axis=0) > 0).sum())
    x3, d3, g_all = (torch.from_numpy(a).cuda() for a in (x3, d3, g))
    nx = cfg.deform_space_dim

    def check(tag, ratios, tol):
        print(f"K4 {tag}: max|k-p|/max|p| "
              + " ".join(f"{k} {v:.3g}" for k, v in ratios.items()),
              flush=True)
        _held(f"K4 {tag}", ratios, tol)

    def rel(a, b):
        return ((a - b).abs().max().item()
                / max(b.abs().max().item(), 1e-30))

    max_abs = 0.0
    for tower, gain in (("undamped", 1.0), ("re-gained", DEFORM_GAIN)):
        tables = pack_tables(_dyn_seeded_params(0, cfg, "cuda", gain=gain),
                             cfg)
        for t in (0.37, 0.0):
            before = dyn_field_backward.launches
            parts = {}
            whole = dyn_field_backward(tables, cfg, x3, d3, t, g_all,
                                       parts=parts)
            xw_p, acts_p = dyn_warp_plain(tables, cfg, x3, t)
            torch.cuda.synchronize()
            if dyn_field_backward.launches != before + 1:
                raise AssertionError("K4 did not launch exactly once")
            # all samples, then those that are stable at the kernel's warped
            # positions (see 3b)
            all_r, _ = _grad_errs(whole, dyn_field_backward_plain(
                tables, cfg, x3, d3, t, g_all))
            check(f"{tower} t={t} vs plain, all samples", all_r,
                  WHOLE_CALL_TOL if gain == 1.0 or t == 0.0
                  else REGAINED_TOL)
            del whole
            g = _stable_cotangents(f"K4, {tower} tower, t={t}", tables, cfg,
                                   parts["xw"], d3, g_all)
            parts = {}
            got = dyn_field_backward(tables, cfg, x3, d3, t, g, parts=parts)
            ref = dyn_field_backward_plain(tables, cfg, x3, d3, t, g)
            torch.cuda.synchronize()
            ratios, err = _grad_errs(got, ref)
            gt, rt = (q["deform_mlp"]["w"][0][nx:] for q in (got, ref))
            ratios["time rows"] = (rel(gt, rt) if t != 0.0
                                   else gt.abs().max().item())
            dmax = max(w.abs().max().item() for w in got["deform_mlp"]["w"])
            # the kernel warps the samples with a cotangent only
            dxw = (parts["xw"] - xw_p).abs()[:, parts["live"]]
            warp = (xw_p - x3).abs().mean().item()
            print(f"K4, {tower} tower, t={t}: M={m} ({m_live} with a "
                  f"cotangent); mean |dx| {warp:.3g}; warped positions kernel "
                  f"vs plain: mean |diff| {dxw.mean().item():.3g}, max "
                  f"{dxw.max().item():.3g}, share above 1e-3 "
                  f"{(dxw > 1e-3).float().mean().item():.3g}; max |deform "
                  f"grad| {dmax:.3g}", flush=True)
            if t == 0.0:
                check(f"{tower} t=0 vs plain", ratios, GRAD_TOL)
                max_abs = max(max_abs, err)
                if dmax != 0.0 or dxw.max().item() != 0.0:
                    raise AssertionError(f"deform gradient {dmax}, warp "
                                         f"{dxw.max().item()} at t == 0")
                k2 = field_backward(tables, cfg, x3, d3, g)
                r2, _ = _grad_errs({k: got[k] for k in k2}, k2)
                check(f"{tower} t=0 vs K2", r2, GRAD_TOL)
                continue
            if not dmax > 0.0:
                raise AssertionError("no deform gradient at t = 0.37")
            if gain == 1.0:
                check(f"{tower} vs plain", ratios, GRAD_TOL)
                max_abs = max(max_abs, err)
            else:
                # The re-gained tower warps by 0.1, and the bf16 noise of
                # its eight layers moves a few positions by up to half a
                # cell of the 1024 tables. With random cotangents every
                # gradient entry is a random-walk sum, which such samples
                # shift by about the root of their share. So the whole is
                # held to the reference's own envelope for its kernel
                # against its XLA model.
                check(f"{tower} vs plain, end to end", ratios, REGAINED_TOL)
            # Each stage, tightly, on the kernel's own input (both towers).
            # 1. The warp.
            if not (dxw.mean().item() <= 1e-5
                    and (dxw > 1e-3).float().mean().item() <= 1e-3):
                raise AssertionError("the kernel's warp is off the plain one")
            # 2. The canonical backward and g_x at the kernel's positions.
            ref2, gx2 = dyn_canonical_backward_plain(tables, cfg, parts["xw"],
                                                     d3, t, g)
            r2, err = _grad_errs({k: got[k] for k in ref2}, ref2)
            max_abs = max(max_abs, err)
            r2["g_x"] = rel(parts["g_x"], gx2)
            check(f"{tower}, canonical stage at the kernel's warp", r2,
                  GRAD_TOL)
            # 3. The activations that the tower's backward recomputed. An
            # mma sums in another order than a matmul, so of the hidden
            # activations a few in ten thousand round to the neighbouring
            # bf16 and about one in a million lands on the other side of
            # the relu (measured: 3.8e-4 to 7.1e-4 differ, 3.7e-4 to 1.5e-3
            # of the samples hold a differing mask;
            # profiling/torch_dyn_bwd_seeds.py). The f32 plain chain lies as
            # far from the same chain with f64 sums.
            live = parts["live"]
            acts_k = [a.float() for a in parts["acts"]]
            acts_p = [a[live] for a in acts_p]
            hid_k, hid_p = torch.cat(acts_k[1:], 1), torch.cat(acts_p[1:], 1)
            differ = (hid_k != hid_p).float().mean().item()
            masks = ((hid_k > 0) != (hid_p > 0)).any(dim=1).float().mean() \
                .item()
            print(f"K4 {tower}, recomputed activations kernel vs plain: the "
                  f"encoded position differs in "
                  f"{int((acts_k[0] != acts_p[0]).sum())} entries; of the "
                  f"hidden entries {differ:.3g} differ; {masks:.3g} of the "
                  f"{live.numel()} samples hold a relu mask that differs",
                  flush=True)
            if not (differ <= ACT_DIFFER_TOL and masks <= ACT_MASK_TOL):
                raise AssertionError(
                    f"recomputed activations off the plain chain: {differ} "
                    f"of the entries (limit {ACT_DIFFER_TOL}), {masks} of "
                    f"the samples by a mask (limit {ACT_MASK_TOL})")
            # 4. The tower's backward (input gradients, outer products) on
            # the kernel's own g_x AND activations: no mask can differ, so
            # this holds the arithmetic itself. The time rows are rounded
            # to bf16 after the sum over all samples: one rounding that
            # differs moves them by up to 2^-7 of themselves.
            ref3 = dyn_tower_backward_plain(tables, cfg, t, acts_k,
                                            parts["g_x"][:, live])["w"]
            got3 = got["deform_mlp"]["w"]
            r3 = {f"matrix {k}": rel(a[:nx] if k == 0 else a,
                                     b[:nx] if k == 0 else b)
                  for k, (a, b) in enumerate(zip(got3, ref3))}
            check(f"{tower}, tower stage on the kernel's g_x and "
                  "activations", r3, TOWER_STAGE_TOL)
            check(f"{tower}, the same, time rows",
                  {"time rows": rel(got3[0][nx:], ref3[0][nx:])}, GRAD_TOL)
            # beside it, not held: the same stage on the PLAIN activations,
            # which the differing masks move by the root of their share
            ref4 = dyn_tower_backward_plain(tables, cfg, t, acts_p,
                                            parts["g_x"][:, live])["w"]
            print(f"K4 {tower}, tower stage on the plain activations (shown, "
                  "not held): " + " ".join(
                      f"{rel(a, b):.3g}" for a, b in zip(got3, ref4)),
                  flush=True)
    g = g_all
    ms = _cuda_ms(lambda: dyn_field_backward(tables, cfg, x3, d3, 0.37, g), 10)
    pms = _cuda_ms(lambda: dyn_field_backward_plain(tables, cfg, x3, d3, 0.37,
                                                    g), 3)
    ms2 = _cuda_ms(lambda: field_backward(tables, cfg, x3, d3, g), 10)
    print(f"K4: M={m} kernel {ms:.3f} ms ({m / ms * 1e3:.4g} samples/s), "
          f"plain {pms:.3f} ms ({m / pms * 1e3:.4g} samples/s); K2 on the "
          f"same samples and cotangents {ms2:.3f} ms", flush=True)
    rec = {"ms": ms, "plain_ms": pms, "max_abs_err": max_abs}
    rec.update(_bound(cfg, m, mode="dyn_bwd", m_live=m_live))
    print(f"K4 bound: {rec['bound_ms']:.4f} ms by {rec['bound_by']}",
          flush=True)
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


def phase_dynamic_served_path():
    import torch
    from sealdnerf_tpu_torch import main_dnerf
    from sealdnerf_tpu_torch.cli import build_trainer, load_datasets
    from sealdnerf_tpu_torch.models.cp import CPDNeRFConfig
    from sealdnerf_tpu_torch.ops.field import (dyn_field_forward,
                                               dyn_field_forward_plain,
                                               field_forward)
    from sealdnerf_tpu_torch.ops.marching_dense import downsample_occ
    from sealdnerf_tpu_torch.render.dynamic_grid import time_slice_index
    from sealdnerf_tpu_torch.render.fast_image import render_image_tiled
    from sealdnerf_tpu_torch.train.checkpoint import save_checkpoint
    from sealdnerf_tpu_torch.train.metrics import psnr

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "dyn_seeded.npz")
        save_checkpoint(ckpt, {"model": {
            "params": _dyn_seeded_params(0, CPDNeRFConfig(bound=1.0), "cpu"),
            "ema": None}}, {"epoch": 0, "global_step": 0})
        argv = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0",
                "--test", "--synthetic_res", "800", "--ckpt", ckpt,
                "--workspace", os.path.join(REPO, "workspace",
                                            "chip_smoke_dyn")]
        opt = main_dnerf.parse_args(argv)
        t0 = time.perf_counter()
        train, _, val = load_datasets(opt, with_time=True)
        print(f"dynamic data: {len(train)} train / {len(val)} val views at "
              f"{val.h}x{val.w}, val times "
              f"{[round(float(t), 4) for t in val.times]} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        dyn_field_forward.launches = 0
        field_forward.launches = 0
        trainer, field = build_trainer(opt, name="ngp", dynamic=True,
                                       lr_net=opt.lr_net)
    if not trainer.time_conditioned or bool(trainer.grid_state["occ"].any()):
        raise AssertionError("expected a dynamic trainer with an empty grid")
    trainer.mark_untrained_grid(train.poses, train.intrinsics)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.rebuild_grid()
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    n_rebuild = dyn_field_forward.launches
    occ = trainer.grid_state["occ"]
    per_bin = occ.reshape(occ.shape[0], -1).float().mean(dim=1)
    gcfg = trainer.dyn_grid_cfg
    print(f"dynamic grid rebuild: {gcfg.time_size} bins x "
          f"{gcfg.grid_size}^3 cells in {rebuild_s:.3f} s, {n_rebuild} kernel "
          f"launches, occupancy per bin min {per_bin.min().item():.4f} mean "
          f"{per_bin.mean().item():.4f} max {per_bin.max().item():.4f}",
          flush=True)
    if n_rebuild < gcfg.time_size:
        raise AssertionError(f"K3 launched {n_rebuild} times in the rebuild "
                             f"of {gcfg.time_size} bins")
    if not bool((per_bin > 0).all()):
        raise AssertionError("a time bin holds no occupied cell")

    result = trainer.evaluate(val)
    times, frames = [], []
    for i in range(len(val)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, _ = trainer.render_image(val.poses[i], val.intrinsics, val.h,
                                      val.w, time=val.times[i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        frames.append(img)
    launches = dyn_field_forward.launches
    n_render = launches - n_rebuild
    if n_render < 2 * len(val):
        raise AssertionError(f"K3 launched {n_render} times in "
                             f"{2 * len(val)} frames")
    if field_forward.launches != 0:
        raise AssertionError(f"the dynamic path launched K1 "
                             f"{field_forward.launches} times")
    for img in frames:
        if img.shape != (val.h, val.w, 3) or not np.isfinite(img).all():
            raise AssertionError(f"bad frame {img.shape}")
    if not np.isfinite(result):
        raise AssertionError(f"evaluate PSNR {result}")
    spf = val.h * val.w * trainer.render_cfg.samples_per_ray
    print(f"dynamic render: {len(val)} frames at {val.h}x{val.w}, tile "
          f"{trainer._pick_tile(val.h, val.w)}, {spf} field samples/frame, "
          f"kernel path {float(np.mean(times)):.2f} ms/frame (min "
          f"{min(times):.2f}, max {max(times):.2f}), {n_render} kernel "
          f"launches in {2 * len(val)} frames, K1 launches "
          f"{field_forward.launches}; PSNR vs GT {result:.3f} dB (seeded "
          f"field)", flush=True)

    # the same pose at another time (not counted as the main path)
    other, _ = trainer.render_image(val.poses[0], val.intrinsics, val.h,
                                    val.w, time=0.9)
    d_time = float(np.abs(other - frames[0]).max())
    if not d_time > 1e-2:
        raise AssertionError(f"view 0 at t={val.times[0]} and at t=0.9 "
                             f"differ by only {d_time}")

    # view 0 through the plain field
    cfg, rcfg, dev = field.cfg, trainer.render_cfg, trainer.device
    t = float(val.times[0])
    occ_m = downsample_occ(occ[time_slice_index(t, gcfg), 0], rcfg.march_res)
    tables = field.kernel_tables(trainer._infer_params())
    before = dyn_field_forward.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        img_p, _ = render_image_tiled(
            tables, occ_m, torch.as_tensor(val.poses[0], device=dev),
            torch.as_tensor(val.intrinsics, device=dev), val.h, val.w, rcfg,
            lambda tb, x3, d3, tt: dyn_field_forward_plain(tb, cfg, x3, d3,
                                                           tt),
            torch.ones(3, device=dev),
            tile_px=trainer._pick_tile(val.h, val.w),
            dilate=trainer.opt.render_dilate,
            density_scale=trainer.opt.density_scale,
            t_thresh=trainer.opt.t_thresh, extra=(t,))
    img_p = img_p.cpu().numpy()
    ms_p = (time.perf_counter() - t0) * 1e3
    if dyn_field_forward.launches != before:
        raise AssertionError("the plain render launched the kernel")
    p = psnr(frames[0], img_p)
    print(f"dynamic kernel frame vs plain frame: PSNR {p:.2f} dB, max|diff| "
          f"{np.abs(frames[0] - img_p).max():.3g}; plain path {ms_p:.2f} "
          f"ms/frame; the same pose at t={t:.4f} and t=0.9 differs by "
          f"{d_time:.3g}", flush=True)
    if p < 40.0:
        raise AssertionError(f"kernel vs plain frame PSNR {p:.2f} < 40 dB")
    return launches, train, val


def _expected_refreshes(steps, upd=2, warmup=128, freeze=592):
    """Refresh calls of `steps` dynamic training steps by the reference's
    rule at its defaults: a chance every `upd` steps, taken at each while
    fewer than `warmup` calls were made and at every other one after that,
    until `freeze` calls (128 + (1600 + 512 - 256) / 4)."""
    calls = 0
    for step in range(steps):
        if step % upd == 0 and calls < freeze and (
                calls < warmup or step % (2 * upd) == 0):
            calls += 1
    return calls


def _mean_deform(trainer, t=0.7, n=4096):
    """mean |deform(x, t)| of the inference params at n seeded scene
    points."""
    import torch
    from sealdnerf_tpu_torch.models.cp import cp_dnerf_deform
    x = torch.from_numpy(np.random.default_rng(7).uniform(
        -1.0, 1.0, (n, 3)).astype(np.float32)).to(trainer.device)
    with torch.no_grad():
        return cp_dnerf_deform(trainer._infer_params(), trainer.field.cfg, x,
                               t).abs().mean().item()


def phase_dynamic_training(train, val):
    import torch
    from sealdnerf_tpu_torch import main_dnerf
    from sealdnerf_tpu_torch.cli import build_trainer
    from sealdnerf_tpu_torch.ops.field import (dyn_field_backward,
                                               dyn_field_forward,
                                               field_backward, field_forward)

    def make(tag):
        argv = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0",
                "--iters", str(TRAIN_STEPS), "--synthetic_res", "800",
                "--ckpt", "scratch", "--workspace",
                os.path.join(REPO, "workspace", tag)]
        opt = main_dnerf.parse_args(argv)
        return opt, build_trainer(opt, name="ngp", dynamic=True,
                                  lr_net=opt.lr_net)[0]

    # the seeded field, served as `--test` serves it: the floor of the PSNR
    _, seeded = make("chip_smoke_dyn_seeded")
    seeded.mark_untrained_grid(train.poses, train.intrinsics)
    seeded.rebuild_grid()
    psnr0 = seeded.evaluate(val)
    deform0 = _mean_deform(seeded)
    seeded.global_step = 300                          # mid-anneal
    phase_one_dyn_step(seeded, train, "seeded field", GRAD_TOL)
    del seeded
    torch.cuda.empty_cache()

    opt, trainer = make("chip_smoke_dyn_train")
    topt = trainer.opt
    if (topt.lr, topt.lr_net, topt.time_curriculum_steps,
            topt.dyn_anneal_steps, topt.deform_zero_reg) != (
            1e-2, 1e-3, -1, 1024, 1e-3):
        raise AssertionError(f"not the reference's defaults: {topt}")
    refresh_ev, refresh_host = [], []
    inner = trainer.refresh_grid

    def timed_refresh(*a, **kw):
        # device time between two events; host time to enqueue the call (the
        # host does not wait for the device inside it)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        ev[0].record()
        inner(*a, **kw)
        ev[1].record()
        refresh_host.append((time.perf_counter() - t0) * 1e3)
        refresh_ev.append(ev)

    trainer.refresh_grid = timed_refresh
    steps_per_epoch = max(len(train), topt.segment_steps)
    for fn in (dyn_field_forward, dyn_field_backward, field_forward,
               field_backward):
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(train, None, int(np.ceil(opt.iters / len(train))))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3, k4 = dyn_field_forward.launches, dyn_field_backward.launches
    k1, k2 = field_forward.launches, field_backward.launches
    del trainer.refresh_grid
    hist = trainer.history
    losses = np.asarray(hist["loss"])
    steps = len(losses)
    if steps != TRAIN_STEPS or trainer.global_step != TRAIN_STEPS:
        raise AssertionError(f"trained {steps} steps, not {TRAIN_STEPS}")
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite training loss")
    if topt.time_curriculum_steps != 512 or not trainer._time_sorted:
        raise AssertionError("the time curriculum did not resolve to 512 "
                             f"steps: {topt.time_curriculum_steps}")
    calls = int(trainer.grid_state["iter_density"])
    want = _expected_refreshes(steps)
    if calls != want or len(refresh_ev) != want:
        raise AssertionError(f"{calls} refresh calls in the grid state, "
                             f"{len(refresh_ev)} made, {want} expected")
    bins = trainer.dyn_grid_cfg.bins_per_call
    if k4 != steps or k3 != steps + bins * calls or k1 or k2:
        raise AssertionError(
            f"launches in {steps} steps and {calls} refreshes: K4 {k4}, K3 "
            f"{k3} (expected {steps + bins * calls}), K1 {k1}, K2 {k2}")
    refresh_ms = [a.elapsed_time(b) for a, b in refresh_ev]
    warm_s = sum(hist["epoch_s"][1:])
    ms_step = warm_s / (steps - steps_per_epoch) * 1e3
    first, last = losses[:64].mean(), losses[-64:].mean()
    occ = trainer.grid_state["occ"]
    per_bin = occ.reshape(occ.shape[0], -1).float().mean(dim=1)
    print(f"dynamic train: {steps} steps x {topt.num_rays} rays in "
          f"{wall:.2f} s ({len(hist['epoch_s'])} epochs of {steps_per_epoch}:"
          f" {' '.join(f'{e:.2f}' for e in hist['epoch_s'])} s); "
          f"{ms_step:.3f} ms/step, {topt.num_rays * 1e3 / ms_step:.1f} rays/s"
          f" over epochs 2-{len(hist['epoch_s'])}; mean n_samples/step "
          f"{np.mean(hist['n_samples']):.1f} (last 64: "
          f"{np.mean(hist['n_samples'][-64:]):.1f}); launches K3 {k3} K4 {k4} "
          f"K1 {k1} K2 {k2}; {calls} grid refreshes, {np.mean(refresh_ms):.3f}"
          f" ms each on the device (warm-up {np.mean(refresh_ms[:128]):.3f}, "
          f"after {np.mean(refresh_ms[128:]):.3f}) and "
          f"{np.mean(refresh_host):.3f} ms of host time to enqueue, "
          f"{sum(refresh_ms) / (sum(hist['epoch_s']) * 1e3):.4f} of the "
          f"epochs' time; loss first 64 {first:.6f} last 64 {last:.6f}",
          flush=True)
    print(f"dynamic train: occupancy per bin min {per_bin.min().item():.4f} "
          f"mean {per_bin.mean().item():.4f} max {per_bin.max().item():.4f}; "
          "bins 0, 16, 32, 48, 63: "
          + " ".join(f"{per_bin[b].item():.4f}" for b in (0, 16, 32, 48, 63)),
          flush=True)
    if not last < 0.5 * first:
        raise AssertionError(f"loss did not halve: {first} -> {last}")
    psnr = trainer.evaluate(val)
    deform1 = _mean_deform(trainer)
    times = []
    for i in (0, len(val) // 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, _ = trainer.render_image(val.poses[i], val.intrinsics, val.h,
                                      val.w, time=val.times[i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if img.shape != (val.h, val.w, 3) or not np.isfinite(img).all():
            raise AssertionError(f"bad trained frame {img.shape}")
    print(f"dynamic train: val PSNR {psnr:.3f} dB after {steps} steps (seeded "
          f"field {psnr0:.3f} dB); mean |deform(x, 0.7)| {deform1:.4g} "
          f"(seeded {deform0:.4g}); one trained {val.h}x{val.w} frame "
          + " ".join(f"{t:.2f}" for t in times) + " ms", flush=True)
    if not psnr >= psnr0 + 3.0:
        raise AssertionError(f"val PSNR {psnr:.3f} not 3 dB above the seeded "
                             f"field's {psnr0:.3f}")
    if not (deform1 > deform0 and deform1 > 1e-3):
        raise AssertionError(f"the deform tower is dead: mean |deform| "
                             f"{deform0} -> {deform1}")
    return trainer, k3, k4


def phase_one_dyn_step(trainer, train, tag, tol):
    import torch
    from sealdnerf_tpu_torch.models.cp import param_leaves, unflatten_like
    from sealdnerf_tpu_torch.ops.field import (dyn_field_backward,
                                               dyn_field_forward)
    from sealdnerf_tpu_torch.ops.marching_dense import downsample_occ

    data = train.device("cuda")
    if trainer._time_sorted:                         # as the trainer sorted
        order = torch.as_tensor(np.argsort(train.times, kind="stable"),
                                device="cuda")
        data = {k: (v[order] if k in ("images", "poses", "times") else v)
                for k, v in data.items()}
    if trainer._occ_m is None:
        trainer._occ_m = downsample_occ(trainer.grid_state["occ"][:, 0],
                                        trainer.march_cfg.march_res)
    batch = trainer.sample_batch(data, train.h, train.w)
    out = []
    for plain in (False, True):
        for p in param_leaves(trainer.params):
            p.grad = None
        k3, k4 = dyn_field_forward.launches, dyn_field_backward.launches
        loss, n = trainer.loss_on(*batch, plain=plain)
        loss.backward()
        torch.cuda.synchronize()
        launched = (dyn_field_forward.launches - k3,
                    dyn_field_backward.launches - k4)
        if launched != ((0, 0) if plain else (1, 1)):
            raise AssertionError(f"plain={plain}: kernel launches {launched}")
        out.append((loss.item(), unflatten_like(
            trainer.params, [p.grad.clone()
                             for p in param_leaves(trainer.params)])))
    (lk, gk), (lp, gp) = out
    ratios, _ = _grad_errs(gk, gp)
    print(f"one dynamic step, {tag}, at t={batch[5].item():.4f}, anneal ramp "
          f"{trainer._anneal_ramp(trainer.global_step):.3f}: {int(n)} "
          f"samples; loss kernel {lk:.8f} plain {lp:.8f}; grads "
          "max|k-p|/max|p| "
          + " ".join(f"{k} {v:.3g}" for k, v in ratios.items()), flush=True)
    if abs(lk - lp) > 1e-4 * abs(lp):
        raise AssertionError(f"loss kernel {lk} vs plain {lp}")
    bad = {k: v for k, v in ratios.items() if not v <= tol}
    if bad:
        raise AssertionError(f"dynamic train-step grads ({tag}) beyond "
                             f"{tol}: {bad}")


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
    rec_dyn = phase_dyn_kernel_vs_plain()
    rec_dbwd = phase_dyn_backward_vs_plain()
    served = phase_served_path(args.ckpt)
    trainer, k1_train, k2_train = phase_training(served)
    phase_one_step(trainer, served["train"])
    del trainer, served["train"], served["val"]
    k3_served, dtrain, dval = phase_dynamic_served_path()
    dtrainer, k3_train, k4_train = phase_dynamic_training(dtrain, dval)
    phase_one_dyn_step(dtrainer, dtrain, "trained field", TRAINED_STEP_TOL)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "field_fwd", "route": "cuda",
        "source": "sealdnerf_tpu_torch/ops/csrc/field_fwd.cu",
        "replaces": "sealdnerf_tpu/ops/pallas_field.py:185",
        "launches": served["launches"] + k1_train, **rec}, {
        "name": "field_bwd", "route": "cuda",
        "source": "sealdnerf_tpu_torch/ops/csrc/field_bwd.cu",
        "replaces": "sealdnerf_tpu/ops/pallas_field.py:574",
        "launches": k2_train, **rec_bwd}, {
        "name": "dyn_field_fwd", "route": "cuda",
        "source": "sealdnerf_tpu_torch/ops/csrc/dyn_field_fwd.cu",
        "replaces": "sealdnerf_tpu/ops/pallas_field.py:200",
        "launches": k3_served + k3_train, **rec_dyn}, {
        "name": "dyn_field_bwd", "route": "cuda",
        "source": "sealdnerf_tpu_torch/ops/csrc/dyn_field_bwd.cu",
        "replaces": "sealdnerf_tpu/ops/pallas_field.py:805",
        "launches": k4_train, **rec_dbwd}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
