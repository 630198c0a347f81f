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
     K1's tolerances, with timings. K3 in chunks of 2^18, of 100,003 and of
     the default 2^20 samples (its warp scratch holds one chunk) equals K3
     in one pass bit for bit. The seeded deform tower is re-gained
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
     input: the warp (the listed samples' warped positions equal K3's bit
     for bit: one device function); the canonical backward and g_x at the kernel's warped
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
  5c. trained static serving: phase 5's field, whose occupancy must be
     below 15 %, so that render_image takes the bucketed renderer (the
     termination trim, the reference's eval ladder). After
     warm_renderers, view 0 four ways through K1, each timed: tiled (one
     launch), bucketed (the pick; the trim's probe and the buckets: >= 2
     launches), the LOD preview (the 1024 line scale skipped, the
     preview ladder) and the trim alone (one full-budget bucket); then
     the bucketed frame and the preview through K1's plain version. Trim
     alone vs tiled >= 40 dB, bucketed and preview kernel vs plain >= 40
     dB; the ladders' distance to tiled is printed.
  6. dynamic served path: a checkpoint of the seeded, re-gained dynamic field
     is written to a temporary directory; main_dnerf's parser and
     cli.build_trainer(dynamic=True) on `synthetic -O --bound 1 --dt_gamma 0
     --test --synthetic_res 800 --ckpt <it>`; frustum marking; a rebuild of
     all 64 time bins of the 128^3 grid through K3 density-only, timed;
     evaluate on the 6 val views at 800x800, each at its own time, timed per
     frame. K3 must have been launched in the rebuild and in the render and
     K1 not at all; every time bin must hold occupied cells; frames finite;
     one view through the plain field must agree with the kernel frame to
     >= 40 dB; one pose rendered at two times must differ. C4: view 0 again,
     once with K3's warp scratch for all 81.92 M samples of the frame and
     once at the default chunk; the peak device memory of K3's call (the
     counter reset just before it, read just after it) must fall by >= 900
     MB, both frames must equal the evaluated one bit for bit; the frame's
     own peak is printed.
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
  7c. trained dynamic serving: phase 5c's checks on phase 7's field at
     t = 0.5, through K3.
  8. dynamic edit: phase 7's trained field (its last full checkpoint) is the
     teacher of `main_seald.main([...])`, called in-process with `synthetic
     -O --bound 1.0 --scale 0.8 --dt_gamma 0 --time_frame 0.5
     --synthetic_res 800` and a bbox `seal.json` the script writes (the
     content of a shell of radius 0.36 around (0, 0.1, 0) moved by +0.3 in
     y, its hue turned); cut: 2 pretraining epochs (100), local point step
     0.01 (0.001), 4 epochs of 128 distillation steps (625). Checks: K3 and
     K4 launched, K1 and K2 not; (a) the proxied views' times all 0.5; (b)
     the student's deform leaves bit for bit the teacher's, its tables
     moved; (c) on the val views at t = 0.5 the student's MSE to the edited
     teacher below 0.8 x the unedited teacher's (the reference's own
     criterion, tests/test_editing.py:293); (d) one proxied view (render_occ
     through K3) against the same view through K3's plain version >= 40 dB;
     (e) one pretraining step (8,192 zone points) through K3/K4 against
     plain: loss within rtol 1e-4; the L1's cotangents, taken from the
     plain forward, through K4 and through its plain version, grads per
     leaf within 5e-2 of max |plain|. The proxy renders every view as the
     reference's does, through render_occ (the packed march, up to 1024
     samples a ray, chunks of 4096 rays with 64 packed samples a ray) on
     the teacher's force-filled occupancy, K3 on the kept samples: K3 must
     launch under it, no other kernel. Prints the proxy seconds and its
     launches, the teacher point queries and their seconds, pretraining
     ms/step, distillation ms/step and rays/s, main's wall seconds and the
     student's PSNR against the edited and the unedited teacher.
  8b. static edit: the same through `main_SealNeRF.main([...])` on phase
     5's trained field, 2 pretraining epochs and 2 of distillation; K1 and
     K2 launched, K3 and K4 not, K1 alone under the proxy; checks (b)-(e).
  9. bound-2 training: `main_nerf.main(["synthetic", "-O", "--iters",
     "512", "--ckpt", "scratch", "--synthetic_res", "800", ...])` with no
     --bound or --dt_gamma: the CLI's defaults, bound 2 and dt_gamma 1/128,
     so the default line scales and no VM planes, two cascades, the
     cascade march with growing steps; 48 views at 800x800, 4096 rays a
     step. Before it the seeded field of the same options is served
     (mark, rebuild, evaluate). Checks: 512 finite losses, K2 once a step
     and K1 launched, the last 64 losses below half the first 64, val PSNR
     at least 5 dB above the seeded field's, the refreshes wrote cells of
     both cascades, main wrote the 6 test frames; then phase 5b's one-step
     comparison on this zero-plane field at 1e-2. Prints ms/step and rays/s
     without the first epoch.
  9b. bound-2 serving: phase 5c's checks on phase 9's field.
  10. NGP training: the seeded Instant-NGP field of `main_nerf
     --backbone ngp` at the CLI's defaults (bound 2, dt_gamma 1/128: the
     packed march's closed-form ladder, two cascades; 16 levels x 2, 2^19
     entries a level, desired resolution 4096) is served (a full sweep of
     both cascades, one timed 800x800 frame through Trainer.render_image,
     val PSNR); then `main_nerf.main([... "--backbone", "ngp", "--iters",
     "512", ...])` on the 48 views at 800x800, 4096 rays a step. Checks:
     512 finite losses, the last 64 below half the first 64, val PSNR at
     least 5 dB above the seeded field's, the refreshes wrote cells of both
     cascades, main wrote the 6 test frames. Prints ms/step and rays/s
     without the first epoch, ms per 800x800 frame, and K1-K4's launches
     (none: the NGP path is plain PyTorch, as the reference's is XLA).
  10b. D-NeRF NGP training: `main_dnerf.main([... "--bound", "2", "--iters",
     "256", ...])` routes to the D-NeRF deform field (8 x 128 deform tower,
     tiled canonical grid, NGP towers) and Trainer; cut from 300,000 steps,
     with the tables at 1e-2 and the towers at 1e-3 (at the backbone's 5e-4
     the loss does not move within 256 steps, as in the reference at a cut
     schedule: tests/test_torch_dnerf_band.py): 256 finite losses whose last
     64 lie below the first 64, and a finite 800x800 frame at t = 0.5
     (timed), which differs from the frame at t = 0.
  11. D-NeRF edit: `main_seald.main([...])` at the CLI's defaults (bound 2,
     dt_gamma 1/128, backbone auto: the D-NeRF field and the non-fast
     StudentTrainer, in plain PyTorch) on phase 10b's trained field, phase
     8's edit at `--time_frame 0.5`; cut: 2 pretraining epochs (100), local
     point step 0.01 (0.001), 3 epochs of 128 distillation steps (625), at
     phase 10b's rates (1e-2 / 1e-3; the script prints why). Checks: the
     trainer and the full-width DNeRFConfig(bound=2); K1-K4 not launched
     under main; the student starts at the teacher's iter_density; the
     tower and deform leaves bit for bit the teacher's after every
     pretraining epoch, the deform leaves after the edit, the grid moved;
     on the val views at t = 0.5 the student's MSE to the edited teacher's
     proxy at most 0.8 x the unedited teacher's; 6 test frames. Prints
     main's wall seconds and its split (proxy, queries and zone sizes,
     pretraining and distillation ms/step, the rest), iter_density.
  11b. Instant-NGP edit: the same through `main_SealNeRF.main([...])` at
     its defaults (its rate 1e-2) on phase 10's field, NGPConfig(bound=2),
     2 epochs of distillation.
  12. main-CLI options, at full width: `main_nerf synthetic -O --bound 1
     --dt_gamma 0` through cli.build_trainer, 256 steps each, preloaded,
     with --error_map, with --patch_size 8 (4,096 rays: 64 patches) and with
     --no_preload; `main_nerf --backbone ngp --error_map` and `main_dnerf
     -O --bound 1 --dt_gamma 0 --error_map` (K3 and K4), 128 steps each;
     then phase 5's trained field as `main_nerf --test` serves it:
     test(write_video=True) on the 6 val views and save_mesh(resolution=256,
     threshold=10). Checks: every loss finite; the error map's rows moved
     away from ones (>= 0.75 of the rows a run could draw) and the rays of
     16 further draws fall in their row's top-decile cells more often than
     uniform draws would (> 10 %); the patch term positive; under
     --no_preload the images in pinned host memory and no device copy of
     them, and the val PSNR within 1 dB of the preloaded run's (the same
     seed draws the same rays); the dynamic run launched K3 and K4 (one a
     step); the 6 PNG frames written (and the mp4 where an encoder
     imports); a mesh of more than 0 triangles through K1. Prints each
     run's ms/step beside phases 5, 7 and 10's, the mesh's seconds split
     into the density sweep and the tetrahedra, and the launches.
  13. the remaining workloads, at full width: (a) `main_tensoRF.main([...])`
     at the CLI's defaults (VM, bound 2, resolution 128 -> 300, ranks 16 /
     48, 27 appearance features, the 3 x 64 colour tower, lr0 2e-2 / lr1
     1e-3) on phase 9's procedural scene at 800x800, 4096 rays a step; cut:
     30,000 iterations to 640, its five upsamples at steps 64-320 (the CLI's
     2000-7000 lie past the cut and the flag appends, so the phase sets the
     parsed list). Checks: each upsample at its step with the reference's
     resolutions (152, 180, 213, 253, 300), 640 finite losses, the last 64
     below the first 64, the val PSNR above the seeded field's, the 6 test
     frames. (d) on that field, 16 GT-free semantic steps at 128x128 with an
     injected objective (the image's mean square): its value on 4 fixed views
     falls and the params move; whether local CLIP weights exist is printed.
     (b) `main_CCNeRF.main([...])` at its defaults (CP rank 64 at 128, bound
     1, the K-loss at 0.25 and 0.5: three renders a step), 256 steps: finite
     losses whose last 64 lie below the first 64, a frame at rank 0.25 that
     differs from full rank; then `--compose --compose_models WS WS`: 6
     finite composed 800x800 frames. (c) `main_sdf.main([...])` on the
     procedural sphere at the CLI's 2^18 points a step and 512^3 export; cut:
     20 epochs to 2 (200 steps). Checks: epoch 2's mean loss below epoch 1's,
     a mesh with triangles whose vertices' mean radius lies within 0.05 of
     the normalised training mesh's. Prints ms/step (the step alone,
     synchronised, as medians) before the first and after the last upsample,
     ms per frame, ms/step split into the host's draws and BVH queries and
     the device's step (the BVH's queries of one batch timed on one host
     thread, as the reference's, and split over QUERY_THREADS), and the
     export's sweep and tetrahedra seconds. K1-K4 launch 0 times (plain
     PyTorch, as the reference's XLA).
  14. device kernels: each device kernel of K3 (on phase 3c's samples at t =
     0.37) and of K4 (on phase 3d's, re-gained tower) timed by itself with
     torch.profiler, the tower's beside its own bounds. It runs last, after
     every phase that times a step or a frame: a profiling session may leave
     a cost on every later launch of the process
     (profiling/torch_profiler_residue.py measures it).
The procedural scene of given arguments is made once per run (~13 s at
800x800) and each later caller gets a copy, so the "data" times after a
scene's first use are those of the copy; the script prints how many scenes
were made and how many copies handed out.
The launch counts of the kernels record are read from the main paths'
runs (phases 4, 5, 5c, 6, 7, 7c, 8, 8b, 9, 9b, 12 and 13; 8 and 8b include
the proxy's launches through render_occ; 10, 10b, 11, 11b and 13 launch
none), with the counters set to 0 just before each. Each
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
# phase 10b: D-NeRF NGP training steps (its grid sweeps 8 of 64 time bins
# in full every 2 steps for the first 16 passes)
NGP_DYN_STEPS = 256
# phases 8 and 8b: pretraining epochs and distillation epochs of 128 steps
EDIT_PRE_EPOCHS, EDIT_EPOCHS = 2, 4
EDIT_PRE_EPOCHS_STATIC, EDIT_EPOCHS_STATIC = 2, 2
# phases 11 and 11b: the same for the NGP-family edits, and their local
# zone's point step (the CLI's 0.001 puts ~7.5e8 points in the edit)
NGP_EDIT_PRE_EPOCHS = 2
NGP_EDIT_EPOCHS, NGP_EDIT_EPOCHS_STATIC = 3, 2
NGP_EDIT_LOCAL_STEP = 0.01
# phase 12: steps of the static runs and of the NGP and dynamic ones
OPTION_STEPS, OPTION_STEPS_SHORT = 256, 128
# ms/step of phases 5, 7 and 10, printed beside phase 12's runs
STEP_MS = {}
# phase 13: main_tensoRF's iterations (cut from 30,000) and the steps of its
# five upsamples (the CLI's 2000-7000 lie past the cut), main_CCNeRF's steps
# (cut from 30,000), main_sdf's epochs (cut from 20), and the semantic steps
# at their render size
TENSORF_STEPS = 640
TENSORF_UPSAMPLES = (64, 128, 192, 256, 320)
CCNERF_STEPS = 256
SDF_EPOCHS = 2
SEMANTIC_STEPS, SEMANTIC_RES = 16, 128
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
    "dyn_bwd" (K4: K2's work plus the deform tower's recompute, dX and dW),
    or the deform tower alone: "tower" (K3's warp, xw = x + dx) and
    "tower_bwd" (K4's tower: recompute, input and weight gradients of the
    live samples, from x and g_x to the matrices' gradients).
    m_live: the samples whose cotangent is not all zero, which alone cost a
    backward kernel operations (default: all). lod_skip: line scales whose
    features are zero, which need no taps and no rows of the first matrix."""
    from sealdnerf_tpu_torch.models.cp import _deform_dims, _tower_dims
    if mode in ("tower", "tower_bwd"):
        dd = _deform_dims(cfg)
        nx = cfg.deform_space_dim
        dmacs = nx * dd[1] + sum(a * b for a, b in zip(dd[1:-1], dd[2:]))
        d_elems = dmacs + (dd[0] - nx) * dd[1]
        enc = 2 * 6 * cfg.multires_deform
        if mode == "tower":
            return m * 24 + 2 * d_elems, 2 * dmacs * m, enc * m
        live = m if m_live is None else m_live
        return (live * 24 + (2 + 4) * d_elems, 3 * 2 * dmacs * live,
                enc * live)
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


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _kernel_ms(fn, reps, names):
    """Device ms a call of each named device kernel (a substring of its
    name) over `reps` calls of fn, by torch.profiler, after one warm call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = torch.autograd.DeviceType.CUDA
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        if e.device_type == dev:
            for n in names:
                if n in e.key:
                    out[n] += e.device_time_total / 1e3 / reps
    return out


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
    from sealdnerf_tpu_torch.ops.field import (DYN_CHUNK, dyn_field_forward,
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
    # the warp's scratch holds one chunk: any chunking gives the same bits
    whole = dyn_field_forward(tables, cfg, x3, d3, 0.37, chunk=m)
    for chunk in (1 << 18, 100_003):
        if not torch.equal(dyn_field_forward(tables, cfg, x3, d3, 0.37,
                                             chunk=chunk), whole):
            raise AssertionError(f"K3 in chunks of {chunk} differs from K3 "
                                 "in one pass")
    if not torch.equal(t_host, whole):
        raise AssertionError("K3 at the default chunk differs from K3 in "
                             "one pass")
    del whole
    print(f"K3 in chunks of 2^18, of 100,003 and of the default "
          f"{DYN_CHUNK} samples equals K3 in one pass of {m} bit for bit",
          flush=True)
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
                                               dyn_field_forward,
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
            # 0. K4's warp is K3's (one device function): bit for bit.
            fwd = {}
            dyn_field_forward(tables, cfg, x3, d3, t, parts=fwd)
            live = parts["live"]
            if not torch.equal(parts["xw"][:, live], fwd["xw"][:, live]):
                raise AssertionError(f"K4's warp differs from K3's ({tower})")
            print(f"K4 {tower}: the warped positions of its {live.numel()} "
                  "listed samples equal K3's bit for bit", flush=True)
            del fwd
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
    STEP_MS["5"] = ms_step
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
    _frame_memory(trainer, tables, occ_m, val, t, frames[0])
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


def _frame_memory(trainer, tables, occ_m, val, t, frame):
    """C4: the device memory of K3's call in one 800x800 frame, with the
    warp's scratch for all M samples (chunk = M, the layout before the
    chunking) and at the default chunk. The peak counter is reset just
    before the call and read just after it; the frame's own peak is the
    larger of the peaks before, in and after the call. Both frames must be
    the evaluated one bit for bit."""
    import torch
    from sealdnerf_tpu_torch.ops.field import DYN_CHUNK, dyn_field_forward
    from sealdnerf_tpu_torch.render.fast_image import render_image_tiled
    cfg, dev = trainer.field.cfg, trainer.device
    out = {}
    for tag, chunk in (("one chunk of all M", None), ("default", DYN_CHUNK)):
        rec = {}

        def fwd(tabs, x3, d3, tt):
            torch.cuda.synchronize()
            rec["before"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            rec["base"] = torch.cuda.memory_allocated()
            o = dyn_field_forward(tabs, cfg, x3, d3, tt,
                                  chunk=x3.shape[1] if chunk is None
                                  else chunk)
            torch.cuda.synchronize()
            rec["call"] = torch.cuda.max_memory_allocated()
            rec["m"] = x3.shape[1]
            torch.cuda.reset_peak_memory_stats()
            return o

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            img, _ = render_image_tiled(
                tables, occ_m, torch.as_tensor(val.poses[0], device=dev),
                torch.as_tensor(val.intrinsics, device=dev), val.h, val.w,
                trainer.render_cfg, fwd, torch.ones(3, device=dev),
                tile_px=trainer._pick_tile(val.h, val.w),
                dilate=trainer.opt.render_dilate,
                density_scale=trainer.opt.density_scale,
                t_thresh=trainer.opt.t_thresh, extra=(t,))
        torch.cuda.synchronize()
        frame_peak = max(rec["before"], rec["call"],
                         torch.cuda.max_memory_allocated())
        if not np.array_equal(img.cpu().numpy(), frame):
            raise AssertionError(f"the frame with K3 at {tag} differs from "
                                 "the evaluated one")
        out[tag] = rec["call"]
        print(f"C4 memory, K3 at {tag} (M = {rec['m']}): the call's peak "
              f"{rec['call'] / 2**20:.1f} MiB ({(rec['call'] - rec['base']) / 2**20:.1f} "
              f"MiB above the {rec['base'] / 2**20:.1f} MiB allocated before "
              f"it); the frame's peak {frame_peak / 2**20:.1f} MiB",
              flush=True)
    drop = out["one chunk of all M"] - out["default"]
    print(f"C4 memory: the call's peak falls by {drop / 1e6:.1f} MB at the "
          f"default chunk; both frames equal the evaluated one bit for bit",
          flush=True)
    if drop < 900e6:
        raise AssertionError(f"K3's peak fell by {drop / 1e6:.1f} MB, not "
                             "900 MB")


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
    STEP_MS["7"] = ms_step
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


def _edit_config():
    """The bbox edit of the reference's editing tests at full scale: the
    content of a shell of radius 0.36 around (0, 0.1, 0) (sphere 0 of the
    synthetic scene) moved by +0.3 in y and its hue turned."""
    t = np.eye(4)
    t[1, 3] = 0.3
    gr = np.random.default_rng(3).normal(size=(256, 3))
    gr /= np.linalg.norm(gr, axis=-1, keepdims=True)
    return {"type": "bbox", "raw": (gr * 0.36 + [0.0, 0.1, 0.0]).tolist(),
            "transform": t.tolist(), "scale": [1, 1, 1],
            "boundType": "both", "hsv": [0.35, 0.1, 0.0]}


def phase_edit(dynamic, teacher_ws, pre_epochs, extra_epochs):
    """Phase 8 (dynamic, main_seald) or 8b (static, main_SealNeRF): a Seal
    edit of a trained teacher through the CLI's main, then its checks.
    Returns the launches of K1-K4 in the main's run."""
    import torch
    from sealdnerf_tpu_torch import main_seald, main_SealNeRF
    from sealdnerf_tpu_torch.editing.student import (FastStudentTrainer,
                                                     freeze_labels,
                                                     pretrain_l1)
    from sealdnerf_tpu_torch.models.cp import param_leaves
    from sealdnerf_tpu_torch.ops.field import (dyn_field_backward,
                                               dyn_field_backward_plain,
                                               dyn_field_forward,
                                               dyn_field_forward_plain,
                                               field_backward,
                                               field_backward_plain,
                                               field_forward,
                                               field_forward_plain)
    from sealdnerf_tpu_torch.train.metrics import psnr

    tag = "8" if dynamic else "8b"
    mod = main_seald if dynamic else main_SealNeRF
    ws = os.path.join(REPO, "workspace",
                      "chip_smoke_edit" if dynamic else "chip_smoke_edit_static")
    os.makedirs(ws, exist_ok=True)
    with open(os.path.join(ws, "seal.json"), "w") as f:
        json.dump(_edit_config(), f)
    argv = ["synthetic", "-O", "--bound", "1.0", "--scale", "0.8",
            "--dt_gamma", "0", "--synthetic_res", "800",
            "--teacher_workspace", teacher_ws, "--workspace", ws,
            "--seal_config", "seal.json",
            "--pretraining_epochs", str(pre_epochs),
            "--pretraining_local_point_step", "0.01",
            "--extra_epochs", str(extra_epochs)]
    if dynamic:
        argv += ["--time_frame", "0.5"]
    print(f"phase {tag} cuts: pretraining epochs 100 -> {pre_epochs}; local "
          f"point step 0.001 -> 0.01; distillation ceil(30,000 / 48) = 625 "
          f"epochs -> --extra_epochs {extra_epochs} of 128 steps",
          flush=True)
    fns = (field_forward, field_backward, dyn_field_forward,
           dyn_field_backward)
    # the launches under the proxy, which renders through render_occ
    proxy_launches = [0, 0, 0, 0]
    proxy = FastStudentTrainer.proxy_dataset

    def counted_proxy(self, *a, **kw):
        before = [fn.launches for fn in fns]
        out = proxy(self, *a, **kw)
        for i, fn in enumerate(fns):
            proxy_launches[i] += fn.launches - before[i]
        return out

    for fn in fns:
        fn.launches = 0
    FastStudentTrainer.proxy_dataset = counted_proxy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        FastStudentTrainer.proxy_dataset = proxy
    launches = [fn.launches for fn in fns]
    tt = st.teacher_trainer
    k1, k2, k3, k4 = launches
    if dynamic and not (k3 > 0 and k4 > 0 and k1 == 0 and k2 == 0):
        raise AssertionError(f"dynamic edit launches K1-K4 {launches}")
    if not dynamic and not (k1 > 0 and k2 > 0 and k3 == 0 and k4 == 0):
        raise AssertionError(f"static edit launches K1-K4 {launches}")
    # the proxy's forward is K1 (static) or K3 (dynamic), and only that
    want = [0, 0, 1, 0] if dynamic else [1, 0, 0, 0]
    if [int(n > 0) for n in proxy_launches] != want:
        raise AssertionError(f"proxy launches K1-K4 {proxy_launches}")
    # (a) the proxied views are pinned to the edit's frame
    tv = st.proxied["valid"]
    if dynamic:
        for name, ds in st.proxied.items():
            if not np.all(ds.times == np.float32(0.5)):
                raise AssertionError(f"proxied {name} times {ds.times}")
    # (b) the deform tower is the teacher's bit for bit; the tables moved
    labels = freeze_labels(st.params)
    for k in st.params:
        for a, b in zip(param_leaves(st.params[k]),
                        param_leaves(tt.params[k])):
            same = torch.equal(a, b)
            if labels[k] == "deform" and not same:
                raise AssertionError(f"the student's {k} moved")
            if labels[k] == "enc" and same:
                raise AssertionError(f"the student's {k} did not move")
    # (c) the student is nearer the edited teacher than the unedited one
    t = 0.5 if dynamic else None
    mse_s, mse_u, ps, pu = [], [], [], []
    for i in range(len(tv)):
        img, _ = st.render_image(tv.poses[i], tv.intrinsics, tv.h, tv.w,
                                 time=t)
        ref, _ = st.render_teacher_image(tv.poses[i], tv.intrinsics, tv.h,
                                         tv.w, time=t, edited=False)
        gt = tv.images[i]
        mse_s.append(float(np.mean((img - gt) ** 2)))
        mse_u.append(float(np.mean((ref - gt) ** 2)))
        ps.append(psnr(img, gt))
        pu.append(psnr(img, ref))
    hist = st.history
    spe = max(len(st.proxied["train"]), st.opt.segment_steps)
    warm = hist["epoch_s"][1:] or hist["epoch_s"]
    dist_ms = sum(warm) / (len(warm) * spe) * 1e3
    n_pre = sum(z["points"].shape[0] for z in st.pretraining_data.values())
    pre_ms = float(np.mean(st.time_inspector["pretraining"])) / n_pre * 1e3
    print(f"phase {tag} edit: {wall:.2f} s wall for main; proxy "
          f"{len(st.proxied['train'])} + {len(tv)} views at {tv.h}x{tv.w} in "
          f"{st.proxy_seconds:.2f} s through render_occ"
          + (" (the tiled renderer's proxy of this phase took 16.14 s on an "
             "NVIDIA H100 80GB HBM3 at 700 W)" if dynamic else "")
          + f", its launches K1 {proxy_launches[0]} K3 "
          f"{proxy_launches[2]}; {st.query_points} teacher point "
          f"queries in {st.query_seconds:.2f} s; pretraining {pre_epochs} x "
          f"{n_pre} steps of {st.pretraining_batch_size} points, "
          f"{pre_ms:.3f} ms/step; distillation {len(hist['loss'])} steps, "
          f"{dist_ms:.3f} ms/step, {st.opt.num_rays * 1e3 / dist_ms:.1f} "
          f"rays/s over epochs 2-{len(hist['epoch_s'])}; launches K1 {k1} "
          f"K2 {k2} K3 {k3} K4 {k4}", flush=True)
    print(f"phase {tag} edit: val MSE student vs edited teacher "
          f"{np.mean(mse_s):.6f}, unedited vs edited teacher "
          f"{np.mean(mse_u):.6f}; PSNR student vs edited teacher "
          f"{np.mean(ps):.3f} dB, vs unedited teacher {np.mean(pu):.3f} dB",
          flush=True)
    if not np.mean(mse_s) < 0.8 * np.mean(mse_u):
        raise AssertionError(f"the student is not nearer the edit: MSE "
                             f"{np.mean(mse_s)} vs {np.mean(mse_u)}")
    # (d) one proxied view (render_occ through the kernel) against the same
    # view through the kernel's plain version
    kern = tv.images[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain, _ = st.render_teacher_image(tv.poses[0], tv.intrinsics, tv.h,
                                       tv.w, time=t, plain=True)
    ms_p = (time.perf_counter() - t0) * 1e3
    p = psnr(kern, plain)
    print(f"phase {tag} proxied view through render_occ, kernel vs plain: "
          f"PSNR {p:.2f} "
          f"dB, max|diff| {np.abs(kern - plain).max():.3g}; plain frame "
          f"{ms_p:.1f} ms", flush=True)
    if p < 40.0:
        raise AssertionError(f"proxied view PSNR {p:.2f} < 40 dB")
    # (e) one pretraining step through the kernels and their plain versions:
    # the L1's cotangents are taken from the plain forward and fed to both
    # backwards (a point whose residual lies within the kernels' noise of 0
    # would take the other sign of the L1's subgradient, which is the loss's
    # doing and not the backward's)
    batch = {k: v[0] for k, v in st.pretraining_data["local"].items()}
    cfg, tables = st.field.cfg, st.field.kernel_tables(st.params)
    x3 = batch["points"].t().contiguous()
    d3 = batch["dirs"].t().contiguous()
    tt_ = (0.5,) if dynamic else ()
    fwd, fwd_p, bwd, bwd_p = (
        (dyn_field_forward, dyn_field_forward_plain, dyn_field_backward,
         dyn_field_backward_plain) if dynamic else
        (field_forward, field_forward_plain, field_backward,
         field_backward_plain))
    before = [fn.launches for fn in fns]
    with torch.no_grad():
        out_p = fwd_p(tables, cfg, x3, d3, *tt_)
    out_p.requires_grad_(True)
    loss_p = pretrain_l1(out_p, batch)
    g = torch.autograd.grad(loss_p, out_p)[0].contiguous()
    grads_p = bwd_p(tables, cfg, x3, d3, *tt_, g)
    torch.cuda.synchronize()
    if [fn.launches for fn in fns] != before:
        raise AssertionError("the plain pretraining step launched a kernel")
    with torch.no_grad():
        loss_k = pretrain_l1(fwd(tables, cfg, x3, d3, *tt_), batch)
    grads_k = bwd(tables, cfg, x3, d3, *tt_, g)
    torch.cuda.synchronize()
    n = sum(a - b for a, b in zip([fn.launches for fn in fns], before))
    if n != 2:
        raise AssertionError(f"the kernel pretraining step: {n} launches")
    lk, lp = loss_k.item(), loss_p.item()
    ratios, _ = _grad_errs(grads_k, grads_p)
    print(f"phase {tag} one pretraining step of {x3.shape[1]} points, kernel "
          f"vs plain: loss {lk:.8f} vs {lp:.8f}; grads max|k-p|/max|p| "
          + " ".join(f"{k} {v:.3g}" for k, v in ratios.items()), flush=True)
    if abs(lk - lp) > 1e-4 * abs(lp):
        raise AssertionError(f"pretraining loss kernel {lk} vs plain {lp}")
    bad = {k: v for k, v in ratios.items() if not v <= TRAINED_STEP_TOL}
    if bad:
        raise AssertionError(f"pretraining grads beyond {TRAINED_STEP_TOL}: "
                             f"{bad}")
    return launches

def phase_trained_frames(trainer, val, tag):
    """Phases 5c, 7c and 9b: a trained field served as render_image serves
    it. Its occupancy must be below 15 %, so that render_image takes the
    bucketed renderer (termination trim, the eval ladder's buckets). On
    view 0 (at t = 0.5 for a time-conditioned field), after
    warm_renderers, through the field kernel (K1, or K3), each timed: the
    tiled frame, the bucketed frame that render_image picks, the LOD
    preview (the 1024 line scale skipped, the preview ladder) and the trim
    alone (render_splits set to one full-budget bucket); then the bucketed
    frame and the preview through the kernel's plain version. Checks: the
    tiled frame launches the kernel once, the others at least twice (the
    trim's probe and the buckets); the trim alone against tiled >= 40 dB;
    the bucketed frame and the preview through the kernel against plain
    >= 40 dB each. The bucketed frame's and the preview's distance to the
    tiled frame (the reference's ladders subsampling tiles over budget)
    are printed. Returns the kernel's launches in the four frames."""
    import dataclasses

    import torch
    import sealdnerf_tpu_torch.train.fast as tfast
    from sealdnerf_tpu_torch.ops.field import (dyn_field_forward,
                                               dyn_field_forward_plain,
                                               field_forward,
                                               field_forward_plain)
    from sealdnerf_tpu_torch.train.metrics import psnr

    dyn = trainer.time_conditioned
    kernel = dyn_field_forward if dyn else field_forward
    t = 0.5 if dyn else None
    pose, intr, h, w = val.poses[0], val.intrinsics, val.h, val.w
    occ = trainer.grid_state["occ"]
    share = occ.float().mean().item()
    per_cas = [round(occ[..., c, :, :, :].float().mean().item(), 4)
               for c in range(occ.shape[-4])]
    if not trainer._use_buckets():
        raise AssertionError(f"phase {tag}: occupancy {share:.4f} is not "
                             "below 0.15: render_image would not bucket")
    trainer.warm_renderers(h, w, pose, intr, time=t)

    def frame(**kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = kernel.launches
        t0 = time.perf_counter()
        img, _ = trainer.render_image(pose, intr, h, w, time=t, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if img.shape != (h, w, 3) or not np.isfinite(img).all():
            raise AssertionError(f"phase {tag}: bad frame {img.shape}")
        return img, ms, kernel.launches - before, \
            torch.cuda.max_memory_allocated() / 2 ** 20

    kernel.launches = 0
    tiled, ms_t, n_t, mem_t = frame(buckets=False)
    buck, ms_b, n_b, mem_b = frame()
    prev, ms_p, n_p, mem_p = frame(lod=True)
    opt = trainer.opt
    trainer.opt = dataclasses.replace(opt, render_splits=((1.0, 1),))
    try:
        trim, ms_tr, n_tr, _ = frame()
    finally:
        trainer.opt = opt
    launches = kernel.launches
    if n_t != 1 or min(n_b, n_p, n_tr) < 2:
        raise AssertionError(f"phase {tag}: launches tiled {n_t}, bucketed "
                             f"{n_b}, preview {n_p}, trim alone {n_tr}")
    # the trainer's forward through the kernel's plain version, the LOD
    # skip included
    name = "dyn_field_forward" if dyn else "field_forward"
    setattr(tfast, name, dyn_field_forward_plain if dyn
            else field_forward_plain)
    try:
        img_p, ms_plain, n_plain, _ = frame()
        prev_p, _, n_prev_plain, _ = frame(lod=True)
    finally:
        setattr(tfast, name, kernel)
    if n_plain or n_prev_plain:
        raise AssertionError(f"phase {tag}: the plain frames launched the "
                             "kernel")
    p_bt, p_pt, p_trt = psnr(buck, tiled), psnr(prev, tiled), psnr(trim,
                                                                   tiled)
    p_bp, p_pp = psnr(buck, img_p), psnr(prev, prev_p)
    print(f"phase {tag} trained frames on {_card()}, {h}x{w}"
          + (f" at t={t}" if dyn else "") + f": occupancy {share:.4f} "
          f"(cascades {per_cas}); tiled {ms_t:.2f} ms ({n_t} launch, peak "
          f"{mem_t:.1f} MiB), bucketed {ms_b:.2f} ms ({n_b} launches, peak "
          f"{mem_b:.1f} MiB), preview {ms_p:.2f} ms ({n_p} launches), trim "
          f"alone {ms_tr:.2f} ms ({n_tr} launches), bucketed through the "
          f"plain version {ms_plain:.2f} ms; PSNR against tiled: bucketed "
          f"{p_bt:.2f} dB, preview {p_pt:.2f} dB, trim alone {p_trt:.2f} "
          f"dB; kernel vs plain: bucketed {p_bp:.2f} dB, preview "
          f"{p_pp:.2f} dB", flush=True)
    for name, p in (("trim alone vs tiled", p_trt),
                    ("bucketed kernel vs plain", p_bp),
                    ("preview kernel vs plain", p_pp)):
        if not p >= 40.0:
            raise AssertionError(f"phase {tag}: {name} PSNR {p:.2f} < 40")
    return launches


def phase_bound2_training():
    """Phase 9: main_nerf at the CLI's defaults (bound 2, dt_gamma 1/128,
    --planes auto = no VM planes, two cascades), trained in-process; then
    one train step through the kernels against their plain versions."""
    import torch
    from sealdnerf_tpu_torch import main_nerf
    from sealdnerf_tpu_torch.cli import (base_parser, build_trainer,
                                         load_datasets, postprocess)
    from sealdnerf_tpu_torch.ops.field import field_backward, field_forward

    ws = os.path.join(REPO, "workspace", "chip_smoke_bound2")
    argv = ["synthetic", "-O", "--iters", str(TRAIN_STEPS), "--ckpt",
            "scratch", "--synthetic_res", "800", "--workspace", ws]
    opt = postprocess(base_parser().parse_args(argv))
    if (opt.bound, opt.dt_gamma, opt.planes) != (2.0, 1 / 128, "auto"):
        raise AssertionError(f"not the CLI's defaults: {opt}")
    # the seeded field, served as `--test` serves it: the floor of the PSNR
    t0 = time.perf_counter()
    train, val, _ = load_datasets(opt)
    data_s = time.perf_counter() - t0
    seeded, field = build_trainer(opt, name="ngp")
    mc = seeded.march_cfg
    if field.cfg.planes != () or not mc.multi or mc.cascades != 2 \
            or seeded.grid_cfg.cascades != 2:
        raise AssertionError(f"bound-2 trainer: planes {field.cfg.planes}, "
                             f"march {mc}")
    seeded.mark_untrained_grid(train.poses, train.intrinsics)
    seeded.rebuild_grid()
    psnr0 = seeded.evaluate(val)
    del seeded
    torch.cuda.empty_cache()

    field_forward.launches = 0
    field_backward.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = main_nerf.main(argv)
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
    if k2 < steps or k1 < 1:
        raise AssertionError(f"launches in {steps} steps: K1 {k1}, K2 {k2}")
    steps_per_epoch = max(len(train), trainer.opt.segment_steps)
    ms_step = sum(hist["epoch_s"][1:]) / (steps - steps_per_epoch) * 1e3
    first, last = losses[:64].mean(), losses[-64:].mean()
    dg = trainer.grid_state["density_grid"]
    occ = trainer.grid_state["occ"]
    written = [int((dg[c] > 0).sum()) for c in range(dg.shape[0])]
    per_cas = [round(occ[c].float().mean().item(), 4)
               for c in range(occ.shape[0])]
    psnr = trainer.stats["results"][-1]
    frames = sorted(os.listdir(os.path.join(ws, "results")))
    print(f"phase 9 bound-2 train (main_nerf at the CLI defaults) on "
          f"{_card()}: data "
          f"{data_s:.2f} s; main {wall:.2f} s wall; {steps} steps x "
          f"{trainer.opt.num_rays} rays, {ms_step:.3f} ms/step, "
          f"{trainer.opt.num_rays * 1e3 / ms_step:.1f} rays/s over epochs "
          f"2-{len(hist['epoch_s'])} (idle share not measured here: "
          f"profiling/torch_train_profile.py --bound2); mean n_samples/step "
          f"{np.mean(hist['n_samples']):.1f}; launches K1 {k1} K2 {k2}; "
          f"grid cells written per cascade {written}, occupancy per cascade "
          f"{per_cas}; loss first 64 {first:.6f} last 64 {last:.6f}; val "
          f"PSNR {psnr:.3f} dB (seeded field {psnr0:.3f} dB); {len(frames)} "
          "test frames written", flush=True)
    if not last < 0.5 * first:
        raise AssertionError(f"loss did not halve: {first} -> {last}")
    if not psnr >= psnr0 + 5.0:
        raise AssertionError(f"val PSNR {psnr:.3f} not 5 dB above the seeded "
                             f"field's {psnr0:.3f}")
    if min(written) < 1:
        raise AssertionError(f"a cascade holds no refreshed cell: {written}")
    if len(frames) != len(val):
        raise AssertionError(f"test frames written: {frames}")
    phase_one_step(trainer, train)
    return trainer, val, k1, k2


def _frame_ms(trainer, pose, intrinsics, t=None):
    """One warm 800x800 frame through render_image: (ms, rgb)."""
    import torch
    trainer.render_image(pose, intrinsics, 800, 800, time=t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, _ = trainer.render_image(pose, intrinsics, 800, 800, time=t)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, img


def _orbit_view(radius=2.0, res=800, fov=0.9):
    """A camera of the synthetic scene's orbit: (pose, intrinsics)."""
    from sealdnerf_tpu_torch.data.rays import rand_poses
    fl = res / (2 * np.tan(fov / 2))
    return (rand_poses(np.random.default_rng(0), 1, radius=radius)[0],
            np.array([fl, fl, res / 2, res / 2], np.float32))


def _kernel_launches():
    from sealdnerf_tpu_torch.ops.field import (dyn_field_backward,
                                               dyn_field_forward,
                                               field_backward, field_forward)
    return (field_forward, field_backward, dyn_field_forward,
            dyn_field_backward)


def _train_stats(trainer, steps, tag):
    """Checks of an NGP-family training run: `steps` finite losses, the
    last 64 below the first 64 -> (ms/step over epochs 2-, first, last)."""
    hist = trainer.history
    losses = np.asarray(hist["loss"])
    if len(losses) != steps or trainer.global_step != steps:
        raise AssertionError(f"phase {tag}: trained {len(losses)} steps, not "
                             f"{steps}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"phase {tag}: non-finite training loss")
    spe = max(48, trainer.opt.segment_steps)
    ms_step = sum(hist["epoch_s"][1:]) / (steps - spe) * 1e3
    return ms_step, losses[:64].mean(), losses[-64:].mean()


def phase_ngp_training():
    """Phase 10: main_nerf --backbone ngp at the CLI's defaults (bound 2,
    dt_gamma 1/128: the packed march's closed-form ladder, two cascades),
    the Instant-NGP field at full width, after the seeded field is
    served."""
    import torch
    from sealdnerf_tpu_torch import main_nerf
    from sealdnerf_tpu_torch.cli import (base_parser, build_trainer,
                                         load_datasets, postprocess)
    from sealdnerf_tpu_torch.models.ngp import NGPConfig
    from sealdnerf_tpu_torch.train.trainer import Trainer

    ws = os.path.join(REPO, "workspace", "chip_smoke_ngp")
    argv = ["synthetic", "-O", "--backbone", "ngp", "--iters",
            str(TRAIN_STEPS), "--ckpt", "scratch", "--synthetic_res", "800",
            "--workspace", ws]
    opt = postprocess(base_parser().parse_args(argv))
    if (opt.bound, opt.dt_gamma) != (2.0, 1 / 128):
        raise AssertionError(f"not the CLI's defaults: {opt}")
    train, val, _ = load_datasets(opt)
    seeded, field = build_trainer(opt, name="ngp")
    full = NGPConfig(bound=2.0)
    if type(seeded) is not Trainer or field.cfg != full or \
            seeded.march.cascades != 2 or \
            tuple(field.params["grid"].shape) != (full.grid_cfg.table_size,
                                                  2):
        raise AssertionError(f"phase 10 trainer {type(seeded)}, field "
                             f"{field.cfg}, march {seeded.march}")
    seeded.mark_untrained_grid(train.poses, train.intrinsics)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seeded.rebuild_grid()
    torch.cuda.synchronize()
    sweep_ms = (time.perf_counter() - t0) * 1e3
    seeded_ms, img0 = _frame_ms(seeded, val.poses[0], val.intrinsics)
    if img0.shape != (800, 800, 3) or not np.isfinite(img0).all():
        raise AssertionError("phase 10: bad seeded frame")
    psnr0 = seeded.evaluate(val)
    del seeded
    torch.cuda.empty_cache()

    fns = _kernel_launches()
    for fn in fns:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = main_nerf.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in fns]
    ms_step, first, last = _train_stats(trainer, TRAIN_STEPS, "10")
    STEP_MS["10"] = ms_step
    dg = trainer.grid_state["density_grid"]
    written = [int((dg[c] > 0).sum()) for c in range(dg.shape[0])]
    occ = [round(trainer.grid_state["occ"][c].float().mean().item(), 4)
           for c in range(dg.shape[0])]
    psnr = trainer.stats["results"][-1]
    frames = sorted(os.listdir(os.path.join(ws, "results")))
    trained_ms, img = _frame_ms(trainer, val.poses[0], val.intrinsics)
    print(f"phase 10 NGP train (main_nerf --backbone ngp at the CLI "
          f"defaults) on {_card()}: seeded field served: 128^3 x 2 sweep "
          f"{sweep_ms:.1f} ms, 800x800 frame {seeded_ms:.1f} ms, val PSNR "
          f"{psnr0:.3f} dB; main {wall:.2f} s wall; {TRAIN_STEPS} steps x "
          f"{trainer.opt.num_rays} rays, {ms_step:.3f} ms/step, "
          f"{trainer.opt.num_rays * 1e3 / ms_step:.1f} rays/s over epochs "
          f"2-{len(trainer.history['epoch_s'])}; mean n_samples/step "
          f"{np.mean(trainer.history['n_samples']):.1f}, packed budget "
          f"{trainer._cur_budget}/ray; launches K1-K4 {launches} (the NGP "
          f"path is plain PyTorch); grid cells written per cascade {written},"
          f" occupancy {occ}; loss first 64 {first:.6f} last 64 {last:.6f}; "
          f"val PSNR {psnr:.3f} dB; trained 800x800 frame {trained_ms:.1f} "
          f"ms; {len(frames)} test frames written", flush=True)
    if not last < 0.5 * first:
        raise AssertionError(f"phase 10: loss did not halve: {first} -> "
                             f"{last}")
    if not psnr >= psnr0 + 5.0:
        raise AssertionError(f"phase 10: val PSNR {psnr:.3f} not 5 dB above "
                             f"the seeded field's {psnr0:.3f}")
    if min(written) < 1:
        raise AssertionError(f"phase 10: a cascade holds no refreshed cell: "
                             f"{written}")
    if len(frames) != len(val) or not np.isfinite(img).all():
        raise AssertionError(f"phase 10: test frames written: {frames}")
    del trainer
    torch.cuda.empty_cache()


def phase_dnerf_ngp_training():
    """Phase 10b: main_dnerf at --bound 2, which routes to the D-NeRF
    deform field (NGP towers, tiled canonical grid) and Trainer's packed
    march, for NGP_DYN_STEPS steps at full width; then a frame at t = 0.5."""
    import torch
    from sealdnerf_tpu_torch import main_dnerf
    from sealdnerf_tpu_torch.models.dnerf import DNeRFConfig
    from sealdnerf_tpu_torch.train.trainer import Trainer

    ws = os.path.join(REPO, "workspace", "chip_smoke_dnerf_ngp")
    argv = ["synthetic", "-O", "--bound", "2", "--iters",
            str(NGP_DYN_STEPS), "--ckpt", "scratch", "--synthetic_res",
            "800", "--workspace", ws]
    opt = main_dnerf.parse_args(argv)
    if (opt.lr, opt.lr_net) != (5e-4, 5e-4):
        raise AssertionError(f"phase 10b rates {opt.lr}, {opt.lr_net}")
    # At 5e-4 / 5e-4 the reference's D-NeRF field does not train within a
    # cut schedule either: tests/test_torch_dnerf_band.py holds the port in
    # the band of three JAX seeds at these rates (ROADMAP section C, C7).
    print(f"phase 10b cuts: 300,000 steps -> {NGP_DYN_STEPS}; at the hash "
          "backbone's rates (5e-4 / 5e-4) the loss does not move within "
          "them, in the reference as in the port, so the tables train at "
          "1e-2 (main_nerf's rate) and the towers at 1e-3", flush=True)
    argv += ["--lr", "1e-2", "--lr_net", "1e-3"]
    fns = _kernel_launches()
    for fn in fns:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = main_dnerf.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in fns]
    if type(trainer) is not Trainer or not trainer.time_conditioned or \
            trainer.field.cfg != DNeRFConfig(bound=2.0):
        raise AssertionError(f"phase 10b trainer {type(trainer)}, field "
                             f"{trainer.field.cfg}")
    ms_step, first, last = _train_stats(trainer, NGP_DYN_STEPS, "10b")
    passes = int(trainer.grid_state["iter_density"])
    view = _orbit_view()
    frame_ms, img = _frame_ms(trainer, *view, t=0.5)
    img2, _ = trainer.render_image(*view, 800, 800, time=0.0)
    print(f"phase 10b D-NeRF NGP train (main_dnerf --bound 2: deform "
          f"variant) on {_card()}: main {wall:.2f} s wall; {NGP_DYN_STEPS} "
          f"steps x {trainer.opt.num_rays} rays, {ms_step:.3f} ms/step, "
          f"{trainer.opt.num_rays * 1e3 / ms_step:.1f} rays/s over epochs "
          f"2-{len(trainer.history['epoch_s'])} (grid refreshes of 8 of 64 "
          f"bins every 2 steps, full sweeps: {passes} passes); mean "
          f"n_samples/step {np.mean(trainer.history['n_samples']):.1f}; "
          f"launches K1-K4 {launches}; loss first 64 {first:.6f} last 64 "
          f"{last:.6f}; val PSNR {trainer.stats['results'][-1]:.3f} dB; "
          f"800x800 frame at t = 0.5 {frame_ms:.1f} ms, max |frame(0.5) - "
          f"frame(0)| {np.abs(img - img2).max():.4f}", flush=True)
    if not last < first:
        raise AssertionError(f"phase 10b: loss did not fall: {first} -> "
                             f"{last}")
    if img.shape != (800, 800, 3) or not np.isfinite(img).all() or \
            np.abs(img - img2).max() == 0:
        raise AssertionError("phase 10b: bad frame at t = 0.5")
    del trainer
    torch.cuda.empty_cache()


def _frozen_leaves_moved(st):
    """The keys of the student's tower ('mlp') and deform leaves that
    differ from the teacher's."""
    import torch
    from sealdnerf_tpu_torch.editing.student import freeze_labels
    from sealdnerf_tpu_torch.models.params import param_leaves
    tt = st.teacher_trainer
    labels = freeze_labels(st.params)
    return sorted(k for k in st.params if labels[k] != "enc" and not all(
        torch.equal(a, b) for a, b in zip(param_leaves(st.params[k]),
                                          param_leaves(tt.params[k]))))


def phase_ngp_edit(dynamic, teacher_ws, extra_epochs,
                   pre_epochs=NGP_EDIT_PRE_EPOCHS, res=800):
    """Phase 11 (main_seald on phase 10b's D-NeRF teacher) or 11b
    (main_SealNeRF on phase 10's Instant-NGP teacher) at the CLI's
    defaults, phase 8's edit; the student is the non-fast StudentTrainer in
    plain PyTorch. Returns main's wall seconds."""
    import torch
    from sealdnerf_tpu_torch import main_seald, main_SealNeRF
    from sealdnerf_tpu_torch.editing.student import (StudentTrainer,
                                                     freeze_labels)
    from sealdnerf_tpu_torch.models.dnerf import DNeRFConfig
    from sealdnerf_tpu_torch.models.ngp import NGPConfig
    from sealdnerf_tpu_torch.train.metrics import psnr

    tag = "11" if dynamic else "11b"
    mod = main_seald if dynamic else main_SealNeRF
    ws = os.path.join(REPO, "workspace", "chip_smoke_ngp_edit"
                      + ("_dyn" if dynamic else ""))
    os.makedirs(ws, exist_ok=True)
    with open(os.path.join(ws, "seal.json"), "w") as f:
        json.dump(_edit_config(), f)
    argv = ["synthetic", "-O", "--synthetic_res", str(res),
            "--teacher_workspace", teacher_ws, "--workspace", ws,
            "--seal_config", "seal.json",
            "--pretraining_epochs", str(pre_epochs),
            "--pretraining_local_point_step", str(NGP_EDIT_LOCAL_STEP),
            "--extra_epochs", str(extra_epochs)]
    if dynamic:
        argv += ["--time_frame", "0.5"]
    opt = mod.parse_args(argv)
    if (opt.bound, opt.dt_gamma, opt.backbone) != (2.0, 1 / 128, "auto") \
            or (opt.lr, getattr(opt, "lr_net", None)) != \
            ((5e-4, 5e-5) if dynamic else (1e-2, None)):
        raise AssertionError(f"phase {tag}: not the CLI's defaults: {opt}")
    print(f"phase {tag} cuts: pretraining epochs 100 -> {pre_epochs}; local "
          f"point step 0.001 -> {NGP_EDIT_LOCAL_STEP} (the edit's two "
          "0.72-wide boxes hold ~7.5e8 points at 0.001, ~90,000 batches of "
          f"8,192 an epoch); distillation ceil(30,000 / 48) = 625 epochs -> "
          f"--extra_epochs {extra_epochs} of 128 steps", flush=True)
    if dynamic:
        # The reference's D-NeRF student misses the criterion at these
        # rates too: tests/test_torch_dnerf_band_student.py holds the port in
        # the band of three JAX seeds there (ROADMAP section C, C7).
        print(f"phase {tag}: at main_seald's rates (5e-4 / 5e-5) the student "
              "does not meet the criterion within the cut depth (it lay "
              "further from the edited proxy than the unedited teacher, in "
              "the reference as in the port), so it distils at phase 10b's "
              "rates, 1e-2 (tables) and 1e-3 (towers)", flush=True)
        argv += ["--lr", "1e-2", "--lr_net", "1e-3"]
    # after every pretraining epoch: the grid's pass count and the tower
    # and deform leaves that moved
    seen = []
    pre = StudentTrainer.pretrain_one_epoch

    def checked(self):
        it = int(self.grid_state["iter_density"])
        loss = pre(self)
        seen.append((it, _frozen_leaves_moved(self)))
        return loss

    fns = _kernel_launches()
    for fn in fns:
        fn.launches = 0
    StudentTrainer.pretrain_one_epoch = checked
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        StudentTrainer.pretrain_one_epoch = pre
    launches = [fn.launches for fn in fns]
    tt = st.teacher_trainer
    full = DNeRFConfig(bound=2.0) if dynamic else NGPConfig(bound=2.0)
    if type(st) is not StudentTrainer or st.field.cfg != full or \
            st.time_conditioned != dynamic:
        raise AssertionError(f"phase {tag}: trainer {type(st)}, field "
                             f"{st.field.cfg}")
    if launches != [0, 0, 0, 0]:
        raise AssertionError(f"phase {tag}: K1-K4 launched {launches}")
    it_teacher = int(tt.grid_state["iter_density"])
    if len(seen) != pre_epochs or seen[0][0] != it_teacher:
        raise AssertionError(f"phase {tag}: pretraining epochs {seen}, the "
                             f"teacher's iter_density {it_teacher}")
    moved = [m for _, m in seen if m]
    if moved:
        raise AssertionError(f"phase {tag}: pretraining moved {moved}")
    labels = freeze_labels(st.params)
    after = _frozen_leaves_moved(st)
    if any(labels[k] == "deform" for k in after):
        raise AssertionError(f"phase {tag}: the edit moved {after}")
    if torch.equal(st.params["grid"], tt.params["grid"]):
        raise AssertionError(f"phase {tag}: the student's grid did not move")
    # the student against the edited teacher's proxy on the val views, and
    # the unedited teacher against it (phase 8's criterion)
    tv = st.proxied["valid"]
    t = 0.5 if dynamic else None
    mse_s, mse_u, ps, pu = [], [], [], []
    for i in range(len(tv)):
        img, _ = st.render_image(tv.poses[i], tv.intrinsics, tv.h, tv.w,
                                 time=t)
        ref, _ = st.render_teacher_image(tv.poses[i], tv.intrinsics, tv.h,
                                         tv.w, time=t, edited=False)
        gt = tv.images[i]
        if not (np.isfinite(img).all() and img.shape == gt.shape):
            raise AssertionError(f"phase {tag}: bad student frame")
        mse_s.append(float(np.mean((img - gt) ** 2)))
        mse_u.append(float(np.mean((ref - gt) ** 2)))
        ps.append(psnr(img, gt))
        pu.append(psnr(img, ref))
    hist = st.history
    spe = max(len(st.proxied["train"]), st.opt.segment_steps)
    warm = hist["epoch_s"][1:] or hist["epoch_s"]
    dist_ms = sum(warm) / (len(warm) * spe) * 1e3
    zones = {k: int(z["weight"].sum()) for k, z in
             st.pretraining_data.items()}
    n_pre = sum(z["points"].shape[0] for z in st.pretraining_data.values())
    pre_s = st.time_inspector["pretraining"]
    pre_ms = float(np.mean(pre_s)) / n_pre * 1e3
    dist_s = sum(st.time_inspector["training"])
    rest = wall - st.proxy_seconds - st.query_seconds - sum(pre_s) - dist_s
    frames = sorted(os.listdir(os.path.join(ws, "results")))
    print(f"phase {tag} NGP-family edit ({mod.__name__.split('.')[-1]} at "
          f"the CLI defaults, {type(st.field.cfg).__name__}, "
          f"StudentTrainer) on {_card()}: {wall:.2f} s wall for main: proxy "
          f"{len(st.proxied['train'])} + {len(tv)} views at {tv.h}x{tv.w} "
          f"through render_occ {st.proxy_seconds:.2f} s; teacher point "
          f"queries {st.query_points} in {st.query_seconds:.2f} s, zones "
          f"{zones}; pretraining {pre_epochs} x {n_pre} steps of "
          f"{st.pretraining_batch_size} points, {sum(pre_s):.2f} s, "
          f"{pre_ms:.3f} ms/step; distillation {len(hist['loss'])} steps, "
          f"{dist_s:.2f} s, {dist_ms:.3f} ms/step, "
          f"{st.opt.num_rays * 1e3 / dist_ms:.1f} rays/s over epochs "
          f"2-{len(hist['epoch_s'])}; the rest (teacher checkpoint, "
          f"student, datasets, {len(frames)} test frames) {rest:.2f} s; "
          f"iter_density teacher {it_teacher}, student at its first "
          f"pretraining epoch {seen[0][0]}, at the end "
          f"{int(st.grid_state['iter_density'])}; launches K1-K4 "
          f"{launches}", flush=True)
    print(f"phase {tag} edit: val MSE student vs edited teacher "
          f"{np.mean(mse_s):.6f}, unedited vs edited teacher "
          f"{np.mean(mse_u):.6f}; PSNR student vs edited teacher "
          f"{np.mean(ps):.3f} dB, vs unedited teacher {np.mean(pu):.3f} dB",
          flush=True)
    if not np.mean(mse_s) <= 0.8 * np.mean(mse_u):
        raise AssertionError(f"phase {tag}: the student is not nearer the "
                             f"edit: MSE {np.mean(mse_s)} vs "
                             f"{np.mean(mse_u)}")
    if len(frames) != 6:
        raise AssertionError(f"phase {tag}: test frames written: {frames}")
    del st, tt
    torch.cuda.empty_cache()
    return wall


def _option_ms(trainer, steps):
    """ms/step of a phase-12 run: over the epochs after the first, or the
    one epoch's (kernels built, the first steps included) when there is
    one."""
    hist = trainer.history
    spe = max(48, trainer.opt.segment_steps)
    if len(hist["epoch_s"]) > 1:
        return sum(hist["epoch_s"][1:]) / (steps - spe) * 1e3
    return hist["epoch_s"][0] / steps * 1e3


def _error_map_checks(trainer, data, h, w, tag, draws=16):
    """The error map of a trained run: the share of the rows that the run
    could draw from (all 48, or the time curriculum's window) that moved
    away from ones (>= 0.75: an image a step, so 128 steps leave ~7 % of
    48 rows undrawn), and the share of `draws` steps' rays drawn in the
    top-decile cells of their image's row (> 0.1, uniform's share) ->
    (rows moved, share)."""
    import torch
    em = trainer.error_map
    n = trainer.n_allowed_images(trainer.global_step - 1, em.shape[0])
    moved = float((em[:n] != 1).any(dim=1).float().mean())
    k = em.shape[1] // 10
    shares = []
    for _ in range(draws):
        trainer.sample_batch(data, h, w)
        img, ic = trainer._draw
        row = em[img].reshape(-1)
        top = torch.zeros_like(row, dtype=torch.bool)
        top[row.topk(k).indices] = True
        shares.append(float(top[ic].float().mean()))
    share = float(np.mean(shares))
    if not moved >= 0.75:
        raise AssertionError(f"phase 12 {tag}: {moved:.3f} of the error "
                             "map's rows moved away from ones")
    if not share > 0.1:
        raise AssertionError(f"phase 12 {tag}: {share:.4f} of the rays drawn "
                             "in the top-decile cells")
    return moved, share


def _option_run(tag, argv, train, dynamic=False, **kw):
    """One phase-12 training run through the CLI's parser and
    cli.build_trainer -> (trainer, its device data, K1-K4 launches of the
    run). Checks that every loss is finite."""
    import torch
    from sealdnerf_tpu_torch import main_dnerf
    from sealdnerf_tpu_torch.cli import base_parser, build_trainer, postprocess

    opt = (main_dnerf.parse_args(argv) if dynamic else
           postprocess(base_parser().parse_args(argv)))
    if dynamic:
        kw["lr_net"] = opt.lr_net
    trainer, _ = build_trainer(opt, name="ngp", dynamic=dynamic, **kw)
    seen = {}
    device_data = trainer._device_data
    trainer._device_data = lambda ds: seen.setdefault("data",
                                                      device_data(ds))
    fns = _kernel_launches()
    before = [fn.launches for fn in fns]
    trainer.train(train, None, int(np.ceil(opt.iters / len(train))))
    torch.cuda.synchronize()
    launched = [fn.launches - b for fn, b in zip(fns, before)]
    losses = np.asarray(trainer.history["loss"])
    if len(losses) != opt.iters or not np.isfinite(losses).all():
        raise AssertionError(f"phase 12 {tag}: {len(losses)} losses, "
                             f"finite: {np.isfinite(losses).all()}")
    return trainer, seen["data"], launched


def phase_cli_options():
    """Phase 12: the main CLIs' training and export options at full width.
    Returns the K1-K4 launches over the phase."""
    import torch
    from sealdnerf_tpu_torch import main_dnerf
    from sealdnerf_tpu_torch.cli import (base_parser, build_trainer,
                                         load_datasets, postprocess)
    from sealdnerf_tpu_torch.train.metrics import LPIPSMeter, PSNRMeter

    fns = _kernel_launches()
    for fn in fns:
        fn.launches = 0
    t_phase = time.perf_counter()
    ws = os.path.join(REPO, "workspace", "chip_smoke_options")
    base = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--iters",
            str(OPTION_STEPS), "--ckpt", "scratch", "--synthetic_res", "800"]
    t0 = time.perf_counter()
    # --error_map gives the training split its map of ones
    train, val, _ = load_datasets(postprocess(base_parser().parse_args(
        base + ["--error_map"])))
    data_s = time.perf_counter() - t0
    h, w = train.h, train.w
    ref5 = STEP_MS.get("5", float("nan"))
    rows, psnrs = [], {}
    for tag, flags in (("preloaded", []), ("--error_map", ["--error_map"]),
                       ("--patch_size 8", ["--patch_size", "8"]),
                       ("--no_preload", ["--no_preload"])):
        trainer, data, launched = _option_run(
            tag, base + ["--workspace", os.path.join(ws, tag.strip("-"))]
            + flags, train)
        ms = _option_ms(trainer, OPTION_STEPS)
        note = ""
        if tag == "--error_map":
            moved, share = _error_map_checks(trainer, data, h, w, tag)
            note = (f"; map rows moved {moved:.3f}, rays in top-decile "
                    f"cells {share:.4f}")
        elif tag == "--patch_size 8":
            batch = trainer.sample_batch(data, h, w)
            with torch.no_grad():
                loss, _ = trainer.loss_on(*batch)
            term = float(loss) - float(trainer._loss_per_ray.mean())
            n_rays = trainer.opt.num_rays
            if not (batch[0].shape[0] == n_rays and term > 0):
                raise AssertionError(f"phase 12 {tag}: {batch[0].shape[0]} "
                                     f"rays, patch term {term}")
            note = (f"; {n_rays // 64} patches a step, patch term "
                    f"{term:.3e}")
        elif tag == "--no_preload":
            imgs = data["host_images"]
            if "images" in data or imgs.device.type != "cpu" or \
                    not imgs.is_pinned():
                raise AssertionError(f"phase 12 {tag}: images not in pinned "
                                     f"host memory: {imgs.device}, "
                                     f"{sorted(data)}")
            note = "; images in pinned host memory"
        if tag in ("preloaded", "--no_preload"):
            psnrs[tag] = trainer.evaluate(val)
            note += f"; val PSNR {psnrs[tag]:.3f} dB"
        rows.append(f"{tag}: {ms:.3f} ms/step (phase 5 {ref5:.3f}), "
                    f"launches K1-K4 {launched}{note}")
        del trainer, data
        torch.cuda.empty_cache()
    if not abs(psnrs["--no_preload"] - psnrs["preloaded"]) <= 1.0:
        raise AssertionError(f"phase 12: --no_preload's val PSNR "
                             f"{psnrs['--no_preload']:.3f} not within 1 dB "
                             f"of the preloaded run's "
                             f"{psnrs['preloaded']:.3f}")
    # main_nerf --backbone ngp --error_map
    ngp = ["synthetic", "-O", "--backbone", "ngp", "--error_map", "--iters",
           str(OPTION_STEPS_SHORT), "--ckpt", "scratch", "--synthetic_res",
           "800", "--workspace", os.path.join(ws, "ngp")]
    trainer, data, launched = _option_run("ngp --error_map", ngp, train)
    moved, share = _error_map_checks(trainer, data, h, w, "ngp")
    rows.append(f"--backbone ngp --error_map: "
                f"{_option_ms(trainer, OPTION_STEPS_SHORT):.3f} ms/step "
                f"(phase 10 {STEP_MS.get('10', float('nan')):.3f}), launches "
                f"K1-K4 {launched}; map rows moved {moved:.3f}, rays in "
                f"top-decile cells {share:.4f}")
    del trainer, data, train
    torch.cuda.empty_cache()
    # main_dnerf -O --bound 1 --error_map: K3 and K4
    dyn = base[:7] + [str(OPTION_STEPS_SHORT)] + base[8:] + [
        "--error_map", "--workspace", os.path.join(ws, "dyn")]
    t0 = time.perf_counter()
    dtrain, _, _ = load_datasets(main_dnerf.parse_args(dyn), with_time=True)
    data_s += time.perf_counter() - t0
    trainer, data, launched = _option_run("dnerf --error_map", dyn, dtrain,
                                          dynamic=True)
    if not (launched[2] > 0 and launched[3] == OPTION_STEPS_SHORT):
        raise AssertionError(f"phase 12 dnerf --error_map: launches K1-K4 "
                             f"{launched}")
    moved, share = _error_map_checks(trainer, data, h, w, "dnerf")
    rows.append(f"main_dnerf --bound 1 --error_map: "
                f"{_option_ms(trainer, OPTION_STEPS_SHORT):.3f} ms/step "
                f"(phase 7 {STEP_MS.get('7', float('nan')):.3f}), launches "
                f"K1-K4 {launched}; map rows moved {moved:.3f}, rays in "
                f"top-decile cells {share:.4f}")
    del trainer, data, dtrain
    torch.cuda.empty_cache()
    # phase 5's trained field, served as main_nerf --test serves it: the
    # test frames with the mp4 when an encoder imports, then the mesh
    opt = postprocess(base_parser().parse_args(
        ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--test",
         "--synthetic_res", "800", "--workspace",
         os.path.join(REPO, "workspace", "chip_smoke_train")]))
    trainer, _ = build_trainer(opt, name="ngp",
                               metrics=[PSNRMeter(), LPIPSMeter()])
    if trainer.global_step != TRAIN_STEPS:
        raise AssertionError(f"phase 12: phase 5's checkpoint is at step "
                             f"{trainer.global_step}")
    before = [fn.launches for fn in fns]
    t0 = time.perf_counter()
    video = trainer.test(val, save_path=os.path.join(ws, "results"),
                         write_video=True)
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    frames = [f for f in os.listdir(os.path.join(ws, "results"))
              if f.endswith(".png")]
    if len(frames) != len(val):
        raise AssertionError(f"phase 12: test frames written: {frames}")
    path, verts, tris = trainer.save_mesh(resolution=256, threshold=10)
    launched = [fn.launches - b for fn, b in zip(fns, before)]
    if not len(tris) > 0 or launched[0] < 1:
        raise AssertionError(f"phase 12: mesh of {len(tris)} triangles, "
                             f"launches K1-K4 {launched}")
    sec = trainer.mesh_seconds
    rows.append(f"test (6 val views at 800x800) {test_s:.2f} s: "
                + (f"mp4 {os.path.basename(video)}" if video else
                   "no encoder importable, PNG frames only")
                + f"; save_mesh(256, 10) {len(verts)} verts {len(tris)} tris"
                f", sweep {sec['sweep']:.3f} s, tetrahedra "
                f"{sec['tetrahedra']:.3f} s; launches K1-K4 {launched}")
    del trainer
    torch.cuda.empty_cache()
    launches = [fn.launches for fn in fns]
    print(f"phase 12 main-CLI options on {_card()} ("
          f"{time.perf_counter() - t_phase:.2f} s, data {data_s:.2f} s): "
          + "; ".join(rows) + f"; launches over the phase K1-K4 {launches}",
          flush=True)
    return launches


def _sync():
    import torch
    torch.cuda.synchronize()


def _pngs(path):
    return [f for f in os.listdir(path) if f.endswith(".png")]


def _patched(obj, name, fn):
    """Set obj.name = fn -> a function that restores the old value."""
    old = getattr(obj, name)
    setattr(obj, name, fn)
    return lambda: setattr(obj, name, old)


def _frame(trainer, val, i=0):
    """View i of val through render_image, warm: (ms, rgb)."""
    trainer.render_image(val.poses[i], val.intrinsics, val.h, val.w)
    _sync()
    t0 = time.perf_counter()
    img, _ = trainer.render_image(val.poses[i], val.intrinsics, val.h, val.w)
    _sync()
    return (time.perf_counter() - t0) * 1e3, img


def phase_tensorf():
    """Phase 13a: main_tensoRF at the CLI's defaults, cut to TENSORF_STEPS
    with five upsamples at TENSORF_UPSAMPLES -> (the trainer, val)."""
    import torch
    from sealdnerf_tpu_torch import main_tensoRF
    from sealdnerf_tpu_torch.main_tensoRF import (TensoRFTrainer,
                                                  upsample_resolutions)
    from sealdnerf_tpu_torch.models.api import make_tensorf_field
    from sealdnerf_tpu_torch.models.tensorf import TensoRFConfig
    from sealdnerf_tpu_torch.train.trainer import Trainer

    ws = os.path.join(REPO, "workspace", "chip_smoke_tensorf")
    argv = ["synthetic", "--iters", str(TENSORF_STEPS), "--ckpt", "scratch",
            "--synthetic_res", "800", "--workspace", ws]
    for step in TENSORF_UPSAMPLES:
        argv += ["--upsample_model_steps", str(step)]
    defaults = list(main_tensoRF.UPSAMPLE_STEPS)
    restore = [_patched(main_tensoRF, "UPSAMPLE_STEPS", ())]
    try:
        opt = main_tensoRF.build_parser().parse_args(argv)
        if (opt.bound, opt.lr0, opt.lr1, opt.resolution0, opt.resolution1,
                opt.cp) != (2.0, 2e-2, 1e-3, 128, 300, False):
            raise AssertionError(f"phase 13a: not the CLI's defaults: {opt}")
        print(f"phase 13a cut: {TENSORF_STEPS} of 30,000 iterations, "
              f"upsamples at {list(TENSORF_UPSAMPLES)} in place of the "
              f"CLI's {defaults} (the flag appends to those, so the phase "
              "sets the parsed list itself)", flush=True)
        train, val, _ = main_tensoRF.load_datasets(opt)
        cfg = TensoRFConfig(bound=2.0, resolution=128)
        seeded = Trainer("tensorf", main_tensoRF.to_train_options(
            opt, name="tensorf", lr=opt.lr0, lr_net=opt.lr1),
            make_tensorf_field(torch.Generator().manual_seed(opt.seed), cfg,
                               "cuda"), workspace=ws + "_seeded",
            use_checkpoint="scratch", device="cuda")
        seeded.mark_untrained_grid(train.poses, train.intrinsics)
        seeded.rebuild_grid()
        psnr0 = seeded.evaluate(val)
        del seeded
        steps_ms, ups = [], []
        gt_step, upsample = TensoRFTrainer.train_step_gt, \
            TensoRFTrainer.upsample

        def timed_step(self, data, h, w):
            _sync()
            t0 = time.perf_counter()
            out = gt_step(self, data, h, w)
            _sync()
            steps_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def logged_upsample(self):
            upsample(self)
            ups.append((self.global_step, self.field.cfg.resolution))
        restore += [_patched(TensoRFTrainer, "train_step_gt", timed_step),
                    _patched(TensoRFTrainer, "upsample", logged_upsample)]
        _sync()
        t0 = time.perf_counter()
        trainer = main_tensoRF.main(argv)
        _sync()
        wall = time.perf_counter() - t0
    finally:
        for r in restore[::-1]:
            r()
    want = list(zip(TENSORF_UPSAMPLES, upsample_resolutions(128, 300, 5)))
    losses = np.asarray(trainer.history["loss"])
    psnr = trainer.stats["results"][-1]
    frames = _pngs(os.path.join(ws, "results"))
    frame_ms, img = _frame(trainer, val)
    first, last = TENSORF_UPSAMPLES[0], TENSORF_UPSAMPLES[-1]
    before = float(np.median(steps_ms[8:first]))
    after = float(np.median(steps_ms[last + 8:]))
    print(f"phase 13a main_tensoRF (VM, bound 2, 128 -> 300, ranks 16 / "
          f"48, app 27) on {_card()}: main {wall:.2f} s wall; "
          f"{len(losses)} steps x {trainer.opt.num_rays} rays; upsamples "
          f"(step, res) {ups}; ms/step (median, the step alone) "
          f"{before:.3f} at 128^3 before the first, {after:.3f} at 300^3 "
          f"after the last; {sum(trainer.history['epoch_s']):.2f} s in "
          f"train's epochs; loss first 64 {losses[:64].mean():.6f} last 64 "
          f"{losses[-64:].mean():.6f}; val PSNR {psnr0:.3f} seeded -> "
          f"{psnr:.3f} dB; 800x800 frame {frame_ms:.1f} ms; "
          f"{len(frames)} test frames", flush=True)
    if ups != want or trainer.field.cfg.resolution != 300 or \
            tuple(trainer.params["app_planes"][0].shape) != (48, 300, 300):
        raise AssertionError(f"phase 13a: upsamples {ups}, want {want}")
    if len(losses) != TENSORF_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"phase 13a: {len(losses)} losses, finite "
                             f"{np.isfinite(losses).all()}")
    if not losses[-64:].mean() < losses[:64].mean():
        raise AssertionError("phase 13a: the loss did not fall")
    if not psnr > psnr0:
        raise AssertionError(f"phase 13a: val PSNR {psnr:.3f} not above the "
                             f"seeded field's {psnr0:.3f}")
    if len(frames) != len(val) or not np.isfinite(img).all():
        raise AssertionError(f"phase 13a: test frames {frames}")
    return trainer, val


def _semantic_probe(trainer, val, res):
    """The semantic objective (the image's mean square) on the current
    params, averaged over 4 fixed orbit views at res x res (radius 1.25,
    white background): each semantic step draws its own pose, so their
    losses do not compare from one step to the next."""
    from sealdnerf_tpu_torch.data.rays import rand_poses
    intr = np.asarray(val.intrinsics, np.float32) * (res / val.h)
    intr[2:] = res / 2.0
    poses = rand_poses(np.random.default_rng(7), 4, radius=1.25)
    return float(np.mean([(trainer.render_image(
        p, intr, res, res, bg_color=np.ones(3, np.float32),
        params=trainer.params)[0] ** 2).mean() for p in poses]))


def phase_semantic(trainer, val):
    """Phase 13d: SEMANTIC_STEPS GT-free steps on 13a's field at
    SEMANTIC_RES with an injected objective (the image's mean square)."""
    from sealdnerf_tpu_torch.models.params import param_leaves
    from sealdnerf_tpu_torch.train.clip_guidance import CLIPGuidance
    trainer.opt.clip_res = SEMANTIC_RES
    trainer.semantic_loss_fn = lambda img: (img ** 2).mean()
    before = [p.detach().clone() for p in param_leaves(trainer.params)]
    probe0 = _semantic_probe(trainer, val, SEMANTIC_RES)
    step0 = trainer.global_step
    _sync()
    t0 = time.perf_counter()
    losses = [float(trainer.train_step_semantic(val.intrinsics, val.h))
              for _ in range(SEMANTIC_STEPS)]
    ms = (time.perf_counter() - t0) * 1e3 / SEMANTIC_STEPS
    moved = sum(not bool((a == b).all()) for a, b in
                zip(before, param_leaves(trainer.params)))
    probe1 = _semantic_probe(trainer, val, SEMANTIC_RES)
    clip = CLIPGuidance("a red car", device="cuda")
    print(f"phase 13d semantic steps on 13a's field: {SEMANTIC_STEPS} at "
          f"{SEMANTIC_RES}x{SEMANTIC_RES}, {ms:.3f} ms/step; the steps' "
          f"losses {losses[0]:.6f} ... {losses[-1]:.6f} (each at its own "
          f"pose); the objective on 4 fixed views {probe0:.6f} -> "
          f"{probe1:.6f}; {moved} of {len(before)} leaves moved; local CLIP "
          f"weights: "
          f"{'yes' if clip.available else 'no (' + clip.reason + ')'}",
          flush=True)
    if not (np.isfinite(losses).all() and probe1 < probe0
            and moved > 0 and trainer.global_step == step0 + SEMANTIC_STEPS):
        raise AssertionError(f"phase 13d: losses {losses}, objective "
                             f"{probe0} -> {probe1}, {moved} leaves moved")


def phase_ccnerf():
    """Phase 13b: main_CCNeRF at its defaults (CP rank 64, the K-loss at
    0.25 and 0.5) for CCNERF_STEPS, then --compose of the workspace
    twice."""
    import copy
    import functools
    from sealdnerf_tpu_torch import main_CCNeRF
    from sealdnerf_tpu_torch.train.trainer import Trainer

    ws = os.path.join(REPO, "workspace", "chip_smoke_ccnerf")
    argv = ["synthetic", "--iters", str(CCNERF_STEPS), "--ckpt", "scratch",
            "--synthetic_res", "800", "--workspace", ws]
    opt = main_CCNeRF.build_parser().parse_args(argv)
    if (opt.bound, opt.rank, opt.rank_fracs) != (1.0, 64, [0.25, 0.5]):
        raise AssertionError(f"phase 13b: not the CLI's defaults: {opt}")
    steps_ms = []
    gt_step = Trainer.train_step_gt

    def timed_step(self, data, h, w):
        _sync()
        t0 = time.perf_counter()
        out = gt_step(self, data, h, w)
        _sync()
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    restore = _patched(Trainer, "train_step_gt", timed_step)
    try:
        t0 = time.perf_counter()
        trainer = main_CCNeRF.main(argv)
        _sync()
        wall = time.perf_counter() - t0
    finally:
        restore()
    losses = np.asarray(trainer.history["loss"])
    _, _, val = main_CCNeRF.load_datasets(opt)
    frame_ms, full = _frame(trainer, val)
    field = trainer.field
    trunc = copy.copy(field)
    trunc.forward = functools.partial(field.forward_trunc, frac=0.25)
    trainer.field = trunc
    img_lo, _ = trainer.render_image(val.poses[0], val.intrinsics, val.h,
                                     val.w)
    trainer.field = field
    trunc_diff = float(np.abs(img_lo - full).mean())
    del trainer
    cws = ws + "_compose"
    t0 = time.perf_counter()
    viewer = main_CCNeRF.main(["synthetic", "--compose", "--compose_models",
                               ws, ws, "--synthetic_res", "800",
                               "--workspace", cws])
    _sync()
    compose_s = time.perf_counter() - t0
    frames = _pngs(os.path.join(cws, "compose"))
    compose_ms, img = _frame(viewer, val)
    occ = float(viewer.grid_state["occ"].float().mean())
    print(f"phase 13b main_CCNeRF (CP rank 64, K-loss 0.25 / 0.5, bound 1) "
          f"on {_card()}: main {wall:.2f} s wall; {len(losses)} steps x "
          f"{opt.num_rays} rays, {float(np.median(steps_ms[8:])):.3f} "
          f"ms/step (median, the step alone: three renders); loss first 64 "
          f"{losses[:64].mean():.6f} last 64 {losses[-64:].mean():.6f}; "
          f"frame {frame_ms:.1f} ms; rank 0.25 vs full: mean |diff| "
          f"{trunc_diff:.4f}; --compose (the workspace twice) {compose_s:.2f}"
          f" s, occupancy {occ:.4f}, {len(frames)} frames, 800x800 "
          f"composed frame {compose_ms:.1f} ms", flush=True)
    if len(losses) != CCNERF_STEPS or not np.isfinite(losses).all() or \
            not losses[-64:].mean() < losses[:64].mean():
        raise AssertionError(f"phase 13b: {len(losses)} losses, first 64 "
                             f"{losses[:64].mean()}, last 64 "
                             f"{losses[-64:].mean()}")
    if not (np.isfinite(img_lo).all() and trunc_diff > 1e-3):
        raise AssertionError(f"phase 13b: the 0.25 truncation's frame: mean "
                             f"|diff| {trunc_diff}")
    if len(frames) != len(val) or not np.isfinite(img).all() or \
            img.shape != (val.h, val.w, 3):
        raise AssertionError(f"phase 13b: composed frames {frames}")


def phase_sdf():
    """Phase 13c: main_sdf synthetic at the CLI's --num_samples and
    --mesh_resolution, SDF_EPOCHS epochs."""
    import torch
    from sealdnerf_tpu_torch import main_sdf
    from sealdnerf_tpu_torch.data.sdf_provider import (QUERY_THREADS,
                                                       SDFDataset)

    ws = os.path.join(REPO, "workspace", "chip_smoke_sdf")
    argv = ["synthetic", "--workspace", ws, "--epochs", str(SDF_EPOCHS)]
    opt = main_sdf.build_parser().parse_args(argv)
    if (opt.num_samples, opt.mesh_resolution) != (2 ** 18, 512):
        raise AssertionError(f"phase 13c: not the CLI's values: {opt}")
    print(f"phase 13c cut: {SDF_EPOCHS} of 20 epochs", flush=True)
    t0 = time.perf_counter()
    fitter, (verts, tris, secs) = main_sdf.main(argv)
    _sync()
    wall = time.perf_counter() - t0
    hist = fitter.history
    n = main_sdf.STEPS_PER_EPOCH
    loss = np.asarray(hist["loss"])
    epochs = [float(loss[i * n:(i + 1) * n].mean())
              for i in range(SDF_EPOCHS)]
    ds = SDFDataset(os.path.join(ws, "synthetic_sphere.ply"), size=1,
                    num_samples=opt.num_samples, seed=1)
    radius = float(np.linalg.norm(ds.verts, axis=-1).mean())
    got = float(np.linalg.norm(verts, axis=-1).mean()) if len(verts) else 0
    # the host's work a step, split: the draws and the BVH's queries
    t0 = time.perf_counter()
    batch = ds.sample_batch()
    draw_s = time.perf_counter() - t0
    half = batch["points"][opt.num_samples // 2:]
    # the BVH's queries of one batch on one host thread (the reference's)
    # and split over QUERY_THREADS, alternated: medians of 3 each
    bvh_ms = {1: [], QUERY_THREADS: []}
    for _ in range(3):
        for threads, times in bvh_ms.items():
            t0 = time.perf_counter()
            ds.query(half, threads=threads)
            times.append((time.perf_counter() - t0) * 1e3)
    bvh = "; ".join(f"{np.median(t):.3f} ms on {n} thread(s)"
                    for n, t in bvh_ms.items())
    # the device's step alone, on one batch
    dev = fitter.params["grid"].device
    pts = torch.from_numpy(batch["points"]).to(dev)
    sdfs = torch.from_numpy(batch["sdfs"]).to(dev)
    fitter.step(pts, sdfs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(8):
        fitter.step(pts, sdfs)
    _sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / 8
    steps = len(loss)
    print(f"phase 13c main_sdf synthetic ({opt.num_samples} points a step, "
          f"{opt.mesh_resolution}^3 export) on {_card()}: main {wall:.2f} s "
          f"wall; {steps} steps, {sum(hist['epoch_s']) * 1e3 / steps:.3f} "
          f"ms/step in all, of which the host's draws "
          f"{sum(hist['draw_s']) * 1e3 / steps:.3f} (one batch apart: "
          f"{draw_s * 1e3:.3f} ms; the BVH's {len(half)} queries {bvh}); "
          f"the device's step alone "
          f"{step_ms:.3f} ms; epoch losses {[round(e, 6) for e in epochs]}; "
          f"export sweep {secs['sweep']:.2f} s, tetrahedra "
          f"{secs['tetrahedra']:.2f} s, {len(verts)} verts {len(tris)} "
          f"tris, mean radius {got:.4f} vs the mesh's {radius:.4f}",
          flush=True)
    if not (np.isfinite(loss).all() and epochs[-1] < epochs[0]):
        raise AssertionError(f"phase 13c: epoch losses {epochs}")
    if not (len(tris) > 0 and abs(got - radius) <= 0.05):
        raise AssertionError(f"phase 13c: {len(tris)} triangles, mean radius "
                             f"{got} vs {radius}")


def phase_other_workloads():
    """Phase 13: main_tensoRF, the semantic step, main_CCNeRF and main_sdf.
    Returns the K1-K4 launches over the phase (all 0: the workloads are
    plain PyTorch)."""
    import torch
    fns = _kernel_launches()
    for fn in fns:
        fn.launches = 0
    t_phase = time.perf_counter()
    trainer, val = phase_tensorf()
    phase_semantic(trainer, val)
    del trainer
    torch.cuda.empty_cache()
    phase_ccnerf()
    torch.cuda.empty_cache()
    phase_sdf()
    launches = [fn.launches for fn in fns]
    print(f"phase 13 other workloads: {time.perf_counter() - t_phase:.2f} s; "
          f"launches K1-K4 {launches} (plain PyTorch, as the reference's "
          f"XLA)", flush=True)
    if any(launches):
        raise AssertionError(f"phase 13 launched K1-K4: {launches}")
    return launches


def _made_once(fn):
    """fn with its results kept by its arguments; each call returns a deep
    copy, so that no caller sees what another changed. made.counts holds
    the results made and the copies handed out."""
    import copy
    cache = {}

    def made(*a, **kw):
        key = (a, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = fn(*a, **kw)
            made.counts["made"] += 1
        made.counts["copies"] += 1
        return copy.deepcopy(cache[key])
    made.counts = {"made": 0, "copies": 0}
    return made


def phase_device_kernels():
    """Phase 14: each device kernel of K3 and K4 by itself, on the inputs of
    phases 3c (t = 0.37) and 3d (re-gained tower), the tower's beside its
    own bounds."""
    import torch
    from sealdnerf_tpu_torch.models.cp import CPDNeRFConfig
    from sealdnerf_tpu_torch.ops.field import (dyn_field_backward,
                                               dyn_field_forward, pack_tables)
    cfg = CPDNeRFConfig()
    tables = pack_tables(_dyn_seeded_params(0, cfg, "cuda"), cfg)
    m = (1 << 20) + 37
    rng = np.random.default_rng(0)
    x3 = rng.uniform(-1.0, 1.0, (3, m)).astype(np.float32)
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    x3, d3 = torch.from_numpy(x3).cuda(), torch.from_numpy(d3).cuda()
    split = _kernel_ms(lambda: dyn_field_forward(tables, cfg, x3, d3, 0.37),
                       10, ("deform_fwd_kernel", "field_fwd_kernel"))
    tb_ = _bound(cfg, m, mode="tower")
    print(f"K3 t=0.37 by device kernel (profiler): deform_fwd_kernel "
          f"{split['deform_fwd_kernel']:.4f} ms against the tower's bound "
          f"{tb_['bound_ms']:.4f} ms by {tb_['bound_by']}; field_fwd_kernel "
          f"{split['field_fwd_kernel']:.4f} ms", flush=True)
    m = 4096 * 64 + 37
    rng = np.random.default_rng(2)
    x3 = rng.uniform(-1.0, 1.0, (3, m)).astype(np.float32)
    d3 = rng.normal(size=(3, m)).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=0, keepdims=True)
    g = rng.normal(size=(4, m)).astype(np.float32)
    g[:, rng.random(m) < 0.3] = 0.0
    m_live = int((np.abs(g).max(axis=0) > 0).sum())
    x3, d3, g = (torch.from_numpy(a).cuda() for a in (x3, d3, g))
    names = ("compact_live_kernel", "warp_kernel", "field_bwd_kernel",
             "tower_bwd_kernel", "tower_wgrad_kernel", "time_rows_kernel")
    split = _kernel_ms(lambda: dyn_field_backward(tables, cfg, x3, d3, 0.37,
                                                  g), 10, names)
    tw = _bound(cfg, m_live, mode="tower")
    tb_ = _bound(cfg, m, mode="tower_bwd", m_live=m_live)
    tower = sum(split[k] for k in names[3:])
    print("K4 by device kernel (profiler): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in split.items())
        + f"; the warp's bound {tw['bound_ms']:.4f} ms by {tw['bound_by']} "
        f"({m_live} listed samples), the tower backward's (tower_bwd_kernel "
        f"+ tower_wgrad_kernel + time_rows_kernel: {tower:.4f} ms) "
        f"{tb_['bound_ms']:.4f} ms by {tb_['bound_by']}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint to serve (default: seeded init)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    smi = _card()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # the procedural scene of given arguments is made once (~13 s at
    # 800x800) and copied to each later caller (cli.load_datasets imports
    # it when called), so a later phase's printed data seconds time a copy
    from sealdnerf_tpu_torch.data import synthetic
    scenes = synthetic.make_synthetic_scene = _made_once(
        synthetic.make_synthetic_scene)
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
    k1_frames = phase_trained_frames(trainer, served["val"], "5c")
    del trainer, served["train"], served["val"]
    torch.cuda.empty_cache()
    k3_served, dtrain, dval = phase_dynamic_served_path()
    dtrainer, k3_train, k4_train = phase_dynamic_training(dtrain, dval)
    phase_one_dyn_step(dtrainer, dtrain, "trained field", TRAINED_STEP_TOL)
    k3_frames = phase_trained_frames(dtrainer, dval, "7c")
    dyn_ws = dtrainer.workspace
    del dtrainer, dtrain, dval
    torch.cuda.empty_cache()
    _, _, k3_edit, k4_edit = phase_edit(True, dyn_ws, EDIT_PRE_EPOCHS,
                                        EDIT_EPOCHS)
    torch.cuda.empty_cache()
    k1_edit, k2_edit, _, _ = phase_edit(
        False, os.path.join(REPO, "workspace", "chip_smoke_train"),
        EDIT_PRE_EPOCHS_STATIC, EDIT_EPOCHS_STATIC)
    torch.cuda.empty_cache()
    b2trainer, b2val, k1_b2, k2_b2 = phase_bound2_training()
    k1_b2 += phase_trained_frames(b2trainer, b2val, "9b")
    del b2trainer, b2val
    torch.cuda.empty_cache()
    phase_ngp_training()
    phase_dnerf_ngp_training()
    phase_ngp_edit(True, os.path.join(REPO, "workspace",
                                      "chip_smoke_dnerf_ngp"),
                   NGP_EDIT_EPOCHS)
    phase_ngp_edit(False, os.path.join(REPO, "workspace", "chip_smoke_ngp"),
                   NGP_EDIT_EPOCHS_STATIC)
    k_opts = phase_cli_options()
    k_other = phase_other_workloads()
    phase_device_kernels()

    print(f"procedural scenes: {scenes.counts['made']} made, "
          f"{scenes.counts['copies']} copies handed out", flush=True)
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "field_fwd", "route": "cuda",
        "source": "sealdnerf_tpu_torch/ops/csrc/field_fwd.cu",
        "replaces": "sealdnerf_tpu/ops/pallas_field.py:185",
        "launches": served["launches"] + k1_train + k1_frames + k1_edit
        + k1_b2 + k_opts[0] + k_other[0], **rec}, {
        "name": "field_bwd", "route": "cuda",
        "source": "sealdnerf_tpu_torch/ops/csrc/field_bwd.cu",
        "replaces": "sealdnerf_tpu/ops/pallas_field.py:574",
        "launches": k2_train + k2_edit + k2_b2 + k_opts[1] + k_other[1],
        **rec_bwd}, {
        "name": "dyn_field_fwd", "route": "cuda",
        "source": "sealdnerf_tpu_torch/ops/csrc/dyn_field_fwd.cu",
        "replaces": "sealdnerf_tpu/ops/pallas_field.py:200",
        "launches": k3_served + k3_train + k3_frames + k3_edit
        + k_opts[2] + k_other[2], **rec_dyn}, {
        "name": "dyn_field_bwd", "route": "cuda",
        "source": "sealdnerf_tpu_torch/ops/csrc/dyn_field_bwd.cu",
        "replaces": "sealdnerf_tpu/ops/pallas_field.py:805",
        "launches": k4_train + k4_edit + k_opts[3] + k_other[3],
        **rec_dbwd}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
