"""Served quality of the PyTorch/CUDA port against the JAX package, with the
port's field kernel on a CUDA card.

    python3 profiling/torch_card_vs_jax.py make DIR [--dynamic]   # where JAX runs
    python3 profiling/torch_card_vs_jax.py check DIR [--dynamic]  # on a CUDA card

`make` (JAX, CPU) trains a JAX FastTrainer on the synthetic scene at narrow
widths: line scales (16,8) (64,16) (128,16), one (32,4) VM plane, grid 32,
320 steps on 64 px views. It saves the checkpoint to DIR/ckpt.npz, renders
the val views with the JAX tiled renderer through the Pallas field kernel
in interpret mode, and writes those frames, the ground truth and the poses
to DIR/jax_frames.npz.

`check` (port only, no JAX) loads DIR/ckpt.npz into the port through
`cli.build_trainer` and renders the same views through the CUDA field
kernel. It prints the largest difference from the JAX frames and both
PSNRs against ground truth, and fails if a frame differs by more than 2e-2
or a PSNR by more than 0.1 dB (the tolerances of tests/test_torch_slice.py)
or if the kernel was not launched.

--dynamic does both for the time-conditioned field: the same narrow
canonical field behind a deform tower of 4 matrices, 128 wide (the width
the dynamic kernel is built for), trained on the dynamic synthetic scene;
each val view is rendered at its own time, through the Pallas dynamic kernel
in interpret mode and through the CUDA dynamic kernel.
"""

import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCALES = ((16, 8), (64, 16), (128, 16))
PLANES = ((32, 4),)     # 4 channels: pack_tables pads the rows to 8
NARROW = dict(grid_size=32, march_res=16, n_intervals=6, steps_per_interval=3)
SEGMENTS, SEGMENT_STEPS, RES = 10, 32, 64
DEFORM = dict(num_layers_deform=4, hidden_dim_deform=128)


def _psnr(img, gt):
    return float(-10.0 * np.log10(np.mean((img - gt) ** 2)))


def _gt(images):
    return images[..., :3] * images[..., 3:] + (1.0 - images[..., 3:])


def make(out_dir, dynamic=False):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sealdnerf_tpu.data.synthetic import make_synthetic_scene
    from sealdnerf_tpu.models.cp import (CPConfig, CPDNeRFConfig,
                                         make_cp_dnerf_field, make_cp_field)
    from sealdnerf_tpu.ops.marching_dense import downsample_occ
    from sealdnerf_tpu.ops.pallas_field import (
        make_fused_dyn_forward_planar, make_fused_forward_planar)
    from sealdnerf_tpu.render.dynamic_grid import time_slice_index
    from sealdnerf_tpu.render.fast_image import render_image_tiled
    from sealdnerf_tpu.train.fast import FastTrainer
    from sealdnerf_tpu.train.trainer import TrainOptions

    os.makedirs(out_dir, exist_ok=True)
    ws = tempfile.mkdtemp(dir=out_dir)
    _, train, val = make_synthetic_scene(n_train=12, n_val=3, res=RES,
                                         dynamic=dynamic)
    opt = TrainOptions(iters=SEGMENTS * SEGMENT_STEPS, num_rays=1024,
                       bound=1.0, dt_gamma=0.0, segment_steps=SEGMENT_STEPS,
                       update_extra_interval=8, workspace=ws, **NARROW)
    if dynamic:
        cfg = CPDNeRFConfig(bound=1.0, scales=SCALES, planes=PLANES, **DEFORM)
        field = make_cp_dnerf_field(jax.random.PRNGKey(0), cfg)
    else:
        cfg = CPConfig(bound=1.0, scales=SCALES, planes=PLANES)
        field = make_cp_field(jax.random.PRNGKey(0), cfg)
    tr = FastTrainer("t", opt, field, workspace=ws, use_checkpoint="scratch",
                     time_conditioned=dynamic)
    tr.mark_untrained_grid(train.poses, train.intrinsics)
    data = train.device()
    h, w, c, n = train.h, train.w, train.images.shape[-1], len(train)
    for _ in range(SEGMENTS):
        tr.train_segment(data, h, w, c, n, SEGMENT_STEPS)
    tr.save_checkpoint()
    shutil.copy(os.path.join(ws, "checkpoints", "t_ep0000.npz"),
                os.path.join(out_dir, "ckpt.npz"))
    shutil.rmtree(ws)

    fwd = (make_fused_dyn_forward_planar if dynamic
           else make_fused_forward_planar)(tr.field.cfg, interpret=True)
    times = val.times if dynamic else np.zeros(len(val), np.float32)
    frames = []
    for i in range(len(val)):
        occ, extra = tr.grid_state["occ"], ()
        if dynamic:
            t = jnp.float32(times[i])
            occ, extra = occ[int(time_slice_index(t, tr.dyn_grid_cfg))], (t,)
        occ_m = downsample_occ(occ[0], tr.render_cfg.march_res)
        img, _ = render_image_tiled(
            tr._infer_params(), occ_m, jnp.asarray(val.poses[i]),
            jnp.asarray(val.intrinsics), val.h, val.w, tr.render_cfg, fwd,
            jnp.ones(3), tile_px=tr._pick_tile(val.h, val.w),
            dilate=tr.opt.render_dilate, density_scale=tr.opt.density_scale,
            t_thresh=tr.opt.t_thresh, planar=True, extra=extra)
        frames.append(np.asarray(img))
    frames = np.stack(frames)
    gt = _gt(val.images)
    np.savez(os.path.join(out_dir, "jax_frames.npz"), frames=frames, gt=gt,
             poses=val.poses, intrinsics=np.asarray(val.intrinsics),
             times=times, steps=tr.global_step)
    print(f"JAX: {tr.global_step} steps; PSNR vs GT "
          + " / ".join(f"{_psnr(f, g):.3f}" for f, g in zip(frames, gt)))


def check(out_dir, dynamic=False):
    import torch
    from sealdnerf_tpu_torch import main_dnerf
    from sealdnerf_tpu_torch.cli import base_parser, build_trainer, postprocess
    from sealdnerf_tpu_torch.ops.field import dyn_field_forward, field_forward

    if not torch.cuda.is_available():
        raise SystemExit("check needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    ref = np.load(os.path.join(out_dir, "jax_frames.npz"))
    ws = tempfile.mkdtemp(dir=out_dir)
    argv = ["synthetic", "-O", "--bound", "1", "--dt_gamma", "0", "--test",
            "--ckpt", os.path.join(out_dir, "ckpt.npz"), "--workspace", ws]
    opt = main_dnerf.parse_args(argv) if dynamic else \
        postprocess(base_parser().parse_args(argv))
    trainer, field = build_trainer(opt, name="t", dynamic=dynamic, **NARROW)
    if field.cfg.scales != SCALES or field.cfg.planes != PLANES:
        raise AssertionError(f"loaded {field.cfg.scales} {field.cfg.planes}")
    kernel = dyn_field_forward if dynamic else field_forward
    before = kernel.launches
    h, w = ref["frames"].shape[1:3]
    worst, lines = 0.0, []
    for i, (img_j, gt) in enumerate(zip(ref["frames"], ref["gt"])):
        img_t, _ = trainer.render_image(ref["poses"][i], ref["intrinsics"],
                                        h, w, time=ref["times"][i])
        diff = float(np.abs(img_t - img_j).max())
        p_t, p_j = _psnr(img_t, gt), _psnr(img_j, gt)
        worst = max(worst, diff)
        lines.append(f"view {i}: max|diff| {diff:.3g}, PSNR vs GT port "
                     f"{p_t:.3f} / JAX {p_j:.3f} dB")
        if diff > 2e-2 or abs(p_t - p_j) > 0.1:
            raise AssertionError(lines[-1])
    shutil.rmtree(ws)
    launches = kernel.launches - before
    print("\n".join(lines))
    print(f"{len(lines)} views at {h}x{w} after {int(ref['steps'])} JAX "
          f"steps: worst max|diff| {worst:.3g}, {launches} kernel launches")
    if launches < len(lines):
        raise AssertionError("the field kernel was not launched")


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--dynamic"]
    if len(args) != 2 or args[0] not in ("make", "check"):
        raise SystemExit(__doc__)
    {"make": make, "check": check}[args[0]](
        args[1], dynamic="--dynamic" in sys.argv[1:])
