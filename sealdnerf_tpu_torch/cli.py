"""Shared CLI machinery for the main_* entry points (port of
sealdnerf_tpu/cli.py).

`base_parser` keeps every flag of the reference parser, plus --device.
Flags of parts that are not ported yet parse but nothing reads them;
`build_trainer` raises for backbones that are not ported (--backbone ngp,
--bg_radius, --basis, --hyper), and the FastTrainer it builds for training
options that are not (--error_map, --patch_size > 1, --no_preload).
"""

import argparse

import torch

from .train.trainer import TrainOptions


def base_parser(default_bound=2.0, default_lr=1e-2, default_iters=30000,
                default_dt_gamma=1 / 128):
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str)
    parser.add_argument("-O", action="store_true",
                        help="equals --fp16 --cuda_ray --preload")
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--workspace", type=str, default="workspace")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch "
                             "versions of the kernels")
    # training
    parser.add_argument("--iters", type=int, default=default_iters)
    parser.add_argument("--lr", type=float, default=default_lr)
    parser.add_argument("--ckpt", type=str, default="latest")
    parser.add_argument("--num_rays", type=int, default=4096)
    parser.add_argument("--cuda_ray", action="store_true",
                        help="occupancy-grid fast path")
    parser.add_argument("--max_steps", type=int, default=1024)
    parser.add_argument("--num_steps", type=int, default=512)
    parser.add_argument("--upsample_steps", type=int, default=0)
    parser.add_argument("--update_extra_interval", type=int, default=16)
    parser.add_argument("--max_ray_batch", type=int, default=4096)
    parser.add_argument("--patch_size", type=int, default=1)
    parser.add_argument("--samples_per_ray", type=int, default=48,
                        help="packed sample budget per ray (training)")
    parser.add_argument("--eval_samples_per_ray", type=int, default=64)
    # backbone
    parser.add_argument("--backbone", type=str, default="auto",
                        choices=["auto", "cp", "ngp"],
                        help="auto: CP-factorized fast path when the recipe "
                             "allows (bound<=1, dt_gamma=0, no bg sphere), "
                             "else NGP; cp/ngp force it")
    parser.add_argument("--planes", type=str, default="auto",
                        help="CP-backbone VM planes: 'auto' ((128,8) when "
                             "bound<=1, off for bound>1), 'off', or "
                             "'res,ch[;res,ch...]'")
    parser.add_argument("--fp16", action="store_true",
                        help="bf16 compute")
    parser.add_argument("--ff", action="store_true", help="no-op alias")
    parser.add_argument("--tcnn", action="store_true", help="no-op alias")
    # dataset
    parser.add_argument("--color_space", type=str, default="srgb")
    parser.add_argument("--preload", action="store_true")
    parser.add_argument("--no_preload", action="store_true",
                        help="keep images in host RAM")
    parser.add_argument("--bound", type=float, default=default_bound)
    parser.add_argument("--scale", type=float, default=0.33)
    parser.add_argument("--offset", type=float, nargs="*", default=[0, 0, 0])
    parser.add_argument("--dt_gamma", type=float, default=default_dt_gamma)
    parser.add_argument("--min_near", type=float, default=0.2)
    parser.add_argument("--density_thresh", type=float, default=10)
    parser.add_argument("--bg_radius", type=float, default=-1)
    parser.add_argument("--downscale", type=int, default=1)
    # GUI
    parser.add_argument("--gui", action="store_true")
    parser.add_argument("--W", type=int, default=1920)
    parser.add_argument("--H", type=int, default=1080)
    parser.add_argument("--radius", type=float, default=5)
    parser.add_argument("--fovy", type=float, default=50)
    parser.add_argument("--max_spp", type=int, default=64)
    # experimental
    parser.add_argument("--error_map", action="store_true")
    parser.add_argument("--clip_text", type=str, default="")
    parser.add_argument("--rand_pose", type=int, default=-1)
    parser.add_argument("--tv_weight", type=float, default=0.0,
                        help="grid-table total-variation regularizer")
    # observability
    parser.add_argument("--profile", action="store_true",
                        help="write a profiler trace to workspace/trace")
    parser.add_argument("--debug_nan", action="store_true",
                        help="torch.autograd anomaly detection")
    # path == "synthetic" builds the procedural scene
    parser.add_argument("--synthetic_res", type=int, default=128)
    return parser


def postprocess(opt):
    if opt.O:
        opt.fp16 = True
        opt.cuda_ray = True
        opt.preload = True
    if opt.patch_size > 1:
        opt.error_map = False
        if opt.num_rays % (opt.patch_size ** 2) != 0:
            raise SystemExit("--num_rays must be a multiple of "
                             "--patch_size ** 2")
    if getattr(opt, "debug_nan", False):
        torch.autograd.set_detect_anomaly(True)
    return opt


def resolve_device(name: str) -> torch.device:
    """The device to run on. 'cuda' without a card raises: the CPU is used
    only when asked for with --device cpu."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return dev


def to_train_options(opt, name="ngp", **overrides) -> TrainOptions:
    kw = dict(
        workspace=opt.workspace, name=name, iters=opt.iters, lr=opt.lr,
        num_rays=opt.num_rays, bound=opt.bound, dt_gamma=opt.dt_gamma,
        min_near=opt.min_near, density_thresh=opt.density_thresh,
        update_extra_interval=opt.update_extra_interval,
        error_map=opt.error_map, patch_size=opt.patch_size, seed=opt.seed,
        preload=not getattr(opt, "no_preload", False),
        time_curriculum_steps=getattr(opt, "time_curriculum_steps", 0),
    )
    kw.update(overrides)
    return TrainOptions(**kw)


def load_datasets(opt, with_time=False):
    """Returns (train, val, test) NeRFDatasets; `synthetic` is procedural."""
    from .data.provider import NeRFDataset
    from .data.synthetic import make_synthetic_scene
    if opt.path.startswith("synthetic"):
        _, train, val = make_synthetic_scene(
            n_train=48, n_val=6, res=opt.synthetic_res, dynamic=with_time)
        return train, val, val
    train = NeRFDataset.load(opt.path, "train", downscale=opt.downscale,
                             scale=opt.scale, offset=tuple(opt.offset),
                             error_map=opt.error_map, with_time=with_time)
    val = NeRFDataset.load(opt.path, "val", downscale=opt.downscale,
                           scale=opt.scale, offset=tuple(opt.offset),
                           with_time=with_time)
    try:
        test = NeRFDataset.load(opt.path, "test", downscale=opt.downscale,
                                scale=opt.scale, offset=tuple(opt.offset),
                                with_time=with_time)
    except FileNotFoundError:
        test = val
    return train, val, test


def build_trainer(opt, name="ngp", dynamic=False, metrics=None,
                  use_checkpoint=None, **topt_overrides):
    """Build the CP field (seeded from --seed) and its FastTrainer on
    --device: the static field, or with dynamic=True the time-conditioned
    one (bound <= 1). Every other backbone is not ported yet and raises."""
    from .models.cp import (CPConfig, CPDNeRFConfig, make_cp_dnerf_field,
                            make_cp_field, parse_planes)
    from .train.fast import FastTrainer
    backbone = getattr(opt, "backbone", "auto")
    variant = dynamic and (getattr(opt, "basis", False)
                           or getattr(opt, "hyper", False))
    if variant:
        raise NotImplementedError("--basis and --hyper (the NGP dynamic "
                                  "variants) are not yet ported")
    eligible = opt.bg_radius <= 0 and not (dynamic and opt.bound > 1.0)
    if backbone == "cp" and not eligible:
        raise SystemExit("--backbone cp needs no --bg_radius (and "
                         "--bound <= 1 for dynamic scenes)")
    if backbone == "ngp" or not eligible:
        raise NotImplementedError(
            "the NGP backbone (--backbone ngp, --bg_radius, dynamic scenes "
            "at --bound > 1) is not yet ported")
    device = resolve_device(getattr(opt, "device", "cuda"))
    topt = to_train_options(opt, name=name, **topt_overrides)
    planes = parse_planes(getattr(opt, "planes", "auto"), opt.bound)
    gen = torch.Generator().manual_seed(opt.seed)
    if dynamic:
        field = make_cp_dnerf_field(
            gen, CPDNeRFConfig(bound=opt.bound, planes=planes), device)
    else:
        field = make_cp_field(gen, CPConfig(bound=opt.bound, planes=planes),
                              device)
    trainer = FastTrainer(name, topt, field, metrics=metrics,
                          workspace=opt.workspace,
                          use_checkpoint=use_checkpoint or opt.ckpt,
                          device=device, time_conditioned=dynamic)
    return trainer, field
