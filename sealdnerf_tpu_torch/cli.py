"""Shared CLI machinery for the main_* entry points (port of
sealdnerf_tpu/cli.py).

`base_parser` keeps every flag of the reference parser, plus --device.
--gui opens the viewers of main_nerf, main_dnerf and main_seald (gui/);
the other CLIs have none and run as without it, as the reference's do.
`build_trainer` routes the recipes as the reference does (the CP field
and FastTrainer where the recipe allows it, else the Instant-NGP or D-NeRF
field), with one departure: the Instant-NGP field without its background
sphere trains and serves on FastTrainer and the hash-grid kernel, the other
Instant-NGP and D-NeRF recipes on Trainer. --clip_text with --rand_pose >=
0 gives the trainers CLIP guidance when its weights are on the disk
(train/clip_guidance.py).

Under `torchrun --nproc_per_node N` every CLI but main_sdf trains and
serves on a data mesh of N ranks (parallel/mesh.py), one process and one
card per rank: `resolve_device` gives rank r cuda:LOCAL_RANK and the
trainers take the mesh of torchrun's environment; an edit's teacher and
student share it. --gui opens the window on rank 0 and drives the other
ranks' controllers from it (gui/follow.py). main_sdf refuses more than one
rank (`refuse_ranks`): the reference's builds no mesh.

--profile wraps the train and test calls in a torch.profiler trace that
each rank writes to <workspace>/trace/rank{r}.pt.trace.json, with the
program's "sdn." spans of frames, steps, compositing and field calls in
it, and beside it the session's tally of those spans and of the counters
(kernel calls and samples, host syncs, fetched bytes),
rank{r}.counters.json (`profiled`, utils/profiling.py).
"""

import argparse
import contextlib
import os

import numpy as np
import torch

from .parallel.mesh import make_mesh, world_size
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
    parser.add_argument("--error_map", action="store_true",
                        help="sample pixels by a per-image error map")
    parser.add_argument("--clip_text", type=str, default="")
    parser.add_argument("--rand_pose", type=int, default=-1)
    parser.add_argument("--tv_weight", type=float, default=0.0,
                        help="grid-table total-variation regularizer")
    # observability
    parser.add_argument("--profile", action="store_true",
                        help="write a profiler trace with the program's "
                        "spans, and their and the counters' tally, to "
                        "workspace/trace")
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


def cp_route(opt) -> bool:
    """Whether a dynamic recipe selects the CP/VM field (--backbone cp, or
    auto with bound <= 1, no background sphere and no --basis/--hyper), the
    backbone whose rate defaults are 1e-2 (tables) and 1e-3 (MLPs)."""
    return opt.backbone == "cp" or (opt.backbone == "auto"
                                    and _cp_eligible(opt, dynamic=True))


def edit_cp_route(opt, dynamic: bool) -> bool:
    """Whether an edit recipe (main_seald, main_SealNeRF) edits a CP field:
    --backbone cp, or auto where the reference's edit CLIs take their fast
    path (--bound <= 1, --dt_gamma 0, no background sphere, and for a
    dynamic scene neither --basis nor --hyper). The other recipes edit an
    Instant-NGP or D-NeRF teacher (StudentTrainer)."""
    backbone = getattr(opt, "backbone", "auto")
    return backbone == "cp" or (
        backbone == "auto" and opt.bound <= 1.0 and opt.dt_gamma == 0.0
        and opt.bg_radius <= 0
        and not (dynamic and (getattr(opt, "basis", False)
                              or getattr(opt, "hyper", False))))


def resolve_device(name: str) -> torch.device:
    """The device to run on. 'cuda' without a card raises: the CPU is used
    only when asked for with --device cpu. Under torchrun (more than one
    rank) 'cuda' is this rank's own card, cuda:LOCAL_RANK; a host with
    fewer cards than ranks is refused, since NCCL takes one card a rank."""
    dev = torch.device(name)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    if world_size() > 1 and dev.index is None:
        local, cards = int(os.environ.get("LOCAL_RANK", "0")), \
            torch.cuda.device_count()
        if local >= cards:
            raise SystemExit(
                f"{world_size()} ranks, but this host has {cards} CUDA "
                f"card(s): local rank {local} has none (NCCL takes one card "
                "a rank; start at most that many ranks a host)")
        dev = torch.device("cuda", local)
    return dev


def refuse_ranks(what: str):
    """Exit when this run has more than one rank: `what` runs on one device,
    as the reference's does (it builds no mesh)."""
    n = world_size()
    if n > 1:
        raise SystemExit(f"{what} runs on one device, and this run has {n} "
                         "ranks: the reference's builds no mesh and runs on "
                         "one device; start it without torchrun")


def profiled(opt, device, rank: int = 0):
    """The context that a CLI's train and test calls run in: with
    --profile, a torch.profiler trace of rank `rank` on `device` and its
    tally of spans and counters written to <workspace>/trace on exit
    (utils/profiling.py); else nothing."""
    if not getattr(opt, "profile", False):
        return contextlib.nullcontext()
    from .utils.profiling import profile_trace
    return profile_trace(os.path.join(opt.workspace, "trace"), device, rank)


def to_train_options(opt, name="ngp", **overrides) -> TrainOptions:
    kw = dict(
        workspace=opt.workspace, name=name, iters=opt.iters, lr=opt.lr,
        num_rays=opt.num_rays, bound=opt.bound, dt_gamma=opt.dt_gamma,
        min_near=opt.min_near, density_thresh=opt.density_thresh,
        update_extra_interval=opt.update_extra_interval,
        error_map=opt.error_map, patch_size=opt.patch_size, seed=opt.seed,
        preload=not getattr(opt, "no_preload", False),
        max_steps=opt.max_steps, bg_radius=opt.bg_radius,
        samples_per_ray=opt.samples_per_ray,
        eval_samples_per_ray=opt.eval_samples_per_ray,
        max_ray_batch=opt.max_ray_batch, num_steps=opt.num_steps,
        upsample_steps=opt.upsample_steps,
        tv_weight=getattr(opt, "tv_weight", 0.0),
        clip_text=getattr(opt, "clip_text", ""),
        rand_pose=getattr(opt, "rand_pose", -1),
        time_curriculum_steps=getattr(opt, "time_curriculum_steps", 0),
    )
    kw.update(overrides)
    return TrainOptions(**kw)


def load_datasets(opt, with_time=False):
    """Returns (train, val, test) NeRFDatasets; `synthetic` is procedural.
    With --error_map the training split carries an error map of ones, as
    NeRFDataset.load gives one to a training split."""
    import dataclasses

    from .data.provider import NeRFDataset
    from .data.rays import ERROR_MAP_RES
    from .data.synthetic import make_synthetic_scene
    if opt.path.startswith("synthetic"):
        _, train, val = make_synthetic_scene(
            n_train=48, n_val=6, res=opt.synthetic_res, dynamic=with_time)
        if opt.error_map:
            train = dataclasses.replace(train, error_map=np.ones(
                (len(train), ERROR_MAP_RES ** 2), np.float32))
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


def _cp_eligible(opt, dynamic: bool) -> bool:
    """Whether the recipe allows the CP field: no background sphere, and
    for a dynamic scene --bound <= 1 and neither --basis nor --hyper."""
    return (opt.bg_radius <= 0
            and not (dynamic and opt.bound > 1.0)
            and not (dynamic and (getattr(opt, "basis", False)
                                  or getattr(opt, "hyper", False))))


def build_trainer(opt, name="ngp", dynamic=False, metrics=None,
                  use_checkpoint=None, edit=False, **topt_overrides):
    """Pick the field and its trainer on --device, seeded from --seed, as
    the reference routes the recipes. The CP field and FastTrainer take
    --backbone cp, and --backbone auto where the recipe allows it: no
    --bg_radius, and for a dynamic scene --bound <= 1 and neither --basis
    nor --hyper (the static field at any --bound and --dt_gamma, its VM
    planes from --planes). Every other recipe takes the Instant-NGP field
    (static; with the background sphere at --bg_radius > 0) or the D-NeRF
    field (dynamic: --basis, --hyper, else deform). The Instant-NGP field
    without the background sphere trains and serves on FastTrainer (the
    dense march, the bucketed frames, its hash-grid kernel K5) at any
    --bound and --dt_gamma; with it, and the D-NeRF field, on Trainer's
    packed march. --backbone cp on a recipe it does not allow exits.

    edit=True builds the teacher of an edit CLI as the reference's
    main_seald and main_SealNeRF build theirs: routed by edit_cp_route, the
    Instant-NGP field with --log2_hashmap_size and the D-NeRF field with
    the background sphere of --bg_radius, both on Trainer, as the
    StudentTrainer that edits them is.

    The trainer runs on the data mesh of torchrun's environment (one rank
    without it; parallel/mesh.py:make_mesh)."""
    from .train.fast import FastTrainer
    from .train.trainer import Trainer
    backbone = getattr(opt, "backbone", "auto")
    eligible = _cp_eligible(opt, dynamic)
    use_cp = edit_cp_route(opt, dynamic) if edit else \
        backbone == "cp" or (backbone == "auto" and eligible)
    if use_cp and not eligible:
        raise SystemExit("--backbone cp needs no --bg_radius (and "
                         "--bound <= 1 for dynamic scenes)")
    device = resolve_device(getattr(opt, "device", "cuda"))
    topt = to_train_options(opt, name=name, **topt_overrides)
    gen = torch.Generator().manual_seed(opt.seed)
    kw = dict(metrics=metrics, workspace=opt.workspace,
              use_checkpoint=use_checkpoint or opt.ckpt, device=device,
              time_conditioned=dynamic, mesh=make_mesh(device))
    if use_cp:
        from .models.cp import (CPConfig, CPDNeRFConfig, make_cp_dnerf_field,
                                make_cp_field, parse_planes)
        planes = parse_planes(getattr(opt, "planes", "auto"), opt.bound)
        if dynamic:
            field = make_cp_dnerf_field(
                gen, CPDNeRFConfig(bound=opt.bound, planes=planes), device)
        else:
            field = make_cp_field(
                gen, CPConfig(bound=opt.bound, planes=planes), device)
        return FastTrainer(name, topt, field, **kw), field
    from .models.api import make_dnerf_field, make_ngp_field
    if dynamic:
        from .models.dnerf import DNeRFConfig
        variant = ("basis" if getattr(opt, "basis", False) else
                   "hyper" if getattr(opt, "hyper", False) else "deform")
        # as in the reference, main_dnerf's field has no background sphere
        # and main_seald's takes --bg_radius
        field = make_dnerf_field(gen, DNeRFConfig(
            bound=opt.bound, variant=variant,
            bg_radius=opt.bg_radius if edit else -1.0), device)
    else:
        from .models.ngp import NGPConfig
        hashmap = {"log2_hashmap_size": opt.log2_hashmap_size} if edit \
            else {}
        field = make_ngp_field(gen, NGPConfig(bound=opt.bound,
                                              bg_radius=opt.bg_radius,
                                              **hashmap), device)
        if not edit and opt.bg_radius <= 0:
            return FastTrainer(name, topt, field, **kw), field
    return Trainer(name, topt, field, **kw), field


def build_edit_trainers(opt, dynamic=False, metrics=None, **topt_overrides):
    """The trainers of a Seal edit (main_seald, main_SealNeRF) -> (teacher,
    student, mapper).

    The teacher is the trainer of the checkpoint that --teacher_ckpt
    selects in --teacher_workspace, which must exist, built as the edit
    CLIs build it (build_trainer with edit=True): the CP field and
    FastTrainer where edit_cp_route allows, else the Instant-NGP field
    (static) or the D-NeRF field (dynamic) and Trainer. A CP field takes the
    teacher checkpoint's shapes (models/cp.py:config_from_params); a
    --planes other than 'auto' that contradicts them is refused. The
    student is a FastStudentTrainer (CP) or a StudentTrainer on a field of
    the teacher's config with a copy of the teacher's params, in
    --workspace, with a copy of its whole grid state (iter_density
    included, so that a dynamic student does not enter the grid's warm-up
    again); the mapper is built from --seal_config (a path under
    --workspace, or absolute), or for a static edit from
    --workspace/seal.json; a dynamic edit without --seal_config has none.
    --secondary_teacher_workspace loads the secondary teacher in the same
    way. topt_overrides go to the options of every trainer.

    On a data mesh every rank loads the teacher's checkpoint, and the
    student runs on the teacher's mesh (one process group)."""
    import copy

    from .editing.seal_utils import get_seal_mapper
    from .editing.student import FastStudentTrainer, StudentTrainer
    from .models.cp import CPField, cp_dnerf_deform_raw, parse_planes
    from .models.params import map_params
    from .train.checkpoint import resolve_checkpoint

    cp = edit_cp_route(opt, dynamic)

    def load(workspace, ckpt):
        if resolve_checkpoint(workspace, "ngp", ckpt) is None:
            raise SystemExit(f"no teacher checkpoint '{ckpt}' in "
                             f"{workspace}")
        topt = copy.copy(opt)
        topt.workspace, topt.ckpt = workspace, ckpt
        trainer, _ = build_trainer(topt, name="ngp", dynamic=dynamic,
                                   edit=True, **topt_overrides)
        if not cp:
            return trainer
        want = parse_planes(getattr(opt, "planes", "auto"), opt.bound)
        if getattr(opt, "planes", "auto").strip().lower() != "auto" and \
                tuple(want) != tuple(trainer.field.cfg.planes):
            raise SystemExit(
                f"--planes {opt.planes} contradicts the teacher checkpoint "
                f"in {workspace}, whose field has planes "
                f"{trainer.field.cfg.planes}")
        return trainer

    teacher = load(opt.teacher_workspace, opt.teacher_ckpt)
    secondary = None
    if getattr(opt, "secondary_teacher_workspace", None):
        secondary = load(opt.secondary_teacher_workspace,
                         opt.secondary_teacher_ckpt).field
    params = map_params(lambda t: t.detach().clone(), teacher.params)
    cfg = teacher.field.cfg
    if cp:
        field = CPField(params, cfg)
        if dynamic:
            field.deform_raw = lambda params, x, t: cp_dnerf_deform_raw(
                params, cfg, x, t)
    else:
        # the field's functions take the params as an argument
        field = copy.copy(teacher.field)
        field.params = params
    if getattr(opt, "seal_config", ""):
        mapper = get_seal_mapper(opt.workspace, None, opt.seal_config)
    elif dynamic:
        mapper = None
    else:
        mapper = get_seal_mapper(opt.workspace)
    cls = FastStudentTrainer if cp else StudentTrainer
    student = cls(
        "ngp", to_train_options(opt, name="ngp", **topt_overrides), field,
        teacher, mapper=mapper, secondary_teacher=secondary,
        metrics=metrics, workspace=opt.workspace, use_checkpoint="scratch",
        device=teacher.device, time_conditioned=dynamic, mesh=teacher.mesh)
    student.adopt_grid_state(teacher.grid_state)
    student.log(f"[INFO] the student took over the teacher's grid state: "
                f"iter_density {int(student.grid_state['iter_density'])}")
    return teacher, student, mapper
