"""The CP field family (configurations with "model": "cp"): the program's
FastTrainer on a CPField, static or with the D-NeRF deform tower, and the
plain reference's side of its checks.

A field module gives the loops what depends on the model:
- `make_params(cfg, seed, device)`: the seeded weights;
- `build_trainer(cell, seed, device, workspace, extra_args)` and
  `training_data(cell, trainer)`: the program, built as its CLI builds it,
  and its training views;
- `reference_steps`, `reference_grid`, `grid_occupancy`,
  `reference_frames`: the reference put in the program's place.
"""

import math

import numpy as np
import torch

from nerfbench import scene
from nerfbench.capture import Outputs, clone_tree
from nerfbench.reference import field as rf
from nerfbench.reference import grid as rg
from nerfbench.reference import render as rr
from nerfbench.reference import train as rt
from nerfbench.work import deform_dims, tower_dims

# the occupancy grid's decay of the program's defaults (GridConfig and
# DynGridConfig), which the reference applies to the grid it rebuilds
GRID_DECAY = 0.95


def is_dynamic(cfg: dict) -> bool:
    return "multires_deform" in cfg


def param_shapes(cfg: dict):
    """The field's parameter tree as shapes: (tables, towers), each a list
    of (path, shape), in the program's names and layouts."""
    tables = []
    for s, (res, rank) in enumerate(cfg["scales"]):
        tables += [(("lines", s, a), (res, rank)) for a in range(3)]
    for s, (pres, ch) in enumerate(cfg["planes"]):
        tables += [(("planes", s, p), (pres, pres, ch)) for p in range(3)]
        tables += [(("vm_lines", s, p), (pres, ch)) for p in range(3)]
    towers = []
    sigma, color = tower_dims(cfg)
    dims = [("sigma_mlp", sigma), ("color_mlp", color)]
    if is_dynamic(cfg):
        dims.append(("deform_mlp", deform_dims(cfg)))
    for name, d in dims:
        towers += [((name, "w", i), (d[i], d[i + 1]))
                   for i in range(len(d) - 1)]
    return tables, towers


def make_params(cfg: dict, seed: int, device) -> dict:
    """The seeded field, on the device in two draws: tables init_scale *
    N(0, 1), tower matrices U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the deform
    tower's last matrix scaled by 1e-3 (the program's init)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    tables, towers = param_shapes(cfg)
    n_tab = sum(math.prod(s) for _, s in tables)
    n_tow = sum(math.prod(s) for _, s in towers)
    tab = torch.randn(n_tab, generator=g, device=device) * cfg["init_scale"]
    tow = torch.rand(n_tow, generator=g, device=device)
    params, off = {}, 0
    for path, shape in tables:
        n = math.prod(shape)
        params.setdefault(path[0], [])
        while len(params[path[0]]) <= path[1]:
            params[path[0]].append([])
        params[path[0]][path[1]].append(tab[off:off + n].view(shape).clone())
        off += n
    off = 0
    for path, shape in towers:
        n = math.prod(shape)
        bound = 1.0 / math.sqrt(shape[0])
        w = tow[off:off + n].view(shape) * (2.0 * bound) - bound
        params.setdefault(path[0], {"w": []})["w"].append(w)
        off += n
    if "deform_mlp" in params:
        params["deform_mlp"]["w"][-1] = params["deform_mlp"]["w"][-1] * 1e-3
    return params


# ------------------------------------------------------------ the program
def build_trainer(cell, seed: int, device: str, workspace: str,
                  extra_args=()):
    """The program's FastTrainer on the seeded params, built as its CLI
    builds one (main_nerf / main_dnerf's parser on the configuration's
    flags, cli.to_train_options, one rank), on the configuration file's
    field (the files of the cells hold the CLI's, as a test pins) and with
    the training options it sets -> (trainer, params given, its
    TrainOptions)."""
    from sealdnerf_tpu_torch import cli, main_dnerf
    from sealdnerf_tpu_torch.models.cp import (CPConfig, CPDNeRFConfig,
                                               CPField, cp_dnerf_deform_raw)
    from sealdnerf_tpu_torch.parallel.mesh import make_mesh
    from sealdnerf_tpu_torch.train.fast import FastTrainer
    argv = list(cell.config["cli"]) + [
        "--seed", str(seed), "--workspace", workspace, "--ckpt", "scratch",
        "--device", device] + list(extra_args)
    fc = dict(cell.field)
    dynamic = is_dynamic(fc)
    if dynamic:
        opt = main_dnerf.parse_args(argv)
        kw = {"lr_net": opt.lr_net}
        cfg_cls = CPDNeRFConfig
    else:
        opt = cli.postprocess(cli.base_parser().parse_args(argv))
        kw = {}
        cfg_cls = CPConfig
    known = set(cfg_cls.__dataclass_fields__)
    cfg = cfg_cls(**{k: (tuple(tuple(x) for x in v)
                         if k in ("scales", "planes") else v)
                     for k, v in fc.items() if k in known})
    dev = cli.resolve_device(device)
    params = make_params(fc, seed, dev)
    field = CPField(clone_tree(params), cfg)
    if dynamic:
        field.deform_raw = lambda p, x, t: cp_dnerf_deform_raw(p, cfg, x, t)
    kw.update(cell.config.get("options", {}))
    topt = cli.to_train_options(opt, name="ngp", **kw)
    trainer = FastTrainer("ngp", topt, field, metrics=None,
                          workspace=workspace, use_checkpoint="scratch",
                          device=dev, time_conditioned=dynamic,
                          mesh=make_mesh(dev))
    return trainer, params, topt


def training_data(cell, trainer):
    """The scene's training views on the device, prepared as the
    trainer's train() prepares a dataset (the time curriculum, the
    cameras' coverage of the grid) -> (data, h, w, (poses, intrinsics) as
    the benchmark made them)."""
    from sealdnerf_tpu_torch.data.provider import NeRFDataset
    ds = cell.config["dataset"]
    poses, images, intr, times = scene.training_views(
        ds["views"], ds["res"], ds["fov"], ds["radius"],
        is_dynamic(cell.field), trainer.device)
    res = ds["res"]
    dataset = trainer._prepare_train(NeRFDataset(
        poses=poses, images=images, intrinsics=intr, h=res, w=res,
        times=times))
    trainer.mark_untrained_grid(dataset.poses, dataset.intrinsics)
    dev = trainer.device
    data = {"poses": torch.as_tensor(dataset.poses, device=dev),
            "intrinsics": torch.as_tensor(dataset.intrinsics, device=dev),
            "images": dataset.images.reshape(len(dataset), res * res, -1)}
    if dataset.times is not None:
        data["times"] = torch.as_tensor(dataset.times, device=dev)
    trainer._ready_for_steps(data)
    views = (torch.as_tensor(np.asarray(poses, np.float32), device=dev),
             np.asarray(intr, np.float32))
    return data, res, res, views


# ------------------------------------------------------- the reference
def ramp(o, step: int) -> float:
    """The coarse-to-fine ramp at `step`, in f32 as the program takes it."""
    if o.dyn_anneal_steps <= 0:
        return 1.0
    return min(max(float(np.float32(step) / np.float32(o.dyn_anneal_steps)),
                   0.0), 1.0)


def _annealed(cell, o, params, step: int):
    fc = dict(cell.field, anneal_res=o.dyn_anneal_res)
    if is_dynamic(cell.field):
        params = rf.anneal(params, fc, ramp(o, step))
    return fc, params


def train_settings(cell, o):
    """(field, march and optimizer settings) of the reference's steps, from
    the configuration and the trainer's options."""
    fc = dict(cell.field, anneal_res=o.dyn_anneal_res)
    mc = {"bound": fc["bound"], "min_near": o.min_near,
          "n_intervals": o.n_intervals,
          "steps_per_interval": o.steps_per_interval,
          "density_scale": o.density_scale, "t_thresh": o.t_thresh}
    opt = {"lr": o.lr, "lr_net": o.lr_net, "iters": o.iters,
           "ema_decay": o.ema_decay, "anneal_steps": o.dyn_anneal_steps,
           "deform_zero_reg": o.deform_zero_reg}
    return fc, mc, opt


def time_bin(t, bins: int) -> int:
    """The bin of time t among `bins`, in f32 as the program takes it."""
    return int(min(max(math.floor(np.float32(float(t)) * np.float32(bins)),
                       0), bins - 1))


def _step_occupancies(cell, cap):
    """The march-resolution occupancy that each step marched: of the
    step's time bin for a dynamic field."""
    occs = []
    for b, occ in zip(cap.batches, cap.occs):
        if is_dynamic(cell.field):
            occ = occ[time_bin(b["t"], occ.shape[0])]
        occs.append(occ[0] if occ.dim() == 4 else occ)
    return occs


def reference_steps(cell, cap, params0, o, q, step0: int = 0,
                    batches=None) -> Outputs:
    """The reference put in the program's place for the captured steps, at
    precision q, on the program's batches (or `batches`) and occupancies,
    in the form StepCapture holds them. From step 0 it starts from the
    seeded `params0`; from a later `step0` from the program's state at the
    steps' start (params, Adam's moments, EMA), which it cannot work out
    again without following every step before."""
    fc, mc, opt = train_settings(cell, o)
    occs = _step_occupancies(cell, cap)
    state, p = None, params0
    if step0:
        p = rt.rebuild(params0, iter(cap.params_before))
        state = {"m": cap.m_before, "v": cap.v_before,
                 "ema": cap.ema_before}
    ref = rt.follow(p, fc, mc, opt, batches or cap.batches, occs, q,
                    step0=step0, state=state)
    out = Outputs(losses=ref["losses"], grad0=ref["grad0"],
                  params_after=ref["params"], ema_after=ref["ema"],
                  queries=[])
    if cap.queries and not step0:
        # the first refresh, of the seeded field at step 0
        _, p = _annealed(cell, o, params0, 0)
        cells = torch.arange(o.grid_size ** 3 // 2,
                             device=cap.rows_before.device)
        sig, occ = rg.refresh_rows(
            p, fc, [(cells, pts, t) for pts, t, _ in cap.queries],
            cap.rows_before, cap.total_before, cap.n_cells, GRID_DECAY,
            o.density_thresh, q)
        out.queries = [(pts, t, s) for (pts, t, _), s in
                       zip(cap.queries, sig)]
        out.occ_after = occ
    return out


def _row_bound(cell, row: int) -> float:
    """The half-extent of a grid row: a static grid's row is a cascade."""
    b = cell.field["bound"]
    return b if is_dynamic(cell.field) else min(float(1 << row), b)


def reference_grid(cell, rec: dict, o, q, views, full: bool) -> dict:
    """The reference's side of the grid check of the program's last update
    `rec` (GridCapture's): its density at the update's points from the
    params the update read (annealed at its step by the reference), the
    rows it updated worked out again from the rows before and the cells a
    training camera sees (the rows it did not query enter only the mean
    density, as the grid holds them), and how far the points that lie in
    their cells fall short of the H^3 (a full sweep) or H^3 / 2 that a row
    is due."""
    fc, p = _annealed(cell, o, rec["params"], rec["step"])
    h = o.grid_size
    poses, intr = views
    sig, covered, counts, bounds, seen = [], {}, [], {}, {}
    for row, pts, t, _ in rec["queries"]:
        b = bounds[row] = _row_bound(cell, row)
        s, _ = rf.forward_chunked(p, fc, pts, None, t, q, density_only=True)
        sig.append(s)
        if b not in seen:
            seen[b] = rg.coverage(poses, intr, h, b)
        covered[row] = seen[b]
        counts.append(int(rg.cells_of(pts, h, b)[1].sum()))
    due = h ** 3 if full else h ** 3 // 2
    short = max(0.0, 1.0 - min(counts) / due) if counts else 1.0
    return {"sigma": sig, "covered": covered, "bounds": bounds,
            "shortfall": short,
            "occ": grid_occupancy(rec, sig, covered, bounds, o)}


def grid_occupancy(rec: dict, sigma, covered, bounds, o) -> dict:
    """The occupancy {row: [H^3]} of the update's rows from the densities
    `sigma` at its points (the reference's, or the control's in the
    program's place)."""
    return rg.updated_rows(
        [(row, pts, s * o.density_scale) for (row, pts, _, _), s in
         zip(rec["queries"], sigma)], rec["rows_before"], covered,
        o.grid_size, bounds, GRID_DECAY, rec["total_after"],
        rec["after_sums"], rec["n_cells"], o.density_thresh)


def frame_inputs(cell, o, params, step: int):
    """(field, frame settings, params) of the reference's frames, worked
    out from the program's state: the coarse-to-fine ramp at `step` on the
    EMA params of a dynamic field."""
    fc, params = _annealed(cell, o, params, step)
    mc = {"bound": fc["bound"], "min_near": o.min_near,
          "n_intervals": o.render_n_intervals or 2 * o.n_intervals,
          "steps_per_interval": o.render_steps_per_interval
          or o.steps_per_interval,
          "density_scale": o.density_scale, "t_thresh": o.t_thresh,
          "march_res": o.render_march_res or o.march_res,
          "dilate": o.render_dilate, "tile_px": o.render_tile_px,
          "splits": o.render_splits, "term_probe": o.render_term_intervals,
          "term_tau": o.render_term_tau,
          "term_stride": o.render_term_stride}
    return fc, mc, params


def reference_frame(cell, fc, mc, params, occ, pose, intr, h, w, t, q):
    """One frame by the reference: the time's bin of the grid, the march
    resolution, the tile, and bucketed (below 15 % occupancy of the whole
    grid) or tiled, as the program decides them. A camera that the program
    marches per ray (tile 1) needs a per-ray reference, which a mix names
    as a module of reference/ ("frame_reference")."""
    dev = occ.device
    if float(occ.float().mean()) >= 0.15:
        mc = dict(mc, splits=((1.0, 1),), term_probe=0)
    occ_t = occ[time_bin(t, occ.shape[0])] if is_dynamic(cell.field) \
        else occ
    occ_m = rr.downsample(occ_t[0] if occ_t.dim() == 4 else occ_t,
                          mc["march_res"])
    tp = rr.pick_tile(h, w, pose, intr, mc["bound"], mc["march_res"],
                      mc["dilate"], mc["tile_px"])
    if tp == 1:
        raise NotImplementedError("the CP reference renders tiled frames "
                                  "only; this camera marches per ray")
    img, _ = rr.render_frame(params, fc, occ_m,
                             torch.as_tensor(pose, device=dev),
                             torch.as_tensor(intr, device=dev), h, w,
                             dict(mc, tile_px=tp), torch.ones(3, device=dev),
                             t, q)
    return img


def reference_frames(cell, kept, state, o, q, render=reference_frame):
    """The sampled frames rendered by the reference (`render`) at precision
    q, in the form the frame loop keeps them."""
    params, occ, step = state
    fc, mc, p = frame_inputs(cell, o, params, step)
    return [(render(cell, fc, mc, p, occ, pose, intr, h, w, t,
                    q).cpu().numpy(), pose, intr, h, w, t)
            for _, pose, intr, h, w, t in kept]
