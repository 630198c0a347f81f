"""The ranks of the data-parallel tests (tests/test_torch_parallel*.py).

`run_ranks` starts `world` processes (torch.multiprocessing, spawn), each a
rank of a gloo mesh on the CPU that meets the others at a FileStore under
the test's directory, so that tests in several pytest workers never share a
port. Each rank runs one of the functions below, which import torch and the
port only, and pickles what it returns to `<dir>/<name>_<world>_r<rank>.pkl`
for the test process to check; a rank that raises fails the test.
"""

import os
import pickle

import numpy as np
import torch
import torch.multiprocessing as mp

from sealdnerf_tpu_torch.models.cp import (CPConfig, CPDNeRFConfig,
                                           params_from_jax)
from sealdnerf_tpu_torch.ops.field import (dyn_field_forward, field_forward,
                                           pack_tables)
from sealdnerf_tpu_torch.ops.marching_dense import DenseMarchConfig
from sealdnerf_tpu_torch.parallel import (all_gather_rows, from_rank0,
                                          make_mesh, pmax, pmean, psum,
                                          replicate, shard_batch)
from sealdnerf_tpu_torch.render import dynamic_grid as tdg
from sealdnerf_tpu_torch.render import grid as tgrid
from sealdnerf_tpu_torch.render.fast_image import make_sharded_image_renderer

SCALES = ((16, 8), (64, 16))
PLANES = ((16, 4),)
DYN_KW = dict(num_layers_deform=3, hidden_dim_deform=32)
SPLITS = ((0.55, 4), (0.30, 2), (1.0, 1))
FRAME_CFG = dict(bound=1.0, march_res=32, n_intervals=8, steps_per_interval=2)
# the frames' renderers: (bucketed, the spec's occupancy, the field);
# "occ_small" is an occupancy that no bucket truncates, "occ" one that
# truncates tiles, which shows on the layered field (the seeded CP fields'
# colours hardly vary, so that a coarser march hardly changes their frame)
FRAME_CASES = {"tiled": (False, "occ", "cp"),
               "bucketed": (True, "occ_small", "cp"),
               "bucketed_truncating": (True, "occ", "layers")}

def static_cfg():
    return CPConfig(bound=1.0, scales=SCALES, planes=PLANES)


def dynamic_cfg():
    return CPDNeRFConfig(bound=1.0, scales=SCALES, planes=PLANES, **DYN_KW)


def run_ranks(fn, world: int, tmp, *args):
    """fn(mesh, *args) on `world` ranks -> the list of their results."""
    tmp = str(tmp)
    name = f"{fn.__name__}_{world}"
    mp.start_processes(_rank_main, args=(fn, world, tmp, name, args),
                       nprocs=world, join=True, start_method="spawn")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"{name}_r{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank, fn, world, tmp, name, args):
    torch.set_num_threads(1)
    mesh = make_mesh(layout=["cpu"] * world, rank=rank,
                     init_method=f"file://{os.path.join(tmp, name)}.store")
    try:
        res = fn(mesh, *args)
    finally:
        mesh.close()
    with open(os.path.join(tmp, f"{name}_r{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------- collectives
def collectives(mesh):
    """Each collective on rank-dependent inputs."""
    r = mesh.rank
    x = torch.arange(6, dtype=torch.float32) * 0.1 + r
    out = {"psum": _np(psum(mesh, x.clone())),
           "pmax": _np(pmax(mesh, -(x.clone() - 2.0) ** 2)),
           "pmean": _np(pmean(mesh, x.clone() / 3.0)),
           "gather": _np(all_gather_rows(mesh, torch.full((2, 3), r + 0.5))),
           "from_rank0": from_rank0(mesh, r + 0.25)}
    state = {"f": torch.full((3, 4), float(r)).requires_grad_(True),
             "b": torch.tensor([r == 0, r != 0]),
             "i": torch.tensor(7 * r, dtype=torch.int32)}
    replicate(mesh, state.values())
    out["replicate"] = {k: _np(v) for k, v in state.items()}
    out["shard"] = _np(shard_batch(mesh, torch.arange(4 * mesh.size)))
    try:
        shard_batch(mesh, torch.arange(4 * mesh.size + 1))
        out["shard_ragged"] = "accepted"
    except ValueError:
        out["shard_ragged"] = "refused"
    out["mesh"] = (mesh.rank, mesh.size, mesh.backend, mesh.axis_name)
    return out


# ------------------------------------------------------------------ frames
def _layers(params, x3, d3, *t):
    """An analytic planar field: a ball of dense shells, coloured by
    position (and time)."""
    r = torch.sqrt((x3 * x3).sum(dim=0))
    sigma = torch.where(r < 0.55, 40.0 * (1.0 + torch.sin(12.0 * x3[2])),
                        torch.zeros_like(r))
    shift = t[0] if t else 0.0
    return torch.stack([sigma, (x3[0] + 0.5 + shift).clamp(0, 1),
                        (x3[1] + 0.5).clamp(0, 1), (x3[2] + 0.5).clamp(0, 1)])


def _forward(kind, field="cp"):
    """(config, planar forward) of a narrow CP field of `kind`, or (None,
    _layers) for field="layers"."""
    if field == "layers":
        return None, _layers
    if kind == "static":
        cfg = static_cfg()
        return cfg, lambda tb, x3, d3: field_forward(tb, cfg, x3, d3)
    cfg = dynamic_cfg()
    return cfg, lambda tb, x3, d3, t: dyn_field_forward(tb, cfg, x3, d3, t)


def frames(mesh, spec):
    """The row-band frame of each field through each of FRAME_CASES."""
    out = {}
    mcfg = DenseMarchConfig(**FRAME_CFG)
    for kind in ("static", "dynamic"):
        extra = (spec["t"],) if kind == "dynamic" else ()
        for case, (buckets, occ, field) in FRAME_CASES.items():
            cfg, fwd = _forward(kind, field)
            tables = None if cfg is None else \
                pack_tables(params_from_jax(spec[kind]), cfg)
            fn = make_sharded_image_renderer(
                mesh, spec["rh"], spec["rw"], mcfg, fwd, tile_px=8,
                buckets=buckets, splits=SPLITS)
            img, dep = fn(tables, torch.from_numpy(spec[occ]),
                          torch.from_numpy(spec["pose"]),
                          torch.from_numpy(spec["intr"]),
                          torch.from_numpy(spec["bg"]), *extra)
            out[kind, case] = (_np(img), _np(dep))
    return out


# ------------------------------------------------------------------ sweeps
def _density(kind, np_params):
    cfg, _ = _forward(kind)
    tables = pack_tables(params_from_jax(np_params), cfg)
    if kind == "static":
        return lambda pts: field_forward(tables, cfg, pts.t().contiguous(),
                                         None, density_only=True)[0]
    return lambda pts, t: dyn_field_forward(
        tables, cfg, pts.t().contiguous(), None, t, density_only=True)[0]


def sweeps(mesh, spec):
    """The merged static and dynamic refreshes of this rank's cells: the
    warm-up slab and given cells (spec's draws, split by rank)."""
    r, n = mesh.rank, mesh.size
    out = {}
    gcfg = tgrid.GridConfig(grid_size=spec["h"], density_thresh=10.0)
    dens = _density("static", spec["static"])
    for case, it in (("slab", 0), ("cells", 40)):
        st = tgrid.init_grid_state(gcfg)
        st["density_grid"] = torch.from_numpy(spec["grid"].copy())
        st["iter_density"] = torch.tensor(it, dtype=torch.int32)
        if case == "slab":
            idx = tgrid.refresh_indices(it, gcfg, rank=r, size=n)
        else:
            idx = shard_batch(mesh, torch.from_numpy(spec["cells"]))
        u = shard_batch(mesh, torch.from_numpy(spec["u"]))
        got = tgrid.update_density_grid(st, dens, gcfg, indices=idx,
                                        noise_u=u[None], mesh=mesh)
        out["static", case] = {"indices": _np(idx),
                               **{k: _np(v) for k, v in got.items()}}
    dcfg = tdg.DynGridConfig(grid_size=spec["h"], time_size=4,
                             bins_per_call=2, density_thresh=10.0)
    ddens = _density("dynamic", spec["dynamic"])
    for case, calls in (("slab", 2), ("cells", 40)):
        st = tdg.init_dyn_grid_state(dcfg)
        st["density_grid"] = torch.from_numpy(spec["dyn_grid"].copy())
        st["iter_density"] = torch.tensor(calls, dtype=torch.int32)
        st["bin_cursor"] = torch.tensor(1, dtype=torch.int32)
        draws = {"u_xyz": shard_batch(mesh, torch.from_numpy(
                     spec["dyn_u"]).transpose(0, 1)).transpose(0, 1),
                 "u_t": torch.from_numpy(spec["dyn_ut"]),
                 "indices": shard_batch(mesh, torch.from_numpy(
                     spec["dyn_cells"]).t()).t()}
        got, sums = tdg.refresh_dyn_density_grid(
            st, ddens, dcfg, warmup_calls=32, draws=draws, mesh=mesh)
        out["dynamic", case] = {"bin_sums": _np(sums),
                                **{k: _np(v) for k, v in got.items()}}
    return out


def world_checks(mesh, spec, with_sweeps):
    """What tests/test_torch_parallel.py checks of one world: the
    collectives, the frames, and at 2 ranks the warm-up slabs of the first
    two refresh calls and the merged sweeps."""
    out = {"collectives": collectives(mesh), "frames": frames(mesh, spec)}
    if with_sweeps:
        gcfg = tgrid.GridConfig(grid_size=spec["h"])
        out["slabs"] = [_np(tgrid.refresh_indices(it, gcfg, rank=mesh.rank,
                                                  size=mesh.size))
                        for it in (0, 1)]
        out["sweeps"] = sweeps(mesh, spec)
    return out


# ---------------------------------------------------------------- training
STEP_OPTS = dict(num_rays=128, error_map=True, grid_size=16, march_res=8,
                 n_intervals=4, steps_per_interval=2, samples_per_ray=16,
                 max_steps=64)
NGP_NARROW = dict(num_levels=4, log2_hashmap_size=12)


def step_trainer(kind, ws, mesh=None):
    """A seeded narrow trainer for one given-batch step: FastTrainer on the
    CP field ("fast") or Trainer on the Instant-NGP field ("ngp"), with the
    error map on and every cell of the occupancy set."""
    from sealdnerf_tpu_torch.models.api import make_ngp_field
    from sealdnerf_tpu_torch.models.cp import make_cp_field
    from sealdnerf_tpu_torch.models.ngp import NGPConfig
    from sealdnerf_tpu_torch.train.fast import FastTrainer
    from sealdnerf_tpu_torch.train.trainer import Trainer, TrainOptions
    gen = torch.Generator().manual_seed(0)
    opt = TrainOptions(workspace=ws, **STEP_OPTS)
    if kind == "fast":
        tr = FastTrainer("t", opt, make_cp_field(gen, static_cfg(), "cpu"),
                         use_checkpoint="scratch", device="cpu", mesh=mesh)
    else:
        tr = Trainer("t", opt, make_ngp_field(gen, NGPConfig(
            bound=1.0, **NGP_NARROW), "cpu"), use_checkpoint="scratch",
            device="cpu", mesh=mesh)
    tr.grid_state["occ"].fill_(True)
    if kind == "fast":
        tr._occ_m = tr._march_occ()
    tr.global_step = 1            # no grid refresh before the step
    return tr


def step_state(tr):
    """params, EMA, Adam moments (leaf order) and the error map -> numpy."""
    from sealdnerf_tpu_torch.models.params import param_leaves
    leaves = param_leaves(tr.params)
    st = [tr.optimizer.state[p] for p in leaves]
    return {"params": [_np(p) for p in leaves],
            "ema": [_np(p) for p in param_leaves(tr.ema_params)],
            "mu": [_np(s["exp_avg"]) for s in st],
            "nu": [_np(s["exp_avg_sq"]) for s in st],
            "error_map": _np(tr.error_map)}


def given_batch(spec, rank):
    """Rank `rank`'s batch of spec -> (batch tensors, image, cells)."""
    b = spec["batches"][rank]
    return (tuple(torch.from_numpy(b[k]) for k in
                  ("rays_o", "rays_d", "gt", "bg", "noise")),
            torch.tensor([b["img"]]), torch.from_numpy(b["cells"]))


def one_step(mesh, spec):
    """One train_step of each trainer on this rank's given batch."""
    out = {}
    for kind in ("fast", "ngp"):
        tr = step_trainer(kind, os.path.join(spec["ws"], kind), mesh)
        tr.error_map = torch.from_numpy(spec["error_map"]).clone()
        batch, img, cells = given_batch(spec, mesh.rank)

        def sample(data, h, w, tr=tr):
            tr._draw = (img, cells)
            return batch
        tr.sample_batch = sample
        loss, _ = tr.train_step(None, 32, 32)
        out[kind] = {"loss": float(loss), **step_state(tr)}
    # a fresh trainer's own draws: an image, pixels, background and noise
    from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
    _, train, _ = make_synthetic_scene(n_train=4, n_val=1, res=16)
    tr = step_trainer("fast", os.path.join(spec["ws"], "draws"), mesh)
    out["draws"] = [_np(x) for x in tr.sample_batch(train.device("cpu"),
                                                    16, 16)]
    return out


def band(mesh, init_ckpt, ws, argv, seeds):
    """For each seed: FastTrainer from the init checkpoint, trained through
    cli.build_trainer on this mesh, then its val PSNR."""
    from sealdnerf_tpu_torch.cli import base_parser, build_trainer, \
        postprocess
    from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
    from sealdnerf_tpu_torch.models.params import param_leaves
    _, train, val = make_synthetic_scene(n_train=6, n_val=1, res=32)
    out = []
    for seed in seeds:
        opt = postprocess(base_parser().parse_args(
            argv + ["--seed", str(seed), "--ckpt", init_ckpt, "--workspace",
                    os.path.join(ws, str(seed))]))
        tr, _ = build_trainer(opt, name="t", segment_steps=64, grid_size=32,
                              march_res=16, n_intervals=6,
                              steps_per_interval=3)
        assert tr.ndev == mesh.size
        tr.train(train, None, max_epochs=10)
        out.append({"psnr": float(tr.evaluate(val)), "steps": tr.global_step,
                    "loss": list(tr.history["loss"]),
                    "params": [_np(p) for p in param_leaves(tr.params)],
                    "grid": _np(tr.grid_state["density_grid"]),
                    "occ": _np(tr.grid_state["occ"])})
    return out


def cli_run(mesh, ws, argv, narrow, pose, intr):
    """main_nerf.main(argv) on this mesh, with the trainer cut to `narrow`,
    then a tiled frame of the trained field."""
    from sealdnerf_tpu_torch import cli, main_nerf
    main_nerf.build_trainer = lambda opt, **kw: cli.build_trainer(
        opt, **kw, **narrow)
    main_nerf.MESH_RESOLUTION = 32
    tr = main_nerf.main(argv)
    img, dep = tr.render_image(pose, intr, 32, 32, buckets=False)
    return {"img": img, "dep": dep, "ndev": tr.ndev}
