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
import time

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


def run_ranks(fn, world: int, tmp, *args, timeout=None):
    """fn(mesh, *args) on `world` ranks -> the list of their results. With
    a timeout (seconds) the ranks still running after it are killed and
    the call raises TimeoutError."""
    tmp = str(tmp)
    name = f"{fn.__name__}_{world}"
    ctx = mp.start_processes(_rank_main, args=(fn, world, tmp, name, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{name}: ranks still running after "
                               f"{timeout} s")
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
    """A numpy copy of t (not a view: the trainers step their tensors in
    place)."""
    return t.detach().cpu().numpy().copy()


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


# ----------------------------------------------------------------- editing
def gathers(mesh, n):
    """share / gather_shares of n items of ragged lengths, and
    broadcast_object of rank 0's object."""
    from sealdnerf_tpu_torch.parallel import (broadcast_object,
                                              gather_shares, share)
    mine = [torch.arange(3 * (i % 3 + 1), dtype=torch.float32)
            .reshape(-1, 3) + 10 * i for i in share(mesh, n)]
    got = gather_shares(mesh, mine, n)
    obj = broadcast_object(mesh, {"rank": mesh.rank, "call": ("x", (1,))})
    return {"share": list(share(mesh, n)), "gathered": [_np(t) for t in got],
            "object": obj}


def edit_teacher_and_student(spec, kind, mesh=None):
    """spec's teacher of `kind` from its checkpoint and the student around
    it, with spec's mapper, on `mesh` (None: one rank): FastTrainer and
    FastStudentTrainer for the CP fields, Trainer and StudentTrainer for
    the Instant-NGP / D-NeRF ones, as the edit CLIs build them."""
    import copy

    from sealdnerf_tpu_torch.editing.seal_utils import get_seal_mapper
    from sealdnerf_tpu_torch.editing.student import (FastStudentTrainer,
                                                     StudentTrainer)
    from sealdnerf_tpu_torch.models.api import (make_dnerf_field,
                                                make_ngp_field)
    from sealdnerf_tpu_torch.models.cp import (CPField, cp_dnerf_deform_raw,
                                               make_cp_dnerf_field,
                                               make_cp_field)
    from sealdnerf_tpu_torch.models.dnerf import DNeRFConfig
    from sealdnerf_tpu_torch.models.ngp import NGPConfig
    from sealdnerf_tpu_torch.models.params import map_params
    from sealdnerf_tpu_torch.train.fast import FastTrainer
    from sealdnerf_tpu_torch.train.trainer import Trainer, TrainOptions
    k = spec["kinds"][kind]
    dyn, gen = k["dynamic"], torch.Generator().manual_seed(0)
    if k["cp"]:
        field = (make_cp_dnerf_field(gen, CPDNeRFConfig(**k["field"])) if dyn
                 else make_cp_field(gen, CPConfig(**k["field"])))
    else:
        field = (make_dnerf_field(gen, DNeRFConfig(**k["field"])) if dyn
                 else make_ngp_field(gen, NGPConfig(**k["field"])))
    kw = dict(use_checkpoint="scratch", device="cpu", time_conditioned=dyn,
              mesh=mesh)
    tt = (FastTrainer if k["cp"] else Trainer)(
        "ngp", TrainOptions(**k["teacher_opts"]), field,
        workspace=k["teacher_opts"]["workspace"],
        **dict(kw, use_checkpoint="latest"))
    params = map_params(lambda t: t.detach().clone(), tt.params)
    if k["cp"]:
        sfield = CPField(params, tt.field.cfg)
        if dyn:
            cfg = tt.field.cfg
            sfield.deform_raw = lambda p, x, t: cp_dnerf_deform_raw(p, cfg,
                                                                    x, t)
    else:
        sfield = copy.copy(tt.field)
        sfield.params = params
    ws = k["student_opts"]["workspace"]
    st = (FastStudentTrainer if k["cp"] else StudentTrainer)(
        "ngp", TrainOptions(**k["student_opts"]), sfield, tt,
        mapper=get_seal_mapper(ws, spec["seal"]), workspace=ws, **kw)
    st.adopt_grid_state(tt.grid_state)
    st.time_frame = spec["time_frame"] if dyn else None
    return tt, st


def edit_val(spec, kind):
    """The val views of the scene of `kind`."""
    from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
    return make_synthetic_scene(n_train=6, n_val=2, res=32,
                                dynamic=spec["kinds"][kind]["dynamic"])[2]


def _leaves(tr):
    from sealdnerf_tpu_torch.models.params import param_leaves
    return param_leaves(tr.params)


def _restore(tr, snap):
    with torch.no_grad():
        for p, s in zip(_leaves(tr), snap):
            p.copy_(s)


def edit_pretraining(st, spec):
    """The zones (init_pretraining with spec's zones), then one pretraining
    step from the student's params on each of spec's batches (zone, index),
    each with a fresh pretraining Adam -> (zones, steps); the student's
    params are restored after each."""
    from sealdnerf_tpu_torch.editing import student as student_mod
    student_mod.TEACHER_QUERY_CHUNK = spec["query_chunk"]
    st.init_pretraining(time_frame=st.time_frame, epochs=1,
                        batch_size=spec["pre_batch"], **spec["zones"])
    zones = {z: {k: _np(v) for k, v in d.items()}
             for z, d in st.pretraining_data.items()}
    snap = [p.detach().clone() for p in _leaves(st)]
    steps = []
    for zone, i in spec["pre_batches"]:
        st._build_pretrain_optimizer()
        batch = {k: v[i] for k, v in st.pretraining_data[zone].items()}
        loss = st.pretrain_step(batch)
        steps.append({"loss": float(loss),
                      "params": [_np(p) for p in _leaves(st)]})
        _restore(st, snap)
    return zones, steps


def edit_checks(mesh, spec):
    """For each of spec's kinds: the proxy of the val views, the zones and
    the pretraining steps, and for the kinds in spec["distil"] one
    distillation step on this rank's given batch; `gathers` of each count
    in spec["gathers"]."""
    out = {"gathers": {n: gathers(mesh, n) for n in spec["gathers"]}}
    for kind in spec["kinds"]:
        tt, st = edit_teacher_and_student(spec, kind, mesh)
        proxy = st.proxy_dataset(edit_val(spec, kind))
        zones, steps = edit_pretraining(st, spec)
        out[kind] = {"proxy": proxy.images, "times": proxy.times,
                     "zones": zones, "steps": steps}
        if kind in spec["distil"]:
            out[kind]["distil"] = distil_step(
                st, spec["distil"][kind][mesh.rank])
            out[kind]["teacher_deform"] = [_np(p) for p in deform_leaves(tt)]
    return out


def deform_leaves(tr):
    """The leaves that an edit freezes (freeze_labels' "deform")."""
    from sealdnerf_tpu_torch.editing.student import freeze_labels
    from sealdnerf_tpu_torch.models.params import param_leaves
    labels = freeze_labels(tr.params)
    return [p for k in sorted(tr.params) if labels[k] == "deform"
            for p in param_leaves(tr.params[k])]


def distil_batch(b):
    """A given distillation batch (numpy) -> the trainer's batch tuple."""
    return tuple(torch.from_numpy(np.asarray(b[k])) for k in
                 ("rays_o", "rays_d", "gt", "bg", "noise", "t", "x_reg")
                 if k in b)


def distil_step(st, b):
    """One train_step of the student on the given batch b (no grid refresh
    before it) -> its loss and state."""
    st._ensure_deform_frozen()
    st.global_step = 1
    batch = distil_batch(b)
    st.sample_batch = lambda data, h, w: batch
    loss, _ = st.train_step(None, 32, 32)
    del st.sample_batch
    return {"loss": float(loss), "deform": [_np(p) for p in deform_leaves(st)],
            **edit_state(st)}


def edit_state(tr):
    """params, EMA and the Adam moments of the stepped leaves -> numpy."""
    from sealdnerf_tpu_torch.models.params import param_leaves
    leaves = param_leaves(tr.params)
    st = [tr.optimizer.state.get(p) for p in leaves]
    return {"params": [_np(p) for p in leaves],
            "ema": [_np(p) for p in param_leaves(tr.ema_params)],
            "mu": [None if s is None else _np(s["exp_avg"]) for s in st],
            "nu": [None if s is None else _np(s["exp_avg_sq"]) for s in st]}


def edit_cli(mesh, runs, pose, intr):
    """Each (module name, argv, narrow overrides) of runs on this mesh ->
    the student's frame at pose (tiled), its rank count and state."""
    import importlib

    from sealdnerf_tpu_torch import cli
    out = []
    for name, argv, narrow in runs:
        mod = importlib.import_module(f"sealdnerf_tpu_torch.{name}")
        mod.build_edit_trainers = lambda opt, _n=narrow, **kw: \
            cli.build_edit_trainers(opt, **kw, **_n)
        st = mod.main(argv)
        img, dep = st.render_image(pose, intr, 32, 32, buckets=False)
        out.append({"img": img, "dep": dep, "ndev": st.ndev,
                    "proxy": st.proxied["train"].images,
                    **edit_state(st)})
    return out


# ------------------------------------------------------- other workloads
def narrow_tensorf(ws, mesh=None, cc=False):
    """A seeded narrow TensoRF trainer (VM; cc: CCNeRF's CP field with the
    K-loss at 0.25 and 0.5) with every occupancy cell set, at global step
    1; the TensoRF one upsamples (16 -> 24) at that step."""
    from sealdnerf_tpu_torch.main_tensoRF import TensoRFTrainer
    from sealdnerf_tpu_torch.models.api import make_tensorf_field
    from sealdnerf_tpu_torch.models.tensorf import TensoRFConfig
    from sealdnerf_tpu_torch.train.trainer import Trainer, TrainOptions
    cfg = TensoRFConfig(
        bound=1.0, decomposition="cp" if cc else "vm", resolution=16,
        sigma_rank=(8,) if cc else (4, 4, 4),
        color_rank=(8,) if cc else (8, 8, 8), color_feat_dim=9,
        hidden_dim_color=16)
    opt = TrainOptions(workspace=ws, num_rays=128, lr=2e-2, lr_net=1e-3,
                       grid_size=16, max_steps=64, samples_per_ray=16,
                       iters=100, k_rank_fracs=(0.25, 0.5) if cc else ())
    field = make_tensorf_field(torch.Generator().manual_seed(0), cfg, "cpu")
    kw = dict(workspace=ws, use_checkpoint="scratch", device="cpu",
              mesh=mesh)
    tr = Trainer("ccnerf", opt, field, **kw) if cc else TensoRFTrainer(
        "tensorf", opt, field, upsample_steps=(1,), resolution1=24, **kw)
    tr.grid_state["occ"].fill_(True)
    tr.global_step = 1
    return tr


def given_step(tr, b):
    """One train_step of tr on the given batch b (5 tensors) -> its loss
    and state."""
    batch = distil_batch(b)
    tr.sample_batch = lambda data, h, w: batch
    loss, _ = tr.train_step(None, 32, 32)
    del tr.sample_batch
    return {"loss": float(loss), **edit_state(tr)}


def run_state(tr):
    """edit_state, the grid state and the step count of a trained run."""
    return {"steps": tr.global_step, "loss": list(tr.history["loss"]),
            "grid": {k: _np(v) for k, v in tr.grid_state.items()},
            **edit_state(tr)}


def workloads(mesh, spec):
    """main_tensoRF across an upsample, main_CCNeRF, their given-batch
    steps, and main_CCNeRF --compose of the CCNeRF run, on this mesh."""
    from sealdnerf_tpu_torch import cli, main_CCNeRF, main_tensoRF
    main_tensoRF.UPSAMPLE_STEPS = ()
    for mod in (main_tensoRF, main_CCNeRF):
        mod.to_train_options = lambda opt, _f=cli.to_train_options, **kw: \
            _f(opt, **kw, **spec["narrow"])
    out = {}
    tr = main_tensoRF.main(spec["tensorf"])
    out["tensorf"] = dict(run_state(tr), res=tr.field.cfg.resolution)
    out["tensorf_step"] = given_step(
        narrow_tensorf(spec["ws"] + "/tensorf_step", mesh),
        spec["batches"][mesh.rank])
    tr = main_CCNeRF.main(spec["ccnerf"])
    out["ccnerf"] = run_state(tr)
    out["ccnerf_step"] = given_step(
        narrow_tensorf(spec["ws"] + "/ccnerf_step", mesh, cc=True),
        spec["batches"][mesh.rank])
    viewer = main_CCNeRF.main(spec["compose"])
    out["compose"] = {"grid": {k: _np(v)
                               for k, v in viewer.grid_state.items()},
                      "ndev": viewer.ndev}
    return out


# --------------------------------------------------------------------- GUI
class _Clock:
    """time.time() of the GUI controller: 0.1 s a call, so that the
    pacing keeps its downscale the same in every run."""

    def __init__(self):
        self.t = 0.0

    def time(self):
        self.t += 0.1
        return self.t


def _drive(n, script, frames):
    """drive(view) for gui.follow.run_view: the view's own frame loop on
    the headless backend for n frames, script(i) before frame i, each
    frame's render buffer appended to frames."""
    from sealdnerf_tpu_torch.gui import headless_dpg as hdpg

    def drive(view):
        running = hdpg.is_dearpygui_running

        def hooked():
            ok = running()
            i = hdpg._S.frame_count
            if i > 0:
                frames.append(np.array(view.ctl.render_buffer))
            if ok:
                script(i)
            return ok
        hdpg.is_dearpygui_running = hooked
        try:
            hdpg.configure(max_frames=n)
            view.render()
        finally:
            hdpg.is_dearpygui_running = running
    return drive


def _script(events):
    """script(i) that fires events[i] (a list of (name, *args) calls of
    the headless backend) before frame i."""
    from sealdnerf_tpu_torch.gui import headless_dpg as hdpg

    def script(i):
        for name, *args in events.get(i, ()):
            getattr(hdpg, name)(*args)
    return script


def gui_sessions(mesh, spec):
    """The three viewers, scripted, on this mesh (mesh None: one rank, in
    the calling process): NeRFGUI serving and training, DNeRFGUI serving
    at three times, SealDGUI editing -> rank 0's frames and every rank's
    state after each session."""
    from sealdnerf_tpu_torch import cli, main_dnerf, main_seald
    from sealdnerf_tpu_torch.cli import base_parser, postprocess
    from sealdnerf_tpu_torch.data.synthetic import make_synthetic_scene
    from sealdnerf_tpu_torch.gui import controller
    from sealdnerf_tpu_torch.gui.controller import GUIController
    from sealdnerf_tpu_torch.gui.dnerf_gui import DNeRFGUI
    from sealdnerf_tpu_torch.gui.edit_controller import EditController
    from sealdnerf_tpu_torch.gui.follow import run_view
    from sealdnerf_tpu_torch.gui.nerf_gui import NeRFGUI
    from sealdnerf_tpu_torch.gui.seald_gui import SealDGUI
    from sealdnerf_tpu_torch.train import fast
    view_argv = ["--W", "32", "--H", "32", "--radius", "2", "--device",
                 "cpu", "--bound", "1", "--dt_gamma", "0", "--max_steps",
                 "128", "-O"]
    out = {}

    bands = []
    sharded = fast.make_sharded_image_renderer
    fast.make_sharded_image_renderer = lambda *a, **kw: (
        bands.append(1), sharded(*a, **kw))[1]

    def session(name, make_view, ctl, events, n):
        controller.time = _Clock()
        ctl.downscale = 1
        frames = []
        t0 = time.perf_counter()
        view = run_view(make_view, ctl, _drive(n, _script(events), frames))
        out[name] = {"frames": frames, "view": view is not None,
                     "time": ctl.time, "step": ctl.trainer.global_step,
                     "bands": len(bands), "seconds": time.perf_counter() - t0,
                     **edit_state(ctl.trainer)}
        bands.clear()

    def trainer(argv, dynamic=False):
        parse = main_dnerf.parse_args if dynamic else \
            (lambda a: postprocess(base_parser().parse_args(a)))
        opt = parse(argv + view_argv)
        tr, _ = cli.build_trainer(opt, dynamic=dynamic,
                                  **spec["narrow"], **(
                                      {"lr_net": opt.lr_net} if dynamic
                                      else {}))
        return opt, tr

    drag = {1: [("emit_drag", 0, 6.0, 4.0)], 2: [("emit_wheel", 1.0)],
            3: [("emit_drag", 2, 2.0, -1.0)]}
    # NeRFGUI serving the static teacher
    opt, tr = trainer(["synthetic", "--ckpt", spec["static"], "--workspace",
                       spec["ws"] + "/nerf", "--test"])
    session("nerf", lambda c: NeRFGUI(opt, tr, controller=c, headless=True),
            GUIController(opt, tr), drag, 4)
    # NeRFGUI training it on the 32-px scene
    _, train, _ = make_synthetic_scene(n_train=4, n_val=1, res=32)
    session("nerf_train", lambda c: NeRFGUI(opt, tr, train_dataset=train,
                                            controller=c, headless=True),
            GUIController(opt, tr, train),
            {0: [("click_item", "start")]}, 3)
    out["nerf_train"]["grid"] = {k: _np(v) for k, v in
                                 tr.grid_state.items()}
    # DNeRFGUI serving the dynamic teacher at three times
    opt, tr = trainer(["synthetic", "--ckpt", spec["dynamic"],
                       "--workspace", spec["ws"] + "/dnerf", "--test"],
                      dynamic=True)
    session("dnerf", lambda c: DNeRFGUI(opt, tr, controller=c,
                                        headless=True),
            GUIController(opt, tr),
            {1: [("set_widget", "time", 0.5)],
             2: [("set_widget", "time", 1.0)]}, 3)
    # SealDGUI: the brush at t = 0.5, the edit, the override
    opt = main_seald.parse_args(
        ["synthetic", "--teacher_workspace", spec["dynamic_ws"],
         "--workspace", spec["ws"] + "/seald"] + view_argv)
    teacher, student, _ = cli.build_edit_trainers(
        opt, dynamic=True, lr_net=opt.lr_net, **spec["narrow"])
    _, dtrain, _ = make_synthetic_scene(n_train=4, n_val=1, res=32,
                                        dynamic=True)
    strokes = [("set_mouse_pos", 12.0 + k, 14.0) for k in range(4)]
    events = {0: [("set_widget", "time", 0.5), ("click_item", "brush")],
              1: [e for s in strokes for e in (s, ("emit_drag", 1, 1, 0))],
              2: [("click_item", "start edit")],
              6: [("click_item", "override teacher")]}
    ctl = EditController(opt, teacher, student, dtrain)
    session("seald", lambda c: SealDGUI(opt, teacher, student,
                                        train_dataset=dtrain, controller=c,
                                        headless=True),
            ctl, events, 8)
    out["seald"]["teacher"] = edit_state(teacher)
    out["seald"]["pretraining"] = ctl._pretrain_done \
        if hasattr(ctl, "_pretrain_done") else None
    return out
