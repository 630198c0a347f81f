"""SDF-fitting CLI of the port (counterpart of the repository's main_sdf.py).

    python -m sealdnerf_tpu_torch.main_sdf MESH|synthetic [--epochs N] \\
        [--num_samples N] [--mesh_resolution R] [--test] [--device cpu]

Fits the hash-grid SDF network (models/sdf.py) to a mesh (PLY or OBJ;
`synthetic` writes a procedural sphere mesh into the workspace first) with
the MAPE loss: epochs of len(dataset) = 100 steps, each on a fresh batch of
--num_samples points drawn on the host (data/sdf_provider.py: numpy draws,
the BVH's signed distances); Adam (betas 0.9 / 0.99, eps 1e-15) in two
groups, the grid ("enc") and the tower ("net", weight decay 1e-6 added to
the gradient before Adam, as optax's add_decayed_weights ahead of adam),
at lr x 0.1 every 1,000 steps; an EMA of 0.95 / 0.05 each step. Each epoch
logs its mean loss and writes workspace/checkpoints/sdf_ep{N}.npz ({"params",
"ema"} in the reference's format). At the end the EMA's surface is
exported: marching tetrahedra of -sdf at 0 on a --mesh_resolution^3 grid of
[-1, 1]^3 -> workspace/results/output.ply. --test exports the `best`
checkpoint (or the latest) instead, or the seeded network when there is
none. --profile (the flag of the other CLIs; the reference's main_sdf has
none) writes a torch.profiler trace of the fit and the export to
<workspace>/trace/rank0.pt.trace.json.

It runs on one device: the reference's main_sdf builds no mesh, so under
torchrun with more than one rank it exits (cli.refuse_ranks).
"""

import argparse
import os
import time

import numpy as np
import torch

from .cli import profiled, refuse_ranks, resolve_device
from .models.params import map_params, param_leaves, params_from_jax
from .models.sdf import SDFConfig, init_sdf, sdf_forward
from .ops.losses import mape_loss
from .train.checkpoint import (load_checkpoint, resolve_checkpoint,
                               save_checkpoint)

STEPS_PER_EPOCH = 100
LR_DECAY_STEPS = 1000            # the lr falls by 10x every 10 epochs
NET_WEIGHT_DECAY = 1e-6
EMA_DECAY = 0.95


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("path", type=str)
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--workspace", type=str, default="workspace")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--fp16", action="store_true")
    parser.add_argument("--ff", action="store_true", help="no-op alias")
    parser.add_argument("--tcnn", action="store_true", help="no-op alias")
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--num_samples", type=int, default=2 ** 18)
    parser.add_argument("--mesh_resolution", type=int, default=512)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs on the CPU")
    parser.add_argument("--profile", action="store_true",
                        help="write a profiler trace to workspace/trace")
    return parser


class SDFFitter:
    """The network's params, Adam in two groups with the staircase
    schedule, and the EMA; history keeps each step's loss and each epoch's
    seconds in the host's draws and in all."""

    def __init__(self, params, cfg: SDFConfig, lr: float):
        self.cfg = cfg
        self.params = map_params(
            lambda t: t.detach().float().requires_grad_(True), params)
        self.ema = map_params(lambda t: t.detach().clone(), self.params)
        self.optimizer = torch.optim.Adam(
            [{"params": [self.params["grid"]], "weight_decay": 0.0},
             {"params": param_leaves(self.params["mlp"]),
              "weight_decay": NET_WEIGHT_DECAY}],
            lr=lr, betas=(0.9, 0.99), eps=1e-15)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda k: 0.1 ** (k // LR_DECAY_STEPS))
        self.history = {"loss": [], "draw_s": [], "epoch_s": []}

    def step(self, points, sdfs):
        """One step on points [N, 3] and sdfs [N, 1] on the params' device
        -> the loss, a 0-d device tensor."""
        loss = mape_loss(sdf_forward(self.params, self.cfg, points),
                         sdfs[:, 0])
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.apply_gradients()
        return loss.detach()

    @torch.no_grad()
    def apply_gradients(self):
        """Adam on the leaves' .grad, the schedule, then the EMA."""
        self.optimizer.step()
        self.scheduler.step()
        ema = param_leaves(self.ema)
        torch._foreach_mul_(ema, EMA_DECAY)
        torch._foreach_add_(ema, param_leaves(self.params),
                            alpha=1.0 - EMA_DECAY)

    def fit_epoch(self, dataset) -> float:
        """len(dataset) steps on fresh batches -> their mean loss."""
        dev = self.params["grid"].device
        t0 = time.perf_counter()
        draw_s, losses = 0.0, []
        for _ in range(len(dataset)):
            t1 = time.perf_counter()
            batch = dataset.sample_batch()
            draw_s += time.perf_counter() - t1
            losses.append(self.step(
                torch.from_numpy(batch["points"]).to(dev, non_blocking=True),
                torch.from_numpy(batch["sdfs"]).to(dev, non_blocking=True)))
        losses = torch.stack(losses).tolist()
        self.history["loss"] += losses
        self.history["draw_s"].append(draw_s)
        self.history["epoch_s"].append(time.perf_counter() - t0)
        return float(np.mean(losses))


def export_mesh(params, cfg: SDFConfig, resolution: int, out: str,
                device="cpu"):
    """The surface of -sdf at 0 on a resolution^3 grid of [-1, 1]^3 by
    marching tetrahedra, written as PLY -> (verts, tris, seconds of the
    sweep and of the tetrahedra)."""
    from .utils.meshing import extract_fields, marching_tetrahedra, save_ply
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    bmin, bmax = np.full(3, -1.0), np.full(3, 1.0)
    t0 = time.perf_counter()
    field = extract_fields(bmin, bmax, resolution,
                           lambda pts: -sdf_forward(params, cfg, pts), device)
    t1 = time.perf_counter()
    verts, tris = marching_tetrahedra(field, 0.0, bmin, bmax)
    t2 = time.perf_counter()
    save_ply(out, verts, tris)
    print(f"saved {out} ({len(verts)} verts, {len(tris)} tris; sweep "
          f"{t1 - t0:.2f} s, tetrahedra {t2 - t1:.2f} s)", flush=True)
    return verts, tris, {"sweep": t1 - t0, "tetrahedra": t2 - t1}


def make_sphere_mesh(path, res: int = 24):
    """A sphere of radius 0.55 in [-1, 1]^3 by marching tetrahedra of a
    res^3 grid, written as PLY."""
    from .utils.meshing import load_mesher, save_ply
    g = np.stack(np.meshgrid(*[np.linspace(-1, 1, res)] * 3, indexing="ij"),
                 -1)
    field = (0.55 - np.linalg.norm(g, axis=-1)).astype(np.float32)
    verts, tris = load_mesher().marching_tetrahedra(field, 0.0)
    save_ply(path, verts * (2.0 / (res - 1)) - 1.0, tris)


def main(argv=None):
    """Run the CLI on argv (None: sys.argv) -> (fitter or None with --test,
    the export's (verts, tris, seconds))."""
    opt = build_parser().parse_args(argv)
    refuse_ranks("main_sdf")
    print(opt)
    device = resolve_device(opt.device)
    cfg = SDFConfig()
    params = init_sdf(torch.Generator().manual_seed(opt.seed), cfg, device)
    with profiled(opt, device):
        return _run(opt, cfg, params, device)


def _run(opt, cfg, params, device):
    from .data.sdf_provider import SDFDataset
    out = os.path.join(opt.workspace, "results", "output.ply")
    if opt.test:
        path = resolve_checkpoint(opt.workspace, "sdf", "best")
        if path:
            params = params_from_jax(load_checkpoint(path)[0]["params"],
                                     device)
        with torch.no_grad():
            return None, export_mesh(params, cfg, opt.mesh_resolution, out,
                                     device)
    if opt.path.startswith("synthetic"):
        os.makedirs(opt.workspace, exist_ok=True)
        opt.path = os.path.join(opt.workspace, "synthetic_sphere.ply")
        make_sphere_mesh(opt.path)
    dataset = SDFDataset(opt.path, size=STEPS_PER_EPOCH,
                         num_samples=opt.num_samples)
    fitter = SDFFitter(params, cfg, opt.lr)
    ckpt_dir = os.path.join(opt.workspace, "checkpoints")
    for epoch in range(1, opt.epochs + 1):
        loss = fitter.fit_epoch(dataset)
        print(f"[epoch {epoch}] loss={loss:.6f} "
              f"{fitter.history['epoch_s'][-1]:.1f}s (host draws "
              f"{fitter.history['draw_s'][-1]:.1f}s)", flush=True)
        save_checkpoint(os.path.join(ckpt_dir, f"sdf_ep{epoch:04d}.npz"),
                        {"params": fitter.params, "ema": fitter.ema},
                        {"epoch": epoch})
    with torch.no_grad():
        return fitter, export_mesh(fitter.ema, cfg, opt.mesh_resolution,
                                   out, device)


if __name__ == "__main__":
    main()
