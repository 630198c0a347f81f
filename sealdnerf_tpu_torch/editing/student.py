"""Student distillation trainers: the Seal editing engine (port of
sealdnerf_tpu/editing/student.py).

StudentTrainer (on train/trainer.py's Trainer: the Instant-NGP and D-NeRF
fields, in plain PyTorch) distils an edited teacher into a student field
that starts as a copy of the teacher:
- proxy_dataset: every view of the dataset is rendered through the
  edit-aware teacher; those images are the student's ground truth. For a
  dynamic edit the teacher renders at the pinned time_frame and the views'
  times are replaced by it. The teacher renders as the reference's does:
  render_occ (render/renderer.py: the packed march of the teacher's
  MarchConfig, up to max_steps samples a ray) on its force-filled
  occupancy (the pinned frame's bin), in chunks of max_ray_batch rays with
  a packed budget of eval_samples_per_ray a ray, through the wrapped
  forward, with the teacher's background (--bg_radius > 0).
- init_pretraining: points on a grid in three zones, local (inside the
  edit; ground truth the mapped teacher), surrounding (a shell around the
  edit; the teacher as it is) and global (the box minus the edit), each
  with a direction drawn from a fixed set, and the teacher's sigma and
  colour at them, queried once in chunks of 65,536 points and kept on the
  device.
- pretraining epochs: the weighted L1 of the student's sigma and colour
  against the cached ones, Adam at lr 0.07 over the encoder tables only
  (the towers stay as they are, which keeps the scene from being globally
  disturbed), through the student's forward under autograd.
- then ray distillation on the proxied dataset through the trainer's own
  train(), with the edit region force-filled in the occupancy that the
  student's training rays march (_occ_at).

FastStudentTrainer (StudentTrainer on the CP field's FastTrainer) keeps
what binds it to the CP kernels: the teacher's planar forward (TeacherField:
K1, or K3 for a dynamic teacher), the pretraining step through
field_train_forward or dyn_field_train_forward (K1 and K2, or K3 and K4),
the force-fill of the dense march's occupancy (_segment_occ_fill), and the
coarse-to-fine anneal, which is off: a student distils from a trained
teacher and needs its fine scales from the first step.

The deform tower (and the other time-conditioning networks) of a dynamic
student is frozen throughout: its leaves are in no optimizer the student
builds (optax's set_to_zero in the reference), so they stay the teacher's
bit for bit, and freezing never rebuilds an optimizer that has taken steps.

On a data mesh of N ranks (the teacher's, parallel/mesh.py) every rank
holds the teacher and the whole student state, and the work is split so
that the state stays the same bits on every rank:
- proxy_dataset: rank r renders views r, r + N, ...; the views are
  gathered, so that every rank holds every proxied image with the bits
  that its renderer gave (the reference renders every view on its one
  controller);
- init_pretraining: the zones and their directions are drawn whole on
  every rank (from np.random.default_rng(opt.seed), so they do not depend
  on N); the teacher's queries are split by chunk (chunk i on rank i % N)
  and gathered;
- pretrain_step: each rank takes its 1 / N of the batch's points; the
  weighted L1's denominator is the whole batch's weight sum (every rank
  holds the batch), so the ranks' losses and gradients add up to the
  unsharded step's, and are summed in one collective before Adam. A step
  repeated whole on every rank would not do: the kernels' table gradients
  are summed with atomics, in an order that differs from rank to rank;
- distillation: Trainer's / FastTrainer's sharded step; the edit region is
  forced into the occupancy where it is read (_occ_at, _segment_occ_fill),
  after each refresh's merge of the ranks' queries; the frozen leaves take
  no gradient and stay as they are;
- rank 0 alone writes the provenance, timer.json, pretrain_vis/*.ply and
  the checkpoints; proxy_seconds and query_seconds are each rank's own.
"""

import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..data.rays import get_rays
from ..models.params import param_leaves
from ..ops.field import (dyn_field_forward, dyn_field_forward_plain,
                         dyn_field_train_forward, field_forward,
                         field_forward_plain, field_train_forward)
from ..parallel.mesh import gather_shares, psum, shard_batch, share
from ..render.dynamic_grid import time_slice_index
from ..render.renderer import render_occ
from ..train.fast import FastTrainer
from ..train.trainer import Trainer
from .seal_utils import SealMapper
from .teacher import (TeacherField, force_fill_mask, hack_occ,
                      make_teacher_field)

TEACHER_QUERY_CHUNK = 65536    # points of one teacher point query


def sample_zone_points(bounds, point_step: float, angle_step: int = 45):
    """Points on a grid of spacing point_step inside each AABB of bounds
    [B, 2, 3], and the set of unit directions that euler angles in steps of
    angle_step degrees give."""
    from scipy.spatial.transform import Rotation
    bounds = np.asarray(bounds, dtype=np.float64)
    if bounds.ndim == 2:
        bounds = bounds[None]
    pts = []
    for b in bounds:
        axes = [np.arange(b[0, i], b[1, i], point_step) for i in range(3)]
        if any(len(a) == 0 for a in axes):
            continue
        pts.append(np.stack(np.meshgrid(*axes, indexing="ij"),
                            axis=-1).reshape(-1, 3))
    points = (np.concatenate(pts) if pts
              else np.zeros((0, 3))).astype(np.float32)
    angles = np.arange(0, 360, angle_step)
    rx, ry, rz = np.meshgrid(angles, angles, angles, indexing="ij")
    eulers = np.stack([rx.ravel(), ry.ravel(), rz.ravel()], axis=-1)
    dirs = Rotation.from_euler("xyz", eulers, degrees=True).apply(
        np.array([1 - 1e-5, 0, 0])).astype(np.float32)
    return points, dirs


def pretrain_l1(out, batch, wsum=None):
    """The pretraining loss of field outputs out [4, M] (rows sigma, r, g,
    b) on a zone batch: the weighted L1 of sigma plus that of the colour,
    each over the live points. wsum: the weight sum to divide by (default
    the batch's; a rank's share of a batch divides by the whole batch's)."""
    w = batch["weight"]
    if wsum is None:
        wsum = w.sum()
    l_sig = (torch.abs(out[0] - batch["sigma"]) * w).sum() \
        / torch.clamp(wsum, min=1.0)
    l_col = (torch.abs(out[1:4].t() - batch["color"]) * w[:, None]).sum() \
        / torch.clamp(wsum * 3, min=1.0)
    return l_sig + l_col


def freeze_labels(params):
    """'enc' (the encoder tables, which pretraining trains), 'mlp' (the
    towers) or 'deform' (the deform tower and the other time-conditioning
    networks, frozen during an edit) for every top-level key of `params`."""
    out = {}
    for k in params:
        if "deform" in k or "ambient" in k or \
                (k.startswith("basis") and "grid" not in k):
            out[k] = "deform"
        elif "grid" in k or "lines" in k or "planes" in k:
            out[k] = "enc"
        else:
            out[k] = "mlp"
    return out


class StudentTrainer(Trainer):
    """Distils an edited teacher into the student field.

    teacher_trainer: a trainer holding the original scene (its params and
    occupancy grid are the teacher's); the edit is `mapper`'s. A secondary
    teacher (a field of the teacher's kind) answers the edited samples
    instead.
    """

    def __init__(self, name, opt, field, teacher_trainer: Trainer,
                 mapper: Optional[SealMapper] = None, secondary_teacher=None,
                 time_conditioned: bool = False, **kw):
        self.teacher_trainer = teacher_trainer
        self.secondary_teacher = secondary_teacher
        self.mapper = None
        self.teacher_field = None
        self.fill_mask = None
        super().__init__(name, opt, field, time_conditioned=time_conditioned,
                         **kw)
        if mapper is not None:
            self.init_mapper(mapper)
        self.pretraining_epochs = 0
        self.pretraining_batch_size = 4096
        self.pretraining_lr = 0.07
        self.pretraining_data = {}
        self._pretrain_optimizer = None
        self.time_frame: Optional[float] = None
        self.time_inspector = {"pretraining": [], "training": []}
        self.proxied = {}
        self.proxy_seconds = self.query_seconds = 0.0
        self.query_points = 0

    # ------------------------------------------------------------- setup
    def init_mapper(self, mapper: SealMapper):
        """Wrap the teacher with the mapper and build the occupancy
        force-fill of the teacher's grid shape."""
        tt = self.teacher_trainer
        self.mapper = mapper.to(tt.device)
        self.teacher_field = self._make_teacher_field()
        g = tt.dyn_grid_cfg if tt.time_conditioned else tt.grid_cfg
        self.fill_mask = force_fill_mask(
            self.mapper, g.grid_size, g.cascades, g.bound,
            time_size=g.time_size if tt.time_conditioned else 0,
            device=tt.device)

    def _make_teacher_field(self, plain: bool = False):
        """The edit-aware teacher of teacher_trainer's field (plain: the
        kernels' plain versions, for a field that has kernels)."""
        return make_teacher_field(self.teacher_trainer.field, self.mapper,
                                  secondary=self.secondary_teacher)

    def _occ_at(self, t):
        """Trainer's occupancy of a training ray batch with the edit region
        forced on (the reference's _train_occ), so that distillation rays
        sample geometry that the edit added before the student's own grid
        refresh finds it. The fill is the same in every time bin."""
        occ = super()._occ_at(t)
        if self.fill_mask is None:
            return occ
        return occ | (self.fill_mask[0] if self.time_conditioned
                      else self.fill_mask)

    def _param_groups(self):
        """The trainer's groups without the deform leaves, which are frozen
        (and take no gradient)."""
        frozen = self._deform_leaves()
        for p in frozen:
            p.requires_grad_(False)
        ids = {id(p) for p in frozen}
        groups = super()._param_groups()
        for g in groups:
            g["params"] = [p for p in g["params"] if id(p) not in ids]
        return [g for g in groups if g["params"]]

    def _leaves_labelled(self, label):
        labels = freeze_labels(self.params)
        return [p for k in sorted(self.params) if labels[k] == label
                for p in param_leaves(self.params[k])]

    def _deform_leaves(self):
        return self._leaves_labelled("deform")

    def _enc_leaves(self):
        return self._leaves_labelled("enc")

    def _ensure_deform_frozen(self):
        """Take the deform leaves out of the optimizer if they are in it,
        keeping the other leaves' Adam moments; never rebuilds it."""
        frozen = {id(p) for p in self._deform_leaves()}
        for g in self.optimizer.param_groups:
            keep = [p for p in g["params"] if id(p) not in frozen]
            if len(keep) != len(g["params"]):
                for p in g["params"]:
                    if id(p) in frozen:
                        self.optimizer.state.pop(p, None)
                        p.requires_grad_(False)
                        p.grad = None
                g["params"] = keep

    def _teacher_params(self):
        """The params the teacher answers with: its trained params (not
        the EMA), unannealed, as the reference's teacher field reads them."""
        return self.teacher_trainer.params

    def teacher_occ(self):
        """The teacher's occupancy with the edit region forced on."""
        return hack_occ(self.teacher_trainer.grid_state["occ"],
                        self.fill_mask)

    def _teacher_extra(self, time=None):
        """(extra, occupancy [CAS, H, H, H]): (t,) and the bin of time (None:
        time_frame) for a time-conditioned teacher, else () and the grid."""
        occ = self.teacher_trainer.grid_state["occ"]
        if not self.time_conditioned:
            return (), hack_occ(occ, self.fill_mask)
        t = float(self.time_frame if time is None else time)
        t_idx = time_slice_index(t, self.teacher_trainer.dyn_grid_cfg)
        fill = None if self.fill_mask is None else self.fill_mask[t_idx]
        return (t,), hack_occ(occ[t_idx], fill)

    # ---------------------------------------------------------- proxying
    def _teacher_forward(self, edited: bool, plain: bool):
        """render_occ's forward_fn of the teacher: the wrapped field
        (edited) or the bare one; plain=True through the kernels' plain
        versions, where the field has kernels."""
        tt = self.teacher_trainer
        if not edited:
            return tt.field.forward
        return self._make_teacher_field(plain=True).forward if plain \
            else self.teacher_field.forward

    @torch.no_grad()
    def render_teacher_rays(self, rays_o, rays_d, time=None, chunk=None,
                            edited: bool = True, plain: bool = False):
        """Render a flat ray batch [N, 3] through the teacher -> (image
        [N, 3], depth [N]), as the reference does: render_occ with the
        teacher's MarchConfig and background in chunks of `chunk` rays
        (None: max_ray_batch), each with a packed budget of
        eval_samples_per_ray per ray of a whole chunk (a last, shorter
        chunk keeps it, as the reference's padded chunk does). edited: the
        wrapped forward on the force-filled occupancy, else the bare field
        on the teacher's own; plain=True: through the kernels' plain
        versions. A dynamic teacher renders at `time` (None: time_frame)."""
        tt = self.teacher_trainer
        chunk = chunk or self.opt.max_ray_batch
        extra, occ = self._teacher_extra(time)
        if not edited:
            occ = tt.grid_state["occ"]
            if self.time_conditioned:
                occ = occ[time_slice_index(extra[0], tt.dyn_grid_cfg)]
        fwd = self._teacher_forward(edited, plain)
        bg_fn = getattr(tt.field, "background", None)
        params = self._teacher_params()
        imgs, deps = [], []
        for i in range(0, rays_o.shape[0], chunk):
            res = render_occ(params, occ, rays_o[i:i + chunk],
                             rays_d[i:i + chunk], tt.settings, fwd, bg_fn,
                             m_budget=chunk * self.opt.eval_samples_per_ray,
                             extra=extra)
            imgs.append(res["image"])
            deps.append(res["depth"])
        return (torch.nan_to_num(torch.cat(imgs)),
                torch.nan_to_num(torch.cat(deps)))

    def _teacher_view(self, pose, intrinsics, h: int, w: int, time=None,
                      **kw):
        """One whole view through render_teacher_rays -> (rgb [h * w, 3],
        depth [h * w]) on the device."""
        dev = self.teacher_trainer.device
        rays = get_rays(
            torch.as_tensor(np.asarray(pose, np.float32), device=dev)[None],
            torch.as_tensor(np.asarray(intrinsics, np.float32), device=dev),
            h, w)
        return self.render_teacher_rays(rays["rays_o"][0], rays["rays_d"][0],
                                        time=time, **kw)

    def render_teacher_image(self, pose, intrinsics, h: int, w: int,
                             time=None, edited: bool = True,
                             plain: bool = False):
        """One whole view through render_teacher_rays -> (rgb [h, w, 3],
        depth [h, w]) numpy."""
        img, dep = self._teacher_view(pose, intrinsics, h, w, time=time,
                                      edited=edited, plain=plain)
        return (img.reshape(h, w, 3).cpu().numpy(),
                dep.reshape(h, w).cpu().numpy())

    def proxy_dataset(self, dataset, time=None):
        """The dataset with every view rendered through the edit-aware
        teacher as its images (RGB on white, or on the teacher's
        background); for a dynamic edit rendered at `time` (None:
        time_frame), which replaces the views' times. On a mesh each rank
        renders its share of the views and every rank gets them all."""
        if self.time_conditioned and time is None:
            time = self.time_frame
        n, h, w = len(dataset), dataset.h, dataset.w
        mine = [self._teacher_view(dataset.poses[i], dataset.intrinsics, h,
                                   w, time=time)[0]
                for i in share(self.mesh, n)]
        imgs = gather_shares(self.mesh, mine, n)
        rep = {"images": torch.stack(imgs).reshape(n, h, w, 3).cpu()
               .numpy().astype(np.float32)}
        if time is not None and dataset.times is not None:
            rep["times"] = np.full(len(dataset), float(time), np.float32)
        return dataclasses.replace(dataset, **rep)

    # ------------------------------------------------------- pretraining
    @torch.no_grad()
    def _teacher_query(self, points, dirs, extra, mapped: bool):
        """Teacher sigma [N] and colour [N, 3] at points and dirs (device
        tensors [N, 3]) in chunks of TEACHER_QUERY_CHUNK: through the mapper
        (the local zone's ground truth) or the bare field. On a mesh each
        rank queries its share of the chunks and every rank gets them all."""
        query = self._query_chunk(extra, mapped)
        c = TEACHER_QUERY_CHUNK
        n = -(-points.shape[0] // c)
        mine = [query(points[i * c:(i + 1) * c], dirs[i * c:(i + 1) * c])
                for i in share(self.mesh, n)]
        out = torch.cat(gather_shares(self.mesh, mine, n))
        return out[:, 0], out[:, 1:4]

    def _query_chunk(self, extra, mapped: bool):
        """(points [k, 3], dirs [k, 3]) -> teacher sigma and colour [k, 4]
        through the mapper or the bare field."""
        tt = self.teacher_trainer
        fwd = self.teacher_field.forward if mapped else tt.field.forward
        params = self._teacher_params()

        def query(pts, dirs):
            out = fwd(params, pts, dirs, *extra)
            return torch.cat([out[0][:, None], out[1]], dim=1)
        return query

    def _edit_mask(self, pts):
        """The mapper's mask of the points [N, 3] (device bool [N])."""
        probe = torch.zeros_like(pts)
        probe[:, 0] = 1.0
        return self.mapper.map_to_origin_compact(pts, probe)[2]

    def init_pretraining(self, time_frame: Optional[float] = None, epochs=0,
                         batch_size=4096, lr=0.07,
                         local_point_step=0.001, local_angle_step=45,
                         surrounding_point_step=0.01,
                         surrounding_angle_step=45,
                         surrounding_bounds_extend=0.2,
                         global_point_step=0.05, global_angle_step=45):
        """Cache the teacher's point ground truth of the three zones on the
        device. The directions are drawn from
        np.random.default_rng(opt.seed)."""
        if self.mapper is None:
            raise RuntimeError("init_mapper first")
        self.pretraining_epochs = epochs
        self.pretraining_batch_size = batch_size
        self.pretraining_lr = lr
        self.time_frame = time_frame
        self.query_seconds, self.query_points = 0.0, 0
        if epochs <= 0:
            return
        rng = np.random.default_rng(self.opt.seed)
        md = self.mapper.map_data
        bound = self.opt.bound
        dev = self.teacher_trainer.device
        fill = np.asarray(md["force_fill_bound"].cpu())
        if fill.ndim == 2:
            fill = fill[None]
        extra, _ = self._teacher_extra(time_frame)
        zones = {}

        def grid(bounds, step, angle_step):
            pts, dirs = sample_zone_points(bounds, step, angle_step)
            return torch.as_tensor(pts, device=dev), dirs

        def add(name, pts, dirs, mapped):
            dsel = torch.as_tensor(
                dirs[rng.integers(0, len(dirs), pts.shape[0])], device=dev)
            self._sync()
            t0 = time.perf_counter()
            sig, col = self._teacher_query(pts, dsel, extra, mapped)
            self._sync()
            self.query_seconds += time.perf_counter() - t0
            self.query_points += pts.shape[0]
            zones[name] = (pts, dsel, sig, col)

        t0 = time.perf_counter()
        if local_point_step > 0:
            pts, dirs = grid(fill, local_point_step, local_angle_step)
            if pts.shape[0] and "map_source" not in md:
                pts = pts[self._edit_mask(pts)]
            if pts.shape[0]:
                add("local", pts, dirs, mapped=True)
        self.log(f"Local x generation: {time.perf_counter() - t0:.2f}s")
        t0 = time.perf_counter()
        if surrounding_point_step > 0:
            sb = fill.copy()
            sb[:, 0] = np.maximum(sb[:, 0] - surrounding_bounds_extend, -bound)
            sb[:, 1] = np.minimum(sb[:, 1] + surrounding_bounds_extend, bound)
            pts, dirs = grid(sb, surrounding_point_step,
                             surrounding_angle_step)
            if pts.shape[0]:
                pts = pts[~self._edit_mask(pts)]
            if pts.shape[0]:
                add("surrounding", pts, dirs, mapped=False)
        self.log(f"Surrounding x generation: {time.perf_counter() - t0:.2f}s")
        t0 = time.perf_counter()
        if global_point_step > 0:
            gb = np.array([[-bound] * 3, [bound] * 3], dtype=np.float32)
            pts, dirs = grid(gb[None], global_point_step, global_angle_step)
            if pts.shape[0]:
                pts = pts[~self._edit_mask(pts)]
            if pts.shape[0]:
                add("global", pts, dirs, mapped=False)
        self.log(f"Global x generation: {time.perf_counter() - t0:.2f}s")

        # each zone padded to whole batches (weight 0), on the student's
        # device
        self.pretraining_data = {}
        for k, (pts, dirs, sig, col) in zones.items():
            n = pts.shape[0]
            pad = (-n) % batch_size
            w = torch.cat([torch.ones(n, device=dev),
                           torch.zeros(pad, device=dev)])
            d_pad = torch.zeros((pad, 3), device=dev)
            d_pad[:, 0] = 1.0

            def put(a, tail, *shape):
                return torch.cat([a, tail]).reshape(
                    -1, batch_size, *shape).to(self.device)
            self.pretraining_data[k] = {
                "points": put(pts, torch.zeros((pad, 3), device=dev), 3),
                "dirs": put(dirs, d_pad, 3),
                "sigma": put(sig, torch.zeros(pad, device=dev)),
                "color": put(col, torch.zeros((pad, 3), device=dev), 3),
                "weight": put(w, w[:0])}
        self._build_pretrain_optimizer()
        if not self._writes():
            return
        vis = os.path.join(self.workspace, "pretrain_vis")
        os.makedirs(vis, exist_ok=True)
        for k, v in zones.items():
            _export_ply_points(os.path.join(vis, f"{k}.ply"),
                               v[0].cpu().numpy(), v[3].cpu().numpy())

    def _build_pretrain_optimizer(self):
        """Adam (betas 0.9/0.99, eps 1e-15) at the constant pretraining lr
        over the encoder leaves: the towers and the deform tower are
        frozen."""
        self._pretrain_optimizer = torch.optim.Adam(
            self._enc_leaves(), lr=self.pretraining_lr, betas=(0.9, 0.99),
            eps=1e-15)

    def pretrain_loss(self, batch, wsum=None):
        """pretrain_l1 of the student's forward at the batch's points, at
        time_frame for a time-conditioned field (wsum: see pretrain_l1)."""
        extra = (float(self.time_frame or 0.0),) if self.time_conditioned \
            else ()
        out = self.field.forward(self.params, batch["points"], batch["dirs"],
                                 *extra)
        return pretrain_l1(torch.cat([out[0][None], out[1].t()]), batch,
                           wsum)

    def pretrain_step(self, batch):
        """One Adam step of the encoder leaves on one batch -> loss (a
        device tensor). A table that the forward does not read (the
        background's) takes a zero gradient, as in the reference. On a mesh
        each rank takes its share of the points, divided by the whole
        batch's weight sum, and the ranks' losses and gradients are summed
        in one collective: the unsharded step's."""
        leaves = self._enc_leaves()
        wsum = None
        if self.ndev > 1:
            wsum = batch["weight"].sum()
            batch = {k: shard_batch(self.mesh, v) for k, v in batch.items()}
        loss = self.pretrain_loss(batch, wsum)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        if self.ndev > 1:
            flat = psum(self.mesh, torch.cat(
                [g.reshape(-1) for g in grads] + [loss.detach().reshape(1)]))
            grads = list(torch.split(flat[:-1], [g.numel() for g in grads]))
            loss = flat[-1]
        for p, g in zip(leaves, grads):
            p.grad = g.view_as(p)
        self._pretrain_optimizer.step()
        for p in leaves:
            p.grad = None
        return loss.detach()

    def pretrain_one_epoch(self):
        """One pass over every zone's batches; the EMA once at its end ->
        mean loss."""
        losses = []
        for zone in self.pretraining_data.values():
            for i in range(zone["points"].shape[0]):
                losses.append(self.pretrain_step(
                    {k: v[i] for k, v in zone.items()}))
                self.global_step += 1
        self._ema_update()
        return float(torch.stack(losses).mean()) if losses else 0.0

    # ---------------------------------------------------------- training
    def train(self, train_dataset, valid_dataset=None, max_epochs: int = 1,
              time_frame: Optional[float] = None):
        """Proxy the datasets, pretraining epochs, then ray distillation for
        the remaining epochs (the trainer's train(), which stops at
        opt.iters steps counted with the pretraining's). The proxied
        datasets are kept as self.proxied["train"] and ["valid"]."""
        if time_frame is not None:
            self.time_frame = time_frame
        self._ensure_deform_frozen()
        self._write_provenance()
        self._sync()
        t0 = time.perf_counter()
        train_ds = self.proxy_dataset(train_dataset)
        valid_ds = (self.proxy_dataset(valid_dataset)
                    if valid_dataset is not None else None)
        self._sync()
        self.proxy_seconds = time.perf_counter() - t0
        self.proxied = {"train": train_ds, "valid": valid_ds}
        self.log(f"proxy_dataset: {self.proxy_seconds:.2f}s")
        for _ in range(self.pretraining_epochs):
            self.epoch += 1
            self._sync()
            t0 = time.perf_counter()
            loss = self.pretrain_one_epoch()
            self._sync()
            self.time_inspector["pretraining"].append(time.perf_counter() - t0)
            self.log(f"[pretrain epoch {self.epoch}] loss={loss:.5f} "
                     f"{self.time_inspector['pretraining'][-1]:.2f}s")
        t0 = time.perf_counter()
        remaining = max_epochs - self.pretraining_epochs
        if remaining > 0:
            super().train(train_ds, valid_ds, remaining)
        self.time_inspector["training"].append(time.perf_counter() - t0)
        self._write_timer()

    # -------------------------------------------------------- provenance
    def _write_provenance(self):
        """seal.json, options.json and run.sh in the workspace (rank 0)."""
        if not self._writes():
            return
        os.makedirs(self.workspace, exist_ok=True)
        try:
            if self.mapper is not None:
                with open(os.path.join(self.workspace, "seal.json"), "w") as f:
                    json.dump(self.mapper.config, f, indent=2, default=str)
            with open(os.path.join(self.workspace, "options.json"), "w") as f:
                json.dump({k: str(v) for k, v in vars(self.opt).items()}, f,
                          indent=2)
            with open(os.path.join(self.workspace, "run.sh"), "w") as f:
                f.write(f"python {' '.join(sys.argv)}\n")
        except OSError:
            pass

    def _write_timer(self):
        """timer.json in the workspace (rank 0)."""
        if not self._writes():
            return
        ti = self.time_inspector
        out = {}
        for k in ("pretraining", "training"):
            out[k] = ti[k]
            out[f"{k}_avg"] = float(np.mean(ti[k])) if ti[k] else 0.0
            out[f"{k}_total"] = float(np.sum(ti[k]))
        with open(os.path.join(self.workspace, "timer.json"), "w") as f:
            json.dump(out, f, indent=2)


class FastStudentTrainer(StudentTrainer, FastTrainer):
    """StudentTrainer on the CP field's FastTrainer: the teacher and the
    pretraining step through the CP kernels, the edit region force-filled
    in the dense march's occupancy. teacher_trainer is a FastTrainer; a
    secondary teacher is a CPField."""

    def init_mapper(self, mapper: SealMapper):
        super().init_mapper(mapper)
        if self._occ_m is not None:
            self._occ_m = self._march_occ()

    def _make_teacher_field(self, plain: bool = False):
        return TeacherField(self.teacher_trainer.field, self.mapper,
                            secondary=self.secondary_teacher,
                            time_conditioned=self.time_conditioned,
                            plain=plain)

    def _segment_occ_fill(self):
        return self.fill_mask

    def _build_anneal_mask(self):
        # the anneal is for training from scratch; a student distils from a
        # trained teacher and keeps its fine scales live from the first step
        return None

    def _teacher_forward(self, edited: bool, plain: bool):
        """The wrapped field (edited) or the bare one, through the kernels
        or (plain=True) their plain versions."""
        if edited:
            return super()._teacher_forward(edited, plain)
        tt = self.teacher_trainer
        fn = ((dyn_field_forward_plain if plain else dyn_field_forward)
              if self.time_conditioned else
              (field_forward_plain if plain else field_forward))

        def bare(params, x, d, *extra):
            out = fn(tt.field.kernel_tables(params), tt.field.cfg,
                     x.t().contiguous(), d.t().contiguous(), *extra)
            return out[0], out[1:4].t()
        return bare

    def _query_chunk(self, extra, mapped: bool):
        """StudentTrainer's query chunk through the planar forward of the
        kernels: K1, or K3 for a dynamic teacher."""
        tt = self.teacher_trainer
        params = self._teacher_params()
        fwd = self.teacher_field.forward_planar if mapped \
            else tt._render_forward()
        if not mapped:
            params = tt.field.kernel_tables(params)

        def query(pts, dirs):
            out = fwd(params, pts.t().contiguous(), dirs.t().contiguous(),
                      *extra)
            return out[:4].t()
        return query

    def pretrain_loss(self, batch, wsum=None):
        """pretrain_l1 of the student at the batch's points, at time_frame
        for a time-conditioned field, through the field's kernels: K1 and
        K2, or K3 and K4."""
        x3 = batch["points"].t().contiguous()
        d3 = batch["dirs"].t().contiguous()
        cfg = self.field.cfg
        tables = self.field.kernel_tables(self.params)
        if self.time_conditioned:
            out = dyn_field_train_forward(self.params, cfg, x3, d3,
                                          float(self.time_frame or 0.0),
                                          tables=tables)
        else:
            out = field_train_forward(self.params, cfg, x3, d3,
                                      tables=tables)
        return pretrain_l1(out, batch, wsum)


def _export_ply_points(path, pts, colors):
    """Binary little-endian PLY of points with u8 colours."""
    try:
        with open(path, "wb") as f:
            f.write(b"ply\nformat binary_little_endian 1.0\n")
            f.write(f"element vertex {len(pts)}\n".encode())
            f.write(b"property float x\nproperty float y\nproperty float z\n")
            f.write(b"property uchar red\nproperty uchar green\n"
                    b"property uchar blue\nend_header\n")
            buf = np.zeros(len(pts), dtype=[("xyz", "<f4", 3),
                                            ("rgb", "u1", 3)])
            buf["xyz"] = np.asarray(pts, dtype=np.float32)
            buf["rgb"] = np.clip(np.asarray(colors) * 255, 0, 255).astype(
                np.uint8)
            f.write(buf.tobytes())
    except OSError:
        pass
