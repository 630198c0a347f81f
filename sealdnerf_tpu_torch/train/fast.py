"""FastTrainer for the CP field (port of sealdnerf_tpu/train/fast.py):
training and serving of the static field and of the time-conditioned one,
on Trainer's host loop (train/trainer.py: epochs, evaluate and test,
checkpoints, the optimizer and the EMA), as the reference's FastTrainer
subclasses its Trainer. It also takes the static Instant-NGP field without
its background sphere (models/api.py's NGPField with bg_radius <= 0;
below).

Training: a plain per-step loop (the reference's fori_loop segments only
amortised host-device transfers). One step refreshes the occupancy grid
every `update_extra_interval` steps (K1 density-only on the current
params), draws one image and `num_rays` random pixels on the device, a
random background per ray for RGBA images and per-ray march noise, renders
through `render_dense` with the field's forward K1 and backward K2
(ops/field.py), and applies Adam, the lr schedule and the EMA. All draws
come from the trainer's one device generator, seeded from `opt.seed`.

Static fields train and serve at any bound and dt_gamma: cascades > 1 or
dt_gamma > 0 march through the cascade march (ops/marching_dense.py), on the
occupancy of every cascade.

Serving: occupancy-grid rebuild and whole-frame rendering. render_image
takes the bucketed renderer with the termination trim
(render/fast_image.py) while the occupied share of the grid is below 15 %,
as a trained field's is, else
the tiled one; the share is read from the device once per grid version, at
the first frame after the grid changed. Unlike the reference, a bucketed
eval frame subsamples no tile (the bucket ladder's shares group the tiles,
each bucket gets the budget of its fullest tile: the ladder's divisors
become floors), so that evaluation reads the field and not the ladder.
test_gui renders the LOD preview (the finest line scales skipped, a harsher
bucket ladder that may subsample a tile 2x) when the caller needs no depth.
On CPU tensors the field runs through the kernels' plain versions.

Time-conditioned fields (time_conditioned=True, a CPDNeRFConfig) use the
[T, CAS, H^3] grid of render/dynamic_grid.py and the dynamic kernels: K3
forward, K4 backward. A training step of one differs from the static step
in this:
- the grid refresh covers bins_per_call of the T time bins per call, so it
  may fire every update_extra_interval * bins_per_call / T steps: at every
  such step while warming up (the first 16 passes over all bins, on the
  deterministic half-grid slabs), at every other one after that, and never
  once the call count reaches `_dyn_freeze_calls`. grid_state["iter_density"]
  counts these calls. The refresh queries the current params, annealed;
- the image comes from a window of the time-sorted frames that grows to the
  full range over `time_curriculum_steps` steps, its time t stays on the
  device, and the step marches the occupancy of t's bin;
- coarse-to-fine: the first sigma matrix's rows of scales and planes with
  res > dyn_anneal_res are scaled by clip(step / dyn_anneal_steps, 0, 1)
  inside the differentiated function, so their gradient carries the same
  ramp; `_infer_params` applies it to the EMA params for rendering;
- `deform_zero_reg * mean(deform_raw(x, 0)^2)` at 1024 random scene points
  is added to the loss (plain PyTorch under autograd, as the reference
  computes it outside its kernels);
- with `lr_net` the MLP towers train at that rate and the tables at `lr`,
  as two Adam groups under one schedule.

Editing hooks (overridden by editing/student.py's FastStudentTrainer):
`_segment_occ_fill` (a bool mask ORed into the occupancy wherever it is
brought to march resolution: the grid refresh, the start of train() and
render_image), `_param_groups` (the leaves that the optimizer steps and their
rates) and `adopt_grid_state` (a grid state taken over from another trainer).

The main CLIs' training options (Trainer's sampling and loss): the error
map and its update, p x p patches with the patch term, and, unlike Trainer,
host-resident images (preload=False): the images stay in pinned host memory,
and each step gathers only its drawn pixels there and copies them
asynchronously (patches are refused there, as in the reference); the draws
are those of a preloaded run of the same seed. train_gui runs steps for the
GUI. Time-conditioned fields serve and train at bound <= 1 only, as in the
reference.

The Instant-NGP field runs on the same march, grid and renderers: its
frames, the trim's taps and the grid's density queries through K5
(ops/field.py:hash_field_forward), its training steps through the plain
field under autograd (models/ngp.py: grid_encode's gather and index_add
backward; no backward kernel yet), with the hash table's TV term when
tv_weight > 0 at the points Trainer draws. What only the CP field has is
skipped: the coarse-to-fine ramp, the LOD preview's skipped line scales
(the preview renders the full field on its ladder) and the checkpoint's
shapes read back by config_from_params (a checkpoint's params are checked
against the field, as Trainer checks them).

On a mesh of N ranks (Trainer's data parallelism) a step is Trainer's: each
rank draws num_rays / N rays and its deform-regulariser points from its own
stream, and the gradients and the loss are averaged before Adam. The grid
refresh is sharded as the reference's: each rank queries its 1/N of the
refresh's cells (its part of the warm-up slab, or cells from its own
stream; a dynamic bin at a time from the stream that is the same on every
rank), and the ranks' queries are merged with pmax before the decay, so
that grid, occupancy and bin sums are the same bits on every rank. Frames
render by row bands (render/fast_image.py:make_sharded_image_renderer)
where the frame's rows split into N bands of whole tiles, else whole on
every rank.
"""

from typing import Optional

import numpy as np
import torch

from ..models.api import NGPField
from ..models.cp import CPConfig, CPDNeRFConfig, config_from_params
from ..models.params import params_version
from ..ops.field import (dyn_field_forward, dyn_field_train_forward,
                         field_forward, field_train_forward,
                         hash_field_forward)
from ..ops.freq_encode import freq_output_dim
from ..ops.marching_dense import DenseMarchConfig, downsample_occ
from ..render.fast import render_dense
from ..render.dynamic_grid import (rebuild_dyn_density_grid,
                                   refresh_dyn_density_grid,
                                   time_slice_index)
from ..render.fast_image import (make_sharded_image_renderer,
                                 render_image_bucketed, render_image_tiled)
from ..render.grid import refresh_indices, update_density_grid
from ..utils import profiling
from .trainer import GUI_DOWNSCALES, Trainer, cascades_for

N_ZERO_REG = 1024      # points of the deform regulariser per step
BUCKET_OCC = 0.15      # occupied share of the grid below which frames bucket


def reference_tile(rh: int, rw: int, tile_px: int) -> int:
    """The reference's march-tile pick for an rh x rw frame: tile_px (8),
    10 at >= 800 px when the size divides, 1 (per-ray) when the size does
    not divide."""
    if (tile_px == 8 and min(rh, rw) >= 800 and rh % 10 == 0
            and rw % 10 == 0):
        return 10
    if rh % tile_px or rw % tile_px:
        return 1
    return tile_px


def tile_fits(tile_px: int, pose, intrinsics, cfg: DenseMarchConfig,
              dilate: int) -> bool:
    """Whether tile_px x tile_px tiles are conservative at this camera: the
    tiled renderers march one ray a tile on an occupancy dilated by
    `dilate` march voxels, which covers the tile's pixel rays while the
    tile's footprint stays within the dilation. The footprint is the
    angle from the tile's center to its farthest pixel center, (tile_px -
    1) / 2 pixels in x and y over the focal lengths, times the distance
    from the camera to the farthest corner of the box; it must stay within
    `dilate` voxels of every cascade, each at its own box. The reference's
    pick assumes this of 10-px tiles at >= 800 px; a wider field of view or
    a camera farther out breaks it (C6)."""
    fx, fy = float(intrinsics[0]), float(intrinsics[1])
    half = 0.5 * (tile_px - 1)
    angle = half * np.sqrt(1.0 / fx ** 2 + 1.0 / fy ** 2)
    o = np.asarray(pose, np.float64)[:3, 3]
    boxes = ([(cfg.cas_bound(c), cfg.vox(c)) for c in range(cfg.cascades)]
             if cfg.multi else [(cfg.bound, cfg.voxel)])
    for b, vox in boxes:
        far = np.sqrt(np.sum((np.abs(o) + b) ** 2))
        if far * angle > dilate * vox:
            return False
    return True


class FastTrainer(Trainer):
    """The CP and Instant-NGP fields' trainer: Trainer's host loop (train,
    evaluate, test, checkpoints, the optimizer and the EMA) around the dense
    march and the kernels."""

    def _check_field(self, field, opt, time_conditioned: bool):
        if isinstance(field, NGPField):
            if time_conditioned:
                raise ValueError("the Instant-NGP field is static")
            if field.cfg.bg_radius > 0:
                raise NotImplementedError(
                    "FastTrainer takes the Instant-NGP field without its "
                    "background sphere (bg_radius <= 0); Trainer takes it "
                    "with one")
            return
        if not isinstance(field.cfg, CPConfig):
            raise NotImplementedError("FastTrainer takes the CP field and "
                                      "the Instant-NGP field")
        if time_conditioned != isinstance(field.cfg, CPDNeRFConfig):
            raise ValueError("time_conditioned goes with a CPDNeRFConfig "
                             "field, and only with one")
        if time_conditioned and opt.bound > 1.0:
            # the dynamic grid is single-cascade (D-NeRF recipes use bound 1)
            raise ValueError("the dynamic fast path serves bound <= 1 "
                             f"recipes (got bound={opt.bound})")

    def _configure(self):
        opt = self.opt
        self._hash = isinstance(self.field, NGPField)
        cascades = cascades_for(opt.bound)
        # the kept-interval budget grows with the cascades: each cascade's
        # band of geometry takes its own slots (the reference measured 12
        # dB at bound 2 with 16 and 25.6 dB with 32)
        ni = opt.n_intervals * cascades
        self.march_cfg = DenseMarchConfig(
            bound=opt.bound, march_res=opt.march_res, n_intervals=ni,
            steps_per_interval=opt.steps_per_interval, min_near=opt.min_near,
            cascades=cascades, dt_gamma=opt.dt_gamma)
        self.render_cfg = DenseMarchConfig(
            bound=opt.bound,
            march_res=opt.render_march_res or opt.march_res,
            n_intervals=opt.render_n_intervals or 2 * ni,
            steps_per_interval=(opt.render_steps_per_interval
                                or opt.steps_per_interval),
            min_near=opt.min_near, cascades=cascades, dt_gamma=opt.dt_gamma)
        self._occ_m = None
        self._time_sorted = False   # train() sorted the frames by time
        self._anneal_mask = self._build_anneal_mask()
        self._infer_cache = None    # (key, annealed inference params)

    def _adopt_params(self, params, path: str):
        if self._hash:
            super()._adopt_params(params, path)
            return
        cfg = config_from_params(params, self.field.cfg)
        if isinstance(cfg, CPDNeRFConfig) != self.time_conditioned:
            raise ValueError(
                f"{path} holds a "
                f"{'time-conditioned' if isinstance(cfg, CPDNeRFConfig) else 'static'}"
                " field, which this trainer does not serve")
        self.field.cfg = cfg
        self._anneal_mask = self._build_anneal_mask()

    @property
    def grid_state(self):
        return self._grid_state

    @grid_state.setter
    def grid_state(self, state):
        # a new grid: its occupied share (_use_buckets) is read again at the
        # next frame
        self._grid_state = state
        self._occ_frac = None

    def _infer_params(self):
        """The EMA params (the params when there are none); of a dynamic
        field annealed at the current step, so that frames show the function
        that was trained. One annealed copy is kept per params version and
        step, so that the frames of an evaluation share its packed tables."""
        params = self.ema_params if self.ema_params is not None \
            else self.params
        if self._anneal_mask is None:
            return params
        key = (params_version(params), self.global_step)
        if self._infer_cache is None or self._infer_cache[0] != key:
            with torch.no_grad():
                self._infer_cache = (
                    key, self._anneal_params(params, self.global_step))
        return self._infer_cache[1]

    # ------------------------------------------ coarse-to-fine (dynamic)
    def _build_anneal_mask(self):
        """Bool [feat_dim] over the rows of the first sigma matrix: True
        where the feature comes from a line scale or a plane with res >
        opt.dyn_anneal_res. None for a static field, with annealing off, or
        when no row is that fine."""
        if not self.time_conditioned or self.opt.dyn_anneal_steps <= 0:
            return None
        cfg = self.field.cfg
        rows = []
        for res, rank in cfg.scales:
            rows += [res > self.opt.dyn_anneal_res] * rank
        for pres, ch in cfg.planes:
            rows += [pres > self.opt.dyn_anneal_res] * (3 * ch)
        rows += [False] * freq_output_dim(3, cfg.freq_degree)
        if not any(rows):
            return None
        return torch.tensor(rows, dtype=torch.bool, device=self.device)

    def _anneal_ramp(self, step: int) -> float:
        """clip(step / dyn_anneal_steps, 0, 1), divided in f32 as the
        reference does."""
        return float(np.clip(np.float32(step)
                             / np.float32(self.opt.dyn_anneal_steps), 0, 1))

    def _anneal_params(self, params, step: int):
        """`params` with the fine rows of the first sigma matrix scaled by
        the ramp at `step` (a host integer). A parameter transform: scaling
        a feature equals scaling its row of the matrix, so the kernels see
        an ordinary matrix, and autograd through the multiply scales the
        row's gradient by the same ramp. At ramp 1 `params` itself comes
        back."""
        ramp = self._anneal_ramp(step) if self._anneal_mask is not None \
            else 1.0
        if ramp >= 1.0:
            return params
        colw = torch.where(self._anneal_mask, ramp, 1.0)[:, None]
        w = params["sigma_mlp"]["w"]
        out = dict(params)
        out["sigma_mlp"] = {**params["sigma_mlp"],
                            "w": [w[0] * colw] + list(w[1:])}
        return out

    def _density_fn(self, params):
        """The grid's density query on `params`: (pts [N, 3]) -> sigma [N],
        with a second argument t for a time-conditioned field."""
        tables = self.field.kernel_tables(params)
        cfg = self.field.cfg

        if self._hash:
            return lambda pts: hash_field_forward(
                tables, cfg, pts.t().contiguous(), None,
                density_only=True)[0]
        if self.time_conditioned:
            return lambda pts, t: dyn_field_forward(
                tables, cfg, pts.t().contiguous(), None, t,
                density_only=True)[0]
        return lambda pts: field_forward(tables, cfg, pts.t().contiguous(),
                                         None, density_only=True)[0]

    def _render_forward(self, lod: bool = False):
        """The renderers' forward_fn: (tables, x3, d3[, t]) -> out. lod=True:
        the LOD preview's, which skips the line scales with res >=
        opt.preview_lod_min_res inside the kernel (the Instant-NGP field
        has no line scales: its preview reads the full field)."""
        cfg = self.field.cfg
        if self._hash:
            return lambda tabs, x3, d3: hash_field_forward(tabs, cfg, x3, d3)
        skip = ()
        if lod and self.opt.preview_lod_min_res > 0:
            skip = tuple(s for s, (res, _) in enumerate(cfg.scales)
                         if res >= self.opt.preview_lod_min_res)
        if self.time_conditioned:
            return lambda tabs, x3, d3, t: dyn_field_forward(
                tabs, cfg, x3, d3, t, lod_skip=skip)
        return lambda tabs, x3, d3: field_forward(tabs, cfg, x3, d3,
                                                  lod_skip=skip)

    # ------------------------------------------------------------- grid
    def _segment_occ_fill(self):
        """A bool mask ORed into the occupancy wherever it is brought to
        march resolution, shaped like grid_state["occ"] (None: none). The
        editing student's force-fill of its edit region."""
        return None

    def _occ_of(self, occ, t_idx=None):
        """occ ORed with `_segment_occ_fill` (of time bin t_idx when occ is
        one bin of a time-conditioned grid)."""
        fill = self._segment_occ_fill()
        if fill is None:
            return occ
        return occ | (fill if t_idx is None else fill[t_idx])

    def _march_occ(self):
        """The training march's occupancy at march resolution: [T, M, M, M]
        for a time-conditioned grid, [CAS, M, M, M] for a static one whose
        march is the cascade march, else [M, M, M]."""
        occ = self._occ_of(self.grid_state["occ"])
        if self.time_conditioned:
            return downsample_occ(occ[:, 0], self.march_cfg.march_res)
        return self.cascade_occ(occ, self.march_cfg)

    @staticmethod
    def cascade_occ(occ, cfg: DenseMarchConfig):
        """A [CAS, H, H, H] occupancy at cfg's march resolution, as cfg's
        march takes it: every cascade for the cascade march, else the
        first."""
        return downsample_occ(occ if cfg.multi else occ[0], cfg.march_res)

    def adopt_grid_state(self, grid_state):
        """Take over a copy of another trainer's grid state of the same kind
        (the editing student starts from its teacher's): the host copies of
        the dynamic grid's counters are dropped and the march occupancy is
        recomputed, with the fill."""
        super().adopt_grid_state(grid_state)
        self._occ_m = self._march_occ()

    def _use_buckets(self) -> bool:
        """Whether frames take the bucketed renderer: while the mean of
        grid_state["occ"] over all its cells is below 15 %. A broadly filled
        grid (early training, a seeded field) gives tiles more intervals
        than the cheap buckets hold; the tiled renderer takes those. The
        mean is read from the device once per grid version (replacing
        grid_state forgets it), so that training steps never wait for it."""
        if self._occ_frac is None:
            self._occ_frac = float(profiling.fetch(
                self.grid_state["occ"].float().mean()))
        return self._occ_frac < BUCKET_OCC

    def _dyn_host_counts(self):
        """(refresh calls so far, next bin): host copies of the grid state's
        iter_density and bin_cursor, read from the device once and then kept
        in step, so that a training step does not wait for the device."""
        if self._dyn_calls is None:
            self._dyn_calls = int(profiling.fetch(
                self.grid_state["iter_density"]))
            self._dyn_cursor = int(profiling.fetch(
                self.grid_state["bin_cursor"]))
        return self._dyn_calls, self._dyn_cursor

    def _segment_update_interval(self) -> int:
        """Steps between refresh opportunities. A dynamic refresh call covers
        bins_per_call of time_size bins, so the interval shrinks in that
        proportion (16 * 8 / 64 = 2 by default)."""
        upd = self.opt.update_extra_interval
        if self.time_conditioned:
            d = self.dyn_grid_cfg
            upd = max(1, int(round(upd * d.bins_per_call / d.time_size)))
        return upd

    def _warmup_calls(self) -> int:
        """Refresh calls that sweep the deterministic half-grid slabs: 16
        passes over all bins for the dynamic grid (two visits of a bin sweep
        it once, so 8 full sweeps); 32 calls for the static one."""
        if self.time_conditioned:
            d = self.dyn_grid_cfg
            return 16 * -(-d.time_size // d.bins_per_call)
        return 32

    def _dyn_freeze_calls(self, upd: int) -> int:
        """The refresh-call count at which the dynamic grid freezes, set so
        that it falls on step 16 * freeze_after (1600), plus the length of
        the time curriculum: the late frames only enter training then, and
        an earlier freeze would lock their bins half trained. After the
        warm-up a call fires every 2 * upd steps. Defaults: 128 warm-up calls
        over 256 steps, then (1600 + 512 - 256) / 4 = 464 -> 592."""
        wc = self._warmup_calls()
        horizon = 16 * self.dyn_grid_cfg.freeze_after \
            + max(self.opt.time_curriculum_steps, 0)
        return wc + max(0, horizon - wc * upd) // (2 * upd)

    def dyn_refresh_due(self, step: int, calls: int) -> bool:
        """Whether the dynamic grid is refreshed before training step `step`
        after `calls` refresh calls (the reference's in-loop predicate)."""
        upd = self._segment_update_interval()
        if step % upd != 0 or calls >= self._dyn_freeze_calls(upd):
            return False
        return calls < self._warmup_calls() or step % (2 * upd) == 0

    @torch.no_grad()
    def refresh_grid(self, params=None):
        """One in-loop grid refresh of training, queried on the current
        params (not the EMA), then the march-resolution occupancy; sharded
        over the mesh's ranks. Static: the warm-up slab or the random cells
        (render.grid.refresh_indices).
        Dynamic: the next bins_per_call time bins
        (render.dynamic_grid.refresh_dyn_density_grid) on `params` (None: the
        current params annealed at the current step)."""
        with profiling.span("grid.refresh"):
            if self.time_conditioned:
                if params is None:
                    params = self._anneal_params(self.params,
                                                 self.global_step)
                calls, cursor = self._dyn_host_counts()
                dcfg = self.dyn_grid_cfg
                self.grid_state, self._dyn_bin_sums = \
                    refresh_dyn_density_grid(
                        self.grid_state, self._density_fn(params), dcfg,
                        self._warmup_calls(), generator=self.rank_generator,
                        bin_sums=self._dyn_bin_sums, calls=calls,
                        cursor=cursor, time_generator=self.generator,
                        mesh=self.mesh)
                self._dyn_calls = calls + 1
                self._dyn_cursor = (cursor + min(
                    dcfg.bins_per_call, dcfg.time_size)) % dcfg.time_size
                self._occ_m = self._march_occ()
                return
            calls = int(profiling.fetch(self.grid_state["iter_density"]))
            idx = refresh_indices(calls, self.grid_cfg, self.rank_generator,
                                  self.device, self.mesh.rank, self.ndev)
            self.grid_state = update_density_grid(
                self.grid_state, self._density_fn(self.params),
                self.grid_cfg, indices=idx, generator=self.rank_generator,
                mesh=self.mesh)
            self._occ_m = self._march_occ()

    @torch.no_grad()
    def rebuild_grid(self):
        """Full-sweep occupancy rebuild from the inference params; of a
        time-conditioned grid, of every time bin."""
        with profiling.span("grid.rebuild"):
            if self.time_conditioned:
                # iter_density counts training's refresh calls (see
                # render/dynamic_grid.py): a rebuild does not move it
                calls = self.grid_state["iter_density"].clone()
                self.grid_state = rebuild_dyn_density_grid(
                    self.grid_state, self._density_fn(self._infer_params()),
                    self.dyn_grid_cfg, generator=self.generator)
                self.grid_state["iter_density"] = calls
                self._forget_dyn_host_state()
                return
            self.grid_state = update_density_grid(
                self.grid_state, self._density_fn(self._infer_params()),
                self.grid_cfg, full=True, generator=self.generator)

    # --------------------------------------------------------- training
    def _train_forward(self, params, x, d, *t, plain=False):
        """render_dense's forward_fn: K1 forward and K2 backward, or with a
        time t K3 and K4 (or their plain versions); the Instant-NGP field's
        plain forward under autograd."""
        if self._hash:
            return self.field.forward(params, x, d)
        x3, d3 = x.t().contiguous(), d.t().contiguous()
        tables = self.field.kernel_tables(params)
        if t:
            out = dyn_field_train_forward(params, self.field.cfg, x3, d3,
                                          t[0], tables=tables, plain=plain)
        else:
            out = field_train_forward(params, self.field.cfg, x3, d3,
                                      tables=tables, plain=plain)
        return out[0], out[1:4].t()

    def n_allowed_images(self, step: int, n_images: int) -> int:
        """How many of the time-sorted frames step `step` may draw from:
        clip(ceil(step / time_curriculum_steps * n) + 1, 1, n) while the
        curriculum runs, else all of them."""
        cur = self.opt.time_curriculum_steps
        if not (self.time_conditioned and cur > 0 and self._time_sorted):
            return n_images
        frac = np.clip(np.float32(step) / np.float32(cur), 0.0, 1.0)
        return int(np.clip(int(np.ceil(frac * np.float32(n_images))) + 1, 1,
                           n_images))

    def sample_batch(self, data, h: int, w: int):
        """Trainer.sample_batch's draws, and for a time-conditioned field
        after them the points x_reg [1024, 3] of the deform regulariser."""
        batch = super().sample_batch(data, h, w)
        if not self.time_conditioned:
            return batch
        b = self.opt.bound
        x_reg = (torch.rand((N_ZERO_REG, 3), generator=self.rank_generator,
                            device=self.device) * 2.0 - 1.0) * b
        return batch + (x_reg,)

    def loss_on(self, rays_o, rays_d, gt, bg, noise=None, t=None, x_reg=None,
                plain: bool = False, params=None, x_tv=None):
        """MSE of render_dense through the field's kernels (plain=True: their
        plain versions) on the current occupancy -> (loss, n_samples),
        differentiable in the params. A time-conditioned field renders at
        time t on the occupancy of t's bin, through `params` (None: the
        current params annealed at the current step), and with x_reg adds
        deform_zero_reg * mean(deform_raw(x_reg, 0)^2). x_tv: points [N, 3]
        in [0, 1] of the Instant-NGP table's TV term (Trainer's)."""
        fwd = self._train_forward if not plain else \
            lambda p, x, d, *tt: self._train_forward(p, x, d, *tt, plain=True)
        occ_m, extra = self._occ_m, ()
        if params is None:
            params = self._anneal_params(self.params, self.global_step)
        if self.time_conditioned:
            t = torch.as_tensor(t, dtype=torch.float32,
                                device=self.device).reshape(())
            # the bin's slice, picked on the device
            occ_m = occ_m.index_select(
                0, time_slice_index(t, self.dyn_grid_cfg).reshape(1))[0]
            extra = (t,)
        res = render_dense(params, occ_m, rays_o, rays_d,
                           self.march_cfg, fwd, bg_color=bg,
                           noise=noise, density_scale=self.opt.density_scale,
                           t_thresh=self.opt.t_thresh, extra=extra)
        loss = self._image_loss(res["image"], gt)
        if self.time_conditioned and x_reg is not None and \
                self.opt.deform_zero_reg > 0:
            h0 = self.field.deform_raw(params, x_reg, 0.0)
            loss = loss + self.opt.deform_zero_reg * torch.mean(h0 ** 2)
        if x_tv is not None:
            loss = loss + self.opt.tv_weight * self.field.tv_loss(params,
                                                                  x_tv)
        return loss, res["n_samples"]

    def train_step(self, data, h: int, w: int):
        """One training step -> (loss, n_samples) as device tensors."""
        with profiling.span("step"):
            params = None
            if self.time_conditioned:
                params = self._anneal_params(self.params, self.global_step)
                if self.dyn_refresh_due(self.global_step,
                                        self._dyn_host_counts()[0]):
                    self.refresh_grid(params)
            elif self.global_step % self.opt.update_extra_interval == 0:
                self.refresh_grid()
            with profiling.span("step.sample"):
                batch = self.sample_batch(data, h, w)
                tv = {}
                if self._hash and self.opt.tv_weight > 0:
                    tv["x_tv"] = torch.rand((self.n_local_rays, 3),
                                            generator=self.rank_generator,
                                            device=self.device)
            with profiling.span("step.forward"):
                loss, n_samples = self.loss_on(*batch, params=params, **tv)
            with profiling.span("step.backward"):
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                # compositing's cumprod backward reads whether its input
                # holds a zero
                profiling.host_sync(loss)
            with profiling.span("step.update"):
                loss = self.reduce_gradients(loss)
                self.apply_gradients()
                self._update_error_map()
            self.global_step += 1
            return loss.detach(), n_samples

    @staticmethod
    def resolve_time_curriculum(steps: int, times) -> int:
        """The curriculum length that -1 ("auto") stands for: 512 on
        monocular data (one camera per timestamp, the shape of the D-NeRF
        datasets, where training without the growing window peaks early and
        decays), 0 (off) where several cameras share a timestamp or there
        are no times. Any other value is returned as it is."""
        if steps >= 0:
            return steps
        if times is None:
            return 0
        t = np.round(np.asarray(times, np.float64).reshape(-1), 6)
        _, counts = np.unique(t, return_counts=True)
        return 512 if int(counts.max()) == 1 else 0

    def enable_time_curriculum(self, train_dataset):
        """Sort the frames by time and switch the growing time window on.
        Returns the sorted dataset: train on that one. train() does this
        when opt.time_curriculum_steps > 0; a caller that drives train_step
        itself calls this first."""
        import dataclasses
        order = np.argsort(train_dataset.times, kind="stable")
        self._time_sorted = True
        emap = train_dataset.error_map
        return dataclasses.replace(
            train_dataset, poses=train_dataset.poses[order],
            images=train_dataset.images[order],
            times=train_dataset.times[order],
            error_map=None if emap is None else emap[order])

    def _prepare_train(self, train_dataset):
        """A time-conditioned field first resolves and switches on the time
        curriculum; then the march occupancy."""
        if self.time_conditioned:
            if self.opt.time_curriculum_steps != 0:
                self.opt.time_curriculum_steps = self.resolve_time_curriculum(
                    self.opt.time_curriculum_steps, train_dataset.times)
            if self.opt.time_curriculum_steps > 0 and \
                    train_dataset.times is not None:
                train_dataset = self.enable_time_curriculum(train_dataset)
        self._occ_m = self._march_occ()
        return train_dataset

    def _device_data(self, train_dataset):
        """The training data: on the device, or with preload=False the
        images kept on the host (NeRFDataset.device), which patches do not
        support."""
        if not self.opt.preload and self.opt.patch_size > 1:
            raise ValueError("preload=False does not support patch "
                             "sampling (--patch_size > 1)")
        return train_dataset.device(self.device, preload=self.opt.preload)

    def _ready_for_steps(self, data):
        super()._ready_for_steps(data)
        if self._occ_m is None:
            self._occ_m = self._march_occ()

    # -------------------------------------------------------- rendering
    def _pick_tile(self, rh: int, rw: int, pose, intrinsics) -> int:
        """March-tile size of an rh x rw frame from the camera `pose`
        (cam2world [4, 4]) with `intrinsics` (fx, fy, cx, cy at the frame's
        resolution): the reference's pick (reference_tile) where that tile
        is conservative at this camera (tile_fits), else the largest
        smaller tile that divides the frame and is, else 1 (per-ray)."""
        ref = reference_tile(rh, rw, self.opt.render_tile_px)
        for tp in range(ref, 1, -1):
            if rh % tp == 0 and rw % tp == 0 and tile_fits(
                    tp, pose, intrinsics, self.render_cfg,
                    self.opt.render_dilate):
                return tp
        return 1

    @torch.no_grad()
    def render_image(self, pose, intrinsics, h, w, bg_color=None,
                     downscale: int = 1, params=None, time=None,
                     lod: bool = False, buckets: Optional[bool] = None):
        """Whole-frame render -> (rgb f32 [rh, rw, 3], depth f32 [rh, rw])
        as numpy arrays. A time-conditioned field renders at `time` (None:
        0), marching the occupancy of that time's bin.

        The renderer: bucketed with the termination trim (buckets=None:
        while _use_buckets(); True or False forces the pick) when the frame
        is cut into tiles, else tiled, with the eval ladder
        (opt.render_splits). lod=True renders the LOD preview: the line
        scales with res >= opt.preview_lod_min_res skipped in the kernel,
        and the preview ladder (opt.render_splits_preview). On a mesh of N
        ranks the frame renders by row bands when rh splits into N bands of
        whole tiles, else whole on every rank; every rank returns it.

        On a CUDA device the arrays live in page-locked host memory
        (profiling.fetch_frame), each in a block of its own: a caller who
        keeps many frames keeps that memory pinned."""
        with profiling.span("frame"):
            with profiling.span("frame.setup"):
                rh, rw = int(h // downscale), int(w // downscale)
                dev = self.device
                params = params if params is not None \
                    else self._infer_params()
                occ, extra = self.grid_state["occ"], ()
                if self.time_conditioned:
                    if isinstance(time, torch.Tensor):
                        profiling.host_sync(time)   # float() reads the card
                    t = 0.0 if time is None else float(time)
                    t_idx = time_slice_index(t, self.dyn_grid_cfg)
                    occ = self._occ_of(occ[t_idx], t_idx)
                    extra = (t,)
                else:
                    occ = self._occ_of(occ)
                rcfg, opt = self.render_cfg, self.opt
                occ_m = self.cascade_occ(occ, rcfg)
                # copies from pageable host memory: each waits for the card
                pose_t = torch.as_tensor(np.asarray(pose, np.float32),
                                         device=dev)
                intr = torch.as_tensor(np.asarray(intrinsics, np.float32),
                                       device=dev) / downscale
                profiling.host_sync(dev, 2)
                if bg_color is None:
                    bg = torch.ones(3, device=dev)
                else:
                    bg = torch.as_tensor(np.asarray(bg_color, np.float32),
                                         device=dev)
                    profiling.host_sync(dev)
                tp = self._pick_tile(rh, rw, pose,
                                     np.asarray(intrinsics, np.float32)
                                     / downscale)
                if buckets is None:
                    buckets = self._use_buckets()
                buckets = buckets and tp > 1
                kw = dict(tile_px=tp, dilate=opt.render_dilate,
                          density_scale=opt.density_scale,
                          t_thresh=opt.t_thresh)
                if buckets:
                    kw.update(splits=(opt.render_splits_preview if lod
                                      else opt.render_splits),
                              term_probe=opt.render_term_intervals,
                              term_tau=opt.render_term_tau,
                              term_stride=opt.render_term_stride)
                tables, fwd = self.field.kernel_tables(params), \
                    self._render_forward(lod)
            if self.ndev > 1 and tp > 1 and rh % (self.ndev * tp) == 0:
                img, depth = make_sharded_image_renderer(
                    self.mesh, rh, rw, rcfg, fwd, buckets=buckets, **kw)(
                        tables, occ_m, pose_t, intr, bg, *extra)
            else:
                render = render_image_bucketed if buckets \
                    else render_image_tiled
                img, depth = render(tables, occ_m, pose_t, intr, rh, rw,
                                    rcfg, fwd, bg, extra=extra, **kw)
            with profiling.span("frame.fetch"):
                return profiling.fetch_frame(img, depth)

    def warm_renderers(self, h, w, pose=None, intrinsics=None, time=None):
        """One throwaway frame through each renderer (tiled and bucketed),
        so that the kernels are built and the allocator holds a frame's
        buffers before the first timed or served frame. Default camera: on
        the -z axis at twice the bound, looking at the origin."""
        if pose is None:
            pose = np.eye(4, dtype=np.float32)
            pose[2, 3] = -2.0 * self.opt.bound
        if intrinsics is None:
            f = 0.5 * max(h, w)
            intrinsics = np.array([f, f, w / 2, h / 2], np.float32)
        for b in (False, True):
            self.render_image(pose, intrinsics, h, w, time=time, buckets=b)

    def test_gui(self, pose, intrinsics, w, h, bg_color=None, spp=1,
                 downscale=1, time=None, need_depth=True):
        """A GUI frame -> {"image": f32 [rh, rw, 3], "depth": f32 [rh, rw]
        or None}. downscale snaps to the nearest of 1, 2, 4 and 8;
        need_depth=False renders the LOD preview and returns no depth (the
        reference's preview wire; its u8 and yuv420 packing is not
        ported). On a CUDA device the arrays are pinned, as render_image's
        are."""
        downscale = min(GUI_DOWNSCALES, key=lambda b: abs(b - downscale))
        img, depth = self.render_image(pose, intrinsics, h, w,
                                       bg_color=bg_color,
                                       downscale=downscale, time=time,
                                       lod=not need_depth)
        return {"image": img, "depth": depth if need_depth else None}
