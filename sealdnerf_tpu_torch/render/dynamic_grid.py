"""Time-conditioned occupancy grid (port of
sealdnerf_tpu/render/dynamic_grid.py).

State: density_grid [T, CAS, H^3] f32 (-1 marks cells no training camera
sees), occ bool [T, CAS, H, H, H], mean_density, iter_density and bin_cursor
(the next bin to refresh). A render at time t uses the slice floor(t * T).

iter_density has two writers, as in the reference. The training refresh
(`refresh_dyn_density_grid`, the reference FastTrainer's dyn_grid_update)
adds 1 per CALL, and the warm-up and freeze thresholds of training are call
counts, so a full checkpoint written mid-training by either package resumes
at the same point of that schedule. `update_dyn_density_grid` (the rebuild
path, the reference's function of the same name) adds 1 per completed PASS
over all bins; the trainer's rebuild puts the count back, so that a rebuild
does not move the training schedule.

- mark_untrained_dyn_grid: the static camera-coverage mask, broadcast over
  the time axis.
- update_dyn_density_grid: refreshes the next `bins_per_call` bins, round
  robin over the cursor. Each bin is queried at its centre time, jittered
  by +-0.5/T, on every cell (full=True) or on H^3/2 random cells, jittered
  inside the cell; then EMA max(grid * decay, new), the mean-density
  threshold over the whole grid, and the occupancy of every bin.
- rebuild_dyn_density_grid: full sweeps until every bin has been refreshed
  once.
- refresh_dyn_density_grid: one refresh call of training: the next
  `bins_per_call` bins, each at a random time inside the bin, on the
  deterministic half-grid slab while warming up and on H^3/2 random cells
  after it.

At full size (T 64, H 128) the density grid is 512 MB and the occupancy
128 MB, so the state is updated IN PLACE: the functions return a new dict
that holds the same, mutated, tensors. Jitter and random cells are drawn on
the grid's device from a torch.Generator, or passed in as `noise_u` so that
a test can hand both packages the same numbers.
"""

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..parallel.mesh import pmax
from .grid import (GridConfig, _cas_bound, _cell_coords, _coords_of,
                   init_grid_state, mark_untrained_grid)


@dataclass(frozen=True)
class DynGridConfig:
    bound: float = 1.0
    cascades: int = 1
    grid_size: int = 128
    time_size: int = 64
    density_thresh: float = 0.01
    density_scale: float = 1.0
    decay: float = 0.95
    freeze_after: int = 100   # passes over all bins before the grid freezes
    bins_per_call: int = 8    # time bins refreshed per update call

    @property
    def freeze_calls(self) -> int:
        """Update calls before freezing: freeze_after passes, each of
        ceil(time_size / bins_per_call) calls."""
        return self.freeze_after * max(
            1, math.ceil(self.time_size / self.bins_per_call))

    def static_view(self) -> GridConfig:
        return GridConfig(bound=self.bound, cascades=self.cascades,
                          grid_size=self.grid_size,
                          density_thresh=self.density_thresh,
                          density_scale=self.density_scale, decay=self.decay)


def init_dyn_grid_state(cfg: DynGridConfig, device=None):
    h3 = cfg.grid_size ** 3
    return {
        "density_grid": torch.zeros((cfg.time_size, cfg.cascades, h3),
                                    device=device),
        "occ": torch.zeros((cfg.time_size, cfg.cascades)
                           + (cfg.grid_size,) * 3, dtype=torch.bool,
                           device=device),
        "mean_density": torch.zeros((), device=device),
        "iter_density": torch.zeros((), dtype=torch.int32, device=device),
        "bin_cursor": torch.zeros((), dtype=torch.int32, device=device),
    }


def grid_times(cfg: DynGridConfig, device=None):
    """Bin-centre times, (arange(T) + 0.5) / T."""
    return (torch.arange(cfg.time_size, dtype=torch.float32, device=device)
            + 0.5) / cfg.time_size


def time_slice_index(time, cfg: DynGridConfig):
    """clamp(floor(time * T), 0, T - 1) in f32: an int for a host number,
    a 0-d int64 tensor (no host round trip) for a tensor."""
    if torch.is_tensor(time):
        idx = torch.floor(time.reshape(()).float() * cfg.time_size)
        return idx.clamp(0, cfg.time_size - 1).long()
    idx = np.floor(np.float32(time) * np.float32(cfg.time_size))
    return int(np.clip(idx, 0, cfg.time_size - 1))


def mark_untrained_dyn_grid(state, poses, intrinsics, cfg: DynGridConfig):
    """Set the cells no training camera sees to -1 in every time bin (in
    place). poses: [B, 4, 4] tensor; intrinsics: [4]."""
    scfg = cfg.static_view()
    static = mark_untrained_grid(init_grid_state(scfg, poses.device), poses,
                                 intrinsics, scfg)
    untrained = static["density_grid"] < 0                    # [CAS, H^3]
    state["density_grid"].masked_fill_(untrained[None], -1.0)
    return {**state}


def _bin_sums(grid, bins):
    """f64 sums of max(grid, 0) over each of the given bins -> [len(bins)].
    A run of consecutive bins is summed in one pass over a view."""
    if len(bins) > 1 and bins == list(range(bins[0], bins[0] + len(bins))):
        return grid[bins[0]:bins[0] + len(bins)].clamp(min=0.0).sum(
            dim=(1, 2), dtype=torch.float64)
    return torch.stack([grid[b].clamp(min=0.0).sum(dtype=torch.float64)
                        for b in bins])


def _runs(bins):
    """The list split into runs of consecutive bins (a refresh that wraps
    around the last bin has two)."""
    runs = [[bins[0]]]
    for b in bins[1:]:
        if b == runs[-1][-1] + 1:
            runs[-1].append(b)
        else:
            runs.append([b])
    return runs


def _set_occupancy(state, cfg: DynGridConfig, bin_sums=None, bins=None):
    """mean_density over the whole grid (f64 sum of max(grid, 0)), and every
    bin's occupancy against min(mean_density, density_thresh), written into
    state["occ"]. Returns (mean_density, bin_sums): the f64 per-bin sums
    [T]. A caller that passes back the bin_sums of its last call together
    with the bins it has changed since has only those summed again: the
    total is the same sum of the same 64 numbers."""
    grid = state["density_grid"]
    if bin_sums is None:
        # bin by bin: no 512 MB temporary
        bin_sums = torch.cat([_bin_sums(grid, [b])
                              for b in range(cfg.time_size)])
    else:
        bin_sums = bin_sums.clone()
        # written run by run through slices: an index tensor made from the
        # host's list would be uploaded from pageable memory, which waits
        # for the stream and so for the refresh's queries
        for run in _runs(list(bins)):
            bin_sums[run[0]:run[0] + len(run)] = _bin_sums(grid, run)
    mean_density = (bin_sums.sum() / grid.numel()).float()
    thresh = torch.clamp(mean_density, max=cfg.density_thresh)
    torch.gt(grid, thresh, out=state["occ"].view(grid.shape))
    return mean_density, bin_sums


def update_dyn_density_grid(state, density_fn: Callable, cfg: DynGridConfig,
                            full: bool,
                            generator: Optional[torch.Generator] = None,
                            noise_u=None):
    """Refresh the next `bins_per_call` time bins (in place).

    density_fn(x [N, 3], t 0-d tensor) -> sigma [N].
    full: sweep every cell of the selected bins; otherwise H^3/2 random
      cells per bin (duplicates allowed).
    generator: draws the cells and the jitter, on the grid's device.
    noise_u: optional (u_xyz [nb, CAS, N, 3], u_t [nb, CAS]) uniform draws
      in [0, 1) that replace the jitter draws.
    Freezing after cfg.freeze_calls calls is the caller's job.
    """
    h, tsz = cfg.grid_size, cfg.time_size
    h3 = h ** 3
    nb = min(cfg.bins_per_call, tsz)
    grid = state["density_grid"]
    dev = grid.device
    cursor = int(state["bin_cursor"])
    half_time = 0.5 / tsz
    n_pts = h3 if full else h3 // 2
    xyz01_full = 2.0 * _cell_coords(h, dev).float() / (h - 1) - 1.0 \
        if full else None
    tmp = torch.empty((cfg.cascades, h3), device=dev)      # reused per bin

    def rand(shape):
        return torch.rand(shape, generator=generator, device=dev)

    for k in range(nb):
        b = (cursor + k) % tsz
        t = (b + 0.5) / tsz
        tmp.fill_(-1.0)
        for cas in range(cfg.cascades):
            if full:
                indices, xyz01 = None, xyz01_full
            else:
                indices = torch.randint(0, h3, (n_pts,), generator=generator,
                                        device=dev)
                xyz01 = 2.0 * _coords_of(indices, h).float() / (h - 1) - 1.0
            bound = _cas_bound(cfg, cas)
            half = bound / h
            if noise_u is not None:
                u_xyz = noise_u[0][k, cas].to(dev)
                u_t = noise_u[1][k, cas].to(dev)
            else:
                u_xyz, u_t = rand((n_pts, 3)), rand(())
            pts = xyz01 * (bound - half) + (u_xyz * 2.0 - 1.0) * half
            tq = t + (u_t * 2.0 - 1.0) * half_time
            sig = density_fn(pts, tq) * cfg.density_scale
            if full:
                tmp[cas] = sig
            else:
                tmp[cas, indices] = sig
        old = grid[b]
        valid = (old >= 0) & (tmp >= 0)
        old.copy_(torch.where(valid, torch.maximum(old * cfg.decay, tmp),
                              old))
    mean_density, _ = _set_occupancy(state, cfg)
    return {
        "density_grid": grid,
        "occ": state["occ"],
        "mean_density": mean_density,
        "iter_density": state["iter_density"] + (cursor + nb) // tsz,
        "bin_cursor": (state["bin_cursor"] + nb) % tsz,
    }


def rebuild_dyn_density_grid(state, density_fn: Callable, cfg: DynGridConfig,
                             generator: Optional[torch.Generator] = None):
    """Full sweeps of every time bin: ceil(T / bins_per_call) update calls
    from the current cursor, so each bin is refreshed at least once."""
    nb = min(cfg.bins_per_call, cfg.time_size)
    for _ in range(math.ceil(cfg.time_size / nb)):
        state = update_dyn_density_grid(state, density_fn, cfg, full=True,
                                        generator=generator)
    return state


def refresh_dyn_density_grid(state, density_fn: Callable, cfg: DynGridConfig,
                             warmup_calls: int,
                             generator: Optional[torch.Generator] = None,
                             draws=None, bin_sums=None, calls=None,
                             cursor=None, time_generator=None, mesh=None):
    """One refresh call of dynamic training, in place (port of the reference
    FastTrainer's dyn_grid_update; single cascade).

    The next `bins_per_call` bins from the cursor are refreshed. Bin b is
    queried at t = (b + U[0, 1)) / T on n = (H^3/2) // size cells of each
    rank of the mesh, jittered inside the cell: while calls < warmup_calls
    the rank's part of the deterministic slab, (visits % 2) * H^3/2 + rank
    * n + arange(n) with visits = calls // (calls per pass), so that two
    visits of a bin sweep it once; after that n random cells (duplicates
    allowed). The ranks' queries of a call are merged with one pmax; then
    max(grid * decay, new) on the queried cells, the mean-density threshold
    over the whole grid and the occupancy of every bin, the same on every
    rank. iter_density goes up by 1 (it counts calls, see the module's
    note).

    density_fn(x [N, 3], t 0-d tensor) -> sigma [N].
    generator: the rank's own stream, which draws the cells and the jitter;
      time_generator (default: generator) draws the bins' times and is the
      same on every rank, so that the ranks query a bin at one time.
    draws: optional dict that replaces the generators' draws: "u_xyz"
      [nb, n, 3] and "u_t" [nb] uniform in [0, 1), and "indices" [nb, n]
      (used after the warm-up only).
    bin_sums: the per-bin sums that the last call returned (None: all bins
      are summed again).
    calls, cursor: host copies of iter_density and bin_cursor; None reads
      them from the state, which waits for the device.
    mesh: the data mesh (None: one rank).

    Returns (state, bin_sums).
    """
    if cfg.cascades != 1:
        raise NotImplementedError("the dynamic grid is single-cascade")
    h, tsz = cfg.grid_size, cfg.time_size
    h3 = h ** 3
    rank, size = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    n = (h3 // 2) // size
    nb = min(cfg.bins_per_call, tsz)
    per_pass = -(-tsz // nb)
    calls = int(state["iter_density"]) if calls is None else calls
    cursor = int(state["bin_cursor"]) if cursor is None else cursor
    warm = calls < warmup_calls
    grid = state["density_grid"]
    dev = grid.device
    half = cfg.bound / h
    time_generator = time_generator or generator

    def cell_centres(indices):
        return (2.0 * _coords_of(indices, h).float() / (h - 1) - 1.0) \
            * (cfg.bound - half)

    if warm:
        slab = ((calls // per_pass) % 2) * (h3 // 2) + rank * n \
            + torch.arange(n, device=dev)
        slab_centres = cell_centres(slab)
    bins = [(cursor + j) % tsz for j in range(nb)]
    # every bin's queries first, so that one pmax merges the ranks' cells
    tmp = torch.full((nb, h3), -1.0, device=dev)
    for j, b in enumerate(bins):
        if warm:
            indices, centres = slab, slab_centres
        else:
            indices = draws["indices"][j].to(dev) if draws is not None else \
                torch.randint(0, h3, (n,), generator=generator, device=dev)
            centres = cell_centres(indices)
        if draws is not None:
            u_xyz, u_t = draws["u_xyz"][j].to(dev), draws["u_t"][j].to(dev)
        else:
            u_xyz = torch.rand((n, 3), generator=generator, device=dev)
            u_t = torch.rand((), generator=time_generator, device=dev)
        pts = centres + (u_xyz * 2.0 - 1.0) * half
        tmp[j, indices] = density_fn(pts, (b + u_t) / tsz) * cfg.density_scale
    if mesh is not None:
        pmax(mesh, tmp)
    for j, b in enumerate(bins):
        old = grid[b, 0]
        valid = (old >= 0) & (tmp[j] >= 0)
        old.copy_(torch.where(valid, torch.maximum(old * cfg.decay, tmp[j]),
                              old))
    mean_density, bin_sums = _set_occupancy(state, cfg, bin_sums, bins)
    return {
        "density_grid": grid,
        "occ": state["occ"],
        "mean_density": mean_density,
        "iter_density": state["iter_density"] + 1,
        "bin_cursor": (state["bin_cursor"] + nb) % tsz,
    }, bin_sums
