"""Whole-image rendering (port of `render_image_tiled` and
`render_image_bucketed` in sealdnerf_tpu/render/fast_image.py).

Tiled:
1. March only the tile-center rays (one ray per tile_px x tile_px pixels)
   against a conservatively dilated occupancy grid (each cascade dilated on
   its own): for a pinhole camera a sample at distance t on the tile-center
   ray lies within the tile's footprint of the same point on every ray of
   the tile, so the dilated interval set covers every pixel of the tile.
2. Broadcast each tile's intervals to its pixels and expand them into fine
   samples per pixel ray.
3. Evaluate the field on planar [3, M] samples (the fused kernel's layout)
   and composite densely.

Bucketed (the renderer of trained fields): the same tile march, then
optionally the termination trim (each tile's intervals behind an opaque
surface dropped, judged by sigma taps along the tile's four corner rays),
then the tiles sorted by their interval count and rendered in buckets, each
with its own interval budget (`splits`); a tile over its bucket's budget is
subsampled over its whole depth (ops/marching_dense.py:subsample_intervals).
A tile that holds no interval is background without a field call: the
sorted counts come to the host once per frame, each bucket renders its
tiles from the first that holds an interval on, in whole groups of
LIVE_TILE_GROUP tiles (an empty bucket renders none), and adjacent buckets
of one budget render in one call. So a frame costs what its occupied tiles
cost: a few more occupied tiles than a bucket's share bring in neither the
bucket's whole budget nor a call of its own.

Row bands (make_sharded_image_renderer): on a mesh of N ranks each rank
renders rh / N rows of the frame through either renderer, with the
principal point shifted to its band, and the bands are gathered, so that
every rank holds the whole frame. The bucketed renderer sorts and buckets
the tiles of the whole frame (the ranks' tile counts gathered), so that a
tile takes the budget it takes in the whole frame and the frame does not
depend on the number of ranks; the reference sorts each band's tiles
alone, which on an 800x800 frame of a trained field put two bands 34.6 dB
from the whole frame on an H100 (chip_smoke.py phase 16, PERF.md).

The renderers take the planar forward only: (params, x3 [3, M], d3 [3, M],
*extra) -> out [>= 4, M] with rows (sigma, r, g, b).

While a profiler session records, the phases of a frame are the spans
sdn.frame.march, sdn.frame.trim, sdn.frame.order, sdn.frame.bucket (one a
run of buckets rendered) and sdn.frame.stitch (utils/profiling.py), and each wait
of the host for the card is counted in "host_syncs" where it is made.
"""

from typing import Callable

import torch

from ..data.rays import get_rays
from ..ops.composite import composite_rays
from ..ops.marching_dense import (DenseMarchConfig, dilate_occ,
                                  expand_intervals, march_intervals,
                                  march_intervals_cascade,
                                  subsample_intervals)
from ..ops.ray import near_far_from_aabb
from ..parallel.mesh import all_gather_rows
from ..utils import profiling

# the reference's default bucket ladder: (share of the tiles, divisor of the
# interval budget), emptiest tiles first; the last split takes the rest
DEFAULT_SPLITS = ((0.55, 4), (0.30, 2), (1.0, 1))

# a bucket renders its occupied tiles in whole groups of this many, so that
# a frame's field calls take few distinct sizes
LIVE_TILE_GROUP = 64


def _march_tiles(to, td, tnear, tfar, occ_m, cfg: DenseMarchConfig,
                 dilate: int):
    """Tile-center coarse march on the dilated grid, single-grid or cascade.

    occ_m: [M, M, M] (single) or [CAS, M, M, M] (cfg.multi). Returns
    (t_entry [T, Sc], iv_dt [T, Sc] or None, iv_valid [T, Sc], far [T]);
    far is padded by the dilation, in the coarsest cascade's voxels, so that
    the pixel rays of a tile reach its band."""
    if cfg.multi:
        occ_c = occ_m if occ_m.dim() == 4 else occ_m[None]
        occ_d = torch.stack([dilate_occ(occ_c[c], dilate)
                             for c in range(occ_c.shape[0])])
        far = tfar + cfg.vox(cfg.cascades - 1) * (dilate + 1)
        t_entry, iv_dt, iv_valid = march_intervals_cascade(
            to, td, tnear, far, occ_d, cfg)
        return t_entry, iv_dt, iv_valid, far
    occ_d = dilate_occ(occ_m if occ_m.dim() == 3 else occ_m[0], dilate)
    far = tfar + cfg.voxel * (dilate + 1)
    t_entry, iv_valid = march_intervals(to, td, tnear, far, occ_d, cfg)
    return t_entry, None, iv_valid, far


def _tile_rays(pose, intr, th: int, tw: int, tile_px: int,
               cfg: DenseMarchConfig):
    """The tile-center rays (the image downsampled by tile_px) and their
    near/far -> (to [T, 3], td [T, 3], tnear [T], tfar [T])."""
    b = cfg.bound
    aabb = torch.tensor([-b] * 3 + [b] * 3, dtype=torch.float32,
                        device=pose.device)
    profiling.host_sync(pose)           # the copy from pageable host memory
    tr = get_rays(pose[None], intr / tile_px, th, tw, -1)
    to, td = tr["rays_o"][0], tr["rays_d"][0]
    tnear, tfar = near_far_from_aabb(to, td, aabb, cfg.min_near)
    return to, td, tnear, tfar


def _shade(params, ro, rd, ts, dts, valid, b: float, forward_fn, bg,
           density_scale: float, t_thresh: float, extra):
    """Field and compositing of n pixel rays with their [n, s] samples ->
    (image [n, 3] clipped to [0, 1], depth [n]). ro: [n, 3] or one [3]
    origin shared by all rays."""
    n, s = ts.shape
    dev = ts.device
    ro = ro.expand(n, 3)
    x3 = torch.empty((3, n * s), dtype=torch.float32, device=dev)
    d3 = torch.empty((3, n * s), dtype=torch.float32, device=dev)
    for a in range(3):
        da = rd[:, a]
        x3[a] = (ro[:, a][:, None] + ts * da[:, None]).clamp(-b, b).reshape(-1)
        d3[a] = da[:, None].expand(n, s).reshape(-1)
    out = forward_fn(params, x3, d3, *extra)
    del x3, d3
    sigma = torch.where(valid, out[0].reshape(n, s) * density_scale,
                        torch.zeros_like(ts))
    # channel rows as an [n, s, 3] view: no copy of the colours
    rgb = out[1:4].reshape(3, n, s).permute(1, 2, 0)
    comp = composite_rays(sigma, rgb, dts, ts=ts, t_thresh=t_thresh)
    image = (comp["image"] + (1.0 - comp["weights_sum"])[:, None] * bg
             ).clamp(0.0, 1.0)
    return image, comp["depth"]


def render_image_tiled(params, occ_m, pose, intr, rh: int, rw: int,
                       cfg: DenseMarchConfig, forward_fn: Callable, bg_color,
                       tile_px: int = 8, dilate: int = 1,
                       density_scale: float = 1.0, t_thresh: float = 1e-4,
                       extra=()):
    """Render a full image.

    Args:
      params: field params or packed tables, passed through to forward_fn.
      occ_m: bool [M, M, M] occupancy at cfg.march_res, or [CAS, M, M, M]
        with cfg.multi.
      pose: [4, 4] cam2world. intr: [4] fx fy cx cy (at render res).
      rh, rw: render resolution, multiples of tile_px.
      forward_fn: (params, x3 [3, M], d3 [3, M], *extra) -> out [>= 4, M]
        with rows (sigma, r, g, b).
      bg_color: [3] tensor.
      extra: further arguments of forward_fn: (t,) for a time-conditioned
        field, whose occ_m is then the slice of that time.

    Returns (image [rh, rw, 3], depth [rh, rw]).
    """
    if rh % tile_px or rw % tile_px:
        raise ValueError(f"{rh}x{rw} is not a multiple of tile {tile_px}")
    th, tw = rh // tile_px, rw // tile_px
    dev = pose.device
    with profiling.span("frame.march"):
        to, td, tnear, tfar = _tile_rays(pose, intr, th, tw, tile_px, cfg)
        t_entry, iv_dt, iv_valid, tfar = _march_tiles(
            to, td, tnear, tfar, occ_m, cfg, dilate)

    # broadcast the tile intervals to pixels
    def to_pixels(a):
        return a.reshape(th, 1, tw, 1, -1).expand(
            th, tile_px, tw, tile_px, a.shape[-1]).reshape(rh * rw, -1)

    # the whole frame is one bucket
    with profiling.span("frame.bucket"):
        pe, pv = to_pixels(t_entry), to_pixels(iv_valid)
        pdt = to_pixels(iv_dt) if iv_dt is not None else None
        pfar = to_pixels(tfar[:, None])[:, 0]

        # per-pixel rays and fine samples
        pr = get_rays(pose[None], intr, rh, rw, -1)
        mr = expand_intervals(pe, pv, pfar, cfg, iv_dt=pdt)
        bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
        image, depth = _shade(params, pr["rays_o"][0], pr["rays_d"][0],
                              mr["ts"], mr["dts"], mr["valid"], cfg.bound,
                              forward_fn, bg, density_scale, t_thresh, extra)
    return image.reshape(rh, rw, 3), depth.reshape(rh, rw)


def _corner_dirs(pose, intr_t, th: int, tw: int, tile_px: int):
    """The directions of each tile's four corner pixels -> [4, T, 3]. The
    downsampled grid samples pixel centers (i + 0.5) * tp; shifting its
    principal point by +-(tp - 1) / (2 tp) lands on the tile's first and
    last pixel centers (the reference's order: x shift outer, y inner)."""
    d = (tile_px - 1) / (2.0 * tile_px)
    dirs = []
    for sx in (-d, d):
        for sy in (-d, d):
            shift = torch.tensor([0.0, 0.0, sx, sy], dtype=torch.float32,
                                 device=intr_t.device)
            profiling.host_sync(intr_t)     # the copy from pageable memory
            dirs.append(get_rays(pose[None], intr_t + shift, th, tw,
                                 -1)["rays_d"][0])
    return torch.stack(dirs)


def _termination_trim(params, pose, intr_t, th: int, tw: int,
                      tile_px: int, t_entry, iv_valid, iv_dt,
                      cfg: DenseMarchConfig, forward_fn, density_scale: float,
                      tau: float, n_probe: int, extra, stride: int = 1):
    """Per-tile early termination (the reference's alive-ray kill at T <
    t_thresh, raymarching.cu:834-914, in the form of a per-tile interval
    trim).

    One mid-interval sigma tap per tapped interval along each of the tile's
    four corner pixel rays; every interval from the first tap whose entry
    optical depth exceeds tau on all four rays on is dropped. Only the
    first n_probe intervals are covered, every stride-th tapped: a skipped
    interval's density is not counted, so the estimate only falls and the
    trim comes later, never earlier. tau = 13.8 bounds the dropped
    contribution at exp(-13.8) ~ 1e-6 per probe.

    pose: the pinhole camera's [4, 4] cam2world. intr_t: the intrinsics of
    the downsampled tile grid. Returns iv_valid with the trimmed suffix cleared; the compacted
    front layout is kept, so counts, sort and subsampling see the trimmed
    workload.
    """
    n_tiles, sc = t_entry.shape
    b = cfg.bound
    dev = t_entry.device
    o = pose[:3, 3]
    cover = min(n_probe, sc)
    idx = torch.arange(0, cover, stride, device=dev)         # tap indices
    npb = idx.shape[0]
    dirs = _corner_dirs(pose, intr_t, th, tw, tile_px)       # [P, T, 3]
    npr = dirs.shape[0]
    width = iv_dt[:, idx] if iv_dt is not None else torch.full(
        (n_tiles, npb), cfg.voxel, dtype=torch.float32, device=dev)
    t_mid = t_entry[:, idx] + 0.5 * width                    # [T, npb]
    m = npr * n_tiles * npb
    x3 = torch.empty((3, m), dtype=torch.float32, device=dev)
    d3 = torch.empty((3, m), dtype=torch.float32, device=dev)
    for a in range(3):
        da = dirs[..., a]                                    # [P, T]
        x3[a] = (o[a] + t_mid[None] * da[..., None]).clamp(-b, b).reshape(-1)
        d3[a] = da[..., None].expand(npr, n_tiles, npb).reshape(-1)
    sigma = forward_fn(params, x3, d3, *extra)[0].reshape(npr, n_tiles, npb)
    od = torch.where(iv_valid[:, idx][None],
                     sigma * density_scale * width[None],
                     torch.zeros_like(sigma))
    cum = torch.cumsum(od, dim=-1)
    entry = (cum - od).amin(dim=0)                           # [T, npb]
    kept = (entry <= tau).to(torch.int64).sum(dim=-1)        # live taps
    # termination at tap k trims from interval idx[k]; no crossing within
    # the covered intervals keeps them all
    idxp = torch.cat([idx, torch.full((1,), sc, dtype=idx.dtype,
                                      device=dev)])
    k_term = idxp[kept]
    return iv_valid & (torch.arange(sc, device=dev)[None, :]
                       < k_term[:, None])


def _tile_major(plane, th: int, tw: int, tp: int):
    """[th * tp, tw * tp] pixel-major -> [th * tw, tp * tp] tile-major."""
    return plane.reshape(th, tp, tw, tp).permute(0, 2, 1, 3).reshape(
        th * tw, tp * tp)


def _untile(tiles, th: int, tw: int, tp: int):
    """[th * tw, tp * tp] -> [th * tp, tw * tp]."""
    return tiles.reshape(th, tw, tp, tp).permute(0, 2, 1, 3).reshape(
        th * tp, tw * tp)


def bucket_bounds(n_tiles: int, sc: int, splits):
    """The buckets of the sorted tiles -> [(start, end, interval budget)]:
    each split takes round(n_tiles * share) tiles (Python's round, as the
    reference), the last one the rest."""
    bounds = []
    start = 0
    for frac, div in splits:
        end = min(start + int(round(n_tiles * frac)), n_tiles)
        bounds.append((start, end, max(sc // div, 1)))
        start = end
    bounds[-1] = (bounds[-1][0], n_tiles, bounds[-1][2])
    return bounds


def _bucket_order(counts, sc: int, splits, mesh=None):
    """The order in which the tiles render and their buckets -> (order [T],
    [(start, end, interval budget)] over the ordered tiles): the tiles
    sorted by their interval count (stably: ties keep raster order) and cut
    by bucket_bounds. On a mesh of more than one rank `counts` are this
    rank's band's tiles; the sort and the buckets are then the whole
    frame's (the ranks' counts gathered in rank order, which is the frame's
    raster order of tiles), and this band's tiles take their whole-frame
    order, each bucket cut to the run of them it holds."""
    if mesh is None or mesh.size == 1:
        return torch.argsort(counts, stable=True), bucket_bounds(
            counts.numel(), sc, splits)
    n = counts.numel()
    every = all_gather_rows(mesh, counts)
    pos = torch.empty_like(every, dtype=torch.int64)
    pos[torch.argsort(every, stable=True)] = torch.arange(
        every.numel(), device=counts.device)
    mine = pos[mesh.rank * n:(mesh.rank + 1) * n]
    order = torch.argsort(mine)
    whole = bucket_bounds(every.numel(), sc, splits)
    edges = torch.tensor([b[0] for b in whole] + [every.numel()],
                         device=counts.device)
    cut = torch.searchsorted(mine[order], edges).tolist()
    profiling.host_sync(counts, 2)      # edges' copy, then the cuts' fetch
    return order, [(cut[i], cut[i + 1], b)
                   for i, (_, _, b) in enumerate(whole)]


def _render_bucket(params, o, te, iv, far, dt, rd_tiles, sc_b: int,
                   tp2: int, cfg: DenseMarchConfig, forward_fn, bg,
                   density_scale: float, t_thresh: float, extra):
    """One bucket of nb ordered tiles with their intervals (te, iv, dt
    [nb, Sc], far [nb]) and pixel directions (rd_tiles [3, nb, tp2]) at an
    interval budget of sc_b -> (image [nb * tp2, 3], depth [nb * tp2])."""
    nb = te.shape[0]
    if sc_b < cfg.n_intervals:
        te, iv, dt = subsample_intervals(te, iv, sc_b, iv_dt=dt,
                                         voxel=cfg.voxel)
    npix = nb * tp2

    def to_pixels(a):
        return a[:, None, :].expand(nb, tp2, a.shape[-1]).reshape(
            npix, a.shape[-1])

    mr = expand_intervals(to_pixels(te), to_pixels(iv),
                          far[:, None].expand(nb, tp2).reshape(npix), cfg,
                          iv_dt=None if dt is None else to_pixels(dt))
    return _shade(params, o, rd_tiles.reshape(3, npix).t(), mr["ts"],
                  mr["dts"], mr["valid"], cfg.bound, forward_fn, bg,
                  density_scale, t_thresh, extra)


def render_image_bucketed(params, occ_m, pose, intr, rh: int, rw: int,
                          cfg: DenseMarchConfig, forward_fn: Callable,
                          bg_color, tile_px: int = 8, dilate: int = 1,
                          density_scale: float = 1.0, t_thresh: float = 1e-4,
                          splits=DEFAULT_SPLITS, term_probe: int = 0,
                          term_tau: float = 13.8, term_stride: int = 1,
                          extra=(), mesh=None):
    """Tile-band render with per-tile sample budgets (same contract as
    render_image_tiled).

    The tiles are sorted by their interval count (after the termination
    trim when term_probe > 0) and rendered in buckets: splits = ((share of
    the tiles, divisor of the interval budget), ...) from the emptiest
    tiles on. Because the counts ascend, only the tiles at a bucket's top
    can exceed its budget, and those are subsampled over their depth; the
    last bucket keeps the full budget. A bucket's empty tiles below its
    first group of occupied ones are background without a field call, and
    adjacent buckets of one budget render in one call. Pixels travel with
    their tile.
    mesh: the frame is a row band of a mesh's frame (make_sharded_image_
    renderer), whose tiles are sorted and bucketed as the whole frame's.
    """
    if rh % tile_px or rw % tile_px:
        raise ValueError(f"{rh}x{rw} is not a multiple of tile {tile_px}")
    th, tw = rh // tile_px, rw // tile_px
    tp2 = tile_px * tile_px
    n_tiles = th * tw
    sc = cfg.n_intervals
    f = cfg.steps_per_interval
    dev = pose.device
    with profiling.span("frame.march"):
        to, td, tnear, tfar = _tile_rays(pose, intr, th, tw, tile_px, cfg)
        t_entry, iv_dt, iv_valid, tfar = _march_tiles(
            to, td, tnear, tfar, occ_m, cfg, dilate)
    o = pose[:3, 3]                                          # pinhole
    if term_probe > 0:
        # trim before counting, so that the sort sees the trimmed workload
        with profiling.span("frame.trim"):
            iv_valid = _termination_trim(
                params, pose, intr / tile_px, th, tw, tile_px, t_entry,
                iv_valid, iv_dt, cfg, forward_fn, density_scale, term_tau,
                term_probe, extra, stride=term_stride)
    with profiling.span("frame.order"):
        counts = iv_valid.to(torch.int32).sum(dim=-1)        # [T]
        order, bounds = _bucket_order(counts, sc, splits, mesh)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(n_tiles, device=dev)
        # one fetch a frame: which buckets hold any interval at all
        counts_sorted = profiling.fetch(counts[order])

        rd = get_rays(pose[None], intr, rh, rw, -1)["rays_d"][0]
        rd_tiles = torch.stack([_tile_major(rd[:, a].reshape(rh, rw), th,
                                            tw, tile_px)[order]
                                for a in range(3)])
        te_s, iv_s, far_s = t_entry[order], iv_valid[order], tfar[order]
        dt_s = iv_dt[order] if iv_dt is not None else None
        bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)

    # the counts ascend in this order: the tiles before the first that holds
    # an interval are empty. Each bucket renders its tiles from there on, in
    # whole groups; the runs of adjacent buckets with one budget are one
    # call, so that a few occupied tiles more do not add a bucket's work.
    first_live = int((counts_sorted == 0).sum())
    runs = []                                   # (start, end, budget)
    for s0, s1, sc_b in bounds:
        live = s1 - min(max(s0, first_live), s1)
        a = s1 - min(s1 - s0, -(-live // LIVE_TILE_GROUP) * LIVE_TILE_GROUP)
        if a == s1:
            continue
        if runs and runs[-1][1] == a and runs[-1][2] == sc_b:
            runs[-1] = (runs[-1][0], s1, sc_b)
        else:
            runs.append((a, s1, sc_b))
    img_parts, dep_parts = [], []
    n_empty = runs[0][0] if runs else n_tiles
    if n_empty:
        # background and zero depth, what compositing zero weights gives
        img_parts.append(bg.clamp(0.0, 1.0).expand(n_empty * tp2, 3))
        dep_parts.append(torch.zeros(n_empty * tp2, device=dev))
    for a, b, sc_b in runs:
        with profiling.span("frame.bucket"):
            image, depth = _render_bucket(
                params, o, te_s[a:b], iv_s[a:b], far_s[a:b],
                None if dt_s is None else dt_s[a:b],
                rd_tiles[:, a:b], sc_b, tp2, cfg, forward_fn, bg,
                density_scale, t_thresh, extra)
        img_parts.append(image)
        dep_parts.append(depth)
    # stitch: sorted order -> inverse permutation -> untile
    with profiling.span("frame.stitch"):
        image = torch.cat(img_parts).reshape(n_tiles, tp2, 3)[inv]
        depth = torch.cat(dep_parts).reshape(n_tiles, tp2)[inv]
        image = torch.stack([_untile(image[..., c], th, tw, tile_px)
                             for c in range(3)], dim=-1)
        depth = _untile(depth, th, tw, tile_px)
    return image, depth


def make_sharded_image_renderer(mesh, rh: int, rw: int, cfg: DenseMarchConfig,
                                forward_fn: Callable, tile_px: int = 8,
                                dilate: int = 1, density_scale: float = 1.0,
                                t_thresh: float = 1e-4, buckets: bool = False,
                                splits=DEFAULT_SPLITS, term_probe: int = 0,
                                term_tau: float = 13.8, term_stride: int = 1):
    """The row-band renderer of a mesh (the reference's function of this
    name): rank r renders rows [r * rh / N, (r + 1) * rh / N) through
    render_image_tiled, or render_image_bucketed with buckets=True (each
    band renders its own tiles, in the whole frame's buckets, and makes its
    own host fetches), with cy shifted by the band's first row; the bands
    are gathered in rank order.

    Requires rh % (N * tile_px) == 0 (the caller renders whole frames
    otherwise). Returns fn(params, occ_m, pose, intr, bg, *extra) ->
    (image [rh, rw, 3], depth [rh, rw]), the same on every rank; extra is
    (t,) for a time-conditioned field."""
    rows = rh // mesh.size
    if rows * mesh.size != rh or rows % tile_px:
        raise ValueError(f"{rh} rows do not split into {mesh.size} bands "
                         f"of whole {tile_px}-px tiles")
    kw = dict(tile_px=tile_px, dilate=dilate, density_scale=density_scale,
              t_thresh=t_thresh)
    if buckets:
        kw.update(splits=splits, term_probe=term_probe, term_tau=term_tau,
                  term_stride=term_stride, mesh=mesh)
    render = render_image_bucketed if buckets else render_image_tiled

    def fn(params, occ_m, pose, intr, bg, *extra):
        band = intr.clone()
        band[3] -= mesh.rank * rows          # cy shifts with the row band
        img, depth = render(params, occ_m, pose, band, rows, rw, cfg,
                            forward_fn, bg, extra=extra, **kw)
        both = all_gather_rows(mesh, torch.cat([img, depth[..., None]], -1))
        return both[..., :3], both[..., 3]
    return fn
