"""Plain reference of the dense march, the compositing and the bucketed
frame renderer, as the program states them (single cascade, fixed pitch:
the bound-1, dt_gamma-0 recipe of both configurations).

- Training rays: the coarse pass at voxel-pitch midpoints through the
  march-resolution occupancy, the first n_intervals occupied steps kept,
  steps_per_interval samples each at pitch voxel / F shifted by the ray's
  noise, alpha compositing with the 1e-15 stabiliser and the transmittance
  cut-off, the background behind.
- Frames: one march per tile_px x tile_px tile (its centre ray) on the
  occupancy dilated by one voxel, then per tile the termination trim (a
  sigma tap at the middle of every stride-th of the first n_probe
  intervals along the tile's four corner rays; the intervals from the
  first tap whose entry optical depth passes tau on all four on are
  dropped), the tiles sorted by their interval count and cut into buckets
  by the ladder of (share of the tiles, divisor of the budget), a tile over
  its bucket's budget subsampled over its whole depth, and every pixel ray
  expanded from its tile's intervals. The program's bucketed frames place
  their samples so by design, so the reference does the same.
"""

import math

import torch
import torch.nn.functional as F

from . import field as rf


def pixel_dirs(pose, intr, h: int, w: int, inds=None):
    """World directions of pixel centres (all of them in raster order, or
    the flat indices `inds`) -> [N, 3]; intr = (fx, fy, cx, cy)."""
    if inds is None:
        inds = torch.arange(h * w, device=pose.device)
    i = (inds % w).float() + 0.5
    j = torch.div(inds, w, rounding_mode="floor").float() + 0.5
    d = torch.stack([(i - intr[2]) / intr[0], (j - intr[3]) / intr[1],
                     torch.ones_like(i)], dim=-1)
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    return d @ pose[:3, :3].t()


def near_far(ro, rd, bound: float, min_near: float):
    rinv = 1.0 / rd
    t0 = (-bound - ro) * rinv
    t1 = (bound - ro) * rinv
    near = torch.minimum(t0, t1).amax(-1)
    far = torch.maximum(t0, t1).amin(-1)
    miss = near > far
    near = near.clamp(min=min_near)
    near = torch.where(miss, torch.full_like(near, 1e10), near)
    far = torch.where(miss | (far < near), near, far)
    return near, far


def downsample(occ, m: int):
    """Max-pool a bool grid [..., H, H, H] to [..., m, m, m]."""
    h = occ.shape[-1]
    f = h // m
    return occ.reshape(occ.shape[:-3] + (m, f) * 3).any(-1).any(-2).any(-3)


def dilate(occ):
    p = F.max_pool3d(occ[None, None].float(), 3, stride=1, padding=1)
    return p[0, 0] > 0


def march(ro, rd, near, far, occ_m, mc: dict):
    """Entry distances of the first n_intervals occupied voxel steps ->
    (t_entry [N, Sc], valid [N, Sc])."""
    m, b = occ_m.shape[-1], mc["bound"]
    vox = 2.0 * b / m
    kc = int(math.ceil(math.sqrt(3.0) * m))
    sc = mc["n_intervals"]
    ks = (torch.arange(kc, dtype=torch.float32, device=ro.device) + 0.5) * vox
    t_mid = near[:, None] + ks[None]
    pos = ro[:, None] + t_mid[..., None] * rd[:, None]
    ijk = (((pos / b) * 0.5 + 0.5) * m).clamp(0.0, m - 1).long()
    hit = occ_m[ijk[..., 0], ijk[..., 1], ijk[..., 2]] \
        & (pos.abs() <= b).all(-1) & (t_mid - 0.5 * vox < far[:, None])
    slot = torch.cumsum(hit.int(), -1) - 1
    keep = hit & (slot < sc)
    n = ro.shape[0]
    t_entry = torch.zeros((n, sc), device=ro.device)
    valid = torch.zeros((n, sc), dtype=torch.bool, device=ro.device)
    rows = torch.arange(n, device=ro.device)[:, None].expand(n, kc)[keep]
    t_entry[rows, slot[keep].long()] = (t_mid - 0.5 * vox)[keep]
    valid[rows, slot[keep].long()] = True
    return t_entry, valid


def expand(t_entry, valid, far, f: int, step, noise=None):
    """[N, Sc] intervals of coarse step `step` (a number or [N, Sc]) ->
    (ts, dts, valid) [N, Sc * f]."""
    n, sc = t_entry.shape
    dt = (torch.as_tensor(step, dtype=torch.float32, device=t_entry.device)
          .expand(n, sc) / f)[..., None]
    ph = 0.0 if noise is None else noise[:, None, None]
    ts = t_entry[..., None] + (torch.arange(f, dtype=torch.float32,
                                            device=t_entry.device) + ph) * dt
    v = valid[..., None] & (ts < far[:, None, None])
    return (ts.reshape(n, -1), dt.expand(n, sc, f).reshape(n, -1),
            v.reshape(n, -1))


def composite(sigma, rgb, dts, ts, t_thresh: float):
    alpha = 1.0 - torch.exp(-(sigma * dts))
    trans = torch.cumprod(1.0 - alpha + 1e-15, -1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    wgt = alpha * trans * (trans >= t_thresh)
    return (wgt[..., None] * rgb).sum(1), wgt.sum(-1), (wgt * ts).sum(-1)


def _shade(params, cfg, ro, rd, ts, dts, valid, t, q, bg, mc, chunk_rays):
    """Field and compositing of pixel rays -> (image [N, 3], depth [N]),
    without gradient, in chunks of rays."""
    b = mc["bound"]
    imgs, deps = [], []
    for i in range(0, ts.shape[0], chunk_rays):
        tsc, dtc, vc = ts[i:i + chunk_rays], dts[i:i + chunk_rays], \
            valid[i:i + chunk_rays]
        n, s = tsc.shape
        rdc = rd[i:i + chunk_rays]
        x = (ro[i:i + chunk_rays, None] + tsc[..., None] * rdc[:, None]) \
            .clamp(-b, b)
        d = rdc[:, None].expand(n, s, 3)
        # the field at the valid samples only: the others weigh nothing
        sig = torch.zeros((n, s), device=ts.device)
        rgb = torch.zeros((n, s, 3), device=ts.device)
        if bool(vc.any()):
            sv, cv = rf.forward_chunked(params, cfg, x[vc], d[vc], t, q)
            sig[vc], rgb[vc] = sv * mc["density_scale"], cv
        img, wsum, dep = composite(sig, rgb, dtc, tsc, mc["t_thresh"])
        imgs.append((img + (1.0 - wsum)[:, None] * bg).clamp(0.0, 1.0))
        deps.append(dep)
    return torch.cat(imgs), torch.cat(deps)


def render_rays(params, cfg: dict, occ_m, ro, rd, mc: dict, bg, noise,
                t=None, q=rf.exact):
    """Training rays, differentiable in params -> image [N, 3]."""
    near, far = near_far(ro, rd, mc["bound"], mc["min_near"])
    t_entry, valid = march(ro, rd, near, far, occ_m, mc)
    vox = 2.0 * mc["bound"] / occ_m.shape[-1]
    ts, dts, valid = expand(t_entry, valid, far, mc["steps_per_interval"],
                            vox, noise)
    n, s = ts.shape
    x = (ro[:, None] + ts[..., None] * rd[:, None]).clamp(
        -mc["bound"], mc["bound"]).reshape(-1, 3)
    d = rd[:, None].expand(n, s, 3).reshape(-1, 3)
    sig, rgb = rf.forward(params, cfg, x, d, t, q)
    sig = torch.where(valid, sig.reshape(n, s) * mc["density_scale"],
                      torch.zeros_like(ts))
    img, wsum, _ = composite(sig, rgb.reshape(n, s, 3), dts, ts,
                             mc["t_thresh"])
    return img + (1.0 - wsum)[:, None] * bg


def bucket_bounds(n_tiles: int, sc: int, splits):
    bounds, start = [], 0
    for frac, div in splits:
        end = min(start + int(round(n_tiles * frac)), n_tiles)
        bounds.append((start, end, max(sc // div, 1)))
        start = end
    bounds[-1] = (bounds[-1][0], n_tiles, bounds[-1][2])
    return bounds


def _subsample(t_entry, valid, sc_b: int, vox: float):
    sc = t_entry.shape[1]
    count = valid.long().sum(-1, keepdim=True)
    k = torch.arange(sc_b, device=t_entry.device)[None]
    lo = torch.div(k * count, sc_b, rounding_mode="floor")
    hi = torch.div((k + 1) * count, sc_b, rounding_mode="floor")
    te = torch.gather(t_entry, 1, lo.clamp(0, sc - 1))
    return te, hi > lo, vox * (hi - lo).float()


def _trim(params, cfg, pose, intr_t, th, tw, tp, t_entry, valid, vox, mc,
          t, q):
    n_tiles, sc = t_entry.shape
    dev = t_entry.device
    idx = torch.arange(0, min(mc["term_probe"], sc), mc["term_stride"],
                       device=dev)
    half = (tp - 1) / (2.0 * tp)
    dirs = []
    for sx in (-half, half):
        for sy in (-half, half):
            shifted = intr_t + torch.tensor([0.0, 0.0, sx, sy], device=dev)
            dirs.append(pixel_dirs(pose, shifted, th, tw))
    dirs = torch.stack(dirs)                                  # [4, T, 3]
    t_mid = t_entry[:, idx] + 0.5 * vox                       # [T, P]
    b = mc["bound"]
    x = (pose[:3, 3] + t_mid[None, ..., None] * dirs[:, :, None]).clamp(-b, b)
    d = dirs[:, :, None].expand(x.shape)
    sig, _ = rf.forward_chunked(params, cfg, x.reshape(-1, 3),
                                d.reshape(-1, 3), t, q)
    sig = sig.reshape(x.shape[:3])
    od = torch.where(valid[:, idx][None], sig * mc["density_scale"] * vox,
                     torch.zeros_like(sig))
    entry = (torch.cumsum(od, -1) - od).amin(0)
    kept = (entry <= mc["term_tau"]).long().sum(-1)
    k_term = torch.cat([idx, torch.full((1,), sc, device=dev)])[kept]
    return valid & (torch.arange(sc, device=dev)[None] < k_term[:, None])


def pick_tile(h: int, w: int, pose, intr, bound: float, march_res: int,
              dilate: int = 1, tile_px: int = 8) -> int:
    """The march tile of an h x w frame: 10 px at >= 800 px when both sides
    divide by 10 (tile_px 8 otherwise, 1 when a side does not divide),
    shrunk to the largest size that divides the frame and whose footprint
    (the angle from the tile's centre to its farthest pixel centre, times
    the distance to the far corner of the box) stays within the dilation."""
    if tile_px == 8 and min(h, w) >= 800 and h % 10 == 0 and w % 10 == 0:
        ref = 10
    else:
        ref = 1 if h % tile_px or w % tile_px else tile_px
    fx, fy = float(intr[0]), float(intr[1])
    o = [float(v) for v in pose[:3, 3]]
    far = math.sqrt(sum((abs(v) + bound) ** 2 for v in o))
    vox = 2.0 * bound / march_res
    for tp in range(ref, 1, -1):
        angle = 0.5 * (tp - 1) * math.sqrt(1.0 / fx ** 2 + 1.0 / fy ** 2)
        if h % tp == 0 and w % tp == 0 and far * angle <= dilate * vox:
            return tp
    return 1


def render_frame(params, cfg: dict, occ_m, pose, intr, h: int, w: int,
                 mc: dict, bg, t=None, q=rf.exact, chunk_rays: int = 1 << 14):
    """A bucketed frame -> (image [h, w, 3], depth [h, w]), no gradient."""
    tp, b = mc["tile_px"], mc["bound"]
    th, tw = h // tp, w // tp
    m = occ_m.shape[-1]
    vox = 2.0 * b / m
    sc = mc["n_intervals"]
    dev = pose.device
    with torch.no_grad():
        intr_t = intr / tp
        td = pixel_dirs(pose, intr_t, th, tw)
        to = pose[:3, 3].expand(td.shape)
        near, far = near_far(to, td, b, mc["min_near"])
        far = far + vox * 2.0                                 # dilate 1
        t_entry, valid = march(to, td, near, far, dilate(occ_m), mc)
        if mc["term_probe"] > 0:
            valid = _trim(params, cfg, pose, intr_t, th, tw, tp, t_entry,
                          valid, vox, mc, t, q)
        counts = valid.int().sum(-1)
        order = torch.argsort(counts, stable=True)
        rd_all = pixel_dirs(pose, intr, h, w).reshape(th, tp, tw, tp, 3) \
            .permute(0, 2, 1, 3, 4).reshape(th * tw, tp * tp, 3)
        img = torch.empty((th * tw, tp * tp, 3), device=dev)
        dep = torch.empty((th * tw, tp * tp), device=dev)
        for s0, s1, sc_b in bucket_bounds(th * tw, sc, mc["splits"]):
            tiles = order[s0:s1]
            if tiles.numel() == 0:
                continue
            te, iv = t_entry[tiles], valid[tiles]
            step = torch.full_like(te, vox)
            if sc_b < sc:
                te, iv, step = _subsample(te, iv, sc_b, vox)
            npx = tp * tp
            rep = lambda a: a[:, None].expand(  # noqa: E731
                (a.shape[0], npx) + a.shape[1:]).reshape(
                (-1,) + a.shape[1:])
            ts, dts, vv = expand(rep(te), rep(iv), rep(far[tiles]),
                                 mc["steps_per_interval"], rep(step))
            rd = rd_all[tiles].reshape(-1, 3)
            ro = pose[:3, 3].expand(rd.shape)
            im, dp = _shade(params, cfg, ro, rd, ts, dts, vv, t, q, bg, mc,
                            chunk_rays)
            img[tiles] = im.reshape(-1, npx, 3)
            dep[tiles] = dp.reshape(-1, npx)
        img = img.reshape(th, tw, tp, tp, 3).permute(0, 2, 1, 3, 4) \
            .reshape(h, w, 3)
        dep = dep.reshape(th, tw, tp, tp).permute(0, 2, 1, 3).reshape(h, w)
    return img, dep
