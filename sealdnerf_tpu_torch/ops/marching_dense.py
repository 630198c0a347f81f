"""Dense two-level ray marching (port of
sealdnerf_tpu/ops/marching_dense.py).

1. Coarse pass: step every ray through the march-resolution occupancy grid.
   Single cascade (cascades == 1, dt_gamma == 0): voxel pitch, K_c =
   ceil(sqrt(3) * march_res) steps per ray. Cascade march (cascades > 1 or
   dt_gamma > 0, the bound > 1 recipes): a step ladder that grows with the
   distance, dt = clamp(t * dt_gamma * F, vox(0), vox(CAS - 1)), each step
   looked up in the cascade that the larger of its position's and its
   step's mip level selects.
2. Interval compaction: keep the first `n_intervals` occupied steps per ray
   (and, in the cascade march, each one's step). The reference writes them
   with a one-hot einsum over [N, K_c, S_c]; here they are scattered on
   their slot index, which gives the same values.
3. Fine expansion: each kept interval emits `steps_per_interval` samples at
   pitch step / F, in ascending t per ray.

`subsample_intervals` coarsens the compacted intervals to a smaller slot
budget (the bucketed renderer's cheap buckets).
"""

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..utils import profiling

SQRT3 = 1.7320508075688772


@dataclass(frozen=True)
class DenseMarchConfig:
    bound: float = 1.0
    march_res: int = 64          # coarse march grid resolution
    n_intervals: int = 16        # kept occupied voxel-steps per ray
    steps_per_interval: int = 4  # fine samples per kept interval
    min_near: float = 0.05
    cascades: int = 1            # 1 + ceil(log2(bound)) in practice
    dt_gamma: float = 0.0        # cone angle: step growth factor

    @property
    def multi(self) -> bool:
        """Whether the cascade march runs (cascades > 1 or dt_gamma > 0)."""
        return self.cascades > 1 or self.dt_gamma > 0.0

    @property
    def voxel(self) -> float:
        return 2.0 * self.bound / self.march_res

    def cas_bound(self, c: int) -> float:
        return min(float(1 << c), self.bound)

    def vox(self, c: int) -> float:
        """March-voxel edge of cascade c, which covers [-cas_bound(c),
        cas_bound(c)]^3 at march_res^3."""
        return 2.0 * self.cas_bound(c) / self.march_res

    @property
    def coarse_growth(self) -> float:
        """Growth of the coarse ladder: dt_gamma scaled so that the fine
        pitch (coarse step / steps_per_interval) grows at dt_gamma."""
        return self.dt_gamma * self.steps_per_interval

    @property
    def k_coarse(self) -> int:
        if not self.multi:
            return int(math.ceil(SQRT3 * self.march_res))
        # the ladder's length from min_near to the longest chord of the box,
        # simulated on the host as the reference does
        g = self.coarse_growth
        lo, hi = self.vox(0), self.vox(self.cascades - 1)
        far = 2.0 * SQRT3 * self.bound
        t, k = self.min_near, 0
        cap = 4 * self.march_res * self.cascades + 2048
        while t < far and k < cap:
            t += min(max(t * g, lo), hi) if g > 0 else lo
            k += 1
        return k

    @property
    def samples_per_ray(self) -> int:
        return self.n_intervals * self.steps_per_interval

    @property
    def dt(self) -> float:
        return self.voxel / self.steps_per_interval


def downsample_occ(occ, march_res: int):
    """Max-pool a bool occupancy grid [..., H, H, H] to [..., M, M, M]
    (M <= H); leading dimensions (time bins) are kept."""
    h = occ.shape[-1]
    if h == march_res:
        return occ
    f = h // march_res
    if f * march_res != h:
        raise ValueError(f"grid {h} is not a multiple of march_res "
                         f"{march_res}")
    return occ.reshape(occ.shape[:-3] + (march_res, f) * 3).any(
        dim=-1).any(dim=-2).any(dim=-3)


def march_intervals(rays_o, rays_d, nears, fars, occ_m,
                    cfg: DenseMarchConfig):
    """Coarse pass + interval compaction.

    Returns (t_entry [N, Sc] f32, iv_valid [N, Sc] bool): the entry distance
    of the first Sc occupied voxel-steps per ray.
    """
    n = rays_o.shape[0]
    m = cfg.march_res
    kc = cfg.k_coarse
    sc = cfg.n_intervals
    vox = cfg.voxel
    dev = rays_o.device

    # coarse pass: occupancy at voxel-pitch midpoints. The index arithmetic
    # keeps the reference's order so that indices agree at voxel boundaries.
    ks = (torch.arange(kc, dtype=torch.float32, device=dev) + 0.5) * vox
    t_mid = nears[:, None] + ks[None, :]                     # [N, Kc]
    pos = rays_o[:, None, :] + t_mid[..., None] * rays_d[:, None, :]
    ijk = (((pos / cfg.bound) * 0.5 + 0.5) * m).clamp(0.0, m - 1).to(
        torch.int64)                                          # [N, Kc, 3]
    flat = (ijk[..., 0] * m + ijk[..., 1]) * m + ijk[..., 2]
    inside = (pos.abs() <= cfg.bound).all(dim=-1)
    hit = occ_m.reshape(-1)[flat] & inside \
        & (t_mid - 0.5 * vox < fars[:, None])

    # compaction: scatter the first Sc occupied steps onto their slot
    slot = torch.cumsum(hit.to(torch.int32), dim=-1) - 1     # [N, Kc]
    keep = hit & (slot < sc)
    rows = torch.arange(n, device=dev)[:, None].expand(n, kc)[keep]
    cols = slot[keep].long()
    t_entry = torch.zeros((n, sc), dtype=torch.float32, device=dev)
    t_entry[rows, cols] = (t_mid - 0.5 * vox)[keep]
    iv_valid = torch.zeros((n, sc), dtype=torch.bool, device=dev)
    iv_valid[rows, cols] = True
    # the host waits for the three mask indexes and the copy of True
    profiling.host_sync(dev, 4)
    return t_entry, iv_valid


def expand_intervals(t_entry, iv_valid, fars, cfg: DenseMarchConfig,
                     noise=None, iv_dt=None):
    """Fine expansion of [N, Sc] intervals into [N, Sc*F] samples.

    noise: optional [N] fine-phase jitter in [0, 1).
    iv_dt: optional [N, Sc] coarse step per interval (the cascade march);
      None = the fixed pitch cfg.voxel.
    """
    n, sc = t_entry.shape
    f = cfg.steps_per_interval
    dev = t_entry.device
    ph = torch.zeros((n, 1, 1), device=dev) if noise is None \
        else noise[:, None, None]
    if iv_dt is None:
        dt_f = torch.full((n, sc, 1), cfg.dt, dtype=torch.float32,
                          device=dev)
    else:
        dt_f = (iv_dt / f)[..., None]                        # [N, Sc, 1]
    fine = (torch.arange(f, dtype=torch.float32, device=dev)[None, None, :]
            + ph) * dt_f
    ts = t_entry[..., None] + fine                           # [N, Sc, F]
    valid = iv_valid[..., None] & (ts < fars[:, None, None])
    ts = ts.reshape(n, sc * f)
    valid = valid.reshape(n, sc * f)
    dts = dt_f.expand(n, sc, f).reshape(n, sc * f)
    counts = valid.to(torch.int32).sum(dim=-1)
    return {"ts": ts, "dts": dts, "valid": valid, "counts": counts}


def subsample_intervals(t_entry, iv_valid, sc_b: int, iv_dt=None,
                        voxel: float = None):
    """Coarsen front-compacted intervals [N, Sc] to at most sc_b slots.

    Slot k of sc_b stands for the run of source intervals [k * count //
    sc_b, (k + 1) * count // sc_b): it samples from the run's first entry
    with its coarse step stretched by the run's length, so that the covered
    length (count * step) is kept and geometry is sampled more coarsely
    instead of cut. With count <= sc_b this is an exact re-packing of the
    input. In the cascade march a run is priced at its first interval's
    step.

    t_entry: [N, Sc] f32, ascending and front-compacted; iv_valid: [N, Sc]
    bool; iv_dt: optional [N, Sc] coarse steps (None: the fixed `voxel`).
    Returns (te [N, sc_b], valid [N, sc_b] bool, dt [N, sc_b] f32): dt is
    the stretched coarse step of each slot (expand_intervals' iv_dt).
    """
    n, sc = t_entry.shape
    dev = t_entry.device
    count = iv_valid.to(torch.int64).sum(dim=-1, keepdim=True)
    k = torch.arange(sc_b, dtype=torch.int64, device=dev)[None, :]
    lo = torch.div(k * count, sc_b, rounding_mode="floor")    # [N, sc_b]
    hi = torch.div((k + 1) * count, sc_b, rounding_mode="floor")
    src = lo.clamp(0, sc - 1)
    te = torch.gather(t_entry, 1, src)
    if iv_dt is None:
        dt_src = torch.full((n, sc_b), voxel, dtype=torch.float32,
                            device=dev)
    else:
        dt_src = torch.gather(iv_dt, 1, src)
    return te, hi > lo, dt_src * (hi - lo).to(torch.float32)


def _mip_from_val(mx, cascades: int):
    """frexp-style exponent, [0.5, 1) -> 0, [1, 2) -> 1, ..., clamped to
    [0, cascades - 1] (copy of sealdnerf_tpu/ops/marching.py:_mip_from_val)."""
    e = torch.ceil(torch.log2(mx.clamp(min=1e-10)))
    # log2 is integral at exact powers of two, where frexp rounds up
    e = torch.where(mx >= torch.exp2(e), e + 1.0, e)
    return e.clamp(0, cascades - 1).to(torch.int64)


def step_ladder(t0, k: int, g: float, lo: float, hi: float):
    """The step ladder t <- t + clamp(t * g, lo, hi) from t0 [N] for k steps
    -> (t [N, k], dt [N, k]), in closed form.

    The reference runs it as a sequential scan. The ladder has three
    phases, each in closed form here, so that a march costs a fixed handful
    of tensor operations instead of k small ones: steps of lo while t * g <=
    lo, geometric growth by 1 + g while lo < t * g < hi, then steps of hi.
    The scan's f32 sums accumulate their rounding step by step, these round
    once: the entries lie within a few f32 ulps of the scan's (rtol 1e-6,
    atol 1e-6: tests/test_torch_cascade.py, tests/test_torch_packed.py)."""
    ks = torch.arange(k, dtype=torch.float32, device=t0.device)[None, :]
    t0 = t0[:, None]
    if g == 0.0:
        return t0 + ks * lo, torch.full((t0.shape[0], k), lo,
                                        dtype=torch.float32,
                                        device=t0.device)
    t_lin, t_geo = lo / g, hi / g       # where the clamp leaves lo, meets hi
    zero = torch.zeros_like(t0)
    # phase 1: the steps k < n1 that start at t <= t_lin
    n1 = torch.where(t0 <= t_lin, torch.floor((t_lin - t0) / lo) + 1.0, zero)
    s2 = t0 + n1 * lo
    # phase 2: the steps that start below t_geo
    r = 1.0 + g
    n2 = torch.where(s2 < t_geo, torch.ceil(
        torch.log(t_geo / s2) / math.log(r)).clamp(min=0.0), zero)
    s3 = s2 * torch.pow(r, n2)
    t = torch.where(
        ks < n1, t0 + ks * lo,
        torch.where(ks < n1 + n2, s2 * torch.pow(r, ks - n1),
                    s3 + (ks - n1 - n2) * hi))
    return t, (t * g).clamp(lo, hi)


def coarse_ladder(nears, cfg: DenseMarchConfig):
    """The cascade march's coarse steps -> (t_ent [N, Kc], dt [N, Kc]): the
    step ladder from the nears with growth coarse_growth between vox(0) and
    vox(CAS - 1)."""
    return step_ladder(nears, cfg.k_coarse, cfg.coarse_growth, cfg.vox(0),
                       cfg.vox(cfg.cascades - 1))


def march_intervals_cascade(rays_o, rays_d, nears, fars, occ_cas,
                            cfg: DenseMarchConfig):
    """Cascade coarse pass + interval compaction.

    occ_cas: bool [CAS, M, M, M] march-resolution occupancy per cascade.
    Each step is looked up at its midpoint in cascade max(mip of the
    position, mip of the step) (raymarching.cu:368-379 semantics).

    Returns (t_entry [N, Sc], iv_dt [N, Sc], iv_valid [N, Sc] bool).
    """
    n = rays_o.shape[0]
    m = cfg.march_res
    sc = cfg.n_intervals
    dev = rays_o.device
    t_ent, dt_c = coarse_ladder(nears, cfg)
    kc = t_ent.shape[1]

    t_mid = t_ent + 0.5 * dt_c
    pos = rays_o[:, None, :] + t_mid[..., None] * rays_d[:, None, :]
    mx = pos.abs().amax(dim=-1)                              # [N, Kc]
    # the step's level: the smallest cascade whose march voxel is >= dt,
    # nudged down so that a step of exactly vox(c) stays in cascade c
    level = torch.maximum(
        _mip_from_val(mx, cfg.cascades),
        _mip_from_val(dt_c * (m * 0.5) * (1.0 - 1e-6), cfg.cascades))
    mip_bound = torch.exp2(level.to(torch.float32)).clamp(max=cfg.bound)
    ijk = (0.5 * (pos / mip_bound[..., None] + 1.0) * m).clamp(
        0.0, m - 1).to(torch.int64)
    flat = ((level * m + ijk[..., 0]) * m + ijk[..., 1]) * m + ijk[..., 2]
    hit = occ_cas.reshape(-1)[flat] & (mx <= cfg.bound) \
        & (t_ent < fars[:, None])

    slot = torch.cumsum(hit.to(torch.int32), dim=-1) - 1
    keep = hit & (slot < sc)
    rows = torch.arange(n, device=dev)[:, None].expand(n, kc)[keep]
    cols = slot[keep].long()
    t_entry = torch.zeros((n, sc), dtype=torch.float32, device=dev)
    t_entry[rows, cols] = t_ent[keep]
    iv_dt = torch.zeros((n, sc), dtype=torch.float32, device=dev)
    iv_dt[rows, cols] = dt_c[keep]
    iv_valid = torch.zeros((n, sc), dtype=torch.bool, device=dev)
    iv_valid[rows, cols] = True
    # the host waits for the four mask indexes and the copy of True
    profiling.host_sync(dev, 5)
    return t_entry, iv_dt, iv_valid


def dilate_occ(occ, r: int = 1):
    """Conservative 1-voxel-radius dilation, applied r times (3^3 max-pool
    with stride 1)."""
    for _ in range(r):
        p = F.pad(occ, (1, 1, 1, 1, 1, 1))
        acc = torch.zeros_like(occ)
        for dx in (0, 1, 2):
            for dy in (0, 1, 2):
                for dz in (0, 1, 2):
                    acc = acc | p[dx:dx + occ.shape[0],
                                  dy:dy + occ.shape[1],
                                  dz:dz + occ.shape[2]]
        occ = acc
    return occ


def march_dense(rays_o, rays_d, nears, fars, occ_m, cfg: DenseMarchConfig,
                noise=None):
    """March rays into a dense [N, S] sample set.

    occ_m: bool [M, M, M] occupancy at march resolution (or [1, M, M, M]);
      with cfg.multi [CAS, M, M, M], one grid per cascade.
    Returns dict(ts [N, S], dts [N, S], valid [N, S] bool, counts [N]).
    """
    if cfg.multi:
        occ_cas = occ_m if occ_m.dim() == 4 else occ_m[None]
        t_entry, iv_dt, iv_valid = march_intervals_cascade(
            rays_o, rays_d, nears, fars, occ_cas, cfg)
        return expand_intervals(t_entry, iv_valid, fars, cfg, noise=noise,
                                iv_dt=iv_dt)
    if occ_m.dim() == 4:
        occ_m = occ_m[0]
    t_entry, iv_valid = march_intervals(rays_o, rays_d, nears, fars, occ_m,
                                        cfg)
    return expand_intervals(t_entry, iv_valid, fars, cfg, noise=noise)
