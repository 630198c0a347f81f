"""Dense two-level ray marching, single-cascade path (port of
sealdnerf_tpu/ops/marching_dense.py).

1. Coarse pass: step every ray at voxel pitch through the march-resolution
   occupancy grid, K_c = ceil(sqrt(3) * march_res) steps per ray.
2. Interval compaction: keep the first `n_intervals` occupied steps per ray.
   The reference writes them with a one-hot einsum over [N, K_c, S_c]; here
   they are scattered on their slot index, which gives the same values.
3. Fine expansion: each kept interval emits `steps_per_interval` samples at
   pitch voxel / F, in ascending t per ray.

The cascade march (cascades > 1 or dt_gamma > 0, the bound > 1 recipes) is
not ported yet: the march raises NotImplementedError for it.
"""

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

SQRT3 = 1.7320508075688772


@dataclass(frozen=True)
class DenseMarchConfig:
    bound: float = 1.0
    march_res: int = 64          # coarse march grid resolution
    n_intervals: int = 16        # kept occupied voxel-steps per ray
    steps_per_interval: int = 4  # fine samples per kept interval
    min_near: float = 0.05
    cascades: int = 1
    dt_gamma: float = 0.0

    @property
    def multi(self) -> bool:
        return self.cascades > 1 or self.dt_gamma > 0.0

    @property
    def voxel(self) -> float:
        return 2.0 * self.bound / self.march_res

    @property
    def k_coarse(self) -> int:
        if self.multi:
            raise NotImplementedError(
                "the cascade march (cascades > 1 or dt_gamma > 0) is not "
                "ported yet")
        return int(math.ceil(SQRT3 * self.march_res))

    @property
    def samples_per_ray(self) -> int:
        return self.n_intervals * self.steps_per_interval

    @property
    def dt(self) -> float:
        return self.voxel / self.steps_per_interval


def downsample_occ(occ, march_res: int):
    """Max-pool a bool occupancy grid [H, H, H] to [M, M, M] (M <= H)."""
    h = occ.shape[-1]
    if h == march_res:
        return occ
    f = h // march_res
    if f * march_res != h:
        raise ValueError(f"grid {h} is not a multiple of march_res "
                         f"{march_res}")
    return occ.reshape(march_res, f, march_res, f, march_res, f).any(
        dim=5).any(dim=3).any(dim=1)


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
    return t_entry, iv_valid


def expand_intervals(t_entry, iv_valid, fars, cfg: DenseMarchConfig,
                     noise=None):
    """Fine expansion of [N, Sc] intervals into [N, Sc*F] samples.

    noise: optional [N] fine-phase jitter in [0, 1).
    """
    n, sc = t_entry.shape
    f = cfg.steps_per_interval
    dev = t_entry.device
    ph = torch.zeros((n, 1, 1), device=dev) if noise is None \
        else noise[:, None, None]
    dt_f = torch.full((n, sc, 1), cfg.dt, dtype=torch.float32, device=dev)
    fine = (torch.arange(f, dtype=torch.float32, device=dev)[None, None, :]
            + ph) * dt_f
    ts = t_entry[..., None] + fine                           # [N, Sc, F]
    valid = iv_valid[..., None] & (ts < fars[:, None, None])
    ts = ts.reshape(n, sc * f)
    valid = valid.reshape(n, sc * f)
    dts = dt_f.expand(n, sc, f).reshape(n, sc * f)
    counts = valid.to(torch.int32).sum(dim=-1)
    return {"ts": ts, "dts": dts, "valid": valid, "counts": counts}


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

    occ_m: bool [M, M, M] occupancy at march resolution (or [1, M, M, M]).
    Returns dict(ts [N, S], dts [N, S], valid [N, S] bool, counts [N]).
    """
    if occ_m.dim() == 4:
        occ_m = occ_m[0]
    t_entry, iv_valid = march_intervals(rays_o, rays_d, nears, fars, occ_m,
                                        cfg)
    return expand_intervals(t_entry, iv_valid, fars, cfg, noise=noise)
