"""Alpha compositing (port of sealdnerf_tpu/ops/composite.py), in two
layouts:

- composite_rays: dense [N_rays, T]. Exclusive-cumprod transmittance with
  the reference's 1e-15 stabiliser and the transmittance early-stop
  threshold as a multiplicative mask.
- composite_packed: packed [M] (the samples of all rays in a row, ray ids
  ascending, from ops/marching.py). The optical depth before each sample is
  a segmented exclusive sum of sigma * dt. The reference takes it as a
  global f32 cumsum less each segment's base; over ~1e6 samples the two
  large sums cancel to a few 1e-3 of optical depth. Here the global sum and
  the bases are taken in f64, so the segmented sum is exact to f32
  rounding; it costs one f64 cumsum over the samples. A sample enters the
  running sum as at most OD_CAP (NaN and +inf as OD_CAP): behind such a
  sample its own ray's transmittance is 0 in f32 whatever the sum, so the
  weights do not change, while the global sum stays finite and exact
  enough. In the reference one infinite sigma * dt makes the optical depth
  of every later ray of the batch inf - inf = NaN.
"""

import torch

from ..utils import profiling

# a sample's share of the running optical-depth sum: exp(-OD_CAP) is 0 in f32
OD_CAP = 1.0e3


def composite_rays(sigmas, rgbs, deltas, ts=None, t_thresh: float = 0.0):
    """Dense-layout compositing.

    Args:
      sigmas: [N, T] densities (already density_scale-multiplied).
      rgbs: [N, T, 3]; a permuted view of channel rows [3, N, T] works
        without a copy, since each channel is summed on its own.
      deltas: [N, T] step sizes.
      ts: optional [N, T] sample positions for depth; None uses the
        cumulative deltas.
      t_thresh: samples reached with transmittance < t_thresh contribute 0.

    Returns:
      dict(weights [N,T], weights_sum [N], depth [N], image [N,3])

    While a profiler session records, the forward is the span
    sdn.composite (utils/profiling.py).
    """
    with profiling.span("composite"):
        alphas = 1.0 - torch.exp(-(sigmas * deltas))
        trans = torch.cumprod(1.0 - alphas + 1e-15, dim=-1)
        trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                          dim=-1)
        weights = alphas * trans
        if t_thresh > 0.0:
            weights = weights * (trans >= t_thresh)
        if ts is None:
            ts = torch.cumsum(deltas, dim=-1)
        return {
            "weights": weights,
            "weights_sum": weights.sum(dim=-1),
            "depth": (weights * ts).sum(dim=-1),
            "image": torch.stack([(weights * rgbs[..., c]).sum(dim=-1)
                                  for c in range(rgbs.shape[-1])], dim=-1),
        }


def composite_packed(sigmas, rgbs, dts, ts, ray_id, valid, n_rays: int,
                     t_thresh: float = 1e-4):
    """Packed-layout compositing.

    Args:
      sigmas: [M] densities. rgbs: [M, 3]. dts, ts: [M] step sizes and
        positions along the ray.
      ray_id: [M] int64 ray ids in [0, n_rays), ascending.
      valid: [M] bool (padding slots False).
      t_thresh: samples reached with transmittance < t_thresh contribute 0.

    Returns dict(weights [M], weights_sum [N], depth [N], image [N, 3]).
    A non-finite sigma * dt reaches only the outputs of its own ray.
    """
    sdt = torch.where(valid, sigmas * dts, torch.zeros_like(sigmas))
    sdt64 = torch.nan_to_num(sdt.double(), nan=OD_CAP, posinf=OD_CAP,
                             neginf=-OD_CAP).clamp(-OD_CAP, OD_CAP)
    cum_excl = torch.cumsum(sdt64, 0) - sdt64
    seg = torch.zeros(n_rays, dtype=torch.float64, device=sdt.device)
    seg = seg.index_add(0, ray_id, sdt64)
    base = torch.cumsum(seg, 0) - seg
    trans = torch.exp(-(cum_excl - base[ray_id]).float())
    alpha = 1.0 - torch.exp(-sdt)
    weights = alpha * trans * valid.to(sigmas.dtype)
    weights = weights * (trans >= t_thresh)

    def seg_sum(v):
        out = v.new_zeros((n_rays,) + v.shape[1:])
        return out.index_add(0, ray_id, v)
    return {
        "weights": weights,
        "weights_sum": seg_sum(weights),
        "depth": seg_sum(weights * ts),
        "image": seg_sum(weights[:, None] * rgbs),
    }
