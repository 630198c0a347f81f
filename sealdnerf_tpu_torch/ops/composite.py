"""Alpha compositing in the dense [N_rays, T] layout (port of
`composite_rays` in sealdnerf_tpu/ops/composite.py).

Exclusive-cumprod transmittance with the reference's 1e-15 stabiliser and
the transmittance early-stop threshold as a multiplicative mask.
"""

import torch


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
    """
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
