"""Training losses (port of sealdnerf_tpu/ops/losses.py): MAPE, Huber and the
O(N) distortion loss of mip-NeRF 360.

eff_distloss writes the forward alone with cumsums and takes its gradient
from autograd, as the reference does; that reproduces the hand-written
backward of torch_efficient_distloss analytically.
"""

import torch


def mape_loss(pred, target, reduction: str = "mean"):
    """Mean absolute percentage error: |pred - target| / (|target| +
    1e-2)."""
    loss = torch.abs(pred - target) / (torch.abs(target) + 1e-2)
    return loss.mean() if reduction == "mean" else loss


def huber_loss(pred, target, delta: float = 0.1, reduction: str = "mean"):
    """Huber loss: 0.5 / delta * r^2 where r = |pred - target| <= delta,
    else r - 0.5 * delta."""
    rel = torch.abs(pred - target)
    sqr = 0.5 / delta * rel * rel
    loss = torch.where(rel > delta, rel - 0.5 * delta, sqr)
    return loss.mean() if reduction == "mean" else loss


def eff_distloss(w, m, interval):
    """Efficient O(N) distortion loss.

    Args:
      w: [B, N] volume-rendering weights.
      m: [B, N] sample midpoint distances.
      interval: scalar or [B, N] per-sample interval.
    """
    n_rays = 1
    for s in w.shape[:-1]:
        n_rays *= s
    w_cumsum = torch.cumsum(w, dim=-1)
    wm_cumsum = torch.cumsum(w * m, dim=-1)
    zero = torch.zeros_like(w_cumsum[..., :1])
    w_prefix = torch.cat([zero, w_cumsum[..., :-1]], dim=-1)
    wm_prefix = torch.cat([zero, wm_cumsum[..., :-1]], dim=-1)
    loss_uni = (1.0 / 3.0) * interval * w ** 2
    loss_bi = 2.0 * w * (m * w_prefix - wm_prefix)
    return (loss_bi.sum() + loss_uni.sum()) / n_rays
