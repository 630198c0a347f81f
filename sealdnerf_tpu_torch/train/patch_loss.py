"""The structural criterion of --patch_size training (port of
sealdnerf_tpu/train/patch_loss.py).

The reference adds 1e-3 x a weight-free SSIM term on the sampled p x p
patches (its stand-in for the original's LPIPS term, which needs
pretrained weights). Rays come in patch-major order, as data/rays.py's
patch sampling lays them out.
"""

import torch


def patch_ssim_loss(pred, gt, patch_size: int, c1: float = 0.01 ** 2,
                    c2: float = 0.03 ** 2):
    """mean(1 - SSIM(patch)) over [N, 3] ray batches laid out as p x p
    patches (N a multiple of p^2), with each patch's global statistics (a
    uniform window over the whole patch; population variances)."""
    p2 = patch_size * patch_size
    n = pred.shape[0]
    pr = pred.reshape(n // p2, p2, 3)
    gt_ = gt.reshape(n // p2, p2, 3)
    mu_p = pr.mean(dim=1)
    mu_g = gt_.mean(dim=1)
    var_p = pr.var(dim=1, unbiased=False)
    var_g = gt_.var(dim=1, unbiased=False)
    cov = ((pr - mu_p[:, None]) * (gt_ - mu_g[:, None])).mean(dim=1)
    ssim = ((2 * mu_p * mu_g + c1) * (2 * cov + c2)) / \
        ((mu_p ** 2 + mu_g ** 2 + c1) * (var_p + var_g + c2))
    return torch.mean(1.0 - ssim)


def patch_criterion(pred, gt, patch_size: int, weight: float = 1e-3):
    """The additive patch term of a training step: 0 when patch_size <=
    1."""
    if patch_size <= 1:
        return 0.0
    return weight * patch_ssim_loss(pred, gt, patch_size)
