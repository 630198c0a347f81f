"""Truncated exponential (port of sealdnerf_tpu/ops/activation.py).

The forward is a plain exp. The backward clamps the pre-activation to
[-15, 15] before the exp, as the reference's custom VJP does, so that a
large pre-activation cannot blow up the gradient.
"""

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x):
    return _TruncExp.apply(x)
