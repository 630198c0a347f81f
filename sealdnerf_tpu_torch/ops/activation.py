"""Truncated exponential, forward only (port of
sealdnerf_tpu/ops/activation.py).

The forward is a plain exp with no clamp; the clamped gradient of the
reference belongs to the training slice, which is not ported yet.
"""

import torch


def trunc_exp(x):
    return torch.exp(x)
