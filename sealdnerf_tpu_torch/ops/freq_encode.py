"""Frequency (sin/cos positional) encoding (port of
sealdnerf_tpu/ops/freq_encode.py).

For degree F the output is [x, sin(2^0 x), cos(2^0 x), ..., sin(2^{F-1} x),
cos(2^{F-1} x)]: the raw D inputs, then per frequency sin over all D dims
followed by cos over all D dims.
"""

import torch


def freq_output_dim(input_dim: int, degree: int) -> int:
    return input_dim + input_dim * degree * 2


def freq_encode(x, degree: int = 6):
    """x: [..., D] float -> [..., D + D*degree*2] float."""
    outs = [x]
    for f in range(degree):
        xf = x * (2.0 ** f)
        outs.append(torch.sin(xf))
        outs.append(torch.cos(xf))
    return torch.cat(outs, dim=-1)
