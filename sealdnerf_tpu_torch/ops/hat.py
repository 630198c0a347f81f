"""Linear interpolation of a 1-D table as a 2-tap lerp (port of
sealdnerf_tpu/ops/hat.py).

The reference builds the hat basis u[s, i] = max(0, 1 - |x_s*(res-1) - i|)
as a dense [S, res] bf16 matrix and multiplies it into the table, because
gathers were slow on the TPU. At most two entries of a row are nonzero, so
here the same two weights are computed directly and the two table rows are
gathered. The weights are rounded to bf16 exactly as the reference rounds
its basis, and the table is read in bf16, so the f32 sum of the two exact
products equals the reference's matmul bit for bit.
"""

import torch


def bf16_round(t):
    """Round an f32 tensor to the nearest bf16 value, kept in f32."""
    return t.to(torch.bfloat16).float()


def hat_taps(x01, res: int):
    """Lower index and the two bf16-rounded hat weights at positions x01.

    Returns (i0 [...] int64, w0 [...] f32, w1 [...] f32): the basis row of
    x01 is w0 at i0, w1 at i0 + 1 and zero elsewhere. x01 is clipped to
    [0, 1]; at x01 == 1 the single nonzero is w1 = 1 at res - 1.
    """
    xa = x01.clamp(0.0, 1.0) * (res - 1)
    i0 = torch.floor(xa).clamp(max=res - 2)
    w0 = bf16_round((1.0 - (xa - i0).abs()).clamp(min=0.0))
    w1 = bf16_round((1.0 - (xa - (i0 + 1.0)).abs()).clamp(min=0.0))
    return i0.long(), w0, w1


def hat_slopes(x01, res: int, i0):
    """Derivatives of the two hat weights of `hat_taps` with respect to the
    scaled coordinate xa = x01 * (res - 1): -sign(xa - i) on the open
    support |xa - i| < 1 and 0 elsewhere (so 0 at an integer xa), for the
    taps i0 and i0 + 1. The reference's d(hat)/dx."""
    xa = x01.clamp(0.0, 1.0) * (res - 1)

    def slope(diff):
        return torch.where(diff.abs() < 1.0, -torch.sign(diff),
                           torch.zeros_like(diff))
    i0 = i0.to(xa.dtype)
    return slope(xa - i0), slope(xa - (i0 + 1.0))


def line_interp(x01, table):
    """Interpolate table [res, R] (read in bf16) at x01 [S] -> [S, R] f32."""
    i0, w0, w1 = hat_taps(x01, table.shape[0])
    t = bf16_round(table.float())
    return w0[:, None] * t[i0] + w1[:, None] * t[i0 + 1]
