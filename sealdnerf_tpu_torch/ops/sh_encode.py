"""Real spherical-harmonics direction encoding, degree 1..8 (port of
sealdnerf_tpu/ops/sh_encode.py).

Same associated-Legendre recurrence and component order (l = 0..deg-1,
m = -l..l, Condon-Shortley phase) as the reference module.
"""

import math

import torch


def sh_output_dim(degree: int) -> int:
    return degree * degree


def sh_coeff(l: int, m: int) -> float:
    """K_l^m = sqrt((2l+1)/(4 pi) (l-m)!/(l+m)!)."""
    return math.sqrt(
        (2 * l + 1) / (4.0 * math.pi) * math.factorial(l - m)
        / math.factorial(l + m))


def double_factorial(n: int) -> int:
    out = 1
    while n > 1:
        out *= n
        n -= 2
    return out


def sh_encode(d, degree: int = 4):
    """Encode unit directions [..., 3] -> [..., degree**2]."""
    if not (1 <= degree <= 8):
        raise ValueError(f"SH degree must be in [1, 8], got {degree}")
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    C = [torch.ones_like(x)]
    S = [torch.zeros_like(x)]
    for m in range(1, degree):
        C.append(x * C[m - 1] - y * S[m - 1])
        S.append(x * S[m - 1] + y * C[m - 1])
    P = {}
    for m in range(degree):
        P[(m, m)] = torch.full_like(
            z, ((-1.0) ** m) * double_factorial(2 * m - 1))
        if m + 1 < degree:
            P[(m + 1, m)] = (2 * m + 1) * z * P[(m, m)]
        for l in range(m + 2, degree):
            P[(l, m)] = ((2 * l - 1) * z * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)
    out = []
    sqrt2 = math.sqrt(2.0)
    for l in range(degree):
        for m in range(-l, l + 1):
            am = abs(m)
            if m == 0:
                out.append(sh_coeff(l, 0) * P[(l, 0)])
            elif m > 0:
                out.append(sqrt2 * sh_coeff(l, am) * P[(l, am)] * C[am])
            else:
                out.append(sqrt2 * sh_coeff(l, am) * P[(l, am)] * S[am])
    return torch.stack(out, dim=-1)
