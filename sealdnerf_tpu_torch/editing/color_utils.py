"""RGB <-> HSV conversions and the Seal colour modifiers on tensors (port of
sealdnerf_tpu/editing/color_utils.py).

`modify_rgb` keeps the relative lightness of the colours it recolours: their
value minus the mean value of the batch. A caller that recolours a subset of
a batch passes the whole batch's mean as `v_mean`, so that the subset comes
out as it would inside the batch.
"""

import torch


def rgb_to_hsv(rgb, eps: float = 1e-8):
    """rgb: [..., 3] in [0, 1] -> hsv: [..., 3], h in [0, 1)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    v = maxc
    delta = maxc - minc
    s = delta / (maxc + eps)
    rc = (maxc - r) / (delta + eps)
    gc = (maxc - g) / (delta + eps)
    bc = (maxc - b) / (delta + eps)
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta < eps, torch.zeros_like(h), h)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv):
    """hsv: [..., 3], h in [0, 1) -> rgb [..., 3]."""
    h = torch.remainder(hsv[..., 0], 1.0)
    s = hsv[..., 1].clamp(0.0, 1.0)
    v = hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int64), 6)[..., None]
    r = torch.stack([v, q, p, p, t, v], dim=-1).gather(-1, i)[..., 0]
    g = torch.stack([t, v, v, q, p, p], dim=-1).gather(-1, i)[..., 0]
    b = torch.stack([p, p, t, v, v, q], dim=-1).gather(-1, i)[..., 0]
    return torch.stack([r, g, b], dim=-1)


def modify_hsv(rgb, modification):
    """Add an (dh, ds, dv) offset in HSV space."""
    mod = torch.as_tensor(modification, dtype=rgb.dtype, device=rgb.device)
    return hsv_to_rgb(rgb_to_hsv(rgb) + mod.reshape(1, 3))


def modify_rgb(rgb, target_rgb, light_offset: float = 0.0, v_mean=None):
    """Replace hue and saturation with the target colour's (one colour, or
    one per row), keeping each colour's value relative to `v_mean` (None:
    the mean value of `rgb`)."""
    hsv = rgb_to_hsv(rgb)
    target = rgb_to_hsv(torch.as_tensor(target_rgb, dtype=rgb.dtype,
                                        device=rgb.device).reshape(-1, 3))
    raw_v = hsv[..., 2]
    if v_mean is None:
        v_mean = raw_v.mean()
    new_v = (target[..., 2] + (raw_v - v_mean) + light_offset).clamp(0.0, 1.0)
    out = torch.stack([target[..., 0].expand(hsv[..., 0].shape),
                       target[..., 1].expand(hsv[..., 1].shape), new_v],
                      dim=-1)
    return hsv_to_rgb(out)
