"""Density grid <-> occupancy bitfield (port of
sealdnerf_tpu/ops/packbits.py): bit i of byte n is cell n * 8 + i, set
when its density exceeds the threshold (the reference's kernel_packbits).
The renderers read a bool occupancy grid; the bitfield is kept for the
reference's checkpoint layout.
"""

import torch


def _bits(device):
    return torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                        device=device)


def packbits(grid, thresh):
    """grid float [..., 8 * K] -> uint8 [..., K] bitfield (LSB first)."""
    occ = (grid > thresh).reshape(*grid.shape[:-1], -1, 8).to(torch.uint8)
    return (occ * _bits(grid.device)).sum(dim=-1).to(torch.uint8)


def unpackbits(bitfield):
    """uint8 [..., K] -> bool [..., 8 * K] (LSB first)."""
    bits = (bitfield[..., None] & _bits(bitfield.device)) > 0
    return bits.reshape(*bitfield.shape[:-1], -1)
