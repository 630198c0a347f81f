"""3-D Morton (Z-order) codes (port of sealdnerf_tpu/ops/morton.py): the
reference's __morton3D and __morton3D_invert bit-twiddling, vectorised.

Coordinates lie in [0, 1024) (10 bits an axis, 30-bit codes), which covers
the 128^3 grids of the package. The occupancy grids here are in raster
(x-major) order, as in the JAX package; these functions are kept for the
API. The arithmetic runs in int64, masked to the low 32 bits where the
reference's uint32 products would wrap.
"""

import torch

_U32 = 0xFFFFFFFF


def _expand_bits(v):
    """v in [0, 1024): two zero bits between consecutive bits."""
    v = (v * 0x00010001) & _U32 & 0xFF0000FF
    v = (v * 0x00000101) & _U32 & 0x0F00F00F
    v = (v * 0x00000011) & _U32 & 0xC30C30C3
    v = (v * 0x00000005) & _U32 & 0x49249249
    return v


def _compact_bits(v):
    v = v & 0x49249249
    v = (v | (v >> 2)) & 0xC30C30C3
    v = (v | (v >> 4)) & 0x0F00F00F
    v = (v | (v >> 8)) & 0xFF0000FF
    v = (v | (v >> 16)) & 0x0000FFFF
    return v


def morton3d(coords):
    """Integer coords [..., 3] in [0, 1024) -> int32 Morton codes [...]."""
    c = coords.long()
    code = (_expand_bits(c[..., 0]) | (_expand_bits(c[..., 1]) << 1)
            | (_expand_bits(c[..., 2]) << 2))
    return code.int()


def morton3d_invert(codes):
    """Morton codes [...] -> int32 coords [..., 3]."""
    v = codes.long() & _U32
    return torch.stack([_compact_bits(v), _compact_bits(v >> 1),
                        _compact_bits(v >> 2)], dim=-1).int()
