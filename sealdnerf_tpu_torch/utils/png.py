"""Minimal PNG writer on the standard library's zlib (8-bit gray or RGB),
so that frames can be written where no image library is installed."""

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xffffffff))


def encode_png(img) -> bytes:
    """uint8 [H, W] or [H, W, 3] -> PNG bytes."""
    a = np.ascontiguousarray(img, dtype=np.uint8)
    if a.ndim == 2:
        color = 0
        a = a[..., None]
    elif a.ndim == 3 and a.shape[-1] == 3:
        color = 2
    else:
        raise ValueError(f"expected [H, W] or [H, W, 3], got {a.shape}")
    h, w, c = a.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)],
                         axis=1)                      # filter byte 0 per row
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img):
    with open(path, "wb") as f:
        f.write(encode_png(img))
