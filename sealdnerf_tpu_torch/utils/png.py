"""Minimal PNG writer and reader on the standard library's zlib (8-bit gray,
RGB or RGBA), so that frames can be written and textures read where no image
library is installed."""

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xffffffff))


_COLOR_TYPES = {1: 0, 3: 2, 4: 6}      # channels -> PNG colour type


def encode_png(img) -> bytes:
    """uint8 [H, W], [H, W, 3] or [H, W, 4] -> PNG bytes."""
    a = np.ascontiguousarray(img, dtype=np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[-1] not in _COLOR_TYPES:
        raise ValueError(f"expected [H, W], [H, W, 3] or [H, W, 4], got "
                         f"{a.shape}")
    color = _COLOR_TYPES[a.shape[-1]]
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


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def read_png(path: str):
    """An 8-bit, non-interlaced gray, gray+alpha, RGB or RGBA PNG -> uint8
    [H, W, C] with C its channels (1, 2, 3 or 4)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, color, _, _, interlace = hdr
    chans = {0: 1, 4: 2, 2: 3, 6: 4}.get(color)
    if depth != 8 or chans is None or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB(A) "
                         f"PNGs are read (depth {depth}, colour type "
                         f"{color}, interlace {interlace})")
    stride = w * chans
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype in (0, 2):
            cur = (row + (prev if ftype == 2 else 0)) & 0xff
        elif ftype == 3 or ftype == 1 or ftype == 4:
            # the left neighbour is the reconstructed byte: one pixel a pass
            cur = np.zeros(stride, np.int32)
            for x in range(0, stride, chans):
                left = cur[x - chans:x] if x else np.zeros(chans, np.int32)
                up = prev[x:x + chans]
                if ftype == 1:
                    pred = left
                elif ftype == 3:
                    pred = (left + up) // 2
                else:
                    ul = prev[x - chans:x] if x else np.zeros(chans, np.int32)
                    pred = _paeth(left, up, ul)
                cur[x:x + chans] = (row[x:x + chans] + pred) & 0xff
        else:
            raise ValueError(f"{path}: bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8).reshape(h, w, chans)
