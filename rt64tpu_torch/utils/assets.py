"""Asset IO: PNG read (the stb_image equivalent, rt64_texture.cpp:146-187).

A small decoder on zlib, struct and numpy, so the port reads images
without an imaging library: 8-bit RGB and RGBA, non-interlaced, the
five row filters of the PNG specification.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels: RGB, RGBA
_CHANNELS = {2: 3, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters; returns (height, stride) uint8."""
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int64)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype == 1:  # Sub: a running sum per channel
            cur = line.reshape(-1, bpp).cumsum(axis=0).reshape(-1) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = line.copy()
            up = prev.tolist()
            vals = cur.tolist()
            for i in range(stride):
                left = vals[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    upleft = up[i - bpp] if i >= bpp else 0
                    pred = _paeth(left, up[i], upleft)
                vals[i] = (vals[i] + pred) & 0xFF
            cur = np.asarray(vals, np.int64)
        else:
            raise ValueError(f"PNG row filter {ftype} is not defined")
        out[y] = cur
        prev = cur
    return out


def read_image(path: str) -> np.ndarray:
    """Decode a PNG file into (H, W, 4) uint8 RGBA (alpha 255 where the
    file has none)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos = 8
    header = None
    idat = []
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced RGB(A) PNG is read "
            f"(bit depth {depth}, colour type {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    pixels = _unfilter(raw, height, width * ch, ch).reshape(height, width, ch)
    if ch == 3:
        pixels = np.concatenate(
            [pixels, np.full((height, width, 1), 255, np.uint8)], -1)
    return np.ascontiguousarray(pixels)
