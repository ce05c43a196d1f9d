"""Asset IO: PNG read and write, BMP write (the stb_image equivalent,
rt64_texture.cpp:146-187; frame dumping, rt64_device.cpp:1156-1215).

Written on zlib, struct and numpy, so the port reads and writes images
without an imaging library: it reads 8-bit RGB and RGBA, non-interlaced,
with the five row filters of the PNG specification, and writes 8-bit
RGBA with filter 0 (other encoders' bytes differ; the pixels do not).
"""

from __future__ import annotations

import os
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


def _u8(rgba) -> np.ndarray:
    """(H, W, C) uint8, or a float image in [0, 1] rounded to it."""
    arr = np.asarray(rgba)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return arr


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def write_png(path: str, rgba) -> None:
    """Write an (H, W, 4) (or (H, W, 3), alpha 255) image as 8-bit RGBA
    PNG, every row with filter 0."""
    arr = _u8(rgba)
    h, w = arr.shape[:2]
    if arr.shape[2] == 3:
        arr = np.concatenate([arr, np.full((h, w, 1), 255, np.uint8)], -1)
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(arr).reshape(h, w * 4)], 1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))


def write_bmp(path: str, rgba) -> None:
    """The reference's frame-dump format (rt64_device.cpp:1156): 24-bit
    bottom-up BMP of the RGB channels, rows padded to 4 bytes."""
    arr = _u8(rgba)[..., :3]
    h, w = arr.shape[:2]
    stride = (w * 3 + 3) & ~3
    pixels = np.zeros((h, stride), np.uint8)
    pixels[:, : w * 3] = arr[::-1, :, ::-1].reshape(h, w * 3)  # BGR, bottom up
    header = struct.pack("<2sIHHI", b"BM", 54 + pixels.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, pixels.size,
                       2835, 2835, 0, 0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(header + info + pixels.tobytes())
