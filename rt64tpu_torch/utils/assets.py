"""Asset IO: PNG read and write, BMP write (the stb_image equivalent,
rt64_texture.cpp:146-187; frame dumping, rt64_device.cpp:1156-1215), and
DDS decode (BC1/BC2/BC3, the DDSTextureLoader equivalent).

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


# --- DDS ------------------------------------------------------------------
#
# Decoded on the host in numpy, top mip only (mipmaps are disabled in the
# reference, rt64_device.cpp:758-762). The block arithmetic is the JAX
# package's, step for step, so both decode BC1-3 to the same bytes.

_DDS_MAGIC = 0x20534444  # 'DDS '


def decode_dds(data: bytes) -> np.ndarray:
    """Decode a DDS file (BC1/BC2/BC3 aka DXT1/3/5, or raw RGBA8) to
    (H, W, 4) uint8."""
    magic, = struct.unpack_from("<I", data, 0)
    if magic != _DDS_MAGIC:
        raise ValueError("not a DDS file")
    height, width = struct.unpack_from("<2I", data, 12)
    pf_flags, fourcc = struct.unpack_from("<2I", data, 4 + 76)
    # dwRGBBitCount and the four masks follow dwFourCC (the JAX package
    # reads them 4 bytes late: ROADMAP queue 3).
    rgb_bitcount, rmask, gmask, bmask, amask = struct.unpack_from(
        "<5I", data, 4 + 84)
    payload_off = 4 + 124
    fourcc_s = struct.pack("<I", fourcc)
    if fourcc_s == b"DX10":
        dxgi_format, = struct.unpack_from("<I", data, payload_off)
        payload_off += 20
        fmt = {71: b"DXT1", 74: b"DXT3", 77: b"DXT5"}.get(dxgi_format)
        if fmt is None:
            raise ValueError(f"unsupported DX10 dxgi format {dxgi_format}")
        fourcc_s = fmt
    payload = np.frombuffer(data, np.uint8, offset=payload_off)
    if pf_flags & 0x4:  # DDPF_FOURCC
        if fourcc_s == b"DXT1":
            return _decode_bc1(payload, width, height)
        if fourcc_s in (b"DXT2", b"DXT3"):
            return _decode_bc2(payload, width, height)
        if fourcc_s in (b"DXT4", b"DXT5"):
            return _decode_bc3(payload, width, height)
        raise ValueError(f"unsupported DDS fourcc {fourcc_s!r}")
    if rgb_bitcount == 32:
        raw = payload[: width * height * 4].reshape(height, width, 4)
        out = np.empty((height, width, 4), np.uint8)
        for c, mask in enumerate((rmask, gmask, bmask)):
            out[..., c] = raw[..., _mask_index(mask)]
        out[..., 3] = raw[..., _mask_index(amask)] if amask else 255
        return out
    raise ValueError("unsupported uncompressed DDS layout")


def _mask_index(mask: int) -> int:
    return {0xFF: 0, 0xFF00: 1, 0xFF0000: 2, 0xFF000000: 3}.get(mask, 0)


def _bc_color_palette(blocks: np.ndarray, bc1_punch: bool) -> np.ndarray:
    """blocks: (B, 2) uint16 c0/c1 -> palette (B, 4, 4) uint8 rgba. BC1
    blocks with c0 <= c1 take three colours and a transparent black."""
    c0 = blocks[:, 0].astype(np.uint32)
    c1 = blocks[:, 1].astype(np.uint32)

    def expand(c):
        r = ((c >> 11) & 0x1F).astype(np.float32) * (255.0 / 31.0)
        g = ((c >> 5) & 0x3F).astype(np.float32) * (255.0 / 63.0)
        b = (c & 0x1F).astype(np.float32) * (255.0 / 31.0)
        return np.stack([r, g, b], -1)

    p0 = expand(c0)
    p1 = expand(c1)
    four = ~(bc1_punch & (c0 <= c1))
    p2 = np.where(four[:, None], (2 * p0 + p1) / 3.0, (p0 + p1) / 2.0)
    p3 = np.where(four[:, None], (p0 + 2 * p1) / 3.0, 0.0)
    pal = np.stack([p0, p1, p2, p3], axis=1)  # (B, 4, 3)
    alpha = np.full(pal.shape[:2] + (1,), 255.0, np.float32)
    if bc1_punch:
        alpha[:, 3, 0] = np.where(four, 255.0, 0.0)
    return np.concatenate([pal, alpha], -1).round().astype(np.uint8)


def _bc_color_indices(rows: np.ndarray) -> np.ndarray:
    """rows: (B, 4) uint8 -> (B, 16) 2-bit indices, texel r * 4 + c."""
    shifts = np.arange(4, dtype=np.uint8) * 2
    return ((rows[:, :, None] >> shifts) & 0x3).reshape(rows.shape[0], 16)


def _assemble_blocks(texels: np.ndarray, width: int, height: int) -> np.ndarray:
    """texels: (B, 16, 4) block texels -> (H, W, 4) image."""
    bw = (width + 3) // 4
    bh = (height + 3) // 4
    img = texels.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(img.reshape(bh * 4, bw * 4, 4)[:height, :width])


def _blocks(payload, width, height, block_bytes):
    n = ((width + 3) // 4) * ((height + 3) // 4)
    return payload[: n * block_bytes].reshape(n, block_bytes)


def _colour_texels(raw, bc1_punch: bool) -> np.ndarray:
    """(B, 16, 4) texels of the colour half of each block (its last 8
    bytes: c0, c1, four rows of 2-bit indices)."""
    colors = raw[:, -8:-4].copy().view(np.uint16)
    pal = _bc_color_palette(colors, bc1_punch)
    idx = _bc_color_indices(raw[:, -4:])
    return np.take_along_axis(pal, idx[..., None].astype(np.int64), 1)


def _decode_bc1(payload, width, height):
    texels = _colour_texels(_blocks(payload, width, height, 8), bc1_punch=True)
    return _assemble_blocks(texels, width, height)


def _decode_bc2(payload, width, height):
    """BC2: explicit 4-bit alpha, texel r * 4 + c at bits 4c of row r."""
    raw = _blocks(payload, width, height, 16)
    texels = _colour_texels(raw, bc1_punch=False)
    a16 = raw[:, :8].copy().view(np.uint16)
    shifts = np.arange(4, dtype=np.uint16) * 4
    alpha = ((a16[:, :, None] >> shifts) & 0xF) * 17
    texels[..., 3] = alpha.reshape(-1, 16).astype(np.uint8)
    return _assemble_blocks(texels, width, height)


def _decode_bc3(payload, width, height):
    """BC3: interpolated alpha, two endpoints and 16 3-bit indices."""
    raw = _blocks(payload, width, height, 16)
    texels = _colour_texels(raw, bc1_punch=False)
    a0 = raw[:, 0].astype(np.float32)
    a1 = raw[:, 1].astype(np.float32)
    apal = np.zeros((raw.shape[0], 8), np.float32)
    apal[:, 0] = a0
    apal[:, 1] = a1
    eight = a0 > a1  # 8-alpha mode vs 6-alpha + 0/255 mode
    for i in range(2, 8):
        v8 = ((8 - i) * a0 + (i - 1) * a1) / 7.0
        if i <= 5:
            v6 = ((6 - i) * a0 + (i - 1) * a1) / 5.0
        elif i == 6:
            v6 = np.zeros_like(a0)
        else:
            v6 = np.full_like(a0, 255.0)
        apal[:, i] = np.where(eight, v8, v6)
    bits = np.zeros(raw.shape[0], np.uint64)
    for i in range(6):
        bits |= raw[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)
    shifts = np.arange(16, dtype=np.uint64) * np.uint64(3)
    aidx = ((bits[:, None] >> shifts) & np.uint64(0x7)).astype(np.int64)
    alpha = np.take_along_axis(apal, aidx, 1)
    texels[..., 3] = alpha.round().astype(np.uint8)
    return _assemble_blocks(texels, width, height)


def read_ppm(path: str) -> np.ndarray:
    """Read a binary (P6) 8-bit PPM, as the sample hosts write it, into
    (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:  # magic, width, height, maxval
        while data[pos : pos + 1].isspace():
            pos += 1
        end = pos
        while not data[end : end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    if fields[0] != b"P6" or fields[3] != b"255":
        raise ValueError(f"{path} is not an 8-bit binary PPM")
    w, h = int(fields[1]), int(fields[2])
    pixels = np.frombuffer(data, np.uint8, w * h * 3, pos + 1)
    return pixels.reshape(h, w, 3).copy()
