"""Quad-pool texture sampling: one pool lookup per bilinear fetch.

Replaces the descriptor-heap texture table (gTextures[512],
Textures.hlsli) and the 18 static samplers (rt64_shader.cpp:142-149).
The pool (scene_buffers.build_quad_entries) stores, per texel, the
packed RGBA of itself and its +x/+y/+xy neighbors under the texture's
addressing mode, so a bilinear sample reads one quad.

Addressing of the BASE coordinate happens at sample time (the baked
neighbors only cover the +1 step). Point filtering selects the nearest
of the four fetched corners.

Pool words are uint32 values held in int64 tensors: torch has no
uint32 shifts, and int64 keeps every unpack exact.

Mip chains are opt-in (SHADER_MIP_LOD_ENABLED, diffuse texture only):
the reference builds its mip pass under ``#if 0``
(rt64_device.cpp:758-762), so without the flag SampleGrad is bilinear
level 0.
"""

from __future__ import annotations

import numpy as np
import torch

ADDR_WRAP = 0
ADDR_MIRROR = 1
ADDR_CLAMP = 2

QPR = 32  # quads per wide pool row (the JAX package's layout)

# Mip chains: level l lies in the pool right after level l-1's h*w
# entries, dims halving (floor, min 1) until 1x1 or MAX_MIP_LEVELS —
# the layout scene_buffers.pack_quad_pool bakes and mip_select derives.
MAX_MIP_LEVELS = 8


def mip_select(offset, w, h, level):
    """Per-lane (offset, w, h) of mip level `level` from the LEVEL-0
    record fields, by arithmetic (the chain layout is fixed, so no table
    is read). Levels past the baked chain clamp to the last level.
    offset/w/h: int tensors (N,) or scalars; level: (N,) int32 >= 0.
    Returns three (N,) int32 tensors."""
    dev = level.device
    as_i32 = lambda a: torch.broadcast_to(
        torch.as_tensor(a, device=dev).to(torch.int32), level.shape)
    acc, cur_w, cur_h = as_i32(offset), as_i32(w), as_i32(h)
    out_off, out_w, out_h = acc, cur_w, cur_h
    for l in range(1, MAX_MIP_LEVELS):
        has_level = (cur_w > 1) | (cur_h > 1)  # level l was baked
        acc = acc + cur_w * cur_h
        cur_w = torch.clamp(cur_w >> 1, min=1)
        cur_h = torch.clamp(cur_h >> 1, min=1)
        sel = (level >= l) & has_level
        out_off = torch.where(sel, acc, out_off)
        out_w = torch.where(sel, cur_w, out_w)
        out_h = torch.where(sel, cur_h, out_h)
    return out_off, out_w, out_h


def _remap(x, size, mode):
    """Apply addressing to the CONTINUOUS texel coordinate so the base
    index lands in [0, size-1] and the baked +1 neighbors stay exact.

    Mirror reflects the whole coordinate (equivalent to per-index
    mirroring of both bilinear corners); clamp collapses out-of-range
    samples onto the edge texel, which matches D3D because both true
    corners are then the same texel.
    """
    sizef = size.to(x.dtype)
    wrapped = torch.remainder(x, sizef)
    reflected = sizef - 0.5 - torch.abs(torch.remainder(x + 0.5, 2.0 * sizef) - sizef)
    mirrored = torch.clamp(torch.clamp(reflected, min=0.0), max=sizef - 1.0)
    clamped = torch.clamp(torch.clamp(x, min=0.0), max=sizef - 1.0)
    return torch.where(
        mode == ADDR_WRAP, wrapped,
        torch.where(mode == ADDR_MIRROR, mirrored, clamped),
    )


def pack_pool_wide(pool_np: np.ndarray) -> np.ndarray:
    """(P, 4) quad pool -> CORNER-MAJOR wide rows (P/QPR, 4*QPR): row r,
    lane c*QPR + j holds corner c of quad r*QPR + j. The scene packer
    stores the pool in this layout so a packed scene matches the JAX
    package's field for field."""
    p = pool_np.shape[0]
    assert p % QPR == 0, p
    return (
        pool_np.reshape(p // QPR, QPR, 4)
        .transpose(0, 2, 1)
        .reshape(p // QPR, 4 * QPR)
    )


def pool_quad_count(pool) -> int:
    """Number of quad entries for either pool layout."""
    if pool.ndim == 2 and pool.shape[1] == 4 * QPR:
        return pool.shape[0] * QPR
    return pool.shape[0]


def _gather_quads(pool, flat):
    """(4 corners, N) pool words of the quads at indices `flat` (int64,
    already clamped to the pool). Wide layout: corner c of quad q sits
    at [q // QPR, c * QPR + q % QPR]."""
    if pool.ndim == 2 and pool.shape[1] == 4 * QPR:
        row = flat // QPR
        lane = flat % QPR
        return torch.stack([pool[row, c * QPR + lane] for c in range(4)], 0)
    return pool[flat].movedim(-1, 0)


def _unpack(words):
    """(4, N) uint32 words (int64) -> (4 corners, 4 rgba, N) float in [0,1]."""
    r = (words & 0xFF).to(torch.float32)
    g = ((words >> 8) & 0xFF).to(torch.float32)
    b = ((words >> 16) & 0xFF).to(torch.float32)
    a = ((words >> 24) & 0xFF).to(torch.float32)
    return torch.stack([r, g, b, a], dim=1) * (1.0 / 255.0)


def sample_quad_cols(pool, offset, w, h, valid, u, v, filter_linear,
                     h_addr, v_addr):
    """Sample the quad pool with the record fields given per lane (or
    scalar, broadcast): offset/w/h int-valued tensors, valid (N,) bool,
    u/v (N,) texture coords, filter_linear (N,) bool, h_addr/v_addr (N,)
    int. Returns (4, N) rgba; invalid lanes are transparent black."""
    n = u.shape
    dev = u.device
    as_i32 = lambda a: torch.broadcast_to(
        torch.as_tensor(a, device=dev).to(torch.int32), n
    )
    offset, w, h = as_i32(offset), as_i32(w), as_i32(h)
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)

    x = _remap(u * wf - 0.5, w, h_addr)
    y = _remap(v * hf - 0.5, h, v_addr)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    # Explicit clamps: NaN coordinates (zero-size records of invalid
    # lanes) and any out-of-range index stay inside the pool.
    x0 = torch.clamp(torch.clamp(x0f.to(torch.int32), min=0), max=w - 1)
    y0 = torch.clamp(torch.clamp(y0f.to(torch.int32), min=0), max=h - 1)
    flat = (offset.to(torch.int64) + y0.to(torch.int64) * w + x0).clamp(
        0, pool_quad_count(pool) - 1
    )

    c = _unpack(_gather_quads(pool, flat))  # (4 corners, 4 rgba, N)
    c00, c10, c01, c11 = c[0], c[1], c[2], c[3]

    bilinear = (
        c00 * ((1 - fx) * (1 - fy))[None]
        + c10 * (fx * (1 - fy))[None]
        + c01 * ((1 - fx) * fy)[None]
        + c11 * (fx * fy)[None]
    )
    px = (fx >= 0.5)[None]
    py = (fy >= 0.5)[None]
    point = torch.where(py, torch.where(px, c11, c01), torch.where(px, c10, c00))
    out = torch.where(filter_linear[None], bilinear, point)
    return torch.where(torch.broadcast_to(valid, n)[None], out, 0.0)


def scalar_record(records: np.ndarray, rec_id: int):
    """(offset, w, h) of one record id, read from the host copy of the
    record table. Negative ids clamp to row 0; callers keep masking by
    rec_id >= 0."""
    row = records[max(int(rec_id), 0)]
    return int(row[0]), int(row[1]), int(row[2])
