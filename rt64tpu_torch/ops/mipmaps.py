"""Mip chain generation (numpy, at scene-pack time).

The reference ships a 4-mips-per-dispatch compute shader
(GenerateMipsCS.hlsl, driven by rt64_mipmaps.cpp) but builds it under
``#if 0`` (rt64_device.cpp:758-762), so no shipped configuration
samples mips. This is the equivalent box-filtered chain, baked into the
quad pool for instances that opt in with SHADER_MIP_LOD_ENABLED.
"""

from __future__ import annotations

import numpy as np


def generate_mips(rgba: np.ndarray, max_levels: int = 16):
    """Box-filtered mip chain of an (H, W, 4) uint8 image.

    Returns a list [level0, level1, ...] down to 1x1 (or max_levels).
    Odd dimensions round down like the reference's >>1 sizing
    (rt64_mipmaps.cpp mip loop).
    """
    levels = [rgba]
    cur = rgba.astype(np.float32)
    while len(levels) < max_levels:
        h, w = cur.shape[:2]
        if h <= 1 and w <= 1:
            break
        nh, nw = max(h // 2, 1), max(w // 2, 1)
        ch = cur[: nh * 2, : nw * 2]
        if h > 1 and w > 1:
            down = (
                ch[0::2, 0::2] + ch[1::2, 0::2] + ch[0::2, 1::2] + ch[1::2, 1::2]
            ) * 0.25
        elif h > 1:
            down = (ch[0::2] + ch[1::2]) * 0.5
        else:
            down = (ch[:, 0::2] + ch[:, 1::2]) * 0.5
        cur = down
        levels.append(np.clip(down + 0.5, 0, 255).astype(np.uint8))
    return levels
