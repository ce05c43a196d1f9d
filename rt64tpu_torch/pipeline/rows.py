"""Packed-row data layout (the counterpart of ``rt64tpu/pipeline/rows.py``).

Everything a shading point needs lives in ONE wide row per triangle:

  vertex rows  (V, VROW)  — object-space attrs, packed at mesh upload
  instance rows (I, IROW) — transforms + material + combiner + light
                            group mask, per frame
  triangle rows (T, TROW) — world-space, built per frame from
                            vertex+instance rows; one gather per hit
                            serves the tracer and every shading stage

The column offsets are those of the JAX package but for the light
columns: where the JAX package keeps one eligibility column per light
slot (16 of them), a row here keeps the instance's light group mask, so
a scene may hold any number of lights (convert.py maps the one form to
the other).
"""

from __future__ import annotations

import torch

# ---- vertex rows (object space; epoch-packed on host) ---------------------
V_POS = 0  # 3
V_NRM = 3  # 3
V_UV = 6  # 2
V_IN1 = 8  # 4
V_IN2 = 12  # 4
VROW = 16

# ---- instance rows (per frame; host-packed) --------------------------------
I_M3 = 0  # 9: objectToWorld upper 3x3, row-major
I_TR = 9  # 3: translation
I_NM3 = 12  # 9: objectToWorldNormal 3x3
I_PM3 = 21  # 9: previous 3x3
I_PTR = 30  # 3: previous translation
I_MAT = 33  # 28 material floats (M_* offsets below, relative)
I_CC = 61  # 1: packed combiner cycles (24 bits)
I_FLAGS = 62  # 1: packed flag bits (F_* below)
I_TEX_D = 63  # diffuse quad-pool record id (or -1)
I_TEX_N = 64  # normal map record id
I_TEX_S = 65  # specular map record id
I_SAMPLER = 66  # filter + 4*h_addr + 16*v_addr
I_LMASK = 67  # 2: light_group_mask_bits, low and high 16 bits (pack_mask)
I_INPUT_COUNT = 69
I_VIEWPORT = 70  # 4: x, y, w, h (0 w/h = full target) — raster path
I_SCISSOR = 74  # 4: x, y, w, h (0 w/h = disabled)
I_TEX_D2 = 78  # TEXEL1 quad-pool record id (or -1)
I_REC = 79  # 12: baked quad-pool records (offset, w, h) for the
            # diffuse / TEXEL1 / normal / specular textures, so sampling
            # needs no per-pixel record lookup
IROW = 91

# material float sub-layout (relative to I_MAT / T_MAT)
M_IGNORE_NORMAL = 0
M_UV_DETAIL = 1
M_REFLECTION = 2
M_REFL_FRESNEL = 3
M_REFL_SHINE = 4
M_REFRACTION = 5
M_SPECULAR = 6  # 3
M_SPEC_EXP = 9
M_SOLID_ALPHA = 10
M_SHADOW_ALPHA = 11
M_DEPTH_BIAS = 12
M_SHADOW_RAY_BIAS = 13
M_SELF_LIGHT = 14  # 3
M_FOG_COLOR = 17  # 3
M_DIFFUSE_MIX = 20  # 4
M_FOG_MUL = 24
M_FOG_OFFSET = 25
M_FOG_ENABLED = 26
M_LOCK = 27
M_WIDTH = 28

# flag bits in I_FLAGS / T_FLAGS (float-encoded small int)
F_OPT_ALPHA = 1 << 0
F_TEXTURE_EDGE = 1 << 1
F_NOISE = 1 << 2
F_ALPHA_SAME = 1 << 3
F_USE_T0 = 1 << 4
F_USE_T1 = 1 << 5
F_NORMAL_MAP = 1 << 6
F_SPECULAR_MAP = 1 << 7
F_NO_CULL = 1 << 8
F_ALPHA_CLASS = 1 << 9
F_HAS_LIGHTING = 1 << 10
F_MIP_LOD = 1 << 11  # ray-diff mip LOD on the diffuse fetch

# ---- triangle rows (world space; per frame) --------------------------------
T_P0 = 0  # 3 world corner 0
T_P1 = 3
T_P2 = 6
T_N0 = 9  # 3 world corner normals
T_N1 = 12
T_N2 = 15
T_UV = 18  # 6: u0 v0 u1 v1 u2 v2
T_IN1 = 24  # 12: input1 rgba x3 corners
T_IN2 = 36  # 12
T_PP0 = 48  # 9: previous-frame world corners (for vertexFlow)
T_PP1 = 51
T_PP2 = 54
T_INST = 57
T_MAT = 58  # 28 (copy of instance material block)
T_CC = 86
T_FLAGS = 87
T_TEX_D = 88
T_TEX_N = 89
T_TEX_S = 90
T_SAMPLER = 91
T_LMASK = 92  # 2: the instance's light group mask (see I_LMASK)
T_INPUT_COUNT = 94
T_TEX_D2 = 95  # TEXEL1 record id
T_REC = 96  # 12: baked texture records (see I_REC)
TROW = 108

# A light group mask is 32 bits; a float32 holds integers exactly up to
# 2^24, so the mask rides a row as two exact 16-bit halves. A light l
# lights a point when (mask & groupBits[l]) != 0 (Lights.hlsli:127-130),
# tested on the device for every light (ops/lighting.plan_lights).
LMASK_HALF = 1 << 16

# ---- compact context rows (post-resolve per-pixel gathers) -----------------
# The resolved per-pixel winner's row is re-gathered at full pixel width
# for lighting context and reflection/refraction state; those consumers
# read only these 12 of the TROW columns (framegraph._ctx_table).
CTX_FLAGS = 0  # T_FLAGS
CTX_IGNORE_NORMAL = 1  # T_MAT + M_IGNORE_NORMAL
CTX_SPEC_EXP = 2  # T_MAT + M_SPEC_EXP
CTX_SHADOW_RAY_BIAS = 3  # T_MAT + M_SHADOW_RAY_BIAS
CTX_SELF_LIGHT = 4  # 3: T_MAT + M_SELF_LIGHT
CTX_REFL_FRESNEL = 7  # T_MAT + M_REFL_FRESNEL
CTX_REFL_SHINE = 8  # T_MAT + M_REFL_SHINE
CTX_REFRACTION = 9  # T_MAT + M_REFRACTION
CTX_LMASK = 10  # 2: T_LMASK
CTXROW = CTX_LMASK + 2  # 12

# (start, length) TROW column runs concatenated into the ctx table, in
# CTX_* order.
CTX_RUNS = (
    (T_FLAGS, 1),
    (T_MAT + M_IGNORE_NORMAL, 1),
    (T_MAT + M_SPEC_EXP, 1),
    (T_MAT + M_SHADOW_RAY_BIAS, 1),
    (T_MAT + M_SELF_LIGHT, 3),
    (T_MAT + M_REFL_FRESNEL, 2),  # fresnel, shine (adjacent)
    (T_MAT + M_REFRACTION, 1),
    (T_LMASK, 2),
)
assert sum(r[1] for r in CTX_RUNS) == CTXROW


def pack_cc(c0, c1) -> float:
    """Pack the two combiner cycles (4x3 bits each) into one f32-exact
    integer (24 bits total, exact below 2^24)."""
    v = 0
    for i in range(4):
        v |= (c0[i] & 7) << (i * 3)
        v |= (c1[i] & 7) << (12 + i * 3)
    return float(v)


def unpack_cc(packed: torch.Tensor) -> torch.Tensor:
    """(...,) float -> (..., 8) int32 combiner items [c0 x4, c1 x4]."""
    v = packed.to(torch.int32)
    items = [(v >> (i * 3)) & 7 for i in range(4)]
    items += [(v >> (12 + i * 3)) & 7 for i in range(4)]
    return torch.stack(items, dim=-1)


def pack_mask(mask: int) -> tuple:
    """A 32-bit light group mask as its two f32-exact 16-bit halves
    (I_LMASK, I_LMASK + 1)."""
    m = int(mask) & 0xFFFFFFFF
    return float(m % LMASK_HALF), float(m // LMASK_HALF)


def unpack_mask(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(...,) float halves -> (...,) int32 with the mask's 32 bits (bit 31
    the sign bit: the int64 sum wraps on the cast)."""
    return (lo.to(torch.int64) + hi.to(torch.int64) * LMASK_HALF).to(
        torch.int32)
