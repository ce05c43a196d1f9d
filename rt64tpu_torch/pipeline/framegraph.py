"""The frame graph: one call per frame, planar layout.

Reimplements View::render's pass DAG (rt64_view.cpp:1180-1667) as plain
functions over device-resident planes:

    build tri rows (TLAS/BLAS refit analog)
    -> primary (trace + shade + alpha resolve, ray-differential mip LOD
       on opted-in diffuse textures) -> batched shadow launch
    -> direct -> indirect (1-bounce GI, reprojected history)
    -> refraction -> reflection bounces (max_reflections)
    -> GI denoise filter -> compose -> upscale to the display size
       (FSR/XeSS temporal accumulators, the learned DLSS slot, or a
       bilinear resize) -> RCAS -> motion blur or debug view
    -> raster foreground

with the raster background composited over the host's base plane first
(ops/raster.py): primary misses read it on the pixel grid, bounce and
mirror misses as an environment map.

All per-pixel data is planar ((C, N) / (C, H, W)) in the tile-swizzled
pixel order, so each 512-ray block is an 8x64 screen tile. Raygen math
mirrors the HLSL raygen shaders (citations inline). Display-size
images are row-major (3, DH, DW).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from rt64tpu_torch import descriptors as d
from rt64tpu_torch.models import learned_upscaler
from rt64tpu_torch.models import upscaler as ups
from rt64tpu_torch.ops import (bluenoise, filters, fog, lighting, raster,
                                raydiff, sky, tracer)
from rt64tpu_torch.ops import random as rnd
from rt64tpu_torch.ops import shading as shade_ops
from rt64tpu_torch.ops import tracer_cuda
from rt64tpu_torch.ops import vecmath as vm
from rt64tpu_torch.pipeline import rows as R
from rt64tpu_torch.pipeline.scene_buffers import SceneBuffers
from rt64tpu_torch.utils import profiling

EPSILON = 1e-6
APPLY_LIGHTS_MINIMUM_ALPHA = 0.5  # Constants.hlsli
_BIG = 3.0e37


@dataclass(frozen=True)
class RenderConfig:
    """Shape-determining configuration of a frame."""

    rt_width: int
    rt_height: int
    display_width: int
    display_height: int
    di_samples: int = 1
    gi_samples: int = 1
    max_lights: int = 12
    max_reflections: int = 2  # rt64_view.cpp:60
    k_primary: int = 4  # alpha hit slots (<= MAX_HIT_QUERIES 16)
    k_secondary: int = 2
    # Alpha hit slots a shadow ray, their alphas summed as RT64's shadow
    # any-hit sums every layer: a ray to a low light through foliage
    # crosses leaves behind a clear texel of the first.
    k_shadow: int = 4
    motion_blur_samples: int = 32  # rt64_view.cpp:53
    motion_blur_enabled: bool = True
    denoiser_enabled: bool = False
    gi_filter_passes: int = 5  # rt64_view.cpp:1512-1530
    upscaler: int = 0
    alpha_cap: int = 256  # compacted alpha triangle list capacity
    refraction_enabled: bool = True
    # Compacted-shade capacity multiplier: grown when a frame reports
    # alpha_dropped > 0 (view.py).
    alpha_shade_boost: int = 1
    # RCAS gate: the view sets it when an upscaler runs with a sharpness
    # above 0 (gp.upscaler_sharpness carries the strength).
    sharpen_enabled: bool = False
    # Row tiling (parallel/tiling.py): rt_height and display_height are
    # this band's rows; full_height is the whole frame's (0: unbanded).
    full_height: int = 0

    @property
    def grid_height(self) -> int:
        """Render rows of the whole frame: screen-space math (ray
        directions, flow, the sky's uv, reprojection bounds) uses it."""
        return self.full_height or self.rt_height

    @property
    def display_grid_height(self) -> int:
        """Display rows of the whole frame."""
        if not self.full_height:
            return self.display_height
        return self.display_height * (self.full_height // self.rt_height)

    # Tile-swizzled ray order: each 8x64 pixel tile is contiguous in the
    # flat pixel axis, so the packet tracer's 512-ray blocks are compact
    # screen tiles (tight cluster culling). Per-pixel math is
    # order-independent, so results are identical either way.
    TILE_H = 8
    TILE_W = 64

    @property
    def tiled(self) -> bool:
        return (
            self.rt_width % self.TILE_W == 0
            and self.rt_height % self.TILE_H == 0
        )


class GlobalParams(NamedTuple):
    """Per-frame parameters (GlobalParams.hlsli:8-43), tensors on the
    frame's device, but for pixel_jitter: the view computes the jitter
    once on the host, and the rays, the fixed-grid background and the
    sky sample all read that one value."""

    view: torch.Tensor
    view_i: torch.Tensor
    prev_view_i: torch.Tensor
    projection: torch.Tensor
    projection_i: torch.Tensor
    view_proj: torch.Tensor
    prev_view_proj: torch.Tensor
    camera_u: torch.Tensor
    camera_v: torch.Tensor
    camera_w: torch.Tensor
    pixel_jitter: tuple  # (x, y) host floats, f32 values
    ambient_base: torch.Tensor  # (3,)
    ambient_no_gi: torch.Tensor
    eye_light_diffuse: torch.Tensor
    eye_light_specular: torch.Tensor
    sky_diffuse_mult: torch.Tensor
    sky_hsl_mod: torch.Tensor
    sky_yaw_offset: torch.Tensor
    gi_diffuse_strength: torch.Tensor
    gi_sky_strength: torch.Tensor
    motion_blur_strength: torch.Tensor
    sky_plane_rec: torch.Tensor  # int32 quad-pool record (-1 = none)
    frame_count: torch.Tensor  # int64 holding a uint32
    di_reproject: torch.Tensor  # bool
    gi_reproject: torch.Tensor  # bool
    binary_lock_mask: torch.Tensor  # bool
    # resetAccumulation of the temporal upscalers (rt64_upscaler.h:40).
    temporal_reset: torch.Tensor  # bool
    # upscalerSharpness (rt64_upscaler.h:25-41): the RCAS strength when
    # cfg.sharpen_enabled (rt64_fsr.cpp:141-166, rt64_dlss.cpp:205).
    upscaler_sharpness: torch.Tensor  # f32


class History(NamedTuple):
    """Temporal state (prev buffers, rt64_view.h:99-110). Flat planes."""

    normal: torch.Tensor  # (3, N)
    depth: torch.Tensor  # (N,)
    direct: torch.Tensor  # (4, N) rgb + history length
    indirect: torch.Tensor  # (4, N)

    @staticmethod
    def zeros(h: int, w: int, device) -> "History":
        n = h * w
        z = lambda *s: torch.zeros(s, device=device)
        return History(normal=z(3, n), depth=z(n), direct=z(4, n),
                       indirect=z(4, n))


class GBuffers(NamedTuple):
    """Primary-pass outputs (GlobalBuffers.hlsli u0-u15), planar."""

    view_dir: torch.Tensor  # (3, N)
    position: torch.Tensor  # (3, N)
    normal: torch.Tensor  # (3, N)
    specular: torch.Tensor  # (3, N)
    diffuse_rgb: torch.Tensor  # (3, N)
    diffuse_a: torch.Tensor  # (N,)
    instance: torch.Tensor  # (N,) int32 (-1 none)
    transparent: torch.Tensor  # (3, N)
    flow: torch.Tensor  # (2, N) screen-pixel motion
    reactive: torch.Tensor  # (N,)
    lock: torch.Tensor  # (N,)
    depth: torch.Tensor  # (N,)
    refl_alpha: torch.Tensor  # (N,)
    refr_alpha: torch.Tensor  # (N,)
    row: torch.Tensor  # (R.CTXROW, N) stored-hit context row (rows.py CTX_*)
    alpha_dropped: torch.Tensor  # () — alpha hits beyond shade capacity


class FrameOutputs(NamedTuple):
    image: torch.Tensor  # (3, DH, DW) linear float
    history: History
    gbuffers: GBuffers
    direct_accum: torch.Tensor  # (4, N)
    indirect_accum: torch.Tensor  # (4, N)
    filtered_direct: torch.Tensor  # (3, N)
    filtered_indirect: torch.Tensor  # (3, N)
    reflection: torch.Tensor  # (3, N)
    refraction: torch.Tensor  # (3, N)
    rt_output: torch.Tensor  # (3, H, W)
    alpha_dropped: torch.Tensor  # () (see GBuffers.alpha_dropped)
    # The temporal upscaler's display-size state when the FSR or XeSS
    # slot ran (the next frame's `temporal`); else None.
    temporal: Optional[torch.Tensor] = None


def make_trace_scene(sb, rows_t, alpha_cap: int) -> tracer.TraceScene:
    """Tracer view over the triangle rows."""
    flags = rows_t[R.T_FLAGS].to(torch.int32)
    alpha = ((flags & R.F_ALPHA_CLASS) != 0) & sb.tri_valid
    no_cull = (flags & R.F_NO_CULL) != 0
    bias = rows_t[R.T_MAT + R.M_DEPTH_BIAS]
    v0 = rows_t[R.T_P0 : R.T_P0 + 3]
    v1 = rows_t[R.T_P1 : R.T_P1 + 3]
    v2 = rows_t[R.T_P2 : R.T_P2 + 3]
    alpha_idx = tracer.sort_alpha_spatial(
        tracer.compact_alpha(sb.tri_valid, alpha, alpha_cap), v0, v1, v2
    )
    return tracer.TraceScene(
        v0=v0, v1=v1, v2=v2, valid=sb.tri_valid, alpha=alpha,
        no_cull=no_cull, bias=bias, alpha_idx=alpha_idx,
        has_alpha=sb.features.has_alpha,
    )


def _pixel_grid(cfg: RenderConfig, device, row_offset: int = 0):
    """(N, 2) int (x, y) of every pixel in the frame's order; y is
    global under row tiling (the band starts at row_offset)."""
    h, w = cfg.rt_height, cfg.rt_width
    xx = torch.arange(w, dtype=torch.int32, device=device)
    yy = torch.arange(h, dtype=torch.int32, device=device) + row_offset
    px = xx[None, :].expand(h, w)
    py = yy[:, None].expand(h, w)
    if cfg.tiled:
        px = _from_image_1(cfg, px)
        py = _from_image_1(cfg, py)
    else:
        px = px.reshape(-1)
        py = py.reshape(-1)
    return torch.stack([px, py], dim=-1)  # (N, 2) int


def _from_image_1(cfg, img_hw):
    """(H, W) -> flat swizzled (N,): pure reshape/transpose."""
    th, tw = cfg.TILE_H, cfg.TILE_W
    h, w = img_hw.shape
    return (
        img_hw.reshape(h // th, th, w // tw, tw)
        .permute(0, 2, 1, 3)
        .reshape(-1)
    )


def from_image(cfg, img):
    """(C, H, W) -> (C, N) in the frame's pixel order."""
    c, h, w = img.shape
    if not cfg.tiled:
        return img.reshape(c, -1)
    th, tw = cfg.TILE_H, cfg.TILE_W
    return (
        img.reshape(c, h // th, th, w // tw, tw)
        .permute(0, 1, 3, 2, 4)
        .reshape(c, -1)
    )


def to_image(cfg, plane):
    """(C, N) -> (C, H, W) undoing the frame's pixel order."""
    h, w = cfg.rt_height, cfg.rt_width
    squeeze = plane.ndim == 1
    if squeeze:
        plane = plane[None]
    c = plane.shape[0]
    if not cfg.tiled:
        out = plane.reshape(c, h, w)
    else:
        th, tw = cfg.TILE_H, cfg.TILE_W
        out = (
            plane.reshape(c, h // th, w // tw, th, tw)
            .permute(0, 1, 3, 2, 4)
            .reshape(c, h, w)
        )
    return out[0] if squeeze else out


def flat_index(cfg, x, y):
    """Flat pixel index of integer coords (x, y) in the frame's order
    (the y*W+x analog; used by reprojection gathers). Coordinates are
    global under row tiling: the bands of one tiling, concatenated, are
    the whole frame's planes in that tiling."""
    w = cfg.rt_width
    if not cfg.tiled:
        return y * w + x
    th, tw = cfg.TILE_H, cfg.TILE_W
    block = (y // th) * (w // tw) + x // tw
    within = (y % th) * tw + (x % tw)
    return block * (th * tw) + within


def primary_rays(cfg: RenderConfig, gp: GlobalParams, row_offset: int = 0):
    """Camera ray setup (PrimaryRayGen.hlsl:33-40): planar origin (3, N)
    and NON-normalized direction (3, N), exactly like the reference."""
    pix = _pixel_grid(cfg, gp.view.device, row_offset)
    w, h = cfg.rt_width, cfg.grid_height
    dx = ((pix[:, 0].to(torch.float32) + 0.5 + gp.pixel_jitter[0]) / w) * 2.0 - 1.0
    dy = ((pix[:, 1].to(torch.float32) + 0.5 + gp.pixel_jitter[1]) / h) * 2.0 - 1.0
    pi = gp.projection_i
    # target = [dx, -dy, 1, 1] @ projI (xyz components)
    tx = dx * pi[0, 0] - dy * pi[1, 0] + pi[2, 0] + pi[3, 0]
    ty = dx * pi[0, 1] - dy * pi[1, 1] + pi[2, 1] + pi[3, 1]
    tz = dx * pi[0, 2] - dy * pi[1, 2] + pi[2, 2] + pi[3, 2]
    vi = gp.view_i
    ddx = tx * vi[0, 0] + ty * vi[1, 0] + tz * vi[2, 0]
    ddy = tx * vi[0, 1] + ty * vi[1, 1] + tz * vi[2, 1]
    ddz = tx * vi[0, 2] + ty * vi[1, 2] + tz * vi[2, 2]
    dirs = torch.stack([ddx, ddy, ddz], 0)
    origin = vi[3, :3][:, None].expand(dirs.shape)
    return pix, origin, dirs


def _noise_rand(cfg, gp, pix):
    """Per-pixel combiner-noise random (rt64_shader.cpp:513-516)."""
    flat = pix[:, 0].to(torch.int64) + pix[:, 1].to(torch.int64) * cfg.rt_width
    seed = rnd.init_rand(flat, gp.frame_count)
    _, val = rnd.next_rand(seed)
    return val


def world_to_screen(vp, pos):
    """WorldToScreenPos, planar: pos (3, N) -> (u, v) each (N,)."""
    cx = pos[0] * vp[0, 0] + pos[1] * vp[1, 0] + pos[2] * vp[2, 0] + vp[3, 0]
    cy = pos[0] * vp[0, 1] + pos[1] * vp[1, 1] + pos[2] * vp[2, 1] + vp[3, 1]
    cw = pos[0] * vp[0, 3] + pos[1] * vp[1, 3] + pos[2] * vp[2, 3] + vp[3, 3]
    return 0.5 + 0.5 * cx / cw, 0.5 + 0.5 * cy / cw


def _screen_depth(vp, pos):
    cz = pos[0] * vp[0, 2] + pos[1] * vp[1, 2] + pos[2] * vp[2, 2] + vp[3, 2]
    cw = pos[0] * vp[0, 3] + pos[1] * vp[1, 3] + pos[2] * vp[2, 3] + vp[3, 3]
    return cz / cw


def _fresnel(normal, incident, reflectivity, fresnel_multiplier):
    """FresnelReflectAmount (PrimaryRayGen.hlsl:26-30)."""
    dd = vm.dot(normal, incident)
    ret = torch.pow(torch.clamp(1.0 + dd, EPSILON, 1.0), 5.0)
    return reflectivity + (1.0 - reflectivity) * ret * fresnel_multiplier


def _pack_rows(carry):
    """Flatten a carry tuple of (N,) / (C, N) tensors into one (R, N)
    float32 matrix (bool -> 0/1, integers -> int32 bit patterns) so a
    compacted-space carry merges back with one gather."""
    rows = []
    for a in carry:
        if a.dtype == torch.bool:
            a = a.to(torch.float32)
        elif not a.is_floating_point():
            a = a.to(torch.int32).view(torch.float32)
        rows.append(a[None] if a.ndim == 1 else a)
    return torch.cat(rows, 0)


def _unpack_rows(packed, proto):
    """Inverse of _pack_rows, using `proto` for shapes/dtypes. Bools
    were packed as exact 0.0/1.0, so > 0.5 restores them."""
    out, r = [], 0
    for a in proto:
        c = 1 if a.ndim == 1 else a.shape[0]
        got = packed[r : r + c]
        r += c
        if a.ndim == 1:
            got = got[0]
        if a.dtype == torch.bool:
            got = got > 0.5
        elif not a.is_floating_point():
            got = got.contiguous().view(torch.int32).to(a.dtype)
        out.append(got)
    return tuple(out)


def _prefix_rank(mask):
    """Exclusive prefix count of a (N,) bool mask — lane j's slot in the
    compact_indices ordering."""
    m = mask.to(torch.int64)
    return torch.cumsum(m, 0) - m


def _scatter_carry(full, comp, mask):
    """Merge a compacted-space carry into its full-width counterpart.
    Gather-side: each candidate lane's slot is its prefix rank; lanes
    past the compaction capacity keep the full-width value."""
    fp = _pack_rows(full)
    cp = _pack_rows(comp)
    p = _prefix_rank(mask)
    cap = cp.shape[1]
    sel = mask & (p < cap)
    got = cp[:, torch.where(sel, p, 0)]
    return _unpack_rows(torch.where(sel[None], got, fp), full)


def _fold_shaded_slots(
    sb, tri_rows, trace_scene, origins, dirs, t_min, t_max, k_alpha,
    noise_rand, cfg, make_carry, slot_fn, cull_backface=True, aux=(),
    mip_diffs=None, regroup=None, frame_lanes=None,
):
    """Trace, then fold slot_fn front-to-back over the K+1 ordered hit
    slots (alpha..., opaque last).

    make_carry(origins, dirs, aux) builds the initial carry at the width
    of its arguments; slot_fn(carry, sh: HitShade, t_s, origins, dirs,
    aux) folds one slot. When the scene has alpha geometry, the K alpha
    slots are traced, shaded and RESOLVED in compacted ray space (one
    cull + compaction per pass, tracer.trace_alpha_to_compact) and the
    folded carry merges back to full width once.

    regroup ("dir" / "origin" / None) sorts an incoherent ray population
    into coherent packet blocks before the opaque trace
    (tracer_cuda._regroup_order).

    mip_diffs: optional (d_ddx, d_ddy) camera-ray differentials (3, N)
    for ray-diff mip LOD, applied to the OPAQUE winner's diffuse fetch
    only (alpha slots keep bilinear level 0: the compacted lanes drop the
    pixel correspondence the differentials need).

    frame_lanes: the frame's ray count, which sizes the alpha capacity
    (default: the width of dirs). A pass traced on a subset of its
    frame's rays passes its frame's, so that it drops what the whole
    frame would.

    Returns (carry, dropped): dropped counts candidate alpha rays beyond
    the compaction capacity, so the view can grow the capacity.
    """
    n = dirs.shape[1] if frame_lanes is None else frame_lanes
    opaque_fn = tracer_cuda.make_opaque_fn(regroup=regroup)
    mip_args = lambda t: None if mip_diffs is None else (t, *mip_diffs)
    # Candidate rays after the opaque-clamped alpha cull are a few
    # percent of a frame; n/16 leaves headroom and the boost ladder
    # (view.py) grows it on overflow.
    cap = max(1024, (n // 16) * cfg.alpha_shade_boost)
    if trace_scene.has_alpha is True and k_alpha > 0:
        t_op, tri_op, uv_op, t_opb = tracer.trace_opaque_only(
            origins, dirs, t_min, t_max, trace_scene,
            cull_backface=cull_backface,
            opaque_fn=opaque_fn,
        )
        ac = tracer.trace_alpha_to_compact(
            origins, dirs, t_min, t_max, trace_scene, k_alpha,
            cull_backface, cap, noise_rand, t_opaque_biased=t_opb,
            extra=aux,
        )
        carry_c = make_carry(ac.origins, ac.dirs, ac.extra)
        for s in range(k_alpha):
            sh_c = shade_ops.shade_hits(
                sb, tri_rows, ac.dirs, ac.tri[:, s], ac.uv[:, s, 0],
                ac.uv[:, s, 1], ac.noise,
            )
            carry_c = slot_fn(carry_c, sh_c, ac.t[:, s], ac.origins,
                              ac.dirs, ac.extra)
        carry = _scatter_carry(make_carry(origins, dirs, aux), carry_c,
                               ac.mask)
        sh = shade_ops.shade_hits(
            sb, tri_rows, dirs, tri_op, uv_op[:, 0], uv_op[:, 1], noise_rand,
            mip_args=mip_args(t_op),
        )
        return slot_fn(carry, sh, t_op, origins, dirs, aux), ac.dropped

    # No alpha geometry (or no alpha slots): opaque closest hit only.
    hits = tracer.trace(
        origins, dirs, t_min, t_max, trace_scene,
        k_alpha=0, cull_backface=cull_backface,
        opaque_fn=opaque_fn,
    )
    sh = shade_ops.shade_hits(
        sb, tri_rows, dirs, hits.tri_op, hits.uv_op[:, 0],
        hits.uv_op[:, 1], noise_rand, mip_args=mip_args(hits.t_op),
    )
    carry = make_carry(origins, dirs, aux)
    return slot_fn(carry, sh, hits.t_op, origins, dirs, aux), hits.alpha_dropped


def _ctx_table(tri_rows):
    """(T, CTXROW) column-sliced triangle rows: the 26 columns the
    post-resolve consumers (lighting ctx, reflection fresnel/shine,
    refraction eta) read."""
    return torch.cat([tri_rows[:, s : s + l] for s, l in R.CTX_RUNS], dim=1)


def _row_of(tri_rows, tri, valid):
    """Gather compact CONTEXT rows (R.CTXROW, N) for resolved per-pixel
    winners."""
    row = _ctx_table(tri_rows)[torch.clamp(tri, min=0).to(torch.int64)].T
    return row * valid[None].to(row.dtype)


def primary_pass(
    sb, gp, cfg, origins, dirs, t_min, t_max, bg_color, tri_rows,
    trace_scene, pix, bn_table, noise_rand,
):
    """Trace + shade + front-to-back alpha resolve, fused per slot
    (PrimaryRayGen.hlsl:76-198)."""
    dev = dirs.device

    def make_carry(origins, dirs, aux):
        m = dirs.shape[1]
        z = lambda *s: torch.zeros(s, device=dev)
        return (
            torch.ones((m,), device=dev),  # res_a
            z(3, m),  # res_rgb
            z(3, m),  # res_transparent
            z(3, m),  # trans_lit_sum
            z(m),  # lock_acc
            z(m),  # refl_alpha
            z(m),  # refr_alpha
            torch.zeros((m,), dtype=torch.bool, device=dev),  # stored
            torch.zeros((m,), dtype=torch.int32, device=dev),  # st_tri
            z(3, m),  # st_pos
            -dirs,  # st_nrm
            z(3, m),  # st_spec
            torch.full((m,), -1, dtype=torch.int32, device=dev),  # st_inst
            z(3, m),  # st_flow3
            torch.zeros((m,), dtype=torch.bool, device=dev),  # tl_stored
            torch.zeros((m,), dtype=torch.int32, device=dev),  # tl_tri
            z(3, m),  # tl_pos
            z(3, m),  # tl_nrm
            z(3, m),  # tl_spec
        )

    ambient3 = (gp.ambient_base + gp.ambient_no_gi)[:, None]

    def slot_body(carry, sh, t_s, origins, dirs, aux):
        (res_a, res_rgb, res_transparent, trans_lit_sum, lock_acc,
         refl_alpha, refr_alpha, stored, st_tri, st_pos, st_nrm, st_spec,
         st_inst, st_flow3, tl_stored, tl_tri, tl_pos, tl_nrm,
         tl_spec) = carry
        color = sh.color  # (4, N)
        inst = sh.instance
        normal = sh.normal
        vspec = sh.specular
        flow3 = sh.flow
        grow = sh.rows_t  # (TROW, N)
        mat = lambda off: grow[R.T_MAT + off]
        flags = grow[R.T_FLAGS].to(torch.int32)

        valid = inst >= 0
        ha = color[3]
        alpha_contrib = res_a * ha
        live = valid & (alpha_contrib >= EPSILON) & (res_a > EPSILON)
        hit_pos = origins + dirs * t_s[None]

        lock_acc = lock_acc + torch.where(live, mat(R.M_LOCK) * alpha_contrib, 0.0)

        uses_l = ((flags & R.F_HAS_LIGHTING) != 0) & valid
        apply_l = uses_l & (ha > APPLY_LIGHTS_MINIMUM_ALPHA)

        # Fog folds into transparency (PrimaryRayGen.hlsl:108-113).
        fa = torch.where(
            mat(R.M_FOG_ENABLED) > 0.0,
            fog.fog_alpha_from_camera(
                hit_pos, gp.view, gp.projection, mat(R.M_FOG_MUL),
                mat(R.M_FOG_OFFSET),
            ),
            0.0,
        )
        fog_rgb = grow[R.T_MAT + R.M_FOG_COLOR : R.T_MAT + R.M_FOG_COLOR + 3]
        res_transparent = res_transparent + torch.where(
            live[None], fog_rgb * (fa * alpha_contrib)[None], 0.0
        )
        alpha_contrib = alpha_contrib * (1.0 - fa)

        # Reflection seed (PrimaryRayGen.hlsl:116-127).
        refl_f = mat(R.M_REFLECTION)
        has_refl = live & (refl_f > EPSILON)
        fresnel = _fresnel(normal, dirs, refl_f, mat(R.M_REFL_FRESNEL))
        reflect_amount = fresnel * alpha_contrib
        refl_alpha = torch.where(has_refl, reflect_amount, refl_alpha)
        lock_acc = lock_acc + torch.where(has_refl, reflect_amount, 0.0)
        alpha_contrib = torch.where(
            has_refl, alpha_contrib * (1.0 - fresnel), alpha_contrib
        )

        # Color accumulation (PrimaryRayGen.hlsl:129-152).
        color_add = color[:3] * alpha_contrib[None]
        res_rgb = res_rgb + torch.where((live & apply_l)[None], color_add, 0.0)
        self_l = grow[R.T_MAT + R.M_SELF_LIGHT : R.T_MAT + R.M_SELF_LIGHT + 3]
        spec = grow[R.T_MAT + R.M_SPECULAR : R.T_MAT + R.M_SPECULAR + 3] * vspec

        trans_lit = live & uses_l & ~apply_l
        take_tl = trans_lit & ~tl_stored
        tl_stored = tl_stored | take_tl
        tl_pos = torch.where(take_tl[None], hit_pos, tl_pos)
        tl_nrm = torch.where(take_tl[None], normal, tl_nrm)
        tl_spec = torch.where(take_tl[None], spec, tl_spec)
        tl_tri = torch.where(take_tl, sh.tri, tl_tri)
        trans_lit_sum = trans_lit_sum + torch.where(trans_lit[None], color_add, 0.0)
        res_transparent = res_transparent + torch.where(
            trans_lit[None], color_add * (ambient3 + self_l), 0.0
        )
        plain = live & ~uses_l
        res_transparent = res_transparent + torch.where(
            plain[None], color_add * (ambient3 + self_l), 0.0
        )

        new_res_a = res_a * (1.0 - ha)

        # Refraction seed terminates traversal (PrimaryRayGen.hlsl:156-161).
        has_refr = live & (mat(R.M_REFRACTION) > EPSILON)
        refr_alpha = torch.where(has_refr, new_res_a, refr_alpha)
        new_res_a = torch.where(has_refr, 0.0, new_res_a)
        res_a = torch.where(live, new_res_a, res_a)

        # Primary-hit storage (PrimaryRayGen.hlsl:163-175).
        store_hit = live & (apply_l | has_refl | has_refr) & ~stored
        stored = stored | store_hit
        st_pos = torch.where(store_hit[None], hit_pos, st_pos)
        st_nrm = torch.where(store_hit[None], normal, st_nrm)
        st_spec = torch.where(store_hit[None], spec, st_spec)
        st_inst = torch.where(store_hit, inst, st_inst)
        st_flow3 = torch.where(store_hit[None], flow3, st_flow3)
        st_tri = torch.where(store_hit, sh.tri.to(torch.int32), st_tri)
        return (
            res_a, res_rgb, res_transparent, trans_lit_sum, lock_acc,
            refl_alpha, refr_alpha, stored, st_tri, st_pos, st_nrm, st_spec,
            st_inst, st_flow3, tl_stored, tl_tri, tl_pos, tl_nrm, tl_spec,
        )

    mip_diffs = None
    if sb.features.has_mips:
        # Camera-ray direction differentials (Ray.hlsli:40-49). Like the
        # reference (PrimaryRayGen.hlsl:36,59) they use a cameraUVW-basis
        # direction: parallel to the traced projI-basis dir, but scaled
        # consistently with cameraU/cameraV, which computeRayDiffs'
        # dot(d, r) terms require.
        w_, h_ = cfg.rt_width, cfg.grid_height
        ndx = ((pix[:, 0].to(torch.float32) + 0.5 + gp.pixel_jitter[0])
               / w_) * 2.0 - 1.0
        ndy = ((pix[:, 1].to(torch.float32) + 0.5 + gp.pixel_jitter[1])
               / h_) * 2.0 - 1.0
        nn = (gp.camera_u[:, None] * ndx[None]
              + gp.camera_v[:, None] * ndy[None]
              + gp.camera_w[:, None])
        mip_diffs = raydiff.compute_ray_diffs(
            nn, gp.camera_u, gp.camera_v, (float(w_), float(h_)),
        )
    carry, alpha_dropped = _fold_shaded_slots(
        sb, tri_rows, trace_scene, origins, dirs, t_min, t_max,
        cfg.k_primary, noise_rand, cfg, make_carry, slot_body,
        mip_diffs=mip_diffs,
    )

    (res_a, res_rgb, res_transparent, trans_lit_sum, lock_acc,
     refl_alpha, refr_alpha, stored, st_tri, st_pos, st_nrm, st_spec,
     st_inst, st_flow3, tl_stored, tl_tri, tl_pos, tl_nrm, tl_spec) = carry

    # Shared transparent light (1 light, checkShadows=true,
    # PrimaryRayGen.hlsl:139-147). Its shadow rays are traced later in
    # the frame's ONE batched shadow launch (lighting.trace_plans).
    st_row = _row_of(tri_rows, st_tri, stored)
    if sb.features.has_lit_transparent:
        tl_row = _row_of(tri_rows, tl_tri, tl_stored)
        tl_ctx = lighting.ctx_from_rows(tl_row, tl_stored)
        tl_plan = lighting.plan_lights(
            sb, pix, bn_table, gp.frame_count, dirs, tl_pos, tl_nrm,
            tl_spec, tl_ctx, max_light_count=1,
            di_samples=cfg.di_samples, noise_rand=noise_rand,
        )
    else:
        tl_plan = None

    # Motion flow (PrimaryRayGen.hlsl:52-56, 163-175, 194), in pixels of
    # the whole frame (the JAX package scales a band's by its own rows).
    bg_pos = origins + dirs * tracer.RAY_MAX_DISTANCE
    pu, pv = world_to_screen(gp.prev_view_proj, bg_pos)
    cu, cv = world_to_screen(gp.view_proj, bg_pos)
    flow_bg_x = (cu - pu) * cfg.rt_width
    flow_bg_y = (cv - pv) * cfg.grid_height
    pu2, pv2 = world_to_screen(gp.prev_view_proj, st_pos - st_flow3)
    cu2, cv2 = world_to_screen(gp.view_proj, st_pos)
    flow_x = torch.where(stored, (cu2 - pu2) * cfg.rt_width, flow_bg_x)
    flow_y = torch.where(stored, (cv2 - pv2) * cfg.grid_height, flow_bg_y)
    flow = torch.stack([-flow_x, flow_y], 0)  # gFlow sign flip (hlsl:194)

    depth = torch.where(stored, _screen_depth(gp.view_proj, st_pos), 1.0)
    # reactive is PROVISIONAL here: the transparent-light contribution
    # lands in render_frame after the batched shadow trace.
    reactive = torch.clamp(res_transparent.amax(dim=0), max=0.9)
    lock_mask = torch.where(
        gp.binary_lock_mask,
        (lock_acc > 0.5).to(torch.float32),
        torch.clamp(lock_acc, max=1.0),
    )

    # Background blend (PrimaryRayGen.hlsl:183-185).
    res_rgb = res_rgb + bg_color * res_a[None]
    g = GBuffers(
        view_dir=dirs,
        position=st_pos,
        normal=st_nrm,
        specular=st_spec,
        diffuse_rgb=res_rgb,
        diffuse_a=1.0 - res_a,
        instance=st_inst,
        transparent=res_transparent,
        flow=flow,
        reactive=reactive,
        lock=lock_mask,
        depth=depth,
        refl_alpha=refl_alpha,
        refr_alpha=refr_alpha,
        row=st_row,
        alpha_dropped=alpha_dropped,
    )
    return g, tl_plan, trans_lit_sum


def direct_pass(cfg, gp, g: GBuffers, ctx, direct_light):
    """DirectRayGen.hlsl:14-65. Returns (4, N) accumulation.

    `direct_light` is the already-traced ComputeLightsRandom result
    (lighting.finish_lights). DI reprojection is compiled out in the
    reference (DI_REPROJECTION_SUPPORT undefined,
    rt64_view.cpp:1012-1016), so the history is not read."""
    n = g.instance.shape[0]
    dev = g.instance.device
    no_hit = g.instance < 0
    new_direct = torch.zeros((3, n), device=dev)
    hist_len = torch.zeros((n,), device=dev)

    res = direct_light + ctx.self_light

    # Eye light (DirectRayGen.hlsl:53-58) — keeps the reference's
    # non-normalized per-pixel ray direction.
    lambert = torch.clamp(vm.dot(g.normal, -g.view_dir), min=0.0)
    reflected = vm.reflect(g.view_dir, g.normal)
    sdot = torch.clamp(vm.dot(reflected, -g.view_dir), 0.0, 1.0)
    spec_f = g.specular * torch.pow(sdot, ctx.spec_exp)[None]
    res = (
        res
        + gp.eye_light_diffuse[:, None] * lambert[None]
        + gp.eye_light_specular[:, None] * spec_f
    )

    hist_len = torch.clamp(hist_len + 1.0, max=64.0)
    new_direct = new_direct + (res - new_direct) / hist_len[None]
    out = torch.cat([new_direct, hist_len[None]], 0)
    miss = torch.cat([torch.ones((3, n), device=dev),
                      torch.zeros((1, n), device=dev)], 0)
    return torch.where(no_hit[None], miss, out)


def _reproject(prev_buf, prev_depth, prev_normal, depth, normal, flow, cfg,
               row_offset: int = 0):
    """Temporal reprojection (DirectRayGen.hlsl:35-48): the previous
    frame's accumulation at the pixel the flow points back to, weighted
    by depth and normal agreement. The previous planes cover the whole
    frame (under row tiling too), so the flow may cross band edges.
    Returns (rgb (3, N), history length (N,))."""
    h, w = cfg.grid_height, cfg.rt_width
    pix = _pixel_grid(cfg, depth.device, row_offset).to(torch.float32)
    px = torch.floor(pix[:, 0] + 0.5 + flow[0]).to(torch.int32)
    py = torch.floor(pix[:, 1] + 0.5 + flow[1]).to(torch.int32)
    inb = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    flat = flat_index(
        cfg, torch.clamp(px, 0, w - 1), torch.clamp(py, 0, h - 1)
    ).to(torch.int64)
    hist_planes = torch.cat([prev_depth[None], prev_normal, prev_buf], 0)
    got = torch.where(inb[None], hist_planes[:, flat], 0.0)
    p_depth = got[0]
    p_normal = got[1:4]
    p_accum = got[4:]
    weight_depth = torch.abs(depth - p_depth) / 0.01
    weight_normal = torch.pow(
        torch.clamp(vm.dot(p_normal, normal), min=0.0), 128.0
    )
    history_weight = torch.exp(-weight_depth) * weight_normal
    return p_accum[:3], p_accum[3] * history_weight


def _simple_resolve_fold(
    sb, tri_rows, trace_scene, origins, dirs, t_min, t_max, k_alpha,
    noise_rand, cfg, regroup=None,
):
    """Fused trace+shade+resolve for secondary rays
    (IndirectRayGen.hlsl:95-117): accumulate color front-to-back,
    remember the last contributing hit."""
    dev = dirs.device

    def make_carry(origins, dirs, aux):
        m = dirs.shape[1]
        z = lambda *s: torch.zeros(s, device=dev)
        return (
            torch.ones((m,), device=dev), z(3, m), z(3, m), z(3, m), z(3, m),
            torch.zeros((m,), dtype=torch.int32, device=dev),
            torch.full((m,), -1, dtype=torch.int32, device=dev),
        )

    def slot_body(carry, sh, t_s, origins, dirs, aux):
        res_a, res_rgb, res_pos, res_nrm, res_spec, res_tri, res_inst = carry
        inst = sh.instance
        valid = inst >= 0
        ha = sh.color[3]
        alpha_contrib = res_a * ha
        live = valid & (alpha_contrib >= EPSILON) & (res_a > EPSILON)
        hit_pos = origins + dirs * t_s[None]
        grow = sh.rows_t
        spec = grow[R.T_MAT + R.M_SPECULAR : R.T_MAT + R.M_SPECULAR + 3] * sh.specular
        res_rgb = res_rgb + torch.where(
            live[None], sh.color[:3] * alpha_contrib[None], 0.0
        )
        res_a = torch.where(live, res_a * (1.0 - ha), res_a)
        res_pos = torch.where(live[None], hit_pos, res_pos)
        res_nrm = torch.where(live[None], sh.normal, res_nrm)
        res_spec = torch.where(live[None], spec, res_spec)
        res_tri = torch.where(live, sh.tri.to(torch.int32), res_tri)
        res_inst = torch.where(live, inst, res_inst)
        return res_a, res_rgb, res_pos, res_nrm, res_spec, res_tri, res_inst

    ((res_a, res_rgb, res_pos, res_nrm, res_spec, res_tri, res_inst),
     dropped) = _fold_shaded_slots(
        sb, tri_rows, trace_scene, origins, dirs, t_min, t_max,
        k_alpha, noise_rand, cfg, make_carry, slot_body, regroup=regroup,
    )
    res_row = _row_of(tri_rows, res_tri, res_inst >= 0)
    return (res_rgb, res_a, res_pos, res_nrm, res_spec, res_inst, res_row,
            dropped)


def _background_env(sb, bg_planes, ray_dir):
    """SampleBackgroundAsEnvMap for bounce-miss rays, skipped when the
    scene has no raster background: bg_planes is then the black base
    and the per-ray gather would return zeros (the JAX package measured
    171 ms per frame of it at 4K)."""
    if sb.features.has_raster_bg:
        return sky.sample_background_env(bg_planes, ray_dir)
    return torch.zeros((3, ray_dir.shape[1]), device=ray_dir.device)


def _cos_hemisphere(r1, r2, normal):
    """getCosHemisphereSampleBlueNoise (IndirectRayGen.hlsl:17-29), planar."""
    a = torch.abs(normal)
    xm = ((a[0] - a[1]) < 0) & ((a[0] - a[2]) < 0)
    ym = ((a[1] - a[2]) < 0) & ~xm
    zm = ~(xm | ym)
    basis = torch.stack([xm, ym, zm], 0).to(normal.dtype)
    bitangent = vm.cross(normal, basis)
    tangent = vm.cross(bitangent, normal)
    r = torch.sqrt(r1)
    phi = 2.0 * torch.pi * r2
    return (
        tangent * (r * torch.cos(phi))[None]
        + bitangent * (r * torch.sin(phi))[None]
        + normal * torch.sqrt(torch.clamp(1.0 - r1, min=0.0))[None]
    )


def indirect_pass(
    sb, tri_rows, trace_scene, cfg, gp, g: GBuffers, hist: History,
    pix, bn_table, noise_rand, bg_planes, row_offset: int = 0,
):
    """IndirectRayGen.hlsl:31-137: 1-bounce blue-noise diffuse GI.
    Bounce rays are regrouped by direction and their shadow rays by
    origin before they reach the packet kernels. Returns ((4, N)
    accumulation: rgb + history length, alpha-drop count)."""
    n = g.instance.shape[0]
    dev = g.instance.device
    ambient3 = gp.ambient_base + gp.ambient_no_gi
    base = ambient3[:, None].expand(3, n)
    fallback = torch.cat([base, torch.zeros((1, n), device=dev)], 0)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    if cfg.gi_samples <= 0:
        return fallback, dropped

    ambient = base
    active = g.instance >= 0
    origin = g.position
    normal = g.normal

    prev_rgb, prev_len = _reproject(
        hist.indirect, hist.depth, hist.normal, g.depth, normal, g.flow, cfg,
        row_offset,
    )
    new_indirect = torch.where(gp.gi_reproject, prev_rgb, 0.0)
    hist_len = torch.where(gp.gi_reproject, prev_len, 0.0)

    blue_noise_mult = 64 // cfg.gi_samples
    t_min = torch.full((n,), tracer.RAY_MIN_DISTANCE, device=dev)
    # Sky pixels trace nothing: an empty interval lets ray blocks skip.
    t_max = torch.where(active, tracer.RAY_MAX_DISTANCE, -1.0)

    for s in range(cfg.gi_samples, 0, -1):
        bn = bluenoise.get_blue_noise(
            bn_table, pix, gp.frame_count + s * blue_noise_mult
        )
        ray_dir = _cos_hemisphere(bn[..., 0], bn[..., 1], normal)
        (res_rgb, res_a, res_pos, res_nrm, res_spec, res_inst, res_row,
         gi_drop) = _simple_resolve_fold(
            sb, tri_rows, trace_scene, origin, ray_dir, t_min, t_max,
            cfg.k_secondary, noise_rand, cfg, regroup="dir",
        )

        bg = _background_env(sb, bg_planes, ray_dir)
        sky_c = sky.sample_sky_plane(
            sb.quad_pool, sb.quad_records, gp.sky_plane_rec, ray_dir,
            gp.sky_yaw_offset, gp.sky_diffuse_mult, gp.sky_hsl_mod,
        )
        bg = bg * (1.0 - sky_c[3])[None] + sky_c[:3] * sky_c[3][None]

        # 1-light direct estimate at the bounce (IndirectRayGen.hlsl:121-127).
        ctx = lighting.ctx_from_rows(res_row, res_inst >= 0)
        direct_b, db_drop = lighting.compute_lights_random(
            sb, tri_rows, trace_scene, pix, bn_table, gp.frame_count,
            ray_dir, res_pos, res_nrm, res_spec, ctx,
            max_light_count=1, di_samples=cfg.di_samples, check_shadows=True,
            noise_rand=noise_rand, shadow_k_alpha=cfg.k_shadow,
            opaque_fn=tracer_cuda.make_shadow_opaque_fn(regroup="origin"),
            alpha_compact=max(1024, (n // 32) * cfg.alpha_shade_boost),
            shade_boost=cfg.alpha_shade_boost,
        )
        bounce = (
            res_rgb * (1.0 - res_a)[None]
            * (ambient + direct_b + ctx.self_light)
            * gp.gi_diffuse_strength
        )
        res_ind = ambient + torch.where((res_inst >= 0)[None], bounce, 0.0)
        res_ind = res_ind + bg * gp.gi_sky_strength * res_a[None]

        hist_len = torch.clamp(hist_len + 1.0, max=64.0)
        new_indirect = new_indirect + (res_ind - new_indirect) / hist_len[None]
        dropped = dropped + gi_drop + db_drop

    out = torch.cat([new_indirect, hist_len[None]], 0)
    return torch.where(active[None], out, fallback), dropped


def _lit_secondary_fold(
    sb, gp, cfg, tri_rows, trace_scene, origins, dirs, t_min, t_max,
    noise_rand, fog_mode, store_any,
):
    """Fused trace+shade+resolve for refraction rays with the fog +
    lighting split (RefractionRayGen.hlsl:63-110; the reflection pass
    folds the same way with its own carry). fog_mode "camera" or
    "origin". store_any: store every live hit (reflection,
    ReflectionRayGen.hlsl:114-118) or only lit ones (refraction,
    RefractionRayGen.hlsl:84-93)."""
    dev = dirs.device
    ambient3 = (gp.ambient_base + gp.ambient_no_gi)[:, None]

    def make_carry(origins, dirs, aux):
        m = dirs.shape[1]
        z = lambda *s: torch.zeros(s, device=dev)
        return (
            torch.ones((m,), device=dev), z(3, m), z(3, m), z(3, m), z(3, m),
            z(3, m), torch.zeros((m,), dtype=torch.int32, device=dev),
            torch.full((m,), -1, dtype=torch.int32, device=dev),
        )

    def slot_body(carry, sh, t_s, origins, dirs, aux):
        (res_a, res_rgb, res_transparent, res_pos, res_nrm, res_spec,
         res_tri, res_inst) = carry
        grow = sh.rows_t
        mat = lambda off: grow[R.T_MAT + off]
        flags = grow[R.T_FLAGS].to(torch.int32)
        inst = sh.instance
        valid = inst >= 0
        ha = sh.color[3]
        alpha_contrib = res_a * ha
        live = valid & (alpha_contrib >= EPSILON) & (res_a > EPSILON)
        hit_pos = origins + dirs * t_s[None]
        if fog_mode == "camera":
            fa = fog.fog_alpha_from_camera(
                hit_pos, gp.view, gp.projection, mat(R.M_FOG_MUL),
                mat(R.M_FOG_OFFSET),
            )
        else:
            fa = fog.fog_alpha_from_origin(
                hit_pos, origins, mat(R.M_FOG_MUL), mat(R.M_FOG_OFFSET)
            )
        fa = torch.where(mat(R.M_FOG_ENABLED) > 0.0, fa, 0.0)
        fog_rgb = grow[R.T_MAT + R.M_FOG_COLOR : R.T_MAT + R.M_FOG_COLOR + 3]
        res_transparent = res_transparent + torch.where(
            live[None], fog_rgb * (fa * alpha_contrib)[None], 0.0
        )
        alpha_contrib = alpha_contrib * (1.0 - fa)
        color_add = sh.color[:3] * alpha_contrib[None]
        uses_l = ((flags & R.F_HAS_LIGHTING) != 0) & valid
        lit = live & uses_l
        self_l = grow[R.T_MAT + R.M_SELF_LIGHT : R.T_MAT + R.M_SELF_LIGHT + 3]
        res_rgb = res_rgb + torch.where(lit[None], color_add, 0.0)
        res_transparent = res_transparent + torch.where(
            (live & ~uses_l)[None], color_add * (ambient3 + self_l), 0.0
        )
        spec = grow[R.T_MAT + R.M_SPECULAR : R.T_MAT + R.M_SPECULAR + 3] * sh.specular
        store = live if store_any else lit
        res_pos = torch.where(store[None], hit_pos, res_pos)
        res_nrm = torch.where(store[None], sh.normal, res_nrm)
        res_spec = torch.where(store[None], spec, res_spec)
        res_tri = torch.where(store, sh.tri.to(torch.int32), res_tri)
        res_inst = torch.where(store, inst, res_inst)
        res_a = torch.where(live, res_a * (1.0 - ha), res_a)
        return (res_a, res_rgb, res_transparent, res_pos, res_nrm, res_spec,
                res_tri, res_inst)

    ((res_a, res_rgb, res_transparent, res_pos, res_nrm, res_spec, res_tri,
      res_inst), dropped) = _fold_shaded_slots(
        sb, tri_rows, trace_scene, origins, dirs, t_min, t_max,
        cfg.k_secondary, noise_rand, cfg, make_carry, slot_body,
    )
    res_row = _row_of(tri_rows, res_tri, res_inst >= 0)
    return (res_rgb, res_a, res_pos, res_nrm, res_spec, res_inst, res_row,
            res_transparent, dropped)


def _refract(d, n, eta):
    """HLSL refract(i, n, eta) with a non-normalized i, as the reference
    calls it (bug-compatible); a total internal reflection gives 0."""
    ndi = vm.dot(n, d)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    out = d * eta[None] - n * (eta * ndi + torch.sqrt(torch.clamp(k, min=0.0)))[None]
    return torch.where((k >= 0.0)[None], out, 0.0)


def refraction_pass(
    sb, tri_rows, trace_scene, cfg, gp, g: GBuffers, pix, bn_table,
    noise_rand, bg_color,
):
    """RefractionRayGen.hlsl:17-117. Returns ((3, N), alpha-drop count).

    bg_color is the (3, N) screen-space background+sky fallback the
    refracted miss reads (RefractionRayGen.hlsl:30-36), the same sample
    render_frame computed for the primary pass. Pixels
    that seeded no refraction ride as dead rays (empty trace intervals).
    Neither trace is regrouped, as in the JAX package."""
    n = g.instance.shape[0]
    active = (g.instance >= 0) & (g.refr_alpha > EPSILON)
    ray_dir = _refract(g.view_dir, g.normal, g.row[R.CTX_REFRACTION])

    t_min = torch.full((n,), tracer.RAY_MIN_DISTANCE, device=ray_dir.device)
    t_max = torch.where(active, tracer.RAY_MAX_DISTANCE, -1.0)
    (rgb, res_a, pos, nrm, spec, inst, row, transparent,
     fold_drop) = _lit_secondary_fold(
        sb, gp, cfg, tri_rows, trace_scene, g.position, ray_dir, t_min,
        t_max, noise_rand, fog_mode="camera", store_any=False,
    )
    ctx = lighting.ctx_from_rows(row, inst >= 0)
    direct, li_drop = lighting.compute_lights_random(
        sb, tri_rows, trace_scene, pix, bn_table, gp.frame_count,
        ray_dir, pos, nrm, spec, ctx,
        max_light_count=1, di_samples=cfg.di_samples, check_shadows=True,
        noise_rand=noise_rand, shadow_k_alpha=cfg.k_shadow,
        opaque_fn=tracer_cuda.make_shadow_opaque_fn(),
        alpha_compact=max(1024, (n // 32) * cfg.alpha_shade_boost),
        shade_boost=cfg.alpha_shade_boost,
    )
    ambient3 = (gp.ambient_base + gp.ambient_no_gi)[:, None]
    rgb = torch.where((inst >= 0)[None],
                      rgb * (ambient3 + direct + ctx.self_light), rgb)
    rgb = rgb + bg_color * res_a[None] + transparent
    return (torch.where(active[None], rgb * g.refr_alpha[None], 0.0),
            fold_drop + li_drop)


class ReflectionState(NamedTuple):
    """The shading state one reflection bounce reads and rewrites for
    the next (ReflectionRayGen.hlsl:117-124)."""

    rgb: torch.Tensor  # (3, N) accumulated reflection
    alpha: torch.Tensor  # (N,) weight of the next bounce
    position: torch.Tensor  # (3, N)
    view_dir: torch.Tensor  # (3, N)
    normal: torch.Tensor  # (3, N)
    instance: torch.Tensor  # (N,) int32
    row: torch.Tensor  # (R.CTXROW, N)


def _mirror_lanes(instance, alpha):
    """(N,) bool: the lanes with a reflection left to trace."""
    return (instance >= 0) & (alpha > EPSILON)


def reflection_pass(
    sb, tri_rows, trace_scene, cfg, gp, state: ReflectionState, pix,
    bn_table, noise_rand, bg_planes, frame_lanes,
):
    """One ReflectionRayGen iteration (ReflectionRayGen.hlsl:25-143) over
    the lanes of `state`, with pix, bn_table and noise_rand at the same
    lanes; reflection_bounces loops it (rt64_view.cpp:1417-1436). Returns
    (the next ReflectionState, alpha-drop count). Mirror rays are traced
    unregrouped, as in the JAX package; lanes with no reflection left
    ride as dead rays and come back unchanged. frame_lanes: the frame's
    ray count, which sizes the alpha capacity (default: the lanes')."""
    refl_rgb, refl_a, sh_pos, view_dir, sh_nrm, inst_id, sh_row = state
    n = inst_id.shape[0]
    dev = inst_id.device
    active = _mirror_lanes(inst_id, refl_a)
    ray_dir = vm.reflect(view_dir, sh_nrm)

    bg = _background_env(sb, bg_planes, ray_dir)
    sky_c = sky.sample_sky_plane(
        sb.quad_pool, sb.quad_records, gp.sky_plane_rec, ray_dir,
        gp.sky_yaw_offset, gp.sky_diffuse_mult, gp.sky_hsl_mod,
    )
    bg = bg * (1.0 - sky_c[3])[None] + sky_c[:3] * sky_c[3][None]

    t_min = torch.full((n,), tracer.RAY_MIN_DISTANCE, device=dev)
    t_max = torch.where(active, tracer.RAY_MAX_DISTANCE, -1.0)

    ambient3 = (gp.ambient_base + gp.ambient_no_gi)[:, None]
    # Bug-compatible: the fresnel multiplier reads the *primary* pixel's
    # material (ReflectionRayGen.hlsl:100). It and the incoming
    # reflection weight are per pixel, so they ride the fold's aux
    # gather into compacted space.
    primary_fresnel = sh_row[R.CTX_REFL_FRESNEL]

    def make_carry(origins, dirs, aux):
        m = dirs.shape[1]
        z = lambda *s: torch.zeros(s, device=dev)
        return (
            torch.ones((m,), device=dev), z(3, m), z(3, m), z(3, m), z(3, m),
            z(3, m), torch.zeros((m,), dtype=torch.int32, device=dev),
            torch.full((m,), -1, dtype=torch.int32, device=dev), z(m),
        )

    def slot_body(carry, sh, t_s, origins, dirs, aux):
        (res_a, res_rgb, res_transparent, res_pos, res_nrm, res_spec,
         res_tri, res_inst, new_refl_a) = carry
        w_in, fresnel_mult = aux
        grow = sh.rows_t
        mat = lambda off: grow[R.T_MAT + off]
        flags = grow[R.T_FLAGS].to(torch.int32)
        inst = sh.instance
        valid = inst >= 0
        ha = sh.color[3]
        alpha_contrib = res_a * ha
        live = valid & (alpha_contrib >= EPSILON) & (res_a > EPSILON)
        hit_pos = origins + dirs * t_s[None]
        fa = torch.where(
            mat(R.M_FOG_ENABLED) > 0.0,
            fog.fog_alpha_from_origin(
                hit_pos, origins, mat(R.M_FOG_MUL), mat(R.M_FOG_OFFSET)
            ),
            0.0,
        )
        fog_rgb = grow[R.T_MAT + R.M_FOG_COLOR : R.T_MAT + R.M_FOG_COLOR + 3]
        res_transparent = res_transparent + torch.where(
            live[None], fog_rgb * (fa * alpha_contrib)[None], 0.0
        )
        alpha_contrib = alpha_contrib * (1.0 - fa)

        hit_refl = mat(R.M_REFLECTION)
        has_refl = live & (hit_refl > EPSILON)
        fres = _fresnel(sh.normal, dirs, hit_refl, fresnel_mult)
        new_refl_a = new_refl_a + torch.where(
            has_refl, fres * alpha_contrib * w_in, 0.0
        )

        color_add = sh.color[:3] * alpha_contrib[None]
        uses_l = ((flags & R.F_HAS_LIGHTING) != 0) & valid
        lit = live & uses_l
        self_l = grow[R.T_MAT + R.M_SELF_LIGHT : R.T_MAT + R.M_SELF_LIGHT + 3]
        res_rgb = res_rgb + torch.where(lit[None], color_add, 0.0)
        res_transparent = res_transparent + torch.where(
            (live & ~uses_l)[None], color_add * (ambient3 + self_l), 0.0
        )
        spec = grow[R.T_MAT + R.M_SPECULAR : R.T_MAT + R.M_SPECULAR + 3] * sh.specular
        res_pos = torch.where(live[None], hit_pos, res_pos)
        res_nrm = torch.where(live[None], sh.normal, res_nrm)
        res_spec = torch.where(live[None], spec, res_spec)
        res_tri = torch.where(live, sh.tri.to(torch.int32), res_tri)
        res_inst = torch.where(live, inst, res_inst)
        res_a = torch.where(live, res_a * (1.0 - ha), res_a)
        return (res_a, res_rgb, res_transparent, res_pos, res_nrm, res_spec,
                res_tri, res_inst, new_refl_a)

    ((res_a, res_rgb, res_transparent, res_pos, res_nrm, res_spec, res_tri,
      res_inst, new_refl_a), refl_dropped) = _fold_shaded_slots(
        sb, tri_rows, trace_scene, sh_pos, ray_dir, t_min, t_max,
        cfg.k_secondary, noise_rand, cfg, make_carry, slot_body,
        aux=(refl_a, primary_fresnel), frame_lanes=frame_lanes,
    )

    res_row = _row_of(tri_rows, res_tri, res_inst >= 0)
    # Lighting at the final hit (checkShadows=false,
    # ReflectionRayGen.hlsl:125-132) and the shading-state write-back.
    ctx = lighting.ctx_from_rows(res_row, res_inst >= 0)
    direct, li_drop = lighting.compute_lights_random(
        sb, tri_rows, trace_scene, pix, bn_table, gp.frame_count,
        ray_dir, res_pos, res_nrm, res_spec, ctx,
        max_light_count=1, di_samples=cfg.di_samples, check_shadows=False,
        noise_rand=noise_rand, shadow_k_alpha=cfg.k_shadow,
    )
    got = res_inst >= 0
    res_rgb = torch.where(
        got[None], res_rgb * (ambient3 + direct + ctx.self_light), res_rgb
    )
    upd = active & got
    sh_pos = torch.where(upd[None], res_pos, sh_pos)
    view_dir = torch.where(upd[None], ray_dir, view_dir)
    sh_nrm = torch.where(upd[None], res_nrm, sh_nrm)
    inst_id = torch.where(upd, res_inst, inst_id)
    sh_row = torch.where(upd[None], res_row, sh_row)

    # Background blend + artificial shine (ReflectionRayGen.hlsl:134-143).
    res_rgb = res_rgb + bg * res_a[None] + res_transparent
    shine = sh_row[R.CTX_REFL_SHINE]
    highlight = vm.splat((1.0, 1.05, 1.2), res_rgb)
    shadow_c = vm.splat((0.1, 0.05, 0.0), res_rgb)
    up_amt = torch.pow(torch.clamp(ray_dir[1], min=0.0) * shine, 3.0)[None]
    dn_amt = torch.pow(torch.clamp(-ray_dir[1], min=0.0) * shine, 3.0)[None]
    res_rgb = res_rgb * (1.0 - up_amt) + highlight * up_amt
    res_rgb = res_rgb * (1.0 - dn_amt) + shadow_c * dn_amt

    add = res_rgb * refl_a[None] * torch.clamp(1.0 - new_refl_a, 0.0, 1.0)[None]
    refl_rgb = refl_rgb + torch.where(active[None], add, 0.0)
    refl_a = torch.where(active, torch.clamp(new_refl_a, 0.0, 1.0), refl_a)
    return (ReflectionState(refl_rgb, refl_a, sh_pos, view_dir, sh_nrm,
                            inst_id, sh_row),
            refl_dropped + li_drop)


def _write_lanes(full: ReflectionState, lanes, state: ReflectionState):
    """`full` with `state`, the state of its lanes `lanes`, written back."""
    return ReflectionState(*(f.index_copy(f.dim() - 1, lanes, c)
                             for f, c in zip(full, state)))


def reflection_bounces(
    sb, tri_rows, trace_scene, cfg, gp, state: ReflectionState, pix,
    bn_table, noise_rand, bg_planes, alpha_dropped,
):
    """The frame's max_reflections bounces (rt64_view.cpp:1417-1436), each
    reading the state the last one wrote, traced on the live mirror rays
    alone. Returns (the ReflectionState after them, alpha_dropped with
    their alpha drops added).

    Before each bounce one read of the live count (a host sync) decides
    its width: the lanes of the bundles that hold a live ray
    (tracer.live_bundles), gathered in lane order, and narrowed again
    when the count falls. A lane a bounce leaves dead stays dead, so the
    lanes left out come back unchanged, as over the full width. A bounce
    with no live ray, and the bounces after it, are not issued. The
    state goes back to full width once, after the last bounce. The
    alpha capacity stays the whole frame's, so drops and the view's
    boost ladder see what full-width bounces would."""
    n = state.instance.shape[0]
    dev = state.instance.device
    full, lanes = state, None  # lanes: the full-width lanes of `state`
    pix_at, noise_at, bn_at = pix, noise_rand, bn_table
    last = cfg.max_reflections - 1
    for b in range(cfg.max_reflections):
        with profiling.stage("rt64.pass.reflection", dev):
            active = _mirror_lanes(state.instance, state.alpha)
            keep = tracer.live_bundles(active)
            live, m = torch.stack([active.sum(), keep.sum()]).tolist()
            profiling.count_reflection(live, m if live else 0,
                                       0 if live else last + 1 - b)
            if live:
                if m < keep.shape[0]:
                    full = (state if lanes is None
                            else _write_lanes(full, lanes, state))
                    sel = torch.nonzero_static(keep, size=m)[:, 0]
                    state = ReflectionState(*(x[..., sel] for x in state))
                    lanes = sel if lanes is None else lanes[sel]
                    pix_at, noise_at = pix[lanes], noise_rand[lanes]
                    bn_at = lambda f, lanes=lanes: bn_table(f)[lanes]
                state, drop = reflection_pass(
                    sb, tri_rows, trace_scene, cfg, gp, state, pix_at, bn_at,
                    noise_at, bg_planes, n,
                )
                alpha_dropped = alpha_dropped + drop
            if lanes is not None and (not live or b == last):
                state = _write_lanes(full, lanes, state)
        if not live:
            break
    return state, alpha_dropped


def _raster_layer(image, sb: SceneBuffers, layer: str, row_offset: int = 0,
                  full_height: int = 0):
    """Blend one raster layer ("bg" or "fg") of the scene over image
    (4, H, W), rows row_offset.. of a target full_height tall (0: H);
    the triangles and their draw state come from the packer's host
    copies (SceneBuffers.raster_host)."""
    rows = getattr(sb, f"raster_{layer}")
    host = sb.raster_host
    if host is None:
        if rows.shape[0]:
            raise ValueError("the scene has raster rows but no host copy "
                             "of them (SceneBuffers.raster_host)")
        return image
    rows_host = getattr(host, layer)
    return raster.rasterize(image, rows, rows_host.shape[0], rows_host,
                            host.instance_rows, sb.quad_pool,
                            host.quad_records, row_offset=row_offset,
                            full_height=full_height)


def background(sb: SceneBuffers, gp: GlobalParams, cfg: RenderConfig,
               bg_planes, row_offset: int = 0):
    """The raster background composited over the base plane bg_planes
    (3, grid_height, W) (rt64_view.cpp:1292-1319), and the fixed-grid
    background + sky sample the primary and refracted misses read
    (PrimaryRayGen.hlsl:47-56), (3, N) in the frame's pixel order. Both
    grids read gp.pixel_jitter. Without raster-background triangles none
    of the background work runs (the plane stays black).

    Under row tiling the plane is the whole frame's: every band
    composites all of it, since bounce and mirror misses read it as an
    environment map, and takes its own rows of the grid sample, so a
    band equals the whole frame's rows."""
    h, w, gh = cfg.rt_height, cfg.rt_width, cfg.grid_height
    dev = gp.view.device
    if bg_planes is not None and bg_planes.shape[1] != gh:
        raise ValueError(f"background plane of {bg_planes.shape[1]} rows; "
                         f"the frame's grid has {gh}")
    if sb.features.has_raster_bg:
        if bg_planes is None:
            bg_planes = torch.zeros((3, gh, w), device=dev)
        bg_rgba = torch.cat([bg_planes, torch.ones((1, gh, w), device=dev)], 0)
        bg_planes = _raster_layer(bg_rgba, sb, "bg")[:3]
        bg_color = sky.sample_background_grid(bg_planes, *gp.pixel_jitter)
        bg_color = bg_color[:, row_offset * w : (row_offset + h) * w]
    else:
        bg_color = torch.zeros((3, h * w), device=dev)
    if sb.sky_plane is not None:
        sky_c = sky.sample_sky_2d_grid(
            sb.sky_plane, gp.sky_plane_rec, gp.pixel_jitter, gp.view_i,
            torch.tensor([cfg.display_width, cfg.display_grid_height],
                         dtype=torch.float32, device=dev),
            gp.sky_yaw_offset, gp.sky_diffuse_mult, gp.sky_hsl_mod,
            w, h, gh, row_offset,
        )
        bg_color = bg_color * (1.0 - sky_c[3])[None] + sky_c[:3] * sky_c[3][None]
    # Both grid samples come in row-major pixel order; the rays read them
    # in the frame's (the 8x64 tile order of a tiled frame).
    return bg_planes, from_image(cfg, bg_color.reshape(3, h, w))


def render_frame(
    sb: SceneBuffers,
    gp: GlobalParams,
    history: History,
    bn_table,
    cfg: RenderConfig,
    visualization_mode: int = 0,
    bg_planes=None,
    temporal=None,
    row_offset: int = 0,
) -> FrameOutputs:
    """The full frame: View::render as one function.

    bg_planes: (3, grid_height, W) base plane the raster background
    composites onto (the view passes a black one, as the reference's
    host clears to black before the background instances draw,
    rt64_view.cpp:1292-1319). Read only when the scene has
    raster-background triangles. temporal: the temporal upscaler's
    display-size state from the last frame (FrameOutputs.temporal), or
    None for a fresh one. row_offset: the first row of this band when
    cfg is a band of a row-tiled frame (parallel/tiling.py); the
    history then covers the whole frame."""
    h, w = cfg.rt_height, cfg.rt_width
    n = h * w
    dev = gp.view.device
    profiling.count_render()

    with profiling.stage("rt64.pass.setup", dev):
        tri_rows, rows_t = shade_ops.build_tri_rows(sb)
        trace_scene = make_trace_scene(sb, rows_t, cfg.alpha_cap)

        pix, origins, dirs = primary_rays(cfg, gp, row_offset)
        noise_rand = _noise_rand(cfg, gp, pix)

        # Every blue-noise fetch in the frame reads the regular pixel grid
        # at a uniform frame index: one 64x64 tile repeated over the screen.
        swz = None
        if cfg.tiled:
            swz = lambda plane: torch.stack(
                [_from_image_1(cfg, plane[..., c]) for c in range(3)], dim=-1
            )
        bn = bluenoise.grid_sampler(bn_table, w, h, row_offset=row_offset,
                                    swizzle=swz)

        bg_planes, bg_color = background(sb, gp, cfg, bg_planes, row_offset)

    with profiling.stage("rt64.pass.primary", dev):
        t_min = torch.full((n,), tracer.RAY_MIN_DISTANCE, device=dev)
        t_max = torch.full((n,), tracer.RAY_MAX_DISTANCE, device=dev)
        g, tl_plan, trans_lit_sum = primary_pass(
            sb, gp, cfg, origins, dirs, t_min, t_max, bg_color,
            tri_rows, trace_scene, pix, bn, noise_rand,
        )

    with profiling.stage("rt64.pass.direct", dev):
        # ONE batched shadow launch for the transparent light + all DI
        # rounds (PrimaryRayGen.hlsl:139-147 + DirectRayGen.hlsl:49-51).
        di_ctx = lighting.ctx_from_rows(g.row, g.instance >= 0)
        di_plan = lighting.plan_lights(
            sb, pix, bn, gp.frame_count, g.view_dir, g.position,
            g.normal, g.specular, di_ctx, max_light_count=cfg.max_lights,
            di_samples=cfg.di_samples, noise_rand=noise_rand,
        )
        plans = [di_plan] if tl_plan is None else [tl_plan, di_plan]
        factors, light_drop = lighting.trace_plans(
            plans, sb, tri_rows, trace_scene, cfg.k_shadow,
            opaque_fn=tracer_cuda.make_shadow_opaque_fn(),
            alpha_compact=max(1024, (n // 32) * cfg.alpha_shade_boost),
            shade_boost=cfg.alpha_shade_boost,
        )
        di_f = factors[-1]
        if tl_plan is not None:
            tl_light = lighting.finish_lights(tl_plan, factors[0])
            transparent = g.transparent + trans_lit_sum * tl_light
            g = g._replace(
                transparent=transparent,
                reactive=torch.clamp(transparent.amax(dim=0), max=0.9),
            )

        alpha_dropped = g.alpha_dropped + light_drop
        direct_accum = direct_pass(
            cfg, gp, g, di_ctx, lighting.finish_lights(di_plan, di_f),
        )
    with profiling.stage("rt64.pass.indirect", dev):
        indirect_accum, i_drop = indirect_pass(
            sb, tri_rows, trace_scene, cfg, gp, g, history, pix, bn,
            noise_rand, bg_planes, row_offset,
        )
        alpha_dropped = alpha_dropped + i_drop
    if cfg.refraction_enabled:
        with profiling.stage("rt64.pass.refraction", dev):
            refraction_rgb, r_drop = refraction_pass(
                sb, tri_rows, trace_scene, cfg, gp, g, pix, bn, noise_rand,
                bg_color,
            )
            alpha_dropped = alpha_dropped + r_drop
    else:
        refraction_rgb = torch.zeros((3, n), device=dev)
    refl, alpha_dropped = reflection_bounces(
        sb, tri_rows, trace_scene, cfg, gp,
        ReflectionState(torch.zeros((3, n), device=dev), g.refl_alpha,
                        g.position, g.view_dir, g.normal, g.instance, g.row),
        pix, bn, noise_rand, bg_planes, alpha_dropped,
    )

    with profiling.stage("rt64.pass.compose", dev):
        # DI denoise is compiled out in the reference
        # (rt64_view.cpp:1439-1443).
        filtered_direct = direct_accum[:3]
        if cfg.denoiser_enabled:
            fi = to_image(cfg, indirect_accum[:3])
            for _ in range(cfg.gi_filter_passes):
                fi = filters.gaussian_3x3(fi)
            filtered_indirect = from_image(cfg, fi)
        else:
            filtered_indirect = indirect_accum[:3]
        rt_rgb = to_image(cfg, filters.compose(
            g.diffuse_rgb, g.diffuse_a, filtered_direct, filtered_indirect,
            refl.rgb, refraction_rgb, g.transparent,
        ))

    # Upscale to the display size (rt64_view.cpp:114-141, 1584-1618);
    # the temporal state rides the frame outputs. Motion blur, or the
    # debug view, replaces the display image after.
    with profiling.stage("rt64.pass.upscale", dev):
        disp, new_temporal = upscale(cfg, gp, g, rt_rgb, temporal)
    with profiling.stage("rt64.pass.post", dev):
        if visualization_mode == 0:
            if cfg.motion_blur_enabled:
                flow_disp = filters.bilinear_resize(
                    to_image(cfg, g.flow), cfg.display_height,
                    cfg.display_width)
                disp = filters.motion_blur(
                    disp, flow_disp, (float(w), float(h)),
                    gp.motion_blur_strength, cfg.motion_blur_samples)
        else:
            disp = debug_visualization(
                visualization_mode, cfg, g, direct_accum, indirect_accum,
                filtered_direct, filtered_indirect, refl.rgb, refraction_rgb,
            )

        # Raster foreground (HUD) over the display image
        # (rt64_view.cpp:1657-1661), row-major at display size; a band
        # draws its rows of the whole display.
        if sb.raster_fg.shape[0]:
            dh, dw = disp.shape[1], disp.shape[2]
            disp_rgba = torch.cat([disp, torch.ones((1, dh, dw), device=dev)],
                                  0)
            disp = _raster_layer(disp_rgba, sb, "fg",
                                 row_offset=row_offset * dh // h,
                                 full_height=cfg.display_grid_height)[:3]

    return FrameOutputs(
        image=disp,
        history=History(normal=g.normal, depth=g.depth,
                        direct=direct_accum, indirect=indirect_accum),
        gbuffers=g,
        direct_accum=direct_accum,
        indirect_accum=indirect_accum,
        filtered_direct=filtered_direct,
        filtered_indirect=filtered_indirect,
        reflection=refl.rgb,
        refraction=refraction_rgb,
        rt_output=rt_rgb,
        alpha_dropped=alpha_dropped,
        temporal=new_temporal,
    )


def upscale(cfg, gp, g: GBuffers, rt_rgb, temporal=None):
    """The render-size frame rt_rgb (3, H, W) at the display size, and
    the temporal upscaler's next state (None for the stateless slots):
    the FSR (and AUTO) slot's temporal accumulator, the XeSS slot's
    depth-validated one, the DLSS slot's CNN, or a bilinear resize with
    the upscaler off; then RCAS when cfg.sharpen_enabled. The upscalers
    read the G-buffer planes as images (to_image). temporal None starts
    a fresh history (reset); otherwise gp.temporal_reset says."""
    dh, dw = cfg.display_height, cfg.display_width
    if (dh, dw) == (cfg.rt_height, cfg.rt_width):
        return rt_rgb, None
    img = lambda plane: to_image(cfg, plane)
    new_temporal = None
    channels = ups.temporal_channels(cfg.upscaler)
    if channels:
        reset = gp.temporal_reset
        if temporal is None:
            temporal = torch.zeros((channels, dh, dw), device=rt_rgb.device)
            reset = True
    if cfg.upscaler in (d.UPSCALER_FSR, d.UPSCALER_AUTO):
        disp = ups.temporal_accumulate(
            temporal, rt_rgb, img(g.flow), img(g.reactive), img(g.lock),
            reset, dh, dw)
        new_temporal = disp
    elif cfg.upscaler == d.UPSCALER_XESS:
        disp, new_temporal = ups.xess_accumulate(
            temporal, rt_rgb, img(g.depth), img(g.flow), img(g.reactive),
            reset, dh, dw)
    elif cfg.upscaler == d.UPSCALER_DLSS:
        disp = learned_upscaler._run(
            rt_rgb, img(g.depth), img(g.flow), img(g.reactive), dh, dw)
    else:
        disp = filters.bilinear_resize(rt_rgb, dh, dw)
    # RCAS after the history was taken: the accumulator feeds back the
    # unsharpened image. Its lobe bound assumes display range [0, 1], so
    # clip first (the present clips the same way).
    if cfg.sharpen_enabled and cfg.upscaler != d.UPSCALER_OFF:
        disp = filters.rcas(torch.clamp(disp, 0.0, 1.0),
                            gp.upscaler_sharpness)
    return disp, new_temporal


def debug_visualization(
    mode: int, cfg, g: GBuffers, direct_accum, indirect_accum,
    filtered_direct, filtered_indirect, reflection, refraction,
):
    """DebugPS.hlsl visualization modes (17 in all; an unknown mode
    shows 0.5 grey). Returns (3, DH, DW): the view at the display size."""
    h, w = cfg.rt_height, cfg.rt_width

    def img3(x):
        return to_image(cfg, x)

    def img1(x):
        return to_image(cfg, x[None]).expand(3, h, w)

    planes = {
        d.VISUALIZATION_MODE_SHADING_POSITION: lambda: img3(g.position),
        d.VISUALIZATION_MODE_SHADING_NORMAL: lambda: img3((g.normal + 1.0) / 2.0),
        d.VISUALIZATION_MODE_SHADING_SPECULAR: lambda: img3(g.specular),
        d.VISUALIZATION_MODE_DIFFUSE: lambda: img3(g.diffuse_rgb),
        d.VISUALIZATION_MODE_INSTANCE_ID: lambda: img3(_instance_colors(g.instance)),
        d.VISUALIZATION_MODE_DIRECT_LIGHT_RAW: lambda: img3(direct_accum[:3]),
        d.VISUALIZATION_MODE_DIRECT_LIGHT_FILTERED: lambda: img3(filtered_direct),
        d.VISUALIZATION_MODE_INDIRECT_LIGHT_RAW: lambda: img3(indirect_accum[:3]),
        d.VISUALIZATION_MODE_INDIRECT_LIGHT_FILTERED: lambda: img3(filtered_indirect),
        d.VISUALIZATION_MODE_REFLECTION: lambda: img3(reflection),
        d.VISUALIZATION_MODE_REFRACTION: lambda: img3(refraction),
        d.VISUALIZATION_MODE_TRANSPARENT: lambda: img3(g.transparent),
        d.VISUALIZATION_MODE_FLOW: lambda: _flow_visualization(cfg, to_image(cfg, g.flow)),
        d.VISUALIZATION_MODE_REACTIVE_MASK: lambda: img1(g.reactive),
        d.VISUALIZATION_MODE_LOCK_MASK: lambda: img1(g.lock),
        d.VISUALIZATION_MODE_DEPTH: lambda: img1(g.depth),
    }
    make = planes.get(mode)
    if make is None:
        out = torch.full((3, h, w), 0.5, device=g.depth.device)
    else:
        out = make()
    return filters.bilinear_resize(out, cfg.display_height, cfg.display_width)


def _instance_colors(instance):
    """Per-instance random colours (DebugPS.hlsl): initRand(instance, 0)
    and three nextRand draws; black where nothing was hit."""
    seed = rnd.init_rand(torch.clamp(instance, min=0).to(torch.int64),
                         torch.zeros_like(instance, dtype=torch.int64))
    seed, r = rnd.next_rand(seed)
    seed, gg = rnd.next_rand(seed)
    seed, b = rnd.next_rand(seed)
    return torch.stack([r, gg, b], 0) * (instance >= 0)[None]


def _flow_visualization(cfg, flow):
    """Motion-vector line drawing (DebugPS.hlsl:15-46): a line from each
    32-pixel block's centre along its flow. flow: (2, H, W)."""
    h, w = cfg.rt_height, cfg.rt_width
    dev = flow.device
    block = 32.0
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    cx = torch.floor(xx / block) * block + block * 0.5
    cy = torch.floor(yy / block) * block + block * 0.5
    cxi = torch.clamp(cx.to(torch.int64), 0, w - 1)
    cyi = torch.clamp(cy.to(torch.int64), 0, h - 1)
    flat = (cyi * w + cxi).reshape(-1)
    fx = flow[0].reshape(-1)[flat].reshape(h, w)
    fy = flow[1].reshape(-1)[flat].reshape(h, w)
    px = cx + fx
    py = cy + fy
    dx = px - cx
    dy = py - cy
    l2 = dx * dx + dy * dy
    t = torch.clamp(((xx - cx) * dx + (yy - cy) * dy)
                    / torch.clamp(l2, min=1e-12), 0.0, 1.0)
    qx = cx + t * dx
    qy = cy + t * dy
    dist = torch.sqrt((xx - qx) ** 2 + (yy - qy) ** 2)
    dist = torch.where(l2 > 0.0, dist, torch.sqrt((xx - cx) ** 2 + (yy - cy) ** 2))
    on = (dist < 1.0).to(torch.float32)
    return on[None].expand(3, h, w)


def present_rgb8(image: torch.Tensor) -> torch.Tensor:
    """Pack the presented frame ON DEVICE (view.py:286-292): (3, H, W)
    linear float -> (H, W, 3) uint8, so present reads back 1 byte per
    channel."""
    rgb = torch.clamp(image * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
    return rgb.permute(1, 2, 0).contiguous()
