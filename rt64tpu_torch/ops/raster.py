"""Raster path: clip-space triangles with combiner shading + blending.

The reference classifies instances into raytraced / raster-background /
raster-foreground (rt64_view.cpp:1081-1147) and draws the raster sets
with runtime-generated VS/PS pairs (rt64_shader.cpp:312-442): the VS is
a passthrough (positions arrive in clip space), the PS runs the color
combiner, and the output blends with src-alpha / inv-src-alpha, no
depth test, no culling (rt64_shader.cpp:408-441). Background instances
render before raytracing (rays sample the result as the background
plane, rt64_view.cpp:1292-1319); foreground instances (HUD) render last
(rt64_view.cpp:1657-1661).

Each raster triangle is rasterized with planar edge functions and
perspective-correct interpolation, then alpha-blended over the image in
submission order. Everything a triangle's draw state holds (corners,
viewport, scissor, combiner, texture bindings, sampler) is read from
the packer's host copies, so the loop issues only the per-pixel work
and never reads the device. A triangle whose three clip w are positive
is evaluated over its pixel bounding box, widened by a margin that
covers the rounding of the edge functions; outside it the triangle
covers no pixel centre, its alpha is 0 and the blend leaves the image
as it was, so the result equals the full-screen evaluation, which the
other triangles take.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from rt64tpu_torch.ops import texture as tex_ops
from rt64tpu_torch.ops.combiner import combiner_eval_planar
from rt64tpu_torch.pipeline import rows as R

# Raster row layout (host-packed per frame): clip-space corners + attrs.
RR_POS = 0  # 12: xyzw x3 corners
RR_UV = 12  # 6
RR_IN1 = 18  # 12: rgba x3
RR_IN2 = 30  # 12
RR_INST = 42
RR_WIDTH = 44

# Per corner k, the 10 interpolated channels: u, v, input 1 rgba,
# input 2 rgba.
_ATTR_COLS = np.array([
    [RR_UV + 2 * k, RR_UV + 2 * k + 1]
    + [RR_IN1 + 4 * k + c for c in range(4)]
    + [RR_IN2 + 4 * k + c for c in range(4)]
    for k in range(3)
], np.int64)

_F = np.float32
_EPS = _F(1e-12)
# Relative rounding of one edge function (three roundings of products
# and differences of f32 values), with a factor 2 to spare.
_EDGE_ROUNDING = 6.0 * 2.0 ** -24 * 2.0
_MIN_MARGIN = 2

_CONST = {}


def _cached(device, name, make):
    """A constant tensor, uploaded once per device (no copy per call)."""
    key = (str(device), name)
    t = _CONST.get(key)
    if t is None:
        t = torch.from_numpy(make()).to(device)
        _CONST[key] = t
    return t


def _const4(device, rgba):
    """A cached (4, 1, 1) constant rgba plane."""
    return _cached(device, rgba,
                   lambda: np.asarray(rgba, np.float32).reshape(4, 1, 1))


def _upload(arr, device):
    """A host array on the device: pinned and without a sync on the
    card, so the loop never waits for the queue."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def _attribute_table(raster_rows: torch.Tensor) -> torch.Tensor:
    """(RB, 3, 10) per-corner attributes of every row, one gather on the
    rows' device."""
    return raster_rows[:, _cached(raster_rows.device, "attr", lambda: _ATTR_COLS)]


def _corner(row, k, vx, vy, vw, vh):
    """Clip -> pixel coords of corner k (D3D: y-down NDC), f32 on the
    host as the JAX package computes them."""
    cx, cy, cw = row[RR_POS + 4 * k], row[RR_POS + 4 * k + 1], row[RR_POS + 4 * k + 3]
    inv_w = _F(1.0) / (cw if abs(cw) > _EPS else _F(1.0))
    sx = vx + (cx * inv_w * _F(0.5) + _F(0.5)) * vw
    sy = vy + (_F(0.5) - cy * inv_w * _F(0.5)) * vh
    return sx, sy, inv_w


def _pixel_box(xs, ys, clip_w, area, width, height, scissor):
    """(x0, x1, y0, y1) pixel range that holds every pixel centre the
    triangle can cover, or the whole target when the triangle does not
    qualify (a clip w <= 0, no area, coordinates far off the target).

    Margin: a pixel outside the triangle's box by r has, for one edge,
    a true edge function of at least r * h_min / 2 in magnitude (h_min:
    the smallest altitude), while the f32 edge function of a pixel at
    distance D from the edge's start errs by at most _EDGE_ROUNDING * L
    * D (L: the edge's length). The box is widened until the first
    bound exceeds the second, so no rounding can admit a pixel outside.
    """
    full = (0, width, 0, height)
    pts = np.array([xs, ys], np.float64)
    if (min(clip_w) <= _EPS or not np.all(np.isfinite(pts))
            or np.abs(pts).max() > 8 * max(width, height)):
        return full
    edges = [np.hypot(*(pts[:, (k + 1) % 3] - pts[:, k])) for k in range(3)]
    l_max = max(edges)
    h_min = 2.0 * abs(float(area)) / l_max if l_max > 0 else 0.0
    if h_min <= 0.0:
        return full
    reach = np.abs(pts).max() + width + height
    margin = max(_MIN_MARGIN, math.ceil(
        2.0 * 2.0 * _EDGE_ROUNDING * l_max * reach / h_min))
    lo_x, hi_x = pts[0].min() - margin, pts[0].max() + margin
    lo_y, hi_y = pts[1].min() - margin, pts[1].max() + margin
    if scissor is not None:
        sx, sy, sw, sh = (float(v) for v in scissor)
        lo_x, hi_x = max(lo_x, sx - 1.0), min(hi_x, sx + sw + 1.0)
        lo_y, hi_y = max(lo_y, sy - 1.0), min(hi_y, sy + sh + 1.0)
    # Pixel x holds the centre x + 0.5.
    x0 = max(0, math.floor(lo_x - 0.5))
    x1 = min(width, math.ceil(hi_x - 0.5) + 1)
    y0 = max(0, math.floor(lo_y - 0.5))
    y1 = min(height, math.ceil(hi_y - 0.5) + 1)
    return x0, max(x0, x1), y0, max(y0, y1)


class _Triangle(NamedTuple):
    """One raster triangle's draw setup, computed on the host in f32."""

    row: int  # its raster row
    inst: int
    box: tuple  # (x0, x1, y0, y1) pixel range, empty when x0 >= x1
    scalars: tuple  # _COLS, in order
    has_scissor: bool


# Per-triangle scalars the pixel work reads, one column each: the box
# origin, the screen corners, 1/w per corner, the area and its guarded
# inverse, and the scissor rectangle's edges.
_COLS = ("ox", "oy", "x0", "y0", "x1", "y1", "x2", "y2", "w0", "w1", "w2",
         "area", "inv_area", "sc_x0", "sc_x1", "sc_y0", "sc_y1", "has_sc")
_C = {name: j for j, name in enumerate(_COLS)}
# Pixels (triangles x box) evaluated in one batch.
_BATCH_PIXELS = 1 << 22


def _setup(ti, row, instance_rows, width, height, bounding_box):
    """The host side of raster row ti (viewport transform, area,
    scissor, pixel box)."""
    row = np.asarray(row, np.float32)
    inst = max(int(row[RR_INST]), 0)
    irow = np.asarray(instance_rows[inst], np.float32)
    # Viewport (instance row; w/h == 0 means the full target).
    vx, vy, vw, vh = irow[R.I_VIEWPORT : R.I_VIEWPORT + 4]
    vw = vw if vw > _F(0.0) else _F(width)
    vh = vh if vh > _F(0.0) else _F(height)
    (x0, y0, w0), (x1, y1, w1), (x2, y2, w2) = (
        _corner(row, k, vx, vy, vw, vh) for k in range(3))
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    inv_area = _F(1.0) / (area if abs(area) > _EPS else _F(1.0))
    sc = irow[R.I_SCISSOR : R.I_SCISSOR + 4]
    has_sc = bool(sc[2] > _F(0.0)) and bool(sc[3] > _F(0.0))
    if bounding_box:
        box = _pixel_box((x0, x1, x2), (y0, y1, y2),
                         row[RR_POS + 3 : RR_POS + 12 : 4], area, width,
                         height, sc if has_sc else None)
    else:
        box = (0, width, 0, height)
    scalars = (0.0, 0.0, x0, y0, x1, y1, x2, y2, w0, w1, w2, area, inv_area,
               sc[0], sc[0] + sc[2], sc[1], sc[1] + sc[3], float(has_sc))
    return _Triangle(ti, inst, box, scalars, has_sc)


def _batches(tris):
    """Runs of consecutive rows of one instance (one draw state), cut at
    _BATCH_PIXELS of (triangles x common box) and at a triangle that
    covers no pixel centre (not drawn)."""
    run = []
    for t in tris:
        if t.box[0] >= t.box[1] or t.box[2] >= t.box[3]:
            if run:
                yield run
            run = []
            continue
        bh = max([b.box[3] - b.box[2] for b in run] + [t.box[3] - t.box[2]])
        bw = max([b.box[1] - b.box[0] for b in run] + [t.box[1] - t.box[0]])
        if run and (t.inst != run[0].inst
                    or (len(run) + 1) * bh * bw > _BATCH_PIXELS):
            yield run
            run = []
        run.append(t)
    if run:
        yield run


def rasterize(image, raster_rows, raster_count, rows_host, instance_rows,
              quad_pool, quad_records, bounding_box: bool = True,
              row_offset: int = 0, full_height: int = 0):
    """Blend raster triangles over image; returns the new (4, H, W).

    image: (4, H, W) rgba target (not modified); raster_rows: (RB,
    RR_WIDTH) packed triangles on the image's device, in submission
    order; raster_count: the valid rows (a host int); rows_host,
    instance_rows (I, IROW) and quad_records (Rec, 3): the packer's host
    copies of the rows, the instance rows and the quad-pool records;
    quad_pool: the device pool. bounding_box=False evaluates every
    triangle over the whole target (the reference for the box path).
    Under row tiling image holds rows row_offset.. of a target
    full_height tall: viewports and pixel centres are the whole
    target's, and each box is cut to the band.

    Consecutive triangles of one instance are shaded together over a
    common box size (each box placed to hold its triangle's), then
    blended one after another in submission order.
    """
    count = int(raster_count)
    if count == 0:
        return image
    _, height, width = image.shape
    attrs = _attribute_table(raster_rows[:count])
    band = (row_offset, row_offset + height)
    tris = [_setup(ti, rows_host[ti], instance_rows, width,
                   full_height or height, bounding_box)
            for ti in range(count)]
    tris = [t._replace(box=(t.box[0], t.box[1], max(t.box[2], band[0]),
                            min(t.box[3], band[1]))) for t in tris]
    out = image.clone()
    for run in _batches(tris):
        _draw_batch(out, run, attrs[run[0].row : run[-1].row + 1],
                    instance_rows[run[0].inst], quad_pool, quad_records,
                    row_offset)
    return out


def _draw_batch(out, run, a, irow, quad_pool, quad_records, row_offset=0):
    """Shade the triangles of one run (same instance; a: their (K, 3
    corners, 10 channels) attributes) over a common box size and blend
    them over out (rows row_offset.. of the target), in order."""
    _, height, width = out.shape
    dev = out.device
    bh = max(t.box[3] - t.box[2] for t in run)
    bw = max(t.box[1] - t.box[0] for t in run)
    table = np.array([t.scalars for t in run], np.float32)
    # Each box starts at its triangle's box, moved back to fit the band.
    origin = [(min(t.box[0], width - bw),
               min(t.box[2], row_offset + height - bh)) for t in run]
    table[:, _C["ox"]] = [o[0] for o in origin]
    table[:, _C["oy"]] = [o[1] for o in origin]
    tab = _upload(table, dev)
    col = lambda name: tab[:, _C[name], None, None]  # (K, 1, 1)

    px = col("ox") + (_cached(dev, ("x", bw), lambda: np.arange(bw, dtype=np.float32))
                      + 0.5)[None, None, :]
    py = col("oy") + (_cached(dev, ("y", bh), lambda: np.arange(bh, dtype=np.float32))
                      + 0.5)[None, :, None]

    # Edge functions at pixel centres, either winding (CULL_MODE_NONE).
    def edge(a, b):
        ax, ay, bx, by = col(f"x{a}"), col(f"y{a}"), col(f"x{b}"), col(f"y{b}")
        return (bx - ax) * (py - ay) - (by - ay) * (px - ax)

    e01, e12, e20 = edge(0, 1), edge(1, 2), edge(2, 0)
    inside = torch.where(
        col("area") >= 0.0,
        (e01 >= 0.0) & (e12 >= 0.0) & (e20 >= 0.0),
        (e01 <= 0.0) & (e12 <= 0.0) & (e20 <= 0.0),
    )
    inv_area = col("inv_area")
    b0, b1, b2 = e12 * inv_area, e20 * inv_area, e01 * inv_area

    # Scissor (pixel-space clip), where both extents are set.
    if any(t.has_scissor for t in run):
        in_sc = ((px >= col("sc_x0")) & (px < col("sc_x1"))
                 & (py >= col("sc_y0")) & (py < col("sc_y1")))
        inside = inside & (in_sc | (col("has_sc") == 0.0))

    # Perspective-correct interpolation weights.
    bw0, bw1, bw2 = b0 * col("w0"), b1 * col("w1"), b2 * col("w2")
    pw = bw0 + bw1 + bw2
    inv_pw = 1.0 / torch.where(torch.abs(pw) > float(_EPS), pw, 1.0)
    q = [(bwk * inv_pw)[:, None] for bwk in (bw0, bw1, bw2)]
    att = (a[:, 0, :, None, None] * q[0] + a[:, 1, :, None, None] * q[1]
           + a[:, 2, :, None, None] * q[2]).transpose(0, 1)  # (10, K, bh, bw)
    uv_u, uv_v = att[0], att[1]
    in1, in2 = att[2:6], att[6:10]

    # Combiner + texture from the instance row: the run's draw state,
    # read on the host and uploaded beside the table, broadcast over the
    # box by the same planar functions the ray shading uses.
    irow = np.asarray(irow, np.float32)
    flags = int(irow[R.I_FLAGS])
    sampler = int(irow[R.I_SAMPLER])
    rec_d = int(irow[R.I_TEX_D]) if flags & R.F_USE_T0 else -1
    rec_d2 = int(irow[R.I_TEX_D2]) if flags & R.F_USE_T1 else -1
    cc = int(irow[R.I_CC])
    st = _upload(np.array(
        [*tex_ops.scalar_record(quad_records, rec_d), rec_d >= 0,
         *tex_ops.scalar_record(quad_records, rec_d2), rec_d2 >= 0,
         (sampler & 3) == 1, (sampler >> 2) & 3, (sampler >> 4) & 3,
         bool(flags & R.F_OPT_ALPHA), bool(flags & R.F_ALPHA_SAME)]
        + [(cc >> (3 * i)) & 7 for i in range(8)], np.int32), dev)
    filt, h_addr, v_addr = st[8] != 0, st[9], st[10]
    tex0 = tex_ops.sample_quad_cols(quad_pool, st[0], st[1], st[2],
                                    st[3] != 0, uv_u, uv_v, filt, h_addr,
                                    v_addr)
    # TEXEL1: the second binding when set, else the reference's magenta
    # stub (rt64_shader.cpp:484-487).
    tex1 = torch.where(
        st[7] != 0,
        tex_ops.sample_quad_cols(quad_pool, st[4], st[5], st[6], st[7] != 0,
                                 uv_u, uv_v, filt, h_addr, v_addr),
        _const4(dev, (1.0, 0.0, 1.0, 1.0))[:, None])
    zero4 = _const4(dev, (0.0, 0.0, 0.0, 1.0))[:, None]  # (4, 1, 1, 1)
    color = combiner_eval_planar(st[13:21], st[11] != 0, st[12] != 0,
                                 in1, in2, zero4, zero4, tex0, tex1)

    # Alpha blend, one triangle after another: src_alpha /
    # inv_src_alpha for color, ONE / inv_src_alpha for alpha
    # (rt64_shader.cpp:408-414): image * (1 - sa) + color * sa.
    sa = torch.where(inside, color[3], 0.0)
    keep = 1.0 - sa
    src = color[:3] * sa[None]
    for k, (ox, oy) in enumerate(origin):
        region = out[:, oy - row_offset : oy - row_offset + bh, ox : ox + bw]
        region[:3].mul_(keep[k][None]).add_(src[:, k])
        region[3].mul_(keep[k]).add_(sa[k])
