"""Image-space stages — planar layout: the compose pass (diffuse, direct
and indirect light, the reflection and refraction planes, transparency),
the GI denoise filter, the quad-packed bilinear fetch, the fixed-grid
resize the upscalers and debug views use, RCAS sharpening, motion blur
and flow-based frame interpolation."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

EPSILON = 1e-6


def compose(diffuse_rgb, diffuse_a, direct, indirect, reflection, refraction,
            transparent):
    """ComposePS (ComposePS.hlsl:18-37). All (3, N) planes + (N,) alpha.

    result = lerp(diffuse, diffuse*(direct+indirect), diffuse.a)
             + reflection + refraction + transparent, when diffuse.a>0.
    """
    lit = diffuse_rgb * (direct + indirect)
    a = diffuse_a[None]
    result = diffuse_rgb * (1.0 - a) + lit * a
    result = result + reflection + refraction + transparent
    return torch.where(a > EPSILON, result, diffuse_rgb)


# 3x3 gaussian weights (GaussianFilterRGB3x3CS.hlsl).
_W_CENTER = 0.195346
_W_EDGE = 0.123317
_W_CORNER = 0.077847


def gaussian_3x3(img):
    """3x3 gaussian with border renormalization. img: (C, H, W)."""
    c, h, w = img.shape
    pad = F.pad(img, (1, 1, 1, 1))
    ones = F.pad(torch.ones((1, h, w), dtype=img.dtype, device=img.device),
                 (1, 1, 1, 1))

    def taps(a):
        acc = torch.zeros_like(a[:, 1:-1, 1:-1])
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                wgt = (
                    _W_CENTER if (dx == 0 and dy == 0)
                    else _W_EDGE if (dx == 0 or dy == 0)
                    else _W_CORNER
                )
                acc = acc + wgt * a[:, 1 + dy : h + 1 + dy, 1 + dx : w + 1 + dx]
        return acc

    return taps(pad) / torch.clamp(taps(ones), min=1e-12)


def rcas(img, sharpness):
    """Robust contrast-adaptive sharpen (RCAS) of a (3, H, W) image in
    display range [0, 1]: the AMD FSR1 RCAS formula (cross-neighbourhood
    negative lobe, clamped so the 4-tap kernel never rings) scaled by
    `sharpness` — identity at 0, the strongest stable sharpening at 1.
    The upscalerSharpness consumer (rt64_fsr.cpp:141-166,
    rt64_dlss.cpp:193-227). Sharpness outside [0, 1] is clamped into it
    (the JAX package does not clamp: ROADMAP queue 3)."""
    c, h, w = img.shape
    if isinstance(sharpness, torch.Tensor):
        sharpness = torch.clamp(sharpness, 0.0, 1.0)
    else:
        sharpness = min(max(float(sharpness), 0.0), 1.0)
    pad = F.pad(img[None], (1, 1, 1, 1), mode="replicate")[0]
    e = img
    b = pad[:, 0:h, 1 : w + 1]  # north
    d = pad[:, 1 : h + 1, 0:w]  # west
    f = pad[:, 1 : h + 1, 2 : w + 2]  # east
    hh = pad[:, 2 : h + 2, 1 : w + 1]  # south
    # Per-channel limiters (AMD's lobeR/G/B); the most restrictive one
    # (closest to zero) drives one shared lobe.
    mn = torch.minimum(torch.minimum(torch.minimum(b, d), torch.minimum(f, hh)), e)
    mx = torch.maximum(torch.maximum(torch.maximum(b, d), torch.maximum(f, hh)), e)
    # out = (lobe*sum4 + e) / (4*lobe + 1) stays in [0, 1] when
    # lobe >= max(-mn/(4*mx), (1-mx)/(4*mn-4)) per channel.
    hit_min = -(mn / torch.clamp(4.0 * mx, min=1e-4))
    hit_max = (1.0 - mx) / torch.clamp(4.0 * mn - 4.0, max=-1e-4)
    lobe = torch.maximum(hit_min, hit_max).amax(dim=0, keepdim=True)
    # RCAS_LIMIT = 0.25 - 1/16: the fixed stability clamp.
    lobe = torch.clamp(lobe, -(0.25 - 1.0 / 16.0), 0.0) * sharpness
    return (lobe * (b + d + f + hh) + e) / (4.0 * lobe + 1.0)


def quad_pack_planar(img, dtype=None):
    """(C, H, W) -> (H*W, 4C): per pixel, the channel values of itself
    and its +x, +y, +xy neighbors (edge-clamped), so a bilinear fetch is
    one row gather. Laid out row-major so that a row gather reads
    contiguous memory. dtype (e.g. torch.bfloat16) compresses the
    packed storage; bilinear_quad blends in f32 either way."""
    c, h, w = img.shape
    xs = torch.cat([img[:, :, 1:], img[:, :, -1:]], dim=2)
    ys = torch.cat([img[:, 1:, :], img[:, -1:, :]], dim=1)
    xys = torch.cat([ys[:, :, 1:], ys[:, :, -1:]], dim=2)
    quad = torch.cat([img, xs, ys, xys], 0).reshape(4 * c, h * w)
    if dtype is not None:
        quad = quad.to(dtype)
    return quad.T.contiguous()


def bilinear_quad(packed, c, h, w, su, sv):
    """Bilinear fetch from a quad-packed image (quad_pack_planar): one
    (N, 4C) row gather + vector blend. Returns (C, N). The gather index
    is clamped by hand (NaN coordinates included): torch raises where
    JAX clamps."""
    x = torch.clamp(su * w - 0.5, 0.0, w - 1.0)
    y = torch.clamp(sv * h - 0.5, 0.0, h - 1.0)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    flat = torch.clamp(y0.to(torch.int64) * w + x0, 0, h * w - 1)
    g = packed[flat]  # (N, 4C): the gather
    p00 = g[:, :c]
    p10 = g[:, c : 2 * c]
    p01 = g[:, 2 * c : 3 * c]
    p11 = g[:, 3 * c :]
    out = (
        p00 * (1 - fx) * (1 - fy)
        + p10 * fx * (1 - fy)
        + p01 * (1 - fx) * fy
        + p11 * fx * fy
    )
    return out.T


def bilinear_planar(img, su, sv):
    """Bilinear fetch of a (C, H, W) planar image at uv (N,) each."""
    c, h, w = img.shape
    return bilinear_quad(quad_pack_planar(img), c, h, w, su, sv)


def _uv_grid(h, w, device):
    yy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    xx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    su = xx[None, :].expand(h, w).reshape(-1)
    sv = yy[:, None].expand(h, w).reshape(-1)
    return su, sv


def _resize_weights(n_out: int, n_in: int, kernel: str = "bilinear"):
    """(n_out, n_in) interpolation matrix for the fixed (i + 0.5) / n_out
    grid. "bilinear" matches bilinear_quad's clip/floor/frac math on that
    grid; "catmull" is the 4-tap Catmull-Rom cubic (the XeSS slot's
    spatial kernel), edge-clamped, taps on one clamped texel summed."""
    x = (np.arange(n_out, dtype=np.float64) + 0.5) / n_out * n_in - 0.5
    x = np.clip(x, 0.0, n_in - 1.0)
    x0 = np.floor(x).astype(np.int64)
    f = (x - x0).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    if kernel == "bilinear":
        x1 = np.minimum(x0 + 1, n_in - 1)
        np.add.at(m, (rows, x0), 1.0 - f)
        np.add.at(m, (rows, x1), f)
        return m
    if kernel != "catmull":
        raise ValueError(f"unknown resize kernel {kernel!r}")
    # Catmull-Rom: w(-1..2) over taps x0-1..x0+2 as polynomials in f.
    w_m1 = 0.5 * (-f + 2.0 * f * f - f * f * f)
    w_0 = 0.5 * (2.0 - 5.0 * f * f + 3.0 * f * f * f)
    w_p1 = 0.5 * (f + 4.0 * f * f - 3.0 * f * f * f)
    w_p2 = 0.5 * (-f * f + f * f * f)
    for off, wv in ((-1, w_m1), (0, w_0), (1, w_p1), (2, w_p2)):
        np.add.at(m, (rows, np.clip(x0 + off, 0, n_in - 1)), wv)
    return m


@functools.lru_cache(maxsize=64)
def _resize_band(n_out: int, n_in: int, kernel: str, device):
    """The nonzero entries of _resize_weights as a band on the device:
    (cols, weights), each (taps, n_out), in ascending column order per
    row; rows with fewer nonzeros pad with weight 0. Built once per
    size, kernel and device."""
    m = _resize_weights(n_out, n_in, kernel)
    rows, cols = np.nonzero(m)
    start = np.searchsorted(rows, np.arange(n_out))
    rank = np.arange(rows.size) - start[rows]
    taps = int(rank.max()) + 1
    band_c = np.zeros((taps, n_out), np.int64)
    band_w = np.zeros((taps, n_out), np.float32)
    band_c[rank, rows] = cols
    band_w[rank, rows] = m[rows, cols]
    return (torch.from_numpy(band_c).to(device),
            torch.from_numpy(band_w).to(device))


def _resize_axis(img, n_out: int, dim: int, kernel: str):
    """One factor of the separable resize along dim 1 (rows) or 2
    (columns) of a (C, H, W) image: the product with the weight matrix,
    its zero entries skipped. Plain f32 multiplies and adds in the
    matrix's column order, so no matmul precision setting (TF32) can
    touch the result, which feeds the temporal upscalers' history."""
    cols, wts = _resize_band(n_out, img.shape[dim], kernel, img.device)
    shape = (1, n_out, 1) if dim == 1 else (1, 1, n_out)
    out = None
    for k in range(cols.shape[0]):
        tap = img.index_select(dim, cols[k]) * wts[k].reshape(shape)
        out = tap if out is None else out + tap
    return out


def bilinear_resize(img, out_h: int, out_w: int, kernel: str = "bilinear"):
    """Fixed-output-grid resize of a (C, H, W) image: rows then columns,
    each the product with a banded weight matrix (_resize_weights).
    kernel="catmull" swaps in the 4-tap Catmull-Rom cubic."""
    c, h, w = img.shape
    if (out_h, out_w) == (h, w):
        return img
    return _resize_axis(_resize_axis(img, out_h, 1, kernel), out_w, 2, kernel)


def motion_blur(output, flow_img, resolution_xy, strength, samples: int):
    """PostProcessPS (PostProcessPS.hlsl:13-35): blur along the flow.

    output: (3, H, W); flow_img: (2, H, W) in render pixels, resized to
    H x W; resolution_xy: the render size the flow is measured in;
    strength: a 0-d tensor or a float. Pixels without flow keep their
    value; the others take the mean of `samples` taps of the bf16 pack
    (at strength 0, each tap the pixel itself). The view runs no blur at
    strength 0 (RenderConfig.motion_blur_enabled)."""
    if samples <= 0:
        return output
    _, h, w = output.shape
    su, sv = _uv_grid(h, w, output.device)
    flow_u = flow_img[0].reshape(-1) / resolution_xy[0]
    flow_v = flow_img[1].reshape(-1) / resolution_xy[1]
    flow_len = torch.sqrt(flow_u * flow_u + flow_v * flow_v)
    step = strength / samples
    start_u = su - flow_u * (strength * 0.5)
    start_v = sv - flow_v * (strength * 0.5)
    # Packed once for every tap, in bf16 as in the JAX package (a
    # one-shot gather of colour: bf16's step is below the RGB8 quantum).
    packed = quad_pack_planar(output, torch.bfloat16)
    acc = torch.zeros((3, h * w), device=output.device)
    for s in range(samples):
        sf = float(s) * step
        uu = torch.clamp(start_u + flow_u * sf, 0.0, 1.0)
        vv = torch.clamp(start_v + flow_v * sf, 0.0, 1.0)
        acc = acc + bilinear_quad(packed, 3, h, w, uu, vv)
    blurred = (acc / samples).reshape(3, h, w)
    active = (flow_len > 1e-6).reshape(1, h, w)
    return torch.where(active, blurred, output)


def interpolate_frame(prev_img, cur_img, flow_img, t=0.5):
    """Flow-based frame between two presented frames. prev_img/cur_img:
    (3, H, W) display images; flow_img: (2, H, W) display-resolution
    motion with the frame graph's convention (the content at p was at
    p + flow the frame before). The frame at fraction t from prev toward
    cur samples prev at p + t*flow and cur at p - (1-t)*flow and blends
    them; where the flow is zero it is a plain blend."""
    c, h, w = cur_img.shape
    dev = cur_img.device
    yy = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    xx = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    px = xx[None, :].expand(h, w)
    py = yy[:, None].expand(h, w)
    fx, fy = flow_img[0], flow_img[1]

    def warp(img, sx, sy):
        su = torch.clamp(sx / w, 0.0, 1.0).reshape(-1)
        sv = torch.clamp(sy / h, 0.0, 1.0).reshape(-1)
        return bilinear_planar(img, su, sv).reshape(c, h, w)

    from_prev = warp(prev_img, px + t * fx, py + t * fy)
    from_cur = warp(cur_img, px - (1.0 - t) * fx, py - (1.0 - t) * fy)
    return from_prev * (1.0 - t) + from_cur * t
