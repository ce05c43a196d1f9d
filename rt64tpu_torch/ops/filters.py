"""Image-space stages — planar layout: the compose pass (diffuse, direct
and indirect light, the reflection and refraction planes, transparency),
the GI denoise filter and the quad-packed bilinear fetch the background
plane is sampled with. Motion blur, sharpening and the bilinear resize
arrive with ROADMAP queue 1 item 12."""

from __future__ import annotations

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


def quad_pack_planar(img):
    """(C, H, W) -> (H*W, 4C): per pixel, the channel values of itself
    and its +x, +y, +xy neighbors (edge-clamped), so a bilinear fetch is
    one row gather. Kept in f32, and laid out row-major so that a row
    gather reads contiguous memory."""
    c, h, w = img.shape
    xs = torch.cat([img[:, :, 1:], img[:, :, -1:]], dim=2)
    ys = torch.cat([img[:, 1:, :], img[:, -1:, :]], dim=1)
    xys = torch.cat([ys[:, :, 1:], ys[:, :, -1:]], dim=2)
    return torch.cat([img, xs, ys, xys], 0).reshape(4 * c, h * w).T.contiguous()


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
