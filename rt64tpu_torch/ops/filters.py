"""Image-space stages — planar layout: the compose pass (diffuse, direct
and indirect light, the reflection and refraction planes, transparency)
and the GI denoise filter. Motion blur, sharpening and the bilinear
blits arrive with ROADMAP queue 1 item 12."""

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
