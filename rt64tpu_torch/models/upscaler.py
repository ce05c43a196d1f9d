"""Upscaler slot: quality policy, temporal (FSR2-style) and XeSS-style
accumulators, and the entry to the learned slot.

Replaces the Upscaler plugin interface (rt64_upscaler.h:43-50) and its
three vendor backends (rt64_dlss.cpp, rt64_fsr.cpp, rt64_xess.cpp):

  * quality -> resolution policy (getQualityAuto, rt64_upscaler.cpp:11-36,
    plus FSR's forced UltraQuality=77% / Native, rt64_fsr.cpp:98-126)
  * jitter phase count (ffxFsr2GetJitterPhaseCount's 8*(disp/render)^2;
    DLSS/XeSS report 64 phases, rt64_dlss.cpp:189-191)
  * the FSR slot: a temporal accumulator consuming the inputs the
    reference feeds FSR2 (colour, flow, reactive/lock masks, jitter)
  * the XeSS slot: a depth-validated accumulator over a Catmull-Rom
    upsample
  * the DLSS slot: a CNN (models/learned_upscaler.py)

All planes are (C, H, W) images in row-major order; the accumulators
keep their history in f32.
"""

from __future__ import annotations

import math

import torch

from rt64tpu_torch import descriptors as d
from rt64tpu_torch.ops import filters

QUALITY_SCALE = {
    d.UPSCALER_MODE_ULTRA_PERFORMANCE: 1.0 / 3.0,
    d.UPSCALER_MODE_PERFORMANCE: 1.0 / 2.0,
    d.UPSCALER_MODE_BALANCED: 1.0 / 1.7,
    d.UPSCALER_MODE_QUALITY: 1.0 / 1.5,
    d.UPSCALER_MODE_ULTRA_QUALITY: 0.77,
    d.UPSCALER_MODE_NATIVE: 1.0,
}

# XeSS's own quality -> input-resolution policy (xessGetInputResolution,
# rt64_xess.cpp:94-124): UltraQuality is a 1.3x ratio, and
# UltraPerformance/Native are forced to 1/3 and 1:1 (rt64_xess.cpp:103-111).
XESS_QUALITY_SCALE = {
    d.UPSCALER_MODE_ULTRA_PERFORMANCE: 1.0 / 3.0,
    d.UPSCALER_MODE_PERFORMANCE: 1.0 / 2.0,
    d.UPSCALER_MODE_BALANCED: 1.0 / 1.7,
    d.UPSCALER_MODE_QUALITY: 1.0 / 1.5,
    d.UPSCALER_MODE_ULTRA_QUALITY: 1.0 / 1.3,
    d.UPSCALER_MODE_NATIVE: 1.0,
}


def quality_auto(display_width: int, display_height: int) -> int:
    """getQualityAuto thresholds (rt64_upscaler.cpp:11-36)."""
    pixels = display_width * display_height
    if pixels <= 1280 * 720:
        return d.UPSCALER_MODE_ULTRA_QUALITY
    if pixels <= 1920 * 1080:
        return d.UPSCALER_MODE_QUALITY
    if pixels <= 2560 * 1440:
        return d.UPSCALER_MODE_BALANCED
    if pixels <= 3840 * 2160:
        return d.UPSCALER_MODE_PERFORMANCE
    return d.UPSCALER_MODE_ULTRA_PERFORMANCE


def quality_resolution(quality: int, display_width: int, display_height: int,
                       upscaler: int = d.UPSCALER_FSR):
    """getQualityInformation analog: the render resolution for a mode.

    The render resolution snaps to the frame graph's tile grid (width a
    multiple of 64, height of 8: RenderConfig.TILE_W/TILE_H), so the
    8x64 tile order stays on at internal resolutions; the reference
    rounds to whole pixels (rt64_view.cpp:114-141). The snap moves the
    scale by at most ~5 %."""
    if quality == d.UPSCALER_MODE_AUTO:
        quality = quality_auto(display_width, display_height)
    table = (XESS_QUALITY_SCALE if upscaler == d.UPSCALER_XESS
             else QUALITY_SCALE)
    scale = table[quality]
    rw = max(1, int(display_width * scale))
    rh = max(1, int(display_height * scale))
    if quality != d.UPSCALER_MODE_NATIVE:
        rw = max(64, int(round(rw / 64.0)) * 64)
        rh = max(8, int(round(rh / 8.0)) * 8)
        rw = min(rw, display_width)
        rh = min(rh, display_height)
    return rw, rh


def jitter_phase_count(render_width: int, display_width: int,
                       upscaler: int = d.UPSCALER_FSR) -> int:
    """FSR: ffxFsr2GetJitterPhaseCount = ceil(8 * (display/render)^2).
    DLSS and XeSS report a fixed 64-phase sequence (rt64_dlss.cpp:
    189-191; rt64_xess.cpp:126-130)."""
    if upscaler in (d.UPSCALER_DLSS, d.UPSCALER_XESS):
        return 64
    ratio = display_width / max(render_width, 1)
    return max(1, int(math.ceil(8.0 * ratio * ratio)))


def temporal_channels(upscaler: int) -> int:
    """Channels of the display-size temporal state: the FSR slot carries
    colour; the XeSS slot also depth, for its disocclusion test; the
    learned (DLSS) slot is stateless."""
    if upscaler in (d.UPSCALER_FSR, d.UPSCALER_AUTO):
        return 3
    if upscaler == d.UPSCALER_XESS:
        return 4
    return 0


def _display_uv(dh: int, dw: int, device):
    yy = (torch.arange(dh, dtype=torch.float32, device=device) + 0.5) / dh
    xx = (torch.arange(dw, dtype=torch.float32, device=device) + 0.5) / dw
    return xx[None, :].expand(dh, dw), yy[:, None].expand(dh, dw)


def _reproject(history, flow_d, h: int, w: int):
    """The history sampled where each display pixel's content was last
    frame: (history at the flow-shifted uv, out-of-bounds mask). Kept in
    f32: the output is next frame's history, and a rounding step would
    compound through the (1 - alpha) recurrence."""
    c, dh, dw = history.shape
    su, sv = _display_uv(dh, dw, history.device)
    # Flow is in render pixels; convert to uv.
    pu = su + flow_d[0] / w
    pv = sv + flow_d[1] / h
    oob = (pu < 0.0) | (pu > 1.0) | (pv < 0.0) | (pv > 1.0)
    reproj = filters.bilinear_planar(
        history, torch.clamp(pu, 0.0, 1.0).reshape(-1),
        torch.clamp(pv, 0.0, 1.0).reshape(-1),
    ).reshape(c, dh, dw)
    return reproj, oob


def temporal_accumulate(history_color, rt_color, flow, reactive, lock, reset,
                        dh: int, dw: int):
    """FSR2-style temporal upscale: reproject the history via the flow,
    rectify it against the current frame's 3x3 neighbourhood
    (anti-ghosting), blend with a reactive-driven alpha; the lock mask
    marks thin features that trust the unclamped history (the
    transparency-and-composition mask fed to FSR2, rt64_fsr.cpp:132-166).

    history_color: (3, DH, DW) previous output; rt_color: (3, H, W);
    flow: (2, H, W) in render pixels; reactive, lock: (H, W); reset: a
    bool (or 0-d bool tensor), resetAccumulation (rt64_upscaler.h:40).
    Returns the (3, DH, DW) output, which is also the next history."""
    h, w = rt_color.shape[1], rt_color.shape[2]
    # One resize for all four render-size inputs.
    res = filters.bilinear_resize(
        torch.cat([rt_color, flow, reactive[None], lock[None]], 0), dh, dw,
    )
    upscaled, flow_d, reactive_d, lock_d = res[:3], res[3:5], res[5], res[6]
    reprojected, oob = _reproject(history_color, flow_d, h, w)

    # 3x3 neighbourhood clamp of the upscaled current frame.
    pad = torch.nn.functional.pad(upscaled[None], (1, 1, 1, 1),
                                  mode="replicate")[0]
    lo = upscaled
    hi = upscaled
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = pad[:, 1 + dy : dh + 1 + dy, 1 + dx : dw + 1 + dx]
            lo = torch.minimum(lo, nb)
            hi = torch.maximum(hi, nb)
    clamped = torch.minimum(torch.maximum(reprojected, lo), hi)
    hist = clamped * (1.0 - lock_d)[None] + reprojected * lock_d[None]
    alpha = torch.clamp(0.1 + reactive_d * 0.8, 0.1, 0.9)[None]
    alpha = torch.where(oob[None] | reset, 1.0, alpha)
    return hist * (1.0 - alpha) + upscaled * alpha


def xess_accumulate(history, rt_color, depth, flow, responsive, reset,
                    dh: int, dw: int):
    """The XeSS-slot backend, consuming the inputs the reference feeds
    xessD3D12Execute (rt64_xess.cpp:132-152): colour, velocity, depth
    and the responsive-pixel mask.

      * spatial: Catmull-Rom upsample of the current frame, clamped at 0
        (cubic kernels overshoot at edges);
      * temporal: the history reprojected via the flow and validated by
        a depth disocclusion test;
      * responsive pixels bias the blend toward the current frame.

    history: (4, DH, DW) rgb + depth of the previous output. Returns
    (the (3, DH, DW) output, the (4, DH, DW) next history)."""
    h, w = rt_color.shape[1], rt_color.shape[2]
    cur = torch.clamp(
        filters.bilinear_resize(rt_color, dh, dw, kernel="catmull"), min=0.0
    )
    aux = filters.bilinear_resize(
        torch.cat([depth[None], flow, responsive[None]], 0), dh, dw,
    )
    depth_d, flow_d, resp_d = aux[0], aux[1:3], aux[3]
    reproj, oob = _reproject(history, flow_d, h, w)
    hist_rgb, hist_depth = reproj[:3], reproj[3]

    # The surface seen last frame at the reprojected position must
    # match this frame's depth, else the history is another surface's.
    disoccluded = torch.abs(hist_depth - depth_d) > (
        0.02 * torch.clamp(depth_d, min=1e-3) + 1e-4
    )
    alpha = torch.clamp(0.1 + resp_d * 0.8, 0.1, 0.9)
    alpha = torch.where(disoccluded | oob | reset, 1.0, alpha)[None]
    out = hist_rgb * (1.0 - alpha) + cur * alpha
    return out, torch.cat([out, depth_d[None]], 0)


def temporal_upscale_step(temporal_history, frame_out, cfg):
    """Drive temporal_accumulate from FrameOutputs: (display image, new
    history). temporal_history None starts a fresh history (reset)."""
    from rt64tpu_torch.pipeline.framegraph import to_image

    dh, dw = cfg.display_height, cfg.display_width
    reset = temporal_history is None
    hist = (temporal_history if temporal_history is not None
            else torch.zeros((3, dh, dw), device=frame_out.rt_output.device))
    g = frame_out.gbuffers
    out = temporal_accumulate(
        hist, frame_out.rt_output, to_image(cfg, g.flow),
        to_image(cfg, g.reactive), to_image(cfg, g.lock), reset, dh, dw,
    )
    return out, out


def learned_upscale(frame_out, cfg):
    """The DLSS slot: the learned CNN upscaler."""
    from rt64tpu_torch.models import learned_upscaler

    return learned_upscaler.upscale(frame_out, cfg)
