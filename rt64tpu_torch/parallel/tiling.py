"""Row tiling: a frame drawn as horizontal bands of rows.

A band is the frame graph run on a band config (shard_config: the
band's rows, the whole frame's full_height) at its first row
(render_frame's row_offset). Screen-space math reads the whole grid, the
blue noise and the sky plane follow the global row, and reprojection
reads the whole frame's history, so the bands, stacked, are the whole
frame: exactly while the denoiser is off; with it on, the GI filter
sees only its band's rows, so rows within cfg.gi_filter_passes of a band
edge differ (as in the JAX package's sharded frame).

The JAX package shards the bands over a device mesh (shard_map: the
scene, camera, blue noise, background and history replicated, the pixel
planes sharded by row, alpha_dropped summed with psum, one all-gather of
the history a frame). The port draws them one after another on the
inputs' device and stacks them (bench.py's native 4K reference on one
card, where the whole frame does not fit). Bands drawn at once, one
worker thread and stream per band, were slower on an H100 than the same
bands in turn, on one card and across four: the threads share the GIL,
and the frame graph's many small eager ops issue slower under it
(PERF.md).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from rt64tpu_torch.pipeline import framegraph as fg


def shard_config(cfg: fg.RenderConfig, n_bands: int) -> fg.RenderConfig:
    """A band's config: rt_height and display_height divided by n_bands,
    full_height the whole frame's rows."""
    if cfg.full_height:
        raise ValueError("the config is a band already")
    if cfg.rt_height % n_bands or cfg.display_height % n_bands:
        raise ValueError(
            f"{n_bands} bands do not divide {cfg.rt_height} render rows "
            f"and {cfg.display_height} display rows")
    return replace(cfg, rt_height=cfg.rt_height // n_bands,
                   display_height=cfg.display_height // n_bands,
                   full_height=cfg.rt_height)


def stack_bands(parts):
    """Bands' values of one output (or their whole FrameOutputs), stacked
    on the pixel or row axis: 1-D planes on axis 0, (C, N) planes and
    (C, H, W) images on axis 1; scalars (the alpha-drop counts) summed;
    None stays None."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, tuple):  # FrameOutputs, History, GBuffers
        return type(first)(*(stack_bands(list(f)) for f in zip(*parts)))
    if first.ndim == 0:
        return sum(parts[1:], first)
    return torch.cat(parts, dim=0 if first.ndim == 1 else 1)


def sharded_render(cfg: fg.RenderConfig, n_bands: int,
                   visualization_mode: int = 0):
    """fn(sb, gp, history, bn_table, bg_planes) -> FrameOutputs of the
    whole frame, drawn in n_bands bands of cfg's rows, in turn on the
    inputs' device.

    history covers the whole frame in the bands' pixel order (the
    previous call's output history, or History.zeros of the whole
    frame): reprojection reads across band edges, so every band reads
    all of it. bg_planes is the whole frame's (3, H, W) base plane.
    Per-pixel outputs are the bands' concatenated (to_image_banded reads
    them as images), alpha_dropped their sum."""
    band = shard_config(cfg, n_bands)

    def fn(sb, gp, history, bn_table, bg_planes):
        return stack_bands([
            fg.render_frame(sb, gp, history, bn_table, band,
                            visualization_mode=visualization_mode,
                            bg_planes=bg_planes,
                            row_offset=b * band.rt_height)
            for b in range(n_bands)])

    return fn


def to_image_banded(cfg: fg.RenderConfig, n_bands: int, plane):
    """(C, N) or (N,) plane of a frame drawn in n_bands bands -> (C, H, W)
    or (H, W): each band undoes its own pixel order (a band may be
    untiled where the whole frame is tiled)."""
    band = shard_config(cfg, n_bands)
    parts = torch.chunk(plane, n_bands, dim=plane.ndim - 1)
    return torch.cat([fg.to_image(band, p) for p in parts],
                     dim=0 if plane.ndim == 1 else 1)
