"""Row tiling: a frame drawn as horizontal bands of rows.

A band is the frame graph run on a band config (shard_config: the
band's rows, the whole frame's full_height) at its first row
(render_frame's row_offset). Screen-space math reads the whole grid, the
blue noise and the sky plane follow the global row, and reprojection
reads the whole frame's history, so the bands, stacked, are the whole
frame: exactly while the denoiser is off; with it on, the GI filter
sees only its band's rows, so rows within cfg.gi_filter_passes of a band
edge differ (as in the JAX package's sharded frame).

The JAX package shards the bands over a device mesh (jax.sharding.Mesh,
shard_map, one all-gather of the history a frame). PyTorch has no mesh:
sharded_render takes a list of devices and renders band b on
devices[b % len(devices)]. One device, where the bands run one after
another, is the path that exists: bench.py draws its native 4K
reference that way on one chip, because the whole frame does not fit.
Several devices raise NotImplementedError (ROADMAP queue 1 item 15).
sharded_render's devices and visualization_mode, and replicate_history,
keep the JAX package's signatures: every caller of the port passes one
device (or None) and visualization mode 0.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from rt64tpu_torch.pipeline import framegraph as fg

_MULTI_DEVICE = ("row tiling over several devices is not ported: the "
                 "bands run one after another on one device (ROADMAP "
                 "queue 1 item 15)")


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


def _devices(devices, like: torch.Tensor):
    devices = [like.device] if devices is None else [torch.device(d) for d in devices]
    if len(devices) != 1:
        raise NotImplementedError(_MULTI_DEVICE)
    return devices


def stack_bands(parts):
    """Bands' values of one output, stacked on the pixel or row axis: 1-D
    planes on axis 0, (C, N) planes and (C, H, W) images on axis 1;
    scalars (the alpha-drop counts) summed; None stays None."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, tuple):  # History, GBuffers
        return type(first)(*(stack_bands(list(f)) for f in zip(*parts)))
    if first.ndim == 0:
        return sum(parts[1:], first)
    return torch.cat(parts, dim=0 if first.ndim == 1 else 1)


def sharded_render(cfg: fg.RenderConfig, n_bands: int, devices=None,
                   visualization_mode: int = 0):
    """fn(sb, gp, history, bn_table, bg_planes) -> FrameOutputs of the
    whole frame, drawn in n_bands bands of cfg's rows.

    history covers the whole frame in the bands' pixel order (the
    previous call's output history, or History.zeros of the whole
    frame); bg_planes is the whole frame's (3, H, W) base plane. Per-pixel
    outputs are the bands' concatenated (to_image_banded reads them as
    images), alpha_dropped their sum. devices: None for the inputs'
    device; more than one raises NotImplementedError."""
    band = shard_config(cfg, n_bands)

    def fn(sb, gp, history, bn_table, bg_planes):
        _devices(devices, history.depth)
        outs = [
            fg.render_frame(sb, gp, history, bn_table, band,
                            visualization_mode=visualization_mode,
                            bg_planes=bg_planes,
                            row_offset=b * band.rt_height)
            for b in range(n_bands)
        ]
        return fg.FrameOutputs(*(stack_bands(list(f)) for f in zip(*outs)))

    return fn


def replicate_history(history: fg.History, devices) -> fg.History:
    """The concatenated history on every device that renders a band: one
    device, so the history on it."""
    (device,) = _devices(devices, history.depth)
    return fg.History(*(p.to(device) for p in history))


def to_image_banded(cfg: fg.RenderConfig, n_bands: int, plane):
    """(C, N) or (N,) plane of a frame drawn in n_bands bands -> (C, H, W)
    or (H, W): each band undoes its own pixel order (a band may be
    untiled where the whole frame is tiled)."""
    band = shard_config(cfg, n_bands)
    parts = torch.chunk(plane, n_bands, dim=plane.ndim - 1)
    return torch.cat([fg.to_image(band, p) for p in parts],
                     dim=0 if plane.ndim == 1 else 1)
