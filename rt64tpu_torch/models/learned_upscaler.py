"""Learned upscaler — the DLSS slot (rt64_dlss.cpp).

A compact CNN consuming the inputs the reference feeds NGX (colour,
depth, flow, reactive mask, rt64_dlss.cpp:193-227): it predicts a
residual over the bilinear upscale. The weights ship beside this file
(`_upscaler_params.npz`, in the JAX package's layout, which reads it
too): the port's trainer's net (models/train_upscaler.fit, 32 pairs of
each scene kind, 2,000 steps, fresh_net(0)), trained on the planes
serving feeds it. Its pairs are camera cuts, so it takes nothing from
the flow channels (their weights are zero). The JAX package's own file,
trained on scrambled planes and on the flow between unrelated cameras,
had collapsed to the bilinear upscale. A missing file raises.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
from torch import nn

from rt64tpu_torch.devices import indexed
from rt64tpu_torch.ops import filters

PARAMS_PATH = os.path.join(os.path.dirname(__file__), "_upscaler_params.npz")


class UpscaleNet(nn.Module):
    """Residual predictor over the bilinear upscale.

    Input at display size: upscaled colour (3), depth (1), flow (2),
    reactive (1). Output: the rgb residual. Five 3x3 "SAME" convolutions
    with ReLU between them, the third dilated by 2. Everything runs in
    bf16 (input, weights, biases, activations), and each bias is added
    to the rounded convolution, as Flax's `nn.Conv(dtype=bfloat16)` does;
    the output is cast to f32. The weights are cast to bf16 inside the
    forward, as Flax casts its f32 parameters at use: a net with f32
    master weights trains as the JAX package's does, and the serving
    net (get_net, bf16 weights) casts nothing."""

    def __init__(self, features: int = 32):
        super().__init__()
        f = features
        self.convs = nn.ModuleList([
            nn.Conv2d(7, f, 3, padding=1),
            nn.Conv2d(f, f, 3, padding=1),
            nn.Conv2d(f, f, 3, padding=2, dilation=2),
            nn.Conv2d(f, f // 2, 3, padding=1),
            nn.Conv2d(f // 2, 3, 3, padding=1),
        ])

    def forward(self, x):  # x: (B, 7, H, W)
        bf16 = torch.bfloat16
        h = x.to(bf16)
        for i, conv in enumerate(self.convs):
            h = torch.nn.functional.conv2d(
                h, conv.weight.to(bf16), None, conv.stride, conv.padding,
                conv.dilation) + conv.bias.to(bf16)[None, :, None, None]
            if i < len(self.convs) - 1:
                h = torch.relu(h)
        return h.to(torch.float32)


def load_params(path: str | None = None):
    """The trained parameters as (weight OIHW, bias) pairs, f32 numpy.
    The file's keys 0000-0009 are Flax's sorted tree order: (bias,
    kernel) of Conv_0 ... Conv_4, kernels HWIO (a file of either package's
    trainer). path: None for PARAMS_PATH, read at the call."""
    path = PARAMS_PATH if path is None else path
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"learned upscaler weights not found: {path}")
    flat = np.load(path)
    keys = sorted(flat.files)
    return [(flat[k].transpose(3, 2, 0, 1), flat[b])
            for b, k in zip(keys[0::2], keys[1::2])]


def save_params(path: str, net: UpscaleNet) -> None:
    """Write the net's parameters in the JAX package's layout (what
    load_params and the JAX package's get_params read): f32, Flax's
    sorted keys 0000-0009, (bias, kernel) of each convolution, kernels
    HWIO."""
    flat = {}
    for i, conv in enumerate(net.convs):
        w = conv.weight.detach().float().cpu().numpy()
        flat[f"{2 * i:04d}"] = conv.bias.detach().float().cpu().numpy()
        flat[f"{2 * i + 1:04d}"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
    np.savez(path, **flat)


def set_params(net: UpscaleNet, params) -> UpscaleNet:
    """Copy load_params' (weight OIHW, bias) pairs into the net."""
    with torch.no_grad():
        for conv, (w, b) in zip(net.convs, params):
            conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
            conv.bias.copy_(torch.from_numpy(b))
    return net


def get_net(device) -> UpscaleNet:
    """The network with the shipped weights, in bf16 on `device` (built
    once per device; a bare "cuda" is the current card)."""
    return _net_on(indexed(device))


@functools.lru_cache(maxsize=None)
def _net_on(device: torch.device) -> UpscaleNet:
    net = set_params(UpscaleNet(), load_params())
    net.requires_grad_(False)
    return net.to(device=device, dtype=torch.bfloat16).eval()


def residual(x):
    """The network's rgb residual for a (7, H, W) display-size input."""
    return get_net(x.device)(x[None])[0]


def _run(rt_color, depth, flow, reactive, dh: int, dw: int):
    """(3, DH, DW) output: the bilinear upscale plus the residual.
    rt_color: (3, H, W); depth, reactive: (H, W); flow: (2, H, W)."""
    # One resize for all seven channels.
    x = filters.bilinear_resize(
        torch.cat([rt_color, depth[None], flow, reactive[None]], 0), dh, dw,
    )
    # The depth plane is fed unnormalised: the shipped weights were
    # trained against that input.
    return x[:3] + residual(x)


def upscale(frame_out, cfg):
    from rt64tpu_torch.pipeline.framegraph import to_image

    g = frame_out.gbuffers
    return _run(
        frame_out.rt_output, to_image(cfg, g.depth), to_image(cfg, g.flow),
        to_image(cfg, g.reactive), cfg.display_height, cfg.display_width,
    )
