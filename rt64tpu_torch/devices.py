"""Device names that mean the same card in every thread.

A bare torch.device("cuda") names the calling thread's current card,
so in a worker thread of parallel/tiling.py, whose current card is its
band's, the same name means another card. Devices that key a cache or
name where a copy goes carry their index."""

from __future__ import annotations

import torch


def indexed(device) -> torch.device:
    """`device` with a bare "cuda" resolved to cuda:<the calling
    thread's current card>; any other device as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
