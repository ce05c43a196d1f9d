"""Device names that key a card by its index.

A bare torch.device("cuda") names whichever card is current when it is
used. A device that keys a cache or a Device (api.resolve_device, the
learned slot's nets) carries its index, so that it names one card."""

from __future__ import annotations

import torch


def indexed(device) -> torch.device:
    """`device` with a bare "cuda" resolved to cuda:<the calling
    thread's current card>; any other device as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
