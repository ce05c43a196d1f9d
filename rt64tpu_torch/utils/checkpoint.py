"""Checkpoint and resume of a view's renderer state.

The reference has no checkpointing (SURVEY.md section 5). The state a
resumed renderer needs is the temporal history (previous normal, depth,
direct and indirect accumulations), the previous frame's view matrices,
the frame counter (rt64_view.h:99-110, rt64_view.cpp:977-990) and the
temporal upscaler's display-size history. The .npz keys are the JAX
package's, so a file saved by either package restores in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rt64tpu_torch.convert import history_from_numpy


def save_view_state(view, path: str) -> None:
    """Snapshot a view's temporal state to an .npz file."""
    r = view._renderer
    if r is None or r.history is None:
        raise ValueError("view has no rendered state to checkpoint")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    eye = np.eye(4, dtype=np.float32)
    blobs = {name: plane.cpu().numpy()
             for name, plane in r.history._asdict().items()}
    blobs.update(
        frame_count=np.int64(view.frame_count),
        prev_view_proj=(eye if r._prev_view_proj is None
                        else np.asarray(r._prev_view_proj)),
        prev_view_i=eye if r._prev_view_i is None else np.asarray(r._prev_view_i),
    )
    if r._temporal is not None:
        blobs["temporal_upscaler"] = r._temporal.cpu().numpy()
    np.savez(path, **blobs)


def restore_view_state(view, path: str) -> None:
    """Restore a snapshot taken by save_view_state (of either package)."""
    from rt64tpu_torch.pipeline.view import ViewRenderer

    data = np.load(path)
    if view._renderer is None:
        view._renderer = ViewRenderer(view)
    r = view._renderer
    r.history = history_from_numpy(data, r.device)
    view.frame_count = int(data["frame_count"])
    r._prev_view_proj = data["prev_view_proj"]
    r._prev_view_i = data["prev_view_i"]
    if "temporal_upscaler" in data:
        r._temporal = torch.from_numpy(data["temporal_upscaler"]).to(r.device)
