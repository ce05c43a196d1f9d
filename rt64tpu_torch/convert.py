"""State carried across from the JAX package.

A renderer has no weights: its state is the packed scene and the
per-frame parameters. These helpers turn host arrays (the JAX package's
SceneBuffers / GlobalParams / History leaves read with ``np.asarray``,
or any arrays of the same layout) into the port's tensors, so both
frame graphs can be fed the identical scene and camera.

uint32 payloads (quad pool words, frame counts) become int64 tensors:
torch has no uint32 arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from rt64tpu_torch.pipeline import framegraph as fg
from rt64tpu_torch.pipeline.scene_buffers import (RasterHost, SceneBuffers,
                                                  ShadeFeatures)
from rt64tpu_torch.utils import profiling


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return profiling.upload(np.array(a), device)


def scene_buffers_from_numpy(fields: dict, features, device) -> SceneBuffers:
    """SceneBuffers from a dict of host arrays keyed by field name.
    features: a ShadeFeatures-like object (or dict) with the same flag
    names; sky_plane may be None. The raster passes' host copies
    (RasterHost) are taken from the same arrays."""
    if not isinstance(features, dict):
        features = features._asdict()
    sky = fields.get("sky_plane")
    tensors = {
        name: _tensor(fields[name], device)
        for name in SceneBuffers._fields
        if name not in ("sky_plane", "features", "raster_host")
    }
    host = lambda name: np.array(np.asarray(fields[name]))
    rows = lambda layer: host(f"raster_{layer}")[
        : int(np.asarray(fields[f"raster_{layer}_count"]))]
    return SceneBuffers(
        **tensors,
        sky_plane=None if sky is None else _tensor(sky, device),
        features=ShadeFeatures(**features),
        raster_host=RasterHost(
            bg=rows("bg"), fg=rows("fg"),
            instance_rows=host("instance_rows"),
            quad_records=host("quad_records")),
    )


# GlobalParams fields the JAX package may leave None (no upscaler ran):
# their values when absent.
_GP_DEFAULTS = dict(temporal_reset=np.bool_(False),
                    upscaler_sharpness=np.float32(0.0))


def global_params_from_numpy(fields: dict, device) -> fg.GlobalParams:
    """GlobalParams from a dict of host arrays keyed by field name.
    pixel_jitter stays on the host as two floats (its f32 values);
    temporal_reset and upscaler_sharpness may be absent or None."""
    def value(name):
        a = fields.get(name)
        if a is None or (isinstance(a, np.ndarray) and a.dtype == object
                         and a.item() is None):
            a = _GP_DEFAULTS[name]
        if name == "pixel_jitter":
            return tuple(float(v) for v in np.asarray(a, np.float32))
        return _tensor(a, device)

    return fg.GlobalParams(*(value(name) for name in fg.GlobalParams._fields))


def history_from_numpy(fields: dict, device) -> fg.History:
    """History from a dict of host arrays keyed by field name."""
    return fg.History(
        *(_tensor(fields[name], device) for name in fg.History._fields)
    )
