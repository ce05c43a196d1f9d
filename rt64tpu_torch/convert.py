"""State carried across from the JAX package.

A renderer has no weights: its state is the packed scene and the
per-frame parameters. These helpers turn host arrays (the JAX package's
SceneBuffers / GlobalParams / History leaves read with ``np.asarray``,
or any arrays of the same layout) into the port's tensors, so both
frame graphs can be fed the identical scene and camera.

uint32 payloads (quad pool words, frame counts) become int64 tensors:
torch has no uint32 arithmetic.

The one place the two layouts differ is the lights. A JAX row carries
one eligibility column per light slot, 16 of them, where a port row
carries the instance's light group mask (pipeline/rows.py, I_LMASK); the
port's SceneBuffers adds the lights' group bits (`light_groups`).
`rows_from_slots` maps the JAX form exactly into the port's (light l's
group bits 1 << l, an instance's mask the OR of its eligible slots'
bits), `rows_to_slots` the port's into the JAX form.
"""

from __future__ import annotations

import numpy as np
import torch

from rt64tpu_torch.pipeline import framegraph as fg
from rt64tpu_torch.pipeline import rows as R
from rt64tpu_torch.pipeline.scene_buffers import (RasterHost, SceneBuffers,
                                                  ShadeFeatures)
from rt64tpu_torch.utils import profiling


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return profiling.upload(np.array(a), device)


# The JAX package's light slots: columns of eligibility at the port's
# I_LMASK, T_LMASK and CTX_LMASK (its I_ELIG, T_ELIG and CTX_ELIG).
JAX_LIGHT_SLOTS = 16


def rows_from_slots(rows, start: int) -> np.ndarray:
    """Rows of the JAX layout (one row per line, its 16 slot columns at
    `start`) in the port's layout: the two mask halves at `start`, the
    mask the OR of 1 << l over the eligible slots l."""
    rows = np.asarray(rows, np.float32)
    slots = rows[..., start : start + JAX_LIGHT_SLOTS] > 0.0
    mask = (slots.astype(np.int64) << np.arange(JAX_LIGHT_SLOTS)).sum(-1)
    halves = np.stack([mask % R.LMASK_HALF, mask // R.LMASK_HALF], -1)
    return np.concatenate(
        [rows[..., :start], halves.astype(np.float32),
         rows[..., start + JAX_LIGHT_SLOTS :]], -1)


def rows_to_slots(rows, start: int, groups, count: int) -> np.ndarray:
    """Rows of the port's layout in the JAX layout: slot l holds 1.0 where
    the mask at `start` shares a bit with light l's group bits, for the
    first min(count, 16) lights, 0.0 past them (as the JAX packer)."""
    rows = np.asarray(rows, np.float32)
    mask = (rows[..., start].astype(np.int64)
            + rows[..., start + 1].astype(np.int64) * R.LMASK_HALF)
    n = min(int(count), JAX_LIGHT_SLOTS)
    groups = np.asarray(groups).astype(np.int64) & 0xFFFFFFFF
    slots = np.zeros(rows.shape[:-1] + (JAX_LIGHT_SLOTS,), np.float32)
    slots[..., :n] = (mask[..., None] & groups[:n]) != 0
    return np.concatenate([rows[..., :start], slots, rows[..., start + 2 :]],
                          -1)


def ctx_rows_from_slots(rows) -> np.ndarray:
    """The JAX package's context rows (its CTXROW, N) in the port's
    (R.CTXROW, N): rows_from_slots on the lines' columns."""
    return np.ascontiguousarray(
        rows_from_slots(np.asarray(rows).T, R.CTX_LMASK).T)


def scene_buffers_from_numpy(fields: dict, features, device) -> SceneBuffers:
    """SceneBuffers from a dict of host arrays keyed by field name.
    features: a ShadeFeatures-like object (or dict) with the same flag
    names; sky_plane may be None. The raster passes' host copies
    (RasterHost) are taken from the same arrays. Fields without
    `light_groups` are the JAX package's: their instance rows are mapped
    by rows_from_slots."""
    if not isinstance(features, dict):
        features = features._asdict()
    if "light_groups" not in fields:
        fields = dict(fields)
        fields["instance_rows"] = rows_from_slots(fields["instance_rows"],
                                                  R.I_LMASK)
        lights = np.asarray(fields["lights"]).shape[0]
        if lights > JAX_LIGHT_SLOTS:
            raise ValueError(f"{lights} light slots: the JAX layout has "
                             f"{JAX_LIGHT_SLOTS}")
        groups = (np.int64(1) << np.arange(lights)).astype(np.int32)
        groups[int(np.asarray(fields["light_count"])):] = 0
        fields["light_groups"] = groups  # slot l's bit, as rows_from_slots
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
