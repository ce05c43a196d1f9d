"""The comparison that decides `correct`: the program's outputs of the
last frame of the window against the plain reference (shading.py and
reference.py), each number against its limit in the configuration.

Numbers compared:
- pick_miss_pct: of the sampled render pixels, the share (%) whose
  instance on screen (the frame's instance plane, View picking's
  source) is not the instance of the reference's closest hit. Covers the
  scene the draw packed (the character's latest upload, the moved
  instances) and the closest-hit kernel behind the frame.
- pos_err_p99: over the sampled pixels where both agree on a hit, the
  99th percentile of |program position - reference position| / the
  reference's distance from the eye.
- shade_miss_pct: of the sampled render pixels, the share (%) where the
  program's render-size frame differs from the reference's by more than
  SHADE_STEP in a channel: the shading of the hit, its direct light and
  shadow rays, GI and reflection bounces, fog and the compose.
- present_lsb_max, present_lsb_p999: the largest difference and its
  99.9th percentile over the pixels, in RGB8 steps, between the frame
  the host read back and the reference's upscale slot applied to the
  program's render-size frame with the reference's own depth, flow,
  reactive and lock planes; the FSR slot's history is the display image
  the program presented before.

A configuration's "limits" name the numbers it is judged by.

The samples are drawn from the seed: `uniform` render pixels, and
`character` pixels inside the character's screen box, so that a stale
pose shows.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference as ref
from portbench import shading

NUMBERS = ("pick_miss_pct", "pos_err_p99", "shade_miss_pct",
           "present_lsb_max", "present_lsb_p999")
# A number that could not be read (no pixel to compare, the wrong render
# size): above any limit, and valid JSON where infinity is not.
FAILED = 1e9
# One RGB8 step of the render-size frame's linear value.
SHADE_STEP = 1.0 / 255.0


def sample_pixels(cfg: dict, data, state, camera: dict, seed: int,
                  uniform: int, character: int) -> np.ndarray:
    """(N, 2) render pixels (x, y): `uniform` anywhere, `character`
    inside the box of the character's projected vertices."""
    rw, rh = cfg["render"]
    rng = np.random.default_rng([seed, 0xC4EC])
    pts = [np.stack([rng.integers(0, rw, uniform),
                     rng.integers(0, rh, uniform)], 1)]
    box = character_box(cfg, data, state, camera)
    if box is not None and character:
        x0, y0, x1, y1 = box
        pts.append(np.stack([rng.integers(x0, x1 + 1, character),
                             rng.integers(y0, y1 + 1, character)], 1))
    return np.concatenate(pts).astype(np.int64)


def character_box(cfg, data, state, camera):
    """The character's box in render pixels, clipped to the frame, or
    None when it is off screen."""
    rw, rh = cfg["render"]
    dw, dh = cfg["display"]
    k = next(i for i, inst in enumerate(data.instances)
             if inst.mesh == "character")
    p = np.concatenate([state.character.positions.astype(np.float64),
                        np.ones((state.character.positions.shape[0], 1))], 1)
    w = (p @ state.transforms[k].astype(np.float64))[:, :3]
    x, y, z = ref.camera_basis(state)
    rel = w - np.asarray(state.eye)
    depth = -(rel @ z)
    if (depth <= 0).any():
        return None
    tan = np.tan(np.radians(camera["fov_deg"]) * 0.5)
    ndc_x = (rel @ x) / depth / (tan * dw / dh)
    ndc_y = -(rel @ y) / depth / tan
    px = (ndc_x + 1) / 2 * rw
    py = (ndc_y + 1) / 2 * rh
    x0, x1 = int(max(0, px.min())), int(min(rw - 1, px.max()))
    y0, y1 = int(max(0, py.min())), int(min(rh - 1, py.max()))
    if x0 > x1 or y0 > y1:
        return None
    return x0, y0, x1, y1


def reference_frame(data, state, prev_state, cfg: dict, camera: dict, pixels,
                    got: dict, device, dtype=torch.float64,
                    upscale_dtype=torch.float32, net_dtype=None,
                    root: str = "."):
    """The reference's answers for one frame, worked out in `dtype`: at
    the sampled pixels the instance, position and render-size colour;
    and the presented RGB8 frame, the upscale slot run on the program's
    render-size frame (`got["rt_output"]`, judged at the pixels by
    shade_miss_pct) with the reference's own planes and, for FSR, the
    display image presented before (`got["previous"]`) as its history."""
    frame = shading.Frame(data, state, prev_state, cfg, camera, device, dtype,
                          root)
    px = torch.as_tensor(pixels, device=device)
    at = frame.shade(px)
    planes = {k: v.to(upscale_dtype) for k, v in frame.planes().items()}
    dw, dh = cfg["display"]
    t = lambda a: torch.as_tensor(a, device=device).to(upscale_dtype)
    rt = t(got["rt_output"])
    flow = torch.stack([planes["flow_x"], planes["flow_y"]])
    if cfg["upscaler"] == "fsr":
        reset = got["previous"] is None
        history = (torch.zeros((3, dh, dw), device=device, dtype=upscale_dtype)
                   if reset else t(got["previous"]))
        img = ref.fsr(history, rt, flow, planes["reactive"], planes["lock"],
                      reset, dh, dw)
    elif cfg["upscaler"] == "dlss":
        img = ref.dlss(ref.load_dlss_params(root), rt, planes["depth"], flow,
                       planes["reactive"], dh, dw, net_dtype=net_dtype)
    else:
        img = ref.resize(rt, dh, dw)
    inst = at["instance"]
    return dict(instance=inst.cpu().numpy(),
                position=at["position"].double().cpu().numpy(),
                rgb=at["rgb"].double().cpu().numpy(),
                framebuffer=ref.present_rgb8(img).cpu().numpy(),
                hit_share=float((inst >= 0).double().mean()))


def compare(got: dict, want: dict, eye) -> dict:
    """The numbers of NUMBERS: `got` has the program's (or the
    control's) answers at the sampled pixels (instance (N,), position
    (N, 3), rgb (N, 3)) and its framebuffer; `want` the reference's."""
    miss = got["instance"] != want["instance"]
    both = ~miss & (want["instance"] >= 0)
    dist = np.linalg.norm(want["position"] - np.asarray(eye), axis=1)
    err = np.linalg.norm(got["position"] - want["position"], axis=1)
    rel = err[both] / np.maximum(dist[both], 1e-9)
    shade = np.abs(got["rgb"] - want["rgb"]).max(1)
    lsb = np.abs(got["framebuffer"].astype(np.int64)
                 - want["framebuffer"].astype(np.int64))
    return dict(
        pick_miss_pct=100.0 * float(miss.mean()),
        pos_err_p99=float(np.percentile(rel, 99)) if rel.size else FAILED,
        shade_miss_pct=100.0 * float((~(shade <= SHADE_STEP)).mean()),
        present_lsb_max=float(lsb.max()),
        present_lsb_p999=float(np.percentile(lsb, 99.9)),
    )


def at_pixels(planes: dict, pixels) -> dict:
    """The program's answers at the sampled pixels."""
    x, y = pixels[:, 0], pixels[:, 1]
    return dict(instance=planes["instance"][y, x],
                position=planes["position"][:, y, x].T.astype(np.float64),
                rgb=planes["rt_output"][:, y, x].T.astype(np.float64),
                framebuffer=planes["framebuffer"])


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): each number that has a limit
    at or under it (a NaN fails)."""
    rows = {k: dict(value=numbers[k], limit=v) for k, v in limits.items()}
    ok = all(numbers[k] <= v for k, v in limits.items())
    return ok, rows
