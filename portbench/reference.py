"""The plain reference the check holds the program to: numpy and plain
torch, importing nothing of the port (nor JAX). With shading.py (the
render-size frame), it is the whole reference.

- jitter / camera_rays: the primary ray of a render pixel through the
  pushed camera and the frame's sub-pixel jitter.
- resize / fsr / dlss: the upscale slot from a frame's render-size
  planes: the FSR slot's temporal accumulation (reprojection through
  the flow, a 3x3 neighbourhood clamp, lock and reactive masks) and the
  DLSS slot's network (five 3x3 convolutions predicting a residual over
  the bilinear upscale), with its weights read from the shipped file.
- present_rgb8: the RGB8 quantisation of the presented frame.

Each stage takes its precision: the check runs the geometry and shading
in float64, the upscale in float32 and the DLSS network in float32; the
control runs each a step below what the configuration states: geometry,
shading and upscale in bfloat16, the network (bfloat16 in the port) in
float8.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

RAY_MIN = 0.1
RAY_MAX = 1e5
PARAMS_FILE = os.path.join("rt64tpu_torch", "models", "_upscaler_params.npz")


def halton(i: int, b: int) -> float:
    f, r = 1.0, 0.0
    while i > 0:
        f /= b
        r += f * (i % b)
        i //= b
    return r


def jitter(frame: int, upscaler: str, render_w: int, display_w: int):
    """The frame's sub-pixel jitter in render pixels: a Halton (2, 3)
    sequence over ceil(8 (display / render)^2) phases for FSR, 64 for
    DLSS, none without an upscaler."""
    if upscaler == "off":
        return 0.0, 0.0
    phases = (64 if upscaler == "dlss"
              else max(1, math.ceil(8.0 * (display_w / render_w) ** 2)))
    i = frame % phases + 1
    return halton(i, 2) - 0.5, halton(i, 3) - 0.5


def camera_basis(state) -> np.ndarray:
    """(3, 3) rows x, y, z of the camera looking from state.eye at
    state.target (right-handed, y up, looking down -z), float64."""
    z = np.asarray(state.eye, np.float64) - np.asarray(state.target, np.float64)
    z /= np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def camera_rays(state, camera: dict, render, display, jit, pixels, device,
                dtype):
    """(origins, directions) (N, 3) of render pixels (N, 2) = (x, y):
    the pushed camera's ray through each pixel centre moved by the
    jitter, unprojected with the display's aspect."""
    rw, rh = render
    eye = np.asarray(state.eye, np.float64)
    basis = torch.as_tensor(camera_basis(state), device=device, dtype=dtype)
    tan = math.tan(math.radians(camera["fov_deg"]) * 0.5)
    aspect = display[0] / display[1]
    px = torch.as_tensor(pixels, device=device, dtype=torch.float64)
    ndc_x = (px[:, 0] + 0.5 + jit[0]) / rw * 2.0 - 1.0
    ndc_y = (px[:, 1] + 0.5 + jit[1]) / rh * 2.0 - 1.0
    view_dir = torch.stack([ndc_x * tan * aspect, -ndc_y * tan,
                            -torch.ones_like(ndc_x)], 1).to(dtype)
    dirs = view_dir @ basis
    origins = torch.as_tensor(eye, device=device, dtype=dtype).expand_as(dirs)
    return origins, dirs


def resize(img, dh: int, dw: int):
    """Bilinear resize of a (C, H, W) image on the pixel-centre grid,
    edge-clamped."""
    if img.shape[1:] == (dh, dw):
        return img
    return F.interpolate(img[None], size=(dh, dw), mode="bilinear",
                         align_corners=False)[0]


def fsr(history, rt, flow, reactive, lock, reset: bool, dh: int, dw: int):
    """The FSR slot's output (3, DH, DW): the history reprojected through
    the upscaled flow (render pixels), clamped to the 3x3 neighbourhood
    of the upscaled frame except where locked, blended with the upscaled
    frame at 0.1 + 0.8 reactive (in [0.1, 0.9]); 1 on reset and where
    the reprojection leaves the screen."""
    h, w = rt.shape[1:]
    res = resize(torch.cat([rt, flow, reactive[None], lock[None]], 0), dh, dw)
    up, flow_d, react_d, lock_d = res[:3], res[3:5], res[5], res[6]
    ys = (torch.arange(dh, device=rt.device, dtype=rt.dtype) + 0.5) / dh
    xs = (torch.arange(dw, device=rt.device, dtype=rt.dtype) + 0.5) / dw
    pu = xs[None, :] + flow_d[0] / w
    pv = ys[:, None] + flow_d[1] / h
    oob = (pu < 0) | (pu > 1) | (pv < 0) | (pv > 1)
    grid = torch.stack([pu.clamp(0, 1) * 2 - 1, pv.clamp(0, 1) * 2 - 1], -1)
    reproj = F.grid_sample(history[None], grid[None], mode="bilinear",
                           padding_mode="border", align_corners=False)[0]
    lo = -F.max_pool2d(-F.pad(up[None], (1, 1, 1, 1), mode="replicate"), 3, 1)[0]
    hi = F.max_pool2d(F.pad(up[None], (1, 1, 1, 1), mode="replicate"), 3, 1)[0]
    hist = reproj.clamp(lo, hi) * (1 - lock_d) + reproj * lock_d
    alpha = torch.clamp(0.1 + react_d * 0.8, 0.1, 0.9)
    alpha = torch.where(oob | reset, torch.ones_like(alpha), alpha)
    return hist * (1 - alpha) + up * alpha


def load_dlss_params(root: str = "."):
    """The shipped network's (weight OIHW, bias) pairs, f32 numpy, read
    from its raw file: keys sorted, (bias, HWIO kernel) per convolution."""
    flat = np.load(os.path.join(root, PARAMS_FILE))
    keys = sorted(flat.files)
    return [(flat[k].transpose(3, 2, 0, 1), flat[b])
            for b, k in zip(keys[0::2], keys[1::2])]


FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def rounded(x, dtype):
    """x with its values rounded to `dtype` (float8 saturated to its
    range), kept in x's type: the network's inputs, weights and each
    layer's output computed in `dtype`, accumulated in x's."""
    if dtype is None or dtype == x.dtype:
        return x
    if dtype == torch.float8_e4m3fn:
        x = x.clamp(-FP8_MAX, FP8_MAX)
    return x.to(dtype).to(x.dtype)


def dlss(params, rt, depth, flow, reactive, dh: int, dw: int, rows: int = 540,
         net_dtype=None):
    """The DLSS slot's output (3, DH, DW): the bilinear upscale of colour,
    depth, flow and reactive, plus the residual of five 3x3 convolutions
    (ReLU between, the third dilated by 2), in blocks of output rows
    with a halo of 6 rows (the stack's reach). net_dtype: the precision
    the network's values are rounded to (None: rt's own)."""
    x = resize(torch.cat([rt, depth[None], flow, reactive[None]], 0), dh, dw)
    convs = [(rounded(torch.as_tensor(w, device=rt.device, dtype=rt.dtype),
                      net_dtype),
              rounded(torch.as_tensor(b, device=rt.device, dtype=rt.dtype),
                      net_dtype))
             for w, b in params]
    dil = (1, 1, 2, 1, 1)
    halo = sum(dil)
    out = []
    for r0 in range(0, dh, rows):
        a, b = max(0, r0 - halo), min(dh, r0 + rows + halo)
        h = rounded(x[None, :, a:b], net_dtype)
        for i, (w, bias) in enumerate(convs):
            h = rounded(F.conv2d(h, w, bias, padding=dil[i], dilation=dil[i]),
                        net_dtype)
            if i < len(convs) - 1:
                h = torch.relu(h)
        out.append(h[0, :, r0 - a:r0 - a + min(rows, dh - r0)])
    return x[:3] + torch.cat(out, 1)


def present_rgb8(img):
    """(3, H, W) linear -> (H, W, 3) uint8 as the frame is presented."""
    return torch.clamp(img.float() * 255.0 + 0.5, 0.0, 255.0).to(
        torch.uint8).permute(1, 2, 0)
