"""The port's main-path frame against the JAX frame, on the CPU.

(a) Through rt64tpu_torch.convert: the JAX package packs the scene and
    the camera once; the identical SceneBuffers and GlobalParams go to
    both render_frame implementations. Edge pixels may differ because
    the JAX CPU config traces with XLA Moller-Trumbore while the port's
    CPU path is the Woop plain twin of K1/K2.
(b) Through each package's own API: Device.draw() twice, then
    View.framebuffer().

Measured on the CPU (torch 2.13, jax 0.9, 128x64): on both scenes the
instance ids agree on 100 % of pixels and the RGB8 images of (a) and of
(b) are equal at every pixel that hits; at sky pixels they differ by at
most 2/255 (SSIM 0.9983 on both scenes), because the port reads the
fixed-grid sky in the frame's 8x64 tile order and the JAX package in
row-major order (ROADMAP queue 3).

The JAX renderer's alpha-capacity boost is pinned at 16 before its first
frame so it compiles one frame program instead of walking its overflow
ladder; both packages render drop-free either way.
"""

import dataclasses

import numpy as np
import pytest

import torch

from rt64tpu.pipeline import framegraph as jfg
from rt64tpu.utils.castle_scene import build_castle_scene as jax_castle
from rt64tpu.utils.testscenes import build_sample_scene as jax_sample

from rt64tpu_torch.convert import (
    global_params_from_numpy,
    history_from_numpy,
    scene_buffers_from_numpy,
)
from rt64tpu_torch.ops import bluenoise
from rt64tpu_torch.pipeline import framegraph as pfg
from rt64tpu_torch.utils.castle_scene import build_castle_scene as port_castle
from rt64tpu_torch.utils.ssim import ssim
from rt64tpu_torch.utils.testscenes import build_sample_scene as port_sample

W, H = 128, 64
SCENES = {
    "castle": (jax_castle, port_castle, dict(foliage=12)),
    "sample": (jax_sample, port_sample, {}),
}


def _build(builder, **kw):
    out = builder(width=W, height=H, gi_samples=0, **kw)
    out[2].max_reflections = 0  # as bench.py configs 1-2
    return out


@pytest.fixture(scope="module", params=sorted(SCENES))
def frames(request):
    jax_build, port_build, extra = SCENES[request.param]
    jdev, _, jview = _build(jax_build, **extra)
    jview.update()
    r = jview._renderer
    r._alpha_boost = 16
    cfg = r._config()
    gp = r._global_params(cfg)
    hist = jfg.History.zeros(cfg.rt_height, cfg.rt_width)
    out, present = r._get_jitted(cfg, 0)(
        r._sb, gp, hist, r.bn_table, r._background_planes(cfg), None
    )
    jax_a = (np.asarray(present),
             np.asarray(jfg.to_image(cfg, out.gbuffers.instance)))
    assert int(out.alpha_dropped) == 0

    sb = r._sb
    sb_t = scene_buffers_from_numpy(
        {f: (None if getattr(sb, f) is None else np.asarray(getattr(sb, f)))
         for f in sb._fields if f != "features"},
        sb.features, "cpu",
    )
    gp_t = global_params_from_numpy(
        {f: np.asarray(getattr(gp, f)) for f in pfg.GlobalParams._fields}, "cpu"
    )
    hist_t = history_from_numpy(
        {f: np.asarray(getattr(hist, f)) for f in pfg.History._fields}, "cpu"
    )
    cfg_t = pfg.RenderConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(pfg.RenderConfig)
    })
    bn = torch.from_numpy(bluenoise.packed_table())
    pout = pfg.render_frame(sb_t, gp_t, hist_t, bn, cfg_t)
    assert int(pout.alpha_dropped) == 0
    port_a = (pfg.present_rgb8(pout.image).numpy(),
              pfg.to_image(cfg_t, pout.gbuffers.instance).numpy())

    # (b): each package through its own API; the JAX draws reuse the
    # frame program compiled above.
    jdev.draw()
    jdev.draw()
    pdev, _, pview = _build(port_build, device="cpu", **extra)
    pdev.draw()
    pdev.draw()
    return jax_a, port_a, jview.framebuffer(), pview.framebuffer()


def test_frame_through_convert(frames):
    (j_img, j_inst), (p_img, p_inst), _, _ = frames
    assert p_img.shape == j_img.shape == (H, W, 3)
    assert ssim(j_img, p_img) >= 0.99
    assert np.mean(j_inst == p_inst) >= 0.995
    assert (p_inst >= 0).any()


def test_frame_through_own_api(frames):
    _, _, j_fb, p_fb = frames
    assert p_fb.shape == j_fb.shape == (H, W, 4)
    assert p_fb.dtype == np.uint8
    assert ssim(j_fb[..., :3], p_fb[..., :3]) >= 0.98
