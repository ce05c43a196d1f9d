"""Post-processing in the port against the JAX package, on the CPU, on
inputs made from a numpy seed:

- bilinear_resize, bilinear and Catmull-Rom, up, down and to odd sizes:
  1e-6 (measured 2.4e-7: the port forms the same banded products with
  the zero entries skipped); its band is built once per size, kernel and
  device; bilinear_planar and interpolate_frame: 1e-6.
- rcas at sharpness 0, 0.5 and 1: 1e-6 (measured 0). At 1.7 and -0.3 the
  port equals its own result at 1 and at 0 (it clamps; the JAX package
  does not, ROADMAP queue 3).
- motion_blur over the bf16 quad pack: the pack equals the JAX
  package's bit for bit, the blur to 1e-6 (measured 3.0e-7); at
  strength 0 each tap reads the pixel itself (its bf16 value).
- One jitter source: a layered view (raster skybox, no sky plane) with
  FSR on, at a frame whose Halton jitter is nonzero: the view's jitter
  equals the JAX view's, and the fixed-grid background plane the rays
  read equals the JAX package's (1e-6) and differs from the unjittered
  one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rt64tpu
from rt64tpu import descriptors as jd
from rt64tpu.ops import filters as jfilters
from rt64tpu.ops import raster as jraster
from rt64tpu.ops import sky as jsky
from rt64tpu.pipeline import framegraph as jfg
from rt64tpu.utils import testscenes as jts

from rt64tpu_torch import descriptors as pd
from rt64tpu_torch.ops import filters as pfilters
from rt64tpu_torch.pipeline import framegraph as pfg
from rt64tpu_torch.utils import testscenes as pts

TOL = dict(rtol=0, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny eager ops while other workers run: one intra-op thread
    is the fastest. The worker's setting comes back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _image(rng, c, h, w, lo=0.0, hi=1.0):
    return rng.uniform(lo, hi, (c, h, w)).astype(np.float32)


# (c, h, w) -> (out_h, out_w): up, down, odd sizes both ways.
RESIZES = {
    "up": ((7, 48, 64), (72, 80)),
    "down": ((3, 96, 128), (40, 50)),
    "odd": ((4, 37, 23), (20, 51)),
}


@pytest.mark.parametrize("kernel", ["bilinear", "catmull"])
@pytest.mark.parametrize("case", sorted(RESIZES))
def test_bilinear_resize_matches(kernel, case):
    (c, h, w), (oh, ow) = RESIZES[case]
    x = _image(np.random.default_rng(1), c, h, w, -2.0, 2.0)
    want = jfilters.bilinear_resize(jnp.asarray(x), oh, ow, kernel=kernel)
    got = pfilters.bilinear_resize(torch.from_numpy(x), oh, ow, kernel=kernel)
    assert tuple(got.shape) == (c, oh, ow) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # Same size: the image itself.
    same = torch.from_numpy(x)
    assert pfilters.bilinear_resize(same, h, w, kernel=kernel) is same


def test_resize_band_built_once():
    cpu = torch.device("cpu")
    a = pfilters._resize_band(720, 552, "bilinear", cpu)
    assert pfilters._resize_band(720, 552, "bilinear", cpu) is a
    assert pfilters._resize_band(720, 552, "catmull", cpu) is not a
    # The band holds exactly the weight matrix's nonzero entries.
    cols, wts = a
    m = np.zeros((720, 552), np.float32)
    np.add.at(m, (np.broadcast_to(np.arange(720), cols.shape), cols.numpy()),
              wts.numpy())
    np.testing.assert_array_equal(m, jfilters._resize_weights(720, 552))


def test_bilinear_planar_matches():
    rng = np.random.default_rng(2)
    x = _image(rng, 4, 30, 50)
    su = rng.uniform(-0.1, 1.1, 700).astype(np.float32)
    sv = rng.uniform(-0.1, 1.1, 700).astype(np.float32)
    want = jfilters.bilinear_planar(jnp.asarray(x), jnp.asarray(su), jnp.asarray(sv))
    got = pfilters.bilinear_planar(torch.from_numpy(x), torch.from_numpy(su),
                                   torch.from_numpy(sv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t", [0.3, 0.5])
def test_interpolate_frame_matches(t):
    rng = np.random.default_rng(3)
    prev, cur = _image(rng, 3, 40, 64), _image(rng, 3, 40, 64)
    flow = rng.uniform(-6, 6, (2, 40, 64)).astype(np.float32)
    flow[:, :8] = 0.0  # a still band: a plain blend there
    want = jfilters.interpolate_frame(jnp.asarray(prev), jnp.asarray(cur),
                                      jnp.asarray(flow), t)
    got = pfilters.interpolate_frame(torch.from_numpy(prev), torch.from_numpy(cur),
                                     torch.from_numpy(flow), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy()[:, :8],
                               (prev * (1 - t) + cur * t)[:, :8], **TOL)


@pytest.fixture(scope="module")
def display_image():
    return _image(np.random.default_rng(4), 3, 48, 64)


@pytest.mark.parametrize("sharpness", [0.0, 0.5, 1.0])
def test_rcas_matches(display_image, sharpness):
    x = display_image
    want = jfilters.rcas(jnp.asarray(x), jnp.float32(sharpness))
    for s in (torch.tensor(sharpness), sharpness):
        got = pfilters.rcas(torch.from_numpy(x), s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if sharpness == 0.0:
        np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("sharpness,inside", [(1.7, 1.0), (-0.3, 0.0)])
def test_rcas_clamps_sharpness(display_image, sharpness, inside):
    x = torch.from_numpy(display_image)
    want = pfilters.rcas(x, inside)
    np.testing.assert_array_equal(pfilters.rcas(x, sharpness).numpy(), want.numpy())
    np.testing.assert_array_equal(
        pfilters.rcas(x, torch.tensor(sharpness)).numpy(), want.numpy())
    # The sharpened image stays in display range (no ringing).
    assert float(want.min()) >= 0.0 and float(want.max()) <= 1.0


@pytest.fixture(scope="module")
def blur_inputs():
    rng = np.random.default_rng(5)
    x = _image(rng, 3, 40, 64)
    flow = rng.uniform(-5, 5, (2, 40, 64)).astype(np.float32)
    flow[:, :10] = 0.0  # still pixels keep their value
    return x, flow


def test_quad_pack_bf16_matches(blur_inputs):
    x, _ = blur_inputs
    want = jfilters.quad_pack_planar(jnp.asarray(x), jnp.bfloat16)
    got = pfilters.quad_pack_planar(torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (40 * 64, 12)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("strength", [0.5, 1.0])
def test_motion_blur_matches(blur_inputs, strength):
    x, flow = blur_inputs
    want = jfilters.motion_blur(jnp.asarray(x), jnp.asarray(flow), (32.0, 20.0),
                                jnp.float32(strength), 32)
    got = pfilters.motion_blur(torch.from_numpy(x), torch.from_numpy(flow),
                               (32.0, 20.0), torch.tensor(strength), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.numpy()[:, :10], x[:, :10])
    assert np.abs(got.numpy() - x).max() > 1e-2  # the blur shows


def test_motion_blur_strength_zero_reads_the_pixel(blur_inputs):
    """At strength 0 every tap reads the pixel itself: the bf16 pack's
    value where the flow is nonzero, as in the JAX package (the view
    runs no blur at strength 0)."""
    x, flow = blur_inputs
    want = jfilters.motion_blur(jnp.asarray(x), jnp.asarray(flow), (32.0, 20.0),
                                jnp.float32(0.0), 32)
    got = pfilters.motion_blur(torch.from_numpy(x), torch.from_numpy(flow),
                               (32.0, 20.0), torch.tensor(0.0), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    bf16 = torch.from_numpy(x).bfloat16().float().numpy()
    np.testing.assert_allclose(got.numpy()[:, 10:], bf16[:, 10:], **TOL)
    np.testing.assert_array_equal(got.numpy()[:, :10], x[:, :10])


# ------------------------------------------------------- one jitter source

BW, BH = 128, 96  # FSR performance: render 64x48
FRAME = 5  # Halton(6, 2) - 0.5, Halton(6, 3) - 0.5: both nonzero


def _layered_view(side):
    """The sample scene without its sky plane, with the raster skybox and
    HUD, FSR performance, at frame FRAME: (view renderer, cfg, gp)."""
    if side == "jax":
        dev, scene, view = jts.build_sample_scene(BW, BH, gi_samples=0)
        mp = pytest.MonkeyPatch()
        mp.setattr(pts, "rt64tpu_torch", rt64tpu)
        mp.setattr(pts, "d", jd)
        try:
            pts.raster_layers(scene, dev)
        finally:
            mp.undo()
    else:
        dev, scene, view = pts.build_sample_scene(BW, BH, gi_samples=0,
                                                  device="cpu")
        pts.raster_layers(scene, dev)
    view.set_sky_plane(None)
    view.desc.upscaler = pd.UPSCALER_FSR
    view.desc.upscaler_mode = pd.UPSCALER_MODE_PERFORMANCE
    view.frame_count = FRAME
    view.update()
    r = view._renderer
    cfg = r._config()
    return r, cfg, r._global_params(cfg)


def test_background_plane_reads_the_view_jitter():
    jr, jcfg, jgp = _layered_view("jax")
    pr, pcfg, pgp = _layered_view("port")
    assert (pcfg.rt_width, pcfg.rt_height) == (jcfg.rt_width, jcfg.rt_height) == (64, 48)
    jitter = np.asarray(jgp.pixel_jitter)
    assert np.all(np.abs(jitter) > 0.05)
    assert pgp.pixel_jitter == tuple(float(v) for v in jitter)

    # The JAX package's background plane, as its render_frame makes it.
    h, w, n = jcfg.rt_height, jcfg.rt_width, jcfg.rt_height * jcfg.rt_width
    jsb = jr._sb
    pix, _, _ = jfg.primary_rays(jcfg, jgp)
    rgba = jnp.concatenate(
        [jfg.from_image(jcfg, jr._background_planes(jcfg)), jnp.ones((1, n))], 0)
    rgba = jraster.rasterize(
        rgba, jsb.raster_bg, jsb.raster_bg_count, jsb.instance_rows,
        jsb.quad_pool, jsb.quad_records, w, h,
        jfg._noise_rand(jcfg, jgp, pix), pix=pix)
    want = np.asarray(jsky.sample_background_grid(
        jfg.to_image(jcfg, rgba[:3]), jgp.pixel_jitter[0], jgp.pixel_jitter[1]))

    planes, got = pfg.background(pr._sb, pgp, pcfg, pr._background_planes(pcfg))
    # The JAX plane is row-major; the port's is in the frame's order.
    got = pfg.to_image(pcfg, got).reshape(3, n).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert got.std() > 0.05  # the skybox shows

    _, still = pfg.background(pr._sb, pgp._replace(pixel_jitter=(0.0, 0.0)),
                              pcfg, pr._background_planes(pcfg))
    still = pfg.to_image(pcfg, still).reshape(3, n).numpy()
    assert np.abs(still - got).max() > 1e-3
