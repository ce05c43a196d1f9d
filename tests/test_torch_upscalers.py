"""The upscaler slots in the port against the JAX package, on the CPU, on
inputs made from a numpy seed:

- Host policy, exactly: halton and halton_jitter over frames 0-200;
  quality_auto, quality_resolution, jitter_phase_count and
  temporal_channels over display sizes x the 7 modes x the 5 upscalers.
- temporal_accumulate and xess_accumulate: the reset frame, 8 static
  steps, random flow with out-of-bounds lanes, and reactive, lock and
  disocclusion masks: 1e-5 (measured 2.9e-6). Each step starts both
  packages from the JAX package's history: XLA turns the uv grid's
  division by the width into a multiply by its reciprocal, which moves
  a sample at a pixel's own centre by up to 5e-6 at 56 pixels wide,
  where the port divides; fed their own outputs, the two recurrences
  part by 1.6e-5 after 8 steps. The port's own recurrence stays within
  1e-3 of its reset frame over the 8 static steps (no drift).
- The learned slot: the shipped weights are the port's retrain on the
  planes serving feeds (ROADMAP queue 3): their sha256, Flax's key order
  and HWIO kernels, read alike by load_params and the JAX package's
  get_params, zero weights on the flow channels (the trainer's camera
  cuts never fed them), and a held-out SSIM above bilinear's on 3 pairs
  (one of each kind, 48x64 -> 96x128, camera seeds the trainer's corpus
  does not use). The JAX package's file stays the parity file, read
  alike by both packages: the tests that hold the port to the JAX
  package point the port at it (jax_weights). There, the CNN residual
  on a random input with world-scale depth equals JAX's within 2e-6,
  one bf16 step of its largest value (measured 0: bit-equal); _run
  within 1e-5; a missing weights file raises.
- Frames through each package's Device.draw(), three draws each, RGB8
  SSIM >= 0.99 and max abs <= 2/255: the sample scene at 128x96 with FSR
  performance (render 64x48) plus RCAS and motion blur over a moving
  sphere; at 256x128 with FSR auto (render 192x96: tiled, three tile
  columns); XeSS and DLSS performance at 128x96. Each holds the display
  size, the render size and the kind of temporal state. Measured: the
  renders one tile column wide SSIM >= 0.99999995, at most 1/255 on
  0.008 % of the pixels (DLSS bit-equal); FSR auto 0.9988, 2/255 at the
  sky pixels, which the JAX package reads in row-major order on a tiled
  frame (ROADMAP queue 3).
"""

import hashlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rt64tpu import descriptors as jd
from rt64tpu.models import learned_upscaler as jlus
from rt64tpu.models import upscaler as jups
from rt64tpu.ops import math3d as jm
from rt64tpu.utils import testscenes as jts

from rt64tpu_torch import descriptors as pd
from rt64tpu_torch.models import learned_upscaler as plus
from rt64tpu_torch.models import upscaler as pups
from rt64tpu_torch.ops import filters as pfilters
from rt64tpu_torch.ops import math3d as pm
from rt64tpu_torch.utils import testscenes as pts
from rt64tpu_torch.utils.ssim import ssim

TOL = dict(rtol=0, atol=1e-5)
MODES = [pd.UPSCALER_MODE_AUTO, pd.UPSCALER_MODE_ULTRA_PERFORMANCE,
         pd.UPSCALER_MODE_PERFORMANCE, pd.UPSCALER_MODE_BALANCED,
         pd.UPSCALER_MODE_QUALITY, pd.UPSCALER_MODE_ULTRA_QUALITY,
         pd.UPSCALER_MODE_NATIVE]
UPSCALERS = [pd.UPSCALER_OFF, pd.UPSCALER_AUTO, pd.UPSCALER_DLSS,
             pd.UPSCALER_FSR, pd.UPSCALER_XESS]
DISPLAYS = [(64, 32), (160, 120), (640, 480), (1000, 500), (1280, 720),
            (1920, 1080), (2560, 1440), (3840, 2160)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny eager ops while other workers run: one intra-op thread
    is the fastest. The worker's setting comes back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------ host policy


def test_halton_matches():
    for i in range(201):
        for b in (2, 3):
            assert pm.halton(i, b) == jm.halton(i, b)


@pytest.mark.parametrize("phases", [1, 8, 32, 64])
def test_halton_jitter_matches(phases):
    for frame in range(201):
        got = pm.halton_jitter(frame, phases)
        assert got == jm.halton_jitter(frame, phases)
        assert all(-0.5 <= v <= 0.5 for v in got)


def test_mode_and_slot_constants_match():
    assert MODES == sorted(MODES) and len(MODES) == 7
    for name in ("UPSCALER_OFF", "UPSCALER_AUTO", "UPSCALER_DLSS",
                 "UPSCALER_FSR", "UPSCALER_XESS"):
        assert getattr(pd, name) == getattr(jd, name)
    assert pups.QUALITY_SCALE == jups.QUALITY_SCALE
    assert pups.XESS_QUALITY_SCALE == jups.XESS_QUALITY_SCALE


@pytest.mark.parametrize("upscaler", UPSCALERS)
@pytest.mark.parametrize("display", DISPLAYS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_policy_matches(display, upscaler):
    dw, dh = display
    assert pups.quality_auto(dw, dh) == jups.quality_auto(dw, dh)
    assert pups.temporal_channels(upscaler) == jups.temporal_channels(upscaler)
    for mode in MODES:
        got = pups.quality_resolution(mode, dw, dh, upscaler=upscaler)
        assert got == jups.quality_resolution(mode, dw, dh, upscaler=upscaler)
        rw, rh = got
        assert 1 <= rw <= dw and 1 <= rh <= dh
        assert (pups.jitter_phase_count(rw, dw, upscaler=upscaler)
                == jups.jitter_phase_count(rw, dw, upscaler=upscaler))


def test_bench_render_sizes():
    """Bench configs 2-5 as bench.py writes them."""
    auto, perf = pd.UPSCALER_MODE_AUTO, pd.UPSCALER_MODE_PERFORMANCE
    assert pups.quality_resolution(auto, 640, 480) == (512, 368)
    assert pups.quality_resolution(auto, 1280, 720) == (960, 552)
    assert pups.quality_resolution(
        perf, 3840, 2160, upscaler=pd.UPSCALER_DLSS) == (1920, 1080)


# ------------------------------------------------------- the accumulators

H, W, DH, DW = 24, 32, 40, 56


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(7)
    f = np.float32
    p = dict(
        rt=rng.uniform(0, 1.5, (3, H, W)).astype(f),
        depth=rng.uniform(2, 80, (H, W)).astype(f),
        flow=rng.uniform(-3, 3, (2, H, W)).astype(f),
        reactive=(rng.uniform(0, 1, (H, W)) * (rng.uniform(0, 1, (H, W)) > 0.6)).astype(f),
        lock=(rng.uniform(0, 1, (H, W)) > 0.7).astype(f),
        hist3=rng.uniform(0, 1.2, (3, DH, DW)).astype(f),
    )
    # A band of lanes whose flow leaves the screen (out of bounds).
    p["flow"][:, :, :4] = np.array([-60.0, 25.0], f)[:, None, None]
    # Depth a little off the history's on half of the history: these
    # pixels fail the XeSS disocclusion test.
    hist_depth = pfilters.bilinear_resize(
        torch.from_numpy(p["depth"][None]), DH, DW)[0].numpy()
    hist_depth[: DH // 2] *= 1.2
    p["hist4"] = np.concatenate([p["hist3"], hist_depth[None]], 0)
    return p


def _both(fn_j, fn_p, *arrays, reset):
    j = fn_j(*map(jnp.asarray, arrays), jnp.bool_(reset), DH, DW)
    p = fn_p(*map(torch.from_numpy, arrays), torch.tensor(reset), DH, DW)
    return j, p


@pytest.mark.parametrize("moving", [False, True], ids=["static", "flow"])
def test_temporal_accumulate_matches(planes, moving):
    p = planes
    flow = p["flow"] if moving else np.zeros_like(p["flow"])
    args = (p["rt"], flow, p["reactive"], p["lock"])
    # The reset frame: the bilinear upscale of the current frame.
    j, t = _both(jups.temporal_accumulate, pups.temporal_accumulate,
                 p["hist3"], *args, reset=True)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    np.testing.assert_allclose(
        t.numpy(),
        pfilters.bilinear_resize(torch.from_numpy(p["rt"]), DH, DW).numpy(),
        **TOL)
    # Eight steps, both from the JAX package's history; and the port's
    # own recurrence.
    reset_frame, own = t, t
    for _ in range(8):
        t = pups.temporal_accumulate(torch.from_numpy(np.array(j)),
                                     *map(torch.from_numpy, args),
                                     torch.tensor(False), DH, DW)
        j = jups.temporal_accumulate(j, *map(jnp.asarray, args), jnp.bool_(False),
                                     DH, DW)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
        own = pups.temporal_accumulate(own, *map(torch.from_numpy, args),
                                       torch.tensor(False), DH, DW)
    if not moving:
        np.testing.assert_allclose(own.numpy(), reset_frame.numpy(),
                                   rtol=0, atol=1e-3)
    # Over a foreign history with the masks live.
    j, t = _both(jups.temporal_accumulate, pups.temporal_accumulate,
                 p["hist3"], *args, reset=False)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("moving", [False, True], ids=["static", "flow"])
def test_xess_accumulate_matches(planes, moving):
    p = planes
    flow = p["flow"] if moving else np.zeros_like(p["flow"])
    args = (p["rt"], p["depth"], flow, p["reactive"])
    j, t = _both(jups.xess_accumulate, pups.xess_accumulate,
                 p["hist4"], *args, reset=True)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    cur = torch.clamp(pfilters.bilinear_resize(torch.from_numpy(p["rt"]), DH, DW,
                                               kernel="catmull"), min=0.0)
    np.testing.assert_allclose(t[0].numpy(), cur.numpy(), **TOL)
    jh, own = j[1], t[1]
    for _ in range(8):
        to, th = pups.xess_accumulate(torch.from_numpy(np.array(jh)),
                                      *map(torch.from_numpy, args),
                                      torch.tensor(False), DH, DW)
        jo, jh = jups.xess_accumulate(jh, *map(jnp.asarray, args),
                                      jnp.bool_(False), DH, DW)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        own_out, own = pups.xess_accumulate(own, *map(torch.from_numpy, args),
                                            torch.tensor(False), DH, DW)
    if not moving:
        np.testing.assert_allclose(own_out.numpy(), t[0].numpy(),
                                   rtol=0, atol=1e-3)
    # Over a history whose top half is another surface (disoccluded).
    j, t = _both(jups.xess_accumulate, pups.xess_accumulate,
                 p["hist4"], *args, reset=False)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# -------------------------------------------------------- the learned slot


# The shipped weights: scripts/retrain_study.py's 32 pairs a kind, 2,000
# steps, fresh_net(0), through train_upscaler.fit (PERF.md §6).
SHIPPED_SHA256 = "2fea4d8a8bf5309cd3d06e4daaa28d57e539d684686d0a014d621f35ba70fd84"
# (kernel HWIO shape) of Conv_0 ... Conv_4; each bias has the last axis.
KERNELS = [(3, 3, 7, 32), (3, 3, 32, 32), (3, 3, 32, 32), (3, 3, 32, 16),
           (3, 3, 16, 3)]


@pytest.fixture
def jax_weights(monkeypatch):
    """The port's learned slot on the JAX package's weight file, the
    parity file of the tests against the JAX package."""
    monkeypatch.setattr(plus, "PARAMS_PATH", jlus._PARAMS_CACHE)
    plus._net_on.cache_clear()
    yield
    plus._net_on.cache_clear()


def test_weights_are_the_jax_packages_file():
    """The JAX package's weight file, the parity file of the tests against
    the JAX package (jax_weights): the port's load_params reads it as the
    JAX package's get_params does."""
    with open(jlus._PARAMS_CACHE, "rb") as f:
        assert len(f.read()) == 104834
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jlus.get_params())]
    for i, (w, b) in enumerate(plus.load_params(jlus._PARAMS_CACHE)):
        assert np.array_equal(b, leaves[2 * i])
        assert np.array_equal(w, leaves[2 * i + 1].transpose(3, 2, 0, 1))


def test_shipped_weights_file(monkeypatch):
    """The shipped file: the port's retrain, not the JAX package's file;
    Flax's key order and HWIO kernels, read alike by both packages; Conv_0
    takes nothing from the flow channels (4, 5), which the trainer's
    camera cuts never fed, and something from every other channel."""
    with open(plus.PARAMS_PATH, "rb") as f:
        got = f.read()
    with open(jlus._PARAMS_CACHE, "rb") as f:
        assert f.read() != got
    assert hashlib.sha256(got).hexdigest() == SHIPPED_SHA256
    flat = np.load(plus.PARAMS_PATH)
    assert flat.files == [f"{i:04d}" for i in range(10)]
    for i, shape in enumerate(KERNELS):
        assert flat[f"{2 * i:04d}"].shape == shape[-1:]
        assert flat[f"{2 * i + 1:04d}"].shape == shape
        assert flat[f"{2 * i + 1:04d}"].dtype == np.float32
    conv0 = flat["0001"]
    assert not conv0[:, :, 4:6].any()
    assert all(conv0[:, :, c].any() for c in (0, 1, 2, 3, 6))
    monkeypatch.setattr(jlus, "_PARAMS_CACHE", plus.PARAMS_PATH)
    monkeypatch.setattr(jlus, "_params", None)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jlus.get_params())]
    for i, (w, b) in enumerate(plus.load_params()):
        assert np.array_equal(b, leaves[2 * i])
        assert np.array_equal(w, leaves[2 * i + 1].transpose(3, 2, 0, 1))


def test_shipped_weights_beat_bilinear():
    """Held-out SSIM against the native 2x frame, one fresh pair of each
    kind drawn on the CPU (the study's camera seeds)."""
    from rt64tpu_torch.models import train_upscaler as ptr

    pairs = []
    for scene, seed0, gi in (("sample", 9007, 0), ("castle", 10007, 0),
                             ("castle", 11007, 1)):
        pairs += ptr.render_pairs(1, scene, lo=(48, 64), hi=(96, 128),
                                  seed0=seed0, gi=gi, device="cpu")
    s_net, s_bilinear = ptr.evaluate(plus.get_net("cpu"), pairs, 96, 128, "cpu")
    assert s_net > s_bilinear


def test_missing_weights_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="weights"):
        plus.load_params(os.path.join(tmp_path, "none.npz"))


@pytest.fixture(scope="module")
def cnn_input():
    """(7, 96, 128): colour, world-scale depth, flow in pixels, reactive."""
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (7, 96, 128)).astype(np.float32)
    x[3] = rng.uniform(1, 200, (96, 128))
    x[4:6] = rng.uniform(-4, 4, (2, 96, 128))
    return x


def test_cnn_residual_matches(cnn_input, jax_weights):
    want = np.asarray(jlus._model.apply(
        jlus.get_params(), jnp.asarray(np.moveaxis(cnn_input, 0, -1))))
    want = np.moveaxis(want, -1, 0)
    got = plus.residual(torch.from_numpy(cnn_input))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 96, 128)
    assert np.abs(want).max() > 1e-4  # a residual worth comparing
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_learned_run_matches(cnn_input, jax_weights):
    rng = np.random.default_rng(12)
    rt = rng.uniform(0, 1, (3, 48, 64)).astype(np.float32)
    depth = rng.uniform(1, 200, (48, 64)).astype(np.float32)
    flow = rng.uniform(-4, 4, (2, 48, 64)).astype(np.float32)
    reactive = rng.uniform(0, 1, (48, 64)).astype(np.float32)
    arrays = (rt, depth, flow, reactive)
    want = jlus._run(jlus.get_params(), *map(jnp.asarray, arrays), 96, 128)
    got = plus._run(*map(torch.from_numpy, arrays), 96, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------------ frames

# name -> (display, upscaler, mode, render size, sharpness, motion blur)
FRAMES = {
    "fsr_performance_rcas_blur": ((128, 96), pd.UPSCALER_FSR,
                                  pd.UPSCALER_MODE_PERFORMANCE, (64, 48), 0.5, 0.5),
    "fsr_auto_tiled": ((256, 128), pd.UPSCALER_FSR, pd.UPSCALER_MODE_AUTO,
                       (192, 96), 0.0, 0.0),
    "xess_performance": ((128, 96), pd.UPSCALER_XESS,
                         pd.UPSCALER_MODE_PERFORMANCE, (64, 48), 0.0, 0.0),
    "dlss_performance": ((128, 96), pd.UPSCALER_DLSS,
                         pd.UPSCALER_MODE_PERFORMANCE, (64, 48), 0.0, 0.0),
}
DRAWS = 3


def _draw(side, name):
    (w, h), upscaler, mode, _, sharpness, blur = FRAMES[name]
    if side == "jax":
        dev, scene, view = jts.build_sample_scene(w, h, gi_samples=0)
    else:
        dev, scene, view = pts.build_sample_scene(w, h, gi_samples=0, device="cpu")
    view.desc.upscaler = upscaler
    view.desc.upscaler_mode = mode
    view.desc.upscaler_sharpness = sharpness
    view.desc.motion_blur_strength = blur
    if blur:
        # The sphere moved 0.4 to the right since the last frame.
        sphere = scene.instances[0]
        sphere.desc.previous_transform = (
            np.asarray(sphere.desc.transform, np.float32)
            @ pm.translation(-0.4, 0.0, 0.0))
        sphere.set_description(sphere.desc)
    fbs = []
    for _ in range(DRAWS):
        dev.draw()
        fbs.append(view.framebuffer()[..., :3].copy())
    r = view._renderer
    cfg = r._config()
    temporal = r._last.temporal
    return dict(fbs=fbs, render=(cfg.rt_width, cfg.rt_height),
                image=tuple(r._last.image.shape),
                temporal=None if temporal is None else tuple(temporal.shape),
                sharpen=cfg.sharpen_enabled, blur=cfg.motion_blur_enabled)


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frames_match(name, jax_weights):
    (w, h), upscaler, _, render, sharpness, blur = FRAMES[name]
    j = _draw("jax", name)
    p = _draw("port", name)
    channels = pups.temporal_channels(upscaler)
    for side in (j, p):
        assert side["render"] == render
        assert side["image"] == (3, h, w)
        assert side["temporal"] == ((channels, h, w) if channels else None)
        assert side["sharpen"] == (sharpness > 0) and side["blur"] == (blur > 0)
    for jf, pf in zip(j["fbs"], p["fbs"]):
        assert pf.shape == jf.shape == (h, w, 3)
        assert ssim(jf, pf) >= 0.99
        diff = np.abs(jf.astype(np.int16) - pf.astype(np.int16))
        assert diff.max() <= 2, diff.max()


def test_upscaler_support():
    from rt64tpu_torch.utils.testscenes import build_sample_scene

    _, _, view = build_sample_scene(32, 16, gi_samples=0, device="cpu")
    assert all(view.get_upscaler_support(u) for u in UPSCALERS)
    assert not view.get_upscaler_support(0x5)


def test_upscale_steps_from_frame_outputs(jax_weights):
    """temporal_upscale_step and learned_upscale, driven from a drawn
    frame's outputs: a fresh history gives the bilinear upscale."""
    dev, _, view = pts.build_sample_scene(128, 96, gi_samples=0, device="cpu",
                                          upscaler=pd.UPSCALER_FSR)
    view.desc.upscaler_mode = pd.UPSCALER_MODE_PERFORMANCE
    dev.draw()
    r = view._renderer
    out, cfg = r._last, r._config()
    img, hist = pups.temporal_upscale_step(None, out, cfg)
    assert img is hist and tuple(img.shape) == (3, 96, 128)
    np.testing.assert_allclose(
        img.numpy(), pfilters.bilinear_resize(out.rt_output, 96, 128).numpy(),
        **TOL)
    learned = pups.learned_upscale(out, cfg)
    assert tuple(learned.shape) == (3, 96, 128)
    np.testing.assert_allclose(learned.numpy(), img.numpy(), rtol=0, atol=1e-3)
