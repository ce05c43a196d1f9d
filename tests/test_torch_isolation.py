"""rt64tpu_torch stands alone: it imports neither JAX nor the rt64tpu
package (nor does its C ABI shim, which embeds the port's bridge), its
Device defaults to the CUDA card, and every feature of the JAX package
renders (the one part not ported, row tiling over several devices,
raises NotImplementedError: tests/test_torch_tiling.py)."""

import ast
import glob
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from rt64tpu_torch import descriptors as d
from rt64tpu_torch.ops import math3d
from rt64tpu_torch.pipeline import framegraph as fg
from rt64tpu_torch.utils.testscenes import (build_sample_scene, dds_texture,
                                            hud_triangle)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers side by side, and the torch work
    here is many tiny eager ops: one intra-op thread is the fastest. The
    worker's setting comes back when this file is done."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "rt64tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "rt64tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return paths


def test_no_source_imports_jax_or_rt64tpu():
    paths = _port_sources()
    assert len(paths) > 20
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path} imports {bad}"


def test_shim_imports_the_port_bridge():
    """The C ABI's shim embeds the port's bridge, never the JAX
    package's, and the header's loader names the port's library."""
    abi = os.path.join(ROOT, "rt64tpu_torch", "abi")
    sources = glob.glob(os.path.join(abi, "*.cpp"))
    imports = []
    for path in sources:
        with open(path) as f:
            imports += re.findall(r'PyImport_ImportModule\("([^"]+)"\)', f.read())
    assert len(sources) == 3 and imports == ["rt64tpu_torch.abi.bridge"]
    with open(os.path.join(abi, "rt64_tpu.h")) as f:
        header = f.read()
    assert re.findall(r'dlopen\(path != NULL \? path : "([^"]+)"', header) == [
        "librt64tpu_torch.so"]


def test_tiny_frame_runs_without_jax_or_rt64tpu():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from rt64tpu_torch.utils.testscenes import build_sample_scene
        for gi in (0, 1):
            dev, scene, view = build_sample_scene(
                64, 32, gi_samples=gi, denoiser=bool(gi), device="cpu")
            view.max_reflections = 0
            dev.draw()
            dev.draw()
            fb = view.framebuffer()
            assert fb.shape == (32, 64, 4) and fb[..., :3].std() > 1.0
        bad = [m for m in sys.modules
               if m in ("jax", "jaxlib", "rt64tpu")
               or m.startswith(("jax.", "jaxlib.", "rt64tpu."))]
        assert not bad, bad
        print("ok")
    """)
    # Few intra-op threads: the suite runs several workers side by side.
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_device_defaults_to_cuda():
    import rt64tpu_torch

    if torch.cuda.is_available():
        assert rt64tpu_torch.Device().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            rt64tpu_torch.Device()
    assert rt64tpu_torch.Device(device="cpu").device.type == "cpu"


def _scene(**kw):
    dev, scene, view = build_sample_scene(64, 32, gi_samples=0, device="cpu", **kw)
    view.max_reflections = 0
    return dev, scene, view


def _reflections(dev, scene, view):
    view.max_reflections = 2  # the sphere is reflective


def _refraction(dev, scene, view):
    # A refractive surface seeds refraction with the alpha it lets
    # through (PrimaryRayGen.hlsl:156-161), so the sphere turns half
    # transparent too.
    material = scene.instances[0].desc.material
    material.refraction_factor = 1.2
    material.solid_alpha_multiplier = 0.5


def _mip_lod(dev, scene, view):
    scene.instances[0].desc.shader.mip_lod_enabled = True  # the checker


def _upscaler(dev, scene, view):
    view.desc.upscaler = d.UPSCALER_FSR


def _resolution_scale(dev, scene, view):
    view.desc.resolution_scale = 0.5


def _motion_blur(dev, scene, view):
    # The blur follows the flow: the sphere moved since the last frame
    # (its previous transform lies 0.4 to the left), the camera did not.
    view.desc.motion_blur_strength = 0.5
    sphere = scene.instances[0]
    sphere.desc.previous_transform = (
        np.asarray(sphere.desc.transform, np.float32)
        @ math3d.translation(-0.4, 0.0, 0.0))
    sphere.set_description(sphere.desc)


def _visualization(dev, scene, view):
    view.visualization_mode = d.VISUALIZATION_MODE_DEPTH


def _raster_hud(dev, scene, view):
    hud_triangle(scene, dev)


def _raster_background(dev, scene, view):
    # A game that draws its own skybox has no sky plane: primary misses
    # show the raster background.
    view.set_sky_plane(None)
    hud_triangle(scene, dev, background=True)


def _pipelined(dev, scene, view):
    # As bench.py's streamed loop turns the ring on: on the live renderer.
    view.pipelined_present = True
    view._renderer.pipelined = True


def _dds_texture(dev, scene, view):
    # A BC1 texture of opaque blocks on the sphere in place of its checker.
    sphere = scene.instances[0]
    sphere.desc.diffuse_texture = dds_texture(dev, b"DXT1", 32, seed=4,
                                              bc1_punch=False)
    sphere.set_description(sphere.desc)


def _gi(dev, scene, view):
    view.desc.gi_samples = 1


def _denoiser(dev, scene, view):
    view.desc.denoiser_enabled = True


def _gi_denoiser(dev, scene, view):
    view.desc.gi_samples = 1
    view.desc.denoiser_enabled = True


@pytest.mark.parametrize("enable", [
    _gi, _denoiser, _gi_denoiser, _reflections, _refraction, _mip_lod,
    _visualization, _raster_hud, _raster_background, _upscaler,
    _resolution_scale, _motion_blur, _pipelined, _dds_texture,
], ids=lambda f: f.__name__.strip("_"))
def test_in_slice_features_render(enable):
    """GI, the GI denoiser, reflections, refraction, mip LOD, the debug
    views, the raster foreground and background, the upscaler, resolution
    scaling, motion blur, the pipelined present and a DDS texture render:
    two frames,
    the second over the first one's history (the pipelined view two
    more, to fill its ring). All but the denoiser alone and the ring
    change the frame; the ring presents the frame of two draws before."""
    dev, scene, view = _scene()
    dev.draw()
    plain = view.framebuffer().copy()
    enable(dev, scene, view)
    drawn = []
    for _ in range(4 if enable is _pipelined else 2):
        dev.draw()
        drawn.append(fg.present_rgb8(view._renderer._last.image).numpy())
    fb = view.framebuffer()
    assert fb.shape == plain.shape and fb[..., :3].std() > 1.0
    hist_len = view._renderer._last.indirect_accum[3]
    wants_history = view.desc.gi_samples > 0 and view.desc.denoiser_enabled
    assert bool(hist_len.max() > 1.5) == wants_history
    if enable is _pipelined:
        assert np.array_equal(fb[..., :3], drawn[-3])
    elif enable is not _denoiser:
        assert (fb != plain).any()  # the feature shows in the frame
