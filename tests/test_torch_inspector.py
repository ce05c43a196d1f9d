"""The port's Inspector against the JAX package's, on the CPU: one command
script to both over the sample scene at 64x48, after the scripts of the
JAX package's tests/test_pipeline.py (console, dump, gizmos, occlusion
dither, camera, live edits, gizmo drag).

- Replies are equal as strings, edited fields and view matrices equal.
- Framebuffers with the light gizmos drawn are equal byte for byte (64
  wide: the frames themselves are equal, measured), the occluded ring
  pixels keep to the odd checkerboard squares.
- The dumped PNG (the port writes it with zlib, not Pillow: the bytes
  differ, the pixels do not) decodes to the framebuffer, and so does the
  JAX package's; a BMP dump reads back through Pillow.
- Device.draw() runs the Inspector after the scenes (the dump index
  counts draws).
"""

import os

import numpy as np
import pytest
import torch

import rt64tpu
from rt64tpu.ops import math3d as jm
from rt64tpu.utils.testscenes import build_sample_scene as jax_sample

import rt64tpu_torch
from rt64tpu_torch.ops import math3d as pm
from rt64tpu_torch.utils import assets
from rt64tpu_torch.utils.testscenes import build_sample_scene as port_sample


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers side by side, and the torch work
    here is many tiny eager ops: one intra-op thread is the fastest. The
    worker's setting comes back when this file is done."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair():
    """(JAX (dev, scene, view, inspector), port (...)) over the sample
    scene 64x48 with gi 0, every ref registered."""
    out = []
    for make, pkg, kw in ((jax_sample, rt64tpu, {}),
                             (port_sample, rt64tpu_torch, dict(device="cpu"))):
        dev, scene, view = make(width=64, height=48, gi_samples=0, **kw)
        ins = pkg.Inspector(dev)
        ins.set_material(scene.instances[0].desc.material, "sphere")
        ins.set_scene(scene.desc)
        ins.set_lights(scene.lights, len(scene.lights), 16)
        out.append((dev, scene, view, ins))
    return out


def test_math3d_helpers_match():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    np.testing.assert_array_equal(pm.transform_points_h(pts, m),
                                  jm.transform_points_h(pts, m))
    for angle in (0.0, 0.03, -1.2):
        np.testing.assert_array_equal(pm.rotation_y(angle), jm.rotation_y(angle))


SCRIPT = [
    "print hello world",
    "get material.diffuse_color_mix",
    "set material.diffuse_color_mix 1 0 0 1",
    "get material.diffuse_color_mix",
    "set material.reflection_factor 0.25",
    "get material.reflection_factor",
    "list material",
    "list scene",
    "list light",
    "list view",
    "get scene.ambient_base_color",
    "set scene.ambient_base_color 0.2 0.1 0.05",
    "get light.0.position",
    "set light.0.diffuse_color 0.5 0.6 0.7",
    "get light.7.position",
    "get view.max_reflections",
    "set view.max_reflections 1",
    "set view.denoiser_enabled on",
    "get view.denoiser_enabled",
    "get view.di_samples",
    "set view.upscaler_sharpness 0.5",
    "get view.nonsense",
    "get nowhere.field",
    "set material.diffuse_color_mix 1 0",
    "camera move 0.5 0 0",
    "camera rotate 0.1 0.05",
    "camera roll 1",
    "frobnicate",
    "",
    "gizmo press 1 1",
    "gizmo drag 10 10",
    "gizmo release",
]


def test_command_script_replies_and_edits_match():
    (jdev, jscene, jview, jins), (pdev, pscene, pview, pins) = _pair()
    j_replies = [jins.command(c) for c in SCRIPT]
    p_replies = [pins.command(c) for c in SCRIPT]
    assert p_replies == j_replies
    assert p_replies[2] == "OK" and p_replies[3] == "1 0 0 1"
    assert pins.messages == jins.messages == ["hello world"]
    pm_, jm_ = pscene.instances[0].desc.material, jscene.instances[0].desc.material
    assert pm_.diffuse_color_mix == jm_.diffuse_color_mix == (1.0, 0.0, 0.0, 1.0)
    assert pm_.reflection_factor == jm_.reflection_factor == 0.25
    assert pscene.desc.ambient_base_color == jscene.desc.ambient_base_color
    assert pscene.lights[0].diffuse_color == jscene.lights[0].diffuse_color
    assert pview.max_reflections == jview.max_reflections == 1
    assert pview.desc.denoiser_enabled and jview.desc.denoiser_enabled
    assert pview.desc.upscaler_sharpness == jview.desc.upscaler_sharpness == 0.5
    np.testing.assert_allclose(pview.view_matrix, jview.view_matrix,
                               rtol=0, atol=1e-6)
    pins.print_clear()
    assert pins.messages == []


def _park_light_ahead(view, light, dist):
    eye, fwd = view.get_view_position(), view.get_view_direction()
    light.position = tuple(float(v) for v in (eye + fwd * dist))


def test_gizmo_drag_matches():
    (_, jscene, jview, jins), (_, pscene, pview, pins) = _pair()
    for view, scene in ((jview, jscene), (pview, pscene)):
        _park_light_ahead(view, scene.lights[0], 10.0)
    pos0 = np.asarray(pscene.lights[0].position, np.float32)
    proj = pm.perspective_fov_rh(pview.fov_radians, 64 / 48, pview.near_dist,
                                 pview.far_dist)
    clip = pm.transform_points_h(pos0, pview.view_matrix @ proj)
    sx = (0.5 + 0.5 * clip[0] / clip[3]) * 64
    sy = (0.5 - 0.5 * clip[1] / clip[3]) * 48
    script = [f"gizmo press {sx:.1f} {sy:.1f}", f"gizmo drag {sx + 6:.1f} {sy:.1f}",
              f"gizmo drag {sx + 6:.1f} {sy - 3:.1f}", "gizmo release",
              "gizmo drag 10 10"]
    j_replies = [jins.command(c) for c in script]
    p_replies = [pins.command(c) for c in script]
    assert p_replies == j_replies
    assert p_replies[0] == "OK 0" and p_replies[1].startswith("OK ")
    assert p_replies[-1] == "MISS"
    assert pscene.lights[0].position == jscene.lights[0].position
    pos1 = np.asarray(pscene.lights[0].position, np.float32)
    fwd, eye = pview.get_view_direction(), pview.get_view_position()
    assert np.linalg.norm(pos1 - pos0) > 1e-3  # moved, in the view plane
    assert abs(float(np.dot(pos1 - eye, fwd)) - 10.0) < 0.1


@pytest.fixture(scope="module")
def gizmo_frames(tmp_path_factory):
    """Both packages draw the scene twice with the light gizmos on and a
    dump directory set; the sun is parked ahead of the camera and to the
    right (open) and a second light far behind the sphere (occluded)."""
    dirs = {}
    out = []
    for name, (dev, scene, view, ins) in zip(("jax", "port"), _pair()):
        dev.draw()
        _park_light_ahead(view, scene.lights[0], 3.0)
        right = np.linalg.inv(view.view_matrix)[0, :3]
        scene.lights[0].position = tuple(
            float(v) for v in np.asarray(scene.lights[0].position) + right)
        eye = view.get_view_position()
        centre = np.asarray(scene.instances[0].desc.transform,
                            np.float32).reshape(4, 4)[3, :3]
        far = type(scene.lights[0])(
            position=tuple(float(v) for v in eye + (centre - eye) * 20.0),
            diffuse_color=(0.2, 0.9, 0.3))
        scene.lights.append(far)
        dirs[name] = str(tmp_path_factory.mktemp(name))
        assert ins.command("gizmos on") == "OK"
        assert ins.command(f"dump {dirs[name]}") == "OK"
        before = []
        render = ins.render

        def hooked(view=view, render=render, before=before):
            before.append(view.framebuffer()[..., :3].copy())
            render()

        ins.render = hooked
        dev.draw()
        dev.draw()
        out.append((view, before[-1], view.framebuffer().copy(), dirs[name],
                    scene))
    return out


def test_gizmo_framebuffers_match(gizmo_frames):
    (jview, jpre, jfb, _, _), (pview, ppre, pfb, _, _) = gizmo_frames
    np.testing.assert_array_equal(ppre, jpre)  # the frames themselves
    np.testing.assert_array_equal(pfb, jfb)
    assert (pfb[..., :3] != ppre).any()  # the rings are drawn


def _ring(view, light, w, h):
    """The pixels of a light's gizmo ring, as the Inspector places it."""
    proj = pm.perspective_fov_rh(view.fov_radians, w / h, view.near_dist,
                                 view.far_dist)
    clip = pm.transform_points_h(np.asarray(light.position, np.float32),
                                 view.view_matrix @ proj)
    sx = int((0.5 + 0.5 * clip[0] / clip[3]) * w)
    sy = int((0.5 - 0.5 * clip[1] / clip[3]) * h)
    yy, xx = np.mgrid[-5:6, -5:6]
    ring = np.abs(np.hypot(xx, yy) - 5) < 1.0
    return np.clip(sy + yy[ring], 0, h - 1), np.clip(sx + xx[ring], 0, w - 1)


def test_occluded_gizmo_dithers(gizmo_frames):
    """The far light's ring, behind the sphere: where the scene is nearer
    than the light, only odd checkerboard squares change (blended at
    half opacity); elsewhere the ring takes its colour."""
    from rt64tpu_torch.pipeline import framegraph as pfg

    _, (view, pre, fb, _, scene) = gizmo_frames
    pick, cfg = view._renderer._pick_src
    inst = pfg.to_image(cfg, pick.instance).numpy()
    pos = pfg.to_image(cfg, pick.position).numpy().transpose(1, 2, 0)
    far = scene.lights[-1]
    ys, xs = _ring(view, far, 64, 48)
    eye = np.linalg.inv(view.view_matrix.astype(np.float64))[3, :3]
    dist = np.where(inst[ys, xs] >= 0,
                    np.linalg.norm(pos[ys, xs] - eye, axis=-1), np.inf)
    occluded = dist < np.linalg.norm(np.asarray(far.position) - eye)
    assert occluded.any()
    changed = (pre[ys, xs] != fb[ys, xs, :3]).any(-1)
    odd = (ys + xs) % 2 == 1
    assert not changed[occluded & ~odd].any()
    assert changed[occluded & odd].any()
    colour = np.clip(np.asarray(far.diffuse_color) * 255 + 64, 0, 255).astype(np.uint8)
    assert (fb[ys, xs, :3][~occluded] == colour).all()


def test_dumped_png_reads_back(gizmo_frames):
    (_, _, jfb, jdir, _), (_, _, pfb, pdir, _) = gizmo_frames
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == [
        "frame_00000.png", "frame_00001.png"]
    np.testing.assert_array_equal(
        assets.read_image(os.path.join(pdir, "frame_00001.png")), pfb)
    np.testing.assert_array_equal(
        assets.read_image(os.path.join(jdir, "frame_00001.png")), jfb)


def test_bmp_and_png_writers(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    rgba = rng.integers(0, 256, (7, 13, 4), dtype=np.uint8)
    assets.write_bmp(str(tmp_path / "a" / "f.bmp"), rgba)
    back = np.asarray(Image.open(tmp_path / "a" / "f.bmp").convert("RGB"))
    np.testing.assert_array_equal(back, rgba[..., :3])
    assets.write_png(str(tmp_path / "f.png"), rgba)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "f.png").convert("RGBA")), rgba)
    img = rng.random((5, 6, 3)).astype(np.float32)
    assets.write_png(str(tmp_path / "g.png"), img)
    want = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(assets.read_image(str(tmp_path / "g.png"))[..., :3], want)


def test_draw_runs_the_inspector_after_the_scenes(tmp_path):
    dev, _, view = port_sample(width=64, height=32, gi_samples=0, device="cpu")
    assert dev.inspector is None
    ins = rt64tpu_torch.Inspector(dev)
    assert dev.inspector is ins
    seen = []
    ins.render = lambda: seen.append(view._framebuffer is not None)
    dev.draw()
    assert seen == [True]
