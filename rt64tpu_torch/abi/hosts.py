"""The sample hosts' calls, replayed in Python through a bridge module.

sample_host(bridge) and sample_host_dl(bridge) make the calls that
sample_host.cpp and sample_host_dl.cpp make through the C ABI, in the
same order and with the same values (float32 arithmetic, sinf and cosf
from the C library), each through the bridge function the shim forwards
that call to. `bridge` is rt64tpu_torch.abi.bridge, or any module with
its structs and functions (the JAX package's bridge has them too), so
the frame a host writes can be held against the same calls made in
Python, on either package.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

from rt64tpu_torch import descriptors as d

_f32 = np.float32
_libm = ctypes.CDLL(ctypes.util.find_library("m"))
for _name in ("sinf", "cosf"):
    getattr(_libm, _name).argtypes = [ctypes.c_float]
    getattr(_libm, _name).restype = ctypes.c_float
# DrawDevice(device, 1, 1000.0f / 60.0f): the shim passes microseconds.
DELTA_MS = _f32(1000.0) / _f32(60.0)
_DELTA_US = int(DELTA_MS * _f32(1000.0))
_FOV = _f32(_f32(45.0) * _f32(3.14159265)) / _f32(180.0)


def _addr(obj) -> int:
    return ctypes.addressof(obj)


def _identity(bridge):
    m = bridge.Matrix4()
    for i in range(4):
        m.m[i][i] = 1.0
    return m


def _default_material(bridge):
    mat = bridge.CMaterial()
    mat.diffuseTexIndex = mat.normalTexIndex = mat.specularTexIndex = -1
    mat.uvDetailScale = 1.0
    mat.specularColor = bridge.Vec3(1.0, 1.0, 1.0)
    mat.specularExponent = 25.0
    mat.solidAlphaMultiplier = 1.0
    mat.shadowAlphaMultiplier = 1.0
    mat.lightGroupMaskBits = 0xFFFFFFFF
    return mat


def _sphere(radius, rings, sectors):
    """make_sphere of sample_host.cpp: (V, 12) float32 rows pos4, nrm3,
    uv2, col3, and the index list."""
    pi = _f32(np.pi)
    rows = []
    for r in range(rings + 1):
        phi = pi * _f32(r) / _f32(rings)
        for s in range(sectors + 1):
            theta = _f32(2.0) * pi * _f32(s) / _f32(sectors)
            sp, cp = _f32(_libm.sinf(phi)), _f32(_libm.cosf(phi))
            st, ct = _f32(_libm.sinf(theta)), _f32(_libm.cosf(theta))
            n = (sp * ct, cp, sp * st)
            rows.append([n[0] * radius, n[1] * radius, n[2] * radius, 1.0,
                         *n, _f32(s) / _f32(sectors), _f32(r) / _f32(rings),
                         1.0, 1.0, 1.0])
    cols = sectors + 1
    idx = []
    for r in range(rings):
        for s in range(sectors):
            a = r * cols + s
            b = a + cols
            idx += [a, a + 1, b, a + 1, b + 1, b]
    return np.asarray(rows, np.float32), np.asarray(idx, np.uint32)


def _set_mesh(bridge, mesh, verts, idx):
    bridge.set_mesh(mesh, verts.ctypes.data, verts.shape[0], verts.strides[0],
                    idx.ctypes.data, idx.shape[0])


def _frame(bridge, view):
    """(pixels (H, W, 4) uint8, width, height) through GetViewFrameSize
    and GetViewFramePixels."""
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    bridge.get_view_frame_size(view, _addr(w), _addr(h))
    pixels = np.zeros((h.value, w.value, 4), np.uint8)
    if not bridge.get_view_frame_pixels(view, pixels.ctypes.data, pixels.nbytes):
        raise RuntimeError("GetViewFramePixels failed")
    return pixels, w.value, h.value


def _draw(bridge, draw):
    """The DrawDevice call: draw(device handle) when given (for example
    the library's RT64_DrawDevice, or a timed Device.draw)."""
    if draw is not None:
        return draw
    return lambda device: bridge.draw_device(device, 1, _DELTA_US)


def sample_host(bridge, frames: int = 3, draw=None):
    """sample_host.cpp's calls: (pixels (H, W, 4) uint8, what it picked at
    the centre: "sphere", "other" or "none"). draw: see _draw."""
    draw = _draw(bridge, draw)
    device = bridge.create_device(0)
    scene = bridge.create_scene(device)
    view = bridge.create_view(scene)

    yy, xx = np.mgrid[0:32, 0:32]
    on = ((xx // 4 + yy // 4) & 1) != 0
    texels = np.zeros((32, 32, 4), np.uint8)
    texels[..., :3] = np.where(on, 230, 40)[..., None]
    texels[..., 3] = 255
    tdesc = bridge.CTextureDesc(texels.ctypes.data, texels.nbytes,
                                d.TEXTURE_FORMAT_RGBA8, 32, 32, 32 * 4)
    texture = bridge.create_texture(device, _addr(tdesc))

    shader = bridge.create_shader(
        device, 5 << 9 | 5 << 21, d.SHADER_FILTER_LINEAR,
        d.SHADER_ADDRESSING_WRAP, d.SHADER_ADDRESSING_WRAP,
        d.SHADER_RAYTRACE_ENABLED)
    floor_shader = bridge.create_shader(
        device, 1 << 9 | 1 << 21, d.SHADER_FILTER_POINT,
        d.SHADER_ADDRESSING_WRAP, d.SHADER_ADDRESSING_CLAMP,
        d.SHADER_RAYTRACE_ENABLED)

    sv, si = _sphere(_f32(1.5), 16, 24)
    sphere = bridge.create_mesh(
        device, d.MESH_RAYTRACE_ENABLED | d.MESH_RAYTRACE_FAST_TRACE)
    _set_mesh(bridge, sphere, sv, si)

    # Floor: pos4, nrm3, col3 (its combiner reads no texture).
    fv = np.zeros((4, 10), np.float32)
    fv[:, 0] = (-8.0, 8.0, 8.0, -8.0)
    fv[:, 2] = (-8.0, -8.0, 8.0, 8.0)
    fv[:, 3] = 1.0
    fv[:, 5] = 1.0
    fv[:, 7:10] = (0.75, 0.72, 0.70)
    fi = np.array([0, 2, 1, 0, 3, 2], np.uint32)
    floor = bridge.create_mesh(
        device, d.MESH_RAYTRACE_ENABLED | d.MESH_RAYTRACE_UPDATABLE)
    _set_mesh(bridge, floor, fv, fi)

    sphere_inst = bridge.create_instance(scene)
    floor_inst = bridge.create_instance(scene)

    light = (bridge.CLight * 1)()
    light[0].position = bridge.Vec3(15.0, 20.0, 8.0)
    light[0].diffuseColor = bridge.Vec3(0.9, 0.85, 0.75)
    light[0].attenuationRadius = 10000.0
    light[0].pointRadius = 1.5
    light[0].specularColor = bridge.Vec3(0.7, 0.65, 0.6)
    light[0].attenuationExponent = 1.0
    light[0].groupBits = d.LIGHT_GROUP_DEFAULT
    bridge.set_scene_lights(scene, _addr(light), 1)

    sd = bridge.CSceneDesc()
    sd.ambientBaseColor = bridge.Vec3(0.25, 0.25, 0.3)
    sd.skyDiffuseMultiplier = bridge.Vec3(1.0, 1.0, 1.0)
    sd.giDiffuseStrength = 0.7
    sd.giSkyStrength = 0.35
    bridge.set_scene_description(scene, _addr(sd))

    vd = bridge.CViewDesc()
    vd.resolutionScale = 1.0
    vd.diSamples = 1
    vd.giSamples = 1
    vd.maxLights = 4
    vd.upscaler = d.UPSCALER_OFF
    bridge.set_view_description(view, _addr(vd))

    view_matrix = _identity(bridge)
    view_matrix.m[3][1] = -3.0
    view_matrix.m[3][2] = -9.0
    params = (ctypes.c_float * 3)(_FOV, 0.1, 1000.0)
    for _ in range(frames):
        bridge.set_view_perspective(view, _addr(view_matrix), _addr(params), 1)
        inst = bridge.CInstanceDesc()
        inst.mesh = sphere
        inst.transform = _identity(bridge)
        inst.transform.m[3][1] = 1.5
        inst.previousTransform = inst.transform
        inst.diffuseTexture = texture
        inst.shader = shader
        inst.material = _default_material(bridge)
        inst.material.reflectionFactor = 0.3
        inst.material.reflectionFresnelFactor = 0.4
        bridge.set_instance_description(sphere_inst, _addr(inst))

        finst = bridge.CInstanceDesc()
        finst.mesh = floor
        finst.transform = _identity(bridge)
        finst.previousTransform = finst.transform
        finst.shader = floor_shader
        finst.material = _default_material(bridge)
        bridge.set_instance_description(floor_inst, _addr(finst))

        draw(device)

    pixels, w, h = _frame(bridge, view)
    picked = bridge.get_view_raytraced_instance_at(view, w // 2, h // 2)
    name = "sphere" if picked == sphere_inst else "other" if picked else "none"

    for inst in (sphere_inst, floor_inst):
        bridge.destroy_instance(inst)
    for mesh in (sphere, floor):
        bridge.destroy_mesh(mesh)
    for s in (shader, floor_shader):
        bridge.destroy_shader(s)
    bridge.destroy_texture(texture)
    bridge.destroy_view(view)
    bridge.destroy_scene(scene)
    bridge.destroy_device(device)
    return pixels, name


def sample_host_dl(bridge, draw=None):
    """sample_host_dl.cpp's calls after RT64_LoadLibrary (its material
    overlay is a header inline and makes no call): pixels (H, W, 4)
    uint8 of its one frame. draw: see _draw."""
    draw = _draw(bridge, draw)
    device = bridge.create_device(0)
    scene = bridge.create_scene(device)
    view = bridge.create_view(scene)

    verts = np.zeros((3, 10), np.float32)  # pos4, nrm3, col3
    verts[:, 0] = (-2.0, 2.0, 0.0)
    verts[:, 1] = (0.0, 0.0, 3.0)
    verts[:, 3] = 1.0
    verts[:, 6] = 1.0
    verts[:, 7:10] = (0.9, 0.4, 0.2)
    idx = np.array([0, 1, 2], np.uint32)
    shader = bridge.create_shader(
        device, 1 << 9 | 1 << 21, d.SHADER_FILTER_POINT,
        d.SHADER_ADDRESSING_WRAP, d.SHADER_ADDRESSING_WRAP,
        d.SHADER_RAYTRACE_ENABLED)
    mesh = bridge.create_mesh(device, d.MESH_RAYTRACE_ENABLED)
    _set_mesh(bridge, mesh, verts, idx)
    inst = bridge.create_instance(scene)

    light = (bridge.CLight * 1)()
    light[0].position = bridge.Vec3(5.0, 8.0, 10.0)
    light[0].diffuseColor = bridge.Vec3(1.0, 1.0, 1.0)
    light[0].attenuationRadius = 10000.0
    light[0].pointRadius = 1.0
    light[0].attenuationExponent = 1.0
    light[0].groupBits = d.LIGHT_GROUP_DEFAULT
    bridge.set_scene_lights(scene, _addr(light), 1)

    sd = bridge.CSceneDesc()
    sd.ambientBaseColor = bridge.Vec3(0.3, 0.3, 0.3)
    bridge.set_scene_description(scene, _addr(sd))

    vd = bridge.CViewDesc()
    vd.resolutionScale = 1.0
    vd.diSamples = 1
    vd.maxLights = 2
    vd.upscaler = d.UPSCALER_OFF
    bridge.set_view_description(view, _addr(vd))

    vm = _identity(bridge)
    vm.m[3][1] = -1.0
    vm.m[3][2] = -8.0
    params = (ctypes.c_float * 3)(_FOV, 0.1, 1000.0)
    bridge.set_view_perspective(view, _addr(vm), _addr(params), 1)

    desc = bridge.CInstanceDesc()
    desc.mesh = mesh
    desc.transform = _identity(bridge)
    desc.previousTransform = desc.transform
    desc.shader = shader
    desc.material.diffuseTexIndex = -1
    desc.material.normalTexIndex = -1
    desc.material.specularTexIndex = -1
    desc.material.uvDetailScale = 1.0
    desc.material.solidAlphaMultiplier = 1.0
    desc.material.shadowAlphaMultiplier = 1.0
    desc.material.lightGroupMaskBits = 0xFFFFFFFF
    bridge.set_instance_description(inst, _addr(desc))

    draw(device)
    pixels, _, _ = _frame(bridge, view)

    bridge.destroy_instance(inst)
    bridge.destroy_mesh(mesh)
    bridge.destroy_shader(shader)
    bridge.destroy_view(view)
    bridge.destroy_scene(scene)
    bridge.destroy_device(device)
    return pixels
