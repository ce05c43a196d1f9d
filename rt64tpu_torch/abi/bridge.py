"""Python side of the C ABI: parses POD structs from raw addresses.

The native shim (rt64_abi.cpp) forwards every RT64_* call here with
pointer arguments as integers; ctypes.Structure mirrors of rt64_tpu.h
decode them. Handles returned to C are stable integer ids mapped to the
live Python objects in a registry (the opaque-pointer contract of the
reference ABI).

Device selection: the bridge draws on the CUDA card, or on the CPU only
when RT64TPU_TORCH_DEVICE=cpu says so (any torch device name is taken as
given). Without the variable and without a card, RT64_CreateDevice fails
and the error reaches the host through RT64_GetLastError: there is no
quiet fallback to another device.
"""

from __future__ import annotations

import ctypes
import os
import re
from typing import Dict

import numpy as np
import torch

import rt64tpu_torch
from rt64tpu_torch import descriptors as d

DEVICE_ENV = "RT64TPU_TORCH_DEVICE"


class Vec2(ctypes.Structure):
    _fields_ = [("x", ctypes.c_float), ("y", ctypes.c_float)]


class Vec3(ctypes.Structure):
    _fields_ = [("x", ctypes.c_float), ("y", ctypes.c_float), ("z", ctypes.c_float)]

    def tup(self):
        return (self.x, self.y, self.z)


class Vec4(ctypes.Structure):
    _fields_ = [("x", ctypes.c_float), ("y", ctypes.c_float),
                ("z", ctypes.c_float), ("w", ctypes.c_float)]

    def tup(self):
        return (self.x, self.y, self.z, self.w)


class Matrix4(ctypes.Structure):
    _fields_ = [("m", (ctypes.c_float * 4) * 4)]

    def np(self):
        return np.array(
            [[self.m[i][j] for j in range(4)] for i in range(4)], np.float32
        )


class Rect(ctypes.Structure):
    _fields_ = [("x", ctypes.c_int), ("y", ctypes.c_int),
                ("w", ctypes.c_int), ("h", ctypes.c_int)]


class CMaterial(ctypes.Structure):
    _fields_ = [
        ("diffuseTexIndex", ctypes.c_int),
        ("normalTexIndex", ctypes.c_int),
        ("specularTexIndex", ctypes.c_int),
        ("ignoreNormalFactor", ctypes.c_float),
        ("uvDetailScale", ctypes.c_float),
        ("reflectionFactor", ctypes.c_float),
        ("reflectionFresnelFactor", ctypes.c_float),
        ("reflectionShineFactor", ctypes.c_float),
        ("refractionFactor", ctypes.c_float),
        ("specularColor", Vec3),
        ("specularExponent", ctypes.c_float),
        ("solidAlphaMultiplier", ctypes.c_float),
        ("shadowAlphaMultiplier", ctypes.c_float),
        ("depthBias", ctypes.c_float),
        ("shadowRayBias", ctypes.c_float),
        ("selfLight", Vec3),
        ("lightGroupMaskBits", ctypes.c_uint),
        ("fogColor", Vec3),
        ("diffuseColorMix", Vec4),
        ("fogMul", ctypes.c_float),
        ("fogOffset", ctypes.c_float),
        ("fogEnabled", ctypes.c_uint),
        ("lockMask", ctypes.c_float),
        ("enabledAttributes", ctypes.c_int),
    ]

    def to_py(self) -> d.Material:
        return d.Material(
            diffuse_tex_index=self.diffuseTexIndex,
            normal_tex_index=self.normalTexIndex,
            specular_tex_index=self.specularTexIndex,
            ignore_normal_factor=self.ignoreNormalFactor,
            uv_detail_scale=self.uvDetailScale,
            reflection_factor=self.reflectionFactor,
            reflection_fresnel_factor=self.reflectionFresnelFactor,
            reflection_shine_factor=self.reflectionShineFactor,
            refraction_factor=self.refractionFactor,
            specular_color=self.specularColor.tup(),
            specular_exponent=self.specularExponent,
            solid_alpha_multiplier=self.solidAlphaMultiplier,
            shadow_alpha_multiplier=self.shadowAlphaMultiplier,
            depth_bias=self.depthBias,
            shadow_ray_bias=self.shadowRayBias,
            self_light=self.selfLight.tup(),
            light_group_mask_bits=self.lightGroupMaskBits,
            fog_color=self.fogColor.tup(),
            diffuse_color_mix=self.diffuseColorMix.tup(),
            fog_mul=self.fogMul,
            fog_offset=self.fogOffset,
            fog_enabled=self.fogEnabled,
            lock_mask=self.lockMask,
            enabled_attributes=self.enabledAttributes,
        )


class CLight(ctypes.Structure):
    _fields_ = [
        ("position", Vec3),
        ("diffuseColor", Vec3),
        ("attenuationRadius", ctypes.c_float),
        ("pointRadius", ctypes.c_float),
        ("specularColor", Vec3),
        ("shadowOffset", ctypes.c_float),
        ("attenuationExponent", ctypes.c_float),
        ("flickerIntensity", ctypes.c_float),
        ("groupBits", ctypes.c_uint),
    ]

    def to_py(self) -> d.Light:
        return d.Light(
            position=self.position.tup(),
            diffuse_color=self.diffuseColor.tup(),
            attenuation_radius=self.attenuationRadius,
            point_radius=self.pointRadius,
            specular_color=self.specularColor.tup(),
            shadow_offset=self.shadowOffset,
            attenuation_exponent=self.attenuationExponent,
            flicker_intensity=self.flickerIntensity,
            group_bits=self.groupBits,
        )


class CSceneDesc(ctypes.Structure):
    _fields_ = [
        ("ambientBaseColor", Vec3),
        ("ambientNoGIColor", Vec3),
        ("eyeLightDiffuseColor", Vec3),
        ("eyeLightSpecularColor", Vec3),
        ("skyDiffuseMultiplier", Vec3),
        ("skyHSLModifier", Vec3),
        ("skyYawOffset", ctypes.c_float),
        ("giDiffuseStrength", ctypes.c_float),
        ("giSkyStrength", ctypes.c_float),
    ]

    def to_py(self) -> d.SceneDesc:
        return d.SceneDesc(
            ambient_base_color=self.ambientBaseColor.tup(),
            ambient_no_gi_color=self.ambientNoGIColor.tup(),
            eye_light_diffuse_color=self.eyeLightDiffuseColor.tup(),
            eye_light_specular_color=self.eyeLightSpecularColor.tup(),
            sky_diffuse_multiplier=self.skyDiffuseMultiplier.tup(),
            sky_hsl_modifier=self.skyHSLModifier.tup(),
            sky_yaw_offset=self.skyYawOffset,
            gi_diffuse_strength=self.giDiffuseStrength,
            gi_sky_strength=self.giSkyStrength,
        )


class CViewDesc(ctypes.Structure):
    _fields_ = [
        ("resolutionScale", ctypes.c_float),
        ("motionBlurStrength", ctypes.c_float),
        ("diSamples", ctypes.c_uint),
        ("giSamples", ctypes.c_uint),
        ("maxLights", ctypes.c_uint),
        ("upscaler", ctypes.c_ubyte),
        ("upscalerMode", ctypes.c_ubyte),
        ("upscalerSharpness", ctypes.c_float),
        ("denoiserEnabled", ctypes.c_bool),
    ]


class CInstanceDesc(ctypes.Structure):
    _fields_ = [
        ("mesh", ctypes.c_void_p),
        ("transform", Matrix4),
        ("previousTransform", Matrix4),
        ("diffuseTexture", ctypes.c_void_p),
        ("normalTexture", ctypes.c_void_p),
        ("specularTexture", ctypes.c_void_p),
        ("shader", ctypes.c_void_p),
        ("material", CMaterial),
        ("scissorRect", Rect),
        ("viewportRect", Rect),
        ("flags", ctypes.c_uint),
    ]


class CTextureDesc(ctypes.Structure):
    _fields_ = [
        ("bytes", ctypes.c_void_p),
        ("byteCount", ctypes.c_int),
        ("format", ctypes.c_int),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("rowPitch", ctypes.c_int),
    ]


# ---- handle registry -------------------------------------------------------
_objects: Dict[int, object] = {}
_next_handle = 1


def _register(obj) -> int:
    global _next_handle
    h = _next_handle
    _next_handle += 1
    _objects[h] = obj
    return h


def _get(handle):
    return _objects.get(int(handle))


def _release(handle):
    _objects.pop(int(handle), None)


def _at(struct_type, addr):
    return struct_type.from_address(int(addr))


# ---- device ----------------------------------------------------------------

def torch_device():
    """The device named by RT64TPU_TORCH_DEVICE, else the CUDA card;
    raises when neither is there."""
    name = os.environ.get(DEVICE_ENV)
    if name is None and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is available: the bridge draws on the card, or "
            f"on the CPU when {DEVICE_ENV}=cpu says so")
    return torch.device(name or "cuda")


def create_device(window):
    del window  # headless
    return _register(rt64tpu_torch.Device(device=torch_device()))


def destroy_device(device):
    dev = _get(device)
    if dev is not None:
        dev.destroy()
    _release(device)


def draw_device(device, vsync, delta_us):
    _get(device).draw(int(vsync), float(delta_us) / 1000.0)


# ---- scene / view ------------------------------------------------------------

def create_scene(device):
    return _register(rt64tpu_torch.Scene(_get(device)))


def set_scene_description(scene, desc_addr):
    _get(scene).set_description(_at(CSceneDesc, desc_addr).to_py())


def set_scene_lights(scene, lights_addr, count):
    arr = (CLight * int(count)).from_address(int(lights_addr))
    _get(scene).set_lights([arr[i].to_py() for i in range(int(count))])


def destroy_scene(scene):
    _release(scene)


def create_view(scene):
    # The reference sizes views from the window client rect
    # (rt64_device.cpp:199-232); headless hosts set it via env.
    w = int(os.environ.get("RT64TPU_VIEW_WIDTH", "320"))
    h = int(os.environ.get("RT64TPU_VIEW_HEIGHT", "240"))
    return _register(rt64tpu_torch.View(_get(scene), width=w, height=h))


def set_view_perspective(view, matrix_addr, params_addr, can_reproject):
    m = _at(Matrix4, matrix_addr).np()
    params = (ctypes.c_float * 3).from_address(int(params_addr))
    _get(view).set_perspective(
        m, params[0], params[1], params[2], bool(can_reproject)
    )


def set_view_description(view, desc_addr):
    c = _at(CViewDesc, desc_addr)
    _get(view).set_description(d.ViewDesc(
        resolution_scale=c.resolutionScale,
        motion_blur_strength=c.motionBlurStrength,
        di_samples=c.diSamples,
        gi_samples=c.giSamples,
        max_lights=c.maxLights,
        upscaler=c.upscaler,
        upscaler_mode=c.upscalerMode,
        upscaler_sharpness=c.upscalerSharpness,
        denoiser_enabled=c.denoiserEnabled,
    ))


def set_view_sky_plane(view, texture):
    _get(view).set_sky_plane(_get(texture))


def get_view_raytraced_instance_at(view, x, y):
    inst = _get(view).get_raytraced_instance_at(int(x), int(y))
    if inst is None:
        return 0
    return getattr(inst, "_abi_handle", 0)


def get_view_upscaler_support(view, upscaler):
    return 1 if _get(view).get_upscaler_support(int(upscaler)) else 0


def destroy_view(view):
    _release(view)


def get_view_frame_size(view, width_addr, height_addr):
    v = _get(view)
    ctypes.c_int.from_address(int(width_addr)).value = v.width
    ctypes.c_int.from_address(int(height_addr)).value = v.height


def get_view_frame_pixels(view, dst_addr, dst_size):
    # The presented frame: with the present ring on, two draws behind.
    fb = _get(view).framebuffer()
    data = np.ascontiguousarray(fb).tobytes()
    if int(dst_size) < len(data):
        return 0
    ctypes.memmove(int(dst_addr), data, len(data))
    return 1


# ---- mesh / texture / shader / instance --------------------------------------

def create_mesh(device, flags):
    return _register(rt64tpu_torch.Mesh(_get(device), int(flags)))


def set_mesh(mesh, verts_addr, vcount, stride, idx_addr, icount):
    vcount, stride, icount = int(vcount), int(stride), int(icount)
    vbytes = ctypes.string_at(int(verts_addr), vcount * stride)
    idx = np.ctypeslib.as_array(
        (ctypes.c_uint * icount).from_address(int(idx_addr))
    ).copy()
    _get(mesh).set_mesh(vbytes, vcount, stride, idx)


def destroy_mesh(mesh):
    _release(mesh)


def create_texture(device, desc_addr):
    c = _at(CTextureDesc, desc_addr)
    data = ctypes.string_at(c.bytes, c.byteCount)
    return _register(rt64tpu_torch.Texture(_get(device), d.TextureDesc(
        bytes=data, byte_count=c.byteCount, format=c.format,
        width=c.width, height=c.height, row_pitch=c.rowPitch,
    )))


def destroy_texture(texture):
    _release(texture)


def create_shader(device, shader_id, filt, h_addr, v_addr, flags):
    return _register(rt64tpu_torch.Shader(
        _get(device), int(shader_id), int(filt), int(h_addr), int(v_addr),
        int(flags),
    ))


def destroy_shader(shader):
    _release(shader)


def create_instance(scene):
    inst = rt64tpu_torch.Instance(_get(scene))
    h = _register(inst)
    inst._abi_handle = h
    return h


def set_instance_alt_texture(instance, texture):
    """RT64_SetInstanceAltTexture (an extension of the header): bind a
    real TEXEL1 texture; 0/NULL unbinds back to the reference's magenta
    stub."""
    _get(instance).set_alt_texture(_get(texture) if texture else None)


def set_instance_description(instance, desc_addr):
    c = _at(CInstanceDesc, desc_addr)

    def handle_of(vp):
        return _get(vp) if vp else None

    _get(instance).set_description(d.InstanceDesc(
        mesh=handle_of(c.mesh),
        transform=c.transform.np(),
        previous_transform=c.previousTransform.np(),
        diffuse_texture=handle_of(c.diffuseTexture),
        normal_texture=handle_of(c.normalTexture),
        specular_texture=handle_of(c.specularTexture),
        shader=handle_of(c.shader),
        material=c.material.to_py(),
        scissor_rect=(c.scissorRect.x, c.scissorRect.y, c.scissorRect.w,
                      c.scissorRect.h),
        viewport_rect=(c.viewportRect.x, c.viewportRect.y, c.viewportRect.w,
                       c.viewportRect.h),
        flags=c.flags,
    ))


def destroy_instance(instance):
    inst = _get(instance)
    if inst is not None:
        inst.destroy()
    _release(instance)


# ---- inspector ----------------------------------------------------------------

# snake_case (descriptor field) -> C struct field, where plain
# camel-casing doesn't match.
_CAMEL_OVERRIDES = {
    "ambient_no_gi_color": "ambientNoGIColor",
    "sky_hsl_modifier": "skyHSLModifier",
}


def _camel(snake: str) -> str:
    if snake in _CAMEL_OVERRIDES:
        return _CAMEL_OVERRIDES[snake]
    head, *rest = snake.split("_")
    return head + "".join(p.capitalize() for p in rest)


class _CProxy:
    """Live snake_case view over a ctypes struct in HOST memory.

    The reference's inspector panels mutate the host's registered
    RT64_MATERIAL / RT64_LIGHT / RT64_SCENE_DESC structs in place
    (rt64_inspector.cpp:226-353); this proxy gives Inspector.command
    the same write-through semantics — an edit lands in host memory and
    the host's next per-frame descriptor push carries it into the frame.
    """

    __slots__ = ("_c",)

    def __init__(self, cstruct):
        object.__setattr__(self, "_c", cstruct)

    def field_names(self):
        inv = {v: k for k, v in _CAMEL_OVERRIDES.items()}
        return [
            inv.get(c, re.sub(r"(?<!^)(?=[A-Z])", "_", c).lower())
            for c, _ in type(self._c)._fields_
        ]

    def __getattr__(self, snake):
        val = getattr(self._c, _camel(snake))
        if isinstance(val, (Vec3, Vec4)):
            return val.tup()
        return val

    def __setattr__(self, snake, value):
        camel = _camel(snake)
        cur = getattr(self._c, camel)
        if isinstance(cur, Vec3):
            cur.x, cur.y, cur.z = (float(v) for v in value)
        elif isinstance(cur, Vec4):
            cur.x, cur.y, cur.z, cur.w = (float(v) for v in value)
        else:
            setattr(self._c, camel, value)


def create_inspector(device):
    return _register(rt64tpu_torch.Inspector(_get(device)))


# Message code for the headless command protocol (the WndProc-forwarding
# analog, rt64_inspector.cpp:461-465): wParam = address of a
# NUL-terminated command string, lParam = address of a reply buffer
# (>= RT64TPU_INSPECTOR_REPLY_SIZE bytes) or 0 for no reply.
RT64TPU_MESSAGE_COMMAND = 0x7464
RT64TPU_INSPECTOR_REPLY_SIZE = 256


def handle_message_inspector(inspector, msg, wparam, lparam):
    if int(msg) != RT64TPU_MESSAGE_COMMAND or not wparam:
        return 0
    cmd = ctypes.string_at(int(wparam)).decode("utf-8", "replace")
    reply = _get(inspector).command(cmd)
    if lparam:
        data = reply.encode("utf-8")[: RT64TPU_INSPECTOR_REPLY_SIZE - 1]
        ctypes.memmove(int(lparam), data + b"\x00", len(data) + 1)
    return 1


def set_scene_inspector(inspector, desc_addr):
    _get(inspector).set_scene(_CProxy(_at(CSceneDesc, desc_addr)))


def set_material_inspector(inspector, material_addr, name_addr):
    name = ctypes.string_at(int(name_addr)).decode("utf-8", "replace")
    _get(inspector).set_material(_CProxy(_at(CMaterial, material_addr)), name)


def set_lights_inspector(inspector, lights_addr, count_addr, max_count):
    count = ctypes.c_int.from_address(int(count_addr)).value
    arr = (CLight * count).from_address(int(lights_addr))
    _get(inspector).set_lights(
        [_CProxy(arr[i]) for i in range(count)], count, int(max_count)
    )


def print_clear_inspector(inspector):
    _get(inspector).print_clear()


def print_message_inspector(inspector, msg_addr):
    _get(inspector).print_message(
        ctypes.string_at(int(msg_addr)).decode("utf-8", "replace")
    )


def destroy_inspector(inspector):
    _release(inspector)
