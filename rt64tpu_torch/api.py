"""Host-side object model mirroring the RT64 C ABI.

One class per opaque handle of the reference ABI (public/rt64.h:88-96):
Device, Scene, View, Mesh, Texture, Shader, Instance. Methods map onto
the exported C symbols; the reference analog is cited inline.

The device is headless: a frame renders into a retained numpy RGBA
buffer (`View.framebuffer()`); presentation is the host's business.
Scene state lives as torch tensors on the Device's torch device, which
is the CUDA card unless the caller asks for the CPU.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from rt64tpu_torch import descriptors as d
from rt64tpu_torch.limits import SceneLimits
from rt64tpu_torch.ops import math3d
from rt64tpu_torch.ops.combiner import CombinerParams, decode_combiner


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; anything else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rt64tpu_torch renders on a CUDA device and none is "
                "available; pass device='cpu' to run the plain-torch path"
            )
        return torch.device("cuda")
    return torch.device(device)


class Device:
    """RT64_CreateDevice / RT64_DrawDevice / RT64_DestroyDevice.

    Reference: RT64::Device (rt64_device.cpp:49-196); draw()
    (rt64_device.cpp:1027-1083) keeps the same update-then-render frame
    orchestration.
    """

    def __init__(self, limits: Optional[SceneLimits] = None, device=None):
        self.limits = limits or SceneLimits()
        self.device = resolve_device(device)
        self.scenes: List[Scene] = []
        self.meshes: List[Mesh] = []
        self.textures: List[Texture] = []
        self.shaders: List[Shader] = []
        self.frame_count = 0
        self.last_frame_time_ms = 0.0
        self._lock = threading.Lock()

    # -- registries -------------------------------------------------------
    def _register_texture(self, tex: "Texture") -> int:
        self.textures.append(tex)
        return len(self.textures) - 1

    def _register_shader(self, shader: "Shader") -> int:
        self.shaders.append(shader)
        return len(self.shaders) - 1

    def _register_mesh(self, mesh: "Mesh") -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    # -- frame loop ---------------------------------------------------------
    def draw(self, vsync_interval: int = 1, delta_time_ms: float = 1000.0 / 60.0):
        """RT64_DrawDevice (rt64_device.cpp:1027-1083, 1239-1246)."""
        t0 = time.perf_counter()
        with self._lock:
            for scene in self.scenes:
                scene.update()
            for scene in self.scenes:
                scene.render(delta_time_ms)
            self.frame_count += 1
        self.last_frame_time_ms = (time.perf_counter() - t0) * 1e3

    def destroy(self):
        self.scenes.clear()
        self.meshes.clear()
        self.textures.clear()
        self.shaders.clear()


class Mesh:
    """RT64_CreateMesh / RT64_SetMesh (rt64_mesh.cpp:190-209).

    Vertices arrive as raw interleaved bytes plus a stride, exactly like
    the C ABI; the layout is shader-dependent and decoded lazily at
    scene assembly (VertexLayout, rt64_shader.cpp:80-96). The version
    counter is the BLAS rebuild/refit trigger analog
    (rt64_mesh.cpp:33-39,76-82).
    """

    def __init__(self, device: Device, flags: int = 0):
        self.device = device
        self.flags = flags
        self.raw_vertices: Optional[np.ndarray] = None  # uint8 view
        self.vertex_count = 0
        self.vertex_stride = 0
        self.indices: Optional[np.ndarray] = None
        self.version = 0
        self._parsed_cache: Dict[tuple, dict] = {}
        self.mesh_id = device._register_mesh(self)

    def set_mesh(self, vertex_array, vertex_count: int, vertex_stride: int, index_array):
        buf = np.frombuffer(
            np.ascontiguousarray(vertex_array).tobytes()
            if isinstance(vertex_array, np.ndarray)
            else bytes(vertex_array),
            dtype=np.uint8,
        )
        if buf.size < vertex_count * vertex_stride:
            raise ValueError("vertex buffer shorter than count * stride")
        self.raw_vertices = buf[: vertex_count * vertex_stride].copy()
        self.vertex_count = vertex_count
        self.vertex_stride = vertex_stride
        self.indices = np.asarray(index_array, np.uint32).reshape(-1, 3)
        self.version += 1
        self._parsed_cache.clear()

    def parsed(self, layout_key: tuple) -> dict:
        """Decode interleaved vertices for a shader's vertex layout.

        layout_key = (has_uv, input_count, use_alpha). Returns dict with
        positions (V,3), normals (V,3), uvs (V,2), inputs (V,4,4) and a
        Morton triangle permutation (the BLAS-build analog).
        """
        cached = self._parsed_cache.get(layout_key)
        if cached is not None:
            return cached
        has_uv, input_count, use_alpha = layout_key
        f32 = self.raw_vertices.view(np.float32).reshape(self.vertex_count, -1)
        off = 0
        positions = f32[:, off : off + 3].copy()
        off += 4  # position is float4 (rt64_shader.cpp:88)
        normals = f32[:, off : off + 3].copy()
        off += 3
        if has_uv:
            uvs = f32[:, off : off + 2].copy()
            off += 2
        else:
            uvs = np.zeros((self.vertex_count, 2), np.float32)
        width = 4 if use_alpha else 3
        inputs = np.zeros((self.vertex_count, 4, 4), np.float32)
        inputs[:, :, 3] = 1.0  # float3 inputs extend with alpha=1
        for i in range(input_count):
            inputs[:, i, :width] = f32[:, off : off + width]
            off += width
        from rt64tpu_torch.ops.geometry import morton_order

        perm = morton_order(positions, self.indices.astype(np.int64))
        out = {
            "positions": positions,
            "positions4": f32[:, 0:4].copy(),
            "normals": normals,
            "uvs": uvs,
            "inputs": inputs,
            "tri_perm": perm,
            "indices": self.indices.astype(np.int32),
        }
        self._parsed_cache[layout_key] = out
        return out

    def parsed_clip(self, layout_key: tuple) -> dict:
        """Raster-path view: positions kept as clip-space float4
        (positions4, the passthrough VS contract, rt64_shader.cpp:347-356)."""
        return self.parsed(layout_key)


class Texture:
    """RT64_CreateTexture (rt64_texture.cpp:207-233).

    RGBA8 payloads are stored as (H, W, 4) uint8. Atlas placement
    happens at scene assembly.
    """

    def __init__(self, device: Device, desc: d.TextureDesc):
        self.device = device
        if desc.format == d.TEXTURE_FORMAT_RGBA8:
            data = np.frombuffer(
                np.ascontiguousarray(desc.bytes).tobytes()
                if isinstance(desc.bytes, np.ndarray)
                else bytes(desc.bytes),
                dtype=np.uint8,
            )
            row_pitch = desc.row_pitch or desc.width * 4
            rows = data[: desc.height * row_pitch].reshape(desc.height, row_pitch)
            self.rgba = rows[:, : desc.width * 4].reshape(desc.height, desc.width, 4).copy()
        elif desc.format == d.TEXTURE_FORMAT_DDS:
            raise NotImplementedError(
                "DDS textures need the BC decoder of utils/assets.py, which "
                "arrives with ROADMAP queue 1 item 16 (C ABI and drivers)"
            )
        else:
            raise ValueError(f"unknown texture format {desc.format}")
        self.width = self.rgba.shape[1]
        self.height = self.rgba.shape[0]
        self.texture_id = device._register_texture(self)


class Shader:
    """RT64_CreateShader (rt64_shader.cpp:810-824).

    Decodes the combiner id once; the vectorized interpreter
    (ops/combiner.py) consumes the decoded parameters directly.
    """

    def __init__(
        self,
        device: Device,
        shader_id: int,
        filter: int = d.SHADER_FILTER_POINT,
        h_addr: int = d.SHADER_ADDRESSING_WRAP,
        v_addr: int = d.SHADER_ADDRESSING_CLAMP,
        flags: int = d.SHADER_RAYTRACE_ENABLED,
    ):
        self.device = device
        self.shader_id = shader_id
        self.filter = filter
        self.h_addr = h_addr
        self.v_addr = v_addr
        self.flags = flags
        self.combiner: CombinerParams = decode_combiner(shader_id)
        self.normal_map_enabled = bool(flags & d.SHADER_NORMAL_MAP_ENABLED)
        self.specular_map_enabled = bool(flags & d.SHADER_SPECULAR_MAP_ENABLED)
        self.mip_lod_enabled = bool(flags & d.SHADER_MIP_LOD_ENABLED)
        self.raster_enabled = bool(flags & d.SHADER_RASTER_ENABLED)
        self.raytrace_enabled = bool(flags & d.SHADER_RAYTRACE_ENABLED)
        device._register_shader(self)

    @property
    def layout_key(self) -> tuple:
        cc = self.combiner
        has_uv = cc.use_textures[0] or cc.use_textures[1]
        return (has_uv, cc.input_count, cc.opt_alpha)


class Scene:
    """RT64_CreateScene / SetSceneLights / SetSceneDescription
    (rt64_scene.cpp:170-187)."""

    def __init__(self, device: Device):
        self.device = device
        self.desc = d.SceneDesc()
        self.instances: List[Instance] = []
        self.views: List[View] = []
        self.lights: List[d.Light] = [d.Light()]
        self._flicker_rng = np.random.default_rng(0)
        self._lights_array = None
        device.scenes.append(self)

    def set_description(self, desc: d.SceneDesc):
        self.desc = desc

    def set_lights(self, lights: List[d.Light]):
        """SetSceneLights with CPU-side flicker (rt64_scene.cpp:114-150)."""
        if not lights:
            raise ValueError("a scene needs at least one light")
        self.lights = list(lights)
        arr, groups = pack_lights(lights)
        flicker = np.array([l.flicker_intensity for l in lights], np.float32)
        mask = flicker > 0
        if mask.any():
            mult = 1.0 + (self._flicker_rng.random(len(lights)).astype(np.float32) * 2.0 - 1.0) * flicker
            arr[mask, 3:6] *= mult[mask, None]
        self._lights_array = (arr, groups)

    def lights_array(self):
        if self._lights_array is None:
            self._lights_array = pack_lights(self.lights)
        return self._lights_array

    def update(self):
        """Scene::update (rt64_scene.cpp:54-62)."""
        for view in self.views:
            view.update()

    def render(self, delta_time_ms: float):
        """Scene::render (rt64_scene.cpp:64-72)."""
        for view in self.views:
            view.render(delta_time_ms)


class Instance:
    """RT64_CreateInstance / SetInstanceDescription
    (rt64_instance.cpp:145-173)."""

    def __init__(self, scene: Scene):
        self.scene = scene
        self.desc = d.InstanceDesc()
        self._alt_texture = None  # sticky TEXEL1 binding
        scene.instances.append(self)

    def set_description(self, desc: d.InstanceDesc):
        if desc.alt_texture is None and self._alt_texture is not None:
            desc.alt_texture = self._alt_texture
        self.desc = desc

    def set_alt_texture(self, texture):
        """Bind the TEXEL1 texture (sticky across set_description calls).
        None unbinds — TEXEL1 then falls back to the reference's magenta
        stub (rt64_shader.cpp:484-487)."""
        self._alt_texture = texture
        self.desc.alt_texture = texture

    def destroy(self):
        self.scene.instances.remove(self)


class View:
    """RT64_CreateView / SetViewPerspective / SetViewDescription /
    SetViewSkyPlane / GetViewRaytracedInstanceAt
    (rt64_view.cpp:2086-2201).

    Holds camera + view configuration; rendering delegates to
    pipeline/view.py and pipeline/framegraph.py.
    """

    def __init__(self, scene: Scene, width: int = 640, height: int = 480):
        self.scene = scene
        self.width = width
        self.height = height
        self.desc = d.ViewDesc()
        self.view_matrix = np.eye(4, dtype=np.float32)
        self.fov_radians = 0.75
        self.near_dist = 0.1
        self.far_dist = 1000.0
        self.can_reproject = True
        self.sky_plane_texture: Optional[Texture] = None
        self.frame_count = 0
        self.max_reflections = 2  # rt64_view.cpp:60
        self.pipelined_present = False  # True: present frame N-1
        self.visualization_mode = d.VISUALIZATION_MODE_FINAL
        self._renderer = None
        self._framebuffer: Optional[np.ndarray] = None
        scene.views.append(self)

    def set_perspective(
        self, view_matrix, fov_radians: float, near_dist: float, far_dist: float,
        can_reproject: bool = True,
    ):
        """SetViewPerspective (rt64_view.cpp:1749-1767)."""
        self.view_matrix = np.asarray(view_matrix, np.float32).reshape(4, 4)
        self.fov_radians = float(fov_radians)
        self.near_dist = float(near_dist)
        self.far_dist = float(far_dist)
        self.can_reproject = bool(can_reproject)

    def set_description(self, desc: d.ViewDesc):
        self.desc = desc

    def set_sky_plane(self, texture: Optional[Texture]):
        self.sky_plane_texture = texture

    def update(self):
        from rt64tpu_torch.pipeline.view import ViewRenderer

        if self._renderer is None:
            self._renderer = ViewRenderer(self, pipelined=self.pipelined_present)
        self._renderer.update()

    def render(self, delta_time_ms: float):
        self._renderer.render(delta_time_ms)
        self.frame_count += 1

    def framebuffer(self) -> np.ndarray:
        """Final (H, W, 4) uint8 frame — the backbuffer analog."""
        if self._framebuffer is None:
            return np.zeros((self.height, self.width, 4), np.uint8)
        return self._framebuffer

    def get_raytraced_instance_at(self, x: int, y: int) -> Optional[Instance]:
        """GetViewRaytracedInstanceAt (rt64_view.cpp:1932-1998). The
        instance-id plane is read back on demand, at most once per
        presented frame (rt64_view.cpp:1946-1981)."""
        if self._renderer is None:
            return None
        inst_plane = self._renderer.instance_plane()
        if inst_plane is None:
            return None
        rh, rw = inst_plane.shape
        rx = min(int(x * rw / self.width), rw - 1)
        ry = min(int(y * rh / self.height), rh - 1)
        idx = int(inst_plane[ry, rx])
        active = self._renderer.active_instances
        if 0 <= idx < len(active):
            return active[idx]
        return None

    def get_view_position(self) -> np.ndarray:
        """View::getViewPosition: camera world position."""
        return np.linalg.inv(self.view_matrix)[3, :3].astype(np.float32)

    def get_view_direction(self) -> np.ndarray:
        """View::getViewDirection: camera forward (-z row of viewI)."""
        dvec = -np.linalg.inv(self.view_matrix)[2, :3]
        return (dvec / np.linalg.norm(dvec)).astype(np.float32)

    def get_ray_direction_at(self, px: float, py: float) -> np.ndarray:
        """View::getRayDirectionAt (rt64_view.cpp:1923-1930): cursor
        pixel -> normalized world ray. Like the reference, the
        unprojected far-plane target is NOT perspective-divided before
        the w=0 view transform."""
        x = ((px + 0.5) / self.width) * 2.0 - 1.0
        y = ((py + 0.5) / self.height) * 2.0 - 1.0
        proj = math3d.perspective_fov_rh(
            self.fov_radians, self.width / self.height,
            self.near_dist, self.far_dist,
        )
        target = np.array([x, -y, 1.0, 1.0], np.float32) @ np.linalg.inv(proj)
        view_i = np.linalg.inv(self.view_matrix)
        dvec = target[:3] @ view_i[:3, :3]
        return (dvec / np.linalg.norm(dvec)).astype(np.float32)

    def move_perspective(self, local_movement):
        """Free-camera translate (rt64_view.cpp:1769-1773): offset in
        view-local axes applied to the view matrix."""
        vi = np.linalg.inv(self.view_matrix)
        offset = math3d.transform_dirs(
            np.asarray(local_movement, np.float32), vi
        )
        self.view_matrix = (
            np.linalg.inv(math3d.translation(*offset)) @ self.view_matrix
        ).astype(np.float32)

    def rotate_perspective(self, local_yaw: float, local_pitch: float,
                           local_roll: float = 0.0):
        """Free-camera rotate (rt64_view.cpp:1775-1782): look-at rebuilt
        from a rotated far-plane focus point."""
        import math as _m

        vi = np.linalg.inv(self.view_matrix)
        pos = math3d.transform_points(np.zeros(3, np.float32), vi)
        focus = np.array([0.0, 0.0, -self.far_dist], np.float32)
        cy, sy = _m.cos(local_yaw), _m.sin(local_yaw)
        cp, sp = _m.cos(local_pitch), _m.sin(local_pitch)
        # yaw about y then pitch about x (XMMatrixRotationRollPitchYaw order)
        fx = focus[0] * cy + focus[2] * sy
        fz = -focus[0] * sy + focus[2] * cy
        fy = focus[1] * cp - fz * sp
        fz = focus[1] * sp + fz * cp
        focus_w = math3d.transform_points(
            np.array([fx, fy, fz], np.float32), vi
        )
        self.view_matrix = math3d.look_at_rh(pos, focus_w, (0.0, 1.0, 0.0))

    def get_upscaler_support(self, upscaler: int) -> bool:
        """GetViewUpscalerSupport: every slot renders (models/)."""
        return upscaler in (
            d.UPSCALER_OFF, d.UPSCALER_AUTO, d.UPSCALER_DLSS, d.UPSCALER_FSR,
            d.UPSCALER_XESS,
        )


# Packed light layout (columns), matching LightInfo (Lights.hlsli:9-19):
# 0:3 position, 3:6 diffuse, 6 attenuationRadius, 7 pointRadius,
# 8:11 specular, 11 shadowOffset, 12 attenuationExponent,
# 13 flickerIntensity. group_bits ride a separate int array.
LIGHT_WIDTH = 14


def pack_lights(lights: List[d.Light]):
    """Returns (floats (N, LIGHT_WIDTH), group_bits (N,) uint32)."""
    arr = np.zeros((len(lights), LIGHT_WIDTH), np.float32)
    groups = np.zeros(len(lights), np.uint32)
    for i, l in enumerate(lights):
        arr[i, 0:3] = l.position
        arr[i, 3:6] = l.diffuse_color
        arr[i, 6] = l.attenuation_radius
        arr[i, 7] = l.point_radius
        arr[i, 8:11] = l.specular_color
        arr[i, 11] = l.shadow_offset
        arr[i, 12] = l.attenuation_exponent
        arr[i, 13] = l.flicker_intensity
        groups[i] = np.uint32(l.group_bits & 0xFFFFFFFF)
    return arr, groups
