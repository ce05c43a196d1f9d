"""Host-side object model mirroring the RT64 C ABI.

One class per opaque handle of the reference ABI (public/rt64.h:88-96):
Device, Scene, View, Mesh, Texture, Shader, Instance, Inspector. Methods
map onto the exported C symbols; the reference analog is cited inline.

The device is headless: a frame renders into a retained numpy RGBA
buffer (`View.framebuffer()`); presentation is the host's business.
Scene state lives as torch tensors on the Device's torch device, which
is the CUDA card unless the caller asks for the CPU.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from rt64tpu_torch import descriptors as d
from rt64tpu_torch.devices import indexed
from rt64tpu_torch.limits import SceneLimits
from rt64tpu_torch.ops import math3d
from rt64tpu_torch.ops.combiner import CombinerParams, decode_combiner
from rt64tpu_torch.utils import profiling


def resolve_device(device=None) -> torch.device:
    """`None` means the current CUDA card; anything else is taken as
    given. A card is named by its index (devices.indexed)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rt64tpu_torch renders on a CUDA device and none is "
                "available; pass device='cpu' to run the plain-torch path"
            )
        device = "cuda"
    return indexed(device)


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
        self.inspector: Optional[Inspector] = None
        self.frame_count = 0
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
        with profiling.span("rt64.draw"), self._lock:
            for scene in self.scenes:
                scene.update()
            for scene in self.scenes:
                scene.render(delta_time_ms)
            if self.inspector is not None:
                self.inspector.render()
            self.frame_count += 1
        profiling.count_frame()

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
        with profiling.span("rt64.api.set_mesh"):
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

    RGBA8 payloads are stored as (H, W, 4) uint8; DDS payloads are
    BC-decompressed on the host on load (utils/assets.py, the
    DDSTextureLoader analog). Atlas placement happens at scene assembly.
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
            from rt64tpu_torch.utils.assets import decode_dds

            self.rgba = decode_dds(bytes(desc.bytes))
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
        with profiling.span("rt64.scene.update"):
            for view in self.views:
                view.update()

    def render(self, delta_time_ms: float):
        """Scene::render (rt64_scene.cpp:64-72)."""
        with profiling.span("rt64.scene.render"):
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
        with profiling.span("rt64.api.set_instance"):
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
        self.pipelined_present = False  # True: present frame N-2 (the ring)
        self.visualization_mode = d.VISUALIZATION_MODE_FINAL
        self._renderer = None
        self._framebuffer: Optional[np.ndarray] = None
        scene.views.append(self)

    def set_perspective(
        self, view_matrix, fov_radians: float, near_dist: float, far_dist: float,
        can_reproject: bool = True,
    ):
        """SetViewPerspective (rt64_view.cpp:1749-1767)."""
        with profiling.span("rt64.api.set_view"):
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


class Inspector:
    """RT64_CreateInspector / PrintMessageInspector / Set*Inspector
    (rt64_inspector.cpp:469-515).

    Headless observability surface: live parameter handles, the print
    console, and frame dumping. The ImGui/Im3d panels become dict-based
    parameter access plus the 17 visualization modes already wired
    through ViewDesc / View.visualization_mode. Device.draw calls
    render() after the scenes have drawn.
    """

    def __init__(self, device: Device):
        self.device = device
        self.messages: List[str] = []
        self.scene_desc_ref: Optional[d.SceneDesc] = None
        self.material_ref: Optional[d.Material] = None
        self.material_name = ""
        self.lights_ref = None
        self.dump_path: Optional[str] = None
        self.show_light_gizmos = False  # Im3d light spheres analog
        self._dump_index = 0
        self._gizmo_drag = None  # active light-gizmo drag state
        device.inspector = self

    def set_scene(self, scene_desc: d.SceneDesc):
        self.scene_desc_ref = scene_desc

    def set_material(self, material: d.Material, name: str):
        self.material_ref = material
        self.material_name = name

    def set_lights(self, lights, light_count: int, max_light_count: int):
        self.lights_ref = (lights, light_count, max_light_count)

    def print_clear(self):
        self.messages.clear()

    def print_message(self, message: str):
        self.messages.append(message)

    # -- live parameter editing (the ImGui-panel analog) --------------------
    #
    # The reference's inspector panels mutate the registered view/scene/
    # material/light state in place (rt64_inspector.cpp:115-353); the
    # headless analog is a small textual command protocol applied to the
    # same registered refs. Commands (whitespace-separated):
    #
    #   get <ns>.<field>                 -> current value
    #   set <ns>.<field> <v> [v2 v3 v4]  -> assign (tuples space-separated)
    #   list <ns>                        -> field names
    #   camera move <dx> <dy> <dz>       -> View.move_perspective
    #   camera rotate <yaw> <pitch>      -> View.rotate_perspective
    #   gizmos on|off / dump <path>|off / print <msg>
    #   gizmo press|drag <x> <y> / gizmo release   (interactive light
    #       gizmos — see _gizmo_command below)
    #
    # Namespaces: material (set_material ref), scene (set_scene ref),
    # light.<i> (set_lights ref), view (every view's live params).
    # Edits land in the registered objects — for ABI hosts those are
    # ctypes proxies over HOST memory, so the next frame's descriptor
    # push picks them up exactly like the reference's in-place panels.

    # View-level attributes; everything else under view.* resolves into
    # the per-frame ViewDesc (resolution_scale, di/gi_samples, max_lights,
    # motion_blur_strength, upscaler, upscaler_mode, upscaler_sharpness,
    # denoiser_enabled) — the same split as RT64_VIEW_DESC vs View state.
    _VIEW_ATTRS = ("max_reflections", "visualization_mode",
                   "pipelined_present", "can_reproject")

    def command(self, cmd: str) -> str:
        try:
            return self._command(cmd)
        except Exception as exc:  # noqa: BLE001 — boundary surface
            return f"ERR {exc}"

    def _views(self):
        return [v for s in self.device.scenes for v in s.views]

    def _resolve(self, path: str):
        """path 'ns.field' or 'light.N.field' -> (obj, field)."""
        parts = path.split(".")
        ns = parts[0]
        if ns == "material":
            if self.material_ref is None:
                raise ValueError("no material registered")
            return self.material_ref, parts[1]
        if ns == "scene":
            if self.scene_desc_ref is None:
                raise ValueError("no scene desc registered")
            return self.scene_desc_ref, parts[1]
        if ns == "light":
            if self.lights_ref is None:
                raise ValueError("no lights registered")
            lights, count, _ = self.lights_ref
            i = int(parts[1])
            if not 0 <= i < count:
                raise ValueError(f"light index {i} out of range {count}")
            return lights[i], parts[2]
        if ns == "view":
            views = self._views()
            if not views:
                raise ValueError("no views")
            field = parts[1]
            if field in self._VIEW_ATTRS:
                return views, field  # list marker: apply to all
            import dataclasses as _dc

            if field in {f.name for f in _dc.fields(views[0].desc)}:
                return [v.desc for v in views], field
            raise ValueError(f"unknown view field {field}")
        raise ValueError(f"unknown namespace {ns}")

    @staticmethod
    def _fmt(val) -> str:
        if isinstance(val, (tuple, list)):
            return " ".join(f"{v:g}" if isinstance(v, float) else str(v)
                            for v in val)
        if isinstance(val, float):
            return f"{val:g}"
        if isinstance(val, bool):
            return "1" if val else "0"
        return str(val)

    @staticmethod
    def _parse(old, args):
        def one(ref, s):
            if isinstance(ref, bool):
                return s.lower() in ("1", "true", "on", "yes")
            if isinstance(ref, int):
                return int(s, 0)
            return float(s)

        if isinstance(old, (tuple, list)):
            if len(args) != len(old):
                raise ValueError(f"expected {len(old)} values")
            return tuple(one(o, a) for o, a in zip(old, args))
        if len(args) != 1:
            raise ValueError("expected 1 value")
        return one(old, args[0])

    def _command(self, cmd: str) -> str:
        toks = cmd.strip().split()
        if not toks:
            return "ERR empty command"
        op = toks[0].lower()
        if op == "print":
            self.print_message(cmd.split(None, 1)[1] if len(toks) > 1 else "")
            return "OK"
        if op == "gizmos":
            self.show_light_gizmos = len(toks) > 1 and toks[1] == "on"
            return "OK"
        if op == "gizmo":
            return self._gizmo_command(toks[1:])
        if op == "dump":
            self.dump_path = None if (len(toks) < 2 or toks[1] == "off") else toks[1]
            return "OK"
        if op == "camera":
            views = self._views()
            if toks[1] == "move":
                delta = tuple(float(t) for t in toks[2:5])
                for v in views:
                    v.move_perspective(delta)
            elif toks[1] == "rotate":
                yaw, pitch = float(toks[2]), float(toks[3])
                for v in views:
                    v.rotate_perspective(yaw, pitch)
            else:
                raise ValueError(f"unknown camera op {toks[1]}")
            return "OK"
        if op == "list":
            ns = toks[1]
            if ns == "view":
                import dataclasses as _dc

                views = self._views()
                desc_fields = (
                    [f.name for f in _dc.fields(views[0].desc)] if views else []
                )
                return " ".join(list(self._VIEW_ATTRS) + desc_fields)
            probe = {"material": self.material_ref,
                     "scene": self.scene_desc_ref}.get(ns)
            if ns == "light":
                probe = self.lights_ref[0][0] if self.lights_ref else None
            if probe is None:
                raise ValueError(f"nothing registered for {ns}")
            import dataclasses as _dc

            if _dc.is_dataclass(probe):
                return " ".join(f.name for f in _dc.fields(probe))
            return " ".join(getattr(probe, "field_names", lambda: [])())
        if op in ("get", "set"):
            obj, field = self._resolve(toks[1])
            targets = obj if isinstance(obj, list) else [obj]
            if op == "get":
                return self._fmt(getattr(targets[0], field))
            old = getattr(targets[0], field)
            val = self._parse(old, toks[2:])
            for t in targets:
                setattr(t, field, val)
            return "OK"
        raise ValueError(f"unknown op {op}")

    # -- interactive light gizmos (Im3d::GizmoTranslation analog) ------------
    #
    # The reference's light editor attaches a translation gizmo to each
    # light, driven by the cursor ray Im3d builds in setupWithView
    # (rt64_inspector.cpp:324, 417-436). The headless analog is three
    # commands a host feeds through RT64_HandleMessageInspector exactly
    # like forwarded mouse messages:
    #
    #   gizmo press <x> <y>   -> pick the light whose gizmo sphere the
    #                            cursor ray hits; reply "OK <i>"/"MISS"
    #   gizmo drag  <x> <y>   -> translate the picked light in the
    #                            camera-facing plane through its grab
    #                            point (Im3d's center-ball drag);
    #                            reply "OK <x> <y> <z>"
    #   gizmo release         -> drop the selection
    #
    # Edits write through the registered light refs (ctypes proxies for
    # ABI hosts), so the host's next setLights push renders the move —
    # the same in-place mutation as Im3d writing &lights[i].position.x.
    GIZMO_PICK_PIXELS = 8.0  # handle radius on screen, Im3d-style

    def _gizmo_pick_radius(self, light, depth: float, view: "View") -> float:
        """Gizmo handles keep constant SCREEN size (Im3d scales by
        m_projScaleY * depth); pick radius is that handle size or the
        light's point sphere, whichever is larger."""
        import math as _m

        world_per_px = (
            2.0 * _m.tan(view.fov_radians * 0.5) * max(depth, 1e-6)
            / view.height
        )
        return max(float(light.point_radius),
                   self.GIZMO_PICK_PIXELS * world_per_px)

    def _gizmo_command(self, toks) -> str:
        views = self._views()
        if not views:
            raise ValueError("no views")
        view = views[0]
        if not toks:
            raise ValueError("gizmo press|drag|release")
        sub = toks[0]
        if sub == "release":
            self._gizmo_drag = None
            return "OK"
        if self.lights_ref is None:
            raise ValueError("no lights registered")
        lights, count, _ = self.lights_ref
        x, y = float(toks[1]), float(toks[2])
        eye = view.get_view_position()
        ray = view.get_ray_direction_at(x, y)
        if sub == "press":
            best = None
            for i in range(count):
                c = np.asarray(lights[i].position, np.float32)
                oc = c - eye
                t = float(np.dot(oc, ray))  # closest approach along ray
                if t <= 0.0:
                    continue
                miss2 = float(np.dot(oc, oc)) - t * t
                r = self._gizmo_pick_radius(lights[i], t, view)
                if miss2 <= r * r and (best is None or t < best[1]):
                    best = (i, t)
            if best is None:
                self._gizmo_drag = None
                return "MISS"
            i, t = best
            grab = eye + ray * t
            self._gizmo_drag = {
                "light": i,
                "grab": grab,
                # Drag plane faces the camera through the grab point
                # (Im3d center-ball translation).
                "normal": view.get_view_direction(),
            }
            return f"OK {i}"
        if sub == "drag":
            if self._gizmo_drag is None:
                return "MISS"
            st = self._gizmo_drag
            denom = float(np.dot(ray, st["normal"]))
            if abs(denom) < 1e-8:
                return "MISS"
            t = float(np.dot(st["grab"] - eye, st["normal"])) / denom
            if t <= 0.0:
                return "MISS"
            new_grab = eye + ray * t
            delta = new_grab - st["grab"]
            li = lights[st["light"]]
            li.position = tuple(
                float(p) + float(dd)
                for p, dd in zip(li.position, delta)
            )
            st["grab"] = new_grab
            return "OK " + self._fmt(li.position)
        raise ValueError(f"unknown gizmo op {sub}")

    def render(self):
        if self.show_light_gizmos:
            for scene in self.device.scenes:
                for view in scene.views:
                    self._draw_light_gizmos(scene, view)
        if self.dump_path:
            from rt64tpu_torch.utils.assets import write_png

            for scene in self.device.scenes:
                for view in scene.views:
                    write_png(
                        f"{self.dump_path}/frame_{self._dump_index:05d}.png",
                        view.framebuffer(),
                    )
            self._dump_index += 1

    def _draw_light_gizmos(self, scene: "Scene", view: "View"):
        """Im3d light-sphere gizmo analog (rt64_inspector.cpp:311-353):
        overlays a ring at each light's projected position on the
        retained framebuffer (debug path, host-side).

        Occlusion dither (Im3DPS.hlsl:9-26): where the scene's primary
        hit lies closer than the gizmo, only every other checkerboard
        pixel draws, at half opacity — the gizmo reads as 'behind'
        without a depth buffer blend."""
        fb = view._framebuffer
        if fb is None:
            return
        h, w = fb.shape[:2]
        proj = math3d.perspective_fov_rh(
            view.fov_radians, w / h, view.near_dist, view.far_dist
        )
        vp = view.view_matrix @ proj
        eye = np.linalg.inv(view.view_matrix.astype(np.float64))[3, :3]

        # Scene hit distance per rt pixel (inf at misses), read from the
        # presented frame's planes (the gHitDistAndFlow read of
        # Im3DPS.hlsl:13): the frame on screen, also when the present
        # ring trails the draws.
        occl = None
        rt_h = rt_w = 0
        r = view._renderer
        src = r._pick_src if r is not None else None
        if src is not None:
            from rt64tpu_torch.pipeline import framegraph as fg

            pick, cfg = src
            pos = fg.to_image(cfg, pick.position).cpu().numpy()
            inst = fg.to_image(cfg, pick.instance).cpu().numpy()
            dist = np.linalg.norm(
                pos.transpose(1, 2, 0) - eye[None, None, :], axis=-1
            )
            occl = np.where(inst >= 0, dist, np.inf)
            rt_h, rt_w = occl.shape

        for light in scene.lights:
            clip = math3d.transform_points_h(
                np.asarray(light.position, np.float32), vp
            )
            if clip[3] <= 0:
                continue
            sx = int((0.5 + 0.5 * clip[0] / clip[3]) * w)
            sy = int((0.5 - 0.5 * clip[1] / clip[3]) * h)
            if not (0 <= sx < w and 0 <= sy < h):
                continue
            color = np.clip(
                np.asarray(light.diffuse_color) * 255 + 64, 0, 255
            ).astype(np.uint8)
            rad = 5
            yy, xx = np.mgrid[-rad : rad + 1, -rad : rad + 1]
            ring = np.abs(np.hypot(xx, yy) - rad) < 1.0
            ys = np.clip(sy + yy[ring], 0, h - 1)
            xs = np.clip(sx + xx[ring], 0, w - 1)
            if occl is not None:
                gizmo_dist = float(np.linalg.norm(
                    np.asarray(light.position, np.float64) - eye
                ))
                oy = np.clip(ys * rt_h // h, 0, rt_h - 1)
                ox = np.clip(xs * rt_w // w, 0, rt_w - 1)
                occluded = occl[oy, ox] < gizmo_dist
                # clip(fmod(x + y, 2) - 1): only odd-parity pixels
                # survive when occluded, at alpha 0.5.
                keep = ~occluded | (((xs + ys) % 2) == 1)
                alpha = np.where(occluded, 0.5, 1.0)[keep, None]
                ys_k, xs_k = ys[keep], xs[keep]
                fb[ys_k, xs_k, :3] = (
                    fb[ys_k, xs_k, :3] * (1.0 - alpha) + color * alpha
                ).astype(np.uint8)
            else:
                fb[ys, xs, :3] = color


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
