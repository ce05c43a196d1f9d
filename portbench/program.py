"""The system under test, driven as a game drives it: the scene pushed
through rt64tpu_torch's public object model, then per frame the walk's
pushes (every instance re-set with its previous transform kept, the
character's mesh re-uploaded, the lights re-set where the mix re-sends
them, the camera re-pushed), Device.draw() and
the presented frame read back through View.framebuffer().

After the window, `outputs` copies to the host what the check compares:
the presented frame and the display image before it, the instance and
position planes of the frame on screen, and its render-size frame.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from portbench import scene as sc

UPSCALERS = {"off": 0x0, "dlss": 0x2, "fsr": 0x3}
MODES = {"auto": 0x0, "performance": 0x2}


def _interleave(mesh: sc.MeshData) -> np.ndarray:
    """RT64's vertex layout for the mesh's shader (rt64_shader.cpp:80-96):
    position float4, normal float3, then the uv float2 for a shader that
    samples a texture, or the vertex colour float3 (INPUT_1) for the
    colour shader, the one that draws a mesh with a colour."""
    n = mesh.positions.shape[0]
    cols = [mesh.positions, np.ones((n, 1), np.float32), mesh.normals]
    if mesh.color is None:
        cols.append(mesh.uvs)
    else:
        cols.append(np.tile(np.float32(mesh.color), (n, 1)))
    return np.ascontiguousarray(np.concatenate(cols, 1), np.float32)


@dataclasses.dataclass
class Program:
    dev: object
    scene: object
    view: object
    data: sc.SceneData
    instances: list  # api.Instance, in SceneData order
    meshes: dict  # name -> api.Mesh
    textures: dict  # name -> api.Texture
    shaders: dict  # SceneData shader kind -> api.Shader

    @property
    def renderer(self):
        return self.view._renderer


def scene_limits(data: sc.SceneData, cfg: dict):
    """The Device's capacity buckets: the configuration's, grown to hold
    the scene's vertices, triangles, instances and lights."""
    from rt64tpu_torch.limits import SceneLimits

    verts = sum(data.meshes[i.mesh].positions.shape[0] for i in data.instances)
    return SceneLimits(
        max_vertices=1 << 15, max_triangles=int(cfg["scene"]["max_triangles"]),
        max_instances=128, max_textures=16, texel_pool=1 << 18,
        alpha_triangles=256,
    ).grown_for(vertices=verts, triangles=data.triangles(),
                instances=len(data.instances), lights=len(data.lights))


def build(data: sc.SceneData, cfg: dict, device=None) -> Program:
    """The scene pushed into a new Device. cfg: the configuration."""
    import rt64tpu_torch as rt
    from rt64tpu_torch import descriptors as d
    from rt64tpu_torch.utils.testscenes import shader_id

    dev = rt.Device(scene_limits(data, cfg), device=device)
    scene = rt.Scene(dev)
    view = rt.View(scene, width=cfg["display"][0], height=cfg["display"][1])
    tex = {name: rt.Texture(dev, d.TextureDesc(
        bytes=img.tobytes(), format=d.TEXTURE_FORMAT_RGBA8,
        width=img.shape[1], height=img.shape[0]))
        for name, img in data.textures.items()}
    addr = {"wrap": d.SHADER_ADDRESSING_WRAP, "clamp": d.SHADER_ADDRESSING_CLAMP}
    a = {k: addr[v] for k, v in sc.ADDRESSING.items()}
    shaders = {
        "texture": rt.Shader(
            dev, shader_id((0, 0, 0, d.MATERIAL_CC_SHADER_TEXEL0)),
            filter=d.SHADER_FILTER_LINEAR, h_addr=a["texture"],
            v_addr=a["texture"], flags=d.SHADER_RAYTRACE_ENABLED),
        "leaf": rt.Shader(
            dev, shader_id((0, 0, 0, d.MATERIAL_CC_SHADER_TEXEL0),
                           opt_alpha=True, texture_edge=True),
            filter=d.SHADER_FILTER_LINEAR, h_addr=a["leaf"],
            v_addr=a["leaf"], flags=d.SHADER_RAYTRACE_ENABLED),
        "color": rt.Shader(
            dev, shader_id((0, 0, 0, d.MATERIAL_CC_SHADER_INPUT_1)),
            flags=d.SHADER_RAYTRACE_ENABLED),
    }
    meshes = {}
    for name, m in data.meshes.items():
        mesh = rt.Mesh(dev, d.MESH_RAYTRACE_ENABLED)
        raw = _interleave(m)
        mesh.set_mesh(raw, raw.shape[0], raw.shape[1] * 4, m.indices)
        meshes[name] = mesh
    instances = []
    for inst in data.instances:
        obj = rt.Instance(scene)
        obj.set_description(_desc(d, inst, meshes, tex, shaders,
                                  inst.transform, inst.transform))
        instances.append(obj)
    view.set_sky_plane(tex["sky"])
    scene.set_lights([d.Light(**light) for light in data.lights])
    scene.set_description(d.SceneDesc(**data.scene_desc))
    view.set_description(d.ViewDesc(
        di_samples=int(cfg["di_samples"]), gi_samples=int(cfg["gi_samples"]),
        max_lights=int(cfg["max_lights"]), denoiser_enabled=bool(cfg["denoiser"]),
        upscaler=UPSCALERS[cfg["upscaler"]],
        upscaler_mode=MODES[cfg["upscaler_mode"]]))
    view.max_reflections = int(cfg["max_reflections"])
    return Program(dev, scene, view, data, instances, meshes, tex, shaders)


def _desc(d, inst: sc.InstanceData, meshes, tex, shaders, transform,
          previous):
    material = d.Material(**inst.material)
    return d.InstanceDesc(
        mesh=meshes[inst.mesh], transform=transform,
        previous_transform=previous,
        diffuse_texture=tex[inst.texture] if inst.texture else None,
        shader=shaders[inst.shader], material=material,
        flags=d.INSTANCE_DISABLE_BACKFACE_CULLING if inst.no_cull else 0)


def push(prog: Program, state, camera: dict):
    """One frame's pushes: every instance re-set (its previous transform
    kept), the character re-uploaded, the lights re-set where the mix
    re-sends them, the camera re-pushed."""
    from rt64tpu_torch import descriptors as d

    raw = _interleave(state.character)
    prog.meshes["character"].set_mesh(raw, raw.shape[0], raw.shape[1] * 4,
                                      state.character.indices)
    for obj, inst, tf, prev in zip(prog.instances, prog.data.instances,
                                   state.transforms, state.previous):
        obj.set_description(_desc(d, inst, prog.meshes, prog.textures,
                                  prog.shaders, tf, prev))
    if state.resend_lights:
        prog.scene.set_lights([d.Light(**light) for light in state.lights])
    prog.view.set_perspective(state.view_matrix,
                              math.radians(camera["fov_deg"]),
                              camera["near"], camera["far"], True)


def draw(prog: Program) -> np.ndarray:
    """Device.draw() in full sync, then the presented RGB8 frame."""
    prog.dev.draw()
    return prog.view.framebuffer()


# The port's ray order: 8x64-pixel tiles, each contiguous, where the
# render size divides into them; else row-major.
TILE_H, TILE_W = 8, 64


def untile(plane, width: int, height: int) -> np.ndarray:
    """A (C, N) plane in the port's ray order as a (C, H, W) image."""
    a = plane.float().cpu().numpy()
    c = a.shape[0]
    if width % TILE_W or height % TILE_H:
        return a.reshape(c, height, width)
    return (a.reshape(c, height // TILE_H, width // TILE_W, TILE_H, TILE_W)
            .transpose(0, 1, 3, 2, 4).reshape(c, height, width))


def outputs(prog: Program) -> dict:
    """Host copies of what the check compares, from the frame on screen:
    the presented frame, the instance plane (picking's, public), and what
    the port keeps on its renderer with no public accessor yet: the
    render-size frame and hit positions (`_last`), and the display image
    presented before (`_prev_image`, before its RGB8 packing: the FSR
    slot's history; the read-back clips it at 1, the history does not).
    instance: (H, W) int64 index into SceneData.instances, -1 none."""
    r = prog.renderer
    out, cfg = r._last, r._last_cfg
    ids = {id(obj): k for k, obj in enumerate(prog.instances)}
    table = np.array([ids[id(a)] for a in r.active_instances] + [-1], np.int64)
    plane = r.instance_plane().astype(np.int64)
    w, h = cfg.rt_width, cfg.rt_height
    return dict(
        framebuffer=prog.view.framebuffer()[..., :3].copy(),
        previous=(None if r._prev_image is None
                  else r._prev_image.float().cpu().numpy()),
        instance=table[np.where(plane >= 0, plane, -1)],
        position=untile(out.gbuffers.position, w, h),
        rt_output=out.rt_output.float().cpu().numpy(),
        render=(w, h),
    )
