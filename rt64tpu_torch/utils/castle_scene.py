"""Castle-grounds-analog benchmark scene.

The BASELINE north star measures the SM64 castle grounds; the actual
game assets can't ship here, so this builds a procedural stand-in with
the same workload shape: ~16k triangles of rolling terrain, a castle
block with towers, a reflective moat, dozens of alpha-tested
(texture-edge) foliage billboards, multiple textures/samplers, a sky
plane, and two light groups — exercising every pipeline path (opaque
bulk, alpha any-hit, reflection, fog, GI) at representative scale.
"""

from __future__ import annotations

import numpy as np

import rt64tpu_torch
from rt64tpu_torch import descriptors as d
from rt64tpu_torch.limits import SceneLimits
from rt64tpu_torch.ops import math3d
from rt64tpu_torch.utils.testscenes import interleave, shader_id, sky_texture


def _grass_texture(device, size=64):
    rng = np.random.default_rng(5)
    noise = rng.random((size, size, 1)).astype(np.float32)
    img = np.zeros((size, size, 4), np.float32)
    img[..., 0] = 0.18 + 0.15 * noise[..., 0]
    img[..., 1] = 0.45 + 0.25 * noise[..., 0]
    img[..., 2] = 0.12 + 0.08 * noise[..., 0]
    img[..., 3] = 1.0
    data = np.clip(img * 255, 0, 255).astype(np.uint8)
    return rt64tpu_torch.Texture(device, d.TextureDesc(
        bytes=data.tobytes(), format=d.TEXTURE_FORMAT_RGBA8,
        width=size, height=size))


def _brick_texture(device, size=64):
    yy, xx = np.mgrid[0:size, 0:size]
    mortar = ((yy % 16) < 2) | (((xx + (yy // 16) * 8) % 32) < 2)
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 0] = np.where(mortar, 150, 180)
    img[..., 1] = np.where(mortar, 150, 172)
    img[..., 2] = np.where(mortar, 150, 160)
    img[..., 3] = 255
    return rt64tpu_torch.Texture(device, d.TextureDesc(
        bytes=img.tobytes(), format=d.TEXTURE_FORMAT_RGBA8,
        width=size, height=size))


def _leaf_texture(device, size=64):
    """Alpha-tested foliage blob (texture-edge workload)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cx = cy = size / 2
    r = np.hypot(xx - cx, yy - cy) / (size / 2)
    rng = np.random.default_rng(7)
    lobes = 0.75 + 0.25 * np.sin(np.arctan2(yy - cy, xx - cx) * 5.0)
    alpha = (r < lobes * 0.9).astype(np.float32)
    img = np.zeros((size, size, 4), np.float32)
    img[..., 0] = 0.1 + 0.1 * rng.random((size, size))
    img[..., 1] = 0.4 + 0.3 * rng.random((size, size))
    img[..., 2] = 0.1
    img[..., 3] = alpha
    data = np.clip(img * 255, 0, 255).astype(np.uint8)
    return rt64tpu_torch.Texture(device, d.TextureDesc(
        bytes=data.tobytes(), format=d.TEXTURE_FORMAT_RGBA8,
        width=size, height=size))


def _terrain(n=48, extent=80.0, rng=None):
    """Heightfield terrain: (verts, indices) with uvs."""
    rng = rng or np.random.default_rng(3)
    freq = rng.normal(0, 1, (4, 2))
    phase = rng.uniform(0, np.pi, 4)
    xs = np.linspace(-extent, extent, n)
    zs = np.linspace(-extent, extent, n)
    vs = []
    for z in zs:
        for x in xs:
            h = sum(
                1.1 * np.sin(0.06 * (x * freq[i, 0] + z * freq[i, 1]) + phase[i])
                for i in range(4)
            )
            # Flatten near the castle.
            h *= np.clip((np.hypot(x, z) - 12.0) / 30.0, 0.0, 1.0)
            vs.append(((x, h, z), (0, 1, 0), (x / 12.0, z / 12.0)))
    idx = []
    for r in range(n - 1):
        for c in range(n - 1):
            a = r * n + c
            idx += [a, a + n, a + 1, a + 1, a + n, a + n + 1]
    return vs, np.array(idx, np.uint32)


def _box(cx, cy, cz, sx, sy, sz):
    """Axis-aligned box (verts with outward normals + uvs, CCW-front)."""
    vs, idx = [], []
    faces = [
        ((1, 0, 0), (0, 0, 1), (0, 1, 0)),
        ((-1, 0, 0), (0, 0, -1), (0, 1, 0)),
        ((0, 1, 0), (1, 0, 0), (0, 0, 1)),
        ((0, -1, 0), (1, 0, 0), (0, 0, -1)),
        ((0, 0, 1), (-1, 0, 0), (0, 1, 0)),
        ((0, 0, -1), (1, 0, 0), (0, 1, 0)),
    ]
    half = np.array([sx, sy, sz]) / 2.0
    center = np.array([cx, cy, cz])
    for nrm, ax_u, ax_v in faces:
        nrm = np.array(nrm, np.float64)
        u = np.array(ax_u, np.float64)
        v = np.array(ax_v, np.float64)
        base = len(vs)
        for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            p = center + (nrm + u * su + v * sv) * half
            vs.append((p, nrm, ((su + 1), (sv + 1))))
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return vs, idx


def build_castle_scene(width=320, height=240, di_samples=1, gi_samples=1,
                       denoiser=False, foliage=48, device=None,
                       terrain_n=48):
    """The castle-grounds workload; device: the torch device to render
    on (None: the CUDA card). terrain_n: terrain grid vertices per side;
    48 is the benchmark scene (16,384-triangle bucket), 128 the large
    scene (2 x 127^2 terrain triangles, 32,768-triangle bucket), which
    lies beyond the packet tracer's size switch."""
    # Terrain + castle (6 boxes) + moat + foliage (4 triangles each).
    triangles = 2 * (terrain_n - 1) ** 2 + 6 * 12 + 2 + 4 * foliage
    vertices = terrain_n ** 2 + 6 * 24 + 4 + 8
    limits = SceneLimits(
        max_vertices=1 << 15, max_triangles=1 << 14, max_instances=128,
        max_textures=16, texel_pool=1 << 18, alpha_triangles=256,
    ).grown_for(vertices=vertices, triangles=triangles)
    device = rt64tpu_torch.Device(limits, device=device)
    scene = rt64tpu_torch.Scene(device)
    view = rt64tpu_torch.View(scene, width=width, height=height)

    grass = _grass_texture(device)
    brick = _brick_texture(device)
    leaf = _leaf_texture(device)
    skytex = sky_texture(device)

    tex_shader = rt64tpu_torch.Shader(
        device, shader_id((0, 0, 0, d.MATERIAL_CC_SHADER_TEXEL0)),
        filter=d.SHADER_FILTER_LINEAR, h_addr=d.SHADER_ADDRESSING_WRAP,
        v_addr=d.SHADER_ADDRESSING_WRAP, flags=d.SHADER_RAYTRACE_ENABLED,
    )
    # Foliage: TEXEL0 with opt_alpha + texture_edge (alpha-tested).
    leaf_shader = rt64tpu_torch.Shader(
        device,
        shader_id((0, 0, 0, d.MATERIAL_CC_SHADER_TEXEL0), opt_alpha=True,
                  texture_edge=True),
        filter=d.SHADER_FILTER_LINEAR, h_addr=d.SHADER_ADDRESSING_CLAMP,
        v_addr=d.SHADER_ADDRESSING_CLAMP, flags=d.SHADER_RAYTRACE_ENABLED,
    )
    color_shader = rt64tpu_torch.Shader(
        device, shader_id((0, 0, 0, d.MATERIAL_CC_SHADER_INPUT_1)),
        flags=d.SHADER_RAYTRACE_ENABLED,
    )

    rng = np.random.default_rng(11)

    # Terrain (~4.4k tris at terrain_n = 48).
    tvs, tidx = _terrain(n=terrain_n, rng=rng)
    tmesh = rt64tpu_torch.Mesh(device, d.MESH_RAYTRACE_ENABLED)
    tdata = interleave(tvs, with_uv=True)
    tmesh.set_mesh(tdata, len(tvs), tdata.shape[1] * 4, tidx)
    terrain = rt64tpu_torch.Instance(scene)
    terrain.set_description(d.InstanceDesc(
        mesh=tmesh, transform=np.eye(4, dtype=np.float32),
        diffuse_texture=grass, shader=tex_shader,
        material=d.Material(fog_enabled=1, fog_color=(0.6, 0.7, 0.9),
                            fog_mul=180.0, fog_offset=30.0),
    ))

    # Castle: keep + four towers (boxes).
    cvs, cidx = [], []
    for box in (
        _box(0, 5, -20, 20, 10, 14),
        _box(-11, 9, -20, 4, 18, 4),
        _box(11, 9, -20, 4, 18, 4),
        _box(-11, 9, -12, 4, 18, 4),
        _box(11, 9, -12, 4, 18, 4),
        _box(0, 8, -16, 6, 16, 6),
    ):
        bvs, bidx = box
        cidx += [i + len(cvs) for i in bidx]
        cvs += bvs
    cmesh = rt64tpu_torch.Mesh(device, d.MESH_RAYTRACE_ENABLED)
    cdata = interleave(cvs, with_uv=True)
    cmesh.set_mesh(cdata, len(cvs), cdata.shape[1] * 4,
                   np.array(cidx, np.uint32))
    castle = rt64tpu_torch.Instance(scene)
    castle.set_description(d.InstanceDesc(
        mesh=cmesh, transform=np.eye(4, dtype=np.float32),
        diffuse_texture=brick, shader=tex_shader, material=d.Material(),
    ))

    # Moat: a reflective quad strip in front of the castle.
    mvs = [
        ((-26, 0.05, 2), (0, 1, 0), (0, 0)),
        ((26, 0.05, 2), (0, 1, 0), (6, 0)),
        ((26, 0.05, 12), (0, 1, 0), (6, 2)),
        ((-26, 0.05, 12), (0, 1, 0), (0, 2)),
    ]
    midx = np.array([0, 2, 1, 0, 3, 2], np.uint32)
    mmesh = rt64tpu_torch.Mesh(device, d.MESH_RAYTRACE_ENABLED)
    mdata = interleave(mvs, input_color=(0.25, 0.3, 0.42), with_uv=True)
    mmesh.set_mesh(mdata, 4, mdata.shape[1] * 4, midx)
    moat = rt64tpu_torch.Instance(scene)
    moat.set_description(d.InstanceDesc(
        mesh=mmesh, transform=np.eye(4, dtype=np.float32),
        shader=color_shader,
        material=d.Material(reflection_factor=0.5,
                            reflection_fresnel_factor=0.3),
    ))

    # Foliage billboards: crossed quads, alpha-tested (opt texture edge).
    fvs = []
    fidx = []
    for plane in range(2):
        base = len(fvs)
        rot = plane * np.pi / 2
        u = np.array([np.cos(rot), 0, np.sin(rot)])
        for su, sv, tu, tv in ((-1, 0, 0, 1), (1, 0, 1, 1), (1, 2, 1, 0),
                               (-1, 2, 0, 0)):
            p = u * su * 1.6 + np.array([0, sv * 1.6, 0])
            fvs.append((p, (0, 1, 0), (tu, tv)))
        fidx += [base, base + 1, base + 2, base, base + 2, base + 3]
    fmesh = rt64tpu_torch.Mesh(device, d.MESH_RAYTRACE_ENABLED)
    fdata = interleave(fvs, with_uv=True)
    fmesh.set_mesh(fdata, len(fvs), fdata.shape[1] * 4,
                   np.array(fidx, np.uint32))
    for _ in range(foliage):
        x = rng.uniform(-60, 60)
        z = rng.uniform(-50, 60)
        if abs(x) < 26 and -30 < z < 14:
            continue  # keep the castle courtyard clear
        inst = rt64tpu_torch.Instance(scene)
        inst.set_description(d.InstanceDesc(
            mesh=fmesh, transform=math3d.translation(x, 0.0, z),
            diffuse_texture=leaf, shader=leaf_shader,
            material=d.Material(),
            flags=d.INSTANCE_DISABLE_BACKFACE_CULLING,
        ))

    view.set_sky_plane(skytex)
    scene.set_lights([
        d.Light(position=(60.0, 90.0, 40.0), diffuse_color=(0.95, 0.9, 0.8),
                attenuation_radius=1e5, point_radius=4.0,
                specular_color=(0.5, 0.5, 0.45), attenuation_exponent=1.0,
                group_bits=d.LIGHT_GROUP_DEFAULT),
        d.Light(position=(0.0, 6.0, -16.0), diffuse_color=(1.0, 0.7, 0.3),
                attenuation_radius=40.0, point_radius=0.5,
                attenuation_exponent=1.5, flicker_intensity=0.15,
                group_bits=0x2),
    ])
    scene.set_description(d.SceneDesc(
        ambient_base_color=(0.22, 0.24, 0.3),
        gi_diffuse_strength=0.7, gi_sky_strength=0.35,
    ))

    vm = math3d.look_at_rh((0.0, 6.0, 40.0), (0.0, 4.0, -10.0), (0.0, 1.0, 0.0))
    view.set_perspective(vm, 45.0 * np.pi / 180.0, 0.1, 1000.0, True)
    view.set_description(d.ViewDesc(
        di_samples=di_samples, gi_samples=gi_samples, max_lights=8,
        denoiser_enabled=denoiser,
    ))
    return device, scene, view
