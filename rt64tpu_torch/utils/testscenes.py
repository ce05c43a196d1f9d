"""Procedural test scenes mirroring the reference sample app.

The reference's runtime smoke test (src/sample/main.cpp:201-412) builds
a UV sphere + floor + HUD triangles with DDS/PNG textures, a sky plane,
and one sun light. These builders create equivalent scenes procedurally
(no external assets) for tests, benches, and golden frames.
"""

from __future__ import annotations

import numpy as np

import rt64tpu_torch
from rt64tpu_torch import descriptors as d
from rt64tpu_torch.limits import SceneLimits
from rt64tpu_torch.ops import math3d


def checker_texture(device, size=64, c0=(255, 255, 255), c1=(40, 40, 48), cell=8):
    img = np.zeros((size, size, 4), np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    mask = ((xx // cell + yy // cell) % 2).astype(bool)
    img[~mask, :3] = c0
    img[mask, :3] = c1
    img[..., 3] = 255
    return rt64tpu_torch.Texture(
        device,
        d.TextureDesc(bytes=img.tobytes(), format=d.TEXTURE_FORMAT_RGBA8,
                      width=size, height=size),
    )


def sky_texture(device, w=256, h=128):
    """Gradient sky with a sun blob, RGBA."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    t = yy / h
    img = np.zeros((h, w, 4), np.float32)
    img[..., 0] = 0.35 + 0.45 * t
    img[..., 1] = 0.55 + 0.30 * t
    img[..., 2] = 0.95 - 0.15 * t
    sun = np.exp(-(((xx - w * 0.3) ** 2 + (yy - h * 0.25) ** 2) / (h * 0.08) ** 2))
    img[..., :3] += sun[..., None] * np.array([1.5, 1.3, 0.9])
    img[..., 3] = 1.0
    data = np.clip(img * 255, 0, 255).astype(np.uint8)
    return rt64tpu_torch.Texture(
        device,
        d.TextureDesc(bytes=data.tobytes(), format=d.TEXTURE_FORMAT_RGBA8,
                      width=w, height=h),
    )


_DDS_BLOCK_BYTES = {b"DXT1": 8, b"DXT3": 16, b"DXT5": 16}


def dds_file(fourcc: bytes, width: int, height: int, seed: int,
             bc1_punch=None) -> bytes:
    """A DDS file of random BC blocks (fourcc DXT1, DXT3 or DXT5) made
    from `seed` with numpy. bc1_punch (DXT1 only): True orders every
    block's end points c0 <= c1 (three colours and transparent black),
    False c0 > c1 (four opaque colours), None leaves them random."""
    rng = np.random.default_rng(seed)
    n = ((width + 3) // 4) * ((height + 3) // 4)
    blocks = rng.integers(0, 256, (n, _DDS_BLOCK_BYTES[fourcc]), np.uint8)
    if bc1_punch is not None:
        ends = blocks[:, :4].copy().view(np.uint16)
        lo, hi = ends.min(1), ends.max(1)
        hi = np.where(lo == hi, hi | 1, hi)
        lo = np.where(lo == hi, lo & 0xFFFE, lo)
        pair = (lo, hi) if bc1_punch else (hi, lo)
        blocks[:, :4] = np.stack(pair, 1).astype(np.uint16).view(np.uint8)
    header = np.zeros(32, np.uint32)  # magic + the 124-byte header
    header[0] = 0x20534444  # 'DDS '
    header[1] = 124
    header[2] = 0x1007  # caps, height, width, pixel format
    header[3], header[4] = height, width
    header[19] = 32  # pixel format size
    header[20] = 0x4  # DDPF_FOURCC
    header[21] = int.from_bytes(fourcc, "little")
    return header.tobytes() + blocks.tobytes()


def dds_texture(device, fourcc=b"DXT1", size=32, seed=0, bc1_punch=None):
    """A Texture from dds_file (size x size)."""
    data = dds_file(fourcc, size, size, seed, bc1_punch)
    return rt64tpu_torch.Texture(device, d.TextureDesc(
        bytes=data, byte_count=len(data), format=d.TEXTURE_FORMAT_DDS))


def uv_sphere(radius=1.0, rings=16, sectors=24):
    """Vertices (pos3, nrm3, uv2) + CCW-front indices."""
    vs, idx = [], []
    for r in range(rings + 1):
        phi = np.pi * r / rings
        for s in range(sectors + 1):
            theta = 2 * np.pi * s / sectors
            n = np.array(
                [np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)]
            )
            vs.append((n * radius, n, (s / sectors, r / rings)))
    cols = sectors + 1
    for r in range(rings):
        for s in range(sectors):
            a = r * cols + s
            b = a + cols
            idx += [a, a + 1, b, a + 1, b + 1, b]
    return vs, np.array(idx, np.uint32)


def interleave(vs, input_color=None, use_alpha=False, with_uv=True):
    """Pack (pos, nrm, uv) tuples into the reference vertex layout
    (VertexLayout, rt64_shader.cpp:80-96): pos float4, nrm float3,
    [uv float2], [input float3/4]."""
    rows = []
    for p, n, uv in vs:
        row = list(np.asarray(p, np.float64)) + [1.0] + list(np.asarray(n, np.float64))
        if with_uv:
            row += list(uv)
        if input_color is not None:
            row += list(input_color[: 4 if use_alpha else 3])
        rows.append(row)
    return np.array(rows, np.float32)


# Combiner ids. Bits: c[0][i] at i*3, c[1][i] at 12+i*3
# (rt64_shader.cpp:44-48).
def shader_id(color_cycle, alpha_cycle=None, opt_alpha=False,
              texture_edge=False, noise=False):
    alpha_cycle = alpha_cycle or color_cycle
    sid = 0
    for i, v in enumerate(color_cycle):
        sid |= (v & 7) << (i * 3)
    for i, v in enumerate(alpha_cycle):
        sid |= (v & 7) << (12 + i * 3)
    if opt_alpha:
        sid |= 1 << 24
    if texture_edge:
        sid |= 1 << 26
    if noise:
        sid |= 1 << 27
    return sid


SID_VERTEX_COLOR = shader_id((0, 0, 0, d.MATERIAL_CC_SHADER_INPUT_1))
SID_TEXTURE = shader_id((0, 0, 0, d.MATERIAL_CC_SHADER_TEXEL0))
SID_TEX_TIMES_INPUT = shader_id(
    (d.MATERIAL_CC_SHADER_TEXEL0, 0, d.MATERIAL_CC_SHADER_INPUT_1, 0)
)
# The sample app's sphere shader (main.cpp:216): 0x01200a00 decodes to
# color = TEXEL0 * INPUT_1(? per N64 encoding); we reuse it verbatim.
SID_SAMPLE_SPHERE = 0x01200A00


def hud_triangle(scene, device, color=(1.0, 0.2, 0.2, 0.8), background=False):
    """A clip-space raster triangle (HUD/bg quad analog,
    main.cpp:356-374). Vertex layout: pos4 + nrm3 + input1 rgba
    (opt_alpha combiner)."""
    sid = shader_id((0, 0, 0, d.MATERIAL_CC_SHADER_INPUT_1), opt_alpha=True)
    sh = rt64tpu_torch.Shader(device, sid, flags=d.SHADER_RASTER_ENABLED)
    if background:
        verts = [(-1, -1), (3, -1), (-1, 3)]  # covers the whole screen
    else:
        verts = [(-0.95, 0.95), (-0.55, 0.95), (-0.75, 0.55)]
    rows = []
    for x, y in verts:
        rows.append([x, y, 0.5, 1.0, 0, 0, 1] + list(color))
    data = np.array(rows, np.float32)
    mesh = rt64tpu_torch.Mesh(device, 0)
    mesh.set_mesh(data, 3, data.shape[1] * 4, np.array([0, 1, 2], np.uint32))
    inst = rt64tpu_torch.Instance(scene)
    inst.set_description(d.InstanceDesc(
        mesh=mesh, shader=sh, material=d.Material(),
        flags=d.INSTANCE_RASTER_BACKGROUND if background else 0,
    ))
    return inst


def raster_layers(scene, device, hud_quads=12, background=True):
    """A game's raster layers over a scene: with background, a
    full-screen two-triangle skybox textured with sky_texture (an
    INSTANCE_RASTER_BACKGROUND instance), and a HUD of hud_quads
    textured quads (2 triangles each; checker_texture at alpha 0.85) in
    one foreground instance, laid along the screen edges. Returns the
    instances (background first)."""
    out = []
    if background:
        sh = rt64tpu_torch.Shader(
            device, SID_TEXTURE, filter=d.SHADER_FILTER_LINEAR,
            h_addr=d.SHADER_ADDRESSING_CLAMP, v_addr=d.SHADER_ADDRESSING_CLAMP,
            flags=d.SHADER_RASTER_ENABLED)
        # Clip-space corners (y up) with v = 0 at the top of the screen.
        vs = [((-1, -1, 0.5), (0, 0, 1), (0, 1)), ((1, -1, 0.5), (0, 0, 1), (1, 1)),
              ((1, 1, 0.5), (0, 0, 1), (1, 0)), ((-1, 1, 0.5), (0, 0, 1), (0, 0))]
        data = interleave(vs, with_uv=True)
        mesh = rt64tpu_torch.Mesh(device, 0)
        mesh.set_mesh(data, 4, data.shape[1] * 4,
                      np.array([0, 1, 2, 0, 2, 3], np.uint32))
        inst = rt64tpu_torch.Instance(scene)
        inst.set_description(d.InstanceDesc(
            mesh=mesh, shader=sh, material=d.Material(),
            diffuse_texture=sky_texture(device),
            flags=d.INSTANCE_RASTER_BACKGROUND))
        out.append(inst)
    if hud_quads:
        sid = shader_id((0, 0, 0, d.MATERIAL_CC_SHADER_TEXEL0),
                        (0, 0, 0, d.MATERIAL_CC_SHADER_INPUT_1), opt_alpha=True)
        sh = rt64tpu_torch.Shader(device, sid, filter=d.SHADER_FILTER_POINT,
                                  h_addr=d.SHADER_ADDRESSING_WRAP,
                                  v_addr=d.SHADER_ADDRESSING_WRAP,
                                  flags=d.SHADER_RASTER_ENABLED)
        # Quads go round the edges: top, bottom, left, right, then the
        # next slot along each edge.
        per_edge = -(-hud_quads // 4)
        qw, qh = 0.16, 0.10
        vs, idx = [], []
        for i in range(hud_quads):
            side, slot = i % 4, i // 4
            t = (slot + 0.5) / per_edge
            if side < 2:
                x0 = -0.8 + 1.6 * t - qw / 2
                y0 = 0.84 if side == 0 else -0.94
            else:
                x0 = -0.96 if side == 2 else 0.8
                y0 = 0.6 - 1.2 * t - qh / 2
            base = len(vs)
            for (x, y), uv in zip(((x0, y0), (x0 + qw, y0), (x0 + qw, y0 + qh),
                                   (x0, y0 + qh)),
                                  ((0, 1), (2, 1), (2, 0), (0, 0))):
                vs.append(((x, y, 0.5), (0, 0, 1), uv))
            idx += [base, base + 1, base + 2, base, base + 2, base + 3]
        data = interleave(vs, input_color=(1.0, 1.0, 1.0, 0.85),
                          use_alpha=True, with_uv=True)
        mesh = rt64tpu_torch.Mesh(device, 0)
        mesh.set_mesh(data, len(vs), data.shape[1] * 4, np.array(idx, np.uint32))
        inst = rt64tpu_torch.Instance(scene)
        inst.set_description(d.InstanceDesc(
            mesh=mesh, shader=sh, material=d.Material(),
            diffuse_texture=checker_texture(device, size=32, cell=4)))
        out.append(inst)
    return out


def build_sample_scene(width=320, height=240, limits=None, di_samples=1,
                       gi_samples=1, denoiser=False, upscaler=d.UPSCALER_OFF,
                       sphere_reflection=0.3, with_glass=False, device=None):
    """Sphere + floor + sky + sun — the src/sample/main.cpp analog.

    with_glass adds a refractive (glass) sphere and an alpha-blended
    quad so every static feature path — refraction, lit-transparent,
    compacted alpha — is live. device: the torch device to render on
    (None: the CUDA card)."""
    limits = limits or SceneLimits(
        max_vertices=2048, max_triangles=2048, max_instances=8,
        max_textures=8, texel_pool=1 << 17,
    )
    device = rt64tpu_torch.Device(limits, device=device)
    scene = rt64tpu_torch.Scene(device)
    view = rt64tpu_torch.View(scene, width=width, height=height)

    checker = checker_texture(device)
    skytex = sky_texture(device)

    tex_shader = rt64tpu_torch.Shader(
        device, SID_TEXTURE, filter=d.SHADER_FILTER_LINEAR,
        h_addr=d.SHADER_ADDRESSING_WRAP, v_addr=d.SHADER_ADDRESSING_WRAP,
        flags=d.SHADER_RAYTRACE_ENABLED,
    )
    color_shader = rt64tpu_torch.Shader(device, SID_VERTEX_COLOR,
                                  flags=d.SHADER_RAYTRACE_ENABLED)

    # Sphere.
    vs, idx = uv_sphere(radius=1.5, rings=24, sectors=32)
    sphere_mesh = rt64tpu_torch.Mesh(
        device, d.MESH_RAYTRACE_ENABLED | d.MESH_RAYTRACE_FAST_TRACE
    )
    data = interleave(vs, with_uv=True)
    sphere_mesh.set_mesh(data, len(vs), data.shape[1] * 4, idx)
    sphere = rt64tpu_torch.Instance(scene)
    sphere_mat = d.Material(
        specular_color=(1.0, 1.0, 1.0), specular_exponent=25.0,
        reflection_factor=sphere_reflection, reflection_fresnel_factor=0.4,
    )
    sphere.set_description(d.InstanceDesc(
        mesh=sphere_mesh, transform=math3d.translation(0.0, 1.5, 0.0),
        diffuse_texture=checker, shader=tex_shader, material=sphere_mat,
    ))

    # Floor (vertex colors).
    fv = [
        ((-8, 0, -8), (0, 1, 0), (0, 0)),
        ((8, 0, -8), (0, 1, 0), (4, 0)),
        ((8, 0, 8), (0, 1, 0), (4, 4)),
        ((-8, 0, 8), (0, 1, 0), (0, 4)),
    ]
    fidx = np.array([0, 2, 1, 0, 3, 2], np.uint32)
    floor_mesh = rt64tpu_torch.Mesh(
        device, d.MESH_RAYTRACE_ENABLED | d.MESH_RAYTRACE_UPDATABLE
    )
    fdata = interleave(fv, input_color=(0.75, 0.72, 0.70), with_uv=True)
    floor_mesh.set_mesh(fdata, 4, fdata.shape[1] * 4, fidx)
    floor = rt64tpu_torch.Instance(scene)
    floor.set_description(d.InstanceDesc(
        mesh=floor_mesh, transform=np.eye(4, dtype=np.float32),
        shader=color_shader, material=d.Material(),
    ))

    if with_glass:
        gvs, gidx = uv_sphere(radius=0.8, rings=12, sectors=16)
        glass_mesh = rt64tpu_torch.Mesh(
            device, d.MESH_RAYTRACE_ENABLED | d.MESH_RAYTRACE_FAST_TRACE
        )
        gdata = interleave(gvs, input_color=(0.9, 0.95, 1.0), with_uv=True)
        glass_mesh.set_mesh(gdata, len(gvs), gdata.shape[1] * 4, gidx)
        glass = rt64tpu_torch.Instance(scene)
        glass.set_description(d.InstanceDesc(
            mesh=glass_mesh,
            transform=math3d.translation(2.5, 0.9, 1.5),
            shader=color_shader,
            material=d.Material(refraction_factor=1.2),
        ))
        # Alpha-blended quad: lit-transparent + compacted-alpha paths.
        av = [
            ((-1.5, 0.0, 3.5), (0, 0, 1), (0, 0)),
            ((1.5, 0.0, 3.5), (0, 0, 1), (1, 0)),
            ((1.5, 2.5, 3.5), (0, 0, 1), (1, 1)),
            ((-1.5, 2.5, 3.5), (0, 0, 1), (0, 1)),
        ]
        aidx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
        amesh = rt64tpu_torch.Mesh(device, d.MESH_RAYTRACE_ENABLED)
        adata = interleave(av, input_color=(0.4, 0.8, 0.9), with_uv=True)
        amesh.set_mesh(adata, 4, adata.shape[1] * 4, aidx)
        aq = rt64tpu_torch.Instance(scene)
        aq.set_description(d.InstanceDesc(
            mesh=amesh, transform=np.eye(4, dtype=np.float32),
            shader=color_shader,
            material=d.Material(solid_alpha_multiplier=0.45),
        ))

    view.set_sky_plane(skytex)
    scene.set_lights([
        d.Light(position=(15.0, 20.0, 8.0), diffuse_color=(0.9, 0.85, 0.75),
                attenuation_radius=1e4, point_radius=1.5,
                specular_color=(0.7, 0.65, 0.6), attenuation_exponent=1.0),
    ])
    scene.set_description(d.SceneDesc(
        ambient_base_color=(0.25, 0.25, 0.3),
        gi_diffuse_strength=0.7, gi_sky_strength=0.35,
    ))

    vm = math3d.look_at_rh((0.0, 3.0, 9.0), (0.0, 1.2, 0.0), (0.0, 1.0, 0.0))
    view.set_perspective(vm, 45.0 * np.pi / 180.0, 0.1, 1000.0)
    view.set_description(d.ViewDesc(
        di_samples=di_samples, gi_samples=gi_samples, max_lights=4,
        denoiser_enabled=denoiser, upscaler=upscaler,
    ))
    return device, scene, view


def make_glass_translucent(scene, alpha=0.5):
    """Let the glass sphere of a with_glass sample scene (its instance 2)
    pass 1 - alpha of its light. A refractive surface seeds refraction
    only with the alpha it lets through (PrimaryRayGen.hlsl:156-161), so
    the opaque glass of the stock scene leaves every refraction ray dead.
    Works on either package's scene objects."""
    glass = scene.instances[2].desc.material
    if glass.refraction_factor <= 0.0:
        raise ValueError("instance 2 is not the glass sphere")
    glass.solid_alpha_multiplier = alpha


def build_mip_floor(mip_enabled, width=128, height=96, device=None):
    """A minification scene for ray-differential mip LOD: a floor running
    to the horizon under a 1-texel checker tiled 64x, so its far rows
    cover hundreds of texels per pixel. mip_enabled sets
    SHADER_MIP_LOD_ENABLED on its shader. device: as for
    build_sample_scene. Returns (device, scene, view); draw to render."""
    limits = SceneLimits(
        max_vertices=64, max_triangles=16, max_instances=2,
        max_textures=4, texel_pool=1 << 16,
    )
    device = rt64tpu_torch.Device(limits, device=device)
    scene = rt64tpu_torch.Scene(device)
    view = rt64tpu_torch.View(scene, width=width, height=height)

    checker = checker_texture(device, size=64, cell=1)
    flags = d.SHADER_RAYTRACE_ENABLED
    if mip_enabled:
        flags |= d.SHADER_MIP_LOD_ENABLED
    shader = rt64tpu_torch.Shader(
        device, SID_TEXTURE, filter=d.SHADER_FILTER_LINEAR,
        h_addr=d.SHADER_ADDRESSING_WRAP, v_addr=d.SHADER_ADDRESSING_WRAP,
        flags=flags,
    )
    fv = [
        ((-40, 0, -400), (0, 1, 0), (0, 0)),
        ((40, 0, -400), (0, 1, 0), (64, 0)),
        ((40, 0, 0), (0, 1, 0), (64, 64)),
        ((-40, 0, 0), (0, 1, 0), (0, 64)),
    ]
    fidx = np.array([0, 2, 1, 0, 3, 2], np.uint32)
    mesh = rt64tpu_torch.Mesh(device, d.MESH_RAYTRACE_ENABLED)
    fdata = interleave(fv, with_uv=True)
    mesh.set_mesh(fdata, 4, fdata.shape[1] * 4, fidx)
    inst = rt64tpu_torch.Instance(scene)
    inst.set_description(d.InstanceDesc(
        mesh=mesh, transform=np.eye(4, dtype=np.float32),
        diffuse_texture=checker, shader=shader, material=d.Material(),
    ))
    sd = scene.desc
    sd.ambient_base_color = (1.0, 1.0, 1.0)  # pure texture
    scene.set_description(sd)
    # Camera 1.5 up, looking slightly down along -z toward the horizon.
    vm = math3d.look_at_rh((0.0, 1.5, 4.0), (0.0, 0.6, -20.0), (0.0, 1.0, 0.0))
    view.set_perspective(vm, 0.9, 0.1, 1000.0)
    return device, scene, view
