"""The castle grounds the benchmark draws, made from a seed as plain numpy
data: meshes in object space, instances, textures, lights. The program
side (program.py) pushes it through the port's public API; the
reference (reference.py) reads it as it is. Nothing here imports the
port.

A seeded rewrite of the port's procedural stand-in for the SM64 castle
grounds (the game's assets cannot ship): rolling terrain on a
terrain_n x terrain_n grid, a keep with four towers, a reflective moat,
crossed-quad foliage billboards that are alpha-tested (TEXEL0 alpha,
texture edge), a sky plane, two lights, and a character mesh that the
traffic re-poses every frame. The seed moves the textures' noise; the
terrain, the billboards' places and the counts of triangles, instances
and textures are the same for every seed (the traffic draws the rest
from it).

A configuration may add a field of point lights after the two
(`point_lights`, see point_light_field) and give the instances of a mesh
a light group mask (`light_masks`: mesh name -> RT64's
light_group_mask_bits), so that a light lights only the materials whose
mask shares a bit with its group bits. Their places and draws come from
a fixed seed too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

TERRAIN_EXTENT = 80.0
# Castle: keep, four towers and the central tower (centre, size). No two
# boxes share a face plane where both show: a tie between coplanar
# triangles has no one right answer.
CASTLE_BOXES = (
    ((0, 5, -20), (20, 10, 14)),
    ((-11, 9, -20), (4, 18, 4)),
    ((11, 9, -20), (4, 18, 4)),
    ((-11, 9, -12), (4, 18, 4)),
    ((11, 9, -12), (4, 18, 4)),
    ((0, 8, -16.5), (6, 16, 6)),
)
FOLIAGE_SIZE = 1.6
LEAF_TEXELS = 64
# The seeds of the terrain's waves and of the billboards' places: the
# same for every run. They set how many alpha-tested hits a view holds,
# and so the work and the memory of the alpha path.
TERRAIN_SHAPE, FOLIAGE_PLACES = 3, 11
# The seed of the point lights' places and draws: the same for every run,
# so that every seed's views light the same places.
POINT_LIGHT_PLACES = 17
# The alpha test of a texture-edge combiner keeps a hit whose texel
# alpha is above this (the port's shading.py; rt64_shader.cpp).
TEXTURE_EDGE_ALPHA = 0.3


@dataclasses.dataclass
class MeshData:
    positions: np.ndarray  # (V, 3) f32, object space
    normals: np.ndarray  # (V, 3) f32
    uvs: np.ndarray  # (V, 2) f32
    indices: np.ndarray  # (T, 3) int32
    color: Optional[tuple] = None  # a vertex colour (INPUT_1) if any


# Each shader's texture addressing, bilinear at level 0 ("color" samples
# none).
ADDRESSING = {"texture": "wrap", "leaf": "clamp"}
# RT64_MATERIAL's defaults (rt64.h), the fields the frame reads.
MATERIAL_DEFAULTS = dict(
    ignore_normal_factor=0.0, reflection_factor=0.0,
    reflection_fresnel_factor=0.0, reflection_shine_factor=0.0,
    specular_color=(1.0, 1.0, 1.0), specular_exponent=5.0,
    shadow_ray_bias=0.0, self_light=(0.0, 0.0, 0.0),
    light_group_mask_bits=0xFFFFFFFF, fog_color=(1.0, 1.0, 1.0), fog_mul=0.0,
    fog_offset=0.0, fog_enabled=0,
)
FOG = dict(fog_enabled=1, fog_color=(0.6, 0.7, 0.9), fog_mul=180.0,
           fog_offset=30.0)
MIRROR = dict(reflection_factor=0.5, reflection_fresnel_factor=0.3)


@dataclasses.dataclass
class InstanceData:
    mesh: str
    transform: np.ndarray  # (4, 4) f32, row vectors: world = [p, 1] @ M
    shader: str  # "texture", "leaf" (alpha-tested) or "color"
    texture: Optional[str]
    no_cull: bool = False
    material: dict = dataclasses.field(default_factory=dict)  # overrides


def material(inst: InstanceData) -> dict:
    """The instance's material: RT64's defaults under its overrides."""
    return dict(MATERIAL_DEFAULTS, **inst.material)


@dataclasses.dataclass
class SceneData:
    meshes: Dict[str, MeshData]
    textures: Dict[str, np.ndarray]  # (H, W, 4) uint8
    instances: List[InstanceData]
    lights: list  # dicts of api Light fields
    foliage: List[int]  # instance indices of the billboards
    scene_desc: dict  # api SceneDesc fields

    @property
    def ambient(self):
        return tuple(a + b for a, b in zip(
            self.scene_desc["ambient_base_color"],
            self.scene_desc.get("ambient_no_gi_color", (0.0, 0.0, 0.0))))

    @property
    def gi_diffuse_strength(self) -> float:
        return self.scene_desc["gi_diffuse_strength"]

    @property
    def gi_sky_strength(self) -> float:
        return self.scene_desc["gi_sky_strength"]

    def triangles(self) -> int:
        return sum(self.meshes[i.mesh].indices.shape[0] for i in self.instances)


def terrain_height(x, z):
    """The terrain's height field at world x, z (arrays or floats): the
    heights its grid's vertices take."""
    rng = np.random.default_rng(TERRAIN_SHAPE)
    freq = rng.normal(0, 1, (4, 2))
    phase = rng.uniform(0, np.pi, 4)
    h = sum(1.1 * np.sin(0.06 * (x * freq[i, 0] + z * freq[i, 1]) + phase[i])
            for i in range(4))
    return h * np.clip((np.hypot(x, z) - 12.0) / 30.0, 0.0, 1.0)


def _terrain(n: int) -> MeshData:
    xs = np.linspace(-TERRAIN_EXTENT, TERRAIN_EXTENT, n)
    x, z = np.meshgrid(xs, xs)  # z rows, x columns
    h = terrain_height(x, z)
    pos = np.stack([x, h, z], -1).reshape(-1, 3)
    nrm = np.tile(np.array([0.0, 1.0, 0.0]), (n * n, 1))
    uv = np.stack([x / 12.0, z / 12.0], -1).reshape(-1, 2)
    r, c = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (r * n + c).reshape(-1)
    idx = np.stack([a, a + n, a + 1, a + 1, a + n, a + n + 1], -1)
    return MeshData(pos.astype(np.float32), nrm.astype(np.float32),
                    uv.astype(np.float32), idx.reshape(-1, 3).astype(np.int32))


def _boxes() -> MeshData:
    faces = (
        ((1, 0, 0), (0, 0, 1), (0, 1, 0)),
        ((-1, 0, 0), (0, 0, -1), (0, 1, 0)),
        ((0, 1, 0), (1, 0, 0), (0, 0, 1)),
        ((0, -1, 0), (1, 0, 0), (0, 0, -1)),
        ((0, 0, 1), (-1, 0, 0), (0, 1, 0)),
        ((0, 0, -1), (1, 0, 0), (0, 1, 0)),
    )
    pos, nrm, uv, idx = [], [], [], []
    for center, size in CASTLE_BOXES:
        half = np.array(size, np.float64) / 2.0
        for n, u, v in faces:
            n, u, v = (np.array(a, np.float64) for a in (n, u, v))
            base = len(pos)
            for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                pos.append(np.array(center) + (n + u * su + v * sv) * half)
                nrm.append(n)
                uv.append((su + 1, sv + 1))
            # Wound so that the geometric normal cross(p1 - p0, p2 - p0)
            # is the face's outward normal: the side that is drawn.
            idx += [(base, base + 2, base + 1), (base, base + 3, base + 2)]
    return MeshData(np.array(pos, np.float32), np.array(nrm, np.float32),
                    np.array(uv, np.float32), np.array(idx, np.int32))


def _moat() -> MeshData:
    pos = np.array([(-26, 0.05, 2), (26, 0.05, 2), (26, 0.05, 12),
                    (-26, 0.05, 12)], np.float32)
    return MeshData(pos, np.tile(np.float32([0, 1, 0]), (4, 1)),
                    np.array([(0, 0), (6, 0), (6, 2), (0, 2)], np.float32),
                    np.array([(0, 2, 1), (0, 3, 2)], np.int32),
                    color=(0.25, 0.3, 0.42))


def _billboard() -> MeshData:
    pos, uv, idx = [], [], []
    for plane in range(2):
        base = len(pos)
        rot = plane * np.pi / 2
        u = np.array([np.cos(rot), 0, np.sin(rot)])
        for su, sv, tu, tv in ((-1, 0, 0, 1), (1, 0, 1, 1), (1, 2, 1, 0),
                               (-1, 2, 0, 0)):
            pos.append(u * su * FOLIAGE_SIZE + np.array([0, sv * FOLIAGE_SIZE, 0]))
            uv.append((tu, tv))
        idx += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    return MeshData(np.array(pos, np.float32),
                    np.tile(np.float32([0, 1, 0]), (len(pos), 1)),
                    np.array(uv, np.float32), np.array(idx, np.int32))


def character_mesh(rings: int, segments: int, height: float, radius: float,
                   bend: float) -> MeshData:
    """A tube of `rings` x `segments` quads (2 * rings * segments
    triangles), `height` tall, its radius swelling at the torso and its
    axis bent sideways by `bend` at the top: the pose the traffic
    changes every frame. Front faces outwards."""
    ys = np.linspace(0.0, height, rings + 1)
    s = ys / height
    rad = radius * (0.55 + 0.45 * np.sin(np.pi * np.clip(s * 1.15, 0, 1)))
    ang = np.arange(segments) * (2 * np.pi / segments)
    off = bend * s * s
    ca, sa = np.cos(ang), np.sin(ang)
    x = off[:, None] + rad[:, None] * ca[None]
    z = rad[:, None] * sa[None]
    y = np.broadcast_to(ys[:, None], x.shape)
    pos = np.stack([x, y, z], -1).reshape(-1, 3)
    nrm = np.stack([np.broadcast_to(ca, x.shape), np.zeros_like(x),
                    np.broadcast_to(sa, x.shape)], -1).reshape(-1, 3)
    uv = np.stack([np.broadcast_to(ang[None] / (2 * np.pi), x.shape),
                   np.broadcast_to(s[:, None], x.shape)], -1).reshape(-1, 2)
    r, c = np.meshgrid(np.arange(rings), np.arange(segments), indexing="ij")
    a = r * segments + c
    b = r * segments + (c + 1) % segments
    # Each quad (a, b) below, (a', b') above: wound so that the
    # geometric normal -cross(p2 - p0, p1 - p0) points outwards.
    idx = np.stack([a, a + segments, b, b, a + segments, b + segments], -1)
    return MeshData(pos.astype(np.float32), nrm.astype(np.float32),
                    uv.astype(np.float32), idx.reshape(-1, 3).astype(np.int32))


def leaf_texture(rng) -> np.ndarray:
    size = LEAF_TEXELS
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    c = size / 2
    r = np.hypot(xx - c, yy - c) / c
    lobes = 0.75 + 0.25 * np.sin(np.arctan2(yy - c, xx - c) * 5.0)
    img = np.zeros((size, size, 4), np.float32)
    img[..., 0] = 0.1 + 0.1 * rng.random((size, size))
    img[..., 1] = 0.4 + 0.3 * rng.random((size, size))
    img[..., 2] = 0.1
    img[..., 3] = (r < lobes * 0.9)
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def _grass_texture(rng, size=64) -> np.ndarray:
    noise = rng.random((size, size))
    img = np.stack([0.18 + 0.15 * noise, 0.45 + 0.25 * noise,
                    0.12 + 0.08 * noise, np.ones_like(noise)], -1)
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def _brick_texture(size=64) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size]
    mortar = ((yy % 16) < 2) | (((xx + (yy // 16) * 8) % 32) < 2)
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 0] = np.where(mortar, 150, 180)
    img[..., 1] = np.where(mortar, 150, 172)
    img[..., 2] = np.where(mortar, 150, 160)
    img[..., 3] = 255
    return img


def sky_texture(w=256, h=128) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    t = yy / h
    img = np.zeros((h, w, 4), np.float32)
    img[..., 0] = 0.35 + 0.45 * t
    img[..., 1] = 0.55 + 0.30 * t
    img[..., 2] = 0.95 - 0.15 * t
    sun = np.exp(-(((xx - w * 0.3) ** 2 + (yy - h * 0.25) ** 2) / (h * 0.08) ** 2))
    img[..., :3] += sun[..., None] * np.array([1.5, 1.3, 0.9])
    img[..., 3] = 1.0
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def translation(x, y, z) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = (x, y, z)
    return m


def rotation_y(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]],
                    np.float32)


def _in_castle(x: float, z: float) -> bool:
    """Whether x, z lies within a unit of a castle box's footprint."""
    return any(abs(x - c[0]) < s[0] / 2 + 1.0 and abs(z - c[2]) < s[2] / 2 + 1.0
               for c, s in CASTLE_BOXES)


def point_light_field(cfg: dict) -> list:
    """The lights of a configuration's `point_lights`: `count` point
    lights placed uniformly in `region` ({"x": [lo, hi], "z": [lo, hi]})
    outside the castle's walls, each `height` (a range) above the
    terrain, with an `attenuation_radius` drawn from its range, the
    given `point_radius` and `attenuation_exponent`, a colour drawn from
    `colors` and group bits cycled through `group_bits`. No light
    flickers (see build_scene)."""
    rng = np.random.default_rng(POINT_LIGHT_PLACES)
    (x0, x1), (z0, z1) = cfg["region"]["x"], cfg["region"]["z"]
    colors, groups = cfg["colors"], cfg["group_bits"]
    out = []
    while len(out) < int(cfg["count"]):
        x, z = float(rng.uniform(x0, x1)), float(rng.uniform(z0, z1))
        if _in_castle(x, z):
            continue
        y = float(terrain_height(x, z)) + float(rng.uniform(*cfg["height"]))
        color = colors[int(rng.integers(len(colors)))]
        out.append(dict(
            position=(x, y, z), diffuse_color=tuple(float(c) for c in color),
            attenuation_radius=float(rng.uniform(*cfg["attenuation_radius"])),
            point_radius=float(cfg["point_radius"]),
            attenuation_exponent=float(cfg["attenuation_exponent"]),
            flicker_intensity=0.0, group_bits=int(groups[len(out) % len(groups)])))
    return out


def build_scene(scene_cfg: dict, character: dict, seed: int) -> SceneData:
    """The castle grounds of one seed. scene_cfg: the configuration's
    "scene" (terrain_n, foliage; optionally point_lights and
    light_masks); character: the traffic's "character" (rings, segments,
    height, radius): its first pose, which the walk replaces every
    frame."""
    rng = np.random.default_rng([seed, 0x5CE7E])
    meshes = {
        "terrain": _terrain(int(scene_cfg["terrain_n"])),
        "castle": _boxes(),
        "moat": _moat(),
        "billboard": _billboard(),
        "character": character_mesh(character["rings"], character["segments"],
                                    character["height"], character["radius"],
                                    0.0),
    }
    textures = {
        "grass": _grass_texture(rng),
        "brick": _brick_texture(),
        "leaf": leaf_texture(rng),
        "sky": sky_texture(),
    }
    eye = np.eye(4, dtype=np.float32)
    instances = [
        InstanceData("terrain", eye, "texture", "grass", material=FOG),
        InstanceData("castle", eye, "texture", "brick"),
        InstanceData("moat", eye, "color", None, material=MIRROR),
    ]
    places = np.random.default_rng(FOLIAGE_PLACES)
    foliage = []
    while len(foliage) < int(scene_cfg["foliage"]):
        x, z = places.uniform(-60, 60), places.uniform(-50, 60)
        if abs(x) < 26 and -30 < z < 14:
            continue  # keep the castle courtyard clear
        foliage.append(len(instances))
        instances.append(InstanceData("billboard", translation(x, 0.0, z),
                                      "leaf", "leaf", no_cull=True))
    instances.append(InstanceData("character", eye, "texture", "brick"))
    # No light flickers: RT64 draws a flicker from the host's own random
    # source each time lights are set, which the reference cannot see.
    lights = [
        dict(position=(60.0, 90.0, 40.0), diffuse_color=(0.95, 0.9, 0.8),
             attenuation_radius=1e5, point_radius=4.0,
             specular_color=(0.5, 0.5, 0.45), attenuation_exponent=1.0,
             group_bits=1),
        dict(position=(0.0, 6.0, -16.0), diffuse_color=(1.0, 0.7, 0.3),
             attenuation_radius=40.0, point_radius=0.5,
             attenuation_exponent=1.5, group_bits=0x2),
    ]
    if "point_lights" in scene_cfg:
        lights += point_light_field(scene_cfg["point_lights"])
    for inst in instances:
        if inst.mesh in scene_cfg.get("light_masks", {}):
            inst.material = dict(inst.material, light_group_mask_bits=int(
                scene_cfg["light_masks"][inst.mesh]))
    scene_desc = dict(ambient_base_color=(0.22, 0.24, 0.3),
                      gi_diffuse_strength=0.7, gi_sky_strength=0.35)
    return SceneData(meshes, textures, instances, lights, foliage, scene_desc)
