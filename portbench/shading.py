"""The reference's render-size frame: what the frame graph's passes must
give, worked out from what the benchmark pushed (scene.SceneData and the
walk's FrameState), in plain torch. Nothing of the port (nor JAX) is
imported; the one file both sides read is RT64's blue-noise sequence
(`BLUE_NOISE_FILE`, a raw table of 64 frames of 64x64 RGB8 noise).

RT64's semantics, as the port's frame graph follows them:
- primary rays through the jittered pixel centre, closest accepted hit
  (back faces culled unless the instance disables culling; alpha-tested
  billboards passed through where the leaf's bilinear alpha is at most
  0.3); the hit's colour (TEXEL0 bilinear at level 0, or the vertex
  colour), camera fog folded into the transparent layer, the
  reflection's Fresnel share taken from the diffuse;
- direct light: every eligible light picked by blue-noise rounds
  (ComputeLightsRandom), one blue-noise sample of its disk, a shadow ray
  to it (no culling; a leaf texel over 0.3 occludes whole);
- GI (gi_samples 1, no history): one cosine-hemisphere bounce from blue
  noise, the bounce hit's colour lit by ambient and one picked light
  with its shadow ray, the sky plane where the bounce misses;
- reflections: mirror bounces off reflective hits, fog from the bounce
  origin, one picked light without shadows, the sky where they miss;
- the compose of diffuse, direct, indirect, reflection and transparent;
- the upscale slot's inputs: depth, screen flow (from the previous
  transforms and camera), reactive (the transparent layer) and lock.

Every stage runs in `dtype`: float64 for the reference, bfloat16 for the
control.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from portbench import reference as ref
from portbench import scene as sc

EPS = 1e-6
RAY_MIN, RAY_MAX = ref.RAY_MIN, ref.RAY_MAX
MAX_LIGHTS = 16
M_PI = 3.14159265  # BgSky.hlsli's constant, as RT64 writes it
BLUE_NOISE_FILE = os.path.join("rt64tpu_torch", "ops", "_bluenoise_u8.npy")
KINDS = {"texture": 0, "leaf": 1, "color": 2}
LIGHT_GROUP_ALL = 0xFFFFFFFF


def blue_noise_table(root: str, device) -> torch.Tensor:
    """(64 frames, 64, 64, 3) uint8 on the device."""
    return torch.as_tensor(np.load(os.path.join(root, BLUE_NOISE_FILE)),
                           device=device)


def blue_noise(table, pixels, frame: int, dtype):
    """getBlueNoise: (N, 3) in [0, 1] at pixels (N, 2) = (x, y)."""
    v = table[frame % 64, pixels[:, 1] % 64, pixels[:, 0] % 64]
    return v.to(dtype) / 255.0


def dot(a, b):
    return (a * b).sum(-1)


def normalize(a):
    return a / torch.sqrt(dot(a, a))[..., None]


def reflect(d, n):
    return d - 2.0 * dot(d, n)[..., None] * n


def perspective(camera: dict, display) -> np.ndarray:
    """XMMatrixPerspectiveFovRH (row vectors), float64."""
    h = 1.0 / math.tan(math.radians(camera["fov_deg"]) * 0.5)
    w = h / (display[0] / display[1])
    near, far = camera["near"], camera["far"]
    rng = far / (near - far)
    return np.array([[w, 0, 0, 0], [0, h, 0, 0], [0, 0, rng, -1.0],
                     [0, 0, rng * near, 0]], np.float64)


class Scene:
    """The frame's triangles and materials on the device in `dtype`."""

    def __init__(self, data: sc.SceneData, state, device, dtype):
        self.data, self.device, self.dtype = data, device, dtype
        v, pv, n, uv, col, inst = [], [], [], [], [], []
        for k, (desc, tf, prev) in enumerate(zip(data.instances,
                                                 state.transforms,
                                                 state.previous)):
            mesh = (state.character if desc.mesh == "character"
                    else data.meshes[desc.mesh])
            p = np.concatenate([mesh.positions.astype(np.float64),
                                np.ones((mesh.positions.shape[0], 1))], 1)
            m = tf.astype(np.float64)
            v.append((p @ m)[:, :3][mesh.indices])
            pv.append((p @ prev.astype(np.float64))[:, :3][mesh.indices])
            nm = np.linalg.inv(m[:3, :3]).T
            n.append((mesh.normals.astype(np.float64) @ nm)[mesh.indices])
            uv.append(mesh.uvs.astype(np.float64)[mesh.indices])
            rgb = mesh.color if mesh.color is not None else (0.0, 0.0, 0.0)
            col.append(np.tile(np.asarray(rgb, np.float64), (len(mesh.indices), 1)))
            inst.append(np.full(len(mesh.indices), k))
        t = lambda a, dt=dtype: torch.as_tensor(np.concatenate(a), device=device,
                                                dtype=dt)
        self.v, self.pv, self.n, self.uv, self.col = t(v), t(pv), t(n), t(uv), t(col)
        self.inst = t(inst, torch.int64)
        mats = [sc.material(d) for d in data.instances]
        f = lambda key: torch.as_tensor([m[key] for m in mats], device=device,
                                        dtype=dtype)
        self.kind = torch.as_tensor([KINDS[d.shader] for d in data.instances],
                                    device=device)
        self.no_cull = torch.as_tensor([d.no_cull for d in data.instances],
                                       device=device)
        names = sorted(data.textures)
        self.textures = [torch.as_tensor(data.textures[k], device=device).to(dtype)
                         / 255.0 for k in names]
        self.tex = torch.as_tensor([names.index(d.texture) if d.texture else -1
                                    for d in data.instances], device=device)
        self.sky = self.textures[names.index("sky")]
        self.fog_on, self.fog_mul, self.fog_offset = (
            f("fog_enabled") > 0, f("fog_mul"), f("fog_offset"))
        self.fog_color = f("fog_color")
        self.refl, self.fresnel = f("reflection_factor"), f("reflection_fresnel_factor")
        self.shine = f("reflection_shine_factor")
        self.spec, self.spec_exp = f("specular_color"), f("specular_exponent")
        self.self_light, self.ignore_normal = f("self_light"), f("ignore_normal_factor")
        self.shadow_bias = f("shadow_ray_bias")
        self.group_mask = [int(m["light_group_mask_bits"]) for m in mats]
        self.leaf = self.kind[self.inst] == KINDS["leaf"]
        self.tri_no_cull = self.no_cull[self.inst]
        self.leaf_alpha = self.textures[names.index("leaf")][..., 3]
        self.lights = state.lights  # as the frame pushed them


def sample(tex, u, v, addressing: int):
    """Bilinear level-0 fetch of an (H, W, C) texture at uv, with the
    texel centre at half a texel, wrap or clamp addressing."""
    h, w = tex.shape[:2]

    def axis(c, size):
        x = c * size - 0.5
        if addressing == "wrap":
            x = torch.remainder(x, float(size))
        else:
            x = torch.clamp(x, 0.0, size - 1.0)
        x0 = torch.floor(x)
        frac = x - x0
        i0 = x0.long().clamp(0, size - 1)
        i1 = (i0 + 1) % size if addressing == "wrap" else (i0 + 1).clamp(max=size - 1)
        return i0, i1, frac[..., None]

    x0, x1, fx = axis(u, w)
    y0, y1, fy = axis(v, h)
    return ((tex[y0, x0] * (1 - fx) + tex[y0, x1] * fx) * (1 - fy)
            + (tex[y1, x0] * (1 - fx) + tex[y1, x1] * fx) * fy)


def trace(s: Scene, origins, dirs, t_min, t_max, cull: bool, chunk=2048):
    """Closest accepted hit of each ray over every triangle:
    (tri (N,) int64, -1 for none; u, v, t (N,)). cull: back faces
    culled unless the instance disables culling (camera, bounce and
    mirror rays); shadow rays cull none. A leaf texel at alpha 0.3 or
    under is passed through."""
    v0 = s.v[:, 0]
    e1, e2 = s.v[:, 1] - v0, s.v[:, 2] - v0
    out = []
    for a in range(0, dirs.shape[0], chunk):
        o, d = origins[a:a + chunk, None], dirs[a:a + chunk, None]
        p = torch.linalg.cross(d.expand(-1, e2.shape[0], -1),
                               e2[None].expand(d.shape[0], -1, -1))
        det = (e1[None] * p).sum(-1)
        if cull:
            keep = torch.where(s.tri_no_cull[None], det.abs() > 1e-9, det > 1e-9)
        else:
            keep = det.abs() > 1e-9
        inv = 1.0 / torch.where(keep, det, torch.ones_like(det))
        tv = o - v0[None]
        u = (tv * p).sum(-1) * inv
        q = torch.linalg.cross(tv, e1[None].expand_as(tv))
        vv = (d * q).sum(-1) * inv
        t = (e2[None] * q).sum(-1) * inv
        hit = (keep & (u >= 0) & (vv >= 0) & (u + vv <= 1)
               & (t >= t_min[a:a + chunk, None]) & (t <= t_max[a:a + chunk, None]))
        leaf = hit & s.leaf[None]
        if leaf.any():
            r, c = leaf.nonzero(as_tuple=True)
            w0 = (1 - u[r, c] - vv[r, c])[:, None]
            uv = (w0 * s.uv[c, 0] + u[r, c, None] * s.uv[c, 1]
                  + vv[r, c, None] * s.uv[c, 2])
            alpha = sample(s.leaf_alpha[..., None], uv[:, 0], uv[:, 1],
                           sc.ADDRESSING["leaf"])[:, 0]
            hit[r, c] = alpha > sc.TEXTURE_EDGE_ALPHA
        t = torch.where(hit, t, torch.full_like(t, math.inf))
        best, arg = t.min(1)
        found = torch.isfinite(best)
        row = torch.arange(arg.shape[0], device=arg.device)
        out.append((torch.where(found, arg, torch.full_like(arg, -1)),
                    torch.where(found, u[row, arg], 0.0),
                    torch.where(found, vv[row, arg], 0.0),
                    torch.where(found, best, 0.0)))
    return tuple(torch.cat(x) for x in zip(*out))


class Hits:
    """The shading inputs of hits (tri >= 0) along rays: the hit point
    o + d t, the shading normal facing the ray, the colour and the
    instance."""

    def __init__(self, s: Scene, tri, u, v, t, origins, dirs):
        self.valid = tri >= 0
        tri = tri.clamp(min=0)
        self.inst = torch.where(self.valid, s.inst[tri], -1)
        k = s.inst[tri]
        w0 = (1 - u - v)[:, None]
        bary = lambda a: w0 * a[tri, 0] + u[:, None] * a[tri, 1] + v[:, None] * a[tri, 2]
        self.pos = origins + dirs * t[:, None]
        e1, e2 = s.v[tri, 1] - s.v[tri, 0], s.v[tri, 2] - s.v[tri, 0]
        geo = torch.linalg.cross(e1, e2)
        n = bary(s.n)
        n = torch.where((n == 0).all(-1, keepdim=True), geo, n)
        sign = torch.where(dot(geo, dirs) <= 0, 1.0, -1.0)
        self.normal = normalize(n) * sign[:, None].to(n.dtype)
        # The motion of the hit point since the previous transforms.
        self.motion = bary(s.v) - bary(s.pv)
        uv = bary(s.uv)
        rgb = s.col[tri].clone()
        for i, tex in enumerate(s.textures):
            for kind, mode in sc.ADDRESSING.items():
                use = (s.tex[k] == i) & (s.kind[k] == KINDS[kind]) & self.valid
                if use.any():
                    rgb[use] = sample(tex, uv[use, 0], uv[use, 1], mode)[:, :3]
        self.rgb = torch.where(self.valid[:, None], rgb, 0.0)
        self.k = k


def light_arrays(s: Scene, mask_rows):
    """Per light: position (L, 3), diffuse (L, 3), radius, point radius,
    specular (L, 3), shadow offset, attenuation exponent; and the
    eligibility (L, N) of each light for the materials in mask_rows
    (instance indices (N,))."""
    t = lambda key, default: torch.as_tensor(
        [l.get(key, default) for l in s.lights], device=s.device, dtype=s.dtype)
    masks = torch.as_tensor([m & LIGHT_GROUP_ALL for m in s.group_mask],
                            device=s.device)[mask_rows.clamp(min=0)]
    bits = torch.as_tensor([l.get("group_bits", 1) for l in s.lights],
                           device=s.device)
    elig = (masks[None] & bits[:, None]) != 0
    return dict(pos=t("position", (0.0,) * 3), diffuse=t("diffuse_color", (1.0,) * 3),
                radius=t("attenuation_radius", 1e5), point=t("point_radius", 0.0),
                specular=t("specular_color", (0.0,) * 3),
                offset=t("shadow_offset", 0.0),
                atten=t("attenuation_exponent", 1.0), elig=elig)


def lights(s: Scene, bn, pixels, frame: int, hits: Hits, ray_dir,
           max_light_count: int, di_samples: int, shadows: bool):
    """ComputeLightsRandom at the hits: (N, 3). Lights picked without
    replacement by blue-noise rounds weighted by their simple intensity;
    the pick's probability compensated only where one light is picked;
    di_samples blue-noise samples of the picked light's disk, each with a
    shadow ray when `shadows`."""
    dt = s.dtype
    n_px = hits.pos.shape[0]
    L = len(s.lights)
    la = light_arrays(s, hits.inst)
    k = hits.k
    pos, nrm = hits.pos, hits.normal
    ign = s.ignore_normal[k]
    delta = pos[None] - la["pos"][:, None]
    dist = torch.sqrt(dot(delta, delta))
    ndotl = -dot(nrm[None], delta) / dist.clamp(min=1e-12)
    bias = torch.clamp(ndotl + (1 - ndotl) * ign[None] + 0.707106, min=0.0)
    falloff = torch.clamp(1 - dist / la["radius"][:, None], min=0.0)
    intens = (torch.pow(falloff, la["atten"][:, None]) * bias
              * la["diffuse"].sum(1)[:, None])
    cand = la["elig"] & (intens > EPS) & hits.valid[None]
    cand = cand & (torch.cumsum(cand.long(), 0) - 1 < MAX_LIGHTS)
    intens = torch.where(cand, intens, 0.0)
    sel = cand.sum(0).clamp(max=max_light_count)
    use_prob = sel == 1
    rng_range, work = intens.sum(0), intens
    has_lighting = hits.valid  # every material here takes lights
    result = torch.zeros((n_px, 3), device=s.device, dtype=dt)
    lidx = torch.arange(L, device=s.device)
    samples = max(di_samples, 1)
    spec = s.spec[k]
    exp = s.spec_exp[k]
    for rnd in range(max_light_count):
        active = (rnd < sel) & has_lighting
        r = blue_noise(bn, pixels, frame + rnd, dt)[:, 0] * rng_range
        csum = torch.cumsum(work, 0)
        positive = work > 0
        over = (csum > r[None]) & positive
        first = torch.argmax(over.to(torch.int8), 0)
        last = (L - 1) - torch.argmax(positive.flip(0).to(torch.int8), 0)
        chosen = torch.where(over.any(0), first, last)
        onehot = lidx[:, None] == chosen[None]
        c_int = torch.where(onehot, work, 0.0).sum(0)
        inv_prob = torch.where(use_prob, rng_range / c_int.clamp(min=1e-12), 1.0)
        g = lambda a: a[chosen]
        lpos, lrad, lpoint = g(la["pos"]), g(la["radius"]), g(la["point"])
        lightdir = normalize(lpos - pos)
        up = torch.zeros_like(lightdir)
        up[:, 1] = 1.0
        px = torch.linalg.cross(-lightdir, up)
        zero = (px == 0).all(-1)
        px[:, 0] = torch.where(zero, 1.0, px[:, 0])
        py = torch.linalg.cross(px, -lightdir)
        lamb_sum = torch.zeros(n_px, device=s.device, dtype=dt)
        shade_sum = torch.zeros_like(lamb_sum)
        spec_sum = torch.zeros((n_px, 3), device=s.device, dtype=dt)
        for smp in range(samples, 0, -1):
            noise = blue_noise(bn, pixels, frame + smp, dt)
            scx, scy = noise[:, 0] * 2 - 1, noise[:, 1] * 2 - 1
            length = torch.sqrt(scx * scx + scy * scy)
            scale = length.clamp(0, 1) / length.clamp(min=1e-12)
            radius = lpoint if di_samples > 0 else torch.zeros_like(lpoint)
            spos = (lpos + px * (scx * scale * radius)[:, None]
                    + py * (scy * scale * radius)[:, None])
            d = spos - pos
            sdist = torch.sqrt(dot(d, d))
            sdir = d / sdist.clamp(min=1e-12)[:, None]
            inten = torch.pow(torch.clamp(1 - sdist / lrad, min=0.0), g(la["atten"]))
            nl = torch.clamp(dot(nrm, sdir), min=0.0)
            lamb = (nl + (1 - nl) * ign) * inten
            sdot = torch.clamp(dot(reflect(-sdir, nrm), -ray_dir) * inten, 0, 1)
            lit = torch.ones_like(lamb)
            if shadows:
                go = ((lamb > EPS) | (sdot > EPS)) & active
                tmax = torch.where(go, sdist - g(la["offset"]), -1.0)
                tmin = RAY_MIN + s.shadow_bias[k]
                tri, *_ = trace(s, pos, sdir, tmin, tmax, cull=False)
                lit = (tri < 0).to(dt)
            lamb_sum = lamb_sum + lamb
            shade_sum = shade_sum + lit
            spec_sum = spec_sum + spec * torch.pow(sdot, exp)[:, None]
        contrib = ((g(la["diffuse"]) * (lamb_sum / samples)[:, None]
                    + g(la["specular"]) * spec_sum / samples)
                   * (shade_sum / samples)[:, None])
        result = result + torch.where(active[:, None], contrib * inv_prob[:, None], 0.0)
        rng_range = rng_range - torch.where(active, c_int, 0.0)
        work = torch.where(onehot & active[None], 0.0, work)
    return torch.where(has_lighting[:, None], result, 0.0)


def sky_by_direction(s: Scene, dirs):
    """SampleSkyPlane: the sky texture at the direction's fake
    environment-map uv (yaw offset 0, multiplier 1), (N, 4)."""
    yaw = torch.remainder(torch.atan2(dirs[:, 0], -dirs[:, 2]) + M_PI, 2 * M_PI)
    pitch = torch.remainder(torch.atan2(-dirs[:, 1], torch.sqrt(
        dirs[:, 0] ** 2 + dirs[:, 2] ** 2)) + M_PI, 2 * M_PI)
    return sample(s.sky, yaw / (2 * M_PI), pitch / (2 * M_PI), "wrap")


def sky_on_screen(s: Scene, state, pixels, jit, render, display):
    """SampleSky2D on the pixel grid (N, 4): the skybox's screen-affine uv
    from the camera's yaw and pitch (BgSky.hlsli)."""
    rw, rh = render
    aspect = display[0] / display[1]
    vd = np.asarray(state.eye, np.float64) - np.asarray(state.target, np.float64)
    vd = vd / np.linalg.norm(vd)
    yaw = math.fmod(math.atan2(vd[0], -vd[2]) + M_PI, 2 * M_PI)
    yaw = yaw + 2 * M_PI if yaw < 0 else yaw
    base_x = 320 * 360.0 * (yaw - M_PI) / (90.0 * M_PI * 2.0)
    pitch = math.atan2(-vd[1], math.hypot(vd[0], vd[2])) * 360.0 / (M_PI * 2.0)
    base_y = min(max(360.0 * pitch / 90.0 + 5.0 * 120.0, 240.0), 960.0)
    base_x = (base_x + 160.0 - 240.0 * aspect / 2.0) / 1280.0
    base_y = (960.0 - base_y) / 960.0
    ratio = aspect / (4.0 / 3.0)
    p = pixels.to(s.dtype)
    u = base_x + (p[:, 0] + jit[0]) / rw * 0.25 * ratio
    v = base_y + (p[:, 1] + jit[1]) / rh * 0.25
    return sample(s.sky, u, v, "wrap")


def fresnel(normal, incident, reflectivity, multiplier):
    ret = torch.pow(torch.clamp(1 + dot(normal, incident), EPS, 1.0), 5.0)
    return reflectivity + (1 - reflectivity) * ret * multiplier


def fog_from_camera(s: Scene, k, pos, vp):
    """ComputeFogFromCamera: N64 clip-space fog alpha."""
    cz = pos @ vp[:3, 2] + vp[3, 2]
    cw = pos @ vp[:3, 3] + vp[3, 3]
    z = cz * 2 - cw
    a = torch.clamp(((z / cw.clamp(min=0.001)) * s.fog_mul[k] + s.fog_offset[k])
                    / 255.0, 0, 1)
    return torch.where(s.fog_on[k], a, 0.0)


def fog_from_origin(s: Scene, k, pos, origin):
    d = pos - origin
    a = torch.clamp(((torch.sqrt(dot(d, d)) + s.fog_offset[k]) / s.fog_mul[k]) * 0.5,
                    0, 1)
    return torch.where(s.fog_on[k], a, 0.0)


def to_screen(vp, pos):
    cx = pos @ vp[:3, 0] + vp[3, 0]
    cy = pos @ vp[:3, 1] + vp[3, 1]
    cw = pos @ vp[:3, 3] + vp[3, 3]
    return 0.5 + 0.5 * cx / cw, 0.5 + 0.5 * cy / cw


class Frame:
    """One frame of the walk as the reference draws it: camera rays of
    the render pixels asked for, their primary hits, and what the
    passes make of them."""

    def __init__(self, data, state, prev_state, cfg: dict, camera: dict,
                 device, dtype, root: str = "."):
        self.cfg, self.state, self.camera = cfg, state, camera
        self.render, self.display = tuple(cfg["render"]), tuple(cfg["display"])
        self.jit = ref.jitter(state.index, cfg["upscaler"], self.render[0],
                              self.display[0])
        self.s = Scene(data, state, device, dtype)
        self.bn = blue_noise_table(root, device)
        proj = perspective(camera, self.display)
        t = lambda m: torch.as_tensor(m, device=device, dtype=dtype)
        self.vp = t(state.view_matrix.astype(np.float64) @ proj)
        self.prev_vp = t(prev_state.view_matrix.astype(np.float64) @ proj)
        self.device, self.dtype = device, dtype

    def primary(self, pixels):
        """(origins, dirs, Hits) of render pixels (N, 2)."""
        o, d = ref.camera_rays(self.state, self.camera, self.render, self.display,
                               self.jit, pixels, self.device, self.dtype)
        n = d.shape[0]
        tmin = torch.full((n,), RAY_MIN, device=self.device, dtype=self.dtype)
        tmax = torch.full((n,), RAY_MAX, device=self.device, dtype=self.dtype)
        tri, u, v, t = trace(self.s, o, d, tmin, tmax, cull=True)
        return o, d, Hits(self.s, tri, u, v, t, o, d)

    def surface(self, d, h: Hits):
        """The primary pass's fold of one opaque hit: (diffuse colour,
        transparent layer, reflection weight) (N, 3), (N, 3), (N,)."""
        s, k = self.s, h.k
        fa = fog_from_camera(s, k, h.pos, self.vp)
        transparent = s.fog_color[k] * fa[:, None]
        share = 1 - fa
        reflective = s.refl[k] > EPS
        f = fresnel(h.normal, d, s.refl[k], s.fresnel[k])
        refl_w = torch.where(reflective, f * share, 0.0)
        share = torch.where(reflective, share * (1 - f), share)
        valid = h.valid[:, None]
        return (torch.where(valid, h.rgb * share[:, None], 0.0),
                torch.where(valid, transparent, 0.0),
                torch.where(h.valid, refl_w, 0.0))

    def planes(self, chunk_rows: int = 256):
        """The upscale slot's inputs over the whole render size, (H, W)
        each: depth, flow x and y (render pixels), reactive, lock."""
        rw, rh = self.render
        out = {k: [] for k in ("depth", "flow_x", "flow_y", "reactive", "lock")}
        binary_lock = self.cfg["upscaler"] != "fsr"
        for y0 in range(0, rh, chunk_rows):
            ys = torch.arange(y0, min(rh, y0 + chunk_rows), device=self.device)
            xs = torch.arange(rw, device=self.device)
            pix = torch.stack([xs[None].expand(len(ys), -1).reshape(-1),
                               ys[:, None].expand(-1, rw).reshape(-1)], 1)
            o, d, h = self.primary(pix)
            _, transparent, refl_w = self.surface(d, h)
            bg = o + d * RAY_MAX
            prev = torch.where(h.valid[:, None], h.pos - h.motion, bg)
            cur = torch.where(h.valid[:, None], h.pos, bg)
            pu, pv = to_screen(self.prev_vp, prev)
            cu, cv = to_screen(self.vp, cur)
            cz = cur @ self.vp[:3, 2] + self.vp[3, 2]
            cw = cur @ self.vp[:3, 3] + self.vp[3, 3]
            out["depth"].append(torch.where(h.valid, cz / cw, 1.0))
            out["flow_x"].append(-(cu - pu) * rw)
            out["flow_y"].append((cv - pv) * rh)
            out["reactive"].append(transparent.amax(-1).clamp(max=0.9))
            out["lock"].append((refl_w > 0.5).to(self.dtype) if binary_lock
                               else refl_w.clamp(max=1.0))
        return {k: torch.cat(v).reshape(rh, rw) for k, v in out.items()}

    def shade(self, pixels):
        """The render-size frame at render pixels (N, 2): the composed
        colour (N, 3) and its parts."""
        s, cfg, dt = self.s, self.cfg, self.dtype
        frame = self.state.index
        o, d, h = self.primary(pixels)
        diffuse, transparent, refl_w = self.surface(d, h)
        sky = sky_on_screen(s, self.state, pixels.to(self.device), self.jit,
                            self.render, self.display)
        diffuse = torch.where(h.valid[:, None], diffuse, sky[:, :3] * sky[:, 3:])
        pix = pixels.to(self.device)
        direct = lights(s, self.bn, pix, frame, h, d, int(cfg["max_lights"]),
                        int(cfg["di_samples"]), shadows=True)
        direct = torch.where(h.valid[:, None], direct, 1.0)
        ambient = torch.as_tensor(self.s.data.ambient, device=self.device, dtype=dt)
        indirect = ambient.expand(h.pos.shape[0], 3)
        if int(cfg["gi_samples"]) > 0:
            indirect = self.gi(pix, frame, h, ambient)
        reflection = self.reflections(pix, frame, d, h, refl_w, ambient)
        lit = diffuse * (direct + indirect)
        a = h.valid.to(dt)[:, None]
        rgb = diffuse * (1 - a) + lit * a + reflection + transparent
        rgb = torch.where(a > EPS, rgb, diffuse)
        return dict(rgb=rgb, direct=direct, indirect=indirect,
                    reflection=reflection, instance=h.inst, position=h.pos)

    def gi(self, pix, frame, h: Hits, ambient):
        """IndirectRayGen with one sample and no history."""
        s, dt = self.s, self.dtype
        noise = blue_noise(self.bn, pix, frame + 64, dt)
        r1, r2, nrm = noise[:, 0], noise[:, 1], h.normal
        a = nrm.abs()
        xm = ((a[:, 0] - a[:, 1]) < 0) & ((a[:, 0] - a[:, 2]) < 0)
        ym = ((a[:, 1] - a[:, 2]) < 0) & ~xm
        basis = torch.stack([xm, ym, ~(xm | ym)], 1).to(dt)
        bit = torch.linalg.cross(nrm, basis)
        tan = torch.linalg.cross(bit, nrm)
        r, phi = torch.sqrt(r1), 2 * math.pi * r2
        dirs = (tan * (r * torch.cos(phi))[:, None] + bit * (r * torch.sin(phi))[:, None]
                + nrm * torch.sqrt(torch.clamp(1 - r1, min=0.0))[:, None])
        n = dirs.shape[0]
        tmin = torch.full((n,), RAY_MIN, device=self.device, dtype=dt)
        tmax = torch.where(h.valid, RAY_MAX, -1.0).to(dt)
        tri, u, v, t = trace(s, h.pos, dirs, tmin, tmax, cull=True)
        b = Hits(s, tri, u, v, t, h.pos, dirs)
        direct = lights(s, self.bn, pix, frame, b, dirs, 1,
                        int(self.cfg["di_samples"]), shadows=True)
        bounce = b.rgb * (ambient + direct + s.self_light[b.k]) * float(
            self.s.data.gi_diffuse_strength)
        sky = sky_by_direction(s, dirs)
        bg = sky[:, :3] * sky[:, 3:]
        res = ambient + torch.where(b.valid[:, None], bounce, 0.0)
        res = res + torch.where(b.valid[:, None], 0.0, bg * float(
            self.s.data.gi_sky_strength))
        return torch.where(h.valid[:, None], res, ambient)

    def reflections(self, pix, frame, d, h: Hits, refl_w, ambient):
        """ReflectionRayGen, max_reflections times: each bounce reads the
        state the last one wrote."""
        s, dt = self.s, self.dtype
        rgb = torch.zeros_like(h.pos)
        weight, pos, view, nrm, inst = refl_w, h.pos, d, h.normal, h.inst
        k_fresnel = s.fresnel[h.k]
        shine = s.shine[h.k]
        for _ in range(int(self.cfg["max_reflections"])):
            active = (inst >= 0) & (weight > EPS)
            if not bool(active.any()):
                break
            dirs = reflect(view, nrm)
            n = dirs.shape[0]
            tmin = torch.full((n,), RAY_MIN, device=self.device, dtype=dt)
            tmax = torch.where(active, RAY_MAX, -1.0).to(dt)
            tri, u, v, t = trace(s, pos, dirs, tmin, tmax, cull=True)
            b = Hits(s, tri, u, v, t, pos, dirs)
            fa = fog_from_origin(s, b.k, b.pos, pos)
            fa = torch.where(b.valid, fa, 0.0)
            transparent = torch.where(b.valid[:, None], s.fog_color[b.k] * fa[:, None], 0.0)
            share = 1 - fa
            reflective = b.valid & (s.refl[b.k] > EPS)
            nxt = torch.where(reflective, fresnel(b.normal, dirs, s.refl[b.k], k_fresnel)
                              * share * weight, 0.0)
            col = torch.where(b.valid[:, None], b.rgb * share[:, None], 0.0)
            direct = lights(s, self.bn, pix, frame, b, dirs, 1,
                            int(self.cfg["di_samples"]), shadows=False)
            col = torch.where(b.valid[:, None],
                              col * (ambient + direct + s.self_light[b.k]), col)
            sky = sky_by_direction(s, dirs)
            bg = sky[:, :3] * sky[:, 3:]
            col = col + torch.where(b.valid[:, None], 0.0, bg) + transparent
            shine = torch.where(b.valid & active, s.shine[b.k], shine)
            k_fresnel = torch.where(b.valid & active, s.fresnel[b.k], k_fresnel)
            up = torch.pow(torch.clamp(dirs[:, 1], min=0.0) * shine, 3.0)[:, None]
            down = torch.pow(torch.clamp(-dirs[:, 1], min=0.0) * shine, 3.0)[:, None]
            hi = torch.tensor([1.0, 1.05, 1.2], device=self.device, dtype=dt)
            lo = torch.tensor([0.1, 0.05, 0.0], device=self.device, dtype=dt)
            col = col * (1 - up) + hi * up
            col = col * (1 - down) + lo * down
            add = col * weight[:, None] * torch.clamp(1 - nxt, 0, 1)[:, None]
            rgb = rgb + torch.where(active[:, None], add, 0.0)
            upd = (active & b.valid)[:, None]
            pos = torch.where(upd, b.pos, pos)
            view = torch.where(upd, dirs, view)
            nrm = torch.where(upd, b.normal, nrm)
            inst = torch.where(upd[:, 0], b.inst, inst)
            weight = torch.where(active, torch.clamp(nxt, 0, 1), weight)
        return rgb
