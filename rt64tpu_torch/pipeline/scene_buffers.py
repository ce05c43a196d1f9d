"""Host -> device scene assembly (packed-row layout).

The per-frame analog of View::update (rt64_view.cpp:1053-1178): classify
instances, resolve texture bindings, and upload transform/material data.
Everything packs into wide rows (pipeline/rows.py):

  * geometry epoch (mesh/instance set changed): vertex rows + triangle
    index tables — the BLAS-build analog.
  * texture epoch: the *quad pool* — every (texture, addressing) combo
    used by the scene gets sampling-ready entries holding the texel and
    its +x/+y/+xy neighbors under that addressing mode, so a bilinear
    fetch reads one quad; a diffuse texture of a mip-LOD shader gets its
    whole mip chain (texture.mip_select's layout).
  * per frame: instance rows (transforms, materials, combiner, light
    group mask) and lights with their group bits — the upload-heap
    analog.

Tensors land on the packer's torch device. The layout matches the JAX
package's SceneBuffers field for field but for the lights: an instance
row carries its light group mask where the JAX package's carries one
eligibility column per light slot, and `light_groups` carries the
lights' group bits (rt64tpu_torch/convert.py moves a packed scene
across).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from rt64tpu_torch import descriptors as d
from rt64tpu_torch.api import LIGHT_WIDTH, Instance, Texture
from rt64tpu_torch.limits import SceneLimits, _next_bucket
from rt64tpu_torch.ops import texture as tex_ops
from rt64tpu_torch.ops.combiner import SHADER_0, SHADER_TEXEL0A
from rt64tpu_torch.ops.mipmaps import generate_mips
from rt64tpu_torch.ops.raster import (RR_IN1, RR_IN2, RR_INST, RR_POS, RR_UV,
                                      RR_WIDTH)
from rt64tpu_torch.pipeline import rows as R
from rt64tpu_torch.utils import profiling


class ShadeFeatures(NamedTuple):
    """Scene-wide shading capabilities, known on the host: the frame
    skips whole sub-passes the scene cannot trigger (the dispatch-level
    analog of the reference compiling a shader permutation per material
    feature set, rt64_shader.cpp:104-129)."""

    has_alpha: bool = True  # any alpha-class triangles
    has_normal_maps: bool = True
    has_specular_maps: bool = True
    has_texel1: bool = True  # any TEXEL1 (alt) texture bound
    # Any instance that can yield a TRANSPARENT-LIT primary hit
    # (lighting on, alpha-class, partial alpha possible — i.e. not
    # binarized by texture-edge; PrimaryRayGen.hlsl:139-147).
    has_lit_transparent: bool = True
    # Any instance opted into ray-diff mip LOD (SHADER_MIP_LOD_ENABLED).
    has_mips: bool = False
    # Any raster-background triangles this frame.
    has_raster_bg: bool = True


class RasterHost(NamedTuple):
    """The packer's host copies of what the raster passes read per
    triangle (ops/raster.py): the valid rows of each raster layer, the
    instance rows and the quad-pool records. With them the frame knows
    the counts and every triangle's draw state without reading the
    device."""

    bg: np.ndarray  # (raster_bg_count, RR_WIDTH)
    fg: np.ndarray  # (raster_fg_count, RR_WIDTH)
    instance_rows: np.ndarray  # (I, IROW)
    quad_records: np.ndarray  # (Rec, 3)


class SceneBuffers(NamedTuple):
    """Device-resident scene. All shapes fixed by SceneLimits. The
    fields up to `features` match the JAX package's but for
    `light_groups` and the instance rows' light columns (module
    docstring); raster_host holds host copies of the raster tables
    (RasterHost)."""

    vertex_rows: torch.Tensor  # (V, VROW) f32 object-space attrs
    tri_idx: torch.Tensor  # (T, 3) int32
    tri_instance: torch.Tensor  # (T,) int32
    tri_valid: torch.Tensor  # (T,) bool
    instance_rows: torch.Tensor  # (I, IROW) f32
    lights: torch.Tensor  # (L, 14) f32
    light_count: torch.Tensor  # () int32
    light_groups: torch.Tensor  # (L,) int32 groupBits (0 past the count)
    quad_pool: torch.Tensor  # (P/32, 128) int64 uint32 words, wide layout
    quad_records: torch.Tensor  # (Rec, 3) int32: offset, width, height
    raster_bg: torch.Tensor  # (RB, RR_WIDTH) raster background triangles
    raster_bg_count: torch.Tensor  # () int32
    raster_fg: torch.Tensor  # (RB, RR_WIDTH) raster foreground (HUD)
    raster_fg_count: torch.Tensor  # () int32
    # Dense (4, Ht, Wt) f32 copy of the sky-plane texture (None when the
    # view has no sky), for the fixed-grid sky resample.
    sky_plane: Optional[torch.Tensor] = None
    features: ShadeFeatures = ShadeFeatures()
    raster_host: Optional[RasterHost] = None


def _addr_np(i, size, mode):
    if mode == d.SHADER_ADDRESSING_WRAP:
        return np.mod(i, size)
    if mode == d.SHADER_ADDRESSING_MIRROR:
        m = np.mod(i, 2 * size)
        return np.where(m < size, m, 2 * size - 1 - m)
    return np.clip(i, 0, size - 1)


def build_quad_entries(rgba: np.ndarray, h_mode: int, v_mode: int) -> np.ndarray:
    """Sampling-ready quad entries for one texture under one addressing
    mode: entry[y*W+x] = packed u32 of (x,y), (x+1,y), (x,y+1), (x+1,y+1)
    with the +1 neighbors wrapped per the mode."""
    h, w = rgba.shape[:2]
    packed = (
        rgba[..., 0].astype(np.uint32)
        | (rgba[..., 1].astype(np.uint32) << 8)
        | (rgba[..., 2].astype(np.uint32) << 16)
        | (rgba[..., 3].astype(np.uint32) << 24)
    )
    xs = np.arange(w)
    ys = np.arange(h)
    x1 = _addr_np(xs + 1, w, h_mode)
    y1 = _addr_np(ys + 1, h, v_mode)
    out = np.zeros((h * w, 4), np.uint32)
    out[:, 0] = packed.reshape(-1)
    out[:, 1] = packed[:, x1].reshape(-1)
    out[:, 2] = packed[y1, :].reshape(-1)
    out[:, 3] = packed[y1][:, x1].reshape(-1)
    return out


def _alpha_class(shader, material: d.Material) -> bool:
    """Conservative: can this instance's evaluated hit alpha be < 1?
    Mirrors when the any-hit could produce partial alpha or IgnoreHit
    (rt64_shader.cpp:489-516)."""
    cc = shader.combiner
    if cc.opt_alpha or cc.opt_noise or cc.opt_texture_edge:
        return True
    if material.solid_alpha_multiplier < 1.0:
        return True
    c = cc.c[0]
    return c[1] == SHADER_0 and c[3] == SHADER_0 and c[2] == SHADER_TEXEL0A


def _content_key(de) -> tuple:
    """Value-key of every descriptor field that feeds the content
    columns (I_MAT..end) of an instance row, compared by value because
    hosts re-push the same (mutated) descriptor every frame."""
    def _v(x):
        if isinstance(x, np.ndarray):
            return tuple(np.asarray(x).ravel().tolist())
        if isinstance(x, (list, tuple)):
            return tuple(_v(e) for e in x)
        return x

    return (
        tuple(_v(v) for v in vars(de.material).values()),
        id(de.shader),
        id(de.diffuse_texture), id(de.normal_texture),
        id(de.specular_texture), id(de.alt_texture),
        _v(de.viewport_rect), _v(de.scissor_rect),
        int(de.flags),
    )


class ScenePacker:
    """Incremental packer owning the numpy staging arrays and their
    device copies."""

    def __init__(self, limits: SceneLimits, device: torch.device):
        self.limits = limits
        self.device = device
        self._geometry_key = None
        self._quad_key = None
        self._np: dict = {}
        self._combo_ids: dict = {}  # (tex_id, h, v, mip) -> record index
        self._row_cache: dict = {}
        self._dev_quads = None
        self._sky_dense_key = "unset"
        self._sky_dense = None
        self.triangle_count = 0
        self.alpha_triangle_count = 0

    def _up(self, a: np.ndarray) -> torch.Tensor:
        return profiling.upload(np.ascontiguousarray(a), self.device)

    # -- texture quad pool ---------------------------------------------------
    def pack_quad_pool(self, instances: List[Instance]):
        """Collect every (texture, hAddr, vAddr, mip) combo in use and
        build the sampling-ready pool."""
        lm = self.limits
        combos = []
        seen = set()
        for inst in instances:
            sh = inst.desc.shader
            if sh is None:
                continue
            # Only the diffuse fetch is mip-filtered (the ray-diff LOD
            # drives tex0; normal/spec/alt maps stay level 0 like the
            # reference's SampleGrad call sites, rt64_shader.cpp:474-545).
            texes = (inst.desc.diffuse_texture, inst.desc.normal_texture,
                     inst.desc.specular_texture, inst.desc.alt_texture)
            for j, tex in enumerate(texes):
                if tex is None:
                    continue
                mip = sh.mip_lod_enabled and j == 0
                key = (id(tex), sh.h_addr, sh.v_addr, mip)
                if key not in seen:
                    seen.add(key)
                    combos.append((tex, sh.h_addr, sh.v_addr, mip))
        key = tuple((id(t), h, v, mp) for t, h, v, mp in combos)
        if key == self._quad_key:
            return
        pool = np.zeros((lm.texel_pool, 4), np.uint32)
        records = np.zeros((lm.max_textures, 3), np.int32)
        self._combo_ids = {}
        offset = 0
        rec = 0
        for tex, h_addr, v_addr, mip in combos:
            levels = (generate_mips(tex.rgba, max_levels=tex_ops.MAX_MIP_LEVELS)
                      if mip else [tex.rgba])
            n = sum(lv.shape[0] * lv.shape[1] for lv in levels)
            if offset + n > lm.texel_pool or rec >= lm.max_textures:
                raise ValueError("quad pool exhausted; grow SceneLimits")
            # Chain layout (texture.mip_select): level l starts right
            # after level l-1's h*w entries.
            o = offset
            for lv in levels:
                ln = lv.shape[0] * lv.shape[1]
                pool[o : o + ln] = build_quad_entries(lv, h_addr, v_addr)
                o += ln
            records[rec] = (offset, tex.width, tex.height)
            self._combo_ids[(id(tex), h_addr, v_addr, mip)] = rec
            offset += n
            rec += 1
        self._next_rec = rec
        self._next_off = offset
        self._np["quad_pool"] = pool
        self._np["quad_records"] = records
        self._dev_quads = None  # re-upload lazily (env textures may append)
        self._quad_key = key

    def add_env_texture(self, tex: Optional[Texture]) -> int:
        """Record id for a wrap/wrap env/sky texture (added on demand)."""
        if tex is None:
            return -1
        key = (id(tex), d.SHADER_ADDRESSING_WRAP, d.SHADER_ADDRESSING_WRAP,
               False)
        if key in self._combo_ids:
            return self._combo_ids[key]
        n = tex.width * tex.height
        pool = self._np["quad_pool"]
        records = self._np["quad_records"]
        if self._next_off + n > pool.shape[0] or self._next_rec >= records.shape[0]:
            raise ValueError("quad pool exhausted; grow SceneLimits")
        pool[self._next_off : self._next_off + n] = build_quad_entries(
            tex.rgba, d.SHADER_ADDRESSING_WRAP, d.SHADER_ADDRESSING_WRAP
        )
        records[self._next_rec] = (self._next_off, tex.width, tex.height)
        self._combo_ids[key] = self._next_rec
        self._next_off += n
        self._next_rec += 1
        self._dev_quads = None
        return self._combo_ids[key]

    def set_sky_plane_dense(self, tex: Optional[Texture]):
        """Dense (4, Ht, Wt) f32 sky texture for the fixed-grid resample
        (SceneBuffers.sky_plane)."""
        key = None if tex is None else (id(tex), tex.width, tex.height)
        if self._sky_dense_key == key:
            return
        self._sky_dense_key = key
        if tex is None:
            self._sky_dense = None
        else:
            img = tex.rgba.astype(np.float32).transpose(2, 0, 1) / 255.0
            self._sky_dense = self._up(img)

    # -- geometry epoch -------------------------------------------------------
    def pack_geometry(self, instances: List[Instance]):
        lm = self.limits
        # The alpha-class bit is part of the key: it depends on the
        # material, so an edit that flips an instance's class re-packs.
        key = tuple(
            (id(inst), inst.desc.mesh.version if inst.desc.mesh else -1,
             id(inst.desc.shader),
             inst.desc.shader is not None
             and _alpha_class(inst.desc.shader, inst.desc.material))
            for inst in instances
        )
        if key == self._geometry_key:
            return
        V, T = lm.max_vertices, lm.max_triangles
        vrows = np.zeros((V, R.VROW), np.float32)
        vrows[:, R.V_IN1 + 3] = 1.0  # float3 inputs extend alpha=1
        vrows[:, R.V_IN2 + 3] = 1.0
        tri_idx = np.zeros((T, 3), np.int32)
        tri_instance = np.zeros(T, np.int32)
        tri_valid = np.zeros(T, bool)

        voff = 0
        toff = 0
        alpha_count = 0
        for ii, inst in enumerate(instances):
            mesh = inst.desc.mesh
            shader = inst.desc.shader
            if mesh is None or shader is None or mesh.indices is None:
                continue
            parsed = mesh.parsed(shader.layout_key)
            nv = parsed["positions"].shape[0]
            nt = parsed["indices"].shape[0]
            if voff + nv > V or toff + nt > T:
                raise ValueError("scene geometry exceeds SceneLimits buckets")
            vrows[voff : voff + nv, R.V_POS : R.V_POS + 3] = parsed["positions"]
            vrows[voff : voff + nv, R.V_NRM : R.V_NRM + 3] = parsed["normals"]
            vrows[voff : voff + nv, R.V_UV : R.V_UV + 2] = parsed["uvs"]
            vrows[voff : voff + nv, R.V_IN1 : R.V_IN1 + 4] = parsed["inputs"][:, 0]
            vrows[voff : voff + nv, R.V_IN2 : R.V_IN2 + 4] = parsed["inputs"][:, 1]
            perm = parsed["tri_perm"]
            tri_idx[toff : toff + nt] = parsed["indices"][perm] + voff
            tri_instance[toff : toff + nt] = ii
            tri_valid[toff : toff + nt] = True
            if _alpha_class(shader, inst.desc.material):
                alpha_count += nt
            voff += nv
            toff += nt

        self._dev_geom = dict(
            vertex_rows=self._up(vrows),
            tri_idx=self._up(tri_idx),
            tri_instance=self._up(tri_instance),
            tri_valid=self._up(tri_valid),
        )
        self._geometry_key = key
        self.triangle_count = toff
        # Upper bound on compacted alpha-class triangles this epoch:
        # drives alpha_cap so the alpha list never silently drops hits.
        self.alpha_triangle_count = alpha_count

    @property
    def alpha_cap(self) -> int:
        """Capacity bucket for the compacted alpha list: the configured
        floor, grown to fit this epoch's alpha-class count."""
        base = self.limits.alpha_triangles
        n = self.alpha_triangle_count
        return base if n <= base else _next_bucket(n, base)

    # -- per-frame -------------------------------------------------------------
    def pack_frame(self, instances: List[Instance], lights_arrays,
                   raster_bg=None, raster_fg=None) -> SceneBuffers:
        """instances: raytraced + raster, in one list (instance rows are
        shared); raster_bg/raster_fg: the raster classification
        (rt64_view.cpp:1081-1147)."""
        lm = self.limits
        I = lm.max_instances
        larr, lgroups = lights_arrays
        irows = np.zeros((I, R.IROW), np.float32)
        eye3 = np.eye(3, dtype=np.float32).reshape(-1)
        irows[:, R.I_M3 : R.I_M3 + 9] = eye3
        irows[:, R.I_NM3 : R.I_NM3 + 9] = eye3
        irows[:, R.I_PM3 : R.I_PM3 + 9] = eye3
        irows[:, R.I_TEX_D] = -1
        irows[:, R.I_TEX_N] = -1
        irows[:, R.I_TEX_S] = -1
        irows[:, R.I_TEX_D2] = -1

        # The content columns (I_MAT..end) of each instance row are
        # cached against a value-key of the descriptor; transforms are
        # filled vectorized below every frame.
        n_act = min(len(instances), I)
        tfs = np.empty((n_act, 4, 4), np.float32)
        ptfs = np.empty((n_act, 4, 4), np.float32)
        # Rows hold the light group mask, not the lights: re-sent lights
        # leave the cache valid.
        epoch = (
            id(self._np.get("quad_records")),
            getattr(self, "_next_rec", 0),
        )
        cache = self._row_cache
        new_cache = {}

        for ii, inst in enumerate(instances[:I]):
            de = inst.desc
            m = de.material
            sh = de.shader
            tf = (
                np.asarray(de.transform, np.float32).reshape(4, 4)
                if de.transform is not None else np.eye(4, dtype=np.float32)
            )
            ptf = (
                np.asarray(de.previous_transform, np.float32).reshape(4, 4)
                if de.previous_transform is not None else tf
            )
            tfs[ii] = tf
            ptfs[ii] = ptf

            ckey = (_content_key(de), epoch)
            hit = cache.get(id(inst))
            if hit is not None and hit[0] == ckey:
                irows[ii, R.I_MAT :] = hit[1]
                new_cache[id(inst)] = hit
                continue

            mat = irows[ii, R.I_MAT : R.I_MAT + R.M_WIDTH]
            mat[R.M_IGNORE_NORMAL] = m.ignore_normal_factor
            mat[R.M_UV_DETAIL] = m.uv_detail_scale
            mat[R.M_REFLECTION] = m.reflection_factor
            mat[R.M_REFL_FRESNEL] = m.reflection_fresnel_factor
            mat[R.M_REFL_SHINE] = m.reflection_shine_factor
            mat[R.M_REFRACTION] = m.refraction_factor
            mat[R.M_SPECULAR : R.M_SPECULAR + 3] = m.specular_color
            mat[R.M_SPEC_EXP] = m.specular_exponent
            mat[R.M_SOLID_ALPHA] = m.solid_alpha_multiplier
            mat[R.M_SHADOW_ALPHA] = m.shadow_alpha_multiplier
            mat[R.M_DEPTH_BIAS] = m.depth_bias
            mat[R.M_SHADOW_RAY_BIAS] = m.shadow_ray_bias
            mat[R.M_SELF_LIGHT : R.M_SELF_LIGHT + 3] = m.self_light
            mat[R.M_FOG_COLOR : R.M_FOG_COLOR + 3] = m.fog_color
            mat[R.M_DIFFUSE_MIX : R.M_DIFFUSE_MIX + 4] = m.diffuse_color_mix
            mat[R.M_FOG_MUL] = m.fog_mul
            mat[R.M_FOG_OFFSET] = m.fog_offset
            mat[R.M_FOG_ENABLED] = float(m.fog_enabled)
            mat[R.M_LOCK] = m.lock_mask

            if sh is not None:
                cc = sh.combiner
                irows[ii, R.I_CC] = R.pack_cc(cc.c[0], cc.c[1])
                flags = 0
                flags |= R.F_OPT_ALPHA * cc.opt_alpha
                flags |= R.F_TEXTURE_EDGE * cc.opt_texture_edge
                flags |= R.F_NOISE * cc.opt_noise
                flags |= R.F_ALPHA_SAME * cc.color_alpha_same
                flags |= R.F_USE_T0 * cc.use_textures[0]
                flags |= R.F_USE_T1 * cc.use_textures[1]
                flags |= R.F_NORMAL_MAP * sh.normal_map_enabled
                flags |= R.F_SPECULAR_MAP * sh.specular_map_enabled
                flags |= R.F_NO_CULL * bool(
                    de.flags & d.INSTANCE_DISABLE_BACKFACE_CULLING
                )
                flags |= R.F_ALPHA_CLASS * _alpha_class(sh, m)
                flags |= R.F_HAS_LIGHTING * (m.light_group_mask_bits != 0)
                flags |= R.F_MIP_LOD * (
                    sh.mip_lod_enabled and de.diffuse_texture is not None
                )
                irows[ii, R.I_FLAGS] = float(flags)
                irows[ii, R.I_SAMPLER] = float(
                    sh.filter + 4 * sh.h_addr + 16 * sh.v_addr
                )
                irows[ii, R.I_INPUT_COUNT] = float(cc.input_count)

                def rec_id(tex, mip=False):
                    if tex is None:
                        return -1
                    return self._combo_ids.get(
                        (id(tex), sh.h_addr, sh.v_addr, mip), -1)

                irows[ii, R.I_TEX_D] = rec_id(de.diffuse_texture,
                                              sh.mip_lod_enabled)
                irows[ii, R.I_TEX_N] = rec_id(de.normal_texture)
                irows[ii, R.I_TEX_S] = rec_id(de.specular_texture)
                irows[ii, R.I_TEX_D2] = rec_id(de.alt_texture)

            if de.viewport_rect is not None:
                irows[ii, R.I_VIEWPORT : R.I_VIEWPORT + 4] = de.viewport_rect
            if de.scissor_rect is not None:
                irows[ii, R.I_SCISSOR : R.I_SCISSOR + 4] = de.scissor_rect

            irows[ii, R.I_LMASK : R.I_LMASK + 2] = R.pack_mask(
                m.light_group_mask_bits)

            new_cache[id(inst)] = (ckey, irows[ii, R.I_MAT :].copy())

        self._row_cache = new_cache

        # Vectorized transform fill: batched 3x3 inverse-transpose for
        # the normal matrices. Singular transforms (scale-0 hidden
        # instances) fall back to identity normals instead of raising.
        if n_act:
            m3 = tfs[:, :3, :3]
            irows[:n_act, R.I_M3 : R.I_M3 + 9] = m3.reshape(n_act, 9)
            irows[:n_act, R.I_TR : R.I_TR + 3] = tfs[:, 3, :3]
            det = np.linalg.det(m3.astype(np.float64))
            ok = np.abs(det) > 1e-30
            safe = np.where(ok[:, None, None], m3, np.eye(3, dtype=np.float32))
            nm = np.linalg.inv(safe).transpose(0, 2, 1)
            irows[:n_act, R.I_NM3 : R.I_NM3 + 9] = nm.reshape(n_act, 9)
            irows[:n_act, R.I_PM3 : R.I_PM3 + 9] = ptfs[:, :3, :3].reshape(n_act, 9)
            irows[:n_act, R.I_PTR : R.I_PTR + 3] = ptfs[:, 3, :3]

        # Bake each instance's texture records (offset, w, h) into the
        # row (I_REC) so sampling needs no per-pixel record lookup.
        records = self._np["quad_records"]
        for j, col in enumerate((R.I_TEX_D, R.I_TEX_D2, R.I_TEX_N, R.I_TEX_S)):
            dst = slice(R.I_REC + 3 * j, R.I_REC + 3 * j + 3)
            if len(records) == 0:
                continue
            rid = irows[:, col].astype(np.int32)
            ok = rid >= 0
            vals = records[np.clip(rid, 0, len(records) - 1)].astype(np.float32)
            vals[~ok] = 0.0
            irows[:, dst] = vals

        # Light buffer capacity derives from the ACTUAL light count,
        # bucketed (powers of two from the limits floor).
        L = _next_bucket(max(len(larr), 1), lm.max_lights)
        lights = np.zeros((L, LIGHT_WIDTH), np.float32)
        count = min(len(larr), L)
        lights[:count] = larr[:count, :LIGHT_WIDTH]
        groups = np.zeros(L, np.uint32)
        groups[:count] = lgroups[:count]
        profiling.count_lights(pushed=count)

        rb_rows, rb_count = self._pack_raster(instances, raster_bg or [])
        rf_rows, rf_count = self._pack_raster(instances, raster_fg or [])

        if self._dev_quads is None:
            pool_np = self._np["quad_pool"]
            if pool_np.shape[0] % tex_ops.QPR == 0:
                pool_np = tex_ops.pack_pool_wide(pool_np)
            self._dev_quads = dict(
                quad_pool=self._up(pool_np.astype(np.int64)),
                quad_records=self._up(self._np["quad_records"]),
            )
        # Scene-wide feature summary (ShadeFeatures docstring), over the
        # raytraced instances: a raster instance never yields a ray hit.
        # (The JAX package also counts the raster ones, scene_buffers.py
        # :535-571, so a HUD with an alpha combiner turns on the
        # transparent-light pass of every frame.)
        raster_ids = {id(inst) for inst in (raster_bg or []) + (raster_fg or [])}
        has_nmap = has_smap = has_t1 = has_mips = has_lit_tl = False
        for inst in instances[:I]:
            if id(inst) in raster_ids:
                continue
            sh = inst.desc.shader
            if sh is None:
                continue
            if sh.normal_map_enabled and inst.desc.normal_texture is not None:
                has_nmap = True
            if sh.specular_map_enabled and inst.desc.specular_texture is not None:
                has_smap = True
            if sh.combiner.use_textures[1] and inst.desc.alt_texture is not None:
                has_t1 = True
            if sh.mip_lod_enabled and inst.desc.diffuse_texture is not None:
                has_mips = True
            # Conservative: lit + alpha-class + alpha not binarized
            # (texture_edge clamps hit alpha to {0, 1}).
            if (inst.desc.material.light_group_mask_bits != 0
                    and _alpha_class(sh, inst.desc.material)
                    and not sh.combiner.opt_texture_edge):
                has_lit_tl = True
        features = ShadeFeatures(
            has_alpha=self.alpha_triangle_count > 0,
            has_normal_maps=has_nmap,
            has_specular_maps=has_smap,
            has_texel1=has_t1,
            has_lit_transparent=has_lit_tl,
            has_mips=has_mips,
            has_raster_bg=rb_count > 0,
        )
        dev = self.device
        i32 = lambda v: profiling.upload(np.asarray(v, np.int32), dev)
        return SceneBuffers(
            **self._dev_geom,
            instance_rows=self._up(irows),
            lights=self._up(lights),
            light_count=i32(count),
            light_groups=i32(groups.view(np.int32)),
            **self._dev_quads,
            raster_bg=self._up(rb_rows),
            raster_bg_count=i32(rb_count),
            raster_fg=self._up(rf_rows),
            raster_fg_count=i32(rf_count),
            sky_plane=self._sky_dense,
            features=features,
            raster_host=RasterHost(
                bg=rb_rows[:rb_count], fg=rf_rows[:rf_count],
                instance_rows=irows, quad_records=records),
        )

    def _pack_raster(self, instances: List[Instance], raster_list):
        """Pack raster triangles (clip-space) into RR rows, in each
        mesh's index order; RR_INST indexes the combined instance list.
        More triangles than limits.raster_triangles raise: none is
        dropped."""
        cap = self.limits.raster_triangles
        if not raster_list:
            # Zero rows: the raster pass does not run at all.
            return np.zeros((0, RR_WIDTH), np.float32), 0
        drawn = [
            inst for inst in raster_list
            if inst.desc.mesh is not None and inst.desc.shader is not None
            and inst.desc.mesh.indices is not None
        ]
        total = sum(inst.desc.mesh.indices.shape[0] for inst in drawn)
        if total > cap:
            raise ValueError(
                f"{total} raster triangles in one layer exceed "
                f"SceneLimits.raster_triangles = {cap}; raise that limit"
            )
        rows = np.zeros((cap, RR_WIDTH), np.float32)
        count = 0
        for inst in drawn:
            ii = instances.index(inst)
            parsed = inst.desc.mesh.parsed_clip(inst.desc.shader.layout_key)
            tris = parsed["indices"]
            n = tris.shape[0]
            dst = rows[count : count + n]
            for k in range(3):
                vi = tris[:, k]
                dst[:, RR_POS + 4 * k : RR_POS + 4 * k + 4] = parsed["positions4"][vi]
                dst[:, RR_UV + 2 * k : RR_UV + 2 * k + 2] = parsed["uvs"][vi]
                dst[:, RR_IN1 + 4 * k : RR_IN1 + 4 * k + 4] = parsed["inputs"][vi, 0]
                dst[:, RR_IN2 + 4 * k : RR_IN2 + 4 * k + 4] = parsed["inputs"][vi, 1]
            dst[:, RR_INST] = ii
            count += n
        return rows, count
