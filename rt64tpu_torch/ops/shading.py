"""Batched hit shading over gathered triangle rows — planar layout.

The DXR surface any-hit emitted at rt64_shader.cpp:444-592 interpolates
vertex data, samples textures, runs the color combiner, applies
material/alpha rules, perturbs normals, and records motion flow. Here
the same math runs as ONE pass over every collected hit: one row gather
per hit (pipeline/rows.py) followed by planar tensor ops. The shadow
variant implements the shadow any-hit rules (rt64_shader.cpp:594-674).

shade_hits chooses by device: CPU tensors take the plain version,
shade_hits_plain; CUDA tensors launch the hand-written kernel,
tracer_cuda.hit_shade (csrc/hit_shade.cu), one launch a call where the
plain version issues ~500-830 ops, or raise. Nothing falls back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rt64tpu_torch.ops import raydiff
from rt64tpu_torch.ops import texture as tex_ops
from rt64tpu_torch.ops import tracer_cuda
from rt64tpu_torch.ops import vecmath as vm
from rt64tpu_torch.ops.combiner import combiner_eval_planar
from rt64tpu_torch.pipeline import rows as R
from rt64tpu_torch.utils import profiling


class HitShade(NamedTuple):
    color: torch.Tensor  # (4, M) combiner rgba after material rules
    normal: torch.Tensor  # (3, M) world shading normal (faces the ray)
    specular: torch.Tensor  # (3, M) vertexSpecular (map or 1)
    flow: torch.Tensor  # (3, M) world-space motion (cur - prev)
    instance: torch.Tensor  # (M,) int32, -1 for empty slots
    rows_t: torch.Tensor  # (TROW, M) the gathered rows (for extra columns)
    tri: torch.Tensor  # (M,) int32 triangle ids (-1 empty)


def shade_hits(
    sb,
    tri_rows,  # (T, TROW) packed triangle rows
    ray_dir,  # (3, M) ray directions (per hit point)
    tri,  # (M,) int32 triangle ids (-1 empty)
    bary_u,  # (M,)
    bary_v,  # (M,)
    noise_rand,  # (M,) per-pixel random for opt_noise
    shadow_variant: bool = False,
    mip_args=None,  # (t (M,), d_ddx (3, M), d_ddy (3, M)) camera-ray
    # differentials for ray-diff mip LOD on the diffuse fetch; consulted
    # only when the scene has mip-enabled instances (features.has_mips)
) -> HitShade:
    """Shade every hit lane: shade_hits_plain on CPU tensors, the
    hit_shade_kernel (tracer_cuda.hit_shade) on a CUDA device."""
    if tri.device.type == "cpu":
        profiling.count_launch("hit_shade_launches")
        return shade_hits_plain(sb, tri_rows, ray_dir, tri, bary_u, bary_v,
                                noise_rand, shadow_variant, mip_args)
    planes = tracer_cuda.hit_shade(sb, tri_rows, ray_dir, tri, bary_u, bary_v,
                                   noise_rand, shadow_variant, mip_args)
    return HitShade(*planes, tri=tri)


def shade_hits_plain(sb, tri_rows, ray_dir, tri, bary_u, bary_v, noise_rand,
                     shadow_variant: bool = False, mip_args=None) -> HitShade:
    """The plain version of shade_hits: planar torch ops, on any device
    (the kernel's yardstick on the card)."""
    valid = tri >= 0
    tri_s = torch.clamp(tri, min=0).to(torch.int64)
    gt = tri_rows[tri_s].T  # (TROW, M) — THE gather

    u = bary_u
    v = bary_v
    w0 = 1.0 - u - v

    p0 = gt[R.T_P0 : R.T_P0 + 3]
    p1 = gt[R.T_P1 : R.T_P1 + 3]
    p2 = gt[R.T_P2 : R.T_P2 + 3]
    n0 = gt[R.T_N0 : R.T_N0 + 3]
    n1 = gt[R.T_N1 : R.T_N1 + 3]
    n2 = gt[R.T_N2 : R.T_N2 + 3]

    pos = p0 * w0 + p1 * u + p2 * v  # world hit position (interp)
    n_interp = n0 * w0 + n1 * u + n2 * v
    uv_u = gt[R.T_UV] * w0 + gt[R.T_UV + 2] * u + gt[R.T_UV + 4] * v
    uv_v = gt[R.T_UV + 1] * w0 + gt[R.T_UV + 3] * u + gt[R.T_UV + 5] * v

    def interp_rgba(base):
        return torch.stack(
            [
                gt[base + c] * w0 + gt[base + 4 + c] * u + gt[base + 8 + c] * v
                for c in range(4)
            ],
            dim=0,
        )

    in1 = interp_rgba(R.T_IN1)
    in2 = interp_rgba(R.T_IN2)
    zero4 = torch.stack([torch.zeros_like(u)] * 3 + [torch.ones_like(u)], 0)

    # Geometric normal -cross(p2-p0, p1-p0) = cross(e1, e2)
    # (rt64_shader.cpp:176), world space.
    e1 = p1 - p0
    e2 = p2 - p0
    tri_nrm = vm.cross(e1, e2)

    # Vertex normal with face-normal fallback (rt64_shader.cpp:177).
    interp_zero = torch.all(n_interp == 0.0, dim=0)
    normal = torch.where(interp_zero[None], tri_nrm, n_interp)
    normal = vm.normalize(normal)
    normal_preflip = normal
    normal_sign = torch.where(vm.dot(tri_nrm, ray_dir) <= 0.0, 1.0, -1.0)
    normal = normal * normal_sign[None]

    # --- flags / sampler / combiner ---------------------------------------
    flags = gt[R.T_FLAGS].to(torch.int32)
    fl = lambda bit: (flags & bit) != 0
    sampler = gt[R.T_SAMPLER].to(torch.int32)
    filt = (sampler & 3) == 1
    h_addr = (sampler >> 2) & 3
    v_addr = (sampler >> 4) & 3
    cc_items = R.unpack_cc(gt[R.T_CC]).T  # (8, M)
    mat = lambda off: gt[R.T_MAT + off]

    # Record fields ride the row (T_REC) — no per-pixel records gather.
    rec_cols = lambda j: (
        gt[R.T_REC + 3 * j], gt[R.T_REC + 3 * j + 1], gt[R.T_REC + 3 * j + 2]
    )
    use_t0 = fl(R.F_USE_T0)
    ok_t0 = use_t0 & valid & (gt[R.T_TEX_D] >= 0.0)
    d_off, d_w, d_h = rec_cols(0)
    feat = sb.features
    if mip_args is not None and feat.has_mips and not shadow_variant:
        # Ray-diff mip LOD (Ray.hlsli:37-94 + the SampleGrad call the
        # reference makes with its mips compiled out,
        # rt64_shader.cpp:474-480). Nearest-level selection keeps the
        # fetch at one pool lookup; the quad entries give the in-level
        # bilinear.
        t_hit, d_ddx, d_ddy = mip_args
        uv0 = torch.stack([gt[R.T_UV], gt[R.T_UV + 1]], 0)
        uv1 = torch.stack([gt[R.T_UV + 2], gt[R.T_UV + 3]], 0)
        uv2 = torch.stack([gt[R.T_UV + 4], gt[R.T_UV + 5]], 0)
        duv_dx, duv_dy = raydiff.uv_differentials(
            d_ddx, d_ddy, ray_dir, t_hit, e1, e2, tri_nrm, uv0, uv1, uv2
        )
        lod = raydiff.lod_from_duv(
            duv_dx, duv_dy, d_w, d_h,
            max_level=float(tex_ops.MAX_MIP_LEVELS - 1),
        )
        level = torch.where(
            fl(R.F_MIP_LOD) & valid, torch.round(lod).to(torch.int32), 0
        )
        d_off, d_w, d_h = tex_ops.mip_select(
            d_off.to(torch.int32), d_w.to(torch.int32), d_h.to(torch.int32),
            level,
        )
    tex0 = tex_ops.sample_quad_cols(
        sb.quad_pool, d_off, d_w, d_h, ok_t0, uv_u, uv_v, filt, h_addr,
        v_addr,
    )
    mix_r = mat(R.M_DIFFUSE_MIX)
    mix_g = mat(R.M_DIFFUSE_MIX + 1)
    mix_b = mat(R.M_DIFFUSE_MIX + 2)
    mix_a = mat(R.M_DIFFUSE_MIX + 3)
    if not shadow_variant:
        # Negative mix applies before the combiner (rt64_shader.cpp:481).
        neg = torch.clamp(-mix_a, min=0.0)
        mix_rgb = torch.stack([mix_r, mix_g, mix_b], 0)
        tex0 = torch.cat(
            [tex0[:3] * (1.0 - neg)[None] + mix_rgb * neg[None], tex0[3:4]], 0
        )
    # TEXEL1: a real second texture binding where the reference stubs it
    # to magenta (rt64_shader.cpp:484-487). Instances without an alt
    # texture keep the magenta value; the fetch is skipped when the
    # scene binds no alt texture (sb.features).
    magenta = torch.stack(
        [torch.ones_like(u), torch.zeros_like(u), torch.ones_like(u),
         torch.ones_like(u)], 0
    )
    if not feat.has_texel1:
        tex1 = magenta
    else:
        use_t1 = fl(R.F_USE_T1)
        ok_t1 = use_t1 & valid & (gt[R.T_TEX_D2] >= 0.0)
        d2_off, d2_w, d2_h = rec_cols(1)
        samp = tex_ops.sample_quad_cols(
            sb.quad_pool, d2_off, d2_w, d2_h, ok_t1, uv_u, uv_v, filt,
            h_addr, v_addr,
        )
        tex1 = torch.where(ok_t1[None], samp, magenta)

    color = combiner_eval_planar(
        cc_items, fl(R.F_OPT_ALPHA), fl(R.F_ALPHA_SAME),
        in1, in2, zero4, zero4, tex0, tex1,
    )

    opt_edge = fl(R.F_TEXTURE_EDGE)
    opt_noise = fl(R.F_NOISE)
    instance = torch.where(valid, gt[R.T_INST].to(torch.int32), -1)

    if shadow_variant:
        # Shadow any-hit rules (rt64_shader.cpp:611-662): only opt_alpha
        # combiners attenuate; everything else fully occludes.
        opt_alpha = fl(R.F_OPT_ALPHA)
        alpha = torch.clamp(color[3] * mat(R.M_SHADOW_ALPHA), 0.0, 1.0)
        alpha = torch.where(
            opt_edge, torch.where(alpha > 0.3, 1.0, 0.0), alpha
        )
        alpha = torch.where(opt_noise, alpha * torch.round(noise_rand), alpha)
        alpha = torch.where(opt_alpha, alpha, 1.0)
        alpha = torch.where(valid, alpha, 0.0)
        zeros3 = torch.zeros_like(normal)
        return HitShade(
            color=torch.cat([color[:3], alpha[None]], 0),
            normal=zeros3, specular=zeros3, flow=zeros3,
            instance=instance, rows_t=gt, tri=tri,
        )

    # Positive diffuse mix after the combiner (rt64_shader.cpp:497).
    pos_mix = torch.clamp(mix_a, min=0.0)
    mix_rgb = torch.stack([mix_r, mix_g, mix_b], 0)
    rgb = color[:3] * (1.0 - pos_mix)[None] + mix_rgb * pos_mix[None]
    alpha = torch.clamp(color[3] * mat(R.M_SOLID_ALPHA), 0.0, 1.0)
    # TEXTURE_EDGE binarizes at 0.3; rejected hits contribute alpha 0
    # (rt64_shader.cpp:502-511).
    alpha = torch.where(opt_edge, torch.where(alpha > 0.3, 1.0, 0.0), alpha)
    alpha = torch.where(opt_noise, alpha * torch.round(noise_rand), alpha)
    alpha = torch.where(valid, alpha, 0.0)

    # --- normal mapping (rt64_shader.cpp:522-533) ---------------------------
    uv_scale = mat(R.M_UV_DETAIL)
    if feat.has_normal_maps:
        do_nmap = fl(R.F_NORMAL_MAP) & (gt[R.T_TEX_N] >= 0.0) & valid
        tangent, binormal = tangent_binormal(gt, normal_preflip)
        tangent = tangent * normal_sign[None]
        binormal = binormal * normal_sign[None]
        n_off, n_w, n_h = rec_cols(2)
        nmap = tex_ops.sample_quad_cols(
            sb.quad_pool, n_off, n_w, n_h, do_nmap,
            uv_u * uv_scale, uv_v * uv_scale, filt, h_addr, v_addr,
        )
        ncol = nmap[:3] * 2.0 - 1.0
        perturbed = vm.normalize(
            normal * ncol[2][None] + tangent * ncol[0][None]
            + binormal * ncol[1][None]
        )
        normal = torch.where(do_nmap[None], perturbed, normal)

    # --- specular map (rt64_shader.cpp:539-545) -----------------------------
    ones3 = torch.ones((3, u.shape[0]), device=u.device)
    if feat.has_specular_maps:
        do_smap = fl(R.F_SPECULAR_MAP) & (gt[R.T_TEX_S] >= 0.0) & valid
        s_off, s_w, s_h = rec_cols(3)
        smap = tex_ops.sample_quad_cols(
            sb.quad_pool, s_off, s_w, s_h, do_smap,
            uv_u * uv_scale, uv_v * uv_scale, filt, h_addr, v_addr,
        )
        specular = torch.where(do_smap[None], smap[:3], ones3)
    else:
        specular = ones3

    # --- motion flow (rt64_shader.cpp:535-537) -------------------------------
    pp0 = gt[R.T_PP0 : R.T_PP0 + 3]
    pp1 = gt[R.T_PP1 : R.T_PP1 + 3]
    pp2 = gt[R.T_PP2 : R.T_PP2 + 3]
    prev_pos = pp0 * w0 + pp1 * u + pp2 * v
    flow = pos - prev_pos

    vmask = valid[None]
    return HitShade(
        color=torch.where(vmask, torch.cat([rgb, alpha[None]], 0), 0.0),
        normal=torch.where(vmask, normal, 0.0),
        specular=torch.where(vmask, specular, 0.0),
        flow=torch.where(vmask, flow, 0.0),
        instance=instance,
        rows_t=gt,
        tri=tri,
    )


def compact_indices(mask, capacity: int):
    """Ray compaction: indices of True lanes, front-packed.

    Returns (idx (capacity,) int64 — source positions of the first
    `capacity` set lanes, padded with n; count — total set lanes, a 0-d
    tensor). Lanes beyond capacity are DROPPED (callers surface the
    count). The pad value n is out of range on purpose: every consumer
    clamps it (`min(idx, n - 1)`) or masks it (`idx < n`)."""
    n = mask.shape[0]
    k = min(capacity, n)
    key = torch.where(mask, torch.arange(n, device=mask.device), n)
    idx = torch.topk(key, k, largest=False, sorted=True).values
    if k < capacity:
        idx = torch.cat([idx, torch.full((capacity - k,), n, device=mask.device)])
    return idx, mask.sum()


def shade_hits_compacted(
    sb, tri_rows, ray_dir, tri, bary_u, bary_v, noise_rand,
    capacity: int, shadow_variant: bool = False,
):
    """shade_hits over ONLY the rays that hit, written back full-width.

    Hits beyond `capacity` are dropped and their count is RETURNED;
    callers surface it (FrameOutputs.alpha_dropped) and the view grows
    the capacity. Returns (HitShade, dropped 0-d tensor). Miss lanes'
    rows_t columns are zero; all consumers mask by hit validity."""
    n = tri.shape[0]
    dev = tri.device
    mask = tri >= 0
    idx, count = compact_indices(mask, capacity)
    safe = torch.clamp(idx, max=n - 1)
    live = idx < n

    tri_c = torch.where(live, tri[safe], -1)
    sh_c = shade_hits(
        sb, tri_rows, ray_dir[:, safe], tri_c, bary_u[safe], bary_v[safe],
        noise_rand[safe], shadow_variant=shadow_variant,
    )
    dropped = torch.clamp(count - capacity, min=0)
    # Pad lanes (idx == n) are dropped from the write-back.
    dst = idx[live]

    if shadow_variant:
        # Shadow rays only consume the occlusion alpha.
        alpha = torch.zeros((n,), device=dev)
        alpha[dst] = sh_c.color[3][live]
        z3 = torch.zeros((3, n), device=dev)
        sh = HitShade(
            color=torch.cat([z3, alpha[None]], 0),
            normal=z3, specular=z3, flow=z3,
            instance=torch.full((n,), -1, dtype=torch.int32, device=dev),
            rows_t=torch.zeros((R.TROW, n), device=dev),
            tri=torch.full((n,), -1, dtype=torch.int32, device=dev),
        )
        return sh, dropped

    def back(plane, fill):
        out = torch.full(plane.shape[:-1] + (n,), fill, dtype=plane.dtype,
                         device=dev)
        out[..., dst] = plane[..., live]
        return out

    sh = HitShade(
        color=back(sh_c.color, 0.0),
        normal=back(sh_c.normal, 0.0),
        specular=back(sh_c.specular, 0.0),
        flow=back(sh_c.flow, 0.0),
        instance=back(sh_c.instance, -1),
        rows_t=back(sh_c.rows_t, 0.0),
        tri=back(tri_c.to(torch.int32), -1),
    )
    return sh, dropped


def tangent_binormal(gt, vertex_normal):
    """Tangent + binormal (rt64_shader.cpp:201-225), world space, planar.

    UV-derived tangent with degenerate fallbacks; binormal handedness
    from UV winding (rt64_shader.cpp:218-224).
    """
    p0 = gt[R.T_P0 : R.T_P0 + 3]
    p1 = gt[R.T_P1 : R.T_P1 + 3]
    p2 = gt[R.T_P2 : R.T_P2 + 3]
    u0, v0 = gt[R.T_UV], gt[R.T_UV + 1]
    u1, v1 = gt[R.T_UV + 2], gt[R.T_UV + 3]
    u2, v2 = gt[R.T_UV + 4], gt[R.T_UV + 5]
    uva = u1 - u0
    uvb = u2 - u0
    uvc = v1 - v0
    uvd = v2 - v0
    uvk = uvb * uvc - uva * uvd
    dpos1 = p1 - p0
    dpos2 = p2 - p0
    t_main = vm.normalize(dpos2 * uvc[None] - dpos1 * uvd[None])
    t_a = vm.normalize(dpos1)
    t_b = vm.normalize(dpos2)
    tangent = torch.where(
        (uvk != 0.0)[None],
        t_main,
        torch.where(
            (uva != 0.0)[None], t_a,
            torch.where((uvb != 0.0)[None], t_b, torch.zeros_like(t_a)),
        ),
    )
    # cross(float3(duv1, 0), float3(duv2, 0)).z with both y negated.
    d1u, d1v = u1 - u0, -(v1 - v0)
    d2u, d2v = u2 - u1, -(v2 - v1)
    crz = d1u * d2v - d1v * d2u
    binormal_mult = torch.where(crz < 0.0, -1.0, 1.0)
    binormal = vm.cross(tangent, vertex_normal) * binormal_mult[None]
    return tangent, binormal


def build_tri_rows(sb):
    """Per-frame world-space triangle rows — the TLAS-rebuild/BLAS-refit
    analog (driver builds at rt64_view.cpp:412-452, rt64_mesh.cpp:114-158).

    Gathers vertex rows per corner and instance rows per triangle,
    transforms to world space (row-vector convention), and lays out the
    TROW columns. Returns (tri_rows (T, TROW), rows_t (TROW, T)).
    """
    tri_idx = sb.tri_idx.to(torch.int64)
    vr = [sb.vertex_rows[tri_idx[:, k]].T for k in range(3)]  # (VROW, T) x3
    it = sb.instance_rows[sb.tri_instance.to(torch.int64)].T  # (IROW, T)

    m3 = it[R.I_M3 : R.I_M3 + 9]
    tr = it[R.I_TR : R.I_TR + 3]
    nm3 = it[R.I_NM3 : R.I_NM3 + 9]
    pm3 = it[R.I_PM3 : R.I_PM3 + 9]
    ptr = it[R.I_PTR : R.I_PTR + 3]

    parts = []
    for k in range(3):
        p = vr[k][R.V_POS : R.V_POS + 3]
        parts.append(vm.mat3_apply(m3, p) + tr)
    for k in range(3):
        n = vr[k][R.V_NRM : R.V_NRM + 3]
        parts.append(vm.mat3_apply(nm3, n))
    # uv interleaved u0 v0 u1 v1 u2 v2
    parts.append(
        torch.stack(
            [vr[0][R.V_UV], vr[0][R.V_UV + 1], vr[1][R.V_UV], vr[1][R.V_UV + 1],
             vr[2][R.V_UV], vr[2][R.V_UV + 1]], 0,
        )
    )
    for base in (R.V_IN1, R.V_IN2):
        parts.append(torch.cat([vr[k][base : base + 4] for k in range(3)], 0))
    for k in range(3):
        p = vr[k][R.V_POS : R.V_POS + 3]
        parts.append(vm.mat3_apply(pm3, p) + ptr)
    parts.append(sb.tri_instance.to(torch.float32)[None])
    parts.append(it[R.I_MAT : R.I_MAT + R.M_WIDTH])
    parts.append(it[R.I_CC][None])
    parts.append(it[R.I_FLAGS][None])
    parts.append(it[R.I_TEX_D][None])
    parts.append(it[R.I_TEX_N][None])
    parts.append(it[R.I_TEX_S][None])
    parts.append(it[R.I_SAMPLER][None])
    parts.append(it[R.I_LMASK : R.I_LMASK + 2])
    parts.append(it[R.I_INPUT_COUNT][None])
    parts.append(it[R.I_TEX_D2][None])
    parts.append(it[R.I_REC : R.I_REC + 12])
    rows_t = torch.cat(parts, dim=0)
    assert rows_t.shape[0] == R.TROW, rows_t.shape
    return rows_t.T.contiguous(), rows_t
