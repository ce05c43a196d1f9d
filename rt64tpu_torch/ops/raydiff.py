"""Igehy ray differentials (Ray.hlsli:37-94) driving texture LOD.

The reference propagates ray differentials through hits to drive
SampleGrad texture LOD (rt64_shader.cpp:474-480), but its mip pass is
compiled out (rt64_device.cpp:758-762), so the gradients never change
the sampled level. Here the same math is live behind the opt-in
SHADER_MIP_LOD_ENABLED flag: primary-hit shading calls uv_differentials
and texture.mip_select picks the baked mip level. Planar layout: vectors
are (3, N), uv pairs (2, N).
"""

from __future__ import annotations

import torch

from rt64tpu_torch.ops import vecmath as vm


def compute_ray_diffs(non_norm_dir, camera_right, camera_up, viewport_wh):
    """computeRayDiffs (Ray.hlsli:40-49): camera-ray direction
    differentials. non_norm_dir: (3, N); camera_right/up: (3,)."""
    r = camera_right.reshape(3, 1)
    u = camera_up.reshape(3, 1)
    dd = vm.dot(non_norm_dir, non_norm_dir)
    divd = 2.0 / (dd * torch.sqrt(dd))
    dr = vm.dot(non_norm_dir, r)
    du = vm.dot(non_norm_dir, u)
    d_dx = (r * dd[None] - non_norm_dir * dr[None]) * divd[None] / viewport_wh[0]
    d_dy = -(u * dd[None] - non_norm_dir * du[None]) * divd[None] / viewport_wh[1]
    return d_dx, d_dy


def propagate(d_odx, d_ody, d_ddx, d_ddy, direction, t, normal):
    """propagateRayDiffs (Ray.hlsli:51-66): transfer to a hit plane."""
    dodx = d_odx + d_ddx * t[None]
    dody = d_ody + d_ddy * t[None]
    rcp_dn = 1.0 / vm.dot(direction, normal)
    dtdx = -vm.dot(dodx, normal) * rcp_dn
    dtdy = -vm.dot(dody, normal) * rcp_dn
    return dodx + direction * dtdx[None], dody + direction * dtdy[None]


def barycentric_differentials(d_odx, d_ody, edge01, edge02, face_normal):
    """computeBarycentricDifferentials (Ray.hlsli:68-78)."""
    nu = vm.cross(edge02, face_normal)
    nv = vm.cross(edge01, face_normal)
    lu = nu / vm.dot(nu, edge01)[None]
    lv = nv / vm.dot(nv, edge02)[None]
    return (
        (vm.dot(lu, d_odx), vm.dot(lv, d_odx)),
        (vm.dot(lu, d_ody), vm.dot(lv, d_ody)),
    )


def texture_differentials(dbary_dx, dbary_dy, uv0, uv1, uv2):
    """computeTextureDifferentials (Ray.hlsli:88-94). uv*: (2, N)."""
    uv01 = uv1 - uv0
    uv02 = uv2 - uv0
    duv_dx = uv01 * dbary_dx[0][None] + uv02 * dbary_dx[1][None]
    duv_dy = uv01 * dbary_dy[0][None] + uv02 * dbary_dy[1][None]
    return duv_dx, duv_dy


def uv_differentials(d_ddx, d_ddy, ray_dir, t, edge01, edge02,
                     face_normal, uv0, uv1, uv2):
    """Per-hit screen-space UV derivatives for a camera ray.

    The three steps above for the primary-hit case (d_odx = d_ody = 0 at
    the camera): transfer the direction differentials d_ddx/d_ddy (3, N)
    to the hit plane at parameter `t` (in units of `ray_dir`, which may
    be non-normalized: the reference traces the same non-normalized
    camera dirs, PrimaryRayGen.hlsl:40), then through barycentrics to UV
    space. Returns (duv_dx, duv_dy), each (2, N). The face_normal scale
    cancels in every ratio, so the raw cross-product normal serves.

    d_ddx/d_ddy are differentials of the NORMALIZED direction
    (computeRayDiffs), so the transfer runs on the normalized dir with t
    converted to world units.
    """
    dlen = torch.sqrt(torch.clamp(vm.dot(ray_dir, ray_dir), min=1e-20))
    d_unit = ray_dir / dlen[None]
    zeros = torch.zeros_like(d_ddx)
    dodx, dody = propagate(
        zeros, zeros, d_ddx, d_ddy, d_unit, t * dlen, face_normal
    )
    dbx, dby = barycentric_differentials(dodx, dody, edge01, edge02,
                                         face_normal)
    return texture_differentials(dbx, dby, uv0, uv1, uv2)


def lod_from_duv(duv_dx, duv_dy, wf, hf, max_level=None):
    """Mip LOD from UV derivatives and the level-0 texel dims: the D3D
    SampleGrad rule log2(max texel-space footprint axis). Returns f32
    (N,) >= 0."""
    fx = (duv_dx[0] * wf) ** 2 + (duv_dx[1] * hf) ** 2
    fy = (duv_dy[0] * wf) ** 2 + (duv_dy[1] * hf) ** 2
    lod = 0.5 * torch.log2(torch.clamp(torch.maximum(fx, fy), min=1e-20))
    lod = torch.clamp(lod, min=0.0)
    if max_level is not None:
        lod = torch.clamp(lod, max=max_level)
    return lod
