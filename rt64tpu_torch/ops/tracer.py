"""Wavefront ray tracer — the plain-torch reference path.

Replaces DXR's driver traversal + any-hit callbacks (TraceRay with
RAY_FLAG_FORCE_NON_OPAQUE and the emitted insertion sort at
rt64_shader.cpp:547-581):

  * The closest *opaque-class* hit is a masked min-reduction over
    triangle chunks. A triangle is opaque-class when its evaluated
    combiner alpha is guaranteed 1; classification happens in scene
    assembly.
  * *Alpha-class* triangles (foliage, decals) are compacted into a dense
    side list each frame; only that list feeds the K-ordered hit
    collection (K = MAX_HIT_QUERIES analog, GlobalHitBuffers.hlsli:8),
    sorted by depth-biased t like the reference's per-pixel insertion
    sort (WithDistanceBias, Instances.hlsli).
  * Shading/alpha evaluation happens afterwards in one batched pass
    (ops/shading.py).

The packet tracer (ops/tracer_cuda.py) drops in through the opaque_fn
hook; this module is its oracle and carries the alpha path, whose
K-hit sweep runs on the card as tracer_cuda.alpha_sweep's kernel
(_alpha_sweep_plain is its twin).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rt64tpu_torch.utils import profiling

RAY_MIN_DISTANCE = 0.1  # Ray.hlsli:8
RAY_MAX_DISTANCE = 100000.0  # Ray.hlsli:9
# Adjacent rays per interval bundle of the alpha cull (_slab_any_bundled).
_CULL_BUNDLE = 8
_BIG = 3.0e37


class TraceScene(NamedTuple):
    """Flattened world-space triangle soup, planar.

    `has_alpha` is host knowledge: True/False selects the alpha path
    once per frame, never per ray.
    """

    v0: torch.Tensor  # (3, T) world corner 0 components
    v1: torch.Tensor  # (3, T)
    v2: torch.Tensor  # (3, T)
    valid: torch.Tensor  # (T,) bool — padding is False
    alpha: torch.Tensor  # (T,) bool — alpha-class (needs any-hit evaluation)
    no_cull: torch.Tensor  # (T,) bool — instance disables backface culling
    bias: torch.Tensor  # (T,) float — per-instance depthBias sort bias
    alpha_idx: torch.Tensor  # (A,) int64 — compacted alpha triangle ids, -1 pad
    has_alpha: Optional[bool] = None

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[1]


def compact_alpha(valid, alpha, capacity: int):
    """Dense list of alpha-class triangle indices (padded with -1), of
    length min(capacity, T)."""
    is_alpha = valid & alpha
    order = torch.argsort((~is_alpha).to(torch.int8), stable=True)
    idx = order[:capacity]
    return torch.where(is_alpha[idx], idx, -1)


def _expand10(v):
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def sort_alpha_spatial(alpha_idx, v0, v1, v2):
    """Reorder the compacted alpha list by Morton code of the triangle
    centroid (world space), so each alpha cull chunk stays spatially
    tight. -1 pads sort to the end (key 0xFFFFFFFF)."""
    live = alpha_idx >= 0
    safe = torch.clamp(alpha_idx, min=0)
    c = (v0[:, safe] + v1[:, safe] + v2[:, safe]) * (1.0 / 3.0)  # (3, A)
    lo = torch.where(live[None], c, _BIG).amin(dim=1)
    hi = torch.where(live[None], c, -_BIG).amax(dim=1)
    ext = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp(
        (c - lo[:, None]) / ext[:, None] * 1023.0, 0.0, 1023.0
    ).to(torch.int64)
    code = (_expand10(q[0]) << 2) | (_expand10(q[1]) << 1) | _expand10(q[2])
    key = torch.where(live, code, 0xFFFFFFFF)
    return alpha_idx[torch.argsort(key, stable=True)]


class Hits(NamedTuple):
    """Trace output: closest opaque hit + K nearest alpha-class hits."""

    t_op: torch.Tensor  # (N,) unbiased t of the opaque hit (BIG when none)
    tri_op: torch.Tensor  # (N,) triangle index, -1 when none
    uv_op: torch.Tensor  # (N, 2) barycentrics of the opaque hit
    t_a: torch.Tensor  # (N, K) biased-sorted, unbiased t values (BIG pad)
    tri_a: torch.Tensor  # (N, K) triangle indices, -1 pad
    uv_a: torch.Tensor  # (N, K, 2)
    alpha_dropped: torch.Tensor  # () — rays culled past the alpha
    # compaction capacity; 0 when exact


class _Rays(NamedTuple):
    """SoA ray bundle: each component (N, 1)."""

    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    t_min: torch.Tensor
    t_max: torch.Tensor

    @staticmethod
    def of(origins, dirs, t_min, t_max) -> "_Rays":
        """origins/dirs: planar (3, N)."""
        return _Rays(
            ox=origins[0][:, None], oy=origins[1][:, None], oz=origins[2][:, None],
            dx=dirs[0][:, None], dy=dirs[1][:, None], dz=dirs[2][:, None],
            t_min=t_min[:, None], t_max=t_max[:, None],
        )


def _intersect_soa(r: _Rays, c0, c1, c2, no_cull, cull_backface: bool):
    """Moller-Trumbore, SoA: rays (N,1 planes) x tris (3,C) -> (N,C).

    Front face matches the reference's geometric normal convention
    (triangleNormal = -cross(p2-p0, p1-p0), rt64_shader.cpp:176): a
    triangle is front-facing when det > 0.

    Returns (t, u, v, hit).
    """
    eps = 1e-9
    row = lambda m, i: m[i][None, :]  # (1, C)
    e1x = row(c1, 0) - row(c0, 0)
    e1y = row(c1, 1) - row(c0, 1)
    e1z = row(c1, 2) - row(c0, 2)
    e2x = row(c2, 0) - row(c0, 0)
    e2y = row(c2, 1) - row(c0, 1)
    e2z = row(c2, 2) - row(c0, 2)
    # pvec = dir x e2
    px = r.dy * e2z - r.dz * e2y
    py = r.dz * e2x - r.dx * e2z
    pz = r.dx * e2y - r.dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    if cull_backface:
        keep = torch.where(no_cull[None, :], torch.abs(det) > eps, det > eps)
    else:
        keep = torch.abs(det) > eps
    inv_det = 1.0 / torch.where(keep, det, 1.0)
    tx = r.ox - row(c0, 0)
    ty = r.oy - row(c0, 1)
    tz = r.oz - row(c0, 2)
    u = (tx * px + ty * py + tz * pz) * inv_det
    # qvec = tvec x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (
        keep & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t >= r.t_min) & (t <= r.t_max)
    )
    return t, u, v, hit


def trace_opaque(
    origins, dirs, t_min, t_max, scene: TraceScene,
    cull_backface: bool = True, chunk: int = 512,
):
    """Closest opaque-class hit: masked min-reduce over triangle chunks.

    origins/dirs: planar (3, N). Returns (t_biased, tri, uv): tri = -1
    for miss; t is the *biased* sort key (caller unbias via scene.bias).
    Ties: within a chunk the largest id among equal keys, across chunks
    the earlier chunk (strict <) — the JAX reference's rule.
    """
    n = origins.shape[1]
    dev = origins.device
    t_total = scene.num_triangles
    chunk = min(chunk, t_total)
    assert t_total % chunk == 0, (t_total, chunk)
    rays = _Rays.of(origins, dirs, t_min, t_max)
    col = torch.arange(chunk, device=dev)[None, :]

    t_op = torch.full((n,), _BIG, device=dev)
    tri_op = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for s in range(0, t_total, chunk):
        sl = slice(s, s + chunk)
        t, u, v, hit = _intersect_soa(
            rays, scene.v0[:, sl], scene.v1[:, sl], scene.v2[:, sl],
            scene.no_cull[sl], cull_backface,
        )
        hit = hit & (scene.valid[sl] & ~scene.alpha[sl])[None, :]
        key = torch.where(hit, t - scene.bias[sl][None, :], _BIG)
        best = key.amin(dim=1)
        idx = torch.where(key <= best[:, None], s + col, -1).amax(dim=1)
        better = best < t_op
        t_op = torch.where(better, best, t_op)
        tri_op = torch.where(better, idx, tri_op)
    tri_op = torch.where(t_op < _BIG * 0.5, tri_op, -1)
    uv_op = _reintersect_uv(rays, scene, tri_op)
    return t_op, tri_op, uv_op


def _reintersect_uv(rays: _Rays, scene: TraceScene, tri):
    """Barycentrics of a known hit triangle per ray: gather its corners
    and redo the Moller-Trumbore uv math."""
    tri_s = torch.clamp(tri, min=0)
    c0 = scene.v0[:, tri_s]  # (3, N)
    c1 = scene.v1[:, tri_s]
    c2 = scene.v2[:, tri_s]
    return _uv_from_corners(rays, c0, c1, c2, tri)


def _uv_from_corners(rays: _Rays, c0, c1, c2, tri):
    e1 = c1 - c0
    e2 = c2 - c0
    dx, dy, dz = rays.dx[:, 0], rays.dy[:, 0], rays.dz[:, 0]
    px = dy * e2[2] - dz * e2[1]
    py = dz * e2[0] - dx * e2[2]
    pz = dx * e2[1] - dy * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1.0)
    tx = rays.ox[:, 0] - c0[0]
    ty = rays.oy[:, 0] - c0[1]
    tz = rays.oz[:, 0] - c0[2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    ok = tri >= 0
    return torch.stack([torch.where(ok, u, 0.0), torch.where(ok, v, 0.0)], dim=-1)


def _extract_k_smallest(key, ids, k: int, payloads=()):
    """K smallest (key, id) pairs per row, ascending, from min/max
    reduces and masked selects. Among equal keys the LARGEST COLUMN is
    taken first.

    key: (N, M) float; ids: (1, M) or (N, M) int triangle ids.
    payloads: extra (N, M) float arrays extracted at the same columns.
    Returns (t (N, K) ascending, tri (N, K), *payloads (N, K)),
    -1/_BIG/0 padded.
    """
    m = key.shape[1]
    col = torch.arange(m, device=key.device)[None, :]
    ids = torch.broadcast_to(ids, key.shape)
    ts, tris = [], []
    pls = [[] for _ in payloads]
    for _ in range(k):
        best = key.amin(dim=1)
        sel = key <= best[:, None]
        # Choose one column (max col among ties), then read ITS id and
        # mask exactly that column out — ids and mask must agree.
        csel = torch.where(sel, col, -1).amax(dim=1)
        at = col == csel[:, None]
        tri = torch.where(at, ids, -1).amax(dim=1)
        miss = best >= _BIG * 0.5
        ts.append(torch.where(miss, _BIG, best))
        tris.append(torch.where(miss, -1, tri))
        for acc, p in zip(pls, payloads):
            pv = torch.where(at, p, -_BIG).amax(dim=1)
            acc.append(torch.where(miss, 0.0, pv))
        key = torch.where(at, _BIG, key)
    return (torch.stack(ts, dim=1), torch.stack(tris, dim=1),
            *[torch.stack(acc, dim=1) for acc in pls])


def trace_alpha(
    origins, dirs, t_min, t_max, scene: TraceScene, k_alpha: int,
    cull_backface: bool, chunk: int = 256, compact_capacity: int = 0,
):
    """K nearest alpha-class hits over the compacted alpha list.

    Returns (t_biased (N,K) sorted, tri (N,K), uv (N,K,2), bias (N,K),
    dropped). With compact_capacity > 0 the sweep is CULLED + COMPACTED:
    each ray slab-tests the alpha list's 128-triangle chunk boxes, and
    only the rays whose segment can touch alpha geometry run the sweep.
    Rays beyond the capacity are dropped and counted.
    """
    n = origins.shape[1]
    dev = origins.device
    k = k_alpha
    a_cap = scene.alpha_idx.shape[0]
    if compact_capacity and 0 < compact_capacity < n and a_cap >= 128:
        from rt64tpu_torch.ops.shading import compact_indices

        lo_c, hi_c = _alpha_chunk_aabbs(scene)
        hit_c, _ = slab_per_ray(origins, dirs, t_min, t_max, lo_c, hi_c)
        ray_mask = hit_c.any(dim=1)

        idx, count = compact_indices(ray_mask, compact_capacity)
        safe_r = torch.clamp(idx, max=n - 1)
        live_r = idx < n
        o_c = origins[:, safe_r]
        d_c = dirs[:, safe_r]
        tmin_c = t_min[safe_r]
        tmax_c = torch.where(live_r, t_max[safe_r], tmin_c - 1.0)
        t_cc, tri_cc, uv_cc, b_cc = _alpha_sweep(
            o_c, d_c, tmin_c, tmax_c, scene, k, cull_backface, chunk
        )
        dst = idx[live_r]

        def back(vals, fill):
            out = torch.full((n,) + vals.shape[1:], fill, dtype=vals.dtype,
                             device=dev)
            out[dst] = vals[live_r]
            return out

        return (back(t_cc, _BIG), back(tri_cc, -1), back(uv_cc, 0.0),
                back(b_cc, 0.0), torch.clamp(count - compact_capacity, min=0))
    t_a, tri_a, uv_a, b_a = _alpha_sweep(
        origins, dirs, t_min, t_max, scene, k, cull_backface, chunk
    )
    return t_a, tri_a, uv_a, b_a, torch.zeros((), dtype=torch.int64, device=dev)


def _alpha_chunk_aabbs(scene: TraceScene, ch: int = 128):
    """AABBs of the compacted alpha list in `ch`-triangle chunks
    (the alpha-side traversal-cull boxes): (lo (3, M), hi (3, M))."""
    ids = scene.alpha_idx
    a_cap = ids.shape[0]
    safe_t = torch.clamp(ids, min=0)
    alive = (ids >= 0)[None]
    g3 = lambda a: a[:, safe_t]
    av0, av1, av2 = g3(scene.v0), g3(scene.v1), g3(scene.v2)
    lo = torch.where(alive, torch.minimum(torch.minimum(av0, av1), av2), _BIG)
    hi = torch.where(alive, torch.maximum(torch.maximum(av0, av1), av2), -_BIG)
    pad_c = (-a_cap) % ch
    if pad_c:
        lo = torch.cat([lo, torch.full((3, pad_c), _BIG, device=lo.device)], dim=1)
        hi = torch.cat([hi, torch.full((3, pad_c), -_BIG, device=hi.device)], dim=1)
    nch = (a_cap + pad_c) // ch
    return lo.reshape(3, nch, ch).amin(dim=2), hi.reshape(3, nch, ch).amax(dim=2)


class AlphaCompact(NamedTuple):
    """K-hit alpha trace results in COMPACTED ray space (see
    trace_alpha_to_compact): callers shade and resolve in this space and
    write their fold results back once."""

    idx: torch.Tensor  # (CAP,) source ray lane, == n for pad lanes; CAP is
    # the capacity, or N where fewer rays are traced
    mask: torch.Tensor  # (N,) candidate mask (lane compacted iff mask &
    # rank(mask) < CAP)
    origins: torch.Tensor  # (3, CAP) gathered ray origins
    dirs: torch.Tensor  # (3, CAP) gathered ray dirs
    noise: torch.Tensor  # (CAP,) gathered per-pixel noise
    t: torch.Tensor  # (CAP, K) UNBIASED hit t ascending by biased key (_BIG pad)
    tri: torch.Tensor  # (CAP, K) triangle ids (-1 pad)
    uv: torch.Tensor  # (CAP, K, 2) barycentrics
    extra: tuple  # gathered caller aux arrays ((C?, CAP) tensors)
    dropped: torch.Tensor  # () — candidate rays beyond CAP


def trace_alpha_to_compact(
    origins, dirs, t_min, t_max, scene: TraceScene, k_alpha: int,
    cull_backface: bool, capacity: int, noise_rand,
    t_opaque_biased=None, extra=(), chunk: int = 256,
):
    """Alpha K-hit trace with ONE cull+compact and NO full-width
    write-back: the slab cull + compaction runs once; rays, noise, the
    opaque depth bound and the caller's `extra` per-ray tensors ((N,) or
    (C, N)) are gathered once; the sweep, shading and front-to-back
    resolve all stay in compacted space (framegraph._fold_shaded_slots
    writes the resolved carry back once).

    t_opaque_biased: (N,) biased opaque-hit keys; alpha hits at/behind
    the opaque hit are masked out (they can never contribute).
    """
    from rt64tpu_torch.ops.shading import compact_indices

    n = origins.shape[1]
    k = k_alpha
    # Per-triangle cull boxes for small alpha lists (flat billboards
    # make fat chunk boxes); larger lists chunk by 4.
    a_cap = scene.alpha_idx.shape[0]
    lo_c, hi_c = _alpha_chunk_aabbs(scene, ch=1 if a_cap <= 512 else 4)
    cull_tmax = t_max
    if t_opaque_biased is not None:
        # Only alpha hits in front of the opaque hit survive the behind
        # mask below, so the cull segment ends at the opaque hit.
        alpha_bias_max = torch.where(
            scene.alpha & scene.valid, scene.bias, 0.0
        ).amax()
        cull_tmax = torch.minimum(t_max, t_opaque_biased + alpha_bias_max)
    ray_mask = _slab_any_bundled(origins, dirs, t_min, cull_tmax, lo_c, hi_c)
    # No more than n rays can be candidates: past n the compacted space
    # would hold only pad lanes. Drops still count against `capacity`.
    idx, count = compact_indices(ray_mask, min(capacity, n))
    safe_r = torch.clamp(idx, max=n - 1)
    live_r = idx < n

    o_c, d_c = origins[:, safe_r], dirs[:, safe_r]
    tmin_c = t_min[safe_r]
    # Pad lanes get an empty interval: they sweep nothing.
    tmax_c = torch.where(live_r, t_max[safe_r], tmin_c - 1.0)
    noise_c = noise_rand[safe_r]
    extra_c = tuple(leaf[..., safe_r] for leaf in extra)

    t_cc, tri_cc, uv_cc, b_cc = _alpha_sweep(
        o_c, d_c, tmin_c, tmax_c, scene, k, cull_backface, chunk
    )
    if t_opaque_biased is not None:
        behind = t_cc >= t_opaque_biased[safe_r][:, None]
        tri_cc = torch.where(behind, -1, tri_cc)
        t_cc = torch.where(behind, _BIG, t_cc)
    t_true = torch.where(tri_cc >= 0, t_cc + b_cc, _BIG)
    return AlphaCompact(
        idx=idx, mask=ray_mask, origins=o_c, dirs=d_c, noise=noise_c,
        t=t_true, tri=tri_cc, uv=uv_cc, extra=extra_c,
        dropped=torch.clamp(count - capacity, min=0),
    )


def trace_opaque_only(
    origins, dirs, t_min, t_max, scene: TraceScene,
    cull_backface: bool = True, chunk: int = 512, opaque_fn=None,
):
    """Opaque-class closest hit with unbiasing folded in.

    Returns (t_true (N,), tri (N,), uv (N, 2), t_biased (N,));
    t_true/t_biased are _BIG for misses."""
    opaque = opaque_fn or trace_opaque
    res = opaque(
        origins, dirs, t_min, t_max, scene, cull_backface=cull_backface,
        chunk=chunk,
    )
    if len(res) == 4:
        t_opb, tri_op, uv_op, bias_op = res
    else:
        t_opb, tri_op, uv_op = res
        bias_op = scene.bias[torch.clamp(tri_op, min=0)]
    t_true = torch.where(tri_op >= 0, t_opb + bias_op, _BIG)
    return t_true, tri_op, uv_op, t_opb


def live_bundles(active):
    """(N,) bool: the lanes of every bundle of _CULL_BUNDLE adjacent lanes
    that holds an active lane, and those of a partial last bundle always.
    The alpha cull tests such bundles (_slab_any_bundled; lane by lane
    where N is no multiple of a bundle), so on a subset of whole bundles
    in lane order it marks each lane as over all N: the same candidates,
    dropped in the same order past the capacity."""
    s = _CULL_BUNDLE
    n = active.shape[0]
    pad = -n % s
    bundles = torch.cat([active, active.new_zeros(pad)]).view(-1, s).any(1)
    if pad:
        bundles[-1] = True
    return bundles[:, None].expand(-1, s).reshape(-1)[:n]


def _slab_any_bundled(origins, dirs, t_min, t_max, lo, hi):
    """Conservative per-ray any-box mask via _CULL_BUNDLE-ray interval
    bundles (origin box, direction box, live [t_min, t_max] hull of
    adjacent rays) against M boxes. Used only as a compaction prefilter,
    so a slightly looser mask costs capacity, not results. Dead rays
    (empty interval) are excluded from the bundle hull and from the
    returned mask. Where N is no multiple of a bundle, rays are tested
    one by one. Otherwise CPU tensors take _slab_any_bundled_plain, CUDA
    tensors the hand-written kernel (tracer_cuda.alpha_cull), whose mask
    equals the twin's bit for bit."""
    n = origins.shape[1]
    if n % _CULL_BUNDLE:
        hit = slab_per_ray(origins, dirs, t_min, t_max, lo, hi)[0]
        return hit.any(dim=1) & (t_max >= t_min)
    if origins.device.type == "cpu":
        profiling.count_launch("alpha_cull_launches")
        return _slab_any_bundled_plain(origins, dirs, t_min, t_max, lo, hi)
    from rt64tpu_torch.ops import tracer_cuda

    return tracer_cuda.alpha_cull(origins, dirs, t_min, t_max, lo, hi)


def _slab_any_bundled_plain(origins, dirs, t_min, t_max, lo, hi):
    """The alpha cull's plain twin (N a multiple of _CULL_BUNDLE): the
    bundles' hulls, then _slab_interval_hit over (bundles x M) planes."""
    live = t_max >= t_min
    hit, _ = _slab_interval_hit(*bundle_hulls(origins, dirs, t_min, t_max),
                                lo, hi)
    return torch.repeat_interleave(hit.any(dim=1), _CULL_BUNDLE) & live


def bundle_hulls(origins, dirs, t_min, t_max):
    """The hulls of the alpha cull's bundles of _CULL_BUNDLE adjacent lanes
    over their live lanes (t_max >= t_min): (o_lo, o_hi, d_lo, d_hi (3, B),
    tmin_lo, tmax_hi (B,)); a bundle without a live lane reads o_lo > o_hi.
    """
    sub = _CULL_BUNDLE
    ns = origins.shape[1] // sub
    live = t_max >= t_min

    def b3(a, fill, red):
        m = torch.where(live[None, :], a, fill)
        return red(m.reshape(3, ns, sub), dim=2)

    return (b3(origins, _BIG, torch.amin), b3(origins, -_BIG, torch.amax),
            b3(dirs, _BIG, torch.amin), b3(dirs, -_BIG, torch.amax),
            torch.where(live, t_min, _BIG).reshape(ns, sub).amin(dim=1),
            torch.where(live, t_max, -_BIG).reshape(ns, sub).amax(dim=1))


def _slab_interval_hit(o_lo, o_hi, d_lo, d_hi, tmin_lo, tmax_hi, lo, hi):
    """Interval-arithmetic slab test of B ray bundles against M boxes.
    Returns (hit (B, M), t_lo (B, M)); bundles with no live ray and
    inverted boxes never hit."""
    b = o_lo.shape[1]
    m = lo.shape[1]
    dev = lo.device
    t_lo = torch.full((b, m), -float("inf"), device=dev)
    t_hi = torch.full((b, m), float("inf"), device=dev)
    eps = 1e-12
    for c in range(3):
        # A direction interval spanning zero constrains nothing.
        mixed = ((d_lo[c] <= eps) & (d_hi[c] >= -eps))[:, None]
        inv_a = (1.0 / torch.where(torch.abs(d_lo[c]) > eps, d_lo[c], 1.0))[:, None]
        inv_b = (1.0 / torch.where(torch.abs(d_hi[c]) > eps, d_hi[c], 1.0))[:, None]
        # Numerator interval: box minus origin interval.
        num_lo = lo[c][None, :] - o_hi[c][:, None]
        num_hi = hi[c][None, :] - o_lo[c][:, None]
        t1 = num_lo * inv_a
        t2 = num_lo * inv_b
        t3 = num_hi * inv_a
        t4 = num_hi * inv_b
        ax_lo = torch.minimum(torch.minimum(t1, t2), torch.minimum(t3, t4))
        ax_hi = torch.maximum(torch.maximum(t1, t2), torch.maximum(t3, t4))
        t_lo = torch.maximum(t_lo, torch.where(mixed, -_BIG, ax_lo))
        t_hi = torch.minimum(t_hi, torch.where(mixed, _BIG, ax_hi))
    t_lo = t_lo - torch.abs(t_lo) * 1e-5 - 1e-4
    t_hi = t_hi + torch.abs(t_hi) * 1e-5 + 1e-4
    hit = (
        (t_lo <= t_hi)
        & (t_hi >= tmin_lo[:, None])
        & (t_lo <= tmax_hi[:, None])
    )
    box_ok = torch.all(lo <= hi, dim=0)
    dead = o_lo[0] > o_hi[0]  # no live rays in the bundle
    return hit & box_ok[None, :] & ~dead[:, None], t_lo


def slab_per_ray(origins, dirs, t_min, t_max, lo, hi):
    """Per-ray slab test against M boxes: (hit (N, M), t_lo (N, M)).

    Axes where the ray is (near-)parallel constrain nothing. The
    interval is widened by a relative+absolute epsilon so triangles
    exactly on a box face are never culled by slab rounding. Inverted
    boxes (lo > hi on any axis: padding/empty) never hit."""
    n = origins.shape[1]
    m = lo.shape[1]
    dev = lo.device
    t_lo = torch.full((n, m), -float("inf"), device=dev)
    t_hi = torch.full((n, m), float("inf"), device=dev)
    for c in range(3):
        o = origins[c][:, None]
        d = dirs[c]
        par = (torch.abs(d) <= 1e-12)[:, None]
        idir = (1.0 / torch.where(torch.abs(d) > 1e-12, d, 1.0))[:, None]
        ta = (lo[c][None, :] - o) * idir
        tb = (hi[c][None, :] - o) * idir
        t_lo = torch.maximum(t_lo, torch.where(par, -_BIG, torch.minimum(ta, tb)))
        t_hi = torch.minimum(t_hi, torch.where(par, _BIG, torch.maximum(ta, tb)))
    t_lo = t_lo - torch.abs(t_lo) * 1e-5 - 1e-4
    t_hi = t_hi + torch.abs(t_hi) * 1e-5 + 1e-4
    hit = (t_lo <= t_hi) & (t_hi >= t_min[:, None]) & (t_lo <= t_max[:, None])
    box_ok = torch.all(lo <= hi, dim=0)
    return hit & box_ok[None, :], t_lo


def _alpha_sweep(
    origins, dirs, t_min, t_max, scene: TraceScene, k_alpha: int,
    cull_backface: bool, chunk: int = 256,
):
    """The raw O(rays x alpha-list) K-hit sweep (see trace_alpha).

    Returns (t_biased (N, K), tri (N, K), uv (N, K, 2), bias (N, K)):
    the depth bias of each hit comes with it, so callers recover the
    true t as key + bias with no per-hit gather. CPU tensors take
    _alpha_sweep_plain, CUDA tensors the hand-written kernel
    (tracer_cuda.alpha_sweep); the result does not depend on `chunk`,
    the twin's piece of the list.
    """
    if origins.device.type == "cpu":
        profiling.count_launch("alpha_sweep_launches")
        return _alpha_sweep_plain(origins, dirs, t_min, t_max, scene,
                                  k_alpha, cull_backface, chunk)
    from rt64tpu_torch.ops import tracer_cuda

    return tracer_cuda.alpha_sweep(origins, dirs, t_min, t_max, scene,
                                   k_alpha, cull_backface)


def _alpha_sweep_plain(
    origins, dirs, t_min, t_max, scene: TraceScene, k_alpha: int,
    cull_backface: bool, chunk: int = 256,
):
    """The alpha sweep's plain twin: Moller-Trumbore over (rays x chunk)
    planes, the K smallest keys of each chunk by _extract_k_smallest,
    merged into the carry chunk by chunk. The bias rides as a payload.

    Tie rule: among equal keys the later alpha-list position comes
    first, whatever the chunk (a chunk's extraction takes the largest
    column first; the merge puts both lists in reversed, so the largest
    column reads the later chunk's hits first, each list in its own
    order). The JAX package merges without reversing, so it can order
    exactly equal keys from different chunks otherwise.
    """
    n = origins.shape[1]
    dev = origins.device
    a_cap = scene.alpha_idx.shape[0]
    k = k_alpha
    if a_cap == 0:
        return (torch.full((n, k), _BIG, device=dev),
                torch.full((n, k), -1, dtype=torch.int64, device=dev),
                torch.zeros((n, k, 2), device=dev),
                torch.zeros((n, k), device=dev))
    chunk = min(chunk, a_cap)
    rays = _Rays.of(origins, dirs, t_min, t_max)

    alpha_idx = scene.alpha_idx
    pad = (-a_cap) % chunk
    if pad:
        alpha_idx = torch.cat(
            [alpha_idx, torch.full((pad,), -1, dtype=alpha_idx.dtype,
                                   device=dev)]
        )
    carry = None
    for ids in alpha_idx.reshape(-1, chunk):
        live = ids >= 0
        ids_s = torch.clamp(ids, min=0)
        g3 = lambda a: a[:, ids_s]
        t, u, v, hit = _intersect_soa(
            rays, g3(scene.v0), g3(scene.v1), g3(scene.v2),
            scene.no_cull[ids_s], cull_backface,
        )
        hit = hit & live[None, :]
        bias_row = torch.broadcast_to(scene.bias[ids_s][None, :], t.shape)
        key = torch.where(hit, t - bias_row, _BIG)
        ext = _extract_k_smallest(key, ids[None, :], k,
                                  payloads=(u, v, bias_row))
        if carry is None:
            carry = ext
            continue
        both = [torch.cat([a.flip(1), b.flip(1)], dim=1)
                for a, b in zip(carry, ext)]
        carry = _extract_k_smallest(both[0], both[1], k,
                                    payloads=tuple(both[2:]))
    t_a, tri_a, u_a, v_a, b_a = carry
    return t_a, tri_a, torch.stack([u_a, v_a], dim=-1), b_a


def trace(
    origins,
    dirs,
    t_min,
    t_max,
    scene: TraceScene,
    k_alpha: int,
    cull_backface: bool = True,
    chunk: int = 512,
    opaque_fn=None,
    alpha_compact: int = 0,
) -> Hits:
    """Trace rays against the full scene.

    origins/dirs: planar (3, N); dirs may be non-normalized (t is
    measured in units of |dir| like DXR). opaque_fn optionally overrides
    the opaque traversal (the packet-tracer hook); it must match
    trace_opaque's signature/returns.
    """
    n = origins.shape[1]
    dev = origins.device
    opaque = opaque_fn or trace_opaque
    res = opaque(
        origins, dirs, t_min, t_max, scene, cull_backface=cull_backface,
        chunk=chunk,
    )
    if len(res) == 4:
        t_opb, tri_op, uv_op, bias_op = res
    else:
        t_opb, tri_op, uv_op = res
        bias_op = scene.bias[torch.clamp(tri_op, min=0)]
    a_dropped = torch.zeros((), dtype=torch.int64, device=dev)
    if k_alpha > 0 and scene.has_alpha is not False:
        t_ab, tri_a, uv_a, b_a, a_dropped = trace_alpha(
            origins, dirs, t_min, t_max, scene, k_alpha, cull_backface,
            compact_capacity=alpha_compact,
        )
        # Alpha hits at/behind the opaque hit can never contribute.
        behind = t_ab >= t_opb[:, None]
        tri_a = torch.where(behind, -1, tri_a)
        t_ab = torch.where(behind, _BIG, t_ab)
    else:
        # k_alpha == 0, or the host knows there are no alpha triangles:
        # empty slots in the caller-expected K width.
        k = max(k_alpha, 1)
        t_ab = torch.full((n, k), _BIG, device=dev)
        tri_a = torch.full((n, k), -1, dtype=torch.int64, device=dev)
        uv_a = torch.zeros((n, k, 2), device=dev)
        b_a = torch.zeros((n, k), device=dev)

    # Unbias: stored keys are t - bias; recover true t for positions
    # (WithoutDistanceBias, Instances.hlsli).
    t_op_true = torch.where(tri_op >= 0, t_opb + bias_op, _BIG)
    t_a_true = torch.where(tri_a >= 0, t_ab + b_a, _BIG)
    return Hits(
        t_op=t_op_true,
        tri_op=tri_op,
        uv_op=uv_op,
        t_a=t_a_true,
        tri_a=tri_a,
        uv_a=uv_a,
        alpha_dropped=a_dropped,
    )


def trace_shadow(
    origins, dirs, t_min, t_max, scene: TraceScene, k_alpha: int,
    chunk: int = 512, opaque_fn=None, alpha_compact: int = 0,
) -> Hits:
    """Shadow-ray trace (TraceShadow, Lights.hlsli:27-53).

    An opaque-class hit anywhere in range fully blocks the ray; alpha
    hits are collected for the shadow-alpha accumulation
    (rt64_shader.cpp:594-674). Backface culling is off: the reference
    leaves SKIP_BACKFACE_SHADOWS undefined (Lights.hlsli:46-48).
    """
    return trace(
        origins, dirs, t_min, t_max, scene,
        k_alpha=k_alpha, cull_backface=False, chunk=chunk, opaque_fn=opaque_fn,
        alpha_compact=alpha_compact,
    )
