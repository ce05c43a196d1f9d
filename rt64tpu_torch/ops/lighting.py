"""Direct lighting: light selection, area shadows — planar layout.

Vectorized equivalents of Lights.hlsli:
  * CalculateLightIntensitySimple (:56-67) over all (light, pixel)
    pairs at once, planar (L, N).
  * ComputeLightsRandom (:115-168): intensity-weighted selection
    without replacement, eligibility from host-precomputed per-instance
    light masks, probability compensation only when a single light is
    sampled.
  * ComputeLight (:70-113): blue-noise disk sampling of the light's
    point radius, diSamples shadow rays each.
  * TraceShadow (:27-53) built from the tracer + the shadow any-hit
    alpha rules (ops/shading.py shadow variant).

The frame plans every light query first (plan_lights), traces ALL their
shadow rays in one launch (trace_plans), then folds each plan
(finish_lights).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rt64tpu_torch.ops import bluenoise
from rt64tpu_torch.ops import shading as shade_ops
from rt64tpu_torch.ops import tracer
from rt64tpu_torch.ops import vecmath as vm
from rt64tpu_torch.pipeline import rows as R

EPSILON = 1e-6  # Constants.hlsli
MAX_LIGHTS = 16  # Lights.hlsli:24


class LightingCtx(NamedTuple):
    """Per-point material inputs the lighting equations need."""

    ignore_normal: torch.Tensor  # (N,)
    spec_exp: torch.Tensor  # (N,)
    shadow_ray_bias: torch.Tensor  # (N,)
    self_light: torch.Tensor  # (3, N)
    has_lighting: torch.Tensor  # (N,) bool
    eligibility: torch.Tensor  # (MAX_ELIG, N) 0/1


def ctx_from_rows(rows_t, valid):
    """Build a LightingCtx from gathered CONTEXT rows (R.CTXROW, N)
    (framegraph._row_of)."""
    flags = rows_t[R.CTX_FLAGS].to(torch.int32)
    return LightingCtx(
        ignore_normal=rows_t[R.CTX_IGNORE_NORMAL],
        spec_exp=rows_t[R.CTX_SPEC_EXP],
        shadow_ray_bias=rows_t[R.CTX_SHADOW_RAY_BIAS],
        self_light=rows_t[R.CTX_SELF_LIGHT : R.CTX_SELF_LIGHT + 3],
        has_lighting=((flags & R.F_HAS_LIGHTING) != 0) & valid,
        eligibility=rows_t[R.CTX_ELIG : R.CTX_ELIG + R.MAX_ELIG_LIGHTS]
        * valid[None].to(rows_t.dtype),
    )


def trace_shadow_factor(
    sb, tri_rows, trace_scene, origins, dirs, t_min, t_max, noise_rand,
    k_alpha: int, opaque_fn=None, alpha_compact: int = 0,
    shade_boost: int = 1,
):
    """TraceShadow: 1 = lit, 0 = fully shadowed.

    Opaque-class hits block completely; alpha-class hits subtract their
    shadow alpha (the payload.shadowHit accumulation is
    order-independent, rt64_shader.cpp:655-658, so a masked sum is
    exact). Returns (factor (N,), dropped — alpha hits beyond shade
    capacity)."""
    n = origins.shape[1]
    dev = origins.device
    if k_alpha > 0 and trace_scene.has_alpha is True:
        _, tri_op, _, t_opb = tracer.trace_opaque_only(
            origins, dirs, t_min, t_max, trace_scene,
            cull_backface=False, opaque_fn=opaque_fn,
        )
        blocked = tri_op >= 0
        # Base 1/32 occupancy; the view's boost ladder grows the
        # capacity QUADRATICALLY here (clamped to the exact k*n bound).
        b = max(shade_boost, 1)
        cap = min(k_alpha * n, max(512, (k_alpha * n) // 32) * b * b)
        ac = tracer.trace_alpha_to_compact(
            origins, dirs, t_min, t_max, trace_scene, k_alpha,
            False, cap, noise_rand, t_opaque_biased=t_opb,
        )
        asum_c = torch.zeros(ac.noise.shape, device=dev)
        for s in range(k_alpha):
            hs = shade_ops.shade_hits(
                sb, tri_rows, ac.dirs, ac.tri[:, s], ac.uv[:, s, 0],
                ac.uv[:, s, 1], ac.noise, shadow_variant=True,
            )
            asum_c = asum_c + hs.color[3]
        live = ac.idx < n
        alpha_sum = torch.zeros((n,), device=dev)
        alpha_sum[ac.idx[live]] = asum_c[live]
        factor = torch.clamp(1.0 - alpha_sum, min=0.0)
        return torch.where(blocked, 0.0, factor), ac.dropped

    hits = tracer.trace_shadow(
        origins, dirs, t_min, t_max, trace_scene, k_alpha,
        opaque_fn=opaque_fn, alpha_compact=alpha_compact,
    )
    blocked = hits.tri_op >= 0
    dropped = hits.alpha_dropped
    if k_alpha > 0 and trace_scene.has_alpha is not False:
        tri_flat = hits.tri_a.T.reshape(-1)  # (K*N,)
        u_flat = hits.uv_a[..., 0].T.reshape(-1)
        v_flat = hits.uv_a[..., 1].T.reshape(-1)
        dirs_flat = dirs.repeat(1, k_alpha)
        hs, sh_dropped = shade_ops.shade_hits_compacted(
            sb, tri_rows, dirs_flat, tri_flat, u_flat, v_flat,
            noise_rand.repeat(k_alpha),
            max(512, (k_alpha * n) // 8) * max(shade_boost, 1),
            shadow_variant=True,
        )
        alpha_sum = hs.color[3].reshape(k_alpha, n).sum(0)
        dropped = dropped + sh_dropped
    else:
        alpha_sum = torch.zeros((n,), device=dev)
    factor = torch.clamp(1.0 - alpha_sum, min=0.0)
    return torch.where(blocked, 0.0, factor), dropped


def _select_light(values, chosen):
    """values: (L,) per-light; chosen: (N,) light index -> (N,) via an
    L-way masked sum."""
    out = None
    for l in range(values.shape[0]):
        term = torch.where(chosen == l, values[l], 0.0)
        out = term if out is None else out + term
    return out


def light_intensity_simple(sb, position, normal, ignore_normal):
    """CalculateLightIntensitySimple for all lights: (L, N)."""
    lp = sb.lights[:, 0:3]  # (L, 3)
    dx = position[0][None, :] - lp[:, 0:1]
    dy = position[1][None, :] - lp[:, 1:2]
    dz = position[2][None, :] - lp[:, 2:3]
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    inv = 1.0 / torch.clamp(dist, min=1e-12)
    ndotl = -(normal[0][None] * dx + normal[1][None] * dy + normal[2][None] * dz) * inv
    inf = ignore_normal[None]
    surface_bias = torch.clamp(ndotl + (1.0 - ndotl) * inf + 0.707106, min=0.0)
    radius = sb.lights[:, 6:7]
    atten = sb.lights[:, 12:13]
    falloff = torch.clamp(1.0 - dist / radius, min=0.0)
    factor = torch.pow(falloff, atten) * surface_bias
    diffuse_sum = sb.lights[:, 3:6].sum(1, keepdim=True)
    return factor * diffuse_sum  # (L, N)


def _light_sample_terms(
    sb, pixel_xy, bn_table, frame_count,
    chosen,  # (N,) selected light index
    ray_dir,  # (3, N)
    position,  # (3, N)
    normal,  # (3, N)
    ctx: LightingCtx,
    di_samples: int,
    live,  # (N,) bool
):
    """ComputeLight (Lights.hlsli:70-113) WITHOUT the shadow trace.
    Returns per-sample lambert/spec-dot terms plus the shadow ray batch
    (dirs (S, 3, N), t_max (S, N))."""
    sel = lambda col: _select_light(sb.lights[:, col], chosen)
    lpos = torch.stack([sel(0), sel(1), sel(2)], 0)
    ldiff = torch.stack([sel(3), sel(4), sel(5)], 0)
    lrad = sel(6)
    lpoint = sel(7)
    lspec = torch.stack([sel(8), sel(9), sel(10)], 0)
    loffset = sel(11)
    latten = sel(12)

    light_dir = vm.normalize(lpos - position)
    point_radius = lpoint if di_samples > 0 else torch.zeros_like(lpoint)
    # perpX = cross(-lightDir, (0,1,0)); zero fallback sets x=1.
    perp_x = vm.cross(-light_dir, vm.splat((0.0, 1.0, 0.0), light_dir))
    all_zero = torch.all(perp_x == 0.0, dim=0)
    perp_x = torch.cat(
        [torch.where(all_zero, 1.0, perp_x[0])[None], perp_x[1:]], dim=0
    )
    perp_y = vm.cross(perp_x, -light_dir)

    max_samples = max(di_samples, 1)
    lamberts, specdots, dirs_s, tmax_s = [], [], [], []
    # Sample indices run max_samples..1 (the blue-noise frame order of
    # the reference implementation).
    for s in range(max_samples, 0, -1):
        bn = bluenoise.get_blue_noise(bn_table, pixel_xy, frame_count + s)
        scx = bn[..., 0] * 2.0 - 1.0
        scy = bn[..., 1] * 2.0 - 1.0
        sc_len = torch.sqrt(scx * scx + scy * scy)
        scale = torch.clamp(sc_len, 0.0, 1.0) / torch.clamp(sc_len, min=1e-12)
        scx = scx * scale
        scy = scy * scale
        sample_pos = (
            lpos + perp_x * (scx * point_radius)[None]
            + perp_y * (scy * point_radius)[None]
        )
        delta = sample_pos - position
        sample_dist = vm.length(delta)
        sample_dir = delta / torch.clamp(sample_dist, min=1e-12)[None]
        falloff = torch.clamp(1.0 - sample_dist / lrad, min=0.0)
        intensity = torch.pow(falloff, latten)
        reflected = vm.reflect(-sample_dir, normal)
        ndotl = torch.clamp(vm.dot(normal, sample_dir), min=0.0)
        s_lambert = (ndotl + (1.0 - ndotl) * ctx.ignore_normal) * intensity
        spec_dot = torch.clamp(vm.dot(reflected, -ray_dir) * intensity, 0.0, 1.0)
        s_tmax = sample_dist - loffset
        # A shadow ray whose diffuse AND specular terms are both zero
        # multiplies the shadow factor into nothing: give it an empty
        # interval so whole ray blocks skip traversal.
        contributes = ((s_lambert > EPSILON) | (spec_dot > EPSILON)) & live
        s_tmax = torch.where(contributes, s_tmax, -1.0)
        lamberts.append(s_lambert)
        specdots.append(spec_dot)
        dirs_s.append(sample_dir)
        tmax_s.append(s_tmax)
    return (ldiff, lspec, torch.stack(lamberts), torch.stack(specdots),
            torch.stack(dirs_s), torch.stack(tmax_s))


class LightPlan(NamedTuple):
    """Phase-1 output of the light loop (see plan_lights): the selection
    and sampling terms plus this query's shadow-ray batch, so the caller
    can trace several queries' rays in ONE launch."""

    rounds: tuple  # per-round (active, inv_prob, ldiff, lspec, lamb, sdot)
    origins: torch.Tensor  # (3, R*S*n) tiled ray origins
    dirs: torch.Tensor  # (3, R*S*n)
    t_min: torch.Tensor  # (R*S*n,)
    t_max: torch.Tensor  # (R*S*n,)
    noise: torch.Tensor  # (R*S*n,)
    specular: torch.Tensor  # (3, n)
    ctx: LightingCtx
    n: int
    max_samples: int
    max_light_count: int


def plan_lights(
    sb, pixel_xy, bn_table, frame_count, ray_dir, position, normal,
    specular, ctx: LightingCtx, max_light_count: int, di_samples: int,
    noise_rand,
):
    """Selection rounds + per-sample terms + the shadow-ray batch
    (ComputeLightsRandom phase 1, Lights.hlsli:115-168). No tracing."""
    L = sb.lights.shape[0]
    n = position.shape[1]
    dev = position.device

    lidx = torch.arange(L, device=dev)
    in_range = (lidx < sb.light_count)[:, None]  # (L, 1)
    elig = ctx.eligibility[:L] > 0.0  # (L, N)
    intensities = light_intensity_simple(sb, position, normal, ctx.ignore_normal)
    candidate = in_range & elig & (intensities > EPSILON)
    # First-MAX_LIGHTS cap in light order (Lights.hlsli:127).
    ordinal = torch.cumsum(candidate.to(torch.int32), dim=0) - 1
    candidate = candidate & (ordinal < MAX_LIGHTS)
    intens = torch.where(candidate, intensities, 0.0)
    s_count = candidate.sum(dim=0)
    total = intens.sum(dim=0)
    sel_count = torch.clamp(s_count, max=max_light_count)
    use_probability = sel_count == 1

    rounds = []
    dirs_all, tmax_all = [], []
    random_range, intens_work = total, intens
    for s in range(max_light_count):
        active = (s < sel_count) & ctx.has_lighting
        r = bluenoise.get_blue_noise(bn_table, pixel_xy, frame_count + s)[..., 0]
        r = r * random_range
        csum = torch.cumsum(intens_work, dim=0)
        positive = intens_work > 0.0
        over = (csum > r[None]) & positive
        any_over = over.any(dim=0)
        first = torch.argmax(over.to(torch.int8), dim=0)
        last = (L - 1) - torch.argmax(positive.flip(0).to(torch.int8), dim=0)
        chosen = torch.where(any_over, first, last)
        onehot = lidx[:, None] == chosen[None]
        c_int = torch.where(onehot, intens_work, 0.0).sum(0)
        inv_prob = torch.where(
            use_probability, random_range / torch.clamp(c_int, min=1e-12), 1.0
        )
        ldiff, lspec, lamb, sdot, sdirs, stmax = _light_sample_terms(
            sb, pixel_xy, bn_table, frame_count, chosen, ray_dir,
            position, normal, ctx, di_samples, live=active,
        )
        rounds.append((active, inv_prob, ldiff, lspec, lamb, sdot))
        dirs_all.append(sdirs.permute(1, 0, 2).reshape(3, -1))
        tmax_all.append(stmax.reshape(-1))
        random_range = random_range - torch.where(active, c_int, 0.0)
        intens_work = torch.where(onehot & active[None], 0.0, intens_work)

    max_samples = max(di_samples, 1)
    reps = max_light_count * max_samples
    return LightPlan(
        rounds=tuple(rounds),
        origins=position.repeat(1, reps),
        dirs=torch.cat(dirs_all, dim=1),
        t_min=(tracer.RAY_MIN_DISTANCE + ctx.shadow_ray_bias).repeat(reps),
        t_max=torch.cat(tmax_all),
        noise=noise_rand.repeat(reps),
        specular=specular,
        ctx=ctx,
        n=n,
        max_samples=max_samples,
        max_light_count=max_light_count,
    )


def finish_lights(plan: LightPlan, factors):
    """Fold the traced shadow factors ((R*S*n,) flat, 1.0 when shadows
    are off) into the final light contribution (phase 3)."""
    n = plan.n
    factors = factors.reshape(plan.max_light_count, plan.max_samples, n)
    result = torch.zeros((3, n), device=factors.device)
    for i, (active, inv_prob, ldiff, lspec, lamb, sdot) in enumerate(
        plan.rounds
    ):
        lambert = lamb.sum(0) / plan.max_samples
        shadow_f = factors[i].sum(0) / plan.max_samples
        spec_f = (
            plan.specular[:, None, :]
            * torch.pow(sdot, plan.ctx.spec_exp[None])[None]
        ).sum(1) / plan.max_samples
        contrib = (ldiff * lambert[None] + lspec * spec_f) * shadow_f[None]
        result = result + torch.where(
            active[None], contrib * inv_prob[None], 0.0
        )
    return torch.where(plan.ctx.has_lighting[None], result, 0.0)


def trace_plans(plans, sb, tri_rows, trace_scene, shadow_k_alpha,
                opaque_fn=None, alpha_compact: int = 0,
                shade_boost: int = 1):
    """ONE batched shadow trace over several LightPlans' rays: one
    visit-list build, one occlusion launch, one alpha cull+compaction.
    Returns per-plan factor tensors, plus the alpha-drop count."""
    widths = [p.dirs.shape[1] for p in plans]
    origins = torch.cat([p.origins for p in plans], dim=1)
    dirs = torch.cat([p.dirs for p in plans], dim=1)
    t_min = torch.cat([p.t_min for p in plans])
    t_max = torch.cat([p.t_max for p in plans])
    noise = torch.cat([p.noise for p in plans])
    factors, dropped = trace_shadow_factor(
        sb, tri_rows, trace_scene, origins, dirs, t_min, t_max, noise,
        shadow_k_alpha, opaque_fn=opaque_fn, alpha_compact=alpha_compact,
        shade_boost=shade_boost,
    )
    return list(torch.split(factors, widths)), dropped


def compute_lights_random(
    sb, tri_rows, trace_scene, pixel_xy, bn_table, frame_count,
    ray_dir, position, normal, specular, ctx: LightingCtx,
    max_light_count: int, di_samples: int, check_shadows: bool,
    noise_rand, shadow_k_alpha: int = 1, opaque_fn=None,
    alpha_compact: int = 0, shade_boost: int = 1,
):
    """ComputeLightsRandom (Lights.hlsli:115-168) for ONE light query:
    plan, trace every round's shadow rays in one launch, finish.
    Returns (light (3, N), alpha-drop count). Callers with several
    queries in flight batch them with plan_lights / trace_plans /
    finish_lights instead."""
    plan = plan_lights(
        sb, pixel_xy, bn_table, frame_count, ray_dir, position, normal,
        specular, ctx, max_light_count, di_samples, noise_rand,
    )
    dev = position.device
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    if check_shadows:
        (factors,), dropped = trace_plans(
            [plan], sb, tri_rows, trace_scene, shadow_k_alpha,
            opaque_fn=opaque_fn,
            alpha_compact=alpha_compact * max_light_count * plan.max_samples,
            shade_boost=shade_boost,
        )
    else:
        factors = torch.ones((plan.dirs.shape[1],), device=dev)
    return finish_lights(plan, factors), dropped
