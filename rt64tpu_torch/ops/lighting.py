"""Direct lighting: light selection, area shadows — planar layout.

Vectorized equivalents of Lights.hlsli:
  * CalculateLightIntensitySimple (:56-67) over all (light, pixel)
    pairs at once, planar (L, N).
  * ComputeLightsRandom (:115-168): every light of the scene tested
    against the point's instance light group mask on the device
    (groupBits & lightGroupMaskBits, :127-130), the first MAX_LIGHTS
    candidates in light order kept, intensity-weighted selection without
    replacement, probability compensation only when a single light is
    sampled. The rounds pick in turn, each pick one gather of the
    intensities and one scatter that takes the light out of the pool.
  * ComputeLight (:70-113): blue-noise disk sampling of the light's
    point radius, diSamples shadow rays each, for every round at once
    on (R, N) planes: the picked lights' parameters are one gather, and
    a plan's launches grow with neither its lights nor its rounds.
  * TraceShadow (:27-53) built from the tracer + the shadow any-hit
    alpha rules (ops/shading.py shadow variant).

The frame plans every light query first (plan_lights), traces ALL their
shadow rays in one launch (trace_plans), then folds each plan
(finish_lights). Each plan_lights call is the stage `rt64.lights.plan`;
trace_plans counts the lanes it traces (`light_shadow_lanes`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rt64tpu_torch.ops import bluenoise
from rt64tpu_torch.ops import shading as shade_ops
from rt64tpu_torch.ops import tracer
from rt64tpu_torch.ops import vecmath as vm
from rt64tpu_torch.pipeline import rows as R
from rt64tpu_torch.utils import profiling

EPSILON = 1e-6  # Constants.hlsli
MAX_LIGHTS = 16  # Lights.hlsli:24


class LightingCtx(NamedTuple):
    """Per-point material inputs the lighting equations need."""

    ignore_normal: torch.Tensor  # (N,)
    spec_exp: torch.Tensor  # (N,)
    shadow_ray_bias: torch.Tensor  # (N,)
    self_light: torch.Tensor  # (3, N)
    has_lighting: torch.Tensor  # (N,) bool
    light_mask: torch.Tensor  # (N,) int32 lightGroupMaskBits (0 if invalid)


def ctx_from_rows(rows_t, valid):
    """Build a LightingCtx from gathered CONTEXT rows (R.CTXROW, N)
    (framegraph._row_of)."""
    flags = rows_t[R.CTX_FLAGS].to(torch.int32)
    validf = valid.to(rows_t.dtype)
    return LightingCtx(
        ignore_normal=rows_t[R.CTX_IGNORE_NORMAL],
        spec_exp=rows_t[R.CTX_SPEC_EXP],
        shadow_ray_bias=rows_t[R.CTX_SHADOW_RAY_BIAS],
        self_light=rows_t[R.CTX_SELF_LIGHT : R.CTX_SELF_LIGHT + 3],
        has_lighting=((flags & R.F_HAS_LIGHTING) != 0) & valid,
        light_mask=R.unpack_mask(rows_t[R.CTX_LMASK] * validf,
                                 rows_t[R.CTX_LMASK + 1] * validf),
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
        # capacity QUADRATICALLY here (clamped to the n rays). The rays,
        # not their k slots: a ray keeps its k alpha hits once compacted.
        b = max(shade_boost, 1)
        cap = min(n, max(512, n // 32) * b * b)
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


def _select_light(light_cols, chosen):
    """light_cols: (LIGHT_WIDTH, L) the lights' columns; chosen: (M,)
    light index in [0, L) -> (LIGHT_WIDTH, M), one gather. The + 0.0
    gives the bits of the L-way masked sum the JAX package takes (a
    -0.0 field reads +0.0)."""
    return torch.index_select(light_cols, 1, chosen) + 0.0


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
    pixel_xy, bn_table, frame_count,
    light,  # (LIGHT_WIDTH, R, N) each round's chosen light
    up,  # (3, 1, 1) the world's up, (0, 1, 0)
    ray_dir,  # (3, N)
    position,  # (3, N)
    normal,  # (3, N)
    ignore_normal,  # (N,)
    di_samples: int,
    live,  # (R, N) bool
):
    """ComputeLight (Lights.hlsli:70-113) WITHOUT the shadow trace, for
    every selection round at once: the points' planes broadcast over the
    rounds, so a plan's launches do not grow with its rounds. Returns
    per-sample lambert/spec-dot terms (S, R, N) plus the shadow ray batch
    (dirs (S, 3, R, N), t_max (S, R, N))."""
    lpos = light[0:3]
    lrad = light[6]
    lpoint = light[7]
    loffset = light[11]
    latten = light[12]
    position = position[:, None]
    normal = normal[:, None]

    light_dir = vm.normalize(lpos - position)
    point_radius = lpoint if di_samples > 0 else torch.zeros_like(lpoint)
    # perpX = cross(-lightDir, (0,1,0)); zero fallback sets x=1.
    perp_x = vm.cross(-light_dir, up)
    all_zero = torch.all(perp_x == 0.0, dim=0)
    perp_x = torch.cat(
        [torch.where(all_zero, 1.0, perp_x[0])[None], perp_x[1:]], dim=0
    )
    perp_y = vm.cross(perp_x, -light_dir)

    max_samples = max(di_samples, 1)
    lamberts, specdots, dirs_s, tmax_s = [], [], [], []
    # Sample indices run max_samples..1 (the blue-noise frame order of
    # the reference implementation); a sample's disk point is the same
    # in every round.
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
        s_lambert = (ndotl + (1.0 - ndotl) * ignore_normal) * intensity
        spec_dot = torch.clamp(
            vm.dot(reflected, -ray_dir[:, None]) * intensity, 0.0, 1.0)
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
    return (torch.stack(lamberts), torch.stack(specdots),
            torch.stack(dirs_s), torch.stack(tmax_s))


class LightPlan(NamedTuple):
    """Phase-1 output of the light loop (see plan_lights): the selection
    and sampling terms of every round, plus this query's shadow-ray
    batch, so the caller can trace several queries' rays in ONE
    launch."""

    active: torch.Tensor  # (R, n) bool: the round picked a light
    inv_prob: torch.Tensor  # (R, n)
    ldiff: torch.Tensor  # (3, R, n) the picked lights' diffuse colours
    lspec: torch.Tensor  # (3, R, n) and specular colours
    lamb: torch.Tensor  # (S, R, n) lambert terms
    sdot: torch.Tensor  # (S, R, n) specular dots
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

    @property
    def rounds(self) -> tuple:
        """Per round (active, inv_prob, ldiff, lspec, lamb, sdot): views."""
        return tuple(
            (self.active[r], self.inv_prob[r], self.ldiff[:, r],
             self.lspec[:, r], self.lamb[:, r], self.sdot[:, r])
            for r in range(self.max_light_count))


def plan_lights(
    sb, pixel_xy, bn_table, frame_count, ray_dir, position, normal,
    specular, ctx: LightingCtx, max_light_count: int, di_samples: int,
    noise_rand,
):
    """Selection rounds + per-sample terms + the shadow-ray batch
    (ComputeLightsRandom phase 1, Lights.hlsli:115-168), timed as the
    stage `rt64.lights.plan`. No tracing. The rounds pick in turn; the
    picked lights' fetch and sample terms are one pass over all rounds."""
    with profiling.stage("rt64.lights.plan", position.device):
        L = sb.lights.shape[0]
        n = position.shape[1]
        dev = position.device

        lidx = torch.arange(L, device=dev)
        in_range = (lidx < sb.light_count)[:, None]  # (L, 1)
        # Every light of the scene against the point's group mask
        # (Lights.hlsli:127-130): no light is bounded by a per-slot column.
        elig = (sb.light_groups[:, None] & ctx.light_mask[None]) != 0  # (L, N)
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

        actives, inv_probs, chosens = [], [], []
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
            # The chosen light's intensity: every intensity is +0.0 or
            # above, so the gather gives the bits of a one-hot sum.
            c_int = torch.gather(intens_work, 0, chosen[None])[0]
            inv_prob = torch.where(
                use_probability, random_range / torch.clamp(c_int, min=1e-12), 1.0
            )
            actives.append(active)
            inv_probs.append(inv_prob)
            chosens.append(chosen)
            random_range = random_range - torch.where(active, c_int, 0.0)
            # A picked light leaves the pool (its intensity zeroed).
            intens_work.scatter_(0, chosen[None],
                                 torch.where(active, 0.0, c_int)[None])

        active = torch.stack(actives)  # (R, N)
        light = _select_light(sb.lights.T.contiguous(), torch.cat(chosens)
                              ).reshape(-1, max_light_count, n)  # (LIGHT_WIDTH, R, N)
        # Filled on the device: a host constant would be a copy, and a
        # wait.
        up = torch.zeros((3, 1, 1), device=dev)
        up[1] = 1.0
        lamb, sdot, sdirs, stmax = _light_sample_terms(
            pixel_xy, bn_table, frame_count, light, up, ray_dir, position,
            normal, ctx.ignore_normal, di_samples, live=active,
        )

        max_samples = max(di_samples, 1)
        reps = max_light_count * max_samples
        return LightPlan(
            active=active,
            inv_prob=torch.stack(inv_probs),
            ldiff=light[3:6],
            lspec=light[8:11],
            lamb=lamb,
            sdot=sdot,
            origins=position.repeat(1, reps),
            # Rays in (round, sample, point) order.
            dirs=sdirs.permute(1, 2, 0, 3).reshape(3, -1),
            t_min=(tracer.RAY_MIN_DISTANCE + ctx.shadow_ray_bias).repeat(reps),
            t_max=stmax.permute(1, 0, 2).reshape(-1),
            noise=noise_rand.repeat(reps),
            specular=specular,
            ctx=ctx,
            n=n,
            max_samples=max_samples,
            max_light_count=max_light_count,
        )


def finish_lights(plan: LightPlan, factors):
    """Fold the traced shadow factors ((R*S*n,) flat, 1.0 when shadows
    are off) into the final light contribution (phase 3): every round's
    term at once, summed over the rounds in turn."""
    n, S = plan.n, plan.max_samples
    factors = factors.reshape(plan.max_light_count, S, n)
    lambert = plan.lamb.sum(0) / S  # (R, N)
    shadow_f = factors.sum(1) / S  # (R, N)
    spec_f = (
        plan.specular[:, None, None, :]
        * torch.pow(plan.sdot, plan.ctx.spec_exp)[None]
    ).sum(1) / S  # (3, R, N)
    contrib = (plan.ldiff * lambert[None] + plan.lspec * spec_f) * shadow_f[None]
    terms = torch.where(plan.active[None], contrib * plan.inv_prob[None], 0.0)
    result = torch.zeros((3, n), device=factors.device)
    for r in range(plan.max_light_count):
        result = result + terms[:, r]
    return torch.where(plan.ctx.has_lighting[None], result, 0.0)


def trace_plans(plans, sb, tri_rows, trace_scene, shadow_k_alpha,
                opaque_fn=None, alpha_compact: int = 0,
                shade_boost: int = 1):
    """ONE batched shadow trace over several LightPlans' rays: one
    visit-list build, one occlusion launch, one alpha cull+compaction.
    Returns per-plan factor tensors, plus the alpha-drop count."""
    widths = [p.dirs.shape[1] for p in plans]
    profiling.count_lights(shadow_lanes=sum(widths))
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
