"""Direct lighting: plan_lights -> trace_plans -> finish_lights in the
port against the JAX package on identical G-buffer inputs (castle
surface points, packed by the JAX package and moved across with
rt64tpu_torch.convert). The JAX side traces its shadow rays with its
packet kernel in interpret mode (the production shadow path), the port
with K2's plain twin: shadow factors must be exactly equal, light
colours agree to 1e-5."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rt64tpu.ops import bluenoise as jbn
from rt64tpu.ops import lighting as jli
from rt64tpu.ops import shading as jsh
from rt64tpu.ops import tracer_pallas as jtp
from rt64tpu.pipeline import framegraph as jfg
from rt64tpu.utils.castle_scene import build_castle_scene

from rt64tpu_torch.convert import (ctx_rows_from_slots, global_params_from_numpy,
                                   scene_buffers_from_numpy)
from rt64tpu_torch.ops import bluenoise as pbn
from rt64tpu_torch.ops import lighting as pli
from rt64tpu_torch.ops import shading as psh
from rt64tpu_torch.ops import tracer_cuda as tc
from rt64tpu_torch.pipeline import framegraph as pfg
from rt64tpu_torch.pipeline import rows as R


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def setup():
    _, _, view = build_castle_scene(width=64, height=16, gi_samples=0, foliage=12)
    view.max_reflections = 0
    view.update()
    r = view._renderer
    sb, cfg = r._sb, r._config()
    gp = r._global_params(cfg)
    sb_t = scene_buffers_from_numpy(
        {f: (None if getattr(sb, f) is None else np.asarray(getattr(sb, f)))
         for f in sb._fields if f != "features"}, sb.features, "cpu")
    gp_t = global_params_from_numpy(
        {f: np.asarray(getattr(gp, f)) for f in pfg.GlobalParams._fields}, "cpu")
    cfg_t = pfg.RenderConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(pfg.RenderConfig)})

    # G-buffer: castle surface points seen from the camera's side.
    rows = np.asarray(jsh.build_tri_rows(sb)[0])
    n = cfg.rt_width * cfg.rt_height
    rng = np.random.default_rng(0)
    tri = rng.choice(np.flatnonzero(np.asarray(sb.tri_valid)), n).astype(np.int32)
    tri[rng.uniform(size=n) < 0.15] = -1  # sky pixels
    u = rng.uniform(0, 1, n).astype(np.float32)
    v = (rng.uniform(0, 1, n) * (1 - u)).astype(np.float32)
    g = rows[np.maximum(tri, 0)].T
    w0 = 1 - u - v
    pos = (g[R.T_P0:R.T_P0 + 3] * w0 + g[R.T_P1:R.T_P1 + 3] * u
           + g[R.T_P2:R.T_P2 + 3] * v).astype(np.float32)
    nrm = np.cross(g[R.T_P1:R.T_P1 + 3] - g[R.T_P0:R.T_P0 + 3],
                   g[R.T_P2:R.T_P2 + 3] - g[R.T_P0:R.T_P0 + 3], axis=0)
    nrm = (nrm / np.maximum(np.linalg.norm(nrm, axis=0), 1e-12)).astype(np.float32)
    eye = np.asarray(gp.view_i)[3, :3, None]
    dirs = (pos - eye).astype(np.float32)
    nrm = np.where((nrm * dirs).sum(0) > 0, -nrm, nrm).astype(np.float32)
    spec = rng.uniform(0, 1, (3, n)).astype(np.float32)
    noise = rng.uniform(size=n).astype(np.float32)
    ctx_rows = np.array(jfg._row_of(jnp.asarray(rows), jnp.asarray(tri),
                                      jnp.asarray(tri >= 0)))
    inputs = dict(tri=tri, pos=pos, nrm=nrm, dirs=dirs, spec=spec,
                  noise=noise, ctx_rows=ctx_rows)
    return sb, gp, cfg, sb_t, gp_t, cfg_t, inputs


def _run_jax(sb, gp, cfg, x, max_lights):
    rows, rows_t = jsh.build_tri_rows(sb)
    scene = jfg.make_trace_scene(sb, rows_t, cfg.alpha_cap)
    pix = jfg._pixel_grid(cfg)
    swz = lambda plane: jnp.stack(
        [jfg._from_image_1(cfg, plane[..., c]) for c in range(3)], axis=-1)
    bn = jbn.grid_sampler(jnp.asarray(jbn.packed_table()), cfg.rt_width,
                          cfg.rt_height, swizzle=swz)
    valid = jnp.asarray(x["tri"] >= 0)
    ctx = jli.ctx_from_rows(jnp.asarray(x["ctx_rows"]), valid)
    plan = jli.plan_lights(
        sb, pix, bn, gp.frame_count, jnp.asarray(x["dirs"]), jnp.asarray(x["pos"]),
        jnp.asarray(x["nrm"]), jnp.asarray(x["spec"]), ctx,
        max_light_count=max_lights, di_samples=cfg.di_samples,
        noise_rand=jnp.asarray(x["noise"]))
    (factors,), dropped = jli.trace_plans(
        [plan], sb, rows, scene, cfg.k_shadow,
        opaque_fn=jtp.make_shadow_opaque_fn(interpret=True),
        alpha_compact=1024, shade_boost=16)
    return plan, factors, jli.finish_lights(plan, factors), dropped


def _run_port(sb, gp, cfg, x, max_lights):
    rows, rows_t = psh.build_tri_rows(sb)
    scene = pfg.make_trace_scene(sb, rows_t, cfg.alpha_cap)
    pix = pfg._pixel_grid(cfg, "cpu")
    swz = lambda plane: torch.stack(
        [pfg._from_image_1(cfg, plane[..., c]) for c in range(3)], dim=-1)
    bn = pbn.grid_sampler(torch.from_numpy(pbn.packed_table()), cfg.rt_width,
                          cfg.rt_height, swizzle=swz)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    ctx = pli.ctx_from_rows(torch.from_numpy(ctx_rows_from_slots(x["ctx_rows"])), t["tri"] >= 0)
    plan = pli.plan_lights(
        sb, pix, bn, gp.frame_count, t["dirs"], t["pos"], t["nrm"], t["spec"],
        ctx, max_light_count=max_lights, di_samples=cfg.di_samples,
        noise_rand=t["noise"])
    (factors,), dropped = pli.trace_plans(
        [plan], sb, rows, scene, cfg.k_shadow,
        opaque_fn=tc.make_shadow_opaque_fn(), alpha_compact=1024,
        shade_boost=16)
    return plan, factors, pli.finish_lights(plan, factors), dropped


def test_lights_match(setup):
    """Two selection rounds over the castle's two light groups."""
    sb, gp, cfg, sb_t, gp_t, cfg_t, x = setup
    max_lights = 2
    jplan, jf, jlight, jdrop = _run_jax(sb, gp, cfg, x, max_lights)
    pplan, pf, plight, pdrop = _run_port(sb_t, gp_t, cfg_t, x, max_lights)
    assert int(jdrop) == int(pdrop) == 0
    # The shadow-ray batch itself.
    for field in ("origins", "dirs", "t_min", "t_max", "noise"):
        np.testing.assert_allclose(_np(getattr(jplan, field)),
                                   _np(getattr(pplan, field)),
                                   rtol=1e-5, atol=1e-5, err_msg=field)
    for (ja, jp, *jt), (pa, pp, *pt) in zip(jplan.rounds, pplan.rounds):
        np.testing.assert_array_equal(_np(ja), _np(pa))
        np.testing.assert_allclose(_np(jp), _np(pp), rtol=1e-5)
    np.testing.assert_array_equal(_np(jf), _np(pf))
    f = _np(pf)
    assert (f == 0).any() and (f == 1).any()  # shadowed and lit rays
    np.testing.assert_allclose(_np(jlight), _np(plight), rtol=1e-5, atol=1e-5)
    assert _np(plight).max() > 0.05
