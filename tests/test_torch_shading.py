"""Shading inputs and hit shading: the port against the JAX package on
identical inputs (the castle scene packed by the JAX package and moved
across with rt64tpu_torch.convert, plus seeded random lanes). Float
outputs agree to 1e-5; ids and masks exactly."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rt64tpu.ops import bluenoise as jbn
from rt64tpu.ops import fog as jfog
from rt64tpu.ops import shading as jsh
from rt64tpu.ops import sky as jsky
from rt64tpu.ops import texture as jtex
from rt64tpu.pipeline import framegraph as jfg
from rt64tpu.utils.castle_scene import build_castle_scene

from rt64tpu_torch.convert import (global_params_from_numpy, rows_to_slots,
                                   scene_buffers_from_numpy)
from rt64tpu_torch.ops import bluenoise as pbn
from rt64tpu_torch.ops import fog as pfog
from rt64tpu_torch.ops import shading as psh
from rt64tpu_torch.ops import sky as psky
from rt64tpu_torch.ops import texture as ptex
from rt64tpu_torch.pipeline import framegraph as pfg
from rt64tpu_torch.pipeline import rows as R

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def castle():
    _, _, view = build_castle_scene(width=128, height=64, gi_samples=0, foliage=12)
    view.max_reflections = 0
    view.update()
    r = view._renderer
    sb = r._sb
    cfg = r._config()
    gp = r._global_params(cfg)
    sb_t = scene_buffers_from_numpy(
        {f: (None if getattr(sb, f) is None else np.asarray(getattr(sb, f)))
         for f in sb._fields if f != "features"}, sb.features, "cpu")
    gp_t = global_params_from_numpy(
        {f: np.asarray(getattr(gp, f)) for f in pfg.GlobalParams._fields}, "cpu")
    cfg_t = pfg.RenderConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(pfg.RenderConfig)})
    return sb, gp, cfg, sb_t, gp_t, cfg_t


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_form(sb_t, rows):
    """The port's triangle rows (T, TROW) in the JAX package's form: the
    light group mask as eligibility per light slot (convert.rows_to_slots)."""
    return rows_to_slots(rows, R.T_LMASK, sb_t.light_groups.numpy(),
                         int(sb_t.light_count))


def test_build_tri_rows_matches(castle):
    sb, _, _, sb_t, _, _ = castle
    j_rows, _ = jsh.build_tri_rows(sb)
    p_rows, p_rows_t = psh.build_tri_rows(sb_t)
    np.testing.assert_allclose(_np(j_rows), _jax_form(sb_t, _np(p_rows)),
                               **TOL)
    np.testing.assert_array_equal(_np(p_rows), _np(p_rows_t).T)


def _lanes(sb, n=3000, seed=0):
    rng = np.random.default_rng(seed)
    valid = np.flatnonzero(np.asarray(sb.tri_valid))
    tri = rng.choice(valid, n).astype(np.int32)
    tri[rng.uniform(size=n) < 0.1] = -1
    u = rng.uniform(0, 1, n).astype(np.float32)
    v = (rng.uniform(0, 1, n) * (1 - u)).astype(np.float32)
    dirs = rng.normal(size=(3, n)).astype(np.float32)
    noise = rng.uniform(size=n).astype(np.float32)
    return tri, u, v, dirs, noise


@pytest.mark.parametrize("shadow", [False, True])
def test_shade_hits_matches(castle, shadow):
    sb, _, _, sb_t, _, _ = castle
    tri, u, v, dirs, noise = _lanes(sb)
    j_rows, _ = jsh.build_tri_rows(sb)
    p_rows, _ = psh.build_tri_rows(sb_t)
    j = jsh.shade_hits(sb, j_rows, jnp.asarray(dirs), jnp.asarray(tri),
                       jnp.asarray(u), jnp.asarray(v), jnp.asarray(noise),
                       shadow_variant=shadow)
    p = psh.shade_hits(sb_t, p_rows, *map(torch.from_numpy, (dirs, tri, u, v, noise)),
                       shadow_variant=shadow)
    np.testing.assert_array_equal(_np(j.instance), _np(p.instance))
    for field in ("color", "normal", "specular", "flow"):
        np.testing.assert_allclose(_np(getattr(j, field)), _np(getattr(p, field)),
                                   err_msg=field, **TOL)
    np.testing.assert_allclose(_np(j.rows_t), _jax_form(sb_t, _np(p.rows_t).T).T,
                               err_msg="rows_t", **TOL)
    alpha = _np(p.color)[3]
    assert 0 < (alpha > 0.5).mean() < 1  # foliage alpha and opaque hits


def test_shade_hits_compacted_matches(castle):
    sb, _, _, sb_t, _, _ = castle
    tri, u, v, dirs, noise = _lanes(sb, seed=1)
    tri[np.random.default_rng(1).uniform(size=tri.size) < 0.8] = -1
    j_rows, _ = jsh.build_tri_rows(sb)
    p_rows, _ = psh.build_tri_rows(sb_t)
    j, jd = jsh.shade_hits_compacted(
        sb, j_rows, jnp.asarray(dirs), jnp.asarray(tri), jnp.asarray(u),
        jnp.asarray(v), jnp.asarray(noise), 500)
    p, pd = psh.shade_hits_compacted(
        sb_t, p_rows, *map(torch.from_numpy, (dirs, tri, u, v, noise)), 500)
    assert int(jd) == int(pd) > 0
    np.testing.assert_array_equal(_np(j.instance), _np(p.instance))
    np.testing.assert_array_equal(_np(j.tri), _np(p.tri))
    for field in ("color", "normal", "specular", "flow"):
        np.testing.assert_allclose(_np(getattr(j, field)), _np(getattr(p, field)),
                                   err_msg=field, **TOL)


@pytest.mark.parametrize("linear", [False, True])
def test_sample_quad_cols_matches(linear):
    rng = np.random.default_rng(2)
    pool = rng.integers(0, 1 << 32, (4096, 4), dtype=np.uint64).astype(np.uint32)
    wide = jtex.pack_pool_wide(pool)
    recs = np.array([[0, 16, 16], [256, 32, 8], [512, 5, 7], [600, 64, 40]])
    n = 5000
    pick = rng.integers(0, len(recs), n)
    off, w, h = (recs[pick, k].astype(np.float32) for k in range(3))
    valid = rng.uniform(size=n) < 0.9
    u = rng.uniform(-3, 3, n).astype(np.float32)
    v = rng.uniform(-3, 3, n).astype(np.float32)
    filt = np.full(n, linear)
    h_addr = rng.integers(0, 3, n).astype(np.int32)
    v_addr = rng.integers(0, 3, n).astype(np.int32)
    args = (off, w, h, valid, u, v, filt, h_addr, v_addr)
    j = jtex.sample_quad_cols(jnp.asarray(wide), *map(jnp.asarray, args))
    p = ptex.sample_quad_cols(torch.from_numpy(wide.astype(np.int64)),
                              *map(torch.from_numpy, args))
    np.testing.assert_allclose(_np(j), _np(p), **TOL)


def test_sample_sky_2d_grid_matches(castle):
    sb, gp, cfg, sb_t, gp_t, cfg_t = castle
    vp = jnp.asarray([cfg.display_width, cfg.display_height], jnp.float32)
    for yaw, hsl in ((0.0, (0.0, 0.0, 0.0)), (0.7, (0.1, -0.2, 0.05))):
        j = jsky.sample_sky_2d_grid(
            sb.sky_plane, gp.sky_plane_rec, gp.pixel_jitter, gp.view_i, vp,
            np.float32(yaw), gp.sky_diffuse_mult, np.asarray(hsl, np.float32),
            cfg.rt_width, cfg.rt_height, cfg.rt_height)
        p = psky.sample_sky_2d_grid(
            sb_t.sky_plane, gp_t.sky_plane_rec, gp_t.pixel_jitter, gp_t.view_i,
            torch.tensor([cfg.display_width, cfg.display_height],
                         dtype=torch.float32), torch.tensor(yaw),
            gp_t.sky_diffuse_mult, torch.tensor(hsl),
            cfg_t.rt_width, cfg_t.rt_height, cfg_t.rt_height)
        np.testing.assert_allclose(_np(j), _np(p), **TOL)
        assert _np(p)[3].min() == 1.0  # the sky plane is opaque


def test_fog_matches(castle):
    _, gp, _, _, gp_t, _ = castle
    rng = np.random.default_rng(3)
    pos = rng.uniform(-80, 80, (3, 4000)).astype(np.float32)
    mul = rng.uniform(50, 300, 4000).astype(np.float32)
    off = rng.uniform(-50, 50, 4000).astype(np.float32)
    j = jfog.fog_alpha_from_camera(jnp.asarray(pos), gp.view, gp.projection,
                                   jnp.asarray(mul), jnp.asarray(off))
    p = pfog.fog_alpha_from_camera(torch.from_numpy(pos), gp_t.view,
                                   gp_t.projection, torch.from_numpy(mul),
                                   torch.from_numpy(off))
    np.testing.assert_allclose(_np(j), _np(p), **TOL)
    o = rng.uniform(-5, 5, (3, 4000)).astype(np.float32)
    np.testing.assert_allclose(
        _np(jfog.fog_alpha_from_origin(jnp.asarray(pos), jnp.asarray(o), 40.0, 3.0)),
        _np(pfog.fog_alpha_from_origin(torch.from_numpy(pos), torch.from_numpy(o), 40.0, 3.0)),
        **TOL)


@pytest.mark.parametrize("frame", [0, 5, 70])
def test_blue_noise_grid_sampler_matches(castle, frame):
    _, _, cfg, _, _, cfg_t = castle
    jswz = lambda plane: jnp.stack(
        [jfg._from_image_1(cfg, plane[..., c]) for c in range(3)], axis=-1)
    pswz = lambda plane: torch.stack(
        [pfg._from_image_1(cfg_t, plane[..., c]) for c in range(3)], dim=-1)
    w, h = cfg.rt_width, cfg.rt_height
    j = jbn.grid_sampler(jnp.asarray(jbn.packed_table()), w, h, swizzle=jswz)(
        jnp.int32(frame))
    p = pbn.grid_sampler(torch.from_numpy(pbn.packed_table()), w, h, swizzle=pswz)(
        torch.tensor(frame))
    np.testing.assert_array_equal(_np(j), _np(p))
    # The gather form (get_blue_noise on a packed table) agrees with it.
    pix = pfg._pixel_grid(cfg_t, "cpu")
    g = pbn.get_blue_noise(torch.from_numpy(pbn.packed_table()), pix,
                           torch.tensor(frame))
    np.testing.assert_array_equal(_np(g), _np(p))
