"""Raster layers, background planes and debug views: the port against the
JAX package on identical inputs, on the CPU.

- Packing: the RR rows and counts of a scene with a raster background, a
  24-triangle HUD mesh with a viewport and a scissor, exactly; more raster
  triangles than SceneLimits.raster_triangles raise in the port (the JAX
  package drops them), and with the limit raised both draw them all.
- rasterize: seeded triangles of either winding, a corner behind the
  camera, a degenerate one, viewport and scissor, both texture bindings,
  point and bilinear filtering under wrap/clamp/mirror and a count below
  the rows: 1e-5 abs. The bounding-box evaluation equals the full-screen
  one bit for bit.
- The background samplers (quad pack + bilinear fetch exactly, the
  fixed-grid and environment samples to 1e-6) and every debug view on
  random buffers (1e-6).
- Frames through each package's Device.draw(): the sample scene at 64x48
  with the raster skybox and HUD, sky plane on and off, gi 1, two draws,
  then two debug views: SSIM >= 0.99 each, max abs stated.
- The port alone: a tiled frame equals a row-major frame of the same
  layered view, sky plane on and off (the JAX package does not).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import rt64tpu
from rt64tpu import descriptors as jd
from rt64tpu.limits import SceneLimits as JaxLimits
from rt64tpu.ops import filters as jfilters
from rt64tpu.ops import raster as jraster
from rt64tpu.ops import sky as jsky
from rt64tpu.pipeline import framegraph as jfg
from rt64tpu.utils import testscenes as jts

from rt64tpu_torch import descriptors as pd
from rt64tpu_torch.convert import rows_to_slots
from rt64tpu_torch.limits import SceneLimits
from rt64tpu_torch.ops import filters as pfilters
from rt64tpu_torch.ops import raster as praster
from rt64tpu_torch.ops import sky as psky
from rt64tpu_torch.ops import texture as ptex
from rt64tpu_torch.pipeline import framegraph as pfg
from rt64tpu_torch.pipeline import rows as R
from rt64tpu_torch.pipeline.scene_buffers import build_quad_entries
from rt64tpu_torch.utils import testscenes as pts
from rt64tpu_torch.utils.ssim import ssim

TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny eager ops while other workers run: one intra-op thread
    is the fastest. The worker's setting comes back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_layers(scene, dev, **kw):
    """testscenes.raster_layers of the port, run against the JAX
    package's classes, so both packages get the same instances."""
    mp = pytest.MonkeyPatch()
    mp.setattr(pts, "rt64tpu_torch", rt64tpu)
    mp.setattr(pts, "d", jd)
    try:
        return pts.raster_layers(scene, dev, **kw)
    finally:
        mp.undo()


def _with_rect(inst, viewport, scissor):
    inst.desc.viewport_rect = viewport
    inst.desc.scissor_rect = scissor
    inst.set_description(inst.desc)


# --------------------------------------------------------------- packing


def _packed(jax_side, limits_kw=None, hud_quads=12, extra=0):
    kw = dict(max_vertices=2048, max_triangles=2048, max_instances=8,
              max_textures=8, texel_pool=1 << 17, **(limits_kw or {}))
    if jax_side:
        dev, scene, view = jts.build_sample_scene(
            32, 16, gi_samples=0, limits=JaxLimits(**kw))
        layers = _jax_layers(scene, dev, hud_quads=hud_quads)
        extra_layers = [_jax_layers(scene, dev, hud_quads=extra, background=False)
                        for _ in range(1 if extra else 0)]
    else:
        dev, scene, view = pts.build_sample_scene(
            32, 16, gi_samples=0, limits=SceneLimits(**kw), device="cpu")
        layers = pts.raster_layers(scene, dev, hud_quads=hud_quads)
        extra_layers = [pts.raster_layers(scene, dev, hud_quads=extra,
                                          background=False)
                        for _ in range(1 if extra else 0)]
    _with_rect(layers[1], (2.0, 1.0, 28.0, 14.0), (3.0, 2.0, 20.0, 10.0))
    view.update()
    return view._renderer._sb


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_pack_raster_rows_match():
    jsb = _packed(True)
    psb = _packed(False)
    assert int(jsb.raster_bg_count) == int(psb.raster_bg_count) == 2
    assert int(jsb.raster_fg_count) == int(psb.raster_fg_count) == 24
    for f in ("raster_bg", "raster_fg"):
        np.testing.assert_array_equal(_host(getattr(jsb, f)),
                                      _host(getattr(psb, f)), err_msg=f)
    # The light columns in the JAX package's form (convert.rows_to_slots).
    np.testing.assert_array_equal(
        _host(jsb.instance_rows),
        rows_to_slots(_host(psb.instance_rows), R.I_LMASK,
                      _host(psb.light_groups), int(psb.light_count)))
    assert jsb.features.has_raster_bg and psb.features.has_raster_bg
    host = psb.raster_host
    np.testing.assert_array_equal(host.bg, _host(psb.raster_bg)[:2])
    np.testing.assert_array_equal(host.fg, _host(psb.raster_fg)[:24])
    np.testing.assert_array_equal(host.instance_rows, _host(psb.instance_rows))
    irow = host.instance_rows[int(host.fg[0, praster.RR_INST])]
    assert list(irow[R.I_VIEWPORT : R.I_VIEWPORT + 4]) == [2, 1, 28, 14]
    assert list(irow[R.I_SCISSOR : R.I_SCISSOR + 4]) == [3, 2, 20, 10]


def test_raster_layers_leave_ray_features_alone():
    """The HUD's alpha combiner turns the JAX package's
    has_lit_transparent on (it counts raster instances); the port
    derives the ray-shading features from the raytraced instances only,
    so only has_raster_bg tells the layered scene from the plain one."""
    psb = _packed(False)
    _, _, view = pts.build_sample_scene(32, 16, gi_samples=0, device="cpu")
    view.update()
    plain = view._renderer._sb.features
    assert psb.features._replace(has_raster_bg=False) == plain
    assert not psb.features.has_lit_transparent
    assert _packed(True).features.has_lit_transparent


def test_raster_overflow_raises():
    """40 + 28 foreground triangles: 68 > 64. The port raises naming the
    limit instead of dropping 4 triangles."""
    with pytest.raises(ValueError, match="raster_triangles"):
        _packed(False, hud_quads=20, extra=14)


def test_raised_raster_limit_draws_every_triangle():
    raised = dict(raster_triangles=128)
    jsb = _packed(True, raised, hud_quads=20, extra=14)
    psb = _packed(False, raised, hud_quads=20, extra=14)
    assert int(jsb.raster_fg_count) == int(psb.raster_fg_count) == 68
    np.testing.assert_array_equal(_host(jsb.raster_fg), _host(psb.raster_fg))


# -------------------------------------------------------------- rasterize

W, H = 48, 32


def _textures(rng):
    """Quad pool (wide layout) and records for random textures under
    several addressing pairs; returns (pool u32 wide, records)."""
    combos = [((8, 8), 0, 0), ((5, 7), 1, 2), ((16, 4), 2, 1), ((6, 6), 1, 1)]
    pool, records, off = [], [], 0
    for (tw, th), hm, vm in combos:
        rgba = rng.integers(0, 256, (th, tw, 4), dtype=np.uint8)
        pool.append(build_quad_entries(rgba, hm, vm))
        records.append((off, tw, th))
        off += tw * th
    pool = np.concatenate(pool)
    pool = np.concatenate([pool, np.zeros((-len(pool) % ptex.QPR, 4), np.uint32)])
    return ptex.pack_pool_wide(pool), np.asarray(records, np.int32)


def _instances(rng):
    """Instance rows: each with its own combiner, bindings, sampler,
    viewport and scissor."""
    irows = np.zeros((6, R.IROW), np.float32)
    irows[:, R.I_TEX_D] = irows[:, R.I_TEX_D2] = -1
    specs = [
        # flags, tex_d, tex_d2, sampler (filter + 4 h + 16 v), viewport, scissor
        (R.F_USE_T0 | R.F_OPT_ALPHA, 0, -1, 1, None, None),
        (R.F_USE_T0 | R.F_USE_T1, 1, 2, 0 + 4 * 1 + 16 * 2, (4, 2, 36, 24),
         (6, 4, 30, 20)),
        (R.F_USE_T1 | R.F_OPT_ALPHA | R.F_ALPHA_SAME, -1, -1, 1, None,
         (0, 0, 20, 0)),  # magenta stub; a scissor with zero height is off
        (R.F_OPT_ALPHA, -1, -1, 0, (0, 0, 0, 16), None),
        (R.F_USE_T0 | R.F_OPT_ALPHA, 3, -1, 1 + 4 * 2 + 16 * 1, None,
         (10, 8, 24, 16)),
        (R.F_USE_T0 | R.F_USE_T1 | R.F_OPT_ALPHA, 2, 3, 1 + 4 * 1 + 16 * 1,
         None, None),
    ]
    for i, (flags, td, td2, sampler, vp, sc) in enumerate(specs):
        c0 = rng.integers(0, 8, 4)
        c1 = rng.integers(0, 8, 4)
        if i == 0:
            c0, c1 = (5, 0, 1, 0), (0, 0, 0, 1)  # TEXEL0 * INPUT_1, alpha INPUT_1
        irows[i, R.I_CC] = R.pack_cc(list(c0), list(c1))
        irows[i, R.I_FLAGS] = flags
        irows[i, R.I_TEX_D] = td
        irows[i, R.I_TEX_D2] = td2
        irows[i, R.I_SAMPLER] = sampler
        if vp is not None:
            irows[i, R.I_VIEWPORT : R.I_VIEWPORT + 4] = vp
        if sc is not None:
            irows[i, R.I_SCISSOR : R.I_SCISSOR + 4] = sc
    return irows


def _triangles(rng, n=12):
    rows = np.zeros((n, praster.RR_WIDTH), np.float32)
    for t in range(n):
        pos = np.concatenate([rng.uniform(-1.2, 1.2, (3, 2)),
                              rng.uniform(0, 1, (3, 1)),
                              rng.uniform(0.5, 2.0, (3, 1))], 1)
        if t == 2:
            pos[1, 3] = -0.7  # a corner behind the camera
        if t == 3:
            pos[2] = pos[0]  # degenerate
        if t == 4:
            pos = pos[::-1].copy()  # the other winding of a full-size one
            pos[:, :2] = [[-1, -1], [1, 1], [1, -1]]
            pos[:, 3] = 1.0
        rows[t, praster.RR_POS : praster.RR_POS + 12] = pos.reshape(-1)
        rows[t, praster.RR_UV : praster.RR_UV + 6] = rng.uniform(-0.5, 1.5, 6)
        rows[t, praster.RR_IN1 : praster.RR_IN1 + 12] = rng.uniform(0, 1, 12)
        rows[t, praster.RR_IN2 : praster.RR_IN2 + 12] = rng.uniform(0, 1, 12)
        rows[t, praster.RR_INST] = t % 6
    return rows


@pytest.fixture(scope="module")
def raster_inputs():
    rng = np.random.default_rng(11)
    pool, records = _textures(rng)
    irows = _instances(rng)
    rows = _triangles(rng)
    image = rng.uniform(0, 1, (4, H, W)).astype(np.float32)
    return pool, records, irows, rows, image


def _port_raster(inputs, count, bounding_box=True):
    pool, records, irows, rows, image = inputs
    return praster.rasterize(
        torch.from_numpy(image), torch.from_numpy(rows), count, rows,
        irows, torch.from_numpy(pool.astype(np.int64)), records,
        bounding_box=bounding_box).numpy()


@pytest.mark.parametrize("count", [10, 1])
def test_rasterize_matches(raster_inputs, count):
    """The JAX function runs op by op (jax.disable_jit): compiled for the
    CPU, XLA contracts the edge functions' a*b - c*d into FMAs, which
    moves the pixel next to the w = 0 horizon of triangle 2 by 1e-3
    relative. Op by op, like the port's kernels, every operation rounds
    on its own."""
    pool, records, irows, rows, image = raster_inputs
    with jax.disable_jit():
        want = jraster.rasterize(
            jnp.asarray(image.reshape(4, -1)), jnp.asarray(rows),
            jnp.int32(count), jnp.asarray(rows_to_slots(irows, R.I_LMASK, (), 0)),
            jnp.asarray(pool),
            jnp.asarray(records), W, H, jnp.zeros(W * H))
    got = _port_raster(raster_inputs, count)
    np.testing.assert_allclose(got, np.asarray(want).reshape(4, H, W), **TOL)
    assert not np.array_equal(got, image)  # the triangles drew something


def test_bounding_box_equals_full_screen(raster_inputs):
    """Every triangle of the seeded set and of thin slivers: the box
    evaluation gives the full-screen evaluation's bits."""
    np.testing.assert_array_equal(_port_raster(raster_inputs, 12),
                                  _port_raster(raster_inputs, 12, False))
    pool, records, irows, _, image = raster_inputs
    rng = np.random.default_rng(5)
    slivers = _triangles(rng, 16)
    for t in range(16):
        pos = slivers[t, :12].reshape(3, 4)
        pos[1, :2] = pos[0, :2] + (pos[2, :2] - pos[0, :2]) * rng.uniform(0.2, 0.8) \
            + rng.uniform(-1, 1, 2) * 10.0 ** -rng.uniform(1, 4)
        pos[:, 3] = np.abs(pos[:, 3]) + 0.5
    thin = (pool, records, irows, slivers, image)
    np.testing.assert_array_equal(_port_raster(thin, 16),
                                  _port_raster(thin, 16, False))


# ------------------------------------------------------------ background


@pytest.fixture(scope="module")
def plane():
    rng = np.random.default_rng(7)
    return rng.uniform(0, 1, (3, 20, 28)).astype(np.float32)


def test_quad_pack_and_bilinear_match(plane):
    rng = np.random.default_rng(8)
    su = rng.uniform(-0.2, 1.2, 500).astype(np.float32)
    sv = rng.uniform(-0.2, 1.2, 500).astype(np.float32)
    jp = jfilters.quad_pack_planar(jnp.asarray(plane))
    pp = pfilters.quad_pack_planar(torch.from_numpy(plane))
    np.testing.assert_array_equal(np.asarray(jp), pp.numpy())
    want = jfilters.bilinear_quad(jp, 3, 20, 28, jnp.asarray(su), jnp.asarray(sv))
    got = pfilters.bilinear_quad(pp, 3, 20, 28, torch.from_numpy(su),
                                 torch.from_numpy(sv))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("jitter", [(0.0, 0.0), (0.3, -0.45), (-0.5, 0.5)])
def test_background_grid_matches(plane, jitter):
    want = jsky.sample_background_grid(jnp.asarray(plane), jnp.float32(jitter[0]),
                                       jnp.float32(jitter[1]))
    got = psky.sample_background_grid(torch.from_numpy(plane), *jitter)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_background_2d_and_env_match(plane):
    rng = np.random.default_rng(9)
    su, sv = rng.uniform(0, 1, (2, 300)).astype(np.float32)
    want = jsky.sample_background_2d(jnp.asarray(plane), jnp.asarray(su),
                                     jnp.asarray(sv))
    got = psky.sample_background_2d(torch.from_numpy(plane),
                                    torch.from_numpy(su), torch.from_numpy(sv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # By direction: the (u, v) of fake_env_map_uv pass through atan2,
    # whose XLA and torch versions may differ by an ulp, which the 28
    # texels of the plane scale to ~1e-6. On the JAX package's own
    # (u, v) the port's fetch holds 1e-6; end to end, 1e-5.
    dirs = rng.normal(size=(3, 300)).astype(np.float32)
    want = jsky.sample_background_env(jnp.asarray(plane), jnp.asarray(dirs))
    got = psky.sample_background_env(torch.from_numpy(plane), torch.from_numpy(dirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    ju, jv = jsky.fake_env_map_uv(jnp.asarray(dirs), 0.0)
    got = psky.sample_background_2d(torch.from_numpy(plane),
                                    torch.from_numpy(np.array(ju)),
                                    torch.from_numpy(np.array(jv)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ----------------------------------------------------------- debug views

DW, DH = 64, 16  # tiled: the views undo the 8x64 swizzle


@pytest.fixture(scope="module")
def buffers():
    rng = np.random.default_rng(13)
    n = DW * DH
    shapes = dict(view_dir=3, position=3, normal=3, specular=3,
                  diffuse_rgb=3, transparent=3, flow=2, row=R.CTXROW)
    g = {}
    for f in pfg.GBuffers._fields:
        if f == "instance":
            g[f] = rng.integers(-1, 9, n).astype(np.int32)
        elif f == "alpha_dropped":
            g[f] = np.zeros((), np.int32)
        elif f == "flow":
            g[f] = rng.uniform(-40, 40, (2, n)).astype(np.float32)
        elif f in shapes:
            g[f] = rng.uniform(-1, 1, (shapes[f], n)).astype(np.float32)
        else:
            g[f] = rng.uniform(0, 1, n).astype(np.float32)
    extra = [rng.uniform(0, 2, (c, n)).astype(np.float32)
             for c in (4, 4, 3, 3, 3, 3)]
    return g, extra


@pytest.mark.parametrize("mode", list(range(17)) + [23])
def test_debug_visualization_matches(buffers, mode):
    g, extra = buffers
    jcfg = jfg.RenderConfig(rt_width=DW, rt_height=DH, display_width=DW,
                            display_height=DH)
    pcfg = pfg.RenderConfig(rt_width=DW, rt_height=DH, display_width=DW,
                            display_height=DH)
    jg = jfg.GBuffers(**{f: jnp.asarray(v) for f, v in g.items()})
    pg = pfg.GBuffers(**{f: torch.from_numpy(v) for f, v in g.items()})
    want = jfg.debug_visualization(mode, jcfg, jg, *map(jnp.asarray, extra))
    got = pfg.debug_visualization(mode, pcfg, pg, *map(torch.from_numpy, extra))
    assert tuple(got.shape) == (3, DH, DW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# ---------------------------------------------------------------- frames

FW, FH = 64, 48
MODES = (pd.VISUALIZATION_MODE_DEPTH, pd.VISUALIZATION_MODE_INSTANCE_ID)


def _draw_both(sky, modes):
    """Both packages' framebuffers: the layered sample scene after two
    draws, then one draw in each of modes."""
    out = {}
    for side in ("jax", "port"):
        if side == "jax":
            dev, scene, view = jts.build_sample_scene(FW, FH, gi_samples=1)
            _jax_layers(scene, dev)
        else:
            dev, scene, view = pts.build_sample_scene(FW, FH, gi_samples=1,
                                                      device="cpu")
            pts.raster_layers(scene, dev)
        if not sky:
            view.set_sky_plane(None)
        dev.draw()
        dev.draw()
        fbs = [view.framebuffer()[..., :3].copy()]
        for mode in modes:
            view.visualization_mode = mode
            dev.draw()
            fbs.append(view.framebuffer()[..., :3].copy())
        out[side] = fbs
    return out


@pytest.fixture(scope="module")
def sky_frames():
    return _draw_both(True, ())


@pytest.fixture(scope="module")
def no_sky_frames():
    return _draw_both(False, MODES)


def _close(j, p):
    assert p.shape == j.shape == (FH, FW, 3)
    score = ssim(j, p)
    max_abs = int(np.abs(j.astype(int) - p.astype(int)).max())
    assert score >= 0.99, (score, max_abs)


@pytest.mark.parametrize("sky", ["sky", "no_sky"])
def test_layered_frames_match(request, sky):
    """Port against JAX at SSIM >= 0.99 (measured: SSIM 1.0, max abs 0,
    sky plane on and off; 64 wide, one tile column, so both packages
    read the grid planes in the same order)."""
    frames = request.getfixturevalue(f"{sky}_frames")
    _close(frames["jax"][0], frames["port"][0])


@pytest.mark.parametrize("mode", MODES)
def test_debug_view_frames_match(no_sky_frames, mode):
    """A debug view with the HUD drawn over it, through Device.draw()."""
    k = 1 + MODES.index(mode)
    j, p = no_sky_frames["jax"][k], no_sky_frames["port"][k]
    _close(j, p)
    assert not np.array_equal(p, no_sky_frames["port"][0])


def _port_layered_frame(sky, width, height):
    dev, scene, view = pts.build_sample_scene(width, height, gi_samples=1,
                                              device="cpu")
    pts.raster_layers(scene, dev)
    if not sky:
        view.set_sky_plane(None)
    dev.draw()
    dev.draw()
    return view.framebuffer()[..., :3].copy()


@pytest.mark.parametrize("sky", ["sky", "no_sky"])
def test_tiled_frame_matches_untiled(monkeypatch, sky):
    """A frame of 8x64 tiles shows the fixed-grid sky and the raster
    background at the pixels a row-major frame of the same view does.
    The JAX package reads both grid planes in row-major order into its
    tiled frames (ROADMAP queue 3); at 128x64 (two tile columns) its
    sky and skybox land on other pixels."""
    tiled = _port_layered_frame(sky == "sky", 128, 64)
    monkeypatch.setattr(pfg.RenderConfig, "tiled",
                        property(lambda self: False))
    untiled = _port_layered_frame(sky == "sky", 128, 64)
    np.testing.assert_array_equal(tiled, untiled)
