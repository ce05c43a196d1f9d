"""Row tiling in the port (parallel/tiling.py and render_frame's
row_offset) against the JAX package and against the port's whole frame,
on the CPU.

- shard_config gives the JAX package's band fields (rows, display rows,
  full_height, grid_height, display_grid_height, tiling).
- Each band of the glass sample (64x32, gi 1, two reflection bounces,
  boost 16), rendered with render_frame(row_offset=) from the JAX
  package's packed scene, equals the JAX package's band (its
  render_frame called directly, no mesh): RGB8 and instance planes equal
  (the bound of the port's frame tests at 64 wide; measured: equal). The
  camera is still: the JAX package scales a band's flow by the band's
  rows (ROADMAP queue 3).
- The glass sample in 4 bands against the JAX package's frame sharded
  over a mesh of 4 CPU devices (its tiling.sharded_render): RGB8 and
  instance planes equal (64 wide is one tile column, where the port's
  bands are byte-equal to the JAX package's), no alpha drops, history
  planes within the bound of the port's other float-plane parity tests
  against the JAX package (rtol = atol = 1e-5, tests/test_torch_gi.py;
  measured: 5.1e-6, the per-pixel arithmetic of XLA on the CPU against
  torch's, which the bands do not change).
- sharded_render in 2, 4 and 8 bands equals the port's whole frame with
  the denoiser off (the JAX package's tests/test_parallel.py bounds: mean
  abs < 1e-6, max abs < 1e-4, instance planes equal): the glass sample
  and the castle at 128x64, each band count drawn once and held plane by
  plane: the image (and no alpha drops), the instance, flow and depth
  planes, and the history planes.
- 128x40 in two untiled bands of 20 rows while the whole frame is tiled,
  3 frames with the denoiser (GI reprojection on): the same bounds on
  the rows farther than gi_filter_passes from the band edge, whose GI
  filter sees only its band.
- Raster layers (a background triangle instead of the sky plane, and a
  HUD triangle) in 2 and 4 bands equal the whole frame.
- A moving camera: the castle at 128x64 and the sample at 128x40 with
  the denoiser, MOVE_FRAMES frames with the view turned (pitch and yaw)
  before each, so prev_view_proj differs from view_proj and the flow
  plane reaches at least a pixel. In 2 and 4 bands, each frame's image
  (band-edge rows excluded with the denoiser, as above), flow, depth,
  instance and history planes equal the whole frame's with the same
  bounds, the history carried across frames on each side, so
  reprojection reads across band edges; the frames are drawn once for
  each band count and held plane by plane. The port scales a band's flow
  by the whole frame's rows; on the same moved camera the JAX package's
  band (its render_frame with row_offset) has a flow y smaller by the
  factor grid_height / band rows (ROADMAP queue 3, fixed in the port).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rt64tpu.parallel import tiling as jtiling
from rt64tpu.pipeline import framegraph as jfg
from rt64tpu.utils.testscenes import build_sample_scene as jax_sample

from rt64tpu_torch.convert import global_params_from_numpy, scene_buffers_from_numpy
from rt64tpu_torch.ops import bluenoise
from rt64tpu_torch.ops import math3d as pmath3d
from rt64tpu_torch.parallel import tiling
from rt64tpu_torch.pipeline import framegraph as pfg
from rt64tpu_torch.utils.castle_scene import build_castle_scene as port_castle
from rt64tpu_torch.utils.testscenes import build_sample_scene as port_sample
from rt64tpu_torch.utils.testscenes import hud_triangle

MEAN_TOL, MAX_TOL = 1e-6, 1e-4
# Float planes against the JAX package (the flow: pixel differences of
# screen positions; the history planes): XLA's CPU arithmetic against
# torch's (the float-plane parity bound of tests/test_torch_gi.py).
PARITY_TOL = dict(rtol=1e-5, atol=1e-5)
# The moving camera: frames, and the turn before each (degrees of pitch
# and of yaw in view space).
MOVE_FRAMES = 3
TURN_DEG = (1.5, 2.0)


def turned(view_matrix, k):
    """view_matrix turned k steps of TURN_DEG (pitch, yaw) in view space."""
    return pmath3d.turn_view(view_matrix, *np.radians(TURN_DEG) * k)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers side by side, and the torch work
    here is many tiny eager ops: one intra-op thread is the fastest. The
    worker's setting comes back when this file is done."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg_to_port(cfg):
    return pfg.RenderConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(pfg.RenderConfig)})


@pytest.mark.parametrize("size,bands", [((64, 32), 2), ((64, 32), 8),
                                        ((1280, 720), 4), ((128, 40), 2)])
def test_shard_config_matches(size, bands):
    w, h = size
    jcfg = jfg.RenderConfig(rt_width=w, rt_height=h, display_width=w,
                            display_height=h)
    pcfg = pfg.RenderConfig(rt_width=w, rt_height=h, display_width=w,
                            display_height=h)
    jb, pb = jtiling.shard_config(jcfg, bands), tiling.shard_config(pcfg, bands)
    for name in ("rt_width", "rt_height", "display_width", "display_height",
                 "full_height", "grid_height", "display_grid_height", "tiled"):
        assert getattr(pb, name) == getattr(jb, name), name
    assert (pcfg.grid_height, pcfg.display_grid_height) == (h, h)


def test_shard_config_refusals():
    cfg = pfg.RenderConfig(rt_width=64, rt_height=30, display_width=64,
                           display_height=30)
    with pytest.raises(ValueError, match="do not divide"):
        tiling.shard_config(cfg, 4)
    with pytest.raises(ValueError, match="a band already"):
        tiling.shard_config(tiling.shard_config(cfg, 2), 3)


def _glass(make, **kw):
    dev, scene, view = make(width=64, height=32, gi_samples=1,
                               with_glass=True, **kw)
    view.max_reflections = 2
    return dev, scene, view


@pytest.fixture(scope="module")
def jax_bands():
    """The JAX package's glass sample packed once; its two bands through
    its own render_frame(row_offset=), and the same inputs for the port."""
    _, _, view = _glass(jax_sample)
    view.update()
    r = view._renderer
    cfg = dataclasses.replace(r._config(), alpha_shade_boost=16)
    gp = r._global_params(cfg)
    hist = jfg.History.zeros(cfg.rt_height, cfg.rt_width)
    bg = r._background_planes(cfg)
    band = jtiling.shard_config(cfg, 2)
    fn = jax.jit(lambda sb, gp, h, bn, bg, off: jfg.render_frame(
        sb, gp, h, bn, bg, cfg=band, row_offset=off))
    outs = []
    for b in range(2):
        o = fn(r._sb, gp, hist, r.bn_table, bg, jnp.int32(b * band.rt_height))
        assert int(o.alpha_dropped) == 0
        outs.append((np.asarray(o.image),
                     np.asarray(jfg.to_image(band, o.gbuffers.instance))))
    # The view turned once: prev_view_proj is the still frame's.
    view.set_perspective(turned(view.view_matrix, 1), view.fov_radians,
                         view.near_dist, view.far_dist)
    gp_moved = r._global_params(cfg)
    flows = [np.asarray(jfg.to_image(band, fn(
        r._sb, gp_moved, hist, r.bn_table, bg,
        jnp.int32(b * band.rt_height)).gbuffers.flow)) for b in range(2)]
    sb = r._sb
    to_port = lambda gp: global_params_from_numpy(
        {f: np.asarray(getattr(gp, f)) for f in pfg.GlobalParams._fields},
        "cpu")
    port_in = dict(
        sb=scene_buffers_from_numpy(
            {f: (None if getattr(sb, f) is None else np.asarray(getattr(sb, f)))
             for f in sb._fields if f != "features"}, sb.features, "cpu"),
        gp=to_port(gp), gp_moved=to_port(gp_moved), jax_flows=flows,
        cfg=_cfg_to_port(cfg))
    return outs, port_in


@pytest.mark.parametrize("b", [0, 1])
def test_band_matches_jax(jax_bands, b):
    outs, inp = jax_bands
    cfg = inp["cfg"]
    band = tiling.shard_config(cfg, 2)
    bn = torch.from_numpy(bluenoise.packed_table())
    pout = pfg.render_frame(inp["sb"], inp["gp"],
                            pfg.History.zeros(cfg.rt_height, cfg.rt_width, "cpu"),
                            bn, band, row_offset=b * band.rt_height)
    assert int(pout.alpha_dropped) == 0
    j_img, j_inst = outs[b]
    np.testing.assert_array_equal(
        pfg.present_rgb8(pout.image).numpy(),
        pfg.present_rgb8(torch.from_numpy(j_img)).numpy())
    np.testing.assert_array_equal(
        pfg.to_image(band, pout.gbuffers.instance).numpy(), j_inst)


@pytest.mark.parametrize("b", [0, 1])
def test_jax_band_flow_is_scaled_by_the_band_rows(jax_bands, b):
    """The fault the port fixes: a band's flow is in pixels of the whole
    frame in the port, of the band's rows in the JAX package."""
    _, inp = jax_bands
    cfg, gp = inp["cfg"], inp["gp_moved"]
    assert not torch.equal(gp.prev_view_proj, gp.view_proj)
    band = tiling.shard_config(cfg, 2)
    bn = torch.from_numpy(bluenoise.packed_table())
    pout = pfg.render_frame(inp["sb"], gp,
                            pfg.History.zeros(cfg.rt_height, cfg.rt_width, "cpu"),
                            bn, band, row_offset=b * band.rt_height)
    port = pfg.to_image(band, pout.gbuffers.flow).numpy()
    jax_flow = inp["jax_flows"][b]
    assert np.abs(port[1]).max() >= 1.0  # the camera moved vertically
    factor = band.grid_height / band.rt_height
    assert factor == 2
    np.testing.assert_allclose(port[0], jax_flow[0], **PARITY_TOL)
    np.testing.assert_allclose(port[1], jax_flow[1] * factor, **PARITY_TOL)
    assert not np.allclose(port[1], jax_flow[1], **PARITY_TOL)


@pytest.fixture(scope="module")
def jax_mesh_frame():
    """The glass sample drawn by the JAX package over a mesh of 4 CPU
    devices (tests/test_parallel.py's), and the same inputs carried to
    the port."""
    _, _, view = _glass(jax_sample)
    view.update()
    r = view._renderer
    cfg = dataclasses.replace(r._config(), alpha_shade_boost=16)
    assert cfg.refraction_enabled
    gp = r._global_params(cfg)
    bg = r._background_planes(cfg)
    fn = jtiling.sharded_render(jtiling.make_mesh(jax.devices()[:4]), cfg)
    out = fn(r._sb, gp, jfg.History.zeros(cfg.rt_height, cfg.rt_width),
             r.bn_table, bg)
    jout = dict(image=np.asarray(out.image),
                instance=np.asarray(out.gbuffers.instance),
                dropped=int(np.asarray(out.alpha_dropped)),
                history=[np.asarray(p) for p in out.history])
    sb = r._sb
    port_in = dict(
        sb=scene_buffers_from_numpy(
            {f: (None if getattr(sb, f) is None else np.asarray(getattr(sb, f)))
             for f in sb._fields if f != "features"}, sb.features, "cpu"),
        gp=global_params_from_numpy(
            {f: np.asarray(getattr(gp, f)) for f in pfg.GlobalParams._fields},
            "cpu"),
        bg=torch.from_numpy(np.array(bg)),
        cfg=_cfg_to_port(cfg))
    return jout, port_in


def test_four_bands_match_jax_mesh(jax_mesh_frame):
    jout, inp = jax_mesh_frame
    cfg = inp["cfg"]
    bn = torch.from_numpy(bluenoise.packed_table())
    fn = tiling.sharded_render(cfg, 4)
    out = fn(inp["sb"], inp["gp"],
             pfg.History.zeros(cfg.rt_height, cfg.rt_width, "cpu"), bn,
             inp["bg"])
    assert jout["dropped"] == 0 and int(out.alpha_dropped) == 0
    np.testing.assert_array_equal(
        pfg.present_rgb8(out.image).numpy(),
        pfg.present_rgb8(torch.from_numpy(jout["image"])).numpy())
    np.testing.assert_array_equal(out.gbuffers.instance.numpy(),
                                  jout["instance"])
    for name, p, j in zip(pfg.History._fields, out.history, jout["history"]):
        assert p.shape == j.shape, name
        np.testing.assert_allclose(p.numpy(), j, err_msg=name, **PARITY_TOL)


def _frame_inputs(view):
    r = view._renderer
    cfg = r._last_cfg
    return r, cfg, r._global_params(cfg), r._background_planes(cfg)


def compare_plane(cfg, n, whole, banded, plane, keep_rows=None):
    """One plane of a frame drawn in n bands against the whole frame:
    "image" on the rows keep_rows (None: every row) within MEAN_TOL and
    MAX_TOL, with no alpha hit dropped on either side; "instance" equal;
    "flow", "depth" and "history" (each of its planes) on every row (the
    GI filter writes none of them) within MEAN_TOL and MAX_TOL."""
    if plane == "image":
        keep = slice(None) if keep_rows is None else keep_rows
        assert banded.image.shape == whole.image.shape
        diff = (whole.image - banded.image).abs()[:, keep]
        assert float(diff.mean()) < MEAN_TOL
        assert float(diff.max()) < MAX_TOL
        assert int(whole.alpha_dropped) == int(banded.alpha_dropped) == 0
        return
    if plane == "instance":
        torch.testing.assert_close(
            tiling.to_image_banded(cfg, n, banded.gbuffers.instance),
            pfg.to_image(cfg, whole.gbuffers.instance), rtol=0, atol=0)
        return
    if plane == "history":
        planes = [(f"history.{name}", w, b) for name, w, b in
                  zip(pfg.History._fields, whole.history, banded.history)]
    else:
        planes = [(plane, getattr(whole.gbuffers, plane),
                   getattr(banded.gbuffers, plane))]
    for name, w, b in planes:
        assert b.shape == w.shape, name
        diff = (pfg.to_image(cfg, w) - tiling.to_image_banded(cfg, n, b)).abs()
        assert float(diff.mean()) < MEAN_TOL, name
        assert float(diff.max()) < MAX_TOL, name


def _compare(cfg, n, whole, banded, keep_rows=None):
    compare_plane(cfg, n, whole, banded, "image", keep_rows)
    compare_plane(cfg, n, whole, banded, "instance")


def _glass_port():
    dev, _, view = _glass(port_sample, device="cpu")
    return dev, view


def _castle_port():
    dev, _, view = port_castle(128, 64, di_samples=1, gi_samples=1,
                               foliage=12, device="cpu")
    view.max_reflections = 0
    return dev, view


SCENES = {"glass": _glass_port, "castle": _castle_port}


@pytest.fixture(scope="module")
def whole_frames():
    """scene name -> (r, cfg, gp, bg, hist, the whole frame's outputs),
    each scene drawn once, on first use."""
    drawn = {}

    def whole(name):
        if name not in drawn:
            dev, view = SCENES[name]()
            dev.draw()  # settles the alpha boost
            r, cfg, gp, bg = _frame_inputs(view)
            hist = pfg.History.zeros(cfg.rt_height, cfg.rt_width, "cpu")
            drawn[name] = (r, cfg, gp, bg, hist, pfg.render_frame(
                r._sb, gp, hist, r.bn_table, cfg, bg_planes=bg))
        return drawn[name]

    return whole


@pytest.fixture(scope="module",
                params=[(name, n) for name in sorted(SCENES) for n in (2, 4, 8)],
                ids=lambda p: f"{p[0]}-{p[1]}")
def banded_frame(request, whole_frames):
    """A scene's whole frame and the same inputs drawn in n bands: (cfg,
    n, whole, banded)."""
    name, n = request.param
    r, cfg, gp, bg, hist, whole = whole_frames(name)
    banded = tiling.sharded_render(cfg, n)(r._sb, gp, hist, r.bn_table, bg)
    return cfg, n, whole, banded


@pytest.mark.parametrize("plane", ["image", "instance", "flow", "depth",
                                   "history"])
def test_sharded_matches_whole(banded_frame, plane):
    compare_plane(*banded_frame, plane)


def test_banded_history_with_reprojection():
    """The whole frame tiled, its two bands not: each side's history is
    self-consistent, and images compare through to_image."""
    dev, _, view = port_sample(128, 40, gi_samples=1, denoiser=True,
                               device="cpu")
    dev.draw()
    r, cfg, gp, bg = _frame_inputs(view)
    band = tiling.shard_config(cfg, 2)
    assert cfg.tiled and not band.tiled
    assert bool(gp.gi_reproject)
    fn = tiling.sharded_render(cfg, 2)
    keep = band_edge_rows(cfg, 2)
    h_whole = h_band = pfg.History.zeros(cfg.rt_height, cfg.rt_width, "cpu")
    for f in range(3):
        gp_f = gp._replace(frame_count=torch.tensor(f))
        whole = pfg.render_frame(r._sb, gp_f, h_whole, r.bn_table, cfg,
                                 bg_planes=bg)
        banded = fn(r._sb, gp_f, h_band, r.bn_table, bg)
        h_whole, h_band = whole.history, banded.history
        _compare(cfg, 2, whole, banded, keep_rows=keep)
    assert float(whole.indirect_accum[3].max()) > 1.5  # reprojected


@pytest.mark.parametrize("n", [2, 4])
def test_banded_raster_layers(n):
    dev, scene, view = port_sample(64, 32, gi_samples=1, device="cpu")
    view.max_reflections = 0
    view.set_sky_plane(None)
    hud_triangle(scene, dev, background=True)
    hud_triangle(scene, dev)
    dev.draw()
    r, cfg, gp, bg = _frame_inputs(view)
    assert r._sb.features.has_raster_bg and r._sb.raster_fg.shape[0]
    hist = pfg.History.zeros(cfg.rt_height, cfg.rt_width, "cpu")
    whole = pfg.render_frame(r._sb, gp, hist, r.bn_table, cfg, bg_planes=bg)
    banded = tiling.sharded_render(cfg, n)(r._sb, gp, hist, r.bn_table, bg)
    _compare(cfg, n, whole, banded)


def _sample_denoiser_port():
    dev, _, view = port_sample(128, 40, gi_samples=1, denoiser=True,
                               device="cpu")
    return dev, view


MOVING = {"castle": _castle_port, "sample_denoiser": _sample_denoiser_port}


@pytest.fixture(scope="module", params=sorted(MOVING))
def moving_whole(request):
    """MOVE_FRAMES frames of a scene with the view turned before each,
    drawn whole with the history carried: (r, cfg, [gp of each frame],
    bg, [whole frame outputs])."""
    dev, view = MOVING[request.param]()
    dev.draw()  # settles the alpha boost
    r = view._renderer
    cfg = r._last_cfg
    bg = r._background_planes(cfg)
    vm0 = view.view_matrix.copy()
    gps, wholes = [], []
    hist = pfg.History.zeros(cfg.rt_height, cfg.rt_width, "cpu")
    for f in range(MOVE_FRAMES):
        view.set_perspective(turned(vm0, f + 1), view.fov_radians,
                             view.near_dist, view.far_dist)
        gp = r._global_params(cfg)._replace(frame_count=torch.tensor(f))
        assert not torch.equal(gp.prev_view_proj, gp.view_proj)
        whole = pfg.render_frame(r._sb, gp, hist, r.bn_table, cfg,
                                 bg_planes=bg)
        flow = pfg.to_image(cfg, whole.gbuffers.flow)
        assert float(flow.abs().max()) >= 1.0, f"frame {f}: flow below a pixel"
        assert float(flow[1].abs().max()) >= 1.0, f"frame {f}: no vertical flow"
        hist = whole.history
        gps.append(gp)
        wholes.append(whole)
    return r, cfg, gps, bg, wholes


def band_edge_rows(cfg, n):
    """Rows to keep in the image comparison: with the denoiser, those
    farther than gi_filter_passes from a band edge (the GI filter sees
    only its band); else None (every row)."""
    if not cfg.denoiser_enabled:
        return None
    band = tiling.shard_config(cfg, n)
    keep = torch.ones(cfg.rt_height, dtype=torch.bool)
    for b in range(1, n):
        lo = b * band.rt_height
        keep[lo - cfg.gi_filter_passes: lo + cfg.gi_filter_passes] = False
    return keep


@pytest.fixture(scope="module", params=[2, 4])
def moving_bands(request, moving_whole):
    """moving_whole's frames drawn in n bands, the history carried from
    zeros: (n, [the bands' outputs of each frame])."""
    n = request.param
    r, cfg, gps, bg, _ = moving_whole
    fn = tiling.sharded_render(cfg, n)
    hist = pfg.History.zeros(cfg.rt_height, cfg.rt_width, "cpu")
    outs = []
    for gp in gps:
        out = fn(r._sb, gp, hist, r.bn_table, bg)
        hist = out.history
        outs.append(out)
    return n, outs


@pytest.mark.parametrize("plane", ["image", "flow", "depth", "history"])
def test_moving_camera_bands_match_whole(moving_whole, moving_bands, plane):
    """Each frame's plane against the whole frame's; "image" also holds
    the instance plane, and with the denoiser leaves out the rows by a
    band edge (band_edge_rows)."""
    _, cfg, _, _, wholes = moving_whole
    n, outs = moving_bands
    for f, (whole, banded) in enumerate(zip(wholes, outs)):
        try:
            if plane == "image":
                _compare(cfg, n, whole, banded,
                         keep_rows=band_edge_rows(cfg, n))
            else:
                compare_plane(cfg, n, whole, banded, plane)
        except AssertionError as exc:
            raise AssertionError(f"frame {f}: {exc}") from exc
