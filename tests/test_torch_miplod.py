"""Ray-differential mip LOD in the port against the JAX package, on the
CPU.

Units: mip_select (exact, against the JAX function and the chain layout
of generate_mips), generate_mips (exact), the six ray-differential
functions (1e-5, seeded inputs), and the quad pool, records and instance
rows of a mip-enabled scene (exact against the JAX packer).

Frames: the minification floor of tests/test_miplod.py (a 1-texel
checker tiled 64x on a floor running to the horizon, 128x96) with
SHADER_MIP_LOD_ENABLED, through rt64tpu_torch.convert and through each
package's own Device.draw(): RGB8 SSIM >= 0.99 and instance ids equal on
>= 99.5 % of the pixels; and the port alone holds the JAX test's
dealiasing property: over the floor band, the flag cuts the pixel
standard deviation below 0.35 of the flag-off frame's and keeps the band
mean within 0.02.

The floor's scene bucket (16 triangles) is smaller than a cluster: one
test holds the port's padded cluster tables (the K1 and K3 twins) to the
reference tracer there, where the JAX packet path asserts.

Measured on the CPU (torch 2.13, jax 0.9): units exact / within 3e-7;
the floor through convert SSIM 1.0 with ids equal on every pixel, own
API SSIM 1.0; band std 0.127 -> 0.0074 (ratio 0.058), band means 0.5837
/ 0.5856.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import rt64tpu
from rt64tpu import descriptors as jd
from rt64tpu.limits import SceneLimits as JaxLimits
from rt64tpu.ops import math3d as jmath3d
from rt64tpu.ops import mipmaps as jmips
from rt64tpu.ops import raydiff as jrd
from rt64tpu.ops import texture as jtex
from rt64tpu.pipeline import framegraph as jfg
from rt64tpu.utils.testscenes import SID_TEXTURE, checker_texture, interleave

from rt64tpu_torch.convert import (
    global_params_from_numpy,
    rows_to_slots,
    scene_buffers_from_numpy,
)
from rt64tpu_torch.ops import bluenoise as pbn
from rt64tpu_torch.ops import mipmaps as pmips
from rt64tpu_torch.ops import raydiff as prd
from rt64tpu_torch.ops import texture as ptex
from rt64tpu_torch.pipeline import framegraph as pfg
from rt64tpu_torch.pipeline import rows as R
from rt64tpu_torch.utils.ssim import ssim
from rt64tpu_torch.utils.testscenes import build_mip_floor


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers side by side, and the torch work
    here is many tiny eager ops: one intra-op thread is the fastest. The
    worker's setting comes back when this file is done."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SHAPES = [(64, 64), (48, 16), (33, 7), (1, 8), (2, 2)]


@pytest.mark.parametrize("w,h", SHAPES)
def test_generate_mips_matches(w, h):
    rgba = np.random.default_rng(w * 100 + h).integers(
        0, 255, (h, w, 4), dtype=np.uint8)
    for max_levels in (ptex.MAX_MIP_LEVELS, 16):
        want = jmips.generate_mips(rgba, max_levels=max_levels)
        got = pmips.generate_mips(rgba, max_levels=max_levels)
        assert len(got) == len(want)
        for g, w_ in zip(got, want):
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g, w_)


@pytest.mark.parametrize("w,h", SHAPES)
def test_mip_select_matches(w, h):
    """Every baked level resolves to its offset and dims in the chain
    generate_mips lays out; levels past the chain clamp to the last one;
    equal to the JAX function lane for lane."""
    assert ptex.MAX_MIP_LEVELS == jtex.MAX_MIP_LEVELS
    rgba = np.zeros((h, w, 4), np.uint8)
    levels = pmips.generate_mips(rgba, max_levels=ptex.MAX_MIP_LEVELS)
    base = 1000
    offs, dims, o = [], [], base
    for lv in levels:
        offs.append(o)
        dims.append((lv.shape[1], lv.shape[0]))
        o += lv.shape[0] * lv.shape[1]
    query = np.arange(ptex.MAX_MIP_LEVELS + 2, dtype=np.int32)
    got = ptex.mip_select(torch.tensor(base, dtype=torch.int32),
                          torch.tensor(w), torch.tensor(h),
                          torch.from_numpy(query))
    want = jtex.mip_select(jnp.int32(base), jnp.int32(w), jnp.int32(h),
                           jnp.asarray(query))
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    for lq in query:
        li = min(int(lq), len(levels) - 1)
        assert int(got[0][lq]) == offs[li]
        assert (int(got[1][lq]), int(got[2][lq])) == dims[li]
    # Per-lane records (the frame passes row columns, one per ray).
    n = 64
    rng = np.random.default_rng(5)
    lo = rng.integers(0, 5000, n).astype(np.int32)
    ws = rng.integers(1, 80, n).astype(np.int32)
    hs = rng.integers(1, 80, n).astype(np.int32)
    lv = rng.integers(0, 10, n).astype(np.int32)
    got = ptex.mip_select(*(torch.from_numpy(a) for a in (lo, ws, hs, lv)))
    want = jtex.mip_select(*(jnp.asarray(a) for a in (lo, ws, hs, lv)))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def _rand3(rng, n, scale=1.0):
    return (rng.normal(size=(3, n)) * scale).astype(np.float32)


def _close(got, want, tol=1e-5):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def _raydiff_inputs():
    rng = np.random.default_rng(6)
    n = 2048
    d = _rand3(rng, n, 2.0)
    d[2] = -np.abs(d[2]) - 1.0  # camera rays look down -z
    e1, e2 = _rand3(rng, n), _rand3(rng, n)
    fn = np.cross(e1, e2, axis=0).astype(np.float32)
    # Rays meet the face at a slant, never grazing it.
    d = np.where((d * fn).sum(0) > 0, -d, d).astype(np.float32)
    cos = np.abs((d * fn).sum(0)) / (np.linalg.norm(d, axis=0)
                                     * np.linalg.norm(fn, axis=0))
    keep = cos > 0.2
    pick = lambda a: np.ascontiguousarray(a[..., keep])
    d, e1, e2, fn = pick(d), pick(e1), pick(e2), pick(fn)
    m = d.shape[1]
    uv = [rng.uniform(0, 8, (2, m)).astype(np.float32) for _ in range(3)]
    t = rng.uniform(0.5, 40.0, m).astype(np.float32)
    cam_u = np.array([0.8, 0.0, 0.1], np.float32)
    cam_v = np.array([0.0, 0.6, 0.05], np.float32)
    return dict(d=d, e1=e1, e2=e2, fn=fn, uv=uv, t=t, cam_u=cam_u,
                cam_v=cam_v, od=_rand3(rng, m, 1e-3), ody=_rand3(rng, m, 1e-3))


def _both(fn_j, fn_p, *args):
    j = fn_j(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
               for a in args))
    p = fn_p(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
               for a in args))
    return p, j


@pytest.mark.parametrize("name", [
    "compute_ray_diffs", "propagate", "barycentric_differentials",
    "texture_differentials", "uv_differentials", "lod_from_duv",
])
def test_raydiff_matches(name):
    x = _raydiff_inputs()
    ddx, ddy = (np.array(a) for a in jrd.compute_ray_diffs(
        jnp.asarray(x["d"]), jnp.asarray(x["cam_u"]), jnp.asarray(x["cam_v"]),
        (128.0, 96.0)))
    if name == "compute_ray_diffs":
        got, want = _both(jrd.compute_ray_diffs, prd.compute_ray_diffs,
                          x["d"], x["cam_u"], x["cam_v"], (128.0, 96.0))
    elif name == "propagate":
        got, want = _both(jrd.propagate, prd.propagate, x["od"], x["ody"],
                          ddx, ddy, x["d"], x["t"], x["fn"])
    elif name == "barycentric_differentials":
        got, want = _both(jrd.barycentric_differentials,
                          prd.barycentric_differentials, x["od"], x["ody"],
                          x["e1"], x["e2"], x["fn"])
    elif name == "texture_differentials":
        rng = np.random.default_rng(7)
        m = x["t"].shape[0]
        bx = tuple(rng.normal(size=m).astype(np.float32) for _ in range(2))
        by = tuple(rng.normal(size=m).astype(np.float32) for _ in range(2))
        want = jrd.texture_differentials(
            tuple(jnp.asarray(a) for a in bx), tuple(jnp.asarray(a) for a in by),
            *(jnp.asarray(a) for a in x["uv"]))
        got = prd.texture_differentials(
            tuple(torch.from_numpy(a) for a in bx),
            tuple(torch.from_numpy(a) for a in by),
            *(torch.from_numpy(a) for a in x["uv"]))
    elif name == "uv_differentials":
        got, want = _both(jrd.uv_differentials, prd.uv_differentials, ddx, ddy,
                          x["d"], x["t"], x["e1"], x["e2"], x["fn"], *x["uv"])
    else:
        dx, dy = (np.array(a) for a in jrd.uv_differentials(
            *(jnp.asarray(a) for a in (ddx, ddy, x["d"], x["t"], x["e1"],
                                       x["e2"], x["fn"], *x["uv"]))))
        rng = np.random.default_rng(8)
        m = x["t"].shape[0]
        wf = rng.choice([1.0, 7.0, 64.0, 256.0], m).astype(np.float32)
        hf = rng.choice([1.0, 8.0, 64.0], m).astype(np.float32)
        dx[:, :8] = 0.0  # a zero footprint: lod 0
        for max_level in (None, 7.0):
            got, want = _both(
                lambda *a: jrd.lod_from_duv(*a, max_level=max_level),
                lambda *a: prd.lod_from_duv(*a, max_level=max_level),
                dx, dy, wf, hf)
            _close(got, want)
            assert (got.numpy() >= 0).all()
        assert (got.numpy() > 0.5).any() and (got.numpy() == 7.0).any()
        return
    _close(got, want)


def _jax_floor(mip_enabled, width=128, height=96):
    """tests/test_miplod.py's floor, kept as (device, scene, view)."""
    limits = JaxLimits(max_vertices=64, max_triangles=16, max_instances=2,
                       max_textures=4, texel_pool=1 << 16)
    device = rt64tpu.Device(limits)
    scene = rt64tpu.Scene(device)
    view = rt64tpu.View(scene, width=width, height=height)
    checker = checker_texture(device, size=64, cell=1)
    flags = jd.SHADER_RAYTRACE_ENABLED
    if mip_enabled:
        flags |= jd.SHADER_MIP_LOD_ENABLED
    shader = rt64tpu.Shader(
        device, SID_TEXTURE, filter=jd.SHADER_FILTER_LINEAR,
        h_addr=jd.SHADER_ADDRESSING_WRAP, v_addr=jd.SHADER_ADDRESSING_WRAP,
        flags=flags,
    )
    fv = [
        ((-40, 0, -400), (0, 1, 0), (0, 0)),
        ((40, 0, -400), (0, 1, 0), (64, 0)),
        ((40, 0, 0), (0, 1, 0), (64, 64)),
        ((-40, 0, 0), (0, 1, 0), (0, 64)),
    ]
    fidx = np.array([0, 2, 1, 0, 3, 2], np.uint32)
    mesh = rt64tpu.Mesh(device, jd.MESH_RAYTRACE_ENABLED)
    fdata = interleave(fv, with_uv=True)
    mesh.set_mesh(fdata, 4, fdata.shape[1] * 4, fidx)
    inst = rt64tpu.Instance(scene)
    inst.set_description(jd.InstanceDesc(
        mesh=mesh, transform=np.eye(4, dtype=np.float32),
        diffuse_texture=checker, shader=shader, material=jd.Material(),
    ))
    sd = scene.desc
    sd.ambient_base_color = (1.0, 1.0, 1.0)
    scene.set_description(sd)
    vm = jmath3d.look_at_rh((0.0, 1.5, 4.0), (0.0, 0.6, -20.0),
                            (0.0, 1.0, 0.0))
    view.set_perspective(vm, 0.9, 0.1, 1000.0)
    return device, scene, view


def test_mip_scene_packs_like_jax():
    """Quad pool (every level of the chain), records and instance rows
    of the mip-enabled floor, exact; the flag-off floor packs one level."""
    for mip in (True, False):
        _, _, jview = _jax_floor(mip)
        jview.update()
        jsb = jview._renderer._sb
        _, _, pview = build_mip_floor(mip, device="cpu")
        pview.update()
        psb = pview._renderer._sb
        assert jsb.features.has_mips == psb.features.has_mips == mip
        np.testing.assert_array_equal(
            psb.quad_pool.numpy(), np.asarray(jsb.quad_pool).astype(np.int64))
        np.testing.assert_array_equal(psb.quad_records.numpy(),
                                      np.asarray(jsb.quad_records))
        np.testing.assert_array_equal(
            rows_to_slots(psb.instance_rows.numpy(), R.I_LMASK,
                          psb.light_groups.numpy(), int(psb.light_count)),
            np.asarray(jsb.instance_rows))
        used = int(np.count_nonzero(np.asarray(jsb.quad_pool)))
        chain = sum(lv.shape[0] * lv.shape[1] for lv in pmips.generate_mips(
            np.zeros((64, 64, 4), np.uint8), ptex.MAX_MIP_LEVELS))
        assert used == 4 * (chain if mip else 64 * 64)


@pytest.fixture(scope="module")
def floor_frames():
    """The mip floor through the JAX package's own API and frame program,
    and through the port's API."""
    jdev, _, jview = _jax_floor(True)
    jdev.draw()
    j_fb = jview.framebuffer().copy()
    r = jview._renderer
    jview.frame_count = 0
    cfg = r._config()
    fn = r._get_jitted(cfg, 0)
    gp = r._global_params(cfg)
    hist = jfg.History.zeros(cfg.rt_height, cfg.rt_width)
    out, present = fn(r._sb, gp, hist, r.bn_table, r._background_planes(cfg),
                      None)
    j = dict(img=np.asarray(present), inst=np.asarray(out.gbuffers.instance))
    sb_t = scene_buffers_from_numpy(
        {f: (None if getattr(r._sb, f) is None else np.asarray(getattr(r._sb, f)))
         for f in r._sb._fields if f != "features"}, r._sb.features, "cpu")
    gp_t = global_params_from_numpy(
        {f: np.asarray(getattr(gp, f)) for f in pfg.GlobalParams._fields}, "cpu")
    cfg_t = pfg.RenderConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(pfg.RenderConfig)})
    pout = pfg.render_frame(sb_t, gp_t,
                            pfg.History.zeros(cfg.rt_height, cfg.rt_width, "cpu"),
                            torch.from_numpy(pbn.packed_table()), cfg_t)
    p = dict(img=pfg.present_rgb8(pout.image).numpy(),
             inst=pout.gbuffers.instance.numpy())
    pdev, _, pview = build_mip_floor(True, device="cpu")
    pdev.draw()
    return j, p, j_fb, pview.framebuffer()


def test_mip_floor_through_convert(floor_frames):
    j, p, _, _ = floor_frames
    s = ssim(j["img"], p["img"])
    same = (j["inst"] == p["inst"]).mean()
    print(f"mip floor convert ssim={s} inst_agree={same}")
    assert s >= 0.99 and same >= 0.995 and (p["inst"] >= 0).any()


def test_mip_floor_through_own_api(floor_frames):
    _, _, j_fb, p_fb = floor_frames
    assert p_fb.shape == j_fb.shape == (96, 128, 4)
    s = ssim(j_fb[..., :3], p_fb[..., :3])
    print(f"mip floor own-API ssim={s}")
    assert s >= 0.99


def test_miplod_reduces_minification_aliasing():
    """tests/test_miplod.py's property, on the port's frames."""
    frames = {}
    for mip in (False, True):
        dev, _, view = build_mip_floor(mip, device="cpu")
        dev.draw()
        frames[mip] = np.asarray(view.framebuffer()[..., :3], np.float64) / 255.0
    h = frames[False].shape[0]
    band = slice(int(h * 0.52), int(h * 0.78))
    std_base = float(frames[False][band].std())
    std_mip = float(frames[True][band].std())
    print(f"band std {std_base} -> {std_mip}")
    assert std_base > 0.03, f"scene not aliasing; bad framing ({std_base})"
    assert std_mip < 0.35 * std_base, (std_mip, std_base)
    assert abs(float(frames[True][band].mean())
               - float(frames[False][band].mean())) < 0.02


@pytest.mark.parametrize("resident", [True, False], ids=["k1", "k3"])
def test_scene_smaller_than_a_cluster(resident, monkeypatch):
    """The floor's scene bucket holds 16 triangles, less than one cluster
    of either table. The JAX package's packet path asserts on it
    (tracer_pallas.build_cluster_data wants a multiple of 128; its CPU
    config never takes that path); the port pads the tables with
    invalid triangles (tracer_cuda.padded_to_clusters), and its K1/K3
    twins find the reference tracer's hits on the floor's camera rays."""
    from rt64tpu.ops import tracer_pallas as jtp
    from rt64tpu_torch.ops import tracer as ptr
    from rt64tpu_torch.ops import tracer_cuda as tc
    from rt64tpu_torch.ops import shading as psh

    monkeypatch.setattr(tc, "RESIDENT_TABLE_BYTES", 1 << 40 if resident else 0)
    _, _, view = build_mip_floor(True, width=64, height=32, device="cpu")
    view.update()
    r = view._renderer
    sb, cfg = r._sb, r._config()
    assert sb.tri_valid.shape[0] == 16
    _, rows_t = psh.build_tri_rows(sb)
    scene = pfg.make_trace_scene(sb, rows_t, cfg.alpha_cap)
    jscene = jfg.tracer.TraceScene(
        *(jnp.asarray(getattr(scene, f).numpy()) for f in (
            "v0", "v1", "v2", "valid", "alpha", "no_cull", "bias",
            "alpha_idx")))
    with pytest.raises(AssertionError):
        jtp.build_cluster_data(jscene)

    padded = tc.padded_to_clusters(scene, tc.K_CS if resident else
                                   tc.CLUSTER_SIZE)
    assert padded.num_triangles == (tc.K_CS if resident else tc.CLUSTER_SIZE)
    assert not padded.valid[16:].any()
    _, origins, dirs = pfg.primary_rays(cfg, r._global_params(cfg))
    n = dirs.shape[1]
    t_min = torch.full((n,), ptr.RAY_MIN_DISTANCE)
    t_max = torch.full((n,), ptr.RAY_MAX_DISTANCE)
    want = ptr.trace(origins, dirs, t_min, t_max, scene, k_alpha=0)
    t, tri, uv, _ = tc.make_opaque_fn()(origins, dirs, t_min, t_max, scene)
    assert (tri >= 0).float().mean() > 0.3
    assert torch.equal(tri, want.tri_op)
    hit = tri >= 0
    torch.testing.assert_close(t[hit], want.t_op[hit], rtol=1e-4, atol=1e-4)
