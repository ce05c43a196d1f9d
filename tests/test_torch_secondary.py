"""Reflections and refraction in the port against the JAX package, on
the CPU.

Units, on identical seeded inputs at 1e-5: HLSL refract with a
non-normalized incident ray (total internal reflection included), the
fresnel term, the one-light estimate without shadow rays
(compute_lights_random with check_shadows=False: lights chosen exactly
equal) and the fog + lighting split fold of the secondary passes
(_lit_secondary_fold, both store modes) on castle camera rays through
JAX-packed scene buffers.

Frames, through rt64tpu_torch.convert (the JAX package packs the scene
and the camera, both frame graphs render it) and through each package's
own Device.draw():
(a) the sample scene with_glass=True at 64x32, gi_samples=1,
    max_reflections=2, its glass sphere made half transparent: a
    refractive surface seeds refraction only with the alpha it lets
    through (PrimaryRayGen.hlsl:156-161), so the opaque glass of the
    stock scene leaves the refraction plane at zero in both packages;
(b) the castle at 128x64 with max_reflections=2 (its moat mirrors);
(c) (a) again with the port's size switch at 0, so the reflection and
    refraction rays take the K3/K4 twins (the JAX CPU config traces
    with its XLA tracer whichever the switch says).
Tolerances: RGB8 SSIM >= 0.99, instance ids equal on >= 99.5 % of the
pixels, and the reflection and refraction planes within 1e-4 on >= 99 %
of the pixels whose ids agree. The JAX CPU config traces with its XLA
tracer and the port with the plain twins of its kernels (Woop or
Moller-Trumbore), so a mirror ray that grazes an edge may land on the
neighbouring triangle.

Measured on the CPU (torch 2.13, jax 0.9): (a) through convert SSIM
1.0, ids equal on every pixel, reflection / refraction max abs error
1.1e-6 / 3.7e-7 (100 % within 1e-4), own API SSIM 1.0; (b) through
convert SSIM 1.0, ids equal on every pixel, reflection max abs error
3.1e-6, own API SSIM 1.0; (c) SSIM 1.0, ids equal, 4.2e-7 / 3.6e-7, with
4 K3-twin traces (the second reflection bounce has no live mirror ray
and is not traced), 3 K4-twin traces and no K1/K2-twin trace. Since the
port reads the fixed-grid sky in the tiled frame's order (the JAX package in
row-major order, ROADMAP queue 3), (b) differs at sky pixels by at most
2/255: SSIM 0.9984 through convert and through the own API. Units: refract,
fresnel and the light within 1e-5 (chosen lights equal); the fold
stores the same instance on every ray, what reads no hit distance is
exactly equal, and colour / position / transparent differ by at most
1.8e-5 / 1.9e-5 / 2.4e-7 (99.9 % of the rays within 1e-5).

One test holds the plain twins of K1-K4 and build_work_items to "no
hit" on a batch whose every ray is dead (t_max = -1), the shape of a
second reflection bounce with nothing left to mirror.
"""

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
from rt64tpu.utils.castle_scene import build_castle_scene as jax_castle
from rt64tpu.utils.testscenes import build_sample_scene as jax_sample

from rt64tpu_torch.convert import (
    ctx_rows_from_slots,
    global_params_from_numpy,
    scene_buffers_from_numpy,
)
from rt64tpu_torch.ops import bluenoise as pbn
from rt64tpu_torch.ops import lighting as pli
from rt64tpu_torch.ops import shading as psh
from rt64tpu_torch.ops import tracer as ptr
from rt64tpu_torch.ops import tracer_cuda as tc
from rt64tpu_torch.pipeline import framegraph as pfg
from rt64tpu_torch.pipeline import rows as R
from rt64tpu_torch.utils import profiling
from rt64tpu_torch.utils.castle_scene import build_castle_scene as port_castle
from rt64tpu_torch.utils.ssim import ssim
from rt64tpu_torch.utils.testscenes import build_sample_scene as port_sample
from rt64tpu_torch.utils.testscenes import make_glass_translucent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers side by side, and the torch work
    here is many tiny eager ops: one intra-op thread is the fastest. The
    worker's setting comes back when this file is done."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sb_to_port(sb):
    return scene_buffers_from_numpy(
        {f: (None if getattr(sb, f) is None else np.asarray(getattr(sb, f)))
         for f in sb._fields if f != "features"}, sb.features, "cpu")


def _gp_to_port(gp):
    return global_params_from_numpy(
        {f: np.asarray(getattr(gp, f)) for f in pfg.GlobalParams._fields}, "cpu")


def _cfg_to_port(cfg):
    return pfg.RenderConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(pfg.RenderConfig)})


def _unit_dirs(rng, n):
    d = rng.normal(size=(3, n)).astype(np.float32)
    return (d / np.linalg.norm(d, axis=0)).astype(np.float32)


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------


def test_refract_matches():
    """Non-normalized incident rays (the reference passes the raw
    camera direction), eta below and above 1, so that some rays meet
    total internal reflection (k < 0 gives 0)."""
    rng = np.random.default_rng(10)
    n = 4096
    d = (_unit_dirs(rng, n) * rng.uniform(0.2, 5.0, n)).astype(np.float32)
    nrm = _unit_dirs(rng, n)
    eta = rng.choice([0.0, 0.7, 1.0, 1.2, 1.5], n).astype(np.float32)
    want = np.asarray(jfg._refract(jnp.asarray(d), jnp.asarray(nrm),
                                   jnp.asarray(eta)))
    got = pfg._refract(torch.from_numpy(d), torch.from_numpy(nrm),
                       torch.from_numpy(eta)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    tir = (got == 0.0).all(axis=0)
    assert 0 < tir.sum() < n  # both branches of the k >= 0 select ran
    assert (tir == (np.asarray(want) == 0.0).all(axis=0)).all()


def test_fresnel_matches():
    rng = np.random.default_rng(11)
    n = 4096
    nrm = _unit_dirs(rng, n)
    inc = (_unit_dirs(rng, n) * rng.uniform(0.5, 3.0, n)).astype(np.float32)
    refl = rng.uniform(0, 1, n).astype(np.float32)
    mult = rng.uniform(0, 1, n).astype(np.float32)
    args = (nrm, inc, refl, mult)
    want = np.asarray(jfg._fresnel(*(jnp.asarray(a) for a in args)))
    got = pfg._fresnel(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def castle_state():
    """The castle at 64x16 packed by the JAX package, its camera rays
    and both packages' tracing state for it."""
    _, _, view = jax_castle(width=64, height=16, gi_samples=0, foliage=12)
    view.max_reflections = 2
    view.update()
    r = view._renderer
    sb, cfg = r._sb, r._config()
    gp = r._global_params(cfg)
    sb_t, gp_t, cfg_t = _sb_to_port(sb), _gp_to_port(gp), _cfg_to_port(cfg)
    jrows, jrows_t = jsh.build_tri_rows(sb)
    jscene = jfg.make_trace_scene(sb, jrows_t, cfg.alpha_cap)
    prows, prows_t = psh.build_tri_rows(sb_t)
    pscene = pfg.make_trace_scene(sb_t, prows_t, cfg_t.alpha_cap)
    return dict(sb=sb, cfg=cfg, gp=gp, sb_t=sb_t, gp_t=gp_t, cfg_t=cfg_t,
                jrows=jrows, jscene=jscene, prows=prows, pscene=pscene)


def test_compute_lights_random_without_shadows_matches(castle_state):
    """The reflection pass's one-light estimate (check_shadows=False):
    no shadow ray is traced, the chosen light of every ray exactly
    equal, the light to 1e-5."""
    st = castle_state
    sb, cfg, gp, sb_t, gp_t, cfg_t = (st[k] for k in (
        "sb", "cfg", "gp", "sb_t", "gp_t", "cfg_t"))
    rows = np.asarray(st["jrows"])
    n = cfg.rt_width * cfg.rt_height
    rng = np.random.default_rng(12)
    tri = rng.choice(np.flatnonzero(np.asarray(sb.tri_valid)), n).astype(np.int32)
    tri[rng.uniform(size=n) < 0.15] = -1
    u = rng.uniform(0, 1, n).astype(np.float32)
    v = (rng.uniform(0, 1, n) * (1 - u)).astype(np.float32)
    g = rows[np.maximum(tri, 0)].T
    p0, p1, p2 = (g[o:o + 3] for o in (R.T_P0, R.T_P1, R.T_P2))
    pos = (p0 * (1 - u - v) + p1 * u + p2 * v).astype(np.float32)
    nrm = np.cross(p1 - p0, p2 - p0, axis=0)
    nrm = (nrm / np.maximum(np.linalg.norm(nrm, axis=0), 1e-12)).astype(np.float32)
    dirs = _unit_dirs(rng, n)
    nrm = np.where((nrm * dirs).sum(0) > 0, -nrm, nrm).astype(np.float32)
    spec = rng.uniform(0, 1, (3, n)).astype(np.float32)
    noise = rng.uniform(size=n).astype(np.float32)
    ctx_rows = np.array(jfg._row_of(jnp.asarray(rows), jnp.asarray(tri),
                                      jnp.asarray(tri >= 0)))

    jctx = jli.ctx_from_rows(jnp.asarray(ctx_rows), jnp.asarray(tri >= 0))
    jargs = (jfg._pixel_grid(cfg), jnp.asarray(jbn.packed_table()),
             gp.frame_count, jnp.asarray(dirs), jnp.asarray(pos),
             jnp.asarray(nrm), jnp.asarray(spec), jctx)
    jlight, jdrop = jli.compute_lights_random(
        sb, st["jrows"], st["jscene"], *jargs, max_light_count=1,
        di_samples=1, check_shadows=False, noise_rand=jnp.asarray(noise))
    jplan = jli.plan_lights(sb, *jargs, 1, 1, jnp.asarray(noise))

    t = torch.from_numpy
    pctx = pli.ctx_from_rows(t(ctx_rows_from_slots(ctx_rows)), t(tri >= 0))
    pargs = (pfg._pixel_grid(cfg_t, "cpu"), t(pbn.packed_table()),
             gp_t.frame_count, t(dirs), t(pos), t(nrm), t(spec), pctx)
    launches = vars(tc.launch_counts).copy()
    plight, pdrop = pli.compute_lights_random(
        sb_t, st["prows"], st["pscene"], *pargs, max_light_count=1,
        di_samples=1, check_shadows=False, noise_rand=t(noise))
    pplan = pli.plan_lights(sb_t, *pargs, 1, 1, t(noise))

    assert int(jdrop) == int(pdrop) == 0
    assert vars(tc.launch_counts) == launches  # no shadow trace at all
    (j_active, _, j_ldiff, *_), = jplan.rounds
    (p_active, _, p_ldiff, *_), = pplan.rounds
    np.testing.assert_array_equal(_np(j_active), _np(p_active))
    np.testing.assert_array_equal(_np(j_ldiff), _np(p_ldiff))
    assert len({tuple(c) for c in _np(p_ldiff).T[_np(p_active)]}) == 2
    np.testing.assert_allclose(_np(plight), _np(jlight), rtol=1e-5, atol=1e-5)
    assert _np(plight).max() > 0.05


@pytest.mark.parametrize("store_any,fog_mode",
                         [(False, "camera"), (True, "origin")],
                         ids=["refraction", "reflection"])
def test_lit_secondary_fold_matches(castle_state, store_any, fog_mode):
    """The fold over the castle's camera rays (alpha foliage in the
    slots, a fifth of the rays dead): the stored hit, colour, residual
    alpha and fog-transparent term of every ray whose stored instance
    agrees, at 1e-5."""
    st = castle_state
    cfg, gp, cfg_t, gp_t = st["cfg"], st["gp"], st["cfg_t"], st["gp_t"]
    _, origins, dirs = jfg.primary_rays(cfg, gp)
    noise = np.array(jfg._noise_rand(cfg, gp, jfg._pixel_grid(cfg)))
    origins, dirs = np.array(origins), np.array(dirs)
    n = dirs.shape[1]
    rng = np.random.default_rng(13)
    t_min = np.full(n, ptr.RAY_MIN_DISTANCE, np.float32)
    t_max = np.where(rng.uniform(size=n) < 0.2, -1.0,
                     ptr.RAY_MAX_DISTANCE).astype(np.float32)
    args = (origins, dirs, t_min, t_max, noise)
    want = jfg._lit_secondary_fold(
        st["sb"], gp, cfg, st["jrows"], st["jscene"],
        *(jnp.asarray(a) for a in args), fog_mode=fog_mode,
        store_any=store_any)
    got = pfg._lit_secondary_fold(
        st["sb_t"], gp_t, cfg_t, st["prows"], st["pscene"],
        *(torch.from_numpy(a) for a in args), fog_mode=fog_mode,
        store_any=store_any)
    names = ("rgb", "res_a", "pos", "nrm", "spec", "inst", "row",
             "transparent", "dropped")
    want = dict(zip(names, (np.asarray(a) for a in want)))
    got = dict(zip(names, (_np(a) for a in got)))
    # The context rows' light columns in the port's form.
    want["row"] = ctx_rows_from_slots(want["row"])
    same = want["inst"] == got["inst"]
    stored = got["inst"] >= 0
    print(f"store_any={store_any} inst_agree={same.mean()} "
          f"stored={stored.mean()}")
    assert same.mean() >= 0.995 and stored.mean() > 0.3
    assert int(want["dropped"]) == int(got["dropped"]) == 0
    # What reads no hit distance is exactly equal; what does (the hit
    # position, and through the fog the colour and the transparent term)
    # carries the two tracers' t rounding (the JAX CPU config's XLA
    # Moller-Trumbore against the port's Woop twin): 1e-5 relative on 99 %
    # of the rays, 1e-4 on all. Measured: exact / rgb 1.8e-5, position
    # 1.9e-5 (world units of tens), transparent 2.4e-7 abs at most.
    for k in ("res_a", "nrm", "spec", "row"):
        np.testing.assert_array_equal(got[k][..., same], want[k][..., same],
                                      err_msg=k)
    for k in ("rgb", "pos", "transparent"):
        g, w = got[k][..., same], want[k][..., same]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=k)
        close = np.isclose(g, w, rtol=1e-5, atol=1e-5).all(axis=0)
        print(k, np.abs(g - w).max(), close.mean())
        assert close.mean() >= 0.99, (k, close.mean())
    # Dead rays store nothing and keep their full residual alpha.
    dead = t_max < 0
    assert (got["inst"][dead] == -1).all() and (got["res_a"][dead] == 1.0).all()
    if not store_any:  # refraction keeps only lit hits
        lit = (got["row"][R.CTX_FLAGS].astype(np.int32) & R.F_HAS_LIGHTING) != 0
        assert lit[stored].all()


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def _frames(jax_build, port_build, prepare):
    """One frame of a scene through convert and through each package's
    own API, both at the top of the alpha boost ladder (one frame
    program). Returns (convert pair, own-API pair, the JAX view)."""
    jdev, jscene, jview = jax_build()
    prepare(jscene)
    jview.max_reflections = 2
    jview.update()
    r = jview._renderer
    r._alpha_boost = 16
    jdev.draw()
    j_fb = jview.framebuffer().copy()

    pdev, pscene, pview = port_build()
    prepare(pscene)
    pview.max_reflections = 2
    pview.update()
    pview._renderer._alpha_boost = 16
    pdev.draw()
    p_fb = pview.framebuffer()
    assert int(pview._renderer._last.alpha_dropped) == 0

    jview.frame_count = 0
    cfg = r._config()
    assert cfg.max_reflections == 2
    fn = r._get_jitted(cfg, 0)
    gp = r._global_params(cfg)
    hist = jfg.History.zeros(cfg.rt_height, cfg.rt_width)
    out, present = fn(r._sb, gp, hist, r.bn_table, r._background_planes(cfg),
                      None)
    assert int(out.alpha_dropped) == 0
    state = (r._sb, gp, cfg)
    j = dict(img=np.asarray(present), inst=np.asarray(out.gbuffers.instance),
             refl=np.asarray(out.reflection), refr=np.asarray(out.refraction),
             refl_alpha=np.asarray(out.gbuffers.refl_alpha),
             refr_alpha=np.asarray(out.gbuffers.refr_alpha))
    return j, state, (j_fb, p_fb)


def _port_convert(state):
    sb, gp, cfg = state
    hist = pfg.History.zeros(cfg.rt_height, cfg.rt_width, "cpu")
    pout = pfg.render_frame(_sb_to_port(sb), _gp_to_port(gp), hist,
                            torch.from_numpy(pbn.packed_table()),
                            _cfg_to_port(cfg))
    assert int(pout.alpha_dropped) == 0
    return dict(img=pfg.present_rgb8(pout.image).numpy(),
                inst=pout.gbuffers.instance.numpy(),
                refl=pout.reflection.numpy(), refr=pout.refraction.numpy())


def _hold(tag, j, p):
    s = ssim(j["img"], p["img"])
    same = j["inst"] == p["inst"]
    out = dict(ssim=s, inst_agree=same.mean())
    for k in ("refl", "refr"):
        err = np.abs(j[k] - p[k]).max(axis=0)
        out[f"{k}_max_err"] = err[same].max()
        out[f"{k}_within_1e-4"] = (err[same] <= 1e-4).mean()
    print(tag, out)
    assert s >= 0.99
    assert same.mean() >= 0.995 and (p["inst"] >= 0).any()
    assert out["refl_within_1e-4"] >= 0.99
    assert out["refr_within_1e-4"] >= 0.99
    return out


GW, GH = 64, 32


@pytest.fixture(scope="module")
def glass_frames():
    j, state, own = _frames(
        lambda: jax_sample(width=GW, height=GH, gi_samples=1, with_glass=True),
        lambda: port_sample(GW, GH, gi_samples=1, with_glass=True,
                            device="cpu"),
        make_glass_translucent,
    )
    return j, state, own


def test_glass_frame_through_convert(glass_frames):
    j, state, _ = glass_frames
    p = _port_convert(state)
    _hold("glass convert", j, p)
    # Both secondary passes do something here.
    assert (j["refr_alpha"] > 0).any() and (j["refl_alpha"] > 0).any()
    assert np.abs(p["refr"]).max() > 0.05 and np.abs(p["refl"]).max() > 0.05
    assert (p["refr"][:, j["refr_alpha"] <= 0] == 0).all()


def test_glass_frame_through_own_api(glass_frames):
    _, _, (j_fb, p_fb) = glass_frames
    assert p_fb.shape == j_fb.shape == (GH, GW, 4)
    s = ssim(j_fb[..., :3], p_fb[..., :3])
    print(f"glass own-API ssim={s}")
    assert s >= 0.99


def test_glass_frame_k3_k4_twins(glass_frames, monkeypatch):
    """The size switch at 0: the frame's closest-hit traces (primary,
    bounce, refraction, each reflection bounce with a live mirror ray)
    take K3's twin and its shadow traces (direct light, bounce light,
    refraction light) K4's."""
    monkeypatch.setattr(tc, "RESIDENT_TABLE_BYTES", 0)
    monkeypatch.setattr(jtp, "VMEM_CLUSTER_BYTES", 0)
    calls = {name: 0 for name in ("trace_opaque_mt_plain",
                                  "trace_shadow_mt_plain",
                                  "trace_opaque_plain", "trace_shadow_plain")}
    for name in calls:
        fn = getattr(tc, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tc, name, counted)
    j, state, _ = glass_frames
    profiling.reset_frame_stats()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        p = _port_convert(state)
    stats = profiling.frame_stats()
    profiling.reset_frame_stats()
    issued = 2 - stats["reflection_bounces_skipped"]
    print("K3/K4 twin calls", calls, "reflection bounces issued", issued)
    # primary + bounce + refraction + one a reflection bounce with a live
    # mirror ray (a bounce with none is not traced); DI + bounce light +
    # refraction light.
    assert issued >= 1
    assert calls["trace_opaque_mt_plain"] == 3 + issued
    assert calls["trace_shadow_mt_plain"] >= 3
    assert calls["trace_opaque_plain"] == calls["trace_shadow_plain"] == 0
    _hold("glass convert K3/K4", j, p)


CW, CH = 128, 64


@pytest.fixture(scope="module")
def castle_frames():
    return _frames(
        lambda: jax_castle(width=CW, height=CH, gi_samples=0),
        lambda: port_castle(CW, CH, gi_samples=0, device="cpu"),
        lambda scene: None,
    )


def test_castle_reflection_frame_through_convert(castle_frames):
    j, state, _ = castle_frames
    p = _port_convert(state)
    _hold("castle convert", j, p)
    moat = j["refl_alpha"] > 0
    assert 0.005 < moat.mean() < 0.5  # the moat, not the whole frame
    assert np.abs(p["refl"][:, moat]).max() > 0.05
    assert (p["refl"][:, ~moat] == 0).all()


def test_castle_reflection_frame_through_own_api(castle_frames):
    _, _, (j_fb, p_fb) = castle_frames
    s = ssim(j_fb[..., :3], p_fb[..., :3])
    print(f"castle own-API ssim={s}")
    assert s >= 0.99


# ---------------------------------------------------------------------------
# a launch with no live ray
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("resident", [True, False], ids=["k1k2", "k3k4"])
def test_all_dead_launch(castle_state, resident, monkeypatch):
    """Every ray dead (t_max = -1): no visit, no work item, and the twins
    report no hit (tri -1, t = t_max + 1, u = v = bias = 0; nothing
    blocked), as the card's launches must."""
    monkeypatch.setattr(tc, "RESIDENT_TABLE_BYTES", 1 << 40 if resident else 0)
    scene = castle_state["pscene"]
    rng = np.random.default_rng(14)
    n = 3 * tc.BLOCK_RAYS + 100  # a partial last block
    origins = torch.from_numpy(rng.uniform(-20, 20, (3, n)).astype(np.float32))
    dirs = torch.from_numpy(_unit_dirs(rng, n))
    t_min = torch.full((n,), ptr.RAY_MIN_DISTANCE)
    t_max = torch.full((n,), -1.0)

    p = tc.prepare_opaque(origins, dirs, t_min, t_max, scene)
    assert p.mt == (not resident)
    assert int(p.counts.sum()) == 0
    items, n_items = tc.build_work_items(p.counts, p.visits.shape[1])
    assert int(n_items) == 0 and items.shape[0] == p.counts.shape[0] * -(
        -p.visits.shape[1] // tc.SLICE_VISITS)
    opaque = tc.trace_opaque_mt_plain if p.mt else tc.trace_opaque_plain
    for cull in (True, False):
        t, tri, u, v, bias = opaque(p.rays8, p.clusters, p.visits, p.counts,
                                    p.entries, cull)
        assert (tri == -1).all()
        assert torch.equal(t, p.rays8[7] + 1.0)
        assert (u == 0).all() and (v == 0).all() and (bias == 0).all()

    s = tc.prepare_shadow(origins, dirs, t_min, t_max, scene)
    assert int(s.counts.sum()) == 0
    shadow = tc.trace_shadow_mt_plain if s.mt else tc.trace_shadow_plain
    blocked = shadow(s.rays8, s.clusters, s.visits, s.counts, s.entries)
    assert blocked.shape == (s.rays8.shape[1],) and (blocked == 0).all()

    # Through the frame's hooks: every ray a miss, none blocked.
    t, tri, uv, bias = tc.make_opaque_fn()(origins, dirs, t_min, t_max, scene)
    assert (tri == -1).all() and (t == tc._BIG).all() and t.shape == (n,)
    _, tri_s, _, _ = tc.make_shadow_opaque_fn()(origins, dirs, t_min, t_max,
                                                scene)
    assert (tri_s == -1).all()
