"""Global illumination in the port against the JAX package, on the CPU.

Units, on identical seeded inputs at 1e-5: the cosine-hemisphere
sampler, the sky lookup by ray direction, temporal reprojection, the 3x3
denoise filter, and the one-light estimate at the bounce
(compute_lights_random, chosen lights exactly equal).

Frames: the sample scene at 64x32 with gi_samples=1, two consecutive
frames so the second reads history, with and without the denoiser
(which is what turns GI reprojection on):
(a) through rt64tpu_torch.convert: the JAX package packs the scene and
    both cameras; the port renders frame 1 from zero history and frame 2
    from the JAX package's frame-1 history;
(b) through each package's own API: Device.draw() twice.
The JAX CPU config traces with its XLA tracer, the port with the plain
twins of its kernels, so a bounce ray that grazes an edge may land on
the neighbouring triangle: indirect_accum is held to 1e-4 on at least
99 % of the pixels whose instance ids agree, and its mean error to 1e-4.

Measured on the CPU (torch 2.13, jax 0.9): frame 2 through convert,
denoiser off / on: RGB8 SSIM 1.0 / 1.0, instance ids agree on every
pixel, indirect_accum max abs error 2.5e-6 / 2.7e-5 (100 % within
1e-4); own API SSIM 1.0 / 1.0.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rt64tpu.ops import bluenoise as jbn
from rt64tpu.ops import filters as jfilters
from rt64tpu.ops import lighting as jli
from rt64tpu.ops import shading as jsh
from rt64tpu.ops import sky as jsky
from rt64tpu.pipeline import framegraph as jfg
from rt64tpu.utils.castle_scene import build_castle_scene as jax_castle
from rt64tpu.utils.testscenes import build_sample_scene as jax_sample

from rt64tpu_torch.convert import (
    ctx_rows_from_slots,
    global_params_from_numpy,
    history_from_numpy,
    scene_buffers_from_numpy,
)
from rt64tpu_torch.ops import bluenoise as pbn
from rt64tpu_torch.ops import filters as pfilters
from rt64tpu_torch.ops import lighting as pli
from rt64tpu_torch.ops import shading as psh
from rt64tpu_torch.ops import sky as psky
from rt64tpu_torch.pipeline import framegraph as pfg
from rt64tpu_torch.pipeline import rows as R
from rt64tpu_torch.utils.ssim import ssim
from rt64tpu_torch.utils.testscenes import build_sample_scene as port_sample


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers side by side, and the torch work
    here is many tiny eager ops: one intra-op thread is the fastest. The
    worker's setting comes back when this file is done."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


W, H = 64, 32


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


def test_cos_hemisphere_matches():
    rng = np.random.default_rng(0)
    n = 4096
    normal = _unit_dirs(rng, n)
    normal[:, :3] = np.eye(3, dtype=np.float32)  # axis-aligned normals
    r1 = rng.uniform(0, 1, n).astype(np.float32)
    r2 = rng.uniform(0, 1, n).astype(np.float32)
    r1[:2] = (0.0, 1.0)
    want = np.asarray(jfg._cos_hemisphere(
        jnp.asarray(r1), jnp.asarray(r2), jnp.asarray(normal)))
    got = pfg._cos_hemisphere(torch.from_numpy(r1), torch.from_numpy(r2),
                              torch.from_numpy(normal)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (np.sum(got * normal, axis=0) >= -1e-5).all()  # the upper hemisphere


def test_gaussian_3x3_matches():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 2, (3, 17, 23)).astype(np.float32)
    want = np.asarray(jfilters.gaussian_3x3(jnp.asarray(img)))
    got = pfilters.gaussian_3x3(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # Border renormalization: a constant image stays constant.
    flat = pfilters.gaussian_3x3(torch.full((1, 5, 7), 0.25)).numpy()
    np.testing.assert_allclose(flat, 0.25, rtol=1e-6)


@pytest.mark.parametrize("w,h", [(64, 32), (20, 12)], ids=["tiled", "linear"])
def test_reproject_matches(w, h):
    """Flow that leaves the screen, tiny and zero normal agreement
    (power 128) and depth steps, in both pixel orders."""
    rng = np.random.default_rng(2)
    n = w * h
    jcfg = jfg.RenderConfig(rt_width=w, rt_height=h, display_width=w,
                            display_height=h)
    pcfg = pfg.RenderConfig(rt_width=w, rt_height=h, display_width=w,
                            display_height=h)
    assert pcfg.tiled == jcfg.tiled == (w == 64)
    prev_buf = rng.uniform(0, 1, (4, n)).astype(np.float32)
    prev_buf[3] = rng.integers(0, 65, n)
    prev_depth = rng.uniform(0.9, 1.0, n).astype(np.float32)
    depth = (prev_depth + rng.choice([0.0, 1e-3, 0.05], n)).astype(np.float32)
    prev_normal = _unit_dirs(rng, n)
    normal = np.where(rng.uniform(size=n) < 0.5, prev_normal,
                      _unit_dirs(rng, n)).astype(np.float32)
    flow = rng.uniform(-6, 6, (2, n)).astype(np.float32)
    flow[:, : n // 4] = 0.0
    args = (prev_buf, prev_depth, prev_normal, depth, normal, flow)
    j_rgb, j_len = jfg._reproject(*(jnp.asarray(a) for a in args), jcfg)
    p_rgb, p_len = pfg._reproject(*(torch.from_numpy(a) for a in args), pcfg)
    np.testing.assert_allclose(p_rgb.numpy(), np.asarray(j_rgb), atol=1e-5)
    np.testing.assert_allclose(p_len.numpy(), np.asarray(j_len), atol=1e-5)
    assert (p_len.numpy() > 1.0).any() and (p_len.numpy() == 0.0).any()


@pytest.fixture(scope="module")
def sample_state():
    _, _, view = jax_sample(width=W, height=H, gi_samples=1)
    view.max_reflections = 0
    view.update()
    r = view._renderer
    cfg = r._config()
    return r._sb, r._global_params(cfg), cfg


def test_sample_sky_plane_matches(sample_state):
    sb, gp, _ = sample_state
    sb_t, gp_t = _sb_to_port(sb), _gp_to_port(gp)
    rng = np.random.default_rng(3)
    n = 4096
    dirs = _unit_dirs(rng, n)
    dirs[:, 0] = (0.0, 1.0, 0.0)  # straight up: atan2(0, -0)
    assert int(gp.sky_plane_rec) >= 0
    hsl = np.array([0.1, -0.2, 0.05], np.float32)
    for hsl_mod in (np.asarray(gp.sky_hsl_mod), hsl):
        want = np.asarray(jsky.sample_sky_plane(
            sb.quad_pool, sb.quad_records,
            jnp.broadcast_to(gp.sky_plane_rec, (n,)), jnp.asarray(dirs),
            gp.sky_yaw_offset, gp.sky_diffuse_mult, jnp.asarray(hsl_mod)))
        got = psky.sample_sky_plane(
            sb_t.quad_pool, sb_t.quad_records, gp_t.sky_plane_rec,
            torch.from_numpy(dirs), gp_t.sky_yaw_offset, gp_t.sky_diffuse_mult,
            torch.from_numpy(hsl_mod)).numpy()
        # A direction on a texel boundary may round to the other texel.
        close = np.isclose(got, want, rtol=1e-5, atol=1e-5).all(axis=0)
        assert close.mean() >= 0.999, close.mean()
        assert got[3].min() > 0.999 and got[:3].std() > 0.01
    # No sky plane: transparent black.
    none = psky.sample_sky_plane(
        sb_t.quad_pool, sb_t.quad_records, torch.tensor(-1, dtype=torch.int32),
        torch.from_numpy(dirs), gp_t.sky_yaw_offset, gp_t.sky_diffuse_mult,
        gp_t.sky_hsl_mod).numpy()
    assert (none == 0.0).all()


def test_compute_lights_random_matches():
    """The one-light estimate at castle surface points: the chosen
    light of every ray (read off its diffuse colour) exactly equal, the
    light colour to 1e-5. Shadow rays are traced by each package's
    plain tracer."""
    _, _, view = jax_castle(width=64, height=16, gi_samples=0, foliage=12)
    view.max_reflections = 0
    view.update()
    r = view._renderer
    sb, cfg = r._sb, r._config()
    gp = r._global_params(cfg)
    sb_t, gp_t, cfg_t = _sb_to_port(sb), _gp_to_port(gp), _cfg_to_port(cfg)

    rows = np.asarray(jsh.build_tri_rows(sb)[0])
    n = cfg.rt_width * cfg.rt_height
    rng = np.random.default_rng(4)
    tri = rng.choice(np.flatnonzero(np.asarray(sb.tri_valid)), n).astype(np.int32)
    tri[rng.uniform(size=n) < 0.15] = -1
    u = rng.uniform(0, 1, n).astype(np.float32)
    v = (rng.uniform(0, 1, n) * (1 - u)).astype(np.float32)
    g = rows[np.maximum(tri, 0)].T
    p0, p1, p2 = (g[o:o + 3] for o in (R.T_P0, R.T_P1, R.T_P2))
    pos = (p0 * (1 - u - v) + p1 * u + p2 * v).astype(np.float32)
    nrm = np.cross(p1 - p0, p2 - p0, axis=0)
    nrm = (nrm / np.maximum(np.linalg.norm(nrm, axis=0), 1e-12)).astype(np.float32)
    dirs = (pos - np.asarray(gp.view_i)[3, :3, None]).astype(np.float32)
    nrm = np.where((nrm * dirs).sum(0) > 0, -nrm, nrm).astype(np.float32)
    spec = rng.uniform(0, 1, (3, n)).astype(np.float32)
    noise = rng.uniform(size=n).astype(np.float32)
    ctx_rows = np.array(jfg._row_of(jnp.asarray(rows), jnp.asarray(tri),
                                      jnp.asarray(tri >= 0)))

    jrows, jrows_t = jsh.build_tri_rows(sb)
    jscene = jfg.make_trace_scene(sb, jrows_t, cfg.alpha_cap)
    jbn_t = jnp.asarray(jbn.packed_table())
    jctx = jli.ctx_from_rows(jnp.asarray(ctx_rows), jnp.asarray(tri >= 0))
    jargs = (jfg._pixel_grid(cfg), jbn_t, gp.frame_count, jnp.asarray(dirs),
             jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(spec), jctx)
    jlight, jdrop = jli.compute_lights_random(
        sb, jrows, jscene, *jargs, max_light_count=1, di_samples=1,
        check_shadows=True, noise_rand=jnp.asarray(noise), alpha_compact=1024,
        shade_boost=16)
    jplan = jli.plan_lights(sb, *jargs, 1, 1, jnp.asarray(noise))

    prows, prows_t = psh.build_tri_rows(sb_t)
    pscene = pfg.make_trace_scene(sb_t, prows_t, cfg_t.alpha_cap)
    pbn_t = torch.from_numpy(pbn.packed_table())
    t = lambda a: torch.from_numpy(a)
    pctx = pli.ctx_from_rows(t(ctx_rows_from_slots(ctx_rows)), t(tri >= 0))
    pargs = (pfg._pixel_grid(cfg_t, "cpu"), pbn_t, gp_t.frame_count, t(dirs),
             t(pos), t(nrm), t(spec), pctx)
    plight, pdrop = pli.compute_lights_random(
        sb_t, prows, pscene, *pargs, max_light_count=1, di_samples=1,
        check_shadows=True, noise_rand=t(noise), alpha_compact=1024,
        shade_boost=16)
    pplan = pli.plan_lights(sb_t, *pargs, 1, 1, t(noise))

    assert int(jdrop) == int(pdrop) == 0
    (j_active, _, j_ldiff, *_), = jplan.rounds
    (p_active, _, p_ldiff, *_), = pplan.rounds
    np.testing.assert_array_equal(_np(j_active), _np(p_active))
    np.testing.assert_array_equal(_np(j_ldiff), _np(p_ldiff))
    picked = {tuple(c) for c in _np(p_ldiff).T[_np(p_active)]}
    assert len(picked) == 2  # both castle lights get chosen
    np.testing.assert_allclose(_np(plight), _np(jlight), rtol=1e-5, atol=1e-5)
    assert _np(plight).max() > 0.05
    unshadowed, _ = pli.compute_lights_random(
        sb_t, prows, pscene, *pargs, max_light_count=1, di_samples=1,
        check_shadows=False, noise_rand=t(noise))
    assert (unshadowed >= plight - 1e-6).all() and (unshadowed > plight).any()


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "denoiser"])
def gi_frames(request):
    denoiser = request.param
    jdev, _, jview = jax_sample(width=W, height=H, gi_samples=1,
                                denoiser=denoiser)
    jview.max_reflections = 0
    jview.update()
    r = jview._renderer
    r._alpha_boost = 16  # one frame program instead of the overflow ladder

    # (b) each package through its own API, two frames.
    jdev.draw()
    jdev.draw()
    j_fb = jview.framebuffer().copy()
    pdev, _, pview = port_sample(W, H, gi_samples=1, denoiser=denoiser,
                                 device="cpu")
    pview.max_reflections = 0
    pdev.draw()
    pdev.draw()
    p_fb = pview.framebuffer()
    p_hist_len = pview._renderer._last.indirect_accum[3].numpy()

    # (a) the same two frames again, by hand on the JAX side (the frame
    # program is already compiled), and through convert on the port's.
    jview.frame_count = 0
    cfg = r._config()
    fn = r._get_jitted(cfg, 0)
    sb = r._sb
    sb_t, cfg_t = _sb_to_port(sb), _cfg_to_port(cfg)
    bn = torch.from_numpy(pbn.packed_table())
    hist = jfg.History.zeros(cfg.rt_height, cfg.rt_width)
    pairs = []
    for frame in range(2):
        jview.frame_count = frame
        gp = r._global_params(cfg)
        hist_t = history_from_numpy(
            {f: np.array(getattr(hist, f)) for f in pfg.History._fields}, "cpu")
        out, present = fn(sb, gp, hist, r.bn_table, r._background_planes(cfg),
                          None)
        assert int(out.alpha_dropped) == 0
        pout = pfg.render_frame(sb_t, _gp_to_port(gp), hist_t, bn, cfg_t)
        assert int(pout.alpha_dropped) == 0
        pairs.append((
            dict(img=np.asarray(present),
                 inst=np.asarray(out.gbuffers.instance),
                 indirect=np.asarray(out.indirect_accum),
                 filtered=np.asarray(out.filtered_indirect)),
            dict(img=pfg.present_rgb8(pout.image).numpy(),
                 inst=pout.gbuffers.instance.numpy(),
                 indirect=pout.indirect_accum.numpy(),
                 filtered=pout.filtered_indirect.numpy()),
        ))
        hist = out.history
    return denoiser, pairs, j_fb, p_fb, p_hist_len


def test_gi_frames_through_convert(gi_frames):
    denoiser, pairs, _, _, _ = gi_frames
    for frame, (j, p) in enumerate(pairs):
        assert p["img"].shape == j["img"].shape == (H, W, 3)
        s = ssim(j["img"], p["img"])
        same = j["inst"] == p["inst"]
        err = np.abs(j["indirect"] - p["indirect"]).max(axis=0)
        print(f"denoiser={denoiser} frame={frame + 1} ssim={s} "
              f"inst_agree={same.mean()} indirect_max_err={err[same].max()} "
              f"within_1e-4={(err[same] <= 1e-4).mean()}")
        assert s >= 0.98
        assert same.mean() >= 0.995 and (p["inst"] >= 0).any()
        assert (err[same] <= 1e-4).mean() >= 0.99
        assert err[same].mean() <= 1e-4
        ferr = np.abs(j["filtered"] - p["filtered"]).max(axis=0)
        assert (ferr[same] <= 1e-4).mean() >= 0.98
    # GI does something: the bounce adds light over the ambient floor.
    lit = pairs[1][1]["indirect"][:3, pairs[1][1]["inst"] >= 0]
    assert lit.max() > lit.min() + 0.05
    # Frame 2 reads history exactly when the denoiser is on.
    hist_len = pairs[1][1]["indirect"][3]
    assert (hist_len.max() > 1.5) == denoiser


def test_gi_frames_through_own_api(gi_frames):
    denoiser, _, j_fb, p_fb, p_hist_len = gi_frames
    assert p_fb.shape == j_fb.shape == (H, W, 4)
    s = ssim(j_fb[..., :3], p_fb[..., :3])
    print(f"denoiser={denoiser} own-API ssim={s}")
    assert s >= 0.98
    assert (p_hist_len.max() > 1.5) == denoiser
