"""The rest of the port's ViewRenderer against the JAX package, on the CPU:
the pipelined present ring, the interpolated midframe, checkpoints and
the profiling helpers.

- The ring: the glass sample at 64x32 (gi 0, no reflections), pipelined,
  6 draws in each package: the framebuffer sequences are equal byte for
  byte, None while the ring fills included (measured: equal). A hold
  (an overflowing frame) keeps the shown frame and picking on it, where
  the JAX package points picking at the held frame; at boost 16 the
  present goes out with a breadcrumb.
- The midframe: interpolate_frame at t = 0, 0.5 and 1 to 1e-6; the
  view's midframe at render size = display size within 1/255 of the JAX
  package's; at a 2x upscale the flow is scaled to display pixels (an
  edge lands on column 24, the JAX package's on 26); after a change of
  render size it equals a fresh view's (the JAX package raises there).
- Checkpoints: the JAX package's .npz after 3 draws of the sample scene
  (GI, denoiser, FSR: render 64x24 of 64x32) restores into the port and
  the next frames agree within 2/255 (measured: equal); the port's file
  restores into the JAX package the same way; the FSR history rides
  along.
- Profiling: a stage timed only under a profiler, positive times, a
  trace file that shows the stage's span.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rt64tpu.ops import filters as jfilters
from rt64tpu.utils import checkpoint as jckpt
from rt64tpu.utils.testscenes import build_sample_scene as jax_sample

from rt64tpu_torch import descriptors as pd
from rt64tpu_torch.ops import filters as pfilters
from rt64tpu_torch.pipeline import framegraph as pfg
from rt64tpu_torch.pipeline import view as pview_mod
from rt64tpu_torch.utils import checkpoint as pckpt
from rt64tpu_torch.utils import profiling
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


def _glass(make, **kw):
    dev, scene, view = make(width=64, height=32, gi_samples=0,
                               with_glass=True, **kw)
    view.max_reflections = 0
    return dev, scene, view


def _fb(view):
    fb = view._framebuffer
    return None if fb is None else fb.copy()


@pytest.fixture(scope="module")
def ring_runs():
    """Six pipelined draws of the glass sample in each package: the
    framebuffer after each draw (None until the ring presents), and the
    port's own RGB8 image of each draw and its ring length after it."""
    jdev, _, jview = _glass(jax_sample)
    jview.pipelined_present = True
    pdev, _, pview = _glass(port_sample, device="cpu")
    pview.pipelined_present = True
    jax_fbs, port_fbs, drawn, ring = [], [], [], []
    for _ in range(6):
        jdev.draw()
        pdev.draw()
        jax_fbs.append(_fb(jview))
        port_fbs.append(_fb(pview))
        drawn.append(pfg.present_rgb8(pview._renderer._last.image).numpy())
        ring.append(len(pview._renderer._pending))
    return jax_fbs, port_fbs, drawn, ring, pview


def test_ring_presents_as_the_jax_package(ring_runs):
    jax_fbs, port_fbs, _, _, _ = ring_runs
    assert [f is None for f in port_fbs] == [f is None for f in jax_fbs] == [
        True, True, False, False, False, False]
    for j, p in zip(jax_fbs[2:], port_fbs[2:]):
        np.testing.assert_array_equal(p, j)


def test_ring_presents_the_frame_two_draws_before(ring_runs):
    _, port_fbs, drawn, ring, pview = ring_runs
    for i in range(2, 6):
        np.testing.assert_array_equal(port_fbs[i][..., :3], drawn[i - 2])
        assert (port_fbs[i][..., 3] == 255).all()
    r = pview._renderer
    assert r.pipelined and r.pipeline_depth == 2
    assert max(ring) <= r.pipeline_depth  # after a present


def _drop_on(renderer, draws, count=3):
    """Make the frames of the given draw numbers (0-based, counted from
    the patch) report `count` dropped alpha hits and no hit at all."""
    frame = renderer._frame
    seen = iter(range(10 ** 6))

    def patched(cfg, gp):
        out = frame(cfg, gp)
        if next(seen) in draws:
            g = out.gbuffers._replace(
                instance=torch.full_like(out.gbuffers.instance, -1))
            out = out._replace(gbuffers=g, alpha_dropped=torch.tensor(count))
        return out

    renderer._frame = patched


def test_hold_keeps_the_shown_frame_and_its_picking(monkeypatch):
    """An overflowing frame reaches the front of the ring: the previous
    framebuffer stays and picking stays on it (the JAX package moves
    picking to the held frame, ROADMAP queue 3), and the boost doubles."""
    crumbs = []
    monkeypatch.setattr(pview_mod, "breadcrumb", crumbs.append)
    dev, _, view = _glass(port_sample, device="cpu")
    view.pipelined_present = True
    dev.draw()
    r = view._renderer
    _drop_on(r, {2})  # the draw after the next two
    dev.draw()
    dev.draw()
    dev.draw()  # presents draw 0 of the patch
    shown = view.framebuffer().copy()
    plane = r.instance_plane().copy()
    assert (plane >= 0).any()
    dev.draw()  # pops draw 1: fine
    shown = view.framebuffer().copy()
    plane = r.instance_plane().copy()
    boost = r.alpha_boost
    dev.draw()  # pops draw 2: dropped hits, held
    np.testing.assert_array_equal(view.framebuffer(), shown)
    np.testing.assert_array_equal(r.instance_plane(), plane)
    assert r.alpha_boost == boost * 2
    assert "holding previous frame" in crumbs[-1]


def test_present_at_full_boost_is_announced(monkeypatch):
    crumbs = []
    monkeypatch.setattr(pview_mod, "breadcrumb", crumbs.append)
    dev, _, view = _glass(port_sample, device="cpu")
    view.pipelined_present = True
    dev.draw()
    r = view._renderer
    r._alpha_boost = pview_mod.MAX_ALPHA_BOOST
    _drop_on(r, {0}, count=5)
    for _ in range(3):
        dev.draw()
    assert view._framebuffer is not None
    assert (r.instance_plane() == -1).all()  # the frame with drops is shown
    assert any("5 alpha hits dropped" in c for c in crumbs)
    assert r.alpha_boost == pview_mod.MAX_ALPHA_BOOST


def test_toggling_pipelined_takes_effect():
    """A live renderer's `pipelined` is read at every draw (bench.py
    sets it on a built view): off presents the frame just drawn and
    empties the ring; on again, the ring fills anew before presenting."""
    dev, _, view = _glass(port_sample, device="cpu")
    r = None
    seq = []
    for pipelined in (True, True, True, False, True, True, True):
        if r is not None:
            r.pipelined = pipelined
        else:
            view.pipelined_present = pipelined
        dev.draw()
        r = view._renderer
        drawn = pfg.present_rgb8(r._last.image).numpy()
        seq.append((_fb(view), drawn, len(r._pending)))
    assert seq[0][0] is None and seq[1][0] is None
    np.testing.assert_array_equal(seq[2][0][..., :3], seq[0][1])
    np.testing.assert_array_equal(seq[3][0][..., :3], seq[3][1])  # full sync
    assert seq[3][2] == 0
    # Back on: the ring refills; the full-sync present stays meanwhile.
    np.testing.assert_array_equal(seq[4][0], seq[3][0])
    np.testing.assert_array_equal(seq[5][0], seq[3][0])
    np.testing.assert_array_equal(seq[6][0][..., :3], seq[4][1])


# -- the midframe -------------------------------------------------------


@pytest.mark.parametrize("t", [0.0, 0.5, 1.0])
def test_interpolate_frame_matches(t):
    rng = np.random.default_rng(8)
    a, b = (rng.random((3, 16, 24), np.float32) for _ in range(2))
    flow = (rng.random((2, 16, 24), np.float32) - 0.5) * 12.0
    want = np.asarray(jfilters.interpolate_frame(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(flow), t))
    got = pfilters.interpolate_frame(torch.from_numpy(a), torch.from_numpy(b),
                                     torch.from_numpy(flow), t).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_midframe_matches_at_native_size():
    """Render size = display size: the flow needs no scaling, so the two
    packages agree (within 1/255 of RGB8)."""
    jdev, _, jview = _glass(jax_sample)
    pdev, _, pview = _glass(port_sample, device="cpu")
    jdev.draw()
    pdev.draw()
    assert pview._renderer.interpolated_midframe() is None  # one frame
    jdev.draw()
    pdev.draw()
    want = jview._renderer.interpolated_midframe()
    got = pview._renderer.interpolated_midframe()
    assert got.shape == want.shape == (32, 64, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _synthetic_last(renderer, xp, prev_edge, cur_edge, flow_x, dw, dh, rw, rh):
    """Put two display images with a vertical edge (columns >= the edge
    white) and a uniform render-size flow into a renderer."""
    def img(edge):
        a = np.zeros((3, dh, dw), np.float32)
        a[:, :, edge:] = 1.0
        return xp(a)

    flow = np.zeros((2, rh * rw), np.float32)
    flow[0] = flow_x
    renderer._prev_image = img(prev_edge)
    renderer._last = types.SimpleNamespace(
        image=img(cur_edge), gbuffers=types.SimpleNamespace(flow=xp(flow)))


def _first_white(mid):
    row = mid[mid.shape[0] // 2, :, 0]
    return int(np.argmax(row >= 250))


def test_midframe_scales_the_flow_to_the_display():
    """2x upscale (display 64x16 from 32x8): content at column 20 came
    from column 28 of the previous display frame, a flow of 4 render
    pixels. Half way, the edge is on column 24; the JAX package applies
    the 4 as display pixels and lands the edge (its white side) on 26."""
    jdev, _, jview = jax_sample(width=64, height=16, gi_samples=0)
    pdev, _, pview = port_sample(width=64, height=16, gi_samples=0,
                                 device="cpu")
    for view in (jview, pview):
        view.desc.resolution_scale = 0.5
        view.update()
    pr, jr = pview._renderer, jview._renderer
    pr._last_cfg = pr._config()
    assert (pr._last_cfg.rt_width, pr._last_cfg.rt_height) == (32, 8)
    _synthetic_last(pr, torch.from_numpy, 28, 20, 4.0, 64, 16, 32, 8)
    _synthetic_last(jr, jnp.asarray, 28, 20, 4.0, 64, 16, 32, 8)
    assert _first_white(pr.interpolated_midframe()) == 24
    assert _first_white(jr.interpolated_midframe()) == 26


def test_midframe_after_a_change_of_render_size():
    """A view drawn at full size, then at half size (resolution_scale,
    same display): its midframe is a fresh half-size view's, where the
    JAX package reuses the first size's program and fails."""
    pdev, _, pview = port_sample(width=64, height=48, gi_samples=0,
                                 device="cpu")
    pdev.draw()
    pdev.draw()
    pview.desc.resolution_scale = 0.5
    pdev.draw()
    pdev.draw()
    fdev, _, fview = port_sample(width=64, height=48, gi_samples=0,
                                 device="cpu")
    fview.desc.resolution_scale = 0.5
    fview.frame_count = 2
    fdev.draw()
    fdev.draw()
    got = pview._renderer.interpolated_midframe()
    np.testing.assert_array_equal(got, fview._renderer.interpolated_midframe())

    jdev, _, jview = jax_sample(width=64, height=48, gi_samples=0)
    jview.update()
    jr = jview._renderer
    _synthetic_last(jr, jnp.asarray, 30, 30, 0.0, 64, 48, 64, 48)
    assert jr.interpolated_midframe().shape == (48, 64, 3)
    jview.desc.resolution_scale = 0.5
    _synthetic_last(jr, jnp.asarray, 30, 30, 0.0, 64, 48, 32, 24)
    with pytest.raises(Exception):
        jr.interpolated_midframe()


# -- checkpoints ----------------------------------------------------------


def _fsr_gi(make, **kw):
    dev, scene, view = make(width=64, height=32, gi_samples=1,
                               denoiser=True, upscaler=pd.UPSCALER_FSR, **kw)
    view.max_reflections = 0
    return dev, scene, view


@pytest.fixture(scope="module")
def fsr_views():
    jdev, _, jview = _fsr_gi(jax_sample)
    pdev, _, pview = _fsr_gi(port_sample, device="cpu")
    return (jdev, jview), (pdev, pview)


def _rgb(view):
    return view.framebuffer()[..., :3].astype(int)


def test_checkpoint_from_jax_restores_in_the_port(fsr_views, tmp_path):
    (jdev, jview), (pdev, pview) = fsr_views
    for _ in range(3):
        jdev.draw()
    path = str(tmp_path / "jax_state.npz")
    jckpt.save_view_state(jview, path)
    keys = sorted(np.load(path).files)
    assert "temporal_upscaler" in keys
    pview.update()
    pckpt.restore_view_state(pview, path)
    r = pview._renderer
    assert pview.frame_count == jview.frame_count == 3
    np.testing.assert_array_equal(r._temporal.numpy(),
                                  np.asarray(jview._renderer._temporal))
    np.testing.assert_array_equal(r.history.indirect.numpy(),
                                  np.asarray(jview._renderer.history.indirect))
    jdev.draw()
    pdev.draw()
    assert np.abs(_rgb(pview) - _rgb(jview)).max() <= 2
    assert bool(r._last.indirect_accum[3].max() > 1.5)  # history was read


def test_checkpoint_from_the_port_restores_in_jax(fsr_views, tmp_path):
    (jdev, jview), (pdev, pview) = fsr_views
    pdev.draw()
    jdev.draw()
    path = str(tmp_path / "port_state.npz")
    pckpt.save_view_state(pview, path)
    j_keys = ["depth", "direct", "frame_count", "indirect", "normal",
              "prev_view_i", "prev_view_proj", "temporal_upscaler"]
    assert sorted(np.load(path).files) == j_keys
    jckpt.restore_view_state(jview, path)
    jr = jview._renderer
    np.testing.assert_array_equal(np.asarray(jr._temporal),
                                  pview._renderer._temporal.numpy())
    assert jview.frame_count == pview.frame_count
    jdev.draw()
    pdev.draw()
    assert np.abs(_rgb(pview) - _rgb(jview)).max() <= 2


def test_checkpoint_round_trip_in_the_port(tmp_path):
    dev, _, view = _fsr_gi(port_sample, device="cpu")
    with pytest.raises(ValueError, match="no rendered state"):
        pckpt.save_view_state(view, str(tmp_path / "none.npz"))
    dev.draw()
    dev.draw()
    path = str(tmp_path / "sub" / "state.npz")
    pckpt.save_view_state(view, path)
    r = view._renderer
    hist, temporal = r.history, r._temporal.clone()
    r.history, r._temporal, view.frame_count = None, None, 0
    pckpt.restore_view_state(view, path)
    for a, b in zip(r.history, hist):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(r._temporal, temporal, rtol=0, atol=0)
    assert view.frame_count == 2
    dev.draw()  # resumes


# -- profiling ------------------------------------------------------------


def test_profiling_helpers(tmp_path):
    profiling.reset_frame_stats()
    x = torch.ones(64, 64)
    with profiling.stage("matmul", x.device):  # no profiler: not timed
        x = x @ x
    assert profiling.frame_stats()["stage_ms"] == {}
    ms = profiling.stage_bench("step", lambda c: c * 1.0001 + 1.0,
                               torch.ones(256), iters=5, reps=2)
    assert ms > 0.0
    with profiling.trace(str(tmp_path / "trace")) as log_dir:
        for _ in range(2):
            with profiling.stage("matmul", x.device):
                x = x @ x
    stats = profiling.frame_stats()
    profiling.reset_frame_stats()
    assert stats["stage_ms"]["matmul"] > 0.0
    assert stats["stage_calls"]["matmul"] == 2
    path = os.path.join(log_dir, "trace.json")
    assert os.path.getsize(path) > 0
    with open(path) as fh:
        assert '"matmul"' in fh.read()
