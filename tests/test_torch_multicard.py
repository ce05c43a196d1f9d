"""Row tiling over several devices in the port (parallel/tiling.py's
sharded_render with a device list: one worker thread per entry), and
the thread safety under it (ops/tracer_cuda.py), on the CPU, where each
entry is "cpu" and the workers are plain threads.

- The glass sample (tests/test_parallel.py's: 64x32, gi 1, glass, two
  reflection bounces, alpha_shade_boost=16), packed by the JAX package
  and carried across by convert.py, in 4 bands over 4 workers against
  the JAX package's mesh-sharded frame over 4 devices: RGB8 and instance
  planes equal (64 wide is one tile column, where the port's bands are
  byte-equal to the JAX package's), no alpha drops, history planes
  within the bound of the port's other float-plane parity tests against
  the JAX package (rtol = atol = 1e-5, tests/test_torch_gi.py; measured:
  5.1e-6, the per-pixel arithmetic of XLA on the CPU against torch's,
  which the bands do not change: they equal the port's whole frame bit
  for bit).
- The glass sample and the castle at 128x64 in 2, 4 and 8 bands over 1,
  2 and n device entries against the port's whole frame, with
  tests/test_torch_tiling.py's bounds (mean abs < 1e-6, max abs < 1e-4,
  instance planes equal), and equal bit for bit to the same bands drawn
  in turn (devices=None).
- Three frames with the denoiser (reprojection across band edges), the
  history carried by replicate_history: equal to the serial bands frame
  by frame.
- A moving camera (tests/test_torch_tiling.py's moving_whole: the castle
  at 128x64 and the sample at 128x40 with the denoiser, the view turned
  before each of 3 frames): 2 and 4 bands over as many workers hold
  image, flow, depth, instance and history planes to the whole frame
  with that file's bounds, the history carried by replicate_history for
  the workers, and equal the serial bands bit for bit.
- 2 bands on 4 entries: the history goes to the 2 entries that draw a
  band only (replicate_history spied on), its copies for those 2 are
  taken and copies for all 4 refused; the frame equals the serial bands
  bit for bit.
- A worker that raises makes the frame raise; empty device lists and
  band counts that do not divide the rows raise; each entry's bands run
  in its own worker thread.
- LaunchCounts from 8 threads, kernel_library() from 4 threads at once,
  and launches whose inputs are on more than one device.
"""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from rt64tpu.parallel import tiling as jtiling
from rt64tpu.pipeline import framegraph as jfg
from rt64tpu.utils.testscenes import build_sample_scene as jax_sample

from rt64tpu_torch.convert import global_params_from_numpy, scene_buffers_from_numpy
from rt64tpu_torch.ops import bluenoise
from rt64tpu_torch.ops import tracer_cuda as tc
from rt64tpu_torch.parallel import tiling
from rt64tpu_torch.pipeline import framegraph as pfg
from rt64tpu_torch.utils.castle_scene import build_castle_scene as port_castle
from rt64tpu_torch.utils.testscenes import build_sample_scene as port_sample
from tests.test_torch_tiling import compare_moving, draw_moving, moving_whole  # noqa: F401

MEAN_TOL, MAX_TOL = 1e-6, 1e-4
HISTORY_TOL = dict(rtol=1e-5, atol=1e-5)
JOIN_S = 60


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


def _all_equal(a, b):
    ta, tb = tiling._tensors(a), tiling._tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))


# ---------------------------------------------------------------------------
# (a) the JAX package's mesh path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_mesh_frame():
    """tests/test_parallel.py's glass sample drawn by the JAX package over
    a mesh of 4 CPU devices, and the same inputs carried to the port."""
    _, _, view = jax_sample(width=64, height=32, gi_samples=1, with_glass=True)
    view.max_reflections = 2
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


def test_four_workers_match_jax_mesh(jax_mesh_frame):
    jout, inp = jax_mesh_frame
    cfg = inp["cfg"]
    bn = torch.from_numpy(bluenoise.packed_table())
    fn = tiling.sharded_render(cfg, 4, devices=["cpu"] * 4)
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
        np.testing.assert_allclose(p.numpy(), j, err_msg=name, **HISTORY_TOL)


# ---------------------------------------------------------------------------
# (b) the port's whole frame, and the same bands in turn
# ---------------------------------------------------------------------------


def _glass_port():
    dev, _, view = port_sample(width=64, height=32, gi_samples=1,
                               with_glass=True, device="cpu")
    view.max_reflections = 2
    return dev, view


def _castle_port():
    dev, _, view = port_castle(128, 64, di_samples=1, gi_samples=1,
                               foliage=12, device="cpu")
    view.max_reflections = 0
    return dev, view


SCENES = {"glass": _glass_port, "castle": _castle_port}


def _frame_inputs(view):
    r = view._renderer
    cfg = r._last_cfg
    return r, cfg, r._global_params(cfg), r._background_planes(cfg)


@pytest.fixture(scope="module", params=sorted(SCENES))
def whole_frame(request):
    dev, view = SCENES[request.param]()
    dev.draw()  # settles the alpha boost
    r, cfg, gp, bg = _frame_inputs(view)
    hist = pfg.History.zeros(cfg.rt_height, cfg.rt_width, "cpu")
    whole = pfg.render_frame(r._sb, gp, hist, r.bn_table, cfg, bg_planes=bg)
    return r, cfg, gp, bg, hist, whole


def _compare(cfg, n, whole, banded, keep_rows=None):
    keep = slice(None) if keep_rows is None else keep_rows
    diff = (whole.image - banded.image).abs()[:, keep]
    assert float(diff.mean()) < MEAN_TOL
    assert float(diff.max()) < MAX_TOL
    torch.testing.assert_close(
        tiling.to_image_banded(cfg, n, banded.gbuffers.instance),
        pfg.to_image(cfg, whole.gbuffers.instance), rtol=0, atol=0)
    assert int(whole.alpha_dropped) == int(banded.alpha_dropped) == 0


@pytest.mark.parametrize("n,entries", [(2, 1), (2, 2), (4, 1), (4, 2),
                                       (4, 4), (8, 1), (8, 2), (8, 8)])
def test_workers_match_whole(whole_frame, n, entries):
    r, cfg, gp, bg, hist, whole = whole_frame
    fn = tiling.sharded_render(cfg, n, devices=["cpu"] * entries)
    banded = fn(r._sb, gp, hist, r.bn_table, bg)
    assert banded.image.shape == whole.image.shape
    assert banded.history.direct.shape == whole.history.direct.shape
    _compare(cfg, n, whole, banded)
    serial = tiling.sharded_render(cfg, n)(r._sb, gp, hist, r.bn_table, bg)
    assert _all_equal(banded, serial)


# ---------------------------------------------------------------------------
# (c) history across frames
# ---------------------------------------------------------------------------


def test_history_across_frames_matches_serial():
    dev, _, view = port_sample(64, 32, gi_samples=1, denoiser=True,
                               device="cpu")
    dev.draw()
    r, cfg, gp, bg = _frame_inputs(view)
    assert bool(gp.gi_reproject)
    devices = ["cpu"] * 4
    workers = tiling.sharded_render(cfg, 4, devices=devices)
    serial = tiling.sharded_render(cfg, 4)
    h_serial = pfg.History.zeros(cfg.rt_height, cfg.rt_width, "cpu")
    h_workers = tiling.replicate_history(h_serial, devices)
    for f in range(3):
        gp_f = gp._replace(frame_count=torch.tensor(f))
        a = workers(r._sb, gp_f, h_workers, r.bn_table, bg)
        b = serial(r._sb, gp_f, h_serial, r.bn_table, bg)
        assert _all_equal(a, b), f"frame {f}"
        h_workers = tiling.replicate_history(a.history, devices)
        h_serial = b.history
    assert float(b.indirect_accum[3].max()) > 1.5  # reprojected


@pytest.mark.parametrize("n", [2, 4])
def test_moving_camera_workers_match_whole(moving_whole, n):
    r, cfg, gps, bg, wholes = moving_whole
    devices = ["cpu"] * n
    outs = draw_moving(tiling.sharded_render(cfg, n, devices=devices), r,
                       gps, bg, cfg,
                       lambda h: tiling.replicate_history(h, devices))
    serial = draw_moving(tiling.sharded_render(cfg, n), r, gps, bg, cfg)
    for f, (whole, a, b) in enumerate(zip(wholes, outs, serial)):
        try:
            compare_moving(cfg, n, whole, a)
        except AssertionError as exc:
            raise AssertionError(f"frame {f}: {exc}") from exc
        assert _all_equal(a, b), f"frame {f}"


def test_history_only_to_the_drawing_entries(whole_frame, monkeypatch):
    r, cfg, gp, bg, hist, whole = whole_frame
    devices = ["cpu"] * 4
    replicate = tiling.replicate_history
    sent = []
    monkeypatch.setattr(tiling, "replicate_history",
                        lambda h, d: sent.append(list(d)) or replicate(h, d))
    fn = tiling.sharded_render(cfg, 2, devices=devices)
    banded = fn(r._sb, gp, hist, r.bn_table, bg)
    assert sent == [[torch.device("cpu")] * 2]
    _compare(cfg, 2, whole, banded)
    serial = tiling.sharded_render(cfg, 2)(r._sb, gp, hist, r.bn_table, bg)
    assert _all_equal(banded, serial)
    workers_copies = replicate(hist, devices[:2])
    assert _all_equal(fn(r._sb, gp, workers_copies, r.bn_table, bg), serial)
    with pytest.raises(ValueError, match="draw a band, one each"):
        fn(r._sb, gp, replicate(hist, devices), r.bn_table, bg)


def test_replicate_history_copies():
    hist = pfg.History.zeros(8, 64, "cpu")
    copies = tiling.replicate_history(hist, ["cpu", "cpu", "cpu"])
    assert len(copies) == 3
    assert all(c is copies[0] for c in copies)
    assert all(a is b for a, b in zip(copies[0], hist))  # no copy in place
    assert tiling.replicate_history(hist, None) == (hist,)
    cfg = pfg.RenderConfig(rt_width=64, rt_height=8, display_width=64,
                           display_height=8)
    fn = tiling.sharded_render(cfg, 2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="replicate_history"):
        fn(None, _gp_on("cpu"), copies, None, None)


# ---------------------------------------------------------------------------
# (d) errors, (e) devices
# ---------------------------------------------------------------------------


class _Band2Fails(RuntimeError):
    pass


def _gp_on(device):
    return type("GP", (), {"view": torch.zeros(4, 4, device=device)})()


def _fake_bands(monkeypatch, cfg, n, draw):
    """render_frame replaced by draw(band index), the inputs passed to the
    workers as they are (no scene needed)."""
    band = tiling.shard_config(cfg, n)
    monkeypatch.setattr(
        pfg, "render_frame",
        lambda *a, row_offset=0, **kw: draw(row_offset // band.rt_height))
    monkeypatch.setattr(tiling, "replicate_inputs",
                        lambda inputs, devices: dict.fromkeys(devices, inputs))


def _tiny_cfg():
    return pfg.RenderConfig(rt_width=64, rt_height=32, display_width=64,
                            display_height=32)


def test_worker_error_fails_the_frame(monkeypatch):
    drawn = []

    def draw(b):
        if b == 2:
            raise _Band2Fails("band 2")
        drawn.append(b)
        return pfg.FrameOutputs(*[torch.zeros(1)] * 11)

    _fake_bands(monkeypatch, _tiny_cfg(), 4, draw)
    fn = tiling.sharded_render(_tiny_cfg(), 4, devices=["cpu"] * 4)
    hist = pfg.History.zeros(32, 64, "cpu")
    result = []
    with pytest.raises(_Band2Fails):
        result.append(fn(None, _gp_on("cpu"), hist, None, None))
    assert not result
    assert 2 not in drawn


def test_bands_run_in_one_worker_per_entry(monkeypatch):
    seen = {}

    def draw(b):
        seen[b] = threading.current_thread()
        return pfg.FrameOutputs(*[torch.full((1,), float(b))] * 11)

    _fake_bands(monkeypatch, _tiny_cfg(), 4, draw)
    out = tiling.sharded_render(_tiny_cfg(), 4, devices=["cpu"] * 2)(
        None, _gp_on("cpu"), pfg.History.zeros(32, 64, "cpu"), None, None)
    assert out.image.tolist() == [0.0, 1.0, 2.0, 3.0]  # in band order
    assert seen[0] is seen[2] and seen[1] is seen[3]
    assert seen[0] is not seen[1]
    assert threading.main_thread() not in seen.values()


def test_device_list_refusals():
    cfg = pfg.RenderConfig(rt_width=64, rt_height=30, display_width=64,
                           display_height=30)
    with pytest.raises(ValueError, match="devices is empty"):
        tiling.sharded_render(cfg, 2, devices=[])
    with pytest.raises(ValueError, match="do not divide"):
        tiling.sharded_render(cfg, 4, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="devices is empty"):
        tiling.replicate_history(pfg.History.zeros(30, 64, "cpu"), [])
    fn = tiling.sharded_render(cfg, 2, devices=["meta", "meta"])
    with pytest.raises(ValueError, match="devices\\[0\\] is meta"):
        fn(None, _gp_on("cpu"), pfg.History.zeros(30, 64, "cpu"), None, None)


# ---------------------------------------------------------------------------
# (f) the repairs under the workers: counts, library, launch devices
# ---------------------------------------------------------------------------


def _run_threads(target, n):
    threads = [threading.Thread(target=target) for _ in range(n)]
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in threads)


def test_launch_counts_under_threads():
    counts = tc.LaunchCounts()
    own = []

    def bump():
        with counts.thread_counts() as mine:
            for _ in range(10_000):
                counts.add("opaque_launches")
            counts.add("shadow_mt_launches")
        own.append(mine)

    _run_threads(bump, 8)
    assert counts.opaque_launches == 8 * 10_000
    assert counts.shadow_mt_launches == 8
    assert counts.shadow_launches == counts.opaque_mt_launches == 0
    assert own == [{"opaque_launches": 10_000, "shadow_launches": 0,
                    "opaque_mt_launches": 0, "shadow_mt_launches": 1,
                    "alpha_sweep_launches": 0}] * 8
    assert set(vars(counts)) == set(tc.LaunchCounts.NAMES)


def test_kernel_library_built_once_across_threads(monkeypatch):
    builds, got = [], []

    def build():
        builds.append(threading.get_ident())
        time.sleep(0.2)  # a slow build: the others arrive meanwhile
        return object()

    monkeypatch.setattr(tc, "_build_library", build)
    monkeypatch.setattr(tc, "_library", None)
    _run_threads(lambda: got.append(tc.kernel_library()), 4)
    assert len(builds) == 1
    assert len(got) == 4 and all(g is got[0] for g in got)


def test_launch_inputs_on_two_devices_raise():
    rays8 = torch.zeros(8, 512)
    p = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="visits on meta, rays8 on cpu"):
        tc.trace_opaque_blocks(rays8, torch.zeros(2, tc.C_ROWS, tc.K_CS),
                               torch.zeros(1, 1, dtype=torch.int32,
                                           device="meta"), p,
                               torch.zeros(1, 1), True)
