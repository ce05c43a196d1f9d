"""The tracing wrappers' launches in the frame record and the span of the
scene's cluster-table build (utils/profiling.py), on the CPU: the glass
sample at 64x32 with GI and two reflection bounces, drawn on either side
of the size switch (tracer_cuda.clusters_resident; RESIDENT_TABLE_BYTES
0 sends its bucket past it, to K3/K4).

- A profiled draw counts one launch a call of each wrapper's plain
  twin (the launch a card would make): K3/K4 and no K1/K2 past the
  switch, K1/K2 and no K3/K4 below it, the alpha sweep, the hit shader
  and the alpha cull on both sides; the alpha cull once a compacted
  alpha trace (tracer.trace_alpha_to_compact).
  launch_counts stands still (a CPU tensor launches no kernel; on the
  card the record equals its deltas: tests/test_torch_cuda.py).
- Nothing is counted while no profiler records.
- The table build runs in `rt64.trace.tables` once a draw (the frame's
  scene tensors are new), and a trace of the same scene again reuses
  the tables without the span.
- A frame drawn in two bands (parallel/tiling.py, in turn) adds both
  bands' launches to the one record.
- The alpha cull's twin marks every live lane that the per-ray slab test
  marks (its bundles' hulls hold their lanes' rays) and no dead lane.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rt64tpu_torch.ops import shading
from rt64tpu_torch.ops import tracer as ptr
from rt64tpu_torch.ops import tracer_cuda as tc
from rt64tpu_torch.parallel import tiling
from rt64tpu_torch.utils import profiling, testscenes
from alpha_sweep_cases import CULL_CASES, cull_case

TWINS = {"opaque_launches": (tc, "trace_opaque_plain"),
         "shadow_launches": (tc, "trace_shadow_plain"),
         "opaque_mt_launches": (tc, "trace_opaque_mt_plain"),
         "shadow_mt_launches": (tc, "trace_shadow_mt_plain"),
         "alpha_sweep_launches": (ptr, "_alpha_sweep_plain"),
         "hit_shade_launches": (shading, "shade_hits_plain"),
         "alpha_cull_launches": (ptr, "_slab_any_bundled_plain")}
KERNELS = {False: ("opaque_mt_launches", "shadow_mt_launches"),
           True: ("opaque_launches", "shadow_launches")}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spy(monkeypatch):
    """Counts of the twins' calls, by the wrapper's counter name."""
    calls = collections.Counter()
    for name, (module, attr) in TWINS.items():
        fn = getattr(module, attr)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(module, attr, counted)
    return calls


def _table_spans(prof):
    return sum(e.name() == "rt64.trace.tables"
               for e in prof.profiler.kineto_results.events())


def _scene(monkeypatch, resident: bool):
    if not resident:
        monkeypatch.setattr(tc, "RESIDENT_TABLE_BYTES", 0)
    dev, scene, view = testscenes.build_sample_scene(
        width=64, height=32, gi_samples=1, with_glass=True, device="cpu")
    testscenes.make_glass_translucent(scene)
    view.max_reflections = 2
    assert tc.clusters_resident(dev.limits.max_triangles) == resident
    return dev, view


@pytest.mark.parametrize("resident", [True, False],
                         ids=["below_switch", "past_switch"])
def test_a_profiled_draw_counts_each_twin_call(monkeypatch, resident):
    dev, _ = _scene(monkeypatch, resident)
    dev.draw()  # the first draw climbs the alpha-boost ladder
    calls = _spy(monkeypatch)
    before = dict(vars(tc.launch_counts))
    profiling.reset_frame_stats()
    dev.draw()
    assert profiling.frame_stats()["frames"] == 0
    assert all(profiling.frame_stats()[k] == 0 for k in profiling.LAUNCHES)
    calls.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dev.draw()
    st = profiling.frame_stats()
    profiling.reset_frame_stats()
    assert st["frames"] == 1
    assert {k: st[k] for k in profiling.LAUNCHES} == {
        k: calls[k] for k in profiling.LAUNCHES}
    used, unused = KERNELS[resident], KERNELS[not resident]
    assert all(st[k] > 0 for k in used), st
    assert all(st[k] == 0 for k in unused), st
    assert st["alpha_sweep_launches"] > 0 and st["hit_shade_launches"] > 0
    # Primary, GI bounce, two reflection bounces; DI and GI shadows.
    assert st[used[0]] >= 4 and st[used[1]] >= 2
    assert vars(tc.launch_counts) == before
    assert _table_spans(prof) == st["renders"]


def test_tables_are_built_once_per_scene(monkeypatch):
    """The memo: a second launch over the same scene tensors takes the
    tables already built, and opens no span."""
    monkeypatch.setattr(tc, "RESIDENT_TABLE_BYTES", 0)
    scene = ptr.TraceScene(**{k: v for k, v in zip(
        ("v0", "v1", "v2"), torch.rand(3, 3, 256).unbind(0))},
        valid=torch.ones(256, dtype=torch.bool),
        alpha=torch.zeros(256, dtype=torch.bool),
        no_cull=torch.zeros(256, dtype=torch.bool), bias=torch.zeros(256),
        alpha_idx=torch.full((64,), 256, dtype=torch.int64))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first = tc._scene_tables(scene)
        again = tc._scene_tables(scene)
    assert again is first and not first.resident
    assert _table_spans(prof) == 1
    scene.v0.add_(0.0)  # written to: the tables are built anew
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tc._scene_tables(scene) is not first
    assert _table_spans(prof) == 1


def test_band_workers_add_their_launches(monkeypatch):
    dev, view = _scene(monkeypatch, resident=False)
    dev.draw()
    r = view._renderer
    cfg = r._config()
    fn = tiling.sharded_render(cfg, 2)
    gp = r._global_params(cfg)
    calls = _spy(monkeypatch)
    profiling.reset_frame_stats()
    with profile(activities=[ProfilerActivity.CPU]):
        fn(r._sb, gp, r.history, r.bn_table, r._background_planes(cfg))
    st = profiling.frame_stats()
    profiling.reset_frame_stats()
    assert st["renders"] == 2
    assert {k: st[k] for k in profiling.LAUNCHES} == {
        k: calls[k] for k in profiling.LAUNCHES}
    assert st["opaque_mt_launches"] >= 8 and st["opaque_launches"] == 0


@pytest.mark.parametrize("resident", [True, False],
                         ids=["below_switch", "past_switch"])
def test_alpha_cull_counts_once_per_compact_trace(monkeypatch, resident):
    """A profiled draw counts alpha_cull_launches once a
    trace_alpha_to_compact call: every call's lanes are whole bundles."""
    dev, _ = _scene(monkeypatch, resident)
    dev.draw()
    widths = []
    real = ptr.trace_alpha_to_compact

    def spy(origins, *args, **kw):
        widths.append(origins.shape[1])
        return real(origins, *args, **kw)

    monkeypatch.setattr(ptr, "trace_alpha_to_compact", spy)
    profiling.reset_frame_stats()
    with profile(activities=[ProfilerActivity.CPU]):
        dev.draw()
    st = profiling.frame_stats()
    profiling.reset_frame_stats()
    assert widths and all(w % ptr._CULL_BUNDLE == 0 for w in widths), widths
    assert st["alpha_cull_launches"] == len(widths)


@pytest.mark.parametrize("case", CULL_CASES)
def test_bundled_cull_covers_the_per_ray_test(case):
    """The cull's twin against the per-lane slab test (slab_per_ray's ANY
    over the boxes): every live lane that the per-lane test marks is
    marked (the bundle test is a superset), no dead lane is, and some
    bundle hull is looser than its lanes. Bundles with a live lane whose
    origin or direction is not finite are left out of the superset check:
    a NaN origin puts a NaN into the twin's hull, which can leave lanes
    that the per-lane test marks unmarked (the card's kernel does the
    same, tests/test_torch_cuda.py)."""
    o, d, t_min, t_max, lo, hi = cull_case(case, n=4096)
    live = t_max >= t_min
    per_ray = ptr.slab_per_ray(o, d, t_min, t_max, lo, hi)[0].any(1) & live
    bundled = ptr._slab_any_bundled_plain(o, d, t_min, t_max, lo, hi)
    finite = (torch.isfinite(o).all(0) & torch.isfinite(d).all(0)) | ~live
    whole = finite.view(-1, ptr._CULL_BUNDLE).all(1).repeat_interleave(
        ptr._CULL_BUNDLE)
    assert per_ray.any() and whole.any()
    assert not (per_ray & ~bundled & whole).any()
    assert not (bundled & ~live).any()
    assert (bundled & ~per_ray).any()
    assert torch.equal(ptr._slab_any_bundled(o, d, t_min, t_max, lo, hi),
                       bundled)
