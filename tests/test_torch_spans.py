"""The port's spans, stage timers and upload counter (utils/profiling.py),
on the CPU: the glass sample at 64x32 with GI, the denoiser, FSR and two
reflection bounces, so that every pass of the frame graph runs.

- One draw under torch.profiler records each span the frame runs, each
  inside the span the layers nest it in, and none of them is a user
  annotation (those would be mirrored onto the device's timeline).
- frame_stats() holds nothing while no profiler records; under one it
  counts the draw, its renders and each stage.
- A draw after Mesh.set_mesh counts at least the mesh's packed bytes
  more than a draw that re-sets no geometry.
- A frame drawn in two bands (parallel/tiling.py, in turn) adds both
  bands' stages to the one record, and threads adding at once lose
  nothing.
"""

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rt64tpu_torch import descriptors as d
from rt64tpu_torch.parallel import tiling
from rt64tpu_torch.pipeline import rows as R
from rt64tpu_torch.utils import profiling, testscenes

# Each span and the span it lies in (None: outside any rt64. span).
PARENT = {
    "rt64.api.set_mesh": None,
    "rt64.api.set_instance": None,
    "rt64.api.set_view": None,
    "rt64.draw": None,
    "rt64.scene.update": "rt64.draw",
    "rt64.pack.quad_pool": "rt64.scene.update",
    "rt64.pack.geometry": "rt64.scene.update",
    "rt64.pack.frame": "rt64.scene.update",
    "rt64.scene.render": "rt64.draw",
    "rt64.view.params": "rt64.scene.render",
    "rt64.view.present": "rt64.scene.render",
    "rt64.view.rerender": "rt64.scene.render",  # a frame that overflowed
}
PASSES = ("setup", "primary", "direct", "indirect", "refraction",
          "reflection", "compose", "upscale", "post")
PARENT.update({f"rt64.pass.{p}": "rt64.scene.render" for p in PASSES})
# The scene's cluster tables, built by the frame's first trace.
PARENT["rt64.trace.tables"] = "rt64.pass.primary"
# A light plan (ops/lighting.plan_lights) lies in any pass that lights
# points: the primary pass's transparent light, the direct light, the GI
# bounce's, the refraction's and each reflection bounce's.
PARENT["rt64.lights.plan"] = tuple(
    f"rt64.pass.{p}" for p in ("primary", "direct", "indirect", "refraction",
                               "reflection"))
STAGES = tuple(f"rt64.pass.{p}" for p in PASSES) + ("rt64.view.present",
                                                    "rt64.lights.plan")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spans(prof):
    """(name, start, end, is a user annotation) of each rt64. event, read
    from the profiler's raw events (prof.events() would build every aten
    op's event too: seconds on the CPU)."""
    return sorted(((e.name(), e.start_ns(), e.end_ns(), e.is_user_annotation())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("rt64.")), key=lambda s: s[1])


def _parent(span, spans):
    """The innermost other rt64. span that holds `span`."""
    name, a, b, _ = span
    holders = [s for s in spans if s is not span and s[1] <= a and b <= s[2]]
    return min(holders, key=lambda s: s[2] - s[1])[0] if holders else None


@pytest.fixture(scope="module")
def drawn():
    """Three draws of the sample: one with no profiler, one profiled
    after the three per-frame pushes (the sphere's mesh re-set), one
    profiled after only the camera's push. Their spans and records."""
    dev, scene, view = testscenes.build_sample_scene(
        width=64, height=32, gi_samples=1, denoiser=True,
        upscaler=d.UPSCALER_FSR, with_glass=True, device="cpu")
    testscenes.make_glass_translucent(scene)
    sphere = scene.instances[0]
    mesh = sphere.desc.mesh
    profiling.reset_frame_stats()
    dev.draw()
    out = dict(unprofiled=profiling.frame_stats())
    for key in ("pushed", "camera"):
        profiling.reset_frame_stats()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            if key == "pushed":
                mesh.set_mesh(mesh.raw_vertices, mesh.vertex_count,
                              mesh.vertex_stride, mesh.indices)
                sphere.set_description(sphere.desc)
            view.set_perspective(view.view_matrix, view.fov_radians,
                                 view.near_dist, view.far_dist)
            dev.draw()
        out[key] = (_spans(prof), profiling.frame_stats())
    profiling.reset_frame_stats()
    out["mesh_bytes"] = (mesh.vertex_count * R.VROW * 4
                         + mesh.indices.shape[0] * (3 * 4 + 4 + 1))
    out["view"] = view
    return out


def test_a_draw_records_every_span_nested(drawn):
    spans, _ = drawn["pushed"]
    assert set(PARENT) - {s[0] for s in spans} == {"rt64.view.rerender"}
    for span in spans:
        want = PARENT[span[0]]
        got = _parent(span, spans)
        if span[0].startswith("rt64.pass.") and got == "rt64.view.rerender":
            got = _parent(next(s for s in spans if s[0] == got), spans)
        assert got in want if isinstance(want, tuple) else got == want, span[0]
    assert sum(s[0] == "rt64.pass.reflection" for s in spans) == 2


def test_spans_are_not_user_annotations(drawn):
    spans, _ = drawn["pushed"]
    assert spans and not any(s[3] for s in spans)


def test_frame_stats_count_only_under_a_profiler(drawn):
    empty = drawn["unprofiled"]
    assert (empty["frames"], empty["renders"], empty["upload_bytes"]) == (0, 0, 0)
    assert empty["stage_ms"] == {} and empty["stage_calls"] == {}
    for key in ("pushed", "camera"):
        spans, st = drawn[key]
        assert st["frames"] == 1
        renders = sum(s[0] == "rt64.pass.setup" for s in spans)
        assert st["renders"] == renders >= 1
        assert set(st["stage_ms"]) == set(STAGES)
        assert all(ms >= 0.0 for ms in st["stage_ms"].values())
        assert st["stage_ms"]["rt64.pass.primary"] > 0.0
        for name in STAGES:
            assert st["stage_calls"][name] == sum(s[0] == name for s in spans)
        assert st["stage_calls"]["rt64.pass.reflection"] == 2 * renders
        assert st["stage_calls"]["rt64.view.present"] == 1


def test_a_reset_mesh_counts_its_packed_bytes(drawn):
    pushed = drawn["pushed"][1]["upload_bytes"]
    camera = drawn["camera"][1]["upload_bytes"]
    assert camera > 0
    assert pushed - camera >= drawn["mesh_bytes"]


def test_band_workers_keep_one_record(drawn):
    spans, whole = drawn["pushed"]
    plans = (whole["stage_calls"]["rt64.lights.plan"]
             // sum(s[0] == "rt64.pass.setup" for s in spans))
    assert plans >= 5
    r = drawn["view"]._renderer
    cfg = r._config()
    fn = tiling.sharded_render(cfg, 2)
    gp = r._global_params(cfg)
    profiling.reset_frame_stats()
    with profile(activities=[ProfilerActivity.CPU]):
        fn(r._sb, gp, r.history, r.bn_table, r._background_planes(cfg))
    st = profiling.frame_stats()
    profiling.reset_frame_stats()
    assert st["frames"] == 0 and st["renders"] == 2
    assert set(st["stage_ms"]) == set(STAGES) - {"rt64.view.present"}
    for name, calls in st["stage_calls"].items():
        per_band = {"rt64.pass.reflection": 2, "rt64.lights.plan": plans}
        assert calls == 2 * per_band.get(name, 1), name
    assert st["stage_ms"]["rt64.pass.primary"] > 0.0


def test_threads_adding_at_once_lose_nothing():
    rec = profiling.FrameRecord()
    threads, per = 16, 400
    interval = sys.getswitchinterval()

    def add():
        for _ in range(per):
            rec.add(renders=1, upload_bytes=3)
            rec.add_stage("rt64.pass.primary", 0.5)

    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(threads) as pool:
            for added in [pool.submit(add) for _ in range(threads)]:
                added.result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    st = rec.stats()
    assert st["renders"] == threads * per
    assert st["upload_bytes"] == 3 * threads * per
    assert st["stage_calls"]["rt64.pass.primary"] == threads * per
    assert st["stage_ms"]["rt64.pass.primary"] == pytest.approx(0.5 * threads * per)


def test_upload_counts_only_under_a_profiler():
    profiling.reset_frame_stats()
    a = np.arange(12, dtype=np.float32)
    t = profiling.upload(a, "cpu")
    assert torch.equal(t, torch.from_numpy(a))
    assert profiling.frame_stats()["upload_bytes"] == 0
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.upload(a, "cpu")
        profiling.upload(torch.zeros((), dtype=torch.int32), "cpu")
    assert profiling.frame_stats()["upload_bytes"] == 48 + 4
    profiling.reset_frame_stats()
