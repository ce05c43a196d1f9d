"""The reductions behind the metrics: frame_ms over the whole window,
the 95th percentile over every frame, the idle share as a union of
intervals, per-layer readers on a synthetic trace, and the roofline's
work counted from the inputs alone."""

import statistics

import pytest

from portbench import run as pr
from portbench import trace
from portbench.harness import Benchmark
from portbench.tests.conftest import REPO

CFG = {"render": [512, 368], "di_samples": 1}
PEAKS = {"fp32_flops_per_s": 67e12, "memory_bytes_per_s": 3.35e12}
K1 = "void (anonymous namespace)::trace_opaque_walk<(anonymous namespace)::WoopClusters, false, true>(float const*)"
K2 = "void (anonymous namespace)::trace_shadow_walk<(anonymous namespace)::WoopClusters, false>(float const*)"
PRO = "(anonymous namespace)::prologue_kernel(float const*, int)"
FIN = "void (anonymous namespace)::finalize_kernel<(anonymous namespace)::WoopClusters>(float const*)"


@pytest.fixture(scope="module")
def bench():
    return Benchmark(REPO)


def _td(**kw):
    td = trace.TraceData(cfg=CFG, triangles=5452, hit_share=0.5, peaks=PEAKS)
    for k, v in kw.items():
        setattr(td, k, v)
    return td


def test_frame_ms_is_the_window_over_all_frames():
    times = [0.1] * 99 + [1.1]
    m = pr.window_metrics(times, wall=11.5)
    assert m["frame_ms"] == pytest.approx(115.0)


def test_p95_is_over_every_frame():
    times = [0.1] * 90 + [0.5] * 10
    m = pr.window_metrics(times, wall=14.0)
    assert m["frame_ms_p95"] == pytest.approx(statistics.quantiles(
        [t * 1e3 for t in times], n=100, method="inclusive")[94])
    assert m["frame_ms_p95"] > 100.0


def test_idle_share_is_a_union_of_intervals(bench):
    kernels = [("a", 0.0, 10.0), ("b", 5.0, 15.0), ("c", 20.0, 30.0)]
    td = _td(frames=[(0.0, 20.0), (20.0, 40.0)], kernels=kernels)
    assert trace.busy_us(kernels) == 25.0
    assert bench.reader("device.idle_pct").read(td) == pytest.approx(37.5)
    assert trace.gaps(kernels, 0.0, 40.0) == [(15.0, 20.0), (30.0, 40.0)]


def test_simple_readers(bench):
    td = _td(frames=[(0.0, 100.0), (100.0, 200.0)],
             kernels=[("k", 10.0, 20.0), ("Memcpy DtoH", 30.0, 40.0),
                      ("k", 110.0, 140.0)],
             scene_update_ms=[2.0, 4.0], sync_frames=4,
             sync_sites={"a.py:1": 6, "b.py:2": 2})
    read = lambda name: bench.reader(name).read(td)
    assert read("scene.update_ms") == 3.0
    assert read("view.host_syncs") == 2.0
    assert read("framegraph.device_ms") == pytest.approx(0.025)
    assert read("framegraph.launches") == 1.0
    empty = _td()
    for name in ("scene.update_ms", "view.host_syncs", "framegraph.device_ms",
                 "framegraph.launches", "device.idle_pct",
                 "kernels.k1_opaque_roofline", "kernels.k2_shadow_roofline"):
        assert bench.reader(name).read(empty) is None


def test_rooflines_count_the_inputs(bench):
    k1, k2 = (bench.reader("kernels.k1_opaque_roofline"),
              bench.reader("kernels.k2_shadow_roofline"))
    rays = 512 * 368
    ops, nbytes = k1.work(rays, 5452)
    assert (ops, nbytes) == (rays * k1.OPS_PER_TEST,
                             rays * 48 + 5452 * 36)
    # One frame: K1's prologue, walk and finalize take 100 us; K2's 50.
    kernels = [("x", 0.0, 5.0), (PRO, 10.0, 20.0), (K1, 20.0, 100.0),
               ("y", 100.0, 101.0), (FIN, 101.0, 111.0), (PRO, 120.0, 130.0),
               (K2, 130.0, 170.0), (K1, 200.0, 900.0)]
    td = _td(frames=[(0.0, 1000.0)], kernels=kernels)
    least1 = max(ops / 67e12, nbytes / 3.35e12)
    assert k1.read(td) == pytest.approx(100.0 * least1 / 100e-6)
    rays2 = round(0.5 * rays)
    least2 = max(rays2 * k2.OPS_PER_TEST / 67e12,
                 (rays2 * 36 + 5452 * 36) / 3.35e12)
    assert k2.read(td) == pytest.approx(100.0 * least2 / 50e-6)
    # Other kernels, longer or renamed, change nothing.
    td2 = _td(frames=[(0.0, 1000.0)],
              kernels=[(n.replace("x", "z"), a, b * 1.0) for n, a, b in kernels])
    assert k1.read(td2) == k1.read(td)
    assert k1.read(_td(frames=[(0.0, 1.0)], kernels=[])) is None
    assert k1.read(_td(frames=[(0.0, 1000.0)], kernels=kernels, peaks=None)) is None


def test_idle_gaps_take_the_innermost_host_range():
    host = [("frame", 0.0, 100.0), ("aten::item", 20.0, 40.0),
            ("cudaStreamSynchronize", 25.0, 35.0), ("aten::mul", 60.0, 62.0)]
    spans = [(26.0, 34.0), (41.0, 59.0), (60.5, 61.5)]
    assert trace.label_gaps(host, spans) == [
        "cudaStreamSynchronize", "frame", "aten::mul"]
    td = _td(frames=[(0.0, 100.0)], kernels=[("k", 10.0, 90.0)],
             host=[("aten::add", 0.0, 8.0), ("aten::item", 91.0, 100.0)])
    b = trace.breakdown(td)
    assert b["device_ops"] == [["k", pytest.approx(80e-6)]]
    assert dict(b["idle_gaps"]) == {"aten::add": pytest.approx(10e-6),
                                    "aten::item": pytest.approx(10e-6)}
