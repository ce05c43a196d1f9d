"""A tiny cell past the tracer's size switch, on the CPU: the 16x16
terrain in the 32,768-triangle bucket (over the switch's 26,880, so the
128-triangle Moller-Trumbore table and K3/K4's twins trace every pass),
with GI, two reflection bounces and the FSR slot, as castle-large-gi.

- The port agrees with the plain reference there; the control (the
  reference a precision step below) and a planted fault (the scene's
  cluster tables kept from the first frame, so the character and the
  swaying foliage go stale) come out not correct.
- The switch answers False for its bucket and True for the tiny cells
  of conftest.py.
- The readers of kernels.k3_opaque_roofline, kernels.k4_shadow_roofline
  and kernels.mt_launches on synthetic traces and a stubbed record.
"""

import json
import os
import sys
import types

import pytest

from portbench import program, scene, trace
from portbench import run as pr
from portbench.harness import Benchmark
from portbench.tests.conftest import REPO, TINY_FSR, tiny_root

TINY_LARGE = dict(TINY_FSR, scene={"terrain_n": 16, "foliage": 48,
                                   "max_triangles": 32768},
                  gi_samples=1, max_reflections=2)
SEED = 20261018 + 2**31


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """conftest's tiny root with the cell tiny-large.walk beside its two."""
    root = tiny_root(str(tmp_path_factory.mktemp("large")))
    path = "portbench/configs/tiny-large.json"
    with open(os.path.join(root, path), "w") as fh:
        json.dump(TINY_LARGE, fh)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["configs"].append(dict(name="tiny-large", source="tests", file=path,
                                reduced=[], why="tests"))
    spec["workloads"].append(dict(name="tiny-large.walk", config="tiny-large",
                                  traffic="walk", chips=1, why="tests"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return Benchmark(root)


def _run(bench, **kw):
    return pr.run(bench, "tiny-large.walk", SEED, 0.0, False, device="cpu",
                  **kw)


def test_program_is_correct_and_the_control_fails(bench):
    out = _run(bench, with_control=True)
    assert out["correct"], out["checks"]
    assert out["checks"]["pick_miss_pct"]["value"] <= 0.5
    assert not out["control"]["correct"], out["control"]


def test_tables_kept_from_the_first_frame_fail(bench, monkeypatch):
    """The cluster tables of the first frame's scene reused for every
    later frame, whatever was re-set since."""
    from rt64tpu_torch.ops import tracer_cuda as tc

    build, first = tc._scene_tables, []

    def kept(trace_scene):
        if not first:
            first.append(build(trace_scene))
        return first[0]

    monkeypatch.setattr(tc, "_scene_tables", kept)
    out = _run(bench)
    assert first and not first[0].resident
    assert not out["correct"], out["checks"]
    assert out["checks"]["pick_miss_pct"]["value"] > 0.5


@pytest.mark.parametrize("cell,resident", [("tiny-fsr.walk", True),
                                           ("tiny-dlss.walk", True),
                                           ("tiny-large.walk", False)])
def test_the_size_switch(bench, monkeypatch, cell, resident):
    """One frame of the cell: every table it builds is of the side of
    the switch its bucket lies on."""
    from rt64tpu_torch.ops import tracer_cuda as tc

    build, seen = tc._scene_tables, []

    def spied(trace_scene):
        tables = build(trace_scene)
        seen.append((trace_scene.num_triangles, tables.resident))
        return tables

    monkeypatch.setattr(tc, "_scene_tables", spied)
    cfg = bench.config(bench.workload(cell)["config"])
    traffic = bench.traffic("walk")
    data = scene.build_scene(cfg["scene"], traffic["character"], SEED)
    prog = program.build(data, cfg, "cpu")
    program.draw(prog)
    assert seen
    for n, got in seen:
        assert n == cfg["scene"]["max_triangles"]
        assert got == tc.clusters_resident(n) == resident


# Readers, on synthetic traces.

CFG = {"render": [960, 552], "di_samples": 1}
PEAKS = {"fp32_flops_per_s": 67e12, "memory_bytes_per_s": 3.35e12}
PRO = "(anonymous namespace)::prologue_kernel(float const*, int)"


def _walk(kind, layout):
    return (f"void (anonymous namespace)::trace_{kind}_walk<(anonymous "
            f"namespace)::{layout}, false, true>(float const*)")


def _fin(layout):
    return (f"void (anonymous namespace)::finalize_kernel<(anonymous "
            f"namespace)::{layout}>(float const*)")


def _frame(layout):
    """One frame: the opaque launch's prologue, walk and finalize take
    100 us, the shadow launch's prologue and walk 50, then a bounce's."""
    return [("x", 0.0, 5.0), (PRO, 10.0, 20.0),
            (_walk("opaque", layout), 20.0, 100.0), ("y", 100.0, 101.0),
            (_fin(layout), 101.0, 111.0), (PRO, 120.0, 130.0),
            (_walk("shadow", layout), 130.0, 170.0),
            (_walk("opaque", layout), 200.0, 900.0),
            (_walk("shadow", layout), 900.0, 990.0)]


def _td(kernels, **kw):
    td = trace.TraceData(cfg=CFG, triangles=33292, hit_share=0.5,
                         peaks=PEAKS)
    td.frames = [(0.0, 1000.0)]
    td.kernels = kernels
    for k, v in kw.items():
        setattr(td, k, v)
    return td


@pytest.fixture(scope="module")
def repo():
    return Benchmark(REPO)


@pytest.mark.parametrize("mt,woop", [("kernels.k3_opaque_roofline",
                                      "kernels.k1_opaque_roofline"),
                                     ("kernels.k4_shadow_roofline",
                                      "kernels.k2_shadow_roofline")])
def test_mt_rooflines_read_the_mt_walks(repo, mt, woop):
    k_mt, k_woop = repo.reader(mt), repo.reader(woop)
    # The same work counted by the same functions, whatever the table.
    assert k_mt.work(960 * 552, 33292) == k_woop.work(960 * 552, 33292)
    got = k_mt.read(_td(_frame("MtClusters")))
    assert got is not None and 0.0 < got <= 100.0
    assert got == pytest.approx(k_woop.read(_td(_frame("WoopClusters"))))
    # Each reads its own layout's walks alone, and K1/K2's are untouched.
    assert k_mt.read(_td(_frame("WoopClusters"))) is None
    assert k_woop.read(_td(_frame("MtClusters"))) is None
    assert k_mt.read(_td([])) is None
    assert k_mt.read(_td(_frame("MtClusters"), peaks=None)) is None


def test_k3_roofline_counts_the_first_launch(repo):
    k3 = repo.reader("kernels.k3_opaque_roofline")
    rays = 960 * 552
    ops, nbytes = k3.work(rays, 33292)
    least = max(ops / 67e12, nbytes / 3.35e12)
    assert k3.read(_td(_frame("MtClusters"))) == pytest.approx(
        100.0 * least / 100e-6)


def _record(monkeypatch, **stats):
    from rt64tpu_torch.utils import profiling

    record = dict(frames=1, renders=1, upload_bytes=0, stage_ms={},
                  stage_calls={}, opaque_launches=0, shadow_launches=0,
                  opaque_mt_launches=4, shadow_mt_launches=3,
                  alpha_sweep_launches=6)
    record.update(stats)
    monkeypatch.setattr(profiling, "frame_stats", lambda: record)


def test_mt_launches_reader(repo, monkeypatch):
    read = repo.reader("kernels.mt_launches").read
    _record(monkeypatch)
    assert read(_td([])) == 7.0
    _record(monkeypatch, frames=2, opaque_mt_launches=9, shadow_mt_launches=5)
    assert read(_td([], frames=[(0.0, 1.0), (1.0, 2.0)])) == 7.0
    _record(monkeypatch, frames=3)  # not the profiled frames
    assert read(_td([])) is None
    _record(monkeypatch, frames=0)
    assert read(_td([])) is None


def test_mt_launches_of_a_program_without_the_counts(repo, monkeypatch):
    """A program whose record has no launch counts (the parent of the
    change that added them), or no record at all: nothing is read."""
    from rt64tpu_torch.utils import profiling

    record = dict(frames=1, renders=1, upload_bytes=0, stage_ms={},
                  stage_calls={})
    monkeypatch.setattr(profiling, "frame_stats", lambda: record)
    read = repo.reader("kernels.mt_launches").read
    assert read(_td([])) is None
    monkeypatch.setitem(sys.modules, "rt64tpu_torch.utils.profiling",
                        types.ModuleType("rt64tpu_torch.utils.profiling"))
    assert read(_td([])) is None
