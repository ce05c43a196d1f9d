"""The readers of the port's own record (rt64tpu_torch.utils.profiling
frame_stats: stage ms and upload bytes over the draws made while the
traced run's profiler recorded), on a stubbed record: the value a frame,
and None where a stage is missing, the record is empty, its draws are
not the profiled frames, or the program has no such record."""

import sys
import types

import pytest

from portbench import trace
from portbench.harness import Benchmark
from portbench.tests.conftest import REPO

STAGES = {"framegraph.primary_ms": "rt64.pass.primary",
          "framegraph.direct_ms": "rt64.pass.direct",
          "framegraph.indirect_ms": "rt64.pass.indirect",
          "framegraph.reflection_ms": "rt64.pass.reflection",
          "framegraph.upscale_ms": "rt64.pass.upscale"}
FRAMES = [(0.0, 100.0), (100.0, 200.0), (200.0, 300.0)]


@pytest.fixture(scope="module")
def bench():
    return Benchmark(REPO)


def _td():
    td = trace.TraceData(cfg={}, triangles=0, hit_share=None, peaks=None)
    td.frames = list(FRAMES)
    return td


def _record(monkeypatch, **stats):
    from rt64tpu_torch.utils import profiling

    record = dict(frames=3, renders=4, upload_bytes=3000,
                  stage_ms={name: 30.0 * (i + 1)
                            for i, name in enumerate(STAGES.values())},
                  stage_calls={})
    record.update(stats)
    monkeypatch.setattr(profiling, "frame_stats", lambda: record)
    return record


@pytest.mark.parametrize("metric", sorted(STAGES))
def test_stage_readers(bench, monkeypatch, metric):
    record = _record(monkeypatch)
    read = bench.reader(metric).read
    assert read(_td()) == pytest.approx(record["stage_ms"][STAGES[metric]] / 3)
    assert bench.reader(metric + ".device_paced").read is not None
    stage_ms = dict(record["stage_ms"])
    del stage_ms[STAGES[metric]]
    _record(monkeypatch, stage_ms=stage_ms)
    assert read(_td()) is None


def test_upload_reader(bench, monkeypatch):
    _record(monkeypatch)
    read = bench.reader("scene.upload_bytes").read
    assert read(_td()) == pytest.approx(1000.0)
    _record(monkeypatch, upload_bytes=0)
    assert read(_td()) == 0.0


@pytest.mark.parametrize("metric", sorted(STAGES) + ["scene.upload_bytes"])
@pytest.mark.parametrize("frames", [0, 2, 4])
def test_readers_refuse_a_record_of_other_frames(bench, monkeypatch, metric,
                                                 frames):
    _record(monkeypatch, frames=frames)
    assert bench.reader(metric).read(_td()) is None


@pytest.mark.parametrize("metric", sorted(STAGES) + ["scene.upload_bytes"])
def test_readers_of_a_program_without_the_record(bench, monkeypatch, metric):
    """The parent of the change that added the record: its profiling
    module has no frame_stats, and the reader reads nothing."""
    monkeypatch.setitem(sys.modules, "rt64tpu_torch.utils.profiling",
                        types.ModuleType("rt64tpu_torch.utils.profiling"))
    assert bench.reader(metric).read(_td()) is None
