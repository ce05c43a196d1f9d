"""The readers of framegraph.reflection_live_share and
framegraph.reflection_traced_share on a stubbed frame record: the live
mirror rays, or the lanes the bounces traced, over render pixels x
max_reflections x the profiled renders, in %, read by the same file in
the device-paced cell; None where the program keeps no such count,
where the record's draws are not the profiled frames, or where the cell
traces no reflection."""

import sys
import types

import pytest

from portbench import trace
from portbench.harness import Benchmark
from portbench.tests.conftest import REPO

METRIC = "framegraph.reflection_live_share"
TRACED = "framegraph.reflection_traced_share"
CFG = {"render": [64, 32], "max_reflections": 2}
FRAMES = [(0.0, 100.0), (100.0, 200.0), (200.0, 300.0)]


@pytest.fixture(scope="module")
def bench():
    return Benchmark(REPO)


def _td(cfg=CFG):
    td = trace.TraceData(cfg=cfg, triangles=0, hit_share=None, peaks=None)
    td.frames = list(FRAMES)
    return td


def _record(monkeypatch, **stats):
    from rt64tpu_torch.utils import profiling

    record = dict(frames=3, renders=4, upload_bytes=0, stage_ms={},
                  stage_calls={}, reflection_live_rays=1024,
                  reflection_traced_lanes=1536, reflection_bounces_skipped=4)
    record.update(stats)
    monkeypatch.setattr(profiling, "frame_stats", lambda: record)
    return record


def test_share_of_the_bounce_lanes(bench, monkeypatch):
    _record(monkeypatch)
    read = bench.reader(METRIC).read
    assert read(_td()) == pytest.approx(100.0 * 1024 / (64 * 32 * 2 * 4))
    assert (bench.reader(METRIC + ".device_paced").__file__
            == bench.reader(METRIC).__file__)
    assert bench.reader(METRIC).UNIT == "%"


@pytest.mark.parametrize("frames", [0, 2, 4])
def test_a_record_of_other_frames_reads_nothing(bench, monkeypatch, frames):
    _record(monkeypatch, frames=frames)
    assert bench.reader(METRIC).read(_td()) is None


def test_a_cell_without_reflections_reads_nothing(bench, monkeypatch):
    _record(monkeypatch, reflection_live_rays=0)
    assert bench.reader(METRIC).read(
        _td(dict(CFG, max_reflections=0))) is None


def test_a_program_without_the_count_reads_nothing(bench, monkeypatch):
    """The parent of the change that added the count: its record has no
    reflection_live_rays (or there is no record at all)."""
    record = _record(monkeypatch)
    del record["reflection_live_rays"]
    assert bench.reader(METRIC).read(_td()) is None
    monkeypatch.setitem(sys.modules, "rt64tpu_torch.utils.profiling",
                        types.ModuleType("rt64tpu_torch.utils.profiling"))
    assert bench.reader(METRIC).read(_td()) is None


def test_traced_share_of_the_bounce_lanes(bench, monkeypatch):
    _record(monkeypatch)
    read = bench.reader(TRACED).read
    assert read(_td()) == pytest.approx(100.0 * 1536 / (64 * 32 * 2 * 4))
    assert (bench.reader(TRACED + ".device_paced").__file__
            == bench.reader(TRACED).__file__)
    assert bench.reader(TRACED).UNIT == "%"


@pytest.mark.parametrize("case", ["other_frames", "no_reflection",
                                  "no_count", "no_record"])
def test_traced_share_reads_nothing(bench, monkeypatch, case):
    record = _record(monkeypatch, frames=2 if case == "other_frames" else 3)
    cfg = dict(CFG, max_reflections=0) if case == "no_reflection" else CFG
    if case == "no_count":
        del record["reflection_traced_lanes"]
    if case == "no_record":
        monkeypatch.setitem(sys.modules, "rt64tpu_torch.utils.profiling",
                            types.ModuleType("rt64tpu_torch.utils.profiling"))
    assert bench.reader(TRACED).read(_td(cfg)) is None
