"""The harness finds cells, configurations, traffic mixes and per-layer
metrics by name in files, refuses an unknown name, and takes a new
configuration, mix and metric as new files and entries alone; and
BENCHMARK.json keeps to the shapes its readers expect."""

import json
import os
import re
import shutil

import pytest

from portbench.harness import Benchmark, UnknownName

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return Benchmark(REPO)


def test_every_cell_finds_its_files(bench):
    for wl in bench.spec["workloads"]:
        cfg = bench.config(wl["config"])
        traffic = bench.traffic(wl["traffic"])
        assert cfg["render"] and traffic["warmup_frames"] > 0
        for m in bench.per_layer(wl["name"]):
            mod = bench.reader(m["name"])
            assert mod.UNIT == m["unit"] and callable(mod.read)


@pytest.mark.parametrize("kind,name", [
    ("workload", "no-such.cell"), ("config", "no-such-config"),
    ("traffic", "no-such-mix"), ("reader", "no.such_metric"),
    ("reader", "kernels.k9_roofline.device_paced")])
def test_unknown_names_are_refused(bench, kind, name):
    with pytest.raises(UnknownName):
        getattr(bench, kind)(name)


def test_split_metrics_read_as_their_base(bench):
    """A metric split by the end-to-end metric it moves reads by its
    base's file; an end-to-end metric so split takes its base's value."""
    assert (bench.reader("scene.update_ms.device_paced").__file__
            == bench.reader("scene.update_ms").__file__)
    assert Benchmark.base_name("frame_ms.device_paced",
                               {"frame_ms": 1, "frame_ms_p95": 2}) == "frame_ms"
    assert Benchmark.base_name("frame_ms_p95", {"frame_ms", "frame_ms_p95"}) == "frame_ms_p95"


@pytest.mark.parametrize("key,value", [("loop", "open"), ("present", "pipelined")])
def test_unknown_loop_or_present_is_refused(key, value):
    """A mix that asks for a loop or present mode the harness does not
    drive is refused, never run as full sync."""
    from portbench import walk

    walk_mix = json.load(open(os.path.join(REPO, "portbench", "traffic",
                                           "walk.json")))
    walk.check_modes(walk_mix)
    with pytest.raises(UnknownName):
        walk.check_modes(dict(walk_mix, **{key: value}))


def test_a_new_cell_is_files_and_entries_only(bench, tmp_path):
    """A dummy configuration, mix and metric beside copies of the files
    that exist, which are left as they are."""
    root = tmp_path
    shutil.copytree(os.path.join(REPO, "portbench", "configs"),
                    root / "portbench" / "configs")
    shutil.copytree(os.path.join(REPO, "portbench", "traffic"),
                    root / "portbench" / "traffic")
    shutil.copytree(os.path.join(REPO, "portbench", "metrics"),
                    root / "portbench" / "metrics")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "portbench" / "configs" / "dummy.json").write_text(
        json.dumps({"render": [64, 32], "display": [64, 32]}))
    (root / "portbench" / "traffic" / "still.json").write_text(
        json.dumps({"warmup_frames": 1}))
    (root / "portbench" / "metrics" / "dummy.count.py").write_text(
        'UNIT = "n"\n\ndef read(td):\n    return 7.0\n')
    spec = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    spec["configs"].append(dict(name="dummy", source="tests",
                                file="portbench/configs/dummy.json",
                                reduced=[], why="tests"))
    spec["workloads"].append(dict(name="dummy.still", config="dummy",
                                  traffic="still", chips=1, why="tests"))
    spec["per_layer"].append(dict(
        name="dummy.count", unit="n", better="lower", source="program_counter",
        layer="tests", moves="frame_ms", workloads=["dummy.still"]))
    b = Benchmark(str(root), spec)
    assert b.config("dummy")["render"] == [64, 32]
    assert b.traffic("still")["warmup_frames"] == 1
    assert [m["name"] for m in b.per_layer("dummy.still")] == ["dummy.count"]
    assert b.reader("dummy.count").read(None) == 7.0
    assert "dummy.count" not in [m["name"] for m in b.per_layer(
        "castle-480p-fsr.walk")]
    assert all(p.read_bytes() == data for p, data in before.items())


def test_benchmark_json_shapes(bench):
    spec = bench.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                  "per_layer") for e in spec[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer")
               for m in spec[k])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert bench.reader(m["name"]).UNIT == m["unit"]
        moved = next(e for e in spec["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    for c in spec["configs"]:
        assert c["file"].startswith("portbench/")
        assert c["reduced"] == bench.config(c["name"])["reduced"]
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = [m for m in spec["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2 and bench.per_layer(w["name"])
