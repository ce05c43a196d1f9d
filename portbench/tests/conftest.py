"""Shared fixtures of the benchmark's CPU tests: a benchmark of tiny
cells in a temporary root (the same harness, walk, program and
reference; a 16x16 terrain at 128x72 and 64x32 render sizes, the second
with GI and two reflection bounces), drawn on the CPU with the port's
plain-torch twins."""

import copy
import json
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY_FSR = {
    "source": "tests only", "scene": {"terrain_n": 16, "foliage": 48,
                                      "max_triangles": 16384},
    "display": [128, 96], "render": [128, 72], "di_samples": 1,
    "max_lights": 8,
    "gi_samples": 0, "max_reflections": 0, "upscaler": "fsr",
    "upscaler_mode": "auto", "denoiser": False, "precision": "float32",
    "assumed": {}, "reduced": [], "check": {"uniform": 1024, "character": 256},
    "limits": {"pick_miss_pct": 1.0, "pos_err_p99": 1e-4,
               "shade_miss_pct": 1.0, "present_lsb_p999": 2.0},
}
# With GI and two reflection bounces, as the 4K cell.
TINY_DLSS = dict(TINY_FSR, display=[128, 64], render=[64, 32],
                 gi_samples=1, max_reflections=2,
                 upscaler="dlss", upscaler_mode="performance",
                 limits={"pick_miss_pct": 1.0, "pos_err_p99": 1e-4,
                         "shade_miss_pct": 1.0, "present_lsb_p999": 3.0})


def tiny_root(tmp: str) -> str:
    """A root holding a BENCHMARK.json of two tiny cells, their
    configuration files and the walk with two warm-up frames."""
    os.makedirs(os.path.join(tmp, "portbench", "configs"))
    os.makedirs(os.path.join(tmp, "portbench", "traffic"))
    with open(os.path.join(REPO, "portbench", "traffic", "walk.json")) as fh:
        walk = json.load(fh)
    walk["warmup_frames"] = 2
    with open(os.path.join(tmp, "portbench", "traffic", "walk.json"), "w") as fh:
        json.dump(walk, fh)
    spec = copy.deepcopy(json.load(open(os.path.join(REPO, "BENCHMARK.json"))))
    spec["configs"], spec["workloads"] = [], []
    for name, cfg in (("tiny-fsr", TINY_FSR), ("tiny-dlss", TINY_DLSS)):
        path = f"portbench/configs/{name}.json"
        with open(os.path.join(tmp, path), "w") as fh:
            json.dump(cfg, fh)
        spec["configs"].append(dict(name=name, source="tests", file=path,
                                    reduced=[], why="tests"))
        spec["workloads"].append(dict(name=f"{name}.walk", config=name,
                                      traffic="walk", chips=1, why="tests"))
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return tmp


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    from portbench.harness import Benchmark

    return Benchmark(tiny_root(str(tmp_path_factory.mktemp("tiny"))))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
