"""A level lit by more lights than RT64's 16 candidates, on the CPU.

- A tiny cell of 40 lights (the castle's two and a field of 38 in front
  of the keep, group bits 4, 8 and 16 in turn, the terrain taking groups
  4 and 16, the castle group 8; `max_lights` 12; the mix re-sends the
  lights every frame, 12 of them bobbing): the port reads `correct`.
- Three planted faults in the program read not correct: the lights past
  the 16th dropped from the push, eligibility given to the first 16
  lights only (the group bits of the rest cleared as they are packed),
  and the cap on a pixel's candidates lifted.
- The traffic of `castle-lights-gi` asks for the many-lights path: at
  the check's sampled pixels of its scene (seed 0, frame 0, a small
  render of the same view) the reference finds on average at least 6
  candidate lights a lit pixel, and over 16 at 1 % of them or more.
"""

import json
import os

import numpy as np
import pytest
import torch

from portbench import check, scene as sc, shading, walk as wk
from portbench import run as pr
from portbench.harness import Benchmark
from portbench.tests.conftest import REPO, TINY_FSR, tiny_root

FIELD = {"count": 38, "region": {"x": [-26.0, 26.0], "z": [-4.0, 36.0]},
         "height": [1.0, 3.0], "attenuation_radius": [20.0, 32.0],
         "point_radius": 0.3, "attenuation_exponent": 1.5,
         "colors": [[1.0, 0.6, 0.25], [1.0, 0.35, 0.1], [0.5, 0.7, 1.0]],
         "group_bits": [4, 8, 16]}
MASKS = {"terrain": 0x15, "castle": 0xB}
SCENE = dict(TINY_FSR["scene"], point_lights=FIELD, light_masks=MASKS)
TINY_40 = dict(TINY_FSR, scene=SCENE, max_lights=12)
LIGHT_MIX = {"resend": "every_frame", "moving": 12, "bob": 1.5, "rate": 0.05}
CELL = "tiny-40.walk-lights"
SEED = 3000000019


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """conftest's tiny root with the mix walk-lights and the cell CELL."""
    root = tiny_root(str(tmp_path_factory.mktemp("many_lights")))
    base = os.path.join(root, "portbench")
    with open(os.path.join(base, "traffic", "walk.json")) as fh:
        mix = dict(json.load(fh), lights=LIGHT_MIX)
    with open(os.path.join(base, "traffic", "walk-lights.json"), "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    path = "portbench/configs/tiny-40.json"
    with open(os.path.join(root, path), "w") as fh:
        json.dump(TINY_40, fh)
    spec["configs"].append(dict(name="tiny-40", source="tests", file=path,
                                reduced=[], why="tests"))
    spec["workloads"].append(dict(name=CELL, config="tiny-40",
                                  traffic="walk-lights", chips=1, why="tests"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return Benchmark(root)


def _run(bench):
    return pr.run(bench, CELL, SEED, 0.0, False, device="cpu")


def test_forty_lights_are_correct(bench):
    data = sc.build_scene(SCENE, bench.traffic("walk-lights")["character"], 1)
    assert len(data.lights) == 40
    out = _run(bench)
    assert out["correct"], out["checks"]


def _past_sixteen_dropped(monkeypatch):
    from rt64tpu_torch import api

    set_lights = api.Scene.set_lights
    monkeypatch.setattr(api.Scene, "set_lights",
                        lambda self, lights: set_lights(self, lights[:16]))


def _first_sixteen_eligible(monkeypatch):
    from rt64tpu_torch import api

    pack = api.pack_lights

    def sixteen(lights):
        arr, groups = pack(lights)
        groups = groups.copy()
        groups[16:] = 0
        return arr, groups

    monkeypatch.setattr(api, "pack_lights", sixteen)


def _cap_lifted(monkeypatch):
    from rt64tpu_torch.ops import lighting

    monkeypatch.setattr(lighting, "MAX_LIGHTS", 1 << 10)


FAULTS = {"past_sixteen_dropped": _past_sixteen_dropped,
          "first_sixteen_eligible": _first_sixteen_eligible,
          "cap_lifted": _cap_lifted}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_many_light_faults_fail(bench, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    out = _run(bench)
    assert not out["correct"], out["checks"]


def candidates(cfg: dict, traffic: dict, seed: int = 0):
    """The reference's candidate lights (uncapped) at the check's sampled
    pixels of the cell's first frame, drawn with the cell's view at a
    quarter of its size (a 320x180 display, a 240x138 render): (N,)
    counts, 0 where a pixel has none."""
    small = dict(cfg, display=[320, 180], render=[240, 138])
    data = sc.build_scene(cfg["scene"], traffic["character"], seed)
    state = wk.Walk(traffic, data, seed).frame(0)
    pixels = check.sample_pixels(small, data, state, traffic["camera"], seed,
                                 cfg["check"]["uniform"],
                                 cfg["check"]["character"])
    frame = shading.Frame(data, state, state, small, traffic["camera"], "cpu",
                          torch.float64, REPO)
    _, _, h = frame.primary(torch.as_tensor(pixels))
    s = frame.s
    la = shading.light_arrays(s, h.inst)
    delta = h.pos[None] - la["pos"][:, None]
    dist = torch.sqrt(shading.dot(delta, delta))
    ndotl = -shading.dot(h.normal[None], delta) / dist.clamp(min=1e-12)
    ign = s.ignore_normal[h.k][None]
    bias = torch.clamp(ndotl + (1 - ndotl) * ign + 0.707106, min=0.0)
    falloff = torch.clamp(1 - dist / la["radius"][:, None], min=0.0)
    intens = (torch.pow(falloff, la["atten"][:, None]) * bias
              * la["diffuse"].sum(1)[:, None])
    cand = la["elig"] & (intens > shading.EPS) & h.valid[None]
    return cand.sum(0).numpy()


def test_the_cells_traffic_asks_for_many_lights():
    bench = Benchmark(REPO)
    cell = bench.workload("castle-lights-gi.walk-lights")
    cfg = bench.config(cell["config"])
    assert cfg["max_lights"] == 12 and cfg["reduced"] == []
    count = candidates(cfg, bench.traffic(cell["traffic"]))
    lit = count[count > 0]
    assert lit.size > 0.5 * count.size
    assert lit.mean() >= 6.0, lit.mean()
    assert (lit > shading.MAX_LIGHTS).mean() >= 0.01, np.bincount(lit)
