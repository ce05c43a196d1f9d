"""A level lit by many point lights, on the CPU: the castle's two lights
and a configured field of 12 point lights (14 in all), light group masks
on the terrain and the castle, `max_lights` 8, and a mix that re-sends
the light list every frame with 4 lights bobbing.

- The field and the mix: fixed places, heights above the terrain, group
  bits cycled, no flicker; the seed picks the bobbing lights; push
  re-sets the frame's lights after the instances.
- Two tiny cells (the FSR size, and the same with GI and two reflection
  bounces): the port agrees with the plain reference; the control and
  each planted fault (a light dropped from the push, the lights frozen
  at set-up, group bits ignored) come out not correct.
- The reference over a 20-light field: a pixel's 17th and later
  candidate lights, in light order, take no share (Lights.hlsli's cap).
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from portbench import program, scene as sc, shading, walk as wk
from portbench import run as pr
from portbench.harness import Benchmark, UnknownName
from portbench.tests.conftest import REPO, TINY_FSR, tiny_root
from portbench.tests.test_portbench_fingerprint import stand_in

FIELD = {"count": 12, "region": {"x": [-18.0, 18.0], "z": [-8.0, 30.0]},
         "height": [1.0, 3.0], "attenuation_radius": [14.0, 24.0],
         "point_radius": 0.3, "attenuation_exponent": 1.5,
         "colors": [[1.0, 0.6, 0.25], [1.0, 0.35, 0.1], [0.5, 0.7, 1.0]],
         "group_bits": [4, 8]}
# The terrain takes the sun, the castle's glow and the field's group 4;
# the castle the sun, its glow and group 8; the rest every light.
MASKS = {"terrain": 0x7, "castle": 0xB}
LIGHTS_SCENE = dict(TINY_FSR["scene"], point_lights=FIELD, light_masks=MASKS)
TINY_LIGHTS = dict(TINY_FSR, scene=LIGHTS_SCENE, max_lights=8)
TINY_LIGHTS_GI = dict(TINY_LIGHTS, gi_samples=1, max_reflections=2)
LIGHT_MIX = {"resend": "every_frame", "moving": 4, "bob": 2.0, "rate": 0.05}
CELLS = ("tiny-lights.walk-lights", "tiny-lights-gi.walk-lights")
SEED = 20261019 + 2**31


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """conftest's tiny root with the mix walk-lights (the walk with the
    light block) and the two cells of CELLS beside its own."""
    root = tiny_root(str(tmp_path_factory.mktemp("lights")))
    base = os.path.join(root, "portbench")
    with open(os.path.join(base, "traffic", "walk.json")) as fh:
        mix = dict(json.load(fh), lights=LIGHT_MIX)
    with open(os.path.join(base, "traffic", "walk-lights.json"), "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    for name, cfg in (("tiny-lights", TINY_LIGHTS),
                      ("tiny-lights-gi", TINY_LIGHTS_GI)):
        path = f"portbench/configs/{name}.json"
        with open(os.path.join(root, path), "w") as fh:
            json.dump(cfg, fh)
        spec["configs"].append(dict(name=name, source="tests", file=path,
                                    reduced=[], why="tests"))
        spec["workloads"].append(dict(name=f"{name}.walk-lights", config=name,
                                      traffic="walk-lights", chips=1,
                                      why="tests"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return Benchmark(root)


def _walk(bench, seed=SEED, frames=4):
    traffic = bench.traffic("walk-lights")
    data = sc.build_scene(LIGHTS_SCENE, traffic["character"], seed)
    w = wk.Walk(traffic, data, seed)
    return traffic, data, w, [w.frame(f) for f in range(frames)]


# The field and the mix.

def test_the_field():
    lights = sc.point_light_field(FIELD)
    assert len(lights) == FIELD["count"]
    assert lights == sc.point_light_field(FIELD)  # a fixed draw
    for i, light in enumerate(lights):
        x, y, z = light["position"]
        assert -18.0 <= x <= 18.0 and -8.0 <= z <= 30.0
        assert not sc._in_castle(x, z)
        assert 1.0 <= y - float(sc.terrain_height(x, z)) <= 3.0
        assert 14.0 <= light["attenuation_radius"] <= 24.0
        assert list(light["diffuse_color"]) in FIELD["colors"]
        assert light["group_bits"] == FIELD["group_bits"][i % 2]
        assert light["flicker_intensity"] == 0.0


def test_the_scene_takes_the_field_and_masks(bench):
    character = bench.traffic("walk-lights")["character"]
    plain = sc.build_scene(TINY_FSR["scene"], character, 5)
    data = sc.build_scene(LIGHTS_SCENE, character, 5)
    assert data.lights[:2] == plain.lights
    assert data.lights[2:] == sc.point_light_field(FIELD)
    for inst in data.instances:
        want = MASKS.get(inst.mesh, shading.LIGHT_GROUP_ALL)
        assert sc.material(inst)["light_group_mask_bits"] == want
    # The masks touch no other instance's material, nor FOG itself.
    assert "light_group_mask_bits" not in sc.FOG
    assert program.scene_limits(data, TINY_LIGHTS).max_lights == 16


def test_the_mix_bobs_the_seeds_lights(bench):
    traffic, data, w, states = _walk(bench)
    assert all(st.resend_lights for st in states)
    moved = [i for i in range(len(data.lights))
             if states[0].lights[i] != states[3].lights[i]]
    assert moved == w.bobbing and len(moved) == LIGHT_MIX["moving"]
    for st in states:
        for i, (got, base) in enumerate(zip(st.lights, data.lights)):
            assert {k: v for k, v in got.items() if k != "position"} == {
                k: v for k, v in base.items() if k != "position"}
            dx, dy, dz = np.subtract(got["position"], base["position"])
            assert dx == dz == 0.0 and abs(dy) <= LIGHT_MIX["bob"]
    again = _walk(bench)[3]
    assert [st.lights for st in again] == [st.lights for st in states]
    other = _walk(bench, seed=SEED + 1)[2]
    assert other.bobbing != w.bobbing or not np.array_equal(
        other.bob_phase, w.bob_phase)


def test_push_resets_the_frames_lights(bench):
    traffic, data, _, states = _walk(bench, frames=2)
    log = []
    prog = stand_in(data, log)
    program.push(prog, states[1], traffic["camera"])
    calls = [(name, method) for name, method, *_ in log]
    sets = [i for i, c in enumerate(calls) if c == ("scene", "set_lights")]
    assert len(sets) == 1
    last_instance = max(i for i, (name, _) in enumerate(calls)
                        if name.startswith("instance."))
    assert last_instance < sets[0] < calls.index(("view", "set_perspective"))
    pushed = log[sets[0]][2][0]
    assert [tuple(light.position) for light in pushed] == [
        tuple(light["position"]) for light in states[1].lights]


@pytest.mark.parametrize("resend", ["first_frame", None])
def test_unknown_resend_is_refused(bench, resend):
    mix = bench.traffic("walk-lights")
    wk.check_modes(mix)
    with pytest.raises(UnknownName):
        wk.check_modes(dict(mix, lights=dict(LIGHT_MIX, resend=resend)))


# The tiny cells.

def _run(bench, cell, **kw):
    return pr.run(bench, cell, SEED, 0.0, False, device="cpu", **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct_and_the_control_fails(bench, cell):
    out = _run(bench, cell, with_control=True)
    assert out["correct"], out["checks"]
    assert out["checks"]["pick_miss_pct"]["value"] <= 0.5
    assert not out["control"]["correct"], out["control"]


def _set_lights_patched(monkeypatch, fn):
    from rt64tpu_torch import api

    set_lights = api.Scene.set_lights
    monkeypatch.setattr(api.Scene, "set_lights",
                        lambda self, lights: fn(set_lights, self, lights))


def _dropped(set_lights, scene, lights):
    """The push's light list with the field's first light left out."""
    set_lights(scene, lights[:2] + lights[3:])


def _frozen(set_lights, scene, lights):
    """The lights of set-up kept, whatever is set later."""
    if not getattr(scene, "_portbench_frozen", False):
        set_lights(scene, lights)
        scene._portbench_frozen = True


FAULTS = {"light_dropped": _dropped, "lights_frozen": _frozen}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_light_faults_fail(bench, monkeypatch, cell, fault):
    _set_lights_patched(monkeypatch, FAULTS[fault])
    out = _run(bench, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_group_bits_ignored_fails(bench, monkeypatch, cell):
    """Every light eligible for every material: the packed group bits
    all set."""
    from rt64tpu_torch import api

    pack = api.pack_lights

    def every_group(lights):
        arr, groups = pack(lights)
        return arr, np.full_like(groups, 0xFFFFFFFF)

    monkeypatch.setattr(api, "pack_lights", every_group)
    out = _run(bench, cell)
    assert not out["correct"], out["checks"]


# The reference past 16 lights.

FIELD_18 = dict(FIELD, count=18, region={"x": [-12.0, 12.0], "z": [24.0, 40.0]},
                attenuation_radius=[60.0, 80.0], group_bits=[4])
# Hand-placed points on the terrain in front of the castle, under the
# field: each of its lights and the sun reach every one.
POINTS = ((0.0, 32.0), (-6.0, 28.0), (7.0, 36.0), (3.0, 26.0))


def _lights_at(data, lights, max_light_count):
    """The reference's direct light at POINTS (terrain hits, normal up)
    with the scene's lights replaced by `lights`."""
    state = types.SimpleNamespace(
        transforms=[i.transform for i in data.instances],
        previous=[i.transform for i in data.instances],
        character=data.meshes["character"], lights=lights)
    s = shading.Scene(data, state, "cpu", torch.float64)
    pos = torch.tensor([(x, float(sc.terrain_height(x, z)), z)
                        for x, z in POINTS], dtype=torch.float64)
    n = len(POINTS)
    terrain = torch.zeros(n, dtype=torch.int64)  # instance 0
    hits = types.SimpleNamespace(
        pos=pos, normal=torch.tensor([[0.0, 1.0, 0.0]] * n, dtype=torch.float64),
        valid=torch.ones(n, dtype=torch.bool), inst=terrain, k=terrain)
    ray = torch.nn.functional.normalize(pos - torch.tensor([0.0, 7.0, 50.0],
                                                           dtype=torch.float64))
    pixels = torch.tensor([(10 + 9 * i, 5 + 4 * i) for i in range(n)])
    bn = shading.blue_noise_table(REPO, "cpu")
    return shading.lights(s, bn, pixels, 0, hits, ray, max_light_count, 1,
                          shadows=True)


def test_reference_caps_candidates_at_16_in_light_order(monkeypatch):
    """A 20-light field with 19 candidates at each point, and as many
    rounds as candidates: the lights after the 16th candidate take no
    share (the result is that of the lights up to it alone), and lifting
    the cap gives them one."""
    character = Benchmark(REPO).traffic("walk")["character"]
    data = sc.build_scene(dict(TINY_FSR["scene"], point_lights=FIELD_18),
                          character, 3)
    assert len(data.lights) == 20
    reach = [[np.linalg.norm(np.subtract(light["position"], (
        x, float(sc.terrain_height(x, z)), z))) < light["attenuation_radius"]
        for light in data.lights] for x, z in POINTS]
    cand = [i for i, r in enumerate(reach[0]) if r]
    assert all(r == reach[0] for r in reach) and len(cand) == 19
    full = _lights_at(data, data.lights, 16)
    upto16 = _lights_at(data, data.lights[:cand[15] + 1], 16)
    assert torch.allclose(full, upto16, rtol=1e-12, atol=0.0)
    monkeypatch.setattr(shading, "MAX_LIGHTS", 20)
    every = _lights_at(data, data.lights, 20)
    assert (every - full).abs().max() > 1e-3
