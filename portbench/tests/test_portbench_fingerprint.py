"""The accepted cells' inputs, held to digests: for each configuration of
BENCHMARK.json and seeds 0, 1 and 2, the seeded scene (every array,
instance and light), the walk's first frames and the calls that
program.push makes for them, recorded through stand-in objects. The
digests were taken from the harness before it learned point lights and
a light list re-sent each frame; a mix or configuration that names
neither must push, draw and check what it did then."""

import dataclasses
import hashlib

import numpy as np
import pytest

from portbench import program, scene as sc, walk as wk
from portbench.harness import Benchmark
from portbench.tests.conftest import REPO

SEEDS = (0, 1, 2)
FRAMES = 8
# The fields of a FrameState that a mix without a light block has always
# had; what it carries besides is checked apart.
STATE_FIELDS = ("index", "eye", "target", "view_matrix", "transforms",
                "previous", "character")
# (configuration, seed): (scene, walk states, pushes), sha256 hex.
DIGESTS = {
    ("castle-480p-fsr", 0): (
        "af833f4811eff18b63689ccc64c5779d6b4390c7df2b4d018d3a2f59e889e49c",
        "7e40ba38bac3effad7eabf9e544754af46041c143961efb5bc0881dc8143dc1f",
        "3cb1b83a4f8b0e6164949322be401b4b3e3895c7dd2c0a559b50100d1f7f750e"),
    ("castle-480p-fsr", 1): (
        "fb1b2d296b0db1c3b99dadb510dc227864a7f9769a1c7f38031ec437062d0608",
        "c4378ab692cc0151cc21d43ce22cade31f8ffdfba6d650162c53119042ad8d86",
        "9a692147bdab86c32f0607e4648420453d7299bd9e0c6806d83e22843477c4fd"),
    ("castle-480p-fsr", 2): (
        "2fd905af15a27a2861a0bd8de523aa4ba8845bd4fb98e2767dfe983a03b8087e",
        "4020e247352a9beb7f6441c0d9e04d4c6ad83db81187db8c87a38db7ce382fdd",
        "e5437ee2006022fd6c1159fffceab149c7fa97eae80295ede2302ead8adff324"),
    ("castle-4k-dlss", 0): (
        "af833f4811eff18b63689ccc64c5779d6b4390c7df2b4d018d3a2f59e889e49c",
        "7e40ba38bac3effad7eabf9e544754af46041c143961efb5bc0881dc8143dc1f",
        "3cb1b83a4f8b0e6164949322be401b4b3e3895c7dd2c0a559b50100d1f7f750e"),
    ("castle-4k-dlss", 1): (
        "fb1b2d296b0db1c3b99dadb510dc227864a7f9769a1c7f38031ec437062d0608",
        "c4378ab692cc0151cc21d43ce22cade31f8ffdfba6d650162c53119042ad8d86",
        "9a692147bdab86c32f0607e4648420453d7299bd9e0c6806d83e22843477c4fd"),
    ("castle-4k-dlss", 2): (
        "2fd905af15a27a2861a0bd8de523aa4ba8845bd4fb98e2767dfe983a03b8087e",
        "4020e247352a9beb7f6441c0d9e04d4c6ad83db81187db8c87a38db7ce382fdd",
        "e5437ee2006022fd6c1159fffceab149c7fa97eae80295ede2302ead8adff324"),
    ("castle-large-gi", 0): (
        "5a70aef7abf93aa6c4988267a46b0838739ff34c40537877476c92818f244665",
        "7e40ba38bac3effad7eabf9e544754af46041c143961efb5bc0881dc8143dc1f",
        "3cb1b83a4f8b0e6164949322be401b4b3e3895c7dd2c0a559b50100d1f7f750e"),
    ("castle-large-gi", 1): (
        "590df9a3a4e1c7c7e3e35b65aa91eea75177320a4efb9ac65e5143cef72e9f2f",
        "c4378ab692cc0151cc21d43ce22cade31f8ffdfba6d650162c53119042ad8d86",
        "9a692147bdab86c32f0607e4648420453d7299bd9e0c6806d83e22843477c4fd"),
    ("castle-large-gi", 2): (
        "8694906a756bdc109bd3df7e172f445d2a0e9a703969d0606abbb9268780fdde",
        "4020e247352a9beb7f6441c0d9e04d4c6ad83db81187db8c87a38db7ce382fdd",
        "e5437ee2006022fd6c1159fffceab149c7fa97eae80295ede2302ead8adff324"),
}


class Recorder:
    """A stand-in for an object of the port's API: each method call is
    appended to `log` as (name, method, args, kwargs)."""

    def __init__(self, name: str, log: list):
        self.name, self._log = name, log

    def __getattr__(self, method):
        if method.startswith("_"):
            raise AttributeError(method)
        return lambda *args, **kw: self._log.append(
            (self.name, method, args, kw))


def feed(h, x):
    """Hash `x` into `h`: arrays by dtype, shape and bytes; dataclasses,
    dicts, lists and scalars by their content; a Recorder by name."""
    if isinstance(x, Recorder):
        h.update(b"R" + x.name.encode())
    elif isinstance(x, np.ndarray):
        h.update(b"A" + x.dtype.str.encode() + repr(x.shape).encode())
        h.update(np.ascontiguousarray(x).tobytes())
    elif dataclasses.is_dataclass(x):
        h.update(b"D" + type(x).__name__.encode())
        for f in dataclasses.fields(x):
            feed(h, f.name)
            feed(h, getattr(x, f.name))
    elif isinstance(x, dict):
        h.update(b"M%d" % len(x))
        for k in sorted(x, key=str):
            feed(h, k)
            feed(h, x[k])
    elif isinstance(x, (list, tuple)):
        h.update(b"L%d" % len(x))
        for e in x:
            feed(h, e)
    elif isinstance(x, (bool, int, float, str, type(None), np.generic)):
        h.update(b"S" + type(x).__name__.encode() + repr(x).encode())
    else:
        raise TypeError(f"no digest for {type(x).__name__}")


def digest(x) -> str:
    h = hashlib.sha256()
    feed(h, x)
    return h.hexdigest()


def stand_in(data: sc.SceneData, log: list) -> program.Program:
    """A Program of Recorders over `data`, as program.build names its
    objects."""
    r = lambda name: Recorder(name, log)
    return program.Program(
        dev=r("device"), scene=r("scene"), view=r("view"), data=data,
        instances=[r(f"instance.{i}") for i in range(len(data.instances))],
        meshes={k: r(f"mesh.{k}") for k in data.meshes},
        textures={k: r(f"texture.{k}") for k in data.textures},
        shaders={k: r(f"shader.{k}") for k in ("texture", "leaf", "color")})


def fingerprint(config: str, seed: int):
    """(scene, walk states, pushes) digests of one configuration and
    seed under the walk mix, and the walk's states."""
    bench = Benchmark(REPO)
    cfg, traffic = bench.config(config), bench.traffic("walk")
    data = sc.build_scene(cfg["scene"], traffic["character"], seed)
    walk = wk.Walk(traffic, data, seed)
    states = [walk.frame(f) for f in range(FRAMES)]
    log = []
    prog = stand_in(data, log)
    for st in states:
        program.push(prog, st, traffic["camera"])
    fields = [[getattr(st, k) for k in STATE_FIELDS] for st in states]
    return (digest(data), digest(fields), digest(log)), states, data


CONFIGS = ("castle-480p-fsr", "castle-4k-dlss", "castle-large-gi")
CASES = [(c, s) for c in CONFIGS for s in SEEDS]


@pytest.mark.parametrize("config,seed", CASES)
def test_accepted_inputs_unchanged(config, seed):
    got, states, data = fingerprint(config, seed)
    assert got == DIGESTS[(config, seed)]


@pytest.mark.parametrize("config", CONFIGS)
def test_accepted_buckets_and_lights_unchanged(config):
    """The Device's buckets are those the harness made before it grew
    them for instances and lights too, and the walk's frames carry the
    scene's lights, never re-sent."""
    from rt64tpu_torch.limits import SceneLimits

    _, states, data = fingerprint(config, 0)
    cfg = Benchmark(REPO).config(config)
    verts = sum(data.meshes[i.mesh].positions.shape[0] for i in data.instances)
    before = SceneLimits(
        max_vertices=1 << 15, max_triangles=int(cfg["scene"]["max_triangles"]),
        max_instances=128, max_textures=16, texel_pool=1 << 18,
        alpha_triangles=256,
    ).grown_for(vertices=verts, triangles=data.triangles())
    got = program.scene_limits(data, cfg)
    assert got == before
    assert (got.max_instances, got.max_lights) == (128, 2)
    assert all(st.lights is data.lights and not st.resend_lights
               for st in states)
