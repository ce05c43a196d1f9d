"""The seeded scene and the walk: the same seed gives the same inputs,
another seed other ones, and every seed the same amount of work."""

import numpy as np
import pytest

from portbench import scene as sc, walk as wk
from portbench.harness import Benchmark
from portbench.tests.conftest import REPO

SEEDS = (7, 2**31 + 11)


@pytest.fixture(scope="module")
def traffic():
    return Benchmark(REPO).traffic("walk")


def _frames(traffic, seed, n=3):
    cfg = Benchmark(REPO).config("castle-480p-fsr")
    data = sc.build_scene(cfg["scene"], traffic["character"], seed)
    w = wk.Walk(traffic, data, seed)
    return data, [w.frame(f) for f in range(n)]


def _flat(data, frames):
    parts = [m.positions for m in data.meshes.values()]
    parts += [t.astype(np.float32) for t in data.textures.values()]
    for st in frames:
        parts += [st.view_matrix, st.character.positions, *st.transforms]
    return np.concatenate([np.ravel(p).astype(np.float64) for p in parts])


def test_same_seed_same_inputs(traffic):
    a, b = _flat(*_frames(traffic, SEEDS[0])), _flat(*_frames(traffic, SEEDS[0]))
    assert np.array_equal(a, b)


def test_seeds_differ(traffic):
    a, b = _flat(*_frames(traffic, SEEDS[0])), _flat(*_frames(traffic, SEEDS[1]))
    assert a.shape == b.shape and not np.array_equal(a, b)


def test_every_seed_the_same_work(traffic):
    for seed in SEEDS:
        data, frames = _frames(traffic, seed)
        assert data.triangles() == 2 * 47 ** 2 + 72 + 2 + 4 * 48 + 768
        assert len(data.foliage) == 48
        moved = [i for i in range(len(data.instances))
                 if not np.array_equal(frames[1].transforms[i],
                                       data.instances[i].transform)]
        assert len(moved) == traffic["foliage"]["moving"] + 1  # + character


def test_walk_pushes_a_moving_frame(traffic):
    data, (f0, f1, f2) = _frames(traffic, SEEDS[1])
    assert np.array_equal(f1.previous[0], f0.transforms[0])
    assert all(np.array_equal(p, t) for p, t in zip(f2.previous, f1.transforms))
    assert not np.array_equal(f1.view_matrix, f2.view_matrix)
    assert not np.array_equal(f1.character.positions, f2.character.positions)
    assert f1.character.indices.shape == (768, 3)
