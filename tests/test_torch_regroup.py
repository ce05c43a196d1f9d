"""Regrouping incoherent rays into coherent packet blocks.

_regroup_order against the JAX package's for both modes with 30 % dead
rays (order and inverse exactly equal: both sorts are stable), and the
port's own parity: tracing regrouped rays gives bit-identical results
to tracing them in their given order, for the closest-hit outputs and
the occlusion flags, on the K1/K2 path and on the K3/K4 path.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rt64tpu.ops import tracer_pallas as jtp

from rt64tpu_torch.ops import tracer as ptr
from rt64tpu_torch.ops import tracer_cuda as tc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers side by side, and the torch work
    here is many tiny eager ops: one intra-op thread is the fastest. The
    worker's setting comes back when this file is done."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rays_np(rng, n, dead_frac=0.3, shadow=False):
    """Bounce-like rays: origins spread over the scene, directions all
    over the sphere (some axis-aligned, some with zero components)."""
    origins = rng.uniform(-15, 15, (3, n)).astype(np.float32)
    dirs = rng.normal(size=(3, n)).astype(np.float32)
    dirs[:, :6] = np.concatenate([np.eye(3), -np.eye(3)], axis=1)
    dirs[1, 6:12] = 0.0
    t_min = np.zeros(n, np.float32)
    t_max = (rng.uniform(1.0, 30.0, n) if shadow else np.full(n, 1e5)
             ).astype(np.float32)
    t_max[rng.uniform(size=n) < dead_frac] = -1.0
    return origins, dirs, t_min, t_max


def _scene(rng, t_total=512):
    v0 = rng.uniform(-10, 10, (3, t_total)).astype(np.float32)
    s = dict(
        v0=v0,
        v1=v0 + rng.uniform(-3, 3, (3, t_total)).astype(np.float32),
        v2=v0 + rng.uniform(-3, 3, (3, t_total)).astype(np.float32),
        valid=rng.uniform(size=t_total) > 0.05,
        alpha=rng.uniform(size=t_total) < 0.1,
        no_cull=rng.uniform(size=t_total) < 0.5,
        bias=np.where(rng.uniform(size=t_total) < 0.2,
                      rng.uniform(0, 2, t_total), 0.0).astype(np.float32),
    )
    a = {k: torch.from_numpy(v) for k, v in s.items()}
    return ptr.TraceScene(**a, alpha_idx=ptr.compact_alpha(a["valid"], a["alpha"], 64))


@pytest.mark.parametrize("mode", ["dir", "origin"])
def test_regroup_order_matches_jax(mode):
    rng = np.random.default_rng(0)
    n = 5000
    rays = _rays_np(rng, n)
    j_order, j_inv = jax.jit(lambda: jtp._regroup_order(
        *(jnp.asarray(a) for a in rays), mode))()
    p_order, p_inv = tc._regroup_order(*(torch.from_numpy(a) for a in rays), mode)
    np.testing.assert_array_equal(np.asarray(j_order), p_order.numpy())
    np.testing.assert_array_equal(np.asarray(j_inv), p_inv.numpy())
    # A permutation and its inverse; dead rays sort last.
    assert (p_order[p_inv] == torch.arange(n)).all()
    live = rays[3] >= rays[2]
    n_live = int(live.sum())
    assert 0.6 * n < n_live < 0.8 * n
    assert live[p_order.numpy()[:n_live]].all()
    assert not live[p_order.numpy()[n_live:]].any()
    # More than one cell is in use, so the order is not the identity.
    assert (p_order.numpy() != np.arange(n)).any()


def test_regroup_order_unknown_mode():
    rays = [torch.from_numpy(a) for a in _rays_np(np.random.default_rng(1), 64)]
    with pytest.raises(AssertionError):
        tc._regroup_order(*rays, "morton")


@pytest.mark.parametrize("path", ["k1k2", "k3k4"])
def test_regroup_parity(path, monkeypatch):
    """Regrouped against unregrouped, bit for bit."""
    if path == "k3k4":
        monkeypatch.setattr(tc, "RESIDENT_TABLE_BYTES", 0)
    rng = np.random.default_rng(3)
    scene = _scene(rng)
    assert tc.clusters_resident(scene.num_triangles) == (path == "k1k2")
    n = 1500  # a partial block: the wrapper pads after the permutation
    for mode in ("dir", "origin"):
        rays = [torch.from_numpy(a) for a in _rays_np(rng, n)]
        plain = tc.make_opaque_fn()(*rays, scene, cull_backface=True)
        grouped = tc.make_opaque_fn(regroup=mode)(*rays, scene,
                                                  cull_backface=True)
        for a, b, name in zip(plain, grouped, ("t", "tri", "uv", "bias")):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), (path, mode, name)
        hit = plain[1] >= 0
        assert 0.1 < hit.float().mean() < 0.75  # dead rays miss

        srays = [torch.from_numpy(a) for a in _rays_np(rng, n, shadow=True)]
        plain = tc.make_shadow_opaque_fn()(*srays, scene)
        grouped = tc.make_shadow_opaque_fn(regroup=mode)(*srays, scene)
        for a, b, name in zip(plain, grouped, ("t", "tri", "uv", "bias")):
            assert torch.equal(a, b), (path, mode, name)
        blocked = plain[1] >= 0
        assert 0.05 < blocked.float().mean() < 0.7
        dead = srays[3] < srays[2]
        assert not blocked[dead].any()


def test_regrouped_blocks_are_more_coherent():
    """What regrouping is for: bounce-like rays sorted by direction
    cell need fewer cluster visits than in their given order."""
    rng = np.random.default_rng(4)
    t_total = 4096
    v0 = rng.uniform(-10, 10, (3, t_total)).astype(np.float32)
    by_x = np.argsort(v0[0], kind="stable")  # clusters are slabs along x
    v0 = v0[:, by_x]
    a = dict(
        v0=torch.from_numpy(v0),
        v1=torch.from_numpy(v0 + rng.uniform(-0.5, 0.5, (3, t_total)).astype(np.float32)),
        v2=torch.from_numpy(v0 + rng.uniform(-0.5, 0.5, (3, t_total)).astype(np.float32)),
        valid=torch.ones(t_total, dtype=torch.bool),
        alpha=torch.zeros(t_total, dtype=torch.bool),
        no_cull=torch.ones(t_total, dtype=torch.bool),
        bias=torch.zeros(t_total),
    )
    scene = ptr.TraceScene(**a, alpha_idx=ptr.compact_alpha(a["valid"], a["alpha"], 64))
    n = 4096
    origins = torch.from_numpy(rng.uniform(-1, 1, (3, n)).astype(np.float32))
    dirs = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    t_min = torch.zeros(n)
    t_max = torch.full((n,), 6.0)
    given = tc.prepare_shadow(origins, dirs, t_min, t_max, scene)
    order, _ = tc._regroup_order(origins, dirs, t_min, t_max, "dir")
    sorted_ = tc.prepare_shadow(origins[:, order], dirs[:, order], t_min[order],
                                t_max[order], scene)
    assert int(sorted_.counts.sum()) < 0.9 * int(given.counts.sum())
