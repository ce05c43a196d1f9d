"""The port's reference tracer (ops/tracer.py) against the JAX one on the
random scenes of tests/test_tracer_pallas.py. Both are Moller-Trumbore
in f32, so triangle ids and alpha slots must be equal and t/uv agree to
float rounding (rtol 1e-5).

And host-side guards of the kernel wrappers (ops/tracer_cuda.py): the
launch counts from 8 threads at once lose nothing, kernel_library() is
built once by 4 threads that ask at once, and a launch whose inputs are
on two devices is refused before it reaches the card."""

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from rt64tpu.ops import tracer as jtr
from rt64tpu_torch.ops import tracer as ptr
from rt64tpu_torch.ops import tracer_cuda as tc
import alpha_sweep_cases as sweep

TOL = dict(rtol=1e-5, atol=1e-5)


def _scene_np(seed, t_total=256):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-10, 10, (3, t_total)).astype(np.float32)
    v1 = v0 + rng.uniform(-3, 3, (3, t_total)).astype(np.float32)
    v2 = v0 + rng.uniform(-3, 3, (3, t_total)).astype(np.float32)
    valid = rng.uniform(size=t_total) > 0.05
    # More alpha geometry than the packet tests, so the K slots fill.
    alpha = (rng.uniform(size=t_total) < 0.3) & valid
    no_cull = rng.uniform(size=t_total) < 0.5
    bias = np.where(rng.uniform(size=t_total) < 0.2,
                    rng.uniform(0, 2, t_total), 0.0).astype(np.float32)
    n = 1024
    rays = (rng.uniform(-15, 15, (3, n)).astype(np.float32),
            rng.normal(size=(3, n)).astype(np.float32),
            np.zeros(n, np.float32), np.full(n, 1e5, np.float32))
    noise = rng.uniform(size=n).astype(np.float32)
    return dict(v0=v0, v1=v1, v2=v2, valid=valid, alpha=alpha,
                no_cull=no_cull, bias=bias), rays, noise


def _scenes(s, cap=64):
    js = {k: jnp.asarray(v) for k, v in s.items()}
    ps = {k: torch.from_numpy(v) for k, v in s.items()}
    jidx = jtr.sort_alpha_spatial(
        jtr.compact_alpha(js["valid"], js["alpha"], cap), js["v0"], js["v1"], js["v2"])
    pidx = ptr.sort_alpha_spatial(
        ptr.compact_alpha(ps["valid"], ps["alpha"], cap), ps["v0"], ps["v1"], ps["v2"])
    return (jtr.TraceScene(**js, alpha_idx=jidx, has_alpha=True),
            ptr.TraceScene(**ps, alpha_idx=pidx, has_alpha=True))


def _both(rays):
    return [jnp.asarray(a) for a in rays], [torch.from_numpy(a) for a in rays]


def _eq(j, p):
    np.testing.assert_array_equal(np.asarray(j), p.numpy())


def _close(j, p):
    np.testing.assert_allclose(np.asarray(j), p.numpy(), **TOL)


@pytest.mark.parametrize("cap", [64, 512])
def test_alpha_list_compaction_and_spatial_sort(cap):
    s, _, _ = _scene_np(0)
    js, ps = _scenes(s, cap)
    _eq(js.alpha_idx, ps.alpha_idx)
    assert (ps.alpha_idx >= 0).sum() > 10


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_trace_opaque_matches(seed, cull):
    s, rays, _ = _scene_np(seed)
    js, ps = _scenes(s)
    jr, pr = _both(rays)
    t_j, tri_j, uv_j = jtr.trace_opaque(*jr, js, cull_backface=cull, chunk=128)
    t_p, tri_p, uv_p = ptr.trace_opaque(*pr, ps, cull_backface=cull, chunk=128)
    _eq(tri_j, tri_p)
    hit = np.asarray(tri_j) >= 0
    np.testing.assert_allclose(np.asarray(t_j)[hit], t_p.numpy()[hit], **TOL)
    np.testing.assert_allclose(np.asarray(uv_j), uv_p.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_trace_opaque_only_matches(seed):
    s, rays, _ = _scene_np(seed)
    js, ps = _scenes(s)
    jr, pr = _both(rays)
    j = jtr.trace_opaque_only(*jr, js, chunk=128)
    p = ptr.trace_opaque_only(*pr, ps, chunk=128)
    _eq(j[1], p[1])
    for a, b in ((j[0], p[0]), (j[3], p[3])):
        _close(a, b)


@pytest.mark.parametrize("compact", [0, 400])
def test_trace_with_alpha_slots_matches(compact):
    s, rays, _ = _scene_np(2)
    js, ps = _scenes(s, cap=128)
    jr, pr = _both(rays)
    j = jtr.trace(*jr, js, k_alpha=4, chunk=128, alpha_compact=compact)
    p = ptr.trace(*pr, ps, k_alpha=4, chunk=128, alpha_compact=compact)
    _eq(j.tri_op, p.tri_op)
    _eq(j.tri_a, p.tri_a)
    assert (p.tri_a >= 0).sum() > 20
    _close(j.t_op, p.t_op)
    _close(j.t_a, p.t_a)
    np.testing.assert_allclose(np.asarray(j.uv_a), p.uv_a.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert int(j.alpha_dropped) == int(p.alpha_dropped)


@pytest.mark.parametrize("cap", [300, 1024])
@pytest.mark.parametrize("cull", [True, False])
def test_trace_alpha_to_compact_matches(cull, cap):
    s, rays, noise = _scene_np(3)
    js, ps = _scenes(s)
    jr, pr = _both(rays)
    t_opb_j = jtr.trace_opaque(*jr, js, cull_backface=cull, chunk=128)[0]
    t_opb_p = ptr.trace_opaque(*pr, ps, cull_backface=cull, chunk=128)[0]
    j = jtr.trace_alpha_to_compact(*jr, js, 4, cull, cap, jnp.asarray(noise),
                                   t_opaque_biased=t_opb_j)
    p = ptr.trace_alpha_to_compact(*pr, ps, 4, cull, cap, torch.from_numpy(noise),
                                   t_opaque_biased=t_opb_p)
    _eq(j.mask, p.mask)
    _eq(j.idx, p.idx)
    _eq(j.tri, p.tri)
    assert (p.tri >= 0).sum() > 10
    _close(j.t, p.t)
    _close(j.noise, p.noise)
    _close(j.origins, p.origins)
    np.testing.assert_allclose(np.asarray(j.uv), p.uv.numpy(), rtol=1e-4, atol=1e-4)
    assert int(j.dropped) == int(p.dropped)


def _jax_tie_order(stack_ids, chunk, k):
    """The order the JAX package's sweep gives STACK equal keys: each
    chunk's extraction takes the later list position first, and its
    merge (carry, then the chunk's hits, largest column first) reverses
    both lists at every merge."""
    carry = []
    for c in range(0, sweep.A_CAP, chunk):
        ext = [i for p, i in stack_ids if c <= p < c + chunk][::-1][:k]
        carry = ext if c == 0 else (carry + ext)[::-1][:k]
    return carry


@pytest.mark.parametrize("k", [4, 16])
def test_alpha_sweep_ties_across_chunks(k):
    """The port's sweep against the JAX package's on a 700-entry alpha
    list (three 256-entry chunks) that holds 20 copies of one triangle:
    rays with distinct keys agree (ids exactly, t / uv / bias to
    rounding); on the rays through the copies, whose keys are equal, the
    port puts the later list position first whatever the chunk (the card
    kernel's insertion order), the JAX package the order its chunk merge
    gives. That order is the one documented difference."""
    (v0, v1, v2, no_cull, bias, alpha_idx), stack = sweep.sweep_arrays(7)
    arrays = dict(v0=v0, v1=v1, v2=v2, valid=np.ones(v0.shape[1], bool),
                  alpha=np.ones(v0.shape[1], bool), no_cull=no_cull, bias=bias)
    js = jtr.TraceScene(**{k_: jnp.asarray(v) for k_, v in arrays.items()},
                        alpha_idx=jnp.asarray(alpha_idx, jnp.int32),
                        has_alpha=True)
    ps = sweep.trace_scene(v0, v1, v2, no_cull, bias, alpha_idx)
    rays = sweep.sweep_rays("random", n=512, seed=7)
    jr, pr = _both(rays)
    j = jtr._alpha_sweep(*jr, js, k, True)
    p = ptr._alpha_sweep(*pr, ps, k, True)
    tied = np.isin(p[1].numpy(), stack).any(axis=1)
    assert 20 < tied.sum() < len(tied) - 100
    for a, b in zip(j, p):
        np.testing.assert_allclose(np.asarray(a)[~tied], b.numpy()[~tied],
                                   **TOL)
    _eq(np.asarray(j[1])[~tied], p[1][~tied])
    positions = [(int(np.flatnonzero(alpha_idx == i)[0]), int(i))
                 for i in stack]
    port_order = stack[::-1][:k]
    jax_order = _jax_tie_order(positions, 256, k)
    assert list(port_order) != jax_order
    _eq(np.broadcast_to(np.asarray(jax_order), (tied.sum(), k)),
        torch.from_numpy(np.asarray(j[1])[tied]))
    _eq(np.broadcast_to(port_order, (tied.sum(), k)), p[1][tied])
    for a, b in ((j[0], p[0]), (j[3], p[3])):
        _close(np.asarray(a)[tied], b[tied])


# ---------------------------------------------------------------------------
# the kernel wrappers' host-side guards
# ---------------------------------------------------------------------------


def test_launch_counts_under_threads():
    counts = tc.LaunchCounts()

    def bump():
        for _ in range(10_000):
            counts.add("opaque_launches")
        counts.add("shadow_mt_launches")

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(8) as pool:
            for bumped in [pool.submit(bump) for _ in range(8)]:
                bumped.result(timeout=60)
    finally:
        sys.setswitchinterval(before)
    assert counts.opaque_launches == 8 * 10_000
    assert counts.shadow_mt_launches == 8
    assert counts.shadow_launches == counts.opaque_mt_launches == 0
    assert set(vars(counts)) == set(tc.LaunchCounts.NAMES)


def test_kernel_library_built_once_across_threads(monkeypatch):
    builds = []

    def build():
        builds.append(threading.get_ident())
        time.sleep(0.2)  # a slow build: the others arrive meanwhile
        return object()

    monkeypatch.setattr(tc, "_build_library", build)
    monkeypatch.setattr(tc, "_library", None)
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(4) as pool:
            calls = [pool.submit(tc.kernel_library) for _ in range(4)]
            got = [c.result(timeout=60) for c in calls]
    finally:
        sys.setswitchinterval(before)
    assert len(builds) == 1
    assert len(got) == 4 and all(g is got[0] for g in got)


def test_launch_inputs_on_two_devices_raise():
    rays8 = torch.zeros(8, 512)
    p = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="visits on meta, rays8 on cpu"):
        tc.trace_opaque_blocks(rays8, torch.zeros(2, tc.C_ROWS, tc.K_CS),
                               torch.zeros(1, 1, dtype=torch.int32,
                                           device="meta"), p,
                               torch.zeros(1, 1), True)
