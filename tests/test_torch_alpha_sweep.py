"""The contract of the alpha sweep's plain twin (tracer._alpha_sweep_plain),
which the card's kernel (tracer_cuda.alpha_sweep, csrc/alpha_sweep.cu) is
held to bit for bit in tests/test_torch_cuda.py: among equal keys the
later alpha-list position comes first; the result does not depend on the
chunk the twin sweeps in; misses read _BIG, -1 and 0; rays with an empty
interval (the compaction's pad lanes) sweep nothing."""

import pytest
import torch

from rt64tpu_torch.ops import tracer as ptr
from rt64tpu_torch.ops import tracer_cuda as tc
from alpha_sweep_cases import (A_CAP, STACK_BIAS, STACK_T, bits,
                               sweep_rays_torch, sweep_scene)


def _equal(got, want):
    return all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))


def _ties(k):
    scene, stack_ids = sweep_scene(0)
    rays = sweep_rays_torch("stack", n=16)
    later_first = stack_ids.flip(0)[:k]
    for chunk in (1, 100, 256, A_CAP):
        t, tri, uv, bias = ptr._alpha_sweep_plain(*rays, scene, k, True, chunk)
        assert torch.equal(tri, later_first.expand(16, k)), chunk
        assert torch.equal(t, torch.full_like(t, t[0, 0].item()))
        assert abs(t[0, 0].item() - (STACK_T - STACK_BIAS)) < 1e-4
        assert torch.equal(bias, torch.full_like(bias, STACK_BIAS))


def _chunks(k):
    """Random rays, every outcome of a row: no hit, fewer hits than k,
    more (the stack rays); the chunk moves no bit."""
    scene, _ = sweep_scene(1)
    for cull in (True, False):
        rays = sweep_rays_torch("random", n=256, seed=k)
        want = ptr._alpha_sweep_plain(*rays, scene, k, cull, A_CAP)
        hits = (want[1] >= 0).sum(dim=1)
        assert (hits == 0).any() and (hits == k).any()
        assert ((hits > 0) & (hits < k)).any() or k == 1
        for chunk in (10, 100, 256):
            got = ptr._alpha_sweep_plain(*rays, scene, k, cull, chunk)
            assert _equal(got, want), (cull, chunk)


def _misses(k):
    scene, _ = sweep_scene(2)
    t, tri, uv, bias = ptr._alpha_sweep_plain(*sweep_rays_torch("away"),
                                              scene, k, False)
    assert t.dtype == torch.float32 and tri.dtype == torch.int64
    assert _equal((t, tri, uv, bias),
                  (torch.full_like(t, ptr._BIG), torch.full_like(tri, -1),
                   torch.zeros_like(uv), torch.zeros_like(bias)))


def _empty_intervals(k):
    """The compaction's pad lanes (t_max = t_min - 1) sweep nothing, among
    live rays that hit."""
    scene, _ = sweep_scene(3)
    o, d, t_min, t_max = sweep_rays_torch("stack")
    dead = torch.arange(t_max.shape[0]) % 3 == 0
    t_max = torch.where(dead, t_min - 1.0, t_max)
    t, tri, uv, bias = ptr._alpha_sweep_plain(o, d, t_min, t_max, scene, k,
                                              True)
    assert (tri[~dead] >= 0).all()
    assert (tri[dead] == -1).all() and (t[dead] == ptr._BIG).all()
    assert not (uv[dead].any() or bias[dead].any())


def _dispatch(k):
    """CPU tensors take the twin: no launch."""
    scene, _ = sweep_scene(4)
    rays = sweep_rays_torch("random")
    before = dict(vars(tc.launch_counts))
    got = ptr._alpha_sweep(*rays, scene, k, True)
    assert vars(tc.launch_counts) == before
    assert _equal(got, ptr._alpha_sweep_plain(*rays, scene, k, True))


def _launch_needs_card(k):
    """The kernel's wrapper launches or raises: it takes no CPU tensor."""
    scene, _ = sweep_scene(5)
    with pytest.raises(ValueError, match="CUDA"):
        tc.alpha_sweep(*sweep_rays_torch("random"), scene, k, True)


CONTRACT = {"ties": _ties, "chunks": _chunks, "misses": _misses,
            "empty_intervals": _empty_intervals, "dispatch": _dispatch,
            "launch_needs_card": _launch_needs_card}


@pytest.mark.parametrize("case,k", [
    ("ties", 1), ("ties", 4), ("ties", 16),
    ("chunks", 1), ("chunks", 2), ("chunks", 4), ("chunks", 16),
    ("misses", 2), ("empty_intervals", 4), ("dispatch", 4),
    ("launch_needs_card", 4),
])
def test_alpha_sweep_twin_contract(case, k):
    CONTRACT[case](k)
