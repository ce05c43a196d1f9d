"""Scenes and rays for the alpha sweep's tests: the plain twin's contract
(tests/test_torch_alpha_sweep.py), the kernel against the twin on the
card (tests/test_torch_cuda.py) and the port against the JAX package
(tests/test_torch_tracer.py). It imports numpy, torch and rt64tpu_torch
only, so the card-only tests can use it on a machine without JAX. The
tests import it by its own name (pytest puts tests/ on the path): a
package named `tests` installed elsewhere would shadow `tests.<name>`."""

import numpy as np
import torch

from rt64tpu_torch.ops import tracer as ptr

A_CAP = 700  # three 256-entry chunks (and kernel tiles), the last partial
STACK = 20  # copies of one triangle across the list: equal keys
STACK_Z = 50.0  # the copies' plane
STACK_T = 30.0  # where a stack ray meets the copies
STACK_BIAS = 0.25


def sweep_arrays(seed, t=1024):
    """Random triangles near the origin, and STACK double-sided copies of
    one triangle in the plane z = STACK_Z, spread over an A_CAP-entry
    alpha list; about one entry in twenty is padding (-1). Returns the
    numpy arrays (v0, v1, v2, no_cull, bias, alpha_idx) and the stack's
    ids in list order."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-10, 10, (3, t)).astype(np.float32)
    v1 = v0 + rng.uniform(-3, 3, (3, t)).astype(np.float32)
    v2 = v0 + rng.uniform(-3, 3, (3, t)).astype(np.float32)
    bias = np.where(rng.uniform(size=t) < 0.3, rng.uniform(0, 2, t),
                    0.0).astype(np.float32)
    no_cull = rng.uniform(size=t) < 0.5
    stack = rng.choice(t, STACK, replace=False)
    for v, corner in ((v0, (-1, -1)), (v1, (1, -1)), (v2, (0, 1))):
        v[:, stack] = np.array([[corner[0]], [corner[1]], [STACK_Z]],
                               np.float32)
    bias[stack] = STACK_BIAS
    no_cull[stack] = True
    others = rng.permutation(np.setdiff1d(np.arange(t), stack))[:A_CAP - STACK]
    alpha_idx = rng.permutation(np.concatenate([stack, others]))
    alpha_idx[(rng.uniform(size=A_CAP) < 0.05)
              & ~np.isin(alpha_idx, stack)] = -1
    return ((v0, v1, v2, no_cull, bias, alpha_idx),
            alpha_idx[np.isin(alpha_idx, stack)])


def trace_scene(v0, v1, v2, no_cull, bias, alpha_idx, alpha=None):
    """A port TraceScene of numpy arrays (every triangle valid; alpha
    class everywhere unless `alpha` is given)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    n_tri = v0.shape[1]
    return ptr.TraceScene(
        v0=t(v0), v1=t(v1), v2=t(v2),
        valid=torch.ones(n_tri, dtype=torch.bool),
        alpha=torch.ones(n_tri, dtype=torch.bool) if alpha is None
        else t(alpha),
        no_cull=t(no_cull), bias=t(bias), alpha_idx=t(alpha_idx),
        has_alpha=True)


def sweep_scene(seed):
    """sweep_arrays as a port TraceScene: (scene, the stack's ids in list
    order as a tensor)."""
    arrays, stack_ids = sweep_arrays(seed)
    return trace_scene(*arrays), torch.from_numpy(stack_ids)


def sweep_rays(kind, n=512, seed=0, dead=0.0):
    """Numpy rays (origins, dirs, t_min, t_max). "stack": rays that cross
    every copy of the stack at t = STACK_T and nothing else; "random":
    random rays through the scene, a fifth of them stack rays; "away":
    rays that hit nothing; "mixed": random rays, stack rays and rays
    away, a quarter, a quarter and a half random. A `dead` share of the
    rays get an empty interval (t_max < t_min: the compaction's pad
    lanes)."""
    rng = np.random.default_rng(100 + seed)
    o = rng.uniform(-15, 15, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    if kind == "mixed":
        pick = rng.integers(0, 4, n)  # 0, 1 random, 2 the stack, 3 away
        stack, away = pick == 2, pick == 3
    else:
        stack = (rng.uniform(size=n) < 0.2 if kind == "random"
                 else np.full(n, kind == "stack"))
        away = np.full(n, kind == "away")
    o[:2, stack] = rng.uniform(-0.3, 0.3, (2, stack.sum()))
    o[2, stack] = STACK_Z - STACK_T
    d[:, stack] = np.array([[0.0], [0.0], [1.0]], np.float32)
    o[:, away] = np.array([[100.0], [100.0], [100.0]], np.float32)
    d[:, away] = np.array([[1.0], [0.0], [0.0]], np.float32)
    t_min = np.zeros(n, np.float32)
    t_max = np.full(n, 1e5, np.float32)
    gone = rng.uniform(size=n) < dead
    t_max[gone] = t_min[gone] - 1.0
    return o, d, t_min, t_max


def sweep_rays_torch(*args, **kw):
    return [torch.from_numpy(a) for a in sweep_rays(*args, **kw)]


def bits(a):
    """A float32 tensor's bits (so -0.0 and 0.0, or two NaNs, differ);
    any other tensor as it is."""
    return a.view(torch.int32) if a.dtype == torch.float32 else a
