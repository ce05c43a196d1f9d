"""Scenes and rays for the alpha path's tests: the sweep's plain twin's
contract (tests/test_torch_alpha_sweep.py), the sweep's and the cull's
kernels against their twins on the card (tests/test_torch_cuda.py), the
cull's twin against the per-ray test (tests/test_torch_launch_stats.py)
and the port against the JAX package (tests/test_torch_tracer.py). It
imports numpy, torch, rt64tpu_torch and portbench's scene only, so the
card-only tests can use it on a machine without JAX. The tests import it
by its own name (pytest puts tests/ on the path): a package named `tests`
installed elsewhere would shadow `tests.<name>`."""

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


def castle_sweep(n, coherent=False):
    """The benchmark's castle (portbench/scene.py, the 4K cell's
    configuration) in world space, with the alpha list the frame builds
    from it (compact_alpha at the frame's 256 entries, spatially sorted);
    camera rays from the walk's orbit aimed at the billboards, and shadow
    rays from the billboards towards the first light. coherent: the rays
    come in bundles of 8 lanes that share an eye (a shadow ray's light)
    and aim within 0.05 of one another, as a frame's adjacent pixels do,
    and half the bundles aim at the ground anywhere in the walk's view."""
    import json
    import os

    from portbench import scene as sc

    bench = os.path.join(os.path.dirname(__file__), os.pardir, "portbench")
    with open(os.path.join(bench, "configs", "castle-4k-dlss.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(bench, "traffic", "walk.json")) as f:
        walk = json.load(f)
    data = sc.build_scene(cfg["scene"], walk["character"], seed=2987654321)
    corners, alpha, no_cull = [], [], []
    for inst in data.instances:
        m = data.meshes[inst.mesh]
        world = np.c_[m.positions, np.ones(len(m.positions))] @ inst.transform
        corners.append(world[m.indices][..., :3].astype(np.float32))
        alpha += [inst.shader == "leaf"] * len(m.indices)
        no_cull += [inst.no_cull] * len(m.indices)
    tris = np.concatenate(corners)  # (T, 3 corners, 3)
    v0, v1, v2 = (tris[:, c].T for c in range(3))
    alpha = np.array(alpha)
    t = alpha.shape[0]
    scene = trace_scene(v0, v1, v2, np.array(no_cull),
                        np.zeros(t, np.float32), np.zeros(0, np.int64), alpha)
    scene = scene._replace(alpha_idx=ptr.sort_alpha_spatial(
        ptr.compact_alpha(scene.valid, scene.alpha, 256), scene.v0, scene.v1,
        scene.v2))
    rng = np.random.default_rng(3)
    m = n // 8 if coherent else n
    leaves = np.array([data.instances[i].transform[3, :3] for i in data.foliage])
    aim = leaves[rng.integers(0, len(leaves), m)] + rng.uniform(
        -1.2, 1.2, (m, 3)) + [0.0, 0.8, 0.0]
    orbit = walk["orbit"]
    yaw = rng.uniform(0, 2 * np.pi, m)
    eye = np.stack([orbit["center"][0] + orbit["radius"] * np.sin(yaw),
                    np.full(m, orbit["eye_height"]),
                    orbit["center"][2] + orbit["radius"] * np.cos(yaw)], 1)
    shadow = rng.uniform(size=m) < 0.3
    if coherent:
        ground = rng.uniform(size=m) < 0.5
        g = int(ground.sum())
        aim[ground] = np.stack([rng.uniform(-60, 60, g), rng.uniform(0, 3, g),
                                rng.uniform(-50, 60, g)], 1)
        aim, eye, shadow = (np.repeat(a, 8, axis=0) for a in (aim, eye, shadow))
        aim = aim + rng.uniform(-0.05, 0.05, (n, 3))
    light = np.array(data.lights[0]["position"])
    o = np.where(shadow[:, None], aim, eye)
    d = np.where(shadow[:, None], light - aim, aim - eye)
    t_min = np.where(shadow, 1e-3, 0.1)
    t_max = np.where(shadow, 1.0, 1e5)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return scene, [f(o.T), f(d.T), f(t_min), f(t_max)]


# The alpha cull's cases (cull_case): the castle frame's boxes (192
# billboard triangles and 64 inverted pad boxes) under camera and shadow
# rays; the same with live and dead lanes mixed in bundles and whole
# bundles dead; direction components at and around 0 and +-1e-12; t_max
# clamped at an opaque hit; non-finite origins and directions on live
# lanes; and an alpha list past 512 entries (4-triangle chunk boxes).
CULL_CASES = ("castle", "dead_lanes", "zero_dirs", "clamped", "nan_inf",
              "chunked")


def cull_boxes(scene):
    """The cull's boxes as trace_alpha_to_compact builds them: one a
    triangle for an alpha list of up to 512 entries, one per 4 above."""
    a_cap = scene.alpha_idx.shape[0]
    return ptr._alpha_chunk_aabbs(scene, ch=1 if a_cap <= 512 else 4)


def cull_case(name, n=8192):
    """The alpha cull's inputs for case `name` of CULL_CASES: CPU tensors
    (origins, dirs, t_min, t_max, lo, hi), n lanes (a multiple of 8)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "chunked":
        scene, _ = sweep_scene(17)
        o, d, t_min, t_max = sweep_rays_torch("mixed", n, seed=17, dead=0.25)
        return [o, d, t_min, t_max, *cull_boxes(scene)]
    scene, (o, d, t_min, t_max) = castle_sweep(n, coherent=True)
    lanes = lambda share: torch.from_numpy(rng.uniform(size=n) < share)
    if name == "dead_lanes":
        dead = lanes(0.5)
        dead.view(-1, 8)[::4] = True  # every fourth bundle has no live lane
        t_max = torch.where(dead, t_min - 1.0, t_max)
    elif name == "zero_dirs":
        tiny = np.float32(1e-12)
        values = np.array([0.0, -0.0, tiny, -tiny, np.nextafter(tiny, 1),
                           np.nextafter(-tiny, -1), np.nextafter(tiny, 0),
                           np.nextafter(-tiny, 0), 1e-30], np.float32)
        pick = lanes(0.4)
        axis = torch.from_numpy(rng.integers(0, 3, n))[pick]
        d[axis, torch.nonzero(pick)[:, 0]] = torch.from_numpy(
            rng.choice(values, int(pick.sum())))
    elif name == "clamped":
        # As trace_alpha_to_compact clamps the cull's t_max at the opaque
        # hit: some intervals shrink, some empty.
        t_opb = torch.where(lanes(0.5), 1e5, torch.from_numpy(
            rng.uniform(0.01, 40.0, n).astype(np.float32)))
        bias_max = torch.where(scene.alpha & scene.valid, scene.bias,
                               0.0).amax()
        t_max = torch.minimum(t_max, t_opb + bias_max)
    elif name == "nan_inf":
        for k, (plane, c, v) in enumerate(
                [(o, 0, np.nan), (o, 1, np.inf), (d, 2, np.nan), (d, 0, np.inf),
                 (d, 1, -np.inf), (o, 2, -np.inf)]):
            plane[c, k::97] = v
    return [o, d, t_min, t_max, *cull_boxes(scene)]
