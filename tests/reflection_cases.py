"""Shared cases of the reflection bounces' tests (CPU:
tests/test_torch_reflection_compact.py; card: tests/test_torch_cuda.py).
Imports torch and rt64tpu_torch only.

capture_bounces draws a view and keeps the arguments its last
render_frame gave framegraph.reflection_bounces; full_width_bounces runs
the same bounces as the frame graph did before it traced the live mirror
rays alone: reflection_pass over every lane of the frame, once a bounce.

Run as a script it prints, as one JSON line, whether reflection_bounces
and full_width_bounces agree bit for bit on each case of CASES (on the
CPU; the CPU test runs it with ATen's scalar kernels)."""

import dataclasses
import json

import torch

import numpy as np

from rt64tpu_torch.ops import math3d
from rt64tpu_torch.ops import tracer
from rt64tpu_torch.pipeline import framegraph as fg
from rt64tpu_torch.pipeline import rows as R
from rt64tpu_torch.utils import profiling
from rt64tpu_torch.utils.castle_scene import build_castle_scene
from rt64tpu_torch.utils.testscenes import build_sample_scene


def make_floor_mirror(scene, factor=0.6):
    """Make the floor of a sample scene (its instance 1) a mirror, which
    faces the mirrored sphere: the second bounce then has live rays.
    Works on either package's scene objects."""
    scene.instances[1].desc.material.reflection_factor = factor


def look_down(device, scene, view):
    """Point a sample scene's camera down at its floor and sphere, which
    then fill the frame: with the floor a mirror, every lane seeds a
    reflection. Takes and returns a builder's (device, scene, view), of
    either package."""
    vm = math3d.look_at_rh((0.0, 6.0, 2.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    view.set_perspective(vm, 45.0 * np.pi / 180.0, 0.1, 1000.0)
    return device, scene, view


def castle_view(device, width=128, height=64):
    """The castle with two reflection bounces (the moat mirrors what
    mirrors nothing, so the second bounce has no live ray)."""
    dev, _, view = build_castle_scene(width, height, gi_samples=0,
                                      device=device)
    view.max_reflections = 2
    return dev, view


def mirror_view(device, width=64, height=32):
    """The sample scene, GI on, with its floor a mirror facing the
    sphere."""
    dev, scene, view = build_sample_scene(width, height, gi_samples=1,
                                          device=device)
    make_floor_mirror(scene)
    view.max_reflections = 2
    return dev, view


def mirror_down_view(device, width=64, height=32):
    """mirror_view looking down (look_down): every cull bundle holds a
    live mirror ray at the first bounce, so it runs at full width, and
    the second bounce narrows to the floor's rays that meet the sphere
    and the sphere's that meet the floor."""
    dev, scene, view = look_down(*build_sample_scene(
        width, height, gi_samples=1, device=device))
    make_floor_mirror(scene)
    view.max_reflections = 2
    return dev, view


def capture_bounces(dev, view, alpha_boost=16):
    """Draw `dev` once at the top of the alpha boost ladder (one frame
    program); the arguments of its last reflection_bounces call."""
    view.update()
    view._renderer._alpha_boost = alpha_boost
    got = []
    real = fg.reflection_bounces

    def spy(*args):
        got.append(args)
        return real(*args)

    fg.reflection_bounces = spy
    try:
        dev.draw()
    finally:
        fg.reflection_bounces = real
    return got[-1]


def overflow_args(args, n, seed=7):
    """reflection_bounces arguments of `n` synthetic lanes in the scene of
    `args` (a capture), at alpha boost 1: live lanes in 40 % of the
    8-lane bundles, each a mirror ray 1.5 units in front of an alpha
    triangle and aimed at it, so that more rays than the capacity
    (1,024) are alpha candidates; dead lanes hold noise."""
    sb, tri_rows, ts, cfg, gp = args[:5]
    dev = ts.v0.device
    g = torch.Generator().manual_seed(seed)
    ids = ts.alpha_idx[ts.alpha_idx >= 0].cpu()
    pick = ids[torch.randint(len(ids), (n,), generator=g)].to(dev)
    v0, v1, v2 = ts.v0[:, pick], ts.v1[:, pick], ts.v2[:, pick]
    nrm = torch.linalg.cross(v1 - v0, v2 - v0, dim=0)
    nrm = nrm / nrm.norm(dim=0, keepdim=True)
    bundle = torch.rand(-(-n // 8), generator=g) < 0.4
    live = (bundle.repeat_interleave(8)[:n]
            & (torch.rand(n, generator=g) < 0.6)).to(dev)
    noise3 = (torch.randn(3, n, generator=g) * 50).to(dev)
    pos = torch.where(live[None], (v0 + v1 + v2) / 3 + 1.5 * nrm, noise3)
    # reflect(view_dir, normal) with both the triangle's normal: the
    # mirror ray runs back along it, into the triangle.
    state = fg.ReflectionState(
        torch.zeros((3, n), device=dev), torch.where(live, 0.5, 0.0), pos,
        nrm, nrm, torch.where(live, 0, -1).to(torch.int32),
        torch.full((R.CTXROW, n), 0.3, device=dev))
    pix = torch.randint(0, 64, (n, 2), generator=g).to(dev)
    noise = torch.rand(n, generator=g).to(dev)
    table = torch.rand(n, 3, generator=g).to(dev)
    cfg1 = dataclasses.replace(cfg, alpha_shade_boost=1)
    return (sb, tri_rows, ts, cfg1, gp, state, pix, lambda f: table, noise,
            args[9], torch.zeros((), dtype=torch.int64, device=dev))


def full_width_bounces(sb, tri_rows, trace_scene, cfg, gp, state, pix, bn,
                       noise_rand, bg_planes, alpha_dropped):
    """max_reflections reflection_pass calls over every lane. Returns
    (state, alpha_dropped, [(live lanes, lanes of their bundles) at the
    start of each bounce])."""
    live = []
    n = state.instance.shape[0]
    for _ in range(cfg.max_reflections):
        active = fg._mirror_lanes(state.instance, state.alpha)
        live.append((int(active.sum()),
                     int(tracer.live_bundles(active).sum())))
        state, drop = fg.reflection_pass(sb, tri_rows, trace_scene, cfg, gp,
                                         state, pix, bn, noise_rand,
                                         bg_planes, n)
        alpha_dropped = alpha_dropped + drop
    return state, alpha_dropped, live


def counted_bounces(*args):
    """reflection_bounces(*args) and the frame record's reflection
    counters over the call."""
    profiling.reset_frame_stats()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fg.reflection_bounces(*args)
    st = profiling.frame_stats()
    profiling.reset_frame_stats()
    return out, {k: st[k] for k in profiling.REFLECTION}


def bits(x: torch.Tensor) -> torch.Tensor:
    """The bytes of x, so that equal means bit-equal (NaNs included)."""
    return x.contiguous().view(torch.uint8)


def same_state(a, b, lanes=None) -> bool:
    """Two ReflectionStates bit-equal on every field (at `lanes`, an (N,)
    bool mask, when given)."""
    if lanes is not None:
        a = fg.ReflectionState(*(x[..., lanes] for x in a))
        b = fg.ReflectionState(*(x[..., lanes] for x in b))
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def compare(args) -> dict:
    """reflection_bounces against full_width_bounces on `args`."""
    (state, dropped), counts = counted_bounces(*args)
    ref, ref_dropped, live = full_width_bounces(*args)
    return dict(same=same_state(state, ref), dropped=int(dropped),
                full_width_dropped=int(ref_dropped), live=live, **counts)


def cases(device):
    """{case: reflection_bounces arguments}: the castle's and the mirror
    scene's frames (the latter also looking down, a full-width first
    bounce), and the overflow lanes in the castle's scene on a whole
    number of bundles and on a partial last one."""
    castle = capture_bounces(*castle_view(device))
    return {"castle": castle,
            "mirrors": capture_bounces(*mirror_view(device)),
            "mirrors_down": capture_bounces(*mirror_down_view(device)),
            "overflow_8192": overflow_args(castle, 8192),
            "overflow_8190": overflow_args(castle, 8190)}


CASES = ("castle", "mirrors", "mirrors_down", "overflow_8192",
         "overflow_8190")


def main():
    torch.set_num_threads(1)
    print(json.dumps({k: compare(a) for k, a in cases("cpu").items()}))


if __name__ == "__main__":
    main()
