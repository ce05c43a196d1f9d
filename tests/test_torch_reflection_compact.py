"""The reflection bounces traced on their live mirror rays alone
(framegraph.reflection_bounces) against the same bounces over every lane
of the frame (reflection_pass once a bounce at full width, as the frame
graph ran them before), on the CPU.

- Two mirrors that face each other (the sample scene's sphere and its
  floor made a mirror), so that the second bounce has live rays: the
  frame held to the JAX package at test_torch_secondary.py's tolerances,
  and the bounces' counters (live rays, traced lanes, no bounce
  skipped). Looking down at them, every cull bundle holds a live ray at
  the first bounce, which runs at full width, and the second narrows:
  that frame too held to the JAX package.
- The castle: its second bounce has no live ray and is not issued; the
  lanes not live at the first bounce come back bit-identical; noise in
  the dead lanes' state changes no live lane's bit.
- A forced alpha-capacity overflow (alpha boost 1, about twice the
  capacity's candidates): the same drop count, and the same lanes
  compacted in the same order, on a whole number of 8-lane cull bundles
  and on a partial last one.
- Bit for bit against the full-width bounces on all five cases, in a
  child process on ATen's scalar CPU kernels (ATEN_CPU_CAPABILITY=
  default): the vector kernels compute pow in a tensor's SIMD body and
  in its scalar tail with different last bits, so there a lane's last
  bit depends on where in its tensor it lies. On the card every element
  takes the same code: tests/test_torch_cuda.py holds the same cases
  bit for bit there.

Measured on the CPU (torch 2.13): the castle 128x64 traces 174 live
mirror rays in its first bounce and skips its second; the mirrors 64x32
1,080 and 160 (the second bounce on fewer bundles than the first);
looking down, 2,048 of 2,048 lanes (all bundles) and 132 in 464 lanes;
the overflow lanes drop 1,036 (8,192 lanes) and 1,017 (8,190) rays of
2,060 / 2,041 live, as the full width does."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rt64tpu.utils.testscenes import build_sample_scene as jax_sample
from rt64tpu_torch.ops import tracer as ptr
from rt64tpu_torch.pipeline import framegraph as pfg
from rt64tpu_torch.utils.ssim import ssim
from rt64tpu_torch.utils.testscenes import build_sample_scene as port_sample

import reflection_cases as rc
from test_torch_secondary import _frames, _hold, _port_convert

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _active(state):
    return pfg._mirror_lanes(state.instance, state.alpha)


# ---------------------------------------------------------------------------
# two facing mirrors against the JAX package
# ---------------------------------------------------------------------------

MW, MH = 64, 32


@pytest.fixture(scope="module")
def mirror_frames():
    return _frames(
        lambda: jax_sample(width=MW, height=MH, gi_samples=1),
        lambda: port_sample(MW, MH, gi_samples=1, device="cpu"),
        rc.make_floor_mirror,
    )


def test_mirror_frame_through_convert(mirror_frames):
    j, state, _ = mirror_frames
    p = _port_convert(state)
    _hold("mirrors convert", j, p)
    seeds = j["refl_alpha"] > 0
    assert 0.2 < seeds.mean() < 0.9  # the floor and the sphere
    assert (p["refl"][:, ~seeds] == 0).all()


def test_mirror_frame_through_own_api(mirror_frames):
    _, _, (j_fb, p_fb) = mirror_frames
    s = ssim(j_fb[..., :3], p_fb[..., :3])
    print(f"mirrors own-API ssim={s}")
    assert s >= 0.99


def test_mirror_second_bounce_is_live():
    args = rc.capture_bounces(*rc.mirror_view("cpu"))
    (_, dropped), counts = rc.counted_bounces(*args)
    _, _, live = rc.full_width_bounces(*args)
    print("mirrors", live, counts)
    (live1, width1), (live2, width2) = live
    assert 0 < live2 < live1 and width2 < width1
    assert counts == {"reflection_live_rays": live1 + live2,
                      "reflection_traced_lanes": width1 + width2,
                      "reflection_bounces_skipped": 0}
    assert int(dropped) == 0


@pytest.fixture(scope="module")
def mirror_down_frames():
    return _frames(
        lambda: rc.look_down(*jax_sample(width=MW, height=MH, gi_samples=1)),
        lambda: rc.look_down(*port_sample(MW, MH, gi_samples=1,
                                          device="cpu")),
        rc.make_floor_mirror,
    )


def test_mirror_down_frame_through_convert(mirror_down_frames):
    """Every lane seeds a reflection: the first bounce runs at full width
    and the second narrows; the frame held to the JAX package."""
    j, state, _ = mirror_down_frames
    p = _port_convert(state)
    _hold("mirrors down convert", j, p)
    assert (j["refl_alpha"] > 0).all()
    assert (np.abs(p["refl"]).max(axis=0) > 0).mean() > 0.9


def test_mirror_down_first_bounce_full_width():
    args = rc.capture_bounces(*rc.mirror_down_view("cpu"))
    (out, dropped), counts = rc.counted_bounces(*args)
    _, ref_dropped, live = rc.full_width_bounces(*args)
    print("mirrors down", live, counts)
    n = args[5].instance.shape[0]
    (live1, width1), (live2, width2) = live
    assert width1 == n and 0 < live2 <= width2 < n
    assert counts == {"reflection_live_rays": live1 + live2,
                      "reflection_traced_lanes": n + width2,
                      "reflection_bounces_skipped": 0}
    assert int(dropped) == int(ref_dropped) == 0
    # The lanes the second bounce leaves out keep what the first (at
    # full width, so on the same kernels either way) wrote, bit for bit.
    first, _ = pfg.reflection_pass(*args[:10], n)
    left = ~_active(first)
    assert rc.same_state(out, first, left)
    assert (out.rgb[:, left].abs().amax(dim=0) > 0).any()


# ---------------------------------------------------------------------------
# the castle: a dead second bounce, dead lanes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def castle_args():
    return rc.capture_bounces(*rc.castle_view("cpu"))


def test_castle_skips_its_dead_bounce(castle_args):
    (out, dropped), counts = rc.counted_bounces(*castle_args)
    state = castle_args[5]
    live = _active(state)
    n = live.shape[0]
    assert 0 < int(live.sum()) < n // 10  # the moat
    assert counts == {"reflection_live_rays": int(live.sum()),
                      "reflection_traced_lanes": int(
                          ptr.live_bundles(live).sum()),
                      "reflection_bounces_skipped": 1}
    assert int(dropped) == 0
    # What no bounce traced comes back as it went in, bit for bit.
    assert rc.same_state(out, state, ~live)
    assert (out.rgb[:, live].abs().amax(dim=0) > 0).any()


def test_dead_lanes_do_not_reach_live_ones(castle_args):
    state = castle_args[5]
    live = _active(state)
    g = torch.Generator().manual_seed(3)

    def noise(x):
        return torch.where(live, x, torch.randn(x.shape, generator=g) * 100)

    scrambled = state._replace(position=noise(state.position),
                               view_dir=noise(state.view_dir),
                               normal=noise(state.normal),
                               row=noise(state.row))
    args = list(castle_args)
    out, _ = pfg.reflection_bounces(*args)
    args[5] = scrambled
    out_s, _ = pfg.reflection_bounces(*args)
    assert rc.same_state(out, out_s, live)
    assert rc.same_state(out_s, scrambled, ~live)


def test_no_bounce_issues_nothing(castle_args):
    """max_reflections 0: the state and the drop count come back as the
    same objects (no device work)."""
    args = list(castle_args)
    args[3] = dataclasses.replace(args[3], max_reflections=0)
    out, dropped = pfg.reflection_bounces(*args)
    assert out is args[5] and dropped is args[10]


def test_live_bundles():
    s = ptr._CULL_BUNDLE
    active = torch.zeros(4 * s, dtype=torch.bool)
    active[s + 3] = True
    want = torch.zeros(4 * s, dtype=torch.bool)
    want[s: 2 * s] = True
    assert torch.equal(ptr.live_bundles(active), want)
    # A partial last bundle is always kept, so the subset's width leaves
    # the same remainder as the frame's (the cull tests it lane by lane).
    got = ptr.live_bundles(active[: 4 * s - 3])
    want = want[: 4 * s - 3].clone()
    want[3 * s:] = True
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# a forced alpha-capacity overflow
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8192, 8190], ids=["whole", "partial"])
def test_alpha_overflow_drops_the_same_lanes(castle_args, monkeypatch, n):
    args = rc.overflow_args(castle_args, n)
    calls = []
    real = ptr.trace_alpha_to_compact

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append(out)
        return out

    monkeypatch.setattr(ptr, "trace_alpha_to_compact", spy)
    (_, dropped), counts = rc.counted_bounces(*args)
    compact = list(calls)
    calls.clear()
    _, full_dropped, live = rc.full_width_bounces(*args)
    full = calls[0]  # the full width's first bounce
    print(n, live, int(dropped), int(full_dropped))
    assert int(dropped) == int(full_dropped) > 0
    assert counts["reflection_bounces_skipped"] == 1 and len(compact) == 1
    assert len(calls) == 2 and int(calls[1].dropped) == 0
    # The compacted bounce's lanes: those of the live bundles, in order.
    lanes = torch.nonzero(ptr.live_bundles(_active(args[5])))[:, 0]
    c = compact[0]
    m = lanes.shape[0]
    assert c.mask.shape == (m,)
    assert torch.equal(full.mask[lanes], c.mask)
    assert int(full.mask.sum()) == int(c.mask.sum())
    assert int(c.mask.sum()) > c.idx.shape[0]  # over the capacity
    assert torch.equal(lanes[c.idx[c.idx < m]], full.idx[full.idx < n])


# ---------------------------------------------------------------------------
# bit for bit against the full width, on ATen's scalar CPU kernels
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scalar_kernel_cases():
    env = dict(os.environ, ATEN_CPU_CAPABILITY="default",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, os.path.join(HERE,
                                                       "reflection_cases.py")],
                         env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", rc.CASES)
def test_bit_equal_to_full_width(scalar_kernel_cases, case):
    got = scalar_kernel_cases[case]
    print(case, got)
    assert got["same"]
    assert got["dropped"] == got["full_width_dropped"]
    issued = [(lv, w) for lv, w in got["live"] if lv]
    assert got["reflection_live_rays"] == sum(lv for lv, _ in issued)
    assert got["reflection_traced_lanes"] == sum(w for _, w in issued)
    assert got["reflection_bounces_skipped"] == len(got["live"]) - len(issued)
    assert np.all(np.diff([lv for lv, _ in got["live"]]) <= 0)
