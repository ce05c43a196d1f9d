"""A scene lit by more lights than RT64's 16 candidates, on the CPU.

- The light loop (plan_lights -> trace_plans -> finish_lights) at 40
  lights with mixed group bits and light group masks agrees with the
  benchmark's plain reference (portbench/shading.lights: every light
  tested against the mask, the first 16 candidates in light order) on
  the same terrain points. Lights past the 16th are candidates there;
  a light loop that gave only the first 16 lights eligibility, or that
  lifted the cap on candidates, reads otherwise.
- A frame's launches do not depend on the number of lights: one draw
  at 8 lights and one at 40, with equal selection rounds, dispatch the
  same operators and count the same tracing launches; so does a light
  plan on its own. A plan's operators grow with its rounds only by the
  picks: the picked lights' fetch and disk samples are one pass.
- Shadow rays low through foliage see every leaf they cross, as the
  plain reference does, with the view's 4 alpha slots a shadow ray
  (1 slot misses the leaves behind a clear texel of the nearest).
- A 50-light scene draws through Device.draw().
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from portbench import program, scene as sc, shading
from portbench.tests.conftest import REPO, TINY_FSR
from rt64tpu_torch.ops import bluenoise as pbn
from rt64tpu_torch.ops import lighting as pli
from rt64tpu_torch.ops import shading as psh
from rt64tpu_torch.ops import tracer_cuda as tc
from rt64tpu_torch.pipeline import framegraph as pfg
from rt64tpu_torch.utils import profiling

CHARACTER = {"rings": 8, "segments": 8, "height": 2.2, "radius": 0.4}
# 38 point lights in front of the castle (40 with the castle's two), group
# bits cycled through 4, 8 and 16; the terrain takes the sun (1) and groups
# 4 and 16, the castle the sun, its glow (2) and group 8.
FIELD = {"count": 38, "region": {"x": [-30.0, 30.0], "z": [16.0, 56.0]},
         "height": [1.0, 3.0], "attenuation_radius": [20.0, 32.0],
         "point_radius": 0.3, "attenuation_exponent": 1.5,
         "colors": [[1.0, 0.6, 0.25], [1.0, 0.35, 0.1], [0.5, 0.7, 1.0]],
         "group_bits": [4, 8, 16]}
MASKS = {"terrain": 0x15, "castle": 0xB}
SCENE = dict(TINY_FSR["scene"], foliage=0, point_lights=FIELD,
             light_masks=MASKS)
TERRAIN = 0  # the terrain's index in SceneData.instances
EYE = (0.0, 7.0, 70.0)
ROUNDS = 12


def _data(count=FIELD["count"], seed=5):
    return sc.build_scene(dict(SCENE, point_lights=dict(FIELD, count=count)),
                          CHARACTER, seed)


def _cfg(max_lights=ROUNDS, **kw):
    return dict(TINY_FSR, scene=SCENE, max_lights=max_lights, **kw)


# The drawn frames' size: 32x16, no upscale.
SMALL = dict(display=[32, 16], render=[32, 16], upscaler="off")


@pytest.fixture(scope="module")
def packed():
    """The 40-light scene pushed through the public API and packed, and
    a grid of terrain points in front of the castle."""
    data = _data()
    assert len(data.lights) == 40
    prog = program.build(data, _cfg(), device="cpu")
    prog.view.update()
    xs, zs = np.meshgrid(np.linspace(-26.0, 26.0, 14),
                         np.linspace(18.0, 52.0, 10))
    pts = np.stack([xs.ravel(), sc.terrain_height(xs, zs).ravel(), zs.ravel()],
                   1)
    return data, prog, pts


def _reference(data, pts, shadows, lights=None):
    """portbench/shading.lights at the terrain points (normal up) in
    float64: (N, 3)."""
    state = type("State", (), dict(
        transforms=[i.transform for i in data.instances],
        previous=[i.transform for i in data.instances],
        character=data.meshes["character"],
        lights=data.lights if lights is None else lights))
    s = shading.Scene(data, state, "cpu", torch.float64)
    n = len(pts)
    inst = torch.full((n,), TERRAIN, dtype=torch.int64)
    hits = type("Hits", (), dict(
        pos=torch.tensor(pts, dtype=torch.float64),
        normal=torch.tensor([[0.0, 1.0, 0.0]] * n, dtype=torch.float64),
        valid=torch.ones(n, dtype=torch.bool), inst=inst, k=inst))
    ray = torch.nn.functional.normalize(
        hits.pos - torch.tensor(EYE, dtype=torch.float64))
    bn = shading.blue_noise_table(REPO, "cpu")
    return shading.lights(s, bn, _pixels(n), 0, hits, ray, ROUNDS, 1,
                          shadows=shadows), s


def _pixels(n):
    return torch.stack([torch.arange(n) * 7 % 61, torch.arange(n) * 3 % 47], 1)


def _port(prog, pts, shadows):
    """The port's light loop at the same points, with the terrain's row
    as the context: (N, 3)."""
    r = prog.renderer
    sb = r._sb
    rows, rows_t = psh.build_tri_rows(sb)
    k = r.active_instances.index(prog.instances[TERRAIN])
    tri = int(torch.nonzero((sb.tri_instance == k) & sb.tri_valid)[0])
    n = len(pts)
    tri_n = torch.full((n,), tri, dtype=torch.int32)
    valid = torch.ones(n, dtype=torch.bool)
    ctx = pli.ctx_from_rows(pfg._row_of(rows, tri_n, valid), valid)
    pos = torch.tensor(pts.T, dtype=torch.float32)
    nrm = torch.tensor([[0.0], [1.0], [0.0]]).expand(3, n).contiguous()
    dirs = torch.nn.functional.normalize(
        pos - torch.tensor(EYE, dtype=torch.float32)[:, None], dim=0)
    mat = sc.material(prog.data.instances[TERRAIN])
    spec = torch.tensor(mat.get("specular_color", (0.0, 0.0, 0.0)),
                        dtype=torch.float32)[:, None].expand(3, n).contiguous()
    bn = torch.from_numpy(pbn.packed_table())
    noise = torch.full((n,), 0.5)
    plan = pli.plan_lights(sb, _pixels(n), bn, 0, dirs, pos, nrm, spec, ctx,
                           max_light_count=ROUNDS, di_samples=1,
                           noise_rand=noise)
    if shadows:
        cfg = r._config()
        scene = pfg.make_trace_scene(sb, rows_t, cfg.alpha_cap)
        (factors,), _ = pli.trace_plans(
            [plan], sb, rows, scene, cfg.k_shadow,
            opaque_fn=tc.make_shadow_opaque_fn(), alpha_compact=1024)
    else:
        factors = torch.ones((plan.dirs.shape[1],))
    return pli.finish_lights(plan, factors).T.double()


def _candidates(data, pts, limit=shading.MAX_LIGHTS):
    """Each point's candidate lights in light order, the first `limit`."""
    pos = np.asarray(pts, np.float64)
    out = []
    mask = sc.material(data.instances[TERRAIN])["light_group_mask_bits"]
    for p in pos:
        c = [i for i, light in enumerate(data.lights)
             if mask & light["group_bits"]
             and np.linalg.norm(np.subtract(light["position"], p))
             < light["attenuation_radius"]]
        out.append(c[:limit])
    return out


@pytest.mark.parametrize("shadows", [False, True])
def test_forty_lights_match_the_reference(packed, shadows):
    data, prog, pts = packed
    want, _ = _reference(data, pts, shadows)
    got = _port(prog, pts, shadows)
    assert want.abs().max() > 0.05
    close = torch.isclose(got, want, rtol=1e-4, atol=1e-4).all(1)
    if shadows:
        # A shadow ray that grazes an edge may fall either way in float32
        # and float64: nearly every point agrees.
        assert close.float().mean() >= 0.97, close.float().mean()
    else:
        assert close.all(), (got - want).abs().max()


def test_lights_past_the_sixteenth_are_reached(packed):
    """Past the 16th light, the points' candidates take every light the
    terrain's mask takes; more than 16 lights reach many points; a slot
    cap (eligibility for lights 0-15 only) or no cap on candidates gives
    another light than the port's at most of those points."""
    data, prog, pts = packed
    cands = _candidates(data, pts)
    every = _candidates(data, pts, limit=len(data.lights))
    mask = MASKS["terrain"]
    takes = {i for i, light in enumerate(data.lights)
             if i >= 16 and mask & light["group_bits"]}
    reached = {i for c in cands for i in c if i >= 16}
    assert takes and reached == takes
    over = [len(c) > 16 for c in every]
    assert sum(over) >= 10
    got = _port(prog, pts, False)
    want, _ = _reference(data, pts, False)
    slot_cap = [dict(light, group_bits=0) if i >= 16 else light
                for i, light in enumerate(data.lights)]
    sixteen, _ = _reference(data, pts, False, lights=slot_cap)
    miss = lambda other: (~torch.isclose(got, other, rtol=1e-4, atol=1e-4)
                          .all(1)).float().mean()
    assert miss(want) == 0.0
    assert miss(sixteen) > 0.3
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(shading, "MAX_LIGHTS", len(data.lights))
        uncapped, _ = _reference(data, pts, False)
    assert miss(uncapped) > 0.05


class _Ops(TorchDispatchMode):
    """Counts the operators dispatched: a launch each on a card."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


def _frame_launches(count):
    """One draw of the tiny castle with `count` field lights and 4
    selection rounds: (operators dispatched, tracing launches)."""
    data = _data(count)
    prog = program.build(data, _cfg(max_lights=4, **SMALL), device="cpu")
    program.draw(prog)  # warm: the view and its tables exist
    profiling.reset_frame_stats()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with _Ops() as ops:
            program.draw(prog)
    st = profiling.frame_stats()
    profiling.reset_frame_stats()
    return ops.count, {k: st[k] for k in profiling.LAUNCHES}, st


def test_a_frames_launches_do_not_grow_with_the_lights():
    few_ops, few, few_st = _frame_launches(6)
    many_ops, many, many_st = _frame_launches(38)
    assert few_st["lights_pushed"] == 8 and many_st["lights_pushed"] == 40
    assert few == many and few["shadow_launches"] >= 1
    assert few_ops == many_ops
    # The shadow lanes the light plans handed to the trace: 4 rounds of
    # one sample over the render's pixels, the same at both counts.
    w, h = SMALL["render"]
    assert few_st["light_shadow_lanes"] == many_st["light_shadow_lanes"] \
        >= 4 * w * h


def _plan_ops(sb, pts, rounds):
    """Operators one light plan of `rounds` rounds dispatches over the
    terrain points, every light eligible by the terrain's mask."""
    n = len(pts)
    ctx = pli.LightingCtx(
        ignore_normal=torch.zeros(n), spec_exp=torch.ones(n),
        shadow_ray_bias=torch.zeros(n), self_light=torch.zeros(3, n),
        has_lighting=torch.ones(n, dtype=torch.bool),
        light_mask=torch.full((n,), MASKS["terrain"], dtype=torch.int32))
    pos = torch.tensor(pts.T, dtype=torch.float32)
    with _Ops() as ops:
        pli.plan_lights(sb, _pixels(n), torch.from_numpy(pbn.packed_table()),
                        0, torch.zeros(3, n), pos,
                        torch.zeros(3, n), torch.zeros(3, n), ctx,
                        max_light_count=rounds, di_samples=1,
                        noise_rand=torch.zeros(n))
    return ops.count


def test_a_light_plan_dispatches_the_same_at_any_bucket(packed):
    data, prog, pts = packed
    counts = []
    for lights in (8, 40):
        sb = prog.renderer._sb
        sb = sb._replace(lights=sb.lights[:lights],
                         light_groups=sb.light_groups[:lights])
        counts.append(_plan_ops(sb, pts, ROUNDS))
    assert counts[0] == counts[1]


def test_a_light_plan_samples_every_round_at_once(packed):
    """The picked lights' fetch and disk samples run once over all the
    rounds: a plan's operators grow with its rounds by the picks alone,
    the same few dozen a round."""
    data, prog, pts = packed
    sb = prog.renderer._sb
    one, two, twelve = (_plan_ops(sb, pts, r) for r in (1, 2, ROUNDS))
    per_round = two - one
    assert twelve - two == (ROUNDS - 2) * per_round
    assert per_round < 70, per_round


def test_shadow_rays_through_foliage_sum_every_leaf():
    """Shadow rays low through the tiny castle's 48 billboards, from near
    one billboard's foot to another's, agree with the plain reference's
    occlusion (the closest hit, a leaf texel over 0.3 occluding whole)
    with the view's alpha slots a shadow ray; with one slot a ray keeps
    only its nearest leaf, often a clear texel, and misses the leaves
    behind it."""
    scene_cfg = dict(TINY_FSR["scene"], point_lights=FIELD, light_masks=MASKS)
    data = sc.build_scene(scene_cfg, CHARACTER, 5)
    prog = program.build(data, dict(TINY_FSR, scene=scene_cfg), device="cpu")
    prog.view.update()
    r = prog.renderer
    sb = r._sb
    rows, rows_t = psh.build_tri_rows(sb)
    cfg = r._config()
    scene = pfg.make_trace_scene(sb, rows_t, cfg.alpha_cap)
    feet = np.array([data.instances[i].transform[3, :3] for i in data.foliage])
    rng = np.random.default_rng(7)
    n = 4096
    a = feet[rng.integers(0, len(feet), n)] + np.c_[
        rng.uniform(-3, 3, n), np.zeros(n), rng.uniform(-3, 3, n)]
    b = feet[rng.integers(0, len(feet), n)] + np.c_[
        rng.uniform(-1, 1, n), np.zeros(n), rng.uniform(-1, 1, n)]
    a[:, 1] = sc.terrain_height(a[:, 0], a[:, 2]) + rng.uniform(0.3, 1.0, n)
    b[:, 1] = sc.terrain_height(b[:, 0], b[:, 2]) + rng.uniform(0.5, 2.5, n)
    d = b - a
    length = np.linalg.norm(d, axis=1)
    keep = length > 2.0
    a, d, length = a[keep], d[keep] / length[keep, None], length[keep]
    n = len(length)
    state = type("State", (), dict(
        transforms=[i.transform for i in data.instances],
        previous=[i.transform for i in data.instances],
        character=data.meshes["character"], lights=data.lights))
    s = shading.Scene(data, state, "cpu", torch.float64)
    tri, _, _, _ = shading.trace(s, torch.tensor(a), torch.tensor(d),
                                 torch.full((n,), 0.01), torch.tensor(length),
                                 cull=False)
    want = (tri >= 0).numpy()

    def agree(k):
        factor, dropped = pli.trace_shadow_factor(
            sb, rows, scene, torch.tensor(a.T, dtype=torch.float32),
            torch.tensor(d.T, dtype=torch.float32), torch.full((n,), 0.01),
            torch.tensor(length, dtype=torch.float32), torch.full((n,), 0.5),
            k, opaque_fn=tc.make_shadow_opaque_fn(), shade_boost=16)
        assert int(dropped) == 0
        return ((factor < 0.5).numpy() == want).mean()

    assert 0.5 < want.mean() < 0.9  # the rays cross the foliage
    assert cfg.k_shadow == 4
    assert agree(cfg.k_shadow) >= 0.999
    assert agree(1) < 0.97


def test_fifty_lights_draw():
    data = _data(48)
    assert len(data.lights) == 50
    prog = program.build(data, _cfg(**SMALL), device="cpu")
    frame = program.draw(prog)
    sb = prog.renderer._sb
    assert int(sb.light_count) == 50 and sb.lights.shape[0] == 64
    assert sb.light_groups[:50].tolist() == [
        light["group_bits"] for light in data.lights]
    assert frame.shape[:2] == (SMALL["display"][1], SMALL["display"][0])
