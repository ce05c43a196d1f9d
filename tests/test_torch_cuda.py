"""Card-only tests of the port: K1/K2, K3/K4, the alpha sweep's and the
alpha cull's kernels against their plain twins, the wrappers' launch
counting and checks, the kernel library loaded once across threads, tiny
frames on the card against the CPU, and the reflection bounces on their live
mirror rays against the full width. This file imports torch and
rt64tpu_torch only, so it runs on a machine without JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a card every test skips with a reason; chip_smoke.py runs the
same checks at the castle frame's full size."""

import functools

import numpy as np
import pytest
import torch

from rt64tpu_torch.ops import tracer as ptr
from rt64tpu_torch.ops import tracer_cuda as tc
from alpha_sweep_cases import (CULL_CASES, bits, castle_sweep, cull_case,
                               sweep_rays_torch, sweep_scene)
import reflection_cases as rc

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scene(seed, device, t=512):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-10, 10, (3, t)).astype(np.float32)
    s = dict(
        v0=v0,
        v1=v0 + rng.uniform(-3, 3, (3, t)).astype(np.float32),
        v2=v0 + rng.uniform(-3, 3, (3, t)).astype(np.float32),
        valid=rng.uniform(size=t) > 0.05,
        alpha=rng.uniform(size=t) < 0.1,
        no_cull=rng.uniform(size=t) < 0.5,
        bias=np.where(rng.uniform(size=t) < 0.2, rng.uniform(0, 2, t), 0.0
                      ).astype(np.float32),
    )
    s = {k: torch.from_numpy(v).to(device) for k, v in s.items()}
    return ptr.TraceScene(**s, alpha_idx=ptr.compact_alpha(s["valid"], s["alpha"], 64))


def _rays(seed, shadow, device, n=4096):
    rng = np.random.default_rng(1000 + seed)
    origins = torch.from_numpy(rng.uniform(-15, 15, (3, n)).astype(np.float32)).to(device)
    dirs = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)).to(device)
    t_min = torch.zeros(n, device=device)
    t_max = (torch.from_numpy(rng.uniform(1, 30, n).astype(np.float32)).to(device)
             if shadow else torch.full((n,), 1e5, device=device))
    return origins, dirs, t_min, t_max


def _prepared(seed, shadow, device, case="base", n=4096):
    """One launch's inputs. case "long_lists": 8192 triangles (64
    clusters of 128, or 128 of 64) and incoherent rays, so that a block's
    list is several work items long; "mostly_dead": 9 rays in 10 have an
    empty interval. n: rays (the prep pads the last block with dead
    rays)."""
    prep = tc.prepare_shadow if shadow else tc.prepare_opaque
    origins, dirs, t_min, t_max = _rays(seed, shadow, device, n=n)
    if case == "mostly_dead":
        dead = torch.from_numpy(
            np.random.default_rng(seed).uniform(size=t_max.shape[0]) < 0.9)
        t_max[dead.to(device)] = -1.0
    scene = _scene(seed, device, t=8192 if case == "long_lists" else 512)
    p = prep(origins, dirs, t_min, t_max, scene)
    if case == "long_lists":
        assert int(p.counts.max()) >= 3 * tc.SLICE_VISITS
    return p


MT_CASES = ["base", "long_lists", "mostly_dead"]


@pytest.fixture
def streaming(monkeypatch):
    """The 128-triangle path (K3/K4) at any scene size."""
    monkeypatch.setattr(tc, "RESIDENT_TABLE_BYTES", 0)


def _counted(wrapper, args, counts, cluster_size, **kw):
    """Launch a kernel's counting instantiation: (outputs, pairs tested,
    pairs past the first stage), after the checks every kernel's counts
    meet: no more visits than listed, no more pairs than the visits hold,
    and each stage passes no more pairs than the one before."""
    stats = torch.empty((counts.shape[0], tc.STATS_COLS), dtype=torch.int64,
                        device=counts.device)
    out = wrapper(*args, stats=stats, **kw)
    walked, tested, *stages = stats[:, :1 + tc.STAT_STAGES].cpu().T
    assert (walked <= counts.cpu()).all()
    assert (tested <= walked * tc.BLOCK_RAYS * cluster_size).all()
    for before, after in zip([tested] + stages, stages):
        assert (after <= before).all()
    return out, tested, stages


# Rays of the K1/K2 twin tests: the last block is partial.
PARTIAL = 4096 + 300


@pytest.mark.parametrize("cull", [True, False])
def test_k1_matches_plain_twin(card, cull):
    p = _prepared(0, False, card, n=PARTIAL)
    assert not p.mt and p.packed is not None
    before = tc.launch_counts.opaque_launches
    t, tri, u, v, b = tc.trace_opaque_blocks(*p[:5], cull, packed=p.packed)
    assert tc.launch_counts.opaque_launches == before + 1
    t_p, tri_p, u_p, v_p, b_p = tc.trace_opaque_plain(*p[:5], cull)
    torch.cuda.synchronize()
    assert (tri == tri_p).float().mean().item() >= 0.999
    same = (tri == tri_p) & (tri >= 0)
    assert same.any()
    rel = (t[same] - t_p[same]).abs() / t_p[same].abs().clamp(min=1e-6)
    assert rel.max().item() < 1e-3
    for got, want in ((u, u_p), (v, v_p)):
        err = (got[same] - want[same]).abs().double()
        assert torch.quantile(err, 0.99).item() < 1e-3
    assert torch.equal(b[same], b_p[same])
    # The counting instantiation gives the same result and sane counts.
    (t_s, tri_s, *_), tested, stages = _counted(
        tc.trace_opaque_blocks, (*p[:5], cull), p.counts, tc.K_CS,
        packed=p.packed)
    assert torch.equal(tri_s, tri) and torch.equal(t_s, t)
    assert 0 < stages[0].sum() < tested.sum()
    # A miss keeps the output contract: t = t_max + 1 and zeros.
    miss = tri < 0
    assert torch.equal(t[miss], p.rays8[7][miss] + 1.0)
    assert not (u[miss].any() or v[miss].any() or b[miss].any())
    # Every hit passed the last stage; a ray may hit several triangles.
    assert stages[3].sum() >= (tri >= 0).sum().item()


def _hits_per_block_within(hits, blocked, counts, triangles):
    """Every blocked ray was hit at least once: a ray's pairs are spread
    over work items and warp tasks, and each stops at its own first
    blocker. It is tested no further: a blocked ray enters no later
    visit of the item, so per block the hits are at most blocked rays x
    the block's items x the tasks that share one ray's cluster."""
    per_block = blocked.reshape(-1, tc.BLOCK_RAYS).sum(dim=1).cpu()
    items = -(-counts.cpu() // tc.SLICE_VISITS)
    tasks = triangles // tc.TASK_TRIS_FEW
    assert (hits >= per_block).all()
    assert (hits <= per_block * items * tasks).all()


def test_k2_matches_plain_twin(card):
    p = _prepared(1, True, card, n=PARTIAL)
    assert not p.mt
    before = tc.launch_counts.shadow_launches
    blocked = tc.trace_shadow_blocks(*p[:5], packed=p.packed)
    assert tc.launch_counts.shadow_launches == before + 1
    want = tc.trace_shadow_plain(*p[:5])
    torch.cuda.synchronize()
    assert (blocked == want).float().mean().item() >= 0.999
    assert 0 < blocked.sum().item() < blocked.numel()
    blocked_s, _, stages = _counted(tc.trace_shadow_blocks, p[:5], p.counts,
                                    tc.K_CS, packed=p.packed)
    assert torch.equal(blocked_s, blocked)
    # K2's hits are its third stage; its fourth stays 0.
    _hits_per_block_within(stages[2], blocked, p.counts, tc.K_CS)
    assert stages[3].sum() == 0


def test_k1_k2_need_packed_on_card(card):
    """On the card the Woop wrappers launch the walk, which reads the
    kernel-side table: without it they raise (the CPU twins need none)."""
    p = _prepared(2, False, card)
    with pytest.raises(ValueError, match="packed"):
        tc.trace_opaque_blocks(*p[:5], True)
    with pytest.raises(ValueError, match="packed"):
        tc.trace_shadow_blocks(*p[:5])
    wrong = tc.pack_mt_clusters(
        torch.zeros((p.clusters.shape[0], tc.M_ROWS, tc.CLUSTER_SIZE),
                    device=card), *tc.build_cluster_boxes(
                        _scene(2, card), tc.CLUSTER_SIZE))
    with pytest.raises(ValueError, match="packed"):
        tc.trace_opaque_blocks(*p[:5], True, packed=wrong)


@pytest.mark.parametrize("case", MT_CASES)
@pytest.mark.parametrize("cull", [True, False])
def test_k3_matches_plain_twin(card, streaming, cull, case):
    p = _prepared(3, False, card, case)
    assert p.mt and p.packed is not None
    before = tc.launch_counts.opaque_mt_launches
    k1_before = tc.launch_counts.opaque_launches
    t, tri, u, v, b = tc.trace_opaque_mt_blocks(*p[:5], cull, packed=p.packed)
    assert tc.launch_counts.opaque_mt_launches == before + 1
    assert tc.launch_counts.opaque_launches == k1_before
    t_p, tri_p, u_p, v_p, b_p = tc.trace_opaque_mt_plain(*p[:5], cull)
    torch.cuda.synchronize()
    assert (tri == tri_p).float().mean().item() >= 0.999
    assert ((tri >= 0) != (tri_p >= 0)).float().mean().item() < 0.001
    same = (tri == tri_p) & (tri >= 0)
    assert same.any()
    rel = (t[same] - t_p[same]).abs() / t_p[same].abs().clamp(min=1e-6)
    assert torch.quantile(rel.double(), 0.99).item() < 1e-3
    for got, want in ((u, u_p), (v, v_p)):
        err = (got[same] - want[same]).abs().double()
        assert torch.quantile(err, 0.99).item() < 1e-3
    assert torch.equal(b[same], b_p[same])
    (t_s, tri_s, *_), tested, stages = _counted(
        tc.trace_opaque_mt_blocks, (*p[:5], cull), p.counts, tc.CLUSTER_SIZE,
        packed=p.packed)
    assert torch.equal(tri_s, tri) and torch.equal(t_s, t)
    # Without culling every active triangle's determinant passes.
    assert 0 < stages[0].sum() <= tested.sum()
    assert (stages[0].sum() < tested.sum()) == cull
    # Most pairs of a visited cluster fail the u or the v stage.
    assert stages[3].sum() >= (tri >= 0).sum().item()
    assert stages[2].sum() < stages[0].sum()


@pytest.mark.parametrize("case", MT_CASES)
def test_k4_matches_plain_twin(card, streaming, case):
    p = _prepared(4, True, card, case)
    assert p.mt
    before = tc.launch_counts.shadow_mt_launches
    blocked = tc.trace_shadow_mt_blocks(*p[:5], packed=p.packed)
    assert tc.launch_counts.shadow_mt_launches == before + 1
    want = tc.trace_shadow_mt_plain(*p[:5])
    torch.cuda.synchronize()
    assert (blocked == want).float().mean().item() >= 0.999
    assert 0 < blocked.sum().item() < blocked.numel()
    blocked_s, _, stages = _counted(tc.trace_shadow_mt_blocks, p[:5],
                                    p.counts, tc.CLUSTER_SIZE,
                                    packed=p.packed)
    assert torch.equal(blocked_s, blocked)
    _hits_per_block_within(stages[3], blocked, p.counts, tc.CLUSTER_SIZE)
    with pytest.raises(ValueError, match="packed"):
        tc.trace_shadow_mt_blocks(*p[:5])


def _order_independent(p, q):
    """A closest-hit launch p and a shadow launch q give the same bits
    whatever order their work items run in: launched twice, and with
    the item table reversed. The card's own item table is
    build_work_items' table."""
    opaque = tc.trace_opaque_mt_blocks if p.mt else tc.trace_opaque_blocks
    shadow = tc.trace_shadow_mt_blocks if q.mt else tc.trace_shadow_blocks
    n_cols = p.visits.shape[1]
    items, n_items = tc.work_items_on_card(p.counts, n_cols)
    twin, twin_n = tc.build_work_items(p.counts, n_cols)
    n = int(n_items)
    assert n == int(twin_n) > 0 and torch.equal(items[:n], twin[:n])
    block, start = tc.work_item_slices(items, n_items, p.counts.shape[0])
    assert int((start < p.counts[block]).sum()) == n
    backwards = items.clone()
    backwards[:n] = items[:n].flip(0)
    first = opaque(*p[:5], True, packed=p.packed)
    for again in (
        opaque(*p[:5], True, packed=p.packed),
        opaque(*p[:5], True, packed=p.packed, items=(backwards, n_items)),
    ):
        for a, b in zip(first, again):
            assert torch.equal(a, b)
    assert (first[1] >= 0).any()
    items, n_items = tc.work_items_on_card(q.counts, q.visits.shape[1])
    n = int(n_items)
    backwards = items.clone()
    backwards[:n] = items[:n].flip(0)
    flags = shadow(*q[:5], packed=q.packed)
    assert flags.any()
    assert torch.equal(flags, shadow(*q[:5], packed=q.packed))
    assert torch.equal(flags, shadow(*q[:5], packed=q.packed,
                                     items=(backwards, n_items)))


@pytest.mark.parametrize("case", MT_CASES)
def test_k3_order_independent(card, streaming, case):
    """K3's outputs (and K4's flags) do not depend on the order of the
    work items."""
    _order_independent(_prepared(5, False, card, case),
                       _prepared(6, True, card, case))


@pytest.mark.parametrize("case", MT_CASES)
def test_k1_order_independent(card, case):
    """K1's outputs (and K2's flags) do not depend on the order of the
    work items."""
    p, q = _prepared(5, False, card, case), _prepared(6, True, card, case)
    assert not (p.mt or q.mt)
    _order_independent(p, q)


def test_regroup_parity_on_card(card, monkeypatch):
    """Regrouped tracing is bit-identical to unregrouped on the card
    too, on both kernel pairs (a stable sort, an order-free tie rule)."""
    scene = _scene(7, card)
    for table_bytes in (tc.RESIDENT_TABLE_BYTES, 0):
        monkeypatch.setattr(tc, "RESIDENT_TABLE_BYTES", table_bytes)
        for shadow, make, mode in ((False, tc.make_opaque_fn, "dir"),
                                   (True, tc.make_shadow_opaque_fn, "origin")):
            origins, dirs, t_min, t_max = _rays(8, shadow, card, n=3000)
            t_max[::3] = -1.0  # dead rays
            plain = make()(origins, dirs, t_min, t_max, scene)
            grouped = make(regroup=mode)(origins, dirs, t_min, t_max, scene)
            for a, b in zip(plain, grouped):
                assert torch.equal(a, b)
            assert (plain[1] >= 0).any()


def test_wrapper_rejects_mixed_devices(card):
    p = _prepared(2, False, card)
    with pytest.raises(ValueError):
        tc.trace_opaque_blocks(p.rays8, p.clusters.cpu(), *p[2:5], True,
                               packed=p.packed)


def _random_sweep(n):
    """The shared 700-entry alpha list (three 256-entry tiles, the last
    partial) with pad ids, single- and double-sided triangles, biases,
    and 20 copies of one double-sided triangle spread over it (equal
    keys, and rows with more hits than any K); rays at random, through
    the copies and away from everything, a quarter with an empty
    interval (pad lanes)."""
    scene, _ = sweep_scene(17)
    return scene, sweep_rays_torch("mixed", n, seed=17, dead=0.25)


SWEEPS = {"random": _random_sweep, "castle": castle_sweep}


@pytest.mark.parametrize("case", sorted(SWEEPS))
@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("k", [1, 2, 4, 16])
def test_alpha_sweep_matches_plain_twin(card, case, cull, k):
    """alpha_sweep_kernel against its plain twin on the CPU, same inputs:
    triangle ids exactly equal, t, u, v and the bias bit-equal."""
    scene, rays = SWEEPS[case](8192)
    to = lambda s: s._replace(**{f: getattr(s, f).to(card)
                                 for f in s._fields if f != "has_alpha"})
    before = tc.launch_counts.alpha_sweep_launches
    got = tc.alpha_sweep(*[r.to(card) for r in rays], to(scene), k, cull)
    assert tc.launch_counts.alpha_sweep_launches == before + 1
    want = ptr._alpha_sweep_plain(*rays, scene, k, cull)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(bits(g.cpu()), bits(w))
    hits = (want[1] >= 0).sum(dim=1)
    assert (hits == 0).any() and (hits >= min(k, 2)).any()
    if case == "random":
        live = rays[3] >= rays[2]
        assert not live.all()
        # The copies' live rays hold more hits than any k: full rows.
        assert (hits[(rays[1][2] == 1.0) & live] == k).all()


def test_alpha_sweep_on_the_frame_path(card):
    """The frame's compacted alpha trace (slab cull, compaction, sweep,
    behind mask) on the card launches the kernel once and equals the CPU
    bit for bit on the castle; k above MAX_SWEEP_HITS raises on the card."""
    scene, (o, d, t_min, t_max) = castle_sweep(8192)
    noise = torch.from_numpy(
        np.random.default_rng(5).uniform(size=o.shape[1]).astype(np.float32))
    t_opb = torch.where(torch.arange(o.shape[1]) % 2 == 0, 1e5, 40.0)
    args = lambda dev, s: ([a.to(dev) for a in (o, d, t_min, t_max)]
                           + [s, 4, True, 2048, noise.to(dev)])
    card_scene = scene._replace(**{f: getattr(scene, f).to(card)
                                   for f in scene._fields if f != "has_alpha"})
    before = tc.launch_counts.alpha_sweep_launches
    got = ptr.trace_alpha_to_compact(*args(card, card_scene),
                                     t_opaque_biased=t_opb.to(card))
    assert tc.launch_counts.alpha_sweep_launches == before + 1
    want = ptr.trace_alpha_to_compact(*args("cpu", scene),
                                      t_opaque_biased=t_opb)
    for name in ("idx", "mask", "t", "tri", "uv"):
        assert torch.equal(bits(getattr(got, name).cpu()),
                           bits(getattr(want, name))), name
    assert (want.tri >= 0).sum() > 100
    assert int(got.dropped) == int(want.dropped)
    with pytest.raises(ValueError, match="k_alpha"):
        tc.alpha_sweep(*args(card, card_scene)[:5], tc.MAX_SWEEP_HITS + 1,
                       True)


def _on(scene, dev):
    return scene._replace(**{f: getattr(scene, f).to(dev)
                             for f in scene._fields if f != "has_alpha"})


@pytest.mark.parametrize("case", CULL_CASES)
def test_alpha_cull_matches_plain_twin(card, case):
    """alpha_cull_kernel against its plain twin on the same card and on
    the CPU, the same inputs (alpha_sweep_cases.CULL_CASES): the masks
    equal, one launch. Some lanes are set and some not."""
    args = cull_case(case)
    before = tc.launch_counts.alpha_cull_launches
    got = tc.alpha_cull(*[a.to(card) for a in args])
    assert tc.launch_counts.alpha_cull_launches == before + 1
    want = ptr._slab_any_bundled_plain(*[a.to(card) for a in args])
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert torch.equal(got.cpu(), ptr._slab_any_bundled_plain(*args))
    assert want.any() and not want.all()


def test_alpha_cull_at_the_4k_shadow_width(card):
    """The 4K frame's DI shadow batch's width (4,147,200 lanes) over the
    castle's boxes: the mask equals the twin's on the card, and the launch
    allocates the mask alone, no (bundles x boxes) tensor: the allocated
    bytes grow by less than one a (bundle, box) pair (the caching
    allocator may hand the mask's N bytes a larger cached block)."""
    n = 4_147_200
    args = [a.to(card) for a in cull_case("castle", n=n)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = tc.alpha_cull(*args)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert n <= grown < n // 8 * args[4].shape[1], grown
    want = ptr._slab_any_bundled_plain(*args)
    assert torch.equal(got, want)
    assert want.any() and not want.all()
    with pytest.raises(ValueError, match="bundles"):
        tc.alpha_cull(*[a[..., :n - 3] for a in args[:4]], *args[4:])


@pytest.mark.parametrize("capacity", [8192, 256])
def test_alpha_cull_on_the_frame_path(card, monkeypatch, capacity):
    """The frame's compacted alpha trace on the card with the cull's
    kernel, and with its plain twin forced: idx, mask, t, tri, uv and
    dropped equal bit for bit (at capacity 256 candidates are dropped),
    one alpha_cull_kernel launch a call."""
    scene, rays = castle_sweep(8192, coherent=True)
    noise = torch.from_numpy(
        np.random.default_rng(5).uniform(size=8192).astype(np.float32))
    t_opb = torch.where(torch.arange(8192) % 2 == 0, 1e5, 40.0)
    args = ([r.to(card) for r in rays]
            + [_on(scene, card), 4, True, capacity, noise.to(card)])
    before = tc.launch_counts.alpha_cull_launches
    got = ptr.trace_alpha_to_compact(*args, t_opaque_biased=t_opb.to(card))
    assert tc.launch_counts.alpha_cull_launches == before + 1
    monkeypatch.setattr(tc, "alpha_cull", ptr._slab_any_bundled_plain)
    want = ptr.trace_alpha_to_compact(*args, t_opaque_biased=t_opb.to(card))
    for name in ("idx", "mask", "t", "tri", "uv"):
        assert torch.equal(bits(getattr(got, name)),
                           bits(getattr(want, name))), name
    assert int(got.dropped) == int(want.dropped)
    assert (int(want.dropped) > 0) == (capacity == 256)
    assert (want.tri >= 0).sum() > 100


@pytest.mark.parametrize("gi", [0, 1])
def test_tiny_frame_card_matches_cpu(card, gi):
    from rt64tpu_torch.utils.ssim import ssim
    from rt64tpu_torch.utils.testscenes import build_sample_scene

    fbs = []
    for device in ("cuda", "cpu"):
        dev, _, view = build_sample_scene(128, 64, gi_samples=gi,
                                          denoiser=bool(gi), device=device)
        view.max_reflections = 0
        for _ in range(1 + gi):  # the second GI frame reads history
            dev.draw()
        fbs.append(view.framebuffer())
    assert ssim(fbs[0][..., :3], fbs[1][..., :3]) >= 0.99


@pytest.mark.parametrize("kernel", ["k1", "k2", "k3", "k4"])
def test_all_dead_launch_matches_twin(card, monkeypatch, kernel):
    """A launch whose every ray is dead (t_max = -1, as on a reflection
    bounce with nothing left to mirror): an empty item table, a
    persistent grid that finds no work, and the twin's "no hit" bits
    (closest hit: tri -1, t = t_max + 1, zeros; occlusion: no flag)."""
    mt = kernel in ("k3", "k4")
    shadow = kernel in ("k2", "k4")
    monkeypatch.setattr(tc, "RESIDENT_TABLE_BYTES",
                        0 if mt else tc.RESIDENT_TABLE_BYTES)
    origins, dirs, t_min, t_max = _rays(9, shadow, card, n=PARTIAL)
    t_max.fill_(-1.0)
    prep = tc.prepare_shadow if shadow else tc.prepare_opaque
    p = prep(origins, dirs, t_min, t_max, _scene(9, card))
    assert p.mt == mt and int(p.counts.sum()) == 0
    items, n_items = tc.work_items_on_card(p.counts, p.visits.shape[1])
    assert int(n_items) == 0
    if shadow:
        wrapper = tc.trace_shadow_mt_blocks if mt else tc.trace_shadow_blocks
        twin = tc.trace_shadow_mt_plain if mt else tc.trace_shadow_plain
        got = (wrapper(*p[:5], packed=p.packed),)
        want = (twin(*p[:5]),)
    else:
        wrapper = tc.trace_opaque_mt_blocks if mt else tc.trace_opaque_blocks
        twin = tc.trace_opaque_mt_plain if mt else tc.trace_opaque_plain
        got = wrapper(*p[:5], True, packed=p.packed)
        want = twin(*p[:5], True)
        assert (got[1] == -1).all()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_reflection_frame_launches_k1(card):
    """The castle at 320x240 with GI, the denoiser and two reflection
    bounces: K1 launches exactly 2 + the reflection bounces with a live
    ray per frame (primary, GI bounce, one per issued reflection bounce;
    a bounce with no live ray is not issued), and the reflection plane
    lights exactly the pixels that seed a reflection (chip_smoke.py holds
    such frames to the CPU)."""
    from rt64tpu_torch.utils import profiling
    from rt64tpu_torch.utils.castle_scene import build_castle_scene

    dev, _, view = build_castle_scene(320, 240, gi_samples=1, denoiser=True)
    view.max_reflections = 2
    dev.draw()  # settles the alpha boost ladder
    before = tc.launch_counts.opaque_launches
    profiling.reset_frame_stats()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        dev.draw()
    torch.cuda.synchronize()
    st = profiling.frame_stats()
    profiling.reset_frame_stats()
    assert st["renders"] == 1 and st["reflection_live_rays"] > 0
    issued = view.max_reflections - st["reflection_bounces_skipped"]
    assert tc.launch_counts.opaque_launches - before == 2 + issued
    out = view._renderer._last
    assert int(out.alpha_dropped) == 0
    seeds = out.gbuffers.refl_alpha > 0
    lit = out.reflection.abs().amax(dim=0) > 0
    assert seeds.any() and torch.equal(lit & ~seeds, torch.zeros_like(lit))
    assert out.reflection.abs().max().item() > 0.05


def test_reflection_frame_equals_full_width_bounces(card):
    """The castle GI frame at 320x240 with two reflection bounces, drawn
    on the live mirror rays: its reflection plane bit-equal to the same
    bounces over every lane."""
    from rt64tpu_torch.utils.castle_scene import build_castle_scene

    dev, _, view = build_castle_scene(320, 240, gi_samples=1, denoiser=True)
    view.max_reflections = 2
    args = rc.capture_bounces(dev, view)
    got = view._renderer._last.reflection
    want, _, live = rc.full_width_bounces(*args)
    torch.cuda.synchronize()
    assert live[0][0] > 0
    assert torch.equal(rc.bits(got), rc.bits(want.rgb))


@functools.lru_cache(maxsize=1)
def _reflection_cases_on_card():
    return {k: rc.compare(a) for k, a in rc.cases("cuda").items()}


@pytest.mark.parametrize("case", rc.CASES)
def test_reflection_bounces_bit_equal_on_card(card, case):
    """reflection_bounces on the live mirror rays against the bounces over
    every lane, bit for bit on the card (the CPU side:
    tests/test_torch_reflection_compact.py): the castle (a dead second
    bounce), two facing mirrors (a narrower second bounce) and a forced
    alpha-capacity overflow on whole and partial cull bundles."""
    got = _reflection_cases_on_card()[case]
    print(case, got)
    assert got["same"]
    assert got["dropped"] == got["full_width_dropped"]
    if case.startswith("overflow"):
        assert got["dropped"] > 0
    issued = [lv for lv, _ in got["live"] if lv]
    assert got["reflection_live_rays"] == sum(issued) > 0


@pytest.mark.parametrize("resident", [True, False],
                         ids=["below_switch", "past_switch"])
def test_frame_stats_equal_launch_counts(card, monkeypatch, resident):
    """A profiled draw of the glass sample (GI, two reflection bounces)
    on either side of the size switch: the frame record's launches of
    each wrapper equal launch_counts' deltas over the draw, K3/K4 and no
    K1/K2 past the switch, the reverse below it (the CPU twins' side:
    tests/test_torch_launch_stats.py)."""
    from torch.profiler import ProfilerActivity, profile

    from rt64tpu_torch.utils import profiling, testscenes

    if not resident:
        monkeypatch.setattr(tc, "RESIDENT_TABLE_BYTES", 0)
    dev, scene, view = testscenes.build_sample_scene(
        128, 64, gi_samples=1, with_glass=True)
    testscenes.make_glass_translucent(scene)
    view.max_reflections = 2
    dev.draw()  # settles the alpha boost ladder
    before = dict(vars(tc.launch_counts))
    profiling.reset_frame_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        dev.draw()
    st = profiling.frame_stats()
    profiling.reset_frame_stats()
    delta = {k: v - before[k] for k, v in vars(tc.launch_counts).items()}
    assert {k: st[k] for k in profiling.LAUNCHES} == delta
    used = (("opaque_launches", "shadow_launches") if resident
            else ("opaque_mt_launches", "shadow_mt_launches"))
    assert all(delta[k] > 0 for k in used), delta
    assert sum(delta.values()) == sum(delta[k] for k in used) + delta[
        "alpha_sweep_launches"] + delta["hit_shade_launches"] + delta[
        "alpha_cull_launches"]
    assert delta["hit_shade_launches"] > 0 and delta["alpha_cull_launches"] > 0


def _raster_inputs(seed, n=12, width=96, height=64):
    """Seeded raster triangles over a random image: random combiners,
    both texture bindings, point and bilinear filtering under every
    addressing mode, a viewport, a scissor, a corner behind the camera."""
    from rt64tpu_torch.ops import raster as pr
    from rt64tpu_torch.ops import texture as ptex
    from rt64tpu_torch.pipeline import rows as R
    from rt64tpu_torch.pipeline.scene_buffers import build_quad_entries

    rng = np.random.default_rng(seed)
    pool, records, off = [], [], 0
    for (tw, th), hm, vm in [((8, 8), 0, 0), ((5, 7), 1, 2), ((16, 4), 2, 1)]:
        pool.append(build_quad_entries(
            rng.integers(0, 256, (th, tw, 4), dtype=np.uint8), hm, vm))
        records.append((off, tw, th))
        off += tw * th
    pool = np.concatenate(pool)
    pool = np.concatenate([pool, np.zeros((-len(pool) % ptex.QPR, 4), np.uint32)])
    irows = np.zeros((4, R.IROW), np.float32)
    for i in range(4):
        irows[i, R.I_CC] = R.pack_cc(list(rng.integers(0, 8, 4)),
                                     list(rng.integers(0, 8, 4)))
        irows[i, R.I_FLAGS] = (R.F_USE_T0 | R.F_USE_T1 * (i % 2)
                               | R.F_OPT_ALPHA * (i != 3))
        irows[i, R.I_TEX_D] = i % 3
        irows[i, R.I_TEX_D2] = (i + 1) % 3 if i != 1 else -1
        irows[i, R.I_SAMPLER] = (i % 2) + 4 * (i % 3) + 16 * ((i + 1) % 3)
    irows[1, R.I_VIEWPORT : R.I_VIEWPORT + 4] = (8, 4, 64, 48)
    irows[2, R.I_SCISSOR : R.I_SCISSOR + 4] = (10, 6, 50, 40)
    rows = np.zeros((n, pr.RR_WIDTH), np.float32)
    for t in range(n):
        pos = np.concatenate([rng.uniform(-1.2, 1.2, (3, 2)), rng.uniform(0, 1, (3, 1)),
                              rng.uniform(0.5, 2.0, (3, 1))], 1)
        if t == 2:
            pos[1, 3] = -0.7
        rows[t, :12] = pos.reshape(-1)
        rows[t, pr.RR_UV : pr.RR_INST] = rng.uniform(-0.5, 1.5, 30)
        rows[t, pr.RR_INST] = t % 4
    image = rng.uniform(0, 1, (4, height, width)).astype(np.float32)
    return image, rows, irows, ptex.pack_pool_wide(pool).astype(np.int64), \
        np.asarray(records, np.int32)


def test_raster_card_matches_cpu(card):
    """rasterize on the card against its plain run on the CPU (1e-5), and
    the box evaluation against the full-screen one on the card."""
    from rt64tpu_torch.ops import raster as pr

    image, rows, irows, pool, records = _raster_inputs(21)
    run = lambda where, box=True: pr.rasterize(
        torch.from_numpy(image).to(where), torch.from_numpy(rows).to(where),
        rows.shape[0], rows, irows, torch.from_numpy(pool).to(where), records,
        bounding_box=box)
    got = run(card)
    torch.cuda.synchronize()
    want = run("cpu")
    assert (got.cpu() - want).abs().max().item() <= 1e-5
    assert torch.equal(got, run(card, False))
    assert not torch.equal(want, torch.from_numpy(image))


def test_background_env_card_matches_cpu(card):
    from rt64tpu_torch.ops import sky

    rng = np.random.default_rng(4)
    plane = torch.from_numpy(rng.uniform(0, 1, (3, 72, 128)).astype(np.float32))
    dirs = torch.from_numpy(rng.normal(size=(3, 20000)).astype(np.float32))
    # On the same (u, v) the fetch agrees to 1e-6. By direction, atan2 on
    # the card and on the CPU may differ by an ulp of u, which the 128
    # texels scale to ~1e-5 (1.3e-5 seen on an H100): 1e-4 end to end.
    u, v = sky.fake_env_map_uv(dirs, 0.0)
    got = sky.sample_background_2d(plane.to(card), u.to(card), v.to(card)).cpu()
    assert (got - sky.sample_background_2d(plane, u, v)).abs().max().item() <= 1e-6
    got = sky.sample_background_env(plane.to(card), dirs.to(card)).cpu()
    want = sky.sample_background_env(plane, dirs)
    assert (got - want).abs().max().item() <= 1e-4
    got = sky.sample_background_grid(plane.to(card), 0.3, -0.2).cpu()
    assert torch.equal(got, sky.sample_background_grid(plane, 0.3, -0.2))


def test_layered_frame_card_matches_cpu(card):
    """The sample scene without its sky plane, with the raster skybox and
    HUD, gi 1, two draws; then the depth view with the HUD over it."""
    from rt64tpu_torch import descriptors as d
    from rt64tpu_torch.utils.ssim import ssim
    from rt64tpu_torch.utils.testscenes import build_sample_scene, raster_layers

    fbs = []
    for device in ("cuda", "cpu"):
        dev, scene, view = build_sample_scene(96, 64, gi_samples=1, device=device)
        view.set_sky_plane(None)
        raster_layers(scene, dev)
        dev.draw()
        dev.draw()
        fbs.append(view.framebuffer()[..., :3].copy())
        view.visualization_mode = d.VISUALIZATION_MODE_DEPTH
        dev.draw()
        fbs.append(view.framebuffer()[..., :3].copy())
    assert ssim(fbs[0], fbs[2]) >= 0.99
    assert ssim(fbs[1], fbs[3]) >= 0.99


@pytest.mark.parametrize("weights", ["shipped", "jax"])
def test_upscalers_card_match_cpu_under_tf32(card, monkeypatch, weights):
    """The resize, both accumulators and the learned slot on the card
    against the CPU, with the caller's TF32 matmul switch on: the
    resize's products are plain f32 multiplies and adds, so the history
    the accumulators feed back keeps f32 whatever the caller set. The
    learned slot runs the shipped weights, and the JAX package's file
    (read as a file)."""
    import os

    from rt64tpu_torch.models import learned_upscaler as lus
    from rt64tpu_torch.models import upscaler as ups
    from rt64tpu_torch.ops import filters

    if weights == "jax":
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        monkeypatch.setattr(lus, "PARAMS_PATH", os.path.join(
            root, "rt64tpu", "models", "_upscaler_params.npz"))
    lus._net_on.cache_clear()

    rng = np.random.default_rng(9)
    f = lambda *s, lo=0.0, hi=1.0: torch.from_numpy(
        rng.uniform(lo, hi, s).astype(np.float32))
    rt, depth, flow = f(3, 96, 128), f(96, 128, lo=1, hi=90), f(2, 96, 128, lo=-3, hi=3)
    reactive, lock, hist = f(96, 128), (f(96, 128) > 0.7).float(), f(4, 120, 160)
    inputs = dict(fsr=(hist[:3], rt, flow, reactive, lock),
                  xess=(hist, rt, depth, flow, reactive))
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for kernel in ("bilinear", "catmull"):
            got = filters.bilinear_resize(rt.to(card), 120, 160, kernel).cpu()
            want = filters.bilinear_resize(rt, 120, 160, kernel)
            assert (got - want).abs().max().item() <= 1e-6
        for name, fn in (("fsr", ups.temporal_accumulate),
                         ("xess", ups.xess_accumulate)):
            got = fn(*(t.to(card) for t in inputs[name]), False, 120, 160)
            want = fn(*inputs[name], False, 120, 160)
            got, want = (got, want) if name == "fsr" else (got[1], want[1])
            assert (got.cpu() - want).abs().max().item() <= 1e-5
        got = lus._run(rt.to(card), depth.to(card), flow.to(card),
                       reactive.to(card), 120, 160).cpu()
        want = lus._run(rt, depth, flow, reactive, 120, 160)
        # bf16 convolutions: cuDNN and oneDNN may round the residual one
        # bf16 step apart, two steps of its largest magnitude at most
        # (1e-5 for the JAX package's file, whose residual stays ~3e-4).
        res = (want - filters.bilinear_resize(rt, 120, 160)).abs().max().item()
        bound = max(1e-5, 2.0 * 2.0 ** (np.floor(np.log2(res)) - 7))
        assert (got - want).abs().max().item() <= bound, (res, bound)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
        lus._net_on.cache_clear()


def test_abi_host_on_card(card, tmp_path, monkeypatch):
    """sample_host built with g++ and run on the card (no
    RT64TPU_TORCH_DEVICE) at 64x48: it picks the sphere, and its PPM is
    the frame of its calls replayed through the port's bridge on the
    card (SSIM >= 0.99)."""
    from rt64tpu_torch.abi import bridge, build, hosts
    from rt64tpu_torch.utils.assets import read_ppm
    from rt64tpu_torch.utils.ssim import ssim

    monkeypatch.delenv(bridge.DEVICE_ENV, raising=False)
    built = build.build(str(tmp_path / "abi"))
    ppm = str(tmp_path / "sample_host.ppm")
    run = build.run_host(built.sample_host, ppm, 64, 48)
    assert run.returncode == 0, run.stderr
    assert "picked instance at center: sphere" in run.stdout
    monkeypatch.setenv("RT64TPU_VIEW_WIDTH", "64")
    monkeypatch.setenv("RT64TPU_VIEW_HEIGHT", "48")
    replay, pick = hosts.sample_host(bridge)
    assert pick == "sphere"
    assert ssim(read_ppm(ppm), replay[..., :3]) >= 0.99


def test_train_step_card_matches_cpu(card):
    """One training step from the same weights (the head made non-zero so
    every gradient is) on a batch of 2 at 16x16 -> 32x32: the loss within
    1e-4 of its value and every gradient within 1e-2 of its largest
    magnitude (bf16 convolutions: cuDNN and oneDNN round some outputs one
    bf16 step apart; the loss here is ~11.7, and one such step of a few
    outputs moves it by ~2e-5 of itself); the loss falls on both."""
    from rt64tpu_torch.models import train_upscaler as tr

    rng = np.random.default_rng(12)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)
    batch = [(dict(rt_color=u(0, 1, 3, 16, 16), depth=u(1, 50, 16, 16),
                   flow=u(-2, 2, 2, 16, 16), reactive=u(0, 1, 16, 16)),
              u(0, 1, 3, 32, 32)) for _ in range(2)]
    head = torch.from_numpy(rng.normal(0, 0.05, (3, 16, 3, 3)).astype(np.float32))
    losses, grads = {}, {}
    for where in ("cuda", "cpu"):
        net = tr.fresh_net(0)
        with torch.no_grad():
            net.convs[-1].weight.copy_(head)
        net = net.to(where)
        stacked, targets = tr.stack_batch(batch, where)
        opt = tr.make_optimizer(net, 1e-3)
        first = tr.train_step(net, opt, 1e-3, stacked, targets, 32, 32)
        grads[where] = [p.grad.cpu() for p in net.parameters()]
        second = tr.train_step(net, opt, 1e-3, stacked, targets, 32, 32)
        losses[where] = (float(first), float(second))
    assert abs(losses["cuda"][0] - losses["cpu"][0]) <= 1e-4 * losses["cpu"][0]
    assert losses["cuda"][1] < losses["cuda"][0]
    assert losses["cpu"][1] < losses["cpu"][0]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert (got - want).abs().max() <= 1e-2 * want.abs().max()


def test_kernel_library_loads_once_across_threads(card, monkeypatch):
    from concurrent.futures import ThreadPoolExecutor

    first = tc.kernel_library()
    monkeypatch.setattr(tc, "_library", None)
    with ThreadPoolExecutor(4) as pool:
        calls = [pool.submit(tc.kernel_library) for _ in range(4)]
        got = [c.result(timeout=300) for c in calls]
    assert all(g is got[0] for g in got)
    assert got[0].path == first.path
