"""The host side of the port's K1/K2 kernels (ops/tracer_cuda.py,
csrc/packet_tracer.cu over the walk of csrc/packet_walk.cuh), on the
CPU: the kernel-side Woop table with the clusters' boxes, the per-ray
box cull that the walk applies before any pair test, the Woop twins cut
into work-item slices and merged as the kernels merge them (through the
packed (key, id) word, or by OR for occlusion), and the scene-table memo
that keeps the kernel-side table.

Everything here is exact (bit for bit, or a set equality): these pieces
move data and compare keys, they form no new arithmetic. The
inequalities, in the box tests, are the direction that must hold (no
ray that hits a cluster's triangle is kept out of the cluster).
"""

import functools

import numpy as np
import pytest
import torch

from rt64tpu_torch.ops import tracer as ptr
from rt64tpu_torch.ops import tracer_cuda as tc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny eager ops: one intra-op thread is the fastest, as in the
    other tests of the port. The worker's setting comes back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _random_scene(seed, t_total=1024):
    """The random scene of tests/test_torch_work_items.py: 16 clusters of
    64, well below the size switch (the Woop path)."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-10, 10, (3, t_total)).astype(np.float32)
    v1 = v0 + rng.uniform(-3, 3, (3, t_total)).astype(np.float32)
    v2 = v0 + rng.uniform(-3, 3, (3, t_total)).astype(np.float32)
    valid = rng.uniform(size=t_total) > 0.05
    alpha = (rng.uniform(size=t_total) < 0.1) & valid
    no_cull = rng.uniform(size=t_total) < 0.5
    bias = np.where(rng.uniform(size=t_total) < 0.2,
                    rng.uniform(0, 2, t_total), 0.0).astype(np.float32)
    a = {k: torch.from_numpy(v) for k, v in dict(
        v0=v0, v1=v1, v2=v2, valid=valid, alpha=alpha, no_cull=no_cull,
        bias=bias).items()}
    return ptr.TraceScene(**a, alpha_idx=ptr.compact_alpha(
        a["valid"], a["alpha"], 64))


def _random_rays(seed, n=1024, shadow=False):
    rng = np.random.default_rng(1000 + seed)
    origins = torch.from_numpy(rng.uniform(-15, 15, (3, n)).astype(np.float32))
    dirs = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
    t_max = (torch.from_numpy(rng.uniform(1.0, 30.0, n).astype(np.float32))
             if shadow else torch.full((n,), 1e5))
    t_max[::9] = -1.0  # some dead rays
    return origins, dirs, torch.zeros(n), t_max


@functools.lru_cache(maxsize=1)
def _castle():
    """The castle's trace scene (16,384-triangle bucket) and the primary
    rays of a 64x48 frame, as its first closest-hit launch saw them."""
    from rt64tpu_torch.utils.castle_scene import build_castle_scene

    seen = []
    prepare = tc.prepare_opaque

    def record(origins, dirs, t_min, t_max, scene):
        seen.append((origins, dirs, t_min, t_max, scene))
        return prepare(origins, dirs, t_min, t_max, scene)

    dev, _, view = build_castle_scene(64, 48, gi_samples=0, device="cpu")
    view.max_reflections = 0
    tc.prepare_opaque = record
    try:
        dev.draw()
    finally:
        tc.prepare_opaque = prepare
    return seen[0]


def _scene(which):
    return _castle()[4] if which == "castle" else _random_scene(int(which))


# ---------------------------------------------------------------------------
# The kernel-side table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["0", "1", "castle"])
def test_woop_table_holds_the_cluster_table(which):
    scene = _scene(which)
    assert tc.clusters_resident(scene.num_triangles)
    clusters = tc.build_cluster_mats(scene)
    lo, hi = tc.build_cluster_boxes(scene, tc.K_CS)
    packed = tc.pack_woop_clusters(clusters, lo, hi)
    n_tab, k = clusters.shape[0], tc.K_CS
    assert packed.shape == (n_tab, tc.WP_FLOAT4S, 4) and packed.is_contiguous()
    rows = lambda *r: torch.stack([clusters[:, i] for i in r], dim=-1)
    w = lambda g, tr: rows(tc.C_W + 3 * g, tc.C_W + 3 * g + 1,
                           tc.C_W + 3 * g + 2, tc.C_TR + tr)
    assert torch.equal(packed[:, :k], w(2, 2))  # r_z, s_z
    assert torch.equal(packed[:, k:2 * k, :2], rows(tc.C_THR, tc.C_BIAS))
    assert not bool(packed[:, k:2 * k, 2:].any())
    assert torch.equal(packed[:, 2 * k:3 * k], w(0, 0))  # u
    assert torch.equal(packed[:, 3 * k:4 * k], w(1, 1))  # v
    box = packed[:, 4 * k:]
    assert torch.equal(box[:-1, 0, :3], lo.T) and torch.equal(box[:-1, 1, :3], hi.T)
    assert bool((box[-1, 0, :3] > box[-1, 1, :3]).all())  # pad: inverted
    assert not bool(box[:, 1, 3].any())
    # The box's w: the largest depth bias of the cluster's active
    # triangles (thr is +BIG on an inactive one), 0 without any.
    thr, bias = clusters[:, tc.C_THR], clusters[:, tc.C_BIAS]
    for c in range(n_tab):
        active = thr[c].abs() < ptr._BIG * 0.5
        want = bias[c][active].max() if bool(active.any()) else 0.0
        assert box[c, 0, 3] == want, c
    # A scene without an empty cluster has no inverted box but the pad.
    empty = (lo > hi).any(dim=0)
    assert torch.equal((box[:-1, 0, :3] > box[:-1, 1, :3]).any(dim=1), empty)


# ---------------------------------------------------------------------------
# The per-ray box cull
# ---------------------------------------------------------------------------

def _hits_per_cluster(p, shadow):
    """(N, nc + 1): per ray and cluster, the twin's closest biased key in
    that cluster (inf where it hits none; cull off: culling only removes
    hits), or for shadow rays whether the twin finds the ray blocked in
    that cluster alone."""
    n_blocks, n_tab = p.counts.shape[0], p.clusters.shape[0]
    one = torch.ones(n_blocks, dtype=torch.int32)
    entries = torch.full((n_blocks, 1), -ptr._BIG)
    cols = []
    for c in range(n_tab):
        visits = torch.full((n_blocks, 1), c, dtype=torch.int32)
        if shadow:
            cols.append(tc.trace_shadow_plain(p.rays8, p.clusters, visits, one,
                                              entries) > 0)
        else:
            t, tri, *_ = tc.trace_opaque_plain(p.rays8, p.clusters, visits, one,
                                               entries, False)
            cols.append(torch.where(tri >= 0, t, float("inf")))
    return torch.stack(cols, dim=1)


@pytest.mark.parametrize("seed", [3, 6])
@pytest.mark.parametrize("shadow", [False, True])
def test_no_woop_hit_lies_outside_the_kernel_side_boxes(seed, shadow):
    scene = _random_scene(seed)
    prep = tc.prepare_shadow if shadow else tc.prepare_opaque
    p = prep(*_random_rays(seed, shadow=shadow), scene)
    assert not p.mt
    lo, hi = tc.build_cluster_boxes(scene, tc.K_CS)
    packed = tc.pack_woop_clusters(p.clusters, lo, hi)
    enters = tc.cluster_slab_mask(p.rays8, packed)
    hits = _hits_per_cluster(p, shadow)
    hit = hits if shadow else hits < float("inf")
    assert hit.shape == enters.shape
    assert int(hit.sum()) > 100
    assert not bool((hit & ~enters).any())
    assert not bool(enters[:, -1].any())  # the pad cluster lets no ray in
    assert bool((~enters).any())  # and the test does cull
    if not shadow:
        # A ray also drops out of a cluster whose widened box entry minus
        # the cluster's largest bias lies beyond its best key: no hit of
        # the cluster has a smaller key than that.
        box = packed[:, -2:]
        _, t_lo = ptr.slab_per_ray(p.rays8[0:3], p.rays8[3:6], p.rays8[6],
                                   p.rays8[7], box[:, 0, :3].T.contiguous(),
                                   box[:, 1, :3].T.contiguous())
        floor = t_lo - box[:, 0, 3][None]
        assert bool((hits[hit] >= floor[hit]).all())


# ---------------------------------------------------------------------------
# Slices merged as the walk merges its work items
# ---------------------------------------------------------------------------

def _slice_of(p, first, s):
    """The launch restricted to visits [first, first + s) of every list."""
    counts = torch.clamp(p.counts - first, 0, s).to(torch.int32)
    return (p.rays8, p.clusters, p.visits[:, first:first + s].contiguous(),
            counts, p.entries[:, first:first + s].contiguous())


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("backwards", [False, True])
def test_woop_slices_merged_through_the_packed_word_equal_the_whole(
        cull, backwards):
    p = tc.prepare_opaque(*_random_rays(1), _random_scene(1))
    assert not p.mt
    s = 3  # several slices per list on this small scene
    assert int(p.counts.max()) > 2 * s
    t, tri, u, v, bias = tc.trace_opaque_plain(*p[:5], cull)
    firsts = list(range(0, int(p.counts.max()), s))
    if backwards:
        firsts.reverse()
    best = tc.pack_key(p.rays8[7] + 1.0, torch.full_like(tri, -1))
    outs = []
    for first in firsts:
        out = tc.trace_opaque_plain(*_slice_of(p, first, s), cull)
        outs.append(out)
        best = torch.minimum(best, tc.pack_key(out[0], out[1]))
    t_m, tri_m = tc.unpack_key(best)
    assert torch.equal(tri_m, tri)
    assert (tri >= 0).any() and (tri < 0).any()
    # The merged key is the whole walk's key, and a miss keeps t_max + 1
    # (== also equates -0.0 and +0.0).
    assert bool((t_m == t).all())
    # u, v and bias come from the slice that holds the winner; a miss
    # reports zeros.
    for k, want in ((2, u), (3, v), (4, bias)):
        got = torch.zeros_like(want)
        for out in outs:
            won = (out[1] == tri_m) & (tri_m >= 0)
            got = torch.where(won, out[k], got)
        assert torch.equal(got, want)


def test_woop_shadow_slices_merge_by_or():
    p = tc.prepare_shadow(*_random_rays(2, shadow=True), _random_scene(2))
    assert not p.mt
    s = 3
    whole = tc.trace_shadow_plain(*p[:5])
    merged = torch.zeros_like(whole)
    for first in range(0, int(p.counts.max()), s):
        merged |= tc.trace_shadow_plain(*_slice_of(p, first, s))
    assert torch.equal(merged, whole) and 0 < int(whole.sum()) < whole.numel()


# ---------------------------------------------------------------------------
# The scene-table memo
# ---------------------------------------------------------------------------

def test_scene_tables_keep_the_woop_packed_table(monkeypatch):
    scene = _random_scene(5)
    # The CPU twins need no kernel-side table, so none is built here ...
    assert tc._scene_tables(scene).packed is None
    # ... unless the CPU is taken for a device whose launches read it.
    monkeypatch.setattr(tc, "_PACKED_ON", ("cpu",))
    other = scene._replace(v1=scene.v1.clone())
    first = tc._scene_tables(other)
    assert first.resident
    assert torch.equal(first.packed,
                       tc.pack_woop_clusters(first.table, first.lo, first.hi))
    assert tc._scene_tables(other) is first
    p = tc.prepare_shadow(*_random_rays(5, shadow=True), other)
    assert p.packed is first.packed and p.clusters is first.table
    # A write into one of the scene's tensors: rebuilt, packed too.
    other.bias.add_(1.0)
    second = tc._scene_tables(other)
    assert second is not first
    k = tc.K_CS
    assert torch.equal(second.packed[:-1, k:2 * k, 1],  # but the pad's
                       first.packed[:-1, k:2 * k, 1] + 1.0)
    assert tc.prepare_opaque(*_random_rays(5), other).packed is second.packed
