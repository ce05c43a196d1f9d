"""The host-side pieces of the port's K3/K4 kernels (ops/tracer_cuda.py,
csrc/mt_tracer.cu and the walk they share with K1/K2,
csrc/packet_walk.cuh), on the CPU: the work-item table, the packed
(key, triangle id) merge word, merging slice by slice, the repacked
cluster table with its boxes and the slab test that culls rays per
cluster, the scene-table memo, and the constants and C signatures that
Python and the CUDA sources must share.

Everything here is exact (bit for bit, or a set equality): these pieces
move data and compare keys, they form no new arithmetic. The one
inequality, in the box test, is the direction that must hold (no ray
that hits a cluster's triangle is kept out of the cluster).
"""

import ctypes
import os
import re
from unittest import mock

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from rt64tpu_torch.ops import tracer as ptr
from rt64tpu_torch.ops import tracer_cuda as tc

CSRC = os.path.join(os.path.dirname(tc.__file__), os.pardir, "csrc")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny eager ops: one intra-op thread is the fastest, as in the
    other tests of the port. The worker's setting comes back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def streaming(monkeypatch):
    """The 128-triangle path at any scene size."""
    monkeypatch.setattr(tc, "RESIDENT_TABLE_BYTES", 0)


# ---------------------------------------------------------------------------
# (a) the work-item table
# ---------------------------------------------------------------------------

def _check_items(counts, n_cols, s):
    """The table for slices of s visits (the wrappers' one constant)."""
    b = len(counts)
    with mock.patch.object(tc, "SLICE_VISITS", s):
        items, n_items = tc.build_work_items(
            torch.tensor(counts, dtype=torch.int32), n_cols)
        block, start = tc.work_item_slices(items, n_items, b)
    assert items.shape == (b * -(-n_cols // s),) and items.dtype == torch.int32
    block, start = block.tolist(), start.tolist()
    assert len(block) == sum(-(-c // s) for c in counts)
    covered = {k: [] for k in range(b)}
    for k, first in zip(block, start):
        assert 0 <= first < counts[k] and first % s == 0
        covered[k].append(first)
    for k, firsts in covered.items():
        # Each block's slices come front to back, tile its list exactly
        # once, and none is longer than s.
        assert firsts == list(range(0, counts[k], s))
    # Slice-major: no item of a later slice before one of an earlier.
    assert start == sorted(start)


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_work_items_cover_every_visit_once(data):
    n_cols = data.draw(st.integers(1, 70))
    s = data.draw(st.sampled_from([1, 3, 16]))
    counts = data.draw(st.lists(st.integers(0, n_cols), min_size=1,
                                max_size=12))
    _check_items(counts, n_cols, s)


@pytest.mark.parametrize("counts, n_cols", [
    ([0, 0, 0], 40),                      # nothing to do
    ([40], 40),                           # one list of all nc visits
    ([0, 5, 16, 17, 40, 33, 0, 1], 40),   # shorter and longer than S
    ([16, 32, 48], 48),                   # exact multiples of S
])
def test_work_items_corner_cases(counts, n_cols):
    _check_items(counts, n_cols, tc.SLICE_VISITS)


# ---------------------------------------------------------------------------
# (b) the packed merge word
# ---------------------------------------------------------------------------

def _tie_rule_takes(key, tid, best, best_tid):
    """The kernels' and twins' rule: does (key, tid) replace the carry?"""
    return key < best or (key == best and best_tid >= 0 and tid > best_tid)


def _adversarial_pairs():
    keys = [0.0, -0.0, 1.0, -1.0, 1.0000001, 0.99999994, 1e-45, -1e-45,
            3.0e37, -3.0e37, 100001.0, -2.5, 7.25]
    tids = [-1, 0, 1, 127, 128, 32767, 2**31 - 1]
    return [(k, t) for k in keys for t in tids]


def test_pack_key_orders_as_the_tie_rule():
    rng = np.random.default_rng(0)
    pairs = _adversarial_pairs()
    pairs += [(float(np.float32(k)), int(t)) for k, t in zip(
        rng.normal(scale=50.0, size=300), rng.integers(0, 1 << 20, 300))]
    key = torch.tensor([p[0] for p in pairs], dtype=torch.float32)
    tid = torch.tensor([p[1] for p in pairs], dtype=torch.int32)
    packed = tc.pack_key(key, tid).tolist()
    keys = key.tolist()  # as f32 holds them
    n = len(pairs)
    for a in range(n):
        for b in range(n):
            # A candidate is a hit (tid >= 0); the carry may be a miss.
            if pairs[a][1] < 0:
                continue
            takes = _tie_rule_takes(keys[a], pairs[a][1], keys[b], pairs[b][1])
            assert (packed[a] < packed[b]) == takes, (pairs[a], pairs[b])


def test_pack_key_round_trips():
    pairs = _adversarial_pairs()
    key = torch.tensor([p[0] for p in pairs], dtype=torch.float32)
    tid = torch.tensor([p[1] for p in pairs], dtype=torch.int32)
    key2, tid2 = tc.unpack_key(tc.pack_key(key, tid))
    assert torch.equal(tid2, tid)
    # Bits survive, but for -0.0, which is stored as +0.0.
    want = torch.where(key == 0.0, torch.zeros_like(key), key)
    assert torch.equal(key2.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# (c), (d) slices merged through the packed word; the boxes
# ---------------------------------------------------------------------------

def _random_scene(seed, t_total=1024):
    """The random scene of tests/test_torch_packet_tracer_mt.py."""
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


def _slice_of(p, first, s):
    """The launch restricted to visits [first, first + s) of every list."""
    counts = torch.clamp(p.counts - first, 0, s).to(torch.int32)
    return (p.rays8, p.clusters, p.visits[:, first:first + s].contiguous(),
            counts, p.entries[:, first:first + s].contiguous())


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("backwards", [False, True])
def test_slices_merged_through_the_packed_word_equal_the_whole(
        streaming, cull, backwards):
    p = tc.prepare_opaque(*_random_rays(1), _random_scene(1))
    assert p.mt
    s = 3  # several slices per list on this small scene
    assert int(p.counts.max()) > 2 * s
    t, tri, u, v, bias = tc.trace_opaque_mt_plain(*p[:5], cull)
    firsts = list(range(0, int(p.counts.max()), s))
    if backwards:
        firsts.reverse()
    best = tc.pack_key(p.rays8[7] + 1.0, torch.full_like(tri, -1))
    outs = []
    for first in firsts:
        out = tc.trace_opaque_mt_plain(*_slice_of(p, first, s), cull)
        outs.append(out)
        best = torch.minimum(best, tc.pack_key(out[0], out[1]))
    t_m, tri_m = tc.unpack_key(best)
    assert torch.equal(tri_m, tri)
    assert (tri >= 0).any() and (tri < 0).any()
    # The merged key is the whole walk's key (== also equates -0.0, +0.0).
    assert bool((t_m == t).all())
    # u, v and bias come from the slice that holds the winner.
    for k, want in ((2, u), (3, v), (4, bias)):
        got = torch.zeros_like(want)
        for out in outs:
            won = (out[1] == tri_m) & (tri_m >= 0)
            got = torch.where(won, out[k], got)
        assert torch.equal(got, want)


def test_shadow_slices_merge_by_or(streaming):
    p = tc.prepare_shadow(*_random_rays(2, shadow=True), _random_scene(2))
    s = 3
    whole = tc.trace_shadow_mt_plain(*p[:5])
    merged = torch.zeros_like(whole)
    for first in range(0, int(p.counts.max()), s):
        merged |= tc.trace_shadow_mt_plain(*_slice_of(p, first, s))
    assert torch.equal(merged, whole) and 0 < int(whole.sum()) < whole.numel()


def _hit_pairs(p, cull):
    """(N, nc + 1) bool: ray r hits some triangle of cluster c, by the
    twins' own pair test, one cluster at a time."""
    n_blocks, n_tab = p.counts.shape[0], p.clusters.shape[0]
    o, d, tmin, tmax = tc._block_rays(p.rays8, n_blocks)
    hits = []
    for c in range(n_tab):
        m = p.clusters[c][None, None].expand(n_blocks, 1, -1, -1)
        hit, _, _, _ = tc._mt_hit(m, o, d, tmin, tmax, cull)
        hits.append(hit.any(dim=2).reshape(-1))
    return torch.stack(hits, dim=1)


@pytest.mark.parametrize("seed", [3, 6])
@pytest.mark.parametrize("shadow", [False, True])
def test_no_hit_lies_outside_the_kernel_side_boxes(streaming, seed, shadow):
    scene = _random_scene(seed)
    prep = tc.prepare_shadow if shadow else tc.prepare_opaque
    p = prep(*_random_rays(seed, shadow=shadow), scene)
    lo, hi = tc.build_cluster_boxes(scene, tc.CLUSTER_SIZE)
    packed = tc.pack_mt_clusters(p.clusters, lo, hi)
    enters = tc.cluster_slab_mask(p.rays8, packed)
    hits = _hit_pairs(p, cull=False)  # culling only removes hits
    assert hits.shape == enters.shape
    assert int(hits.sum()) > 100
    assert not bool((hits & ~enters).any())
    assert not bool(enters[:, -1].any())  # the pad cluster lets no ray in
    assert bool((~enters).any())  # and the test does cull


def test_packed_table_holds_the_cluster_table(streaming):
    scene = _random_scene(4)
    clusters = tc.build_cluster_data(scene)
    lo, hi = tc.build_cluster_boxes(scene, tc.CLUSTER_SIZE)
    packed = tc.pack_mt_clusters(clusters, lo, hi)
    n_tab, cs = clusters.shape[0], tc.CLUSTER_SIZE
    assert packed.shape == (n_tab, tc.PK_FLOAT4S, 4) and packed.is_contiguous()
    active = clusters[:, tc.M_ACTIVE] > 0
    e1, e2, v0 = packed[:, :cs], packed[:, cs:2 * cs], packed[:, 2 * cs:3 * cs]
    for got, row in ((e1, tc.M_E1), (e2, tc.M_E2), (v0, tc.M_V0)):
        want = clusters[:, row:row + 3].permute(0, 2, 1)
        assert torch.equal(got[..., :3][active], want[active])
        assert not bool(got[..., :3][~active].any())  # folded into geometry
    assert torch.equal(e1[..., 3], clusters[:, tc.M_BIAS])
    cls = torch.where(active, 1.0 + clusters[:, tc.M_NO_CULL], 0.0)
    assert torch.equal(e2[..., 3], cls)
    box = packed[:, 3 * cs:]
    assert torch.equal(box[:-1, 0, :3], lo.T) and torch.equal(box[:-1, 1, :3], hi.T)
    assert bool((box[-1, 0, :3] > box[-1, 1, :3]).all())  # pad: inverted
    bias_max = torch.where(active, clusters[:, tc.M_BIAS], -1.0).amax(dim=1)
    assert torch.equal(box[:, 0, 3], torch.clamp(bias_max, min=0.0))
    # A cluster without an active triangle lets no ray in either.
    gone = scene._replace(valid=scene.valid & (
        torch.arange(scene.num_triangles) >= cs))
    box = tc.pack_mt_clusters(
        tc.build_cluster_data(gone),
        *tc.build_cluster_boxes(gone, cs))[:, 3 * cs:]
    assert bool((box[0, 0, :3] > box[0, 1, :3]).all())
    assert bool((box[1, 0, :3] <= box[1, 1, :3]).all())


def test_scene_tables_are_kept_until_the_scene_changes(streaming):
    scene = _random_scene(5)
    first = tc._scene_tables(scene)
    assert tc._scene_tables(scene) is first
    assert not first.resident and first.packed is None  # CPU: no repack
    # The same values in other tensors: another scene.
    other = scene._replace(v1=scene.v1.clone())
    second = tc._scene_tables(other)
    assert second is not first and torch.equal(second.table, first.table)
    # A write into one of its tensors: rebuilt.
    other.bias.add_(1.0)
    third = tc._scene_tables(other)
    assert third is not second
    assert not torch.equal(third.table, second.table)
    assert tc.prepare_opaque(*_random_rays(5), other).clusters is third.table


# ---------------------------------------------------------------------------
# What Python and the CUDA sources share
# ---------------------------------------------------------------------------

def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _constant(text, name):
    m = re.search(rf"constexpr int {name} = ([^;]+);", text)
    assert m, name
    return m.group(1).strip()


def test_constants_match_the_cuda_sources():
    stats = _source("work_stats.cuh")
    for name in ("STATS_COLS", "STAT_STAGES", "STAT_CYCLES",
                 "STAT_ITEM_CYCLES"):
        assert int(_constant(stats, name)) == getattr(tc, name), name
    walk = _source("packet_walk.cuh")
    assert int(_constant(walk, "SLICE_VISITS")) == tc.SLICE_VISITS
    assert int(_constant(walk, "TASK_TRIS_FEW")) == tc.TASK_TRIS_FEW
    assert int(_constant(walk, "BLOCK_RAYS")) == tc.BLOCK_RAYS
    mt = _source("mt_tracer.cu")
    assert int(_constant(mt, "MT_CS")) == tc.CLUSTER_SIZE
    assert _constant(mt, "PK_FLOAT4S") == "3 * MT_CS + 2"
    assert tc.PK_FLOAT4S == 3 * tc.CLUSTER_SIZE + 2
    woop = _source("packet_tracer.cu")
    assert int(_constant(woop, "K_CS")) == tc.K_CS
    assert _constant(woop, "WP_FLOAT4S") == "4 * K_CS + 2"
    assert tc.WP_FLOAT4S == 4 * tc.K_CS + 2
    # The walk takes the counters' layout from their one header, and both
    # sources take the walk (and its constants) from the shared header.
    assert '#include "work_stats.cuh"' in walk and "STATS_COLS =" not in walk
    for text in (mt, woop):
        assert '#include "packet_walk.cuh"' in text
        for name in ("STATS_COLS", "SLICE_VISITS", "BLOCK_RAYS",
                     "TASK_TRIS_FEW"):
            assert f"{name} =" not in text, name


def test_alpha_cull_bundle_matches_the_cuda_source():
    """The alpha cull's kernel tests the bundles the twin forms."""
    assert int(_constant(_source("alpha_cull.cu"),
                         "CULL_BUNDLE")) == ptr._CULL_BUNDLE


def test_c_signatures_match_the_cuda_sources():
    """Every extern "C" function is declared to ctypes with one argtype
    per parameter: c_void_p for a pointer or the stream (anything else
    would cut it to 32 bits), c_int for an int."""
    declared = {}
    for name in sorted(n for n in os.listdir(CSRC)
                       if n.endswith((".cu", ".cuh"))):
        for fn, params in re.findall(
                r'extern "C" \w+ (\w+)\(([^)]*)\)', _source(name)):
            assert fn not in declared, fn
            declared[fn] = [" ".join(p.split()) for p in params.split(",")]
    assert set(declared) == set(tc.C_SIGNATURES)
    # The Woop and the MT launches take the same arguments.
    for woop, mt in (("rt64_trace_opaque", "rt64_trace_opaque_mt"),
                     ("rt64_trace_shadow", "rt64_trace_shadow_mt"),
                     ("rt64_woop_grid", "rt64_mt_grid")):
        assert declared[woop] == declared[mt]
    for fn, params in declared.items():
        want = [ctypes.c_void_p if ("*" in p or p.startswith("cudaStream_t"))
                else ctypes.c_int for p in params]
        assert all("*" in p or p.startswith(("int ", "cudaStream_t "))
                   for p in params), params
        assert tc.C_SIGNATURES[fn] == want, fn


def test_build_cache_key_covers_every_file_of_csrc(tmp_path, monkeypatch):
    for name in ("a.cu", "b.cu", "shared.cuh"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(tc, "_CSRC", str(tmp_path))
    names, before = tc._csrc_digest()
    assert names == ["a.cu", "b.cu", "shared.cuh"]
    # Only sources and headers count: no backup file, no directory.
    (tmp_path / "a.cu~").write_text("// an editor's backup\n")
    (tmp_path / "old.cuh").mkdir()
    assert tc._csrc_digest() == (names, before)
    (tmp_path / "shared.cuh").write_text("// shared.cuh, edited\n")
    assert tc._csrc_digest()[1] != before
    # The package's own csrc: every source and the header they share.
    monkeypatch.undo()
    assert tc._csrc_digest()[0] == sorted(
        n for n in os.listdir(CSRC) if n.endswith((".cu", ".cuh", ".h")))
    assert {"mt_tracer.cu", "packet_tracer.cu", "packet_walk.cuh",
            "work_stats.cuh"} <= set(tc._csrc_digest()[0])
