"""Packet tracer: cluster-culled traversal with hand-written CUDA kernels.

The counterpart of ``rt64tpu/ops/tracer_pallas.py``. Traversal is
packet-granular:

  1. Triangles are Morton-ordered at mesh upload (ops/geometry.py), so
     consecutive 64-triangle clusters are spatially coherent; their
     boxes and Woop transforms are rebuilt every frame (plain torch).
  2. A two-level slab pre-pass (block_visit_lists, plain torch) reduces
     every 512-ray block to a front-to-back list of the clusters any of
     its rays might hit.
  3. A kernel walks each block's list: K1 (closest opaque hit) and K2
     (any-hit occlusion) over the 64-triangle Woop table, in
     ``rt64tpu_torch/csrc/packet_tracer.cu``; K3 and K4 (the same two
     functions) over the 128-triangle Moller-Trumbore table, in
     ``rt64tpu_torch/csrc/mt_tracer.cu``. All four run one walk
     (``csrc/packet_walk.cuh``): work items (block, slice of its list) on
     a persistent grid (build_work_items), each ray culled per cluster by
     the cluster's box, dense warp tasks, an order-free merge.

Each kernel has a plain PyTorch twin that takes the same inputs and
computes the same function (trace_opaque_plain, trace_shadow_plain,
trace_opaque_mt_plain, trace_shadow_mt_plain,
tracer._alpha_sweep_plain, tracer._slab_any_bundled_plain). The wrappers
choose by device only: a CPU tensor takes the plain twin, a CUDA tensor
launches the kernel (built on first use with nvcc) or raises. Nothing
falls back. The alpha sweep's and the alpha cull's choices are made by
their one callers, tracer._alpha_sweep and tracer._slab_any_bundled.

Tie rule (K1, K3 and their twins): among hits, the smallest biased key
(t - depth bias) wins; among equal keys, the largest triangle id. The
rule does not depend on the order of the visits, so regrouped rays (see
_regroup_order) get bit-identical results. The JAX TPU kernels differ
on exactly equal keys only: K1's counterpart
(tracer_pallas._kernel_vmem) gives the same result whenever the tied
hits sit in different lanes of its 128-lane tile, and for two equal
keys in the same lane (the same column j) of different visits it keeps
the earlier visit (strict <, tracer_pallas.py:828); K3's counterpart
(tracer_pallas._kernel) takes the largest id within one cluster and
keeps the EARLIER visit across clusters (strict <,
tracer_pallas.py:681). The plain reference tracer (ops/tracer.py
trace_opaque) breaks ties per 512-triangle chunk instead (largest id
within a chunk, earlier chunk across chunks).

Cluster tables, both with the all-zero pad cluster `nc` last:
  Woop, K1/K2: (nc + 1, 14, 64) f32, one SoA block per 64-triangle
    cluster, plain f32 (no hi/lo split: the kernels run on CUDA cores,
    not on a bf16-rounding matrix unit). The kernels read its repacked
    form (pack_woop_clusters): four 16-byte operands per triangle and
    the cluster's box, (nc + 1, WP_FLOAT4S, 4) f32;
  Moller-Trumbore, K3/K4: (nc + 1, 12, 128) f32, one SoA block per
    128-triangle cluster: v0, e1, e2, depth bias, active, no_cull. The
    kernels read its repacked form (pack_mt_clusters): 16-byte operands
    per triangle and the cluster's box, (nc + 1, PK_FLOAT4S, 4) f32.

The alpha-class K-hit sweep (alpha_sweep): every ray against the whole
compacted alpha list, keeping its K nearest hits, for the alpha slots of
every pass (tracer.trace_alpha, tracer.trace_alpha_to_compact). Its
kernel, alpha_sweep_kernel in ``rt64tpu_torch/csrc/alpha_sweep.cu``,
runs one thread per ray with a K-slot insertion list in registers and
the list staged through shared memory, so no (rays x list) tensor is
made; its plain twin is tracer._alpha_sweep_plain, which sweeps the list
in 256-entry chunks. Tie rule (kernel and twin): ascending biased key;
among equal keys the later alpha-list position first, whatever the
chunk. t, u, v and the bias equal the twin's bit for bit. It replaces no
TPU kernel: the JAX package runs the sweep as XLA elementwise work.

The alpha cull (alpha_cull) before it: which lanes' 8-lane bundles may
meet an alpha triangle's box, the prefilter of the compaction in
tracer.trace_alpha_to_compact. Its kernel, alpha_cull_kernel in
``rt64tpu_torch/csrc/alpha_cull.cu``, runs one thread per bundle with
the bundle's hull in registers and the boxes staged through shared
memory, so no (bundles x boxes) tensor is made; its plain twin is
tracer._slab_any_bundled_plain. The mask equals the twin's bit for bit.
It replaces no TPU kernel either.

The size switch (clusters_resident): the JAX package keeps its Woop
table resident in on-chip memory while it fits RESIDENT_TABLE_BYTES
(triangle buckets up to 26,880) and streams the 128-triangle table from
device memory for larger scenes. The port changes tables at the same
scene, so both packages trace a given scene through counterpart
kernels. On the H100 this is a parity rule, not a memory wall: all four
kernels read their table from device memory through the caches, and
either pair can serve any scene size.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import weakref
from typing import NamedTuple

import torch

from rt64tpu_torch import limits
from rt64tpu_torch.ops import texture as tex_ops
from rt64tpu_torch.ops import tracer
from rt64tpu_torch.pipeline import rows as R
from rt64tpu_torch.utils import profiling

_BIG = tracer._BIG

K_CS = 64  # triangles per Woop cluster (K1/K2)
CLUSTER_SIZE = 128  # triangles per Moller-Trumbore cluster (K3/K4)
BLOCK_RAYS = 512  # rays per visit list (and per CTA of the walk)
# Clusters per level-1 group box at CLUSTER_SIZE; the K_CS path takes
# twice as many, so its group boxes keep the same physical extent.
GROUP_CLUSTERS = 8
# Columns of a kernel's optional work-count buffer (csrc/work_stats.cuh):
# visits walked, pairs tested, pairs past stages 1-4 of the pair test,
# then the cycles the block's work items held a CTA and the longest
# single item's cycles.
STATS_COLS = 8
STAT_STAGES = 5  # columns 1..5: pairs tested, then past each stage
STAT_CYCLES = 6
STAT_ITEM_CYCLES = 7
# The walk (csrc/packet_walk.cuh): visits per work item, and the
# triangles of the smallest warp task (a ray that enters a cluster is
# tested by at most triangles // TASK_TRIS_FEW tasks). Float4s of one
# cluster of the kernel-side tables: K3/K4 3 x 128 triangle operands +
# the box (csrc/mt_tracer.cu), K1/K2 4 x 64 + the box
# (csrc/packet_tracer.cu).
SLICE_VISITS = 16
TASK_TRIS_FEW = 8
PK_FLOAT4S = 3 * CLUSTER_SIZE + 2
WP_FLOAT4S = 4 * K_CS + 2
# The size switch (see the module docstring): the byte size of the JAX
# package's resident table, (T // 64) clusters of 13 x 192 f32, against
# its budget.
RESIDENT_TABLE_BYTES = 4 * 1024 * 1024
_RESIDENT_CLUSTER_BYTES = 13 * 192 * 4

# Woop cluster table rows (build_cluster_mats).
C_W = 0  # 9: W[g][i] at row g*3+i
C_TR = 9  # 3: -W v0
C_THR = 12  # signed keep threshold
C_BIAS = 13  # depth bias
C_ROWS = 14

# Moller-Trumbore cluster table rows (build_cluster_data).
M_V0 = 0  # 3
M_E1 = 3  # 3
M_E2 = 6  # 3
M_BIAS = 9
M_ACTIVE = 10  # 1.0 when valid opaque-class
M_NO_CULL = 11
M_ROWS = 12

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "rt64tpu_torch")


class LaunchCounts:
    """Kernel launches per wrapper: each wrapper adds one where it
    launches its kernel, and nowhere else. The counts are the whole
    process's, whatever thread launched (a C host may draw from several),
    under one lock. While a profiler records, each launch also goes to
    the frame record (profiling.count_launch), where a CPU twin's call
    counts as well. The lock is a class attribute, so vars() of the
    instance holds the counts alone."""

    NAMES = profiling.LAUNCHES  # K1-K4, the alpha sweep, hit shader, alpha cull
    _lock = threading.Lock()

    def __init__(self):
        self.reset()

    def reset(self):
        with self._lock:
            for name in self.NAMES:
                setattr(self, name, 0)

    def add(self, name: str):
        """One more launch of the wrapper that counts under `name`."""
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)
        profiling.count_launch(name)


launch_counts = LaunchCounts()


# ---------------------------------------------------------------------------
# Cluster data (plain torch, every frame)
# ---------------------------------------------------------------------------


def clusters_resident(num_triangles: int) -> bool:
    """The size switch: True when a scene of this triangle bucket takes
    the Woop table and K1/K2, False when it takes the Moller-Trumbore
    table and K3/K4. The same predicate as the JAX package's
    (tracer_pallas._clusters_fit_vmem on its (T // 64, 13, 192) table)."""
    return ((num_triangles // K_CS) * _RESIDENT_CLUSTER_BYTES
            <= RESIDENT_TABLE_BYTES)


def padded_to_clusters(scene: tracer.TraceScene, cs: int):
    """The scene with its triangle arrays padded to a multiple of `cs`
    by invalid triangles, which no ray hits: a scene bucket smaller than
    a cluster (or not a multiple of one) still fills whole clusters, and
    the ids of the real triangles do not change."""
    pad = (-scene.num_triangles) % cs
    if not pad:
        return scene
    ext = lambda a: torch.cat(
        [a, torch.zeros(a.shape[:-1] + (pad,), dtype=a.dtype,
                        device=a.device)], dim=-1)
    return scene._replace(v0=ext(scene.v0), v1=ext(scene.v1),
                          v2=ext(scene.v2), valid=ext(scene.valid),
                          alpha=ext(scene.alpha), no_cull=ext(scene.no_cull),
                          bias=ext(scene.bias))


def build_cluster_boxes(scene: tracer.TraceScene, cs: int = K_CS):
    """Per-cluster AABBs of the opaque-class triangles at `cs`-triangle
    granularity: (lo (3, nc), hi (3, nc)), nc = ceil(T / cs); clusters
    without an opaque-class triangle get inverted (never-hit) boxes."""
    scene = padded_to_clusters(scene, cs)
    nc = scene.num_triangles // cs
    act = (scene.valid & ~scene.alpha)[None]
    lo = torch.minimum(torch.minimum(scene.v0, scene.v1), scene.v2)
    hi = torch.maximum(torch.maximum(scene.v0, scene.v1), scene.v2)
    lo = torch.where(act, lo, _BIG).reshape(3, nc, cs).amin(dim=2)
    hi = torch.where(act, hi, -_BIG).reshape(3, nc, cs).amax(dim=2)
    return lo, hi


def build_cluster_data(scene: tracer.TraceScene):
    """Cluster-major Moller-Trumbore rows: (nc + 1, M_ROWS, CLUSTER_SIZE)
    f32 (v0, e1, e2, depth bias, active, no_cull per triangle) with the
    all-zero pad cluster last."""
    scene = padded_to_clusters(scene, CLUSTER_SIZE)
    nc = scene.num_triangles // CLUSTER_SIZE
    active = (scene.valid & ~scene.alpha).to(torch.float32)
    rows = torch.cat([
        scene.v0, scene.v1 - scene.v0, scene.v2 - scene.v0,
        scene.bias[None], active[None],
        scene.no_cull.to(torch.float32)[None],
    ], dim=0)  # (M_ROWS, T)
    tris = rows.reshape(M_ROWS, nc, CLUSTER_SIZE).permute(1, 0, 2)
    pad = torch.zeros((1, M_ROWS, CLUSTER_SIZE), dtype=tris.dtype,
                      device=tris.device)
    return torch.cat([tris, pad], dim=0).contiguous()


def build_cluster_mats(scene: tracer.TraceScene):
    """Cluster-major Woop transforms: (nc + 1, C_ROWS, K_CS) f32 with the
    all-zero pad cluster last.

    W is the inverse of [e1 e2 n]: rows (e2 x n, n x e1, n) / (n.n), so
    s = W (o - v0) and r = W d give t = -s_z/r_z, u = s_x + t r_x,
    v = s_y + t r_y. Moller-Trumbore's |det| > 1e-9 with det = -r_z nn
    becomes |r_z| > thr with thr = 1e-9 / nn; a double-sided triangle
    stores -thr, an inactive or degenerate one +BIG and a zero
    transform."""
    scene = padded_to_clusters(scene, K_CS)
    nc = scene.num_triangles // K_CS
    v0 = scene.v0
    e1 = scene.v1 - scene.v0
    e2 = scene.v2 - scene.v0

    def cross(a, b):
        return torch.stack([
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ], dim=0)

    n = cross(e1, e2)
    nn = (n * n).sum(dim=0)
    safe = nn > 1e-30
    inv = torch.where(safe, 1.0 / torch.where(safe, nn, 1.0), 0.0)
    w0 = cross(e2, n) * inv[None]
    w1 = cross(n, e1) * inv[None]
    w2 = n * inv[None]
    tr = torch.stack([
        -(w0 * v0).sum(dim=0),
        -(w1 * v0).sum(dim=0),
        -(w2 * v0).sum(dim=0),
    ], dim=0)  # (3, T)
    active = scene.valid & ~scene.alpha & safe
    act3 = active[None]
    w = torch.where(act3, torch.cat([w0, w1, w2], dim=0), 0.0)  # (9, T)
    tr = torch.where(act3, tr, 0.0)
    thr = torch.where(active, 1e-9 * inv, _BIG)
    thr = torch.where(scene.no_cull & active, -thr, thr)
    rows = torch.cat([w, tr, thr[None], scene.bias[None]], dim=0)  # (14, T)
    mats = rows.reshape(C_ROWS, nc, K_CS).permute(1, 0, 2)
    pad = torch.zeros((1, C_ROWS, K_CS), dtype=mats.dtype, device=mats.device)
    return torch.cat([mats, pad], dim=0).contiguous()


# ---------------------------------------------------------------------------
# Visit lists (plain torch, per launch)
# ---------------------------------------------------------------------------


def _slab_per_ray_live(origins, dirs, t_min, t_max, lo, hi):
    """Per-ray slab test against M boxes: (hit (N, M), entry (N, M)).
    Dead rays (empty [t_min, t_max]) never vote."""
    hit, t_lo = tracer.slab_per_ray(origins, dirs, t_min, t_max, lo, hi)
    hit = hit & (t_max >= t_min)[:, None]
    entry = torch.where(hit, torch.maximum(t_lo, t_min[:, None]), _BIG)
    return hit, entry


def block_visit_lists(origins, dirs, t_min, t_max, aabb_lo, aabb_hi,
                      bias_max=0.0, group_clusters: int = GROUP_CLUSTERS):
    """Per-ray-block compacted cluster visit lists — the two-level cull
    (the BLAS/TLAS traversal-cull analog of the driver BVH).

    Level 1: every ray slab-tests the group boxes (`group_clusters`
    Morton-adjacent clusters each). Level 2: each block's interval
    bounds (origin box, direction box, t range over its live rays)
    slab-test every cluster. A cluster is visited iff both pass; both
    are conservative. Lists are sorted FRONT-TO-BACK by the larger of
    the two entry bounds, which is what lets a kernel stop once the next
    entry lies beyond its rays' best. Equal entries come in ascending
    cluster id; no result depends on that order (the tie rule and the
    early-out look at keys and entries only).

    Returns (visits (n_blocks, nc) int32 cluster ids front-to-back,
    padded with nc; counts (n_blocks,) int32; entry (n_blocks, nc) f32
    entry distance per visit slot minus `bias_max`, so it lower-bounds
    the biased hit keys a kernel compares against).
    """
    n = origins.shape[1]
    dev = origins.device
    nc = aabb_lo.shape[1]
    assert n % BLOCK_RAYS == 0
    n_blocks = n // BLOCK_RAYS

    # Pad clusters to a group multiple with inverted (never-hit) boxes.
    g = group_clusters
    pad = (-nc) % g
    lo_p = torch.cat([aabb_lo, torch.full((3, pad), _BIG, device=dev)], dim=1)
    hi_p = torch.cat([aabb_hi, torch.full((3, pad), -_BIG, device=dev)], dim=1)
    nc_p = nc + pad
    ng = nc_p // g
    gr_lo = lo_p.reshape(3, ng, g).amin(dim=2)
    gr_hi = hi_p.reshape(3, ng, g).amax(dim=2)

    # Level 1: per-ray x group.
    hit_g, entry_g = _slab_per_ray_live(origins, dirs, t_min, t_max,
                                        gr_lo, gr_hi)
    block_hit_g = hit_g.reshape(n_blocks, BLOCK_RAYS, ng).any(dim=1)
    block_entry_g = entry_g.reshape(n_blocks, BLOCK_RAYS, ng).amin(dim=1)

    # Level 2: block interval bounds x cluster, over live rays only.
    live = t_max >= t_min
    per_block = lambda a, fill, red: red(
        torch.where(live[None, :], a, fill).reshape(3, n_blocks, BLOCK_RAYS),
        dim=2,
    )
    o_lo = per_block(origins, _BIG, torch.amin)
    o_hi = per_block(origins, -_BIG, torch.amax)
    d_lo = per_block(dirs, _BIG, torch.amin)
    d_hi = per_block(dirs, -_BIG, torch.amax)
    tmin_lo = torch.where(live, t_min, _BIG).reshape(n_blocks, BLOCK_RAYS).amin(dim=1)
    tmax_hi = torch.where(live, t_max, -_BIG).reshape(n_blocks, BLOCK_RAYS).amax(dim=1)
    hit_c, t_lo_c = tracer._slab_interval_hit(
        o_lo, o_hi, d_lo, d_hi, tmin_lo, tmax_hi, lo_p, hi_p
    )
    entry_c = torch.where(hit_c, torch.maximum(t_lo_c, tmin_lo[:, None]), _BIG)

    # Combine: expand groups to clusters, take the tighter entry bound.
    expand = lambda a: torch.repeat_interleave(a, g, dim=1)
    block_hit = expand(block_hit_g) & hit_c
    entry_b = torch.maximum(expand(block_entry_g), entry_c)

    counts = block_hit.sum(dim=1).to(torch.int32)
    key = torch.where(block_hit, entry_b, _BIG)
    order = torch.argsort(key, dim=1, stable=True)
    entry_sorted = torch.gather(key, 1, order)
    visits = torch.where(
        torch.arange(nc_p, device=dev)[None, :] < counts[:, None], order, nc
    ).to(torch.int32)
    entry = entry_sorted - bias_max
    # Padded cluster ids never hit, so the tail slice is pure padding.
    return (visits[:, :nc].contiguous(), counts,
            entry[:, :nc].contiguous())


# ---------------------------------------------------------------------------
# Kernel library: built from csrc/ with nvcc at first use
# ---------------------------------------------------------------------------


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when a cached build was loaded
    ptxas_log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cuda):
        return cuda
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "rt64tpu_torch/csrc on a machine with the CUDA toolkit")


def _csrc_digest():
    """(file names, hash) of every source and header under csrc/ (the
    regular *.cu, *.cuh and *.h files: the sources and all they include),
    so that no edit there reuses an old build."""
    names = sorted(
        n for n in os.listdir(_CSRC)
        if n.endswith((".cu", ".cuh", ".h"))
        and os.path.isfile(os.path.join(_CSRC, n)))
    sha = hashlib.sha256()
    for name in names:
        with open(os.path.join(_CSRC, name), "rb") as f:
            sha.update(name.encode() + b"\0" + f.read() + b"\0")
    return names, sha.hexdigest()[:16]


_library = None
_library_lock = threading.Lock()


def kernel_library() -> KernelLibrary:
    """Build (if needed) and load the packet-tracer library: every .cu
    under csrc/ compiled by its own nvcc (all started together), then
    linked into one shared library. The build output is cached under
    build/rt64tpu_torch/ by a hash of every file under csrc/. Loaded
    once a process: a thread that comes while another builds waits for
    that build (a C host may draw from several threads)."""
    global _library
    with _library_lock:
        if _library is None:
            _library = _build_library()
        return _library


def _build_library() -> KernelLibrary:
    import time

    names, digest = _csrc_digest()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    path = os.path.join(_BUILD_DIR, f"packet_tracer_{digest}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        # Another process may build the same library at the same time:
        # each writes its own files and renames the finished one in.
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}"
        nvcc = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
        t0 = time.perf_counter()
        sources = [n for n in names if n.endswith(".cu")]
        objects = [f"{tmp}.{n}.o" for n in sources]
        procs = [
            subprocess.Popen(
                nvcc + ["-Xptxas=-v", "-c", "-o", obj, os.path.join(_CSRC, n)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for n, obj in zip(sources, objects)
        ]
        outs = [proc.communicate()[0] for proc in procs]
        log = "".join(outs)
        failed = [n for n, proc in zip(sources, procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        link = subprocess.run(nvcc + ["-shared", "-o", f"{tmp}.so"] + objects,
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n{log}")
        seconds = time.perf_counter() - t0
        for obj in objects:
            os.remove(obj)
        os.replace(f"{tmp}.so", path)
    return KernelLibrary(_load_library(path), path, seconds, log)


# The C functions of the library: a pointer or a stream passed without
# c_void_p would be cut to 32 bits.
_P, _I = ctypes.c_void_p, ctypes.c_int
# rays8, blocks, table, n_tab, visits, counts, entries, n_cols, cull,
# items, n_items, max_items, build_items, counter, packed, t, tri, u, v,
# bias, stats, stream
_OPAQUE_ARGS = [_P, _I, _P, _I, _P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _P,
                _P, _P, _P, _P, _P, _P, _P]
# ... entries, n_cols, items, n_items, max_items, build_items, counter,
# blocked, stats, stream
_SHADOW_ARGS = [_P, _I, _P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P,
                _P]
C_SIGNATURES = {
    "rt64_trace_opaque": _OPAQUE_ARGS,  # K1
    "rt64_trace_shadow": _SHADOW_ARGS,  # K2
    "rt64_trace_opaque_mt": _OPAQUE_ARGS,  # K3
    "rt64_trace_shadow_mt": _SHADOW_ARGS,  # K4
    # shadow, stats
    "rt64_woop_grid": [_I, _I],
    "rt64_mt_grid": [_I, _I],
    # counts, blocks, max_items, items, n_items, stream
    "rt64_work_items": [_P, _I, _I, _P, _P, _P],
    # origins, dirs, t_min, t_max, n, v0, v1, v2, no_cull, bias, n_tri,
    # alpha_idx, a_cap, k, cull, t, tri, uv, bias, stream
    "rt64_alpha_sweep": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _I,
                         _I, _I, _P, _P, _P, _P, _P],
    # origins, dirs, t_min, t_max, n, lo, hi, m, mask, stream
    "rt64_alpha_cull": [_P, _P, _P, _P, _I, _P, _P, _I, _P, _P],
    # tri_rows, n_tri, tri, tri_is64, tri_stride, u, u_stride, v, v_stride,
    # noise, noise_stride, dir, dir_row, dir_lane, t_hit, t_stride, ddx,
    # ddx_row, ddx_lane, ddy, ddy_row, ddy_lane, pool, pool_quads,
    # pool_wide, m, variant, color, normal, specular, flow, instance,
    # rows_t, stream
    "rt64_hit_shade": [_P, _I, _P, _I, _I, _P, _I, _P, _I, _P, _I, _P, _I, _I,
                       _P, _I, _P, _I, _I, _P, _I, _I, _P, _I, _I, _I, _I, _P,
                       _P, _P, _P, _P, _P, _P],
}


def _load_library(path):
    """Load a built kernel library and declare its C functions."""
    lib = ctypes.CDLL(path)
    for name, argtypes in C_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_inputs(rays8, clusters, visits, counts, entries,
                  table=(C_ROWS, K_CS)):
    """Validate the kernels' inputs (`table`: rows and triangles of one
    cluster); returns (n_blocks, n_cols)."""
    n_blocks = counts.shape[0]
    checks = [
        (rays8, torch.float32, (8, n_blocks * BLOCK_RAYS), "rays8"),
        (clusters, torch.float32, (clusters.shape[0],) + table, "clusters"),
        (visits, torch.int32, (n_blocks, visits.shape[1]), "visits"),
        (counts, torch.int32, (n_blocks,), "counts"),
        (entries, torch.float32, (n_blocks, visits.shape[1]), "entries"),
    ]
    dev = rays8.device
    for t, dtype, shape, name in checks:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, rays8 on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if clusters.shape[0] < 1:
        raise ValueError("clusters needs at least the pad cluster")
    return n_blocks, visits.shape[1]


def _stats_ptr(stats, n_blocks, dev):
    """Zero a kernel's optional (n_blocks, STATS_COLS) int64 work-count
    buffer and return its pointer (None when absent)."""
    if stats is None:
        return None
    if (stats.dtype != torch.int64
            or tuple(stats.shape) != (n_blocks, STATS_COLS)
            or stats.device != dev or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous (n_blocks, {STATS_COLS}) "
                         "int64 tensor on the rays' device")
    stats.zero_()
    return stats.data_ptr()


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# The walk's launches (K1-K4, csrc/packet_walk.cuh)
# ---------------------------------------------------------------------------


def build_work_items(counts, n_cols: int):
    """The work items of a walk launch (K1-K4): every block's visit list
    cut into slices of at most SLICE_VISITS visits.

    Returns (items (B * ceil(n_cols / SLICE_VISITS),) int32, n_items
    (1,) int32). Only the first n_items entries are items. An item is
    the code slice * B + block: it stands for visits
    [slice * SLICE_VISITS, (slice + 1) * SLICE_VISITS) of that block's
    list (work_item_slices decodes). Items come slice-major: every
    block's first slice before any second slice, so a block's front
    slices start before its back slices and have usually lowered the
    block's bound by then, and the last items to start are single slices
    of the longest lists. This is the twin of the table that the
    launches' prologue_kernel builds (csrc/packet_walk.cuh), which
    builds the same table on the card in one launch; nothing is read
    back here either."""
    n_blocks = counts.shape[0]
    dev = counts.device
    max_slices = -(-n_cols // SLICE_VISITS)
    levels = torch.arange(max_slices, device=dev, dtype=torch.int32)[:, None]
    codes = torch.arange(max_slices * n_blocks, device=dev, dtype=torch.int32)
    slices = (counts + (SLICE_VISITS - 1)) // SLICE_VISITS  # (B,)
    valid = (levels < slices[None, :]).reshape(-1)  # slice-major grid
    # Stable compaction: an item's place is the number of items before it.
    place = torch.cumsum(valid, dim=0)
    dest = torch.where(valid, place - 1, codes.shape[0])
    items = torch.empty(codes.shape[0] + 1, dtype=torch.int32, device=dev)
    items.scatter_(0, dest, codes)
    return items[:-1], place[-1:].to(torch.int32)


def work_item_slices(items, n_items, n_blocks: int):
    """Decode build_work_items' codes: (block, first visit) of each of
    the n_items items, two (n_items,) int64 tensors (reads n_items back)."""
    codes = items[: int(n_items)].to(torch.int64)
    return codes % n_blocks, (codes // n_blocks) * SLICE_VISITS


def pack_key(key, tid):
    """Torch twin of K1's and K3's packed merge word (packet_walk.cuh
    pack_hit): the biased key's float bits mapped to an order-preserving
    unsigned (all bits of a negative flipped, the sign bit of a
    non-negative set, -0.0 made +0.0 first) above ~tid. Returned as
    int64 with the top bit flipped, so that signed order here equals the
    kernel's unsigned order: the minimum is the smallest key and, among
    equal keys, the largest id; tid -1 (a miss) wins every tie."""
    key = torch.where(key == 0.0, torch.zeros_like(key), key)
    b = key.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    k = torch.where((b & 0x80000000) != 0, ~b & 0xFFFFFFFF, b | 0x80000000)
    low = ~tid.to(torch.int64) & 0xFFFFFFFF
    return ((k - 0x80000000) << 32) | low


def unpack_key(packed):
    """Inverse of pack_key: (key f32, tid int32)."""
    k = (packed >> 32) + 0x80000000
    b = torch.where((k & 0x80000000) != 0, k & 0x7FFFFFFF, ~k & 0xFFFFFFFF)
    wrap = lambda x: ((x ^ 0x80000000) - 0x80000000).to(torch.int32)
    return (wrap(b).view(torch.float32),
            wrap(~packed & 0xFFFFFFFF))


def _box_float4s(lo, hi, bias, active):
    """The last two float4s of a cluster of a kernel-side table, (n_tab,
    2, 4): {box lo, the largest depth bias of the cluster's active
    triangles (0 without any)} and {box hi, 0}. lo, hi: (3, nc), the
    boxes the visit lists were made from; the pad cluster gets an
    inverted (never-entered) box, as build_cluster_boxes gives every
    cluster without an active triangle. bias, active: (n_tab, triangles)."""
    n_tab = bias.shape[0]
    pad = lambda a, fill: torch.cat(
        [a.T, torch.full((n_tab - a.shape[1], 3), fill, device=a.device)])
    lo, hi = pad(lo, _BIG), pad(hi, -_BIG)
    bias_max = torch.where(active, bias, -_BIG).amax(dim=1)
    bias_max = torch.where(active.any(dim=1), bias_max, 0.0)
    return torch.stack([
        torch.cat([lo, bias_max[:, None]], dim=1),
        torch.cat([hi, torch.zeros_like(bias_max)[:, None]], dim=1),
    ], dim=1)


def cluster_slab_mask(rays8, packed):
    """Torch twin of the walk's per-ray cluster cull: (N, nc + 1) bool,
    True where a live ray's widened slab interval against the cluster's
    box (the last two float4s of a kernel-side table, pack_woop_clusters'
    or pack_mt_clusters') meets [t_min, t_max]. The kernels test a ray
    against a cluster only where this holds."""
    box = packed[:, -2:, :3]  # (n_tab, 2, 3)
    hit, _ = _slab_per_ray_live(rays8[0:3], rays8[3:6], rays8[6], rays8[7],
                                box[:, 0].T.contiguous(),
                                box[:, 1].T.contiguous())
    return hit


def walk_grid(woop: bool, shadow: bool, stats: bool = False) -> int:
    """CTAs of a walk's persistent grid on the current card, SMs x
    resident CTAs: K1 (woop) or K3, or with shadow K2 (woop) or K4; the
    counting instantiation with stats. A launch clips it to its item
    table's size."""
    lib = kernel_library().lib
    grid = (lib.rt64_woop_grid if woop else lib.rt64_mt_grid)(
        int(shadow), int(stats))
    if grid <= 0:
        raise RuntimeError(f"walk_grid failed: cudaError {-grid}")
    return grid


class _WalkLaunch(NamedTuple):
    """The walk-only inputs of a card launch, as the C function takes
    them: addresses into the launch's scratch tensor (or the caller's
    item table)."""

    items: int  # (max_items,) int32 item codes
    n_items: int  # (1,) int32
    max_items: int
    build_items: bool  # the launch fills items and n_items itself
    counter: int  # (1,) int32, the grid's work counter
    best: int  # closest hit: (n,) int64 merge words, else 0
    scratch: torch.Tensor  # holds the memory the addresses point into


def _walk_inputs(rays8, clusters, counts, n_cols, packed, items, float4s,
                 packer, best_words: bool):
    """Validate and complete the walk-only inputs of a card launch
    (packed: `packer`'s table of `float4s` float4s per cluster). Without
    `items` the launch builds build_work_items' table itself, in its
    prologue kernel instead of a dozen torch ops. A launch's host time is
    part of its time, so the scratch (the merge words with best_words,
    the item table and the work counter, which the prologue zeroes) is
    one allocation, addressed by offset."""
    dev = rays8.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n_tab = clusters.shape[0]
    if packed is None:
        raise ValueError(f"a launch on the card needs packed, {packer}' "
                         "kernel-side table")
    if (packed.dtype != torch.float32
            or packed.shape != (n_tab, float4s, 4)
            or packed.device != dev or not packed.is_contiguous()
            or packed.data_ptr() % 16):
        raise ValueError(f"packed must be a contiguous, 16-byte aligned "
                         f"({n_tab}, {float4s}, 4) f32 tensor on {dev}")
    max_items = counts.shape[0] * -(-n_cols // SLICE_VISITS)
    words = 2 * rays8.shape[1] if best_words else 0  # int64 as 2 x int32
    scratch = torch.empty(words + max_items + 2, dtype=torch.int32,
                          device=dev)
    at = scratch.data_ptr()
    counter = at + 4 * (words + max_items + 1)
    best = at if best_words else 0
    if items is None:
        table = at + 4 * words
        return _WalkLaunch(table, table + 4 * max_items, max_items, True,
                           counter, best, scratch)
    table, n_items = items
    for t, shape, name in ((table, (max_items,), "items"),
                           (n_items, (1,), "n_items")):
        if (t.dtype != torch.int32 or t.shape != shape
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {shape} int32 "
                             f"tensor on {dev}")
    return _WalkLaunch(table.data_ptr(), n_items.data_ptr(), max_items, False,
                       counter, best, scratch)


def work_items_on_card(counts, n_cols: int):
    """build_work_items as the card's launches make it when they are
    given no table: (items, n_items) from prologue_kernel alone (for tests
    and chip_smoke.py; the launches build it in passing)."""
    dev = counts.device
    max_items = counts.shape[0] * -(-n_cols // SLICE_VISITS)
    items = torch.empty(max_items, dtype=torch.int32, device=dev)
    n_items = torch.zeros(1, dtype=torch.int32, device=dev)
    if max_items:
        lib = kernel_library().lib
        with torch.cuda.device(dev):  # see _launch_opaque
            err = lib.rt64_work_items(
                counts.data_ptr(), counts.shape[0], max_items,
                items.data_ptr(), n_items.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(err, "prologue_kernel")
    return items, n_items


def _launch_opaque(fn, float4s, packer, rays8, clusters, visits, counts,
                   entries, cull_backface, stats, packed, items):
    """Launch a closest-hit walk, K1 or K3 (the C function `fn`: prologue,
    walk, final pass), on the current stream of the inputs' device (the
    wrapper's _check_inputs and _walk_inputs raise ValueError, naming the
    tensor, for an input on another device)."""
    n_blocks, n_cols = counts.shape[0], visits.shape[1]
    w = _walk_inputs(rays8, clusters, counts, n_cols, packed, items, float4s,
                     packer, best_words=True)
    dev = rays8.device
    n = n_blocks * BLOCK_RAYS
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    bias = torch.empty(n, dtype=torch.float32, device=dev)
    stats_ptr = _stats_ptr(stats, n_blocks, dev)
    launch = getattr(kernel_library().lib, fn)
    # The CUDA runtime launches on the calling thread's current device,
    # not on the device of the stream it is given, and the walk's grid
    # reads cudaGetDevice: a Device("cuda:1") draws while card 0 may be
    # current, so the inputs' device is made the current one around
    # every launch.
    with torch.cuda.device(dev):
        err = launch(
            rays8.data_ptr(), n_blocks, packed.data_ptr(), packed.shape[0],
            visits.data_ptr(), counts.data_ptr(), entries.data_ptr(), n_cols,
            int(bool(cull_backface)), w.items, w.n_items, w.max_items,
            int(w.build_items), w.counter, w.best, t.data_ptr(),
            tri.data_ptr(), u.data_ptr(), v.data_ptr(), bias.data_ptr(),
            stats_ptr, torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, fn)
    return t, tri, u, v, bias


def _launch_shadow(fn, float4s, packer, rays8, clusters, visits, counts,
                   entries, stats, packed, items):
    """Launch an occlusion walk, K2 or K4 (the C function `fn`: prologue,
    which zeroes the flags, and walk), on the current stream of the
    inputs' device."""
    n_blocks, n_cols = counts.shape[0], visits.shape[1]
    w = _walk_inputs(rays8, clusters, counts, n_cols, packed, items, float4s,
                     packer, best_words=False)
    dev = rays8.device
    blocked = torch.empty(n_blocks * BLOCK_RAYS, dtype=torch.int32, device=dev)
    stats_ptr = _stats_ptr(stats, n_blocks, dev)
    launch = getattr(kernel_library().lib, fn)
    with torch.cuda.device(dev):  # see _launch_opaque
        err = launch(
            rays8.data_ptr(), n_blocks, packed.data_ptr(), packed.shape[0],
            visits.data_ptr(), counts.data_ptr(), entries.data_ptr(), n_cols,
            w.items, w.n_items, w.max_items, int(w.build_items), w.counter,
            blocked.data_ptr(), stats_ptr,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, fn)
    return blocked


# ---------------------------------------------------------------------------
# K1: closest opaque hit
# ---------------------------------------------------------------------------


def pack_woop_clusters(clusters, lo, hi):
    """The kernel-side table of K1/K2, (nc + 1, WP_FLOAT4S, 4) f32, from
    build_cluster_mats' (nc + 1, 14, 64) table: per cluster 64 float4
    {W row 2, tr.z} (r_z and s_z), 64 {signed thr, depth bias, 0, 0}, 64
    {W row 0, tr.x} (u), 64 {W row 1, tr.y} (v), then the cluster's box
    as {lo, largest depth bias of the cluster} and {hi, 0}.

    The rows are copied as they are: an inactive triangle keeps its
    zero transform and thr = +BIG, and counts as inactive for the
    largest bias. lo, hi: build_cluster_boxes(scene, K_CS), each
    (3, nc): the boxes the visit lists were made from."""
    n_tab = clusters.shape[0]
    row = lambda r: clusters[:, r]  # (n_tab, 64)
    w_row = lambda g, tr: [row(C_W + 3 * g + i) for i in range(3)] + [row(tr)]
    zero = torch.zeros_like(row(C_THR))
    planes = torch.stack([
        torch.stack(w_row(2, C_TR + 2), dim=-1),
        torch.stack([row(C_THR), row(C_BIAS), zero, zero], dim=-1),
        torch.stack(w_row(0, C_TR), dim=-1),
        torch.stack(w_row(1, C_TR + 1), dim=-1),
    ], dim=1)  # (n_tab, 4, 64, 4)
    active = torch.abs(row(C_THR)) < _BIG * 0.5
    box = _box_float4s(lo, hi, row(C_BIAS), active)
    return torch.cat([planes.reshape(n_tab, 4 * K_CS, 4), box],
                     dim=1).contiguous()


def trace_opaque_blocks(rays8, clusters, visits, counts, entries,
                        cull_backface: bool, stats=None, packed=None,
                        items=None):
    """Closest opaque hit per ray over per-block visit lists of
    64-triangle Woop clusters.

    rays8 (8, B*512) f32; clusters (nc+1, 14, 64) f32; visits (B, nc)
    int32; counts (B,) int32; entries (B, nc) f32. Returns (t biased
    key, tri int32 (-1 miss), u, v, bias), each (B*512,); a miss reports
    t = t_max + 1 and u = v = bias = 0. stats: optional (B, STATS_COLS)
    int64 tensor on the card that receives, per block, the visits
    walked, the (ray, triangle) pairs tested and those that passed each
    early return of the pair test in turn: the keep test, t in range, u,
    and v with u + v; then the cycles the block's work items held a CTA
    and its longest item's (kernel only; it selects the counting
    instantiation of K1).

    CPU tensors take trace_opaque_plain; CUDA tensors launch K1
    (csrc/packet_tracer.cu, the walk of csrc/packet_walk.cuh). On the
    card the time goes to the pair test (bound by instruction dispatch:
    a warp runs every stage any of its lanes reaches, for all its lanes)
    and, where lists are long, to the CTA that walks the longest. So the
    walk runs as work items, slices of SLICE_VISITS visits of one
    block's list (items: build_work_items' table, made by the launch
    itself when not given), pulled by a persistent grid; clusters arrive
    through an asynchronous shared-memory ring; per visit every ray is
    put to the slab test against the cluster's box (the box rows of
    packed, the scene's pack_woop_clusters table, which a launch on the
    card must be given: prepare_opaque's result carries it;
    cluster_slab_mask is the test's twin) and only the rays that enter
    are gathered and dealt to the warps as tasks of 32 rays x 8 or 16
    triangles; the pair test reads 16-byte operands. Items and tasks
    merge through atomicMin on a packed (key, ~id) word per ray (pack_key
    is its twin), which is the tie rule, so the result does not depend
    on the order they ran in; a last pass recomputes u, v and bias from
    the winning triangle."""
    _check_inputs(rays8, clusters, visits, counts, entries)
    if rays8.device.type == "cpu":
        profiling.count_launch("opaque_launches")
        return trace_opaque_plain(rays8, clusters, visits, counts, entries,
                                  cull_backface)
    out = _launch_opaque("rt64_trace_opaque", WP_FLOAT4S,
                         "pack_woop_clusters", rays8, clusters, visits,
                         counts, entries, cull_backface, stats, packed, items)
    launch_counts.add("opaque_launches")
    return out


def _block_rays(rays8, n_blocks):
    r = rays8.reshape(8, n_blocks, BLOCK_RAYS, 1)
    return r[0:3], r[3:6], r[6], r[7]  # (3, B, 512, 1) x2, (B, 512, 1) x2


def _visit_cluster(clusters, visits, counts, i):
    """Cluster ids of visit slot i per block (the pad cluster past the
    block's count) and their (B, 1, rows, triangles) table blocks."""
    pad = clusters.shape[0] - 1
    cid = torch.where(i < counts, visits[:, i], pad).to(torch.int64)
    cid = torch.clamp(cid, 0, pad)
    return cid, clusters[cid][:, None]


def _woop_terms(m, o, d):
    """s = W o + tr and r = W d for a (B, 1, 14, 64) cluster against
    (3, B, 512, 1) rays: six (B, 512, 64) planes."""
    w = lambda g, i: m[:, :, C_W + 3 * g + i]
    s = [w(g, 0) * o[0] + w(g, 1) * o[1] + w(g, 2) * o[2] + m[:, :, C_TR + g]
         for g in range(3)]
    r = [w(g, 0) * d[0] + w(g, 1) * d[1] + w(g, 2) * d[2] for g in range(3)]
    return s, r


def trace_opaque_plain(rays8, clusters, visits, counts, entries,
                       cull_backface: bool):
    """K1's plain twin: the same function over (blocks, 512, 64) tiles,
    one visit slot at a time, without the early-out (which never changes
    the result). Same tie rule as the kernel."""
    n_blocks = counts.shape[0]
    dev = rays8.device
    o, d, tmin, tmax = _block_rays(rays8, n_blocks)
    best = tmax[..., 0] + 1.0
    best_tid = torch.full_like(best, -1, dtype=torch.int64)
    best_u = torch.zeros_like(best)
    best_v = torch.zeros_like(best)
    best_b = torch.zeros_like(best)
    col = torch.arange(K_CS, device=dev)
    n_slots = int(counts.max()) if n_blocks else 0
    for i in range(n_slots):
        cid, m = _visit_cluster(clusters, visits, counts, i)
        (sx, sy, sz), (rx, ry, rz) = _woop_terms(m, o, d)
        thr_s = m[:, :, C_THR]
        thr = torch.abs(thr_s)
        if cull_backface:
            keep = (rz < -thr) | ((thr_s < 0.0) & (rz > thr))
        else:
            keep = torch.abs(rz) > thr
        t = -sz / torch.where(keep, rz, 1.0)
        u = sx + t * rx
        v = sy + t * ry
        hit = (keep & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t >= tmin) & (t <= tmax))
        bias = m[:, :, C_BIAS]
        key = torch.where(hit, t - bias, _BIG)
        tid = (cid[:, None, None] * K_CS + col).expand_as(key)
        # This visit's winner per ray: smallest key, then largest id.
        k_min = key.amin(dim=2)
        k_tid = torch.where(key <= k_min[..., None], tid, -1).amax(dim=2)
        at = tid == k_tid[..., None]
        pick = lambda a: torch.where(at, a, 0.0).sum(dim=2)
        take = (k_min < _BIG * 0.5) & (
            (k_min < best) | ((k_min == best) & (k_tid > best_tid))
        )
        best = torch.where(take, k_min, best)
        best_tid = torch.where(take, k_tid, best_tid)
        best_u = torch.where(take, pick(u), best_u)
        best_v = torch.where(take, pick(v), best_v)
        best_b = torch.where(take, pick(torch.broadcast_to(bias, key.shape)),
                             best_b)
    found = best <= tmax[..., 0]
    flat = lambda a: a.reshape(-1)
    return (
        flat(best),
        flat(torch.where(found, best_tid, -1)).to(torch.int32),
        flat(torch.where(found, best_u, 0.0)),
        flat(torch.where(found, best_v, 0.0)),
        flat(torch.where(found, best_b, 0.0)),
    )

# ---------------------------------------------------------------------------
# K2: any-hit occlusion
# ---------------------------------------------------------------------------


def trace_shadow_blocks(rays8, clusters, visits, counts, entries,
                        stats=None, packed=None, items=None):
    """Occlusion per ray over per-block visit lists of 64-triangle Woop
    clusters (never culls). Returns (B*512,) int32 blocked flags. CPU
    tensors take trace_shadow_plain; CUDA tensors launch K2
    (csrc/packet_tracer.cu). stats, packed, items and the design: as for
    trace_opaque_blocks, with the stages of K2's division-free test: the
    keep test, t in range, and u with v and u + v (the fourth stage
    column stays 0). K2's items merge through the flags themselves
    (zeroed by the launch; a slice that blocks a ray stores 1, and an item
    skips the rays an earlier one has blocked), and a block's bound is
    the largest t_max among its unblocked rays."""
    _check_inputs(rays8, clusters, visits, counts, entries)
    if rays8.device.type == "cpu":
        profiling.count_launch("shadow_launches")
        return trace_shadow_plain(rays8, clusters, visits, counts, entries)
    blocked = _launch_shadow("rt64_trace_shadow", WP_FLOAT4S,
                             "pack_woop_clusters", rays8, clusters, visits,
                             counts, entries, stats, packed, items)
    launch_counts.add("shadow_launches")
    return blocked


def trace_shadow_plain(rays8, clusters, visits, counts, entries):
    """K2's plain twin: the division-free occlusion test over
    (blocks, 512, 64) tiles, one visit slot at a time, without the
    early-outs."""
    n_blocks = counts.shape[0]
    o, d, tmin, tmax = _block_rays(rays8, n_blocks)
    blocked = torch.zeros_like(tmax[..., 0], dtype=torch.bool)
    n_slots = int(counts.max()) if n_blocks else 0
    for i in range(n_slots):
        _, m = _visit_cluster(clusters, visits, counts, i)
        (sx, sy, sz), (rx, ry, rz) = _woop_terms(m, o, d)
        keep = torch.abs(rz) > torch.abs(m[:, :, C_THR])
        q = rz * rz
        p = -(sz * rz)
        uq = sx * q + p * rx
        vq = sy * q + p * ry
        hit = (keep & (q > 0.0) & (uq >= 0.0) & (vq >= 0.0) & (uq + vq <= q)
               & (p >= tmin * q) & (p <= tmax * q))
        blocked = blocked | hit.any(dim=2)
    return blocked.reshape(-1).to(torch.int32)

# ---------------------------------------------------------------------------
# K3 / K4: the same two functions over the 128-triangle MT table
# ---------------------------------------------------------------------------

# (ray, triangle) pairs per tile of the MT twins: bounds their
# temporaries to a few hundred MB whatever the launch size.
_TWIN_TILE_PAIRS = 1 << 25
_MT_TABLE = (M_ROWS, CLUSTER_SIZE)


def pack_mt_clusters(clusters, lo, hi):
    """The kernel-side table of K3/K4, (nc + 1, PK_FLOAT4S, 4) f32, from
    build_cluster_data's (nc + 1, 12, 128) table: per cluster 128 float4
    {e1, depth bias}, 128 {e2, class}, 128 {v0, 0}, then the cluster's
    box as {lo, largest depth bias of the cluster} and {hi, 0}.

    class is 0 for an inactive triangle, 1 single-sided, 2 double-sided;
    an inactive triangle's e1, e2 and v0 are zeroed, so its determinant
    is 0 and the pair test rejects it without reading a flag. lo, hi:
    build_cluster_boxes(scene, CLUSTER_SIZE), each (3, nc): the boxes the
    visit lists were made from. The pad cluster gets an inverted
    (never-entered) box, as build_cluster_boxes gives every cluster
    without an active triangle."""
    n_tab = clusters.shape[0]
    active = clusters[:, M_ACTIVE] > 0.0  # (n_tab, 128)
    geo = torch.where(active[:, None, :], clusters[:, :M_BIAS], 0.0)
    bias = clusters[:, M_BIAS]
    cls = torch.where(active, 1.0 + (clusters[:, M_NO_CULL] > 0.0), 0.0)
    planes = torch.stack([
        torch.cat([geo[:, M_E1:M_E1 + 3], bias[:, None]], dim=1),
        torch.cat([geo[:, M_E2:M_E2 + 3], cls[:, None]], dim=1),
        torch.cat([geo[:, M_V0:M_V0 + 3], torch.zeros_like(bias)[:, None]],
                  dim=1),
    ], dim=1)  # (n_tab, 3, 4, 128)
    tris = planes.permute(0, 1, 3, 2).reshape(n_tab, 3 * CLUSTER_SIZE, 4)
    box = _box_float4s(lo, hi, bias, active)
    return torch.cat([tris, box], dim=1).contiguous()


def trace_opaque_mt_blocks(rays8, clusters, visits, counts, entries,
                           cull_backface: bool, stats=None, packed=None,
                           items=None):
    """Closest opaque hit per ray over per-block visit lists of
    128-triangle Moller-Trumbore clusters.

    rays8 (8, B*512) f32; clusters (nc+1, 12, 128) f32; visits (B, nc)
    int32; counts (B,) int32; entries (B, nc) f32. Returns (t biased
    key, tri int32 (-1 miss), u, v, bias), each (B*512,); a miss reports
    t = t_max + 1. stats: as for trace_opaque_blocks, with the pairs
    counted over active triangles (tested) and the stages of the
    Moller-Trumbore test: the determinant, u, v with u + v, t in range.

    CPU tensors take trace_opaque_mt_plain; CUDA tensors launch K3
    (csrc/mt_tracer.cu): the walk of trace_opaque_blocks over the
    scene's pack_mt_clusters table (packed, which a launch on the card
    must be given; items as there)."""
    _check_inputs(rays8, clusters, visits, counts, entries, _MT_TABLE)
    if rays8.device.type == "cpu":
        profiling.count_launch("opaque_mt_launches")
        return trace_opaque_mt_plain(rays8, clusters, visits, counts, entries,
                                     cull_backface)
    out = _launch_opaque("rt64_trace_opaque_mt", PK_FLOAT4S,
                         "pack_mt_clusters", rays8, clusters, visits, counts,
                         entries, cull_backface, stats, packed, items)
    launch_counts.add("opaque_mt_launches")
    return out


def trace_shadow_mt_blocks(rays8, clusters, visits, counts, entries,
                           stats=None, packed=None, items=None):
    """Occlusion per ray over per-block visit lists of 128-triangle
    Moller-Trumbore clusters (never culls). Returns (B*512,) int32
    blocked flags. CPU tensors take trace_shadow_mt_plain; CUDA tensors
    launch K4 (csrc/mt_tracer.cu), the walk of trace_shadow_blocks over
    the scene's pack_mt_clusters table. stats, packed, items: as for
    trace_opaque_mt_blocks."""
    _check_inputs(rays8, clusters, visits, counts, entries, _MT_TABLE)
    if rays8.device.type == "cpu":
        profiling.count_launch("shadow_mt_launches")
        return trace_shadow_mt_plain(rays8, clusters, visits, counts, entries)
    blocked = _launch_shadow("rt64_trace_shadow_mt", PK_FLOAT4S,
                             "pack_mt_clusters", rays8, clusters, visits,
                             counts, entries, stats, packed, items)
    launch_counts.add("shadow_mt_launches")
    return blocked



def _mt_tiles(rays8, counts):
    """Split a launch into runs of blocks of at most _TWIN_TILE_PAIRS
    pairs per visit: yields (b0, b1, rays8 of those blocks)."""
    n_blocks = counts.shape[0]
    step = max(1, _TWIN_TILE_PAIRS // (BLOCK_RAYS * CLUSTER_SIZE))
    blocks = rays8.reshape(8, n_blocks, BLOCK_RAYS)
    for b0 in range(0, n_blocks, step):
        b1 = min(b0 + step, n_blocks)
        yield b0, b1, blocks[:, b0:b1].reshape(8, -1)


def _mt_hit(m, o, d, tmin, tmax, cull_backface: bool):
    """Moller-Trumbore of (B, 1, 12, 128) clusters against
    (3, B, 512, 1) rays, in the operation order of the JAX kernel:
    (hit, t, u, v), each (B, 512, 128)."""
    row = lambda r: m[:, :, r]
    v0x, v0y, v0z = row(M_V0), row(M_V0 + 1), row(M_V0 + 2)
    e1x, e1y, e1z = row(M_E1), row(M_E1 + 1), row(M_E1 + 2)
    e2x, e2y, e2z = row(M_E2), row(M_E2 + 1), row(M_E2 + 2)
    ox, oy, oz = o[0], o[1], o[2]
    dx, dy, dz = d[0], d[1], d[2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    if cull_backface:
        keep = (det > 1e-9) | ((row(M_NO_CULL) > 0.0) & (det < -1e-9))
    else:
        keep = torch.abs(det) > 1e-9
    inv_det = 1.0 / torch.where(keep, det, 1.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (keep & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= tmin) & (t <= tmax) & (row(M_ACTIVE) > 0.0))
    return hit, t, u, v


def trace_opaque_mt_plain(rays8, clusters, visits, counts, entries,
                          cull_backface: bool):
    """K3's plain twin: the same function over (blocks, 512, 128) tiles,
    one visit slot at a time, without the early-out (which never changes
    the result). Same tie rule as the kernel; a ray's carry starts at
    t_max + 1 with no triangle, and only a strictly smaller key takes
    it from there."""
    dev = rays8.device
    col = torch.arange(CLUSTER_SIZE, device=dev)
    outs = []
    for b0, b1, rays in _mt_tiles(rays8, counts):
        cnt, vis = counts[b0:b1], visits[b0:b1]
        o, d, tmin, tmax = _block_rays(rays, b1 - b0)
        best = tmax[..., 0] + 1.0
        best_tid = torch.full_like(best, -1, dtype=torch.int64)
        best_u = torch.zeros_like(best)
        best_v = torch.zeros_like(best)
        best_b = torch.zeros_like(best)
        for i in range(int(cnt.max())):
            cid, m = _visit_cluster(clusters, vis, cnt, i)
            hit, t, u, v = _mt_hit(m, o, d, tmin, tmax, cull_backface)
            bias = m[:, :, M_BIAS]
            key = torch.where(hit, t - bias, _BIG)
            tid = (cid[:, None, None] * CLUSTER_SIZE + col).expand_as(key)
            # This visit's winner per ray: smallest key, then largest id.
            k_min = key.amin(dim=2)
            k_tid = torch.where(key <= k_min[..., None], tid, -1).amax(dim=2)
            at = tid == k_tid[..., None]
            pick = lambda a: torch.where(at, a, 0.0).sum(dim=2)
            take = (k_min < _BIG * 0.5) & (
                (k_min < best)
                | ((k_min == best) & (best_tid >= 0) & (k_tid > best_tid))
            )
            best = torch.where(take, k_min, best)
            best_tid = torch.where(take, k_tid, best_tid)
            best_u = torch.where(take, pick(u), best_u)
            best_v = torch.where(take, pick(v), best_v)
            best_b = torch.where(
                take, pick(torch.broadcast_to(bias, key.shape)), best_b)
        outs.append((best, best_tid.to(torch.int32), best_u, best_v, best_b))
    return tuple(torch.cat([o[k].reshape(-1) for o in outs])
                 for k in range(5))


def trace_shadow_mt_plain(rays8, clusters, visits, counts, entries):
    """K4's plain twin: Moller-Trumbore occlusion over (blocks, 512, 128)
    tiles, one visit slot at a time, without the early-outs."""
    outs = []
    for b0, b1, rays in _mt_tiles(rays8, counts):
        cnt, vis = counts[b0:b1], visits[b0:b1]
        o, d, tmin, tmax = _block_rays(rays, b1 - b0)
        blocked = torch.zeros_like(tmax[..., 0], dtype=torch.bool)
        for i in range(int(cnt.max())):
            _, m = _visit_cluster(clusters, vis, cnt, i)
            hit, _, _, _ = _mt_hit(m, o, d, tmin, tmax, False)
            blocked = blocked | hit.any(dim=2)
        outs.append(blocked.reshape(-1))
    return torch.cat(outs).to(torch.int32)


# ---------------------------------------------------------------------------
# The alpha path's kernels: the cull and the K-hit sweep
# ---------------------------------------------------------------------------


def _contiguous_inputs(dev, inputs):
    """Check (name, tensor, dtype, shape) inputs against a kernel's
    contract (on `dev`, the dtype and shape given) and return their
    contiguous forms, whose pointers the launch takes."""
    out = []
    for name, t, dtype, shape in inputs:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, origins on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a {shape} {dtype} tensor, got "
                             f"{tuple(t.shape)} {t.dtype}")
        out.append(t.contiguous())
    return out


def alpha_cull(origins, dirs, t_min, t_max, lo, hi):
    """The alpha path's bundled slab cull on a CUDA device: (N,) bool, set
    on a live lane (t_max >= t_min) whose bundle of tracer._CULL_BUNDLE
    adjacent lanes, by its interval hull, may meet any of the M boxes lo,
    hi (3, M); N a multiple of the bundle.

    Launches alpha_cull_kernel (csrc/alpha_cull.cu): one thread a bundle,
    its hull and per-axis reciprocals in registers, the boxes staged
    through shared memory without the inverted ones, the walk stopped at
    the first hit, the plain twin's arithmetic operation for operation, so
    the mask equals tracer._slab_any_bundled_plain's bit for bit. No
    (bundles x boxes) tensor is made. Other devices raise."""
    dev = origins.device
    if dev.type != "cuda":
        raise ValueError(f"alpha_cull launches on a CUDA device, not {dev}")
    n, m = origins.shape[1], lo.shape[1]
    if n % tracer._CULL_BUNDLE:
        raise ValueError(f"alpha_cull takes whole {tracer._CULL_BUNDLE}-lane "
                         f"bundles, got {n} lanes")
    keep = _contiguous_inputs(dev, (
        ("origins", origins, torch.float32, (3, n)),
        ("dirs", dirs, torch.float32, (3, n)),
        ("t_min", t_min, torch.float32, (n,)),
        ("t_max", t_max, torch.float32, (n,)),
        ("lo", lo, torch.float32, (3, m)),
        ("hi", hi, torch.float32, (3, m)),
    ))
    mask = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return mask
    o, d, t0, t1, lo_p, hi_p = (t.data_ptr() for t in keep)
    lib = kernel_library().lib
    with torch.cuda.device(dev):  # see _launch_opaque
        err = lib.rt64_alpha_cull(
            o, d, t0, t1, n, lo_p, hi_p, m, mask.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "alpha_cull_kernel")
    launch_counts.add("alpha_cull_launches")
    return mask


MAX_SWEEP_HITS = limits.SceneLimits().max_hit_queries  # the kernel's largest


def alpha_sweep(origins, dirs, t_min, t_max, scene: tracer.TraceScene,
                k_alpha: int, cull_backface: bool):
    """The K nearest alpha-class hits per ray over the scene's compacted
    alpha list, on a CUDA device: (t_biased (N, K), tri (N, K) int64,
    uv (N, K, 2), bias (N, K)), ascending by biased key; among equal keys
    the later list position comes first; misses read _BIG, -1, 0 and 0.

    Launches alpha_sweep_kernel (csrc/alpha_sweep.cu): one thread per
    ray with a K-slot insertion list in registers, the list staged
    through shared memory, the plain twin's arithmetic operation for
    operation, so every output equals tracer._alpha_sweep_plain's bit for
    bit. No (rays x list) tensor is made. Other devices raise."""
    dev = origins.device
    if dev.type != "cuda":
        raise ValueError(f"alpha_sweep launches on a CUDA device, not {dev}")
    if not 1 <= k_alpha <= MAX_SWEEP_HITS:
        raise ValueError(f"k_alpha must be in [1, {MAX_SWEEP_HITS}], "
                         f"got {k_alpha}")
    n = origins.shape[1]
    n_tri = scene.num_triangles
    inputs = (
        ("origins", origins, torch.float32, (3, n)),
        ("dirs", dirs, torch.float32, (3, n)),
        ("t_min", t_min, torch.float32, (n,)),
        ("t_max", t_max, torch.float32, (n,)),
        ("v0", scene.v0, torch.float32, (3, n_tri)),
        ("v1", scene.v1, torch.float32, (3, n_tri)),
        ("v2", scene.v2, torch.float32, (3, n_tri)),
        ("no_cull", scene.no_cull, torch.bool, (n_tri,)),
        ("bias", scene.bias, torch.float32, (n_tri,)),
        ("alpha_idx", scene.alpha_idx, torch.int64,
         (scene.alpha_idx.shape[0],)),
    )
    keep = _contiguous_inputs(dev, inputs)  # the pointers' tensors
    ptrs = [t.data_ptr() for t in keep]
    k = k_alpha
    t_out = torch.empty((n, k), dtype=torch.float32, device=dev)
    tri = torch.empty((n, k), dtype=torch.int64, device=dev)
    uv = torch.empty((n, k, 2), dtype=torch.float32, device=dev)
    bias = torch.empty((n, k), dtype=torch.float32, device=dev)
    if n == 0:
        return t_out, tri, uv, bias
    (o, d, t0, t1, v0, v1, v2, no_cull, bias_in, alpha_idx) = ptrs
    lib = kernel_library().lib
    with torch.cuda.device(dev):  # see _launch_opaque
        err = lib.rt64_alpha_sweep(
            o, d, t0, t1, n, v0, v1, v2, no_cull, bias_in, n_tri, alpha_idx,
            scene.alpha_idx.shape[0], k, int(bool(cull_backface)),
            t_out.data_ptr(), tri.data_ptr(), uv.data_ptr(), bias.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "alpha_sweep_kernel")
    launch_counts.add("alpha_sweep_launches")
    return t_out, tri, uv, bias


# ---------------------------------------------------------------------------
# The hit shader
# ---------------------------------------------------------------------------

# Variant bits of rt64_hit_shade (csrc/hit_shade.cu): the kernel's
# template flags, then the layouts of the mip level's planes.
HIT_SHADOW, HIT_TEXEL1, HIT_NORMAL_MAPS, HIT_SPECULAR_MAPS, HIT_MIPS = (
    1, 2, 4, 8, 16)
HIT_DIR_LANE_MAJOR, HIT_DDX_LANE_MAJOR, HIT_DDY_LANE_MAJOR = 32, 64, 128
_INT_MAX = 2**31 - 1


def _lane_major(plane) -> bool:
    """Whether ATen lays out what it computes from a (3, M) plane
    lane-major (strides (1, 3)), and so sums the plane's dot products in
    another order (csrc/hit_shade.cu, dot_lane_major)."""
    return plane.shape[1] > 1 and plane.stride(0) < plane.stride(1)


def hit_shade(sb, tri_rows, ray_dir, tri, bary_u, bary_v, noise_rand,
              shadow_variant: bool = False, mip_args=None):
    """shading.shade_hits on a CUDA device, in one launch of
    hit_shade_kernel (csrc/hit_shade.cu): (color (4, M), normal (3, M),
    specular (3, M), flow (3, M), instance (M,) int32, rows_t (TROW, M)),
    the planes of shading.HitShade but its tri. The shadow variant's
    normal, specular and flow are one zero plane, as in the plain version.

    The kernel follows shading.shade_hits_plain operation for operation
    in float32, every product and sum rounded on its own, and sums each
    three-term dot product in the order ATen's reduction takes for the
    plane's layout (the variant's lane-major bits), so the planes equal
    the plain version's on the card bit for bit
    (tests/test_torch_hit_shade.py). The per-lane inputs may be strided
    views; tri is int32 or int64. Raises on a dtype, shape or device the
    kernel does not take, CPU tensors included."""
    m = tri.shape[0] if tri.dim() == 1 else -1
    feat = sb.features
    mips = mip_args is not None and feat.has_mips and not shadow_variant
    pool = sb.quad_pool
    f32 = (torch.float32,)
    lanes = [("ray_dir", ray_dir, f32, (3, m)),
             ("tri", tri, (torch.int32, torch.int64), (m,)),
             ("bary_u", bary_u, f32, (m,)), ("bary_v", bary_v, f32, (m,)),
             ("noise_rand", noise_rand, f32, (m,))]
    if mips:
        t_hit, d_ddx, d_ddy = mip_args
        lanes += [("t", t_hit, f32, (m,)), ("d_ddx", d_ddx, f32, (3, m)),
                  ("d_ddy", d_ddy, f32, (3, m))]
    if m < 0:
        raise ValueError(f"tri must be a (M,) tensor, got {tuple(tri.shape)}")
    for name, t, dtypes, shape in lanes:
        if t.dtype not in dtypes or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a {shape} tensor of {dtypes}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if any(st > _INT_MAX for st in t.stride()):
            raise ValueError(f"{name}'s strides {t.stride()} pass 32 bits")
    wide = pool.dim() == 2 and pool.shape[1] == 4 * tex_ops.QPR
    whole = [("tri_rows", tri_rows, torch.float32,
              tri_rows.dim() == 2 and tri_rows.shape[0] >= 1
              and tri_rows.shape[1] == R.TROW, f"(T >= 1, {R.TROW})"),
             ("quad_pool", pool, torch.int64,
              wide or (pool.dim() == 2 and pool.shape[1] == 4),
              f"(P / {tex_ops.QPR}, {4 * tex_ops.QPR}) or (P, 4)")]
    for name, t, dtype, shaped, want in whole:
        if t.dtype != dtype or not shaped or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {want} {dtype} "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
    quads = tex_ops.pool_quad_count(pool)
    if not 1 <= quads <= _INT_MAX or tri_rows.shape[0] > _INT_MAX:
        raise ValueError(f"quad_pool holds {quads} quads, tri_rows "
                         f"{tri_rows.shape[0]} rows: 1 to 2**31 - 1 each")
    dev = tri.device
    for name, t, *_ in lanes + whole:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, tri on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"hit_shade launches on a CUDA device, not {dev}")

    plane = lambda rows: torch.empty((rows, m), dtype=torch.float32, device=dev)
    color, normal, rows_t = plane(4), plane(3), plane(R.TROW)
    specular, flow = (normal, normal) if shadow_variant else (plane(3), plane(3))
    instance = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return color, normal, specular, flow, instance, rows_t
    variant = ((HIT_SHADOW if shadow_variant else 0)
               | (HIT_TEXEL1 if feat.has_texel1 else 0)
               | (HIT_NORMAL_MAPS if feat.has_normal_maps else 0)
               | (HIT_SPECULAR_MAPS if feat.has_specular_maps else 0)
               | (HIT_MIPS if mips else 0)
               | (HIT_DIR_LANE_MAJOR if _lane_major(ray_dir) else 0))
    if mips:
        # torch.zeros_like keeps only a dense plane's layout (raydiff.propagate).
        dense = lambda d: d.shape[1] > 1 and d.stride() == (1, 3)
        variant |= ((HIT_DDX_LANE_MAJOR if dense(d_ddx) else 0)
                    | (HIT_DDY_LANE_MAJOR if dense(d_ddy) else 0))
    none = (None, 0, 0)
    planar = lambda t: (t.data_ptr(), t.stride(0), t.stride(1))
    t_args = (t_hit.data_ptr(), t_hit.stride(0)) if mips else (None, 0)
    lib = kernel_library().lib
    with torch.cuda.device(dev):  # see _launch_opaque
        err = lib.rt64_hit_shade(
            tri_rows.data_ptr(), tri_rows.shape[0], tri.data_ptr(),
            int(tri.dtype == torch.int64), tri.stride(0),
            bary_u.data_ptr(), bary_u.stride(0),
            bary_v.data_ptr(), bary_v.stride(0),
            noise_rand.data_ptr(), noise_rand.stride(0), *planar(ray_dir),
            *t_args, *(planar(d_ddx) if mips else none),
            *(planar(d_ddy) if mips else none), pool.data_ptr(), quads,
            int(wide), m, variant, color.data_ptr(), normal.data_ptr(),
            specular.data_ptr(), flow.data_ptr(), instance.data_ptr(),
            rows_t.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "hit_shade_kernel")
    launch_counts.add("hit_shade_launches")
    return color, normal, specular, flow, instance, rows_t


# ---------------------------------------------------------------------------
# Regrouping incoherent rays into coherent blocks
# ---------------------------------------------------------------------------


def _regroup_order(origins, dirs, t_min, t_max, mode: str):
    """Ray order that packs coherent rays into the same 512-ray blocks:
    (order, inverse), both (N,) int64.

    Incoherent populations defeat the per-block cluster cull. mode
    "dir": direction octant + 4x4 dominant-axis cell (hemisphere bounce
    rays: scattered directions, coherent origins). mode "origin": origin
    cell in the live rays' box + direction octant (bounce-point shadow
    rays: scattered origins). Dead rays (empty interval) sort last, so
    live blocks stay dense and dead blocks visit nothing. The sort is
    stable, so the order is repeatable. Results are bit-identical either
    way: every kernel decision below block granularity is per ray, and
    the tie rule does not depend on the visit order."""
    live = t_max >= t_min
    oct_ = ((dirs[0] >= 0).to(torch.int32)
            + 2 * (dirs[1] >= 0).to(torch.int32)
            + 4 * (dirs[2] >= 0).to(torch.int32))
    if mode == "dir":
        dom = torch.clamp(torch.abs(dirs).amax(dim=0), min=1e-6)
        u = torch.clamp((dirs[0] / dom * 0.5 + 0.5) * 4.0, 0.0, 3.0)
        v = torch.clamp((dirs[1] / dom * 0.5 + 0.5) * 4.0, 0.0, 3.0)
        key = oct_ * 16 + u.to(torch.int32) * 4 + v.to(torch.int32)
    else:
        assert mode == "origin", mode
        lo = torch.where(live[None], origins, _BIG).amin(dim=1)
        hi = torch.where(live[None], origins, -_BIG).amax(dim=1)
        span = torch.clamp(hi - lo, min=1e-6)
        q = torch.clamp(
            (origins - lo[:, None]) / span[:, None] * 8.0, 0.0, 7.0
        ).to(torch.int32)
        key = ((q[0] * 8 + q[1]) * 8 + q[2]) * 8 + oct_
    key = torch.where(live, key, 1 << 20)
    order = torch.argsort(key, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return order, inv


def _regrouped(base_fn, mode: str):
    """Wrap an opaque_fn: permute rays into coherent blocks, trace,
    inverse-permute the results."""

    def fn(origins, dirs, t_min, t_max, scene, cull_backface=True, chunk=0):
        order, inv = _regroup_order(origins, dirs, t_min, t_max, mode)
        t, tri, uv, bias = base_fn(
            origins[:, order], dirs[:, order], t_min[order], t_max[order],
            scene, cull_backface, chunk,
        )
        return t[inv], tri[inv], uv[inv], bias[inv]

    return fn


# ---------------------------------------------------------------------------
# opaque_fn hooks for ops/tracer.py
# ---------------------------------------------------------------------------


class PacketInputs(NamedTuple):
    """One launch's kernel inputs (the host-side prep of a trace)."""

    rays8: torch.Tensor
    clusters: torch.Tensor
    visits: torch.Tensor
    counts: torch.Tensor
    entries: torch.Tensor
    n: int  # real rays (the rest of rays8 is padding)
    mt: bool  # the 128-triangle MT table (K3/K4), else the Woop table
    packed: torch.Tensor | None = None  # the kernel-side table (card only)


def _pad_to_blocks(origins, dirs, t_min, t_max):
    """Pad rays to a BLOCK_RAYS multiple; padded rays get t_max = -1
    (an empty interval: dead)."""
    n = origins.shape[1]
    pad = (-n) % BLOCK_RAYS
    if not pad:
        return origins, dirs, t_min, t_max
    z = lambda a: torch.zeros(a.shape[:-1] + (pad,), dtype=a.dtype,
                              device=a.device)
    return (torch.cat([origins, z(origins)], dim=1),
            torch.cat([dirs, z(dirs)], dim=1),
            torch.cat([t_min, z(t_min)]),
            torch.cat([t_max, z(t_max) - 1.0]))


class SceneTables(NamedTuple):
    """What a launch needs of the scene alone (not of its rays)."""

    resident: bool  # the size switch's answer
    lo: torch.Tensor  # cluster boxes at the switch's granularity
    hi: torch.Tensor
    table: torch.Tensor  # Woop (resident) or Moller-Trumbore cluster table
    packed: torch.Tensor | None  # the kernels' repacked table (card only)


# Devices whose launches read the kernel-side tables (the CPU twins read
# the cluster tables themselves).
_PACKED_ON = ("cuda",)


def _scene_tables(scene) -> SceneTables:
    """Ask the size switch and build the scene's boxes and cluster
    tables. A frame traces one scene several times (primary, shadow and
    bounce launches), so the tables are kept with the scene: as an
    attribute of its v0 tensor, so that they are freed with it. They are
    reused while the caller passes the very same tensors and none of
    them has been written to since. A build (a miss) runs in the span
    `rt64.trace.tables`."""
    tensors = (scene.v0, scene.v1, scene.v2, scene.valid, scene.alpha,
               scene.no_cull, scene.bias)
    stamp = (RESIDENT_TABLE_BYTES,) + tuple(t._version for t in tensors)
    memo = getattr(scene.v0, "_rt64_scene_tables", None)
    if (memo is not None and memo[1] == stamp
            and all(ref() is t for ref, t in zip(memo[0], tensors))):
        return memo[2]
    with profiling.span("rt64.trace.tables"):
        resident = clusters_resident(scene.num_triangles)
        lo, hi = build_cluster_boxes(scene,
                                     K_CS if resident else CLUSTER_SIZE)
        build = build_cluster_mats if resident else build_cluster_data
        table = build(scene)
        packed = None
        if table.device.type in _PACKED_ON:
            pack = pack_woop_clusters if resident else pack_mt_clusters
            packed = pack(table, lo, hi)
    tables = SceneTables(resident, lo, hi, table, packed)
    scene.v0._rt64_scene_tables = (
        tuple(weakref.ref(t) for t in tensors), stamp, tables)
    return tables


def _packet_inputs(origins_p, dirs_p, t_min_p, t_max_p, n,
                   tables: SceneTables, bias_max=0.0) -> PacketInputs:
    """Visit lists of one launch of padded rays, with the scene's tables."""
    rays8 = torch.cat(
        [origins_p, dirs_p, t_min_p[None], t_max_p[None]], dim=0
    ).contiguous()
    visits, counts, entries = block_visit_lists(
        origins_p, dirs_p, t_min_p, t_max_p, tables.lo, tables.hi,
        bias_max=bias_max,
        group_clusters=(2 * GROUP_CLUSTERS if tables.resident
                        else GROUP_CLUSTERS),
    )
    return PacketInputs(rays8, tables.table, visits, counts, entries, n,
                        not tables.resident, tables.packed)


def prepare_opaque(origins, dirs, t_min, t_max, scene) -> PacketInputs:
    """Host-side prep of a K1 or K3 launch (by the size switch): pad,
    clamp t_max at the scene-box exit, build the cluster table and the
    visit lists."""
    n = origins.shape[1]
    origins_p, dirs_p, t_min_p, t_max_p = _pad_to_blocks(
        origins, dirs, t_min, t_max
    )
    tables = _scene_tables(scene)
    lo, hi = tables.lo, tables.hi
    # Clamp each ray's t_max to its scene-box exit: rays that leave the
    # geometry stop gating the packet early-out, and rays that miss the
    # scene visit nothing. Misses are tri == -1, so results never change.
    glo = lo.amin(dim=1)
    ghi = hi.amax(dim=1)
    g_lo = torch.full_like(t_min_p, -_BIG)
    g_hi = torch.full_like(t_min_p, _BIG)
    for c in range(3):
        d = dirs_p[c]
        par = torch.abs(d) <= 1e-12
        idir = 1.0 / torch.where(~par, d, 1.0)
        ta = (glo[c] - origins_p[c]) * idir
        tb = (ghi[c] - origins_p[c]) * idir
        g_lo = torch.maximum(g_lo, torch.where(par, -_BIG, torch.minimum(ta, tb)))
        g_hi = torch.minimum(g_hi, torch.where(par, _BIG, torch.maximum(ta, tb)))
    g_hi = g_hi + torch.abs(g_hi) * 1e-5 + 1e-4  # never clip boundary hits
    in_box = (g_lo <= g_hi) & (g_hi >= t_min_p)
    t_max_k = torch.where(in_box, torch.minimum(t_max_p, g_hi), t_min_p - 1.0)

    bias_max = torch.where(scene.valid & ~scene.alpha, scene.bias, 0.0).amax()
    return _packet_inputs(origins_p, dirs_p, t_min_p, t_max_k, n, tables,
                          bias_max=bias_max)


def prepare_shadow(origins, dirs, t_min, t_max, scene) -> PacketInputs:
    """Host-side prep of a K2 or K4 launch (by the size switch): pad,
    build the cluster table and the visit lists (shadow rays keep their
    own t_max)."""
    n = origins.shape[1]
    origins_p, dirs_p, t_min_p, t_max_p = _pad_to_blocks(
        origins, dirs, t_min, t_max
    )
    return _packet_inputs(origins_p, dirs_p, t_min_p, t_max_p, n,
                          _scene_tables(scene))


def make_opaque_fn(regroup=None):
    """opaque_fn for tracer.trace / trace_opaque_only: K1 or K3 (by the
    size switch) behind the packet prep. Returns (t biased (BIG on a
    miss), tri, uv (N, 2), bias). regroup ("dir" / "origin" / None):
    sort incoherent rays into coherent blocks first (_regroup_order)."""

    def opaque_fn(origins, dirs, t_min, t_max, scene, cull_backface=True,
                  chunk=0):
        del chunk
        p = prepare_opaque(origins, dirs, t_min, t_max, scene)
        trace = trace_opaque_mt_blocks if p.mt else trace_opaque_blocks
        t, tri, u, v, bias = trace(p.rays8, p.clusters, p.visits, p.counts,
                                   p.entries, cull_backface, packed=p.packed)
        n = p.n
        tri = tri[:n]
        t = torch.where(tri >= 0, t[:n], _BIG)
        return t, tri, torch.stack([u[:n], v[:n]], dim=-1), bias[:n]

    return _regrouped(opaque_fn, regroup) if regroup else opaque_fn


def make_shadow_opaque_fn(regroup=None):
    """opaque_fn for shadow traces: K2 or K4 (by the size switch) behind
    the packet prep, in trace_opaque's shape contract: tri = 0 when
    blocked (-1 otherwise), t = 0/BIG, uv and bias 0. regroup: as for
    make_opaque_fn."""

    def opaque_fn(origins, dirs, t_min, t_max, scene, cull_backface=False,
                  chunk=0):
        del chunk, cull_backface  # shadows never cull
        p = prepare_shadow(origins, dirs, t_min, t_max, scene)
        trace = trace_shadow_mt_blocks if p.mt else trace_shadow_blocks
        blocked = trace(p.rays8, p.clusters, p.visits, p.counts, p.entries,
                        packed=p.packed)
        blocked = blocked[: p.n] > 0
        n = p.n
        dev = origins.device
        t = torch.where(blocked, 0.0, _BIG)
        tri = torch.where(blocked, 0, -1).to(torch.int32)
        return (t, tri, torch.zeros((n, 2), device=dev),
                torch.zeros((n,), device=dev))

    return _regrouped(opaque_fn, regroup) if regroup else opaque_fn
