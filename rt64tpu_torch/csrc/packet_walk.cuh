// The walk that all four packet-traversal kernels share: work items on a
// persistent grid, the asynchronous cluster ring, per-ray cluster culling
// and dense warp tasks. Templated on the cluster table's layout and pair
// test (`Cl`): WoopClusters (K1/K2, 64-triangle Woop clusters,
// packet_tracer.cu) and MtClusters (K3/K4, 128-triangle Moller-Trumbore
// clusters, mt_tracer.cu). Each source instantiates its own layout.
//
// Inputs. Rays are planar rays8 (8, N): origin xyz, direction xyz, t_min,
// t_max, in blocks of 512. Every block has a row of the visit tables:
// visits (cluster ids front-to-back), counts, entries (conservative
// entry distance per visit, already lowered by the scene's max depth
// bias). The kernels read a kernel-side cluster table of Cl::FLOAT4S
// float4 per cluster: Cl::TRIS triangles' operands, then at Cl::BOX the
// cluster's box as {lo.xyz, the cluster's largest depth bias} and
// {hi.xyz, 0}; an empty cluster's box is inverted.
//
// Design (what bounds the kernels and what it does about it: see the
// sources' head comments for each layout's numbers):
//
// 1. Work items on a persistent grid. Every block's list is cut into
//    slices of at most SLICE_VISITS visits; the (block, slice) items are
//    ordered slice-major, so a block's front slices start before its back
//    slices (prologue_kernel builds the table, build_work_items in
//    ops/tracer_cuda.py is its twin). A launch runs SMs x resident CTAs
//    and every CTA pulls items from a global counter until none is left,
//    so a long list runs on many CTAs at once.
//    Shadow launches merge through blocked_out (zero-filled by the
//    launch's prologue): a slice that blocks a ray stores 1; every writer
//    writes the same value. Closest-hit launches merge through one packed 64-bit
//    word per ray: high word the biased key mapped to an order-preserving
//    unsigned (with -0.0 made +0.0), low word ~triangle id, combined with
//    atomicMin. That keeps the smallest key and, among equal keys, the
//    largest id: the tie rule. A ray starts at pack(t_max + 1, id -1),
//    whose low word 0 wins every tie, so only a strictly smaller key
//    takes a ray from its miss state. A final pass decodes key and id and
//    recomputes u, v and the bias from the winning triangle with the
//    walk's own arithmetic. min is associative and commutative, so NO
//    RESULT DEPENDS ON THE ORDER IN WHICH ITEMS (or the tasks below) RUN:
//    what one reads of the others' results (the packed word, the blocked
//    flag) only prunes pairs that cannot change the result.
// 2. A ring of RING_STAGES clusters in shared memory. A producer warp
//    starts one cp.async.bulk per visit, completed on the stage's `full`
//    mbarrier; each consumer warp arrives on the stage's `empty` mbarrier
//    when it is done with it, so the loads of the next visits fly while
//    this one is tested.
// 3. Culling per ray, work per warp. An item walks only the visits whose
//    entry lies within the block's current bound (closest hit: the
//    largest best key; shadow: the largest t_max of an unblocked ray). Per
//    visit every thread puts its own ray to the slab test against the
//    cluster's box (the test of tracer.slab_per_ray, with the same
//    widening; a closest-hit ray also drops out when its box entry minus
//    the cluster's largest bias lies beyond its best key, a shadow ray
//    when it is blocked). The rays that enter are gathered into a dense
//    list, and list x triangles is cut into warp tasks of 32 rays x 8 or
//    16 triangles dealt to all 16 warps: a cluster that 50 of the 512
//    rays enter costs 2 warps' worth of pair tests, not 16. The rays live
//    in shared memory for that. A skip removes only pairs that cannot
//    hit.
// 4. The pair test reads broadcast 16-byte operands and pins every
//    product and sum (__fmul_rn, __fmaf_rn, in the order of the plain
//    twin's expressions), so the walk, its counting instantiation and the
//    final pass give the same bits by construction.
//
// Each kernel has a STATS instantiation (see work_stats.cuh), launched
// when the caller passes a stats buffer; it returns the production
// launch's outputs bit for bit.
//
// The layout interface (`Cl`): TRIS, FLOAT4S, BOX, and
//   opaque<STATS, CULL>(cl, j, ray, key, work): triangle j of the staged
//     cluster against the ray; true on a hit in [t_min, t_max] that the
//     culling rule keeps (backfaces culled with CULL), with its biased
//     key;
//   shadow<STATS>(cl, j, ray, work): true on an occluding hit (never
//     culls);
//   hit_attributes(cl, j, ray, u, v, bias): u, v and the bias of a hit
//     that opaque() found, by the same arithmetic.
// Both tests count, in a STATS launch, the pairs tested (work.n[0]) and
// those past each of their early returns (work.n[1..4]).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "work_stats.cuh"

namespace {

constexpr int BLOCK_RAYS = 512;
constexpr int CONSUMER_THREADS = BLOCK_RAYS;  // a ray per thread
constexpr int CONSUMER_WARPS = CONSUMER_THREADS / 32;
constexpr int CTA_THREADS = CONSUMER_THREADS + 32;  // + the producer warp
constexpr int SLICE_VISITS = 16;  // tracer_cuda.SLICE_VISITS
constexpr int RING_STAGES = 4;
constexpr int MIN_CTAS = 2;  // resident CTAs per SM the registers must allow
constexpr float BIG = 3.0e37f;  // tracer._BIG
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// mbarrier and bulk-copy primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed. A
// wait that never ends is a bug in the ring; it traps instead of hanging
// the card, after 2^30 polls: minutes, far beyond any visit, a preempted
// context or a slow counting launch.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (spins > (1u << 30)) __trap();
  }
}

// One bulk copy global -> shared, completed on `bar` (1-D TMA).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// The packed (key, triangle id) word of the closest-hit merge
// ---------------------------------------------------------------------------

// Order-preserving map of a float to an unsigned: flip all bits of a
// negative, set the sign bit of a non-negative. -0.0 becomes +0.0 first:
// the tie rule compares keys with ==.
__device__ __forceinline__ uint32_t key_bits(float key) {
  const uint32_t b = __float_as_uint(key == 0.0f ? 0.0f : key);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float bits_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ unsigned long long pack_hit(float key, int tid) {
  return ((unsigned long long)key_bits(key) << 32)
         | (unsigned long long)(~(uint32_t)tid);
}

__device__ __forceinline__ float packed_key(unsigned long long p) {
  return bits_key((uint32_t)(p >> 32));
}

__device__ __forceinline__ int packed_tid(unsigned long long p) {
  return (int)(~(uint32_t)p);
}

// ---------------------------------------------------------------------------
// Rays and the slab test
// ---------------------------------------------------------------------------

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
  float ix, iy, iz;  // 1 / direction; unused where the ray is parallel
};

__device__ __forceinline__ float inv_dir(float d) {
  return __fdiv_rn(1.0f, fabsf(d) > 1e-12f ? d : 1.0f);
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays8,
                                        size_t n_rays, size_t r) {
  Ray ray;
  ray.ox = rays8[0 * n_rays + r];
  ray.oy = rays8[1 * n_rays + r];
  ray.oz = rays8[2 * n_rays + r];
  ray.dx = rays8[3 * n_rays + r];
  ray.dy = rays8[4 * n_rays + r];
  ray.dz = rays8[5 * n_rays + r];
  ray.tmin = rays8[6 * n_rays + r];
  ray.tmax = rays8[7 * n_rays + r];
  ray.ix = inv_dir(ray.dx);
  ray.iy = inv_dir(ray.dy);
  ray.iz = inv_dir(ray.dz);
  return ray;
}

// One axis of the slab test (tracer.slab_per_ray): a (near-)parallel axis
// constrains nothing.
__device__ __forceinline__ void slab_axis(float o, float d, float inv,
                                          float lo, float hi, float& t_lo,
                                          float& t_hi) {
  const bool par = fabsf(d) <= 1e-12f;
  const float ta = __fmul_rn(__fsub_rn(lo, o), inv);
  const float tb = __fmul_rn(__fsub_rn(hi, o), inv);
  t_lo = fmaxf(t_lo, par ? -BIG : fminf(ta, tb));
  t_hi = fminf(t_hi, par ? BIG : fmaxf(ta, tb));
}

// The conservative slab test of tracer.slab_per_ray against one box:
// true when the widened slab interval meets [t_min, t_max]; `entry` is
// the widened entry distance. The caller has checked the box is not
// inverted.
__device__ __forceinline__ bool slab_enters(const Ray& r, const float4& lo,
                                            const float4& hi, float& entry) {
  float t_lo = -INFINITY, t_hi = INFINITY;
  slab_axis(r.ox, r.dx, r.ix, lo.x, hi.x, t_lo, t_hi);
  slab_axis(r.oy, r.dy, r.iy, lo.y, hi.y, t_lo, t_hi);
  slab_axis(r.oz, r.dz, r.iz, lo.z, hi.z, t_lo, t_hi);
  t_lo = __fsub_rn(__fsub_rn(t_lo, __fmul_rn(fabsf(t_lo), 1e-5f)), 1e-4f);
  t_hi = __fadd_rn(__fadd_rn(t_hi, __fmul_rn(fabsf(t_hi), 1e-5f)), 1e-4f);
  entry = t_lo;
  return t_lo <= t_hi && t_hi >= r.tmin && t_lo <= r.tmax;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  }
  return v;
}

// ---------------------------------------------------------------------------
// The item loop's shared state: the ring, the slice's visits, the rays
// ---------------------------------------------------------------------------

template <class Cl>
struct Shared {
  float4 ring[RING_STAGES * Cl::FLOAT4S];
  uint64_t full[RING_STAGES];
  uint64_t empty[RING_STAGES];
  // The block's rays, planar: origin, direction, t_min, t_max.
  float rays[8][BLOCK_RAYS];
  union {
    unsigned long long best[BLOCK_RAYS];  // closest hit: the merge words
    int flag[BLOCK_RAYS];                 // shadow: RAY_OPEN / _HIT / _CLOSED
  };
  // Rays that enter the staged cluster's box, per visit (two visits may
  // be in flight), and their number (three, so that one can be reset
  // while its neighbours are written and read).
  unsigned short list[2][BLOCK_RAYS];
  int n_in[3];
  int cid[SLICE_VISITS];
  float entry[SLICE_VISITS];
  float warp_bound[CONSUMER_WARPS];
  int item;
};

constexpr int RAY_OPEN = 0;    // live and not known to be blocked
constexpr int RAY_HIT = 1;     // blocked by this item
constexpr int RAY_CLOSED = 2;  // dead, or blocked before this item began

struct Item {
  int block, start, len;
};

template <class Cl>
__device__ __forceinline__ void ring_init(Shared<Cl>& s) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < RING_STAGES; ++k) {
      mbar_init(&s.full[k], 1);
      mbar_init(&s.empty[k], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// A barrier of the consumer warps alone (the producer warp runs ahead).
__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_THREADS) : "memory");
}

// Pull the next work item (CTA-uniform); false when none is left. The
// barrier inside also separates one item's use of the shared arrays from
// the next item's writes. In a STATS launch thread 0 charges the cycles
// since the previous pull to the previous item's block.
template <bool STATS, class Cl>
__device__ __forceinline__ bool next_item(
    Shared<Cl>& s, const int* __restrict__ items,
    const int* __restrict__ n_items, int* counter,
    const int* __restrict__ counts, int n_blocks,
    unsigned long long* __restrict__ stats, long long& clock0, Item& it) {
  if (threadIdx.x == 0) s.item = atomicAdd(counter, 1);
  __syncthreads();
  if (STATS && threadIdx.x == 0) {
    const long long now = clock64();
    if (clock0 != 0) {
      unsigned long long* row = stats + (size_t)it.block * STATS_COLS;
      const unsigned long long span = (unsigned long long)(now - clock0);
      atomicAdd(row + STAT_CYCLES, span);
      atomicMax(row + STAT_ITEM_CYCLES, span);
    }
    clock0 = now;
  }
  const int k = s.item;
  if (k >= *n_items) return false;
  // An item is the code slice * n_blocks + block (build_work_items).
  it.block = items[k] % n_blocks;
  it.start = (items[k] / n_blocks) * SLICE_VISITS;
  it.len = min(SLICE_VISITS, counts[it.block] - it.start);
  return true;
}

// Stage the slice's cluster ids and entries and reset the per-visit
// counts (before the item's second barrier).
template <class Cl>
__device__ __forceinline__ void load_slice(
    Shared<Cl>& s, const Item& it, const int* __restrict__ visits,
    const float* __restrict__ entries, int n_cols, int n_tab) {
  const int k = threadIdx.x;
  if (k < it.len) {
    const size_t at = (size_t)it.block * n_cols + it.start + k;
    s.cid[k] = min(max(visits[at], 0), n_tab - 1);
    s.entry[k] = entries[at];
  }
  if (k < 3) s.n_in[k] = 0;
}

// The consumer's own ray: into registers (with 1 / direction for the slab
// test) and into the shared planes (for whichever thread tests it).
template <class Cl>
__device__ __forceinline__ Ray own_ray(Shared<Cl>& s,
                                       const float* __restrict__ rays8,
                                       size_t n_rays, size_t r) {
  const Ray ray = load_ray(rays8, n_rays, r);
  const int t = threadIdx.x;
  s.rays[0][t] = ray.ox;
  s.rays[1][t] = ray.oy;
  s.rays[2][t] = ray.oz;
  s.rays[3][t] = ray.dx;
  s.rays[4][t] = ray.dy;
  s.rays[5][t] = ray.dz;
  s.rays[6][t] = ray.tmin;
  s.rays[7][t] = ray.tmax;
  return ray;
}

template <class Cl>
__device__ __forceinline__ Ray shared_ray(const Shared<Cl>& s, int t) {
  Ray ray;
  ray.ox = s.rays[0][t];
  ray.oy = s.rays[1][t];
  ray.oz = s.rays[2][t];
  ray.dx = s.rays[3][t];
  ray.dy = s.rays[4][t];
  ray.dz = s.rays[5][t];
  ray.tmin = s.rays[6][t];
  ray.tmax = s.rays[7][t];
  return ray;
}

// After the item's second barrier: the block's bound and the number of
// leading visits (entries ascend) that lie within it.
template <class Cl>
__device__ __forceinline__ int visits_within(const Shared<Cl>& s,
                                             const Item& it) {
  float bound = s.warp_bound[0];
  for (int k = 1; k < CONSUMER_WARPS; ++k) bound = fmaxf(bound, s.warp_bound[k]);
  int n = 0;
  while (n < it.len && s.entry[n] <= bound) ++n;
  return n;
}

// The producer warp's part of an item: lane 0 starts one bulk copy per
// visit into the ring, waiting for a stage's previous use to be released.
// `g` counts the visits this CTA has staged so far, over all items.
template <class Cl>
__device__ __forceinline__ void produce(Shared<Cl>& s,
                                        const float4* __restrict__ table,
                                        unsigned g, int n_vis) {
  if ((threadIdx.x & 31) != 0) return;
  constexpr uint32_t bytes = Cl::FLOAT4S * 16;
  for (int i = 0; i < n_vis; ++i, ++g) {
    const unsigned stage = g % RING_STAGES, use = g / RING_STAGES;
    if (use > 0) mbar_wait(&s.empty[stage], (use - 1) & 1);
    mbar_expect_tx(&s.full[stage], bytes);
    bulk_load(s.ring + stage * Cl::FLOAT4S,
              table + (size_t)s.cid[i] * Cl::FLOAT4S, bytes, &s.full[stage]);
  }
}

template <class Cl>
__device__ __forceinline__ const float4* consumer_wait(Shared<Cl>& s,
                                                       unsigned g) {
  const unsigned stage = g % RING_STAGES;
  mbar_wait(&s.full[stage], (g / RING_STAGES) & 1);
  return s.ring + stage * Cl::FLOAT4S;
}

template <class Cl>
__device__ __forceinline__ void consumer_release(Shared<Cl>& s, unsigned g) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&s.empty[g % RING_STAGES]);
}

__device__ __forceinline__ bool box_valid(const float4& lo, const float4& hi) {
  return lo.x <= hi.x && lo.y <= hi.y && lo.z <= hi.z;
}

// Visit i, first half: every consumer thread has decided whether its own
// ray enters the staged cluster (`in`); the rays that do are gathered
// into the visit's list (in no particular order: nothing depends on it).
// Returns after the consumers' barrier with the number of listed rays.
template <class Cl>
__device__ __forceinline__ int gather_rays(Shared<Cl>& s, int i, bool in) {
  const unsigned lane = threadIdx.x & 31;
  // The count two visits on: its last readers passed the previous
  // barrier, its next writers wait for this one.
  if (threadIdx.x == 0) s.n_in[(i + 1) % 3] = 0;
  const unsigned ballot = __ballot_sync(FULL, in);
  if (ballot != 0) {
    int base = 0;
    if (lane == 0) base = atomicAdd(&s.n_in[i % 3], __popc(ballot));
    base = __shfl_sync(FULL, base, 0);
    if (in) {
      s.list[i & 1][base + __popc(ballot & ((1u << lane) - 1))] =
          (unsigned short)threadIdx.x;
    }
  }
  consumer_barrier();
  return s.n_in[i % 3];
}

// Visit i, second half: the listed rays x the cluster's triangles are cut
// into warp tasks of 32 rays x (Cl::TRIS / chunks) triangles, so that all
// warps share the visit's work however few rays entered the cluster
// (task sizes of 8 to 32 triangles timed the same within the noise).
constexpr int TASK_TRIS = 16;
constexpr int TASK_TRIS_FEW = 8;  // tracer_cuda.TASK_TRIS_FEW
constexpr int TASK_FEW_GROUPS = 4;  // up to this many groups of 32 rays

struct Tasks {
  int n_tasks, chunks, tris;
};

template <class Cl>
__device__ __forceinline__ Tasks plan_tasks(int n_in) {
  const int groups = (n_in + 31) >> 5;
  // Small tasks spread evenly over the warps; a few rays get the smallest.
  const int tris = groups <= TASK_FEW_GROUPS ? TASK_TRIS_FEW : TASK_TRIS;
  return {groups * (Cl::TRIS / tris), Cl::TRIS / tris, tris};
}

// ---------------------------------------------------------------------------
// The prologue: item table, counter and the rays' initial results
// ---------------------------------------------------------------------------

constexpr int PROLOGUE_THREADS = 1024;

// build_work_items' table, by one CTA: the slice-major grid of (slice,
// block) codes, compacted to the slices that exist, in order.
__device__ __forceinline__ void build_item_table(
    const int* __restrict__ counts, int n_blocks, int max_slices,
    int* __restrict__ items, int* __restrict__ n_items) {
  __shared__ int s_sum[PROLOGUE_THREADS / 32];
  const int total = n_blocks * max_slices;
  const int per = (total + PROLOGUE_THREADS - 1) / PROLOGUE_THREADS;
  const int k0 = min((int)threadIdx.x * per, total);
  const int k1 = min(k0 + per, total);
  auto exists = [&](int k) {
    return (k / n_blocks) * SLICE_VISITS < counts[k % n_blocks];
  };
  int mine = 0;
  for (int k = k0; k < k1; ++k) mine += exists(k);
  // Exclusive scan of `mine` over the CTA.
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int scan = mine;
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(FULL, scan, off);
    if (lane >= off) scan += up;
  }
  if (lane == 31) s_sum[warp] = scan;
  __syncthreads();
  if (warp == 0) {
    int w = s_sum[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w += up;
    }
    s_sum[lane] = w;
  }
  __syncthreads();
  int at = scan - mine + (warp > 0 ? s_sum[warp - 1] : 0);
  for (int k = k0; k < k1; ++k) {
    if (exists(k)) items[at++] = k;
  }
  if (threadIdx.x == 0) *n_items = s_sum[PROLOGUE_THREADS / 32 - 1];
}

// What a launch needs before its walk, in one kernel over the rays: a
// closest-hit launch's merge words (`packed`) at their miss state, a
// shadow launch's flags (`blocked`) at 0; CTA 0 also zeroes the grid's
// work counter and, when `items` is given, builds the item table. Null
// pointers skip their part.
__global__ void __launch_bounds__(PROLOGUE_THREADS) prologue_kernel(
    const float* __restrict__ rays8, int n_rays,
    unsigned long long* __restrict__ packed, int* __restrict__ blocked,
    const int* __restrict__ counts, int n_blocks, int max_slices,
    int* __restrict__ items, int* __restrict__ n_items,
    int* __restrict__ counter) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < n_rays) {
    // Key init t_max + 1: a hit at exactly t_max still wins, and rays
    // that can hit nothing stop gating the early-out.
    if (packed != nullptr) {
      packed[r] = pack_hit(rays8[7 * (size_t)n_rays + r] + 1.0f, -1);
    }
    if (blocked != nullptr) blocked[r] = 0;
  }
  if (blockIdx.x != 0) return;
  if (threadIdx.x == 0 && counter != nullptr) *counter = 0;
  if (items != nullptr) {
    build_item_table(counts, n_blocks, max_slices, items, n_items);
  }
}

// ---------------------------------------------------------------------------
// Closest hit (K1, K3)
// ---------------------------------------------------------------------------

template <class Cl, bool STATS, bool CULL>
__global__ void __launch_bounds__(CTA_THREADS, MIN_CTAS) trace_opaque_walk(
    const float* __restrict__ rays8, int n_rays,
    const float4* __restrict__ table, int n_tab,
    const int* __restrict__ visits, const int* __restrict__ counts,
    const float* __restrict__ entries, int n_cols,
    const int* __restrict__ items, const int* __restrict__ n_items,
    int* __restrict__ counter, unsigned long long* __restrict__ packed,
    unsigned long long* __restrict__ stats) {
  __shared__ __align__(128) Shared<Cl> s;
  ring_init(s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool consumer = warp < CONSUMER_WARPS;
  unsigned g = 0;
  long long clock0 = 0;
  Item it = {};

  while (next_item<STATS>(s, items, n_items, counter, counts,
                          n_rays / BLOCK_RAYS, stats, clock0, it)) {
    load_slice(s, it, visits, entries, n_cols, n_tab);
    const size_t r = (size_t)it.block * BLOCK_RAYS + threadIdx.x;
    Ray own;
    bool live = false;
    unsigned long long best0 = 0;
    if (consumer) {
      own = own_ray(s, rays8, n_rays, r);
      live = own.tmax >= own.tmin;  // a dead ray can hit nothing
      best0 = __ldcg(packed + r);   // other items' results: prunes only
      s.best[threadIdx.x] = best0;
      const float bound = warp_max(live ? packed_key(best0) : -INFINITY);
      if (lane == 0) s.warp_bound[warp] = bound;
    }
    __syncthreads();
    const int n_vis = visits_within(s, it);
    Work work;
    if (!consumer) {
      produce(s, table, g, n_vis);
    } else {
      volatile unsigned long long* s_best = s.best;
      for (int i = 0; i < n_vis; ++i) {
        const float4* cl = consumer_wait(s, g + i);
        const float4 lo = cl[Cl::BOX], hi = cl[Cl::BOX + 1];
        bool in = false;
        if (live && box_valid(lo, hi)) {
          // The entry bounds the biased key of any hit in this cluster
          // from below, for the block and for this ray.
          const float key = packed_key(s_best[threadIdx.x]);
          float entry;
          in = s.entry[i] <= key && slab_enters(own, lo, hi, entry)
               && __fsub_rn(entry, lo.w) <= key;
        }
        const int n_in = gather_rays(s, i, in);
        const Tasks tasks = plan_tasks<Cl>(n_in);
        const int tid0 = s.cid[i] * Cl::TRIS;
        for (int task = warp; task < tasks.n_tasks; task += CONSUMER_WARPS) {
          const int at = (task / tasks.chunks) * 32 + lane;
          if (at >= n_in) continue;
          const int ray_at = s.list[i & 1][at];
          const Ray ray = shared_ray(s, ray_at);
          unsigned long long best = s_best[ray_at];
          bool improved = false;
          const int j0 = (task % tasks.chunks) * tasks.tris;
          for (int j = j0; j < j0 + tasks.tris; ++j) {
            float key;
            if (!Cl::template opaque<STATS, CULL>(cl, j, ray, key, work))
              continue;
            const unsigned long long cand = pack_hit(key, tid0 + j);
            if (cand < best) {
              best = cand;
              improved = true;
            }
          }
          if (improved) atomicMin(&s.best[ray_at], best);
        }
        consumer_release(s, g + i);
      }
      consumer_barrier();  // every task's result is in s.best
      const unsigned long long best = s_best[threadIdx.x];
      if (best < best0) atomicMin(packed + r, best);
    }
    g += n_vis;
    if (STATS) add_stats(stats, it.block, n_vis, work);
  }
}

// Decode each ray's packed winner and recompute u, v and the bias from
// the winning triangle with the walk's arithmetic.
template <class Cl>
__global__ void finalize_kernel(
    const float* __restrict__ rays8, int n_rays,
    const float4* __restrict__ table,
    const unsigned long long* __restrict__ packed, float* __restrict__ t_out,
    int* __restrict__ tri_out, float* __restrict__ u_out,
    float* __restrict__ v_out, float* __restrict__ bias_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const unsigned long long best = packed[r];
  const int tid = packed_tid(best);
  float u = 0.0f, v = 0.0f, bias = 0.0f;
  if (tid >= 0) {
    const Ray ray = load_ray(rays8, n_rays, r);
    const float4* cl = table + (size_t)(tid / Cl::TRIS) * Cl::FLOAT4S;
    Cl::hit_attributes(cl, tid % Cl::TRIS, ray, u, v, bias);
  }
  t_out[r] = packed_key(best);
  tri_out[r] = tid;
  u_out[r] = u;
  v_out[r] = v;
  bias_out[r] = bias;
}

// ---------------------------------------------------------------------------
// Occlusion (K2, K4)
// ---------------------------------------------------------------------------

template <class Cl, bool STATS>
__global__ void __launch_bounds__(CTA_THREADS, MIN_CTAS) trace_shadow_walk(
    const float* __restrict__ rays8, int n_rays,
    const float4* __restrict__ table, int n_tab,
    const int* __restrict__ visits, const int* __restrict__ counts,
    const float* __restrict__ entries, int n_cols,
    const int* __restrict__ items, const int* __restrict__ n_items,
    int* __restrict__ counter, int* __restrict__ blocked_out,
    unsigned long long* __restrict__ stats) {
  __shared__ __align__(128) Shared<Cl> s;
  ring_init(s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool consumer = warp < CONSUMER_WARPS;
  unsigned g = 0;
  long long clock0 = 0;
  Item it = {};

  while (next_item<STATS>(s, items, n_items, counter, counts,
                          n_rays / BLOCK_RAYS, stats, clock0, it)) {
    load_slice(s, it, visits, entries, n_cols, n_tab);
    const size_t r = (size_t)it.block * BLOCK_RAYS + threadIdx.x;
    Ray own;
    if (consumer) {
      own = own_ray(s, rays8, n_rays, r);
      // A dead ray can block nothing; a ray another item has blocked
      // needs no more tests (a stale 0 only costs work).
      const bool open = own.tmax >= own.tmin && __ldcg(blocked_out + r) == 0;
      s.flag[threadIdx.x] = open ? RAY_OPEN : RAY_CLOSED;
      const float bound = warp_max(open ? own.tmax : -INFINITY);
      if (lane == 0) s.warp_bound[warp] = bound;
    }
    __syncthreads();
    const int n_vis = visits_within(s, it);
    Work work;
    if (!consumer) {
      produce(s, table, g, n_vis);
    } else {
      volatile int* s_flag = s.flag;
      for (int i = 0; i < n_vis; ++i) {
        const float4* cl = consumer_wait(s, g + i);
        const float4 lo = cl[Cl::BOX], hi = cl[Cl::BOX + 1];
        bool in = false;
        if (s_flag[threadIdx.x] == RAY_OPEN && box_valid(lo, hi)) {
          float entry;
          in = s.entry[i] <= own.tmax && slab_enters(own, lo, hi, entry);
        }
        const int n_in = gather_rays(s, i, in);
        const Tasks tasks = plan_tasks<Cl>(n_in);
        for (int task = warp; task < tasks.n_tasks; task += CONSUMER_WARPS) {
          const int at = (task / tasks.chunks) * 32 + lane;
          if (at >= n_in) continue;
          const int ray_at = s.list[i & 1][at];
          const Ray ray = shared_ray(s, ray_at);
          const int j0 = (task % tasks.chunks) * tasks.tris;
          for (int j = j0; j < j0 + tasks.tris; ++j) {
            if (Cl::template shadow<STATS>(cl, j, ray, work)) {
              s_flag[ray_at] = RAY_HIT;
              break;
            }
          }
        }
        consumer_release(s, g + i);
      }
      consumer_barrier();  // every task's result is in s.flag
      if (s_flag[threadIdx.x] == RAY_HIT) blocked_out[r] = 1;
    }
    g += n_vis;
    if (STATS) add_stats(stats, it.block, n_vis, work);
  }
}

// ---------------------------------------------------------------------------
// Host side: the grid, the item table and the launches
// ---------------------------------------------------------------------------

// SMs x resident CTAs of a kernel on the current device. The answer is
// kept per kernel and device: the occupancy query costs more host time
// than a small launch's whole device time.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int* grid) {
  struct Known {
    const void* fn;
    int device, grid;
  };
  constexpr int MAX_KNOWN = 64;
  static std::mutex lock;
  static Known known[MAX_KNOWN];
  static int n_known = 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> hold(lock);
    for (int k = 0; k < n_known; ++k) {
      if (known[k].fn == fn && known[k].device == device) {
        *grid = known[k].grid;
        return cudaSuccess;
      }
    }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      CTA_THREADS, 0);
  if (err != cudaSuccess) return err;
  *grid = sms * per_sm;
  if (*grid <= 0) return cudaErrorLaunchOutOfResources;
  std::lock_guard<std::mutex> hold(lock);
  if (n_known < MAX_KNOWN) known[n_known++] = {fn, device, *grid};
  return cudaSuccess;
}

// CTAs of a closest-hit (shadow = 0) or shadow (shadow = 1) launch's
// persistent grid before it is clipped to the item table's size;
// negative on an error.
template <class Cl>
int walk_grid(int shadow, int stats) {
  int grid = 0;
  cudaError_t err;
  if (shadow) {
    err = stats ? persistent_grid(trace_shadow_walk<Cl, true>, &grid)
                : persistent_grid(trace_shadow_walk<Cl, false>, &grid);
  } else {
    err = stats ? persistent_grid(trace_opaque_walk<Cl, true, true>, &grid)
                : persistent_grid(trace_opaque_walk<Cl, false, true>, &grid);
  }
  return err == cudaSuccess ? grid : -(int)err;
}

// The prologue of a launch of n_rays rays (see prologue_kernel).
cudaError_t prologue(const float* rays8, int n_rays,
                     unsigned long long* packed, int* blocked,
                     const int* counts, int n_blocks, int max_items,
                     int* items, int* n_items, int* counter,
                     cudaStream_t stream) {
  const int grid = max(1, (n_rays + PROLOGUE_THREADS - 1) / PROLOGUE_THREADS);
  prologue_kernel<<<grid, PROLOGUE_THREADS, 0, stream>>>(
      rays8, n_rays, packed, blocked, counts, n_blocks, max_items / n_blocks,
      items, n_items, counter);
  return cudaGetLastError();
}

// A closest-hit launch on `stream`: the prologue (merge words, counter
// and, with build_items, the item table), the walk and the final pass.
template <class Cl>
cudaError_t launch_opaque(
    const float* rays8, int n_blocks, const float4* table, int n_tab,
    const int* visits, const int* counts, const float* entries, int n_cols,
    int cull_backface, int* items, int* n_items, int max_items,
    int build_items, int* counter, unsigned long long* packed, float* t,
    int* tri, float* u, float* v, float* bias, unsigned long long* stats,
    cudaStream_t stream) {
  if (n_blocks <= 0) return cudaSuccess;
  const int n_rays = n_blocks * BLOCK_RAYS;
  cudaError_t err =
      prologue(rays8, n_rays, packed, nullptr, counts, n_blocks, max_items,
               build_items && max_items > 0 ? items : nullptr, n_items,
               counter, stream);
  if (err != cudaSuccess) return err;
  if (max_items > 0) {
    auto kernel = stats != nullptr
                      ? (cull_backface ? trace_opaque_walk<Cl, true, true>
                                       : trace_opaque_walk<Cl, true, false>)
                      : (cull_backface ? trace_opaque_walk<Cl, false, true>
                                       : trace_opaque_walk<Cl, false, false>);
    int grid = 0;
    err = persistent_grid(kernel, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<min(grid, max_items), CTA_THREADS, 0, stream>>>(
        rays8, n_rays, table, n_tab, visits, counts, entries, n_cols,
        items, n_items, counter, packed, stats);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  finalize_kernel<Cl><<<(n_rays + 255) / 256, 256, 0, stream>>>(
      rays8, n_rays, table, packed, t, tri, u, v, bias);
  return cudaGetLastError();
}

// A shadow launch on `stream`: the prologue (flags, counter and, with
// build_items, the item table) and the walk.
template <class Cl>
cudaError_t launch_shadow(
    const float* rays8, int n_blocks, const float4* table, int n_tab,
    const int* visits, const int* counts, const float* entries, int n_cols,
    int* items, int* n_items, int max_items, int build_items, int* counter,
    int* blocked, unsigned long long* stats, cudaStream_t stream) {
  if (n_blocks <= 0) return cudaSuccess;
  const int n_rays = n_blocks * BLOCK_RAYS;
  cudaError_t err =
      prologue(nullptr, n_rays, nullptr, blocked, counts, n_blocks, max_items,
               build_items && max_items > 0 ? items : nullptr, n_items,
               counter, stream);
  if (err != cudaSuccess || max_items <= 0) return err;
  auto kernel = stats != nullptr ? trace_shadow_walk<Cl, true>
                                 : trace_shadow_walk<Cl, false>;
  int grid = 0;
  err = persistent_grid(kernel, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<min(grid, max_items), CTA_THREADS, 0, stream>>>(
      rays8, n_rays, table, n_tab, visits, counts, entries, n_cols, items,
      n_items, counter, blocked, stats);
  return cudaGetLastError();
}

}  // namespace
