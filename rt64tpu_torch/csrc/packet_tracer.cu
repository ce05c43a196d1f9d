// Packet traversal kernels for Hopper (sm_90a), walking per-block cluster
// visit lists: K1 closest opaque hit and K2 any-hit occlusion over
// 64-triangle Woop clusters, K3 and K4 the same two functions over
// 128-triangle Moller-Trumbore clusters (the tables of scenes beyond the
// size switch, see ops/tracer_cuda.py).
//
// K1 `trace_opaque_kernel` replaces the TPU kernel
//   rt64tpu/ops/tracer_pallas.py: _kernel_vmem (launched by
//   _trace_opaque_vmem_impl).
// K2 `trace_shadow_kernel` replaces the TPU kernel
//   rt64tpu/ops/tracer_pallas.py: _shadow_kernel_vmem (launched by
//   _shadow_vmem_impl).
// K3 `trace_opaque_mt_kernel` replaces the TPU kernel
//   rt64tpu/ops/tracer_pallas.py: _kernel (launched by
//   _trace_opaque_pallas_impl).
// K4 `trace_shadow_mt_kernel` replaces the TPU kernel
//   rt64tpu/ops/tracer_pallas.py: _shadow_kernel (launched by
//   _shadow_pallas_impl).
//
// The text below describes K1/K2; K3/K4 have their own section further
// down.
//
// Layout. One CTA per 512-ray block, one ray per thread, so each CTA
// reads exactly one row of the visit tables (visits: cluster ids
// front-to-back, counts, entries: conservative entry distance per visit,
// already lowered by the scene's max depth bias). Rays are planar
// rays8 (8, N): origin xyz, direction xyz, t_min, t_max. The cluster
// table is (n_tab, 14, 64) f32, SoA per 64-triangle cluster:
//   rows 0-8  : Woop transform W (row g*3+i = W[g][i]),
//   rows 9-11 : tr = -W v0,
//   row  12   : signed keep threshold thr (1e-9/nn; negative when the
//               triangle is double-sided; +BIG when inactive),
//   row  13   : depth bias.
// Inactive triangles carry an all-zero transform, so r_z = 0 and the
// keep test rejects them without an explicit active flag.
//
// What bounds it on this card: FP32 CUDA-core work against the number
// of (ray, triangle) pairs the walk tests. Every tested pair costs the
// r_z = W[2] d keep test (5 flops); a pair pays each later stage of the
// Woop test only if it passed the one before (K1: t 7, u 13, v 14, key 1;
// K2: the t range 10, then u and v together 29). Dead rays
// (t_max < t_min: padding, rays outside the scene box, shadow rays of
// lights that contribute nothing) and blocked shadow rays need no tests;
// the kernels still run a dead ray's tests in step with its warp.
// The bytes moved are small: each CTA reads its 512 rays once and each
// visited cluster once (3.5 KB, staged in shared memory and broadcast to
// all 512 threads). The design keeps every operand in registers or
// shared memory, stages VISIT_UNROLL (K1) or SHADOW_UNROLL (K2) clusters
// per barrier, and cuts the pair count with the packet early-out: K1
// stops once the next cluster's entry lies beyond every ray's best key,
// K2 once every ray is blocked or the entry passes the block's largest
// t_max. Making the walk faster (warp-level packets, persistent CTAs) is
// later work.
//
// Each kernel has a STATS instantiation (launched when the caller passes
// a stats buffer) that also writes, per block, the visits walked, the
// pairs that live, unblocked rays tested and the pairs that passed each
// stage of the test (every stage returns early), so a caller can derive
// the work the launch needed; the timed production launch is the plain
// instantiation, whose code the counters leave as it was.
//
// Tie rule (K1): a hit replaces the carry when
//   key < best || (key == best && tid > best_tid),
// i.e. the smallest biased key wins and, among equal keys, the largest
// triangle id. The TPU kernel gives this whenever the tied hits sit in
// different lanes; for two exactly equal keys in the same lane (the same
// column j) of different visits it keeps the earlier visit (strict <,
// tracer_pallas.py:828).

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_RAYS = 512;
constexpr int K_CS = 64;
constexpr int CROWS = 14;
constexpr int CL_FLOATS = CROWS * K_CS;
constexpr int VISIT_UNROLL = 4;
constexpr int SHADOW_UNROLL = 8;
constexpr int R_TR = 9;
constexpr int R_THR = 12;
constexpr int R_BIAS = 13;

// CTA-wide max of one float per thread (all threads get the result).
// Contains a barrier, so it also fences the shared cluster stage.
__device__ __forceinline__ float block_max(float v, float* s_warp) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = s_warp[0];
  for (int k = 1; k < BLOCK_RAYS / 32; ++k) m = fmaxf(m, s_warp[k]);
  return m;
}

// Per-block work counters of a STATS launch, STATS_COLS per block:
// [visits walked, pairs tested, pairs past stage 1, 2, 3, 4]. The stages
// are the early returns of the pair test, in order:
//   K1: keep (r_z), t in range, u >= 0, v and u + v (a hit);
//   K2: keep (r_z), t in range, u with v and u + v (a hit); stage 4
//       stays 0;
//   K3, K4: determinant, u >= 0, v and u + v, t in range (a hit).
// A thread counts its own pairs in a Work and the block sums them.
constexpr int STATS_COLS = 6;

struct Work {
  unsigned n[STATS_COLS - 1] = {};
};

__device__ __forceinline__ void write_stats(unsigned long long* stats,
                                            int walked, const Work& w) {
  unsigned long long* row = stats + (size_t)blockIdx.x * STATS_COLS;
  if (threadIdx.x == 0) row[0] = (unsigned long long)walked;
  for (int k = 0; k < STATS_COLS - 1; ++k) {
    const unsigned sum = __reduce_add_sync(0xffffffffu, w.n[k]);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(row + 1 + k, (unsigned long long)sum);
    }
  }
}

// Copy the clusters of visits [i0, i0 + nv) into shared memory; slots at
// or past `count` are zero (an all-zero cluster never hits).
__device__ __forceinline__ void stage_clusters(
    float* dst, const float* __restrict__ clusters, int n_tab,
    const int* __restrict__ vrow, int i0, int nv, int count) {
  for (int k = threadIdx.x; k < nv * CL_FLOATS; k += BLOCK_RAYS) {
    const int slot = k / CL_FLOATS;
    const int off = k - slot * CL_FLOATS;
    const int i = i0 + slot;
    float val = 0.0f;
    if (i < count) {
      const int cid = min(max(vrow[i], 0), n_tab - 1);
      val = clusters[(size_t)cid * CL_FLOATS + off];
    }
    dst[k] = val;
  }
}

template <bool STATS>
__global__ void __launch_bounds__(BLOCK_RAYS) trace_opaque_kernel(
    const float* __restrict__ rays8, int n_rays,
    const float* __restrict__ clusters, int n_tab,
    const int* __restrict__ visits, const int* __restrict__ counts,
    const float* __restrict__ entries, int n_cols, int cull_backface,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    float* __restrict__ bias_out, unsigned long long* __restrict__ stats) {
  __shared__ float s_cl[VISIT_UNROLL * CL_FLOATS];
  __shared__ float s_warp[BLOCK_RAYS / 32];

  const int b = blockIdx.x;
  const int r = b * BLOCK_RAYS + threadIdx.x;
  const float ox = rays8[0 * (size_t)n_rays + r];
  const float oy = rays8[1 * (size_t)n_rays + r];
  const float oz = rays8[2 * (size_t)n_rays + r];
  const float dx = rays8[3 * (size_t)n_rays + r];
  const float dy = rays8[4 * (size_t)n_rays + r];
  const float dz = rays8[5 * (size_t)n_rays + r];
  const float tmin = rays8[6 * (size_t)n_rays + r];
  const float tmax = rays8[7 * (size_t)n_rays + r];
  const int count = counts[b];
  const int* vrow = visits + (size_t)b * n_cols;
  const float* erow = entries + (size_t)b * n_cols;

  // Key init t_max + 1: a hit at exactly t_max still wins, and rays
  // that can hit nothing stop gating the early-out.
  float best = tmax + 1.0f;
  int best_tid = -1;
  float best_u = 0.0f, best_v = 0.0f, best_b = 0.0f;
  float worst = block_max(best, s_warp);
  const bool live = tmax >= tmin;  // a dead ray can hit nothing
  Work work;

  int i = 0;
  while (i < count && erow[i] <= worst) {
    stage_clusters(s_cl, clusters, n_tab, vrow, i, VISIT_UNROLL, count);
    __syncthreads();
    const int nv = min(VISIT_UNROLL, count - i);
    for (int k = 0; k < nv; ++k) {
      const float* m = s_cl + k * CL_FLOATS;
      const int tid0 = min(max(vrow[i + k], 0), n_tab - 1) * K_CS;
      for (int j = 0; j < K_CS; ++j) {
        const float rz = m[6 * K_CS + j] * dx + m[7 * K_CS + j] * dy
                         + m[8 * K_CS + j] * dz;
        const float thr_s = m[R_THR * K_CS + j];
        const float thr = fabsf(thr_s);
        const bool keep = cull_backface
                              ? ((rz < -thr) || (thr_s < 0.0f && rz > thr))
                              : (fabsf(rz) > thr);
        if (STATS && live) ++work.n[0];
        if (!keep) continue;
        if (STATS && live) ++work.n[1];
        const float sz = m[6 * K_CS + j] * ox + m[7 * K_CS + j] * oy
                         + m[8 * K_CS + j] * oz + m[(R_TR + 2) * K_CS + j];
        const float t = -sz / rz;
        if (!(t >= tmin && t <= tmax)) continue;
        if (STATS) ++work.n[2];  // a dead ray never gets here
        const float sx = m[0 * K_CS + j] * ox + m[1 * K_CS + j] * oy
                         + m[2 * K_CS + j] * oz + m[R_TR * K_CS + j];
        const float rx = m[0 * K_CS + j] * dx + m[1 * K_CS + j] * dy
                         + m[2 * K_CS + j] * dz;
        const float u = sx + t * rx;
        if (!(u >= 0.0f)) continue;
        if (STATS) ++work.n[3];
        const float sy = m[3 * K_CS + j] * ox + m[4 * K_CS + j] * oy
                         + m[5 * K_CS + j] * oz + m[(R_TR + 1) * K_CS + j];
        const float ry = m[3 * K_CS + j] * dx + m[4 * K_CS + j] * dy
                         + m[5 * K_CS + j] * dz;
        const float v = sy + t * ry;
        if (!(v >= 0.0f && u + v <= 1.0f)) continue;
        if (STATS) ++work.n[4];
        const float bias = m[R_BIAS * K_CS + j];
        const float key = t - bias;
        const int tid = tid0 + j;
        if (key < best || (key == best && tid > best_tid)) {
          best = key;
          best_tid = tid;
          best_u = u;
          best_v = v;
          best_b = bias;
        }
      }
    }
    i += VISIT_UNROLL;
    worst = block_max(best, s_warp);
  }

  const bool found = best <= tmax;
  t_out[r] = best;
  tri_out[r] = found ? best_tid : -1;
  u_out[r] = found ? best_u : 0.0f;
  v_out[r] = found ? best_v : 0.0f;
  bias_out[r] = found ? best_b : 0.0f;
  if (STATS) write_stats(stats, min(i, count), work);
}

template <bool STATS>
__global__ void __launch_bounds__(BLOCK_RAYS) trace_shadow_kernel(
    const float* __restrict__ rays8, int n_rays,
    const float* __restrict__ clusters, int n_tab,
    const int* __restrict__ visits, const int* __restrict__ counts,
    const float* __restrict__ entries, int n_cols,
    int* __restrict__ blocked_out, unsigned long long* __restrict__ stats) {
  __shared__ float s_cl[SHADOW_UNROLL * CL_FLOATS];
  __shared__ float s_warp[BLOCK_RAYS / 32];

  const int b = blockIdx.x;
  const int r = b * BLOCK_RAYS + threadIdx.x;
  const float ox = rays8[0 * (size_t)n_rays + r];
  const float oy = rays8[1 * (size_t)n_rays + r];
  const float oz = rays8[2 * (size_t)n_rays + r];
  const float dx = rays8[3 * (size_t)n_rays + r];
  const float dy = rays8[4 * (size_t)n_rays + r];
  const float dz = rays8[5 * (size_t)n_rays + r];
  const float tmin = rays8[6 * (size_t)n_rays + r];
  const float tmax = rays8[7 * (size_t)n_rays + r];
  const int count = counts[b];
  const int* vrow = visits + (size_t)b * n_cols;
  const float* erow = entries + (size_t)b * n_cols;

  // Static entry bound: clusters entered beyond every ray's t_max
  // cannot block anything.
  const float worst0 = block_max(tmax, s_warp);
  bool blocked = false;
  const bool live = tmax >= tmin;  // a dead ray can block nothing
  Work work;

  int i = 0;
  while (i < count && erow[i] <= worst0) {
    stage_clusters(s_cl, clusters, n_tab, vrow, i, SHADOW_UNROLL, count);
    __syncthreads();
    const int nv = min(SHADOW_UNROLL, count - i);
    for (int k = 0; k < nv && !blocked; ++k) {
      const float* m = s_cl + k * CL_FLOATS;
      for (int j = 0; j < K_CS; ++j) {
        // Division-free test: multiply the hit conditions through by
        // q = r_z^2 > 0 (t = p / q with p = -s_z r_z). Shadows never cull.
        const float rz = m[6 * K_CS + j] * dx + m[7 * K_CS + j] * dy
                         + m[8 * K_CS + j] * dz;
        if (STATS && live) ++work.n[0];
        if (!(fabsf(rz) > fabsf(m[R_THR * K_CS + j]))) continue;
        if (STATS && live) ++work.n[1];
        const float sz = m[6 * K_CS + j] * ox + m[7 * K_CS + j] * oy
                         + m[8 * K_CS + j] * oz + m[(R_TR + 2) * K_CS + j];
        const float q = rz * rz;
        const float p = -(sz * rz);
        // q > 0 guards flush-to-zero underflow of a near-grazing r_z.
        if (!(q > 0.0f && p >= tmin * q && p <= tmax * q)) continue;
        if (STATS) ++work.n[2];  // a dead ray never gets here
        const float sx = m[0 * K_CS + j] * ox + m[1 * K_CS + j] * oy
                         + m[2 * K_CS + j] * oz + m[R_TR * K_CS + j];
        const float rx = m[0 * K_CS + j] * dx + m[1 * K_CS + j] * dy
                         + m[2 * K_CS + j] * dz;
        const float sy = m[3 * K_CS + j] * ox + m[4 * K_CS + j] * oy
                         + m[5 * K_CS + j] * oz + m[(R_TR + 1) * K_CS + j];
        const float ry = m[3 * K_CS + j] * dx + m[4 * K_CS + j] * dy
                         + m[5 * K_CS + j] * dz;
        const float uq = sx * q + p * rx;
        const float vq = sy * q + p * ry;
        if (uq >= 0.0f && vq >= 0.0f && uq + vq <= q) {
          if (STATS) ++work.n[3];
          blocked = true;
          break;
        }
      }
    }
    i += SHADOW_UNROLL;
    // Barrier + count: also fences the shared cluster stage.
    if (__syncthreads_count(blocked) == BLOCK_RAYS) break;
  }

  blocked_out[r] = blocked ? 1 : 0;
  if (STATS) write_stats(stats, min(i, count), work);
}

// ---------------------------------------------------------------------------
// K3 / K4: 128-triangle Moller-Trumbore clusters
// ---------------------------------------------------------------------------
//
// Same launch shape as K1/K2: one CTA per 512-ray block, one ray per
// thread, the block's row of the visit tables. The cluster table is
// (n_tab, 12, 128) f32, SoA per 128-triangle cluster:
//   rows 0-2 : v0,   rows 3-5 : e1 = v1 - v0,   rows 6-8 : e2 = v2 - v0,
//   row  9   : depth bias,
//   row  10  : active (1.0 for a valid opaque-class triangle),
//   row  11  : no_cull (1.0 for a double-sided triangle).
// The active row gates the hit (the table keeps raw vertices, so an
// inactive triangle has no other mark).
//
// Each visit stages ONE cluster (6 KB) in shared memory, every thread
// runs its ray against the 128 triangles with all operands in registers
// or broadcast shared-memory reads, and the CTA checks the early-out
// after EVERY visit (K1 checks every 4, K2 every 8): K3 stops once the
// next entry lies beyond the largest best key of the block, K4 once all
// 512 rays are blocked or the next entry passes the largest t_max among
// its unblocked rays (a blocked ray counts 0 there and a dead ray its
// negative t_max, which only ever shortens the walk). The check is one
// CTA-wide reduction whose barrier also fences the stage, so no barrier
// sits in divergent code. A dead ray (t_max < t_min) and a blocked
// shadow ray skip the triangle loop.
//
// What bounds them on this card: as K1/K2, FP32 CUDA-core work against
// the (ray, triangle) pairs the walk tests. A pair of a live ray and an
// active triangle pays p = d x e2 and det = e1 . p (14 flops); a pair
// pays each later stage only if it passed the one before: 1/det, o - v0
// and u (10), then q, v and u + v (16), then t (6), and in K3 a hit pays
// the key (1). The bytes are small: 512 rays and one 6 KB cluster per
// visit per CTA.
//
// Tie rule (K3): as K1, smallest biased key, then largest triangle id,
// whatever the visit order. A ray starts at key t_max + 1 with no
// triangle; only a strictly smaller key takes it from there, and the
// hit test t <= t_max uses the (scene-box-clamped) t_max itself. The TPU
// kernel picks the largest id within a cluster and keeps the EARLIER
// visit across clusters (strict <, tracer_pallas.py:681), so it differs
// on exactly equal keys in different clusters only.

constexpr int MT_CS = 128;
constexpr int MT_ROWS = 12;
constexpr int MT_FLOATS = MT_ROWS * MT_CS;
constexpr int MT_BIAS = 9;
constexpr int MT_ACTIVE = 10;
constexpr int MT_NO_CULL = 11;

// Copy the cluster of visit i into shared memory (i < count).
__device__ __forceinline__ int stage_mt_cluster(
    float* dst, const float* __restrict__ clusters, int n_tab,
    const int* __restrict__ vrow, int i) {
  const int cid = min(max(vrow[i], 0), n_tab - 1);
  const float* src = clusters + (size_t)cid * MT_FLOATS;
  for (int k = threadIdx.x; k < MT_FLOATS; k += BLOCK_RAYS) dst[k] = src[k];
  return cid;
}

// The determinant half of Moller-Trumbore for triangle j of the staged
// cluster: p = d x e2 and det = e1 . p.
struct MtDet {
  float px, py, pz, det;
};

__device__ __forceinline__ MtDet mt_det(const float* m, int j, float dx,
                                        float dy, float dz) {
  const float e2x = m[6 * MT_CS + j], e2y = m[7 * MT_CS + j],
              e2z = m[8 * MT_CS + j];
  MtDet r;
  r.px = dy * e2z - dz * e2y;
  r.py = dz * e2x - dx * e2z;
  r.pz = dx * e2y - dy * e2x;
  r.det = m[3 * MT_CS + j] * r.px + m[4 * MT_CS + j] * r.py
          + m[5 * MT_CS + j] * r.pz;
  return r;
}

// The rest of the test once the determinant passed: true on a hit in
// [tmin, tmax], with t, u, v set. A STATS caller's `work` counts the
// pairs past the u stage, the v stage and the hits.
template <bool STATS>
__device__ __forceinline__ bool mt_hit(
    const float* m, int j, const MtDet& p, float ox, float oy, float oz,
    float dx, float dy, float dz, float tmin, float tmax, float& t, float& u,
    float& v, Work& work) {
  const float inv_det = 1.0f / p.det;
  const float tx = ox - m[0 * MT_CS + j];
  const float ty = oy - m[1 * MT_CS + j];
  const float tz = oz - m[2 * MT_CS + j];
  u = (tx * p.px + ty * p.py + tz * p.pz) * inv_det;
  if (!(u >= 0.0f)) return false;
  if (STATS) ++work.n[2];
  const float e1x = m[3 * MT_CS + j], e1y = m[4 * MT_CS + j],
              e1z = m[5 * MT_CS + j];
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (dx * qx + dy * qy + dz * qz) * inv_det;
  if (!(v >= 0.0f && u + v <= 1.0f)) return false;
  if (STATS) ++work.n[3];
  t = (m[6 * MT_CS + j] * qx + m[7 * MT_CS + j] * qy + m[8 * MT_CS + j] * qz)
      * inv_det;
  if (!(t >= tmin && t <= tmax)) return false;
  if (STATS) ++work.n[4];
  return true;
}

template <bool STATS>
__global__ void __launch_bounds__(BLOCK_RAYS) trace_opaque_mt_kernel(
    const float* __restrict__ rays8, int n_rays,
    const float* __restrict__ clusters, int n_tab,
    const int* __restrict__ visits, const int* __restrict__ counts,
    const float* __restrict__ entries, int n_cols, int cull_backface,
    float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    float* __restrict__ bias_out, unsigned long long* __restrict__ stats) {
  __shared__ float s_cl[MT_FLOATS];
  __shared__ float s_warp[BLOCK_RAYS / 32];

  const int b = blockIdx.x;
  const int r = b * BLOCK_RAYS + threadIdx.x;
  const float ox = rays8[0 * (size_t)n_rays + r];
  const float oy = rays8[1 * (size_t)n_rays + r];
  const float oz = rays8[2 * (size_t)n_rays + r];
  const float dx = rays8[3 * (size_t)n_rays + r];
  const float dy = rays8[4 * (size_t)n_rays + r];
  const float dz = rays8[5 * (size_t)n_rays + r];
  const float tmin = rays8[6 * (size_t)n_rays + r];
  const float tmax = rays8[7 * (size_t)n_rays + r];
  const int count = counts[b];
  const int* vrow = visits + (size_t)b * n_cols;
  const float* erow = entries + (size_t)b * n_cols;

  float best = tmax + 1.0f;
  int best_tid = -1;
  float best_u = 0.0f, best_v = 0.0f, best_b = 0.0f;
  float worst = block_max(best, s_warp);
  const bool live = tmax >= tmin;  // a dead ray can hit nothing
  Work work;

  int i = 0;
  while (i < count && erow[i] <= worst) {
    const int tid0 = stage_mt_cluster(s_cl, clusters, n_tab, vrow, i) * MT_CS;
    __syncthreads();
    if (live) {
      for (int j = 0; j < MT_CS; ++j) {
        if (!(s_cl[MT_ACTIVE * MT_CS + j] > 0.0f)) continue;
        const MtDet p = mt_det(s_cl, j, dx, dy, dz);
        if (STATS) ++work.n[0];
        const bool keep =
            cull_backface
                ? (p.det > 1e-9f
                   || (s_cl[MT_NO_CULL * MT_CS + j] > 0.0f && p.det < -1e-9f))
                : (fabsf(p.det) > 1e-9f);
        if (!keep) continue;
        if (STATS) ++work.n[1];
        float t, u, v;
        if (!mt_hit<STATS>(s_cl, j, p, ox, oy, oz, dx, dy, dz, tmin, tmax, t,
                           u, v, work))
          continue;
        const float bias = s_cl[MT_BIAS * MT_CS + j];
        const float key = t - bias;
        const int tid = tid0 + j;
        if (key < best
            || (key == best && best_tid >= 0 && tid > best_tid)) {
          best = key;
          best_tid = tid;
          best_u = u;
          best_v = v;
          best_b = bias;
        }
      }
    }
    ++i;
    worst = block_max(best, s_warp);  // its barrier fences the stage
  }

  t_out[r] = best;
  tri_out[r] = best_tid;
  u_out[r] = best_u;
  v_out[r] = best_v;
  bias_out[r] = best_b;
  if (STATS) write_stats(stats, i, work);
}

template <bool STATS>
__global__ void __launch_bounds__(BLOCK_RAYS) trace_shadow_mt_kernel(
    const float* __restrict__ rays8, int n_rays,
    const float* __restrict__ clusters, int n_tab,
    const int* __restrict__ visits, const int* __restrict__ counts,
    const float* __restrict__ entries, int n_cols,
    int* __restrict__ blocked_out, unsigned long long* __restrict__ stats) {
  __shared__ float s_cl[MT_FLOATS];
  __shared__ float s_warp[BLOCK_RAYS / 32];
  __shared__ int s_blocked[BLOCK_RAYS / 32];

  const int b = blockIdx.x;
  const int r = b * BLOCK_RAYS + threadIdx.x;
  const float ox = rays8[0 * (size_t)n_rays + r];
  const float oy = rays8[1 * (size_t)n_rays + r];
  const float oz = rays8[2 * (size_t)n_rays + r];
  const float dx = rays8[3 * (size_t)n_rays + r];
  const float dy = rays8[4 * (size_t)n_rays + r];
  const float dz = rays8[5 * (size_t)n_rays + r];
  const float tmin = rays8[6 * (size_t)n_rays + r];
  const float tmax = rays8[7 * (size_t)n_rays + r];
  const int count = counts[b];
  const int* vrow = visits + (size_t)b * n_cols;
  const float* erow = entries + (size_t)b * n_cols;

  bool blocked = false;
  const bool live = tmax >= tmin;  // a dead ray can block nothing
  Work work;
  float worst = block_max(tmax, s_warp);
  int n_blocked = 0;

  int i = 0;
  while (i < count && n_blocked < BLOCK_RAYS && erow[i] <= worst) {
    stage_mt_cluster(s_cl, clusters, n_tab, vrow, i);
    __syncthreads();
    if (live && !blocked) {
      for (int j = 0; j < MT_CS; ++j) {
        if (!(s_cl[MT_ACTIVE * MT_CS + j] > 0.0f)) continue;
        const MtDet p = mt_det(s_cl, j, dx, dy, dz);
        if (STATS) ++work.n[0];
        if (!(fabsf(p.det) > 1e-9f)) continue;  // shadows never cull
        if (STATS) ++work.n[1];
        float t, u, v;
        if (mt_hit<STATS>(s_cl, j, p, ox, oy, oz, dx, dy, dz, tmin, tmax, t, u,
                          v, work)) {
          blocked = true;
          break;
        }
      }
    }
    ++i;
    // One reduction for both early-outs: the largest t_max among the
    // unblocked rays and the number of blocked rays. Its barrier fences
    // the stage.
    const unsigned ballot = __ballot_sync(0xffffffffu, blocked);
    if ((threadIdx.x & 31) == 0) s_blocked[threadIdx.x >> 5] = __popc(ballot);
    worst = block_max(blocked ? 0.0f : tmax, s_warp);
    n_blocked = 0;
    for (int k = 0; k < BLOCK_RAYS / 32; ++k) n_blocked += s_blocked[k];
  }

  blocked_out[r] = blocked ? 1 : 0;
  if (STATS) write_stats(stats, i, work);
}

}  // namespace

extern "C" cudaError_t rt64_trace_opaque(
    const float* rays8, int n_blocks, const float* clusters, int n_tab,
    const int* visits, const int* counts, const float* entries, int n_cols,
    int cull_backface, float* t, int* tri, float* u, float* v, float* bias,
    unsigned long long* stats, cudaStream_t stream) {
  if (n_blocks <= 0) return cudaSuccess;
  auto kernel = stats != nullptr ? trace_opaque_kernel<true>
                                 : trace_opaque_kernel<false>;
  kernel<<<n_blocks, BLOCK_RAYS, 0, stream>>>(
      rays8, n_blocks * BLOCK_RAYS, clusters, n_tab, visits, counts, entries,
      n_cols, cull_backface, t, tri, u, v, bias, stats);
  return cudaGetLastError();
}

extern "C" cudaError_t rt64_trace_shadow(
    const float* rays8, int n_blocks, const float* clusters, int n_tab,
    const int* visits, const int* counts, const float* entries, int n_cols,
    int* blocked, unsigned long long* stats, cudaStream_t stream) {
  if (n_blocks <= 0) return cudaSuccess;
  auto kernel = stats != nullptr ? trace_shadow_kernel<true>
                                 : trace_shadow_kernel<false>;
  kernel<<<n_blocks, BLOCK_RAYS, 0, stream>>>(
      rays8, n_blocks * BLOCK_RAYS, clusters, n_tab, visits, counts, entries,
      n_cols, blocked, stats);
  return cudaGetLastError();
}

extern "C" cudaError_t rt64_trace_opaque_mt(
    const float* rays8, int n_blocks, const float* clusters, int n_tab,
    const int* visits, const int* counts, const float* entries, int n_cols,
    int cull_backface, float* t, int* tri, float* u, float* v, float* bias,
    unsigned long long* stats, cudaStream_t stream) {
  if (n_blocks <= 0) return cudaSuccess;
  auto kernel = stats != nullptr ? trace_opaque_mt_kernel<true>
                                 : trace_opaque_mt_kernel<false>;
  kernel<<<n_blocks, BLOCK_RAYS, 0, stream>>>(
      rays8, n_blocks * BLOCK_RAYS, clusters, n_tab, visits, counts, entries,
      n_cols, cull_backface, t, tri, u, v, bias, stats);
  return cudaGetLastError();
}

extern "C" cudaError_t rt64_trace_shadow_mt(
    const float* rays8, int n_blocks, const float* clusters, int n_tab,
    const int* visits, const int* counts, const float* entries, int n_cols,
    int* blocked, unsigned long long* stats, cudaStream_t stream) {
  if (n_blocks <= 0) return cudaSuccess;
  auto kernel = stats != nullptr ? trace_shadow_mt_kernel<true>
                                 : trace_shadow_mt_kernel<false>;
  kernel<<<n_blocks, BLOCK_RAYS, 0, stream>>>(
      rays8, n_blocks * BLOCK_RAYS, clusters, n_tab, visits, counts, entries,
      n_cols, blocked, stats);
  return cudaGetLastError();
}
