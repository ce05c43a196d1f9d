// Packet traversal kernels for Hopper (sm_90a), walking per-block cluster
// visit lists: K1 closest opaque hit and K2 any-hit occlusion over
// 64-triangle Woop clusters. K3 and K4, the same two functions over
// 128-triangle Moller-Trumbore clusters (the tables of scenes beyond the
// size switch, see ops/tracer_cuda.py), are in mt_tracer.cu.
//
// K1 `trace_opaque_kernel` replaces the TPU kernel
//   rt64tpu/ops/tracer_pallas.py: _kernel_vmem (launched by
//   _trace_opaque_vmem_impl).
// K2 `trace_shadow_kernel` replaces the TPU kernel
//   rt64tpu/ops/tracer_pallas.py: _shadow_kernel_vmem (launched by
//   _shadow_vmem_impl).
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

#include "work_stats.cuh"

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

// Per-block work counters of a STATS launch: see work_stats.cuh. One CTA
// owns one block here, so it adds its counts to the row of its blockIdx.
__device__ __forceinline__ void write_stats(unsigned long long* stats,
                                            int walked, const Work& w) {
  add_stats(stats, blockIdx.x, walked, w);
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
