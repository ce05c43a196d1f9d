// The alpha path's slab cull for Hopper (sm_90a): which lanes' 8-lane
// bundles might meet an alpha triangle, the prefilter of the compaction in
// tracer.trace_alpha_to_compact. The kernel of tracer_cuda.alpha_cull; its
// plain twin is tracer._slab_any_bundled_plain (the bundle hull there, the
// interval test in tracer._slab_interval_hit).
//
// It replaces no TPU kernel: the JAX package runs this cull as XLA
// elementwise work over (bundles x boxes) planes, as the twin does: some 65
// broadcast operators of float32 planes of bundles x M boxes, ~600 bytes of
// device-memory traffic a (bundle, box) pair, 0.81 GB a plane at the 6.36 M
// shadow lanes of a frame lit by 12 lights.
//
// Layout. One thread per bundle of 8 adjacent lanes, CULL_THREADS bundles a
// CTA. The thread builds its bundle's hull from its live lanes (t_max >=
// t_min): the origin box, the direction box and the [t_min, t_max] hull,
// then per axis whether the direction interval spans zero (`mixed`) and the
// reciprocals of its ends, once. The boxes pass through shared memory in
// tiles of CULL_TILE, staged in list order with the inverted ones (lo > hi
// on any axis: padding, never a hit in the twin) left out; every thread of
// a warp reads the same box at a time (a broadcast). A thread walks the
// boxes until its first hit (the result is an ANY), a bundle without a live
// lane tests nothing, and a CTA whose bundles are all done loads no more
// tiles. It writes bundle_hit && live for its 8 lanes, as one 8-byte store.
// No (bundles x boxes) value leaves the registers, and nothing is
// allocated.
//
// Arithmetic. The twin's operations in the twin's order, each product and
// sum rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn: nothing is
// contracted into an FMA), the reciprocals correctly rounded as ATen's
// reciprocal (Tensor.__rtruediv__ is reciprocal() * other), and every
// minimum and maximum with torch's rule that a NaN operand gives NaN
// (min.NaN / max.NaN, which fminf / fmaxf are not): the mask equals the
// twin's bit for bit, whatever the inputs hold.
//
// What bounds it. Each (live bundle, live box) pair that is tested costs
// ~50 FP32 instructions (2 subtractions, 4 products and 8 minima or maxima
// an axis, then the widening and three comparisons); the bytes are each
// lane's ray (32 B) and mask byte, once. Most bundles meet no box and walk
// the whole list, so the pairs are most of (live bundles x live boxes):
// instruction issue on the FP32 pipes. On an H100 SXM a 4K frame's five
// culls (51,016 to 4,147,200 lanes) take 0.04-0.22 ms each, 0.69 ms in
// all, against a floor of 0.11 ms from those pairs and bytes.

#include <cuda_runtime.h>

namespace {

constexpr int CULL_BUNDLE = 8;    // lanes a bundle (tracer._CULL_BUNDLE)
constexpr int CULL_THREADS = 128;  // bundles a CTA, one a thread
constexpr int CULL_TILE = 512;     // boxes staged a pass
constexpr int CULL_WARPS = CULL_THREADS / 32;
constexpr float BIG = 3.0e37f;  // tracer._BIG
constexpr float EPS = 1e-12f;   // a direction component treated as zero

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.minimum / torch.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__global__ void __launch_bounds__(CULL_THREADS) alpha_cull_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_min, const float* __restrict__ t_max, int n,
    const float* __restrict__ lo, const float* __restrict__ hi, int m,
    unsigned long long* __restrict__ mask) {
  __shared__ float box[6][CULL_TILE];  // lo x, y, z, hi x, y, z
  __shared__ int warp_kept[CULL_WARPS];
  const int n_bundles = n / CULL_BUNDLE;
  const int b = blockIdx.x * CULL_THREADS + threadIdx.x;
  const size_t ns = static_cast<size_t>(n);

  // The bundle's hull over its live lanes (b3, tmin_lo, tmax_hi).
  float o_lo[3] = {BIG, BIG, BIG}, o_hi[3] = {-BIG, -BIG, -BIG};
  float d_lo[3] = {BIG, BIG, BIG}, d_hi[3] = {-BIG, -BIG, -BIG};
  float tmin_lo = BIG, tmax_hi = -BIG;
  unsigned live = 0;
  if (b < n_bundles) {
#pragma unroll
    for (int l = 0; l < CULL_BUNDLE; ++l) {
      const size_t i = static_cast<size_t>(b) * CULL_BUNDLE + l;
      const float t0 = t_min[i], t1 = t_max[i];
      const bool lv = t1 >= t0;
      live |= static_cast<unsigned>(lv) << l;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float o = origins[c * ns + i], d = dirs[c * ns + i];
        o_lo[c] = min_nan(o_lo[c], lv ? o : BIG);
        o_hi[c] = max_nan(o_hi[c], lv ? o : -BIG);
        d_lo[c] = min_nan(d_lo[c], lv ? d : BIG);
        d_hi[c] = max_nan(d_hi[c], lv ? d : -BIG);
      }
      tmin_lo = min_nan(tmin_lo, lv ? t0 : BIG);
      tmax_hi = max_nan(tmax_hi, lv ? t1 : -BIG);
    }
  }
  // Per axis, once a bundle: a direction interval spanning zero constrains
  // nothing; otherwise the reciprocals of its ends.
  bool mixed[3];
  float inv_a[3], inv_b[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mixed[c] = d_lo[c] <= EPS && d_hi[c] >= -EPS;
    inv_a[c] = __frcp_rn(fabsf(d_lo[c]) > EPS ? d_lo[c] : 1.0f);
    inv_b[c] = __frcp_rn(fabsf(d_hi[c]) > EPS ? d_hi[c] : 1.0f);
  }
  const bool dead = o_lo[0] > o_hi[0];  // no live lane in the bundle
  bool looking = b < n_bundles && !dead;
  bool hit = false;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = 0; base < m; base += CULL_TILE) {
    // Also the barrier after the previous tile's walk.
    if (!__syncthreads_or(looking)) break;
    const int len = min(CULL_TILE, m - base);
    int kept = 0;  // boxes staged so far in this tile, the same in every thread
    for (int j0 = 0; j0 < len; j0 += CULL_THREADS) {
      const int j = base + j0 + threadIdx.x;
      float bx[6];
      bool ok = false;
      if (j0 + threadIdx.x < len) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          bx[c] = lo[c * m + j];
          bx[3 + c] = hi[c * m + j];
        }
        ok = bx[0] <= bx[3] && bx[1] <= bx[4] && bx[2] <= bx[5];
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) warp_kept[warp] = __popc(ballot);
      __syncthreads();
      int slot = kept, total = 0;
#pragma unroll
      for (int w = 0; w < CULL_WARPS; ++w) {
        if (w < warp) slot += warp_kept[w];
        total += warp_kept[w];
      }
      if (ok) {
        slot += __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
        for (int k = 0; k < 6; ++k) box[k][slot] = bx[k];
      }
      kept += total;
      __syncthreads();  // the tile is written; warp_kept is free again
    }
    if (!looking) continue;
    for (int s = 0; s < kept; ++s) {
      float t_lo = -INFINITY, t_hi = INFINITY;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float num_lo = sub(box[c][s], o_hi[c]);
        const float num_hi = sub(box[3 + c][s], o_lo[c]);
        const float t1 = mul(num_lo, inv_a[c]);
        const float t2 = mul(num_lo, inv_b[c]);
        const float t3 = mul(num_hi, inv_a[c]);
        const float t4 = mul(num_hi, inv_b[c]);
        const float ax_lo = min_nan(min_nan(t1, t2), min_nan(t3, t4));
        const float ax_hi = max_nan(max_nan(t1, t2), max_nan(t3, t4));
        t_lo = max_nan(t_lo, mixed[c] ? -BIG : ax_lo);
        t_hi = min_nan(t_hi, mixed[c] ? BIG : ax_hi);
      }
      t_lo = sub(sub(t_lo, mul(fabsf(t_lo), 1e-5f)), 1e-4f);
      t_hi = add(add(t_hi, mul(fabsf(t_hi), 1e-5f)), 1e-4f);
      if (t_lo <= t_hi && t_hi >= tmin_lo && t_lo <= tmax_hi) {
        hit = true;
        looking = false;
        break;
      }
    }
  }
  if (b >= n_bundles) return;
  unsigned long long out = 0;
  if (hit) {
#pragma unroll
    for (int l = 0; l < CULL_BUNDLE; ++l)
      out |= static_cast<unsigned long long>((live >> l) & 1u) << (8 * l);
  }
  mask[b] = out;
}

}  // namespace

// The alpha cull of n lanes (n a multiple of 8): origins, dirs (3, n)
// planar f32, t_min, t_max (n,) f32; m boxes lo, hi (3, m) planar f32.
// Writes mask (n,) bool, 8-byte aligned, on the stream.
extern "C" cudaError_t rt64_alpha_cull(const float* origins, const float* dirs,
                                       const float* t_min, const float* t_max,
                                       int n, const float* lo, const float* hi,
                                       int m, bool* mask, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (n % CULL_BUNDLE != 0 || m < 0) return cudaErrorInvalidValue;
  const int n_bundles = n / CULL_BUNDLE;
  const dim3 grid((n_bundles + CULL_THREADS - 1) / CULL_THREADS);
  alpha_cull_kernel<<<grid, CULL_THREADS, 0, stream>>>(
      origins, dirs, t_min, t_max, n, lo, hi, m,
      reinterpret_cast<unsigned long long*>(mask));
  return cudaGetLastError();
}
