// The alpha-class K-hit sweep for Hopper (sm_90a): every ray against the
// whole compacted alpha list (tracer.TraceScene.alpha_idx), keeping its K
// nearest hits by biased key (t - depth bias). The kernel of
// tracer_cuda.alpha_sweep; its plain twin is tracer._alpha_sweep_plain.
//
// It replaces no TPU kernel: the JAX package runs this sweep as XLA
// elementwise work over (rays x alpha list) planes (rt64tpu/ops/tracer.py
// _alpha_sweep), as the twin does: ~40 broadcast operations of
// Moller-Trumbore and K passes of min / where / int64 max per 256-entry
// chunk, planes of up to 4 GB each at the 4K frame's capacity. RT64 does
// the same work as an any-hit shader with a 16-slot insertion sort per
// ray; so does this kernel.
//
// Layout. One thread per ray, SWEEP_THREADS rays a CTA. The alpha list
// passes through shared memory in tiles of SWEEP_TILE entries, each three
// 16-byte operands {v0, depth bias}, {e1, class}, {e2, triangle id} (48 B),
// built by the CTA itself from the scene's planar corners, so nothing is
// packed on the host and any list length works. Every thread of a warp
// reads the same entry at a time (a broadcast). Pad entries (id < 0) get
// class 0 and never hit. Rays with an empty interval (t_max < t_min: the
// compaction's pad lanes) test nothing, and a CTA without a live ray
// loads no tile.
//
// Arithmetic. Moller-Trumbore in the order of the twin's expressions
// (tracer._intersect_soa), every product and sum rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn: nothing is contracted into an FMA),
// 1 / det by the correctly rounded reciprocal, the same culling rule,
// threshold and [t_min, t_max] test: t, u, v and the key equal the
// twin's bit for bit.
//
// Hit list. K slots in registers (K a template parameter: 1, 2, 4, 8, 16,
// the launch takes the smallest one that holds the k asked for and writes
// k), kept ascending by key by insertion. Entries arrive in list order,
// and a new hit goes before every held hit of an equal key: among equal
// keys the later list position comes first, the twin's tie rule. Misses
// read key BIG, id -1, u = v = bias = 0.
//
// What bounds it. Every (live ray, entry) pair is tested, ~25
// instructions to the first rejection; the bytes are the rays and the K
// hits, once. A launch covers the compacted lanes, up to the 4K frame's
// 2,073,600 (4,147,200 for two lights' shadows), most of them pad lanes
// at an empty interval: instruction issue on the FP32 pipes for the live
// rays, the output writes for the rest. On an H100 SXM the 4K frame's six
// launches take 0.10-0.83 ms each, 1.7 ms in all.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int SWEEP_THREADS = 128;  // rays a CTA, one a thread
constexpr int SWEEP_TILE = 256;     // alpha-list entries staged a pass
constexpr float BIG = 3.0e37f;      // tracer._BIG
constexpr float EPS = 1e-9f;        // the determinant's threshold

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

// One staged entry of the alpha list. class: 0 pad, 1 single-sided,
// 2 double-sided (the instance's no_cull).
struct Entry {
  float4 v0b;  // v0, depth bias
  float4 e1c;  // v1 - v0, class
  float4 e2i;  // v2 - v0, triangle id (int bits)
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// a0 b0 + a1 b1 + a2 b2, summed left to right.
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

__device__ __forceinline__ Entry load_entry(
    const long long* alpha_idx, int pos, const float* v0, const float* v1,
    const float* v2, const unsigned char* no_cull, const float* bias,
    int n_tri) {
  const long long id = alpha_idx[pos];
  Entry e;
  if (id < 0) {
    e.v0b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    e.e1c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    e.e2i = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(-1));
    return e;
  }
  const size_t s = static_cast<size_t>(n_tri);
  const float ax = v0[id], ay = v0[s + id], az = v0[2 * s + id];
  e.v0b = make_float4(ax, ay, az, bias[id]);
  e.e1c = make_float4(sub(v1[id], ax), sub(v1[s + id], ay),
                      sub(v1[2 * s + id], az), no_cull[id] ? 2.0f : 1.0f);
  e.e2i = make_float4(sub(v2[id], ax), sub(v2[s + id], ay),
                      sub(v2[2 * s + id], az),
                      __int_as_float(static_cast<int>(id)));
  return e;
}

// Moller-Trumbore as tracer._intersect_soa computes it: true on a hit in
// [t_min, t_max] that the culling rule keeps, with t, u and v set.
template <bool CULL>
__device__ __forceinline__ bool intersect(const Ray& r, const Entry& e,
                                          float& t, float& u, float& v) {
  const float e1x = e.e1c.x, e1y = e.e1c.y, e1z = e.e1c.z;
  const float e2x = e.e2i.x, e2y = e.e2i.y, e2z = e.e2i.z;
  const float px = sub(mul(r.dy, e2z), mul(r.dz, e2y));
  const float py = sub(mul(r.dz, e2x), mul(r.dx, e2z));
  const float pz = sub(mul(r.dx, e2y), mul(r.dy, e2x));
  const float det = dot3(e1x, px, e1y, py, e1z, pz);
  const float cls = e.e1c.w;
  const bool keep = CULL ? (cls > 1.5f ? fabsf(det) > EPS
                                       : (cls > 0.5f && det > EPS))
                         : (cls > 0.5f && fabsf(det) > EPS);
  if (!keep) return false;
  const float inv_det = __frcp_rn(det);
  const float tx = sub(r.ox, e.v0b.x);
  const float ty = sub(r.oy, e.v0b.y);
  const float tz = sub(r.oz, e.v0b.z);
  u = mul(dot3(tx, px, ty, py, tz, pz), inv_det);
  if (!(u >= 0.0f)) return false;
  const float qx = sub(mul(ty, e1z), mul(tz, e1y));
  const float qy = sub(mul(tz, e1x), mul(tx, e1z));
  const float qz = sub(mul(tx, e1y), mul(ty, e1x));
  v = mul(dot3(r.dx, qx, r.dy, qy, r.dz, qz), inv_det);
  if (!(v >= 0.0f && add(u, v) <= 1.0f)) return false;
  t = mul(dot3(e2x, qx, e2y, qy, e2z, qz), inv_det);
  return t >= r.tmin && t <= r.tmax;
}

// The K nearest hits so far, ascending by key; empty slots hold key BIG
// and id -1. Indexed with constants only, so it stays in registers.
template <int K>
struct HitList {
  float key[K];
  int id[K];
  float u[K];
  float v[K];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      key[s] = BIG;
      id[s] = -1;
      u[s] = 0.0f;
      v[s] = 0.0f;
    }
  }

  // A hit from a later list position than every hit held (k < BIG / 2):
  // it goes before the held hits of an equal key, and the last slot falls
  // off when the list is full.
  __device__ __forceinline__ void insert(float k, int i, float hu, float hv) {
    if (!(k <= key[K - 1])) return;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (k <= key[s]) {
        const float tk = key[s], tu = u[s], tv = v[s];
        const int ti = id[s];
        key[s] = k;
        id[s] = i;
        u[s] = hu;
        v[s] = hv;
        k = tk;
        i = ti;
        hu = tu;
        hv = tv;
      }
    }
  }
};

template <int K, bool CULL>
__global__ void __launch_bounds__(SWEEP_THREADS) alpha_sweep_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_min, const float* __restrict__ t_max, int n,
    const float* __restrict__ v0, const float* __restrict__ v1,
    const float* __restrict__ v2, const unsigned char* __restrict__ no_cull,
    const float* __restrict__ bias, int n_tri,
    const long long* __restrict__ alpha_idx, int a_cap, int k_out,
    float* __restrict__ t_out, long long* __restrict__ tri_out,
    float* __restrict__ uv_out, float* __restrict__ bias_out) {
  __shared__ Entry tile[SWEEP_TILE];
  const int i = blockIdx.x * SWEEP_THREADS + threadIdx.x;
  const size_t ns = static_cast<size_t>(n);
  Ray r{};
  bool live = false;
  if (i < n) {
    r.ox = origins[i];
    r.oy = origins[ns + i];
    r.oz = origins[2 * ns + i];
    r.dx = dirs[i];
    r.dy = dirs[ns + i];
    r.dz = dirs[2 * ns + i];
    r.tmin = t_min[i];
    r.tmax = t_max[i];
    live = r.tmax >= r.tmin;
  }
  HitList<K> hits;
  hits.clear();
  if (__syncthreads_or(live)) {
    for (int base = 0; base < a_cap; base += SWEEP_TILE) {
      const int m = min(SWEEP_TILE, a_cap - base);
      __syncthreads();  // the previous tile is done with
      for (int j = threadIdx.x; j < m; j += SWEEP_THREADS)
        tile[j] = load_entry(alpha_idx, base + j, v0, v1, v2, no_cull, bias,
                             n_tri);
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < m; ++j) {
        const Entry e = tile[j];
        float t, u, v;
        if (!intersect<CULL>(r, e, t, u, v)) continue;
        const float key = sub(t, e.v0b.w);
        if (key < 0.5f * BIG) hits.insert(key, __float_as_int(e.e2i.w), u, v);
      }
    }
  }
  if (i >= n) return;
  const size_t row = static_cast<size_t>(i) * k_out;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k_out) {
      const int id = hits.id[s];
      t_out[row + s] = id >= 0 ? hits.key[s] : BIG;
      tri_out[row + s] = id;
      uv_out[2 * (row + s)] = hits.u[s];
      uv_out[2 * (row + s) + 1] = hits.v[s];
      bias_out[row + s] = id >= 0 ? bias[id] : 0.0f;
    }
  }
}

template <int K>
cudaError_t launch(int cull, cudaStream_t stream, const float* origins,
                   const float* dirs, const float* t_min, const float* t_max,
                   int n, const float* v0, const float* v1, const float* v2,
                   const unsigned char* no_cull, const float* bias, int n_tri,
                   const long long* alpha_idx, int a_cap, int k, float* t,
                   long long* tri, float* uv, float* bias_out) {
  const dim3 grid((n + SWEEP_THREADS - 1) / SWEEP_THREADS);
  if (cull)
    alpha_sweep_kernel<K, true><<<grid, SWEEP_THREADS, 0, stream>>>(
        origins, dirs, t_min, t_max, n, v0, v1, v2, no_cull, bias, n_tri,
        alpha_idx, a_cap, k, t, tri, uv, bias_out);
  else
    alpha_sweep_kernel<K, false><<<grid, SWEEP_THREADS, 0, stream>>>(
        origins, dirs, t_min, t_max, n, v0, v1, v2, no_cull, bias, n_tri,
        alpha_idx, a_cap, k, t, tri, uv, bias_out);
  return cudaGetLastError();
}

}  // namespace

// The K nearest alpha-class hits of n rays: origins, dirs (3, n) planar
// f32, t_min, t_max (n,) f32; the scene's corners v0, v1, v2 (3, n_tri)
// f32, no_cull (n_tri,) bool, bias (n_tri,) f32; the alpha list (a_cap,)
// int64 (ids < 0 are padding); 1 <= k <= 16. Writes t (n, k) biased keys,
// tri (n, k) int64, uv (n, k, 2), bias (n, k) on the stream.
extern "C" cudaError_t rt64_alpha_sweep(
    const float* origins, const float* dirs, const float* t_min,
    const float* t_max, int n, const float* v0, const float* v1,
    const float* v2, const unsigned char* no_cull, const float* bias,
    int n_tri, const long long* alpha_idx, int a_cap, int k,
    int cull_backface, float* t, long long* tri, float* uv, float* bias_out,
    cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  auto run = [&](auto slots) {
    return launch<decltype(slots)::value>(
        cull_backface, stream, origins, dirs, t_min, t_max, n, v0, v1, v2,
        no_cull, bias, n_tri, alpha_idx, a_cap, k, t, tri, uv, bias_out);
  };
  if (k < 1 || k > 16) return cudaErrorInvalidValue;
  if (k <= 1) return run(std::integral_constant<int, 1>{});
  if (k <= 2) return run(std::integral_constant<int, 2>{});
  if (k <= 4) return run(std::integral_constant<int, 4>{});
  if (k <= 8) return run(std::integral_constant<int, 8>{});
  return run(std::integral_constant<int, 16>{});
}
