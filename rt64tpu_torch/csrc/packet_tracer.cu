// K1 / K2: packet traversal over 64-triangle Woop clusters for Hopper
// (sm_90a): the tables of scenes up to the size switch (see
// ops/tracer_cuda.py), the castle frame's kernels. K3/K4, the same two
// functions over 128-triangle Moller-Trumbore clusters, are in
// mt_tracer.cu; all four share the walk of packet_walk.cuh (work items,
// the cluster ring, per-ray culling, warp tasks, the packed merge word),
// which this file instantiates with the Woop layout and pair tests
// (WoopClusters).
//
// K1 `trace_opaque_walk<WoopClusters>` (closest opaque hit) replaces the
//   TPU kernel rt64tpu/ops/tracer_pallas.py: _kernel_vmem (launched by
//   _trace_opaque_vmem_impl).
// K2 `trace_shadow_walk<WoopClusters>` (any-hit occlusion) replaces the
//   TPU kernel rt64tpu/ops/tracer_pallas.py: _shadow_kernel_vmem
//   (launched by _shadow_vmem_impl).
//
// The kernel-side table (pack_woop_clusters in ops/tracer_cuda.py, from
// build_cluster_mats' (nc + 1, 14, 64) rows), WP_FLOAT4S float4 per
// cluster, one 16-byte load per stage of the pair test:
//   [0, 64)    : {W row 2, tr.z}     r_z = W[2] d, s_z = W[2] o + tr.z
//   [64, 128)  : {signed thr, depth bias, 0, 0}
//   [128, 192) : {W row 0, tr.x}     u
//   [192, 256) : {W row 1, tr.y}     v
//   256, 257   : {box lo.xyz, the cluster's largest depth bias},
//                {box hi.xyz, 0}; an empty cluster's box is inverted.
// W is the inverse of [e1 e2 n], tr = -W v0. thr is the keep threshold
// 1e-9 / (n.n), stored negative when the triangle is double-sided; an
// inactive triangle carries thr = +BIG and an all-zero transform, so
// r_z = 0 and the keep test rejects it without a flag.
//
// What bounds them on this card. Measured on the first design (one CTA
// per 512-ray block walking its whole list, one ray per thread, every
// thread testing all 64 triangles of every staged cluster, 3 CTAs per
// SM): staging and barriers were 5-18 % of a castle launch (K1 0.058 of
// 0.355 ms, K2 0.062 of 1.316), and checking the packet early-out every
// visit or never moved nothing. The launches were bound by their slowest
// blocks: K2's longest block (56 visits) held a CTA for 2.57 M cycles,
// the whole launch, where all blocks' cycles over the 396 resident CTAs
// came to 1.35 M; K1 ran 600 blocks on 396 CTAs, 1.5 waves, its longest
// block 0.49 M cycles against 0.25 M balanced. Inside a block, a warp ran
// each stage of the test for all 32 lanes whenever one lane reached it,
// for rays nowhere near the cluster and for dead rays (51 % of the
// castle's shadow rays) alike. The shared walk answers both: work items
// on a persistent grid split the long lists, and per-ray box culling with
// dense warp tasks tests only the rays that enter a cluster's box.
//
// The pair tests. K1 follows the twin (trace_opaque_plain): keep on r_z
// against thr (with the culling rule), t = -s_z / r_z in [t_min, t_max],
// u = s_x + t r_x >= 0, v = s_y + t r_y >= 0 with u + v <= 1; the key is
// t - bias. K2 is division-free (trace_shadow_plain): with q = r_z^2 and
// p = -s_z r_z, t in range is p in [t_min q, t_max q], and the hit is
// u q = s_x q + p r_x >= 0, v q = s_y q + p r_y >= 0, u q + v q <= q;
// shadows never cull. Every product and sum is pinned in the order of the
// twin's expressions (dot products as fused chains), so the walk, its
// counting instantiation and the final pass give the same bits.
//
// Tie rule (K1): smallest biased key, then largest triangle id, whatever
// the visit order (the packed word of packet_walk.cuh). The TPU kernel
// gives this whenever the tied hits sit in different lanes of its tile;
// for two exactly equal keys in the same lane (the same column j) of
// different visits it keeps the earlier visit (strict <,
// tracer_pallas.py:828).

#include "packet_walk.cuh"

namespace {

constexpr int K_CS = 64;
constexpr int WP_Z = 0;
constexpr int WP_THR = K_CS;
constexpr int WP_X = 2 * K_CS;
constexpr int WP_Y = 3 * K_CS;
constexpr int WP_BOX = 4 * K_CS;
constexpr int WP_FLOAT4S = 4 * K_CS + 2;  // tracer_cuda.WP_FLOAT4S

// w . d for a float4 {w, tr} row.
__device__ __forceinline__ float w_dir(const float4& w, const Ray& r) {
  return __fmaf_rn(w.z, r.dz, __fmaf_rn(w.y, r.dy, __fmul_rn(w.x, r.dx)));
}

// w . o + tr for a float4 {w, tr} row.
__device__ __forceinline__ float w_org(const float4& w, const Ray& r) {
  return __fadd_rn(
      __fmaf_rn(w.z, r.oz, __fmaf_rn(w.y, r.oy, __fmul_rn(w.x, r.ox))), w.w);
}

// K1's test after the keep test: true on a hit in [tmin, tmax], with t,
// u, v set. A STATS caller's `work` counts the pairs past the t stage,
// the u stage and the hits.
template <bool STATS>
__device__ __forceinline__ bool woop_hit(const float4* cl, int j,
                                         const float4& z, float rz,
                                         const Ray& r, float& t, float& u,
                                         float& v, Work& work) {
  t = __fdiv_rn(-w_org(z, r), rz);
  if (!(t >= r.tmin && t <= r.tmax)) return false;
  if (STATS) ++work.n[2];
  const float4 x = cl[WP_X + j];
  u = __fmaf_rn(t, w_dir(x, r), w_org(x, r));
  if (!(u >= 0.0f)) return false;
  if (STATS) ++work.n[3];
  const float4 y = cl[WP_Y + j];
  v = __fmaf_rn(t, w_dir(y, r), w_org(y, r));
  if (!(v >= 0.0f && __fadd_rn(u, v) <= 1.0f)) return false;
  if (STATS) ++work.n[4];
  return true;
}

// The layout and pair tests of the walk (see packet_walk.cuh). A STATS
// launch counts every tested pair, then (K1) the pairs past the keep
// test, t in range, u, and v with u + v (a hit); (K2) past the keep
// test, t in range, and u with v and u + v (a hit).
struct WoopClusters {
  static constexpr int TRIS = K_CS;
  static constexpr int FLOAT4S = WP_FLOAT4S;
  static constexpr int BOX = WP_BOX;

  template <bool STATS, bool CULL>
  static __device__ __forceinline__ bool opaque(const float4* cl, int j,
                                                const Ray& ray, float& key,
                                                Work& work) {
    const float4 z = cl[WP_Z + j];
    const float2 tb = *reinterpret_cast<const float2*>(cl + WP_THR + j);
    const float rz = w_dir(z, ray);
    if (STATS) ++work.n[0];
    const float thr = fabsf(tb.x);
    const bool keep = CULL ? (rz < -thr || (tb.x < 0.0f && rz > thr))
                           : (fabsf(rz) > thr);
    if (!keep) return false;
    if (STATS) ++work.n[1];
    float t, u, v;
    if (!woop_hit<STATS>(cl, j, z, rz, ray, t, u, v, work)) return false;
    key = __fsub_rn(t, tb.y);
    return true;
  }

  template <bool STATS>
  static __device__ __forceinline__ bool shadow(const float4* cl, int j,
                                                const Ray& ray, Work& work) {
    const float4 z = cl[WP_Z + j];
    const float rz = w_dir(z, ray);
    if (STATS) ++work.n[0];
    if (!(fabsf(rz) > fabsf(cl[WP_THR + j].x))) return false;
    if (STATS) ++work.n[1];
    const float q = __fmul_rn(rz, rz);
    const float p = -__fmul_rn(w_org(z, ray), rz);
    // q > 0 guards flush-to-zero underflow of a near-grazing r_z.
    if (!(q > 0.0f && p >= __fmul_rn(ray.tmin, q)
          && p <= __fmul_rn(ray.tmax, q)))
      return false;
    if (STATS) ++work.n[2];
    const float4 x = cl[WP_X + j];
    const float4 y = cl[WP_Y + j];
    const float uq = __fmaf_rn(p, w_dir(x, ray), __fmul_rn(w_org(x, ray), q));
    const float vq = __fmaf_rn(p, w_dir(y, ray), __fmul_rn(w_org(y, ray), q));
    if (!(uq >= 0.0f && vq >= 0.0f && __fadd_rn(uq, vq) <= q)) return false;
    if (STATS) ++work.n[3];
    return true;
  }

  static __device__ __forceinline__ void hit_attributes(const float4* cl,
                                                        int j, const Ray& ray,
                                                        float& u, float& v,
                                                        float& bias) {
    const float4 z = cl[WP_Z + j];
    Work unused;
    float t;
    woop_hit<false>(cl, j, z, w_dir(z, ray), ray, t, u, v, unused);
    bias = cl[WP_THR + j].y;
  }
};

}  // namespace

// CTAs of a K1 (shadow = 0) or K2 (shadow = 1) launch's persistent grid
// before it is clipped to the item table's size; negative on an error.
extern "C" int rt64_woop_grid(int shadow, int stats) {
  return walk_grid<WoopClusters>(shadow, stats);
}

extern "C" cudaError_t rt64_trace_opaque(
    const float* rays8, int n_blocks, const float4* table, int n_tab,
    const int* visits, const int* counts, const float* entries, int n_cols,
    int cull_backface, int* items, int* n_items, int max_items,
    int build_items, int* counter, unsigned long long* packed, float* t,
    int* tri, float* u, float* v, float* bias, unsigned long long* stats,
    cudaStream_t stream) {
  return launch_opaque<WoopClusters>(
      rays8, n_blocks, table, n_tab, visits, counts, entries, n_cols,
      cull_backface, items, n_items, max_items, build_items, counter, packed,
      t, tri, u, v, bias, stats, stream);
}

extern "C" cudaError_t rt64_trace_shadow(
    const float* rays8, int n_blocks, const float4* table, int n_tab,
    const int* visits, const int* counts, const float* entries, int n_cols,
    int* items, int* n_items, int max_items, int build_items, int* counter,
    int* blocked, unsigned long long* stats, cudaStream_t stream) {
  return launch_shadow<WoopClusters>(
      rays8, n_blocks, table, n_tab, visits, counts, entries, n_cols, items,
      n_items, max_items, build_items, counter, blocked, stats, stream);
}
