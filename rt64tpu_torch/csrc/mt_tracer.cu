// K3 / K4: packet traversal over 128-triangle Moller-Trumbore clusters
// for Hopper (sm_90a): the tables of scenes beyond the size switch (see
// ops/tracer_cuda.py). K1/K2, the same two functions over 64-triangle
// Woop clusters, are in packet_tracer.cu; all four share the walk of
// packet_walk.cuh (work items, the cluster ring, per-ray culling, warp
// tasks, the packed merge word), which this file instantiates with the
// Moller-Trumbore layout and pair test (MtClusters).
//
// K3 `trace_opaque_walk<MtClusters>` (closest opaque hit) replaces the
//   TPU kernel rt64tpu/ops/tracer_pallas.py: _kernel (launched by
//   _trace_opaque_pallas_impl).
// K4 `trace_shadow_walk<MtClusters>` (any-hit occlusion) replaces the
//   TPU kernel rt64tpu/ops/tracer_pallas.py: _shadow_kernel (launched by
//   _shadow_pallas_impl).
//
// The kernel-side table (pack_mt_clusters in ops/tracer_cuda.py),
// PK_FLOAT4S float4 per cluster:
//   [0, 128)   : {e1.xyz, depth bias}      e1 = v1 - v0
//   [128, 256) : {e2.xyz, class}           e2 = v2 - v0; class 0 inactive,
//                                          1 single-sided, 2 double-sided
//   [256, 384) : {v0.xyz, 0}
//   384, 385   : {box lo.xyz, the cluster's largest depth bias},
//                {box hi.xyz, 0}; an empty cluster's box is inverted.
// An inactive triangle carries e1 = e2 = 0, so its determinant is 0 and
// the |det| > 1e-9 test rejects it without a flag.
//
// What bounds them on this card. Measured on the first design (one CTA
// per block walking its whole list, one ray per thread, the cluster
// re-staged with plain loads and two CTA barriers per visit): staging and
// barriers were 1-5 % of a launch. The time went to the pair test, which
// is bound by instruction dispatch (a warp runs every stage of the test
// that any of its lanes reaches, for all 32 lanes, whether or not a
// lane's ray comes near the cluster), and on incoherent launches to the
// tail: the launch lasted as long as the block with the longest list
// while most of the card idled. The shared walk answers both: work items
// on a persistent grid fill the card, and per-ray box culling with dense
// warp tasks runs fewer warp-wide pair tests (culling whole warps by a
// vote of their own 32 rays, the first form of that step, left 9 lanes in
// 10 idle on incoherent rays; two rays per thread were slower at both).
// The pair test reads its operands as three broadcast 16-byte loads.
//
// Tie rule (K3): smallest biased key, then largest triangle id, whatever
// the visit order. The hit test t <= t_max uses the (scene-box-clamped)
// t_max itself. The TPU kernel picks the largest id within a cluster and
// keeps the EARLIER visit across clusters (strict <, tracer_pallas.py:681),
// so it differs on exactly equal keys in different clusters only.

#include "packet_walk.cuh"

namespace {

constexpr int MT_CS = 128;
constexpr int PK_E1 = 0;
constexpr int PK_E2 = MT_CS;
constexpr int PK_V0 = 2 * MT_CS;
constexpr int PK_BOX = 3 * MT_CS;
constexpr int PK_FLOAT4S = 3 * MT_CS + 2;  // tracer_cuda.PK_FLOAT4S

// The determinant half of Moller-Trumbore: p = d x e2 and det = e1 . p.
struct MtDet {
  float px, py, pz, det;
};

__device__ __forceinline__ MtDet mt_det(const float4& e1, const float4& e2,
                                        const Ray& r) {
  MtDet p;
  p.px = __fmaf_rn(r.dy, e2.z, -__fmul_rn(r.dz, e2.y));
  p.py = __fmaf_rn(r.dz, e2.x, -__fmul_rn(r.dx, e2.z));
  p.pz = __fmaf_rn(r.dx, e2.y, -__fmul_rn(r.dy, e2.x));
  p.det = __fmaf_rn(e1.z, p.pz, __fmaf_rn(e1.y, p.py, __fmul_rn(e1.x, p.px)));
  return p;
}

// The culling rule on the determinant; e2.w is the triangle's class.
__device__ __forceinline__ bool mt_keep(float det, float cls,
                                        int cull_backface) {
  return cull_backface ? (det > 1e-9f || (cls > 1.5f && det < -1e-9f))
                       : (fabsf(det) > 1e-9f);
}

// The rest of the test once the determinant passed: true on a hit in
// [tmin, tmax], with t, u, v set. A STATS caller's `work` counts the
// pairs past the u stage, the v stage and the hits.
template <bool STATS>
__device__ __forceinline__ bool mt_hit(const float4& e1, const float4& e2,
                                       const float4& v0, const MtDet& p,
                                       const Ray& r, float& t, float& u,
                                       float& v, Work& work) {
  const float inv_det = __fdiv_rn(1.0f, p.det);
  const float tx = __fsub_rn(r.ox, v0.x);
  const float ty = __fsub_rn(r.oy, v0.y);
  const float tz = __fsub_rn(r.oz, v0.z);
  u = __fmul_rn(
      __fmaf_rn(tz, p.pz, __fmaf_rn(ty, p.py, __fmul_rn(tx, p.px))), inv_det);
  if (!(u >= 0.0f)) return false;
  if (STATS) ++work.n[2];
  const float qx = __fmaf_rn(ty, e1.z, -__fmul_rn(tz, e1.y));
  const float qy = __fmaf_rn(tz, e1.x, -__fmul_rn(tx, e1.z));
  const float qz = __fmaf_rn(tx, e1.y, -__fmul_rn(ty, e1.x));
  v = __fmul_rn(
      __fmaf_rn(r.dz, qz, __fmaf_rn(r.dy, qy, __fmul_rn(r.dx, qx))), inv_det);
  if (!(v >= 0.0f && __fadd_rn(u, v) <= 1.0f)) return false;
  if (STATS) ++work.n[3];
  t = __fmul_rn(
      __fmaf_rn(e2.z, qz, __fmaf_rn(e2.y, qy, __fmul_rn(e2.x, qx))), inv_det);
  if (!(t >= r.tmin && t <= r.tmax)) return false;
  if (STATS) ++work.n[4];
  return true;
}

// The layout and pair tests of the walk (see packet_walk.cuh). A STATS
// launch counts the pairs of active triangles as tested, then the pairs
// past the determinant, u, v with u + v, and t in range (a hit).
struct MtClusters {
  static constexpr int TRIS = MT_CS;
  static constexpr int FLOAT4S = PK_FLOAT4S;
  static constexpr int BOX = PK_BOX;

  template <bool STATS, bool CULL>
  static __device__ __forceinline__ bool opaque(const float4* cl, int j,
                                                const Ray& ray, float& key,
                                                Work& work) {
    const float4 e2 = cl[PK_E2 + j];
    const float4 e1 = cl[PK_E1 + j];
    const MtDet p = mt_det(e1, e2, ray);
    if (STATS && e2.w > 0.0f) ++work.n[0];
    if (!mt_keep(p.det, e2.w, CULL)) return false;
    if (STATS) ++work.n[1];
    float t, u, v;
    if (!mt_hit<STATS>(e1, e2, cl[PK_V0 + j], p, ray, t, u, v, work))
      return false;
    key = __fsub_rn(t, e1.w);
    return true;
  }

  template <bool STATS>
  static __device__ __forceinline__ bool shadow(const float4* cl, int j,
                                                const Ray& ray, Work& work) {
    const float4 e2 = cl[PK_E2 + j];
    const float4 e1 = cl[PK_E1 + j];
    const MtDet p = mt_det(e1, e2, ray);
    if (STATS && e2.w > 0.0f) ++work.n[0];
    if (!mt_keep(p.det, e2.w, 0)) return false;  // shadows never cull
    if (STATS) ++work.n[1];
    float t, u, v;
    return mt_hit<STATS>(e1, e2, cl[PK_V0 + j], p, ray, t, u, v, work);
  }

  static __device__ __forceinline__ void hit_attributes(const float4* cl,
                                                        int j, const Ray& ray,
                                                        float& u, float& v,
                                                        float& bias) {
    const float4 e1 = cl[PK_E1 + j], e2 = cl[PK_E2 + j], v0 = cl[PK_V0 + j];
    const MtDet p = mt_det(e1, e2, ray);
    Work unused;
    float t;
    mt_hit<false>(e1, e2, v0, p, ray, t, u, v, unused);
    bias = e1.w;
  }
};

}  // namespace

// CTAs of a K3 (shadow = 0) or K4 (shadow = 1) launch's persistent grid
// before it is clipped to the item table's size; negative on an error.
extern "C" int rt64_mt_grid(int shadow, int stats) {
  return walk_grid<MtClusters>(shadow, stats);
}

// build_work_items' table alone (for tests): see prologue_kernel.
extern "C" cudaError_t rt64_work_items(const int* counts, int n_blocks,
                                       int max_items, int* items,
                                       int* n_items, cudaStream_t stream) {
  if (n_blocks <= 0 || max_items <= 0) return cudaSuccess;
  return prologue(nullptr, 0, nullptr, nullptr, counts, n_blocks, max_items,
                  items, n_items, nullptr, stream);
}

extern "C" cudaError_t rt64_trace_opaque_mt(
    const float* rays8, int n_blocks, const float4* table, int n_tab,
    const int* visits, const int* counts, const float* entries, int n_cols,
    int cull_backface, int* items, int* n_items, int max_items,
    int build_items, int* counter, unsigned long long* packed, float* t,
    int* tri, float* u, float* v, float* bias, unsigned long long* stats,
    cudaStream_t stream) {
  return launch_opaque<MtClusters>(
      rays8, n_blocks, table, n_tab, visits, counts, entries, n_cols,
      cull_backface, items, n_items, max_items, build_items, counter, packed,
      t, tri, u, v, bias, stats, stream);
}

extern "C" cudaError_t rt64_trace_shadow_mt(
    const float* rays8, int n_blocks, const float4* table, int n_tab,
    const int* visits, const int* counts, const float* entries, int n_cols,
    int* items, int* n_items, int max_items, int build_items, int* counter,
    int* blocked, unsigned long long* stats, cudaStream_t stream) {
  return launch_shadow<MtClusters>(
      rays8, n_blocks, table, n_tab, visits, counts, entries, n_cols, items,
      n_items, max_items, build_items, counter, blocked, stats, stream);
}
