// The hit shader for Hopper (sm_90a): for every hit lane, the triangle
// row's gather, barycentric interpolation, normals, the quad-pool texture
// fetches, the diffuse mixes, the N64 colour combiner, the alpha rules,
// normal and specular maps and the motion flow, in one launch. The kernel
// of tracer_cuda.hit_shade; its plain version is shading.shade_hits_plain.
//
// It replaces no TPU kernel: the JAX package's shade_hits
// (rt64tpu/ops/shading.py) is elementwise work that XLA fuses. Eager
// PyTorch issues it op by op, ~500-830 launches a call (the combiner's
// 8-way selects alone ~506), and a frame makes 6-13 calls: the host's
// issue of those launches, not the device, paced the frame. This kernel
// is one launch a call.
//
// Layout. One thread per hit lane, HIT_THREADS lanes a CTA. A lane reads
// its triangle's row of tri_rows (TROW floats, 432 B) once from device
// memory, as float2 (a row starts on an 8-byte boundary), and writes it
// to rows_t lane-contiguously (the plain version's tri_rows[tri].T); the
// fields it shades from are read again from the row through L1. The
// per-lane inputs may be strided views (an alpha slot's column of the
// (lanes, K) hit tables): the wrapper passes element strides.
//
// Arithmetic. float32, the plain version's operations in its order, every
// product and sum rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn: nothing is contracted into an FMA), clamps that
// keep NaN as ATen's do, fmodf-based remainder as ATen's, the sum over
// three components as ATen's reduction adds them ((a0 + a1) + a2, then
// + 0). The combiner evaluates each operand with a switch on its id in
// place of the masked 8-way sum, and adds + 0.0 to the selected value as
// that sum does (a -0.0 plane reads +0.0); an id outside 0-7 reads 0.0.
//
// Variants. Template flags: SHADOW (the shadow any-hit alpha, zero normal,
// specular and flow), and the fetches the scene's features call for:
// TEXEL1, normal maps, specular maps and ray-differential mip LOD (the
// diffuse fetch of the opaque hit of a camera ray). Every pass of every
// cell calls the same function; only the inputs' widths differ.
//
// The row carries the instance's light group mask as two exact 16-bit
// halves (T_LMASK), not an eligibility column per light: the lighting
// tests it against every light's group bits. The kernel copies it with
// the row and reads nothing of the lights.
//
// What bounds it. Bytes: the 432 B row read and written, 36 B of lane
// inputs, 56 B of planes and 4 B of instance written, ~1 KB a lane with a
// quad fetch or two. The arithmetic is ~200-400 FP32 operations a lane.

#include <cuda_runtime.h>

namespace {

constexpr int HIT_THREADS = 128;

// Triangle-row columns (pipeline/rows.py).
constexpr int TROW = 108;
constexpr int T_P0 = 0;
constexpr int T_P1 = 3;
constexpr int T_P2 = 6;
constexpr int T_N0 = 9;
constexpr int T_N1 = 12;
constexpr int T_N2 = 15;
constexpr int T_UV = 18;
constexpr int T_IN1 = 24;
constexpr int T_IN2 = 36;
constexpr int T_PP0 = 48;
constexpr int T_PP1 = 51;
constexpr int T_PP2 = 54;
constexpr int T_INST = 57;
constexpr int T_MAT = 58;
constexpr int T_CC = 86;
constexpr int T_FLAGS = 87;
constexpr int T_TEX_D = 88;
constexpr int T_TEX_N = 89;
constexpr int T_TEX_S = 90;
constexpr int T_SAMPLER = 91;
constexpr int T_LMASK = 92;
constexpr int T_TEX_D2 = 95;
constexpr int T_REC = 96;
// Material floats, relative to T_MAT.
constexpr int M_UV_DETAIL = 1;
constexpr int M_SOLID_ALPHA = 10;
constexpr int M_SHADOW_ALPHA = 11;
constexpr int M_DIFFUSE_MIX = 20;
// Flag bits of T_FLAGS.
constexpr int F_OPT_ALPHA = 1 << 0;
constexpr int F_TEXTURE_EDGE = 1 << 1;
constexpr int F_NOISE = 1 << 2;
constexpr int F_ALPHA_SAME = 1 << 3;
constexpr int F_USE_T0 = 1 << 4;
constexpr int F_USE_T1 = 1 << 5;
constexpr int F_NORMAL_MAP = 1 << 6;
constexpr int F_SPECULAR_MAP = 1 << 7;
constexpr int F_MIP_LOD = 1 << 11;
// Quad pool (ops/texture.py): quads a wide row, mip levels a chain.
constexpr int QPR = 32;
constexpr int MAX_MIP_LEVELS = 8;
// Variant bits of rt64_hit_shade's `variant`.
constexpr int V_SHADOW = 1;
constexpr int V_TEXEL1 = 2;
constexpr int V_NORMAL_MAPS = 4;
constexpr int V_SPECULAR_MAPS = 8;
constexpr int V_MIPS = 16;
// Runtime bits of `variant`: the ray directions' and the differentials'
// planes are lane-major, so ATen sums the dots of the planes made from
// them in the lane-major order (dot_lane_major).
constexpr int V_DIR_LANE_MAJOR = 32;
constexpr int V_DDX_LANE_MAJOR = 64;
constexpr int V_DDY_LANE_MAJOR = 128;

struct Params {
  const float* tri_rows;
  int n_tri;
  const void* tri;
  int tri_is64, tri_stride;
  const float* u;
  int u_stride;
  const float* v;
  int v_stride;
  const float* noise;
  int noise_stride;
  const float* dir;
  int dir_row, dir_lane;
  const float* t_hit;
  int t_stride;
  const float* ddx;
  int ddx_row, ddx_lane;
  const float* ddy;
  int ddy_row, ddy_lane;
  const long long* pool;
  int pool_quads, pool_wide;
  int m, variant;
  float* color;
  float* normal;
  float* specular;
  float* flow;
  int* instance;
  float* rows_t;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(x, min=lo) and (x, max=hi) with scalars: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}
// torch.minimum / torch.maximum: NaN from either side.
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// torch.remainder on floats: the sign of the divisor.
__device__ __forceinline__ float remainder(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((b < 0.0f) != (r < 0.0f))) r = add(r, b);
  return r;
}
// Float to int32 as ATen casts (truncation; NaN reads 0).
__device__ __forceinline__ int to_int(float x) { return __float2int_rz(x); }

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)};
}
__device__ __forceinline__ V3 vscale(V3 a, float s) {
  return {mul(a.x, s), mul(a.y, s), mul(a.z, s)};
}
// vecmath.dot: the products, then ATen's sum over the three. Its order
// follows the plane's layout: a (3, M) plane is summed as (p0 + p1) + p2,
// then + 0; a lane-major plane (strides (1, 3), what ATen gives the
// differences of the gathered rows, tri_rows[tri].T, and the planes made
// from them) as (p0 + p2) + 0, then + p1, two threads a lane.
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return add(add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z)), 0.0f);
}
__device__ __forceinline__ float dot_lane_major(V3 a, V3 b) {
  return add(add(add(mul(a.x, b.x), mul(a.z, b.z)), 0.0f), mul(a.y, b.y));
}
__device__ __forceinline__ float dot_as(bool lane_major, V3 a, V3 b) {
  return lane_major ? dot_lane_major(a, b) : dot(a, b);
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
          sub(mul(a.x, b.y), mul(a.y, b.x))};
}
// vecmath.normalize: a / clamp(|a|, min=1e-12).
template <bool LANE_MAJOR = false>
__device__ __forceinline__ V3 normalize(V3 a) {
  const float aa = LANE_MAJOR ? dot_lane_major(a, a) : dot(a, a);
  const float l = clamp_min(__fsqrt_rn(aa), 1e-12f);
  return {dvd(a.x, l), dvd(a.y, l), dvd(a.z, l)};
}
__device__ __forceinline__ V3 select(bool c, V3 a, V3 b) { return c ? a : b; }

// One row, read through the read-only path.
struct Row {
  const float* p;
  __device__ __forceinline__ float operator[](int c) const { return __ldg(p + c); }
  __device__ __forceinline__ V3 v3(int c) const {
    return {(*this)[c], (*this)[c + 1], (*this)[c + 2]};
  }
};

// p0 w0 + p1 u + p2 v, as the plain version sums it.
struct Bary {
  float w0, u, v;
  __device__ __forceinline__ float at(float a0, float a1, float a2) const {
    return add(add(mul(a0, w0), mul(a1, u)), mul(a2, v));
  }
  __device__ __forceinline__ V3 at(V3 a0, V3 a1, V3 a2) const {
    return {at(a0.x, a1.x, a2.x), at(a0.y, a1.y, a2.y), at(a0.z, a1.z, a2.z)};
  }
};

struct Rgba {
  float c[4];
};

// texture._remap: addressing of the continuous texel coordinate.
__device__ __forceinline__ float remap(float x, float sizef, int mode) {
  if (mode == 0) return remainder(x, sizef);
  const float top = sub(sizef, 1.0f);
  if (mode == 1) {
    const float folded = remainder(add(x, 0.5f), mul(2.0f, sizef));
    const float reflected = sub(sub(sizef, 0.5f), fabsf(sub(folded, sizef)));
    return minimum(clamp_min(reflected, 0.0f), top);
  }
  return minimum(clamp_min(x, 0.0f), top);
}

__device__ __forceinline__ Rgba unpack(unsigned long long word) {
  const float k = static_cast<float>(1.0 / 255.0);
  Rgba out;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    out.c[c] = mul(static_cast<float>(static_cast<int>((word >> (8 * c)) & 0xFF)), k);
  return out;
}

// texture.sample_quad_cols for one lane; invalid lanes read 0.
__device__ Rgba sample(const Params& p, int off, int w, int h, bool ok,
                       float tu, float tv, bool linear, int h_addr,
                       int v_addr) {
  Rgba out{{0.0f, 0.0f, 0.0f, 0.0f}};
  if (!ok) return out;
  const float wf = static_cast<float>(w), hf = static_cast<float>(h);
  const float x = remap(sub(mul(tu, wf), 0.5f), wf, h_addr);
  const float y = remap(sub(mul(tv, hf), 0.5f), hf, v_addr);
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = sub(x, x0f), fy = sub(y, y0f);
  const int x0 = min(max(to_int(x0f), 0), w - 1);
  const int y0 = min(max(to_int(y0f), 0), h - 1);
  long long flat = static_cast<long long>(off) + static_cast<long long>(y0) * w + x0;
  flat = min(max(flat, 0LL), static_cast<long long>(p.pool_quads) - 1);
  Rgba corner[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const long long at = p.pool_wide
        ? (flat / QPR) * (4 * QPR) + c * QPR + flat % QPR
        : flat * 4 + c;
    corner[c] = unpack(static_cast<unsigned long long>(__ldg(p.pool + at)));
  }
  if (linear) {
    const float ax = sub(1.0f, fx), ay = sub(1.0f, fy);
    const float w00 = mul(ax, ay), w10 = mul(fx, ay);
    const float w01 = mul(ax, fy), w11 = mul(fx, fy);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out.c[c] = add(add(add(mul(corner[0].c[c], w00), mul(corner[1].c[c], w10)),
                         mul(corner[2].c[c], w01)),
                     mul(corner[3].c[c], w11));
  } else {
    // The nearest corner, chosen channel by channel: a runtime index
    // into corner[] would put it in local memory.
    const bool px = fx >= 0.5f, py = fy >= 0.5f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out.c[c] = py ? (px ? corner[3].c[c] : corner[2].c[c])
                    : (px ? corner[1].c[c] : corner[0].c[c]);
  }
  return out;
}

// combiner._select8 for one lane: the plane of operand `id`, + 0.0.
__device__ __forceinline__ float pick(int id, float p0, float p1, float p2,
                                      float p3, float p4, float p5, float p6,
                                      float p7) {
  float x;
  switch (id) {
    case 0: x = p0; break;
    case 1: x = p1; break;
    case 2: x = p2; break;
    case 3: x = p3; break;
    case 4: x = p4; break;
    case 5: x = p5; break;
    case 6: x = p6; break;
    case 7: x = p7; break;
    default: x = 0.0f;
  }
  return add(x, 0.0f);
}

// combiner_eval_planar's scalar formula over the with-alpha table.
__device__ __forceinline__ float scalar_formula(const int* j, const float* tab,
                                                float gen_mul) {
  const auto sel = [&](int id) {
    return pick(id, tab[0], tab[1], tab[2], tab[3], tab[4], tab[5], tab[6], tab[7]);
  };
  const float a = sel(j[0]), b = sel(j[1]), cc = sel(j[2]), dd = sel(j[3]);
  if (j[2] == 0) return dd;
  if (j[1] == 0 && j[3] == 0) return mul(a, cc);
  if (j[1] == j[3]) return add(b, mul(sub(a, b), cc));
  return add(mul(sub(a, b), gen_mul), dd);
}

// combiner.combiner_eval_planar for one lane (in3 = in4 = (0, 0, 0, 1)).
__device__ Rgba combine(const int* items, bool opt_alpha, bool alpha_same,
                        const Rgba& in1, const Rgba& in2, const Rgba& tex0,
                        const Rgba& tex1) {
  const float t0a = tex0.c[3];
  const int i0 = items[0], i1 = items[1], i2 = items[2], i3 = items[3];
  const bool do_single = i2 == 0;
  const bool do_multiply = i1 == 0 && i3 == 0;
  const bool comp_c = do_multiply || i1 == i3;
  const auto rgb_pick = [&](int id, int c) {
    return pick(id, 0.0f, in1.c[c], in2.c[c], 0.0f, 0.0f, tex0.c[c], t0a, tex1.c[c]);
  };
  const float c_r = rgb_pick(i2, 0);
  Rgba out;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = rgb_pick(i0, c), b = rgb_pick(i1, c);
    const float cc = c == 0 ? c_r : rgb_pick(i2, c);
    const float d = rgb_pick(i3, c);
    const float ccm = do_single ? 0.0f : (comp_c ? cc : c_r);
    out.c[c] = add(mul(sub(a, b), ccm), do_multiply ? 0.0f : d);
  }
  const float a_full[8] = {0.0f, in1.c[3], in2.c[3], 1.0f, 1.0f, tex0.c[3], t0a, tex1.c[3]};
  float alpha;
  if (opt_alpha && !alpha_same) {
    const float gen = pick(items[6], a_full[0], a_full[1], a_full[2], a_full[3],
                           a_full[4], a_full[5], a_full[6], a_full[7]);
    alpha = scalar_formula(items + 4, a_full, gen);
  } else if (opt_alpha) {
    alpha = scalar_formula(items, a_full, c_r);
  } else if (i1 == 0 && i3 == 0 && i2 != 0) {
    alpha = pick(i2, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, t0a, 1.0f);
  } else {
    alpha = 1.0f;
  }
  out.c[3] = alpha;
  return out;
}

// The alpha rules after the combiner: the material's alpha scale, the
// texture edge's binarisation at 0.3, the noise.
__device__ __forceinline__ float alpha_rules(float a, float scale, bool edge,
                                             bool noisy, float noise) {
  a = clamp01(mul(a, scale));
  if (edge) a = a > 0.3f ? 1.0f : 0.0f;
  if (noisy) a = mul(a, rintf(noise));
  return a;
}

// raydiff.uv_differentials + lod_from_duv: the diffuse fetch's mip level.
// The planes of the unit direction and of the transferred differentials
// keep the layout of ray_dir and of d_ddx, d_ddy.
__device__ int mip_level(const Params& p, int lane, V3 dir, V3 e1, V3 e2,
                         V3 fn, const Row& row, float wf, float hf) {
  const bool dir_lm = p.variant & V_DIR_LANE_MAJOR;
  const float t = p.t_hit[static_cast<long long>(lane) * p.t_stride];
  const long long xl = static_cast<long long>(lane) * p.ddx_lane;
  const long long yl = static_cast<long long>(lane) * p.ddy_lane;
  const V3 ddx = {p.ddx[xl], p.ddx[p.ddx_row + xl], p.ddx[2LL * p.ddx_row + xl]};
  const V3 ddy = {p.ddy[yl], p.ddy[p.ddy_row + yl], p.ddy[2LL * p.ddy_row + yl]};
  const float dlen = __fsqrt_rn(clamp_min(dot_as(dir_lm, dir, dir), 1e-20f));
  const V3 d = {dvd(dir.x, dlen), dvd(dir.y, dlen), dvd(dir.z, dlen)};
  const float tt = mul(t, dlen);
  // propagate from the camera (d_odx = d_ody = 0)
  V3 dodx = vscale(ddx, tt), dody = vscale(ddy, tt);
  dodx = {add(0.0f, dodx.x), add(0.0f, dodx.y), add(0.0f, dodx.z)};
  dody = {add(0.0f, dody.x), add(0.0f, dody.y), add(0.0f, dody.z)};
  const float rcp_dn = mul(dvd(1.0f, dot_as(dir_lm, d, fn)), 1.0f);
  const float dtdx = mul(-dot_as(p.variant & V_DDX_LANE_MAJOR, dodx, fn), rcp_dn);
  const float dtdy = mul(-dot_as(p.variant & V_DDY_LANE_MAJOR, dody, fn), rcp_dn);
  const V3 sx = vscale(d, dtdx), sy = vscale(d, dtdy);
  dodx = {add(dodx.x, sx.x), add(dodx.y, sx.y), add(dodx.z, sx.z)};
  dody = {add(dody.x, sy.x), add(dody.y, sy.y), add(dody.z, sy.z)};
  // barycentric differentials
  const V3 nu = cross(e2, fn), nv = cross(e1, fn);
  const float du = dot(nu, e1), dv = dot(nv, e2);
  const V3 lu = {dvd(nu.x, du), dvd(nu.y, du), dvd(nu.z, du)};
  const V3 lv = {dvd(nv.x, dv), dvd(nv.y, dv), dvd(nv.z, dv)};
  const float bx0 = dot(lu, dodx), bx1 = dot(lv, dodx);
  const float by0 = dot(lu, dody), by1 = dot(lv, dody);
  // texture differentials
  const float uv01u = sub(row[T_UV + 2], row[T_UV]), uv01v = sub(row[T_UV + 3], row[T_UV + 1]);
  const float uv02u = sub(row[T_UV + 4], row[T_UV]), uv02v = sub(row[T_UV + 5], row[T_UV + 1]);
  const float dxu = add(mul(uv01u, bx0), mul(uv02u, bx1));
  const float dxv = add(mul(uv01v, bx0), mul(uv02v, bx1));
  const float dyu = add(mul(uv01u, by0), mul(uv02u, by1));
  const float dyv = add(mul(uv01v, by0), mul(uv02v, by1));
  const auto sq = [](float x) { return mul(x, x); };
  const float fx = add(sq(mul(dxu, wf)), sq(mul(dxv, hf)));
  const float fy = add(sq(mul(dyu, wf)), sq(mul(dyv, hf)));
  float lod = mul(0.5f, log2f(clamp_min(maximum(fx, fy), 1e-20f)));
  lod = clamp_max(clamp_min(lod, 0.0f), static_cast<float>(MAX_MIP_LEVELS - 1));
  return to_int(rintf(lod));
}

// texture.mip_select: (offset, w, h) of a level by the chain's arithmetic.
__device__ __forceinline__ void mip_select(int& off, int& w, int& h, int level) {
  int acc = off, cw = w, ch = h;
#pragma unroll
  for (int l = 1; l < MAX_MIP_LEVELS; ++l) {
    const bool has_level = cw > 1 || ch > 1;
    acc += cw * ch;
    cw = max(cw >> 1, 1);
    ch = max(ch >> 1, 1);
    if (level >= l && has_level) {
      off = acc;
      w = cw;
      h = ch;
    }
  }
}

// shading.tangent_binormal for one lane. Its edge planes are lane-major.
__device__ void tangent_binormal(const Row& row, V3 vertex_normal, V3& tangent,
                                 V3& binormal) {
  const V3 p0 = row.v3(T_P0), p1 = row.v3(T_P1), p2 = row.v3(T_P2);
  const float u0 = row[T_UV], v0 = row[T_UV + 1], u1 = row[T_UV + 2];
  const float v1 = row[T_UV + 3], u2 = row[T_UV + 4], v2 = row[T_UV + 5];
  const float uva = sub(u1, u0), uvb = sub(u2, u0);
  const float uvc = sub(v1, v0), uvd = sub(v2, v0);
  const float uvk = sub(mul(uvb, uvc), mul(uva, uvd));
  const V3 dpos1 = vsub(p1, p0), dpos2 = vsub(p2, p0);
  if (uvk != 0.0f)
    tangent = normalize<true>(vsub(vscale(dpos2, uvc), vscale(dpos1, uvd)));
  else if (uva != 0.0f)
    tangent = normalize<true>(dpos1);
  else if (uvb != 0.0f)
    tangent = normalize<true>(dpos2);
  else
    tangent = {0.0f, 0.0f, 0.0f};
  const float d1u = sub(u1, u0), d1v = -sub(v1, v0);
  const float d2u = sub(u2, u1), d2v = -sub(v2, v1);
  const float crz = sub(mul(d1u, d2v), mul(d1v, d2u));
  binormal = vscale(cross(tangent, vertex_normal), crz < 0.0f ? -1.0f : 1.0f);
}

template <bool SHADOW, bool TEXEL1, bool NMAP, bool SMAP, bool MIPS>
__global__ void __launch_bounds__(HIT_THREADS) hit_shade_kernel(const Params p) {
  const int lane = blockIdx.x * HIT_THREADS + threadIdx.x;
  if (lane >= p.m) return;
  const size_t m = static_cast<size_t>(p.m);
  const long long li = lane;

  const long long tri = p.tri_is64
      ? static_cast<const long long*>(p.tri)[li * p.tri_stride]
      : static_cast<const int*>(p.tri)[li * p.tri_stride];
  const bool valid = tri >= 0;
  const long long ts = min(max(tri, 0LL), static_cast<long long>(p.n_tri) - 1);
  const Row row{p.tri_rows + ts * TROW};

  // rows_t: the gathered row, lane-contiguous.
  const float2* row2 = reinterpret_cast<const float2*>(row.p);
#pragma unroll 4
  for (int r = 0; r < TROW / 2; ++r) {
    const float2 x = __ldg(row2 + r);
    p.rows_t[(2 * r) * m + lane] = x.x;
    p.rows_t[(2 * r + 1) * m + lane] = x.y;
  }
  p.instance[lane] = valid ? to_int(row[T_INST]) : -1;

  const float u = p.u[li * p.u_stride];
  const float v = p.v[li * p.v_stride];
  const Bary b{sub(sub(1.0f, u), v), u, v};
  const long long dl = li * p.dir_lane;
  const V3 dir = {p.dir[dl], p.dir[p.dir_row + dl], p.dir[2LL * p.dir_row + dl]};

  const V3 p0 = row.v3(T_P0), p1 = row.v3(T_P1), p2 = row.v3(T_P2);
  const float uv_u = b.at(row[T_UV], row[T_UV + 2], row[T_UV + 4]);
  const float uv_v = b.at(row[T_UV + 1], row[T_UV + 3], row[T_UV + 5]);
  Rgba in1, in2;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    in1.c[c] = b.at(row[T_IN1 + c], row[T_IN1 + 4 + c], row[T_IN1 + 8 + c]);
    in2.c[c] = b.at(row[T_IN2 + c], row[T_IN2 + 4 + c], row[T_IN2 + 8 + c]);
  }
  const V3 e1 = vsub(p1, p0), e2 = vsub(p2, p0);
  const V3 tri_nrm = cross(e1, e2);

  const int flags = to_int(row[T_FLAGS]);
  const int sampler = to_int(row[T_SAMPLER]);
  const bool linear = (sampler & 3) == 1;
  const int h_addr = (sampler >> 2) & 3, v_addr = (sampler >> 4) & 3;
  const int cc = to_int(row[T_CC]);
  int items[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    items[i] = (cc >> (i * 3)) & 7;
    items[4 + i] = (cc >> (12 + i * 3)) & 7;
  }
  const auto rec = [&](int j, int k) { return row[T_REC + 3 * j + k]; };

  // TEXEL0, with the ray-differential mip level on the opaque camera hit.
  const bool ok_t0 = (flags & F_USE_T0) && valid && row[T_TEX_D] >= 0.0f;
  int d_off = to_int(rec(0, 0)), d_w = to_int(rec(0, 1)), d_h = to_int(rec(0, 2));
  if (MIPS) {
    const int level = mip_level(p, lane, dir, e1, e2, tri_nrm, row, rec(0, 1),
                                rec(0, 2));
    mip_select(d_off, d_w, d_h, (flags & F_MIP_LOD) && valid ? level : 0);
  }
  Rgba tex0 = sample(p, d_off, d_w, d_h, ok_t0, uv_u, uv_v, linear, h_addr, v_addr);
  const float mix_r = row[T_MAT + M_DIFFUSE_MIX], mix_g = row[T_MAT + M_DIFFUSE_MIX + 1];
  const float mix_b = row[T_MAT + M_DIFFUSE_MIX + 2], mix_a = row[T_MAT + M_DIFFUSE_MIX + 3];
  const float mix[3] = {mix_r, mix_g, mix_b};
  if (!SHADOW) {
    // The negative diffuse mix, before the combiner.
    const float neg = clamp_min(-mix_a, 0.0f);
    const float keep = sub(1.0f, neg);
#pragma unroll
    for (int c = 0; c < 3; ++c) tex0.c[c] = add(mul(tex0.c[c], keep), mul(mix[c], neg));
  }
  Rgba tex1{{1.0f, 0.0f, 1.0f, 1.0f}};  // magenta where no TEXEL1 is bound
  if (TEXEL1) {
    const bool ok_t1 = (flags & F_USE_T1) && valid && row[T_TEX_D2] >= 0.0f;
    if (ok_t1)
      tex1 = sample(p, to_int(rec(1, 0)), to_int(rec(1, 1)), to_int(rec(1, 2)), true,
                    uv_u, uv_v, linear, h_addr, v_addr);
  }
  const Rgba color = combine(items, flags & F_OPT_ALPHA, flags & F_ALPHA_SAME, in1,
                             in2, tex0, tex1);
  const bool opt_edge = flags & F_TEXTURE_EDGE, opt_noise = flags & F_NOISE;
  const float noise = p.noise[li * p.noise_stride];

  if (SHADOW) {
    // The shadow any-hit: only opt_alpha combiners attenuate.
    float alpha = alpha_rules(color.c[3], row[T_MAT + M_SHADOW_ALPHA], opt_edge,
                              opt_noise, noise);
    if (!(flags & F_OPT_ALPHA)) alpha = 1.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p.color[c * m + lane] = color.c[c];
      p.normal[c * m + lane] = 0.0f;
    }
    p.color[3 * m + lane] = valid ? alpha : 0.0f;
    return;
  }

  // The vertex normal, the face normal where it is zero, facing the ray.
  const V3 n_interp = b.at(row.v3(T_N0), row.v3(T_N1), row.v3(T_N2));
  const bool interp_zero = n_interp.x == 0.0f && n_interp.y == 0.0f && n_interp.z == 0.0f;
  const V3 normal_preflip = normalize(select(interp_zero, tri_nrm, n_interp));
  const float normal_sign = dot(tri_nrm, dir) <= 0.0f ? 1.0f : -1.0f;
  V3 normal = vscale(normal_preflip, normal_sign);

  // The positive diffuse mix, after the combiner; the alpha rules.
  const float pos_mix = clamp_min(mix_a, 0.0f);
  const float keep = sub(1.0f, pos_mix);
  float rgb[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb[c] = add(mul(color.c[c], keep), mul(mix[c], pos_mix));
  const float alpha = alpha_rules(color.c[3], row[T_MAT + M_SOLID_ALPHA], opt_edge,
                                  opt_noise, noise);

  const float uv_scale = row[T_MAT + M_UV_DETAIL];
  if (NMAP) {
    const bool do_nmap = (flags & F_NORMAL_MAP) && row[T_TEX_N] >= 0.0f && valid;
    if (do_nmap) {
      V3 tangent, binormal;
      tangent_binormal(row, normal_preflip, tangent, binormal);
      tangent = vscale(tangent, normal_sign);
      binormal = vscale(binormal, normal_sign);
      const Rgba nm = sample(p, to_int(rec(2, 0)), to_int(rec(2, 1)), to_int(rec(2, 2)),
                             true, mul(uv_u, uv_scale), mul(uv_v, uv_scale), linear,
                             h_addr, v_addr);
      float ncol[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) ncol[c] = sub(mul(nm.c[c], 2.0f), 1.0f);
      const V3 a = vscale(normal, ncol[2]), t = vscale(tangent, ncol[0]);
      const V3 bn = vscale(binormal, ncol[1]);
      normal = normalize({add(add(a.x, t.x), bn.x), add(add(a.y, t.y), bn.y),
                          add(add(a.z, t.z), bn.z)});
    }
  }
  V3 specular = {1.0f, 1.0f, 1.0f};
  if (SMAP) {
    const bool do_smap = (flags & F_SPECULAR_MAP) && row[T_TEX_S] >= 0.0f && valid;
    if (do_smap) {
      const Rgba sm = sample(p, to_int(rec(3, 0)), to_int(rec(3, 1)), to_int(rec(3, 2)),
                             true, mul(uv_u, uv_scale), mul(uv_v, uv_scale), linear,
                             h_addr, v_addr);
      specular = {sm.c[0], sm.c[1], sm.c[2]};
    }
  }
  // The motion flow: this frame's hit point less the previous frame's.
  const V3 pos = b.at(p0, p1, p2);
  const V3 prev = b.at(row.v3(T_PP0), row.v3(T_PP1), row.v3(T_PP2));
  const V3 flow = vsub(pos, prev);

  const float out4[4] = {rgb[0], rgb[1], rgb[2], alpha};
#pragma unroll
  for (int c = 0; c < 4; ++c) p.color[c * m + lane] = valid ? out4[c] : 0.0f;
  const float n3[3] = {normal.x, normal.y, normal.z};
  const float s3[3] = {specular.x, specular.y, specular.z};
  const float f3[3] = {flow.x, flow.y, flow.z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    p.normal[c * m + lane] = valid ? n3[c] : 0.0f;
    p.specular[c * m + lane] = valid ? s3[c] : 0.0f;
    p.flow[c * m + lane] = valid ? f3[c] : 0.0f;
  }
}

template <bool SHADOW, bool TEXEL1, bool NMAP, bool SMAP, bool MIPS>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.m + HIT_THREADS - 1) / HIT_THREADS);
  hit_shade_kernel<SHADOW, TEXEL1, NMAP, SMAP, MIPS><<<grid, HIT_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <bool TEXEL1, bool NMAP, bool SMAP>
cudaError_t launch_mips(const Params& p, int variant, cudaStream_t stream) {
  return variant & V_MIPS ? launch<false, TEXEL1, NMAP, SMAP, true>(p, stream)
                          : launch<false, TEXEL1, NMAP, SMAP, false>(p, stream);
}

template <bool TEXEL1, bool NMAP>
cudaError_t launch_smap(const Params& p, int variant, cudaStream_t stream) {
  return variant & V_SPECULAR_MAPS ? launch_mips<TEXEL1, NMAP, true>(p, variant, stream)
                                   : launch_mips<TEXEL1, NMAP, false>(p, variant, stream);
}

template <bool TEXEL1>
cudaError_t launch_lit(const Params& p, int variant, cudaStream_t stream) {
  return variant & V_NORMAL_MAPS ? launch_smap<TEXEL1, true>(p, variant, stream)
                                 : launch_smap<TEXEL1, false>(p, variant, stream);
}

}  // namespace

// Shades m hit lanes. tri_rows (n_tri, TROW) f32; tri (m,) int32 or int64
// (tri_is64) with element stride tri_stride; u, v, noise (m,) f32 and the
// ray directions dir (3, m) f32 (row and lane strides); for the mip level
// (variant V_MIPS) t_hit (m,) and the camera-ray differentials ddx, ddy
// (3, m). The quad pool: pool_quads quads of four uint32 words held in
// int64, wide (pool_wide: rows of QPR quads, corner-major) or (quads, 4).
// Writes color (4, m), normal, specular, flow (3, m) f32, instance (m,)
// int32 and rows_t (TROW, m) f32 on the stream; the shadow variant writes
// color and a zero normal plane, and neither specular nor flow.
extern "C" cudaError_t rt64_hit_shade(
    const float* tri_rows, int n_tri, const void* tri, int tri_is64,
    int tri_stride, const float* u, int u_stride, const float* v,
    int v_stride, const float* noise, int noise_stride, const float* dir,
    int dir_row, int dir_lane, const float* t_hit, int t_stride,
    const float* ddx, int ddx_row, int ddx_lane, const float* ddy,
    int ddy_row, int ddy_lane, const long long* pool, int pool_quads,
    int pool_wide, int m, int variant, float* color, float* normal,
    float* specular, float* flow, int* instance, float* rows_t,
    cudaStream_t stream) {
  if (m <= 0) return cudaSuccess;
  if (n_tri < 1 || pool_quads < 1) return cudaErrorInvalidValue;
  const Params p{tri_rows, n_tri, tri, tri_is64, tri_stride, u, u_stride, v,
                 v_stride, noise, noise_stride, dir, dir_row, dir_lane, t_hit,
                 t_stride, ddx, ddx_row, ddx_lane, ddy, ddy_row, ddy_lane, pool,
                 pool_quads, pool_wide, m, variant, color, normal, specular,
                 flow, instance, rows_t};
  if (variant & V_SHADOW)
    return variant & V_TEXEL1 ? launch<true, true, false, false, false>(p, stream)
                              : launch<true, false, false, false, false>(p, stream);
  return variant & V_TEXEL1 ? launch_lit<true>(p, variant, stream)
                            : launch_lit<false>(p, variant, stream);
}
