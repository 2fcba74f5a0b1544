// The deferred shade on Hopper (sm_90a): one thread a lane.
//
// Replaces no TPU kernel. The JAX package computes this in XLA:
// superconductor_tpu/ops/shade.py:410 shade, with its helpers at :188-289
// (_normalize, eval_sh_nonlinear, ggx_specular, sh_specular_approximation,
// compute_cotangent_frame_normal) and ops/tonemap.py. The port ran it as a
// chain of about 190 torch operations a call (ops/shade.py
// shade_lanes_plain, which stays as the plain version), each writing its
// whole (lanes, 3) or (lanes,) result to device memory for the next to
// read back.
//
// shade_kernel: what ops/shade.py shade computes after the material
// sampling, a lane at a time. Its inputs: the g-buffer's valid,
// front_facing, normal, world_pos, dpdx, dpdy, duvdx and duvdy; the
// lane's sampled textures s16 (albedo, normal, metallic-roughness,
// emissive); the factors (columns 0-9) and the MAT_UNLIT flag (column 16)
// of the lane's material row, read in place from the row table (mat_row_mq
// or mat_row by material id, or the g-buffer's mat_tail, a row a lane);
// the lane's SH: sampled here from the light volume's and the lightmaps'
// SH pools at the g-buffer's world_pos, lm_uv and lightmapped
// (csrc/sh_sample.cuh, the instantiation shade_kernel<true>), or (4, 3)
// coefficients given a lane, or the 12 ambient ones by value; and the
// view's eye, read through a device pointer (a CUDA graph's input buffer
// that a new pose overwrites). It writes rgb (P, 3) and alpha (P,).
//
// Per lane, in the chain's order: the factors and the albedo, metallic,
// roughness and emissive terms; the geometric normal, flipped for a back
// face; the normal map in the cotangent frame of dpdx, dpdy, duvdx and
// duvdy; the view vector; eval_sh_nonlinear, sh_specular_approximation on
// the coefficients with L0 times pi^2, ggx_specular; then aces_filmic and
// linear_to_srgb_approx by the config's inline flags. An unlit material
// takes linear_to_srgb_approx of its albedo (or the albedo) instead, and
// an invalid lane is 0 in both outputs: neither computes the lit terms.
//
// What bounds it on this card: bytes. A valid lane reads its flags (2 B),
// its material id (4 B, by id), six g-buffer vectors (64 B), s16 (64 B),
// the 44 B of its material row that hold the factors and the flag (in the
// 32-B sectors that hold them; the frames' materials are few, so the rows
// stay in cache), on the lit scenes the 96-B pool rows of its SH taps
// (neighbouring lanes share them) or 48 B of given SH, and writes 16 B; an
// invalid lane reads its valid byte and writes 16 B. The arithmetic, 346
// FP32 operations a lit lane before the display transform and 379 with it,
// counting each powf, square root and reciprocal square root as one
// (chip_smoke.py shade_bound), is under the bytes at the card's rate.
//
// Design: registers only, nothing written but the result; s16 with 16-B
// loads where its rows are aligned; the lanes' vectors read where they lie
// (any lane stride); an invalid lane reads nothing more, an unlit one only
// its albedo.
//
// Bit for bit with the torch chain on the card (csrc/torch_exact.cuh):
// every product, sum and quotient in the chain's order, the three-term
// sums (x0 + x1) + x2 and the cross products a1 b2 - a2 b1, a2 b0 - a0 b2,
// a0 b1 - a1 b0, as ops/shade.py writes them out; torch.rsqrt is rsqrtf,
// torch.sqrt the IEEE square root, torch.pow powf with the exponent as the
// chain gives it (pexp a tensor, 5.0 and 1 / 2.2 rounded to f32); Python
// float constants are rounded once to f32 (math.pi, math.pi * math.pi,
// 255 / 127, 128 / 127, 1e-12, 1e-20, 1e-8, 1e-4, 0.04); / 3.0 is a
// product with (float)(1 / 3.0) (scalar_quo), 0.5 / t the reciprocal times
// 0.5; clamp_min, maximum and clamp keep a NaN.

// shade_kernel(const ParticleShadeArgs), the particle shade: what
// ops/particles.py shade_particles computes for a layer's lanes, a lane a
// thread. It replaces no TPU kernel either: the JAX package computes it in
// XLA (superconductor_tpu/ops/particles.py:166 shade_particles), the port
// ran it as a chain of about 130 torch operations a layer
// (shade_particles_plain, the plain version). Per lane, in the chain's
// order: the packed row of max(pair, 0) (ParticleAttrs.packed); the
// barycentrics from its adjoint edges at the pixel centre (e / d, d == 0
// taken as 1), the interpolated uv and world position; the normal towards
// the eye from the quad's centre and the cotangent frame of the camera's
// right and down axes; the smoke maps (the procedural puff, the
// interleaved smoke pool's 32-B row, or each map's level-0 tap from the
// LDR pool by its descriptor rows); the six-way light map of the SH's
// average direction, the directional and ambient terms, the emission from
// the LUT (the pool's own rows or the LDR pool, sRGB-decoded by the
// texture's flag) or the emissive mask; the display transform by the two
// inline flags; alpha, 0 where pair < 0. A dead lane is computed as the
// chain computes it, on row 0. The SH is the 12 ambient values by value
// where the environment binds no light volume and no lightmaps (one launch
// a layer); else the position form (`form` 1) writes the lanes' world
// positions, the frame's SH sampler (a torch chain) samples them, and the
// full form reads the (P, 4, 3) result by its strides (two launches).
// Where the frame's sampler is a PoolSH whose pools are bound
// (ops/particles.py sh_form "pools"), the one launch of shade_kernel<true>
// samples the SH at the lane's interpolated position as the frame's
// stand-in g-buffer asks it (lm_uv 0, not lightmapped: the volume where one
// is bound), csrc/sh_sample.cuh.
//
// What bounds it on this card: the instructions, then the bytes. A lane
// reads its pair (4 B) and pixel centre (8 B) and writes rgb and alpha
// (16 B); its packed row (128 B), its texels and its SH pool rows (96 B a
// tap) are rows of tables that stay in cache. Its arithmetic is 450-900
// instructions (chip_smoke.py particle_bound_parts: about 450 with the
// smoke pool, 450 more for the light volume's two SH taps), above the
// bytes at the card's issue rate wherever most lanes are distinct.
// Design: a thread a lane, registers only, the row read with 16-B loads
// where it is aligned, nothing written but the result. A dead lane (pair
// -1) whose key the lane a stride before holds returns at once: the stride
// is as many threads as the card holds at once (particle_resident_threads,
// by instantiation), and the first lane of each run of equal keys along it
// computes its result and copies it down the run, so that a frame's dead
// tail (pair -1 at one granule's pixel centres, repeating with a period
// that divides the stride) is computed once a stride; a given SH is an
// input of its own, so its lanes are each computed.
//
// Bit for bit with the chain on the card, beside the rules above: torch.sum
// over a contiguous (P, 3) last dim adds (x0 + x2) + x1 (its reduction
// splits the three values over two threads) and torch.mean multiplies that
// sum by (float)(1 / 3); torch.sum over the corners of (P, 3, C) adds (x0 +
// x1) + x2; both give +0 for a zero sum (their accumulators start at +0);
// torch.linalg.cross's kernel, built with contraction, computes each
// component a1 b2 - a2 b1 as fma(a1, b2, -(a2 b1)) (all measured on the
// card, torch 2.11: chip_smoke.py [particles]).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sh_sample.cuh"
#include "torch_exact.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnlitFlagCol = 16;  // ops/sample.py FLAGS + 4: pi[4]
constexpr int kMatUnlit = 1;       // ops/shade.py MAT_UNLIT
constexpr double kPi = 3.141592653589793;  // math.pi

struct ShadeArgs {
  int lanes;
  const uint8_t* valid;
  long long valid_s;
  const uint8_t* front_facing;
  long long ff_s;
  // normal, world_pos, dpdx, dpdy (P, 3); duvdx, duvdy (P, 2): lane strides
  const float* normal;
  long long normal_s;
  const float* world_pos;
  long long wp_s;
  const float* dpdx;
  long long dpdx_s;
  const float* dpdy;
  long long dpdy_s;
  const float* duvdx;
  long long duvdx_s;
  const float* duvdy;
  long long duvdy_s;
  const float* s16;  // (P, 16)
  long long s16_s;
  int s16_vec;  // s16's rows are 16-B aligned
  const float* rows;  // the material rows: rows[mat[p]], or rows[p] when mat is null
  long long rows_s;
  long long n_rows;
  const int* mat;
  long long mat_s;
  const float* sh;  // (P, 4, 3), the (4, 3) adjacent; null: the pools or ambient
  long long sh_s;
  ShPools pools;  // with sh null and a pool bound: the SH sampled here
  const float* lm_uv;  // (P, 2): the lightmaps' uv
  long long lm_uv_s;
  const uint8_t* lightmapped;  // (P,)
  long long lightmapped_s;
  float ambient[12];
  const float* eye;  // the view's (3,) eye on the device
  long long eye_s;
  int aces;
  int srgb;
  float* rgb;  // (P, 3)
  float* alpha;  // (P,)
};

// ops/tonemap.py aces_filmic: clamp((x (a x + b)) / (x (c x + d) + e), 0, 1)
__device__ __forceinline__ float aces(float x) {
  const float a = (float)2.51, b = (float)0.03, c = (float)2.43, d = (float)0.59,
              e = (float)0.14;
  return clamp(quo(mul(x, add(mul(x, a), b)), add(mul(x, add(mul(x, c), d)), e)), 0.0f, 1.0f);
}

// ops/tonemap.py linear_to_srgb_approx: clamp(x, 0, 1) ** (1 / 2.2)
__device__ __forceinline__ float srgb_approx(float x) {
  return powf(clamp(x, 0.0f, 1.0f), (float)(1.0 / 2.2));
}

// _sum3: (x0 + x1) + x2
__device__ __forceinline__ float sum3(float x0, float x1, float x2) { return add(add(x0, x1), x2); }

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return sum3(mul(a[0], b[0]), mul(a[1], b[1]), mul(a[2], b[2]));
}

// _normalize: v * rsqrt(clamp_min(_sum3(v * v), 1e-12)), in place
__device__ __forceinline__ void normalize(float* v) {
  const float r = rsqrtf(clamp_min(dot3(v, v), (float)1e-12));
  v[0] = mul(v[0], r);
  v[1] = mul(v[1], r);
  v[2] = mul(v[2], r);
}

// _cross: (a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0)
__device__ __forceinline__ void cross(const float* a, const float* b, float* out) {
  out[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  out[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  out[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

template <int C>
__device__ __forceinline__ void load_vec(const float* base, long long p, long long s, float* v) {
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = __ldg(base + p * s + c);
}

// kPools: the SH sampled from a.pools (csrc/sh_sample.cuh); otherwise given
// (a.sh) or the ambient values. Two instantiations, so that a frame without
// the pools runs code free of the sampler's registers.
template <bool kPools>
__global__ void __launch_bounds__(kThreads) shade_kernel(const ShadeArgs a) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.lanes) return;
  float* rgb = a.rgb + p * 3;
  if (__ldg(a.valid + p * a.valid_s) == 0) {
    rgb[0] = rgb[1] = rgb[2] = 0.0f;
    a.alpha[p] = 0.0f;
    return;
  }

  // the sampled textures and the material row's factors
  float s[16];
  if (a.s16_vec) {
    const float4* r4 = reinterpret_cast<const float4*>(a.s16 + p * a.s16_s);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 q = __ldg(r4 + k);
      s[4 * k] = q.x;
      s[4 * k + 1] = q.y;
      s[4 * k + 2] = q.z;
      s[4 * k + 3] = q.w;
    }
  } else {
    load_vec<16>(a.s16, p, a.s16_s, s);
  }
  const long long r = a.mat == nullptr ? p : row_of(__ldg(a.mat + p * a.mat_s), a.n_rows);
  const float* row = a.rows + r * a.rows_s;
  float pf[10];
#pragma unroll
  for (int c = 0; c < 10; ++c) pf[c] = __ldg(row + c);
  const bool unlit = (__float_as_int(__ldg(row + kUnlitFlagCol)) & kMatUnlit) != 0;

  float albedo[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) albedo[c] = mul(s[c], pf[c]);
  a.alpha[p] = mul(s[3], pf[3]);
  if (unlit) {
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = a.srgb ? srgb_approx(albedo[c]) : albedo[c];
    return;
  }
  const float metallic = mul(s[10], pf[7]);
  const float roughness = mul(s[9], pf[8]);
  float emissive[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) emissive[c] = mul(s[12 + c], pf[4 + c]);

  // the geometric normal, flipped for a back face
  float g[3];
  load_vec<3>(a.normal, p, a.normal_s, g);
  normalize(g);
  if (__ldg(a.front_facing + p * a.ff_s) == 0) {
    g[0] = -g[0];
    g[1] = -g[1];
    g[2] = -g[2];
  }
  // the tangent-space normal: s * 255/127 - 128/127, x and y scaled
  float m[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    m[j] = sub(mul(s[4 + j], (float)(255.0 / 127.0)), (float)(128.0 / 127.0));
  m[0] = mul(m[0], pf[9]);
  m[1] = mul(m[1], pf[9]);
  m[2] = mul(m[2], 1.0f);
  normalize(m);

  // compute_cotangent_frame_normal
  float dpdx[3], dpdy[3], duvdx[2], duvdy[2];
  load_vec<3>(a.dpdx, p, a.dpdx_s, dpdx);
  load_vec<3>(a.dpdy, p, a.dpdy_s, dpdy);
  load_vec<2>(a.duvdx, p, a.duvdx_s, duvdx);
  load_vec<2>(a.duvdy, p, a.duvdy_s, duvdy);
  float dp2[3], dp1[3], t[3], b[3];
  cross(dpdy, g, dp2);
  cross(g, dpdx, dp1);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    t[j] = add(mul(dp2[j], duvdx[0]), mul(dp1[j], duvdy[0]));
    b[j] = add(mul(dp2[j], duvdx[1]), mul(dp1[j], duvdy[1]));
  }
  const float invmax = rsqrtf(clamp_min(maximum(dot3(t, t), dot3(b, b)), (float)1e-20));
  float n[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    n[j] = add(add(mul(mul(t[j], invmax), m[0]), mul(mul(b[j], invmax), m[1])), mul(g[j], m[2]));
  normalize(n);

  // the view vector
  float v[3];
  load_vec<3>(a.world_pos, p, a.wp_s, v);

  // sh[k][c]: L0, L1x, L1y, L1z by colour
  float sh[12];
  if (kPools) {
    const bool lightmapped =
        a.lightmapped != nullptr && __ldg(a.lightmapped + p * a.lightmapped_s) != 0;
    float lu = 0.0f, lv = 0.0f;
    if (a.pools.lm != nullptr && (a.pools.lv == nullptr || lightmapped)) {
      lu = __ldg(a.lm_uv + p * a.lm_uv_s);
      lv = __ldg(a.lm_uv + p * a.lm_uv_s + 1);
    }
    sample_sh(a.pools, v, lu, lv, lightmapped, sh);
  } else if (a.sh != nullptr) {
    load_vec<12>(a.sh, p, a.sh_s, sh);
  } else {
#pragma unroll
    for (int k = 0; k < 12; ++k) sh[k] = a.ambient[k];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) v[j] = sub(__ldg(a.eye + j * a.eye_s), v[j]);
  normalize(v);

  // diffuse: albedo * (1 - metallic) * eval_sh_nonlinear(sh, n)
  const float one_m = sub(1.0f, metallic);
  float diffuse[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float s1 = sh[3 + c], s2 = sh[6 + c], s3 = sh[9 + c];
    const float length =
        __fsqrt_rn(add(sum3(mul(s1, s1), mul(s2, s2), mul(s3, s3)), (float)1e-20));
    const float ea = quo(sub(1.0f, length), add(length, 1.0f));
    const float pexp = add(mul(length, 2.0f), 1.0f);
    const float ndot = sum3(mul(s1, n[0]), mul(s2, n[1]), mul(s3, n[2]));
    const float q = clamp_min(mul(add(ndot, 1.0f), 0.5f), 0.0f);
    const float e =
        mul(sh[c], add(ea, mul(mul(sub(1.0f, ea), add(pexp, 1.0f)), powf(q, pexp))));
    diffuse[c] = mul(mul(albedo[c], one_m), e);
  }

  // sh_specular_approximation on sh with L0 * pi^2
  float avg[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    avg[j] = scalar_quo(sum3(sh[3 * (j + 1)], sh[3 * (j + 1) + 1], sh[3 * (j + 1) + 2]), 3.0);
  const float dir_len = __fsqrt_rn(add(dot3(avg, avg), (float)1e-20));
  const float adjusted_rp = sub(1.0f, mul(sub(1.0f, roughness), __fsqrt_rn(dir_len)));
  const float actual_roughness = mul(adjusted_rp, adjusted_rp);
  float l[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) l[j] = quo(avg[j], dir_len);

  // ggx_specular(n, v, l, actual_roughness, f0, 1)
  float h[3] = {add(v[0], l[0]), add(v[1], l[1]), add(v[2], l[2])};
  normalize(h);
  const float ndv = clamp_min(dot3(n, v), (float)1e-4);
  const float ndl = clamp_min(dot3(n, l), 0.0f);
  const float ndh = clamp_min(dot3(n, h), 0.0f);
  const float vdh = clamp_min(dot3(v, h), 0.0f);
  const float a2 = mul(actual_roughness, actual_roughness);
  const float denom = add(mul(mul(ndh, ndh), sub(a2, 1.0f)), 1.0f);
  const float d = quo(a2, clamp_min(mul(mul(denom, (float)kPi), denom), (float)1e-8));
  const float one_a2 = sub(1.0f, a2);
  const float lv = mul(ndl, __fsqrt_rn(add(mul(mul(ndv, ndv), one_a2), a2)));
  const float ll = mul(ndv, __fsqrt_rn(add(mul(mul(ndl, ndl), one_a2), a2)));
  const float vis = mul(quo(1.0f, clamp_min(add(lv, ll), (float)1e-8)), 0.5f);
  const float schlick = powf(sub(1.0f, vdh), 5.0f);
  const float dvis = mul(d, vis);

#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float f0 = add(mul(one_m, (float)0.04), mul(albedo[c], metallic));
    const float fresnel = add(f0, mul(sub(1.0f, f0), schlick));
    const float strength = mul(mul(sh[c], (float)(kPi * kPi)), dir_len);
    const float specular = mul(mul(mul(dvis, fresnel), strength), ndl);
    float x = add(add(diffuse[c], specular), emissive[c]);
    if (a.aces) x = aces(x);
    if (a.srgb) x = srgb_approx(x);
    rgb[c] = x;
  }
}


// --- The particle shade ---------------------------------------------------

constexpr int kSmokePuff = 0;  // no smoke textures bound: the procedural puff
constexpr int kSmokePool = 1;  // the interleaved smoke pool (smoke_ab, smoke_lut)
constexpr int kSmokeSlots = 2;  // each map by its descriptor from the LDR pool

// ops/particles.py shade_particles' arguments, 8 B a field (ops/particles.py
// _ShadeArgs mirrors it); strides in elements, rows of u8 tables in 4-B words
struct ParticleShadeArgs {
  long long lanes;
  long long form;  // 0: rgb and alpha; 1: the lanes' world positions only
  const int* pair;
  long long pair_s;
  const float* px;
  long long px_s;
  const float* py;
  long long py_s;
  const float* packed;  // (T, 32) rows, adjacent columns
  long long packed_s;
  long long n_rows;
  long long packed_vec;  // the rows are 16-B aligned
  const float* eye;  // the view's (3,) eye
  long long eye_s;
  const float* view_inverse;  // the view's (4, 4)
  long long vi_s0;
  long long vi_s1;
  const float* sh;  // (P, 4, 3), or null: the pools or the ambient values
  long long sh_s0;
  long long sh_s1;
  long long sh_s2;
  ShPools pools;  // with sh null and a pool bound: the SH sampled at the lane
  long long smoke;  // kSmoke*
  const uint32_t* smoke_ab;  // (w * h, 32) u8
  long long ab_s;
  long long ab_rows;
  long long ab_w;
  long long ab_h;
  long long ab_wrap;
  const uint32_t* smoke_lut;  // (lw * lh, 16) u8
  long long lut_s;
  long long lut_rows;
  long long lut_w;
  long long lut_h;
  long long lut_wrap;
  long long lut_srgb;
  const uint32_t* texels;  // the LDR pool, (N, 16) quad rows or (N, 4) texels
  long long texels_s;
  long long texels_rows;
  long long texels_quad;
  const int* tex_meta;  // (T, 4): base, count, wrap, flags
  long long meta_s;
  long long n_tex;
  const int* mip_owh;  // (L, 4): offset, w, h
  long long owh_s;
  long long n_owh;
  long long tex_a;
  long long tex_b;
  long long tex_lut;
  long long aces;
  long long srgb;
  float* rgb;  // (P, 3)
  float* alpha;  // (P,)
  float* world_pos;  // (P, 3): the position form's result
  float ambient[12];
};

// torch.sum over a contiguous (P, 3) last dim on the card: (x0 + x2) + x1,
// a zero sum +0
__device__ __forceinline__ float sum3_last(float x0, float x1, float x2) {
  return add(add(add(x0, x2), x1), 0.0f);
}

// torch.sum over the corners of (P, 3, C): (x0 + x1) + x2, a zero sum +0
__device__ __forceinline__ float sum3_corners(float x0, float x1, float x2) {
  return add(add(add(x0, x1), x2), 0.0f);
}

// torch.linalg.cross on the card: each component fma(a_i b_j, -(a_j b_i))
__device__ __forceinline__ void cross_fma(const float* a, const float* b, float* out) {
  out[0] = __fmaf_rn(a[1], b[2], -mul(a[2], b[1]));
  out[1] = __fmaf_rn(a[2], b[0], -mul(a[0], b[2]));
  out[2] = __fmaf_rn(a[0], b[1], -mul(a[1], b[0]));
}

// sqrt(torch.sum(v * v, -1)) of a contiguous (P, 3) (shade_particles' _norm)
__device__ __forceinline__ float norm3(float x0, float x1, float x2) {
  return __fsqrt_rn(sum3_last(mul(x0, x0), mul(x1, x1), mul(x2, x2)));
}

// the four texels of a bilinear tap, 4 channels each, as bytes of words
struct Texels {
  uint32_t t[4];  // t00, t10, t01, t11
};

// _lerp4 of each channel of a tap, times 1 / 255
__device__ __forceinline__ void filter(const Texels& q, float fx, float fy, float* out) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    out[c] = mul(lerp4(byte_of(q.t[0], c), byte_of(q.t[1], c), byte_of(q.t[2], c),
                       byte_of(q.t[3], c), fx, fy),
                 (float)(1.0 / 255.0));
}

// One level-0 bilinear tap of texture `tex` of the LDR pool
// (sample_bilinear_level: the descriptor rows tex_meta and mip_owh, the
// quad or the flat pool), filtered and normalised; with decode, the colour
// channels sRGB-decoded where the texture is flagged so
__device__ __forceinline__ void slot_tap(const ParticleShadeArgs& a, long long tex, float u,
                                         float v, bool decode, float* out) {
  const int* meta = a.tex_meta + row_of(tex, a.n_tex) * a.meta_s;
  const int base = __ldg(meta), count = __ldg(meta + 1), wrap = __ldg(meta + 2),
            flags = __ldg(meta + 3);
  const int lvl = min(0, iadd(count, -1));  // _clamp_to(0, count)
  const int* owh = a.mip_owh + row_of(iadd(base, lvl), a.n_owh) * a.owh_s;
  const int off = __ldg(owh), w = __ldg(owh + 1), h = __ldg(owh + 2);
  TapPos t = tap_pos(u, v, w, h);
  Texels q;
  if (a.texels_quad) {
    const uint32_t* r = a.texels + quad_row(t, off, w, h, wrap, a.texels_rows) * a.texels_s;
#pragma unroll
    for (int k = 0; k < 4; ++k) q.t[k] = __ldg(r + k);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int xi = wrap_coord(iadd(t.x0, k & 1), w, wrap);
      const int yi = wrap_coord(iadd(t.y0, k >> 1), h, wrap);
      q.t[k] = __ldg(a.texels + row_of(iadd(iadd(off, imul(yi, w)), xi), a.texels_rows) *
                                    a.texels_s);
    }
  }
  filter(q, t.fx, t.fy, out);
  if (decode && (flags & 1) != 0)
    for (int c = 0; c < 3; ++c) out[c] = srgb_to_linear(out[c]);
}

// Lane p of a layer, a function of (pair, x, y), the call's tables and,
// where the SH is given, the lane's SH: out = rgb and alpha, or with `form`
// 1 the world position (out[0..2])
template <bool kPools>
__device__ __forceinline__ void particle_lane(const ParticleShadeArgs& a, long long p, int pair,
                                              float x, float y, float out[4]) {
  const float* rp = a.packed + row_of(max(pair, 0), a.n_rows) * a.packed_s;
  float row[32];
  if (a.packed_vec) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(rp) + k);
      row[4 * k] = q.x;
      row[4 * k + 1] = q.y;
      row[4 * k + 2] = q.z;
      row[4 * k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 32; ++k) row[k] = __ldg(rp + k);
  }

  // barycentrics from the adjoint edges, the interpolated uv and position
  float e[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) e[i] = add(add(mul(row[3 * i], x), mul(row[3 * i + 1], y)), row[3 * i + 2]);
  const float d = sum3_last(e[0], e[1], e[2]);
  const float dd = d == 0.0f ? 1.0f : d;
  float bary[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) bary[i] = quo(e[i], dd);
  float wp[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    wp[c] = sum3_corners(mul(row[15 + c], bary[0]), mul(row[18 + c], bary[1]),
                         mul(row[21 + c], bary[2]));
  if (a.form == 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = wp[c];
    return;
  }
  float uv[2];
#pragma unroll
  for (int c = 0; c < 2; ++c)
    uv[c] = sum3_corners(mul(row[9 + c], bary[0]), mul(row[11 + c], bary[1]),
                         mul(row[13 + c], bary[2]));

  // the normal towards the eye from the quad's centre
  const bool diag1 = row[31] > 0.5f;
  float normal[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float partner = diag1 ? row[18 + c] : row[21 + c];
    normal[c] = sub(__ldg(a.eye + c * a.eye_s), mul(add(row[15 + c], partner), 0.5f));
  }
  normalize(normal);

  // sh[k][c]: L0, L1x, L1y, L1z by colour
  float sh[12];
  if (kPools) {
    sample_sh(a.pools, wp, 0.0f, 0.0f, false, sh);  // the stand-in: lm_uv 0, not lightmapped
  } else if (a.sh != nullptr) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < 3; ++c) sh[3 * k + c] = __ldg(a.sh + p * a.sh_s0 + k * a.sh_s1 + c * a.sh_s2);
  } else {
#pragma unroll
    for (int k = 0; k < 12; ++k) sh[k] = a.ambient[k];
  }

  // the smoke maps: (left, bottom, front, emissive) and (right, top, back, alpha)
  float sa[4], sb[4];
  if (a.smoke == kSmokePool) {
    TapPos t = tap_pos(uv[0], uv[1], (int)a.ab_w, (int)a.ab_h);
    const uint32_t* r = a.smoke_ab +
        quad_row(t, 0, (int)a.ab_w, (int)a.ab_h, (int)a.ab_wrap, a.ab_rows) * a.ab_s;
    Texels qa, qb;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      qa.t[k] = __ldg(r + k);
      qb.t[k] = __ldg(r + 4 + k);
    }
    filter(qa, t.fx, t.fy, sa);
    filter(qb, t.fx, t.fy, sb);
  } else if (a.smoke == kSmokeSlots) {
    slot_tap(a, a.tex_a, uv[0], uv[1], false, sa);
    slot_tap(a, a.tex_b, uv[0], uv[1], false, sb);
  } else {
    const float du = sub(uv[0], 0.5f), dv = sub(uv[1], 0.5f);
    const float len = __fsqrt_rn(add(mul(du, du), mul(dv, dv)));
    const float fall = clamp(sub(1.0f, mul(len, 2.0f)), 0.0f, 1.0f);
    const float half = mul(fall, 0.5f);
    sa[0] = sa[1] = sa[2] = sb[0] = sb[1] = sb[2] = half;
    sa[3] = sb[3] = fall;
  }

  // the SH's average direction and the channels' lengths
  float avg[3], len[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    avg[j] = scalar_quo(add(add(sh[3 * (j + 1)], sh[3 * (j + 1) + 1]), sh[3 * (j + 1) + 2]), 3.0);
#pragma unroll
  for (int c = 0; c < 3; ++c) len[c] = norm3(sh[3 + c], sh[6 + c], sh[9 + c]);
  const float avg_len =
      clamp_min(mul(sum3_last(len[0], len[1], len[2]), (float)(1.0 / 3.0)), (float)1e-8);
  float avg_dir[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) avg_dir[j] = quo(avg[j], avg_len);

  // the cotangent frame of a screen-aligned quad and the light in it
  float right[3], down[3], t[3], b[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    right[j] = __ldg(a.view_inverse + j * a.vi_s0);
    down[j] = -__ldg(a.view_inverse + j * a.vi_s0 + a.vi_s1);
  }
  cross_fma(down, normal, t);
  normalize(t);
  cross_fma(normal, right, b);
  normalize(b);
  const float l0 = sum3_last(mul(t[0], avg_dir[0]), mul(t[1], avg_dir[1]), mul(t[2], avg_dir[2]));
  const float l1 = sum3_last(mul(b[0], avg_dir[0]), mul(b[1], avg_dir[1]), mul(b[2], avg_dir[2]));
  const float l2 = sum3_last(mul(normal[0], avg_dir[0]), mul(normal[1], avg_dir[1]),
                             mul(normal[2], avg_dir[2]));
  const float h_map = l0 > 0.0f ? sa[0] : sb[0];
  const float v_map = l1 > 0.0f ? sb[1] : sa[1];
  const float z_map = l2 > 0.0f ? sa[2] : sb[2];
  const float light_map = add(add(mul(mul(h_map, l0), l0), mul(mul(v_map, l1), l1)),
                              mul(mul(z_map, l2), l2));

  // the emission: the LUT at (emissive mask, lut_y), or the mask
  const bool use_lut = row[30] >= 0.0f;
  float lut[3] = {0.0f, 0.0f, 0.0f};
  if (a.smoke == kSmokePool) {
    TapPos tl = tap_pos(sa[3], clamp_min(row[30], 0.0f), (int)a.lut_w, (int)a.lut_h);
    const uint32_t* r = a.smoke_lut +
        quad_row(tl, 0, (int)a.lut_w, (int)a.lut_h, (int)a.lut_wrap, a.lut_rows) * a.lut_s;
    Texels q;
#pragma unroll
    for (int k = 0; k < 4; ++k) q.t[k] = __ldg(r + k);
    float l4[4];
    filter(q, tl.fx, tl.fy, l4);
#pragma unroll
    for (int c = 0; c < 3; ++c) lut[c] = a.lut_srgb ? srgb_to_linear(l4[c]) : l4[c];
  } else if (a.smoke == kSmokeSlots) {
    float l4[4];
    slot_tap(a, a.tex_lut, sa[3], clamp_min(row[30], 0.0f), true, l4);
#pragma unroll
    for (int c = 0; c < 3; ++c) lut[c] = l4[c];
  }

#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float directional = mul(sh[c], len[c]);
    const float ambient = mul(mul(sh[c], (float)0.2), sub(1.0f, len[c]));
    const float emission = mul(use_lut ? lut[c] : sa[3], row[27 + c]);
    float o = add(mul(add(mul(directional, light_map), ambient), row[24 + c]), emission);
    if (a.aces) o = aces(o);
    if (a.srgb) o = srgb_approx(o);
    out[c] = o;
  }
  out[3] = pair >= 0 ? sb[3] : 0.0f;
}

// Stores lane p's result (particle_lane's out)
__device__ __forceinline__ void store_lane(const ParticleShadeArgs& a, long long p,
                                           const float out[4]) {
  if (a.form == 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) a.world_pos[p * 3 + c] = out[c];
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) a.rgb[p * 3 + c] = out[c];
    a.alpha[p] = out[3];
  }
}

// A thread a lane. A dead lane (pair -1) whose key (pair and the bits of
// x and y) the lane `tail` before it holds is written by that lane's
// thread and returns at once; any other lane is computed by its thread,
// and a dead one then walks forward by `tail` and copies its result to
// each lane with the same key, up to the first that differs. The frame's
// lanes past the compaction's count all hold pair -1 and the pixel
// centres of one sentinel granule, so with a `tail` that is a multiple of
// the granule the first `tail` of them are computed and the rest copied.
// Live lanes read nothing more than a thread a lane would; a given SH is
// an input of its own, so its lanes are each computed. kPools as
// shade_kernel(ShadeArgs)'s.
template <bool kPools>
__global__ void __launch_bounds__(kThreads) shade_kernel(const ParticleShadeArgs a,
                                                         long long tail) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.lanes) return;
  const int pair = __ldg(a.pair + p * a.pair_s);
  const float x = __ldg(a.px + p * a.px_s), y = __ldg(a.py + p * a.py_s);
  const uint32_t bx = __float_as_uint(x), by = __float_as_uint(y);
  const bool chain = pair < 0 && a.sh == nullptr;
  if (chain && p >= tail) {
    const long long q = p - tail;
    if (__ldg(a.pair + q * a.pair_s) == pair && __float_as_uint(__ldg(a.px + q * a.px_s)) == bx &&
        __float_as_uint(__ldg(a.py + q * a.py_s)) == by)
      return;
  }
  float out[4];
  particle_lane<kPools>(a, p, pair, x, y, out);
  store_lane(a, p, out);
  if (!chain) return;
  for (long long q = p + tail; q < a.lanes; q += tail) {
    if (__ldg(a.pair + q * a.pair_s) != pair || __float_as_uint(__ldg(a.px + q * a.px_s)) != bx ||
        __float_as_uint(__ldg(a.py + q * a.py_s)) != by)
      break;
    store_lane(a, q, out);
  }
}

// threads of the particle shade the current device holds at once, the dead
// tail's stride (asked of the runtime once a device; -1 where it fails)
template <bool kPools>
long long particle_resident_threads() {
  static long long known[64] = {};
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (device < 64 && known[device] > 0) return known[device];
  void (*kernel)(const ParticleShadeArgs, long long) = shade_kernel<kPools>;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
          cudaSuccess) {
    return -1;
  }
  const long long threads = (long long)sms * per_sm * kThreads;
  if (device < 64) known[device] = threads;
  return threads;
}
}  // namespace

// The C entry point (ops/shade.py binds it with ctypes). Pointers are
// device pointers but `ambient`, the host's 12 floats, and `pools`, the
// host's ShPools (both read here, passed by value); strides are in
// elements; mat null: a row a lane; sh null: the SH from the pools where
// `pools` is not null and binds one, else the ambient coefficients. The
// result is the launch's cudaError_t.
extern "C" int sc_shade(int lanes, const uint8_t* valid, long long valid_s,
                        const uint8_t* front_facing, long long ff_s, const float* normal,
                        long long normal_s, const float* world_pos, long long wp_s,
                        const float* dpdx, long long dpdx_s, const float* dpdy,
                        long long dpdy_s, const float* duvdx, long long duvdx_s,
                        const float* duvdy, long long duvdy_s, const float* s16,
                        long long s16_s, int s16_vec, const float* rows, long long rows_s,
                        long long n_rows, const int* mat, long long mat_s, const float* sh,
                        long long sh_s, const void* pools, const float* lm_uv,
                        long long lm_uv_s, const uint8_t* lightmapped, long long lightmapped_s,
                        const float* ambient, const float* eye, long long eye_s, int aces,
                        int srgb, float* rgb, float* alpha, void* stream) {
  ShadeArgs a{lanes, valid, valid_s, front_facing, ff_s, normal, normal_s, world_pos, wp_s,
              dpdx, dpdx_s, dpdy, dpdy_s, duvdx, duvdx_s, duvdy, duvdy_s, s16, s16_s, s16_vec,
              rows, rows_s, n_rows, mat, mat_s, sh, sh_s, {}, lm_uv, lm_uv_s, lightmapped,
              lightmapped_s, {}, eye, eye_s, aces, srgb, rgb, alpha};
  if (pools != nullptr) a.pools = *static_cast<const ShPools*>(pools);
  for (int k = 0; k < 12; ++k) a.ambient[k] = ambient[k];
  const int blocks = (lanes + kThreads - 1) / kThreads;
  if (a.sh == nullptr && (a.pools.lv != nullptr || a.pools.lm != nullptr))
    shade_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  else
    shade_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ops/particles.py shade_particles' kernel: the address of its host
// ParticleShadeArgs, launched on `stream`; the result is the launch's
// cudaError_t.
extern "C" int sc_particle_shade(const void* args, void* stream) {
  const ParticleShadeArgs a = *static_cast<const ParticleShadeArgs*>(args);
  const bool pools = a.sh == nullptr && (a.pools.lv != nullptr || a.pools.lm != nullptr);
  const long long tail =
      pools ? particle_resident_threads<true>() : particle_resident_threads<false>();
  if (tail <= 0) {
    const int err = (int)cudaGetLastError();
    return err != 0 ? err : (int)cudaErrorInvalidConfiguration;
  }
  const long long blocks = (a.lanes + kThreads - 1) / kThreads;
  if (pools)
    shade_kernel<true><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a, tail);
  else
    shade_kernel<false><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a, tail);
  return (int)cudaGetLastError();
}

// sizeof(ParticleShadeArgs), for the binding's check of its mirror
extern "C" int sc_particle_shade_args_bytes() { return (int)sizeof(ParticleShadeArgs); }

// sizeof(ShPools), for the binding's check of its mirror
extern "C" int sc_sh_pools_bytes() { return (int)sizeof(ShPools); }
