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
// the lane's (4, 3) SH coefficients, or the 12 ambient ones by value; and
// the view's eye, read through a device pointer (a CUDA graph's input
// buffer that a new pose overwrites). It writes rgb (P, 3) and alpha (P,).
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
// stay in cache), its 48 B of SH on the lit scenes, and writes 16 B; an
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

#include <cuda_runtime.h>
#include <stdint.h>

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
  const float* sh;  // (P, 4, 3), the (4, 3) adjacent; null: ambient
  long long sh_s;
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
#pragma unroll
  for (int j = 0; j < 3; ++j) v[j] = sub(__ldg(a.eye + j * a.eye_s), v[j]);
  normalize(v);

  // sh[k][c]: L0, L1x, L1y, L1z by colour
  float sh[12];
  if (a.sh != nullptr) {
    load_vec<12>(a.sh, p, a.sh_s, sh);
  } else {
#pragma unroll
    for (int k = 0; k < 12; ++k) sh[k] = a.ambient[k];
  }

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

}  // namespace

// The C entry point (ops/shade.py binds it with ctypes). Pointers are
// device pointers but `ambient`, the host's 12 floats (read here, passed by
// value); strides are in elements; mat null: a row a lane; sh null: the
// ambient coefficients. The result is the launch's cudaError_t.
extern "C" int sc_shade(int lanes, const uint8_t* valid, long long valid_s,
                        const uint8_t* front_facing, long long ff_s, const float* normal,
                        long long normal_s, const float* world_pos, long long wp_s,
                        const float* dpdx, long long dpdx_s, const float* dpdy,
                        long long dpdy_s, const float* duvdx, long long duvdx_s,
                        const float* duvdy, long long duvdy_s, const float* s16,
                        long long s16_s, int s16_vec, const float* rows, long long rows_s,
                        long long n_rows, const int* mat, long long mat_s, const float* sh,
                        long long sh_s, const float* ambient, const float* eye,
                        long long eye_s, int aces, int srgb, float* rgb, float* alpha,
                        void* stream) {
  ShadeArgs a{lanes, valid, valid_s, front_facing, ff_s, normal, normal_s, world_pos, wp_s,
              dpdx, dpdx_s, dpdy, dpdy_s, duvdx, duvdx_s, duvdy, duvdy_s, s16, s16_s, s16_vec,
              rows, rows_s, n_rows, mat, mat_s, sh, sh_s, {}, eye, eye_s, aces, srgb, rgb,
              alpha};
  for (int k = 0; k < 12; ++k) a.ambient[k] = ambient[k];
  const int blocks = (lanes + kThreads - 1) / kThreads;
  shade_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
