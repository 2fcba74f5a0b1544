// The skybox on Hopper (sm_90a): one thread a pixel.
//
// Replaces no TPU kernel. The JAX package computes this in XLA:
// superconductor_tpu/ops/sky.py:56 shade_sky_rays, :76 sample_skybox and
// :94 sample_skybox_at (with ops/texture.py sample_cubemap and
// ops/tonemap.py). The port ran it as a chain of about 178 torch
// operations (ops/sky.py sample_skybox_plain and sample_skybox_at_plain,
// which stay as the plain versions), each writing its whole (pixels, 3) or
// (pixels,) result to device memory for the next to read back, and one
// gather of a 4-texel quad a pixel.
//
// sky_kernel: a pixel of the band [y_offset, y_offset + H) of a
// full_height-tall image, or at a flat band index idx[p] (div / mod by the
// width): its ray (NDC, the written-out rows of _rays_from_ndc, then
// math3d.quat_rotate), the cube face and its uv (ops/texture.py
// sample_cubemap), one bilinear tap (_bilinear_core) on the face's level-0
// placement from the quad-packed (N, 16) or the flat (N, 4) HDR pool (f16,
// f32 or u8 texels, the u8 ones times 1/255), then aces_filmic and
// linear_to_srgb_approx by the config's inline flags. The faces' (offset,
// w, h, wrap) come by value (the static placement,
// EnvBindings.ibl_cubemap_static: CLAMP) or as a (6, 4) i32 table on the
// device (the descriptor rows' level 0, which the wrapper gathers on the
// device). Without a cubemap the clear colour goes through the same
// display transform.
//
// What bounds it on this card: bytes. A pixel reads one quad (32 B of f16
// texels) from a cubemap that stays in L2, or its index, and writes 12 B;
// the arithmetic (about 60 FP32 operations and a powf a channel) is far
// below the card's rate.
//
// Design: registers only; the projection's inverse, the view quaternion
// and the face table are read by every thread from the same addresses
// (cached); nothing is written to device memory but the result.
//
// Bit for bit with the torch chain on the card (csrc/torch_exact.cuh):
// x / width and y / full_height are divisions by Python ints (a product
// with the reciprocal taken in double); the ray's rows are
// (x * m0 + y * m1) + (0 * m2 + 1 * m3); clamp_min(ma, 1e-20); _lerp4 is
// left to right; ** (1 / 2.2) is powf with the exponent rounded to f32;
// aces_filmic's Python-float constants are rounded once to f32.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "torch_exact.cuh"

namespace {

constexpr int kThreads = 256;

// pool texel types (ops/sky.py _TEXEL_TYPES)
enum Texel { kU8 = 0, kF16 = 1, kF32 = 2 };

struct Face {
  int off, w, h, wrap;
};
struct Faces {
  Face f[6];
};

struct SkyArgs {
  int lanes, width, y_offset, full_height;
  const void* idx;  // null: the band's pixels in order
  long long idx_s;
  int idx_64;
  const float* m;  // the projection's inverse (4, 4)
  long long m_s0, m_s1;
  const float* q;  // the view quaternion (4,)
  long long q_s;
  const void* pool;  // null: no cubemap, the clear colour
  long long n_pool;
  int quad;
  Faces faces;
  const int* face_table;  // (6, 4) on the device, or null: `faces`
  float clear[3];
  int aces, srgb;
  float* out;  // (P, 3)
};

template <int kType>
__device__ __forceinline__ float texel(const void* pool, long long i) {
  if (kType == kU8) return (float)__ldg(reinterpret_cast<const uint8_t*>(pool) + i);
  if (kType == kF16) return __half2float(__ldg(reinterpret_cast<const __half*>(pool) + i));
  return __ldg(reinterpret_cast<const float*>(pool) + i);
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long d = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --d;
  return d;
}

// ops/tonemap.py aces_filmic: clamp((x (a x + b)) / (x (c x + d) + e), 0, 1)
__device__ __forceinline__ float aces(float x) {
  const float a = (float)2.51, b = (float)0.03, c = (float)2.43, d = (float)0.59,
              e = (float)0.14;
  return clamp(quo(mul(x, add(mul(x, a), b)), add(mul(x, add(mul(x, c), d)), e)), 0.0f, 1.0f);
}

// ops/tonemap.py linear_to_srgb_approx: clamp(x, 0, 1) ** (1 / 2.2)
__device__ __forceinline__ float srgb(float x) {
  return powf(clamp(x, 0.0f, 1.0f), (float)(1.0 / 2.2));
}

template <int kType>
__global__ void __launch_bounds__(kThreads) sky_kernel(SkyArgs a) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.lanes) return;
  float rgb[3];
  if (a.pool == nullptr) {
    rgb[0] = a.clear[0];
    rgb[1] = a.clear[1];
    rgb[2] = a.clear[2];
  } else {
    // the pixel's column and row in the band
    long long col, row;
    if (a.idx == nullptr) {
      col = p % a.width;
      row = p / a.width;
    } else {
      const long long i =
          a.idx_64 ? __ldg(reinterpret_cast<const long long*>(a.idx) + p * a.idx_s)
                   : (long long)__ldg(reinterpret_cast<const int*>(a.idx) + p * a.idx_s);
      row = floor_div(i, a.width);
      col = i - row * a.width;  // torch.remainder: the floor modulo
    }
    // ndc: x / width * 2 - 1 and 1 - y / full_height * 2, at the centre
    const float x = add((float)col, 0.5f);
    const float y = add(add((float)row, 0.5f), (float)a.y_offset);
    const float nx = sub(mul(scalar_quo(x, a.width), 2.0f), 1.0f);
    const float ny = sub(1.0f, mul(scalar_quo(y, a.full_height), 2.0f));
    // _rays_from_ndc: (x m0 + y m1) + (0 m2 + 1 m3) for rows 0..2
    float v[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float* mj = a.m + j * a.m_s0;
      v[j] = add(add(mul(nx, __ldg(mj)), mul(ny, __ldg(mj + a.m_s1))),
                 add(mul(0.0f, __ldg(mj + 2 * a.m_s1)), mul(1.0f, __ldg(mj + 3 * a.m_s1))));
    }
    // math3d.quat_rotate: t = 2 cross(q.xyz, v); v + w t + cross(q.xyz, t)
    const float qx = __ldg(a.q), qy = __ldg(a.q + a.q_s), qz = __ldg(a.q + 2 * a.q_s),
                qw = __ldg(a.q + 3 * a.q_s);
    const float tx = mul(2.0f, sub(mul(qy, v[2]), mul(qz, v[1])));
    const float ty = mul(2.0f, sub(mul(qz, v[0]), mul(qx, v[2])));
    const float tz = mul(2.0f, sub(mul(qx, v[1]), mul(qy, v[0])));
    const float dx = add(add(v[0], mul(qw, tx)), sub(mul(qy, tz), mul(qz, ty)));
    const float dy = add(add(v[1], mul(qw, ty)), sub(mul(qz, tx), mul(qx, tz)));
    const float dz = add(add(v[2], mul(qw, tz)), sub(mul(qx, ty), mul(qy, tx)));
    // sample_cubemap: the face, ma, sc, tc and the face's uv
    const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
    const bool is_x = (ax >= ay) && (ax >= az);
    const bool is_y = (ay > ax) && (ay >= az) && !is_x;
    const int face = is_x ? (dx >= 0.0f ? 0 : 1)
                          : (is_y ? (dy >= 0.0f ? 2 : 3) : (dz >= 0.0f ? 4 : 5));
    const float ma = clamp_min(is_x ? ax : (is_y ? ay : az), (float)1e-20);
    const float sc = is_x ? (dx >= 0.0f ? -dz : dz) : (is_y ? dx : (dz >= 0.0f ? dx : -dx));
    const float tc = is_y ? (dy >= 0.0f ? dz : -dz) : -dy;
    const float u = mul(0.5f, add(quo(sc, ma), 1.0f));
    const float w = mul(0.5f, add(quo(tc, ma), 1.0f));
    // _bilinear_core at the face's placement
    Face f = a.faces.f[face];
    if (a.face_table != nullptr) {
      const int* t = a.face_table + 4 * face;
      f = {__ldg(t), __ldg(t + 1), __ldg(t + 2), __ldg(t + 3)};
    }
    TapPos tp = tap_pos(u, w, f.w, f.h);
    float t00[3], t10[3], t01[3], t11[3];
    if (a.quad) {
      const long long r = quad_row(tp, f.off, f.w, f.h, f.wrap, a.n_pool) * 16;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        t00[c] = texel<kType>(a.pool, r + c);
        t10[c] = texel<kType>(a.pool, r + 4 + c);
        t01[c] = texel<kType>(a.pool, r + 8 + c);
        t11[c] = texel<kType>(a.pool, r + 12 + c);
      }
    } else {
      const int x1 = iadd(tp.x0, 1), y1 = iadd(tp.y0, 1);
      const int xa = wrap_coord(tp.x0, f.w, f.wrap), xb = wrap_coord(x1, f.w, f.wrap);
      const int ya = wrap_coord(tp.y0, f.h, f.wrap), yb = wrap_coord(y1, f.h, f.wrap);
      const long long r00 = row_of(iadd(iadd(f.off, imul(ya, f.w)), xa), a.n_pool) * 4;
      const long long r10 = row_of(iadd(iadd(f.off, imul(ya, f.w)), xb), a.n_pool) * 4;
      const long long r01 = row_of(iadd(iadd(f.off, imul(yb, f.w)), xa), a.n_pool) * 4;
      const long long r11 = row_of(iadd(iadd(f.off, imul(yb, f.w)), xb), a.n_pool) * 4;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        t00[c] = texel<kType>(a.pool, r00 + c);
        t10[c] = texel<kType>(a.pool, r10 + c);
        t01[c] = texel<kType>(a.pool, r01 + c);
        t11[c] = texel<kType>(a.pool, r11 + c);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      rgb[c] = lerp4(t00[c], t10[c], t01[c], t11[c], tp.fx, tp.fy);
      if (kType == kU8) rgb[c] = mul(rgb[c], (float)(1.0 / 255.0));
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float x = rgb[c];
    if (a.aces) x = aces(x);
    if (a.srgb) x = srgb(x);
    a.out[p * 3 + c] = x;
  }
}

}  // namespace

// The C entry point (ops/sky.py binds it with ctypes). Pointers are device
// pointers, except `faces`: the host's 6 x (offset, w, h, wrap), read here
// and passed by value (used when face_table is null); strides are in
// elements; idx null: the band's pixels in order; pool null: no cubemap,
// the clear colour. The result is the launch's cudaError_t.
extern "C" int sc_sky(int lanes, int width, int y_offset, int full_height, const void* idx,
                      long long idx_s, int idx_64, const float* m, long long m_s0,
                      long long m_s1, const float* q, long long q_s, const void* pool,
                      long long n_pool, int texel_type, int quad, const int* faces,
                      const int* face_table, float clear_r, float clear_g, float clear_b,
                      int aces, int srgb, float* out, void* stream) {
  SkyArgs a{lanes, width, y_offset, full_height, idx, idx_s, idx_64, m, m_s0, m_s1, q, q_s,
            pool, n_pool, quad, {}, face_table, {clear_r, clear_g, clear_b}, aces, srgb, out};
  for (int f = 0; f < 6; ++f)
    a.faces.f[f] = {faces[4 * f], faces[4 * f + 1], faces[4 * f + 2], faces[4 * f + 3]};
  const int blocks = (lanes + kThreads - 1) / kThreads;
  if (texel_type == kU8)
    sky_kernel<kU8><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  else if (texel_type == kF16)
    sky_kernel<kF16><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  else
    sky_kernel<kF32><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
