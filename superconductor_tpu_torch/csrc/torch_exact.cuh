// Round-exact helpers: torch's elementwise operations on the card, one at a
// time, for the hand kernels that compute what a chain of torch operations
// computes, bit for bit (csrc/sample.cu, csrc/gbuffer.cu, csrc/sky.cu,
// csrc/shade.cu, csrc/geometry.cu).
//
// Torch runs one kernel an operation, each result rounded to f32, so every
// product, sum and quotient is written with __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn in the chain's order (none can be contracted into
// an FMA; the library is also built with -fmad=false). The traps found so
// far:
// * A Python float operand is rounded once to f32. A division by a Python
//   scalar is a product with its reciprocal, taken in double and rounded
//   once to f32 (torch's CUDA true division by a CPU scalar: c / 1.055 is
//   c * (float)(1 / 1.055), which differs from c * (1.0f / 1.055f) in most
//   lanes): scalar_quo.
// * 1.0 / t (Tensor.__rtruediv__) is t.reciprocal() * 1.0: recip_times_one.
// * x ** 2 is x * x; log2f and powf are the CUDA math library's, as
//   torch.log2 and pow with a scalar exponent call them.
// * torch.maximum, torch.minimum and clamp keep a NaN; fmaxf / fminf do not.
// * int32 arithmetic wraps; torch.remainder is the floor modulo; the f32 ->
//   int32 conversion truncates (NaN 0); a negative row index counts from the
//   end, as torch's advanced indexing does.
// Every lane is computed as the chain computes it, dead lanes included.
//
// Also the pieces of ops/texture.py's one-tap bilinear core (_bilinear_core,
// _lerp4) and the sRGB decode that csrc/sample.cu, csrc/sky.cu and
// csrc/shade.cu share.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWrapRepeat = 0;  // ops/texture.py WRAP_REPEAT
constexpr int kWrapClamp = 1;   // WRAP_CLAMP

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
// a / s for a Python scalar s: a * (float)(1 / s), the reciprocal in double
__device__ __forceinline__ float scalar_quo(float a, double s) { return mul(a, (float)(1.0 / s)); }
// 1.0 / t: torch.reciprocal (1 / t, rounded) times 1.0
__device__ __forceinline__ float recip_times_one(float t) { return mul(quo(1.0f, t), 1.0f); }

// torch.maximum / torch.minimum: a NaN operand is the result
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp_min / torch.clamp with scalar bounds: a NaN stays
__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// int32 arithmetic wraps, as torch's does
__device__ __forceinline__ int iadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int imul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }
// torch.remainder on int32: the floor modulo
__device__ __forceinline__ int remainder(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}
// _clamp_to with a per-lane size: minimum(clamp_min(c, 0), size - 1)
__device__ __forceinline__ int clamp_to(int c, int size) { return min(max(c, 0), iadd(size, -1)); }
// _wrap with a per-lane mode: REPEAT the floor modulo, anything else the clamp
__device__ __forceinline__ int wrap_coord(int c, int size, int wrap) {
  return wrap == kWrapRepeat ? remainder(c, size) : clamp_to(c, size);
}
// torch's f32 -> int32 conversion (toward zero; NaN 0)
__device__ __forceinline__ int to_i32(float x) { return __float2int_rz(x); }
// torch's advanced indexing: a negative index counts from the end; one
// out of range (where torch raises) is held inside the table
__device__ __forceinline__ long long row_of(long long i, long long n) {
  const long long r = i < 0 ? i + n : i;
  return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

// ops/texture.py _lerp4, left to right
__device__ __forceinline__ float lerp4(float t00, float t10, float t01, float t11, float fx,
                                       float fy) {
  const float gx = sub(1.0f, fx), gy = sub(1.0f, fy);
  return add(add(add(mul(mul(t00, gx), gy), mul(mul(t10, fx), gy)), mul(mul(t01, gx), fy)),
             mul(mul(t11, fx), fy));
}

// byte k of a little-endian word of u8 texels, as f32 (the u8 -> f32 cast)
__device__ __forceinline__ float byte_of(uint32_t word, int k) {
  return (float)((word >> (8 * k)) & 0xffu);
}

// ops/tonemap.py srgb_to_linear_exact: where(c <= 0.04045, c / 12.92,
// ((c + 0.055) / 1.055) ** 2.4)
__device__ __forceinline__ float srgb_to_linear(float c) {
  const float lin = scalar_quo(c, 12.92);
  const float p = powf(scalar_quo(add(c, (float)0.055), 1.055), (float)2.4);
  return c <= (float)0.04045 ? lin : p;
}

// A bilinear tap's position at a level of w x h texels: the floor texel
// (x0, y0) and the fractions (uv * size - 0.5)
struct TapPos {
  int x0, y0;
  float fx, fy;
};

__device__ __forceinline__ TapPos tap_pos(float u, float v, int w, int h) {
  const float x = sub(mul(u, (float)w), 0.5f);
  const float y = sub(mul(v, (float)h), 0.5f);
  const float xf = floorf(x), yf = floorf(y);
  return {to_i32(xf), to_i32(yf), sub(x, xf), sub(y, yf)};
}

// The quad row of a tap on a pool with baked neighbours (the quad and
// material rows): wrapped floor texel, fractions zeroed at CLAMP's negative
// edge (ops/texture.py _bilinear_core's quad branch, _matq_bilinear)
__device__ __forceinline__ long long quad_row(TapPos& t, int off, int w, int h, int wrap,
                                              long long n) {
  const int xi = wrap_coord(t.x0, w, wrap), yi = wrap_coord(t.y0, h, wrap);
  const bool clamped = wrap == kWrapClamp;
  if (clamped && t.x0 < 0) t.fx = 0.0f;
  if (clamped && t.y0 < 0) t.fy = 0.0f;
  return row_of(iadd(iadd(off, imul(yi, w)), xi), n);
}

}  // namespace
