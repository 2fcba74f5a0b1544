// The skybox on Hopper (sm_90a): a thread two consecutive pixels of a row.
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
// sky_kernel: the pixels of the band [y_offset, y_offset + H) of a
// full_height-tall image (kBand), or those at flat band indices idx[p]
// (floor div / mod by the width): each pixel's ray (NDC, the written-out
// rows of _rays_from_ndc, then math3d.quat_rotate), the cube face and its
// uv (ops/texture.py sample_cubemap), one bilinear tap (_bilinear_core) on
// the face's level-0 placement from the quad-packed (N, 16) or the flat
// (N, 4) HDR pool (f16, f32 or u8 texels, the u8 ones times 1/255), then
// aces_filmic and linear_to_srgb_approx by the config's inline flags. The
// faces' (offset, w, h, wrap) come by value (the static placement,
// EnvBindings.ibl_cubemap_static: CLAMP) or as a (6, 4) i32 table on the
// device (the descriptor rows' level 0, which the wrapper gathers on the
// device). Without a cubemap the clear colour goes through the same
// display transform.
//
// What holds it back on this card is not bytes. A pixel reads one quad
// (32 B of f16 texels) from a cubemap that stays in L2, or its index, and
// writes 12 B (0.0075 ms of bytes for a 1080p band), where the kernel
// takes about five times that. What does is not measured; read from the
// code, the likeliest is the instructions it runs: the arithmetic the bits
// need (140 operations, three powf and five IEEE divisions a pixel,
// chip_smoke.py deferred_bound) with the library's powf and the divisions'
// refinements. Their static count (chip_smoke.py [sky]: the headline's
// template holds about 1,300 SASS instructions for its two pixels) is an
// estimate only: it also holds the paths a pixel does not run (scalar
// loads, the 64-bit division, the slow paths of powf and the divisions),
// and no dynamic count was taken. The
// first design (a thread a pixel over a 1D grid) also spent two 64-bit
// divisions a pixel on its column and row, two double-precision
// reciprocals on values that are the same for every pixel, 16 loads of
// uniform values and 12 two-byte texel loads.
//
// Design:
// * The band runs as a 2D grid of 16 x 8 threads, each thread kPx
//   consecutive pixels of one row: a block a tile of 32 x 8 pixels, a warp
//   a patch of 32 x 2, so that neighbouring rays share a face and quad
//   rows. Column and row come from the block and thread indices, in 32
//   bits (the wrapper refuses 2^31 pixels); a thread's pixels share the
//   row's ny and its three products, and its columns' products are the
//   same at every row it visits (each the same rounded f32). kPx = 2: the
//   launch shapes tried beside it are in PERF.md §6.
// * The worklist runs kPx consecutive lanes a thread, its indices read in
//   one load where they lie contiguous and aligned, and divided by the
//   width with a multiplier and shift prepared on the host (a
//   multiply-high, as CUTLASS's FastDivmod does; the floor for negative
//   indices). An int64 index outside int32 takes the 64-bit division.
// * 1 / width and 1 / full_height come by value, taken in double and
//   rounded once to f32 on the host, as torch does; the inverse
//   projection's 12 entries used, the quaternion and the face rows are read
//   once a block into shared memory, with each ray row's constant term
//   (0 * m2 + 1 * m3). They are the CUDA graph's input buffers, so the host
//   never reads them.
// * A quad row is read with 16-B loads (two for f16, four for f32, one for
//   u8), a flat pool's tap as one load; a thread's 24 B of result go out as
//   three 8-B stores where its row start is 8-B aligned (scalar stores
//   otherwise, and for the ragged end).
// * Templates on what a launch fixes: band or worklist, the texel type (or
//   the clear colour), quad or flat pool, static placement or face table,
//   and the two inline flags.
//
// Bit for bit with the torch chain on the card (csrc/torch_exact.cuh):
// x / width and y / full_height are divisions by Python ints (a product
// with the reciprocal taken in double); the ray's rows are
// (x * m0 + y * m1) + (0 * m2 + 1 * m3); clamp_min(ma, 1e-20); _lerp4 is
// left to right; ** (1 / 2.2) is powf with the exponent rounded to f32;
// aces_filmic's Python-float constants are rounded once to f32. Traps met
// in the redesign: a dead column of the band's last thread is computed
// (never stored), so its rays may be anything and its reads stay clamped
// inside the pool; an int32 floor division of INT_MIN works on ~i, never
// on -i.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <array>
#include <utility>

#include "torch_exact.cuh"

namespace {

constexpr int kPx = 2;            // consecutive pixels (or worklist lanes) a thread
constexpr int kBandX = 16;        // band blocks: kBandX x kBandY threads,
constexpr int kBandY = 8;         // a tile of (kBandX * kPx) x kBandY pixels
constexpr int kThreads = kBandX * kBandY;  // a block, band or worklist
constexpr int kMaxGridY = 65535;
static_assert(kPx % 2 == 0, "store_px and lane_indices move the pixels in pairs");

// pool texel types (ops/sky.py _TEXEL_TYPES); kNone: no cubemap, the clear colour
enum Texel { kU8 = 0, kF16 = 1, kF32 = 2, kNone = 3 };

struct SkyArgs {
  int lanes, width, height, y_offset;
  float inv_w, inv_h;  // (float)(1.0 / width), (float)(1.0 / full_height)
  unsigned div_mul;    // the width's divisor: floor(n / width) of 0 <= n < 2^31 is
  int div_shift;       // umulhi(n, div_mul) >> div_shift (div_mul 0: width 1)
  const void* idx;     // the worklist's (lanes,) indices
  long long idx_s;
  int idx_64;
  const float* m;  // the projection's inverse (4, 4)
  long long m_s0, m_s1;
  const float* q;  // the view quaternion (4,)
  long long q_s;
  const void* pool;
  long long n_pool;
  int pool_vec;  // the pool's base is 16-B aligned: vector texel loads
  int face_w, face_h, face_off[6];  // the static placement
  const int* face_table;            // (6, 4) on the device: the descriptor placement
  float clear[3];
  float* out;  // (lanes, 3)
};

// The values a thread keeps in registers: the rows 0..2 of the inverse
// projection's columns 0 and 1, each row's constant term, the quaternion
struct Rays {
  float m0[3], m1[3], c[3], q[4];
};

// What a block reads once: the rays' values and the faces' (offset, w, h,
// wrap)
struct Uniforms {
  Rays r;
  int4 face[6];
};

__device__ __forceinline__ long long floor_div64(long long a, long long b) {
  long long d = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --d;
  return d;
}

// torch.div(i, width, rounding_mode="floor") of an int32 i: a negative i
// as -1 - floor(~i / width), ~i = -i - 1 in [0, 2^31)
__device__ __forceinline__ int floor_div32(int i, unsigned mul, int shift) {
  const int s = i >> 31;
  const unsigned n = (unsigned)(i ^ s);
  const unsigned q = mul != 0u ? __umulhi(n, mul) >> shift : n;
  return (int)q ^ s;
}

// (float) column and row of band index i: torch.remainder and torch.div
// (floor) by the width
__device__ __forceinline__ void index_coords32(int i, const SkyArgs& a, float& xf, float& yf) {
  const int row = floor_div32(i, a.div_mul, a.div_shift);
  const int col = (int)((unsigned)i - (unsigned)row * (unsigned)a.width);
  xf = (float)col;
  yf = (float)row;
}

__device__ __forceinline__ void index_coords64(long long i, const SkyArgs& a, float& xf,
                                               float& yf) {
  if (i == (long long)(int)i) {
    index_coords32((int)i, a, xf, yf);
  } else {
    const long long row = floor_div64(i, a.width);
    xf = (float)(i - row * a.width);
    yf = (float)row;
  }
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

template <int kAces, int kSrgb>
__device__ __forceinline__ float display(float x) {
  if (kAces) x = aces(x);
  if (kSrgb) x = srgb(x);
  return x;
}

__device__ __forceinline__ void half_rgb(unsigned lo, unsigned hi, float* t) {
  t[0] = __half2float(__ushort_as_half((unsigned short)(lo & 0xffffu)));
  t[1] = __half2float(__ushort_as_half((unsigned short)(lo >> 16)));
  t[2] = __half2float(__ushort_as_half((unsigned short)(hi & 0xffffu)));
}

__device__ __forceinline__ void byte_rgb(unsigned w, float* t) {
  t[0] = (float)(w & 0xffu);
  t[1] = (float)((w >> 8) & 0xffu);
  t[2] = (float)((w >> 16) & 0xffu);
}

template <int kType>
__device__ __forceinline__ float texel(const void* pool, long long i) {
  if (kType == kU8) return (float)__ldg(reinterpret_cast<const uint8_t*>(pool) + i);
  if (kType == kF16) return __half2float(__ldg(reinterpret_cast<const __half*>(pool) + i));
  return __ldg(reinterpret_cast<const float*>(pool) + i);
}

// The rgb of the four texels t00, t10, t01, t11 of quad row r
template <int kType>
__device__ __forceinline__ void quad_texels(const void* pool, long long r, int vec,
                                            float (&t)[4][3]) {
  if (vec) {
    if (kType == kF16) {
      const uint4* p =
          reinterpret_cast<const uint4*>(reinterpret_cast<const __half*>(pool) + r * 16);
      const uint4 a = __ldg(p), b = __ldg(p + 1);
      half_rgb(a.x, a.y, t[0]);
      half_rgb(a.z, a.w, t[1]);
      half_rgb(b.x, b.y, t[2]);
      half_rgb(b.z, b.w, t[3]);
    } else if (kType == kF32) {
      const float4* p =
          reinterpret_cast<const float4*>(reinterpret_cast<const float*>(pool) + r * 16);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 v = __ldg(p + k);
        t[k][0] = v.x;
        t[k][1] = v.y;
        t[k][2] = v.z;
      }
    } else {
      const uint4 w =
          __ldg(reinterpret_cast<const uint4*>(reinterpret_cast<const uint8_t*>(pool) + r * 16));
      byte_rgb(w.x, t[0]);
      byte_rgb(w.y, t[1]);
      byte_rgb(w.z, t[2]);
      byte_rgb(w.w, t[3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < 3; ++c) t[k][c] = texel<kType>(pool, r * 16 + 4 * k + c);
  }
}

// The rgb of flat pool row r
template <int kType>
__device__ __forceinline__ void flat_texel(const void* pool, long long r, int vec, float* t) {
  if (vec) {
    if (kType == kF16) {
      const uint2 w =
          __ldg(reinterpret_cast<const uint2*>(reinterpret_cast<const __half*>(pool) + r * 4));
      half_rgb(w.x, w.y, t);
    } else if (kType == kF32) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(reinterpret_cast<const float*>(pool) + r * 4));
      t[0] = v.x;
      t[1] = v.y;
      t[2] = v.z;
    } else {
      const uint8_t* b = reinterpret_cast<const uint8_t*>(pool) + r * 4;
      byte_rgb(__ldg(reinterpret_cast<const unsigned*>(b)), t);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) t[c] = texel<kType>(pool, r * 4 + c);
  }
}

// The cubemap's colour along the (unrotated) ray v
template <int kType, int kQuad, int kStatic>
__device__ __forceinline__ void cube_rgb(const SkyArgs& a, const Uniforms& s, const Rays& u,
                                         const float (&v)[3], float* rgb) {
  // math3d.quat_rotate: t = 2 cross(q.xyz, v); v + w t + cross(q.xyz, t)
  const float qx = u.q[0], qy = u.q[1], qz = u.q[2], qw = u.q[3];
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
  const float fu = mul(0.5f, add(quo(sc, ma), 1.0f));
  const float fv = mul(0.5f, add(quo(tc, ma), 1.0f));
  // _bilinear_core at the face's placement
  // (the static placement's constant size and CLAMP fold into the helpers)
  const int4 f = s.face[face];
  const int w = kStatic ? a.face_w : f.y, h = kStatic ? a.face_h : f.z;
  const int wrap = kStatic ? kWrapClamp : f.w;
  TapPos tp = tap_pos(fu, fv, w, h);
  float t[4][3];
  if (kQuad) {
    quad_texels<kType>(a.pool, quad_row(tp, f.x, w, h, wrap, a.n_pool), a.pool_vec, t);
  } else {
    const int x1 = iadd(tp.x0, 1), y1 = iadd(tp.y0, 1);
    const int xa = wrap_coord(tp.x0, w, wrap), xb = wrap_coord(x1, w, wrap);
    const int ya = wrap_coord(tp.y0, h, wrap), yb = wrap_coord(y1, h, wrap);
    const int ra = iadd(f.x, imul(ya, w)), rb = iadd(f.x, imul(yb, w));
    flat_texel<kType>(a.pool, row_of(iadd(ra, xa), a.n_pool), a.pool_vec, t[0]);
    flat_texel<kType>(a.pool, row_of(iadd(ra, xb), a.n_pool), a.pool_vec, t[1]);
    flat_texel<kType>(a.pool, row_of(iadd(rb, xa), a.n_pool), a.pool_vec, t[2]);
    flat_texel<kType>(a.pool, row_of(iadd(rb, xb), a.n_pool), a.pool_vec, t[3]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rgb[c] = lerp4(t[0][c], t[1][c], t[2][c], t[3][c], tp.fx, tp.fy);
    if (kType == kU8) rgb[c] = mul(rgb[c], (float)(1.0 / 255.0));
  }
}

// n (1..kPx) pixels' rgb at out: 8-B stores where out is 8-B aligned and
// all kPx are there, else one float at a time
__device__ __forceinline__ void store_px(float* out, const float (&rgb)[kPx][3], int n) {
  if (n == kPx && (reinterpret_cast<uintptr_t>(out) & 7u) == 0) {
#pragma unroll
    for (int v = 0; v < 3 * kPx / 2; ++v)
      reinterpret_cast<float2*>(out)[v] =
          make_float2(rgb[2 * v / 3][2 * v % 3], rgb[(2 * v + 1) / 3][(2 * v + 1) % 3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPx; ++k)
      if (k < n) {
        out[3 * k] = rgb[k][0];
        out[3 * k + 1] = rgb[k][1];
        out[3 * k + 2] = rgb[k][2];
      }
  }
}

// An aligned load of kBytes
template <int kBytes>
struct Words;
template <>
struct Words<16> {
  using T = int4;
};
template <>
struct Words<8> {
  using T = int2;
};

// The kPx worklist indices from p (stride s; n of them there, a ragged
// end repeats the first): 16-B (or, for two int32, 8-B) loads where they
// lie contiguous and aligned
template <class T>
__device__ __forceinline__ void lane_indices(const T* p, long long s, int n, T (&i)[kPx]) {
  constexpr int kVec = 16 / (int)sizeof(T) < kPx ? 16 / (int)sizeof(T) : kPx;
  constexpr int kBytes = kVec * (int)sizeof(T);
  using V = typename Words<kBytes>::T;
  if (n == kPx && s == 1 && (reinterpret_cast<uintptr_t>(p) & (kBytes - 1)) == 0) {
#pragma unroll
    for (int v = 0; v < kPx / kVec; ++v) {
      const V w = __ldg(reinterpret_cast<const V*>(p) + v);
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int k = 0; k < kVec; ++k) i[kVec * v + k] = e[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPx; ++k) i[k] = __ldg(p + (k < n ? k : 0) * s);
  }
}

// ndc: x / width * 2 - 1 and 1 - y / full_height * 2, at the centre
__device__ __forceinline__ float ndc_x(float col, const SkyArgs& a) {
  return sub(mul(mul(add(col, 0.5f), a.inv_w), 2.0f), 1.0f);
}
__device__ __forceinline__ float ndc_y(float row, const SkyArgs& a) {
  return sub(1.0f, mul(mul(add(add(row, 0.5f), (float)a.y_offset), a.inv_h), 2.0f));
}

template <int kBand, int kType, int kQuad, int kStatic, int kAces, int kSrgb>
__global__ void __launch_bounds__(kThreads) sky_kernel(const SkyArgs a) {
  __shared__ Uniforms s;
  Rays u;
  if constexpr (kType != kNone) {
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    if (tid < 3) {  // _rays_from_ndc's row tid: m0, m1 and 0 * m2 + 1 * m3
      const float* mj = a.m + tid * a.m_s0;
      s.r.m0[tid] = __ldg(mj);
      s.r.m1[tid] = __ldg(mj + a.m_s1);
      s.r.c[tid] = add(mul(0.0f, __ldg(mj + 2 * a.m_s1)), mul(1.0f, __ldg(mj + 3 * a.m_s1)));
    } else if (tid < 7) {
      s.r.q[tid - 3] = __ldg(a.q + (tid - 3) * a.q_s);
    } else if (tid < 13) {
      const int f = tid - 7;
      if (kStatic) {
        int off = a.face_off[0];
#pragma unroll
        for (int k = 1; k < 6; ++k)
          if (f == k) off = a.face_off[k];
        s.face[f] = make_int4(off, a.face_w, a.face_h, kWrapClamp);
      } else {
        const int* t = a.face_table + 4 * f;
        s.face[f] = make_int4(__ldg(t), __ldg(t + 1), __ldg(t + 2), __ldg(t + 3));
      }
    }
    __syncthreads();
    u = s.r;
  }
  float rgb[kPx][3];
  if constexpr (kType == kNone) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = display<kAces, kSrgb>(a.clear[c]);
#pragma unroll
      for (int k = 0; k < kPx; ++k) rgb[k][c] = x;
    }
  }
  if constexpr (kBand) {
    const unsigned c0 = (blockIdx.x * kBandX + threadIdx.x) * kPx;  // may pass 2^31 - 1
    if (c0 >= (unsigned)a.width) return;
    const int col0 = (int)c0, n = min(kPx, a.width - col0);
    // x * m0 of the thread's columns, the same at every row (the ragged
    // end's dead columns computed, never stored)
    float xm[kPx][3];
    if constexpr (kType != kNone) {
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        const float nx = ndc_x((float)(col0 + k), a);
#pragma unroll
        for (int j = 0; j < 3; ++j) xm[k][j] = mul(nx, u.m0[j]);
      }
    }
    const int n_by = (a.height - 1) / kBandY + 1;
    for (int by = blockIdx.y; by < n_by; by += gridDim.y) {
      const int row = by * kBandY + threadIdx.y;
      if (row >= a.height) break;
      if constexpr (kType != kNone) {
        const float ny = ndc_y((float)row, a);
        float ym[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) ym[j] = mul(ny, u.m1[j]);
#pragma unroll
        for (int k = 0; k < kPx; ++k) {
          float v[3];
#pragma unroll
          for (int j = 0; j < 3; ++j) v[j] = add(add(xm[k][j], ym[j]), u.c[j]);
          cube_rgb<kType, kQuad, kStatic>(a, s, u, v, rgb[k]);
#pragma unroll
          for (int c = 0; c < 3; ++c) rgb[k][c] = display<kAces, kSrgb>(rgb[k][c]);
        }
      }
      store_px(a.out + 3LL * (row * a.width + col0), rgb, n);
    }
  } else {
    const unsigned u0 = (blockIdx.x * kThreads + threadIdx.x) * kPx;  // may pass 2^31 - 1
    if (u0 >= (unsigned)a.lanes) return;
    const int l0 = (int)u0, n = min(kPx, a.lanes - l0);
    if constexpr (kType != kNone) {
      // the lanes' columns and rows (a ragged end repeats lane l0)
      float xs[kPx], ys[kPx];
      if (a.idx_64) {
        long long i[kPx];
        lane_indices(reinterpret_cast<const long long*>(a.idx) + l0 * a.idx_s, a.idx_s, n, i);
#pragma unroll
        for (int k = 0; k < kPx; ++k) index_coords64(i[k], a, xs[k], ys[k]);
      } else {
        int i[kPx];
        lane_indices(reinterpret_cast<const int*>(a.idx) + l0 * a.idx_s, a.idx_s, n, i);
#pragma unroll
        for (int k = 0; k < kPx; ++k) index_coords32(i[k], a, xs[k], ys[k]);
      }
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        const float nx = ndc_x(xs[k], a), ny = ndc_y(ys[k], a);
        float v[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) v[j] = add(add(mul(nx, u.m0[j]), mul(ny, u.m1[j])), u.c[j]);
        cube_rgb<kType, kQuad, kStatic>(a, s, u, v, rgb[k]);
#pragma unroll
        for (int c = 0; c < 3; ++c) rgb[k][c] = display<kAces, kSrgb>(rgb[k][c]);
      }
    }
    store_px(a.out + 3LL * l0, rgb, n);
  }
}

using Launcher = void (*)(const SkyArgs&, cudaStream_t);

// Variant code C: band << 6 | texel << 4 | quad << 3 | static << 2 | aces << 1 | srgb
// (ops/sky.py kernel_variant); without a cubemap, quad and static are 0
template <int C>
void launch(const SkyArgs& a, cudaStream_t stream) {
  constexpr int kBand = (C >> 6) & 1, kType = (C >> 4) & 3;
  constexpr int kQuad = kType == kNone ? 0 : (C >> 3) & 1;
  constexpr int kStatic = kType == kNone ? 0 : (C >> 2) & 1;
  constexpr int kAces = (C >> 1) & 1, kSrgb = C & 1;
  auto kernel = sky_kernel<kBand, kType, kQuad, kStatic, kAces, kSrgb>;
  if constexpr (kBand) {
    const dim3 grid((a.width - 1) / (kBandX * kPx) + 1,
                    std::min((a.height - 1) / kBandY + 1, kMaxGridY));
    kernel<<<grid, dim3(kBandX, kBandY), 0, stream>>>(a);
  } else {
    kernel<<<(a.lanes - 1) / (kThreads * kPx) + 1, kThreads, 0, stream>>>(a);
  }
}

template <size_t... C>
constexpr std::array<Launcher, sizeof...(C)> launchers(std::index_sequence<C...>) {
  return {{&launch<(int)C>...}};
}

const std::array<Launcher, 128> kLaunchers = launchers(std::make_index_sequence<128>());

}  // namespace

// The C entry point (ops/sky.py binds it with ctypes). Pointers are device
// pointers, except `faces`: the host's 6 x (offset, w, h, wrap) of the
// static placement, read here and passed by value; strides are in
// elements; lanes > 0 (band: height x width). variant: the launch's
// template (launch's code C above). The result is the launch's
// cudaError_t.
// kPx: the pixels (lanes) a thread of sky_kernel computes
extern "C" int sc_sky_pixels_a_thread() { return kPx; }

extern "C" int sc_sky(int lanes, int width, int height, int y_offset, float inv_w, float inv_h,
                      unsigned div_mul, int div_shift, const void* idx, long long idx_s,
                      int idx_64, const float* m, long long m_s0, long long m_s1,
                      const float* q, long long q_s, const void* pool, long long n_pool,
                      int pool_vec, const int* faces, const int* face_table, float clear_r,
                      float clear_g, float clear_b, int variant, float* out, void* stream) {
  if (variant < 0 || variant >= (int)kLaunchers.size()) return (int)cudaErrorInvalidValue;
  SkyArgs a{lanes, width, height, y_offset, inv_w, inv_h, div_mul, div_shift, idx, idx_s, idx_64,
            m, m_s0, m_s1, q, q_s, pool, n_pool, pool_vec, faces[1], faces[2], {}, face_table,
            {clear_r, clear_g, clear_b}, out};
  for (int f = 0; f < 6; ++f) a.face_off[f] = faces[4 * f];
  kLaunchers[variant](a, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
