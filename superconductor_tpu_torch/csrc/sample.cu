// Material samplers on Hopper (sm_90a): the classic per-slot sampler and
// the interleaved material sampler, one thread a lane.
//
// Replaces no TPU kernel. The JAX package computes both in XLA:
// superconductor_tpu/ops/texture.py:556 sample_material_interleaved and
// :629 sample_anisotropic, whose material rows come from
// superconductor_tpu/ops/shade.py:363 _material_rows. The port ran them as
// chains of torch operations (ops/texture.py sample_material_interleaved,
// ops/sample.py classic_sample), which stay as the plain versions: each
// operation wrote its whole (lanes, 4) or (lanes,) result to device memory
// and the next read it back, and the classic chain first gathered a whole
// material row of 44 + 12 L floats a lane.
//
// * classic_sample_kernel: ops/sample.py classic_sample for a tuple of
//   slots on the material table the port's upload always publishes,
//   mat_row (M, 44 + 12 L) f32 with the in-register mip tables
//   (scene/upload.py material_tables): sample_anisotropic's LOD and taps,
//   then sample_trilinear's in-register branch, from the flat (N, 4) or the
//   quad-packed (N, 16) u8 pool.
// * material_sample_kernel: ops/texture.py sample_material_interleaved
//   with the row unpack of ops/sample.py _unpack_mq_row, on every pool
//   scene/upload.py matq_tables publishes: (N, 64) u8 rows, with or
//   without the tail pool of the second level, and the wide (N, 208) mq3
//   rows. The material row is either the lane's material's row of
//   mat_row_mq (M, 24 + 4 L) or a row per lane (the g-buffer's mat_tail, a
//   strided view of the shade row).
// The tables' columns (the meta at 20, the mip tables at 44 and 24) are
// ops/sample.py's META, MAT_ROW_HEAD and MQ_ROW_HEAD.
//
// What bounds them on this card: bytes. A lane reads its uv and
// derivatives (24 B) and its material id (4 B), a few ints of its
// material's row (a table of a few rows that stays in L1 / L2), one 16-B
// quad (or 64-B / 208-B material row) per bilinear tap, and writes 16 B a
// slot; the arithmetic (a few hundred FP32 operations a lane, two powf a
// channel in sRGB) is far below the card's rate.
//
// Design: everything between the inputs and the output stays in
// registers; the material row is read in place (the slot's 6-int meta and
// its mip table, not the row), so nothing is written to device memory but
// the result. A lane's texel rows are 16-B loads (__ldg). No shared memory,
// no staging: cp.async / TMA of the texel rows is later work.
//
// Bit for bit with the torch chain on the card: every operation is
// written with csrc/torch_exact.cuh's round-exact helpers, in the chain's
// order; log2f and powf are the CUDA math library's, as torch.log2 and
// ** 2.4 call them. Every lane is computed as the chain computes it, dead
// lanes included.

#include <cuda_runtime.h>
#include <stdint.h>

#include "torch_exact.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTexflagSrgb = 1;

// _select_level: row lvl of an L-row table by a select ladder
__device__ __forceinline__ int select_level(int lvl, int L) {
  return lvl >= 1 ? min(lvl, L - 1) : 0;
}

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

// u8 -> [0, 1] (_decode_u8), then the sRGB decode of the colour channels
__device__ __forceinline__ void decode(float* r, bool srgb) {
  const float s = (float)(1.0 / 255.0);
  for (int c = 0; c < 4; ++c) r[c] = mul(r[c], s);
  if (srgb)
    for (int c = 0; c < 3; ++c) r[c] = srgb_to_linear(r[c]);
}

// a * (1 - f) + b * f on C channels
template <int C>
__device__ __forceinline__ void level_blend(const float* a, const float* b, float f, float* out) {
  const float g = sub(1.0f, f);
  for (int c = 0; c < C; ++c) out[c] = add(mul(a[c], g), mul(b[c], f));
}

// The trilinear pair of a lod: the floor level l0, its fraction (0 below
// level 0) and the two levels clamped to the chain's count
struct LevelPair {
  int l0, a, b;
  float f;
};

__device__ __forceinline__ LevelPair level_pair(float lod, int count) {
  const float fl = floorf(lod);
  LevelPair p;
  p.l0 = to_i32(fl);
  p.f = p.l0 < 0 ? 0.0f : sub(lod, fl);
  p.a = min(max(p.l0, 0), iadd(count, -1));
  p.b = min(max(iadd(p.l0, 1), 0), iadd(count, -1));
  return p;
}

// ops/texture.py sample_anisotropic (and sample_material_interleaved's
// taps): `taps` trilinear samples along the major axis, lod from the minor
// axis clamped by the tap count; taps <= 1: trilinear at the isotropic lod.
// tri(u, v, lod, out) writes C channels.
template <int C, class Tri>
__device__ __forceinline__ void anisotropic(const Tri& tri, float u, float v, float dux,
                                            float dvx, float duy, float dvy, float w, float h,
                                            int taps, float* out) {
  const float eps = (float)1e-12;
  const float ax = mul(dux, w), bx = mul(dvx, h);
  const float dx2 = add(mul(ax, ax), mul(bx, bx));
  const float ay = mul(duy, w), by = mul(dvy, h);
  const float dy2 = add(mul(ay, ay), mul(by, by));
  if (taps <= 1) {
    const float lod = clamp_min(mul(0.5f, log2f(clamp_min(maximum(dx2, dy2), eps))), 0.0f);
    tri(u, v, lod, out);
    return;
  }
  const bool major_x = dx2 >= dy2;
  const float maj = maximum(dx2, dy2), mnr = minimum(dx2, dy2);
  const float ratio2 = clamp(quo(maj, clamp_min(mnr, eps)), 1.0f,
                             (float)((double)taps * (double)taps));
  const float lod = clamp_min(mul(0.5f, log2f(clamp_min(quo(maj, ratio2), eps))), 0.0f);
  const float mu = major_x ? dux : duy, mv = major_x ? dvx : dvy;
  float s[C];
  for (int i = 0; i < taps; ++i) {
    const float t = (float)(((double)i + 0.5) / (double)taps - 0.5);
    const float tu = add(u, mul(mu, t)), tv = add(v, mul(mv, t));
    if (i == 0) {
      tri(tu, tv, lod, out);
    } else {
      tri(tu, tv, lod, s);
      for (int c = 0; c < C; ++c) out[c] = add(out[c], s[c]);
    }
  }
  const float inv = (float)(1.0 / (double)taps);  // out / taps: a product with 1 / taps
  for (int c = 0; c < C; ++c) out[c] = mul(out[c], inv);
}

// --- the classic per-slot sampler -------------------------------------------

// One slot of a material: sample_trilinear's in-register branch
struct ClassicTri {
  const uint8_t* pool;
  long long n;
  bool quad;
  int count, wrap, flags, L;
  const int* levels;  // L x (offset, w, h)
  bool srgb;

  __device__ void bilinear(const int* owh, float u, float v, float* r) const {
    const int off = __ldg(owh), w = __ldg(owh + 1), h = __ldg(owh + 2);
    TapPos t = tap_pos(u, v, w, h);
    if (quad) {
      const long long row = quad_row(t, off, w, h, wrap, n);
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(pool) + row);
      for (int c = 0; c < 4; ++c)
        r[c] = lerp4(byte_of(q.x, c), byte_of(q.y, c), byte_of(q.z, c), byte_of(q.w, c), t.fx,
                     t.fy);
      return;
    }
    const uint32_t* texel = reinterpret_cast<const uint32_t*>(pool);
    const int x1 = iadd(t.x0, 1), y1 = iadd(t.y0, 1);
    const int xa = wrap_coord(t.x0, w, wrap), xb = wrap_coord(x1, w, wrap);
    const int ya = wrap_coord(t.y0, h, wrap), yb = wrap_coord(y1, h, wrap);
    const uint32_t t00 = __ldg(texel + row_of(iadd(iadd(off, imul(ya, w)), xa), n));
    const uint32_t t10 = __ldg(texel + row_of(iadd(iadd(off, imul(ya, w)), xb), n));
    const uint32_t t01 = __ldg(texel + row_of(iadd(iadd(off, imul(yb, w)), xa), n));
    const uint32_t t11 = __ldg(texel + row_of(iadd(iadd(off, imul(yb, w)), xb), n));
    for (int c = 0; c < 4; ++c)
      r[c] = lerp4(byte_of(t00, c), byte_of(t10, c), byte_of(t01, c), byte_of(t11, c), t.fx,
                   t.fy);
  }

  __device__ void operator()(float u, float v, float lod, float* out) const {
    const LevelPair p = level_pair(lod, count);
    float a[4], b[4];
    bilinear(levels + 3 * select_level(p.a, L), u, v, a);
    bilinear(levels + 3 * select_level(p.b, L), u, v, b);
    const bool dec = srgb && (flags & kTexflagSrgb) != 0;
    decode(a, dec);
    decode(b, dec);
    level_blend<4>(a, b, p.f, out);
  }
};

__global__ void __launch_bounds__(kThreads)
    classic_sample_kernel(int lanes, const float* __restrict__ uv, long long uv_s,
                          const float* __restrict__ ddx, long long ddx_s,
                          const float* __restrict__ ddy, long long ddy_s,
                          const int* __restrict__ mat, long long mat_s,
                          const float* __restrict__ table, long long row_s, long long n_rows,
                          int L, const uint8_t* __restrict__ pool, long long n_pool, int quad,
                          int taps, int decode_srgb, int n_slots, int slot_code,
                          float* __restrict__ out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= lanes) return;
  const float u = uv[p * uv_s], v = uv[p * uv_s + 1];
  const float dux = ddx[p * ddx_s], dvx = ddx[p * ddx_s + 1];
  const float duy = ddy[p * ddy_s], dvy = ddy[p * ddy_s + 1];
  const int* row = reinterpret_cast<const int*>(table) + row_of(mat[p * mat_s], n_rows) * row_s;
  float4* dst = reinterpret_cast<float4*>(out + p * 4 * n_slots);
  for (int k = 0; k < n_slots; ++k) {
    const int slot = (slot_code >> (2 * k)) & 3;
    const int* meta = row + 20 + 6 * slot;  // base, count, wrap, flags, w, h
    ClassicTri tri{pool, n_pool, quad != 0, __ldg(meta + 1), __ldg(meta + 2), __ldg(meta + 3), L,
                   row + 44 + 3 * L * slot, decode_srgb != 0};
    float r[4];
    anisotropic<4>(tri, u, v, dux, dvx, duy, dvy, (float)__ldg(meta + 4), (float)__ldg(meta + 5),
                   taps, r);
    dst[k] = make_float4(r[0], r[1], r[2], r[3]);
  }
}

// --- the interleaved material sampler ---------------------------------------

enum MatqRows { kRows64 = 0, kRows64Tail = 1, kRowsMq3 = 2 };

// sample_material_interleaved's trilinear: all wanted slots of a level
// from one material row (64 B: four slots' quads; 208 B: the level's quads,
// then each slot's 3 x 3 texels of the next level)
struct MatqTri {
  const uint8_t* mq;
  long long n_mq;
  const uint8_t* tail;
  long long n_tail;
  int kind, wrap, mask, count, L, want;
  const int* owh;  // L x (offset, w, h, tail offset)
  bool srgb;

  // one level's quads (_matq_bilinear) -> r[4 * slot + channel], raw
  __device__ void quads(const uint8_t* pool, long long n, int width, int off, int w, int h,
                        float u, float v, float* r) const {
    TapPos t = tap_pos(u, v, w, h);
    const uint8_t* row = pool + quad_row(t, off, w, h, wrap, n) * width;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (!((want >> s) & 1)) continue;
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(row) + s);
      for (int c = 0; c < 4; ++c)
        r[4 * s + c] = lerp4(byte_of(q.x, c), byte_of(q.y, c), byte_of(q.z, c), byte_of(q.w, c),
                             t.fx, t.fy);
    }
  }

  // _mq3_levels: both levels from one 208-B row
  __device__ void mq3(const int* a_owh, const int* b_owh, bool self_pair, float u, float v,
                      float* a, float* b) const {
    const int off = __ldg(a_owh), w = __ldg(a_owh + 1), h = __ldg(a_owh + 2);
    TapPos t = tap_pos(u, v, w, h);
    const int xi = wrap_coord(t.x0, w, wrap), yi = wrap_coord(t.y0, h, wrap);
    const uint8_t* row = mq + quad_row(t, off, w, h, wrap, n_mq) * 208;
    const bool clamped = wrap == kWrapClamp;
    const int wb = __ldg(b_owh + 1), hb = __ldg(b_owh + 2);
    TapPos tb = tap_pos(u, v, wb, hb);
    if (clamped && tb.x0 < 0) tb.fx = 0.0f;
    if (clamped && tb.y0 < 0) tb.fy = 0.0f;
    // the level-b tap's place in the baked 3-window
    auto window = [&](int v1, int v0, int vi, int dim, int& p0, int& p1) {
      const int c_rep = self_pair ? v0 : (v0 >> 1);
      const int p0_rep = iadd(v1, -iadd(c_rep, -1));
      const int c_cl = self_pair ? vi : (vi >> 1);
      const int p0_cl = iadd(min(max(v1, 0), iadd(dim, -1)), -iadd(c_cl, -1));
      const int p1_cl = iadd(min(max(iadd(v1, 1), 0), iadd(dim, -1)), -iadd(c_cl, -1));
      p0 = min(max(clamped ? p0_cl : p0_rep, 0), 2);
      p1 = min(max(clamped ? p1_cl : iadd(p0_rep, 1), 0), 2);
    };
    int px0, px1, py0, py1;
    window(tb.x0, t.x0, xi, wb, px0, px1);
    window(tb.y0, t.y0, yi, hb, py0, py1);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (!((want >> s) & 1)) continue;
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(row) + s);
      const uint32_t* cells = reinterpret_cast<const uint32_t*>(row + 64 + 36 * s);
      const uint32_t c00 = __ldg(cells + py0 * 3 + px0), c10 = __ldg(cells + py0 * 3 + px1);
      const uint32_t c01 = __ldg(cells + py1 * 3 + px0), c11 = __ldg(cells + py1 * 3 + px1);
      for (int c = 0; c < 4; ++c) {
        a[4 * s + c] = lerp4(byte_of(q.x, c), byte_of(q.y, c), byte_of(q.z, c), byte_of(q.w, c),
                             t.fx, t.fy);
        b[4 * s + c] = lerp4(byte_of(c00, c), byte_of(c10, c), byte_of(c01, c), byte_of(c11, c),
                             tb.fx, tb.fy);
      }
    }
  }

  __device__ void operator()(float u, float v, float lod, float* out) const {
    const LevelPair p = level_pair(lod, count);
    const int* a_owh = owh + 4 * select_level(p.a, L);
    const int* b_owh = owh + 4 * select_level(p.b, L);
    float a[16], b[16];
    for (int c = 0; c < 16; ++c) a[c] = b[c] = 0.0f;
    if (kind == kRowsMq3) {
      mq3(a_owh, b_owh, p.l0 >= iadd(count, -1), u, v, a, b);
    } else {
      quads(mq, n_mq, 64, __ldg(a_owh), __ldg(a_owh + 1), __ldg(a_owh + 2), u, v, a);
      if (kind == kRows64Tail)
        quads(tail, n_tail, 64, __ldg(b_owh + 3), __ldg(b_owh + 1), __ldg(b_owh + 2), u, v, b);
      else
        quads(mq, n_mq, 64, __ldg(b_owh), __ldg(b_owh + 1), __ldg(b_owh + 2), u, v, b);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (!((want >> s) & 1)) continue;
      const bool dec = srgb && ((mask >> s) & 1);
      decode(a + 4 * s, dec);
      decode(b + 4 * s, dec);
    }
    level_blend<16>(a, b, p.f, out);
  }
};

__global__ void __launch_bounds__(kThreads)
    material_sample_kernel(int lanes, const float* __restrict__ uv, long long uv_s,
                           const float* __restrict__ ddx, long long ddx_s,
                           const float* __restrict__ ddy, long long ddy_s,
                           const int* __restrict__ mat, long long mat_s,
                           const float* __restrict__ rows, long long row_s, long long n_rows,
                           int L, const uint8_t* __restrict__ mq, long long n_mq, int kind,
                           const uint8_t* __restrict__ tail, long long n_tail, int taps,
                           int decode_srgb, int n_slots, int slot_code,
                           float* __restrict__ out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= lanes) return;
  const float u = uv[p * uv_s], v = uv[p * uv_s + 1];
  const float dux = ddx[p * ddx_s], dvx = ddx[p * ddx_s + 1];
  const float duy = ddy[p * ddy_s], dvy = ddy[p * ddy_s + 1];
  const long long r = mat != nullptr ? row_of(mat[p * mat_s], n_rows) : p;
  const int* row = reinterpret_cast<const int*>(rows) + r * row_s;
  int want = 0, at[4] = {-1, -1, -1, -1};  // slot -> its place in the output
  for (int k = 0; k < n_slots; ++k) {
    const int s = (slot_code >> (2 * k)) & 3;
    want |= 1 << s;
    at[s] = k;
  }
  // meta: wrap, sRGB mask, count, pad; then L x (offset, w, h, tail offset)
  const int* owh = row + 24;
  MatqTri tri{mq, n_mq, tail, n_tail, kind, __ldg(row + 20), __ldg(row + 21), __ldg(row + 22),
              L, want, owh, decode_srgb != 0};
  float s16[16];
  anisotropic<16>(tri, u, v, dux, dvx, duy, dvy, (float)__ldg(owh + 1), (float)__ldg(owh + 2),
                  taps, s16);
  float4* dst = reinterpret_cast<float4*>(out + p * 4 * n_slots);
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (at[s] >= 0)
      dst[at[s]] = make_float4(s16[4 * s], s16[4 * s + 1], s16[4 * s + 2], s16[4 * s + 3]);
}

int blocks(int lanes) { return (lanes + kThreads - 1) / kThreads; }

}  // namespace

// The C entry points (ops/texture.py binds them with ctypes). Pointers
// are device pointers; strides are in elements; the result is the launch's
// cudaError_t.
extern "C" int sc_classic_sample(int lanes, const float* uv, long long uv_s, const float* ddx,
                                 long long ddx_s, const float* ddy, long long ddy_s,
                                 const int* mat, long long mat_s, const float* table,
                                 long long row_s, long long n_rows, int L, const uint8_t* pool,
                                 long long n_pool, int quad, int taps, int decode_srgb,
                                 int n_slots, int slot_code, float* out, void* stream) {
  classic_sample_kernel<<<blocks(lanes), kThreads, 0, (cudaStream_t)stream>>>(
      lanes, uv, uv_s, ddx, ddx_s, ddy, ddy_s, mat, mat_s, table, row_s, n_rows, L, pool, n_pool,
      quad, taps, decode_srgb, n_slots, slot_code, out);
  return (int)cudaGetLastError();
}

extern "C" int sc_material_sample(int lanes, const float* uv, long long uv_s, const float* ddx,
                                  long long ddx_s, const float* ddy, long long ddy_s,
                                  const int* mat, long long mat_s, const float* rows,
                                  long long row_s, long long n_rows, int L, const uint8_t* mq,
                                  long long n_mq, int kind, const uint8_t* tail,
                                  long long n_tail, int taps, int decode_srgb, int n_slots,
                                  int slot_code, float* out, void* stream) {
  material_sample_kernel<<<blocks(lanes), kThreads, 0, (cudaStream_t)stream>>>(
      lanes, uv, uv_s, ddx, ddx_s, ddy, ddy_s, mat, mat_s, rows, row_s, n_rows, L, mq, n_mq, kind,
      tail, n_tail, taps, decode_srgb, n_slots, slot_code, out);
  return (int)cudaGetLastError();
}
