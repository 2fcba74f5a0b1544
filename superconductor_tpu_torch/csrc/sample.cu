// Material samplers on Hopper (sm_90a): the classic per-slot sampler, a
// thread a (lane, wanted slot), and the interleaved material sampler, a
// thread a lane.
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
// The contract: a call samples n lanes, lane ids[i] (or lane i when ids is
// null) of the caller's P lanes. It reads that lane's uv, derivatives and
// material id in place (any lane stride) and writes its 4 x n_slots floats
// to row ids[i] of out (P rows of out_s floats); the other rows of out are
// left as they are. render/frame.py's material partition samples each of
// its two segments so, straight from the g-buffer into one result: no
// permutation of the inputs, no concatenation and no inverse permutation
// of the results. An id is taken as torch's indexing takes it (negative
// from the end); ids must be distinct.
//
// What bounds them on this card: instructions and the latency of a chain
// of dependent loads more than bytes. A lane reads its id (4 B), uv and
// derivatives (24 B) and material id (4 B), then a few ints of its
// material's row (a table of a few rows that stays in L1, or the lane's
// own row of the shade row), then the level entries, then one 16-B quad
// (or a 64-B / 208-B material row) a bilinear tap, and writes 16 B a slot.
// But a slot's trilinear sample is some 400 instructions in sRGB (two
// levels of four 13-operation lerps, and a powf for each colour channel
// of each level) and 150 without: at 1080p that issue time is of the order
// of the bytes' time.
//
// Design. Every tap's texels are fetched whole (Tap) before any filtering,
// so a lane's loads of both levels are in flight together; the tap count
// the frames use (RenderConfig.aniso_taps = 1) is a template, other tap
// counts take the generic path. Where the level fraction is 0 (every
// magnified lane: the lod clamps to 0) level b neither loads nor filters
// (trilinear says why the bits do not change), which halves such a lane's
// loads and powf. Everything stays in registers; the material row is read
// in place; no shared memory (the material tables are a few rows, which L1
// holds).
// * classic_sample_kernel: a thread a (lane, wanted slot), a warp one slot
//   of 32 adjacent lanes: each slot has its own texture, size and so LOD,
//   nothing is shared between a lane's slots but its inputs (which the
//   slot's warps read from L1), and a warp reads one texture and takes one
//   decode branch.
// * material_sample_kernel: a thread a lane, every wanted slot. The four
//   slots of an interleaved row share the LOD, the level pair, the tap
//   positions and the rows, so the lane locates them once, then fetches
//   and filters one slot at a time (60 registers, no spills: twice the
//   resident threads of the first design's 120). A thread a (lane, slot)
//   repeated that shared work once a slot and measured slower than the
//   first design (PERF.md). Computing it in one of a lane's four threads
//   and broadcasting it with __shfl_sync would issue no fewer of the
//   warp's instructions: the other three threads wait masked while it is
//   computed, so a warp still pays the shared work once for 8 lanes where
//   a thread a lane pays it once for 32.
// The first design ran a thread a lane in both, with every slot's channels
// of both levels in registers.
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

constexpr int kThreads = 256;  // a block of the material kernel (a thread a lane)
constexpr int kLanes = 64;  // a block of the classic kernel: kLanes threads a wanted slot
constexpr int kTexflagSrgb = 1;

// _select_level: row lvl of an L-row table by a select ladder
__device__ __forceinline__ int select_level(int lvl, int L) {
  return lvl >= 1 ? min(lvl, L - 1) : 0;
}

// u8 -> [0, 1] (_decode_u8), then the sRGB decode of the colour channels
__device__ __forceinline__ void decode(float* r, bool srgb) {
  const float s = (float)(1.0 / 255.0);
  for (int c = 0; c < 4; ++c) r[c] = mul(r[c], s);
  if (srgb)
    for (int c = 0; c < 3; ++c) r[c] = srgb_to_linear(r[c]);
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

// One bilinear tap of one slot, fetched: its four texels (t00, t10, t01,
// t11, a byte a channel) and its fractions
struct Tap {
  uint4 q;
  float fx, fy;
};

// a tap filtered (_lerp4 a channel) and decoded
__device__ __forceinline__ void level(const Tap& t, bool srgb, float* r) {
  for (int c = 0; c < 4; ++c)
    r[c] = lerp4(byte_of(t.q.x, c), byte_of(t.q.y, c), byte_of(t.q.z, c), byte_of(t.q.w, c),
                 t.fx, t.fy);
  decode(r, srgb);
}

// the two levels' taps filtered, decoded and blended a * (1 - f) + b * f.
// At f == 0 that is a itself, bit for bit: a * 1 is a, and b, decoded from
// bytes with weights in [0, 1], is finite and >= +0, so b * 0 is +0 and
// a + +0 is a (a >= +0 too, or NaN as the blend would make it). So a lane
// at f == 0 (every magnified lane: lod clamps to 0) neither fetches nor
// filters level b: `b` may be unread there.
__device__ __forceinline__ void trilinear(const Tap& a, const Tap& b, float f, bool srgb,
                                          float* out) {
  level(a, srgb, out);
  if (f == 0.0f) return;
  float rb[4];
  level(b, srgb, rb);
  const float g = sub(1.0f, f);
  for (int c = 0; c < 4; ++c) out[c] = add(mul(out[c], g), mul(rb[c], f));
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
  int count, wrap, L;
  const int* levels;  // L x (offset, w, h)
  bool srgb;

  __device__ __forceinline__ Tap fetch(const int* owh, float u, float v) const {
    const int off = __ldg(owh), w = __ldg(owh + 1), h = __ldg(owh + 2);
    TapPos t = tap_pos(u, v, w, h);
    if (quad) {
      const long long row = quad_row(t, off, w, h, wrap, n);
      return {__ldg(reinterpret_cast<const uint4*>(pool) + row), t.fx, t.fy};
    }
    const uint32_t* texel = reinterpret_cast<const uint32_t*>(pool);
    const int x1 = iadd(t.x0, 1), y1 = iadd(t.y0, 1);
    const int xa = wrap_coord(t.x0, w, wrap), xb = wrap_coord(x1, w, wrap);
    const int ya = wrap_coord(t.y0, h, wrap), yb = wrap_coord(y1, h, wrap);
    const uint32_t t00 = __ldg(texel + row_of(iadd(iadd(off, imul(ya, w)), xa), n));
    const uint32_t t10 = __ldg(texel + row_of(iadd(iadd(off, imul(ya, w)), xb), n));
    const uint32_t t01 = __ldg(texel + row_of(iadd(iadd(off, imul(yb, w)), xa), n));
    const uint32_t t11 = __ldg(texel + row_of(iadd(iadd(off, imul(yb, w)), xb), n));
    return {make_uint4(t00, t10, t01, t11), t.fx, t.fy};
  }

  __device__ __forceinline__ void operator()(float u, float v, float lod, float* out) const {
    const LevelPair p = level_pair(lod, count);
    const Tap a = fetch(levels + 3 * select_level(p.a, L), u, v);
    Tap b;
    if (p.f != 0.0f) b = fetch(levels + 3 * select_level(p.b, L), u, v);
    trilinear(a, b, p.f, srgb, out);
  }
};

// A thread a (lane, wanted slot): a block of kLanes * n_slots threads
// samples kLanes lanes, its k-th kLanes threads the k-th wanted slot of
// each, so a warp samples one slot of 32 adjacent lanes. Thread j takes
// lane ids[i] (lane i without ids), i = blockIdx.x * kLanes + j % kLanes.
// TAPS: 1, the frames' tap count, or 0, any (the `taps` argument)
template <int TAPS>
__global__ void __launch_bounds__(kThreads)
    classic_sample_kernel(int n, const int* __restrict__ ids, long long lanes,
                          const float* __restrict__ uv, long long uv_s,
                          const float* __restrict__ ddx, long long ddx_s,
                          const float* __restrict__ ddy, long long ddy_s,
                          const int* __restrict__ mat, long long mat_s,
                          const float* __restrict__ table, long long row_s, long long n_rows,
                          int L, const uint8_t* __restrict__ pool, long long n_pool, int quad,
                          int taps, int decode_srgb, int slot_code, float* __restrict__ out,
                          long long out_s) {
  const int i = blockIdx.x * kLanes + threadIdx.x % kLanes, k = threadIdx.x / kLanes;
  if (i >= n) return;
  const long long p = ids != nullptr ? row_of(__ldg(ids + i), lanes) : i;
  const float u = __ldg(uv + p * uv_s), v = __ldg(uv + p * uv_s + 1);
  const float dux = __ldg(ddx + p * ddx_s), dvx = __ldg(ddx + p * ddx_s + 1);
  const float duy = __ldg(ddy + p * ddy_s), dvy = __ldg(ddy + p * ddy_s + 1);
  const int* row =
      reinterpret_cast<const int*>(table) + row_of(__ldg(mat + p * mat_s), n_rows) * row_s;
  const int slot = (slot_code >> (2 * k)) & 3;
  const int* meta = row + 20 + 6 * slot;  // base, count, wrap, flags, w, h
  const bool srgb = decode_srgb != 0 && (__ldg(meta + 3) & kTexflagSrgb) != 0;
  const ClassicTri tri{pool, n_pool, quad != 0, __ldg(meta + 1), __ldg(meta + 2), L,
                       row + 44 + 3 * L * slot, srgb};
  float r[4];
  anisotropic<4>(tri, u, v, dux, dvx, duy, dvy, (float)__ldg(meta + 4), (float)__ldg(meta + 5),
                 TAPS > 0 ? TAPS : taps, r);
  *reinterpret_cast<float4*>(out + p * out_s + 4 * k) = make_float4(r[0], r[1], r[2], r[3]);
}

// --- the interleaved material sampler ---------------------------------------

enum MatqRows { kRows64 = 0, kRows64Tail = 1, kRowsMq3 = 2 };

// sample_material_interleaved's trilinear for every wanted slot of a lane:
// one tap position, level pair and material row a level serve all four
// slots (64-B rows: four slots' quads, the slot's at 16 s; 208-B rows: the
// level's quads, then each slot's 3 x 3 texels of the next level), so the
// lane locates them once and then fetches and filters a slot at a time
struct MatqTri {
  const uint8_t* mq;
  long long n_mq;
  const uint8_t* tail;
  long long n_tail;
  int kind, wrap, count, L;
  const int* owh;  // L x (offset, w, h, tail offset)
  int n_slots, slot_code, srgb_mask;

  // a level's 64-B row (_matq_bilinear) and the tap's fractions
  __device__ __forceinline__ const uint4* quad_row64(const uint8_t* pool, long long n, int off,
                                                     int w, int h, float u, float v,
                                                     float& fx, float& fy) const {
    TapPos t = tap_pos(u, v, w, h);
    const long long row = quad_row(t, off, w, h, wrap, n);
    fx = t.fx;
    fy = t.fy;
    return reinterpret_cast<const uint4*>(pool + row * 64);
  }

  __device__ __forceinline__ void operator()(float u, float v, float lod, float* out) const {
    const LevelPair p = level_pair(lod, count);
    const int* a_owh = owh + 4 * select_level(p.a, L);
    const int* b_owh = owh + 4 * select_level(p.b, L);
    const uint4 *row_a, *row_b = nullptr;
    const uint32_t* cells = nullptr;
    float ax, ay, bx, by;
    int px0 = 0, px1 = 0, py0 = 0, py1 = 0;
    if (kind == kRowsMq3) {
      // _mq3_levels: both levels from one 208-B row
      const int off = __ldg(a_owh), w = __ldg(a_owh + 1), h = __ldg(a_owh + 2);
      const int wb = __ldg(b_owh + 1), hb = __ldg(b_owh + 2);
      const bool self_pair = p.l0 >= iadd(count, -1);
      TapPos t = tap_pos(u, v, w, h);
      const int xi = wrap_coord(t.x0, w, wrap), yi = wrap_coord(t.y0, h, wrap);
      const uint8_t* row = mq + quad_row(t, off, w, h, wrap, n_mq) * 208;
      const bool clamped = wrap == kWrapClamp;
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
      window(tb.x0, t.x0, xi, wb, px0, px1);
      window(tb.y0, t.y0, yi, hb, py0, py1);
      row_a = reinterpret_cast<const uint4*>(row);
      cells = reinterpret_cast<const uint32_t*>(row + 64);
      ax = t.fx, ay = t.fy, bx = tb.fx, by = tb.fy;
    } else {
      row_a = quad_row64(mq, n_mq, __ldg(a_owh), __ldg(a_owh + 1), __ldg(a_owh + 2), u, v, ax,
                         ay);
      if (p.f != 0.0f)
        row_b = kind == kRows64Tail
                    ? quad_row64(tail, n_tail, __ldg(b_owh + 3), __ldg(b_owh + 1),
                                 __ldg(b_owh + 2), u, v, bx, by)
                    : quad_row64(mq, n_mq, __ldg(b_owh), __ldg(b_owh + 1), __ldg(b_owh + 2), u,
                                 v, bx, by);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= n_slots) {  // no slot: its channels stay 0 through the taps' sum
        for (int c = 0; c < 4; ++c) out[4 * k + c] = 0.0f;
        continue;
      }
      const int s = (slot_code >> (2 * k)) & 3;
      const Tap a{__ldg(row_a + s), ax, ay};
      Tap b;
      if (p.f == 0.0f) {
        // level b unread (trilinear)
      } else if (cells != nullptr) {
        const uint32_t* c = cells + 9 * s;
        b = {make_uint4(__ldg(c + py0 * 3 + px0), __ldg(c + py0 * 3 + px1),
                        __ldg(c + py1 * 3 + px0), __ldg(c + py1 * 3 + px1)),
             bx, by};
      } else {
        b = {__ldg(row_b + s), bx, by};
      }
      trilinear(a, b, p.f, (srgb_mask >> s) & 1, out + 4 * k);
    }
  }
};

// A thread a lane: lane ids[i] (lane i without ids), every wanted slot
template <int TAPS>
__global__ void __launch_bounds__(kThreads)
    material_sample_kernel(int n, const int* __restrict__ ids, long long lanes,
                           const float* __restrict__ uv, long long uv_s,
                           const float* __restrict__ ddx, long long ddx_s,
                           const float* __restrict__ ddy, long long ddy_s,
                           const int* __restrict__ mat, long long mat_s,
                           const float* __restrict__ rows, long long row_s, long long n_rows,
                           int L, const uint8_t* __restrict__ mq, long long n_mq, int kind,
                           const uint8_t* __restrict__ tail, long long n_tail, int taps,
                           int decode_srgb, int n_slots, int slot_code,
                           float* __restrict__ out, long long out_s) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long p = ids != nullptr ? row_of(__ldg(ids + i), lanes) : i;
  const float u = __ldg(uv + p * uv_s), v = __ldg(uv + p * uv_s + 1);
  const float dux = __ldg(ddx + p * ddx_s), dvx = __ldg(ddx + p * ddx_s + 1);
  const float duy = __ldg(ddy + p * ddy_s), dvy = __ldg(ddy + p * ddy_s + 1);
  const long long r = mat != nullptr ? row_of(__ldg(mat + p * mat_s), n_rows) : p;
  const int* row = reinterpret_cast<const int*>(rows) + r * row_s;
  // meta: wrap, sRGB mask, count, pad; then L x (offset, w, h, tail offset)
  const int* owh = row + 24;
  const MatqTri tri{mq, n_mq, tail, n_tail, kind, __ldg(row + 20), __ldg(row + 22), L, owh,
                    n_slots, slot_code, decode_srgb != 0 ? __ldg(row + 21) : 0};
  float c[16];
  anisotropic<16>(tri, u, v, dux, dvx, duy, dvy, (float)__ldg(owh + 1), (float)__ldg(owh + 2),
                  TAPS > 0 ? TAPS : taps, c);
  float4* dst = reinterpret_cast<float4*>(out + p * out_s);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < n_slots) dst[k] = make_float4(c[4 * k], c[4 * k + 1], c[4 * k + 2], c[4 * k + 3]);
}

unsigned blocks(int n, int lanes_a_block) {
  return (unsigned)((n + lanes_a_block - 1) / lanes_a_block);
}

}  // namespace

// The C entry points (ops/raster.py binds them with ctypes). Pointers
// are device pointers (ids may be null); strides are in elements; n = 0
// launches nothing; the result is the launch's cudaError_t.
extern "C" int sc_classic_sample(int n, const int* ids, long long lanes, const float* uv,
                                 long long uv_s, const float* ddx, long long ddx_s,
                                 const float* ddy, long long ddy_s, const int* mat,
                                 long long mat_s, const float* table, long long row_s,
                                 long long n_rows, int L, const uint8_t* pool, long long n_pool,
                                 int quad, int taps, int decode_srgb, int n_slots, int slot_code,
                                 float* out, long long out_s, void* stream) {
  if (n <= 0) return 0;
  auto kernel = taps == 1 ? classic_sample_kernel<1> : classic_sample_kernel<0>;
  kernel<<<blocks(n, kLanes), kLanes * n_slots, 0, (cudaStream_t)stream>>>(
      n, ids, lanes, uv, uv_s, ddx, ddx_s, ddy, ddy_s, mat, mat_s, table, row_s, n_rows, L, pool,
      n_pool, quad, taps, decode_srgb, slot_code, out, out_s);
  return (int)cudaGetLastError();
}

extern "C" int sc_material_sample(int n, const int* ids, long long lanes, const float* uv,
                                  long long uv_s, const float* ddx, long long ddx_s,
                                  const float* ddy, long long ddy_s, const int* mat,
                                  long long mat_s, const float* rows, long long row_s,
                                  long long n_rows, int L, const uint8_t* mq, long long n_mq,
                                  int kind, const uint8_t* tail, long long n_tail, int taps,
                                  int decode_srgb, int n_slots, int slot_code, float* out,
                                  long long out_s, void* stream) {
  if (n <= 0) return 0;
  auto kernel = taps == 1 ? material_sample_kernel<1> : material_sample_kernel<0>;
  kernel<<<blocks(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      n, ids, lanes, uv, uv_s, ddx, ddx_s, ddy, ddy_s, mat, mat_s, rows, row_s, n_rows, L, mq,
      n_mq, kind, tail, n_tail, taps, decode_srgb, n_slots, slot_code, out, out_s);
  return (int)cudaGetLastError();
}

// Registers a thread, local (spill) bytes a thread, resident blocks an SM
// and threads a block of kernel `which` (0: classic, 1: material; taps1:
// the one-tap template, else the generic one) at the block its launch
// takes for n_slots wanted slots, into info[0..3]; the result is a
// cudaError_t.
extern "C" int sc_sample_kernel_info(int which, int taps1, int n_slots, int* info) {
  const void* classic = taps1 ? (const void*)classic_sample_kernel<1>
                              : (const void*)classic_sample_kernel<0>;
  const void* material = taps1 ? (const void*)material_sample_kernel<1>
                               : (const void*)material_sample_kernel<0>;
  const void* fn = which == 0 ? classic : material;
  const int block = which == 0 ? kLanes * n_slots : kThreads;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn, block, 0);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = resident;
  info[3] = block;
  return (int)err;
}
