// G-buffer interpolation on Hopper (sm_90a): one thread a lane.
//
// Replaces no TPU kernel. The JAX package computes this in XLA:
// superconductor_tpu/ops/shade.py:73 interpolate_gbuffer. The port ran it
// as a chain of about 69 torch operations (ops/shade.py
// interpolate_gbuffer_plain, which stays as the plain version): the shade
// row gather, the edge functions, the sums, the reciprocal, the
// barycentrics, four interpolations and two pairs of derivatives, each
// writing its whole (lanes, 3, C) result to device memory for the next to
// read back.
//
// gbuffer_kernel: a lane's winner pair (dead lanes, pair < 0, read row 0,
// as clamp_min(pair, 0) does), its setup row's columns 0-8 and 15 and its
// 32 packed attribute columns, read in place from the shade row (setup
// 0-16, packed 16-48, the mat_row_mq tail 48-row_cols) or from the setup
// and packed attribute tables, by pointer and row stride: no column slice
// is copied. It writes every GBuffer field (ops/shade.py GBuffer): valid,
// front_facing, lightmapped (bool), material (i32, the bits of packed
// column 30), world_pos, normal, dpdx, dpdy (P, 3), uv, lm_uv, duvdx, duvdy
// (P, 2), and the tail (P, row_cols - 48) when the row has one.
//
// What bounds it on this card: bytes. A lane reads its pair, px and py
// (12 B) and 42 floats of its row (168 B, in the 32-B sectors that hold
// them), and the tail it copies; it writes 86 B and the tail. The
// arithmetic (about 150 FP32 operations a lane, one division) is far below
// the card's rate.
//
// Design: registers only; the row's columns are read in place (16-B loads
// where the row is 16-B aligned), and nothing is written to device memory
// but the result. The tail is copied by the warp together, one lane's row
// at a time, so that its reads and writes are whole sectors.
//
// Bit for bit with the torch chain on the card (csrc/torch_exact.cuh): the
// order of each product, sum and quotient is the chain's:
// e_i = (a_i * px + b_i * py) + c_i; _sum3 is (x0 + x1) + x2; inv_d =
// 1.0 / where(d == 0, 1, d), a reciprocal then a product with 1.0; bary_i =
// e_i * inv_d; interp = _sum3(av_i * bary_i); deriv: n = _sum3(e_i * av_i),
// n_dx = _sum3(dx_i * av_i), ddx = (n_dx - n * (d_dx * inv_d)) * inv_d.

#include <cuda_runtime.h>
#include <stdint.h>

#include "torch_exact.cuh"

namespace {

constexpr int kThreads = 256;

struct GBufferOut {
  uint8_t* valid;
  uint8_t* front_facing;
  uint8_t* lightmapped;
  int* material;
  float* world_pos;  // (P, 3)
  float* normal;
  float* dpdx;
  float* dpdy;
  float* uv;  // (P, 2)
  float* lm_uv;
  float* duvdx;
  float* duvdy;
  uint32_t* tail;  // (P, tail_cols), or null
  int tail_cols;
};

// columns [0, 4 n) of a row: 16-B loads where aligned, else 4-B loads
template <bool kVec>
__device__ __forceinline__ void load_cols(const float* row, int n, float* dst) {
  if (kVec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (int k = 0; k < n; ++k) {
      const float4 q = __ldg(r4 + k);
      dst[4 * k] = q.x;
      dst[4 * k + 1] = q.y;
      dst[4 * k + 2] = q.z;
      dst[4 * k + 3] = q.w;
    }
  } else {
    for (int k = 0; k < 4 * n; ++k) dst[k] = __ldg(row + k);
  }
}

// interp: _sum3(av_i * bary_i) of C components; av at av[stride * i + c]
template <int C>
__device__ __forceinline__ void interp(const float* av, const float* bary, float* out) {
#pragma unroll
  for (int c = 0; c < C; ++c)
    out[c] = add(add(mul(av[c], bary[0]), mul(av[C + c], bary[1])), mul(av[2 * C + c], bary[2]));
}

// deriv: (n_dx - n_val * (d_dx * inv_d)) * inv_d and the same in y
template <int C>
__device__ __forceinline__ void deriv(const float* av, const float* e, const float* dx,
                                      const float* dy, float rx, float ry, float inv_d,
                                      float* ddx, float* ddy) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float a0 = av[c], a1 = av[C + c], a2 = av[2 * C + c];
    const float n_val = add(add(mul(e[0], a0), mul(e[1], a1)), mul(e[2], a2));
    const float n_dx = add(add(mul(dx[0], a0), mul(dx[1], a1)), mul(dx[2], a2));
    const float n_dy = add(add(mul(dy[0], a0), mul(dy[1], a1)), mul(dy[2], a2));
    ddx[c] = mul(sub(n_dx, mul(n_val, rx)), inv_d);
    ddy[c] = mul(sub(n_dy, mul(n_val, ry)), inv_d);
  }
}

template <int C>
__device__ __forceinline__ void store(float* dst, long long p, const float* v) {
#pragma unroll
  for (int c = 0; c < C; ++c) dst[p * C + c] = v[c];
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    gbuffer_kernel(int lanes, const int* __restrict__ pair, long long pair_s,
                   const float* __restrict__ px, long long px_s, const float* __restrict__ py,
                   long long py_s, const float* __restrict__ setup, long long setup_s,
                   const float* __restrict__ packed, long long packed_s, long long n_rows,
                   const uint32_t* __restrict__ tail_src, long long tail_s, GBufferOut o) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long r = 0;
  if (p < lanes) {
    const int pr = __ldg(pair + p * pair_s);
    r = row_of(max(pr, 0), n_rows);
    const float* srow = setup + r * setup_s;
    float s[9];
    load_cols<kVec>(srow, 2, s);
    s[8] = __ldg(srow + 8);
    const float flags = __ldg(srow + 15);
    float av[32];
    load_cols<kVec>(packed + r * packed_s, 8, av);
    const float X = __ldg(px + p * px_s), Y = __ldg(py + p * py_s);

    float e[3], dx[3], dy[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      dx[i] = s[3 * i];
      dy[i] = s[3 * i + 1];
      e[i] = add(add(mul(s[3 * i], X), mul(s[3 * i + 1], Y)), s[3 * i + 2]);
    }
    const float d_val = add(add(e[0], e[1]), e[2]);
    const float d_dx = add(add(dx[0], dx[1]), dx[2]);
    const float d_dy = add(add(dy[0], dy[1]), dy[2]);
    const float inv_d = recip_times_one(d_val == 0.0f ? 1.0f : d_val);
    const float bary[3] = {mul(e[0], inv_d), mul(e[1], inv_d), mul(e[2], inv_d)};
    const float rx = mul(d_dx, inv_d), ry = mul(d_dy, inv_d);

    // packed: world_pos 0-8, normal 9-17, uv 18-23, lm_uv 24-29 (vertex
    // major), material bits 30, lightmapped 31
    float v3[3], w3[3];
    interp<3>(av, bary, v3);
    store<3>(o.world_pos, p, v3);
    interp<3>(av + 9, bary, v3);
    store<3>(o.normal, p, v3);
    deriv<3>(av, e, dx, dy, rx, ry, inv_d, v3, w3);
    store<3>(o.dpdx, p, v3);
    store<3>(o.dpdy, p, w3);
    float v2[2], w2[2];
    interp<2>(av + 18, bary, v2);
    store<2>(o.uv, p, v2);
    interp<2>(av + 24, bary, v2);
    store<2>(o.lm_uv, p, v2);
    deriv<2>(av + 18, e, dx, dy, rx, ry, inv_d, v2, w2);
    store<2>(o.duvdx, p, v2);
    store<2>(o.duvdy, p, w2);
    o.material[p] = __float_as_int(av[30]);
    o.lightmapped[p] = av[31] != 0.0f;
    o.front_facing[p] = flags == 0.0f;
    o.valid[p] = pr >= 0;
  }
  if (o.tail == nullptr) return;  // uniform over the launch
  // the tail, one lane's row at a time by the whole warp; a warp's threads
  // past the last lane take part in the shuffles
  const int lane = threadIdx.x & 31;
  const long long first = p - lane;
  for (int j = 0; j < 32; ++j) {
    const long long row = __shfl_sync(0xffffffffu, r, j);
    const long long q = first + j;
    if (q >= lanes) break;
    const uint32_t* src = tail_src + row * tail_s;
    uint32_t* dst = o.tail + q * o.tail_cols;
    for (int c = lane; c < o.tail_cols; c += 32) dst[c] = __ldg(src + c);
  }
}

}  // namespace

// The C entry point (ops/shade.py binds it with ctypes). Pointers are
// device pointers; strides are in elements; vec: the setup and packed rows
// are 16-B aligned (pointers and row strides); tail_src null: no tail. The
// result is the launch's cudaError_t.
extern "C" int sc_gbuffer(int lanes, const int* pair, long long pair_s, const float* px,
                          long long px_s, const float* py, long long py_s, const float* setup,
                          long long setup_s, const float* packed, long long packed_s,
                          long long n_rows, int vec, const float* tail_src, long long tail_s,
                          int tail_cols, uint8_t* valid, uint8_t* front_facing,
                          uint8_t* lightmapped, int* material, float* world_pos, float* normal,
                          float* dpdx, float* dpdy, float* uv, float* lm_uv, float* duvdx,
                          float* duvdy, float* tail, void* stream) {
  GBufferOut o{valid, front_facing, lightmapped, material, world_pos, normal, dpdx, dpdy, uv,
               lm_uv, duvdx, duvdy, reinterpret_cast<uint32_t*>(tail), tail_cols};
  const int blocks = (lanes + kThreads - 1) / kThreads;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(tail_src);
  if (vec)
    gbuffer_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        lanes, pair, pair_s, px, px_s, py, py_s, setup, setup_s, packed, packed_s, n_rows, src,
        tail_s, o);
  else
    gbuffer_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        lanes, pair, pair_s, px, px_s, py, py_s, setup, setup_s, packed, packed_s, n_rows, src,
        tail_s, o);
  return (int)cudaGetLastError();
}
