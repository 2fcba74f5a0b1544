// Device helpers shared by the binned rasterizers raster.cu and kbuffer.cu:
// the tile shape, the exact edge arithmetic, the row rejection per 8x8 block
// or rectangle, the map from a thread to its pixels, and the TMA ring's
// mbarrier and bulk-copy wrappers.
//
// Setup row layout (16 f32, 64 B, read as four float4):
//   q0 = a0 b0 c0 a1 | q1 = b1 c1 a2 b2 | q2 = c2 zc0 zc1 zc2 |
//   q3 = wc0 wc1 wc2 flags
// Edge i at a pixel centre is e_i = (a_i*px + b_i*py) + c_i, rounded op by
// op (__fmul_rn / __fadd_rn, never contracted): the reference's order.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kThreads = 512;  // threads of a block
constexpr int kChunk = 64;     // setup rows a ring slot holds (4 KB)
constexpr int kMaxCluster = 8;

__device__ __forceinline__ bool tie_bit(float a, float b) {
  return (a > 0.0f) || (a == 0.0f && b > 0.0f);
}

__device__ __forceinline__ float edge(float a, float b, float c, float px,
                                      float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

__device__ __forceinline__ float dot3(float e0, float e1, float e2, float v0,
                                      float v1, float v2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(e0, v0), __fmul_rn(e1, v1)),
                   __fmul_rn(e2, v2));
}

// The fill-rule test e > 0 || (e == 0 && tie) is e > fill_threshold(a, b):
// e > -0x1p-149 is e >= 0 (comparisons do not flush subnormals), and a NaN
// fails both.
__device__ __forceinline__ float fill_threshold(float a, float b) {
  return tie_bit(a, b) ? __uint_as_float(0x80000001u) : 0.0f;
}

// True unless the edge fails at the block corner where it is largest
// (then it fails at every pixel of the block).
__device__ __forceinline__ bool corner_ok(float a, float b, float c,
                                          float px_lo, float px_hi,
                                          float py_lo, float py_hi) {
  const float e = edge(a, b, c, a > 0.0f ? px_hi : px_lo,
                       b > 0.0f ? py_hi : py_lo);
  return !((e < 0.0f) || (e == 0.0f && !tie_bit(a, b)));
}

// Exact row rejection: false only when some edge of the row (q0, q1 and
// c2 = q2.x) fails at every pixel of the 8x8 block whose top-left pixel is
// (x0, y0), y0 already offset. fl(a*px) is monotone in px and fl(u + v) in
// each argument, so the edge at the corner where it is largest, rounded as
// at a pixel, is the largest value any pixel of the block computes, and
// the fill-rule test is monotone in e. A NaN corner value rejects nothing.
__device__ __forceinline__ bool block_keeps(const float4& q0, const float4& q1,
                                            float c2, int x0, int y0) {
  const float xl = static_cast<float>(x0) + 0.5f;
  const float xh = static_cast<float>(x0 + 7) + 0.5f;
  const float yl = static_cast<float>(y0) + 0.5f;
  const float yh = static_cast<float>(y0 + 7) + 0.5f;
  return corner_ok(q0.x, q0.y, q0.z, xl, xh, yl, yh) &&
         corner_ok(q0.w, q1.x, q1.y, xl, xh, yl, yh) &&
         corner_ok(q1.z, q1.w, c2, xl, xh, yl, yh);
}

// block_keeps for a rectangle of kW x kH pixels whose top-left pixel is
// (x0, y0), y0 already offset: the same corner test at its own corners, so
// exact for the same reason. Pixels of the rectangle past the target's edge
// only make it keep more.
template <int kW, int kH>
__device__ __forceinline__ bool rect_keeps(const float4& q0, const float4& q1,
                                           float c2, int x0, int y0) {
  const float xl = static_cast<float>(x0) + 0.5f;
  const float xh = static_cast<float>(x0 + kW - 1) + 0.5f;
  const float yl = static_cast<float>(y0) + 0.5f;
  const float yh = static_cast<float>(y0 + kH - 1) + 0.5f;
  return corner_ok(q0.x, q0.y, q0.z, xl, xh, yl, yh) &&
         corner_ok(q0.w, q1.x, q1.y, xl, xh, yl, yh) &&
         corner_ok(q1.z, q1.w, c2, xl, xh, yl, yh);
}

// Local (x, y), within its band of 4 * kPix rows x 128 columns, of pixel k
// of thread o, when each thread holds kPix pixels of one column (kPix in
// {2, 4, 8}). Each group of 64 / kPix lanes owns one 8x8 block: lane l of
// the group holds column l % 8, rows (l / 8) * kPix + k, so 8 neighbouring
// lanes store 32 contiguous bytes. A warp's kPix / 2 blocks sit 2 across
// (g % 2) and 2 down (g / 2); the warps tile the band row by row.
template <int kPix>
__device__ __forceinline__ void band_pixel(int o, int k, int* lx, int* ly) {
  static_assert(kPix == 2 || kPix == 4 || kPix == 8, "kPix in {2, 4, 8}");
  constexpr int kGroups = kPix / 2;
  constexpr int kGroupLanes = 32 / kGroups;
  constexpr int kWarpW = kGroups >= 2 ? 16 : 8;
  constexpr int kWarpH = kGroups >= 4 ? 16 : 8;
  constexpr int kAcross = kTileW / kWarpW;
  const int w = o >> 5, lane = o & 31;
  const int g = lane / kGroupLanes, l = lane % kGroupLanes;
  *lx = (w % kAcross) * kWarpW + (g & 1) * 8 + (l & 7);
  *ly = (w / kAcross) * kWarpH + (g >> 1) * 8 + (l >> 3) * kPix + k;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// One thread: expect `bytes` on `bar`, then bulk-copy them global -> shared.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Walks setup rows [pb, pe) through the two-slot ring `ring` (kChunk rows a
// slot, completing on bar[0] / bar[1]): thread 0 bulk-copies chunk c + 1
// while the block visits chunk c, so loads overlap the walk. Every thread
// of the block calls it; visit(rows, r0, cnt) sees rows [r0, r0 + cnt)
// staged at rows[0, 4 * cnt), in order.
template <typename Visit>
__device__ __forceinline__ void ring_walk(const float4* __restrict__ setup,
                                          int pb, int pe,
                                          float4 (*ring)[kChunk * 4],
                                          uint64_t* bar, Visit&& visit) {
  const int nchunks = (pe - pb + kChunk - 1) / kChunk;
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (nchunks > 0) {
      const int cnt = min(kChunk, pe - pb);
      bulk_load(ring[0], setup + static_cast<long long>(pb) * 4, cnt * 64u, &bar[0]);
    }
  }
  __syncthreads();
  for (int c = 0; c < nchunks; ++c) {
    const int slot = c & 1;
    const int r0 = pb + c * kChunk;
    const int cnt = min(kChunk, pe - r0);
    mbar_wait(&bar[slot], (c >> 1) & 1);
    __syncthreads();  // every warp is done with chunk c - 1 (the other slot)
    if (threadIdx.x == 0 && c + 1 < nchunks) {
      const int r1 = r0 + kChunk;
      bulk_load(ring[slot ^ 1], setup + static_cast<long long>(r1) * 4,
                min(kChunk, pe - r1) * 64u, &bar[slot ^ 1]);
    }
    visit(static_cast<const float4*>(ring[slot]), r0, cnt);
  }
}

// The rows [begin, end) of tile t, clamped to [0, num_rows), and the part
// [*pb, *pe) of them that block `rank` of `parts` walks (empty when rank >=
// parts). Returns the number of parts: ceil(rows / min_part_rows), at
// least 1 and at most `cluster`.
__device__ __forceinline__ int tile_part(const int* tile_start,
                                         const int* tile_count, int t,
                                         int num_rows, int cluster,
                                         int min_part_rows, int rank, int* pb,
                                         int* pe) {
  const long long start = tile_start[t];
  const long long stop = start + static_cast<long long>(tile_count[t]);
  const int begin = static_cast<int>(start < 0 ? 0 : start);
  const int end = static_cast<int>(stop > num_rows ? num_rows : stop);
  const int n = end > begin ? end - begin : 0;
  int parts = (n + min_part_rows - 1) / min_part_rows;
  parts = parts < 1 ? 1 : (parts > cluster ? cluster : parts);
  *pb = *pe = begin;
  if (rank < parts) {
    *pb = begin + static_cast<int>(static_cast<long long>(n) * rank / parts);
    *pe = begin + static_cast<int>(static_cast<long long>(n) * (rank + 1) / parts);
  }
  return parts;
}

}  // namespace
