// Binned tile rasterizer: the opaque visibility pass on Hopper (sm_90a).
//
// Replaces the TPU kernel superconductor_tpu/ops/raster_pallas.py
// _raster_kernel (:80), launched by rasterize_pallas_sorted (:194).
//
// What it computes, per 32x128 screen tile t: walk the tile's slice
// [tile_start[t], tile_start[t] + tile_count[t]) of tile-sorted setup rows
// IN ORDER. Each row is 16 f32: edge coefficients (a, b, c) x 3, the clip
// z and w of the three corners, and a flags word this kernel ignores. At
// every pixel centre (x + .5, y + .5 + y_offset):
//   e_i = a_i*px + b_i*py + c_i, inside iff every e_i > 0, or e_i == 0 when
//   (a_i, b_i) is lexicographically positive (the fill rule that makes
//   shared edges watertight); then sum(e*w) > 0, z = sum(e*zc) / sum(e*w)
//   in [0, 1], and a strict depth test (z > depth under reverse-z). The
//   pixel keeps its depth and the winner's SORTED position (-1 = miss).
//
// Design: one block per tile, 128 x 8 threads; thread (x, y) owns the four
// pixels of column x in rows 4y..4y+3, so a warp touches 32 neighbouring
// pixels of a row. The block stages CHUNK setup rows (64 B each) into
// shared memory cooperatively; every thread then walks them in order,
// reading each row as a broadcast, and keeps (depth, pos) in registers.
// Each pixel is written once; the ragged right and bottom edges are masked.
//
// Bounds on this card: every setup row is read once from L2/HBM per tile
// and once per thread from shared memory (broadcast), then costs FP32
// instructions -- 3 edge functions plus the z and w sums, 15 multiply/adds per
// pair-pixel, and a divide for candidates. This is the simple correct
// form: no TMA staging, no persistent grid, no balancing of heavy tiles
// (wgmma does not apply); those are later work.
//
// Bit-exactness with the reference: products and sums are written with
// __fmul_rn / __fadd_rn in the reference's order ((a*px + b*py) + c and
// (e0*zc0 + e1*zc1) + e2*zc2) and the divide is IEEE (__fdiv_rn), so no
// FMA contraction moves an edge value by an ulp where the e == 0 rule
// decides a pixel. Build with -fmad=false as well, never fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kThreadsY = 8;
constexpr int kRowsPerThread = kTileH / kThreadsY;  // 4
constexpr int kChunk = 256;  // setup rows staged per round (16 KB)

__device__ __forceinline__ bool tie_bit(float a, float b) {
  return (a > 0.0f) || (a == 0.0f && b > 0.0f);
}

__device__ __forceinline__ bool edge_ok(float e, bool tie) {
  return (e > 0.0f) || (e == 0.0f && tie);
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

template <bool kReverseZ, bool kHasInit>
__global__ void __launch_bounds__(kTileW * kThreadsY)
raster_sorted_kernel(const float4* __restrict__ setup, int num_rows,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, int ntx, int height,
                     int width, int y_offset,
                     const float* __restrict__ init_depth,
                     const int* __restrict__ init_pair,
                     float* __restrict__ depth_out,
                     int* __restrict__ pair_out) {
  __shared__ float4 rows[kChunk * 4];

  const int t = blockIdx.y * ntx + blockIdx.x;
  const long long start = tile_start[t];
  const long long stop = start + static_cast<long long>(tile_count[t]);
  const int begin = static_cast<int>(start < 0 ? 0 : start);
  const int end = static_cast<int>(stop > num_rows ? num_rows : stop);

  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y0 = blockIdx.y * kTileH + threadIdx.y * kRowsPerThread;
  const float px = static_cast<float>(x) + 0.5f;
  const float far_depth = kReverseZ ? 0.0f : 1.0f;

  float py[kRowsPerThread];
  float depth[kRowsPerThread];
  int pos[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int y = y0 + k;
    py[k] = static_cast<float>(y + y_offset) + 0.5f;
    depth[k] = far_depth;
    pos[k] = -1;
    if (kHasInit && x < width && y < height) {
      depth[k] = init_depth[static_cast<long long>(y) * width + x];
      pos[k] = init_pair[static_cast<long long>(y) * width + x];
    }
  }

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int nthreads = kTileW * kThreadsY;
  for (int base = begin; base < end; base += kChunk) {
    const int n = min(kChunk, end - base);
    __syncthreads();  // the previous chunk has been consumed
    for (int i = tid; i < n * 4; i += nthreads) {
      rows[i] = setup[static_cast<long long>(base) * 4 + i];
    }
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      // row layout: q0 = a0 b0 c0 a1 | q1 = b1 c1 a2 b2 |
      //             q2 = c2 zc0 zc1 zc2 | q3 = wc0 wc1 wc2 flags
      const float4 q0 = rows[r * 4 + 0];
      const float4 q1 = rows[r * 4 + 1];
      const float4 q2 = rows[r * 4 + 2];
      const float4 q3 = rows[r * 4 + 3];
      const bool t0 = tie_bit(q0.x, q0.y);
      const bool t1 = tie_bit(q0.w, q1.x);
      const bool t2 = tie_bit(q1.z, q1.w);
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const float e0 = edge(q0.x, q0.y, q0.z, px, py[k]);
        const float e1 = edge(q0.w, q1.x, q1.y, px, py[k]);
        const float e2 = edge(q1.z, q1.w, q2.x, px, py[k]);
        if (!(edge_ok(e0, t0) && edge_ok(e1, t1) && edge_ok(e2, t2))) continue;
        const float wsum = dot3(e0, e1, e2, q3.x, q3.y, q3.z);
        if (!(wsum > 0.0f)) continue;
        const float zsum = dot3(e0, e1, e2, q2.y, q2.z, q2.w);
        const float z = __fdiv_rn(zsum, wsum);
        const bool nearer = kReverseZ ? (z > depth[k]) : (z < depth[k]);
        if (z >= 0.0f && z <= 1.0f && nearer) {
          depth[k] = z;
          pos[k] = base + r;
        }
      }
    }
  }

  if (x < width) {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int y = y0 + k;
      if (y < height) {
        depth_out[static_cast<long long>(y) * width + x] = depth[k];
        pair_out[static_cast<long long>(y) * width + x] = pos[k];
      }
    }
  }
}

template <bool kReverseZ, bool kHasInit>
void launch(const void* setup, int num_rows, const void* tile_start,
            const void* tile_count, int ntx, int nty, int height, int width,
            int y_offset, const void* init_depth, const void* init_pair,
            void* depth_out, void* pair_out, cudaStream_t stream) {
  const dim3 grid(ntx, nty);
  const dim3 block(kTileW, kThreadsY);
  raster_sorted_kernel<kReverseZ, kHasInit><<<grid, block, 0, stream>>>(
      static_cast<const float4*>(setup), num_rows,
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      ntx, height, width, y_offset, static_cast<const float*>(init_depth),
      static_cast<const int*>(init_pair), static_cast<float*>(depth_out),
      static_cast<int*>(pair_out));
}

}  // namespace

// Plain C entry point (loaded with ctypes). Tile shape is fixed at 32x128;
// the caller checks shapes, dtypes, devices and alignment. Launches on
// `stream`, allocates nothing, does not synchronise. Returns the
// cudaGetLastError() code of the launch (0 = launched).
extern "C" int sc_raster_sorted(const void* setup, int num_rows,
                                const void* tile_start, const void* tile_count,
                                int ntx, int nty, int height, int width,
                                int y_offset, int reverse_z,
                                const void* init_depth, const void* init_pair,
                                void* depth_out, void* pair_out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_init = init_depth != nullptr;
  if (reverse_z) {
    if (has_init) {
      launch<true, true>(setup, num_rows, tile_start, tile_count, ntx, nty,
                         height, width, y_offset, init_depth, init_pair,
                         depth_out, pair_out, s);
    } else {
      launch<true, false>(setup, num_rows, tile_start, tile_count, ntx, nty,
                          height, width, y_offset, init_depth, init_pair,
                          depth_out, pair_out, s);
    }
  } else {
    if (has_init) {
      launch<false, true>(setup, num_rows, tile_start, tile_count, ntx, nty,
                          height, width, y_offset, init_depth, init_pair,
                          depth_out, pair_out, s);
    } else {
      launch<false, false>(setup, num_rows, tile_start, tile_count, ntx, nty,
                           height, width, y_offset, init_depth, init_pair,
                           depth_out, pair_out, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
