// Binned k-buffer rasterizer: the alpha-clip and alpha-blend visibility
// passes on Hopper (sm_90a).
//
// Replaces the TPU kernel superconductor_tpu/ops/raster_pallas.py
// _kbuffer_kernel (:314), launched by kbuffer_pallas_sorted (:456).
//
// What it computes, per 32x128 screen tile t: walk the tile's slice
// [tile_start[t], tile_start[t] + tile_count[t]) of tile-sorted setup rows
// IN ORDER, with the edge / fill-rule / z math of raster.cu. A fragment is
// accepted when it is inside, sum(e*w) > 0, z in [0, 1] and strictly
// nearer than the pixel's opaque depth floor (z > floor under reverse-z).
// Every accepted fragment adds one to the pixel's `layers` count and is
// inserted into the pixel's K slots (slot 0 nearest): its rank is the
// number of occupied slots strictly nearer, the slots from the rank on
// shift back by one, and the last falls off. So an equal-z fragment goes
// ahead of those already held, and each pixel ends with the top K of its
// accepted fragments by (nearness, sorted position), both descending.
// Outputs: K pair planes (SORTED positions, -1 = empty), K depth planes
// when kWantDepth (the clip resolve reads them; the blend pass does not),
// and `layers`, which may exceed K (the host's signal to grow K).
//
// Design: raster.cu's, with the slots in registers. A block of 128 x 4
// threads covers 128 columns by kRows * 4 rows of a tile, kRows pixels of
// one column per thread (4 for K <= 4, 2 for K = 8, so 2K+3 live values
// per pixel stay within the 128 registers a 512-thread block allows), and
// 32 / (4 * kRows) blocks share a tile. Each block stages CHUNK setup rows
// (64 B each) into shared memory cooperatively and every thread walks them
// in order, reading each row as a broadcast. The insertion shift is fully
// unrolled over K, so the slots are registers and the shift is selects.
// Each pixel writes its slots once; ragged edges are masked.
//
// Bounds on this card: like raster.cu, FP32 instruction issue over
// (row, pixel) pairs -- 15 multiply/adds per pair-pixel -- plus, per
// accepted fragment, K compares and 2K selects. Every tile's rows are read
// from L2 once per block that covers it. The simple correct form: no TMA
// staging, no persistent grid, no balancing of heavy tiles.
//
// Bit-exactness with the reference: __fmul_rn / __fadd_rn in its order and
// an IEEE divide (__fdiv_rn); build with -fmad=false, never fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kThreadsY = 4;
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

template <bool kReverseZ>
__device__ __forceinline__ bool nearer(float a, float b) {
  return kReverseZ ? (a > b) : (a < b);
}

// pixels per thread down a column for K slots
template <int K>
constexpr int kRowsFor = K >= 8 ? 2 : 4;

template <int K, bool kReverseZ, bool kWantDepth>
__global__ void __launch_bounds__(kTileW * kThreadsY)
kbuffer_sorted_kernel(const float4* __restrict__ setup, int num_rows,
                      const int* __restrict__ tile_start,
                      const int* __restrict__ tile_count, int ntx, int height,
                      int width, int y_offset,
                      const float* __restrict__ floor_depth,
                      float* __restrict__ depth_out,
                      int* __restrict__ pair_out,
                      int* __restrict__ layers_out) {
  constexpr int kRows = kRowsFor<K>;
  constexpr int kBlockRows = kThreadsY * kRows;
  constexpr int kSplit = kTileH / kBlockRows;  // blocks per tile
  __shared__ float4 rows[kChunk * 4];

  const int tile_y = blockIdx.y / kSplit;
  const int t = tile_y * ntx + blockIdx.x;
  const long long start = tile_start[t];
  const long long stop = start + static_cast<long long>(tile_count[t]);
  const int begin = static_cast<int>(start < 0 ? 0 : start);
  const int end = static_cast<int>(stop > num_rows ? num_rows : stop);

  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y0 = tile_y * kTileH + (blockIdx.y % kSplit) * kBlockRows +
                 threadIdx.y * kRows;
  const float px = static_cast<float>(x) + 0.5f;
  const float far_depth = kReverseZ ? 0.0f : 1.0f;

  float py[kRows];
  float floor_z[kRows];
  int layers[kRows];
  float depth[kRows][K];
  int pos[kRows][K];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = y0 + r;
    py[r] = static_cast<float>(y + y_offset) + 0.5f;
    floor_z[r] = far_depth;
    if (floor_depth != nullptr && x < width && y < height) {
      floor_z[r] = floor_depth[static_cast<long long>(y) * width + x];
    }
    layers[r] = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      depth[r][i] = far_depth;
      pos[r][i] = -1;
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
    for (int s = 0; s < n; ++s) {
      // row layout: q0 = a0 b0 c0 a1 | q1 = b1 c1 a2 b2 |
      //             q2 = c2 zc0 zc1 zc2 | q3 = wc0 wc1 wc2 flags
      const float4 q0 = rows[s * 4 + 0];
      const float4 q1 = rows[s * 4 + 1];
      const float4 q2 = rows[s * 4 + 2];
      const float4 q3 = rows[s * 4 + 3];
      const bool t0 = tie_bit(q0.x, q0.y);
      const bool t1 = tie_bit(q0.w, q1.x);
      const bool t2 = tie_bit(q1.z, q1.w);
      const int sorted_pos = base + s;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float e0 = edge(q0.x, q0.y, q0.z, px, py[r]);
        const float e1 = edge(q0.w, q1.x, q1.y, px, py[r]);
        const float e2 = edge(q1.z, q1.w, q2.x, px, py[r]);
        if (!(edge_ok(e0, t0) && edge_ok(e1, t1) && edge_ok(e2, t2))) continue;
        const float wsum = dot3(e0, e1, e2, q3.x, q3.y, q3.z);
        if (!(wsum > 0.0f)) continue;
        const float zsum = dot3(e0, e1, e2, q2.y, q2.z, q2.w);
        const float z = __fdiv_rn(zsum, wsum);
        if (!(z >= 0.0f && z <= 1.0f && nearer<kReverseZ>(z, floor_z[r]))) continue;
        layers[r] += 1;
        int rank = 0;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          rank += (pos[r][i] >= 0 && nearer<kReverseZ>(depth[r][i], z)) ? 1 : 0;
        }
        // shift the slots behind the rank back by one (the last falls
        // off), then write the new fragment at the rank; rank == K drops it
#pragma unroll
        for (int i = K - 1; i > 0; --i) {
          if (i > rank) {
            depth[r][i] = depth[r][i - 1];
            pos[r][i] = pos[r][i - 1];
          }
        }
#pragma unroll
        for (int i = 0; i < K; ++i) {
          if (i == rank) {
            depth[r][i] = z;
            pos[r][i] = sorted_pos;
          }
        }
      }
    }
  }

  if (x < width) {
    const long long plane = static_cast<long long>(height) * width;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int y = y0 + r;
      if (y < height) {
        const long long at = static_cast<long long>(y) * width + x;
        layers_out[at] = layers[r];
#pragma unroll
        for (int i = 0; i < K; ++i) {
          pair_out[i * plane + at] = pos[r][i];
          if (kWantDepth) depth_out[i * plane + at] = depth[r][i];
        }
      }
    }
  }
}

template <int K, bool kReverseZ, bool kWantDepth>
void launch(const void* setup, int num_rows, const void* tile_start,
            const void* tile_count, int ntx, int nty, int height, int width,
            int y_offset, const void* floor_depth, void* depth_out,
            void* pair_out, void* layers_out, cudaStream_t stream) {
  constexpr int kSplit = kTileH / (kThreadsY * kRowsFor<K>);
  const dim3 grid(ntx, nty * kSplit);
  const dim3 block(kTileW, kThreadsY);
  kbuffer_sorted_kernel<K, kReverseZ, kWantDepth><<<grid, block, 0, stream>>>(
      static_cast<const float4*>(setup), num_rows,
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      ntx, height, width, y_offset, static_cast<const float*>(floor_depth),
      static_cast<float*>(depth_out), static_cast<int*>(pair_out),
      static_cast<int*>(layers_out));
}

template <int K>
void dispatch(bool reverse_z, const void* setup, int num_rows,
              const void* tile_start, const void* tile_count, int ntx, int nty,
              int height, int width, int y_offset, const void* floor_depth,
              void* depth_out, void* pair_out, void* layers_out,
              cudaStream_t s) {
  const bool want_depth = depth_out != nullptr;
  if (reverse_z && want_depth) {
    launch<K, true, true>(setup, num_rows, tile_start, tile_count, ntx, nty,
                          height, width, y_offset, floor_depth, depth_out,
                          pair_out, layers_out, s);
  } else if (reverse_z) {
    launch<K, true, false>(setup, num_rows, tile_start, tile_count, ntx, nty,
                           height, width, y_offset, floor_depth, depth_out,
                           pair_out, layers_out, s);
  } else if (want_depth) {
    launch<K, false, true>(setup, num_rows, tile_start, tile_count, ntx, nty,
                           height, width, y_offset, floor_depth, depth_out,
                           pair_out, layers_out, s);
  } else {
    launch<K, false, false>(setup, num_rows, tile_start, tile_count, ntx, nty,
                            height, width, y_offset, floor_depth, depth_out,
                            pair_out, layers_out, s);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Tile shape is fixed at 32x128
// and k must be 1, 2, 4 or 8; the caller checks shapes, dtypes, devices and
// alignment. floor_depth (H, W) may be null (every floor at far); depth_out
// (K, H, W) may be null (no depth planes). Launches on `stream`, allocates
// nothing, does not synchronise. Returns the cudaGetLastError() code of the
// launch (0 = launched), or cudaErrorInvalidValue for another k.
extern "C" int sc_kbuffer_sorted(const void* setup, int num_rows,
                                 const void* tile_start,
                                 const void* tile_count, int ntx, int nty,
                                 int height, int width, int y_offset, int k,
                                 int reverse_z, const void* floor_depth,
                                 void* depth_out, void* pair_out,
                                 void* layers_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rz = reverse_z != 0;
  switch (k) {
    case 1:
      dispatch<1>(rz, setup, num_rows, tile_start, tile_count, ntx, nty,
                  height, width, y_offset, floor_depth, depth_out, pair_out,
                  layers_out, s);
      break;
    case 2:
      dispatch<2>(rz, setup, num_rows, tile_start, tile_count, ntx, nty,
                  height, width, y_offset, floor_depth, depth_out, pair_out,
                  layers_out, s);
      break;
    case 4:
      dispatch<4>(rz, setup, num_rows, tile_start, tile_count, ntx, nty,
                  height, width, y_offset, floor_depth, depth_out, pair_out,
                  layers_out, s);
      break;
    case 8:
      dispatch<8>(rz, setup, num_rows, tile_start, tile_count, ntx, nty,
                  height, width, y_offset, floor_depth, depth_out, pair_out,
                  layers_out, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
