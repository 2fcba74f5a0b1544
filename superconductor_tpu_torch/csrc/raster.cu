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
//   pixel keeps its depth and the winner's SORTED position (-1 = miss),
//   starting from `init` or from far.
//
// What bounds it on this card. The work is FP32 issue: every (row, pixel)
// pair costs three edge functions (12 operations) and a few compares,
// whatever the triangle's size, while the bytes (64 B a row, 8 B a pixel)
// are small. The binning leaves the rows very unevenly spread: at 1080p
// most tiles are empty and one tile may hold 5-40x the mean, so a kernel
// with one block per tile runs as long as its heaviest tile walks, on one
// SM, while the rest of the card idles; and a small triangle covers few of
// a tile's pixels, so most (row, pixel) pairs are work that can be skipped. Tensor cores do not apply: a TF32
// or bf16 product moves an edge value off the e == 0 decision the fill
// rule makes, so every product stays an IEEE f32 multiply.
//
// Design:
// * A thread-block cluster of S <= 8 blocks shares a tile (grid x = tile
//   column * S + rank). A tile with more than min_part_rows rows is cut
//   into P = min(S, ceil(rows / min_part_rows)) contiguous parts; block s
//   walks part s from beyond far (-inf under reverse-z, +inf otherwise)
//   and leaves a partial (depth, pos) per pixel in its shared memory.
//   After cluster.sync() every block merges a share of the tile's pixels
//   through distributed shared memory: from init (or far) it takes parts
//   0..P-1 in order under the same strict test. A sequential walk keeps
//   the first of the nearest accepted fragments that beat its start; part
//   by part that is the part's first nearest (its partial), taken when it
//   beats what came before, and a tie keeps the earlier part or init. So
//   the merge is the whole walk bit for bit, for every init, with no
//   atomics, key packing, global scratch or second launch. Tiles of at
//   most min_part_rows rows are walked by rank 0 alone from init; the
//   other ranks exit at once.
// * Exact row rejection per 8x8 block. A warp owns a 16x16 sub-tile, a
//   thread 8 pixels of one column, each group of 8 lanes one 8x8 quarter.
//   For 32 rows at a time, lane i evaluates each edge of row i at each
//   quarter's pixel centre where that edge is largest (px max if a > 0
//   else px min, likewise py with b), rounded as below. fl(a*px) is
//   monotone in px and fl(u + v) in each argument, so that is the largest
//   e any pixel of the quarter computes, and the fill-rule test is
//   monotone in e: a row whose corner value fails an edge is rejected by
//   every pixel of the quarter, and skipping it there changes nothing. A
//   NaN corner value rejects nothing. Four ballots give each group the
//   rows its quarter keeps; the warp loops while any group has one left,
//   each group taking its own next row in order, so a row costs the warp
//   an iteration only where it may cover pixels. A row first runs the
//   fill-rule test on all eight of a thread's pixels without branches (one
//   compare per edge), then the depth work of the pixels inside.
// * Rows are staged by TMA: one thread issues 1-D bulk copies
//   (cp.async.bulk, global -> shared) of the part's contiguous rows into a
//   two-slot ring, each slot completing on an mbarrier, so the load of
//   chunk c + 1 overlaps the walk of chunk c.
// * 512-thread blocks, at most 64 registers a thread, 40 KB of static
//   shared memory (32 KB partials + 8 KB ring): two blocks fit on an SM.
// * The edge arithmetic, the 8x8 rejection, the thread-to-pixel map, the
//   split into parts and the TMA ring live in raster_common.cuh, shared
//   with kbuffer.cu.
//
// What still bounds it: a group walks its kept rows one after another, each
// a chain of dependent FP32 operations (and an IEEE divide where a pixel is
// inside) with only 32 warps on an SM, so the walk is bound by latency more
// than by issue; and every tile launches S blocks, most of them on empty
// tiles, so launching grows with S (the wrapper's default S weighs the two).
//
// Bit-exactness with the reference: products and sums are written with
// __fmul_rn / __fadd_rn in the reference's order ((a*px + b*py) + c and
// (e0*zc0 + e1*zc1) + e2*zc2) and the divide is IEEE (__fdiv_rn), so no
// FMA contraction moves an edge value by an ulp where the e == 0 rule
// decides a pixel. Build with -fmad=false as well, never fast-math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "raster_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPix = 8;  // pixels a thread holds (one column)
constexpr int kTilePix = kTileH * kTileW;
static_assert(kThreads * kPix == kTilePix, "a block holds the whole tile");

template <bool kReverseZ, bool kHasInit>
__global__ void __launch_bounds__(kThreads, 2)
raster_sorted_kernel(const float4* __restrict__ setup, int num_rows,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count, int ntx, int height,
                     int width, int y_offset, int min_part_rows,
                     const float* __restrict__ init_depth,
                     const int* __restrict__ init_pair,
                     float* __restrict__ depth_out,
                     int* __restrict__ pair_out) {
  __shared__ __align__(128) float4 ring[2][kChunk * 4];
  __shared__ float part_depth[kTilePix];
  __shared__ int part_pos[kTilePix];
  __shared__ __align__(8) uint64_t bar[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tx = blockIdx.x / S;
  const int ty = blockIdx.y;
  const int t = ty * ntx + tx;

  // this block's part [pb, pe) of the tile's rows
  int pb, pe;
  const int parts = tile_part(tile_start, tile_count, t, num_rows, S,
                              min_part_rows, rank, &pb, &pe);
  if (parts == 1 && rank != 0) return;  // uniform over the cluster

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  int lx, ly0;
  band_pixel<kPix>(tid, 0, &lx, &ly0);
  const int x = tx * kTileW + lx;
  const int y0 = ty * kTileH + ly0;
  const float px = static_cast<float>(x) + 0.5f;
  // y + k + y_offset + .5 for k < 8, exact in f32 (|y| < 2^22)
  const float py0 = static_cast<float>(y0 + y_offset) + 0.5f;
  const float far_depth = kReverseZ ? 0.0f : 1.0f;
  // -inf under reverse-z, +inf otherwise: every accepted z beats it
  const float beyond_far = __uint_as_float(kReverseZ ? 0xff800000u : 0x7f800000u);
  // the 8x8 quarter of the warp's 16x16 sub-tile that this lane's group of
  // 8 holds
  const int quarter = lane >> 3;

  float depth[kPix];
  int pos[kPix];
  if (parts == 1) {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      depth[k] = far_depth;
      pos[k] = -1;
      if (kHasInit && x < width && y0 + k < height) {
        const long long i = static_cast<long long>(y0 + k) * width + x;
        depth[k] = init_depth[i];
        pos[k] = init_pair[i];
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      depth[k] = beyond_far;
      pos[k] = -1;
    }
  }

  ring_walk(setup, pb, pe, ring, bar, [&](const float4* rows, int r0, int cnt) {
    for (int g = 0; g < cnt; g += 32) {
      // lane i tests row g + i against each 8x8 quarter of the warp's
      // sub-tile; each group of 8 lanes (one quarter) then walks, in
      // order, the rows its quarter keeps
      bool keep[4] = {false, false, false, false};
      if (g + lane < cnt) {
        const float4 q0 = rows[(g + lane) * 4 + 0];
        const float4 q1 = rows[(g + lane) * 4 + 1];
        const float c2 = rows[(g + lane) * 4 + 2].x;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          int bx, by;
          band_pixel<kPix>(warp * 32 + q * 8, 0, &bx, &by);
          keep[q] = block_keeps(q0, q1, c2, tx * kTileW + bx,
                                ty * kTileH + by + y_offset);
        }
      }
      unsigned mine = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned m = __ballot_sync(0xffffffffu, keep[q]);
        if (q == quarter) mine = m;
      }
      while (__any_sync(0xffffffffu, mine != 0u)) {
        const bool active = mine != 0u;
        const int r = g + (active ? __ffs(mine) - 1 : 0);
        mine &= mine - 1u;
        const float4 q0 = rows[r * 4 + 0];
        const float4 q1 = rows[r * 4 + 1];
        const float4 q2 = rows[r * 4 + 2];
        const float th0 = fill_threshold(q0.x, q0.y);
        const float th1 = fill_threshold(q0.w, q1.x);
        const float th2 = fill_threshold(q1.z, q1.w);
        const float ax0 = __fmul_rn(q0.x, px);
        const float ax1 = __fmul_rn(q0.w, px);
        const float ax2 = __fmul_rn(q1.z, px);
        // all eight fill-rule tests first, without branches, so their
        // chains overlap; then the depth work of the pixels inside
        unsigned hit = 0;
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const float py = __fadd_rn(py0, static_cast<float>(k));
          const float e0 = __fadd_rn(__fadd_rn(ax0, __fmul_rn(q0.y, py)), q0.z);
          const float e1 = __fadd_rn(__fadd_rn(ax1, __fmul_rn(q1.x, py)), q1.y);
          const float e2 = __fadd_rn(__fadd_rn(ax2, __fmul_rn(q1.w, py)), q2.x);
          hit |= (e0 > th0 && e1 > th1 && e2 > th2) ? 1u << k : 0u;
        }
        if (active && hit != 0u) {
          const float4 q3 = rows[r * 4 + 3];
#pragma unroll
          for (int k = 0; k < kPix; ++k) {
            if (!(hit & (1u << k))) continue;
            const float py = __fadd_rn(py0, static_cast<float>(k));
            const float e0 = __fadd_rn(__fadd_rn(ax0, __fmul_rn(q0.y, py)), q0.z);
            const float e1 = __fadd_rn(__fadd_rn(ax1, __fmul_rn(q1.x, py)), q1.y);
            const float e2 = __fadd_rn(__fadd_rn(ax2, __fmul_rn(q1.w, py)), q2.x);
            const float wsum = dot3(e0, e1, e2, q3.x, q3.y, q3.z);
            if (!(wsum > 0.0f)) continue;
            const float zsum = dot3(e0, e1, e2, q2.y, q2.z, q2.w);
            const float z = __fdiv_rn(zsum, wsum);
            const bool nearer = kReverseZ ? (z > depth[k]) : (z < depth[k]);
            if (z >= 0.0f && z <= 1.0f && nearer) {
              depth[k] = z;
              pos[k] = r0 + r;
            }
          }
        }
      }
    }
  });

  if (parts == 1) {
    if (x < width) {
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (y0 + k < height) {
          const long long i = static_cast<long long>(y0 + k) * width + x;
          depth_out[i] = depth[k];
          pair_out[i] = pos[k];
        }
      }
    }
    return;
  }

  // split tile: partials by slot q = k * kThreads + thread, then the merge
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    part_depth[k * kThreads + tid] = depth[k];
    part_pos[k * kThreads + tid] = pos[k];
  }
  cluster.sync();
  for (int q = rank * kThreads + tid; q < kTilePix; q += S * kThreads) {
    int qx, qy;
    band_pixel<kPix>(q % kThreads, q / kThreads, &qx, &qy);
    const int gx = tx * kTileW + qx;
    const int gy = ty * kTileH + qy;
    if (gx >= width || gy >= height) continue;
    const long long i = static_cast<long long>(gy) * width + gx;
    float d = kHasInit ? init_depth[i] : far_depth;
    int p = kHasInit ? init_pair[i] : -1;
    for (int s = 0; s < parts; ++s) {
      const float ds = cluster.map_shared_rank(part_depth, s)[q];
      if (kReverseZ ? (ds > d) : (ds < d)) {
        d = ds;
        p = cluster.map_shared_rank(part_pos, s)[q];
      }
    }
    depth_out[i] = d;
    pair_out[i] = p;
  }
  cluster.sync();  // no block leaves while another still reads its partials
}

template <bool kReverseZ, bool kHasInit>
cudaError_t launch(const void* setup, int num_rows, const void* tile_start,
                   const void* tile_count, int ntx, int nty, int height,
                   int width, int y_offset, int cluster, int min_part_rows,
                   const void* init_depth, const void* init_pair,
                   void* depth_out, void* pair_out, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ntx * cluster, nty, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, raster_sorted_kernel<kReverseZ, kHasInit>,
      static_cast<const float4*>(setup), num_rows,
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      ntx, height, width, y_offset, min_part_rows,
      static_cast<const float*>(init_depth), static_cast<const int*>(init_pair),
      static_cast<float*>(depth_out), static_cast<int*>(pair_out));
}

}  // namespace

// Plain C entry point (loaded with ctypes). Tile shape is fixed at 32x128;
// `cluster` (1..8) blocks share a tile, and a tile is split only into parts
// of more than `min_part_rows` (>= 1) rows. The caller checks shapes,
// dtypes, devices and 16-byte alignment of `setup`. Launches on `stream`,
// allocates nothing, does not synchronise. Returns the launch's
// cudaError_t code (0 = launched).
extern "C" int sc_raster_sorted(const void* setup, int num_rows,
                                const void* tile_start, const void* tile_count,
                                int ntx, int nty, int height, int width,
                                int y_offset, int reverse_z, int cluster,
                                int min_part_rows, const void* init_depth,
                                const void* init_pair, void* depth_out,
                                void* pair_out, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || min_part_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_init = init_depth != nullptr;
  cudaError_t err;
  if (reverse_z) {
    err = has_init
              ? launch<true, true>(setup, num_rows, tile_start, tile_count, ntx,
                                   nty, height, width, y_offset, cluster,
                                   min_part_rows, init_depth, init_pair,
                                   depth_out, pair_out, s)
              : launch<true, false>(setup, num_rows, tile_start, tile_count, ntx,
                                    nty, height, width, y_offset, cluster,
                                    min_part_rows, init_depth, init_pair,
                                    depth_out, pair_out, s);
  } else {
    err = has_init
              ? launch<false, true>(setup, num_rows, tile_start, tile_count, ntx,
                                    nty, height, width, y_offset, cluster,
                                    min_part_rows, init_depth, init_pair,
                                    depth_out, pair_out, s)
              : launch<false, false>(setup, num_rows, tile_start, tile_count,
                                     ntx, nty, height, width, y_offset, cluster,
                                     min_part_rows, init_depth, init_pair,
                                     depth_out, pair_out, s);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
