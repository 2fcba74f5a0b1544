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
// What bounds it on this card. Bytes set the floor: every pixel writes K
// pair planes, K depth planes (clip) and `layers`, and a pixel of a tile
// holding rows reads its floor -- at most 149 MB at 1080p for K = 8 with
// depth planes, 0.045 ms at 3.35 TB/s --
// while the rows (64 B each) are small. The work is FP32 issue over (row,
// pixel) pairs, plus, per accepted fragment, K compares and 2K selects;
// but the binning leaves the rows very unevenly spread (one clip tile
// holds 2,821 rows, most tiles none), and a tile's rows must be walked in
// order, so a kernel that walks each tile on one SM takes as long as its
// heaviest tile's walk while the card idles; and a small triangle covers
// few of a tile's pixels, so most (row, pixel) pairs can be skipped.
//
// Design:
// * Bands. A block of 512 threads owns a band of 4 * kPix rows of a tile,
//   kPix pixels of one column per thread (kPix = 2 for K >= 8, 4 for
//   K <= 4, so the 2K + 3 live values per pixel fit the 64 registers that
//   two blocks an SM allow; K = 16 runs one block an SM, with 128
//   registers and 140 KB of shared memory). Each group of 64 / kPix lanes
//   owns one 8x8 block (raster_common.cuh band_pixel), and 8 neighbouring
//   lanes store 32 contiguous bytes of a plane.
// * A thread-block cluster of S <= 8 blocks shares a band (grid x = tile
//   column * S + rank). A tile of more than min_part_rows rows is cut into
//   P = min(S, ceil(rows / min_part_rows)) contiguous parts; block s walks
//   part s from empty slots under the same floor and leaves its K slots and
//   count per pixel in its shared memory (dynamic: 2K + 1 words a pixel of
//   the band, 40-80 KB with the ring; sc_kbuffer_smem_bytes). The insert
//   leaves the top K of the accepted fragments under a total order
//   (nearer first, then the later sorted position), so the top K of the
//   union of the parts' lists is the whole walk's, in any merge order, and
//   `layers` is the sum of the parts' counts. After cluster.sync() every
//   block merges a share of the band's pixels through distributed shared
//   memory: part 0's list as it is, then each later part's entries
//   inserted by the same float `nearer` test (-0.0 equals 0.0) and, at an
//   equal depth, the larger sorted position first -- so the result is the
//   whole walk bit for bit, with no atomics, key packing or second launch.
//   Bands of at most min_part_rows rows are walked by rank 0 alone, which
//   writes from registers; the other ranks exit at once (empty tiles too:
//   rank 0 writes far / -1 / 0).
// * Exact row rejection per 8x8 block (raster_common.cuh block_keeps). For
//   32 rows at a time, lane i tests row i against each of its warp's 8x8
//   blocks at the corner where each edge is largest; a ballot gives each
//   group the rows its block keeps, and the warp loops while any group has
//   one left, each group taking its own next row in order. A kept row runs
//   the fill-rule test on the thread's kPix pixels without branches, then
//   the depth work and the insert of the pixels inside.
// * Rows are staged by TMA (raster_common.cuh ring_walk): one thread
//   issues 1-D bulk copies into a two-slot ring, each slot completing on an
//   mbarrier, so the load of chunk c + 1 overlaps the walk of chunk c.
//
// What still bounds it (measured at 1080p on an H100, PERF.md): a group
// walks its kept rows one after another, each a chain of dependent FP32
// operations, an IEEE divide and, when accepted, an unrolled K-slot insert,
// at 2 blocks an SM; the clip setup holds several heavy tiles whose band
// walks together, not the heaviest tile's alone, set the time. Most
// rows the 8x8 test keeps there are thin silhouette slivers that cover no
// pixel of the block. And every band launches S blocks, most of them on
// empty tiles: at S = 1 the empty tiles write their planes near the bytes
// bound, and each step in S adds launch time (the wrapper's S = 2 weighs
// the two).
//
// Other K. A K up to 16 that is not a template runs the next template up
// (the wrapper, ops/raster.py kbuffer_sorted, keeps its first K planes: the
// insert's total order makes the top K a prefix of the top K'). A K above 16
// runs kbuffer_deep_kernel: its slots no longer fit registers or a block's
// shared memory (smem_bytes<32> at kPix = 2 passes the 227 KB a block may
// take), so each pixel keeps its list in the output planes in device
// memory, one thread a pixel, walking its tile's rows in order through the
// same TMA ring. Bytes: every accepted fragment reads up to K slots and
// shifts the ones behind it, through L1 and L2. A simple kernel that is
// right; it has no cluster split or 8x8 rejection.
//
// Bit-exactness with the reference: __fmul_rn / __fadd_rn in its order and
// an IEEE divide (__fdiv_rn); build with -fmad=false, never fast-math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "raster_common.cuh"

namespace cg = cooperative_groups;

namespace {

// pixels a thread holds down one column, for K slots
template <int K>
constexpr int kPixFor = K >= 8 ? 2 : 4;

// resident blocks an SM: two up to K = 8, one at K = 16 (its 2K + 3 live
// values a pixel need more than the 64 registers two blocks leave)
template <int K>
constexpr int kBlocksPerSm = K >= 16 ? 1 : 2;

constexpr int kRingBytes = 2 * kChunk * 64;

// dynamic shared memory of a block: the ring, then K depth and K position
// partials and a count for every pixel of the band
template <int K>
constexpr int smem_bytes() {
  return kRingBytes + kThreads * kPixFor<K> * (2 * K + 1) * 4;
}

template <bool kReverseZ>
__device__ __forceinline__ bool nearer(float a, float b) {
  return kReverseZ ? (a > b) : (a < b);
}

// Inserts (z, p) into slots sorted nearest first: its rank is the number of
// occupied slots ahead of it, the slots from the rank on shift back by one,
// and the last falls off (rank K drops it). A slot is ahead when strictly
// nearer or, with kByPos, at an equal depth with a larger position. The
// walk inserts in increasing position, so there kByPos changes nothing.
template <int K, bool kReverseZ, bool kByPos>
__device__ __forceinline__ void insert(float (&depth)[K], int (&pos)[K],
                                       float z, int p) {
  int rank = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const bool ahead = nearer<kReverseZ>(depth[i], z) ||
                       (kByPos && depth[i] == z && pos[i] > p);
    rank += (pos[i] >= 0 && ahead) ? 1 : 0;
  }
#pragma unroll
  for (int i = K - 1; i > 0; --i) {
    if (i > rank) {
      depth[i] = depth[i - 1];
      pos[i] = pos[i - 1];
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i == rank) {
      depth[i] = z;
      pos[i] = p;
    }
  }
}

template <int K, bool kReverseZ, bool kWantDepth>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<K>)
kbuffer_sorted_kernel(const float4* __restrict__ setup, int num_rows,
                      const int* __restrict__ tile_start,
                      const int* __restrict__ tile_count, int ntx, int height,
                      int width, int y_offset, int min_part_rows,
                      const float* __restrict__ floor_depth,
                      float* __restrict__ depth_out,
                      int* __restrict__ pair_out,
                      int* __restrict__ layers_out) {
  constexpr int kPix = kPixFor<K>;
  constexpr int kBandH = kThreads * kPix / kTileW;  // 4 * kPix rows
  constexpr int kBands = kTileH / kBandH;
  constexpr int kBandPx = kThreads * kPix;
  constexpr int kGroups = kPix / 2;  // 8x8 blocks of a warp
  constexpr int kGroupLanes = 32 / kGroups;

  extern __shared__ __align__(128) unsigned char smem[];
  float4(*ring)[kChunk * 4] = reinterpret_cast<float4(*)[kChunk * 4]>(smem);
  // partials by slot q = k * kThreads + thread: slot i of pixel q at
  // [i * kBandPx + q]
  float* part_depth = reinterpret_cast<float*>(smem + kRingBytes);
  int* part_pos = reinterpret_cast<int*>(part_depth + K * kBandPx);
  int* part_layers = part_pos + K * kBandPx;
  __shared__ __align__(8) uint64_t bar[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tx = blockIdx.x / S;
  const int ty = blockIdx.y / kBands;
  const int band_y = ty * kTileH + (blockIdx.y % kBands) * kBandH;
  const int t = ty * ntx + tx;

  // this block's part [pb, pe) of the tile's rows
  int pb, pe;
  const int parts = tile_part(tile_start, tile_count, t, num_rows, S,
                              min_part_rows, rank, &pb, &pe);
  if (parts == 1 && rank != 0) return;  // uniform over the cluster

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int group = lane / kGroupLanes;
  int lx, ly0;
  band_pixel<kPix>(tid, 0, &lx, &ly0);
  const int x = tx * kTileW + lx;
  const int y0 = band_y + ly0;
  const float px = static_cast<float>(x) + 0.5f;
  // y + k + y_offset + .5 for k < kPix, exact in f32 (|y| < 2^22)
  const float py0 = static_cast<float>(y0 + y_offset) + 0.5f;
  const float far_depth = kReverseZ ? 0.0f : 1.0f;

  float floor_z[kPix];
  int layers[kPix];
  float depth[kPix][K];
  int pos[kPix][K];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    floor_z[k] = far_depth;  // read only where there are rows to test
    if (floor_depth != nullptr && pe > pb && x < width && y0 + k < height) {
      floor_z[k] = floor_depth[static_cast<long long>(y0 + k) * width + x];
    }
    layers[k] = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      depth[k][i] = far_depth;
      pos[k][i] = -1;
    }
  }

  ring_walk(setup, pb, pe, ring, bar, [&](const float4* rows, int r0, int cnt) {
    for (int g = 0; g < cnt; g += 32) {
      // lane i tests row g + i against each 8x8 block of the warp; each
      // group then walks, in order, the rows its block keeps
      bool keep[kGroups];
#pragma unroll
      for (int q = 0; q < kGroups; ++q) keep[q] = false;
      if (g + lane < cnt) {
        const float4 q0 = rows[(g + lane) * 4 + 0];
        const float4 q1 = rows[(g + lane) * 4 + 1];
        const float c2 = rows[(g + lane) * 4 + 2].x;
#pragma unroll
        for (int q = 0; q < kGroups; ++q) {
          int bx, by;
          band_pixel<kPix>(warp * 32 + q * kGroupLanes, 0, &bx, &by);
          keep[q] = block_keeps(q0, q1, c2, tx * kTileW + bx,
                                band_y + by + y_offset);
        }
      }
      unsigned mine = 0;
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        const unsigned m = __ballot_sync(0xffffffffu, keep[q]);
        if (q == group) mine = m;
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
        // the fill-rule tests of every pixel first, without branches, so
        // their chains overlap; then the depth work of the pixels inside
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
            if (!(z >= 0.0f && z <= 1.0f && nearer<kReverseZ>(z, floor_z[k]))) continue;
            layers[k] += 1;
            insert<K, kReverseZ, false>(depth[k], pos[k], z, r0 + r);
          }
        }
      }
    }
  });

  const long long plane = static_cast<long long>(height) * width;
  if (parts == 1) {
    if (x < width) {
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (y0 + k < height) {
          const long long at = static_cast<long long>(y0 + k) * width + x;
          layers_out[at] = layers[k];
#pragma unroll
          for (int i = 0; i < K; ++i) {
            pair_out[i * plane + at] = pos[k][i];
            if (kWantDepth) depth_out[i * plane + at] = depth[k][i];
          }
        }
      }
    }
    return;
  }

  // split band: partials, then the merge of a share of the band's pixels
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int q = k * kThreads + tid;
    part_layers[q] = layers[k];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      part_depth[i * kBandPx + q] = depth[k][i];
      part_pos[i * kBandPx + q] = pos[k][i];
    }
  }
  cluster.sync();
  for (int q = rank * kThreads + tid; q < kBandPx; q += S * kThreads) {
    int qx, qy;
    band_pixel<kPix>(q % kThreads, q / kThreads, &qx, &qy);
    const int gx = tx * kTileW + qx;
    const int gy = band_y + qy;
    if (gx >= width || gy >= height) continue;
    // part 0's list as it is (sorted already), then the later parts'
    const float* d0 = cluster.map_shared_rank(part_depth, 0);
    const int* p0 = cluster.map_shared_rank(part_pos, 0);
    float d[K];
    int p[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      d[j] = d0[j * kBandPx + q];
      p[j] = p0[j * kBandPx + q];
    }
    int count = cluster.map_shared_rank(part_layers, 0)[q];
    for (int s = 1; s < parts; ++s) {
      const float* sd = cluster.map_shared_rank(part_depth, s);
      const int* sp = cluster.map_shared_rank(part_pos, s);
      count += cluster.map_shared_rank(part_layers, s)[q];
      float zs[K];
      int ps[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        zs[j] = sd[j * kBandPx + q];
        ps[j] = sp[j * kBandPx + q];
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (ps[j] >= 0) insert<K, kReverseZ, true>(d, p, zs[j], ps[j]);
      }
    }
    const long long at = static_cast<long long>(gy) * width + gx;
    layers_out[at] = count;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      pair_out[i * plane + at] = p[i];
      if (kWantDepth) depth_out[i * plane + at] = d[i];
    }
  }
  cluster.sync();  // no block leaves while another still reads its partials
}

template <int K, bool kReverseZ, bool kWantDepth>
cudaError_t launch(const void* setup, int num_rows, const void* tile_start,
                   const void* tile_count, int ntx, int nty, int height,
                   int width, int y_offset, int cluster, int min_part_rows,
                   const void* floor_depth, void* depth_out, void* pair_out,
                   void* layers_out, cudaStream_t stream) {
  constexpr int kBands = kTileH / (kThreads * kPixFor<K> / kTileW);
  constexpr int smem = smem_bytes<K>();
  auto kernel = kbuffer_sorted_kernel<K, kReverseZ, kWantDepth>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ntx * cluster, nty * kBands, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float4*>(setup), num_rows,
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      ntx, height, width, y_offset, min_part_rows,
      static_cast<const float*>(floor_depth), static_cast<float*>(depth_out),
      static_cast<int*>(pair_out), static_cast<int*>(layers_out));
}

template <int K>
cudaError_t dispatch(bool reverse_z, const void* setup, int num_rows,
                     const void* tile_start, const void* tile_count, int ntx,
                     int nty, int height, int width, int y_offset, int cluster,
                     int min_part_rows, const void* floor_depth,
                     void* depth_out, void* pair_out, void* layers_out,
                     cudaStream_t s) {
  const bool want_depth = depth_out != nullptr;
  if (reverse_z && want_depth) {
    return launch<K, true, true>(setup, num_rows, tile_start, tile_count, ntx,
                                 nty, height, width, y_offset, cluster,
                                 min_part_rows, floor_depth, depth_out,
                                 pair_out, layers_out, s);
  } else if (reverse_z) {
    return launch<K, true, false>(setup, num_rows, tile_start, tile_count, ntx,
                                  nty, height, width, y_offset, cluster,
                                  min_part_rows, floor_depth, depth_out,
                                  pair_out, layers_out, s);
  } else if (want_depth) {
    return launch<K, false, true>(setup, num_rows, tile_start, tile_count,
                                  ntx, nty, height, width, y_offset, cluster,
                                  min_part_rows, floor_depth, depth_out,
                                  pair_out, layers_out, s);
  }
  return launch<K, false, false>(setup, num_rows, tile_start, tile_count, ntx,
                                 nty, height, width, y_offset, cluster,
                                 min_part_rows, floor_depth, depth_out,
                                 pair_out, layers_out, s);
}

// K > 16: 512 threads own 4 rows x 128 columns of a tile, one pixel each.
// A pixel's occupied slots are its first min(layers, K) slots of the depth
// and pair planes (depth_out is never null here: the wrapper gives scratch
// planes when the caller wants none), sorted nearest first, so the slots
// strictly nearer than a new fragment are a prefix and its rank is their
// count -- the same insert as the template kernel's, slot by slot.
template <bool kReverseZ>
__global__ void __launch_bounds__(kThreads)
kbuffer_deep_kernel(const float4* __restrict__ setup, int num_rows,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ tile_count, int ntx, int height,
                    int width, int y_offset, int k,
                    const float* __restrict__ floor_depth,
                    float* __restrict__ depth_out, int* __restrict__ pair_out,
                    int* __restrict__ layers_out) {
  constexpr int kBandH = kThreads / kTileW;  // 4 rows
  constexpr int kBands = kTileH / kBandH;
  __shared__ __align__(128) float4 ring[2][kChunk * 4];
  __shared__ __align__(8) uint64_t bar[2];

  const int tx = blockIdx.x;
  const int ty = blockIdx.y / kBands;
  const int t = ty * ntx + tx;
  const int x = tx * kTileW + static_cast<int>(threadIdx.x) % kTileW;
  const int y = ty * kTileH + (blockIdx.y % kBands) * kBandH +
                static_cast<int>(threadIdx.x) / kTileW;
  const bool live = x < width && y < height;
  int pb, pe;
  tile_part(tile_start, tile_count, t, num_rows, 1, 1, 0, &pb, &pe);

  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y + y_offset) + 0.5f;
  const float far_depth = kReverseZ ? 0.0f : 1.0f;
  const long long plane = static_cast<long long>(height) * width;
  const long long at = static_cast<long long>(y) * width + x;
  float floor_z = far_depth;
  if (floor_depth != nullptr && live && pe > pb) floor_z = floor_depth[at];
  float* depth = depth_out + at;
  int* pos = pair_out + at;
  int layers = 0;

  ring_walk(setup, pb, pe, ring, bar, [&](const float4* rows, int r0, int cnt) {
    if (!live) return;
    for (int r = 0; r < cnt; ++r) {
      const float4 q0 = rows[r * 4 + 0];
      const float4 q1 = rows[r * 4 + 1];
      const float4 q2 = rows[r * 4 + 2];
      const float e0 = edge(q0.x, q0.y, q0.z, px, py);
      const float e1 = edge(q0.w, q1.x, q1.y, px, py);
      const float e2 = edge(q1.z, q1.w, q2.x, px, py);
      if (!(e0 > fill_threshold(q0.x, q0.y) && e1 > fill_threshold(q0.w, q1.x) &&
            e2 > fill_threshold(q1.z, q1.w))) {
        continue;
      }
      const float4 q3 = rows[r * 4 + 3];
      const float wsum = dot3(e0, e1, e2, q3.x, q3.y, q3.z);
      if (!(wsum > 0.0f)) continue;
      const float zsum = dot3(e0, e1, e2, q2.y, q2.z, q2.w);
      const float z = __fdiv_rn(zsum, wsum);
      if (!(z >= 0.0f && z <= 1.0f && nearer<kReverseZ>(z, floor_z))) continue;
      const int held = layers < k ? layers : k;
      int rank = 0;
      while (rank < held && nearer<kReverseZ>(depth[rank * plane], z)) ++rank;
      layers += 1;
      if (rank == k) continue;
      for (int i = (held < k ? held : k - 1); i > rank; --i) {
        depth[i * plane] = depth[(i - 1) * plane];
        pos[i * plane] = pos[(i - 1) * plane];
      }
      depth[rank * plane] = z;
      pos[rank * plane] = r0 + r;
    }
  });

  if (!live) return;
  layers_out[at] = layers;
  for (int i = layers < k ? layers : k; i < k; ++i) {
    depth[i * plane] = far_depth;
    pos[i * plane] = -1;
  }
}

template <bool kReverseZ>
cudaError_t launch_deep(const void* setup, int num_rows, const void* tile_start,
                        const void* tile_count, int ntx, int nty, int height,
                        int width, int y_offset, int k, const void* floor_depth,
                        void* depth_out, void* pair_out, void* layers_out,
                        cudaStream_t stream) {
  constexpr int kBands = kTileH / (kThreads / kTileW);
  kbuffer_deep_kernel<kReverseZ><<<dim3(ntx, nty * kBands, 1), kThreads, 0, stream>>>(
      static_cast<const float4*>(setup), num_rows,
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      ntx, height, width, y_offset, k, static_cast<const float*>(floor_depth),
      static_cast<float*>(depth_out), static_cast<int*>(pair_out),
      static_cast<int*>(layers_out));
  return cudaSuccess;
}

}  // namespace

// Bytes of dynamic shared memory a block of the K-slot template takes, or -1
// for another k.
extern "C" int sc_kbuffer_smem_bytes(int k) {
  switch (k) {
    case 1: return smem_bytes<1>();
    case 2: return smem_bytes<2>();
    case 4: return smem_bytes<4>();
    case 8: return smem_bytes<8>();
    case 16: return smem_bytes<16>();
    default: return -1;
  }
}

// Plain C entry point (loaded with ctypes). Tile shape is fixed at 32x128.
// k is 1, 2, 4, 8 or 16 (the templates; a caller wanting another K up to 16
// passes the next of them and keeps the first K planes) or above 16 (the
// deep kernel, which needs depth_out and ignores cluster and
// min_part_rows); `cluster` (1..8) blocks share a band, and a tile is split
// only into parts of more than `min_part_rows` (>= 1) rows. The caller
// checks shapes, dtypes, devices and 16-byte alignment of `setup`.
// floor_depth (H, W) may be null (every floor at far); depth_out (K, H, W)
// may be null (no depth planes) for k <= 16. Launches on `stream`,
// allocates nothing, does not synchronise. Returns the launch's cudaError_t
// code (0 = launched), or cudaErrorInvalidValue for another k, cluster or
// min_part_rows, or a null depth_out above 16.
extern "C" int sc_kbuffer_sorted(const void* setup, int num_rows,
                                 const void* tile_start,
                                 const void* tile_count, int ntx, int nty,
                                 int height, int width, int y_offset, int k,
                                 int reverse_z, int cluster, int min_part_rows,
                                 const void* floor_depth, void* depth_out,
                                 void* pair_out, void* layers_out,
                                 void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || min_part_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rz = reverse_z != 0;
  cudaError_t err;
  switch (k) {
    case 1:
      err = dispatch<1>(rz, setup, num_rows, tile_start, tile_count, ntx, nty,
                        height, width, y_offset, cluster, min_part_rows,
                        floor_depth, depth_out, pair_out, layers_out, s);
      break;
    case 2:
      err = dispatch<2>(rz, setup, num_rows, tile_start, tile_count, ntx, nty,
                        height, width, y_offset, cluster, min_part_rows,
                        floor_depth, depth_out, pair_out, layers_out, s);
      break;
    case 4:
      err = dispatch<4>(rz, setup, num_rows, tile_start, tile_count, ntx, nty,
                        height, width, y_offset, cluster, min_part_rows,
                        floor_depth, depth_out, pair_out, layers_out, s);
      break;
    case 8:
      err = dispatch<8>(rz, setup, num_rows, tile_start, tile_count, ntx, nty,
                        height, width, y_offset, cluster, min_part_rows,
                        floor_depth, depth_out, pair_out, layers_out, s);
      break;
    case 16:
      err = dispatch<16>(rz, setup, num_rows, tile_start, tile_count, ntx, nty,
                         height, width, y_offset, cluster, min_part_rows,
                         floor_depth, depth_out, pair_out, layers_out, s);
      break;
    default:
      if (k <= 16 || depth_out == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      err = rz ? launch_deep<true>(setup, num_rows, tile_start, tile_count, ntx,
                                   nty, height, width, y_offset, k, floor_depth,
                                   depth_out, pair_out, layers_out, s)
               : launch_deep<false>(setup, num_rows, tile_start, tile_count,
                                    ntx, nty, height, width, y_offset, k,
                                    floor_depth, depth_out, pair_out,
                                    layers_out, s);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
