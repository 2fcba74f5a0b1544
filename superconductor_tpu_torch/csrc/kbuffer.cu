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
// runs kbuffer_deep_kernel: its 2K + 3 live values a pixel no longer fit
// registers, and smem_bytes<32> at kPix = 2 passes the 227 KB a block may
// take. Bytes bound it as they bound the templates (K pair planes, K depth
// planes when wanted, and `layers`, written at every pixel), so its design
// writes each of them once and nothing else:
// * Lists on chip. A block of P threads owns a band of P pixels of a tile,
//   one a thread, row-major (P / 128 rows of 128 columns, or P columns of one
//   row below 128), and keeps each pixel's slots in shared memory,
//   slot-major ([slot][pixel]: a warp's 32 pixels hit 32 banks), with its
//   count: P (8K + 4) bytes beside the 8 KB ring (deep_smem_bytes).
//   deep_band_px takes the largest P in {512, ..., 32} of which two blocks
//   fit an SM (512 up to K = 25, 256 up to 52, 128 up to 104, 64 up to 209,
//   32 up to 419), else P = 32 at one block an SM: the largest K the kernel
//   takes is 875.
// * The insert is the templates' sorted insert, run on the list in shared
//   memory from its end: each held slot that is not strictly nearer than
//   the new fragment moves back one (the last falls off when the list is
//   full), and the fragment lands in the gap; a full list whose last slot
//   is strictly nearer drops it at once. An unsorted list that replaces its
//   farthest entry would save the shifts but needs a rescan for the new
//   farthest on every replacement and a sort of every list at the end; the
//   shifts fall only on the few pixels a deep stack covers, and a sorted
//   list is written and merged as it stands.
// * Writes. At the end each thread writes its pixel's K pair planes, K depth
//   planes only when depth_out is non-null, and `layers`, once: a warp
//   stores 128 contiguous bytes of a plane. A band of an empty tile writes
//   far / -1 / 0 without touching shared memory. No scratch planes.
// * Row rejection. A warp's 32 pixels are one segment of a row: for 32 rows
//   at a time, lane i tests row i against that 32x1 rectangle
//   (raster_common.cuh rect_keeps) and the warp walks the rows it keeps, in
//   order, two at a time: both rows' fill tests and depth work without
//   branches between them, so their dependent chains overlap, then the
//   inserts in row order.
// * Cluster split, as the templates: a tile of more than min_part_rows rows
//   is cut into parts (tile_part) over a cluster of S blocks, and each block
//   walks its part into its own lists. After cluster.sync() block s takes a
//   share of the band's pixels, which no other block reads in its lists,
//   and merges every other part's list into its own there, in place from
//   the back, by the templates' kByPos rule (nearer, or at an equal depth
//   the larger position, ahead): the other part's entries come through
//   distributed shared memory 8 at a time, loaded together, and its own
//   from local shared memory. Different parts hold different positions, so
//   that order is total: the merge is the whole walk's list bit for bit,
//   whatever S or the order of the parts, and `layers` is the sum of the
//   parts' counts.
// What still bounds it (measured at 1080p on an H100, PERF.md): on a pass
// whose tiles are mostly empty, the empty bands' writes, near the bytes
// bound; at K below 32, the busy bands' walks, each kept row a chain of
// dependent FP32 operations, an IEEE divide and an insert whose shifts
// follow one another. A cluster split pays on a tile of thousands of rows;
// on lighter tiles its extra blocks cost more than the shorter walks save,
// so the wrapper's default is one block a band.
// A K above 875 runs kbuffer_global_kernel: each pixel's list in its output
// planes in device memory (scratch depth planes when the caller wants
// none), one thread a pixel, no rejection or split; the deep kernel's
// predecessor for every K above 16, exported as sc_kbuffer_global so that
// the two can be timed side by side.

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

constexpr int kSmSmem = 233472;       // shared memory of an SM
constexpr int kBlockSmem = 232448;    // the most a block may take
constexpr int kBlockReserved = 1024;  // what the runtime keeps of it a block

// dynamic shared memory of a deep block of px pixels at k slots: the ring,
// then k depths, k positions and the count of every pixel
__host__ __device__ constexpr long long deep_smem_bytes(int px, int k) {
  return kRingBytes + static_cast<long long>(px) * (8LL * k + 4);
}

// Pixels a block of the deep kernel owns at k slots: the largest of 512,
// 256, ..., 32 of which two blocks fit an SM, else 32 when one block fits,
// else 0 (the global-memory kernel).
int deep_band_px(int k) {
  for (int px = 512; px >= 32; px /= 2) {
    if (2 * (deep_smem_bytes(px, k) + kBlockReserved) <= kSmSmem) return px;
  }
  return deep_smem_bytes(32, k) <= kBlockSmem ? 32 : 0;
}

// K > 16 (header: "Other K"). Thread q owns pixel q of the band, its slot i
// at list_z / list_p[i * kPx + q], nearest first; only its first min(count,
// k) slots are held.
template <int kPx, bool kReverseZ, bool kWantDepth>
__global__ void __launch_bounds__(kPx, 1024 / kPx)
kbuffer_deep_kernel(const float4* __restrict__ setup, int num_rows,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ tile_count, int ntx, int height,
                    int width, int y_offset, int k, int min_part_rows,
                    const float* __restrict__ floor_depth,
                    float* __restrict__ depth_out, int* __restrict__ pair_out,
                    int* __restrict__ layers_out) {
  constexpr int kCols = kPx < kTileW ? kPx : kTileW;
  constexpr int kRows = kPx / kCols;
  constexpr int kAcross = kTileW / kCols;  // bands across a tile
  constexpr int kDown = kTileH / kRows;    // bands down a tile

  extern __shared__ __align__(128) unsigned char smem[];
  float4(*ring)[kChunk * 4] = reinterpret_cast<float4(*)[kChunk * 4]>(smem);
  float* list_z = reinterpret_cast<float*>(smem + kRingBytes);
  int* list_p = reinterpret_cast<int*>(list_z + k * kPx);
  int* list_n = list_p + k * kPx;
  __shared__ __align__(8) uint64_t bar[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int band = blockIdx.x / S;
  const int tx = band / kAcross;
  const int ty = blockIdx.y / kDown;
  const int band_x = tx * kTileW + (band % kAcross) * kCols;
  const int band_y = ty * kTileH + (blockIdx.y % kDown) * kRows;
  const int t = ty * ntx + tx;

  int pb, pe;
  const int parts = tile_part(tile_start, tile_count, t, num_rows, S,
                              min_part_rows, rank, &pb, &pe);
  if (parts == 1 && rank != 0) return;  // uniform over the cluster

  const int q = threadIdx.x;
  const int x = band_x + q % kCols;
  const int y = band_y + q / kCols;
  const bool live = x < width && y < height;
  const long long plane = static_cast<long long>(height) * width;
  const long long at = static_cast<long long>(y) * width + x;
  const float far_depth = kReverseZ ? 0.0f : 1.0f;

  if (parts == 1 && pe == pb) {  // an empty tile
    if (live) {
      layers_out[at] = 0;
      for (int i = 0; i < k; ++i) {
        pair_out[i * plane + at] = -1;
        if (kWantDepth) depth_out[i * plane + at] = far_depth;
      }
    }
    return;
  }

  float floor_z = far_depth;
  if (floor_depth != nullptr && live && pe > pb) floor_z = floor_depth[at];
  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y + y_offset) + 0.5f;
  const int lane = q & 31;
  const int seg = q - lane;  // the warp's 32 pixels: one segment of a row
  const int seg_x = band_x + seg % kCols;
  const int seg_y = band_y + seg / kCols + y_offset;
  float* zq = list_z + q;
  int* pq = list_p + q;
  int layers = 0;

  ring_walk(setup, pb, pe, ring, bar, [&](const float4* rows, int r0, int cnt) {
    for (int g = 0; g < cnt; g += 32) {
      bool keep = false;
      if (g + lane < cnt) {
        keep = rect_keeps<32, 1>(rows[(g + lane) * 4 + 0], rows[(g + lane) * 4 + 1],
                                 rows[(g + lane) * 4 + 2].x, seg_x, seg_y);
      }
      unsigned mine = __ballot_sync(0xffffffffu, keep);
      while (mine != 0u) {  // uniform over the warp
        // two kept rows at a time (the second is the first again when none
        // is left): the fill tests and the depth work of both without
        // branches between them, so their chains overlap; the inserts
        // then go in row order
        const int ra = g + __ffs(mine) - 1;
        mine &= mine - 1u;
        const bool two = mine != 0u;
        const int rb = two ? g + __ffs(mine) - 1 : ra;
        if (two) mine &= mine - 1u;
        float e[2][3];
        bool inside[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4* row = rows + (h == 0 ? ra : rb) * 4;
          const float4 q0 = row[0];
          const float4 q1 = row[1];
          const float c2 = row[2].x;
          e[h][0] = edge(q0.x, q0.y, q0.z, px, py);
          e[h][1] = edge(q0.w, q1.x, q1.y, px, py);
          e[h][2] = edge(q1.z, q1.w, c2, px, py);
          inside[h] = live && e[h][0] > fill_threshold(q0.x, q0.y) &&
                      e[h][1] > fill_threshold(q0.w, q1.x) &&
                      e[h][2] > fill_threshold(q1.z, q1.w);
        }
        inside[1] = inside[1] && two;
        if (!(inside[0] || inside[1])) continue;
        float z[2];
        bool ok[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4* row = rows + (h == 0 ? ra : rb) * 4;
          const float4 q2 = row[2];
          const float4 q3 = row[3];
          const float wsum = dot3(e[h][0], e[h][1], e[h][2], q3.x, q3.y, q3.z);
          const float zsum = dot3(e[h][0], e[h][1], e[h][2], q2.y, q2.z, q2.w);
          z[h] = __fdiv_rn(zsum, wsum);
          ok[h] = inside[h] && wsum > 0.0f && z[h] >= 0.0f && z[h] <= 1.0f &&
                  nearer<kReverseZ>(z[h], floor_z);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!ok[h]) continue;
          const int held = layers < k ? layers : k;
          layers += 1;
          // rank k: every held slot strictly nearer
          if (held == k && nearer<kReverseZ>(zq[(k - 1) * kPx], z[h])) continue;
          int i = held < k ? held : k - 1;
          while (i > 0 && !nearer<kReverseZ>(zq[(i - 1) * kPx], z[h])) {
            zq[i * kPx] = zq[(i - 1) * kPx];
            pq[i * kPx] = pq[(i - 1) * kPx];
            --i;
          }
          zq[i * kPx] = z[h];
          pq[i * kPx] = r0 + (h == 0 ? ra : rb);
        }
      }
    }
  });

  if (parts == 1) {
    if (live) {
      layers_out[at] = layers;
      const int held = layers < k ? layers : k;
      for (int i = 0; i < k; ++i) {
        pair_out[i * plane + at] = i < held ? pq[i * kPx] : -1;
        if (kWantDepth) depth_out[i * plane + at] = i < held ? zq[i * kPx] : far_depth;
      }
    }
    return;
  }

  // split band: block `rank` merges, for its share [rank P / S, (rank + 1)
  // P / S) of the band's pixels, every other part's list into its own, in
  // place, then writes them. Only this block reads its own lists there.
  list_n[q] = layers;
  cluster.sync();
  const int m = rank * kPx / S + q;
  const int mx = band_x + m % kCols;
  const int my = band_y + m / kCols;
  if (m < (rank + 1) * kPx / S && mx < width && my < height) {
    float* za = list_z + m;
    int* pa = list_p + m;
    int count = list_n[m];
    int held = count < k ? count : k;
    for (int s = 0; s < parts; ++s) {
      if (s == rank) continue;
      const int n = cluster.map_shared_rank(list_n, s)[m];
      count += n;
      const float* zb = cluster.map_shared_rank(list_z, s) + m;
      const int* pb_s = cluster.map_shared_rank(list_p, s) + m;
      // merge from the back: slot `out` takes whichever of a's and b's
      // last unmerged entries is behind the other; slots past k drop
      int ia = held - 1, ib = (n < k ? n : k) - 1;
      int out = ia + ib + 1;
      held = out + 1 < k ? out + 1 : k;
      while (ib >= 0) {  // then a's unmerged entries are in place
        float bz[8];  // the next 8 of b, loaded together from the other block
        int bp[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (ib - j >= 0) {
            bz[j] = zb[(ib - j) * kPx];
            bp[j] = pb_s[(ib - j) * kPx];
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (ib - j < 0) break;
          while (ia >= 0 && (nearer<kReverseZ>(bz[j], za[ia * kPx]) ||
                             (bz[j] == za[ia * kPx] && bp[j] > pa[ia * kPx]))) {
            if (out < k) {
              za[out * kPx] = za[ia * kPx];
              pa[out * kPx] = pa[ia * kPx];
            }
            --ia;
            --out;
          }
          if (out < k) {
            za[out * kPx] = bz[j];
            pa[out * kPx] = bp[j];
          }
          --out;
        }
        ib -= 8;
      }
    }
    const long long at_m = static_cast<long long>(my) * width + mx;
    layers_out[at_m] = count;
    for (int i = 0; i < k; ++i) {
      pair_out[i * plane + at_m] = i < held ? pa[i * kPx] : -1;
      if (kWantDepth) depth_out[i * plane + at_m] = i < held ? za[i * kPx] : far_depth;
    }
  }
  cluster.sync();  // no block leaves while another still reads its lists
}

template <int kPx, bool kReverseZ, bool kWantDepth>
cudaError_t launch_deep(const void* setup, int num_rows, const void* tile_start,
                        const void* tile_count, int ntx, int nty, int height,
                        int width, int y_offset, int k, int cluster,
                        int min_part_rows, const void* floor_depth,
                        void* depth_out, void* pair_out, void* layers_out,
                        cudaStream_t stream) {
  constexpr int kCols = kPx < kTileW ? kPx : kTileW;
  constexpr int kRows = kPx / kCols;
  const int smem = static_cast<int>(deep_smem_bytes(kPx, k));
  auto kernel = kbuffer_deep_kernel<kPx, kReverseZ, kWantDepth>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ntx * (kTileW / kCols) * cluster, nty * (kTileH / kRows), 1);
  cfg.blockDim = dim3(kPx, 1, 1);
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
      ntx, height, width, y_offset, k, min_part_rows,
      static_cast<const float*>(floor_depth), static_cast<float*>(depth_out),
      static_cast<int*>(pair_out), static_cast<int*>(layers_out));
}

template <int kPx>
cudaError_t dispatch_deep(bool reverse_z, const void* setup, int num_rows,
                          const void* tile_start, const void* tile_count,
                          int ntx, int nty, int height, int width,
                          int y_offset, int k, int cluster, int min_part_rows,
                          const void* floor_depth, void* depth_out,
                          void* pair_out, void* layers_out, cudaStream_t s) {
  const bool want_depth = depth_out != nullptr;
  if (reverse_z && want_depth) {
    return launch_deep<kPx, true, true>(setup, num_rows, tile_start, tile_count,
                                        ntx, nty, height, width, y_offset, k,
                                        cluster, min_part_rows, floor_depth,
                                        depth_out, pair_out, layers_out, s);
  } else if (reverse_z) {
    return launch_deep<kPx, true, false>(setup, num_rows, tile_start, tile_count,
                                         ntx, nty, height, width, y_offset, k,
                                         cluster, min_part_rows, floor_depth,
                                         depth_out, pair_out, layers_out, s);
  } else if (want_depth) {
    return launch_deep<kPx, false, true>(setup, num_rows, tile_start, tile_count,
                                         ntx, nty, height, width, y_offset, k,
                                         cluster, min_part_rows, floor_depth,
                                         depth_out, pair_out, layers_out, s);
  }
  return launch_deep<kPx, false, false>(setup, num_rows, tile_start, tile_count,
                                        ntx, nty, height, width, y_offset, k,
                                        cluster, min_part_rows, floor_depth,
                                        depth_out, pair_out, layers_out, s);
}

// K beyond the deep kernel (header: "Other K"): 512 threads own 4 rows x 128
// columns of a tile, one pixel each. A pixel's occupied slots are its first
// min(layers, K) slots of the depth and pair planes (depth_out is never null
// here: the wrapper gives scratch planes when the caller wants none), sorted
// nearest first, so the slots strictly nearer than a new fragment are a
// prefix and its rank is their count -- the same insert as the template
// kernel's, slot by slot.
template <bool kReverseZ>
__global__ void __launch_bounds__(kThreads)
kbuffer_global_kernel(const float4* __restrict__ setup, int num_rows,
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
cudaError_t launch_global(const void* setup, int num_rows,
                          const void* tile_start, const void* tile_count,
                          int ntx, int nty, int height, int width,
                          int y_offset, int k, const void* floor_depth,
                          void* depth_out, void* pair_out, void* layers_out,
                          cudaStream_t stream) {
  constexpr int kBands = kTileH / (kThreads / kTileW);
  kbuffer_global_kernel<kReverseZ><<<dim3(ntx, nty * kBands, 1), kThreads, 0, stream>>>(
      static_cast<const float4*>(setup), num_rows,
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      ntx, height, width, y_offset, k, static_cast<const float*>(floor_depth),
      static_cast<float*>(depth_out), static_cast<int*>(pair_out),
      static_cast<int*>(layers_out));
  return cudaSuccess;
}

}  // namespace

// Bytes of dynamic shared memory a block of the K-slot kernel takes: the
// template's for 1, 2, 4, 8 and 16, the deep kernel's above 16, and -1 for
// another k or a k above 875 (the global-memory kernel takes none).
extern "C" int sc_kbuffer_smem_bytes(int k) {
  switch (k) {
    case 1: return smem_bytes<1>();
    case 2: return smem_bytes<2>();
    case 4: return smem_bytes<4>();
    case 8: return smem_bytes<8>();
    case 16: return smem_bytes<16>();
    default: break;
  }
  const int px = k > 16 ? deep_band_px(k) : 0;
  return px > 0 ? static_cast<int>(deep_smem_bytes(px, k)) : -1;
}

// Plain C entry point (loaded with ctypes). Tile shape is fixed at 32x128.
// k is 1, 2, 4, 8 or 16 (the templates; a caller wanting another K up to 16
// passes the next of them and keeps the first K planes) or above 16 (the
// deep kernel up to 875, the global-memory kernel above it, which needs
// depth_out and ignores cluster and min_part_rows); `cluster` (1..8) blocks
// share a band, and a tile is split only into parts of more than
// `min_part_rows` (>= 1) rows. The caller checks shapes, dtypes, devices
// and 16-byte alignment of `setup`. floor_depth (H, W) may be null (every
// floor at far); depth_out (K, H, W) may be null (no depth planes) for k up
// to 875. Launches on `stream`, allocates nothing, does not synchronise.
// Returns the launch's cudaError_t code (0 = launched), or
// cudaErrorInvalidValue for another k, cluster or min_part_rows, or a null
// depth_out above 875.
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
    default: {
      if (k <= 16) return static_cast<int>(cudaErrorInvalidValue);
      auto deep = dispatch_deep<32>;
      switch (deep_band_px(k)) {
        case 512: deep = dispatch_deep<512>; break;
        case 256: deep = dispatch_deep<256>; break;
        case 128: deep = dispatch_deep<128>; break;
        case 64: deep = dispatch_deep<64>; break;
        case 32: break;
        default:
          if (depth_out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
          err = rz ? launch_global<true>(setup, num_rows, tile_start, tile_count,
                                         ntx, nty, height, width, y_offset, k,
                                         floor_depth, depth_out, pair_out,
                                         layers_out, s)
                   : launch_global<false>(setup, num_rows, tile_start,
                                          tile_count, ntx, nty, height, width,
                                          y_offset, k, floor_depth, depth_out,
                                          pair_out, layers_out, s);
          if (err == cudaSuccess) err = cudaGetLastError();
          return static_cast<int>(err);
      }
      err = deep(rz, setup, num_rows, tile_start, tile_count, ntx, nty, height,
                 width, y_offset, k, cluster, min_part_rows, floor_depth,
                 depth_out, pair_out, layers_out, s);
    }
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// The global-memory kernel at any k >= 1, for timing beside the kernel
// sc_kbuffer_sorted runs (the same arguments without cluster and
// min_part_rows; depth_out must not be null).
extern "C" int sc_kbuffer_global(const void* setup, int num_rows,
                                 const void* tile_start,
                                 const void* tile_count, int ntx, int nty,
                                 int height, int width, int y_offset, int k,
                                 int reverse_z, const void* floor_depth,
                                 void* depth_out, void* pair_out,
                                 void* layers_out, void* stream) {
  if (k < 1 || depth_out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      reverse_z != 0
          ? launch_global<true>(setup, num_rows, tile_start, tile_count, ntx,
                                nty, height, width, y_offset, k, floor_depth,
                                depth_out, pair_out, layers_out, s)
          : launch_global<false>(setup, num_rows, tile_start, tile_count, ntx,
                                 nty, height, width, y_offset, k, floor_depth,
                                 depth_out, pair_out, layers_out, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
