// The shading worklists on Hopper (sm_90a): the compaction of a pixel mask
// into a fixed-capacity list of granules (one launch of a cooperative
// grid), the compose of the worklist's lane rows
// into a per-pixel destination, in place (one launch), and one alpha-clip
// round's compose of its found, chosen pair and chosen depth planes with
// the round's takes and masks folded in (one launch).
//
// Replaces no TPU kernel. The JAX package computes these in XLA:
// superconductor_tpu/render/frame.py:419 _compact_px and :532
// _compact_worklist (a sort of where(mask, arange, npx) keys), :543
// _compose_worklist (a scatter, or a cumsum-rank gather for large lists),
// and the clip round at :951-966 (two takes of full planes, the masks and
// three composes). It sorts on purpose: a TPU scatter costs about 80 ns a
// row. The plain versions (ops/worklist.py worklist_compact_plain,
// worklist_compose_plain and worklist_compose_clip_plain) keep the torch
// chains: an any() over the mask's granules, the keys, a full radix sort
// and three small ops a compaction; a compose that copies the whole
// destination with torch.cat before index_copy_ writes the rows into the
// copy; the clip round's gathers, six elementwise ops and three composes.
// On the card a scattered row costs what a gathered one does, so neither
// the sort nor the copy is needed.
//
// worklist_compact_kernel: a mask (npx,) of bytes (a bool tensor), granules
// of gr pixels (n_g = npx / gr), a granule set when any of its bytes is.
// Out: idx (cap,) i32, the set granules in ascending order and n_g past
// their count; safe = min(idx, n_g - 1); live = idx < n_g; need = the set
// granules times gr. What holds a compaction back is launches, not bytes:
// 2 MB of mask is 0.6 us at the card's rate, below one launch's dispatch
// (PERF.md). So it is one launch of a cooperative grid (ops/worklist.py
// compact_blocks: 128 blocks at every frame's shape, 16,200 granules of
// 128 pixels at 1080p; more where a block would own more than kChunk
// granules; the entry point holds it to what the card runs at once: a grid
// barrier waits for every block). Block t owns the
// contiguous run of ceil(n_g / blocks) granules from t times that. It
// computes its run's flags into shared memory, kChunk granules at a time
// (16-B loads where the mask is 16-B aligned and a granule is whole
// chunks, eight in flight a thread; bytes one by one otherwise), and its
// count into `counts` (one int a block, allocated by the wrapper for the
// call and written whole before it is read). After the grid's barrier
// (cg::this_grid().sync(), the runtime's, no state of this file's) each
// block sums the counts before its run and of all, scans its threads'
// counts (shuffles) and writes its set granules below the cap in
// ascending order: from the flags still in shared memory where its run is
// one chunk (every frame's), else computing each chunk's flags again (the
// mask is in L2 by then). The blocks together write the sentinels from
// the total to the cap, and block 0 the need. Nothing is kept between
// calls: a CUDA graph replays the launch as is.
//
// worklist_compose_kernel: dst (npx, C) of 32-bit words (f32 or i32, C = 1
// or 3), rows (slots * gr, C), one thread 4 words of a granule's row
// (<kVec>: 16-B loads and stores, where the row width gr * C is a multiple
// of 4 and both tensors are 16-B aligned) or one word (<kWords>); a slot
// whose idx is n_g or more (dead, past the count) writes nothing, and with
// a lane mask `where` a lane whose mask is false writes nothing: no copy of
// dst, no scratch row.
// <kClip>: one clip round, a thread a lane q = j * gr + l of slot j, at
// pixel p = idx[j] * gr + l of a live slot: cur = found[p] != 0, ok =
// valid[q] && alpha[q] >= cutoff[q] && !cur; found[p] = cur || ok as 1 or 0
// at every live lane (lanes with no fragment too); where ok, pair[p] =
// pair_rows[q] and depth[p] = layer_depth[p], the layer's depth plane read
// in place. Three planes in one launch, where the torch chain took two
// gathers of full planes, six elementwise ops and three composes. valid,
// alpha and cutoff are read at any element stride (alpha and cutoff as
// ops/shade.py albedo_alpha returns them: columns of wider rows).
//
// What bounds them on this card: bytes. The compaction reads the mask once
// (npx bytes) and writes 9 B a slot; a compose reads and writes the live
// lanes' rows (and reads the lane mask); a clip round reads and writes
// found at the live lanes, reads valid, alpha and cutoff where they are
// needed and writes pair and depth where ok. At the frames' sizes each is
// a few microseconds of data at most, so one launch's dispatch (a few
// microseconds, PERF.md) is most of the time, and each design is the one
// launch.
//
// Bit for bit with the torch chains: the compaction's results are
// integers, the composes copy 32-bit words, and the clip test compares two
// floats as torch's >= does (false with a NaN; no flush to zero).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // a block of either kernel
constexpr int kChunk = 4096;   // granules a block flags at a time (ops/worklist.py CHUNK)
constexpr int kLoads = 8;      // 16-B loads a thread has in flight
constexpr unsigned kFull = 0xffffffffu;

// the compose's forms
enum ComposeForm { kWords = 0, kVec = 1, kClip = 2 };

struct CompactArgs {
  const uint8_t* mask;
  int gr, n_g;
  int run;  // granules a block: ceil(n_g / blocks)
  int vec;  // the mask is 16-B aligned
  int cap;
  int* counts;  // one int a block
  int* idx;
  int* safe;
  uint8_t* live;
  int* need;
};

struct ComposeArgs {
  const int* idx;
  int words;  // threads' work: slots * gr * C words, or slots * gr lanes (kClip)
  int w, c, gr, n_g;
  // kWords / kVec
  const uint32_t* rows;
  const uint8_t* where;
  uint32_t* dst;
  // kClip
  const uint8_t* valid;
  const float* alpha;
  const float* cutoff;
  long long valid_stride, alpha_stride, cutoff_stride;
  const int* pair_rows;
  const uint32_t* layer_depth;
  int* found;
  int* pair;
  uint32_t* depth;
};

// flags[i] = 1 where granule g0 + i (i < n) holds a set byte, else 0; the
// chunk's bytes are [b0, b0 + n * gr) of the mask, indexed in 32 bits from
// b0 (n * gr is at most the mask's npx, under 2^31)
__device__ void chunk_flags(const uint8_t* __restrict__ mask, long long b0, int n, int gr,
                            bool vec, uint8_t* flags) {
  for (int i = threadIdx.x; i < n; i += kThreads) flags[i] = 0;
  __syncthreads();
  const int nbytes = n * gr;
  if (vec && gr % 16 == 0) {
    // b0 is a multiple of 16: whole chunks, each inside one granule, kLoads
    // of them in flight a thread before any is tested
    const uint4* chunks = reinterpret_cast<const uint4*>(mask + b0);
    const int per = gr >> 4;
    const int nc = nbytes >> 4;
    for (int c = threadIdx.x; c < nc; c += kLoads * kThreads) {
      uint4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int cu = c + u * kThreads;
        v[u] = cu < nc ? __ldg(chunks + cu) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if ((v[u].x | v[u].y | v[u].z | v[u].w) != 0u) flags[(c + u * kThreads) / per] = 1;
    }
  } else if (vec) {
    // the mask's 16-B chunks that hold the chunk's bytes, the first `head`
    // bytes of the first one before b0
    const uint4* chunks = reinterpret_cast<const uint4*>(mask) + (b0 >> 4);
    const int head = (int)(b0 & 15);
    const int nch = (head + nbytes + 15) >> 4;
    for (int c = threadIdx.x; c < nch; c += kThreads) {
      const int base = (c << 4) - head;  // its first byte's offset from b0
      if (base >= 0 && base + 16 <= nbytes) {
        const uint4 v = __ldg(chunks + c);
        if ((v.x | v.y | v.z | v.w) == 0u) continue;
        const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if ((words[k] >> (8 * j)) & 0xffu) flags[(base + 4 * k + j) / gr] = 1;
        }
      } else {  // 16 bytes across the chunk's edge: those inside it
        const int lo = base > 0 ? base : 0;
        const int hi = base + 16 < nbytes ? base + 16 : nbytes;
        for (int i = lo; i < hi; ++i)
          if (__ldg(mask + b0 + i)) flags[i / gr] = 1;
      }
    }
  } else {
    for (int i = threadIdx.x; i < nbytes; i += kThreads)
      if (__ldg(mask + b0 + i)) flags[i / gr] = 1;
  }
  __syncthreads();
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// (sum of a, sum of b) over the block, to every thread
__device__ int2 block_sum2(int a, int b) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int2 part[kWarps];
  a = warp_sum(a);
  b = warp_sum(b);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = make_int2(a, b);
  __syncthreads();
  int2 s = make_int2(0, 0);
  for (int w = 0; w < kWarps; ++w) {
    s.x += part[w].x;
    s.y += part[w].y;
  }
  __syncthreads();
  return s;
}

// the exclusive prefix of v over the block's threads in order
__device__ int block_exclusive_scan(int v) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  return (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
}

// this thread's count of the set flags in its run of the chunk's n, and
// that run [i0, i1)
__device__ __forceinline__ int thread_count(const uint8_t* flags, int n, int& i0, int& i1) {
  const int per = (n + kThreads - 1) / kThreads;
  i0 = min((int)threadIdx.x * per, n);
  i1 = min(i0 + per, n);
  int mine = 0;
  for (int i = i0; i < i1; ++i) mine += flags[i];
  return mine;
}

__global__ void __launch_bounds__(kThreads) worklist_compact_kernel(const CompactArgs a) {
  __shared__ uint8_t flags[kChunk];
  const int g0 = (int)min((long long)blockIdx.x * a.run, (long long)a.n_g);
  const int g1 = (int)min((long long)g0 + a.run, (long long)a.n_g);
  const bool one_chunk = g1 - g0 <= kChunk;  // its flags stay in shared memory
  int count = 0, mine = 0, i0 = 0, i1 = 0;
  for (int c0 = g0; c0 < g1; c0 += kChunk) {
    const int n = min(kChunk, g1 - c0);
    chunk_flags(a.mask, (long long)c0 * a.gr, n, a.gr, a.vec != 0, flags);
    mine = thread_count(flags, n, i0, i1);
    count += block_sum2(mine, 0).x;  // its barriers end the reads of flags
  }
  if (threadIdx.x == 0) a.counts[blockIdx.x] = count;
  cg::this_grid().sync();  // every block's count written
  int lower = 0, all = 0;
  for (int j = threadIdx.x; j < (int)gridDim.x; j += kThreads) {
    const int c = a.counts[j];
    all += c;
    if (j < (int)blockIdx.x) lower += c;
  }
  const int2 s = block_sum2(lower, all);
  const int total = s.y;
  int before = s.x;  // set granules before this chunk
  for (int c0 = g0; c0 < g1 && before < a.cap; c0 += kChunk) {
    const int n = min(kChunk, g1 - c0);
    if (!one_chunk) {
      chunk_flags(a.mask, (long long)c0 * a.gr, n, a.gr, a.vec != 0, flags);
      mine = thread_count(flags, n, i0, i1);
    }
    int pos = before + block_exclusive_scan(mine);
    for (int i = i0; i < i1 && pos < a.cap; ++i) {
      if (!flags[i]) continue;
      a.idx[pos] = c0 + i;
      a.safe[pos] = c0 + i;
      a.live[pos] = 1;
      ++pos;
    }
    before += block_sum2(mine, 0).x;  // and its barriers end this chunk's reads
  }
  for (long long p = (long long)total + (long long)blockIdx.x * kThreads + threadIdx.x;
       p < a.cap; p += (long long)gridDim.x * kThreads) {
    a.idx[p] = a.n_g;
    a.safe[p] = a.n_g - 1;
    a.live[p] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.need = total * a.gr;
}

template <int kForm>
__global__ void __launch_bounds__(kThreads) worklist_compose_kernel(const ComposeArgs a) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if constexpr (kForm == kClip) {
    if (q >= a.words) return;
    const int j = (int)(q / a.gr);  // the granule slot
    const int g = __ldg(a.idx + j);
    if ((unsigned)g >= (unsigned)a.n_g) return;  // dead: past the count
    const long long p = (long long)g * a.gr + (q - (long long)j * a.gr);
    const bool cur = a.found[p] != 0;
    const bool ok = !cur && __ldg(a.valid + q * a.valid_stride) != 0 &&
                    __ldg(a.alpha + q * a.alpha_stride) >= __ldg(a.cutoff + q * a.cutoff_stride);
    a.found[p] = (cur || ok) ? 1 : 0;
    if (ok) {
      a.pair[p] = __ldg(a.pair_rows + q);
      a.depth[p] = __ldg(a.layer_depth + p);
    }
    return;
  } else {
    const long long e = kForm == kVec ? q * 4 : q;
    if (e >= a.words) return;
    const int j = (int)(e / a.w);                   // the granule slot
    const int o = (int)(e - (long long)j * a.w);    // the word in its row
    const int g = __ldg(a.idx + j);
    if ((unsigned)g >= (unsigned)a.n_g) return;  // dead: past the count
    uint32_t* out = a.dst + (long long)g * a.w + o;
    const long long lane0 = (long long)j * a.gr;
    if constexpr (kForm == kVec) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(a.rows + e));
      if (a.where == nullptr) {
        *reinterpret_cast<uint4*>(out) = v;
        return;
      }
      const uint32_t vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (__ldg(a.where + lane0 + (o + k) / a.c)) out[k] = vv[k];
    } else {
      if (a.where != nullptr && !__ldg(a.where + lane0 + o / a.c)) return;
      *out = __ldg(a.rows + e);
    }
  }
}

// blocks of the compaction's grid the current device holds at once, or -1
// (asked of the runtime once a device)
int grid_capacity() {
  static int known[64] = {};
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (device < 64 && known[device] > 0) return known[device];
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, worklist_compact_kernel, kThreads,
                                                    0) != cudaSuccess) {
    return -1;
  }
  if (device < 64) known[device] = sms * per_sm;
  return sms * per_sm;
}

cudaError_t launch_compose(int form, int blocks, const ComposeArgs& args, cudaStream_t s) {
  if (form == kClip) {
    worklist_compose_kernel<kClip><<<blocks, kThreads, 0, s>>>(args);
  } else if (form == kVec) {
    worklist_compose_kernel<kVec><<<blocks, kThreads, 0, s>>>(args);
  } else {
    worklist_compose_kernel<kWords><<<blocks, kThreads, 0, s>>>(args);
  }
  return cudaGetLastError();
}

}  // namespace

// The C entry points (ops/worklist.py binds them with ctypes). Pointers are
// device pointers. The result is the launches' cudaError_t.

// mask (npx,) bytes, granules of gr; idx, safe (cap,) i32, live (cap,)
// bytes, need () i32; cap at most n_g; counts at least `blocks` ints. The
// grid is `blocks` blocks, held to n_g and to what the card runs at once
// (a cooperative launch's barrier waits for every block: a grid larger
// than that would never pass it, and a CUDA graph's capture need not
// refuse it).
extern "C" int sc_worklist_compact(const uint8_t* mask, int npx, int gr, int blocks, int cap,
                                   int* counts, int* idx, int* safe, uint8_t* live, int* need,
                                   void* stream) {
  if (npx <= 0 || gr <= 0 || npx % gr) return (int)cudaErrorInvalidValue;
  const int n_g = npx / gr;
  if (cap < 0 || cap > n_g || blocks <= 0 || counts == nullptr) return (int)cudaErrorInvalidValue;
  const int capacity = grid_capacity();
  if (capacity <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (blocks > n_g) blocks = n_g;
  if (blocks > capacity) blocks = capacity;
  const int run = (n_g + blocks - 1) / blocks;
  const int vec = reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  const CompactArgs args{mask, gr, n_g, run, vec, cap, counts, idx, safe, live, need};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, worklist_compact_kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// idx (slots,) i32 granule indices (n_g or more: dead); rows (slots * gr,
// c) and dst (n_g * gr, c) of 32-bit words, contiguous; where (slots * gr,)
// bytes or null
extern "C" int sc_worklist_compose(const int* idx, int slots, int gr, int c, int n_g,
                                   const void* rows, const uint8_t* where, void* dst,
                                   void* stream) {
  if (slots <= 0 || gr <= 0 || c <= 0 || n_g <= 0) return (int)cudaErrorInvalidValue;
  const long long w = (long long)gr * c;
  if ((long long)slots * w >= (1LL << 31) || (long long)n_g * w >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  ComposeArgs args = {};
  args.idx = idx;
  args.words = (int)(slots * w);
  args.w = (int)w;
  args.c = c;
  args.gr = gr;
  args.n_g = n_g;
  args.rows = static_cast<const uint32_t*>(rows);
  args.where = where;
  args.dst = static_cast<uint32_t*>(dst);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const long long threads = vec ? args.words / 4 : args.words;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  return (int)launch_compose(vec ? kVec : kWords, blocks, args, (cudaStream_t)stream);
}

// One clip round: idx (slots,) i32 as above; valid (slots * gr,) bytes,
// alpha and cutoff (slots * gr,) f32, each at its element stride; pair_rows
// (slots * gr,) i32 contiguous; layer_depth, found, pair and depth (n_g *
// gr,) contiguous (f32, i32, i32, f32), the last three written in place
extern "C" int sc_worklist_compose_clip(const int* idx, int slots, int gr, int n_g,
                                        const uint8_t* valid, long long valid_stride,
                                        const float* alpha, long long alpha_stride,
                                        const float* cutoff, long long cutoff_stride,
                                        const int* pair_rows, const void* layer_depth,
                                        int* found, int* pair, void* depth, void* stream) {
  if (slots <= 0 || gr <= 0 || n_g <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)slots * gr >= (1LL << 31) || (long long)n_g * gr >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  ComposeArgs args = {};
  args.idx = idx;
  args.words = slots * gr;
  args.w = gr;
  args.c = 1;
  args.gr = gr;
  args.n_g = n_g;
  args.valid = valid;
  args.alpha = alpha;
  args.cutoff = cutoff;
  args.valid_stride = valid_stride;
  args.alpha_stride = alpha_stride;
  args.cutoff_stride = cutoff_stride;
  args.pair_rows = pair_rows;
  args.layer_depth = static_cast<const uint32_t*>(layer_depth);
  args.found = found;
  args.pair = pair;
  args.depth = static_cast<uint32_t*>(depth);
  const int blocks = (args.words + kThreads - 1) / kThreads;
  return (int)launch_compose(kClip, blocks, args, (cudaStream_t)stream);
}
