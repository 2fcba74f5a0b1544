// The geometry stage on Hopper (sm_90a): the vertex stage of one or two
// draw lists in two launches (a vertex phase, then a triangle phase) and
// the edge setup of one view over both lists in one launch, one thread a
// slot.
//
// Replaces no TPU kernel. The JAX package leaves this stage to XLA:
// superconductor_tpu/ops/geometry.py:194 geometry_vertex_stage and :292
// geometry_view_setup (with _setup_from_clip, :386). The port ran them as
// chains of torch operations (ops/geometry.py geometry_vertex_stage_plain
// and geometry_view_setup_plain, which stay as the plain versions): about
// 400 launches a frame, nearly all of the stage's time, each writing its
// whole (slots, C) result to device memory for the next to read back.
//
// vertex_stage_kernel<0>, the vertex phase: the lists' vertex slots in one
// grid, each list's slots in whole blocks of their own (the animated list's
// blocks first: a skinned vertex takes the longest, and blocks start in
// index order). Each block's first warp scans its list's draw counts
// (valid draws only) into their inclusive prefixes with shuffles, as
// torch.cumsum gives them (int32, wrapping; any order gives the same
// integers), into shared memory; the list's first block also writes them
// to a device table (`ends`: the vertex prefixes, then the triangle ones)
// and the triangle count to num_valid. A vertex slot p finds its draw as
// torch.searchsorted(ends, p, right=True) does (the same binary search;
// owner 0 past the total), gathers its position, normal, uv and lightmap
// uv, skins them on the clamped joint rows of the palette (the animated
// list), applies the draw's sim8 transform, rotates the normal by its
// quaternion, applies the material's KHR_texture_transform (_uv_transform),
// and writes w1 (V, 4) and a scratch row of what a corner needs besides its
// position: the normal and u (`corner`'s first v_cap rows), v, the lightmap
// uv and a pad (its last v_cap rows), 16-B rows in two planes so that every
// store is coalesced. Of the slots past the list's total, whose rows are
// all alike, only the last writes a scratch row.
//
// vertex_stage_kernel<1>, the triangle phase: the lists' triangle slots in
// one grid, split by block as the vertex phase's. A triangle slot finds its
// draw over the triangle prefixes of the table, reads its three indices,
// forms row3 (the vertex slots of its corners, row_ok, clamped to [0,
// v_cap)), pair_inst, scene_tri, pair_valid, double_sided (the material's
// flag bit 2) and lightmapped, and writes its 32-float packed attribute row
// (ops/geometry.py pack_attrs) from its corners' w1 and scratch rows
// (those of the list's last slot for a corner past the total), copied by
// their bits (a NaN keeps its payload). A warp's 32 packed rows
// go through shared memory (16-B chunks, XOR-swizzled against bank
// conflicts) so that each store instruction writes 512 contiguous bytes.
//
// Padding: every slot past its list's total gets the same row (owner 0,
// scene vertex 0 or scene triangle 0, pair_valid false). A block that holds
// such slots computes that row once, by the thread of its last slot (one of
// them), into shared memory, and its other padding slots store it. (The
// headline's static list has 16,060 triangles in 32,768 slots.)
//
// view_setup_kernel: one triangle slot of one view, over up to two lists'
// stages (each list's slots in whole blocks), written into one table (the
// first list's rows first). Each corner's clip coordinates are
// clip_transform's four products and three sums of its w1 row, computed
// inline rather than gathered from a per-vertex clip table; then
// _setup_from_clip with vertex_ids (each edge's products in the corners' id
// order, times the orientation sign): the setup row (16 f32, staged through
// shared memory as the packed rows), valid and bbox (4 i32), and, into an
// `out`, the slot's tri_id and inst_id. The first thread writes the lists'
// num_valid summed (int32, wrapping, as torch's add). The view-projection
// matrix is read through a device pointer (a CUDA graph's input buffer,
// which a new pose overwrites).
//
// view_setup_kernel(const ParticleQuadArgs), the particle billboards: what
// ops/particles.py particle_geometry computes (the JAX package's
// superconductor_tpu/ops/particles.py:42, in XLA; the port's torch chain,
// about 310 operations a view, stays as particle_geometry_plain). One
// block, a thread a particle (the frames hold 16 to 64): its centre and
// four corners through the view, the projection and the inverse view
// (clip_transform's order), its two triangles (0, 1, 2) at row i and (0,
// 2, 3) at row n + i through setup_row with the corners' ids 4i + k (the
// quad's diagonal watertight), double-sided, and each triangle's ids, corner
// uvs and world positions and 32-float packed shading row; num_valid the
// block's count of valid triangles (an int32 sum, exact in any order). A
// few kilobytes a frame: one launch at the dispatch floor.
//
// A frame so runs 2 vertex-stage launches (both lists) and 1 setup launch
// a view (a first design of these kernels ran a vertex-stage launch a list,
// whose triangle slots computed their corners' vertices again, a setup
// launch a list a view, and a torch add of the two counts).
//
// What bounds both on this card: bytes. A vertex slot reads 40 B (32 with
// no lightmap uvs; skinning adds 32 B and its palette rows) and writes 16
// B; a triangle slot reads 16 B and writes 151 B; a view's triangle slot
// reads 14 B and its corners' w1 rows (each vertex once: 16 B a vertex
// slot) and writes 81 B (into a merged table 16 B more, its tri_id and
// inst_id read and written). At the frames' capacities that is about 7 MB
// for the headline's vertex stage (32,768 vertex and 32,768 triangle slots
// static, 64 and 64 animated; 2.2 us at 3.35 TB/s), 58 MB for all_passes'
// (262,144 static) and 45 MB for stereo_anim's (131,072 static and 65,536
// skinned), and 4.1 MB, 33 MB and 25 MB a view of edge setup. The
// arithmetic (78 FP32 operations a vertex, 341 more with four joints; 97 a
// triangle's setup and 28 a vertex's clip coordinates) is far under that
// at the card's rate (chip_smoke.py geometry_bytes_ops counts the
// function's bytes and operations, not the kernel's: the scratch rows' 32 B
// a vertex below the total, written and read back through the L2, are the
// kernel's own cost). Measured (chip_smoke.py [geometry]): the merged
// vertex stage of the all-passes and stereo frames at 0.5-0.6 of that
// bound, their setups at about 0.7; the headline's at its two launches'
// floor.
//
// Bit for bit with the torch chains on the card (csrc/torch_exact.cuh):
// every product, sum and quotient in the chain's order, as ops/geometry.py
// and math3d.py write them out: quat_rotate's t = 2 * cross(q.xyz, v) and
// v + w t + cross(q.xyz, t), similarity_apply's t + s * rot, clip's (x m0
// + y m1) + (z m2 + w m3), the edges' (yj wk - yk wj) * sign; torch.cos and
// torch.sin are the math library's cosf and sinf; torch.sum's two 4-term
// reductions in skin_vertices are in the orders torch's CUDA reduction
// adds them (sum4_contiguous, sum4_strided, each term first added to 0);
// 1.0 / clamp_min(w, 1e-6) is a reciprocal times 1.0; width * 0.5 and the
// other Python floats are rounded once to f32; the products by +-1.0 stay
// products (a negation keeps a NaN's payload, a product does not); amin,
// amax and clamp keep a NaN, and the int32 conversion of a NaN is 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "torch_exact.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPackedCols = 32;  // ops/geometry.py pack_attrs
constexpr int kSetupCols = 16;
constexpr int kMaxLists = 2;  // the static and the animated draw list

// Every field 8 bytes, so that ops/geometry.py's ctypes mirrors lay them
// out alike (sc_geometry_args_bytes checks the sizes). Tables are
// contiguous; a row count bounds each table's index as torch's indexing
// does (row_of).
struct ListArgs {
  // the DrawList, (n,) each; sim8 (n, 8)
  long long n;
  const float* sim8;
  const int* first_tri;
  const int* tri_count;
  const int* first_vertex;
  const int* vertex_count;
  const int* joints_offset;
  const int* material;
  const uint8_t* lightmapped;
  const uint8_t* valid;
  long long t_cap;
  long long v_cap;
  // the list's scene tables
  const int* indices;
  long long n_indices;
  const float* positions;  // (., 3)
  long long n_positions;
  const float* normals;  // (., 3)
  long long n_normals;
  const float* uvs;  // (., 2)
  long long n_uvs;
  const float* lm_uvs;  // (., 2), or null: zeros
  long long n_lm_uvs;
  const int* tri_material;
  long long n_tri_material;
  // skinning: the palette (., 8), or null: no skinning
  const float* palette;
  long long n_palette;
  const int* joint_indices;  // (., 4)
  long long n_joint_indices;
  const float* joint_weights;  // (., 4)
  long long n_joint_weights;
  // the vertex phase's scratch for the triangle phase
  int* ends;  // (2n,): the vertex count prefixes, then the triangle ones
  float* corner;  // (2 v_cap, 4): normal and u, then v, lightmap uv and a pad
  // results
  float* w1;  // (v_cap, 4)
  int* row3;  // (t_cap, 3)
  int* pair_inst;
  int* scene_tri;
  uint8_t* pair_valid;
  uint8_t* double_sided;
  int* num_valid;  // ()
  float* packed;  // (t_cap, 32), 16-B aligned
  uint8_t* lightmapped_out;
};

struct VertexArgs {
  long long lists;  // 1 or 2
  // the materials, shared by the lists
  const float* uv_offset;  // (., 2)
  long long n_uv_offset;
  const float* uv_scale;  // (., 2)
  long long n_uv_scale;
  const float* uv_rotation;
  long long n_uv_rotation;
  const int* mat_flags;
  long long n_mat_flags;
  ListArgs list[kMaxLists];
};

struct SetupPart {  // one list's VertexStage
  long long t_cap;
  long long v_rows;  // w1's rows
  const int* row3;  // (t_cap, 3)
  const uint8_t* pair_valid;
  const uint8_t* double_sided;
  const float* w1;  // (v_rows, 4), 16-B aligned
  const int* scene_tri;  // copied into tri_id, where that is not null
  const int* pair_inst;  // copied into inst_id
  const int* num_valid;  // ()
};

struct SetupArgs {
  long long parts;  // 1 or 2
  const float* view_proj;  // (4, 4)
  long long width;
  long long height;
  long long flip_viewport;
  // the parts' rows, the first part's first
  float* setup;  // (rows, 16), 16-B aligned
  uint8_t* valid;
  int* bbox;  // (rows, 4), 16-B aligned
  int* tri_id;  // or null: not written
  int* inst_id;
  int* num_valid;  // (): the parts' num_valid summed, or null: not written
  SetupPart part[kMaxLists];
};

// ops/particles.py particle_geometry's arguments (ops/particles.py
// _QuadArgs mirrors it): the particles' columns, contiguous, (n,) or (n, C);
// the view's three matrices with their element strides; the results, 2n
// rows each (a quad's first triangle at row i, its second at n + i),
// contiguous, the setup and packed rows 16-B aligned
struct ParticleQuadArgs {
  long long n;
  const float* center;  // (n, 3)
  const float* scale;  // (n, 2)
  const uint8_t* valid;
  const float* uv_offset;  // (n, 2)
  const float* uv_scale;  // (n, 2)
  const float* colour;  // (n, 3)
  const float* emissive_colour;  // (n, 3)
  const int* use_emissive_lut;
  const float* lut_y;
  const float* view;
  long long view_s0;
  long long view_s1;
  const float* view_inverse;
  long long vi_s0;
  long long vi_s1;
  const float* projection;
  long long proj_s0;
  long long proj_s1;
  long long width;
  long long height;
  long long flip_viewport;
  float* setup;  // (2n, 16)
  int* bbox;  // (2n, 4)
  uint8_t* tri_valid;
  int* tri_id;
  int* particle;  // TriangleSetup.inst_id and ParticleAttrs.particle
  int* num_valid;  // ()
  float* uv;  // (2n, 3, 2)
  float* world_pos;  // (2n, 3, 3)
  float* packed;  // (2n, 32)
};

__device__ __forceinline__ int isub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
__host__ __device__ __forceinline__ long long blocks_of(long long slots) {
  return (slots + kThreads - 1) / kThreads;
}

// torch.where(valid, count, 0) of draw i
__device__ __forceinline__ int vertex_count_of(const ListArgs& l, long long i) {
  return l.valid[i] ? l.vertex_count[i] : 0;
}
__device__ __forceinline__ int tri_count_of(const ListArgs& l, long long i) {
  return l.valid[i] ? l.tri_count[i] : 0;
}

// The inclusive prefixes of the list's draw vertex counts into ends_v
// (shared memory), by the block's first warp with shuffles; with `table`,
// also the vertex and triangle prefixes into l.ends and the triangle total
// into l.num_valid. Integer sums wrap, so any order gives torch.cumsum's.
__device__ __forceinline__ void draw_prefixes(const ListArgs& l, int* ends_v, bool table) {
  if (threadIdx.x < 32) {
    const int n = (int)l.n, lane = threadIdx.x;
    unsigned carry_v = 0, carry_t = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      unsigned v = i < n ? (unsigned)vertex_count_of(l, i) : 0u;
      unsigned t = i < n && table ? (unsigned)tri_count_of(l, i) : 0u;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned pv = __shfl_up_sync(0xffffffffu, v, d);
        const unsigned pt = __shfl_up_sync(0xffffffffu, t, d);
        if (lane >= d) {
          v += pv;
          t += pt;
        }
      }
      v += carry_v;
      t += carry_t;
      if (i < n) {
        ends_v[i] = (int)v;
        if (table) {
          l.ends[i] = (int)v;
          l.ends[n + i] = (int)t;
        }
      }
      carry_v = __shfl_sync(0xffffffffu, v, 31);
      carry_t = __shfl_sync(0xffffffffu, t, 31);
    }
    if (table && lane == 0) *l.num_valid = (int)carry_t;
  }
  __syncthreads();
}

// torch.searchsorted(ends, val, right=True): its binary search, step for
// step (so that any ends, sorted or not, give its answer)
template <bool Global>
__device__ __forceinline__ int upper_bound(const int* ends, int n, int val) {
  int start = 0, end = n;
  while (start < end) {
    const int mid = start + ((end - start) >> 1);
    const int e = Global ? __ldg(ends + mid) : ends[mid];
    if (!(e > val)) {
      start = mid + 1;
    } else {
      end = mid;
    }
  }
  return start;
}

// math3d.py quat_rotate: t = 2 * cross(q.xyz, v); v + w * t + cross(q.xyz, t)
__device__ __forceinline__ void quat_rotate(const float* q, const float* v, float* r) {
  const float qx = q[0], qy = q[1], qz = q[2], qw = q[3];
  const float tx = mul(2.0f, sub(mul(qy, v[2]), mul(qz, v[1])));
  const float ty = mul(2.0f, sub(mul(qz, v[0]), mul(qx, v[2])));
  const float tz = mul(2.0f, sub(mul(qx, v[1]), mul(qy, v[0])));
  r[0] = add(add(v[0], mul(qw, tx)), sub(mul(qy, tz), mul(qz, ty)));
  r[1] = add(add(v[1], mul(qw, ty)), sub(mul(qz, tx), mul(qx, tz)));
  r[2] = add(add(v[2], mul(qw, tz)), sub(mul(qx, ty), mul(qy, tx)));
}

// math3d.py similarity_apply: t + s * quat_rotate(q, v), sim8 = [t, s, q]
__device__ __forceinline__ void similarity_apply(const float* sim, const float* v, float* r) {
  float rot[3];
  quat_rotate(sim + 4, v, rot);
#pragma unroll
  for (int c = 0; c < 3; ++c) r[c] = add(sim[c], mul(sim[3], rot[c]));
}

// torch.sum(x, dim=-1) of a contiguous (N, 4) table on the card: four
// lanes of a warp take a term each (0 + x), then shuffles down by 2 and 1
__device__ __forceinline__ float sum4_contiguous(const float* x) {
  return add(add(add(0.0f, x[0]), add(0.0f, x[2])), add(add(0.0f, x[1]), add(0.0f, x[3])));
}

// torch.sum(x, dim=-2) of a contiguous (N, 4, 3) table on the card: one
// thread an output, four accumulators (0 + x) combined in turn
__device__ __forceinline__ float sum4_strided(const float* x) {
  return add(add(add(add(0.0f, x[0]), add(0.0f, x[1])), add(0.0f, x[2])), add(0.0f, x[3]));
}

// One vertex slot's rows: w1 (the world position and 1), the normal and u,
// then v, the lightmap uv and a pad
struct VertexRows {
  float4 w1, lo, hi;
};

// One vertex slot p of the vertex stage (ops/geometry.py
// geometry_vertex_stage_plain up to w1): the draw that owns it, its
// gathered attributes, skinning, the draw's transform and the uv transform.
__device__ __forceinline__ VertexRows vertex_at(const VertexArgs& a, const ListArgs& l,
                                                const int* ends_v, int total_v, int p) {
  const int n = (int)l.n;
  const bool ok = p < total_v;
  const long long o = row_of(ok ? upper_bound<false>(ends_v, n, p) : 0, n);
  const int local = isub(p, isub(ends_v[o], vertex_count_of(l, o)));
  const int sv = ok ? iadd(l.first_vertex[o], local) : 0;

  float pos[3], nrm[3];
  const long long rp = row_of(sv, l.n_positions), rn = row_of(sv, l.n_normals);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pos[c] = __ldg(l.positions + 3 * rp + c);
    nrm[c] = __ldg(l.normals + 3 * rn + c);
  }
  const long long ru = row_of(sv, l.n_uvs);
  const float uv0 = __ldg(l.uvs + 2 * ru), uv1 = __ldg(l.uvs + 2 * ru + 1);
  float lm0 = 0.0f, lm1 = 0.0f;
  if (l.lm_uvs) {
    const long long rl = row_of(sv, l.n_lm_uvs);
    lm0 = __ldg(l.lm_uvs + 2 * rl);
    lm1 = __ldg(l.lm_uvs + 2 * rl + 1);
  }

  if (l.palette) {  // skin_vertices
    const long long ri = row_of(sv, l.n_joint_indices), rw = row_of(sv, l.n_joint_weights);
    const int joff = l.joints_offset[o];
    float jw[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) jw[k] = __ldg(l.joint_weights + 4 * rw + k);
    const float total_w = sum4_contiguous(jw);
    float wp[3][4], wn[3][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float w = quo(jw[k], total_w);
      const int ji = min(max(iadd(__ldg(l.joint_indices + 4 * ri + k), joff), 0),
                         (int)l.n_palette - 1);
      float j[8], pk[3], nk[3];
#pragma unroll
      for (int c = 0; c < 8; ++c) j[c] = __ldg(l.palette + 8 * (long long)ji + c);
      similarity_apply(j, pos, pk);
      quat_rotate(j + 4, nrm, nk);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        wp[c][k] = mul(w, pk[c]);
        wn[c][k] = mul(w, nk[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pos[c] = sum4_strided(wp[c]);
      nrm[c] = sum4_strided(wn[c]);
    }
  }

  float sim[8], world[3], normal[3];
#pragma unroll
  for (int c = 0; c < 8; ++c) sim[c] = __ldg(l.sim8 + 8 * o + c);
  similarity_apply(sim, pos, world);
  quat_rotate(sim + 4, nrm, normal);

  // _uv_transform: offset + rot(rotation) * (scale * uv)
  const int dmat = l.material[o];
  const float rot = __ldg(a.uv_rotation + row_of(dmat, a.n_uv_rotation));
  const float co = cosf(rot), si = sinf(rot);
  const long long rs = row_of(dmat, a.n_uv_scale), rf = row_of(dmat, a.n_uv_offset);
  const float su0 = mul(uv0, __ldg(a.uv_scale + 2 * rs));
  const float su1 = mul(uv1, __ldg(a.uv_scale + 2 * rs + 1));
  const float u = add(__ldg(a.uv_offset + 2 * rf), sub(mul(co, su0), mul(si, su1)));
  const float v = add(__ldg(a.uv_offset + 2 * rf + 1), add(mul(si, su0), mul(co, su1)));
  return {make_float4(world[0], world[1], world[2], 1.0f),
          make_float4(normal[0], normal[1], normal[2], u), make_float4(v, lm0, lm1, 0.0f)};
}

// The vertex phase of list l's block `block`. Where the block holds slots
// past the list's total, its last slot (one of them) computes their row and
// shares it.
__device__ __forceinline__ void vertex_phase(const VertexArgs& a, const ListArgs& l, int block) {
  extern __shared__ int ends_v[];  // (n,)
  __shared__ VertexRows pad;
  draw_prefixes(l, ends_v, block == 0);
  const int total_v = ends_v[l.n - 1];
  const long long first = (long long)block * kThreads;
  const long long last = min(first + kThreads, l.v_cap) - 1;
  const bool has_pad = last >= total_v;
  const long long p = first + threadIdx.x;
  VertexRows r;
  if (p == last || (p < last && p < total_v)) r = vertex_at(a, l, ends_v, total_v, (int)p);
  if (has_pad) {
    if (p == last) pad = r;
    __syncthreads();
    if (p < last && p >= total_v) r = pad;
  }
  if (p >= l.v_cap) return;
  reinterpret_cast<float4*>(l.w1)[p] = r.w1;
  if (p < total_v || p == l.v_cap - 1) {  // the padding slots' scratch: the last slot's alone
    reinterpret_cast<float4*>(l.corner)[p] = r.lo;
    reinterpret_cast<float4*>(l.corner)[l.v_cap + p] = r.hi;
  }
}

// One triangle slot's results
struct TriangleRow {
  int r[3], o, st, mat;
  bool pair_valid, double_sided, lightmapped;
};

// Triangle slot t of the triangle phase (expand_draws, row3, the flags),
// over the vertex phase's prefix table
__device__ __forceinline__ TriangleRow triangle_at(const VertexArgs& a, const ListArgs& l,
                                                   int total_v, int total_t, int t) {
  const int n = (int)l.n;
  const int* ends_v = l.ends;
  const int* ends_t = l.ends + n;
  TriangleRow out;
  const bool ok = t < total_t;
  const long long o = row_of(ok ? upper_bound<true>(ends_t, n, t) : 0, n);
  const int local = isub(t, isub(__ldg(ends_t + o), tri_count_of(l, o)));
  const int st = ok ? iadd(l.first_tri[o], local) : 0;

  // the corners' vertex slots
  const int voff = isub(__ldg(ends_v + o), vertex_count_of(l, o));
  const int fv = l.first_vertex[o];
  const int vmax = (int)l.v_cap - 1;
  bool row_ok = true;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int idx = __ldg(l.indices + row_of(iadd(imul(st, 3), c), l.n_indices));
    const int row = iadd(voff, isub(idx, fv));
    row_ok = row_ok && row >= 0 && row < total_v;
    out.r[c] = min(max(row, 0), vmax);
  }
  out.mat = __ldg(l.tri_material + row_of(st, l.n_tri_material));
  out.double_sided = (__ldg(a.mat_flags + row_of(out.mat, a.n_mat_flags)) & 2) != 0;
  out.lightmapped = l.lightmapped[o] != 0;
  out.o = (int)o;
  out.st = st;
  out.pair_valid = ok && row_ok;
  return out;
}

// The packed row of a triangle: world_pos (3 x 3) | normal (3 x 3) | uv
// (3 x 2) | lm_uv (3 x 2) | material's bits | lightmapped, its corners'
// values copied from their w1 and scratch rows
__device__ __forceinline__ void packed_row(const ListArgs& l, const TriangleRow& t, int total_v,
                                          float4* row4) {
  float row[kPackedCols];
  const float4* w1 = reinterpret_cast<const float4*>(l.w1);
  const float4* corner = reinterpret_cast<const float4*>(l.corner);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // a padding slot's rows are the last slot's (vertex_phase wrote the
    // scratch of no other padding slot)
    const long long r = t.r[c] < total_v ? t.r[c] : l.v_cap - 1;
    const float4 w = __ldg(w1 + r);
    const float4 lo = __ldg(corner + r);
    const float4 hi = __ldg(corner + l.v_cap + r);
    row[3 * c] = w.x;
    row[3 * c + 1] = w.y;
    row[3 * c + 2] = w.z;
    row[9 + 3 * c] = lo.x;
    row[9 + 3 * c + 1] = lo.y;
    row[9 + 3 * c + 2] = lo.z;
    row[18 + 2 * c] = lo.w;
    row[19 + 2 * c] = hi.x;
    row[24 + 2 * c] = hi.y;
    row[25 + 2 * c] = hi.z;
  }
  row[30] = __int_as_float(t.mat);
  row[31] = t.lightmapped ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 0; k < kPackedCols / 4; ++k) {
    row4[k] = make_float4(row[4 * k], row[4 * k + 1], row[4 * k + 2], row[4 * k + 3]);
  }
}

// A warp's rows of C float4 chunks (C = 8 or 4) stored to dst's rows
// [first, first + rows) through the warp's staging area in shared memory:
// lane i's chunk k at i * C + (k ^ swz(i)), where swz spreads a quarter
// warp's chunks over every bank both ways; then each store instruction
// writes 32 consecutive chunks.
template <int C>
__device__ __forceinline__ int swizzle(int row) {
  return C == 8 ? (row & 7) : ((row >> 1) & 3);
}

template <int C>
__device__ __forceinline__ void store_rows(float4* stage, const float4* chunks, float4* dst,
                                           long long first, long long rows) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < C; ++k) stage[lane * C + (k ^ swizzle<C>(lane))] = chunks[k];
  __syncwarp();
  float4* out = dst + first * C;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int idx = k * 32 + lane, r = idx / C, c = idx % C;
    if (r < rows) out[idx] = stage[r * C + (c ^ swizzle<C>(r))];
  }
}

// The triangle phase of list l's block `block`; the padding row as in
// vertex_phase
__device__ __forceinline__ void triangle_phase(const VertexArgs& a, const ListArgs& l,
                                               int block) {
  __shared__ float4 stage[kThreads * kPackedCols / 4];
  __shared__ TriangleRow pad_tri;
  __shared__ float4 pad_row[kPackedCols / 4];
  const int n = (int)l.n;
  const int total_v = __ldg(l.ends + n - 1), total_t = __ldg(l.ends + 2 * n - 1);
  const long long first = (long long)block * kThreads;
  const long long last = min(first + kThreads, l.t_cap) - 1;
  const bool has_pad = last >= total_t;
  const long long t = first + threadIdx.x;
  TriangleRow tri;
  float4 row4[kPackedCols / 4];
  if (t == last || (t < last && t < total_t)) {
    tri = triangle_at(a, l, total_v, total_t, (int)t);
    packed_row(l, tri, total_v, row4);
  }
  if (has_pad) {
    if (t == last) {
      pad_tri = tri;
#pragma unroll
      for (int k = 0; k < kPackedCols / 4; ++k) pad_row[k] = row4[k];
    }
    __syncthreads();
    if (t < last && t >= total_t) {
      tri = pad_tri;
#pragma unroll
      for (int k = 0; k < kPackedCols / 4; ++k) row4[k] = pad_row[k];
    }
  }
  const long long warp_first = first + (threadIdx.x & ~31);
  if (warp_first >= l.t_cap) return;  // the whole warp past the capacity
  if (t < l.t_cap) {
    l.row3[3 * t] = tri.r[0];
    l.row3[3 * t + 1] = tri.r[1];
    l.row3[3 * t + 2] = tri.r[2];
    l.pair_inst[t] = tri.o;
    l.scene_tri[t] = tri.st;
    l.pair_valid[t] = tri.pair_valid;
    l.double_sided[t] = tri.double_sided;
    l.lightmapped_out[t] = tri.lightmapped;
  }
  store_rows<kPackedCols / 4>(stage + (threadIdx.x & ~31) * (kPackedCols / 4), row4,
                              reinterpret_cast<float4*>(l.packed), warp_first,
                              min(32LL, l.t_cap - warp_first));
}

// Phase 0, the vertex phase; 1, the triangle phase. The last list's
// blocks come first (the animated list's: a skinned vertex takes the
// longest, so its blocks start early rather than form the tail); the list
// is uniform over a block.
template <int Phase>
__global__ void __launch_bounds__(kThreads) vertex_stage_kernel(const VertexArgs a) {
  const ListArgs& last = a.list[kMaxLists - 1];
  const long long last_blocks = blocks_of(Phase == 0 ? last.v_cap : last.t_cap);
  const int b = (int)blockIdx.x;
  if (a.lists > 1 && b < last_blocks) {
    if (Phase == 0) {
      vertex_phase(a, last, b);
    } else {
      triangle_phase(a, last, b);
    }
  } else {
    const int first = a.lists > 1 ? b - (int)last_blocks : b;
    if (Phase == 0) {
      vertex_phase(a, a.list[0], first);
    } else {
      triangle_phase(a, a.list[0], first);
    }
  }
}

// amin / amax of three values, a NaN kept
__device__ __forceinline__ float min3(float a, float b, float c) {
  return minimum(minimum(a, b), c);
}
__device__ __forceinline__ float max3(float a, float b, float c) {
  return maximum(maximum(a, b), c);
}

// A corner's viewport coordinates (x + w) * width / 2, (w - y) * height / 2
// (y negated with flip_viewport), its clip z and w, from its clip coordinates
__device__ __forceinline__ void viewport_corner(const float* clip, bool flip_viewport,
                                                float half_w, float half_h, float& xv,
                                                float& yv, float& zc, float& wc) {
  const float yc = flip_viewport ? -clip[1] : clip[1];
  zc = clip[2];
  wc = clip[3];
  xv = mul(add(clip[0], wc), half_w);
  yv = mul(sub(wc, yc), half_h);
}

// _setup_from_clip with vertex_ids on one triangle, from its corners' ids
// and viewport coordinates (viewport_corner): the setup row r (16 f32), and
// into *valid_out and *bbox_out its valid flag (*pair_valid, kept by its
// facing or *double_sided (null: double-sided), det != 0, in front of the
// eye in part, on screen) and its bbox (4 i32). The two flags are read, and
// the results stored, where the chain needs them: fewer live registers in
// view_setup_kernel's 40. Returns the valid flag.
__device__ __forceinline__ bool setup_row(const int* ids, const float* xv, const float* yv,
                                          const float* zc, const float* wc,
                                          const uint8_t* pair_valid,
                                          const uint8_t* double_sided, long long width,
                                          long long height, float* r, uint8_t* valid_out,
                                          int4* bbox_out) {
  // _setup_from_clip's edge_coeffs with vertex_ids: edges (1, 2), (2, 0), (0, 1)
  float e[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j0 = (i + 1) % 3, k0 = (i + 2) % 3;
    const bool swap = ids[j0] > ids[k0];
    const float sign = swap ? -1.0f : 1.0f;
    const int j = swap ? k0 : j0, k = swap ? j0 : k0;
    e[3 * i] = mul(sub(mul(yv[j], wc[k]), mul(yv[k], wc[j])), sign);
    e[3 * i + 1] = mul(sub(mul(wc[j], xv[k]), mul(wc[k], xv[j])), sign);
    e[3 * i + 2] = mul(sub(mul(xv[j], yv[k]), mul(xv[k], yv[j])), sign);
  }
  const float det = add(add(mul(xv[0], e[0]), mul(yv[0], e[1])), mul(wc[0], e[2]));
  const bool front = det < 0.0f;
  const bool keep = front || double_sided == nullptr || *double_sided != 0;
  const float flip = front ? -1.0f : 1.0f;
  bool valid = *pair_valid != 0 && keep && det != 0.0f;

#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = mul(e[k], flip);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r[9 + c] = zc[c];
    r[12 + c] = wc[c];
  }
  r[15] = front ? 0.0f : 1.0f;  // FLAG_BACKFACING

  // the bbox of the corners in front of the eye
  const float eps = 1e-6f, big = 1e9f;
  bool w_ok[3];
  float px[3], py[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    w_ok[c] = wc[c] > eps;
    const float inv_w = w_ok[c] ? recip_times_one(clamp_min(wc[c], eps)) : 0.0f;
    px[c] = mul(xv[c], inv_w);
    py[c] = mul(yv[c], inv_w);
  }
  const float wf = (float)(width - 1), hf = (float)(height - 1);
  float x0 = min3(w_ok[0] ? px[0] : big, w_ok[1] ? px[1] : big, w_ok[2] ? px[2] : big);
  float x1 = max3(w_ok[0] ? px[0] : -big, w_ok[1] ? px[1] : -big, w_ok[2] ? px[2] : -big);
  float y0 = min3(w_ok[0] ? py[0] : big, w_ok[1] ? py[1] : big, w_ok[2] ? py[2] : big);
  float y1 = max3(w_ok[0] ? py[0] : -big, w_ok[1] ? py[1] : -big, w_ok[2] ? py[2] : -big);
  const bool any_behind = !(w_ok[0] && w_ok[1] && w_ok[2]);
  const bool all_behind = !(w_ok[0] || w_ok[1] || w_ok[2]);
  if (any_behind) {
    x0 = 0.0f;
    y0 = 0.0f;
    x1 = wf;
    y1 = hf;
  }
  valid = valid && !all_behind;
  const bool offscreen = x1 < 0.0f || y1 < 0.0f || x0 > wf || y0 > hf;
  valid = valid && !offscreen;
  *valid_out = valid;
  *bbox_out = make_int4(to_i32(clamp(floorf(sub(x0, 0.5f)), 0.0f, wf)),
                        to_i32(clamp(floorf(sub(y0, 0.5f)), 0.0f, hf)),
                        to_i32(clamp(ceilf(add(x1, 0.5f)), 0.0f, wf)),
                        to_i32(clamp(ceilf(add(y1, 0.5f)), 0.0f, hf)));
  return valid;
}

// clip_transform of one row (x, y, z, w) by a row-major 4 x 4 m: (x m0 +
// y m1) + (z m2 + w m3) a column
__device__ __forceinline__ void clip_row(float x, float y, float z, float w, const float* m,
                                         float* out) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[j] = add(add(mul(x, m[4 * j]), mul(y, m[4 * j + 1])),
                 add(mul(z, m[4 * j + 2]), mul(w, m[4 * j + 3])));
  }
}

// Triangle slot t of part p, written at row `row` of the table
__device__ __forceinline__ void setup_slot(const SetupArgs& a, const SetupPart& p, long long t,
                                           long long row, float4* stage, long long warp_row,
                                           long long warp_rows) {
  float4 chunks[kSetupCols / 4];
  if (t < p.t_cap) {
    float m[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) m[k] = __ldg(a.view_proj + k);
    const float half_w = (float)(a.width * 0.5), half_h = (float)(a.height * 0.5);
    int ids[3];
    float xv[3], yv[3], zc[3], wc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ids[c] = __ldg(p.row3 + 3 * t + c);
      const float4 q = __ldg(reinterpret_cast<const float4*>(p.w1) + row_of(ids[c], p.v_rows));
      float clip[4];
      clip_row(q.x, q.y, q.z, q.w, m, clip);
      viewport_corner(clip, a.flip_viewport != 0, half_w, half_h, xv[c], yv[c], zc[c], wc[c]);
    }
    float r[kSetupCols];
    setup_row(ids, xv, yv, zc, wc, p.pair_valid + t, p.double_sided + t, a.width, a.height, r,
              a.valid + row, reinterpret_cast<int4*>(a.bbox) + row);
#pragma unroll
    for (int k = 0; k < kSetupCols / 4; ++k) {
      chunks[k] = make_float4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
    }
    if (a.tri_id) {
      a.tri_id[row] = p.scene_tri[t];
      a.inst_id[row] = p.pair_inst[t];
    }
  }
  store_rows<kSetupCols / 4>(stage, chunks, reinterpret_cast<float4*>(a.setup), warp_row,
                             warp_rows);
}

// Block `block` of part p, whose rows start at row `offset` of the table
__device__ __forceinline__ void setup_block(const SetupArgs& a, const SetupPart& p,
                                            long long offset, long long block) {
  __shared__ float4 stage[kThreads * kSetupCols / 4];
  const long long first = block * kThreads;
  const long long warp_first = first + (threadIdx.x & ~31);
  if (warp_first >= p.t_cap) return;  // the whole warp past the part's slots
  setup_slot(a, p, first + threadIdx.x, offset + first + threadIdx.x,
             stage + (threadIdx.x & ~31) * (kSetupCols / 4), offset + warp_first,
             min(32LL, p.t_cap - warp_first));
}

// One launch a view: the first part's slots in the first blocks; the part
// is uniform over a block. Six blocks an SM: 40 registers a thread (the
// compiler's choice, 58, allows four; a few more blocks in flight hide more
// of the corners' gather latency, a few percent at the frames' sites)
__global__ void __launch_bounds__(kThreads, 6) view_setup_kernel(const SetupArgs a) {
  if (a.num_valid && blockIdx.x == 0 && threadIdx.x == 0) {
    int sum = *a.part[0].num_valid;
    if (a.parts > 1) sum = iadd(sum, *a.part[1].num_valid);
    *a.num_valid = sum;
  }
  const long long first_blocks = blocks_of(a.part[0].t_cap);
  if (a.parts > 1 && blockIdx.x >= first_blocks) {
    setup_block(a, a.part[1], a.part[0].t_cap, blockIdx.x - first_blocks);
  } else {
    setup_block(a, a.part[0], 0, blockIdx.x);
  }
}


// --- The particle billboards ----------------------------------------------

// m (4 x 4 at element strides s0, s1) into registers, row-major
__device__ __forceinline__ void load_matrix(const float* m, long long s0, long long s1,
                                            float* out) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) out[4 * j + k] = __ldg(m + j * s0 + k * s1);
}

// Particle i's quad: its four corners (x, y in {-0.5, 0.5} scaled, in view
// space about its centre) through the projection and the inverse view, its
// two triangles (0, 1, 2) at row i and (0, 2, 3) at row n + i, each with
// its setup row, valid, bbox, ids, corner uvs and world positions and
// packed shading row. Returns how many of the two are valid.
__device__ __forceinline__ int particle_quad(const ParticleQuadArgs& a, long long i,
                                             const float* view, const float* vinv,
                                             const float* proj) {
  const float cx[4] = {-0.5f, 0.5f, 0.5f, -0.5f}, cy[4] = {-0.5f, -0.5f, 0.5f, 0.5f};
  float vc[4];
  clip_row(__ldg(a.center + 3 * i), __ldg(a.center + 3 * i + 1), __ldg(a.center + 3 * i + 2),
           1.0f, view, vc);
  const float sx = __ldg(a.scale + 2 * i), sy = __ldg(a.scale + 2 * i + 1);
  const float uox = __ldg(a.uv_offset + 2 * i), uoy = __ldg(a.uv_offset + 2 * i + 1);
  const float usx = __ldg(a.uv_scale + 2 * i), usy = __ldg(a.uv_scale + 2 * i + 1);
  float clip[4][4], world[4][4], uv[4][2];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float x = add(vc[0], mul(sx, cx[k])), y = add(vc[1], mul(sy, cy[k]));
    const float z = add(vc[2], 0.0f);
    clip_row(x, y, z, 1.0f, proj, clip[k]);
    clip_row(x, y, z, 1.0f, vinv, world[k]);
    uv[k][0] = add(uox, mul(add(cx[k], 0.5f), usx));
    uv[k][1] = add(uoy, mul(sub(0.5f, cy[k]), usy));
  }
  const float lut = __ldg(a.use_emissive_lut + i) != 0 ? __ldg(a.lut_y + i) : -1.0f;
  const float half_w = (float)(a.width * 0.5), half_h = (float)(a.height * 0.5);
  const int corners[2][3] = {{0, 1, 2}, {0, 2, 3}};
  int kept = 0;
#pragma unroll
  for (int tri = 0; tri < 2; ++tri) {
    const long long row = tri * a.n + i;
    int ids[3];
    float xv[3], yv[3], zc[3], wc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int k = corners[tri][c];
      ids[c] = iadd(imul((int)i, 4), k);
      viewport_corner(clip[k], a.flip_viewport != 0, half_w, half_h, xv[c], yv[c], zc[c],
                      wc[c]);
    }
    float r[kSetupCols];
    kept += setup_row(ids, xv, yv, zc, wc, a.valid + i, nullptr, a.width, a.height, r,
                      a.tri_valid + row, reinterpret_cast<int4*>(a.bbox) + row);
    float4* setup4 = reinterpret_cast<float4*>(a.setup) + row * (kSetupCols / 4);
#pragma unroll
    for (int k = 0; k < kSetupCols / 4; ++k)
      setup4[k] = make_float4(r[4 * k], r[4 * k + 1], r[4 * k + 2], r[4 * k + 3]);
    a.tri_id[row] = (int)row;
    a.particle[row] = (int)i;

    // the packed row: edges (9) | uv (6) | world_pos (9) | colour (3) |
    // emissive colour (3) | lut_y or -1 | which corner is diagonal to corner 0
    float pk[kPackedCols];
#pragma unroll
    for (int k = 0; k < 9; ++k) pk[k] = r[k];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int k = corners[tri][c];
      pk[9 + 2 * c] = a.uv[row * 6 + 2 * c] = uv[k][0];
      pk[10 + 2 * c] = a.uv[row * 6 + 2 * c + 1] = uv[k][1];
#pragma unroll
      for (int j = 0; j < 3; ++j) pk[15 + 3 * c + j] = a.world_pos[row * 9 + 3 * c + j] = world[k][j];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pk[24 + c] = __ldg(a.colour + 3 * i + c);
      pk[27 + c] = __ldg(a.emissive_colour + 3 * i + c);
    }
    pk[30] = lut;
    pk[31] = tri == 0 ? 0.0f : 1.0f;
    float4* packed4 = reinterpret_cast<float4*>(a.packed) + row * (kPackedCols / 4);
#pragma unroll
    for (int k = 0; k < kPackedCols / 4; ++k)
      packed4[k] = make_float4(pk[4 * k], pk[4 * k + 1], pk[4 * k + 2], pk[4 * k + 3]);
  }
  return kept;
}

// One block: a thread a particle (a frame holds 16 to 64 of them; past the
// block's threads a thread takes every kThreads-th), num_valid the block's
// count of valid triangles (an int32 sum, exact in any order)
__global__ void __launch_bounds__(kThreads) view_setup_kernel(const ParticleQuadArgs a) {
  __shared__ int count;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  float view[16], vinv[16], proj[16];
  load_matrix(a.view, a.view_s0, a.view_s1, view);
  load_matrix(a.view_inverse, a.vi_s0, a.vi_s1, vinv);
  load_matrix(a.projection, a.proj_s0, a.proj_s1, proj);
  int kept = 0;
  for (long long i = threadIdx.x; i < a.n; i += kThreads) kept += particle_quad(a, i, view, vinv, proj);
  atomicAdd(&count, kept);
  __syncthreads();
  if (threadIdx.x == 0) *a.num_valid = count;
}
}  // namespace

// The C entry points (ops/geometry.py binds them with ctypes): each takes
// the address of its arguments' host struct (a VertexArgs or a SetupArgs;
// void, since a type of this file's unnamed namespace in the signature
// would keep the symbol out of the library) and launches on `stream`; the
// result is the first failed launch's cudaError_t, else cudaSuccess.

// sizeof(VertexArgs) (which 0), sizeof(SetupArgs) (1), sizeof(ListArgs)
// (2), sizeof(SetupPart) (3) or sizeof(ParticleQuadArgs) (4), for the
// binding's check of its mirrors
extern "C" int sc_geometry_args_bytes(int which) {
  switch (which) {
    case 0:
      return (int)sizeof(VertexArgs);
    case 1:
      return (int)sizeof(SetupArgs);
    case 2:
      return (int)sizeof(ListArgs);
    case 3:
      return (int)sizeof(SetupPart);
    default:
      return (int)sizeof(ParticleQuadArgs);
  }
}

// The vertex phase, then the triangle phase, over the lists' slots
extern "C" int sc_vertex_stage(const void* args, void* stream) {
  const VertexArgs a = *static_cast<const VertexArgs*>(args);
  long long vertex_blocks = 0, triangle_blocks = 0, n = 0;
  for (int l = 0; l < a.lists; ++l) {
    vertex_blocks += blocks_of(a.list[l].v_cap);
    triangle_blocks += blocks_of(a.list[l].t_cap);
    n = n > a.list[l].n ? n : a.list[l].n;
  }
  const size_t smem = sizeof(int) * (size_t)n;  // the vertex phase's prefixes
  if (smem + sizeof(VertexRows) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vertex_stage_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  vertex_stage_kernel<0><<<(unsigned)vertex_blocks, kThreads, smem, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vertex_stage_kernel<1><<<(unsigned)triangle_blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int sc_view_setup(const void* args, void* stream) {
  const SetupArgs a = *static_cast<const SetupArgs*>(args);
  long long blocks = 0;
  for (int p = 0; p < a.parts; ++p) blocks += blocks_of(a.part[p].t_cap);
  view_setup_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ops/particles.py particle_geometry's kernel: one block for every particle
extern "C" int sc_particle_quads(const void* args, void* stream) {
  const ParticleQuadArgs a = *static_cast<const ParticleQuadArgs*>(args);
  view_setup_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
