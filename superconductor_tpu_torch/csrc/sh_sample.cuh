// The SH lookup on the SH-interleaved pools, a lane at a time: what
// ops/shade.py sample_spherical_harmonics computes where each bound texture
// set has its pool (upload.sh_pool) and its static dims, bit for bit with
// the torch chain on the card. csrc/shade.cu's two kernels share it: the
// deferred shade at the g-buffer's world position, lm_uv and lightmapped,
// the particle shade at the lane's interpolated position with lm_uv 0 and
// lightmapped false (render/frame.py's stand-in g-buffer).
//
// Per lane, in the chain's order:
// * the light volume: rescaled = (world_pos - probes_bottom_left) /
//   probes_scale (the IEEE quotient of two device tensors), then
//   ops/texture.py sample_lightvol_sh: _sh_plane_index on x and y
//   (x = u * w - 0.5, floor, the fraction, the f32 -> i32 conversion,
//   clamped to [0, w - 1], the fraction zeroed at the negative edge),
//   _layer_pair on z (the layer clamped, its fraction not), two taps of the
//   (w*h*z, 48) f16 pool widened to f32 and _lerp4'd, then
//   tap(zi) * (1 - fz) + tap(zi1) * fz;
// * the lightmaps: sample_lightmap_sh, one tap at lm_uv;
// * where both are bound, the lightmaps where the lane is lightmapped, else
//   the volume (torch.where: only the chosen one is computed here);
// * unpack: L0 as it is, each L1 band t * (float)(255 / 127) +
//   (float)(-128 / 127).
// A pool row is the texel's 2x2 footprint corner-major ([t00: L0 Lx Ly Lz
// rgb][t10][t01][t11]), so the four corners of a tap are one 96-B row.
// probes_bottom_left and probes_scale are read through device pointers (a
// CUDA graph's input buffers, which a new pose overwrites).

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "torch_exact.cuh"

namespace {

constexpr int kShRowHalves = 48;  // 4 corners x 4 bands x rgb, f16

// The SH pools of a call, 8 B a field (ops/shade.py _ShPools mirrors it).
// A null pool is a texture set that is not bound.
struct ShPools {
  const uint16_t* lv;  // the light volume's (w*h*z, 48) f16 rows
  long long lv_s;      // its row stride in halves
  long long lv_rows;
  long long lv_vec;    // its rows are 16-B aligned
  long long lv_w;
  long long lv_h;
  long long lv_z;
  const uint16_t* lm;  // the lightmaps' (w*h, 48) f16 rows
  long long lm_s;
  long long lm_rows;
  long long lm_vec;
  long long lm_w;
  long long lm_h;
  const float* bl;  // probes_bottom_left (3,)
  long long bl_s;
  const float* scale;  // probes_scale (3,)
  long long scale_s;
};

__device__ __forceinline__ float half_of(uint32_t word, int k) {
  return __half2float(__ushort_as_half((unsigned short)(word >> (16 * k))));
}

// _sh_bilinear of one pool row: the 12 channels of each corner, widened to
// f32, _lerp4'd left to right (t00 (1 - fx) (1 - fy) + t10 fx (1 - fy) +
// t01 (1 - fx) fy + t11 fx fy)
__device__ __forceinline__ void sh_tap(const uint16_t* pool, long long row, long long s,
                                       bool vec, float fx, float fy, float out[12]) {
  const uint16_t* r = pool + row * s;
  uint32_t w[kShRowHalves / 2];
  if (vec) {
#pragma unroll
    for (int k = 0; k < kShRowHalves / 8; ++k) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(r) + k);
      w[4 * k] = q.x;
      w[4 * k + 1] = q.y;
      w[4 * k + 2] = q.z;
      w[4 * k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kShRowHalves / 2; ++k) w[k] = __ldg(reinterpret_cast<const uint32_t*>(r) + k);
  }
#pragma unroll
  for (int c = 0; c < 12; ++c) {
    const int i = c;  // column c of corner j is half 12 j + c
    out[c] = lerp4(half_of(w[i / 2], i & 1), half_of(w[(12 + i) / 2], (12 + i) & 1),
                   half_of(w[(24 + i) / 2], (24 + i) & 1), half_of(w[(36 + i) / 2], (36 + i) & 1),
                   fx, fy);
  }
}

// _sh_plane_index: the texel row of a tap at (u, v) on a w x h pool (CLAMP
// with baked neighbours), its fractions zeroed at the negative edge
__device__ __forceinline__ int sh_plane(float u, float v, int w, int h, float& fx, float& fy) {
  TapPos t = tap_pos(u, v, w, h);
  fx = t.x0 < 0 ? 0.0f : t.fx;
  fy = t.y0 < 0 ? 0.0f : t.fy;
  return iadd(imul(clamp_to(t.y0, h), w), clamp_to(t.x0, w));
}

// sample_spherical_harmonics on the pools at a lane: sh[3 k + c], band k
// (L0, L1x, L1y, L1z) of colour c. At least one pool is bound.
__device__ __forceinline__ void sample_sh(const ShPools& p, const float wp[3], float lu, float lv,
                                          bool lightmapped, float sh[12]) {
  float t12[12];
  if (p.lm != nullptr && (p.lv == nullptr || lightmapped)) {
    float fx, fy;
    const int plane = sh_plane(lu, lv, (int)p.lm_w, (int)p.lm_h, fx, fy);
    sh_tap(p.lm, row_of(plane, p.lm_rows), p.lm_s, p.lm_vec != 0, fx, fy, t12);
  } else {
    float r[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r[j] = quo(sub(wp[j], __ldg(p.bl + j * p.bl_s)), __ldg(p.scale + j * p.scale_s));
    const int w = (int)p.lv_w, h = (int)p.lv_h, zl = (int)p.lv_z;
    float fx, fy;
    const int plane = sh_plane(r[0], r[1], w, h, fx, fy);
    // _layer_pair: z = r2 z_layers - 0.5, both layers clamped, fz = z - floor(z)
    const float z = sub(mul(r[2], (float)zl), 0.5f);
    const float z0 = floorf(z);
    const int zi = clamp_to(to_i32(z0), zl);
    const int zi1 = clamp_to(iadd(zi, 1), zl);
    const float fz = sub(z, z0);
    const int wh = imul(w, h);
    float b[12];
    sh_tap(p.lv, row_of(iadd(imul(zi, wh), plane), p.lv_rows), p.lv_s, p.lv_vec != 0, fx, fy,
           t12);
    sh_tap(p.lv, row_of(iadd(imul(zi1, wh), plane), p.lv_rows), p.lv_s, p.lv_vec != 0, fx, fy,
           b);
    const float gz = sub(1.0f, fz);
#pragma unroll
    for (int c = 0; c < 12; ++c) t12[c] = add(mul(t12[c], gz), mul(b[c], fz));
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) sh[c] = t12[c];
#pragma unroll
  for (int c = 3; c < 12; ++c)
    sh[c] = add(mul(t12[c], (float)(255.0 / 127.0)), (float)(-128.0 / 127.0));
}

}  // namespace
