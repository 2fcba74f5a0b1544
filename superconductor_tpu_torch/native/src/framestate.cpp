// Per-frame draw-list building: the hot host runtime loop in native code.
//
// C++ twin of the vectorized numpy path in render/draws.py::build_frame_state
// (itself the analog of the reference's push_entity_instances hot loop,
// src/systems.rs:204-332). For every (instance x primitive) candidate:
// compose the instance and primitive Similarity transforms, frustum-cull the
// bounding sphere against each view's planes (union across views, matching
// resources.rs:166-184's one-or-two-eye params), select the screen-coverage
// LOD, and pack visible candidates into compact static/animated draw rows.
//
// Float expression order deliberately mirrors math3d.py (quat_mul,
// quat_rotate, similarity_compose8) so results match the numpy path to the
// last ulp in practice; the test suite asserts equality on every column.

#include <cmath>
#include <cstdint>

namespace {

struct Sim8 {
  float tx, ty, tz, s, qx, qy, qz, qw;
};

// quat_rotate (math3d.py:64): t = 2*cross(q.xyz, v); v' = v + w*t + cross(q.xyz, t)
inline void quat_rotate(const float* q, const float* v, float* out) {
  const float qx = q[0], qy = q[1], qz = q[2], qw = q[3];
  const float tx = 2.0f * (qy * v[2] - qz * v[1]);
  const float ty = 2.0f * (qz * v[0] - qx * v[2]);
  const float tz = 2.0f * (qx * v[1] - qy * v[0]);
  out[0] = v[0] + qw * tx + (qy * tz - qz * ty);
  out[1] = v[1] + qw * ty + (qz * tx - qx * tz);
  out[2] = v[2] + qw * tz + (qx * ty - qy * tx);
}

// similarity_compose8 (math3d.py:268): result applies b first, then a.
inline void compose8(const float* a, const float* b, float* out) {
  float r[3];
  quat_rotate(a + 4, b, r);  // rotate b.translation by a.rotation
  out[0] = a[0] + a[3] * r[0];
  out[1] = a[1] + a[3] * r[1];
  out[2] = a[2] + a[3] * r[2];
  out[3] = a[3] * b[3];
  // Hamilton product a.q * b.q (math3d.py:43)
  const float ax = a[4], ay = a[5], az = a[6], aw = a[7];
  const float bx = b[4], by = b[5], bz = b[6], bw = b[7];
  out[4] = aw * bx + ax * bw + ay * bz - az * by;
  out[5] = aw * by - ax * bz + ay * bw + az * bx;
  out[6] = aw * bz + ax * by - ay * bx + az * bw;
  out[7] = aw * bw - ax * bx - ay * by - az * bz;
}

}  // namespace

extern "C" {

// Returns the candidate count processed. Outputs are compact (row i < the
// returned counts); the caller pads to its pow2 caps.
int32_t sc_build_draws(
    // instances
    int32_t n_inst, const float* inst8 /*(n_inst,8)*/,
    const int32_t* inst_uid /*(n_inst)*/,
    // per-uid ranges into the big primitive tables
    const int32_t* prim_base, const int32_t* prim_counts,
    // big primitive tables (P rows, lmax LOD columns)
    int32_t lmax, const float* prim8, const float* radius,
    const int32_t* material, const uint8_t* animated, const int32_t* n_lods,
    const float* lod_cov, const int32_t* lt_first, const int32_t* lt_count,
    const int32_t* lv_first, const int32_t* lv_count, const uint8_t* lt_lm,
    // culling: n_sets plane sets; set k = planes[set_off[k] .. set_off[k+1])
    // rows of (nx, ny, nz, d); sphere visible in a set iff every plane has
    // dot(n, c) + d >= -r; visible overall iff visible in ANY set (VR union)
    int32_t n_sets, const int32_t* set_off, const float* planes,
    // LOD: when do_lod, lod = #(lod_cov > pi*vr^2/denom) clamped to n_lods-1
    int32_t do_lod, const float* eye3, double denom,
    // outputs: compact rows (allocated n_cand long by the caller)
    float* s_sim8, int32_t* s_first_tri, int32_t* s_tri_count,
    int32_t* s_first_vertex, int32_t* s_vertex_count, int32_t* s_material,
    uint8_t* s_lightmapped, int32_t* s_inst,
    float* a_sim8, int32_t* a_first_tri, int32_t* a_tri_count,
    int32_t* a_first_vertex, int32_t* a_vertex_count, int32_t* a_material,
    uint8_t* a_lightmapped, int32_t* a_inst,
    uint8_t* inst_visible /*(n_inst)*/, int32_t* counts_out /*[2]*/) {
  int32_t n_static = 0, n_anim = 0, n_cand = 0;
  for (int32_t ii = 0; ii < n_inst; ++ii) {
    const float* ia = inst8 + 8 * ii;
    const int32_t uid = inst_uid[ii];
    const int32_t base = prim_base[uid];
    const int32_t count = prim_counts[uid];
    for (int32_t p = base; p < base + count; ++p, ++n_cand) {
      float c8[8];
      compose8(ia, prim8 + 8 * p, c8);
      const float r = c8[3] * radius[p];

      bool visible = true;
      if (n_sets > 0) {
        visible = false;
        for (int32_t k = 0; k < n_sets && !visible; ++k) {
          bool in = true;
          for (int32_t pl = set_off[k]; pl < set_off[k + 1]; ++pl) {
            const float* pw = planes + 4 * pl;
            const float d =
                c8[0] * pw[0] + c8[1] * pw[1] + c8[2] * pw[2] + pw[3];
            if (!(d >= -r)) {
              in = false;
              break;
            }
          }
          visible = in;
        }
      }
      if (!visible) continue;
      inst_visible[ii] = 1;

      int32_t lod = 0;
      if (do_lod) {
        const float dx = c8[0] - eye3[0];
        const float dy = c8[1] - eye3[1];
        const float dz = c8[2] - eye3[2];
        const float d = sqrtf((dx * dx + dy * dy) + dz * dz);
        if (d > 0.0f) {
          const float vr = r / d;
          const float cov = (float)(M_PI * (double)vr * (double)vr / denom);
          const float* pc = lod_cov + (size_t)lmax * p;
          for (int32_t l = 0; l < lmax; ++l) lod += pc[l] > cov;
        }
        const int32_t nl = n_lods[p] - 1;
        if (lod > nl) lod = nl;
      }

      const size_t lp = (size_t)lmax * p + lod;
      if (animated[p]) {
        for (int j = 0; j < 8; ++j) a_sim8[8 * n_anim + j] = c8[j];
        a_first_tri[n_anim] = lt_first[lp];
        a_tri_count[n_anim] = lt_count[lp];
        a_first_vertex[n_anim] = lv_first[lp];
        a_vertex_count[n_anim] = lv_count[lp];
        a_material[n_anim] = material[p];
        a_lightmapped[n_anim] = lt_lm[lp];
        a_inst[n_anim] = ii;
        ++n_anim;
      } else {
        for (int j = 0; j < 8; ++j) s_sim8[8 * n_static + j] = c8[j];
        s_first_tri[n_static] = lt_first[lp];
        s_tri_count[n_static] = lt_count[lp];
        s_first_vertex[n_static] = lv_first[lp];
        s_vertex_count[n_static] = lv_count[lp];
        s_material[n_static] = material[p];
        s_lightmapped[n_static] = lt_lm[lp];
        s_inst[n_static] = ii;
        ++n_static;
      }
    }
  }
  counts_out[0] = n_static;
  counts_out[1] = n_anim;
  return n_cand;
}

}  // extern "C"

extern "C" {

// Parent-first joint hierarchy update (AnimationJoints.update,
// animation.py:138-152): global = parent_global * local over Similarity
// (translation, uniform scale, quaternion), roots copy their locals.
// Links must be ordered parent-before-child. Batched over I instances
// whose SoA arrays are stacked contiguously ((I, N, ...) C-order).
void sc_joint_update(
    int32_t n_inst, int32_t n_nodes,
    int32_t n_roots, const int32_t* roots,
    int32_t n_links, const int32_t* link_parent, const int32_t* link_child,
    const float* lt /*(I,N,3)*/, const float* ls /*(I,N)*/,
    const float* lr /*(I,N,4)*/,
    float* gt, float* gs, float* gr) {
  for (int32_t i = 0; i < n_inst; ++i) {
    const float* ilt = lt + (size_t)i * n_nodes * 3;
    const float* ils = ls + (size_t)i * n_nodes;
    const float* ilr = lr + (size_t)i * n_nodes * 4;
    float* igt = gt + (size_t)i * n_nodes * 3;
    float* igs = gs + (size_t)i * n_nodes;
    float* igr = gr + (size_t)i * n_nodes * 4;
    for (int32_t k = 0; k < n_roots; ++k) {
      const int32_t r = roots[k];
      for (int d = 0; d < 3; ++d) igt[3 * r + d] = ilt[3 * r + d];
      igs[r] = ils[r];
      for (int d = 0; d < 4; ++d) igr[4 * r + d] = ilr[4 * r + d];
    }
    for (int32_t k = 0; k < n_links; ++k) {
      const int32_t p = link_parent[k], c = link_child[k];
      const float ps = igs[p];
      float rotated[3];
      quat_rotate(igr + 4 * p, ilt + 3 * c, rotated);
      for (int d = 0; d < 3; ++d)
        igt[3 * c + d] = igt[3 * p + d] + ps * rotated[d];
      igs[c] = ps * ils[c];
      // Hamilton product parent_q * local_q (math3d.py:43)
      const float ax = igr[4 * p], ay = igr[4 * p + 1], az = igr[4 * p + 2],
                  aw = igr[4 * p + 3];
      const float bx = ilr[4 * c], by = ilr[4 * c + 1], bz = ilr[4 * c + 2],
                  bw = ilr[4 * c + 3];
      igr[4 * c] = aw * bx + ax * bw + ay * bz - az * by;
      igr[4 * c + 1] = aw * by - ax * bz + ay * bw + az * bx;
      igr[4 * c + 2] = aw * bz + ax * by - ay * bx + az * bw;
      igr[4 * c + 3] = aw * bw - ax * bx - ay * by - az * bz;
    }
  }
}

}  // extern "C"

extern "C" {

// Keyframe channel sampling + local-transform writes: the native twin of
// Animation.animate (animation.py:217-229) over Channel.sample
// (animation.py:156-193). Channel meta rows are
// [kind(0=T,1=R,2=S), node, interp(0=STEP,1=LINEAR,2=CUBIC), K, in_off,
// out_off, D] with inputs/outputs concatenated across channels.
// Out-of-range times leave the local value untouched (rest pose), matching
// the Python None semantics.
void sc_anim_sample(
    int32_t n_channels, const int32_t* meta /*(C,7)*/,
    const float* inputs, const float* outputs, float t,
    float* local_t /*(N,3)*/, float* local_s /*(N,)*/,
    float* local_r /*(N,4)*/) {
  for (int32_t c = 0; c < n_channels; ++c) {
    const int32_t* m = meta + 7 * c;
    const int32_t kind = m[0], node = m[1], interp = m[2], K = m[3];
    const float* in = inputs + m[4];
    const float* out = outputs + m[5];
    const int32_t D = m[6];
    // NaN-safe range check: !(t >= x) also rejects NaN times, matching the
    // Python path's None (searchsorted sends NaN past the last key there)
    if (K <= 0 || !(t >= in[0]) || !(t <= in[K - 1])) continue;
    if (K == 1) {  // single key: hold its value (t == in[0] here)
      float v1[4] = {0, 0, 0, 0};
      const float* row = interp == 2 ? out + (size_t)D : out;  // cubic: value row
      for (int d = 0; d < D && d < 4; ++d) v1[d] = row[d];
      if (kind == 0) {
        for (int d = 0; d < 3; ++d) local_t[3 * node + d] = v1[d];
      } else if (kind == 1) {
        for (int d = 0; d < 4; ++d) local_r[4 * node + d] = v1[d];
      } else {
        float mx = v1[0];
        for (int d = 1; d < D && d < 4; ++d) mx = v1[d] > mx ? v1[d] : mx;
        local_s[node] = mx;
      }
      continue;
    }
    // searchsorted(side='right') - 1
    int32_t lo = 0, hi = K;
    while (lo < hi) {
      int32_t mid = (lo + hi) / 2;
      if (in[mid] <= t) lo = mid + 1; else hi = mid;
    }
    int32_t i = lo - 1;
    if (i == K - 1) {
      if (in[i] == t) i -= 1; else continue;
    }
    if (i < 0) continue;  // defensive: can't happen for finite t, K >= 2
    const float prev_t = in[i], next_t = in[i + 1];
    const float delta = next_t - prev_t;
    const float factor = (t - prev_t) / delta;

    float v[4] = {0, 0, 0, 0};
    if (interp == 0) {  // STEP
      for (int d = 0; d < D; ++d) v[d] = out[(size_t)i * D + d];
    } else if (interp == 1) {  // LINEAR
      const float* a = out + (size_t)i * D;
      const float* b = out + (size_t)(i + 1) * D;
      if (D == 4) {
        // glTF quaternion linear = slerp with sign fix (_quat_linear,
        // animation.py:196-208); angle math in double like numpy
        float bb[4] = {b[0], b[1], b[2], b[3]};
        double dot = 0.0;
        for (int d = 0; d < 4; ++d) dot += (double)a[d] * bb[d];
        if (dot < 0.0) {
          for (int d = 0; d < 4; ++d) bb[d] = -bb[d];
          dot = -dot;
        }
        if (dot > 0.9995) {
          double n2 = 0.0;
          for (int d = 0; d < 4; ++d) {
            v[d] = a[d] + (bb[d] - a[d]) * factor;
            n2 += (double)v[d] * v[d];
          }
          const float inv = (float)(1.0 / sqrt(n2));
          for (int d = 0; d < 4; ++d) v[d] *= inv;
        } else {
          if (dot > 1.0) dot = 1.0;
          if (dot < -1.0) dot = -1.0;
          const double theta = acos(dot);
          const double s = sin(theta);
          const double wa = sin((1.0 - factor) * theta) / s;
          const double wb = sin(factor * theta) / s;
          for (int d = 0; d < 4; ++d)
            v[d] = (float)(wa * a[d] + wb * bb[d]);
        }
      } else {
        for (int d = 0; d < D; ++d) v[d] = a[d] + (b[d] - a[d]) * factor;
      }
    } else {  // CUBIC_SPLINE: outputs packed [in_tan, value, out_tan] * K
      const float* p0 = out + (size_t)(i * 3 + 1) * D;
      const float* m0 = out + (size_t)(i * 3 + 2) * D;
      const float* m1 = out + (size_t)(i * 3 + 3) * D;
      const float* p1 = out + (size_t)(i * 3 + 4) * D;
      const float t_ = factor, t2 = t_ * t_, t3 = t2 * t_;
      const float c0 = 2 * t3 - 3 * t2 + 1, c1 = t3 - 2 * t2 + t_;
      const float c2 = -2 * t3 + 3 * t2, c3 = t3 - t2;
      for (int d = 0; d < D; ++d)
        v[d] = c0 * p0[d] + c1 * (m0[d] * delta) + c2 * p1[d]
               + c3 * (m1[d] * delta);
      if (D == 4) {
        float n2 = 0.0f;
        for (int d = 0; d < 4; ++d) n2 += v[d] * v[d];
        const float inv = 1.0f / sqrtf(n2);
        for (int d = 0; d < 4; ++d) v[d] *= inv;
      }
    }

    if (kind == 0) {
      for (int d = 0; d < 3; ++d) local_t[3 * node + d] = v[d];
    } else if (kind == 1) {
      for (int d = 0; d < 4; ++d) local_r[4 * node + d] = v[d];
    } else {
      float mx = v[0];
      for (int d = 1; d < D; ++d) mx = v[d] > mx ? v[d] : mx;
      local_s[node] = mx;
    }
  }
}

}  // extern "C"
