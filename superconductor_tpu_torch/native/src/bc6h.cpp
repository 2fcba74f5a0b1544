// BC6H (UF16/SF16) block decompression — the native equivalent of the
// reference's GPU BC6H decoder (granite-shaders/bc6.frag, used via the
// bc6h_decompression pipeline, renderer-core/src/pipelines.rs). Mode
// layouts come from bc6h_layout.h (oracle-derived spec constants);
// validated bit-exactly against Mesa in tests/test_native.py.

#include <cstring>
#include <stdint.h>

#include "bc6h_layout.h"
#include "bptc_tables.h"

namespace {

static const uint8_t kW3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
static const uint8_t kW4[16] = {0,  4,  9,  13, 17, 21, 26, 30,
                                34, 38, 43, 47, 51, 55, 60, 64};

inline int get_bit(const uint8_t* d, int pos) {
  return (d[pos >> 3] >> (pos & 7)) & 1;
}

inline uint32_t read_field(const uint8_t* d, const Bc6hField& f) {
  uint32_t v = 0;
  for (int i = 0; i < f.count; i++) v |= uint32_t(get_bit(d, f.bits[i])) << i;
  return v;
}

inline int sign_extend(uint32_t v, int bits) {
  uint32_t sign = 1u << (bits - 1);
  return int((v ^ sign) - sign);
}

inline int unquantize_u(int v, int bits) {
  if (bits >= 15) return v;
  if (v == 0) return 0;
  if (v == (1 << bits) - 1) return 0xFFFF;
  return ((v << 16) + 0x8000) >> bits;
}

inline int unquantize_s(int v, int bits) {
  if (bits >= 16) return v;
  bool neg = v < 0;
  if (neg) v = -v;
  int unq;
  if (v == 0)
    unq = 0;
  else if (v >= ((1 << (bits - 1)) - 1))
    unq = 0x7FFF;
  else
    unq = ((v << 15) + 0x4000) >> (bits - 1);
  return neg ? -unq : unq;
}

inline uint16_t finish_u(int v) { return uint16_t((v * 31) >> 6); }

inline uint16_t finish_s(int v) {
  v = (v < 0) ? -((-v * 31) >> 5) : (v * 31) >> 5;
  uint16_t s = 0;
  if (v < 0) {
    s = 0x8000;
    v = -v;
  }
  return uint16_t(s | v);
}

inline float half_to_float(uint16_t h) {
  uint32_t sign = uint32_t(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t man = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {
      exp = 127 - 15 + 1;
      while (!(man & 0x400)) {
        man <<= 1;
        exp--;
      }
      man &= 0x3FF;
      bits = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000 | (man << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  memcpy(&out, &bits, 4);
  return out;
}

void decode_bc6h_block(const uint8_t* block, bool signed_fmt,
                       float out[16][4]) {
  int prefix2 = block[0] & 3;
  const Bc6hMode* m = nullptr;
  if (prefix2 < 2) {
    for (int i = 0; i < kNumBc6hModes; i++)
      if (kBc6hModes[i].prefix_len == 2 && kBc6hModes[i].prefix == prefix2)
        m = &kBc6hModes[i];
  } else {
    int prefix5 = block[0] & 31;
    for (int i = 0; i < kNumBc6hModes; i++)
      if (kBc6hModes[i].prefix_len == 5 && kBc6hModes[i].prefix == prefix5)
        m = &kBc6hModes[i];
  }
  if (!m) {  // reserved mode: black per spec
    for (int t = 0; t < 16; t++) {
      out[t][0] = out[t][1] = out[t][2] = 0.0f;
      out[t][3] = 1.0f;
    }
    return;
  }

  int nsub = m->one_region ? 1 : 2;
  int nep = nsub * 2;
  int ep[4][3];
  int mask = (1 << m->epb) - 1;
  for (int c = 0; c < 3; c++) {
    int base = int(read_field(block, m->fields[c * 4 + 0]));
    if (signed_fmt) base = sign_extend(base, m->epb);
    ep[0][c] = base;
    for (int e = 1; e < nep; e++) {
      const Bc6hField& f = m->fields[c * 4 + e];
      uint32_t raw = read_field(block, f);
      if (m->transformed) {
        int delta = sign_extend(raw, f.count);
        ep[e][c] = (base + delta) & mask;
        if (signed_fmt) ep[e][c] = sign_extend(ep[e][c], m->epb);
      } else {
        ep[e][c] = signed_fmt ? sign_extend(raw, m->epb) : int(raw);
      }
    }
  }

  int partition = 0;
  if (!m->one_region)
    for (int i = 0; i < 5; i++)
      partition |= get_bit(block, m->part_bits[i]) << i;

  // Unquantize.
  for (int e = 0; e < nep; e++)
    for (int c = 0; c < 3; c++)
      ep[e][c] = signed_fmt ? unquantize_s(ep[e][c], m->epb)
                            : unquantize_u(ep[e][c], m->epb);

  // Indices.
  int pos = m->one_region ? 65 : 82;
  int ib = m->one_region ? 4 : 3;
  const uint8_t* wt = m->one_region ? kW4 : kW3;
  int anchor2 = m->one_region ? -1 : kAnchor2[partition];
  for (int t = 0; t < 16; t++) {
    int n = ib - ((t == 0 || t == anchor2) ? 1 : 0);
    int idx = 0;
    for (int i = 0; i < n; i++) idx |= get_bit(block, pos++) << i;
    int w = wt[idx];
    int s = m->one_region ? 0 : kP2[partition][t];
    for (int c = 0; c < 3; c++) {
      int a = ep[s * 2][c], b = ep[s * 2 + 1][c];
      int v = (a * (64 - w) + b * w + 32) >> 6;
      uint16_t bits = signed_fmt ? finish_s(v) : finish_u(v);
      out[t][c] = half_to_float(bits);
    }
    out[t][3] = 1.0f;
  }
}

}  // namespace

extern "C" void sc_decode_bc6h(const uint8_t* data, int width, int height,
                               int signed_fmt, float* out) {
  int bw = (width + 3) / 4;
  int bh = (height + 3) / 4;
  for (int by = 0; by < bh; by++) {
    for (int bx = 0; bx < bw; bx++) {
      float texels[16][4];
      decode_bc6h_block(data + (by * bw + bx) * 16, signed_fmt != 0, texels);
      for (int ty = 0; ty < 4; ty++) {
        int y = by * 4 + ty;
        if (y >= height) break;
        for (int tx = 0; tx < 4; tx++) {
          int x = bx * 4 + tx;
          if (x >= width) continue;
          memcpy(out + (y * width + x) * 4, texels[ty * 4 + tx], 16);
        }
      }
    }
  }
}
