// BC7 (and BC6H, see bc6h.cpp) block decompression.
//
// The reference ships BC7/BC6H assets (lighting/bcn, smoke/burst, noon
// cubemap) and decodes them with basis-universal / a GPU shader
// (granite-shaders/bc6.frag). This is the TPU build's host-side native
// equivalent. Constant tables in bptc_tables.h are derived by probing the
// Mesa software decoder (tools/extract_bptc_tables.py); the implementation
// is validated bit-exactly against that oracle in tests/test_native.py.

#include <cstring>
#include <stdint.h>

#include "bptc_tables.h"

namespace {

struct BitReader {
  const uint8_t* data;
  int pos = 0;
  explicit BitReader(const uint8_t* d) : data(d) {}
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) {
      v |= uint32_t((data[pos >> 3] >> (pos & 7)) & 1) << i;
      pos++;
    }
    return v;
  }
};

static const uint8_t kW2[4] = {0, 21, 43, 64};
static const uint8_t kW3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
static const uint8_t kW4[16] = {0,  4,  9,  13, 17, 21, 26, 30,
                                34, 38, 43, 47, 51, 55, 60, 64};

struct Bc7Mode {
  int ns;          // number of subsets
  int pb;          // partition bits
  int rb;          // rotation bits
  int isb;         // index selection bit
  int cb;          // color bits
  int ab;          // alpha bits
  int epb;         // endpoint P-bits (unique per endpoint)
  int spb;         // shared P-bits (per subset)
  int ib;          // index bits per texel
  int ib2;         // secondary index bits (0 = none)
};

static const Bc7Mode kModes[8] = {
    //ns pb rb isb cb ab epb spb ib ib2
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0},  // mode 0
    {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},  // mode 1
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0},  // mode 2
    {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},  // mode 3
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3},  // mode 4
    {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},  // mode 5
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0},  // mode 6
    {2, 6, 0, 0, 5, 5, 1, 0, 2, 0},  // mode 7
};

inline int unquantize(int v, int bits) {
  if (bits >= 8) return v;
  return (v << (8 - bits)) | (v >> (2 * bits - 8));
}

inline int lerp(int a, int b, int w) { return (a * (64 - w) + b * w + 32) >> 6; }

void decode_bc7_block(const uint8_t* block, uint8_t out[16][4]) {
  BitReader br(block);
  int mode = 0;
  while (mode < 8 && br.read(1) == 0) mode++;
  if (mode == 8) {  // reserved: all zero
    memset(out, 0, 64);
    return;
  }
  const Bc7Mode& m = kModes[mode];
  int partition = m.pb ? br.read(m.pb) : 0;
  int rotation = m.rb ? br.read(m.rb) : 0;
  int index_sel = m.isb ? br.read(m.isb) : 0;

  int nep = m.ns * 2;
  int ep[6][4];  // endpoints x RGBA
  for (int c = 0; c < 3; c++)
    for (int e = 0; e < nep; e++) ep[e][c] = br.read(m.cb);
  if (m.ab)
    for (int e = 0; e < nep; e++) ep[e][3] = br.read(m.ab);
  else
    for (int e = 0; e < nep; e++) ep[e][3] = 255;

  int cbits = m.cb, abits = m.ab;
  if (m.epb) {
    for (int e = 0; e < nep; e++) {
      int p = br.read(1);
      for (int c = 0; c < 3; c++) ep[e][c] = (ep[e][c] << 1) | p;
      if (m.ab) ep[e][3] = (ep[e][3] << 1) | p;
    }
    cbits++;
    if (m.ab) abits++;
  } else if (m.spb) {
    for (int s = 0; s < m.ns; s++) {
      int p = br.read(1);
      for (int e = s * 2; e < s * 2 + 2; e++) {
        for (int c = 0; c < 3; c++) ep[e][c] = (ep[e][c] << 1) | p;
        if (m.ab) ep[e][3] = (ep[e][3] << 1) | p;
      }
    }
    cbits++;
    if (m.ab) abits++;
  }

  for (int e = 0; e < nep; e++) {
    for (int c = 0; c < 3; c++) ep[e][c] = unquantize(ep[e][c], cbits);
    if (m.ab) ep[e][3] = unquantize(ep[e][3], abits);
  }

  // subset + anchor lookup per texel
  const uint8_t* psub = nullptr;
  if (m.ns == 2) psub = kP2[partition];
  if (m.ns == 3) psub = kP3[partition];

  auto is_anchor = [&](int t) {
    if (t == 0) return true;
    if (m.ns == 2) return t == kAnchor2[partition];
    if (m.ns == 3)
      return t == kAnchor3a[partition] || t == kAnchor3b[partition];
    return false;
  };

  // primary indices
  int idx[16], idx2[16];
  for (int t = 0; t < 16; t++)
    idx[t] = br.read(m.ib - (is_anchor(t) ? 1 : 0));
  if (m.ib2)
    for (int t = 0; t < 16; t++) idx2[t] = br.read(m.ib2 - (t == 0 ? 1 : 0));

  const uint8_t* wt = m.ib == 2 ? kW2 : (m.ib == 3 ? kW3 : kW4);
  const uint8_t* wt2 = m.ib2 == 2 ? kW2 : kW3;

  for (int t = 0; t < 16; t++) {
    int s = m.ns == 1 ? 0 : psub[t];
    const int* e0 = ep[s * 2];
    const int* e1 = ep[s * 2 + 1];
    int wc, wa;
    if (m.ib2) {
      // mode 4: index_sel swaps which index stream drives color vs alpha
      int w_lo = wt[idx[t]];
      int w_hi = wt2[idx2[t]];
      wc = index_sel ? w_hi : w_lo;
      wa = index_sel ? w_lo : w_hi;
    } else {
      wc = wa = wt[idx[t]];
    }
    int r = lerp(e0[0], e1[0], wc);
    int g = lerp(e0[1], e1[1], wc);
    int b = lerp(e0[2], e1[2], wc);
    int a = lerp(e0[3], e1[3], wa);
    // rotation: swap alpha with a color channel (modes 4/5)
    switch (rotation) {
      case 1: { int tmp = r; r = a; a = tmp; break; }
      case 2: { int tmp = g; g = a; a = tmp; break; }
      case 3: { int tmp = b; b = a; a = tmp; break; }
    }
    out[t][0] = uint8_t(r);
    out[t][1] = uint8_t(g);
    out[t][2] = uint8_t(b);
    out[t][3] = uint8_t(a);
  }
}

}  // namespace

extern "C" void sc_decode_bc7(const uint8_t* data, int width, int height,
                              uint8_t* out) {
  int bw = (width + 3) / 4;
  int bh = (height + 3) / 4;
  for (int by = 0; by < bh; by++) {
    for (int bx = 0; bx < bw; bx++) {
      uint8_t texels[16][4];
      decode_bc7_block(data + (by * bw + bx) * 16, texels);
      for (int ty = 0; ty < 4; ty++) {
        int y = by * 4 + ty;
        if (y >= height) break;
        for (int tx = 0; tx < 4; tx++) {
          int x = bx * 4 + tx;
          if (x >= width) continue;
          memcpy(out + (y * width + x) * 4, texels[ty * 4 + tx], 4);
        }
      }
    }
  }
}
