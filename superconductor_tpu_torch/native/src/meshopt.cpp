// meshopt vertex/index codec decoders (EXT_meshopt_compression).
//
// Native counterpart of assets/meshopt.py (the reference uses the Rust
// meshopt-decoder port, renderer-core/Cargo.toml:33). Cross-validated
// against the Python implementation by round-trip in tests/test_meshopt.py.

#include <cstring>
#include <stdint.h>

namespace {

constexpr int kByteGroupSize = 16;
constexpr int kBlockSizeBytes = 8192;
constexpr int kBlockMaxVertices = 256;

int block_size(int stride) {
  int result = (kBlockSizeBytes / stride) & ~(kByteGroupSize - 1);
  if (result < kByteGroupSize) result = kByteGroupSize;
  if (result > kBlockMaxVertices) result = kBlockMaxVertices;
  return result;
}

inline uint8_t unzigzag8(uint8_t v) {
  return uint8_t((v >> 1) ^ (0 - (v & 1)));
}

const uint8_t* decode_bytes_group(const uint8_t* data, const uint8_t* end,
                                  uint8_t* out, int sel) {
  switch (sel) {
    case 0:
      memset(out, 0, 16);
      return data;
    case 1: {
      if (data + 4 > end) return nullptr;
      const uint8_t* packed = data;
      data += 4;
      for (int j = 0; j < 16; j++) {
        int v = (packed[j / 4] >> (6 - 2 * (j % 4))) & 3;
        if (v == 3) {
          if (data >= end) return nullptr;
          v = *data++;
        }
        out[j] = uint8_t(v);
      }
      return data;
    }
    case 2: {
      if (data + 8 > end) return nullptr;
      const uint8_t* packed = data;
      data += 8;
      for (int j = 0; j < 16; j++) {
        int v = (packed[j / 2] >> (4 - 4 * (j % 2))) & 15;
        if (v == 15) {
          if (data >= end) return nullptr;
          v = *data++;
        }
        out[j] = uint8_t(v);
      }
      return data;
    }
    default:
      if (data + 16 > end) return nullptr;
      memcpy(out, data, 16);
      return data + 16;
  }
}

const uint8_t* decode_bytes(const uint8_t* data, const uint8_t* end,
                            uint8_t* out, int size) {
  int ngroups = size / kByteGroupSize;
  int header_size = (ngroups + 3) / 4;
  const uint8_t* header = data;
  if (data + header_size > end) return nullptr;
  data += header_size;
  for (int g = 0; g < ngroups; g++) {
    int sel = (header[g / 4] >> ((g % 4) * 2)) & 3;
    data = decode_bytes_group(data, end, out + g * 16, sel);
    if (!data) return nullptr;
  }
  return data;
}

}  // namespace

extern "C" int sc_meshopt_decode_vertex(const uint8_t* data, int data_size,
                                        int count, int stride, uint8_t* out) {
  if (data_size < 1 + stride) return 1;
  if ((data[0] & 0xF0) != 0xA0) return 2;
  if ((data[0] & 0x0F) != 0) return 3;
  const uint8_t* end = data + data_size;
  uint8_t last[256];
  if (stride > 256) return 4;
  memcpy(last, data + data_size - stride, stride);
  const uint8_t* p = data + 1;
  int block = block_size(stride);
  uint8_t deltas[kBlockMaxVertices + 16];
  for (int offset = 0; offset < count; ) {
    int n = count - offset < block ? count - offset : block;
    int rounded = (n + 15) & ~15;
    for (int k = 0; k < stride; k++) {
      p = decode_bytes(p, end, deltas, rounded);
      if (!p) return 5;
      uint8_t v = last[k];
      for (int i = 0; i < n; i++) {
        v = uint8_t(v + unzigzag8(deltas[i]));
        out[(offset + i) * stride + k] = v;
      }
      last[k] = v;
    }
    offset += n;
  }
  return 0;
}

namespace {

const uint8_t* decode_vbyte(const uint8_t* p, const uint8_t* end,
                            uint32_t* out) {
  uint32_t result = 0;
  int shift = 0;
  while (true) {
    if (p >= end) return nullptr;
    uint8_t b = *p++;
    result |= uint32_t(b & 0x7F) << shift;
    shift += 7;
    if (b < 0x80) break;
  }
  *out = result;
  return p;
}

}  // namespace

extern "C" int sc_meshopt_decode_index(const uint8_t* data, int data_size,
                                       int index_count, uint32_t* out) {
  if (data_size < 17) return 1;
  if ((data[0] & 0xF0) != 0xE0) return 2;
  int version = data[0] & 0x0F;
  if (version > 1) return 3;
  int fecmax = version >= 1 ? 13 : 15;

  int ntri = index_count / 3;
  const uint8_t* code = data + 1;
  const uint8_t* p = code + ntri;
  const uint8_t* end = data + data_size;
  const uint8_t* codeaux = data + data_size - 16;

  uint32_t edgefifo[16][2] = {};
  uint32_t vertexfifo[16] = {};
  int eoff = 0, voff = 0;
  uint32_t next = 0;
  int32_t last = 0;

  auto push_edge = [&](uint32_t a, uint32_t b) {
    edgefifo[eoff & 15][0] = a;
    edgefifo[eoff & 15][1] = b;
    eoff++;
  };
  auto push_vertex = [&](uint32_t v, bool cond) {
    if (cond) {
      vertexfifo[voff & 15] = v;
      voff++;
    }
  };
  auto decode_delta = [&](const uint8_t*& q, uint32_t* c) -> bool {
    uint32_t v;
    q = decode_vbyte(q, end, &v);
    if (!q) return false;
    int32_t d = int32_t(v >> 1) ^ -int32_t(v & 1);
    last += d;
    *c = uint32_t(last);
    return true;
  };

  for (int t = 0; t < ntri; t++) {
    uint32_t a, b, c;
    uint8_t codetri = code[t];
    if (codetri < 0xF0) {
      int fe = codetri >> 4;
      a = edgefifo[(eoff - 1 - fe) & 15][0];
      b = edgefifo[(eoff - 1 - fe) & 15][1];
      int fec = codetri & 15;
      if (fec < fecmax) {
        c = (fec == 0) ? next : vertexfifo[(voff - 1 - fec) & 15];
        next += (fec == 0);
        push_vertex(c, fec == 0);
      } else {
        if (fec == 13) {
          c = uint32_t(last);
        } else {
          if (!decode_delta(p, &c)) return 5;
        }
        push_vertex(c, true);
      }
      push_edge(c, b);
      push_edge(a, c);
    } else {
      int feb, fec;
      bool fea_explicit = false;
      if (codetri < 0xFE) {
        uint8_t cod = codeaux[codetri & 15];
        feb = cod >> 4;
        fec = cod & 15;
      } else {
        if (p >= end) return 6;
        uint8_t cod = *p++;
        feb = cod >> 4;
        fec = cod & 15;
        fea_explicit = (codetri == 0xFF);
      }
      if (!fea_explicit) {
        a = next++;
      } else {
        if (!decode_delta(p, &a)) return 7;
      }
      if (feb == 0) {
        b = next++;
      } else if (feb < 15) {
        b = vertexfifo[(voff - feb) & 15];
      } else {
        if (!decode_delta(p, &b)) return 8;
      }
      if (fec == 0) {
        c = next++;
      } else if (fec < 15) {
        c = vertexfifo[(voff - fec) & 15];
      } else {
        if (!decode_delta(p, &c)) return 9;
      }
      push_vertex(a, true);
      push_vertex(b, feb == 0);
      push_vertex(c, fec == 0);
      push_edge(b, a);
      push_edge(c, b);
      push_edge(a, c);
    }
    out[t * 3 + 0] = a;
    out[t * 3 + 1] = b;
    out[t * 3 + 2] = c;
  }
  return 0;
}

// Index SEQUENCE codec (EXT_meshopt_compression mode 2, arbitrary
// topology): per index one vbyte — bit 0 selects one of two running
// baselines, the remaining bits are a zigzag delta applied to (and stored
// back into) it.
extern "C" int sc_meshopt_decode_index_sequence(const uint8_t* data,
                                                int data_size,
                                                int index_count,
                                                uint32_t* out) {
  if (data_size < 1) return 1;
  if ((data[0] & 0xF0) != 0xD0) return 2;
  int version = data[0] & 0x0F;
  if (version > 1) return 3;
  const uint8_t* p = data + 1;
  const uint8_t* end = data + data_size;
  uint32_t last[2] = {0, 0};
  for (int i = 0; i < index_count; i++) {
    if (p >= end) return 4;
    uint32_t v;
    p = decode_vbyte(p, end, &v);
    uint32_t current = v & 1;
    v >>= 1;
    uint32_t d = (v >> 1) ^ (~(v & 1) + 1);
    last[current] += d;
    out[i] = last[current];
  }
  return 0;
}
