// ETC1S / BasisLZ low-level transcoder (host side).
//
// The reference links the basis-universal C++ transcoder
// (renderer-core/Cargo.toml:29, consumed in textures.rs:929-1097) to turn
// KHR_texture_basisu payloads into GPU texels. This file is the ETC1S half
// of that role (UASTC is handled by astc.cpp): it decodes the BasisLZ
// compressed streams — canonical-Huffman codebooks, delta-coded endpoint /
// selector palettes, and per-slice block index streams — into per-block
// (endpoint, selector) indices. RGBA expansion happens vectorized on the
// Python side (assets/basislz.py).
//
// Wire format implemented from the published basis_universal ETC1S
// specification (the DEFLATE-like Huffman table serialization, the
// 3-model color5 delta scheme, XOR-delta selector palettes, the 2x2-block
// endpoint-prediction symbols and the approximate-move-to-front selector
// history buffer). Validation strategy (tests/test_etc1s.py): the ETC1S
// block layer is checked against Mesa's independent ETC2 decoder (every
// ETC1S block is a valid ETC1/ETC2 block); the bitstream layer is pinned
// by hand-assembled wire vectors plus encoder round-trips — no ETC1S
// assets or reference encoder exist in this environment, so container-
// level bit-exactness against basisu itself is documented as best-effort.
//
// Video (P-frame / conditional-replenishment) slices are rejected: the
// reference never plays basis video either.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------- bits

struct BitReader {
  const uint8_t* data;
  size_t len;
  size_t bit = 0;
  bool err = false;

  uint32_t get_bits(uint32_t n) {
    uint32_t v = 0;
    for (uint32_t i = 0; i < n; i++) {
      size_t byte = bit >> 3;
      if (byte >= len) {
        err = true;
        return v;
      }
      v |= (uint32_t)((data[byte] >> (bit & 7)) & 1u) << i;
      bit++;
    }
    return v;
  }

  // Chunked VLC: chunk_bits value bits + 1 continuation bit per chunk.
  uint32_t decode_vlc(uint32_t chunk_bits) {
    uint32_t v = 0, ofs = 0;
    for (;;) {
      uint32_t s = get_bits(chunk_bits + 1);
      v |= (s & ((1u << chunk_bits) - 1u)) << ofs;
      ofs += chunk_bits;
      if (!(s & (1u << chunk_bits))) break;
      if (err || ofs >= 32) {
        err = true;
        break;
      }
    }
    return v;
  }
};

// ------------------------------------------------------------- huffman

constexpr uint32_t kMaxCodeSize = 16;
constexpr uint32_t kMaxSymsLog2 = 14;
constexpr uint32_t kSmallZeroRun = 17, kBigZeroRun = 18;
constexpr uint32_t kSmallRepeat = 19, kBigRepeat = 20;
constexpr uint32_t kTotalCodelengthCodes = 21;
static const uint8_t kSortedCodelengthCodes[kTotalCodelengthCodes] = {
    kSmallZeroRun, kBigZeroRun, kSmallRepeat, kBigRepeat,
    0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15, 16};

// Canonical Huffman decode table: codes assigned DEFLATE-style (shorter
// codes first, symbols in increasing index order within a length), read
// MSB-of-code-first off the LSB-first bit stream.
struct HuffTable {
  uint32_t first_code[kMaxCodeSize + 1] = {0};
  uint32_t count[kMaxCodeSize + 1] = {0};
  uint32_t offset[kMaxCodeSize + 1] = {0};
  std::vector<uint32_t> sorted_syms;
  bool nonempty = false;

  bool init(const uint8_t* sizes, uint32_t n) {
    for (uint32_t i = 0; i <= kMaxCodeSize; i++) {
      first_code[i] = count[i] = offset[i] = 0;
    }
    sorted_syms.clear();
    uint32_t total = 0;
    for (uint32_t i = 0; i < n; i++) {
      if (sizes[i] > kMaxCodeSize) return false;
      if (sizes[i]) {
        count[sizes[i]]++;
        total++;
      }
    }
    if (!total) return true;  // empty table: valid, but any decode fails
    nonempty = true;
    uint32_t code = 0, ofs = 0;
    for (uint32_t l = 1; l <= kMaxCodeSize; l++) {
      first_code[l] = code;
      offset[l] = ofs;
      code = (code + count[l]) << 1;
      ofs += count[l];
    }
    sorted_syms.resize(total);
    std::vector<uint32_t> next(kMaxCodeSize + 1);
    for (uint32_t l = 1; l <= kMaxCodeSize; l++) next[l] = offset[l];
    for (uint32_t i = 0; i < n; i++) {
      if (sizes[i]) sorted_syms[next[sizes[i]]++] = i;
    }
    return true;
  }

  int decode(BitReader& br) const {
    if (!nonempty) return -1;
    uint32_t code = 0;
    for (uint32_t l = 1; l <= kMaxCodeSize; l++) {
      code = (code << 1) | br.get_bits(1);
      if (br.err) return -1;
      if (count[l] && code - first_code[l] < count[l]) {
        return (int)sorted_syms[offset[l] + (code - first_code[l])];
      }
    }
    return -1;
  }
};

bool read_huffman_table(BitReader& br, HuffTable& t) {
  const uint32_t total_used_syms = br.get_bits(kMaxSymsLog2);
  if (br.err) return false;
  if (!total_used_syms) return true;  // empty
  const uint32_t num_cl = br.get_bits(5);
  if (num_cl < 1 || num_cl > kTotalCodelengthCodes) return false;
  uint8_t cl_sizes[kTotalCodelengthCodes] = {0};
  for (uint32_t i = 0; i < num_cl; i++) {
    cl_sizes[kSortedCodelengthCodes[i]] = (uint8_t)br.get_bits(3);
  }
  HuffTable cl;
  if (!cl.init(cl_sizes, kTotalCodelengthCodes)) return false;
  std::vector<uint8_t> sizes(total_used_syms, 0);
  uint32_t cur = 0;
  while (cur < total_used_syms) {
    int c = cl.decode(br);
    if (c < 0) return false;
    if (c <= (int)kMaxCodeSize) {
      sizes[cur++] = (uint8_t)c;
    } else if (c == (int)kSmallZeroRun) {
      cur += br.get_bits(3) + 3;
    } else if (c == (int)kBigZeroRun) {
      cur += br.get_bits(7) + 11;
    } else {
      if (!cur) return false;
      uint8_t prev = sizes[cur - 1];
      if (!prev) return false;
      uint32_t rep = (c == (int)kSmallRepeat) ? br.get_bits(2) + 3
                                              : br.get_bits(7) + 7;
      while (rep-- && cur < total_used_syms) sizes[cur++] = prev;
    }
    if (cur > total_used_syms) return false;
  }
  return t.init(sizes.data(), total_used_syms) && !br.err;
}

}  // namespace

// ------------------------------------------------------------ palettes

// Decodes the endpoint + selector codebooks.
//   out_endpoints: num_endpoints * 4 bytes (r5, g5, b5, inten3)
//   out_selectors: num_selectors * 16 bytes (values 0..3, raster y*4+x)
// Returns 0 on success, a positive stage code on failure.
extern "C" int sc_etc1s_decode_palettes(
    const uint8_t* ep_data, uint32_t ep_len, uint32_t num_endpoints,
    const uint8_t* sel_data, uint32_t sel_len, uint32_t num_selectors,
    uint8_t* out_endpoints, uint8_t* out_selectors) {
  BitReader br{ep_data, ep_len};
  HuffTable m0, m1, m2, mi;
  if (!read_huffman_table(br, m0) || !read_huffman_table(br, m1) ||
      !read_huffman_table(br, m2) || !read_huffman_table(br, mi)) {
    return 1;
  }
  const bool grayscale = br.get_bits(1) != 0;
  // 3-model color5 delta coder: the model (and the delta bias) is chosen
  // by the previous component value's range.
  int prev[3] = {16, 16, 16};
  uint32_t prev_inten = 0;
  for (uint32_t i = 0; i < num_endpoints; i++) {
    int id = mi.decode(br);
    if (id < 0) return 2;
    uint32_t inten = ((uint32_t)id + prev_inten) & 7;
    prev_inten = inten;
    int c[3] = {0, 0, 0};
    const int nc = grayscale ? 1 : 3;
    for (int ch = 0; ch < nc; ch++) {
      const int pv = prev[ch];
      int delta;
      if (pv <= 9) {
        int s = m0.decode(br);
        if (s < 0) return 3;
        delta = s - 9;  // delta range [-9, 31]
      } else if (pv <= 21) {
        int s = m1.decode(br);
        if (s < 0) return 3;
        delta = s - 21;  // [-21, 21]
      } else {
        int s = m2.decode(br);
        if (s < 0) return 3;
        delta = s - 31;  // [-31, 9]
      }
      const int v = pv + delta;
      if (v < 0 || v > 31) return 4;
      c[ch] = v;
    }
    if (grayscale) c[1] = c[2] = c[0];
    out_endpoints[i * 4 + 0] = (uint8_t)c[0];
    out_endpoints[i * 4 + 1] = (uint8_t)c[1];
    out_endpoints[i * 4 + 2] = (uint8_t)c[2];
    out_endpoints[i * 4 + 3] = (uint8_t)inten;
    prev[0] = c[0];
    prev[1] = c[1];
    prev[2] = c[2];
  }
  if (br.err) return 5;

  BitReader sb{sel_data, sel_len};
  const bool used_global_palette = sb.get_bits(1) != 0;
  const bool used_hybrid_palette = sb.get_bits(1) != 0;
  if (used_global_palette || used_hybrid_palette) return 6;  // deprecated
  const bool raw = sb.get_bits(1) != 0;
  if (raw) {
    for (uint32_t i = 0; i < num_selectors; i++) {
      for (uint32_t j = 0; j < 4; j++) {
        uint32_t b = sb.get_bits(8);
        for (uint32_t k = 0; k < 4; k++) {
          out_selectors[i * 16 + j * 4 + k] = (uint8_t)((b >> (k * 2)) & 3);
        }
      }
    }
  } else {
    HuffTable dm;
    if (!read_huffman_table(sb, dm)) return 7;
    uint8_t prevb[4] = {0, 0, 0, 0};
    for (uint32_t i = 0; i < num_selectors; i++) {
      for (uint32_t j = 0; j < 4; j++) {
        uint32_t b;
        if (!i) {
          b = sb.get_bits(8);  // first selector is sent raw
        } else {
          int d = dm.decode(sb);
          if (d < 0) return 8;
          b = ((uint32_t)d) ^ prevb[j];
        }
        prevb[j] = (uint8_t)b;
        for (uint32_t k = 0; k < 4; k++) {
          out_selectors[i * 16 + j * 4 + k] = (uint8_t)((b >> (k * 2)) & 3);
        }
      }
    }
  }
  return sb.err ? 9 : 0;
}

// --------------------------------------------------------------- slice

// Decodes one ETC1S slice into per-block endpoint/selector indices.
// tables_data is the shared BasisLZ "tables" blob (4 Huffman models +
// 13-bit selector history buffer size). Returns 0 on success.
extern "C" int sc_etc1s_transcode_slice(
    const uint8_t* tables_data, uint32_t tables_len,
    const uint8_t* slice_data, uint32_t slice_len,
    uint32_t num_blocks_x, uint32_t num_blocks_y,
    uint32_t num_endpoints, uint32_t num_selectors,
    uint32_t* out_endpoint_idx, uint32_t* out_selector_idx) {
  BitReader tb{tables_data, tables_len};
  HuffTable endpoint_pred_model, delta_endpoint_model, selector_model,
      selector_rle_model;
  if (!read_huffman_table(tb, endpoint_pred_model) ||
      !read_huffman_table(tb, delta_endpoint_model) ||
      !read_huffman_table(tb, selector_model) ||
      !read_huffman_table(tb, selector_rle_model)) {
    return 1;
  }
  const uint32_t history_size = tb.get_bits(13);
  if (tb.err || history_size > 8192) return 1;

  constexpr uint32_t kEndpointPredRepeatLast = 256;  // 4 preds ^ 4 blocks
  constexpr uint32_t kEndpointPredVlcBits = 4;
  constexpr uint32_t kEndpointPredMinRepeat = 3;
  constexpr uint32_t kSelectorRleThresh = 3;
  constexpr uint32_t kSelectorRleEscape = 63;  // last sym of 64-entry model
  const uint32_t selector_rle_sym = num_selectors + history_size;

  // Approximate move-to-front history buffer: new entries are written at
  // a rover cycling over the back half; a hit swaps one slot frontward.
  std::vector<uint32_t> history(history_size, 0);
  uint32_t rover = history_size / 2;

  BitReader br{slice_data, slice_len};
  std::vector<uint8_t> row_pred_bits(num_blocks_x, 0);
  std::vector<uint32_t> prev_row_ep(num_blocks_x, 0);
  std::vector<uint32_t> cur_row_ep(num_blocks_x, 0);
  uint32_t cur_pred_bits = 0, prev_pred_sym = 0, pred_repeat_count = 0;
  uint32_t prev_endpoint_index = 0, cur_selector_rle_count = 0;

  for (uint32_t by = 0; by < num_blocks_y; by++) {
    for (uint32_t bx = 0; bx < num_blocks_x; bx++) {
      // One endpoint-pred symbol covers a 2x2 block group: low 4 bits are
      // this row's pair, high 4 bits are stashed for the row below.
      if ((bx & 1) == 0) {
        if ((by & 1) == 0) {
          if (pred_repeat_count) {
            pred_repeat_count--;
            cur_pred_bits = prev_pred_sym;
          } else {
            int s = endpoint_pred_model.decode(br);
            if (s < 0) return 2;
            if ((uint32_t)s == kEndpointPredRepeatLast) {
              pred_repeat_count =
                  br.decode_vlc(kEndpointPredVlcBits) + kEndpointPredMinRepeat - 1;
              cur_pred_bits = prev_pred_sym;
            } else {
              cur_pred_bits = (uint32_t)s;
              prev_pred_sym = cur_pred_bits;
            }
          }
          row_pred_bits[bx] = (uint8_t)(cur_pred_bits >> 4);
        } else {
          cur_pred_bits = row_pred_bits[bx];
        }
      }
      const uint32_t pred = cur_pred_bits & 3;
      cur_pred_bits >>= 2;

      uint32_t endpoint_index;
      if (pred == 0) {  // left neighbour
        if (!bx) return 3;
        endpoint_index = cur_row_ep[bx - 1];
      } else if (pred == 1) {  // upper neighbour
        if (!by) return 3;
        endpoint_index = prev_row_ep[bx];
      } else if (pred == 2) {  // upper-left (CR/video would live here)
        if (!bx || !by) return 3;
        endpoint_index = prev_row_ep[bx - 1];
      } else {  // explicit, delta-coded vs the previous explicit index
        int d = delta_endpoint_model.decode(br);
        if (d < 0) return 4;
        endpoint_index = (uint32_t)d + prev_endpoint_index;
        if (endpoint_index >= num_endpoints) endpoint_index -= num_endpoints;
      }
      prev_endpoint_index = endpoint_index;
      cur_row_ep[bx] = endpoint_index;

      uint32_t selector_sym;
      if (cur_selector_rle_count) {
        cur_selector_rle_count--;
        selector_sym = num_selectors;  // history slot 0
      } else {
        int s = selector_model.decode(br);
        if (s < 0) return 5;
        selector_sym = (uint32_t)s;
        if (selector_sym == selector_rle_sym) {
          int run = selector_rle_model.decode(br);
          if (run < 0) return 5;
          cur_selector_rle_count =
              ((uint32_t)run == kSelectorRleEscape)
                  ? br.decode_vlc(7) + kSelectorRleThresh
                  : (uint32_t)run + kSelectorRleThresh;
          selector_sym = num_selectors;
          cur_selector_rle_count--;
        }
      }
      uint32_t selector_index;
      if (selector_sym >= num_selectors) {
        if (!history_size) return 6;
        const uint32_t hidx = selector_sym - num_selectors;
        if (hidx >= history_size) return 6;
        selector_index = history[hidx];
        if (hidx) {  // approximate MTF: bubble one slot toward the front
          uint32_t t = history[hidx - 1];
          history[hidx - 1] = history[hidx];
          history[hidx] = t;
        }
      } else {
        selector_index = selector_sym;
        if (history_size) {
          history[rover++] = selector_index;
          if (rover >= history_size) rover = history_size / 2;
        }
      }

      if (endpoint_index >= num_endpoints || selector_index >= num_selectors) {
        return 7;
      }
      const size_t o = (size_t)by * num_blocks_x + bx;
      out_endpoint_idx[o] = endpoint_index;
      out_selector_idx[o] = selector_index;
    }
    std::swap(prev_row_ep, cur_row_ep);
  }
  return br.err ? 8 : 0;
}
