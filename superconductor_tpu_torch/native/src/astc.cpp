// ASTC LDR 2D block decoder (any block size; the engine uses 4x4).
//
// Role in the framework: the reference links the basis-universal C++
// transcoder for UASTC/KHR_texture_basisu sources and serves ASTC-capable
// devices directly (renderer-core/src/assets/textures.rs:1099-1153,
// Cargo.toml:29).  UASTC blocks are by construction valid ASTC 4x4 blocks,
// so one spec-complete ASTC LDR decoder covers both the .astc/ asset tier
// and UASTC KTX2 payloads.  Validated bit-exactly against the Mesa
// llvmpipe GL decoder (tests/test_native.py), same method as bptc.cpp.
//
// Implemented from the Khronos Data Format Specification's ASTC section:
// block modes, BISE integer sequences (trits/quints/bits), weight + color
// unquantization, the partition hash, all LDR color endpoint modes,
// dual-plane, infill interpolation, void-extent blocks and the error
// conditions (which produce opaque magenta in the LDR profile).

#include <cstdint>
#include <cstring>

namespace {

// ---------------------------------------------------------------- bits --
struct Block {
    uint8_t b[16];
    // bit i (0 = LSB of byte 0)
    inline uint32_t bits(int pos, int count) const {
        uint64_t lo, hi;
        std::memcpy(&lo, b, 8);
        std::memcpy(&hi, b + 8, 8);
        uint64_t v;
        if (pos >= 64)
            v = hi >> (pos - 64);
        else {
            v = lo >> pos;
            if (pos + count > 64 && pos > 0)
                v |= hi << (64 - pos);
            else if (pos == 0)
                v = lo;
        }
        return (uint32_t)(v & ((count >= 32) ? 0xFFFFFFFFu : ((1u << count) - 1)));
    }
};

// Sequential bounded bit reader. Reads past `limit` return zero bits (the
// ISE streams of truncated final groups rely on this).
struct Reader {
    const Block* blk;
    int pos;
    int limit;
    inline uint32_t read(int count) {
        if (count == 0) return 0;
        int avail = limit - pos;
        uint32_t v = 0;
        if (avail > 0) {
            int take = avail < count ? avail : count;
            v = blk->bits(pos, take);
        }
        pos += count;
        return v;
    }
};

// Reverse the 128 bits of a block (for the weight ISE, which is stored
// from bit 127 downward).
static const uint8_t kRev[256] = {
#define R2(n) n, n + 2 * 64, n + 1 * 64, n + 3 * 64
#define R4(n) R2(n), R2(n + 2 * 16), R2(n + 1 * 16), R2(n + 3 * 16)
#define R6(n) R4(n), R4(n + 2 * 4), R4(n + 1 * 4), R4(n + 3 * 4)
    R6(0), R6(2), R6(1), R6(3)
#undef R2
#undef R4
#undef R6
};

static Block reverse_block(const Block& in) {
    Block out;
    for (int i = 0; i < 16; i++) out.b[i] = kRev[in.b[15 - i]];
    return out;
}

// ------------------------------------------------------------ ISE sizes --
struct Quant {
    int levels;
    int bits;
    int trits;   // 0/1
    int quints;  // 0/1
};

// All BISE quantization modes, ascending.
static const Quant kQuants[] = {
    {2, 1, 0, 0},  {3, 0, 1, 0},  {4, 2, 0, 0},  {5, 0, 0, 1},
    {6, 1, 1, 0},  {8, 3, 0, 0},  {10, 1, 0, 1}, {12, 2, 1, 0},
    {16, 4, 0, 0}, {20, 2, 0, 1}, {24, 3, 1, 0}, {32, 5, 0, 0},
    {40, 3, 0, 1}, {48, 4, 1, 0}, {64, 6, 0, 0}, {80, 4, 0, 1},
    {96, 5, 1, 0}, {128, 7, 0, 0}, {160, 5, 0, 1}, {192, 6, 1, 0},
    {256, 8, 0, 0},
};
static const int kNumQuants = sizeof(kQuants) / sizeof(kQuants[0]);

static int ise_bits(const Quant& q, int count) {
    int bits = count * q.bits;
    if (q.trits) bits += (count * 8 + 4) / 5;
    if (q.quints) bits += (count * 7 + 2) / 3;
    return bits;
}

// ------------------------------------------------------------ ISE decode --
static void decode_trits(uint32_t T, int t[5]) {
    uint32_t C;
    if (((T >> 2) & 7) == 7) {
        C = (((T >> 5) & 7) << 2) | (T & 3);
        t[4] = t[3] = 2;
    } else {
        C = T & 0x1F;
        if (((T >> 5) & 3) == 3) {
            t[4] = 2;
            t[3] = (T >> 7) & 1;
        } else {
            t[4] = (T >> 7) & 1;
            t[3] = (T >> 5) & 3;
        }
    }
    if ((C & 3) == 3) {
        t[2] = 2;
        t[1] = (C >> 4) & 1;
        t[0] = (((C >> 3) & 1) << 1) | (((C >> 2) & 1) & ~((C >> 3) & 1));
    } else if (((C >> 2) & 3) == 3) {
        t[2] = 2;
        t[1] = 2;
        t[0] = C & 3;
    } else {
        t[2] = (C >> 4) & 1;
        t[1] = (C >> 2) & 3;
        t[0] = (((C >> 1) & 1) << 1) | ((C & 1) & ~((C >> 1) & 1));
    }
}

static void decode_quints(uint32_t Q, int q[3]) {
    uint32_t C;
    if (((Q >> 1) & 3) == 3 && ((Q >> 5) & 3) == 0) {
        uint32_t q0 = Q & 1;
        q[2] = ((q0 & 1) << 2) | ((((Q >> 4) & 1) & ~q0) << 1) |
               (((Q >> 3) & 1) & ~q0);
        q[1] = q[0] = 4;
        return;
    }
    if (((Q >> 1) & 3) == 3) {
        q[2] = 4;
        C = (((Q >> 3) & 3) << 3) | ((~(Q >> 5) & 3) << 1) | (Q & 1);
    } else {
        q[2] = (Q >> 5) & 3;
        C = Q & 0x1F;
    }
    if ((C & 7) == 5) {
        q[1] = 4;
        q[0] = (C >> 3) & 3;
    } else {
        q[1] = (C >> 3) & 3;
        q[0] = C & 7;
    }
}

// Decode `count` ISE values from `r`; out[i] gets (digit, bits) packed as
// digit * 2^bits | m for convenient unquantization.
struct IseValue {
    uint8_t m;
    uint8_t d;  // trit or quint digit (0 when bits-only)
};

static void decode_ise(Reader& r, const Quant& q, int count, IseValue* out) {
    if (q.trits) {
        static const int chunk[5] = {2, 2, 1, 2, 1};
        for (int i = 0; i < count; i += 5) {
            int cnt = count - i < 5 ? count - i : 5;
            uint32_t T = 0;
            int tpos = 0;
            uint8_t m[5] = {0, 0, 0, 0, 0};
            for (int j = 0; j < cnt; j++) {
                m[j] = (uint8_t)r.read(q.bits);
                T |= r.read(chunk[j]) << tpos;
                tpos += chunk[j];
            }
            int t[5];
            decode_trits(T, t);
            for (int j = 0; j < cnt; j++) {
                out[i + j].m = m[j];
                out[i + j].d = (uint8_t)t[j];
            }
        }
    } else if (q.quints) {
        static const int chunk[3] = {3, 2, 2};
        for (int i = 0; i < count; i += 3) {
            int cnt = count - i < 3 ? count - i : 3;
            uint32_t Q = 0;
            int qpos = 0;
            uint8_t m[3] = {0, 0, 0};
            for (int j = 0; j < cnt; j++) {
                m[j] = (uint8_t)r.read(q.bits);
                Q |= r.read(chunk[j]) << qpos;
                qpos += chunk[j];
            }
            int qd[3];
            decode_quints(Q, qd);
            for (int j = 0; j < cnt; j++) {
                out[i + j].m = m[j];
                out[i + j].d = (uint8_t)qd[j];
            }
        }
    } else {
        for (int i = 0; i < count; i++) {
            out[i].m = (uint8_t)r.read(q.bits);
            out[i].d = 0;
        }
    }
}

// ------------------------------------------------------- unquantization --
// Weight unquantization -> 0..64 (spec "unquantize weights").
static int unquant_weight(const Quant& q, IseValue v) {
    int n = q.bits;
    if (!q.trits && !q.quints) {
        // bit replication to 6 bits
        int w;
        switch (n) {
            case 1: w = v.m * 63; break;
            case 2: w = v.m * 21; break;
            case 3: w = v.m * 9; break;
            case 4: w = (v.m << 2) | (v.m >> 2); break;
            case 5: w = (v.m << 1) | (v.m >> 4); break;
            default: w = 0; break;
        }
        if (w > 32) w += 1;
        return w;
    }
    if (n == 0) return q.trits ? v.d * 32 : v.d * 16;
    int A = (v.m & 1) ? 0x7F : 0;
    int B = 0, C = 0;
    if (q.trits) {
        switch (n) {
            case 1: C = 50; break;
            case 2: C = 23; B = ((v.m >> 1) & 1) * 69; break;  // "b000b0b"
            case 3:
                C = 11;
                B = ((v.m >> 1) & 1) * 33 + ((v.m >> 2) & 1) * 66;  // "cb000cb"
                break;
        }
    } else {
        switch (n) {
            case 1: C = 28; break;
            case 2: C = 13; B = ((v.m >> 1) & 1) * 66; break;  // "b0000b0"
        }
    }
    int T = v.d * C + B;
    T ^= A;
    T = (A & 0x20) | (T >> 2);
    if (T > 32) T += 1;
    return T;
}

// Color unquantization -> 0..255 (spec Table of B/C parameters).
static int unquant_color(const Quant& q, IseValue v) {
    int n = q.bits;
    if (!q.trits && !q.quints) {
        switch (n) {
            case 1: return v.m * 255;
            case 2: return v.m * 85;
            case 3: return (v.m << 5) | (v.m << 2) | (v.m >> 1);
            case 4: return v.m * 17;
            case 5: return (v.m << 3) | (v.m >> 2);
            case 6: return (v.m << 2) | (v.m >> 4);
            case 7: return (v.m << 1) | (v.m >> 6);
            default: return v.m;
        }
    }
    int A = (v.m & 1) ? 0x1FF : 0;
    int B = 0, C = 0;
    int b = (v.m >> 1) & 1, c = (v.m >> 2) & 1, d = (v.m >> 3) & 1,
        e = (v.m >> 4) & 1, f = (v.m >> 5) & 1;
    if (q.trits) {
        switch (n) {
            case 1: C = 204; break;
            case 2: C = 93; B = b * 278; break;              // "b000b0bb0"
            case 3: C = 44; B = c * 266 + b * 133; break;    // "cb000cbcb"
            case 4: C = 22; B = d * 260 + c * 130 + b * 65; break;  // "dcb000dcb"
            case 5:
                C = 11;
                B = e * 258 + d * 129 + c * 64 + b * 32;  // "edcb000ed"
                break;
            case 6:
                C = 5;
                B = f * 257 + e * 128 + d * 64 + c * 32 + b * 16;  // "fedcb000f"
                break;
        }
    } else {
        switch (n) {
            case 1: C = 113; break;
            case 2: C = 54; B = b * 268; break;              // "b0000bb00"
            case 3: C = 26; B = c * 261 + b * 130; break;    // "cb0000cbc"
            case 4: C = 13; B = d * 258 + c * 129 + b * 64; break;  // "dcb0000dc"
            case 5:
                C = 6;
                B = e * 257 + d * 128 + c * 64 + b * 32;  // "edcb0000e"
                break;
        }
    }
    int T = v.d * C + B;
    T ^= A;
    T = (A & 0x80) | (T >> 2);
    return T;
}

// ------------------------------------------------------- partition hash --
static uint32_t hash52(uint32_t p) {
    p ^= p >> 15;
    p -= p << 17;
    p += p << 7;
    p += p << 4;
    p ^= p >> 5;
    p += p << 16;
    p ^= p >> 7;
    p ^= p >> 3;
    p ^= p << 6;
    p ^= p >> 17;
    return p;
}

static int select_partition(int seed, int x, int y, int z, int partitioncount,
                            int small_block) {
    if (partitioncount <= 1) return 0;
    if (small_block) {
        x <<= 1;
        y <<= 1;
        z <<= 1;
    }
    seed += (partitioncount - 1) * 1024;
    uint32_t rnum = hash52((uint32_t)seed);
    uint8_t seed1 = rnum & 0xF;
    uint8_t seed2 = (rnum >> 4) & 0xF;
    uint8_t seed3 = (rnum >> 8) & 0xF;
    uint8_t seed4 = (rnum >> 12) & 0xF;
    uint8_t seed5 = (rnum >> 16) & 0xF;
    uint8_t seed6 = (rnum >> 20) & 0xF;
    uint8_t seed7 = (rnum >> 24) & 0xF;
    uint8_t seed8 = (rnum >> 28) & 0xF;
    uint8_t seed9 = (rnum >> 18) & 0xF;
    uint8_t seed10 = (rnum >> 22) & 0xF;
    uint8_t seed11 = (rnum >> 26) & 0xF;
    uint8_t seed12 = ((rnum >> 30) | (rnum << 2)) & 0xF;

    seed1 *= seed1;
    seed2 *= seed2;
    seed3 *= seed3;
    seed4 *= seed4;
    seed5 *= seed5;
    seed6 *= seed6;
    seed7 *= seed7;
    seed8 *= seed8;
    seed9 *= seed9;
    seed10 *= seed10;
    seed11 *= seed11;
    seed12 *= seed12;

    int sh1, sh2;
    if (seed & 1) {
        sh1 = (seed & 2) ? 4 : 5;
        sh2 = (partitioncount == 3) ? 6 : 5;
    } else {
        sh1 = (partitioncount == 3) ? 6 : 5;
        sh2 = (seed & 2) ? 4 : 5;
    }
    int sh3 = (seed & 0x10) ? sh1 : sh2;

    seed1 >>= sh1;
    seed2 >>= sh2;
    seed3 >>= sh1;
    seed4 >>= sh2;
    seed5 >>= sh1;
    seed6 >>= sh2;
    seed7 >>= sh1;
    seed8 >>= sh2;
    seed9 >>= sh3;
    seed10 >>= sh3;
    seed11 >>= sh3;
    seed12 >>= sh3;

    int a = seed1 * x + seed2 * y + seed11 * z + (rnum >> 14);
    int b = seed3 * x + seed4 * y + seed12 * z + (rnum >> 10);
    int c = seed5 * x + seed6 * y + seed9 * z + (rnum >> 6);
    int d = seed7 * x + seed8 * y + seed10 * z + (rnum >> 2);

    a &= 0x3F;
    b &= 0x3F;
    c &= 0x3F;
    d &= 0x3F;
    if (partitioncount <= 3) d = 0;
    if (partitioncount <= 2) c = 0;

    if (a >= b && a >= c && a >= d) return 0;
    if (b >= c && b >= d) return 1;
    if (c >= d) return 2;
    return 3;
}

// ----------------------------------------------------------- block mode --
struct BlockMode {
    int gw, gh;     // weight grid dims
    bool dual;
    int rq;         // index into kQuants for the weight range
    bool ok;
};

// Weight ranges: R in 2..7, H selects low/high precision.
static const int kWeightQuantIdx[2][8] = {
    // H = 0: levels 2, 3, 4, 5, 6, 8
    {-1, -1, 0, 1, 2, 3, 4, 5},
    // H = 1: levels 10, 12, 16, 20, 24, 32
    {-1, -1, 6, 7, 8, 9, 10, 11},
};

static BlockMode decode_block_mode(uint32_t mode) {
    BlockMode bm = {0, 0, false, 0, false};
    int D = (mode >> 10) & 1;
    int H = (mode >> 9) & 1;
    int A = (mode >> 5) & 3;
    int r;
    if (mode & 3) {
        r = (((mode >> 1) & 1) << 2) | ((mode & 1) << 1) | ((mode >> 4) & 1);
        int B = (mode >> 7) & 3;
        switch ((mode >> 2) & 3) {
            case 0: bm.gw = B + 4; bm.gh = A + 2; break;
            case 1: bm.gw = B + 8; bm.gh = A + 2; break;
            case 2: bm.gw = A + 2; bm.gh = B + 8; break;
            case 3:
                if (B & 2) {
                    bm.gw = (B & 1) + 2;
                    bm.gh = A + 2;
                } else {
                    bm.gw = A + 2;
                    bm.gh = (B & 1) + 6;
                }
                break;
        }
    } else {
        r = (((mode >> 3) & 1) << 2) | (((mode >> 2) & 1) << 1) |
            ((mode >> 4) & 1);
        switch ((mode >> 7) & 3) {
            case 0: bm.gw = 12; bm.gh = A + 2; break;
            case 1: bm.gw = A + 2; bm.gh = 12; break;
            case 2: {
                int B = (mode >> 9) & 3;
                bm.gw = A + 6;
                bm.gh = B + 6;
                D = 0;
                H = 0;
                break;
            }
            case 3:
                if (A == 0) {
                    bm.gw = 6;
                    bm.gh = 10;
                } else if (A == 1) {
                    bm.gw = 10;
                    bm.gh = 6;
                } else {
                    return bm;  // reserved
                }
                break;
        }
    }
    if (r < 2) return bm;  // reserved range
    bm.dual = D != 0;
    bm.rq = kWeightQuantIdx[H][r];
    bm.ok = true;
    return bm;
}

// --------------------------------------------------------- color modes --
static inline int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }
static inline int clamp12(int v) { return v < 0 ? 0 : (v > 0xFFF ? 0xFFF : v); }

static void bit_transfer_signed(int& a, int& b) {
    b >>= 1;
    b |= a & 0x80;
    a >>= 1;
    a &= 0x3F;
    if (a & 0x20) a -= 0x40;
}

static void blue_contract(int e[4]) {
    e[0] = (e[0] + e[2]) >> 1;
    e[1] = (e[1] + e[2]) >> 1;
}

// ------------------------------------------------------- HDR endpoints --
// HDR color endpoint modes produce 12-bit per-channel values (Khronos
// spec "HDR Endpoint Decoding"); channels flagged hdr interpolate in the
// LNS domain and convert via lns_to_sf16.

static inline void swap_int(int& a, int& b) { int t = a; a = b; b = t; }

static void hdr_mode2(const int* v, int e0[4], int e1[4]) {
    int y0, y1;
    if (v[1] >= v[0]) {
        y0 = v[0] << 4;
        y1 = v[1] << 4;
    } else {
        y0 = (v[1] << 4) + 8;
        y1 = (v[0] << 4) - 8;
    }
    e0[0] = e0[1] = e0[2] = clamp12(y0);
    e1[0] = e1[1] = e1[2] = clamp12(y1);
    e0[3] = e1[3] = 0x780;
}

static void hdr_mode3(const int* v, int e0[4], int e1[4]) {
    int y0, d;
    if (v[0] & 0x80) {
        y0 = ((v[1] & 0xE0) << 4) | ((v[0] & 0x7F) << 2);
        d = (v[1] & 0x1F) << 2;
    } else {
        y0 = ((v[1] & 0xF0) << 4) | ((v[0] & 0x7F) << 1);
        d = (v[1] & 0x0F) << 1;
    }
    int y1 = y0 + d;
    if (y1 > 0xFFF) y1 = 0xFFF;
    e0[0] = e0[1] = e0[2] = y0;
    e1[0] = e1[1] = e1[2] = y1;
    e0[3] = e1[3] = 0x780;
}

static void hdr_mode7(const int* v, int e0[4], int e1[4]) {
    int modeval = ((v[0] & 0xC0) >> 6) | ((v[1] & 0x80) >> 5) | ((v[2] & 0x80) >> 4);
    int majcomp, mode;
    if ((modeval & 0xC) != 0xC) {
        majcomp = modeval >> 2;
        mode = modeval & 3;
    } else if (modeval != 0xF) {
        majcomp = modeval & 3;
        mode = 4;
    } else {
        majcomp = 0;
        mode = 5;
    }
    int red = v[0] & 0x3F, green = v[1] & 0x1F, blue = v[2] & 0x1F,
        scale = v[3] & 0x1F;
    int x0 = (v[1] >> 6) & 1, x1 = (v[1] >> 5) & 1, x2 = (v[2] >> 6) & 1,
        x3 = (v[2] >> 5) & 1, x4 = (v[3] >> 7) & 1, x5 = (v[3] >> 6) & 1,
        x6 = (v[3] >> 5) & 1;
    int ohm = 1 << mode;
    if (ohm & 0x30) green |= x0 << 6;
    if (ohm & 0x3A) green |= x1 << 5;
    if (ohm & 0x30) blue |= x2 << 6;
    if (ohm & 0x3A) blue |= x3 << 5;
    if (ohm & 0x3D) scale |= x6 << 5;
    if (ohm & 0x2D) scale |= x5 << 6;
    if (ohm & 0x04) scale |= x4 << 7;
    if (ohm & 0x3B) red |= x4 << 6;
    if (ohm & 0x04) red |= x3 << 6;
    if (ohm & 0x10) red |= x5 << 7;
    if (ohm & 0x0F) red |= x2 << 7;
    if (ohm & 0x05) red |= x1 << 8;
    if (ohm & 0x0A) red |= x0 << 8;
    if (ohm & 0x05) red |= x0 << 9;
    if (ohm & 0x02) red |= x6 << 9;
    if (ohm & 0x01) red |= x3 << 10;
    if (ohm & 0x02) red |= x5 << 10;
    static const int shamts[6] = {1, 1, 2, 3, 4, 5};
    int shamt = shamts[mode];
    red <<= shamt;
    green <<= shamt;
    blue <<= shamt;
    scale <<= shamt;
    if (mode != 5) {
        green = red - green;
        blue = red - blue;
    }
    if (majcomp == 1) {
        swap_int(red, green);
    } else if (majcomp == 2) {
        swap_int(red, blue);
    }
    e1[0] = clamp12(red);
    e1[1] = clamp12(green);
    e1[2] = clamp12(blue);
    e1[3] = 0x780;
    e0[0] = clamp12(red - scale);
    e0[1] = clamp12(green - scale);
    e0[2] = clamp12(blue - scale);
    e0[3] = 0x780;
}

static inline int sign_extend(int v, int bits) {
    int m = 1 << (bits - 1);
    return (v ^ m) - m;
}

static void hdr_mode11(const int* v, int e0[4], int e1[4]) {
    int majcomp = ((v[4] & 0x80) >> 7) | ((v[5] & 0x80) >> 6);
    if (majcomp == 3) {
        e0[0] = v[0] << 4; e0[1] = v[2] << 4; e0[2] = (v[4] & 0x7F) << 5;
        e1[0] = v[1] << 4; e1[1] = v[3] << 4; e1[2] = (v[5] & 0x7F) << 5;
        e0[3] = e1[3] = 0x780;
        return;
    }
    int mode = ((v[1] & 0x80) >> 7) | ((v[2] & 0x80) >> 6) | ((v[3] & 0x80) >> 5);
    int va = v[0] | ((v[1] & 0x40) << 2);
    int vb0 = v[2] & 0x3F, vb1 = v[3] & 0x3F;
    int vc = v[1] & 0x3F;
    int vd0 = v[4] & 0x7F, vd1 = v[5] & 0x7F;
    static const int dbits[8] = {7, 6, 7, 6, 5, 6, 5, 6};
    vd0 = sign_extend(vd0 & ((1 << dbits[mode]) - 1), dbits[mode]);
    vd1 = sign_extend(vd1 & ((1 << dbits[mode]) - 1), dbits[mode]);
    int x0 = (v[2] >> 6) & 1, x1 = (v[3] >> 6) & 1, x2 = (v[4] >> 6) & 1,
        x3 = (v[5] >> 6) & 1, x4 = (v[4] >> 5) & 1, x5 = (v[5] >> 5) & 1;
    int ohm = 1 << mode;
    if (ohm & 0xA4) va |= x0 << 9;
    if (ohm & 0x08) va |= x2 << 9;
    if (ohm & 0x50) va |= x4 << 9;
    if (ohm & 0x50) va |= x5 << 10;
    if (ohm & 0xA0) va |= x1 << 10;
    if (ohm & 0xC0) va |= x2 << 11;
    if (ohm & 0x04) vc |= x1 << 6;
    if (ohm & 0xE8) vc |= x3 << 6;
    if (ohm & 0x20) vc |= x2 << 7;
    if (ohm & 0x5B) vb0 |= x0 << 6;
    if (ohm & 0x5B) vb1 |= x1 << 6;
    if (ohm & 0x12) vb0 |= x2 << 7;
    if (ohm & 0x12) vb1 |= x3 << 7;
    int shamt = (mode >> 1) ^ 3;
    va <<= shamt;
    vb0 <<= shamt;
    vb1 <<= shamt;
    vc <<= shamt;
    vd0 <<= shamt;
    vd1 <<= shamt;
    e1[0] = clamp12(va);
    e1[1] = clamp12(va - vb0);
    e1[2] = clamp12(va - vb1);
    e1[3] = 0x780;
    e0[0] = clamp12(va - vc);
    e0[1] = clamp12(va - vb0 - vc - vd0);
    e0[2] = clamp12(va - vb1 - vc - vd1);
    e0[3] = 0x780;
    if (majcomp == 1) {
        swap_int(e0[0], e0[1]);
        swap_int(e1[0], e1[1]);
    } else if (majcomp == 2) {
        swap_int(e0[0], e0[2]);
        swap_int(e1[0], e1[2]);
    }
}

static void hdr_mode15_alpha(int v6, int v7, int& a0, int& a1) {
    int mode = ((v6 >> 7) & 1) | ((v7 >> 6) & 2);
    v6 &= 0x7F;
    if (mode == 3) {
        a0 = v6 << 5;
        a1 = (v7 & 0x7F) << 5;
        return;
    }
    v6 |= (v7 << (mode + 1)) & 0x780;
    v7 &= 0x3F >> mode;
    v7 ^= 0x20 >> mode;
    v7 -= 0x20 >> mode;
    v6 <<= 4 - mode;
    v7 <<= 4 - mode;
    v7 += v6;
    if (v7 < 0) v7 = 0;
    if (v7 > 0xFFF) v7 = 0xFFF;
    a0 = v6;
    a1 = v7;
}

// ---------------------------------------------------- fp16 conversions --
// LNS interpolant -> fp16 (spec "...converted to FP16 as follows").
static uint16_t lns_to_sf16(uint16_t p) {
    uint16_t mc = p & 0x7FF;
    uint16_t ec = p >> 11;
    uint16_t mt;
    if (mc < 512)
        mt = 3 * mc;
    else if (mc < 1536)
        mt = 4 * mc - 512;
    else
        mt = 5 * mc - 2048;
    uint16_t res = (uint16_t)((ec << 10) | (mt >> 3));
    if (res >= 0x7BFF) res = 0x7BFF;
    return res;
}

// UNORM16 interpolant -> fp16 (LDR channels inside an HDR-profile decode).
static uint16_t unorm16_to_sf16(uint16_t p) {
    if (p == 0xFFFF) return 0x3C00;  // 1.0
    if (p == 0) return 0;
    int lz = 0;
    uint16_t v = p;
    while (!(v & 0x8000)) {
        v <<= 1;
        lz++;
    }
    v <<= 1;   // drop the leading one
    v >>= 6;   // 10-bit mantissa
    return (uint16_t)(v | ((14 - lz) << 10));
}

static float sf16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
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
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

static bool decode_endpoints(int cem, const int* v, int e0[4], int e1[4]);

// Decode one partition's endpoints from its unquantized color values.
// hdr[ch] marks channels holding 12-bit HDR (LNS) endpoints; LDR channels
// hold 8-bit values. In the LDR profile (hdr_profile=false) HDR modes
// return false -> error color.
static bool decode_endpoints_full(int cem, const int* v, int e0[4], int e1[4],
                                  bool hdr[4], bool hdr_profile) {
    hdr[0] = hdr[1] = hdr[2] = hdr[3] = false;
    switch (cem) {
        case 2:
            if (!hdr_profile) return false;
            hdr_mode2(v, e0, e1);
            hdr[0] = hdr[1] = hdr[2] = hdr[3] = true;
            return true;
        case 3:
            if (!hdr_profile) return false;
            hdr_mode3(v, e0, e1);
            hdr[0] = hdr[1] = hdr[2] = hdr[3] = true;
            return true;
        case 7:
            if (!hdr_profile) return false;
            hdr_mode7(v, e0, e1);
            hdr[0] = hdr[1] = hdr[2] = hdr[3] = true;
            return true;
        case 11:
            if (!hdr_profile) return false;
            hdr_mode11(v, e0, e1);
            hdr[0] = hdr[1] = hdr[2] = hdr[3] = true;
            return true;
        case 14:
            if (!hdr_profile) return false;
            hdr_mode11(v, e0, e1);
            hdr[0] = hdr[1] = hdr[2] = true;
            e0[3] = v[6];
            e1[3] = v[7];
            return true;
        case 15: {
            if (!hdr_profile) return false;
            hdr_mode11(v, e0, e1);
            hdr[0] = hdr[1] = hdr[2] = hdr[3] = true;
            int a0, a1;
            hdr_mode15_alpha(v[6], v[7], a0, a1);
            e0[3] = a0;
            e1[3] = a1;
            return true;
        }
        default:
            break;
    }
    return decode_endpoints(cem, v, e0, e1);
}

// LDR color endpoint modes.
static bool decode_endpoints(int cem, const int* v, int e0[4], int e1[4]) {
    switch (cem) {
        case 0:  // LDR luminance, direct
            e0[0] = e0[1] = e0[2] = v[0];
            e1[0] = e1[1] = e1[2] = v[1];
            e0[3] = e1[3] = 255;
            return true;
        case 1: {  // LDR luminance, base + offset
            int l0 = (v[0] >> 2) | (v[1] & 0xC0);
            int l1 = l0 + (v[1] & 0x3F);
            if (l1 > 255) l1 = 255;
            e0[0] = e0[1] = e0[2] = l0;
            e1[0] = e1[1] = e1[2] = l1;
            e0[3] = e1[3] = 255;
            return true;
        }
        case 4:  // LDR luminance + alpha, direct
            e0[0] = e0[1] = e0[2] = v[0];
            e1[0] = e1[1] = e1[2] = v[1];
            e0[3] = v[2];
            e1[3] = v[3];
            return true;
        case 5: {  // LDR luminance + alpha, base + offset
            int v0 = v[0], v1 = v[1], v2 = v[2], v3 = v[3];
            bit_transfer_signed(v1, v0);
            bit_transfer_signed(v3, v2);
            e0[0] = e0[1] = e0[2] = v0;
            e1[0] = e1[1] = e1[2] = clamp255(v0 + v1);
            e0[3] = v2;
            e1[3] = clamp255(v2 + v3);
            for (int i = 0; i < 3; i++) e0[i] = clamp255(e0[i]);
            e0[3] = clamp255(e0[3]);
            return true;
        }
        case 6:  // LDR RGB, base + scale
            e1[0] = v[0];
            e1[1] = v[1];
            e1[2] = v[2];
            e1[3] = 255;
            e0[0] = (v[0] * v[3]) >> 8;
            e0[1] = (v[1] * v[3]) >> 8;
            e0[2] = (v[2] * v[3]) >> 8;
            e0[3] = 255;
            return true;
        case 8: {  // LDR RGB, direct
            int s0 = v[0] + v[2] + v[4], s1 = v[1] + v[3] + v[5];
            if (s1 >= s0) {
                e0[0] = v[0]; e0[1] = v[2]; e0[2] = v[4];
                e1[0] = v[1]; e1[1] = v[3]; e1[2] = v[5];
            } else {
                e0[0] = v[1]; e0[1] = v[3]; e0[2] = v[5];
                e1[0] = v[0]; e1[1] = v[2]; e1[2] = v[4];
                blue_contract(e0);
                blue_contract(e1);
            }
            e0[3] = e1[3] = 255;
            return true;
        }
        case 9: {  // LDR RGB, base + offset
            int v0 = v[0], v1 = v[1], v2 = v[2], v3 = v[3], v4 = v[4], v5 = v[5];
            bit_transfer_signed(v1, v0);
            bit_transfer_signed(v3, v2);
            bit_transfer_signed(v5, v4);
            if (v1 + v3 + v5 >= 0) {
                e0[0] = v0; e0[1] = v2; e0[2] = v4;
                e1[0] = v0 + v1; e1[1] = v2 + v3; e1[2] = v4 + v5;
            } else {
                e0[0] = v0 + v1; e0[1] = v2 + v3; e0[2] = v4 + v5;
                e1[0] = v0; e1[1] = v2; e1[2] = v4;
                blue_contract(e0);
                blue_contract(e1);
            }
            for (int i = 0; i < 3; i++) {
                e0[i] = clamp255(e0[i]);
                e1[i] = clamp255(e1[i]);
            }
            e0[3] = e1[3] = 255;
            return true;
        }
        case 10:  // LDR RGB, base + scale, plus two alphas
            e1[0] = v[0]; e1[1] = v[1]; e1[2] = v[2]; e1[3] = v[5];
            e0[0] = (v[0] * v[3]) >> 8;
            e0[1] = (v[1] * v[3]) >> 8;
            e0[2] = (v[2] * v[3]) >> 8;
            e0[3] = v[4];
            return true;
        case 12: {  // LDR RGBA, direct
            int s0 = v[0] + v[2] + v[4], s1 = v[1] + v[3] + v[5];
            if (s1 >= s0) {
                e0[0] = v[0]; e0[1] = v[2]; e0[2] = v[4]; e0[3] = v[6];
                e1[0] = v[1]; e1[1] = v[3]; e1[2] = v[5]; e1[3] = v[7];
            } else {
                e0[0] = v[1]; e0[1] = v[3]; e0[2] = v[5]; e0[3] = v[7];
                e1[0] = v[0]; e1[1] = v[2]; e1[2] = v[4]; e1[3] = v[6];
                blue_contract(e0);
                blue_contract(e1);
            }
            return true;
        }
        case 13: {  // LDR RGBA, base + offset
            int v0 = v[0], v1 = v[1], v2 = v[2], v3 = v[3];
            int v4 = v[4], v5 = v[5], v6 = v[6], v7 = v[7];
            bit_transfer_signed(v1, v0);
            bit_transfer_signed(v3, v2);
            bit_transfer_signed(v5, v4);
            bit_transfer_signed(v7, v6);
            if (v1 + v3 + v5 >= 0) {
                e0[0] = v0; e0[1] = v2; e0[2] = v4; e0[3] = v6;
                e1[0] = v0 + v1; e1[1] = v2 + v3; e1[2] = v4 + v5;
                e1[3] = v6 + v7;
            } else {
                e0[0] = v0 + v1; e0[1] = v2 + v3; e0[2] = v4 + v5;
                e0[3] = v6 + v7;
                e1[0] = v0; e1[1] = v2; e1[2] = v4; e1[3] = v6;
                blue_contract(e0);
                blue_contract(e1);
            }
            for (int i = 0; i < 4; i++) {
                e0[i] = clamp255(e0[i]);
                e1[i] = clamp255(e1[i]);
            }
            return true;
        }
        default:
            return false;  // HDR modes: error in the LDR profile
    }
}

// -------------------------------------------------------------- decode --
static void error_color(uint8_t* out8, float* outf, int n) {
    for (int i = 0; i < n; i++) {
        if (out8) {
            out8[i * 4 + 0] = 0xFF;
            out8[i * 4 + 1] = 0x00;
            out8[i * 4 + 2] = 0xFF;
            out8[i * 4 + 3] = 0xFF;
        }
        if (outf) {
            outf[i * 4 + 0] = 1.0f;
            outf[i * 4 + 1] = 0.0f;
            outf[i * 4 + 2] = 1.0f;
            outf[i * 4 + 3] = 1.0f;
        }
    }
}

// Decode one block. Exactly one of out8 (LDR profile, display-encoded u8)
// / outf (HDR profile, float32) is non-null.
static void decode_block(const Block& blk, int bw, int bh, int srgb,
                         uint8_t* out8, float* outf) {
    const int ntex = bw * bh;
    const bool hdr_profile = outf != nullptr;
    uint32_t mode = blk.bits(0, 11);

    // Void-extent (constant color) block.
    if ((mode & 0x1FF) == 0x1FC) {
        bool hdr_void = (mode & 0x200) != 0;
        if (hdr_void && !hdr_profile) {  // error in the LDR profile
            error_color(out8, outf, ntex);
            return;
        }
        // Extent coords: all-ones means "unspecified"; otherwise a
        // degenerate extent (min >= max) is an error.
        uint32_t s0 = blk.bits(12, 13), s1 = blk.bits(25, 13);
        uint32_t t0 = blk.bits(38, 13), t1 = blk.bits(51, 13);
        bool all_ones = (s0 & s1 & t0 & t1) == 0x1FFF;
        if (!all_ones && (s0 >= s1 || t0 >= t1)) {
            error_color(out8, outf, ntex);
            return;
        }
        uint16_t c[4];
        for (int i = 0; i < 4; i++)
            c[i] = (uint16_t)blk.bits(64 + 16 * i, 16);
        for (int i = 0; i < ntex; i++)
            for (int ch = 0; ch < 4; ch++) {
                if (out8) out8[i * 4 + ch] = (uint8_t)(c[ch] >> 8);
                if (outf)
                    outf[i * 4 + ch] = hdr_void
                                           ? sf16_to_f32(c[ch])
                                           : sf16_to_f32(unorm16_to_sf16(c[ch]));
            }
        return;
    }

    BlockMode bm = decode_block_mode(mode);
    if (!bm.ok || bm.gw > bw || bm.gh > bh) {
        error_color(out8, outf, ntex);
        return;
    }
    const Quant& wq = kQuants[bm.rq];
    int num_weights = bm.gw * bm.gh * (bm.dual ? 2 : 1);
    int weight_bits = ise_bits(wq, num_weights);
    if (num_weights > 64 || weight_bits < 24 || weight_bits > 96) {
        error_color(out8, outf, ntex);
        return;
    }

    int num_parts = (int)blk.bits(11, 2) + 1;
    if (bm.dual && num_parts == 4) {
        error_color(out8, outf, ntex);
        return;
    }

    int part_seed = 0;
    int cem_field;
    int color_start;
    if (num_parts == 1) {
        cem_field = (int)blk.bits(13, 4);
        color_start = 17;
    } else {
        part_seed = (int)blk.bits(13, 10);
        cem_field = (int)blk.bits(23, 6);
        color_start = 29;
    }

    // Per-partition CEMs (+ count of extra CEM bits below the weights).
    int cems[4];
    int extra_cem_bits = 0;
    if (num_parts == 1) {
        cems[0] = cem_field;
    } else {
        int C = cem_field & 3;
        if (C == 0) {
            for (int i = 0; i < num_parts; i++) cems[i] = cem_field >> 2;
        } else {
            extra_cem_bits = 3 * num_parts - 4;
            uint32_t extra =
                blk.bits(128 - weight_bits - extra_cem_bits, extra_cem_bits);
            uint32_t payload = ((uint32_t)cem_field >> 2) | (extra << 4);
            // payload: num_parts class bits, then 2-bit m per partition
            for (int i = 0; i < num_parts; i++) {
                int cls = (C - 1) + ((payload >> i) & 1);
                int m = (payload >> (num_parts + 2 * i)) & 3;
                cems[i] = cls * 4 + m;
            }
        }
    }

    // Dual-plane component selector sits below weights and extra CEM bits.
    int ccs = -1;
    int ccs_bits = bm.dual ? 2 : 0;
    if (bm.dual)
        ccs = (int)blk.bits(128 - weight_bits - extra_cem_bits - 2, 2);

    // Color endpoint integer count and quantization.
    int num_color_values = 0;
    for (int i = 0; i < num_parts; i++)
        num_color_values += ((cems[i] >> 2) + 1) * 2;
    int color_avail = 128 - color_start - weight_bits - extra_cem_bits - ccs_bits;
    if (num_color_values > 18 || color_avail < 0) {
        error_color(out8, outf, ntex);
        return;
    }
    int cq = -1;
    for (int i = kNumQuants - 1; i >= 0; i--) {
        if (kQuants[i].levels < 6) break;
        if (ise_bits(kQuants[i], num_color_values) <= color_avail) {
            cq = i;
            break;
        }
    }
    if (cq < 0) {
        error_color(out8, outf, ntex);
        return;
    }

    // Decode + unquantize color endpoint values.
    IseValue cvals[18];
    Reader cr = {&blk, color_start,
                 color_start + ise_bits(kQuants[cq], num_color_values)};
    decode_ise(cr, kQuants[cq], num_color_values, cvals);
    int v[18];
    for (int i = 0; i < num_color_values; i++)
        v[i] = unquant_color(kQuants[cq], cvals[i]);

    int e0[4][4], e1[4][4];
    bool ehdr[4][4];
    int voff = 0;
    for (int i = 0; i < num_parts; i++) {
        if (!decode_endpoints_full(cems[i], v + voff, e0[i], e1[i], ehdr[i],
                                   hdr_profile)) {
            error_color(out8, outf, ntex);
            return;
        }
        voff += ((cems[i] >> 2) + 1) * 2;
    }

    // Decode + unquantize weights (stored bit-reversed from the top).
    Block rev = reverse_block(blk);
    IseValue wvals[128];
    Reader wr = {&rev, 0, weight_bits};
    decode_ise(wr, wq, num_weights, wvals);
    int w[128];
    for (int i = 0; i < num_weights; i++) w[i] = unquant_weight(wq, wvals[i]);

    // Infill: bilinear interpolation of the weight grid onto the texels.
    const int Ds = (1024 + bw / 2) / (bw - 1);
    const int Dt = (1024 + bh / 2) / (bh - 1);
    const int small_block = (bw * bh) < 31;
    const int planes = bm.dual ? 2 : 1;

    for (int t = 0; t < bh; t++) {
        for (int s = 0; s < bw; s++) {
            int gs = (Ds * s * (bm.gw - 1) + 32) >> 6;
            int gt = (Dt * t * (bm.gh - 1) + 32) >> 6;
            int js = gs >> 4, fs = gs & 0xF;
            int jt = gt >> 4, ft = gt & 0xF;
            int w11 = (fs * ft + 8) >> 4;
            int w10 = ft - w11;
            int w01 = fs - w11;
            int w00 = 16 - fs - ft + w11;
            int js1 = js + 1 < bm.gw ? js + 1 : bm.gw - 1;
            int jt1 = jt + 1 < bm.gh ? jt + 1 : bm.gh - 1;
            int tw[2];
            for (int pl = 0; pl < planes; pl++) {
                int p00 = w[(jt * bm.gw + js) * planes + pl];
                int p01 = w[(jt * bm.gw + js1) * planes + pl];
                int p10 = w[(jt1 * bm.gw + js) * planes + pl];
                int p11 = w[(jt1 * bm.gw + js1) * planes + pl];
                tw[pl] =
                    (p00 * w00 + p01 * w01 + p10 * w10 + p11 * w11 + 8) >> 4;
            }
            int part = select_partition(part_seed, s, t, 0, num_parts,
                                        small_block);
            for (int ch = 0; ch < 4; ch++) {
                int wgt = (bm.dual && ch == ccs) ? tw[1] : tw[0];
                int c0 = e0[part][ch], c1 = e1[part][ch];
                int x0, x1;
                bool ch_hdr = ehdr[part][ch];
                if (ch_hdr) {
                    x0 = c0 << 4;  // 12-bit LNS endpoint -> 16-bit domain
                    x1 = c1 << 4;
                } else if (srgb) {
                    x0 = (c0 << 8) | 0x80;
                    x1 = (c1 << 8) | 0x80;
                } else {
                    x0 = (c0 << 8) | c0;
                    x1 = (c1 << 8) | c1;
                }
                int cc = (x0 * (64 - wgt) + x1 * wgt + 32) >> 6;
                if (out8) out8[(t * bw + s) * 4 + ch] = (uint8_t)(cc >> 8);
                if (outf)
                    outf[(t * bw + s) * 4 + ch] = sf16_to_f32(
                        ch_hdr ? lns_to_sf16((uint16_t)cc)
                               : unorm16_to_sf16((uint16_t)cc));
            }
        }
    }
}

}  // namespace

extern "C" {

// Test hook: color unquantization for the quant mode with `levels` levels.
// Returns -1 for an unknown level count. Conformance tests sweep this
// against tables extracted from the Mesa GL oracle.
int sc_astc_unquant_color(int levels, int d, int m) {
    for (int i = 0; i < kNumQuants; i++) {
        if (kQuants[i].levels == levels) {
            IseValue v = {(uint8_t)m, (uint8_t)d};
            return unquant_color(kQuants[i], v);
        }
    }
    return -1;
}

// Decode an ASTC LDR 2D payload: ceil(w/bw) x ceil(h/bh) 16-byte blocks in
// raster order -> (height, width, 4) uint8 (display-encoded).
void sc_decode_astc(const uint8_t* data, int width, int height, int block_w,
                    int block_h, int srgb, uint8_t* out) {
    int bx = (width + block_w - 1) / block_w;
    int by = (height + block_h - 1) / block_h;
    uint8_t texels[12 * 12 * 4];
    for (int byi = 0; byi < by; byi++) {
        for (int bxi = 0; bxi < bx; bxi++) {
            Block blk;
            std::memcpy(blk.b, data + (byi * bx + bxi) * 16, 16);
            decode_block(blk, block_w, block_h, srgb, texels, nullptr);
            for (int t = 0; t < block_h; t++) {
                int y = byi * block_h + t;
                if (y >= height) break;
                for (int s = 0; s < block_w; s++) {
                    int x = bxi * block_w + s;
                    if (x >= width) break;
                    std::memcpy(out + (y * width + x) * 4,
                                texels + (t * block_w + s) * 4, 4);
                }
            }
        }
    }
}

// Decode an ASTC HDR 2D payload -> (height, width, 4) float32. LDR blocks
// inside the payload decode fine (unorm16 -> fp16); HDR endpoint modes
// decode through the LNS domain.
void sc_decode_astc_hdr(const uint8_t* data, int width, int height,
                        int block_w, int block_h, float* out) {
    int bx = (width + block_w - 1) / block_w;
    int by = (height + block_h - 1) / block_h;
    float texels[12 * 12 * 4];
    for (int byi = 0; byi < by; byi++) {
        for (int bxi = 0; bxi < bx; bxi++) {
            Block blk;
            std::memcpy(blk.b, data + (byi * bx + bxi) * 16, 16);
            decode_block(blk, block_w, block_h, 0, nullptr, texels);
            for (int t = 0; t < block_h; t++) {
                int y = byi * block_h + t;
                if (y >= height) break;
                for (int s = 0; s < block_w; s++) {
                    int x = bxi * block_w + s;
                    if (x >= width) break;
                    std::memcpy(out + (y * width + x) * 4,
                                texels + (t * block_w + s) * 4, 16);
                }
            }
        }
    }
}
}
