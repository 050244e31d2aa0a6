// image_codec: the host image codecs of reface_tpu_torch/io/images.py, in
// place of the cv2 and PIL calls of the JAX package's drivers.
//
//   - PNG: the row unfilter (None, Sub, Up, Average, Paeth). The Python side
//     parses the chunks, inflates with zlib and lays out the samples.
//   - JPEG decode, baseline and extended sequential (SOF0/SOF1) and
//     progressive (SOF2: spectral selection and successive approximation,
//     DC and AC first and refinement scans, EOB runs, as libjpeg's
//     jdphuff.c), Huffman, 8-bit, restart markers: libjpeg's integer ISLOW
//     IDCT, its "fancy" triangle upsampling (h2v1, h1v2, h2v2), its YCbCr ->
//     RGB tables and its range limit, so that the pixels are those of
//     libjpeg-turbo (cv2.imdecode) with its defaults. A progressive file is
//     read whole into its coefficients before the IDCT, as libjpeg reads it
//     for a full decode; libjpeg's block smoothing, which it applies only
//     while some coefficient is still partly sent, is not done.
//     Arithmetic-coded files are refused with their own code.
//   - Baseline JPEG encode: RGB -> YCbCr with libjpeg's integer tables, 4:2:0
//     by libjpeg's alternating-bias 2x2 average, the Annex K tables scaled by
//     libjpeg's quality rule, the Annex K Huffman tables.
//
// Plain C ABI for ctypes; every function returns 0 (or a length) on success
// and a negative code on failure.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ------------------------------------------------------------------ PNG

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

// ------------------------------------------------------------------ JPEG

enum {
  kErrCorrupt = -1,
  kErrArithmetic = -3,
  kErrUnsupported = -4,
  kErrTruncated = -5,
  kErrSpace = -6,
};

int g_zigzag[64];  // g_zigzag[k] = natural index of the k-th coefficient

struct ZigzagInit {
  ZigzagInit() {
    int k = 0;
    for (int s = 0; s < 15; ++s) {
      if (s % 2 == 0) {  // up and to the right
        for (int y = std::min(s, 7); y >= 0 && s - y < 8; --y) g_zigzag[k++] = y * 8 + (s - y);
      } else {
        for (int x = std::min(s, 7); x >= 0 && s - x < 8; --x) g_zigzag[k++] = (s - x) * 8 + x;
      }
    }
  }
} g_zigzag_init;

struct Huff {
  bool defined = false;
  uint8_t vals[256];
  int maxcode[18];   // largest code of each length, -1 if none
  int valptr[17];    // index in vals of the first code of each length
  int mincode[17];
  uint8_t fast_len[512];  // codes of up to 9 bits: their length (0: longer)
  uint8_t fast_val[512];

  bool build(const uint8_t* bits, const uint8_t* v, int nvals) {
    std::memcpy(vals, v, nvals);
    std::memset(fast_len, 0, sizeof(fast_len));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += bits[l - 1];
      k += bits[l - 1];
      maxcode[l] = bits[l - 1] ? code - 1 : -1;
      if (code > (1 << l)) return false;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    for (int l = 1; l <= 9; ++l) {
      for (int i = 0; i < (maxcode[l] >= 0 ? maxcode[l] - mincode[l] + 1 : 0); ++i) {
        int c = mincode[l] + i;
        int lo = c << (9 - l), n = 1 << (9 - l);
        for (int j = 0; j < n; ++j) {
          fast_len[lo + j] = (uint8_t)l;
          fast_val[lo + j] = vals[valptr[l] + i];
        }
      }
    }
    defined = true;
    return true;
  }
};

// Entropy-coded data: 0xFF00 unstuffed; at a marker, zeros are fed (as
// libjpeg does) and the position stays at the marker.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint32_t b = 0;
      if (!at_marker && p < end) {
        if (*p == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            b = 0xFF;
            p += 2;
          } else {
            at_marker = true;
          }
        } else {
          b = *p++;
        }
      }
      acc |= (uint64_t)b << (56 - nbits);
      nbits += 8;
    }
  }
  inline uint32_t peek(int n) {
    if (nbits < n) fill();
    return (uint32_t)(acc >> (64 - n));
  }
  inline void skip(int n) {
    acc <<= n;
    nbits -= n;
  }
  inline int get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return (int)v;
  }
  // Past a restart marker: drop the buffered bits, find 0xFF 0xD0-0xD7.
  bool restart() {
    acc = 0;
    nbits = 0;
    at_marker = false;
    while (p + 1 < end) {
      if (p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
        p += 2;
        return true;
      }
      ++p;
    }
    return false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

inline int decode_huff(BitReader& br, const Huff& h, bool& bad) {
  uint32_t look = br.peek(16);
  uint32_t idx = look >> 7;
  if (h.fast_len[idx]) {
    br.skip(h.fast_len[idx]);
    return h.fast_val[idx];
  }
  for (int l = 10; l <= 16; ++l) {
    int code = (int)(look >> (16 - l));
    if (code <= h.maxcode[l]) {
      br.skip(l);
      return h.vals[h.valptr[l] + code - h.mincode[l]];
    }
  }
  bad = true;
  return 0;
}

// libjpeg's jidctint.c (ISLOW): CONST_BITS 13, PASS1_BITS 2.
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// libjpeg's IDCT range limit: (x & 1023) read as a signed 10-bit value,
// plus 128, clamped to [0, 255].
inline uint8_t idct_limit(int32_t x) {
  int32_t i = x & 1023;
  if (i >= 512) i -= 1024;
  i += 128;
  return (uint8_t)(i < 0 ? 0 : (i > 255 ? 255 : i));
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int32_t* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int32_t dc = (int32_t)in[0] * qt[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int32_t z2 = (int32_t)in[16] * qt[16], z3 = (int32_t)in[48] * qt[48];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int32_t)in[0] * qt[0];
    z3 = (int32_t)in[32] * qt[32];
    int32_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int32_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int32_t)in[56] * qt[56];
    tmp1 = (int32_t)in[40] * qt[40];
    tmp2 = (int32_t)in[24] * qt[24];
    tmp3 = (int32_t)in[8] * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, n);
    w[56] = descale(tmp10 - tmp3, n);
    w[8] = descale(tmp11 + tmp2, n);
    w[48] = descale(tmp11 - tmp2, n);
    w[16] = descale(tmp12 + tmp1, n);
    w[40] = descale(tmp12 - tmp1, n);
    w[24] = descale(tmp13 + tmp0, n);
    w[32] = descale(tmp13 - tmp0, n);
  }
  const int n = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (w[0] + w[4]) * (1 << kConstBits);
    int32_t tmp1 = (w[0] - w[4]) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = idct_limit(descale(tmp10 + tmp3, n));
    o[7] = idct_limit(descale(tmp10 - tmp3, n));
    o[1] = idct_limit(descale(tmp11 + tmp2, n));
    o[6] = idct_limit(descale(tmp11 - tmp2, n));
    o[2] = idct_limit(descale(tmp12 + tmp1, n));
    o[5] = idct_limit(descale(tmp12 - tmp1, n));
    o[3] = idct_limit(descale(tmp13 + tmp0, n));
    o[4] = idct_limit(descale(tmp13 - tmp0, n));
  }
}

// Progressive scans (libjpeg's jdphuff.c), one block's coefficients in
// natural order. A DC scan: the first codes the difference from the
// predictor, scaled by 2^Al; a refinement adds bit Al of every DC value.
void decode_dc_progressive(BitReader& br, const Huff& dc, int ah, int al, int& pred,
                           int16_t* c, bool& bad) {
  if (ah == 0) {
    int t = decode_huff(br, dc, bad);
    if (t > 11) bad = true;
    pred += t ? extend(br.get(t), t) : 0;
    c[0] = (int16_t)(pred * (1 << al));
  } else if (br.get(1)) {
    c[0] = (int16_t)(c[0] | (1 << al));
  }
}

// The first AC scan of band [ss, se]: run/size codes, each coefficient
// scaled by 2^Al; EOBr starts a run of 2^r + r more bits blocks with no
// coefficient in the band (this one included).
void decode_ac_first(BitReader& br, const Huff& ac, int ss, int se, int al, int& eobrun,
                     int16_t* c, bool& bad) {
  if (eobrun > 0) {
    --eobrun;
    return;
  }
  for (int k = ss; k <= se; ++k) {
    int rs = decode_huff(br, ac, bad);
    int r = rs >> 4, sz = rs & 15;
    if (sz) {
      k += r;
      if (k > 63) { bad = true; return; }
      c[g_zigzag[k]] = (int16_t)(extend(br.get(sz), sz) * (1 << al));
    } else if (r == 15) {
      k += 15;  // ZRL
    } else {
      eobrun = (1 << r) + (r ? br.get(r) : 0) - 1;
      return;
    }
  }
}

// An AC refinement scan of band [ss, se]: a correction bit (bit Al) for
// every coefficient already non-zero, and new coefficients of +-2^Al, each
// after r coefficients that stay zero; inside an EOB run only corrections.
void decode_ac_refine(BitReader& br, const Huff& ac, int ss, int se, int al, int& eobrun,
                      int16_t* c, bool& bad) {
  const int p1 = 1 << al, m1 = -(1 << al);
  auto correct = [&](int16_t& v) {
    if (br.get(1) && (v & p1) == 0) v = (int16_t)(v + (v >= 0 ? p1 : m1));
  };
  int k = ss;
  if (eobrun == 0) {
    for (; k <= se; ++k) {
      int rs = decode_huff(br, ac, bad);
      int r = rs >> 4, sz = rs & 15, nz = 0;
      if (sz) {
        nz = br.get(1) ? p1 : m1;  // a size other than 1 is libjpeg's warning only
      } else if (r != 15) {
        eobrun = (1 << r) + (r ? br.get(r) : 0);
        break;
      }
      do {  // past the non-zero coefficients (each corrected) and r zeros
        int16_t& v = c[g_zigzag[k]];
        if (v != 0) correct(v);
        else if (--r < 0) break;
        ++k;
      } while (k <= se);
      if (nz) {
        if (k > 63) { bad = true; return; }
        c[g_zigzag[k]] = (int16_t)nz;
      }
    }
  }
  if (eobrun > 0) {
    for (; k <= se; ++k) {
      int16_t& v = c[g_zigzag[k]];
      if (v != 0) correct(v);
    }
    --eobrun;
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;       // Huffman tables of the current scan
  int pred = 0;             // DC predictor
  int bw = 0, bh = 0;       // plane size in blocks (MCU-padded)
  int dw = 0, dh = 0;       // downsampled size in samples
  uint16_t qt[64];          // latched quantisation table, natural order
  bool qt_latched = false;
  std::vector<uint8_t> plane;
  std::vector<int16_t> coef;  // progressive: bw x bh blocks of 64, natural order
};

struct Jpeg {
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int restart_interval = 0;
  int adobe_transform = -1;  // -1: no Adobe marker
  bool jfif = false;
  int orientation = 1;
  bool sof_seen = false;
  bool progressive = false;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  Component comp[4];
  int mcux = 0, mcuy = 0;
};

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

void parse_exif_orientation(Jpeg& j, const uint8_t* p, int n) {
  if (n < 14 || std::memcmp(p, "Exif\0\0", 6) != 0) return;
  const uint8_t* t = p + 6;
  int tn = n - 6;
  bool le;
  if (t[0] == 'I' && t[1] == 'I') le = true;
  else if (t[0] == 'M' && t[1] == 'M') le = false;
  else return;
  auto u16 = [&](int off) -> int {
    return le ? (t[off] | (t[off + 1] << 8)) : ((t[off] << 8) | t[off + 1]);
  };
  auto u32 = [&](int off) -> uint32_t {
    return le ? (uint32_t)(t[off] | (t[off + 1] << 8) | (t[off + 2] << 16) | ((uint32_t)t[off + 3] << 24))
              : (uint32_t)(((uint32_t)t[off] << 24) | (t[off + 1] << 16) | (t[off + 2] << 8) | t[off + 3]);
  };
  uint32_t ifd = u32(4);
  if (ifd + 2 > (uint32_t)tn) return;
  int count = u16(ifd);
  for (int i = 0; i < count; ++i) {
    uint32_t e = ifd + 2 + 12 * i;
    if (e + 12 > (uint32_t)tn) return;
    if (u16(e) == 0x0112 && u16(e + 2) == 3) {
      int o = u16(e + 8);
      if (o >= 1 && o <= 8) j.orientation = o;
      return;
    }
  }
}

// Reads the markers up to the first SOS (with_scans false) or through the
// whole file, decoding every scan into the component planes.
int run(Jpeg& j, const uint8_t* buf, long n, bool with_scans) {
  if (n < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return kErrCorrupt;
  const uint8_t* p = buf + 2;
  const uint8_t* end = buf + n;
  while (true) {
    while (p < end && *p != 0xFF) ++p;  // tolerate junk between segments
    while (p < end && *p == 0xFF) ++p;  // fill bytes
    if (p >= end) return j.sof_seen ? 0 : kErrTruncated;
    int m = *p++;
    if (m == 0xD9) return 0;                    // EOI
    if (m >= 0xD0 && m <= 0xD7) continue;       // stray RST
    if (p + 2 > end) return kErrTruncated;
    int len = be16(p);
    if (len < 2 || p + len > end) return kErrTruncated;
    const uint8_t* s = p + 2;
    int sn = len - 2;
    p += len;
    if (m == 0xC9 || m == 0xCA || m == 0xCB || m == 0xCD || m == 0xCE || m == 0xCF || m == 0xCC)
      return kErrArithmetic;
    if (m == 0xC3 || m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xDE || m == 0xDF)
      return kErrUnsupported;
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      if (j.sof_seen) return kErrCorrupt;  // a second frame header (libjpeg: JERR_SOF_DUPLICATE)
      j.progressive = m == 0xC2;
      if (sn < 6 || s[0] != 8) return kErrUnsupported;  // 8-bit samples only
      j.height = be16(s + 1);
      j.width = be16(s + 3);
      j.ncomp = s[5];
      if (j.height == 0 || j.width == 0) return kErrUnsupported;  // DNL
      if (!(j.ncomp == 1 || j.ncomp == 3)) return kErrUnsupported;
      if (sn < 6 + 3 * j.ncomp) return kErrCorrupt;
      j.hmax = j.vmax = 1;
      for (int c = 0; c < j.ncomp; ++c) {
        Component& cp = j.comp[c];
        cp.id = s[6 + 3 * c];
        cp.h = s[7 + 3 * c] >> 4;
        cp.v = s[7 + 3 * c] & 15;
        cp.tq = s[8 + 3 * c];
        if (cp.h < 1 || cp.h > 4 || cp.v < 1 || cp.v > 4 || cp.tq > 3) return kErrCorrupt;
        j.hmax = std::max(j.hmax, cp.h);
        j.vmax = std::max(j.vmax, cp.v);
      }
      j.mcux = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
      j.mcuy = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
      for (int c = 0; c < j.ncomp; ++c) {
        Component& cp = j.comp[c];
        cp.bw = j.mcux * cp.h;
        cp.bh = j.mcuy * cp.v;
        cp.dw = (j.width * cp.h + j.hmax - 1) / j.hmax;
        cp.dh = (j.height * cp.v + j.vmax - 1) / j.vmax;
      }
      j.sof_seen = true;
      if (!with_scans) return 0;
      for (int c = 0; c < j.ncomp; ++c) {
        Component& cp = j.comp[c];
        cp.plane.assign((size_t)cp.bw * 8 * cp.bh * 8, 0);
        if (j.progressive) cp.coef.assign((size_t)cp.bw * cp.bh * 64, 0);
      }
      continue;
    }
    if (m == 0xC4) {  // DHT
      int off = 0;
      while (off < sn) {
        if (off + 17 > sn) return kErrCorrupt;
        int tc = s[off] >> 4, th = s[off] & 15;
        if (tc > 1 || th > 3) return kErrCorrupt;
        int total = 0;
        for (int i = 0; i < 16; ++i) total += s[off + 1 + i];
        if (total > 256 || off + 17 + total > sn) return kErrCorrupt;
        Huff& h = tc ? j.ac[th] : j.dc[th];
        if (!h.build(s + off + 1, s + off + 17, total)) return kErrCorrupt;
        off += 17 + total;
      }
      continue;
    }
    if (m == 0xDB) {  // DQT
      int off = 0;
      while (off < sn) {
        int pq = s[off] >> 4, tq = s[off] & 15;
        if (tq > 3 || pq > 1 || off + 1 + 64 * (pq + 1) > sn) return kErrCorrupt;
        for (int k = 0; k < 64; ++k) {
          int v = pq ? be16(s + off + 1 + 2 * k) : s[off + 1 + k];
          j.qt[tq][g_zigzag[k]] = (uint16_t)v;
        }
        j.qt_defined[tq] = true;
        off += 1 + 64 * (pq + 1);
      }
      continue;
    }
    if (m == 0xDD) {  // DRI
      if (sn < 2) return kErrCorrupt;
      j.restart_interval = be16(s);
      continue;
    }
    if (m == 0xE0) {
      if (sn >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) j.jfif = true;
      continue;
    }
    if (m == 0xE1) {
      if (j.orientation == 1) parse_exif_orientation(j, s, sn);
      continue;
    }
    if (m == 0xEE) {
      if (sn >= 12 && std::memcmp(s, "Adobe", 5) == 0) j.adobe_transform = s[11];
      continue;
    }
    if (m == 0xDA) {  // SOS
      if (!j.sof_seen) return kErrCorrupt;
      if (!with_scans) return 0;
      if (sn < 1) return kErrCorrupt;
      int ns = s[0];
      if (ns < 1 || ns > j.ncomp || sn < 1 + 2 * ns + 3) return kErrCorrupt;
      Component* sc[4];
      int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
      // the tables a scan reads: both in a sequential scan; in a progressive
      // one the DC table in a first DC scan, the AC table in an AC scan
      bool need_dc = !j.progressive || (ss == 0 && ah == 0), need_ac = !j.progressive || ss > 0;
      if (j.progressive) {  // libjpeg's JERR_BAD_PROGRESSION
        if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1)) return kErrCorrupt;
        if ((ah != 0 && al != ah - 1) || al > 13) return kErrCorrupt;
      }
      for (int i = 0; i < ns; ++i) {
        int cid = s[1 + 2 * i];
        Component* cp = nullptr;
        for (int c = 0; c < j.ncomp; ++c)
          if (j.comp[c].id == cid) cp = &j.comp[c];
        if (!cp) return kErrCorrupt;
        cp->td = s[2 + 2 * i] >> 4;
        cp->ta = s[2 + 2 * i] & 15;
        if (cp->td > 3 || cp->ta > 3 || (need_dc && !j.dc[cp->td].defined) ||
            (need_ac && !j.ac[cp->ta].defined))
          return kErrCorrupt;
        if (!cp->qt_latched) {
          if (!j.qt_defined[cp->tq]) return kErrCorrupt;
          std::memcpy(cp->qt, j.qt[cp->tq], sizeof(cp->qt));
          cp->qt_latched = true;
        }
        cp->pred = 0;
        sc[i] = cp;
      }
      // a sequential scan's Ss, Se, Ah and Al are not read (libjpeg warns
      // JWRN_NOT_SEQUENTIAL and decodes the scan as sequential)
      BitReader br{p, end};
      bool bad = false;
      int eobrun = 0;  // progressive AC scans: blocks left in the current EOB run
      int16_t blk[64];
      int nmcu_x, nmcu_y;
      if (ns == 1) {
        nmcu_x = (sc[0]->dw + 7) / 8;
        nmcu_y = (sc[0]->dh + 7) / 8;
      } else {
        nmcu_x = j.mcux;
        nmcu_y = j.mcuy;
      }
      long total = (long)nmcu_x * nmcu_y, done = 0;
      int todo = j.restart_interval;
      for (int my = 0; my < nmcu_y; ++my) {
        for (int mx = 0; mx < nmcu_x; ++mx) {
          if (j.restart_interval && done > 0 && todo == 0) {
            br.restart();
            for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
            eobrun = 0;
            todo = j.restart_interval;
          }
          for (int i = 0; i < ns; ++i) {
            Component& cp = *sc[i];
            int nbh = ns == 1 ? 1 : cp.h, nbv = ns == 1 ? 1 : cp.v;
            for (int by = 0; by < nbv; ++by) {
              for (int bx = 0; bx < nbh; ++bx) {
                int row = ns == 1 ? my : my * cp.v + by;
                int col = ns == 1 ? mx : mx * cp.h + bx;
                if (j.progressive) {
                  int16_t* c = cp.coef.data() + ((size_t)row * cp.bw + col) * 64;
                  if (ss == 0)
                    decode_dc_progressive(br, j.dc[cp.td], ah, al, cp.pred, c, bad);
                  else if (ah == 0)
                    decode_ac_first(br, j.ac[cp.ta], ss, se, al, eobrun, c, bad);
                  else
                    decode_ac_refine(br, j.ac[cp.ta], ss, se, al, eobrun, c, bad);
                  if (bad) return kErrCorrupt;
                  continue;
                }
                std::memset(blk, 0, sizeof(blk));
                int t = decode_huff(br, j.dc[cp.td], bad);
                if (t > 11) bad = true;
                int diff = t ? extend(br.get(t), t) : 0;
                cp.pred += diff;
                blk[0] = (int16_t)cp.pred;
                for (int k = 1; k < 64;) {
                  int rs = decode_huff(br, j.ac[cp.ta], bad);
                  int r = rs >> 4, sz = rs & 15;
                  if (sz) {
                    k += r;
                    if (k > 63) { bad = true; break; }
                    blk[g_zigzag[k]] = (int16_t)extend(br.get(sz), sz);
                    ++k;
                  } else {
                    if (r != 15) break;
                    k += 16;
                  }
                }
                if (bad) return kErrCorrupt;
                int stride = cp.bw * 8;
                idct_islow(blk, cp.qt, cp.plane.data() + (size_t)row * 8 * stride + col * 8, stride);
              }
            }
          }
          ++done;
          if (j.restart_interval) --todo;
        }
      }
      (void)total;
      // on to the marker after the entropy-coded segment (past any RSTn)
      p = br.p;
      while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF &&
                              !(p[1] >= 0xD0 && p[1] <= 0xD7)))
        ++p;
      continue;
    }
    // APPn, COM and anything else: skipped
  }
}

inline uint8_t clamp8(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// The component upsampled to (at least) width x height, as libjpeg's
// jdsample.c with do_fancy_upsampling: rows above the first and below the
// last real row repeat them (jdmainct.c's context rows).
int upsample(const Jpeg& j, const Component& cp, std::vector<uint8_t>& out, int& ostride) {
  const int hf = j.hmax / cp.h, vf = j.vmax / cp.v;
  if (j.hmax % cp.h || j.vmax % cp.v) return kErrUnsupported;
  const int stride = cp.bw * 8;
  const uint8_t* in = cp.plane.data();
  const int dw = cp.dw, dh = cp.dh;
  ostride = dw * hf;
  const int oh = dh * vf;
  out.assign((size_t)ostride * oh, 0);
  auto row = [&](int r) { return in + (size_t)std::min(std::max(r, 0), dh - 1) * stride; };
  if (hf == 1 && vf == 1) {
    for (int r = 0; r < dh; ++r) std::memcpy(out.data() + (size_t)r * ostride, row(r), dw);
  } else if (hf == 2 && vf == 1 && dw > 2) {
    for (int r = 0; r < dh; ++r) {
      const uint8_t* ip = row(r);
      uint8_t* op = out.data() + (size_t)r * ostride;
      op[0] = ip[0];
      op[1] = (uint8_t)((ip[0] * 3 + ip[1] + 2) >> 2);
      for (int c = 1; c < dw - 1; ++c) {
        int v = ip[c] * 3;
        op[2 * c] = (uint8_t)((v + ip[c - 1] + 1) >> 2);
        op[2 * c + 1] = (uint8_t)((v + ip[c + 1] + 2) >> 2);
      }
      op[2 * dw - 2] = (uint8_t)((ip[dw - 1] * 3 + ip[dw - 2] + 1) >> 2);
      op[2 * dw - 1] = ip[dw - 1];
    }
  } else if (hf == 1 && vf == 2) {
    for (int r = 0; r < dh; ++r) {
      for (int v = 0; v < 2; ++v) {
        const uint8_t* i0 = row(r);
        const uint8_t* i1 = row(v == 0 ? r - 1 : r + 1);
        int bias = v == 0 ? 1 : 2;
        uint8_t* op = out.data() + (size_t)(2 * r + v) * ostride;
        for (int c = 0; c < dw; ++c) op[c] = (uint8_t)((i0[c] * 3 + i1[c] + bias) >> 2);
      }
    }
  } else if (hf == 2 && vf == 2 && dw > 2) {
    for (int r = 0; r < dh; ++r) {
      for (int v = 0; v < 2; ++v) {
        const uint8_t* i0 = row(r);
        const uint8_t* i1 = row(v == 0 ? r - 1 : r + 1);
        uint8_t* op = out.data() + (size_t)(2 * r + v) * ostride;
        int thiscol = i0[0] * 3 + i1[0];
        int nextcol = i0[1] * 3 + i1[1];
        op[0] = (uint8_t)((thiscol * 4 + 8) >> 4);
        op[1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        int lastcol = thiscol;
        thiscol = nextcol;
        for (int c = 1; c < dw - 1; ++c) {
          nextcol = i0[c + 1] * 3 + i1[c + 1];
          op[2 * c] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
          op[2 * c + 1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        op[2 * dw - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        op[2 * dw - 1] = (uint8_t)((thiscol * 4 + 7) >> 4);
      }
    }
  } else {  // box replication (libjpeg's h2v1/h2v2 plain and int_upsample)
    for (int r = 0; r < oh; ++r) {
      const uint8_t* ip = row(r / vf);
      uint8_t* op = out.data() + (size_t)r * ostride;
      for (int c = 0; c < ostride; ++c) op[c] = ip[c / hf];
    }
  }
  return 0;
}

// ------------------------------------------------------------------ JPEG encode

const uint8_t kStdLumQ[64] = {
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++k) {
        code[vals[k]] = (uint16_t)c++;
        size[vals[k]] = (uint8_t)l;
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  uint8_t* out;
  long cap, n = 0;
  uint32_t acc = 0;
  int nbits = 0;
  bool overflow = false;
  inline void byte(uint8_t b) {
    if (n < cap) out[n++] = b;
    else overflow = true;
  }
  inline void put(uint32_t v, int len) {
    if (len == 0) return;
    acc = (acc << len) | (v & ((1u << len) - 1));
    nbits += len;
    while (nbits >= 8) {
      uint8_t b = (uint8_t)(acc >> (nbits - 8));
      byte(b);
      if (b == 0xFF) byte(0);
      nbits -= 8;
    }
  }
  void flush() {  // pad with 1 bits
    if (nbits > 0) put(0x7F, 8 - nbits);
  }
};

// Forward DCT of one 8x8 block of level-shifted samples, in double precision.
struct Dct {
  double cs[8][8];
  Dct() {
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        cs[u][x] = (u == 0 ? std::sqrt(0.125) : 0.5) * std::cos((2 * x + 1) * u * M_PI / 16.0);
  }
  void forward(const double* in, double* out) const {
    double tmp[64];
    for (int y = 0; y < 8; ++y)
      for (int u = 0; u < 8; ++u) {
        double s = 0;
        for (int x = 0; x < 8; ++x) s += cs[u][x] * in[y * 8 + x];
        tmp[y * 8 + u] = s;
      }
    for (int v = 0; v < 8; ++v)
      for (int u = 0; u < 8; ++u) {
        double s = 0;
        for (int y = 0; y < 8; ++y) s += cs[v][y] * tmp[y * 8 + u];
        out[v * 8 + u] = s;
      }
  }
};

inline int magnitude_bits(int v) {
  int a = v < 0 ? -v : v, n = 0;
  while (a) { ++n; a >>= 1; }
  return n;
}

void encode_block(BitWriter& bw, const double* samples, const uint16_t* q, int& pred,
                  const EncTable& dc, const EncTable& ac, const Dct& dct) {
  double f[64];
  dct.forward(samples, f);
  int coef[64];
  for (int i = 0; i < 64; ++i) {
    double c = f[i] / q[i];
    coef[i] = (int)(c < 0 ? -std::floor(-c + 0.5) : std::floor(c + 0.5));
    const int lim = i ? 1023 : 2047;  // 10-bit AC and 11-bit DC magnitudes
    coef[i] = std::min(std::max(coef[i], -lim), lim);
  }
  int diff = coef[0] - pred;
  pred = coef[0];
  int s = magnitude_bits(diff);
  bw.put(dc.code[s], dc.size[s]);
  bw.put(diff < 0 ? diff - 1 : diff, s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[g_zigzag[k]];
    if (v == 0) { ++run; continue; }
    while (run > 15) { bw.put(ac.code[0xF0], ac.size[0xF0]); run -= 16; }
    int sz = magnitude_bits(v);
    int sym = (run << 4) | sz;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(v < 0 ? v - 1 : v, sz);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0x00], ac.size[0x00]);
}

void put16(BitWriter& bw, int v) { bw.byte((uint8_t)(v >> 8)); bw.byte((uint8_t)v); }

void write_dht(BitWriter& bw, int cls_id, const uint8_t* bits, const uint8_t* vals, int nvals) {
  bw.byte(0xFF); bw.byte(0xC4);
  put16(bw, 2 + 1 + 16 + nvals);
  bw.byte((uint8_t)cls_id);
  for (int i = 0; i < 16; ++i) bw.byte(bits[i]);
  for (int i = 0; i < nvals; ++i) bw.byte(vals[i]);
}

// libjpeg's jpeg_quality_scaling and jpeg_add_quant_table (force_baseline).
void scaled_table(const uint8_t* base, int quality, uint16_t* out) {
  quality = std::min(std::max(quality, 1), 100);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = ((long)base[i] * scale + 50L) / 100L;
    out[i] = (uint16_t)std::min(std::max(t, 1L), 255L);
  }
}

}  // namespace

extern "C" {

// PNG: `in` holds `height` rows of 1 filter byte + `stride` bytes; `out`
// gets height x stride unfiltered bytes. bpp: bytes per complete pixel
// (at least 1). Returns 0, or -1 on an unknown filter type.
int ic_png_unfilter(const uint8_t* in, int height, int stride, int bpp, uint8_t* out) {
  std::vector<uint8_t> zero(stride, 0);
  for (int r = 0; r < height; ++r) {
    const uint8_t* src = in + (size_t)r * (stride + 1);
    int f = src[0];
    ++src;
    uint8_t* dst = out + (size_t)r * stride;
    const uint8_t* up = r ? out + (size_t)(r - 1) * stride : zero.data();
    switch (f) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        for (int i = 0; i < stride; ++i) dst[i] = (uint8_t)(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < stride; ++i) dst[i] = (uint8_t)(src[i] + up[i]);
        break;
      case 3:
        for (int i = 0; i < stride; ++i)
          dst[i] = (uint8_t)(src[i] + (((i >= bpp ? dst[i - bpp] : 0) + up[i]) >> 1));
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          int a = i >= bpp ? dst[i - bpp] : 0, c = i >= bpp ? up[i - bpp] : 0;
          dst[i] = (uint8_t)(src[i] + paeth(a, up[i], c));
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}

// JPEG header: size, component count and EXIF orientation (1 when absent).
int ic_jpeg_info(const uint8_t* buf, long n, int* height, int* width, int* ncomp,
                 int* orientation) {
  Jpeg j;
  int rc = run(j, buf, n, false);
  if (rc < 0) return rc;
  if (!j.sof_seen) return kErrCorrupt;
  *height = j.height;
  *width = j.width;
  *ncomp = j.ncomp;
  *orientation = j.orientation;
  return 0;
}

// JPEG decode into `out`: height x width x 3 RGB, or height x width gray
// when `gray`, where height and width are the caller's (from ic_jpeg_info):
// a frame of another size is refused and nothing is written. The
// orientation is left to the caller.
int ic_jpeg_decode(const uint8_t* buf, long n, int height, int width, int gray, uint8_t* out) {
  Jpeg j;
  int rc = run(j, buf, n, true);
  if (rc < 0) return rc;
  if (!j.sof_seen) return kErrCorrupt;
  if (j.height != height || j.width != width) return kErrCorrupt;
  if (j.progressive) {  // every scan read: the IDCT of each block's coefficients
    for (int c = 0; c < j.ncomp; ++c) {
      Component& cp = j.comp[c];
      if (!cp.qt_latched) {  // a component no scan carried
        if (!j.qt_defined[cp.tq]) return kErrCorrupt;
        std::memcpy(cp.qt, j.qt[cp.tq], sizeof(cp.qt));
      }
      const int stride = cp.bw * 8;
      for (int by = 0; by < cp.bh; ++by)
        for (int bx = 0; bx < cp.bw; ++bx)
          idct_islow(cp.coef.data() + ((size_t)by * cp.bw + bx) * 64, cp.qt,
                     cp.plane.data() + (size_t)by * 8 * stride + bx * 8, stride);
    }
  }
  const int W = j.width, H = j.height;
  std::vector<uint8_t> up[3];
  int ustride[3];
  // libjpeg's colour spaces: one component is gray; three are YCbCr unless
  // an Adobe marker says transform 0, or (no JFIF, no Adobe) the ids are R G B
  bool rgb_src = false;
  if (j.ncomp == 3) {
    if (j.adobe_transform == 0) rgb_src = true;
    else if (j.adobe_transform < 0 && !j.jfif && j.comp[0].id == 'R' && j.comp[1].id == 'G' &&
             j.comp[2].id == 'B')
      rgb_src = true;
  }
  const int need = (gray && !rgb_src) ? 1 : j.ncomp;
  for (int c = 0; c < need; ++c) {
    rc = upsample(j, j.comp[c], up[c], ustride[c]);
    if (rc < 0) return rc;
  }
  if (j.ncomp == 1 || (gray && !rgb_src)) {
    for (int y = 0; y < H; ++y) {
      const uint8_t* ip = up[0].data() + (size_t)y * ustride[0];
      if (gray) {
        std::memcpy(out + (size_t)y * W, ip, W);
      } else {
        uint8_t* op = out + (size_t)y * W * 3;
        for (int x = 0; x < W; ++x) op[3 * x] = op[3 * x + 1] = op[3 * x + 2] = ip[x];
      }
    }
    return 0;
  }
  if (rgb_src) {
    for (int y = 0; y < H; ++y) {
      const uint8_t* r = up[0].data() + (size_t)y * ustride[0];
      const uint8_t* g = up[1].data() + (size_t)y * ustride[1];
      const uint8_t* b = up[2].data() + (size_t)y * ustride[2];
      if (gray) {  // jdcolor.c rgb_gray_convert
        uint8_t* op = out + (size_t)y * W;
        for (int x = 0; x < W; ++x)
          op[x] = (uint8_t)((19595 * r[x] + 38470 * g[x] + 7471 * b[x] + 32768) >> 16);
      } else {
        uint8_t* op = out + (size_t)y * W * 3;
        for (int x = 0; x < W; ++x) {
          op[3 * x] = r[x];
          op[3 * x + 1] = g[x];
          op[3 * x + 2] = b[x];
        }
      }
    }
    return 0;
  }
  // jdcolor.c ycc_rgb_convert, SCALEBITS 16
  static int cr_r[256], cb_b[256];
  static int32_t cr_g[256], cb_g[256];
  static bool tables = false;
  if (!tables) {
    const int32_t one_half = 1 << 15;
    for (int i = 0; i < 256; ++i) {
      int32_t x = i - 128;
      cr_r[i] = (int)((91881 * x + one_half) >> 16);    // FIX(1.40200)
      cb_b[i] = (int)((116130 * x + one_half) >> 16);   // FIX(1.77200)
      cr_g[i] = -46802 * x;                             // FIX(0.71414)
      cb_g[i] = -22554 * x + one_half;                  // FIX(0.34414)
    }
    tables = true;
  }
  for (int y = 0; y < H; ++y) {
    const uint8_t* yy = up[0].data() + (size_t)y * ustride[0];
    const uint8_t* cb = up[1].data() + (size_t)y * ustride[1];
    const uint8_t* cr = up[2].data() + (size_t)y * ustride[2];
    uint8_t* op = out + (size_t)y * W * 3;
    for (int x = 0; x < W; ++x) {
      int Y = yy[x];
      op[3 * x] = clamp8(Y + cr_r[cr[x]]);
      op[3 * x + 1] = clamp8(Y + (int)((cb_g[cb[x]] + cr_g[cr[x]]) >> 16));
      op[3 * x + 2] = clamp8(Y + cb_b[cb[x]]);
    }
  }
  return 0;
}

// Baseline JPEG encode of a height x width x channels (1: gray, 3: RGB)
// image at `quality`; colour is 4:2:0. Returns the file's length, or
// kErrSpace when `cap` bytes do not hold it.
long ic_jpeg_encode(const uint8_t* img, int height, int width, int channels, int quality,
                    uint8_t* out, long cap) {
  if (!(channels == 1 || channels == 3) || height < 1 || width < 1 || height > 65535 ||
      width > 65535)
    return kErrUnsupported;
  static const Dct dct;
  uint16_t ql[64], qc[64];
  scaled_table(kStdLumQ, quality, ql);
  scaled_table(kStdChromQ, quality, qc);
  EncTable dcl, dcc, acl, acc;
  dcl.build(kDcLumBits, kDcVals);
  dcc.build(kDcChromBits, kDcVals);
  acl.build(kAcLumBits, kAcLumVals);
  acc.build(kAcChromBits, kAcChromVals);
  const bool color = channels == 3;
  const int mcu = color ? 16 : 8;
  const int mw = (width + mcu - 1) / mcu, mh = (height + mcu - 1) / mcu;
  const int pw = mw * mcu, ph = mh * mcu;
  // planes padded to whole MCUs by repeating the last column and row
  std::vector<uint8_t> Y((size_t)pw * ph), Cb, Cr;
  if (color) {
    Cb.resize((size_t)pw * ph);
    Cr.resize((size_t)pw * ph);
  }
  for (int y = 0; y < ph; ++y) {
    const uint8_t* ip = img + (size_t)std::min(y, height - 1) * width * channels;
    for (int x = 0; x < pw; ++x) {
      const uint8_t* px = ip + (size_t)std::min(x, width - 1) * channels;
      size_t o = (size_t)y * pw + x;
      if (!color) {
        Y[o] = px[0];
        continue;
      }
      int32_t r = px[0], g = px[1], b = px[2];
      // jccolor.c rgb_ycc_convert, SCALEBITS 16
      Y[o] = (uint8_t)((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
      Cb[o] = (uint8_t)((-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16);
      Cr[o] = (uint8_t)((32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16);
    }
  }
  std::vector<uint8_t> cbs, crs;
  const int cw = pw / 2, ch = ph / 2;
  if (color) {  // jcsample.c h2v2_downsample: bias 1, 2, 1, 2, ...
    cbs.resize((size_t)cw * ch);
    crs.resize((size_t)cw * ch);
    for (int y = 0; y < ch; ++y) {
      int bias = 1;
      for (int x = 0; x < cw; ++x) {
        size_t a = (size_t)(2 * y) * pw + 2 * x, b2 = a + pw;
        cbs[(size_t)y * cw + x] = (uint8_t)((Cb[a] + Cb[a + 1] + Cb[b2] + Cb[b2 + 1] + bias) >> 2);
        crs[(size_t)y * cw + x] = (uint8_t)((Cr[a] + Cr[a + 1] + Cr[b2] + Cr[b2 + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }
  BitWriter bw{out, cap};
  bw.byte(0xFF); bw.byte(0xD8);
  // APP0 JFIF 1.01, no density
  const uint8_t app0[] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01, 0x01,
                          0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  for (uint8_t b : app0) bw.byte(b);
  for (int t = 0; t < (color ? 2 : 1); ++t) {
    const uint16_t* q = t ? qc : ql;
    bw.byte(0xFF); bw.byte(0xDB);
    put16(bw, 2 + 65);
    bw.byte((uint8_t)t);
    for (int k = 0; k < 64; ++k) bw.byte((uint8_t)q[g_zigzag[k]]);
  }
  bw.byte(0xFF); bw.byte(0xC0);
  put16(bw, 8 + 3 * channels);
  bw.byte(8);
  put16(bw, height);
  put16(bw, width);
  bw.byte((uint8_t)channels);
  for (int c = 0; c < channels; ++c) {
    bw.byte((uint8_t)(c + 1));
    bw.byte(c == 0 ? (color ? 0x22 : 0x11) : 0x11);
    bw.byte(c == 0 ? 0 : 1);
  }
  write_dht(bw, 0x00, kDcLumBits, kDcVals, 12);
  write_dht(bw, 0x10, kAcLumBits, kAcLumVals, 162);
  if (color) {
    write_dht(bw, 0x01, kDcChromBits, kDcVals, 12);
    write_dht(bw, 0x11, kAcChromBits, kAcChromVals, 162);
  }
  bw.byte(0xFF); bw.byte(0xDA);
  put16(bw, 6 + 2 * channels);
  bw.byte((uint8_t)channels);
  for (int c = 0; c < channels; ++c) {
    bw.byte((uint8_t)(c + 1));
    bw.byte(c == 0 ? 0x00 : 0x11);
  }
  bw.byte(0); bw.byte(63); bw.byte(0);
  int pred[3] = {0, 0, 0};
  double blk[64];
  auto load = [&](const std::vector<uint8_t>& plane, int stride, int y0, int x0) {
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x)
        blk[y * 8 + x] = (double)plane[(size_t)(y0 + y) * stride + x0 + x] - 128.0;
  };
  for (int my = 0; my < mh; ++my) {
    for (int mx = 0; mx < mw; ++mx) {
      if (!color) {
        load(Y, pw, my * 8, mx * 8);
        encode_block(bw, blk, ql, pred[0], dcl, acl, dct);
        continue;
      }
      for (int by = 0; by < 2; ++by)
        for (int bx = 0; bx < 2; ++bx) {
          load(Y, pw, my * 16 + by * 8, mx * 16 + bx * 8);
          encode_block(bw, blk, ql, pred[0], dcl, acl, dct);
        }
      load(cbs, cw, my * 8, mx * 8);
      encode_block(bw, blk, qc, pred[1], dcc, acc, dct);
      load(crs, cw, my * 8, mx * 8);
      encode_block(bw, blk, qc, pred[2], dcc, acc, dct);
    }
  }
  bw.flush();
  bw.byte(0xFF); bw.byte(0xD9);
  if (bw.overflow) return kErrSpace;
  return bw.n;
}

}  // extern "C"
