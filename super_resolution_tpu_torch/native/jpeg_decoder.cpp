// JPEG entropy decoding for super_resolution_tpu_torch.
//
// The serial half of the port's JPEG reader (utils/jpeg.py): marker parsing
// and Huffman decoding of 8-bit sequential (SOF0 / SOF1) and progressive
// (SOF2) JPEG into quantised DCT coefficients, one int16 block of 64 (natural
// order) per 8x8 block of each component. Dequantisation, the inverse DCT,
// chroma upsampling and the colour conversion are vectorised numpy in
// utils/jpeg.py.
//
// Handled: 1 and 3 components, sampling factors 1-4, interleaved and
// single-component scans, restart markers, any Huffman tables (the standard
// tables of ITU T.81 Annex K.3 stand in for a missing DHT, as in Motion-JPEG
// frames), sizes that are not multiples of the MCU. Progressive files: DC
// first and refine scans (interleaved or not), AC first scans with spectral
// selection and end-of-band runs, AC refinement scans with their correction
// bits, restarts inside every kind of scan; every scan is gathered into the
// one coefficient buffer. Refused with status -2 and a message naming the
// feature: a progressive file whose scans leave a low coefficient unrefined
// (libjpeg-turbo then smooths blocks, jdcoefct.c), lossless, hierarchical and
// arithmetic-coded JPEG, precisions other than 8 bits, 2 or 4 components.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 jpeg_decoder.cpp -o <lib>.so
// (native/__init__.py does this at first use, into
// super_resolution_tpu_torch/_build/).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kNaturalOrder[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ITU T.81 Annex K.3: DC / AC tables for luminance (0) and chrominance (1).
constexpr uint8_t kDcBits[2][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
constexpr uint8_t kDcValues[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcBits[2][16] = {{0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
                                    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
constexpr uint8_t kAcValues[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
     0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
     0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
     0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
     0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
     0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
     0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
     0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
     0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
     0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
     0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
     0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
     0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
     0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
     0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
     0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
     0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

constexpr int kLookBits = 9;

struct Status {
  int code = 0;  // 0 ok, -1 corrupt or invalid, -2 not supported
  std::string message;
  bool Fail(int c, const std::string& m) {
    if (code == 0) {
      code = c;
      message = m;
    }
    return false;
  }
};

// A canonical Huffman table (ITU T.81 Annex C / F.2.2.3) with a lookup of
// the first kLookBits bits.
struct HuffmanTable {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint8_t values[256];
  uint16_t lookup[1 << kLookBits];  // (length << 8) | value, 0 if longer

  bool Build(const uint8_t bits[16], const uint8_t* vals, int count, Status* st) {
    int total = 0;
    for (int l = 0; l < 16; ++l) total += bits[l];
    if (total != count || total > 256) return st->Fail(-1, "bad Huffman table");
    std::memcpy(values, vals, count);
    std::memset(lookup, 0, sizeof(lookup));
    int32_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
      valoffset[l] = k - code;
      for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
        if (l <= kLookBits) {
          const int shift = kLookBits - l;
          for (int j = 0; j < (1 << shift); ++j) {
            lookup[(code << shift) | j] = static_cast<uint16_t>((l << 8) | values[k]);
          }
        }
      }
      maxcode[l] = bits[l - 1] ? code - 1 : -1;
      if (code > (1 << l)) return st->Fail(-1, "bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
    return true;
  }
};

// MSB-first bits of the entropy-coded data: stuffed 0xFF00 bytes are
// undone; at a marker, zero bits are supplied (as libjpeg does) and the
// marker is left in place.
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
  uint64_t acc = 0;
  int bits = 0;
  bool at_marker = false;

  void Fill() {
    while (bits <= 56) {
      uint64_t b = 0;
      if (!at_marker && pos < size) {
        b = data[pos];
        if (b == 0xFF) {
          if (pos + 1 < size && data[pos + 1] == 0x00) {
            pos += 2;
          } else {
            at_marker = true;
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      acc |= b << (56 - bits);
      bits += 8;
    }
  }
  uint32_t Get(int n) {
    if (n == 0) return 0;
    if (bits < n) Fill();
    const uint32_t v = static_cast<uint32_t>(acc >> (64 - n));
    acc <<= n;
    bits -= n;
    return v;
  }
  void Reset() {
    acc = 0;
    bits = 0;
    at_marker = false;
  }
};

inline int Extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1 : static_cast<int>(v);
}

bool DecodeSymbol(BitReader* br, const HuffmanTable& t, int* symbol, Status* st) {
  if (br->bits < 16) br->Fill();
  const uint32_t peek = static_cast<uint32_t>(br->acc >> (64 - kLookBits));
  const uint16_t hit = t.lookup[peek];
  if (hit) {
    const int len = hit >> 8;
    br->acc <<= len;
    br->bits -= len;
    *symbol = hit & 0xFF;
    return true;
  }
  const uint32_t code16 = static_cast<uint32_t>(br->acc >> 48);
  for (int l = kLookBits + 1; l <= 16; ++l) {
    const int32_t code = static_cast<int32_t>(code16 >> (16 - l));
    if (code <= t.maxcode[l]) {
      br->acc <<= l;
      br->bits -= l;
      *symbol = t.values[t.valoffset[l] + code];
      return true;
    }
  }
  return st->Fail(-1, "corrupt JPEG data: bad Huffman code");
}

// libjpeg-turbo (jdcoefct.c, SAVED_COEFS) smooths blocks while any of the
// first 10 coefficients of a progressive file is not refined to bit 0.
constexpr int kSmoothedCoefs = 10;

struct Component {
  int id, h, v, tq;
  int coef_bits[64];  // progressive: Al of the last scan that coded each coefficient, -1 before any
  int64_t blocks_w, blocks_h;  // the buffer, padded to whole MCUs
  int64_t width_in_blocks, height_in_blocks;  // the blocks that hold samples
  bool latched = false;
  uint16_t quant[64];  // natural order
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  Status st;
  int width = 0, height = 0, precision = 0, sof = -1;
  bool progressive = false;
  int eobrun = 0;
  int hmax = 1, vmax = 1;
  int64_t mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  int adobe_transform = -1;
  bool jfif = false;
  std::vector<Component> comps;
  uint16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  HuffmanTable dc[4], ac[4];
  int16_t* coefs = nullptr;
  std::vector<int64_t> offsets;

  int Byte() { return pos < size ? data[pos++] : -1; }
  int Word() {
    const int a = Byte(), b = Byte();
    return (a < 0 || b < 0) ? -1 : (a << 8) | b;
  }

  // The next marker code, skipping fill bytes; -1 at the end of the data.
  int NextMarker() {
    while (pos < size) {
      if (data[pos] != 0xFF) {
        ++pos;
        continue;
      }
      while (pos < size && data[pos] == 0xFF) ++pos;
      if (pos >= size) return -1;
      const int m = data[pos++];
      if (m != 0x00) return m;
    }
    return -1;
  }

  bool ParseSOF(int marker, size_t end) {
    if (sof >= 0) return st.Fail(-1, "more than one frame header");
    static const char* kNames[16] = {
        "baseline", "extended sequential", "progressive JPEG (SOF2)", "lossless JPEG (SOF3)", "",
        "hierarchical JPEG (SOF5)", "hierarchical progressive JPEG (SOF6)",
        "hierarchical lossless JPEG (SOF7)", "", "arithmetic-coded JPEG (SOF9)",
        "arithmetic-coded progressive JPEG (SOF10)", "arithmetic-coded lossless JPEG (SOF11)", "",
        "arithmetic-coded hierarchical JPEG (SOF13)",
        "arithmetic-coded hierarchical progressive JPEG (SOF14)",
        "arithmetic-coded hierarchical lossless JPEG (SOF15)"};
    const int n = marker - 0xC0;
    if (n > 2) return st.Fail(-2, kNames[n]);
    sof = n;
    progressive = n == 2;
    precision = Byte();
    height = Word();
    width = Word();
    const int nc = Byte();
    if (nc < 0 || pos + 3 * static_cast<size_t>(nc) > end) return st.Fail(-1, "truncated frame header");
    if (precision != 8) return st.Fail(-2, std::to_string(precision) + "-bit JPEG");
    if (nc == 4) return st.Fail(-2, "4-component (CMYK / YCCK) JPEG");
    if (nc != 1 && nc != 3) return st.Fail(-2, std::to_string(nc) + "-component JPEG");
    if (height == 0) return st.Fail(-2, "JPEG whose height is set by a DNL marker");
    if (width <= 0 || height < 0) return st.Fail(-1, "bad image size");
    for (int i = 0; i < nc; ++i) {
      Component c;
      c.id = Byte();
      const int hv = Byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = Byte();
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return st.Fail(-1, "bad component in frame header");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
      comps.push_back(c);
    }
    for (const auto& c : comps) {
      if (hmax % c.h || vmax % c.v) return st.Fail(-2, "JPEG with fractional chroma sampling ratios");
    }
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    int64_t off = 0;
    for (auto& c : comps) {
      const int64_t cw = (static_cast<int64_t>(width) * c.h + hmax - 1) / hmax;
      const int64_t ch = (static_cast<int64_t>(height) * c.v + vmax - 1) / vmax;
      c.width_in_blocks = (cw + 7) / 8;
      c.height_in_blocks = (ch + 7) / 8;
      c.blocks_w = mcus_x * c.h;
      c.blocks_h = mcus_y * c.v;
      offsets.push_back(off);
      off += c.blocks_w * c.blocks_h * 64;
    }
    offsets.push_back(off);
    return true;
  }

  bool ParseDQT(size_t end) {
    while (pos < end) {
      const int pq_tq = Byte();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) return st.Fail(-1, "bad quantisation table");
      if (pos + (pq ? 128 : 64) > end) return st.Fail(-1, "truncated quantisation table");
      for (int k = 0; k < 64; ++k) quant[tq][kNaturalOrder[k]] = static_cast<uint16_t>(pq ? Word() : Byte());
      quant_defined[tq] = true;
    }
    return true;
  }

  bool ParseDHT(size_t end) {
    while (pos < end) {
      const int tc_th = Byte();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3 || pos + 16 > end) return st.Fail(-1, "bad Huffman table header");
      uint8_t bits[16];
      int count = 0;
      for (int l = 0; l < 16; ++l) count += bits[l] = static_cast<uint8_t>(Byte());
      if (count > 256 || pos + count > end) return st.Fail(-1, "bad Huffman table");
      if (!(tc ? ac[th] : dc[th]).Build(bits, data + pos, count, &st)) return false;
      pos += count;
    }
    return true;
  }

  void StandardTables() {
    for (int t = 0; t < 2; ++t) {
      if (!dc[t].defined) dc[t].Build(kDcBits[t], kDcValues, 12, &st);
      if (!ac[t].defined) ac[t].Build(kAcBits[t], kAcValues[t], 162, &st);
    }
  }

  int16_t* Block(int ci, int64_t bx, int64_t by) {
    return coefs + offsets[ci] + (by * comps[ci].blocks_w + bx) * 64;
  }

  // The DC difference of a sequential block, or of a progressive DC first scan (scaled by 2^al).
  bool DecodeDC(BitReader* br, int16_t* blk, const HuffmanTable& d, int* pred, int al) {
    int s;
    if (!DecodeSymbol(br, d, &s, &st)) return false;
    if (s > 11) return st.Fail(-1, "corrupt JPEG data: bad DC difference");
    if (s) *pred += Extend(br->Get(s), s);
    blk[0] = static_cast<int16_t>(*pred * (1 << al));
    return true;
  }

  // A sequential block: DC difference, then the AC run-lengths.
  bool DecodeBlock(BitReader* br, int16_t* blk, const HuffmanTable& d, const HuffmanTable& a, int* pred) {
    if (!DecodeDC(br, blk, d, pred, 0)) return false;
    for (int k = 1; k < 64; ++k) {
      int rs;
      if (!DecodeSymbol(br, a, &rs, &st)) return false;
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) return st.Fail(-1, "corrupt JPEG data: coefficient index past 63");
        blk[kNaturalOrder[k]] = static_cast<int16_t>(Extend(br->Get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return true;
  }

  // Progressive scans (ITU T.81 G.1.2; libjpeg-turbo's jdphuff.c).
  void DecodeDCRefine(BitReader* br, int16_t* blk, int al) {
    if (br->Get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  bool DecodeACFirst(BitReader* br, int16_t* blk, const HuffmanTable& a, int ss, int se, int al) {
    if (eobrun > 0) {
      --eobrun;
      return true;
    }
    for (int k = ss; k <= se; ++k) {
      int rs;
      if (!DecodeSymbol(br, a, &rs, &st)) return false;
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > se) return st.Fail(-1, "corrupt JPEG data: coefficient index past the spectral band");
        blk[kNaturalOrder[k]] = static_cast<int16_t>(Extend(br->Get(s), s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += static_cast<int>(br->Get(r));
        --eobrun;
        break;
      }
    }
    return true;
  }

  // A correction bit for a coefficient that is already non-zero.
  static void Refine(BitReader* br, int16_t* coef, int p1) {
    if (br->Get(1) && (*coef & p1) == 0) *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef - p1);
  }

  bool DecodeACRefine(BitReader* br, int16_t* blk, const HuffmanTable& a, int ss, int se, int al) {
    const int p1 = 1 << al;
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs;
        if (!DecodeSymbol(br, a, &rs, &st)) return false;
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) return st.Fail(-1, "corrupt JPEG data: bad refinement value");
          s = br->Get(1) ? p1 : -p1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += static_cast<int>(br->Get(r));
          break;
        }
        // Skip r zero coefficients (refining the non-zero ones passed), then place s.
        do {
          int16_t* coef = blk + kNaturalOrder[k];
          if (*coef != 0) {
            Refine(br, coef, p1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          if (k > se) return st.Fail(-1, "corrupt JPEG data: coefficient index past the spectral band");
          blk[kNaturalOrder[k]] = static_cast<int16_t>(s);
        }
      }
    }
    if (eobrun > 0) {
      // The rest of the band holds no new coefficient: refine the non-zero ones.
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNaturalOrder[k];
        if (*coef != 0) Refine(br, coef, p1);
      }
      --eobrun;
    }
    return true;
  }

  // One scan; `pos` is just past the SOS header on entry, at the first
  // byte after the scan's entropy-coded data on exit.
  bool DecodeScan(const std::vector<int>& sel, const std::vector<int>& td, const std::vector<int>& ta, int ss,
                  int se, int ah, int al) {
    const bool dc_scan = ss == 0, refine = ah != 0;
    for (size_t i = 0; i < sel.size(); ++i) {
      Component& c = comps[sel[i]];
      if (!c.latched) {
        if (!quant_defined[c.tq]) return st.Fail(-1, "component without its quantisation table");
        std::memcpy(c.quant, quant[c.tq], sizeof(c.quant));
        c.latched = true;
      }
      const bool needs_dc = !progressive || (dc_scan && !refine);
      const bool needs_ac = !progressive || !dc_scan;
      if ((needs_dc && !dc[td[i]].defined) || (needs_ac && !ac[ta[i]].defined)) {
        return st.Fail(-1, "scan without its Huffman table");
      }
      if (progressive) {
        for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
      }
    }
    BitReader br{data, size, pos};
    int pred[4] = {0, 0, 0, 0};
    eobrun = 0;
    const bool interleaved = sel.size() > 1;
    const int64_t units_x = interleaved ? mcus_x : comps[sel[0]].width_in_blocks;
    const int64_t units_y = interleaved ? mcus_y : comps[sel[0]].height_in_blocks;
    const int64_t total = units_x * units_y;
    int next_restart = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        // Byte-align, expect RSTn, reset the DC predictions and the end-of-band run.
        br.Reset();
        size_t p = br.pos;
        while (p < size && data[p] == 0xFF && p + 1 < size && data[p + 1] == 0xFF) ++p;
        if (p + 1 >= size || data[p] != 0xFF || data[p + 1] != 0xD0 + next_restart) {
          return st.Fail(-1, "corrupt JPEG data: missing restart marker");
        }
        br.pos = p + 2;
        next_restart = (next_restart + 1) & 7;
        std::memset(pred, 0, sizeof(pred));
        eobrun = 0;
      }
      const int64_t mx = m % units_x, my = m / units_x;
      for (size_t i = 0; i < sel.size(); ++i) {
        const Component& c = comps[sel[i]];
        const int bh = interleaved ? c.v : 1, bw = interleaved ? c.h : 1;
        for (int v = 0; v < bh; ++v) {
          for (int h = 0; h < bw; ++h) {
            int16_t* blk = Block(sel[i], mx * bw + h, my * bh + v);
            bool ok = true;
            if (!progressive) {
              ok = DecodeBlock(&br, blk, dc[td[i]], ac[ta[i]], &pred[i]);
            } else if (dc_scan) {
              if (refine) {
                DecodeDCRefine(&br, blk, al);
              } else {
                ok = DecodeDC(&br, blk, dc[td[i]], &pred[i], al);
              }
            } else {
              ok = refine ? DecodeACRefine(&br, blk, ac[ta[i]], ss, se, al)
                          : DecodeACFirst(&br, blk, ac[ta[i]], ss, se, al);
            }
            if (!ok) return false;
          }
        }
      }
    }
    pos = br.pos;
    return true;
  }

  // libjpeg-turbo's smoothing_ok (jdcoefct.c) after the last scan: true
  // where it would smooth the blocks, which this decoder does not do.
  bool NeedsBlockSmoothing() const {
    if (!progressive) return false;
    bool useful = false;
    for (const auto& c : comps) {
      for (int k = 0; k < kSmoothedCoefs; ++k) {
        if (c.quant[kNaturalOrder[k]] == 0) return false;
      }
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < kSmoothedCoefs; ++k) useful |= c.coef_bits[k] != 0;
    }
    return useful;
  }

  bool ParseSOS(size_t end, bool headers_only) {
    if (sof < 0) return st.Fail(-1, "scan before the frame header");
    const int ns = Byte();
    if (ns < 1 || ns > 4 || pos + 2 * static_cast<size_t>(ns) + 3 > end) return st.Fail(-1, "bad scan header");
    std::vector<int> sel, td, ta;
    for (int i = 0; i < ns; ++i) {
      const int id = Byte(), t = Byte();
      int found = -1;
      for (size_t k = 0; k < comps.size(); ++k) {
        if (comps[k].id == id) found = static_cast<int>(k);
      }
      if (found < 0 || (t >> 4) > 3 || (t & 15) > 3) return st.Fail(-1, "bad component in scan header");
      sel.push_back(found);
      td.push_back(t >> 4);
      ta.push_back(t & 15);
    }
    const int ss = Byte(), se = Byte(), a = Byte();
    const int ah = a >> 4, al = a & 15;
    if (!progressive) {
      if (ss != 0 || se != 63 || a != 0) return st.Fail(-1, "sequential scan with a spectral selection");
    } else {
      // jdphuff.c's start_pass_phuff_decoder: these are errors, not warnings.
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      bad |= (ah != 0 && al != ah - 1) || al > 13;
      if (bad) return st.Fail(-1, "invalid progressive scan parameters");
    }
    int blocks = 0;
    for (int i = 0; i < ns; ++i) blocks += comps[sel[i]].h * comps[sel[i]].v;
    if (ns > 1 && blocks > 10) return st.Fail(-1, "more than 10 blocks in an MCU");
    pos = end;
    if (headers_only) return true;
    StandardTables();
    return DecodeScan(sel, td, ta, ss, se, ah, al);
  }

  // Parses markers and, unless `headers_only`, decodes every scan. Returns
  // when EOI is met (or, with `headers_only`, at the first scan).
  bool Run(bool headers_only) {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) return st.Fail(-1, "not a JPEG file (no SOI marker)");
    pos = 2;
    bool scanned = false;
    while (true) {
      const int m = NextMarker();
      if (m < 0) {
        if (scanned) return true;  // EOI missing after the data: libjpeg warns and goes on
        return st.Fail(-1, "JPEG data ends before the first scan");
      }
      if (m == 0xD9) return scanned || st.Fail(-1, "JPEG file without a scan");
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      const int len = Word();
      if (len < 2 || pos + len - 2 > size) return st.Fail(-1, "truncated JPEG marker segment");
      const size_t end = pos + len - 2;
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        if (!ParseSOF(m, end)) return false;
      } else if (m == 0xCC) {
        return st.Fail(-2, "arithmetic-coded JPEG (DAC)");
      } else if (m == 0xC4) {
        if (!ParseDHT(end)) return false;
      } else if (m == 0xDB) {
        if (!ParseDQT(end)) return false;
      } else if (m == 0xDD) {
        restart_interval = Word();
      } else if (m == 0xDA) {
        if (!ParseSOS(end, headers_only)) return false;
        if (headers_only) return true;
        scanned = true;
        continue;
      } else if (m == 0xE0 && len >= 7 && std::memcmp(data + pos, "JFIF\0", 5) == 0) {
        jfif = true;
      } else if (m == 0xEE && len >= 14 && std::memcmp(data + pos, "Adobe", 5) == 0) {
        adobe_transform = data[pos + 11];
      }
      pos = end;
    }
  }
};

}  // namespace

extern "C" {

// Frame description filled by sr_jpeg_decode.
struct SrJpegInfo {
  int32_t width, height, num_components;
  int32_t jfif, adobe_transform;  // adobe_transform -1: no Adobe marker
  int32_t component_id[3], h[3], v[3];
  int64_t blocks_w[3], blocks_h[3];
  int64_t num_coefficients;  // int16 values the coefficient buffer needs
  uint16_t quant[3][64];     // per component, natural order
};

// Decodes a sequential or progressive JPEG held in `data`. With `coefs` null (or `capacity`
// below `info->num_coefficients`), parses the headers up to the first scan,
// fills `info` and returns 1; else decodes every scan into `coefs` (zeroed
// by the caller): component c's blocks start at the sum of the earlier
// components' blocks_w * blocks_h * 64 values, row-major over blocks, 64
// coefficients per block in natural order; returns 0. Errors: -1 corrupt or
// invalid data, -2 a feature this decoder does not support; `message`
// (`message_len` bytes) says which.
int sr_jpeg_decode(const uint8_t* data, int64_t size, SrJpegInfo* info, int16_t* coefs, int64_t capacity,
                   char* message, int message_len) {
  Decoder dec;
  dec.data = data;
  dec.size = static_cast<size_t>(size);
  const bool headers_only = coefs == nullptr;
  dec.coefs = coefs;
  bool ok = dec.Run(true);
  if (ok) {
    std::memset(info, 0, sizeof(*info));
    info->width = dec.width;
    info->height = dec.height;
    info->num_components = static_cast<int32_t>(dec.comps.size());
    info->num_coefficients = dec.offsets.back();
    for (size_t i = 0; i < dec.comps.size(); ++i) {
      info->component_id[i] = dec.comps[i].id;
      info->h[i] = dec.comps[i].h;
      info->v[i] = dec.comps[i].v;
      info->blocks_w[i] = dec.comps[i].blocks_w;
      info->blocks_h[i] = dec.comps[i].blocks_h;
    }
    if (!headers_only && capacity >= info->num_coefficients) {
      Decoder full;
      full.data = data;
      full.size = dec.size;
      full.coefs = coefs;
      ok = full.Run(false);
      if (ok) {
        info->jfif = full.jfif;
        info->adobe_transform = full.adobe_transform;
        for (size_t i = 0; i < full.comps.size(); ++i) {
          if (!full.comps[i].latched) {
            ok = full.st.Fail(-1, "a component that no scan codes");
            break;
          }
          std::memcpy(info->quant[i], full.comps[i].quant, sizeof(info->quant[i]));
        }
        if (ok && full.NeedsBlockSmoothing()) {
          ok = full.st.Fail(-2, "progressive JPEG with incomplete refinement (its first coefficients not refined to "
                                "bit 0; libjpeg-turbo smooths such blocks)");
        }
        if (ok) return 0;
      }
      dec.st = full.st;
    } else {
      return 1;
    }
  }
  if (message && message_len > 0) std::snprintf(message, message_len, "%s", dec.st.message.c_str());
  return dec.st.code ? dec.st.code : -1;
}

}  // extern "C"
