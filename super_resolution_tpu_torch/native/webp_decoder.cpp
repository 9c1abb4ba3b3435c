// WebP decoding for super_resolution_tpu_torch's codec (utils/webp.py): the
// serial half, bound with ctypes. The RIFF container is parsed in Python;
// this file decodes the chunks' payloads.
//
// - VP8L (lossless, the WebP lossless bitstream specification, RFC 9649):
//   prefix-code groups with the meta prefix image, the colour cache, LZ77
//   backward references with the 120-entry distance map, and the four
//   transforms (predictor with its 14 modes, cross-colour, subtract-green,
//   colour indexing with pixel bundling). Output: ARGB, one uint32 a pixel.
// - VP8 (lossy key frames, RFC 6386): the boolean entropy decoder, segments
//   and their quantisers, token probabilities with their updates, 16x16,
//   4x4 and chroma intra prediction, the inverse WHT and DCT, the simple and
//   normal loop filters; then YUV 4:2:0 to BGR with libwebp's "fancy"
//   upsampler (each output chroma sample 9/16, 3/16, 3/16, 1/16 of its four
//   nearest) and its 14-bit fixed-point conversion, as WebPDecodeBGR does.
// - ALPH: raw or VP8L-compressed alpha planes and their horizontal,
//   vertical and gradient filters.
//
// The tables below are the normative ones of RFC 6386 (coefficient
// probabilities and their update probabilities, the 4x4 mode
// probabilities, the quantiser steps). The 4x4 intra modes are numbered as
// libwebp numbers them (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU), and so is
// the mode-probability table.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 webp_decoder.cpp -o <lib>.so
// (native/__init__.py does this at first use, into
// super_resolution_tpu_torch/_build/).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ======================================================================= VP8L

enum Vp8lStatus { kOk = 0, kTruncated = -1, kBadCode = -2, kBadData = -3, kBadHeader = -4 };

// Least-significant-bit-first reader.
class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size) : data_(data), size_(size) {}
  uint32_t Read(int n) {
    const uint32_t v = Peek(n);
    Skip(n);
    return v;
  }
  uint32_t Peek(int n) {
    Fill();
    return n == 0 ? 0 : static_cast<uint32_t>(bits_ & ((uint64_t{1} << n) - 1));
  }
  void Skip(int n) {
    if (n > count_) {  // past the end of the data
      eos_ = true;
      count_ = 0;
      bits_ = 0;
      return;
    }
    bits_ >>= n;
    count_ -= n;
  }
  bool eos() const { return eos_; }

 private:
  void Fill() {
    while (count_ <= 56 && pos_ < size_) {
      bits_ |= static_cast<uint64_t>(data_[pos_++]) << count_;
      count_ += 8;
    }
  }
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
  uint64_t bits_ = 0;
  int count_ = 0;
  bool eos_ = false;
};

constexpr int kMaxCodeLength = 15;
constexpr int kRootBits = 10;

// A canonical prefix code: a table on the next kRootBits bits for codes up
// to kRootBits long, the canonical decode for longer ones. A code with one
// symbol reads no bits.
class PrefixCode {
 public:
  // False when the lengths do not make a complete code (or make none).
  bool Build(const std::vector<int>& lengths) {
    int count[kMaxCodeLength + 1] = {0};
    int used = 0;
    int last = -1;
    for (size_t s = 0; s < lengths.size(); ++s) {
      if (lengths[s] > 0) {
        ++count[lengths[s]];
        ++used;
        last = static_cast<int>(s);
      }
    }
    if (used == 0) return false;
    single_ = used == 1 ? last : -1;
    if (single_ >= 0) return true;
    int left = 1;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      left = (left << 1) - count[len];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    int offset[kMaxCodeLength + 2] = {0};
    for (int len = 1; len <= kMaxCodeLength; ++len) offset[len + 1] = offset[len] + count[len];
    sorted_.assign(used, 0);
    for (size_t s = 0; s < lengths.size(); ++s) {
      if (lengths[s] > 0) sorted_[offset[lengths[s]]++] = static_cast<uint16_t>(s);
    }
    std::copy(count, count + kMaxCodeLength + 1, count_);
    table_.assign(1 << kRootBits, 0);
    int code = 0;
    int index = 0;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      for (int k = 0; k < count[len]; ++k, ++code, ++index) {
        if (len > kRootBits) continue;
        int reversed = 0;
        for (int b = 0; b < len; ++b) reversed |= ((code >> b) & 1) << (len - 1 - b);
        for (int fill = reversed; fill < (1 << kRootBits); fill += 1 << len) {
          table_[fill] = static_cast<uint32_t>(sorted_[index]) << 4 | static_cast<uint32_t>(len);
        }
      }
      code <<= 1;
    }
    return true;
  }
  int Read(BitReader& br) const {
    if (single_ >= 0) return single_;
    const uint32_t entry = table_[br.Peek(kRootBits)];
    if (entry != 0) {
      br.Skip(entry & 15);
      return static_cast<int>(entry >> 4);
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      code |= static_cast<int>(br.Read(1));
      const int n = count_[len];
      if (code - first < n) return sorted_[index + code - first];
      index += n;
      first = (first + n) << 1;
      code <<= 1;
    }
    return -1;
  }

 private:
  int single_ = -1;
  int count_[kMaxCodeLength + 1] = {0};
  std::vector<uint16_t> sorted_;
  std::vector<uint32_t> table_;
};

constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

// (row << 4) | (8 - column) of distance codes 1 to 120 (the 2D neighbourhood
// of the lossless bitstream specification).
constexpr uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37, 0x39,
    0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a,
    0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e, 0x66, 0x6a, 0x22, 0x2e,
    0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f,
    0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72,
    0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

int PlaneCodeToDistance(int xsize, int plane_code) {
  if (plane_code > 120) return plane_code - 120;
  const int code = kCodeToPlane[plane_code - 1];
  const int dist = (code >> 4) * xsize + (8 - (code & 15));
  return dist >= 1 ? dist : 1;
}

inline uint32_t AddPixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t Average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline int Channel(uint32_t v, int shift) { return static_cast<int>((v >> shift) & 0xff); }
inline uint32_t Clip255(int v) { return static_cast<uint32_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

uint32_t Select(uint32_t top, uint32_t left, uint32_t top_left) {
  int pa_minus_pb = 0;  // sum |left - top_left| - |top - top_left|
  for (int shift = 0; shift < 32; shift += 8) {
    const int c = Channel(top_left, shift);
    pa_minus_pb += std::abs(Channel(left, shift) - c) - std::abs(Channel(top, shift) - c);
  }
  return pa_minus_pb <= 0 ? top : left;
}
uint32_t ClampAddSubtractFull(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int shift = 0; shift < 32; shift += 8) {
    out |= Clip255(Channel(a, shift) + Channel(b, shift) - Channel(c, shift)) << shift;
  }
  return out;
}
uint32_t ClampAddSubtractHalf(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int shift = 0; shift < 32; shift += 8) {
    const int x = Channel(a, shift);
    out |= Clip255(x + (x - Channel(b, shift)) / 2) << shift;
  }
  return out;
}

uint32_t Predict(int mode, uint32_t left, uint32_t top, uint32_t top_right, uint32_t top_left) {
  switch (mode) {
    case 1: return left;
    case 2: return top;
    case 3: return top_right;
    case 4: return top_left;
    case 5: return Average2(Average2(left, top_right), top);
    case 6: return Average2(left, top_left);
    case 7: return Average2(left, top);
    case 8: return Average2(top_left, top);
    case 9: return Average2(top, top_right);
    case 10: return Average2(Average2(left, top_left), Average2(top, top_right));
    case 11: return Select(top, left, top_left);
    case 12: return ClampAddSubtractFull(left, top, top_left);
    case 13: return ClampAddSubtractHalf(Average2(left, top), top_left);
    default: return 0xff000000u;  // mode 0; 14 and 15 as libwebp
  }
}

inline int ColorTransformDelta(int8_t pred, int8_t color) { return (static_cast<int>(pred) * color) >> 5; }

enum TransformType { kPredictor = 0, kCrossColor = 1, kSubtractGreen = 2, kColorIndexing = 3 };

struct Transform {
  int type;
  int bits;   // block size bits (predictor, cross-colour) or pixels-per-byte bits (colour indexing)
  int xsize;  // width of the image this transform outputs
  std::vector<uint32_t> data;
};

inline int DivRoundUp(int n, int bits) { return (n + (1 << bits) - 1) >> bits; }

class Vp8lDecoder {
 public:
  Vp8lDecoder(const uint8_t* data, size_t size) : br_(data, size) {}
  BitReader& bits() { return br_; }

  // Decodes an image stream of xsize x ysize; the main (level 0) image may
  // have transforms and a meta prefix image.
  int DecodeImageStream(int xsize, int ysize, bool level0, std::vector<uint32_t>& out) {
    std::vector<Transform> transforms;
    int coded_xsize = xsize;
    if (level0) {
      bool seen[4] = {false, false, false, false};
      while (br_.Read(1)) {
        Transform t;
        t.type = static_cast<int>(br_.Read(2));
        if (seen[t.type]) return kBadData;
        seen[t.type] = true;
        t.xsize = coded_xsize;
        t.bits = 0;
        if (t.type == kPredictor || t.type == kCrossColor) {
          t.bits = static_cast<int>(br_.Read(3)) + 2;
          const int status = DecodeImageStream(DivRoundUp(coded_xsize, t.bits), DivRoundUp(ysize, t.bits), false,
                                               t.data);
          if (status != kOk) return status;
        } else if (t.type == kColorIndexing) {
          const int n = static_cast<int>(br_.Read(8)) + 1;
          t.bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
          std::vector<uint32_t> table;
          const int status = DecodeImageStream(n, 1, false, table);
          if (status != kOk) return status;
          t.data.assign(std::max(256, n), 0u);  // indices past the table give transparent black
          t.data[0] = table[0];
          for (int i = 1; i < n; ++i) t.data[i] = AddPixels(table[i], t.data[i - 1]);
          coded_xsize = DivRoundUp(coded_xsize, t.bits);
        }
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br_.Read(1)) {
      cache_bits = static_cast<int>(br_.Read(4));
      if (cache_bits < 1 || cache_bits > 11) return kBadData;
    }
    int meta_bits = 0;
    std::vector<uint32_t> meta;
    int num_groups = 1;
    if (level0 && br_.Read(1)) {
      meta_bits = static_cast<int>(br_.Read(3)) + 2;
      const int status = DecodeImageStream(DivRoundUp(coded_xsize, meta_bits), DivRoundUp(ysize, meta_bits), false,
                                           meta);
      if (status != kOk) return status;
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        num_groups = std::max(num_groups, static_cast<int>(m) + 1);
      }
    }
    if (br_.eos()) return kTruncated;
    const int cache_size = cache_bits > 0 ? 1 << cache_bits : 0;
    const int alphabet[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
    std::vector<PrefixCode> codes(5 * static_cast<size_t>(num_groups));
    for (int g = 0; g < num_groups; ++g) {
      for (int k = 0; k < 5; ++k) {
        const int status = ReadCode(alphabet[k], codes[5 * g + k]);
        if (status != kOk) return status;
      }
    }
    const int status = DecodePixels(coded_xsize, ysize, cache_bits, meta_bits, meta, codes, out);
    if (status != kOk) return status;
    for (auto t = transforms.rbegin(); t != transforms.rend(); ++t) Inverse(*t, ysize, out);
    return kOk;
  }

 private:
  int ReadCode(int alphabet, PrefixCode& code) {
    std::vector<int> lengths(alphabet, 0);
    if (br_.Read(1)) {  // simple code: one or two symbols
      const int n = static_cast<int>(br_.Read(1)) + 1;
      const int first_bits = br_.Read(1) ? 8 : 1;
      const int s0 = static_cast<int>(br_.Read(first_bits));
      if (s0 >= alphabet) return kBadCode;
      lengths[s0] = 1;
      if (n == 2) {
        const int s1 = static_cast<int>(br_.Read(8));
        if (s1 >= alphabet) return kBadCode;
        lengths[s1] = 1;
      }
    } else {
      std::vector<int> cl_lengths(19, 0);
      const int count = static_cast<int>(br_.Read(4)) + 4;
      for (int i = 0; i < count; ++i) cl_lengths[kCodeLengthOrder[i]] = static_cast<int>(br_.Read(3));
      PrefixCode cl_code;
      if (!cl_code.Build(cl_lengths)) return kBadCode;
      int max_symbol = alphabet;
      if (br_.Read(1)) {
        const int length_bits = 2 + 2 * static_cast<int>(br_.Read(3));
        max_symbol = 2 + static_cast<int>(br_.Read(length_bits));
        if (max_symbol > alphabet) return kBadCode;
      }
      int symbol = 0;
      int previous = 8;
      while (symbol < alphabet) {
        if (max_symbol-- == 0) break;
        const int c = cl_code.Read(br_);
        if (c < 0 || br_.eos()) return kTruncated;
        if (c < 16) {
          lengths[symbol++] = c;
          if (c != 0) previous = c;
        } else {
          const int extra = c == 16 ? 2 : c == 17 ? 3 : 7;
          const int offset = c == 18 ? 11 : 3;
          const int repeat = static_cast<int>(br_.Read(extra)) + offset;
          if (symbol + repeat > alphabet) return kBadCode;
          const int value = c == 16 ? previous : 0;
          for (int r = 0; r < repeat; ++r) lengths[symbol++] = value;
        }
      }
    }
    if (br_.eos()) return kTruncated;
    return code.Build(lengths) ? kOk : kBadCode;
  }

  int CopyLength(int prefix) {
    if (prefix < 4) return prefix + 1;
    const int extra = (prefix - 2) >> 1;
    const int offset = (2 + (prefix & 1)) << extra;
    return offset + static_cast<int>(br_.Read(extra)) + 1;
  }

  int DecodePixels(int xsize, int ysize, int cache_bits, int meta_bits, const std::vector<uint32_t>& meta,
                   const std::vector<PrefixCode>& codes, std::vector<uint32_t>& out) {
    const int64_t total = static_cast<int64_t>(xsize) * ysize;
    out.assign(total, 0u);
    std::vector<uint32_t> cache(cache_bits > 0 ? size_t{1} << cache_bits : 0, 0u);
    const int meta_xsize = meta_bits > 0 ? DivRoundUp(xsize, meta_bits) : 0;
    const int cache_shift = 32 - cache_bits;
    int64_t pos = 0, cached = 0;
    while (pos < total) {
      const int x = static_cast<int>(pos % xsize), y = static_cast<int>(pos / xsize);
      const int group = meta_bits > 0 ? static_cast<int>(meta[(y >> meta_bits) * meta_xsize + (x >> meta_bits)]) : 0;
      const PrefixCode* g = &codes[5 * static_cast<size_t>(group)];
      const int s = g[0].Read(br_);
      if (s < 0) return kBadData;
      if (s < 256) {
        const uint32_t red = static_cast<uint32_t>(g[1].Read(br_));
        const uint32_t blue = static_cast<uint32_t>(g[2].Read(br_));
        const uint32_t alpha = static_cast<uint32_t>(g[3].Read(br_));
        out[pos++] = alpha << 24 | red << 16 | static_cast<uint32_t>(s) << 8 | blue;
      } else if (s < 256 + 24) {
        const int length = CopyLength(s - 256);
        const int dist_symbol = g[4].Read(br_);
        if (dist_symbol < 0) return kBadData;
        const int dist = PlaneCodeToDistance(xsize, CopyLength(dist_symbol));
        if (dist > pos || length > total - pos) return kBadData;
        for (int k = 0; k < length; ++k, ++pos) out[pos] = out[pos - dist];
      } else {
        const int index = s - 280;
        if (index >= static_cast<int>(cache.size())) return kBadData;
        out[pos++] = cache[index];
      }
      if (br_.eos()) return kTruncated;
      if (cache_bits > 0) {
        for (; cached < pos; ++cached) cache[(0x1e35a7bdu * out[cached]) >> cache_shift] = out[cached];
      }
    }
    return kOk;
  }

  void Inverse(const Transform& t, int ysize, std::vector<uint32_t>& px) {
    const int w = t.xsize;
    if (t.type == kSubtractGreen) {
      for (uint32_t& p : px) {
        const uint32_t green = (p >> 8) & 0xff;
        p = (p & 0xff00ff00u) | ((((p >> 16) + green) & 0xff) << 16) | ((p + green) & 0xff);
      }
    } else if (t.type == kPredictor) {
      const int tw = DivRoundUp(w, t.bits);
      for (int y = 0; y < ysize; ++y) {
        for (int x = 0; x < w; ++x) {
          const int64_t i = static_cast<int64_t>(y) * w + x;
          uint32_t pred;
          if (y == 0) {
            pred = x == 0 ? 0xff000000u : px[i - 1];
          } else if (x == 0) {
            pred = px[i - w];
          } else {
            const int mode = static_cast<int>((t.data[(y >> t.bits) * tw + (x >> t.bits)] >> 8) & 15);
            pred = Predict(mode, px[i - 1], px[i - w], px[i - w + 1], px[i - w - 1]);
          }
          px[i] = AddPixels(px[i], pred);
        }
      }
    } else if (t.type == kCrossColor) {
      const int tw = DivRoundUp(w, t.bits);
      for (int y = 0; y < ysize; ++y) {
        for (int x = 0; x < w; ++x) {
          const uint32_t m = t.data[(y >> t.bits) * tw + (x >> t.bits)];
          const int8_t green_to_red = static_cast<int8_t>(m & 0xff);
          const int8_t green_to_blue = static_cast<int8_t>((m >> 8) & 0xff);
          const int8_t red_to_blue = static_cast<int8_t>((m >> 16) & 0xff);
          uint32_t& p = px[static_cast<int64_t>(y) * w + x];
          const int8_t green = static_cast<int8_t>((p >> 8) & 0xff);
          int red = static_cast<int>((p >> 16) & 0xff);
          int blue = static_cast<int>(p & 0xff);
          red = (red + ColorTransformDelta(green_to_red, green)) & 0xff;
          blue += ColorTransformDelta(green_to_blue, green);
          blue += ColorTransformDelta(red_to_blue, static_cast<int8_t>(red));
          blue &= 0xff;
          p = (p & 0xff00ff00u) | static_cast<uint32_t>(red) << 16 | static_cast<uint32_t>(blue);
        }
      }
    } else {  // colour indexing: the coded image is DivRoundUp(w, bits) wide
      const int cw = DivRoundUp(w, t.bits);
      const int per_byte = 1 << t.bits;
      const int bits_per_index = 8 >> t.bits;
      const uint32_t mask = (1u << bits_per_index) - 1;
      std::vector<uint32_t> result(static_cast<size_t>(w) * ysize);
      for (int y = 0; y < ysize; ++y) {
        for (int x = 0; x < w; ++x) {
          const uint32_t packed = (px[static_cast<int64_t>(y) * cw + (x >> t.bits)] >> 8) & 0xff;
          const uint32_t index = (packed >> ((x & (per_byte - 1)) * bits_per_index)) & mask;
          result[static_cast<int64_t>(y) * w + x] = t.data[index];
        }
      }
      px.swap(result);
    }
  }

  BitReader br_;
};

// ======================================================================== VP8

static const uint8_t kCoeffsProba0[4][8][3][11] = {
  {
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128}, {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128}, {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
    {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128}, {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128}, {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
    {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128}, {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128}, {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
    {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128}, {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128}, {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
    {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128}, {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128}, {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
    {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128}, {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128}, {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62}, {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1}, {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
    {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128}, {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128}, {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
    {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128}, {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128}, {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
    {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128}, {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128}, {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
    {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128}, {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128}, {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
    {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128}, {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128}, {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
    {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128}, {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128}, {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
    {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128}, {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128}, {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}},
  },
  {
    {{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128}, {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128}, {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
    {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128}, {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128}, {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
    {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128}, {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128}, {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
    {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128}, {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128}, {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
    {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128}, {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128}, {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128}, {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128}, {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
    {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}, {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
  {
    {{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255}, {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128}, {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
    {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128}, {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128}, {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
    {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128}, {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128}, {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
    {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128}, {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128}, {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
    {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128}, {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128}, {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
    {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128}, {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128}, {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
    {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128}, {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128}, {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
    {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}, {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
  },
};
static const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
  {
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255}, {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255}, {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255}, {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255}, {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
    {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
  {
    {{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255}, {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
    {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255}, {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255}, {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
    {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}, {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
  },
};
static const uint8_t kBModesProba[10][10][9] = {
  {{231, 120, 48, 89, 115, 113, 120, 152, 112}, {152, 179, 64, 126, 170, 118, 46, 70, 95}, {175, 69, 143, 80, 85, 82, 72, 155, 103}, {56, 58, 10, 171, 218, 189, 17, 13, 152}, {114, 26, 17, 163, 44, 195, 21, 10, 173}, {121, 24, 80, 195, 26, 62, 44, 64, 85}, {144, 71, 10, 38, 171, 213, 144, 34, 26}, {170, 46, 55, 19, 136, 160, 33, 206, 71}, {63, 20, 8, 114, 114, 208, 12, 9, 226}, {81, 40, 11, 96, 182, 84, 29, 16, 36}},
  {{134, 183, 89, 137, 98, 101, 106, 165, 148}, {72, 187, 100, 130, 157, 111, 32, 75, 80}, {66, 102, 167, 99, 74, 62, 40, 234, 128}, {41, 53, 9, 178, 241, 141, 26, 8, 107}, {74, 43, 26, 146, 73, 166, 49, 23, 157}, {65, 38, 105, 160, 51, 52, 31, 115, 128}, {104, 79, 12, 27, 217, 255, 87, 17, 7}, {87, 68, 71, 44, 114, 51, 15, 186, 23}, {47, 41, 14, 110, 182, 183, 21, 17, 194}, {66, 45, 25, 102, 197, 189, 23, 18, 22}},
  {{88, 88, 147, 150, 42, 46, 45, 196, 205}, {43, 97, 183, 117, 85, 38, 35, 179, 61}, {39, 53, 200, 87, 26, 21, 43, 232, 171}, {56, 34, 51, 104, 114, 102, 29, 93, 77}, {39, 28, 85, 171, 58, 165, 90, 98, 64}, {34, 22, 116, 206, 23, 34, 43, 166, 73}, {107, 54, 32, 26, 51, 1, 81, 43, 31}, {68, 25, 106, 22, 64, 171, 36, 225, 114}, {34, 19, 21, 102, 132, 188, 16, 76, 124}, {62, 18, 78, 95, 85, 57, 50, 48, 51}},
  {{193, 101, 35, 159, 215, 111, 89, 46, 111}, {60, 148, 31, 172, 219, 228, 21, 18, 111}, {112, 113, 77, 85, 179, 255, 38, 120, 114}, {40, 42, 1, 196, 245, 209, 10, 25, 109}, {88, 43, 29, 140, 166, 213, 37, 43, 154}, {61, 63, 30, 155, 67, 45, 68, 1, 209}, {100, 80, 8, 43, 154, 1, 51, 26, 71}, {142, 78, 78, 16, 255, 128, 34, 197, 171}, {41, 40, 5, 102, 211, 183, 4, 1, 221}, {51, 50, 17, 168, 209, 192, 23, 25, 82}},
  {{138, 31, 36, 171, 27, 166, 38, 44, 229}, {67, 87, 58, 169, 82, 115, 26, 59, 179}, {63, 59, 90, 180, 59, 166, 93, 73, 154}, {40, 40, 21, 116, 143, 209, 34, 39, 175}, {47, 15, 16, 183, 34, 223, 49, 45, 183}, {46, 17, 33, 183, 6, 98, 15, 32, 183}, {57, 46, 22, 24, 128, 1, 54, 17, 37}, {65, 32, 73, 115, 28, 128, 23, 128, 205}, {40, 3, 9, 115, 51, 192, 18, 6, 223}, {87, 37, 9, 115, 59, 77, 64, 21, 47}},
  {{104, 55, 44, 218, 9, 54, 53, 130, 226}, {64, 90, 70, 205, 40, 41, 23, 26, 57}, {54, 57, 112, 184, 5, 41, 38, 166, 213}, {30, 34, 26, 133, 152, 116, 10, 32, 134}, {39, 19, 53, 221, 26, 114, 32, 73, 255}, {31, 9, 65, 234, 2, 15, 1, 118, 73}, {75, 32, 12, 51, 192, 255, 160, 43, 51}, {88, 31, 35, 67, 102, 85, 55, 186, 85}, {56, 21, 23, 111, 59, 205, 45, 37, 192}, {55, 38, 70, 124, 73, 102, 1, 34, 98}},
  {{125, 98, 42, 88, 104, 85, 117, 175, 82}, {95, 84, 53, 89, 128, 100, 113, 101, 45}, {75, 79, 123, 47, 51, 128, 81, 171, 1}, {57, 17, 5, 71, 102, 57, 53, 41, 49}, {38, 33, 13, 121, 57, 73, 26, 1, 85}, {41, 10, 67, 138, 77, 110, 90, 47, 114}, {115, 21, 2, 10, 102, 255, 166, 23, 6}, {101, 29, 16, 10, 85, 128, 101, 196, 26}, {57, 18, 10, 102, 102, 213, 34, 20, 43}, {117, 20, 15, 36, 163, 128, 68, 1, 26}},
  {{102, 61, 71, 37, 34, 53, 31, 243, 192}, {69, 60, 71, 38, 73, 119, 28, 222, 37}, {68, 45, 128, 34, 1, 47, 11, 245, 171}, {62, 17, 19, 70, 146, 85, 55, 62, 70}, {37, 43, 37, 154, 100, 163, 85, 160, 1}, {63, 9, 92, 136, 28, 64, 32, 201, 85}, {75, 15, 9, 9, 64, 255, 184, 119, 16}, {86, 6, 28, 5, 64, 255, 25, 248, 1}, {56, 8, 17, 132, 137, 255, 55, 116, 128}, {58, 15, 20, 82, 135, 57, 26, 121, 40}},
  {{164, 50, 31, 137, 154, 133, 25, 35, 218}, {51, 103, 44, 131, 131, 123, 31, 6, 158}, {86, 40, 64, 135, 148, 224, 45, 183, 128}, {22, 26, 17, 131, 240, 154, 14, 1, 209}, {45, 16, 21, 91, 64, 222, 7, 1, 197}, {56, 21, 39, 155, 60, 138, 23, 102, 213}, {83, 12, 13, 54, 192, 255, 68, 47, 28}, {85, 26, 85, 85, 128, 128, 32, 146, 171}, {18, 11, 7, 63, 144, 171, 4, 4, 246}, {35, 27, 10, 146, 174, 171, 12, 26, 128}},
  {{190, 80, 35, 99, 180, 80, 126, 54, 45}, {85, 126, 47, 87, 176, 51, 41, 20, 32}, {101, 75, 128, 139, 118, 146, 116, 128, 85}, {56, 41, 15, 176, 236, 85, 37, 9, 62}, {71, 30, 17, 119, 118, 255, 17, 18, 138}, {101, 38, 60, 138, 55, 70, 43, 26, 142}, {146, 36, 19, 30, 171, 255, 97, 27, 20}, {138, 45, 61, 62, 219, 1, 81, 188, 64}, {32, 41, 20, 117, 151, 142, 20, 21, 163}, {112, 19, 12, 61, 195, 128, 48, 4, 24}},
};
static const uint8_t kDcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
  18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
  29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
  44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
  59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
  75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
  91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
  122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
static const uint16_t kAcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
  20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
  36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
  52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
  78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
  110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
  155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
  213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

constexpr uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// Intra modes as libwebp numbers them; the 16x16 and chroma modes share
// the first four numbers.
enum { B_DC = 0, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
enum { DC_PRED = B_DC, TM_PRED = B_TM, V_PRED = B_VE, H_PRED = B_HE };

// RFC 6386's boolean decoder; past the end of its data it reads zeros.
class BoolDecoder {
 public:
  void Init(const uint8_t* data, size_t size) {
    data_ = data;
    end_ = data + size;
    value_ = NextByte() << 8;
    value_ |= NextByte();
    range_ = 255;
    bit_count_ = 0;
  }
  int GetBit(int prob) {
    const uint32_t split = 1 + (((range_ - 1) * static_cast<uint32_t>(prob)) >> 8);
    const uint32_t big_split = split << 8;
    int bit;
    if (value_ >= big_split) {
      bit = 1;
      range_ -= split;
      value_ -= big_split;
    } else {
      bit = 0;
      range_ = split;
    }
    while (range_ < 128) {
      value_ <<= 1;
      range_ <<= 1;
      if (++bit_count_ == 8) {
        bit_count_ = 0;
        value_ |= NextByte();
      }
    }
    return bit;
  }
  int Get() { return GetBit(128); }
  int GetValue(int bits) {
    int v = 0;
    while (bits-- > 0) v |= Get() << bits;
    return v;
  }
  int GetSignedValue(int bits) {
    const int v = GetValue(bits);
    return Get() ? -v : v;
  }

 private:
  uint32_t NextByte() { return data_ < end_ ? *data_++ : 0u; }
  const uint8_t* data_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint32_t value_ = 0, range_ = 255;
  int bit_count_ = 0;
};

struct FilterInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

struct MacroBlock {
  int segment = 0;
  bool skip = false, is_i4x4 = false;
  uint8_t imodes[16];
  int uvmode = 0;
};

inline uint8_t Clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// The work buffer of one macroblock: a row above and four columns to the
// left of each plane, and four top-right pixels for the 4x4 modes.
constexpr int BPS = 32;

inline int Avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int Avg2(int a, int b) { return (a + b + 1) >> 1; }
#define DST(x, y) dst[(x) + (y) * BPS]

void TrueMotion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int top_left = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1 + y * BPS];
    for (int x = 0; x < size; ++x) dst[x + y * BPS] = Clip8(top[x] + left - top_left);
  }
}
void Vertical(uint8_t* dst, int size) {
  for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, dst - BPS, size);
}
void Horizontal(uint8_t* dst, int size) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dst[-1 + y * BPS], size);
}
// DC of a 16x16 or 8x8 block, with or without the row above / the column to the left.
void DcPredict(uint8_t* dst, int size, bool has_top, bool has_left) {
  const int shift = size == 16 ? 4 : 3;
  int dc;
  if (has_top && has_left) {
    int sum = 0;
    for (int i = 0; i < size; ++i) sum += dst[i - BPS] + dst[-1 + i * BPS];
    dc = (sum + size) >> (shift + 1);
  } else if (has_top || has_left) {
    int sum = 0;
    for (int i = 0; i < size; ++i) sum += has_top ? dst[i - BPS] : dst[-1 + i * BPS];
    dc = (sum + (size >> 1)) >> shift;
  } else {
    dc = 0x80;
  }
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dc, size);
}

void Predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
            H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int y = 0; y < 4; ++y) std::memset(dst + y * BPS, dc, 4);
      break;
    }
    case B_TM:
      TrueMotion(dst, 4);
      break;
    case B_VE: {
      const uint8_t vals[4] = {static_cast<uint8_t>(Avg3(X, A, B)), static_cast<uint8_t>(Avg3(A, B, C)),
                               static_cast<uint8_t>(Avg3(B, C, D)), static_cast<uint8_t>(Avg3(C, D, E))};
      for (int y = 0; y < 4; ++y) std::memcpy(dst + y * BPS, vals, 4);
      break;
    }
    case B_HE: {
      const int rows[4] = {Avg3(X, I, J), Avg3(I, J, K), Avg3(J, K, L), Avg3(K, L, L)};
      for (int y = 0; y < 4; ++y) std::memset(dst + y * BPS, rows[y], 4);
      break;
    }
    case B_RD:
      DST(0, 3) = Avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = Avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = Avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = Avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = Avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = Avg3(C, B, A);
      DST(3, 0) = Avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = Avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = Avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = Avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = Avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = Avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = Avg3(F, G, H);
      DST(3, 3) = Avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = Avg2(X, A);
      DST(1, 0) = DST(2, 2) = Avg2(A, B);
      DST(2, 0) = DST(3, 2) = Avg2(B, C);
      DST(3, 0) = Avg2(C, D);
      DST(0, 3) = Avg3(K, J, I);
      DST(0, 2) = Avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = Avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = Avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = Avg3(A, B, C);
      DST(3, 1) = Avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = Avg2(A, B);
      DST(1, 0) = DST(0, 2) = Avg2(B, C);
      DST(2, 0) = DST(1, 2) = Avg2(C, D);
      DST(3, 0) = DST(2, 2) = Avg2(D, E);
      DST(0, 1) = Avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = Avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = Avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = Avg3(D, E, F);
      DST(3, 2) = Avg3(E, F, G);
      DST(3, 3) = Avg3(F, G, H);
      break;
    case B_HU:
      DST(0, 0) = Avg2(I, J);
      DST(2, 0) = DST(0, 1) = Avg2(J, K);
      DST(2, 1) = DST(0, 2) = Avg2(K, L);
      DST(1, 0) = Avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = Avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = Avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = Avg2(I, X);
      DST(0, 1) = DST(2, 2) = Avg2(J, I);
      DST(0, 2) = DST(2, 3) = Avg2(K, J);
      DST(0, 3) = Avg2(L, K);
      DST(3, 0) = Avg3(A, B, C);
      DST(2, 0) = Avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = Avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = Avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = Avg3(K, J, I);
      DST(1, 3) = Avg3(L, K, J);
      break;
  }
}
#undef DST

void PredictBlock(uint8_t* dst, int size, int mode, int mb_x, int mb_y) {
  switch (mode) {
    case DC_PRED: DcPredict(dst, size, mb_y > 0, mb_x > 0); break;
    case TM_PRED: TrueMotion(dst, size); break;
    case V_PRED: Vertical(dst, size); break;
    default: Horizontal(dst, size); break;
  }
}

// The inverse DCT of one 4x4 block, added to the prediction in dst.
void InverseDct(const int16_t* in, uint8_t* dst) {
  auto mul1 = [](int a) { return ((a * 20091) >> 16) + a; };
  auto mul2 = [](int a) { return (a * 35468) >> 16; };
  int tmp[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* row = dst + i * BPS;
    row[0] = Clip8(row[0] + ((a + d) >> 3));
    row[1] = Clip8(row[1] + ((b + c) >> 3));
    row[2] = Clip8(row[2] + ((b - c) >> 3));
    row[3] = Clip8(row[3] + ((a - d) >> 3));
  }
}

// The inverse Walsh-Hadamard transform of the Y2 block: the DC of each of
// the 16 luma blocks (out[16 * k]).
void InverseWht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[4 * i] + 3;
    const int a0 = dc + tmp[4 * i + 3];
    const int a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2];
    const int a3 = dc - tmp[4 * i + 3];
    out[64 * i + 0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[64 * i + 16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[64 * i + 32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[64 * i + 48] = static_cast<int16_t>((a3 - a2) >> 3);
  }
}

// ---- loop filter (RFC 6386 section 15, in libwebp's arrangement)

inline int SignedClip(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }
inline int Sclip1(int v) { return SignedClip(v, -128, 127); }
inline int Sclip2(int v) { return SignedClip(v, -16, 15); }

void Filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + Sclip1(p1 - q1);
  const int a1 = Sclip2((a + 4) >> 3);
  const int a2 = Sclip2((a + 3) >> 3);
  p[-step] = Clip8(p0 + a2);
  p[0] = Clip8(q0 - a1);
}
void Filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = Sclip2((a + 4) >> 3);
  const int a2 = Sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = Clip8(p1 + a3);
  p[-step] = Clip8(p0 + a2);
  p[0] = Clip8(q0 - a1);
  p[step] = Clip8(q1 - a3);
}
void Filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = Sclip1(3 * (q0 - p0) + Sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = Clip8(p2 + a3);
  p[-2 * step] = Clip8(p1 + a2);
  p[-step] = Clip8(p0 + a1);
  p[0] = Clip8(q0 - a1);
  p[step] = Clip8(q1 - a2);
  p[2 * step] = Clip8(q2 - a3);
}
bool Hev(const uint8_t* p, int step, int thresh) {
  return std::abs(p[-2 * step] - p[-step]) > thresh || std::abs(p[step] - p[0]) > thresh;
}
bool NeedsFilter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}
bool NeedsFilter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
// `step` crosses the edge, `along` walks it.
void SimpleEdge(uint8_t* p, int step, int along, int thresh) {
  const int t = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += along) {
    if (NeedsFilter(p, step, t)) Filter2(p, step);
  }
}
void NormalEdge(uint8_t* p, int step, int along, int size, int thresh, int ithresh, int hev_thresh, bool mb_edge) {
  const int t = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += along) {
    if (!NeedsFilter2(p, step, t, ithresh)) continue;
    if (Hev(p, step, hev_thresh)) {
      Filter2(p, step);
    } else if (mb_edge) {
      Filter6(p, step);
    } else {
      Filter4(p, step);
    }
  }
}

int ClipQ(int v, int hi) { return v < 0 ? 0 : v > hi ? hi : v; }

struct Quant {
  int y1[2], y2[2], uv[2];
};

class Vp8Decoder {
 public:
  // Decodes the frame into `out`: height x width x `channels` bytes, BGR in
  // the first three of each pixel. Returns 0 or a negative status.
  int Decode(const uint8_t* data, size_t size, int width, int height, uint8_t* out, int channels) {
    if (size < 10) return kTruncated;
    const uint32_t bits = data[0] | data[1] << 8 | data[2] << 16;
    const bool key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const bool show = (bits >> 4) & 1;
    const uint32_t part0_size = bits >> 5;
    if (!key_frame || profile > 3 || !show) return kBadHeader;
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return kBadHeader;
    const int w = (data[6] | data[7] << 8) & 0x3fff;
    const int h = (data[8] | data[9] << 8) & 0x3fff;
    if (w != width || h != height || w == 0 || h == 0) return kBadHeader;
    data += 10;
    size -= 10;
    if (part0_size > size) return kTruncated;
    mb_w_ = (w + 15) >> 4;
    mb_h_ = (h + 15) >> 4;
    BoolDecoder br;
    br.Init(data, part0_size);
    br.Get();  // colour space
    br.Get();  // clamping type
    ParseSegmentHeader(br);
    ParseFilterHeader(br);
    const int status = ParsePartitions(data + part0_size, size - part0_size, br);
    if (status != kOk) return status;
    ParseQuant(br);
    br.Get();  // refresh entropy probabilities: meaningless for a still image
    ParseProba(br);
    Reconstruct(br);
    if (filter_type_ > 0) LoopFilter();
    ToBgr(w, h, out, channels);
    return kOk;
  }

 private:
  void ParseSegmentHeader(BoolDecoder& br) {
    use_segment_ = br.Get();
    if (use_segment_) {
      update_map_ = br.Get();
      if (br.Get()) {
        absolute_delta_ = br.Get();
        for (int& q : quantizer_) q = br.Get() ? br.GetSignedValue(7) : 0;
        for (int& f : filter_strength_) f = br.Get() ? br.GetSignedValue(6) : 0;
      }
      if (update_map_) {
        for (int& p : segment_proba_) p = br.Get() ? br.GetValue(8) : 255;
      }
    }
  }
  void ParseFilterHeader(BoolDecoder& br) {
    simple_ = br.Get();
    level_ = br.GetValue(6);
    sharpness_ = br.GetValue(3);
    use_lf_delta_ = br.Get();
    if (use_lf_delta_ && br.Get()) {
      for (int& d : ref_lf_delta_) {
        if (br.Get()) d = br.GetSignedValue(6);
      }
      for (int& d : mode_lf_delta_) {
        if (br.Get()) d = br.GetSignedValue(6);
      }
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
  }
  int ParsePartitions(const uint8_t* data, size_t size, BoolDecoder& br) {
    const int last = (1 << br.GetValue(2)) - 1;
    num_parts_ = last + 1;
    if (size < static_cast<size_t>(3 * last)) return kTruncated;
    const uint8_t* sizes = data;
    const uint8_t* start = data + 3 * last;
    size_t left = size - 3 * last;
    for (int p = 0; p < last; ++p) {
      size_t psize = sizes[0] | sizes[1] << 8 | sizes[2] << 16;
      if (psize > left) psize = left;
      parts_[p].Init(start, psize);
      start += psize;
      left -= psize;
      sizes += 3;
    }
    parts_[last].Init(start, left);
    return left > 0 ? kOk : kTruncated;
  }
  void ParseQuant(BoolDecoder& br) {
    const int base_q0 = br.GetValue(7);
    const int dqy1_dc = br.Get() ? br.GetSignedValue(4) : 0;
    const int dqy2_dc = br.Get() ? br.GetSignedValue(4) : 0;
    const int dqy2_ac = br.Get() ? br.GetSignedValue(4) : 0;
    const int dquv_dc = br.Get() ? br.GetSignedValue(4) : 0;
    const int dquv_ac = br.Get() ? br.GetSignedValue(4) : 0;
    for (int s = 0; s < 4; ++s) {
      int q = base_q0;
      if (use_segment_) {
        q = quantizer_[s] + (absolute_delta_ ? 0 : base_q0);
      } else if (s > 0) {
        quant_[s] = quant_[0];
        continue;
      }
      Quant& m = quant_[s];
      m.y1[0] = kDcTable[ClipQ(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[ClipQ(q, 127)];
      m.y2[0] = kDcTable[ClipQ(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[ClipQ(q + dqy2_ac, 127)] * 101581) >> 16;  // = x * 155 / 100 on the table
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[ClipQ(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[ClipQ(q + dquv_ac, 127)];
    }
  }
  void ParseProba(BoolDecoder& br) {
    for (int t = 0; t < 4; ++t) {
      for (int b = 0; b < 8; ++b) {
        for (int c = 0; c < 3; ++c) {
          for (int p = 0; p < 11; ++p) {
            proba_[t][b][c][p] = br.GetBit(kCoeffsUpdateProba[t][b][c][p]) ? br.GetValue(8)
                                                                            : kCoeffsProba0[t][b][c][p];
          }
        }
      }
    }
    use_skip_proba_ = br.Get();
    if (use_skip_proba_) skip_proba_ = br.GetValue(8);
  }

  void ParseIntraMode(BoolDecoder& br, MacroBlock& mb, uint8_t* top, uint8_t* left) {
    mb.segment = update_map_ ? (!br.GetBit(segment_proba_[0]) ? br.GetBit(segment_proba_[1])
                                                              : br.GetBit(segment_proba_[2]) + 2)
                             : 0;
    mb.skip = use_skip_proba_ ? br.GetBit(skip_proba_) : false;
    mb.is_i4x4 = !br.GetBit(145);
    if (!mb.is_i4x4) {
      const int ymode = br.GetBit(156) ? (br.GetBit(128) ? TM_PRED : H_PRED) : (br.GetBit(163) ? V_PRED : DC_PRED);
      mb.imodes[0] = static_cast<uint8_t>(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          ymode = !br.GetBit(prob[0])   ? B_DC
                  : !br.GetBit(prob[1]) ? B_TM
                  : !br.GetBit(prob[2]) ? B_VE
                  : !br.GetBit(prob[3]) ? (!br.GetBit(prob[4]) ? B_HE : (!br.GetBit(prob[5]) ? B_RD : B_VR))
                                        : (!br.GetBit(prob[6])   ? B_LD
                                           : !br.GetBit(prob[7]) ? B_VL
                                           : !br.GetBit(prob[8]) ? B_HD
                                                                 : B_HU);
          top[x] = static_cast<uint8_t>(ymode);
        }
        std::memcpy(mb.imodes + 4 * y, top, 4);
        left[y] = static_cast<uint8_t>(ymode);
      }
    }
    mb.uvmode = !br.GetBit(142) ? DC_PRED : !br.GetBit(114) ? V_PRED : br.GetBit(183) ? TM_PRED : H_PRED;
  }

  int GetLargeValue(BoolDecoder& br, const uint8_t* p) {
    int v;
    if (!br.GetBit(p[3])) {
      v = !br.GetBit(p[4]) ? 2 : 3 + br.GetBit(p[5]);
    } else if (!br.GetBit(p[6])) {
      if (!br.GetBit(p[7])) {
        v = 5 + br.GetBit(159);
      } else {
        v = 7 + 2 * br.GetBit(165);
        v += br.GetBit(145);
      }
    } else {
      const int bit1 = br.GetBit(p[8]);
      const int bit0 = br.GetBit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.GetBit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // One block's tokens from position n; returns the position after the
  // last coefficient read (n when the block is empty), as libwebp does.
  int GetCoeffs(BoolDecoder& br, int type, int ctx, const int dq[2], int n, int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.GetBit(p[0])) return n;
      while (!br.GetBit(p[1])) {
        p = proba_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!br.GetBit(p[2])) {
        v = 1;
        p = proba_[type][kBands[n + 1]][1];
      } else {
        v = GetLargeValue(br, p);
        p = proba_[type][kBands[n + 1]][2];
      }
      out[kZigzag[n]] = static_cast<int16_t>((br.Get() ? -v : v) * dq[n > 0]);
    }
    return 16;
  }

  // Parses one macroblock's coefficients into coeffs (16 Y, 4 U, 4 V
  // blocks); returns whether any block has a non-zero coefficient.
  bool ParseResiduals(BoolDecoder& br, const MacroBlock& mb, int mb_x, int16_t* coeffs) {
    const Quant& q = quant_[mb.segment];
    uint8_t* tnz = top_nz_.data() + 9 * mb_x;  // 4 Y, 2 U, 2 V, Y2
    uint8_t* lnz = left_nz_;
    bool any = false;
    int first, type;
    if (!mb.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = tnz[8] + lnz[8];
      const int nz = GetCoeffs(br, 1, ctx, q.y2, 0, dc);
      tnz[8] = lnz[8] = nz > 0;
      InverseWht(dc, coeffs);
      first = 1;
      type = 0;
    } else {
      first = 0;
      type = 3;
    }
    for (int y = 0; y < 4; ++y) {
      for (int x = 0; x < 4; ++x) {
        int16_t* block = coeffs + 16 * (4 * y + x);
        const int ctx = lnz[y] + tnz[x];
        const int nz = GetCoeffs(br, type, ctx, q.y1, first, block);
        lnz[y] = tnz[x] = nz > first;
        any |= nz > 1 || block[0] != 0;
      }
    }
    for (int ch = 0; ch < 2; ++ch) {
      for (int y = 0; y < 2; ++y) {
        for (int x = 0; x < 2; ++x) {
          int16_t* block = coeffs + 16 * (16 + 4 * ch + 2 * y + x);
          const int ctx = lnz[4 + 2 * ch + y] + tnz[4 + 2 * ch + x];
          const int nz = GetCoeffs(br, 2, ctx, q.uv, 0, block);
          lnz[4 + 2 * ch + y] = tnz[4 + 2 * ch + x] = nz > 0;
          any |= nz > 1 || block[0] != 0;
        }
      }
    }
    return any;
  }

  void Reconstruct(BoolDecoder& br) {
    const int stride = mb_w_ * 16, uv_stride = mb_w_ * 8;
    y_.assign(static_cast<size_t>(stride) * mb_h_ * 16, 0);
    u_.assign(static_cast<size_t>(uv_stride) * mb_h_ * 8, 0);
    v_.assign(u_.size(), 0);
    y_stride_ = stride;
    uv_stride_ = uv_stride;
    finfo_.assign(static_cast<size_t>(mb_w_) * mb_h_, FilterInfo());
    top_nz_.assign(9 * static_cast<size_t>(mb_w_), 0);
    std::vector<uint8_t> intra_top(4 * static_cast<size_t>(mb_w_), B_DC);
    std::vector<uint8_t> top_y(16 * static_cast<size_t>(mb_w_)), top_u(8 * static_cast<size_t>(mb_w_)),
        top_v(8 * static_cast<size_t>(mb_w_));
    FilterInfo strengths[4][2];
    PrecomputeFilterStrengths(strengths);
    std::vector<MacroBlock> row(mb_w_);
    int16_t coeffs[384];
    // Work buffers: row -1 holds the samples above, columns -4..-1 those to the left.
    uint8_t ybuf[BPS * 17], ubuf[BPS * 9], vbuf[BPS * 9];
    uint8_t* const y_dst = ybuf + BPS + 8;
    uint8_t* const u_dst = ubuf + BPS + 8;
    uint8_t* const v_dst = vbuf + BPS + 8;
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      uint8_t intra_left[4];
      std::memset(intra_left, B_DC, 4);
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        ParseIntraMode(br, row[mb_x], intra_top.data() + 4 * mb_x, intra_left);
      }
      BoolDecoder& tokens = parts_[mb_y & (num_parts_ - 1)];
      std::memset(left_nz_, 0, sizeof(left_nz_));
      for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
      for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
      if (mb_y > 0) {
        y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
      } else {
        std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        std::memset(u_dst - BPS - 1, 127, 8 + 1);
        std::memset(v_dst - BPS - 1, 127, 8 + 1);
      }
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const MacroBlock& mb = row[mb_x];
        std::memset(coeffs, 0, sizeof(coeffs));
        bool coded = false;
        if (!mb.skip) {
          coded = ParseResiduals(tokens, mb, mb_x, coeffs);
        } else {
          std::memset(left_nz_, 0, 8);
          std::memset(top_nz_.data() + 9 * mb_x, 0, 8);
          if (!mb.is_i4x4) left_nz_[8] = top_nz_[9 * mb_x + 8] = 0;
        }
        if (filter_type_ > 0) {
          FilterInfo& f = finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
          f = strengths[mb.segment][mb.is_i4x4];
          f.inner = f.inner || coded;
        }
        if (mb_x > 0) {  // rotate in the left samples
          for (int j = -1; j < 16; ++j) std::memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
          for (int j = -1; j < 8; ++j) {
            std::memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
            std::memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
          }
        }
        if (mb_y > 0) {
          std::memcpy(y_dst - BPS, top_y.data() + 16 * mb_x, 16);
          std::memcpy(u_dst - BPS, top_u.data() + 8 * mb_x, 8);
          std::memcpy(v_dst - BPS, top_v.data() + 8 * mb_x, 8);
        }
        if (mb.is_i4x4) {
          uint8_t* top_right = y_dst - BPS + 16;
          if (mb_y > 0) {
            if (mb_x >= mb_w_ - 1) {
              std::memset(top_right, top_y[16 * mb_x + 15], 4);
            } else {
              std::memcpy(top_right, top_y.data() + 16 * (mb_x + 1), 4);
            }
          }
          for (int r = 1; r <= 3; ++r) std::memcpy(top_right + 4 * r * BPS, top_right, 4);
          for (int n = 0; n < 16; ++n) {
            uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
            Predict4(dst, mb.imodes[n]);
            InverseDct(coeffs + 16 * n, dst);
          }
        } else {
          PredictBlock(y_dst, 16, mb.imodes[0], mb_x, mb_y);
          for (int n = 0; n < 16; ++n) InverseDct(coeffs + 16 * n, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
        }
        PredictBlock(u_dst, 8, mb.uvmode, mb_x, mb_y);
        PredictBlock(v_dst, 8, mb.uvmode, mb_x, mb_y);
        for (int n = 0; n < 4; ++n) {
          const int offset = (n & 1) * 4 + (n >> 1) * 4 * BPS;
          InverseDct(coeffs + 16 * (16 + n), u_dst + offset);
          InverseDct(coeffs + 16 * (20 + n), v_dst + offset);
        }
        std::memcpy(top_y.data() + 16 * mb_x, y_dst + 15 * BPS, 16);
        std::memcpy(top_u.data() + 8 * mb_x, u_dst + 7 * BPS, 8);
        std::memcpy(top_v.data() + 8 * mb_x, v_dst + 7 * BPS, 8);
        for (int j = 0; j < 16; ++j) {
          std::memcpy(&y_[(static_cast<size_t>(mb_y) * 16 + j) * stride + 16 * mb_x], y_dst + j * BPS, 16);
        }
        for (int j = 0; j < 8; ++j) {
          std::memcpy(&u_[(static_cast<size_t>(mb_y) * 8 + j) * uv_stride + 8 * mb_x], u_dst + j * BPS, 8);
          std::memcpy(&v_[(static_cast<size_t>(mb_y) * 8 + j) * uv_stride + 8 * mb_x], v_dst + j * BPS, 8);
        }
      }
    }
  }

  void PrecomputeFilterStrengths(FilterInfo strengths[4][2]) {
    for (int s = 0; s < 4; ++s) {
      int base = level_;
      if (use_segment_) base = filter_strength_[s] + (absolute_delta_ ? 0 : level_);
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = strengths[s][i4x4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * level + ilevel;
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4 != 0;
      }
    }
  }

  void LoopFilter() {
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const FilterInfo& f = finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
        if (f.limit == 0) continue;
        const int ys = y_stride_, uvs = uv_stride_;
        uint8_t* y = &y_[static_cast<size_t>(mb_y) * 16 * ys + 16 * mb_x];
        if (filter_type_ == 1) {
          if (mb_x > 0) SimpleEdge(y, 1, ys, f.limit + 4);
          if (f.inner) {
            for (int k = 4; k < 16; k += 4) SimpleEdge(y + k, 1, ys, f.limit);
          }
          if (mb_y > 0) SimpleEdge(y, ys, 1, f.limit + 4);
          if (f.inner) {
            for (int k = 4; k < 16; k += 4) SimpleEdge(y + k * ys, ys, 1, f.limit);
          }
          continue;
        }
        uint8_t* u = &u_[static_cast<size_t>(mb_y) * 8 * uvs + 8 * mb_x];
        uint8_t* v = &v_[static_cast<size_t>(mb_y) * 8 * uvs + 8 * mb_x];
        const int t = f.limit, it = f.ilevel, hev = f.hev_thresh;
        if (mb_x > 0) {
          NormalEdge(y, 1, ys, 16, t + 4, it, hev, true);
          NormalEdge(u, 1, uvs, 8, t + 4, it, hev, true);
          NormalEdge(v, 1, uvs, 8, t + 4, it, hev, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) NormalEdge(y + k, 1, ys, 16, t, it, hev, false);
          NormalEdge(u + 4, 1, uvs, 8, t, it, hev, false);
          NormalEdge(v + 4, 1, uvs, 8, t, it, hev, false);
        }
        if (mb_y > 0) {
          NormalEdge(y, ys, 1, 16, t + 4, it, hev, true);
          NormalEdge(u, uvs, 1, 8, t + 4, it, hev, true);
          NormalEdge(v, uvs, 1, 8, t + 4, it, hev, true);
        }
        if (f.inner) {
          for (int k = 4; k < 16; k += 4) NormalEdge(y + k * ys, ys, 1, 16, t, it, hev, false);
          NormalEdge(u + 4 * uvs, uvs, 1, 8, t, it, hev, false);
          NormalEdge(v + 4 * uvs, uvs, 1, 8, t, it, hev, false);
        }
      }
    }
  }

  // libwebp's YUV -> RGB: 14-bit fixed point, clipped.
  static int MultHi(int v, int coeff) { return (v * coeff) >> 8; }
  static int Clip8Yuv(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }
  static void YuvToBgr(int y, int u, int v, uint8_t* bgr) {
    bgr[2] = static_cast<uint8_t>(Clip8Yuv(MultHi(y, 19077) + MultHi(v, 26149) - 14234));
    bgr[1] = static_cast<uint8_t>(Clip8Yuv(MultHi(y, 19077) - MultHi(u, 6419) - MultHi(v, 13320) + 8708));
    bgr[0] = static_cast<uint8_t>(Clip8Yuv(MultHi(y, 19077) + MultHi(u, 33050) - 17685));
  }

  // libwebp's "fancy" upsampler on one pair of output rows: top_y's chroma
  // leans on (top_u, top_v), bottom_y's on (cur_u, cur_v).
  static void UpsampleRows(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                           const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v, uint8_t* top_dst,
                           uint8_t* bottom_dst, int len, int step) {
    auto load = [](uint8_t u, uint8_t v) { return static_cast<uint32_t>(u) | static_cast<uint32_t>(v) << 16; };
    const int last_pair = (len - 1) >> 1;
    uint32_t tl_uv = load(top_u[0], top_v[0]);
    uint32_t l_uv = load(cur_u[0], cur_v[0]);
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      YuvToBgr(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      YuvToBgr(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
    }
    for (int x = 1; x <= last_pair; ++x) {
      const uint32_t t_uv = load(top_u[x], top_v[x]);
      const uint32_t uv = load(cur_u[x], cur_v[x]);
      const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
      const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
      const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
      {
        const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
        const uint32_t uv1 = (diag_03 + t_uv) >> 1;
        YuvToBgr(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, top_dst + (2 * x - 1) * step);
        YuvToBgr(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + 2 * x * step);
      }
      if (bottom_y != nullptr) {
        const uint32_t uv0 = (diag_03 + l_uv) >> 1;
        const uint32_t uv1 = (diag_12 + uv) >> 1;
        YuvToBgr(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (2 * x - 1) * step);
        YuvToBgr(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16, bottom_dst + 2 * x * step);
      }
      tl_uv = t_uv;
      l_uv = uv;
    }
    if (!(len & 1)) {
      {
        const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
        YuvToBgr(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * step);
      }
      if (bottom_y != nullptr) {
        const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
        YuvToBgr(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * step);
      }
    }
  }

  void ToBgr(int w, int h, uint8_t* out, int channels) {
    const size_t row_bytes = static_cast<size_t>(w) * channels;
    auto y_row = [&](int r) { return &y_[static_cast<size_t>(r) * y_stride_]; };
    auto u_row = [&](int r) { return &u_[static_cast<size_t>(r) * uv_stride_]; };
    auto v_row = [&](int r) { return &v_[static_cast<size_t>(r) * uv_stride_]; };
    // Row 0 alone, then the pairs (2k - 1, 2k) between chroma rows k - 1 and k,
    // then the last row alone when the height is even.
    UpsampleRows(y_row(0), nullptr, u_row(0), v_row(0), u_row(0), v_row(0), out, nullptr, w, channels);
    int k = 1;
    for (; 2 * k < h; ++k) {
      UpsampleRows(y_row(2 * k - 1), y_row(2 * k), u_row(k - 1), v_row(k - 1), u_row(k), v_row(k),
                   out + (2 * k - 1) * row_bytes, out + 2 * k * row_bytes, w, channels);
    }
    if (!(h & 1)) {
      UpsampleRows(y_row(h - 1), nullptr, u_row(k - 1), v_row(k - 1), u_row(k - 1), v_row(k - 1),
                   out + (h - 1) * row_bytes, nullptr, w, channels);
    }
  }

  int mb_w_ = 0, mb_h_ = 0;
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {0, 0, 0, 0}, filter_strength_[4] = {0, 0, 0, 0};
  int segment_proba_[3] = {255, 255, 255};
  bool simple_ = false, use_lf_delta_ = false;
  int level_ = 0, sharpness_ = 0, filter_type_ = 0;
  int ref_lf_delta_[4] = {0, 0, 0, 0}, mode_lf_delta_[4] = {0, 0, 0, 0};
  int num_parts_ = 1;
  BoolDecoder parts_[8];
  Quant quant_[4];
  uint8_t proba_[4][8][3][11];
  bool use_skip_proba_ = false;
  int skip_proba_ = 0;
  std::vector<uint8_t> top_nz_;
  uint8_t left_nz_[9];
  std::vector<FilterInfo> finfo_;
  std::vector<uint8_t> y_, u_, v_;
  int y_stride_ = 0, uv_stride_ = 0;
};

}  // namespace

extern "C" {

// Decodes a VP8L bitstream. With `has_header` the data starts with the
// 5-byte VP8L header (signature 0x2f, 14-bit width - 1 and height - 1, the
// alpha hint, a 3-bit version 0) and `width` x `height` must match it;
// without, it is the headerless image stream of an ALPH chunk. `argb`
// receives width * height pixels. Returns 0, -1 truncated data, -2 an
// invalid prefix code, -3 invalid image data, -4 an invalid header.
int sr_vp8l_decode(const uint8_t* data, int64_t size, int width, int height, int has_header, uint32_t* argb) {
  Vp8lDecoder dec(data, static_cast<size_t>(size));
  if (has_header) {
    BitReader& br = dec.bits();
    if (br.Read(8) != 0x2f) return kBadHeader;
    const int w = static_cast<int>(br.Read(14)) + 1;
    const int h = static_cast<int>(br.Read(14)) + 1;
    br.Read(1);  // alpha hint
    if (br.Read(3) != 0 || w != width || h != height) return kBadHeader;
  }
  std::vector<uint32_t> out;
  const int status = dec.DecodeImageStream(width, height, true, out);
  if (status != kOk) return status;
  std::memcpy(argb, out.data(), out.size() * sizeof(uint32_t));
  return kOk;
}

// Decodes a VP8 key frame of `width` x `height` into `out` (height x width x
// `channels`, channels 3 or 4): BGR in the first three bytes of each pixel,
// the fourth left as it is. Returns 0, -1 truncated data, -4 an invalid or
// unsupported frame header.
int sr_vp8_decode(const uint8_t* data, int64_t size, int width, int height, uint8_t* out, int channels) {
  Vp8Decoder dec;
  return dec.Decode(data, static_cast<size_t>(size), width, height, out, channels);
}

// Undoes an ALPH chunk's filter (1 horizontal, 2 vertical, 3 gradient) in
// place on `alpha` (height x width).
void sr_webp_unfilter_alpha(uint8_t* alpha, int width, int height, int filter) {
  for (int y = 0; y < height; ++y) {
    uint8_t* row = alpha + static_cast<size_t>(y) * width;
    const uint8_t* prev = y > 0 ? row - width : nullptr;
    if (filter == 1 || prev == nullptr) {
      uint8_t pred = prev == nullptr ? 0 : prev[0];
      for (int x = 0; x < width; ++x) pred = row[x] = static_cast<uint8_t>(pred + row[x]);
    } else if (filter == 2) {
      for (int x = 0; x < width; ++x) row[x] = static_cast<uint8_t>(prev[x] + row[x]);
    } else {
      int left = prev[0], top_left = prev[0];
      for (int x = 0; x < width; ++x) {
        const int top = prev[x];
        const int g = left + top - top_left;
        left = row[x] = static_cast<uint8_t>(row[x] + (g < 0 ? 0 : g > 255 ? 255 : g));
        top_left = top;
      }
    }
  }
}

}  // extern "C"
