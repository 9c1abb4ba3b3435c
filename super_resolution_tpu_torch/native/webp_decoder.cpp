// WebP decoding for super_resolution_tpu_torch's codec (utils/webp.py): the
// serial half, bound with ctypes. The RIFF container is parsed in Python;
// this file decodes the chunks' payloads.
//
// - VP8L (lossless, the WebP lossless bitstream specification, RFC 9649):
//   prefix-code groups with the meta prefix image, the colour cache, LZ77
//   backward references with the 120-entry distance map, and the four
//   transforms (predictor with its 14 modes, cross-colour, subtract-green,
//   colour indexing with pixel bundling). Output: ARGB, one uint32 a pixel.
// - VP8 (lossy key frames, RFC 6386): the frame decoded by vp8_core.h's
//   FrameDecoder (shared with the video decoder, vp8_decoder.cpp) on
//   libwebp's rules where they differ from FFmpeg's; then YUV 4:2:0 to BGR
//   with libwebp's "fancy" upsampler (each output chroma sample 9/16, 3/16,
//   3/16, 1/16 of its four nearest) and its 14-bit fixed-point conversion,
//   as WebPDecodeBGR does.
// - ALPH: raw or VP8L-compressed alpha planes and their horizontal,
//   vertical and gradient filters.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 webp_decoder.cpp -o <lib>.so
// (native/__init__.py does this at first use, into
// super_resolution_tpu_torch/_build/).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "vp8_core.h"

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

// The frame itself: vp8_core.h. Here, libwebp's conversion of its planes.

// libwebp's YUV -> RGB: 14-bit fixed point, clipped.
inline int MultHi(int v, int coeff) { return (v * coeff) >> 8; }
inline int Clip8Yuv(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }
void YuvToBgr(int y, int u, int v, uint8_t* bgr) {
  bgr[2] = static_cast<uint8_t>(Clip8Yuv(MultHi(y, 19077) + MultHi(v, 26149) - 14234));
  bgr[1] = static_cast<uint8_t>(Clip8Yuv(MultHi(y, 19077) - MultHi(u, 6419) - MultHi(v, 13320) + 8708));
  bgr[0] = static_cast<uint8_t>(Clip8Yuv(MultHi(y, 19077) + MultHi(u, 33050) - 17685));
}

// libwebp's "fancy" upsampler on one pair of output rows: top_y's chroma
// leans on (top_u, top_v), bottom_y's on (cur_u, cur_v).
void UpsampleRows(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
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

// The picture's top-left w x h to BGR with the fancy upsampler: row 0
// alone, then the pairs (2k - 1, 2k) between chroma rows k - 1 and k, then
// the last row alone when the height is even.
void ToBgr(const sr_vp8::Picture& pic, int w, int h, uint8_t* out, int channels) {
  const size_t row_bytes = static_cast<size_t>(w) * channels;
  auto y_row = [&](int r) { return &pic.y[static_cast<size_t>(r) * pic.y_stride()]; };
  auto u_row = [&](int r) { return &pic.u[static_cast<size_t>(r) * pic.uv_stride()]; };
  auto v_row = [&](int r) { return &pic.v[static_cast<size_t>(r) * pic.uv_stride()]; };
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
  if (size < 10) return kTruncated;
  const uint32_t bits = data[0] | data[1] << 8 | data[2] << 16;
  const bool key_frame = !(bits & 1), show = (bits >> 4) & 1;
  const int profile = (bits >> 1) & 7;
  if (!key_frame || profile > 3 || !show) return kBadHeader;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return kBadHeader;
  const int w = (data[6] | data[7] << 8) & 0x3fff;
  const int h = (data[8] | data[9] << 8) & 0x3fff;
  if (w != width || h != height || w == 0 || h == 0) return kBadHeader;
  sr_vp8::FrameDecoder dec(sr_vp8::kLibwebp);
  sr_vp8::Picture pic;
  try {
    dec.Decode(data, static_cast<size_t>(size), pic, nullptr);
  } catch (const sr_vp8::Unsupported&) {
    return kBadHeader;
  } catch (const sr_vp8::Corrupt&) {
    return kTruncated;
  }
  ToBgr(pic, w, h, out, channels);
  return kOk;
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
