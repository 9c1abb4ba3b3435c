// FFV1 video, versions 0-3 at 8 bits a sample (RFC 9043), decoded as
// FFmpeg's decoder (libavcodec/ffv1dec.c) decodes it, then converted to
// BGR24 as cv2.VideoCapture converts FFmpeg's frames.
//
// Covered:
//   - the range coder with its default state-transition table and with a
//     custom one (coder 1 / 2), and Golomb-Rice coding with run mode (coder 0);
//   - the quantisation tables and context models (three or five inputs),
//     the version 2+ configuration record (initial states, quantisation
//     table sets, error correction) with its CRC;
//   - version 0 / 1 frame headers, version 2 slice positions in the frame
//     header, version 3 slice headers, and the slice footers found from the
//     end of the packet (size, error status, CRC);
//   - contexts kept from frame to frame, reset on key frames;
//   - the median predictor and the sample's wrap at 8 (RGB: 9) bits;
//   - grey (with and without transparency), YCbCr with every chroma
//     subsampling FFmpeg decodes (4:4:4, 4:4:0, 4:2:2, 4:2:0, 4:1:1, 4:1:0;
//     with transparency 4:4:4, 4:2:2, 4:2:0), RGB with the reversible colour
//     transform, with and without alpha.
// BGR: RGB as FFmpeg's 0RGB32 / RGB32 frame reordered (swscale drops the
// fourth byte), grey as swscale expands GRAY8 / YA8 (each channel the
// sample), YCbCr through swscale_bgr.h.
// Refused (-2, the feature named): more than 8 bits a sample, version 4+,
// another colourspace, and a layout ffv1dec.c refuses. A slice whose CRC
// fails is -3 (FFmpeg conceals it from the previous frame instead); other
// corrupt data is -1.
//
// C interface:
//   void* sr_ffv1_stream_new(const uint8_t* config, int64_t size, int width, int height, char* err, int err_len)
//                                         a decoder (null: err says why); sr_ffv1_stream_free(h) ends it
//   int sr_ffv1_stream_decode(void* h, const uint8_t* data, int64_t size, char* err, int err_len)
//                                         1 (a frame) or -1 / -2 / -3 as above
//   void sr_ffv1_stream_bgr(void* h, uint8_t* out)          the last frame, height x width x 3
//   int64_t sr_ffv1_stream_plane(void* h, int plane, uint8_t* out, int32_t* shape)
//                                         plane 0-3 of the last frame (Y U V A, or G B R A): its bytes
//                                         (0: no such plane), its width and height into shape; out may be
//                                         null to ask the size
//   int sr_ffv1_stream_stats(void* h, int64_t* out, int n)  the counts below; returns how many there are
//   void sr_yuv_to_bgr(const uint8_t* y, const uint8_t* u, const uint8_t* v, int y_stride, int uv_stride,
//                      int width, int height, int sx, int sy, int alpha, int h_chr_pos, int v_chr_pos,
//                      uint8_t* out)  swscale_bgr.h's YuvToBgr, which the video decoders share

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "swscale_bgr.h"

namespace {

constexpr int kContextSize = 32;
constexpr int kMaxQuantTables = 8;
constexpr int kMaxSlices = 1024;

enum Stat {
  kFrames, kKeyFrames, kNonKeyFrames, kSlices, kVersion0, kVersion1, kVersion2, kVersion3, kCoderGolomb,
  kCoderRangeDefault, kCoderRangeCustom, kCrcSlices, kRuns, kLargeContextFrames, kInitialStateFrames,
  kGrey, kGreyAlpha, kYuv444, kYuv440, kYuv422, kYuv420, kYuv411, kYuv410, kYuvAlpha, kRgb, kRgbAlpha,
  kMultiSliceFrames, kStatCount
};

struct Error {
  int code;
  std::string what;
};

// RFC 9043's range coder (libavcodec/rangecoder.h), byte for byte as FFmpeg runs it.
struct RangeCoder {
  int low = 0, range = 0xFF00;
  const uint8_t* start = nullptr;
  const uint8_t* pos = nullptr;
  const uint8_t* end = nullptr;
  int overread = 0;
  uint8_t zero[256], one[256];

  void Init(const uint8_t* buf, int64_t size) {
    start = pos = buf;
    end = buf + size;
    range = 0xFF00;
    overread = 0;
    low = size >= 2 ? (buf[0] << 8) | buf[1] : 0xFF00;
    pos += 2;
    if (low >= 0xFF00) {
      low = 0xFF00;
      end = pos;
    }
  }
  // ff_build_rac_states(c, 0.05 * 2^32, 256 - 8).
  void BuildStates() {
    const int64_t one_ = int64_t{1} << 32;
    const int factor = static_cast<int>(0.05 * static_cast<double>(int64_t{1} << 32));
    const int max_p = 256 - 8;
    std::memset(zero, 0, sizeof zero);
    std::memset(one, 0, sizeof one);
    int last_p8 = 0;
    int64_t p = one_ / 2;
    for (int i = 0; i < 128; ++i) {
      int p8 = static_cast<int>((256 * p + one_ / 2) >> 32);
      if (p8 <= last_p8) p8 = last_p8 + 1;
      if (last_p8 && last_p8 < 256 && p8 <= max_p) one[last_p8] = static_cast<uint8_t>(p8);
      p += ((one_ - p) * factor + one_ / 2) >> 32;
      last_p8 = p8;
    }
    for (int i = 256 - max_p; i <= max_p; ++i) {
      if (one[i]) continue;
      p = (i * one_ + 128) >> 8;
      p += ((one_ - p) * factor + one_ / 2) >> 32;
      int p8 = static_cast<int>((256 * p + one_ / 2) >> 32);
      if (p8 <= i) p8 = i + 1;
      if (p8 > max_p) p8 = max_p;
      one[i] = static_cast<uint8_t>(p8);
    }
    for (int i = 1; i < 255; ++i) zero[i] = static_cast<uint8_t>(256 - one[256 - i]);
  }
  void Custom(const uint8_t* transition) {
    for (int i = 1; i < 256; ++i) {
      one[i] = transition[i];
      zero[256 - i] = static_cast<uint8_t>(256 - one[i]);
    }
  }
  void Refill() {
    if (range < 0x100) {
      range <<= 8;
      low <<= 8;
      if (pos < end)
        low += *pos++;
      else
        ++overread;
    }
  }
  int Bit(uint8_t* state) {
    const int range1 = (range * (*state)) >> 8;
    range -= range1;
    if (low < range) {
      *state = zero[*state];
      Refill();
      return 0;
    }
    low -= range;
    *state = one[*state];
    range = range1;
    Refill();
    return 1;
  }
  // get_symbol(): 0, or an exponent in unary, the mantissa's bits, and a sign.
  int Symbol(uint8_t* state, bool is_signed) {
    if (Bit(state)) return 0;
    int e = 0;
    while (Bit(state + 1 + (e < 9 ? e : 9))) {
      if (++e > 31) throw Error{-1, "a range-coded symbol longer than 32 bits"};
    }
    unsigned a = 1;
    for (int i = e - 1; i >= 0; --i) a += a + Bit(state + 22 + (i < 9 ? i : 9));
    const int neg = -(is_signed && Bit(state + 11 + (e < 10 ? e : 10)));
    return static_cast<int>((a ^ static_cast<unsigned>(neg)) - static_cast<unsigned>(neg));
  }
  int64_t Consumed() const { return pos - start; }
};

// MSB-first bit reader for Golomb-Rice, over a copy of the slice's bytes padded with zeros: reads past the end
// give zeros and are counted.
struct BitReader {
  std::vector<uint8_t> data;
  int64_t bits = 0, at = 0;
  void Init(const uint8_t* d, int64_t bytes) {
    bytes = bytes > 0 ? bytes : 0;
    data.assign(d, d + bytes);
    data.resize(static_cast<size_t>(bytes) + 16, 0);
    bits = bytes * 8, at = 0;
  }
  // The next 57 bits or more, left-aligned.
  uint64_t Peek() const {
    if (at >= bits) return 0;
    uint64_t w;
    std::memcpy(&w, data.data() + (at >> 3), 8);
    return __builtin_bswap64(w) << (at & 7);
  }
  int Bit() {
    const int v = static_cast<int>(Peek() >> 63);
    ++at;
    return v;
  }
  unsigned Bits(int n) {
    if (!n) return 0;
    const unsigned v = static_cast<unsigned>(Peek() >> (64 - n));
    at += n;
    return v;
  }
  bool Overread() const { return at > bits; }
};

const uint8_t kLog2Run[41] = {0, 0, 0, 0, 1, 1, 1, 1, 2,  2,  2,  2,  3,  3,  3,  3,  4,  4,  5,  5,  6,
                              6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24};

struct VlcState {
  int drift = 0, error_sum = 4, bias = 0, count = 1;
};

// get_ur_golomb(gb, k, 12, bits) then the sign fold of get_sr_golomb: fewer than 12 zeros, a one and k bits;
// else 12 zeros and esc_len bits.
int SignedGolomb(BitReader& br, int k, int esc_len) {
  const uint64_t w = br.Peek();
  const int zeros = w ? __builtin_clzll(w) : 64;
  unsigned v;
  if (zeros < 12 && k <= 32) {
    v = (static_cast<unsigned>(zeros) << k) + (k ? static_cast<unsigned>((w << (zeros + 1)) >> (64 - k)) : 0u);
    br.at += zeros + 1 + k;
  } else if (zeros < 12) {
    br.at += zeros + 1;
    v = (static_cast<unsigned>(zeros) << k) + br.Bits(k);
  } else {
    br.at += 12;
    v = br.Bits(esc_len) + 11;
  }
  return static_cast<int>(v >> 1) ^ -static_cast<int>(v & 1);
}

int Fold(int diff, int bits) {
  const int shift = 32 - bits;
  return static_cast<int>(static_cast<uint32_t>(diff) << shift) >> shift;
}

int VlcSymbol(BitReader& br, VlcState& s, int bits) {
  int i = s.count, k = 0;
  while (i < s.error_sum) ++k, i += i;
  int v = SignedGolomb(br, k, bits);
  v ^= (2 * s.drift + s.count) >> 31;
  const int ret = Fold(v + s.bias, bits);
  // update_vlc_state()
  int drift = s.drift, count = s.count;
  s.error_sum += v < 0 ? -v : v;
  drift += v;
  if (count == 128) count >>= 1, drift >>= 1, s.error_sum >>= 1;
  ++count;
  if (drift <= -count) {
    s.bias = s.bias - 1 > -128 ? s.bias - 1 : -128;
    drift = drift + count > -count + 1 ? drift + count : -count + 1;
  } else if (drift > 0) {
    s.bias = s.bias + 1 < 127 ? s.bias + 1 : 127;
    drift = drift - count < 0 ? drift - count : 0;
  }
  s.drift = drift;
  s.count = count;
  return ret;
}

using QuantTable = int16_t[5][256];

int MidPred(int a, int b, int c) {
  if (a > b) std::swap(a, b);
  return c <= a ? a : c >= b ? b : c;
}

struct PlaneContext {
  int quant_table = 0;
  int context_count = 0;
  std::vector<uint8_t> state;  // context_count x kContextSize
  std::vector<VlcState> vlc;
};

struct Slice {
  int x = 0, y = 0, w = 0, h = 0;
  PlaneContext planes[4];
  RangeCoder rc;
  BitReader br;
  int run_index = 0;
};

uint32_t Crc32(uint32_t crc, const uint8_t* data, int64_t n) {  // AV_CRC_32_IEEE: MSB first, 0x04C11DB7
  static uint32_t table[256];
  static bool ready = false;
  if (!ready) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i << 24;
      for (int j = 0; j < 8; ++j) c = (c << 1) ^ ((c & 0x80000000u) ? 0x04C11DB7u : 0);
      table[i] = c;
    }
    ready = true;
  }
  for (int64_t i = 0; i < n; ++i) crc = (crc << 8) ^ table[((crc >> 24) ^ data[i]) & 0xFF];
  return crc;
}

uint32_t Bswap(uint32_t v) { return (v >> 24) | ((v >> 8) & 0xFF00) | ((v << 8) & 0xFF0000) | (v << 24); }

class Decoder {
 public:
  Decoder(const uint8_t* config, int64_t size, int width, int height) : width_(width), height_(height) {
    if (width <= 0 || height <= 0) throw Error{-1, "a frame size of " + std::to_string(width) + "x" + std::to_string(height)};
    if (size > 0) ReadConfig(config, size);
  }

  void Decode(const uint8_t* buf, int64_t size) {
    if (size < 2) throw Error{-1, "a packet of " + std::to_string(size) + " bytes"};
    RangeCoder& c = frame_rc_;
    c.Init(buf, size);
    c.BuildStates();
    uint8_t keystate = 128;
    const bool key = c.Bit(&keystate);
    if (key) {
      ReadHeader(c, buf);
      have_key_ = true;
    } else if (!have_key_) {
      throw Error{-1, "a non-key frame before the first key frame"};
    }
    if (ac_ == 2) c.Custom(transition_);
    // The slices, found from the end of the packet.
    const int trailer = 3 + 5 * (ec_ ? 1 : 0);
    const uint8_t* p = buf + size;
    std::vector<std::pair<const uint8_t*, int64_t>> spans(slice_count_);
    for (int i = slice_count_ - 1; i >= 0; --i) {
      int64_t v;
      if (i || version_ > 2) {
        if (trailer > p - buf) throw Error{-1, "slice " + std::to_string(i) + " without its footer"};
        v = ((int64_t{p[-trailer]} << 16) | (p[-trailer + 1] << 8) | p[-trailer + 2]) + trailer;
      } else {
        v = p - c.start;
      }
      if (p - c.start < v) throw Error{-1, "a broken chain of slice sizes (slice " + std::to_string(i) + ")"};
      p -= v;
      if (ec_) {
        const uint32_t crc = Crc32(Bswap(crcref_), p, v);
        ++stats_[kCrcSlices];
        if (crc != Bswap(crcref_)) {
          char hex[16];
          std::snprintf(hex, sizeof hex, "%08X", crc);
          throw Error{-3, "slice " + std::to_string(i) + " of frame " + std::to_string(stats_[kFrames]) +
                              " fails its CRC (" + hex + ")"};
        }
      }
      spans[i] = {p, v};
    }
    for (int i = 0; i < slice_count_; ++i) {
      Slice& s = slices_[i];
      if (i) {
        s.rc.Init(spans[i].first, spans[i].second);
        s.rc.BuildStates();
        if (ac_ == 2) s.rc.Custom(transition_);
      } else {
        s.rc = c;
        s.rc.end = spans[0].first + spans[0].second;
      }
      DecodeSlice(s, key);
    }
    ++stats_[kFrames];
    ++stats_[key ? kKeyFrames : kNonKeyFrames];
    stats_[kSlices] += slice_count_;
    if (slice_count_ > 1) ++stats_[kMultiSliceFrames];
    ++stats_[kVersion0 + version_];
    ++stats_[ac_ == 0 ? kCoderGolomb : ac_ == 1 ? kCoderRangeDefault : kCoderRangeCustom];
    if (large_context_) ++stats_[kLargeContextFrames];
    if (initial_states_used_) ++stats_[kInitialStateFrames];
    ++stats_[layout_];
  }

  void Bgr(uint8_t* out) const {
    const size_t n = static_cast<size_t>(width_) * height_;
    if (colorspace_ == 1) {
      for (size_t i = 0; i < n; ++i) out[3 * i] = planes_[1][i], out[3 * i + 1] = planes_[0][i], out[3 * i + 2] = planes_[2][i];
    } else if (!chroma_planes_) {
      for (size_t i = 0; i < n; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = planes_[0][i];
    } else {
      sr_yuv::YuvToBgr(planes_[0].data(), planes_[1].data(), planes_[2].data(), width_, ChromaWidth(), width_,
                       height_, h_shift_, v_shift_, out, transparency_ != 0);
    }
  }

  // Plane `i` (Y U V A, or G B R A) of the last frame; its size in bytes, 0 where there is none.
  int64_t Plane(int i, uint8_t* out, int32_t* shape) const {
    if (i < 0 || i > 3 || planes_[i].empty()) return 0;
    const bool chroma = colorspace_ == 0 && (i == 1 || i == 2);
    shape[0] = chroma ? ChromaWidth() : width_;
    shape[1] = chroma ? ChromaHeight() : height_;
    if (out) std::memcpy(out, planes_[i].data(), planes_[i].size());
    return static_cast<int64_t>(planes_[i].size());
  }

  const int64_t* Stats() const { return stats_; }

 private:
  int ChromaWidth() const { return -((-width_) >> h_shift_); }
  int ChromaHeight() const { return -((-height_) >> v_shift_); }

  static int ReadQuantTable(RangeCoder& c, int16_t* table, int scale) {
    uint8_t state[kContextSize];
    std::memset(state, 128, sizeof state);
    int i = 0, v = 0;
    for (; i < 128; ++v) {
      const unsigned len = static_cast<unsigned>(c.Symbol(state, false)) + 1u;
      if (len > static_cast<unsigned>(128 - i) || !len) throw Error{-1, "a quantisation table that overruns"};
      for (unsigned k = 0; k < len; ++k) table[i++] = static_cast<int16_t>(scale * v);
    }
    for (i = 1; i < 128; ++i) table[256 - i] = static_cast<int16_t>(-table[i]);
    table[128] = static_cast<int16_t>(-table[127]);
    return 2 * v - 1;
  }

  static int ReadQuantTables(RangeCoder& c, QuantTable& t) {
    int count = 1;
    for (int i = 0; i < 5; ++i) {
      count *= ReadQuantTable(c, t[i], count);
      if (count <= 0 || count > 32768) throw Error{-1, "a context count past 32768"};
    }
    return (count + 1) / 2;
  }

  void ReadTransition(RangeCoder& c, uint8_t* state) {
    for (int i = 1; i < 256; ++i) {
      const int st = c.Symbol(state, true) + c.one[i];
      if (st < 1 || st > 255) throw Error{-1, "a state transition of " + std::to_string(st)};
      transition_[i] = static_cast<uint8_t>(st);
    }
  }

  void CheckBits(int bits) {
    if (bits > 8)
      throw Error{-2, std::to_string(bits) + " bits a sample (bits_per_raw_sample " + std::to_string(bits) + ")"};
  }

  // The version 2+ configuration record (CodecPrivate / extradata).
  void ReadConfig(const uint8_t* data, int64_t size) {
    RangeCoder c;
    c.Init(data, size);
    c.BuildStates();
    uint8_t state[kContextSize];
    std::memset(state, 128, sizeof state);
    version_ = c.Symbol(state, false);
    if (version_ < 2) throw Error{-1, "a configuration record of version " + std::to_string(version_)};
    if (version_ > 3) throw Error{-2, "version " + std::to_string(version_)};
    if (version_ > 2) {
      c.end -= 4;
      micro_version_ = c.Symbol(state, false);
    }
    combined_ = (version_ << 16) + micro_version_;
    ac_ = c.Symbol(state, false);
    if (ac_ > 2) throw Error{-2, "coder type " + std::to_string(ac_)};
    if (ac_ == 2) ReadTransition(c, state);
    colorspace_ = c.Symbol(state, false);
    bits_ = c.Symbol(state, false);
    chroma_planes_ = c.Bit(state);
    h_shift_ = c.Symbol(state, false);
    v_shift_ = c.Symbol(state, false);
    transparency_ = c.Bit(state);
    plane_count_ = 1 + 1 + transparency_;
    num_h_slices_ = 1 + c.Symbol(state, false);
    num_v_slices_ = 1 + c.Symbol(state, false);
    if (num_h_slices_ <= 0 || num_h_slices_ > width_ || num_v_slices_ <= 0 || num_v_slices_ > height_ ||
        num_h_slices_ > kMaxSlices / num_v_slices_)
      throw Error{-1, "a slice grid of " + std::to_string(num_h_slices_) + "x" + std::to_string(num_v_slices_)};
    quant_table_count_ = c.Symbol(state, false);
    if (quant_table_count_ <= 0 || quant_table_count_ > kMaxQuantTables)
      throw Error{-1, std::to_string(quant_table_count_) + " quantisation table sets"};
    for (int i = 0; i < quant_table_count_; ++i) context_count_[i] = ReadQuantTables(c, quant_tables_[i]);
    uint8_t state2[kContextSize][kContextSize];
    std::memset(state2, 128, sizeof state2);
    for (int i = 0; i < quant_table_count_; ++i) {
      if (!c.Bit(state)) continue;
      initial_states_[i].assign(static_cast<size_t>(context_count_[i]) * kContextSize, 0);
      for (int j = 0; j < context_count_[i]; ++j)
        for (int k = 0; k < kContextSize; ++k) {
          const int pred = j ? initial_states_[i][(j - 1) * kContextSize + k] : 128;
          initial_states_[i][j * kContextSize + k] = static_cast<uint8_t>((pred + c.Symbol(state2[k], true)) & 0xFF);
        }
    }
    if (version_ > 2) {
      ec_ = c.Symbol(state, false);
      if (ec_ >= 2) crcref_ = 0x7a8c4079;
      if (combined_ >= 0x30003) c.Symbol(state, false);  // intra: every frame a key frame (not needed to decode)
      const uint32_t crc = Crc32(Bswap(crcref_), data, size);
      if (crc != Bswap(crcref_) || size < 4) {
        char hex[16];
        std::snprintf(hex, sizeof hex, "%08X", crc);
        throw Error{-1, std::string("a configuration record whose CRC fails (") + hex + ")"};
      }
    }
    CheckLayout();
    InitSlices();
  }

  // ffv1dec.c's choice of pixel format: what it refuses is refused here.
  void CheckLayout() {
    CheckBits(bits_ ? bits_ : 8);
    if (h_shift_ > 4 || v_shift_ > 4 || h_shift_ < 0 || v_shift_ < 0)
      throw Error{-1, "a chroma shift of " + std::to_string(h_shift_) + "x" + std::to_string(v_shift_)};
    if (colorspace_ == 0) {
      if (!chroma_planes_) {
        layout_ = transparency_ ? kGreyAlpha : kGrey;
        return;
      }
      const int code = 16 * h_shift_ + v_shift_;
      if (transparency_) {
        if (code != 0x00 && code != 0x10 && code != 0x11)
          throw Error{-2, "YCbCr with transparency and chroma shifts " + std::to_string(h_shift_) + "," +
                              std::to_string(v_shift_) + " (FFmpeg decodes 4:4:4, 4:2:2 and 4:2:0 with alpha)"};
        layout_ = kYuvAlpha;
        return;
      }
      switch (code) {
        case 0x00: layout_ = kYuv444; return;
        case 0x01: layout_ = kYuv440; return;
        case 0x10: layout_ = kYuv422; return;
        case 0x11: layout_ = kYuv420; return;
        case 0x20: layout_ = kYuv411; return;
        case 0x22: layout_ = kYuv410; return;
        default:
          throw Error{-2, "YCbCr with chroma shifts " + std::to_string(h_shift_) + "," + std::to_string(v_shift_)};
      }
    }
    if (colorspace_ == 1) {
      if (h_shift_ || v_shift_) throw Error{-2, "RGB with chroma subsampling"};
      layout_ = transparency_ ? kRgbAlpha : kRgb;
      return;
    }
    throw Error{-2, "colourspace " + std::to_string(colorspace_)};
  }

  void InitSlices() {
    max_slice_count_ = num_h_slices_ * num_v_slices_;
    slices_.assign(max_slice_count_, Slice());
    for (int i = 0; i < max_slice_count_; ++i) {
      const int sx = i % num_h_slices_, sy = i / num_h_slices_;
      Slice& s = slices_[i];
      s.x = static_cast<int>(int64_t{width_} * sx / num_h_slices_);
      s.w = static_cast<int>(int64_t{width_} * (sx + 1) / num_h_slices_) - s.x;
      s.y = static_cast<int>(int64_t{height_} * sy / num_v_slices_);
      s.h = static_cast<int>(int64_t{height_} * (sy + 1) / num_v_slices_) - s.y;
    }
    const size_t n = static_cast<size_t>(width_) * height_;
    for (auto& p : planes_) p.clear();
    planes_[0].assign(n, 0);
    if (colorspace_ == 1) {
      planes_[1].assign(n, 0), planes_[2].assign(n, 0);
      if (transparency_) planes_[3].assign(n, 0);
    } else {
      if (chroma_planes_) {
        const size_t cn = static_cast<size_t>(ChromaWidth()) * ChromaHeight();
        planes_[1].assign(cn, 0), planes_[2].assign(cn, 0);
      }
      if (transparency_) planes_[3].assign(n, 0);
    }
  }

  // read_header(): a key frame's header (versions 0 / 1: the stream's parameters; 2: the slices; 3: their count).
  void ReadHeader(RangeCoder& c, const uint8_t* buf) {
    uint8_t state[kContextSize];
    std::memset(state, 128, sizeof state);
    if (version_ < 2) {
      const int v = c.Symbol(state, false);
      if (v >= 2) throw Error{-1, "version " + std::to_string(v) + " in a version 0 / 1 frame header"};
      const int ac = c.Symbol(state, false);
      if (ac > 2) throw Error{-2, "coder type " + std::to_string(ac)};
      if (ac == 2) ReadTransition(c, state);
      const int colorspace = c.Symbol(state, false);
      const int bits = v > 0 ? c.Symbol(state, false) : 0;
      const int chroma_planes = c.Bit(state);
      const int h_shift = c.Symbol(state, false), v_shift = c.Symbol(state, false);
      const int transparency = c.Bit(state);
      if (have_header_ && (colorspace != colorspace_ || bits != bits_ || chroma_planes != chroma_planes_ ||
                           h_shift != h_shift_ || v_shift != v_shift_ || transparency != transparency_))
        throw Error{-1, "a change of the stream's parameters"};
      version_ = v, ac_ = ac, colorspace_ = colorspace, bits_ = bits, chroma_planes_ = chroma_planes;
      h_shift_ = h_shift, v_shift_ = v_shift, transparency_ = transparency;
      plane_count_ = 2 + transparency_;
      combined_ = version_ << 16;
      quant_table_count_ = 1;
      context_count_[0] = ReadQuantTables(c, quant_tables_[0]);
      num_h_slices_ = num_v_slices_ = 1;
      if (!have_header_) {
        CheckLayout();
        InitSlices();
      }
      have_header_ = true;
      slice_count_ = max_slice_count_;
    } else if (version_ < 3) {
      slice_count_ = c.Symbol(state, false);
    } else {
      const uint8_t* p = c.end;
      const int trailer = 3 + 5 * (ec_ ? 1 : 0);
      for (slice_count_ = 0; slice_count_ < kMaxSlices && trailer < p - buf; ++slice_count_) {
        const int64_t sz = (int64_t{p[-trailer]} << 16) | (p[-trailer + 1] << 8) | p[-trailer + 2];
        if (sz + trailer > p - buf) break;
        p -= sz + trailer;
      }
    }
    if (slice_count_ <= 0 || slice_count_ > max_slice_count_)
      throw Error{-1, std::to_string(slice_count_) + " slices in a frame of " + std::to_string(max_slice_count_)};
    for (int j = 0; j < slice_count_; ++j) {
      Slice& s = slices_[j];
      if (version_ == 2) {
        const int sx = c.Symbol(state, false), sy = c.Symbol(state, false);
        const int sw = c.Symbol(state, false) + 1, sh = c.Symbol(state, false) + 1;
        if (sx < 0 || sy < 0 || sw <= 0 || sh <= 0 || sx > num_h_slices_ - sw || sy > num_v_slices_ - sh)
          throw Error{-1, "slice " + std::to_string(j) + " outside the slice grid"};
        s.x = static_cast<int>(int64_t{sx} * width_ / num_h_slices_);
        s.y = static_cast<int>(int64_t{sy} * height_ / num_v_slices_);
        s.w = static_cast<int>(int64_t{sx + sw} * width_ / num_h_slices_) - s.x;
        s.h = static_cast<int>(int64_t{sy + sh} * height_ / num_v_slices_) - s.y;
      }
      for (int i = 0; i < plane_count_; ++i) {
        PlaneContext& pc = s.planes[i];
        int context_count = context_count_[0];
        if (version_ == 2) {
          const int idx = c.Symbol(state, false);
          if (idx < 0 || idx >= quant_table_count_) throw Error{-1, "a quantisation table index out of range"};
          pc.quant_table = idx;
          context_count = context_count_[idx];
        }
        pc.context_count = context_count;
      }
    }
  }

  // decode_slice_header() of version 3.
  void ReadSliceHeader(Slice& s) {
    RangeCoder& c = s.rc;
    uint8_t state[kContextSize];
    std::memset(state, 128, sizeof state);
    const int sx = c.Symbol(state, false), sy = c.Symbol(state, false);
    const int sw = c.Symbol(state, false) + 1, sh = c.Symbol(state, false) + 1;
    if (sx < 0 || sy < 0 || sw <= 0 || sh <= 0 || sx > num_h_slices_ - sw || sy > num_v_slices_ - sh)
      throw Error{-1, "a slice outside the slice grid"};
    // ff_slice_coord() for streams up to version 4.2: width * sx / slices.
    s.x = static_cast<int>(int64_t{width_} * sx / num_h_slices_);
    s.y = static_cast<int>(int64_t{height_} * sy / num_v_slices_);
    s.w = static_cast<int>(int64_t{width_} * (sx + sw) / num_h_slices_) - s.x;
    s.h = static_cast<int>(int64_t{height_} * (sy + sh) / num_v_slices_) - s.y;
    for (int i = 0; i < plane_count_; ++i) {
      const int idx = c.Symbol(state, false);
      if (idx < 0 || idx >= quant_table_count_) throw Error{-1, "a quantisation table index out of range"};
      s.planes[i].quant_table = idx;
      s.planes[i].context_count = context_count_[idx];
    }
    c.Symbol(state, false);  // picture structure
    c.Symbol(state, false);  // sample aspect ratio
    c.Symbol(state, false);
  }

  void ClearSliceState(Slice& s) {
    for (int i = 0; i < plane_count_; ++i) {
      PlaneContext& p = s.planes[i];
      if (ac_ != 0) {
        const auto& init = initial_states_[p.quant_table];
        if (!init.empty())
          p.state = init;
        else
          p.state.assign(static_cast<size_t>(p.context_count) * kContextSize, 128);
      } else {
        p.vlc.assign(p.context_count, VlcState());
      }
    }
  }

  void DecodeSlice(Slice& s, bool key) {
    if (version_ > 2) ReadSliceHeader(s);
    bool sized = true;
    for (int i = 0; i < plane_count_; ++i) {
      const PlaneContext& p = s.planes[i];
      const size_t need = ac_ ? static_cast<size_t>(p.context_count) * kContextSize : static_cast<size_t>(p.context_count);
      sized = sized && (ac_ ? p.state.size() : p.vlc.size()) == need;
    }
    if (key || !sized) {
      if (!key) throw Error{-1, "a non-key frame whose contexts changed size"};
      ClearSliceState(s);
    }
    for (int i = 0; i < plane_count_; ++i)
      if (quant_tables_[s.planes[i].quant_table][3][127] || quant_tables_[s.planes[i].quant_table][4][127])
        large_context_ = true;
    for (int i = 0; i < plane_count_; ++i)
      if (!initial_states_[s.planes[i].quant_table].empty()) initial_states_used_ = true;
    if (ac_ == 0) {
      if (combined_ >= 0x30002) {
        uint8_t st = 129;
        s.rc.Bit(&st);
      }
      const int64_t skip = (version_ > 2 || (!s.x && !s.y)) ? s.rc.Consumed() - 1 : 0;
      s.br.Init(s.rc.start + skip, (s.rc.end - s.rc.start) - skip);
    }
    const int x = s.x, y = s.y, w = s.w, h = s.h;
    if (colorspace_ == 0 && (chroma_planes_ || !transparency_)) {
      DecodePlane(s, &planes_[0][static_cast<size_t>(y) * width_ + x], w, h, width_, 0);
      if (chroma_planes_) {
        const int cw = -((-w) >> h_shift_), ch = -((-h) >> v_shift_);
        const size_t off = static_cast<size_t>(y >> v_shift_) * ChromaWidth() + (x >> h_shift_);
        DecodePlane(s, &planes_[1][off], cw, ch, ChromaWidth(), 1);
        DecodePlane(s, &planes_[2][off], cw, ch, ChromaWidth(), 1);
      }
      if (transparency_) DecodePlane(s, &planes_[3][static_cast<size_t>(y) * width_ + x], w, h, width_, 2);
    } else if (colorspace_ == 0) {  // grey with alpha: YA8, the two planes interleaved, one context set each
      DecodePlane(s, &planes_[0][static_cast<size_t>(y) * width_ + x], w, h, width_, 0);
      DecodePlane(s, &planes_[3][static_cast<size_t>(y) * width_ + x], w, h, width_, 1);
    } else {
      DecodeRgb(s, w, h);
    }
    if (ac_ != 0 && version_ > 2) {
      uint8_t st = 129;
      s.rc.Bit(&st);
      const int64_t left = (s.rc.end - s.rc.pos) - 2 - 5 * (ec_ ? 1 : 0);
      if (left) throw Error{-1, "a slice whose range coder ends " + std::to_string(left) + " bytes from its footer"};
    }
    if (ac_ == 0 ? s.br.Overread() : s.rc.overread > 2) throw Error{-1, "a slice that runs past its data"};
  }

  // decode_line(): one row of `w` samples into sample[1], sample[0] the row above.
  void DecodeLine(Slice& s, int w, int16_t* sample[2], int plane, int bits) {
    PlaneContext& p = s.planes[plane];
    const QuantTable& q = quant_tables_[p.quant_table];
    const bool five = q[3][127] || q[4][127];
    const int mask = (1 << bits) - 1;
    int run_count = 0, run_mode = 0, run_index = s.run_index;
    int16_t* cur = sample[1];
    const int16_t* last = sample[0];
    for (int x = 0; x < w; ++x) {
      const int LT = last[x - 1], T = last[x], RT = last[x + 1], L = cur[x - 1];
      int context = q[0][(L - LT) & 0xFF] + q[1][(LT - T) & 0xFF] + q[2][(T - RT) & 0xFF];
      if (five) context += q[3][(cur[x - 2] - L) & 0xFF] + q[4][(cur[x] - T) & 0xFF];  // LL, and TT two rows up
      int sign = 0;
      if (context < 0) context = -context, sign = 1;
      if (context >= p.context_count) throw Error{-1, "a context past the context count"};
      int diff;
      if (ac_ != 0) {
        diff = s.rc.Symbol(&p.state[static_cast<size_t>(context) * kContextSize], true);
      } else {
        if (context == 0 && run_mode == 0) run_mode = 1;
        if (run_mode) {
          if (run_count == 0 && run_mode == 1) {
            if (s.br.Bit()) {
              run_count = 1 << kLog2Run[run_index];
              if (x + run_count <= w) ++run_index;
              ++stats_[kRuns];
            } else {
              run_count = kLog2Run[run_index] ? static_cast<int>(s.br.Bits(kLog2Run[run_index])) : 0;
              if (run_index) --run_index;
              run_mode = 2;
            }
          }
          if (--run_count < 0) {
            run_mode = 0;
            run_count = 0;
            diff = VlcSymbol(s.br, p.vlc[context], bits);
            if (diff >= 0) ++diff;
          } else {
            diff = 0;
          }
        } else {
          diff = VlcSymbol(s.br, p.vlc[context], bits);
        }
      }
      if (sign) diff = static_cast<int>(0u - static_cast<unsigned>(diff));
      cur[x] = static_cast<int16_t>((MidPred(L, T, L + T - LT) + diff) & mask);
    }
    s.run_index = run_index;
  }

  // decode_plane(): rows of `w` samples, `stride` apart, into dst.
  void DecodePlane(Slice& s, uint8_t* dst, int w, int h, int stride, int plane) {
    std::vector<int16_t> buffer(2 * static_cast<size_t>(w + 6), 0);
    int16_t* sample[2] = {buffer.data() + 3, buffer.data() + w + 6 + 3};
    s.run_index = 0;
    for (int y = 0; y < h; ++y) {
      std::swap(sample[0], sample[1]);
      sample[1][-1] = sample[0][0];
      sample[0][w] = sample[0][w - 1];
      DecodeLine(s, w, sample, plane, 8);
      uint8_t* row = dst + static_cast<size_t>(y) * stride;
      for (int x = 0; x < w; ++x) row[x] = static_cast<uint8_t>(sample[1][x]);
    }
  }

  // decode_rgb_frame(): G, B, R (and A) rows in turn at 9 bits, then the reversible colour transform undone.
  void DecodeRgb(Slice& s, int w, int h) {
    const int planes = 3 + transparency_;
    std::vector<int16_t> buffer(8 * static_cast<size_t>(w + 6), 0);
    int16_t* sample[4][2];
    for (int k = 0; k < 4; ++k) {
      sample[k][0] = buffer.data() + k * 2 * (w + 6) + 3;
      sample[k][1] = buffer.data() + (k * 2 + 1) * (w + 6) + 3;
    }
    s.run_index = 0;
    const int offset = 1 << 8;
    for (int y = 0; y < h; ++y) {
      for (int k = 0; k < planes; ++k) {
        std::swap(sample[k][0], sample[k][1]);
        sample[k][1][-1] = sample[k][0][0];
        sample[k][0][w] = sample[k][0][w - 1];
        DecodeLine(s, w, sample[k], (k + 1) / 2, 9);
      }
      const size_t row = static_cast<size_t>(s.y + y) * width_ + s.x;
      for (int x = 0; x < w; ++x) {
        int g = sample[0][1][x], b = sample[1][1][x] - offset, r = sample[2][1][x] - offset;
        const int a = sample[3][1][x];
        g -= (b + r) >> 2;
        b += g;
        r += g;
        // FFmpeg stores b + (g << 8) + (r << 16) + (a << 24) as one 32-bit pixel (0RGB32 / RGB32): a value
        // outside 0-255 carries into the next byte.
        const uint32_t px = static_cast<uint32_t>(b) + (static_cast<uint32_t>(g) << 8) +
                            (static_cast<uint32_t>(r) << 16) + (static_cast<uint32_t>(a) << 24);
        planes_[0][row + x] = static_cast<uint8_t>(px >> 8);
        planes_[1][row + x] = static_cast<uint8_t>(px);
        planes_[2][row + x] = static_cast<uint8_t>(px >> 16);
        if (transparency_) planes_[3][row + x] = static_cast<uint8_t>(px >> 24);
      }
    }
  }

  int width_, height_;
  int version_ = 0, micro_version_ = 0, combined_ = 0, ac_ = 0, colorspace_ = 0, bits_ = 0, chroma_planes_ = 0;
  int h_shift_ = 0, v_shift_ = 0, transparency_ = 0, plane_count_ = 0, ec_ = 0;
  uint32_t crcref_ = 0;
  int num_h_slices_ = 1, num_v_slices_ = 1, max_slice_count_ = 0, slice_count_ = 0;
  int quant_table_count_ = 0, context_count_[kMaxQuantTables] = {};
  QuantTable quant_tables_[kMaxQuantTables] = {};
  std::vector<uint8_t> initial_states_[kMaxQuantTables];
  uint8_t transition_[256] = {};
  bool have_key_ = false, have_header_ = false, large_context_ = false, initial_states_used_ = false;
  int layout_ = kGrey;
  RangeCoder frame_rc_;
  std::vector<Slice> slices_;
  std::vector<uint8_t> planes_[4];
  int64_t stats_[kStatCount] = {};
};

void SetError(char* err, int err_len, const std::string& what) {
  if (err && err_len > 0) std::snprintf(err, static_cast<size_t>(err_len), "%s", what.c_str());
}

}  // namespace

extern "C" {

void* sr_ffv1_stream_new(const uint8_t* config, int64_t size, int width, int height, char* err, int err_len) {
  try {
    return new Decoder(config, size, width, height);
  } catch (const Error& e) {
    SetError(err, err_len, (e.code == -2 ? "2:" : "1:") + e.what);
  } catch (const std::exception& e) {
    SetError(err, err_len, std::string("1:") + e.what());
  }
  return nullptr;
}

void sr_ffv1_stream_free(void* h) { delete static_cast<Decoder*>(h); }

int sr_ffv1_stream_decode(void* h, const uint8_t* data, int64_t size, char* err, int err_len) {
  try {
    static_cast<Decoder*>(h)->Decode(data, size);
    return 1;
  } catch (const Error& e) {
    SetError(err, err_len, e.what);
    return e.code;
  } catch (const std::exception& e) {
    SetError(err, err_len, e.what());
    return -1;
  }
}

void sr_ffv1_stream_bgr(void* h, uint8_t* out) { static_cast<Decoder*>(h)->Bgr(out); }

int64_t sr_ffv1_stream_plane(void* h, int plane, uint8_t* out, int32_t* shape) {
  return static_cast<Decoder*>(h)->Plane(plane, out, shape);
}

int sr_ffv1_stream_stats(void* h, int64_t* out, int n) {
  const int64_t* stats = static_cast<Decoder*>(h)->Stats();
  for (int i = 0; i < n && i < kStatCount; ++i) out[i] = stats[i];
  return kStatCount;
}

void sr_yuv_to_bgr(const uint8_t* y, const uint8_t* u, const uint8_t* v, int y_stride, int uv_stride, int width,
                   int height, int sx, int sy, int alpha, int h_chr_pos, int v_chr_pos, uint8_t* out) {
  sr_yuv::YuvToBgr(y, u, v, y_stride, uv_stride, width, height, sx, sy, out, alpha != 0, h_chr_pos, v_chr_pos);
}

}  // extern "C"
