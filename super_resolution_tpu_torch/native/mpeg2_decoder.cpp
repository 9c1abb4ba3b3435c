// MPEG-1 video (ISO/IEC 11172-2) and MPEG-2 video (ISO/IEC 13818-2, Main
// profile: progressive and interlaced frame pictures, 4:2:0, 8 bits) for
// super_resolution_tpu_torch.utils.mpeg2, bound with ctypes: a stateful
// decoder behind a handle, fed a container's payloads (one picture each, or a
// whole elementary stream) as cv2.VideoCapture's FFmpeg (mpeg12dec) decodes
// them.
//
// Read: the sequence header with its quantiser matrices, the sequence
// extension, the sequence display extension (its matrix_coefficients choose
// the colour conversion), the quant matrix extension, the group of pictures
// header (closed_gop), the picture header and picture coding extension
// (f_codes, intra_dc_precision 8-11, top_field_first, frame_pred_frame_dct,
// concealment_motion_vectors, q_scale_type, intra_vlc_format, alternate_scan,
// repeat_first_field, progressive_frame), slices (MPEG-1's across rows too)
// and the macroblocks of I, P and B pictures: address increments with escapes
// and stuffing, skipped macroblocks (P: a zero vector; B: the vectors and
// directions of the macroblock before), macroblock types, dct_type,
// frame_motion_type, coded_block_pattern, DC and AC coefficients (tables B-14
// and B-15, MPEG-1's and MPEG-2's escapes).
//
// Reconstructed as FFmpeg's x86-64 build reconstructs (which departs from the
// standard in places; this follows FFmpeg): inverse quantisation without
// saturation (a value past 16 bits wraps, as FFmpeg's int16_t blocks keep
// it), MPEG-2's mismatch control on coefficient 63 and MPEG-1's oddification
// ((v - 1) | 1, so that 0 becomes -1); FFmpeg's simple IDCT (simple_idct.h,
// the routine FFmpeg picks for MPEG-1 / MPEG-2 on x86-64); motion vectors
// with MPEG-1's full_pel, MPEG-2's frame and field prediction in frame
// pictures (each field's vector selecting a reference field; chroma vectors
// halved towards zero) and field DCT; half-pel prediction with rounding, and
// bi-directional prediction as the average (rounded up) of the forward
// prediction and the backward one; the picture cropped from the macroblock
// grid to the sequence's size. Pictures come out in FFmpeg's order: a B
// picture (or any picture under low_delay) at once, an I or P picture when the
// next one is decoded, the last at the end of the stream (sr_mpeg2_stream_flush).
// B pictures of an open GOP that precede its I picture in a stream that starts
// there are dropped, as FFmpeg drops them; pictures before the first sequence
// header give no frame. The frame is converted to BGR24 with swscale's
// arithmetic (swscale_bgr.h) for the sequence display extension's matrix
// (BT.601 where there is none), limited range, with MPEG-2's chroma sited left
// and MPEG-1's centred, as cv2.VideoCapture converts it.
//
// Refused by name (sr_mpeg2_stream_decode returns -2): field pictures, dual
// prime motion, 4:2:2 and 4:4:4 chroma, the scalable extensions (data
// partitioning among them), D pictures, a picture size that changes
// mid-stream, a stream that starts with a P picture, a B picture with no
// forward reference in a closed GOP, a colour matrix other than BT.601,
// BT.709, FCC and SMPTE 240M, and one other than BT.601 at an odd height.
// Damaged data (an invalid code, a motion vector out of the picture,
// macroblocks no slice covers) returns -1 with what was wrong.
//
// C interface:
//   void* sr_mpeg2_stream_new(const uint8_t* config, int64_t size, char* err, int err_len)
//     a decoder, given the headers a container keeps outside the payloads
//     (size 0: none); null with err set (a leading '!' for a refused feature)
//     when they are refused or damaged; sr_mpeg2_stream_free(h) ends it
//   int sr_mpeg2_stream_decode(void* h, const uint8_t* data, int64_t size, char* err, int err_len)
//     decodes the pictures of one payload; returns the number of frames
//     output, -1: corrupt data, -2: a refused feature (err names it)
//   int sr_mpeg2_stream_flush(void* h, char* err, int err_len)
//     the end of the stream: outputs the picture still held back; returns their number
//   void sr_mpeg2_stream_size(void* h, int32_t* width_height)   the cropped frame size
//   void sr_mpeg2_stream_bgr(void* h, int index, uint8_t* out)  output frame `index`, height x width x 3
//   void sr_mpeg2_stream_plane(void* h, int index, int plane, uint8_t* out)
//     plane 0 / 1 / 2 (Y, U, V) of output frame `index`, cropped (chroma rounded up), its rows packed
//   int sr_mpeg2_stream_unit(void* h, int index)
//     which call to sr_mpeg2_stream_decode (0, 1, ...) carried output frame `index`'s picture
//   int sr_mpeg2_stream_stats(void* h, int64_t* out, int n)
//     the first n of the Stat counts; returns how many there are
//
// Build: g++ -O3 -shared -fPIC -std=c++17 mpeg2_decoder.cpp -o <lib>.so
// (native/__init__.py does this at first use, into
// super_resolution_tpu_torch/_build/).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "mpeg2_tables.h"
#include "simple_idct.h"
#include "swscale_bgr.h"

namespace sr_mpeg2 {

struct Unsupported : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// The counts kept over a stream (utils/mpeg2.py STATS names them in this order).
enum Stat {
  kSequenceHeaders, kMpeg1Pictures, kMpeg2Pictures, kIPictures, kPPictures, kBPictures, kInterlacedSequences,
  kLowDelaySequences, kGops, kClosedGops, kSlices, kIntraMbs, kSkippedMbs, kQuantMbs, kNoMcMbs, kForwardMbs,
  kBackwardMbs, kBidirectionalMbs, kFieldPredictionMbs, kFieldDctMbs, kConcealmentVectors, kFullPelVectors,
  kEscapes, kIntraVlcPictures, kAlternateScanPictures, kNonLinearQuantPictures, kDcPrecision8, kDcPrecision9,
  kDcPrecision10, kDcPrecision11, kIntraMatrices, kNonIntraMatrices, kChromaMatrices, kQuantMatrixExtensions,
  kRepeatFirstField, kTopFieldFirst, kInterlacedFrames, kOpenGopBDropped, kPicturesBeforeSequence,
  kReorderedPictures, kNumStats
};

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size) : data_(data), bytes_(static_cast<int64_t>(size)) {}
  // The next n (<= 32) bits; past the end of the data they read as zeros.
  uint32_t peek(int n) const {
    const int64_t byte = pos_ >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) v = (v << 8) | (byte + i < bytes_ ? data_[byte + i] : 0);
    return static_cast<uint32_t>((v << (pos_ & 7)) >> (64 - n));
  }
  uint32_t get(int n) {
    const uint32_t v = peek(n);
    pos_ += n;
    return v;
  }
  int get1() { return static_cast<int>(get(1)); }
  int get_signed(int n) {  // two's complement
    const int v = static_cast<int>(get(n));
    return v >= (1 << (n - 1)) ? v - (1 << n) : v;
  }
  int get_xbits(int n) {  // a dc_differential: a leading 0 marks a negative value
    const int v = static_cast<int>(get(n));
    return (v >> (n - 1)) ? v : v - (1 << n) + 1;
  }
  void skip(int n) { pos_ += n; }
  int64_t left() const { return bytes_ * 8 - pos_; }

 private:
  const uint8_t* data_;
  int64_t bytes_, pos_ = 0;
};

class Vlc {
 public:
  Vlc(const Code* codes, int n) {
    for (int i = 0; i < n; ++i) bits_ = std::max<int>(bits_, codes[i].len);
    sym_.assign(size_t{1} << bits_, -1);
    len_.assign(size_t{1} << bits_, 0);
    for (int i = 0; i < n; ++i) {
      const int shift = bits_ - codes[i].len;
      const size_t first = size_t{codes[i].code} << shift;
      for (size_t j = 0; j < (size_t{1} << shift); ++j) {
        sym_[first + j] = static_cast<int16_t>(i);
        len_[first + j] = codes[i].len;
      }
    }
  }
  int decode(BitReader& br) const {  // the symbol, or -1 for a code not in the table
    const uint32_t v = br.peek(bits_);
    if (!len_[v]) return -1;
    br.skip(len_[v]);
    return sym_[v];
  }

 private:
  int bits_ = 0;
  std::vector<int16_t> sym_;
  std::vector<uint8_t> len_;
};

const Vlc& increment_vlc() { static const Vlc v(kAddressIncrement, 36); return v; }
const Vlc& mb_type_vlc(int type) {
  static const Vlc i(kMbTypeI, 2), p(kMbTypeP, 7), b(kMbTypeB, 11);
  return type == 1 ? i : type == 2 ? p : b;
}
const Vlc& cbp_vlc() { static const Vlc v(kCodedBlockPattern, 64); return v; }
const Vlc& motion_vlc() { static const Vlc v(kMotionCode, 17); return v; }
const Vlc& dc_vlc(int component) {
  static const Vlc luma(kDcSizeLuma, 12), chroma(kDcSizeChroma, 12);
  return component ? chroma : luma;
}
const Vlc& dct_vlc(int table) {
  static const Vlc zero(kDctTable0, 113), one(kDctTable1, 113);
  return table ? one : zero;
}
constexpr int kEscape = 111, kEndOfBlock = 112;

inline int sign_extend(int v, int bits) {
  const unsigned shift = 32 - bits;
  return static_cast<int>(static_cast<unsigned>(v) << shift) >> shift;
}

struct Picture {
  int width = 0, height = 0;  // the macroblock grid
  std::vector<uint8_t> y, u, v;
  int unit = 0;
  uint8_t* Plane(int c) { return c == 0 ? y.data() : c == 1 ? u.data() : v.data(); }
  const uint8_t* Plane(int c) const { return c == 0 ? y.data() : c == 1 ? u.data() : v.data(); }
  int Stride(int c) const { return c ? width / 2 : width; }
};

enum { kPictI = 1, kPictP = 2, kPictB = 3 };
enum { kDirForward = 1, kDirBackward = 2 };

class Decoder {
 public:
  Decoder(const uint8_t* config, size_t size) {
    ResetMatrices(false, false);
    if (size) Parse(config, size, /*headers_only=*/true);
  }

  int Decode(const uint8_t* data, size_t size) {
    out_.clear();
    Parse(data, size, false);
    if (cur_) FinishPicture();
    ++unit_;
    return static_cast<int>(out_.size());
  }

  int Flush() {
    out_.clear();
    if (!low_delay_ && next_) {
      out_.push_back(next_);
      next_.reset();
    }
    return static_cast<int>(out_.size());
  }

  const Picture& output(int i) const { return *out_.at(static_cast<size_t>(i)); }
  int width() const { return width_; }
  int height() const { return height_; }
  const int64_t* stats() const { return stats_; }

  void Bgr(int index, uint8_t* bgr) const {
    const Picture& pic = output(index);
    if (height_ % 2 == 0) {  // swscale's unscaled converter, with the stream's matrix
      sr_yuv::Yuv420ToBgrUnscaled(pic.y.data(), pic.u.data(), pic.v.data(), pic.width, pic.width / 2, width_,
                                  height_, colour_, bgr);
      return;
    }
    // An odd height takes swscale's scaled path (BT.601 only: refused otherwise), where the chroma siting counts:
    // left for MPEG-2, centred for MPEG-1, as FFmpeg marks its frames.
    sr_yuv::YuvToBgr(pic.y.data(), pic.u.data(), pic.v.data(), pic.width, pic.width / 2, width_, height_, 1, 1, bgr,
                     false, chroma_left_ ? 0 : sr_yuv::kUnsited, chroma_left_ ? 128 : sr_yuv::kUnsited);
  }

 private:
  // ---- the start-code layer
  static size_t FindStart(const uint8_t* d, size_t size, size_t pos) {
    for (; pos + 3 < size; ++pos)
      if (d[pos + 2] <= 1 && !d[pos] && !d[pos + 1] && d[pos + 2] == 1) return pos;
    return size;
  }

  void Parse(const uint8_t* data, size_t size, bool headers_only) {
    size_t pos = FindStart(data, size, 0);
    while (pos < size) {
      const uint8_t code = data[pos + 3];
      const size_t body = pos + 4, next = FindStart(data, size, body);
      const uint8_t* p = data + body;
      const size_t n = next - body;
      if (code >= 0x01 && code <= 0xAF) {
        if (!headers_only) Slice(code, p, n);
      } else {
        if (code == 0x00 || code == 0xB3 || code == 0xB8) {
          if (cur_) FinishPicture();  // a payload with more than one picture
          picture_pending_ = skipping_ = false;
        }
        switch (code) {
          case 0xB3: SequenceHeader(p, n); break;
          case 0xB5: Extension(p, n); break;
          case 0xB8: Gop(p, n); break;
          case 0x00: if (!headers_only) PictureHeader(p, n); break;
          default: break;  // user data, sequence end, reserved and system codes
        }
      }
      pos = next;
    }
  }

  void ResetMatrices(bool keep_intra, bool keep_inter) {
    for (int i = 0; i < 64; ++i) {
      if (!keep_intra) intra_[i] = chroma_intra_[i] = kDefaultIntraMatrix[i];
      if (!keep_inter) inter_[i] = chroma_inter_[i] = 16;
    }
  }

  // A matrix sent in zigzag order, into raster order; an intra matrix's first weight is taken as 8, as FFmpeg takes
  // it.
  void LoadMatrix(BitReader& br, uint16_t* m0, uint16_t* m1, bool intra) {
    for (int i = 0; i < 64; ++i) {
      int v = static_cast<int>(br.get(8));
      if (!v) throw Corrupt("a quantiser matrix with a weight of 0");
      if (intra && i == 0) v = 8;
      m0[kZigzag[i]] = static_cast<uint16_t>(v);
      if (m1) m1[kZigzag[i]] = static_cast<uint16_t>(v);
    }
  }

  void SequenceHeader(const uint8_t* p, size_t n) {
    BitReader br(p, n);
    seq_width_ = static_cast<int>(br.get(12));
    seq_height_ = static_cast<int>(br.get(12));
    br.skip(4 + 4 + 18 + 1 + 10 + 1);  // aspect ratio, frame rate, bit rate, marker, VBV buffer, constrained
    const bool intra = br.get1();
    if (intra) {
      LoadMatrix(br, chroma_intra_, intra_, true);
      ++stats_[kIntraMatrices];
    }
    const bool inter = br.get1();
    if (inter) {
      LoadMatrix(br, chroma_inter_, inter_, false);
      ++stats_[kNonIntraMatrices];
    }
    ResetMatrices(intra, inter);
    // MPEG-1 until a sequence extension says otherwise, as FFmpeg resets it.
    mpeg2_ = false;
    progressive_sequence_ = true;
    chroma_format_ = 1;
    low_delay_ = false;
    seen_sequence_ = true;
    ++stats_[kSequenceHeaders];
  }

  void Extension(const uint8_t* p, size_t n) {
    BitReader br(p, n);
    const int id = static_cast<int>(br.get(4));
    switch (id) {
      case 1: {  // sequence extension
        br.skip(8);  // profile and level
        progressive_sequence_ = br.get1();
        chroma_format_ = static_cast<int>(br.get(2));
        if (chroma_format_ == 2 || chroma_format_ == 3)
          throw Unsupported(std::string(chroma_format_ == 2 ? "4:2:2" : "4:4:4") + " chroma (chroma_format " +
                            std::to_string(chroma_format_) + ")");
        chroma_format_ = 1;  // 0 is reserved: FFmpeg takes 4:2:0
        seq_width_ = (seq_width_ & 0xFFF) | static_cast<int>(br.get(2) << 12);
        seq_height_ = (seq_height_ & 0xFFF) | static_cast<int>(br.get(2) << 12);
        br.skip(12 + 1 + 8);  // bit rate extension, marker, VBV buffer extension
        low_delay_ = br.get1();
        mpeg2_ = true;
        if (!progressive_sequence_) ++stats_[kInterlacedSequences];
        if (low_delay_) ++stats_[kLowDelaySequences];
        break;
      }
      case 2: {  // sequence display extension
        br.skip(3);  // video_format
        if (br.get1()) {
          br.skip(16);  // colour_primaries, transfer_characteristics
          matrix_ = static_cast<int>(br.get(8));
        }
        break;
      }
      case 3: {  // quant matrix extension
        if (br.get1()) LoadMatrix(br, chroma_intra_, intra_, true), ++stats_[kIntraMatrices];
        if (br.get1()) LoadMatrix(br, chroma_inter_, inter_, false), ++stats_[kNonIntraMatrices];
        if (br.get1()) LoadMatrix(br, chroma_intra_, nullptr, true), ++stats_[kChromaMatrices];
        if (br.get1()) LoadMatrix(br, chroma_inter_, nullptr, false), ++stats_[kChromaMatrices];
        ++stats_[kQuantMatrixExtensions];
        break;
      }
      case 5: {
        static const char* const kModes[4] = {"data partitioning", "spatial scalability", "SNR scalability",
                                              "temporal scalability"};
        throw Unsupported(std::string("the sequence scalable extension (") + kModes[br.get(2)] + ")");
      }
      case 9: throw Unsupported("the picture spatial scalable extension");
      case 10: throw Unsupported("the picture temporal scalable extension");
      case 8: PictureCodingExtension(br); break;
      default: break;  // copyright, picture display, camera parameters, ITU-T extensions
    }
  }

  void Gop(const uint8_t* p, size_t n) {
    BitReader br(p, n);
    br.skip(25);  // time_code
    closed_gop_ = br.get1();
    ++stats_[kGops];
    if (closed_gop_) ++stats_[kClosedGops];
  }

  void PictureHeader(const uint8_t* p, size_t n) {
    BitReader br(p, n);
    br.skip(10);  // temporal_reference
    const int type = static_cast<int>(br.get(3));
    if (type == 4) throw Unsupported("D pictures (picture_coding_type 4)");
    if (type < 1 || type > 3) throw Corrupt("picture_coding_type " + std::to_string(type));
    br.skip(16);  // vbv_delay
    full_pel_[0] = full_pel_[1] = false;
    for (int dir = 0; dir < 2; ++dir) {
      if (type == kPictP + dir || type == kPictB) {
        full_pel_[dir] = br.get1();
        int code = static_cast<int>(br.get(3));
        code += !code;
        f_code_[dir][0] = f_code_[dir][1] = code;
      }
    }
    pict_type_ = type;
    picture_pending_ = true;
    // MPEG-1 pictures: what a picture coding extension would otherwise set.
    intra_dc_precision_ = 0;
    picture_structure_ = 3;
    frame_pred_frame_dct_ = true;
    concealment_vectors_ = q_scale_type_ = intra_vlc_ = alternate_scan_ = false;
    picture_mpeg2_ = false;
  }

  void PictureCodingExtension(BitReader& br) {
    full_pel_[0] = full_pel_[1] = false;
    for (int dir = 0; dir < 2; ++dir)
      for (int k = 0; k < 2; ++k) {
        const int code = static_cast<int>(br.get(4));
        f_code_[dir][k] = code + !code;
      }
    intra_dc_precision_ = static_cast<int>(br.get(2));
    picture_structure_ = static_cast<int>(br.get(2));
    const bool top_field_first = br.get1();
    frame_pred_frame_dct_ = br.get1();
    concealment_vectors_ = br.get1();
    q_scale_type_ = br.get1();
    intra_vlc_ = br.get1();
    alternate_scan_ = br.get1();
    const bool repeat_first_field = br.get1();
    br.skip(1);  // chroma_420_type
    const bool progressive_frame = br.get1();
    if (picture_structure_ == 0) picture_structure_ = 3;  // reserved: FFmpeg takes a frame picture
    if (picture_structure_ != 3)
      throw Unsupported(std::string("field pictures (picture_structure ") + std::to_string(picture_structure_) +
                        ", a " + (picture_structure_ == 1 ? "top" : "bottom") + " field)");
    picture_mpeg2_ = true;
    pic_flags_ = (top_field_first ? 1 : 0) | (repeat_first_field ? 2 : 0) | (progressive_frame ? 0 : 4);
  }

  // ---- pictures
  // Sets up the picture the first slice belongs to; false where FFmpeg decodes none.
  bool StartPicture() {
    picture_pending_ = false;
    if (!seen_sequence_) {
      ++stats_[kPicturesBeforeSequence];
      return false;
    }
    if (pict_type_ == kPictB && !last_) {
      if (!closed_gop_) {
        ++stats_[kOpenGopBDropped];
        return false;
      }
      throw Unsupported("a B picture with no forward reference picture in a closed GOP");
    }
    if (pict_type_ == kPictP && !next_)
      throw Unsupported("a stream that starts with a P picture (no reference picture before it)");
    if (!sr_yuv::MatrixTable(matrix_))
      throw Unsupported("matrix_coefficients " + std::to_string(matrix_) +
                        " (BT.601, BT.709, FCC and SMPTE 240M are converted)");
    const int mb_w = (seq_width_ + 15) / 16;
    const int mb_h = mpeg2_ && !progressive_sequence_ ? (seq_height_ + 31) / 32 * 2 : (seq_height_ + 15) / 16;
    if (!mb_w || !mb_h) throw Corrupt("a sequence header of size 0");
    if (width_ && (seq_width_ != width_ || seq_height_ != height_ || mb_h != mb_h_))
      throw Unsupported("a picture size that changes mid-stream (" + std::to_string(width_) + "x" +
                        std::to_string(height_) + " then " + std::to_string(seq_width_) + "x" +
                        std::to_string(seq_height_) + ")");
    if (!width_) {
      width_ = seq_width_, height_ = seq_height_, mb_w_ = mb_w, mb_h_ = mb_h;
      colour_ = sr_yuv::SimdCoefficients(sr_yuv::MatrixTable(matrix_), false);
      chroma_left_ = mpeg2_;
    }
    if (height_ % 2 && sr_yuv::MatrixTable(matrix_) != sr_yuv::MatrixTable(2))
      throw Unsupported("matrix_coefficients " + std::to_string(matrix_) + " at an odd height (" +
                        std::to_string(height_) + "; BT.601 is converted there)");
    colour_ = sr_yuv::SimdCoefficients(sr_yuv::MatrixTable(matrix_), false);
    cur_ = std::make_shared<Picture>();
    cur_->width = 16 * mb_w_, cur_->height = 16 * mb_h_;
    const size_t luma = static_cast<size_t>(cur_->width) * cur_->height;
    cur_->y.assign(luma, 0);
    cur_->u.assign(luma / 4, 0);
    cur_->v.assign(luma / 4, 0);
    cur_->unit = unit_;
    if (pict_type_ != kPictB) {
      last_ = next_;
      next_ = cur_;
    }
    coded_.assign(static_cast<size_t>(mb_w_) * mb_h_, 0);
    prev_intra_.assign(coded_.size(), 0);
    ++stats_[pict_type_ == kPictI ? kIPictures : pict_type_ == kPictP ? kPPictures : kBPictures];
    ++stats_[picture_mpeg2_ ? kMpeg2Pictures : kMpeg1Pictures];
    if (picture_mpeg2_) {
      if (intra_vlc_) ++stats_[kIntraVlcPictures];
      if (alternate_scan_) ++stats_[kAlternateScanPictures];
      if (q_scale_type_) ++stats_[kNonLinearQuantPictures];
      ++stats_[kDcPrecision8 + intra_dc_precision_];
      if (pic_flags_ & 1) ++stats_[kTopFieldFirst];
      if (pic_flags_ & 2) ++stats_[kRepeatFirstField];
      if (pic_flags_ & 4) ++stats_[kInterlacedFrames];
    }
    return true;
  }

  void FinishPicture() {
    std::shared_ptr<Picture> pic = std::move(cur_);
    cur_.reset();
    for (size_t i = 0; i < coded_.size(); ++i)
      if (!coded_[i]) {
        char msg[96];
        std::snprintf(msg, sizeof msg, "macroblock (%d, %d) of a picture lies in no slice",
                      static_cast<int>(i % mb_w_), static_cast<int>(i / mb_w_));
        throw Corrupt(msg);
      }
    if (pict_type_ == kPictB || low_delay_) {
      out_.push_back(pic);
    } else if (last_) {
      out_.push_back(last_);
      ++stats_[kReorderedPictures];
    }
  }

  // ---- slices
  int Qscale(BitReader& br) const {
    const int code = static_cast<int>(br.get(5));
    return q_scale_type_ ? kNonLinearQuantiserScale[code] : code << 1;
  }

  void ResetPredictors() {
    last_dc_[0] = last_dc_[1] = last_dc_[2] = 1 << (7 + intra_dc_precision_);
    std::memset(last_mv_, 0, sizeof last_mv_);
  }

  [[noreturn]] void Fail(const char* what) const {
    char msg[160];
    std::snprintf(msg, sizeof msg, "%s at macroblock (%d, %d) of a%s picture", what, mb_x_, mb_y_,
                  pict_type_ == kPictI ? "n I" : pict_type_ == kPictP ? " P" : " B");
    throw Corrupt(msg);
  }

  void Slice(int code, const uint8_t* p, size_t n) {
    if (!cur_) {
      if (skipping_) return;  // a picture FFmpeg does not decode
      if (!picture_pending_) throw Corrupt("a slice without a picture header");
      if (!StartPicture()) {
        skipping_ = true;
        return;
      }
    }
    ++stats_[kSlices];
    BitReader br(p, n);
    mb_y_ = code - 1;
    if (mpeg2_ && mb_h_ > 175) mb_y_ += static_cast<int>(br.get(3)) << 7;
    mb_x_ = 0;
    if (mb_y_ >= mb_h_) Fail("a slice below the picture");
    ResetPredictors();
    interlaced_dct_ = false;
    qscale_ = Qscale(br);
    if (!qscale_) Fail("quantiser_scale_code 0");
    while (br.get1()) br.skip(8);  // intra_slice_flag and the extra information bytes
    for (;;) {
      const int c = increment_vlc().decode(br);
      if (c < 0 || c == 35) Fail("an invalid first macroblock_address_increment");
      if (c == 33) {
        mb_x_ += 33;
      } else if (c != 34) {
        mb_x_ += c;
        break;
      }
    }
    if (mb_x_ >= mb_w_) Fail("a first macroblock address past the row");
    int skip_run = 0;
    for (;;) {
      if (skip_run-- != 0) {
        SkippedMacroblock();
      } else {
        Macroblock(br);
      }
      uint8_t& coded = coded_[static_cast<size_t>(mb_y_) * mb_w_ + mb_x_];
      if (coded) Fail("a macroblock coded twice");
      coded = 1;
      if (++mb_x_ >= mb_w_) {
        mb_x_ = 0;
        if (++mb_y_ >= mb_h_) {
          const int64_t left = br.left();
          if (left < 0 || (left && br.peek(static_cast<int>(std::min<int64_t>(left, 23))))) {
            --mb_y_;
            Fail("data after the last macroblock of the picture");
          }
          return;
        }
      }
      if (skip_run == -1) {
        skip_run = 0;
        for (;;) {
          const int c = increment_vlc().decode(br);
          if (c < 0) Fail("an invalid macroblock_address_increment");
          if (c == 33) {
            skip_run += 33;
          } else if (c == 35) {
            if (skip_run || br.peek(15)) Fail("a slice that ends inside a run of skipped macroblocks");
            return;  // the next start code
          } else if (c != 34) {
            skip_run += c;
            break;
          }
        }
        if (skip_run) StartSkipRun();
      }
      if (br.left() < 0) Fail("a slice that runs past its data");
    }
  }

  // What a run of skipped macroblocks predicts with, as FFmpeg sets it when it reads the run's increment.
  void StartSkipRun() {
    if (pict_type_ == kPictI) Fail("a skipped macroblock in an I picture");
    last_dc_[0] = last_dc_[1] = last_dc_[2] = 128 << intra_dc_precision_;
    field_mv_ = false;
    if (pict_type_ == kPictP) {
      mv_dir_ = kDirForward;
      std::memset(mv_, 0, sizeof mv_);
      std::memset(last_mv_[0], 0, sizeof last_mv_[0]);
    } else {
      for (int dir = 0; dir < 2; ++dir) {
        mv_[dir][0][0] = last_mv_[dir][0][0];
        mv_[dir][0][1] = last_mv_[dir][0][1];
      }
    }
  }

  void SkippedMacroblock() {
    ++stats_[kSkippedMbs];
    const size_t index = static_cast<size_t>(mb_y_) * mb_w_ + mb_x_;
    if (pict_type_ == kPictB) {
      // FFmpeg takes the type of the macroblock to the left (the end of the row above for the first of a row).
      const size_t left = mb_x_ ? index - 1 : static_cast<size_t>(mb_y_ - 1) * mb_w_ + mb_w_ - 1;
      if (mb_y_ == 0 && mb_x_ == 0) Fail("a skipped macroblock first in the picture");
      if (prev_intra_[left]) Fail("a skipped macroblock after an intra macroblock in a B picture");
    }
    prev_intra_[index] = 0;
    for (int i = 0; i < 6; ++i) coded_blocks_[i] = false;
    Predict();
  }

  // ---- macroblocks
  void Macroblock(BitReader& br) {
    const int t = mb_type_vlc(pict_type_).decode(br);
    if (t < 0) Fail("an invalid macroblock_type");
    const int flags = pict_type_ == kPictI ? kMbFlagsI[t] : pict_type_ == kPictP ? kMbFlagsP[t] : kMbFlagsB[t];
    const size_t index = static_cast<size_t>(mb_y_) * mb_w_ + mb_x_;
    std::memset(blocks_, 0, sizeof blocks_);
    if (flags & kMbQuant) ++stats_[kQuantMbs];
    if (flags & kMbIntra) {
      ++stats_[kIntraMbs];
      prev_intra_[index] = 1;
      if (!frame_pred_frame_dct_) interlaced_dct_ = br.get1();
      if (flags & kMbQuant) qscale_ = Qscale(br);
      if (concealment_vectors_) {
        ++stats_[kConcealmentVectors];
        for (int k = 0; k < 2; ++k) {
          const int v = MotionDelta(br, f_code_[0][k], last_mv_[0][0][k]);
          mv_[0][0][k] = last_mv_[0][0][k] = last_mv_[0][1][k] = v;
        }
        br.skip(1);  // marker
      } else {
        std::memset(last_mv_, 0, sizeof last_mv_);
      }
      if (interlaced_dct_) ++stats_[kFieldDctMbs];
      for (int i = 0; i < 6; ++i) {
        if (mpeg2_) {
          IntraBlock2(br, i);
        } else {
          IntraBlock1(br, i);
        }
      }
      for (int i = 0; i < 6; ++i) PutBlock(i, false);
      return;
    }
    prev_intra_[index] = 0;
    if (!(flags & (kMbForward | kMbBackward))) {  // P, "No MC": a zero vector
      ++stats_[kNoMcMbs];
      mv_dir_ = kDirForward;
      field_mv_ = false;
      if (!frame_pred_frame_dct_) interlaced_dct_ = br.get1();
      if (flags & kMbQuant) qscale_ = Qscale(br);
      std::memset(last_mv_[0], 0, sizeof last_mv_[0]);
      mv_[0][0][0] = mv_[0][0][1] = 0;
    } else {
      int motion_type = 2;  // frame
      if (!frame_pred_frame_dct_) {
        motion_type = static_cast<int>(br.get(2));
        if (flags & kMbPattern) interlaced_dct_ = br.get1();
      }
      if (flags & kMbQuant) qscale_ = Qscale(br);
      mv_dir_ = ((flags & kMbForward) ? kDirForward : 0) | ((flags & kMbBackward) ? kDirBackward : 0);
      ++stats_[mv_dir_ == 3 ? kBidirectionalMbs : mv_dir_ == kDirForward ? kForwardMbs : kBackwardMbs];
      if (motion_type == 0) Fail("frame_motion_type 0");
      if (motion_type == 3) throw Unsupported("dual prime motion (frame_motion_type 3)");
      field_mv_ = motion_type == 1;
      if (field_mv_) ++stats_[kFieldPredictionMbs];
      for (int dir = 0; dir < 2; ++dir) {
        if (!(mv_dir_ & (1 << dir))) continue;
        if (!field_mv_) {
          for (int k = 0; k < 2; ++k) {
            const int v = MotionDelta(br, f_code_[dir][k], last_mv_[dir][0][k]);
            mv_[dir][0][k] = last_mv_[dir][0][k] = last_mv_[dir][1][k] = v;
          }
          if (full_pel_[dir]) {
            mv_[dir][0][0] *= 2;
            mv_[dir][0][1] *= 2;
            ++stats_[kFullPelVectors];
          }
        } else {
          for (int j = 0; j < 2; ++j) {
            field_select_[dir][j] = br.get1();
            int v = MotionDelta(br, f_code_[dir][0], last_mv_[dir][j][0]);
            last_mv_[dir][j][0] = mv_[dir][j][0] = v;
            v = MotionDelta(br, f_code_[dir][1], last_mv_[dir][j][1] >> 1);
            last_mv_[dir][j][1] = 2 * v;
            mv_[dir][j][1] = v;
          }
        }
      }
    }
    last_dc_[0] = last_dc_[1] = last_dc_[2] = 128 << intra_dc_precision_;
    int cbp = 0;
    if (flags & kMbPattern) {
      cbp = cbp_vlc().decode(br);
      if (cbp <= 0) Fail(cbp < 0 ? "an invalid coded_block_pattern" : "coded_block_pattern 0");
      if (interlaced_dct_) ++stats_[kFieldDctMbs];
    }
    for (int i = 0; i < 6; ++i) {
      coded_blocks_[i] = (cbp >> (5 - i)) & 1;
      if (coded_blocks_[i]) {
        if (mpeg2_) {
          InterBlock2(br, i);
        } else {
          InterBlock1(br, i);
        }
      }
    }
    Predict();
  }

  int MotionDelta(BitReader& br, int f_code, int pred) {
    const int code = motion_vlc().decode(br);
    if (code < 0) Fail("an invalid motion_code");
    if (code == 0) return pred;
    const int sign = br.get1();
    const int shift = f_code - 1;
    int v = code;
    if (shift) v = (((v - 1) << shift) | static_cast<int>(br.get(shift))) + 1;
    if (sign) v = -v;
    return sign_extend(v + pred, 5 + shift);
  }

  int DcDifferential(BitReader& br, int component) {
    const int size = dc_vlc(component).decode(br);
    if (size < 0) Fail("an invalid dct_dc_size");
    return size ? br.get_xbits(size) : 0;
  }

  const uint8_t* Scan() const { return alternate_scan_ ? kAlternate : kZigzag; }

  // One (run, level) pair of table `table`; false at the end of the block. Escapes give their raw level.
  bool RunLevel(BitReader& br, int table, bool mpeg1_escape, int* run, int* level, bool* escaped) {
    const int s = dct_vlc(table).decode(br);
    if (s < 0) Fail("an invalid DCT coefficient code");
    if (s == kEndOfBlock) return false;
    if (s == kEscape) {
      ++stats_[kEscapes];
      *escaped = true;
      *run = static_cast<int>(br.get(6));
      if (mpeg1_escape) {
        int v = br.get_signed(8);
        if (v == -128) {
          v = static_cast<int>(br.get(8)) - 256;
        } else if (v == 0) {
          v = static_cast<int>(br.get(8));
        }
        *level = v;
      } else {
        *level = br.get_signed(12);
      }
      return true;
    }
    *escaped = false;
    *run = kDctRun[s];
    *level = br.get1() ? -kDctLevel[s] : kDctLevel[s];
    return true;
  }

  void IntraDc(BitReader& br, int n, int16_t* block, int scale) {
    const int component = n < 4 ? 0 : n - 3;
    last_dc_[component] += DcDifferential(br, component);
    block[0] = static_cast<int16_t>(last_dc_[component] * scale);
  }

  // mpeg2_decode_block_intra: B-14 or B-15, MPEG-2 escapes, no saturation, mismatch control.
  void IntraBlock2(BitReader& br, int n) {
    int16_t* block = blocks_[n];
    const uint16_t* matrix = n < 4 ? intra_ : chroma_intra_;
    IntraDc(br, n, block, 1 << (3 - intra_dc_precision_));
    int mismatch = block[0] ^ 1;
    const uint8_t* scan = Scan();
    int i = 0, run, level;
    bool escaped;
    while (RunLevel(br, intra_vlc_ ? 1 : 0, false, &run, &level, &escaped)) {
      i += run + 1;
      if (i > 63) Fail("a DCT coefficient past the 64th");
      const int j = scan[i];
      const int v = (std::abs(level) * qscale_ * matrix[j]) >> 4;
      level = level < 0 ? -v : v;
      mismatch ^= level;
      block[j] = static_cast<int16_t>(level);
    }
    block[63] = static_cast<int16_t>(block[63] ^ (mismatch & 1));
  }

  // ff_mpeg1_decode_block_intra: B-14, MPEG-1 escapes, oddification.
  void IntraBlock1(BitReader& br, int n) {
    int16_t* block = blocks_[n];
    IntraDc(br, n, block, intra_[0]);
    int i = 0, run, level;
    bool escaped;
    while (RunLevel(br, 0, true, &run, &level, &escaped)) {
      i += run + 1;
      if (i > 63) Fail("a DCT coefficient past the 64th");
      const int j = kZigzag[i];
      const int v = (((std::abs(level) * qscale_ * intra_[j]) >> 4) - 1) | 1;
      block[j] = static_cast<int16_t>(level < 0 ? -v : v);
    }
  }

  // The first coefficient of a non-intra block: "1s" is (0, +-1), else the table's code.
  bool FirstInter(BitReader& br, bool mpeg1_escape, int* run, int* level, bool* escaped) {
    if (br.peek(1)) {
      br.skip(1);
      *run = 0;
      *level = br.get1() ? -1 : 1;
      *escaped = false;
      return true;
    }
    return RunLevel(br, 0, mpeg1_escape, run, level, escaped);
  }

  // mpeg2_decode_block_non_intra.
  void InterBlock2(BitReader& br, int n) {
    int16_t* block = blocks_[n];
    const uint16_t* matrix = n < 4 ? inter_ : chroma_inter_;
    const uint8_t* scan = Scan();
    int mismatch = 1, i = -1, run, level;
    bool escaped;
    bool more = FirstInter(br, false, &run, &level, &escaped);
    while (more) {
      i += run + 1;
      if (i > 63) Fail("a DCT coefficient past the 64th");
      const int j = scan[i];
      const int v = ((std::abs(level) * 2 + 1) * qscale_ * matrix[j]) >> 5;
      level = level < 0 ? -v : v;
      mismatch ^= level;
      block[j] = static_cast<int16_t>(level);
      more = RunLevel(br, 0, false, &run, &level, &escaped);
    }
    block[63] = static_cast<int16_t>(block[63] ^ (mismatch & 1));
  }

  // mpeg1_decode_block_inter.
  void InterBlock1(BitReader& br, int n) {
    int16_t* block = blocks_[n];
    int i = -1, run, level;
    bool escaped;
    bool more = FirstInter(br, true, &run, &level, &escaped);
    while (more) {
      i += run + 1;
      if (i > 63) Fail("a DCT coefficient past the 64th");
      const int j = kZigzag[i];
      const int v = ((((std::abs(level) * 2 + 1) * qscale_ * inter_[j]) >> 5) - 1) | 1;
      block[j] = static_cast<int16_t>(level < 0 ? -v : v);
      more = RunLevel(br, 0, true, &run, &level, &escaped);
    }
  }

  // ---- reconstruction
  uint8_t* BlockDest(int n, int* stride) {
    const int ls = cur_->width, cs = ls / 2;
    if (n >= 4) {
      *stride = cs;
      return cur_->Plane(n - 3) + static_cast<size_t>(mb_y_) * 8 * cs + mb_x_ * 8;
    }
    uint8_t* y = cur_->y.data() + static_cast<size_t>(mb_y_) * 16 * ls + mb_x_ * 16 + (n & 1) * 8;
    *stride = interlaced_dct_ ? 2 * ls : ls;
    return y + (n >> 1) * (interlaced_dct_ ? ls : 8 * ls);
  }

  void PutBlock(int n, bool add) {
    int stride;
    uint8_t* dst = BlockDest(n, &stride);
    sr_idct::simple_idct(blocks_[n]);
    sr_idct::write_block(blocks_[n], dst, stride, add);
  }

  void Predict() {
    bool first = true;
    for (int dir = 0; dir < 2; ++dir) {
      if (!(mv_dir_ & (1 << dir))) continue;
      const Picture& ref = dir == 0 ? *last_ : *next_;
      if (!field_mv_) {
        Motion(ref, mv_[dir][0][0], mv_[dir][0][1], false, 0, 0, !first);
      } else {
        for (int j = 0; j < 2; ++j) Motion(ref, mv_[dir][j][0], mv_[dir][j][1], true, j, field_select_[dir][j], !first);
      }
      first = false;
    }
    for (int i = 0; i < 6; ++i)
      if (coded_blocks_[i]) PutBlock(i, true);
  }

  // mpeg_motion_internal: the 16 x h luma and 8 x h/2 chroma prediction of one frame (field = false) or of one
  // field (`bottom`) of the macroblock from field `select` of ref, put or averaged into the picture.
  void Motion(const Picture& ref, int mx, int my, bool field, int bottom, int select, bool avg) {
    const int h = field ? 8 : 16, f = field ? 1 : 0;
    const int ls = ref.width, cs = ls / 2, v_edge = (16 * mb_h_) >> f, h_edge = 16 * mb_w_;
    const int dxy = ((my & 1) << 1) | (mx & 1);
    const int src_x = mb_x_ * 16 + (mx >> 1), src_y = (mb_y_ << (4 - f)) + (my >> 1);
    if (static_cast<unsigned>(src_x) >= static_cast<unsigned>(std::max(h_edge - (mx & 1) - 15, 0)) ||
        static_cast<unsigned>(src_y) >= static_cast<unsigned>(std::max(v_edge - (my & 1) - h + 1, 0)))
      Fail("a motion vector out of the picture");
    const int cmx = mx / 2, cmy = my / 2;  // towards zero
    const int uvdxy = ((cmy & 1) << 1) | (cmx & 1);
    const int uv_x = mb_x_ * 8 + (cmx >> 1), uv_y = (mb_y_ << (3 - f)) + (cmy >> 1);
    for (int c = 0; c < 3; ++c) {
      const int stride = c ? cs : ls, rows = (c ? ref.height / 2 : ref.height) >> f;
      const sr_idct::Plane plane{const_cast<uint8_t*>(ref.Plane(c)) + select * stride, stride, rows, stride << f};
      uint8_t* dst = cur_->Plane(c) + static_cast<size_t>(c ? mb_y_ * 8 : mb_y_ * 16) * stride + bottom * stride +
                     (c ? mb_x_ * 8 : mb_x_ * 16);
      const int w = c ? 8 : 16, bh = c ? h / 2 : h;
      const int x = c ? uv_x : src_x, y = c ? uv_y : src_y, d = c ? uvdxy : dxy;
      if (!avg) {
        sr_idct::predict(plane, x, y, d, false, w, bh, dst, stride << f, plane.width, plane.height);
      } else {
        uint8_t pred[16 * 16];
        sr_idct::predict(plane, x, y, d, false, w, bh, pred, 16, plane.width, plane.height);
        sr_idct::average(dst, stride << f, pred, 16, w, bh);
      }
    }
  }

  // ---- state
  int64_t stats_[kNumStats] = {};
  int unit_ = 0;
  std::vector<std::shared_ptr<Picture>> out_;
  std::shared_ptr<Picture> cur_, last_, next_;  // FFmpeg's cur_pic, last_pic (forward), next_pic (backward)
  // sequence
  bool seen_sequence_ = false, mpeg2_ = false, progressive_sequence_ = true, low_delay_ = false;
  int chroma_format_ = 1, matrix_ = 2, seq_width_ = 0, seq_height_ = 0;
  uint16_t intra_[64], inter_[64], chroma_intra_[64], chroma_inter_[64];
  bool closed_gop_ = false;
  // the decoded size
  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  sr_yuv::Coefficients colour_{};
  bool chroma_left_ = false;
  // picture
  bool picture_pending_ = false, skipping_ = false, picture_mpeg2_ = false;
  int pict_type_ = kPictI, pic_flags_ = 0;
  int f_code_[2][2] = {{1, 1}, {1, 1}};
  bool full_pel_[2] = {false, false};
  int intra_dc_precision_ = 0, picture_structure_ = 3;
  bool frame_pred_frame_dct_ = true, concealment_vectors_ = false, q_scale_type_ = false, intra_vlc_ = false,
       alternate_scan_ = false;
  std::vector<uint8_t> coded_, prev_intra_;
  // macroblock
  int mb_x_ = 0, mb_y_ = 0, qscale_ = 2;
  int last_dc_[3] = {128, 128, 128};
  int last_mv_[2][2][2] = {}, mv_[2][2][2] = {};  // [direction][field or frame][x, y]
  int field_select_[2][2] = {};
  int mv_dir_ = kDirForward;
  bool field_mv_ = false, interlaced_dct_ = false;
  bool coded_blocks_[6] = {};
  int16_t blocks_[6][64];
};

void CopyMessage(const char* msg, char* err, int err_len) {
  if (err && err_len > 0) {
    std::strncpy(err, msg, err_len - 1);
    err[err_len - 1] = '\0';
  }
}

}  // namespace sr_mpeg2

extern "C" {

void* sr_mpeg2_stream_new(const uint8_t* config, int64_t size, char* err, int err_len) {
  try {
    return new sr_mpeg2::Decoder(config, size > 0 ? static_cast<size_t>(size) : 0);
  } catch (const sr_mpeg2::Unsupported& e) {
    sr_mpeg2::CopyMessage((std::string("!") + e.what()).c_str(), err, err_len);
  } catch (const std::exception& e) {
    sr_mpeg2::CopyMessage(e.what(), err, err_len);
  }
  return nullptr;
}

void sr_mpeg2_stream_free(void* handle) { delete static_cast<sr_mpeg2::Decoder*>(handle); }

int sr_mpeg2_stream_decode(void* handle, const uint8_t* data, int64_t size, char* err, int err_len) {
  try {
    return static_cast<sr_mpeg2::Decoder*>(handle)->Decode(data, size > 0 ? static_cast<size_t>(size) : 0);
  } catch (const sr_mpeg2::Unsupported& e) {
    sr_mpeg2::CopyMessage(e.what(), err, err_len);
    return -2;
  } catch (const std::exception& e) {
    sr_mpeg2::CopyMessage(e.what(), err, err_len);
    return -1;
  }
}

int sr_mpeg2_stream_flush(void* handle, char* err, int err_len) {
  try {
    return static_cast<sr_mpeg2::Decoder*>(handle)->Flush();
  } catch (const std::exception& e) {
    sr_mpeg2::CopyMessage(e.what(), err, err_len);
    return -1;
  }
}

int sr_mpeg2_stream_unit(void* handle, int index) {
  return static_cast<const sr_mpeg2::Decoder*>(handle)->output(index).unit;
}

void sr_mpeg2_stream_size(void* handle, int32_t* width_height) {
  const auto* dec = static_cast<const sr_mpeg2::Decoder*>(handle);
  width_height[0] = dec->width();
  width_height[1] = dec->height();
}

void sr_mpeg2_stream_bgr(void* handle, int index, uint8_t* out) {
  static_cast<const sr_mpeg2::Decoder*>(handle)->Bgr(index, out);
}

void sr_mpeg2_stream_plane(void* handle, int index, int plane, uint8_t* out) {
  const auto* dec = static_cast<const sr_mpeg2::Decoder*>(handle);
  const sr_mpeg2::Picture& pic = dec->output(index);
  const int w = plane ? (dec->width() + 1) / 2 : dec->width(), h = plane ? (dec->height() + 1) / 2 : dec->height();
  const int stride = pic.Stride(plane);
  const uint8_t* src = pic.Plane(plane);
  for (int y = 0; y < h; ++y) std::memcpy(out + static_cast<size_t>(y) * w, src + static_cast<size_t>(y) * stride, w);
}

int sr_mpeg2_stream_stats(void* handle, int64_t* out, int n) {
  const int64_t* stats = static_cast<const sr_mpeg2::Decoder*>(handle)->stats();
  for (int i = 0; i < n && i < sr_mpeg2::kNumStats; ++i) out[i] = stats[i];
  return sr_mpeg2::kNumStats;
}

}  // extern "C"
