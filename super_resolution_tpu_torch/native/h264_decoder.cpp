// H.264 video (progressive 8-bit 4:2:0, I, P and B slices, CAVLC and CABAC)
// for super_resolution_tpu_torch.utils.h264, bound with ctypes: a stateful
// decoder behind a handle, fed whole access units a call, as
// cv2.VideoCapture's FFmpeg decodes them.
//
// Written from ITU-T Rec. H.264 (08/2021): NAL units from Annex B byte
// streams or length-prefixed (an avcC record's lengthSizeMinusOne 0, 1 or 3),
// emulation prevention removed; sequence and picture parameter sets with the
// VUI (its bitstream restriction read), scaling matrices (fall-back rules A
// and B, the default lists) and the second chroma QP offset; slice headers
// with reference list modification of both lists, explicit weighted
// prediction of both lists and the decoded reference picture marking
// (sliding window, MMCO 1-6, long-term references); macroblocks of every I, P
// and B type under CAVLC and under CABAC (every cabac_init_idc, I_PCM); the
// 4x4 and 8x8 inverse transforms with the luma and chroma DC transforms and
// the dequantisation by the scaling matrices; intra 4x4, 8x8 (with its
// reference sample filtering), 16x16 and chroma prediction under slice and
// constrained-intra availability; motion-vector prediction; spatial and
// temporal direct prediction under either direct_8x8_inference_flag (the
// co-located picture's references found by frame_num, as FFmpeg finds them);
// luma 6-tap and chroma bilinear interpolation with reference samples clamped
// to the picture; bi-prediction, default, implicit and explicit, weighted as
// FFmpeg's x86 code weighs where a row holds 4 samples or more (a weight of
// 128 halved, sums saturated to 16 bits: see BiWeight); the deblocking filter
// (with FFmpeg's bS shortcut, see Deblock).
// Reconstruction is exactly specified, so the frames are FFmpeg's wherever
// the stream conforms, but for a 4x4 scaling list whose first weight is above
// 28, which FFmpeg's x86 DC dequantisation can round apart from the standard.
// Pictures are output in the order and number FFmpeg's h264_select_output_frame
// gives: with the VUI's bitstream_restriction_flag, delayed by
// max_num_reorder_frames and each the lowest picture order count held back up
// to a key frame or an MMCO 5 picture (sr_h264_stream_flush drains the rest at
// the end of the stream); without it, in decoding order, which is FFmpeg's
// order wherever its picture order count (which goes on across an MMCO 5)
// increases; a stream without the restriction where it does not is refused.
// The cropped frame is converted to BGR24 with swscale's arithmetic
// (swscale_bgr.h) for the VUI's colour matrix and range, as cv2.VideoCapture
// converts it.
//
// Refused by name (sr_h264_stream_decode returns -2): SP / SI slices,
// interlaced coding, another chroma format than 4:2:0, more than 8 bits,
// lossless bypass, slice groups, arbitrary slice order, redundant pictures,
// data partitioning, gaps in frame_num, a size that changes mid-stream, a
// left crop, a colour matrix other than BT.601, BT.709, FCC and SMPTE 240M,
// no_output_of_prior_pics_flag, a stream that starts without an IDR picture
// and a picture order count that does not increase in a stream without the
// VUI's bitstream_restriction_flag. Damaged data raises (returns -1) with what
// was wrong.
//
// C interface:
//   void* sr_h264_stream_new(const uint8_t* config, int64_t size, char* err, int err_len)
//     a decoder (null with err set when the avcC record is refused or damaged;
//     size 0: Annex B); sr_h264_stream_free(h) ends it
//   int sr_h264_stream_decode(void* h, const uint8_t* data, int64_t size, char* err, int err_len)
//     decodes whole access units, one or more; returns the number of frames
//     output, -1: corrupt data, -2: a refused feature (err names it)
//   int sr_h264_stream_flush(void* h, char* err, int err_len)
//     the end of the stream: outputs the pictures still held back; returns their number
//   void sr_h264_stream_size(void* h, int32_t* width_height)   the cropped frame size
//   void sr_h264_stream_bgr(void* h, int index, uint8_t* out)  output frame `index`, height x width x 3
//   void sr_h264_stream_plane(void* h, int index, int plane, uint8_t* out)
//     plane 0 / 1 / 2 (Y, U, V) of output frame `index`, cropped, its rows packed
//   int sr_h264_stream_unit(void* h, int index)
//     which call to sr_h264_stream_decode (0, 1, ...) carried output frame `index`'s picture
//   int sr_h264_stream_stats(void* h, int64_t* out, int n)
//     the first n of the Stat counts; returns how many there are
//
// Build: g++ -O3 -shared -fPIC -std=c++17 h264_decoder.cpp -o <lib>.so
// (native/__init__.py does this at first use, into
// super_resolution_tpu_torch/_build/).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "h264_cabac_tables.h"
#include "h264_tables.h"
#include "swscale_bgr.h"

namespace sr_h264 {

struct Unsupported : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// The counts a stream's decode keeps (utils/h264.py names them in this order).
enum Stat {
  kPictures, kIdrPictures, kNonRefPictures, kSlices, kISlices, kPSlices, kMultiSlicePictures,
  kINxN, kI16x16, kIPcm, kP16x16, kP16x8, kP8x16, kP8x8, kP8x8Ref0, kPSkip, kIntraInP,
  kSub8x8, kSub8x4, kSub4x8, kSub4x4,
  kI4Mode0, kI4Mode1, kI4Mode2, kI4Mode3, kI4Mode4, kI4Mode5, kI4Mode6, kI4Mode7, kI4Mode8,
  kI16Mode0, kI16Mode1, kI16Mode2, kI16Mode3,
  kChromaMode0, kChromaMode1, kChromaMode2, kChromaMode3,
  kSkipRuns, kSkipMvNonzero, kRefIdxNonzero, kFarMv,
  kWeightedSlices, kListModifications, kMmco1, kMmco2, kMmco3, kMmco4, kMmco5, kMmco6, kLongTermRefs,
  kSlidingWindowRemovals, kDeblockIdc0, kDeblockIdc1, kDeblockIdc2, kDeblockOffsets, kConstrainedIntraSlices,
  kPocType0, kPocType1, kPocType2, kLevelPrefix14, kLevelPrefix15, kQpWraps, kCroppedPictures,
  kCabacSlices, kCabacInitIdc0, kCabacInitIdc1, kCabacInitIdc2, kCabacPcm, kCabacLevelEscapes, kCabacMvdEscapes,
  kI8x8, kTransform8x8Inter,
  kI8Mode0, kI8Mode1, kI8Mode2, kI8Mode3, kI8Mode4, kI8Mode5, kI8Mode6, kI8Mode7, kI8Mode8,
  kSpsScalingMatrices, kPpsScalingMatrices, kScalingListsExplicit, kScalingListsDefault, kScalingListsFallbackA,
  kScalingListsFallbackB, kSecondChromaQpOffsets, kTransform8x8Pps,
  kBSlices, kBSkip, kBDirect16x16, kB16x16, kB16x8, kB8x16, kB8x8, kBSubDirect, kBSub8x8, kBSub8x4, kBSub4x8,
  kBSub4x4, kIntraInB, kSpatialDirectMbs, kTemporalDirectMbs, kBiPartitions, kImplicitBipredSlices,
  kExplicitBipredSlices, kList1Modifications, kReferenceBPictures, kReorderedPictures,
  kNumStats
};

inline int Clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline uint8_t Clip1(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int Median(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }

// ---------------------------------------------------------------------------------------------
// NAL units and the RBSP bit reader

std::vector<uint8_t> Unescape(const uint8_t* data, size_t size) {
  std::vector<uint8_t> out;
  out.reserve(size);
  int zeros = 0;
  for (size_t i = 0; i < size; ++i) {
    const uint8_t b = data[i];
    if (zeros >= 2 && b == 3) {
      zeros = 0;
      continue;  // emulation_prevention_three_byte
    }
    out.push_back(b);
    zeros = b == 0 ? zeros + 1 : 0;
  }
  return out;
}

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size) : data_(data), size_(size) {
    // The rbsp_stop_one_bit: the last set bit of the payload.
    end_ = size * 8;
    while (end_ > 0 && !((data_[(end_ - 1) >> 3] >> (7 - ((end_ - 1) & 7))) & 1)) --end_;
    if (end_ > 0) --end_;
  }
  int Bit() {
    if (pos_ >= size_ * 8) throw Corrupt("truncated NAL unit");
    const int bit = (data_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1;
    ++pos_;
    return bit;
  }
  uint32_t Bits(int n) {
    uint32_t v = 0;
    while (n--) v = (v << 1) | Bit();
    return v;
  }
  uint32_t Ue() {
    int zeros = 0;
    while (!Bit()) {
      if (++zeros > 31) throw Corrupt("Exp-Golomb code longer than 32 bits");
    }
    return zeros ? ((1u << zeros) - 1 + Bits(zeros)) : 0;
  }
  int Se() {
    const uint32_t k = Ue();
    return (k & 1) ? static_cast<int>((k + 1) / 2) : -static_cast<int>(k / 2);
  }
  int Peek(int n) const {  // the next n bits, zeros past the end
    int v = 0;
    for (int i = 0; i < n; ++i) {
      const size_t p = pos_ + i;
      v = (v << 1) | (p < size_ * 8 ? (data_[p >> 3] >> (7 - (p & 7))) & 1 : 0);
    }
    return v;
  }
  void Skip(int n) {
    if (pos_ + n > size_ * 8) throw Corrupt("truncated slice data");
    pos_ += n;
  }
  int BitOrZero() {  // CABAC's reads: past the end, zeros (the engine never needs them in a conforming slice)
    const int bit = pos_ < size_ * 8 ? (data_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1 : 0;
    ++pos_;
    return bit;
  }
  bool MoreRbspData() const { return pos_ < end_; }
  bool Aligned() const { return (pos_ & 7) == 0; }
  size_t Pos() const { return pos_; }
  const uint8_t* Data() const { return data_; }
  size_t Size() const { return size_; }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0, end_ = 0;
};

// ---------------------------------------------------------------------------------------------
// Parameter sets

// The scaling matrices: weightScale4x4 of the six 4x4 lists (Intra Y, Cb, Cr, Inter Y, Cb, Cr) and
// weightScale8x8 of the two 8x8 lists (Intra Y, Inter Y), in raster order; all 16 where none is sent.
struct ScalingLists {
  uint8_t l4[6][16];
  uint8_t l8[2][64];
  ScalingLists() {
    std::memset(l4, 16, sizeof(l4));
    std::memset(l8, 16, sizeof(l8));
  }
};

struct Sps {
  bool valid = false;
  std::string unsupported;  // a feature this decoder refuses, named
  int chroma_format = 1;
  bool scaling_present = false;
  ScalingLists lists;
  int log2_max_frame_num = 4, poc_type = 0, log2_max_poc_lsb = 4;
  bool delta_pic_order_always_zero = false;
  int offset_for_non_ref_pic = 0, offset_for_top_to_bottom = 0;
  std::vector<int> offset_for_ref_frame;
  int max_num_ref_frames = 0;
  int mb_width = 0, mb_height = 0;
  bool direct_8x8_inference = true;
  bool restriction = false;  // the VUI's bitstream_restriction_flag
  int num_reorder = 0;       // its max_num_reorder_frames
  int crop_left = 0, crop_right = 0, crop_top = 0, crop_bottom = 0;  // in luma samples
  bool full_range = false;
  int matrix = 2;  // matrix_coefficients: unspecified unless the VUI says
};

struct Pps {
  bool valid = false;
  std::string unsupported;
  int sps_id = 0;
  bool cabac = false, bottom_field_pic_order = false, weighted_pred = false, deblocking_control = false;
  bool constrained_intra = false, redundant_pic_cnt = false, transform_8x8 = false;
  int num_ref_idx_default = 1, num_ref_idx_l1_default = 1, bipred_idc = 0;
  int pic_init_qp = 26, chroma_qp_offset = 0, chroma_qp_offset2 = 0;
  ScalingLists lists;  // those the picture uses: the PPS's, else the SPS's
};

// One scaling_list() (7.3.2.1.1.1) into out (raster order): read, the default list (useDefaultScalingMatrixFlag),
// or, where the list is not sent, the fall-back list (of rule B where rule_b). Counts which it was.
void ReadScalingList(BitReader& br, uint8_t* out, int size, const uint8_t* default_scan, const uint8_t* fallback,
                     bool rule_b, int64_t* stats) {
  const uint8_t* scan = size == 16 ? kZigzag4x4 : kZigzag8x8;
  if (!br.Bit()) {
    std::memcpy(out, fallback, size);
    ++stats[rule_b ? kScalingListsFallbackB : kScalingListsFallbackA];
    return;
  }
  int last = 8, next = 8;
  for (int j = 0; j < size; ++j) {
    if (next != 0) {
      const int delta = br.Se();
      if (delta < -128 || delta > 127) throw Corrupt("delta_scale out of range");
      next = (last + delta + 256) % 256;
      if (j == 0 && next == 0) {
        for (int k = 0; k < size; ++k) out[scan[k]] = default_scan[k];
        ++stats[kScalingListsDefault];
        return;
      }
    }
    out[scan[j]] = static_cast<uint8_t>(next == 0 ? last : next);
    last = out[scan[j]];
  }
  ++stats[kScalingListsExplicit];
}

// The scaling matrices of an SPS (sps == nullptr: fall-back rule A) or of a PPS (rule A where its SPS sends
// none, else rule B), with eight lists, or six where eight_by_eight is false, into lists.
void ReadScalingMatrices(BitReader& br, const Sps* sps, bool eight_by_eight, ScalingLists* lists, int64_t* stats) {
  const bool rule_b = sps && sps->scaling_present;
  uint8_t defaults4[2][16], defaults8[2][64];
  for (int t = 0; t < 2; ++t) {
    for (int k = 0; k < 16; ++k) defaults4[t][kZigzag4x4[k]] = kDefault4x4[t][k];
    for (int k = 0; k < 64; ++k) defaults8[t][kZigzag8x8[k]] = kDefault8x8[t][k];
  }
  for (int i = 0; i < 6; ++i) {
    const int t = i / 3;
    // Rule A: Default for lists 0 and 3, else the list before; rule B: the SPS's for lists 0 and 3.
    const uint8_t* fallback = i % 3 ? lists->l4[i - 1] : rule_b ? sps->lists.l4[i] : defaults4[t];
    ReadScalingList(br, lists->l4[i], 16, kDefault4x4[t], fallback, rule_b, stats);
  }
  if (eight_by_eight) {
    for (int t = 0; t < 2; ++t)
      ReadScalingList(br, lists->l8[t], 64, kDefault8x8[t], rule_b ? sps->lists.l8[t] : defaults8[t], rule_b, stats);
  }
}

void SkipHrd(BitReader& br) {  // hrd_parameters() (E.1.2)
  const uint32_t count = br.Ue() + 1;
  if (count > 32) throw Corrupt("cpb_cnt_minus1 above 31");
  br.Bits(8);  // bit_rate_scale, cpb_size_scale
  for (uint32_t i = 0; i < count; ++i) br.Ue(), br.Ue(), br.Bit();
  br.Bits(20);  // the four delay and offset lengths
}

Sps ParseSps(BitReader& br, int* id_out, int64_t* stats) {
  Sps s;
  const int p = br.Bits(8);  // profile_idc
  br.Bits(16);               // constraint flags, level_idc
  const uint32_t id = br.Ue();
  if (id > 31) throw Corrupt("seq_parameter_set_id above 31");
  *id_out = static_cast<int>(id);
  if (p == 100 || p == 110 || p == 122 || p == 244 || p == 44 || p == 83 || p == 86 || p == 118 || p == 128 ||
      p == 138 || p == 139 || p == 134 || p == 135) {
    const int chroma_format = br.Ue();
    s.chroma_format = chroma_format;
    if (chroma_format == 3 && br.Bit()) {
      s.unsupported = "separate_colour_plane_flag 1";
      return s;
    }
    if (chroma_format != 1) {
      s.unsupported = "chroma_format_idc " + std::to_string(chroma_format) + " (only 4:2:0 is read)";
      return s;
    }
    const int depth_luma = br.Ue() + 8, depth_chroma = br.Ue() + 8;
    if (depth_luma != 8 || depth_chroma != 8) {
      s.unsupported = "a bit depth of " + std::to_string(std::max(depth_luma, depth_chroma)) + " (above 8 bits)";
      return s;
    }
    if (br.Bit()) {
      s.unsupported = "qpprime_y_zero_transform_bypass_flag 1 (lossless bypass)";
      return s;
    }
    if (br.Bit()) {  // seq_scaling_matrix_present_flag
      s.scaling_present = true;
      ++stats[kSpsScalingMatrices];
      ReadScalingMatrices(br, nullptr, true, &s.lists, stats);
    }
  }
  s.log2_max_frame_num = br.Ue() + 4;
  if (s.log2_max_frame_num > 16) throw Corrupt("log2_max_frame_num_minus4 above 12");
  s.poc_type = br.Ue();
  if (s.poc_type == 0) {
    s.log2_max_poc_lsb = br.Ue() + 4;
    if (s.log2_max_poc_lsb > 16) throw Corrupt("log2_max_pic_order_cnt_lsb_minus4 above 12");
  } else if (s.poc_type == 1) {
    s.delta_pic_order_always_zero = br.Bit();
    s.offset_for_non_ref_pic = br.Se();
    s.offset_for_top_to_bottom = br.Se();
    const uint32_t n = br.Ue();
    if (n > 255) throw Corrupt("num_ref_frames_in_pic_order_cnt_cycle above 255");
    for (uint32_t i = 0; i < n; ++i) s.offset_for_ref_frame.push_back(br.Se());
  } else if (s.poc_type != 2) {
    throw Corrupt("pic_order_cnt_type above 2");
  }
  s.max_num_ref_frames = br.Ue();
  if (s.max_num_ref_frames > 16) throw Corrupt("max_num_ref_frames above 16");
  br.Bit();  // gaps_in_frame_num_value_allowed_flag: a gap is refused either way
  s.mb_width = br.Ue() + 1;
  s.mb_height = br.Ue() + 1;
  if (s.mb_width > 1024 || s.mb_height > 1024) throw Corrupt("picture size above 16384 samples");
  if (!br.Bit()) {
    s.unsupported = "frame_mbs_only_flag 0 (interlaced coding: field pictures or MBAFF)";
    return s;
  }
  s.direct_8x8_inference = br.Bit();
  if (br.Bit()) {
    s.crop_left = 2 * br.Ue();
    s.crop_right = 2 * br.Ue();
    s.crop_top = 2 * br.Ue();
    s.crop_bottom = 2 * br.Ue();
    if (s.crop_left + s.crop_right >= 16 * s.mb_width || s.crop_top + s.crop_bottom >= 16 * s.mb_height)
      throw Corrupt("frame cropping removes the whole picture");
  }
  if (br.Bit()) {  // vui_parameters
    if (br.Bit() && br.Bits(8) == 255) br.Bits(32);  // aspect_ratio_info, Extended_SAR
    if (br.Bit()) br.Bit();                            // overscan
    if (br.Bit()) {                                    // video_signal_type_present_flag
      br.Bits(3);
      s.full_range = br.Bit();
      if (br.Bit()) {  // colour_description: primaries, transfer, matrix
        br.Bits(16);
        s.matrix = br.Bits(8);
      }
    }
    if (br.Bit()) br.Ue(), br.Ue();                      // chroma_loc_info
    if (br.Bit()) br.Bits(32), br.Bits(32), br.Bit();    // timing_info
    const bool nal_hrd = br.Bit();
    if (nal_hrd) SkipHrd(br);
    const bool vcl_hrd = br.Bit();
    if (vcl_hrd) SkipHrd(br);
    if (nal_hrd || vcl_hrd) br.Bit();  // low_delay_hrd_flag
    br.Bit();                          // pic_struct_present_flag
    s.restriction = br.Bit();
    if (s.restriction) {
      br.Bit();  // motion_vectors_over_pic_boundaries_flag
      br.Ue(), br.Ue(), br.Ue(), br.Ue();  // max_bytes_per_pic_denom ... log2_max_mv_length_vertical
      s.num_reorder = static_cast<int>(br.Ue());
      if (s.num_reorder > 16) throw Corrupt("max_num_reorder_frames above 16");
      br.Ue();  // max_dec_frame_buffering
    }
  }
  s.valid = true;
  return s;
}

// A PPS, its scaling matrices resolved against sps_table[sps_id] as it stands (as FFmpeg does).
Pps ParsePps(BitReader& br, int* id_out, const Sps* sps_table, int64_t* stats) {
  Pps p;
  const uint32_t id = br.Ue();
  if (id > 255) throw Corrupt("pic_parameter_set_id above 255");
  *id_out = static_cast<int>(id);
  p.sps_id = br.Ue();
  if (p.sps_id > 31) throw Corrupt("seq_parameter_set_id above 31");
  const Sps& sps = sps_table[p.sps_id];
  p.cabac = br.Bit();
  p.bottom_field_pic_order = br.Bit();
  const uint32_t groups = br.Ue() + 1;
  if (groups > 1) {
    p.unsupported = "slice groups (FMO, num_slice_groups_minus1 " + std::to_string(groups - 1) + ")";
    return p;
  }
  p.num_ref_idx_default = br.Ue() + 1;
  p.num_ref_idx_l1_default = br.Ue() + 1;
  if (p.num_ref_idx_default > 32 || p.num_ref_idx_l1_default > 32)
    throw Corrupt("num_ref_idx_default_active_minus1 above 31");
  p.weighted_pred = br.Bit();
  p.bipred_idc = br.Bits(2);
  if (p.bipred_idc == 3) throw Corrupt("weighted_bipred_idc 3");
  p.pic_init_qp = 26 + br.Se();
  br.Se();  // pic_init_qs_minus26
  p.chroma_qp_offset = br.Se();
  if (p.pic_init_qp < 0 || p.pic_init_qp > 51 || p.chroma_qp_offset < -12 || p.chroma_qp_offset > 12)
    throw Corrupt("pic_init_qp or chroma_qp_index_offset out of range");
  p.chroma_qp_offset2 = p.chroma_qp_offset;
  p.deblocking_control = br.Bit();
  p.constrained_intra = br.Bit();
  p.redundant_pic_cnt = br.Bit();
  p.lists = sps.lists;
  if (br.MoreRbspData()) {
    p.transform_8x8 = br.Bit();
    if (p.transform_8x8) ++stats[kTransform8x8Pps];
    if (br.Bit()) {  // pic_scaling_matrix_present_flag
      if (!sps.valid && sps.unsupported.empty()) throw Corrupt("a PPS with scaling matrices before its SPS");
      if (sps.chroma_format == 3) {
        p.unsupported = "chroma_format_idc 3 (only 4:2:0 is read)";
        return p;
      }
      ++stats[kPpsScalingMatrices];
      ReadScalingMatrices(br, &sps, p.transform_8x8, &p.lists, stats);
    }
    p.chroma_qp_offset2 = br.Se();
    if (p.chroma_qp_offset2 < -12 || p.chroma_qp_offset2 > 12)
      throw Corrupt("second_chroma_qp_index_offset out of range");
    if (p.chroma_qp_offset2 != p.chroma_qp_offset) ++stats[kSecondChromaQpOffsets];
  }
  p.valid = true;
  return p;
}

// ---------------------------------------------------------------------------------------------
// CABAC's arithmetic decoding engine (9.3.1.2, 9.3.3.2), reading bit by bit from the slice's reader

class CabacEngine {
 public:
  void Start(BitReader* br) {
    br_ = br;
    range_ = 510;
    offset_ = 0;
    for (int i = 0; i < 9; ++i) offset_ = (offset_ << 1) | br_->BitOrZero();
    if (offset_ >= 510) throw Corrupt("CABAC codIOffset of 510 or 511");
  }
  // A bin of the context whose state is (pStateIdx << 1) | valMPS.
  int Decision(uint8_t* state) {
    int s = *state >> 1, mps = *state & 1, bin = mps;
    const int lps = kRangeLps[s][(range_ >> 6) & 3];
    range_ -= lps;
    if (offset_ >= range_) {
      bin = !mps;
      offset_ -= range_;
      range_ = lps;
      if (s == 0) mps = !mps;
      s = kTransIdxLps[s];
    } else {
      s = std::min(s + 1, 62);
    }
    *state = static_cast<uint8_t>((s << 1) | mps);
    Renormalise();
    return bin;
  }
  int Bypass() {
    offset_ = (offset_ << 1) | br_->BitOrZero();
    if (offset_ < range_) return 0;
    offset_ -= range_;
    return 1;
  }
  // end_of_slice_flag and I_PCM's mb_type bin: after a 1, the reader stands past the encoder's flush.
  int Terminate() {
    range_ -= 2;
    if (offset_ >= range_) return 1;
    Renormalise();
    return 0;
  }

 private:
  void Renormalise() {
    while (range_ < 256) {
      range_ <<= 1;
      offset_ = (offset_ << 1) | br_->BitOrZero();
    }
  }
  BitReader* br_ = nullptr;
  int range_ = 510, offset_ = 0;
};

// ---------------------------------------------------------------------------------------------
// Pictures

struct Picture {
  int id = 0;
  sr_yuv::Coefficients colour{};  // the unscaled converter's, from the VUI's matrix and range
  int width = 0, height = 0;  // coded, in luma samples
  std::vector<uint8_t> y, u, v;
  int frame_num = 0, frame_num_wrap = 0;
  int64_t poc = 0;  // as FFmpeg counts it
  bool short_ref = false, long_ref = false;
  int long_idx = -1;
  int unit = 0;                              // the decode call that carried it
  bool key = false, mmco_reset = false;      // an IDR picture; FFmpeg's mmco_reset (an MMCO 5 before or in it)
  // Its motion, for the co-located lookup of direct prediction: per 4x4 block the vector and reference index of each
  // list, per macroblock whether it is intra, and the frame_num of each entry of the lists of its last slice (FFmpeg
  // finds the co-located block's reference in the current list 0 by frame_num).
  std::vector<int16_t> mv[2];
  std::vector<int8_t> ref[2];
  std::vector<uint8_t> intra, shape;  // per macroblock: intra; MbInfo::shape
  int list_count[2] = {0, 0};
  int list_frame_num[2][32] = {};
  const uint8_t* Plane(int c) const { return c == 0 ? y.data() : c == 1 ? u.data() : v.data(); }
  uint8_t* Plane(int c) { return c == 0 ? y.data() : c == 1 ? u.data() : v.data(); }
  int Stride(int c) const { return c == 0 ? width : width / 2; }
};
using PicturePtr = std::shared_ptr<Picture>;

enum MbKind : uint8_t { kMbI4x4, kMbI16x16, kMbPcm, kMbInter, kMbSkip };  // kMbSkip: P_Skip or B_Skip

struct MbInfo {
  int slice = -1;  // index of the slice of the current picture that decoded it; -1: not decoded
  MbKind kind = kMbSkip;
  int qp = 0;            // QPY
  uint8_t nz[24] = {};   // nonzero levels (CAVLC: total_coeff; CABAC: of the 8x8 block in each of its 4x4 blocks):
                         // luma 4x4 in raster order, then Cb and Cr 2x2; 16 in I_PCM
  int8_t i4[16] = {};    // Intra4x4PredMode (Intra8x8PredMode in each 4x4 block) in raster order (2 but in I_NxN)
  bool t8 = false;       // transform_size_8x8_flag
  uint8_t cbp = 0;       // CodedBlockPatternLuma | CodedBlockPatternChroma << 4
  uint8_t dc = 0;        // coded DC blocks (CABAC's coded_block_flag): 1 luma (Intra16x16), 2 Cb, 4 Cr
  uint8_t chroma_mode = 0;  // intra_chroma_pred_mode
  bool direct16 = false;    // B_Direct_16x16
  uint8_t shape = 0;        // its partitions as FFmpeg types it: 0 16x16 (or intra), 1 16x8, 2 8x16, 3 8x8
  bool b_slice = false;     // decoded in a B slice (deblocking compares both lists there)
  bool Intra() const { return kind == kMbI4x4 || kind == kMbI16x16 || kind == kMbPcm; }
};

struct SliceInfo {
  int deblock_idc = 0, alpha_offset = 0, beta_offset = 0, chroma_qp_offset[2] = {0, 0};  // Cb, Cr
  bool constrained_intra = false;
};

struct Weight {
  int luma_w = 1, luma_o = 0, chroma_w[2] = {1, 1}, chroma_o[2] = {0, 0};
  bool luma = false, chroma = false;
};

struct Mmco {
  int op = 0, diff = 0, long_num = 0, long_idx = 0, max_idx = 0;
};

// ---------------------------------------------------------------------------------------------
// The decoder

class Decoder {
 public:
  explicit Decoder(const uint8_t* config, size_t size) {
    if (size == 0) return;
    if (size < 7 || config[0] != 1) throw Corrupt("avcC record without configurationVersion 1");
    const int length_size = (config[4] & 3) + 1;
    if (length_size == 3) throw Corrupt("avcC lengthSizeMinusOne 2");
    length_size_ = length_size;
    size_t pos = 5;
    for (int set = 0; set < 2; ++set) {
      if (pos >= size) throw Corrupt("truncated avcC record");
      const int count = set == 0 ? (config[pos] & 31) : config[pos];
      ++pos;
      for (int i = 0; i < count; ++i) {
        if (pos + 2 > size) throw Corrupt("truncated avcC record");
        const size_t len = (config[pos] << 8) | config[pos + 1];
        pos += 2;
        if (pos + len > size) throw Corrupt("truncated avcC parameter set");
        Nal(config + pos, len);
        pos += len;
      }
    }
    // A configuration that announces a refused stream is refused before its first frame.
    for (const Sps& s : sps_)
      if (!s.unsupported.empty()) throw Unsupported(s.unsupported);
    for (const Pps& p : pps_)
      if (!p.unsupported.empty()) throw Unsupported(p.unsupported);
  }

  int Decode(const uint8_t* data, size_t size) {
    output_.clear();
    if (length_size_ == 0) {
      // Annex B: NAL units between start codes (two or more zero bytes, then a one).
      size_t i = 0, start = SIZE_MAX;
      while (i + 2 < size) {
        if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
          if (start != SIZE_MAX) NalTrimmed(data + start, i - start);
          i += 3;
          start = i;
        } else {
          ++i;
        }
      }
      if (start != SIZE_MAX && start < size) NalTrimmed(data + start, size - start);
    } else {
      size_t pos = 0;
      while (pos < size) {
        if (pos + length_size_ > size) throw Corrupt("truncated NAL unit length");
        size_t len = 0;
        for (int k = 0; k < length_size_; ++k) len = (len << 8) | data[pos + k];
        pos += length_size_;
        if (pos + len > size) throw Corrupt("NAL unit runs past its payload");
        Nal(data + pos, len);
        pos += len;
      }
    }
    if (cur_) FinishPicture();  // a call holds whole access units
    ++unit_;
    return static_cast<int>(output_.size());
  }

  // The end of the stream: the pictures still held back, as FFmpeg's send_next_delayed_frame outputs them (the lowest
  // picture order count first, up to a key frame or an MMCO 5 picture).
  int Flush() {
    output_.clear();
    while (!delayed_.empty()) {
      const size_t out = NextDelayed();
      Emit(delayed_[out]);
      delayed_.erase(delayed_.begin() + static_cast<std::ptrdiff_t>(out));
    }
    return static_cast<int>(output_.size());
  }

  int width() const { return out_width_; }
  int height() const { return out_height_; }
  const Picture& output(int i) const { return *output_.at(i); }
  const int64_t* stats() const { return stats_; }
  int crop_left() const { return crop_left_; }
  int crop_top() const { return crop_top_; }

 private:
  // ---- NAL units
  void NalTrimmed(const uint8_t* data, size_t size) {
    while (size > 0 && data[size - 1] == 0) --size;  // trailing_zero_8bits and the next start code's zeros
    if (size) Nal(data, size);
  }

  void Nal(const uint8_t* data, size_t size) {
    if (size == 0) return;
    if (data[0] & 0x80) throw Corrupt("NAL unit with forbidden_zero_bit set");
    const int ref_idc = (data[0] >> 5) & 3, type = data[0] & 31;
    switch (type) {
      case 1:
      case 5: {
        std::vector<uint8_t> rbsp = Unescape(data + 1, size - 1);
        Slice(rbsp, ref_idc, type == 5);
        break;
      }
      case 2:
      case 3:
      case 4:
        throw Unsupported("data partitioning (NAL unit type " + std::to_string(type) + ")");
      case 7: {
        std::vector<uint8_t> rbsp = Unescape(data + 1, size - 1);
        BitReader br(rbsp.data(), rbsp.size());
        int id = 0;
        Sps s = ParseSps(br, &id, stats_);
        sps_[id] = s;
        break;
      }
      case 8: {
        std::vector<uint8_t> rbsp = Unescape(data + 1, size - 1);
        BitReader br(rbsp.data(), rbsp.size());
        int id = 0;
        Pps p = ParsePps(br, &id, sps_, stats_);
        pps_[id] = p;
        break;
      }
      default:
        break;  // SEI, AUD, end of sequence / stream, filler, SPS extension, prefix / subset SPS / extension
                // NAL units of other layers, and the reserved types: what FFmpeg skips for the base layer
    }
  }

  // ---- slice header
  struct Header {
    int first_mb = 0, type = 0, pps_id = 0, frame_num = 0, poc_lsb = 0;  // type 0: P, 1: B, 2: I
    int delta_poc_bottom = 0, delta_poc[2] = {0, 0}, num_ref[2] = {1, 0}, qp = 26;
    int deblock_idc = 0, alpha_offset = 0, beta_offset = 0;
    int luma_log2 = 0, chroma_log2 = 0, cabac_init_idc = 0;
    bool idr = false, long_term_reference = false, adaptive = false, weighted = false, direct_spatial = false;
    bool use_weight = false;  // FFmpeg's use_weight: a weight or offset of the table unlike the default
    int ref_idc = 0, bipred_idc = 0;
    std::vector<std::pair<int, int>> modifications[2];
    std::vector<Weight> weights[2];
    std::vector<Mmco> mmco;
  };

  void ReadModifications(BitReader& br, std::vector<std::pair<int, int>>* mods) {
    if (!br.Bit()) return;  // ref_pic_list_modification_flag_lX
    for (;;) {
      const uint32_t idc = br.Ue();
      if (idc == 3) break;
      if (idc > 3) throw Corrupt("modification_of_pic_nums_idc above 3");
      mods->emplace_back(static_cast<int>(idc), static_cast<int>(br.Ue()));
      if (mods->size() > 32) throw Corrupt("more than 32 reference list modifications");
    }
  }

  // pred_weight_table() (7.3.3.2) of the slice's lists.
  void ReadWeights(BitReader& br, Header* h, int lists) {
    h->weighted = true;
    h->luma_log2 = br.Ue();
    h->chroma_log2 = br.Ue();
    if (h->luma_log2 > 7 || h->chroma_log2 > 7) throw Corrupt("log2 weight denominator above 7");
    for (int l = 0; l < lists; ++l) {
      h->weights[l].resize(h->num_ref[l]);
      for (int i = 0; i < h->num_ref[l]; ++i) {
        Weight& w = h->weights[l][i];
        w.luma_w = 1 << h->luma_log2;
        w.chroma_w[0] = w.chroma_w[1] = 1 << h->chroma_log2;
        if (br.Bit()) {
          w.luma = true;
          w.luma_w = br.Se();
          w.luma_o = br.Se();
          h->use_weight |= w.luma_w != 1 << h->luma_log2 || w.luma_o != 0;
        }
        if (br.Bit()) {
          w.chroma = true;
          for (int j = 0; j < 2; ++j) {
            w.chroma_w[j] = br.Se();
            w.chroma_o[j] = br.Se();
            h->use_weight |= w.chroma_w[j] != 1 << h->chroma_log2 || w.chroma_o[j] != 0;
          }
        }
        auto out = [](int v) { return v < -128 || v > 127; };
        if ((w.luma && (out(w.luma_w) || out(w.luma_o))) ||
            (w.chroma && (out(w.chroma_w[0]) || out(w.chroma_o[0]) || out(w.chroma_w[1]) || out(w.chroma_o[1]))))
          throw Corrupt("prediction weight or offset out of range");
      }
    }
  }

  void Slice(const std::vector<uint8_t>& rbsp, int ref_idc, bool idr) {
    BitReader br(rbsp.data(), rbsp.size());
    Header h;
    h.idr = idr;
    h.ref_idc = ref_idc;
    h.first_mb = br.Ue();
    const uint32_t slice_type = br.Ue();
    if (slice_type > 9) throw Corrupt("slice_type above 9");
    h.type = slice_type % 5;
    if (h.type == 3) throw Unsupported("SP slices");
    if (h.type == 4) throw Unsupported("SI slices");
    if (idr && h.type != 2) throw Corrupt("an IDR picture with a P or B slice");
    h.pps_id = br.Ue();
    if (h.pps_id > 255 || !pps_[h.pps_id].valid) {
      if (h.pps_id <= 255 && !pps_[h.pps_id].unsupported.empty())
        throw Unsupported(pps_[h.pps_id].unsupported);
      throw Corrupt("slice refers to a missing picture parameter set");
    }
    const Pps& pps = pps_[h.pps_id];
    const Sps& sps = sps_[pps.sps_id];
    if (!sps.valid) {
      if (!sps.unsupported.empty()) throw Unsupported(sps.unsupported);
      throw Corrupt("slice refers to a missing sequence parameter set");
    }
    h.frame_num = br.Bits(sps.log2_max_frame_num);
    if (idr) br.Ue();  // idr_pic_id
    if (sps.poc_type == 0) {
      h.poc_lsb = br.Bits(sps.log2_max_poc_lsb);
      if (pps.bottom_field_pic_order) h.delta_poc_bottom = br.Se();
    } else if (sps.poc_type == 1 && !sps.delta_pic_order_always_zero) {
      h.delta_poc[0] = br.Se();
      if (pps.bottom_field_pic_order) h.delta_poc[1] = br.Se();
    }
    if (pps.redundant_pic_cnt && br.Ue() > 0) throw Unsupported("redundant pictures (redundant_pic_cnt above 0)");
    const bool b = h.type == 1;
    if (b) h.direct_spatial = br.Bit();
    h.num_ref[0] = pps.num_ref_idx_default;
    h.num_ref[1] = b ? pps.num_ref_idx_l1_default : 0;
    if (h.type != 2) {
      if (br.Bit()) {  // num_ref_idx_active_override_flag
        h.num_ref[0] = br.Ue() + 1;
        if (b) h.num_ref[1] = br.Ue() + 1;
      }
      if (h.num_ref[0] > 16) throw Corrupt("num_ref_idx_l0_active_minus1 above 15");
      if (h.num_ref[1] > 16) throw Corrupt("num_ref_idx_l1_active_minus1 above 15");
      for (int l = 0; l < (b ? 2 : 1); ++l) ReadModifications(br, &h.modifications[l]);
      if (h.type == 0 ? pps.weighted_pred : pps.bipred_idc == 1) ReadWeights(br, &h, b ? 2 : 1);
      if (b) h.bipred_idc = pps.bipred_idc;
    } else {
      h.num_ref[0] = 0;
    }
    if (ref_idc) {
      if (idr) {
        if (br.Bit()) throw Unsupported("no_output_of_prior_pics_flag 1");
        h.long_term_reference = br.Bit();
      } else {
        h.adaptive = br.Bit();
        if (h.adaptive) {
          for (;;) {
            Mmco m;
            m.op = br.Ue();
            if (m.op == 0) break;
            if (m.op > 6) throw Corrupt("memory_management_control_operation above 6");
            if (m.op == 1 || m.op == 3) m.diff = br.Ue() + 1;
            if (m.op == 2) m.long_num = br.Ue();
            if (m.op == 3 || m.op == 6) m.long_idx = br.Ue();
            if (m.op == 4) m.max_idx = br.Ue();
            h.mmco.push_back(m);
            if (h.mmco.size() > 66) throw Corrupt("more than 66 memory management operations");
          }
        }
      }
    }
    if (pps.cabac && h.type != 2) {
      h.cabac_init_idc = br.Ue();
      if (h.cabac_init_idc > 2) throw Corrupt("cabac_init_idc above 2");
    }
    h.qp = pps.pic_init_qp + br.Se();
    if (h.qp < 0 || h.qp > 51) throw Corrupt("slice QP out of range");
    if (pps.deblocking_control) {
      h.deblock_idc = br.Ue();
      if (h.deblock_idc > 2) throw Corrupt("disable_deblocking_filter_idc above 2");
      if (h.deblock_idc != 1) {
        h.alpha_offset = 2 * br.Se();
        h.beta_offset = 2 * br.Se();
        if (h.alpha_offset < -12 || h.alpha_offset > 12 || h.beta_offset < -12 || h.beta_offset > 12)
          throw Corrupt("deblocking filter offset out of range");
      }
    }

    if (h.first_mb == 0 && cur_) FinishPicture();
    if (!cur_) {
      if (h.first_mb != 0) {
        if (!seen_idr_) throw Corrupt("a slice before the first IDR picture");
        throw Unsupported("arbitrary slice order (a picture's first slice does not start at macroblock 0)");
      }
      StartPicture(h, sps, pps);
    } else {
      if (h.first_mb < next_mb_) throw Unsupported("arbitrary slice order (first_mb_in_slice goes back)");
      if (h.first_mb > next_mb_) throw Corrupt("macroblocks missing between slices");
      if (h.frame_num != cur_header_.frame_num || h.idr != cur_header_.idr || h.pps_id != cur_header_.pps_id)
        throw Corrupt("slices of one picture disagree on frame_num, IDR or PPS");
      if (sps_index_ != pps.sps_id) throw Corrupt("slices of one picture use two sequence parameter sets");
    }
    ++stats_[kSlices];
    ++stats_[h.type == 2 ? kISlices : h.type == 0 ? kPSlices : kBSlices];
    ++stats_[kDeblockIdc0 + h.deblock_idc];
    if (h.deblock_idc != 1 && (h.alpha_offset || h.beta_offset)) ++stats_[kDeblockOffsets];
    if (pps.constrained_intra) ++stats_[kConstrainedIntraSlices];
    if (h.weighted) ++stats_[b ? kExplicitBipredSlices : kWeightedSlices];
    if (b && h.bipred_idc == 2) ++stats_[kImplicitBipredSlices];
    if (pps.cabac) {
      ++stats_[kCabacSlices];
      if (h.type != 2) ++stats_[kCabacInitIdc0 + h.cabac_init_idc];
    }
    stats_[kListModifications] += static_cast<int64_t>(h.modifications[0].size());
    stats_[kList1Modifications] += static_cast<int64_t>(h.modifications[1].size());

    SliceInfo info;
    info.deblock_idc = h.deblock_idc;
    info.alpha_offset = h.alpha_offset;
    info.beta_offset = h.beta_offset;
    info.chroma_qp_offset[0] = pps.chroma_qp_offset;
    info.chroma_qp_offset[1] = pps.chroma_qp_offset2;
    info.constrained_intra = pps.constrained_intra;
    slices_.push_back(info);
    slice_ = static_cast<int>(slices_.size()) - 1;
    if (slice_ == 1) ++stats_[kMultiSlicePictures];
    header_ = h;
    sps_direct_8x8_ = sps.direct_8x8_inference;
    BuildRefLists(h);
    SliceData(br, h, pps);
  }

  // ---- pictures
  void StartPicture(const Header& h, const Sps& sps, const Pps& pps) {
    if (!h.idr && !seen_idr_) {
      if (h.type == 2) throw Unsupported("a stream that starts without an IDR picture");
      throw Corrupt(h.type == 0 ? "a P slice before the first IDR picture" : "a B slice before the first IDR picture");
    }
    const int width = 16 * sps.mb_width, height = 16 * sps.mb_height;
    if (sps.crop_left)
      throw Unsupported("a left crop (frame_crop_left_offset " + std::to_string(sps.crop_left / 2) + ")");
    if (!sr_yuv::MatrixTable(sps.matrix))
      throw Unsupported("matrix_coefficients " + std::to_string(sps.matrix) +
                        " (BT.601, BT.709, FCC and SMPTE 240M are converted)");
    if (width_ && (width != width_ || height != height_ || sps.crop_right != crop_right_ ||
                   sps.crop_top != crop_top_ || sps.crop_bottom != crop_bottom_))
      throw Unsupported("a picture size that changes mid-stream");
    width_ = width, height_ = height, mb_width_ = sps.mb_width, mb_height_ = sps.mb_height;
    crop_left_ = sps.crop_left, crop_right_ = sps.crop_right, crop_top_ = sps.crop_top, crop_bottom_ = sps.crop_bottom;
    out_width_ = width - sps.crop_left - sps.crop_right;
    out_height_ = height - sps.crop_top - sps.crop_bottom;
    sps_index_ = pps.sps_id;
    const int max_frame_num = 1 << sps.log2_max_frame_num;
    if (h.idr) {
      for (auto& r : dpb_) r->short_ref = r->long_ref = false;
      dpb_.clear();
      prev_ref_frame_num_ = 0;
      max_long_idx_ = -1;
      prev_poc_msb_ = 1 << 16, prev_poc_lsb_ = -1;  // FFmpeg's idr()
      prev_frame_num_offset_ = 0;
      prev_frame_num_ = 0;
      std::fill(std::begin(last_pocs_), std::end(last_pocs_), kNoPoc);
      seen_idr_ = true;
    } else if (h.frame_num != prev_ref_frame_num_ && h.frame_num != (prev_ref_frame_num_ + 1) % max_frame_num) {
      throw Unsupported("gaps in frame_num (" + std::to_string(prev_ref_frame_num_) + " then " +
                        std::to_string(h.frame_num) + ")");
    }
    cur_ = std::make_shared<Picture>();
    cur_->id = ++picture_ids_;
    cur_->width = width, cur_->height = height;
    cur_->y.assign(static_cast<size_t>(width) * height, 0);
    cur_->u.assign(static_cast<size_t>(width / 2) * (height / 2), 0);
    cur_->v.assign(cur_->u.size(), 0);
    cur_->frame_num = h.frame_num;
    cur_->unit = unit_;
    cur_->key = h.idr;
    cur_->colour = sr_yuv::SimdCoefficients(sr_yuv::MatrixTable(sps.matrix), sps.full_range);
    cur_header_ = h;
    mbs_.assign(static_cast<size_t>(mb_width_) * mb_height_, MbInfo());
    const size_t blocks = static_cast<size_t>(mb_width_) * mb_height_ * 16;
    for (int l = 0; l < 2; ++l) {
      mv_[l].assign(blocks * 2, 0);
      mvd_[l].assign(blocks * 2, 0);
      ref_[l].assign(blocks, -1);
      refpic_[l].assign(blocks, 0);
    }
    direct_.assign(blocks, 0);
    slices_.clear();
    next_mb_ = 0;
    // Picture order count as FFmpeg derives it (ff_h264_init_poc): 8.2.1, except that after an MMCO 5 it goes on
    // from the previous reference picture's counts as they were. Where it increases, FFmpeg outputs the pictures
    // in decoding order, as this decoder does, however many frames it holds back (its reorder delay grows with the
    // steps it sees, and with its frame threads); elsewhere FFmpeg reorders or drops pictures depending on that
    // delay, so such a stream is refused.
    int frame_num_offset = prev_frame_num_offset_ + (h.frame_num < prev_frame_num_ ? max_frame_num : 0);
    int64_t top = 0, bottom = 0;
    if (sps.poc_type == 0) {
      const int max_lsb = 1 << sps.log2_max_poc_lsb;
      if (prev_poc_lsb_ < 0) prev_poc_lsb_ = h.poc_lsb;
      int msb = prev_poc_msb_;
      if (h.poc_lsb < prev_poc_lsb_ && prev_poc_lsb_ - h.poc_lsb >= max_lsb / 2)
        msb += max_lsb;
      else if (h.poc_lsb > prev_poc_lsb_ && prev_poc_lsb_ - h.poc_lsb < -max_lsb / 2)
        msb -= max_lsb;
      cur_poc_msb_ = msb;
      top = msb + h.poc_lsb;
      bottom = top + h.delta_poc_bottom;
    } else if (sps.poc_type == 1) {
      const int cycle = static_cast<int>(sps.offset_for_ref_frame.size());
      int abs_frame_num = cycle ? frame_num_offset + h.frame_num : 0;
      if (h.ref_idc == 0 && abs_frame_num > 0) --abs_frame_num;
      int64_t expected = 0, delta_cycle = 0;
      for (int o : sps.offset_for_ref_frame) delta_cycle += o;
      if (abs_frame_num > 0) {
        expected = static_cast<int64_t>((abs_frame_num - 1) / cycle) * delta_cycle;
        for (int i = 0; i <= (abs_frame_num - 1) % cycle; ++i) expected += sps.offset_for_ref_frame[i];
      }
      if (h.ref_idc == 0) expected += sps.offset_for_non_ref_pic;
      top = expected + h.delta_poc[0];
      bottom = top + sps.offset_for_top_to_bottom + h.delta_poc[1];
    } else {
      top = bottom = 2 * (static_cast<int64_t>(frame_num_offset) + h.frame_num) - (h.ref_idc == 0);
    }
    cur_frame_num_offset_ = frame_num_offset;
    cur_->poc = std::min(top, bottom);
    if (!h.idr && cur_->poc <= last_poc_ && !sps.restriction)
      throw Unsupported("a picture order count that does not increase in decoding order in a stream without the "
                        "VUI's bitstream_restriction_flag (" + std::to_string(last_poc_) + " then " +
                        std::to_string(cur_->poc) + " as FFmpeg counts: its output order then depends on its thread "
                        "count)");
    ++stats_[kPocType0 + sps.poc_type];
    cur_max_frame_num_ = max_frame_num;
    cur_max_refs_ = std::max(sps.max_num_ref_frames, 1);
    if (h.type == 1 && h.ref_idc) ++stats_[kReferenceBPictures];
    SelectOutput(sps);
  }

  // FFmpeg's h264_select_output_frame, at the start of each picture: with the VUI's bitstream restriction the picture
  // joins those held back and, once more are held than max_num_reorder_frames, the one of lowest picture order count
  // (up to a key frame or an MMCO 5 picture) is output when the current one has been decoded, or dropped where it
  // comes before one already output. Without the restriction every picture is output as it is decoded: FFmpeg then
  // grows its delay from what it sees, and its order is the decoding order wherever the count increases (elsewhere
  // the stream is refused).
  void SelectOutput(const Sps& sps) {
    Picture& cur = *cur_;
    cur.mmco_reset = mmco_reset_;
    mmco_reset_ = false;
    if (!sps.restriction) {
      pending_output_ = cur_;
      return;
    }
    has_b_frames_ = std::max(has_b_frames_, sps.num_reorder);
    int i = 0;  // last_pocs_: the 16 largest counts seen, ascending
    for (;; ++i) {
      if (i == 16 || cur.poc < last_pocs_[i]) {
        if (i) last_pocs_[i - 1] = cur.poc;
        break;
      } else if (i) {
        last_pocs_[i - 1] = last_pocs_[i];
      }
    }
    if (16 - i == 16) {  // "Invalid POC": a count below every one kept
      std::fill(std::begin(last_pocs_), std::end(last_pocs_), kNoPoc);
      last_pocs_[0] = cur.poc;
      cur.mmco_reset = true;
    }
    delayed_.push_back(cur_);
    const size_t out = NextDelayed();
    if (has_b_frames_ == 0 && (delayed_[0]->key || delayed_[0]->mmco_reset)) next_output_poc_ = kNoPoc;
    const PicturePtr picked = delayed_[out];
    const bool out_of_order = picked->poc < next_output_poc_;
    const bool ready = static_cast<int>(delayed_.size()) > has_b_frames_;
    if (out_of_order || ready) delayed_.erase(delayed_.begin() + static_cast<std::ptrdiff_t>(out));
    if (!out_of_order && ready) {
      pending_output_ = picked;
      next_output_poc_ = out == 0 && !delayed_.empty() && (delayed_[0]->key || delayed_[0]->mmco_reset)
                             ? kNoPoc : picked->poc;
    }
  }

  // The held-back picture of lowest picture order count before the first key frame or MMCO 5 picture after the first.
  size_t NextDelayed() const {
    size_t out = 0;
    for (size_t i = 1; i < delayed_.size() && !delayed_[i]->key && !delayed_[i]->mmco_reset; ++i)
      if (delayed_[i]->poc < delayed_[out]->poc) out = i;
    return out;
  }

  void Emit(const PicturePtr& pic) {
    if (pic->id < max_output_id_) ++stats_[kReorderedPictures];
    max_output_id_ = std::max(max_output_id_, pic->id);
    output_.push_back(pic);
  }

  void FinishPicture() {
    if (next_mb_ != mb_width_ * mb_height_) throw Corrupt("a picture whose slices leave macroblocks undecoded");
    Deblock();
    const Header& h = cur_header_;
    ++stats_[kPictures];
    if (h.idr) ++stats_[kIdrPictures];
    if (!h.ref_idc) ++stats_[kNonRefPictures];
    if (crop_right_ || crop_top_ || crop_bottom_) ++stats_[kCroppedPictures];
    if (h.ref_idc && MarkReferences(h)) {
      prev_ref_frame_num_ = 0;  // MMCO 5: frame_num starts over
    } else if (h.ref_idc) {
      prev_ref_frame_num_ = h.frame_num;
    }
    // FFmpeg's ff_h264_field_end: the counts the next picture's POC starts from (frame_num 0 after an MMCO 5).
    if (h.ref_idc) prev_poc_msb_ = cur_poc_msb_, prev_poc_lsb_ = h.poc_lsb;
    prev_frame_num_offset_ = cur_frame_num_offset_;
    prev_frame_num_ = cur_->frame_num;
    last_poc_ = cur_->poc;
    for (int l = 0; l < 2; ++l) {
      cur_->mv[l] = std::move(mv_[l]);
      cur_->ref[l] = std::move(ref_[l]);
    }
    cur_->intra.resize(mbs_.size());
    cur_->shape.resize(mbs_.size());
    for (size_t i = 0; i < mbs_.size(); ++i) cur_->intra[i] = mbs_[i].Intra(), cur_->shape[i] = mbs_[i].shape;
    if (pending_output_) Emit(pending_output_);
    pending_output_.reset();
    cur_.reset();
  }

  // ---- reference marking (8.2.5)
  void UpdateWraps(int frame_num) {
    for (auto& r : dpb_) {
      if (r->short_ref) r->frame_num_wrap = r->frame_num > frame_num ? r->frame_num - cur_max_frame_num_ : r->frame_num;
    }
  }

  void Prune() {
    auto unused = [](const PicturePtr& p) { return !p->short_ref && !p->long_ref; };
    dpb_.erase(std::remove_if(dpb_.begin(), dpb_.end(), unused), dpb_.end());
  }

  PicturePtr ShortByPicNum(int pic_num) {
    for (auto& r : dpb_)
      if (r->short_ref && r->frame_num_wrap == pic_num) return r;
    return nullptr;
  }
  PicturePtr LongByIdx(int idx) {
    for (auto& r : dpb_)
      if (r->long_ref && r->long_idx == idx) return r;
    return nullptr;
  }

  bool MarkReferences(const Header& h) {
    bool mmco5 = false, current_long = false;
    UpdateWraps(h.frame_num);
    if (h.idr) {
      if (h.long_term_reference) {
        cur_->long_ref = true;
        cur_->long_idx = 0;
        max_long_idx_ = 0;
        current_long = true;
        ++stats_[kLongTermRefs];
      } else {
        max_long_idx_ = -1;
      }
    } else if (!h.adaptive) {
      int count = 0;
      for (auto& r : dpb_) count += r->short_ref || r->long_ref;
      if (count >= cur_max_refs_) {
        PicturePtr oldest;
        for (auto& r : dpb_)
          if (r->short_ref && (!oldest || r->frame_num_wrap < oldest->frame_num_wrap)) oldest = r;
        if (!oldest) throw Corrupt("sliding window with no short-term reference to remove");
        oldest->short_ref = false;
        ++stats_[kSlidingWindowRemovals];
      }
    } else {
      const int curr_pic_num = h.frame_num;
      for (const Mmco& m : h.mmco) {
        ++stats_[kMmco1 + m.op - 1];
        switch (m.op) {
          case 1: {
            PicturePtr p = ShortByPicNum(curr_pic_num - m.diff);
            if (!p) throw Corrupt("MMCO 1 names no short-term reference");
            p->short_ref = false;
            break;
          }
          case 2: {
            PicturePtr p = LongByIdx(m.long_num);
            if (!p) throw Corrupt("MMCO 2 names no long-term reference");
            p->long_ref = false;
            break;
          }
          case 3: {
            PicturePtr p = ShortByPicNum(curr_pic_num - m.diff);
            if (!p) throw Corrupt("MMCO 3 names no short-term reference");
            if (m.long_idx > max_long_idx_) throw Corrupt("MMCO 3 past MaxLongTermFrameIdx");
            PicturePtr old = LongByIdx(m.long_idx);
            if (old && old != p) old->long_ref = false;
            p->short_ref = false;
            p->long_ref = true;
            p->long_idx = m.long_idx;
            ++stats_[kLongTermRefs];
            break;
          }
          case 4:
            max_long_idx_ = m.max_idx - 1;
            for (auto& r : dpb_)
              if (r->long_ref && r->long_idx > max_long_idx_) r->long_ref = false;
            break;
          case 5:
            for (auto& r : dpb_) r->short_ref = r->long_ref = false;
            max_long_idx_ = -1;
            mmco5 = true;
            break;
          case 6: {
            if (m.long_idx > max_long_idx_) throw Corrupt("MMCO 6 past MaxLongTermFrameIdx");
            PicturePtr old = LongByIdx(m.long_idx);
            if (old) old->long_ref = false;
            cur_->long_ref = true;
            cur_->long_idx = m.long_idx;
            current_long = true;
            ++stats_[kLongTermRefs];
            break;
          }
        }
      }
    }
    Prune();
    if (!current_long) cur_->short_ref = true;
    if (mmco5) {
      cur_->frame_num = 0;
      cur_->mmco_reset = mmco_reset_ = true;  // FFmpeg's MMCO_RESET: this picture and the next one
      std::fill(std::begin(last_pocs_), std::end(last_pocs_), kNoPoc);
    }
    dpb_.push_back(cur_);
    int count = 0;
    for (auto& r : dpb_) count += r->short_ref || r->long_ref;
    if (count > cur_max_refs_) throw Corrupt("more reference frames than max_num_ref_frames");
    return mmco5;
  }

  // ---- reference lists (8.2.4)
  void BuildRefLists(const Header& h) {
    ref_list_[0].clear();
    ref_list_[1].clear();
    if (h.type == 2) return;
    UpdateWraps(h.frame_num);
    std::vector<PicturePtr> shorts, longs;
    for (auto& r : dpb_) {
      if (r->short_ref) shorts.push_back(r);
      if (r->long_ref) longs.push_back(r);
    }
    std::sort(longs.begin(), longs.end(),
              [](const PicturePtr& a, const PicturePtr& b) { return a->long_idx < b->long_idx; });
    std::vector<PicturePtr> init[2];
    if (h.type == 0) {  // P: by PicNum, descending
      std::sort(shorts.begin(), shorts.end(),
                [](const PicturePtr& a, const PicturePtr& b) { return a->frame_num_wrap > b->frame_num_wrap; });
      init[0] = shorts;
    } else {  // B (8.2.4.2.3): by picture order count, those before the current picture first in list 0
      std::vector<PicturePtr> before, after;
      for (auto& r : shorts) (r->poc <= cur_->poc ? before : after).push_back(r);
      std::sort(before.begin(), before.end(), [](const PicturePtr& a, const PicturePtr& b) { return a->poc > b->poc; });
      std::sort(after.begin(), after.end(), [](const PicturePtr& a, const PicturePtr& b) { return a->poc < b->poc; });
      init[0] = before;
      init[0].insert(init[0].end(), after.begin(), after.end());
      init[1] = after;
      init[1].insert(init[1].end(), before.begin(), before.end());
    }
    for (int l = 0; l < (h.type == 1 ? 2 : 1); ++l) init[l].insert(init[l].end(), longs.begin(), longs.end());
    if (h.type == 1 && init[1].size() > 1 && init[1] == init[0]) std::swap(init[1][0], init[1][1]);
    for (int l = 0; l < (h.type == 1 ? 2 : 1); ++l) {
      std::vector<PicturePtr>& list = init[l];
      const int num_ref = h.num_ref[l];
      if (static_cast<int>(list.size()) > num_ref) list.resize(num_ref);  // extra entries are discarded
      list.resize(num_ref + 1);  // empty entries, and one spare for the modification process
      int pred = h.frame_num, ref_idx = 0;
      const int max_pic_num = cur_max_frame_num_;
      for (const auto& [idc, value] : h.modifications[l]) {
        PicturePtr pic;
        bool is_long = false;
        int num = 0;
        if (idc < 2) {
          const int abs_diff = value + 1;
          if (abs_diff > max_pic_num) throw Corrupt("abs_diff_pic_num_minus1 out of range");
          int no_wrap = idc == 0 ? pred - abs_diff : pred + abs_diff;
          if (no_wrap < 0) no_wrap += max_pic_num;
          if (no_wrap >= max_pic_num) no_wrap -= max_pic_num;
          pred = no_wrap;
          num = no_wrap > h.frame_num ? no_wrap - max_pic_num : no_wrap;
          pic = ShortByPicNum(num);
        } else {
          is_long = true;
          num = value;
          pic = LongByIdx(value);
        }
        if (!pic) throw Corrupt("reference list modification names a missing picture");
        if (ref_idx >= num_ref) throw Corrupt("more reference list modifications than entries");
        for (int c = num_ref; c > ref_idx; --c) list[c] = list[c - 1];
        list[ref_idx++] = pic;
        int n = ref_idx;
        for (int c = ref_idx; c <= num_ref; ++c) {
          const PicturePtr& e = list[c];
          const bool same =
              e && (is_long ? (e->long_ref && e->long_idx == num) : (e->short_ref && e->frame_num_wrap == num));
          if (!same) list[n++] = list[c];
        }
      }
      list.resize(num_ref);
      ref_list_[l] = list;
      // FFmpeg keeps the lists of a picture's last slice for the co-located lookup, by frame_num.
      cur_->list_count[l] = num_ref;
      for (int i = 0; i < num_ref; ++i) cur_->list_frame_num[l][i] = list[i] ? list[i]->frame_num : -1;
    }
    if (h.type == 1) {
      if (!ref_list_[1][0] || !ref_list_[0][0]) throw Corrupt("a B slice with an empty reference list entry 0");
      if (!h.direct_spatial) {  // DistScaleFactor of each list 0 entry (8.4.1.2.3), as FFmpeg's get_scale_factor
        const int64_t poc1 = ref_list_[1][0]->poc;
        for (int i = 0; i < h.num_ref[0]; ++i) {
          dsf_[i] = 256;
          if (!ref_list_[0][i]) continue;
          const int64_t poc0 = ref_list_[0][i]->poc;
          const int td = Clip3(-128, 127, static_cast<int>(poc1 - poc0));
          if (td == 0 || ref_list_[0][i]->long_ref) continue;
          const int tb = Clip3(-128, 127, static_cast<int>(cur_->poc - poc0));
          const int tx = (16384 + (std::abs(td) >> 1)) / td;
          dsf_[i] = Clip3(-1024, 1023, (tb * tx + 32) >> 6);
        }
      }
    }
  }

  // ---- slice data (7.3.4)
  void SliceData(BitReader& br, const Header& h, const Pps& pps) {
    int qp = h.qp;
    int mb = h.first_mb;
    const int total = mb_width_ * mb_height_;
    bool more = true;
    if (mb >= total) throw Corrupt("first_mb_in_slice past the picture");
    cabac_ = pps.cabac;
    if (cabac_) {
      while (!br.Aligned()) {
        if (!br.Bit()) throw Corrupt("cabac_alignment_one_bit equal to 0");
      }
      InitContexts(h.qp, h.type == 2 ? 0 : 1 + h.cabac_init_idc);
      engine_.Start(&br);
      prev_qp_delta_ = 0;
      for (;;) {
        if (mb >= total) throw Corrupt("slice data past the picture");
        if (h.type != 2 && Dec((h.type == 1 ? 24 : 11) + SkipCtxInc(mb % mb_width_, mb / mb_width_))) {
          SkipMb(mb, qp);
          prev_qp_delta_ = 0;
        } else {
          Macroblock(br, h, pps, mb, &qp);
        }
        ++mb;
        if (engine_.Terminate()) break;  // end_of_slice_flag
      }
      next_mb_ = mb;
      return;
    }
    while (more) {
      if (h.type != 2) {
        const uint32_t run = br.Ue();
        if (run > static_cast<uint32_t>(total - mb)) throw Corrupt("mb_skip_run past the picture");
        if (run) ++stats_[kSkipRuns];
        for (uint32_t i = 0; i < run; ++i) SkipMb(mb++, qp);
        if (run) {
          more = br.MoreRbspData();
          if (!more) break;
        }
        if (mb >= total) throw Corrupt("slice data past the picture");
      }
      Macroblock(br, h, pps, mb++, &qp);
      more = br.MoreRbspData();
      if (more && mb >= total) throw Corrupt("slice data past the picture");
    }
    next_mb_ = mb;
  }

  // ---- CABAC (9.3): context states and the ctxIdxInc of the macroblock-level syntax elements
  void InitContexts(int slice_qp, int table) {
    const int q = Clip3(0, 51, slice_qp);
    for (int i = 0; i < 436; ++i) {
      const int pre = Clip3(1, 126, ((kCabacInit[table][i][0] * q) >> 4) + kCabacInit[table][i][1]);
      ctx_[i] = static_cast<uint8_t>(pre <= 63 ? (63 - pre) << 1 : ((pre - 64) << 1) | 1);
    }
  }

  int Dec(int ctx_idx) { return engine_.Decision(&ctx_[ctx_idx]); }

  int SkipCtxInc(int mbx, int mby) const {
    auto cond = [](const MbInfo* n) { return n && n->kind != kMbSkip; };
    return cond(MbAt(mbx - 1, mby)) + cond(MbAt(mbx, mby - 1));
  }

  // mb_type of an I macroblock (Table 9-36): prefix bins from ctxIdx 3 in I slices (its first by the neighbours), as
  // the suffix from 17 in P slices and from 32 in B slices.
  int CabacIntraType(bool i_slice, int mbx, int mby, int base = 17) {
    auto cond = [](const MbInfo* n) { return n && (n->kind == kMbI16x16 || n->kind == kMbPcm); };
    if (!Dec(i_slice ? 3 + cond(MbAt(mbx - 1, mby)) + cond(MbAt(mbx, mby - 1)) : base)) return 0;  // I_NxN
    if (engine_.Terminate()) return 25;                                                              // I_PCM
    int type = 1 + 12 * Dec(i_slice ? 6 : base + 1);
    if (Dec(i_slice ? 7 : base + 2)) type += 4 + 4 * Dec(i_slice ? 8 : base + 2);
    type += 2 * Dec(i_slice ? 9 : base + 3);
    return type + Dec(i_slice ? 10 : base + 3);
  }

  // The macroblock holding the picture's 4x4 block (bx, by), seen from the current macroblock (mbx, mby): itself,
  // or a neighbour available to it; nullptr where none is.
  const MbInfo* BlockMb(int bx, int by, int mbx, int mby) const {
    if (bx < 0 || by < 0 || (bx >> 2) >= mb_width_) return nullptr;
    if ((bx >> 2) == mbx && (by >> 2) == mby) return &mbs_[static_cast<size_t>(mby) * mb_width_ + mbx];
    return MbAt(bx >> 2, by >> 2);
  }

  // ---- neighbours
  const MbInfo* MbAt(int mbx, int mby) const {  // available: in the picture and in the current slice
    if (mbx < 0 || mby < 0 || mbx >= mb_width_ || mby >= mb_height_) return nullptr;
    const MbInfo& m = mbs_[static_cast<size_t>(mby) * mb_width_ + mbx];
    return m.slice == slice_ ? &m : nullptr;
  }

  // Availability of a neighbouring MB for intra prediction (constrained_intra_pred: intra MBs only).
  bool IntraAvailable(int mbx, int mby) const {
    const MbInfo* m = MbAt(mbx, mby);
    return m && (!slices_[slice_].constrained_intra || m->Intra());
  }

  struct Neighbour {
    bool available = false;
    int ref = -1, mvx = 0, mvy = 0;
  };

  // The motion in list `list` of the 4x4 block at picture block coordinates (bx, by), seen from the current MB.
  Neighbour Motion(int bx, int by, int cur_mbx, int cur_mby, int decoded_mask, int list = 0) const {
    Neighbour n;
    const int mbx = bx >> 2, mby = by >> 2;
    if (bx < 0 || by < 0 || mbx >= mb_width_ || mby >= mb_height_) return n;
    if (mbx == cur_mbx && mby == cur_mby) {
      if (!((decoded_mask >> ((by & 3) * 4 + (bx & 3))) & 1)) return n;
    } else {
      if (mby > cur_mby || (mby == cur_mby && mbx > cur_mbx)) return n;
      if (!MbAt(mbx, mby)) return n;
    }
    n.available = true;
    const size_t b = static_cast<size_t>(by) * mb_width_ * 4 + bx;
    n.ref = ref_[list][b];
    if (n.ref >= 0) n.mvx = mv_[list][2 * b], n.mvy = mv_[list][2 * b + 1];
    return n;
  }

  // Motion vector prediction (8.4.1.3) for the partition at block (x4, y4) of the MB, w4 blocks wide;
  // shape 1: 16x8, 2: 8x16 (their directional rules), 0: any other.
  void PredictMv(int mbx, int mby, int x4, int y4, int w4, int ref, int mask, int shape, int* px, int* py,
                 int list = 0) const {
    const int bx = mbx * 4 + x4, by = mby * 4 + y4;
    Neighbour a = Motion(bx - 1, by, mbx, mby, mask, list);
    Neighbour b = Motion(bx, by - 1, mbx, mby, mask, list);
    Neighbour c = Motion(bx + w4, by - 1, mbx, mby, mask, list);
    if (!c.available) c = Motion(bx - 1, by - 1, mbx, mby, mask, list);
    if (shape == 1) {  // 16x8
      if (y4 == 0 && b.ref == ref) return void((*px = b.mvx, *py = b.mvy));
      if (y4 != 0 && a.ref == ref) return void((*px = a.mvx, *py = a.mvy));
    } else if (shape == 2) {  // 8x16
      if (x4 == 0 && a.ref == ref) return void((*px = a.mvx, *py = a.mvy));
      if (x4 != 0 && c.ref == ref) return void((*px = c.mvx, *py = c.mvy));
    }
    if (!b.available && !c.available && a.available) b = a, c = a;
    const int matches = (a.ref == ref) + (b.ref == ref) + (c.ref == ref);
    if (matches == 1) {
      const Neighbour& m = a.ref == ref ? a : b.ref == ref ? b : c;
      *px = m.mvx, *py = m.mvy;
      return;
    }
    *px = Median(a.mvx, b.mvx, c.mvx);
    *py = Median(a.mvy, b.mvy, c.mvy);
  }

  void SetMotion(int mbx, int mby, int x4, int y4, int w4, int h4, int ref, int mvx, int mvy, int* mask,
                 int list = 0) {
    for (int y = y4; y < y4 + h4; ++y)
      for (int x = x4; x < x4 + w4; ++x) {
        const size_t b = static_cast<size_t>(mby * 4 + y) * mb_width_ * 4 + mbx * 4 + x;
        ref_[list][b] = static_cast<int8_t>(ref);
        refpic_[list][b] = ref >= 0 ? ref_list_[list][ref]->id : 0;
        mv_[list][2 * b] = static_cast<int16_t>(ref >= 0 ? mvx : 0);
        mv_[list][2 * b + 1] = static_cast<int16_t>(ref >= 0 ? mvy : 0);
        *mask |= 1 << (y * 4 + x);
      }
  }

  // ---- macroblocks
  void SkipMb(int addr, int qp) {
    const int mbx = addr % mb_width_, mby = addr / mb_width_;
    MbInfo& m = mbs_[addr];
    m = MbInfo();
    m.slice = slice_;
    m.kind = kMbSkip;
    m.qp = qp;
    m.b_slice = header_.type == 1;
    std::fill(std::begin(m.i4), std::end(m.i4), 2);
    if (header_.type == 1) {
      BDirectMb(addr, true);
      return;
    }
    if (ref_list_[0].empty() || !ref_list_[0][0]) throw Corrupt("P_Skip with an empty reference list");
    int mvx = 0, mvy = 0, mask = 0;
    const Neighbour a = Motion(mbx * 4 - 1, mby * 4, mbx, mby, 0), b = Motion(mbx * 4, mby * 4 - 1, mbx, mby, 0);
    if (a.available && b.available && !(a.ref == 0 && a.mvx == 0 && a.mvy == 0) &&
        !(b.ref == 0 && b.mvx == 0 && b.mvy == 0))
      PredictMv(mbx, mby, 0, 0, 4, 0, 0, 0, &mvx, &mvy);
    ++stats_[kPSkip];
    if (mvx || mvy) ++stats_[kSkipMvNonzero];
    SetMotion(mbx, mby, 0, 0, 4, 4, 0, mvx, mvy, &mask);
    SetMvd(mbx, mby, 0, 0, 4, 4, 0, 0);
    InterPredict(mbx, mby, 0, 0, 16, 16, 0, mvx, mvy);
  }

  // ref_idx_lX of the partition whose top-left 4x4 block is (x4, y4); cur_ref: the reference indices read so far
  // in the macroblock (CABAC's context), cur_direct: its direct blocks (B slices; nullptr in P slices).
  int ReadRefIdx(BitReader& br, int num_ref, int mbx, int mby, int x4, int y4, const int* cur_ref, int list = 0,
                 const uint8_t* cur_direct = nullptr) {
    int v = 0;
    if (num_ref > 1 && cabac_) {
      // refIdxZeroFlag's complement: the neighbouring partition's index above 0, where (in B slices) it is not
      // predicted in direct mode.
      auto cond = [&](int x, int y) {
        if (x >= 0 && y >= 0) return cur_ref[y * 4 + x] > 0 && !(cur_direct && cur_direct[y * 4 + x]);
        const int bx = mbx * 4 + x, by = mby * 4 + y;
        const size_t b = static_cast<size_t>(by) * mb_width_ * 4 + bx;
        return BlockMb(bx, by, mbx, mby) != nullptr && ref_[list][b] > 0 && !(cur_direct && direct_[b]);
      };
      int ctx = 54 + cond(x4 - 1, y4) + 2 * cond(x4, y4 - 1);
      while (Dec(ctx)) {
        if (++v >= 32) throw Corrupt("ref_idx_l0 above 31");
        ctx = v == 1 ? 58 : 59;
      }
    } else if (num_ref == 2) {
      v = !br.Bit();
    } else if (num_ref > 2) {
      v = static_cast<int>(std::min<uint32_t>(br.Ue(), 32));
    }
    if (v >= num_ref) throw Corrupt("ref_idx_l0 past num_ref_idx_l0_active");
    if (!ref_list_[list][v]) throw Corrupt("ref_idx_l0 names an empty reference list entry");
    if (v > 0) ++stats_[kRefIdxNonzero];
    return v;
  }

  // One component of mvd_l0 (comp 0: horizontal) of the partition whose top-left 4x4 block is (x4, y4).
  int ReadMvd(BitReader& br, int comp, int mbx, int mby, int x4, int y4, int list = 0) {
    if (!cabac_) return br.Se();
    auto abs_at = [&](int x, int y) -> int {
      const int bx = mbx * 4 + x, by = mby * 4 + y;
      if (!BlockMb(bx, by, mbx, mby)) return 0;
      return mvd_[list][2 * (static_cast<size_t>(by) * mb_width_ * 4 + bx) + comp];
    };
    const int base = comp ? 47 : 40, sum = abs_at(x4 - 1, y4) + abs_at(x4, y4 - 1);
    if (!Dec(base + (sum < 3 ? 0 : sum > 32 ? 2 : 1))) return 0;
    int v = 1, ctx = base + 3;
    while (v < 9 && Dec(ctx)) {
      ++v;
      if (ctx < base + 6) ++ctx;
    }
    if (v >= 9) {  // UEG3's Exp-Golomb suffix
      int k = 3;
      while (engine_.Bypass()) {
        v += 1 << k;
        if (++k > 24) throw Corrupt("mvd_l0 suffix longer than 24 bits");
      }
      while (k--) v += engine_.Bypass() << k;
      ++stats_[kCabacMvdEscapes];
    }
    return engine_.Bypass() ? -v : v;
  }

  // The absolute mvd components of a partition, for CABAC's mvd contexts (at most 70, as their sums are compared
  // with 3 and 32).
  void SetMvd(int mbx, int mby, int x4, int y4, int w4, int h4, int dx, int dy, int list = 0) {
    for (int y = y4; y < y4 + h4; ++y)
      for (int x = x4; x < x4 + w4; ++x) {
        const size_t b = static_cast<size_t>(mby * 4 + y) * mb_width_ * 4 + mbx * 4 + x;
        mvd_[list][2 * b] = static_cast<uint8_t>(std::min(std::abs(dx), 70));
        mvd_[list][2 * b + 1] = static_cast<uint8_t>(std::min(std::abs(dy), 70));
      }
  }

  void Macroblock(BitReader& br, const Header& h, const Pps& pps, int addr, int* qp) {
    MbInfo& m = mbs_[addr];
    m = MbInfo();
    m.slice = slice_;
    std::fill(std::begin(m.i4), std::end(m.i4), 2);
    m.b_slice = h.type == 1;
    const int mbx = addr % mb_width_, mby = addr / mb_width_;
    const bool p_slice = h.type == 0, b_slice = h.type == 1;
    int mb_type = 0;
    bool intra = h.type == 2;
    if (cabac_) {
      if (p_slice && !Dec(14)) {
        mb_type = !Dec(15) ? 3 * Dec(16) : 2 - Dec(17);  // P_L0_16x16, P_8x8; P_L0_L0_8x16, P_L0_L0_16x8 (Table 9-37)
      } else if (b_slice && (mb_type = CabacBType(mbx, mby)) >= 0) {
      } else {
        intra = true;
        mb_type = CabacIntraType(h.type == 2, mbx, mby, b_slice ? 32 : 17);
      }
    } else {
      const uint32_t v = br.Ue(), first_intra = p_slice ? 5 : b_slice ? 23 : 0;
      if (v > first_intra + 25)
        throw Corrupt(p_slice ? "mb_type above 30 in a P slice" : b_slice ? "mb_type above 48 in a B slice"
                                                                          : "mb_type above 25 in an I slice");
      intra = v >= first_intra;
      mb_type = static_cast<int>(intra ? v - first_intra : v);
    }
    if (!intra) {
      if (b_slice) {
        BInterMb(br, h, pps, addr, mb_type, qp);
      } else {
        InterMb(br, h, pps, addr, mb_type, qp);
      }
      return;
    }
    if (p_slice) ++stats_[kIntraInP];
    if (b_slice) ++stats_[kIntraInB];
    if (mb_type == 25) {
      PcmMb(br, addr, *qp);
      return;
    }
    IntraMb(br, pps, addr, mb_type, qp);
  }

  void PcmMb(BitReader& br, int addr, int qp) {
    const int mbx = addr % mb_width_, mby = addr / mb_width_;
    MbInfo& m = mbs_[addr];
    m.kind = kMbPcm;
    m.qp = qp;
    m.cbp = 0x2F;  // as CABAC's contexts see I_PCM: every luma 8x8 block and the chroma AC coded
    m.dc = 7;
    std::fill(std::begin(m.nz), std::end(m.nz), 16);
    ++stats_[kIPcm];
    if (cabac_) ++stats_[kCabacPcm];
    while (!br.Aligned()) {
      if (br.Bit()) throw Corrupt("pcm_alignment_zero_bit set");
    }
    for (int y = 0; y < 16; ++y)
      for (int x = 0; x < 16; ++x) cur_->y[static_cast<size_t>(mby * 16 + y) * width_ + mbx * 16 + x] = br.Bits(8);
    for (int c = 1; c <= 2; ++c)
      for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x)
          cur_->Plane(c)[static_cast<size_t>(mby * 8 + y) * (width_ / 2) + mbx * 8 + x] = br.Bits(8);
    int mask = 0;
    SetMotion(mbx, mby, 0, 0, 4, 4, -1, 0, 0, &mask);
    SetMvd(mbx, mby, 0, 0, 4, 4, 0, 0);
    if (cabac_) {
      engine_.Start(&br);  // 9.3.1.2: the engine starts again after the samples
      prev_qp_delta_ = 0;
    }
  }

  void ReadQpDelta(BitReader& br, int* qp) {
    int delta = 0;
    if (cabac_) {
      int k = 0;
      if (Dec(60 + (prev_qp_delta_ != 0))) {  // the previous macroblock's mb_qp_delta in decoding order
        k = 1;
        for (int ctx = 62; Dec(ctx); ctx = 63) {
          if (++k > 52) throw Corrupt("mb_qp_delta out of range");
        }
      }
      delta = (k & 1) ? (k + 1) / 2 : -(k / 2);
    } else {
      delta = br.Se();
    }
    if (delta < -26 || delta > 25) throw Corrupt("mb_qp_delta out of range");
    prev_qp_delta_ = delta;
    int q = *qp + delta;
    if (q < 0 || q > 51) {
      q = (q + 52) % 52;
      ++stats_[kQpWraps];
    }
    *qp = q;
  }

  int ReadIntraMode(BitReader& br, int pred) {  // prev_intra4x4/8x8_pred_mode_flag, rem_intra4x4/8x8_pred_mode
    if (cabac_ ? Dec(68) : br.Bit()) return pred;
    int rem = 0;
    if (cabac_) {
      for (int k = 0; k < 3; ++k) rem |= Dec(69) << k;  // FL: the least significant bin first
    } else {
      rem = br.Bits(3);
    }
    return rem < pred ? rem : rem + 1;
  }

  int ReadChromaMode(BitReader& br, int mbx, int mby) {
    int mode = 0;
    if (cabac_) {
      auto cond = [](const MbInfo* n) { return n && n->chroma_mode != 0; };  // 0 in inter and I_PCM macroblocks
      if (Dec(64 + cond(MbAt(mbx - 1, mby)) + cond(MbAt(mbx, mby - 1))))
        mode = !Dec(67) ? 1 : Dec(67) ? 3 : 2;
    } else {
      const uint32_t v = br.Ue();
      if (v > 3) throw Corrupt("intra_chroma_pred_mode above 3");
      mode = static_cast<int>(v);
    }
    ++stats_[kChromaMode0 + mode];
    return mode;
  }

  // coded_block_pattern: luma in bits 0-3, chroma in bits 4-5.
  int ReadCbp(BitReader& br, int mbx, int mby, bool intra) {
    if (!cabac_) {
      const uint32_t code = br.Ue();
      if (code > 47) throw Corrupt("coded_block_pattern above 47");
      return intra ? kCbpIntra[code] : kCbpInter[code];
    }
    const MbInfo* a = MbAt(mbx - 1, mby);
    const MbInfo* b = MbAt(mbx, mby - 1);
    int cbp = 0;
    for (int b8 = 0; b8 < 4; ++b8) {  // condTermFlagN: the neighbouring 8x8 block coded without coefficients
      const int ca = (b8 & 1) ? !((cbp >> (b8 - 1)) & 1) : a && a->kind != kMbPcm && !((a->cbp >> (b8 + 1)) & 1);
      const int cb = (b8 & 2) ? !((cbp >> (b8 - 2)) & 1) : b && b->kind != kMbPcm && !((b->cbp >> (b8 + 2)) & 1);
      cbp |= Dec(73 + ca + 2 * cb) << b8;
    }
    auto cond = [](const MbInfo* n, int bin) { return n && (n->cbp >> 4) > bin; };  // 0x2F in I_PCM
    if (Dec(77 + cond(a, 0) + 2 * cond(b, 0))) cbp |= (1 + Dec(81 + cond(a, 1) + 2 * cond(b, 1))) << 4;
    return cbp;
  }

  bool ReadTransform8x8(BitReader& br, int mbx, int mby) {
    if (!cabac_) return br.Bit();
    auto cond = [](const MbInfo* n) { return n && n->t8; };
    return Dec(399 + cond(MbAt(mbx - 1, mby)) + cond(MbAt(mbx, mby - 1)));
  }

  void IntraMb(BitReader& br, const Pps& pps, int addr, int mb_type, int* qp) {
    const int mbx = addr % mb_width_, mby = addr / mb_width_;
    MbInfo& m = mbs_[addr];
    int cbp_luma = 0, cbp_chroma = 0, i16_mode = 0;
    int modes[16];
    if (mb_type == 0) {
      m.kind = kMbI4x4;
      ++stats_[kINxN];
      if (pps.transform_8x8) m.t8 = ReadTransform8x8(br, mbx, mby);
      const int n = m.t8 ? 4 : 16;
      if (m.t8) ++stats_[kI8x8];
      for (int blk = 0; blk < n; ++blk) {
        const int x4 = m.t8 ? (blk & 1) * 2 : ((blk >> 2) & 1) * 2 + (blk & 1);
        const int y4 = m.t8 ? (blk >> 1) * 2 : (blk >> 3) * 2 + ((blk >> 1) & 1);
        // Predicted mode: min of the modes of the 4x4 blocks left of and above the block's top-left one, DC (2)
        // where one is unavailable (8.3.1.1, 8.3.2.1).
        const int a = NeighbourI4Mode(mbx, mby, x4 - 1, y4, m), b = NeighbourI4Mode(mbx, mby, x4, y4 - 1, m);
        const int mode = ReadIntraMode(br, (a < 0 || b < 0) ? 2 : std::min(a, b));
        for (int k = 0; k < (m.t8 ? 4 : 1); ++k) m.i4[(y4 + (k >> 1)) * 4 + x4 + (k & 1)] = static_cast<int8_t>(mode);
        modes[blk] = mode;
        ++stats_[(m.t8 ? kI8Mode0 : kI4Mode0) + mode];
      }
    } else {
      m.kind = kMbI16x16;
      ++stats_[kI16x16];
      i16_mode = (mb_type - 1) % 4;
      cbp_chroma = ((mb_type - 1) / 4) % 3;
      cbp_luma = mb_type >= 13 ? 15 : 0;
      ++stats_[kI16Mode0 + i16_mode];
    }
    const int chroma_mode = ReadChromaMode(br, mbx, mby);
    m.chroma_mode = static_cast<uint8_t>(chroma_mode);
    if (m.kind == kMbI4x4) {
      const int cbp = ReadCbp(br, mbx, mby, true);
      cbp_luma = cbp & 15;
      cbp_chroma = cbp >> 4;
    }
    m.cbp = static_cast<uint8_t>(cbp_luma | cbp_chroma << 4);
    int mask = 0;
    SetMotion(mbx, mby, 0, 0, 4, 4, -1, 0, 0, &mask);
    SetMvd(mbx, mby, 0, 0, 4, 4, 0, 0);
    Coefficients c;
    if (cbp_luma || cbp_chroma || m.kind == kMbI16x16) {
      ReadQpDelta(br, qp);
      Residual(br, pps, addr, *qp, &c);
    } else {
      prev_qp_delta_ = 0;
    }
    m.qp = *qp;
    // Reconstruction.
    if (m.kind == kMbI4x4 && m.t8) {
      for (int b8 = 0; b8 < 4; ++b8) {
        Intra8x8(mbx, mby, b8, modes[b8]);
        AddResidual8x8(cur_->y.data(), width_, mbx * 16 + (b8 & 1) * 8, mby * 16 + (b8 >> 1) * 8, c.luma8[b8]);
      }
    } else if (m.kind == kMbI4x4) {
      for (int blk = 0; blk < 16; ++blk) {
        const int x4 = ((blk >> 2) & 1) * 2 + (blk & 1), y4 = (blk >> 3) * 2 + ((blk >> 1) & 1);
        Intra4x4(mbx, mby, x4, y4, blk, modes[blk]);
        AddResidual(cur_->y.data(), width_, mbx * 16 + x4 * 4, mby * 16 + y4 * 4, c.luma[y4 * 4 + x4],
                    m.nz[y4 * 4 + x4] > 0);
      }
    } else {
      Intra16x16(mbx, mby, i16_mode);
      for (int b = 0; b < 16; ++b)
        AddResidual(cur_->y.data(), width_, mbx * 16 + (b & 3) * 4, mby * 16 + (b >> 2) * 4, c.luma[b],
                    m.nz[b] > 0 || c.luma[b][0] != 0);
    }
    IntraChroma(mbx, mby, chroma_mode);
    AddChroma(mbx, mby, c.chroma, addr);
  }

  int NeighbourI4Mode(int mbx, int mby, int x4, int y4, const MbInfo& cur) const {
    if (x4 >= 0 && y4 >= 0) return cur.i4[y4 * 4 + x4];
    const int nx = x4 < 0 ? mbx - 1 : mbx, ny = y4 < 0 ? mby - 1 : mby;
    const MbInfo* n = MbAt(nx, ny);
    if (!n) return -1;
    if (!n->Intra() && slices_[slice_].constrained_intra) return -1;
    if (n->kind != kMbI4x4) return 2;
    return n->i4[((y4 + 4) & 3) * 4 + ((x4 + 4) & 3)];  // I_NxN with the 8x8 transform: its 8x8 block's mode
  }

  void InterMb(BitReader& br, const Header& h, const Pps& pps, int addr, int mb_type, int* qp) {
    const int mbx = addr % mb_width_, mby = addr / mb_width_;
    MbInfo& m = mbs_[addr];
    m.kind = kMbInter;
    if (ref_list_[0].empty()) throw Corrupt("inter macroblock with an empty reference list");
    int mask = 0, cur_ref[16];
    std::fill(std::begin(cur_ref), std::end(cur_ref), 0);
    static const int kStat[5] = {kP16x16, kP16x8, kP8x16, kP8x8, kP8x8Ref0};
    ++stats_[kStat[mb_type]];
    m.shape = static_cast<uint8_t>(std::min(mb_type, 3));
    bool all_8x8 = true;  // no partition smaller than 8x8: the 8x8 transform may be chosen
    if (mb_type < 3) {
      const int parts = mb_type == 0 ? 1 : 2;
      int refs[2] = {0, 0}, mvd[2][2], geo[2][4];
      for (int p = 0; p < parts; ++p) {
        const int x4 = mb_type == 2 ? 2 * p : 0, y4 = mb_type == 1 ? 2 * p : 0;
        const int w4 = mb_type == 2 ? 2 : 4, h4 = mb_type == 1 ? 2 : 4;
        geo[p][0] = x4, geo[p][1] = y4, geo[p][2] = w4, geo[p][3] = h4;
        refs[p] = ReadRefIdx(br, h.num_ref[0], mbx, mby, x4, y4, cur_ref);
        for (int y = y4; y < y4 + h4; ++y)
          for (int x = x4; x < x4 + w4; ++x) cur_ref[y * 4 + x] = refs[p];
      }
      for (int p = 0; p < parts; ++p) {
        mvd[p][0] = ReadMvd(br, 0, mbx, mby, geo[p][0], geo[p][1]);
        mvd[p][1] = ReadMvd(br, 1, mbx, mby, geo[p][0], geo[p][1]);
        SetMvd(mbx, mby, geo[p][0], geo[p][1], geo[p][2], geo[p][3], mvd[p][0], mvd[p][1]);
      }
      for (int p = 0; p < parts; ++p) {
        const int x4 = geo[p][0], y4 = geo[p][1], w4 = geo[p][2], h4 = geo[p][3];
        int px, py;
        PredictMv(mbx, mby, x4, y4, w4, refs[p], mask, mb_type, &px, &py);
        const int mvx = px + mvd[p][0], mvy = py + mvd[p][1];
        SetMotion(mbx, mby, x4, y4, w4, h4, refs[p], mvx, mvy, &mask);
        InterPredict(mbx, mby, x4 * 4, y4 * 4, w4 * 4, h4 * 4, refs[p], mvx, mvy);
      }
    } else {
      int sub[4], refs[4] = {0, 0, 0, 0};
      for (int s = 0; s < 4; ++s) {
        int t = 0;
        if (cabac_) {
          t = Dec(21) ? 0 : !Dec(22) ? 1 : Dec(23) ? 2 : 3;  // Table 9-38
        } else {
          const uint32_t v = br.Ue();
          if (v > 3) throw Corrupt("sub_mb_type above 3 in a P slice");
          t = static_cast<int>(v);
        }
        sub[s] = t;
        all_8x8 = all_8x8 && t == 0;
        ++stats_[kSub8x8 + sub[s]];
      }
      for (int s = 0; s < 4; ++s) {
        const int sx = (s & 1) * 2, sy = (s >> 1) * 2;
        refs[s] = mb_type == 4 ? 0 : ReadRefIdx(br, h.num_ref[0], mbx, mby, sx, sy, cur_ref);
        for (int k = 0; k < 4; ++k) cur_ref[(sy + (k >> 1)) * 4 + sx + (k & 1)] = refs[s];
      }
      if (!ref_list_[0][0]) throw Corrupt("P_8x8ref0 with an empty reference list");
      int mvd[4][4][2];
      for (int s = 0; s < 4; ++s) {
        const int sx = (s & 1) * 2, sy = (s >> 1) * 2;
        const int n = sub[s] == 0 ? 1 : sub[s] == 3 ? 4 : 2;
        const int w4 = (sub[s] == 0 || sub[s] == 1) ? 2 : 1, h4 = (sub[s] == 0 || sub[s] == 2) ? 2 : 1;
        for (int k = 0; k < n; ++k) {
          const int x4 = sx + (w4 == 1 ? (k & 1) : 0), y4 = sy + (h4 == 1 ? (sub[s] == 3 ? k >> 1 : k) : 0);
          mvd[s][k][0] = ReadMvd(br, 0, mbx, mby, x4, y4);
          mvd[s][k][1] = ReadMvd(br, 1, mbx, mby, x4, y4);
          SetMvd(mbx, mby, x4, y4, w4, h4, mvd[s][k][0], mvd[s][k][1]);
        }
      }
      for (int s = 0; s < 4; ++s) {
        const int sx = (s & 1) * 2, sy = (s >> 1) * 2;
        const int n = sub[s] == 0 ? 1 : sub[s] == 3 ? 4 : 2;
        const int w4 = (sub[s] == 0 || sub[s] == 1) ? 2 : 1, h4 = (sub[s] == 0 || sub[s] == 2) ? 2 : 1;
        for (int k = 0; k < n; ++k) {
          const int x4 = sx + (w4 == 1 ? (k & 1) : 0), y4 = sy + (h4 == 1 ? (sub[s] == 3 ? k >> 1 : k) : 0);
          int px, py;
          PredictMv(mbx, mby, x4, y4, w4, refs[s], mask, 0, &px, &py);
          const int mvx = px + mvd[s][k][0], mvy = py + mvd[s][k][1];
          SetMotion(mbx, mby, x4, y4, w4, h4, refs[s], mvx, mvy, &mask);
          InterPredict(mbx, mby, x4 * 4, y4 * 4, w4 * 4, h4 * 4, refs[s], mvx, mvy);
        }
      }
    }
    InterResidual(br, pps, addr, qp, all_8x8);
  }

  // The residual of an inter macroblock: coded_block_pattern, transform_size_8x8_flag where all_8x8 allows it,
  // mb_qp_delta and the levels, added to the prediction.
  void InterResidual(BitReader& br, const Pps& pps, int addr, int* qp, bool all_8x8) {
    const int mbx = addr % mb_width_, mby = addr / mb_width_;
    MbInfo& m = mbs_[addr];
    const int cbp = ReadCbp(br, mbx, mby, false);
    const int cbp_luma = cbp & 15, cbp_chroma = cbp >> 4;
    m.cbp = static_cast<uint8_t>(cbp);
    if (cbp_luma && pps.transform_8x8 && all_8x8) {
      m.t8 = ReadTransform8x8(br, mbx, mby);
      if (m.t8) ++stats_[kTransform8x8Inter];
    }
    Coefficients c;
    if (cbp_luma || cbp_chroma) {
      ReadQpDelta(br, qp);
      Residual(br, pps, addr, *qp, &c);
    } else {
      prev_qp_delta_ = 0;
    }
    m.qp = *qp;
    if (m.t8) {
      for (int b8 = 0; b8 < 4; ++b8)
        AddResidual8x8(cur_->y.data(), width_, mbx * 16 + (b8 & 1) * 8, mby * 16 + (b8 >> 1) * 8, c.luma8[b8]);
    } else {
      for (int b = 0; b < 16; ++b)
        AddResidual(cur_->y.data(), width_, mbx * 16 + (b & 3) * 4, mby * 16 + (b >> 2) * 4, c.luma[b], m.nz[b] > 0);
    }
    AddChroma(mbx, mby, c.chroma, addr);
  }

  // ---- B macroblocks
  // The prediction of each partition of B mb_type 1-21 (Table 7-14): bit 0 list 0, bit 1 list 1.
  static constexpr uint8_t kBPred[22][2] = {{0, 0}, {1, 0}, {2, 0}, {3, 0}, {1, 1}, {1, 1}, {2, 2}, {2, 2},
                                            {1, 2}, {1, 2}, {2, 1}, {2, 1}, {1, 3}, {1, 3}, {2, 3}, {2, 3},
                                            {3, 1}, {3, 1}, {3, 2}, {3, 2}, {3, 3}, {3, 3}};
  // sub_mb_type in B slices (Table 7-18): the prediction (0: direct) and the partition (0 8x8, 1 8x4, 2 4x8, 3 4x4).
  static constexpr uint8_t kBSubPred[13] = {0, 1, 2, 3, 1, 1, 2, 2, 3, 3, 1, 2, 3};
  static constexpr uint8_t kBSubShape[13] = {0, 0, 0, 0, 1, 2, 1, 2, 1, 2, 3, 3, 3};

  // mb_type in B slices (FFmpeg's decode_cabac_mb_type_b): 0-22, or -1 where the prefix announces an intra type.
  int CabacBType(int mbx, int mby) {
    auto cond = [](const MbInfo* n) { return n && n->kind != kMbSkip && !n->direct16; };
    if (!Dec(27 + cond(MbAt(mbx - 1, mby)) + cond(MbAt(mbx, mby - 1)))) return 0;  // B_Direct_16x16
    if (!Dec(30)) return 1 + Dec(32);                                                 // B_L0_16x16, B_L1_16x16
    int bits = Dec(31) << 3;
    bits |= Dec(32) << 2;
    bits |= Dec(32) << 1;
    bits |= Dec(32);
    if (bits < 8) return bits + 3;
    if (bits == 13) return -1;
    if (bits == 14) return 11;
    if (bits == 15) return 22;
    return ((bits << 1) | Dec(32)) - 4;
  }

  int CabacBSubType() {  // sub_mb_type in B slices (FFmpeg's decode_cabac_b_mb_sub_type)
    if (!Dec(36)) return 0;
    if (!Dec(37)) return 1 + Dec(39);
    int type = 3;
    if (Dec(38)) {
      if (Dec(39)) return 11 + Dec(39);
      type += 4;
    }
    type += 2 * Dec(39);
    return type + Dec(39);
  }

  // Direct prediction (8.4.1.2) of a macroblock's 16 4x4 blocks, with the partition FFmpeg's
  // pred_spatial_direct_motion / pred_temp_direct_motion give it (which decides the block sizes it predicts with).
  struct DirectMotion {
    int ref[2][16];
    int mv[2][16][2];
    int shape;     // of a B_Skip / B_Direct_16x16 macroblock, as MbInfo::shape
    bool sub4[4];  // in shape 3 (and in B_8x8), an 8x8 block predicted in 4x4 blocks
  };

  void Direct(int mbx, int mby, bool b8x8, DirectMotion* d) {
    const Picture& col = *ref_list_[1][0];
    const size_t col_mb = static_cast<size_t>(mby) * mb_width_ + mbx;
    const bool col_intra = col.intra[col_mb];
    auto col_block = [&](int k) {  // the co-located 4x4 block, or the corner of its 8x8 block
      int x4 = k & 3, y4 = k >> 2;
      if (sps_direct_8x8_) x4 = (x4 >> 1) * 3, y4 = (y4 >> 1) * 3;
      return static_cast<size_t>(mby * 4 + y4) * mb_width_ * 4 + mbx * 4 + x4;
    };
    // FFmpeg types the macroblock 16x16 where the co-located one is 16x16 or intra, as its 16x8 / 8x16 partitions,
    // else 8x8 (8x8 blocks under direct_8x8_inference_flag, else 4x4 blocks).
    d->shape = b8x8 ? 3 : col_intra ? 0 : col.shape[col_mb];
    for (bool& v : d->sub4) v = !sps_direct_8x8_;
    if (!header_.direct_spatial) {
      ++stats_[kTemporalDirectMbs];
      for (int k = 0; k < 16; ++k) {
        int ref0 = 0, mv0[2] = {0, 0}, mv1[2] = {0, 0};
        if (!col_intra) {
          const size_t cb = col_block(k);
          const int l = col.ref[0][cb] >= 0 ? 0 : 1, ref_col = col.ref[l][cb];
          const int mv_col[2] = {col.mv[l][2 * cb], col.mv[l][2 * cb + 1]};
          // The lowest list 0 index whose picture has the frame_num of the co-located block's reference (FFmpeg's
          // fill_colmap; 0 where none has).
          if (ref_col >= 0 && ref_col < col.list_count[l]) {
            for (int j = 0; j < header_.num_ref[0]; ++j)
              if (ref_list_[0][j] && ref_list_[0][j]->frame_num == col.list_frame_num[l][ref_col]) {
                ref0 = j;
                break;
              }
          }
          for (int c = 0; c < 2; ++c) {
            mv0[c] = (dsf_[ref0] * mv_col[c] + 128) >> 8;
            mv1[c] = mv0[c] - mv_col[c];
          }
        }
        d->ref[0][k] = ref0, d->ref[1][k] = 0;
        for (int c = 0; c < 2; ++c) d->mv[0][k][c] = mv0[c], d->mv[1][k][c] = mv1[c];
      }
      return;
    }
    ++stats_[kSpatialDirectMbs];
    int ref[2], mv[2][2] = {{0, 0}, {0, 0}};
    const int bx = mbx * 4, by = mby * 4;
    auto min_positive = [](int x, int y) { return x >= 0 && y >= 0 ? std::min(x, y) : std::max(x, y); };
    for (int l = 0; l < 2; ++l) {
      const Neighbour a = Motion(bx - 1, by, mbx, mby, 0, l), b = Motion(bx, by - 1, mbx, mby, 0, l);
      Neighbour c = Motion(bx + 4, by - 1, mbx, mby, 0, l);
      if (!c.available) c = Motion(bx - 1, by - 1, mbx, mby, 0, l);
      ref[l] = min_positive(a.ref, min_positive(b.ref, c.ref));
      if (ref[l] >= 0) PredictMv(mbx, mby, 0, 0, 4, ref[l], 0, 0, &mv[l][0], &mv[l][1], l);
    }
    const bool zero = ref[0] < 0 && ref[1] < 0;  // both lists from reference 0 with zero vectors
    if (zero) ref[0] = ref[1] = 0;
    if (!b8x8 && !mv[0][0] && !mv[0][1] && !mv[1][0] && !mv[1][1]) d->shape = 0;
    const bool col_usable = !col_intra && !col.long_ref;
    int n = 0;
    for (int i8 = 0; i8 < 4; ++i8) {
      int m = 0;
      bool cond8 = false;
      for (int i4 = 0; i4 < 4; ++i4) {
        const int k = ((i8 >> 1) * 2 + (i4 >> 1)) * 4 + (i8 & 1) * 2 + (i4 & 1);
        const size_t cb = col_block(k);
        // colZeroFlag: the co-located block from its reference 0 of list 0 (or, unused, of list 1), moved by at most
        // one quarter sample.
        const int l = col.ref[0][cb] == 0 ? 0 : 1;
        cond8 = col_usable && (col.ref[0][cb] == 0 || (col.ref[0][cb] < 0 && col.ref[1][cb] == 0));
        const bool col_zero =
            cond8 && std::abs(col.mv[l][2 * cb]) <= 1 && std::abs(col.mv[l][2 * cb + 1]) <= 1;
        m += col_zero;
        for (int li = 0; li < 2; ++li) {
          d->ref[li][k] = ref[li];
          const bool z = zero || ref[li] < 0 || (ref[li] == 0 && col_zero);
          d->mv[li][k][0] = z ? 0 : mv[li][0];
          d->mv[li][k][1] = z ? 0 : mv[li][1];
        }
      }
      if (!sps_direct_8x8_ && cond8 && (m == 0 || m == 4)) d->sub4[i8] = false;
      n += m;
    }
    if (!b8x8 && (n == 0 || n == 16)) d->shape = 0;
  }

  void SetDirect(int mbx, int mby, int x4, int y4, int w4, int h4) {
    for (int y = y4; y < y4 + h4; ++y)
      for (int x = x4; x < x4 + w4; ++x) direct_[static_cast<size_t>(mby * 4 + y) * mb_width_ * 4 + mbx * 4 + x] = 1;
  }

  // The prediction of the block of w4 x h4 4x4 blocks at (x4, y4) from the motion set for its top-left one.
  void PredictFromMotion(int mbx, int mby, int x4, int y4, int w4, int h4) {
    const size_t b = static_cast<size_t>(mby * 4 + y4) * mb_width_ * 4 + mbx * 4 + x4;
    InterPredictB(mbx, mby, x4 * 4, y4 * 4, w4 * 4, h4 * 4, ref_[0][b], mv_[0][2 * b], mv_[0][2 * b + 1], ref_[1][b],
                  mv_[1][2 * b], mv_[1][2 * b + 1]);
  }

  // The prediction of 8x8 block i8 of a direct macroblock or direct sub-macroblock.
  void PredictDirect8x8(int mbx, int mby, const DirectMotion& d, int i8) {
    const int x4 = (i8 & 1) * 2, y4 = (i8 >> 1) * 2;
    if (!d.sub4[i8]) return PredictFromMotion(mbx, mby, x4, y4, 2, 2);
    for (int k = 0; k < 4; ++k) PredictFromMotion(mbx, mby, x4 + (k & 1), y4 + (k >> 1), 1, 1);
  }

  // B_Skip (skip) or B_Direct_16x16: the direct motion of the macroblock and its prediction.
  void BDirectMb(int addr, bool skip) {
    const int mbx = addr % mb_width_, mby = addr / mb_width_;
    MbInfo& m = mbs_[addr];
    DirectMotion d;
    Direct(mbx, mby, false, &d);
    m.shape = static_cast<uint8_t>(d.shape);
    for (int l = 0; l < 2; ++l) {
      int mask = 0;
      for (int k = 0; k < 16; ++k)
        SetMotion(mbx, mby, k & 3, k >> 2, 1, 1, d.ref[l][k], d.mv[l][k][0], d.mv[l][k][1], &mask, l);
      SetMvd(mbx, mby, 0, 0, 4, 4, 0, 0, l);
    }
    SetDirect(mbx, mby, 0, 0, 4, 4);
    ++stats_[skip ? kBSkip : kBDirect16x16];
    if (d.shape == 0) {
      PredictFromMotion(mbx, mby, 0, 0, 4, 4);
    } else if (d.shape == 1) {
      PredictFromMotion(mbx, mby, 0, 0, 4, 2);
      PredictFromMotion(mbx, mby, 0, 2, 4, 2);
    } else if (d.shape == 2) {
      PredictFromMotion(mbx, mby, 0, 0, 2, 4);
      PredictFromMotion(mbx, mby, 2, 0, 2, 4);
    } else {
      for (int i8 = 0; i8 < 4; ++i8) PredictDirect8x8(mbx, mby, d, i8);
    }
  }

  void BInterMb(BitReader& br, const Header& h, const Pps& pps, int addr, int mb_type, int* qp) {
    const int mbx = addr % mb_width_, mby = addr / mb_width_;
    MbInfo& m = mbs_[addr];
    m.kind = kMbInter;
    bool all_8x8 = true;  // no partition smaller than 8x8: the 8x8 transform may be chosen
    const uint8_t no_direct[16] = {};
    if (mb_type == 0) {
      m.direct16 = true;
      BDirectMb(addr, false);
      all_8x8 = sps_direct_8x8_;
    } else if (mb_type < 22) {
      const int parts = mb_type < 4 ? 1 : 2, shape = mb_type < 4 ? 0 : (mb_type & 1) ? 2 : 1;
      m.shape = static_cast<uint8_t>(shape);
      ++stats_[parts == 1 ? kB16x16 : shape == 1 ? kB16x8 : kB8x16];
      int geo[2][4], refs[2][2] = {{-1, -1}, {-1, -1}}, cur_ref[2][16], mvd[2][2][2] = {};
      std::fill(&cur_ref[0][0], &cur_ref[0][0] + 32, -1);
      for (int p = 0; p < parts; ++p) {
        geo[p][0] = shape == 2 ? 2 * p : 0, geo[p][1] = shape == 1 ? 2 * p : 0;
        geo[p][2] = shape == 2 ? 2 : 4, geo[p][3] = shape == 1 ? 2 : 4;
      }
      for (int l = 0; l < 2; ++l)
        for (int p = 0; p < parts; ++p) {
          if (!(kBPred[mb_type][p] >> l & 1)) continue;
          refs[l][p] = ReadRefIdx(br, h.num_ref[l], mbx, mby, geo[p][0], geo[p][1], cur_ref[l], l, no_direct);
          for (int y = geo[p][1]; y < geo[p][1] + geo[p][3]; ++y)
            for (int x = geo[p][0]; x < geo[p][0] + geo[p][2]; ++x) cur_ref[l][y * 4 + x] = refs[l][p];
        }
      for (int l = 0; l < 2; ++l)
        for (int p = 0; p < parts; ++p) {
          if (refs[l][p] < 0) continue;
          mvd[l][p][0] = ReadMvd(br, 0, mbx, mby, geo[p][0], geo[p][1], l);
          mvd[l][p][1] = ReadMvd(br, 1, mbx, mby, geo[p][0], geo[p][1], l);
          SetMvd(mbx, mby, geo[p][0], geo[p][1], geo[p][2], geo[p][3], mvd[l][p][0], mvd[l][p][1], l);
        }
      for (int l = 0; l < 2; ++l) {
        int mask = 0;
        for (int p = 0; p < parts; ++p) {
          int px = 0, py = 0;
          if (refs[l][p] >= 0)
            PredictMv(mbx, mby, geo[p][0], geo[p][1], geo[p][2], refs[l][p], mask, shape, &px, &py, l);
          SetMotion(mbx, mby, geo[p][0], geo[p][1], geo[p][2], geo[p][3], refs[l][p], px + mvd[l][p][0],
                    py + mvd[l][p][1], &mask, l);
        }
      }
      for (int p = 0; p < parts; ++p) {
        if (refs[0][p] >= 0 && refs[1][p] >= 0) ++stats_[kBiPartitions];
        PredictFromMotion(mbx, mby, geo[p][0], geo[p][1], geo[p][2], geo[p][3]);
      }
    } else {
      m.shape = 3;
      ++stats_[kB8x8];
      int sub[4];
      bool any_direct = false;
      uint8_t cur_direct[16] = {};
      for (int s = 0; s < 4; ++s) {
        int t = 0;
        if (cabac_) {
          t = CabacBSubType();
        } else {
          const uint32_t v = br.Ue();
          if (v > 12) throw Corrupt("sub_mb_type above 12 in a B slice");
          t = static_cast<int>(v);
        }
        sub[s] = t;
        static const int kSubStat[4] = {kBSub8x8, kBSub8x4, kBSub4x8, kBSub4x4};
        ++stats_[t == 0 ? kBSubDirect : kSubStat[kBSubShape[t]]];
        all_8x8 = all_8x8 && (t == 0 ? sps_direct_8x8_ : kBSubShape[t] == 0);
        if (t == 0) {
          any_direct = true;
          for (int k = 0; k < 4; ++k) cur_direct[((s >> 1) * 2 + (k >> 1)) * 4 + (s & 1) * 2 + (k & 1)] = 1;
        }
      }
      DirectMotion d;
      if (any_direct) Direct(mbx, mby, true, &d);
      int refs[2][4] = {{-1, -1, -1, -1}, {-1, -1, -1, -1}}, cur_ref[2][16];
      std::fill(&cur_ref[0][0], &cur_ref[0][0] + 32, -1);
      for (int l = 0; l < 2; ++l)
        for (int s = 0; s < 4; ++s) {
          if (!sub[s] || !(kBSubPred[sub[s]] >> l & 1)) continue;
          const int sx = (s & 1) * 2, sy = (s >> 1) * 2;
          refs[l][s] = ReadRefIdx(br, h.num_ref[l], mbx, mby, sx, sy, cur_ref[l], l, cur_direct);
          for (int k = 0; k < 4; ++k) cur_ref[l][(sy + (k >> 1)) * 4 + sx + (k & 1)] = refs[l][s];
        }
      int mvd[2][4][4][2] = {};
      auto part = [&](int s, int k, int* x4, int* y4, int* w4, int* h4) {
        const int shape = kBSubShape[sub[s]];
        *w4 = shape == 0 || shape == 1 ? 2 : 1, *h4 = shape == 0 || shape == 2 ? 2 : 1;
        *x4 = (s & 1) * 2 + (*w4 == 1 ? (k & 1) : 0);
        *y4 = (s >> 1) * 2 + (*h4 == 1 ? (shape == 3 ? k >> 1 : k) : 0);
        return shape == 0 ? 1 : shape == 3 ? 4 : 2;
      };
      for (int l = 0; l < 2; ++l)
        for (int s = 0; s < 4; ++s) {
          if (refs[l][s] < 0) continue;
          int x4, y4, w4, h4;
          const int n = part(s, 0, &x4, &y4, &w4, &h4);
          for (int k = 0; k < n; ++k) {
            part(s, k, &x4, &y4, &w4, &h4);
            mvd[l][s][k][0] = ReadMvd(br, 0, mbx, mby, x4, y4, l);
            mvd[l][s][k][1] = ReadMvd(br, 1, mbx, mby, x4, y4, l);
            SetMvd(mbx, mby, x4, y4, w4, h4, mvd[l][s][k][0], mvd[l][s][k][1], l);
          }
        }
      for (int l = 0; l < 2; ++l) {
        int mask = 0;
        for (int s = 0; s < 4; ++s) {
          const int sx = (s & 1) * 2, sy = (s >> 1) * 2;
          if (!sub[s]) {
            for (int k = 0; k < 4; ++k) {
              const int b = (sy + (k >> 1)) * 4 + sx + (k & 1);
              SetMotion(mbx, mby, b & 3, b >> 2, 1, 1, d.ref[l][b], d.mv[l][b][0], d.mv[l][b][1], &mask, l);
            }
            continue;
          }
          if (refs[l][s] < 0) {
            SetMotion(mbx, mby, sx, sy, 2, 2, -1, 0, 0, &mask, l);
            continue;
          }
          int x4, y4, w4, h4;
          const int n = part(s, 0, &x4, &y4, &w4, &h4);
          for (int k = 0; k < n; ++k) {
            part(s, k, &x4, &y4, &w4, &h4);
            int px, py;
            PredictMv(mbx, mby, x4, y4, w4, refs[l][s], mask, 0, &px, &py, l);
            SetMotion(mbx, mby, x4, y4, w4, h4, refs[l][s], px + mvd[l][s][k][0], py + mvd[l][s][k][1], &mask, l);
          }
        }
      }
      for (int s = 0; s < 4; ++s) {
        if (!sub[s]) {
          SetDirect(mbx, mby, (s & 1) * 2, (s >> 1) * 2, 2, 2);
          PredictDirect8x8(mbx, mby, d, s);
          continue;
        }
        int x4, y4, w4, h4;
        const int n = part(s, 0, &x4, &y4, &w4, &h4);
        for (int k = 0; k < n; ++k) {
          part(s, k, &x4, &y4, &w4, &h4);
          if (kBSubPred[sub[s]] == 3) ++stats_[kBiPartitions];
          PredictFromMotion(mbx, mby, x4, y4, w4, h4);
        }
      }
    }
    InterResidual(br, pps, addr, qp, all_8x8);
  }

  // ---- residual (7.3.5.3, 9.2)
  int TotalCoeffAt(int mbx, int mby, int comp, int x4, int y4) const {  // -1: unavailable
    const int w = comp == 0 ? 4 : 2;
    int nx = mbx, ny = mby;
    if (x4 < 0) nx -= 1, x4 += w;
    if (y4 < 0) ny -= 1, y4 += w;
    const MbInfo* n = MbAt(nx, ny);
    if (!n) return -1;
    return comp == 0 ? n->nz[y4 * 4 + x4] : n->nz[16 + (comp - 1) * 4 + y4 * 2 + x4];
  }

  int PredictNc(int mbx, int mby, int comp, int x4, int y4) const {
    const MbInfo& cur = mbs_[static_cast<size_t>(mby) * mb_width_ + mbx];
    const int w = comp == 0 ? 4 : 2;
    auto inner = [&](int x, int y) { return comp == 0 ? cur.nz[y * 4 + x] : cur.nz[16 + (comp - 1) * 4 + y * w + x]; };
    const int a = x4 > 0 ? inner(x4 - 1, y4) : TotalCoeffAt(mbx, mby, comp, x4 - 1, y4);
    const int b = y4 > 0 ? inner(x4, y4 - 1) : TotalCoeffAt(mbx, mby, comp, x4, y4 - 1);
    if (a >= 0 && b >= 0) return (a + b + 1) >> 1;
    if (a >= 0) return a;
    if (b >= 0) return b;
    return 0;
  }

  // One CAVLC block: the levels into coeff (in scan order, from start), its TotalCoeff returned.
  int ResidualBlock(BitReader& br, int nc, int start, int max_coeff, int* coeff) {
    int total = -1, trailing = 0;
    if (nc == -1) {
      for (int t = 0; t <= 4 && total < 0; ++t)
        for (int o = 0; o <= std::min(t, 3); ++o) {
          const int len = kChromaDcTokenLen[t * 4 + o];
          if (len && br.Peek(len) == kChromaDcTokenCode[t * 4 + o]) {
            total = t, trailing = o;
            br.Skip(len);
            break;
          }
        }
    } else {
      const int table = nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3;
      for (int t = 0; t <= 16 && total < 0; ++t)
        for (int o = 0; o <= std::min(t, 3); ++o) {
          const int len = kCoeffTokenLen[table][t * 4 + o];
          if (len && br.Peek(len) == kCoeffTokenCode[table][t * 4 + o]) {
            total = t, trailing = o;
            br.Skip(len);
            break;
          }
        }
    }
    if (total < 0) throw Corrupt("invalid coeff_token");
    if (total > max_coeff) throw Corrupt("coeff_token with more coefficients than the block holds");
    if (total == 0) return 0;
    int levels[16];
    int suffix_length = (total > 10 && trailing < 3) ? 1 : 0;
    for (int i = 0; i < total; ++i) {
      if (i < trailing) {
        levels[i] = br.Bit() ? -1 : 1;
        continue;
      }
      int prefix = 0;
      while (!br.Bit()) {
        if (++prefix > 25) throw Corrupt("level_prefix above 25");
      }
      if (prefix == 14) ++stats_[kLevelPrefix14];
      if (prefix >= 15) ++stats_[kLevelPrefix15];
      int code = std::min(15, prefix) << suffix_length;
      const int suffix_size = (prefix == 14 && suffix_length == 0) ? 4 : prefix >= 15 ? prefix - 3 : suffix_length;
      if (suffix_size) code += br.Bits(suffix_size);
      if (prefix >= 15 && suffix_length == 0) code += 15;
      if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
      if (i == trailing && trailing < 3) code += 2;
      levels[i] = (code & 1) ? (-code - 1) >> 1 : (code + 2) >> 1;
      if (suffix_length == 0) suffix_length = 1;
      if (std::abs(levels[i]) > (3 << (suffix_length - 1)) && suffix_length < 6) ++suffix_length;
    }
    int zeros_left = 0;
    if (total < max_coeff) {
      int tz = -1;
      if (nc == -1) {
        for (int z = 0; z <= 4 - total && tz < 0; ++z) {
          const int len = kChromaDcZerosLen[total - 1][z];
          if (len && br.Peek(len) == kChromaDcZerosCode[total - 1][z]) tz = z, br.Skip(len);
        }
      } else {
        for (int z = 0; z <= 16 - total && tz < 0; ++z) {
          const int len = kTotalZerosLen[total - 1][z];
          if (len && br.Peek(len) == kTotalZerosCode[total - 1][z]) tz = z, br.Skip(len);
        }
      }
      if (tz < 0) throw Corrupt("invalid total_zeros");
      zeros_left = tz;
    }
    if (total + zeros_left > max_coeff) throw Corrupt("total_zeros past the block");
    int runs[16];
    for (int i = 0; i < total - 1; ++i) {
      int run = 0;
      if (zeros_left > 0) {
        const int t = std::min(zeros_left, 7) - 1;
        run = -1;
        for (int r = 0; r <= std::min(zeros_left, 14) && run < 0; ++r) {
          const int len = kRunLen[t][r];
          if (len && br.Peek(len) == kRunCode[t][r]) run = r, br.Skip(len);
        }
        if (run < 0 || run > zeros_left) throw Corrupt("invalid run_before");
      }
      runs[i] = run;
      zeros_left -= run;
    }
    runs[total - 1] = zeros_left;
    int pos = -1;
    for (int i = total - 1; i >= 0; --i) {
      pos += runs[i] + 1;
      coeff[start + pos] = levels[i];
    }
    return total;
  }

  // One residual block's levels into coeff (scan order, from start; max_coeff of them), as CAVLC or CABAC codes
  // them; returns how many are nonzero (CAVLC: TotalCoeff). cat is ctxBlockCat (0 Intra16x16 DC, 1 its AC, 2 luma
  // 4x4, 3 chroma DC, 4 chroma AC, 5 luma 8x8); (x4, y4) the block in its component's 4x4 grid (comp 0: luma,
  // 1: Cb, 2: Cr).
  int ReadBlock(BitReader& br, int cat, int mbx, int mby, int comp, int x4, int y4, int max_coeff, int* coeff) {
    const int start = (cat == 1 || cat == 4) ? 1 : 0;
    if (!cabac_) return ResidualBlock(br, cat == 3 ? -1 : PredictNc(mbx, mby, comp, x4, y4), start, max_coeff, coeff);
    static const int kCbfOffset[5] = {0, 4, 8, 12, 16}, kSigOffset[5] = {0, 15, 29, 44, 47};
    static const int kAbsOffset[5] = {0, 10, 20, 30, 39};
    if (cat != 5) {  // coded_block_flag (an 8x8 block has none in 4:2:0: it is coded)
      const bool intra = mbs_[static_cast<size_t>(mby) * mb_width_ + mbx].Intra();
      const int inc =
          CbfCond(cat, mbx, mby, comp, x4, y4, intra, true) + 2 * CbfCond(cat, mbx, mby, comp, x4, y4, intra, false);
      if (!Dec(85 + kCbfOffset[cat] + inc)) return 0;
    }
    const int sig = cat == 5 ? 402 : 105 + kSigOffset[cat], last = cat == 5 ? 417 : 166 + kSigOffset[cat];
    const int abs = cat == 5 ? 426 : 227 + kAbsOffset[cat];
    int pos[64], n = 0;
    bool ended = false;
    for (int i = 0; i < max_coeff - 1 && !ended; ++i) {  // the significance map
      const int inc = cat == 5 ? kSig8x8[i] : cat == 3 ? std::min(i, 2) : i;
      if (Dec(sig + inc)) {
        pos[n++] = i;
        ended = Dec(last + (cat == 5 ? kLast8x8[i] : inc));
      }
    }
    if (!ended) pos[n++] = max_coeff - 1;
    int eq1 = 0, gt1 = 0;
    for (int k = n - 1; k >= 0; --k) {  // the levels, in reverse scan order
      int level = 1;
      if (Dec(abs + (gt1 ? 0 : std::min(4, 1 + eq1)))) {
        level = 2;
        const int ctx = abs + 5 + std::min(4 - (cat == 3), gt1);
        while (level < 15 && Dec(ctx)) ++level;
        if (level == 15) {  // coeff_abs_level_minus1 of 14 or more: UEG0's Exp-Golomb suffix
          int j = 0;
          while (engine_.Bypass()) {
            level += 1 << j;
            if (++j > 20) throw Corrupt("coeff_abs_level_minus1 suffix longer than 20 bits");
          }
          while (j--) level += engine_.Bypass() << j;
          ++stats_[kCabacLevelEscapes];
        }
        ++gt1;
      } else {
        ++eq1;
      }
      coeff[start + pos[k]] = engine_.Bypass() ? -level : level;
    }
    return n;
  }

  // condTermFlagN of coded_block_flag (9.3.3.1.1.9) for the block left of (left) or above the block: the
  // neighbouring block's flag as its nonzero count shows it, 1 in I_PCM, and where the neighbouring macroblock is
  // unavailable, 1 for an intra macroblock and 0 for an inter one.
  int CbfCond(int cat, int mbx, int mby, int comp, int x4, int y4, bool intra, bool left) const {
    const MbInfo* n;
    if (cat == 0 || cat == 3) {
      n = left ? MbAt(mbx - 1, mby) : MbAt(mbx, mby - 1);
    } else {
      const int w = comp ? 2 : 4;
      (left ? x4 : y4) -= 1;
      if (x4 < 0 || y4 < 0) {
        n = MbAt(mbx - (x4 < 0), mby - (y4 < 0));
        x4 = (x4 + w) % w, y4 = (y4 + w) % w;
      } else {
        n = &mbs_[static_cast<size_t>(mby) * mb_width_ + mbx];
      }
    }
    if (!n) return intra;
    if (n->kind == kMbPcm) return 1;
    if (cat == 0 || cat == 3) return (n->dc >> comp) & 1;
    return (comp == 0 ? n->nz[y4 * 4 + x4] : n->nz[16 + (comp - 1) * 4 + y4 * 2 + x4]) > 0;
  }

  static int ChromaQp(int qp, int offset) {
    const int qpi = Clip3(0, 51, qp + offset);
    return qpi < 30 ? qpi : kChromaQp[qpi - 30];
  }

  // LevelScale4x4 (8.5.9) of raster position r: weightScale4x4 times normAdjust4x4.
  static int LevelScale4(const uint8_t* weights, int q_mod, int r) {
    const int row = r >> 2, col = r & 3;
    return weights[r] * kDequant[q_mod][(row & 1) == 0 && (col & 1) == 0 ? 0 : (row & 1) && (col & 1) ? 1 : 2];
  }

  static int LevelScale8(const uint8_t* weights, int q_mod, int r) {
    const int i = r >> 3, j = r & 7;
    const int cls = (i % 4 == 0 && j % 4 == 0)                               ? 0
                    : (i % 2 == 1 && j % 2 == 1)                             ? 1
                    : (i % 4 == 2 && j % 4 == 2)                             ? 2
                    : ((i % 4 == 0 && j % 2 == 1) || (i % 2 == 1 && j % 4 == 0)) ? 3
                    : ((i % 4 == 0 && j % 4 == 2) || (i % 4 == 2 && j % 4 == 0)) ? 4
                                                                               : 5;
    return weights[r] * kDequant8[q_mod][cls];
  }

  // The scaled coefficients of a macroblock (8.5.12.1, 8.5.13.1), in raster order: the 4x4 luma blocks (raster
  // order of the blocks), the 8x8 luma blocks, the chroma 4x4 blocks.
  struct Coefficients {
    int16_t luma[16][16] = {};
    int16_t luma8[4][64] = {};
    int16_t chroma[2][4][16] = {};
  };

  void Residual(BitReader& br, const Pps& pps, int addr, int qp, Coefficients* c) {
    const int mbx = addr % mb_width_, mby = addr / mb_width_;
    MbInfo& m = mbs_[addr];
    const bool i16 = m.kind == kMbI16x16, intra = m.Intra();
    const int cbp_luma = m.cbp & 15, cbp_chroma = m.cbp >> 4;
    const ScalingLists& lists = pps.lists;
    const uint8_t* w4 = lists.l4[intra ? 0 : 3];
    const int q6 = qp / 6, qm = qp % 6;
    if (i16) {
      int dc[16] = {};
      if (ReadBlock(br, 0, mbx, mby, 0, 0, 0, 16, dc)) m.dc |= 1;
      // Inverse Hadamard of the DC levels (8.5.10), in raster order of the 4x4 blocks.
      int cc[16];
      for (int k = 0; k < 16; ++k) cc[kZigzag4x4[k]] = dc[k];
      int f[16];
      for (int i = 0; i < 4; ++i) {
        const int* row = cc + 4 * i;
        const int e0 = row[0] + row[1], e1 = row[0] - row[1], e2 = row[2] - row[3], e3 = row[2] + row[3];
        f[4 * i + 0] = e0 + e3;
        f[4 * i + 1] = e0 - e3;
        f[4 * i + 2] = e1 - e2;
        f[4 * i + 3] = e1 + e2;
      }
      int g[16];
      for (int j = 0; j < 4; ++j) {
        const int e0 = f[j] + f[4 + j], e1 = f[j] - f[4 + j], e2 = f[8 + j] - f[12 + j], e3 = f[8 + j] + f[12 + j];
        g[j] = e0 + e3;
        g[4 + j] = e0 - e3;
        g[8 + j] = e1 - e2;
        g[12 + j] = e1 + e2;
      }
      const int ls = LevelScale4(w4, qm, 0);
      for (int k = 0; k < 16; ++k) {
        const int v = qp >= 36 ? (g[k] * ls) << (q6 - 6) : (g[k] * ls + (1 << (5 - q6))) >> (6 - q6);
        c->luma[k][0] = static_cast<int16_t>(v);  // block k in raster order of the 4x4 blocks
      }
    }
    for (int b8 = 0; b8 < 4; ++b8) {
      const int x8 = (b8 & 1) * 2, y8 = (b8 >> 1) * 2;
      if (!((cbp_luma >> b8) & 1)) {
        for (int b4 = 0; b4 < 4; ++b4) m.nz[(y8 + (b4 >> 1)) * 4 + x8 + (b4 & 1)] = 0;
        continue;
      }
      if (m.t8) {
        int lv[64] = {};
        if (cabac_) {
          const int n = ReadBlock(br, 5, mbx, mby, 0, x8, y8, 64, lv);
          for (int b4 = 0; b4 < 4; ++b4) m.nz[(y8 + (b4 >> 1)) * 4 + x8 + (b4 & 1)] = static_cast<uint8_t>(n);
        } else {
          // Four interleaved 4x4 blocks (7.3.5.3.2): coefficient k of block b4 is the 8x8 block's 4 * k + b4.
          for (int b4 = 0; b4 < 4; ++b4) {
            const int x4 = x8 + (b4 & 1), y4 = y8 + (b4 >> 1);
            int part[16] = {};
            m.nz[y4 * 4 + x4] = static_cast<uint8_t>(ReadBlock(br, 2, mbx, mby, 0, x4, y4, 16, part));
            for (int k = 0; k < 16; ++k) lv[4 * k + b4] = part[k];
          }
        }
        const uint8_t* w8 = lists.l8[intra ? 0 : 1];
        for (int k = 0; k < 64; ++k) {
          if (!lv[k]) continue;
          const int r = kZigzag8x8[k], ls = LevelScale8(w8, qm, r);
          const int v = qp >= 36 ? (lv[k] * ls) << (q6 - 6) : (lv[k] * ls + (1 << (5 - q6))) >> (6 - q6);
          c->luma8[b8][r] = static_cast<int16_t>(v);
        }
        continue;
      }
      for (int b4 = 0; b4 < 4; ++b4) {
        const int x4 = x8 + (b4 & 1), y4 = y8 + (b4 >> 1), raster = y4 * 4 + x4;
        int lv[16] = {};
        m.nz[raster] = static_cast<uint8_t>(ReadBlock(br, i16 ? 1 : 2, mbx, mby, 0, x4, y4, i16 ? 15 : 16, lv));
        for (int k = i16 ? 1 : 0; k < 16; ++k) {
          if (lv[k]) c->luma[raster][kZigzag4x4[k]] = static_cast<int16_t>(Dequant4(lv[k], w4, qp, kZigzag4x4[k]));
        }
      }
    }
    const SliceInfo& si = slices_[slice_];
    int qpc[2];
    for (int comp = 0; comp < 2; ++comp) qpc[comp] = ChromaQp(qp, si.chroma_qp_offset[comp]);
    if (cbp_chroma) {
      for (int comp = 0; comp < 2; ++comp) {
        int dc[4] = {};
        if (ReadBlock(br, 3, mbx, mby, comp + 1, 0, 0, 4, dc)) m.dc |= 2 << comp;
        // 2x2 transform (8.5.11.1): c = [[dc0, dc1], [dc2, dc3]].
        const int f0 = dc[0] + dc[1] + dc[2] + dc[3], f1 = dc[0] - dc[1] + dc[2] - dc[3];
        const int f2 = dc[0] + dc[1] - dc[2] - dc[3], f3 = dc[0] - dc[1] - dc[2] + dc[3];
        const int fs[4] = {f0, f1, f2, f3};
        const int ls = LevelScale4(lists.l4[(intra ? 1 : 4) + comp], qpc[comp] % 6, 0);
        for (int k = 0; k < 4; ++k)
          c->chroma[comp][k][0] = static_cast<int16_t>(((fs[k] * ls) << (qpc[comp] / 6)) >> 5);
      }
    }
    for (int comp = 0; comp < 2; ++comp) {
      const uint8_t* w = lists.l4[(intra ? 1 : 4) + comp];
      for (int b = 0; b < 4; ++b) {
        if (!(cbp_chroma & 2)) {
          m.nz[16 + comp * 4 + b] = 0;
          continue;
        }
        int lv[16] = {};
        m.nz[16 + comp * 4 + b] = static_cast<uint8_t>(ReadBlock(br, 4, mbx, mby, comp + 1, b & 1, b >> 1, 15, lv));
        for (int k = 1; k < 16; ++k) {
          if (lv[k])
            c->chroma[comp][b][kZigzag4x4[k]] = static_cast<int16_t>(Dequant4(lv[k], w, qpc[comp], kZigzag4x4[k]));
        }
      }
    }
  }

  // A 4x4 block's level at raster position r scaled (8.5.12.1): LevelScale4x4 * level, with the rounding below
  // qP 24.
  static int Dequant4(int level, const uint8_t* weights, int qp, int r) {
    const int ls = LevelScale4(weights, qp % 6, r);
    return qp >= 24 ? (level * ls) << (qp / 6 - 4) : (level * ls + (1 << (3 - qp / 6))) >> (4 - qp / 6);
  }

  // The 4x4 inverse transform (8.5.12.2) of d (raster order), added to the prediction at (x, y).
  static void AddResidual(uint8_t* plane, int stride, int x, int y, const int16_t* d, bool coded) {
    bool any = coded;
    for (int k = 0; k < 16 && !any; ++k) any = d[k] != 0;
    if (!any) return;
    int f[16];
    for (int i = 0; i < 4; ++i) {
      const int d0 = d[4 * i], d1 = d[4 * i + 1], d2 = d[4 * i + 2], d3 = d[4 * i + 3];
      const int e0 = d0 + d2, e1 = d0 - d2, e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
      f[4 * i] = e0 + e3;
      f[4 * i + 1] = e1 + e2;
      f[4 * i + 2] = e1 - e2;
      f[4 * i + 3] = e0 - e3;
    }
    for (int j = 0; j < 4; ++j) {
      const int f0 = f[j], f1 = f[4 + j], f2 = f[8 + j], f3 = f[12 + j];
      const int g0 = f0 + f2, g1 = f0 - f2, g2 = (f1 >> 1) - f3, g3 = f1 + (f3 >> 1);
      const int h[4] = {g0 + g3, g1 + g2, g1 - g2, g0 - g3};
      for (int i = 0; i < 4; ++i) {
        uint8_t& p = plane[static_cast<size_t>(y + i) * stride + x + j];
        p = Clip1(p + ((h[i] + 32) >> 6));
      }
    }
  }

  void AddChroma(int mbx, int mby, int16_t chroma[2][4][16], int addr) {
    const MbInfo& m = mbs_[addr];
    for (int comp = 0; comp < 2; ++comp)
      for (int b = 0; b < 4; ++b)
        AddResidual(cur_->Plane(comp + 1), width_ / 2, mbx * 8 + (b & 1) * 4, mby * 8 + (b >> 1) * 4, chroma[comp][b],
                    m.nz[16 + comp * 4 + b] > 0 || chroma[comp][b][0] != 0);
  }

  // The 8x8 inverse transform (8.5.13) of d (raster order), added to the prediction at (x, y).
  static void AddResidual8x8(uint8_t* plane, int stride, int x, int y, const int16_t* d) {
    bool any = false;
    for (int k = 0; k < 64 && !any; ++k) any = d[k] != 0;
    if (!any) return;
    auto transform = [](const int* in, int step, int* out) {
      const int d0 = in[0], d1 = in[step], d2 = in[2 * step], d3 = in[3 * step], d4 = in[4 * step],
                d5 = in[5 * step], d6 = in[6 * step], d7 = in[7 * step];
      const int e0 = d0 + d4, e1 = -d3 + d5 - d7 - (d7 >> 1), e2 = d0 - d4, e3 = d1 + d7 - d3 - (d3 >> 1);
      const int e4 = (d2 >> 1) - d6, e5 = -d1 + d7 + d5 + (d5 >> 1), e6 = d2 + (d6 >> 1), e7 = d3 + d5 + d1 + (d1 >> 1);
      const int f0 = e0 + e6, f1 = e1 + (e7 >> 2), f2 = e2 + e4, f3 = e3 + (e5 >> 2);
      const int f4 = e2 - e4, f5 = (e3 >> 2) - e5, f6 = e0 - e6, f7 = e7 - (e1 >> 2);
      out[0] = f0 + f7, out[1] = f2 + f5, out[2] = f4 + f3, out[3] = f6 + f1;
      out[4] = f6 - f1, out[5] = f4 - f3, out[6] = f2 - f5, out[7] = f0 - f7;
    };
    int in[64], g[64];
    for (int k = 0; k < 64; ++k) in[k] = d[k];
    for (int i = 0; i < 8; ++i) transform(in + 8 * i, 1, g + 8 * i);  // the rows, then the columns
    for (int j = 0; j < 8; ++j) {
      int h[8];
      transform(g + j, 8, h);
      for (int i = 0; i < 8; ++i) {
        uint8_t& p = plane[static_cast<size_t>(y + i) * stride + x + j];
        p = Clip1(p + ((h[i] + 32) >> 6));
      }
    }
  }

  // Intra 8x8 prediction (8.3.2) of 8x8 block b8 of the macroblock, from the filtered reference samples.
  void Intra8x8(int mbx, int mby, int b8, int mode) {
    const int bx = b8 & 1, by = b8 >> 1;
    const int x0 = mbx * 16 + bx * 8, y0 = mby * 16 + by * 8, stride = width_;
    uint8_t* pic = cur_->y.data();
    const bool left = bx > 0 || IntraAvailable(mbx - 1, mby);
    const bool top = by > 0 || IntraAvailable(mbx, mby - 1);
    const bool corner = bx && by   ? true
                        : bx       ? IntraAvailable(mbx, mby - 1)
                        : by       ? IntraAvailable(mbx - 1, mby)
                                   : IntraAvailable(mbx - 1, mby - 1);
    // Up and to the right: the macroblock above (block 0), the one above and right (block 1), block 1 (block 2).
    const bool top_right =
        b8 == 0 ? IntraAvailable(mbx, mby - 1) : b8 == 1 ? IntraAvailable(mbx + 1, mby - 1) : b8 == 2;
    const bool needs_top = mode == 0 || mode == 3 || mode == 4 || mode == 5 || mode == 6 || mode == 7;
    const bool needs_left = mode == 1 || mode == 4 || mode == 5 || mode == 6 || mode == 8;
    const bool needs_corner = mode == 4 || mode == 5 || mode == 6;
    if ((needs_top && !top) || (needs_left && !left) || (needs_corner && !corner))
      throw Corrupt("intra 8x8 prediction mode " + std::to_string(mode) + " needs unavailable samples");
    int pt[16] = {}, pl[8] = {}, pc = 0;
    if (top) {
      for (int i = 0; i < 16; ++i)
        pt[i] = pic[static_cast<size_t>(y0 - 1) * stride + x0 + (i < 8 || top_right ? i : 7)];
    }
    if (left)
      for (int i = 0; i < 8; ++i) pl[i] = pic[static_cast<size_t>(y0 + i) * stride + x0 - 1];
    if (corner) pc = pic[static_cast<size_t>(y0 - 1) * stride + x0 - 1];
    // Reference sample filtering (8.3.2.2.1).
    int t[16] = {}, l[8] = {}, c = pc;
    if (top) {
      t[0] = corner ? (pc + 2 * pt[0] + pt[1] + 2) >> 2 : (3 * pt[0] + pt[1] + 2) >> 2;
      for (int i = 1; i < 15; ++i) t[i] = (pt[i - 1] + 2 * pt[i] + pt[i + 1] + 2) >> 2;
      t[15] = (pt[14] + 3 * pt[15] + 2) >> 2;
    }
    if (corner) {
      c = top && left ? (pt[0] + 2 * pc + pl[0] + 2) >> 2
          : top       ? (3 * pc + pt[0] + 2) >> 2
          : left      ? (3 * pc + pl[0] + 2) >> 2
                      : pc;
    }
    if (left) {
      l[0] = corner ? (pc + 2 * pl[0] + pl[1] + 2) >> 2 : (3 * pl[0] + pl[1] + 2) >> 2;
      for (int i = 1; i < 7; ++i) l[i] = (pl[i - 1] + 2 * pl[i] + pl[i + 1] + 2) >> 2;
      l[7] = (pl[6] + 3 * pl[7] + 2) >> 2;
    }
    auto T = [&](int x) { return x < 0 ? c : t[x]; };  // p'[x, -1]
    auto L = [&](int y) { return y < 0 ? c : l[y]; };  // p'[-1, y]
    int dc = 128;
    if (mode == 2) {
      int st = 0, sl = 0;
      for (int i = 0; i < 8; ++i) st += t[i], sl += l[i];
      dc = top && left ? (st + sl + 8) >> 4 : left ? (sl + 4) >> 3 : top ? (st + 4) >> 3 : 128;
    }
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) {
        int v = 0;
        switch (mode) {
          case 0: v = T(x); break;
          case 1: v = L(y); break;
          case 2: v = dc; break;
          case 3:
            v = (x == 7 && y == 7) ? (T(14) + 3 * T(15) + 2) >> 2
                                   : (T(x + y) + 2 * T(x + y + 1) + T(x + y + 2) + 2) >> 2;
            break;
          case 4:
            if (x > y) v = (T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2;
            else if (x < y) v = (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2;
            else v = (T(0) + 2 * c + L(0) + 2) >> 2;
            break;
          case 5: {
            const int z = 2 * x - y;
            if (z >= 0 && !(z & 1)) v = (T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 1) >> 1;
            else if (z >= 0) v = (T(x - (y >> 1) - 2) + 2 * T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 2) >> 2;
            else if (z == -1) v = (L(0) + 2 * c + T(0) + 2) >> 2;
            else v = (L(y - 2 * x - 1) + 2 * L(y - 2 * x - 2) + L(y - 2 * x - 3) + 2) >> 2;
            break;
          }
          case 6: {
            const int z = 2 * y - x;
            if (z >= 0 && !(z & 1)) v = (L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 1) >> 1;
            else if (z >= 0) v = (L(y - (x >> 1) - 2) + 2 * L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 2) >> 2;
            else if (z == -1) v = (L(0) + 2 * c + T(0) + 2) >> 2;
            else v = (T(x - 2 * y - 1) + 2 * T(x - 2 * y - 2) + T(x - 2 * y - 3) + 2) >> 2;
            break;
          }
          case 7:
            if (!(y & 1)) v = (T(x + (y >> 1)) + T(x + (y >> 1) + 1) + 1) >> 1;
            else v = (T(x + (y >> 1)) + 2 * T(x + (y >> 1) + 1) + T(x + (y >> 1) + 2) + 2) >> 2;
            break;
          case 8: {
            const int z = x + 2 * y;
            if (z > 13) v = L(7);
            else if (z == 13) v = (L(6) + 3 * L(7) + 2) >> 2;
            else if (!(z & 1)) v = (L(y + (x >> 1)) + L(y + (x >> 1) + 1) + 1) >> 1;
            else v = (L(y + (x >> 1)) + 2 * L(y + (x >> 1) + 1) + L(y + (x >> 1) + 2) + 2) >> 2;
            break;
          }
        }
        pic[static_cast<size_t>(y0 + y) * stride + x0 + x] = static_cast<uint8_t>(v);
      }
  }

  // ---- intra prediction (8.3)
  void Intra4x4(int mbx, int mby, int x4, int y4, int blk, int mode) {
    const int x0 = mbx * 16 + x4 * 4, y0 = mby * 16 + y4 * 4;
    const uint8_t* pic = cur_->y.data();
    const int stride = width_;
    const bool left = x4 > 0 || IntraAvailable(mbx - 1, mby);
    const bool top = y4 > 0 || IntraAvailable(mbx, mby - 1);
    bool top_left;
    if (x4 > 0 && y4 > 0) top_left = true;
    else if (x4 > 0) top_left = IntraAvailable(mbx, mby - 1);
    else if (y4 > 0) top_left = IntraAvailable(mbx - 1, mby);
    else top_left = IntraAvailable(mbx - 1, mby - 1);
    bool top_right;
    if (y4 == 0) {
      top_right = x4 < 3 ? IntraAvailable(mbx, mby - 1) : IntraAvailable(mbx + 1, mby - 1);
    } else if (x4 == 3) {
      top_right = false;
    } else {
      // Inside the MB: the block up and to the right must precede this one in decoding order.
      const int nx = x4 + 1, ny = y4 - 1;
      const int nblk = (ny >> 1) * 8 + (nx >> 1) * 4 + (ny & 1) * 2 + (nx & 1);
      top_right = nblk < blk;
    }
    int p[13];  // p[0] = top-left, p[1..8] = top 0..7, p[9..12] = left 0..3
    if (top_left) p[0] = pic[static_cast<size_t>(y0 - 1) * stride + x0 - 1];
    if (top) {
      for (int i = 0; i < 4; ++i) p[1 + i] = pic[static_cast<size_t>(y0 - 1) * stride + x0 + i];
      for (int i = 4; i < 8; ++i) p[1 + i] = top_right ? pic[static_cast<size_t>(y0 - 1) * stride + x0 + i] : p[4];
    }
    if (left)
      for (int i = 0; i < 4; ++i) p[9 + i] = pic[static_cast<size_t>(y0 + i) * stride + x0 - 1];
    auto T = [&](int x) { return x < 0 ? p[0] : p[1 + x]; };   // p[x, -1]
    auto L = [&](int y) { return y < 0 ? p[0] : p[9 + y]; };   // p[-1, y]
    const bool needs_top = mode == 0 || mode == 3 || mode == 4 || mode == 5 || mode == 6 || mode == 7;
    const bool needs_left = mode == 1 || mode == 4 || mode == 5 || mode == 6 || mode == 8;
    const bool needs_corner = mode == 4 || mode == 5 || mode == 6;
    if ((needs_top && !top) || (needs_left && !left) || (needs_corner && !top_left))
      throw Corrupt("intra 4x4 prediction mode " + std::to_string(mode) + " needs unavailable samples");
    uint8_t out[4][4];
    for (int y = 0; y < 4; ++y)
      for (int x = 0; x < 4; ++x) {
        int v = 0;
        switch (mode) {
          case 0: v = T(x); break;
          case 1: v = L(y); break;
          case 2:
            if (top && left) v = (T(0) + T(1) + T(2) + T(3) + L(0) + L(1) + L(2) + L(3) + 4) >> 3;
            else if (left) v = (L(0) + L(1) + L(2) + L(3) + 2) >> 2;
            else if (top) v = (T(0) + T(1) + T(2) + T(3) + 2) >> 2;
            else v = 128;
            break;
          case 3:
            v = (x == 3 && y == 3) ? (T(6) + 3 * T(7) + 2) >> 2 : (T(x + y) + 2 * T(x + y + 1) + T(x + y + 2) + 2) >> 2;
            break;
          case 4:
            if (x > y) v = (T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2;
            else if (x < y) v = (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2;
            else v = (T(0) + 2 * p[0] + L(0) + 2) >> 2;
            break;
          case 5: {
            const int z = 2 * x - y;
            if (z >= 0 && !(z & 1)) v = (T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 1) >> 1;
            else if (z >= 0) v = (T(x - (y >> 1) - 2) + 2 * T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 2) >> 2;
            else if (z == -1) v = (L(0) + 2 * p[0] + T(0) + 2) >> 2;
            else v = (L(y - 1) + 2 * L(y - 2) + L(y - 3) + 2) >> 2;
            break;
          }
          case 6: {
            const int z = 2 * y - x;
            if (z >= 0 && !(z & 1)) v = (L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 1) >> 1;
            else if (z >= 0) v = (L(y - (x >> 1) - 2) + 2 * L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 2) >> 2;
            else if (z == -1) v = (L(0) + 2 * p[0] + T(0) + 2) >> 2;
            else v = (T(x - 1) + 2 * T(x - 2) + T(x - 3) + 2) >> 2;
            break;
          }
          case 7:
            if (!(y & 1)) v = (T(x + (y >> 1)) + T(x + (y >> 1) + 1) + 1) >> 1;
            else v = (T(x + (y >> 1)) + 2 * T(x + (y >> 1) + 1) + T(x + (y >> 1) + 2) + 2) >> 2;
            break;
          case 8: {
            const int z = x + 2 * y;
            if (z > 5) v = L(3);
            else if (z == 5) v = (L(2) + 3 * L(3) + 2) >> 2;
            else if (!(z & 1)) v = (L(y + (x >> 1)) + L(y + (x >> 1) + 1) + 1) >> 1;
            else v = (L(y + (x >> 1)) + 2 * L(y + (x >> 1) + 1) + L(y + (x >> 1) + 2) + 2) >> 2;
            break;
          }
        }
        out[y][x] = static_cast<uint8_t>(v);
      }
    for (int y = 0; y < 4; ++y)
      for (int x = 0; x < 4; ++x) cur_->y[static_cast<size_t>(y0 + y) * stride + x0 + x] = out[y][x];
  }

  void Intra16x16(int mbx, int mby, int mode) {
    const int x0 = mbx * 16, y0 = mby * 16, stride = width_;
    uint8_t* pic = cur_->y.data();
    const bool left = IntraAvailable(mbx - 1, mby), top = IntraAvailable(mbx, mby - 1);
    const bool corner = IntraAvailable(mbx - 1, mby - 1);
    if ((mode == 0 && !top) || (mode == 1 && !left) || (mode == 3 && !(top && left && corner)))
      throw Corrupt("intra 16x16 prediction mode " + std::to_string(mode) + " needs unavailable samples");
    auto T = [&](int x) { return static_cast<int>(pic[static_cast<size_t>(y0 - 1) * stride + x0 + x]); };
    auto L = [&](int y) { return static_cast<int>(pic[static_cast<size_t>(y0 + y) * stride + x0 - 1]); };
    int dc = 128;
    if (mode == 2) {
      int st = 0, sl = 0;
      for (int i = 0; i < 16; ++i) {
        if (top) st += T(i);
        if (left) sl += L(i);
      }
      dc = top && left ? (st + sl + 16) >> 5 : left ? (sl + 8) >> 4 : top ? (st + 8) >> 4 : 128;
    }
    int a = 0, b = 0, c = 0;
    if (mode == 3) {
      int hh = 0, vv = 0;
      for (int i = 0; i < 8; ++i) {
        hh += (i + 1) * (T(8 + i) - T(6 - i));
        vv += (i + 1) * (L(8 + i) - L(6 - i));
      }
      a = 16 * (L(15) + T(15));
      b = (5 * hh + 32) >> 6;
      c = (5 * vv + 32) >> 6;
    }
    uint8_t out[16][16];
    for (int y = 0; y < 16; ++y)
      for (int x = 0; x < 16; ++x)
        out[y][x] = mode == 0   ? T(x)
                    : mode == 1 ? L(y)
                    : mode == 2 ? dc
                                : Clip1((a + b * (x - 7) + c * (y - 7) + 16) >> 5);
    for (int y = 0; y < 16; ++y)
      for (int x = 0; x < 16; ++x) pic[static_cast<size_t>(y0 + y) * stride + x0 + x] = out[y][x];
  }

  void IntraChroma(int mbx, int mby, int mode) {
    const bool left = IntraAvailable(mbx - 1, mby), top = IntraAvailable(mbx, mby - 1);
    const bool corner = IntraAvailable(mbx - 1, mby - 1);
    if ((mode == 1 && !left) || (mode == 2 && !top) || (mode == 3 && !(top && left && corner)))
      throw Corrupt("intra chroma prediction mode " + std::to_string(mode) + " needs unavailable samples");
    const int stride = width_ / 2, x0 = mbx * 8, y0 = mby * 8;
    for (int comp = 1; comp <= 2; ++comp) {
      uint8_t* pic = cur_->Plane(comp);
      auto T = [&](int x) { return static_cast<int>(pic[static_cast<size_t>(y0 - 1) * stride + x0 + x]); };
      auto L = [&](int y) { return static_cast<int>(pic[static_cast<size_t>(y0 + y) * stride + x0 - 1]); };
      uint8_t out[8][8];
      if (mode == 0) {
        for (int by = 0; by < 2; ++by)
          for (int bx = 0; bx < 2; ++bx) {
            int st = 0, sl = 0;
            for (int i = 0; i < 4; ++i) {
              if (top) st += T(bx * 4 + i);
              if (left) sl += L(by * 4 + i);
            }
            int v = 128;
            if (bx == by) {
              v = top && left ? (st + sl + 4) >> 3 : left ? (sl + 2) >> 2 : top ? (st + 2) >> 2 : 128;
            } else if (bx == 1) {  // (4, 0): the row above first
              v = top ? (st + 2) >> 2 : left ? (sl + 2) >> 2 : 128;
            } else {  // (0, 4): the column to the left first
              v = left ? (sl + 2) >> 2 : top ? (st + 2) >> 2 : 128;
            }
            for (int y = 0; y < 4; ++y)
              for (int x = 0; x < 4; ++x) out[by * 4 + y][bx * 4 + x] = static_cast<uint8_t>(v);
          }
      } else if (mode == 1) {
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x) out[y][x] = L(y);
      } else if (mode == 2) {
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x) out[y][x] = T(x);
      } else {
        const int corner_px = pic[static_cast<size_t>(y0 - 1) * stride + x0 - 1];
        auto TT = [&](int x) { return x < 0 ? corner_px : T(x); };
        auto LL = [&](int y) { return y < 0 ? corner_px : L(y); };
        int hh = 0, vv = 0;
        for (int i = 0; i < 4; ++i) {
          hh += (i + 1) * (TT(4 + i) - TT(2 - i));
          vv += (i + 1) * (LL(4 + i) - LL(2 - i));
        }
        const int a = 16 * (L(7) + T(7)), b = (34 * hh + 32) >> 6, c = (34 * vv + 32) >> 6;
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x) out[y][x] = Clip1((a + b * (x - 3) + c * (y - 3) + 16) >> 5);
      }
      for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x) pic[static_cast<size_t>(y0 + y) * stride + x0 + x] = out[y][x];
    }
  }

  // ---- inter prediction (8.4.2)
  // The prediction samples of a w x h block at luma sample (x0, y0) from reference r with vector (mvx, mvy).
  void Interpolate(const Picture& r, int x0, int y0, int w, int h, int mvx, int mvy, uint8_t luma[16][16],
                   uint8_t cb[8][8], uint8_t cr[8][8]) const {
    // Luma: a window of the reference with its coordinates clamped to the picture, then the 6-tap filter.
    const int ix = x0 + (mvx >> 2), iy = y0 + (mvy >> 2), fx = mvx & 3, fy = mvy & 3;
    int win[21][21];
    for (int y = 0; y < h + 5; ++y)
      for (int x = 0; x < w + 5; ++x) {
        const int sx = Clip3(0, width_ - 1, ix + x - 2), sy = Clip3(0, height_ - 1, iy + y - 2);
        win[y][x] = r.y[static_cast<size_t>(sy) * width_ + sx];
      }
    auto G = [&](int x, int y) { return win[y + 2][x + 2]; };
    auto tap = [](int a, int b, int c, int d, int e, int f) { return a - 5 * b + 20 * c + 20 * d - 5 * e + f; };
    auto b1 = [&](int x, int y) {  // the horizontal half-sample's sum at (x + 1/2, y)
      return tap(G(x - 2, y), G(x - 1, y), G(x, y), G(x + 1, y), G(x + 2, y), G(x + 3, y));
    };
    auto h1 = [&](int x, int y) {  // the vertical one at (x, y + 1/2)
      return tap(G(x, y - 2), G(x, y - 1), G(x, y), G(x, y + 1), G(x, y + 2), G(x, y + 3));
    };
    auto bb = [&](int x, int y) { return Clip1((b1(x, y) + 16) >> 5); };
    auto hh = [&](int x, int y) { return Clip1((h1(x, y) + 16) >> 5); };
    auto jj = [&](int x, int y) {
      const int j1 = tap(b1(x, y - 2), b1(x, y - 1), b1(x, y), b1(x, y + 1), b1(x, y + 2), b1(x, y + 3));
      return Clip1((j1 + 512) >> 10);
    };
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        int v;
        const int G0 = G(x, y);
        switch (fy * 4 + fx) {
          case 0: v = G0; break;
          case 1: v = (G0 + bb(x, y) + 1) >> 1; break;
          case 2: v = bb(x, y); break;
          case 3: v = (bb(x, y) + G(x + 1, y) + 1) >> 1; break;
          case 4: v = (G0 + hh(x, y) + 1) >> 1; break;
          case 5: v = (bb(x, y) + hh(x, y) + 1) >> 1; break;
          case 6: v = (bb(x, y) + jj(x, y) + 1) >> 1; break;
          case 7: v = (bb(x, y) + hh(x + 1, y) + 1) >> 1; break;
          case 8: v = hh(x, y); break;
          case 9: v = (hh(x, y) + jj(x, y) + 1) >> 1; break;
          case 10: v = jj(x, y); break;
          case 11: v = (jj(x, y) + hh(x + 1, y) + 1) >> 1; break;
          case 12: v = (hh(x, y) + G(x, y + 1) + 1) >> 1; break;
          case 13: v = (hh(x, y) + bb(x, y + 1) + 1) >> 1; break;
          case 14: v = (jj(x, y) + bb(x, y + 1) + 1) >> 1; break;
          default: v = (hh(x + 1, y) + bb(x, y + 1) + 1) >> 1; break;
        }
        luma[y][x] = static_cast<uint8_t>(v);
      }
    // Chroma: eighth-sample bilinear.
    const int cw = w / 2, ch = h / 2, cx0 = x0 / 2, cy0 = y0 / 2, cwid = width_ / 2, chei = height_ / 2;
    const int icx = cx0 + (mvx >> 3), icy = cy0 + (mvy >> 3), cfx = mvx & 7, cfy = mvy & 7;
    for (int comp = 0; comp < 2; ++comp) {
      const uint8_t* src = comp == 0 ? r.u.data() : r.v.data();
      auto S = [&](int x, int y) {
        return static_cast<int>(src[static_cast<size_t>(Clip3(0, chei - 1, y)) * cwid + Clip3(0, cwid - 1, x)]);
      };
      uint8_t(*dst)[8] = comp == 0 ? cb : cr;
      for (int y = 0; y < ch; ++y)
        for (int x = 0; x < cw; ++x) {
          const int sx = icx + x, sy = icy + y;
          dst[y][x] = static_cast<uint8_t>(((8 - cfx) * (8 - cfy) * S(sx, sy) + cfx * (8 - cfy) * S(sx + 1, sy) +
                                            (8 - cfx) * cfy * S(sx, sy + 1) + cfx * cfy * S(sx + 1, sy + 1) + 32) >> 6);
        }
    }
  }

  void InterPredict(int mbx, int mby, int px, int py, int w, int h, int ref, int mvx, int mvy) {
    const int ax = mbx * 16 + px + (mvx >> 2), ay = mby * 16 + py + (mvy >> 2);
    if (ax + w <= -16 || ay + h <= -16 || ax >= width_ + 16 || ay >= height_ + 16) ++stats_[kFarMv];
    InterPredictB(mbx, mby, px, py, w, h, ref, mvx, mvy, -1, 0, 0);
  }

  void Store(int x0, int y0, int w, int h, uint8_t luma[16][16], uint8_t cb[8][8], uint8_t cr[8][8]) {
    const int cwid = width_ / 2, cx0 = x0 / 2, cy0 = y0 / 2;
    for (int y = 0; y < h; ++y)
      std::memcpy(&cur_->y[static_cast<size_t>(y0 + y) * width_ + x0], luma[y], w);
    for (int y = 0; y < h / 2; ++y) {
      std::memcpy(&cur_->u[static_cast<size_t>(cy0 + y) * cwid + cx0], cb[y], w / 2);
      std::memcpy(&cur_->v[static_cast<size_t>(cy0 + y) * cwid + cx0], cr[y], w / 2);
    }
  }

  // Weighted bi-prediction of one sample (8.4.2.3.2), o the sum of the two offsets, as FFmpeg's x86 biweight computes
  // it for a block whose rows hold `width` samples: where a weight is 128 the weights, the rounded offset and the shift
  // are halved (16- and 8-wide rows take them as signed bytes, pmaddubsw); the products and then the offset are added
  // in signed 16 bits with saturation. 2-wide rows (the chroma of 4-wide partitions) take FFmpeg's exact C
  // version.
  static uint8_t BiWeight(int a, int b, int w0, int w1, int o, int log_wd, int width) {
    int off = (o + 1) | 1, shift = log_wd + 1;
    if (width <= 2) return Clip1((a * w0 + b * w1 + (off << log_wd)) >> shift);
    if (w0 == 128 || w1 == 128) w0 >>= 1, w1 >>= 1, off >>= 1, shift = log_wd;
    auto sat = [](int v) { return v < -32768 ? -32768 : v > 32767 ? 32767 : v; };
    return Clip1(sat(sat(a * w0 + b * w1) + ((off << shift) >> 1)) >> shift);
  }

  // Implicit weight w0 of list 0 (8.4.2.3.1) for the pair (ref0, ref1), as FFmpeg's implicit_weight_table.
  int ImplicitWeight(int ref0, int ref1) const {
    const Picture& p0 = *ref_list_[0][ref0];
    const Picture& p1 = *ref_list_[1][ref1];
    if (p0.long_ref || p1.long_ref) return 32;
    const int td = Clip3(-128, 127, static_cast<int>(p1.poc - p0.poc));
    if (!td) return 32;
    const int tb = Clip3(-128, 127, static_cast<int>(cur_->poc - p0.poc));
    const int tx = (16384 + (std::abs(td) >> 1)) / td;
    const int dsf = (tb * tx + 32) >> 8;
    return dsf >= -64 && dsf <= 128 ? 64 - dsf : 32;
  }

  // Inter prediction of a partition (px, py, w, h in the macroblock) from list 0 (ref0 >= 0), list 1 (ref1 >= 0)
  // or both, weighted as the slice says.
  void InterPredictB(int mbx, int mby, int px, int py, int w, int h, int ref0, int mv0x, int mv0y, int ref1, int mv1x,
                     int mv1y) {
    const int x0 = mbx * 16 + px, y0 = mby * 16 + py, cw = w / 2, ch = h / 2;
    uint8_t luma[2][16][16], cb[2][8][8], cr[2][8][8];
    if (ref0 >= 0) Interpolate(*ref_list_[0][ref0], x0, y0, w, h, mv0x, mv0y, luma[0], cb[0], cr[0]);
    if (ref1 >= 0) Interpolate(*ref_list_[1][ref1], x0, y0, w, h, mv1x, mv1y, luma[1], cb[1], cr[1]);
    const Header& hd = header_;
    if (ref0 < 0 || ref1 < 0) {
      const int l = ref0 >= 0 ? 0 : 1, ref = ref0 >= 0 ? ref0 : ref1;
      if (hd.weighted) {  // explicit weighted prediction (8.4.2.3.2; FFmpeg's saturation cannot change these)
        const Weight& wt = hd.weights[l][ref];
        if (wt.luma) {
          const int lw = hd.luma_log2;
          for (int y = 0; y < h; ++y)
            for (int x = 0; x < w; ++x) {
              const int v = luma[l][y][x] * wt.luma_w;
              luma[l][y][x] = lw >= 1 ? Clip1(((v + (1 << (lw - 1))) >> lw) + wt.luma_o) : Clip1(v + wt.luma_o);
            }
        }
        if (wt.chroma) {
          const int cwd = hd.chroma_log2;
          for (int c = 0; c < 2; ++c) {
            uint8_t(*dst)[8] = c == 0 ? cb[l] : cr[l];
            for (int y = 0; y < ch; ++y)
              for (int x = 0; x < cw; ++x) {
                const int v = dst[y][x] * wt.chroma_w[c];
                dst[y][x] = cwd >= 1 ? Clip1(((v + (1 << (cwd - 1))) >> cwd) + wt.chroma_o[c])
                                     : Clip1(v + wt.chroma_o[c]);
              }
          }
        }
      }
      Store(x0, y0, w, h, luma[l], cb[l], cr[l]);
      return;
    }
    uint8_t out[16][16], ocb[8][8], ocr[8][8];
    // FFmpeg weights explicitly where a weight or offset of the table is unlike the default (use_weight), implicitly
    // where the pair's weight is not 32, else averages.
    const int implicit = hd.bipred_idc == 2 ? ImplicitWeight(ref0, ref1) : 32;
    if ((hd.weighted && hd.use_weight) || implicit != 32) {
      Weight a, b;
      int luma_log2 = 5, chroma_log2 = 5;
      if (implicit != 32) {
        a.luma_w = a.chroma_w[0] = a.chroma_w[1] = implicit;
        b.luma_w = b.chroma_w[0] = b.chroma_w[1] = 64 - implicit;
      } else {
        a = hd.weights[0][ref0], b = hd.weights[1][ref1];
        luma_log2 = hd.luma_log2, chroma_log2 = hd.chroma_log2;
      }
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
          out[y][x] = BiWeight(luma[0][y][x], luma[1][y][x], a.luma_w, b.luma_w, a.luma_o + b.luma_o, luma_log2, w);
      for (int y = 0; y < ch; ++y)
        for (int x = 0; x < cw; ++x) {
          ocb[y][x] = BiWeight(cb[0][y][x], cb[1][y][x], a.chroma_w[0], b.chroma_w[0], a.chroma_o[0] + b.chroma_o[0],
                               chroma_log2, cw);
          ocr[y][x] = BiWeight(cr[0][y][x], cr[1][y][x], a.chroma_w[1], b.chroma_w[1], a.chroma_o[1] + b.chroma_o[1],
                               chroma_log2, cw);
        }
    } else {
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) out[y][x] = static_cast<uint8_t>((luma[0][y][x] + luma[1][y][x] + 1) >> 1);
      for (int y = 0; y < ch; ++y)
        for (int x = 0; x < cw; ++x) {
          ocb[y][x] = static_cast<uint8_t>((cb[0][y][x] + cb[1][y][x] + 1) >> 1);
          ocr[y][x] = static_cast<uint8_t>((cr[0][y][x] + cr[1][y][x] + 1) >> 1);
        }
    }
    Store(x0, y0, w, h, out, ocb, ocr);
  }

  // ---- deblocking (8.7)
  int Strength(int mb_p, int mb_q, int bp, int bq, bool mb_edge) const {
    const MbInfo& p = mbs_[mb_p];
    const MbInfo& q = mbs_[mb_q];
    if (p.Intra() || q.Intra()) return mb_edge ? 4 : 3;
    const int rp = (bp >> 2) & 3, cp = bp & 3, rq = (bq >> 2) & 3, cq = bq & 3;
    // Coefficients in the 4x4 block, or with the 8x8 transform in the 8x8 block, holding the sample.
    auto coded = [](const MbInfo& m, int r, int c) {
      if (!m.t8) return m.nz[r * 4 + c] != 0;
      const int k = (r & 2) * 4 + (c & 2);
      return (m.nz[k] | m.nz[k + 1] | m.nz[k + 4] | m.nz[k + 5]) != 0;
    };
    if (coded(p, rp, cp) || coded(q, rq, cq)) return 2;
    const int mbw = mb_width_;
    const size_t ip = static_cast<size_t>((mb_p / mbw) * 4 + rp) * mbw * 4 + (mb_p % mbw) * 4 + cp;
    const size_t iq = static_cast<size_t>((mb_q / mbw) * 4 + rq) * mbw * 4 + (mb_q % mbw) * 4 + cq;
    // FFmpeg's check_mv (which 8.7.2.1 comes to): the pictures referenced and the vectors differ in the pairing of
    // the lists, and, where q lies in a B slice, in the crossed pairing too.
    auto differ = [&](int lp, int lq) {
      return std::abs(mv_[lp][2 * ip] - mv_[lq][2 * iq]) >= 4 || std::abs(mv_[lp][2 * ip + 1] - mv_[lq][2 * iq + 1]) >= 4;
    };
    bool v = refpic_[0][ip] != refpic_[0][iq] || (refpic_[0][ip] && differ(0, 0));
    if (!q.b_slice) return v;
    if (!v) v = refpic_[1][ip] != refpic_[1][iq] || differ(1, 1);
    if (!v) return 0;
    if (refpic_[0][ip] != refpic_[1][iq] || refpic_[1][ip] != refpic_[0][iq]) return 1;
    return differ(0, 1) || differ(1, 0);
  }

  // Filters one line of samples across an edge: p[-k * step] are p0..p3, p[k * step] q0..q3 (p0 = s[-step]).
  static void FilterLine(uint8_t* s, int step, int bs, int alpha, int beta, int tc0, bool luma) {
    const int p0 = s[-step], p1 = s[-2 * step], q0 = s[0], q1 = s[step];
    if (!(std::abs(p0 - q0) < alpha && std::abs(p1 - p0) < beta && std::abs(q1 - q0) < beta)) return;
    const int p2 = luma ? s[-3 * step] : 0, q2 = luma ? s[2 * step] : 0;
    if (bs < 4) {
      const int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
      const int tc = luma ? tc0 + (ap < beta) + (aq < beta) : tc0 + 1;
      const int delta = Clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
      s[-step] = Clip1(p0 + delta);
      s[0] = Clip1(q0 - delta);
      if (luma) {
        const int avg = (p0 + q0 + 1) >> 1;
        if (ap < beta) s[-2 * step] = static_cast<uint8_t>(p1 + Clip3(-tc0, tc0, (p2 + avg - (p1 << 1)) >> 1));
        if (aq < beta) s[step] = static_cast<uint8_t>(q1 + Clip3(-tc0, tc0, (q2 + avg - (q1 << 1)) >> 1));
      }
      return;
    }
    if (luma) {
      const int p3 = s[-4 * step], q3 = s[3 * step];
      const int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
      const bool strong = std::abs(p0 - q0) < ((alpha >> 2) + 2);
      if (ap < beta && strong) {
        s[-step] = static_cast<uint8_t>((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
        s[-2 * step] = static_cast<uint8_t>((p2 + p1 + p0 + q0 + 2) >> 2);
        s[-3 * step] = static_cast<uint8_t>((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
      } else {
        s[-step] = static_cast<uint8_t>((2 * p1 + p0 + q1 + 2) >> 2);
      }
      if (aq < beta && strong) {
        s[0] = static_cast<uint8_t>((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
        s[step] = static_cast<uint8_t>((p0 + q0 + q1 + q2 + 2) >> 2);
        s[2 * step] = static_cast<uint8_t>((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
      } else {
        s[0] = static_cast<uint8_t>((2 * q1 + q0 + p1 + 2) >> 2);
      }
    } else {
      s[-step] = static_cast<uint8_t>((2 * p1 + p0 + q1 + 2) >> 2);
      s[0] = static_cast<uint8_t>((2 * q1 + q0 + p1 + 2) >> 2);
    }
  }

  void Deblock() {
    const int mbw = mb_width_;
    for (int addr = 0; addr < mbw * mb_height_; ++addr) {
      const int mbx = addr % mbw, mby = addr / mbw;
      const MbInfo& q = mbs_[addr];
      const SliceInfo& si = slices_[q.slice];
      if (si.deblock_idc == 1) continue;
      const bool left = mbx > 0 && (si.deblock_idc == 0 || mbs_[addr - 1].slice == q.slice);
      const bool top = mby > 0 && (si.deblock_idc == 0 || mbs_[addr - mbw].slice == q.slice);
      for (int dir = 0; dir < 2; ++dir) {  // vertical edges, then horizontal
        for (int e = 0; e < 4; ++e) {
          const bool mb_edge = e == 0;
          if (mb_edge && !(dir == 0 ? left : top)) continue;
          if (q.t8 && (e & 1)) continue;  // no transform edge inside an 8x8 block
          const int mb_p = mb_edge ? (dir == 0 ? addr - 1 : addr - mbw) : addr;
          // FFmpeg's filter (ff_h264_filter_mb_fast, taken on x86 where the two chroma QP offsets are equal) gives
          // every edge of an inter macroblock with the 8x8 transform and 8x8 blocks 0-2 coded bS 2 at least: what
          // the standard gives under CABAC, but also under CAVLC where such a block's four 4x4 parts hold no level.
          const bool coded_8x8 = q.kind == kMbInter && q.t8 && (q.cbp & 7) == 7 &&
                                 si.chroma_qp_offset[0] == si.chroma_qp_offset[1];
          int bs[4];
          for (int k = 0; k < 4; ++k) {
            const int bq = dir == 0 ? k * 4 + e : e * 4 + k;
            const int bp = mb_edge ? (dir == 0 ? k * 4 + 3 : 12 + k) : (dir == 0 ? bq - 1 : bq - 4);
            bs[k] = Strength(mb_p, addr, bp, bq, mb_edge);
            if (coded_8x8) bs[k] = std::max(bs[k], 2);
          }
          if (!bs[0] && !bs[1] && !bs[2] && !bs[3]) continue;
          const MbInfo& p = mbs_[mb_p];
          const int qp_p = p.kind == kMbPcm ? 0 : p.qp, qp_q = q.kind == kMbPcm ? 0 : q.qp;
          // Luma.
          {
            const int qpav = (qp_p + qp_q + 1) >> 1;
            const int ia = Clip3(0, 51, qpav + si.alpha_offset), ib = Clip3(0, 51, qpav + si.beta_offset);
            const int alpha = kAlpha[ia], beta = kBeta[ib];
            for (int i = 0; i < 16; ++i) {
              const int b = bs[i >> 2];
              if (!b) continue;
              uint8_t* s;
              int step;
              if (dir == 0) {
                s = &cur_->y[static_cast<size_t>(mby * 16 + i) * width_ + mbx * 16 + e * 4];
                step = 1;
              } else {
                s = &cur_->y[static_cast<size_t>(mby * 16 + e * 4) * width_ + mbx * 16 + i];
                step = width_;
              }
              FilterLine(s, step, b, alpha, beta, b < 4 ? kTc0[ia][b - 1] : 0, true);
            }
          }
          // Chroma: edges 0 and 2 of the luma grid fall on chroma edges 0 and 4.
          if (e & 1) continue;
          const int cs = width_ / 2;
          for (int comp = 1; comp <= 2; ++comp) {
            const int qpc_p = ChromaQp(qp_p, slices_[p.slice].chroma_qp_offset[comp - 1]);
            const int qpc_q = ChromaQp(qp_q, si.chroma_qp_offset[comp - 1]);
            const int qpav = (qpc_p + qpc_q + 1) >> 1;
            const int ia = Clip3(0, 51, qpav + si.alpha_offset), ib = Clip3(0, 51, qpav + si.beta_offset);
            const int alpha = kAlpha[ia], beta = kBeta[ib];
            for (int i = 0; i < 8; ++i) {
              const int b = bs[i >> 1];
              if (!b) continue;
              uint8_t* s;
              int step;
              if (dir == 0) {
                s = &cur_->Plane(comp)[static_cast<size_t>(mby * 8 + i) * cs + mbx * 8 + e * 2];
                step = 1;
              } else {
                s = &cur_->Plane(comp)[static_cast<size_t>(mby * 8 + e * 2) * cs + mbx * 8 + i];
                step = cs;
              }
              FilterLine(s, step, b, alpha, beta, b < 4 ? kTc0[ia][b - 1] : 0, false);
            }
          }
        }
      }
    }
  }

  // ---- state
  int length_size_ = 0;
  Sps sps_[32];
  Pps pps_[256];
  int sps_index_ = 0;
  int width_ = 0, height_ = 0, mb_width_ = 0, mb_height_ = 0;
  int crop_left_ = 0, crop_right_ = 0, crop_top_ = 0, crop_bottom_ = 0, out_width_ = 0, out_height_ = 0;
  bool seen_idr_ = false;
  PicturePtr cur_;
  Header cur_header_, header_;
  std::vector<MbInfo> mbs_;
  // Per 4x4 block of the current picture and list: the vector, |mvd| (at most 70, CABAC's contexts), the reference
  // index and the id of the picture it names (0: the list is not used); whether it was predicted in direct mode.
  std::vector<int16_t> mv_[2];
  std::vector<uint8_t> mvd_[2];
  std::vector<int8_t> ref_[2];
  std::vector<int> refpic_[2];
  std::vector<uint8_t> direct_;
  std::vector<SliceInfo> slices_;
  int slice_ = 0, next_mb_ = 0, picture_ids_ = 0;
  std::vector<PicturePtr> dpb_, ref_list_[2], output_;
  bool sps_direct_8x8_ = true;  // direct_8x8_inference_flag of the current slice's SPS
  int dsf_[32] = {};            // temporal direct's DistScaleFactor of each list 0 entry
  // FFmpeg's output state: the pictures held back, the one to output when the current one is decoded, its
  // has_b_frames, last_pocs, next_outputed_poc and the mmco_reset the next picture takes; the decode call count.
  static constexpr int64_t kNoPoc = INT32_MIN;
  std::vector<PicturePtr> delayed_;
  PicturePtr pending_output_;
  int has_b_frames_ = 0, unit_ = 0, max_output_id_ = 0;
  int64_t last_pocs_[16] = {kNoPoc, kNoPoc, kNoPoc, kNoPoc, kNoPoc, kNoPoc, kNoPoc, kNoPoc,
                            kNoPoc, kNoPoc, kNoPoc, kNoPoc, kNoPoc, kNoPoc, kNoPoc, kNoPoc};
  int64_t next_output_poc_ = kNoPoc;
  bool mmco_reset_ = false;
  int prev_ref_frame_num_ = 0, prev_frame_num_ = 0, prev_frame_num_offset_ = 0;
  int prev_poc_msb_ = 0, prev_poc_lsb_ = 0, cur_poc_msb_ = 0, cur_frame_num_offset_ = 0;
  int64_t last_poc_ = 0;
  int max_long_idx_ = -1, cur_max_frame_num_ = 16, cur_max_refs_ = 1;
  bool cabac_ = false;  // the current slice's entropy_coding_mode_flag
  CabacEngine engine_;
  uint8_t ctx_[436] = {};
  int prev_qp_delta_ = 0;  // mb_qp_delta of the previous macroblock of the slice (0 where it had none)
  int64_t stats_[kNumStats] = {};
};

void CopyMessage(const char* msg, char* err, int err_len) {
  if (err && err_len > 0) {
    std::strncpy(err, msg, err_len - 1);
    err[err_len - 1] = '\0';
  }
}

}  // namespace sr_h264

extern "C" {

void* sr_h264_stream_new(const uint8_t* config, int64_t size, char* err, int err_len) {
  try {
    return new sr_h264::Decoder(config, size > 0 ? static_cast<size_t>(size) : 0);
  } catch (const sr_h264::Unsupported& e) {
    sr_h264::CopyMessage((std::string("!") + e.what()).c_str(), err, err_len);
  } catch (const std::exception& e) {
    sr_h264::CopyMessage(e.what(), err, err_len);
  }
  return nullptr;
}

void sr_h264_stream_free(void* handle) { delete static_cast<sr_h264::Decoder*>(handle); }

int sr_h264_stream_decode(void* handle, const uint8_t* data, int64_t size, char* err, int err_len) {
  try {
    return static_cast<sr_h264::Decoder*>(handle)->Decode(data, size > 0 ? static_cast<size_t>(size) : 0);
  } catch (const sr_h264::Unsupported& e) {
    sr_h264::CopyMessage(e.what(), err, err_len);
    return -2;
  } catch (const std::exception& e) {
    sr_h264::CopyMessage(e.what(), err, err_len);
    return -1;
  }
}

int sr_h264_stream_flush(void* handle, char* err, int err_len) {
  try {
    return static_cast<sr_h264::Decoder*>(handle)->Flush();
  } catch (const std::exception& e) {
    sr_h264::CopyMessage(e.what(), err, err_len);
    return -1;
  }
}

int sr_h264_stream_unit(void* handle, int index) {
  return static_cast<const sr_h264::Decoder*>(handle)->output(index).unit;
}

void sr_h264_stream_size(void* handle, int32_t* width_height) {
  const auto* dec = static_cast<const sr_h264::Decoder*>(handle);
  width_height[0] = dec->width();
  width_height[1] = dec->height();
}

void sr_h264_stream_bgr(void* handle, int index, uint8_t* out) {
  const auto* dec = static_cast<const sr_h264::Decoder*>(handle);
  const sr_h264::Picture& pic = dec->output(index);
  const int top = dec->crop_top(), left = dec->crop_left();
  // 4:2:0 cropped in steps of 2 keeps an even height: swscale's unscaled converter.
  sr_yuv::Yuv420ToBgrUnscaled(pic.y.data() + static_cast<size_t>(top) * pic.width + left,
                              pic.u.data() + static_cast<size_t>(top / 2) * (pic.width / 2) + left / 2,
                              pic.v.data() + static_cast<size_t>(top / 2) * (pic.width / 2) + left / 2, pic.width,
                              pic.width / 2, dec->width(), dec->height(), pic.colour, out);
}

void sr_h264_stream_plane(void* handle, int index, int plane, uint8_t* out) {
  const auto* dec = static_cast<const sr_h264::Decoder*>(handle);
  const sr_h264::Picture& pic = dec->output(index);
  const int sub = plane ? 1 : 0;
  const int w = dec->width() >> sub, h = dec->height() >> sub;
  const int top = dec->crop_top() >> sub, left = dec->crop_left() >> sub, stride = pic.Stride(plane);
  const uint8_t* src = pic.Plane(plane);
  for (int y = 0; y < h; ++y)
    std::memcpy(out + static_cast<size_t>(y) * w, src + static_cast<size_t>(y + top) * stride + left, w);
}

int sr_h264_stream_stats(void* handle, int64_t* out, int n) {
  const int64_t* stats = static_cast<const sr_h264::Decoder*>(handle)->stats();
  for (int i = 0; i < n && i < sr_h264::kNumStats; ++i) out[i] = stats[i];
  return sr_h264::kNumStats;
}

}  // extern "C"
