// VP9 video (profile 0: 8-bit 4:2:0) for super_resolution_tpu_torch.utils.vp9,
// bound with ctypes: a stateful decoder behind a handle, fed one container
// payload a call, as cv2.VideoCapture's FFmpeg decodes it.
//
// Written from the VP9 Bitstream Specification, with FFmpeg's VP9 decoder as
// the behaviour to match where the two part (FFmpeg reproduces several of
// libvpx's deviations from the specification on purpose):
//   - a payload is a superframe (its index split off) of one or more frames;
//     hidden frames (show_frame = 0) are decoded and kept, show_existing_frame
//     outputs a slot without decoding;
//   - the eight reference slots, sign bias, the four saved probability
//     contexts: loaded from the context the header names (also on key and
//     intra-only frames), reset by key / error-resilient / intra-only frames,
//     saved after forward updates or backward adaptation into context 0 on
//     intra frames;
//   - segmentation with FFmpeg's rule for the map a frame predicts from: the
//     map of the last frame that wrote one, kept while later frames leave
//     theirs alone, dropped by key, intra-only and error-resilient frames;
//   - motion-vector candidates as FFmpeg's find_ref_mvs lists them (its
//     sub-8x8 quirks included), clamped 16 pixels past the block's edges;
//   - intra edges from the unfiltered picture, the row above available across
//     tile rows, the column to the left not across tile columns, above-right
//     pixels only for 4x4 transforms inside their block, pixels past the
//     8-pixel-aligned picture replicated;
//   - the loop filter on libvpx's 64x64 masks, after the frame, superblock by
//     superblock.
// Shown frames are converted to BGR24 with swscale's arithmetic
// (swscale_bgr.h), as cv2.VideoCapture converts them at any size.
//
// C interface:
//   void* sr_vp9_stream_new()              a decoder; sr_vp9_stream_free(h) ends it
//   int sr_vp9_stream_decode(void* h, const uint8_t* data, int64_t size, char* err, int err_len)
//     the number of frames the payload shows (0, 1 or more), -1: corrupt
//     data, -2: a feature the decoder refuses (the message in err names it)
//   void sr_vp9_stream_size(void* h, int32_t* width_height)
//   void sr_vp9_stream_bgr(void* h, int index, uint8_t* out)
//     shown frame `index` of the last payload, height x width x 3
//   void sr_vp9_stream_plane(void* h, int index, int plane, uint8_t* out)
//     plane 0 / 1 / 2 (Y, U, V) of shown frame `index`, its rows packed
//   int sr_vp9_stream_stats(void* h, int64_t* out, int n)
//     the first n of the Stat counts; returns how many there are
//   int sr_vp9_stream_profile(void* h, int64_t* out, int n)
//     nanoseconds spent in each decoding stage (mode info, tokens, intra
//     prediction, inter prediction, inverse transforms, loop filter) where the
//     library is built with -DSR_VP9_PROFILE (scripts/profile_vp9_decode.py),
//     zeros otherwise; returns the number of stages
//
// Build: g++ -O3 -shared -fPIC -std=c++17 vp9_decoder.cpp -o <lib>.so
// (native/__init__.py does this at first use, into
// super_resolution_tpu_torch/_build/).

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

#include "vp9_tables.h"
#include "swscale_bgr.h"

namespace sr_vp9 {

struct Unsupported : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// The counts a stream's decode keeps (utils/vp9.py names them in this order).
enum Stat {
  kFrames, kKeyFrames, kInterFrames, kIntraOnlyFrames, kHiddenFrames, kShownAgain, kSuperframes,
  kDcPred, kVPred, kHPred, kD45Pred, kD135Pred, kD117Pred, kD153Pred, kD207Pred, kD63Pred, kTmPred,
  kNearestMv, kNearMv, kZeroMv, kNewMv,
  kIntraBlocks, kLastBlocks, kGoldenBlocks, kAltrefBlocks, kCompoundBlocks, kSub8x8Blocks, kSkipBlocks,
  kIntraInInterFrames,
  kFilterRegular, kFilterSmooth, kFilterSharp, kFilterBilinear,
  kTx4x4, kTx8x8, kTx16x16, kTx32x32,
  kPartitionNone, kPartitionHorz, kPartitionVert, kPartitionSplit,
  kRefresh0, kRefresh1, kRefresh2, kRefresh3, kRefresh4, kRefresh5, kRefresh6, kRefresh7,
  kSignBiasFrames, kCompoundFixedFrames, kCompoundSelectFrames, kSwitchableFilterFrames, kHighPrecisionFrames,
  kTileColFrames, kTileRowFrames, kSegmentedFrames, kSegmentMapUpdates, kSegmentTemporalUpdates,
  kSegmentDataUpdates, kSegmentAltQ, kSegmentAltLf, kSegmentRef, kSegmentSkip,
  kLosslessFrames, kErrorResilientFrames, kAdaptedFrames, kParallelFrames, kContextNotRefreshed,
  kResetContext2, kResetContext3, kContext0, kContext1, kContext2, kContext3,
  kTxSelectFrames, kLfDeltaUpdates, kSharpFrames, kLfZeroFrames, kOddSizeFrames, kFarMvBlocks,
  kNumStats
};

enum Stage { kStageModes, kStageTokens, kStageIntra, kStageInter, kStageTransforms, kStageLoopFilter, kNumStages };

// Adds the time of its scope to a stage's total, in a library built with -DSR_VP9_PROFILE.
struct StageTimer {
  explicit StageTimer(int64_t* total) : total_(total), start_(std::chrono::steady_clock::now()) {}
  ~StageTimer() {
    *total_ += std::chrono::duration_cast<std::chrono::nanoseconds>(std::chrono::steady_clock::now() - start_).count();
  }
  int64_t* total_;
  std::chrono::steady_clock::time_point start_;
};

#ifdef SR_VP9_PROFILE
#define SR_VP9_STAGE(stage) StageTimer stage_timer(&profile_ns_[stage])
#else
#define SR_VP9_STAGE(stage)
#endif

// ---------------------------------------------------------------------------------------------
// Bit readers

class BitReader {  // the uncompressed header: most significant bit first
 public:
  BitReader(const uint8_t* data, size_t size) : data_(data), size_(size) {}
  int Bit() {
    if (pos_ >= size_ * 8) throw Corrupt("truncated frame header");
    const int bit = (data_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1;
    ++pos_;
    return bit;
  }
  int Bits(int n) {
    int v = 0;
    while (n--) v = (v << 1) | Bit();
    return v;
  }
  int Signed(int n) {  // magnitude, then sign
    const int v = Bits(n);
    return Bit() ? -v : v;
  }
  size_t Bytes() const { return (pos_ + 7) >> 3; }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
};

class BoolDecoder {  // the arithmetic-coded partitions, as libvpx's vpx_reader (zeros past the end)
 public:
  void Init(const uint8_t* data, size_t size) {
    buf_ = data;
    end_ = data + size;
    value_ = 0;
    count_ = -8;
    range_ = 255;
    Fill();
    if (Read(128)) throw Corrupt("marker bit set in a bool-coded partition");
  }
  int Read(int prob) {
    const unsigned split = (range_ * prob + (256 - prob)) >> 8;
    if (count_ < 0) Fill();
    const uint64_t big = static_cast<uint64_t>(split) << 56;
    int bit;
    if (value_ >= big) {
      range_ -= split;
      value_ -= big;
      bit = 1;
    } else {
      range_ = split;
      bit = 0;
    }
    const int shift = __builtin_clz(range_) - 24;
    range_ <<= shift;
    value_ <<= shift;
    count_ -= shift;
    return bit;
  }
  int Literal(int n) {
    int v = 0;
    while (n--) v = (v << 1) | Read(128);
    return v;
  }
  int Tree(const int8_t* tree, const uint8_t* probs) {
    int i = 0;
    while ((i = tree[i + Read(probs[i >> 1])]) > 0) {
    }
    return -i;
  }

 private:
  void Fill() {
    int shift = 64 - 8 - (count_ + 8);
    while (shift >= 0) {
      if (buf_ >= end_) {
        count_ += 0x4000;
        break;
      }
      count_ += 8;
      value_ |= static_cast<uint64_t>(*buf_++) << shift;
      shift -= 8;
    }
  }
  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  int count_ = 0;
  unsigned range_ = 255;
};

// ---------------------------------------------------------------------------------------------
// Symbols, trees and small tables

enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D117_PRED, D153_PRED, D207_PRED, D63_PRED, TM_PRED };
enum { NEARESTMV = 10, NEARMV, ZEROMV, NEWMV };  // inter modes follow the intra ones
enum { INTRA_FRAME = 0, LAST_FRAME = 1, GOLDEN_FRAME = 2, ALTREF_FRAME = 3 };
enum { PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT };
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32 };
enum { ONLY_4X4, ALLOW_8X8, ALLOW_16X16, ALLOW_32X32, TX_MODE_SELECT };
enum { EIGHTTAP, EIGHTTAP_SMOOTH, EIGHTTAP_SHARP, BILINEAR, SWITCHABLE };
enum { SINGLE_REFERENCE, COMPOUND_REFERENCE, REFERENCE_MODE_SELECT };
enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST };
// Block sizes, smallest first: 4x4, 4x8, 8x4, 8x8, 8x16, 16x8, 16x16, 16x32, 32x16, 32x32, 32x64, 64x32, 64x64.
enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8, BLOCK_16X16, BLOCK_16X32, BLOCK_32X16,
       BLOCK_32X32, BLOCK_32X64, BLOCK_64X32, BLOCK_64X64 };

constexpr int8_t kIntraModeTree[18] = {-DC_PRED, 2, -TM_PRED, 4, -V_PRED, 6, 8, 12, -H_PRED, 10,
                                       -D135_PRED, -D117_PRED, -D45_PRED, 14, -D63_PRED, 16, -D153_PRED, -D207_PRED};
constexpr int8_t kSegmentTree[14] = {2, 4, 6, 8, 10, 12, 0, -1, -2, -3, -4, -5, -6, -7};
constexpr int8_t kPartitionTree[6] = {-PARTITION_NONE, 2, -PARTITION_HORZ, 4, -PARTITION_VERT, -PARTITION_SPLIT};
constexpr int8_t kInterModeTree[6] = {-2, 2, 0, 4, -1, -3};  // ZERO, NEAREST, NEAR, NEW as offsets from NEARESTMV
constexpr int8_t kInterpTree[4] = {-EIGHTTAP, 2, -EIGHTTAP_SMOOTH, -EIGHTTAP_SHARP};
constexpr int8_t kMvJointTree[6] = {0, 2, -1, 4, -2, -3};
constexpr int8_t kMvClassTree[20] = {0, 2, -1, 4, 6, 8, -2, -3, 10, 12, -4, -5, -6, 14, 16, 18, -7, -8, -9, -10};
constexpr int8_t kMvFpTree[6] = {0, 2, -1, 4, -2, -3};

constexpr uint8_t kMiWidth[13] = {1, 1, 1, 1, 1, 2, 2, 2, 4, 4, 4, 8, 8};  // in 8x8 units, at least 1
constexpr uint8_t kMiHeight[13] = {1, 1, 1, 1, 2, 1, 2, 4, 2, 4, 8, 4, 8};
constexpr uint8_t kWidth4[13] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16};  // in 4x4 units
constexpr uint8_t kHeight4[13] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16};
constexpr uint8_t kMaxTx[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3};
constexpr uint8_t kSizeGroup[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3};
constexpr uint8_t kSubsize[4][13] = {  // [partition][square block size]
    {0, 0, 0, BLOCK_8X8, 0, 0, BLOCK_16X16, 0, 0, BLOCK_32X32, 0, 0, BLOCK_64X64},
    {0, 0, 0, BLOCK_8X4, 0, 0, BLOCK_16X8, 0, 0, BLOCK_32X16, 0, 0, BLOCK_64X32},
    {0, 0, 0, BLOCK_4X8, 0, 0, BLOCK_8X16, 0, 0, BLOCK_16X32, 0, 0, BLOCK_32X64},
    {0, 0, 0, BLOCK_4X4, 0, 0, BLOCK_8X8, 0, 0, BLOCK_16X16, 0, 0, BLOCK_32X32}};
// The partition context bits a block leaves above and to its left (libvpx's partition_context_lookup).
constexpr uint8_t kAbovePartitionCtx[13] = {15, 15, 14, 14, 14, 12, 12, 12, 8, 8, 8, 0, 0};
constexpr uint8_t kLeftPartitionCtx[13] = {15, 14, 15, 14, 12, 14, 12, 8, 12, 8, 0, 8, 0};
constexpr uint8_t kTxModeToBiggest[5] = {TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_32X32};
constexpr uint8_t kModeToTxType[14] = {DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
                                       DCT_ADST, ADST_DCT, ADST_ADST, DCT_DCT, DCT_DCT, DCT_DCT, DCT_DCT};
constexpr uint8_t kLiteralToFilter[4] = {EIGHTTAP_SMOOTH, EIGHTTAP, EIGHTTAP_SHARP, BILINEAR};
constexpr int8_t kSegFeatureBits[4] = {8, 6, 2, 0};
constexpr bool kSegFeatureSigned[4] = {true, true, false, false};
// Nearby blocks the motion-vector candidates come from, (column, row) in 8x8 units (FFmpeg's mv_ref_blk_off).
constexpr int8_t kMvRefBlocks[13][8][2] = {
    {{0, -1}, {-1, 0}, {-1, -1}, {0, -2}, {-2, 0}, {-1, -2}, {-2, -1}, {-2, -2}},
    {{0, -1}, {-1, 0}, {-1, -1}, {0, -2}, {-2, 0}, {-1, -2}, {-2, -1}, {-2, -2}},
    {{0, -1}, {-1, 0}, {-1, -1}, {0, -2}, {-2, 0}, {-1, -2}, {-2, -1}, {-2, -2}},
    {{0, -1}, {-1, 0}, {-1, -1}, {0, -2}, {-2, 0}, {-1, -2}, {-2, -1}, {-2, -2}},
    {{-1, 0}, {0, -1}, {-1, 1}, {-1, -1}, {-2, 0}, {0, -2}, {-1, -2}, {-2, -1}},
    {{0, -1}, {-1, 0}, {1, -1}, {-1, -1}, {0, -2}, {-2, 0}, {-2, -1}, {-1, -2}},
    {{0, -1}, {-1, 0}, {1, -1}, {-1, 1}, {-1, -1}, {0, -3}, {-3, 0}, {-3, -3}},
    {{-1, 0}, {0, -1}, {-1, 2}, {-1, -1}, {1, -1}, {-3, 0}, {0, -3}, {-3, -3}},
    {{0, -1}, {-1, 0}, {2, -1}, {-1, -1}, {-1, 1}, {0, -3}, {-3, 0}, {-3, -3}},
    {{1, -1}, {-1, 1}, {2, -1}, {-1, 2}, {-1, -1}, {0, -3}, {-3, 0}, {-3, -3}},
    {{-1, 0}, {0, -1}, {-1, 4}, {2, -1}, {-1, -1}, {-3, 0}, {0, -3}, {-1, 2}},
    {{0, -1}, {-1, 0}, {4, -1}, {-1, 2}, {-1, -1}, {0, -3}, {-3, 0}, {2, -1}},
    {{3, -1}, {-1, 3}, {4, -1}, {-1, 4}, {-1, -1}, {0, -1}, {-1, 0}, {6, -1}}};
// libvpx's counter_to_context: the inter-mode context from the two nearest neighbours' modes.
constexpr uint8_t kCounterToContext[19] = {2, 3, 4, 1, 3, 9, 0, 9, 9, 5, 5, 9, 5, 9, 9, 9, 9, 9, 6};
constexpr uint8_t kInvMapTable[255] = {
    7,   20,  33,  46,  59,  72,  85,  98,  111, 124, 137, 150, 163, 176, 189, 202, 215, 228, 241, 254, 1,   2,
    3,   4,   5,   6,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,  19,  21,  22,  23,  24,  25,  26,
    27,  28,  29,  30,  31,  32,  34,  35,  36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  47,  48,  49,  50,
    51,  52,  53,  54,  55,  56,  57,  58,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,  71,  73,  74,
    75,  76,  77,  78,  79,  80,  81,  82,  83,  84,  86,  87,  88,  89,  90,  91,  92,  93,  94,  95,  96,  97,
    99,  100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 110, 112, 113, 114, 115, 116, 117, 118, 119, 120, 121,
    122, 123, 125, 126, 127, 128, 129, 130, 131, 132, 133, 134, 135, 136, 138, 139, 140, 141, 142, 143, 144, 145,
    146, 147, 148, 149, 151, 152, 153, 154, 155, 156, 157, 158, 159, 160, 161, 162, 164, 165, 166, 167, 168, 169,
    170, 171, 172, 173, 174, 175, 177, 178, 179, 180, 181, 182, 183, 184, 185, 186, 187, 188, 190, 191, 192, 193,
    194, 195, 196, 197, 198, 199, 200, 201, 203, 204, 205, 206, 207, 208, 209, 210, 211, 212, 213, 214, 216, 217,
    218, 219, 220, 221, 222, 223, 224, 225, 226, 227, 229, 230, 231, 232, 233, 234, 235, 236, 237, 238, 239, 240,
    242, 243, 244, 245, 246, 247, 248, 249, 250, 251, 252, 253, 253};
// Bands of the coefficient positions: 4x4, and 8x8 and larger.
constexpr uint8_t kBand4x4[16] = {0, 1, 1, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5};
constexpr uint8_t kEnergyClass[12] = {0, 1, 2, 3, 3, 4, 4, 5, 5, 5, 5, 5};
constexpr uint8_t kCat6Probs[14] = {254, 254, 254, 252, 249, 243, 230, 196, 177, 153, 140, 133, 130, 129};

// ---------------------------------------------------------------------------------------------
// Probabilities and counts

struct MvComponentProbs {
  uint8_t sign, classes[10], class0, bits[10], class0_fp[2][3], fp[3], class0_hp, hp;
};

struct ModeProbs {  // everything but the coefficients
  uint8_t y_mode[4][9], uv_mode[10][9], partition[16][3], skip[3], tx8[2][1], tx16[2][2], tx32[2][3];
  uint8_t interp[4][2], inter_mode[7][3], intra_inter[4], comp_inter[5], single_ref[5][2], comp_ref[5];
  uint8_t mv_joints[3];
  MvComponentProbs mv[2];
};

struct ProbContext {
  uint8_t coef[4][2][2][6][6][3];
  ModeProbs p;
};

struct MvComponentCounts {
  uint32_t sign[2], classes[11], class0[2], bits[10][2], class0_fp[2][4], fp[4], class0_hp[2], hp[2];
};

struct Counts {
  uint32_t coef[4][2][2][6][6][3];  // ZERO, ONE, larger tokens
  uint32_t eob[4][2][2][6][6][2];   // no more coefficients, more
  uint32_t y_mode[4][10], uv_mode[10][10], partition[16][4], skip[3][2], tx8[2][2], tx16[2][3], tx32[2][4];
  uint32_t interp[4][3], inter_mode[7][4], intra_inter[4][2], comp_inter[5][2], single_ref[5][2][2], comp_ref[5][2];
  uint32_t mv_joints[4];
  MvComponentCounts mv[2];
};

ProbContext DefaultProbs() {
  static const uint8_t kInterp[4][2] = {{235, 162}, {36, 255}, {34, 3}, {149, 144}};
  static const uint8_t kInterMode[7][3] = {{2, 173, 34}, {7, 145, 85}, {7, 166, 63}, {7, 94, 66},
                                           {8, 64, 46},  {17, 81, 31}, {25, 29, 30}};
  static const uint8_t kIntraInter[4] = {9, 102, 187, 225};
  static const uint8_t kCompInter[5] = {239, 183, 119, 96, 41};
  static const uint8_t kSingleRef[5][2] = {{33, 16}, {77, 74}, {142, 142}, {172, 170}, {238, 247}};
  static const uint8_t kCompRef[5] = {50, 126, 123, 221, 226};
  static const uint8_t kTx8[2][1] = {{100}, {66}};
  static const uint8_t kTx16[2][2] = {{20, 152}, {15, 101}};
  static const uint8_t kTx32[2][3] = {{3, 136, 37}, {5, 52, 13}};
  static const uint8_t kSkip[3] = {192, 128, 64};
  static const uint8_t kMvJoints[3] = {32, 64, 96};
  static const MvComponentProbs kMv[2] = {
      {128, {224, 144, 192, 168, 192, 176, 192, 198, 198, 245}, 216, {136, 140, 148, 160, 176, 192, 224, 234, 234, 240},
       {{128, 128, 64}, {96, 112, 64}}, {64, 96, 64}, 160, 128},
      {128, {216, 128, 176, 160, 176, 176, 192, 198, 198, 208}, 208, {136, 140, 148, 160, 176, 192, 224, 234, 234, 240},
       {{128, 128, 64}, {96, 112, 64}}, {64, 96, 64}, 160, 128}};
  ProbContext c;
  std::memcpy(c.coef, kDefaultCoefProbs, sizeof(c.coef));
  std::memcpy(c.p.y_mode, kDefaultYModeProbs, sizeof(c.p.y_mode));
  std::memcpy(c.p.uv_mode, kDefaultUvModeProbs, sizeof(c.p.uv_mode));
  std::memcpy(c.p.partition, kDefaultPartitionProbs, sizeof(c.p.partition));
  std::memcpy(c.p.skip, kSkip, sizeof(kSkip));
  std::memcpy(c.p.tx8, kTx8, sizeof(kTx8));
  std::memcpy(c.p.tx16, kTx16, sizeof(kTx16));
  std::memcpy(c.p.tx32, kTx32, sizeof(kTx32));
  std::memcpy(c.p.interp, kInterp, sizeof(kInterp));
  std::memcpy(c.p.inter_mode, kInterMode, sizeof(kInterMode));
  std::memcpy(c.p.intra_inter, kIntraInter, sizeof(kIntraInter));
  std::memcpy(c.p.comp_inter, kCompInter, sizeof(kCompInter));
  std::memcpy(c.p.single_ref, kSingleRef, sizeof(kSingleRef));
  std::memcpy(c.p.comp_ref, kCompRef, sizeof(kCompRef));
  std::memcpy(c.p.mv_joints, kMvJoints, sizeof(kMvJoints));
  c.p.mv[0] = kMv[0];
  c.p.mv[1] = kMv[1];
  return c;
}

// A saved probability moved toward the frame's counts (FFmpeg's adapt_prob).
void AdaptProb(uint8_t* p, uint32_t ct0, uint32_t ct1, uint32_t max_count, uint32_t update_factor) {
  const uint32_t ct = ct0 + ct1;
  if (!ct) return;
  const uint32_t factor = update_factor * std::min(ct, max_count) / max_count;
  const int p1 = *p;
  int p2 = static_cast<int>(((static_cast<int64_t>(ct0) << 8) + (ct >> 1)) / ct);
  p2 = std::clamp(p2, 1, 255);
  *p = static_cast<uint8_t>(p1 + (((p2 - p1) * static_cast<int>(factor) + 128) >> 8));
}

void AdaptMode(uint8_t* p, const uint32_t* c) {  // a tree in the intra-mode tree's shape
  uint32_t sum = 0;
  for (int i = 0; i < 10; ++i) sum += c[i];
  sum -= c[DC_PRED];
  AdaptProb(&p[0], c[DC_PRED], sum, 20, 128);
  sum -= c[TM_PRED];
  AdaptProb(&p[1], c[TM_PRED], sum, 20, 128);
  sum -= c[V_PRED];
  AdaptProb(&p[2], c[V_PRED], sum, 20, 128);
  uint32_t s2 = c[H_PRED] + c[D135_PRED] + c[D117_PRED];
  sum -= s2;
  AdaptProb(&p[3], s2, sum, 20, 128);
  s2 -= c[H_PRED];
  AdaptProb(&p[4], c[H_PRED], s2, 20, 128);
  AdaptProb(&p[5], c[D135_PRED], c[D117_PRED], 20, 128);
  sum -= c[D45_PRED];
  AdaptProb(&p[6], c[D45_PRED], sum, 20, 128);
  sum -= c[D63_PRED];
  AdaptProb(&p[7], c[D63_PRED], sum, 20, 128);
  AdaptProb(&p[8], c[D153_PRED], c[D207_PRED], 20, 128);
}

// ---------------------------------------------------------------------------------------------
// Inverse transforms (libvpx's C arithmetic: 14-bit cosine constants, rounding after each rotation)

constexpr int kCos[32] = {16384, 16364, 16305, 16207, 16069, 15893, 15679, 15426, 15137, 14811, 14449,
                          14053, 13623, 13160, 12665, 12140, 11585, 11003, 10394, 9760,  9102,  8423,
                          7723,  7005,  6270,  5520,  4756,  3981,  3196,  2404,  1606,  804};
constexpr int kSinPi19 = 5283, kSinPi29 = 9929, kSinPi39 = 13377, kSinPi49 = 15212;

inline int Rs(int64_t x) { return static_cast<int>((x + (1 << 13)) >> 14); }

void Idct4(const int* in, int* out) {
  const int s0 = Rs(static_cast<int64_t>(in[0] + in[2]) * kCos[16]);
  const int s1 = Rs(static_cast<int64_t>(in[0] - in[2]) * kCos[16]);
  const int s2 = Rs(static_cast<int64_t>(in[1]) * kCos[24] - static_cast<int64_t>(in[3]) * kCos[8]);
  const int s3 = Rs(static_cast<int64_t>(in[1]) * kCos[8] + static_cast<int64_t>(in[3]) * kCos[24]);
  out[0] = s0 + s3;
  out[1] = s1 + s2;
  out[2] = s1 - s2;
  out[3] = s0 - s3;
}

// Rotation: (a * c1 - b * c2, a * c2 + b * c1), each rounded.
inline void Rot(int a, int b, int c1, int c2, int* x, int* y) {
  *x = Rs(static_cast<int64_t>(a) * c1 - static_cast<int64_t>(b) * c2);
  *y = Rs(static_cast<int64_t>(a) * c2 + static_cast<int64_t>(b) * c1);
}

void Idct8(const int* in, int* out) {
  int even_in[4] = {in[0], in[2], in[4], in[6]}, e[4];
  Idct4(even_in, e);
  int s4, s7, s5, s6;
  Rot(in[1], in[7], kCos[28], kCos[4], &s4, &s7);
  Rot(in[5], in[3], kCos[12], kCos[20], &s5, &s6);
  const int t4 = s4 + s5, t5 = s4 - s5, t6 = -s6 + s7, t7 = s6 + s7;
  const int u5 = Rs(static_cast<int64_t>(t6 - t5) * kCos[16]);
  const int u6 = Rs(static_cast<int64_t>(t5 + t6) * kCos[16]);
  const int o[4] = {t4, u5, u6, t7};
  for (int i = 0; i < 4; ++i) {
    out[i] = e[i] + o[3 - i];
    out[7 - i] = e[i] - o[3 - i];
  }
}

void Idct16(const int* in, int* out) {
  int even_in[8], e[8];
  for (int i = 0; i < 8; ++i) even_in[i] = in[2 * i];
  Idct8(even_in, e);
  int s8, s15, s9, s14, s10, s13, s11, s12;
  Rot(in[1], in[15], kCos[30], kCos[2], &s8, &s15);
  Rot(in[9], in[7], kCos[14], kCos[18], &s9, &s14);
  Rot(in[5], in[11], kCos[22], kCos[10], &s10, &s13);
  Rot(in[13], in[3], kCos[6], kCos[26], &s11, &s12);
  const int t8 = s8 + s9, t9 = s8 - s9, t10 = -s10 + s11, t11 = s10 + s11;
  const int t12 = s12 + s13, t13 = s12 - s13, t14 = -s14 + s15, t15 = s14 + s15;
  int u9, u14, u10, u13;
  u9 = Rs(-static_cast<int64_t>(t9) * kCos[8] + static_cast<int64_t>(t14) * kCos[24]);
  u14 = Rs(static_cast<int64_t>(t9) * kCos[24] + static_cast<int64_t>(t14) * kCos[8]);
  u10 = Rs(-static_cast<int64_t>(t10) * kCos[24] - static_cast<int64_t>(t13) * kCos[8]);
  u13 = Rs(-static_cast<int64_t>(t10) * kCos[8] + static_cast<int64_t>(t13) * kCos[24]);
  const int u8 = t8, u11 = t11, u12 = t12, u15 = t15;
  const int v8 = u8 + u11, v9 = u9 + u10, v10 = u9 - u10, v11 = u8 - u11;
  const int v12 = -u12 + u15, v13 = -u13 + u14, v14 = u13 + u14, v15 = u12 + u15;
  const int w10 = Rs(static_cast<int64_t>(-v10 + v13) * kCos[16]);
  const int w13 = Rs(static_cast<int64_t>(v10 + v13) * kCos[16]);
  const int w11 = Rs(static_cast<int64_t>(-v11 + v12) * kCos[16]);
  const int w12 = Rs(static_cast<int64_t>(v11 + v12) * kCos[16]);
  const int o[8] = {v8, v9, w10, w11, w12, w13, v14, v15};
  for (int i = 0; i < 8; ++i) {
    out[i] = e[i] + o[7 - i];
    out[15 - i] = e[i] - o[7 - i];
  }
}

void Idct32(const int* in, int* out) {
  int even_in[16], e[16];
  for (int i = 0; i < 16; ++i) even_in[i] = in[2 * i];
  Idct16(even_in, e);
  int a[32];  // the odd half, indices 16..31 as in libvpx's idct32_c
  Rot(in[1], in[31], kCos[31], kCos[1], &a[16], &a[31]);
  Rot(in[17], in[15], kCos[15], kCos[17], &a[17], &a[30]);
  Rot(in[9], in[23], kCos[23], kCos[9], &a[18], &a[29]);
  Rot(in[25], in[7], kCos[7], kCos[25], &a[19], &a[28]);
  Rot(in[5], in[27], kCos[27], kCos[5], &a[20], &a[27]);
  Rot(in[21], in[11], kCos[11], kCos[21], &a[21], &a[26]);
  Rot(in[13], in[19], kCos[19], kCos[13], &a[22], &a[25]);
  Rot(in[29], in[3], kCos[3], kCos[29], &a[23], &a[24]);
  int b[32];  // stage 2
  b[16] = a[16] + a[17];
  b[17] = a[16] - a[17];
  b[18] = -a[18] + a[19];
  b[19] = a[18] + a[19];
  b[20] = a[20] + a[21];
  b[21] = a[20] - a[21];
  b[22] = -a[22] + a[23];
  b[23] = a[22] + a[23];
  b[24] = a[24] + a[25];
  b[25] = a[24] - a[25];
  b[26] = -a[26] + a[27];
  b[27] = a[26] + a[27];
  b[28] = a[28] + a[29];
  b[29] = a[28] - a[29];
  b[30] = -a[30] + a[31];
  b[31] = a[30] + a[31];
  int c[32];  // stage 3
  c[16] = b[16];
  c[31] = b[31];
  c[17] = Rs(-static_cast<int64_t>(b[17]) * kCos[4] + static_cast<int64_t>(b[30]) * kCos[28]);
  c[30] = Rs(static_cast<int64_t>(b[17]) * kCos[28] + static_cast<int64_t>(b[30]) * kCos[4]);
  c[18] = Rs(-static_cast<int64_t>(b[18]) * kCos[28] - static_cast<int64_t>(b[29]) * kCos[4]);
  c[29] = Rs(-static_cast<int64_t>(b[18]) * kCos[4] + static_cast<int64_t>(b[29]) * kCos[28]);
  c[19] = b[19];
  c[20] = b[20];
  c[21] = Rs(-static_cast<int64_t>(b[21]) * kCos[20] + static_cast<int64_t>(b[26]) * kCos[12]);
  c[26] = Rs(static_cast<int64_t>(b[21]) * kCos[12] + static_cast<int64_t>(b[26]) * kCos[20]);
  c[22] = Rs(-static_cast<int64_t>(b[22]) * kCos[12] - static_cast<int64_t>(b[25]) * kCos[20]);
  c[25] = Rs(-static_cast<int64_t>(b[22]) * kCos[20] + static_cast<int64_t>(b[25]) * kCos[12]);
  c[23] = b[23];
  c[24] = b[24];
  c[27] = b[27];
  c[28] = b[28];
  int d[32];  // stage 4
  d[16] = c[16] + c[19];
  d[17] = c[17] + c[18];
  d[18] = c[17] - c[18];
  d[19] = c[16] - c[19];
  d[20] = -c[20] + c[23];
  d[21] = -c[21] + c[22];
  d[22] = c[21] + c[22];
  d[23] = c[20] + c[23];
  d[24] = c[24] + c[27];
  d[25] = c[25] + c[26];
  d[26] = c[25] - c[26];
  d[27] = c[24] - c[27];
  d[28] = -c[28] + c[31];
  d[29] = -c[29] + c[30];
  d[30] = c[29] + c[30];
  d[31] = c[28] + c[31];
  int f[32];  // stage 5
  f[16] = d[16];
  f[17] = d[17];
  f[18] = Rs(-static_cast<int64_t>(d[18]) * kCos[8] + static_cast<int64_t>(d[29]) * kCos[24]);
  f[29] = Rs(static_cast<int64_t>(d[18]) * kCos[24] + static_cast<int64_t>(d[29]) * kCos[8]);
  f[19] = Rs(-static_cast<int64_t>(d[19]) * kCos[8] + static_cast<int64_t>(d[28]) * kCos[24]);
  f[28] = Rs(static_cast<int64_t>(d[19]) * kCos[24] + static_cast<int64_t>(d[28]) * kCos[8]);
  f[20] = Rs(-static_cast<int64_t>(d[20]) * kCos[24] - static_cast<int64_t>(d[27]) * kCos[8]);
  f[27] = Rs(-static_cast<int64_t>(d[20]) * kCos[8] + static_cast<int64_t>(d[27]) * kCos[24]);
  f[21] = Rs(-static_cast<int64_t>(d[21]) * kCos[24] - static_cast<int64_t>(d[26]) * kCos[8]);
  f[26] = Rs(-static_cast<int64_t>(d[21]) * kCos[8] + static_cast<int64_t>(d[26]) * kCos[24]);
  f[22] = d[22];
  f[23] = d[23];
  f[24] = d[24];
  f[25] = d[25];
  f[30] = d[30];
  f[31] = d[31];
  int g[32];  // stage 6
  g[16] = f[16] + f[23];
  g[17] = f[17] + f[22];
  g[18] = f[18] + f[21];
  g[19] = f[19] + f[20];
  g[20] = f[19] - f[20];
  g[21] = f[18] - f[21];
  g[22] = f[17] - f[22];
  g[23] = f[16] - f[23];
  g[24] = -f[24] + f[31];
  g[25] = -f[25] + f[30];
  g[26] = -f[26] + f[29];
  g[27] = -f[27] + f[28];
  g[28] = f[27] + f[28];
  g[29] = f[26] + f[29];
  g[30] = f[25] + f[30];
  g[31] = f[24] + f[31];
  int h[32];  // stage 7
  for (int i = 16; i < 20; ++i) h[i] = g[i];
  for (int i = 28; i < 32; ++i) h[i] = g[i];
  for (int k = 0; k < 4; ++k) {
    const int lo = 20 + k, hi = 27 - k;
    h[lo] = Rs(static_cast<int64_t>(-g[lo] + g[hi]) * kCos[16]);
    h[hi] = Rs(static_cast<int64_t>(g[lo] + g[hi]) * kCos[16]);
  }
  for (int i = 0; i < 16; ++i) {
    out[i] = e[i] + h[31 - i];
    out[31 - i] = e[i] - h[31 - i];
  }
}

void Iadst4(const int* in, int* out) {
  const int64_t x0 = in[0], x1 = in[1], x2 = in[2], x3 = in[3];
  if (!(x0 | x1 | x2 | x3)) {
    out[0] = out[1] = out[2] = out[3] = 0;
    return;
  }
  int64_t s0 = kSinPi19 * x0, s1 = kSinPi29 * x0, s2 = kSinPi39 * x1, s3 = kSinPi49 * x2;
  const int64_t s4 = kSinPi19 * x2, s5 = kSinPi29 * x3, s6 = kSinPi49 * x3, s7 = x0 - x2 + x3;
  s0 = s0 + s3 + s5;
  s1 = s1 - s4 - s6;
  s3 = s2;
  s2 = kSinPi39 * s7;
  out[0] = Rs(s0 + s3);
  out[1] = Rs(s1 + s3);
  out[2] = Rs(s2);
  out[3] = Rs(s0 + s1 - s3);
}

void Iadst8(const int* in, int* out) {
  int64_t x0 = in[7], x1 = in[0], x2 = in[5], x3 = in[2], x4 = in[3], x5 = in[4], x6 = in[1], x7 = in[6];
  if (!(x0 | x1 | x2 | x3 | x4 | x5 | x6 | x7)) {
    for (int i = 0; i < 8; ++i) out[i] = 0;
    return;
  }
  int64_t s0 = kCos[2] * x0 + kCos[30] * x1, s1 = kCos[30] * x0 - kCos[2] * x1;
  int64_t s2 = kCos[10] * x2 + kCos[22] * x3, s3 = kCos[22] * x2 - kCos[10] * x3;
  int64_t s4 = kCos[18] * x4 + kCos[14] * x5, s5 = kCos[14] * x4 - kCos[18] * x5;
  int64_t s6 = kCos[26] * x6 + kCos[6] * x7, s7 = kCos[6] * x6 - kCos[26] * x7;
  x0 = Rs(s0 + s4);
  x1 = Rs(s1 + s5);
  x2 = Rs(s2 + s6);
  x3 = Rs(s3 + s7);
  x4 = Rs(s0 - s4);
  x5 = Rs(s1 - s5);
  x6 = Rs(s2 - s6);
  x7 = Rs(s3 - s7);
  s0 = x0;
  s1 = x1;
  s2 = x2;
  s3 = x3;
  s4 = kCos[8] * x4 + kCos[24] * x5;
  s5 = kCos[24] * x4 - kCos[8] * x5;
  s6 = -kCos[24] * x6 + kCos[8] * x7;
  s7 = kCos[8] * x6 + kCos[24] * x7;
  x0 = s0 + s2;
  x1 = s1 + s3;
  x2 = s0 - s2;
  x3 = s1 - s3;
  x4 = Rs(s4 + s6);
  x5 = Rs(s5 + s7);
  x6 = Rs(s4 - s6);
  x7 = Rs(s5 - s7);
  s2 = kCos[16] * (x2 + x3);
  s3 = kCos[16] * (x2 - x3);
  s6 = kCos[16] * (x6 + x7);
  s7 = kCos[16] * (x6 - x7);
  x2 = Rs(s2);
  x3 = Rs(s3);
  x6 = Rs(s6);
  x7 = Rs(s7);
  out[0] = static_cast<int>(x0);
  out[1] = static_cast<int>(-x4);
  out[2] = static_cast<int>(x6);
  out[3] = static_cast<int>(-x2);
  out[4] = static_cast<int>(x3);
  out[5] = static_cast<int>(-x7);
  out[6] = static_cast<int>(x5);
  out[7] = static_cast<int>(-x1);
}

void Iadst16(const int* in, int* out) {
  int64_t x[16] = {in[15], in[0], in[13], in[2], in[11], in[4], in[9], in[6],
                   in[7],  in[8], in[5],  in[10], in[3], in[12], in[1], in[14]};
  int64_t any = 0;
  for (int i = 0; i < 16; ++i) any |= x[i];
  if (!any) {
    for (int i = 0; i < 16; ++i) out[i] = 0;
    return;
  }
  int64_t s[16];
  // stage 1
  s[0] = x[0] * kCos[1] + x[1] * kCos[31];
  s[1] = x[0] * kCos[31] - x[1] * kCos[1];
  s[2] = x[2] * kCos[5] + x[3] * kCos[27];
  s[3] = x[2] * kCos[27] - x[3] * kCos[5];
  s[4] = x[4] * kCos[9] + x[5] * kCos[23];
  s[5] = x[4] * kCos[23] - x[5] * kCos[9];
  s[6] = x[6] * kCos[13] + x[7] * kCos[19];
  s[7] = x[6] * kCos[19] - x[7] * kCos[13];
  s[8] = x[8] * kCos[17] + x[9] * kCos[15];
  s[9] = x[8] * kCos[15] - x[9] * kCos[17];
  s[10] = x[10] * kCos[21] + x[11] * kCos[11];
  s[11] = x[10] * kCos[11] - x[11] * kCos[21];
  s[12] = x[12] * kCos[25] + x[13] * kCos[7];
  s[13] = x[12] * kCos[7] - x[13] * kCos[25];
  s[14] = x[14] * kCos[29] + x[15] * kCos[3];
  s[15] = x[14] * kCos[3] - x[15] * kCos[29];
  for (int i = 0; i < 8; ++i) {
    x[i] = Rs(s[i] + s[i + 8]);
    x[i + 8] = Rs(s[i] - s[i + 8]);
  }
  // stage 2
  for (int i = 0; i < 8; ++i) s[i] = x[i];
  s[8] = x[8] * kCos[4] + x[9] * kCos[28];
  s[9] = x[8] * kCos[28] - x[9] * kCos[4];
  s[10] = x[10] * kCos[20] + x[11] * kCos[12];
  s[11] = x[10] * kCos[12] - x[11] * kCos[20];
  s[12] = -x[12] * kCos[28] + x[13] * kCos[4];
  s[13] = x[12] * kCos[4] + x[13] * kCos[28];
  s[14] = -x[14] * kCos[12] + x[15] * kCos[20];
  s[15] = x[14] * kCos[20] + x[15] * kCos[12];
  for (int i = 0; i < 4; ++i) {
    x[i] = s[i] + s[i + 4];
    x[i + 4] = s[i] - s[i + 4];
    x[i + 8] = Rs(s[i + 8] + s[i + 12]);
    x[i + 12] = Rs(s[i + 8] - s[i + 12]);
  }
  // stage 3
  s[0] = x[0];
  s[1] = x[1];
  s[2] = x[2];
  s[3] = x[3];
  s[4] = x[4] * kCos[8] + x[5] * kCos[24];
  s[5] = x[4] * kCos[24] - x[5] * kCos[8];
  s[6] = -x[6] * kCos[24] + x[7] * kCos[8];
  s[7] = x[6] * kCos[8] + x[7] * kCos[24];
  s[8] = x[8];
  s[9] = x[9];
  s[10] = x[10];
  s[11] = x[11];
  s[12] = x[12] * kCos[8] + x[13] * kCos[24];
  s[13] = x[12] * kCos[24] - x[13] * kCos[8];
  s[14] = -x[14] * kCos[24] + x[15] * kCos[8];
  s[15] = x[14] * kCos[8] + x[15] * kCos[24];
  x[0] = s[0] + s[2];
  x[1] = s[1] + s[3];
  x[2] = s[0] - s[2];
  x[3] = s[1] - s[3];
  x[4] = Rs(s[4] + s[6]);
  x[5] = Rs(s[5] + s[7]);
  x[6] = Rs(s[4] - s[6]);
  x[7] = Rs(s[5] - s[7]);
  x[8] = s[8] + s[10];
  x[9] = s[9] + s[11];
  x[10] = s[8] - s[10];
  x[11] = s[9] - s[11];
  x[12] = Rs(s[12] + s[14]);
  x[13] = Rs(s[13] + s[15]);
  x[14] = Rs(s[12] - s[14]);
  x[15] = Rs(s[13] - s[15]);
  // stage 4
  s[2] = (-kCos[16]) * (x[2] + x[3]);
  s[3] = kCos[16] * (x[2] - x[3]);
  s[6] = kCos[16] * (x[6] + x[7]);
  s[7] = kCos[16] * (-x[6] + x[7]);
  s[10] = kCos[16] * (x[10] + x[11]);
  s[11] = kCos[16] * (-x[10] + x[11]);
  s[14] = (-kCos[16]) * (x[14] + x[15]);
  s[15] = kCos[16] * (x[14] - x[15]);
  x[2] = Rs(s[2]);
  x[3] = Rs(s[3]);
  x[6] = Rs(s[6]);
  x[7] = Rs(s[7]);
  x[10] = Rs(s[10]);
  x[11] = Rs(s[11]);
  x[14] = Rs(s[14]);
  x[15] = Rs(s[15]);
  const int64_t o[16] = {x[0], -x[8], x[12], -x[4], x[6], x[14], x[10], x[2],
                         x[3], x[11], x[15], x[7],  x[5], -x[13], x[9], -x[1]};
  for (int i = 0; i < 16; ++i) out[i] = static_cast<int>(o[i]);
}

inline uint8_t ClipPixel(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

using Transform1d = void (*)(const int*, int*);

// Adds the inverse transform of coef (n x n, row-major; tx_type's first half is the vertical
// transform) to dst: rows first, then columns, rounded by 4 / 5 / 6 / 6 bits.
void InverseTransformAdd(const int16_t* coef, int tx, int tx_type, uint8_t* dst, int stride) {
  static const Transform1d kDct[4] = {Idct4, Idct8, Idct16, Idct32};
  static const Transform1d kAdst[4] = {Iadst4, Iadst8, Iadst16, nullptr};
  const int n = 4 << tx, shift = tx == TX_4X4 ? 4 : tx == TX_8X8 ? 5 : 6;
  const Transform1d rows = (tx_type == DCT_ADST || tx_type == ADST_ADST) ? kAdst[tx] : kDct[tx];
  const Transform1d cols = (tx_type == ADST_DCT || tx_type == ADST_ADST) ? kAdst[tx] : kDct[tx];
  int tmp[32 * 32], in[32], out[32];
  for (int r = 0; r < n; ++r) {
    bool any = false;
    for (int c = 0; c < n; ++c) {
      in[c] = coef[r * n + c];
      any |= in[c] != 0;
    }
    if (any) {
      rows(in, tmp + r * n);
    } else {
      std::memset(tmp + r * n, 0, sizeof(int) * n);
    }
  }
  for (int c = 0; c < n; ++c) {
    for (int r = 0; r < n; ++r) in[r] = tmp[r * n + c];
    cols(in, out);
    for (int r = 0; r < n; ++r) {
      uint8_t* p = dst + r * stride + c;
      *p = ClipPixel(*p + ((out[r] + (1 << (shift - 1))) >> shift));
    }
  }
}

// The lossless transform: the 4x4 Walsh-Hadamard transform.
void InverseWhtAdd(const int16_t* coef, uint8_t* dst, int stride) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    int a1 = coef[4 * i] >> 2, c1 = coef[4 * i + 1] >> 2, d1 = coef[4 * i + 2] >> 2, b1 = coef[4 * i + 3] >> 2;
    a1 += c1;
    d1 -= b1;
    const int e1 = (a1 - d1) >> 1;
    b1 = e1 - b1;
    c1 = e1 - c1;
    a1 -= b1;
    d1 += c1;
    tmp[4 * i] = a1;
    tmp[4 * i + 1] = b1;
    tmp[4 * i + 2] = c1;
    tmp[4 * i + 3] = d1;
  }
  for (int i = 0; i < 4; ++i) {
    int a1 = tmp[i], c1 = tmp[4 + i], d1 = tmp[8 + i], b1 = tmp[12 + i];
    a1 += c1;
    d1 -= b1;
    const int e1 = (a1 - d1) >> 1;
    b1 = e1 - b1;
    c1 = e1 - c1;
    a1 -= b1;
    d1 += c1;
    dst[i] = ClipPixel(dst[i] + a1);
    dst[stride + i] = ClipPixel(dst[stride + i] + b1);
    dst[2 * stride + i] = ClipPixel(dst[2 * stride + i] + c1);
    dst[3 * stride + i] = ClipPixel(dst[3 * stride + i] + d1);
  }
}


// ---------------------------------------------------------------------------------------------
// Pictures and per-block state

struct Mv {
  int16_t row = 0, col = 0;
  bool operator==(const Mv& o) const { return row == o.row && col == o.col; }
  bool operator!=(const Mv& o) const { return !(*this == o); }
};

struct MvRef {  // what later frames see of a block: its references (-1: none) and vectors
  int8_t ref[2] = {-1, -1};
  Mv mv[2];
};

struct BlockInfo {
  uint8_t bsize = 0, tx = 0, skip = 0, is_inter = 0, comp = 0, seg_id = 0, filter = 0, mode = 0, uv_mode = 0;
  uint8_t level = 0;
  uint16_t row = 0, col = 0;  // top-left 8x8
  uint8_t sub_modes[4] = {0, 0, 0, 0};
  int8_t ref[2] = {0, -1};
  Mv mv[4][2];  // per 4x4 sub-block of a block under 8x8; [3] is the block's vector
};

struct Picture {
  int width = 0, height = 0, mi_cols = 0, mi_rows = 0;
  int stride = 0, uv_stride = 0, rows = 0, uv_rows = 0;
  std::vector<uint8_t> planes[3];
  std::vector<MvRef> mvs;        // one per 8x8
  std::vector<uint8_t> segmap;   // one per 8x8

  void Allocate(int w, int h) {
    width = w;
    height = h;
    mi_cols = (w + 7) >> 3;
    mi_rows = (h + 7) >> 3;
    stride = ((mi_cols + 7) >> 3) * 64;  // whole superblocks: blocks may reach past the picture
    rows = ((mi_rows + 7) >> 3) * 64;
    uv_stride = stride >> 1;
    uv_rows = rows >> 1;
    planes[0].assign(static_cast<size_t>(stride) * rows, 0);
    planes[1].assign(static_cast<size_t>(uv_stride) * uv_rows, 0);
    planes[2].assign(static_cast<size_t>(uv_stride) * uv_rows, 0);
    mvs.assign(static_cast<size_t>(mi_cols) * mi_rows, MvRef());
    segmap.assign(static_cast<size_t>(mi_cols) * mi_rows, 0);
  }
  uint8_t* Plane(int p) { return planes[p].data(); }
  const uint8_t* Plane(int p) const { return planes[p].data(); }
  int Stride(int p) const { return p ? uv_stride : stride; }
  int PlaneWidth(int p) const { return p ? (width + 1) >> 1 : width; }
  int PlaneHeight(int p) const { return p ? (height + 1) >> 1 : height; }
};

struct TileState {
  BoolDecoder bd;
  int col_start = 0, col_end = 0;  // in 8x8 units
  uint8_t left_partition[8];
  uint8_t left_nnz[3][16];
  uint8_t left_seg_pred[8];
};

// ---------------------------------------------------------------------------------------------
// The stream decoder

class Decoder {
 public:
  Decoder() {
    for (auto& c : ctx_) c = DefaultProbs();
    std::memset(stats_, 0, sizeof(stats_));
  }
  // Decodes one container payload; returns the number of frames it shows.
  int DecodePayload(const uint8_t* data, size_t size);
  int width() const { return width_; }
  int height() const { return height_; }
  const Picture& shown(int i) const { return *shown_[i]; }
  const int64_t* stats() const { return stats_; }
  const int64_t* profile() const { return profile_ns_; }

 private:
  void DecodeFrame(const uint8_t* data, size_t size);
  size_t ReadUncompressedHeader(const uint8_t* data, size_t size);
  void ReadCompressedHeader(const uint8_t* data, size_t size);
  void SetupSegmentsAndFilterLevels();
  void DecodeTiles(const uint8_t* data, size_t size);
  void DecodePartition(TileState& t, int mi_row, int mi_col, int bsize);
  void DecodeBlock(TileState& t, int mi_row, int mi_col, int bsize);
  void ReadModeInfo(TileState& t, BlockInfo& b, int mi_row, int mi_col);
  void ReadIntraFrameModes(TileState& t, BlockInfo& b, const BlockInfo* above, const BlockInfo* left);
  void ReadInterFrameModes(TileState& t, BlockInfo& b, int mi_row, int mi_col, const BlockInfo* above,
                           const BlockInfo* left);
  int ReadSegmentId(TileState& t, BlockInfo& b, int mi_row, int mi_col);
  void ReadRefFrames(TileState& t, BlockInfo& b, const BlockInfo* above, const BlockInfo* left);
  void FindRefMv(Mv* out, const BlockInfo& b, int mi_row, int mi_col, int ref, int z, int idx, int sb);
  void FillMv(TileState& t, BlockInfo& b, int mi_row, int mi_col, int mode, int sb, Mv out[2]);
  int ReadMvComponent(TileState& t, int comp, bool hp);
  int DecodeCoefficients(TileState& t, const BlockInfo& b, int plane, int x4, int y4, int tx, int tx_type,
                         int16_t* coef);
  int ReadTokens(BoolDecoder& bd, int16_t* coef, int tx, int tx_type, int plane, bool is_inter, int ctx,
                 const int16_t* dq);
  void ReconstructIntra(TileState& t, BlockInfo& b, int mi_row, int mi_col);
  void PredictInter(const BlockInfo& b, int mi_row, int mi_col);
  void ReconstructInter(TileState& t, BlockInfo& b, int mi_row, int mi_col);
  void PredictIntra(int plane, int x, int y, int tx, int mode, bool have_left, bool have_top, bool have_right);
  void LoopFilterFrame();
  void LoopFilterSuperblock(int mi_row, int mi_col);
  void AdaptProbabilities();
  void Count(Stat s) { ++stats_[s]; }

  // Stream state
  ProbContext ctx_[4];
  std::shared_ptr<Picture> refs_[8];
  std::shared_ptr<Picture> cur_, mvpair_ref_, segmap_ref_;
  std::vector<std::shared_ptr<Picture>> shown_;
  int width_ = 0, height_ = 0;
  bool have_keyframe_ = false, last_keyframe_ = false, invisible_ = false;
  bool seg_enabled_ = false, seg_update_map_ = false, seg_temporal_ = false, seg_abs_ = false;
  uint8_t seg_tree_probs_[7] = {255, 255, 255, 255, 255, 255, 255}, seg_pred_probs_[3] = {255, 255, 255};
  bool seg_feature_[8][4] = {};
  int seg_data_[8][4] = {};
  int lf_ref_deltas_[4] = {1, 0, -1, -1}, lf_mode_deltas_[2] = {0, 0};
  int64_t stats_[kNumStats];
  int64_t profile_ns_[kNumStages] = {};

  // Frame header
  bool key_ = false, show_ = false, error_res_ = false, intra_only_ = false;
  int reset_ctx_ = 0, refresh_flags_ = 0, ref_idx_[3] = {0, 0, 0};
  bool sign_bias_[4] = {false, false, false, false};
  bool allow_hp_ = false, refresh_ctx_ = false, parallel_ = false, use_last_mvs_ = false;
  int interp_filter_ = 0, ctx_read_ = 0, ctx_save_ = 0;
  int lf_level_ = 0, sharpness_ = 0;
  bool lf_delta_enabled_ = false;
  int base_q_ = 0, dq_y_dc_ = 0, dq_uv_dc_ = 0, dq_uv_ac_ = 0;
  bool lossless_ = false;
  int log2_tile_cols_ = 0, log2_tile_rows_ = 0;
  size_t compressed_size_ = 0;
  int tx_mode_ = 0, ref_mode_ = 0, comp_fixed_ = 0, comp_var_[2] = {0, 0};
  int16_t dequant_[8][2][2];     // [segment][plane > 0][ac]
  uint8_t seg_levels_[8][4][2];  // [segment][reference][mode is not ZEROMV]
  uint8_t lim_[64], mblim_[64];

  // Frame decoding
  ProbContext prob_;
  Counts counts_;
  int mi_cols_ = 0, mi_rows_ = 0, sb_cols_ = 0, tile_col_start_ = 0;
  std::vector<BlockInfo> blocks_;
  std::vector<int32_t> grid_;  // block index per 8x8, -1 before it is decoded
  std::vector<uint8_t> above_partition_, above_seg_pred_;
  std::vector<uint8_t> above_nnz_[3];
  int16_t coef_[32 * 32];
};

int Decoder::DecodePayload(const uint8_t* data, size_t size) {
  shown_.clear();
  // A superframe index: its marker byte ends the payload and opens the index.
  std::vector<std::pair<const uint8_t*, size_t>> frames;
  const uint8_t marker = data[size - 1];
  bool split = false;
  if ((marker & 0xe0) == 0xc0) {
    const int n = (marker & 7) + 1, mag = ((marker >> 3) & 3) + 1;
    const size_t index_size = 2 + static_cast<size_t>(mag) * n;
    if (size >= index_size && data[size - index_size] == marker) {
      const uint8_t* p = data + size - index_size + 1;
      size_t offset = 0;
      for (int i = 0; i < n; ++i) {
        size_t frame_size = 0;
        for (int b = 0; b < mag; ++b) frame_size |= static_cast<size_t>(*p++) << (8 * b);
        if (offset + frame_size > size - index_size) throw Corrupt("superframe index past its payload");
        frames.emplace_back(data + offset, frame_size);
        offset += frame_size;
      }
      split = true;
      Count(kSuperframes);
    }
  }
  if (!split) frames.emplace_back(data, size);
  for (const auto& f : frames) {
    if (f.second == 0) continue;
    DecodeFrame(f.first, f.second);
  }
  return static_cast<int>(shown_.size());
}

size_t Decoder::ReadUncompressedHeader(const uint8_t* data, size_t size) {
  BitReader br(data, size);
  if (br.Bits(2) != 2) throw Corrupt("bad frame marker");
  int profile = br.Bit();
  profile |= br.Bit() << 1;
  if (profile == 3) br.Bit();
  if (profile != 0) throw Unsupported("profile " + std::to_string(profile) + " (only profile 0, 8-bit 4:2:0)");
  if (br.Bit()) {  // show_existing_frame
    const int idx = br.Bits(3);
    if (!refs_[idx]) throw Corrupt("show_existing_frame of an empty slot");
    shown_.push_back(refs_[idx]);
    Count(kShownAgain);
    return 0;
  }
  key_ = !br.Bit();
  const bool last_invisible = invisible_;
  show_ = br.Bit();
  invisible_ = !show_;
  error_res_ = br.Bit();
  use_last_mvs_ = !error_res_ && !last_invisible;
  int w = width_, h = height_;
  auto read_size = [&]() {
    w = br.Bits(16) + 1;
    h = br.Bits(16) + 1;
  };
  auto check_sync = [&]() {
    if (br.Bits(8) != 0x49 || br.Bits(8) != 0x83 || br.Bits(8) != 0x42) throw Corrupt("bad frame sync code");
  };
  intra_only_ = false;
  reset_ctx_ = 0;
  if (key_) {
    check_sync();
    const int color_space = br.Bits(3);
    if (color_space == 7) throw Unsupported("color_space RGB");
    if (br.Bit()) throw Unsupported("color_range 1 (full-range YUV)");
    read_size();
    if (br.Bit()) br.Bits(32);  // render size
    refresh_flags_ = 0xff;
  } else {
    intra_only_ = show_ ? false : br.Bit();
    reset_ctx_ = error_res_ ? 0 : br.Bits(2);
    if (intra_only_) {
      check_sync();
      refresh_flags_ = br.Bits(8);
      read_size();
      if (br.Bit()) br.Bits(32);
    } else {
      if (!have_keyframe_) throw Corrupt("inter frame before the first key frame");
      refresh_flags_ = br.Bits(8);
      for (int i = 0; i < 3; ++i) {
        ref_idx_[i] = br.Bits(3);
        sign_bias_[LAST_FRAME + i] = br.Bit() && !error_res_;
        if (!refs_[ref_idx_[i]]) throw Corrupt("reference to an empty slot");
      }
      bool found = false;
      for (int i = 0; i < 3 && !found; ++i) {
        if (br.Bit()) {
          w = refs_[ref_idx_[i]]->width;
          h = refs_[ref_idx_[i]]->height;
          found = true;
        }
      }
      if (!found) read_size();
      if (br.Bit()) br.Bits(32);
      allow_hp_ = br.Bit();
      interp_filter_ = br.Bit() ? static_cast<int>(SWITCHABLE) : kLiteralToFilter[br.Bits(2)];
    }
  }
  if (!key_ && !intra_only_) {
    for (int i = 0; i < 3; ++i) {
      const Picture& r = *refs_[ref_idx_[i]];
      if (r.width != w || r.height != h) throw Unsupported("a reference of another size (scaled prediction)");
    }
  }
  if (have_keyframe_ && (w != width_ || h != height_)) {
    throw Unsupported("a frame size that changes mid-stream (" + std::to_string(width_) + "x" +
                      std::to_string(height_) + " to " + std::to_string(w) + "x" + std::to_string(h) + ")");
  }
  if (!have_keyframe_ && !key_) {
    if (!intra_only_) throw Corrupt("inter frame before the first key frame");
  }
  width_ = w;
  height_ = h;
  refresh_ctx_ = error_res_ ? false : br.Bit();
  parallel_ = error_res_ ? true : br.Bit();
  ctx_read_ = br.Bits(2);
  ctx_save_ = (key_ || intra_only_) ? 0 : ctx_read_;
  if (key_ || error_res_ || intra_only_) {
    lf_ref_deltas_[0] = 1;
    lf_ref_deltas_[1] = 0;
    lf_ref_deltas_[2] = lf_ref_deltas_[3] = -1;
    lf_mode_deltas_[0] = lf_mode_deltas_[1] = 0;
    std::memset(seg_feature_, 0, sizeof(seg_feature_));
    std::memset(seg_data_, 0, sizeof(seg_data_));
  }
  if (key_ || error_res_ || (intra_only_ && reset_ctx_ == 3)) {
    for (auto& c : ctx_) c = DefaultProbs();
  } else if (intra_only_ && reset_ctx_ == 2) {
    ctx_[ctx_read_] = DefaultProbs();
  }
  // Loop filter
  lf_level_ = br.Bits(6);
  sharpness_ = br.Bits(3);
  lf_delta_enabled_ = br.Bit();
  if (lf_delta_enabled_ && br.Bit()) {
    Count(kLfDeltaUpdates);
    for (int i = 0; i < 4; ++i)
      if (br.Bit()) lf_ref_deltas_[i] = br.Signed(6);
    for (int i = 0; i < 2; ++i)
      if (br.Bit()) lf_mode_deltas_[i] = br.Signed(6);
  }
  // Quantisation
  base_q_ = br.Bits(8);
  auto delta_q = [&]() { return br.Bit() ? br.Signed(4) : 0; };
  dq_y_dc_ = delta_q();
  dq_uv_dc_ = delta_q();
  dq_uv_ac_ = delta_q();
  lossless_ = base_q_ == 0 && dq_y_dc_ == 0 && dq_uv_dc_ == 0 && dq_uv_ac_ == 0;
  // Segmentation
  seg_enabled_ = br.Bit();
  if (seg_enabled_) {
    seg_update_map_ = br.Bit();
    if (seg_update_map_) {
      for (auto& p : seg_tree_probs_) p = br.Bit() ? br.Bits(8) : 255;
      seg_temporal_ = br.Bit();
      if (seg_temporal_)
        for (auto& p : seg_pred_probs_) p = br.Bit() ? br.Bits(8) : 255;
    }
    if (br.Bit()) {
      Count(kSegmentDataUpdates);
      seg_abs_ = br.Bit();
      for (int i = 0; i < 8; ++i) {
        for (int j = 0; j < 4; ++j) {
          seg_feature_[i][j] = br.Bit();
          int v = 0;
          if (seg_feature_[i][j]) {
            v = br.Bits(kSegFeatureBits[j]);
            if (kSegFeatureSigned[j] && br.Bit()) v = -v;
          }
          seg_data_[i][j] = v;
        }
      }
    }
  }
  // Tiles
  const int sb64_cols = (((w + 7) >> 3) + 7) >> 3;
  int min_log2 = 0, max_log2 = 1;
  while ((64 << min_log2) < sb64_cols) ++min_log2;
  while ((sb64_cols >> max_log2) >= 4) ++max_log2;
  --max_log2;
  log2_tile_cols_ = min_log2;
  while (log2_tile_cols_ < max_log2 && br.Bit()) ++log2_tile_cols_;
  log2_tile_rows_ = br.Bit();
  if (log2_tile_rows_) log2_tile_rows_ += br.Bit();
  compressed_size_ = br.Bits(16);
  if (compressed_size_ == 0) throw Corrupt("empty compressed header");
  const size_t offset = br.Bytes();
  if (offset + compressed_size_ > size) throw Corrupt("compressed header past the frame");
  return offset;
}

// A forward update of a probability (the decoder's inverse of the encoder's remap).
int UpdateProb(BoolDecoder& bd, int p) {
  int d;
  if (!bd.Read(128)) {
    d = bd.Literal(4);
  } else if (!bd.Read(128)) {
    d = bd.Literal(4) + 16;
  } else if (!bd.Read(128)) {
    d = bd.Literal(5) + 32;
  } else {
    d = bd.Literal(7);
    if (d >= 65) d = (d << 1) - 65 + bd.Read(128);
    d += 64;
  }
  auto recenter = [](int v, int m) {
    if (v > 2 * m) return v;
    return (v & 1) ? m - ((v + 1) >> 1) : m + (v >> 1);
  };
  const int v = kInvMapTable[std::min(d, 254)];
  return p <= 128 ? 1 + recenter(v, p - 1) : 255 - recenter(v, 255 - p);
}

void DiffUpdate(BoolDecoder& bd, uint8_t* p) {
  if (bd.Read(252)) *p = static_cast<uint8_t>(UpdateProb(bd, *p));
}

void MvUpdate(BoolDecoder& bd, uint8_t* p) {
  if (bd.Read(252)) *p = static_cast<uint8_t>((bd.Literal(7) << 1) | 1);
}

void Decoder::ReadCompressedHeader(const uint8_t* data, size_t size) {
  BoolDecoder bd;
  bd.Init(data, size);
  ModeProbs& p = prob_.p;
  if (lossless_) {
    tx_mode_ = ONLY_4X4;
  } else {
    tx_mode_ = bd.Literal(2);
    if (tx_mode_ == ALLOW_32X32) tx_mode_ += bd.Read(128);
    if (tx_mode_ == TX_MODE_SELECT) {
      for (int i = 0; i < 2; ++i) DiffUpdate(bd, &p.tx8[i][0]);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) DiffUpdate(bd, &p.tx16[i][j]);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 3; ++j) DiffUpdate(bd, &p.tx32[i][j]);
    }
  }
  for (int t = 0; t <= kTxModeToBiggest[tx_mode_]; ++t) {
    if (!bd.Read(128)) continue;
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        for (int k = 0; k < 6; ++k)
          for (int l = 0; l < (k == 0 ? 3 : 6); ++l)
            for (int m = 0; m < 3; ++m) DiffUpdate(bd, &prob_.coef[t][i][j][k][l][m]);
  }
  for (int i = 0; i < 3; ++i) DiffUpdate(bd, &p.skip[i]);
  ref_mode_ = SINGLE_REFERENCE;
  if (!key_ && !intra_only_) {
    for (int i = 0; i < 7; ++i)
      for (int j = 0; j < 3; ++j) DiffUpdate(bd, &p.inter_mode[i][j]);
    if (interp_filter_ == SWITCHABLE)
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 2; ++j) DiffUpdate(bd, &p.interp[i][j]);
    for (int i = 0; i < 4; ++i) DiffUpdate(bd, &p.intra_inter[i]);
    const bool allow_comp = sign_bias_[LAST_FRAME] != sign_bias_[GOLDEN_FRAME] ||
                            sign_bias_[LAST_FRAME] != sign_bias_[ALTREF_FRAME];
    if (allow_comp) {
      ref_mode_ = bd.Read(128) ? (bd.Read(128) ? REFERENCE_MODE_SELECT : COMPOUND_REFERENCE) : SINGLE_REFERENCE;
      if (sign_bias_[LAST_FRAME] == sign_bias_[GOLDEN_FRAME]) {
        comp_fixed_ = ALTREF_FRAME;
        comp_var_[0] = LAST_FRAME;
        comp_var_[1] = GOLDEN_FRAME;
      } else if (sign_bias_[LAST_FRAME] == sign_bias_[ALTREF_FRAME]) {
        comp_fixed_ = GOLDEN_FRAME;
        comp_var_[0] = LAST_FRAME;
        comp_var_[1] = ALTREF_FRAME;
      } else {
        comp_fixed_ = LAST_FRAME;
        comp_var_[0] = GOLDEN_FRAME;
        comp_var_[1] = ALTREF_FRAME;
      }
    }
    if (ref_mode_ == REFERENCE_MODE_SELECT)
      for (int i = 0; i < 5; ++i) DiffUpdate(bd, &p.comp_inter[i]);
    if (ref_mode_ != COMPOUND_REFERENCE)
      for (int i = 0; i < 5; ++i) {
        DiffUpdate(bd, &p.single_ref[i][0]);
        DiffUpdate(bd, &p.single_ref[i][1]);
      }
    if (ref_mode_ != SINGLE_REFERENCE)
      for (int i = 0; i < 5; ++i) DiffUpdate(bd, &p.comp_ref[i]);
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 9; ++j) DiffUpdate(bd, &p.y_mode[i][j]);
    for (int i = 0; i < 16; ++i)
      for (int j = 0; j < 3; ++j) DiffUpdate(bd, &p.partition[i][j]);
    for (int j = 0; j < 3; ++j) MvUpdate(bd, &p.mv_joints[j]);
    for (int i = 0; i < 2; ++i) {
      MvComponentProbs& c = p.mv[i];
      MvUpdate(bd, &c.sign);
      for (auto& x : c.classes) MvUpdate(bd, &x);
      MvUpdate(bd, &c.class0);
      for (auto& x : c.bits) MvUpdate(bd, &x);
    }
    for (int i = 0; i < 2; ++i) {
      MvComponentProbs& c = p.mv[i];
      for (int j = 0; j < 2; ++j)
        for (int k = 0; k < 3; ++k) MvUpdate(bd, &c.class0_fp[j][k]);
      for (int k = 0; k < 3; ++k) MvUpdate(bd, &c.fp[k]);
    }
    if (allow_hp_) {
      for (int i = 0; i < 2; ++i) {
        MvUpdate(bd, &p.mv[i].class0_hp);
        MvUpdate(bd, &p.mv[i].hp);
      }
    }
  }
}

void Decoder::SetupSegmentsAndFilterLevels() {
  const int shift = lf_level_ >> 5;
  for (int i = 0; i < 8; ++i) {
    const bool seg = seg_enabled_;
    int q = base_q_;
    if (seg && seg_feature_[i][0]) q = seg_abs_ ? seg_data_[i][0] : base_q_ + seg_data_[i][0];
    q = std::clamp(q, 0, 255);
    dequant_[i][0][0] = kDcQLookup[std::clamp(q + dq_y_dc_, 0, 255)];
    dequant_[i][0][1] = kAcQLookup[q];
    dequant_[i][1][0] = kDcQLookup[std::clamp(q + dq_uv_dc_, 0, 255)];
    dequant_[i][1][1] = kAcQLookup[std::clamp(q + dq_uv_ac_, 0, 255)];
    int lvl = lf_level_;
    if (seg && seg_feature_[i][1]) lvl = std::clamp(seg_abs_ ? seg_data_[i][1] : lf_level_ + seg_data_[i][1], 0, 63);
    if (lf_delta_enabled_) {
      seg_levels_[i][0][0] = seg_levels_[i][0][1] =
          static_cast<uint8_t>(std::clamp(lvl + lf_ref_deltas_[0] * (1 << shift), 0, 63));
      for (int r = 1; r < 4; ++r)
        for (int m = 0; m < 2; ++m)
          seg_levels_[i][r][m] =
              static_cast<uint8_t>(std::clamp(lvl + (lf_ref_deltas_[r] + lf_mode_deltas_[m]) * (1 << shift), 0, 63));
    } else {
      std::memset(seg_levels_[i], lvl, sizeof(seg_levels_[i]));
    }
  }
  for (int l = 0; l < 64; ++l) {
    int limit = l;
    if (sharpness_ > 0) {
      limit >>= (sharpness_ + 3) >> 2;
      limit = std::min(limit, 9 - sharpness_);
    }
    limit = std::max(limit, 1);
    lim_[l] = static_cast<uint8_t>(limit);
    mblim_[l] = static_cast<uint8_t>(2 * (l + 2) + limit);
  }
}


// ---------------------------------------------------------------------------------------------
// Coefficient scans and their neighbours

struct Scan {
  const int16_t* scan;
  int16_t nb[1024][2];  // raster positions of the two coded neighbours of each scan position
};

const Scan* GetScan(int tx, int tx_type) {
  static Scan scans[4][3];  // [tx][default, col, row]
  static bool ready = false;
  if (!ready) {
    const int16_t* tables[4][3] = {{kDefaultScan4, kColScan4, kRowScan4},
                                   {kDefaultScan8, kColScan8, kRowScan8},
                                   {kDefaultScan16, kColScan16, kRowScan16},
                                   {kDefaultScan32, kDefaultScan32, kDefaultScan32}};
    for (int t = 0; t < 4; ++t) {
      const int l = 4 << t;
      for (int k = 0; k < 3; ++k) {
        Scan& s = scans[t][k];
        s.scan = tables[t][k];
        s.nb[0][0] = s.nb[0][1] = 0;
        for (int n = 1; n < l * l; ++n) {
          const int rc = s.scan[n], i = rc / l, j = rc % l;
          int a, b;
          if (i > 0 && j > 0) {
            if (k == 1 && t < 3) {
              a = b = (i - 1) * l + j;  // column scans: the neighbour above
            } else if (k == 2 && t < 3) {
              a = b = i * l + j - 1;  // row scans: the neighbour to the left
            } else {
              a = (i - 1) * l + j;
              b = i * l + j - 1;
            }
          } else if (i > 0) {
            a = b = (i - 1) * l + j;
          } else {
            a = b = i * l + j - 1;
          }
          s.nb[n][0] = static_cast<int16_t>(a);
          s.nb[n][1] = static_cast<int16_t>(b);
        }
      }
    }
    ready = true;
  }
  if (tx == TX_32X32 || tx_type == DCT_DCT || tx_type == ADST_ADST) return &scans[tx][0];
  return tx_type == ADST_DCT ? &scans[tx][2] : &scans[tx][1];
}

const uint8_t* Bands(int tx) {
  static uint8_t big[1024];
  static bool ready = false;
  if (!ready) {
    for (int i = 0; i < 1024; ++i) big[i] = i == 0 ? 0 : i < 3 ? 1 : i < 6 ? 2 : i < 10 ? 3 : i < 21 ? 4 : 5;
    ready = true;
  }
  return tx == TX_4X4 ? kBand4x4 : big;
}

// ---------------------------------------------------------------------------------------------
// Tiles, partitions, blocks

void Decoder::DecodeTiles(const uint8_t* data, size_t size) {
  const int tile_cols = 1 << log2_tile_cols_, tile_rows = 1 << log2_tile_rows_;
  above_partition_.assign(sb_cols_ * 8 + 8, 0);
  above_seg_pred_.assign(sb_cols_ * 8 + 8, 0);
  above_nnz_[0].assign(sb_cols_ * 16 + 16, 0);
  above_nnz_[1].assign(sb_cols_ * 8 + 8, 0);
  above_nnz_[2].assign(sb_cols_ * 8 + 8, 0);
  if (tile_cols > 1) Count(kTileColFrames);
  if (tile_rows > 1) Count(kTileRowFrames);
  auto offset = [](int idx, int mis, int log2) {
    const int sbs = (mis + 7) >> 3;
    return std::min(((idx * sbs) >> log2) << 3, mis);
  };
  const uint8_t* p = data;
  const uint8_t* end = data + size;
  TileState t;
  for (int tr = 0; tr < tile_rows; ++tr) {
    for (int tc = 0; tc < tile_cols; ++tc) {
      const bool last = tr == tile_rows - 1 && tc == tile_cols - 1;
      size_t tile_size;
      if (last) {
        tile_size = end - p;
      } else {
        if (end - p < 4) throw Corrupt("truncated tile size");
        tile_size = (static_cast<size_t>(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
        p += 4;
        if (tile_size > static_cast<size_t>(end - p)) throw Corrupt("tile past the frame");
      }
      if (tile_size == 0) throw Corrupt("empty tile");
      t.bd.Init(p, tile_size);
      p += tile_size;
      t.col_start = offset(tc, mi_cols_, log2_tile_cols_);
      tile_col_start_ = t.col_start;
      t.col_end = offset(tc + 1, mi_cols_, log2_tile_cols_);
      const int row_start = offset(tr, mi_rows_, log2_tile_rows_), row_end = offset(tr + 1, mi_rows_, log2_tile_rows_);
      for (int mi_row = row_start; mi_row < row_end; mi_row += 8) {
        std::memset(t.left_partition, 0, sizeof(t.left_partition));
        std::memset(t.left_nnz, 0, sizeof(t.left_nnz));
        std::memset(t.left_seg_pred, 0, sizeof(t.left_seg_pred));
        for (int mi_col = t.col_start; mi_col < t.col_end; mi_col += 8) DecodePartition(t, mi_row, mi_col, BLOCK_64X64);
      }
    }
  }
}

void Decoder::DecodePartition(TileState& t, int mi_row, int mi_col, int bsize) {
  if (mi_row >= mi_rows_ || mi_col >= mi_cols_) return;
  const int n8 = kMiWidth[bsize], hbs = n8 >> 1;
  const int bsl = bsize == BLOCK_8X8 ? 0 : bsize == BLOCK_16X16 ? 1 : bsize == BLOCK_32X32 ? 2 : 3;
  const int above = (above_partition_[mi_col] >> bsl) & 1, left = (t.left_partition[mi_row & 7] >> bsl) & 1;
  const int ctx = bsl * 4 + left * 2 + above;
  const uint8_t* probs = (key_ || intra_only_) ? kKfPartitionProbs + 3 * ctx : prob_.p.partition[ctx];
  const bool has_rows = (mi_row + hbs) < mi_rows_, has_cols = (mi_col + hbs) < mi_cols_;
  int p;
  if (hbs == 0 || (has_rows && has_cols)) {
    p = t.bd.Tree(kPartitionTree, probs);
  } else if (has_cols) {
    p = t.bd.Read(probs[1]) ? PARTITION_SPLIT : PARTITION_HORZ;
  } else if (has_rows) {
    p = t.bd.Read(probs[2]) ? PARTITION_SPLIT : PARTITION_VERT;
  } else {
    p = PARTITION_SPLIT;
  }
  ++counts_.partition[ctx][p];
  Count(static_cast<Stat>(kPartitionNone + p));
  const int subsize = kSubsize[p][bsize];
  if (hbs == 0) {
    DecodeBlock(t, mi_row, mi_col, subsize);
  } else {
    switch (p) {
      case PARTITION_NONE:
        DecodeBlock(t, mi_row, mi_col, subsize);
        break;
      case PARTITION_HORZ:
        DecodeBlock(t, mi_row, mi_col, subsize);
        if (has_rows) DecodeBlock(t, mi_row + hbs, mi_col, subsize);
        break;
      case PARTITION_VERT:
        DecodeBlock(t, mi_row, mi_col, subsize);
        if (has_cols) DecodeBlock(t, mi_row, mi_col + hbs, subsize);
        break;
      default:
        DecodePartition(t, mi_row, mi_col, subsize);
        DecodePartition(t, mi_row, mi_col + hbs, subsize);
        DecodePartition(t, mi_row + hbs, mi_col, subsize);
        DecodePartition(t, mi_row + hbs, mi_col + hbs, subsize);
    }
  }
  if (bsize == BLOCK_8X8 || p != PARTITION_SPLIT) {
    std::memset(&above_partition_[mi_col], kAbovePartitionCtx[subsize], n8);
    std::memset(&t.left_partition[mi_row & 7], kLeftPartitionCtx[subsize], n8);
  }
}

void Decoder::DecodeBlock(TileState& t, int mi_row, int mi_col, int bsize) {
  const int index = static_cast<int>(blocks_.size());
  blocks_.emplace_back();
  BlockInfo& b = blocks_.back();
  b.bsize = static_cast<uint8_t>(bsize);
  b.row = static_cast<uint16_t>(mi_row);
  b.col = static_cast<uint16_t>(mi_col);
  const int x_mis = std::min<int>(kMiWidth[bsize], mi_cols_ - mi_col);
  const int y_mis = std::min<int>(kMiHeight[bsize], mi_rows_ - mi_row);
  ReadModeInfo(t, b, mi_row, mi_col);
  if (bsize < BLOCK_8X8) Count(kSub8x8Blocks);
  Count(static_cast<Stat>(kTx4x4 + b.tx));
  if (!b.is_inter) {
    Count(kIntraBlocks);
    if (!key_ && !intra_only_) Count(kIntraInInterFrames);
    ReconstructIntra(t, b, mi_row, mi_col);
  } else {
    Count(static_cast<Stat>(kIntraBlocks + b.ref[0]));
    if (b.comp) Count(kCompoundBlocks);
    Count(static_cast<Stat>(kFilterRegular + b.filter));
    PredictInter(b, mi_row, mi_col);
    ReconstructInter(t, b, mi_row, mi_col);
  }
  if (b.skip) Count(kSkipBlocks);
  b.level = seg_levels_[b.seg_id][b.is_inter ? b.ref[0] : 0][b.is_inter && b.mode != ZEROMV];
  for (int y = 0; y < y_mis; ++y) {
    for (int x = 0; x < x_mis; ++x) {
      const size_t o = static_cast<size_t>(mi_row + y) * mi_cols_ + mi_col + x;
      grid_[o] = index;
      MvRef& m = cur_->mvs[o];
      if (!b.is_inter) {
        m.ref[0] = m.ref[1] = -1;
      } else {
        m.ref[0] = b.ref[0];
        m.ref[1] = b.comp ? b.ref[1] : -1;
        m.mv[0] = b.mv[3][0];
        m.mv[1] = b.comp ? b.mv[3][1] : Mv();
      }
    }
  }
}

// ---------------------------------------------------------------------------------------------
// Mode info

int Decoder::ReadSegmentId(TileState& t, BlockInfo& b, int mi_row, int mi_col) {
  if (!seg_enabled_) return 0;
  const int bw = kMiWidth[b.bsize], bh = kMiHeight[b.bsize];
  const int x_mis = std::min(bw, mi_cols_ - mi_col), y_mis = std::min(bh, mi_rows_ - mi_row);
  int seg;
  if (key_ || intra_only_) {
    seg = seg_update_map_ ? t.bd.Tree(kSegmentTree, seg_tree_probs_) : 0;
  } else {
    const int ctx = above_seg_pred_[mi_col] + t.left_seg_pred[mi_row & 7];
    if (!seg_update_map_ || (seg_temporal_ && t.bd.Read(seg_pred_probs_[ctx]))) {
      seg = 0;
      if (!error_res_ && segmap_ref_) {
        seg = 8;
        for (int y = 0; y < y_mis; ++y)
          for (int x = 0; x < x_mis; ++x)
            seg = std::min<int>(seg, segmap_ref_->segmap[static_cast<size_t>(mi_row + y) * mi_cols_ + mi_col + x]);
      }
      std::memset(&above_seg_pred_[mi_col], 1, bw);
      std::memset(&t.left_seg_pred[mi_row & 7], 1, bh);
    } else {
      seg = t.bd.Tree(kSegmentTree, seg_tree_probs_);
      std::memset(&above_seg_pred_[mi_col], 0, bw);
      std::memset(&t.left_seg_pred[mi_row & 7], 0, bh);
    }
  }
  if (seg_update_map_ || key_ || intra_only_) {
    for (int y = 0; y < y_mis; ++y)
      for (int x = 0; x < x_mis; ++x)
        cur_->segmap[static_cast<size_t>(mi_row + y) * mi_cols_ + mi_col + x] = static_cast<uint8_t>(seg);
  }
  return seg;
}

void Decoder::ReadModeInfo(TileState& t, BlockInfo& b, int mi_row, int mi_col) {
  SR_VP9_STAGE(kStageModes);
  const BlockInfo* above = mi_row > 0 ? &blocks_[grid_[static_cast<size_t>(mi_row - 1) * mi_cols_ + mi_col]] : nullptr;
  const BlockInfo* left =
      mi_col > t.col_start ? &blocks_[grid_[static_cast<size_t>(mi_row) * mi_cols_ + mi_col - 1]] : nullptr;
  b.seg_id = static_cast<uint8_t>(ReadSegmentId(t, b, mi_row, mi_col));
  if (seg_enabled_ && seg_feature_[b.seg_id][3]) {
    b.skip = 1;
  } else {
    const int ctx = (above ? above->skip : 0) + (left ? left->skip : 0);
    b.skip = static_cast<uint8_t>(t.bd.Read(prob_.p.skip[ctx]));
    ++counts_.skip[ctx][b.skip];
  }
  const bool intra_frame = key_ || intra_only_;
  if (intra_frame) {
    b.is_inter = 0;
  } else if (seg_enabled_ && seg_feature_[b.seg_id][2]) {
    b.is_inter = seg_data_[b.seg_id][2] != INTRA_FRAME;
  } else {
    const int ctx = above && left ? ((!above->is_inter && !left->is_inter) ? 3 : (!above->is_inter || !left->is_inter))
                    : (above || left) ? 2 * !(above ? above : left)->is_inter
                                      : 0;
    b.is_inter = static_cast<uint8_t>(t.bd.Read(prob_.p.intra_inter[ctx]));
    ++counts_.intra_inter[ctx][b.is_inter];
  }
  const int max_tx = kMaxTx[b.bsize];
  if (tx_mode_ == TX_MODE_SELECT && b.bsize >= BLOCK_8X8 && (!b.skip || !b.is_inter)) {
    int actx = (above && !above->skip) ? above->tx : max_tx;
    int lctx = (left && !left->skip) ? left->tx : max_tx;
    if (!left) lctx = actx;
    if (!above) actx = lctx;
    const int ctx = (actx + lctx) > max_tx;
    int tx;
    if (max_tx == TX_8X8) {
      tx = t.bd.Read(prob_.p.tx8[ctx][0]);
      ++counts_.tx8[ctx][tx];
    } else if (max_tx == TX_16X16) {
      tx = t.bd.Read(prob_.p.tx16[ctx][0]);
      if (tx) tx += t.bd.Read(prob_.p.tx16[ctx][1]);
      ++counts_.tx16[ctx][tx];
    } else {
      tx = t.bd.Read(prob_.p.tx32[ctx][0]);
      if (tx) {
        tx += t.bd.Read(prob_.p.tx32[ctx][1]);
        if (tx == 2) tx += t.bd.Read(prob_.p.tx32[ctx][2]);
      }
      ++counts_.tx32[ctx][tx];
    }
    b.tx = static_cast<uint8_t>(tx);
  } else {
    b.tx = static_cast<uint8_t>(std::min<int>(max_tx, kTxModeToBiggest[tx_mode_]));
  }
  if (intra_frame) {
    ReadIntraFrameModes(t, b, above, left);
  } else if (b.is_inter) {
    ReadInterFrameModes(t, b, mi_row, mi_col, above, left);
  } else {
    // Intra blocks of inter frames: the frame's adaptive probabilities by block size.
    auto read_y = [&](int group) {
      const int m = t.bd.Tree(kIntraModeTree, prob_.p.y_mode[group]);
      ++counts_.y_mode[group][m];
      Count(static_cast<Stat>(kDcPred + m));
      return m;
    };
    if (b.bsize == BLOCK_4X4) {
      for (int i = 0; i < 4; ++i) b.sub_modes[i] = static_cast<uint8_t>(read_y(0));
    } else if (b.bsize == BLOCK_4X8) {
      b.sub_modes[0] = b.sub_modes[2] = static_cast<uint8_t>(read_y(0));
      b.sub_modes[1] = b.sub_modes[3] = static_cast<uint8_t>(read_y(0));
    } else if (b.bsize == BLOCK_8X4) {
      b.sub_modes[0] = b.sub_modes[1] = static_cast<uint8_t>(read_y(0));
      b.sub_modes[2] = b.sub_modes[3] = static_cast<uint8_t>(read_y(0));
    } else {
      b.sub_modes[0] = b.sub_modes[1] = b.sub_modes[2] = b.sub_modes[3] =
          static_cast<uint8_t>(read_y(kSizeGroup[b.bsize]));
    }
    b.mode = b.sub_modes[3];
    b.uv_mode = static_cast<uint8_t>(t.bd.Tree(kIntraModeTree, prob_.p.uv_mode[b.mode]));
    ++counts_.uv_mode[b.mode][b.uv_mode];
    b.ref[0] = INTRA_FRAME;
    b.ref[1] = -1;
  }
}

void Decoder::ReadIntraFrameModes(TileState& t, BlockInfo& b, const BlockInfo* above, const BlockInfo* left) {
  auto above_mode = [&](int i) -> int {
    if (i >= 2) return b.sub_modes[i - 2];
    if (!above || above->is_inter) return DC_PRED;
    return above->sub_modes[i + 2];
  };
  auto left_mode = [&](int i) -> int {
    if (i & 1) return b.sub_modes[i - 1];
    if (!left || left->is_inter) return DC_PRED;
    return left->sub_modes[i + 1];
  };
  auto read = [&](int i) {
    const int m = t.bd.Tree(kIntraModeTree, kKfYModeProbs + (above_mode(i) * 10 + left_mode(i)) * 9);
    Count(static_cast<Stat>(kDcPred + m));
    return static_cast<uint8_t>(m);
  };
  if (b.bsize == BLOCK_4X4) {
    for (int i = 0; i < 4; ++i) b.sub_modes[i] = read(i);
  } else if (b.bsize == BLOCK_4X8) {
    b.sub_modes[0] = b.sub_modes[2] = read(0);
    b.sub_modes[1] = b.sub_modes[3] = read(1);
  } else if (b.bsize == BLOCK_8X4) {
    b.sub_modes[0] = b.sub_modes[1] = read(0);
    b.sub_modes[2] = b.sub_modes[3] = read(2);
  } else {
    b.sub_modes[0] = b.sub_modes[1] = b.sub_modes[2] = b.sub_modes[3] = read(0);
  }
  b.mode = b.sub_modes[3];
  b.uv_mode = static_cast<uint8_t>(t.bd.Tree(kIntraModeTree, kKfUvModeProbs + b.mode * 9));
  b.ref[0] = INTRA_FRAME;
  b.ref[1] = -1;
}

void Decoder::ReadRefFrames(TileState& t, BlockInfo& b, const BlockInfo* above, const BlockInfo* left) {
  if (seg_enabled_ && seg_feature_[b.seg_id][2]) {
    b.ref[0] = static_cast<int8_t>(seg_data_[b.seg_id][2]);
    b.ref[1] = -1;
    b.comp = 0;
    return;
  }
  const bool has_a = above != nullptr, has_l = left != nullptr;
  auto inter = [](const BlockInfo* m) { return m->is_inter != 0; };
  auto second = [](const BlockInfo* m) { return m->is_inter && m->comp; };
  int comp = 0;
  if (ref_mode_ == REFERENCE_MODE_SELECT) {
    int ctx;
    if (has_a && has_l) {
      if (!second(above) && !second(left))
        ctx = (above->ref[0] == comp_fixed_) ^ (left->ref[0] == comp_fixed_);
      else if (!second(above))
        ctx = 2 + (above->ref[0] == comp_fixed_ || !inter(above));
      else if (!second(left))
        ctx = 2 + (left->ref[0] == comp_fixed_ || !inter(left));
      else
        ctx = 4;
    } else if (has_a || has_l) {
      const BlockInfo* e = has_a ? above : left;
      ctx = !second(e) ? e->ref[0] == comp_fixed_ : 3;
    } else {
      ctx = 1;
    }
    comp = t.bd.Read(prob_.p.comp_inter[ctx]);
    ++counts_.comp_inter[ctx][comp];
  } else {
    comp = ref_mode_ == COMPOUND_REFERENCE;
  }
  b.comp = static_cast<uint8_t>(comp);
  if (comp) {
    const int fix_idx = sign_bias_[comp_fixed_], var_idx = !fix_idx;
    int ctx;
    if (has_a && has_l) {
      const bool ai = !inter(above), li = !inter(left);
      if (ai && li) {
        ctx = 2;
      } else if (ai || li) {
        const BlockInfo* e = ai ? left : above;
        ctx = !second(e) ? 1 + 2 * (e->ref[0] != comp_var_[1]) : 1 + 2 * (e->ref[var_idx] != comp_var_[1]);
      } else {
        const bool l_sg = !second(left), a_sg = !second(above);
        const int vrfa = a_sg ? above->ref[0] : above->ref[var_idx];
        const int vrfl = l_sg ? left->ref[0] : left->ref[var_idx];
        if (vrfa == vrfl && comp_var_[1] == vrfa) {
          ctx = 0;
        } else if (l_sg && a_sg) {
          if ((vrfa == comp_fixed_ && vrfl == comp_var_[0]) || (vrfl == comp_fixed_ && vrfa == comp_var_[0]))
            ctx = 4;
          else if (vrfa == vrfl)
            ctx = 3;
          else
            ctx = 1;
        } else if (l_sg || a_sg) {
          const int vrfc = l_sg ? vrfa : vrfl, rfs = a_sg ? vrfa : vrfl;
          if (vrfc == comp_var_[1] && rfs != comp_var_[1])
            ctx = 1;
          else if (rfs == comp_var_[1] && vrfc != comp_var_[1])
            ctx = 2;
          else
            ctx = 4;
        } else if (vrfa == vrfl) {
          ctx = 4;
        } else {
          ctx = 2;
        }
      }
    } else if (has_a || has_l) {
      const BlockInfo* e = has_a ? above : left;
      if (!inter(e))
        ctx = 2;
      else if (second(e))
        ctx = 4 * (e->ref[var_idx] != comp_var_[1]);
      else
        ctx = 3 * (e->ref[0] != comp_var_[1]);
    } else {
      ctx = 2;
    }
    const int bit = t.bd.Read(prob_.p.comp_ref[ctx]);
    ++counts_.comp_ref[ctx][bit];
    b.ref[fix_idx] = static_cast<int8_t>(comp_fixed_);
    b.ref[var_idx] = static_cast<int8_t>(comp_var_[bit]);
    return;
  }
  // Single reference: LAST, or GOLDEN / ALTREF.
  int ctx0;
  if (has_a && has_l) {
    const bool ai = !inter(above), li = !inter(left);
    if (ai && li) {
      ctx0 = 2;
    } else if (ai || li) {
      const BlockInfo* e = ai ? left : above;
      ctx0 = !second(e) ? 4 * (e->ref[0] == LAST_FRAME) : 1 + (e->ref[0] == LAST_FRAME || e->ref[1] == LAST_FRAME);
    } else {
      const bool as = second(above), ls = second(left);
      const int a0 = above->ref[0], a1 = above->ref[1], l0 = left->ref[0], l1 = left->ref[1];
      if (as && ls) {
        ctx0 = 1 + (a0 == LAST_FRAME || a1 == LAST_FRAME || l0 == LAST_FRAME || l1 == LAST_FRAME);
      } else if (as || ls) {
        const int rfs = !as ? a0 : l0, crf1 = as ? a0 : l0, crf2 = as ? a1 : l1;
        ctx0 = rfs == LAST_FRAME ? 3 + (crf1 == LAST_FRAME || crf2 == LAST_FRAME)
                                 : (crf1 == LAST_FRAME || crf2 == LAST_FRAME);
      } else {
        ctx0 = 2 * (a0 == LAST_FRAME) + 2 * (l0 == LAST_FRAME);
      }
    }
  } else if (has_a || has_l) {
    const BlockInfo* e = has_a ? above : left;
    if (!inter(e))
      ctx0 = 2;
    else if (!second(e))
      ctx0 = 4 * (e->ref[0] == LAST_FRAME);
    else
      ctx0 = 1 + (e->ref[0] == LAST_FRAME || e->ref[1] == LAST_FRAME);
  } else {
    ctx0 = 2;
  }
  const int bit0 = t.bd.Read(prob_.p.single_ref[ctx0][0]);
  ++counts_.single_ref[ctx0][0][bit0];
  b.ref[1] = -1;
  if (!bit0) {
    b.ref[0] = LAST_FRAME;
    return;
  }
  int ctx1;
  if (has_a && has_l) {
    const bool ai = !inter(above), li = !inter(left);
    if (ai && li) {
      ctx1 = 2;
    } else if (ai || li) {
      const BlockInfo* e = ai ? left : above;
      if (!second(e))
        ctx1 = e->ref[0] == LAST_FRAME ? 3 : 4 * (e->ref[0] == GOLDEN_FRAME);
      else
        ctx1 = 1 + 2 * (e->ref[0] == GOLDEN_FRAME || e->ref[1] == GOLDEN_FRAME);
    } else {
      const bool as = second(above), ls = second(left);
      const int a0 = above->ref[0], a1 = above->ref[1], l0 = left->ref[0], l1 = left->ref[1];
      if (as && ls) {
        if (a0 == l0 && a1 == l1)
          ctx1 = 3 * (a0 == GOLDEN_FRAME || a1 == GOLDEN_FRAME || l0 == GOLDEN_FRAME || l1 == GOLDEN_FRAME);
        else
          ctx1 = 2;
      } else if (as || ls) {
        const int rfs = !as ? a0 : l0, crf1 = as ? a0 : l0, crf2 = as ? a1 : l1;
        if (rfs == GOLDEN_FRAME)
          ctx1 = 3 + (crf1 == GOLDEN_FRAME || crf2 == GOLDEN_FRAME);
        else if (rfs == ALTREF_FRAME)
          ctx1 = crf1 == GOLDEN_FRAME || crf2 == GOLDEN_FRAME;
        else
          ctx1 = 1 + 2 * (crf1 == GOLDEN_FRAME || crf2 == GOLDEN_FRAME);
      } else {
        if (a0 == LAST_FRAME && l0 == LAST_FRAME) {
          ctx1 = 3;
        } else if (a0 == LAST_FRAME || l0 == LAST_FRAME) {
          const int edge0 = a0 == LAST_FRAME ? l0 : a0;
          ctx1 = 4 * (edge0 == GOLDEN_FRAME);
        } else {
          ctx1 = 2 * (a0 == GOLDEN_FRAME) + 2 * (l0 == GOLDEN_FRAME);
        }
      }
    }
  } else if (has_a || has_l) {
    const BlockInfo* e = has_a ? above : left;
    if (!inter(e) || (e->ref[0] == LAST_FRAME && !second(e)))
      ctx1 = 2;
    else if (!second(e))
      ctx1 = 4 * (e->ref[0] == GOLDEN_FRAME);
    else
      ctx1 = 3 * (e->ref[0] == GOLDEN_FRAME || e->ref[1] == GOLDEN_FRAME);
  } else {
    ctx1 = 2;
  }
  const int bit1 = t.bd.Read(prob_.p.single_ref[ctx1][1]);
  ++counts_.single_ref[ctx1][1][bit1];
  b.ref[0] = bit1 ? ALTREF_FRAME : GOLDEN_FRAME;
}

int Decoder::ReadMvComponent(TileState& t, int idx, bool hp) {
  const MvComponentProbs& p = prob_.p.mv[idx];
  MvComponentCounts& c = counts_.mv[idx];
  const int sign = t.bd.Read(p.sign);
  const int cls = t.bd.Tree(kMvClassTree, p.classes);
  ++c.sign[sign];
  ++c.classes[cls];
  int n;
  if (cls) {
    n = 0;
    for (int m = 0; m < cls; ++m) {
      const int bit = t.bd.Read(p.bits[m]);
      n |= bit << m;
      ++c.bits[m][bit];
    }
    n <<= 3;
    const int fp = t.bd.Tree(kMvFpTree, p.fp);
    n |= fp << 1;
    ++c.fp[fp];
    if (hp) {
      const int bit = t.bd.Read(p.hp);
      ++c.hp[bit];
      n |= bit;
    } else {
      n |= 1;
      ++c.hp[1];  // counted though not coded, as libvpx does
    }
    n += 8 << cls;
  } else {
    n = t.bd.Read(p.class0);
    ++c.class0[n];
    const int fp = t.bd.Tree(kMvFpTree, p.class0_fp[n]);
    ++c.class0_fp[n][fp];
    n = (n << 3) | (fp << 1);
    if (hp) {
      const int bit = t.bd.Read(p.class0_hp);
      ++c.class0_hp[bit];
      n |= bit;
    } else {
      n |= 1;
      ++c.class0_hp[1];
    }
  }
  return sign ? -(n + 1) : (n + 1);
}

// FFmpeg's find_ref_mvs: the nearest (idx 0) or near (idx 1) candidate vector for reference `ref`;
// sb >= 0 for a sub-8x8 block's sub-block, -1 for the whole block.
void Decoder::FindRefMv(Mv* pmv, const BlockInfo& b, int row, int col, int ref, int z, int idx, int sb) {
  const int8_t(*p)[2] = kMvRefBlocks[b.bsize];
  const int min_x = -(128 + col * 64), min_y = -(128 + row * 64);
  const int max_x = 128 + (mi_cols_ - col - kMiWidth[b.bsize]) * 64;
  const int max_y = 128 + (mi_rows_ - row - kMiHeight[b.bsize]) * 64;
  auto clamp = [&](Mv m) {
    m.col = static_cast<int16_t>(std::clamp<int>(m.col, min_x, max_x));
    m.row = static_cast<int16_t>(std::clamp<int>(m.row, min_y, max_y));
    return m;
  };
  bool have_mem = false, have_mem_sub = false;
  Mv mem, mem_sub;
  auto direct = [&](Mv m) {
    if (!idx) {
      *pmv = m;
      return true;
    }
    if (!have_mem) {
      mem = m;
      have_mem = true;
      return false;
    }
    if (m != mem) {
      *pmv = m;
      return true;
    }
    return false;
  };
  auto ret = [&](Mv m) {
    if (sb > 0) {
      if (!have_mem_sub) {
        const Mv tmp = clamp(m);
        if (tmp != mem) {
          *pmv = tmp;
          return true;
        }
        mem_sub = m;
        have_mem_sub = true;
      } else if (mem_sub != m) {
        const Mv tmp = clamp(m);
        *pmv = tmp != mem ? tmp : Mv();  // FFmpeg keeps libvpx's zero here
        return true;
      }
      return false;
    }
    if (!idx) {
      *pmv = clamp(m);
      return true;
    }
    if (!have_mem) {
      mem = m;
      have_mem = true;
      return false;
    }
    if (m != mem) {
      *pmv = clamp(m);
      return true;
    }
    return false;
  };
  const int tile_start = tile_col_start_;
  int i = 0;
  if (sb >= 0) {
    if (sb == 1 || sb == 2) {
      if (direct(b.mv[0][z])) return;
    } else if (sb == 3) {
      if (direct(b.mv[2][z]) || direct(b.mv[1][z]) || direct(b.mv[0][z])) return;
    }
    if (row > 0) {
      const MvRef& m = cur_->mvs[static_cast<size_t>(row - 1) * mi_cols_ + col];
      const BlockInfo& a = blocks_[grid_[static_cast<size_t>(row - 1) * mi_cols_ + col]];
      if (m.ref[0] == ref) {
        if (ret(a.mv[2 + (sb & 1)][0])) return;
      } else if (m.ref[1] == ref) {
        if (ret(a.mv[2 + (sb & 1)][1])) return;
      }
    }
    if (col > tile_start) {
      const MvRef& m = cur_->mvs[static_cast<size_t>(row) * mi_cols_ + col - 1];
      const BlockInfo& l = blocks_[grid_[static_cast<size_t>(row) * mi_cols_ + col - 1]];
      if (m.ref[0] == ref) {
        if (ret(l.mv[1 + 2 * (sb >> 1)][0])) return;
      } else if (m.ref[1] == ref) {
        if (ret(l.mv[1 + 2 * (sb >> 1)][1])) return;
      }
    }
    i = 2;
  }
  auto inside = [&](int c, int r) { return c >= tile_start && c < mi_cols_ && r >= 0 && r < mi_rows_; };
  for (; i < 8; ++i) {
    const int c = p[i][0] + col, r = p[i][1] + row;
    if (!inside(c, r)) continue;
    const MvRef& m = cur_->mvs[static_cast<size_t>(r) * mi_cols_ + c];
    if (m.ref[0] == ref) {
      if (ret(m.mv[0])) return;
    } else if (m.ref[1] == ref) {
      if (ret(m.mv[1])) return;
    }
  }
  const MvRef* prev = (use_last_mvs_ && mvpair_ref_) ? &mvpair_ref_->mvs[static_cast<size_t>(row) * mi_cols_ + col]
                                                      : nullptr;
  if (prev) {
    if (prev->ref[0] == ref) {
      if (ret(prev->mv[0])) return;
    } else if (prev->ref[1] == ref) {
      if (ret(prev->mv[1])) return;
    }
  }
  auto scaled = [&](Mv m, int other) {
    if (sign_bias_[other] != sign_bias_[ref]) {
      m.row = static_cast<int16_t>(-m.row);
      m.col = static_cast<int16_t>(-m.col);
    }
    return m;
  };
  auto other_refs = [&](const MvRef& m) {
    if (m.ref[0] != ref && m.ref[0] > 0) {
      if (ret(scaled(m.mv[0], m.ref[0]))) return true;
    }
    if (m.ref[1] != ref && m.ref[1] > 0 && m.mv[0] != m.mv[1]) {
      if (ret(scaled(m.mv[1], m.ref[1]))) return true;
    }
    return false;
  };
  for (i = 0; i < 8; ++i) {
    const int c = p[i][0] + col, r = p[i][1] + row;
    if (!inside(c, r)) continue;
    if (other_refs(cur_->mvs[static_cast<size_t>(r) * mi_cols_ + c])) return;
  }
  if (prev && other_refs(*prev)) return;
  *pmv = clamp(Mv());
}

void Decoder::FillMv(TileState& t, BlockInfo& b, int mi_row, int mi_col, int mode, int sb, Mv out[2]) {
  if (mode == ZEROMV) {
    out[0] = out[1] = Mv();
    return;
  }
  for (int r = 0; r <= b.comp; ++r) {
    FindRefMv(&out[r], b, mi_row, mi_col, b.ref[r], r, mode == NEARMV, mode == NEWMV ? -1 : sb);
    bool hp = true;
    if (mode == NEWMV || sb == -1) {
      hp = allow_hp_ && std::abs(out[r].col) < 64 && std::abs(out[r].row) < 64;
      if (!hp) {
        if (out[r].row & 1) out[r].row = static_cast<int16_t>(out[r].row + (out[r].row < 0 ? 1 : -1));
        if (out[r].col & 1) out[r].col = static_cast<int16_t>(out[r].col + (out[r].col < 0 ? 1 : -1));
      }
    }
    if (mode == NEWMV) {
      const int j = t.bd.Tree(kMvJointTree, prob_.p.mv_joints);
      ++counts_.mv_joints[j];
      if (j >= 2) out[r].row = static_cast<int16_t>(out[r].row + ReadMvComponent(t, 0, hp));
      if (j & 1) out[r].col = static_cast<int16_t>(out[r].col + ReadMvComponent(t, 1, hp));
    }
  }
}

void Decoder::ReadInterFrameModes(TileState& t, BlockInfo& b, int mi_row, int mi_col, const BlockInfo* above,
                                  const BlockInfo* left) {
  ReadRefFrames(t, b, above, left);
  // The inter-mode context: the modes of the two nearest candidates.
  int counter = 0;
  for (int i = 0; i < 2; ++i) {
    const int c = kMvRefBlocks[b.bsize][i][0] + mi_col, r = kMvRefBlocks[b.bsize][i][1] + mi_row;
    if (c >= tile_col_start_ && c < mi_cols_ && r >= 0 && r < mi_rows_) {
      const BlockInfo& n = blocks_[grid_[static_cast<size_t>(r) * mi_cols_ + c]];
      counter += !n.is_inter ? 9 : n.mode == ZEROMV ? 3 : n.mode == NEWMV ? 1 : 0;
    }
  }
  const int ctx = kCounterToContext[counter];
  auto read_mode = [&]() {
    const int m = NEARESTMV + t.bd.Tree(kInterModeTree, prob_.p.inter_mode[ctx]);
    ++counts_.inter_mode[ctx][m - NEARESTMV];
    Count(static_cast<Stat>(kNearestMv + m - NEARESTMV));
    return m;
  };
  if (b.bsize >= BLOCK_8X8) {
    if (seg_enabled_ && seg_feature_[b.seg_id][3]) {
      b.mode = ZEROMV;
      Count(kZeroMv);
    } else {
      b.mode = static_cast<uint8_t>(read_mode());
    }
  }
  if (interp_filter_ == SWITCHABLE) {
    const int lt = left && left->is_inter ? left->filter : 3, at = above && above->is_inter ? above->filter : 3;
    const int fctx = lt == at ? lt : lt == 3 ? at : at == 3 ? lt : 3;
    b.filter = static_cast<uint8_t>(t.bd.Tree(kInterpTree, prob_.p.interp[fctx]));
    ++counts_.interp[fctx][b.filter];
  } else {
    b.filter = static_cast<uint8_t>(interp_filter_);
  }
  if (b.bsize < BLOCK_8X8) {
    int m = read_mode();
    b.sub_modes[0] = static_cast<uint8_t>(m);
    FillMv(t, b, mi_row, mi_col, m, 0, b.mv[0]);
    if (b.bsize != BLOCK_8X4) {
      m = read_mode();
      b.sub_modes[1] = static_cast<uint8_t>(m);
      FillMv(t, b, mi_row, mi_col, m, 1, b.mv[1]);
    } else {
      b.sub_modes[1] = b.sub_modes[0];
      b.mv[1][0] = b.mv[0][0];
      b.mv[1][1] = b.mv[0][1];
    }
    if (b.bsize != BLOCK_4X8) {
      m = read_mode();
      b.sub_modes[2] = static_cast<uint8_t>(m);
      FillMv(t, b, mi_row, mi_col, m, 2, b.mv[2]);
      if (b.bsize != BLOCK_8X4) {
        m = read_mode();
        b.sub_modes[3] = static_cast<uint8_t>(m);
        FillMv(t, b, mi_row, mi_col, m, 3, b.mv[3]);
      } else {
        b.sub_modes[3] = b.sub_modes[2];
        b.mv[3][0] = b.mv[2][0];
        b.mv[3][1] = b.mv[2][1];
      }
    } else {
      b.sub_modes[2] = b.sub_modes[0];
      b.mv[2][0] = b.mv[0][0];
      b.mv[2][1] = b.mv[0][1];
      b.sub_modes[3] = b.sub_modes[1];
      b.mv[3][0] = b.mv[1][0];
      b.mv[3][1] = b.mv[1][1];
    }
    b.mode = b.sub_modes[3];
  } else {
    FillMv(t, b, mi_row, mi_col, b.mode, -1, b.mv[0]);
    for (int i = 1; i < 4; ++i) {
      b.mv[i][0] = b.mv[0][0];
      b.mv[i][1] = b.mv[0][1];
    }
    b.sub_modes[0] = b.sub_modes[1] = b.sub_modes[2] = b.sub_modes[3] = b.mode;
  }
  for (int r = 0; r <= b.comp; ++r) {
    const int px = mi_col * 64 + b.mv[3][r].col, py = mi_row * 64 + b.mv[3][r].row;
    if (px < -64 * 8 || py < -64 * 8 || px > (mi_cols_ * 8 + 64) * 8 || py > (mi_rows_ * 8 + 64) * 8) {
      Count(kFarMvBlocks);
      break;
    }
  }
}


// ---------------------------------------------------------------------------------------------
// Coefficients

int Decoder::ReadTokens(BoolDecoder& bd, int16_t* coef, int tx, int tx_type, int plane, bool is_inter, int ctx,
                        const int16_t* dq) {
  SR_VP9_STAGE(kStageTokens);
  const Scan* sc = GetScan(tx, tx_type);
  const int16_t* scan = sc->scan;
  const uint8_t* band = Bands(tx);
  uint8_t(*probs)[6][3] = prob_.coef[tx][plane > 0][is_inter];
  uint32_t(*cnt)[6][3] = counts_.coef[tx][plane > 0][is_inter];
  uint32_t(*eobc)[6][2] = counts_.eob[tx][plane > 0][is_inter];
  const int n = 16 << (2 * tx);
  uint8_t cache[1024];
  int c = 0, dqv = dq[0];
  while (c < n) {
    int b = band[c];
    const uint8_t* p = probs[b][ctx];
    const int more = bd.Read(p[0]);
    ++eobc[b][ctx][more];
    if (!more) break;
    while (!bd.Read(p[1])) {
      ++cnt[b][ctx][0];
      dqv = dq[1];
      cache[scan[c]] = 0;
      if (++c >= n) return c;
      ctx = (1 + cache[sc->nb[c][0]] + cache[sc->nb[c][1]]) >> 1;
      b = band[c];
      p = probs[b][ctx];
    }
    int val, energy;
    if (!bd.Read(p[2])) {
      ++cnt[b][ctx][1];
      val = 1;
      energy = 1;
    } else {
      ++cnt[b][ctx][2];
      const uint8_t* pp = kPareto8 + (p[2] - 1) * 8;
      if (!bd.Read(pp[0])) {
        if (!bd.Read(pp[1])) {
          val = 2;
          energy = 2;
        } else {
          val = 3 + bd.Read(pp[2]);
          energy = 3;
        }
      } else if (!bd.Read(pp[3])) {
        energy = 4;
        if (!bd.Read(pp[4])) {
          val = 5 + bd.Read(159);
        } else {
          val = 7 + (bd.Read(165) << 1);
          val += bd.Read(145);
        }
      } else {
        energy = 5;
        if (!bd.Read(pp[5])) {
          if (!bd.Read(pp[6])) {
            val = 11 + (bd.Read(173) << 2);
            val += bd.Read(148) << 1;
            val += bd.Read(140);
          } else {
            val = 19 + (bd.Read(176) << 3);
            val += bd.Read(155) << 2;
            val += bd.Read(140) << 1;
            val += bd.Read(135);
          }
        } else if (!bd.Read(pp[7])) {
          val = 35 + (bd.Read(180) << 4);
          val += bd.Read(157) << 3;
          val += bd.Read(141) << 2;
          val += bd.Read(134) << 1;
          val += bd.Read(130);
        } else {
          val = 67;
          for (int i = 0; i < 14; ++i) val += bd.Read(kCat6Probs[i]) << (13 - i);
        }
      }
    }
    const int rc = scan[c];
    const int signed_val = bd.Read(128) ? -val : val;
    const int v = tx == TX_32X32 ? static_cast<int>(static_cast<int64_t>(signed_val) * dqv / 2) : signed_val * dqv;
    coef[rc] = static_cast<int16_t>(v);
    cache[rc] = static_cast<uint8_t>(energy);
    if (++c >= n) break;
    ctx = (1 + cache[sc->nb[c][0]] + cache[sc->nb[c][1]]) >> 1;
    dqv = dq[1];
  }
  return c;
}

// Reads one transform block's coefficients into coef (zeroed beforehand), keeping the nonzero contexts;
// returns the end of block (0: no coefficient).
int Decoder::DecodeCoefficients(TileState& t, const BlockInfo& b, int plane, int x4, int y4, int tx, int tx_type,
                                int16_t* coef) {
  const int n4 = 1 << tx;
  const int edge_x = plane ? mi_cols_ : mi_cols_ * 2, edge_y = plane ? mi_rows_ : mi_rows_ * 2;
  uint8_t* a = &above_nnz_[plane][x4];
  uint8_t* l = &t.left_nnz[plane][y4 & (plane ? 7 : 15)];
  int actx = 0, lctx = 0;
  for (int i = 0; i < n4; ++i) {
    actx |= a[i];
    lctx |= l[i];
  }
  const int eob = ReadTokens(t.bd, coef, tx, tx_type, plane, b.is_inter, actx + lctx,
                             dequant_[b.seg_id][plane > 0]);
  const uint8_t nz = eob > 0;
  for (int i = 0; i < n4; ++i) {
    a[i] = (x4 + i < edge_x) ? nz : 0;
    l[i] = (y4 + i < edge_y) ? nz : 0;
  }
  return eob;
}

inline int UvTx(const BlockInfo& b) {
  const int min_dim = std::min(kWidth4[b.bsize], kHeight4[b.bsize]) * 4;  // pixels
  const int uv_max = min_dim >= 64 ? TX_32X32 : min_dim >= 32 ? TX_16X16 : min_dim >= 16 ? TX_8X8 : TX_4X4;
  return std::min<int>(b.tx, uv_max);
}

void ResetSkipContext(std::vector<uint8_t>* above, TileState& t, int bsize, int mi_row, int mi_col) {
  const int w = kMiWidth[bsize], h = kMiHeight[bsize];
  std::memset(&above[0][mi_col * 2], 0, w * 2);
  std::memset(&above[1][mi_col], 0, w);
  std::memset(&above[2][mi_col], 0, w);
  std::memset(&t.left_nnz[0][(mi_row & 7) * 2], 0, h * 2);
  std::memset(&t.left_nnz[1][mi_row & 7], 0, h);
  std::memset(&t.left_nnz[2][mi_row & 7], 0, h);
}

// ---------------------------------------------------------------------------------------------
// Intra prediction

inline uint8_t Avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }
inline uint8_t Avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }

void Decoder::PredictIntra(int plane, int x, int y, int tx, int mode, bool have_left, bool have_top,
                           bool have_right) {
  SR_VP9_STAGE(kStageIntra);
  const int bs = 4 << tx;
  const int stride = cur_->Stride(plane);
  uint8_t* dst = cur_->Plane(plane) + static_cast<size_t>(y) * stride + x;
  const int aligned_w = plane ? mi_cols_ * 4 : mi_cols_ * 8, aligned_h = plane ? mi_rows_ * 4 : mi_rows_ * 8;
  uint8_t above_buf[80], left[32];
  uint8_t* above = above_buf + 16;
  if (have_top) {
    const uint8_t* src = dst - stride;
    const int avail = aligned_w - x, n = std::min(bs, avail);
    std::memcpy(above, src, n);
    for (int i = n; i < bs; ++i) above[i] = above[n - 1];
    if (tx == TX_4X4 && have_right && bs + 4 <= avail) {
      std::memcpy(above + 4, src + 4, 4);
    } else {
      for (int i = bs; i < 2 * bs; ++i) above[i] = above[bs - 1];
    }
    above[-1] = have_left ? src[-1] : 129;
  } else {
    std::memset(above - 1, 127, 2 * bs + 1);
  }
  if (have_left) {
    const int avail = aligned_h - y, n = std::min(bs, avail);
    for (int i = 0; i < n; ++i) left[i] = dst[static_cast<size_t>(i) * stride - 1];
    for (int i = n; i < bs; ++i) left[i] = left[n - 1];
  } else {
    std::memset(left, 129, bs);
  }
  uint8_t pred[32][32];
  switch (mode) {
    case DC_PRED: {
      int v = 128;
      if (have_top && have_left) {
        int sum = 0;
        for (int i = 0; i < bs; ++i) sum += above[i] + left[i];
        v = (sum + bs) / (2 * bs);
      } else if (have_top) {
        int sum = 0;
        for (int i = 0; i < bs; ++i) sum += above[i];
        v = (sum + bs / 2) / bs;
      } else if (have_left) {
        int sum = 0;
        for (int i = 0; i < bs; ++i) sum += left[i];
        v = (sum + bs / 2) / bs;
      }
      for (int r = 0; r < bs; ++r) std::memset(pred[r], v, bs);
      break;
    }
    case V_PRED:
      for (int r = 0; r < bs; ++r) std::memcpy(pred[r], above, bs);
      break;
    case H_PRED:
      for (int r = 0; r < bs; ++r) std::memset(pred[r], left[r], bs);
      break;
    case TM_PRED:
      for (int r = 0; r < bs; ++r)
        for (int c = 0; c < bs; ++c) pred[r][c] = ClipPixel(left[r] + above[c] - above[-1]);
      break;
    case D45_PRED:
      for (int r = 0; r < bs; ++r)
        for (int c = 0; c < bs; ++c)
          pred[r][c] = r + c + 2 < 2 * bs ? Avg3(above[r + c], above[r + c + 1], above[r + c + 2]) : above[2 * bs - 1];
      break;
    case D63_PRED:
      for (int r = 0; r < bs; ++r) {
        const int i0 = r >> 1;
        for (int c = 0; c < bs; ++c)
          pred[r][c] = (r & 1) ? Avg3(above[i0 + c], above[i0 + c + 1], above[i0 + c + 2])
                               : Avg2(above[i0 + c], above[i0 + c + 1]);
      }
      break;
    case D135_PRED:
      pred[0][0] = Avg3(left[0], above[-1], above[0]);
      for (int c = 1; c < bs; ++c) pred[0][c] = Avg3(above[c - 2], above[c - 1], above[c]);
      pred[1][0] = Avg3(above[-1], left[0], left[1]);
      for (int r = 2; r < bs; ++r) pred[r][0] = Avg3(left[r - 2], left[r - 1], left[r]);
      for (int r = 1; r < bs; ++r)
        for (int c = 1; c < bs; ++c) pred[r][c] = pred[r - 1][c - 1];
      break;
    case D117_PRED:
      for (int c = 0; c < bs; ++c) pred[0][c] = Avg2(above[c - 1], above[c]);
      pred[1][0] = Avg3(left[0], above[-1], above[0]);
      for (int c = 1; c < bs; ++c) pred[1][c] = Avg3(above[c - 2], above[c - 1], above[c]);
      pred[2][0] = Avg3(above[-1], left[0], left[1]);
      for (int r = 3; r < bs; ++r) pred[r][0] = Avg3(left[r - 3], left[r - 2], left[r - 1]);
      for (int r = 2; r < bs; ++r)
        for (int c = 1; c < bs; ++c) pred[r][c] = pred[r - 2][c - 1];
      break;
    case D153_PRED:
      pred[0][0] = Avg2(left[0], above[-1]);
      for (int r = 1; r < bs; ++r) pred[r][0] = Avg2(left[r - 1], left[r]);
      pred[0][1] = Avg3(left[0], above[-1], above[0]);
      pred[1][1] = Avg3(above[-1], left[0], left[1]);
      for (int r = 2; r < bs; ++r) pred[r][1] = Avg3(left[r - 2], left[r - 1], left[r]);
      for (int c = 2; c < bs; ++c) pred[0][c] = Avg3(above[c - 3], above[c - 2], above[c - 1]);
      for (int r = 1; r < bs; ++r)
        for (int c = 2; c < bs; ++c) pred[r][c] = pred[r - 1][c - 2];
      break;
    case D207_PRED:
      for (int c = 0; c < bs; ++c) pred[bs - 1][c] = left[bs - 1];
      for (int r = 0; r < bs - 1; ++r) pred[r][0] = Avg2(left[r], left[r + 1]);
      for (int r = 0; r < bs - 2; ++r) pred[r][1] = Avg3(left[r], left[r + 1], left[r + 2]);
      pred[bs - 2][1] = Avg3(left[bs - 2], left[bs - 1], left[bs - 1]);
      for (int c = 2; c < bs; ++c)
        for (int r = 0; r < bs - 1; ++r) pred[r][c] = pred[r + 1][c - 2];
      break;
  }
  for (int r = 0; r < bs; ++r) std::memcpy(dst + static_cast<size_t>(r) * stride, pred[r], bs);
}

void Decoder::ReconstructIntra(TileState& t, BlockInfo& b, int mi_row, int mi_col) {
  if (b.skip) ResetSkipContext(above_nnz_, t, b.bsize, mi_row, mi_col);
  for (int plane = 0; plane < 3; ++plane) {
    const int tx = plane ? UvTx(b) : b.tx, step = 1 << tx;
    const int w4 = plane ? kMiWidth[b.bsize] : kMiWidth[b.bsize] * 2;
    const int h4 = plane ? kMiHeight[b.bsize] : kMiHeight[b.bsize] * 2;
    const int x0 = plane ? mi_col : mi_col * 2, y0 = plane ? mi_row : mi_row * 2;
    const int end_x = std::min(w4, (plane ? mi_cols_ : mi_cols_ * 2) - x0);
    const int end_y = std::min(h4, (plane ? mi_rows_ : mi_rows_ * 2) - y0);
    const int stride = cur_->Stride(plane);
    for (int y = 0; y < end_y; y += step) {
      for (int x = 0; x < end_x; x += step) {
        const int mode = plane ? b.uv_mode : b.bsize < BLOCK_8X8 ? b.sub_modes[(y << 1) + x] : b.mode;
        PredictIntra(plane, (x0 + x) * 4, (y0 + y) * 4, tx, mode, x > 0 || mi_col > t.col_start, y > 0 || mi_row > 0,
                     x + step < w4);
        if (b.skip) continue;
        const int tx_type = (plane || lossless_) ? static_cast<int>(DCT_DCT) : kModeToTxType[mode];
        std::memset(coef_, 0, sizeof(int16_t) * (16 << (2 * tx)));
        if (DecodeCoefficients(t, b, plane, x0 + x, y0 + y, tx, tx_type, coef_)) {
          uint8_t* dst = cur_->Plane(plane) + static_cast<size_t>((y0 + y) * 4) * stride + (x0 + x) * 4;
          SR_VP9_STAGE(kStageTransforms);
          if (lossless_)
            InverseWhtAdd(coef_, dst, stride);
          else
            InverseTransformAdd(coef_, tx, tx == TX_32X32 ? DCT_DCT : tx_type, dst, stride);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------------------------
// Inter prediction

// Predicts a w x h block of `plane` at (x, y) from `ref`, displaced by (mvx, mvy) sixteenths of a
// plane pixel, reading the reference with its edges replicated; averages into dst when `average`.
void McBlock(const Picture& ref, int plane, int x, int y, int w, int h, int mvx, int mvy, int filter, uint8_t* dst,
             int dst_stride, bool average) {
  const int ix = x + (mvx >> 4), iy = y + (mvy >> 4), fx = mvx & 15, fy = mvy & 15;
  const int pw = ref.PlaneWidth(plane), ph = ref.PlaneHeight(plane), stride = ref.Stride(plane);
  const uint8_t* src = ref.Plane(plane);
  uint8_t block[71 * 71];
  const int bw = w + 7, bh = h + 7;
  int cols[71];
  for (int c = 0; c < bw; ++c) cols[c] = std::clamp(ix - 3 + c, 0, pw - 1);
  for (int r = 0; r < bh; ++r) {
    const uint8_t* row = src + static_cast<size_t>(std::clamp(iy - 3 + r, 0, ph - 1)) * stride;
    for (int c = 0; c < bw; ++c) block[r * 71 + c] = row[cols[c]];
  }
  const int16_t* kx = kFilters + (filter * 16 + fx) * 8;
  const int16_t* ky = kFilters + (filter * 16 + fy) * 8;
  uint8_t out[64 * 64];
  if (fx && fy) {
    uint8_t tmp[71 * 64];
    for (int r = 0; r < bh; ++r)
      for (int c = 0; c < w; ++c) {
        const uint8_t* s = block + r * 71 + c;
        int sum = 0;
        for (int k = 0; k < 8; ++k) sum += kx[k] * s[k];
        tmp[r * 64 + c] = ClipPixel((sum + 64) >> 7);
      }
    for (int r = 0; r < h; ++r)
      for (int c = 0; c < w; ++c) {
        int sum = 0;
        for (int k = 0; k < 8; ++k) sum += ky[k] * tmp[(r + k) * 64 + c];
        out[r * 64 + c] = ClipPixel((sum + 64) >> 7);
      }
  } else if (fx) {
    for (int r = 0; r < h; ++r)
      for (int c = 0; c < w; ++c) {
        const uint8_t* s = block + (r + 3) * 71 + c;
        int sum = 0;
        for (int k = 0; k < 8; ++k) sum += kx[k] * s[k];
        out[r * 64 + c] = ClipPixel((sum + 64) >> 7);
      }
  } else if (fy) {
    for (int r = 0; r < h; ++r)
      for (int c = 0; c < w; ++c) {
        int sum = 0;
        for (int k = 0; k < 8; ++k) sum += ky[k] * block[(r + k) * 71 + c + 3];
        out[r * 64 + c] = ClipPixel((sum + 64) >> 7);
      }
  } else {
    for (int r = 0; r < h; ++r)
      for (int c = 0; c < w; ++c) out[r * 64 + c] = block[(r + 3) * 71 + c + 3];
  }
  for (int r = 0; r < h; ++r) {
    uint8_t* d = dst + static_cast<size_t>(r) * dst_stride;
    for (int c = 0; c < w; ++c) d[c] = average ? Avg2(d[c], out[r * 64 + c]) : out[r * 64 + c];
  }
}

void Decoder::PredictInter(const BlockInfo& b, int mi_row, int mi_col) {
  SR_VP9_STAGE(kStageInter);
  for (int r = 0; r <= b.comp; ++r) {
    const Picture& ref = *refs_[ref_idx_[b.ref[r] - 1]];
    for (int plane = 0; plane < 3; ++plane) {
      const int stride = cur_->Stride(plane);
      uint8_t* base = cur_->Plane(plane);
      if (b.bsize < BLOCK_8X8) {
        if (plane == 0) {
          for (int i = 0; i < 4; ++i) {
            const int x = mi_col * 8 + (i & 1) * 4, y = mi_row * 8 + (i >> 1) * 4;
            McBlock(ref, 0, x, y, 4, 4, b.mv[i][r].col * 2, b.mv[i][r].row * 2, b.filter,
                    base + static_cast<size_t>(y) * stride + x, stride, r == 1);
          }
        } else {
          auto rdiv = [](int s, int d) { return s >= 0 ? (s + d / 2) / d : (s - d / 2) / d; };
          int mx, my;
          if (b.bsize == BLOCK_8X4) {
            mx = rdiv(b.mv[0][r].col + b.mv[2][r].col, 2);
            my = rdiv(b.mv[0][r].row + b.mv[2][r].row, 2);
          } else if (b.bsize == BLOCK_4X8) {
            mx = rdiv(b.mv[0][r].col + b.mv[1][r].col, 2);
            my = rdiv(b.mv[0][r].row + b.mv[1][r].row, 2);
          } else {
            mx = rdiv(b.mv[0][r].col + b.mv[1][r].col + b.mv[2][r].col + b.mv[3][r].col, 4);
            my = rdiv(b.mv[0][r].row + b.mv[1][r].row + b.mv[2][r].row + b.mv[3][r].row, 4);
          }
          const int x = mi_col * 4, y = mi_row * 4;
          McBlock(ref, plane, x, y, 4, 4, mx, my, b.filter, base + static_cast<size_t>(y) * stride + x, stride,
                  r == 1);
        }
      } else {
        const int w = kWidth4[b.bsize] * (plane ? 2 : 4), h = kHeight4[b.bsize] * (plane ? 2 : 4);
        const int x = mi_col * (plane ? 4 : 8), y = mi_row * (plane ? 4 : 8);
        const int scale = plane ? 1 : 2;
        McBlock(ref, plane, x, y, w, h, b.mv[0][r].col * scale, b.mv[0][r].row * scale, b.filter,
                base + static_cast<size_t>(y) * stride + x, stride, r == 1);
      }
    }
  }
}

void Decoder::ReconstructInter(TileState& t, BlockInfo& b, int mi_row, int mi_col) {
  if (b.skip) {
    ResetSkipContext(above_nnz_, t, b.bsize, mi_row, mi_col);
    return;
  }
  bool any = false;
  for (int plane = 0; plane < 3; ++plane) {
    const int tx = plane ? UvTx(b) : b.tx, step = 1 << tx;
    const int w4 = plane ? kMiWidth[b.bsize] : kMiWidth[b.bsize] * 2;
    const int h4 = plane ? kMiHeight[b.bsize] : kMiHeight[b.bsize] * 2;
    const int x0 = plane ? mi_col : mi_col * 2, y0 = plane ? mi_row : mi_row * 2;
    const int end_x = std::min(w4, (plane ? mi_cols_ : mi_cols_ * 2) - x0);
    const int end_y = std::min(h4, (plane ? mi_rows_ : mi_rows_ * 2) - y0);
    const int stride = cur_->Stride(plane);
    for (int y = 0; y < end_y; y += step) {
      for (int x = 0; x < end_x; x += step) {
        std::memset(coef_, 0, sizeof(int16_t) * (16 << (2 * tx)));
        if (DecodeCoefficients(t, b, plane, x0 + x, y0 + y, tx, DCT_DCT, coef_)) {
          any = true;
          uint8_t* dst = cur_->Plane(plane) + static_cast<size_t>((y0 + y) * 4) * stride + (x0 + x) * 4;
          SR_VP9_STAGE(kStageTransforms);
          if (lossless_)
            InverseWhtAdd(coef_, dst, stride);
          else
            InverseTransformAdd(coef_, tx, DCT_DCT, dst, stride);
        }
      }
    }
  }
  if (!any && b.bsize >= BLOCK_8X8) b.skip = 1;
}


// ---------------------------------------------------------------------------------------------
// Loop filter (libvpx's masks over each 64x64 superblock)

struct LfMask {
  uint64_t left_y[4], above_y[4], int_4x4_y;
  uint16_t left_uv[4], above_uv[4], int_4x4_uv;
  uint8_t lfl_y[64];
};

constexpr uint64_t kLeft64Tx[4] = {~0ULL, ~0ULL, 0x5555555555555555ULL, 0x1111111111111111ULL};
constexpr uint64_t kAbove64Tx[4] = {~0ULL, ~0ULL, 0x00ff00ff00ff00ffULL, 0x000000ff000000ffULL};
constexpr uint16_t kLeft64TxUv[4] = {0xffff, 0xffff, 0x5555, 0x1111};
constexpr uint16_t kAbove64TxUv[4] = {0xffff, 0xffff, 0x0f0f, 0x000f};

void BuildMask(const BlockInfo& b, int shift_y, int shift_uv, bool do_uv, LfMask& m) {
  if (!b.level) return;
  const int w8 = kMiWidth[b.bsize], h8 = kMiHeight[b.bsize];
  for (int r = 0; r < h8; ++r) std::memset(&m.lfl_y[shift_y + r * 8], b.level, w8);
  const uint64_t above_pred = (1ULL << w8) - 1;
  uint64_t left_pred = 0;
  for (int r = 0; r < h8; ++r) left_pred |= 1ULL << (8 * r);
  const uint64_t size_mask = above_pred * left_pred;
  const int wuv = std::max(1, w8 >> 1), huv = std::max(1, h8 >> 1);
  const uint16_t above_uv = static_cast<uint16_t>((1 << wuv) - 1);
  uint16_t left_uv = 0;
  for (int r = 0; r < huv; ++r) left_uv = static_cast<uint16_t>(left_uv | (1 << (4 * r)));
  const uint16_t size_uv = static_cast<uint16_t>(above_uv * left_uv);
  const int tx = b.tx, uv_tx = UvTx(b);
  m.above_y[tx] |= above_pred << shift_y;
  m.left_y[tx] |= left_pred << shift_y;
  if (do_uv) {
    m.above_uv[uv_tx] = static_cast<uint16_t>(m.above_uv[uv_tx] | (above_uv << shift_uv));
    m.left_uv[uv_tx] = static_cast<uint16_t>(m.left_uv[uv_tx] | (left_uv << shift_uv));
  }
  if (b.skip && b.is_inter) return;
  m.above_y[tx] |= (size_mask & kAbove64Tx[tx]) << shift_y;
  m.left_y[tx] |= (size_mask & kLeft64Tx[tx]) << shift_y;
  if (do_uv) {
    m.above_uv[uv_tx] = static_cast<uint16_t>(m.above_uv[uv_tx] | ((size_uv & kAbove64TxUv[uv_tx]) << shift_uv));
    m.left_uv[uv_tx] = static_cast<uint16_t>(m.left_uv[uv_tx] | ((size_uv & kLeft64TxUv[uv_tx]) << shift_uv));
  }
  if (tx == TX_4X4) m.int_4x4_y |= size_mask << shift_y;
  if (do_uv && uv_tx == TX_4X4) m.int_4x4_uv = static_cast<uint16_t>(m.int_4x4_uv | (size_uv << shift_uv));
}

inline int Sc8(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }

// Filters one pixel line across an edge: s is the first pixel past the edge, pitch the step across it.
void FilterLine(uint8_t* s, int pitch, int lim, int mblim, int thresh, int width) {
  const int p3 = s[-4 * pitch], p2 = s[-3 * pitch], p1 = s[-2 * pitch], p0 = s[-pitch];
  const int q0 = s[0], q1 = s[pitch], q2 = s[2 * pitch], q3 = s[3 * pitch];
  if (std::abs(p3 - p2) > lim || std::abs(p2 - p1) > lim || std::abs(p1 - p0) > lim || std::abs(q1 - q0) > lim ||
      std::abs(q2 - q1) > lim || std::abs(q3 - q2) > lim || std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 > mblim)
    return;
  const bool flat = width >= 8 && std::abs(p1 - p0) <= 1 && std::abs(q1 - q0) <= 1 && std::abs(p2 - p0) <= 1 &&
                    std::abs(q2 - q0) <= 1 && std::abs(p3 - p0) <= 1 && std::abs(q3 - q0) <= 1;
  if (flat && width == 16) {
    int v[16];
    for (int i = 0; i < 16; ++i) v[i] = s[(i - 8) * pitch];
    bool flat2 = true;
    for (int k = 4; k < 8 && flat2; ++k) flat2 = std::abs(v[7 - k] - p0) <= 1 && std::abs(v[8 + k] - q0) <= 1;
    if (flat2) {
      for (int j = 1; j < 15; ++j) {
        int sum = v[j];
        for (int k = j - 7; k <= j + 7; ++k) sum += v[std::clamp(k, 0, 15)];
        s[(j - 8) * pitch] = static_cast<uint8_t>((sum + 8) >> 4);
      }
      return;
    }
  }
  if (flat) {
    const int v[8] = {p3, p2, p1, p0, q0, q1, q2, q3};
    for (int j = 1; j < 7; ++j) {
      int sum = v[j];
      for (int k = j - 3; k <= j + 3; ++k) sum += v[std::clamp(k, 0, 7)];
      s[(j - 4) * pitch] = static_cast<uint8_t>((sum + 4) >> 3);
    }
    return;
  }
  const int ps1 = p1 - 128, ps0 = p0 - 128, qs0 = q0 - 128, qs1 = q1 - 128;
  const bool hev = std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
  int f = hev ? Sc8(ps1 - qs1) : 0;
  f = Sc8(f + 3 * (qs0 - ps0));
  const int f1 = Sc8(f + 4) >> 3, f2 = Sc8(f + 3) >> 3;
  s[0] = static_cast<uint8_t>(Sc8(qs0 - f1) + 128);
  s[-pitch] = static_cast<uint8_t>(Sc8(ps0 + f2) + 128);
  if (!hev) {
    const int f3 = (f1 + 1) >> 1;
    s[pitch] = static_cast<uint8_t>(Sc8(qs1 - f3) + 128);
    s[-2 * pitch] = static_cast<uint8_t>(Sc8(ps1 + f3) + 128);
  }
}

void Decoder::LoopFilterSuperblock(int mi_row, int mi_col) {
  LfMask m;
  std::memset(&m, 0, sizeof(m));
  const int max_rows = std::min(8, mi_rows_ - mi_row), max_cols = std::min(8, mi_cols_ - mi_col);
  for (int r = 0; r < max_rows; ++r) {
    for (int c = 0; c < max_cols; ++c) {
      const BlockInfo& b = blocks_[grid_[static_cast<size_t>(mi_row + r) * mi_cols_ + mi_col + c]];
      if (b.row != mi_row + r || b.col != mi_col + c) continue;  // not the block's top-left 8x8
      BuildMask(b, r * 8 + c, (r >> 1) * 4 + (c >> 1), !(r & 1) && !(c & 1), m);
    }
  }
  m.left_y[TX_16X16] |= m.left_y[TX_32X32];
  m.above_y[TX_16X16] |= m.above_y[TX_32X32];
  m.left_uv[TX_16X16] = static_cast<uint16_t>(m.left_uv[TX_16X16] | m.left_uv[TX_32X32]);
  m.above_uv[TX_16X16] = static_cast<uint16_t>(m.above_uv[TX_16X16] | m.above_uv[TX_32X32]);
  const uint64_t left_border = 0x1111111111111111ULL, above_border = 0x000000ff000000ffULL;
  const uint16_t left_border_uv = 0x1111, above_border_uv = 0x000f;
  m.left_y[TX_8X8] |= m.left_y[TX_4X4] & left_border;
  m.left_y[TX_4X4] &= ~left_border;
  m.above_y[TX_8X8] |= m.above_y[TX_4X4] & above_border;
  m.above_y[TX_4X4] &= ~above_border;
  m.left_uv[TX_8X8] = static_cast<uint16_t>(m.left_uv[TX_8X8] | (m.left_uv[TX_4X4] & left_border_uv));
  m.left_uv[TX_4X4] = static_cast<uint16_t>(m.left_uv[TX_4X4] & ~left_border_uv);
  m.above_uv[TX_8X8] = static_cast<uint16_t>(m.above_uv[TX_8X8] | (m.above_uv[TX_4X4] & above_border_uv));
  m.above_uv[TX_4X4] = static_cast<uint16_t>(m.above_uv[TX_4X4] & ~above_border_uv);
  if (mi_row + 8 > mi_rows_) {
    const int rows = mi_rows_ - mi_row;
    const uint64_t mask_y = (1ULL << (rows << 3)) - 1;
    const uint16_t mask_uv = static_cast<uint16_t>((1 << (((rows + 1) >> 1) << 2)) - 1);
    for (int i = 0; i < TX_32X32; ++i) {
      m.left_y[i] &= mask_y;
      m.above_y[i] &= mask_y;
      m.left_uv[i] &= mask_uv;
      m.above_uv[i] &= mask_uv;
    }
    m.int_4x4_y &= mask_y;
    m.int_4x4_uv &= mask_uv;
    if (rows == 1) {
      m.above_uv[TX_8X8] = static_cast<uint16_t>(m.above_uv[TX_8X8] | m.above_uv[TX_16X16]);
      m.above_uv[TX_16X16] = 0;
    }
    if (rows == 5) {
      m.above_uv[TX_8X8] = static_cast<uint16_t>(m.above_uv[TX_8X8] | (m.above_uv[TX_16X16] & 0xff00));
      m.above_uv[TX_16X16] = static_cast<uint16_t>(m.above_uv[TX_16X16] & ~0xff00);
    }
  }
  if (mi_col + 8 > mi_cols_) {
    const int columns = mi_cols_ - mi_col;
    const uint64_t mask_y = ((1ULL << columns) - 1) * 0x0101010101010101ULL;
    const uint16_t mask_uv = static_cast<uint16_t>(((1 << ((columns + 1) >> 1)) - 1) * 0x1111);
    const uint16_t mask_uv_int = static_cast<uint16_t>(((1 << (columns >> 1)) - 1) * 0x1111);
    for (int i = 0; i < TX_32X32; ++i) {
      m.left_y[i] &= mask_y;
      m.above_y[i] &= mask_y;
      m.left_uv[i] &= mask_uv;
      m.above_uv[i] &= mask_uv;
    }
    m.int_4x4_y &= mask_y;
    m.int_4x4_uv &= mask_uv_int;
    if (columns == 1) {
      m.left_uv[TX_8X8] = static_cast<uint16_t>(m.left_uv[TX_8X8] | m.left_uv[TX_16X16]);
      m.left_uv[TX_16X16] = 0;
    }
    if (columns == 5) {
      m.left_uv[TX_8X8] = static_cast<uint16_t>(m.left_uv[TX_8X8] | (m.left_uv[TX_16X16] & 0xcccc));
      m.left_uv[TX_16X16] = static_cast<uint16_t>(m.left_uv[TX_16X16] & ~0xcccc);
    }
  }
  if (mi_col == 0) {
    for (int i = 0; i < TX_32X32; ++i) {
      m.left_y[i] &= 0xfefefefefefefefeULL;
      m.left_uv[i] &= 0xeeee;
    }
  }
  auto edge = [&](uint8_t* s, int pitch, int along, int level, int width) {
    const int lim = lim_[level], mblim = mblim_[level], thresh = level >> 4;
    for (int i = 0; i < 8; ++i) FilterLine(s + i * along, pitch, lim, mblim, thresh, width);
  };
  // Luma: vertical edges, then horizontal ones.
  {
    const int stride = cur_->stride;
    uint8_t* base = cur_->Plane(0) + static_cast<size_t>(mi_row * 8) * stride + mi_col * 8;
    for (int r = 0; r < max_rows; ++r) {
      for (int c = 0; c < 8; ++c) {
        const int bit = r * 8 + c, level = m.lfl_y[bit];
        uint8_t* s = base + static_cast<size_t>(r * 8) * stride + c * 8;
        if ((m.left_y[TX_16X16] >> bit) & 1)
          edge(s, 1, stride, level, 16);
        else if ((m.left_y[TX_8X8] >> bit) & 1)
          edge(s, 1, stride, level, 8);
        else if ((m.left_y[TX_4X4] >> bit) & 1)
          edge(s, 1, stride, level, 4);
        if ((m.int_4x4_y >> bit) & 1) edge(s + 4, 1, stride, level, 4);
      }
    }
    for (int r = 0; r < max_rows; ++r) {
      for (int c = 0; c < 8; ++c) {
        const int bit = r * 8 + c, level = m.lfl_y[bit];
        uint8_t* s = base + static_cast<size_t>(r * 8) * stride + c * 8;
        if (mi_row + r > 0) {
          if ((m.above_y[TX_16X16] >> bit) & 1)
            edge(s, stride, 1, level, 16);
          else if ((m.above_y[TX_8X8] >> bit) & 1)
            edge(s, stride, 1, level, 8);
          else if ((m.above_y[TX_4X4] >> bit) & 1)
            edge(s, stride, 1, level, 4);
        }
        if ((m.int_4x4_y >> bit) & 1) edge(s + 4 * stride, stride, 1, level, 4);
      }
    }
  }
  // Chroma: each 8x8 takes the level of the luma 8x8 at its top left.
  for (int plane = 1; plane < 3; ++plane) {
    const int stride = cur_->uv_stride;
    uint8_t* base = cur_->Plane(plane) + static_cast<size_t>(mi_row * 4) * stride + mi_col * 4;
    for (int r = 0; r < max_rows; r += 2) {
      for (int c = 0; c < 4; ++c) {
        const int bit = (r >> 1) * 4 + c, level = m.lfl_y[r * 8 + c * 2];
        uint8_t* s = base + static_cast<size_t>((r >> 1) * 8) * stride + c * 8;
        if ((m.left_uv[TX_16X16] >> bit) & 1)
          edge(s, 1, stride, level, 16);
        else if ((m.left_uv[TX_8X8] >> bit) & 1)
          edge(s, 1, stride, level, 8);
        else if ((m.left_uv[TX_4X4] >> bit) & 1)
          edge(s, 1, stride, level, 4);
        if ((m.int_4x4_uv >> bit) & 1) edge(s + 4, 1, stride, level, 4);
      }
    }
    for (int r = 0; r < max_rows; r += 2) {
      const bool skip_border = mi_row + r == mi_rows_ - 1;
      for (int c = 0; c < 4; ++c) {
        const int bit = (r >> 1) * 4 + c, level = m.lfl_y[r * 8 + c * 2];
        uint8_t* s = base + static_cast<size_t>((r >> 1) * 8) * stride + c * 8;
        if (mi_row + r > 0) {
          if ((m.above_uv[TX_16X16] >> bit) & 1)
            edge(s, stride, 1, level, 16);
          else if ((m.above_uv[TX_8X8] >> bit) & 1)
            edge(s, stride, 1, level, 8);
          else if ((m.above_uv[TX_4X4] >> bit) & 1)
            edge(s, stride, 1, level, 4);
        }
        if (!skip_border && ((m.int_4x4_uv >> bit) & 1)) edge(s + 4 * stride, stride, 1, level, 4);
      }
    }
  }
}

void Decoder::LoopFilterFrame() {
  SR_VP9_STAGE(kStageLoopFilter);
  for (int mi_row = 0; mi_row < mi_rows_; mi_row += 8)
    for (int mi_col = 0; mi_col < mi_cols_; mi_col += 8) LoopFilterSuperblock(mi_row, mi_col);
}

// ---------------------------------------------------------------------------------------------
// Backward adaptation (FFmpeg's ff_vp9_adapt_probs)

void Decoder::AdaptProbabilities() {
  ProbContext& pc = ctx_[ctx_save_];
  const uint32_t uf = (key_ || intra_only_ || !last_keyframe_) ? 112 : 128;
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        for (int k = 0; k < 6; ++k)
          for (int l = 0; l < 6; ++l) {
            if (k == 0 && l >= 3) break;
            uint8_t* pp = pc.coef[t][i][j][k][l];
            const uint32_t* e = counts_.eob[t][i][j][k][l];
            const uint32_t* c = counts_.coef[t][i][j][k][l];
            AdaptProb(&pp[0], e[0], e[1], 24, uf);
            AdaptProb(&pp[1], c[0], c[1] + c[2], 24, uf);
            AdaptProb(&pp[2], c[1], c[2], 24, uf);
          }
  ModeProbs& p = pc.p;
  const Counts& n = counts_;
  if (key_ || intra_only_) {
    std::memcpy(p.skip, prob_.p.skip, sizeof(p.skip));
    std::memcpy(p.tx32, prob_.p.tx32, sizeof(p.tx32));
    std::memcpy(p.tx16, prob_.p.tx16, sizeof(p.tx16));
    std::memcpy(p.tx8, prob_.p.tx8, sizeof(p.tx8));
    return;
  }
  for (int i = 0; i < 3; ++i) AdaptProb(&p.skip[i], n.skip[i][0], n.skip[i][1], 20, 128);
  for (int i = 0; i < 4; ++i) AdaptProb(&p.intra_inter[i], n.intra_inter[i][0], n.intra_inter[i][1], 20, 128);
  if (ref_mode_ == REFERENCE_MODE_SELECT)
    for (int i = 0; i < 5; ++i) AdaptProb(&p.comp_inter[i], n.comp_inter[i][0], n.comp_inter[i][1], 20, 128);
  if (ref_mode_ != SINGLE_REFERENCE)
    for (int i = 0; i < 5; ++i) AdaptProb(&p.comp_ref[i], n.comp_ref[i][0], n.comp_ref[i][1], 20, 128);
  if (ref_mode_ != COMPOUND_REFERENCE)
    for (int i = 0; i < 5; ++i) {
      AdaptProb(&p.single_ref[i][0], n.single_ref[i][0][0], n.single_ref[i][0][1], 20, 128);
      AdaptProb(&p.single_ref[i][1], n.single_ref[i][1][0], n.single_ref[i][1][1], 20, 128);
    }
  for (int i = 0; i < 16; ++i) {
    const uint32_t* c = n.partition[i];
    AdaptProb(&p.partition[i][0], c[0], c[1] + c[2] + c[3], 20, 128);
    AdaptProb(&p.partition[i][1], c[1], c[2] + c[3], 20, 128);
    AdaptProb(&p.partition[i][2], c[2], c[3], 20, 128);
  }
  if (tx_mode_ == TX_MODE_SELECT) {
    for (int i = 0; i < 2; ++i) {
      const uint32_t *c16 = n.tx16[i], *c32 = n.tx32[i];
      AdaptProb(&p.tx8[i][0], n.tx8[i][0], n.tx8[i][1], 20, 128);
      AdaptProb(&p.tx16[i][0], c16[0], c16[1] + c16[2], 20, 128);
      AdaptProb(&p.tx16[i][1], c16[1], c16[2], 20, 128);
      AdaptProb(&p.tx32[i][0], c32[0], c32[1] + c32[2] + c32[3], 20, 128);
      AdaptProb(&p.tx32[i][1], c32[1], c32[2] + c32[3], 20, 128);
      AdaptProb(&p.tx32[i][2], c32[2], c32[3], 20, 128);
    }
  }
  if (interp_filter_ == SWITCHABLE) {
    for (int i = 0; i < 4; ++i) {
      const uint32_t* c = n.interp[i];
      AdaptProb(&p.interp[i][0], c[0], c[1] + c[2], 20, 128);
      AdaptProb(&p.interp[i][1], c[1], c[2], 20, 128);
    }
  }
  for (int i = 0; i < 7; ++i) {
    const uint32_t* c = n.inter_mode[i];  // NEAREST, NEAR, ZERO, NEW
    AdaptProb(&p.inter_mode[i][0], c[2], c[1] + c[0] + c[3], 20, 128);
    AdaptProb(&p.inter_mode[i][1], c[0], c[1] + c[3], 20, 128);
    AdaptProb(&p.inter_mode[i][2], c[1], c[3], 20, 128);
  }
  {
    const uint32_t* c = n.mv_joints;
    AdaptProb(&p.mv_joints[0], c[0], c[1] + c[2] + c[3], 20, 128);
    AdaptProb(&p.mv_joints[1], c[1], c[2] + c[3], 20, 128);
    AdaptProb(&p.mv_joints[2], c[2], c[3], 20, 128);
  }
  for (int i = 0; i < 2; ++i) {
    MvComponentProbs& q = p.mv[i];
    const MvComponentCounts& c = n.mv[i];
    AdaptProb(&q.sign, c.sign[0], c.sign[1], 20, 128);
    const uint32_t* k = c.classes;
    uint32_t sum = 0;
    for (int j = 1; j < 11; ++j) sum += k[j];
    AdaptProb(&q.classes[0], k[0], sum, 20, 128);
    sum -= k[1];
    AdaptProb(&q.classes[1], k[1], sum, 20, 128);
    sum -= k[2] + k[3];
    AdaptProb(&q.classes[2], k[2] + k[3], sum, 20, 128);
    AdaptProb(&q.classes[3], k[2], k[3], 20, 128);
    sum -= k[4] + k[5];
    AdaptProb(&q.classes[4], k[4] + k[5], sum, 20, 128);
    AdaptProb(&q.classes[5], k[4], k[5], 20, 128);
    sum -= k[6];
    AdaptProb(&q.classes[6], k[6], sum, 20, 128);
    AdaptProb(&q.classes[7], k[7] + k[8], k[9] + k[10], 20, 128);
    AdaptProb(&q.classes[8], k[7], k[8], 20, 128);
    AdaptProb(&q.classes[9], k[9], k[10], 20, 128);
    AdaptProb(&q.class0, c.class0[0], c.class0[1], 20, 128);
    for (int j = 0; j < 10; ++j) AdaptProb(&q.bits[j], c.bits[j][0], c.bits[j][1], 20, 128);
    for (int j = 0; j < 2; ++j) {
      const uint32_t* f = c.class0_fp[j];
      AdaptProb(&q.class0_fp[j][0], f[0], f[1] + f[2] + f[3], 20, 128);
      AdaptProb(&q.class0_fp[j][1], f[1], f[2] + f[3], 20, 128);
      AdaptProb(&q.class0_fp[j][2], f[2], f[3], 20, 128);
    }
    AdaptProb(&q.fp[0], c.fp[0], c.fp[1] + c.fp[2] + c.fp[3], 20, 128);
    AdaptProb(&q.fp[1], c.fp[1], c.fp[2] + c.fp[3], 20, 128);
    AdaptProb(&q.fp[2], c.fp[2], c.fp[3], 20, 128);
    if (allow_hp_) {
      AdaptProb(&q.class0_hp, c.class0_hp[0], c.class0_hp[1], 20, 128);
      AdaptProb(&q.hp, c.hp[0], c.hp[1], 20, 128);
    }
  }
  for (int i = 0; i < 4; ++i) AdaptMode(p.y_mode[i], n.y_mode[i]);
  for (int i = 0; i < 10; ++i) AdaptMode(p.uv_mode[i], n.uv_mode[i]);
}

// ---------------------------------------------------------------------------------------------
// One frame

void Decoder::DecodeFrame(const uint8_t* data, size_t size) {
  const bool retain_segmap = segmap_ref_ && (!seg_enabled_ || !seg_update_map_);
  const bool prev_key = key_;
  const size_t header_end = ReadUncompressedHeader(data, size);
  if (header_end == 0) return;  // show_existing_frame
  last_keyframe_ = prev_key;
  // FFmpeg's references for the segmentation map a frame predicts from and the previous frame's vectors.
  const std::shared_ptr<Picture> src = (!intra_only_ && !key_ && !error_res_) ? cur_ : nullptr;
  if (!retain_segmap || key_ || intra_only_) segmap_ref_ = src;
  mvpair_ref_ = src;
  use_last_mvs_ = use_last_mvs_ && cur_ && cur_->width == width_ && cur_->height == height_;
  cur_ = std::make_shared<Picture>();
  cur_->Allocate(width_, height_);
  mi_cols_ = cur_->mi_cols;
  mi_rows_ = cur_->mi_rows;
  sb_cols_ = (mi_cols_ + 7) >> 3;
  blocks_.clear();
  blocks_.reserve(static_cast<size_t>(mi_cols_) * mi_rows_);
  grid_.assign(static_cast<size_t>(mi_cols_) * mi_rows_, -1);
  SetupSegmentsAndFilterLevels();
  prob_ = ctx_[ctx_read_];
  std::memset(&counts_, 0, sizeof(counts_));
  ReadCompressedHeader(data + header_end, compressed_size_);
  DecodeTiles(data + header_end + compressed_size_, size - header_end - compressed_size_);
  if (lf_level_) LoopFilterFrame();
  if (refresh_ctx_ && parallel_) {
    for (int t = 0; t <= kTxModeToBiggest[tx_mode_]; ++t)
      std::memcpy(ctx_[ctx_save_].coef[t], prob_.coef[t], sizeof(prob_.coef[t]));
    ctx_[ctx_save_].p = prob_.p;
  } else if (refresh_ctx_) {
    AdaptProbabilities();
  }
  for (int i = 0; i < 8; ++i) {
    if (refresh_flags_ & (1 << i)) {
      refs_[i] = cur_;
      Count(static_cast<Stat>(kRefresh0 + i));
    }
  }
  if (show_) shown_.push_back(cur_);
  if (key_) have_keyframe_ = true;
  // Counts of what the frame used.
  Count(kFrames);
  if (key_) Count(kKeyFrames);
  if (intra_only_) Count(kIntraOnlyFrames);
  if (!key_ && !intra_only_) Count(kInterFrames);
  if (!show_) Count(kHiddenFrames);
  if (!key_ && !intra_only_ && (sign_bias_[1] || sign_bias_[2] || sign_bias_[3])) Count(kSignBiasFrames);
  if (ref_mode_ == COMPOUND_REFERENCE) Count(kCompoundFixedFrames);
  if (ref_mode_ == REFERENCE_MODE_SELECT) Count(kCompoundSelectFrames);
  if (!key_ && !intra_only_ && interp_filter_ == SWITCHABLE) Count(kSwitchableFilterFrames);
  if (!key_ && !intra_only_ && allow_hp_) Count(kHighPrecisionFrames);
  if (seg_enabled_) {
    Count(kSegmentedFrames);
    if (seg_update_map_) Count(kSegmentMapUpdates);
    if (seg_update_map_ && seg_temporal_) Count(kSegmentTemporalUpdates);
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 4; ++j)
        if (seg_feature_[i][j]) {
          Count(static_cast<Stat>(kSegmentAltQ + j));
        }
  }
  if (lossless_) Count(kLosslessFrames);
  if (error_res_) Count(kErrorResilientFrames);
  if (refresh_ctx_ && !parallel_) Count(kAdaptedFrames);
  if (parallel_) Count(kParallelFrames);
  if (!refresh_ctx_) Count(kContextNotRefreshed);
  if (reset_ctx_ == 2) Count(kResetContext2);
  if (reset_ctx_ == 3) Count(kResetContext3);
  Count(static_cast<Stat>(kContext0 + ctx_read_));
  if (tx_mode_ == TX_MODE_SELECT) Count(kTxSelectFrames);
  if (sharpness_) Count(kSharpFrames);
  if (!lf_level_) Count(kLfZeroFrames);
  if ((width_ & 7) || (height_ & 7)) Count(kOddSizeFrames);
}

}  // namespace sr_vp9

// ---------------------------------------------------------------------------------------------
// C interface

namespace {

void CopyMessage(const char* msg, char* err, int err_len) {
  if (err && err_len > 0) {
    std::strncpy(err, msg, err_len - 1);
    err[err_len - 1] = '\0';
  }
}

}  // namespace

extern "C" {

void* sr_vp9_stream_new() { return new sr_vp9::Decoder(); }

void sr_vp9_stream_free(void* handle) { delete static_cast<sr_vp9::Decoder*>(handle); }

int sr_vp9_stream_decode(void* handle, const uint8_t* data, int64_t size, char* err, int err_len) {
  try {
    if (size <= 0) return 0;
    return static_cast<sr_vp9::Decoder*>(handle)->DecodePayload(data, static_cast<size_t>(size));
  } catch (const sr_vp9::Unsupported& e) {
    CopyMessage(e.what(), err, err_len);
    return -2;
  } catch (const std::exception& e) {
    CopyMessage(e.what(), err, err_len);
    return -1;
  }
}

void sr_vp9_stream_size(void* handle, int32_t* width_height) {
  const auto* dec = static_cast<const sr_vp9::Decoder*>(handle);
  width_height[0] = dec->width();
  width_height[1] = dec->height();
}

void sr_vp9_stream_bgr(void* handle, int index, uint8_t* out) {
  const auto* dec = static_cast<const sr_vp9::Decoder*>(handle);
  const sr_vp9::Picture& pic = dec->shown(index);
  sr_yuv::Yuv420ToBgr(pic.Plane(0), pic.Plane(1), pic.Plane(2), pic.stride, pic.uv_stride, pic.width, pic.height,
                      out);
}

void sr_vp9_stream_plane(void* handle, int index, int plane, uint8_t* out) {
  const auto* dec = static_cast<const sr_vp9::Decoder*>(handle);
  const sr_vp9::Picture& pic = dec->shown(index);
  const int w = pic.PlaneWidth(plane), h = pic.PlaneHeight(plane);
  const uint8_t* src = pic.Plane(plane);
  for (int y = 0; y < h; ++y) {
    std::memcpy(out + static_cast<size_t>(y) * w, src + static_cast<size_t>(y) * pic.Stride(plane), w);
  }
}

int sr_vp9_stream_profile(void* handle, int64_t* out, int n) {
  const int64_t* ns = static_cast<const sr_vp9::Decoder*>(handle)->profile();
  for (int i = 0; i < n && i < sr_vp9::kNumStages; ++i) out[i] = ns[i];
  return sr_vp9::kNumStages;
}

int sr_vp9_stream_stats(void* handle, int64_t* out, int n) {
  const int64_t* stats = static_cast<const sr_vp9::Decoder*>(handle)->stats();
  for (int i = 0; i < n && i < sr_vp9::kNumStats; ++i) out[i] = stats[i];
  return sr_vp9::kNumStats;
}

}  // extern "C"
