// MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile macroblock decoding: the
// serial half of super_resolution_tpu_torch.utils.mpeg4, which parses the
// VOS / VOL / VOP headers and keeps the reference picture.
//
// One call decodes the macroblocks of one I- or P-VOP into the 16-pixel grid
// of YUV 4:2:0 planes: intra DC / AC prediction, the three escape modes,
// H.263 and MPEG inverse quantisation (with mismatch control on inter
// blocks), median motion-vector prediction with its video-packet edge rules,
// 1MV and 4MV half-pel motion compensation with unrestricted vectors, and
// video packets (resync markers). Every integer step is the one FFmpeg's
// decoder takes in its x86-64 build, which is the decoder cv2.VideoCapture
// runs: its "simple" integer IDCT (the IDCT FFmpeg's own encoder
// reconstructs with, so a decode shows no drift over a GOP) or, for streams
// FFmpeg takes for Xvid's, its Xvid IDCT; its half-pel averages,
// chroma-vector rounding and edge clamps, and its prediction state layout.
// Where its SIMD code departs from its C code -- 16-bit saturation in the
// IDCTs, 16-bit products in MPEG inverse quantisation, the 8-pixel
// no-rounding averages at 0 -- this follows the SIMD code. Two of FFmpeg's
// workarounds for old encoders are followed where the caller asks: edges
// taken at the picture's size instead of the macroblock grid's
// (FF_BUG_EDGE), and intra DC predictors not clipped at 2047 (FF_BUG_DC_CLIP).
// A second call converts the planes to BGR24 as cv2.VideoCapture does
// (swscale_bgr.h: BT.601, limited range, at any size, with the chroma sited
// left as FFmpeg's MPEG-4 decoder marks it).
//
// C interface (ctypes):
//   int sr_mpeg4_decode_vop(const uint8_t* data, int64_t size, int64_t bit_pos,
//                           const int32_t* params, const int32_t* matrices,
//                           const uint8_t* ref, uint8_t* out, char* err, int err_len)
//     params: width, height, coding type (0 = I, 1 = P), quantiser, fcode,
//             rounding type, intra_dc_vlc_thr, quant type, time increment bits,
//             flags (kXvidIdct | kEdgeBug | kDcClipBug)
//     matrices: intra then inter quantiser matrix, 64 each, raster order
//     ref / out: Y then U then V, each the full macroblock grid
//   Returns 0, or -1 with a message in err.
//   void sr_mpeg4_idct(int16_t* block, int xvid)
//     the IDCT in place on 64 coefficients in raster order (the 16-bit values
//     before pixels are clipped): the simple one, or the Xvid one where xvid != 0
//   void sr_mpeg4_yuv420_to_bgr(const uint8_t* planes, int mb_w, int mb_h,
//                               int width, int height, uint8_t* bgr)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "simple_idct.h"
#include "swscale_bgr.h"

namespace {

using sr_idct::Plane;
using sr_idct::predict;
using sr_idct::saturate16;
using sr_idct::simple_idct;

struct Code {
  uint16_t code;
  uint8_t len;
};

// Table B-6: MCBPC for I-VOPs; index = cbpc | 4 * (intra+q); 8 = stuffing.
const Code kIntraMcbpc[9] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4}, {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// Table B-7: MCBPC for P-VOPs; index = cbpc | 4 * intra | 8 * dquant | 16 * 4MV; 20 = stuffing.
const Code kInterMcbpc[28] = {
    {1, 1}, {3, 4},  {2, 4},  {5, 6},  {3, 5}, {4, 8}, {3, 8}, {3, 7}, {3, 3},  {7, 7},
    {6, 7}, {5, 9},  {4, 6},  {4, 9},  {3, 9}, {2, 9}, {2, 3}, {5, 7}, {4, 7},  {5, 8},
    {1, 9}, {0, 0},  {0, 0},  {0, 0},  {2, 11}, {12, 13}, {14, 13}, {15, 13}};
// Table B-8: CBPY for intra macroblocks (inter ones invert it).
const Code kCbpy[16] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
                        {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// Table B-12: motion vector magnitude codes 0..32 (a sign bit follows a non-zero one).
const Code kMv[33] = {{1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},   {3, 7},   {11, 9},
                      {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10}, {14, 10}, {13, 10}, {12, 10}, {11, 10},
                      {10, 10}, {9, 10},  {8, 10},  {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},
                      {5, 11},  {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};
// Tables B-13 / B-14: dct_dc_size for luminance and chrominance.
const Code kDcLum[13] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                         {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const Code kDcChrom[13] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4}, {1, 5}, {1, 6},
                           {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};

// Table B-16: intra TCOEF; 102 (run, level) codes, those from index 67 on with last = 1, then the escape.
const Code kIntraTcoef[103] = {
    {2, 2},   {6, 3},   {15, 4},  {13, 5},  {12, 5},  {21, 6},  {19, 6},  {18, 6},  {23, 7},  {31, 8},  {30, 8},
    {29, 8},  {37, 9},  {36, 9},  {35, 9},  {33, 9},  {33, 10}, {32, 10}, {15, 10}, {14, 10}, {7, 11},  {6, 11},
    {32, 11}, {33, 11}, {80, 12}, {81, 12}, {82, 12}, {14, 4},  {20, 6},  {22, 7},  {28, 8},  {32, 9},  {31, 9},
    {13, 10}, {34, 11}, {83, 12}, {85, 12}, {11, 5},  {21, 7},  {30, 9},  {12, 10}, {86, 12}, {17, 6},  {27, 8},
    {29, 9},  {11, 10}, {16, 6},  {34, 9},  {10, 10}, {13, 6},  {28, 9},  {8, 10},  {18, 7},  {27, 9},  {84, 12},
    {20, 7},  {26, 9},  {87, 12}, {25, 8},  {9, 10},  {24, 8},  {35, 11}, {23, 8},  {25, 9},  {24, 9},  {7, 10},
    {88, 12}, {7, 4},   {12, 6},  {22, 8},  {23, 9},  {6, 10},  {5, 11},  {4, 11},  {89, 12}, {15, 6},  {22, 9},
    {5, 10},  {14, 6},  {4, 10},  {17, 7},  {36, 11}, {16, 7},  {37, 11}, {19, 7},  {90, 12}, {21, 8},  {91, 12},
    {20, 8},  {19, 8},  {26, 8},  {21, 9},  {20, 9},  {19, 9},  {18, 9},  {17, 9},  {38, 11}, {39, 11}, {92, 12},
    {93, 12}, {94, 12}, {95, 12}, {3, 7}};
const int8_t kIntraRun[102] = {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                               0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2,
                               3,  3,  3,  3,  4,  4,  4,  5,  5,  5,  6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10,
                               11, 12, 13, 14, 0,  0,  0,  0,  0,  0,  0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                               5,  5,  6,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20};
const int8_t kIntraLevel[102] = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
                                 22, 23, 24, 25, 26, 27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5,
                                 1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1,
                                 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 1, 2, 1, 2, 1, 2,
                                 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
// Table B-17: inter TCOEF; 102 (run, level) codes, those from index 58 on with last = 1, then the escape.
const Code kInterTcoef[103] = {
    {2, 2},   {15, 4},  {21, 6},  {23, 7},  {31, 8},  {37, 9},  {36, 9},  {33, 10}, {32, 10}, {7, 11},  {6, 11},
    {32, 11}, {6, 3},   {20, 6},  {30, 8},  {15, 10}, {33, 11}, {80, 12}, {14, 4},  {29, 8},  {14, 10}, {81, 12},
    {13, 5},  {35, 9},  {13, 10}, {12, 5},  {34, 9},  {82, 12}, {11, 5},  {12, 10}, {83, 12}, {19, 6},  {11, 10},
    {84, 12}, {18, 6},  {10, 10}, {17, 6},  {9, 10},  {16, 6},  {8, 10},  {22, 7},  {85, 12}, {21, 7},  {20, 7},
    {28, 8},  {27, 8},  {33, 9},  {32, 9},  {31, 9},  {30, 9},  {29, 9},  {28, 9},  {27, 9},  {26, 9},  {34, 11},
    {35, 11}, {86, 12}, {87, 12}, {7, 4},   {25, 9},  {5, 11},  {15, 6},  {4, 11},  {14, 6},  {13, 6},  {12, 6},
    {19, 7},  {18, 7},  {17, 7},  {16, 7},  {26, 8},  {25, 8},  {24, 8},  {23, 8},  {22, 8},  {21, 8},  {20, 8},
    {19, 8},  {24, 9},  {23, 9},  {22, 9},  {21, 9},  {20, 9},  {19, 9},  {18, 9},  {17, 9},  {7, 10},  {6, 10},
    {5, 10},  {4, 10},  {36, 11}, {37, 11}, {38, 11}, {39, 11}, {88, 12}, {89, 12}, {90, 12}, {91, 12}, {92, 12},
    {93, 12}, {94, 12}, {95, 12}, {3, 7}};
const int8_t kInterRun[102] = {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  2,  2,  2,
                               2,  3,  3,  3,  4,  4,  4,  5,  5,  5,  6,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
                               11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0,  0,  0,  1,  1,
                               2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
                               23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40};
const int8_t kInterLevel[102] = {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3,
                                 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2,
                                 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2,
                                 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};

const uint8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltHorizontal[64] = {0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
                                    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
                                    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
                                    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltVertical[64] = {0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
                                  41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
                                  51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
                                  53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
// Table 7-1: DC scaler by quantiser.
const uint8_t kYDcScale[32] = {0,  8,  8,  8,  8,  10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23,
                               24, 25, 26, 27, 28, 29, 30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
const uint8_t kCDcScale[32] = {0,  8,  8,  8,  8,  9,  9,  10, 10, 11, 11, 12, 12, 13, 13, 14,
                               14, 15, 15, 16, 16, 17, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25};
const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};  // intra_dc_vlc_thr -> quantiser bound
const int kQuantStep[4] = {-1, -2, 1, 2};                       // dquant

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

class BitReader {
 public:
  BitReader(const uint8_t* data, int64_t size, int64_t pos) : data_(data), bytes_(size), bits_(size * 8), pos_(pos) {}
  // The next n (<= 32) bits; past the end of the data they read as zeros.
  uint32_t peek(int n) const {
    int64_t byte = pos_ >> 3;
    uint64_t v = 0;
    if (byte + 8 <= bytes_) {
      for (int i = 0; i < 8; ++i) v = (v << 8) | data_[byte + i];
    } else {
      for (int i = 0; i < 8; ++i) v = (v << 8) | (byte + i < bytes_ && byte + i >= 0 ? data_[byte + i] : 0);
    }
    return static_cast<uint32_t>((v << (pos_ & 7)) >> (64 - n));
  }
  uint32_t get(int n) {
    uint32_t v = peek(n);
    pos_ += n;
    return v;
  }
  int get1() { return static_cast<int>(get(1)); }
  int get_signed(int n) {  // two's complement
    int v = static_cast<int>(get(n));
    return v >= (1 << (n - 1)) ? v - (1 << n) : v;
  }
  int get_xbits(int n) {  // dct_dc_differential: a leading 0 marks a negative value
    int v = static_cast<int>(get(n));
    return (v >> (n - 1)) ? v : v - (1 << n) + 1;
  }
  void skip(int n) { pos_ += n; }
  void align() { pos_ = (pos_ + 7) & ~int64_t{7}; }
  int64_t pos() const { return pos_; }
  int64_t size() const { return bits_; }

 private:
  const uint8_t* data_;
  int64_t bytes_, bits_, pos_;
};

class Vlc {
 public:
  Vlc(const Code* codes, int n) {
    for (int i = 0; i < n; ++i) bits_ = std::max<int>(bits_, codes[i].len);
    sym_.assign(size_t{1} << bits_, -1);
    len_.assign(size_t{1} << bits_, 0);
    for (int i = 0; i < n; ++i) {
      if (!codes[i].len) continue;
      int shift = bits_ - codes[i].len;
      size_t first = size_t{codes[i].code} << shift;
      for (size_t j = 0; j < (size_t{1} << shift); ++j) {
        sym_[first + j] = static_cast<int16_t>(i);
        len_[first + j] = codes[i].len;
      }
    }
  }
  int decode(BitReader& br) const {  // the symbol, or -1 for a code not in the table
    uint32_t v = br.peek(bits_);
    if (!len_[v]) return -1;
    br.skip(len_[v]);
    return sym_[v];
  }

 private:
  int bits_ = 0;
  std::vector<int16_t> sym_;
  std::vector<uint8_t> len_;
};

struct RunLevel {
  RunLevel(const Code* codes, const int8_t* run, const int8_t* level, int last) : vlc(codes, 103) {
    for (int i = 0; i < 102; ++i) {
      run_plus[i] = run[i] + 1 + (i >= last ? 192 : 0);
      this->level[i] = level[i];
    }
    std::memset(max_level, 0, sizeof max_level);
    std::memset(max_run, 0, sizeof max_run);
    for (int i = 0; i < 102; ++i) {
      int l = i >= last;
      max_level[l][run[i]] = std::max<int>(max_level[l][run[i]], level[i]);
      max_run[l][level[i]] = std::max<int>(max_run[l][level[i]], run[i]);
    }
  }
  static constexpr int kEscape = 102;
  Vlc vlc;
  int run_plus[102];  // run + 1, plus 192 where last = 1
  int level[102];
  int max_level[2][65];  // LMAX by (last, run)
  int max_run[2][65];    // RMAX by (last, level)
};

const Vlc& intra_mcbpc_vlc() { static const Vlc v(kIntraMcbpc, 9); return v; }
const Vlc& inter_mcbpc_vlc() { static const Vlc v(kInterMcbpc, 28); return v; }
const Vlc& cbpy_vlc() { static const Vlc v(kCbpy, 16); return v; }
const Vlc& mv_vlc() { static const Vlc v(kMv, 33); return v; }
const Vlc& dc_lum_vlc() { static const Vlc v(kDcLum, 13); return v; }
const Vlc& dc_chrom_vlc() { static const Vlc v(kDcChrom, 13); return v; }
const RunLevel& intra_rl() { static const RunLevel r(kIntraTcoef, kIntraRun, kIntraLevel, 67); return r; }
const RunLevel& inter_rl() { static const RunLevel r(kInterTcoef, kInterRun, kInterLevel, 58); return r; }

inline int mid_pred(int a, int b, int c) { return std::max(std::min(a, b), std::min(std::max(a, b), c)); }


// FFmpeg's Xvid IDCT as its x86 SSE2 build computes it (Walken's row pass,
// Skal's LLM column pass). Rows: exact 32-bit sums of the coefficients times
// one of four cosine tables, plus a per-row rounder that also carries the
// column pass's rounding (row 0) and a bias correction (rows 1-3, 5-7),
// shifted by 11 and saturated to 16 bits. Columns: 16-bit lanes throughout,
// products keeping their high 16 bits (pmulhw), sums saturated (paddsw /
// psubsw), outputs shifted by 6. A zero row stays zero in every row but the
// first three, so skipping zero rows as the SIMD code does changes nothing.
const int kXvidTab04[7] = {22725, 21407, 19266, 16384, 12873, 8867, 4520};
const int kXvidTab17[7] = {31521, 29692, 26722, 22725, 17855, 12299, 6270};
const int kXvidTab26[7] = {29692, 27969, 25172, 21407, 16819, 11585, 5906};
const int kXvidTab35[7] = {26722, 25172, 22654, 19266, 15137, 10426, 5315};
const int* const kXvidRowTab[8] = {kXvidTab04, kXvidTab17, kXvidTab26, kXvidTab35,
                                   kXvidTab04, kXvidTab35, kXvidTab26, kXvidTab17};
const int kXvidRounder[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};
constexpr int kTan1 = 0x32EC, kTan2 = 0x6A0A, kTan3 = 0xAB0E - 0x10000, kSqrt2 = 0x5A82;

inline int mulhi(int c, int x) { return (c * x) >> 16; }                 // pmulhw
inline int adds(int a, int b) { return saturate16(a + b); }             // paddsw
inline int subs(int a, int b) { return saturate16(a - b); }             // psubsw

void xvid_idct(int16_t* block) {
  for (int r = 0; r < 8; ++r) {
    int16_t* x = block + 8 * r;
    const int* t = kXvidRowTab[r];
    const int c1 = t[0], c2 = t[1], c3 = t[2], c4 = t[3], c5 = t[4], c6 = t[5], c7 = t[6];
    // unsigned: the 32-bit lanes wrap
    const unsigned k = static_cast<unsigned>(c4 * x[0] + kXvidRounder[r]);
    const unsigned a0 = k + c2 * x[2] + c4 * x[4] + c6 * x[6];
    const unsigned a1 = k + c6 * x[2] - c4 * x[4] - c2 * x[6];
    const unsigned a2 = k - c6 * x[2] - c4 * x[4] + c2 * x[6];
    const unsigned a3 = k - c2 * x[2] + c4 * x[4] - c6 * x[6];
    const unsigned b0 = c1 * x[1] + c3 * x[3] + c5 * x[5] + c7 * x[7];
    const unsigned b1 = c3 * x[1] - c7 * x[3] - c1 * x[5] - c5 * x[7];
    const unsigned b2 = c5 * x[1] - c1 * x[3] + c7 * x[5] + c3 * x[7];
    const unsigned b3 = c7 * x[1] - c5 * x[3] + c3 * x[5] - c1 * x[7];
    const unsigned sums[8] = {a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0};
    for (int i = 0; i < 8; ++i) x[i] = saturate16(static_cast<int>(sums[i]) >> 11);
  }
  for (int c = 0; c < 8; ++c) {
    int16_t* in = block + c;
    const int x0 = in[0], x1 = in[8], x2 = in[16], x3 = in[24], x4 = in[32], x5 = in[40], x6 = in[48], x7 = in[56];
    // odd part
    int m0 = adds(mulhi(kTan1, x7), x1);
    int m1 = subs(mulhi(kTan1, x1), x7);
    int m2 = adds(adds(mulhi(kTan3, x5), x5), x3);  // tan3 > 1/2: x * (tan3 - 1) + x
    int m3 = subs(adds(mulhi(kTan3, x3), x3), x5);
    int m7 = adds(m0, m2);
    int m4 = subs(m1, m3);
    m0 = subs(m0, m2);
    m1 = adds(m1, m3);
    int m6 = adds(m0, m1);
    int m5 = subs(m0, m1);
    m5 = saturate16(2 * mulhi(kSqrt2, m5));
    m6 = saturate16(2 * mulhi(kSqrt2, m6));
    // even part
    int e3 = adds(mulhi(kTan2, x6), x2);
    int e2 = subs(mulhi(kTan2, x2), x6);
    int e0 = adds(x0, x4), e1 = subs(x0, x4);
    int t = adds(e0, e3);
    e3 = subs(e0, e3);
    in[0] = static_cast<int16_t>(adds(t, m7) >> 6);
    in[56] = static_cast<int16_t>(subs(t, m7) >> 6);
    in[24] = static_cast<int16_t>(adds(e3, m4) >> 6);
    in[32] = static_cast<int16_t>(subs(e3, m4) >> 6);
    t = adds(e1, e2);
    e2 = subs(e1, e2);
    in[8] = static_cast<int16_t>(adds(t, m6) >> 6);
    in[48] = static_cast<int16_t>(subs(t, m6) >> 6);
    in[16] = static_cast<int16_t>(adds(e2, m5) >> 6);
    in[40] = static_cast<int16_t>(subs(e2, m5) >> 6);
  }
}

// The IDCT of block written to (add = false) or added to (add = true) the 8x8 pixels at dst.
void idct(int16_t* block, uint8_t* dst, int stride, bool add, bool xvid) {
  if (xvid) {
    xvid_idct(block);
  } else {
    simple_idct(block);
  }
  sr_idct::write_block(block, dst, stride, add);
}


inline int round_chroma(int x) {  // the sum of four luma vectors -> one chroma vector, in half pels
  static const uint8_t kTab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
  return kTab[x & 0xf] + ((x >> 3) & ~1);
}

enum { kSliceOk = 0, kSliceEnd = 1 };
enum { kXvidIdct = 1, kEdgeBug = 2, kDcClipBug = 4 };  // params[9]

class VopDecoder {
 public:
  VopDecoder(const int32_t* params, const int32_t* matrices, const uint8_t* ref, uint8_t* out)
      : width_(params[0]), height_(params[1]), pict_type_(params[2] ? 2 : 1), f_code_(params[4]),
        no_rounding_(params[5] != 0), intra_dc_threshold_(kDcThreshold[params[6] & 7]), mpeg_quant_(params[7] != 0),
        time_increment_bits_(params[8]), xvid_idct_((params[9] & kXvidIdct) != 0),
        dc_clip_bug_((params[9] & kDcClipBug) != 0) {
    mb_w_ = (width_ + 15) / 16;
    mb_h_ = (height_ + 15) / 16;
    const bool edge_bug = (params[9] & kEdgeBug) != 0;
    h_edge_ = edge_bug ? width_ : 16 * mb_w_;
    v_edge_ = edge_bug ? height_ : 16 * mb_h_;
    mb_num_ = mb_w_ * mb_h_;
    mb_stride_ = mb_w_ + 1;
    b8_stride_ = 2 * mb_w_ + 1;
    std::memcpy(intra_matrix_, matrices, sizeof intra_matrix_);
    std::memcpy(inter_matrix_, matrices + 64, sizeof inter_matrix_);
    int lw = 16 * mb_w_, lh = 16 * mb_h_;
    cur_[0] = {out, lw, lh};
    cur_[1] = {out + lw * lh, lw / 2, lh / 2};
    cur_[2] = {out + lw * lh + lw * lh / 4, lw / 2, lh / 2};
    if (ref) {
      uint8_t* r = const_cast<uint8_t*>(ref);
      ref_[0] = {r, lw, lh};
      ref_[1] = {r + lw * lh, lw / 2, lh / 2};
      ref_[2] = {r + lw * lh + lw * lh / 4, lw / 2, lh / 2};
    }
    // DC / AC prediction state in FFmpeg's layout: luma blocks on a grid of
    // b8_stride columns, then each chroma plane on mb_stride columns, with a
    // row above and a shared column beside, at DC 1024 and AC 0.
    y_size_ = b8_stride_ * (2 * mb_h_ + 1);
    c_size_ = mb_stride_ * (mb_h_ + 1);
    dc_base_.assign(y_size_ + 2 * c_size_, 1024);
    ac_base_.assign(size_t(y_size_ + 2 * c_size_) * 16, 0);
    qscale_table_.assign(mb_stride_ * mb_h_, 0);
    motion_base_.assign(size_t(b8_stride_) * (2 * mb_h_ + 2) * 2 + 64, 0);
    motion_ = motion_base_.data() + 2 * (b8_stride_ + 4);
    set_qscale(params[3]);
  }

  void decode(BitReader& br) {
    if (pict_type_ == 2 && !ref_[0].data) throw Error("a P-VOP without a reference VOP before it");
    mb_x_ = mb_y_ = 0;
    decode_slice(br);
    while (mb_y_ < mb_h_) {
      resync(br);
      clean_buffers();
      decode_slice(br);
    }
  }

 private:
  // --- state ---
  int width_, height_, pict_type_, f_code_;
  bool no_rounding_;
  int intra_dc_threshold_;
  bool mpeg_quant_;
  int time_increment_bits_;
  bool xvid_idct_, dc_clip_bug_;
  int h_edge_, v_edge_;  // where reference pictures end for motion compensation
  int intra_matrix_[64], inter_matrix_[64];
  int mb_w_, mb_h_, mb_num_, mb_stride_, b8_stride_, y_size_, c_size_;
  Plane cur_[3], ref_[3] = {{nullptr, 0, 0}, {nullptr, 0, 0}, {nullptr, 0, 0}};
  std::vector<int16_t> dc_base_, ac_base_, motion_base_;
  std::vector<int8_t> qscale_table_;
  int16_t* motion_;
  int qscale_ = 1, y_dc_scale_ = 8, c_dc_scale_ = 8;
  int mb_x_ = 0, mb_y_ = 0, resync_mb_x_ = 0, resync_mb_y_ = 0;
  bool first_slice_line_ = true;
  int block_index_[6];
  bool mb_intra_ = false, ac_pred_ = false, four_mv_ = false;
  int mv_[4][2];
  int16_t block_[6][64];
  int block_last_index_[6];

  int16_t* dc_val() { return dc_base_.data() + b8_stride_ + 1; }
  int16_t* ac_val() { return ac_base_.data() + size_t(b8_stride_ + 1) * 16; }
  int wrap(int n) const { return n < 4 ? b8_stride_ : mb_stride_; }

  void set_qscale(int q) {
    qscale_ = std::min(std::max(q, 1), 31);
    y_dc_scale_ = kYDcScale[qscale_];
    c_dc_scale_ = kCDcScale[qscale_];
  }

  void init_block_index() {
    block_index_[0] = b8_stride_ * (2 * mb_y_) + 2 * mb_x_;
    block_index_[1] = block_index_[0] + 1;
    block_index_[2] = b8_stride_ * (2 * mb_y_ + 1) + 2 * mb_x_;
    block_index_[3] = block_index_[2] + 1;
    block_index_[4] = mb_stride_ * (mb_y_ + 1) + b8_stride_ * mb_h_ * 2 + mb_x_;
    block_index_[5] = mb_stride_ * (mb_y_ + mb_h_ + 2) + b8_stride_ * mb_h_ * 2 + mb_x_;
  }

  [[noreturn]] void fail(const char* what) const {
    char msg[160];
    std::snprintf(msg, sizeof msg, "%s at macroblock (%d, %d) of a %s-VOP", what, mb_x_, mb_y_,
                  pict_type_ == 1 ? "I" : "P");
    throw Error(msg);
  }

  int prefix_length() const { return pict_type_ == 1 ? 16 : f_code_ + 15; }
  int mb_num_bits() const {
    int v = mb_num_ - 1, bits = 0;
    while (v > 0) { ++bits; v >>= 1; }
    return std::max(bits, 1);
  }

  // --- video packets ---
  void decode_slice(BitReader& br) {
    first_slice_line_ = true;
    resync_mb_x_ = mb_x_;
    resync_mb_y_ = mb_y_;
    set_qscale(qscale_);
    for (; mb_y_ < mb_h_; ++mb_y_) {
      for (; mb_x_ < mb_w_; ++mb_x_) {
        init_block_index();
        if (resync_mb_x_ == mb_x_ && resync_mb_y_ + 1 == mb_y_) first_slice_line_ = false;
        four_mv_ = false;
        int ret = decode_mb(br);
        if (br.pos() > br.size()) fail("the VOP's data ends");
        update_motion_val();
        reconstruct();
        if (ret == kSliceEnd) {
          if (++mb_x_ >= mb_w_) {
            mb_x_ = 0;
            ++mb_y_;
          }
          return;
        }
      }
      mb_x_ = 0;
    }
  }

  // Where a resync marker follows the macroblock: the first macroblock of the
  // next packet (the VOP's count at the end of its data), else 0.
  int is_resync(BitReader& br) {
    int64_t bits = br.pos();
    uint32_t v = br.peek(16);
    while (v <= 0xFF) {  // macroblock stuffing before the marker
      if ((v >> (8 - pict_type_)) != 1) break;
      br.skip(8 + pict_type_);
      bits += 8 + pict_type_;
      v = br.peek(16);
    }
    if (bits + 8 >= br.size()) {
      v >>= 8;
      v |= 0x7F >> (7 - (bits & 7));
      if (v == 0x7F) return mb_num_;
    } else {
      static const uint16_t kPrefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800, 0x7000, 0x6000, 0x4000, 0x0000};
      if (v == kPrefix[bits & 7]) {
        BitReader g = br;
        g.skip(1);
        g.align();
        int len = 0;
        for (; len < 32; ++len)
          if (g.get1()) break;
        int mb_num = static_cast<int>(g.get(mb_num_bits()));
        if (!mb_num || mb_num > mb_num_ || g.pos() + 6 > g.size()) mb_num = -1;
        if (len >= prefix_length()) return mb_num;
      }
    }
    return 0;
  }

  void resync(BitReader& br) {
    br.skip(1);
    br.align();
    if (br.peek(16) != 0) fail("no resync marker where the video packet ends");
    int len = 0;
    for (; len < 32; ++len)
      if (br.get1()) break;
    if (len != prefix_length()) fail("a resync marker of the wrong length");
    int mb_num = static_cast<int>(br.get(mb_num_bits()));
    if (mb_num != mb_y_ * mb_w_ + mb_x_)
      fail("a video packet that does not start where the last one ended");
    int q = static_cast<int>(br.get(5));
    if (q) qscale_ = q;
    if (br.get1()) {  // header_extension_code: a copy of the VOP header's fields
      while (br.get1()) {
      }
      br.skip(1);                     // marker
      br.skip(time_increment_bits_);  // vop_time_increment
      br.skip(1);                     // marker
      br.skip(2);                     // vop_coding_type
      br.skip(3);                     // intra_dc_vlc_thr
      if (pict_type_ != 1) br.skip(3);  // vop_fcode_forward
    }
  }

  // FFmpeg's ff_mpeg4_clean_buffers: AC prediction zeroed from the block above
  // and left of the packet's first macroblock on, through the same place a row down.
  void clean_buffers() {
    int l_xy = (2 * mb_y_ - 1) * b8_stride_ + 2 * mb_x_ - 1;
    std::fill_n(ac_val() + l_xy * 16, (2 * b8_stride_ + 1) * 16, 0);
    int c_xy = (mb_y_ - 1) * mb_stride_ + mb_x_ - 1;
    int16_t* ac_u = ac_val() + size_t(y_size_ - b8_stride_ - 1 + mb_stride_ + 1) * 16;
    std::fill_n(ac_u + c_xy * 16, (mb_stride_ + 1) * 16, 0);
    std::fill_n(ac_u + (c_xy + c_size_) * 16, (mb_stride_ + 1) * 16, 0);
  }

  // --- macroblock layer ---
  int decode_mb(BitReader& br) {
    int cbpc, cbp, dquant;
    mb_intra_ = false;
    ac_pred_ = false;
    for (auto& m : mv_) m[0] = m[1] = 0;
    for (int& l : block_last_index_) l = -1;
    if (pict_type_ == 2) {
      do {
        if (br.get1()) {  // not coded: the reference copied
          return end_of_mb(br);
        }
        cbpc = inter_mcbpc_vlc().decode(br);
        if (cbpc < 0) fail("an invalid MCBPC code");
      } while (cbpc == 20);
      std::memset(block_, 0, sizeof block_);
      dquant = cbpc & 8;
      mb_intra_ = (cbpc & 4) != 0;
      if (!mb_intra_) {
        int cbpy = cbpy_vlc().decode(br);
        if (cbpy < 0) fail("an invalid CBPY code");
        cbp = (cbpc & 3) | ((cbpy ^ 0xF) << 2);
        if (dquant) set_qscale(qscale_ + kQuantStep[br.get(2)]);
        if (!(cbpc & 16)) {
          int px, py;
          pred_motion(0, &px, &py);
          mv_[0][0] = decode_motion(br, px);
          mv_[0][1] = decode_motion(br, py);
        } else {
          four_mv_ = true;
          for (int i = 0; i < 4; ++i) {
            int px, py;
            int16_t* mot = pred_motion(i, &px, &py);
            mv_[i][0] = decode_motion(br, px);
            mv_[i][1] = decode_motion(br, py);
            mot[0] = static_cast<int16_t>(mv_[i][0]);
            mot[1] = static_cast<int16_t>(mv_[i][1]);
          }
        }
        for (int i = 0; i < 6; ++i) {
          decode_block(br, block_[i], i, cbp & 32, false, false);
          cbp += cbp;
        }
        return end_of_mb(br);
      }
    } else {
      do {
        cbpc = intra_mcbpc_vlc().decode(br);
        if (cbpc < 0) fail("an invalid MCBPC code");
      } while (cbpc == 8);
      std::memset(block_, 0, sizeof block_);
      dquant = cbpc & 4;
      mb_intra_ = true;
    }
    ac_pred_ = br.get1() != 0;
    int cbpy = cbpy_vlc().decode(br);
    if (cbpy < 0) fail("an invalid CBPY code");
    cbp = (cbpc & 3) | (cbpy << 2);
    bool use_intra_dc_vlc = qscale_ < intra_dc_threshold_;
    if (dquant) set_qscale(qscale_ + kQuantStep[br.get(2)]);
    for (int i = 0; i < 6; ++i) {
      decode_block(br, block_[i], i, cbp & 32, true, use_intra_dc_vlc);
      cbp += cbp;
    }
    return end_of_mb(br);
  }

  int end_of_mb(BitReader& br) {
    int next = is_resync(br);
    if (next && mb_x_ + mb_y_ * mb_w_ + 1 >= next) return kSliceEnd;
    return kSliceOk;
  }

  // --- motion vectors ---
  // FFmpeg's ff_h263_pred_motion: the median of left, above and above-right,
  // with the first line of a video packet and its first macroblock special.
  int16_t* pred_motion(int block, int* px, int* py) {
    static const int kOff[4] = {2, 1, 1, -1};
    const int wrap = b8_stride_;
    int16_t* mot = motion_ + 2 * block_index_[block];
    int16_t* A = mot - 2;
    if (first_slice_line_ && block < 3) {
      if (block == 0) {
        if (mb_x_ == resync_mb_x_) {
          *px = *py = 0;
        } else if (mb_x_ + 1 == resync_mb_x_) {
          int16_t* C = mot + 2 * (kOff[block] - wrap);
          if (mb_x_ == 0) {
            *px = C[0];
            *py = C[1];
          } else {
            *px = mid_pred(A[0], 0, C[0]);
            *py = mid_pred(A[1], 0, C[1]);
          }
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else if (block == 1) {
        if (mb_x_ + 1 == resync_mb_x_) {
          int16_t* C = mot + 2 * (kOff[block] - wrap);
          *px = mid_pred(A[0], 0, C[0]);
          *py = mid_pred(A[1], 0, C[1]);
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else {
        int16_t* B = mot - 2 * wrap;
        int16_t* C = mot + 2 * (kOff[block] - wrap);
        if (mb_x_ == resync_mb_x_) A[0] = A[1] = 0;
        *px = mid_pred(A[0], B[0], C[0]);
        *py = mid_pred(A[1], B[1], C[1]);
      }
    } else {
      int16_t* B = mot - 2 * wrap;
      int16_t* C = mot + 2 * (kOff[block] - wrap);
      *px = mid_pred(A[0], B[0], C[0]);
      *py = mid_pred(A[1], B[1], C[1]);
    }
    return mot;
  }

  int decode_motion(BitReader& br, int pred) {
    int code = mv_vlc().decode(br);
    if (code < 0) fail("an invalid motion vector code");
    if (code == 0) return pred;
    int sign = br.get1();
    int shift = f_code_ - 1;
    int val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= static_cast<int>(br.get(shift));
      ++val;
    }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + f_code_;  // wrapped into the range the f_code spans
    return static_cast<int>(static_cast<unsigned>(val) << (32 - bits)) >> (32 - bits);
  }

  void update_motion_val() {
    if (four_mv_) return;  // written while parsing
    int16_t* m = motion_ + 2 * block_index_[0];
    int mx = mb_intra_ ? 0 : mv_[0][0], my = mb_intra_ ? 0 : mv_[0][1];
    for (int16_t* p : {m, m + 2, m + 2 * b8_stride_, m + 2 * b8_stride_ + 2}) {
      p[0] = static_cast<int16_t>(mx);
      p[1] = static_cast<int16_t>(my);
    }
  }

  // --- blocks ---
  int pred_dc(int n, int level, int* dir) {
    int scale = n < 4 ? y_dc_scale_ : c_dc_scale_;
    int w = wrap(n);
    int16_t* dc = dc_val() + block_index_[n];
    int a = dc[-1], b = dc[-1 - w], c = dc[-w];
    if (first_slice_line_ && n != 3) {
      if (n != 2) b = c = 1024;
      if (n != 1 && mb_x_ == resync_mb_x_) b = a = 1024;
    }
    if (mb_x_ == resync_mb_x_ && mb_y_ == resync_mb_y_ + 1) {
      if (n == 0 || n == 4 || n == 5) b = 1024;
    }
    int pred;
    if (std::abs(a - b) < std::abs(b - c)) {
      pred = c;
      *dir = 1;  // from above
    } else {
      pred = a;
      *dir = 0;  // from the left
    }
    pred = (pred + (scale >> 1)) / scale;
    level += pred;
    int ret = level;
    level *= scale;
    if (level & ~2047) level = level < 0 ? 0 : dc_clip_bug_ ? level : 2047;
    dc[0] = static_cast<int16_t>(level);
    return ret;
  }

  static int rounded_div(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

  void pred_ac(int16_t* block, int n, int dir) {
    int16_t* ac = ac_val() + size_t(block_index_[n]) * 16;
    int16_t* own = ac;
    if (ac_pred_) {
      if (dir == 0) {
        int xy = mb_x_ - 1 + mb_y_ * mb_stride_;
        ac -= 16;
        if (mb_x_ == 0 || qscale_ == qscale_table_[xy] || n == 1 || n == 3) {
          for (int i = 1; i < 8; ++i) block[i << 3] = static_cast<int16_t>(block[i << 3] + ac[i]);
        } else {
          for (int i = 1; i < 8; ++i)
            block[i << 3] = static_cast<int16_t>(block[i << 3] + rounded_div(ac[i] * qscale_table_[xy], qscale_));
        }
      } else {
        int xy = mb_x_ + mb_y_ * mb_stride_ - mb_stride_;
        ac -= 16 * wrap(n);
        if (mb_y_ == 0 || qscale_ == qscale_table_[xy] || n == 2 || n == 3) {
          for (int i = 1; i < 8; ++i) block[i] = static_cast<int16_t>(block[i] + ac[i + 8]);
        } else {
          for (int i = 1; i < 8; ++i)
            block[i] = static_cast<int16_t>(block[i] + rounded_div(ac[i + 8] * qscale_table_[xy], qscale_));
        }
      }
    }
    for (int i = 1; i < 8; ++i) own[i] = block[i << 3];
    for (int i = 1; i < 8; ++i) own[8 + i] = block[i];
  }

  void decode_block(BitReader& br, int16_t* block, int n, bool coded, bool intra, bool use_dc_vlc) {
    const RunLevel* rl;
    const uint8_t* scan = kZigzag;
    int i, qmul, qadd, dc_dir = 0;
    if (intra) {
      if (use_dc_vlc) {
        int code = (n < 4 ? dc_lum_vlc() : dc_chrom_vlc()).decode(br);
        if (code < 0 || code > 9) fail("an invalid DC size code");
        int level = 0;
        if (code) {
          level = br.get_xbits(code);
          if (code > 8) br.skip(1);  // marker
        }
        level = pred_dc(n, level, &dc_dir);
        if (level < 0) fail("a negative intra DC");  // FFmpeg takes it for damage too
        block[0] = static_cast<int16_t>(level);
        i = 0;
      } else {
        i = -1;
        pred_dc(n, 0, &dc_dir);  // the direction; the value is set again below
      }
      if (!coded) goto not_coded;
      rl = &intra_rl();
      if (ac_pred_) scan = dc_dir == 0 ? kAltVertical : kAltHorizontal;
      qmul = 1;
      qadd = 0;
    } else {
      i = -1;
      if (!coded) {
        block_last_index_[n] = -1;
        return;
      }
      rl = &inter_rl();
      if (mpeg_quant_) {
        qmul = 1;
        qadd = 0;
      } else {
        qmul = qscale_ << 1;
        qadd = (qscale_ - 1) | 1;
      }
    }
    for (;;) {
      int sym = rl->vlc.decode(br);
      if (sym < 0) fail("an invalid DCT coefficient code");
      int level, run;
      if (sym == RunLevel::kEscape) {
        uint32_t mode = br.peek(2);
        if (mode & 2) {
          if (mode & 1) {  // escape 3: last, run and level written out
            br.skip(2);
            int last = br.get1();
            run = static_cast<int>(br.get(6));
            if (!br.get1()) fail("a missing marker bit in an escaped coefficient");
            level = br.get_signed(12);
            if (!br.get1()) fail("a missing marker bit in an escaped coefficient");
            level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
            if (static_cast<unsigned>(level + 2048) > 4095) level = level < 0 ? -2048 : 2047;
            i += run + 1;
            if (last) i += 192;
          } else {  // escape 2: run + RMAX + 1
            br.skip(2);
            int s = rl->vlc.decode(br);
            if (s < 0 || s == RunLevel::kEscape) fail("an invalid escaped coefficient code");
            run = rl->run_plus[s];
            level = rl->level[s] * qmul + qadd;
            i += run + rl->max_run[run >> 7][rl->level[s]] + 1;
            if (br.get1()) level = -level;
          }
        } else {  // escape 1: level + LMAX
          br.skip(1);
          int s = rl->vlc.decode(br);
          if (s < 0 || s == RunLevel::kEscape) fail("an invalid escaped coefficient code");
          run = rl->run_plus[s];
          level = rl->level[s] * qmul + qadd;
          i += run;
          level += rl->max_level[run >> 7][(run - 1) & 63] * qmul;
          if (br.get1()) level = -level;
        }
      } else {
        run = rl->run_plus[sym];
        level = rl->level[sym] * qmul + qadd;
        i += run;
        if (br.get1()) level = -level;
      }
      if (i > 62) {
        i -= 192;
        if (i & ~63) fail("DCT coefficients past the end of a block");
        block[scan[i]] = static_cast<int16_t>(level);
        break;
      }
      block[scan[i]] = static_cast<int16_t>(level);
    }
  not_coded:
    if (intra) {
      if (!use_dc_vlc) {
        block[0] = static_cast<int16_t>(pred_dc(n, block[0], &dc_dir));
        if (i < 0) i = 0;
      }
      pred_ac(block, n, dc_dir);
      if (ac_pred_) i = 63;
    }
    block_last_index_[n] = i;
  }

  // --- reconstruction ---
  // MPEG inverse quantisation as FFmpeg's x86 SIMD computes it, in 16-bit
  // lanes: |level| times 2 * quantiser * weight keeps its low 16 bits, then
  // an arithmetic shift by 4 (intra) or, with the 2 |level| + 1 of inter
  // blocks, a logical shift by 5; the sign is put back in 16 bits. The same
  // as the standard's arithmetic wherever the product fits in 15 bits.
  static int16_t mpeg_dequantised(int16_t level, int weight, int qscale, bool intra) {
    const uint16_t q = static_cast<uint16_t>(2 * qscale * weight);
    const uint16_t magnitude = static_cast<uint16_t>(level < 0 ? -level : level);
    uint16_t v;
    if (intra) {
      v = static_cast<uint16_t>(static_cast<int16_t>(static_cast<uint16_t>(magnitude * q)) >> 4);
    } else {
      v = static_cast<uint16_t>(static_cast<uint16_t>(static_cast<uint16_t>(2 * magnitude) * q + q) >> 5);
    }
    return static_cast<int16_t>(level < 0 ? static_cast<uint16_t>(-v) : v);
  }

  void dequantise_intra(int16_t* block, int n) {
    int dc_scale = n < 4 ? y_dc_scale_ : c_dc_scale_;
    block[0] = static_cast<int16_t>(block[0] * dc_scale);
    if (mpeg_quant_) {
      for (int i = 1; i <= block_last_index_[n]; ++i) {
        int j = kZigzag[i];
        if (block[j]) block[j] = mpeg_dequantised(block[j], intra_matrix_[j], qscale_, true);
      }
    } else {
      int qmul = qscale_ << 1, qadd = (qscale_ - 1) | 1;
      for (int i = 1; i < 64; ++i) {
        int level = block[i];
        if (level) block[i] = static_cast<int16_t>(level < 0 ? level * qmul - qadd : level * qmul + qadd);
      }
    }
  }

  void dequantise_inter_mpeg(int16_t* block, int n) {
    int sum = -1;
    for (int i = 0; i <= block_last_index_[n]; ++i) {
      int j = kZigzag[i];
      if (!block[j]) continue;
      block[j] = mpeg_dequantised(block[j], inter_matrix_[j], qscale_, false);
      sum += block[j];
    }
    block[63] = static_cast<int16_t>(block[63] ^ (sum & 1));  // mismatch control: make the sum odd
  }

  uint8_t* dest(int n) {
    if (n < 4)
      return cur_[0].data + (16 * mb_y_ + 8 * (n >> 1)) * cur_[0].width + 16 * mb_x_ + 8 * (n & 1);
    const Plane& p = cur_[n - 3];
    return p.data + 8 * mb_y_ * p.width + 8 * mb_x_;
  }

  void reconstruct() {
    int xy = mb_y_ * mb_stride_ + mb_x_;
    qscale_table_[xy] = static_cast<int8_t>(qscale_);
    if (mb_intra_) {
      for (int n = 0; n < 6; ++n) {
        dequantise_intra(block_[n], n);
        idct(block_[n], dest(n), n < 4 ? cur_[0].width : cur_[1].width, false, xvid_idct_);
      }
      return;
    }
    motion_compensate();
    for (int n = 0; n < 6; ++n) {
      if (block_last_index_[n] < 0) continue;
      if (mpeg_quant_) dequantise_inter_mpeg(block_[n], n);
      idct(block_[n], dest(n), n < 4 ? cur_[0].width : cur_[1].width, true, xvid_idct_);
    }
  }

  void motion_compensate() {
    const int ls = cur_[0].width, cs = cur_[1].width;
    if (!four_mv_) {
      int mx = mv_[0][0], my = mv_[0][1];
      int dxy = ((my & 1) << 1) | (mx & 1);
      int src_x = mb_x_ * 16 + (mx >> 1), src_y = mb_y_ * 16 + (my >> 1);
      int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
      // FFmpeg decides by the luma footprint alone whether to emulate edges;
      // where it does not, chroma reads the decoded grid as it lies.
      const bool emulate = static_cast<unsigned>(src_x) >= static_cast<unsigned>(std::max(h_edge_ - (mx & 1) - 15, 0)) ||
                           static_cast<unsigned>(src_y) >= static_cast<unsigned>(std::max(v_edge_ - (my & 1) - 15, 0));
      const int cw = emulate ? h_edge_ >> 1 : cur_[1].width, ch = emulate ? v_edge_ >> 1 : cur_[1].height;
      predict(ref_[0], src_x, src_y, dxy, no_rounding_, 16, 16, dest(0), ls, h_edge_, v_edge_);
      predict(ref_[1], src_x >> 1, src_y >> 1, uvdxy, no_rounding_, 8, 8, dest(4), cs, cw, ch);
      predict(ref_[2], src_x >> 1, src_y >> 1, uvdxy, no_rounding_, 8, 8, dest(5), cs, cw, ch);
      return;
    }
    int sum_x = 0, sum_y = 0;
    for (int i = 0; i < 4; ++i) {
      int mx = mv_[i][0], my = mv_[i][1];
      int src_x = mb_x_ * 16 + (i & 1) * 8 + (mx >> 1), src_y = mb_y_ * 16 + (i >> 1) * 8 + (my >> 1);
      int dxy = 0;
      src_x = std::min(std::max(src_x, -16), width_);
      if (src_x != width_) dxy |= mx & 1;
      src_y = std::min(std::max(src_y, -16), height_);
      if (src_y != height_) dxy |= (my & 1) << 1;
      predict(ref_[0], src_x, src_y, dxy, no_rounding_, 8, 8, dest(i), ls, h_edge_, v_edge_);
      sum_x += mx;
      sum_y += my;
    }
    int mx = round_chroma(sum_x), my = round_chroma(sum_y);
    int dxy = ((my & 1) << 1) | (mx & 1);
    mx >>= 1;
    my >>= 1;
    int src_x = std::min(std::max(mb_x_ * 8 + mx, -8), width_ >> 1);
    if (src_x == (width_ >> 1)) dxy &= ~1;
    int src_y = std::min(std::max(mb_y_ * 8 + my, -8), height_ >> 1);
    if (src_y == (height_ >> 1)) dxy &= ~2;
    predict(ref_[1], src_x, src_y, dxy, no_rounding_, 8, 8, dest(4), cs, h_edge_ >> 1, v_edge_ >> 1);
    predict(ref_[2], src_x, src_y, dxy, no_rounding_, 8, 8, dest(5), cs, h_edge_ >> 1, v_edge_ >> 1);
  }
};

void copy_message(const char* msg, char* err, int err_len) {
  if (err && err_len > 0) {
    std::strncpy(err, msg, err_len - 1);
    err[err_len - 1] = '\0';
  }
}

}  // namespace

extern "C" {

int sr_mpeg4_decode_vop(const uint8_t* data, int64_t size, int64_t bit_pos, const int32_t* params,
                        const int32_t* matrices, const uint8_t* ref, uint8_t* out, char* err, int err_len) {
  try {
    if (params[0] <= 0 || params[1] <= 0 || params[3] < 1 || params[3] > 31 || (params[2] && (params[4] < 1 ||
                                                                                              params[4] > 7)))
      throw Error("invalid VOP parameters");
    BitReader br(data, size, bit_pos);
    VopDecoder(params, matrices, ref, out).decode(br);
    return 0;
  } catch (const std::exception& e) {
    copy_message(e.what(), err, err_len);
    return -1;
  }
}

void sr_mpeg4_idct(int16_t* block, int xvid) {
  if (xvid) {
    xvid_idct(block);
  } else {
    simple_idct(block);
  }
}

// YUV 4:2:0 -> BGR24 as cv2.VideoCapture converts it (swscale_bgr.h) of the planes on
// the macroblock grid.
void sr_mpeg4_yuv420_to_bgr(const uint8_t* planes, int mb_w, int mb_h, int width, int height, uint8_t* bgr) {
  const int ls = 16 * mb_w, cs = 8 * mb_w;
  const uint8_t* up = planes + ls * 16 * mb_h;
  sr_yuv::Yuv420ToBgr(planes, up, up + cs * 8 * mb_h, ls, cs, width, height, bgr, /*left=*/true);
}

}  // extern "C"
