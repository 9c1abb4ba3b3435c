// FFmpeg's "simple" integer IDCT and its half-pel motion compensation, as its
// x86-64 build computes them (the build cv2.VideoCapture runs): shared by the
// MPEG-4 Part 2 decoder (mpeg4_decoder.cpp) and the MPEG-1 / MPEG-2 decoder
// (mpeg2_decoder.cpp), whose FFmpeg decoders reconstruct with the same
// routines (mpegvideo's IDCTDSPContext and HpelDSPContext).

#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace sr_idct {

inline uint8_t clip_pixel(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// FFmpeg's "simple" integer IDCT, 8-bit, as its x86 SIMD build computes it
// (the one cv2.VideoCapture runs; the same as its C code on what encoders
// write): rows with a DC-only shortcut (DC << 3, wrapped to 16 bits) or
// 32-bit sums shifted by 11 and saturated to 16 bits; columns with the
// rounding term added to the DC as 32 in 16-bit arithmetic (W4 * 32 stands in
// for 2^19), 32-bit sums shifted by 20, saturated.
constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;
constexpr int kRowShift = 11, kColShift = 20;

inline int16_t saturate16(int v) { return static_cast<int16_t>(v < -32768 ? -32768 : v > 32767 ? 32767 : v); }

// The eight outputs of a 1-D pass over v[0], v[stride], ..., v[7 * stride];
// a0 starts at W4 * v[0] + bias.
inline void idct_1d(const int16_t* v, int stride, unsigned bias, int shift, int* out) {
  const int x0 = v[0], x1 = v[stride], x2 = v[2 * stride], x3 = v[3 * stride], x4 = v[4 * stride],
            x5 = v[5 * stride], x6 = v[6 * stride], x7 = v[7 * stride];
  unsigned a0 = W4 * x0 + bias;  // unsigned: sums wrap at 32 bits as the SIMD lanes do
  unsigned a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * x2 + W4 * x4 + W6 * x6;
  a1 += W6 * x2 - W4 * x4 - W2 * x6;
  a2 += -W6 * x2 - W4 * x4 + W2 * x6;
  a3 += -W2 * x2 + W4 * x4 - W6 * x6;
  unsigned b0 = W1 * x1 + W3 * x3 + W5 * x5 + W7 * x7;
  unsigned b1 = W3 * x1 - W7 * x3 - W1 * x5 - W5 * x7;
  unsigned b2 = W5 * x1 - W1 * x3 + W7 * x5 + W3 * x7;
  unsigned b3 = W7 * x1 - W5 * x3 + W3 * x5 - W1 * x7;
  const unsigned sums[8] = {a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0};
  for (int i = 0; i < 8; ++i) out[i] = static_cast<int>(sums[i]) >> shift;
}

inline void simple_idct(int16_t* block) {
  int out[8];
  for (int r = 0; r < 8; ++r) {
    int16_t* row = block + 8 * r;
    if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
      int16_t dc = static_cast<int16_t>(static_cast<uint16_t>(row[0]) << 3);
      for (int i = 0; i < 8; ++i) row[i] = dc;
      continue;
    }
    idct_1d(row, 1, 1u << (kRowShift - 1), kRowShift, out);
    for (int i = 0; i < 8; ++i) row[i] = saturate16(out[i]);
  }
  for (int x = 0; x < 8; ++x) {
    int16_t col[64];
    for (int y = 0; y < 8; ++y) col[8 * y] = block[8 * y + x];
    col[0] = static_cast<int16_t>(col[0] + (1 << (kColShift - 1)) / W4);
    idct_1d(col, 8, 0, kColShift, out);
    for (int y = 0; y < 8; ++y) block[8 * y + x] = saturate16(out[y]);
  }
}

struct Plane {
  uint8_t* data;
  int width, height;  // the macroblock grid
  int stride = 0;     // bytes from one row to the next; 0: width (a field of a frame: twice its width)
};

// A w x h half-pel prediction from ref at (x, y) with dxy (bit 0 = half right,
// bit 1 = half down), reading outside the edge_w x edge_h corner of the plane
// from its nearest edge pixel (FFmpeg's edge emulation).
// Rounding averages are (a + b + 1) >> 1 and (a + b + c + d + 2) >> 2; without
// rounding (a + b) >> 1 and (a + b + c + d + 1) >> 2, except FFmpeg's x86
// two-tap averages 8 pixels wide: the rounding average with one tap lowered by
// 1 first, saturating at 0 (the left one; of two rows, the odd-numbered one),
// which differs from (a + b) >> 1 where that tap is 0.
inline void predict(const Plane& ref, int x, int y, int dxy, bool no_rounding, int w, int h, uint8_t* dst,
                    int dst_stride, int edge_w, int edge_h) {
  uint8_t src[17 * 17];
  const int stride = ref.stride ? ref.stride : ref.width;
  edge_w = std::min(edge_w, ref.width);
  edge_h = std::min(edge_h, ref.height);
  for (int j = 0; j <= h; ++j) {
    int yy = std::min(std::max(y + j, 0), edge_h - 1);
    for (int i = 0; i <= w; ++i) {
      int xx = std::min(std::max(x + i, 0), edge_w - 1);
      src[j * 17 + i] = ref.data[static_cast<size_t>(yy) * stride + xx];
    }
  }
  const bool approximate = no_rounding && w == 8;
  const int r = no_rounding ? 0 : 1;
  auto lowered = [](int v) { return v ? v - 1 : v; };
  for (int j = 0; j < h; ++j) {
    const uint8_t* s = src + j * 17;
    for (int i = 0; i < w; ++i) {
      int v;
      switch (dxy) {
        case 0: v = s[i]; break;
        case 1: v = approximate ? (lowered(s[i]) + s[i + 1] + 1) >> 1 : (s[i] + s[i + 1] + r) >> 1; break;
        case 2:
          v = !approximate ? (s[i] + s[i + 17] + r) >> 1
              : j & 1      ? (lowered(s[i]) + s[i + 17] + 1) >> 1
                           : (s[i] + lowered(s[i + 17]) + 1) >> 1;
          break;
        default: v = (s[i] + s[i + 1] + s[i + 17] + s[i + 18] + 1 + r) >> 2; break;
      }
      dst[j * dst_stride + i] = static_cast<uint8_t>(v);
    }
  }
}

// The IDCT output of `block` written to (add = false) or added to (add = true) the 8x8 pixels at dst, clipped:
// FFmpeg's idct_put / idct_add, whose 16-bit saturating adds clip as this does.
inline void write_block(const int16_t* block, uint8_t* dst, int stride, bool add) {
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) {
      uint8_t& p = dst[y * stride + x];
      p = clip_pixel(add ? p + block[8 * y + x] : block[8 * y + x]);
    }
}

// FFmpeg's avg_pixels after a put: each of the w x h pixels at dst the rounded average of itself and the one at
// pred (pavgb), as bi-directional prediction averages its backward prediction into the forward one.
inline void average(uint8_t* dst, int dst_stride, const uint8_t* pred, int pred_stride, int w, int h) {
  for (int j = 0; j < h; ++j)
    for (int i = 0; i < w; ++i) {
      uint8_t& p = dst[j * dst_stride + i];
      p = static_cast<uint8_t>((p + pred[j * pred_stride + i] + 1) >> 1);
    }
}

}  // namespace sr_idct
