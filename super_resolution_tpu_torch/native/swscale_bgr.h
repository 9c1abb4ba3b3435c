// Planar 8-bit YUV (BT.601, limited range; the unscaled path also with the
// other matrices and the full range H.264 signals) -> BGR24 as cv2.VideoCapture
// converts every frame FFmpeg decodes: swscale at SWS_BICUBIC, same size,
// with the frame's chroma siting, and the routines swscale picks on x86-64
// (SSSE3 and up). Shared by the MPEG-4
// Part 2, VP8, VP9, FFV1 and H.264 video decoders.
//
// swscale takes one of two paths:
//
// - Unscaled (4:2:0, YUVA 4:2:0 and 4:2:2 at an even height): the SSSE3 converter, in
//   16-bit fixed point: (v << 3) - offset, times a coefficient scaled by 2^13,
//   keeping the high 16 bits; each chroma sample serves its 2 (x 2) luma
//   samples.
// - Scaled (every other size and subsampling): the chroma planes are
//   filtered up (or, for 4:4:0's width, down) by bicubic filters with
//   B = 0, C = 0.6 whose taps initFilter() makes in 64-bit fixed point,
//   horizontally to 15-bit intermediates, then vertically, and written out:
//   * as pixel pairs that share one chroma (the packed writer) when the width
//     is even and the chroma is subsampled: rows 0 .. h-3 by the MMXEXT
//     routines (the vertical filter as a sum of pmulhw products, the
//     conversion as above, 16-bit adds, unsigned saturation), the last two
//     rows by the C routines (32-bit sums, then the 8-bit lookup tables of
//     ff_yuv2rgb_c_init_tables). swscale switches to C for the last two rows
//     because its MMX vertical filter would overrun its line array.
//   * at full chroma resolution (SWS_FULL_CHR_H_INT, which swscale forces for
//     an odd width and for 4:4:4) by the C routines alone, in 22-bit fixed point.
//
// Which routine runs depends on the CPU: on x86-64 every CPU with SSSE3 gives
// these frames; FFmpeg's plain C build (another architecture, or
// av_force_cpu_flags(0)) differs in the unscaled converter and in rows
// 0 .. h-3 of the packed writer.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace sr_yuv {

constexpr int kUnsited = -513;  // swscale's default chroma siting: centred between the luma samples

inline uint8_t ClipPixel(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

namespace detail {

// BT.601 limited range (SWS_CS_DEFAULT): ff_yuv2rgb_coeffs {crv, cbu, cgu, cgv}.
constexpr int64_t kCrv = 104597, kCbu = 132201, kCgu = -25675, kCgv = -53279;
constexpr int64_t kCy = (int64_t{1} << 16) * 255 / 219, kOy = int64_t{16} << 16;
// The 16-bit coefficients (scaled by 2^13) of the SIMD routines and of the full-chroma C writer.
constexpr int kY = 9539, kVR = 13075, kUB = 16525, kUG = -3209, kVG = -6660;
constexpr int kYOffset8 = 128;      // 16 << 3
constexpr int kUVOffset8 = 1024;    // 128 << 3
constexpr int kYOffset9 = 16 << 9;  // the full-chroma writer's luma offset
constexpr int kVRounder = 4;        // where the MMX vertical filter's sums start (c->vRounder)

inline int16_t W16(int v) { return static_cast<int16_t>(v); }                     // 16-bit wrap (paddw, psubw)
inline int Pmulhw(int a, int b) { return (int{W16(a)} * int{W16(b)}) >> 16; }      // signed high half
inline uint8_t Packus(int v) { return ClipPixel(W16(v)); }                         // packuswb of a word

}  // namespace detail

// The SIMD converter's coefficients: ff_yuv2rgb_c_init_tables' yCoeff, vrCoeff, ubCoeff, ugCoeff, vgCoeff and
// yOffset.
struct Coefficients {
  int y, vr, ub, ug, vg, y_offset;
};

namespace detail {

constexpr Coefficients kBt601Limited{kY, kVR, kUB, kUG, kVG, kYOffset8};

// The MMXEXT / SSSE3 conversion of one pixel from its luma and chroma in << 3 scale.
inline void Simd(int y8, int u8, int v8, uint8_t* o, const Coefficients& k = kBt601Limited) {
  const int yy = Pmulhw(y8 - k.y_offset, k.y), u = W16(u8 - kUVOffset8), v = W16(v8 - kUVOffset8);
  o[0] = Packus(yy + Pmulhw(u, k.ub));
  o[1] = Packus(yy + W16(Pmulhw(u, k.ug) + Pmulhw(v, k.vg)));
  o[2] = Packus(yy + Pmulhw(v, k.vr));
}

// ff_yuv2rgb_c_init_tables for a 24-bit output: one luma table, indexed through per-chroma offsets.
struct Tables {
  uint8_t y[2048];
  int64_t crv, cbu, cgu, cgv;
  static constexpr int kYOffs = 326 + 512;
  Tables() {
    // Scaled by cy, with C's truncating division as swscale's.
    crv = ((kCrv << 16) + 0x8000) / kCy;
    cbu = ((kCbu << 16) + 0x8000) / kCy;
    cgu = (kCgu * 65536 + 0x8000) / kCy;
    cgv = (kCgv * 65536 + 0x8000) / kCy;
    int64_t yb = -(int64_t{384} << 16) - 512 * kCy - kOy;
    for (int i = 0; i < 2048; ++i, yb += kCy) y[i] = ClipPixel(static_cast<int>((yb + 0x8000) >> 16));
  }
  static int64_t Off(int c, int64_t inc) { return -(inc >> 9) + ((ClipPixel(c) * inc) >> 16); }
  // The C packed writer's pixel from 8-bit Y, U, V (U and V clipped by the table's own clamp).
  void Pixel(int y8, int u, int v, uint8_t* o) const {
    const int64_t base = kYOffs + y8;
    o[0] = y[base + Off(u, cbu)];
    o[1] = y[base + Off(u, cgu) + Off(v, cgv)];
    o[2] = y[base + Off(v, crv)];
  }
};

inline const Tables& CTables() {
  static const Tables tables;
  return tables;
}

// yuv2rgb_write_full for BGR24: Y, U, V in << 9 scale (U, V centred on 0).
inline void Full(int Y, int U, int V, uint8_t* o) {
  Y = (Y - kYOffset9) * kY + (1 << 21);
  int R = static_cast<int>(static_cast<unsigned>(Y) + static_cast<unsigned>(V) * static_cast<unsigned>(kVR));
  int G = static_cast<int>(static_cast<unsigned>(Y) + static_cast<unsigned>(V) * static_cast<unsigned>(kVG) +
                           static_cast<unsigned>(U) * static_cast<unsigned>(kUG));
  int B = static_cast<int>(static_cast<unsigned>(Y) + static_cast<unsigned>(U) * static_cast<unsigned>(kUB));
  if ((R | G | B) & 0xC0000000) {
    auto clip30 = [](int v) { return v < 0 ? 0 : v > (1 << 30) - 1 ? (1 << 30) - 1 : v; };
    R = clip30(R), G = clip30(G), B = clip30(B);
  }
  o[0] = static_cast<uint8_t>(B >> 22);
  o[1] = static_cast<uint8_t>(G >> 22);
  o[2] = static_cast<uint8_t>(R >> 22);
}

// A filter as initFilter() leaves it: `size` taps a destination sample, starting at source sample pos[i].
struct Filter {
  int size = 0;
  std::vector<int> pos;
  std::vector<int> coef;  // size per destination sample, summing to `one`
};

// initFilter() of libswscale/utils.c for SWS_BICUBIC (B = 0, C = 0.6) without source or destination
// vectors, on an x86 CPU (MMX): `align` is 4 for horizontal filters and 2 for vertical ones, where a
// filter that reduces to one tap keeps one.
inline Filter InitFilter(int64_t inc, int src, int dst, int align, int one, int src_pos, int dst_pos) {
  const int log2 = [](int v) { int r = 0; while (v >>= 1) ++r; return r; }(src / dst);
  const int64_t fone = int64_t{1} << (54 - (log2 < 8 ? log2 : 8));
  int size;
  std::vector<int64_t> f;
  std::vector<int> pos(dst);
  if (std::llabs(inc - 0x10000) < 10 && src_pos == dst_pos) {
    size = 1;
    f.assign(dst, fone);
    for (int i = 0; i < dst; ++i) pos[i] = i;
  } else {
    size = inc <= (1 << 16) ? 1 + 4 : 1 + (4 * src + dst - 1) / dst;
    if (size > src - 2) size = src - 2;
    if (size < 1) size = 1;
    f.assign(static_cast<size_t>(dst) * size, 0);
    int64_t x_dst_in_src = ((dst_pos * inc) >> 7) - ((src_pos * int64_t{0x10000}) >> 7);
    const int64_t B = 0, C = static_cast<int64_t>(0.6 * (1 << 24));
    for (int i = 0; i < dst; ++i) {
      int xx = static_cast<int>((x_dst_in_src - (size - 2) * (int64_t{1} << 16)) / (1 << 17));
      pos[i] = xx;
      for (int j = 0; j < size; ++j, ++xx) {
        int64_t d = std::llabs(int64_t{xx} * (1 << 17) - x_dst_in_src) << 13;
        if (inc > 1 << 16) d = d * dst / src;
        int64_t coeff;
        if (d >= int64_t{1} << 31) {
          coeff = 0;
        } else {
          const int64_t dd = (d * d) >> 30, ddd = (dd * d) >> 30;
          if (d < int64_t{1} << 30)
            coeff = (12 * (int64_t{1} << 24) - 9 * B - 6 * C) * ddd + (-18 * (int64_t{1} << 24) + 12 * B + 6 * C) * dd +
                    (6 * (int64_t{1} << 24) - 2 * B) * (int64_t{1} << 30);
          else
            coeff = (-B - 6 * C) * ddd + (6 * B + 30 * C) * dd + (-12 * B - 48 * C) * d + (8 * B + 24 * C) * (int64_t{1} << 30);
        }
        coeff /= (int64_t{1} << 54) / fone;
        f[static_cast<size_t>(i) * size + j] = coeff;
      }
      x_dst_in_src += 2 * inc;
    }
  }
  // Reduce: drop near-zero taps on the left (shifting), count them on the right.
  const int64_t cutoff_limit = static_cast<int64_t>(0.002 * static_cast<double>(fone));
  int min_size = 0;
  for (int i = dst - 1; i >= 0; --i) {
    int64_t* row = &f[static_cast<size_t>(i) * size];
    int min = size;
    int64_t cut = 0;
    for (int j = 0; j < size; ++j) {
      cut += std::llabs(row[0]);
      if (cut > cutoff_limit) break;
      if (i < dst - 1 && pos[i] >= pos[i + 1]) break;
      for (int k = 1; k < size; ++k) row[k - 1] = row[k];
      row[size - 1] = 0;
      ++pos[i];
    }
    cut = 0;
    for (int j = size - 1; j > 0; --j) {
      cut += std::llabs(row[j]);
      if (cut > cutoff_limit) break;
      --min;
    }
    if (min > min_size) min_size = min;
  }
  if (min_size == 1 && align == 2) align = 1;
  const int out_size = (min_size + align - 1) & ~(align - 1);
  std::vector<int64_t> g(static_cast<size_t>(dst) * out_size, 0);
  for (int i = 0; i < dst; ++i)
    for (int j = 0; j < out_size && j < size; ++j) g[static_cast<size_t>(i) * out_size + j] = f[static_cast<size_t>(i) * size + j];
  // Fix the borders: no tap reads before sample 0 or past the last.
  for (int i = 0; i < dst; ++i) {
    int64_t* row = &g[static_cast<size_t>(i) * out_size];
    if (pos[i] < 0) {
      for (int j = 1; j < out_size; ++j) {
        const int left = j + pos[i] > 0 ? j + pos[i] : 0;
        row[left] += row[j];
        row[j] = 0;
      }
      pos[i] = 0;
    }
    if (pos[i] + out_size > src) {
      const int shift = pos[i] + (out_size - src < 0 ? out_size - src : 0);
      int64_t acc = 0;
      for (int j = out_size - 1; j >= 0; --j)
        if (pos[i] + j >= src) acc += row[j], row[j] = 0;
      for (int j = out_size - 1; j >= 0; --j) row[j] = j < shift ? 0 : row[j - shift];
      pos[i] -= shift;
      row[src - 1 - pos[i]] += acc;
    }
  }
  // Normalise to `one`, carrying each tap's rounding error into the next.
  Filter out;
  out.size = out_size;
  out.pos = pos;
  out.coef.assign(static_cast<size_t>(dst) * out_size, 0);
  for (int i = 0; i < dst; ++i) {
    const int64_t* row = &g[static_cast<size_t>(i) * out_size];
    int64_t sum = 0, error = 0;
    for (int j = 0; j < out_size; ++j) sum += row[j];
    sum = (sum + one / 2) / one;
    if (!sum) sum = 1;
    for (int j = 0; j < out_size; ++j) {
      const int64_t v = row[j] + error;
      const int64_t q = v >= 0 ? (v + sum / 2) / sum : (v - sum / 2) / sum;  // ROUNDED_DIV
      out.coef[static_cast<size_t>(i) * out_size + j] = static_cast<int>(q);
      error = v - q * sum;
    }
  }
  return out;
}

inline int CeilShift(int v, int s) { return -((-v) >> s); }

// get_local_pos(): a chroma siting relative to the chroma sample grid of subsampling 2^shift.
inline int LocalPos(int shift, int pos) {
  if (pos == -1 || pos <= -513) pos = (128 << shift) - 128;
  return (pos + 128) >> shift;
}

// The unscaled SSSE3 converter (4:2:0 with vshift 1, 4:2:2 with vshift 0).
inline void Unscaled(const uint8_t* yp, const uint8_t* up, const uint8_t* vp, int y_stride, int uv_stride, int width,
                     int height, int vshift, uint8_t* bgr, const Coefficients& k = kBt601Limited) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* yr = yp + static_cast<size_t>(y) * y_stride;
    const uint8_t* ur = up + static_cast<size_t>(y >> vshift) * uv_stride;
    const uint8_t* vr = vp + static_cast<size_t>(y >> vshift) * uv_stride;
    uint8_t* o = bgr + static_cast<size_t>(y) * width * 3;
    for (int x = 0; x < width; ++x) Simd(yr[x] << 3, ur[x >> 1] << 3, vr[x >> 1] << 3, o + 3 * x, k);
  }
}

}  // namespace detail

// The top-left width x height of planar 8-bit YUV whose chroma planes are subsampled by 2^sx across
// and 2^sy down (rows y_stride / uv_stride bytes apart) into bgr, height x width x 3 bytes.
// (sx, sy) is (1, 1) for 4:2:0, (1, 0) 4:2:2, (0, 0) 4:4:4, (2, 2) 4:1:0, (2, 0) 4:1:1, (0, 1) 4:4:0.
// `alpha` says the frame has a transparency plane (which the BGR drops): swscale's unscaled converter
// takes YUVA 4:2:0 but not YUVA 4:2:2. h_chr_pos / v_chr_pos are the chroma samples' siting in 1/256 of
// a luma sample, as swscale's src_h_chr_pos / src_v_chr_pos take it, which cv2.VideoCapture sets from the
// frame's chroma location: kUnsited (centred) for VP8, VP9 and FFV1, 0 / 128 (left) for MPEG-4 Part 2.
inline void YuvToBgr(const uint8_t* yp, const uint8_t* up, const uint8_t* vp, int y_stride, int uv_stride, int width,
                     int height, int sx, int sy, uint8_t* bgr, bool alpha = false, int h_chr_pos = kUnsited,
                     int v_chr_pos = kUnsited) {
  using namespace detail;
  if (sx == 1 && (sy == 1 || (sy == 0 && !alpha)) && height % 2 == 0) {
    Unscaled(yp, up, vp, y_stride, uv_stride, width, height, sy, bgr);
    return;
  }
  const bool full = (width & 1) || (sx == 0 && sy == 0);  // SWS_FULL_CHR_H_INT forced
  const int src_cw = CeilShift(width, sx), src_ch = CeilShift(height, sy);
  const int dst_cw = full ? width : CeilShift(width, 1), dst_ch = height;
  const int64_t x_inc = ((int64_t{src_cw} << 16) + (dst_cw >> 1)) / dst_cw;
  const int64_t y_inc = ((int64_t{src_ch} << 16) + (dst_ch >> 1)) / dst_ch;
  const Filter h = InitFilter(x_inc, src_cw, dst_cw, 4, 1 << 14, LocalPos(sx, h_chr_pos), LocalPos(full ? 0 : 1, kUnsited));
  const Filter v = InitFilter(y_inc, src_ch, dst_ch, 2, 1 << 12, LocalPos(sy, v_chr_pos), LocalPos(0, kUnsited));
  // The horizontal pass: each chroma row to 15-bit intermediates.
  std::vector<int16_t> hu(static_cast<size_t>(src_ch) * dst_cw), hv(hu.size());
  for (int r = 0; r < src_ch; ++r) {
    const uint8_t* ur = up + static_cast<size_t>(r) * uv_stride;
    const uint8_t* vr = vp + static_cast<size_t>(r) * uv_stride;
    for (int i = 0; i < dst_cw; ++i) {
      int su = 0, sv = 0;
      for (int j = 0; j < h.size; ++j) {
        const int c = h.coef[static_cast<size_t>(i) * h.size + j], s = h.pos[i] + j;
        if (c) su += ur[s] * c, sv += vr[s] * c;
      }
      su >>= 7, sv >>= 7;
      hu[static_cast<size_t>(r) * dst_cw + i] = static_cast<int16_t>(su < 32767 ? su : 32767);
      hv[static_cast<size_t>(r) * dst_cw + i] = static_cast<int16_t>(sv < 32767 ? sv : 32767);
    }
  }
  const Tables& tables = CTables();
  std::vector<int> acc_u(dst_cw), acc_v(dst_cw);
  for (int y = 0; y < height; ++y) {
    const uint8_t* yr = yp + static_cast<size_t>(y) * y_stride;
    uint8_t* o = bgr + static_cast<size_t>(y) * width * 3;
    const int* vc = &v.coef[static_cast<size_t>(y) * v.size];
    const int16_t* u0 = &hu[static_cast<size_t>(v.pos[y]) * dst_cw];
    const int16_t* v0 = &hv[static_cast<size_t>(v.pos[y]) * dst_cw];
    const bool simd = !full && y < height - 2;
    const bool one_tap = v.size == 1;
    const bool two_tap = v.size == 2 && vc[0] + vc[1] == 4096 && static_cast<unsigned>(vc[1]) <= 4096u;
    if (full) {
      for (int x = 0; x < width; ++x) {
        int U, V;
        if (one_tap) {
          U = (u0[x] - (128 << 7)) * 4, V = (v0[x] - (128 << 7)) * 4;
        } else if (two_tap) {
          const int a = vc[1], a1 = 4096 - a;
          U = (u0[x] * a1 + u0[x + dst_cw] * a - (128 << 19)) >> 10;
          V = (v0[x] * a1 + v0[x + dst_cw] * a - (128 << 19)) >> 10;
        } else {
          U = V = (1 << 9) - (128 << 19);
          for (int j = 0; j < v.size; ++j)
            U += u0[static_cast<size_t>(j) * dst_cw + x] * vc[j], V += v0[static_cast<size_t>(j) * dst_cw + x] * vc[j];
          U >>= 10, V >>= 10;
        }
        Full((yr[x] << 7) * 4, U, V, o + 3 * x);
      }
      continue;
    }
    for (int i = 0; i < dst_cw; ++i) {
      const int x = 2 * i;
      if (simd) {
        int us, vs;
        if (one_tap || (two_tap && vc[1] < 2048)) {
          us = u0[i] >> 4, vs = v0[i] >> 4;
        } else if (two_tap) {
          us = static_cast<uint16_t>(W16(u0[i] + u0[i + dst_cw])) >> 5;
          vs = static_cast<uint16_t>(W16(v0[i] + v0[i + dst_cw])) >> 5;
        } else {
          us = vs = kVRounder;
          for (int j = 0; j < v.size; ++j) {
            us = W16(us + Pmulhw(u0[static_cast<size_t>(j) * dst_cw + i], vc[j]));
            vs = W16(vs + Pmulhw(v0[static_cast<size_t>(j) * dst_cw + i], vc[j]));
          }
        }
        // The luma is unscaled: (y << 7) >> 4 in the one- and two-tap routines, the rounder plus
        // pmulhw(y << 7, 4096) in the general one.
        const int round = one_tap || two_tap ? 0 : kVRounder;
        Simd((yr[x] << 3) + round, us, vs, o + 3 * x);
        if (x + 1 < width) Simd((yr[x + 1] << 3) + round, us, vs, o + 3 * x + 3);
      } else {
        int U, V;
        if (one_tap) {
          U = (u0[i] + 64) >> 7, V = (v0[i] + 64) >> 7;
        } else if (two_tap) {
          const int a = vc[1], a1 = 4096 - a;
          U = (u0[i] * a1 + u0[i + dst_cw] * a + (128 << 11)) >> 19;
          V = (v0[i] * a1 + v0[i + dst_cw] * a + (128 << 11)) >> 19;
        } else {
          U = V = 1 << 18;
          for (int j = 0; j < v.size; ++j)
            U += u0[static_cast<size_t>(j) * dst_cw + i] * vc[j], V += v0[static_cast<size_t>(j) * dst_cw + i] * vc[j];
          U >>= 19, V >>= 19;
          if ((U | V) & 0x100) U = ClipPixel(U), V = ClipPixel(V);
        }
        tables.Pixel(yr[x], U, V, o + 3 * x);
        if (x + 1 < width) tables.Pixel(yr[x + 1], U, V, o + 3 * x + 3);
      }
    }
  }
}

// swscale's table of a colour matrix (sws_getCoefficients: crv, cbu, -cgu, -cgv) for the matrix_coefficients
// values cv2.VideoCapture's conversion follows: BT.709 (1), the BT.601 ones and unspecified (2, 5, 6: swscale's
// default), FCC (4), SMPTE 240M (7); null for the others (BT.2020's frames are not swscale's BT.2020 conversion).
inline const int* MatrixTable(int matrix) {
  static const int kBt601[4] = {104597, 132201, 25675, 53279}, kBt709[4] = {117489, 138438, 13975, 34925};
  static const int kFcc[4] = {104448, 132798, 24759, 53109}, kSmpte240[4] = {117579, 136230, 16907, 35559};
  switch (matrix) {
    case 1: return kBt709;
    case 2: case 5: case 6: return kBt601;
    case 4: return kFcc;
    case 7: return kSmpte240;
    default: return nullptr;
  }
}

// The SIMD converter's coefficients for a matrix's table at limited or full range, at swscale's default
// brightness, contrast and saturation (ff_yuv2rgb_c_init_tables); BT.601 at limited range gives detail's
// constants.
inline Coefficients SimdCoefficients(const int table[4], bool full_range) {
  auto round16 = [](int64_t f) {  // roundToInt16
    const int64_t r = (f + (1 << 15)) >> 16;
    return static_cast<int>(r < -0x7FFF ? -0x8000 : r > 0x7FFF ? 0x7FFF : r);
  };
  int64_t crv = table[0], cbu = table[1], cgu = -table[2], cgv = -table[3], cy = 1 << 16, oy = 0;
  if (!full_range) {
    cy = (cy * 255) / 219;
    oy = int64_t{16} << 16;
  } else {
    crv = (crv * 224) / 255, cbu = (cbu * 224) / 255, cgu = (cgu * 224) / 255, cgv = (cgv * 224) / 255;
  }
  return {round16(cy * (1 << 13)), round16(crv * (1 << 13)), round16(cbu * (1 << 13)), round16(cgu * (1 << 13)),
          round16(cgv * (1 << 13)), round16(oy * (1 << 3))};
}

// 4:2:0 of an even height through the unscaled converter with coefficients `k` (H.264's colour description).
inline void Yuv420ToBgrUnscaled(const uint8_t* yp, const uint8_t* up, const uint8_t* vp, int y_stride, int uv_stride,
                                int width, int height, const Coefficients& k, uint8_t* bgr) {
  detail::Unscaled(yp, up, vp, y_stride, uv_stride, width, height, 1, bgr, k);
}

// 4:2:0 of the VP8 and VP9 decoders (chroma centred) and of the MPEG-4 one (`left`: sited left).
inline void Yuv420ToBgr(const uint8_t* yp, const uint8_t* up, const uint8_t* vp, int y_stride, int uv_stride,
                        int width, int height, uint8_t* bgr, bool left = false) {
  YuvToBgr(yp, up, vp, y_stride, uv_stride, width, height, 1, 1, bgr, false, left ? 0 : kUnsited, left ? 128 : kUnsited);
}

}  // namespace sr_yuv
