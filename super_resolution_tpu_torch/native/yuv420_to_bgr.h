// swscale's unscaled YUV 4:2:0 -> BGR24 (BT.601, limited range), as
// cv2.VideoCapture converts every 4:2:0 frame FFmpeg decodes: in the 16-bit
// fixed point of swscale's x86 converter, (v << 3) - offset, times a
// coefficient scaled by 2^13, keeping the high 16 bits; each chroma sample
// serves its 2x2 luma samples. Shared by the MPEG-4 Part 2
// (mpeg4_decoder.cpp) and VP8 (vp8_decoder.cpp) video decoders.

#pragma once

#include <cstddef>
#include <cstdint>

namespace sr_yuv {

inline uint8_t ClipPixel(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// The top-left width x height of the planes (rows y_stride / uv_stride
// bytes apart) into bgr, height x width x 3 bytes.
inline void Yuv420ToBgr(const uint8_t* yp, const uint8_t* up, const uint8_t* vp, int y_stride, int uv_stride,
                        int width, int height, uint8_t* bgr) {
  constexpr int kY = 9539, kVR = 13075, kUB = 16525, kUG = -3209, kVG = -6660;
  for (int y = 0; y < height; ++y) {
    const uint8_t* yr = yp + static_cast<size_t>(y) * y_stride;
    const uint8_t* ur = up + static_cast<size_t>(y >> 1) * uv_stride;
    const uint8_t* vr = vp + static_cast<size_t>(y >> 1) * uv_stride;
    uint8_t* o = bgr + static_cast<size_t>(y) * width * 3;
    for (int x = 0; x < width; ++x) {
      const int yy = (((yr[x] << 3) - 128) * kY) >> 16;
      const int u = (ur[x >> 1] << 3) - 1024, v = (vr[x >> 1] << 3) - 1024;
      o[3 * x] = ClipPixel(yy + ((u * kUB) >> 16));
      o[3 * x + 1] = ClipPixel(yy + ((u * kUG) >> 16) + ((v * kVG) >> 16));
      o[3 * x + 2] = ClipPixel(yy + ((v * kVR) >> 16));
    }
  }
}

}  // namespace sr_yuv
