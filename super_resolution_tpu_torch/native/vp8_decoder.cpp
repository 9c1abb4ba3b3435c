// VP8 video (RFC 6386) for super_resolution_tpu_torch.utils.vp8, bound with
// ctypes: a stateful decoder behind a handle, fed one frame (a container
// payload) a call, as cv2.VideoCapture's FFmpeg decodes it.
//
// vp8_core.h decodes each frame on FFmpeg's rules; this file keeps the
// stream: the three reference frames (last, golden, altref), each a
// filtered picture on the macroblock grid, updated after every frame in
// libvpx's order -- copy_buffer_to_golden / copy_buffer_to_alternate read the
// buffers as they stood before the frame, then the refreshes take the new
// one --, hidden frames (show_frame = 0) decoded and kept as references but
// not output, and the conversion of a shown frame to BGR24 with swscale's
// arithmetic (swscale_bgr.h), as cv2.VideoCapture converts them at any size.
//
// C interface:
//   void* sr_vp8_stream_new()              a decoder; sr_vp8_stream_free(h) ends it
//   int sr_vp8_stream_decode(void* h, const uint8_t* data, int64_t size, char* err, int err_len)
//     1: a frame to show, 0: a hidden frame, -1: corrupt data, -2: a
//     feature the decoder refuses (the message in err names it)
//   void sr_vp8_stream_size(void* h, int32_t* width_height)
//   void sr_vp8_stream_bgr(void* h, uint8_t* out)    the last frame, height x width x 3
//   int sr_vp8_stream_stats(void* h, int64_t* out, int n)
//     the first n of vp8_core.h's Stat counts; returns how many there are
//
// Build: g++ -O3 -shared -fPIC -std=c++17 vp8_decoder.cpp -o <lib>.so
// (native/__init__.py does this at first use, into
// super_resolution_tpu_torch/_build/).

#include <cstdint>
#include <cstring>
#include <exception>

#include "vp8_core.h"
#include "swscale_bgr.h"

namespace {

class StreamDecoder {
 public:
  int Decode(const uint8_t* data, size_t size) {
    int cur = 0;
    while (cur == refs_[0] || cur == refs_[1] || cur == refs_[2]) ++cur;
    const sr_vp8::Picture* refs[3] = {nullptr, nullptr, nullptr};
    for (int i = 0; i < 3; ++i) {
      if (refs_[i] >= 0) refs[i] = &buffers_[refs_[i]];
    }
    const sr_vp8::FrameHeader hdr = frames_.Decode(data, size, buffers_[cur], refs);
    const int last = refs_[0], golden = refs_[1], altref = refs_[2];
    if (hdr.key) {
      refs_[0] = refs_[1] = refs_[2] = cur;
    } else {
      refs_[1] = hdr.refresh_golden ? cur : hdr.copy_to_golden == 1 ? last : hdr.copy_to_golden == 2 ? altref : golden;
      refs_[2] = hdr.refresh_altref ? cur : hdr.copy_to_altref == 1 ? last : hdr.copy_to_altref == 2 ? golden : altref;
      if (hdr.refresh_last) refs_[0] = cur;
    }
    decoded_ = cur;
    return hdr.show ? 1 : 0;
  }
  int width() const { return frames_.width(); }
  int height() const { return frames_.height(); }
  const sr_vp8::Picture& decoded() const { return buffers_[decoded_]; }
  const int64_t* stats() const { return frames_.stats(); }

 private:
  sr_vp8::FrameDecoder frames_{sr_vp8::kFfmpeg};
  sr_vp8::Picture buffers_[4];  // the three references and the frame being decoded
  int refs_[3] = {-1, -1, -1};  // last, golden, altref
  int decoded_ = 0;
};

void CopyMessage(const char* msg, char* err, int err_len) {
  if (err && err_len > 0) {
    std::strncpy(err, msg, err_len - 1);
    err[err_len - 1] = '\0';
  }
}

}  // namespace

extern "C" {

void* sr_vp8_stream_new() { return new StreamDecoder(); }

void sr_vp8_stream_free(void* handle) { delete static_cast<StreamDecoder*>(handle); }

int sr_vp8_stream_decode(void* handle, const uint8_t* data, int64_t size, char* err, int err_len) {
  try {
    return static_cast<StreamDecoder*>(handle)->Decode(data, static_cast<size_t>(size));
  } catch (const sr_vp8::Unsupported& e) {
    CopyMessage(e.what(), err, err_len);
    return -2;
  } catch (const std::exception& e) {
    CopyMessage(e.what(), err, err_len);
    return -1;
  }
}

void sr_vp8_stream_size(void* handle, int32_t* width_height) {
  const auto* dec = static_cast<const StreamDecoder*>(handle);
  width_height[0] = dec->width();
  width_height[1] = dec->height();
}

void sr_vp8_stream_bgr(void* handle, uint8_t* out) {
  const auto* dec = static_cast<const StreamDecoder*>(handle);
  const sr_vp8::Picture& pic = dec->decoded();
  sr_yuv::Yuv420ToBgr(pic.y.data(), pic.u.data(), pic.v.data(), pic.y_stride(), pic.uv_stride(), dec->width(),
                      dec->height(), out);
}

int sr_vp8_stream_stats(void* handle, int64_t* out, int n) {
  const int64_t* stats = static_cast<const StreamDecoder*>(handle)->stats();
  for (int i = 0; i < n && i < sr_vp8::kNumStats; ++i) out[i] = stats[i];
  return sr_vp8::kNumStats;
}

}  // extern "C"
