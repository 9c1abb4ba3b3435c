"""FFV1 video (RFC 9043; versions 0-3 at 8 bits a sample) decoded as
``cv2.VideoCapture`` decodes it: what ``cv2.VideoWriter`` writes with the
``FFV1`` fourcc into Matroska, AVI, MP4 and QuickTime, and what FFmpeg's
``ffv1`` encoder writes with any of its options.

:class:`Ffv1Decoder` takes the stream's configuration record (the
container's ``CodecPrivate`` / extradata, empty for versions 0 and 1) and
its frame size, which FFV1 leaves to the container, then one frame a
payload, and returns it as a uint8 ``HxWx3`` BGR array. The frames are
decoded in C++ (``native/ffv1_decoder.cpp``, built at first use by
:mod:`super_resolution_tpu_torch.native`; no compiler: ``RuntimeError``), as
FFmpeg's FFV1 decoder decodes them, and converted to BGR as
``cv2.VideoCapture`` converts them: RGB reordered, grey copied to each
channel, YCbCr through swscale's arithmetic (``native/swscale_bgr.h``).

Covered: the range coder with the default or a custom state-transition
table, Golomb-Rice coding with run mode; small and large context models;
the version 2+ configuration record (quantisation table sets, initial
states, error correction) and its CRC; one slice (versions 0 / 1) or a grid
of slices (versions 2 / 3) with their footers and CRCs; contexts kept
between frames and reset on key frames; grey, grey with alpha, YCbCr 4:4:4,
4:4:0, 4:2:2, 4:2:0, 4:1:1 and 4:1:0 (4:4:4, 4:2:2 and 4:2:0 also with
alpha), and RGB with or without alpha. Raise ``NotImplementedError`` naming
the feature: more than 8 bits a sample, version 4, another colourspace or a
layout FFmpeg's decoder refuses. A slice whose CRC fails raises
``ValueError`` naming the slice (FFmpeg conceals it from the previous frame);
other corrupt data raises ``ValueError`` too.
"""

from __future__ import annotations

import ctypes

import numpy as np

__all__ = ["STATS", "Ffv1Decoder"]

# The counts native/ffv1_decoder.cpp keeps over a stream (its Stat order): frames, slices, frames by version,
# coder, context model and layout, slices whose CRC was checked, Golomb-Rice runs.
STATS = ("frames", "key_frames", "non_key_frames", "slices", "version_0", "version_1", "version_2", "version_3",
         "coder_golomb", "coder_range_default", "coder_range_custom", "crc_slices", "runs", "large_context_frames",
         "initial_state_frames", "grey", "grey_alpha", "yuv444", "yuv440", "yuv422", "yuv420", "yuv411", "yuv410",
         "yuv_alpha", "rgb", "rgb_alpha", "multi_slice_frames")


def _raise(code: int, message: str):
    if code == -2:
        raise NotImplementedError(f"FFV1 stream with {message} is not supported by the port's video reader "
                                  "(versions 0-3 at 8 bits a sample are).")
    raise ValueError(f"Corrupt FFV1 stream: {message}.")


class Ffv1Decoder:
    """Decoder state across one FFV1 stream: its parameters and its slices' contexts, held natively."""

    def __init__(self, config: bytes, width: int, height: int):
        from super_resolution_tpu_torch.native import get_ffv1_library

        self._lib = get_ffv1_library()
        self._size = (int(width), int(height))
        err = ctypes.create_string_buffer(256)
        self._handle = self._lib.sr_ffv1_stream_new(config, len(config), width, height, err, len(err))
        if not self._handle:
            code, _, message = err.value.decode().partition(":")
            _raise(-int(code), message)

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.sr_ffv1_stream_free(handle)

    def decode(self, payload: bytes) -> list[np.ndarray]:
        """The frame one payload holds (uint8 ``HxWx3`` BGR), as a list of one; none for an empty payload."""
        if not payload:
            return []
        err = ctypes.create_string_buffer(256)
        code = self._lib.sr_ffv1_stream_decode(self._handle, payload, len(payload), err, len(err))
        if code < 0:
            _raise(code, err.value.decode())
        width, height = self._size
        bgr = np.empty((height, width, 3), np.uint8)
        self._lib.sr_ffv1_stream_bgr(self._handle, bgr.ctypes.data)
        return [bgr]

    def planes(self) -> list[np.ndarray]:
        """The decoded planes of the last frame: Y, then U and V where the stream has chroma, then A where it has
        alpha (YCbCr and grey); G, B, R, then A (RGB). Each ``h x w`` at its own subsampled size."""
        out, shape = [], np.zeros(2, np.int32)
        for plane in range(4):
            if not self._lib.sr_ffv1_stream_plane(self._handle, plane, None, shape.ctypes.data):
                continue
            out.append(np.empty((shape[1], shape[0]), np.uint8))
            self._lib.sr_ffv1_stream_plane(self._handle, plane, out[-1].ctypes.data, shape.ctypes.data)
        return out

    @property
    def size(self) -> tuple[int, int]:
        """(width, height) of the stream's frames, as the container gave them."""
        return self._size

    @property
    def stats(self) -> dict[str, int]:
        """Counts over the frames decoded so far (:data:`STATS`)."""
        out = np.zeros(len(STATS), np.int64)
        count = self._lib.sr_ffv1_stream_stats(self._handle, out.ctypes.data, len(STATS))
        if count != len(STATS):
            raise RuntimeError(f"native/ffv1_decoder.cpp keeps {count} counts, utils/ffv1.py names {len(STATS)}.")
        return dict(zip(STATS, out.tolist()))
