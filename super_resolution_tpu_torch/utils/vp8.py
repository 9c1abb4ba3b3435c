"""VP8 video (RFC 6386) decoded as ``cv2.VideoCapture`` decodes it: what
``cv2.VideoWriter`` writes with the ``VP80`` fourcc into WebM, Matroska,
AVI and IVF.

:class:`Vp8Decoder` takes the stream one container payload (one frame) at a
time and returns the frames it shows as uint8 ``HxWx3`` BGR arrays. The
frames are decoded in C++ (``native/vp8_decoder.cpp`` over
``native/vp8_core.h``, the frame decoder the lossy WebP reader shares; built
at first use by :mod:`super_resolution_tpu_torch.native`; no compiler:
``RuntimeError``), as FFmpeg's VP8 decoder decodes them, and converted with
swscale's BT.601 limited-range YUV 4:2:0 to BGR24 arithmetic, as
``cv2.VideoCapture`` converts them.

Covered: key and inter frames of versions 0-3 (six-tap or bilinear motion
compensation, full-pixel chroma in version 3), the golden and altref
references with their refreshes, copies and sign bias, hidden frames
(decoded, kept as references, not returned), intra macroblocks in inter
frames, every inter mode with SPLITMV in its four partitionings, vectors
far outside the picture, segmentation with a map that is updated or kept,
``refresh_entropy_probs = 0``, 1-8 token partitions, the simple and normal
loop filters with their deltas, coefficients so large that the transforms'
16-bit intermediates wrap (as in FFmpeg's x86 code). Raise
``NotImplementedError`` naming the feature: a frame size that changes
mid-stream, versions above 3, frame scaling (``horizontal_scale`` /
``vertical_scale``), colour space 1 and ``clamping_type`` 1 (after which
FFmpeg marks frames full-range). Corrupt data (a truncated frame, an inter
frame before the first key frame) raises ``ValueError``.
"""

from __future__ import annotations

import ctypes

import numpy as np

__all__ = ["STATS", "Vp8Decoder"]

_MODES = ("DC_PRED", "TM_PRED", "V_PRED", "H_PRED", "B_PRED", "ZEROMV", "NEARESTMV", "NEARMV", "NEWMV", "SPLITMV")
# The counts native/vp8_core.h keeps over a stream (its Stat order).
STATS = ("frames", "key_frames", "hidden_frames", *_MODES,
         "intra_mbs", "last_mbs", "golden_mbs", "altref_mbs",
         "split_16x8", "split_8x16", "split_8x8", "split_4x4",
         "version_0", "version_1", "version_2", "version_3",
         "golden_refreshes", "altref_refreshes", "golden_from_last", "golden_from_altref", "altref_from_last",
         "altref_from_golden", "segmented_frames", "segment_map_updates", "segment_maps_kept",
         "segment_data_updates", "entropy_not_refreshed", "sign_bias_golden", "sign_bias_altref",
         "partitions_1", "partitions_2", "partitions_4", "partitions_8", "lf_delta_updates",
         "simple_filter_frames", "normal_filter_frames", "mbs_far_outside", "mbs_large_coefficients")


class Vp8Decoder:
    """Decoder state across one VP8 stream: its references and probabilities, held by the native decoder."""

    def __init__(self):
        from super_resolution_tpu_torch.native import get_vp8_library

        self._lib = get_vp8_library()
        self._handle = self._lib.sr_vp8_stream_new()

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.sr_vp8_stream_free(handle)

    def decode(self, payload: bytes) -> list[np.ndarray]:
        """The frame of one payload (uint8 ``HxWx3`` BGR), or none for a hidden frame or an empty payload."""
        if not payload:
            return []
        err = ctypes.create_string_buffer(256)
        status = self._lib.sr_vp8_stream_decode(self._handle, payload, len(payload), err, len(err))
        if status == -2:
            raise NotImplementedError(f"VP8 stream with {err.value.decode()} is not supported by the port's video "
                                      "reader.")
        if status < 0:
            raise ValueError(f"Corrupt VP8 frame: {err.value.decode()}.")
        if status == 0:
            return []
        width, height = self.size
        bgr = np.empty((height, width, 3), np.uint8)
        self._lib.sr_vp8_stream_bgr(self._handle, bgr.ctypes.data)
        return [bgr]

    @property
    def size(self) -> tuple[int, int]:
        """(width, height) of the stream's frames (0, 0 before its first key frame)."""
        wh = np.zeros(2, np.int32)
        self._lib.sr_vp8_stream_size(self._handle, wh.ctypes.data)
        return int(wh[0]), int(wh[1])

    @property
    def stats(self) -> dict[str, int]:
        """Counts over the frames decoded so far (:data:`STATS`): frames, macroblocks by mode, by reference and
        by SPLITMV partitioning, and the frame-header features met."""
        out = np.zeros(len(STATS), np.int64)
        count = self._lib.sr_vp8_stream_stats(self._handle, out.ctypes.data, len(STATS))
        if count != len(STATS):
            raise RuntimeError(f"native/vp8_core.h keeps {count} counts, utils/vp8.py names {len(STATS)}.")
        return dict(zip(STATS, out.tolist()))
