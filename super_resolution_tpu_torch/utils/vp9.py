"""VP9 video (profile 0: 8-bit 4:2:0) decoded as ``cv2.VideoCapture``
decodes it: what ``cv2.VideoWriter`` writes with the ``VP90`` fourcc into
WebM, Matroska, IVF, AVI and MP4, and what libvpx writes with the tools
OpenCV leaves off.

:class:`Vp9Decoder` takes the stream one container payload at a time and
returns the frames it shows as uint8 ``HxWx3`` BGR arrays: none for a
payload that holds only a hidden frame, one or more for a superframe (a
hidden frame and a shown one) or a ``show_existing_frame``. The frames are
decoded in C++ (``native/vp9_decoder.cpp``, built at first use by
:mod:`super_resolution_tpu_torch.native`; no compiler: ``RuntimeError``), as
FFmpeg's VP9 decoder decodes them, and converted with swscale's BT.601
limited-range YUV 4:2:0 to BGR24 arithmetic, as ``cv2.VideoCapture``
converts them.

Covered: key, inter and intra-only frames; the eight reference slots with
their sign bias; superframes, hidden frames and ``show_existing_frame``; the
four saved probability contexts with their resets, forward updates and
backward adaptation; tile columns and rows; partitions down to 4x4;
segmentation (tree and temporally predicted maps, a map carried from an
earlier frame, the quantiser, loop-filter, reference and skip features);
every transform size with ``TX_MODE_SELECT``, the DCT / ADST pairs and the
lossless Walsh-Hadamard transform; the ten intra modes; ZERO / NEAREST / NEAR
/ NEW vectors, high precision, sub-8x8 blocks; the regular, smooth, sharp and
bilinear filters, switchable; compound prediction, fixed and selected per
block; the loop filter with its levels by segment, reference and mode and its
sharpness; odd frame sizes. Raise ``NotImplementedError`` naming the feature:
profiles 1-3, ``color_space`` RGB, ``color_range`` 1, a reference of another
size than the frame (scaled prediction) and a frame size that changes
mid-stream. Corrupt data (a truncated frame, a bad marker, an inter frame
before the first key frame) raises ``ValueError``.
"""

from __future__ import annotations

import ctypes

import numpy as np

__all__ = ["STATS", "Vp9Decoder"]

_INTRA_MODES = ("DC_PRED", "V_PRED", "H_PRED", "D45_PRED", "D135_PRED", "D117_PRED", "D153_PRED", "D207_PRED",
                "D63_PRED", "TM_PRED")
# The counts native/vp9_decoder.cpp keeps over a stream (its Stat order): frames by kind, mode symbols decoded
# (each sub-8x8 sub-block's own), blocks by reference, compound use, filter and transform size, partition
# decisions (forced ones included), slot refreshes, and frames by the header features they use.
STATS = ("frames", "key_frames", "inter_frames", "intra_only_frames", "hidden_frames", "shown_again", "superframes",
         *_INTRA_MODES, "NEARESTMV", "NEARMV", "ZEROMV", "NEWMV",
         "intra_blocks", "last_blocks", "golden_blocks", "altref_blocks", "compound_blocks", "sub8x8_blocks",
         "skip_blocks", "intra_blocks_in_inter_frames",
         "filter_regular", "filter_smooth", "filter_sharp", "filter_bilinear",
         "tx_4x4", "tx_8x8", "tx_16x16", "tx_32x32",
         "partition_none", "partition_horz", "partition_vert", "partition_split",
         *(f"refresh_slot_{i}" for i in range(8)),
         "sign_bias_frames", "compound_fixed_frames", "compound_select_frames", "switchable_filter_frames",
         "high_precision_frames", "tile_col_frames", "tile_row_frames", "segmented_frames", "segment_map_updates",
         "segment_temporal_updates", "segment_data_updates", "segment_alt_q", "segment_alt_lf", "segment_ref",
         "segment_skip", "lossless_frames", "error_resilient_frames", "adapted_frames", "parallel_frames",
         "context_not_refreshed", "reset_context_2", "reset_context_3", "context_0", "context_1", "context_2",
         "context_3", "tx_select_frames", "lf_delta_updates", "sharp_frames", "lf_zero_frames", "odd_size_frames",
         "far_mv_blocks")


class Vp9Decoder:
    """Decoder state across one VP9 stream: its reference slots and probability contexts, held natively."""

    def __init__(self):
        from super_resolution_tpu_torch.native import get_vp9_library

        self._lib = get_vp9_library()
        self._handle = self._lib.sr_vp9_stream_new()

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.sr_vp9_stream_free(handle)

    def decode(self, payload: bytes) -> list[np.ndarray]:
        """The frames one payload shows (uint8 ``HxWx3`` BGR): none, one, or more for a superframe."""
        if not payload:
            return []
        err = ctypes.create_string_buffer(256)
        shown = self._lib.sr_vp9_stream_decode(self._handle, payload, len(payload), err, len(err))
        if shown == -2:
            raise NotImplementedError(f"VP9 stream with {err.value.decode()} is not supported by the port's video "
                                      "reader.")
        if shown < 0:
            raise ValueError(f"Corrupt VP9 frame: {err.value.decode()}.")
        width, height = self.size
        frames = []
        for index in range(shown):
            bgr = np.empty((height, width, 3), np.uint8)
            self._lib.sr_vp9_stream_bgr(self._handle, index, bgr.ctypes.data)
            frames.append(bgr)
        return frames

    def planes(self, index: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The Y, U and V planes of shown frame ``index`` of the last payload."""
        width, height = self.size
        out = []
        for plane, (w, h) in enumerate([(width, height)] + [((width + 1) // 2, (height + 1) // 2)] * 2):
            out.append(np.empty((h, w), np.uint8))
            self._lib.sr_vp9_stream_plane(self._handle, index, plane, out[-1].ctypes.data)
        return tuple(out)

    @property
    def size(self) -> tuple[int, int]:
        """(width, height) of the stream's frames (0, 0 before its first key frame)."""
        wh = np.zeros(2, np.int32)
        self._lib.sr_vp9_stream_size(self._handle, wh.ctypes.data)
        return int(wh[0]), int(wh[1])

    @property
    def stats(self) -> dict[str, int]:
        """Counts over the frames decoded so far (:data:`STATS`)."""
        out = np.zeros(len(STATS), np.int64)
        count = self._lib.sr_vp9_stream_stats(self._handle, out.ctypes.data, len(STATS))
        if count != len(STATS):
            raise RuntimeError(f"native/vp9_decoder.cpp keeps {count} counts, utils/vp9.py names {len(STATS)}.")
        return dict(zip(STATS, out.tolist()))
