"""H.264 video (progressive 8-bit 4:2:0, I, P and B slices, CAVLC or CABAC)
decoded as ``cv2.VideoCapture`` decodes it: what Constrained Baseline and
x264's ``--profile baseline`` write, Main and High profile with B slices --
x264's defaults: B-pyramid, spatial direct, implicit weighted bi-prediction,
CABAC, the 8x8 transform --, from MP4 (``avc1`` / ``avc3``, with the
composition offsets of ``ctts``), Matroska (``V_MPEG4/ISO/AVC``), AVI
(``H264`` and its other fourccs) and raw Annex B streams (``.h264``).

:class:`H264Decoder` takes the stream one whole access unit (or several) a
call and returns the frames it outputs as uint8 ``HxWx3`` BGR arrays;
:meth:`H264Decoder.flush` returns those still held back at the end of the
stream and :meth:`H264Decoder.units` says which call carried each. The
frames are decoded in C++ (``native/h264_decoder.cpp``, built at first use by
:mod:`super_resolution_tpu_torch.native`; no compiler: ``RuntimeError``),
reconstructed as the standard specifies them -- and so as FFmpeg decodes them --,
cropped, and converted with swscale's YUV 4:2:0 to BGR24 arithmetic for the
VUI's colour matrix and range (BT.601 limited range where the stream names
none), as ``cv2.VideoCapture`` converts them.

Covered: Annex B and length-prefixed NAL units (an ``avcC`` record's
``lengthSizeMinusOne`` 0, 1 or 3); any ``profile_idc`` whose stream stays
within these tools; the VUI; frame cropping at the right, top and bottom;
picture order count types 0, 1 and 2; several slices a picture in raster
order; CAVLC and CABAC (each ``cabac_init_idc``, I_PCM within it); every I,
P and B macroblock type with every sub-partition, I_PCM and skips; spatial
and temporal direct prediction under either ``direct_8x8_inference_flag``;
default, implicit and explicit bi-prediction; reference B pictures; the 8x8
transform (``transform_8x8_mode_flag``) with intra 8x8 prediction; scaling
matrices in the SPS and the PPS (fall-back rules A and B, the default
lists); ``second_chroma_qp_index_offset``; intra 4x4 / 8x8 / 16x16 / chroma
prediction under slices and ``constrained_intra_pred``; reference lists of
up to 16 frames with modification of both lists; explicit weighted
prediction; the sliding window and MMCO 1-6 with long-term references; the
deblocking filter with ``disable_deblocking_filter_idc`` 0, 1 and 2 and its
offsets, as FFmpeg applies it (its bS of 2 on every edge of an inter
macroblock with the 8x8 transform and 8x8 blocks 0-2 coded, where the two
chroma offsets are equal). Frames come out in the order and number FFmpeg's
``h264_select_output_frame`` gives them: where the SPS's VUI carries
``bitstream_restriction_flag``, held back by ``max_num_reorder_frames`` and
output lowest picture order count first (up to a key frame or an MMCO 5
picture), the rest at the end of the stream; without it, in decoding order,
which is FFmpeg's order wherever its picture order count (which, unlike the
standard's, goes on across an MMCO 5) increases. Where a 4x4 scaling list's
first weight is above 28 (the lists x264 and the standard's defaults send
keep it at 6-16), FFmpeg's x86 DC dequantisation of Intra 16x16 macroblocks
can round apart from the standard, which this decoder follows: such frames
can differ from cv2's by a grey level. Weighted bi-prediction follows
FFmpeg's x86 code where a block's row holds 4 samples or more: a weight of
128 halves both weights, the offset and the shift, and the weighted samples
add in signed 16 bits with saturation.

Raise ``NotImplementedError`` naming the feature, under CAVLC and under
CABAC: SP / SI slices, interlaced coding (``frame_mbs_only_flag`` 0),
another chroma format than 4:2:0, more than 8 bits, lossless bypass, slice
groups, arbitrary slice order, redundant pictures, data partitioning, gaps in
``frame_num``, a size that changes mid-stream, a left crop (cv2.VideoCapture
rescales such frames), a colour matrix other than BT.601, BT.709, FCC and
SMPTE 240M, ``no_output_of_prior_pics_flag``, a stream that starts without an
IDR picture and a picture order count that does not increase in a stream
whose SPS lacks the VUI's ``bitstream_restriction_flag`` (FFmpeg then grows
its delay as it goes, and what it outputs depends on its thread count).
Corrupt data (a truncated slice, a P slice before the first IDR, a reference
index past the list) raises ``ValueError``.
"""

from __future__ import annotations

import ctypes

import numpy as np

__all__ = ["STATS", "H264Decoder"]

_I4X4_MODES = ("vertical", "horizontal", "dc", "diagonal_down_left", "diagonal_down_right", "vertical_right",
               "horizontal_down", "vertical_left", "horizontal_up")
# The counts native/h264_decoder.cpp keeps over a stream (its Stat order): pictures and slices by kind,
# macroblocks by type, sub-macroblock partitions, intra modes, skip runs and motion, the slice-header tools
# (weights, list modifications, memory management operations, long-term references, the sliding window,
# deblocking), POC types, level escapes, QP wraps and cropped pictures; then CABAC's slices by cabac_init_idc,
# its I_PCM macroblocks and the levels and vector differences that reach their Exp-Golomb suffixes, intra 8x8
# macroblocks, inter ones with the 8x8 transform, intra 8x8 modes, and the parameter sets' tools (scaling
# matrices in SPSs and PPSs, their lists read, default or by fall-back rule A or B, second chroma QP offsets
# unlike the first, transform_8x8_mode_flag), counted as the parameter sets are read; then B slices, macroblocks by B
# type (B_16x16: B_L0 / B_L1 / B_Bi_16x16), sub-macroblock partitions of B_8x8 (direct, 8x8, 8x4, 4x8, 4x4), intra
# macroblocks in B slices, macroblocks predicted in spatial and in temporal direct mode (B_Skip, B_Direct_16x16, and
# B_8x8 with a direct sub-macroblock), bi-predicted partitions other than direct ones, B slices with implicit and with
# explicit weights, list 1 modifications, reference B pictures and pictures output after a picture decoded later.
STATS = ("pictures", "idr_pictures", "non_ref_pictures", "slices", "i_slices", "p_slices", "multi_slice_pictures",
         "I_NxN", "I_16x16", "I_PCM", "P_L0_16x16", "P_L0_L0_16x8", "P_L0_L0_8x16", "P_8x8", "P_8x8ref0", "P_Skip",
         "intra_mbs_in_p_slices", "sub_8x8", "sub_8x4", "sub_4x8", "sub_4x4",
         *(f"i4x4_{m}" for m in _I4X4_MODES), "i16x16_vertical", "i16x16_horizontal", "i16x16_dc", "i16x16_plane",
         "chroma_dc", "chroma_horizontal", "chroma_vertical", "chroma_plane",
         "skip_runs", "skip_mv_nonzero", "ref_idx_nonzero", "far_mv_partitions",
         "weighted_slices", "list_modifications", *(f"mmco_{i}" for i in range(1, 7)), "long_term_refs",
         "sliding_window_removals", "deblock_idc_0", "deblock_idc_1", "deblock_idc_2", "deblock_offsets",
         "constrained_intra_slices", "poc_type_0", "poc_type_1", "poc_type_2", "level_prefix_14",
         "level_prefix_15", "qp_wraps", "cropped_pictures",
         "cabac_slices", "cabac_init_idc_0", "cabac_init_idc_1", "cabac_init_idc_2", "cabac_pcm",
         "cabac_level_escapes", "cabac_mvd_escapes", "I_8x8", "transform_8x8_inter",
         *(f"i8x8_{m}" for m in _I4X4_MODES),
         "sps_scaling_matrices", "pps_scaling_matrices", "scaling_lists_explicit", "scaling_lists_default",
         "scaling_lists_fallback_a", "scaling_lists_fallback_b", "second_chroma_qp_offsets", "transform_8x8_pps",
         "b_slices", "B_Skip", "B_Direct_16x16", "B_16x16", "B_16x8", "B_8x16", "B_8x8", "b_sub_direct", "b_sub_8x8",
         "b_sub_8x4", "b_sub_4x8", "b_sub_4x4", "intra_mbs_in_b_slices", "spatial_direct_mbs", "temporal_direct_mbs",
         "bi_partitions", "implicit_bipred_slices", "explicit_bipred_slices", "list1_modifications",
         "reference_b_pictures", "reordered_pictures")


class H264Decoder:
    """Decoder state across one H.264 stream: parameter sets, decoded
    reference pictures and their marking, held natively. ``config`` is an
    ``avcC`` record (MP4, Matroska): its parameter sets are read and the
    payloads are length-prefixed; empty means Annex B."""

    def __init__(self, config: bytes = b""):
        from super_resolution_tpu_torch.native import get_h264_library

        self._lib = get_h264_library()
        self._units: list[int] = []
        err = ctypes.create_string_buffer(256)
        self._handle = self._lib.sr_h264_stream_new(config, len(config), err, len(err))
        if not self._handle:
            message = err.value.decode()
            if message.startswith("!"):
                raise NotImplementedError(f"H.264 stream with {message[1:]} is not supported by the port's video "
                                          "reader.")
            raise ValueError(f"Corrupt H.264 configuration: {message}.")

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.sr_h264_stream_free(handle)

    def decode(self, payload: bytes) -> list[np.ndarray]:
        """The frames output after the whole access units of ``payload`` (uint8 ``HxWx3`` BGR); an empty payload
        counts as a call that carries no picture."""
        err = ctypes.create_string_buffer(256)
        count = self._lib.sr_h264_stream_decode(self._handle, payload, len(payload), err, len(err))
        if count == -2:
            raise NotImplementedError(f"H.264 stream with {err.value.decode()} is not supported by the port's video "
                                      "reader.")
        if count < 0:
            raise ValueError(f"Corrupt H.264 stream: {err.value.decode()}.")
        return self._frames(count)

    def flush(self) -> list[np.ndarray]:
        """The frames still held back for reordering at the end of the stream, in their output order."""
        err = ctypes.create_string_buffer(256)
        count = self._lib.sr_h264_stream_flush(self._handle, err, len(err))
        if count < 0:
            raise ValueError(f"Corrupt H.264 stream: {err.value.decode()}.")
        return self._frames(count)

    def units(self) -> list[int]:
        """For each frame the last :meth:`decode` or :meth:`flush` returned, which :meth:`decode` call (0, 1, ...)
        carried its picture."""
        return list(self._units)

    def _frames(self, count: int) -> list[np.ndarray]:
        width, height = self.size
        frames = []
        for index in range(count):
            bgr = np.empty((height, width, 3), np.uint8)
            self._lib.sr_h264_stream_bgr(self._handle, index, bgr.ctypes.data)
            frames.append(bgr)
        self._units = [self._lib.sr_h264_stream_unit(self._handle, index) for index in range(count)]
        return frames

    def planes(self, index: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The cropped Y, U and V planes of output frame ``index`` of the last :meth:`decode` or :meth:`flush`."""
        width, height = self.size
        out = []
        for plane, (w, h) in enumerate([(width, height)] + [(width // 2, height // 2)] * 2):
            out.append(np.empty((h, w), np.uint8))
            self._lib.sr_h264_stream_plane(self._handle, index, plane, out[-1].ctypes.data)
        return tuple(out)

    @property
    def size(self) -> tuple[int, int]:
        """(width, height) of the stream's cropped frames (0, 0 before its first picture)."""
        wh = np.zeros(2, np.int32)
        self._lib.sr_h264_stream_size(self._handle, wh.ctypes.data)
        return int(wh[0]), int(wh[1])

    @property
    def stats(self) -> dict[str, int]:
        """Counts over the pictures decoded so far (:data:`STATS`)."""
        out = np.zeros(len(STATS), np.int64)
        count = self._lib.sr_h264_stream_stats(self._handle, out.ctypes.data, len(STATS))
        if count != len(STATS):
            raise RuntimeError(f"native/h264_decoder.cpp keeps {count} counts, utils/h264.py names {len(STATS)}.")
        return dict(zip(STATS, out.tolist()))
