"""MPEG-1 and MPEG-2 video decoded as ``cv2.VideoCapture`` decodes it: what
``cv2.VideoWriter`` writes with ``mpg2`` / ``PIM1`` and FFmpeg's
``mpeg2video`` / ``mpeg1video`` encoders write -- I, P and B pictures,
progressive and interlaced frame pictures (field DCT, field prediction),
4:2:0 at 8 bits --, from MPEG program and transport streams, raw elementary
streams (``.m1v`` / ``.m2v``), Matroska (``V_MPEG1`` / ``V_MPEG2``), MP4 /
QuickTime (``mp4v`` with an MPEG-1 / MPEG-2 object type, ``m2v1``, ``mp2v``)
and AVI (``mpg2``, ``PIM1`` and their other fourccs).

:class:`Mpeg2Decoder` takes the stream a payload a call (a container's
sample, or the whole elementary stream) and returns the frames it outputs as
uint8 ``HxWx3`` BGR arrays; :meth:`Mpeg2Decoder.flush` returns the reference
picture still held back at the end of the stream and :meth:`Mpeg2Decoder.units`
says which call carried each frame. The frames are decoded in C++
(``native/mpeg2_decoder.cpp``, built at first use by
:mod:`super_resolution_tpu_torch.native`; no compiler: ``RuntimeError``) as
FFmpeg's x86-64 build decodes them -- its inverse quantisation, mismatch
control and MPEG-1 oddification, its simple IDCT, its half-pel and
bi-directional averages --, cropped, and converted with swscale's YUV 4:2:0 to
BGR24 arithmetic for the sequence display extension's colour matrix (BT.601
where the stream names none), as ``cv2.VideoCapture`` converts them. Frames
come out in FFmpeg's order: a B picture at once, an I or P picture when the
next I or P picture is decoded (at once under ``low_delay``), the last one at
the end. ``repeat_first_field`` and ``top_field_first`` repeat no frame, as
cv2 repeats none.

Raise ``NotImplementedError`` naming the feature: field pictures
(``picture_structure`` 1 / 2), dual prime motion, 4:2:2 and 4:4:4 chroma,
the scalable extensions (data partitioning, spatial, SNR and temporal
scalability), D pictures, a size that changes mid-stream, a stream that
starts with a P picture, a closed GOP's B picture with no forward reference,
a colour matrix other than BT.601, BT.709, FCC and SMPTE 240M (and one other
than BT.601 at an odd height). B pictures of an open GOP that a stream
starts with are dropped and pictures before the first sequence header give
no frame, as FFmpeg decodes neither. Corrupt data (an invalid code, a
vector out of the picture, macroblocks that no slice covers) raises
``ValueError``.
"""

from __future__ import annotations

import ctypes

import numpy as np

__all__ = ["STATS", "Mpeg2Decoder", "access_units", "elementary_stream_codec"]

# The counts native/mpeg2_decoder.cpp keeps over a stream (its Stat order): sequence headers, pictures by syntax
# (MPEG-1 / MPEG-2) and by type, interlaced and low-delay sequence extensions, GOP headers (closed ones), slices,
# macroblocks by kind (intra, skipped, with a quantiser, P "No MC", forward, backward and bi-directional,
# field-predicted, field-DCT), concealment vectors, MPEG-1 full-pel vectors, coefficient escapes, pictures by
# picture coding extension tool (intra_vlc_format, alternate_scan, q_scale_type, intra_dc_precision 8-11),
# quantiser matrices loaded (intra, non-intra, chroma) and quant matrix extensions, pictures with
# repeat_first_field, top_field_first and progressive_frame 0, open-GOP B pictures dropped at the start of a stream,
# pictures before the first sequence header, and reference pictures output after a picture decoded later.
STATS = ("sequence_headers", "mpeg1_pictures", "mpeg2_pictures", "i_pictures", "p_pictures", "b_pictures",
         "interlaced_sequences", "low_delay_sequences", "gops", "closed_gops", "slices", "intra_mbs", "skipped_mbs",
         "quant_mbs", "no_mc_mbs", "forward_mbs", "backward_mbs", "bidirectional_mbs", "field_prediction_mbs",
         "field_dct_mbs", "concealment_vectors", "full_pel_vectors", "escapes", "intra_vlc_pictures",
         "alternate_scan_pictures", "non_linear_quant_pictures", "dc_precision_8", "dc_precision_9",
         "dc_precision_10", "dc_precision_11", "intra_matrices", "non_intra_matrices", "chroma_matrices",
         "quant_matrix_extensions", "repeat_first_field", "top_field_first", "interlaced_frames",
         "open_gop_b_dropped", "pictures_before_sequence", "reordered_pictures")


def elementary_stream_codec(es: bytes) -> str | None:
    """The codec of a video elementary stream told apart by its start codes in its first 64 KiB: ``"h264"`` where
    each is followed by an H.264 NAL unit header (``forbidden_zero_bit`` clear, as no start code of MPEG-1, MPEG-2
    or MPEG-4 Part 2 pictures is) and the first names a slice, SEI, parameter set or delimiter; else ``"mpeg2"``
    (MPEG-1 / MPEG-2: a sequence header, ``00 00 01 B3``) or ``"mpeg4"`` (MPEG-4 Part 2: a visual object sequence
    or video object layer start code), whichever comes first; else ``None``."""
    codes, pos = [], es.find(b"\0\0\1")
    while 0 <= pos < min(len(es) - 3, 1 << 16):
        codes.append(es[pos + 3])
        pos = es.find(b"\0\0\1", pos + 3)
    if codes and all(code < 0x80 for code in codes):
        return "h264" if codes[0] & 31 in (1, 5, 6, 7, 8, 9) else None
    for code in codes:
        if code == 0xB3:
            return "mpeg2"
        if code == 0xB0 or 0x20 <= code <= 0x2F:
            return "mpeg4"
    return None


def access_units(es: bytes, codec: str):
    """The payloads of a ``codec`` elementary stream, one picture each with the headers before it, as FFmpeg's
    parsers cut the stream of a program or transport stream or a raw file, in stream order (a generator: the
    stream is cut as the decoder reaches it, so a reader that stops early cuts no more). ``"mpeg2"``: at the
    first sequence or GOP header or picture start code after a picture's slices; ``"mpeg4"``: at the first start
    code after a VOP's; ``"h264"``: before an access unit delimiter, SEI, parameter set or the first slice of a
    picture (``first_mb_in_slice`` 0) that follows a picture's slices, with the zero byte of a 4-byte start code."""
    if codec == "h264":
        yield from _h264_access_units(es)
        return
    picture = b"\0\0\1\0" if codec == "mpeg2" else b"\0\0\1\xb6"  # a picture header, or a VOP
    heads = (b"\0\0\1\xb3", b"\0\0\1\xb8") if codec == "mpeg2" else (b"\0\0\1",)
    start, pos = 0, es.find(picture)
    while pos >= 0:
        following = es.find(picture, pos + 4)
        if following < 0:
            break
        cut = min([following] + [p for head in heads if (p := es.find(head, pos + 4, following)) >= 0])
        yield es[start:cut]
        start, pos = cut, following
    yield es[start:]


def _h264_access_units(es: bytes):
    start, slices, pos = 0, False, es.find(b"\0\0\1")
    while 0 <= pos < len(es) - 3:
        kind = es[pos + 3] & 31
        first_slice = kind in (1, 2, 5) and pos + 4 < len(es) and es[pos + 4] & 0x80  # first_mb_in_slice ue(v) 0
        if slices and (first_slice or kind in (6, 7, 8, 9) or 14 <= kind <= 18):
            cut = pos - 1 if pos > start and es[pos - 1] == 0 else pos
            yield es[start:cut]
            start, slices = cut, False
        slices |= 1 <= kind <= 5
        pos = es.find(b"\0\0\1", pos + 3)
    yield es[start:]


class Mpeg2Decoder:
    """Decoder state across one MPEG-1 / MPEG-2 stream: its headers, its two reference pictures and the one held
    back for output, held natively. ``config``: headers a container keeps outside the payloads (a Matroska
    ``CodecPrivate``, an MP4 ``esds`` DecoderSpecificInfo), read first."""

    def __init__(self, config: bytes = b""):
        from super_resolution_tpu_torch.native import get_mpeg2_library

        self._lib = get_mpeg2_library()
        self._units: list[int] = []
        err = ctypes.create_string_buffer(256)
        self._handle = self._lib.sr_mpeg2_stream_new(config, len(config), err, len(err))
        if not self._handle:
            message = err.value.decode()
            if message.startswith("!"):
                raise NotImplementedError(f"MPEG video with {message[1:]} is not supported by the port's video reader.")
            raise ValueError(f"Corrupt MPEG video headers: {message}.")

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.sr_mpeg2_stream_free(handle)

    def decode(self, payload: bytes) -> list[np.ndarray]:
        """The frames output after the pictures of ``payload`` (uint8 ``HxWx3`` BGR)."""
        err = ctypes.create_string_buffer(256)
        count = self._lib.sr_mpeg2_stream_decode(self._handle, payload, len(payload), err, len(err))
        if count == -2:
            raise NotImplementedError(f"MPEG video with {err.value.decode()} is not supported by the port's video "
                                      "reader.")
        if count < 0:
            raise ValueError(f"Corrupt MPEG video stream: {err.value.decode()}.")
        return self._frames(count)

    def flush(self) -> list[np.ndarray]:
        """The reference picture still held back at the end of the stream (none under ``low_delay``)."""
        err = ctypes.create_string_buffer(256)
        count = self._lib.sr_mpeg2_stream_flush(self._handle, err, len(err))
        if count < 0:
            raise ValueError(f"Corrupt MPEG video stream: {err.value.decode()}.")
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
            self._lib.sr_mpeg2_stream_bgr(self._handle, index, bgr.ctypes.data)
            frames.append(bgr)
        self._units = [self._lib.sr_mpeg2_stream_unit(self._handle, index) for index in range(count)]
        return frames

    def planes(self, index: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The cropped Y, U and V planes of output frame ``index`` of the last :meth:`decode` or :meth:`flush`."""
        width, height = self.size
        out = []
        for plane, (w, h) in enumerate([(width, height)] + [((width + 1) // 2, (height + 1) // 2)] * 2):
            out.append(np.empty((h, w), np.uint8))
            self._lib.sr_mpeg2_stream_plane(self._handle, index, plane, out[-1].ctypes.data)
        return tuple(out)

    @property
    def size(self) -> tuple[int, int]:
        """(width, height) of the stream's frames (0, 0 before its first picture)."""
        wh = np.zeros(2, np.int32)
        self._lib.sr_mpeg2_stream_size(self._handle, wh.ctypes.data)
        return int(wh[0]), int(wh[1])

    @property
    def stats(self) -> dict[str, int]:
        """Counts over the pictures decoded so far (:data:`STATS`)."""
        out = np.zeros(len(STATS), np.int64)
        count = self._lib.sr_mpeg2_stream_stats(self._handle, out.ctypes.data, len(STATS))
        if count != len(STATS):
            raise RuntimeError(f"native/mpeg2_decoder.cpp keeps {count} counts, utils/mpeg2.py names {len(STATS)}.")
        return dict(zip(STATS, out.tolist()))
