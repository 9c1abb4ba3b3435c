"""MPEG program streams (ISO/IEC 13818-1 2.5, and MPEG-1 system streams,
ISO/IEC 11172-1: .mpg, .mpeg, .vob): the first video stream's elementary
stream, as ``cv2.VideoCapture`` (FFmpeg's ``mpegps`` demuxer) delivers it.

:func:`read_program_stream` walks the packs: pack headers of either form
(MPEG-1's 12 bytes, MPEG-2's 14 plus stuffing), the system header, the
program stream map (read for the video stream's ``stream_type``), the
program end code, and PES packets, whose headers it reads in either form
(MPEG-1's stuffing, STD buffer and time stamps; MPEG-2's flags and
``PES_header_data_length``). The payloads of the first video stream
(``stream_id`` 0xE0-0xEF) are joined in file order; every other stream --
audio, padding, ``private_stream_1`` (DVD audio and subtitles),
``private_stream_2`` (DVD navigation packs) -- is skipped by its length.

The codec is the map's ``stream_type`` where the stream carries a map, else
what the elementary stream's start codes say
(:func:`super_resolution_tpu_torch.utils.mpeg2.elementary_stream_codec`):
:func:`stream_codec`, which the transport stream reader shares.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from super_resolution_tpu_torch.utils.mpeg2 import elementary_stream_codec

__all__ = ["PRIVATE_DATA", "READ_STREAM_TYPES", "STREAM_TYPES", "ProgramStream", "is_program_stream",
           "read_program_stream", "pes_payload", "stream_codec"]

_PACK, _SYSTEM_HEADER, _END, _MAP = 0xBA, 0xBB, 0xB9, 0xBC
PRIVATE_DATA = 0x06  # PES packets of private data: FFmpeg probes what they carry
# The video stream types of ISO/IEC 13818-1 Table 2-34 (and those FFmpeg maps), by name.
STREAM_TYPES = {0x01: "MPEG-1 video", 0x02: "MPEG-2 video", 0x10: "MPEG-4 Part 2", 0x1B: "H.264", 0x1E: "MPEG-2 video"
                " (auxiliary)", 0x20: "H.264 MVC", 0x21: "JPEG 2000", 0x24: "HEVC", 0x33: "VVC", 0x42: "AVS",
                0xD1: "Dirac", 0xD2: "AVS2", 0xD4: "AVS3", 0xEA: "VC-1"}
# The stream types the port decodes, and the decoder each goes to.
READ_STREAM_TYPES = {0x01: "mpeg2", 0x02: "mpeg2", 0x10: "mpeg4", 0x1B: "h264"}


def stream_codec(stream_type: int | None, es: bytes, container: str) -> str | None:
    """The decoder (``"mpeg2"``, ``"mpeg4"`` or ``"h264"``) of a ``container``'s video stream of ``stream_type`` (a
    program stream map's or a transport stream's program map's): the elementary stream's start codes tell it
    without a map (``None``) and for private data (0x06), as FFmpeg probes them (``None`` where they name no codec).
    Any other type raises ``NotImplementedError`` naming it."""
    if stream_type is None or stream_type == PRIVATE_DATA:
        return elementary_stream_codec(es)
    if stream_type not in READ_STREAM_TYPES:
        raise NotImplementedError(f"{container} video of {STREAM_TYPES.get(stream_type, 'an unknown codec')} "
                                  f"(stream_type 0x{stream_type:02X}) is not supported by the port's video reader "
                                  "(MPEG-1 / MPEG-2, MPEG-4 Part 2 and H.264 are).")
    return READ_STREAM_TYPES[stream_type]


def is_program_stream(head: bytes) -> bool:
    """Whether a file starting with ``head`` is an MPEG program (or MPEG-1 system) stream: a pack header first."""
    return head[:4] == b"\0\0\1\xba"


@dataclass
class ProgramStream:
    """The first video stream: its ``stream_id``, the program stream map's ``stream_type`` for it (``None``
    without a map) and its elementary stream."""

    stream_id: int
    stream_type: int | None
    es: bytes

    def codec(self) -> str | None:
        """The decoder of the stream (:func:`stream_codec`)."""
        return stream_codec(self.stream_type, self.es, "MPEG program stream")


def pes_payload(data: bytes, pos: int, end: int) -> int:
    """Where the payload of the PES packet whose header starts at ``pos`` (its start code) begins: after an
    MPEG-2 PES header (``10`` flag bits) or an MPEG-1 one (stuffing, STD buffer size, time stamps)."""
    p = pos + 6
    if p < end and data[p] & 0xC0 == 0x80:
        if p + 3 > end:
            raise ValueError(f"MPEG PES header at byte {pos} runs past its packet.")
        return p + 3 + data[p + 2]
    while p < end and data[p] == 0xFF:  # stuffing
        p += 1
    if p < end and data[p] & 0xC0 == 0x40:  # STD_buffer_scale / size
        p += 2
    if p < end:
        flags = data[p] & 0xF0
        p += 5 if flags == 0x20 else 10 if flags == 0x30 else 1
    if p > end:
        raise ValueError(f"MPEG PES header at byte {pos} runs past its packet.")
    return p


def _stream_map(data: bytes, pos: int, end: int) -> dict[int, int]:
    """``stream_id`` -> ``stream_type`` of a program stream map whose start code is at ``pos``."""
    p = pos + 8
    (info,) = struct.unpack(">H", data[p:p + 2])
    p += 2 + info
    (size,) = struct.unpack(">H", data[p:p + 2])
    p += 2
    types, stop = {}, min(p + size, end)
    while p + 4 <= stop:
        kind, stream_id, info = data[p], data[p + 1], struct.unpack(">H", data[p + 2:p + 4])[0]
        types.setdefault(stream_id, kind)
        p += 4 + info
    return types


def read_program_stream(data: bytes) -> ProgramStream:
    """The first video stream of an MPEG program stream held in ``data``."""
    pos, video, payloads, types = 0, None, [], {}
    while True:
        pos = data.find(b"\0\0\1", pos)
        if pos < 0 or pos + 4 > len(data):
            break
        code = data[pos + 3]
        if code == _PACK:
            if pos + 5 > len(data):
                break
            if data[pos + 4] & 0xC0 == 0x40:  # MPEG-2
                if pos + 14 > len(data):
                    break
                pos += 14 + (data[pos + 13] & 7)
            else:  # MPEG-1
                pos += 12
            continue
        if code == _END:
            pos += 4
            continue
        if code < _END:  # not a system start code: resynchronise
            pos += 3
            continue
        if pos + 6 > len(data):
            break
        (length,) = struct.unpack(">H", data[pos + 4:pos + 6])
        end = min(pos + 6 + length, len(data))
        if code == _MAP:
            types = _stream_map(data, pos, end)
        elif 0xE0 <= code <= 0xEF and (video is None or code == video):
            if video is None:
                video = code
            payloads.append(data[pes_payload(data, pos, end):end])
        pos = end
    if video is None:
        raise ValueError("MPEG program stream without a video stream.")
    return ProgramStream(video, types.get(video), b"".join(payloads))
