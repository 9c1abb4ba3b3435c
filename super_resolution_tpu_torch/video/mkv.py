"""Matroska and WebM files (.mkv, .webm): the first video track's frames, as
``cv2.VideoCapture`` (FFmpeg's demuxer) delivers them.

:func:`read_matroska_video` walks the EBML elements: the EBML header (doc
type ``matroska`` or ``webm``), the ``Segment`` (of known or unknown size),
its ``Tracks`` -- the first ``TrackEntry`` of type video, with its
``CodecID``, ``CodecPrivate`` and ``PixelWidth`` / ``PixelHeight`` -- and
its ``Cluster`` s, of known or unknown size (an unknown-size cluster ends
where an element that cannot be its child begins), with their
``SimpleBlock`` s and ``BlockGroup`` / ``Block`` s. A block's frames are
split by the lacing its own flags give, whatever the track's ``FlagLacing``
says (FFmpeg does not read it either): Xiph (sizes as runs of 255), EBML (a
first size, then signed differences) or fixed-size. ``SeekHead``,
``Cues``, ``Void``, ``CRC-32`` and the other top-level elements are
skipped.

Codecs: ``V_MJPEG`` (each frame a JPEG); ``V_MPEG4/ISO/SP``, ``/ASP`` and
``/AP`` (MPEG-4 Part 2, with ``CodecPrivate`` as the decoder's
configuration); ``V_MPEG1`` and ``V_MPEG2`` (each frame an MPEG-1 / MPEG-2
picture, with ``CodecPrivate``, where there is one, as the sequence
headers); ``V_VP8`` (each frame a VP8 frame, hidden ones included);
``V_VP9`` (each frame a VP9 frame or superframe); ``V_FFV1`` (each frame
an FFV1 frame, with ``CodecPrivate`` as its configuration record);
``V_MPEG4/ISO/AVC`` (each frame an H.264 access unit of length-prefixed NAL
units, with ``CodecPrivate`` as its AVCDecoderConfigurationRecord);
``V_MS/VFW/FOURCC``, whose ``CodecPrivate`` is a
``BITMAPINFOHEADER`` followed by the decoder's configuration, routed by its
compression code as the AVI reader routes a stream's four-character code
(code 0 at 24 bits: rows of BGR24, which FFmpeg's Matroska demuxer hands
over top-down at the track's ``PixelWidth`` x ``PixelHeight``, not at the
header's size, and unflipped).
Every other codec (``V_MPEGH/ISO/HEVC``, ``V_AV1``, ...), a track with
``ContentEncodings`` (compressed or encrypted frames) and a file with a second
video track raise ``NotImplementedError`` naming what they are.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

__all__ = ["MatroskaVideo", "is_matroska", "read_matroska_video"]

EBML, SEGMENT, CLUSTER, TRACKS = 0x1A45DFA3, 0x18538067, 0x1F43B675, 0x1654AE6B
_DOC_TYPE = 0x4282
_TRACK_ENTRY, _TRACK_NUMBER, _TRACK_TYPE, _CODEC_ID, _CODEC_PRIVATE = 0xAE, 0xD7, 0x83, 0x86, 0x63A2
_VIDEO, _PIXEL_WIDTH, _PIXEL_HEIGHT, _CONTENT_ENCODINGS = 0xE0, 0xB0, 0xBA, 0x6D80
_SIMPLE_BLOCK, _BLOCK_GROUP, _BLOCK = 0xA3, 0xA0, 0xA1
# Elements that end an unknown-size cluster: the Segment's children and the EBML header.
_TOP_LEVEL = {CLUSTER, TRACKS, 0x114D9B74, 0x1549A966, 0x1C53BB6B, 0x1254C367, 0x1043A770, 0x1941A469, EBML, SEGMENT}
_CODECS = {"V_VP8": "VP8", "V_VP9": "VP9", "V_FFV1": "FFV1", "V_MPEG4/ISO/AVC": "H.264",
           "V_MPEGH/ISO/HEVC": "HEVC", "V_AV1": "AV1", "V_MPEG1": "MPEG-1 video", "V_MPEG2": "MPEG-2 video",
           "V_THEORA": "Theora", "V_UNCOMPRESSED": "uncompressed video", "V_PRORES": "ProRes",
           "V_QUICKTIME": "a QuickTime codec", "V_REAL/RV40": "RealVideo", "V_MPEGI/ISO/VVC": "VVC"}
MPEG4_CODECS = {"V_MPEG4/ISO/SP", "V_MPEG4/ISO/ASP", "V_MPEG4/ISO/AP"}
MPEG12_CODECS = {"V_MPEG1", "V_MPEG2"}
UNKNOWN = -1


def is_matroska(head: bytes) -> bool:
    """Whether a file starting with ``head`` is EBML (Matroska / WebM)."""
    return head[:4] == b"\x1a\x45\xdf\xa3"


def _vint(data: bytes, pos: int, end: int, keep_marker: bool) -> tuple[int, int]:
    """(value, next position) of the variable-length integer at ``pos``; an
    element ID keeps its length marker, a size with every value bit set is
    ``UNKNOWN``."""
    if pos >= end:
        raise ValueError(f"Matroska element ends early at byte {pos}.")
    first = data[pos]
    length = 9 - first.bit_length() if first else 9
    if length > 8 or pos + length > end:
        raise ValueError(f"Invalid Matroska variable-length integer at byte {pos}.")
    value = int.from_bytes(data[pos:pos + length], "big")
    if not keep_marker:
        value &= (1 << (7 * length)) - 1
        if value == (1 << (7 * length)) - 1:
            value = UNKNOWN
    return value, pos + length


def _elements(data: bytes, start: int, end: int):
    """(ID, body start, body end) of each element in ``data[start:end]``. An
    element of unknown size runs to the end of its parent, a cluster to the
    first element that cannot be its child."""
    pos = start
    while pos < end:
        ident, body = _vint(data, pos, end, True)
        size, body = _vint(data, body, end, False)
        if size == UNKNOWN:
            if ident == CLUSTER:
                stop = _unknown_cluster_end(data, body, end)
            else:
                stop = end
        else:
            stop = body + size
            if stop > end:
                raise ValueError(f"Matroska element 0x{ident:X} at byte {pos} runs past its parent.")
        yield ident, body, stop
        pos = stop


def _unknown_cluster_end(data: bytes, start: int, end: int) -> int:
    """Where a cluster of unknown size ends: at the first element that cannot be its child."""
    pos = start
    while pos < end:
        ident, body = _vint(data, pos, end, True)
        if ident in _TOP_LEVEL:
            return pos
        size, body = _vint(data, body, end, False)
        if size == UNKNOWN:
            raise ValueError(f"Matroska cluster child 0x{ident:X} of unknown size at byte {pos}.")
        pos = body + size
    return min(pos, end)


def _children(data: bytes, start: int, end: int) -> dict[int, tuple[int, int]]:
    """The first element of each ID among the children of ``data[start:end]``."""
    found = {}
    for ident, s, e in _elements(data, start, end):
        found.setdefault(ident, (s, e))
    return found


def _uint(data: bytes, span) -> int:
    return int.from_bytes(data[span[0]:span[1]], "big") if span else 0


def _string(data: bytes, span) -> str:
    return data[span[0]:span[1]].split(b"\0", 1)[0].decode("latin-1") if span else ""


@dataclass
class MatroskaVideo:
    """The first video track: its codec, its configuration, its ``PixelWidth``
    x ``PixelHeight`` and its frames in file order."""

    codec_id: str
    codec_private: bytes
    width: int
    height: int
    frames: list[bytes]


def codec_name(codec_id: str) -> str:
    return _CODECS.get(codec_id, "a codec")


def _lace(data: bytes, start: int, end: int, lacing: int) -> list[bytes]:
    """The frames of one block's data ``data[start:end]`` (after its header byte of flags)."""
    if lacing == 0:
        return [data[start:end]]
    if start >= end:
        raise ValueError("Matroska laced block without a frame count.")
    count, pos = data[start] + 1, start + 1
    sizes = []
    if lacing == 1:  # Xiph
        for _ in range(count - 1):
            size = 0
            while True:
                if pos >= end:
                    raise ValueError("Matroska Xiph lacing runs past its block.")
                byte = data[pos]
                pos += 1
                size += byte
                if byte != 255:
                    break
            sizes.append(size)
    elif lacing == 3:  # EBML
        size, pos = _vint(data, pos, end, False)
        sizes.append(size)
        for _ in range(count - 2):
            first = data[pos]
            length = 9 - first.bit_length() if first else 9
            raw, pos = _vint(data, pos, end, False)
            size += raw - ((1 << (7 * length - 1)) - 1)
            sizes.append(size)
    else:  # fixed
        if (end - pos) % count:
            raise ValueError(f"Matroska fixed-size lacing of {end - pos} bytes into {count} frames.")
        sizes = [(end - pos) // count] * (count - 1)
    last = end - pos - sum(sizes)
    if last < 0 or any(s < 0 for s in sizes):
        raise ValueError("Matroska lacing sizes run past their block.")
    frames = []
    for size in sizes + [last]:
        frames.append(data[pos:pos + size])
        pos += size
    return frames


def read_matroska_video(data: bytes) -> MatroskaVideo:
    """The first video track of a Matroska / WebM file held in ``data``."""
    if not is_matroska(data[:4]):
        raise ValueError("Not a Matroska / WebM file (no EBML header).")
    top = list(_elements(data, 0, len(data)))
    header = next(((s, e) for i, s, e in top if i == EBML), None)
    doc_type = _string(data, _children(data, *header).get(_DOC_TYPE)) if header else ""
    if doc_type not in ("matroska", "webm"):
        raise ValueError(f"EBML file of document type {doc_type!r}, not Matroska / WebM.")
    segment = next(((s, e) for i, s, e in top if i == SEGMENT), None)
    if segment is None:
        raise ValueError("Matroska file without a Segment.")
    track = number = None
    blocks = []
    for ident, s, e in _elements(data, *segment):
        if ident == TRACKS and track is None:
            track = _video_track(data, s, e)
            number = _uint(data, track[_TRACK_NUMBER])
        elif ident == CLUSTER:
            if track is None:
                raise ValueError("Matroska cluster before the Tracks element.")
            blocks += _cluster_frames(data, s, e, number)
    if track is None:
        raise ValueError("Matroska file without a Tracks element.")
    return MatroskaVideo(track["codec_id"], track["codec_private"], track["width"], track["height"], blocks)


def _video_track(data: bytes, start: int, end: int) -> dict:
    video = [(s, e) for i, s, e in _elements(data, start, end) if i == _TRACK_ENTRY
             and _uint(data, _children(data, s, e).get(_TRACK_TYPE)) == 1]
    if not video:
        raise ValueError("Matroska file without a video track.")
    if len(video) > 1:
        raise NotImplementedError(f"Matroska file with {len(video)} video tracks: a second video track is not "
                                  "supported by the port's video reader (one video track is).")
    entry = _children(data, *video[0])
    codec_id = _string(data, entry.get(_CODEC_ID))
    if _CONTENT_ENCODINGS in entry:
        raise NotImplementedError(f"Matroska {codec_id} track with ContentEncodings (compressed or encrypted frames) "
                                  "is not supported by the port's video reader.")
    if _TRACK_NUMBER not in entry:
        raise ValueError("Matroska video track without a TrackNumber.")
    picture = _children(data, *entry[_VIDEO]) if _VIDEO in entry else {}
    private = entry.get(_CODEC_PRIVATE)
    return {_TRACK_NUMBER: entry[_TRACK_NUMBER], "codec_id": codec_id,
            "codec_private": data[private[0]:private[1]] if private else b"",
            "width": _uint(data, picture.get(_PIXEL_WIDTH)), "height": _uint(data, picture.get(_PIXEL_HEIGHT))}


def _cluster_frames(data: bytes, start: int, end: int, number: int):
    """The frames of track ``number`` in one cluster's blocks, in file order."""
    for ident, s, e in _elements(data, start, end):
        if ident == _BLOCK_GROUP:
            block = _children(data, s, e).get(_BLOCK)
            if block is None:
                continue
            s, e = block
        elif ident != _SIMPLE_BLOCK:
            continue
        track, pos = _vint(data, s, e, False)
        if track != number:
            continue
        if pos + 3 > e:
            raise ValueError(f"Matroska block at byte {s} shorter than its header.")
        flags = data[pos + 2]
        yield from _lace(data, pos + 3, e, (flags >> 1) & 3)


def bitmap_info_header(private: bytes) -> tuple[bytes, int, bytes]:
    """(compression code, bits per pixel, the decoder's configuration after it) of a ``V_MS/VFW/FOURCC`` track."""
    if len(private) < 40:
        raise ValueError(f"Matroska V_MS/VFW/FOURCC track with a CodecPrivate of {len(private)} bytes "
                         "(a BITMAPINFOHEADER has 40).")
    (bits,) = struct.unpack("<H", private[14:16])
    return private[16:20], bits, private[40:]
