"""ISO base media files (ISO/IEC 14496-12: .mp4, and QuickTime .mov, which
uses the same boxes): the first video track's samples, as
``cv2.VideoCapture`` (FFmpeg's demuxer) delivers them.

:func:`read_mp4_video` walks the boxes (32-bit sizes, the 64-bit form and a
last box that runs to the end of the file; ``mdat`` before or after
``moov``), takes the first ``trak`` whose handler is ``vide``, reads its
``mp4v`` sample entry and the ``esds`` descriptor (object type 0x20, MPEG-4
Visual, whose DecoderSpecificInfo carries the VOS / VO / VOL headers, or
0x60-0x65 and 0x6A, MPEG-2 and MPEG-1 video, whose samples carry their own
headers), QuickTime's ``m1v`` / ``m1v1`` (MPEG-1 video) or ``m2v1`` /
``mp2v`` (MPEG-2 video) sample entry or its
``vp09`` sample entry (VP9, whose ``vpcC`` box is read only for the profile
and bit depth: the frames carry their own headers) or its ``FFV1`` sample
entry (FFV1, whose ``glbl`` box holds the configuration record and whose
width and height are the frames') or its ``avc1`` / ``avc3`` sample entry
(H.264, whose ``avcC`` box -- the AVCDecoderConfigurationRecord -- holds the
parameter sets and the length of the samples' NAL unit size fields), and
locates every sample from ``stsz``, ``stsc`` and ``stco`` / ``co64``,
timed by ``stts`` (I- and P-VOPs, VP9, FFV1 or H.264 access units in decoding
order) and presented at those times plus the composition offsets of ``ctts``
(version 0, or version 1 with negative offsets: H.264 with B pictures). An
edit list (``elst``) is honoured as FFmpeg honours it: each edit with a media
time plays the samples whose presentation time lies in ``[media_time,
media_time + duration)``, decoding from the sync sample before the first of
them (in decoding order) through the last, the others flagged as not shown;
an empty edit only delays. x264 and FFmpeg's muxer write ``media_time`` equal
to the first composition delay, so that every frame plays. Without an edit
list every sample plays.

A fragmented file (``mvex`` / ``moof``), a ``vp09`` entry of another
profile than 0 or of more than 8 bits, another ``esds`` object type, and any
other sample entry than ``mp4v``, :data:`MPEG12_SAMPLE_ENTRIES`, ``vp09``, ``FFV1``,
``avc1`` and ``avc3`` raise ``NotImplementedError`` naming
it (the codec and its four-character code, such as "HEVC (hvc1)").
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

__all__ = ["MPEG12_OBJECT_TYPES", "MPEG12_SAMPLE_ENTRIES", "Mp4Video", "is_iso_bmff", "read_mp4_video"]

_TOP_LEVEL = {b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide", b"pnot", b"uuid", b"styp", b"sidx", b"moof"}
_CODECS = {b"avc1": "H.264", b"avc2": "H.264", b"avc3": "H.264", b"avc4": "H.264", b"hvc1": "HEVC",
           b"hev1": "HEVC", b"av01": "AV1", b"vp08": "VP8", b"vp09": "VP9", b"s263": "H.263", b"jpeg": "Motion JPEG",
           b"mjpa": "Motion JPEG", b"mjpb": "Motion JPEG", b"hdv1": "MPEG-2 video (HDV)", b"apcn": "ProRes",
           b"apch": "ProRes", b"dvh1": "Dolby Vision HEVC", b"vvc1": "VVC", b"encv": "encrypted video"}
_OBJECT_TYPES = {0x21: "H.264", 0x23: "HEVC", 0x6C: "JPEG", 0x6D: "PNG", 0x6E: "JPEG 2000"}
# esds objectTypeIndication of MPEG-2 video (its six profiles, 0x60-0x65) and MPEG-1 video (0x6A).
MPEG12_OBJECT_TYPES = frozenset({*range(0x60, 0x66), 0x6A})
# QuickTime's sample entries of MPEG-1 video (FFmpeg's muxer writes "m1v ") and MPEG-2 video, whose samples carry
# their own headers.
MPEG12_SAMPLE_ENTRIES = ("m1v ", "m1v1", "m2v1", "mp2v")


def is_iso_bmff(head: bytes) -> bool:
    """Whether a file starting with ``head`` (12 bytes or more) is an ISO base media / QuickTime file."""
    return len(head) >= 8 and head[4:8] in _TOP_LEVEL


def _boxes(data: bytes, start: int, end: int):
    """(type, body start, body end) of each box in ``data[start:end]``."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = pos + 8
        if size == 1:
            if pos + 16 > end:
                raise ValueError("MP4 box with a truncated 64-bit size.")
            (size,) = struct.unpack(">Q", data[pos + 8:pos + 16])
            body = pos + 16
        elif size == 0:
            size = end - pos
        if size < body - pos or pos + size > end:
            raise ValueError(f"MP4 box {kind!r} at byte {pos} runs past its parent ({size} bytes).")
        yield kind, body, pos + size
        pos += size


def _child(data: bytes, start: int, end: int, kind: bytes):
    return next(((s, e) for k, s, e in _boxes(data, start, end) if k == kind), None)


def _path(data: bytes, start: int, end: int, *kinds: bytes):
    span = (start, end)
    for kind in kinds:
        span = _child(data, *span, kind)
        if span is None:
            return None
    return span


def _descriptor(data: bytes, pos: int) -> tuple[int, int, int]:
    """(tag, body start, body end) of the ES descriptor at ``pos``; its length is up to four 7-bit bytes."""
    tag, length, pos = data[pos], 0, pos + 1
    for _ in range(4):
        byte = data[pos]
        pos += 1
        length = (length << 7) | (byte & 0x7F)
        if not byte & 0x80:
            break
    return tag, pos, pos + length


def _decoder_specific_info(data: bytes, start: int, end: int) -> tuple[int, bytes]:
    """(objectTypeIndication, DecoderSpecificInfo) of an ``esds`` box body, checked to be MPEG-4 Visual, MPEG-2
    video or MPEG-1 video."""
    tag, s, e = _descriptor(data, start + 4)  # after version / flags
    if tag != 3:
        raise ValueError("MP4 esds box without an ES descriptor.")
    flags = data[s + 2]
    pos = s + 3
    if flags & 0x80:
        pos += 2  # dependsOn_ES_ID
    if flags & 0x40:
        pos += 1 + data[pos]  # URL
    if flags & 0x20:
        pos += 2  # OCR_ES_Id
    tag, s, e = _descriptor(data, pos)
    if tag != 4:
        raise ValueError("MP4 esds box without a DecoderConfigDescriptor.")
    object_type = data[s]
    if object_type != 0x20 and object_type not in MPEG12_OBJECT_TYPES:
        name = _OBJECT_TYPES.get(object_type, f"object type 0x{object_type:02X}")
        raise NotImplementedError(f"MP4 video of {name} (mp4v with objectTypeIndication 0x{object_type:02X}) is not "
                                  "supported by the port's video reader (MPEG-4 Part 2, 0x20, MPEG-2 video, "
                                  "0x60-0x65, and MPEG-1 video, 0x6A, are).")
    pos = s + 13
    while pos < e:
        tag, ds, de = _descriptor(data, pos)
        if tag == 5:
            return object_type, data[ds:de]
        pos = de
    return object_type, b""


def _table(data: bytes, span, fmt: str, fields: int):
    """The entries of a full box whose body is a 32-bit count then ``fields`` values of ``fmt`` each."""
    if span is None:
        return []
    s, _ = span
    (count,) = struct.unpack(">I", data[s + 4:s + 8])
    size = struct.calcsize(">" + fmt * fields)
    return [struct.unpack(">" + fmt * fields, data[s + 8 + i * size:s + 8 + (i + 1) * size]) for i in range(count)]


def _sample_sizes(data: bytes, stbl) -> list[int]:
    stsz = _child(data, *stbl, b"stsz")
    if stsz is None:
        raise ValueError("MP4 video track without a sample size table (stsz).")
    s, _ = stsz
    size, count = struct.unpack(">II", data[s + 4:s + 12])
    return [size] * count if size else list(struct.unpack(f">{count}I", data[s + 12:s + 12 + 4 * count]))


def _timescale(data: bytes, start: int) -> int:
    """The timescale of an ``mvhd`` / ``mdhd`` body: after 4-byte (version 0) or 8-byte (version 1) times."""
    pos = start + (20 if data[start] else 12)
    return struct.unpack(">I", data[pos:pos + 4])[0]


@dataclass
class Mp4Video:
    """The first video track: its decoder configuration, its samples in
    decode order, for each whether its frame is shown (``False``: decoded
    only, ahead of an edit; with B pictures the frame a sample carries, not
    the one output after it), its sample entry's code (``mp4v``, ``vp09``,
    ``FFV1``, ``avc1``, ``avc3``, ``m2v1`` or ``mp2v``), the entry's width and height, and an ``mp4v``
    entry's ``esds`` object type (0x20: MPEG-4 Part 2; :data:`MPEG12_OBJECT_TYPES`: MPEG-1 / MPEG-2)."""

    config: bytes
    samples: list[bytes]
    shown: list[bool]
    codec: str = "mp4v"
    width: int = 0
    height: int = 0
    object_type: int = 0x20


def read_mp4_video(data: bytes) -> Mp4Video:
    """The first video track of an MP4 / QuickTime file held in ``data``."""
    top = list(_boxes(data, 0, len(data)))
    if any(kind == b"moof" for kind, _, _ in top):
        raise NotImplementedError("Fragmented MP4 (moof boxes) is not supported by the port's video reader.")
    moov = next(((s, e) for kind, s, e in top if kind == b"moov"), None)
    if moov is None:
        raise ValueError("MP4 file without a moov box.")
    if _child(data, *moov, b"mvex") is not None:
        raise NotImplementedError("Fragmented MP4 (an mvex box) is not supported by the port's video reader.")
    mvhd = _child(data, *moov, b"mvhd")
    movie_scale = _timescale(data, mvhd[0]) if mvhd else 0
    for kind, ts, te in _boxes(data, *moov):
        if kind != b"trak":
            continue
        hdlr = _path(data, ts, te, b"mdia", b"hdlr")
        if hdlr is not None and data[hdlr[0] + 8:hdlr[0] + 12] == b"vide":
            return _read_track(data, ts, te, movie_scale)
    raise ValueError("MP4 file without a video track.")


def _read_track(data: bytes, ts: int, te: int, movie_scale: int) -> Mp4Video:
    mdia = _child(data, ts, te, b"mdia")
    mdhd = _child(data, *mdia, b"mdhd")
    media_scale = _timescale(data, mdhd[0])
    stbl = _path(data, *mdia, b"minf", b"stbl")
    if stbl is None:
        raise ValueError("MP4 video track without a sample table.")
    stsd = _child(data, *stbl, b"stsd")
    entries = list(_boxes(data, stsd[0] + 8, stsd[1]))
    if not entries:
        raise ValueError("MP4 video track without a sample description.")
    fourcc, es, ee = entries[0]
    mpeg12 = fourcc.decode("latin-1") in MPEG12_SAMPLE_ENTRIES
    if fourcc not in (b"mp4v", b"vp09", b"FFV1", b"avc1", b"avc3") and not mpeg12:
        name = _CODECS.get(fourcc, "a codec")
        raise NotImplementedError(f"MP4 video of {name} ({fourcc.decode('latin-1')}) is not supported by the port's "
                                  "video reader (MPEG-4 Part 2 or MPEG-1 / MPEG-2, mp4v, MPEG-1 / MPEG-2, m1v / m1v1 "
                                  "/ m2v1 / mp2v, VP9, vp09, FFV1, and H.264, avc1 / avc3, are).")
    width, height = struct.unpack(">HH", data[es + 24:es + 28])
    object_type = 0x20
    if fourcc in (b"avc1", b"avc3"):
        avcc = _child(data, es + 78, ee, b"avcC")  # after the 78 bytes of the visual sample entry
        if avcc is None:
            raise ValueError(f"MP4 {fourcc.decode()} sample entry without an avcC box.")
        config = data[avcc[0]:avcc[1]]
    elif fourcc == b"FFV1":
        glbl = _child(data, es + 78, ee, b"glbl")  # after the 78 bytes of the visual sample entry
        config = data[glbl[0]:glbl[1]] if glbl else b""
    elif fourcc == b"vp09":
        vpcc = _child(data, es + 78, ee, b"vpcC")  # after the 78 bytes of the visual sample entry
        if vpcc is not None and vpcc[1] - vpcc[0] >= 7:
            profile, depth = data[vpcc[0] + 4], data[vpcc[0] + 6] >> 4
            if profile != 0 or depth != 8:
                raise NotImplementedError(f"MP4 VP9 video of profile {profile} at {depth} bits is not supported by "
                                          "the port's video reader (profile 0, 8-bit 4:2:0, is).")
        config = b""
    elif mpeg12:  # MPEG-1 / MPEG-2 video, its headers in the samples
        config = b""
    else:
        esds = _child(data, es + 78, ee, b"esds")  # after the 78 bytes of the visual sample entry
        if esds is None:
            raise ValueError("MP4 mp4v sample entry without an esds box.")
        object_type, config = _decoder_specific_info(data, *esds)

    sizes = _sample_sizes(data, stbl)
    chunks = [o for (o,) in _table(data, _child(data, *stbl, b"stco"), "I", 1)]
    chunks += [o for (o,) in _table(data, _child(data, *stbl, b"co64"), "Q", 1)]
    runs = _table(data, _child(data, *stbl, b"stsc"), "I", 3)
    samples = []
    for i, offset in enumerate(chunks, start=1):
        per_chunk = next((n for first, n, _ in reversed(runs) if first <= i), 0)
        for _ in range(per_chunk):
            if len(samples) == len(sizes):
                break
            size = sizes[len(samples)]
            if offset + size > len(data):
                raise ValueError(f"MP4 sample {len(samples)} runs past the end of the file.")
            samples.append(data[offset:offset + size])
            offset += size
    if len(samples) != len(sizes):
        raise ValueError(f"MP4 chunk tables locate {len(samples)} of {len(sizes)} samples.")

    pts, t = [], 0
    for count, delta in _table(data, _child(data, *stbl, b"stts"), "I", 2):
        for _ in range(count):
            pts.append(t)
            t += delta
    pts += [t] * (len(samples) - len(pts))  # a short stts: the rest keep the last time
    # Composition offsets (ctts, version 0 or 1; signed, as FFmpeg reads both): presentation = decoding time + offset.
    k = 0
    for count, offset in _table(data, _child(data, *stbl, b"ctts"), "i", 2):
        for _ in range(count):
            if k < len(pts):
                pts[k] += offset
            k += 1
    stss = _child(data, *stbl, b"stss")
    sync = {n - 1 for (n,) in _table(data, stss, "I", 1)} if stss else set(range(len(samples)))

    elst = _path(data, ts, te, b"edts", b"elst")
    edits = []
    if elst is not None:
        s, _ = elst
        version, count = data[s], struct.unpack(">I", data[s + 4:s + 8])[0]
        fmt, size = (">Qq", 16) if version else (">Ii", 8)
        for i in range(count):
            duration, media_time = struct.unpack(fmt, data[s + 8 + i * (size + 4):s + 8 + i * (size + 4) + size])
            if media_time < 0:
                continue  # an empty edit
            span = (duration * media_scale + movie_scale // 2) // movie_scale if duration and movie_scale else None
            edits.append((media_time, None if span is None else media_time + span))
    codec = fourcc.decode("latin-1")
    if not edits:
        return Mp4Video(config, samples, [True] * len(samples), codec, width, height, object_type)
    order, shown = [], []
    for first, stop in edits:
        chosen = [i for i in range(len(samples)) if pts[i] >= first and (stop is None or pts[i] < stop)]
        if not chosen:
            continue
        start = max((i for i in sync if i <= chosen[0]), default=0)
        kept = set(chosen)
        for i in range(start, chosen[-1] + 1):
            order.append(i)
            shown.append(i in kept)
    return Mp4Video(config, [samples[i] for i in order], shown, codec, width, height, object_type)
