"""Video frame loading (equivalent of ``src/video/video_loader.{h,cpp}``).

Counterpart of the JAX package's ``video/video_loader.py``. Frames come from
an image directory (the only path the reference exercises,
``shift_add_fusion.cpp:37-38``; PNG, BMP, JPEG -- sequential or progressive
--, TIFF or GIF frames, each read as ``cv2.imread`` reads it, through
:func:`super_resolution_tpu_torch.utils.data_loader.load_images`) or from a
video file, and are kept as
``[H, W, C]`` tensors in ``[0, 1]`` on the loader's device, in OpenCV's BGR
order; :meth:`VideoLoader.frame_stack` gives the ``[K, C, H, W]`` stack the
solvers take.

The JAX loader decodes video through ``cv2.VideoCapture`` (FFmpeg). The port
reads the file itself, choosing the container by its first bytes, not by
its extension (:data:`CONTAINERS` lists them with the codecs each carries,
and the refusal of any other file names them):

- MP4 / QuickTime (:mod:`super_resolution_tpu_torch.video.mp4`): the first
  video track's MPEG-4 Part 2 (``mp4v`` with object type 0x20), MPEG-1 /
  MPEG-2 (``mp4v`` with object types 0x60-0x65 or 0x6A, QuickTime's
  ``m1v`` / ``m1v1`` / ``m2v1`` / ``mp2v``), VP9 (``vp09``), FFV1 (``FFV1``, configured by its
  ``glbl`` box) or H.264 (``avc1`` / ``avc3``, configured by its ``avcC``
  box) samples, with its edit list;
- Matroska / WebM (:mod:`super_resolution_tpu_torch.video.mkv`): the
  first video track's MPEG-4 Part 2 (``V_MPEG4/ISO/SP|ASP|AP``), MPEG-1 /
  MPEG-2 (``V_MPEG1`` / ``V_MPEG2``), VP8 (``V_VP8``), VP9 (``V_VP9``), FFV1
  (``V_FFV1``), H.264 (``V_MPEG4/ISO/AVC``) or Motion-JPEG (``V_MJPEG``)
  frames, or those of a ``V_MS/VFW/FOURCC`` track whose code the AVI reader
  takes (uncompressed 24-bit rows top-down, at the track's size, as FFmpeg's
  Matroska demuxer hands them over);
- RIFF AVI: the video stream's ``##dc`` / ``##db`` chunks of the ``movi``
  list (and of the OpenDML ``AVIX`` extensions), decoded as MPEG-4 Part 2
  (fourcc ``XVID``, ``DIVX``, ``DX50``, ``FMP4``, ``MP4V``), as MPEG-1 /
  MPEG-2 (``mpg1``, ``mpg2``, ``PIM1``, ``PIM2``, ``MPEG``, ``mpgv``), as VP8
  (``VP80``), VP9 (``VP90``) or FFV1 (``FFV1``, configured by what follows
  the ``BITMAPINFOHEADER`` in ``strf``), as H.264 in Annex B (``H264``,
  ``X264``, ``AVC1``) -- each fourcc in either case --, as Motion-JPEG
  through :mod:`super_resolution_tpu_torch.utils.jpeg`, or as uncompressed
  24-bit ``BI_RGB`` rows (bottom-up where the height is positive, each row
  padded to 4 bytes);
- IVF (:mod:`super_resolution_tpu_torch.video.ivf`): its VP8 (``VP80``) or
  VP9 (``VP90``) frames;
- MPEG program streams and MPEG-1 system streams (.mpg, .vob;
  :mod:`super_resolution_tpu_torch.video.mpegps`) and MPEG transport streams
  of 188- or 192-byte packets (.ts, .m2ts, .mts;
  :mod:`super_resolution_tpu_torch.video.mpegts`): the first video stream's
  MPEG-1 / MPEG-2, MPEG-4 Part 2 or H.264 elementary stream;
- a raw MPEG-1 / MPEG-2 elementary stream (.m1v / .m2v, a sequence header
  first) or H.264 Annex B stream (``.h264`` / ``.264``, a start code and a
  NAL unit header of H.264 first), as ``cv2.VideoCapture`` opens them.

MPEG-4 Part 2 frames (:mod:`super_resolution_tpu_torch.utils.mpeg4`), MPEG-1
and MPEG-2 frames (:mod:`super_resolution_tpu_torch.utils.mpeg2`: I, P and B
pictures, progressive and interlaced frame pictures, in FFmpeg's output
order), VP8 frames (:mod:`super_resolution_tpu_torch.utils.vp8`), VP9 frames
(:mod:`super_resolution_tpu_torch.utils.vp9`), FFV1 frames
(:mod:`super_resolution_tpu_torch.utils.ffv1`, versions 0-3 at 8 bits) and
H.264 frames (:mod:`super_resolution_tpu_torch.utils.h264`: progressive 8-bit
4:2:0, I, P and B slices, CAVLC or CABAC, up to High profile, in FFmpeg's output
order) are
``cv2.VideoCapture``'s, pixel for pixel, at any frame size, on what
``cv2.VideoWriter`` writes; a hidden VP8 or VP9
frame gives none, a VP9 superframe or ``show_existing_frame`` the frames it
shows. An MJPEG frame is what ``cv2.imdecode`` gives for its JPEG payload;
FFmpeg's MJPEG decoder and colour conversion differ from that by a few grey
levels (ROADMAP.md, Queue 3). An MPEG-2 frame FFmpeg flags as interlaced
(``progressive_frame`` 0) is converted as swscale converts its planes, which
``cv2.VideoCapture`` with FFmpeg 8's swscale does not do (ROADMAP.md, Queue 3).
Other containers and codecs (HEVC, HuffYUV, FFV1 above 8 bits, MS-MPEG4
``DIV3``, interlaced H.264, MPEG-2 field pictures, ...) raise
``NotImplementedError`` naming them.
"""

from __future__ import annotations

import itertools
import os
import struct
import tempfile
from collections.abc import Iterable

import numpy as np
import torch

from super_resolution_tpu_torch._device import resolve_device

__all__ = ["CONTAINERS", "VideoLoader", "read_avi_frames", "read_video_frames"]

_MJPEG = {b"MJPG", b"mjpg"}
_MPEG4 = {b"XVID", b"xvid", b"DIVX", b"divx", b"DX50", b"dx50", b"FMP4", b"fmp4", b"MP4V", b"mp4v"}
_VP8 = {b"VP80", b"vp80"}
_VP9 = {b"VP90", b"vp90"}
_FFV1 = {b"FFV1", b"ffv1"}
_H264 = {b"H264", b"h264", b"X264", b"x264", b"avc1", b"AVC1"}
# MPEG-1 / MPEG-2 video: the codes FFmpeg's AVI muxer writes (mpg2, PIM1) and others of its RIFF table, either case.
_MPEG12 = {code for tag in (b"mpg1", b"mpg2", b"PIM1", b"PIM2", b"MPEG", b"mpgv")
           for code in (tag.lower(), tag.upper())}
_DISPLAY_SIZE = (1000, 600)  # kDisplayFrameSize, video_loader.cpp:19


def _container_name(head: bytes) -> str:
    if head[:4] == b"RIFF":
        return f"RIFF {head[8:12].decode('latin-1')!r}"
    return "an unknown container"


def _chunks(data: bytes, start: int, end: int):
    """(fourcc, list type or None, body start, body end) of each chunk in ``data[start:end]``."""
    pos = start
    while pos + 8 <= end:
        fourcc = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        body = pos + 8
        stop = min(body + size, end)
        if fourcc in (b"LIST", b"RIFF"):
            yield fourcc, data[body:body + 4], body + 4, stop
        else:
            yield fourcc, None, body, stop
        pos = body + size + (size & 1)


def _video_stream(data: bytes, hdrl: tuple[int, int]):
    """(stream number, codec fourcc, bits per pixel, width, height, handler fourcc, the decoder's configuration
    after the 40-byte BITMAPINFOHEADER in ``strf``) of the first video stream."""
    number = 0
    for fourcc, kind, start, end in _chunks(data, *hdrl):
        if fourcc != b"LIST" or kind != b"strl":
            continue
        strh = strf = None
        for sub, _, s, e in _chunks(data, start, end):
            if sub == b"strh":
                strh = data[s:e]
            elif sub == b"strf":
                strf = data[s:e]
        if strh is not None and strh[:4] == b"vids" and strf is not None and len(strf) >= 20:
            _, width, height, _, bits, compression = struct.unpack("<IiiHH4s", strf[:20])
            return number, compression, bits, width, height, strh[4:8], strf[40:]
        number += 1
    raise ValueError("AVI file without a video stream.")


def _frame_payloads(data: bytes, stream: int, max_frames: int):
    """The video stream's chunk bodies, in file order, over ``movi`` of the
    ``AVI `` RIFF and of every OpenDML ``AVIX`` RIFF after it."""
    ids = {f"{stream:02d}dc".encode(), f"{stream:02d}db".encode()}
    payloads = []

    def walk(start, end):
        for fourcc, kind, s, e in _chunks(data, start, end):
            if max_frames and len(payloads) >= max_frames:
                return
            if fourcc == b"LIST" and kind == b"rec ":
                walk(s, e)
            elif fourcc in ids and e > s:
                payloads.append(data[s:e])

    for fourcc, kind, start, end in _chunks(data, 0, len(data)):
        if fourcc != b"RIFF" or kind not in (b"AVI ", b"AVIX"):
            continue
        for sub, sub_kind, s, e in _chunks(data, start, end):
            if sub == b"LIST" and sub_kind == b"movi":
                walk(s, e)
    return payloads


def _read(path: str) -> bytes:
    if not os.path.isfile(path):
        raise FileNotFoundError(f"Could not open video {path}")
    with open(path, "rb") as f:
        return f.read()


def _refuse_container(path: str, head: bytes) -> NotImplementedError:
    readable = ", ".join(f"{name} with {codecs}" for name, _, _, codecs in CONTAINERS)
    return NotImplementedError(
        f"{path}: {_container_name(head)} is not supported by the port's video reader ({readable}, are); convert "
        "the video, or extract its frames as images.")


def _is_annexb(head: bytes) -> bool:
    """Whether a file starting with ``head`` is an H.264 Annex B stream: a start code, then a NAL unit header
    with the forbidden bit clear and a slice, SEI, parameter set or delimiter type."""
    start = 3 if head[:3] == b"\0\0\1" else 4 if head[:4] == b"\0\0\0\1" else 0
    return bool(start) and len(head) > start and not head[start] & 0x80 and (head[start] & 31) in (1, 5, 6, 7, 8, 9)


def _is_avi(head: bytes) -> bool:
    return head[:4] == b"RIFF" and head[8:12] == b"AVI "


def _is_mpeg_es(head: bytes) -> bool:
    """Whether a file starting with ``head`` is a raw MPEG-1 / MPEG-2 video elementary stream: a sequence header."""
    return head[:4] == b"\0\0\1\xb3"


def _containers():
    from super_resolution_tpu_torch.video.ivf import is_ivf
    from super_resolution_tpu_torch.video.mkv import is_matroska
    from super_resolution_tpu_torch.video.mp4 import is_iso_bmff
    from super_resolution_tpu_torch.video.mpegps import is_program_stream
    from super_resolution_tpu_torch.video.mpegts import packet_size

    # (name, whether a file's first 400 bytes are this container, its reader (path, data, max_frames), the
    # codecs read in it): the dispatch of read_video_frames, in the order it tries them, and its refusal's text.
    return (
        ("AVI", _is_avi, _avi_frames, "MPEG-4 Part 2, MPEG-1 / MPEG-2, VP8, VP9, FFV1, H.264, Motion-JPEG or "
         "uncompressed frames"),
        ("MP4 / QuickTime", lambda h: is_iso_bmff(h[:12]), lambda p, d, n: _mp4_frames(d, n),
         "MPEG-4 Part 2, MPEG-1 / MPEG-2, VP9, FFV1 or H.264"),
        ("Matroska / WebM", lambda h: is_matroska(h[:4]), _matroska_frames,
         "MPEG-4 Part 2, MPEG-1 / MPEG-2, VP8, VP9, FFV1, H.264 or Motion-JPEG"),
        ("IVF", lambda h: is_ivf(h[:4]), _ivf_frames, "VP8 or VP9"),
        ("MPEG program streams", is_program_stream, _program_stream_frames,
         "MPEG-1 / MPEG-2, MPEG-4 Part 2 or H.264"),
        ("MPEG transport streams (188- and 192-byte packets)", lambda h: bool(packet_size(h)),
         _transport_stream_frames, "MPEG-1 / MPEG-2, MPEG-4 Part 2 or H.264"),
        ("raw elementary streams", _is_mpeg_es,
         lambda p, d, n: _elementary_stream_frames(p, "raw elementary stream", "mpeg2", d, n), "MPEG-1 / MPEG-2"),
        ("raw elementary streams", lambda h: _is_annexb(h[:5]),
         lambda p, d, n: _elementary_stream_frames(p, "raw elementary stream", "h264", d, n), "H.264 (Annex B)"),
    )


def read_video_frames(path: str, max_frames: int = 0) -> list[np.ndarray]:
    """The frames of a video file in any container of :data:`CONTAINERS`, told apart by its first bytes, as
    uint8 ``HxWx3`` BGR arrays (all, or the first ``max_frames``)."""
    data = _read(path)
    for _, matches, read, _ in CONTAINERS:
        if matches(data[:400]):
            return read(path, data, max_frames)
    raise _refuse_container(path, data[:12])


def _ivf_frames(path: str, data: bytes, max_frames: int) -> list[np.ndarray]:
    from super_resolution_tpu_torch.video import ivf

    video = ivf.read_ivf_video(data)
    if video.fourcc in _VP9:
        return _vp9_frames(video.frames, max_frames)
    if video.fourcc not in _VP8:
        raise NotImplementedError(f"{path}: IVF video of {ivf.codec_name(video.fourcc)} is not supported by the "
                                  "port's video reader (VP8 and VP9 are).")
    return _vp8_frames(video.frames, max_frames)


def _vp8_frames(payloads: list[bytes], max_frames: int) -> list[np.ndarray]:
    """The frames a VP8 stream's payloads show (a hidden frame shows none)."""
    from super_resolution_tpu_torch.utils.vp8 import Vp8Decoder

    return _shown_frames(Vp8Decoder(), payloads, max_frames)


def _vp9_frames(payloads: list[bytes], max_frames: int, shown: list[bool] | None = None) -> list[np.ndarray]:
    """The frames a VP9 stream's payloads show, keeping those of the ``shown`` payloads (default: all)."""
    from super_resolution_tpu_torch.utils.vp9 import Vp9Decoder

    return _shown_frames(Vp9Decoder(), payloads, max_frames, shown)


def _ffv1_frames(payloads: list[bytes], max_frames: int, config: bytes, width: int, height: int,
                 shown: list[bool] | None = None) -> list[np.ndarray]:
    """The frames of an FFV1 stream, whose size the container gives, keeping those of the ``shown`` payloads."""
    from super_resolution_tpu_torch.utils.ffv1 import Ffv1Decoder

    return _shown_frames(Ffv1Decoder(config, width, height), payloads, max_frames, shown)


def _h264_frames(payloads: Iterable[bytes], max_frames: int, config: bytes = b"",
                 shown: list[bool] | None = None) -> list[np.ndarray]:
    """The frames of an H.264 stream's access units (length-prefixed after an ``avcC`` ``config``, Annex B
    without one) in FFmpeg's output order, those held back for reordering at the end included, keeping those whose
    own payload is ``shown``."""
    from super_resolution_tpu_torch.utils.h264 import H264Decoder

    return _shown_frames(H264Decoder(config), payloads, max_frames, shown)


def _mpeg2_frames(payloads: Iterable[bytes], max_frames: int, config: bytes = b"",
                  shown: list[bool] | None = None) -> list[np.ndarray]:
    """The frames of an MPEG-1 / MPEG-2 stream's payloads (a picture each) in
    FFmpeg's output order, the last reference picture at the end included, keeping those whose own payload is
    ``shown``; ``config``: headers the container keeps outside the payloads."""
    from super_resolution_tpu_torch.utils.mpeg2 import Mpeg2Decoder

    return _shown_frames(Mpeg2Decoder(config), payloads, max_frames, shown)


def _elementary_stream_frames(path: str, container: str, codec: str | None, es: bytes,
                              max_frames: int) -> list[np.ndarray]:
    """The frames of a video elementary stream (a program or transport stream's, or a raw file) decoded as
    ``codec``, a picture a call, so that ``max_frames`` stops the decode."""
    from super_resolution_tpu_torch.utils.mpeg2 import access_units

    decode = {"mpeg2": _mpeg2_frames, "h264": _h264_frames, "mpeg4": _mpeg4_frames}.get(codec)
    if decode is None:
        raise NotImplementedError(f"{path}: {container} video whose elementary stream starts with "
                                  f"{es[:8].hex(' ') or 'nothing'} is not supported by the port's video reader "
                                  "(MPEG-1 / MPEG-2, MPEG-4 Part 2 and H.264 are).")
    return decode(access_units(es, codec), max_frames)


def _program_stream_frames(path: str, data: bytes, max_frames: int) -> list[np.ndarray]:
    from super_resolution_tpu_torch.video.mpegps import read_program_stream

    stream = read_program_stream(data)
    return _elementary_stream_frames(path, "MPEG program stream", stream.codec(), stream.es, max_frames)


def _transport_stream_frames(path: str, data: bytes, max_frames: int) -> list[np.ndarray]:
    from super_resolution_tpu_torch.video.mpegts import packet_size, read_transport_stream

    stream = read_transport_stream(data, packet_size(data[:400]))
    return _elementary_stream_frames(path, "MPEG transport stream", stream.codec(), stream.es, max_frames)


def _shown_frames(decoder, payloads: Iterable[bytes], max_frames: int,
                  shown: list[bool] | None = None) -> list[np.ndarray]:
    """The frames ``decoder`` gives for each payload in turn (none, one or more), then those its ``flush()`` gives at
    the end where it has one; the first ``max_frames`` (0: all), no payload decoded after them. With ``shown`` (default: all kept), a frame is kept
    where the payload that carried it is shown: that of the call that gave it, or where the decoder reorders, the one
    its ``units()`` names. An H.264 B picture comes out a call or more after its own access unit, and FFmpeg drops
    the frame of a packet flagged as discarded, not the frame its call outputs. A frame of the flush that names no
    payload is kept. The order of the frames given so far is settled, so ``max_frames`` cuts as they come."""
    flush, units = getattr(decoder, "flush", None), getattr(decoder, "units", None)
    frames = []
    for i, payload in enumerate(itertools.chain(payloads, [None] * bool(flush))):
        decoded = flush() if payload is None else decoder.decode(payload)
        if shown is not None:
            carried = units() if units else [i] * len(decoded)
            decoded = [frame for frame, unit in zip(decoded, carried) if unit >= len(shown) or shown[unit]]
        frames += decoded
        if max_frames and len(frames) >= max_frames:
            return frames[:max_frames]
    return frames


def _matroska_frames(path: str, data: bytes, max_frames: int) -> list[np.ndarray]:
    from super_resolution_tpu_torch.video import mkv

    video = mkv.read_matroska_video(data)
    codec, config, tag = video.codec_id, video.codec_private, b""
    if codec == "V_MS/VFW/FOURCC":
        tag, bits, config = mkv.bitmap_info_header(config)
        if tag == b"\0\0\0\0" and bits == 24:
            return [_decode_bgr24(p, video.width, -video.height, packed=True)
                    for p in video.frames[:max_frames or None]]
        if tag not in _MPEG4 | _MPEG12 | _MJPEG | _VP8 | _VP9 | _FFV1 | _H264:
            raise NotImplementedError(f"{path}: Matroska V_MS/VFW/FOURCC video {_fourcc_name(tag)} with {bits} bits "
                                      "per pixel is not supported by the port's video reader (MPEG-4 Part 2, MPEG-1 "
                                      "/ MPEG-2, VP8, VP9, FFV1, H.264, Motion-JPEG and uncompressed 24-bit BGR "
                                      "are).")
    if codec in mkv.MPEG4_CODECS or tag in _MPEG4:
        return _mpeg4_frames(video.frames, max_frames, config, codec_tag=tag)
    if codec in mkv.MPEG12_CODECS or tag in _MPEG12:
        return _mpeg2_frames(video.frames, max_frames, config)
    if codec == "V_VP8" or tag in _VP8:
        return _vp8_frames(video.frames, max_frames)
    if codec == "V_VP9" or tag in _VP9:
        return _vp9_frames(video.frames, max_frames)
    if codec == "V_FFV1" or tag in _FFV1:
        return _ffv1_frames(video.frames, max_frames, config, video.width, video.height)
    if codec == "V_MPEG4/ISO/AVC":
        return _h264_frames(video.frames, max_frames, config)
    if tag in _H264:
        return _h264_frames(video.frames, max_frames)
    if codec == "V_MJPEG" or tag in _MJPEG:
        return [_decode_mjpeg(p) for p in video.frames[:max_frames or None]]
    raise NotImplementedError(f"{path}: Matroska / WebM video of {mkv.codec_name(codec)} ({codec}) is not supported "
                              "by the port's video reader (V_MPEG4/ISO/SP|ASP|AP, V_MPEG1, V_MPEG2, V_VP8, V_VP9, "
                              "V_FFV1, V_MPEG4/ISO/AVC, V_MJPEG and V_MS/VFW/FOURCC with an MPEG-4 Part 2, MPEG-1 / "
                              "MPEG-2, VP8, VP9, FFV1, H.264, Motion-JPEG or uncompressed 24-bit code are).")


def _fourcc_name(codec: bytes) -> str:
    name = "uncompressed" if codec == b"\0\0\0\0" else repr(codec.decode("latin-1"))
    if codec.upper() in (b"DIV3", b"MP43", b"MP42", b"MPG4"):
        name += " (Microsoft MPEG-4, another codec than MPEG-4 Part 2)"
    return name


def _mp4_frames(data: bytes, max_frames: int) -> list[np.ndarray]:
    from super_resolution_tpu_torch.video.mp4 import MPEG12_OBJECT_TYPES, MPEG12_SAMPLE_ENTRIES, read_mp4_video

    video = read_mp4_video(data)
    if video.codec == "FFV1":
        return _ffv1_frames(video.samples, max_frames, video.config, video.width, video.height, video.shown)
    if video.codec == "vp09":
        return _vp9_frames(video.samples, max_frames, video.shown)
    if video.codec in ("avc1", "avc3"):
        return _h264_frames(video.samples, max_frames, video.config, video.shown)
    if video.codec in MPEG12_SAMPLE_ENTRIES or video.object_type in MPEG12_OBJECT_TYPES:
        return _mpeg2_frames(video.samples, max_frames, video.config, video.shown)
    return _mpeg4_frames(video.samples, max_frames, video.config, video.shown)


def _mpeg4_frames(payloads: Iterable[bytes], max_frames: int, config: bytes = b"",
                  shown: list[bool] | None = None, codec_tag: bytes = b"",
                  stream_codec_tag: bytes = b"") -> list[np.ndarray]:
    """The frames of an MPEG-4 Part 2 stream's payloads, keeping those of the
    ``shown`` ones (default: all); the container's four-character codes name
    the encoder where the stream does not."""
    from super_resolution_tpu_torch.utils.mpeg4 import Mpeg4Decoder

    return _shown_frames(Mpeg4Decoder(config, codec_tag, stream_codec_tag), payloads, max_frames, shown)


def read_avi_frames(path: str, max_frames: int = 0) -> list[np.ndarray]:
    """The frames of an AVI file as uint8 ``HxWx3`` BGR arrays (all, or the first ``max_frames``)."""
    data = _read(path)
    if not _is_avi(data):
        raise _refuse_container(path, data[:12])
    return _avi_frames(path, data, max_frames)


def _avi_frames(path: str, data: bytes, max_frames: int) -> list[np.ndarray]:
    hdrl = next(((s, e) for fourcc, kind, s, e in _chunks(data, 12, len(data))
                 if fourcc == b"LIST" and kind == b"hdrl"), None)
    if hdrl is None:
        raise ValueError(f"{path}: AVI file without a header list.")
    stream, codec, bits, width, height, handler, config = _video_stream(data, hdrl)
    if codec in _FFV1:
        return _ffv1_frames(_frame_payloads(data, stream, 0), max_frames, config, width, abs(height))
    if codec in _MPEG4:
        return _mpeg4_frames(_frame_payloads(data, stream, 0), max_frames, codec_tag=codec, stream_codec_tag=handler)
    if codec in _MPEG12:
        return _mpeg2_frames(_frame_payloads(data, stream, 0), max_frames, config)
    if codec in _VP8:
        return _vp8_frames(_frame_payloads(data, stream, 0), max_frames)
    if codec in _VP9:
        return _vp9_frames(_frame_payloads(data, stream, 0), max_frames)
    if codec in _H264:
        return _h264_frames(_frame_payloads(data, stream, 0), max_frames)
    if codec in _MJPEG:
        decode = _decode_mjpeg
    elif codec == b"\0\0\0\0" and bits == 24:
        decode = lambda payload: _decode_bgr24(payload, width, height)  # noqa: E731
    else:
        raise NotImplementedError(
            f"{path}: {_fourcc_name(codec)} video with {bits} bits per pixel is not supported by the port's video reader "
            "(MPEG-4 Part 2, MPEG-1 / MPEG-2, VP8, VP9, FFV1, H.264, Motion-JPEG and uncompressed 24-bit BGR "
            "are).")
    return [decode(p) for p in _frame_payloads(data, stream, max_frames)]


def _decode_mjpeg(payload: bytes) -> np.ndarray:
    from super_resolution_tpu_torch.utils.jpeg import decode_jpeg

    frame = decode_jpeg(payload)
    return np.repeat(frame[..., None], 3, axis=-1) if frame.ndim == 2 else frame


def _decode_bgr24(payload: bytes, width: int, height: int, packed: bool = False) -> np.ndarray:
    """An uncompressed BGR24 frame, bottom-up where ``height`` is positive,
    its rows padded to 4 bytes; with ``packed`` (a Matroska track's frames,
    as FFmpeg's raw video decoder takes them) padded where the payload holds
    that many bytes, else packed."""
    rows, stride = abs(height), (width * 3 + 3) & ~3
    if packed and len(payload) < rows * stride:
        stride = width * 3
    if len(payload) < rows * stride:
        raise ValueError(f"Uncompressed frame of {len(payload)} bytes; {width}x{rows} needs {rows * stride}.")
    image = np.frombuffer(payload, dtype=np.uint8, count=rows * stride).reshape(rows, stride)[:, : width * 3]
    if height > 0:  # bottom-up rows
        image = image[::-1]
    return np.ascontiguousarray(image.reshape(rows, width, 3))


CONTAINERS = _containers()


class VideoLoader:
    """Frames of a video or an image directory, as ``[H, W, C]`` tensors in
    ``[0, 1]`` on ``device`` (default ``"cuda"``, which raises without a
    card) in ``dtype``."""

    def __init__(self, device="cuda", dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        self._frames: list[torch.Tensor] = []

    def _place(self, frame: np.ndarray) -> torch.Tensor:
        # Normalised on the host in float64, as the JAX loader does, then placed.
        return torch.from_numpy(frame.astype(np.float64) / 255.0).to(device=self.device, dtype=self.dtype)

    def load_frames_from_video(self, video_path: str, max_frames: int = 0) -> None:
        self._frames = [self._place(frame) for frame in read_video_frames(video_path, max_frames)]

    def load_frames_from_directory(self, directory: str) -> None:
        from super_resolution_tpu_torch.utils.data_loader import load_images

        self._frames = [torch.movedim(img.hidden_array, 0, -1)
                        for img in load_images(directory, device=self.device, dtype=self.dtype)]

    @property
    def num_frames(self) -> int:
        return len(self._frames)

    @property
    def image_size(self) -> tuple[int, int]:
        """(width, height) of the frames."""
        if not self._frames:
            return (0, 0)
        h, w = self._frames[0].shape[:2]
        return (w, h)

    def get_frames(self) -> list[torch.Tensor]:
        return list(self._frames)

    def frame_stack(self) -> torch.Tensor:
        """``[K, C, H, W]`` stack on the loader's device."""
        if not self._frames:
            return torch.zeros((0, 0, 0, 0), dtype=self.dtype, device=self.device)
        return torch.stack([torch.movedim(f, -1, 0) if f.ndim == 3 else f[None] for f in self._frames])

    def play_original_video(self, frame_delay_ms: int = 30) -> list[str]:
        """The JAX loader's headless branch of ``PlayOriginalVideo``
        (``video_loader.cpp:62-77``): each frame resized to the reference's
        1000x600 display size and written as PNG to a new temporary
        directory; returns the paths. The port opens no window
        (``frame_delay_ms`` is kept for the signature)."""
        from super_resolution_tpu_torch.utils.image_io import write_image
        from super_resolution_tpu_torch.utils.visualization import _resize_uint8

        out_dir = tempfile.mkdtemp(prefix="srtpu_video_")
        paths = []
        for i, frame in enumerate(self._frames):
            pixels = (np.clip(frame.detach().cpu().to(torch.float64).numpy(), 0.0, 1.0) * 255).astype(np.uint8)
            if pixels.ndim == 3 and pixels.shape[-1] == 1:  # cv2.resize drops a single channel's axis
                pixels = pixels[..., 0]
            path = os.path.join(out_dir, f"frame_{i:05d}.png")
            write_image(path, _resize_uint8(pixels, _DISPLAY_SIZE))
            paths.append(path)
        if paths:
            print(f"[headless] saved {len(paths)} video frames to {out_dir}")
        return paths
