"""MPEG-4 Part 2 video (ISO/IEC 14496-2) decoded as ``cv2.VideoCapture``
decodes it: what ``cv2.VideoWriter`` writes with the ``mp4v`` fourcc (in
.mp4) and with ``XVID`` / ``DIVX`` / ``FMP4`` (in .avi).

:class:`Mpeg4Decoder` takes the stream one container payload at a time (an
MP4 sample, an AVI chunk) and returns its frames as uint8 ``HxWx3`` BGR
arrays. It reads the start-code layer here -- visual object sequence,
visual object, video object layer (VOL), group of VOPs, user data and VOP
headers -- and keeps the reference picture; the macroblocks of each I- and
P-VOP are decoded in C++ (``native/mpeg4_decoder.cpp``, built at first use
by :mod:`super_resolution_tpu_torch.native`; no compiler: ``RuntimeError``),
with FFmpeg's integer IDCT, half-pel rounding and prediction rules as its
x86-64 build computes them (16-bit saturation and products where its SIMD
code departs from its C code), so that the frames equal FFmpeg's, colour
conversion included (swscale's BT.601 limited-range YUV 4:2:0 to BGR24).

Covered: the Simple Profile -- rectangular, progressive, 8-bit I- and
P-VOPs, H.263 and MPEG quantisation (default and loaded matrices), 1MV and
4MV macroblocks, unrestricted vectors, intra macroblocks in P-VOPs, resync
markers and video packets (with header extension). A VOP with
``vop_coded = 0`` gives no frame, as FFmpeg gives none; where the stream
ends with such VOPs, :meth:`Mpeg4Decoder.flush` repeats the last frame once,
as FFmpeg does when it is drained. Raise
``NotImplementedError`` naming the feature: B-VOPs, S-VOPs (sprites, global
motion compensation), quarter-pel motion, interlaced video, data
partitioning and reversible VLC, short-header (H.263) streams, shapes other
than rectangular, and the other rarely written VOL options (complexity
estimation, NEWPRED, reduced-resolution VOPs, scalability, other bit
depths). Corrupt data (an invalid code, a negative intra DC, a video packet
out of place) raises ``ValueError``.

FFmpeg tells encoders apart by the user data (``Lavc``, ``FFmpeg``,
``DivX``, ``XviD`` and their build numbers) and, where no encoder is named,
by the container's four-character code, and so does this decoder
(:class:`Encoder`). A stream taken for Xvid's -- user data ``XviD<build>``,
or no encoder name in a stream tagged ``XVID`` (``XVIX``, ``RMP4``,
``ZMP4``, ``SIPP``), which FFmpeg takes for Xvid build 0 -- is decoded with
FFmpeg's Xvid IDCT as its SSE2 code computes it, as ``cv2.VideoCapture``
does; every other stream with FFmpeg's simple IDCT. FFmpeg's workarounds for
old encoders that change pixels of the streams decoded here are followed:
edges at the picture's size, not the macroblock grid's, for Xvid builds up
to 12, DivX before 5 (and a ``DIVX``-tagged stream with no name and no VOL
control parameters) and FFmpeg builds before 4670 (``FF_BUG_EDGE``); intra
DC predictors left unclipped for Xvid builds up to 32 and FFmpeg builds up
to 4712 (``FF_BUG_DC_CLIP``). Its other workarounds touch only what this
decoder refuses (quarter-pel, B-VOPs, interlaced fields) or, as its padding
detection, only damaged streams.
"""

from __future__ import annotations

import ctypes
import re
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Encoder", "Mpeg4Decoder", "Vol", "idct", "parse_vol", "start_codes"]

_VOP, _VOL_FIRST, _VOL_LAST, _USER_DATA = 0xB6, 0x20, 0x2F, 0xB2
# Flags of sr_mpeg4_decode_vop's params[9].
XVID_IDCT, EDGE_BUG, DC_CLIP_BUG = 1, 2, 4
# Four-character codes whose stream FFmpeg takes for Xvid's where no encoder is named.
_XVID_TAGS = {b"XVID", b"XVIX", b"RMP4", b"ZMP4", b"SIPP"}

# Default quantiser matrices (ISO/IEC 14496-2, 6.3.3), raster order.
DEFAULT_INTRA_MATRIX = np.array([
    8, 17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23, 24, 26, 28, 30,
    21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
    25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45], np.int32)
DEFAULT_INTER_MATRIX = np.array([
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21, 22, 23, 24, 25,
    19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
    22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33], np.int32)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,
    7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


class _Bits:
    """A big-endian bit reader over ``data[start:end]``; reading past the end raises ``ValueError``."""

    def __init__(self, data: bytes, start: int = 0, end: int | None = None):
        self.data, self.pos, self.end = data, start * 8, (len(data) if end is None else end) * 8

    def get(self, n: int) -> int:
        if self.pos + n > self.end:
            raise ValueError("MPEG-4 header ends early.")
        first, last = self.pos >> 3, (self.pos + n + 7) >> 3
        value = int.from_bytes(self.data[first:last], "big")
        value = (value >> (last * 8 - self.pos - n)) & ((1 << n) - 1)
        self.pos += n
        return value

    def marker(self) -> None:
        self.get(1)  # FFmpeg reads past a missing marker bit; so does this reader


def start_codes(data: bytes) -> list[tuple[int, int, int]]:
    """(start code value, first byte after the code, end) of each ``00 00 01 xx`` unit of ``data``."""
    found, pos = [], data.find(b"\x00\x00\x01")
    while 0 <= pos and pos + 3 < len(data):
        found.append((data[pos + 3], pos + 4))
        pos = data.find(b"\x00\x00\x01", pos + 4)
    return [(code, start, found[i + 1][1] - 4 if i + 1 < len(found) else len(data))
            for i, (code, start) in enumerate(found)]


@dataclass
class Vol:
    """The fields of a video object layer header that decoding needs."""

    width: int
    height: int
    time_increment_bits: int
    quant_type: int = 0
    intra_matrix: np.ndarray = field(default_factory=lambda: DEFAULT_INTRA_MATRIX.copy())
    inter_matrix: np.ndarray = field(default_factory=lambda: DEFAULT_INTER_MATRIX.copy())
    resync_marker_disable: int = 1
    vo_type: int = 0  # video_object_type_indication
    vol_control_parameters: int = 0


def _read_matrix(bits: _Bits, default: np.ndarray) -> np.ndarray:
    """A loaded quantiser matrix: up to 64 values in zigzag order, the last repeated after a 0."""
    matrix, last, i = default.copy(), 0, 0
    while i < 64:
        value = bits.get(8)
        if value == 0:
            break
        last = value
        matrix[ZIGZAG[i]] = value
        i += 1
    for j in range(i, 64):
        matrix[ZIGZAG[j]] = last
    return matrix


def _unsupported(feature: str) -> NotImplementedError:
    return NotImplementedError(f"MPEG-4 Part 2 video with {feature} is not supported by the port's decoder "
                               "(the Simple Profile's rectangular, progressive I- and P-VOPs are).")


def parse_vol(data: bytes, start: int = 0, end: int | None = None) -> Vol:
    """The video object layer header whose body (after its start code) is ``data[start:end]``."""
    b = _Bits(data, start, end)
    b.get(1)  # random_accessible_vol
    vo_type = b.get(8)
    verid = 1
    if b.get(1):  # is_object_layer_identifier
        verid = b.get(4)
        b.get(3)
    if b.get(4) == 15:  # aspect_ratio_info: extended PAR
        b.get(16)
    vol_control_parameters = b.get(1)
    if vol_control_parameters:
        if b.get(2) != 1:
            raise _unsupported("a chroma format other than 4:2:0")
        b.get(1)  # low_delay
        if b.get(1):  # vbv_parameters
            for n in (15, 1, 15, 1, 15, 1, 3, 11, 1, 15, 1):
                b.get(n)
    shape = b.get(2)
    if shape != 0:
        raise _unsupported("a non-rectangular shape (binary or grey-scale alpha)")
    b.marker()
    resolution = b.get(16)
    if resolution == 0:
        raise ValueError("MPEG-4 VOL header with a time increment resolution of 0.")
    time_increment_bits = max(1, (resolution - 1).bit_length())
    b.marker()
    if b.get(1):  # fixed_vop_rate
        b.get(time_increment_bits)
    b.marker()
    width = b.get(13)
    b.marker()
    height = b.get(13)
    b.marker()
    if width == 0 or height == 0:
        raise ValueError(f"MPEG-4 VOL header of {width}x{height} pixels.")
    if b.get(1):
        raise _unsupported("interlaced coding")
    b.get(1)  # obmc_disable: FFmpeg decodes without OBMC whatever it says
    if b.get(1 if verid == 1 else 2):
        raise _unsupported("sprites or global motion compensation (S-VOPs)")
    if b.get(1):
        raise _unsupported("a bit depth other than 8 (not_8_bit)")
    vol = Vol(width, height, time_increment_bits, vo_type=vo_type, vol_control_parameters=vol_control_parameters)
    vol.quant_type = b.get(1)
    if vol.quant_type:
        if b.get(1):
            vol.intra_matrix = _read_matrix(b, DEFAULT_INTRA_MATRIX)
        if b.get(1):
            vol.inter_matrix = _read_matrix(b, DEFAULT_INTER_MATRIX)
    if verid != 1 and b.get(1):
        raise _unsupported("quarter-pel motion compensation")
    if not b.get(1):
        raise _unsupported("complexity estimation headers")
    vol.resync_marker_disable = b.get(1)
    if b.get(1):
        raise _unsupported("data partitioning / reversible VLC")
    if verid != 1:
        if b.get(1):
            raise _unsupported("NEWPRED")
        if b.get(1):
            raise _unsupported("reduced-resolution VOPs")
    if b.get(1):
        raise _unsupported("scalability")
    return vol


def _scan_int(text: str, pos: int) -> tuple[int, int] | None:
    """``sscanf``'s ``%d`` at ``text[pos:]``: (value, end), or None."""
    m = re.match(r"\s*([+-]?\d+)", text[pos:])
    return (int(m.group(1)), pos + m.end()) if m else None


def _scan(text: str, pattern: list) -> list[int]:
    """The integers ``sscanf(text, ...)`` assigns, for a pattern of literals (str) and ``%d`` (int)."""
    values, pos = [], 0
    for piece in pattern:
        if isinstance(piece, str):
            if not text.startswith(piece, pos):
                break
            pos += len(piece)
        else:
            found = _scan_int(text, pos)
            if found is None:
                break
            values.append(found[0])
            pos = found[1]
    return values


@dataclass
class Encoder:
    """The encoder FFmpeg's MPEG-4 decoder reads from user data
    (``decode_user_data``): -1 where a field was never named."""

    xvid_build: int = -1
    divx_version: int = -1
    divx_build: int = -1
    lavc_build: int = -1

    def read_user_data(self, data: bytes) -> None:
        """Update from one user data unit's body: up to 255 bytes, ending where
        23 zero bits begin, read as a C string."""
        text = bytearray()
        padded = data + b"\x00\x00\x00"
        for i in range(min(len(data), 255)):
            if padded[i] == 0 and padded[i + 1] == 0 and padded[i + 2] < 2:
                break
            text.append(data[i])
        buf = bytes(text).split(b"\x00", 1)[0].decode("latin-1")
        divx = _scan(buf, ["DivX", 0, "Build", 0])
        if len(divx) < 2:
            divx = _scan(buf, ["DivX", 0, "b", 0])
        if len(divx) == 2:
            self.divx_version, self.divx_build = divx
        build = None
        m = re.match(r"FFmpe[^b]+b", buf)
        if m and _scan_int(buf, m.end()) is not None:
            build = _scan_int(buf, m.end())[0]
        if build is None:
            ffmpeg = _scan(buf, ["FFmpeg v", 0, ".", 0, ".", 0, " / libavcodec build: ", 0])
            build = ffmpeg[3] if len(ffmpeg) == 4 else None
        if build is None:
            lavc = _scan(buf, ["Lavc", 0, ".", 0, ".", 0])
            if len(lavc) == 3:
                build = ((lavc[0] & 0xFF) << 16) + ((lavc[1] & 0xFF) << 8) + (lavc[2] & 0xFF)
        if build is not None:
            self.lavc_build = build
        elif buf == "ffmpeg":
            self.lavc_build = 4600
        xvid = _scan(buf, ["XviD", 0])
        if xvid:
            self.xvid_build = xvid[0]

    def identify(self, vol: Vol, codec_tag: bytes, stream_codec_tag: bytes) -> None:
        """FFmpeg's guesses where no encoder is named (``ff_mpeg4_workaround_bugs``)."""
        unnamed = self.xvid_build == -1 and self.divx_version == -1 and self.lavc_build == -1
        if unnamed and (stream_codec_tag == b"XVID" or codec_tag in _XVID_TAGS):
            self.xvid_build = 0
        elif unnamed and codec_tag == b"DIVX" and vol.vo_type == 0 and vol.vol_control_parameters == 0:
            self.divx_version = 400
        if self.xvid_build >= 0 and self.divx_version >= 0:
            self.divx_version = self.divx_build = -1

    def workarounds(self) -> int:
        """The flags of FFmpeg's workarounds that change this decoder's pixels."""
        flags = 0
        if 0 <= self.xvid_build <= 12 or 0 <= self.divx_version < 500 or 0 <= self.lavc_build < 4670:
            flags |= EDGE_BUG
        if 0 <= self.xvid_build <= 32 or 0 <= self.lavc_build <= 4712:
            flags |= DC_CLIP_BUG
        return flags


def idct(block: np.ndarray, xvid: bool = False) -> np.ndarray:
    """The decoder's IDCT of int16 coefficients ``[..., 8, 8]`` (raster order):
    FFmpeg's simple IDCT, or its Xvid IDCT, as its x86 SIMD code computes
    them; the 16-bit values before pixels are clipped."""
    from super_resolution_tpu_torch.native import get_mpeg4_library

    lib = get_mpeg4_library()
    out = np.ascontiguousarray(block, dtype=np.int16).copy()
    for one in out.reshape(-1, 64):
        lib.sr_mpeg4_idct(one.ctypes.data, int(xvid))
    return out


class Mpeg4Decoder:
    """Decoder state across one stream: the VOL in force, the encoder named, and the reference picture."""

    def __init__(self, config: bytes = b"", codec_tag: bytes = b"", stream_codec_tag: bytes = b""):
        """``config``: headers given outside the payloads (an MP4 ``esds``
        DecoderSpecificInfo, a Matroska ``CodecPrivate``); ``codec_tag`` /
        ``stream_codec_tag``: the container's four-character codes (an AVI
        stream's ``strf`` compression and ``strh`` handler), which FFmpeg
        reads where the stream names no encoder."""
        from super_resolution_tpu_torch.native import get_mpeg4_library

        self._lib = get_mpeg4_library()
        self.codec_tag, self.stream_codec_tag = codec_tag, stream_codec_tag
        self.encoder = Encoder()
        self.workarounds = 0  # sticky, as FFmpeg's workaround_bugs
        self.xvid_idct = False  # once switched, FFmpeg keeps the Xvid IDCT
        self.vol: Vol | None = None
        self._reference: np.ndarray | None = None
        self._last: np.ndarray | None = None
        self._skipped_last = False
        if config:
            self.decode(config)

    def decode(self, payload: bytes) -> list[np.ndarray]:
        """The frames (uint8 ``HxWx3`` BGR) of one payload: one per coded VOP."""
        units = start_codes(payload)
        if not units and len(payload) > 2 and payload[:2] == b"\x00\x00" and payload[2] & 0xFC == 0x80:
            raise _unsupported("short headers (H.263 baseline)")
        frames = []
        for code, start, end in units:
            if _VOL_FIRST <= code <= _VOL_LAST:
                vol = parse_vol(payload, start, end)
                if self.vol is not None and (vol.width, vol.height) != (self.vol.width, self.vol.height):
                    self._reference = None
                self.vol = vol
            elif code == _USER_DATA:
                self.encoder.read_user_data(payload[start:end])
            elif code == _VOP:
                frame = self._decode_vop(payload[:end], start)
                self._skipped_last = frame is None
                if frame is not None:
                    frames.append(frame)
                    self._last = frame
        return frames

    def flush(self) -> list[np.ndarray]:
        """The frames due at the end of the stream: the last one again where the stream ended on uncoded VOPs."""
        repeat = [self._last.copy()] if self._skipped_last and self._last is not None else []
        self._skipped_last = False
        return repeat

    def _decode_vop(self, payload: bytes, start: int) -> np.ndarray | None:
        vol = self.vol
        if vol is None:
            raise ValueError("MPEG-4 VOP before any video object layer header.")
        self.encoder.identify(vol, self.codec_tag, self.stream_codec_tag)
        self.workarounds |= self.encoder.workarounds()
        self.xvid_idct |= self.encoder.xvid_build >= 0
        b = _Bits(payload, start)
        coding_type = b.get(2)
        if coding_type == 2:
            raise _unsupported("B-VOPs (Advanced Simple Profile)")
        if coding_type == 3:
            raise _unsupported("S-VOPs (sprites or global motion compensation)")
        while b.get(1):  # modulo_time_base
            pass
        b.marker()
        b.get(vol.time_increment_bits)
        b.marker()
        if not b.get(1):  # vop_coded = 0: FFmpeg outputs no frame for it
            return None
        rounding = b.get(1) if coding_type == 1 else 0
        intra_dc_vlc_thr = b.get(3)
        quant = b.get(5)
        if quant == 0:
            raise ValueError("MPEG-4 VOP with a quantiser of 0.")
        f_code = 0
        if coding_type == 1:
            f_code = b.get(3)
            if f_code == 0:
                raise ValueError("MPEG-4 P-VOP with fcode 0.")
            if self._reference is None:
                raise ValueError("MPEG-4 P-VOP without a reference VOP before it.")
        mb_w, mb_h = (vol.width + 15) // 16, (vol.height + 15) // 16
        out = np.empty(256 * mb_w * mb_h * 3 // 2, np.uint8)
        params = np.array([vol.width, vol.height, coding_type, quant, f_code, rounding, intra_dc_vlc_thr,
                           vol.quant_type, vol.time_increment_bits,
                           self.workarounds | (XVID_IDCT if self.xvid_idct else 0)], np.int32)
        matrices = np.concatenate([vol.intra_matrix, vol.inter_matrix]).astype(np.int32)
        reference = self._reference if coding_type == 1 else None
        err = ctypes.create_string_buffer(256)
        status = self._lib.sr_mpeg4_decode_vop(
            payload, len(payload), b.pos, params.ctypes.data, matrices.ctypes.data,
            None if reference is None else reference.ctypes.data, out.ctypes.data, err, len(err))
        if status != 0:
            raise ValueError(f"Corrupt MPEG-4 VOP: {err.value.decode()}.")
        self._reference = out
        bgr = np.empty((vol.height, vol.width, 3), np.uint8)
        self._lib.sr_mpeg4_yuv420_to_bgr(out.ctypes.data, mb_w, mb_h, vol.width, vol.height, bgr.ctypes.data)
        return bgr
