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

FFmpeg switches to the Xvid IDCT for streams whose user data names Xvid
(or that carry no encoder name in an ``XVID`` AVI); this decoder keeps the
one IDCT that FFmpeg's own encoder (``Lavc`` user data, what OpenCV writes)
reconstructs with, so frames of other encoders can differ from FFmpeg's by
the IDCT's rounding.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Mpeg4Decoder", "Vol", "parse_vol", "start_codes"]

_VOP, _VOL_FIRST, _VOL_LAST = 0xB6, 0x20, 0x2F

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
    b.get(8)  # video_object_type_indication
    verid = 1
    if b.get(1):  # is_object_layer_identifier
        verid = b.get(4)
        b.get(3)
    if b.get(4) == 15:  # aspect_ratio_info: extended PAR
        b.get(16)
    if b.get(1):  # vol_control_parameters
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
    vol = Vol(width, height, time_increment_bits)
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


class Mpeg4Decoder:
    """Decoder state across one stream: the VOL in force and the reference picture."""

    def __init__(self, config: bytes = b""):
        """``config``: headers given outside the payloads (an MP4 ``esds`` DecoderSpecificInfo)."""
        from super_resolution_tpu_torch.native import get_mpeg4_library

        self._lib = get_mpeg4_library()
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
                           vol.quant_type, vol.time_increment_bits], np.int32)
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
