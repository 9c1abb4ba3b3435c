"""WebP reading and writing with what ``cv2.imread(path, IMREAD_UNCHANGED)``
returns and what OpenCV's default ``cv2.imwrite`` writes.

Reading (:func:`decode_webp`) returns OpenCV's pixels exactly: uint8 BGR, or
BGRA where the file has alpha (the VP8L header's alpha hint of a lossless
file; the VP8X alpha flag or an ``ALPH`` chunk of a lossy one), as libwebp's
``WebPDecodeBGR`` / ``WebPDecodeBGRA`` give them. Covered:

- the RIFF container: a simple ``VP8 `` or ``VP8L`` file, and the extended
  ``VP8X`` form with an ``ALPH`` chunk; ``ICCP``, ``EXIF``, ``XMP `` and
  unknown chunks are skipped;
- VP8L (lossless): every prefix-code, colour-cache, backward-reference and
  transform feature of the bitstream;
- VP8 (lossy key frames): all of RFC 6386's intra coding, both loop
  filters, then YUV 4:2:0 to BGR through libwebp's "fancy" chroma
  upsampler and its fixed-point conversion;
- ``ALPH``: uncompressed or VP8L-compressed planes with their horizontal,
  vertical and gradient filters.

An animated file (``ANIM`` / ``ANMF``; ``cv2.imread`` gives its first frame
composed on the canvas) raises ``NotImplementedError``; corrupt or truncated
data raises ``ValueError``.

Writing (:func:`encode_webp`): OpenCV writes WebP at its default quality as
*lossless* VP8L (a grey image as BGR), so any valid VP8L file of the same
pixels decodes to what the JAX package's file decodes to. The port's encoder
is a simple one -- subtract-green and predictor transforms, one prefix-code
group, LZ77 with a hash chain -- and its bytes are not libwebp's: the parity
is of pixels, not of bytes.

The bitstreams are decoded and encoded in C++ (``native/webp_decoder.cpp``,
``native/webp_encoder.cpp``, built at first use by
:mod:`super_resolution_tpu_torch.native`; no compiler: ``RuntimeError``).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["decode_webp", "encode_webp"]

_ERRORS = {-1: "the data ends early", -2: "an invalid prefix code", -3: "invalid image data",
           -4: "an invalid or unsupported frame header"}
_ALPHA_FLAG, _ANIMATION_FLAG = 0x10, 0x02


def _chunks(data: bytes) -> list[tuple[bytes, bytes]]:
    """The RIFF chunks of a WebP file, as (FourCC, payload)."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("Not a WebP file (no RIFF / WEBP header).")
    (riff_size,) = struct.unpack("<I", data[4:8])
    if riff_size < 12 or 8 + riff_size > len(data):
        raise ValueError(f"WebP file is truncated: its RIFF header promises {riff_size + 8} bytes, "
                         f"the file holds {len(data)}.")
    chunks, pos, end = [], 12, 8 + riff_size
    while pos + 8 <= end:
        fourcc = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        if pos + 8 + size > end:
            raise ValueError(f"WebP chunk {fourcc!r} at byte {pos} runs past the end of the file.")
        chunks.append((fourcc, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    if not chunks:
        raise ValueError("WebP file without chunks.")
    return chunks


def _check(status: int, what: str) -> None:
    if status != 0:
        raise ValueError(f"Cannot decode WebP {what}: {_ERRORS.get(status, f'status {status}')}.")


def _vp8l_size(payload: bytes) -> tuple[int, int, bool]:
    """(width, height, alpha hint) from a VP8L header."""
    if len(payload) < 5 or payload[0] != 0x2F:
        raise ValueError("Invalid VP8L header (no 0x2f signature).")
    (bits,) = struct.unpack("<I", payload[1:5])
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)


def _vp8_size(payload: bytes) -> tuple[int, int]:
    if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError("Invalid VP8 frame header (no key-frame start code).")
    width, height = struct.unpack("<HH", payload[6:10])
    return width & 0x3FFF, height & 0x3FFF


def _decode_vp8l(lib, payload: bytes, width: int, height: int, header: bool, what: str) -> np.ndarray:
    """A VP8L image stream as ``[height, width, 4]`` BGRA bytes."""
    argb = np.empty(width * height, np.uint32)
    _check(lib.sr_vp8l_decode(payload, len(payload), width, height, int(header), argb.ctypes.data), what)
    return argb.view(np.uint8).reshape(height, width, 4)  # little-endian ARGB words are B, G, R, A bytes


def _decode_alpha(lib, payload: bytes, width: int, height: int) -> np.ndarray:
    """An ``ALPH`` chunk's plane, unfiltered (``[height, width]`` uint8)."""
    if not payload:
        raise ValueError("Empty WebP ALPH chunk.")
    head = payload[0]
    method, filtering, preprocessing = head & 3, (head >> 2) & 3, (head >> 4) & 3
    if method > 1 or preprocessing > 1 or head >> 6:
        raise ValueError(f"Invalid WebP ALPH header 0x{head:02x}.")
    if method == 0:
        if len(payload) - 1 < width * height:
            raise ValueError("WebP ALPH chunk is truncated.")
        alpha = np.frombuffer(payload, np.uint8, width * height, 1).reshape(height, width).copy()
    else:
        alpha = np.ascontiguousarray(_decode_vp8l(lib, payload[1:], width, height, False, "ALPH data")[..., 1])
    if filtering:
        lib.sr_webp_unfilter_alpha(alpha.ctypes.data, width, height, filtering)
    return alpha


def decode_webp(data: bytes) -> np.ndarray:
    """Decode WebP bytes to what ``cv2.imread(..., IMREAD_UNCHANGED)`` returns."""
    from super_resolution_tpu_torch import native

    data = bytes(data)
    chunks = _chunks(data)
    canvas = None
    alpha_flag = False
    if chunks[0][0] == b"VP8X":
        head = chunks[0][1]
        if len(head) < 10:
            raise ValueError("WebP VP8X chunk is truncated.")
        if head[0] & _ANIMATION_FLAG or any(fourcc in (b"ANIM", b"ANMF") for fourcc, _ in chunks):
            raise NotImplementedError(
                "Animated WebP (ANIM / ANMF chunks) is not supported by the port's WebP decoder; cv2.imread "
                "returns its first frame composed on the canvas. Still VP8 / VP8L files are supported.")
        alpha_flag = bool(head[0] & _ALPHA_FLAG)
        canvas = (int.from_bytes(head[4:7], "little") + 1, int.from_bytes(head[7:10], "little") + 1)
    elif chunks[0][0] not in (b"VP8 ", b"VP8L"):
        raise ValueError(f"WebP file whose first chunk is {chunks[0][0]!r} (VP8, VP8L or VP8X expected).")
    image = next(((fourcc, payload) for fourcc, payload in chunks if fourcc in (b"VP8 ", b"VP8L")), None)
    if image is None:
        raise ValueError("WebP file without a VP8 or VP8L chunk.")
    alph = next((payload for fourcc, payload in chunks if fourcc == b"ALPH"), None)
    lib = native.get_webp_library()
    fourcc, payload = image
    if fourcc == b"VP8L":
        width, height, has_alpha = _vp8l_size(payload)
    else:
        width, height = _vp8_size(payload)
        has_alpha = alpha_flag or alph is not None
    if canvas is not None and canvas != (width, height):
        raise ValueError(f"WebP canvas {canvas[0]}x{canvas[1]} differs from its image {width}x{height}.")
    if fourcc == b"VP8L":
        bgra = _decode_vp8l(lib, payload, width, height, True, "VP8L data")
        return bgra.copy() if has_alpha else np.ascontiguousarray(bgra[..., :3])
    out = np.empty((height, width, 4 if has_alpha else 3), np.uint8)
    _check(lib.sr_vp8_decode(payload, len(payload), width, height, out.ctypes.data, out.shape[2]), "VP8 data")
    if has_alpha:
        out[..., 3] = 255 if alph is None else _decode_alpha(lib, alph, width, height)
    return out


def encode_webp(image) -> bytes:
    """Encode a uint8 ``HxW`` (grey, written as BGR) or ``HxWx3`` (BGR) image as lossless WebP."""
    from super_resolution_tpu_torch import native

    img = np.asarray(image)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"Expected a uint8 HxW or HxWx3 image, got {img.dtype} {img.shape}.")
    height, width = img.shape[:2]
    if not (1 <= width <= 16384 and 1 <= height <= 16384):
        raise ValueError(f"WebP images are 1 to 16384 pixels a side, not {width}x{height}.")
    bgr = np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img
    argb = np.empty((height, width, 4), np.uint8)
    argb[..., :3], argb[..., 3] = bgr, 255
    argb = argb.view(np.uint32).reshape(-1)
    capacity = 4 * argb.size + 4096
    out = np.empty(capacity, np.uint8)
    n = native.get_webp_encoder_library().sr_vp8l_encode(argb.ctypes.data, width, height, out.ctypes.data, capacity)
    if n <= 0:
        raise RuntimeError(f"VP8L encoding failed (status {n}).")
    payload = out[:n].tobytes() + (b"\x00" if n & 1 else b"")
    return b"RIFF" + struct.pack("<I", 12 + len(payload)) + b"WEBP" + b"VP8L" + struct.pack("<I", n) + payload
