"""Image files, read and written with the standard library, numpy and the
port's native codecs.

The JAX package reads and writes images through OpenCV (``cv2.imread`` /
``cv2.imwrite``). The port keeps its own codecs instead and returns what
``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` returns for the same file: the
same dtype, the same channel count and the same BGR / BGRA channel order;
and it writes the file ``cv2.imwrite`` writes for the uint8 ``HxW`` /
``HxWx3`` (BGR) images the loaders save.

PNG, read: colour types 0 (grey), 2 (RGB), 3 (palette), 4 (grey + alpha)
and 6 (RGBA) at every bit depth PNG allows them, the five row filters and
Adam7 interlacing. As OpenCV does, grey below 8 bits is scaled to 0-255,
a palette is expanded to BGR (BGRA when the file has a ``tRNS`` chunk),
grey + alpha becomes BGRA, an RGB file with a ``tRNS`` colour gains an alpha
channel that is 0 on that colour, and a grey file's ``tRNS`` is ignored.
PNG, written: uint8 ``HxW`` (grey) and ``HxWx3`` (BGR), every row with
filter 0.

BMP (uncompressed), read: 8 bit with a palette (one channel when every
palette entry is grey, else BGR), 24 bit and 32 bit (BGR: OpenCV drops the
fourth byte). Written: 24 bit for ``HxWx3`` and 8 bit with a grey palette for
``HxW``, as ``cv2.imwrite`` does.

JPEG (:mod:`super_resolution_tpu_torch.utils.jpeg`): sequential and
progressive Huffman JPEG read bit-equal to OpenCV's libjpeg-turbo decode;
written byte-equal to ``cv2.imwrite`` (quality 95, 4:2:0).
TIFF (:mod:`super_resolution_tpu_torch.utils.tiff`): read as OpenCV's
libtiff reads it (strips and tiles, chunky and planar, uncompressed, LZW,
Deflate and PackBits, the three predictors, 8 to 64-bit samples; and
through libtiff's RGBA interface JPEG-compressed files -- GDAL's tiled 4:2:0
YCbCr GeoTIFFs with shared JPEGTables among them --, YCbCr in data units,
palette at 1, 4 and 8 bits and bilevel); written as ``cv2.imwrite`` writes
it (LZW, predictor 2).
GIF (:mod:`super_resolution_tpu_torch.utils.gif`): the first frame read as
OpenCV's GIF decoder composes it.
WebP (:mod:`super_resolution_tpu_torch.utils.webp`): lossless (VP8L) and
lossy (VP8) files, with or without alpha, read as OpenCV's libwebp decodes
them; written as lossless VP8L, as ``cv2.imwrite`` writes WebP at its
default quality. The port's encoder is not libwebp's, so its bytes differ
from OpenCV's file: what is held equal is the pixels both files decode to
(through ``cv2.imdecode`` and through this decoder), not the bytes.
JPEG 2000 (:mod:`super_resolution_tpu_torch.utils.jpeg2000`): JP2 files
and raw codestreams (5/3 and 9/7, every Part 1 progression, layer, precinct
and tile layout) read as OpenCV's OpenJPEG decodes them; written byte-equal
to ``cv2.imwrite`` (OpenJPEG 2.5.3's encoder: 5/3, one rate-allocated layer
at OpenCV's default rate). One deliberate difference: an image with a side
below 32 pixels raises ``ValueError``, where ``cv2.imwrite`` returns
``False`` and the JAX ``save_image``, which ignores that, writes no file and
says nothing.
Writing GIF raises ``NotImplementedError`` with the format's name; so does
an animated WebP.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = ["IMAGE_EXTENSIONS", "read_image", "write_image", "read_png", "write_png", "read_bmp", "write_bmp"]

_CODECS = {".png": "PNG", ".bmp": "BMP", ".jpg": "JPEG", ".jpeg": "JPEG", ".tif": "TIFF", ".tiff": "TIFF",
           ".gif": "GIF", ".webp": "WebP", ".jp2": "JPEG 2000"}
# Why each read-only format is not written: another encoder would write other pixels than OpenCV's file holds.
_READ_ONLY = {".gif": ("GIF", "OpenCV quantises the colours with a quantiser of its own")}
# Every extension the JAX loader reads as an image (``data_loader.py:22-24``).
IMAGE_EXTENSIONS = frozenset(_CODECS)

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x start, y start, x step, y step).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _extension(path: str, writing: bool) -> str:
    ext = os.path.splitext(path)[1].lower()
    if writing and ext in _READ_ONLY:
        name, why = _READ_ONLY[ext]
        raise NotImplementedError(
            f"Writing {name} files ({ext}) is not supported by the port's image codecs (reading is): "
            f"{why}; write PNG, BMP, JPEG, TIFF, WebP or JPEG 2000.")
    if ext not in _CODECS:
        raise ValueError(f"{path}: not an image extension these codecs know ({ext!r}).")
    return _CODECS[ext]


def read_image(path: str) -> np.ndarray:
    """An image file as ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` gives it."""
    kind = _extension(path, writing=False)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"Could not read image {path}")
    with open(path, "rb") as f:
        data = f.read()
    if kind == "JPEG":
        from super_resolution_tpu_torch.utils.jpeg import decode_jpeg

        return decode_jpeg(data)
    if kind == "TIFF":
        from super_resolution_tpu_torch.utils.tiff import read_tiff

        return read_tiff(data)
    if kind == "GIF":
        from super_resolution_tpu_torch.utils.gif import read_gif

        return read_gif(data)
    if kind == "WebP":
        from super_resolution_tpu_torch.utils.webp import decode_webp

        return decode_webp(data)
    if kind == "JPEG 2000":
        from super_resolution_tpu_torch.utils.jpeg2000 import decode_jpeg2000

        return decode_jpeg2000(data)
    return read_png(data) if kind == "PNG" else read_bmp(data)


def write_image(path: str, image: np.ndarray) -> None:
    """Write a uint8 ``HxW`` or ``HxWx3`` (BGR) image as PNG, BMP, JPEG, TIFF, WebP or JPEG 2000, by
    extension."""
    kind = _extension(path, writing=True)
    if kind == "JPEG":
        from super_resolution_tpu_torch.utils.jpeg import encode_jpeg

        data = encode_jpeg(image)
    elif kind == "TIFF":
        from super_resolution_tpu_torch.utils.tiff import write_tiff

        data = write_tiff(image)
    elif kind == "WebP":
        from super_resolution_tpu_torch.utils.webp import encode_webp

        data = encode_webp(image)
    elif kind == "JPEG 2000":
        from super_resolution_tpu_torch.utils.jpeg2000 import encode_jpeg2000

        data = encode_jpeg2000(image)
    else:
        data = write_png(image) if kind == "PNG" else write_bmp(image)
    with open(path, "wb") as f:
        f.write(data)


# --------------------------------------------------------------------------- PNG


def _chunks(data: bytes):
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("Not a PNG file (bad signature).")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC.")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG file ends without an IEND chunk.")


def _unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of one (sub-)image: ``raw`` is ``rows`` x
    (1 + ``stride``) bytes, each row led by its filter type.

    Each reconstructed byte depends on the byte ``bpp`` to its left, the one
    above and the one above-left, so the anti-diagonals of the grid of
    ``bpp``-byte units are independent: they are computed one after another,
    every unit on one of them at once, for whatever filter its row uses.
    """
    grid = raw.reshape(rows, stride + 1)
    kinds = grid[:, 0].astype(np.int64)
    if np.any(kinds > 4):
        raise ValueError(f"Unknown PNG filter type {int(kinds.max())}.")
    units = stride // bpp
    filt = grid[:, 1:].reshape(rows, units, bpp).astype(np.int64)
    if np.all(kinds == 0):
        return filt.reshape(rows, stride).astype(np.uint8)
    recon = np.zeros((rows + 1, units + 1, bpp), dtype=np.int64)  # a zero row above, a zero unit to the left
    for d in range(rows + units - 1):
        r = np.arange(max(0, d - units + 1), min(rows - 1, d) + 1)
        j = d - r
        a, b, c = recon[r + 1, j], recon[r, j + 1], recon[r, j]  # left, up, up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        kind = kinds[r][:, None]
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4], [a, b, (a + b) >> 1, paeth], 0)
        recon[r + 1, j + 1] = (filt[r, j] + pred) & 0xFF
    return recon[1:, 1:].reshape(rows, stride).astype(np.uint8)


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows -> ``[h, width, channels]`` samples (uint8 / uint16)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, : width * channels].reshape(h, width, channels)
    if depth == 16:
        return rows[:, : width * channels * 2].reshape(h, -1).view(">u2").astype(np.uint16).reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, : width * channels * depth].reshape(h, width * channels, depth)
    values = (bits.astype(np.uint16) << np.arange(depth - 1, -1, -1, dtype=np.uint16)).sum(axis=-1)
    return values.astype(np.uint8).reshape(h, width, channels)


def read_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes to what ``cv2.imread(..., IMREAD_UNCHANGED)`` returns."""
    header = palette = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError("PNG file without an IHDR chunk or without image data.")
    width, height, depth, color, compression, filter_method, interlace = header
    if color not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[color]:
        raise ValueError(f"Invalid PNG colour type {color} with bit depth {depth}.")
    if compression != 0 or filter_method != 0 or interlace not in (0, 1):
        raise ValueError("Unknown PNG compression, filter method or interlace method.")
    channels = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    bpp = max(1, channels * depth // 8)
    samples = np.zeros((height, width, channels), dtype=np.uint16 if depth == 16 else np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-(pw * channels * depth) // 8)
        size = ph * (stride + 1)
        if pos + size > raw.size:
            raise ValueError("PNG image data is truncated.")
        rows = _unfilter(raw[pos:pos + size], ph, stride, bpp)
        samples[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
        pos += size
    return _as_opencv(samples, color, depth, palette, trns)


def _as_opencv(samples: np.ndarray, color: int, depth: int, palette, trns) -> np.ndarray:
    """Samples in the file's layout -> OpenCV's layout (see the module docstring)."""
    if color == 0:
        grey = samples[..., 0]
        if depth < 8:
            grey = grey * np.uint8(255 // ((1 << depth) - 1))
        return grey
    if color == 3:
        if palette is None:
            raise ValueError("Palette PNG without a PLTE chunk.")
        index = samples[..., 0]
        if int(index.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index out of range.")
        bgr = palette[index][..., ::-1]
        if not trns:
            return np.ascontiguousarray(bgr)
        alpha = np.full(256, 255, dtype=np.uint8)
        alpha[: len(trns)] = np.frombuffer(trns, dtype=np.uint8)[:256]
        return np.concatenate([bgr, alpha[index][..., None]], axis=-1)
    if color == 4:
        grey, alpha = samples[..., :1], samples[..., 1:]
        return np.concatenate([grey, grey, grey, alpha], axis=-1)
    bgr = samples[..., 2::-1]
    if color == 6:
        return np.concatenate([bgr, samples[..., 3:]], axis=-1)
    if trns:  # colour type 2: one transparent colour
        key = np.asarray(struct.unpack(">HHH", trns[:6]), dtype=samples.dtype)
        full = np.iinfo(samples.dtype).max
        alpha = np.where(np.all(samples == key, axis=-1), 0, full).astype(samples.dtype)
        return np.concatenate([bgr, alpha[..., None]], axis=-1)
    return np.ascontiguousarray(bgr)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _uint8_image(image) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"Expected a uint8 HxW or HxWx3 image, got {img.dtype} {img.shape}.")
    return img


def write_png(image) -> bytes:
    """Encode a uint8 ``HxW`` (grey) or ``HxWx3`` (BGR) image as PNG bytes."""
    img = _uint8_image(image)
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    pixels = img if img.ndim == 2 else img[..., ::-1]
    rows = np.concatenate([np.zeros((h, 1), dtype=np.uint8), pixels.reshape(h, -1)], axis=1)
    return (_PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


# --------------------------------------------------------------------------- BMP


def read_bmp(data: bytes) -> np.ndarray:
    """Decode an uncompressed 8 / 24 / 32 bit BMP as OpenCV does."""
    if data[:2] != b"BM" or len(data) < 54:
        raise ValueError("Not a BMP file.")
    (offset,) = struct.unpack("<I", data[10:14])
    header_size, width, height, planes, bits, compression = struct.unpack("<IiiHHI", data[14:34])
    if header_size < 40:
        raise NotImplementedError(f"BMP with a {header_size}-byte header (OS/2) is not supported.")
    if compression != 0:
        raise NotImplementedError(f"Compressed BMP (compression {compression}) is not supported.")
    if bits not in (8, 24, 32):
        raise NotImplementedError(f"{bits}-bit BMP is not supported (8, 24 and 32 bit are).")
    h, top_down = abs(height), height < 0
    stride = (width * bits // 8 + 3) & ~3
    if offset + stride * h > len(data):
        raise ValueError("BMP pixel data is truncated.")
    rows = np.frombuffer(data, dtype=np.uint8, count=stride * h, offset=offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bits == 8:
        (used,) = struct.unpack("<I", data[46:50])
        count = used or 256
        if count > 256:
            raise ValueError(f"BMP palette of {count} entries; 8-bit files have at most 256.")
        start = 14 + header_size
        palette = np.zeros((256, 4), dtype=np.uint8)
        palette[:count] = np.frombuffer(data, dtype=np.uint8, count=4 * count, offset=start).reshape(count, 4)
        index = rows[:, :width]
        grey = np.all(palette[:, 0:1] == palette[:, 1:3], axis=None)
        return np.ascontiguousarray(palette[index, 0] if grey else palette[index, :3])
    n = bits // 8
    return np.ascontiguousarray(rows[:, : width * n].reshape(h, width, n)[..., :3])


def write_bmp(image) -> bytes:
    """Encode a uint8 ``HxWx3`` (BGR, 24 bit) or ``HxW`` (8 bit, grey palette) image."""
    img = _uint8_image(image)
    h, w = img.shape[:2]
    n = 1 if img.ndim == 2 else 3
    stride = (w * n + 3) & ~3
    palette = b"" if n == 3 else np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4).copy()
    if n == 1:
        palette[:, 3] = 0
        palette = palette.tobytes()
    pixels = np.zeros((h, stride), dtype=np.uint8)
    pixels[:, : w * n] = img.reshape(h, -1)
    offset = 54 + len(palette)
    file_header = struct.pack("<2sIHHI", b"BM", offset + pixels.size, 0, 0, offset)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8 * n, 0, pixels.size, 0, 0, 256 if n == 1 else 0, 0)
    return file_header + info + palette + pixels[::-1].tobytes()
