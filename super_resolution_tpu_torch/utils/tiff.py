"""TIFF files, read and written as ``cv2.imread`` / ``cv2.imwrite`` (libtiff) do.

Reading (:func:`read_tiff`) returns what ``cv2.imread(path,
IMREAD_UNCHANGED)`` returns for the file's first page: its dtype (uint8,
int8, uint16, int16, uint32, int32, float32, float64), one channel for grey
and BGR / BGRA for RGB / RGBA. Covered: ``II`` and ``MM`` byte orders,
classic and BigTIFF headers, 1-4 samples a pixel, chunky and planar samples,
strips and tiles, no compression (1), LZW (5), Deflate (8, 32946) and
PackBits (32773), and predictors 1, 2 (horizontal differencing, per sample,
wrapping in the sample's type) and 3 (floating point, byte planes) under LZW
and Deflate (libtiff ignores the tag under the other compressions). The
Orientation tag turns the image as OpenCV does.

OpenCV reads 8-bit files through libtiff's RGBA interface, and the port does
what that gives: min-is-white grey is inverted, a grey file's extra samples
are dropped, and an RGB file whose fourth sample is unassociated alpha
(ExtraSamples 2) comes back premultiplied, ``(v * a + 127) // 255``. Files
that OpenCV reads only through that interface's conversions -- palette,
bilevel, YCbCr, CMYK or CIE Lab, JPEG- or CCITT-compressed -- raise
``NotImplementedError`` naming the feature, as do grey with alpha at more
than 8 bits and planar files at more than 8 bits (OpenCV misreads both) and
more than 4 samples a pixel (OpenCV refuses them). Corrupt data raises
``ValueError``.

Writing (:func:`write_tiff`) does what ``cv2.imwrite`` does for the uint8
grey and BGR images the loaders save: one IFD, LZW with predictor 2, chunky
samples, libtiff's default rows per strip (8192 bytes of pixels a strip), the
tags and their layout as libtiff writes them -- the same bytes as OpenCV's
file.

LZW is C++ (``native/lzw.cpp``, built at first use by
:mod:`super_resolution_tpu_torch.native`); a host without a C++ compiler
raises ``RuntimeError`` on an LZW file. The rest is numpy, ``zlib`` and
``struct``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["read_tiff", "write_tiff"]

# Field types: (struct code, size).
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2),
          9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8), 13: ("I", 4), 16: ("Q", 8), 17: ("q", 8),
          18: ("Q", 8)}
_COMPRESSION_NAMES = {2: "CCITT RLE", 3: "CCITT Group 3 fax", 4: "CCITT Group 4 fax", 6: "old-style JPEG",
                      7: "JPEG", 32809: "ThunderScan", 34676: "SGI LogLuv", 34712: "JPEG 2000", 34887: "LERC",
                      34925: "LZMA", 50000: "ZSTD", 50001: "WebP"}
_PHOTOMETRIC_NAMES = {3: "palette (colour-mapped)", 4: "transparency-mask", 5: "CMYK (separated)", 6: "YCbCr",
                      8: "CIE L*a*b*", 9: "ICC L*a*b*", 10: "ITU L*a*b*", 32844: "LogL", 32845: "LogLuv"}
_DTYPES = {(1, 8): "u1", (2, 8): "i1", (1, 16): "u2", (2, 16): "i2", (1, 32): "u4", (2, 32): "i4", (3, 32): "f4",
           (3, 64): "f8"}


def _unsupported(what: str):
    return NotImplementedError(f"{what} is not supported by the port's TIFF reader.")


def _ifd(data: bytes):
    """The first IFD: (byte order, {tag: tuple of values})."""
    if len(data) < 8 or data[:2] not in (b"II", b"MM"):
        raise ValueError("Not a TIFF file (no II / MM byte order mark).")
    bo = "<" if data[:2] == b"II" else ">"
    (magic,) = struct.unpack(bo + "H", data[2:4])
    if magic == 42:
        (offset,) = struct.unpack(bo + "I", data[4:8])
        count_fmt, entry_fmt, entry_size, inline = "H", "HHI", 12, 4
    elif magic == 43:
        if len(data) < 16 or struct.unpack(bo + "HH", data[4:8]) != (8, 0):
            raise ValueError("Bad BigTIFF header.")
        (offset,) = struct.unpack(bo + "Q", data[8:16])
        count_fmt, entry_fmt, entry_size, inline = "Q", "HHQ", 20, 8
    else:
        raise ValueError(f"Not a TIFF file (version {magic}).")
    head = struct.calcsize(bo + count_fmt)
    if offset + head > len(data):
        raise ValueError("TIFF IFD offset past the end of the file.")
    (n,) = struct.unpack(bo + count_fmt, data[offset:offset + head])
    if offset + head + n * entry_size > len(data):
        raise ValueError("Truncated TIFF IFD.")
    tags = {}
    for i in range(n):
        start = offset + head + i * entry_size
        tag, typ, count = struct.unpack(bo + entry_fmt, data[start:start + struct.calcsize(bo + entry_fmt)])
        if typ not in _TYPES:
            continue  # libtiff ignores fields of unknown types
        code, size = _TYPES[typ]
        field = start + struct.calcsize(bo + entry_fmt)
        if count * size > inline:
            (where,) = struct.unpack(bo + ("Q" if inline == 8 else "I"), data[field:field + inline])
        else:
            where = field
        if where + count * size > len(data):
            raise ValueError(f"TIFF tag {tag}: its values lie past the end of the file.")
        values = struct.unpack(bo + code * count, data[where:where + count * size])
        if typ in (5, 10):
            values = tuple(values[k] / values[k + 1] if values[k + 1] else 0.0 for k in range(0, len(values), 2))
        tags[tag] = values
    return bo, tags


def _packbits_decode(raw: bytes, size: int) -> bytes:
    out, i, n = bytearray(), 0, len(raw)
    while i < n and len(out) < size:
        header = raw[i]
        i += 1
        if header < 128:
            out += raw[i:i + header + 1]
            i += header + 1
        elif header > 128:
            if i >= n:
                break
            out += bytes([raw[i]]) * (257 - header)
            i += 1
    return bytes(out[:size])


def _decompress(raw: bytes, compression: int, size: int) -> bytes:
    if compression == 1:
        out = raw[:size]
    elif compression == 5:
        from super_resolution_tpu_torch import native

        buf = np.empty(size, np.uint8)
        n = native.get_lzw_library().sr_tiff_lzw_decode(raw, len(raw), buf.ctypes.data, size)
        if n == -2:
            raise _unsupported("Old-style (pre-TIFF 6.0) LZW")
        if n < 0:
            raise ValueError("Corrupt TIFF LZW data.")
        out = buf[:n].tobytes()
    elif compression in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, size)
        except zlib.error as err:
            raise ValueError(f"Corrupt TIFF Deflate data: {err}") from None
    elif compression == 32773:
        out = _packbits_decode(raw, size)
    else:
        name = _COMPRESSION_NAMES.get(compression, f"compression {compression}")
        raise _unsupported(f"{name}-compressed TIFF")
    if len(out) < size:
        raise ValueError(f"TIFF strip or tile holds {len(out)} bytes of the {size} it needs.")
    return out


def _undo_predictor(chunk: np.ndarray, predictor: int, dtype: np.dtype) -> np.ndarray:
    """``chunk``: the decoded bytes of one strip or tile, ``[rows, width, spp, bytes]``
    uint8. Returns the samples ``[rows, width, spp]`` in ``dtype`` (native order)."""
    rows, width, spp, size = chunk.shape
    if predictor == 3:  # byte planes (most significant first), each differenced with stride spp
        planes = np.cumsum(chunk.reshape(rows, -1, spp), axis=1, dtype=np.uint8).reshape(rows, size, width * spp)
        big = planes.transpose(0, 2, 1).reshape(rows, width, spp, size)
        return np.ascontiguousarray(big).view(dtype.newbyteorder(">")).reshape(rows, width, spp).astype(dtype)
    samples = np.ascontiguousarray(chunk).view(dtype).reshape(rows, width, spp)
    if predictor == 2:
        unsigned = np.dtype(f"u{size}").newbyteorder(dtype.byteorder)
        acc = np.cumsum(samples.view(unsigned).astype(unsigned.newbyteorder("=")), axis=1,
                        dtype=unsigned.newbyteorder("="))
        return acc.view(dtype.newbyteorder("="))
    return samples.astype(dtype.newbyteorder("="))


_ORIENTATIONS = {
    1: lambda a: a, 2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
    5: lambda a: a.swapaxes(0, 1), 6: lambda a: np.rot90(a, 3), 7: lambda a: a[::-1, ::-1].swapaxes(0, 1),
    8: lambda a: np.rot90(a),
}


def read_tiff(data: bytes) -> np.ndarray:
    """Decode a TIFF file's first page to what ``cv2.imread(..., IMREAD_UNCHANGED)`` returns."""
    bo, tags = _ifd(data)

    def one(tag, default=None):
        values = tags.get(tag)
        if values is None:
            if default is None:
                raise ValueError(f"TIFF without its required tag {tag}.")
            return default
        return values[0]

    width, height = int(one(256)), int(one(257))
    spp = int(one(277, 1))
    bits = tags.get(258, (1,) * spp)
    compression, photometric = int(one(259, 1)), int(one(262, 1 if spp < 3 else 2))
    # libtiff applies the predictor only under the codecs that take one (LZW, Deflate).
    planar, predictor = int(one(284, 1)), int(one(317, 1)) if compression in (5, 8, 32946) else 1
    sample_format = tags.get(339, (1,) * spp)
    if width <= 0 or height <= 0 or spp <= 0:
        raise ValueError(f"TIFF of {width}x{height} with {spp} samples a pixel.")
    if photometric in _PHOTOMETRIC_NAMES:
        raise _unsupported(f"{_PHOTOMETRIC_NAMES[photometric]} TIFF")
    if photometric not in (0, 1, 2):
        raise _unsupported(f"TIFF of photometric interpretation {photometric}")
    if len(set(bits)) != 1 or len(set(sample_format)) != 1:
        raise _unsupported("TIFF whose samples differ in size or format")
    if bits[0] == 1:
        raise _unsupported("Bilevel (1-bit) TIFF")
    key = (int(sample_format[0]) if sample_format[0] in (1, 2, 3) else 1, int(bits[0]))
    if key not in _DTYPES:
        raise _unsupported(f"TIFF with {bits[0]}-bit samples of format {sample_format[0]}")
    if spp > 4:
        raise _unsupported(f"TIFF with {spp} samples a pixel (OpenCV reads 1 to 4)")
    if photometric == 2 and spp < 3:
        raise _unsupported(f"RGB TIFF with {spp} samples a pixel")
    if predictor not in (1, 2, 3) or (predictor == 3 and key[0] != 3):
        raise _unsupported(f"TIFF predictor {predictor} on {key[1]}-bit samples of format {key[0]}")
    dtype = np.dtype(_DTYPES[key]).newbyteorder(bo)
    size = dtype.itemsize
    if size > 1 and planar == 2:
        raise _unsupported("Planar (PlanarConfiguration 2) TIFF with samples wider than 8 bits (OpenCV misreads it)")
    if size > 1 and photometric in (0, 1) and spp > 1:
        raise _unsupported("Grey TIFF with extra samples wider than 8 bits (OpenCV misreads it)")
    orientation = int(one(274, 1))
    if orientation not in _ORIENTATIONS:
        raise ValueError(f"Bad TIFF orientation {orientation}.")

    per_chunk = 1 if planar == 2 else spp
    planes = spp if planar == 2 else 1
    if 322 in tags:  # tiles
        tw, tl = int(one(322)), int(one(323))
        offsets, counts = tags.get(324), tags.get(325)
        across, down = -(-width // tw), -(-height // tl)
        layout = [(p, ty * tl, tx * tw, tl, tw) for p in range(planes) for ty in range(down) for tx in range(across)]
    else:
        rps = min(int(one(278, 2 ** 32 - 1)), height)
        offsets, counts = tags.get(273), tags.get(279)
        strips = -(-height // rps)
        layout = [(p, s * rps, 0, min(rps, height - s * rps), width) for p in range(planes) for s in range(strips)]
    if offsets is None or counts is None or len(offsets) < len(layout) or len(counts) < len(layout):
        raise ValueError("TIFF without its strip / tile offsets and byte counts.")
    image = np.zeros((height, width, spp), dtype.newbyteorder("="))
    for (p, y, x, rows, cols), offset, count in zip(layout, offsets, counts):
        raw = data[int(offset):int(offset) + int(count)]
        chunk = np.frombuffer(_decompress(raw, compression, rows * cols * per_chunk * size), np.uint8)
        samples = _undo_predictor(chunk.reshape(rows, cols, per_chunk, size), predictor, dtype)
        h, w = min(rows, height - y), min(cols, width - x)
        image[y:y + h, x:x + w, p:p + per_chunk] = samples[:h, :w]

    if size == 1:  # OpenCV's 8-bit path: libtiff's RGBA interface, on the bytes as they are
        bytes_ = image.view(np.uint8)
        if photometric in (0, 1):
            bytes_ = bytes_[..., :1]
            if photometric == 0:
                bytes_ = 255 - bytes_
        elif spp == 4 and tags.get(338, (0,))[0] == 2:  # unassociated alpha -> premultiplied
            alpha = bytes_[..., 3:].astype(np.uint32)
            bytes_ = np.concatenate([((bytes_[..., :3] * alpha + 127) // 255).astype(np.uint8), bytes_[..., 3:]], -1)
        image = np.ascontiguousarray(bytes_).view(image.dtype)
    if photometric == 2:
        image = np.concatenate([image[..., 2::-1], image[..., 3:]], axis=-1)
    out = _ORIENTATIONS[orientation](image)
    return np.ascontiguousarray(out[..., 0] if out.shape[-1] == 1 else out)


# --------------------------------------------------------------------------- writing

_STRIP_BYTES = 8192  # libtiff's STRIP_SIZE_DEFAULT


def write_tiff(image) -> bytes:
    """Encode a uint8 ``HxW`` (grey) or ``HxWx3`` (BGR) image as ``cv2.imwrite`` does."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"Expected a uint8 HxW or HxWx3 image, got {img.dtype} {img.shape}.")
    from super_resolution_tpu_torch import native

    height, width = img.shape[:2]
    spp = 1 if img.ndim == 2 else 3
    pixels = (img if spp == 1 else img[..., ::-1]).reshape(height, width * spp)
    row_bytes = width * spp
    rps = min(height, max(1, _STRIP_BYTES // row_bytes))
    # Predictor 2: each sample minus the same sample of the pixel to its left, modulo 256.
    diff = pixels.copy()
    diff[:, spp:] = pixels[:, spp:] - pixels[:, :-spp]
    lzw = native.get_lzw_library()
    strips = []
    for y in range(0, height, rps):
        raw = np.ascontiguousarray(diff[y:y + rps])
        out = np.empty(raw.size * 2 + 64, np.uint8)
        n = lzw.sr_tiff_lzw_encode(raw.ctypes.data, raw.size, out.ctypes.data, out.size)
        if n < 0:
            raise ValueError("TIFF LZW encoding failed.")
        strips.append(out[:n].tobytes())
    offsets, pos = [], 8
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    ifd_offset = pos + (pos & 1)
    counts = [len(s) for s in strips]
    # libtiff: SHORT or LONG by value for sizes; byte counts of several strips
    # as SHORT while a strip's pixels are under 6553 bytes (_WriteAsType).
    short_or_long = lambda v: 3 if v <= 0xFFFF else 4  # noqa: E731
    counts_type = 3 if len(strips) > 1 and rps * row_bytes < 0xFFFF // 10 else 4
    entries = [(256, short_or_long(width), [width]), (257, short_or_long(height), [height]),
               (258, 3, [8] * spp), (259, 3, [5]), (262, 3, [1 if spp == 1 else 2]), (273, 4, offsets),
               (277, 3, [spp]), (278, short_or_long(rps), [rps]), (279, counts_type, counts), (284, 3, [1]),
               (317, 3, [2]), (339, 3, [1] * spp)]
    out_of_line = ifd_offset + 2 + 12 * len(entries) + 4
    fields, extra = {}, b""
    for tag in (258, 279, 273, 339):  # libtiff's order for the values stored after the IFD
        _, typ, values = next(e for e in entries if e[0] == tag)
        payload = struct.pack("<" + _TYPES[typ][0] * len(values), *values)
        if len(payload) > 4:
            fields[tag] = struct.pack("<I", out_of_line + len(extra))
            extra += payload
    ifd = struct.pack("<H", len(entries))
    for tag, typ, values in entries:
        field = fields.get(tag) or struct.pack("<" + _TYPES[typ][0] * len(values), *values).ljust(4, b"\0")
        ifd += struct.pack("<HHI", tag, typ, len(values)) + field
    ifd += struct.pack("<I", 0)
    return (b"II*\0" + struct.pack("<I", ifd_offset) + b"".join(strips) + b"\0" * (ifd_offset - pos) + ifd
            + extra)
