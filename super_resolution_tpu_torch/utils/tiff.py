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
are dropped, an RGB file whose fourth sample is unassociated alpha
(ExtraSamples 2) comes back premultiplied, ``(v * a + 127) // 255``, and in
a tiled file the mirror of orientations 2, 3, 6 and 7 turns each tile in
place. Through that interface the reader also takes:

- JPEG compression (7), strips and tiles, each its own JPEG frame read
  after the JPEGTables stream (tag 347) where there is one, as libtiff's
  codec feeds libjpeg: YCbCr (photometric 6, any YCbCrSubsampling the frames
  hold) converted to RGB by libjpeg-turbo's arithmetic, its fancy upsampling
  at each frame's own edges (:mod:`.jpeg`); RGB (2) and grey (1, 0) without
  a colour transform; edge tiles cropped, a last strip's taller frame too;
- YCbCr without JPEG (1x1, 2x1, 1x2, 2x2, 4x1, 4x2; planar at 1x1): data
  units of Y samples then Cb and Cr, chroma replicated over its unit,
  converted by libtiff's integer tables with ReferenceBlackWhite (532) and
  YCbCrCoefficients (529);
- palette (3) at 1, 4 and 8 bits, the ColorMap taken as 8-bit where every
  entry is below 256 and by its high bytes otherwise (BGR; a 1-bit palette
  comes back as the grey OpenCV makes of the colours, one channel);
- bilevel grey (1 bit, min-is-black or min-is-white) as 0 / 255.

Where ``cv2.imread`` returns None for such a file -- 2- and 4-bit grey,
2-bit palette, 1x4 / 2x4 subsampling, planar subsampled YCbCr, a predictor
on 1-bit samples, JPEG frames whose sampling factors or size libtiff
refuses -- the reader raises ``ValueError``. CMYK, CIE L*a*b* (all three),
CCITT (2, 3, 4), old-style JPEG (6), JPEG with extra samples or planar
samples, YCbCr at 4x4 (libtiff's RGBA interface misreads it), grey with
alpha at more than 8 bits and planar files at more than 8 bits (OpenCV
misreads both) and more than 4 samples a pixel (OpenCV refuses them) raise
``NotImplementedError`` naming the layout. Corrupt data raises
``ValueError``.

Writing (:func:`write_tiff`) does what ``cv2.imwrite`` does for the uint8
grey and BGR images the loaders save: one IFD, LZW with predictor 2, chunky
samples, libtiff's default rows per strip (8192 bytes of pixels a strip), the
tags and their layout as libtiff writes them -- the same bytes as OpenCV's
file.

LZW is C++ (``native/lzw.cpp``) and JPEG's entropy decoding too
(``native/jpeg_decoder.cpp``), each built at first use by
:mod:`super_resolution_tpu_torch.native`; a host without a C++ compiler
raises ``RuntimeError`` on an LZW or a JPEG-compressed file. The rest is
numpy, ``zlib`` and ``struct``.
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
                      32809: "ThunderScan", 34676: "SGI LogLuv", 34712: "JPEG 2000", 34887: "LERC",
                      34925: "LZMA", 50000: "ZSTD", 50001: "WebP"}
_DTYPES = {(1, 8): "u1", (2, 8): "i1", (1, 16): "u2", (2, 16): "i2", (1, 32): "u4", (2, 32): "i4", (3, 32): "f4",
           (3, 64): "f8"}


# What OpenCV 5.0.0 (libtiff 4.7) does with the layouts the port still refuses, as probed.
_CV2_READS = "OpenCV reads it through libtiff's RGBA interface"
# The photometric interpretations refused by name: (name, what OpenCV does).
_REFUSED_PHOTOMETRIC = {4: ("transparency-mask", "OpenCV returns None"),
                        5: ("CMYK (separated)", "OpenCV reads it as 4 channels"), 8: ("CIE L*a*b*", _CV2_READS),
                        9: ("ICC L*a*b*", "OpenCV returns None"), 10: ("ITU L*a*b*", "OpenCV returns None"),
                        32844: ("LogL", "OpenCV returns None"), 32845: ("LogLuv", "OpenCV returns None")}


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
    else:  # PackBits (32773): read_tiff refuses the other compressions first
        out = _packbits_decode(raw, size)
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


def _chunks(data: bytes, tags, one, width: int, height: int, planes: int):
    """The strips or tiles: [(plane, y, x, rows, cols, stored bytes)], ``rows x cols`` the chunk's full size
    (a tile's, past the image at its edges; a strip's, cut at the image's end)."""
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
    return [(*where, data[int(offset):int(offset) + int(count)])
            for where, offset, count in zip(layout, offsets, counts)]


def _place(image: np.ndarray, y: int, x: int, block: np.ndarray) -> None:
    """Copy the part of a decoded chunk that lies inside ``image``."""
    h, w = min(block.shape[0], image.shape[0] - y), min(block.shape[1], image.shape[1] - x)
    image[y:y + h, x:x + w] = block[:h, :w]


def _unpack(chunk: bytes, rows: int, cols: int, bits: int) -> np.ndarray:
    """Sub-byte samples, most significant first, each row padded to a whole byte -> ``[rows, cols]`` uint8."""
    stride = -(-cols * bits // 8)
    packed = np.frombuffer(chunk, np.uint8, rows * stride).reshape(rows, stride)
    per_byte = 8 // bits
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    values = (packed[..., None] >> shifts) & np.uint8((1 << bits) - 1)
    return values.reshape(rows, stride * per_byte)[:, :cols]


def _read_jpeg(data, tags, one, width, height, spp, photometric, planar):
    """Compression 7 as libtiff's JPEG codec hands it to the RGBA interface
    (``tif_jpeg.c``): each strip or tile its own JPEG frame, read after the
    ``JPEGTables`` stream (tag 347), YCbCr converted to RGB by libjpeg (its
    fancy upsampling inside the frame), RGB and grey without a transform.
    Returns ``HxWxC`` uint8 (C: 1 grey, 3 B, G, R)."""
    from super_resolution_tpu_torch.utils.jpeg import decode_jpeg_frames, jpeg_coefficients

    if planar == 2:
        raise _unsupported(f"Planar (PlanarConfiguration 2) JPEG-compressed TIFF ({_CV2_READS})")
    components = 1 if photometric in (0, 1) else 3
    if spp > components:
        raise _unsupported(f"JPEG-compressed TIFF with extra samples ({_CV2_READS})")
    if spp < components:
        raise ValueError(f"JPEG-compressed TIFF of photometric {photometric} with {spp} samples a pixel.")
    tables = bytes(tags.get(347, ()))
    if tables.endswith(b"\xff\xd9"):
        tables = tables[:-2]
    chunks = _chunks(data, tags, one, width, height, 1)
    frames = []
    for _, _, _, _, _, raw in chunks:
        # libtiff reads the tables-only stream first, then the chunk's abbreviated stream: one stream spliced.
        stream = tables + raw[2:] if tables[:2] == b"\xff\xd8" and raw[:2] == b"\xff\xd8" else raw
        frames.append(jpeg_coefficients(stream))
    # JPEGPreDecode: component 0 at the YCbCrSubsampling factors (read from the first frame where the tag
    # is absent, as JPEGFixupTags does), the others at 1x1.
    if photometric == 6:
        expected = tuple(int(v) for v in tags.get(530, (frames[0][0].h[0], frames[0][0].v[0])))
    else:
        expected = (1, 1)
    tiled = 322 in tags
    for k, ((_, y, _, rows, cols, _), (info, _)) in enumerate(zip(chunks, frames)):
        n = info.num_components
        if n != components:
            raise ValueError(f"TIFF JPEG frame {k} has {n} components, not {components}.")
        factors = [(info.h[c], info.v[c]) for c in range(n)]
        if factors[0] != expected or any(f != (1, 1) for f in factors[1:]):
            raise ValueError(f"TIFF JPEG frame {k} has sampling factors {factors}; libtiff wants {expected} for "
                             "its first component and 1x1 for the others.")
        # A last strip may be taller than the rows left; any other frame of another size libtiff refuses
        # (larger) or reads only in part (smaller).
        taller_last_strip = not tiled and y + rows == height and info.width == cols and info.height > rows
        if (info.width, info.height) != (cols, rows) and not taller_last_strip:
            raise ValueError(f"TIFF JPEG frame {k} is {info.width}x{info.height}, its "
                             f"{'tile' if tiled else 'strip'} {cols}x{rows}.")
    decoded = decode_jpeg_frames(frames, rgb=photometric != 6)
    image = np.zeros((height, width, components), np.uint8)
    for (_, y, x, _, _, _), pixels in zip(chunks, decoded):
        _place(image, y, x, pixels.reshape(*pixels.shape[:2], -1))
    return image


_YCBCR_SUBSAMPLING = {(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2)}  # libtiff's putcontig8bitYCbCr*tile


def _ycbcr_to_rgb(y, cb, cr, tags):
    """libtiff's TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB (``tif_color.c``) in its
    float32 and 16-bit fixed-point arithmetic, with YCbCrCoefficients (529)
    and ReferenceBlackWhite (532) or their defaults."""
    f32 = np.float32
    luma = [f32(v) for v in tags.get(529, (0.299, 0.587, 0.114))]
    rbw = [f32(v) for v in tags.get(532, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0))]
    if len(luma) != 3 or len(rbw) != 6 or not all(np.isfinite(luma)) or luma[1] == 0:
        raise ValueError("TIFF with invalid YCbCrCoefficients or ReferenceBlackWhite.")
    if not all(f32(-0x7FFFFFFF + 128) < v < f32(0x7FFFFFFF) for v in rbw):
        raise ValueError("TIFF with ReferenceBlackWhite values out of range.")

    def fix(v):  # FIX(CLAMP(v, 0, 2)): float * 2**16 + 0.5, truncated
        return int(float(f32(min(max(v, f32(0)), f32(2))) * f32(65536)) + 0.5)

    f1 = f32(2) - f32(2) * luma[0]
    f3 = f32(2) - f32(2) * luma[2]
    d1, d2 = fix(f1), -fix(luma[0] * f1 / luma[1])
    d3, d4 = fix(f3), -fix(luma[2] * f3 / luma[1])

    def code2v(c, black, white, scale):  # Code2V, then CLAMPw to +-4096 and the cast to int32
        span = white - black
        v = (c - np.int64(np.trunc(black))).astype(f32) * f32(scale) / (span if span != 0 else f32(1))
        return np.trunc(np.clip(v, f32(-4096), f32(4096))).astype(np.int64)

    x = np.arange(256, dtype=np.int64) - 128
    cr_v = code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127)
    cb_v = code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127)
    cr_r, cb_b = (d1 * cr_v + (1 << 15)) >> 16, (d3 * cb_v + (1 << 15)) >> 16
    cr_g, cb_g = d2 * cr_v, d4 * cb_v + (1 << 15)
    y_tab = code2v(x + 128, rbw[0], rbw[1], 255)
    yy = y_tab[y]
    return [np.clip(v, 0, 255).astype(np.uint8)
            for v in (yy + cr_r[cr], yy + ((cb_g[cb] + cr_g[cr]) >> 16), yy + cb_b[cb])]


def _read_ycbcr(data, tags, one, width, height, spp, bits, compression, planar, predictor):
    """Uncompressed-style YCbCr (not JPEG): data units of ``h x v`` Y samples
    then Cb and Cr, rows and columns of units padded past the chunk, chroma
    replicated over its unit (``putcontig8bitYCbCr*tile``). ``HxWx3`` B, G, R."""
    if bits != 8 or spp != 3:
        raise _unsupported(f"YCbCr TIFF with {spp} samples of {bits} bits")
    h, v = (int(s) for s in tags.get(530, (2, 2)))
    if (h, v) == (4, 4):
        raise _unsupported("YCbCr TIFF at subsampling 4x4 (libtiff's RGBA interface drops the last bytes of a strip "
                           "whose row of units is not a whole number of bytes a line, and skips the wrong number of "
                           "units past a tile's edge)")
    if (h, v) not in _YCBCR_SUBSAMPLING or (planar == 2 and (h, v) != (1, 1)):
        raise ValueError(f"libtiff's RGBA interface cannot read YCbCr {'planar ' if planar == 2 else ''}data at "
                         f"subsampling {h}x{v} (OpenCV returns None).")
    if predictor != 1 and (h, v) != (1, 1):
        raise _unsupported(f"Predictor {predictor} on subsampled YCbCr TIFF")
    ycc = np.zeros((height, width, 3), np.uint8)
    if planar == 2 or (h, v) == (1, 1):
        for p, y, x, rows, cols, raw in _chunks(data, tags, one, width, height, 3 if planar == 2 else 1):
            per_chunk = 1 if planar == 2 else 3
            chunk = np.frombuffer(_decompress(raw, compression, rows * cols * per_chunk), np.uint8)
            samples = _undo_predictor(chunk.reshape(rows, cols, per_chunk, 1), predictor, np.dtype("u1"))
            _place(ycc[..., p:p + per_chunk], y, x, samples)
    else:
        unit = h * v + 2
        for _, y, x, rows, cols, raw in _chunks(data, tags, one, width, height, 1):
            uy, ux = -(-rows // v), -(-cols // h)
            units = np.frombuffer(_decompress(raw, compression, uy * ux * unit), np.uint8).reshape(uy, ux, unit)
            luma = units[..., :h * v].reshape(uy, ux, v, h).transpose(0, 2, 1, 3).reshape(uy * v, ux * h)
            chroma = np.repeat(np.repeat(units[..., h * v:], v, axis=0), h, axis=1)
            _place(ycc, y, x, np.concatenate([luma[..., None], chroma], axis=-1))
    return np.stack(_ycbcr_to_rgb(ycc[..., 0], ycc[..., 1], ycc[..., 2], tags)[::-1], axis=-1)


def _indices(data, tags, one, width, height, bits, compression, predictor):
    """One sample a pixel at 1, 2, 4 or 8 bits, rows padded to a byte -> ``HxW`` uint8 values."""
    if predictor != 1 and bits != 8:
        raise ValueError(f"libtiff refuses predictor {predictor} on {bits}-bit samples (OpenCV returns None).")
    image = np.zeros((height, width), np.uint8)
    for _, y, x, rows, cols, raw in _chunks(data, tags, one, width, height, 1):
        size = rows * -(-cols * bits // 8)
        chunk = _decompress(raw, compression, size)
        if bits == 8:
            values = _undo_predictor(np.frombuffer(chunk, np.uint8).reshape(rows, cols, 1, 1), predictor,
                                     np.dtype("u1"))[..., 0]
        else:
            values = _unpack(chunk, rows, cols, bits)
        _place(image, y, x, values)
    return image


def _read_palette(data, tags, one, width, height, spp, bits, compression, predictor):
    """Palette (photometric 3): the index of each pixel through the ColorMap,
    taken as 8-bit where every entry is below 256 and as 16-bit (the high
    byte) otherwise (libtiff's ``checkcmap`` / ``cvtcmap``). ``HxWx3`` B, G,
    R; at 1 bit ``HxWx1``, the grey OpenCV makes of the colours (it gives
    1-bit files one channel)."""
    if spp != 1:
        if bits < 8:
            raise ValueError(f"libtiff's RGBA interface cannot read {bits}-bit palette data with {spp} samples a "
                             "pixel (OpenCV returns None).")
        raise _unsupported(f"Palette TIFF with {spp} samples a pixel")
    if bits not in (1, 4, 8):
        if bits == 2:
            raise ValueError("OpenCV reads no 2-bit TIFF (cv2.imread returns None).")
        raise _unsupported(f"{bits}-bit palette TIFF")
    indices = _indices(data, tags, one, width, height, bits, compression, predictor)
    colormap = tags.get(320)
    if colormap is None or len(colormap) != 3 << bits:
        # libtiff drops a ColorMap of another count; without one, TIFFReadDirectory takes an 8-bit palette
        # file as grey and fails a smaller one.
        if bits < 8:
            raise ValueError(f"{bits}-bit palette TIFF without a ColorMap of {3 << bits} entries.")
        return indices[..., None]
    cmap = np.asarray(colormap, np.int64).reshape(3, 1 << bits)
    if (cmap >= 256).any():
        cmap >>= 8
    cmap &= 0xFF
    r, g, b = (cmap[c][indices] for c in range(3))
    if bits == 1:  # OpenCV's icvCvt_BGRA2Gray_8u_C4R: 14-bit weights, rounded
        return ((r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14).astype(np.uint8)[..., None]
    return np.stack([b, g, r], axis=-1).astype(np.uint8)


# Orientations under which libtiff's RGBA interface mirrors rows, and what is left of each after the mirror.
_TILE_MIRRORED = {2: 1, 3: 4, 6: 7, 7: 6}


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
    if len(set(bits)) != 1 or len(set(sample_format)) != 1:
        raise _unsupported("TIFF whose samples differ in size or format")
    orientation = int(one(274, 1))
    if orientation not in _ORIENTATIONS:
        raise ValueError(f"Bad TIFF orientation {orientation}.")
    if photometric in _REFUSED_PHOTOMETRIC:
        name, cv2_does = _REFUSED_PHOTOMETRIC[photometric]
        raise _unsupported(f"{name} TIFF ({cv2_does})")
    if photometric not in (0, 1, 2, 3, 6):
        raise _unsupported(f"TIFF of photometric interpretation {photometric}")
    if compression not in (1, 5, 7, 8, 32946, 32773):
        name = _COMPRESSION_NAMES.get(compression, f"compression {compression}")
        raise _unsupported(f"{name}-compressed TIFF" + (f" ({_CV2_READS})" if compression in (2, 3, 4) else ""))
    if sample_format[0] not in (1, 2) and (compression == 7 or photometric in (3, 6) or bits[0] < 8):
        raise _unsupported(f"TIFF of sample format {sample_format[0]} at {bits[0]} bits")
    depth = np.dtype("i1" if sample_format[0] == 2 else "u1")  # OpenCV's Mat depth for 8-bit data

    through_rgba = None  # what OpenCV makes of libtiff's RGBA raster: HxWx1 grey or HxWx3 B, G, R
    if compression == 7:
        if bits[0] != 8:
            raise _unsupported(f"{bits[0]}-bit JPEG-compressed TIFF")
        through_rgba = _read_jpeg(data, tags, one, width, height, spp, photometric, planar)
        if photometric == 0:
            through_rgba = 255 - through_rgba
    elif photometric == 6:
        through_rgba = _read_ycbcr(data, tags, one, width, height, spp, int(bits[0]), compression, planar, predictor)
    elif photometric == 3:
        through_rgba = _read_palette(data, tags, one, width, height, spp, int(bits[0]), compression, predictor)
    elif bits[0] < 8:
        if spp != 1:
            raise ValueError(f"libtiff's RGBA interface cannot read {bits[0]}-bit data with {spp} samples a pixel "
                             "(OpenCV returns None).")
        if bits[0] != 1:
            raise ValueError(f"OpenCV reads no {bits[0]}-bit grey TIFF (cv2.imread returns None).")
        grey = _indices(data, tags, one, width, height, 1, compression, predictor) * np.uint8(255)
        through_rgba = (255 - grey if photometric == 0 else grey)[..., None]
    if through_rgba is not None:
        image = through_rgba.view(depth)
    else:
        image = _read_samples(data, tags, one, bo, width, height, spp, bits, compression, photometric, planar,
                              predictor, sample_format)
    if image.dtype.itemsize == 1 and 322 in tags and orientation in _TILE_MIRRORED:
        # The RGBA interface mirrors each tile it reads (TIFFReadRGBATile) in place, not the whole row.
        tw = int(one(322))
        image = image.copy()
        for x in range(0, width, tw):
            image[:, x:x + tw] = image[:, x:x + tw][:, ::-1]
        orientation = _TILE_MIRRORED[orientation]
    out = _ORIENTATIONS[orientation](image)
    return np.ascontiguousarray(out[..., 0] if out.shape[-1] == 1 else out)


def _read_samples(data, tags, one, bo, width, height, spp, bits, compression, photometric, planar, predictor,
                  sample_format):
    """Grey and RGB at 8 bits and more: the samples as stored; at 8 bits what
    the RGBA interface makes of them. ``HxWxC`` in OpenCV's channel order."""
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

    per_chunk = 1 if planar == 2 else spp
    planes = spp if planar == 2 else 1
    image = np.zeros((height, width, spp), dtype.newbyteorder("="))
    for p, y, x, rows, cols, raw in _chunks(data, tags, one, width, height, planes):
        chunk = np.frombuffer(_decompress(raw, compression, rows * cols * per_chunk * size), np.uint8)
        samples = _undo_predictor(chunk.reshape(rows, cols, per_chunk, size), predictor, dtype)
        _place(image[..., p:p + per_chunk], y, x, samples)

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
    return image


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
