"""Hand-built TIFF and GIF files for the port's codec tests and fixtures.

OpenCV writes a few TIFF layouts only (chunky strips, little-endian) and
GIF files through its own quantiser; these builders write the layouts it
does not -- tiles, planar samples, big-endian and BigTIFF files, the
floating-point predictor, min-is-white grey, extra samples, YCbCr data
units, palette and sub-byte samples, JPEG streams (from a caller's encoder)
as strips or tiles with or without shared JPEGTables, interlaced and
transparent GIF frames on a larger screen -- with numpy and ``zlib`` only,
and an LZW encoder of their own (so that the port's is not its own oracle).
OpenCV then reads each file as the reference.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tiff_lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB first, early change), a clear code first and whenever
    the table reaches 4094 entries."""
    out, acc, bits = bytearray(), 0, 0
    width = 9

    def put(code):
        nonlocal acc, bits
        acc = (acc << width) | code
        bits += width
        while bits >= 8:
            bits -= 8
            out.append((acc >> bits) & 0xFF)

    def reset():
        return {bytes([i]): i for i in range(256)}, 258

    put(256)
    table, free = reset()
    prefix = b""
    for byte in data:
        candidate = prefix + bytes([byte])
        if candidate in table:
            prefix = candidate
            continue
        put(table[prefix])
        table[candidate] = free
        free += 1
        prefix = bytes([byte])
        if free == 4094:
            put(256)
            width = 9
            table, free = reset()
        elif free > (1 << width) - 1:
            width += 1
    if prefix:
        put(table[prefix])
        free += 1
        if free > (1 << width) - 1 and width < 12:
            width += 1
    put(257)
    if bits:
        out.append((acc << (8 - bits)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3 to 128 equal bytes as one repeat, the rest as literals of at most 128."""
    out, i, n = bytearray(), 0, len(data)
    literal = bytearray()

    def flush():
        for k in range(0, len(literal), 128):
            chunk = literal[k:k + 128]
            out.append(len(chunk) - 1)
            out.extend(chunk)
        literal.clear()

    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            flush()
            out.append(257 - run)
            out.append(data[i])
            i += run
        else:
            literal.append(data[i])
            i += 1
    flush()
    return bytes(out)


def _predict(chunk: np.ndarray, predictor: int, spp: int, byte_order: str) -> bytes:
    """``chunk`` [rows, cols, spp] samples -> the bytes to compress, after the predictor."""
    rows, cols = chunk.shape[:2]
    if predictor == 2:
        unsigned = chunk.view(np.dtype(f"u{chunk.dtype.itemsize}"))
        diff = unsigned.copy()
        diff[:, 1:] = unsigned[:, 1:] - unsigned[:, :-1]
        return diff.astype(diff.dtype.newbyteorder(byte_order)).tobytes()
    if predictor == 3:
        bps = chunk.dtype.itemsize
        big = chunk.astype(chunk.dtype.newbyteorder(">")).reshape(rows, cols * spp)
        planes = big.view(np.uint8).reshape(rows, cols * spp, bps).transpose(0, 2, 1).reshape(rows, -1)
        grouped = planes.reshape(rows, -1, spp).astype(np.int64)
        diff = grouped.copy()
        diff[:, 1:] = grouped[:, 1:] - grouped[:, :-1]
        return (diff & 0xFF).astype(np.uint8).tobytes()
    return chunk.astype(chunk.dtype.newbyteorder(byte_order)).tobytes()


def _compress(raw: bytes, compression: int) -> bytes:
    if compression == 1:
        return raw
    if compression == 5:
        return tiff_lzw_encode(raw)
    if compression in (8, 32946):
        return zlib.compress(raw, 6)
    if compression == 32773:
        return packbits_encode(raw)
    raise ValueError(compression)


def tiff_bytes(samples, *, byte_order="<", photometric=None, compression=1, predictor=1, planar=False, tile=None,
               rows_per_strip=None, extra_samples=None, sample_format=None, bigtiff=False, extra_tags=(),
               declared_compression=None, bits=None) -> bytes:
    """A one-page TIFF of ``samples`` ([H, W] or [H, W, S], in the file's
    channel order, e.g. RGB). ``tile``: (width, length), multiples of 16.
    ``extra_tags``: (tag, type, values) entries added as they are.
    ``declared_compression`` / ``bits``: the Compression / BitsPerSample
    tags to write in place of the true ones (for files a reader must refuse)."""
    a = np.asarray(samples)
    if a.ndim == 2:
        a = a[..., None]
    h, w, spp = a.shape
    if photometric is None:
        photometric = 2 if spp >= 3 else 1
    if sample_format is None:
        sample_format = 3 if a.dtype.kind == "f" else 2 if a.dtype.kind == "i" else 1
    planes = [a[..., s:s + 1] for s in range(spp)] if planar else [a]
    chunks = []
    if tile:
        tw, tl = tile
        for plane in planes:
            padded = np.zeros((-(-h // tl) * tl, -(-w // tw) * tw, plane.shape[2]), a.dtype)
            padded[:h, :w] = plane
            for ty in range(0, h, tl):
                for tx in range(0, w, tw):
                    chunks.append(padded[ty:ty + tl, tx:tx + tw])
    else:
        rps = rows_per_strip or h
        for plane in planes:
            for y in range(0, h, rps):
                chunks.append(plane[y:y + rps])
    applied = predictor if compression in (5, 8, 32946) else 1  # libtiff ignores it under the other codecs
    data = [_compress(_predict(np.ascontiguousarray(c), applied, c.shape[2], byte_order), compression)
            for c in chunks]
    tags = [(258, 3, [bits or a.dtype.itemsize * 8] * spp), (259, 3, [declared_compression or compression]),
            (262, 3, [photometric]), (277, 3, [spp]), (284, 3, [2 if planar else 1]), (339, 3, [sample_format] * spp)]
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if extra_samples is not None:
        tags.append((338, 3, list(extra_samples)))
    return tiff_file(w, h, data, tags + list(extra_tags), tile=tile, rows_per_strip=rows_per_strip,
                     byte_order=byte_order, bigtiff=bigtiff)


def tiff_file(width, height, chunks, tags, *, tile=None, rows_per_strip=None, byte_order="<", bigtiff=False) -> bytes:
    """A one-page TIFF around ``chunks``, the strips' or tiles' bytes as they are stored (already compressed),
    with ``tags`` -- (tag, type, values) -- besides the size and the strip / tile layout, which this adds."""
    data = list(chunks)
    tags = [(256, 4, [width]), (257, 4, [height])] + list(tags)
    offsets_type = 16 if bigtiff else 4
    if tile:
        tags += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, offsets_type, None), (325, 4, [len(d) for d in data])]
    else:
        tags += [(273, offsets_type, None), (278, 4, [rows_per_strip or height]), (279, 4, [len(d) for d in data])]
    tags.sort(key=lambda t: t[0])
    bo = byte_order
    header_size = 16 if bigtiff else 8
    body = bytearray()
    offsets = []
    for d in data:
        offsets.append(header_size + len(body))
        body += d
        if len(body) % 2:
            body += b"\0"
    fmt = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 7: "B", 16: "Q"}
    entry_size, count_fmt, inline = (20, "Q", 8) if bigtiff else (12, "I", 4)
    ifd_offset = header_size + len(body)
    n = len(tags)
    ifd_size = (8 if bigtiff else 2) + n * entry_size + (8 if bigtiff else 4)
    extra = bytearray()
    entries = bytearray()
    for tag, typ, values in tags:
        if values is None:
            values = offsets
        payload = b"".join(struct.pack(bo + fmt[typ], *(v if typ == 5 else (v,))) for v in values)
        if len(payload) <= inline:
            field = payload + b"\0" * (inline - len(payload))
        else:
            where = ifd_offset + ifd_size + len(extra)
            field = struct.pack(bo + ("Q" if bigtiff else "I"), where)
            extra += payload
            if len(extra) % 2:
                extra += b"\0"
        entries += struct.pack(bo + "HH" + count_fmt, tag, typ, len(values)) + field
    magic = b"II" if bo == "<" else b"MM"
    if bigtiff:
        head = magic + struct.pack(bo + "HHHQ", 43, 8, 0, ifd_offset)
        ifd = struct.pack(bo + "Q", n) + entries + struct.pack(bo + "Q", 0)
    else:
        head = magic + struct.pack(bo + "HI", 42, ifd_offset)
        ifd = struct.pack(bo + "H", n) + entries + struct.pack(bo + "I", 0)
    return head + bytes(body) + ifd + bytes(extra)


def _chunk_parts(image: np.ndarray, tile=None, rows_per_strip=None):
    """The image cut as a TIFF stores it: full tiles (zeros past the edges) or strips."""
    h, w = image.shape[:2]
    if tile:
        tw, tl = tile
        padded = np.zeros((-(-h // tl) * tl, -(-w // tw) * tw) + image.shape[2:], image.dtype)
        padded[:h, :w] = image
        return [padded[y:y + tl, x:x + tw] for y in range(0, h, tl) for x in range(0, w, tw)]
    rps = rows_per_strip or h
    return [image[y:y + rps] for y in range(0, h, rps)]


def _jpeg_segments(stream: bytes):
    """(marker, bytes) of each segment of a JPEG stream up to its scan (the scan and the rest as one)."""
    out, pos = [], 2
    while pos < len(stream):
        marker = stream[pos + 1]
        if marker == 0xDA:
            out.append((marker, stream[pos:]))
            break
        (n,) = struct.unpack(">H", stream[pos + 2:pos + 4])
        out.append((marker, stream[pos:pos + 2 + n]))
        pos += 2 + n
    return out


def jpeg_tiff_bytes(samples, encode, *, subsampling=(2, 2), photometric=None, tile=None, rows_per_strip=None,
                    shared_tables=False, subsampling_tag=True, extra_tags=()) -> bytes:
    """A JPEG-compressed TIFF (compression 7) whose strips or tiles are the
    JPEG streams ``encode(part)`` returns for each part of ``samples``
    ([H, W] grey or [H, W, 3] in the file's channel order). ``subsampling``:
    what the streams hold, written as YCbCrSubsampling (530) for photometric
    6 unless ``subsampling_tag`` is False. ``shared_tables``: the first
    stream's DQT / DHT segments moved into JPEGTables (347) and every
    stream's tables (and APP0) dropped, as libtiff writes."""
    a = np.asarray(samples)
    spp = 1 if a.ndim == 2 else a.shape[2]
    if photometric is None:
        photometric = 1 if spp == 1 else 6
    chunks = [encode(np.ascontiguousarray(part)) for part in _chunk_parts(a, tile, rows_per_strip)]
    tags = [(258, 3, [8] * spp), (259, 3, [7]), (262, 3, [photometric]), (277, 3, [spp]), (284, 3, [1])]
    if shared_tables:
        tables = b"".join(seg for m, seg in _jpeg_segments(chunks[0]) if m in (0xDB, 0xC4))
        tags.append((347, 7, list(b"\xff\xd8" + tables + b"\xff\xd9")))
        chunks = [b"\xff\xd8" + b"".join(seg for m, seg in _jpeg_segments(c) if m not in (0xDB, 0xC4, 0xE0))
                  for c in chunks]
    if photometric == 6 and subsampling_tag:
        tags.append((530, 3, list(subsampling)))
    return tiff_file(a.shape[1], a.shape[0], chunks, tags + list(extra_tags), tile=tile,
                     rows_per_strip=rows_per_strip)


def ycbcr_units(ycc: np.ndarray, h: int, v: int) -> bytes:
    """[rows, cols, 3] Y, Cb, Cr -> TIFF's YCbCr data units: ``h x v`` Y
    samples then one Cb and one Cr (the unit's top-left pixel's), units
    padded with zeros past the edges."""
    rows, cols = ycc.shape[:2]
    uy, ux = -(-rows // v), -(-cols // h)
    padded = np.zeros((uy * v, ux * h, 3), np.uint8)
    padded[:rows, :cols] = ycc
    luma = padded[..., 0].reshape(uy, v, ux, h).transpose(0, 2, 1, 3).reshape(uy, ux, v * h)
    return np.concatenate([luma, padded[::v, ::h, 1:]], axis=-1).tobytes()


def ycbcr_tiff_bytes(ycc, *, subsampling=(2, 2), compression=1, tile=None, rows_per_strip=None, planar=False,
                     subsampling_tag=True, extra_tags=()) -> bytes:
    """An 8-bit YCbCr TIFF (photometric 6, not JPEG) of ``ycc`` ([H, W, 3])
    in data units (chunky) or as three planes (``planar``, 1x1 only)."""
    h, v = subsampling
    parts = _chunk_parts(np.asarray(ycc, np.uint8), tile, rows_per_strip)
    if planar:
        raw = [np.ascontiguousarray(p[..., c]).tobytes() for c in range(3) for p in parts]
    else:
        raw = [ycbcr_units(p, h, v) for p in parts]
    tags = [(258, 3, [8] * 3), (259, 3, [compression]), (262, 3, [6]), (277, 3, [3]), (284, 3, [2 if planar else 1])]
    if subsampling_tag:
        tags.append((530, 3, [h, v]))
    return tiff_file(ycc.shape[1], ycc.shape[0], [_compress(r, compression) for r in raw], tags + list(extra_tags),
                     tile=tile, rows_per_strip=rows_per_strip)


def pack_bits(values: np.ndarray, bits: int) -> bytes:
    """[rows, cols] samples of ``bits`` (1, 2, 4) -> rows packed most significant first, padded to a byte."""
    rows, cols = values.shape
    per = 8 // bits
    stride = -(-cols // per)
    padded = np.zeros((rows, stride * per), np.uint8)
    padded[:, :cols] = values
    out = np.zeros((rows, stride), np.uint8)
    for k in range(per):
        out |= (padded[:, k::per] << (8 - bits * (k + 1))).astype(np.uint8)
    return out.tobytes()


def packed_tiff_bytes(values, bits, *, photometric=1, colormap=None, compression=1, tile=None, rows_per_strip=None,
                      samples_per_pixel=1, sample_format=None, extra_tags=()) -> bytes:
    """A one-sample TIFF of ``values`` ([H, W], each below ``2**bits``) at
    1, 2, 4 or 8 bits: grey (photometric 0 / 1) or palette (3, with
    ``colormap`` [3, 2**bits] written as ColorMap)."""
    a = np.asarray(values, np.uint8)
    parts = _chunk_parts(a, tile, rows_per_strip)
    raw = [pack_bits(p, bits) if bits < 8 else np.ascontiguousarray(p).tobytes() for p in parts]
    spp = samples_per_pixel
    tags = [(258, 3, [bits] * spp), (259, 3, [compression]), (262, 3, [photometric]), (277, 3, [spp]),
            (284, 3, [1])]
    if colormap is not None:
        tags.append((320, 3, [int(x) for x in np.asarray(colormap).reshape(-1)]))
    if sample_format is not None:
        tags.append((339, 3, [sample_format] * spp))
    return tiff_file(a.shape[1], a.shape[0], [_compress(r, compression) for r in raw], tags + list(extra_tags),
                     tile=tile, rows_per_strip=rows_per_strip)


# --------------------------------------------------------------------------- GIF


def gif_lzw_encode(indices: bytes, min_code_size: int) -> bytes:
    """GIF LZW (LSB first), a clear code first and whenever the table is full."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out, acc, bits = bytearray(), 0, 0
    width = min_code_size + 1

    def put(code):
        nonlocal acc, bits
        acc |= code << bits
        bits += width
        while bits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            bits -= 8

    def reset():
        return {bytes([i]): i for i in range(clear)}, end + 1

    put(clear)
    table, free = reset()
    prefix = b""
    for byte in indices:
        candidate = prefix + bytes([byte])
        if candidate in table:
            prefix = candidate
            continue
        put(table[prefix])
        prefix = bytes([byte])
        if free < 4096:
            table[candidate] = free
            free += 1
            if free > (1 << width) and width < 12:
                width += 1
        if free == 4096:
            put(clear)
            table, free = reset()
            width = min_code_size + 1
    if prefix:
        put(table[prefix])
    put(end)
    if bits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)) + b"\0"


def gif_bytes(indices, palette, *, screen=None, origin=(0, 0), local_palette=None, interlaced=False,
              transparent=None, background=0, frames=()) -> bytes:
    """A GIF89a file whose first frame is ``indices`` ([h, w] uint8) at
    ``origin`` (x, y) on a ``screen`` (w, h) (default: the frame's size).
    ``palette`` is the global colour table ([n, 3] RGB, n a power of 2, or
    None), ``local_palette`` the frame's own. ``transparent``: the index a
    Graphic Control Extension marks transparent. ``frames``: more
    (indices, origin) frames after the first."""
    idx = np.asarray(indices, np.uint8)
    h, w = idx.shape
    sw, sh = screen or (w, h)
    out = bytearray(b"GIF89a")
    flags = 0
    if palette is not None:
        size = len(palette).bit_length() - 2
        flags = 0x80 | (7 << 4) | size
    out += struct.pack("<HHBBB", sw, sh, flags, background, 0)
    if palette is not None:
        out += np.asarray(palette, np.uint8).tobytes()

    def frame(index, at, local, gce):
        fh, fw = index.shape
        block = bytearray()
        if gce is not None:
            block += bytes([0x21, 0xF9, 4, 1, 0, 0, gce, 0])
        lflags = 0
        if local is not None:
            lflags = 0x80 | (len(local).bit_length() - 2)
        if interlaced:
            lflags |= 0x40
            order = list(range(0, fh, 8)) + list(range(4, fh, 8)) + list(range(2, fh, 4)) + list(range(1, fh, 2))
            index = index[order]
        block += bytes([0x2C]) + struct.pack("<HHHHB", at[0], at[1], fw, fh, lflags)
        if local is not None:
            block += np.asarray(local, np.uint8).tobytes()
        colours = len(local if local is not None else palette)
        mcs = max(2, (colours - 1).bit_length())
        block += bytes([mcs]) + _sub_blocks(gif_lzw_encode(index.tobytes(), mcs))
        return block

    out += frame(idx, origin, local_palette, transparent)
    for more, at in frames:
        out += frame(np.asarray(more, np.uint8), at, None, None)
    out += b";"
    return bytes(out)
