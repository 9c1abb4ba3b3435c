"""Hand-built TIFF and GIF files for the port's codec tests and fixtures.

OpenCV writes a few TIFF layouts only (chunky strips, little-endian) and
GIF files through its own quantiser; these builders write the layouts it
does not -- tiles, planar samples, big-endian and BigTIFF files, the
floating-point predictor, min-is-white grey, extra samples, interlaced and
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
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits or a.dtype.itemsize * 8] * spp),
            (259, 3, [declared_compression or compression]),
            (262, 3, [photometric]), (277, 3, [spp]), (284, 3, [2 if planar else 1]), (339, 3, [sample_format] * spp)]
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if extra_samples is not None:
        tags.append((338, 3, list(extra_samples)))
    offsets_type = 16 if bigtiff else 4
    if tile:
        tags += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, offsets_type, None), (325, 4, [len(d) for d in data])]
    else:
        tags += [(273, offsets_type, None), (278, 4, [rows_per_strip or h]), (279, 4, [len(d) for d in data])]
    tags += list(extra_tags)
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
    fmt = {1: "B", 2: "B", 3: "H", 4: "I", 16: "Q"}
    entry_size, count_fmt, inline = (20, "Q", 8) if bigtiff else (12, "I", 4)
    ifd_offset = header_size + len(body)
    n = len(tags)
    ifd_size = (8 if bigtiff else 2) + n * entry_size + (8 if bigtiff else 4)
    extra = bytearray()
    entries = bytearray()
    for tag, typ, values in tags:
        if values is None:
            values = offsets
        payload = b"".join(struct.pack(bo + fmt[typ], v) for v in values)
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
