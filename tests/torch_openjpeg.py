"""OpenJPEG's own JPEG 2000 encoder (2.5.4, the library bundled with PIL's
wheel in ``pillow.libs``) through ctypes, for the port's JPEG 2000 reader
tests: the code-block styles, RGN, POC, tiles and tile-parts that neither
``cv2.imwrite`` nor PIL's options write, and the rewrites of its codestreams
that move packet headers into PPM / PPT marker segments.

``opj_cparameters_t`` is written as an array of int32 at these indices
(OpenJPEG 2.5 on x86-64; the two ``char *`` fields before ``csty`` take two
slots each):

======================  ==========================================================
``[0..4]``              ``tile_size_on, cp_tx0, cp_ty0, cp_tdx, cp_tdy``
``[5]``                 ``cp_disto_alloc``
``[12]``                ``csty`` (2: SOP markers, 4: EPH markers)
``[13]``                ``prog_order`` (LRCP 0 .. CPRL 4)
``[14 + 37 * i]``       ``POC[i]``: ``resno0, compno0, layno1, resno1, compno1`` at
                        +0..+4, ``prg1`` at +8, ``tile`` (1-based) at +12
``[1198]``              ``numpocs``
``[1199]``              ``tcp_numlayers``
``[1200..]``            ``tcp_rates``, as float32 (compression ratios, 0: lossless)
``[1400..1406]``        ``numresolution, cblockw_init, cblockh_init, mode,
                        irreversible, roi_compno, roi_shift``
``[4549..4552]``        ``subsampling_dx, subsampling_dy, decod_format, cod_format``
byte ``4 * 4674``       ``tp_on``, then ``tp_flag`` and ``tcp_mct`` (chars)
======================  ==========================================================

The defaults ``opj_set_default_encoder_parameters`` writes are asserted at
1400 (``6, 64, 64, 0, 0, -1``) and at 4549 (``1, 1, -1, -1``) before any
field is set, so a library of another layout fails loudly.
"""

from __future__ import annotations

import ctypes
import glob
import os
import struct
import tempfile

import numpy as np
import PIL

LIBS = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
_P = ctypes.c_void_p
_loaded = {}

PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
# The code-block style bits of COD's SPcod (OpenJPEG's ``mode``).
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32
STYLES = {"BYPASS": BYPASS, "RESET": RESET, "TERMALL": TERMALL, "VSC": VSC, "PTERM": PTERM, "SEGSYM": SEGSYM}
_DEFAULTS = {1400: [6, 64, 64, 0, 0, -1], 4549: [1, 1, -1, -1]}
_TP_ON = 4 * 4674


def library() -> ctypes.CDLL:
    """PIL's OpenJPEG, with the signatures of the functions used here."""
    if "openjp2" not in _loaded:
        paths = glob.glob(os.path.join(LIBS, "libopenjp2-*.so*"))
        assert paths, f"no libopenjp2 beside PIL in {LIBS}"
        lib = ctypes.CDLL(paths[0])
        for name, restype, argtypes in (
                ("opj_set_default_encoder_parameters", None, [_P]),
                ("opj_image_create", _P, [ctypes.c_uint32, _P, ctypes.c_int]), ("opj_image_destroy", None, [_P]),
                ("opj_create_compress", _P, [ctypes.c_int]), ("opj_setup_encoder", ctypes.c_int, [_P, _P, _P]),
                ("opj_stream_create_default_file_stream", _P, [ctypes.c_char_p, ctypes.c_int]),
                ("opj_start_compress", ctypes.c_int, [_P, _P, _P]), ("opj_encode", ctypes.c_int, [_P, _P]),
                ("opj_end_compress", ctypes.c_int, [_P, _P]), ("opj_stream_destroy", None, [_P]),
                ("opj_destroy_codec", None, [_P])):
            getattr(lib, name).restype, getattr(lib, name).argtypes = restype, argtypes
        _loaded["openjp2"] = lib
    return _loaded["openjp2"]


def encode(image: np.ndarray, *, codec="jp2", mode=0, rates=(), irreversible=False, resolutions=6,
           code_block=(64, 64), progression="LRCP", pocs=(), roi=None, sop_eph=False, tiles=None,
           tile_parts=None) -> bytes:
    """The file OpenJPEG writes for a uint8 ``HxW`` (grey) or ``HxWx3`` (BGR, handed over as R, G, B with the
    colour transform, as OpenCV hands it over) image. ``codec``: ``"jp2"`` or ``"j2k"`` (a raw codestream);
    ``mode``: the code-block style bits (:data:`STYLES`); ``rates``: the layers' compression ratios (one
    lossless layer when empty); ``code_block``: (width, height); ``pocs``: (resno0, compno0, layno1, resno1,
    compno1, progression, tile) entries, ``tile`` 1-based; ``roi``: (component, shift); ``tiles``: (width,
    height); ``tile_parts``: ``"R"``, ``"L"`` or ``"C"``, a tile-part for each resolution, layer or component."""
    lib = library()
    params = (ctypes.c_int32 * 8192)()
    lib.opj_set_default_encoder_parameters(params)
    for index, values in _DEFAULTS.items():
        assert list(params[index:index + len(values)]) == values, (index, list(params[index:index + len(values)]))
    floats = ctypes.cast(params, ctypes.POINTER(ctypes.c_float))
    raw = ctypes.cast(params, ctypes.POINTER(ctypes.c_uint8))
    params[5] = 1  # cp_disto_alloc: the layers by rate
    params[1199] = max(len(rates), 1)
    for i, rate in enumerate(rates or (0,)):
        floats[1200 + i] = float(rate)
    params[12] = 6 if sop_eph else 0
    params[13] = PROGRESSIONS[progression]
    params[1400:1407] = [resolutions, code_block[0], code_block[1], mode, int(irreversible),
                         *(roi if roi else (-1, 0))]
    if tiles:
        params[0], params[3], params[4] = 1, tiles[0], tiles[1]
    for i, (r0, c0, l1, r1, c1, prog, tile) in enumerate(pocs):
        base = 14 + 37 * i
        params[base:base + 5] = [r0, c0, l1, r1, c1]
        params[base + 8], params[base + 12] = PROGRESSIONS[prog], tile
    params[1198] = len(pocs)
    if tile_parts:
        raw[_TP_ON], raw[_TP_ON + 1] = 1, ord(tile_parts)
    h, w = image.shape[:2]
    planes = [image] if image.ndim == 2 else [image[..., 2], image[..., 1], image[..., 0]]
    raw[_TP_ON + 2] = 1 if len(planes) == 3 else 0  # tcp_mct
    comp = (ctypes.c_uint32 * (9 * len(planes)))()
    for k in range(len(planes)):
        comp[9 * k:9 * k + 9] = [1, 1, w, h, 0, 0, 8, 8, 0]  # dx, dy, w, h, x0, y0, prec, bpp, sgnd
    img = lib.opj_image_create(len(planes), comp, 1 if len(planes) == 3 else 2)  # OPJ_CLRSPC_SRGB / GRAY
    assert img
    try:
        ctypes.memmove(img + 8, struct.pack("<II", w, h), 8)  # x1, y1
        comps = struct.unpack("<Q", ctypes.string_at(img + 24, 8))[0]
        for k, plane in enumerate(planes):
            data = struct.unpack("<Q", ctypes.string_at(comps + 64 * k + 48, 8))[0]
            samples = np.ascontiguousarray(plane, dtype=np.int32)
            ctypes.memmove(data, samples.ctypes.data, samples.nbytes)
        codec_handle = lib.opj_create_compress({"j2k": 0, "jp2": 2}[codec])
        assert codec_handle
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "out." + codec).encode()
            try:
                assert lib.opj_setup_encoder(codec_handle, params, img), "opj_setup_encoder refused the parameters"
                stream = lib.opj_stream_create_default_file_stream(path, 0)
                assert stream
                try:
                    assert lib.opj_start_compress(codec_handle, img, stream), "opj_start_compress failed"
                    assert lib.opj_encode(codec_handle, stream), "opj_encode failed"
                    assert lib.opj_end_compress(codec_handle, stream), "opj_end_compress failed"
                finally:
                    lib.opj_stream_destroy(stream)
            finally:
                lib.opj_destroy_codec(codec_handle)
            with open(path, "rb") as f:
                return f.read()
    finally:
        lib.opj_image_destroy(img)


# --------------------------------------------------------------------------- codestream rewrites


def _codestream_span(data: bytes) -> tuple[int, int, int]:
    """(start, end, offset of the jp2c box header or -1) of the codestream in a JP2 file or raw codestream."""
    if data[:4] == b"\xff\x4f\xff\x51":
        return 0, len(data), -1
    pos = 0
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        length = length or len(data) - pos
        if kind == b"jp2c":
            return pos + 8, pos + length, pos
        pos += length
    raise ValueError("no codestream")


def _replace_codestream(data: bytes, codestream: bytes) -> bytes:
    start, end, box = _codestream_span(data)
    if box < 0:
        return codestream + data[end:]
    return data[:box] + struct.pack(">I", 8 + len(codestream)) + b"jp2c" + codestream + data[end:]


def _segments(cs: bytes, pos: int, stop: set[int]):
    """(marker, start, end) of the marker segments from ``pos`` up to a marker in ``stop``; then (marker, pos)."""
    out = []
    while True:
        if pos + 2 > len(cs):
            return out, None, pos
        (marker,) = struct.unpack(">H", cs[pos:pos + 2])
        if marker in stop:
            return out, marker, pos
        (length,) = struct.unpack(">H", cs[pos + 2:pos + 4])
        out.append((marker, pos, pos + 2 + length))
        pos += 2 + length


class _TilePart:
    def __init__(self, isot, tpsot, tnsot, header: bytes, body: bytes):
        self.isot, self.tpsot, self.tnsot, self.header, self.body = isot, tpsot, tnsot, header, body

    def bytes(self) -> bytes:
        psot = 12 + len(self.header) + 2 + len(self.body)
        return (struct.pack(">HHHIBB", 0xFF90, 10, self.isot, psot, self.tpsot, self.tnsot) + self.header
                + b"\xff\x93" + self.body)


def _parse(cs: bytes):
    """(main header from SOC up to the first SOT, tile-parts, the bytes from EOC on)."""
    _, _, sot = _segments(cs, 2, {0xFF90})
    main = cs[:sot]
    parts, pos = [], sot
    while cs[pos:pos + 2] == b"\xff\x90":
        _, isot, psot, tpsot, tnsot = struct.unpack(">HHIBB", cs[pos + 2:pos + 12])
        end = pos + psot if psot else len(cs) - 2
        _, _, sod = _segments(cs, pos + 12, {0xFF93})
        parts.append(_TilePart(isot, tpsot, tnsot, cs[pos + 12:sod], cs[sod + 2:end]))
        pos = end
    return main, parts, cs[pos:]


def _join(main: bytes, parts, tail: bytes) -> bytes:
    return main + b"".join(p.bytes() for p in parts) + tail


def _packets(body: bytes) -> list[tuple[bytes, bytes]]:
    """(SOP segment, header through its EPH marker, body) of each packet of a tile-part written with SOP and
    EPH markers: a header ends at its FF92 (packet headers stuff a 0 bit after 0xFF, so never hold FF92)."""
    out, pos = [], 0
    while pos < len(body):
        assert body[pos:pos + 2] == b"\xff\x91", f"no SOP marker at byte {pos} of a tile-part"
        eph = body.index(b"\xff\x92", pos + 6) + 2
        nxt = body.find(b"\xff\x91", eph)
        nxt = len(body) if nxt < 0 else nxt
        out.append((body[pos:pos + 6], body[pos + 6:eph], body[eph:nxt]))
        pos = nxt
    return out


def _cut(data: bytes, pieces: int) -> list[bytes]:
    if not data:
        return []
    pieces = max(1, min(pieces, len(data)))
    bounds = [round(i * len(data) / pieces) for i in range(pieces + 1)]
    return [data[a:b] for a, b in zip(bounds, bounds[1:])]


def _marker(code: int, body: bytes) -> bytes:
    assert len(body) + 2 <= 0xFFFF, "a marker segment over 65535 bytes"
    return struct.pack(">HH", code, len(body) + 2) + body


def pack_headers(data: bytes, kind: str, split=1, reverse=False) -> bytes:
    """``data`` (a JP2 file or raw codestream written with SOP and EPH markers) with every packet header moved
    out of the tile-parts into PPT marker segments of each tile-part header (``kind`` ``"ppt"``) or PPM marker
    segments of the main header (``"ppm"``: an ``Nppm`` and its headers for each tile-part, in codestream
    order). ``split``: the marker segments each tile-part's headers (PPT) or all headers (PPM) are cut over,
    at consecutive ``Z`` indices, a PPM cut never inside an ``Nppm`` field; ``reverse``: the segments written
    in the reverse of their ``Z`` order. Packet bodies keep their SOP markers; the EPH markers go with the
    headers, as the packed headers carry them."""
    start, end, _ = _codestream_span(data)
    main, parts, tail = _parse(data[start:end])
    cod = main.index(b"\xff\x52")
    assert main[cod + 4] & 6 == 6, "the codestream was written without SOP and EPH markers"
    headers = []
    for part in parts:
        packets = _packets(part.body)
        headers.append(b"".join(h for _, h, _ in packets))
        part.body = b"".join(sop + body for sop, _, body in packets)
    order = (lambda s: s[::-1]) if reverse else (lambda s: s)
    if kind == "ppt":
        z = {}
        for part, packed in zip(parts, headers):
            chunks = [c for c in _cut(packed, split) for c in _cut(c, -(-len(c) // 65000))]
            segments = []
            for chunk in chunks:
                segments.append(_marker(0xFF61, bytes([z.setdefault(part.isot, 0)]) + chunk))
                z[part.isot] += 1
            part.header += b"".join(order(segments))
    elif kind == "ppm":
        payload = b"".join(struct.pack(">I", len(h)) + h for h in headers)
        # Cut points inside the headers' bytes only (each Nppm field stays whole).
        inside, offset = [], 0
        for h in headers:
            inside.extend(range(offset + 4 + 1, offset + 4 + len(h)))
            offset += 4 + len(h)
        cuts = sorted({inside[round(i * (len(inside) - 1) / split)] for i in range(1, split)}) if inside else []
        bounds = [0, *cuts, len(payload)]
        segments = [_marker(0xFF60, bytes([i]) + payload[a:b]) for i, (a, b) in enumerate(zip(bounds, bounds[1:]))]
        main += b"".join(order(segments))
    else:
        raise ValueError(kind)
    return _replace_codestream(data, _join(main, parts, tail))


def move_to_tile_header(data: bytes, marker: int) -> bytes:
    """``data`` with the main header's first ``marker`` segment (a POC or RGN) moved into the first tile-part
    header."""
    start, end, _ = _codestream_span(data)
    main, parts, tail = _parse(data[start:end])
    segments, _, _ = _segments(main, 2, {0xFF90})
    found = next((s for s in segments if s[0] == marker), None)
    assert found, f"no marker 0x{marker:04X} in the main header"
    _, a, b = found
    parts[0].header = main[a:b] + parts[0].header
    return _replace_codestream(data, _join(main[:a] + main[b:], parts, tail))


def move_to_main_header(data: bytes, marker: int) -> bytes:
    """``data`` with the first tile-part header's first ``marker`` segment (a POC or RGN) moved to the end of
    the main header."""
    start, end, _ = _codestream_span(data)
    main, parts, tail = _parse(data[start:end])
    segments, _, _ = _segments(parts[0].header + b"\xff\x93", 0, {0xFF93})
    found = next((s for s in segments if s[0] == marker), None)
    assert found, f"no marker 0x{marker:04X} in the first tile-part header"
    _, a, b = found
    segment, parts[0].header = parts[0].header[a:b], parts[0].header[:a] + parts[0].header[b:]
    return _replace_codestream(data, _join(main + segment, parts, tail))


def split_poc(data: bytes) -> bytes:
    """``data`` with the first entry of the first tile-part's POC moved into a POC of its own in the main header
    (OpenJPEG appends a tile's entries to the main header's, so the order of the entries stays)."""
    start, end, _ = _codestream_span(data)
    main, parts, tail = _parse(data[start:end])
    segments, _, _ = _segments(parts[0].header + b"\xff\x93", 0, {0xFF93})
    found = next((s for s in segments if s[0] == 0xFF5F), None)
    assert found, "no POC in the first tile-part header"
    _, a, b = found
    (siz_length,) = struct.unpack(">H", main[4:6])
    entry = 7 if (siz_length - 38) // 3 <= 256 else 9
    body = parts[0].header[a + 4:b]
    assert len(body) >= 2 * entry, "the POC has one entry"
    parts[0].header = parts[0].header[:a] + _marker(0xFF5F, body[entry:]) + parts[0].header[b:]
    return _replace_codestream(data, _join(main + _marker(0xFF5F, body[:entry]), parts, tail))


def add_to_tile_header(data: bytes, segment: bytes, part=0) -> bytes:
    """``data`` with ``segment`` (a whole marker segment) at the end of tile-part ``part``'s header."""
    start, end, _ = _codestream_span(data)
    main, parts, tail = _parse(data[start:end])
    parts[part].header += segment
    return _replace_codestream(data, _join(main, parts, tail))


def rewrite(data: bytes, edit) -> bytes:
    """``data`` with ``edit(main, tile_parts)`` applied: it returns the new main header (SOC up to the first SOT)
    and may change the tile-parts' ``header``, ``body``, ``tpsot`` and ``tnsot`` in place (``Psot`` follows)."""
    start, end, _ = _codestream_span(data)
    main, parts, tail = _parse(data[start:end])
    return _replace_codestream(data, _join(edit(main, parts), parts, tail))


def main_markers(data: bytes) -> list[int]:
    """The markers of the main header, in order."""
    start, end, _ = _codestream_span(data)
    main, _, _ = _parse(data[start:end])
    segments, _, _ = _segments(main, 2, {0xFF90})
    return [m for m, _, _ in segments]


def tile_part_markers(data: bytes) -> list[tuple[int, int, list[int]]]:
    """(Isot, TPsot, the markers of its header) of each tile-part."""
    start, end, _ = _codestream_span(data)
    _, parts, _ = _parse(data[start:end])
    out = []
    for p in parts:
        segments, _, _ = _segments(p.header + b"\xff\x93", 0, {0xFF93})
        out.append((p.isot, p.tpsot, [m for m, _, _ in segments]))
    return out
