"""JPEG 2000 reading with what ``cv2.imread(path, IMREAD_UNCHANGED)`` returns,
and writing the file ``cv2.imwrite`` writes.

OpenCV reads JPEG 2000 through OpenJPEG and turns its components into a
``Mat``. :func:`decode_jpeg2000` does both: the codestream is decoded in C++
(``native/jpeg2000_decoder.cpp``, built at first use by
:mod:`super_resolution_tpu_torch.native`; no compiler: ``RuntimeError``) as
OpenJPEG 2.5 decodes it, and the JP2 layer and the conversion to a ``Mat``
follow OpenJPEG's ``opj_jp2_decode`` and OpenCV's reader:

- the input is recognised by its signature: a JP2 file (the ``jP`` box) or
  a raw codestream (``FF4F FF51``), whatever the extension;
- JP2 boxes: ``ftyp``; ``jp2h`` with ``ihdr``, ``colr`` (enumerated or
  ICC; the first one counts), ``pclr`` + ``cmap`` (the palette applied),
  ``cdef`` (channels reordered as OpenJPEG reorders them) and ``res``
  (ignored); then ``jp2c``;
- the ``Mat`` has as many channels as the codestream has components (1, 3
  or 4), in BGR / BGRA order; uint8 when the widest component has 8 bits,
  uint16 (values unscaled) for 9 to 16 bits; a grey colour space repeats the
  first component, sYCC is converted to BGR, three or more components under
  a one-channel ``Mat`` (a palette file) are converted to grey.

Where ``cv2.imread`` returns ``None``, :func:`decode_jpeg2000` raises
``ValueError`` with OpenCV's reason: 2 or more than 4 components, a
precision below 8 or above 16 bits, signed or sub-sampled components, an
image offset, a colour space it does not convert (eYCC, CMYK), and a file
cut short or otherwise corrupt -- among these what OpenJPEG 2.5 itself fails
on: a packet header without its EPH marker where COD asks for them, PPM
beside PPT or a Z index read twice, a code-block past 30 bit-planes with its
RGN shift, a tile whose last tile-part holds no data, a colour transform over
components a POC left at different resolutions. All of Part 1 is read: every
code-block style (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM), RGN, POC,
PPM and PPT. HTJ2K (Part 15) and Part 2 extensions raise
``NotImplementedError`` naming them.

:func:`encode_jpeg2000` writes a uint8 ``HxW`` or ``HxWx3`` (BGR) image as
the JP2 file ``cv2.imwrite(path, image)`` writes, byte for byte: OpenCV
hands the image to OpenJPEG 2.5.3 as R, G, B (or grey) components with one
quality layer at rate 4 (``IMWRITE_JPEG2000_COMPRESSION_X1000`` 250, its
default). The codestream is encoded in C++ (``native/jpeg2000_encoder.cpp``:
the 5/3 transform, tier-1, OpenJPEG's rate allocation, tier-2 and the
markers); the JP2 boxes around it are written here. Images with a side
below 32 pixels raise ``ValueError``: OpenJPEG's 5 decomposition levels need
32, and ``cv2.imwrite`` writes no file there.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

__all__ = ["STATS", "ENCODER_STATS", "decode_jpeg2000", "decode_codestream", "encode_jpeg2000"]

# The counts native/jpeg2000_decoder.cpp keeps over one decode (its Stat order).
STATS = ("tiles", "tile_parts", "packets", "empty_packets", "sop_markers", "eph_markers", "code_blocks",
         "truncated_blocks", "passes", "layers", "reversible", "irreversible", "rct", "ict", "precincts_defined",
         "lrcp", "rlcp", "rpcl", "pcrl", "cprl", "segments", "raw_passes", "roi_components", "poc_entries",
         "packed_header_bytes")

# The counts native/jpeg2000_encoder.cpp keeps over one encode (its Stat order): code-blocks, those with
# no coefficient above zero, coding passes, passes kept in the layer, code-blocks whose passes were cut, the
# packets' byte budget, bisection steps, tier-2 trials and the packets' bytes.
ENCODER_STATS = ("code_blocks", "zero_blocks", "passes", "passes_kept", "blocks_cut", "budget", "iterations",
                 "trials", "packet_bytes")
# OpenJPEG's 5 decomposition levels need a tile of 2^5 samples a side.
MIN_ENCODE_SIDE = 32

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"

# OpenJPEG's colour spaces, as opj_jp2_decode sets them from the colr box.
_UNSPECIFIED, _SRGB, _GRAY, _SYCC, _EYCC, _CMYK, _UNKNOWN = range(7)
_ENUMCS = {16: _SRGB, 17: _GRAY, 18: _SYCC, 24: _EYCC, 12: _CMYK}


class _Info(ctypes.Structure):
    _fields_ = [("x0", ctypes.c_int32), ("y0", ctypes.c_int32), ("x1", ctypes.c_int32), ("y1", ctypes.c_int32),
                ("num_components", ctypes.c_int32), ("precision", ctypes.c_int32 * 4),
                ("is_signed", ctypes.c_int32 * 4), ("dx", ctypes.c_int32 * 4), ("dy", ctypes.c_int32 * 4),
                ("stats", ctypes.c_int64 * len(STATS))]


def _call(lib, codestream: bytes, info: _Info, out, plane: int, capacity: int) -> int:
    message = ctypes.create_string_buffer(256)
    code = lib.sr_j2k_decode(codestream, len(codestream), ctypes.byref(info), out, plane, capacity, message, 256)
    text = message.value.decode(errors="replace")
    if code == -2:
        raise NotImplementedError(f"JPEG 2000 codestream with {text} is not supported by the port's reader.")
    if code < 0:
        raise ValueError(f"Corrupt JPEG 2000 codestream: {text}.")
    return code


def _header(codestream: bytes) -> _Info:
    from super_resolution_tpu_torch.native import get_jpeg2000_library

    info = _Info()
    _call(get_jpeg2000_library(), codestream, info, None, 0, 0)
    return info


def decode_codestream(codestream: bytes, info: _Info | None = None, stats: dict | None = None) -> list[np.ndarray]:
    """A codestream's components as int32 planes, as OpenJPEG's ``opj_decode`` leaves them (sub-sampled
    components are refused: OpenCV refuses them). ``info``: its main header, if already read; ``stats``: a
    dict to fill with the decoder's counts (:data:`STATS`)."""
    from super_resolution_tpu_torch.native import get_jpeg2000_library

    lib = get_jpeg2000_library()
    info = info or _header(codestream)
    n = info.num_components
    if any(info.dx[c] != 1 or info.dy[c] != 1 for c in range(min(n, 4))):
        raise ValueError("JPEG 2000 with sub-sampled components: OpenCV does not read them.")
    w, h = info.x1 - info.x0, info.y1 - info.y0
    out = np.zeros((n, h, w), dtype=np.int32)
    _call(lib, codestream, info, out.ctypes.data, w * h, out.size)
    if stats is not None:
        stats.update(zip(STATS, (int(v) for v in info.stats)))
    return list(out)


# --------------------------------------------------------------------------- JP2 boxes


def _boxes(data: bytes, pos: int, end: int):
    """(type, body start, body end) of the boxes in ``data[pos:end]``."""
    while pos < end:
        if pos + 8 > end:
            raise ValueError("Corrupt JP2 file: a box header is cut short.")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if length == 1:
            if pos + 16 > end:
                raise ValueError("Corrupt JP2 file: a box header is cut short.")
            (length,) = struct.unpack(">Q", data[pos + 8:pos + 16])
            head = 16
        elif length == 0:
            length = end - pos
        if length < head or pos + length > end:
            raise ValueError(f"Corrupt JP2 file: box {kind.decode(errors='replace')!r} of {length} bytes "
                             f"with {end - pos} left.")
        yield kind, pos + head, pos + length
        pos += length


class _Jp2:
    """What opj_jp2_read_header keeps of a JP2 file's boxes."""

    def __init__(self, data: bytes):
        self.enumcs = 0
        self.has_colr = False
        self.pclr = None  # the palette's entries, [NE, NPC] int64
        self.cmap = None  # [(cmp, mtyp, pcol)]
        self.cdef = None  # [(cn, typ, asoc)]
        self.codestream = None
        self.size = (0, 0)
        boxes = _boxes(data, 0, len(data))
        first = next(boxes, None)
        if first is None or first[0] != b"jP  " or data[first[1]:first[2]] != b"\r\n\x87\n":
            raise ValueError("Corrupt JP2 file: no signature box.")
        second = next(boxes, None)
        if second is None or second[0] != b"ftyp":
            raise ValueError("Corrupt JP2 file: the signature box is not followed by an ftyp box.")
        has_jp2h = False
        for kind, start, end in boxes:
            if kind == b"jp2h":
                if has_jp2h:
                    raise ValueError("Corrupt JP2 file: a second jp2h box.")
                has_jp2h = True
                self._header_box(data, start, end)
            elif kind == b"jp2c":
                if not has_jp2h:
                    raise ValueError("Corrupt JP2 file: the codestream comes before the jp2h box.")
                self.codestream = data[start:end]
                break
        if self.codestream is None:
            raise ValueError("Corrupt JP2 file: no codestream (jp2c) box.")

    def _header_box(self, data: bytes, start: int, end: int) -> None:
        has_ihdr = False
        for kind, s, e in _boxes(data, start, end):
            body = data[s:e]
            if kind == b"ihdr":
                if len(body) != 14:
                    raise ValueError("Corrupt JP2 file: bad ihdr box.")
                h, w, nc = struct.unpack(">IIH", body[:10])
                if h < 1 or w < 1 or nc < 1:
                    raise ValueError("Corrupt JP2 file: ihdr with a zero size or no components.")
                self.size = (w, h)
                has_ihdr = True
            elif kind == b"colr":
                if self.has_colr:
                    continue  # the first colour specification counts
                if len(body) < 3:
                    raise ValueError("Corrupt JP2 file: bad colr box.")
                method = body[0]
                if method == 1:
                    if len(body) < 7:
                        raise ValueError("Corrupt JP2 file: bad colr box (bad size).")
                    (self.enumcs,) = struct.unpack(">I", body[3:7])
                    self.has_colr = True
                elif method == 2:
                    self.enumcs = 0  # an ICC profile: no enumerated colour space
                    self.has_colr = True
            elif kind == b"pclr":
                if self.pclr is not None:
                    raise ValueError("Corrupt JP2 file: a second pclr box.")
                self.pclr = self._palette(body)
            elif kind == b"cmap":
                if self.pclr is None:
                    raise ValueError("Corrupt JP2 file: a cmap box before its pclr box.")
                if self.cmap is not None:
                    raise ValueError("Corrupt JP2 file: a second cmap box.")
                npc = self.pclr.shape[1]
                if len(body) < 4 * npc:
                    raise ValueError("Corrupt JP2 file: the cmap box does not map every palette column.")
                self.cmap = [list(struct.unpack(">HBB", body[4 * i:4 * i + 4])) for i in range(npc)]
            elif kind == b"cdef":
                if self.cdef is not None:
                    raise ValueError("Corrupt JP2 file: a second cdef box.")
                if len(body) < 2:
                    raise ValueError("Corrupt JP2 file: bad cdef box.")
                (n,) = struct.unpack(">H", body[:2])
                if n == 0 or len(body) != 2 + 6 * n:
                    raise ValueError("Corrupt JP2 file: bad cdef box.")
                self.cdef = [struct.unpack(">HHH", body[2 + 6 * i:8 + 6 * i]) for i in range(n)]
        if not has_ihdr:
            raise ValueError("Corrupt JP2 file: the jp2h box has no ihdr box.")

    @staticmethod
    def _palette(body: bytes):
        if len(body) < 3:
            raise ValueError("Corrupt JP2 file: bad pclr box.")
        ne, npc = struct.unpack(">HB", body[:3])
        if ne == 0 or ne > 1024 or npc == 0 or len(body) < 3 + npc:
            raise ValueError("Corrupt JP2 file: bad pclr box.")
        widths = [((b & 0x7F) + 8) >> 3 for b in body[3:3 + npc]]
        pos = 3 + npc
        if len(body) < pos + ne * sum(widths):
            raise ValueError("Corrupt JP2 file: the pclr box is cut short.")
        entries = np.zeros((ne, npc), dtype=np.int64)
        for j in range(ne):
            for i, width in enumerate(widths):
                entries[j, i] = int.from_bytes(body[pos:pos + width], "big")
                pos += width
        return entries

    def apply(self, comps: list[np.ndarray]) -> list[np.ndarray]:
        """opj_jp2_check_color, opj_jp2_apply_pclr and opj_jp2_apply_cdef on the decoded components."""
        n = len(comps)
        pclr = self.pclr if self.cmap is not None else None  # a palette without cmap is dropped
        if self.cdef is not None:
            channels = len(self.cmap) if pclr is not None else n
            for cn, _typ, asoc in self.cdef:
                if cn >= channels:
                    raise ValueError(f"Corrupt JP2 file: invalid component index {cn} (>= {channels}).")
                if asoc not in (0, 65535) and asoc - 1 >= channels:
                    raise ValueError(f"Corrupt JP2 file: invalid component index {asoc - 1} (>= {channels}).")
            defined = {cn for cn, _typ, _asoc in self.cdef}
            if any(c not in defined for c in range(channels)):
                raise ValueError("Corrupt JP2 file: incomplete channel definitions.")
        if pclr is not None:
            entries = pclr
            npc = entries.shape[1]
            used = [False] * npc
            for i, (cmp, mtyp, pcol) in enumerate(self.cmap):
                if cmp >= n:
                    raise ValueError(f"Corrupt JP2 file: invalid component index {cmp} (>= {n}).")
                if mtyp not in (0, 1) or pcol >= npc or (used[pcol] and mtyp == 1) or (mtyp == 0 and pcol != 0) \
                        or (mtyp == 1 and pcol != i):
                    raise ValueError(f"Corrupt JP2 file: channel {i} of the cmap box maps no palette column as "
                                     "OpenJPEG requires.")
                used[pcol] = True
            if any(not used[i] and mtyp != 0 for i, (_cmp, mtyp, _pcol) in enumerate(self.cmap)):
                raise ValueError("Corrupt JP2 file: a palette column without a mapping.")
            if n == 1 and not all(used):  # OpenJPEG maps every column of a one-component image instead
                self.cmap = [[cmp, 1, i] for i, (cmp, _mtyp, _pcol) in enumerate(self.cmap)]
            mapped = []
            for cmp, mtyp, pcol in self.cmap:
                if mtyp == 0:
                    mapped.append(comps[cmp])
                else:
                    mapped.append(entries[np.clip(comps[cmp], 0, entries.shape[0] - 1), pcol])
            comps = mapped
        if self.cdef is not None:
            comps = list(comps)
            info = [list(entry) for entry in self.cdef]
            for i, (cn, typ, asoc) in enumerate(info):
                if cn >= len(comps) or asoc in (0, 65535):
                    continue
                acn = asoc - 1
                if acn >= len(comps):
                    continue
                if cn != acn and typ == 0:
                    comps[cn], comps[acn] = comps[acn], comps[cn]
                    for later in info[i + 1:]:
                        if later[0] == cn:
                            later[0] = acn
                        elif later[0] == acn:
                            later[0] = cn
        return comps

    @property
    def color_space(self) -> int:
        return _ENUMCS.get(self.enumcs, _UNKNOWN)


# --------------------------------------------------------------------------- OpenCV's Mat


def _cast(values: np.ndarray, dtype) -> np.ndarray:
    """``static_cast``: the low bits of each value, as OpenCV copies components into the ``Mat``."""
    return values.astype(np.int64).astype(dtype)


def _saturate(values: np.ndarray, dtype) -> np.ndarray:
    info = np.iinfo(dtype)
    return np.clip(values, info.min, info.max).astype(dtype)


def _rgb_to_grey(r, g, b, dtype) -> np.ndarray:
    """cvtColor's RGB -> grey in 15-bit fixed point, on channels already cast to ``dtype``."""
    r, g, b = (_cast(c, dtype).astype(np.int64) for c in (r, g, b))
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(dtype)


def _yuv_to_bgr(y, u, v, dtype) -> np.ndarray:
    """cvtColor's YUV -> BGR in 14-bit fixed point (chroma centred on half the type's range)."""
    y, u, v = (_cast(c, dtype).astype(np.int64) for c in (y, u, v))
    half = 128 if dtype == np.uint8 else 32768
    u, v = u - half, v - half
    b = y + ((u * 33292 + (1 << 13)) >> 14)
    g = y + ((u * -6472 + v * -9519 + (1 << 13)) >> 14)
    r = y + ((v * 18678 + (1 << 13)) >> 14)
    return np.stack([_saturate(c, dtype) for c in (b, g, r)], axis=-1)


def _to_mat(comps: list[np.ndarray], channels: int, dtype, color_space: int) -> np.ndarray:
    """Jpeg2KOpjDecoderBase::readData's decodeSRGBData / decodeGrayscaleData / decodeSYCCData."""
    n = len(comps)
    if color_space in (_UNSPECIFIED, _UNKNOWN, _SRGB):
        if channels == 1:
            return _cast(comps[0], dtype) if n <= 2 else _rgb_to_grey(comps[0], comps[1], comps[2], dtype)
        if channels == 3 and n in (3, 4):
            return np.stack([_cast(comps[k], dtype) for k in (2, 1, 0)], axis=-1)
        if channels == 4 and n == 4:
            return np.stack([_cast(comps[k], dtype) for k in (2, 1, 0, 3)], axis=-1)
        kind = "an sRGB"
    elif color_space == _GRAY:
        if channels in (1, 3):
            grey = _cast(comps[0], dtype)
            return grey if channels == 1 else np.stack([grey] * 3, axis=-1)
        kind = "a grey"
    elif color_space == _SYCC:
        if channels == 1:
            return _cast(comps[0], dtype)
        if channels == 3 and n >= 3:
            return _yuv_to_bgr(comps[0], comps[1], comps[2], dtype)
        kind = "an sYCC"
    else:
        name = {_EYCC: "eYCC", _CMYK: "CMYK"}[color_space]
        raise ValueError(f"JPEG 2000: OpenCV does not convert the colour space {name} to sRGB.")
    raise ValueError(f"JPEG 2000: OpenCV has no conversion from {n} components to {channels} channels for "
                     f"{kind} image.")


def decode_jpeg2000(data: bytes, stats: dict | None = None) -> np.ndarray:
    """Decode a JP2 file or a raw JPEG 2000 codestream to what ``cv2.imread(..., IMREAD_UNCHANGED)`` returns.
    ``stats``: a dict to fill with the decoder's counts (:data:`STATS`)."""
    jp2 = None
    if data[:12] == JP2_SIGNATURE:
        jp2 = _Jp2(data)
        codestream = jp2.codestream
    elif data[:4] == J2K_SIGNATURE:
        codestream = data
    else:
        raise ValueError("Not a JPEG 2000 file (neither a JP2 signature box nor a codestream's SOC / SIZ).")
    info = _header(codestream)
    n = info.num_components
    if jp2 is not None and jp2.size != (info.x1 - info.x0, info.y1 - info.y0):
        raise ValueError(f"Corrupt JP2 file: the ihdr box's size {jp2.size} is not the codestream's.")
    # Jpeg2KOpjDecoderBase::readHeader's checks, on the codestream's components.
    if not 1 <= n <= 4:
        raise ValueError(f"JPEG 2000 with {n} components: OpenCV reads 1 to 4.")
    if any(info.is_signed[c] for c in range(n)):
        raise ValueError("JPEG 2000 with signed components: OpenCV does not read them.")
    precision = max(info.precision[c] for c in range(n))
    if precision < 8:
        raise ValueError(f"JPEG 2000 of {precision}-bit components: OpenCV reads 8 bits and more.")
    if precision > 16:
        raise ValueError(f"JPEG 2000 of {precision}-bit components: OpenCV does not read more than 16 bits.")
    if n == 2:
        raise ValueError("JPEG 2000 with 2 components: OpenCV does not read 2-channel images.")
    if info.x0 != 0 or info.y0 != 0:
        raise ValueError("JPEG 2000 with an image offset: OpenCV does not read it.")
    comps = decode_codestream(codestream, info, stats)
    color_space = _UNSPECIFIED
    if jp2 is not None:
        comps = jp2.apply(comps)
        color_space = jp2.color_space
    return _to_mat(comps, n, np.uint8 if precision == 8 else np.uint16, color_space)


# --------------------------------------------------------------------------- writing


def _jp2_header(height: int, width: int, channels: int) -> bytes:
    """The signature, ``ftyp`` and ``jp2h`` boxes (``ihdr``: 8-bit unsigned, JPEG 2000 compression, no IPR;
    ``colr``: enumerated sRGB or grey) as OpenJPEG's ``opj_jp2_write_jp`` / ``_ftyp`` / ``_jp2h`` write them."""
    ftyp = struct.pack(">I4s4sI4s", 20, b"ftyp", b"jp2 ", 0, b"jp2 ")
    ihdr = struct.pack(">I4sIIHBBBB", 22, b"ihdr", height, width, channels, 7, 7, 0, 0)
    colr = struct.pack(">I4sBBBI", 15, b"colr", 1, 0, 0, 17 if channels == 1 else 16)
    jp2h = struct.pack(">I4s", 8 + len(ihdr) + len(colr), b"jp2h") + ihdr + colr
    return JP2_SIGNATURE + ftyp + jp2h


def encode_jpeg2000(image, stats: dict | None = None, compression_x1000: int = 250) -> bytes:
    """Encode a uint8 ``HxW`` (grey) or ``HxWx3`` (BGR) image as the JP2 file ``cv2.imwrite`` writes.

    ``stats``: a dict to fill with the encoder's counts (:data:`ENCODER_STATS`), ``passes_cut`` and the
    rate allocation's slope ``threshold`` (-1 when every pass is kept). ``compression_x1000``: what OpenCV's
    ``IMWRITE_JPEG2000_COMPRESSION_X1000`` sets (rate ``1000 / value``; 1000 is lossless); the writers
    keep OpenCV's default."""
    from super_resolution_tpu_torch.native import get_jpeg2000_encoder_library

    img = np.asarray(image)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"Expected a uint8 HxW or HxWx3 image, got {img.dtype} {img.shape}.")
    height, width = img.shape[:2]
    if min(height, width) < MIN_ENCODE_SIDE:
        raise ValueError(f"JPEG 2000 cannot hold a {width}x{height} image here: OpenJPEG's 5 decomposition levels "
                         f"need at least {MIN_ENCODE_SIDE} pixels a side (cv2.imwrite writes no file).")
    if max(height, width) >= 1 << 30:
        raise ValueError(f"JPEG 2000 writing of a {width}x{height} image is not supported (sides below 2^30).")
    channels = 1 if img.ndim == 2 else 3
    img = np.ascontiguousarray(img)
    head = _jp2_header(height, width, channels)
    lib = get_jpeg2000_encoder_library()
    counts = np.zeros(len(ENCODER_STATS), dtype=np.int64)
    threshold = ctypes.c_double()
    capacity = img.size * 2 + 4096  # a first guess; when it is short the encoder says what it needs
    while True:
        out = np.empty(capacity, dtype=np.uint8)
        n = lib.sr_j2k_encode(img.ctypes.data, height, width, channels, int(compression_x1000), len(head) + 8,
                              out.ctypes.data, capacity, counts.ctypes.data, ctypes.byref(threshold))
        if n != -1:
            break
        capacity = int(counts[ENCODER_STATS.index("packet_bytes")]) + 4096
    if n < 0:
        raise ValueError(f"JPEG 2000 encoding failed (code {n}).")
    if stats is not None:
        stats.update(zip(ENCODER_STATS, (int(v) for v in counts)))
        stats["passes_cut"] = stats["passes"] - stats["passes_kept"]
        stats["threshold"] = threshold.value
    return head + struct.pack(">I4s", 8 + n, b"jp2c") + out[:n].tobytes()
