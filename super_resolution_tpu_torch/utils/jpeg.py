"""JPEG decoding with what ``cv2.imread(path, IMREAD_UNCHANGED)`` returns.

The JAX package reads JPEG through OpenCV, whose decoder is libjpeg-turbo
with its defaults: the integer ("islow") inverse DCT, fancy (triangle)
chroma upsampling for h2v1, h1v2 and h2v2 subsampling and replication for
other factors, integer YCbCr -> RGB, delivered as 8-bit BGR (or grey for a
one-component file). This module computes the same bits:

- the serial half, marker parsing and Huffman decoding into quantised DCT
  coefficients, is C++ (``native/jpeg_decoder.cpp``, built at first use by
  :mod:`super_resolution_tpu_torch.native`); a host without a C++ compiler
  raises ``RuntimeError`` (there is no second decoder);
- dequantisation, the inverse DCT, upsampling and the colour conversion are
  numpy over all blocks at once, with libjpeg-turbo's integer arithmetic.

Supported: 8-bit sequential (SOF0 / SOF1) and progressive (SOF2) Huffman
JPEG, grey and three components, sampling factors 1-4 in each direction
whose ratios are whole (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...), restart
markers, optimised Huffman tables (and the standard tables where a
Motion-JPEG frame has no DHT), any image size. A progressive file's scans
(DC first / refine, AC first / refine with spectral selection) are gathered
into one coefficient buffer in C++; the rest of the decode is the same as a
sequential file's. A progressive file whose scans stop before its first ten
coefficients are refined to bit 0 (libjpeg-turbo then smooths its blocks),
lossless, hierarchical and arithmetic-coded JPEG, 12-bit samples and CMYK
raise ``NotImplementedError`` naming the feature; corrupt data raises
``ValueError``.

Encoding (:func:`encode_jpeg`) writes what ``cv2.imwrite(path, image)``
writes for a uint8 grey or BGR image, byte for byte (see its docstring).
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

__all__ = ["decode_jpeg", "decode_jpeg_frames", "encode_jpeg", "jpeg_coefficients"]

_MESSAGE_BYTES = 256


class _Info(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32), ("height", ctypes.c_int32), ("num_components", ctypes.c_int32),
        ("jfif", ctypes.c_int32), ("adobe_transform", ctypes.c_int32), ("component_id", ctypes.c_int32 * 3),
        ("h", ctypes.c_int32 * 3), ("v", ctypes.c_int32 * 3), ("blocks_w", ctypes.c_int64 * 3),
        ("blocks_h", ctypes.c_int64 * 3), ("num_coefficients", ctypes.c_int64),
        ("quant", (ctypes.c_uint16 * 64) * 3),
    ]


def _raise(status: int, message) -> None:
    text = message.value.decode("ascii", "replace")
    if status == -2:
        raise NotImplementedError(f"{text} is not supported by the port's JPEG decoder (sequential and progressive Huffman JPEG are).")
    raise ValueError(f"Cannot decode JPEG: {text}.")


def jpeg_coefficients(data: bytes):
    """(frame info, [per component int16 ``[blocks_h, blocks_w, 64]`` in natural order])."""
    from super_resolution_tpu_torch import native

    lib = native.get_jpeg_library()
    info = _Info()
    message = ctypes.create_string_buffer(_MESSAGE_BYTES)
    status = lib.sr_jpeg_decode(data, len(data), ctypes.byref(info), None, 0, message, _MESSAGE_BYTES)
    if status != 1:
        _raise(status, message)
    coefs = np.zeros(info.num_coefficients, dtype=np.int16)
    status = lib.sr_jpeg_decode(data, len(data), ctypes.byref(info), coefs.ctypes.data, coefs.size, message,
                                _MESSAGE_BYTES)
    if status != 0:
        _raise(status, message)
    blocks, start = [], 0
    for c in range(info.num_components):
        bh, bw = info.blocks_h[c], info.blocks_w[c]
        blocks.append(coefs[start:start + bh * bw * 64].reshape(bh, bw, 64))
        start += bh * bw * 64
    return info, blocks


# libjpeg's jidctint.c: CONST_BITS = 13, PASS1_BITS = 2, and FIX(c) = round(c * 2**13).
_FIX_0_298631336, _FIX_0_390180644, _FIX_0_541196100, _FIX_0_765366865 = 2446, 3196, 4433, 6270
_FIX_0_899976223, _FIX_1_175875602, _FIX_1_501321110, _FIX_1_847759065 = 7373, 9633, 12299, 15137
_FIX_1_961570560, _FIX_2_053119869, _FIX_2_562915447, _FIX_3_072711026 = 16069, 16819, 20995, 25172


def _idct_1d(v, shift):
    """One pass of libjpeg's islow IDCT over eight int64 arrays (frequencies
    0..7 of a column or a row); returns the eight outputs descaled by ``shift``."""
    z1 = (v[2] + v[6]) * _FIX_0_541196100
    tmp2 = z1 - v[6] * _FIX_1_847759065
    tmp3 = z1 + v[2] * _FIX_0_765366865
    tmp0 = (v[0] + v[4]) << 13
    tmp1 = (v[0] - v[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * _FIX_1_175875602
    o0 = o0 * _FIX_0_298631336
    o1 = o1 * _FIX_2_053119869
    o2 = o2 * _FIX_3_072711026
    o3 = o3 * _FIX_1_501321110
    z1 = z1 * -_FIX_0_899976223
    z2 = z2 * -_FIX_2_562915447
    z3 = z3 * -_FIX_1_961570560 + z5
    z4 = z4 * -_FIX_0_390180644 + z5
    o0 = o0 + z1 + z3
    o1 = o1 + z2 + z4
    o2 = o2 + z2 + z3
    o3 = o3 + z1 + z4
    half = 1 << (shift - 1)
    return [(a + half) >> shift for a in (tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0,
                                          tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3)]


def _samples(blocks: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Quantised coefficients ``[n, bh, bw, 64]`` and tables ``[n, 64]`` -> uint8 samples ``[n, bh * 8, bw * 8]``."""
    n, bh, bw, _ = blocks.shape
    d = blocks.astype(np.int64).reshape(n, -1, 8, 8) * quant.astype(np.int64).reshape(n, 1, 8, 8)
    d = d.reshape(-1, 8, 8)
    # Pass 1: columns (vertical frequencies), scaled up by 2**PASS1_BITS.
    ws = np.stack(_idct_1d([d[:, r, :] for r in range(8)], 13 - 2), axis=1)
    # Pass 2: rows, descaled by 2**(CONST_BITS + PASS1_BITS + 3).
    out = np.stack(_idct_1d([ws[:, :, c] for c in range(8)], 13 + 2 + 3), axis=2)
    # libjpeg-turbo's SIMD IDCT saturates (its range-limit table agrees within +-512).
    pixels = np.clip(out + 128, 0, 255).astype(np.uint8)
    return pixels.reshape(n, bh, bw, 8, 8).transpose(0, 1, 3, 2, 4).reshape(n, bh * 8, bw * 8)


def _edges(p: np.ndarray, axis: int):
    """The neighbours before and after each sample along ``axis``, the edge sample repeated."""
    n = p.shape[axis]
    before = np.take(p, np.r_[0, np.arange(n - 1)], axis=axis)
    after = np.take(p, np.r_[np.arange(1, n), n - 1], axis=axis)
    return before, after


def _interleave(even: np.ndarray, odd: np.ndarray, axis: int) -> np.ndarray:
    axis %= even.ndim
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample(p: np.ndarray, h_expand: int, v_expand: int) -> np.ndarray:
    """libjpeg-turbo's upsampler (jdsample.c) on one component's real samples ``[..., rows, cols]``: each
    frame's edges are its own (a TIFF's strips and tiles are separate frames)."""
    p = p.astype(np.int32)
    width = p.shape[-1]
    if (h_expand, v_expand) == (2, 1) and width > 2:          # h2v1_fancy_upsample
        left, right = _edges(p, -1)
        return _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2, -1)
    if (h_expand, v_expand) == (1, 2):                         # h1v2_fancy_upsample
        above, below = _edges(p, -2)
        return _interleave((3 * p + above + 1) >> 2, (3 * p + below + 2) >> 2, -2)
    if (h_expand, v_expand) == (2, 2) and width > 2:          # h2v2_fancy_upsample
        above, below = _edges(p, -2)
        rows = []
        for colsum in (3 * p + above, 3 * p + below):
            left, right = _edges(colsum, -1)
            rows.append(_interleave((3 * colsum + left + 8) >> 4, (3 * colsum + right + 7) >> 4, -1))
        return _interleave(rows[0], rows[1], -2)
    return np.repeat(np.repeat(p, v_expand, axis=-2), h_expand, axis=-1)  # h2v1 / h2v2 / int_upsample


def _color_tables():
    """jdcolor.c's build_ycc_rgb_table: SCALEBITS = 16, FIX(x) = round(x * 2**16)."""
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda c: int(c * 65536 + 0.5)  # noqa: E731
    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)


_CR_R, _CB_B, _CR_G, _CB_G = _color_tables()


def _guessed_rgb(info) -> bool:
    """libjpeg's guess of a 3-component file's colour space (jdapimin.c): JFIF
    means YCbCr, else an Adobe marker's transform flag, else component ids
    'R', 'G', 'B'. True where the components are R, G, B."""
    if info.jfif:
        return False
    if info.adobe_transform >= 0:
        return info.adobe_transform == 0
    return tuple(info.component_id[:3]) == (82, 71, 66)


def decode_jpeg_frames(frames, rgb: bool) -> list:
    """Finish the decode of several JPEG streams (a TIFF's strips or tiles),
    each given as :func:`jpeg_coefficients` returns it, to uint8 ``HxW`` /
    ``HxWx3`` (BGR) arrays. ``rgb`` says what 3-component frames hold, as the
    caller tells libjpeg (``jpeg_color_space``): True takes the components as
    R, G, B without a transform (libtiff's ``JCS_UNKNOWN`` for RGB files),
    False converts YCbCr to RGB. The frames of one geometry go through the
    inverse DCT, the upsampling and the colour conversion together; each frame
    keeps its own edges."""
    groups = {}
    for k, (info, blocks) in enumerate(frames):
        n = info.num_components
        key = (info.width, info.height, n, tuple(info.h[:n]), tuple(info.v[:n]),
               tuple(b.shape for b in blocks))
        groups.setdefault(key, []).append(k)
    out = [None] * len(frames)
    for (width, height, n, hs, vs, _), members in groups.items():
        hmax, vmax = max(hs), max(vs)
        planes = []
        for c in range(n):
            h, v = hs[c], vs[c]
            real_w, real_h = -(-width * h // hmax), -(-height * v // vmax)  # libjpeg's downsampled size
            blocks = np.stack([frames[k][1][c] for k in members])
            quant = np.array([np.ctypeslib.as_array(frames[k][0].quant[c]) for k in members])
            samples = _samples(blocks, quant)[:, :real_h, :real_w]
            planes.append(_upsample(samples, hmax // h, vmax // v)[:, :height, :width].astype(np.int64))
        if n == 1:
            for i, k in enumerate(members):
                out[k] = planes[0][i].astype(np.uint8)
            continue
        if rgb:
            r, g, b = planes
        else:
            y, cb, cr = planes
            r = y + _CR_R[cr]
            g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
            b = y + _CB_B[cb]
        bgr = np.empty(b.shape + (3,), np.uint8)
        for i, v in enumerate((b, g, r)):
            bgr[..., i] = np.clip(v, 0, 255)
        for i, k in enumerate(members):
            out[k] = bgr[i]
    return out


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode JPEG bytes to uint8 ``HxW`` (one component) or ``HxWx3`` (BGR),
    with the colour space guessed as libjpeg guesses it from the file's
    markers (JFIF, Adobe, component ids)."""
    frame = jpeg_coefficients(bytes(data))
    return decode_jpeg_frames([frame], _guessed_rgb(frame[0]))[0]


# --------------------------------------------------------------------------- encoding

# The zigzag scan: the natural (row-major) index of the k-th coefficient.
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
    28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
    54, 47, 55, 62, 63])
# ITU T.81 Annex K.1 quantisation tables (natural order): luminance, chrominance.
_STD_QUANT = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29,
     51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121,
     120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99,
     99, 99, 99, 99] + [99] * 32], dtype=np.int64)
# ITU T.81 Annex K.3 Huffman tables: (code counts by length 1-16, symbols), luminance then chrominance.
_STD_DC = [((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12))),
           ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))]
_STD_AC = [((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a3435363738"
    "393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a92939495969798999aa2a3a4a5"
    "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
           ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a262728292a353637"
    "38393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a92939495969798999aa2a3"
    "a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))]
# jcparam.c's jpeg_set_quality(95) (OpenCV's default IMWRITE_JPEG_QUALITY) with force_baseline:
# each entry scaled by 200 - 2 * 95 = 10 %, rounded, clamped to 1..255.
_QUANT = np.clip((_STD_QUANT * 10 + 50) // 100, 1, 255)

# jccolor.c's rgb_ycc_start: SCALEBITS = 16, FIX(x) = round(x * 2**16); the
# B => Cb and R => Cr tables are the same.
_FIX = lambda c: int(c * 65536 + 0.5)  # noqa: E731
_I = np.arange(256, dtype=np.int64)
_HALF = 1 << 15
_TO_Y_R, _TO_Y_G, _TO_Y_B = _FIX(0.29900) * _I, _FIX(0.58700) * _I, _FIX(0.11400) * _I + _HALF
_TO_CB_R, _TO_CB_G = -_FIX(0.16874) * _I, -_FIX(0.33126) * _I
_TO_CB_B = _FIX(0.5) * _I + (128 << 16) + _HALF - 1
_TO_CR_G, _TO_CR_B = -_FIX(0.41869) * _I, -_FIX(0.08131) * _I


def _fdct_1d(d, shift0, shift1):
    """One pass of jfdctint.c's jpeg_fdct_islow over eight int64 arrays;
    outputs 0 / 4 descaled by ``shift0`` (a left shift where negative), the
    others by ``shift1``."""
    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if shift0 < 0:
        out[0], out[4] = (tmp10 + tmp11) << -shift0, (tmp10 - tmp11) << -shift0
    else:
        out[0], out[4] = descale(tmp10 + tmp11, shift0), descale(tmp10 - tmp11, shift0)
    z1 = (tmp12 + tmp13) * _FIX_0_541196100
    out[2] = descale(z1 + tmp13 * _FIX_0_765366865, shift1)
    out[6] = descale(z1 - tmp12 * _FIX_1_847759065, shift1)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _FIX_1_175875602
    tmp4, tmp5 = tmp4 * _FIX_0_298631336, tmp5 * _FIX_2_053119869
    tmp6, tmp7 = tmp6 * _FIX_3_072711026, tmp7 * _FIX_1_501321110
    z1, z2 = z1 * -_FIX_0_899976223, z2 * -_FIX_2_562915447
    z3, z4 = z3 * -_FIX_1_961570560 + z5, z4 * -_FIX_0_390180644 + z5
    out[7] = descale(tmp4 + z1 + z3, shift1)
    out[5] = descale(tmp5 + z2 + z4, shift1)
    out[3] = descale(tmp6 + z2 + z3, shift1)
    out[1] = descale(tmp7 + z1 + z4, shift1)
    return out


def _quantised_blocks(plane: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """uint8 samples ``[bh * 8, bw * 8]`` -> quantised coefficients ``[bh, bw, 64]``
    in zigzag order: jcdctmgr.c's forward_DCT (islow) and quantize."""
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    d = plane.astype(np.int64).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8) - 128
    # Pass 1: rows, scaled up by 2**PASS1_BITS; pass 2: columns, descaled by PASS1_BITS.
    ws = np.stack(_fdct_1d([d[:, :, c] for c in range(8)], -2, 13 - 2), axis=2)
    coef = np.stack(_fdct_1d([ws[:, r, :] for r in range(8)], 2, 13 + 2), axis=1).reshape(-1, 64)
    # libjpeg-turbo divides by the divisor 8q through a reciprocal
    # (compute_reciprocal); for every |x| < 2**15 and q in 1..255 that rounds
    # exactly as this division does.
    divisor = 8 * quant.astype(np.int64)
    q = (np.abs(coef) + divisor // 2) // divisor
    q = np.where(coef < 0, -q, q)
    return q[:, _ZIGZAG].reshape(bh, bw, 64).astype(np.int16)


def _edge_pad(p: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(p, ((0, rows - p.shape[0]), (0, cols - p.shape[1])), mode="edge")


def _huffman_codes(bits, values):
    """Canonical codes (ITU T.81 C.2): (code [256] uint16, size [256] uint8) by symbol."""
    code, size = np.zeros(256, np.uint16), np.zeros(256, np.uint8)
    next_code, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            code[values[k]], size[values[k]] = next_code, length
            next_code += 1
            k += 1
        next_code <<= 1
    return code, size


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(image) -> bytes:
    """Encode a uint8 ``HxW`` (grey) or ``HxWx3`` (BGR) image as ``cv2.imwrite``
    does with its defaults (libjpeg-turbo): byte for byte the same file.

    The file: SOI; a JFIF APP0 (1.01, no units, density 1x1); quality 95
    tables (luminance, and chrominance for colour), each in its own DQT;
    SOF0 with Y at 2x2 and Cb / Cr at 1x1 (one component at 1x1 for grey);
    the standard Huffman tables of the components, each in its own DHT; one
    interleaved scan without restarts; EOI. The samples go through
    libjpeg-turbo's integer arithmetic: ``rgb_ycc_convert``, ``h2v2_downsample``
    after ``expand_right_edge`` (the bias alternating 1, 2 along a row), the
    last row repeated down to the sampling factor and then to whole blocks,
    ``jpeg_fdct_islow`` and its rounded quantisation; in a partial MCU
    the blocks past the image are jccoefct.c's dummy blocks (no AC, the DC of
    the block before). The Huffman coding is C++ (``native/jpeg_encoder.cpp``).
    """
    img = np.asarray(image)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"Expected a uint8 HxW or HxWx3 image, got {img.dtype} {img.shape}.")
    height, width = img.shape[:2]
    if not (0 < height <= 65535 and 0 < width <= 65535):
        raise ValueError(f"JPEG cannot hold a {width}x{height} image (each side 1 to 65535).")
    if img.ndim == 2:
        planes, factors, hmax, vmax = [img.astype(np.int64)], [(1, 1)], 1, 1
    else:
        b, g, r = (img[..., i].astype(np.int64) for i in range(3))
        planes = [(_TO_Y_R[r] + _TO_Y_G[g] + _TO_Y_B[b]) >> 16, (_TO_CB_R[r] + _TO_CB_G[g] + _TO_CB_B[b]) >> 16,
                  (_TO_CB_B[r] + _TO_CR_G[g] + _TO_CR_B[b]) >> 16]
        factors, hmax, vmax = [(2, 2), (1, 1), (1, 1)], 2, 2
    mcus_x, mcus_y = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    grids = []
    for ci, (plane, (h, v)) in enumerate(zip(planes, factors)):
        wb, hb = -(-width * h // (8 * hmax)), -(-height * v // (8 * vmax))
        if (h, v) == (hmax, vmax):
            samples = _edge_pad(plane, hb * 8, wb * 8)
        else:  # h2v2_downsample on rows repeated to pairs and columns to 16 x blocks
            p = _edge_pad(plane, -(-height // 2) * 2, wb * 16)
            bias = np.tile(np.array([1, 2], np.int64), wb * 4)
            down = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + bias) >> 2
            samples = _edge_pad(down, hb * 8, wb * 8)
        blocks = _quantised_blocks(samples, _QUANT[min(ci, 1)])
        if len(planes) == 1:
            grids.append(blocks)
            continue
        # jccoefct.c's dummy blocks: right of the image in the last MCU column
        # (DC of the block to the left), then whole rows below it in the last
        # MCU row (DC of the last block of the MCU's row above).
        full = np.zeros((mcus_y * v, mcus_x * h, 64), np.int16)
        full[:hb, :wb] = blocks
        for col in range(wb, mcus_x * h):
            full[:hb, col, 0] = full[:hb, col - 1, 0]
        for row in range(hb, mcus_y * v):
            full[row, :, 0] = np.repeat(full[row - 1, h - 1::h, 0], h)
        grids.append(full)
    if len(planes) == 1:
        order = grids[0].reshape(-1, 64)
        component = np.zeros(len(order), np.uint8)
    else:
        # MCU by MCU: Y's v rows of h blocks, then Cb, then Cr.
        parts = [g.reshape(mcus_y, v, mcus_x, h, 64).transpose(0, 2, 1, 3, 4).reshape(mcus_y, mcus_x, v * h, 64)
                 for g, (h, v) in zip(grids, factors)]
        order = np.concatenate(parts, axis=2).reshape(-1, 64)
        component = np.tile(np.repeat(np.arange(3, dtype=np.uint8), [h * v for h, v in factors]), mcus_x * mcus_y)
    order = np.ascontiguousarray(order)
    tables = [min(ci, 1) for ci in range(len(planes))]
    dc = [_huffman_codes(*_STD_DC[t]) for t in tables]
    ac = [_huffman_codes(*_STD_AC[t]) for t in tables]
    dc_code = np.ascontiguousarray(np.stack([c[:16] for c, _ in dc]))
    dc_size = np.ascontiguousarray(np.stack([s[:16] for _, s in dc]))
    ac_code, ac_size = np.ascontiguousarray(np.stack([c for c, _ in ac])), np.ascontiguousarray(np.stack([s for _, s in ac]))
    out = np.empty(len(order) * 512 + 64, np.uint8)
    from super_resolution_tpu_torch import native

    n = native.get_jpeg_encoder_library().sr_jpeg_encode_scan(
        order.ctypes.data, component.ctypes.data, len(order), dc_code.ctypes.data, dc_size.ctypes.data,
        ac_code.ctypes.data, ac_size.ctypes.data, out.ctypes.data, out.size)
    if n < 0:
        raise ValueError(f"JPEG entropy coding failed (status {n}).")
    ncomp = len(planes)
    header = [b"\xff\xd8", _segment(0xE0, b"JFIF\0" + bytes([1, 1, 0, 0, 1, 0, 1, 0, 0]))]
    for t in sorted(set(tables)):
        header.append(_segment(0xDB, bytes([t]) + _QUANT[t][_ZIGZAG].astype(np.uint8).tobytes()))
    sof = struct.pack(">BHHB", 8, height, width, ncomp)
    for ci, (h, v) in enumerate(factors):
        sof += bytes([ci + 1, (h << 4) | v, tables[ci]])
    header.append(_segment(0xC0, sof))
    for t in sorted(set(tables)):
        for cls, (bits, values) in ((0, _STD_DC[t]), (1, _STD_AC[t])):
            header.append(_segment(0xC4, bytes([(cls << 4) | t, *bits]) + bytes(values)))
    sos = bytes([ncomp]) + b"".join(bytes([ci + 1, (tables[ci] << 4) | tables[ci]]) for ci in range(ncomp))
    header.append(_segment(0xDA, sos + bytes([0, 63, 0])))
    return b"".join(header) + out[:n].tobytes() + b"\xff\xd9"
