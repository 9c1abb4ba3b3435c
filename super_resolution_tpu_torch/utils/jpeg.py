"""Baseline JPEG decoding with what ``cv2.imread(path, IMREAD_UNCHANGED)`` returns.

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

Supported: 8-bit sequential Huffman JPEG (SOF0 / SOF1), grey and three
components, sampling factors 1-4 in each direction whose ratios are whole
(4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...), restart markers, optimised
Huffman tables (and the standard tables where a Motion-JPEG frame has no
DHT), any image size. Progressive, lossless, hierarchical and arithmetic-
coded JPEG, 12-bit samples and CMYK raise ``NotImplementedError`` naming
the feature; corrupt data raises ``ValueError``.
"""

from __future__ import annotations

import ctypes

import numpy as np

__all__ = ["decode_jpeg"]

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
        raise NotImplementedError(f"{text} is not supported by the port's JPEG decoder (baseline JPEG is).")
    raise ValueError(f"Cannot decode JPEG: {text}.")


def _coefficients(data: bytes):
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


def _samples(blocks: np.ndarray, quant) -> np.ndarray:
    """Quantised coefficients ``[bh, bw, 64]`` -> uint8 samples ``[bh * 8, bw * 8]``."""
    bh, bw, _ = blocks.shape
    d = blocks.astype(np.int64).reshape(-1, 8, 8) * np.asarray(quant, dtype=np.int64).reshape(1, 8, 8)
    # Pass 1: columns (vertical frequencies), scaled up by 2**PASS1_BITS.
    ws = np.stack(_idct_1d([d[:, r, :] for r in range(8)], 13 - 2), axis=1)
    # Pass 2: rows, descaled by 2**(CONST_BITS + PASS1_BITS + 3).
    out = np.stack(_idct_1d([ws[:, :, c] for c in range(8)], 13 + 2 + 3), axis=2)
    # libjpeg-turbo's SIMD IDCT saturates (its range-limit table agrees within +-512).
    pixels = np.clip(out + 128, 0, 255).astype(np.uint8)
    return pixels.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)


def _edges(p: np.ndarray, axis: int):
    """The neighbours before and after each sample along ``axis``, the edge sample repeated."""
    n = p.shape[axis]
    before = np.take(p, np.r_[0, np.arange(n - 1)], axis=axis)
    after = np.take(p, np.r_[np.arange(1, n), n - 1], axis=axis)
    return before, after


def _interleave(even: np.ndarray, odd: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample(p: np.ndarray, h_expand: int, v_expand: int) -> np.ndarray:
    """libjpeg-turbo's upsampler (jdsample.c) on one component's real samples."""
    p = p.astype(np.int32)
    width = p.shape[1]
    if (h_expand, v_expand) == (2, 1) and width > 2:          # h2v1_fancy_upsample
        left, right = _edges(p, 1)
        return _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2, 1)
    if (h_expand, v_expand) == (1, 2):                         # h1v2_fancy_upsample
        above, below = _edges(p, 0)
        return _interleave((3 * p + above + 1) >> 2, (3 * p + below + 2) >> 2, 0)
    if (h_expand, v_expand) == (2, 2) and width > 2:          # h2v2_fancy_upsample
        above, below = _edges(p, 0)
        rows = []
        for colsum in (3 * p + above, 3 * p + below):
            left, right = _edges(colsum, 1)
            rows.append(_interleave((3 * colsum + left + 8) >> 4, (3 * colsum + right + 7) >> 4, 1))
        return _interleave(rows[0], rows[1], 0)
    return np.repeat(np.repeat(p, v_expand, axis=0), h_expand, axis=1)  # h2v1 / h2v2 / int_upsample


def _color_tables():
    """jdcolor.c's build_ycc_rgb_table: SCALEBITS = 16, FIX(x) = round(x * 2**16)."""
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda c: int(c * 65536 + 0.5)  # noqa: E731
    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)


_CR_R, _CB_B, _CR_G, _CB_G = _color_tables()


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode JPEG bytes to uint8 ``HxW`` (one component) or ``HxWx3`` (BGR)."""
    info, blocks = _coefficients(bytes(data))
    width, height, n = info.width, info.height, info.num_components
    hmax, vmax = max(info.h[:n]), max(info.v[:n])
    planes = []
    for c in range(n):
        h, v = info.h[c], info.v[c]
        real_w, real_h = -(-width * h // hmax), -(-height * v // vmax)  # libjpeg's downsampled size
        samples = _samples(blocks[c], info.quant[c])[:real_h, :real_w]
        planes.append(_upsample(samples, hmax // h, vmax // v)[:height, :width].astype(np.int64))
    if n == 1:
        return planes[0].astype(np.uint8)
    # libjpeg's guess of the colour space (jdapimin.c): JFIF means YCbCr, else
    # an Adobe marker's transform flag, else component ids 'R', 'G', 'B'.
    if info.jfif:
        rgb = False
    elif info.adobe_transform >= 0:
        rgb = info.adobe_transform == 0
    else:
        rgb = tuple(info.component_id[:3]) == (82, 71, 66)
    if rgb:
        r, g, b = planes
    else:
        y, cb, cr = planes
        r = y + _CR_R[cr]
        g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
        b = y + _CB_B[cb]
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)
