"""Native (C++) libraries of the port, bound with ctypes.

- ``envi_loader.cpp`` (the port's own copy) streams band-sequential float32
  cubes: cropped, seek-based reads on a pool of threads, byte swapping for
  big-endian files.
- ``jpeg_decoder.cpp`` parses sequential and progressive JPEG and decodes
  its Huffman-coded scans into quantised DCT coefficients (the serial half of
  :func:`super_resolution_tpu_torch.utils.jpeg.decode_jpeg`).
- ``jpeg_encoder.cpp`` Huffman-codes quantised DCT blocks into a baseline
  scan (the serial half of :func:`super_resolution_tpu_torch.utils.jpeg.encode_jpeg`).
- ``lzw.cpp`` decodes and encodes TIFF's LZW and decodes GIF's (the serial
  halves of :mod:`super_resolution_tpu_torch.utils.tiff` and
  :mod:`super_resolution_tpu_torch.utils.gif`).
- ``webp_decoder.cpp`` decodes WebP's VP8L (lossless) and VP8 (lossy)
  bitstreams and unfilters ALPH planes; ``webp_encoder.cpp`` writes VP8L
  (the serial halves of :mod:`super_resolution_tpu_torch.utils.webp`).
- ``mpeg4_decoder.cpp`` decodes the macroblocks of MPEG-4 Part 2 Simple
  Profile I- and P-VOPs into YUV 4:2:0 planes and converts them to BGR (the
  serial half of :mod:`super_resolution_tpu_torch.utils.mpeg4`, which reads
  the headers and keeps the reference picture).
- ``vp8_decoder.cpp`` decodes VP8 video, one frame a call, keeping its three
  reference frames and its probabilities between calls, and converts the
  frames shown to BGR (behind :class:`super_resolution_tpu_torch.utils.vp8.Vp8Decoder`).
- ``vp9_decoder.cpp`` decodes VP9 profile 0 video likewise: its eight
  reference slots, four probability contexts and segmentation map between
  calls, superframes split within a call, the shown frames to BGR (behind
  :class:`super_resolution_tpu_torch.utils.vp9.Vp9Decoder`); its constant
  tables are ``vp9_tables.h``.
- ``ffv1_decoder.cpp`` decodes FFV1 video (versions 0-3, 8 bits), keeping
  its slices' contexts between calls, and converts each frame to BGR (behind
  :class:`super_resolution_tpu_torch.utils.ffv1.Ffv1Decoder`).
- ``h264_decoder.cpp`` decodes H.264 video (progressive 8-bit 4:2:0, I, P
  and B slices, CAVLC and CABAC, the 8x8 transform, scaling matrices),
  keeping its parameter sets, decoded reference pictures and the pictures it
  holds back for reordering between calls, and converts each frame to BGR (behind
  :class:`super_resolution_tpu_torch.utils.h264.H264Decoder`); its constant
  tables are ``h264_tables.h`` and ``h264_cabac_tables.h``.
- ``mpeg2_decoder.cpp`` decodes MPEG-1 and MPEG-2 video (I, P and B
  pictures, progressive and interlaced frame pictures, 4:2:0), keeping its
  headers, its two reference pictures and the picture it holds back between
  calls, and converts each frame to BGR (behind
  :class:`super_resolution_tpu_torch.utils.mpeg2.Mpeg2Decoder`); its constant
  tables are ``mpeg2_tables.h``. It shares FFmpeg's simple IDCT and half-pel
  prediction (``simple_idct.h``) with ``mpeg4_decoder.cpp``.
- ``jpeg2000_decoder.cpp`` decodes a JPEG 2000 Part 1 codestream (tier-2,
  tier-1, dequantisation, the 5/3 and 9/7 inverse wavelet transforms, the
  colour transforms) into integer component planes, as OpenJPEG does (the
  serial half of :func:`super_resolution_tpu_torch.utils.jpeg2000.decode_jpeg2000`);
  ``jpeg2000_encoder.cpp`` encodes one uint8 image into the codestream
  OpenJPEG 2.5.3 writes under OpenCV's parameters (the forward 5/3 transform,
  tier-1, the rate allocation, tier-2; the serial half of
  :func:`super_resolution_tpu_torch.utils.jpeg2000.encode_jpeg2000`). The two
  share the MQ states and the tier-1 context tables (``jpeg2000_tables.h``).
  VP8 frames themselves are decoded by ``vp8_core.h``, which
  ``webp_decoder.cpp`` shares; the video decoders convert YUV to BGR with
  ``swscale_bgr.h``, as ``cv2.VideoCapture`` does at any size.

At first use each is compiled with the host's C++ compiler into
``super_resolution_tpu_torch/_build/libsr_<name>_<hash>.so``, where the hash
covers the source, the headers it includes and the flags: an edited source is rebuilt, an unchanged
one loaded as it is. Nothing runs when the module is imported.

:func:`native_available` is false only when the host has no C++ compiler;
then :mod:`super_resolution_tpu_torch.spectral.envi` reads with numpy. The
codecs have no second implementation: without a compiler
:func:`get_jpeg_library`, :func:`get_jpeg_encoder_library`,
:func:`get_lzw_library`, :func:`get_webp_library`,
:func:`get_webp_encoder_library`, :func:`get_mpeg4_library`, :func:`get_vp8_library`,
:func:`get_vp9_library`, :func:`get_ffv1_library`, :func:`get_h264_library`,
:func:`get_mpeg2_library`, :func:`get_jpeg2000_library` and
:func:`get_jpeg2000_encoder_library` raise
``RuntimeError``. A compile that fails, and a
native read that fails, raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["native_available", "get_library", "get_jpeg_library", "get_jpeg_encoder_library", "get_lzw_library",
           "get_webp_library", "get_webp_encoder_library", "get_mpeg4_library", "get_vp8_library", "get_vp9_library",
           "get_ffv1_library", "get_h264_library", "get_mpeg2_library", "get_jpeg2000_library",
           "get_jpeg2000_encoder_library", "read_bsq", "build_library"]

_HERE = Path(__file__).resolve().parent
_SOURCE = _HERE / "envi_loader.cpp"
_JPEG_SOURCE = _HERE / "jpeg_decoder.cpp"
_JPEG_ENCODER_SOURCE = _HERE / "jpeg_encoder.cpp"
_LZW_SOURCE = _HERE / "lzw.cpp"
_WEBP_SOURCE = _HERE / "webp_decoder.cpp"
_WEBP_ENCODER_SOURCE = _HERE / "webp_encoder.cpp"
_MPEG4_SOURCE = _HERE / "mpeg4_decoder.cpp"
_VP8_SOURCE = _HERE / "vp8_decoder.cpp"
_VP9_SOURCE = _HERE / "vp9_decoder.cpp"
_FFV1_SOURCE = _HERE / "ffv1_decoder.cpp"
_H264_SOURCE = _HERE / "h264_decoder.cpp"
_MPEG2_SOURCE = _HERE / "mpeg2_decoder.cpp"
_JPEG2000_SOURCE = _HERE / "jpeg2000_decoder.cpp"
_JPEG2000_ENCODER_SOURCE = _HERE / "jpeg2000_encoder.cpp"
_LIBRARY_NAMES = {_SOURCE: "envi", _JPEG_SOURCE: "jpeg", _JPEG_ENCODER_SOURCE: "jpeg_encoder", _LZW_SOURCE: "lzw",
                  _WEBP_SOURCE: "webp", _WEBP_ENCODER_SOURCE: "webp_encoder", _MPEG4_SOURCE: "mpeg4",
                  _VP8_SOURCE: "vp8", _VP9_SOURCE: "vp9", _FFV1_SOURCE: "ffv1", _H264_SOURCE: "h264",
                  _MPEG2_SOURCE: "mpeg2", _JPEG2000_SOURCE: "jpeg2000",
                  _JPEG2000_ENCODER_SOURCE: "jpeg2000_encoder"}
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_loaded: dict[Path, ctypes.CDLL] = {}


def _compiler() -> str | None:
    return shutil.which("g++") or shutil.which("c++")


def _library_path(source: Path = _SOURCE) -> Path:
    text = source.read_bytes()
    headers = b"".join((_HERE / name.decode()).read_bytes() for name in re.findall(rb'#include "([^"]+)"', text))
    digest = hashlib.sha256(text + headers + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return Path(__file__).resolve().parents[1] / "_build" / f"libsr_{_LIBRARY_NAMES[source]}_{digest}.so"


def build_library(source: Path = _SOURCE) -> Path:
    """Compile ``source`` (default: the ENVI reader) if it is not built yet; return its path.

    Raises ``RuntimeError`` without a compiler or when the compile fails."""
    lib = _library_path(source)
    if lib.is_file():
        return lib
    compiler = _compiler()
    if compiler is None:
        raise RuntimeError(f"No C++ compiler (g++ / c++) on PATH; the native library {source.name} cannot be "
                           "built.")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    out = subprocess.run([compiler, *_FLAGS, str(source), "-o", str(tmp)], capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"Building {source.name} failed (exit {out.returncode}):\n{out.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees a whole file or none
    return lib


def _load(source: Path, signatures: dict) -> ctypes.CDLL:
    """``source``'s library, built and loaded once; ``signatures`` maps each
    function to (restype, argtypes)."""
    with _lock:
        if source not in _loaded:
            lib = ctypes.CDLL(str(build_library(source)))
            for name, (restype, argtypes) in signatures.items():
                getattr(lib, name).restype = restype
                getattr(lib, name).argtypes = argtypes
            _loaded[source] = lib
        return _loaded[source]


_i64, _int, _ptr = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p


def get_library() -> ctypes.CDLL:
    """The loaded ENVI reader, built first if need be."""
    return _load(_SOURCE, {"sr_envi_read_bsq": (_int, [ctypes.c_char_p] + [_i64] * 10
                                                 + [_int, _int, ctypes.POINTER(ctypes.c_float)])})


def get_jpeg_library() -> ctypes.CDLL:
    """The loaded JPEG decoder, built first if need be (``RuntimeError`` without a C++ compiler)."""
    return _load(_JPEG_SOURCE, {"sr_jpeg_decode": (_int, [ctypes.c_char_p, _i64, _ptr, _ptr, _i64, ctypes.c_char_p,
                                                          _int])})


def get_jpeg_encoder_library() -> ctypes.CDLL:
    """The loaded JPEG entropy coder, built first if need be (``RuntimeError`` without a C++ compiler)."""
    return _load(_JPEG_ENCODER_SOURCE, {"sr_jpeg_encode_scan": (_i64, [_ptr, _ptr, _i64] + [_ptr] * 5 + [_i64])})


def get_lzw_library() -> ctypes.CDLL:
    """The loaded LZW codecs of TIFF and GIF, built first if need be (``RuntimeError`` without a C++ compiler)."""
    return _load(_LZW_SOURCE, {"sr_tiff_lzw_decode": (_i64, [ctypes.c_char_p, _i64, _ptr, _i64]),
                               "sr_tiff_lzw_encode": (_i64, [_ptr, _i64, _ptr, _i64]),
                               "sr_gif_lzw_decode": (_i64, [ctypes.c_char_p, _i64, _int, _ptr, _i64])})


def get_webp_library() -> ctypes.CDLL:
    """The loaded WebP decoder, built first if need be (``RuntimeError`` without a C++ compiler)."""
    return _load(_WEBP_SOURCE, {"sr_vp8l_decode": (_int, [ctypes.c_char_p, _i64, _int, _int, _int, _ptr]),
                                "sr_vp8_decode": (_int, [ctypes.c_char_p, _i64, _int, _int, _ptr, _int]),
                                "sr_webp_unfilter_alpha": (None, [_ptr, _int, _int, _int])})


def get_webp_encoder_library() -> ctypes.CDLL:
    """The loaded VP8L encoder, built first if need be (``RuntimeError`` without a C++ compiler)."""
    return _load(_WEBP_ENCODER_SOURCE, {"sr_vp8l_encode": (_i64, [_ptr, _int, _int, _ptr, _i64])})


def get_mpeg4_library() -> ctypes.CDLL:
    """The loaded MPEG-4 Part 2 decoder, built first if need be (``RuntimeError`` without a C++ compiler)."""
    return _load(_MPEG4_SOURCE, {"sr_mpeg4_decode_vop": (_int, [ctypes.c_char_p, _i64, _i64, _ptr, _ptr, _ptr, _ptr,
                                                               ctypes.c_char_p, _int]),
                                 "sr_mpeg4_yuv420_to_bgr": (None, [_ptr, _int, _int, _int, _int, _ptr]),
                                 "sr_mpeg4_idct": (None, [_ptr, _int])})


def get_vp8_library() -> ctypes.CDLL:
    """The loaded VP8 video decoder, built first if need be (``RuntimeError`` without a C++ compiler)."""
    return _load(_VP8_SOURCE, {"sr_vp8_stream_new": (_ptr, []),
                               "sr_vp8_stream_free": (None, [_ptr]),
                               "sr_vp8_stream_decode": (_int, [_ptr, ctypes.c_char_p, _i64, ctypes.c_char_p, _int]),
                               "sr_vp8_stream_size": (None, [_ptr, _ptr]),
                               "sr_vp8_stream_bgr": (None, [_ptr, _ptr]),
                               "sr_vp8_stream_stats": (_int, [_ptr, _ptr, _int])})


def get_vp9_library() -> ctypes.CDLL:
    """The loaded VP9 video decoder, built first if need be (``RuntimeError`` without a C++ compiler)."""
    return _load(_VP9_SOURCE, {"sr_vp9_stream_new": (_ptr, []),
                               "sr_vp9_stream_free": (None, [_ptr]),
                               "sr_vp9_stream_decode": (_int, [_ptr, ctypes.c_char_p, _i64, ctypes.c_char_p, _int]),
                               "sr_vp9_stream_size": (None, [_ptr, _ptr]),
                               "sr_vp9_stream_bgr": (None, [_ptr, _int, _ptr]),
                               "sr_vp9_stream_plane": (None, [_ptr, _int, _int, _ptr]),
                               "sr_vp9_stream_stats": (_int, [_ptr, _ptr, _int]),
                               "sr_vp9_stream_profile": (_int, [_ptr, _ptr, _int])})


def get_ffv1_library() -> ctypes.CDLL:
    """The loaded FFV1 video decoder, built first if need be (``RuntimeError`` without a C++ compiler)."""
    return _load(_FFV1_SOURCE, {"sr_ffv1_stream_new": (_ptr, [ctypes.c_char_p, _i64, _int, _int, ctypes.c_char_p,
                                                              _int]),
                                "sr_ffv1_stream_free": (None, [_ptr]),
                                "sr_ffv1_stream_decode": (_int, [_ptr, ctypes.c_char_p, _i64, ctypes.c_char_p, _int]),
                                "sr_ffv1_stream_bgr": (None, [_ptr, _ptr]),
                                "sr_ffv1_stream_plane": (_i64, [_ptr, _int, _ptr, _ptr]),
                                "sr_ffv1_stream_stats": (_int, [_ptr, _ptr, _int]),
                                "sr_yuv_to_bgr": (None, [_ptr] * 3 + [_int] * 9 + [_ptr])})


def get_h264_library() -> ctypes.CDLL:
    """The loaded H.264 video decoder, built first if need be (``RuntimeError`` without a C++ compiler)."""
    return _load(_H264_SOURCE, {"sr_h264_stream_new": (_ptr, [ctypes.c_char_p, _i64, ctypes.c_char_p, _int]),
                                "sr_h264_stream_free": (None, [_ptr]),
                                "sr_h264_stream_decode": (_int, [_ptr, ctypes.c_char_p, _i64, ctypes.c_char_p, _int]),
                                "sr_h264_stream_flush": (_int, [_ptr, ctypes.c_char_p, _int]),
                                "sr_h264_stream_unit": (_int, [_ptr, _int]),
                                "sr_h264_stream_size": (None, [_ptr, _ptr]),
                                "sr_h264_stream_bgr": (None, [_ptr, _int, _ptr]),
                                "sr_h264_stream_plane": (None, [_ptr, _int, _int, _ptr]),
                                "sr_h264_stream_stats": (_int, [_ptr, _ptr, _int])})


def get_mpeg2_library() -> ctypes.CDLL:
    """The loaded MPEG-1 / MPEG-2 video decoder, built first if need be (``RuntimeError`` without a C++ compiler)."""
    return _load(_MPEG2_SOURCE, {"sr_mpeg2_stream_new": (_ptr, [ctypes.c_char_p, _i64, ctypes.c_char_p, _int]),
                                 "sr_mpeg2_stream_free": (None, [_ptr]),
                                 "sr_mpeg2_stream_decode": (_int, [_ptr, ctypes.c_char_p, _i64, ctypes.c_char_p,
                                                                   _int]),
                                 "sr_mpeg2_stream_flush": (_int, [_ptr, ctypes.c_char_p, _int]),
                                 "sr_mpeg2_stream_unit": (_int, [_ptr, _int]),
                                 "sr_mpeg2_stream_size": (None, [_ptr, _ptr]),
                                 "sr_mpeg2_stream_bgr": (None, [_ptr, _int, _ptr]),
                                 "sr_mpeg2_stream_plane": (None, [_ptr, _int, _int, _ptr]),
                                 "sr_mpeg2_stream_stats": (_int, [_ptr, _ptr, _int])})


def get_jpeg2000_library() -> ctypes.CDLL:
    """The loaded JPEG 2000 codestream decoder, built first if need be (``RuntimeError`` without a C++ compiler)."""
    return _load(_JPEG2000_SOURCE, {"sr_j2k_decode": (_int, [ctypes.c_char_p, _i64, _ptr, _ptr, _i64, _i64,
                                                             ctypes.c_char_p, _int])})

def get_jpeg2000_encoder_library() -> ctypes.CDLL:
    """The loaded JPEG 2000 codestream encoder, built first if need be (``RuntimeError`` without a C++ compiler)."""
    return _load(_JPEG2000_ENCODER_SOURCE, {"sr_j2k_encode": (_i64, [_ptr, _int, _int, _int, _int, _i64, _ptr, _i64,
                                                                     _ptr, ctypes.POINTER(ctypes.c_double)])})


def native_available() -> bool:
    """True where a C++ compiler can build the library (it is then built and loaded)."""
    if _SOURCE not in _loaded and not _library_path().is_file() and _compiler() is None:
        return False
    get_library()
    return True


def read_bsq(
    path: str,
    bands: int,
    rows: int,
    cols: int,
    crop=(None, None, None),
    header_offset: int = 0,
    big_endian: bool = False,
) -> np.ndarray:
    """Read a cropped float32 BSQ sub-cube. ``crop`` is ((b0, b1), (r0, r1),
    (c0, c1)), end-exclusive, with None meaning the full range. Bands are
    read on up to eight threads."""
    (b0, b1), (r0, r1), (c0, c1) = [
        rng if rng is not None else (0, full) for rng, full in zip(crop, (bands, rows, cols))
    ]
    if not (0 <= b0 < b1 <= bands and 0 <= r0 < r1 <= rows and 0 <= c0 < c1 <= cols):
        raise ValueError(f"Invalid crop {crop} of a {bands}x{rows}x{cols} cube.")
    needed = header_offset + 4 * bands * rows * cols
    if os.path.getsize(path) < needed:
        raise IOError(f"{path} holds {os.path.getsize(path)} bytes; a {bands}x{rows}x{cols} float32 cube "
                      f"after {header_offset} header bytes needs {needed}.")
    out = np.empty((b1 - b0, r1 - r0, c1 - c0), dtype=np.float32)
    threads = min(os.cpu_count() or 1, 8)
    status = get_library().sr_envi_read_bsq(
        os.fsencode(path), header_offset, bands, rows, cols, b0, b1, r0, r1, c0, c1,
        1 if big_endian else 0, threads, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if status != 0:
        raise IOError(f"sr_envi_read_bsq failed with status {status} for {path}")
    return out

