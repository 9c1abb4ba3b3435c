"""GDAL's GeoTIFF writer (``libgdal.so.32``, GDAL 3.6) through ctypes, for the
port's TIFF reader tests: the layouts GDAL writes and OpenCV reads through
libtiff's RGBA interface -- JPEG-compressed YCbCr tiles with shared
``JPEGTables`` (``COMPRESS=JPEG PHOTOMETRIC=YCBCR TILED=YES``), JPEG RGB and
grey strips, 1-bit (``NBITS=1``) and other sub-byte samples.

The image is handed to GDAL as a ``MEM:::DATAPOINTER=...`` dataset over the
array's memory, given a north-up geotransform (so the file carries the
GeoTIFF tags a GIS writes), and copied to the ``GTiff`` driver with
``GDALCreateCopy`` and the creation options as given. :func:`available` says
whether the library loads; tests that need it skip without it.
"""

from __future__ import annotations

import ctypes
import os
import tempfile

import numpy as np

LIBRARY = "libgdal.so.32"
_P = ctypes.c_void_p
_loaded = {}


def library():
    """The GDAL library with the signatures used here, or None where it does not load."""
    if "gdal" not in _loaded:
        try:
            lib = ctypes.CDLL(LIBRARY)
        except OSError:
            _loaded["gdal"] = None
            return None
        for name, restype, argtypes in (
                ("GDALAllRegister", None, []), ("GDALOpen", _P, [ctypes.c_char_p, ctypes.c_int]),
                ("GDALGetDriverByName", _P, [ctypes.c_char_p]),
                ("GDALCreateCopy", _P, [_P, ctypes.c_char_p, _P, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                                        _P, _P]),
                ("GDALSetGeoTransform", ctypes.c_int, [_P, ctypes.POINTER(ctypes.c_double)]),
                ("GDALClose", None, [_P]), ("CPLGetLastErrorMsg", ctypes.c_char_p, [])):
            getattr(lib, name).restype, getattr(lib, name).argtypes = restype, argtypes
        lib.GDALAllRegister()
        _loaded["gdal"] = lib
    return _loaded["gdal"]


def available() -> bool:
    return library() is not None


def write(image: np.ndarray, **options) -> bytes:
    """The GeoTIFF GDAL writes for a uint8 ``HxW`` (one band) or ``HxWxC`` (bands in order: R, G, B for RGB)
    image under the creation options given as keywords, e.g. ``write(rgb, COMPRESS="JPEG",
    PHOTOMETRIC="YCBCR", TILED="YES", BLOCKXSIZE=128, BLOCKYSIZE=128, JPEG_QUALITY=75)``."""
    lib = library()
    assert lib is not None, f"{LIBRARY} does not load"
    img = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = img.shape[:2]
    bands = 1 if img.ndim == 2 else img.shape[2]
    name = (f"MEM:::DATAPOINTER={img.ctypes.data},PIXELS={w},LINES={h},BANDS={bands},DATATYPE=Byte,"
            f"PIXELOFFSET={bands},LINEOFFSET={w * bands},BANDOFFSET=1")
    source = lib.GDALOpen(name.encode(), 0)
    assert source, lib.CPLGetLastErrorMsg()
    try:
        geo = (ctypes.c_double * 6)(500000.0, 0.5, 0.0, 4200000.0, 0.0, -0.5)
        lib.GDALSetGeoTransform(source, geo)
        pairs = [f"{k}={v}".encode() for k, v in options.items()]
        argv = (ctypes.c_char_p * (len(pairs) + 1))(*pairs, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "out.tif")
            out = lib.GDALCreateCopy(lib.GDALGetDriverByName(b"GTiff"), path.encode(), source, 0, argv, None, None)
            assert out, lib.CPLGetLastErrorMsg()
            lib.GDALClose(out)
            with open(path, "rb") as f:
                return f.read()
    finally:
        lib.GDALClose(source)
