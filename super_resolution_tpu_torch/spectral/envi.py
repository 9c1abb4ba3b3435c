"""ENVI BSQ hyperspectral binary I/O (equivalent of
``src/hyperspectral/hyperspectral_data_loader.{h,cpp}``).

Supports the reference's surface: BSQ (band-sequential) float32 binary data
with optional byte swapping and header offset, driven either by a
space-delimited configuration file with crop ranges
(``hyperspectral_data_loader.cpp:269-377``; end_{row,col,band} are
EXCLUSIVE) or by an ENVI ``.hdr`` header ('='-delimited, ``:219-263``).
Saving emits the binary file plus ``.hdr`` and ``.config`` companions so the
data round-trips through both this loader and the reference (:120-194).

Reading goes through the native C++ reader (:mod:`super_resolution_tpu_torch.native`:
cropped seek-based band reads on a thread pool). Only where that library
cannot be built at all (no C++ compiler, ``native_available()`` false) does
the numpy ``memmap`` path read instead; a native read that fails raises.
The two paths return the same values (:func:`read_cube_native`,
:func:`read_cube_numpy`).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from super_resolution_tpu_torch import native
from super_resolution_tpu_torch.image.image_data import ImageData, SpectralMode
from super_resolution_tpu_torch.utils.config_reader import ConfigurationFileReader

__all__ = [
    "HSIBinaryDataParameters",
    "HyperspectralDataLoader",
    "read_envi_header",
    "read_cube_native",
    "read_cube_numpy",
]


@dataclasses.dataclass
class HSIBinaryDataParameters:
    """Mirror of ``HSIBinaryDataParameters`` (``hyperspectral_data_loader.h:52-75``)."""

    interleave: str = "bsq"
    data_type: str = "float"
    big_endian: bool = False
    header_offset: int = 0
    num_data_rows: int = 0
    num_data_cols: int = 0
    num_data_bands: int = 0

    @classmethod
    def from_header_file(cls, header_file_path: str) -> "HSIBinaryDataParameters":
        return read_envi_header(header_file_path)


def read_envi_header(header_file_path: str) -> HSIBinaryDataParameters:
    """Parse an ENVI ``.hdr`` file ('='-delimited keys)."""
    reader = ConfigurationFileReader(delimiter="=")
    reader.read_file(header_file_path)
    v = reader.values
    data_type_code = int(v.get("data type", "4"))
    if data_type_code != 4:
        raise NotImplementedError(
            f"Only float32 (ENVI data type 4) is supported, got {data_type_code}."
        )
    interleave = v.get("interleave", "bsq").lower()
    if interleave != "bsq":
        raise NotImplementedError(f"Only BSQ interleave is supported, got {interleave}.")
    return HSIBinaryDataParameters(
        interleave=interleave,
        data_type="float",
        big_endian=int(v.get("byte order", "0")) != 0,
        header_offset=int(v.get("header offset", "0")),
        num_data_rows=int(v.get("lines", "0")),
        num_data_cols=int(v.get("samples", "0")),
        num_data_bands=int(v.get("bands", "0")),
    )


def read_cube_native(data_path, bands, rows, cols, b, r, c, header_offset, big_endian) -> np.ndarray:
    """Cropped BSQ read through the native reader: float32 ``[b1-b0, r1-r0, c1-c0]``."""
    return native.read_bsq(data_path, bands, rows, cols, crop=(b, r, c), header_offset=header_offset,
                           big_endian=big_endian)


def read_cube_numpy(data_path, bands, rows, cols, b, r, c, header_offset, big_endian) -> np.ndarray:
    """The same read through a numpy ``memmap``."""
    dtype = np.dtype(">f4" if big_endian else "<f4")
    cube = np.memmap(data_path, dtype=dtype, mode="r", offset=header_offset, shape=(bands, rows, cols))
    return np.asarray(cube[b[0]: b[1], r[0]: r[1], c[0]: c[1]], dtype=np.float32)


class HyperspectralDataLoader:
    """Config-file-driven ENVI BSQ reader/writer.

    ``device`` / ``dtype``: where the loaded image's tensor goes (the port's
    entry points default to ``"cuda"``; a CUDA device that is not there raises).
    """

    def __init__(self, file_path: str, device="cuda", dtype: torch.dtype = torch.float32):
        self.file_path = file_path
        self.device = device
        self.dtype = dtype
        self._image: ImageData | None = None

    def load_image_from_envi_file(self) -> None:
        """Read per the configuration file given to the constructor."""
        reader = ConfigurationFileReader(delimiter=" ")
        reader.read_file(self.file_path)

        data_path = reader.get_value_or_die("file")
        if not os.path.isabs(data_path):
            data_path = os.path.normpath(
                os.path.join(os.path.dirname(os.path.abspath(self.file_path)), data_path)
            )
        interleave = reader.get_value("interleave", "bsq").lower()
        if interleave != "bsq":
            raise NotImplementedError("Only BSQ interleave is supported.")
        data_type = reader.get_value("data_type", "float").lower()
        if data_type != "float":
            raise NotImplementedError("Only float binary data is supported.")
        big_endian = reader.get_value("big_endian", "false").lower() == "true"
        header_offset = reader.get_value_as_int("header_offset", 0)
        rows = reader.get_value_as_int("num_data_rows")
        cols = reader.get_value_as_int("num_data_cols")
        bands = reader.get_value_as_int("num_data_bands")
        if rows <= 0 or cols <= 0 or bands <= 0:
            raise ValueError("num_data_rows/cols/bands must all be positive.")

        # Crop ranges; end indices are EXCLUSIVE.
        r0 = reader.get_value_as_int("start_row", 0)
        r1 = reader.get_value_as_int("end_row", rows)
        c0 = reader.get_value_as_int("start_col", 0)
        c1 = reader.get_value_as_int("end_col", cols)
        b0 = reader.get_value_as_int("start_band", 0)
        b1 = reader.get_value_as_int("end_band", bands)
        if not (0 <= r0 < r1 <= rows and 0 <= c0 < c1 <= cols and 0 <= b0 < b1 <= bands):
            raise ValueError("Invalid crop ranges in HSI configuration.")

        read = read_cube_native if native.native_available() else read_cube_numpy
        data = read(data_path, bands, rows, cols, (b0, b1), (r0, r1), (c0, c1), header_offset, big_endian)
        self._image = ImageData(
            data, normalize="never", channel_major=True,
            spectral_mode=SpectralMode.HYPERSPECTRAL if data.shape[0] > 3 else SpectralMode.NONE,
            device=self.device, dtype=self.dtype,
        )

    def get_image(self) -> ImageData:
        if self._image is None:
            raise ValueError("No image loaded; call load_image_from_envi_file first.")
        return self._image

    def save_image(self, image, big_endian: bool = False) -> None:
        """Write BSQ float32 binary + ``.hdr`` + ``.config`` companions."""
        arr = getattr(image, "hidden_array", image)
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        arr = np.asarray(arr, dtype=np.float64)
        if arr.ndim == 2:
            arr = arr[None]
        bands, rows, cols = arr.shape
        dtype = np.dtype(">f4" if big_endian else "<f4")
        arr.astype(dtype).tofile(self.file_path)

        hdr_path = self.file_path + ".hdr"
        with open(hdr_path, "w") as f:
            f.write("ENVI\n")
            f.write("description = {\n  super_resolution_tpu_torch ENVI export}\n")
            f.write(f"samples = {cols}\n")
            f.write(f"lines   = {rows}\n")
            f.write(f"bands   = {bands}\n")
            f.write("header offset = 0\n")
            f.write("file type = ENVI Standard\n")
            f.write("data type = 4\n")
            f.write("interleave = bsq\n")
            f.write(f"byte order = {1 if big_endian else 0}\n")

        config_path = self.file_path + ".config"
        with open(config_path, "w") as f:
            f.write(f"file             {os.path.abspath(self.file_path)}\n")
            f.write("interleave       bsq\n")
            f.write("data_type        float\n")
            f.write(f"big_endian       {'true' if big_endian else 'false'}\n")
            f.write("header_offset    0\n")
            f.write(f"num_data_rows    {rows}\n")
            f.write(f"num_data_cols    {cols}\n")
            f.write(f"num_data_bands   {bands}\n")
