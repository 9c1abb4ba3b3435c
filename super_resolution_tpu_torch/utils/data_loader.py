"""Extension-dispatched image I/O (equivalent of ``src/util/data_loader.{h,cpp}``).

Image extensions load through the port's own codecs
(:mod:`super_resolution_tpu_torch.utils.image_io`: PNG, BMP, JPEG --
sequential and progressive --, TIFF -- JPEG-compressed (GDAL's tiled
YCbCr GeoTIFFs), YCbCr, palette and bilevel files among them --, GIF, WebP
and JPEG 2000, with what ``cv2.imread(path, IMREAD_UNCHANGED)`` returns;
animated WebP raises
``NotImplementedError``); anything else is an HSI configuration file for the
ENVI BSQ path (``data_loader.cpp:96-114``). As in the JAX package, an image
whose values pass 255 (a 16-bit file, say) makes ``ImageData`` raise
``ValueError`` ("Invalid pixel range"): it is not rescaled.
Directory loads are sorted by filename — the reference uses raw ``readdir``
order (``data_loader.cpp:75-94``), which is filesystem-dependent; sorting is
the deterministic fix.

Loaded images are placed on ``device`` (default ``"cuda"``, as every entry
point of the port) as ``dtype`` (default float32).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from super_resolution_tpu_torch.image.image_data import ImageData
from super_resolution_tpu_torch.spectral.envi import HyperspectralDataLoader
from super_resolution_tpu_torch.utils.image_io import IMAGE_EXTENSIONS, read_image, write_image

__all__ = ["load_image", "load_images", "save_image"]


def load_image(file_path: str, device="cuda", dtype: torch.dtype = torch.float32) -> ImageData:
    """Load a standard image (normalized to [0, 1]) or an ENVI config path."""
    ext = os.path.splitext(file_path)[1].lower()
    if ext in IMAGE_EXTENSIONS:
        return ImageData(read_image(file_path).astype(np.float64), device=device, dtype=dtype)
    loader = HyperspectralDataLoader(file_path, device=device, dtype=dtype)
    loader.load_image_from_envi_file()
    return loader.get_image()


def load_images(directory: str, device="cuda", dtype: torch.dtype = torch.float32) -> list[ImageData]:
    """Load all images in a directory, sorted by filename."""
    if not os.path.isdir(directory):
        raise NotADirectoryError(directory)
    names = sorted(
        f for f in os.listdir(directory)
        if not f.startswith(".") and os.path.isfile(os.path.join(directory, f))
    )
    return [load_image(os.path.join(directory, f), device=device, dtype=dtype) for f in names]


def save_image(image: ImageData, file_path: str) -> None:
    """1/3-channel images save as visualization images (PNG, BMP, JPEG,
    TIFF or JPEG 2000, the file ``cv2.imwrite`` writes -- JPEG 2000 raises
    ``ValueError`` below 32 pixels a side, where OpenCV writes nothing; WebP,
    a lossless file of the pixels OpenCV's decodes to; GIF is read-only and
    raises ``NotImplementedError``); anything else exports as ENVI binary
    (``data_loader.cpp:116-130``)."""
    n = image.total_num_channels
    ext = os.path.splitext(file_path)[1].lower()
    if n in (1, 3) and ext in IMAGE_EXTENSIONS:
        write_image(file_path, image.visualization_image())
    else:
        HyperspectralDataLoader(file_path).save_image(image)
