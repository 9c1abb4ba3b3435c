"""The format fixtures of ``tests/data_torch/formats`` (made here by
``scripts/make_torch_format_fixtures.py`` with OpenCV; ``chip_smoke.py``
phase 14 reads them on a host without OpenCV): each file decodes
array-equal to OpenCV's decode stored beside it (or to the SHA-256 of that
decode's array, kept in the manifest for phase 14 (c-7)'s 250x250 frames), and the port's JPEG, TIFF
and JPEG 2000 of each seeded image are byte-equal to OpenCV's."""

import hashlib
import json
import os

import cv2
import numpy as np
import pytest

from super_resolution_tpu_torch.utils.image_io import read_image
from super_resolution_tpu_torch.utils.jpeg import encode_jpeg
from super_resolution_tpu_torch.utils.jpeg2000 import encode_jpeg2000
from super_resolution_tpu_torch.utils.tiff import write_tiff

DIR = os.path.join(os.path.dirname(__file__), "data_torch", "formats")
with open(os.path.join(DIR, "manifest.json")) as f:
    MANIFEST = json.load(f)


def _expected(name):
    path = os.path.join(DIR, name)
    return np.load(path) if name.endswith(".npy") else cv2.imread(path, cv2.IMREAD_UNCHANGED)


@pytest.mark.parametrize("entry", MANIFEST["decode"], ids=lambda e: e["file"])
def test_decode_fixture(entry):
    path = os.path.join(DIR, entry["file"])
    if "expected_sha256" in entry:  # OpenCV's decode kept as the SHA-256 of its array
        ours, theirs = read_image(path), cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert hashlib.sha256(np.ascontiguousarray(theirs).tobytes()).hexdigest() == entry["expected_sha256"]
        assert ours.dtype == theirs.dtype and list(ours.shape) == entry["shape"]
        np.testing.assert_array_equal(ours, theirs)
        return
    ours, stored = read_image(path), _expected(entry["expected"])
    np.testing.assert_array_equal(stored, cv2.imread(path, cv2.IMREAD_UNCHANGED))  # the stored decode is OpenCV's
    assert ours.dtype == stored.dtype and list(ours.shape) == entry["shape"]
    np.testing.assert_array_equal(ours, stored)
    if entry["expected"].endswith(".png"):
        np.testing.assert_array_equal(read_image(os.path.join(DIR, entry["expected"])), stored)


@pytest.mark.parametrize("entry", MANIFEST["encode"], ids=lambda e: e.get("jpeg", e["jp2"]))
def test_encode_fixture(entry):
    raw = np.random.PCG64(entry["seed"]).random_raw(int(np.prod(entry["shape"])))
    image = (raw >> np.uint64(56)).astype(np.uint8).reshape(entry["shape"])
    for key, encode in (("jpeg", encode_jpeg), ("tiff", write_tiff), ("jp2", encode_jpeg2000)):
        if key not in entry:
            continue
        name = entry[key]
        with open(os.path.join(DIR, name), "rb") as f:
            stored = f.read()
        assert encode(image) == stored, name
        np.testing.assert_array_equal(read_image(os.path.join(DIR, name)) if name.endswith(".tif") else image, image)
        if key == "jp2":  # lossy: the stored file is today's OpenCV's, and reads back to OpenCV's decode of it
            assert cv2.imencode(".jp2", image)[1].tobytes() == stored, name
            np.testing.assert_array_equal(read_image(os.path.join(DIR, name)),
                                          cv2.imread(os.path.join(DIR, name), cv2.IMREAD_UNCHANGED))
