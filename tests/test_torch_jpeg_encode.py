"""The port's JPEG writer against the JAX package's ``save_image``
(``cv2.imwrite``, libjpeg-turbo at its defaults: quality 95, 4:2:0): the
files are byte-equal for grey and BGR images at 1x1, 7x9, 37x53, 64x48 and
other odd sizes, and at the flagship's 1000x1000. A failure names the marker
and the offset of the first byte that differs."""

import os

import cv2
import numpy as np
import pytest
import torch

from super_resolution_tpu.image import ImageData as JImageData
from super_resolution_tpu.utils.data_loader import save_image as j_save_image

from super_resolution_tpu_torch.image import ImageData
from super_resolution_tpu_torch.utils import image_io
from super_resolution_tpu_torch.utils.data_loader import save_image
from super_resolution_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg

SIZES = [(1, 1), (7, 9), (37, 53), (64, 48), (17, 33), (16, 16)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _image(h, w, channels, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        img = rng.integers(0, 256, (h, w, channels))
    else:
        yy, xx = np.mgrid[:h, :w].astype(np.float64)
        img = np.stack([128 + 90 * np.sin(xx / (3.0 + c)) * np.cos(yy / 5.0) for c in range(channels)], -1)
        img = np.clip(np.rint(img + rng.normal(0, 4, img.shape)), 0, 255)
    img = img.astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _where(data: bytes, offset: int) -> str:
    """The marker segment (or the entropy-coded data) that holds ``offset``."""
    pos = 2
    while pos + 4 <= len(data):
        marker = data[pos + 1]
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if offset < pos + 2 + length:
            return f"marker 0x{marker:02X} segment at {pos}"
        if marker == 0xDA:
            return "entropy-coded data"
        pos += 2 + length
    return "after the scan"


def assert_same_bytes(ours: bytes, theirs: bytes):
    if ours == theirs:
        return
    first = next((i for i in range(min(len(ours), len(theirs))) if ours[i] != theirs[i]), min(len(ours), len(theirs)))
    pytest.fail(f"JPEG files differ first at offset {first} ({_where(theirs, first)}); "
                f"{len(ours)} bytes against {len(theirs)}")


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("hw", SIZES)
def test_write_jpeg_byte_equal_to_opencv(tmp_path, hw, channels, kind):
    image = _image(*hw, channels, kind, seed=hw[0] * hw[1] + channels)
    path = str(tmp_path / "ours.jpg")
    image_io.write_image(path, image)
    with open(path, "rb") as f:
        assert_same_bytes(f.read(), cv2.imencode(".jpg", image)[1].tobytes())


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("hw", [(37, 53), (64, 48)])
def test_save_image_byte_equal_to_the_jax_save_image(tmp_path, hw, channels):
    """``save_image`` of the same [0, 1] image: the port's file is the JAX package's."""
    arr = _image(*hw, channels, "smooth", seed=7).astype(np.float64) / 255.0
    planes = np.moveaxis(arr if channels == 3 else arr[..., None], -1, 0)
    ours, theirs = str(tmp_path / "ours.jpg"), str(tmp_path / "theirs.jpeg")
    save_image(ImageData(planes, channel_major=True, device="cpu", dtype=torch.float64), ours)
    j_save_image(JImageData(planes, channel_major=True), theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert_same_bytes(a.read(), b.read())


@pytest.mark.parametrize("channels", [1, 3])
def test_flagship_size_byte_equal(channels):
    image = _image(1000, 1000, channels, "smooth", seed=1000)
    data = encode_jpeg(image)
    assert_same_bytes(data, cv2.imencode(".jpg", image)[1].tobytes())
    np.testing.assert_array_equal(decode_jpeg(data), cv2.imdecode(np.frombuffer(data, np.uint8),
                                                                  cv2.IMREAD_UNCHANGED))


def test_layout_of_the_file():
    """SOI, JFIF 1.01, two DQTs at quality 95, SOF0 4:2:0, four DHTs of
    31 / 181 / 31 / 181 bytes, one interleaved scan, EOI."""
    data = encode_jpeg(_image(37, 53, 3, "noise", 1))
    segments, pos = [], 2
    while True:
        marker, length = data[pos + 1], int.from_bytes(data[pos + 2:pos + 4], "big")
        segments.append((marker, length))
        if marker == 0xDA:
            break
        pos += 2 + length
    assert segments == [(0xE0, 16), (0xDB, 67), (0xDB, 67), (0xC0, 17), (0xC4, 31), (0xC4, 181), (0xC4, 31),
                        (0xC4, 181), (0xDA, 12)]
    sof = data.index(b"\xff\xc0")
    assert data[sof + 10:sof + 19] == bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    dqt = data.index(b"\xff\xdb")
    assert data[dqt + 5] == 2  # luminance DC: (16 * 10 + 50) // 100


def test_bad_images_raise(tmp_path):
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError):
        encode_jpeg(np.zeros((4, 4), np.uint16))
    assert not os.path.exists(tmp_path / "never.jpg")
