"""The port's JPEG 2000 writer (``encode_jpeg2000`` in ``utils/jpeg2000.py``
over ``native/jpeg2000_encoder.cpp``) against ``cv2.imencode(".jp2", image)``
(OpenJPEG 2.5.3 behind OpenCV): the same bytes, grey and BGR, from the
smallest size OpenCV writes (32 a side) to several code-blocks a band, on
noise (every pass cut by the rate allocation), a smooth ramp, a constant
image (code-blocks without a bit-plane), a checkerboard of 0 / 255 and one
bright pixel; at OpenCV's default rate and at the rates of
``IMWRITE_JPEG2000_COMPRESSION_X1000`` from lossless (1000: every pass, which
isolates tier-1 and tier-2) down to 1 (the 30-byte floor of the budget).
Also: ``write_image`` / ``read_image`` against ``cv2.imwrite`` /
``cv2.imread``, the refusals (a side below 32, where OpenCV writes nothing;
other dtypes and channel counts), the encoder's counts, and the flagship
scene of ``chip_smoke.py`` phase 14 (c-6a) against its stored file."""

import hashlib
import json
import os

import cv2
import numpy as np
import pytest
import torch

from super_resolution_tpu_torch import native
from super_resolution_tpu_torch.image import ImageData
from super_resolution_tpu_torch.utils import image_io
from super_resolution_tpu_torch.utils.jpeg2000 import encode_jpeg2000

FORMATS = os.path.join(os.path.dirname(__file__), "data_torch", "formats")
SIZES = [(32, 32), (32, 33), (33, 32), (37, 53), (64, 64), (65, 129), (200, 257)]
CONTENTS = ["noise", "ramp", "constant", "checkerboard", "bright_pixel"]
RATES = [1000, 500, 250, 100, 10, 1]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _built():
    native.get_jpeg2000_encoder_library()  # one build for the module


def _image(content, h, w, channels, seed=0):
    rng = np.random.default_rng(seed + 7 * h + w)
    shape = (h, w) if channels == 1 else (h, w, channels)
    yy, xx = np.mgrid[:h, :w]
    if content == "noise":
        return rng.integers(0, 256, shape).astype(np.uint8)
    if content == "ramp":
        planes = [(xx * (1 + c) + 2 * yy) * 255 // (w * (1 + c) + 2 * h) for c in range(channels)]
    elif content == "constant":
        planes = [np.full((h, w), 77 + 60 * c) for c in range(channels)]
    elif content == "checkerboard":
        planes = [((xx + yy + c) % 2) * 255 for c in range(channels)]
    else:
        planes = [np.where((yy == h // 3) & (xx == w // 2 + c), 255, 0) for c in range(channels)]
    return np.stack(planes, -1).astype(np.uint8).reshape(shape)


def _opencv(image, per_mille=None):
    params = [] if per_mille is None else [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, per_mille]
    ok, data = cv2.imencode(".jp2", image, params)
    assert ok
    return data.tobytes()


def _first_difference(ours, theirs):
    n = min(len(ours), len(theirs))
    diff = next((i for i in range(n) if ours[i] != theirs[i]), n)
    return f"{len(ours)} vs {len(theirs)} bytes, first difference at byte {diff}"


@pytest.mark.parametrize("channels", [1, 3], ids=["grey", "bgr"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("content", CONTENTS)
def test_default_rate_bytes_equal_opencv(content, size, channels):
    image = _image(content, *size, channels)
    ours, theirs = encode_jpeg2000(image), _opencv(image)
    assert ours == theirs, _first_difference(ours, theirs)


@pytest.mark.parametrize("per_mille", RATES)
@pytest.mark.parametrize("content,size,channels", [("noise", (65, 129), 1), ("ramp", (200, 257), 3),
                                                   ("noise", (37, 53), 3)], ids=["grey", "bgr_ramp", "bgr_noise"])
def test_rates_bytes_equal_opencv(content, size, channels, per_mille):
    image = _image(content, *size, channels, seed=per_mille)
    stats = {}
    ours, theirs = encode_jpeg2000(image, stats, compression_x1000=per_mille), _opencv(image, per_mille)
    assert ours == theirs, _first_difference(ours, theirs)
    if per_mille == 1000:  # lossless: every pass of every code-block
        assert stats["threshold"] == -1 and stats["passes_cut"] == 0 and stats["trials"] == 0
    else:
        assert stats["trials"] >= 1 and stats["packet_bytes"] <= stats["budget"]


def test_stats_of_a_cut_layer():
    stats = {}
    image = _image("noise", 200, 257, 3)
    data = encode_jpeg2000(image, stats)
    # 64x64 code-blocks by resolution, coarsest first: 1, 3, 3, 3, 4 (LH is 65 wide), 14; three components.
    assert stats["code_blocks"] == 3 * 28 and stats["zero_blocks"] == 0
    assert stats["passes_cut"] > 0 and stats["blocks_cut"] > 0 and stats["threshold"] > 0
    assert stats["passes"] == stats["passes_kept"] + stats["passes_cut"]
    assert 0 < stats["packet_bytes"] <= stats["budget"] < len(data)
    # OpenJPEG's budget: raw bytes / rate 4, less the 85 bytes of JP2 boxes and the 125-byte main header.
    assert stats["budget"] == int(np.ceil(200 * 257 * 3 / 4 - 85 - 125))


@pytest.mark.parametrize("channels", [1, 3], ids=["grey", "bgr"])
def test_write_and_read_back_as_opencv(tmp_path, channels):
    """``write_image`` writes ``cv2.imwrite``'s file, and the port's ``read_image`` of it equals ``cv2.imread``
    of OpenCV's file."""
    image = _image("noise", 45, 70, channels, seed=3)
    ours, theirs = str(tmp_path / "ours.jp2"), str(tmp_path / "theirs.jp2")
    image_io.write_image(ours, image)
    assert cv2.imwrite(theirs, image)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    decoded = cv2.imread(theirs, cv2.IMREAD_UNCHANGED)
    assert not np.array_equal(decoded, image)  # lossy at the default rate
    np.testing.assert_array_equal(image_io.read_image(ours), decoded)


@pytest.mark.parametrize("shape", [(31, 31), (31, 64), (64, 31), (1, 1), (16, 40, 3)])
def test_below_32_pixels_a_side_raises(tmp_path, shape):
    """OpenJPEG refuses 5 decomposition levels on a side below 32 and OpenCV writes nothing; the port raises."""
    image = np.zeros(shape, dtype=np.uint8)
    assert not cv2.imencode(".jp2", image)[0]
    with pytest.raises(ValueError, match="at least 32 pixels a side"):
        encode_jpeg2000(image)
    with pytest.raises(ValueError, match="at least 32 pixels a side"):
        image_io.write_image(str(tmp_path / "small.jp2"), image)
    assert not os.path.exists(tmp_path / "small.jp2")


@pytest.mark.parametrize("image", [np.zeros((40, 40), np.uint16), np.zeros((40, 40), np.float32),
                                   np.zeros((40, 40, 2), np.uint8), np.zeros((40, 40, 4), np.uint8),
                                   np.zeros((40, 40, 1), np.uint8), np.zeros((40,), np.uint8)],
                         ids=["uint16", "float32", "2_channels", "4_channels", "1_channel_axis", "1d"])
def test_other_inputs_raise(image):
    with pytest.raises(ValueError, match="Expected a uint8 HxW or HxWx3 image"):
        encode_jpeg2000(image)


def test_flagship_scene_encodes_to_the_stored_file():
    """What phase 14 (c-6a) checks on the card's host: the flagship scene's pixels hash to the manifest's digest,
    and the port encodes them to ``flagship_scene_1000x1000.jp2`` (cv2's file)."""
    import chip_smoke

    with open(os.path.join(FORMATS, "manifest.json")) as f:
        entry = json.load(f)["flagship_scene"]
    pixels = ImageData(chip_smoke.synthetic_scene(1, 1000, 1000, seed=2026), channel_major=True,
                       device="cpu").visualization_image()
    assert list(pixels.shape) == entry["shape"]
    assert hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest() == entry["pixels_sha256"]
    with open(os.path.join(FORMATS, entry["file"]), "rb") as f:
        stored = f.read()
    ours = encode_jpeg2000(pixels)
    assert ours == stored, _first_difference(ours, stored)
