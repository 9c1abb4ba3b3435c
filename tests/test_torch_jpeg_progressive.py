"""The port's progressive JPEG reader against the JAX loader (OpenCV's
libjpeg-turbo) on the same bytes: files that ``cv2.imencode`` writes with
``IMWRITE_JPEG_PROGRESSIVE`` here (DC first / refine scans, AC first scans
with spectral selection and end-of-band runs, AC refinement scans), grey and
colour at odd sizes, with and without restart intervals. Every case is
array-equal; a file whose scans stop before the low coefficients are
refined (libjpeg-turbo would smooth its blocks) raises, naming that."""

import cv2
import numpy as np
import pytest
import torch

from super_resolution_tpu.utils.data_loader import load_image as j_load_image

from super_resolution_tpu_torch.utils import image_io
from super_resolution_tpu_torch.utils.data_loader import load_image
from super_resolution_tpu_torch.utils.jpeg import decode_jpeg

CPU = dict(device="cpu", dtype=torch.float64)
SAMPLING = {"4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "4:4:4": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "4:2:2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422}
SIZES = [(1, 1), (7, 9), (37, 53), (64, 48)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(h, w, channels, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.stack([128 + 80 * np.sin(xx / (4.0 + c)) * np.cos(yy / 6.0) + 30 * np.sin((xx + yy) / 3.0)
                    for c in range(channels)], axis=-1)
    img = np.clip(np.rint(img + rng.normal(0, 12, img.shape)), 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _progressive(kind, h, w, quality=85, restart=0, extra=()):
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_QUALITY, quality, *extra]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if kind != "grey":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind]]
    image = _scene(h, w, 1 if kind == "grey" else 3, seed=h * w + quality + restart)
    data = cv2.imencode(".jpg", image, params)[1].tobytes()
    assert data[data.index(b"\xff\xc2") + 1] == 0xC2  # SOF2
    return data


def _same_as_the_jax_loader(tmp_path, data):
    path = str(tmp_path / "image.jpg")
    with open(path, "wb") as f:
        f.write(data)
    ours, theirs = image_io.read_image(path), cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(load_image(path, **CPU).hidden_array.numpy(),
                                  np.asarray(j_load_image(path).hidden_array))


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("kind", ["grey", "4:2:0", "4:4:4"])
def test_progressive_as_the_jax_loader(tmp_path, kind, hw, restart):
    data = _progressive(kind, *hw, restart=restart)
    assert (b"\xff\xdd" in data) == bool(restart)
    _same_as_the_jax_loader(tmp_path, data)


@pytest.mark.parametrize("quality", [30, 100])
@pytest.mark.parametrize("kind", ["grey", "4:2:2"])
def test_progressive_qualities_and_optimised_tables(tmp_path, kind, quality):
    _same_as_the_jax_loader(tmp_path, _progressive(kind, 45, 70, quality, extra=(cv2.IMWRITE_JPEG_OPTIMIZE, 1)))


def test_refinement_scans_are_decoded():
    """OpenCV's progression (libjpeg's ``jpeg_simple_progression``) holds AC
    refinement scans (Ah > 0, Ss > 0): the file below has them, and decodes
    equal to OpenCV, restarts inside every scan included."""
    data = _progressive("4:2:0", 121, 161, 90, restart=3)
    scans = [data[i + 2:i + 2 + int.from_bytes(data[i + 2:i + 4], "big")] for i in range(len(data) - 1)
             if data[i] == 0xFF and data[i + 1] == 0xDA]
    tails = [(s[-3], s[-2], s[-1] >> 4) for s in scans]  # (Ss, Se, Ah)
    assert any(ss > 0 and ah > 0 for ss, _, ah in tails) and any(ss == 0 and ah > 0 for ss, _, ah in tails)
    np.testing.assert_array_equal(decode_jpeg(data), cv2.imdecode(np.frombuffer(data, np.uint8),
                                                                  cv2.IMREAD_UNCHANGED))


def _first_scans(data: bytes, n: int) -> bytes:
    """The file cut after its first ``n`` scans, with an EOI."""
    starts = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    return data[:starts[n]] + b"\xff\xd9"


@pytest.mark.parametrize("scans", [1, 3])
def test_incomplete_refinement_raises(scans):
    """Cut after the DC scans (or a few AC ones): libjpeg-turbo would smooth
    the blocks (jdcoefct.c); the port names the feature it does not do."""
    with pytest.raises(NotImplementedError, match="incomplete refinement"):
        decode_jpeg(_first_scans(_progressive("4:2:0", 37, 53), scans))


def test_bad_progression_and_arithmetic_coding():
    data = bytearray(_progressive("grey", 16, 16))
    sos = data.index(b"\xff\xda")
    n = data[sos + 4]
    se = sos + 5 + 2 * n + 1
    assert data[se - 1] == 0 and data[se] == 0  # the first scan is DC: Ss = Se = 0
    bad = bytearray(data)
    bad[se] = 5
    with pytest.raises(ValueError, match="progressive scan parameters"):
        decode_jpeg(bytes(bad))
    sof = data.index(b"\xff\xc2")
    data[sof + 1] = 0xCA  # SOF10
    with pytest.raises(NotImplementedError, match="arithmetic-coded progressive"):
        decode_jpeg(bytes(data))
