"""The port's baseline JPEG reader against ``cv2.imread(..., IMREAD_UNCHANGED)``
(OpenCV's libjpeg-turbo), on files that ``cv2.imwrite`` / ``cv2.imencode``
write here: grey and BGR, every sampling factor OpenCV writes, qualities
30 / 75 / 95 / 100, optimised Huffman tables, restart intervals and sizes
that are not multiples of the MCU. Every case is bit-equal. The loaders
read ``.jpg`` as the JAX package's do; what the reader does not support
raises ``NotImplementedError`` naming it."""

import cv2
import numpy as np
import pytest
import torch

from super_resolution_tpu.utils.data_loader import load_image as j_load_image
from super_resolution_tpu.utils.data_loader import load_images as j_load_images

from super_resolution_tpu_torch import native
from super_resolution_tpu_torch.utils import image_io
from super_resolution_tpu_torch.utils.data_loader import load_image, load_images
from super_resolution_tpu_torch.utils.jpeg import decode_jpeg

CPU = dict(device="cpu", dtype=torch.float64)
SAMPLING = {
    "4:1:1": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, "4:2:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "4:2:2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, "4:4:0": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "4:4:4": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
}
KINDS = ["grey", *SAMPLING]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(h, w, channels, seed=0):
    """Smooth texture, sharp edges and noise, uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.stack([128 + 80 * np.sin(xx / (4.0 + c)) * np.cos(yy / 6.0) + 30 * np.sin((xx + yy) / 3.0)
                    for c in range(channels)], axis=-1)
    img[h // 4: h // 2, w // 3: 2 * w // 3] += 60
    img += rng.normal(0, 10, img.shape)
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _write(path, kind, h, w, quality=75, extra=()):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, *extra]
    if kind != "grey":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[kind]]
    assert cv2.imwrite(str(path), _scene(h, w, 1 if kind == "grey" else 3, seed=h * w + quality), params)
    return str(path)


def _same_as_opencv(path):
    ours = image_io.read_image(path)
    theirs = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert ours.dtype == np.uint8 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("quality", [30, 75, 95, 100])
@pytest.mark.parametrize("kind", KINDS)
def test_read_jpeg_as_opencv(tmp_path, kind, quality):
    _same_as_opencv(_write(tmp_path / "image.jpg", kind, 48, 64, quality))


@pytest.mark.parametrize("kind", KINDS)
def test_optimised_huffman_tables(tmp_path, kind):
    _same_as_opencv(_write(tmp_path / "image.jpg", kind, 40, 56, 85, (cv2.IMWRITE_JPEG_OPTIMIZE, 1)))


@pytest.mark.parametrize("kind", KINDS)
def test_restart_intervals(tmp_path, kind):
    path = _write(tmp_path / "image.jpeg", kind, 45, 70, 80, (cv2.IMWRITE_JPEG_RST_INTERVAL, 2))
    assert b"\xff\xdd" in open(path, "rb").read() and b"\xff\xd1" in open(path, "rb").read()
    _same_as_opencv(path)


@pytest.mark.parametrize("hw", [(37, 53), (1, 1), (2, 3), (17, 9), (9, 17), (121, 161)])
def test_sizes_that_are_not_whole_mcus(tmp_path, hw):
    for kind in KINDS:  # 4:2:2 / 4:2:0 at a width of 1-2 chroma samples upsample by replication
        _same_as_opencv(_write(tmp_path / f"{kind.replace(':', '')}.jpg", kind, *hw, 90))


def test_standard_tables_stand_in_for_a_missing_dht():
    """A Motion-JPEG frame may leave out its Huffman tables: both decoders
    take ITU T.81's standard ones."""
    data = cv2.imencode(".jpg", _scene(30, 40, 3), [cv2.IMWRITE_JPEG_QUALITY, 80])[1].tobytes()
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:  # copy every segment before the scan but the DHTs
        length = int.from_bytes(data[pos + 2: pos + 4], "big")
        if data[pos + 1] != 0xC4:
            out += data[pos: pos + 2 + length]
        pos += 2 + length
    out += data[pos:]
    assert b"\xff\xc4" not in out[: out.index(b"\xff\xda")]
    np.testing.assert_array_equal(decode_jpeg(bytes(out)), cv2.imdecode(np.frombuffer(bytes(out), np.uint8),
                                                                        cv2.IMREAD_UNCHANGED))


def test_unsupported_jpeg_raises_naming_the_feature(tmp_path):
    """Progressive JPEG decodes as OpenCV decodes it and writing is OpenCV's
    bytes (tests/test_torch_jpeg_progressive.py and test_torch_jpeg_encode.py
    hold them in full); arithmetic-coded, lossless and 12-bit JPEG raise
    naming the feature."""
    progressive = cv2.imencode(".jpg", _scene(16, 16, 3), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    np.testing.assert_array_equal(decode_jpeg(progressive),
                                  cv2.imdecode(np.frombuffer(progressive, np.uint8), cv2.IMREAD_UNCHANGED))
    baseline = bytearray(cv2.imencode(".jpg", _scene(16, 16, 3))[1].tobytes())
    sof = baseline.index(b"\xff\xc0")
    for marker, name in ((0xC9, "arithmetic"), (0xC3, "lossless")):
        baseline[sof + 1] = marker
        with pytest.raises(NotImplementedError, match=name):
            decode_jpeg(bytes(baseline))
    baseline[sof + 1] = 0xC0
    baseline[sof + 4] = 12  # precision
    with pytest.raises(NotImplementedError, match="12-bit"):
        decode_jpeg(bytes(baseline))
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(ValueError):
        decode_jpeg(bytes(baseline[: sof + 6]))
    image_io.write_image(str(tmp_path / "out.jpg"), _scene(4, 4, 1))
    assert open(tmp_path / "out.jpg", "rb").read() == cv2.imencode(".jpg", _scene(4, 4, 1))[1].tobytes()


def test_no_compiler_means_no_jpeg_decoder(monkeypatch, tmp_path):
    """There is no second codec: without a C++ compiler (and no library
    built yet) reading or writing a JPEG, and reading or writing an LZW TIFF
    or a GIF, raises, naming the compiler."""
    from torch_format_builders import gif_bytes

    from super_resolution_tpu_torch.utils.gif import read_gif
    from super_resolution_tpu_torch.utils.jpeg import encode_jpeg
    from super_resolution_tpu_torch.utils.tiff import read_tiff, write_tiff

    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_compiler", lambda: None)
    monkeypatch.setattr(native, "_library_path", lambda source=None: tmp_path / "absent.so")
    image = _scene(8, 8, 1)
    lzw_tiff = cv2.imencode(".tif", image)[1].tobytes()
    for codec, data in ((decode_jpeg, cv2.imencode(".jpg", image)[1].tobytes()), (encode_jpeg, image),
                        (read_tiff, lzw_tiff), (write_tiff, image),
                        (read_gif, gif_bytes(np.zeros((4, 4), np.uint8), np.zeros((4, 3), np.uint8)))):
        with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
            codec(data)


def test_loaders_read_jpeg_as_the_jax_loaders(tmp_path):
    for i, kind in enumerate(("4:2:0", "grey", "4:4:4")):
        _write(tmp_path / f"frame_{i}.jpg", kind, 33, 47, 88)
    ours, theirs = load_images(str(tmp_path), **CPU), j_load_images(str(tmp_path))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.spectral_mode.name == b.spectral_mode.name
        np.testing.assert_array_equal(a.hidden_array.numpy(), np.asarray(b.hidden_array))
    single = load_image(str(tmp_path / "frame_0.jpg"), **CPU)
    np.testing.assert_array_equal(single.hidden_array.numpy(),
                                  np.asarray(j_load_image(str(tmp_path / "frame_0.jpg")).hidden_array))
