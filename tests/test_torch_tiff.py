"""The port's TIFF codec against the JAX loaders (OpenCV's libtiff) on the
same bytes. Reading: files ``cv2.imwrite`` writes here (compression 1 / 5 /
8 / 32773, grey and BGR, 1x1 to 64x48) and files built by hand for the
layouts it does not write (``MM``, BigTIFF, tiles, planar samples, uint16 /
int16 / float32 / float64, the three predictors, min-is-white, extra
samples, orientations); ``read_image`` is array-equal to ``cv2.imread(...,
IMREAD_UNCHANGED)``, the port's ``load_image`` to the JAX one. Writing: the
JAX loader reads the port's file back equal to the image, and the bytes are
OpenCV's. The layouts the port still refuses (CMYK, CIE L*a*b*, CCITT,
old-style JPEG, 16-bit planar, five samples) raise ``NotImplementedError``
naming them (``tests/test_torch_tiff_rgba.py`` holds JPEG, YCbCr, palette
and bilevel files); corrupt data ``ValueError``. And
``super_resolve`` from a TIFF to a JPEG, against the JAX CLI's file."""

import contextlib
import io
import struct

import cv2
import numpy as np
import pytest
import torch

from super_resolution_tpu.cli import super_resolve as j_super_resolve
from super_resolution_tpu.utils.data_loader import load_image as j_load_image

from super_resolution_tpu_torch.cli import super_resolve
from super_resolution_tpu_torch.image import ImageData
from super_resolution_tpu_torch.utils import image_io
from super_resolution_tpu_torch.utils.data_loader import load_image, save_image
from super_resolution_tpu_torch.utils.tiff import read_tiff, write_tiff
from torch_format_builders import tiff_bytes

CPU = dict(device="cpu", dtype=torch.float64)
SIZES = [(1, 1), (7, 9), (37, 53), (64, 48)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _samples(shape, dtype, seed, full_range=True):
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return rng.random(shape).astype(dtype)
    info = np.iinfo(dtype)
    high = info.max if full_range else min(info.max, 255)
    return rng.integers(max(info.min, 0) if not full_range else info.min, high, shape, endpoint=True).astype(dtype)


def _same_as_opencv(data: bytes):
    ours = read_tiff(data)
    theirs = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    assert theirs is not None
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, (ours.dtype, ours.shape, theirs.shape)
    np.testing.assert_array_equal(ours, theirs)
    return ours


def _same_as_the_jax_loader(tmp_path, data: bytes, name="image.tif"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(load_image(path, **CPU).hidden_array.numpy(),
                                  np.asarray(j_load_image(path).hidden_array))


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("hw", SIZES)
def test_read_files_opencv_writes(tmp_path, hw, channels, compression):
    image = _samples((*hw, channels) if channels == 3 else hw, np.uint8, hw[0] * hw[1] + compression)
    data = cv2.imencode(".tif", image, [cv2.IMWRITE_TIFF_COMPRESSION, compression])[1].tobytes()
    np.testing.assert_array_equal(_same_as_opencv(data), image)
    _same_as_the_jax_loader(tmp_path, data)


# (dtype, samples a pixel, keyword arguments of tiff_bytes)
LAYOUTS = {
    "u8_rgb_mm_lzw_pred2": ("u1", 3, dict(byte_order=">", compression=5, predictor=2, rows_per_strip=5)),
    "u8_rgba_tiles_deflate": ("u1", 4, dict(compression=8, tile=(16, 32), extra_samples=[1])),
    "u8_rgba_unassociated_alpha": ("u1", 4, dict(compression=5, predictor=2, extra_samples=[2])),
    "u8_planar_rgb_packbits": ("u1", 3, dict(planar=True, compression=32773, rows_per_strip=4)),
    "u8_planar_rgb_lzw_tiles": ("u1", 3, dict(planar=True, compression=5, tile=(16, 16))),
    "u8_bigtiff_lzw": ("u1", 3, dict(bigtiff=True, compression=5, predictor=2)),
    "u8_min_is_white": ("u1", 1, dict(photometric=0, compression=8)),
    "u8_grey_alpha": ("u1", 2, dict(extra_samples=[2], compression=5)),
    "u16_grey_mm_tiles_deflate_pred2": ("u2", 1, dict(byte_order=">", compression=8, tile=(32, 16), predictor=2)),
    "u16_rgb_lzw_pred2": ("u2", 3, dict(compression=5, predictor=2, rows_per_strip=3)),
    "u16_rgba_adobe_deflate": ("u2", 4, dict(compression=32946, extra_samples=[2])),
    "u16_min_is_white": ("u2", 1, dict(photometric=0)),
    "i16_grey_lzw_pred2": ("i2", 1, dict(compression=5, predictor=2)),
    "f32_rgb_lzw_pred3": ("f4", 3, dict(compression=5, predictor=3, rows_per_strip=4)),
    "f32_grey_mm_deflate_pred3_tiles": ("f4", 1, dict(byte_order=">", compression=8, predictor=3, tile=(16, 16))),
    "f32_rgb_packbits_predictor_ignored": ("f4", 3, dict(compression=32773, predictor=2)),
    "f64_grey_deflate_pred3": ("f8", 1, dict(compression=8, predictor=3)),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_read_hand_built_layouts(tmp_path, name):
    dtype, spp, kwargs = LAYOUTS[name]
    shape = (21, 37, spp) if spp > 1 else (21, 37)
    _same_as_opencv(tiff_bytes(_samples(shape, dtype, seed=len(name)), **kwargs))
    # The loader's range: the JAX ImageData takes [0, 255] (and floats as they are).
    _same_as_the_jax_loader(tmp_path, tiff_bytes(_samples(shape, dtype, seed=3, full_range=False), **kwargs))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation(orientation):
    """Strips, and tiles: the RGBA interface (8-bit) mirrors each tile in place."""
    for dtype, spp, layout in (("u1", 3, {}), ("u2", 1, {}), ("u1", 3, dict(tile=(16, 16), compression=8)),
                               ("u2", 1, dict(tile=(16, 16), compression=8))):
        shape = (19, 37, spp) if layout else (9, 14, spp)
        samples = _samples(shape if spp > 1 else shape[:2], dtype, orientation)
        _same_as_opencv(tiff_bytes(samples, extra_tags=[(274, 3, [orientation])], **layout))


def test_lzw_table_resets_and_long_strips():
    """One strip far past 4094 codes (so the table resets several times),
    from the builder's own encoder."""
    data = tiff_bytes(_samples((100, 90, 3), np.uint8, 5), compression=5)
    assert len(data) > 3 * 4094 * 9 // 8
    _same_as_opencv(data)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("hw", [*SIZES, (1000, 1000), (3, 3000)])
def test_write_reads_back_in_the_jax_loader(tmp_path, hw, channels):
    image = _samples((*hw, channels) if channels == 3 else hw, np.uint8, hw[0] + channels)
    path = str(tmp_path / "ours.tiff")
    image_io.write_image(path, image)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), image)
    with open(path, "rb") as f:
        assert f.read() == cv2.imencode(".tif", image)[1].tobytes()  # OpenCV's bytes, too
    np.testing.assert_array_equal(image_io.read_image(path), image)


def test_save_image_reads_back_as_the_jax_file(tmp_path):
    planes = _samples((3, 20, 30), np.uint8, 9).astype(np.float64) / 255.0
    ours = str(tmp_path / "ours.tif")
    save_image(ImageData(planes, channel_major=True, **CPU), ours)
    np.testing.assert_array_equal(load_image(ours, **CPU).hidden_array.numpy(),
                                  np.asarray(j_load_image(ours).hidden_array))


def test_uint16_above_255_raises_as_the_jax_loader(tmp_path):
    """The JAX ``ImageData`` refuses values past 255 (``Invalid pixel
    range``); the port's loader does the same and does not rescale."""
    path = str(tmp_path / "deep.tif")
    with open(path, "wb") as f:
        f.write(tiff_bytes(np.full((4, 5), 300, np.uint16)))
    with pytest.raises(ValueError, match="Invalid pixel range"):
        j_load_image(path)
    with pytest.raises(ValueError, match="Invalid pixel range"):
        load_image(path, **CPU)
    assert image_io.read_image(path).max() == 300


REFUSED = {
    "cmyk": (dict(photometric=5), "CMYK"),
    "lab": (dict(photometric=8), "L\\*a\\*b\\*"),
    "ccitt": (dict(declared_compression=4), "CCITT"),
    "old_style_jpeg": (dict(declared_compression=6), "old-style JPEG"),
    "planar_16bit": (dict(planar=True), "Planar"),
    "five_samples": (dict(), "5 samples"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_name_the_feature(name):
    kwargs, match = REFUSED[name]
    spp = 5 if name == "five_samples" else 3
    dtype = np.uint16 if name == "planar_16bit" else np.uint8
    data = tiff_bytes(_samples((6, 8, spp), dtype, 1), **kwargs)
    with pytest.raises(NotImplementedError, match=match):
        read_tiff(data)


def test_corrupt_data_raises():
    good = tiff_bytes(_samples((16, 16, 3), np.uint8, 2), compression=5)
    with pytest.raises(ValueError, match="Not a TIFF"):
        read_tiff(b"\x89PNG\r\n\x1a\n" + good[8:])
    with pytest.raises(ValueError):
        read_tiff(good[:40])  # the strip and the IFD cut off
    # The LZW strip cut short: fewer bytes than the strip needs.
    (ifd,) = struct.unpack("<I", good[4:8])
    short = bytearray(good)
    short[8 + 20:ifd] = b"\0" * (ifd - 28)
    with pytest.raises(ValueError):
        read_tiff(bytes(short))
    deflate = tiff_bytes(_samples((8, 8), np.uint8, 3), compression=8)
    with pytest.raises(ValueError, match="Deflate"):
        read_tiff(deflate[:8] + b"\xff" * 12 + deflate[20:])


def test_write_refuses_other_images():
    with pytest.raises(ValueError):
        write_tiff(np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError):
        write_tiff(np.zeros((4, 4, 4), np.uint8))


def test_super_resolve_from_a_tiff_to_a_jpeg(tmp_path, monkeypatch, tmp_path_factory):
    """The generate mode from a TIFF ground truth, the result written as
    JPEG: the port's file (float64, CPU) is the JAX CLI's, byte for byte."""
    monkeypatch.setenv("SRTPU_COMPILE_CACHE", str(tmp_path_factory.getbasetemp() / "jax_cache"))
    monkeypatch.delenv("DISPLAY", raising=False)
    yy, xx = np.mgrid[:32, :32]
    noise = np.random.default_rng(1).random((32, 32))
    scene = np.clip(0.5 + 0.3 * np.sin(xx / 3.0) * np.cos(yy / 4.0) + 0.1 * noise, 0, 1)  # tests/test_torch_cli.py's
    truth = str(tmp_path / "truth.tif")
    image_io.write_image(truth, (scene * 255).astype(np.uint8))
    (tmp_path / "shifts.txt").write_text("0 0\n1 1\n0 1\n1 0\n")
    argv = ["--data_path", truth, "--generate_lr_images", "--motion_sequence_path", str(tmp_path / "shifts.txt"),
            "--upsampling_scale", "2", "--solver", "linear_cg", "--optimization_iterations", "2",
            "--solver_iterations", "10", "--evaluators", "psnr"]
    results = {}
    for name, main, extra in (("jax", j_super_resolve.main, []),
                              ("port", super_resolve.main, ["--device", "cpu", "--dtype", "float64"])):
        results[name] = str(tmp_path / f"{name}.jpg")
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(argv + extra + ["--result_path", results[name]]) == 0
    with open(results["port"], "rb") as a, open(results["jax"], "rb") as b:
        assert a.read() == b.read()
