"""The port's image and ENVI I/O: its PNG / BMP codec against what
``cv2.imread(..., IMREAD_UNCHANGED)`` returns for the same file, its loaders
against the JAX package's, its native ENVI reader against its numpy one.
OpenCV and PIL write the oracle files here; the port imports neither."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from super_resolution_tpu.image import ImageData as JImageData
from super_resolution_tpu.spectral.envi import HyperspectralDataLoader as JLoader
from super_resolution_tpu.spectral.envi import read_envi_header as j_read_envi_header
from super_resolution_tpu.utils.config_reader import ConfigurationFileReader as JReader
from super_resolution_tpu.utils.data_loader import load_image as j_load_image
from super_resolution_tpu.utils.data_loader import load_images as j_load_images
from super_resolution_tpu.utils.data_loader import save_image as j_save_image

from super_resolution_tpu_torch import native
from super_resolution_tpu_torch.image import ImageData
from super_resolution_tpu_torch.spectral import envi
from super_resolution_tpu_torch.utils import image_io
from super_resolution_tpu_torch.utils.config_reader import ConfigurationFileReader
from super_resolution_tpu_torch.utils.data_loader import load_image, load_images, save_image

CPU = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _opencv(path):
    image = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert image is not None, path
    return image


def _assert_like_opencv(path):
    ours, theirs = image_io.read_image(str(path)), _opencv(path)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, (ours.dtype, ours.shape, theirs.shape)
    np.testing.assert_array_equal(ours, theirs)


# --- a raw PNG encoder for what neither OpenCV nor PIL writes ------------------
# (grey at 2 and 4 bits, grey + alpha at 16 bits, and every row filter).

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _packed_rows(samples, depth):
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8)
    flat = samples.reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1)
    return np.packbits(bits.astype(np.uint8), axis=1)


def _filtered(rows, bpp, kinds):
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for r, row in enumerate(rows.astype(np.int64)):
        kind = kinds[r % len(kinds)]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        p = left + prev - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        pred = [0 * row, left, prev, (left + prev) >> 1, paeth][kind]
        out.append(np.concatenate([[kind], (row - pred) & 0xFF]))
        prev = row
    return np.asarray(out, np.uint8).tobytes()


def _encode_png(samples, color, depth, interlace=0, kinds=(0, 1, 2, 3, 4)):
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    data = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            data += _filtered(_packed_rows(sub, depth), bpp, kinds)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
            + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))


# --- PNG read -----------------------------------------------------------------


def _opencv_png(tmp_path, kind):
    rng = np.random.default_rng(1)
    image = {
        "grey8": rng.integers(0, 256, (13, 17), dtype=np.uint8),
        "grey16": rng.integers(0, 65536, (13, 17), dtype=np.uint16),
        "bgr8": rng.integers(0, 256, (13, 17, 3), dtype=np.uint8),
        "bgr16": rng.integers(0, 65536, (13, 17, 3), dtype=np.uint16),
        "bgra8": rng.integers(0, 256, (13, 17, 4), dtype=np.uint8),
        "bgra16": rng.integers(0, 65536, (13, 17, 4), dtype=np.uint16),
    }[kind]
    path = tmp_path / f"{kind}.png"
    assert cv2.imwrite(str(path), image)
    return path


@pytest.mark.parametrize("kind", ["grey8", "grey16", "bgr8", "bgr16", "bgra8", "bgra16"])
def test_png_written_by_opencv(tmp_path, kind):
    _assert_like_opencv(_opencv_png(tmp_path, kind))


def _pil_png(tmp_path, kind):
    rng = np.random.default_rng(2)
    path = tmp_path / f"{kind}.png"
    palette = [int(v) for v in rng.integers(0, 256, 3 * 5)]
    if kind in ("palette1", "palette2", "palette4", "palette8", "palette_trns"):
        depth = {"palette1": 1, "palette2": 2, "palette4": 4}.get(kind, 8)
        colours = min(1 << depth, 5)
        image = Image.fromarray(rng.integers(0, colours, (11, 14)).astype(np.uint8), mode="P")
        image.putpalette(palette)
        extra = {"transparency": bytes([0, 90, 255, 30])} if kind == "palette_trns" else {}
        image.save(path, bits=depth, **extra)
    elif kind == "grey1":
        Image.fromarray(rng.integers(0, 2, (11, 14)).astype(bool)).save(path)
    elif kind == "grey_alpha8":
        Image.fromarray(rng.integers(0, 256, (11, 14, 2)).astype(np.uint8), mode="LA").save(path)
    elif kind == "grey_trns":
        Image.fromarray(rng.integers(0, 256, (11, 14)).astype(np.uint8), mode="L").save(path, transparency=7)
    elif kind == "rgb_trns":
        pixels = rng.integers(0, 256, (11, 14, 3)).astype(np.uint8)
        pixels[2, 3] = (1, 2, 3)
        Image.fromarray(pixels, mode="RGB").save(path, transparency=(1, 2, 3))
    elif kind.startswith("adam7"):
        mode, shape = {"adam7_rgb": ("RGB", (13, 19, 3)), "adam7_rgba": ("RGBA", (13, 19, 4)),
                       "adam7_grey": ("L", (13, 19))}[kind]
        Image.fromarray(rng.integers(0, 256, shape).astype(np.uint8), mode=mode).save(path, interlace=1)
    return path


@pytest.mark.parametrize("kind", ["palette1", "palette2", "palette4", "palette8", "palette_trns", "grey1",
                                  "grey_alpha8", "grey_trns", "rgb_trns", "adam7_rgb", "adam7_rgba", "adam7_grey"])
def test_png_written_by_pil(tmp_path, kind):
    _assert_like_opencv(_pil_png(tmp_path, kind))


@pytest.mark.parametrize("color,depth", [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2),
                                         (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)])
@pytest.mark.parametrize("interlace", [0, 1])
def test_png_every_type_depth_and_filter(tmp_path, color, depth, interlace):
    rng = np.random.default_rng(3 + color * 100 + depth)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    samples = rng.integers(0, 1 << depth, (11, 13, channels))
    if color == 3:
        samples %= 5
    data = _encode_png(samples, color, depth, interlace)
    if color == 3:  # PLTE before IDAT
        plte = _chunk(b"PLTE", rng.integers(0, 256, 15).astype(np.uint8).tobytes())
        at = data.index(b"IDAT") - 4
        data = data[:at] + plte + data[at:]
    path = tmp_path / "raw.png"
    path.write_bytes(data)
    _assert_like_opencv(path)


@pytest.mark.parametrize("shape", [(9, 14), (9, 14, 3)])
def test_png_write_reads_back_in_opencv(tmp_path, shape):
    image = np.random.default_rng(4).integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "ours.png")
    image_io.write_image(path, image)
    np.testing.assert_array_equal(_opencv(path), image)
    np.testing.assert_array_equal(image_io.read_image(path), image)
    with pytest.raises(ValueError, match="uint8"):
        image_io.write_image(path, image.astype(np.float32))


def test_png_refuses_corrupt_files(tmp_path):
    data = bytearray(_opencv_png(tmp_path, "grey8").read_bytes())
    data[40] ^= 0xFF
    with pytest.raises(ValueError, match="CRC|truncated"):
        image_io.read_png(bytes(data))
    with pytest.raises(ValueError, match="signature"):
        image_io.read_png(b"GIF89a" + bytes(40))


# --- BMP ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["grey8_opencv", "bgr24_opencv", "palette8_pil", "rgb24_pil", "rgba32_pil"])
def test_bmp_read(tmp_path, kind):
    rng = np.random.default_rng(5)
    path = tmp_path / f"{kind}.bmp"
    if kind == "grey8_opencv":
        cv2.imwrite(str(path), rng.integers(0, 256, (7, 10)).astype(np.uint8))
    elif kind == "bgr24_opencv":
        cv2.imwrite(str(path), rng.integers(0, 256, (7, 10, 3)).astype(np.uint8))
    elif kind == "palette8_pil":
        image = Image.fromarray(rng.integers(0, 4, (7, 10)).astype(np.uint8), mode="P")
        image.putpalette([10, 20, 30, 40, 50, 60, 70, 80, 90, 200, 210, 220])
        image.save(path)
    elif kind == "rgb24_pil":
        Image.fromarray(rng.integers(0, 256, (7, 10, 3)).astype(np.uint8)).save(path)
    else:
        Image.fromarray(rng.integers(0, 256, (7, 10, 4)).astype(np.uint8), mode="RGBA").save(path)
    _assert_like_opencv(path)


@pytest.mark.parametrize("shape", [(7, 9), (7, 9, 3)])
def test_bmp_write_reads_back_in_opencv(tmp_path, shape):
    image = np.random.default_rng(6).integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "ours.bmp")
    image_io.write_image(path, image)
    np.testing.assert_array_equal(_opencv(path), image)
    np.testing.assert_array_equal(image_io.read_image(path), image)


@pytest.mark.parametrize("ext,name", [(".jpg", "JPEG"), (".jpeg", "JPEG"), (".tif", "TIFF"), (".tiff", "TIFF"),
                                      (".gif", "GIF"), (".jp2", "JPEG 2000"), (".webp", "WebP")])
def test_other_formats_against_opencv(tmp_path, ext, name):
    """Every extension the JAX loader hands to OpenCV: JPEG, TIFF and JPEG
    2000 are read and written as the JAX loader does (the port's file is
    OpenCV's, and the JAX loader reads it back); WebP is read as it does and
    written losslessly (the port's bytes are its own; both files decode to
    the same pixels); GIF is read as it does, and writing it raises naming
    the format. (OpenCV's JPEG 2000 writer needs 32 pixels a side for its 5
    decomposition levels.)"""
    path = str(tmp_path / f"image{ext}")
    shape = (40, 45, 3) if name == "JPEG 2000" else (6, 9, 3)
    image = np.random.default_rng(len(ext)).integers(0, 256, shape).astype(np.uint8)
    assert cv2.imwrite(path, image)
    np.testing.assert_array_equal(load_image(path, **CPU).hidden_array.numpy(),
                                  np.asarray(j_load_image(path).hidden_array))
    if name == "GIF":
        with pytest.raises(NotImplementedError, match=f"Writing {name}"):
            image_io.write_image(path, image)
        return
    theirs = open(path, "rb").read()
    theirs_loaded = np.asarray(j_load_image(path).hidden_array)
    image_io.write_image(path, image)
    if name == "WebP":
        np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(theirs, np.uint8), cv2.IMREAD_UNCHANGED), image)
        np.testing.assert_array_equal(_opencv(path), image)
        np.testing.assert_array_equal(image_io.read_image(path), image)
    else:
        assert open(path, "rb").read() == theirs
    np.testing.assert_array_equal(np.asarray(j_load_image(path).hidden_array), theirs_loaded)
    np.testing.assert_array_equal(np.asarray(j_load_image(path).hidden_array),
                                  load_image(path, **CPU).hidden_array.numpy())


# --- the loaders --------------------------------------------------------------


def test_load_images_in_name_order_as_the_jax_loader(tmp_path):
    rng = np.random.default_rng(7)
    for name in ("frame_10.png", "frame_2.png", "a.bmp", "frame_1.png"):
        image = rng.integers(0, 256, (6, 8, 3) if name != "frame_2.png" else (6, 8)).astype(np.uint8)
        cv2.imwrite(str(tmp_path / name), image)
    (tmp_path / ".hidden.png").write_bytes(b"")
    ours, theirs = load_images(str(tmp_path), **CPU), j_load_images(str(tmp_path))
    assert len(ours) == len(theirs) == 4 and ours[3].total_num_channels == 1  # a, frame_1, frame_10, frame_2
    for a, b in zip(ours, theirs):
        assert a.spectral_mode.name == b.spectral_mode.name
        np.testing.assert_array_equal(a.hidden_array.numpy(), np.asarray(b.hidden_array))
    with pytest.raises(NotADirectoryError):
        load_images(str(tmp_path / "frame_1.png"), **CPU)
    with pytest.raises(FileNotFoundError):
        load_image(str(tmp_path / "missing.png"), **CPU)
    float32 = load_image(str(tmp_path / "frame_1.png"), device="cpu")
    assert float32.dtype == torch.float32
    np.testing.assert_allclose(float32.hidden_array.numpy(), ours[1].hidden_array.numpy(), rtol=0, atol=1e-7)


@pytest.mark.parametrize("channels,ext", [(1, ".png"), (3, ".png"), (3, ".bmp"), (2, ".png"), (5, ".bin")])
def test_save_image_dispatch_as_the_jax_loader(tmp_path, channels, ext):
    arr = np.random.default_rng(8).random((channels, 6, 8)) * 1.2 - 0.1
    ours = ImageData(arr, normalize="never", channel_major=True, **CPU)
    theirs = JImageData(jnp.asarray(arr), normalize="never", channel_major=True)
    save_image(ours, str(tmp_path / f"ours{ext}"))
    j_save_image(theirs, str(tmp_path / f"theirs{ext}"))
    if channels in (1, 3):
        assert (tmp_path / f"ours{ext}").read_bytes() != b""
        np.testing.assert_array_equal(_opencv(tmp_path / f"ours{ext}"), _opencv(tmp_path / f"theirs{ext}"))
    else:  # ENVI with its companions
        assert (tmp_path / f"ours{ext}").read_bytes() == (tmp_path / f"theirs{ext}").read_bytes()
        assert os.path.exists(tmp_path / f"ours{ext}.hdr") and os.path.exists(tmp_path / f"ours{ext}.config")
        back = load_image(str(tmp_path / f"ours{ext}.config"), **CPU)
        np.testing.assert_array_equal(back.hidden_array.numpy(), arr.astype(np.float32).astype(np.float64))


# --- ENVI ---------------------------------------------------------------------


def _write_cube(tmp_path, cube, big_endian=False, header_offset=0, name="cube.bsq"):
    path = tmp_path / name
    with open(path, "wb") as f:
        f.write(b"\xAB" * header_offset)
        f.write(cube.astype(">f4" if big_endian else "<f4").tobytes())
    return path


def _config(tmp_path, data_name, cube, extra="", name="cube.config"):
    bands, rows, cols = cube.shape
    text = (f"# a comment\nfile {data_name}\ninterleave bsq\ndata_type float\n"
            f"num_data_rows {rows}\nnum_data_cols {cols}\nnum_data_bands {bands}\n{extra}")
    path = tmp_path / name
    path.write_text(text)
    return path


@pytest.mark.parametrize("case", ["whole", "cropped", "big_endian", "offset_cropped_big_endian"])
def test_envi_reads_as_the_jax_loader(tmp_path, case):
    cube = np.random.default_rng(9).random((6, 9, 11)).astype(np.float32)
    big = "big_endian" in case
    offset = 24 if "offset" in case else 0
    _write_cube(tmp_path, cube, big, offset)
    extra = f"big_endian {'true' if big else 'false'}\nheader_offset {offset}\n"
    if "cropped" in case:
        extra += "start_row 2\nend_row 7\nstart_col 1\nend_col 10\nstart_band 1\nend_band 5\n"
    config = _config(tmp_path, "cube.bsq", cube, extra)  # a relative path, against the config's directory
    ours = load_image(str(config), **CPU)
    theirs = j_load_image(str(config))
    np.testing.assert_array_equal(ours.hidden_array.numpy(), np.asarray(theirs.hidden_array))
    assert ours.spectral_mode.name == theirs.spectral_mode.name
    expected = cube[1:5, 2:7, 1:10] if "cropped" in case else cube
    np.testing.assert_array_equal(ours.hidden_array.numpy(), expected.astype(np.float64))


def test_envi_native_and_numpy_reads_are_equal(tmp_path):
    assert native.native_available()  # the test machines have a C++ compiler
    cube = np.random.default_rng(10).random((5, 12, 7)).astype(np.float32)
    for big, offset in ((False, 0), (True, 16)):
        path = str(_write_cube(tmp_path, cube, big, offset, name=f"c{int(big)}.bsq"))
        for crop in (((0, 5), (0, 12), (0, 7)), ((1, 4), (3, 11), (2, 6))):
            args = (path, 5, 12, 7, *crop, offset, big)
            a, b = envi.read_cube_native(*args), envi.read_cube_numpy(*args)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="Invalid crop"):
        native.read_bsq(path, 5, 12, 7, crop=((0, 6), None, None))
    with pytest.raises(IOError, match="needs"):
        native.read_bsq(path, 5, 12, 8)  # a larger cube than the file holds


def test_envi_save_round_trip_and_header(tmp_path):
    cube = np.random.default_rng(11).random((4, 5, 6))
    path = str(tmp_path / "out.bin")
    envi.HyperspectralDataLoader(path).save_image(ImageData(cube, normalize="never", channel_major=True, **CPU),
                                                  big_endian=True)
    header, j_header = envi.read_envi_header(path + ".hdr"), j_read_envi_header(path + ".hdr")
    assert vars(header) == vars(j_header)
    assert (header.num_data_bands, header.num_data_rows, header.num_data_cols, header.big_endian) == (4, 5, 6, True)
    loader = envi.HyperspectralDataLoader(path + ".config", **CPU)
    loader.load_image_from_envi_file()
    j_loader = JLoader(path + ".config")
    j_loader.load_image_from_envi_file()
    np.testing.assert_array_equal(loader.get_image().hidden_array.numpy(),
                                  np.asarray(j_loader.get_image().hidden_array))
    np.testing.assert_array_equal(loader.get_image().hidden_array.numpy(), cube.astype(np.float32).astype(np.float64))
    with pytest.raises(ValueError, match="No image loaded"):
        envi.HyperspectralDataLoader(path).get_image()


def test_envi_refusals(tmp_path):
    cube = np.zeros((2, 3, 4), np.float32)
    _write_cube(tmp_path, cube)
    bad_crop = _config(tmp_path, "cube.bsq", cube, "start_row 2\nend_row 2\n", name="a.config")
    with pytest.raises(ValueError, match="crop"):
        load_image(str(bad_crop), **CPU)
    bil = _config(tmp_path, "cube.bsq", cube, "", name="b.config")
    bil.write_text(bil.read_text().replace("interleave bsq", "interleave bil"))
    with pytest.raises(NotImplementedError, match="BSQ"):
        load_image(str(bil), **CPU)
    hdr = tmp_path / "x.hdr"
    hdr.write_text("ENVI\nsamples = 4\nlines = 3\nbands = 2\ndata type = 12\n")
    with pytest.raises(NotImplementedError, match="float32"):
        envi.read_envi_header(str(hdr))


def test_config_reader_as_the_jax_reader(tmp_path):
    path = tmp_path / "c.txt"
    path.write_text("# comment\n\nkey value with spaces\nnumber   42\nlonely\n  padded   x  \n")
    eq = tmp_path / "c.hdr"
    eq.write_text("ENVI\nsamples = 4\nbyte order=1\ndescription = {a = b}\n")
    for file, delimiter in ((path, " "), (eq, "=")):
        ours, theirs = ConfigurationFileReader(delimiter), JReader(delimiter)
        ours.read_file(str(file))
        theirs.read_file(str(file))
        assert ours.values == theirs.values
    ours = ConfigurationFileReader()
    ours.read_file(str(path))
    assert ours.get_value("key") == "value with spaces" and ours.get_value_as_int("number") == 42
    assert ours.get_value("missing", "d") == "d" and ours.get_value_as_int("missing", 3) == 3
    with pytest.raises(KeyError, match="lonely"):
        ours.get_value_or_die("lonely")
