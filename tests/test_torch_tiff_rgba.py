"""The TIFF layouts OpenCV reads through libtiff's RGBA interface, against
``cv2.imdecode(..., IMREAD_UNCHANGED)`` on the same bytes: JPEG-compressed
TIFF (compression 7) as GDAL writes it for GIS imagery -- tiled 4:2:0 YCbCr
with shared ``JPEGTables`` (``tests/torch_gdal.py``), RGB and grey strips --,
as PIL's libtiff writes it, and hand-built around OpenCV's JPEG streams
(every sampling factor, tables in the tiles or shared, orientations);
YCbCr without JPEG in data units, with ``ReferenceBlackWhite`` and
``YCbCrCoefficients``; palette at 1, 4 and 8 bits with 8- and 16-bit maps;
bilevel grey. Each is array-equal to OpenCV's array, or raises
``ValueError`` where OpenCV returns None; what the port still refuses
raises ``NotImplementedError``. The port's ``load_image`` of a GDAL JPEG
GeoTIFF is the JAX ``load_image``'s."""

import io

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import torch_gdal
from super_resolution_tpu.utils.data_loader import load_image as j_load_image
from super_resolution_tpu_torch.utils.data_loader import load_image
from super_resolution_tpu_torch.utils.jpeg import decode_jpeg
from super_resolution_tpu_torch.utils.tiff import read_tiff
from torch_format_builders import jpeg_tiff_bytes, packed_tiff_bytes, tiff_bytes, ycbcr_tiff_bytes

gdal = pytest.mark.skipif(not torch_gdal.available(), reason=f"{torch_gdal.LIBRARY} does not load here")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)


def _scene(h, w, seed, channels=3):
    """Smooth colour with noise: chroma that upsampling has to get right."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.stack([128 + 90 * np.sin(xx / (3.0 + k)) * np.cos(yy / (5.0 + k)) for k in range(channels)], axis=-1)
    img += np.random.default_rng(seed).normal(0, 12, img.shape)
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _same_as_opencv(data: bytes):
    theirs = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if theirs is None:
        with pytest.raises(ValueError):
            read_tiff(data)
        return None
    ours = read_tiff(data)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, (ours.dtype, ours.shape, theirs.shape)
    np.testing.assert_array_equal(ours, theirs)
    return ours


def _read(data: bytes):
    """Array-equal to OpenCV, which must read the file."""
    assert _same_as_opencv(data) is not None
    return data


# --------------------------------------------------------------------------- JPEG (compression 7)

GDAL_SIZES = [(1, 1), (37, 53), (61, 77), (250, 250)]
GDAL_LAYOUTS = {"strips": {}, "tiles16": dict(TILED="YES", BLOCKXSIZE=16, BLOCKYSIZE=16),
                "tiles128": dict(TILED="YES", BLOCKXSIZE=128, BLOCKYSIZE=128),
                "tiles256": dict(TILED="YES", BLOCKXSIZE=256, BLOCKYSIZE=256)}


@gdal
@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("layout", sorted(GDAL_LAYOUTS))
@pytest.mark.parametrize("hw", GDAL_SIZES)
def test_gdal_jpeg_ycbcr(hw, layout, quality):
    """GDAL's ``COMPRESS=JPEG PHOTOMETRIC=YCBCR``: 4:2:0, JPEGTables, each
    strip or tile its own frame (its own edges for the chroma upsampling),
    edge tiles full frames cropped."""
    image = _scene(*hw, seed=hw[0] + quality)
    _read(torch_gdal.write(image, COMPRESS="JPEG", PHOTOMETRIC="YCBCR", JPEG_QUALITY=quality,
                           **GDAL_LAYOUTS[layout]))


@gdal
@pytest.mark.parametrize("options", [dict(), dict(BLOCKYSIZE=8), dict(TILED="YES", BLOCKXSIZE=16, BLOCKYSIZE=32)],
                         ids=["strip", "strips8", "tiles16x32"])
@pytest.mark.parametrize("channels", [1, 3])
def test_gdal_jpeg_rgb_and_grey(channels, options):
    """``COMPRESS=JPEG`` alone: photometric 2 (RGB components, no colour
    transform) or 1 (grey), in strips of 8 rows (one frame a strip, the last
    shorter) and in tiles."""
    _read(torch_gdal.write(_scene(37, 53, 1, channels), COMPRESS="JPEG", **options))


@gdal
@pytest.mark.parametrize("rows", [16, 32])
def test_gdal_jpeg_ycbcr_strips(rows):
    _read(torch_gdal.write(_scene(61, 77, 2), COMPRESS="JPEG", PHOTOMETRIC="YCBCR", BLOCKYSIZE=rows))


def _pil_tiff(image, **options) -> bytes:
    out = io.BytesIO()
    image.save(out, "TIFF", **options)
    return out.getvalue()


@pytest.mark.parametrize("quality", [30, 90])
@pytest.mark.parametrize("mode", ["RGB", "YCbCr", "L"])
def test_pil_jpeg(mode, quality):
    """PIL's libtiff: RGB (photometric 2), YCbCr at 1x1 and grey, each strip
    with its tables in JPEGTables."""
    rgb = _scene(37, 53, 3 + quality)
    image = Image.fromarray(rgb[..., 0] if mode == "L" else rgb).convert(mode)
    _read(_pil_tiff(image, compression="jpeg", quality=quality))


SAMPLINGS = {"444": ((1, 1), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
             "422": ((2, 1), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
             "420": ((2, 2), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
             "440": ((1, 2), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
             "411": ((4, 1), cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)}
HAND_JPEG_LAYOUTS = {"strip": dict(), "strips16": dict(rows_per_strip=16),
                     "strips16_shared_tables": dict(rows_per_strip=16, shared_tables=True),
                     "tiles16_tables_absent": dict(tile=(16, 16)),
                     "tiles32x16_shared_tables": dict(tile=(32, 16), shared_tables=True),
                     "no_subsampling_tag": dict(subsampling_tag=False),
                     "tiles_no_subsampling_tag": dict(tile=(16, 16), subsampling_tag=False)}


def _cv2_jpeg(sampling, quality=80):
    flag = SAMPLINGS[sampling][1]

    def encode(part):  # the file's R, G, B handed to OpenCV as BGR
        bgr = part if part.ndim == 2 else part[..., ::-1]
        params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag]
        return cv2.imencode(".jpg", np.ascontiguousarray(bgr), params)[1].tobytes()
    return encode


@pytest.mark.parametrize("layout", sorted(HAND_JPEG_LAYOUTS))
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_hand_built_jpeg_ycbcr(sampling, layout):
    """OpenCV's JPEG streams (JFIF, YCbCr) at every sampling factor, as
    strips or tiles, with their own tables or JPEGTables, and without the
    YCbCrSubsampling tag (libtiff then takes the first frame's)."""
    _read(jpeg_tiff_bytes(_scene(37, 53, 5), _cv2_jpeg(sampling), subsampling=SAMPLINGS[sampling][0],
                          **HAND_JPEG_LAYOUTS[layout]))


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("layout", [dict(tile=(16, 16), shared_tables=True), dict(rows_per_strip=16)],
                         ids=["tiles", "strips"])
def test_jpeg_orientation(layout, orientation):
    """The Orientation tag as the RGBA interface applies it: a mirror inside
    each tile, not across the row."""
    _read(jpeg_tiff_bytes(_scene(37, 53, 6), _cv2_jpeg("420"), extra_tags=[(274, 3, [orientation])], **layout))


@pytest.mark.parametrize("photometric", [0, 1, 2])
@pytest.mark.parametrize("layout", [dict(), dict(tile=(16, 32), shared_tables=True)], ids=["strip", "tiles"])
def test_jpeg_without_a_colour_transform(layout, photometric):
    """Photometric 2 (a 4:4:4 stream's components taken as R, G, B whatever
    its JFIF marker says), 1 and 0 (grey; min-is-white inverted)."""
    image = _scene(37, 53, 7, 3 if photometric == 2 else 1)
    _read(jpeg_tiff_bytes(image, _cv2_jpeg("444"), photometric=photometric, **layout))


def _without_marker(data: bytes, marker: int) -> bytes:
    """A JPEG stream with every segment of one marker before the first scan taken out."""
    out, i = bytearray(data[:2]), 2
    while data[i + 1] != 0xDA:
        end = i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
        if data[i + 1] != marker:
            out += data[i:end]
        i = end
    return bytes(out + data[i:])


def _adobe_ycbcr(data: bytes) -> bytes:
    """An Adobe-marked RGB stream whose APP14 transform flag says YCbCr (1)."""
    at = data.index(b"Adobe") + 11
    return data[:at] + b"\x01" + data[at + 1:]


@pytest.mark.parametrize("case", ["jfif", "ids_1_2_3", "adobe_rgb", "ids_r_g_b", "adobe_ycbcr_over_r_g_b"])
def test_standalone_jpeg_colour_guess(case):
    """Outside TIFF, ``decode_jpeg`` guesses a 3-component stream's colour
    space as libjpeg does: JFIF, else the Adobe transform flag, else the
    component ids ('R', 'G', 'B' for RGB)."""
    buffer = io.BytesIO()
    Image.fromarray(_scene(21, 35, 11)).save(buffer, "JPEG", quality=80, keep_rgb=case != "jfif" and case != "ids_1_2_3")
    data = buffer.getvalue()
    data = {"ids_1_2_3": lambda d: _without_marker(d, 0xE0), "ids_r_g_b": lambda d: _without_marker(d, 0xEE),
            "adobe_ycbcr_over_r_g_b": _adobe_ycbcr}.get(case, lambda d: d)(data)
    np.testing.assert_array_equal(decode_jpeg(data), cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("case", ["rgb_subsampled", "tag_against_stream"])
def test_jpeg_sampling_that_libtiff_refuses(case):
    """libtiff's JPEGPreDecode wants the YCbCrSubsampling factors (1x1 for RGB)
    in the first component and 1x1 in the others: OpenCV returns None."""
    if case == "rgb_subsampled":
        data = jpeg_tiff_bytes(_scene(37, 53, 8), _cv2_jpeg("420"), photometric=2)
    else:
        data = jpeg_tiff_bytes(_scene(37, 53, 8), _cv2_jpeg("422"), subsampling_tag=False,
                               extra_tags=[(530, 3, [2, 2])])
    assert _same_as_opencv(data) is None
    with pytest.raises(ValueError, match="sampling factors"):
        read_tiff(data)


# --------------------------------------------------------------------------- YCbCr without JPEG

YCBCR_SUBSAMPLINGS = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2)]
YCBCR_LAYOUTS = {"none": dict(), "none_strips7": dict(rows_per_strip=7), "lzw_tiles": dict(compression=5, tile=(32, 16)),
                 "deflate_strips12": dict(compression=8, rows_per_strip=12), "packbits": dict(compression=32773),
                 "deflate_tiles16": dict(compression=8, tile=(16, 16))}


@pytest.mark.parametrize("layout", sorted(YCBCR_LAYOUTS))
@pytest.mark.parametrize("subsampling", YCBCR_SUBSAMPLINGS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("hw", [(1, 1), (37, 53)])
def test_ycbcr_data_units(hw, subsampling, layout):
    """Data units of ``h x v`` Y then Cb, Cr; rows and columns padded to whole
    units; chroma replicated over its unit; libtiff's integer conversion."""
    ycc = np.random.default_rng(hw[0] + subsampling[0] * 3 + subsampling[1]).integers(0, 256, (*hw, 3))
    _read(ycbcr_tiff_bytes(ycc.astype(np.uint8), subsampling=subsampling, **YCBCR_LAYOUTS[layout]))


def _rationals(values):
    return [(int(round(v * 4)) & 0xFFFFFFFF, 4) for v in values]


@pytest.mark.parametrize("reference", [(0, 255, 128, 255, 128, 255), (16, 235, 128, 240, 128, 240),
                                       (15.5, 235.25, 100, 200, 90, 250), (0, 0, 128, 128, 128, 128),
                                       (300, 10, 50, 60, 70, 80)], ids=str)
@pytest.mark.parametrize("subsampling", [(1, 1), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_ycbcr_reference_black_white(subsampling, reference):
    """ReferenceBlackWhite (532): video range, fractions, empty and reversed
    ranges, through libtiff's float32 Code2V and its clamps."""
    ycc = np.random.default_rng(9).integers(0, 256, (32, 48, 3)).astype(np.uint8)
    _read(ycbcr_tiff_bytes(ycc, subsampling=subsampling, extra_tags=[(532, 5, _rationals(reference))]))


@pytest.mark.parametrize("pair, rationals", [("y", ((477, 53), (16215, 85))), ("y", ((2407, 15), (15052, 85))),
                                             ("cb", ((1408, 61), (717, 64))), ("cb", ((77, 73), (3032, 64)))],
                         ids=["y_9.0_190.8", "y_160.5_177.1", "cb_23.1_11.2", "cb_1.1_47.4"])
def test_ycbcr_code2v_in_float32(pair, rationals):
    """References whose Code2V quotient truncates otherwise in float64:
    libtiff divides in float32."""
    y, c = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    ycc = np.stack([y, c, y], axis=-1).astype(np.uint8)
    reference = [(0, 1), (255, 1), (128, 1), (255, 1), (128, 1), (255, 1)]
    at = 0 if pair == "y" else 2
    reference[at:at + 2] = rationals
    _read(ycbcr_tiff_bytes(ycc, subsampling=(1, 1), compression=8, extra_tags=[(532, 5, reference)]))


@pytest.mark.parametrize("luma", [(0.2126, 0.7152, 0.0722), (0.5, 0.3, 0.2), (1.2, 0.1, 0.9)], ids=str)
def test_ycbcr_coefficients(luma):
    """YCbCrCoefficients (529), out-of-range ones clamped as libtiff's FIX does."""
    ycc = np.random.default_rng(10).integers(0, 256, (32, 48, 3)).astype(np.uint8)
    _read(ycbcr_tiff_bytes(ycc, subsampling=(2, 1), extra_tags=[(529, 5, [(int(v * 10000), 10000) for v in luma])]))


def test_ycbcr_every_chroma_pair():
    """Every (Cb, Cr) at 1x1 under four luma levels, the default and a video-range reference."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    rows = [np.stack([np.full(cb.shape, y), cb, cr], axis=-1).reshape(-1, 1024, 3) for y in (0, 77, 180, 255)]
    ycc = np.concatenate(rows).astype(np.uint8)
    _read(ycbcr_tiff_bytes(ycc, subsampling=(1, 1), compression=8, rows_per_strip=64))
    _read(ycbcr_tiff_bytes(ycc, subsampling=(1, 1), compression=8, rows_per_strip=64,
                           extra_tags=[(532, 5, _rationals((16, 235, 128, 240, 128, 240)))]))


def test_ycbcr_planar_default_subsampling_and_pil():
    ycc = np.random.default_rng(11).integers(0, 256, (37, 53, 3)).astype(np.uint8)
    _read(ycbcr_tiff_bytes(ycc, subsampling=(1, 1), planar=True, rows_per_strip=16))
    _read(ycbcr_tiff_bytes(ycc, subsampling=(2, 2), subsampling_tag=False))  # the tag's default, 2x2
    _read(_pil_tiff(Image.fromarray(_scene(37, 53, 12)).convert("YCbCr"), compression="tiff_lzw"))


@pytest.mark.parametrize("case", ["1x4", "2x4", "planar_2x2"])
def test_ycbcr_that_opencv_does_not_read(case):
    ycc = np.random.default_rng(12).integers(0, 256, (16, 32, 3)).astype(np.uint8)
    if case == "planar_2x2":
        data = ycbcr_tiff_bytes(ycc, subsampling=(2, 2), planar=True)
    else:
        data = ycbcr_tiff_bytes(ycc, subsampling=tuple(int(c) for c in case.split("x")))
    assert _same_as_opencv(data) is None


# --------------------------------------------------------------------------- palette and bilevel

PACKED_LAYOUTS = {"none": dict(), "packbits_strips4": dict(rows_per_strip=4, compression=32773),
                  "lzw_tiles": dict(compression=5, tile=(16, 16)), "deflate_strips7": dict(compression=8, rows_per_strip=7)}


@pytest.mark.parametrize("layout", sorted(PACKED_LAYOUTS))
@pytest.mark.parametrize("map_bits", [8, 16])
@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("hw", [(1, 1), (37, 53)])
def test_palette(hw, bits, map_bits, layout):
    """The ColorMap taken as 8-bit when every entry is below 256, else its high
    bytes; BGR, and at 1 bit the grey OpenCV makes of the colours."""
    rng = np.random.default_rng(bits * 100 + map_bits + hw[0])
    colormap = rng.integers(0, 256, (3, 1 << bits))
    if map_bits == 16:
        colormap = colormap * 257 ^ rng.integers(0, 256, colormap.shape)
    indices = rng.integers(0, 1 << bits, hw).astype(np.uint8)
    _read(packed_tiff_bytes(indices, bits, photometric=3, colormap=colormap, **PACKED_LAYOUTS[layout]))


@pytest.mark.parametrize("case", ["16bit_map_below_256", "map_of_another_count", "no_map", "2_bits", "predictor",
                                  "pil"])
def test_palette_edges(case):
    rng = np.random.default_rng(13)
    indices = rng.integers(0, 256, (37, 53)).astype(np.uint8)
    colormap = rng.integers(0, 256, (3, 256))
    if case == "16bit_map_below_256":  # libtiff warns and takes it as 8-bit
        _read(packed_tiff_bytes(indices, 8, photometric=3, colormap=colormap))
    elif case == "map_of_another_count":  # libtiff drops the tag and reads 8-bit indices as grey
        _read(packed_tiff_bytes(indices, 8, photometric=3, colormap=colormap[:, :128]))
    elif case == "no_map":
        _read(packed_tiff_bytes(indices, 8, photometric=3))
        assert _same_as_opencv(packed_tiff_bytes(indices % 16, 4, photometric=3)) is None
    elif case == "2_bits":
        assert _same_as_opencv(packed_tiff_bytes(indices % 4, 2, photometric=3, colormap=colormap[:, :4])) is None
    elif case == "predictor":
        _read(packed_tiff_bytes(indices, 8, photometric=3, colormap=colormap, compression=5,
                                extra_tags=[(317, 3, [2])]))
    else:
        _read(_pil_tiff(Image.fromarray(_scene(37, 53, 14)).convert("P")))


@gdal
def test_gdal_palette():
    _read(torch_gdal.write(_scene(37, 53, 22, 1), PHOTOMETRIC="PALETTE"))


@pytest.mark.parametrize("layout", sorted(PACKED_LAYOUTS))
@pytest.mark.parametrize("photometric", [0, 1], ids=["min_is_white", "min_is_black"])
@pytest.mark.parametrize("hw", [(1, 1), (9, 17), (37, 53)])
def test_bilevel(hw, photometric, layout):
    """1-bit grey, rows padded to a byte: 0 / 255, min-is-white inverted."""
    bits = np.random.default_rng(hw[1] + photometric).integers(0, 2, hw).astype(np.uint8)
    _read(packed_tiff_bytes(bits, 1, photometric=photometric, **PACKED_LAYOUTS[layout]))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_bilevel_and_palette_orientation(orientation):
    rng = np.random.default_rng(orientation)
    tag = [(274, 3, [orientation])]
    _read(packed_tiff_bytes(rng.integers(0, 2, (37, 53)), 1, photometric=0, compression=8, tile=(16, 16),
                            extra_tags=tag))
    _read(packed_tiff_bytes(rng.integers(0, 256, (37, 53)), 8, photometric=3, colormap=rng.integers(0, 256, (3, 256)),
                            compression=8, tile=(32, 16), extra_tags=tag))


@gdal
@pytest.mark.parametrize("options", [dict(COMPRESS="PACKBITS"), dict(COMPRESS="LZW"), dict(COMPRESS="DEFLATE"),
                                     dict(PHOTOMETRIC="MINISWHITE")], ids=["packbits", "lzw", "deflate", "min_is_white"])
def test_gdal_nbits1(options):
    bits = (_scene(37, 53, 15, 1) > 127).astype(np.uint8)
    _read(torch_gdal.write(bits, NBITS=1, **options))


@pytest.mark.parametrize("compression", ["raw", "packbits"])
def test_pil_bilevel(compression):
    image = Image.fromarray(_scene(37, 53, 16, 1) > 127)
    _read(_pil_tiff(image) if compression == "raw" else _pil_tiff(image, compression="packbits"))


@pytest.mark.parametrize("case", ["4bit_grey_deflate", "2bit_grey", "4bit_min_is_white", "bilevel_predictor",
                                  "bilevel_two_samples"])
def test_sub_byte_layouts_opencv_does_not_read(case):
    """OpenCV returns None for 2- and 4-bit grey (its readHeader takes 1, 8,
    10, 12, 14, 16, 32, 64 bits and 4 only for palette), and libtiff for a
    predictor on 1-bit samples or packed extra samples: ``ValueError``."""
    rng = np.random.default_rng(17)
    data = {
        "4bit_grey_deflate": lambda: packed_tiff_bytes(rng.integers(0, 16, (37, 53)), 4, compression=8),
        "2bit_grey": lambda: packed_tiff_bytes(rng.integers(0, 4, (37, 53)), 2),
        "4bit_min_is_white": lambda: packed_tiff_bytes(rng.integers(0, 16, (9, 7)), 4, photometric=0),
        "bilevel_predictor": lambda: packed_tiff_bytes(rng.integers(0, 2, (9, 17)), 1, compression=5,
                                                       extra_tags=[(317, 3, [2])]),
        "bilevel_two_samples": lambda: packed_tiff_bytes(rng.integers(0, 2, (9, 34)), 1, samples_per_pixel=2),
    }[case]()
    assert _same_as_opencv(data) is None


@gdal
def test_gdal_nbits4_returns_none():
    assert _same_as_opencv(torch_gdal.write(_scene(37, 53, 18, 1) >> 4, NBITS=4, COMPRESS="DEFLATE")) is None


@pytest.mark.parametrize("case", ["palette", "bilevel"])
def test_signed_samples_give_int8(case):
    """SampleFormat 2: OpenCV's Mat is int8, the RGBA interface's bytes."""
    rng = np.random.default_rng(19)
    if case == "palette":
        data = packed_tiff_bytes(rng.integers(0, 256, (9, 17)), 8, photometric=3,
                                 colormap=rng.integers(0, 256, (3, 256)), sample_format=2)
    else:
        data = packed_tiff_bytes(rng.integers(0, 2, (9, 17)), 1, sample_format=2)
    assert _same_as_opencv(data).dtype == np.int8


# --------------------------------------------------------------------------- refusals and the loader

REFUSED = {
    "jpeg_extra_samples": (lambda img: tiff_bytes(np.dstack([img, img[..., :1]]), declared_compression=7),
                           "JPEG-compressed TIFF with extra samples"),
    "jpeg_planar": (lambda img: tiff_bytes(img, planar=True, declared_compression=7), "Planar .*JPEG"),
    "ycbcr_4x4": (lambda img: ycbcr_tiff_bytes(img, subsampling=(4, 4)), "subsampling 4x4"),
    "jpeg_12bit": (lambda img: tiff_bytes(img.astype(np.uint16), declared_compression=7, bits=12), "12-bit JPEG"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_name_the_layout(name):
    build, match = REFUSED[name]
    with pytest.raises(NotImplementedError, match=match):
        read_tiff(build(_scene(16, 32, 20)))


@gdal
def test_load_image_matches_the_jax_loader(tmp_path):
    """A GDAL JPEG-YCbCr GeoTIFF (tiled, 4:2:0) through both packages' ``load_image``."""
    path = str(tmp_path / "scene.tif")
    with open(path, "wb") as f:
        f.write(torch_gdal.write(_scene(61, 77, 21), COMPRESS="JPEG", PHOTOMETRIC="YCBCR", TILED="YES",
                                 BLOCKXSIZE=32, BLOCKYSIZE=32, JPEG_QUALITY=75))
    ours = load_image(path, device="cpu", dtype=torch.float64).hidden_array.numpy()
    np.testing.assert_array_equal(ours, np.asarray(j_load_image(path).hidden_array))
    assert ours.shape == (3, 61, 77)
