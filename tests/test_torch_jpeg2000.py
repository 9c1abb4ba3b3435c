"""The port's JPEG 2000 reader (``utils/jpeg2000.py`` over
``native/jpeg2000_decoder.cpp``) against ``cv2.imread(path,
IMREAD_UNCHANGED)`` on the same file: the same dtype, shape and values, or a
``ValueError`` where OpenCV returns ``None``.

The files come from three writers and two kinds of hand edits:
``cv2.imwrite`` (OpenJPEG: 5/3, one layer, rate-limited at its default, so
the code-blocks' passes are cut), PIL (OpenJPEG with every option PIL
exposes: 9/7, the colour transform, layers by rate and by quality, code-block
and precinct sizes, the five progressions, tiles, raw codestreams, PLT,
RGBA, 16 bits), FFmpeg's own ``jpeg2000`` encoder (SOP / EPH markers,
progressions, tiles, layers, its 5/3 and integer 9/7) through
``tests/torch_libav.py``, codestreams wrapped in JP2 boxes written here
(colour specifications, palettes, channel definitions) and SIZ / COD edits
(precisions, signed components, the Part 1 features set by hand, HTJ2K and
Part 2, which the reader refuses by name). The rest of Part 1 (code-block
styles, RGN, POC, PPM / PPT) in files OpenJPEG's own encoder writes:
``tests/test_torch_jpeg2000_features.py``.
The decoder's counts (the ``stats`` of ``decode_jpeg2000``) show what each file reached. Also: the
port's loader and ``super_resolve`` from ``.jp2`` frames against the JAX
package's, which read through OpenCV.
"""

import contextlib
import io
import os
import struct

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import torch_libav
import torch_openjpeg
from super_resolution_tpu.cli import super_resolve as j_super_resolve
from super_resolution_tpu.utils.data_loader import load_image as j_load_image
from super_resolution_tpu_torch import native
from super_resolution_tpu_torch.cli import super_resolve
from super_resolution_tpu_torch.utils import image_io
from super_resolution_tpu_torch.utils.data_loader import load_image
from super_resolution_tpu_torch.utils.jpeg2000 import decode_jpeg2000

CPU = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch, tmp_path_factory):
    torch.set_num_threads(1)
    monkeypatch.setenv("SRTPU_COMPILE_CACHE", str(tmp_path_factory.getbasetemp() / "jax_cache"))


@pytest.fixture(scope="module", autouse=True)
def _built():
    native.get_jpeg2000_library()  # one build for the module


def _smooth(h, w, c, seed, peak=255):
    """A photograph-like image (waves, an edge, some noise), uint8 or up to ``peak``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    planes = [0.5 + 0.35 * np.sin(xx / (4.0 + k)) * np.cos(yy / (5.0 + k)) + 0.2 * (xx > w // 3) for k in range(c)]
    img = np.stack(planes, -1) / 1.3 + rng.normal(0, 0.03, (h, w, c))
    img = np.rint(np.clip(img, 0, 1) * peak).astype(np.uint8 if peak == 255 else np.uint16)
    return img[..., 0] if c == 1 else img


def _compare(tmp_path, data: bytes, name="image.jp2"):
    """(OpenCV's array or None, the port's array or the exception it raised)."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    theirs = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    try:
        ours = image_io.read_image(path)
    except (ValueError, NotImplementedError) as error:
        ours = error
    return theirs, ours


def _assert_like_opencv(tmp_path, data: bytes):
    theirs, ours = _compare(tmp_path, data)
    assert theirs is not None, "OpenCV refused the file"
    assert not isinstance(ours, Exception), ours
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)
    stats = {}
    np.testing.assert_array_equal(decode_jpeg2000(data, stats), theirs)
    return stats


def _assert_refused_like_opencv(tmp_path, data: bytes, match):
    theirs, ours = _compare(tmp_path, data)
    assert theirs is None
    assert isinstance(ours, ValueError), ours
    assert match.lower() in str(ours).lower(), ours


def _pil(image, mode=None, **options) -> bytes:
    out = io.BytesIO()
    (Image.fromarray(image, mode) if mode else Image.fromarray(image)).save(out, "JPEG2000", **options)
    return out.getvalue()


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def _jp2(codestream, components, colr=(1, 16), pclr=None, cmap=None, cdef=None, size=None):
    """A JP2 file around ``codestream``: ihdr (its size from SIZ unless ``size``), colr (method, value),
    pclr (entries [NE, NPC], bit depths), cmap [(cmp, mtyp, pcol)], cdef [(cn, typ, asoc)]."""
    x1, y1, x0, y0 = struct.unpack(">IIII", codestream[8:24])
    w, h = size or (x1 - x0, y1 - y0)
    header = _box(b"ihdr", struct.pack(">IIHBBBB", h, w, components, 7, 7, 0, 0))
    if colr is not None:
        method, value = colr
        header += _box(b"colr", bytes([method, 0, 0]) + (struct.pack(">I", value) if method == 1 else value))
    if pclr is not None:
        entries, depths = pclr
        body = struct.pack(">HB", len(entries), len(depths)) + bytes(d - 1 for d in depths)
        body += b"".join(int(v).to_bytes((d + 7) // 8, "big") for row in entries for v, d in zip(row, depths))
        header += _box(b"pclr", body)
    if cmap is not None:
        header += _box(b"cmap", b"".join(struct.pack(">HBB", *m) for m in cmap))
    if cdef is not None:
        header += _box(b"cdef", struct.pack(">H", len(cdef)) + b"".join(struct.pack(">HHH", *c) for c in cdef))
    return (_box(b"jP  ", b"\r\n\x87\n") + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ") + _box(b"jp2h", header)
            + _box(b"jp2c", codestream))


def _codestream(image, **options) -> bytes:
    return _pil(image, no_jp2=True, **options)


def _with_precision(codestream: bytes, precision: int, signed=False) -> bytes:
    data = bytearray(codestream)
    (n,) = struct.unpack(">H", data[40:42])
    for c in range(n):
        data[42 + 3 * c] = (precision - 1) | (0x80 if signed else 0)
    return bytes(data)


# --- OpenCV's writer -------------------------------------------------------------------------------------------


@pytest.mark.parametrize("channels,depth,rate,size", [
    (1, 8, None, (37, 53)), (3, 8, None, (37, 53)), (1, 8, 10, (64, 80)), (3, 8, 100, (61, 77)),
    (3, 8, 1000, (33, 47)), (1, 16, 250, (40, 50)), (3, 16, 100, (35, 45)), (1, 8, 250, (130, 33))])
def test_opencv_files(tmp_path, channels, depth, rate, size):
    """``cv2.imwrite``'s JP2: 5/3, one layer, LRCP; below 1000 per mille rate-limited, so passes are cut."""
    image = _smooth(*size, channels, seed=channels + depth, peak=255 if depth == 8 else 4095)
    params = [] if rate is None else [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, rate]
    data = cv2.imencode(".jp2", image, params)[1].tobytes()
    stats = _assert_like_opencv(tmp_path, data)
    assert stats["reversible"] == channels and stats["lrcp"] == 1
    assert (stats["truncated_blocks"] > 0) == (rate != 1000)


# --- PIL (OpenJPEG's encoder) ----------------------------------------------------------------------------------


@pytest.mark.parametrize("progression", ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"])
def test_progressions_layers_precincts_tiles(tmp_path, progression):
    """9/7 with the colour transform, 3 layers by quality, 32x32 precincts, 16x8 code-blocks, 40x24 tiles; and
    5/3 with 3 layers by rate, 3 resolutions, 16x16 precincts, 4x4 code-blocks."""
    image = _smooth(61, 77, 3, seed=1)
    stats = _assert_like_opencv(tmp_path, _pil(
        image, irreversible=True, mct=1, quality_mode="dB", quality_layers=[25, 35, 45], progression=progression,
        precinct_size=(32, 32), codeblock_size=(16, 8), tile_size=(40, 24)))
    assert stats[progression.lower()] == 6 and stats["tiles"] == 6 and stats["layers"] == 3
    assert stats["ict"] == 6 and stats["precincts_defined"] == 18
    stats = _assert_like_opencv(tmp_path, _pil(
        image, progression=progression, mct=1, num_resolutions=3, precinct_size=(16, 16), codeblock_size=(4, 4),
        quality_layers=[60, 20, 5]))
    assert stats["rct"] == 1 and stats["truncated_blocks"] > 0


@pytest.mark.parametrize("options", [
    dict(irreversible=True), dict(irreversible=True, mct=0), dict(mct=1), dict(mct=0),
    dict(tile_size=(17, 13)), dict(tile_size=(17, 13), irreversible=True, quality_layers=[30, 10]),
    dict(no_jp2=True), dict(plt=True, quality_layers=[30]), dict(num_resolutions=1),
    dict(num_resolutions=6, codeblock_size=(64, 16), irreversible=True), dict(codeblock_size=(4, 64)),
    dict(quality_mode="rates", quality_layers=[80, 40, 20, 10, 5], irreversible=True),
    dict(precinct_size=(16, 16), num_resolutions=3), dict(precinct_size=(32, 16), codeblock_size=(64, 32), irreversible=True)],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_pil_options(tmp_path, options):
    _assert_like_opencv(tmp_path, _pil(_smooth(61, 77, 3, seed=2), **options))


@pytest.mark.parametrize("kind", ["grey", "grey 9/7", "rgba", "rgba 9/7", "16 bit", "16 bit 9/7"])
def test_pil_modes(tmp_path, kind):
    if kind.startswith("grey"):
        image, mode = _smooth(45, 33, 1, seed=3), None
    elif kind.startswith("rgba"):
        image, mode = _smooth(45, 33, 4, seed=4), None
    else:
        image, mode = _smooth(33, 45, 1, seed=5, peak=65535), "I;16"
    options = dict(irreversible=True, quality_layers=[20]) if kind.endswith("9/7") else {}
    if mode:
        with pytest.warns(DeprecationWarning):
            data = _pil(image, mode, **options)
    else:
        data = _pil(image, **options)
    out = _assert_like_opencv(tmp_path, data)
    assert out["irreversible" if options else "reversible"] > 0


@pytest.mark.parametrize("size", [(1, 1), (1, 7), (7, 1), (2, 2), (3, 5), (129, 3)])
def test_tiny_and_thin_images(tmp_path, size):
    """Resolutions of 0 and 1 samples, odd lengths: the 5/3 and 9/7 single-sample and boundary cases."""
    rng = np.random.default_rng(size[0] * 10 + size[1])
    _assert_like_opencv(tmp_path, _pil(rng.integers(0, 256, size).astype(np.uint8)))
    levels = 1 if min(size) < 2 else 2
    _assert_like_opencv(tmp_path, _pil(rng.integers(0, 256, size + (3,)).astype(np.uint8), irreversible=True,
                                       num_resolutions=levels))


def test_one_pixel_tiles(tmp_path):
    """Tiles at odd offsets, one of them 1 pixel wide: each tile-component starts on an odd coordinate."""
    image = _smooth(9, 11, 3, seed=6)
    for irreversible in (False, True):
        stats = _assert_like_opencv(tmp_path, _pil(image, tile_size=(5, 4), num_resolutions=2,
                                                   irreversible=irreversible))
        assert stats["tiles"] == 9


def test_raw_codestream_under_jp2_name(tmp_path):
    """OpenCV picks the decoder by signature: a raw codestream named .jp2 reads as one."""
    data = _codestream(_smooth(30, 40, 3, seed=7), irreversible=True)
    assert data[:4] == b"\xff\x4f\xff\x51"
    _assert_like_opencv(tmp_path, data)


# --- FFmpeg's encoder ------------------------------------------------------------------------------------------


def _ffmpeg(image, pix_fmt, options):
    h, w = image.shape[:2]
    planes = [image.view(np.uint8).reshape(h, -1)] if pix_fmt != "yuv420p" else image
    (payload,), _ = torch_libav.encode("jpeg2000", [planes], pix_fmt, w, h, options)
    return payload


@pytest.mark.parametrize("options", [
    {}, {"format": "jp2"}, {"sop": "1", "eph": "1"}, {"pred": "dwt53"}, {"pred": "dwt97int"},
    {"layer_rates": "100,10,1", "pred": "dwt53"}, {"layer_rates": "50,20,5", "eph": "1"},
    *({"prog": p, "sop": "1", "eph": "1", "tile_width": "16", "tile_height": "16"}
      for p in ("lrcp", "rlcp", "rpcl", "pcrl", "cprl"))],
    ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()) or "default")
def test_ffmpeg_grey(tmp_path, options):
    stats = _assert_like_opencv(tmp_path, _ffmpeg(_smooth(37, 45, 1, seed=8), "gray", options))
    if options.get("sop"):
        assert stats["sop_markers"] == stats["packets"] > 0
    if options.get("eph"):
        assert stats["eph_markers"] == stats["packets"]
    if "prog" in options:
        assert stats[options["prog"]] == stats["tiles"] == 9


@pytest.mark.parametrize("pix_fmt,pred", [("rgb24", "dwt53"), ("rgb24", "dwt97int"), ("gray16le", "dwt53")])
def test_ffmpeg_colour_and_16_bit(tmp_path, pix_fmt, pred):
    image = _smooth(37, 45, 3, seed=9) if pix_fmt == "rgb24" else _smooth(37, 45, 1, seed=9, peak=65535)
    _assert_like_opencv(tmp_path, _ffmpeg(image, pix_fmt, {"format": "jp2", "pred": pred}))


def test_ffmpeg_sub_sampled_components_are_refused_as_opencv_refuses_them(tmp_path):
    h, w = 32, 48
    planes = [_smooth(h, w, 1, seed=10), _smooth(h // 2, w // 2, 1, seed=11), _smooth(h // 2, w // 2, 1, seed=12)]
    (payload,), _ = torch_libav.encode("jpeg2000", [planes], "yuv420p", w, h, {"format": "jp2"})
    _assert_refused_like_opencv(tmp_path, payload, "sub-sampled")


# --- the JP2 boxes -------------------------------------------------------------------------------------------


@pytest.mark.parametrize("colr", [(1, 16), (1, 17), (1, 18), (1, 5), (2, b"\0" * 128), None, (3, b"\0\0\0\x10")],
                         ids=["sRGB", "grey", "sYCC", "enumerated 5", "ICC", "no colr", "method 3"])
@pytest.mark.parametrize("irreversible", [False, True])
def test_colour_specifications(tmp_path, colr, irreversible):
    """sRGB and unknown spaces as BGR, grey as the first component three times, sYCC through OpenCV's YUV -> BGR."""
    codestream = _codestream(_smooth(21, 30, 3, seed=13), irreversible=irreversible, mct=0)
    _assert_like_opencv(tmp_path, _jp2(codestream, 3, colr=colr))


@pytest.mark.parametrize("value,name", [(24, "eYCC"), (12, "CMYK")])
def test_colour_spaces_opencv_refuses(tmp_path, value, name):
    codestream = _codestream(_smooth(21, 30, 3, seed=14))
    _assert_refused_like_opencv(tmp_path, _jp2(codestream, 3, colr=(1, value)), name)


def test_sycc_16_bit(tmp_path):
    codestream = _with_precision(_codestream(_smooth(21, 30, 3, seed=15)), 12)
    out = _assert_like_opencv(tmp_path, _jp2(codestream, 3, colr=(1, 18)))
    assert out["reversible"] == 3


@pytest.mark.parametrize("columns,depth,entries,cmap", [
    (3, 8, 256, None), (3, 16, 256, None), (3, 8, 100, None), (4, 8, 256, None), (1, 8, 256, None),
    (3, 8, 256, [(0, 1, 0), (0, 1, 1), (0, 0, 0)])], ids=["rgb", "rgb 16-bit", "short", "rgba", "one", "direct"])
def test_palettes(tmp_path, columns, depth, entries, cmap):
    """pclr + cmap: the palette applied (indices past the end clamped), three or more columns under OpenCV's
    one-channel Mat converted to grey on the columns' low bits."""
    rng = np.random.default_rng(columns + depth)
    codestream = _codestream(_smooth(21, 30, 1, seed=16))
    table = rng.integers(0, 1 << depth, (entries, columns))
    _assert_like_opencv(tmp_path, _jp2(codestream, columns, pclr=(table, [depth] * columns),
                                       cmap=cmap or [(0, 1, i) for i in range(columns)]))


def test_palette_on_a_colour_codestream(tmp_path):
    """Three components, one mapped through a 16-bit palette: OpenCV keeps the low byte of each column."""
    rng = np.random.default_rng(17)
    codestream = _codestream(_smooth(16, 16, 3, seed=17))
    _assert_like_opencv(tmp_path, _jp2(codestream, 3, pclr=(rng.integers(0, 65536, (256, 3)), [16] * 3),
                                       cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)]))


def test_palette_refusals(tmp_path):
    rng = np.random.default_rng(18)
    grey, colour = _codestream(_smooth(16, 16, 1, seed=18)), _codestream(_smooth(16, 16, 3, seed=18))
    table = (rng.integers(0, 256, (256, 2)), [8, 8])
    # Two columns under a three-component codestream: OpenCV has no 2 -> 3 channel conversion.
    _assert_refused_like_opencv(tmp_path, _jp2(colour, 3, pclr=table, cmap=[(0, 1, 0), (0, 1, 1)]), "conversion")
    # A column mapped from a component the codestream does not have.
    _assert_refused_like_opencv(tmp_path, _jp2(grey, 2, pclr=table, cmap=[(0, 1, 0), (3, 1, 1)]), "component")


@pytest.mark.parametrize("cdef", [[(0, 0, 3), (1, 0, 2), (2, 0, 1)], [(0, 0, 1), (1, 0, 2), (2, 0, 3)],
                                  [(2, 0, 1), (0, 0, 3), (1, 0, 2)]], ids=["reversed", "identity", "rotated"])
def test_channel_definitions(tmp_path, cdef):
    _assert_like_opencv(tmp_path, _jp2(_codestream(_smooth(21, 30, 3, seed=19)), 3, cdef=cdef))


def test_alpha_channel_definitions(tmp_path):
    codestream = _codestream(_smooth(21, 30, 4, seed=20))
    _assert_like_opencv(tmp_path, _jp2(codestream, 4, cdef=[(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)]))
    _assert_like_opencv(tmp_path, _jp2(codestream, 4, cdef=[(0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 2, 0)]))


def test_box_refusals(tmp_path):
    codestream = _codestream(_smooth(21, 30, 3, seed=21))
    _assert_refused_like_opencv(tmp_path, _jp2(codestream, 3, cdef=[(0, 0, 1), (1, 0, 2)]), "channel definitions")
    _assert_refused_like_opencv(tmp_path, _jp2(codestream, 3, size=(31, 21)), "ihdr")
    good = _jp2(codestream, 3)
    _assert_refused_like_opencv(tmp_path, good[:12] + good[32:], "ftyp")


# --- SIZ edits: precision and sign ------------------------------------------------------------------------------


@pytest.mark.parametrize("precision", [9, 10, 12, 16])
@pytest.mark.parametrize("irreversible", [False, True])
def test_precisions_as_uint16(tmp_path, precision, irreversible):
    """9 to 16 bits read as uint16, unscaled (the DC shift and clamp of the component's own precision)."""
    codestream = _codestream(_smooth(21, 30, 3, seed=22), irreversible=irreversible)
    out = _assert_like_opencv(tmp_path, _jp2(_with_precision(codestream, precision), 3))
    assert out["irreversible" if irreversible else "reversible"] == 3


@pytest.mark.parametrize("precision,signed,match", [(4, False, "8 bits"), (7, False, "8 bits"),
                                                    (17, False, "16 bits"), (8, True, "signed")])
def test_precisions_and_signs_opencv_refuses(tmp_path, precision, signed, match):
    codestream = _with_precision(_codestream(_smooth(21, 30, 1, seed=23)), precision, signed)
    _assert_refused_like_opencv(tmp_path, _jp2(codestream, 1), match)


def test_two_components_image_offsets_and_other_files_are_refused(tmp_path):
    la = np.stack([_smooth(21, 30, 1, seed=24), _smooth(21, 30, 1, seed=25)], -1)
    _assert_refused_like_opencv(tmp_path, _pil(la, "LA"), "2 components")
    _assert_refused_like_opencv(tmp_path, _pil(_smooth(37, 53, 3, seed=26), offset=(3, 5), tile_size=(16, 16),
                                               tile_offset=(1, 2)), "offset")
    _assert_refused_like_opencv(tmp_path, b"\0\0\0\x0cjP  \r\n\x87\x0b" + bytes(64), "not a jpeg 2000")
    # PIL halves a 16x16 precinct down each of 6 resolutions: a precinct of 1 above resolution 0.
    _assert_refused_like_opencv(tmp_path, _pil(_smooth(61, 77, 3, seed=2), precinct_size=(16, 16)), "precinct")


def test_files_cut_short_are_refused_as_opencv_refuses_them(tmp_path):
    """OpenJPEG in OpenCV decodes strictly: every cut, down to the last byte of the EOC marker, returns None."""
    for data in (cv2.imencode(".jp2", _smooth(37, 53, 3, seed=27))[1].tobytes(),
                 _codestream(_smooth(37, 53, 1, seed=28), tile_size=(16, 16), irreversible=True)):
        for cut in (len(data) - 1, len(data) - 2, len(data) - 3, len(data) // 2, 150, 60, 20, 4):
            theirs, ours = _compare(tmp_path, data[:cut])
            assert theirs is None and isinstance(ours, ValueError), (cut, ours)


def _packet_header(bits) -> bytes:
    """Packet-header bits as a codestream holds them: a byte after 0xFF carries 7 bits."""
    out, byte, room, pending = bytearray(), 0, 8, 0
    for bit in bits:
        byte, room, pending = byte << 1 | bit, room - 1, pending + 1
        if room == 0:
            out.append(byte)
            byte, room, pending = 0, 7 if byte == 0xFF else 8, 0
    if pending:
        out.append(byte << room)
    return bytes(out)


@pytest.mark.parametrize("lblock,length,match", [(33, 2**33 - 1, "33 bits"), (32, 0xFFFFFFF0, "runs past")],
                         ids=["length field over 32 bits", "length past the tile"])
def test_code_block_lengths_opencv_refuses(tmp_path, lblock, length, match):
    """A first packet whose one code-block has 1 pass and a length field of ``lblock`` bits: OpenJPEG refuses a
    field wider than 32 bits and a length past the tile's data, and so does the port."""
    codestream = _codestream(_smooth(16, 16, 1, seed=40), num_resolutions=1)
    sod = codestream.index(b"\xff\x93") + 2
    # Not empty; included (inclusion tag tree 0); no missing bit-plane; 1 pass; Lblock 3 raised to lblock.
    bits = [1, 1, 1, 0] + [1] * (lblock - 3) + [0] + [int(b) for b in f"{length:0{lblock}b}"]
    header = _packet_header(bits)
    _assert_refused_like_opencv(tmp_path, codestream[:sod] + header + codestream[sod + len(header):], match)


# --- features refused by name -----------------------------------------------------------------------------------


def _insert_main_segment(codestream: bytes, segment: bytes) -> bytes:
    sot = codestream.index(b"\xff\x90")
    return codestream[:sot] + segment + codestream[sot:]


def _set_cod_byte(codestream: bytes, offset: int, value: int) -> bytes:
    data = bytearray(codestream)
    data[codestream.index(b"\xff\x52") + offset] = value
    return bytes(data)


def _insert_tile_segment(codestream: bytes, segment: bytes) -> bytes:
    sot = codestream.index(b"\xff\x90")
    (psot,) = struct.unpack(">I", codestream[sot + 6:sot + 10])
    head = codestream[:sot + 6] + struct.pack(">I", psot + len(segment)) + codestream[sot + 10:sot + 12]
    return head + segment + codestream[sot + 12:]


# Part 1 features set on a codestream written without them: a code-block style decoding data coded without it,
# a POC naming component 0 only (the others left unread), an empty PPM / PPT segment (OpenJPEG's error), an RGN
# shift of 5 on component 0.
_CRAFTED = {
    "BYPASS": lambda c: _set_cod_byte(c, 12, 0x01), "RESET": lambda c: _set_cod_byte(c, 12, 0x02),
    "TERMALL": lambda c: _set_cod_byte(c, 12, 0x04), "VSC": lambda c: _set_cod_byte(c, 12, 0x08),
    "PTERM": lambda c: _set_cod_byte(c, 12, 0x10), "SEGSYM": lambda c: _set_cod_byte(c, 12, 0x20),
    "POC": lambda c: _insert_main_segment(c, bytes.fromhex("ff5f000900000001060100")),
    "PPM": lambda c: _insert_main_segment(c, bytes.fromhex("ff60000300")),
    "PPT": lambda c: _insert_tile_segment(c, bytes.fromhex("ff61000300")),
    "RGN": lambda c: _insert_main_segment(c, bytes.fromhex("ff5e0005000005")),
}


@pytest.mark.parametrize("feature", list(_CRAFTED))
def test_crafted_features_read_as_opencv_reads_them(tmp_path, feature):
    """The Part 1 features the reader once refused by name, set by hand on PIL's codestream: the port's array
    equals OpenCV's, or both refuse (the empty PPM / PPT segments)."""
    data = _CRAFTED[feature](_codestream(_smooth(16, 16, 3, seed=29)))
    theirs, ours = _compare(tmp_path, data)
    if theirs is None:
        assert isinstance(ours, ValueError), ours
        assert feature in ("PPM", "PPT") and feature in str(ours)
    else:
        assert not isinstance(ours, Exception), ours
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        np.testing.assert_array_equal(ours, theirs)


_REFUSED = {
    "HTJ2K (Part 15) high-throughput": lambda c: _set_cod_byte(c, 12, 0x40),
    "HTJ2K (Part 15) codestreams (CAP)": lambda c: _insert_main_segment(c, bytes.fromhex("ff500008000200000000")),
    "HTJ2K (Part 15) codestreams": lambda c: c[:6] + b"\x40\x00" + c[8:],
    "Part 2 extensions (Rsiz": lambda c: c[:6] + b"\x80\x00" + c[8:],
    "Part 2 extensions (marker 0xFF74)": lambda c: _insert_main_segment(c, bytes.fromhex("ff7400040000")),
    "Part 2 extensions (arbitrary wavelet": lambda c: _set_cod_byte(c, 13, 2),
    "Part 2 extensions (multiple component": lambda c: _set_cod_byte(c, 8, 2),
}


@pytest.mark.parametrize("feature", list(_REFUSED))
def test_refused_features_are_named(feature):
    codestream = _codestream(_smooth(16, 16, 3, seed=29))
    with pytest.raises(NotImplementedError, match=feature.replace("(", "\\(").replace(")", "\\)")):
        decode_jpeg2000(_REFUSED[feature](codestream))


def test_no_compiler_means_no_jpeg2000_reader(monkeypatch, tmp_path):
    data = cv2.imencode(".jp2", _smooth(32, 32, 1, seed=30))[1].tobytes()
    monkeypatch.setattr(native, "_loaded", {})
    monkeypatch.setattr(native, "_compiler", lambda: None)
    monkeypatch.setattr(native, "_library_path", lambda source=None: tmp_path / "absent.so")
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        decode_jpeg2000(data)


# --- the loader and the CLI against the JAX package ------------------------------------------------------------


@pytest.mark.parametrize("channels,writer", [(1, "opencv"), (3, "opencv"), (3, "pil 9/7")])
def test_load_image_as_the_jax_loader(tmp_path, channels, writer):
    image = _smooth(40, 44, channels, seed=31 + channels)
    path = str(tmp_path / "image.jp2")
    if writer == "opencv":
        assert cv2.imwrite(path, image)
    else:
        with open(path, "wb") as f:
            f.write(_pil(image, irreversible=True, quality_layers=[15, 5], progression="PCRL"))
    np.testing.assert_array_equal(load_image(path, **CPU).hidden_array.numpy(),
                                  np.asarray(j_load_image(path).hidden_array))


def test_super_resolve_from_jpeg2000_frames_as_jax(tmp_path):
    """LR frames as JPEG 2000 (OpenCV's rate-limited 5/3 and PIL's 9/7 with layers) and a .jp2 truth: the two
    CLIs print the same PSNR / SSIM to 1e-6."""

    def write(path, k, low):
        if k % 2:
            with open(path, "wb") as f:
                f.write(_pil(low, irreversible=True, quality_layers=[12, 4], num_resolutions=3))
        else:
            assert cv2.imwrite(path, low)

    _super_resolve_as_jax(tmp_path, write)


def test_super_resolve_from_openjpeg_featured_frames_as_jax(tmp_path):
    """LR frames OpenJPEG's own encoder writes with all six code-block styles, 3 layers and two POC entries (9/7
    and 5/3 in turn): the two CLIs print the same PSNR / SSIM to 1e-6."""

    def write(path, k, low):
        data = torch_openjpeg.encode(low, mode=63, rates=(30, 10, 4), irreversible=bool(k % 2), resolutions=4,
                                     pocs=((0, 0, 2, 2, 1, "RLCP", 1), (0, 0, 3, 4, 1, "CPRL", 1)))
        stats = {}
        decode_jpeg2000(data, stats)
        assert stats["poc_entries"] == 2 and stats["segments"] == stats["passes"] > 0  # TERMALL: a segment a pass
        with open(path, "wb") as f:
            f.write(data)

    _super_resolve_as_jax(tmp_path, write)


def _super_resolve_as_jax(tmp_path, write):
    truth = _smooth(64, 64, 1, seed=40)
    frames = tmp_path / "frames"
    frames.mkdir()
    shifts = [(0, 0), (1, 1), (0, 1), (1, 0)]
    for k, (dx, dy) in enumerate(shifts):
        low = np.roll(truth, (-dy, -dx), axis=(0, 1))[::2, ::2]
        write(str(frames / f"frame_{k}.jp2"), k, low)
    assert cv2.imwrite(str(tmp_path / "truth.jp2"), truth, [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000])
    (tmp_path / "shifts.txt").write_text("".join(f"{dx} {dy}\n" for dx, dy in shifts))
    argv = ["--data_path", str(frames), "--ground_truth_image", str(tmp_path / "truth.jp2"),
            "--motion_sequence_path", str(tmp_path / "shifts.txt"), "--upsampling_scale", "2", "--solver",
            "linear_cg", "--optimization_iterations", "2", "--solver_iterations", "10", "--evaluators", "psnr,ssim"]
    scores = []
    for main, extra in ((j_super_resolve.main, []), (super_resolve.main, ["--device", "cpu", "--dtype", "float64"])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(argv + extra) == 0
        scores.append({line.split(":")[0].strip(): float(line.split(":")[1])
                       for line in out.getvalue().splitlines() if "score on" in line})
    assert set(scores[0]) == set(scores[1]) and len(scores[0]) == 4
    for key in scores[0]:
        assert abs(scores[0][key] - scores[1][key]) <= 1e-6, (key, scores)
    assert os.path.isfile(str(tmp_path / "truth.jp2"))
