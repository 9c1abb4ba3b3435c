"""The rest of JPEG 2000 Part 1 in the port's reader (``utils/jpeg2000.py``
over ``native/jpeg2000_decoder.cpp``), each file array-equal to
``cv2.imread(path, IMREAD_UNCHANGED)`` or refused with ``ValueError`` where
OpenCV returns ``None``: the code-block styles BYPASS, RESET, TERMALL, VSC,
PTERM and SEGSYM alone and together, RGN, POC, PPM and PPT.

The files come from OpenJPEG's own encoder (``tests/torch_openjpeg.py``:
PIL's bundled OpenJPEG 2.5.4 through ctypes, with the options neither
``cv2.imwrite`` nor PIL exposes), PIL's cinema profiles (a POC in a tile-part
header, TLM) and rewrites of OpenJPEG's codestreams: packet headers moved into
PPM / PPT marker segments, a POC or RGN moved between the main and a
tile-part header. The decoder's counts (the ``stats`` of
``decode_jpeg2000``) show that each file reached what it was made for.
"""

import io

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import torch_openjpeg as oj
from super_resolution_tpu_torch import native
from super_resolution_tpu_torch.utils import image_io
from super_resolution_tpu_torch.utils.jpeg2000 import decode_jpeg2000

ALL_STYLES = 63
POC, RGN = 0xFF5F, 0xFF5E


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _built():
    native.get_jpeg2000_library()  # one build for the module


def _smooth(h, w, c, seed):
    """A photograph-like uint8 image (waves, an edge, some noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    planes = [0.5 + 0.35 * np.sin(xx / (4.0 + k)) * np.cos(yy / (5.0 + k)) + 0.2 * (xx > w // 3) for k in range(c)]
    img = np.stack(planes, -1) / 1.3 + rng.normal(0, 0.03, (h, w, c))
    img = np.rint(np.clip(img, 0, 1) * 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _read(tmp_path, data: bytes):
    """(OpenCV's array or None, the port's array or the ValueError it raised, the decoder's counts)."""
    path = str(tmp_path / "image.jp2")
    with open(path, "wb") as f:
        f.write(data)
    theirs = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    stats = {}
    try:
        ours = image_io.read_image(path)
        decode_jpeg2000(data, stats)
    except ValueError as error:
        ours = error
    return theirs, ours, stats


def _like_opencv(tmp_path, data: bytes, refused=False):
    """The port's decode of ``data`` array-equal to OpenCV's, or a ``ValueError`` where OpenCV returns None
    (``refused``: where it must); the decoder's counts."""
    theirs, ours, stats = _read(tmp_path, data)
    if theirs is None:
        assert isinstance(ours, ValueError), "OpenCV refused the file, the port read it"
        return None
    assert not refused, "OpenCV read the file"
    assert not isinstance(ours, Exception), ours
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)
    return stats


# --- code-block styles ---------------------------------------------------------------------------------------

_STYLE_SETS = {**oj.STYLES, "all six": ALL_STYLES,
               "BYPASS+TERMALL": oj.BYPASS | oj.TERMALL, "BYPASS+RESET": oj.BYPASS | oj.RESET,
               "VSC+SEGSYM": oj.VSC | oj.SEGSYM}
# (image, options): grey 5/3 in 64x64 code-blocks, RGB 9/7 in 16x16, RGB 5/3 in 4x8 at 3 resolutions; odd sizes.
_LAYOUTS = ((lambda: _smooth(37, 53, 1, 1), dict()),
            (lambda: _smooth(45, 61, 3, 2), dict(irreversible=True, code_block=(16, 16))),
            (lambda: _smooth(23, 29, 3, 3), dict(code_block=(4, 8), resolutions=3)))


@pytest.mark.parametrize("lossy", [False, True], ids=["lossless", "lossy 3 layers"])
@pytest.mark.parametrize("styles", list(_STYLE_SETS))
def test_code_block_styles(tmp_path, styles, lossy):
    mode = _STYLE_SETS[styles]
    for make, options in _LAYOUTS:
        data = oj.encode(make(), mode=mode, rates=(40, 10, 4) if lossy else (), **options)
        stats = _like_opencv(tmp_path, data, refused=False)
        assert stats["code_blocks"] > 0
        if mode & oj.TERMALL:  # every pass its own codeword segment
            assert stats["segments"] == stats["passes"]
        if mode & oj.BYPASS and options.get("code_block", (64, 64))[0] >= 16:
            assert stats["raw_passes"] > 0
        if not mode & (oj.BYPASS | oj.TERMALL):
            assert stats["raw_passes"] == 0 and stats["segments"] <= stats["code_blocks"] * 3
    if lossy:
        assert stats["truncated_blocks"] > 0


def test_bypass_segments_continue_across_layers(tmp_path):
    """Five layers cut the 10-, 2- and 1-pass segments of BYPASS anywhere: a segment continued in the next layer
    is one codeword; under TERMALL every pass is its own."""
    image = _smooth(40, 48, 3, 4)
    for mode in (oj.BYPASS, oj.BYPASS | oj.TERMALL, oj.BYPASS | oj.PTERM, ALL_STYLES):
        stats = _like_opencv(tmp_path, oj.encode(image, mode=mode, rates=(80, 40, 20, 10, 5), code_block=(8, 8)))
        assert stats["layers"] == 5 and stats["raw_passes"] > 0


# --- RGN -----------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("shift", [1, 7, 26])
@pytest.mark.parametrize("component", [0, 2])
@pytest.mark.parametrize("where", ["main", "tile-part"])
def test_region_of_interest(tmp_path, shift, component, where):
    """RGN's shift adds to each code-block's bit-planes and scales the region back down after tier-1; past 30
    bit-planes OpenJPEG fails the decode (a shift of 26 does on this image) and OpenCV returns None."""
    data = oj.encode(_smooth(37, 45, 3, 5), roi=(component, shift), rates=(20, 5))
    assert RGN in oj.main_markers(data)
    if where == "tile-part":
        data = oj.move_to_tile_header(data, RGN)
        assert RGN not in oj.main_markers(data)
    stats = _like_opencv(tmp_path, data, refused=shift == 26)
    if stats is not None:
        assert stats["roi_components"] == 1


@pytest.mark.parametrize("shift,mode", [(1, oj.BYPASS), (7, oj.BYPASS), (7, ALL_STYLES), (12, oj.BYPASS | oj.VSC)])
def test_region_of_interest_with_bypass(tmp_path, shift, mode):
    """OpenJPEG's bypass test counts a code-block's bit-planes without the RGN shift: raw passes start
    ``shift`` bit-planes later than the segments say."""
    stats = _like_opencv(tmp_path, oj.encode(_smooth(41, 47, 3, 6), roi=(0, shift), mode=mode, rates=(30, 8)))
    assert stats is None or stats["roi_components"] == 1


# --- POC -----------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("progression", list(oj.PROGRESSIONS))
def test_poc_one_entry_each_progression(tmp_path, progression):
    image = _smooth(45, 61, 3, 7)
    data = oj.encode(image, rates=(30, 10, 4), pocs=((0, 0, 3, 6, 3, progression, 1),))
    stats = _like_opencv(tmp_path, data)
    assert stats["poc_entries"] == 1 and stats["layers"] == 3


@pytest.mark.parametrize("pocs", [
    ((0, 0, 3, 3, 3, "LRCP", 1), (0, 0, 3, 6, 3, "RPCL", 1)),
    ((2, 1, 2, 5, 3, "CPRL", 1), (0, 0, 3, 6, 3, "PCRL", 1)),
    ((0, 0, 1, 6, 3, "CPRL", 1), (0, 0, 2, 6, 3, "RLCP", 1), (0, 0, 3, 6, 3, "PCRL", 1)),
    ((1, 0, 3, 4, 2, "RLCP", 1), (0, 2, 2, 6, 3, "LRCP", 1), (0, 0, 3, 6, 3, "RPCL", 1))],
    ids=["res then all", "overlapping comps", "layer ranges", "three overlapping"])
def test_poc_several_entries(tmp_path, pocs):
    """Overlapping ranges (each packet read once, at its first entry), layer ranges from 0 each time."""
    data = oj.encode(_smooth(45, 61, 3, 8), rates=(30, 10, 4), pocs=pocs)
    stats = _like_opencv(tmp_path, data)
    assert stats["poc_entries"] == len(pocs)


@pytest.mark.parametrize("channels,poc,refused", [
    (1, (0, 0, 2, 4, 1, "RLCP", 1), False), (3, (0, 0, 2, 4, 3, "LRCP", 1), False),
    (3, (0, 0, 2, 4, 1, "RLCP", 1), True)], ids=["grey, resolutions 0-3", "RGB, resolutions 0-3", "RGB, component 0"])
def test_poc_leaving_packets_unread(tmp_path, channels, poc, refused):
    """A POC that leaves packets out: OpenJPEG writes only those it names, and synthesises each component up to
    the highest resolution read (a smaller picture in the top left, zeros around it); the colour transform over
    components synthesised to different resolutions fails the decode, and OpenCV returns None."""
    stats = _like_opencv(tmp_path, oj.encode(_smooth(40, 56, channels, 9), rates=(20, 5), pocs=(poc,)),
                         refused=refused)
    assert stats is None or stats["poc_entries"] == 1


@pytest.mark.parametrize("where", ["tile-part", "main"])
def test_poc_in_either_header(tmp_path, where):
    """OpenJPEG writes POC into the first tile-part header; moved to the main header it reads the same."""
    data = oj.encode(_smooth(44, 52, 3, 10), rates=(25, 6), pocs=((0, 0, 2, 2, 3, "PCRL", 1), (0, 0, 2, 6, 3, "CPRL", 1)))
    assert POC in oj.tile_part_markers(data)[0][2]
    if where == "main":
        data = oj.move_to_main_header(data, POC)
        assert POC in oj.main_markers(data)
    assert _like_opencv(tmp_path, data)["poc_entries"] == 2


@pytest.mark.parametrize("pocs", [((0, 0, 2, 3, 3, "LRCP", 1), (3, 0, 2, 6, 3, "RPCL", 1)),
                                  ((0, 0, 2, 2, 3, "PCRL", 1), (2, 0, 2, 4, 3, "LRCP", 1), (4, 0, 2, 6, 3, "CPRL", 1))],
                         ids=["two", "three"])
def test_poc_in_main_and_tile_part_headers(tmp_path, pocs):
    """The first entry in the main header, the others in the tile-part header: OpenJPEG appends the tile's
    entries to the main header's, so the file reads as the one with all of them in the tile-part header."""
    source = oj.encode(_smooth(40, 48, 3, 11), rates=(25, 6), pocs=pocs)
    data = oj.split_poc(source)
    assert POC in oj.main_markers(data) and POC in oj.tile_part_markers(data)[0][2]
    assert _like_opencv(tmp_path, data)["poc_entries"] == len(pocs)
    np.testing.assert_array_equal(decode_jpeg2000(data), decode_jpeg2000(source))


@pytest.mark.parametrize("tiles_pocs", [
    ((0, 0, 2, 3, 3, "RLCP", 1), (0, 0, 2, 6, 3, "LRCP", 1)),
    ((0, 0, 2, 6, 3, "CPRL", 1), (0, 0, 2, 6, 3, "RPCL", 2), (0, 0, 2, 6, 3, "PCRL", 3)),
    ((0, 0, 2, 2, 3, "LRCP", 2),)],
    ids=["first tile", "three tiles", "second tile below full resolution"])
def test_poc_several_tiles(tmp_path, tiles_pocs):
    """Each tile is synthesised up to the highest resolution its own packets reached."""
    data = oj.encode(_smooth(50, 60, 3, 12), rates=(25, 6), pocs=tiles_pocs, tiles=(32, 32))
    stats = _like_opencv(tmp_path, data)
    assert stats["tiles"] == 4 and stats["poc_entries"] > 0


@pytest.mark.parametrize("profile,size", [("cinema2k-24", (48, 64)), ("cinema4k-24", (48, 64)),
                                          ("cinema4k-24", (117, 131)), ("cinema2k-48", (61, 77))])
def test_pil_cinema_profiles(tmp_path, profile, size):
    """PIL's digital cinema profiles: 9/7, CPRL, TLM, tile-parts by component; the 4K profile's POC in a
    tile-part header."""
    out = io.BytesIO()
    Image.fromarray(_smooth(*size, 3, 13)).save(out, "JPEG2000", cinema_mode=profile)
    stats = _like_opencv(tmp_path, out.getvalue())
    assert stats["poc_entries"] == (2 if profile.startswith("cinema4k") else 0)


# --- PPM and PPT ---------------------------------------------------------------------------------------------

_PACKED_LAYOUTS = {
    "one tile": dict(),
    "four tiles": dict(tiles=(32, 32)),
    "tile-parts": dict(tile_parts="R"),
    "tiles and tile-parts": dict(tiles=(32, 24), tile_parts="L", resolutions=4),
}


@pytest.mark.parametrize("split", [1, 3])
@pytest.mark.parametrize("layout", list(_PACKED_LAYOUTS))
@pytest.mark.parametrize("kind", ["ppm", "ppt"])
def test_packed_packet_headers(tmp_path, kind, layout, split):
    """Packet headers out of the tile-parts into PPM (one Nppm a tile-part, cut over ``split`` segments) or PPT
    (each tile-part's over ``split`` segments); the same pixels as the file they came from."""
    options = dict(rates=(20, 5), **_PACKED_LAYOUTS[layout])
    source = oj.encode(_smooth(45, 61, 3, 14), sop_eph=True, **options)
    packed = oj.pack_headers(source, kind, split=split)
    stats = _like_opencv(tmp_path, packed)
    assert stats["packed_header_bytes"] > 0 and stats["sop_markers"] == stats["packets"] == stats["eph_markers"]
    np.testing.assert_array_equal(decode_jpeg2000(packed), decode_jpeg2000(source))


@pytest.mark.parametrize("kind", ["ppm", "ppt"])
def test_packed_headers_with_every_style(tmp_path, kind):
    source = oj.encode(_smooth(40, 44, 1, 15), sop_eph=True, mode=ALL_STYLES, rates=(30, 10, 4), tiles=(24, 24),
                       resolutions=4)
    _like_opencv(tmp_path, oj.pack_headers(source, kind, split=2))


@pytest.mark.parametrize("kind", ["ppm", "ppt"])
def test_packed_segments_out_of_order(tmp_path, kind):
    """The segments written in the reverse of their Z order: both readers merge them by Z."""
    source = oj.encode(_smooth(45, 61, 3, 16), sop_eph=True, rates=(20, 5), tiles=(32, 32))
    stats = _like_opencv(tmp_path, oj.pack_headers(source, kind, split=3, reverse=True))
    assert stats["packed_header_bytes"] > 0


def test_ppm_with_ppt_is_refused_as_opencv_refuses_it(tmp_path):
    source = oj.encode(_smooth(30, 40, 3, 17), sop_eph=True, rates=(20, 5), resolutions=4)
    data = oj.add_to_tile_header(oj.pack_headers(source, "ppm"), bytes.fromhex("ff610004" "00" "80"))
    _like_opencv(tmp_path, data, refused=True)


def test_ppm_z_read_twice_is_refused_as_opencv_refuses_it(tmp_path):
    source = oj.encode(_smooth(30, 40, 3, 18), sop_eph=True, rates=(20, 5), resolutions=4)
    packed = oj.pack_headers(source, "ppm", split=2)
    at = packed.index(b"\xff\x60")
    (length,) = np.frombuffer(packed[at + 2:at + 4], ">u2")
    second = at + 2 + int(length)
    assert packed[second:second + 2] == b"\xff\x60"
    data = packed[:second + 4] + b"\x00" + packed[second + 5:]  # the second segment's Z set to the first's
    _like_opencv(tmp_path, data, refused=True)


def _drop_first_eph(main, parts):
    at = parts[0].body.index(b"\xff\x92")
    parts[0].body = parts[0].body[:at] + parts[0].body[at + 2:]
    return main


def _poc_before_cod(main, parts):
    """The first tile-part header's POC moved into the main header, right after SIZ."""
    header = parts[0].header
    segments, _, _ = oj._segments(header + b"\xff\x93", 0, {0xFF93})
    _, a, b = next(s for s in segments if s[0] == POC)
    parts[0].header = header[:a] + header[b:]
    (siz_length,) = np.frombuffer(main[4:6], ">u2")
    siz_end = 4 + int(siz_length)
    return main[:siz_end] + header[a:b] + main[siz_end:]


def _empty_second_tile(tnsot):
    def edit(main, parts):
        parts[1].body, parts[1].tnsot = b"", tnsot
        return main
    return edit


# (encode's options, the edit, OpenCV refuses the file).
_EDITS = {
    "EPH missing": (dict(sop_eph=True), _drop_first_eph, True),
    # OpenJPEG clamps LYEpoc to the layers known when POC is read: none before COD, so no packet is read.
    "POC before COD": (dict(pocs=((0, 0, 2, 3, 1, "LRCP", 1), (3, 0, 2, 6, 1, "RPCL", 1))), _poc_before_cod, False),
    "a finished tile without data": (dict(tiles=(32, 45)), _empty_second_tile(1), True),
    "an unfinished tile without data": (dict(tiles=(32, 45)), _empty_second_tile(0), False),
}


@pytest.mark.parametrize("edit", list(_EDITS))
def test_codestream_edits_read_as_opencv_reads_them(tmp_path, edit):
    """Where OpenJPEG departs from a plain reading of the standard: a packet header without the EPH marker COD
    asks for fails the decode; a POC read before COD reads no packet; a tile whose last tile-part (by TNsot)
    holds no data fails the decode, one never finished is passed over and left zero."""
    options, fn, refused = _EDITS[edit]
    data = oj.rewrite(oj.encode(_smooth(45, 61, 1, 19), rates=(20, 5), **options), fn)
    stats = _like_opencv(tmp_path, data, refused=refused)
    if edit == "POC before COD":
        assert stats["packets"] == 0
