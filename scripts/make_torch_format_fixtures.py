#!/usr/bin/env python3
"""Write the image-format fixtures of the port's codecs into tests/data_torch/formats/.

    python3 scripts/make_torch_format_fixtures.py

Needs OpenCV (``cv2``), which writes most files and decodes every one of
them as the reference; the layouts OpenCV cannot write (tiles, planar
samples, big-endian, the floating-point predictor, an interlaced and
transparent GIF on a larger screen) are built by hand by
``tests/torch_format_builders.py``; one lossless WebP comes from PIL's
libwebp at its highest effort, 6 (OpenCV writes at its default). The
JPEG 2000 files come from OpenCV (OpenJPEG at its default rate: 5/3, passes
cut by the rate control), PIL (OpenJPEG with its options: 9/7 with the colour
transform, layers, progressions, precincts, tiles, RGBA, 16 bits, a raw
codestream), FFmpeg's own ``jpeg2000`` encoder (SOP / EPH markers, through
``tests/torch_libav.py``) and a palette file wrapped in JP2 boxes by hand;
among them the inputs of ``chip_smoke.py`` phase 14 (c-4) -- the flagship
scene of (c-1), ``synthetic_scene(1, 1000, 1000, seed=2026)``, as
``cv2.imwrite`` writes it -- and (c-5) -- the 4 RGB LR frames of phase 11
(d)'s scene, made here on the CPU by ``chip_smoke.estimated_motion_problem``,
as PIL writes them -- and the files of the rest of Part 1 from OpenJPEG
2.5.4's own encoder (PIL's bundled library through ``tests/torch_openjpeg.py``):
the six code-block styles, RGN, POC in both headers, PPM and PPT (packet
headers moved out of the tile-parts), PIL's cinema profile; among them the
inputs of phase 14 (c-7), phase 11 (d)'s 4 frames with those features; and
the TIFF layouts OpenCV reads through libtiff's RGBA interface, GDAL's
JPEG-compressed GeoTIFFs among them (``tests/torch_gdal.py``, GDAL 3.6's
``libgdal.so.32`` through ctypes): phase 14 (c-8)'s inputs, the same 4 frames
and their 1000x1000 scene as tiled 4:2:0 YCbCr. Each
input file comes with OpenCV's decode of it: a PNG for uint8 images (the port's PNG reader is exact), a
``.npy`` otherwise; (c-7)'s four 250x250 frames with the SHA-256 of OpenCV's
array instead (``expected_sha256``: their four PNGs would be ~540 kB), as
(c-8)'s five files, which
``chip_smoke.py`` and the tests hold the port's decode to. The encoding fixtures are OpenCV's JPEG, TIFF and JPEG
2000 files of images drawn from ``numpy.random.PCG64(seed).random_raw``,
whose stream numpy keeps stable. ``manifest.json`` lists it all, with the
SHA-256 of the flagship scene's uint8 pixels (phase 14 (c-6a) regenerates
the scene and encodes it with the port's writer); the tests
(``tests/test_torch_formats_fixtures.py``) and ``chip_smoke.py`` phase 14
read it. Not run by the tests: rerun it only when the set changes.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys

import cv2
import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, ROOT)
from torch_format_builders import gif_bytes, tiff_bytes  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data_torch", "formats")


def seeded_image(seed: int, shape) -> np.ndarray:
    """uint8 samples from the raw PCG64 stream (stable across numpy versions)."""
    raw = np.random.PCG64(seed).random_raw(int(np.prod(shape)))
    return (raw >> np.uint64(56)).astype(np.uint8).reshape(shape)


def scene(h, w, c, seed):
    """A smooth texture with edges and noise, uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.stack([128 + 80 * np.sin(xx / (4.0 + k)) * np.cos(yy / 6.0) + 30 * np.sin((xx + yy) / 3.0)
                    for k in range(c)], axis=-1)
    img[h // 4: h // 2, w // 3: 2 * w // 3] += 60
    img = np.clip(np.rint(img + rng.normal(0, 10, img.shape)), 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _pil_jpeg2000(rgb_or_grey, mode=None, **options) -> bytes:
    out = io.BytesIO()
    image = Image.fromarray(rgb_or_grey, mode) if mode else Image.fromarray(rgb_or_grey)
    image.save(out, "JPEG2000", **options)
    return out.getvalue()


def _jp2_box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def _palette_jp2(indices: np.ndarray, palette: np.ndarray) -> bytes:
    """A JP2 file by hand: PIL's codestream of the 8-bit indices, a pclr box of ``palette`` (NE x 3, 8 bits) and
    a cmap box mapping the one component through its three columns."""
    codestream = _pil_jpeg2000(indices, no_jp2=True)
    h, w = indices.shape
    header = _jp2_box(b"ihdr", struct.pack(">IIHBBBB", h, w, 3, 7, 7, 0, 0))
    header += _jp2_box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", 16))
    header += _jp2_box(b"pclr", struct.pack(">HB", len(palette), 3) + bytes([7, 7, 7])
                       + palette.astype(np.uint8).tobytes())
    header += _jp2_box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i) for i in range(3)))
    return (_jp2_box(b"jP  ", b"\r\n\x87\n") + _jp2_box(b"ftyp", b"jp2 \0\0\0\0jp2 ") + _jp2_box(b"jp2h", header)
            + _jp2_box(b"jp2c", codestream))


def add_jpeg2000(add) -> str:
    """The JPEG 2000 fixtures (see the module docstring)."""
    import torch

    import chip_smoke
    import torch_libav
    from super_resolution_tpu_torch.image import ImageData

    add("opencv_default_rate_grey_37x53.jp2", cv2.imencode(".jp2", scene(37, 53, 1, 19))[1].tobytes(),
        "JPEG 2000 by OpenCV at its default rate: 5/3, one layer, LRCP, passes cut by the rate control")
    add("tiles_17x13_97_ict_layers_61x77.jp2",
        _pil_jpeg2000(scene(61, 77, 3, 20)[..., ::-1], irreversible=True, mct=1, tile_size=(17, 13),
                      quality_layers=[30, 10], progression="CPRL"),
        "JPEG 2000 by PIL: 9/7 with the ICT, 2 layers, CPRL, 17x13 tiles (tile-components at odd offsets)")
    rgba = np.dstack([scene(37, 53, 3, 21)[..., ::-1], scene(37, 53, 1, 22)])
    add("rgba_37x53.jp2", _pil_jpeg2000(rgba, quality_layers=[20], progression="RLCP"),
        "JPEG 2000 by PIL: RGBA (4 components, BGRA in OpenCV), 5/3 cut to one rate-limited layer, RLCP")
    deep = (scene(33, 45, 1, 23).astype(np.uint16) * 257) ^ np.uint16(0x1234)
    add("grey16_33x45.jp2", _pil_jpeg2000(deep, "I;16", irreversible=True, quality_layers=[8, 2]),
        "JPEG 2000 by PIL: 16-bit grey (uint16 in OpenCV), 9/7, 2 layers")
    add("raw_codestream_37x53.jp2",
        _pil_jpeg2000(scene(37, 53, 3, 24)[..., ::-1], no_jp2=True, precinct_size=(16, 16), codeblock_size=(8, 8),
                      progression="PCRL", num_resolutions=4),
        "JPEG 2000 by PIL: a raw codestream (FF4F FF51) under .jp2, 16x16 precincts, 8x8 code-blocks, PCRL")
    grey = scene(37, 45, 1, 25)
    (payload,), _ = torch_libav.encode("jpeg2000", [[grey]], "gray", 45, 37,
                                       {"sop": "1", "eph": "1", "prog": "rlcp", "tile_width": "32",
                                        "tile_height": "16", "layer_rates": "40,10"})
    add("ffmpeg_sop_eph_rlcp_tiles_37x45.jp2", payload,
        "JPEG 2000 by FFmpeg's jpeg2000 encoder: SOP and EPH markers, RLCP, 32x16 tiles, 2 layers, integer 9/7")
    add("palette_29x41.jp2", _palette_jp2((scene(29, 41, 1, 26) // 8).astype(np.uint8), seeded_image(27, (32, 3))),
        "JPEG 2000 by hand: pclr + cmap boxes around PIL's codestream of 8-bit indices (OpenCV: grey of the colours)")

    # chip_smoke.py phase 14 (c-4): the flagship scene as the port saves it, written by cv2.imwrite.
    flagship = ImageData(chip_smoke.synthetic_scene(1, 1000, 1000, seed=2026), channel_major=True, device="cpu")
    pixels = flagship.visualization_image()
    add("flagship_scene_1000x1000.jp2", cv2.imencode(".jp2", pixels)[1].tobytes(),
        "JPEG 2000 by OpenCV at its default rate: the flagship scene, 1000x1000 grey (chip_smoke phase 14 (c-4))")
    # (c-5): the 4 RGB LR frames of phase 11 (d), written by PIL: 9/7 with the ICT, 3 layers, RPCL, 64x64 precincts.
    _, lows = chip_smoke.estimated_motion_problem("cpu", side=1000, dtype=torch.float32)
    for k, low in enumerate(lows):
        bgr = ImageData(low, normalize="never", channel_major=True).visualization_image()
        add(f"rgb_lr_frame_{k}_250x250.jp2",
            _pil_jpeg2000(np.ascontiguousarray(bgr[..., ::-1]), irreversible=True, mct=1, quality_mode="rates",
                          quality_layers=[16, 8, 4], progression="RPCL", precinct_size=(64, 64)),
            f"JPEG 2000 by PIL: LR frame {k} of phase 11 (d)'s RGB scene, 9/7 with the ICT, 3 layers, RPCL, 64x64 "
            "precincts (chip_smoke phase 14 (c-5))")
    add_openjpeg_features(add, lows)
    # (c-6a) regenerates the flagship scene on the card's host and checks it against this digest first.
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


def add_openjpeg_features(add, lows) -> None:
    """The rest of Part 1 as OpenJPEG 2.5.4's encoder writes it (see the module docstring); ``lows``: phase 11
    (d)'s 4 RGB LR frames, for (c-7)."""
    import torch_openjpeg as oj

    from super_resolution_tpu_torch.image import ImageData

    rgb, grey = scene(37, 53, 3, 30), scene(45, 61, 1, 31)
    add("openjpeg_all_styles_lossy_37x53.jp2", oj.encode(rgb, mode=63, rates=(40, 10, 4)),
        "JPEG 2000 by OpenJPEG 2.5.4: the six code-block styles together (BYPASS, RESET, TERMALL, VSC, PTERM, "
        "SEGSYM), 3 layers (rates 40 / 10 / 4), 5/3 with the RCT")
    add("openjpeg_rgn_component0_37x53.jp2", oj.encode(rgb, roi=(0, 7), rates=(20, 5)),
        "JPEG 2000 by OpenJPEG 2.5.4: RGN on component 0, shift 7, in the main header; 2 layers")
    add("openjpeg_poc_main_and_tile_part_37x53.jp2",
        oj.split_poc(oj.encode(rgb, rates=(20, 5), pocs=((0, 0, 2, 3, 3, "LRCP", 1), (3, 0, 2, 6, 3, "RPCL", 1)))),
        "JPEG 2000 by OpenJPEG 2.5.4: two POC entries (resolutions 0-2 LRCP, 3-5 RPCL), the first moved into the "
        "main header, the second in the tile-part header; 2 layers")
    add("openjpeg_ppm_two_tiles_45x61.jp2",
        oj.pack_headers(oj.encode(grey, rates=(20, 5), tiles=(32, 45), sop_eph=True, resolutions=4), "ppm"),
        "JPEG 2000 by OpenJPEG 2.5.4 with SOP / EPH, its packet headers moved into a PPM segment: two 32x45 tiles, "
        "2 layers")
    add("openjpeg_ppt_split_45x61.jp2",
        oj.pack_headers(oj.encode(grey, rates=(20, 5), mode=oj.BYPASS, sop_eph=True, tile_parts="R"), "ppt", split=2),
        "JPEG 2000 by OpenJPEG 2.5.4 with SOP / EPH, BYPASS, a tile-part a resolution, each tile-part's packet "
        "headers moved into two PPT segments")
    out = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(scene(48, 64, 3, 32)[..., ::-1])).save(out, "JPEG2000",
                                                                                 cinema_mode="cinema4k-24")
    add("pil_cinema4k_48x64.jp2", out.getvalue(),
        "JPEG 2000 by PIL (OpenJPEG 2.5.4): the cinema4k-24 profile, a POC in the tile-part header, TLM, 9/7, CPRL")
    # (c-7): phase 11 (d)'s frames with every feature group, lossy, 3 layers; frame 3 PIL's cinema profile.
    bgr = [np.ascontiguousarray(ImageData(low, normalize="never", channel_major=True).visualization_image())
           for low in lows]
    rates = (48, 24, 10)
    frames = [
        (oj.pack_headers(oj.encode(bgr[0], mode=oj.BYPASS | oj.RESET | oj.TERMALL, rates=rates, roi=(0, 7),
                                   sop_eph=True), "ppm"),
         "BYPASS, RESET and TERMALL, RGN on component 0 (shift 7), the packet headers in PPM"),
        (oj.pack_headers(oj.encode(bgr[1], mode=oj.VSC | oj.PTERM | oj.SEGSYM, rates=rates, sop_eph=True), "ppt",
                         split=2),
         "VSC, PTERM and SEGSYM, the packet headers in two PPT segments"),
        (oj.encode(bgr[2], mode=63, rates=rates, pocs=((0, 0, 3, 3, 3, "LRCP", 1), (3, 0, 3, 6, 3, "RPCL", 1))),
         "the six code-block styles, two POC entries (resolutions 0-2 LRCP, 3-5 RPCL) in the tile-part header")]
    for k, (data, what) in enumerate(frames):
        add(f"rgb_lr_frame_{k}_features_250x250.jp2", data,
            f"JPEG 2000 by OpenJPEG 2.5.4: LR frame {k} of phase 11 (d)'s RGB scene, 5/3 with the RCT, 3 layers "
            f"(rates 48 / 24 / 10), {what} (chip_smoke phase 14 (c-7))", digest_only=True)
    out = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(bgr[3][..., ::-1])).save(out, "JPEG2000", cinema_mode="cinema4k-24",
                                                                 quality_mode="dB", quality_layers=[45])
    add("rgb_lr_frame_3_features_250x250.jp2", out.getvalue(),
        "JPEG 2000 by PIL (OpenJPEG 2.5.4): LR frame 3 of phase 11 (d)'s RGB scene, the cinema4k-24 profile (its "
        "POC, TLM, 9/7, CPRL), one layer at 45 dB (chip_smoke phase 14 (c-7))", digest_only=True)


def add_tiff_rgba(add) -> None:
    """The TIFF layouts OpenCV reads through libtiff's RGBA interface: GDAL's
    JPEG-compressed GeoTIFFs (``tests/torch_gdal.py``) -- chip_smoke phase 14
    (c-8)'s 4 RGB LR frames of phase 11 (d) as tiled 4:2:0 YCbCr (128 px
    tiles, quality 75) and the scene's 1000x1000 truth the same way in 256 px
    tiles (edge tiles cropped), kept as the SHA-256 of OpenCV's arrays --, an
    RGB JPEG file in strips and a bilevel file, and hand-built palette and
    YCbCr-in-data-units files."""
    import torch
    import torch_gdal

    import chip_smoke
    from super_resolution_tpu_torch.image import ImageData
    from torch_format_builders import packed_tiff_bytes, ycbcr_tiff_bytes

    def rgb(x):  # the port's BGR uint8 of a channel-major tensor, as R, G, B for GDAL
        bgr = ImageData(x, normalize="never", channel_major=True).visualization_image()
        return np.ascontiguousarray(bgr[..., ::-1])

    ycbcr = dict(COMPRESS="JPEG", PHOTOMETRIC="YCBCR", TILED="YES", JPEG_QUALITY=75)
    gt, lows = chip_smoke.estimated_motion_problem("cpu", side=1000, dtype=torch.float32)
    for k, low in enumerate(lows):
        add(f"rgb_lr_frame_{k}_gdal_jpeg_ycbcr_250x250.tif",
            torch_gdal.write(rgb(low), BLOCKXSIZE=128, BLOCKYSIZE=128, **ycbcr),
            f"JPEG-compressed GeoTIFF by GDAL: LR frame {k} of phase 11 (d)'s RGB scene, tiled 4:2:0 YCbCr (128 px "
            "tiles, JPEGTables, quality 75) (chip_smoke phase 14 (c-8))", digest_only=True)
    add("rgb_truth_gdal_jpeg_ycbcr_1000x1000.tif", torch_gdal.write(rgb(gt), BLOCKXSIZE=256, BLOCKYSIZE=256, **ycbcr),
        "JPEG-compressed GeoTIFF by GDAL: phase 11 (d)'s 1000x1000 RGB scene, tiled 4:2:0 YCbCr (256 px tiles, the "
        "last row and column cropped from full frames, quality 75) (chip_smoke phase 14 (c-8))", digest_only=True)
    add("gdal_jpeg_rgb_strips_37x53.tif", torch_gdal.write(scene(37, 53, 3, 40), COMPRESS="JPEG",
                                                           BLOCKYSIZE=8),
        "JPEG-compressed TIFF by GDAL: photometric RGB (no colour transform), strips of 8 rows with JPEGTables")
    add("gdal_bilevel_packbits_37x53.tif", torch_gdal.write((scene(37, 53, 1, 41) > 127).astype(np.uint8), NBITS=1,
                                                            COMPRESS="PACKBITS"),
        "TIFF by GDAL: bilevel (NBITS=1, min-is-black), PackBits, odd width")
    colormap = seeded_image(42, (3, 16)).astype(np.int64) * 257
    add("palette_4bit_16bit_map_37x53.tif",
        packed_tiff_bytes(scene(37, 53, 1, 43) // 16, 4, photometric=3, colormap=colormap, compression=5,
                          tile=(16, 16)),
        "TIFF by hand: 4-bit palette, a 16-bit ColorMap, LZW, 16x16 tiles")
    reference = [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)]
    add("ycbcr_2x2_units_37x53.tif",
        ycbcr_tiff_bytes(scene(37, 53, 3, 44), subsampling=(2, 2), rows_per_strip=8, extra_tags=[(532, 5, reference)]),
        "TIFF by hand: uncompressed YCbCr in 2x2 data units, video-range ReferenceBlackWhite, strips of 8 rows")


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    decode, encode = [], []

    def add(name, data, what, digest_only=False):
        path = os.path.join(OUT, name)
        with open(path, "wb") as f:
            f.write(data)
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert ref is not None, name
        stem = os.path.splitext(name)[0]
        if digest_only:
            decode.append({"file": name, "expected_sha256": hashlib.sha256(np.ascontiguousarray(ref).tobytes())
                           .hexdigest(), "what": what, "dtype": str(ref.dtype), "shape": list(ref.shape)})
            return
        if ref.dtype == np.uint8:
            expected = stem + ".decoded.png"
            assert cv2.imwrite(os.path.join(OUT, expected), ref)
        else:
            expected = stem + ".decoded.npy"
            np.save(os.path.join(OUT, expected), ref)
        decode.append({"file": name, "expected": expected, "what": what,
                       "dtype": str(ref.dtype), "shape": list(ref.shape)})

    progressive = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2, cv2.IMWRITE_JPEG_QUALITY, 85]
    add("progressive_grey_restarts_37x53.jpg", cv2.imencode(".jpg", scene(37, 53, 1, 1), progressive)[1].tobytes(),
        "progressive JPEG, grey, restart interval 2, odd size")
    add("progressive_420_restarts_37x53.jpg",
        cv2.imencode(".jpg", scene(37, 53, 3, 2), progressive + [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])[1].tobytes(),
        "progressive JPEG, 4:2:0 colour, restart interval 2, odd size")
    add("lzw_predictor2_bgr_37x53.tif", cv2.imencode(".tif", scene(37, 53, 3, 3))[1].tobytes(),
        "TIFF by OpenCV: LZW, predictor 2, uint8 BGR")
    deep = (scene(40, 50, 1, 4).astype(np.uint16) * 257) ^ np.uint16(0x5A5A)
    add("tiled_deflate_uint16_bigendian_40x50.tif", tiff_bytes(deep, byte_order=">", compression=8, tile=(16, 32),
                                                                predictor=2),
        "TIFF by hand: 16x32 tiles, Deflate, predictor 2, uint16, big-endian (MM)")
    add("packbits_grey_37x53.tif",
        cv2.imencode(".tif", scene(37, 53, 1, 5), [cv2.IMWRITE_TIFF_COMPRESSION, 32773])[1].tobytes(),
        "TIFF by OpenCV: PackBits, uint8 grey")
    wide = scene(23, 31, 3, 6).astype(np.float32) / np.float32(255) - np.float32(0.25)
    add("float32_predictor3_23x31.tif", tiff_bytes(wide, compression=5, predictor=3, rows_per_strip=8),
        "TIFF by hand: LZW, floating-point predictor 3, float32 RGB, 3 strips")
    add("planar_rgb_37x53.tif", tiff_bytes(scene(37, 53, 3, 7), planar=True, compression=32946, rows_per_strip=16),
        "TIFF by hand: planar (PlanarConfiguration 2) uint8 RGB, Deflate (32946), 3 strips a plane")
    palette = seeded_image(8, (32, 3))
    indices = (scene(29, 41, 1, 9) // 8).astype(np.uint8)
    add("interlaced_transparent_29x41.gif",
        gif_bytes(indices, palette, screen=(47, 33), origin=(3, 2), interlaced=True, transparent=5, background=7),
        "GIF by hand: interlaced frame at (3, 2) on a 47x33 screen, global table of 32, transparent index 5")
    colours = seeded_image(13, (11, 3))
    add("vp8l_palette_29x41.webp", cv2.imencode(".webp", colours[scene(29, 41, 1, 14) % 11])[1].tobytes(),
        "WebP by OpenCV: lossless (VP8L), 11 colours (colour indexing, 2 pixels a byte)")
    bgra = np.dstack([scene(37, 53, 3, 15), scene(37, 53, 1, 16)])
    add("vp8l_alpha_37x53.webp", cv2.imencode(".webp", bgra)[1].tobytes(),
        "WebP by OpenCV: lossless (VP8L) BGRA, odd size")
    add("vp8_q50_37x53.webp", cv2.imencode(".webp", scene(37, 53, 3, 17), [cv2.IMWRITE_WEBP_QUALITY, 50])[1].tobytes(),
        "WebP by OpenCV: lossy (VP8) quality 50, odd size")
    add("vp8_alpha_q70_37x53.webp", cv2.imencode(".webp", bgra, [cv2.IMWRITE_WEBP_QUALITY, 70])[1].tobytes(),
        "WebP by OpenCV: lossy (VP8) quality 70 with an ALPH chunk (VP8X), odd size")
    effort6 = io.BytesIO()
    Image.fromarray(scene(48, 64, 3, 18)[..., ::-1]).save(effort6, "WEBP", lossless=True, method=6)
    add("vp8l_effort6_48x64.webp", effort6.getvalue(),
        "WebP by PIL: lossless (VP8L) at its highest effort, 6")

    flagship_sha256 = add_jpeg2000(add)
    add_tiff_rgba(add)

    # What cv2.imwrite writes of seeded images: JPEG, TIFF and JPEG 2000 (5/3, one layer cut to OpenCV's
    # default rate); the 32x32 grey (the smallest JPEG 2000 OpenCV writes) and the 256x256 BGR (the rate
    # allocation over 75 code-blocks) only as JPEG 2000.
    for seed, shape, exts in ((11, (48, 64, 3), (".jpg", ".tif", ".jp2")), (12, (37, 53), (".jpg", ".tif", ".jp2")),
                              (28, (32, 32), (".jp2",)), (29, (256, 256, 3), (".jp2",))):
        image = seeded_image(seed, shape)
        stem = f"encode_seed{seed}_{'x'.join(map(str, shape))}"
        entry = {"seed": seed, "shape": list(shape)}
        for ext in exts:
            with open(os.path.join(OUT, stem + ext), "wb") as f:
                f.write(cv2.imencode(ext, image)[1].tobytes())
            entry[{".jpg": "jpeg", ".tif": "tiff", ".jp2": "jp2"}[ext]] = stem + ext
        encode.append(entry)

    manifest = {"made_by": "scripts/make_torch_format_fixtures.py with OpenCV " + cv2.__version__,
                "decode": decode, "encode": encode,
                "flagship_scene": {"file": "flagship_scene_1000x1000.jp2", "shape": [1000, 1000],
                                   "pixels_sha256": flagship_sha256}}
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"wrote {len(os.listdir(OUT))} files, {total} bytes, into {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
