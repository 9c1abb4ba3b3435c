#!/usr/bin/env python3
"""Write the image-format fixtures of the port's codecs into tests/data_torch/formats/.

    python3 scripts/make_torch_format_fixtures.py

Needs OpenCV (``cv2``), which writes most files and decodes every one of
them as the reference; the layouts OpenCV cannot write (tiles, planar
samples, big-endian, the floating-point predictor, an interlaced and
transparent GIF on a larger screen) are built by hand by
``tests/torch_format_builders.py``; one lossless WebP comes from PIL's
libwebp at its highest effort, 6 (OpenCV writes at its default). Each
input file comes with OpenCV's decode of it: a PNG for uint8 images (the port's PNG reader is exact), a
``.npy`` otherwise. The encoding fixtures are OpenCV's JPEG and TIFF files
of images drawn from ``numpy.random.PCG64(seed).random_raw``, whose stream
numpy keeps stable. ``manifest.json`` lists it all; the tests
(``tests/test_torch_formats_fixtures.py``) and ``chip_smoke.py`` phase 14
read it. Not run by the tests: rerun it only when the set changes.
"""

from __future__ import annotations

import json
import os
import sys

import io

import cv2
import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
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


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    decode, encode = [], []

    def add(name, data, what):
        path = os.path.join(OUT, name)
        with open(path, "wb") as f:
            f.write(data)
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert ref is not None, name
        stem = os.path.splitext(name)[0]
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

    for seed, shape in ((11, (48, 64, 3)), (12, (37, 53))):
        image = seeded_image(seed, shape)
        stem = f"encode_seed{seed}_{'x'.join(map(str, shape))}"
        entry = {"seed": seed, "shape": list(shape)}
        for ext in (".jpg", ".tif"):
            with open(os.path.join(OUT, stem + ext), "wb") as f:
                f.write(cv2.imencode(ext, image)[1].tobytes())
            entry["jpeg" if ext == ".jpg" else "tiff"] = stem + ext
        encode.append(entry)

    manifest = {"made_by": "scripts/make_torch_format_fixtures.py with OpenCV " + cv2.__version__,
                "decode": decode, "encode": encode}
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"wrote {len(os.listdir(OUT))} files, {total} bytes, into {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
