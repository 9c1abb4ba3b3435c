#!/usr/bin/env python3
"""Write the Motion-JPEG AVI fixture of the port's video tests.

    python3 scripts/make_torch_video_fixture.py [--out tests/data_torch/mjpeg_160x120x8.avi]

Eight 160x120 RGB frames of a seeded scene (smooth texture and sharp-edged
shapes) panned by one pixel a frame, written by ``cv2.VideoWriter`` with the
``MJPG`` fourcc (OpenCV's FFmpeg backend: baseline JPEG frames, 4:2:0, each
with its own tables). Needs OpenCV, which the machine that decodes the
fixture (``chip_smoke.py``) does not have: the file is kept in the
repository, and ``tests/test_torch_video.py`` records the SHA-256 of the
port's decode of it.
"""

from __future__ import annotations

import argparse
import os

import cv2
import numpy as np

FRAMES, WIDTH, HEIGHT, SEED = 8, 160, 120, 2026


def scene(seed: int = SEED) -> np.ndarray:
    """A uint8 BGR scene of (HEIGHT, WIDTH + FRAMES) pixels."""
    rng = np.random.default_rng(seed)
    h, w = HEIGHT, WIDTH + FRAMES
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.empty((h, w, 3))
    for c in range(3):
        img[..., c] = 120 + 60 * np.sin(xx / (9.0 + 2 * c)) * np.cos(yy / 13.0) + 20 * np.sin((xx + yy) / 5.0)
    for _ in range(10):
        cy, cx, ry, rx = rng.integers(0, h), rng.integers(0, w), rng.integers(4, 25), rng.integers(4, 30)
        img[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0] += rng.uniform(-70, 70, 3)
    img += rng.normal(0, 3, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "..", "tests", "data_torch",
                                                      "mjpeg_160x120x8.avi"))
    args = parser.parse_args(argv)
    base = scene()
    writer = cv2.VideoWriter(args.out, cv2.VideoWriter_fourcc(*"MJPG"), 10, (WIDTH, HEIGHT))
    if not writer.isOpened():
        raise SystemExit("cv2.VideoWriter cannot write MJPG here")
    for i in range(FRAMES):
        writer.write(np.ascontiguousarray(base[:, i: i + WIDTH]))
    writer.release()
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
