#!/usr/bin/env python3
"""Write the video fixtures of the port's tests.

    python3 scripts/make_torch_video_fixture.py [--out tests/data_torch/mjpeg_160x120x8.avi]
                                                [--mpeg4-dir tests/data_torch/video]
                                                [--vp9-dir tests/data_torch/vp9]
                                                [--ffv1-dir tests/data_torch/ffv1]
                                                [--odd-dir tests/data_torch/odd_height]
                                                [--h264-dir tests/data_torch/h264]
                                                [--vp9-only | --ffv1-only | --h264-only | --mpeg2-only]

The Motion-JPEG AVI: eight 160x120 RGB frames of a seeded scene (smooth
texture and sharp-edged shapes) panned by one pixel a frame, written by
``cv2.VideoWriter`` with the ``MJPG`` fourcc (OpenCV's FFmpeg backend:
baseline JPEG frames, 4:2:0, each with its own tables);
``tests/test_torch_video.py`` records the SHA-256 of the port's decode of it.

The clips of ``tests/data_torch/video``, each written by ``cv2.VideoWriter``
(MPEG-4 Part 2 by FFmpeg's ``mpeg4`` encoder: I- and P-VOPs, a GOP of 12;
VP8 by libvpx through FFmpeg):

- ``mp4v_960x540x12.mp4``: the 12 LR frames of ``chip_smoke.py``'s video
  phase (``video_problem`` on the CPU in float32, seed 41: 3x540x960),
  quantised to uint8 as that phase's PNG path quantises them
  (``ImageData.visualization_image``); ``chip_smoke.py`` super-resolves the
  port's decode of it on the card and rebuilds the truth from the seed;
- ``mp4v_160x120x14.mp4``: the scene above panned by one pixel a frame, with
  one frame of noise (intra macroblocks in P-VOPs), over two GOPs;
- ``xvid_96x64x8.avi``: the scene at 96x64 with fourcc ``XVID``;
- ``xvid_build67_88x56x6.avi`` and ``xvid_noname_88x56x6.avi``: the scene
  at 88x56 with fourcc ``XVID``, its 13-byte user data ``Lavc62.28.101``
  rewritten in place as ``XviD000000067`` (FFmpeg then decodes with its Xvid
  IDCT) and as 13 spaces (no encoder name in an ``XVID`` AVI: FFmpeg takes it
  for Xvid build 0, Xvid IDCT and the old builds' edge workaround); the
  rewrite needs the ``Lavc62.28.101`` that this machine's OpenCV writes;
- ``mp4v_960x540x12.mkv`` and ``mp4v_96x64x8.mkv``: the frames of
  ``mp4v_960x540x12.mp4`` and the 96x64 scene in Matroska
  (``V_MPEG4/ISO/ASP``);
- ``vp8_960x540x12.webm``: the frames of ``mp4v_960x540x12.mp4`` written
  with fourcc ``VP80`` (libvpx's VP8: key and inter frames, golden and
  altref references); ``chip_smoke.py`` super-resolves the port's decode of
  it on the card;
- ``vp8_160x120x40.webm``, ``.mkv``, ``.avi`` and ``.ivf``: a pan over 40
  frames of the scene without grain, one frame of them under noise of +-30
  grey levels (intra macroblocks in inter frames, a key frame after it,
  golden refreshes), in each container ``cv2.VideoWriter`` puts VP8 into;
- ``vp8_96x64x16.webm``: a pan with a square that moves on its own (inter
  macroblocks split between two motions: SPLITMV);
- ``mjpeg_160x120x4.mkv``: the Motion-JPEG AVI's scene in Matroska as ``V_MJPEG``. The
  port decodes each JPEG as ``cv2.imdecode`` does, which is not what
  ``cv2.VideoCapture`` gives for Motion-JPEG; its entry records the digest of
  the port's decode (``decode_sha256``) and the largest and mean gaps to
  ``cv2.VideoCapture``'s frames (``capture_gap``).

The VP9 clips of ``tests/data_torch/vp9`` (its own ``manifest.json``), each
written by ``cv2.VideoWriter`` with the ``VP90`` fourcc (libvpx's VP9 at
OpenCV's settings: profile 0, frame-parallel, switchable filters, high
precision vectors; ``vp09`` in MP4):

- ``vp9_960x540x12.webm``: the frames of ``mp4v_960x540x12.mp4`` (two tile
  columns at this width); ``chip_smoke.py`` super-resolves the port's decode
  of it on the card;
- ``vp9_160x120x24.webm``, ``.ivf`` and ``.mp4``: a pan over 24 frames of
  the scene without grain, one frame of them under noise of +-30 grey
  levels, with a square that moves on its own (NEWMV, sub-8x8 blocks, intra
  blocks in inter frames);
- ``vp9_96x64x10.mkv`` and ``.avi``: a smaller pan.

The FFV1 clips of ``tests/data_torch/ffv1`` (its own ``manifest.json``),
each written by ``cv2.VideoWriter`` with the ``FFV1`` fourcc (FFmpeg's
lossless ``ffv1`` encoder at OpenCV's settings: version 3, RGB with alpha,
Golomb-Rice, slices with CRCs):

- ``ffv1_960x540x4.mkv``: the first 4 frames of ``mp4v_960x540x12.mp4``;
  ``chip_smoke.py`` super-resolves the port's decode of it on the card;
- ``ffv1_96x64x6.avi``, ``.mp4`` and ``.mov``: a small pan of the scene.

Their entries also record ``source_sha256``, the SHA-256 of the frames
written: the codec is lossless, so it equals ``frames_sha256``.

The odd-height clips of ``tests/data_torch/odd_height`` (its own
``manifest.json``), whose frames ``cv2.VideoCapture`` converts through
swscale's bicubic scaler: ``vp9_61x41x12.ivf`` from the VP9 test writer
(``tests/torch_vp9_writer.py``, every feature, seed 51),
``vp8_61x41x12.ivf`` from the VP8 test writer (``tests/torch_vp8_writer.py``,
every feature, seed 52) and ``mpeg4_64x37x6.avi`` from FFmpeg's ``mpeg4``
encoder driven through ctypes (``tests/torch_libav.py``), whose chroma FFmpeg
sites left.

The H.264 clips of ``tests/data_torch/h264`` (its own ``manifest.json``):
``h264_960x540x12.mp4`` (``avc1``), ``.mkv`` (``V_MPEG4/ISO/AVC``), ``.avi``
(``H264``, Annex B) and ``.h264`` (a raw Annex B stream), one stream in four
containers: the frames of ``mp4v_960x540x12.mp4`` coded 960x544 with a bottom
crop of 4 rows by the test writer's encoder (``tests/torch_h264_writer.py``:
an IDR of intra 16x16 macroblocks, then P pictures of P_L0_16x16 and P_Skip
macroblocks from a motion search, QP 22, the deblocking filter off, in the
closed loop); and ``h264_high_960x540x12.mp4`` (``avc1``, High profile), the
same frames by its High-profile encoder (CABAC, the 8x8 transform chosen for
each macroblock, an IDR of intra 8x8 and intra 16x16 macroblocks, then
P_L0_16x16, P_8x8 and P_Skip, QP 22, the deblocking filter on, each P picture
predicted from FFmpeg's decode of the stream before it); and
``h264_b_960x540x12.mp4`` (``avc1``, High profile with B pictures), the same
frames in x264's default GOP shape (up to 3 B pictures before each anchor, the
middle one a reference: B-pyramid; spatial direct, implicit weighted
bi-prediction, CABAC, QP 22 and 24 in B slices, deblocking on), with the composition offsets
(``ctts`` version 0) and the edit list FFmpeg's muxer writes. ``chip_smoke.py``
super-resolves the port's decode of the three ``.mp4`` files on the card. The
OpenCV wheel's ``cv2.VideoWriter`` has no H.264 encoder (its FFmpeg's only
one, ``h264_v4l2m2m``, needs a V4L2 device).

The MPEG-1 / MPEG-2 clips of ``tests/data_torch/mpeg2`` (its own
``manifest.json``), each written by ``cv2.VideoWriter`` at 25 frames a second
(an MPEG frame rate, which MPEG-1 needs) from the frames of
``mp4v_960x540x12.mp4``: ``mpeg2_960x540x12.mpg`` (fourcc ``mpg2``:
FFmpeg's ``mpeg2video`` at OpenCV's settings, I, P and B pictures -- two B
pictures between anchors --, in an MPEG-1 system stream, FFmpeg's ``mpeg``
muxer), ``mpeg2_960x540x12.ts`` (the same stream in an MPEG transport stream)
and ``mpeg1_960x540x12.mpg`` (fourcc ``PIM1``: FFmpeg's ``mpeg1video``, I and
P pictures). ``chip_smoke.py`` super-resolves the port's decode of the MPEG-2
``.mpg`` on the card and decodes the other two. Each entry also records the
stream's picture types, counted from its picture headers here, and the
macroblock counts of the port's decoder (``utils/mpeg2.py`` ``STATS``).

``manifest.json`` records each clip's SHA-256, its frame shape and the
SHA-256 of ``cv2.VideoCapture``'s frames (uint8 BGR, C order); the small
MPEG-4 Part 2 clips but the Matroska one also keep those frames as
``<clip>.decoded.png``, stacked top to bottom. Needs OpenCV, which the
machine that decodes the fixtures (``chip_smoke.py``) does not have: the
files are kept in the repository.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import sys

import cv2
import numpy as np

FRAMES, WIDTH, HEIGHT, SEED = 8, 160, 120, 2026
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
FULL_WIDTH_CLIP = "mp4v_960x540x12.mp4"
FULL_WIDTH_MKV = "mp4v_960x540x12.mkv"
ENCODER_NAME = b"Lavc62.28.101"  # the user data this OpenCV's FFmpeg writes into MPEG-4 Part 2
XVID_NAMES = {"xvid_build67_88x56x6.avi": b"XviD000000067", "xvid_noname_88x56x6.avi": b" " * 13}


def scene(seed: int = SEED, h: int = HEIGHT, w: int = WIDTH + FRAMES, grain: float = 3.0) -> np.ndarray:
    """A uint8 BGR scene of (h, w) pixels, with Gaussian grain of standard deviation ``grain``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.empty((h, w, 3))
    for c in range(3):
        img[..., c] = 120 + 60 * np.sin(xx / (9.0 + 2 * c)) * np.cos(yy / 13.0) + 20 * np.sin((xx + yy) / 5.0)
    for _ in range(10):
        cy, cx, ry, rx = rng.integers(0, h), rng.integers(0, w), rng.integers(4, 25), rng.integers(4, 30)
        img[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0] += rng.uniform(-70, 70, 3)
    if grain:
        img += rng.normal(0, grain, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def write_clip(path: str, fourcc: str, frames: list[np.ndarray], fps: int = 10) -> None:
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    if not writer.isOpened():
        raise SystemExit(f"cv2.VideoWriter cannot write {fourcc} to {path} here")
    for frame in frames:
        writer.write(np.ascontiguousarray(frame))
    writer.release()


def capture_frames(path: str) -> list[np.ndarray]:
    """The frames ``cv2.VideoCapture`` (the JAX package's video path) decodes from ``path``."""
    capture, frames = cv2.VideoCapture(path), []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(frame)
    capture.release()
    return frames


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@functools.lru_cache(maxsize=1)
def video_phase_frames() -> tuple[np.ndarray, ...]:
    """chip_smoke.py's video LR frames (seed 41, 3x540x960) as the uint8 BGR images its PNG path writes."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from super_resolution_tpu_torch.image import ImageData

    _, lows, _ = chip_smoke.video_problem(torch.device("cpu"), torch.float32)
    return tuple(ImageData(low, normalize="never", channel_major=True).visualization_image() for low in lows)


def vp8_clips() -> dict[str, tuple[str, list[np.ndarray], bool]]:
    """{file name: (fourcc, frames, keep cv2's decode as PNG)} of the VP8 fixtures."""
    pan = scene(SEED + 4, 120, 200, grain=0)
    panned = [pan[:, i:i + 160].copy() for i in range(40)]
    noise = np.random.default_rng(SEED + 4).integers(-30, 31, panned[17].shape)
    panned[17] = np.clip(panned[17] + noise, 0, 255).astype(np.uint8)
    ground, square = scene(SEED + 5, 64, 112, grain=0), scene(SEED + 6, 24, 24, grain=0)
    split = []
    for i in range(16):
        frame = ground[:, i:i + 96].copy()
        y, x = 8 + (5 * i) % 32, 60 - 3 * i
        frame[y:y + 24, x:x + 24] = square
        split.append(frame)
    clips = {"vp8_960x540x12.webm": ("VP80", list(video_phase_frames()), False)}
    clips.update({f"vp8_160x120x40.{ext}": ("VP80", panned, False) for ext in ("webm", "mkv", "avi", "ivf")})
    clips["vp8_96x64x16.webm"] = ("VP80", split, False)
    return clips


def vp9_clips() -> dict[str, tuple[str, list[np.ndarray], bool]]:
    """{file name: (fourcc, frames, keep cv2's decode as PNG)} of the VP9 fixtures."""
    ground, square = scene(SEED + 7, 120, 184, grain=0), scene(SEED + 8, 24, 24, grain=0)
    pan = []
    for i in range(24):
        frame = ground[:, i:i + 160].copy()
        y, x = 16 + (7 * i) % 72, 120 - 4 * i
        frame[y:y + 24, max(x, 0):x + 24] = square[:, max(-x, 0):]
        pan.append(frame)
    noise = np.random.default_rng(SEED + 7).integers(-30, 31, pan[13].shape)
    pan[13] = np.clip(pan[13] + noise, 0, 255).astype(np.uint8)
    small = scene(SEED + 9, 64, 106, grain=0)
    clips = {"vp9_960x540x12.webm": ("VP90", list(video_phase_frames()), False)}
    clips.update({f"vp9_160x120x24.{ext}": ("VP90", pan, False) for ext in ("webm", "ivf", "mp4")})
    clips.update({f"vp9_96x64x10.{ext}": ("VP90", [small[:, i:i + 96] for i in range(10)], False)
                  for ext in ("mkv", "avi")})
    return clips


def mpeg4_clips() -> dict[str, tuple[str, list[np.ndarray], bool]]:
    """{file name: (fourcc, frames, keep cv2's decode as PNG)} of the MPEG-4 fixtures."""
    pan = scene(SEED + 1, 120, 174)
    panned = [pan[:, i:i + 160].copy() for i in range(14)]
    panned[9] = np.random.default_rng(SEED).integers(0, 256, panned[9].shape, dtype=np.uint8)
    small = scene(SEED + 2, 64, 104)
    small_frames = [small[:, i:i + 96] for i in range(8)]
    named = scene(SEED + 3, 56, 94)
    return {FULL_WIDTH_CLIP: ("mp4v", list(video_phase_frames()), False),
            "mp4v_160x120x14.mp4": ("mp4v", panned, True),
            "xvid_96x64x8.avi": ("XVID", small_frames, True),
            **{name: ("XVID", [named[:, i:i + 88] for i in range(6)], True) for name in XVID_NAMES},
            FULL_WIDTH_MKV: ("mp4v", list(video_phase_frames()), False),
            "mp4v_96x64x8.mkv": ("mp4v", small_frames, False),
            "mjpeg_160x120x4.mkv": ("MJPG", [scene()[:, i:i + WIDTH] for i in range(4)], False)}


def rename_encoder(path: str, name: bytes) -> None:
    """Rewrite the clip's encoder name (its MPEG-4 user data) in place, keeping its length."""
    data = open(path, "rb").read()
    if data.count(ENCODER_NAME) != 1 or len(name) != len(ENCODER_NAME):
        raise SystemExit(f"{path}: expected one {ENCODER_NAME!r} to rewrite as {name!r}")
    with open(path, "wb") as f:
        f.write(data.replace(ENCODER_NAME, name))


def matroska_payloads(path: str) -> list[bytes]:
    """The frames of a Matroska clip, read with the port's demuxer."""
    sys.path.insert(0, ROOT)
    from super_resolution_tpu_torch.video.mkv import read_matroska_video

    return read_matroska_video(open(path, "rb").read()).frames


def write_mpeg4_fixtures(directory: str, clips=None) -> None:
    os.makedirs(directory, exist_ok=True)
    manifest = {}
    for name, (fourcc, frames, keep_png) in (clips or {**mpeg4_clips(), **vp8_clips()}).items():
        path = os.path.join(directory, name)
        write_clip(path, fourcc, frames)
        if name in XVID_NAMES:
            rename_encoder(path, XVID_NAMES[name])
        decoded = np.stack(capture_frames(path))
        entry = {"sha256": sha256(open(path, "rb").read()), "fourcc": fourcc, "shape": list(decoded.shape),
                 "frames_sha256": sha256(decoded.tobytes()), "decoded_png": None}
        if fourcc == "MJPG":
            ours = np.stack([cv2.imdecode(np.frombuffer(p, np.uint8), cv2.IMREAD_COLOR)
                             for p in matroska_payloads(path)])
            gap = np.abs(ours.astype(np.int64) - decoded)
            entry.update(decode_sha256=sha256(ours.tobytes()), capture_gap=[int(gap.max()), float(gap.mean())])
        if keep_png:
            entry["decoded_png"] = f"{name}.decoded.png"
            cv2.imwrite(os.path.join(directory, entry["decoded_png"]), decoded.reshape(-1, *decoded.shape[2:]),
                        [cv2.IMWRITE_PNG_COMPRESSION, 9])
        manifest[name] = entry
        print(f"wrote {path} ({os.path.getsize(path)} bytes, {decoded.shape[0]} frames)")
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


def ffv1_clips() -> dict[str, tuple[str, list[np.ndarray], bool]]:
    """{file name: (fourcc, frames, keep cv2's decode as PNG)} of the FFV1 fixtures."""
    small = scene(SEED + 10, 64, 102, grain=0)
    clips = {"ffv1_960x540x4.mkv": ("FFV1", list(video_phase_frames()[:4]), False)}
    clips.update({f"ffv1_96x64x6.{ext}": ("FFV1", [small[:, i:i + 96] for i in range(6)], False)
                  for ext in ("avi", "mp4", "mov")})
    return clips


def write_ffv1_fixtures(directory: str) -> None:
    """The FFV1 clips, with the digest of the frames written beside that of cv2's decode."""
    clips = ffv1_clips()
    write_mpeg4_fixtures(directory, clips)
    path = os.path.join(directory, "manifest.json")
    manifest = json.load(open(path))
    for name, (_, frames, _) in clips.items():
        manifest[name]["source_sha256"] = sha256(np.stack(frames).tobytes())
        if manifest[name]["source_sha256"] != manifest[name]["frames_sha256"]:
            raise SystemExit(f"{name}: cv2.VideoCapture does not give back the frames written")
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


def odd_height_streams() -> dict[str, tuple[str, bytes]]:
    """{file name: (fourcc, file bytes)} of the odd-height clips."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_libav
    from torch_vp8_writer import FEATURES as VP8_FEATURES, Vp8Writer, ivf as vp8_ivf
    from torch_vp9_writer import FEATURES as VP9_FEATURES, Vp9Writer, ivf as vp9_ivf

    w, h, n = 61, 41, 12
    vp9 = Vp9Writer(w, h, np.random.default_rng(51), VP9_FEATURES).stream(n)
    vp8_writer = Vp8Writer(w, h, np.random.default_rng(52), VP8_FEATURES, 0)
    vp8 = [vp8_writer.frame(key=i == n // 2, show=i % 5 != 3) for i in range(n)]
    mw, mh = 64, 37
    texture = scene(SEED + 11, mh, mw + 6)
    planes = []
    for i in range(6):
        yuv = cv2.cvtColor(np.ascontiguousarray(texture[:, i:i + mw]), cv2.COLOR_BGR2YUV)
        planes.append([yuv[..., 0], yuv[::2, ::2, 1], yuv[::2, ::2, 2]])  # 4:2:0, the last chroma row alone
    mpeg4, _ = torch_libav.encode("mpeg4", planes, "yuv420p", mw, mh, {"g": 3, "bf": 0})
    out = os.path.join(ROOT, "tests", "data_torch", "odd_height", ".mpeg4.avi")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    torch_libav.write_avi(out, mpeg4, mw, mh, b"FMP4")
    avi = open(out, "rb").read()
    os.remove(out)
    return {f"vp9_{w}x{h}x{n}.ivf": ("VP90", vp9_ivf(vp9, w, h)), f"vp8_{w}x{h}x{n}.ivf": ("VP80", vp8_ivf(vp8, w, h)),
            f"mpeg4_{mw}x{mh}x6.avi": ("FMP4", avi)}


def write_odd_height_fixtures(directory: str) -> None:
    os.makedirs(directory, exist_ok=True)
    manifest = {}
    for name, (fourcc, data) in odd_height_streams().items():
        path = os.path.join(directory, name)
        with open(path, "wb") as f:
            f.write(data)
        decoded = np.stack(capture_frames(path))
        manifest[name] = {"sha256": sha256(data), "fourcc": fourcc, "shape": list(decoded.shape),
                          "frames_sha256": sha256(decoded.tobytes())}
        print(f"wrote {path} ({len(data)} bytes, {decoded.shape[0]} frames)")
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


H264_QP, H264_SEARCH = 22, 6


def write_h264_fixtures(directory: str) -> None:
    """The 960x540 H.264 clip: the frames of ``mp4v_960x540x12.mp4`` coded 960x544 with a bottom crop of 4 rows
    by ``tests/torch_h264_writer.py``'s encoder (an IDR of intra 16x16 macroblocks, then P pictures with a
    motion search, a residual at QP 22, the deblocking filter off, in the closed loop), in four containers that
    hold the same stream. The manifest records cv2's digest of each and the encoding settings; the script stops
    if the encoder's reconstruction is not FFmpeg's decode or if the containers decode apart."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_libav
    from torch_h264_writer import annexb, avi, encode_frames, mkv, mp4

    os.makedirs(directory, exist_ok=True)
    frames = list(video_phase_frames())
    h, w = frames[0].shape[:2]
    aus, recon, encoder = encode_frames(frames, H264_QP, H264_SEARCH)
    planes = torch_libav.decode_planes("h264", [annexb([au]) for au in aus], "yuv420p", w, h)
    if len(planes) != len(recon) or any(not np.array_equal(a, b) for r, p in zip(recon, planes) for a, b in zip(r, p)):
        raise SystemExit("the encoder's reconstruction is not FFmpeg's decode")
    stem = f"h264_{w}x{h}x{len(frames)}"
    files = {f"{stem}.mp4": mp4(aus, w, h), f"{stem}.mkv": mkv(aus, w, h), f"{stem}.h264": annexb(aus)}
    manifest = {}
    for name, data in files.items():
        with open(os.path.join(directory, name), "wb") as f:
            f.write(data)
    avi(os.path.join(directory, f"{stem}.avi"), aus, w, h)
    files[f"{stem}.avi"] = open(os.path.join(directory, f"{stem}.avi"), "rb").read()
    digests = set()
    for name, data in files.items():
        decoded = np.stack(capture_frames(os.path.join(directory, name)))
        digests.add(sha256(decoded.tobytes()))
        manifest[name] = {"sha256": sha256(data), "frames_sha256": sha256(decoded.tobytes()),
                          "shape": list(decoded.shape), "bytes": len(data)}
        print(f"wrote {name} ({len(data)} bytes, {decoded.shape[0]} frames)")
    if len(digests) != 1:
        raise SystemExit("cv2.VideoCapture decodes the four containers apart")
    manifest["encoding"] = {"source": "video_phase_frames() (mp4v_960x540x12.mp4's frames)", "qp": H264_QP,
                            "search": H264_SEARCH, "coded": [encoder.cw, encoder.ch], "crop_bottom": encoder.ch - h,
                            "profile_idc": encoder.sps.profile_idc, "deblocking": "off",
                            "macroblocks": dict(sorted(encoder.stats.items()))}
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


def write_h264_high_fixture(directory: str) -> None:
    """The 960x540 High-profile H.264 clip ``h264_high_960x540x12.mp4`` (``avc1``, ``profile_idc`` 100): the same
    frames coded 960x544 with a bottom crop of 4 rows by ``tests/torch_h264_writer.py``'s High-profile encoder
    (CABAC, the 8x8 transform chosen for each macroblock; an IDR of I_NxN (intra 8x8) and I_16x16 macroblocks, then
    P pictures of P_L0_16x16, P_8x8 and P_Skip; QP 22; the deblocking filter on), each P picture predicted from
    FFmpeg's decode of the stream before it. Added to the manifest that ``write_h264_fixtures`` writes; the script
    stops if the whole stream's decode is not the pictures the encoder predicted from."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_libav
    from torch_h264_writer import annexb, encode_frames, mp4

    frames = list(video_phase_frames())
    h, w = frames[0].shape[:2]
    aus, recon, encoder = encode_frames(frames, H264_QP, H264_SEARCH, high=True)
    planes = torch_libav.decode_planes("h264", [annexb([au]) for au in aus], "yuv420p", w, h)
    if len(planes) != len(recon) or any(not np.array_equal(a, b) for r, p in zip(recon, planes) for a, b in zip(r, p)):
        raise SystemExit("the High-profile stream's decode is not the pictures its encoder predicted from")
    name = f"h264_high_{w}x{h}x{len(frames)}.mp4"
    data = mp4(aus, w, h)
    with open(os.path.join(directory, name), "wb") as f:
        f.write(data)
    decoded = np.stack(capture_frames(os.path.join(directory, name)))
    path = os.path.join(directory, "manifest.json")
    manifest = json.load(open(path))
    manifest[name] = {"sha256": sha256(data), "frames_sha256": sha256(decoded.tobytes()), "shape": list(decoded.shape),
                      "bytes": len(data)}
    manifest["encoding_high"] = {"source": "video_phase_frames() (mp4v_960x540x12.mp4's frames)", "qp": H264_QP,
                                 "search": H264_SEARCH, "coded": [encoder.cw, encoder.ch],
                                 "crop_bottom": encoder.ch - h,
                                 "profile_idc": encoder.sps.profile_idc, "entropy_coding": "CABAC",
                                 "deblocking": "on", "macroblocks": dict(sorted(encoder.stats.items()))}
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {name} ({len(data)} bytes, {decoded.shape[0]} frames)")


def write_h264_b_fixture(directory: str) -> None:
    """The 960x540 H.264 clip with B pictures ``h264_b_960x540x12.mp4`` (``avc1``, ``profile_idc`` 100): the same
    frames coded 960x544 with a bottom crop of 4 rows by ``tests/torch_h264_writer.py``'s ``HighBEncoder``
    (x264's default GOP shape: an IDR, then an anchor P picture every 4 frames with up to 3 B pictures before it,
    the middle one of 3 a reference; spatial direct, implicit weighted bi-prediction, CABAC, the 8x8 transform,
    QP 22 and 24 in B slices (x264's pbratio), the deblocking filter on; each picture predicted from FFmpeg's decode of its references), in an MP4 with
    ``ctts`` version 0 and an edit list whose media_time is the composition delay, as FFmpeg's mov muxer writes it.
    Added to the manifest; the script stops if FFmpeg's decode is not the pictures the encoder predicted from."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_libav
    from torch_h264_writer import HighBEncoder, annexb, encode_frames, mp4

    frames = list(video_phase_frames())
    h, w = frames[0].shape[:2]
    aus, recon, encoder = encode_frames(frames, H264_QP, H264_SEARCH, high=True, b_frames=True)
    planes = torch_libav.decode_planes("h264", [annexb([au]) for au in aus], "yuv420p", w, h)
    if len(planes) != len(recon) or any(not np.array_equal(a, b) for r, p in zip(recon, planes) for a, b in zip(r, p)):
        raise SystemExit("the B-picture stream's decode is not the pictures its encoder predicted from")
    gop = HighBEncoder.gop(len(frames))
    name = f"h264_b_{w}x{h}x{len(frames)}.mp4"
    data = mp4(aus, w, h, pts=[g[0] for g in gop])
    with open(os.path.join(directory, name), "wb") as f:
        f.write(data)
    decoded = np.stack(capture_frames(os.path.join(directory, name)))
    path = os.path.join(directory, "manifest.json")
    manifest = json.load(open(path))
    manifest[name] = {"sha256": sha256(data), "frames_sha256": sha256(decoded.tobytes()), "shape": list(decoded.shape),
                      "bytes": len(data)}
    manifest["encoding_b"] = {"source": "video_phase_frames() (mp4v_960x540x12.mp4's frames)", "qp": H264_QP,
                              "qp_b_slices": H264_QP + 2,
                              "search": H264_SEARCH, "coded": [encoder.cw, encoder.ch], "crop_bottom": encoder.ch - h,
                              "profile_idc": encoder.sps.profile_idc, "entropy_coding": "CABAC", "deblocking": "on",
                              "gop": " ".join(f"{kind}{disp}" for disp, kind, _ in gop),
                              "macroblocks": dict(sorted(encoder.stats.items()))}
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {name} ({len(data)} bytes, {decoded.shape[0]} frames)")


MPEG2_DIR = os.path.join(ROOT, "tests", "data_torch", "mpeg2")
MPEG_FPS = 25  # an MPEG-1 / MPEG-2 frame rate: FFmpeg's mpeg1video refuses the fixtures' 10


def mpeg_picture_types(es: bytes) -> dict[str, int]:
    """{"I": n, "P": n, "B": n}: the picture_coding_type of each picture header of an MPEG-1 / MPEG-2 elementary
    stream."""
    counts = {"I": 0, "P": 0, "B": 0}
    pos = es.find(b"\0\0\1\0")
    while pos >= 0:
        counts["IPB"[((es[pos + 5] >> 3) & 7) - 1]] += 1
        pos = es.find(b"\0\0\1\0", pos + 4)
    return counts


def write_mpeg2_fixtures(directory: str) -> None:
    """The MPEG-1 / MPEG-2 clips of ``directory`` and its manifest: the frames of ``mp4v_960x540x12.mp4`` written by
    ``cv2.VideoWriter`` as MPEG-2 in a program stream and in a transport stream, and as MPEG-1 in a program stream.
    The script stops if cv2 does not read back the frames written or if the port's decode is not cv2's."""
    sys.path.insert(0, ROOT)
    from super_resolution_tpu_torch.utils.mpeg2 import Mpeg2Decoder
    from super_resolution_tpu_torch.video.mpegps import read_program_stream
    from super_resolution_tpu_torch.video.mpegts import read_transport_stream

    os.makedirs(directory, exist_ok=True)
    frames = list(video_phase_frames())
    h, w = frames[0].shape[:2]
    clips = {f"mpeg2_{w}x{h}x{len(frames)}.mpg": "mpg2", f"mpeg2_{w}x{h}x{len(frames)}.ts": "mpg2",
             f"mpeg1_{w}x{h}x{len(frames)}.mpg": "PIM1"}
    manifest = {}
    for name, fourcc in clips.items():
        path = os.path.join(directory, name)
        write_clip(path, fourcc, frames, fps=MPEG_FPS)
        data = open(path, "rb").read()
        es = read_transport_stream(data).es if name.endswith(".ts") else read_program_stream(data).es
        decoded = np.stack(capture_frames(path))
        if decoded.shape[0] != len(frames):
            raise SystemExit(f"cv2.VideoCapture reads {decoded.shape[0]} frames of {name}, not {len(frames)}")
        decoder = Mpeg2Decoder()
        ours = np.stack(decoder.decode(es) + decoder.flush())
        if not np.array_equal(ours, decoded):
            raise SystemExit(f"the port's decode of {name} is not cv2.VideoCapture's")
        stats = decoder.stats
        manifest[name] = {"sha256": sha256(data), "frames_sha256": sha256(decoded.tobytes()),
                          "shape": list(decoded.shape), "bytes": len(data), "fourcc": fourcc,
                          "pictures": mpeg_picture_types(es),
                          "macroblocks": {k: stats[k] for k in ("intra_mbs", "skipped_mbs", "forward_mbs",
                                                                "backward_mbs", "bidirectional_mbs")}}
        print(f"wrote {name} ({len(data)} bytes, {decoded.shape[0]} frames, {manifest[name]['pictures']})")
    manifest["source"] = "video_phase_frames() (mp4v_960x540x12.mp4's frames), cv2.VideoWriter at 25 frames/s"
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "tests", "data_torch", "mjpeg_160x120x8.avi"))
    parser.add_argument("--mpeg4-dir", default=os.path.join(ROOT, "tests", "data_torch", "video"))
    parser.add_argument("--vp9-dir", default=os.path.join(ROOT, "tests", "data_torch", "vp9"))
    parser.add_argument("--ffv1-dir", default=os.path.join(ROOT, "tests", "data_torch", "ffv1"))
    parser.add_argument("--odd-dir", default=os.path.join(ROOT, "tests", "data_torch", "odd_height"))
    parser.add_argument("--h264-dir", default=os.path.join(ROOT, "tests", "data_torch", "h264"))
    parser.add_argument("--vp9-only", action="store_true", help="write the VP9 clips alone")
    parser.add_argument("--ffv1-only", action="store_true", help="write the FFV1 and odd-height clips alone")
    parser.add_argument("--h264-only", action="store_true", help="write the H.264 clips alone")
    parser.add_argument("--mpeg2-only", action="store_true", help="write the MPEG-1 / MPEG-2 clips alone")
    args = parser.parse_args(argv)
    if args.mpeg2_only:
        write_mpeg2_fixtures(MPEG2_DIR)
        return 0
    if args.h264_only:
        write_h264_fixtures(args.h264_dir)
        write_h264_high_fixture(args.h264_dir)
        write_h264_b_fixture(args.h264_dir)
        return 0
    if args.vp9_only:
        write_mpeg4_fixtures(args.vp9_dir, vp9_clips())
        return 0
    if args.ffv1_only:
        write_ffv1_fixtures(args.ffv1_dir)
        write_odd_height_fixtures(args.odd_dir)
        return 0
    base = scene()
    write_clip(args.out, "MJPG", [base[:, i: i + WIDTH] for i in range(FRAMES)])
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    write_mpeg4_fixtures(args.mpeg4_dir)
    write_mpeg4_fixtures(args.vp9_dir, vp9_clips())
    write_ffv1_fixtures(args.ffv1_dir)
    write_odd_height_fixtures(args.odd_dir)
    write_h264_fixtures(args.h264_dir)
    write_h264_high_fixture(args.h264_dir)
    write_h264_b_fixture(args.h264_dir)
    write_mpeg2_fixtures(MPEG2_DIR)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
