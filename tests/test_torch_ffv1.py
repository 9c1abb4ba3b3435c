"""FFV1 video in the port (``utils/ffv1.py`` over ``native/ffv1_decoder.cpp``;
the Matroska, AVI, MP4 and QuickTime routing of ``video/video_loader.py``),
held against ``cv2.VideoCapture`` -- the JAX package's video path, FFmpeg's
FFV1 decoder -- and against FFmpeg's own decoder and swscale on the same
streams.

- The clips ``cv2.VideoWriter`` writes with ``FFV1`` (version 3, RGB with
  alpha, Golomb-Rice, slices with CRCs) in .mkv / .avi / .mp4 / .mov, in
  colour and in grey, decode array-equal to ``cv2.VideoCapture`` and to the
  frames written (the codec is lossless); so do the checked-in fixtures of
  ``tests/data_torch/ffv1``.
- Streams of FFmpeg's ``ffv1`` encoder, driven through ctypes
  (``torch_libav.py``) with the options that reach every feature of the
  decoder -- versions 0-3, the Golomb-Rice coder and the range coder with the
  default and a custom state table, small and large contexts, one to many
  slices, frames that keep their contexts (``g`` > 1), every 8-bit layout,
  odd sizes -- decode to FFmpeg's planes, and through an AVI to
  ``cv2.VideoCapture``'s BGR, each feature shown reached by the decoder's
  counts.
- More than 8 bits and version 4 raise ``NotImplementedError`` naming them;
  a slice whose CRC fails raises ``ValueError`` naming it.
- The loader matches the JAX loader in float64 on an FFV1 .mkv; the resolver
  matches the JAX resolver on the decoded frames to 1e-8 of the largest
  entry.
"""

import hashlib
import json
import os
import pathlib
import sys

import cv2
import numpy as np
import pytest
import torch

from super_resolution_tpu.video import VideoLoader as JVideoLoader
from super_resolution_tpu.video import VideoSuperResolver as JVideoSuperResolver

from super_resolution_tpu_torch.utils.ffv1 import STATS, Ffv1Decoder
from super_resolution_tpu_torch.video import VideoLoader, VideoSuperResolver
from super_resolution_tpu_torch.video.mkv import read_matroska_video
from super_resolution_tpu_torch.video.mp4 import read_mp4_video
from super_resolution_tpu_torch.video.video_loader import _chunks, _frame_payloads, _video_stream, read_video_frames

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_libav  # noqa: E402
from torch_libav import capture, plane_shapes, sws_bgr, write_avi  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data_torch", "ffv1")
CPU = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(h, w, seed):
    """Smooth texture with sharp-edged discs and a little grain, uint8 BGR."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    base = np.stack([128 + 70 * np.sin(xx / (5.0 + c)) * np.cos(yy / 9.0) for c in range(3)], -1)
    for _ in range(6):
        cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(3, 10)
        base[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers(0, 256, 3)
    return np.clip(base + rng.normal(0, 4, base.shape), 0, 255).astype(np.uint8)


def _equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    gaps = [int(np.abs(a.astype(int) - b.astype(int)).max()) for a, b in zip(ours, theirs)]
    assert gaps == [0] * len(gaps), f"per-frame max gap {gaps}"


def _payloads(path):
    data = pathlib.Path(path).read_bytes()
    if path.endswith(".avi"):
        hdrl = next((s, e) for fourcc, kind, s, e in _chunks(data, 12, len(data)) if kind == b"hdrl")
        stream, _, _, w, h, _, config = _video_stream(data, hdrl)
        return _frame_payloads(data, stream, 0), config, w, abs(h)
    if path.endswith((".mp4", ".mov")):
        video = read_mp4_video(data)
        return video.samples, video.config, video.width, video.height
    video = read_matroska_video(data)
    return video.frames, video.codec_private, video.width, video.height


# --- what cv2.VideoWriter writes ---------------------------------------------------------------


@pytest.mark.parametrize("colour", [True, False], ids=["colour", "grey"])
@pytest.mark.parametrize("ext", ["mkv", "avi", "mp4", "mov"])
def test_videowriter_clips_equal_videocapture_and_the_frames_written(tmp_path, ext, colour):
    """cv2.VideoWriter's FFV1 in each container: array-equal to cv2.VideoCapture and to the frames written
    (grey comes back with three equal channels)."""
    w, h = 48, 32
    frames = [_scene(h, w + 4, 3)[:, i:i + w].copy() for i in range(4)]
    if not colour:
        frames = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in frames]
    path = str(tmp_path / f"clip.{ext}")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 10, (w, h), colour)
    for frame in frames:
        writer.write(frame)
    writer.release()
    ours = read_video_frames(path)
    _equal(ours, capture(path))
    written = frames if colour else [np.repeat(f[..., None], 3, -1) for f in frames]
    _equal(ours, written)
    assert len(read_video_frames(path, max_frames=2)) == 2


def _manifest():
    return json.loads(pathlib.Path(FIXTURES, "manifest.json").read_text())


@pytest.mark.parametrize("name", sorted(json.load(open(os.path.join(FIXTURES, "manifest.json")))))
def test_checked_in_fixtures(name):
    """Each fixture is the file recorded; the port decodes it to cv2.VideoCapture's frames and to the frames
    written (both digests recorded), through the decoder at its version 3 RGB-with-alpha layout."""
    entry, path = _manifest()[name], os.path.join(FIXTURES, name)
    assert hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest() == entry["sha256"]
    ours = np.stack(read_video_frames(path))
    assert list(ours.shape) == entry["shape"] and entry["fourcc"] == "FFV1"
    assert hashlib.sha256(ours.tobytes()).hexdigest() == entry["frames_sha256"] == entry["source_sha256"]
    _equal(list(ours), capture(path))
    payloads, config, w, h = _payloads(path)
    decoder = Ffv1Decoder(config, w, h)
    for payload in payloads:
        decoder.decode(payload)
    stats = decoder.stats
    assert stats["version_3"] == stats["frames"] == len(ours) and stats["rgb_alpha"] == len(ours)
    assert stats["coder_golomb"] and stats["crc_slices"] >= stats["frames"]


def test_fixture_directory_size():
    """The FFV1 fixtures stay under 3 MB together (the 960x540 clip: 4 RGB frames at about 680 kB each)."""
    assert sum(p.stat().st_size for p in pathlib.Path(FIXTURES).iterdir()) <= 3_000_000


# --- FFmpeg's ffv1 encoder with every option --------------------------------------------------


def _frames(pix_fmt, w, h, n, seed):
    """``n`` frames of ``pix_fmt`` planes: a ramp that moves, a third of the samples noise, the top quarter flat
    (runs for the Golomb-Rice coder)."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        planes = []
        for k, (rows, width) in enumerate(plane_shapes(pix_fmt, w, h)):
            yy, xx = np.mgrid[:rows, :width]
            ramp = ((3 * xx + 5 * yy + 7 * i + 40 * k) % 256).astype(np.uint8)
            noise = rng.integers(0, 256, (rows, width), dtype=np.uint8)
            plane = np.where(rng.random((rows, width)) < 0.3, noise, ramp)
            plane[:(rows + 3) // 4] = 100 + k
            planes.append(plane)
        frames.append(planes)
    return frames


def _by_channel(pix_fmt, planes):
    """FFmpeg's planes in the decoder's order: Y U V A, or G B R A; grey Y (A)."""
    if pix_fmt in ("bgr0", "bgra"):
        bgra = planes[0].reshape(planes[0].shape[0], -1, 4)
        return [bgra[..., 1], bgra[..., 0], bgra[..., 2]] + ([bgra[..., 3]] if pix_fmt == "bgra" else [])
    if pix_fmt == "ya8":
        ya = planes[0].reshape(planes[0].shape[0], -1, 2)
        return [ya[..., 0], ya[..., 1]]
    return planes


# (pixel format, size, encoder options, decoder counts the stream must reach)
FEATURES = {
    "v0_gray": ("gray", (33, 19), {"level": 0, "g": 1}, ("version_0", "grey", "coder_golomb", "runs")),
    "v1_yuv420_gop": ("yuv420p", (33, 19), {"level": 1, "g": 3}, ("version_1", "yuv420", "non_key_frames")),
    "v1_range_tab": ("yuv444p", (20, 13), {"level": 1, "coder": "range_tab", "g": 2},
                     ("version_1", "coder_range_custom", "non_key_frames")),
    "v2_slices": ("yuv420p", (64, 48), {"level": 2, "strict": -2, "slices": 4},
                  ("version_2", "multi_slice_frames")),
    "v2_rgb_range_tab": ("bgr0", (65, 49), {"level": 2, "strict": -2, "coder": "range_tab", "slices": 6},
                         ("version_2", "rgb", "coder_range_custom")),
    "v3_yuv422_slices": ("yuv422p", (33, 19), {"level": 3, "slices": 4}, ("version_3", "yuv422", "crc_slices",
                                                                          "multi_slice_frames")),
    "v3_yuv410_large_context": ("yuv410p", (37, 21), {"level": 3, "coder": "range_def", "context": 1},
                                ("coder_range_default", "large_context_frames", "yuv410")),
    "v3_yuv411_rice_large_context": ("yuv411p", (33, 19), {"level": 3, "coder": "rice", "context": 1, "slices": 6},
                                     ("coder_golomb", "large_context_frames", "yuv411")),
    "v3_yuv440_range_tab": ("yuv440p", (32, 19), {"level": 3, "coder": "range_tab"},
                            ("coder_range_custom", "yuv440")),
    "v3_yuva420": ("yuva420p", (33, 19), {"level": 3, "g": 4}, ("yuv_alpha", "non_key_frames")),
    "v3_yuva444_range": ("yuva444p", (21, 17), {"level": 3, "coder": "range_def", "slices": 4},
                         ("yuv_alpha", "coder_range_default")),
    "v3_yuva422_rice": ("yuva422p", (34, 18), {"level": 3, "slices": 4}, ("yuv_alpha", "coder_golomb")),
    "v3_bgra_many_slices": ("bgra", (97, 61), {"level": 3, "slices": 16, "g": 5}, ("rgb_alpha",
                                                                                   "multi_slice_frames")),
    "v3_bgr0_no_crc": ("bgr0", (16, 9), {"level": 3, "slicecrc": 0}, ("rgb", "version_3")),
    "v3_grey_alpha": ("ya8", (31, 17), {"level": 3, "context": 1}, ("grey_alpha", "large_context_frames")),
    "v1_yuv420_tiny": ("yuv420p", (3, 5), {"level": 1}, ("version_1", "yuv420")),
    "v3_default_960": ("yuv420p", (960, 540), {}, ("version_3", "multi_slice_frames", "runs")),
}


@pytest.mark.parametrize("feature", list(FEATURES))
def test_encoder_features_equal_ffmpeg_and_videocapture(tmp_path, feature):
    """The encoder's stream with ``feature``: the port's planes are FFmpeg's decoder's, its BGR swscale's of
    those planes and, through an AVI, cv2.VideoCapture's; the feature reached by the decoder's counts."""
    pix_fmt, (w, h), options, reaches = FEATURES[feature]
    n = 2 if w * h > 100_000 else 5
    payloads, config = torch_libav.encode("ffv1", _frames(pix_fmt, w, h, n, seed=len(feature)), pix_fmt, w, h,
                                          options)
    theirs = torch_libav.decode_planes("ffv1", payloads, pix_fmt, w, h, config)
    decoder, ours = Ffv1Decoder(config, w, h), []
    for payload, planes in zip(payloads, theirs):
        ours += decoder.decode(payload)
        mine = decoder.planes()
        assert len(mine) == len(_by_channel(pix_fmt, planes))
        assert all(np.array_equal(a, b) for a, b in zip(mine, _by_channel(pix_fmt, planes)))
        assert np.array_equal(ours[-1], sws_bgr(pix_fmt, planes, w, h))
    path = str(tmp_path / f"{feature}.avi")
    write_avi(path, payloads, w, h, b"FFV1", config)
    _equal(read_video_frames(path), capture(path))
    stats = decoder.stats
    assert stats["frames"] == len(payloads) and ours[0].shape == (h, w, 3)
    reached = {k: stats[k] for k in reaches}
    assert all(reached.values()), reached


# --- what the decoder refuses -------------------------------------------------------------------


def test_refusals_name_what_they_are(tmp_path):
    """10 bits a sample and version 4 raise NotImplementedError naming them, through the loader too; a slice
    whose CRC fails raises ValueError naming the slice; a non-key frame first, ValueError."""
    frames = [[np.zeros(s, np.uint8) for s in plane_shapes("yuv420p10le", 32, 16)]]
    payloads, config = torch_libav.encode("ffv1", frames, "yuv420p10le", 32, 16, {"level": 3})
    with pytest.raises(NotImplementedError, match="10 bits a sample"):
        Ffv1Decoder(config, 32, 16)
    path = str(tmp_path / "ten_bits.avi")
    write_avi(path, payloads, 32, 16, b"FFV1", config)
    with pytest.raises(NotImplementedError, match="10 bits a sample"):
        read_video_frames(path)
    _, config = torch_libav.encode("ffv1", _frames("yuv420p", 32, 16, 1, 0), "yuv420p", 32, 16,
                                   {"level": 4, "strict": -2})
    with pytest.raises(NotImplementedError, match="version 4"):
        Ffv1Decoder(config, 32, 16)
    payloads, config = torch_libav.encode("ffv1", _frames("yuv420p", 32, 16, 2, 0), "yuv420p", 32, 16,
                                          {"level": 3, "slices": 4, "g": 2})
    damaged = bytearray(payloads[1])
    damaged[5] ^= 1  # inside slice 0
    decoder = Ffv1Decoder(config, 32, 16)
    decoder.decode(payloads[0])
    with pytest.raises(ValueError, match="slice 0 of frame 1 fails its CRC"):
        decoder.decode(bytes(damaged))
    with pytest.raises(ValueError, match="non-key frame before the first key frame"):
        Ffv1Decoder(config, 32, 16).decode(payloads[1])


# --- the loader and the resolver against the JAX package's ---------------------------------------


def test_loader_matches_jax(tmp_path):
    """The port's VideoLoader and the JAX one (cv2.VideoCapture) on the same FFV1 .mkv, float64, equal."""
    path = str(tmp_path / "clip.mkv")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 10, (40, 24))
    base = _scene(24, 46, 7)
    for i in range(6):
        writer.write(np.ascontiguousarray(base[:, i:i + 40]))
    writer.release()
    for max_frames in (0, 4):
        ours, theirs = VideoLoader(**CPU), JVideoLoader()
        ours.load_frames_from_video(path, max_frames)
        theirs.load_frames_from_video(path, max_frames)
        assert ours.num_frames == theirs.num_frames == (max_frames or 6)
        assert ours.image_size == theirs.image_size == (40, 24)
        stack = ours.frame_stack()
        assert stack.dtype == torch.float64 and stack.device.type == "cpu"
        np.testing.assert_array_equal(stack.numpy(), theirs.frame_stack())


def test_super_resolver_matches_jax_on_decoded_frames(tmp_path):
    """The JAX and the port's VideoSuperResolver on the port's decode of an FFV1 .mkv (window 3, no blur),
    to 1e-8 of the largest entry."""
    path = str(tmp_path / "clip.mkv")
    rng = np.random.default_rng(21)
    base = np.clip(cv2.GaussianBlur(rng.uniform(0, 255, (64, 64, 3)), (0, 0), 2.0) * 3 - 256, 0, 255).astype(np.uint8)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 10, (24, 24))
    for i in range(4):
        writer.write(np.ascontiguousarray(base[i:i + 24, 2 * i:2 * i + 24]))
    writer.release()
    loader = VideoLoader(**CPU)
    loader.load_frames_from_video(path)
    frames = loader.frame_stack().numpy()
    assert frames.shape == (4, 3, 24, 24)
    kwargs = dict(scale=2, temporal_window=3, blur_radius=0)
    theirs = np.asarray(JVideoSuperResolver(**kwargs).super_resolve(frames))
    ours = VideoSuperResolver(**kwargs, **CPU).super_resolve(torch.from_numpy(frames)).numpy()
    assert ours.shape == theirs.shape == (4, 3, 48, 48)
    assert np.abs(ours - theirs).max() <= 1e-8 * np.abs(theirs).max()


def test_stats_names_match_the_native_counts():
    decoder = Ffv1Decoder(b"", 8, 8)
    assert decoder.size == (8, 8) and set(decoder.stats.values()) == {0}
    payloads, config = torch_libav.encode("ffv1", _frames("gray", 8, 8, 1, 0), "gray", 8, 8, {"level": 1})
    assert config == b""
    assert decoder.decode(payloads[0])[0].shape == (8, 8, 3)
    assert decoder.stats["frames"] == decoder.stats["key_frames"] == decoder.stats["grey"] == 1
    assert len(STATS) == len(decoder.stats)
