"""VP9 video in the port (``utils/vp9.py`` over ``native/vp9_decoder.cpp``; the
WebM / Matroska / IVF / AVI / MP4 routing of ``video/video_loader.py``), held
against ``cv2.VideoCapture`` -- the JAX package's video path, FFmpeg's VP9
decoder -- on the same files.

Every frame is array-equal to cv2.VideoCapture's, frame count included: the
checked-in clips ``cv2.VideoWriter`` writes with ``VP90`` (``tests/data_torch/vp9``:
960x540 with two tile columns; a pan with a noise frame and a square of its
own motion in .webm, .ivf and .mp4; a smaller pan in .mkv and .avi), each
reaching what it was made for; streams libvpx writes through FFmpeg's
``libvpx-vp9`` encoder with the tools OpenCV leaves off (backward adaptation,
segmentation with temporal prediction, lossless, tile rows and columns,
error resilience, the realtime speed's transform selection); and streams of
random syntax from ``torch_vp9_writer.py`` (backward adaptation,
segmentation with every feature, intra-only, hidden and shown-again frames,
superframes, compound prediction fixed and selected, each interpolation
filter, lossless, tiles, the four contexts and their resets, error
resilience, loop-filter deltas and sharpness, vectors far outside the
picture, odd sizes), each held to cv2 and to the symbols the writer meant.
cv2.VideoCapture converts a frame of odd height through swscale's bicubic
scaler (``native/swscale_bgr.h``): those frames are held to FFmpeg's decoded
planes and to cv2's BGR. What the decoder refuses raises ``NotImplementedError``
naming it. The loader matches the JAX loader in float64; the resolver matches
the JAX resolver on the decoded frames to 1e-8 of the largest entry.
"""

import ctypes
import glob
import hashlib
import json
import os
import pathlib
import struct
import sys

import cv2
import numpy as np
import pytest
import torch

from super_resolution_tpu.video import VideoLoader as JVideoLoader
from super_resolution_tpu.video import VideoSuperResolver as JVideoSuperResolver

from super_resolution_tpu_torch.utils.vp9 import STATS, Vp9Decoder
from super_resolution_tpu_torch.video import VideoLoader, VideoSuperResolver
from super_resolution_tpu_torch.video.ivf import read_ivf_video
from super_resolution_tpu_torch.video.mkv import read_matroska_video
from super_resolution_tpu_torch.video.mp4 import read_mp4_video
from super_resolution_tpu_torch.video.video_loader import _frame_payloads, read_video_frames

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_libav import libavcodec as _libavcodec  # noqa: E402
from torch_vp9_writer import FEATURES, BitWriter, Vp9Writer, ivf  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data_torch", "vp9")
CPU = dict(device="cpu", dtype=torch.float64)
FULL = "vp9_960x540x12.webm"
PAN = "vp9_160x120x24.webm"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _built():
    Vp9Decoder()  # builds native/vp9_decoder.cpp once for the module


def _capture(path):
    capture, frames = cv2.VideoCapture(path), []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(frame)
    capture.release()
    return frames


def _assert_equal_to_capture(path, ours):
    theirs = _capture(path)
    assert len(ours) == len(theirs) > 0
    gaps = [int(np.abs(a.astype(int) - b.astype(int)).max()) for a, b in zip(ours, theirs)]
    assert gaps == [0] * len(gaps), f"per-frame max gap {gaps}"


def _decode(payloads):
    decoder, frames = Vp9Decoder(), []
    for payload in payloads:
        frames += decoder.decode(payload)
    return frames, decoder.stats


def _manifest():
    return json.loads(pathlib.Path(FIXTURES, "manifest.json").read_text())


def _payloads(name):
    data = pathlib.Path(FIXTURES, name).read_bytes()
    if name.endswith(".ivf"):
        return read_ivf_video(data).frames
    if name.endswith(".avi"):
        return _frame_payloads(data, 0, 0)
    if name.endswith(".mp4"):
        return read_mp4_video(data).samples
    return read_matroska_video(data).frames


# --- the checked-in clips cv2.VideoWriter writes ---------------------------------------------

REACHES = {FULL: ("tile_col_frames", "NEWMV", "sub8x8_blocks", "refresh_slot_1", "high_precision_frames",
                  "switchable_filter_frames"),
           PAN: ("NEWMV", "NEARMV", "sub8x8_blocks", "refresh_slot_1", "intra_blocks_in_inter_frames",
                 "second_key_frame",
                 "tx_32x32")}


@pytest.mark.parametrize("name", [FULL, PAN, "vp9_160x120x24.ivf", "vp9_160x120x24.mp4", "vp9_96x64x10.mkv",
                                  "vp9_96x64x10.avi"])
def test_fixtures_equal_videocapture(name):
    """Each fixture through read_video_frames is cv2.VideoCapture's, and its stream reaches what the clip was
    made for (the decoder's counts), so that cv2's encoder cannot drop it unseen."""
    path = os.path.join(FIXTURES, name)
    entry = _manifest()[name]
    assert hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest() == entry["sha256"]
    ours = read_video_frames(path)
    assert hashlib.sha256(np.stack(ours).tobytes()).hexdigest() == entry["frames_sha256"]
    _assert_equal_to_capture(path, ours)
    assert list(np.stack(ours).shape) == entry["shape"]
    frames, stats = _decode(_payloads(name))
    assert all(np.array_equal(a, b) for a, b in zip(frames, ours))
    stats["second_key_frame"] = stats["key_frames"] - 1
    reached = {k: stats[k] for k in REACHES.get(name.replace(name[name.rindex("."):], ".webm"), ())}
    assert all(reached.values()), reached
    assert len(read_video_frames(path, max_frames=5)) == 5


def test_fixture_directory_size():
    """The VP9 fixtures stay small: at most 300 kB together."""
    assert sum(p.stat().st_size for p in pathlib.Path(FIXTURES).iterdir()) <= 300_000


# --- libvpx with the tools OpenCV leaves off, through FFmpeg's libvpx-vp9 encoder ---------------


def _libvpx_encode(frames, options):
    """The VP9 payloads FFmpeg's libvpx-vp9 encoder writes for BGR ``frames`` with AVOptions ``options``, through
    libavcodec's C API: the AVFrame fields used are ``data`` / ``linesize`` / ``width`` / ``height`` / ``format`` /
    ``pts`` (byte offsets 0 / 64 / 104 / 108 / 116 / 136), the AVPacket's ``data`` / ``size`` (24 / 32)."""
    avutil, avcodec = _libavcodec()
    h, w = frames[0].shape[:2]
    codec = avcodec.avcodec_find_encoder_by_name(b"libvpx-vp9")
    assert codec, "no libvpx-vp9 encoder in cv2's FFmpeg"
    ctx = avcodec.avcodec_alloc_context3(codec)
    settings = {"video_size": f"{w}x{h}", "pixel_format": "yuv420p", "time_base": "1/10", "deadline": "good",
                "cpu-used": "4", "b": "300k", **options}
    for key, value in settings.items():
        assert avutil.av_opt_set(ctx, key.encode(), value.encode(), 1) >= 0, key
    assert avcodec.avcodec_open2(ctx, codec, None) == 0
    frame, packet = avutil.av_frame_alloc(), avcodec.av_packet_alloc()
    ctypes.memmove(frame + 104, struct.pack("<ii", w, h), 8)
    ctypes.memmove(frame + 116, struct.pack("<i", 0), 4)  # AV_PIX_FMT_YUV420P
    assert avutil.av_frame_get_buffer(frame, 0) == 0
    payloads = []

    def drain():
        while avcodec.avcodec_receive_packet(ctx, packet) == 0:
            data, size = struct.unpack("<Qi", ctypes.string_at(packet + 24, 12))
            payloads.append(ctypes.string_at(data, size))
            avcodec.av_packet_unref(packet)

    for i, bgr in enumerate(frames):
        i420 = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420)
        planes = (i420[:h], i420[h:h + h // 4].reshape(h // 2, w // 2), i420[h + h // 4:].reshape(h // 2, w // 2))
        assert avutil.av_frame_make_writable(frame) == 0
        head = ctypes.string_at(frame, 96)
        data, linesize = struct.unpack("<8Q", head[:64]), struct.unpack("<8i", head[64:])
        for k, plane in enumerate(planes):
            for row in range(plane.shape[0]):
                ctypes.memmove(data[k] + row * linesize[k], plane[row].tobytes(), plane.shape[1])
        ctypes.memmove(frame + 136, struct.pack("<q", i), 8)
        assert avcodec.avcodec_send_frame(ctx, frame) == 0
        drain()
    avcodec.avcodec_send_frame(ctx, None)
    drain()
    return payloads


def _ffmpeg_planes(payloads):
    """The Y, U, V planes FFmpeg's VP9 decoder (cv2.VideoCapture's) gives for each frame ``payloads`` show."""
    avutil, avcodec = _libavcodec()
    codec = avcodec.avcodec_find_decoder_by_name(b"vp9")
    ctx = avcodec.avcodec_alloc_context3(codec)
    assert avcodec.avcodec_open2(ctx, codec, None) == 0
    packet, frame, out = avcodec.av_packet_alloc(), avutil.av_frame_alloc(), []

    def drain():
        while avcodec.avcodec_receive_frame(ctx, frame) == 0:
            head = ctypes.string_at(frame, 112)
            data, linesize = struct.unpack("<8Q", head[:64]), struct.unpack("<8i", head[64:96])
            w, h = struct.unpack("<ii", head[104:112])
            planes = []
            for k, (pw, ph) in enumerate([(w, h)] + [((w + 1) // 2, (h + 1) // 2)] * 2):
                rows = np.frombuffer(ctypes.string_at(data[k], linesize[k] * ph), np.uint8).reshape(ph, linesize[k])
                planes.append(rows[:, :pw].copy())
            out.append(planes)
            avutil.av_frame_unref(frame)

    for payload in payloads:
        assert avcodec.av_new_packet(packet, len(payload)) == 0
        ctypes.memmove(struct.unpack("<Q", ctypes.string_at(packet + 24, 8))[0], payload, len(payload))
        assert avcodec.avcodec_send_packet(ctx, packet) == 0
        avcodec.av_packet_unref(packet)
        drain()
    avcodec.avcodec_send_packet(ctx, None)
    drain()
    return out


def _pan(w, h, n, seed, step=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w + step * n].astype(np.float64)
    base = np.stack([128 + 60 * np.sin(xx / (7.0 + c)) * np.cos(yy / 11.0) for c in range(3)], -1)
    for _ in range(8):
        cy, cx, r = rng.integers(0, h), rng.integers(0, w + step * n), rng.integers(4, 16)
        base[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.integers(0, 256, 3)
    base = np.clip(base + rng.normal(0, 3, base.shape), 0, 255).astype(np.uint8)
    return [base[:, step * i:step * i + w].copy() for i in range(n)]


# A pan of 11 pixels a frame under backward adaptation: vectors past 8 pixels, whose high-precision bit is not
# coded but still counted for the adaptation.
LIBVPX_TOOLS = {
    "backward_adaptation": ({"frame-parallel": "0"}, ("adapted_frames",)),
    "segmentation_variance": ({"aq-mode": "1", "frame-parallel": "0"}, ("segmented_frames", "segment_alt_q")),
    "segmentation_cyclic": ({"aq-mode": "3", "frame-parallel": "0"}, ("segment_temporal_updates",)),
    "lossless": ({"lossless": "1"}, ("lossless_frames",)),
    "tiles": ({"tile-columns": "2", "tile-rows": "2", "frame-parallel": "0"}, ("tile_col_frames", "tile_row_frames")),
    "error_resilient": ({"error-resilient": "1"}, ("error_resilient_frames",)),
    "realtime": ({"deadline": "realtime", "cpu-used": "8", "b": "100k", "frame-parallel": "0"},
                 ("tx_select_frames", "adapted_frames")),
}


@pytest.mark.parametrize("tool", list(LIBVPX_TOOLS))
def test_libvpx_tools_equal_videocapture(tmp_path, tool):
    """libvpx's own streams with a tool cv2.VideoWriter leaves off: array-equal to cv2.VideoCapture, the tool
    reached."""
    options, reaches = LIBVPX_TOOLS[tool]
    w, h, n = (640, 360, 4) if tool == "tiles" else (160, 120, 12)
    payloads = _libvpx_encode(_pan(w, h, n, seed=len(tool), step=11 if tool == "backward_adaptation" else 3), options)
    path = str(tmp_path / f"{tool}.ivf")
    pathlib.Path(path).write_bytes(ivf(payloads, w, h))
    ours, stats = _decode(payloads)
    _assert_equal_to_capture(path, ours)
    assert read_video_frames(path)[-1].tobytes() == ours[-1].tobytes()
    reached = {k: stats[k] for k in reaches}
    assert all(reached.values()), reached


# --- streams of random syntax ----------------------------------------------------------------

# What each stream is meant to reach, by the decoder's counts.
WRITER_REACHES = {
    "adaptation": ("adapted_frames",),
    "segmentation": ("segmented_frames", "segment_map_updates", "segment_data_updates", "segment_alt_q",
                     "segment_alt_lf", "segment_ref", "segment_skip"),
    "intra_only": ("intra_only_frames", "hidden_frames"),
    "hidden": ("hidden_frames", "superframes", "shown_again"),
    "compound_fixed": ("compound_fixed_frames", "compound_blocks", "sign_bias_frames"),
    "compound_select": ("compound_select_frames", "compound_blocks"),
    "filters": ("filter_regular", "filter_smooth", "filter_sharp", "filter_bilinear"),
    "lossless": ("lossless_frames",),
    "tiles": ("tile_col_frames", "tile_row_frames"),
    "contexts": ("context_0", "context_1", "context_2", "context_3", "context_not_refreshed"),
    "error_resilient": ("error_resilient_frames",),
    "lf_deltas": ("lf_delta_updates", "sharp_frames"),
    "far_mvs": ("far_mv_blocks",),
    "odd_size": ("odd_size_frames",),
}
# The counts the writer keeps of what it wrote.
WRITTEN = tuple(k for k in STATS if k not in ("far_mv_blocks",) and not k.endswith("_frames") and
                not k.startswith(("segment", "context_", "reset_", "tx_select", "lf_"))) + (
    "frames", "key_frames", "inter_frames", "intra_only_frames", "hidden_frames", "tile_col_frames",
    "switchable_filter_frames", "intra_blocks_in_inter_frames")
WRITER_SIZES = {"tiles": (520, 200, 4), "odd_size": (61, 40, 12), "segmentation": (72, 40, 16)}
WRITER_SEEDS = {"adaptation": 1, "segmentation": 2, "intra_only": 3, "hidden": 4, "compound_fixed": 5,
                "compound_select": 6, "filters": 8, "lossless": 8, "tiles": 9, "contexts": 10, "error_resilient": 12,
                "lf_deltas": 12, "far_mvs": 13, "odd_size": 14}


def _writer_stream(tmp_path, seed, features, width=72, height=40, frames=12):
    writer = Vp9Writer(width, height, np.random.default_rng(seed), features)
    payloads = writer.stream(frames)
    path = str(tmp_path / f"random_{seed}.ivf")
    pathlib.Path(path).write_bytes(ivf(payloads, width, height))
    return path, payloads, writer


def _assert_written(stats, writer):
    assert {k: stats[k] for k in WRITTEN} == {k: writer.counts.get(k, 0) for k in WRITTEN}


@pytest.mark.parametrize("feature", FEATURES)
def test_writer_feature_equals_videocapture(tmp_path, feature):
    """One feature at a time: array-equal to cv2.VideoCapture, the feature reached, the symbols and blocks those
    written."""
    path, payloads, writer = _writer_stream(tmp_path, WRITER_SEEDS[feature], (feature,),
                                            *WRITER_SIZES.get(feature, (72, 40, 12)))
    ours, stats = _decode(payloads)
    _assert_equal_to_capture(path, ours)
    reached = {k: stats[k] for k in WRITER_REACHES[feature]}
    assert all(reached.values()), reached
    _assert_written(stats, writer)


@pytest.mark.parametrize("seed,size", [(21, (72, 40)), (22, (130, 72)), (23, (8, 8)), (24, (33, 18))])
def test_writer_everything_equals_videocapture(tmp_path, seed, size):
    """Every feature at once, at sizes on and off the 8-pixel grid (down to one 8x8 block)."""
    path, payloads, writer = _writer_stream(tmp_path, seed, FEATURES, *size, frames=16)
    ours, stats = _decode(payloads)
    _assert_equal_to_capture(path, ours)
    _assert_written(stats, writer)
    assert stats["adapted_frames"] and stats["hidden_frames"]


@pytest.mark.parametrize("seed,size", [(31, (61, 37)), (32, (9, 17)), (33, (72, 41))])
def test_writer_odd_heights_equal_ffmpeg_planes(tmp_path, seed, size):
    """Frames of odd height, every feature: the decoded planes are FFmpeg's, and the BGR frames
    cv2.VideoCapture's (which converts such frames through swscale's bicubic scaler, native/swscale_bgr.h)."""
    writer = Vp9Writer(*size, np.random.default_rng(seed), FEATURES)
    payloads = writer.stream(12)
    decoder, ours, bgr = Vp9Decoder(), [], []
    for payload in payloads:
        shown = decoder.decode(payload)
        bgr += shown
        ours += [decoder.planes(i) for i in range(len(shown))]
    theirs = _ffmpeg_planes(payloads)
    assert len(ours) == len(theirs) > 0
    assert all(np.array_equal(a, b) for x, y in zip(ours, theirs) for a, b in zip(x, y))
    path = str(tmp_path / f"odd_{seed}.ivf")
    pathlib.Path(path).write_bytes(ivf(payloads, *size))
    _assert_equal_to_capture(path, bgr)
    _assert_written(decoder.stats, writer)


# --- what the decoder refuses ------------------------------------------------------------------


def _key_frame(width=32, height=32):
    return Vp9Writer(width, height, np.random.default_rng(3), ()).frame(key=True)


def _with_byte(frame, index, value):
    return frame[:index] + bytes([frame[index] | value]) + frame[index + 1:]


def _inter_header(width, height):
    """An inter frame's header that gives its own size (no reference's), then zeros."""
    bw = BitWriter()
    for value, bits in ((2, 2), (0, 2), (0, 1), (1, 1), (1, 1), (0, 1), (0, 2), (1, 8)):
        bw.put(value, bits)
    for _ in range(3):
        bw.put(0, 4)  # slot 0, no sign bias
    bw.put(0, 3)  # no size from a reference
    bw.put(width - 1, 16)
    bw.put(height - 1, 16)
    return bw.data() + bytes(32)


REFUSALS = {
    "profile 1": lambda: [_with_byte(_key_frame(), 0, 0x20)],
    "profile 2": lambda: [_with_byte(_key_frame(), 0, 0x10)],
    "profile 3": lambda: [_with_byte(_key_frame(), 0, 0x30)],
    "color_space RGB": lambda: [_with_byte(_key_frame(), 4, 0xE0)],
    "color_range 1": lambda: [_with_byte(_key_frame(), 4, 0x10)],
    "scaled prediction": lambda: [_key_frame(), _inter_header(48, 32)],
    "frame size that changes mid-stream": lambda: [_key_frame(), _key_frame(48, 32)],
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_refusals_name_what_they_are(tmp_path, what):
    path = str(tmp_path / "refused.ivf")
    pathlib.Path(path).write_bytes(ivf(REFUSALS[what](), 32, 32))
    with pytest.raises(NotImplementedError, match=what):
        read_video_frames(path)


def test_mp4_vpcc_refusal(tmp_path):
    """An MP4 vp09 sample entry whose vpcC asks for profile 1."""
    data = bytearray(pathlib.Path(FIXTURES, "vp9_160x120x24.mp4").read_bytes())
    at = data.index(b"vpcC") + 8  # the box body after its version and flags
    assert data[at] == 0
    data[at] = 1
    path = tmp_path / "profile1.mp4"
    path.write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match="VP9 video of profile 1"):
        read_video_frames(str(path))


def test_other_ivf_codecs_and_corrupt_streams(tmp_path):
    path = str(tmp_path / "av1.ivf")
    pathlib.Path(path).write_bytes(ivf([_key_frame()], 32, 32, fourcc=b"AV01"))
    with pytest.raises(NotImplementedError, match="IVF video of AV1"):
        read_video_frames(path)
    writer = Vp9Writer(32, 32, np.random.default_rng(3), ())
    writer.frame(key=True)
    with pytest.raises(ValueError, match="before the first key frame"):
        Vp9Decoder().decode(writer.frame())
    with pytest.raises(ValueError, match="truncated frame header"):
        Vp9Decoder().decode(_key_frame()[:6])
    with pytest.raises(ValueError, match="bad frame marker"):
        Vp9Decoder().decode(bytes([0x42]) + _key_frame()[1:])
    with pytest.raises(ValueError, match="compressed header past the frame"):
        Vp9Decoder().decode(_key_frame()[:16])
    with pytest.raises(ValueError, match="show_existing_frame of an empty slot"):
        Vp9Decoder().decode(bytes([0x8B]))


# --- the loader and the resolver against the JAX package's ---------------------------------------


def test_loader_matches_jax():
    """The port's VideoLoader and the JAX one (cv2.VideoCapture) on the same .webm, float64, equal."""
    path = os.path.join(FIXTURES, PAN)
    for max_frames in (0, 5):
        ours, theirs = VideoLoader(**CPU), JVideoLoader()
        ours.load_frames_from_video(path, max_frames)
        theirs.load_frames_from_video(path, max_frames)
        assert ours.num_frames == theirs.num_frames == (max_frames or 24)
        assert ours.image_size == theirs.image_size == (160, 120)
        stack = ours.frame_stack()
        assert stack.dtype == torch.float64 and stack.device.type == "cpu"
        np.testing.assert_array_equal(stack.numpy(), theirs.frame_stack())


def test_super_resolver_matches_jax_on_decoded_frames(tmp_path):
    """The JAX and the port's VideoSuperResolver on the port's decode of a VP9 .webm (window 3, no blur),
    to 1e-8 of the largest entry."""
    path = str(tmp_path / "clip.webm")
    rng = np.random.default_rng(21)
    base = np.clip(cv2.GaussianBlur(rng.uniform(0, 255, (64, 64, 3)), (0, 0), 2.0) * 3 - 256, 0, 255).astype(np.uint8)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"VP90"), 10, (24, 24))
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
    decoder = Vp9Decoder()
    assert decoder.size == (0, 0) and set(decoder.stats.values()) == {0}
    frames = decoder.decode(_key_frame())
    assert frames[0].shape == (32, 32, 3) and decoder.size == (32, 32)
    assert decoder.stats["frames"] == decoder.stats["key_frames"] == 1
    assert [p.shape for p in decoder.planes()] == [(32, 32), (16, 16), (16, 16)]
