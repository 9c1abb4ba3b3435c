"""VP8 video in the port (``utils/vp8.py`` over ``native/vp8_decoder.cpp``
and ``native/vp8_core.h``; ``video/ivf.py``; the WebM / Matroska / AVI / IVF
routing of ``video/video_loader.py``), held against ``cv2.VideoCapture`` --
the JAX package's video path, FFmpeg's VP8 decoder -- on the same files.

Every frame is array-equal to cv2.VideoCapture's, frame count included: the
checked-in clips ``cv2.VideoWriter`` writes with ``VP80`` (WebM, Matroska,
AVI, IVF; 960x540, a height off the macroblock grid; a pan with a noise
frame; a square that moves on its own), each of them reaching what it was
made for (NEWMV, SPLITMV, intra macroblocks in inter frames, the golden and
altref references); their frame tags rewritten to versions 1, 2 and 3
(bilinear prediction, full-pixel chroma) and to a hidden inter frame; and
streams of random syntax from ``torch_vp8_writer.py`` (segmentation with maps
kept and updated, ``refresh_entropy_probs = 0``, sign bias, 2-8 token
partitions, loop-filter deltas, vectors far outside the picture, hidden
frames, reference copies, every inter mode, coefficients past the 16 bits of
FFmpeg's x86 transforms), each held to cv2 and to the modes the writer
meant. What the decoder refuses raises
``NotImplementedError`` naming it. The loader matches the JAX loader in
float64; the resolver matches the JAX resolver on the decoded frames to
1e-8 of the largest entry.
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

from super_resolution_tpu_torch.utils.vp8 import Vp8Decoder
from super_resolution_tpu_torch.video import VideoLoader, VideoSuperResolver
from super_resolution_tpu_torch.video.ivf import read_ivf_video
from super_resolution_tpu_torch.video.mkv import read_matroska_video
from super_resolution_tpu_torch.video.video_loader import _frame_payloads, read_video_frames

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_vp8_writer import FEATURES, Vp8Writer, ivf  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data_torch", "video")
CPU = dict(device="cpu", dtype=torch.float64)
PAN = "vp8_160x120x40.webm"
SPLIT = "vp8_96x64x16.webm"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


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
    decoder, frames = Vp8Decoder(), []
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
    return read_matroska_video(data).frames


# --- the checked-in clips cv2.VideoWriter writes ---------------------------------------------

# What each clip was made to reach: NEWMV, SPLITMV, intra macroblocks in inter frames, golden and altref references.
REACHES = {"vp8_960x540x12.webm": ("NEWMV", "SPLITMV", "golden_mbs", "altref_mbs"),
           PAN: ("NEWMV", "SPLITMV", "intra_in_inter", "golden_mbs", "altref_mbs", "second_key_frame"),
           SPLIT: ("NEWMV", "SPLITMV", "split_16x8", "split_8x16", "split_8x8", "split_4x4", "intra_in_inter")}


@pytest.mark.parametrize("name", ["vp8_960x540x12.webm", PAN, "vp8_160x120x40.mkv", "vp8_160x120x40.avi",
                                  "vp8_160x120x40.ivf", SPLIT])
def test_fixtures_equal_videocapture(name):
    """Each fixture through read_video_frames is cv2.VideoCapture's, and its stream reaches what the clip
    was made for (the decoder's counts), so that cv2's encoder cannot drop it unseen."""
    path = os.path.join(FIXTURES, name)
    entry = _manifest()[name]
    assert hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest() == entry["sha256"]
    ours = read_video_frames(path)
    _assert_equal_to_capture(path, ours)
    assert list(np.stack(ours).shape) == entry["shape"]
    frames, stats = _decode(_payloads(name))
    assert all(np.array_equal(a, b) for a, b in zip(frames, ours))
    mbs_per_frame = sum(stats[k] for k in ("intra_mbs", "last_mbs", "golden_mbs", "altref_mbs")) // stats["frames"]
    stats["intra_in_inter"] = stats["intra_mbs"] - stats["key_frames"] * mbs_per_frame
    stats["second_key_frame"] = stats["key_frames"] - 1
    reached = {k: stats[k] for k in REACHES.get(name.replace(name[name.rindex("."):], ".webm"), ())}
    assert all(reached.values()), reached
    assert len(read_video_frames(path, max_frames=5)) == 5


# --- the same streams with their frame tags rewritten -----------------------------------------


def _rewritten(tmp_path, name, change):
    """The fixture's frames, each rewritten by ``change(index, frame)``, in an IVF file."""
    width, height = _manifest()[name]["shape"][2:0:-1]
    frames = [change(i, f) for i, f in enumerate(_payloads(name))]
    path = str(tmp_path / f"{name}.ivf")
    pathlib.Path(path).write_bytes(ivf(frames, width, height))
    return path, frames


@pytest.mark.parametrize("name", [PAN, SPLIT])
@pytest.mark.parametrize("version", [1, 2, 3])
def test_versions_equal_videocapture(tmp_path, name, version):
    """Every frame tag set to version 1 or 2 (bilinear prediction) or 3 (bilinear, full-pixel chroma)."""
    path, frames = _rewritten(tmp_path, name, lambda i, f: bytes([f[0] & ~0x0E | version << 1]) + f[1:])
    ours, stats = _decode(frames)
    _assert_equal_to_capture(path, ours)
    assert stats[f"version_{version}"] == len(frames) == len(ours)
    assert read_video_frames(path)[-1].tobytes() == ours[-1].tobytes()


def test_hidden_frame_equals_videocapture(tmp_path):
    """``show_frame`` cleared on an inter frame that refreshes the golden reference: decoded and kept as a
    reference, not shown -- one frame fewer, the others cv2.VideoCapture's."""
    _, stats = _decode(_payloads(PAN)[:12])
    assert stats["golden_refreshes"]
    hidden = 6
    path, frames = _rewritten(tmp_path, PAN, lambda i, f: bytes([f[0] & ~0x10]) + f[1:] if i == hidden else f)
    assert frames[hidden][0] & 1  # an inter frame
    ours, stats = _decode(frames)
    _assert_equal_to_capture(path, ours)
    assert len(ours) == len(frames) - 1 and stats["hidden_frames"] == 1


# --- streams of random syntax ----------------------------------------------------------------

# What each stream is meant to reach, by the decoder's counts.
WRITER_REACHES = {
    "segmentation": ("segmented_frames", "segment_map_updates", "segment_maps_kept", "segment_data_updates"),
    "entropy": ("entropy_not_refreshed",),
    "sign_bias": ("sign_bias_golden", "sign_bias_altref"),
    "partitions": ("partitions_2", "partitions_4", "partitions_8"),
    "lf_deltas": ("lf_delta_updates", "simple_filter_frames", "normal_filter_frames"),
    "far_mvs": ("mbs_far_outside",),
    "hidden": ("hidden_frames",),
    "copies": ("golden_from_last", "golden_from_altref", "altref_from_last", "altref_from_golden"),
    "large_coefficients": ("mbs_large_coefficients",),
}
MODE_COUNTS = ("DC_PRED", "V_PRED", "H_PRED", "TM_PRED", "B_PRED", "ZEROMV", "NEARESTMV", "NEARMV", "NEWMV",
               "SPLITMV", "intra_mbs", "last_mbs", "golden_mbs", "altref_mbs")


def _writer_stream(tmp_path, seed, features, version=0, width=72, height=40, frames=12):
    rng = np.random.default_rng(seed)
    writer = Vp8Writer(width, height, rng, features, version)
    payloads = [writer.frame(key=i == frames // 2, show=not ("hidden" in features and i % 5 == 3))
                for i in range(frames)]
    path = str(tmp_path / f"random_{seed}.ivf")
    pathlib.Path(path).write_bytes(ivf(payloads, width, height))
    return path, payloads, writer


@pytest.mark.parametrize("feature", FEATURES)
def test_writer_feature_equals_videocapture(tmp_path, feature):
    """One feature at a time: array-equal to cv2.VideoCapture, the feature reached, the modes those written."""
    path, payloads, writer = _writer_stream(tmp_path, FEATURES.index(feature) + 1, (feature,))
    ours, stats = _decode(payloads)
    _assert_equal_to_capture(path, ours)
    reached = {k: stats[k] for k in WRITER_REACHES[feature]}
    assert all(reached.values()), reached
    assert {k: stats[k] for k in MODE_COUNTS} == {k: writer.counts.get(k, 0) for k in MODE_COUNTS}


@pytest.mark.parametrize("seed,version,size", [(11, 0, (72, 40)), (12, 1, (48, 48)), (13, 2, (40, 56)),
                                               (14, 3, (72, 40)), (15, 0, (24, 16))])
def test_writer_everything_equals_videocapture(tmp_path, seed, version, size):
    """Every feature at once, versions 0-3, sizes on and off the macroblock grid (down to 2 x 1
    macroblocks); streams of 12 macroblocks a frame or more reach every inter mode and B_PRED."""
    path, payloads, writer = _writer_stream(tmp_path, seed, FEATURES, version, *size)
    ours, stats = _decode(payloads)
    _assert_equal_to_capture(path, ours)
    assert stats[f"version_{version}"] == len(payloads)
    assert {k: stats[k] for k in MODE_COUNTS} == {k: writer.counts.get(k, 0) for k in MODE_COUNTS}
    if writer.mb_w * writer.mb_h >= 12:
        assert all(stats[k] for k in ("ZEROMV", "NEARESTMV", "NEARMV", "NEWMV", "SPLITMV", "B_PRED"))


@pytest.mark.parametrize("seed,size", [(41, (61, 37)), (42, (9, 17)), (43, (72, 41))])
def test_writer_odd_heights_equal_videocapture(tmp_path, seed, size):
    """Frames of odd height, every feature: array-equal to cv2.VideoCapture, which converts them through
    swscale's bicubic scaler (native/swscale_bgr.h), not its unscaled converter."""
    path, payloads, writer = _writer_stream(tmp_path, seed, FEATURES, 0, *size)
    ours, stats = _decode(payloads)
    _assert_equal_to_capture(path, ours)
    assert ours[0].shape == (size[1], size[0], 3)
    assert {k: stats[k] for k in MODE_COUNTS} == {k: writer.counts.get(k, 0) for k in MODE_COUNTS}


# --- what the decoder refuses ------------------------------------------------------------------


def _key_frame(writer_kwargs=None, **frame):
    writer = Vp8Writer(32, 32, np.random.default_rng(3), (), **(writer_kwargs or {}))
    return writer.frame(**frame)


REFUSALS = {
    "VP8 version 4": lambda: [bytes([_key_frame()[0] | 4 << 1]) + _key_frame()[1:]],
    "frame scaling": lambda: [_key_frame(scale=1)],
    "colour space 1": lambda: [_key_frame(colour_space=1)],
    "clamping_type 1": lambda: [_key_frame(clamping_type=1)],
    "frame size that changes mid-stream": lambda: [_key_frame(), Vp8Writer(48, 32, np.random.default_rng(3),
                                                                           ()).frame()],
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_refusals_name_what_they_are(tmp_path, what):
    path = str(tmp_path / "refused.ivf")
    pathlib.Path(path).write_bytes(ivf(REFUSALS[what](), 32, 32))
    with pytest.raises(NotImplementedError, match=what):
        read_video_frames(path)


def test_other_ivf_codecs_and_corrupt_streams(tmp_path):
    path = str(tmp_path / "av1.ivf")
    pathlib.Path(path).write_bytes(ivf([_key_frame()], 32, 32, fourcc=b"AV01"))
    with pytest.raises(NotImplementedError, match="IVF video of AV1"):
        read_video_frames(path)
    inter = Vp8Writer(32, 32, np.random.default_rng(3), ())
    inter.frame()
    with pytest.raises(ValueError, match="before the first key frame"):
        Vp8Decoder().decode(inter.frame())
    with pytest.raises(ValueError, match="first partition that runs past the frame"):
        Vp8Decoder().decode(_key_frame()[:12])
    pathlib.Path(path).write_bytes(ivf([_key_frame()], 32, 32)[:-3])
    with pytest.raises(ValueError, match="runs past the end"):
        read_video_frames(path)


# --- the loader and the resolver against the JAX package's ---------------------------------------


def test_loader_matches_jax():
    """The port's VideoLoader and the JAX one (cv2.VideoCapture) on the same .webm, float64, equal."""
    path = os.path.join(FIXTURES, SPLIT)
    for max_frames in (0, 5):
        ours, theirs = VideoLoader(**CPU), JVideoLoader()
        ours.load_frames_from_video(path, max_frames)
        theirs.load_frames_from_video(path, max_frames)
        assert ours.num_frames == theirs.num_frames == (max_frames or 16)
        assert ours.image_size == theirs.image_size == (96, 64)
        stack = ours.frame_stack()
        assert stack.dtype == torch.float64 and stack.device.type == "cpu"
        np.testing.assert_array_equal(stack.numpy(), theirs.frame_stack())


def test_super_resolver_matches_jax_on_decoded_frames(tmp_path):
    """The JAX and the port's VideoSuperResolver on the port's decode of a VP8 .webm (window 3, no blur),
    to 1e-8 of the largest entry."""
    path = str(tmp_path / "clip.webm")
    rng = np.random.default_rng(21)
    base = np.clip(cv2.GaussianBlur(rng.uniform(0, 255, (64, 64, 3)), (0, 0), 2.0) * 3 - 256, 0, 255).astype(np.uint8)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"VP80"), 10, (24, 24))
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
    decoder = Vp8Decoder()
    assert decoder.size == (0, 0) and set(decoder.stats.values()) == {0}
    frames = decoder.decode(_key_frame())
    assert frames[0].shape == (32, 32, 3) and decoder.size == (32, 32)
    assert decoder.stats["frames"] == decoder.stats["key_frames"] == 1
