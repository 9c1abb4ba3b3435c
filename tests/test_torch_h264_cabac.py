"""High-profile H.264 without B slices in the port (``native/h264_decoder.cpp``
through ``utils/h264.py``): CABAC under each ``cabac_init_idc``, the 8x8
transform with intra 8x8 prediction, scaling matrices in the SPS and the PPS
(fall-back rules A and B, the default lists) and a second chroma QP offset
unlike the first.

Random streams of ``torch_h264_writer.py`` are held three ways: the BGR
frames array-equal to ``cv2.VideoCapture``'s (the JAX package's video path),
the YUV planes equal to libavcodec's, and the decoder's counts equal to those
the writer kept of what it wrote. A fixed set of streams reaches every new
count and codes with every ctxIdx that a progressive 4:2:0 I / P stream can
use, under each of the four initialisation tables (a wrong context value
shows only where a stream reaches it). The checked-in High-profile clip of
``tests/data_torch/h264`` decodes to the digest of cv2's frames; the JAX
loader (cv2) and the port's agree on it, and the JAX resolver and the port's
agree on the decoded frames of a small High-profile clip. What stays refused
raises ``NotImplementedError`` inside CABAC streams too; the CABAC streams
that B slices and FFmpeg's output order lifted from refusal decode to cv2's
frames (B slices themselves: test_torch_h264_b.py).
"""

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from super_resolution_tpu.video import VideoLoader as JVideoLoader
from super_resolution_tpu.video import VideoSuperResolver as JVideoSuperResolver

from super_resolution_tpu_torch.utils.h264 import STATS, H264Decoder
from super_resolution_tpu_torch.video import VideoLoader, VideoSuperResolver
from super_resolution_tpu_torch.video.mp4 import read_mp4_video
from super_resolution_tpu_torch.video.video_loader import read_video_frames

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_h264_tables import CABAC_INIT, LAST_8X8, SIG_8X8  # noqa: E402
from torch_h264_writer import (BitWriter, Options, Pps, Sps, StreamWriter, annexb, encode_frames, mp4,  # noqa: E402
                               nal_unit, random_stream)
from torch_libav import capture, decode_planes  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data_torch", "h264")
CLIP = "h264_high_960x540x12.mp4"
CPU = dict(device="cpu", dtype=torch.float64)
NEW_STATS = STATS[STATS.index("cabac_slices"):STATS.index("b_slices")]  # B slices' counts: test_torch_h264_b.py


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _built():
    H264Decoder()  # builds native/h264_decoder.cpp once for the module


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _assert_frames_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.shape == b.shape and np.array_equal(a, b), f"frame {i}: max |diff| {np.abs(a.astype(int) - b).max()}"


def _check_stream(tmp_path, name, aus, stats, size, planes=True):
    """The three checks: cv2's BGR frames, libavcodec's planes (a packet an access unit), the writer's counts."""
    data = annexb(aus)
    path = _write(tmp_path, name, data)
    decoder = H264Decoder()
    ours = [decoder.decode(annexb([au])) for au in aus]
    assert all(len(frames) == 1 for frames in ours)
    _assert_frames_equal([frames[0] for frames in ours], capture(path))
    assert ours[0][0].shape == (size[1], size[0], 3)
    assert decoder.stats == {k: stats.get(k, 0) for k in STATS}
    if planes:
        theirs = decode_planes("h264", [annexb([au]) for au in aus], "yuv420p", *size)
        again = H264Decoder()
        for i, au in enumerate(aus):
            again.decode(annexb([au]))
            for a, b in zip(again.planes(0), theirs[i]):
                np.testing.assert_array_equal(a, b, err_msg=f"picture {i}")


# --- random streams --------------------------------------------------------------------------------

HIGH = dict(cabac=True, transform_8x8=True)
PRESETS = {
    "cabac_i_only": dict(cabac=True, intra_only=True),
    "cabac_p_init_idc_0": dict(cabac=True, cabac_init_idc=0),
    "cabac_p_init_idc_1": dict(cabac=True, cabac_init_idc=1),
    "cabac_p_init_idc_2": dict(cabac=True, cabac_init_idc=2),
    "transform_8x8_cavlc": dict(transform_8x8=True),
    "transform_8x8_cabac": dict(HIGH),
    "sps_lists_only": dict(HIGH, sps_lists=True),
    "pps_lists_only": dict(HIGH, pps_lists=True),  # fall-back rule A in the PPS
    "fall_back_rule_b": dict(HIGH, sps_lists=True, pps_lists=True, list_modes=("absent", "explicit")),
    "lists_under_cavlc": dict(transform_8x8=True, sps_lists=True, pps_lists=True),
    "default_lists": dict(HIGH, sps_lists=True, pps_lists=True, list_modes=("default",)),
    "second_chroma_qp_offset": dict(HIGH, second_chroma_qp_offset=True),
    "low_qp": dict(HIGH, qp_range=(0, 12)),
    "high_qp": dict(HIGH, qp_range=(40, 51)),
    "several_slices": dict(HIGH, mb_width=6, mb_height=4, frames=8),
    "i_pcm": dict(HIGH, intra_share=0.6),
    "one_macroblock": dict(HIGH, mb_width=1, mb_height=1, frames=8),
    "constrained_intra_8x8": dict(HIGH, constrained_intra=True, intra_share=0.5),
}


@pytest.mark.parametrize("preset", list(PRESETS))
def test_high_profile_streams_equal_videocapture(tmp_path, preset):
    """Random streams, Annex B: cv2's frames, libavcodec's planes and the writer's counts."""
    for seed in (1, 2):
        aus, stats, _, size, _ = random_stream(seed + 100 * list(PRESETS).index(preset) + 20000, **PRESETS[preset])
        _check_stream(tmp_path, f"{seed}.h264", aus, stats, size)


def test_coded_8x8_blocks_without_levels_deblock_as_ffmpeg(tmp_path):
    """CAVLC 8x8 blocks coded in the cbp whose four 4x4 parts hold no level: FFmpeg's x86 deblocking gives every edge
    of an inter macroblock with 8x8 blocks 0-2 coded bS 2, and so does the port (these two streams part from cv2's
    frames without it)."""
    for seed in (3, 5):
        aus, stats, _, size, _ = random_stream(seed, transform_8x8=True, empty_8x8_share=0.6, intra_share=0.05,
                                               mb_width=6, mb_height=4)
        _check_stream(tmp_path, f"{seed}.h264", aus, stats, size)


def test_high_profile_stream_in_mp4_equals_videocapture(tmp_path):
    """The avcC route: a CABAC stream with the 8x8 transform and scaling matrices in an .mp4."""
    aus, _, _, size, _ = random_stream(77, mb_width=5, mb_height=3, frames=5, sps_lists=True, pps_lists=True,
                                       **HIGH)
    path = _write(tmp_path, "high.mp4", mp4(aus, *size))
    _assert_frames_equal(read_video_frames(path), capture(path))


# The ctxIdx a progressive 4:2:0 stream of I and P slices codes bins with: mb_type of I slices (3-10); mb_skip_flag,
# mb_type and sub_mb_type of P slices (11-23), mvd (40-53), ref_idx (54-59); mb_qp_delta, the intra modes (60-69);
# coded_block_pattern (73-84); the residual of ctxBlockCat 0-4 (85-275, frame scans) and of 8x8 blocks with
# transform_size_8x8_flag (399-435).
I_CONTEXTS = set(range(3, 11)) | set(range(60, 70)) | set(range(73, 276)) | set(range(399, 436))
P_CONTEXTS = (I_CONTEXTS - set(range(3, 11))) | set(range(11, 24)) | set(range(40, 60))
COVERAGE = ([dict(HIGH, cabac_init_idc=k % 3) for k in range(9)]
            + [dict(HIGH, intra_share=0.6, cabac_init_idc=k % 3) for k in range(6)]
            + [dict(HIGH, sps_lists=True, pps_lists=True), dict(HIGH, second_chroma_qp_offset=True, sps_lists=True),
               dict(transform_8x8=True, pps_lists=True, sps_lists=True, list_modes=("absent", "default"))])


def test_writer_covers_every_context_and_tool(tmp_path):
    """Over a fixed set of 96x64 streams of eight frames, each held to cv2's frames and the writer's counts, every
    count of the High-profile tools is reached and every ctxIdx an I / P stream uses is coded under each of the four
    initialisation tables (I slices; P slices with cabac_init_idc 0, 1 and 2)."""
    used, total = set(), {k: 0 for k in NEW_STATS}
    for i, options in enumerate(COVERAGE):
        aus, stats, _, size, writer = random_stream(9000 + i, mb_width=6, mb_height=4, frames=8, **options)
        _check_stream(tmp_path, f"{i}.h264", aus, stats, size, planes=False)
        used |= writer.ctx_used
        for k in NEW_STATS:
            total[k] += stats.get(k, 0)
    assert [k for k, v in total.items() if not v] == []
    for table in range(4):
        missing = sorted((I_CONTEXTS if table == 0 else P_CONTEXTS) - {c for t, c in used if t == table})
        assert missing == [], f"initialisation table {table}: ctxIdx {missing} never coded"


def test_writer_cabac_tables_have_their_shapes():
    assert len(CABAC_INIT) == 4 and all(len(t) == 436 for t in CABAC_INIT)
    assert all(-128 <= m < 128 and -128 <= n < 128 for t in CABAC_INIT for m, n in t)
    assert len(SIG_8X8) == len(LAST_8X8) == 63 and set(SIG_8X8) == set(range(15)) and set(LAST_8X8) == set(range(9))


# --- the closed-loop High-profile encoder and the checked-in clip ---------------------------------


def _small_high_clip(tmp_path, frames=6):
    import cv2

    rng = np.random.default_rng(21)
    base = np.clip(cv2.GaussianBlur(rng.uniform(0, 255, (64, 64, 3)), (0, 0), 2.0) * 3 - 256, 0, 255).astype(np.uint8)
    clip = [np.ascontiguousarray(base[i:i + 24, 2 * i:2 * i + 32]) for i in range(frames)]
    aus, recon, encoder = encode_frames(clip, qp=20, search=3, high=True)
    return _write(tmp_path, "clip.mp4", mp4(aus, 32, 24)), aus, recon, encoder


def test_high_encoder_stream_equals_ffmpegs(tmp_path):
    """The High-profile encoder (CABAC, deblocking on, its references FFmpeg's decode): the port decodes its stream to
    libavcodec's planes, which are the encoder's reconstruction, and to cv2's frames."""
    path, aus, recon, encoder = _small_high_clip(tmp_path)
    decoder = H264Decoder()
    for i, au in enumerate(aus):
        decoder.decode(annexb([au]))
        for a, b in zip(decoder.planes(0), recon[i]):
            np.testing.assert_array_equal(a, b)
    _assert_frames_equal(read_video_frames(path), capture(path))
    stats = decoder.stats
    assert stats["cabac_slices"] == 6 and stats["deblock_idc_0"] == 6 and stats["I_8x8"] > 0
    assert {k: stats[k] for k in encoder.stats} == dict(encoder.stats)


def test_high_fixture_equals_videocapture_digest():
    manifest = json.load(open(os.path.join(FIXTURES, "manifest.json")))
    path = os.path.join(FIXTURES, CLIP)
    assert hashlib.sha256(open(path, "rb").read()).hexdigest() == manifest[CLIP]["sha256"]
    frames = np.stack(read_video_frames(path))
    assert list(frames.shape) == manifest[CLIP]["shape"] == [12, 540, 960, 3]
    assert hashlib.sha256(frames.tobytes()).hexdigest() == manifest[CLIP]["frames_sha256"]


def test_high_fixture_reaches_what_it_was_made_for():
    manifest = json.load(open(os.path.join(FIXTURES, "manifest.json")))
    video = read_mp4_video(open(os.path.join(FIXTURES, CLIP), "rb").read())
    assert video.codec == "avc1" and video.config[1] == 100  # profile_idc: High
    decoder = H264Decoder(video.config)
    frames = [f for s in video.samples for f in decoder.decode(s)]
    stats = decoder.stats
    assert len(frames) == 12 and stats["idr_pictures"] == 1 and stats["p_slices"] == 11
    assert stats["cabac_slices"] == 12 and stats["deblock_idc_0"] == 12 and stats["cropped_pictures"] == 12
    counts = manifest["encoding_high"]["macroblocks"]
    assert {k: stats[k] for k in counts} == counts
    assert all(counts[k] > 0 for k in ("I_16x16", "I_8x8", "P_L0_16x16", "P_8x8", "P_Skip", "transform_8x8_inter"))


# --- the loader and the resolver against the JAX package's ---------------------------------------


def test_loader_matches_jax_on_high_fixture():
    """The port's VideoLoader and the JAX one (cv2.VideoCapture) on the High-profile .mp4, float64, equal."""
    path = os.path.join(FIXTURES, CLIP)
    ours, theirs = VideoLoader(**CPU), JVideoLoader()
    ours.load_frames_from_video(path, 2)
    theirs.load_frames_from_video(path, 2)
    assert ours.num_frames == theirs.num_frames == 2 and ours.image_size == theirs.image_size == (960, 540)
    np.testing.assert_array_equal(ours.frame_stack().numpy(), theirs.frame_stack())


def test_super_resolver_matches_jax_on_high_frames(tmp_path):
    """The port's VideoSuperResolver on the port's decode of a small High-profile .mp4, and the JAX one on
    cv2.VideoCapture's frames of the same file (window 3, no blur), to 1e-8 of the largest entry."""
    path = _small_high_clip(tmp_path, frames=4)[0]
    loader, jloader = VideoLoader(**CPU), JVideoLoader()
    loader.load_frames_from_video(path)
    jloader.load_frames_from_video(path)
    kwargs = dict(scale=2, temporal_window=3, blur_radius=0)
    theirs = np.asarray(JVideoSuperResolver(**kwargs).super_resolve(np.asarray(jloader.frame_stack())))
    ours = VideoSuperResolver(**kwargs, **CPU).super_resolve(loader.frame_stack()).numpy()
    assert ours.shape == theirs.shape == (4, 3, 48, 64)
    assert np.abs(ours - theirs).max() <= 1e-8 * np.abs(theirs).max()


# --- what stays refused, inside CABAC streams -------------------------------------------------------


def _cabac_stream(options=None, sps=None, frames=3, seed=9):
    writer = StreamWriter(np.random.default_rng(seed), Options(mb_width=3, mb_height=2, frames=frames, cabac=True,
                                                               transform_8x8=True, **(options or {})))
    for key, value in (sps or {}).items():
        setattr(writer.sps, key, value)
    return [writer.picture() for _ in range(frames)]


def _cabac_slice_of_type(slice_type):
    w = BitWriter()
    w.ue(0)
    w.ue(slice_type)
    w.ue(0)
    w.trailing()
    return [nal_unit(3, 7, Sps(3, 2, profile_idc=100).rbsp()), nal_unit(3, 8, Pps(cabac=True).rbsp()),
            nal_unit(3, 1, w.data())]


CABAC_REFUSALS = {
    "SP slices": lambda: _cabac_stream()[:1] + [_cabac_slice_of_type(3)],
    "frame_mbs_only_flag 0": lambda: _cabac_stream(sps=dict(frame_mbs_only=False, mb_height=2)),
    "no_output_of_prior_pics_flag": lambda: _cabac_stream(options=dict(no_output_of_prior_pics=True)),
    "without an IDR picture": lambda: _cabac_stream(options=dict(first_non_idr=True)),
    "does not increase": lambda: _cabac_stream(options=dict(poc_step=0),
                                               sps=dict(poc_type=0, bitstream_restriction=False)),
    "a left crop": lambda: _cabac_stream(sps=dict(crop=(1, 0, 0, 0))),
}


@pytest.mark.parametrize("what", list(CABAC_REFUSALS))
def test_refusals_in_cabac_streams(tmp_path, what):
    path = _write(tmp_path, "refused.h264", annexb(CABAC_REFUSALS[what]()))
    with pytest.raises(NotImplementedError, match=what):
        read_video_frames(path)


# The CABAC streams of the refusals that B slices and the output order of FFmpeg replaced: each now decodes to cv2's
# frames.
FORMERLY_REFUSED = {
    "B slices": lambda: _cabac_stream(options=dict(b_frames=True), frames=8),
    "does not increase with the VUI's restriction": lambda: _cabac_stream(
        options=dict(poc_step=0), sps=dict(poc_type=0, vui=True, bitstream_restriction=True)),
}


@pytest.mark.parametrize("what", list(FORMERLY_REFUSED))
def test_formerly_refused_cabac_streams_equal_videocapture(tmp_path, what):
    path = _write(tmp_path, "cabac.h264", annexb(FORMERLY_REFUSED[what]()))
    _assert_frames_equal(read_video_frames(path), capture(path))
