"""H.264 B slices in the port (``native/h264_decoder.cpp`` through
``utils/h264.py``): every B macroblock and sub-macroblock type, B_Skip,
spatial and temporal direct prediction under either
``direct_8x8_inference_flag``, default, implicit and explicit weighted
bi-prediction, list 1 modification, long-term pictures in list 1, reference
B pictures (B-pyramid), MMCO 5 and several slices, under CAVLC and CABAC;
the output order of FFmpeg's ``h264_select_output_frame`` (the VUI's
``max_num_reorder_frames`` 1 and 2, the pictures held back drained at the end
of the stream); and the MP4 composition offsets (``ctts`` version 0 with an
edit list, version 1 with negative offsets).

Random streams of ``torch_h264_writer.py`` are held three ways: the BGR
frames array-equal to ``cv2.VideoCapture``'s (the JAX package's video path,
whose frame-threaded FFmpeg returns the held-back pictures at the end of the
file), the YUV planes equal to libavcodec's single-thread decode (so the
output does not hang on the thread count), and the decoder's counts equal to
those the writer kept of what it wrote. A fixed set of streams codes with
every B ctxIdx (24-39, and list 1's ref_idx and mvd contexts) under each
``cabac_init_idc``. One B stream in each container gives cv2's frames in
cv2's order and number. The checked-in clip with B pictures of
``tests/data_torch/h264`` decodes to the digest of cv2's frames; the JAX
loader (cv2) and the port's agree on it, and the JAX resolver and the port's
agree on the decoded frames of a small B clip. A picture order that goes back
in a stream without the VUI's ``bitstream_restriction_flag`` raises
``NotImplementedError``.
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
from torch_h264_writer import (HighBEncoder, Options, StreamWriter, annexb, avi, display_order,  # noqa: E402
                               encode_frames, mkv, mp4, random_stream)
from torch_libav import capture, decode_planes  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data_torch", "h264")
CLIP = "h264_b_960x540x12.mp4"
CPU = dict(device="cpu", dtype=torch.float64)
B_STATS = STATS[STATS.index("b_slices"):]


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


def _decode(aus):
    """(frames, YUV planes, the decode call of each frame, the decoder) of the access units fed one a call, then
    the end of the stream."""
    decoder, frames, planes, units = H264Decoder(), [], [], []
    for au in aus + [None]:
        out = decoder.flush() if au is None else decoder.decode(annexb([au]))
        frames += out
        planes += [decoder.planes(i) for i in range(len(out))]
        units += decoder.units()
    return frames, planes, units, decoder


def _check_stream(tmp_path, name, aus, stats, size, planes=True):
    """cv2's BGR frames, libavcodec's single-thread planes (a packet an access unit) and the writer's counts."""
    path = _write(tmp_path, name, annexb(aus))
    frames, ours, units, decoder = _decode(aus)
    _assert_frames_equal(frames, capture(path))
    assert frames[0].shape == (size[1], size[0], 3) and sorted(units) == list(range(len(aus)))
    assert decoder.stats == {k: stats.get(k, 0) for k in STATS}
    if planes:
        theirs = decode_planes("h264", [annexb([au]) for au in aus], "yuv420p", *size)
        assert len(ours) == len(theirs)
        for i, (a, b) in enumerate(zip(ours, theirs)):
            for p, q in zip(a, b):
                np.testing.assert_array_equal(p, q, err_msg=f"frame {i}")


# --- random streams --------------------------------------------------------------------------------

SMALL = dict(b_frames=True, mb_width=4, mb_height=3, frames=10)
PRESETS = {
    "cavlc": dict(),
    "cabac": dict(cabac=True),
    "cabac_transform_8x8": dict(cabac=True, transform_8x8=True),
    "spatial_direct_8x8_inference": dict(direct_spatial=True, direct_8x8_inference=True, cabac=True),
    "spatial_direct_4x4": dict(direct_spatial=True, direct_8x8_inference=False),
    "temporal_direct_8x8_inference": dict(direct_spatial=False, direct_8x8_inference=True),
    "temporal_direct_4x4": dict(direct_spatial=False, direct_8x8_inference=False, cabac=True),
    "default_bipred": dict(bipred_idc=0, cabac=True),
    "explicit_bipred": dict(bipred_idc=1),
    "implicit_bipred": dict(bipred_idc=2, cabac=True),
    "reorder_1_without_pyramid": dict(b_pyramid=False, extra_reorder=0),
    "reorder_2_pyramid": dict(b_pyramid=True, extra_reorder=0, cabac=True),
    "display_order_poc_type_2": dict(poc_type=2),
    "references_and_mmco": dict(max_refs=4, frames=12, cabac=True),
    "several_slices": dict(mb_width=6, mb_height=4, cabac=True, transform_8x8=True),
}


@pytest.mark.parametrize("preset", list(PRESETS))
def test_b_streams_equal_videocapture(tmp_path, preset):
    """Random B streams, Annex B: cv2's frames, libavcodec's planes and the writer's counts."""
    for seed in (1, 2):
        aus, stats, _, size, _ = random_stream(seed + 100 * list(PRESETS).index(preset) + 30000,
                                               **{**SMALL, **PRESETS[preset]})
        _check_stream(tmp_path, f"{seed}.h264", aus, stats, size)


def test_direct_block_sizes_follow_ffmpeg(tmp_path):
    """FFmpeg predicts a direct macroblock whose motion comes out uniform as one 16x16 block, and a direct 8x8 block
    without direct_8x8_inference_flag in 4x4 blocks unless its co-located blocks all or none are still; the block
    size decides whether a 2-sample chroma row takes FFmpeg's exact C weighting or its x86 one (a weight of 128
    halved). This stream, explicitly weighted, shows it (decoding every direct macroblock in 4x4 blocks parts from
    cv2 here)."""
    aus, stats, _, size, _ = random_stream(4, **SMALL, bipred_idc=1, direct_8x8_inference=False, direct_spatial=True,
                                           max_refs=4, b_mb_shares=(0.4, 0.0, 0.4, 0.1, 0.1, 0.0), cabac=True)
    _check_stream(tmp_path, "direct.h264", aus, stats, size)


# The ctxIdx that B slices add (mb_skip_flag 24-26, mb_type 27-35 with the intra suffix, sub_mb_type 36-39) and
# those list 1's ref_idx (54-59) and mvd (40-53) code with, under each of the three initialisation tables.
B_CONTEXTS = set(range(24, 40))
LIST1_CONTEXTS = set(range(40, 60))
COVERAGE = [dict(cabac=True, cabac_init_idc=k % 3) for k in range(9)] + \
    [dict(cabac=True, transform_8x8=True, cabac_init_idc=k % 3) for k in range(3)]


def test_writer_covers_every_b_context_and_tool(tmp_path):
    """Over a fixed set of 96x64 B streams of ten frames, each held to cv2's frames and the writer's counts, every
    B count is reached and every B ctxIdx -- list 1's ref_idx and mvd ones included -- is coded under each
    cabac_init_idc; the streams reach a long-term picture in list 1, a B picture as the co-located one, a
    co-located reference no list 0 entry has the frame_num of, and MMCO 5."""
    used, used1, total, facts = set(), set(), {k: 0 for k in B_STATS}, {}
    mmco5 = 0
    for i, options in enumerate(COVERAGE):
        aus, stats, _, size, writer = random_stream(9100 + i, b_frames=True, mb_width=6, mb_height=4, frames=10,
                                                    **options)
        _check_stream(tmp_path, f"{i}.h264", aus, stats, size, planes=False)
        used |= writer.ctx_used
        used1 |= writer.ctx_used_l1
        mmco5 += stats.get("mmco_5", 0)
        for k in B_STATS:
            total[k] += stats.get(k, 0)
        for k, v in writer.facts.items():
            facts[k] = facts.get(k, 0) + v
    assert [k for k, v in total.items() if not v] == []
    for table in (1, 2, 3):
        assert sorted(B_CONTEXTS - {c for t, c in used if t == table}) == [], f"table {table}"
        assert sorted(LIST1_CONTEXTS - {c for t, c in used1 if t == table}) == [], f"list 1, table {table}"
    assert mmco5 and all(facts.get(k) for k in ("long_term_in_list1", "b_picture_co_located",
                                                "co_located_reference_not_in_list0")), facts


def test_output_order_and_units():
    """The frames come out in display order however the access units are fed (one a call, or all in one call
    with the rest at the end of the stream), and each frame's decode call is the access unit that carried it."""
    aus, _, _, _, writer = random_stream(41, **SMALL, cabac=True)
    frames, _, units, decoder = _decode(aus)
    assert decoder.stats["reordered_pictures"] > 0
    assert units == sorted(range(len(aus)), key=lambda i: display_order(writer, len(aus))[i])
    whole = H264Decoder()
    together = whole.decode(annexb(aus))
    assert set(whole.units()) <= {0}
    _assert_frames_equal(together + whole.flush(), frames)


# --- containers --------------------------------------------------------------------------------------------------

CONTAINERS = {
    "mp4_ctts_v0_elst": lambda aus, size, pts, path: open(path, "wb").write(mp4(aus, *size, pts=pts)),
    "mp4_ctts_v1": lambda aus, size, pts, path: open(path, "wb").write(mp4(aus, *size, pts=pts, ctts_version=1)),
    "mp4_edit_skips_two": lambda aus, size, pts, path: open(path, "wb").write(mp4(aus, *size, pts=pts, skip=2)),
    "mkv": lambda aus, size, pts, path: open(path, "wb").write(mkv(aus, *size, pts=pts)),
    "avi": lambda aus, size, pts, path: avi(path, aus, *size),
    "h264": lambda aus, size, pts, path: open(path, "wb").write(annexb(aus)),
}
EXTENSIONS = {"mp4": ".mp4", "mkv": ".mkv", "avi": ".avi", "h264": ".h264"}


@pytest.mark.parametrize("container", list(CONTAINERS))
def test_containers_equal_videocapture(tmp_path, container):
    """One B stream in each container: read_video_frames and VideoLoader give cv2's frames, in cv2's order and
    number (the edit list that starts two frames late drops the frames of its first two packets)."""
    aus, _, _, size, writer = random_stream(4343, **{**SMALL, "mb_width": 5, "crop": (0, 1, 0, 2)}, cabac=True)
    path = str(tmp_path / ("clip" + EXTENSIONS[container.split("_")[0]]))
    CONTAINERS[container](aus, size, display_order(writer, len(aus)), path)
    ours, theirs = read_video_frames(path), capture(path)
    _assert_frames_equal(ours, theirs)
    assert len(ours) == len(aus) - 2 * (container == "mp4_edit_skips_two")
    loader = VideoLoader(**CPU)
    loader.load_frames_from_video(path, max_frames=3)
    np.testing.assert_array_equal(loader.frame_stack().numpy(),
                                  np.stack([np.moveaxis(f, -1, 0) for f in theirs[:3]]) / 255.0)


def test_mp4_composition_offsets_are_read():
    aus, _, _, size, writer = random_stream(4343, **SMALL)
    pts = display_order(writer, len(aus))
    for version in (0, 1):
        video = read_mp4_video(mp4(aus, *size, pts=pts, ctts_version=version))
        assert video.codec == "avc1" and len(video.samples) == len(aus) and all(video.shown)
    video = read_mp4_video(mp4(aus, *size, pts=pts, skip=3))
    hidden = [i for i, shown in enumerate(video.shown) if not shown]
    assert sorted(pts[i] for i in hidden) == [0, 1, 2]


# --- the B-picture encoder and the checked-in clip ---------------------------------------------------------


def _small_b_clip(tmp_path, frames=6):
    import cv2

    rng = np.random.default_rng(21)
    base = np.clip(cv2.GaussianBlur(rng.uniform(0, 255, (64, 64, 3)), (0, 0), 2.0) * 3 - 256, 0, 255).astype(np.uint8)
    clip = [np.ascontiguousarray(base[i:i + 24, 2 * i:2 * i + 32]) for i in range(frames)]
    aus, recon, encoder = encode_frames(clip, qp=20, search=3, high=True, b_frames=True)
    pts = [g[0] for g in HighBEncoder.gop(frames)]
    return _write(tmp_path, "clip.mp4", mp4(aus, 32, 24, pts=pts)), aus, recon, encoder


def test_b_encoder_stream_equals_ffmpegs(tmp_path):
    """The B-picture encoder (x264's GOP shape, spatial direct, implicit weights, CABAC, deblocking on): the port
    decodes its stream to libavcodec's planes, which are the encoder's reconstruction, to cv2's frames, and to the
    counts the encoder kept."""
    path, aus, recon, encoder = _small_b_clip(tmp_path)
    _, planes, _, decoder = _decode(aus)
    assert len(planes) == len(recon) == 6
    for ours, theirs in zip(planes, recon):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    _assert_frames_equal(read_video_frames(path), capture(path))
    stats = decoder.stats
    assert stats["b_slices"] == 3 and stats["reference_b_pictures"] == 1 and stats["reordered_pictures"] > 0
    assert {k: stats[k] for k in encoder.stats} == dict(encoder.stats)


def test_b_fixture_equals_videocapture_digest():
    manifest = json.load(open(os.path.join(FIXTURES, "manifest.json")))
    path = os.path.join(FIXTURES, CLIP)
    data = open(path, "rb").read()
    assert hashlib.sha256(data).hexdigest() == manifest[CLIP]["sha256"] and len(data) < 200_000
    frames = np.stack(read_video_frames(path))
    assert list(frames.shape) == manifest[CLIP]["shape"] == [12, 540, 960, 3]
    assert hashlib.sha256(frames.tobytes()).hexdigest() == manifest[CLIP]["frames_sha256"]


def test_b_fixture_reaches_what_it_was_made_for():
    manifest = json.load(open(os.path.join(FIXTURES, "manifest.json")))
    video = read_mp4_video(open(os.path.join(FIXTURES, CLIP), "rb").read())
    assert video.codec == "avc1" and video.config[1] == 100 and all(video.shown)
    decoder = H264Decoder(video.config)
    frames = [f for s in video.samples for f in decoder.decode(s)] + decoder.flush()
    stats = decoder.stats
    assert len(frames) == 12 and stats["idr_pictures"] == 1 and stats["p_slices"] == 3 and stats["b_slices"] == 8
    assert stats["reference_b_pictures"] == 2 and stats["implicit_bipred_slices"] == 8
    assert stats["reordered_pictures"] > 0 and stats["cabac_slices"] == 12 and stats["deblock_idc_0"] == 12
    counts = manifest["encoding_b"]["macroblocks"]
    assert {k: stats[k] for k in counts} == counts
    assert all(counts[k] > 0 for k in ("B_Skip", "B_Direct_16x16", "B_16x16", "bi_partitions", "spatial_direct_mbs"))


# --- the loader and the resolver against the JAX package's ---------------------------------------


def test_loader_matches_jax_on_b_fixture():
    """The port's VideoLoader and the JAX one (cv2.VideoCapture) on the B-picture .mp4, float64, equal."""
    path = os.path.join(FIXTURES, CLIP)
    ours, theirs = VideoLoader(**CPU), JVideoLoader()
    ours.load_frames_from_video(path, 3)
    theirs.load_frames_from_video(path, 3)
    assert ours.num_frames == theirs.num_frames == 3 and ours.image_size == theirs.image_size == (960, 540)
    np.testing.assert_array_equal(ours.frame_stack().numpy(), theirs.frame_stack())


def test_super_resolver_matches_jax_on_b_frames(tmp_path):
    """The port's VideoSuperResolver on the port's decode of a small .mp4 with B pictures, and the JAX one on
    cv2.VideoCapture's frames of the same file (window 3, no blur), to 1e-8 of the largest entry."""
    path = _small_b_clip(tmp_path, frames=5)[0]
    loader, jloader = VideoLoader(**CPU), JVideoLoader()
    loader.load_frames_from_video(path)
    jloader.load_frames_from_video(path)
    kwargs = dict(scale=2, temporal_window=3, blur_radius=0)
    theirs = np.asarray(JVideoSuperResolver(**kwargs).super_resolve(np.asarray(jloader.frame_stack())))
    ours = VideoSuperResolver(**kwargs, **CPU).super_resolve(loader.frame_stack()).numpy()
    assert ours.shape == theirs.shape == (5, 3, 48, 64)
    assert np.abs(ours - theirs).max() <= 1e-8 * np.abs(theirs).max()


# --- the refusal -------------------------------------------------------------------------------------


def test_order_that_goes_back_without_the_restriction_is_refused(tmp_path):
    """A B stream whose SPS lacks the VUI's bitstream_restriction_flag: FFmpeg grows its delay as it goes, so what
    it outputs depends on its frame threads; the port refuses it by name (with the restriction it decodes)."""
    writer = StreamWriter(np.random.default_rng(5), Options(**SMALL))
    writer.sps.bitstream_restriction = False
    aus = [writer.picture() for _ in range(SMALL["frames"])]
    path = _write(tmp_path, "unrestricted.h264", annexb(aus))
    with pytest.raises(NotImplementedError, match="does not increase .* without the VUI's bitstream_restriction_flag"):
        read_video_frames(path)
    with pytest.raises(NotImplementedError, match="bitstream_restriction_flag"):
        H264Decoder().decode(annexb(aus))
