"""H.264 video in the port (``utils/h264.py`` over ``native/h264_decoder.cpp``;
the MP4 / Matroska / AVI / Annex B routing of ``video/video_loader.py``), held
against ``cv2.VideoCapture`` -- the JAX package's video path, FFmpeg's H.264
decoder -- on the same files.

The OpenCV wheel's ``cv2.VideoWriter`` has no H.264 encoder (only ``h264_v4l2m2m``,
which needs a V4L2 device), so the streams come from
``torch_h264_writer.py``: random syntax that covers every tool the decoder
reads (every macroblock type, sub-partition and intra mode, skip runs, up to
16 reference frames with list modification, MMCO 1-6 and long-term
references, explicit weights, several slices a picture with each deblocking
mode, constrained intra prediction, POC types 0-2, the QP range and its
wrap, far vectors, level escapes, I_PCM, crops, 1x1 to 6x4 macroblocks),
each held array-equal to cv2's frames and to the counts the writer kept of
what it wrote; each container; the checked-in 960x540 clip of
``tests/data_torch/h264`` (the writer's closed-loop encoder) at the digest of
cv2's frames that its manifest records. What the decoder refuses raises
``NotImplementedError`` naming it; damaged streams raise ``ValueError``. The
loader matches the JAX loader in float64; the resolver matches the JAX
resolver on cv2's frames of the same file to 1e-8 of the largest entry. The High-profile
tools (CABAC, the 8x8 transform, scaling matrices, the second chroma QP
offset) have test_torch_h264_cabac.py and B slices test_torch_h264_b.py; here,
the streams those tools were once refused on decode to cv2's frames.
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
from torch_h264_tables import (CHROMA_DC_TOKEN, CHROMA_DC_TOTAL_ZEROS, COEFF_TOKEN, RUN_BEFORE,  # noqa: E402
                               TOTAL_ZEROS)
from torch_h264_writer import (BitWriter, Options, Pps, Sps, StreamWriter, annexb, avcc, avi,  # noqa: E402
                               encode_frames, mkv, mp4, nal_unit, random_stream)
from torch_libav import capture, decode_planes  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data_torch", "h264")
CPU = dict(device="cpu", dtype=torch.float64)
CLIP = "h264_960x540x12"


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


def _decode(data, config=b""):
    decoder = H264Decoder(config)
    return decoder.decode(data) + decoder.flush(), decoder


def _assert_frames_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.shape == b.shape and np.array_equal(a, b), f"frame {i}: max |diff| {np.abs(a.astype(int) - b).max()}"


# --- the writer's tables --------------------------------------------------------------------------


def test_writer_tables_are_prefix_codes():
    """Each CAVLC table the writer copied is a prefix code (a wrong length or value shows here or in FFmpeg's
    decode of a written stream)."""
    tables = ([[c for row in t for c in row] for t in COEFF_TOKEN] + [[c for row in CHROMA_DC_TOKEN for c in row]]
              + TOTAL_ZEROS + CHROMA_DC_TOTAL_ZEROS + RUN_BEFORE)
    for codes in tables:
        words = [format(v, f"0{n}b") for n, v in codes]
        assert sum(2.0 ** -n for n, _ in codes) <= 1.0
        assert not any(a != b and b.startswith(a) for a in words for b in words)


# --- random streams against cv2.VideoCapture ------------------------------------------------------

PRESETS = {
    "64x48": dict(),
    "96x64": dict(mb_width=6, mb_height=4, frames=8),
    "one_macroblock": dict(mb_width=1, mb_height=1, frames=8),
    "odd_macroblock_counts": dict(mb_width=5, mb_height=3),
    "crop_right_top_bottom": dict(mb_width=5, mb_height=3, crop=(0, 3, 1, 2)),
    "poc_type_0": dict(poc_type=0),
    "poc_type_1": dict(poc_type=1),
    "poc_type_2": dict(poc_type=2),
    "poc_steps_past_2": dict(poc_type=0, poc_step=3),  # FFmpeg's reorder heuristic then delays its output
    "constrained_intra": dict(constrained_intra=True, intra_share=0.5),
    "sixteen_references": dict(max_refs=16, frames=8, mmco=False),
    "long_term_references": dict(max_refs=4, frames=8),
    "low_qp_escapes": dict(qp_range=(0, 12)),
    "high_qp": dict(qp_range=(40, 51)),
}
# The colour matrices and ranges cv2.VideoCapture's conversion follows (the VUI's colour description).
COLOURS = [(m, full) for m in (None, 1, 2, 4, 5, 6, 7) for full in (False, True)]


@pytest.mark.parametrize("preset", list(PRESETS))
def test_writer_streams_equal_videocapture(tmp_path, preset):
    """Random streams, Annex B: the port's frames array-equal to cv2's, the decoder's counts equal to the
    writer's."""
    for seed in (1, 2):
        aus, stats, _, size, _ = random_stream(seed + 100 * list(PRESETS).index(preset), **PRESETS[preset])
        data = annexb(aus)
        path = _write(tmp_path, f"{seed}.h264", data)
        ours, decoder = _decode(data)
        _assert_frames_equal(ours, capture(path))
        assert ours[0].shape == (size[1], size[0], 3)
        assert decoder.stats == {k: stats.get(k, 0) for k in STATS}
        _assert_frames_equal(read_video_frames(path, max_frames=2), ours[:2])


@pytest.mark.parametrize("matrix,full_range", COLOURS)
def test_colour_description_equals_videocapture(tmp_path, matrix, full_range):
    """The VUI's matrix_coefficients and video_full_range_flag, which cv2.VideoCapture's conversion follows."""
    aus = _stream(sps=dict(vui=True, matrix=matrix, full_range=full_range), frames=2)
    path = _write(tmp_path, "colour.h264", annexb(aus))
    _assert_frames_equal(read_video_frames(path), capture(path))


def test_high_profile_pps_extension_equals_videocapture(tmp_path):
    """A High-profile PPS that carries its extension with neither tool on and the second chroma offset equal to
    the first: read, and cv2's frames."""
    aus = _stream(sps=dict(profile_idc=100), pps=dict(chroma_qp_offset=3, second_chroma_qp_offset=3))
    path = _write(tmp_path, "high.h264", annexb(aus))
    _assert_frames_equal(read_video_frames(path), capture(path))


def test_writer_covers_every_tool():
    """Over twenty 96x64 streams of eight frames the writer reaches every count the decoder keeps (cropping aside:
    its own preset), and the decoder counts what the writer wrote."""
    total = {k: 0 for k in STATS}
    for seed in range(20):
        aus, stats, _, _, _ = random_stream(seed + 7000, mb_width=6, mb_height=4, frames=8)
        _, decoder = _decode(annexb(aus))
        assert decoder.stats == {k: stats.get(k, 0) for k in STATS}
        for k, v in decoder.stats.items():
            total[k] += v
    # The High-profile tools' counts, from "cabac_slices" on, are reached by test_torch_h264_cabac.py's streams.
    assert [k for k in STATS[:STATS.index("cabac_slices")] if not total[k]] == ["cropped_pictures"]


# --- containers -----------------------------------------------------------------------------------

CONTAINERS = {
    "mp4_avc1": lambda aus, size, path: open(path, "wb").write(mp4(aus, *size)),
    "mp4_avc1_2_byte_lengths": lambda aus, size, path: open(path, "wb").write(mp4(aus, *size, length_size=2)),
    "mp4_avc3": lambda aus, size, path: open(path, "wb").write(mp4(aus, *size, fourcc=b"avc3")),
    "mkv": lambda aus, size, path: open(path, "wb").write(mkv(aus, *size)),
    "mkv_2_byte_lengths": lambda aus, size, path: open(path, "wb").write(mkv(aus, *size, length_size=2)),
    "avi": lambda aus, size, path: avi(path, aus, *size),
    "avi_x264": lambda aus, size, path: avi(path, aus, *size, fourcc=b"X264"),
    "h264": lambda aus, size, path: open(path, "wb").write(annexb(aus)),
}
EXTENSIONS = {"mp4": ".mp4", "mkv": ".mkv", "avi": ".avi", "h264": ".h264"}


@pytest.mark.parametrize("container", list(CONTAINERS))
def test_containers_equal_videocapture(tmp_path, container):
    aus, _, _, size, _ = random_stream(4242, mb_width=5, mb_height=3, frames=6, crop=(0, 1, 0, 2))
    path = str(tmp_path / ("clip" + EXTENSIONS[container.split("_")[0]]))
    CONTAINERS[container](aus, size, path)
    ours = read_video_frames(path)
    _assert_frames_equal(ours, capture(path))
    _assert_frames_equal(ours, _decode(annexb(aus))[0])


def test_one_byte_nal_lengths(tmp_path):
    """avcC's lengthSizeMinusOne 0: NAL units under 256 bytes."""
    aus, _, _, size, _ = random_stream(77, mb_width=1, mb_height=1, frames=4, pcm=False, escapes=False,
                                       qp_range=(45, 51))
    assert max(len(n) for au in aus for n in au) < 256
    path = _write(tmp_path, "clip.mp4", mp4(aus, *size, length_size=1))
    _assert_frames_equal(read_video_frames(path), capture(path))


# --- the checked-in clip --------------------------------------------------------------------------


@pytest.mark.parametrize("ext", ["mp4", "mkv", "avi", "h264"])
def test_fixture_equals_videocapture_digest(ext):
    """The 960x540 clip in each container: the file and the port's frames at the manifest's digests (cv2's
    frames; one stream, so one digest)."""
    manifest = json.load(open(os.path.join(FIXTURES, "manifest.json")))
    name = f"{CLIP}.{ext}"
    path = os.path.join(FIXTURES, name)
    assert hashlib.sha256(open(path, "rb").read()).hexdigest() == manifest[name]["sha256"]
    frames = np.stack(read_video_frames(path))
    assert list(frames.shape) == manifest[name]["shape"] == [12, 540, 960, 3]
    assert hashlib.sha256(frames.tobytes()).hexdigest() == manifest[name]["frames_sha256"] \
        == manifest[f"{CLIP}.mp4"]["frames_sha256"]


def test_fixture_reaches_what_it_was_made_for():
    manifest = json.load(open(os.path.join(FIXTURES, "manifest.json")))
    video = read_mp4_video(open(os.path.join(FIXTURES, f"{CLIP}.mp4"), "rb").read())
    decoder = H264Decoder(video.config)
    frames = [f for s in video.samples for f in decoder.decode(s)]
    stats = decoder.stats
    assert len(frames) == 12 and stats["idr_pictures"] == 1 and stats["p_slices"] == 11
    assert stats["cropped_pictures"] == 12 and stats["deblock_idc_1"] == 12
    assert {k: stats[k] for k in ("I_16x16", "P_L0_16x16", "P_Skip")} == manifest["encoding"]["macroblocks"]
    assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in os.listdir(FIXTURES)) < 1_000_000


def test_encoder_reconstruction_is_ffmpegs():
    """The writer's encoder in the closed loop: its reconstruction is FFmpeg's decode, frame for frame."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (40, 80, 3)).astype(np.uint8)
    base = np.repeat(np.repeat(base, 2, 0), 2, 1)
    frames = [np.ascontiguousarray(base[i:i + 36, 3 * i:3 * i + 48]) for i in range(4)]
    aus, recon, encoder = encode_frames(frames, qp=26, search=3)
    planes = decode_planes("h264", [annexb([au]) for au in aus], "yuv420p", 48, 36)
    assert len(planes) == 4 and encoder.stats["P_L0_16x16"] > 0
    for r, p in zip(recon, planes):
        for a, b in zip(r, p):
            np.testing.assert_array_equal(a, b)


# --- refusals and damage --------------------------------------------------------------------------


def _stream(options=None, sps=None, pps=None, frames=3, seed=9):
    """A small random stream (Annex B), its SPS and PPS fields changed first."""
    writer = StreamWriter(np.random.default_rng(seed), Options(mb_width=3, mb_height=2, frames=frames,
                                                               **(options or {})))
    for key, value in (sps or {}).items():
        setattr(writer.sps, key, value)
    for p in writer.ppss:
        for key, value in (pps or {}).items():
            setattr(p, key, value)
    return [writer.picture() for _ in range(frames)]


def _slice_of_type(slice_type, cabac=False):
    w = BitWriter()
    w.ue(0)
    w.ue(slice_type)
    w.ue(0)
    w.trailing()
    return [nal_unit(3, 7, Sps(3, 2, profile_idc=100 if cabac else 66).rbsp()), nal_unit(3, 8, Pps(cabac=cabac).rbsp()),
            nal_unit(3, 1, w.data())]


def _swap_slices(aus):
    for au in aus[1:]:
        slices = [i for i, n in enumerate(au) if n[0] & 31 in (1, 5)]
        if len(slices) >= 2:
            au[slices[0]], au[slices[1]] = au[slices[1]], au[slices[0]]
            return aus
    raise AssertionError("no picture of several slices")


REFUSALS = {
    "SP slices": lambda: [_slice_of_type(3)],
    "SI slices": lambda: [_slice_of_type(9)],
    "frame_mbs_only_flag 0": lambda: _stream(sps=dict(frame_mbs_only=False, mb_height=2)),
    "chroma_format_idc 2": lambda: _stream(sps=dict(profile_idc=122, chroma_format_idc=2)),
    "chroma_format_idc 0": lambda: _stream(sps=dict(profile_idc=100, chroma_format_idc=0)),
    "above 8 bits": lambda: _stream(sps=dict(profile_idc=110, bit_depth=10)),
    "separate_colour_plane_flag": lambda: _stream(sps=dict(profile_idc=244, chroma_format_idc=3,
                                                           separate_colour_plane=True)),
    "lossless bypass": lambda: _stream(sps=dict(profile_idc=244, bypass=True)),
    "slice groups": lambda: _stream(pps=dict(slice_groups=2)),
    "arbitrary slice order": lambda: _swap_slices(_stream(frames=8, seed=12)),
    "redundant pictures": lambda: _stream(options=dict(redundant_pic_cnt=1), pps=dict(redundant_pic_cnt=True)),
    "data partitioning": lambda: [_stream()[0] + [nal_unit(2, 2, b"\x80")]],
    "gaps in frame_num": lambda: (lambda a: a[:2] + a[3:])(_stream(options=dict(non_ref=False, mmco=False), frames=5,
                                                                   sps=dict(poc_type=2))),
    "a picture size that changes": lambda: _stream() + [StreamWriter(np.random.default_rng(3), Options(
        mb_width=2, mb_height=2, frames=1)).picture()],
    "a left crop": lambda: _stream(sps=dict(crop=(1, 0, 0, 0))),
    "matrix_coefficients 9": lambda: _stream(sps=dict(vui=True, matrix=9)),
    "matrix_coefficients 0": lambda: _stream(sps=dict(vui=True, matrix=0)),
    "no_output_of_prior_pics_flag": lambda: _stream(options=dict(no_output_of_prior_pics=True)),
    "without an IDR picture": lambda: _stream(options=dict(first_non_idr=True)),
    # Without the VUI's bitstream_restriction_flag (with it, FORMERLY_REFUSED).
    "does not increase": lambda: _stream(options=dict(poc_step=0), sps=dict(poc_type=0, bitstream_restriction=False),
                                         frames=3),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_refusals_name_what_they_are(tmp_path, what):
    path = _write(tmp_path, "refused.h264", annexb(REFUSALS[what]()))
    with pytest.raises(NotImplementedError, match=what):
        read_video_frames(path)


# The streams of the refusals that the High-profile tools and B slices replaced: each now decodes to cv2's frames.
FORMERLY_REFUSED = {
    "B slices": lambda: _stream(options=dict(b_frames=True), frames=8),
    "with B slices": lambda: _stream(options=dict(b_frames=True, cabac=True), sps=dict(profile_idc=100), frames=8),
    "does not increase with the VUI's restriction": lambda: _stream(
        options=dict(poc_step=0), sps=dict(poc_type=0, vui=True, bitstream_restriction=True), frames=3),
    "CABAC": lambda: _stream(pps=dict(cabac=True)),
    "transform_8x8_mode_flag": lambda: _stream(pps=dict(transform_8x8=True), sps=dict(profile_idc=100)),
    "scaling matrices in the SPS": lambda: _stream(sps=dict(profile_idc=100, scaling_lists=[None] * 8)),
    "scaling matrices in the PPS": lambda: _stream(sps=dict(profile_idc=100), pps=dict(scaling_lists=[None] * 6)),
    "second_chroma_qp_index_offset": lambda: _stream(sps=dict(profile_idc=100),
                                                     pps=dict(chroma_qp_offset=2, second_chroma_qp_offset=-3)),
}


@pytest.mark.parametrize("what", list(FORMERLY_REFUSED))
def test_formerly_refused_streams_equal_videocapture(tmp_path, what):
    path = _write(tmp_path, "high.h264", annexb(FORMERLY_REFUSED[what]()))
    _assert_frames_equal(read_video_frames(path), capture(path))


@pytest.mark.parametrize("seed", range(4))
def test_mmco5_equals_videocapture(tmp_path, seed):
    """MMCO 5 in POC type 0 streams whose lsb goes on counting: FFmpeg's POC, which goes on from the reset
    picture's count rather than starting over, increases, so cv2 gives the pictures in decoding order."""
    found = 0
    for k in range(12):
        aus, stats, _, _, _ = random_stream(5000 + 20 * seed + k, mb_width=2, mb_height=2, frames=12, poc_type=0,
                                            poc_step=4, max_refs=3)
        if not stats["mmco_5"]:
            continue
        found += 1
        path = _write(tmp_path, f"{k}.h264", annexb(aus))
        _assert_frames_equal(_decode(annexb(aus))[0], capture(path))
    assert found


@pytest.mark.parametrize("restriction", [False, True])
def test_mmco5_with_frame_num_pocs_is_refused(tmp_path, restriction):
    """POC type 2 after an MMCO 5: FFmpeg's count starts from the reset frame_num while it keeps the reset
    picture's offset, so it goes back. Without the VUI's bitstream restriction FFmpeg's order then depends on its
    threads: refused by name; with it (max_num_reorder_frames 0) FFmpeg outputs each picture, and so does the
    port: cv2's frames."""
    writer = StreamWriter(np.random.default_rng(4), Options(mb_width=2, mb_height=2, frames=4, poc_type=2))
    writer.sps.vui = writer.sps.bitstream_restriction = restriction
    aus = [writer.picture(), writer.picture()]
    writer.o.mmco = True
    plan = writer.plan_marking
    writer.plan_marking = lambda idr, ref_idc, frame_num: ({"adaptive": True, "ops": [(5,)], "mmco5": True}
                                                           if ref_idc and not idr else plan(idr, ref_idc, frame_num))
    writer.last_non_ref = True  # the next picture is a reference
    aus.append(writer.picture())
    writer.plan_marking = plan
    aus += [writer.picture(), writer.picture()]
    path = _write(tmp_path, "mmco5.h264", annexb(aus))
    if restriction:
        _assert_frames_equal(read_video_frames(path), capture(path))
        return
    with pytest.raises(NotImplementedError, match="does not increase"):
        read_video_frames(path)


def test_left_crop_is_refused_as_cv2_rescales_it(tmp_path):
    """cv2.VideoCapture gives a left-cropped stream's frames at the cropped width, but libavcodec returns them
    uncropped at the left (for alignment) and OpenCV rescales them: the port refuses such streams by name."""
    aus, _, coded, size, _ = random_stream(3, mb_width=4, mb_height=2, frames=2, crop=(2, 0, 0, 2))
    path = _write(tmp_path, "left.h264", annexb(aus))
    assert [f.shape for f in capture(path)] == [(size[1], size[0], 3)] * 2 and size[0] == coded[0] - 4
    with pytest.raises(NotImplementedError, match=r"a left crop \(frame_crop_left_offset 2\)"):
        read_video_frames(path)


def test_avcc_announcing_cabac_decodes(tmp_path):
    """An avcC record whose PPS announces CABAC: the decoder takes it, and the .mp4 around it decodes to cv2's
    frames."""
    aus, _, _, size, _ = random_stream(31, mb_width=2, mb_height=2, frames=3, cabac=True)
    sps = [n for n in aus[0] if n[0] & 31 == 7]
    pps = [n for n in aus[0] if n[0] & 31 == 8]
    config = avcc(sps, pps)
    assert config[0] == 1 and H264Decoder(config).size == (0, 0)
    path = _write(tmp_path, "cabac.mp4", mp4(aus, *size))
    _assert_frames_equal(read_video_frames(path), capture(path))
    with pytest.raises(ValueError, match="configurationVersion"):
        H264Decoder(b"\x00" + config[1:])


def test_damaged_streams_raise_value_error():
    aus = _stream(frames=3)
    data = annexb(aus)
    parameter_sets = [n for n in aus[0] if n[0] & 31 in (7, 8)]
    with pytest.raises(ValueError, match="P slice before the first IDR"):
        _decode(annexb([parameter_sets] + aus[1:]))
    last = aus[-1][-1]
    with pytest.raises(ValueError, match="Corrupt H.264 stream"):
        _decode(data[:len(data) - len(last) // 2])
    with pytest.raises(ValueError, match="empty reference list entry|past num_ref_idx"):
        _decode(annexb(_stream(options=dict(bad_ref_idx=True, intra_share=0.0, skip_share=0.0), frames=3)))
    with pytest.raises(ValueError, match="forbidden_zero_bit"):
        _decode(b"\0\0\1\x87\x00")


# --- the loader and the resolver against the JAX package's ---------------------------------------


def _small_clip(tmp_path):
    rng = np.random.default_rng(21)
    import cv2

    base = np.clip(cv2.GaussianBlur(rng.uniform(0, 255, (64, 64, 3)), (0, 0), 2.0) * 3 - 256, 0, 255).astype(np.uint8)
    frames = [np.ascontiguousarray(base[i:i + 24, 2 * i:2 * i + 24]) for i in range(6)]
    aus, _, _ = encode_frames(frames, qp=20, search=3)
    return _write(tmp_path, "clip.mp4", mp4(aus, 24, 24))


def test_loader_matches_jax(tmp_path):
    """The port's VideoLoader and the JAX one (cv2.VideoCapture) on the same .mp4, float64, equal."""
    path = _small_clip(tmp_path)
    for max_frames in (0, 4):
        ours, theirs = VideoLoader(**CPU), JVideoLoader()
        ours.load_frames_from_video(path, max_frames)
        theirs.load_frames_from_video(path, max_frames)
        assert ours.num_frames == theirs.num_frames == (max_frames or 6)
        assert ours.image_size == theirs.image_size == (24, 24)
        np.testing.assert_array_equal(ours.frame_stack().numpy(), theirs.frame_stack())


def test_super_resolver_matches_jax_on_decoded_frames(tmp_path):
    """The port's VideoSuperResolver on the port's decode of the first 4 frames of an avc1 .mp4, and the JAX one on
    cv2.VideoCapture's frames of the same file (window 3, no blur), to 1e-8 of the largest entry."""
    path = _small_clip(tmp_path)
    loader, jloader = VideoLoader(**CPU), JVideoLoader()
    loader.load_frames_from_video(path, 4)
    jloader.load_frames_from_video(path, 4)
    kwargs = dict(scale=2, temporal_window=3, blur_radius=0)
    theirs = np.asarray(JVideoSuperResolver(**kwargs).super_resolve(np.asarray(jloader.frame_stack())))
    ours = VideoSuperResolver(**kwargs, **CPU).super_resolve(loader.frame_stack()).numpy()
    assert ours.shape == theirs.shape == (4, 3, 48, 48)
    assert np.abs(ours - theirs).max() <= 1e-8 * np.abs(theirs).max()


def test_stats_names_match_the_native_counts():
    decoder = H264Decoder()
    assert decoder.size == (0, 0) and set(decoder.stats.values()) == {0}
    aus, _, _, _, _ = random_stream(5, mb_width=2, mb_height=2, frames=1)
    frames = decoder.decode(annexb(aus))
    assert frames[0].shape == (32, 32, 3) and decoder.size == (32, 32)
    assert decoder.stats["pictures"] == decoder.stats["idr_pictures"] == 1
    assert [p.shape for p in decoder.planes()] == [(32, 32), (16, 16), (16, 16)]
    assert decoder.flush() == []
