"""The video slice: the port's ``VideoSuperResolver`` and ``VideoLoader``
against the JAX package's, float64 on the CPU, on the same numpy frames.

The resolvers agree to 1e-8 of the largest entry (measured: <= 1.2e-13): the
same windows, registration, image model, IRLS BTV solve and linear start.
The loaders agree to 1e-12 on a PNG directory. For video the JAX loader
decodes with ``cv2.VideoCapture`` (FFmpeg); the port reads the file itself.
Here: its Motion-JPEG AVI frames are bit-equal to ``cv2.imdecode`` of each
frame's JPEG payload (OpenCV's libjpeg-turbo), and differ from
``VideoCapture``'s frames by FFmpeg's own MJPEG decoder and colour
conversion: on the clips here by at most 26 grey levels and at most 1.9 on
average (measured 16-26 and 0.94-1.81; ROADMAP.md, Queue 3). Uncompressed
24-bit AVI frames are the bytes written. ``cv2.VideoWriter`` cannot write
that format here (its FFmpeg backend stores fourcc 0 as I420), and
``cv2.VideoCapture`` aborts on such a file in this OpenCV build, so the test
writes it with its own RIFF writer and holds the frames against what it
wrote. MPEG-4 Part 2 video (MP4, and AVI with ``XVID`` and the like) has its
own tests, ``tests/test_torch_mpeg4.py``; here only the containers and
codecs still refused.
"""

import hashlib
import os
import struct
import sys

import cv2
import numpy as np
import pytest
import torch

from super_resolution_tpu.solvers import IRLSMapSolverOptions as JOptions
from super_resolution_tpu.video import VideoLoader as JVideoLoader
from super_resolution_tpu.video import VideoSuperResolver as JVideoSuperResolver

from super_resolution_tpu_torch import IRLSMapSolverOptions
from super_resolution_tpu_torch.solvers import irls
from super_resolution_tpu_torch.utils.image_io import read_image
from super_resolution_tpu_torch.video import VideoLoader, VideoSuperResolver
from super_resolution_tpu_torch.video.video_loader import read_avi_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from make_torch_video_fixture import scene as fixture_scene  # noqa: E402

CPU = dict(device="cpu", dtype=torch.float64)
TOL = 1e-8
FIXTURE = os.path.join(REPO, "tests", "data_torch", "mjpeg_160x120x8.avi")
# SHA-256 of the port's decode of FIXTURE: 8 frames of 120x160x3 uint8, BGR, C order.
FIXTURE_SHA256 = "2e73a5dd9b4206cdc215e3c8b8f8fb5cb69678eb48184e53581eaa7d6882f16c"
# cv2.VideoCapture (FFmpeg) against cv2.imdecode (libjpeg-turbo) on the MJPEG clips here.
CAPTURE_GAP_MAX, CAPTURE_GAP_MEAN = 26, 1.9


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _frames(c, h, w, k=4, seed=3):
    """A textured scene moved by whole LR pixels, with noise, in [0, 1]: ``[k, c, h, w]``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([0.5 + 0.3 * np.sin(xx / 2.3 + ch) * np.cos(yy / 3.1) for ch in range(c)])
    base += 0.05 * rng.standard_normal(base.shape)
    out = [np.roll(base, (i % 2, i // 2), axis=(1, 2)) + 0.01 * rng.standard_normal(base.shape) for i in range(k)]
    return np.clip(np.stack(out), 0, 1)


def _close(ours, theirs, tol=TOL):
    ours, theirs = ours.detach().cpu().numpy(), np.asarray(theirs)
    assert ours.shape == theirs.shape
    assert np.abs(ours - theirs).max() <= tol * np.abs(theirs).max()


CASES = {
    # tests/test_video.py's two cases: window 3 without blur, and 2 x 6 with refinement.
    "window3_blur0": (dict(scale=2, temporal_window=3, blur_radius=0), None),
    "refine_2x6": (dict(scale=2, temporal_window=3, blur_radius=3, blur_sigma=0.7),
                   dict(max_num_irls_iterations=2, max_num_solver_iterations=6, refine_motion_every=1)),
}


@pytest.mark.parametrize("chw", [(1, 16, 16), (3, 12, 12)], ids=["1x16x16", "3x12x12"])
@pytest.mark.parametrize("case", list(CASES))
def test_super_resolve_matches_jax(case, chw):
    kwargs, options = CASES[case]
    frames = _frames(*chw)
    theirs = JVideoSuperResolver(solver_options=options and JOptions(**options), **kwargs).super_resolve(frames)
    resolver = VideoSuperResolver(solver_options=options and IRLSMapSolverOptions(**options), **kwargs, **CPU)
    ours = resolver.super_resolve(frames)
    assert ours.shape == (4, chw[0], 2 * chw[1], 2 * chw[2]) and ours.dtype == torch.float64
    _close(ours, theirs)


@pytest.mark.parametrize("chw", [(1, 48, 48), (3, 48, 48)], ids=["1x48x48", "3x48x48"])
def test_robust_registration_matches_jax(chw):
    """``robust_registration=True`` (per-block consensus) with the JAX
    defaults, one window; 48 px is the smallest side whose 3x3 blocks the
    robust estimator takes."""
    frames = _frames(*chw)
    theirs = JVideoSuperResolver(robust_registration=True).super_resolve_frame(frames, 1)
    ours = VideoSuperResolver(robust_registration=True, **CPU).super_resolve_frame(torch.from_numpy(frames), 1)
    assert ours.shape == (chw[0], 96, 96)
    _close(ours, theirs)


def test_robust_registration_refuses_small_blocks_as_jax_does():
    frames = _frames(1, 16, 16)
    with pytest.raises(ValueError, match="too small"):
        JVideoSuperResolver(robust_registration=True).super_resolve_frame(frames, 0)
    with pytest.raises(ValueError, match="too small"):
        VideoSuperResolver(robust_registration=True, **CPU).super_resolve_frame(frames, 0)


def test_fused_video_equals_the_host_loop_and_builds_once():
    """``fused_irls`` over a video: one built fused solve serves every window
    (the built-solver cache), and every frame is bit-equal to the host loop's
    with the same iterations and evaluations."""
    frames = _frames(3, 12, 12, k=5)
    options = dict(max_num_irls_iterations=2, max_num_solver_iterations=6, least_squares_solver="linear_cg")
    host = VideoSuperResolver(solver_options=IRLSMapSolverOptions(**options), **CPU)
    fused = VideoSuperResolver(solver_options=IRLSMapSolverOptions(**options, fused_irls=True), **CPU)
    irls._BUILT_SOLVER_CACHE.clear()
    built = set()
    for i in range(5):
        x_host = host.super_resolve_frame(frames, i)
        x_fused = fused.super_resolve_frame(frames, i)
        assert torch.equal(x_host, x_fused)
        assert [c[1:] for c in fused.last_solver.last_inner_calls] == [c[1:] for c in host.last_solver.last_inner_calls]
        built.add(id(fused.last_solver.last_fused))
    assert len(built) == 1 and len(irls._BUILT_SOLVER_CACHE) == 1


# --- the loader ------------------------------------------------------------------


@pytest.fixture()
def frame_dir(tmp_path):
    """Four colour frames and their names out of order, as PNG."""
    d = tmp_path / "frames"
    d.mkdir()
    base = fixture_scene(5)[:28, :36]
    for i in (2, 0, 3, 1):
        cv2.imwrite(str(d / f"frame_{i}.png"), np.roll(base, i, axis=1))
    return str(d)


def test_load_frames_from_directory_matches_jax(frame_dir):
    ours, theirs = VideoLoader(**CPU), JVideoLoader()
    ours.load_frames_from_directory(frame_dir)
    theirs.load_frames_from_directory(frame_dir)
    assert ours.num_frames == theirs.num_frames == 4
    assert ours.image_size == theirs.image_size == (36, 28)
    for a, b in zip(ours.get_frames(), theirs.get_frames()):
        _close(a, b, 1e-12)
    stack = ours.frame_stack()
    assert stack.shape == (4, 3, 28, 36) and stack.device.type == "cpu" and stack.dtype == torch.float64
    _close(stack, theirs.frame_stack(), 1e-12)
    assert VideoLoader(**CPU).frame_stack().shape == (0, 0, 0, 0) and VideoLoader(**CPU).image_size == (0, 0)


def test_play_original_video_headless_matches_jax(frame_dir, monkeypatch):
    """PlayOriginalVideo (video_loader.cpp:62-77) as the JAX loader's headless
    branch: 1000x600 PNGs, within one grey level of cv2.resize's."""
    monkeypatch.delenv("DISPLAY", raising=False)
    ours, theirs = VideoLoader(**CPU), JVideoLoader()
    ours.load_frames_from_directory(frame_dir)
    theirs.load_frames_from_directory(frame_dir)
    our_paths, their_paths = ours.play_original_video(), theirs.play_original_video()
    assert len(our_paths) == len(their_paths) == 4
    for a, b in zip(our_paths, their_paths):
        mine, reference = read_image(a), cv2.imread(b, cv2.IMREAD_UNCHANGED)
        assert mine.shape == reference.shape == (600, 1000, 3)
        assert np.abs(mine.astype(int) - reference.astype(int)).max() <= 1


def _capture(path):
    cap, frames = cv2.VideoCapture(path), []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def _jpeg_payloads(path):
    """Each JPEG in the file, SOI to EOI, in file order."""
    data, out, pos = open(path, "rb").read(), [], 0
    while (start := data.find(b"\xff\xd8\xff", pos)) >= 0:
        end = data.index(b"\xff\xd9", start) + 2
        out.append(data[start:end])
        pos = end
    return out


@pytest.mark.parametrize("backend,size", [("ffmpeg", (64, 48)), ("ffmpeg", (53, 37)), ("opencv", (64, 48)),
                                          ("opencv", (53, 37))])
def test_mjpeg_avi_frames_are_imdecode_of_their_payloads(tmp_path, backend, size):
    path = str(tmp_path / "clip.avi")
    api = cv2.CAP_FFMPEG if backend == "ffmpeg" else cv2.CAP_OPENCV_MJPEG
    writer = cv2.VideoWriter(path, api, cv2.VideoWriter_fourcc(*"MJPG"), 10, size)
    base = fixture_scene(7)
    for i in range(6):
        writer.write(np.ascontiguousarray(base[: size[1], i: i + size[0]]))
    writer.release()
    frames = read_avi_frames(path)
    payloads = _jpeg_payloads(path)
    assert len(frames) == len(payloads) == 6
    for frame, payload in zip(frames, payloads):
        np.testing.assert_array_equal(frame, cv2.imdecode(np.frombuffer(payload, np.uint8), cv2.IMREAD_COLOR))
    gap = np.abs(np.stack(frames).astype(int) - np.stack(_capture(path)).astype(int))
    assert gap.max() <= CAPTURE_GAP_MAX and gap.mean() <= CAPTURE_GAP_MEAN
    loader = VideoLoader(**CPU)
    loader.load_frames_from_video(path, max_frames=4)
    # FFmpeg's 4:2:0 writer rounds odd sides down to even ones.
    assert loader.num_frames == 4 and loader.image_size == frames[0].shape[1::-1]
    np.testing.assert_array_equal(loader.frame_stack().numpy(),
                                  np.stack([np.moveaxis(f, -1, 0) for f in frames[:4]]).astype(np.float64) / 255.0)


def test_the_fixture_decodes_to_its_recorded_digest():
    """The MJPEG fixture that chip_smoke.py decodes on the card's host:
    8 frames of 120x160, bit-equal to cv2.imdecode, and the digest of the
    decode it holds the card's machine to."""
    frames = read_avi_frames(FIXTURE)
    assert len(frames) == 8 and frames[0].shape == (120, 160, 3)
    for frame, payload in zip(frames, _jpeg_payloads(FIXTURE)):
        np.testing.assert_array_equal(frame, cv2.imdecode(np.frombuffer(payload, np.uint8), cv2.IMREAD_COLOR))
    assert hashlib.sha256(np.stack(frames).tobytes()).hexdigest() == FIXTURE_SHA256
    gap = np.abs(np.stack(frames).astype(int) - np.stack(_capture(FIXTURE)).astype(int))
    assert gap.max() <= CAPTURE_GAP_MAX and gap.mean() <= CAPTURE_GAP_MEAN
    assert len(read_avi_frames(FIXTURE, max_frames=3)) == 3


# --- uncompressed AVI, written here ---------------------------------------------------


def _chunk(fourcc, body):
    return fourcc + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")


def _list(kind, fourcc, body):
    return _chunk(kind, fourcc + body)


def _write_bgr24_avi(path, frames, top_down=False, avix_from=None):
    """A RIFF AVI of uncompressed 24-bit BGR frames (BI_RGB): bottom-up rows
    unless ``top_down`` (a negative height), each padded to 4 bytes, with an
    ``idx1`` index; frames from ``avix_from`` on go into an OpenDML
    ``AVIX`` RIFF."""
    h, w = frames[0].shape[:2]
    stride = (w * 3 + 3) & ~3

    def payload(frame):
        rows = np.zeros((h, stride), np.uint8)
        rows[:, : w * 3] = frame.reshape(h, -1)
        return (rows if top_down else rows[::-1]).tobytes()

    main = len(frames) if avix_from is None else avix_from
    avih = struct.pack("<14I", 100000, 0, 0, 0x10, main, 0, 1, stride * h, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"\0\0\0\0", 0, 0, 0, 0, 1, 10, 0, len(frames),
                       stride * h, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, 24, 0, stride * h, 0, 0, 0, 0)
    hdrl = _list(b"LIST", b"hdrl", _chunk(b"avih", avih)
                 + _list(b"LIST", b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    movi = b"".join(_chunk(b"00db", payload(f)) for f in frames[:main])
    idx1 = b"".join(struct.pack("<4sIII", b"00db", 0x10, 4 + i * (8 + stride * h), stride * h) for i in range(main))
    data = _list(b"RIFF", b"AVI ", hdrl + _list(b"LIST", b"movi", movi) + _chunk(b"idx1", idx1))
    if avix_from is not None:
        data += _list(b"RIFF", b"AVIX", _list(b"LIST", b"movi", b"".join(_chunk(b"00db", payload(f))
                                                                           for f in frames[main:])))
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up", "top_down"])
@pytest.mark.parametrize("avix_from", [None, 3], ids=["one_riff", "opendml_avix"])
def test_uncompressed_avi_frames_are_the_bytes_written(tmp_path, top_down, avix_from):
    rng = np.random.default_rng(11)
    written = [rng.integers(0, 256, (9, 13, 3), dtype=np.uint8) for _ in range(5)]  # 39-byte rows, padded to 40
    path = str(tmp_path / "raw.avi")
    _write_bgr24_avi(path, written, top_down, avix_from)
    frames = read_avi_frames(path)
    assert len(frames) == 5
    for a, b in zip(frames, written):
        np.testing.assert_array_equal(a, b)
    assert len(read_avi_frames(path, max_frames=4)) == 4
    loader = VideoLoader(**CPU)
    loader.load_frames_from_video(path)
    assert loader.image_size == (13, 9)
    np.testing.assert_array_equal(loader.get_frames()[4].numpy(), written[4].astype(np.float64) / 255.0)


def test_other_containers_and_codecs_raise(tmp_path):
    mkv = str(tmp_path / "clip.mkv")  # Matroska with FFV1, refused until the port read it: now the frames written
    writer = cv2.VideoWriter(mkv, cv2.VideoWriter_fourcc(*"FFV1"), 10, (32, 24))
    assert writer.isOpened()
    for i in range(3):
        writer.write(np.full((24, 32, 3), 40 * i, np.uint8))
    writer.release()
    loader = VideoLoader(**CPU)
    loader.load_frames_from_video(mkv)
    assert loader.num_frames == 3
    for i, frame in enumerate(loader.get_frames()):
        assert torch.equal(frame, torch.full((24, 32, 3), 40 * i / 255.0, dtype=torch.float64))
    hfyu = str(tmp_path / "hfyu.mkv")  # Matroska with HuffYUV: a codec the port does not decode
    writer = cv2.VideoWriter(hfyu, cv2.VideoWriter_fourcc(*"HFYU"), 10, (32, 24))
    assert writer.isOpened()
    for i in range(3):
        writer.write(np.full((24, 32, 3), 40 * i, np.uint8))
    writer.release()
    with pytest.raises(NotImplementedError, match="HFYU"):
        VideoLoader(**CPU).load_frames_from_video(hfyu)
    i420 = str(tmp_path / "i420.avi")  # what cv2.VideoWriter writes for fourcc 0
    writer = cv2.VideoWriter(i420, 0, 10, (32, 24))
    for i in range(3):
        writer.write(np.full((24, 32, 3), 40 * i, np.uint8))
    writer.release()
    with pytest.raises(NotImplementedError, match="I420"):
        read_avi_frames(i420)
    with pytest.raises(FileNotFoundError):
        read_avi_frames(str(tmp_path / "missing.avi"))
