"""Matroska and WebM in the port (``video/mkv.py`` and its routing in
``video/video_loader.py``), held against ``cv2.VideoCapture`` -- the JAX
package's video path -- on the same files.

Files ``cv2.VideoWriter`` writes to .mkv (``V_MPEG4/ISO/ASP`` for the
``mp4v`` / ``XVID`` fourccs, ``V_MJPEG``, ``V_FFV1``, ``V_VP9``) and .webm
(``V_VP8``, ``V_VP9``), and rewrites of them made here with a small EBML
writer (SeekHead, Cues and Void dropped, so that FFmpeg reads the clusters in
order): Xiph, EBML and fixed-size lacing, clusters and a segment of unknown
size, blocks in ``BlockGroup`` s, ``V_MS/VFW/FOURCC`` tracks (MPEG-4 Part 2,
VP8 and uncompressed), ``ContentEncodings``, a second video track, other
codec IDs and a VP8 key frame that asks for scaling. MPEG-4 Part 2, VP8,
VP9 and FFV1 frames are array-equal to cv2.VideoCapture's (``tests/test_torch_vp8.py``
holds VP8 in .webm, ``tests/test_torch_vp9.py`` VP9, ``tests/test_torch_ffv1.py``
FFV1); Motion-JPEG frames are each what
``cv2.imdecode`` gives for the block, within the bounds the AVI reader is held
to (26 grey levels, 1.9 on average) of cv2.VideoCapture's. What the port does
not read raises ``NotImplementedError`` naming it. The loader matches the JAX
loader on a Matroska clip.
"""

import os
import struct
import sys

import cv2
import numpy as np
import pytest
import torch

from super_resolution_tpu.video import VideoLoader as JVideoLoader

from super_resolution_tpu_torch.video import VideoLoader
from super_resolution_tpu_torch.video.mkv import read_matroska_video
from super_resolution_tpu_torch.video.video_loader import read_video_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from make_torch_video_fixture import scene  # noqa: E402

MJPEG_GAP_MAX, MJPEG_GAP_MEAN = 26, 1.9
SEGMENT, CLUSTER, TRACKS, TRACK_ENTRY, VIDEO = 0x18538067, 0x1F43B675, 0x1654AE6B, 0xAE, 0xE0
SIMPLE_BLOCK, BLOCK_GROUP, BLOCK, CODEC_ID, CODEC_PRIVATE = 0xA3, 0xA0, 0xA1, 0x86, 0x63A2
TRACK_NUMBER, TRACK_UID, DROPPED = 0xD7, 0x73C5, {0x114D9B74, 0x1C53BB6B, 0xEC, 0xBF}  # SeekHead, Cues, Void, CRC
MASTERS = {SEGMENT, CLUSTER, TRACKS, TRACK_ENTRY, VIDEO, BLOCK_GROUP}
UNKNOWN = b"\x01\xff\xff\xff\xff\xff\xff\xff"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _write(path, fourcc, frames, fps=10):
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert writer.isOpened(), f"cv2.VideoWriter cannot write {fourcc} to {path}"
    for frame in frames:
        writer.write(np.ascontiguousarray(frame))
    writer.release()


def _capture(path):
    capture, frames = cv2.VideoCapture(path), []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(frame)
    capture.release()
    return frames


def _pan(w, h, n, seed=3):
    base = scene(seed, h, w + n)
    return [base[:, i:i + w].copy() for i in range(n)]


# --- a small EBML reader and writer, for rewriting what cv2.VideoWriter writes -------------


def _vint(data, pos, keep_marker):
    length = 9 - data[pos].bit_length()
    value = int.from_bytes(data[pos:pos + length], "big")
    return (value if keep_marker else value & ((1 << (7 * length)) - 1)), pos + length


def _parse(data, start=0, end=None):
    """``[[id, body]]`` of the elements in ``data[start:end]``, master elements' bodies parsed in turn."""
    nodes, pos, end = [], start, len(data) if end is None else end
    while pos < end:
        ident, pos = _vint(data, pos, True)
        size, pos = _vint(data, pos, False)
        body = data[pos:pos + size]
        nodes.append([ident, _parse(data, pos, pos + size) if ident in MASTERS else body])
        pos += size
    return nodes


def _size(n):
    length = next(k for k in range(1, 9) if n < (1 << (7 * k)) - 1)
    return ((1 << (7 * length)) | n).to_bytes(length, "big")


def _build(nodes, unknown=()):
    """The bytes of ``nodes``; elements whose ID is in ``unknown`` get the unknown size."""
    out = b""
    for ident, body in nodes:
        if ident in DROPPED:
            continue
        payload = _build(body, unknown) if isinstance(body, list) else body
        out += ident.to_bytes((ident.bit_length() + 7) // 8, "big") + (UNKNOWN if ident in unknown else
                                                                        _size(len(payload))) + payload
    return out


def _find(nodes, ident):
    return [node for node in nodes if node[0] == ident]


def _segment(tree):
    return _find(tree, SEGMENT)[0][1]


def _blocks(tree):
    """(cluster, index, SimpleBlock body) of every block, in file order."""
    return [(cluster, i, node[1]) for cluster in _find(_segment(tree), CLUSTER)
            for i, node in enumerate(cluster[1]) if node[0] == SIMPLE_BLOCK]


def _track(tree):
    return _find(_find(_segment(tree), TRACKS)[0][1], TRACK_ENTRY)[0][1]


def _set(entry, ident, body):
    found = _find(entry, ident)
    if found:
        found[0][1] = body
    else:
        entry.append([ident, body])


def _laced(tree, lacing, per_block=3):
    """Every ``per_block`` frames of each cluster in one SimpleBlock with ``lacing`` (1 Xiph, 3 EBML, 2 fixed)."""
    for cluster in _find(_segment(tree), CLUSTER):
        blocks = [node for node in cluster[1] if node[0] == SIMPLE_BLOCK]
        others = [node for node in cluster[1] if node[0] != SIMPLE_BLOCK]
        laced = []
        for k in range(0, len(blocks), per_block):
            group = [b[1] for b in blocks[k:k + per_block]]
            frames = [g[4:] for g in group]
            if len(frames) == 1:
                laced.append([SIMPLE_BLOCK, group[0]])
                continue
            head = group[0][:3] + bytes([(group[0][3] & 0xF9) | lacing << 1, len(frames) - 1])
            if lacing == 1:
                sizes = b"".join(b"\xff" * (len(f) // 255) + bytes([len(f) % 255]) for f in frames[:-1])
            elif lacing == 3:
                sizes = _size(len(frames[0]))
                for a, b in zip(frames, frames[1:-1]):
                    sizes += (len(b) - len(a) + (1 << 13) - 1 | 1 << 14).to_bytes(2, "big")  # 2-byte signed
            else:
                longest = max(len(f) for f in frames)
                frames, sizes = [f + bytes(longest - len(f)) for f in frames], b""  # zeros after the JPEG's EOI
            laced.append([SIMPLE_BLOCK, head + sizes + b"".join(frames)])
        cluster[1] = others + laced
    return tree


def _rewritten(tmp_path, src, name, change, unknown=()):
    tree = _parse(open(src, "rb").read())
    change(tree)
    path = str(tmp_path / name)
    open(path, "wb").write(_build(tree, unknown))
    return path


@pytest.fixture(scope="module")
def mp4v_mkv(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mkv") / "mp4v.mkv")
    _write(path, "mp4v", _pan(64, 48, 14))
    return path


@pytest.fixture(scope="module")
def mjpeg_mkv(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mkv") / "mjpeg.mkv")
    _write(path, "MJPG", [scene()[:, i:i + 160] for i in range(4)])
    return path


# --- what cv2.VideoWriter writes ----------------------------------------------------------


@pytest.mark.parametrize("fourcc,size", [("mp4v", (64, 48)), ("XVID", (120, 88))], ids=["mp4v", "XVID"])
def test_mpeg4_matroska_equals_videocapture(tmp_path, fourcc, size):
    """``V_MPEG4/ISO/ASP`` with its CodecPrivate as the decoder's configuration: array-equal to
    cv2.VideoCapture, and to the port's decode of the same frames written to .mp4."""
    frames = _pan(*size, 14, seed=sum(size))
    mkv, mp4 = str(tmp_path / "clip.mkv"), str(tmp_path / "clip.mp4")
    _write(mkv, fourcc, frames)
    _write(mp4, "mp4v", frames)
    video = read_matroska_video(open(mkv, "rb").read())
    assert video.codec_id == "V_MPEG4/ISO/ASP" and (video.width, video.height) == size and len(video.frames) == 14
    assert video.codec_private.startswith(b"\x00\x00\x01")
    ours = read_video_frames(mkv)
    theirs = _capture(mkv)
    assert len(ours) == len(theirs) == 14 and all(np.array_equal(a, b) for a, b in zip(ours, theirs))
    assert all(np.array_equal(a, b) for a, b in zip(ours, read_video_frames(mp4)))
    assert len(read_video_frames(mkv, max_frames=5)) == 5


def test_mjpeg_matroska(mjpeg_mkv):
    """``V_MJPEG``: each frame bit-equal to cv2.imdecode of its block, and within the MJPEG AVI's bounds of
    cv2.VideoCapture."""
    blocks = read_matroska_video(open(mjpeg_mkv, "rb").read()).frames
    ours, theirs = np.stack(read_video_frames(mjpeg_mkv)), np.stack(_capture(mjpeg_mkv))
    decoded = np.stack([cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR) for b in blocks])
    np.testing.assert_array_equal(ours, decoded)
    gap = np.abs(ours.astype(int) - theirs)
    assert ours.shape == (4, 120, 160, 3) and gap.max() <= MJPEG_GAP_MAX and gap.mean() <= MJPEG_GAP_MEAN


# --- layouts of the same frames, rewritten here ------------------------------------------------

LAYOUTS = {
    "xiph lacing": (lambda tree: _laced(tree, 1), ()),
    "ebml lacing": (lambda tree: _laced(tree, 3, per_block=4), ()),
    "unknown-size clusters": (lambda tree: None, (CLUSTER,)),
    "unknown-size segment and clusters": (lambda tree: None, (SEGMENT, CLUSTER)),
    "block groups": (lambda tree: [cluster[1].__setitem__(i, [BLOCK_GROUP, [[BLOCK, body]]])
                                   for cluster, i, body in _blocks(tree)], ()),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layouts_equal_videocapture(tmp_path, mp4v_mkv, layout):
    change, unknown = LAYOUTS[layout]
    path = _rewritten(tmp_path, mp4v_mkv, "layout.mkv", change, unknown)
    ours, theirs, original = read_video_frames(path), _capture(path), read_video_frames(mp4v_mkv)
    assert len(ours) == len(theirs) == len(original) == 14
    assert all(np.array_equal(a, b) and np.array_equal(a, c) for a, b, c in zip(ours, theirs, original))


def test_fixed_size_lacing(tmp_path, mjpeg_mkv):
    """Fixed-size lacing needs frames of one size: JPEG frames padded with zeros after their EOI."""
    path = _rewritten(tmp_path, mjpeg_mkv, "fixed.mkv", lambda tree: _laced(tree, 2, per_block=2))
    assert len(_capture(path)) == 4
    ours, original = read_video_frames(path), read_video_frames(mjpeg_mkv)
    assert len(ours) == 4 and all(np.array_equal(a, b) for a, b in zip(ours, original))


def _vfw(fourcc, name=None):
    """The track as ``V_MS/VFW/FOURCC``: a BITMAPINFOHEADER with ``fourcc``, then the configuration;
    ``name`` rewrites the stream's encoder name (its 13-byte ``Lavc`` user data) in the blocks."""

    def change(tree):
        entry = _track(tree)
        config = _find(entry, CODEC_PRIVATE)[0][1]
        video = _find(entry, VIDEO)[0][1]
        w, h = (int.from_bytes(_find(video, i)[0][1], "big") for i in (0xB0, 0xBA))
        header = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, fourcc, w * h * 3, 0, 0, 0, 0)
        _set(entry, CODEC_ID, b"V_MS/VFW/FOURCC")
        _set(entry, CODEC_PRIVATE, header + config.replace(b"Lavc62.28.101", name or b"Lavc62.28.101"))

    return change


@pytest.mark.parametrize("name", [None, b" " * 13], ids=["named", "no-name"])
def test_vfw_fourcc_track(tmp_path, name):
    """A ``V_MS/VFW/FOURCC`` track with ``XVID``: routed as the AVI reader routes it, the four-character
    code read where the stream names no encoder (FFmpeg then takes it for Xvid's: its IDCT, and edges at
    the picture's size at 120x88)."""
    src = str(tmp_path / "src.mkv")
    _write(src, "XVID", _pan(120, 88, 8, seed=9))
    assert b"Lavc62.28.101" in read_matroska_video(open(src, "rb").read()).codec_private
    path = _rewritten(tmp_path, src, "vfw.mkv", _vfw(b"XVID", name))
    ours, theirs = read_video_frames(path), _capture(path)
    assert len(ours) == len(theirs) == 8 and all(np.array_equal(a, b) for a, b in zip(ours, theirs))
    differ = any(not np.array_equal(a, b) for a, b in zip(ours, read_video_frames(src)))
    assert differ == (name is not None)


def test_vp8_vfw_fourcc_track(tmp_path):
    """A ``V_VP8`` track rewritten as ``V_MS/VFW/FOURCC`` with ``VP80``: routed to the VP8 decoder as the AVI
    reader routes it, array-equal to cv2.VideoCapture and to the ``V_VP8`` track's frames."""
    src = str(tmp_path / "src.webm")
    _write(src, "VP80", _pan(64, 48, 8, seed=4))
    assert read_matroska_video(open(src, "rb").read()).codec_id == "V_VP8"

    def change(tree):
        entry = _track(tree)
        _set(entry, CODEC_ID, b"V_MS/VFW/FOURCC")
        _set(entry, CODEC_PRIVATE, struct.pack("<IiiHH4sIiiII", 40, 64, 48, 1, 24, b"VP80", 64 * 48 * 3, 0, 0, 0, 0))

    path = _rewritten(tmp_path, src, "vfw.mkv", change)
    ours, theirs, original = read_video_frames(path), _capture(path), read_video_frames(src)
    assert len(ours) == len(theirs) == len(original) == 8
    assert all(np.array_equal(a, b) and np.array_equal(a, c) for a, b, c in zip(ours, theirs, original))


@pytest.mark.parametrize("padded", [True, False], ids=["padded rows", "packed rows"])
def test_vfw_uncompressed_track(tmp_path, padded):
    """A ``V_MS/VFW/FOURCC`` track with code 0 at 24 bits, as the AVI reader routes it: BGR24 rows, which
    FFmpeg's Matroska demuxer hands over top-down (the header's positive height notwithstanding) at the
    track's PixelWidth x PixelHeight; rows padded to 4 bytes where the block holds them, else packed."""
    w, h = 30, 22  # 90-byte rows, padded to 92
    src = str(tmp_path / "src.mkv")
    _write(src, "mp4v", _pan(w, h, 3))
    rng = np.random.default_rng(5)
    written = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(3)]
    stride = (w * 3 + 3) & ~3 if padded else w * 3

    def change(tree):
        entry = _track(tree)
        _set(entry, CODEC_ID, b"V_MS/VFW/FOURCC")
        _set(entry, CODEC_PRIVATE, struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, bytes(4), 0, 0, 0, 0, 0))
        for (cluster, i, body), frame in zip(_blocks(tree), written):
            rows = np.zeros((h, stride), np.uint8)
            rows[:, :w * 3] = frame.reshape(h, -1)
            cluster[1][i] = [SIMPLE_BLOCK, body[:4] + rows.tobytes()]

    path = _rewritten(tmp_path, src, "raw.mkv", change)
    ours, theirs = read_video_frames(path), _capture(path)
    assert len(ours) == len(theirs) == 3
    assert all(np.array_equal(a, b) and np.array_equal(a, c) for a, b, c in zip(ours, theirs, written))


# --- what the port refuses ----------------------------------------------------------------------


@pytest.mark.parametrize("fourcc,ext,name", [("FFV1", "mkv", "FFV1"), ("VP90", "mkv", "VP9"), ("VP90", "webm", "VP9"),
                                             ("HFYU", "mkv", "HuffYUV")])
def test_other_codecs_raise(tmp_path, fourcc, ext, name):
    """HuffYUV raises naming it; VP9 (V_VP9) and FFV1 (V_FFV1), refused until the port read them, now read as
    cv2.VideoCapture does (tests/test_torch_vp9.py and tests/test_torch_ffv1.py hold the codecs themselves)."""
    path = str(tmp_path / f"clip.{ext}")
    _write(path, fourcc, _pan(32, 24, 3))
    if name in ("VP9", "FFV1"):
        ours, theirs = read_video_frames(path), _capture(path)
        assert len(ours) == len(theirs) == 3 and all(np.array_equal(a, b) for a, b in zip(ours, theirs))
        return
    with pytest.raises(NotImplementedError, match=r"HFYU"):
        read_video_frames(path)


def _vp8_scaled(tree):
    """The first key frame's horizontal_scale set (the top bits of its width)."""
    cluster, i, body = _blocks(tree)[0]
    frame = bytearray(body[4:])
    frame[7] |= 0x40
    cluster[1][i] = [SIMPLE_BLOCK, body[:4] + bytes(frame)]


def test_vp8_refusal_names_it(tmp_path):
    """A VP8 feature the port refuses: a key frame that asks for scaling."""
    src = str(tmp_path / "src.webm")
    _write(src, "VP80", _pan(32, 24, 3))
    path = _rewritten(tmp_path, src, "scaled.webm", _vp8_scaled)
    with pytest.raises(NotImplementedError, match=r"VP8 frame scaling \(horizontal_scale / vertical_scale"):
        read_video_frames(path)


def _second_video_track(tree):
    tracks = _find(_segment(tree), TRACKS)[0][1]
    copy = [[i, list(b) if isinstance(b, list) else b] for i, b in _find(tracks, TRACK_ENTRY)[0][1]]
    _set(copy, TRACK_NUMBER, b"\x02")
    _set(copy, TRACK_UID, b"\x02")
    tracks.append([TRACK_ENTRY, copy])


def _interlaced_avc(tree):
    """An H.264 track whose configuration record announces interlaced coding (frame_mbs_only_flag 0), which the port
    refuses."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_h264_writer import Pps, Sps, avcc, nal_unit

    _set(_track(tree), CODEC_ID, b"V_MPEG4/ISO/AVC")
    _set(_track(tree), CODEC_PRIVATE, avcc([nal_unit(3, 7, Sps(4, 4, profile_idc=77, frame_mbs_only=False).rbsp())],
                                           [nal_unit(3, 8, Pps(cabac=True).rbsp())]))


REFUSALS = {
    "H.264": _interlaced_avc,
    "HEVC": lambda tree: _set(_track(tree), CODEC_ID, b"V_MPEGH/ISO/HEVC"),
    "AV1": lambda tree: _set(_track(tree), CODEC_ID, b"V_AV1"),
    "ContentEncodings": lambda tree: _track(tree).append([0x6D80, b"\x62\x40\x80"]),
    "2 video tracks": _second_video_track,
    "DIV3": _vfw(b"DIV3"),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_refusals_name_what_they_are(tmp_path, mp4v_mkv, what):
    path = _rewritten(tmp_path, mp4v_mkv, "refused.mkv", REFUSALS[what])
    with pytest.raises(NotImplementedError, match=what.replace(".", r"\.")):
        read_video_frames(path)


def test_loader_matches_jax(mp4v_mkv):
    """The port's VideoLoader and the JAX one (cv2.VideoCapture) on the same .mkv, float64."""
    ours = VideoLoader(device="cpu", dtype=torch.float64)
    ours.load_frames_from_video(mp4v_mkv)
    theirs = JVideoLoader()
    theirs.load_frames_from_video(mp4v_mkv)
    jax_frames = np.stack([np.asarray(f) for f in theirs.get_frames()])
    assert ours.num_frames == theirs.num_frames == 14 and ours.image_size == theirs.image_size == (64, 48)
    np.testing.assert_allclose(np.stack([f.numpy() for f in ours.get_frames()]), jax_frames, rtol=0, atol=1e-12)
