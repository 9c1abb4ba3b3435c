"""MPEG-1 and MPEG-2 video in the port (``native/mpeg2_decoder.cpp`` through
``utils/mpeg2.py``) and the MPEG system streams (``video/mpegps.py``,
``video/mpegts.py``), held against ``cv2.VideoCapture`` (the JAX package's
video path) and libavcodec's single-thread planes (``tests/torch_libav.py``).

- ``cv2.VideoWriter``'s MPEG-2 (``mpg2``) and MPEG-1 (``PIM1``) in every
  container it writes them to: program streams (.mpg, .vob), transport
  streams (.ts, .m2ts), raw elementary streams (.m2v), Matroska, QuickTime,
  MP4 and AVI; each array-equal to cv2's frames, in order and number.
- FFmpeg's ``mpeg2video`` / ``mpeg1video`` encoders with each option by
  itself (``tests/torch_libav.py`` ``encode``): interlaced frame pictures
  (``+ildct+ilme``: field DCT and field prediction), ``alternate_scan``,
  ``intra_vlc``, ``non_linear_quant``, intra DC precision 8-11, 0-3 B
  pictures, closed GOPs, ``low_delay``, MPEG-1 with B pictures; each equal to
  libavcodec's planes and to cv2's frames. cv2 5.0 with FFmpeg 8's swscale
  does not convert a frame flagged interlaced (``progressive_frame`` 0: it
  logs "Cannot convert interlaced to progressive frames" and hands back its
  buffer unchanged), so those streams are held to swscale's conversion of
  libavcodec's planes, and to cv2 once their ``progressive_frame`` bits are set
  (which changes no decoded sample).
- Streams rewritten in place: quantiser matrices loaded in every sequence
  header and in quant matrix extensions (chroma ones too), and the
  ``repeat_first_field`` / ``top_field_first`` bits (cv2 repeats no frame).
- Hand-built streams (a small bit writer below): concealment motion vectors,
  MPEG-1 ``full_pel_forward_vector``, and each refusal
  (``NotImplementedError`` naming it).
- H.264 (the writer's Annex B stream, muxed by a small transport stream
  writer below) and cv2's MPEG-4 Part 2 in .ts; cut and damaged transport
  streams.
- The checked-in fixtures of ``tests/data_torch/mpeg2`` (digests and
  counts), the JAX ``VideoLoader`` on the .mpg, and the JAX
  ``VideoSuperResolver`` against the port's on a small MPEG-2 clip.

Tolerances: decoded frames and planes are compared exactly (array-equal); the
loaders in float64 exactly; the resolvers to 1e-8 of the largest entry (the
two solvers' float64 sums in another order).
"""

import hashlib
import json
import os
import struct
import sys

import cv2
import numpy as np
import pytest
import torch

from super_resolution_tpu.video import VideoLoader as JVideoLoader
from super_resolution_tpu.video import VideoSuperResolver as JVideoSuperResolver

from super_resolution_tpu_torch.utils.h264 import H264Decoder
from super_resolution_tpu_torch.utils.mpeg2 import STATS, Mpeg2Decoder, access_units, elementary_stream_codec
from super_resolution_tpu_torch.utils.mpeg4 import Mpeg4Decoder
from super_resolution_tpu_torch.video import VideoLoader, VideoSuperResolver
from super_resolution_tpu_torch.video.mpegps import read_program_stream
from super_resolution_tpu_torch.video.mpegts import read_transport_stream
from super_resolution_tpu_torch.video.video_loader import CONTAINERS, read_video_frames

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_h264_writer import annexb, random_stream  # noqa: E402
from torch_libav import capture, decode_planes, encode, sws_bgr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data_torch", "mpeg2")
CLIP = "mpeg2_960x540x12.mpg"
CPU = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _built():
    Mpeg2Decoder()  # builds native/mpeg2_decoder.cpp once for the module


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _assert_frames_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a.shape == b.shape and np.array_equal(a, b), f"frame {i}: max |diff| {np.abs(a.astype(int) - b).max()}"


def _scene(w, h, n, seed=7, step=(1, 2)):
    """n BGR frames of a seeded smooth texture panned by ``step`` (rows, columns) a frame, one under noise."""
    rng = np.random.default_rng(seed)
    big = cv2.GaussianBlur(rng.uniform(0, 255, (h + step[0] * n + 8, w + step[1] * n + 8, 3)), (0, 0), 2.5)
    big = np.clip((big - big.mean()) * 4 + 128, 0, 255).astype(np.uint8)
    frames = [np.ascontiguousarray(big[i * step[0]:i * step[0] + h, i * step[1]:i * step[1] + w]) for i in range(n)]
    frames[n // 2] = np.clip(frames[n // 2] + rng.integers(-40, 41, frames[0].shape), 0, 255).astype(np.uint8)
    return frames


def _planes(frames):
    """The YUV 4:2:0 planes of BGR frames (even sizes), as torch_libav.encode takes them."""
    out = []
    for f in frames:
        h, w = f.shape[:2]
        yuv = cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420)
        out.append([yuv[:h], yuv[h:h + h // 4].reshape(h // 2, w // 2), yuv[h + h // 4:].reshape(h // 2, w // 2)])
    return out


def _write_cv2(path, fourcc, frames, fps=25):
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert writer.isOpened(), f"cv2.VideoWriter cannot write {fourcc} to {path}"
    for frame in frames:
        writer.write(frame)
    writer.release()
    return path


def _decode(payloads):
    """(BGR frames, YUV planes, the decoder) of payloads fed one a call, then the end of the stream."""
    decoder, frames, planes = Mpeg2Decoder(), [], []
    for payload in payloads + [None]:
        out = decoder.flush() if payload is None else decoder.decode(payload)
        frames += out
        planes += [decoder.planes(i) for i in range(len(out))]
    return frames, planes, decoder


def _assert_planes_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for i, (a, b) in enumerate(zip(ours, theirs)):
        for p, q in zip(a, b):
            np.testing.assert_array_equal(p, q, err_msg=f"frame {i}")


def _split_pictures(es):
    """An elementary stream cut into pictures as FFmpeg's mpegvideo parser cuts it: before the first sequence
    header, GOP header or picture header that follows a picture's slices."""
    cuts, pos, in_slices = [0], es.find(b"\0\0\1"), False
    while 0 <= pos < len(es) - 3:
        code = es[pos + 3]
        if 0x01 <= code <= 0xAF:
            in_slices = True
        elif in_slices and code in (0x00, 0xB3, 0xB8):
            cuts.append(pos)
            in_slices = False
        pos = es.find(b"\0\0\1", pos + 3)
    return [es[a:b] for a, b in zip(cuts, cuts[1:] + [len(es)])]


# --- cv2.VideoWriter's MPEG-1 / MPEG-2 in every container ---------------------------------------------------------

CONTAINER_CASES = [(fourcc, ext) for fourcc in ("mpg2", "PIM1")
                   for ext in ("mpg", "vob", "ts", "m2ts", "m2v", "mkv", "mov", "mp4", "avi")
                   if (fourcc, ext) != ("PIM1", "m2v")]  # FFmpeg's raw mpeg2video muxer takes no MPEG-1


@pytest.mark.parametrize("fourcc,ext", CONTAINER_CASES)
def test_cv2_containers_equal_videocapture(tmp_path, fourcc, ext):
    """cv2.VideoWriter's stream (a GOP of 12; MPEG-2 with 2 B pictures between anchors) in each container:
    read_video_frames array-equal to cv2.VideoCapture, in order and number; max_frames cuts as cv2 reads."""
    path = _write_cv2(str(tmp_path / f"clip.{ext}"), fourcc, _scene(96, 64, 16))
    frames = read_video_frames(path)
    _assert_frames_equal(frames, capture(path))
    assert len(frames) == 16 and frames[0].shape == (64, 96, 3)
    _assert_frames_equal(read_video_frames(path, max_frames=5), frames[:5])


def test_cv2_clip_at_an_odd_size_and_several_gops(tmp_path):
    """A 120x88 MPEG-2 clip of 30 frames (three GOPs, macroblocks cropped at the right and the bottom) in a program
    stream and its MPEG-1 twin; the decoder reports the GOP structure cv2.VideoWriter chose."""
    frames = _scene(120, 88, 30, seed=11)
    for fourcc, stats in (("mpg2", dict(i_pictures=3, b_pictures=19)), ("PIM1", dict(i_pictures=3, b_pictures=0))):
        path = _write_cv2(str(tmp_path / f"{fourcc}.mpg"), fourcc, frames)
        _assert_frames_equal(read_video_frames(path), capture(path))
        decoder = Mpeg2Decoder()
        out = decoder.decode(read_program_stream(open(path, "rb").read()).es) + decoder.flush()
        assert len(out) == 30 and {k: decoder.stats[k] for k in stats} == stats


@pytest.mark.parametrize("codec", ["mpeg2video", "mpeg1video"])
@pytest.mark.parametrize("size", [(97, 65), (96, 65), (97, 64), (33, 17)])
def test_odd_sizes_equal_planes_and_videocapture(tmp_path, codec, size):
    """Odd widths and heights (cv2.VideoWriter rounds them down; FFmpeg's encoders take them): an odd height takes
    swscale's scaled path, where FFmpeg's chroma siting counts (left for MPEG-2, centred for MPEG-1), an odd width
    its full-chroma writer; libavcodec's planes (chroma rounded up) and cv2's frames."""
    w, h = size
    rng = np.random.default_rng(w + h)
    planes = [[cv2.GaussianBlur(rng.uniform(0, 255, shape), (0, 0), 2).astype(np.uint8)
               for shape in ((h, w), ((h + 1) // 2, (w + 1) // 2), ((h + 1) // 2, (w + 1) // 2))] for _ in range(6)]
    payloads, _ = encode(codec, planes, "yuv420p", w, h, {"time_base": "1/25", "bf": "2"})
    frames, ours, _ = _decode(payloads)
    _assert_planes_equal(ours, decode_planes(codec, payloads, "yuv420p", w, h))
    path = _write(tmp_path, "odd.m2v", b"".join(payloads))
    _assert_frames_equal(read_video_frames(path), capture(path))
    _assert_frames_equal(frames, capture(path))
    assert frames[0].shape == (h, w, 3)


def test_picture_taller_than_2800_lines():
    """16x2832 (177 macroblock rows): MPEG-2 slices below row 175 carry slice_vertical_position_extension;
    libavcodec's planes."""
    rng = np.random.default_rng(2)
    w, h = 16, 2832
    planes = [[rng.integers(0, 256, (h, w), dtype=np.uint8), rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
               rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)] for _ in range(3)]
    payloads, _ = encode("mpeg2video", planes, "yuv420p", w, h, {"time_base": "1/25", "bf": "1"})
    _, ours, decoder = _decode(payloads)
    _assert_planes_equal(ours, decode_planes("mpeg2video", payloads, "yuv420p", w, h))
    assert decoder.stats["slices"] == 3 * 177


# --- FFmpeg's encoders, one option at a time ------------------------------------------------------------------------

OPTIONS = {
    "mpeg2_default": ("mpeg2video", {}, {"i_pictures": 2}),
    "bf1": ("mpeg2video", {"bf": "1"}, {"b_pictures": 9}),
    "bf2": ("mpeg2video", {"bf": "2"}, {"b_pictures": 12}),
    "bf3": ("mpeg2video", {"bf": "3"}, {"b_pictures": 14}),
    "intra_vlc": ("mpeg2video", {"intra_vlc": "1", "bf": "2"}, {"intra_vlc_pictures": 20}),
    "non_linear_quant": ("mpeg2video", {"non_linear_quant": "1", "qmax": "28", "bf": "2"},
                         {"non_linear_quant_pictures": 20}),
    "dc8": ("mpeg2video", {"dc": "8"}, {"dc_precision_8": 20}),
    "dc9": ("mpeg2video", {"dc": "9"}, {"dc_precision_9": 20}),
    "dc10": ("mpeg2video", {"dc": "10"}, {"dc_precision_10": 20}),
    "dc11": ("mpeg2video", {"dc": "11", "bf": "2"}, {"dc_precision_11": 20}),
    "closed_gop": ("mpeg2video", {"flags": "+cgop", "sc_threshold": "1000000000", "bf": "2", "g": "6"},
                   {"closed_gops": 5}),
    "low_delay": ("mpeg2video", {"flags": "+low_delay"}, {"low_delay_sequences": 2, "reordered_pictures": 0}),
    "high_bitrate": ("mpeg2video", {"b": "4000000", "bf": "2"}, {"b_pictures": 12}),
    "mpeg1_default": ("mpeg1video", {}, {"mpeg1_pictures": 20}),
    "mpeg1_bf2": ("mpeg1video", {"bf": "2"}, {"mpeg1_pictures": 20, "b_pictures": 12}),
    "mpeg1_closed_gop": ("mpeg1video", {"flags": "+cgop", "sc_threshold": "1000000000", "bf": "2", "g": "6"},
                         {"closed_gops": 5}),
}
# FFmpeg's encoder codes these as an interlaced sequence (progressive_sequence 0, progressive_frame 0): what each
# must reach.
INTERLACED = {
    "ildct_ilme": ("mpeg2video", {"flags": "+ildct+ilme", "bf": "2"}, ("field_dct_mbs", "field_prediction_mbs")),
    "ildct_ilme_no_b": ("mpeg2video", {"flags": "+ildct+ilme"}, ("field_dct_mbs", "field_prediction_mbs")),
    "ildct": ("mpeg2video", {"flags": "+ildct", "bf": "1"}, ("field_dct_mbs",)),
    "alternate_scan": ("mpeg2video", {"alternate_scan": "1", "bf": "1"}, ("alternate_scan_pictures",)),
    "ildct_ilme_all_tools": ("mpeg2video", {"flags": "+ildct+ilme", "alternate_scan": "1", "intra_vlc": "1",
                                            "dc": "10", "bf": "2"},
                             ("field_dct_mbs", "field_prediction_mbs", "alternate_scan_pictures",
                              "intra_vlc_pictures", "dc_precision_10")),
}
W, H, N = 176, 120, 20


@pytest.fixture(scope="module")
def source_planes():
    return _planes(_scene(W, H, N, seed=1, step=(3, 5)))


@pytest.mark.parametrize("name", list(OPTIONS))
def test_encoder_options_equal_planes_and_videocapture(tmp_path, source_planes, name):
    """Each option's stream, a packet a picture: libavcodec's planes (one thread) and, as a raw .m2v / .m1v,
    cv2's frames; the counts show the option reached the stream."""
    codec, options, expected = OPTIONS[name]
    payloads, _ = encode(codec, source_planes, "yuv420p", W, H, {"time_base": "1/25", **options})
    frames, planes, decoder = _decode(payloads)
    _assert_planes_equal(planes, decode_planes(codec, payloads, "yuv420p", W, H))
    path = _write(tmp_path, "clip.m2v", b"".join(payloads))
    _assert_frames_equal(frames, capture(path))
    _assert_frames_equal(read_video_frames(path), frames)
    stats = decoder.stats
    assert {k: stats[k] for k in expected} == expected and stats["escapes"] > 0
    assert stats["interlaced_frames"] == 0 and len(frames) == N


def _set_coding_extension_bit(es, bit, value=1):
    """``es`` with bit ``bit`` (0: the first after the start code) of every picture coding extension set to ``value``:
    20-21 intra_dc_precision, 22-23 picture_structure, 24 top_field_first, 30 repeat_first_field, 32
    progressive_frame."""
    out, pos = bytearray(es), es.find(b"\0\0\1\xb5")
    while pos >= 0:
        if out[pos + 4] >> 4 == 8:
            byte, shift = pos + 4 + bit // 8, 7 - bit % 8
            out[byte] = (out[byte] & ~(1 << shift)) | (value << shift)
        pos = es.find(b"\0\0\1\xb5", pos + 4)
    return bytes(out)


@pytest.mark.parametrize("name", list(INTERLACED))
def test_interlaced_frame_pictures(tmp_path, source_planes, name):
    """Interlaced frame pictures (field DCT, field prediction: each field's vector selecting a reference field):
    equal to libavcodec's planes and to swscale's conversion of them (cv2.VideoCapture does not convert frames
    flagged interlaced); with the progressive_frame bits set, equal to cv2's frames."""
    codec, options, reached = INTERLACED[name]
    payloads, _ = encode(codec, source_planes, "yuv420p", W, H, {"time_base": "1/25", **options})
    frames, planes, decoder = _decode(payloads)
    _assert_planes_equal(planes, decode_planes(codec, payloads, "yuv420p", W, H))
    for frame, (y, u, v) in zip(frames, planes):
        np.testing.assert_array_equal(frame, sws_bgr("yuv420p", [y, u, v], W, H, (0, 128)))
    stats = decoder.stats
    assert stats["interlaced_sequences"] == 2 and stats["interlaced_frames"] == N
    assert all(stats[k] > 0 for k in reached), {k: stats[k] for k in reached}
    marked = _set_coding_extension_bit(b"".join(payloads), 32)
    path = _write(tmp_path, "progressive_frame.m2v", marked)
    ours = read_video_frames(path)
    _assert_frames_equal(ours, capture(path))
    _assert_frames_equal(ours, frames)


def test_repeat_first_field_and_top_field_first_repeat_no_frame(tmp_path):
    """repeat_first_field and top_field_first set in every picture of a cv2 stream (progressive_sequence 1: a frame
    shown two or three times): cv2 repeats none, nor does the port."""
    path = _write_cv2(str(tmp_path / "clip.m2v"), "mpg2", _scene(64, 48, 14))
    es = open(path, "rb").read()
    for bits in ((30,), (24,), (24, 30)):
        rewritten = es
        for bit in bits:
            rewritten = _set_coding_extension_bit(rewritten, bit)
        out = _write(tmp_path, "rff.m2v", rewritten)
        frames = read_video_frames(out)
        _assert_frames_equal(frames, capture(out))
        _assert_frames_equal(frames, read_video_frames(path))
        decoder = Mpeg2Decoder()
        decoder.decode(rewritten)
        assert decoder.stats["repeat_first_field"] == (14 if 30 in bits else 0)
        assert decoder.stats["top_field_first"] == (14 if 24 in bits else 0)


# --- quantiser matrices ------------------------------------------------------------------------------------------

ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
          21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
          60, 61, 54, 47, 55, 62, 63]


class _Bits:
    """An MSB-first bit writer."""

    def __init__(self):
        self.bits = []

    def put(self, value, n):
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def code(self, text):
        self.bits += [int(c) for c in text]
        return self

    def align(self):
        self.bits += [0] * (-len(self.bits) % 8)
        return self

    def bytes(self):
        self.align()
        return bytes(int("".join(map(str, self.bits[i:i + 8])), 2) for i in range(0, len(self.bits), 8))


def _matrix(rng, low, high):
    """A quantiser matrix in raster order."""
    return rng.integers(low, high + 1, 64)


def _put_matrix(bits, matrix):
    for i in range(64):
        bits.put(int(matrix[ZIGZAG[i]]), 8)


def _load_sequence_matrices(es, intra, inter):
    """``es`` with every sequence header loading ``intra`` and ``inter`` (raster order; None: not loaded)."""
    out, pos = bytearray(), 0
    while True:
        at = es.find(b"\0\0\1\xb3", pos)
        if at < 0:
            return bytes(out + es[pos:])
        header = es[at + 4:at + 12]
        fixed = int.from_bytes(header, "big")
        assert fixed & 3 == 0, "the encoder loaded matrices itself"
        bits = _Bits().put(0x1B3, 32).put(fixed >> 2, 62)
        for matrix in (intra, inter):
            bits.put(matrix is not None, 1)
            if matrix is not None:
                _put_matrix(bits, matrix)
        out += es[pos:at] + bits.bytes()
        pos = at + 12


def _insert_quant_matrix_extensions(es, matrices):
    """``es`` with a quant matrix extension after every picture coding extension: ``matrices`` the intra,
    non-intra, chroma intra and chroma non-intra matrices (None: not loaded)."""
    bits = _Bits().put(0x1B5, 32).put(3, 4)
    for matrix in matrices:
        bits.put(matrix is not None, 1)
        if matrix is not None:
            _put_matrix(bits, matrix)
    extension, out, pos = bits.bytes(), bytearray(), 0
    while True:
        at = es.find(b"\0\0\1\xb5", pos)
        if at < 0:
            return bytes(out + es[pos:])
        end = es.find(b"\0\0\1", at + 4)
        out += es[pos:end]
        if es[at + 4] >> 4 == 8:
            out += extension
        pos = end


def test_quantiser_matrices(tmp_path, source_planes):
    """Matrices loaded in every sequence header (the intra matrix's first weight 17, which FFmpeg takes as 8) and in
    quant matrix extensions after every picture coding extension, chroma ones included (FFmpeg applies those to
    4:2:0 chroma): cv2's frames and libavcodec's planes, MPEG-2 with B pictures and MPEG-1."""
    rng = np.random.default_rng(3)
    for codec in ("mpeg2video", "mpeg1video"):
        payloads, _ = encode(codec, source_planes[:12], "yuv420p", W, H, {"time_base": "1/25", "bf": "2"})
        intra, inter = _matrix(rng, 6, 40), _matrix(rng, 8, 48)
        intra[0] = 17
        es = _load_sequence_matrices(b"".join(payloads), intra, inter)
        expected = dict(intra_matrices=1, non_intra_matrices=1)
        if codec == "mpeg2video":
            es = _insert_quant_matrix_extensions(es, (None, _matrix(rng, 4, 30), _matrix(rng, 10, 60),
                                                      _matrix(rng, 12, 24)))
            expected = dict(intra_matrices=1, non_intra_matrices=13, chroma_matrices=24, quant_matrix_extensions=12)
        pictures = _split_pictures(es)
        frames, planes, decoder = _decode(pictures)
        assert {k: decoder.stats[k] for k in expected} == expected
        _assert_planes_equal(planes, decode_planes(codec, pictures, "yuv420p", W, H))
        path = _write(tmp_path, f"{codec}.m2v", es)
        _assert_frames_equal(read_video_frames(path), capture(path))
        _assert_frames_equal(read_video_frames(path), frames)


# --- hand-built streams: what encoders here do not write, and the refusals -----------------------------------------

DC_LUMA = ["100", "00", "01", "101", "110", "1110", "11110", "111110", "1111110", "11111110", "111111110", "111111111"]
DC_CHROMA = ["00", "01", "10", "110", "1110", "11110", "111110", "1111110", "11111110", "111111110", "1111111110",
             "1111111111"]


def _dc(bits, table, diff):
    size = abs(diff).bit_length()
    bits.code(table[size])
    if size:
        bits.put(diff if diff > 0 else diff + (1 << size) - 1, size)


def _sequence(w, h, *, mpeg2=True, progressive=1, chroma=1, matrix=None, scalable=None):
    bits = _Bits().put(0x1B3, 32).put(w & 0xFFF, 12).put(h & 0xFFF, 12).put(1, 4).put(3, 4).put(0x3FFFF, 18)
    bits.put(1, 1).put(112, 10).put(0, 1).put(0, 2)
    if mpeg2:
        bits.align().put(0x1B5, 32).put(1, 4).put(0x48, 8).put(progressive, 1).put(chroma, 2).put(0, 4).put(0, 12)
        bits.put(1, 1).put(0, 8).put(0, 1).put(0, 7)
    if matrix is not None:
        bits.align().put(0x1B5, 32).put(2, 4).put(5, 3).put(1, 1).put(1, 8).put(1, 8).put(matrix, 8).put(w, 14)
        bits.put(1, 1).put(h, 14)
    if scalable is not None:
        bits.align().put(0x1B5, 32).put(5, 4).put(scalable, 2).put(0, 10)
    return bits.bytes()


def _gop(closed):
    return _Bits().put(0x1B8, 32).put(1 << 12, 25).put(closed, 1).put(0, 1).bytes()


def _picture_header(kind, *, mpeg2=True, full_pel=0, structure=3, fpfd=1, concealment=0):
    bits = _Bits().put(0x100, 32).put(0, 10).put(kind, 3).put(0xFFFF, 16)
    f_code = 7 if mpeg2 else 1
    for _ in range((kind in (2, 3)) + (kind == 3)):
        bits.put(full_pel, 1).put(f_code, 3)
    bits.put(0, 1)
    if mpeg2:
        codes = {1: (1, 1, 15, 15) if concealment else (15,) * 4, 2: (1, 1, 15, 15), 3: (1, 1, 1, 1)}[kind]
        bits.align().put(0x1B5, 32).put(8, 4)
        for c in codes:
            bits.put(c, 4)
        bits.put(0, 2).put(structure, 2).put(0, 1).put(fpfd, 1).put(concealment, 1).put(0, 4).put(1, 1)
        bits.put(fpfd, 1).put(0, 1)
    return bits.bytes()


def _intra_slices(rng, mb_w, mb_h, *, fpfd=1, concealment=0):
    """One slice a row of intra macroblocks whose blocks carry only a random DC."""
    out = b""
    for row in range(mb_h):
        bits = _Bits().put(0x100 + row + 1, 32).put(4, 5).put(0, 1)
        dc = [128, 128, 128]
        for _ in range(mb_w):
            bits.code("1").code("1")  # address increment 1, intra
            if not fpfd:
                bits.put(0, 1)  # dct_type
            if concealment:
                bits.code("1").code("1").code("1")  # a zero vector, then the marker
            for block in range(6):
                component = 0 if block < 4 else block - 3
                target = int(np.clip(dc[component] + rng.integers(-24, 25), 24, 232))
                _dc(bits, DC_LUMA if component == 0 else DC_CHROMA, target - dc[component])
                dc[component] = target
                bits.code("10")  # end of block
        out += bits.bytes()
    return out


def _motion_code(bits, delta):
    """A motion_code of f_code 1 (no residual)."""
    table = ["1", "01", "001", "0001", "000011", "0000101", "0000100", "0000011"]
    bits.code(table[abs(delta)])
    if delta:
        bits.put(delta < 0, 1)


def _inter_slices(mb_h, deltas=(0,)):
    """One slice a row of macroblocks of the type "MC, not coded" (forward in P pictures; in B pictures "MC,
    not coded" is read as backward), the i-th with horizontal vector difference ``deltas[i]``."""
    out = b""
    for row in range(mb_h):
        bits = _Bits().put(0x100 + row + 1, 32).put(4, 5).put(0, 1)
        for delta in deltas:
            bits.code("1").code("001")  # address increment 1, MC not coded
            _motion_code(bits, delta)
            _motion_code(bits, 0)
        out += bits.bytes()
    return out


def test_hand_built_concealment_vectors_and_full_pel(tmp_path):
    """Intra macroblocks with concealment motion vectors (MPEG-2), and an MPEG-1 P picture whose first macroblock of
    each row moves by one whole pixel (full_pel_forward_vector) and whose second goes back: libavcodec's planes and
    cv2's frames."""
    rng = np.random.default_rng(9)
    concealed = (_sequence(32, 32) + _picture_header(1, concealment=1)
                 + _intra_slices(rng, 2, 2, concealment=1))
    frames, planes, decoder = _decode([concealed])
    assert decoder.stats["concealment_vectors"] == 4 and len(frames) == 1
    _assert_planes_equal(planes, decode_planes("mpeg2video", [concealed], "yuv420p", 32, 32))
    path = _write(tmp_path, "concealment.m2v", concealed)
    _assert_frames_equal(read_video_frames(path), capture(path))

    intra = _sequence(32, 32, mpeg2=False) + _picture_header(1, mpeg2=False) + _intra_slices(rng, 2, 2)
    p = _picture_header(2, mpeg2=False, full_pel=1) + _inter_slices(2, deltas=(1, -1))
    frames, planes, decoder = _decode([intra, p])
    assert decoder.stats["full_pel_vectors"] == 4 and decoder.stats["mpeg1_pictures"] == 2
    _assert_planes_equal(planes, decode_planes("mpeg1video", [intra, p], "yuv420p", 32, 32))
    path = _write(tmp_path, "full_pel.m1v", intra + p)
    _assert_frames_equal(read_video_frames(path), capture(path))
    assert not np.array_equal(planes[0][0], planes[1][0])


REFUSALS = {
    "field pictures": lambda r: _sequence(32, 32, progressive=0) + _picture_header(1, structure=1, fpfd=0),
    "dual prime": lambda r: (_sequence(32, 32, progressive=0) + _picture_header(1, fpfd=0)
                             + _intra_slices(r, 2, 2, fpfd=0) + _picture_header(2, fpfd=0)
                             + _Bits().put(0x101, 32).put(4, 5).put(0, 1).code("1").code("1").put(3, 2).bytes()),
    "4:2:2": lambda r: _sequence(32, 32, chroma=2) + _picture_header(1) + _intra_slices(r, 2, 2),
    "4:4:4": lambda r: _sequence(32, 32, chroma=3) + _picture_header(1) + _intra_slices(r, 2, 2),
    "data partitioning": lambda r: _sequence(32, 32, scalable=0) + _picture_header(1) + _intra_slices(r, 2, 2),
    "spatial scalability": lambda r: _sequence(32, 32, scalable=1) + _picture_header(1) + _intra_slices(r, 2, 2),
    "D pictures": lambda r: _sequence(32, 32, mpeg2=False) + _picture_header(4, mpeg2=False),
    "a picture size that changes mid-stream": lambda r: (
        _sequence(32, 32) + _picture_header(1) + _intra_slices(r, 2, 2)
        + _sequence(48, 32) + _picture_header(1) + _intra_slices(r, 3, 2)),
    "starts with a P picture": lambda r: _sequence(32, 32) + _picture_header(2) + _inter_slices(2, (0, 0)),
    "a B picture with no forward reference picture in a closed GOP": lambda r: (
        _sequence(32, 32) + _gop(1) + _picture_header(1) + _intra_slices(r, 2, 2) + _picture_header(3)
        + _inter_slices(2, (0, 0))),
    "matrix_coefficients 0": lambda r: _sequence(32, 32, matrix=0) + _picture_header(1) + _intra_slices(r, 2, 2),
    r"matrix_coefficients 1 at an odd height \(31": lambda r: (_sequence(32, 31, matrix=1) + _picture_header(1)
                                                               + _intra_slices(r, 2, 2)),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_refusals_name_what_they_are(tmp_path, what):
    """Each feature the port leaves out raises NotImplementedError naming it, from the decoder and the reader."""
    es = REFUSALS[what](np.random.default_rng(4))
    with pytest.raises(NotImplementedError, match=what):
        decoder = Mpeg2Decoder()
        decoder.decode(es)
        decoder.flush()
    with pytest.raises(NotImplementedError, match=what):
        read_video_frames(_write(tmp_path, "refused.m2v", es))


def test_hand_built_intra_stream_and_bt709_decode(tmp_path):
    """The refusals' own stream without the refused feature decodes to libavcodec's planes and cv2's frames:
    BT.709 (the sequence display extension's matrix) at an even height."""
    es = _sequence(32, 32, matrix=1) + _picture_header(1) + _intra_slices(np.random.default_rng(4), 2, 2)
    frames, planes, _ = _decode([es])
    _assert_planes_equal(planes, decode_planes("mpeg2video", [es], "yuv420p", 32, 32))
    path = _write(tmp_path, "bt709.m2v", es)
    _assert_frames_equal(read_video_frames(path), capture(path))
    assert not np.array_equal(frames[0], sws_bgr("yuv420p", list(planes[0]), 32, 32))  # not BT.601's


def test_damaged_stream_raises_value_error(tmp_path):
    es = _sequence(32, 32) + _picture_header(1) + _intra_slices(np.random.default_rng(4), 2, 1)  # one row of two
    with pytest.raises(ValueError, match=r"macroblock \(0, 1\) of a picture lies in no slice"):
        Mpeg2Decoder().decode(es)


# --- the system streams -------------------------------------------------------------------------------------------

def _crc32(data):
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte << 24
        for _ in range(8):
            crc = (crc << 1) ^ 0x04C11DB7 if crc & 0x80000000 else crc << 1
            crc &= 0xFFFFFFFF
    return crc


def _ts(es_units, stream_type, video_pid=0x100):
    """A transport stream: PAT, PMT (one stream of ``stream_type``), then one PES packet (stream id 0xE0, a PTS) a
    unit of ``es_units``, split into 188-byte packets with adaptation-field stuffing."""
    def section(table_id, body):
        head = bytes([table_id]) + struct.pack(">H", 0xB000 | (len(body) + 9)) + b"\0\1\xc1\0\0" + body
        return head + struct.pack(">I", _crc32(head))

    def packets(pid, payload, counter):
        out, first = [], True
        while payload:
            chunk, payload = payload[:184], payload[184:]
            header = bytes([0x47, (0x40 if first else 0) | pid >> 8, pid & 0xFF])
            if len(chunk) < 184:
                pad = 184 - len(chunk)
                field = bytes([pad - 1]) + (b"\0" + b"\xff" * (pad - 2) if pad > 1 else b"")
                out.append(header + bytes([0x30 | counter[0]]) + field + chunk)
            else:
                out.append(header + bytes([0x10 | counter[0]]) + chunk)
            counter[0] = (counter[0] + 1) & 15
            first = False
        return out

    pat = section(0x00, struct.pack(">HH", 1, 0xE000 | 0x1000))
    pmt = section(0x02, struct.pack(">HH", 0xE000 | video_pid, 0xF000)
                  + bytes([stream_type]) + struct.pack(">HH", 0xE000 | video_pid, 0xF000))
    stream = packets(0, b"\0" + pat, [0]) + packets(0x1000, b"\0" + pmt, [0])
    counter = [0]
    for i, unit in enumerate(es_units):
        pts = 3600 * (i + 1)
        header = bytes([0x80, 0x80, 5, 0x21 | (pts >> 29) & 0x0E, (pts >> 22) & 0xFF, 0x01 | (pts >> 14) & 0xFE,
                        (pts >> 7) & 0xFF, 0x01 | (pts << 1) & 0xFE])
        stream += packets(video_pid, b"\0\0\1\xe0\0\0" + header + unit, counter)
    return b"".join(stream)


def test_h264_and_mpeg4_in_transport_streams(tmp_path):
    """H.264 (stream_type 0x1B: the test writer's Annex B access units, one PES packet each) and cv2's MPEG-4 Part
    2 (0x10) in .ts: cv2's frames; the same H.264 stream as 192-byte .m2ts packets too."""
    aus = random_stream(23, mb_width=3, mb_height=2, frames=6)[0]
    data = _ts([annexb([au]) for au in aus], 0x1B)
    assert read_transport_stream(data).stream_type == 0x1B
    path = _write(tmp_path, "h264.ts", data)
    frames = read_video_frames(path)
    _assert_frames_equal(frames, capture(path))
    m2ts = b"".join(b"\0\0\0\0" + data[i:i + 188] for i in range(0, len(data), 188))
    _assert_frames_equal(read_video_frames(_write(tmp_path, "h264.m2ts", m2ts)), frames)
    for fourcc in ("mp4v", "FMP4"):
        path = _write_cv2(str(tmp_path / f"{fourcc}.ts"), fourcc, _scene(64, 48, 8))
        assert elementary_stream_codec(read_transport_stream(open(path, "rb").read()).es) == "mpeg4"
        _assert_frames_equal(read_video_frames(path), capture(path))


def test_mpeg2_in_a_hand_built_transport_stream_and_its_refusals(tmp_path):
    """A picture a PES packet with this writer (PAT, PMT, PTS): cv2's frames. Another stream type (HEVC, 0x24) and a
    continuity counter that jumps raise NotImplementedError naming them."""
    path = _write_cv2(str(tmp_path / "clip.m2v"), "mpg2", _scene(64, 48, 10))
    pictures = _split_pictures(open(path, "rb").read())
    data = _ts(pictures, 0x02)
    ts = _write(tmp_path, "clip.ts", data)
    _assert_frames_equal(read_video_frames(ts), capture(ts))
    _assert_frames_equal(read_video_frames(ts), read_video_frames(path))
    with pytest.raises(NotImplementedError, match=r"HEVC \(stream_type 0x24\)"):
        read_video_frames(_write(tmp_path, "hevc.ts", _ts(pictures, 0x24)))
    video = [i for i in range(0, len(data), 188) if (data[i + 1] & 0x1F) << 8 | data[i + 2] == 0x100]
    lost = data[:video[5]] + data[video[5] + 188:]
    with pytest.raises(NotImplementedError, match=r"continuity counter jumps from 4 to 6 on PID 0x100"):
        read_video_frames(_write(tmp_path, "lost.ts", lost))
    repeated = data[:video[5] + 188] + data[video[5]:]  # a duplicate packet is dropped
    _assert_frames_equal(read_video_frames(_write(tmp_path, "repeated.ts", repeated)), read_video_frames(ts))


def test_cut_streams_follow_videocapture(tmp_path):
    """A transport stream cut between packets (its first PES packet and pictures before a sequence header lost)
    and an elementary stream cut at its second sequence header (an open GOP: the B pictures before its I picture
    dropped, as FFmpeg drops them) give cv2's frames."""
    path = _write_cv2(str(tmp_path / "clip.ts"), "mpg2", _scene(96, 64, 30, seed=5))
    data = open(path, "rb").read()
    for packets in (5, 23, 40):
        cut = _write(tmp_path, f"cut{packets}.ts", data[188 * packets:])
        _assert_frames_equal(read_video_frames(cut), capture(cut))
    es = read_transport_stream(data).es
    second = es.find(b"\0\0\1\xb3", 4)
    cut = _write(tmp_path, "cut.m2v", es[second:])
    frames = read_video_frames(cut)
    _assert_frames_equal(frames, capture(cut))
    decoder = Mpeg2Decoder()
    assert len(decoder.decode(es[second:]) + decoder.flush()) == len(frames)
    assert decoder.stats["open_gop_b_dropped"] == 2 and decoder.stats["closed_gops"] == 0


def test_program_stream_codecs_and_the_reader_refusal(tmp_path):
    """cv2's MPEG-4 Part 2 in a program stream (no stream map: told by its start codes), and a file of no known
    container: the refusal names every container of the dispatch."""
    path = _write_cv2(str(tmp_path / "mp4v.mpg"), "mp4v", _scene(64, 48, 8))
    stream = read_program_stream(open(path, "rb").read())
    assert stream.stream_id == 0xE0 and elementary_stream_codec(stream.es) == "mpeg4"
    _assert_frames_equal(read_video_frames(path), capture(path))
    with pytest.raises(NotImplementedError) as refusal:
        read_video_frames(_write(tmp_path, "noise.bin", bytes(range(256)) * 4))
    for name, _, _, codecs in CONTAINERS:
        assert f"{name} with {codecs}" in str(refusal.value)
    assert "MPEG program streams" in str(refusal.value) and "MPEG transport streams" in str(refusal.value)


def _ps(es, stream_type=None):
    """An MPEG-2 program stream of ``es`` in PES packets of stream 0xE0, each after a pack header, with a program
    stream map naming ``stream_type`` first where it is given."""
    pack = b"\0\0\1\xba\x44\x00\x04\x00\x04\x01\x01\x89\xc3\xf8"
    out = pack
    if stream_type is not None:
        body = b"\x80\x01\0\0\0\x04" + bytes([stream_type, 0xE0]) + b"\0\0"
        out += b"\0\0\1\xbc" + struct.pack(">H", len(body) + 4) + body + struct.pack(">I", _crc32(body))
    for i in range(0, len(es), 2000):
        chunk = es[i:i + 2000]
        out += pack + b"\0\0\1\xe0" + struct.pack(">H", len(chunk) + 3) + b"\x80\0\0" + chunk
    return out + b"\0\0\1\xb9"


def test_program_stream_map(tmp_path):
    """A program stream with a map: its stream_type names the codec (0x02: cv2's frames; 0x24: HEVC, refused by
    name), as FFmpeg's demuxer reads it; without a map the start codes do."""
    path = _write_cv2(str(tmp_path / "clip.m2v"), "mpg2", _scene(64, 48, 10))
    es = open(path, "rb").read()
    for stream_type in (None, 0x02):
        ps = _write(tmp_path, "mapped.mpg", _ps(es, stream_type))
        assert read_program_stream(open(ps, "rb").read()).stream_type == stream_type
        _assert_frames_equal(read_video_frames(ps), capture(ps))
        _assert_frames_equal(read_video_frames(ps), read_video_frames(path))
    with pytest.raises(NotImplementedError, match=r"MPEG program stream video of HEVC \(stream_type 0x24\)"):
        read_video_frames(_write(tmp_path, "hevc.mpg", _ps(es, 0x24)))


@pytest.mark.parametrize("codec", ["mpeg2", "mpeg4", "h264"])
def test_access_units_cut_a_picture_each(tmp_path, codec):
    """The reader's cut of an elementary stream: MPEG-2 as FFmpeg's mpegvideo parser cuts it (this file's
    ``_split_pictures``); MPEG-4 Part 2 a VOP a unit, its headers before it; H.264 the writer's access units (several
    slices a picture, parameter sets, B pictures). The units joined are the stream."""
    if codec == "mpeg2":
        es = open(_write_cv2(str(tmp_path / "clip.m2v"), "mpg2", _scene(64, 48, 14)), "rb").read()
        expected = _split_pictures(es)
    elif codec == "mpeg4":
        path = _write_cv2(str(tmp_path / "clip.ts"), "mp4v", _scene(64, 48, 8))
        es = read_transport_stream(open(path, "rb").read()).es
        expected = None
    else:
        aus = random_stream(31, mb_width=3, mb_height=2, frames=8, b_frames=True)[0]
        es, expected = annexb(aus), [annexb([au]) for au in aus]
    units = list(access_units(es, codec))
    assert b"".join(units) == es
    if expected is None:
        assert len(units) == 8 and all(unit.count(b"\0\0\1\xb6") == 1 for unit in units)
    else:
        assert units == expected and len(units) >= 8


MAX_FRAMES_CASES = ["mpg", "ts", "m2v", "h264.ts", "h264", "mp4v.ts"]


@pytest.mark.parametrize("case", MAX_FRAMES_CASES)
def test_max_frames_stops_the_decode(tmp_path, monkeypatch, case):
    """read_video_frames(path, 3) on a program stream, a transport stream or a raw elementary stream (MPEG-2, H.264,
    MPEG-4 Part 2) gives the first 3 frames of the whole decode and feeds the decoder a picture a call until it has
    them: MPEG-2's I, P, B, B (the I picture out when the P comes), and less of the stream than the whole decode."""
    if case.startswith("h264"):
        aus = random_stream(23, mb_width=3, mb_height=2, frames=8)[0]
        data = _ts([annexb([au]) for au in aus], 0x1B) if case.endswith(".ts") else annexb(aus)
        path, cls = _write(tmp_path, f"clip.{case}", data), H264Decoder
    elif case == "mp4v.ts":
        path, cls = _write_cv2(str(tmp_path / "clip.ts"), "mp4v", _scene(64, 48, 10)), Mpeg4Decoder
    else:
        path, cls = _write_cv2(str(tmp_path / f"clip.{case}"), "mpg2", _scene(64, 48, 12)), Mpeg2Decoder
    calls, decode = [], cls.decode
    monkeypatch.setattr(cls, "decode", lambda self, payload: calls.append(len(payload)) or decode(self, payload))
    everything = read_video_frames(path)
    whole, calls[:] = list(calls), []
    first = read_video_frames(path, 3)
    _assert_frames_equal(first, everything[:3])
    assert len(whole) >= len(everything) - 1 and sum(calls) < sum(whole)
    assert (len(calls) == 4) if cls is Mpeg2Decoder else (3 <= len(calls) < len(whole))


def _ref_idc_1(nal):
    """An H.264 NAL unit with its nal_ref_idc, where not 0, set to 1 (decoded alike: only 0 or not counts)."""
    return bytes([nal[0] & 0x9F | 0x20 if nal[0] & 0x60 else nal[0]]) + nal[1:]


@pytest.mark.parametrize("container", ["mpg", "ts"])
def test_h264_with_nal_ref_idc_1_told_apart_from_mpeg4(tmp_path, container):
    """H.264 whose NAL unit headers carry nal_ref_idc 1 (SPS 0x27, PPS 0x28, IDR 0x25, slices 0x21, as some encoders
    write them) in a program stream without a map and on a private-data (0x06) transport stream PID: its start
    codes share bytes with MPEG-4 Part 2's video object layers (0x20-0x2F), yet it is told to be H.264, and decodes
    to cv2's frames and to those of the stream before the rewrite."""
    aus = random_stream(29, mb_width=3, mb_height=2, frames=6)[0]
    rewritten = [[_ref_idc_1(nal) for nal in au] for au in aus]
    es = annexb(rewritten)
    assert {nal[0] for nal in rewritten[0]} >= {0x27, 0x28, 0x25}
    data = _ps(es) if container == "mpg" else _ts([annexb([au]) for au in rewritten], 0x06)
    path = _write(tmp_path, f"ref_idc.{container}", data)
    stream = read_program_stream(data) if container == "mpg" else read_transport_stream(data)
    assert elementary_stream_codec(es) == stream.codec() == "h264"
    frames = read_video_frames(path)
    _assert_frames_equal(frames, capture(path))
    _assert_frames_equal(frames, read_video_frames(_write(tmp_path, "original.h264", annexb(aus))))


@pytest.mark.parametrize("signalled", [True, False])
def test_transport_stream_discontinuity_indicator(tmp_path, signalled):
    """A continuity counter that jumps on a packet whose adaptation field sets discontinuity_indicator (a splice,
    ISO/IEC 13818-1 2.4.3.5) is read on, as FFmpeg reads it: cv2's frames, those of the stream without the jump.
    The same jump unsignalled raises NotImplementedError naming it."""
    path = _write_cv2(str(tmp_path / "clip.m2v"), "mpg2", _scene(64, 48, 10))
    clean = _ts(_split_pictures(open(path, "rb").read()), 0x02)
    data = bytearray(clean)
    video = [i for i in range(0, len(data), 188) if (data[i + 1] & 0x1F) << 8 | data[i + 2] == 0x100]
    # A packet past the fifth with an adaptation field holding its flags (the stuffed last packet of a PES packet).
    jump = next(k for k in range(5, len(video)) if data[video[k] + 3] & 0x20 and data[video[k] + 4] > 0)
    for i in video[jump:]:
        data[i + 3] = data[i + 3] & 0xF0 | (data[i + 3] + 5) & 15
    if signalled:
        data[video[jump] + 5] |= 0x80
    spliced = _write(tmp_path, "spliced.ts", bytes(data))
    if not signalled:
        with pytest.raises(NotImplementedError, match=r"continuity counter jumps from \d+ to \d+ on PID 0x100"):
            read_video_frames(spliced)
        return
    frames = read_video_frames(spliced)
    _assert_frames_equal(frames, capture(spliced))
    _assert_frames_equal(frames, read_video_frames(_write(tmp_path, "clean.ts", clean)))


# --- the fixtures, the loader and the resolver against the JAX package's ------------------------------------------


def test_fixtures_equal_videocapture_digests_and_counts():
    """Each checked-in clip is the file recorded, decodes to the digest of cv2's frames, and to the picture types
    and macroblock counts recorded: the MPEG-2 .mpg and .ts the same frames (I, P and B pictures), the MPEG-1 .mpg
    I and P pictures."""
    manifest = json.load(open(os.path.join(FIXTURES, "manifest.json")))
    for name in ("mpeg2_960x540x12.mpg", "mpeg2_960x540x12.ts", "mpeg1_960x540x12.mpg"):
        entry = manifest[name]
        data = open(os.path.join(FIXTURES, name), "rb").read()
        assert hashlib.sha256(data).hexdigest() == entry["sha256"] and len(data) < 250_000
        es = read_transport_stream(data).es if name.endswith(".ts") else read_program_stream(data).es
        decoder = Mpeg2Decoder()
        frames = np.stack(decoder.decode(es) + decoder.flush())
        assert list(frames.shape) == entry["shape"] == [12, 540, 960, 3]
        assert hashlib.sha256(frames.tobytes()).hexdigest() == entry["frames_sha256"]
        stats = decoder.stats
        assert {t: stats[f"{t.lower()}_pictures"] for t in "IPB"} == entry["pictures"]
        assert {k: stats[k] for k in entry["macroblocks"]} == entry["macroblocks"]
    assert manifest["mpeg2_960x540x12.mpg"]["frames_sha256"] == manifest["mpeg2_960x540x12.ts"]["frames_sha256"]
    assert manifest[CLIP]["pictures"]["B"] > 0 and manifest["mpeg1_960x540x12.mpg"]["pictures"]["B"] == 0


def test_loader_matches_jax_on_fixture():
    """The port's VideoLoader and the JAX one (cv2.VideoCapture) on the MPEG-2 .mpg, 3 frames, float64: equal."""
    path = os.path.join(FIXTURES, CLIP)
    ours, theirs = VideoLoader(**CPU), JVideoLoader()
    ours.load_frames_from_video(path, 3)
    theirs.load_frames_from_video(path, 3)
    assert ours.num_frames == theirs.num_frames == 3 and ours.image_size == theirs.image_size == (960, 540)
    np.testing.assert_array_equal(ours.frame_stack().numpy(), theirs.frame_stack())


def test_super_resolver_matches_jax_on_mpeg2_frames(tmp_path):
    """The port's VideoSuperResolver on the port's decode of a small MPEG-2 .mpg (I, P and B pictures), and the JAX
    one on cv2.VideoCapture's frames of the same file (window 3, no blur), to 1e-8 of the largest entry."""
    path = _write_cv2(str(tmp_path / "clip.mpg"), "mpg2", _scene(32, 24, 5, seed=21))
    loader, jloader = VideoLoader(**CPU), JVideoLoader()
    loader.load_frames_from_video(path)
    jloader.load_frames_from_video(path)
    kwargs = dict(scale=2, temporal_window=3, blur_radius=0)
    theirs = np.asarray(JVideoSuperResolver(**kwargs).super_resolve(np.asarray(jloader.frame_stack())))
    ours = VideoSuperResolver(**kwargs, **CPU).super_resolve(loader.frame_stack()).numpy()
    assert ours.shape == theirs.shape == (5, 3, 48, 64)
    assert np.abs(ours - theirs).max() <= 1e-8 * np.abs(theirs).max()


def test_stats_names_match_the_decoder():
    assert len(Mpeg2Decoder().stats) == len(STATS)
