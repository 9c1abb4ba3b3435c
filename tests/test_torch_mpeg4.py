"""MPEG-4 Part 2 video in the port: the ISO-BMFF demuxer
(``video/mp4.py``), the AVI routing and the Simple Profile decoder
(``utils/mpeg4.py`` with ``native/mpeg4_decoder.cpp``), held against
``cv2.VideoCapture`` -- the JAX package's video path -- on the same files.

Every frame is array-equal to ``cv2.VideoCapture``'s (FFmpeg's decoder and
swscale's YUV 4:2:0 -> BGR24 conversion), with no drift over a GOP: the
clips ``cv2.VideoWriter`` writes here (``mp4v`` in .mp4 and .mov, ``XVID`` /
``DIVX`` / ``FMP4`` / ``DX50`` in .avi; 16x16 to 352x288, odd-macroblock
sizes; whole-pixel and sub-pixel pans, a zoom, a burst of noise that makes
P-VOPs carry intra macroblocks; three GOPs), the coding tools OpenCV does
not switch on, written by the same FFmpeg encoder through its C API
(``_lavc_encode``: 4MV, video packets, AC prediction, adaptive quantisation,
MPEG quantisation), VOLs rewritten by hand to MPEG quantisation with default
and loaded matrices, streams of random syntax written here (every macroblock
type, DC by either VLC, large coefficients, saturated pixels: where FFmpeg's
x86 SIMD code departs from its C code, which ``cv2.VideoCapture`` runs and the
port follows), edit lists, uncoded VOPs and the other MP4 layouts. Streams
FFmpeg takes for Xvid's (user data ``XviD<build>``, or no encoder name in an
``XVID`` AVI) and for old DivX builds are decoded as FFmpeg decodes them:
its Xvid IDCT (held against FFmpeg's own through its public ``AVDCT`` API on
random blocks, saturating ones included, as is the simple IDCT), edges at
the picture's size for old builds and DC predictors left unclipped. The
loader matches the JAX loader in float64; the resolver matches the JAX
resolver on the decoded frames to 1e-8 of the largest entry. What the decoder
does not cover raises ``NotImplementedError`` naming it.
"""

import ctypes
import glob
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

from super_resolution_tpu_torch.utils.mpeg4 import Mpeg4Decoder, idct, parse_vol, start_codes
from super_resolution_tpu_torch.video import VideoLoader, VideoSuperResolver
from super_resolution_tpu_torch.video.mp4 import read_mp4_video
from super_resolution_tpu_torch.video.video_loader import read_avi_frames, read_video_frames

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_libav  # noqa: E402
from torch_libav import libavcodec as _libavcodec  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data_torch", "video")
CPU = dict(device="cpu", dtype=torch.float64)
GOP = 12  # cv2.VideoWriter's MPEG-4 GOP: an I-VOP every 12 frames


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _texture(h, w, seed):
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.uniform(0, 255, (h, w, 3)), (0, 0), 2.0)
    return np.clip((img - img.mean()) * 4 + 128, 0, 255).astype(np.uint8)


def _motion_frames(w, h, n=30, seed=0, noise_at=15):
    """Frames 0-9 a whole-pixel pan, 10-19 a sub-pixel pan (the source
    resampled), 20-29 a zoom about the centre; frame ``noise_at`` is noise."""
    pad = 48
    big = _texture(h + 2 * pad, w + 2 * pad, seed)
    frames = []
    for i in range(n):
        if i < 10:
            dx, dy, zoom = 2 * i, i, 1.0
        elif i < 20:
            dx, dy, zoom = 20 + 0.37 * (i - 10), 10 - 0.61 * (i - 10), 1.0
        else:
            dx, dy, zoom = 23.7, 3.9, 1.0 + 0.03 * (i - 19)
        cx, cy = pad + w / 2 + dx - 24, pad + h / 2 + dy - 12
        m = np.array([[zoom, 0, w / 2 - zoom * cx], [0, zoom, h / 2 - zoom * cy]])
        frames.append(cv2.warpAffine(big, m, (w, h), flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT))
    if noise_at is not None and noise_at < n:
        frames[noise_at] = np.random.default_rng(seed + 1).integers(0, 256, (h, w, 3), dtype=np.uint8)
    return frames


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


def _assert_equal_to_capture(path, ours=None):
    """The port's frames of ``path`` array-equal to cv2.VideoCapture's, and
    no drift: the gap on a GOP's last P-VOP <= the gap on its I-VOP + 1."""
    ours = read_video_frames(path) if ours is None else ours
    theirs = _capture(path)
    assert len(ours) == len(theirs) > 0
    gaps = [int(np.abs(a.astype(int) - b.astype(int)).max()) for a, b in zip(ours, theirs)]
    assert gaps == [0] * len(gaps), f"per-frame max gap {gaps}"
    for start in range(0, len(gaps) - 1, GOP):
        last = min(start + GOP, len(gaps)) - 1
        assert gaps[last] <= gaps[start] + 1
    return ours


# --- clips cv2.VideoWriter writes --------------------------------------------------------


@pytest.mark.parametrize("size", [(16, 16), (54, 38), (160, 120), (352, 288)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fourcc,ext", [("mp4v", "mp4"), ("mp4v", "mov"), ("XVID", "avi"), ("DIVX", "avi"),
                                        ("FMP4", "avi")], ids=["mp4v-mp4", "mp4v-mov", "XVID", "DIVX", "FMP4"])
def test_videowriter_clips_equal_videocapture(tmp_path, fourcc, ext, size):
    path = str(tmp_path / f"clip.{ext}")
    _write(path, fourcc, _motion_frames(*size, seed=sum(size)))
    frames = _assert_equal_to_capture(path)
    assert len(frames) == 30 and frames[0].shape == (size[1], size[0], 3)
    assert len(read_video_frames(path, max_frames=13)) == 13


def test_avi_fourcc_variants_route_to_the_decoder(tmp_path):
    """``DX50`` and the lower-case / ``MP4V`` tags of the same stream reach
    the MPEG-4 decoder; cv2.VideoWriter writes ``DX50`` and ``mp4v`` AVIs."""
    for fourcc in ("DX50", "mp4v"):
        path = str(tmp_path / f"{fourcc}.avi")
        _write(path, fourcc, _motion_frames(48, 32, n=14, seed=5))
        _assert_equal_to_capture(path, read_avi_frames(path))


# --- the coding tools OpenCV does not switch on, through FFmpeg's encoder ----------------


def _lavc_encode(frames, options):
    """The MPEG-4 Part 2 payloads FFmpeg's ``mpeg4`` encoder (the one
    cv2.VideoWriter drives) writes for BGR ``frames`` with AVOptions
    ``options``, through libavcodec's C API: the AVFrame and AVPacket fields
    used are ``data`` / ``linesize`` / ``width`` / ``height`` / ``format``
    (byte offsets 0 / 64 / 104 / 108 / 116) and ``data`` / ``size`` (24 / 32)."""
    avutil, avcodec = _libavcodec()
    p = ctypes.c_void_p
    avcodec.avcodec_find_encoder.restype = p
    avcodec.avcodec_alloc_context3.restype, avcodec.avcodec_alloc_context3.argtypes = p, [p]
    avcodec.avcodec_open2.argtypes = [p, p, p]
    avcodec.av_packet_alloc.restype = p
    avcodec.avcodec_send_frame.argtypes = [p, p]
    avcodec.avcodec_receive_packet.argtypes = [p, p]
    avcodec.av_packet_unref.argtypes = [p]
    avutil.av_frame_alloc.restype = p
    avutil.av_frame_get_buffer.argtypes = [p, ctypes.c_int]
    avutil.av_frame_make_writable.argtypes = [p]
    avutil.av_opt_set.argtypes = [p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    h, w = frames[0].shape[:2]
    codec = avcodec.avcodec_find_encoder(12)  # AV_CODEC_ID_MPEG4
    ctx = avcodec.avcodec_alloc_context3(codec)
    settings = {"video_size": f"{w}x{h}", "pixel_format": "yuv420p", "time_base": "1/10", "g": str(GOP), "bf": "0",
                **options}
    for key, value in settings.items():
        assert avutil.av_opt_set(ctx, key.encode(), value.encode(), 1) >= 0, key  # 1: search the encoder's own
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

    for bgr in frames:
        i420 = cv2.cvtColor(bgr, cv2.COLOR_BGR2YUV_I420)
        planes = (i420[:h], i420[h:h + h // 4].reshape(h // 2, w // 2), i420[h + h // 4:].reshape(h // 2, w // 2))
        assert avutil.av_frame_make_writable(frame) == 0
        head = ctypes.string_at(frame, 96)
        data, linesize = struct.unpack("<8Q", head[:64]), struct.unpack("<8i", head[64:])
        for k, plane in enumerate(planes):
            for row in range(plane.shape[0]):
                ctypes.memmove(data[k] + row * linesize[k], plane[row].tobytes(), plane.shape[1])
        assert avcodec.avcodec_send_frame(ctx, frame) == 0
        drain()
    avcodec.avcodec_send_frame(ctx, None)
    drain()
    return payloads


@pytest.mark.parametrize("size", [(64, 37), (33, 19), (9, 17), (2, 3)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_odd_heights_equal_videocapture(tmp_path, size):
    """Streams of odd height from FFmpeg's mpeg4 encoder (through ctypes): array-equal to cv2.VideoCapture,
    which converts them through swscale's bicubic scaler with the chroma sited left, as FFmpeg's MPEG-4
    decoder marks it (native/swscale_bgr.h)."""
    w, h = size
    rng = np.random.default_rng(w * h)
    frames = []
    for i in range(6):
        yuv = cv2.cvtColor(np.ascontiguousarray(_texture(h, w + 6, seed=w)[:, i:i + w]), cv2.COLOR_BGR2YUV)
        chroma = [np.clip(yuv[::2, ::2, c].astype(int) + rng.integers(-40, 41, yuv[::2, ::2, c].shape), 0, 255)
                  .astype(np.uint8) for c in (1, 2)]
        frames.append([yuv[..., 0], *chroma])
    payloads, _ = torch_libav.encode("mpeg4", frames, "yuv420p", w, h, {"g": 3, "bf": 0})
    path = str(tmp_path / "odd.avi")
    torch_libav.write_avi(path, payloads, w, h, b"FMP4")
    ours = _assert_equal_to_capture(path)
    assert ours[0].shape == (h, w, 3)


def _write_avi(path, payloads, w, h, fourcc=b"XVID"):
    """A RIFF AVI of compressed frames with an ``idx1`` index (I-VOPs marked as key frames)."""
    keys = []
    for payload in payloads:
        vop = payload.find(b"\x00\x00\x01\xb6")
        keys.append(vop >= 0 and payload[vop + 4] >> 6 == 0)
    torch_libav.write_avi(path, payloads, w, h, fourcc, keys=keys)


def _avi_payloads(path):
    data, out = open(path, "rb").read(), []
    pos = data.find(b"movi") + 4
    while pos + 8 <= len(data):
        fourcc, size = struct.unpack("<4sI", data[pos:pos + 8])
        if fourcc == b"idx1":
            break
        if fourcc[2:] in (b"dc", b"db"):
            out.append(data[pos + 8:pos + 8 + size])
        pos += 8 + size + (size & 1)
    return out


LAVC_TOOLS = {
    "4mv": {"flags": "+mv4"},
    "video_packets": {"ps": "150"},
    "ac_prediction": {"flags": "+aic"},
    "adaptive_quant": {"lumi_mask": "0.5", "scplx_mask": "0.5", "p_mask": "0.5"},
    # AC prediction from neighbours of another quantiser: their coefficients rescaled with rounding
    "ac_prediction_across_quantisers": {"flags": "+aic", "lumi_mask": "0.8", "dark_mask": "0.8", "scplx_mask": "0.8"},
    "mpeg_quant": {"mpeg_quant": "1"},
    "all": {"flags": "+mv4+aic", "ps": "100", "mpeg_quant": "1", "lumi_mask": "0.4", "p_mask": "0.4"},
}


@pytest.mark.parametrize("tool", list(LAVC_TOOLS))
def test_coding_tools_equal_videocapture(tmp_path, tool):
    """Large motion (vectors past the frame edge, fcode > 1) at 144x112 (an
    odd count of macroblock columns) under a brightness ramp (adaptive
    quantisation then varies the quantiser between neighbours), a noise burst,
    two GOPs, each tool on."""
    w, h = 144, 112
    big = _texture(h + 400, w + 400, 9)
    ramp = np.linspace(0.2, 1.0, w)[None, :, None] * np.linspace(0.3, 1.0, h)[:, None, None]
    frames = [(big[17 * i:17 * i + h, 23 * i:23 * i + w] * ramp).astype(np.uint8) for i in range(16)]
    frames[6] = np.random.default_rng(4).integers(0, 256, (h, w, 3), dtype=np.uint8)
    payloads = _lavc_encode(frames, LAVC_TOOLS[tool])
    assert payloads != _lavc_encode(frames, {})  # the tool changed the stream
    path = str(tmp_path / f"{tool}.avi")
    _write_avi(path, payloads, w, h)
    _assert_equal_to_capture(path)
    vol = parse_vol(payloads[0], *next((s, e) for code, s, e in start_codes(payloads[0]) if 0x20 <= code <= 0x2F))
    assert vol.quant_type == ("mpeg_quant" in LAVC_TOOLS[tool])
    assert vol.resync_marker_disable == ("ps" not in LAVC_TOOLS[tool])


# --- VOLs written by hand -------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, n, value):
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]

    def stuffed(self):
        """The bits, then next_start_code()'s stuffing: a 0 and 1s to the byte."""
        bits = self.bits + [0] + [1] * ((7 - len(self.bits) % 8) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7,
          14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39,
          46, 53, 60, 61, 54, 47, 55, 62, 63]


def _vol(width, height, resolution=10, verid=1, shape=0, interlaced=0, sprite=0, quant_type=0, intra=None,
         inter=None, quarter_sample=0, data_partitioned=0):
    """A video object layer header (ISO/IEC 14496-2, 6.2.3), start code included.
    ``intra`` / ``inter``: loaded matrices as zigzag-ordered values (a 0 ends one early)."""
    b = _BitWriter()
    b.put(32, 0x120)
    b.put(1, 0)
    b.put(8, 1)  # random_accessible_vol, Simple object type
    b.put(1, 1)
    b.put(4, verid)
    b.put(3, 1)
    b.put(4, 1)  # square pixels
    b.put(1, 1)
    b.put(2, 1)
    b.put(1, 1)
    b.put(1, 0)  # vol_control_parameters: 4:2:0, low delay, no VBV
    b.put(2, shape)
    b.put(1, 1)
    b.put(16, resolution)
    b.put(1, 1)
    b.put(1, 0)  # fixed_vop_rate
    for n, value in ((1, 1), (13, width), (1, 1), (13, height), (1, 1)):
        b.put(n, value)
    b.put(1, interlaced)
    b.put(1, 1)  # obmc_disable
    b.put(1 if verid == 1 else 2, sprite)
    b.put(1, 0)  # not_8_bit
    b.put(1, quant_type)
    if quant_type:
        for matrix in (intra, inter):
            b.put(1, matrix is not None)
            for value in matrix or []:
                b.put(8, value)
    if verid != 1:
        b.put(1, quarter_sample)
    b.put(1, 1)  # complexity_estimation_disable
    b.put(1, 1)  # resync_marker_disable
    b.put(1, data_partitioned)
    if data_partitioned:
        b.put(1, 0)
    if verid != 1:
        b.put(2, 0)  # NEWPRED, reduced-resolution VOPs
    b.put(1, 0)  # scalability
    return b.stuffed()


def _replace_vols(payloads, vol):
    """``payloads`` with every VOL header (start code to the next start code) replaced by ``vol``."""
    out = []
    for payload in payloads:
        for code, start, end in reversed(start_codes(payload)):
            if 0x20 <= code <= 0x2F:
                payload = payload[:start - 4] + vol + payload[end:]
        out.append(payload)
    return out


@pytest.mark.parametrize("matrices", ["default", "loaded"])
def test_mpeg_quantisation_by_a_rewritten_vol(tmp_path, matrices):
    """An OpenCV XVID AVI whose VOLs are rewritten to ``quant_type`` 1: the
    same VOP syntax, read with MPEG inverse quantisation (intra: scaled by
    the matrix; inter: with mismatch control) and the default or loaded
    matrices (the non-intra one ended early by a 0, its last value repeated)."""
    w, h = 80, 64
    src = str(tmp_path / "src.avi")
    _write(src, "XVID", _motion_frames(w, h, n=26, seed=3))
    payloads = _avi_payloads(src)
    first = payloads[0]
    assert parse_vol(first, *next((s, e) for c, s, e in start_codes(first) if 0x20 <= c <= 0x2F)).time_increment_bits \
        == 4  # OpenCV's time base 1/10: a resolution of 10
    loaded = matrices == "loaded"
    vol = _vol(w, h, quant_type=1, intra=[8] + [12 + (3 * i) % 50 for i in range(63)] if loaded else None,
               inter=[16 + i % 9 for i in range(20)] + [0] if loaded else None)
    path = str(tmp_path / "mpeg_quant.avi")
    _write_avi(path, _replace_vols(payloads, vol), w, h)
    decoder = Mpeg4Decoder()
    ours = [f for p in _avi_payloads(path) for f in decoder.decode(p)]
    assert decoder.vol.quant_type == 1
    if loaded:
        assert decoder.vol.intra_matrix[ZIGZAG[1]] == 12 and decoder.vol.inter_matrix[ZIGZAG[63]] == 16 + 19 % 9
    _assert_equal_to_capture(path, ours)


# --- MP4 layouts, edit lists, uncoded VOPs ----------------------------------------------

_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"dinf", b"udta", b"mvex", b"moof", b"traf"}


def _parse_boxes(data):
    out, pos = [], 0
    while pos + 8 <= len(data):
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + size]
        out.append([kind, _parse_boxes(body) if kind in _CONTAINERS else body])
        pos += size
    return out


def _build_boxes(tree):
    out = b""
    for kind, body in tree:
        body = _build_boxes(body) if isinstance(body, list) else body
        out += struct.pack(">I4s", 8 + len(body), kind) + body
    return out


def _box(tree, *path):
    for node in tree:
        if node[0] == path[0]:
            return node if len(path) == 1 else _box(node[1], *path[1:])
    raise KeyError(path)


@pytest.fixture()
def mp4_clip(tmp_path):
    """A 30-frame 64x48 mp4v clip (mdat before moov, as cv2.VideoWriter writes it) and its frames."""
    path = str(tmp_path / "clip.mp4")
    _write(path, "mp4v", _motion_frames(64, 48, seed=11))
    return path, _capture(path)


def _stbl(tree):
    return _box(tree, b"moov", b"trak", b"mdia", b"minf", b"stbl")[1]


@pytest.mark.parametrize("layout", ["moov_first", "co64", "mdat_64bit_size", "mdat_to_the_end", "chunks_of_3"])
def test_mp4_layouts(tmp_path, mp4_clip, layout):
    """The same samples laid out as other muxers lay them out."""
    src, frames = mp4_clip
    data = open(src, "rb").read()
    tree = _parse_boxes(data)
    mdat_at = data.find(b"mdat") - 4
    mdat_body = _box(tree, b"mdat")[1]
    stbl = _stbl(tree)
    stco = _box(stbl, b"stco")
    offsets = list(struct.unpack(f">{len(stco[1]) // 4 - 2}I", stco[1][8:]))
    sizes = list(struct.unpack(">30I", _box(stbl, b"stsz")[1][12:]))
    base = [o - mdat_at - 8 for o in offsets]  # each sample's place in mdat's body
    others = [n for n in tree if n[0] not in (b"moov", b"mdat")]
    if layout == "chunks_of_3":  # 10 chunks of 3 samples (cv2.VideoWriter writes one chunk of 30)
        assert len(base) == 1
        base = [base[0] + sum(sizes[:i]) for i in range(0, 30, 3)]
        _box(stbl, b"stsc")[1] = struct.pack(">II", 0, 1) + struct.pack(">III", 1, 3, 1)
    moov_first = layout in ("moov_first", "mdat_to_the_end")  # a box that runs to the end comes last
    header = _build_boxes(others)
    for _ in range(2):  # the offsets depend on moov's size, which co64 changes once
        moov = _build_boxes([n for n in tree if n[0] == b"moov"])
        mdat_head = 16 if layout == "mdat_64bit_size" else 8
        body_at = len(header) + (len(moov) if moov_first else 0) + mdat_head
        if layout == "co64":
            stco[0], stco[1] = b"co64", struct.pack(">II", 0, len(base)) + b"".join(
                struct.pack(">Q", body_at + b) for b in base)
        else:
            stco[1] = struct.pack(">II", 0, len(base)) + struct.pack(f">{len(base)}I", *(body_at + b for b in base))
    moov = _build_boxes([n for n in tree if n[0] == b"moov"])
    if layout == "mdat_64bit_size":
        mdat = struct.pack(">I4sQ", 1, b"mdat", 16 + len(mdat_body)) + mdat_body
    elif layout == "mdat_to_the_end":
        mdat = struct.pack(">I4s", 0, b"mdat") + mdat_body
    else:
        mdat = struct.pack(">I4s", 8 + len(mdat_body), b"mdat") + mdat_body
    path = str(tmp_path / f"{layout}.mp4")
    with open(path, "wb") as f:
        f.write(header + (moov + mdat if moov_first else mdat + moov))
    ours = _assert_equal_to_capture(path)
    assert all(np.array_equal(a, b) for a, b in zip(ours, frames)) and len(ours) == len(frames)


# (segment duration in the movie's 1/1000 s, media time in the track's 1/10240 s; 1024 a frame)
EDITS = {"none": [(3000, 0)], "skip_2": [(3000, 2048)], "start_mid_frame": [(3000, 1500)],
         "cut_tail": [(1550, 0)], "two_edits": [(1000, 4096), (1000, 10240)], "empty_first": [(500, -1), (3000, 0)],
         "from_frame_15": [(1000, 15360)]}


@pytest.mark.parametrize("edit", list(EDITS))
def test_edit_lists(tmp_path, mp4_clip, edit):
    """cv2.VideoCapture plays what the edit list selects: from the media
    time, for the segment's duration, each edit in turn; an empty edit only
    delays."""
    src, _ = mp4_clip
    tree = _parse_boxes(open(src, "rb").read())
    entries = EDITS[edit]
    _box(tree, b"moov", b"trak", b"edts", b"elst")[1] = struct.pack(">II", 0, len(entries)) + b"".join(
        struct.pack(">Iihh", duration, media_time, 1, 0) for duration, media_time in entries)
    path = str(tmp_path / f"{edit}.mp4")
    with open(path, "wb") as f:
        f.write(_build_boxes(tree))  # moov stays after mdat: the sample offsets hold
    _assert_equal_to_capture(path)


def _uncoded(payload, time_increment_bits):
    """``payload`` with its VOP cut after vop_time_increment and vop_coded set to 0."""
    vop = payload.index(b"\x00\x00\x01\xb6") + 4
    bits = "".join(f"{byte:08b}" for byte in payload[vop:vop + 8])
    pos = 2
    while bits[pos] == "1":
        pos += 1
    pos += 2 + time_increment_bits  # the 0 ending modulo_time_base, marker, increment, marker
    kept = bits[:pos + 1] + "0"  # ... the marker after the increment, then vop_coded = 0
    kept += "0" + "1" * ((7 - len(kept) % 8) % 8)
    return payload[:vop] + bytes(int(kept[i:i + 8], 2) for i in range(0, len(kept), 8))


@pytest.mark.parametrize("where", [[5], [5, 6], [29], [28, 29]], ids=["one", "two", "last", "last_two"])
def test_uncoded_vops(tmp_path, where):
    """A VOP with vop_coded = 0 gives no frame; a stream that ends on such
    VOPs gives its last frame once more (FFmpeg's drain)."""
    w, h = 64, 48
    src = str(tmp_path / "src.avi")
    _write(src, "XVID", _motion_frames(w, h, seed=13))
    payloads = _avi_payloads(src)
    for k in where:
        payloads[k] = _uncoded(payloads[k], 4)
    path = str(tmp_path / "uncoded.avi")
    _write_avi(path, payloads, w, h)
    ours = _assert_equal_to_capture(path)
    assert len(ours) == 30 - len(where) + (29 in where)


# --- the loaders and the resolver against the JAX package ------------------------------


@pytest.mark.parametrize("name", ["mp4v_160x120x14.mp4", "xvid_96x64x8.avi"])
def test_loader_matches_jax(name):
    path = os.path.join(FIXTURES, name)
    for max_frames in (0, 5):
        ours, theirs = VideoLoader(**CPU), JVideoLoader()
        ours.load_frames_from_video(path, max_frames)
        theirs.load_frames_from_video(path, max_frames)
        assert ours.num_frames == theirs.num_frames == (max_frames or json.load(
            open(os.path.join(FIXTURES, "manifest.json")))[name]["shape"][0])
        assert ours.image_size == theirs.image_size
        stack = ours.frame_stack()
        assert stack.dtype == torch.float64 and stack.device.type == "cpu"
        np.testing.assert_array_equal(stack.numpy(), theirs.frame_stack())


def test_super_resolver_matches_jax_on_decoded_frames(tmp_path):
    """The JAX and the port's VideoSuperResolver on the port's decode of an
    mp4v clip (window 3, no blur), to 1e-8 of the largest entry."""
    path = str(tmp_path / "clip.mp4")
    base = _texture(64, 64, 21)
    _write(path, "mp4v", [base[i:i + 24, 2 * i:2 * i + 24] for i in range(4)])
    loader = VideoLoader(**CPU)
    loader.load_frames_from_video(path)
    frames = loader.frame_stack().numpy()
    assert frames.shape == (4, 3, 24, 24)
    kwargs = dict(scale=2, temporal_window=3, blur_radius=0)
    theirs = np.asarray(JVideoSuperResolver(**kwargs).super_resolve(frames))
    ours = VideoSuperResolver(**kwargs, **CPU).super_resolve(torch.from_numpy(frames)).numpy()
    assert ours.shape == theirs.shape == (4, 3, 48, 48)
    assert np.abs(ours - theirs).max() <= 1e-8 * np.abs(theirs).max()


# --- what the decoder refuses ----------------------------------------------------------


def _refusal_avi(tmp_path, name, payloads, fourcc=b"XVID"):
    path = str(tmp_path / f"{name}.avi")
    _write_avi(path, payloads, 32, 32, fourcc)
    return path


@pytest.fixture()
def xvid_payloads(tmp_path):
    src = str(tmp_path / "src.avi")
    _write(src, "XVID", _motion_frames(32, 32, n=4, seed=2))
    return _avi_payloads(src)


VOL_REFUSALS = {"data partitioning": dict(data_partitioned=1), "interlaced": dict(interlaced=1),
                "quarter-pel": dict(verid=2, quarter_sample=1), "global motion": dict(verid=2, sprite=2),
                "non-rectangular": dict(shape=1)}


@pytest.mark.parametrize("feature", list(VOL_REFUSALS))
def test_vol_features_raise(tmp_path, xvid_payloads, feature):
    path = _refusal_avi(tmp_path, feature, _replace_vols(xvid_payloads, _vol(32, 32, **VOL_REFUSALS[feature])))
    with pytest.raises(NotImplementedError, match=feature):
        read_video_frames(path)


@pytest.mark.parametrize("coding_type,feature", [(2, "B-VOPs"), (3, "S-VOPs")])
def test_vop_types_raise(tmp_path, xvid_payloads, coding_type, feature):
    """A P-VOP's vop_coding_type rewritten to B (2) or S (3)."""
    payloads = list(xvid_payloads)
    vop = payloads[1].index(b"\x00\x00\x01\xb6") + 4
    payloads[1] = payloads[1][:vop] + bytes([(payloads[1][vop] & 0x3F) | coding_type << 6]) + payloads[1][vop + 1:]
    path = _refusal_avi(tmp_path, "vop", payloads)
    with pytest.raises(NotImplementedError, match=feature):
        read_video_frames(path)


def test_short_header_raises():
    """H.263 baseline inside MPEG-4 (short_video_start_code, 22 bits)."""
    with pytest.raises(NotImplementedError, match="short headers"):
        Mpeg4Decoder().decode(bytes([0x00, 0x00, 0x80, 0x02, 0x08]) + bytes(16))


def _fragmented(data):
    """``data`` (an mp4) with an ``mvex`` box in moov, or a ``moof`` after it."""
    tree = _parse_boxes(data)
    with_mvex = [n if n[0] != b"moov" else [b"moov", n[1] + [[b"mvex", [[b"trex", bytes(24)]]]]] for n in tree]
    return _build_boxes(with_mvex), data + _build_boxes([[b"moof", [[b"mfhd", bytes(8)]]]])


def test_mp4_refusals(tmp_path, mp4_clip):
    """A fragmented file (mvex, moof), other sample entries, another object type in esds."""
    src, _ = mp4_clip
    data = open(src, "rb").read()
    for body in _fragmented(data):
        path = str(tmp_path / "fragmented.mp4")
        open(path, "wb").write(body)
        with pytest.raises(NotImplementedError, match="Fragmented MP4"):
            read_video_frames(path)
    for fourcc, name in ((b"avc2", r"H\.264 \(avc2\)"), (b"hvc1", r"HEVC \(hvc1\)"), (b"av01", r"AV1 \(av01\)")):
        tree = _parse_boxes(data)
        stsd = _box(_stbl(tree), b"stsd")
        assert stsd[1][12:16] == b"mp4v"  # version / flags, entry count, then the entry's size and type
        stsd[1] = stsd[1][:12] + fourcc + stsd[1][16:]
        path = str(tmp_path / f"{fourcc.decode()}.mp4")
        open(path, "wb").write(_build_boxes(tree))
        with pytest.raises(NotImplementedError, match=name):
            read_video_frames(path)
        with pytest.raises(NotImplementedError, match=name):
            read_mp4_video(open(path, "rb").read())
    esds = data.index(b"esds")
    dcd = data.index(b"\x04\x80\x80\x80", esds)
    path = str(tmp_path / "jpeg.mp4")  # MPEG-2 video (0x60-0x65) is read now: JPEG (0x6C) stands for the others
    open(path, "wb").write(data[:dcd + 5] + b"\x6c" + data[dcd + 6:])
    with pytest.raises(NotImplementedError, match=r"JPEG \(mp4v with objectTypeIndication 0x6C\)"):
        read_video_frames(path)


def test_other_containers_and_codecs_raise(tmp_path):
    mkv = str(tmp_path / "clip.mkv")  # Matroska with FFV1, refused until the port read it: now cv2's frames
    _write(mkv, "FFV1", _motion_frames(32, 24, n=3))
    _assert_equal_to_capture(mkv)
    for ext in ("mkv", "avi"):  # HuffYUV: a codec the port does not decode
        path = str(tmp_path / f"hfyu.{ext}")
        _write(path, "HFYU", _motion_frames(32, 24, n=3))
        with pytest.raises(NotImplementedError, match="HFYU"):
            read_video_frames(path)
    div3 = str(tmp_path / "div3.avi")  # MS-MPEG4 v3: another codec
    _write(div3, "DIV3", _motion_frames(32, 24, n=3))
    with pytest.raises(NotImplementedError, match="DIV3"):
        read_video_frames(div3)


# --- the checked-in fixtures -----------------------------------------------------------

# The Motion-JPEG bounds tests/test_torch_video.py holds against cv2.VideoCapture (grey levels).
MJPEG_GAP_MAX, MJPEG_GAP_MEAN = 26, 1.9


@pytest.mark.parametrize("name", sorted(json.load(open(os.path.join(FIXTURES, "manifest.json")))))
def test_checked_in_fixtures(name):
    """Each fixture is the file recorded, cv2.VideoCapture still decodes it to
    the frames recorded (digest, and the PNG the card's host compares with),
    and the port decodes it to the same frames."""
    entry = json.load(open(os.path.join(FIXTURES, "manifest.json")))[name]
    path = os.path.join(FIXTURES, name)
    assert hashlib.sha256(open(path, "rb").read()).hexdigest() == entry["sha256"]
    ours, theirs = np.stack(read_video_frames(path)), np.stack(_capture(path))
    assert list(ours.shape) == entry["shape"]
    assert hashlib.sha256(theirs.tobytes()).hexdigest() == entry["frames_sha256"]
    if "decode_sha256" in entry:  # Motion-JPEG: each frame as cv2.imdecode decodes it, near cv2.VideoCapture's
        assert hashlib.sha256(ours.tobytes()).hexdigest() == entry["decode_sha256"]
        gap = np.abs(ours.astype(int) - theirs)
        assert [int(gap.max()), float(gap.mean())] == entry["capture_gap"]
        assert gap.max() <= MJPEG_GAP_MAX and gap.mean() <= MJPEG_GAP_MEAN
        return
    assert hashlib.sha256(ours.tobytes()).hexdigest() == entry["frames_sha256"]
    if entry["decoded_png"]:
        png = cv2.imread(os.path.join(FIXTURES, entry["decoded_png"]), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(png.reshape(ours.shape), ours)
    total = sum(os.path.getsize(p) for p in glob.glob(os.path.join(FIXTURES, "*")))
    assert total <= 1.5e6


# --- streams of random syntax, written by hand --------------------------------------------

_INTRA_MCBPC = [(1, 1), (1, 3), (2, 3), (3, 3), (1, 4), (1, 6), (2, 6), (3, 6)]  # cbpc | 4 * dquant
_INTER_MCBPC = {0: (1, 1), 1: (3, 4), 2: (2, 4), 3: (5, 6), 4: (3, 5), 5: (4, 8), 6: (3, 8), 7: (3, 7),
                8: (3, 3), 9: (7, 7), 10: (6, 7), 11: (5, 9), 12: (4, 6), 13: (4, 9), 14: (3, 9), 15: (2, 9),
                16: (2, 3), 17: (5, 7), 18: (4, 7), 19: (5, 8)}  # cbpc | 4 * intra | 8 * dquant | 16 * 4MV
_CBPY = [(3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4), (2, 5), (3, 6), (5, 4), (10, 4), (4, 4),
         (8, 4), (6, 4), (3, 2)]  # by the intra pattern; an inter macroblock codes the pattern ^ 15
_MV = [(1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7), (11, 9), (10, 9), (9, 9), (17, 10), (16, 10),
       (15, 10), (14, 10), (13, 10), (12, 10), (11, 10), (10, 10), (9, 10), (8, 10), (7, 10), (6, 10), (5, 10),
       (4, 10), (7, 11), (6, 11), (5, 11), (4, 11), (3, 11), (2, 11), (3, 12), (2, 12)]
_DC_SIZE = {True: [(3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8)],   # luma
            False: [(3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9)]}  # chroma


_Y_DC_SCALE = [0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 34, 36,
               38, 40, 42, 44, 46]
_C_DC_SCALE = [0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18, 19, 20,
               21, 22, 23, 24, 25]


class _SyntaxWriter(_BitWriter):
    """Valid MPEG-4 Simple Profile VOPs of random syntax: every macroblock
    type, dquant, AC prediction, DC by its own VLC or as the first
    coefficient (``intra_dc_vlc_thr``), coefficients in escape mode 3 (last,
    run and level written out), motion vector differences over the whole
    range of ``fcode``, uncoded macroblocks. Each intra DC is chosen so that
    its level (the prediction, kept here as a decoder keeps it, plus the
    coded difference) is one a picture can have: FFmpeg takes a negative
    DC for damage."""

    def __init__(self, rng, mb_w, mb_h):
        super().__init__()
        self.rng, self.mb_w, self.mb_h = rng, mb_w, mb_h
        self.quant, self.dc_threshold = 1, 0
        # reconstructed DC of each 8x8 block, a border of 1024 above and to the left: luma, then U, then V
        self.dc = [np.full((2 * mb_h + 1, 2 * mb_w + 1), 1024), np.full((mb_h + 1, mb_w + 1), 1024),
                   np.full((mb_h + 1, mb_w + 1), 1024)]
        self.mb = (0, 0)

    def _dc_cell(self, n):
        mx, my = self.mb
        if n < 4:
            return self.dc[0], 2 * my + (n >> 1) + 1, 2 * mx + (n & 1) + 1
        return self.dc[n - 3], my + 1, mx + 1

    def dc_prediction(self, n):
        """The quantised DC prediction of block ``n`` (the gradient rule, and
        1024 above the picture's first row and left of its first column)."""
        grid, y, x = self._dc_cell(n)
        a, b, c = int(grid[y, x - 1]), int(grid[y - 1, x - 1]), int(grid[y - 1, x])
        scale = (_Y_DC_SCALE if n < 4 else _C_DC_SCALE)[self.quant]
        pred = c if abs(a - b) < abs(b - c) else a
        return (pred + scale // 2) // scale, scale

    def set_dc(self, n, level, scale):
        grid, y, x = self._dc_cell(n)
        grid[y, x] = min(max(level * scale, 0), 2047)

    def clear_dc(self):
        """An inter or uncoded macroblock: its blocks predict as 1024."""
        for n in range(6):
            grid, y, x = self._dc_cell(n)
            grid[y, x] = 1024

    def dquant(self):
        step = int(self.rng.integers(0, 4))
        self.put(2, step)
        self.quant = min(max(self.quant + (-1, -2, 1, 2)[step], 1), 31)

    def dc_vlc(self):
        """Whether an intra macroblock codes its DC with the DC size VLC: the
        quantiser before its dquant against intra_dc_vlc_thr's bound."""
        return self.quant < (99, 13, 15, 17, 19, 21, 23, 0)[self.dc_threshold]

    def code(self, pair):
        self.put(pair[1], pair[0])

    def coefficients(self, start, first=None, skip_dc=False):
        """1-4 coefficients after scan position ``start`` (-1: from the DC
        on), the last marked; ``first``: the DC's value, coded at position 0;
        ``skip_dc``: from -1, but the first past the DC."""
        pos, count = start, int(self.rng.integers(1, 5))
        for k in range(count):
            run = 0 if k == 0 and first is not None else min(int(self.rng.integers(skip_dc and k == 0, 8)), 62 - pos)
            pos += run + 1
            last = k == count - 1 or pos >= 63
            level = first if k == 0 and first is not None else \
                int(self.rng.integers(1, 40)) * (1 if self.rng.random() < 0.5 else -1)
            self.put(7, 3)  # escape
            self.put(2, 3)  # mode 3
            for n, value in ((1, last), (6, run), (1, 1), (12, level & 0xFFF), (1, 1)):
                self.put(n, value)
            if last:
                return

    def intra_blocks(self, cbp, dc_vlc):
        for n in range(6):
            coded = cbp >> (5 - n) & 1
            pred, scale = self.dc_prediction(n)
            level = pred
            if dc_vlc or coded:  # a DC level a picture can have, near the prediction or anywhere
                top = 2047 // scale
                level = int(self.rng.integers(0, top + 1)) if self.rng.random() < 0.2 else \
                    min(max(pred + int(self.rng.integers(-6, 7)), 0), top)
            diff = level - pred
            if dc_vlc:
                size = abs(diff).bit_length()
                self.code(_DC_SIZE[n < 4][size])
                if size:
                    self.put(size, diff if diff > 0 else diff + (1 << size) - 1)
                    if size > 8:
                        self.put(1, 1)  # marker
                if coded:
                    self.coefficients(0)
            elif coded:
                if diff:
                    self.coefficients(-1, first=diff)
                else:  # nothing to code at the DC: the first coefficient lies past it
                    self.coefficients(-1, skip_dc=True)
            self.set_dc(n, level, scale)

    def intra_macroblock(self, mcbpc_table, index_of):
        cbpc, dquant = int(self.rng.integers(0, 4)), self.rng.random() < 0.3
        self.code(mcbpc_table[index_of(cbpc, dquant)])
        self.put(1, int(self.rng.random() < 0.5))  # ac_pred_flag
        cbpy = int(self.rng.integers(0, 16))
        self.code(_CBPY[cbpy])
        dc_vlc = self.dc_vlc()
        if dquant:
            self.dquant()
        self.intra_blocks(cbpy << 2 | cbpc, dc_vlc)

    def vop(self, coding_type, quant, dc_threshold, f_code):
        self.put(32, 0x1B6)
        self.put(2, coding_type)
        for n, value in ((1, 0), (1, 1), (4, 0), (1, 1), (1, 1)):  # modulo_time_base .. vop_coded
            self.put(n, value)
        if coding_type == 1:
            self.put(1, int(self.rng.random() < 0.5))  # vop_rounding_type
        self.put(3, dc_threshold)
        self.put(5, quant)
        self.quant, self.dc_threshold = quant, dc_threshold
        if coding_type == 1:
            self.put(3, f_code)
        for index in range(self.mb_w * self.mb_h):
            self.mb = (index % self.mb_w, index // self.mb_w)
            if coding_type == 0:
                self.intra_macroblock(_INTRA_MCBPC, lambda c, q: c | 4 * q)
                continue
            kind = self.rng.choice(["skip", "inter", "inter4v", "intra"], p=[.2, .45, .2, .15])
            if kind == "intra":
                self.put(1, 0)
                self.intra_macroblock(_INTER_MCBPC, lambda c, q: c | 4 | 8 * q)
                continue
            self.clear_dc()
            if kind == "skip":
                self.put(1, 1)
                continue
            self.put(1, 0)
            cbpc, dquant = int(self.rng.integers(0, 4)), kind == "inter" and self.rng.random() < 0.3
            self.code(_INTER_MCBPC[cbpc | 8 * dquant | 16 * (kind == "inter4v")])
            cbpy = int(self.rng.integers(0, 16))
            self.code(_CBPY[cbpy ^ 15])
            if dquant:
                self.dquant()
            for _ in range(8 if kind == "inter4v" else 2):  # motion vector differences, x then y
                magnitude = int(self.rng.choice([0, 1, 2, 3, 5, 9, 17, 32], p=[.3, .2, .15, .1, .1, .05, .05, .05]))
                self.code(_MV[magnitude])
                if magnitude:
                    self.put(1, int(self.rng.random() < 0.5))
                    if f_code > 1:
                        self.put(f_code - 1, int(self.rng.integers(0, 1 << (f_code - 1))))
            for n in range(6):
                if (cbpy << 2 | cbpc) >> (5 - n) & 1:
                    self.coefficients(-1)
        return self.stuffed()


def _random_syntax_payloads(seed, w=64, h=48, vops=6):
    """The VOL, an I-VOP and P-VOPs of random syntax: quantisers 1-31, every
    ``intra_dc_vlc_thr``, fcode 1-7; H.263 quantisation for even seeds, MPEG
    quantisation for odd ones (loaded matrices for every fourth seed)."""
    rng = np.random.default_rng(seed)
    loaded = seed % 4 == 3
    vol = _vol(w, h, quant_type=seed % 2, intra=[int(v) for v in rng.integers(8, 80, 64)] if loaded else None,
               inter=[int(v) for v in rng.integers(8, 80, 64)] if loaded else None)
    payloads = []
    for k in range(vops):
        writer = _SyntaxWriter(rng, w // 16, h // 16)
        vop = writer.vop(0 if k == 0 else 1, int(rng.integers(1, 32)), int(rng.integers(0, 8)),
                         int(rng.integers(1, 8)))
        payloads.append((vol if k == 0 else b"") + vop)
    return payloads


@pytest.mark.parametrize("seed", range(12))
def test_random_syntax_equals_videocapture(tmp_path, seed):
    """An I-VOP and five P-VOPs of random syntax (``_SyntaxWriter``) at 64x48,
    fourcc ``FMP4`` and no encoder name (so FFmpeg keeps its simple IDCT):
    saturated pixels, large coefficients and every macroblock type, where
    FFmpeg's x86 code departs from its C code."""
    w, h = 64, 48
    payloads = _random_syntax_payloads(seed, w, h)
    path = str(tmp_path / "syntax.avi")
    _write_avi(path, payloads, w, h, fourcc=b"FMP4")
    _assert_equal_to_capture(path)


def test_negative_intra_dc_raises():
    """A DC level below 0 (here the prediction 1024 / 8 = 128 less 200) is
    damage, as FFmpeg takes it: ``ValueError``, not a picture."""
    b = _SyntaxWriter(np.random.default_rng(0), 1, 1)
    b.put(32, 0x1B6)
    for n, value in ((2, 0), (1, 0), (1, 1), (4, 0), (1, 1), (1, 1), (3, 0), (5, 4)):  # I-VOP, DC VLC, quant 4
        b.put(n, value)
    b.code(_INTRA_MCBPC[0])
    b.put(1, 0)  # ac_pred_flag
    b.code(_CBPY[0])
    b.code(_DC_SIZE[True][8])
    b.put(8, -200 + 255)
    for n in range(1, 6):
        b.code(_DC_SIZE[n < 4][0])
    with pytest.raises(ValueError, match="negative intra DC"):
        Mpeg4Decoder().decode(_vol(16, 16) + b.stuffed())


# --- the encoder FFmpeg reads from the stream: the Xvid IDCT and old builds' workarounds ---


def _avdct(algo):
    """FFmpeg's IDCT of ``idct_algo`` ``algo`` as cv2.VideoCapture runs it, through the public
    ``AVDCT`` API of the cv2 wheel's libavcodec (``avcodec_dct_alloc`` / ``avcodec_dct_init``;
    ``idct`` at byte 8, its input permutation at 16, ``idct_algo`` at 92): ``[8, 8]`` int16 in
    raster order -> the IDCT's int16 output."""
    _, avcodec = _libavcodec()
    avcodec.avcodec_dct_alloc.restype = ctypes.c_void_p
    avcodec.avcodec_dct_init.argtypes = [ctypes.c_void_p]
    dct = avcodec.avcodec_dct_alloc()
    ctypes.memmove(dct + 92, struct.pack("<i", algo), 4)
    assert avcodec.avcodec_dct_init(dct) == 0
    function = ctypes.CFUNCTYPE(None, ctypes.c_void_p)(ctypes.c_void_p.from_address(dct + 8).value)
    permutation = np.frombuffer(ctypes.string_at(dct + 16, 64), np.uint8)
    buffer = np.zeros(64 + 8, np.int16)
    start = (-buffer.ctypes.data % 16) // 2  # the SIMD code loads 16-byte aligned rows
    block = buffer[start:start + 64]

    def run(coefficients):
        block[permutation] = coefficients.reshape(64)
        function(block.ctypes.data)
        return block.reshape(8, 8).copy()

    return run


def _random_blocks(rng, count):
    """Coefficient blocks of four kinds: sparse small levels, dense 12-bit levels, full 16-bit
    levels (every lane of the SIMD code saturates), and levels in the first rows only (the rows
    the SIMD code skips when zero)."""
    blocks = np.zeros((4, count, 64), np.int64)
    blocks[0] = rng.integers(-256, 257, (count, 64)) * (rng.random((count, 64)) < 0.2)
    blocks[1] = rng.integers(-2048, 2048, (count, 64)) * (rng.random((count, 64)) < 0.6)
    blocks[2] = rng.integers(-32768, 32768, (count, 64))
    rows = rng.integers(1, 5, count)
    blocks[3] = rng.integers(-4096, 4096, (count, 64)) * (np.arange(64)[None] < 8 * rows[:, None])
    return blocks.reshape(-1, 8, 8).astype(np.int16)


@pytest.mark.parametrize("algo,xvid", [(0, False), (14, True)], ids=["simple", "xvid"])
def test_idct_equals_ffmpeg(algo, xvid):
    """The decoder's IDCTs against FFmpeg's on 3000 random blocks: the simple IDCT (FFmpeg's
    automatic choice) and the Xvid IDCT (``FF_IDCT_XVID``), each as its x86 SIMD code runs."""
    blocks = _random_blocks(np.random.default_rng(algo), 750)
    ffmpeg = _avdct(algo)
    ours = idct(blocks, xvid)
    wrong = [i for i, b in enumerate(blocks) if not np.array_equal(ours[i], ffmpeg(b))]
    assert not wrong, f"{len(wrong)} of {len(blocks)} blocks differ, first {blocks[wrong[0]].tolist()}"


ENCODER_NAMES = {
    "XviD build 67": b"XviD000000067",  # the Xvid IDCT alone
    "no name": b" " * 13,               # an XVID AVI without a name: Xvid build 0, the IDCT and the edge workaround
    "XviD build 12": b"XviD000000012",  # the last Xvid build with the edge workaround
    "XviD build 13": b"XviD000000013",  # the first without it
    "DivX 4": b"DivX400Build1",         # the edge workaround with the simple IDCT
}


@pytest.mark.parametrize("name", list(ENCODER_NAMES))
def test_encoder_names_equal_videocapture(tmp_path, name):
    """cv2.VideoWriter's XVID clip at 120x88 (neither side a multiple of 16, so edges at the
    picture's size differ from the macroblock grid's), its 13-byte user data ``Lavc62.28.101``
    rewritten in place: the port's frames equal cv2.VideoCapture's, and the decode the port made
    before it read encoder names -- the same stream with its Lavc name -- would not."""
    lavc = str(tmp_path / "lavc.avi")
    _write(lavc, "XVID", _motion_frames(120, 88, n=8, seed=4))
    data = open(lavc, "rb").read()
    assert data.count(b"Lavc62.28.101") == 1, "this OpenCV's FFmpeg names itself otherwise"
    renamed = str(tmp_path / "renamed.avi")
    open(renamed, "wb").write(data.replace(b"Lavc62.28.101", ENCODER_NAMES[name]))
    _assert_equal_to_capture(renamed)
    old = read_video_frames(lavc)
    assert any(not np.array_equal(a, b) for a, b in zip(old, _capture(renamed)))


def _dc_clip_stream(build):
    """One 16x16 I-VOP after user data ``XviD<build>``: luma block 0's DC level is 328 (x 8 =
    2624, past 2047) and block 1 predicts its DC from it, 150 lower. FFmpeg clips the stored
    predictor to 2047 (block 1 then 106) except for Xvid builds up to 32 (178)."""
    b = _SyntaxWriter(np.random.default_rng(0), 1, 1)
    b.put(32, 0x1B6)
    for n, value in ((2, 0), (1, 0), (1, 1), (4, 0), (1, 1), (1, 1), (3, 0), (5, 4)):  # I-VOP, DC VLC, quant 4
        b.put(n, value)
    b.code(_INTRA_MCBPC[0])
    b.put(1, 0)  # ac_pred_flag
    b.code(_CBPY[0])
    for difference in (200, -150):
        b.code(_DC_SIZE[True][8])
        b.put(8, difference if difference > 0 else difference + 255)
    for n in range(2, 6):
        b.code(_DC_SIZE[n < 4][0])
    return _vol(16, 16) + b"\x00\x00\x01\xb2" + f"XviD{build:09d}".encode() + b.stuffed()


def test_unclipped_dc_predictors_of_old_xvid_builds(tmp_path):
    frames = {}
    for build in (32, 33):
        path = str(tmp_path / f"xvid{build}.avi")
        _write_avi(path, [_dc_clip_stream(build)], 16, 16, fourcc=b"FMP4")
        frames[build] = _assert_equal_to_capture(path)[0]
    assert not np.array_equal(frames[32], frames[33])  # the workaround shows in the picture
