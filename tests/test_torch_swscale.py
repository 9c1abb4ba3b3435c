"""The YUV -> BGR24 conversion the port's video decoders share
(``native/swscale_bgr.h``), held against swscale itself: the
``libswscale`` bundled with the cv2 wheel, called through ctypes as
``cv2.VideoCapture`` calls it (``SWS_BICUBIC``, BGR24, the same size, the
frame's chroma siting), on seeded random planes.

Every subsampling FFmpeg's decoders give 8-bit frames in (4:2:0, 4:2:2,
4:4:4, 4:1:0, 4:1:1, 4:4:0, and YUVA 4:2:0 / 4:2:2 / 4:4:4), at odd and even
widths and heights down to one pixel, with centred chroma (VP8, VP9, FFV1)
and chroma sited left (MPEG-4 Part 2), is array-equal: the unscaled
converter swscale takes for 4:2:0 and 4:2:2 at an even height, the bicubic
scaler with its MMXEXT and C writers otherwise. Planes of only 0 and 255 push
the bicubic filters' overshoot to the intermediates' limits. The odd-height
clips of ``tests/data_torch/odd_height`` decode to cv2.VideoCapture's frames.
"""

import hashlib
import json
import os
import pathlib
import sys

import numpy as np
import pytest

from super_resolution_tpu_torch.native import get_ffv1_library
from super_resolution_tpu_torch.video.video_loader import read_video_frames

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_libav import PIX_FMTS, capture, sws_bgr  # noqa: E402

ODD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "data_torch", "odd_height")

FORMATS = ["yuv420p", "yuv422p", "yuv444p", "yuv410p", "yuv411p", "yuv440p", "yuva420p", "yuva422p", "yuva444p"]
SIZES = [(1, 1), (2, 1), (1, 2), (2, 2), (3, 3), (5, 2), (2, 7), (8, 9), (9, 8), (17, 15), (64, 37), (63, 36)]
CENTRED, LEFT = (-513, -513), (0, 128)


def _ours(pix_fmt, planes, w, h, chroma_pos):
    _, sx, sy, _ = PIX_FMTS[pix_fmt]
    out = np.empty((h, w, 3), np.uint8)
    get_ffv1_library().sr_yuv_to_bgr(planes[0].ctypes.data, planes[1].ctypes.data, planes[2].ctypes.data,
                                     planes[0].shape[1], planes[1].shape[1], w, h, sx, sy, int(len(planes) == 4),
                                     *chroma_pos, out.ctypes.data)
    return out


def _planes(pix_fmt, w, h, rng, extreme=False):
    count, sx, sy, _ = PIX_FMTS[pix_fmt]
    shapes = [(h, w) if k in (0, 3) else (-(-h >> sy), -(-w >> sx)) for k in range(count)]
    planes = [rng.integers(0, 256, shape, dtype=np.uint8) for shape in shapes]
    return [np.where(p > 127, 255, 0).astype(np.uint8) for p in planes] if extreme else planes


@pytest.mark.parametrize("siting", ["centred", "left"])
@pytest.mark.parametrize("pix_fmt", FORMATS)
def test_equals_swscale(pix_fmt, siting):
    """Every size of SIZES, random and extreme planes: array-equal to sws_scale."""
    chroma_pos = CENTRED if siting == "centred" else LEFT
    rng = np.random.default_rng(FORMATS.index(pix_fmt))
    gaps = {}
    for w, h in SIZES:
        for extreme in (False, True):
            planes = _planes(pix_fmt, w, h, rng, extreme)
            gap = np.abs(_ours(pix_fmt, planes, w, h, chroma_pos).astype(int)
                         - sws_bgr(pix_fmt, planes, w, h, chroma_pos)).max()
            if gap:
                gaps[(w, h, extreme)] = int(gap)
    assert not gaps, gaps


@pytest.mark.parametrize("size", [(960, 541), (961, 540), (130, 71)])
def test_full_width_frames_equal_swscale(size):
    """Frames at the video phase's width, odd and even, 4:2:0 centred and left: array-equal to sws_scale."""
    w, h = size
    rng = np.random.default_rng(w + h)
    for chroma_pos in (CENTRED, LEFT):
        planes = _planes("yuv420p", w, h, rng)
        assert np.array_equal(_ours("yuv420p", planes, w, h, chroma_pos), sws_bgr("yuv420p", planes, w, h, chroma_pos))


@pytest.mark.parametrize("name", sorted(json.load(open(os.path.join(ODD, "manifest.json")))))
def test_odd_height_fixtures(name):
    """The checked-in odd-height VP9, VP8 and MPEG-4 Part 2 clips (the card's host decodes them to the
    recorded digest of cv2.VideoCapture's frames): the file recorded, and the port's frames cv2's."""
    entry, path = json.loads(pathlib.Path(ODD, "manifest.json").read_text())[name], os.path.join(ODD, name)
    assert hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest() == entry["sha256"]
    ours = np.stack(read_video_frames(path))
    assert list(ours.shape) == entry["shape"] and entry["shape"][1] % 2 == 1
    assert hashlib.sha256(ours.tobytes()).hexdigest() == entry["frames_sha256"]
    assert np.array_equal(ours, np.stack(capture(path)))
