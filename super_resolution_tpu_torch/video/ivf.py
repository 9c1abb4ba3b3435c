"""IVF files (.ivf), the raw container of libvpx's tools: the frames of its
one stream, as FFmpeg's IVF demuxer delivers them.

A 32-byte header -- the signature ``DKIF``, a version (0), the header's
size, the codec's four-character code, the width and height, the frame
rate's numerator and denominator, the frame count --, then each frame as a
12-byte header (its size, 4 bytes, and its timestamp, 8 bytes, little
endian) and its payload. The frames are read in file order up to the end of
the file; the header's frame count is not trusted (FFmpeg does not read it
either).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

__all__ = ["IvfVideo", "is_ivf", "read_ivf_video"]

_CODECS = {b"VP80": "VP8", b"VP90": "VP9", b"AV01": "AV1", b"VP10": "VP10"}


def is_ivf(head: bytes) -> bool:
    """Whether a file starting with ``head`` is IVF."""
    return head[:4] == b"DKIF"


def codec_name(fourcc: bytes) -> str:
    return _CODECS.get(fourcc, repr(fourcc.decode("latin-1")))


@dataclass
class IvfVideo:
    """The stream's four-character code, its header's width x height and its frames in file order."""

    fourcc: bytes
    width: int
    height: int
    frames: list[bytes]


def read_ivf_video(data: bytes) -> IvfVideo:
    """The stream of an IVF file held in ``data``."""
    if not is_ivf(data) or len(data) < 32:
        raise ValueError("Not an IVF file (no 32-byte DKIF header).")
    _, _, header_size, fourcc, width, height = struct.unpack("<4sHH4sHH", data[:16])
    pos = max(header_size, 32)
    frames = []
    while pos + 12 <= len(data):
        (size,) = struct.unpack("<I", data[pos:pos + 4])
        start = pos + 12
        if start + size > len(data):
            raise ValueError(f"IVF frame at byte {pos} of {size} bytes runs past the end of the file.")
        frames.append(data[start:start + size])
        pos = start + size
    return IvfVideo(fourcc, width, height, frames)
