"""GIF reading with what ``cv2.imread(path, IMREAD_UNCHANGED)`` returns.

OpenCV (5.x, its own GIF codec) returns the first frame composed on the
logical screen: the screen starts as the global colour table's background
colour (black without a global table) with alpha 0, the frame's pixels take
their colour from the frame's local table or the global one, with alpha 255,
and the pixels of the transparent index (a Graphic Control Extension's)
keep the screen beneath them. The result is BGRA when the frame's Graphic
Control Extension sets a transparent index, else BGR, uint8.

Covered: GIF87a and GIF89a, global and local colour tables, interlaced
frames, a frame smaller than the screen, transparency. The LZW decoding is
C++ (``native/lzw.cpp``, built at first use by
:mod:`super_resolution_tpu_torch.native`; no compiler: ``RuntimeError``).
Corrupt data raises ``ValueError``. Writing GIF is not supported: OpenCV
quantises to 256 colours with a quantiser of its own, and another quantiser
would write other pixels.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["read_gif"]


def _sub_blocks(data: bytes, pos: int):
    """The joined sub-blocks starting at ``pos``, and the position after their terminator."""
    parts = []
    while True:
        if pos >= len(data):
            raise ValueError("GIF data ends inside a block.")
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(parts), pos
        parts.append(data[pos:pos + n])
        pos += n


def _interlaced_rows(h: int) -> np.ndarray:
    """The image row of each stored row of an interlaced frame (four passes)."""
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4), np.arange(1, h, 2)])


def read_gif(data: bytes) -> np.ndarray:
    """Decode a GIF file's first frame to what ``cv2.imread(..., IMREAD_UNCHANGED)`` returns."""
    from super_resolution_tpu_torch import native

    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError("Not a GIF file (no GIF87a / GIF89a signature).")
    sw, sh, flags, background = struct.unpack("<HHBB", data[6:12])
    pos = 13
    palette = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        palette = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3) if pos + 3 * n <= len(data) else None
        if palette is None:
            raise ValueError("GIF global colour table is truncated.")
        pos += 3 * n
        if background >= n:
            raise ValueError(f"GIF background index {background} past its {n}-colour table.")
    transparent = None
    while True:
        if pos >= len(data):
            raise ValueError("GIF without an image.")
        kind = data[pos]
        pos += 1
        if kind == 0x3B:
            raise ValueError("GIF without an image.")
        if kind == 0x21:  # extension
            if pos >= len(data):
                raise ValueError("GIF data ends inside an extension.")
            label = data[pos]
            body, pos = _sub_blocks(data, pos + 1)
            if label == 0xF9 and len(body) >= 4:
                transparent = body[3] if body[0] & 1 else None
            continue
        if kind != 0x2C:
            raise ValueError(f"Unknown GIF block 0x{kind:02x}.")
        if pos + 9 > len(data):
            raise ValueError("GIF image descriptor is truncated.")
        left, top, w, h, lflags = struct.unpack("<HHHHB", data[pos:pos + 9])
        pos += 9
        colours = palette
        if lflags & 0x80:
            n = 2 << (lflags & 7)
            if pos + 3 * n > len(data):
                raise ValueError("GIF local colour table is truncated.")
            colours = np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3)
            pos += 3 * n
        if colours is None:
            raise ValueError("GIF frame without a colour table.")
        if pos >= len(data):
            raise ValueError("GIF image data is missing.")
        min_code_size = data[pos]
        lzw, pos = _sub_blocks(data, pos + 1)
        break
    if left + w > sw or top + h > sh:
        raise ValueError(f"GIF frame {w}x{h} at ({left}, {top}) outside its {sw}x{sh} screen.")
    indices = np.empty(w * h, np.uint8)
    n = native.get_lzw_library().sr_gif_lzw_decode(lzw, len(lzw), min_code_size, indices.ctypes.data, indices.size)
    if n != indices.size:
        raise ValueError(f"Corrupt GIF image data ({n} of {indices.size} pixels decoded).")
    frame = indices.reshape(h, w)
    if lflags & 0x40:
        unlaced = np.empty_like(frame)
        unlaced[_interlaced_rows(h)] = frame
        frame = unlaced
    if int(frame.max(initial=0)) >= len(colours):
        raise ValueError("GIF colour index past its colour table.")
    channels = 4 if transparent is not None else 3
    screen = np.zeros((sh, sw, channels), np.uint8)
    if palette is not None:
        screen[..., :3] = palette[background][::-1]
    region = screen[top:top + h, left:left + w]
    opaque = frame != transparent if transparent is not None else np.ones(frame.shape, bool)
    region[..., :3][opaque] = colours[frame[opaque]][:, ::-1]
    if channels == 4:
        region[..., 3][opaque] = 255
    return screen
