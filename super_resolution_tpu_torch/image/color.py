"""BGR <-> YCrCb color conversion with OpenCV float-path parity.

The reference converts through cv::cvtColor in CV_32F mode
(``src/image/image_data.cpp:402-425``). OpenCV's float YCrCb uses delta = 0.5:

    Y  = 0.299 R + 0.587 G + 0.114 B
    Cr = (R - Y) * 0.713 + 0.5
    Cb = (B - Y) * 0.564 + 0.5

    R = Y + 1.403 (Cr - 0.5)
    G = Y - 0.714 (Cr - 0.5) - 0.344 (Cb - 0.5)
    B = Y + 1.773 (Cb - 0.5)

Channel order here is BGR (OpenCV default), matching the reference's
SPECTRAL_MODE_COLOR_BGR. Tensors are ``[3, H, W]``, on any device.
"""

from __future__ import annotations

import torch

__all__ = ["bgr_to_ycrcb", "ycrcb_to_bgr"]

_DELTA = 0.5


def bgr_to_ycrcb(x: torch.Tensor) -> torch.Tensor:
    """``[3, H, W]`` BGR -> ``[3, H, W]`` YCrCb (float convention, delta=0.5)."""
    b, g, r = x[0], x[1], x[2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cr = (r - y) * 0.713 + _DELTA
    cb = (b - y) * 0.564 + _DELTA
    return torch.stack([y, cr, cb])


def ycrcb_to_bgr(x: torch.Tensor) -> torch.Tensor:
    """``[3, H, W]`` YCrCb -> ``[3, H, W]`` BGR (float convention, delta=0.5)."""
    y, cr, cb = x[0], x[1], x[2]
    r = y + 1.403 * (cr - _DELTA)
    g = y - 0.714 * (cr - _DELTA) - 0.344 * (cb - _DELTA)
    b = y + 1.773 * (cb - _DELTA)
    return torch.stack([b, g, r])
