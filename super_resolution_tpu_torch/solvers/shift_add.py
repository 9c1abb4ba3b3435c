"""Shift-add fusion baseline (equivalent of ``src/shift_add_fusion.cpp``).

Places each LR pixel of frame k at HR position ``(s*y - dy_k, s*x - dx_k)``
(:58-77), masks unfilled HR pixels, and inpaints the holes (:84-90, where the
reference uses cv::inpaint Navier-Stokes).

"Place pixel (y, x) at (s*y - dy, s*x - dx)" is exactly
``translate(zero_upsample(frame, s), -dx, -dy)`` with integer shifts — no
scatter. Later frames overwrite earlier ones at collisions (matching the
reference's sequential ``at<uchar>() =`` writes). Hole filling is an
iterative known-neighbor diffusion (a masked 3x3 box filter repeated until
the grid is covered), as in the JAX package; everything runs on the frames'
device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from super_resolution_tpu_torch.ops.blur import correlate2d
from super_resolution_tpu_torch.ops.resize import zero_upsample
from super_resolution_tpu_torch.ops.warp import translate_static

__all__ = ["shift_add_fusion", "fill_holes"]

_BOX = np.ones((3, 3))


def fill_holes(image: torch.Tensor, known_mask: torch.Tensor, num_iterations: int | None = None) -> torch.Tensor:
    """Fill ``image`` where ``known_mask == 0`` by repeated known-neighbor
    averaging (3x3). Sweeps stop as soon as every pixel is covered: one small
    read-back per sweep decides it, and a sweep past coverage would change
    nothing, so the result equals the JAX package's while-loop.
    ``num_iterations`` caps the sweep count; the default cap covers any hole
    in the image."""
    cap = max(image.shape[-2], image.shape[-1]) if num_iterations is None else num_iterations
    img = image
    mask = known_mask.to(image.dtype)
    sweeps = 0
    while sweeps < cap and not bool(torch.all(mask > 0)):
        num = correlate2d(img * mask, _BOX)
        den = correlate2d(mask, _BOX)
        grown = den > 0
        fill = num / torch.clamp(den, min=1.0)
        img = torch.where(mask > 0, img, torch.where(grown, fill, img))
        mask = torch.maximum(mask, grown.to(image.dtype))
        sweeps += 1
    return img


def shift_add_fusion(frames, shifts, scale: int, inpaint: bool = True) -> torch.Tensor:
    """Fuse LR ``frames`` into an HR image.

    ``frames``: ``[K, H, W]`` or ``[K, C, H, W]`` tensor (or a list of
    frames); ``shifts``: ``[K, 2]`` (dx, dy) — integer-valued; fractional
    parts are truncated like the reference's implicit double->int conversion
    (``shift_add_fusion.cpp:66-67``).
    """
    stack = torch.stack(list(frames)) if isinstance(frames, (list, tuple)) else frames
    if isinstance(shifts, torch.Tensor):
        shifts = shifts.detach().cpu().numpy()
    shifts_arr = [(float(s[0]), float(s[1])) for s in np.asarray(shifts)]
    if stack.shape[0] != len(shifts_arr):
        raise ValueError("The number of motion estimates must match the number of frames.")

    out = None
    known = None
    for k in range(stack.shape[0]):
        dx, dy = shifts_arr[k]
        dx_i, dy_i = float(math.trunc(dx)), float(math.trunc(dy))
        placed = translate_static(zero_upsample(stack[k], scale), -dx_i, -dy_i)
        mask = translate_static(zero_upsample(torch.ones_like(stack[k]), scale), -dx_i, -dy_i)
        if out is None:
            out = placed
            known = mask
        else:
            # Sequential overwrite: frame k wins at collisions.
            out = torch.where(mask > 0.5, placed, out)
            known = torch.maximum(known, mask)
    if inpaint:
        out = fill_holes(out, known > 0.5)
    return out
