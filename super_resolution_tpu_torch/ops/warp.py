"""Translational warp with cv::warpAffine parity and a warp-based adjoint.

The reference's MotionModule (``src/image_model/motion_module.cpp``) warps each
channel with ``cv::warpAffine`` and kernel ``[1 0 dx; 0 1 dy]``: the output is
``dst(r, c) = src(r - dy, c - dx)`` with bilinear sampling and zero
(BORDER_CONSTANT) outside the image — content moves *down-right* for positive
shifts. Its "transpose" warps by ``(-dx, -dy)`` (``motion_module.cpp:40-51``),
which is the exact adjoint for integer shifts and the reference's accepted
approximation for fractional ones.

The warp is a weighted sum of at most four integer-shifted copies (pad and
crop, no gather and no ``grid_sample``), so float64 results are comparable
term by term with the JAX package's ``translate_static``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["shift_zero_fill", "translate", "translate_static", "translate_adjoint"]


def shift_zero_fill(x: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """``out(r, c) = x(r - m, c - n)`` over ``[..., H, W]``, zero outside."""
    if m == 0 and n == 0:
        return x
    h, w = x.shape[-2], x.shape[-1]
    if abs(m) >= h or abs(n) >= w:
        return torch.zeros_like(x)
    # Constant-mode pad takes negative widths as a crop: pad the leading
    # side by the shift and crop the trailing side by the same amount.
    return F.pad(x, (n, -n, m, -m))


def translate_static(x: torch.Tensor, dx: float, dy: float) -> torch.Tensor:
    """Warp ``[..., H, W]`` so that ``out(r, c) = x(r - dy, c - dx)``.

    Bilinear, zero border. ``iy = floor(dy)``, ``fy = dy - iy``: the value at
    row ``r - dy`` is ``(1 - fy) x(r - iy) + fy x(r - iy - 1)``. Taps whose
    weight is exactly zero are dropped (an integer shift is one shifted copy).
    """
    dx, dy = float(dx), float(dy)
    iy, ix = math.floor(dy), math.floor(dx)
    fy, fx = dy - iy, dx - ix
    out = None
    for a, wy in ((0, 1.0 - fy), (1, fy)):
        for b, wx in ((0, 1.0 - fx), (1, fx)):
            weight = wy * wx
            if weight == 0.0:
                continue
            term = shift_zero_fill(x, iy + a, ix + b) * weight
            out = term if out is None else out + term
    return out


def translate(x: torch.Tensor, dx, dy) -> torch.Tensor:
    """:func:`translate_static` for shifts given as floats or 0-d tensors.

    A tensor shift is read back to the host (one synchronisation when it
    lives on a CUDA device). The JAX package's ``max_shift`` argument sized a
    static pad for traced shifts and has no counterpart here.
    """
    return translate_static(x, float(dx), float(dy))


def translate_adjoint(x: torch.Tensor, dx, dy) -> torch.Tensor:
    """The reference's motion transpose: warp by ``(-dx, -dy)``.

    Exact adjoint of :func:`translate` for integer shifts; the reference's
    deliberate approximation for fractional shifts (``motion_module.cpp:40-51``).
    It is NOT the true transpose of the bilinear warp.
    """
    return translate_static(x, -float(dx), -float(dy))
