"""Translational warp with cv::warpAffine parity and a warp-based adjoint.

The reference's MotionModule (``src/image_model/motion_module.cpp``) warps each
channel with ``cv::warpAffine`` and kernel ``[1 0 dx; 0 1 dy]``: the output is
``dst(r, c) = src(r - dy, c - dx)`` with bilinear sampling and zero
(BORDER_CONSTANT) outside the image — content moves *down-right* for positive
shifts. Its "transpose" warps by ``(-dx, -dy)`` (``motion_module.cpp:40-51``),
which is the exact adjoint for integer shifts and the reference's accepted
approximation for fractional ones.

The warp is a weighted sum of at most four integer-shifted copies (no
``grid_sample``), so float64 results are comparable term by term with the
JAX package's. Two forms: :func:`translate_static` for shifts the host knows
(pad and crop), and :func:`translate` for shifts that are tensors on the
device (rows and columns gathered by index there, weights as tensors), with
:func:`translate_with_shift_derivatives` giving the closed-form derivatives
in the shift that motion refinement needs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "shift_zero_fill",
    "translate",
    "translate_static",
    "translate_adjoint",
    "translate_with_shift_derivatives",
]


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


def _shift_taps(x: torch.Tensor, dx, dy):
    """The four integer-shifted copies of a warp whose shift is a tensor.

    ``dx``/``dy``: 0-d tensors, or ``[B]`` tensors matching the leading axis
    of ``x`` (one shift per batch entry). Returns ``(taps, fy, fx)`` with
    ``taps[a][b](r, c) = x(r - iy - a, c - ix - b)`` (zero outside) and the
    fractional parts shaped to broadcast against ``x``. The integer parts
    stay on the device: rows and columns are gathered by index, so nothing
    is read back to the host.
    """
    h, w = x.shape[-2], x.shape[-1]
    dx = torch.as_tensor(dx, device=x.device).to(x.dtype)
    dy = torch.as_tensor(dy, device=x.device).to(x.dtype)
    if dx.shape != dy.shape or dx.ndim > 1 or (dx.ndim == 1 and dx.shape[0] != x.shape[0]):
        raise ValueError(
            f"Shifts of shape {tuple(dx.shape)}, {tuple(dy.shape)} do not fit x {tuple(x.shape)}."
        )
    # One shift per entry of the leading axis, or one for all of x.
    view = (-1,) + (1,) * (x.ndim - 1) if dx.ndim == 1 else ()
    fly, flx = torch.floor(dy), torch.floor(dx)
    fy, fx = (dy - fly).reshape(view), (dx - flx).reshape(view)
    iy, ix = fly.to(torch.int64).reshape(view), flx.to(torch.int64).reshape(view)

    def gather(src, index, size, dim):
        valid = (index >= 0) & (index < size)
        index = index.clamp(0, size - 1).expand(src.shape)
        return torch.take_along_dim(src, index, dim) * valid.to(src.dtype)

    rows = torch.arange(h, device=x.device).reshape(h, 1)
    cols = torch.arange(w, device=x.device).reshape(1, w)
    taps = []
    for a in (0, 1):
        shifted_rows = gather(x, rows - iy - a, h, -2)
        taps.append([gather(shifted_rows, cols - ix - b, w, -1) for b in (0, 1)])
    return taps, fy, fx


def _bilinear(taps, fy, fx) -> torch.Tensor:
    wy, wx = (1.0 - fy, fy), (1.0 - fx, fx)
    out = torch.zeros_like(taps[0][0])
    for a in (0, 1):
        for b in (0, 1):
            out = out + (wy[a] * wx[b]) * taps[a][b]
    return out


def translate(x: torch.Tensor, dx, dy) -> torch.Tensor:
    """Warp ``[..., H, W]`` so that ``out(r, c) = x(r - dy, c - dx)``.

    Python-number shifts go to :func:`translate_static`. Tensor shifts (0-d,
    or ``[B]`` with ``x`` ``[B, ..., H, W]``) stay on their device: the
    integer parts index rows and columns there and the fractional parts are
    tensor weights, so a warp inside a loop never waits for the host. The
    bilinear weights are computed in ``x.dtype``, as the JAX package's traced
    ``translate`` does. Its ``max_shift`` argument sized a static pad and has
    no counterpart here: any shift is taken, and one beyond the image gives
    zeros.
    """
    if not isinstance(dx, torch.Tensor) and not isinstance(dy, torch.Tensor):
        return translate_static(x, dx, dy)
    return _bilinear(*_shift_taps(x, dx, dy))


def translate_with_shift_derivatives(x: torch.Tensor, dx, dy):
    """``(translate(x, dx, dy), d/d dx, d/d dy)`` for tensor shifts, in closed form.

    The bilinear warp is piecewise linear in the shift. With
    ``S(a, b)(r, c) = x(r - iy - a, c - ix - b)``:

        d out / d dx = (1 - fy) [S(0,1) - S(0,0)] + fy [S(1,1) - S(1,0)]
        d out / d dy = (1 - fx) [S(1,0) - S(0,0)] + fx [S(1,1) - S(0,1)]

    which is what forward-mode differentiation through ``floor`` gives (the
    derivative of ``floor`` is 0): at an exactly integer shift it is the
    one-sided difference towards the next tap, ``ix + 1``.
    """
    taps, fy, fx = _shift_taps(x, dx, dy)
    out = _bilinear(taps, fy, fx)
    wy, wx = (1.0 - fy, fy), (1.0 - fx, fx)
    d_dx = wy[0] * (taps[0][1] - taps[0][0]) + wy[1] * (taps[1][1] - taps[1][0])
    d_dy = wx[0] * (taps[1][0] - taps[0][0]) + wx[1] * (taps[1][1] - taps[0][1])
    return out, d_dx, d_dy


def translate_adjoint(x: torch.Tensor, dx, dy) -> torch.Tensor:
    """The reference's motion transpose: warp by ``(-dx, -dy)``.

    Exact adjoint of :func:`translate` for integer shifts; the reference's
    deliberate approximation for fractional shifts (``motion_module.cpp:40-51``).
    It is NOT the true transpose of the bilinear warp.
    """
    return translate(x, -dx, -dy)
