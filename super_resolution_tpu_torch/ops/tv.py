"""Anisotropic total variation regularizer (2D), vectorized.

Reference semantics (``src/optimization/tv_regularizer.cpp``):

- Per-pixel residual ``r = |x(r, c+1) - x(r, c)| + |x(r+1, c) - x(r, c)|``
  with forward differences and zeros past the image border (:21-106).
- The IRLS gradient of ``sum_i c_i r_i^2`` w.r.t. each pixel uses signum
  factors of the forward differences, accumulating the self / left / above
  contributions (:134-227). With ``G = 2 c r`` and ``s* = sign`` of each
  forward difference (``sign(0) = 0``):

      grad = -G (s_x + s_y) + shift_right(G s_x) + shift_down(G s_y)

  where shift_* moves values one step along the axis with zero fill.

``constants`` is the per-pixel ``lambda * irls_weight`` array, matching
``objective_irls_regularization_term.cpp:25-32``. The 3D (spectral) variant
is not ported yet.
"""

from __future__ import annotations

import torch

from super_resolution_tpu_torch.ops.warp import shift_zero_fill

__all__ = ["tv_residuals", "tv_cost_and_grad", "TotalVariationRegularizer"]

_NO_3D = "3D (spectral) total variation is not ported yet."


def _forward_diff_x(x: torch.Tensor) -> torch.Tensor:
    """x(r, c+1) - x(r, c); zero at the last column."""
    d = torch.zeros_like(x)
    d[..., :, :-1] = x[..., :, 1:] - x[..., :, :-1]
    return d


def _forward_diff_y(x: torch.Tensor) -> torch.Tensor:
    """x(r+1, c) - x(r, c); zero at the last row."""
    d = torch.zeros_like(x)
    d[..., :-1, :] = x[..., 1:, :] - x[..., :-1, :]
    return d


def tv_residuals(x: torch.Tensor, use_3d: bool = False) -> torch.Tensor:
    """Per-pixel TV residuals of a ``[C, H, W]`` image."""
    if use_3d:
        raise NotImplementedError(_NO_3D)
    return _forward_diff_x(x).abs() + _forward_diff_y(x).abs()


def tv_cost_and_grad(
    x: torch.Tensor, constants: torch.Tensor, use_3d: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """IRLS TV term: cost ``sum(c r^2)`` and its reference-parity gradient."""
    if use_3d:
        raise NotImplementedError(_NO_3D)
    dx = _forward_diff_x(x)
    dy = _forward_diff_y(x)
    r = dx.abs() + dy.abs()
    cost = torch.sum(constants * r * r)
    g = 2.0 * constants * r
    sx = torch.sign(dx)
    sy = torch.sign(dy)
    # shift right / down by one pixel with zero fill
    grad = -g * (sx + sy) + shift_zero_fill(g * sx, 0, 1) + shift_zero_fill(g * sy, 1, 0)
    return cost, grad


class TotalVariationRegularizer:
    """Object wrapper mirroring the reference class API
    (``tv_regularizer.h:18-46``)."""

    def __init__(self, use_3d_total_variation: bool = False):
        if use_3d_total_variation:
            raise NotImplementedError(_NO_3D)
        self.use_3d = False

    def residuals(self, x: torch.Tensor) -> torch.Tensor:
        return tv_residuals(x)

    def cost_and_grad(self, x: torch.Tensor, constants: torch.Tensor):
        return tv_cost_and_grad(x, constants)
