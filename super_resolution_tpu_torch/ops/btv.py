"""Bilateral total variation regularizer, vectorized over static offsets.

Reference semantics (``src/optimization/btv_regularizer.cpp``):

- Per-pixel residual over a down-right window with spatial decay ``a``:
  ``r(p) = sum_{0 <= i, j <= P} a^(i+j) |x(p) - x(p + (i, j))|`` where
  out-of-image offsets are skipped (:19-46). Note the residual loop bound is
  *inclusive* (``<= scale_range``).
- The gradient loops are *exclusive* (``< scale_range``, :114, :139) — a
  deliberate reproduction of the reference's asymmetry; with
  ``D_ij(p) = x(p) - x(p + (i,j))``, ``T_ij = a^(i+j) G sign(D_ij)``
  (``sign(0) = 0``), and ``G = 2 c r``:

      grad = sum_{i,j in [0, P)} T_ij                    (self term, :108-137)
           - sum_{i,j in [0, P)} shift_{i,j}(T_ij')      (window overlap, :138-165)

  where shift moves values down-right by (i, j) with zero fill, and ``T_ij'``
  zeroes the contribution sourced at the image-origin pixel (0, 0) —
  replicating the reference's ``offset_row == 0 && offset_col == 0`` skip.

P is small (1-3) in practice; the (P+1)^2 offsets are a Python loop.
"""

from __future__ import annotations

import torch

from super_resolution_tpu_torch.ops.warp import shift_zero_fill

__all__ = ["btv_residuals", "btv_cost_and_grad", "BilateralTotalVariationRegularizer"]


def _shifted_diff(x: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """D_ij(p) = x(p) - x(p + (i, j)); zero where the offset leaves the image."""
    d = torch.zeros_like(x)
    if i == 0 and j == 0:
        return d
    h, w = x.shape[-2], x.shape[-1]
    if i >= h or j >= w:
        return d
    d[..., : h - i, : w - j] = x[..., : h - i, : w - j] - x[..., i:, j:]
    return d


def btv_residuals(x: torch.Tensor, scale_range: int, spatial_decay: float) -> torch.Tensor:
    """Per-pixel BTV residuals of ``[C, H, W]`` (inclusive window bound)."""
    r = torch.zeros_like(x)
    for i in range(scale_range + 1):
        for j in range(scale_range + 1):
            r = r + (spatial_decay ** (i + j)) * _shifted_diff(x, i, j).abs()
    return r


def btv_cost_and_grad(
    x: torch.Tensor,
    constants: torch.Tensor,
    scale_range: int,
    spatial_decay: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """IRLS BTV term: cost ``sum(c r^2)`` and reference-parity gradient."""
    r = btv_residuals(x, scale_range, spatial_decay)
    cost = torch.sum(constants * r * r)
    g = 2.0 * constants * r
    grad = torch.zeros_like(x)
    # Gradient windows use the exclusive bound [0, scale_range).
    for i in range(scale_range):
        for j in range(scale_range):
            t = (spatial_decay ** (i + j)) * g * torch.sign(_shifted_diff(x, i, j))
            grad = grad + t
            # Overlap term: contributions sourced at image origin are skipped
            # (the reference's offset_row==0 && offset_col==0 quirk).
            t_masked = t.clone()
            t_masked[..., 0, 0] = 0.0
            grad = grad - shift_zero_fill(t_masked, i, j)
    return cost, grad


class BilateralTotalVariationRegularizer:
    """Object wrapper mirroring ``btv_regularizer.h:17-45``."""

    def __init__(self, scale_range: int, spatial_decay: float):
        if scale_range < 1:
            raise ValueError("Range must be at least 1 (1 pixel in each direction).")
        if not (0.0 < spatial_decay <= 1.0):
            raise ValueError("Spatial decay must be in (0, 1].")
        self.scale_range = scale_range
        self.spatial_decay = spatial_decay

    def residuals(self, x: torch.Tensor) -> torch.Tensor:
        return btv_residuals(x, self.scale_range, self.spatial_decay)

    def cost_and_grad(self, x: torch.Tensor, constants: torch.Tensor):
        return btv_cost_and_grad(x, constants, self.scale_range, self.spatial_decay)
