"""Anisotropic total variation regularizer (2D and 3D), vectorized.

Reference semantics (``src/optimization/tv_regularizer.cpp``):

- Per-pixel residual ``r = |x(r, c+1) - x(r, c)| + |x(r+1, c) - x(r, c)|``
  with forward differences and zeros past the image border (:21-106); 3D TV
  adds the spectral term ``|x(b+1) - x(b)|``, zero at the last band
  (:58-69, 90-106).
- The IRLS gradient of ``sum_i c_i r_i^2`` w.r.t. each pixel uses signum
  factors of the forward differences, accumulating the self / left / above
  (/ previous-band) contributions (:134-227). With ``G = 2 c r`` and
  ``s* = sign`` of each forward difference (``sign(0) = 0``):

      grad = -G (s_x + s_y [+ s_z])
             + shift_right(G s_x) + shift_down(G s_y) [+ shift_band(G s_z)]

  where shift_* moves values one step along the axis with zero fill.

``constants`` is the per-pixel ``lambda * irls_weight`` array, matching
``objective_irls_regularization_term.cpp:25-32``.

On a halo-extended tile of a larger image (``origin``, ``global_hw``; see
``parallel/halo.py``) the forward differences are cut at the border of the
IMAGE, in global coordinates, and ``x`` reads as zero beyond the tile's own
array: halo content inside the image is a neighbour like any other.

These functions are the plain version of the TV terms that the CUDA kernels
fuse into the objective (``ops/cuda/degrade.py``, modes ``data_term_tv`` and
``data_term_tv3d``); the IRLS reweighting calls :func:`tv_residuals` directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from super_resolution_tpu_torch.ops.warp import shift_zero_fill

__all__ = ["tv_residuals", "tv_cost_and_grad", "TotalVariationRegularizer", "residual_abs"]


class _ResidualAbs(torch.autograd.Function):
    """``|d|`` whose derivative at 0 is +1 (its right derivative)."""

    @staticmethod
    def forward(ctx, d):
        ctx.save_for_backward(d)
        return d.abs()

    @staticmethod
    def backward(ctx, grad):
        (d,) = ctx.saved_tensors
        return torch.where(d >= 0, grad, -grad)


def residual_abs(d: torch.Tensor) -> torch.Tensor:
    """``|d|`` of a residual's difference. The value is ``d.abs()``; only
    autograd sees a difference: the derivative at a kink (``d == 0``) is +1,
    as ``jnp.abs``'s is in the JAX package, where ``torch.abs``'s is 0. The
    ``autodiff`` gradient mode then takes the JAX package's gradient from a
    start with flat regions (a nearest-upsampled estimate has many)."""
    return _ResidualAbs.apply(d)


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


def _forward_diff_z(x: torch.Tensor) -> torch.Tensor:
    """x(b+1) - x(b) across the channel axis; zero at the last band."""
    d = torch.zeros_like(x)
    d[:-1] = x[1:] - x[:-1]
    return d


def _shift_band(v: torch.Tensor) -> torch.Tensor:
    """Values moved one band up the channel axis, zero into band 0."""
    out = torch.zeros_like(v)
    out[1:] = v[:-1]
    return out


def tv_residuals(x: torch.Tensor, use_3d: bool = False) -> torch.Tensor:
    """Per-pixel TV residuals of a ``[C, H, W]`` image."""
    r = residual_abs(_forward_diff_x(x)) + residual_abs(_forward_diff_y(x))
    if use_3d:
        r = r + residual_abs(_forward_diff_z(x))
    return r


def _tile_forward_diffs(x: torch.Tensor, origin, global_hw) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward differences of a tile whose element (0, 0) lies at ``origin`` of
    an image of extent ``global_hw``: zero past the image's border, with
    ``x`` zero beyond the tile."""
    h, w = x.shape[-2], x.shape[-1]
    u0, v0 = origin
    hg, wg = global_hw
    padded = F.pad(x, (0, 1, 0, 1))
    keep_x = (v0 + torch.arange(w, device=x.device) + 1 < wg).to(x.dtype)
    keep_y = (u0 + torch.arange(h, device=x.device) + 1 < hg).to(x.dtype)[:, None]
    return (padded[..., :h, 1:] - x) * keep_x, (padded[..., 1:, :w] - x) * keep_y


def tv_cost_and_grad(
    x: torch.Tensor, constants: torch.Tensor, use_3d: bool = False, origin=None, global_hw=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """IRLS TV term: cost ``sum(c r^2)`` and its reference-parity gradient.

    ``origin`` ``(u0, v0)`` and ``global_hw`` ``(H, W)``: ``x`` is a tile of a
    larger image (see the module docstring); both ``None`` for a whole image.
    """
    if origin is None and global_hw is None:
        dx = _forward_diff_x(x)
        dy = _forward_diff_y(x)
    else:
        dx, dy = _tile_forward_diffs(
            x, origin or (0, 0), global_hw or (x.shape[-2], x.shape[-1]))
    r = dx.abs() + dy.abs()
    if use_3d:
        dz = _forward_diff_z(x)
        r = r + dz.abs()
    cost = torch.sum(constants * r * r)
    g = 2.0 * constants * r
    sx = torch.sign(dx)
    sy = torch.sign(dy)
    # shift right / down by one pixel with zero fill
    grad = -g * (sx + sy) + shift_zero_fill(g * sx, 0, 1) + shift_zero_fill(g * sy, 1, 0)
    if use_3d:
        sz = torch.sign(dz)
        grad = grad - g * sz + _shift_band(g * sz)
    return cost, grad


class TotalVariationRegularizer:
    """Object wrapper mirroring the reference class API
    (``tv_regularizer.h:18-46``)."""

    def __init__(self, use_3d_total_variation: bool = False):
        self.use_3d = bool(use_3d_total_variation)

    def residuals(self, x: torch.Tensor) -> torch.Tensor:
        return tv_residuals(x, self.use_3d)

    def cost_and_grad(self, x: torch.Tensor, constants: torch.Tensor):
        return tv_cost_and_grad(x, constants, self.use_3d)
