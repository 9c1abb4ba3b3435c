"""Decimation and its adjoint (the other resizers are not ported yet)."""

from __future__ import annotations

import torch

__all__ = ["decimate", "zero_upsample"]


def decimate(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Top-left decimation: ``out[r, c] = x[r*scale, c*scale]``.

    The forward downsampling operator D (``downsampling_module.cpp:19-27`` via
    INTER_NEAREST; selection-matrix form at :41-64). It aliases on purpose.
    """
    if scale == 1:
        return x
    return x[..., ::scale, ::scale]


def zero_upsample(
    x: torch.Tensor, scale: int, out_hw: tuple[int, int] | None = None
) -> torch.Tensor:
    """Zero-padding upsample: ``out[r*scale, c*scale] = x[r, c]``, zeros elsewhere.

    The exact adjoint D^T of :func:`decimate` and the reference's
    INTERPOLATE_ADDITIVE upsample (``image_data.cpp:99-115``).
    """
    if scale == 1:
        return x
    h_in, w_in = x.shape[-2], x.shape[-1]
    if out_hw is None:
        out_hw = (h_in * scale, w_in * scale)
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    if h_out < (h_in - 1) * scale + 1 or w_out < (w_in - 1) * scale + 1:
        raise ValueError(f"out_hw {out_hw} is too small for input {(h_in, w_in)} at scale {scale}.")
    out = x.new_zeros(*x.shape[:-2], h_out, w_out)
    out[..., : (h_in - 1) * scale + 1 : scale, : (w_in - 1) * scale + 1 : scale] = x
    return out
