"""Single-level Haar wavelet transform (equivalent of
``src/wavelet/wavelet_transform.cpp``).

Per-2x2-block coefficients with 0.5 scaling (:63-115):

    ll = 0.5 (a + b + c + d)    lh = 0.5 (a - b + c - d)
    hl = 0.5 (a + b - c - d)    hh = 0.5 (a - b - c + d)

for a block ``[[a, b], [c, d]]``, with the exact inverse (:117-173).
Strided views and elementwise combines on the tensor's device, no per-pixel
loops; iDWT(DWT(x)) == x to float precision.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["WaveletCoefficients", "wavelet_transform", "inverse_wavelet_transform"]


class WaveletCoefficients(NamedTuple):
    """LL/LH/HL/HH subbands, each ``[..., H/2, W/2]``
    (``wavelet_transform.h:12-31``)."""

    ll: torch.Tensor
    lh: torch.Tensor
    hl: torch.Tensor
    hh: torch.Tensor

    def stitched(self) -> torch.Tensor:
        """2x2 visualization layout [[ll, lh], [hl, hh]]
        (``wavelet_transform.cpp:12-61``)."""
        top = torch.cat([self.ll, self.lh], dim=-1)
        bottom = torch.cat([self.hl, self.hh], dim=-1)
        return torch.cat([top, bottom], dim=-2)


def wavelet_transform(x: torch.Tensor) -> WaveletCoefficients:
    """Haar DWT of ``[..., H, W]`` (H, W even)."""
    h, w = x.shape[-2], x.shape[-1]
    if h % 2 or w % 2:
        raise ValueError(f"Wavelet transform needs even dimensions, got {(h, w)}")
    a = x[..., 0::2, 0::2]
    b = x[..., 0::2, 1::2]
    c = x[..., 1::2, 0::2]
    d = x[..., 1::2, 1::2]
    ll = 0.5 * (a + b + c + d)
    lh = 0.5 * (a - b + c - d)
    hl = 0.5 * (a + b - c - d)
    hh = 0.5 * (a - b - c + d)
    return WaveletCoefficients(ll, lh, hl, hh)


def inverse_wavelet_transform(coefficients: WaveletCoefficients) -> torch.Tensor:
    """Exact inverse Haar DWT -> ``[..., H, W]``."""
    ll, lh, hl, hh = coefficients
    a = 0.5 * (ll + lh + hl + hh)
    b = 0.5 * (ll - lh + hl - hh)
    c = 0.5 * (ll + lh - hl - hh)
    d = 0.5 * (ll - lh - hl + hh)
    h2, w2 = ll.shape[-2], ll.shape[-1]
    out = ll.new_empty(*ll.shape[:-2], 2 * h2, 2 * w2)
    out[..., 0::2, 0::2] = a
    out[..., 0::2, 1::2] = b
    out[..., 1::2, 0::2] = c
    out[..., 1::2, 1::2] = d
    return out
