"""Gaussian PSF blur with cv::filter2D parity (correlation, zero border).

Mirrors the reference BlurModule (``src/image_model/blur_module.cpp``):
the kernel is ``getGaussianKernel(size, sigma)`` outer-producted with itself
(``blur_module.cpp:20-22``), applied as *correlation* (cv::filter2D does not
flip the kernel) with BORDER_CONSTANT zero padding
(``src/util/matrix_util.h:18-22``). The "transpose" applies the transposed
kernel (``blur_module.cpp:30-36``) — identical for the symmetric Gaussian.

The correlation is a sum of shifted copies, one per kernel tap, in the
tensor's own dtype. It does not go through ``conv2d``, so on a CUDA device
no TF32 rounding can enter a float32 blur.
"""

from __future__ import annotations

import numpy as np
import torch

from super_resolution_tpu_torch.ops.warp import shift_zero_fill

__all__ = ["gaussian_kernel_1d", "gaussian_kernel_2d", "correlate2d", "blur", "blur_adjoint"]


def gaussian_kernel_1d(size: int, sigma: float, dtype=np.float64) -> np.ndarray:
    """cv::getGaussianKernel parity: normalized ``exp(-(i - (size-1)/2)^2 / (2 sigma^2))``."""
    if size < 1 or size % 2 != 1:
        raise ValueError("Blur kernel size must be a positive odd number.")
    if sigma <= 0:
        # OpenCV's automatic sigma for ksize (not used by the reference, which
        # CHECKs sigma > 0, but kept for API completeness).
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    i = np.arange(size, dtype=np.float64)
    center = (size - 1) / 2.0
    k = np.exp(-((i - center) ** 2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(dtype)


def gaussian_kernel_2d(size: int, sigma: float, dtype=np.float64) -> np.ndarray:
    k = gaussian_kernel_1d(size, sigma, dtype=np.float64)
    return np.outer(k, k).astype(dtype)


def _kernel_taps(kernel) -> np.ndarray:
    if isinstance(kernel, torch.Tensor):
        kernel = kernel.detach().cpu().numpy()
    k = np.asarray(kernel, dtype=np.float64)
    if k.ndim != 2:
        raise ValueError(f"Blur kernel must be 2D, got shape {k.shape}.")
    return k


def correlate2d(x: torch.Tensor, kernel) -> torch.Tensor:
    """'SAME' zero-padded correlation of ``[..., H, W]`` with a 2D kernel.

    ``out(r, c) = sum_ij k[i, j] x(r + i - kh//2, c + j - kw//2)``: cv::filter2D
    with a center anchor and BORDER_CONSTANT. For even-sized kernels OpenCV
    anchors at ``(k//2, k//2)``, i.e. asymmetric padding
    ``(k//2, k - 1 - k//2)`` on each axis. ``kernel`` is a numpy array or a
    tensor; its taps are host constants.
    """
    k = _kernel_taps(kernel)
    kh, kw = k.shape
    out = None
    for i in range(kh):
        for j in range(kw):
            tap = float(k[i, j])
            if tap == 0.0:
                continue
            term = shift_zero_fill(x, kh // 2 - i, kw // 2 - j) * tap
            out = term if out is None else out + term
    return torch.zeros_like(x) if out is None else out


def blur(x: torch.Tensor, kernel) -> torch.Tensor:
    """Forward PSF blur B (correlation with the kernel, zero border)."""
    return correlate2d(x, kernel)


def blur_adjoint(x: torch.Tensor, kernel) -> torch.Tensor:
    """Reference blur transpose: correlation with ``kernel.T`` (``blur_module.cpp:30-36``).

    For the symmetric separable Gaussian this equals the forward blur; it is
    the exact adjoint only for 180-degree-symmetric kernels (the true adjoint
    of zero-padded correlation flips the kernel in both axes).
    """
    return correlate2d(x, _kernel_taps(kernel).T)
