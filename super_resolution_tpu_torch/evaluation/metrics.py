"""Quality metrics with reference parity (``src/evaluation/``).

PSNR over all channels jointly, MAX = 1.0
(``peak_signal_to_noise_ratio.cpp:29-53``): ``-10 log10(MSE)``; +inf for
identical images. SSIM and the evaluator classes are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["psnr"]


def _as_chw(arr) -> torch.Tensor:
    if not isinstance(arr, torch.Tensor):
        arr = torch.tensor(np.asarray(arr))  # a copy: the input may be read-only
    if arr.ndim == 2:
        arr = arr[None]
    return arr


def psnr(image, ground_truth) -> torch.Tensor:
    """PSNR = -10 log10(MSE) with MAX=1.0; inf when identical.

    Takes tensors or numpy arrays; the result lives where ``image`` does.
    """
    a = _as_chw(image)
    b = _as_chw(ground_truth).to(device=a.device, dtype=a.dtype)
    mse = torch.mean((a - b) ** 2)
    return -10.0 * torch.log10(mse)
