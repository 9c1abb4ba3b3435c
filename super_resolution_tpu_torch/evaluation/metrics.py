"""Quality metrics with reference parity (``src/evaluation/``).

- PSNR over all channels jointly, MAX = 1.0
  (``peak_signal_to_noise_ratio.cpp:29-53``): ``-10 log10(MSE)``; +inf for
  identical images.
- SSIM computed *globally* (not 8x8-windowed) with mean/variance/covariance
  pooled over all channels and pixels and k1=0.01, k2=0.03, L=1.0
  (``structural_similarity.cpp``; the global formulation is an acknowledged
  simplification, TODO at ``structural_similarity.h:41-42``).

Both take tensors or numpy arrays and return a 0-d tensor where ``image``
lives. The evaluator classes mirror the reference's ``GroundTruthEvaluator``
API, bilinearly resizing mismatched inputs like the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from super_resolution_tpu_torch.ops.resize import linear_resize

__all__ = [
    "psnr",
    "ssim",
    "GroundTruthEvaluator",
    "PeakSignalToNoiseRatioEvaluator",
    "StructuralSimilarityEvaluator",
]


def _as_chw(arr) -> torch.Tensor:
    arr = getattr(arr, "array", arr)  # an ImageData's visible channels
    if not isinstance(arr, torch.Tensor):
        arr = torch.tensor(np.asarray(arr))  # a copy: the input may be read-only
    if arr.ndim == 2:
        arr = arr[None]
    return arr


def _pair(image, ground_truth) -> tuple[torch.Tensor, torch.Tensor]:
    a = _as_chw(image)
    return a, _as_chw(ground_truth).to(device=a.device, dtype=a.dtype)


def psnr(image, ground_truth) -> torch.Tensor:
    """PSNR = -10 log10(MSE) with MAX=1.0; inf when identical."""
    a, b = _pair(image, ground_truth)
    mse = torch.mean((a - b) ** 2)
    return -10.0 * torch.log10(mse)


def ssim(image, ground_truth, k1: float = 0.01, k2: float = 0.03, image_scale: float = 1.0) -> torch.Tensor:
    """Global SSIM pooled over all channels + pixels (reference semantics)."""
    a, b = _pair(image, ground_truth)
    c1 = (k1 * image_scale) ** 2
    c2 = (k2 * image_scale) ** 2
    mu_a = torch.mean(a)
    mu_b = torch.mean(b)
    var_a = torch.mean((a - mu_a) ** 2)
    var_b = torch.mean((b - mu_b) ** 2)
    cov = torch.mean((a - mu_a) * (b - mu_b))
    num = (2.0 * mu_a * mu_b + c1) * (2.0 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    return num / den


class GroundTruthEvaluator:
    """Abstract evaluator vs a stored ground truth (``ground_truth_evaluator.h``)."""

    def __init__(self, ground_truth):
        self.ground_truth = _as_chw(ground_truth)

    def _prepare(self, image) -> torch.Tensor:
        arr = _as_chw(image)
        if arr.shape[0] != self.ground_truth.shape[0]:
            raise ValueError("Images must have the same number of channels to be compared.")
        if arr.shape[1:] != self.ground_truth.shape[1:]:
            arr = linear_resize(arr, tuple(self.ground_truth.shape[1:]))
        return arr

    def evaluate(self, image) -> float:
        raise NotImplementedError


class PeakSignalToNoiseRatioEvaluator(GroundTruthEvaluator):
    def evaluate(self, image) -> float:
        return float(psnr(self._prepare(image), self.ground_truth))


class StructuralSimilarityEvaluator(GroundTruthEvaluator):
    def __init__(self, ground_truth, k1: float = 0.01, k2: float = 0.03, image_scale: float = 1.0):
        super().__init__(ground_truth)
        self.k1, self.k2, self.image_scale = k1, k2, image_scale

    def evaluate(self, image) -> float:
        return float(ssim(self._prepare(image), self.ground_truth, self.k1, self.k2, self.image_scale))
