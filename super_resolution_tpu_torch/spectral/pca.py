"""Spectral-basis PCA for hyperspectral stacks (equivalent of
``src/hyperspectral/spectral_pca.cpp``).

Training data is a subsampled set of pixel spectra: ``10 * num_bands``
samples split evenly across the input images with an even pixel stride
(``spectral_pca.cpp:23,50-66``). The basis comes from an SVD of the centered
sample matrix (equivalent to cv::PCA DATA_AS_ROW), computed once on the host
in float64 (a few hundred samples), truncated either to a band count or to a
retained-variance fraction (``spectral_pca.h:46-76``).

Projection / back-projection are per-pixel matrix products: ``[C, H, W]``
reshaped to ``[H*W, C]`` and multiplied by the basis with ``torch.matmul`` on
the tensor's device (``spectral_pca.cpp:94-161`` does it with scalar loops).
Components are sign-canonicalized (largest-|entry| positive) since the PCA
sign is arbitrary.
"""

from __future__ import annotations

import numpy as np
import torch

from super_resolution_tpu_torch.image.image_data import ImageData, SpectralMode

__all__ = ["SpectralPCA"]

_SAMPLES_PER_BAND = 10  # kPCASamplesMultiplicationFactor


def _as_chw(image) -> np.ndarray:
    arr = getattr(image, "array", image)
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    arr = np.asarray(arr, dtype=np.float64)
    if arr.ndim == 2:
        arr = arr[None]
    return arr


class SpectralPCA:
    """PCA over the spectral axis, trained from one or more images.

    ``mean`` ``[C]`` and ``basis`` ``[k, C]`` are float64 numpy arrays.
    ``from_basis`` builds the object from a mean and a basis computed
    elsewhere.
    """

    def __init__(
        self,
        hyperspectral_images,
        num_pca_bands: int = 0,
        retained_variance: float | None = None,
    ):
        images = [_as_chw(img) for img in hyperspectral_images]
        if not images:
            raise ValueError("At least one image is required to compute the PCA basis.")
        num_channels = images[0].shape[0]
        if num_channels == 0:
            raise ValueError("Cannot compute PCA on empty images.")

        samples = self._gather_training_samples(images, num_channels)
        mean = samples.mean(axis=0)
        centered = samples - mean
        # SVD of the sample matrix == eigendecomposition of the covariance.
        _, svals, vt = np.linalg.svd(centered, full_matrices=False)
        variances = (svals**2) / max(samples.shape[0] - 1, 1)

        if retained_variance is not None:
            if not 0.0 < retained_variance <= 1.0:
                raise ValueError("retained_variance must be in (0, 1].")
            ratios = np.cumsum(variances) / variances.sum()
            k = int(np.searchsorted(ratios, retained_variance) + 1)
        elif num_pca_bands > 0:
            k = min(num_pca_bands, len(svals))
        else:
            k = len(svals)

        basis = vt[:k]  # [k, C]
        # Canonical sign: largest-|.| entry of each component positive.
        signs = np.sign(basis[np.arange(k), np.abs(basis).argmax(axis=1)])
        signs[signs == 0] = 1.0
        self._set(mean, basis * signs[:, None])

    def _set(self, mean, basis) -> None:
        self.mean = np.asarray(mean, dtype=np.float64)
        self.basis = np.asarray(basis, dtype=np.float64)
        if self.basis.ndim != 2 or self.mean.shape != (self.basis.shape[1],):
            raise ValueError(
                f"mean {self.mean.shape} and basis {self.basis.shape} must be [C] and [k, C]."
            )
        self.num_pca_bands, self.num_spectral_bands = self.basis.shape

    @classmethod
    def from_basis(cls, mean, basis) -> "SpectralPCA":
        """A PCA with the given ``mean`` ``[C]`` and ``basis`` ``[k, C]``, taken as they are."""
        pca = cls.__new__(cls)
        pca._set(mean, basis)
        return pca

    @staticmethod
    def _gather_training_samples(images, num_channels) -> np.ndarray:
        num_images = len(images)
        num_pixels = images[0].shape[1] * images[0].shape[2]
        num_samples = num_channels * _SAMPLES_PER_BAND
        per_image = min(max(num_samples // num_images, 1), num_pixels)
        stride = max(num_pixels // per_image, 1)
        rows = []
        for img in images:
            if img.shape[0] != num_channels:
                raise ValueError("Inconsistent number of channels between images.")
            flat = img.reshape(num_channels, -1)  # [C, P]
            idx = (np.arange(per_image) * stride) % num_pixels
            rows.append(flat[:, idx].T)  # [per_image, C]
        return np.concatenate(rows, axis=0)

    # ------------------------------------------------------------- transforms

    def _on(self, array: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(array, device=like.device).to(like.dtype)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """``[C, H, W]`` spectra -> ``[k, H, W]`` PCA coefficients."""
        c, h, w = x.shape
        flat = x.reshape(c, h * w).T  # [P, C]
        coeffs = torch.matmul(flat - self._on(self.mean, x), self._on(self.basis.T, x))  # [P, k]
        return coeffs.T.reshape(self.num_pca_bands, h, w)

    def back_project(self, y: torch.Tensor) -> torch.Tensor:
        """``[k, H, W]`` PCA coefficients -> ``[C, H, W]`` spectra."""
        k, h, w = y.shape
        coeffs = y.reshape(k, h * w).T  # [P, k]
        flat = torch.matmul(coeffs, self._on(self.basis, y)) + self._on(self.mean, y)
        return flat.T.reshape(self.num_spectral_bands, h, w)

    # ----------------------------------------------------- ImageData wrappers

    def get_pca_image(self, image, device=None, dtype: torch.dtype | None = None) -> ImageData:
        """Mirror of ``SpectralPCA::GetPCAImage``: the projected image, in
        mode ``HYPERSPECTRAL_PCA``. ``image``: an ``ImageData``, a tensor
        (both stay where they are) or a numpy array (placed on ``device``,
        default ``"cuda"``, as ``dtype``, default float32)."""
        x = ImageData(getattr(image, "array", image), normalize="never", channel_major=True,
                      device=device, dtype=dtype).array
        return ImageData(self.project(x), normalize="never", channel_major=True,
                         spectral_mode=SpectralMode.HYPERSPECTRAL_PCA)

    def reconstruct_image(self, pca_image, device=None, dtype: torch.dtype | None = None) -> ImageData:
        """Mirror of ``SpectralPCA::ReconstructImage``: the back-projected
        image, in mode ``HYPERSPECTRAL`` (placement as :meth:`get_pca_image`)."""
        y = ImageData(getattr(pca_image, "array", pca_image), normalize="never", channel_major=True,
                      device=device, dtype=dtype).array
        return ImageData(self.back_project(y), normalize="never", channel_major=True,
                         spectral_mode=SpectralMode.HYPERSPECTRAL)
