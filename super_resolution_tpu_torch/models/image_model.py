"""The forward/adjoint degradation image model (equivalent of
``src/image_model/``).

Models the observation process ``y_k = D B M_k x (+ n)``:

- ``M_k`` translational warp by per-frame (dx, dy) — :class:`MotionOperator`
- ``B``   Gaussian PSF blur — :class:`BlurOperator`
- ``D``   top-left decimation by ``scale`` — :class:`DownsamplingOperator`
- ``n``   additive Gaussian noise (data generation only) — :class:`NoiseOperator`

Each operator exposes three views:

- ``apply(x, k)`` / ``apply_transpose(x, k)``: plain functions on
  ``[..., H, W]`` tensors that run on the tensor's own device;
- ``operator_matrix(hw, k)``: the explicit dense numpy matrix, a *test-only
  oracle* capped at 30x30 images / 10x10 kernels like the reference
  (``degradation_operator.cpp:16-17``), on no solve path.

The :class:`ImageModel` chains operators in order (forward) and reverse
(adjoint), mirroring ``image_model.cpp:76-118``. :func:`degrade` /
:func:`degrade_adjoint` are the functional form for one frame.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from super_resolution_tpu_torch.motion.motion_shift import MotionShiftSequence
from super_resolution_tpu_torch.ops.blur import (
    blur as blur_op,
    blur_adjoint as blur_adjoint_op,
    gaussian_kernel_2d,
)
from super_resolution_tpu_torch.ops.resize import decimate, zero_upsample
from super_resolution_tpu_torch.ops.warp import (
    translate,
    translate_adjoint,
    translate_with_shift_derivatives,
)

__all__ = [
    "ImageModelParameters",
    "ImageModel",
    "DegradationOperator",
    "MotionOperator",
    "BlurOperator",
    "DownsamplingOperator",
    "NoiseOperator",
    "kernel_to_operator_matrix",
    "degrade",
    "degrade_adjoint",
    "degrade_with_shift_derivatives",
]


# Dense-matrix oracle caps (``degradation_operator.cpp:16-17``).
_MAX_MATRIX_IMAGE_SIZE = 30
_MAX_MATRIX_KERNEL_SIZE = 10


def kernel_to_operator_matrix(kernel, hw: tuple[int, int]) -> np.ndarray:
    """Dense correlation matrix of a 2D kernel over an HxW image.

    Row ``i`` holds the kernel taps that produce output pixel ``i`` under
    zero-padded correlation — ``DegradationOperator::ConvertKernelToOperatorMatrix``
    (``degradation_operator.cpp:22-76``).
    """
    kernel = np.asarray(kernel, dtype=np.float64)
    kh, kw = kernel.shape
    h, w = hw
    if kh > _MAX_MATRIX_KERNEL_SIZE or kw > _MAX_MATRIX_KERNEL_SIZE:
        raise ValueError("Kernel is too big to convert to matrix form.")
    if h > _MAX_MATRIX_IMAGE_SIZE or w > _MAX_MATRIX_IMAGE_SIZE:
        raise ValueError("Image is too big to compute a kernel matrix.")
    mat = np.zeros((h * w, h * w))
    mid_r, mid_c = kh // 2, kw // 2
    for row in range(h):
        for col in range(w):
            for i in range(kh):
                for j in range(kw):
                    rr, cc = row + i - mid_r, col + j - mid_c
                    if 0 <= rr < h and 0 <= cc < w:
                        mat[row * w + col, rr * w + cc] = kernel[i, j]
    return mat


class DegradationOperator:
    """Base operator: forward, transpose and dense-matrix views."""

    def apply(self, x: torch.Tensor, index: int) -> torch.Tensor:
        raise NotImplementedError

    def apply_transpose(self, x: torch.Tensor, index: int) -> torch.Tensor:
        raise NotImplementedError

    def operator_matrix(self, hw: tuple[int, int], index: int) -> np.ndarray:
        """Default: identity (``degradation_operator.cpp:78-83``)."""
        return np.eye(hw[0] * hw[1])


class MotionOperator(DegradationOperator):
    """Per-frame translational warp M_k (``motion_module.cpp``)."""

    def __init__(self, motion_sequence: MotionShiftSequence):
        self.motion_sequence = motion_sequence

    def apply(self, x, index):
        s = self.motion_sequence[index]
        return translate(x, s.dx, s.dy)

    def apply_transpose(self, x, index):
        s = self.motion_sequence[index]
        return translate_adjoint(x, s.dx, s.dy)

    def operator_matrix(self, hw, index):
        """0/1 shift matrix; fractional shifts truncate like the reference's
        implicit double->int conversion (``motion_module.cpp:53-73``)."""
        h, w = hw
        s = self.motion_sequence[index]
        dy, dx = int(s.dy), int(s.dx)
        mat = np.zeros((h * w, h * w))
        for row in range(h):
            for col in range(w):
                sr, sc = row - dy, col - dx
                if 0 <= sr < h and 0 <= sc < w:
                    mat[row * w + col, sr * w + sc] = 1.0
        return mat


class BlurOperator(DegradationOperator):
    """Gaussian PSF blur B (``blur_module.cpp``). ``radius`` is the full
    (odd) kernel size, matching the reference's naming."""

    def __init__(self, radius: int, sigma: float):
        if radius < 1 or radius % 2 != 1:
            raise ValueError("Blur radius must be a positive odd number.")
        if sigma <= 0:
            raise ValueError("Blur sigma must be positive.")
        self.radius = radius
        self.sigma = sigma
        self.kernel = gaussian_kernel_2d(radius, sigma)

    def apply(self, x, index):
        return blur_op(x, self.kernel)

    def apply_transpose(self, x, index):
        return blur_adjoint_op(x, self.kernel)

    def operator_matrix(self, hw, index):
        return kernel_to_operator_matrix(self.kernel, hw)


class DownsamplingOperator(DegradationOperator):
    """Top-left decimation D (``downsampling_module.cpp``)."""

    def __init__(self, scale: int):
        if scale < 1:
            raise ValueError("Downsampling scale must be at least 1.")
        self.scale = scale

    def apply(self, x, index):
        return decimate(x, self.scale)

    def apply_transpose(self, x, index):
        return zero_upsample(x, self.scale)

    def operator_matrix(self, hw, index):
        """Row-selection matrix mapping HR pixels to the LR grid
        (``downsampling_module.cpp:41-64``)."""
        h, w = hw
        s = self.scale
        mat = np.zeros(((h * w) // (s * s), h * w))
        next_row = 0
        for row in range(0, h, s):
            for col in range(0, w, s):
                mat[next_row, row * w + col] = 1.0
                next_row += 1
        return mat


class NoiseOperator(DegradationOperator):
    """Additive Gaussian noise N(0, sigma/255) per channel
    (``additive_noise_module.cpp``). Data-generation only; the transpose is a
    no-op (the reference leaves it unimplemented, :38-44).

    The noise is drawn from an explicit ``torch.Generator``. Without one, a
    generator on the tensor's device is seeded with ``seed + index`` per call,
    so a frame's noise does not depend on the order frames are made in. The
    values differ from the JAX package's for the same seed.
    """

    def __init__(self, sigma: float, seed: int = 0, generator: torch.Generator | None = None):
        if sigma <= 0:
            raise ValueError("Noise sigma must be positive.")
        self.sigma = sigma
        self.seed = seed
        self.generator = generator

    def apply(self, x, index):
        gen = self.generator
        if gen is None:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(self.seed + index)
        noise = torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype)
        return x + noise * (self.sigma / 255.0)

    def apply_transpose(self, x, index):
        return x


@dataclasses.dataclass
class ImageModelParameters:
    """Mirror of ``ImageModelParameters`` (``image_model.h:26-50``)."""

    scale: int = 2
    blur_radius: int = 0          # full (odd) kernel size; 0 disables blur
    blur_sigma: float = 0.0
    motion_sequence: MotionShiftSequence | None = None
    motion_sequence_path: str = ""
    noise_sigma: float = 0.0
    noise_seed: int = 0


class ImageModel:
    """Ordered chain of degradation operators (``image_model.cpp``)."""

    def __init__(self, downsampling_scale: int, operators: Sequence[DegradationOperator] = ()):
        if downsampling_scale < 1:
            raise ValueError("Downsampling scale must be at least 1.")
        self.downsampling_scale = downsampling_scale
        self.operators: list[DegradationOperator] = list(operators)

    @classmethod
    def create(cls, params: ImageModelParameters) -> "ImageModel":
        """Factory assembling M -> B -> D (-> n), ``image_model.cpp:17-61``."""
        model = cls(params.scale)
        seq = params.motion_sequence
        if (seq is None or len(seq) == 0) and params.motion_sequence_path:
            seq = MotionShiftSequence.from_file(params.motion_sequence_path)
        if seq is not None and len(seq) > 0:
            model.add_operator(MotionOperator(seq))
        if params.blur_radius > 0 and params.blur_sigma > 0.0:
            model.add_operator(BlurOperator(params.blur_radius, params.blur_sigma))
        model.add_operator(DownsamplingOperator(params.scale))
        if params.noise_sigma > 0.0:
            model.add_operator(NoiseOperator(params.noise_sigma, params.noise_seed))
        return model

    def add_operator(self, operator: DegradationOperator) -> None:
        self.operators.append(operator)

    def apply(self, x: torch.Tensor, index: int) -> torch.Tensor:
        """Forward degradation of an HR ``[..., H, W]`` tensor for frame ``index``."""
        for op in self.operators:
            x = op.apply(x, index)
        return x

    def apply_transpose(self, x: torch.Tensor, index: int) -> torch.Tensor:
        """Adjoint chain, reverse operator order (``image_model.cpp:93-101``)."""
        for op in reversed(self.operators):
            x = op.apply_transpose(x, index)
        return x

    def operator_matrix(self, hw: tuple[int, int], index: int) -> np.ndarray:
        """Dense ``A_k = D B M_k`` for the test oracle (``image_model.cpp:103-118``):
        the operators' matrices composed in order. The JAX package's name is
        :meth:`model_matrix`."""
        if not self.operators:
            raise ValueError("Cannot build a model matrix with no operators.")
        mat = self.operators[0].operator_matrix(hw, index)
        for op in self.operators[1:]:
            mat = op.operator_matrix(hw, index) @ mat
        return mat

    model_matrix = operator_matrix

    # Convenience accessors for the fused functional path.

    @property
    def motion_operator(self) -> MotionOperator | None:
        for op in self.operators:
            if isinstance(op, MotionOperator):
                return op
        return None

    @property
    def blur_operator(self) -> BlurOperator | None:
        for op in self.operators:
            if isinstance(op, BlurOperator):
                return op
        return None


def degrade(x: torch.Tensor, dx, dy, blur_kernel, scale: int) -> torch.Tensor:
    """Functional forward model ``D B M x`` for one frame's (dx, dy).

    Shifts are Python numbers or tensors (0-d, or ``[B]`` with ``x``
    ``[B, ..., H, W]``); tensor shifts stay on their device (see
    :func:`~super_resolution_tpu_torch.ops.warp.translate`).
    """
    z = translate(x, dx, dy)
    if blur_kernel is not None:
        z = blur_op(z, blur_kernel)
    return decimate(z, scale)


def degrade_with_shift_derivatives(x: torch.Tensor, dx, dy, blur_kernel, scale: int):
    """``(D B M x, d/d dx, d/d dy)``: the prediction and its Jacobian in the shift.

    Blur and decimation are linear, so the derivatives are the same chain
    applied to the warp's closed-form shift derivatives.
    """
    outs = translate_with_shift_derivatives(x, dx, dy)
    if blur_kernel is not None:
        outs = tuple(blur_op(z, blur_kernel) for z in outs)
    return tuple(decimate(z, scale) for z in outs)


def degrade_adjoint(r: torch.Tensor, dx, dy, blur_kernel, scale: int) -> torch.Tensor:
    """Adjoint ``M^T B^T D^T r`` (reverse order, ``image_model.cpp:93-101``)."""
    z = zero_upsample(r, scale)
    if blur_kernel is not None:
        z = blur_adjoint_op(z, blur_kernel)
    return translate_adjoint(z, dx, dy)
