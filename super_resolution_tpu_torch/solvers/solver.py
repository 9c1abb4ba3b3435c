"""Solver base classes (equivalents of ``src/optimization/solver.h`` and the
``MapSolver`` base, ``src/optimization/map_solver.{h,cpp}``)."""

from __future__ import annotations

import torch

from super_resolution_tpu_torch._device import as_chw, resolve_device
from super_resolution_tpu_torch.models.image_model import ImageModel

__all__ = ["Solver", "MapSolverBase"]


class Solver:
    """Abstract solver over a degradation model (``solver.h:14-43``)."""

    def __init__(self, image_model: ImageModel, print_solver_output: bool = True):
        self.image_model = image_model
        self._verbose = print_solver_output

    def stfu(self) -> None:
        """Disable solver output (``solver.h:26-34``)."""
        self._verbose = False

    @property
    def verbose(self) -> bool:
        return self._verbose

    def solve(self, initial_estimate):
        raise NotImplementedError


class MapSolverBase(Solver):
    """Shared MAP solver state: observations, HR geometry, regularizers.

    ``low_res_images`` is a sequence of ``[C, h, w]`` (or ``[h, w]``) numpy
    arrays, tensors or ``ImageData`` (read through ``.array``, as the JAX
    package does); they are stacked on ``device`` as ``dtype``.

    Unlike the reference — which nearest-upsamples all observations to the HR
    grid in the constructor (``map_solver.cpp:80-85``) — observations stay on
    the LR grid; the objective's s^2 factor reproduces the HR-grid residual
    semantics exactly (see :mod:`..solvers.objective`).
    """

    def __init__(
        self,
        image_model,
        low_res_images,
        print_solver_output=True,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__(image_model, print_solver_output)
        self.device = resolve_device(device)
        self.dtype = dtype
        stack = [as_chw(getattr(img, "array", img), self.device, dtype) for img in low_res_images]
        if not stack:
            raise ValueError("Cannot super-resolve with 0 low-res images.")
        for s in stack[1:]:
            if s.shape != stack[0].shape:
                raise ValueError("All LR images must have identical shapes.")
        self.observations = torch.stack(stack)
        self.num_channels = stack[0].shape[0]
        scale = image_model.downsampling_scale
        self.scale = scale
        h, w = stack[0].shape[-2], stack[0].shape[-1]
        self.hr_shape = (self.num_channels, h * scale, w * scale)
        self.regularizers: list[tuple[object, float]] = []

    @property
    def num_pixels(self) -> int:
        return self.hr_shape[1] * self.hr_shape[2]

    @property
    def image_size(self) -> tuple[int, int]:
        """(width, height) of the HR estimate."""
        return (self.hr_shape[2], self.hr_shape[1])

    @property
    def num_images(self) -> int:
        return self.observations.shape[0]

    @property
    def num_data_points(self) -> int:
        return self.num_pixels * self.num_channels

    def add_regularizer(self, regularizer, parameter: float) -> None:
        self.regularizers.append((regularizer, float(parameter)))

    @property
    def regularization_parameter_sum(self) -> float:
        return sum(lam for _, lam in self.regularizers)
