"""The MAP objective: data-fidelity term + IRLS-weighted regularization terms.

Replaces the reference's ObjectiveFunction / ObjectiveDataTerm /
ObjectiveIRLSRegularizationTerm stack (``src/optimization/objective_*.cpp``)
with fused functions.

Data term semantics (``objective_data_term.cpp:15-95``): the reference keeps
observations nearest-upsampled on the HR grid, degrades the HR estimate,
re-upsamples it, takes per-pixel residuals on the HR grid, and for the
gradient additive-downsamples the HR residual before the adjoint chain.
Because nearest-upsampling by integer scale ``s`` repeats each LR pixel
``s^2`` times and additive-downsampling sums them back, this is *exactly*
equivalent to computing everything on the LR grid with an ``s^2`` factor:

    cost   = s^2 * sum_k ||D B M_k x - y_k||^2
    grad   = 2 s^2 * sum_k M_k^T B^T D^T (D B M_k x - y_k)

Regularization term (``objective_irls_regularization_term.cpp``):
``cost += lambda * sum_i w_i r_i^2`` with gradient constants ``lambda * w``.

Where the JAX package chose between a traced path, a static-shift path and
a Pallas kernel through a dozen keywords, the port has one choice, made by
where the tensors live: :func:`~super_resolution_tpu_torch.ops.cuda.degrade.fused_objective`
launches the CUDA kernels for a CUDA tensor and runs the plain version for a
CPU tensor. Only the analytic (reference-parity) gradient is ported.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from super_resolution_tpu_torch._device import as_tensor, resolve_device
from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu_torch.ops.cuda.degrade import (
    fused_objective,
    fused_objective_reference,
)
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer

__all__ = [
    "data_term_cost_and_grad",
    "data_term_cost_and_grad_static",
    "make_map_value_and_grad",
]


def data_term_cost_and_grad_static(
    x: torch.Tensor, observations: torch.Tensor, static_shifts, blur_kernel, scale: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Data term from plain PyTorch ops with host-known shifts, on any device.

    The semantic reference of the fused kernels: cost and gradient of
    ``s^2 sum_k ||A_k x - y_k||^2`` with per-operator zero borders.
    """
    return fused_objective_reference(x, observations, static_shifts, blur_kernel, scale)


def data_term_cost_and_grad(
    x: torch.Tensor, observations: torch.Tensor, shifts, blur_kernel, scale: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused cost+gradient of ``s^2 sum_k ||A_k x - y_k||^2``.

    ``x``: HR estimate ``[C, H, W]``; ``observations``: LR stack
    ``[K, C, H/s, W/s]``; ``shifts``: ``[K, 2]`` (dx, dy) columns, runtime
    data. CUDA kernels for a CUDA ``x``, the plain version for a CPU ``x``.
    """
    return fused_objective(x, observations, shifts, blur_kernel, scale)


def make_map_value_and_grad(
    observations,
    shifts,
    blur_kernel,
    scale: int,
    regularizers: Sequence[tuple[object, float]] = (),
    diff_mode: str = "analytic",
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> Callable:
    """Build ``value_and_grad(x, weights) -> (cost, grad)`` for the MAP objective.

    ``observations`` ``[K, C, H/s, W/s]``, ``shifts`` ``[K, 2]`` and
    ``blur_kernel`` (2D or ``None``) are numpy arrays or tensors; they are
    placed on ``device`` as ``dtype`` once, here. ``weights`` is a tuple of
    per-regularizer IRLS weight tensors (shape of x) on the same device.

    A single 2D TV or BTV term with a positive parameter is fused into the
    objective kernel; any other set of regularizers is added term by term
    with plain tensor ops after the fused data term.
    ``value_and_grad.prepare(weights)`` binds the weights and computes the
    ``lambda * w`` constants once for a whole inner solve.

    ``diff_mode`` other than ``"analytic"`` is not ported yet.
    """
    if diff_mode not in ("analytic", "autodiff", "numerical"):
        raise ValueError(f"Unknown diff_mode {diff_mode!r}")
    if diff_mode != "analytic":
        raise NotImplementedError(f"diff_mode {diff_mode!r} is not ported yet; use 'analytic'.")
    device = resolve_device(device)
    obs = as_tensor(observations, device, dtype)
    # float64 on the device: the kernels split each shift into its integer
    # and fractional part themselves.
    shifts_t = as_tensor(np.asarray(_to_numpy(shifts), dtype=np.float64).reshape(-1, 2), device, torch.float64)
    shifts_host = shifts_t.cpu().numpy()
    kernel_np = None if blur_kernel is None else np.asarray(_to_numpy(blur_kernel), dtype=np.float64)
    kernel_t = None if kernel_np is None else as_tensor(kernel_np, device, dtype)
    regs = tuple(regularizers)

    fuse_tv = len(regs) == 1 and isinstance(regs[0][0], TotalVariationRegularizer) and regs[0][1] > 0.0
    fuse_btv = (
        len(regs) == 1
        and isinstance(regs[0][0], BilateralTotalVariationRegularizer)
        and regs[0][1] > 0.0
    )

    # The plain version slices by host shifts and host blur taps; the kernels
    # read both from device memory.
    motion, psf = (shifts_host, kernel_np) if device.type == "cpu" else (shifts_t, kernel_t)

    def objective(x, **fused):
        return fused_objective(x, obs, motion, psf, scale, **fused)

    def bind(weights):
        weights = tuple(weights)
        if fuse_tv:
            constants = (regs[0][1] * weights[0]).contiguous()
            return lambda x: objective(x, tv_constants=constants)
        if fuse_btv:
            reg, lam = regs[0]
            constants = (lam * weights[0]).contiguous()
            return lambda x: objective(
                x, btv_constants=constants, btv_range=reg.scale_range, btv_decay=reg.spatial_decay
            )
        terms = [(reg, lam * w) for (reg, lam), w in zip(regs, weights) if lam > 0.0]

        def unfused(x):
            cost, grad = objective(x)
            for reg, constants in terms:
                c, g = reg.cost_and_grad(x, constants)
                cost = cost + c
                grad = grad + g
            return cost, grad

        return unfused

    def value_and_grad(x, weights=()):
        return bind(weights)(x)

    value_and_grad.prepare = bind
    return value_and_grad


def _to_numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
