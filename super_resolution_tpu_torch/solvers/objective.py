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
CPU tensor. That is the analytic (reference-parity) gradient. The two
gradient-validation modes, ``autodiff`` (``torch.autograd.grad`` of the
cost) and ``numerical`` (central differences, :func:`finite_difference_grad`),
evaluate the cost with plain PyTorch ops on any device, on purpose: the JAX
package routes them off its kernel too.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from super_resolution_tpu_torch._device import as_tensor, resolve_device
from super_resolution_tpu_torch.models.image_model import degrade
from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu_torch.ops.cuda.degrade import (
    fused_objective,
    fused_objective_reference,
)
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer

__all__ = [
    "data_term_cost_and_grad",
    "data_term_cost_and_grad_static",
    "data_term_cost",
    "make_map_value_and_grad",
    "finite_difference_grad",
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


def data_term_cost(x: torch.Tensor, observations: torch.Tensor, shifts, blur_kernel, scale: int) -> torch.Tensor:
    """Cost only, ``s^2 sum_k ||D B M_k x - y_k||^2``, from the plain forward
    model (:func:`~super_resolution_tpu_torch.models.image_model.degrade`;
    for the autodiff and numerical modes, differentiable in ``x``).

    ``shifts``: ``[K, 2]`` (dx, dy), read where they lie: a tensor on ``x``'s
    device is never read back, so an evaluation can be captured in a CUDA
    graph. ``blur_kernel``: host taps (numpy) or ``None``.
    """
    shifts = torch.as_tensor(shifts, device=x.device).reshape(-1, 2)
    cost = torch.zeros((), dtype=x.dtype, device=x.device)
    for k in range(observations.shape[0]):
        r = degrade(x, shifts[k, 0], shifts[k, 1], blur_kernel, scale) - observations[k]
        cost = cost + torch.sum(r * r)
    return float(scale * scale) * cost


def finite_difference_grad(cost_fn: Callable, x: torch.Tensor, step: float = 1e-6) -> torch.Tensor:
    """Central-difference gradient (the reference's numerical-diff testing
    mode, ``map_solver.h:64-69``). O(2n) cost evaluations: tiny problems only."""
    flat = x.reshape(-1)
    grad = torch.empty_like(flat)
    for i in range(flat.numel()):
        plus, minus = flat.clone(), flat.clone()
        plus[i] = flat[i] + step
        minus[i] = flat[i] - step
        grad[i] = (cost_fn(plus.reshape(x.shape)) - cost_fn(minus.reshape(x.shape))) / (2.0 * step)
    return grad.reshape(x.shape)


def _autodiff(cost_fn: Callable) -> Callable:
    """``x -> (cost, torch.autograd.grad of the cost)``."""

    def value_and_grad(x):
        with torch.enable_grad():
            z = x.detach().requires_grad_(True)
            cost = cost_fn(z)
            (grad,) = torch.autograd.grad(cost, z)
        return cost.detach(), grad

    return value_and_grad


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
    placed on ``device`` once, here (the shifts as float64: the kernels split
    each into its integer and fractional part themselves). ``weights`` is a
    tuple of per-regularizer IRLS weight tensors (shape of x) on the same
    device.

    A single TV (2D or 3D) or BTV term with a positive parameter is fused
    into the objective kernel; any other set of regularizers is added term by
    term with plain tensor ops after the fused data term.
    ``value_and_grad.prepare(weights, shifts=None)`` binds the weights,
    computes the ``lambda * w`` constants once for a whole inner solve and,
    when ``shifts`` is given, uses that ``[K, 2]`` tensor instead of the
    shifts given here: motion refined on the device reaches the kernels as
    it is, and nothing is rebuilt. ``value_and_grad(x, weights, shifts)``
    does the same per call. ``value_and_grad.bind_static()`` binds it once to
    buffers that later calls update in place (the fused IRLS solve's CUDA
    graphs read them; see its docstring).

    ``diff_mode``: ``"analytic"`` (the reference's hand-derived gradient
    chain, through the fused objective), ``"autodiff"`` (``torch.autograd``
    of the cost: the data term from the plain degradation plus ``sum lambda
    w r^2``) or ``"numerical"`` (central differences of that cost, step 1e-6,
    O(2n) evaluations per gradient). The last two run plain PyTorch ops on
    any device and read the shifts where they lie, as the analytic mode does.
    """
    if diff_mode not in ("analytic", "autodiff", "numerical"):
        raise ValueError(f"Unknown diff_mode {diff_mode!r}")
    device = resolve_device(device)
    obs = as_tensor(observations, device, dtype)
    shifts_t = as_tensor(shifts, device, torch.float64).reshape(-1, 2)
    kernel_np = None if blur_kernel is None else np.asarray(_to_numpy(blur_kernel), dtype=np.float64)
    kernel_t = None if kernel_np is None else as_tensor(kernel_np, device, dtype)
    regs = tuple(regularizers)

    fuse_tv = len(regs) == 1 and isinstance(regs[0][0], TotalVariationRegularizer) and regs[0][1] > 0.0
    fuse_btv = (
        len(regs) == 1
        and isinstance(regs[0][0], BilateralTotalVariationRegularizer)
        and regs[0][1] > 0.0
    )

    # The plain version slices by host blur taps; the kernels read them from
    # device memory.
    psf = kernel_np if device.type == "cpu" else kernel_t

    def bound(motion, constants):
        """The objective at these shifts and per-regulariser ``lambda * w``
        constants (``None`` for a term whose parameter is not positive)."""
        if diff_mode != "analytic":
            terms = [(reg, c) for (reg, lam), c in zip(regs, constants) if lam > 0.0]

            def cost_fn(x):
                cost = data_term_cost(x, obs, motion, kernel_np, scale)
                for reg, c in terms:
                    r = reg.residuals(x)
                    cost = cost + torch.sum(c * r * r)
                return cost

            if diff_mode == "autodiff":
                return _autodiff(cost_fn)
            return lambda x: (cost_fn(x), finite_difference_grad(cost_fn, x))

        def objective(x, **fused):
            return fused_objective(x, obs, motion, psf, scale, **fused)

        if fuse_tv:
            return lambda x: objective(x, tv_constants=constants[0], tv_use_3d=regs[0][0].use_3d)
        if fuse_btv:
            reg = regs[0][0]
            return lambda x: objective(
                x, btv_constants=constants[0], btv_range=reg.scale_range, btv_decay=reg.spatial_decay
            )
        terms = [(reg, c) for (reg, lam), c in zip(regs, constants) if lam > 0.0]

        def unfused(x):
            cost, grad = objective(x)
            for reg, c in terms:
                c_reg, g_reg = reg.cost_and_grad(x, c)
                cost = cost + c_reg
                grad = grad + g_reg
            return cost, grad

        return unfused

    def bind(weights, shifts=None):
        motion = shifts_t if shifts is None else as_tensor(shifts, device, torch.float64).reshape(-1, 2)
        constants = tuple((lam * w).contiguous() if lam > 0.0 else None for (_, lam), w in zip(regs, weights))
        return bound(motion, constants)

    def bind_static():
        """The objective bound to buffers whose addresses never change, for
        a solve captured into CUDA graphs: ``.constants`` (one ``lambda * w``
        buffer of ``x``'s shape per regulariser, ``None`` where the parameter
        is not positive), ``.shifts`` (a ``[K, 2]`` float64 buffer, starting
        as the shifts given here) and ``.observations`` (the stack it reads).
        ``.set_weights(weights)`` writes ``lambda * w`` into the constants in
        place; whoever writes ``.shifts`` or ``.observations`` in place
        (``.set_shifts(values)``, ``.set_observations(values)``) changes
        what every later evaluation, and every replay, reads. ``.buffers``:
        the tensors the IRLS seam writes (shifts, constants). ``.place`` /
        ``.gather`` map an estimate to the solve's state and back: the
        identity here, the mesh's placement for a sharded objective."""
        k, c, h, w = obs.shape
        constants = tuple(
            torch.empty((c, h * scale, w * scale), dtype=dtype, device=device) if lam > 0.0 else None
            for _, lam in regs)
        motion = shifts_t.clone()
        fn = bound(motion, constants)

        def set_weights(weights):
            for (_, lam), buffer, weight in zip(regs, constants, weights):
                if buffer is not None:
                    torch.mul(weight, lam, out=buffer)

        fn.constants, fn.shifts, fn.observations, fn.set_weights = constants, motion, obs, set_weights
        fn.set_shifts, fn.set_observations = motion.copy_, obs.copy_
        fn.buffers = (motion,) + tuple(c for c in constants if c is not None)  # what a solve's steps write
        fn.place = fn.gather = lambda x: x  # the state of a solve is the estimate itself
        return fn

    def value_and_grad(x, weights=(), shifts=None):
        return bind(weights, shifts)(x)

    value_and_grad.prepare = bind
    value_and_grad.bind_static = bind_static
    return value_and_grad


def _to_numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
