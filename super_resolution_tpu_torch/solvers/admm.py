"""ADMM MAP solver with exact TV splitting.

The reference's AdmmSolver is a non-functional skeleton that returns the
initial estimate (``src/optimization/admm_solver.cpp:10-34``; X/Z splitting
only sketched in comments). This is the algorithm it sketches, as the JAX
package runs it:

    min_x  s^2 sum_k ||A_k x - y_k||^2 + lambda ||G x||_1

split with z = G x (forward-difference stack), giving the standard updates

    x <- argmin s^2 sum_k ||A_k x - y_k||^2 + (rho/2) ||G x - z + u||^2
         (a few matrix-free linear-CG steps on the SPD normal equations)
    z <- soft_threshold(G x + u, lambda / rho)
    u <- u + G x - z

The data gradient and the Hessian-vector product of the x-update both go
through :func:`~super_resolution_tpu_torch.solvers.objective.data_term_cost_and_grad`:
the hand-written data-term kernels on a CUDA tensor (two launches an
evaluation), their plain version on a CPU tensor. The product is that call
with zero observations, plus rho G^T G. One ADMM iteration is
``2 + cg_iterations`` evaluations: the right-hand side, the warm start's
residual and one product per CG step. Nothing in the loops reads the device
back: the CG step's zero-denominator guards are ``torch.where`` on device
scalars, and the loop counts are fixed. The JAX package's ``max_shift`` (the
TPU kernel's shift bucket) has no counterpart: the CUDA kernels take any
shift. Unlike IRLS (which squares the anisotropic TV residual), ADMM
minimizes the true L1 TV objective.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from super_resolution_tpu_torch._device import as_chw
from super_resolution_tpu_torch.image.image_data import ImageData
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
from super_resolution_tpu_torch.solvers.map_solver import MapSolverOptions
from super_resolution_tpu_torch.solvers.objective import data_term_cost_and_grad
from super_resolution_tpu_torch.solvers.solver import MapSolverBase

__all__ = ["admm_solve", "AdmmResult", "AdmmSolver", "AdmmSolverOptions"]


class AdmmResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    primal_residual: torch.Tensor
    dual_residual: torch.Tensor


def _grad_x(x):
    return F.pad(x[..., :, 1:] - x[..., :, :-1], (0, 1))


def _grad_y(x):
    return F.pad(x[..., 1:, :] - x[..., :-1, :], (0, 0, 0, 1))


def _g(x):
    """Forward-difference operator G: [C,H,W] -> [2,C,H,W]."""
    return torch.stack([_grad_x(x), _grad_y(x)])


def _gt(z):
    """Adjoint G^T: [2,C,H,W] -> [C,H,W] (negative divergence)."""
    # Adjoint of d(r,c) = x(r,c+1) - x(r,c) for c < W-1 (zero at last col):
    zx, zy = z[0].clone(), z[1].clone()
    zx[..., :, -1] = 0.0
    zy[..., -1, :] = 0.0
    gx = F.pad(zx[..., :, :-1], (1, 0)) - zx
    gy = F.pad(zy[..., :-1, :], (0, 0, 1, 0)) - zy
    return gx + gy


def _soft_threshold(v, kappa):
    return torch.sign(v) * torch.clamp(torch.abs(v) - kappa, min=0.0)


def _dot(a, b):
    return torch.sum(a * b)


def _nonzero(v):
    return torch.where(v == 0, torch.ones_like(v), v)


def admm_solve(
    x0: torch.Tensor,
    observations: torch.Tensor,
    shifts,
    blur_kernel,
    scale: int,
    tv_lambda: float = 0.01,
    rho: float = 1.0,
    num_iterations: int = 30,
    cg_iterations: int = 10,
) -> AdmmResult:
    """Run ADMM on ``x0``'s device in its dtype.

    ``observations`` ``[K, C, H/s, W/s]`` on the same device; ``shifts``
    ``[K, 2]`` (dx, dy) in HR pixels (a float64 tensor on the device is used
    as it is; anything else is copied there once); ``blur_kernel`` a 2D
    array / tensor or ``None`` (placed on the device once).
    """
    x0 = x0.contiguous()
    device, dtype = x0.device, x0.dtype
    observations = observations.to(device=device, dtype=dtype).contiguous()
    shifts = torch.as_tensor(shifts, dtype=torch.float64, device=device).reshape(-1, 2).contiguous()
    if blur_kernel is not None:
        if isinstance(blur_kernel, torch.Tensor):
            blur_kernel = blur_kernel.detach()
        else:
            blur_kernel = torch.as_tensor(np.asarray(blur_kernel, dtype=np.float64))
        blur_kernel = blur_kernel.to(device=device, dtype=dtype).contiguous()
    zero_obs = torch.zeros_like(observations)

    def data_grad(x):
        # grad of s^2 sum ||A x - y||^2 (factor 2 included by the helper).
        return data_term_cost_and_grad(x, observations, shifts, blur_kernel, scale)[1]

    def hvp(v):
        # Hessian-vector product of the x-subproblem: 2 s^2 sum A^T A v + rho G^T G v.
        return data_term_cost_and_grad(v, zero_obs, shifts, blur_kernel, scale)[1] + rho * _gt(_g(v))

    def x_update(x, z, u):
        # Solve hvp(x) = b with linear CG, warm-started at x.
        b = -data_grad(torch.zeros_like(x)) + rho * _gt(z - u)
        r = b - hvp(x)
        p = r
        rs = _dot(r, r)
        for _ in range(cg_iterations):
            hp = hvp(p)
            alpha = rs / _nonzero(_dot(p, hp))
            x = x + alpha * p
            r = r - alpha * hp
            rs_new = _dot(r, r)
            p = r + (rs_new / _nonzero(rs)) * p
            rs = rs_new
        return x

    x = x0
    z = _g(x0)
    u = torch.zeros_like(z)
    for _ in range(num_iterations):
        x = x_update(x, z, u)
        gx = _g(x)
        z = _soft_threshold(gx + u, tv_lambda / rho)
        u = u + gx - z
    primal = torch.sqrt(torch.sum((_g(x) - z) ** 2))
    dual = rho * torch.sqrt(torch.sum(_gt(z - _g(x0)) ** 2))
    return AdmmResult(x=x, iterations=num_iterations, primal_residual=primal, dual_residual=dual)


@dataclasses.dataclass
class AdmmSolverOptions(MapSolverOptions):
    """ADMM options; ``max_num_solver_iterations`` is the outer ADMM
    iteration count (matching the reference's shared MapSolverOptions seam,
    ``admm_solver.h:15-27``)."""

    rho: float = 1.0
    # Linear-CG steps per x-subproblem solve (warm-started at the previous
    # x, so a handful suffices).
    admm_cg_iterations: int = 10


class AdmmSolver(MapSolverBase):
    """ADMM MAP solver implementing the :class:`Solver` interface.

    The reference stubs this class as a MapSolver subclass that returns its
    input (``src/optimization/admm_solver.cpp:10-34``); this one wraps the
    working :func:`admm_solve`, a peer of :class:`IRLSMapSolver` that the CLI
    reaches with ``--solver admm``.

    Supports exactly one 2D :class:`TotalVariationRegularizer` term (the
    exact L1 splitting implemented by :func:`admm_solve`); no regularizer
    degrades to plain least squares. BTV / 3D TV splittings are not
    implemented — use IRLS for those. The solve runs on ``device`` in
    ``dtype``; a CUDA device that is not there raises.
    """

    def __init__(self, options: AdmmSolverOptions, image_model, low_res_images,
                 print_solver_output: bool = False, device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__(image_model, low_res_images, print_solver_output, device, dtype)
        self.options = options
        motion = image_model.motion_operator
        k = self.observations.shape[0]
        if motion is not None:
            arr = motion.motion_sequence.as_array()
            if arr.shape[0] < k:
                raise ValueError("Fewer motion shifts than LR frames.")
            shifts = np.asarray(arr[:k], dtype=np.float64)
        else:
            shifts = np.zeros((k, 2))
        self.shifts = torch.as_tensor(shifts, dtype=torch.float64, device=self.device)
        blur = image_model.blur_operator
        self.blur_kernel = None if blur is None else torch.as_tensor(
            np.asarray(blur.kernel, dtype=np.float64)).to(device=self.device, dtype=dtype)

    def solve(self, initial_estimate):
        """The ADMM estimate ``[C, H, W]``: an ``ImageData`` in the initial
        estimate's spectral mode when it is one, else a tensor."""
        x0 = as_chw(getattr(initial_estimate, "array", initial_estimate), self.device, self.dtype)
        if tuple(x0.shape) != self.hr_shape:
            raise ValueError(
                f"Initial estimate shape {tuple(x0.shape)} != expected {self.hr_shape}"
            )

        tv_lambda = 1e-8  # ~unregularized least squares
        if self.regularizers:
            if len(self.regularizers) != 1:
                raise ValueError("AdmmSolver supports exactly one regularizer.")
            reg, lam = self.regularizers[0]
            if not isinstance(reg, TotalVariationRegularizer) or getattr(reg, "use_3d", False):
                raise ValueError(
                    "AdmmSolver implements the exact L1 splitting for 2D TV "
                    "only; use IRLSMapSolver for BTV / 3D TV."
                )
            tv_lambda = lam

        opts = self.options
        x = admm_solve(
            x0, self.observations, self.shifts, self.blur_kernel, self.scale,
            tv_lambda=tv_lambda, rho=opts.rho, num_iterations=opts.max_num_solver_iterations,
            cg_iterations=opts.admm_cg_iterations,
        ).x
        if self.verbose:
            print(
                f"ADMM done ({opts.max_num_solver_iterations} iterations, "
                f"rho={opts.rho}, lambda={tv_lambda})."
            )
        if isinstance(initial_estimate, ImageData):
            return ImageData(x, normalize="never", channel_major=True,
                             spectral_mode=initial_estimate.spectral_mode)
        return x
