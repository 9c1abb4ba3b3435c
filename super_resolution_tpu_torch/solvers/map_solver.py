"""Solver options mirroring ``src/optimization/map_solver.h:28-79`` and
``irls_map_solver.h:14-37``.

The JAX package's kernel-routing fields (``use_pallas_data_term``,
``use_static_shifts``, ``pallas_tile``, ``pallas_shift_bound``,
``pallas_channel_block``) have no counterpart: the port's objective is the
CUDA kernel on a CUDA tensor and the plain version on a CPU tensor.
``fused_irls`` routes the solve through ``irls_solve_fused`` as in the JAX
package; on a CUDA device its steps replay as CUDA graphs
(``solvers/irls.py``). In particular there is no shift bound: the TPU kernel's
shift-generic mode compiled one program per |shift| bucket and clipped
refined shifts to it; the CUDA kernels read any shift from device memory, so
refined motion is never clipped.
"""

from __future__ import annotations

import dataclasses

__all__ = ["MapSolverOptions", "IRLSMapSolverOptions"]


@dataclasses.dataclass
class MapSolverOptions:
    """Options shared by MAP solvers (defaults = reference defaults)."""

    # 'cg' (reference default, strong-Wolfe nonlinear CG), 'lbfgs', or
    # 'linear_cg' — exact-step CG exploiting the quadratic IRLS inner
    # subproblem: one objective evaluation per iteration with a true
    # re-evaluation every linear_cg_refresh_every iterations.
    least_squares_solver: str = "cg"
    linear_cg_refresh_every: int = 8
    num_lbfgs_hessian_corrections: int = 5
    max_num_solver_iterations: int = 50
    gradient_norm_threshold: float = 1e-6
    cost_decrease_threshold: float = 1e-6
    parameter_variation_threshold: float = 1e-6
    # 'analytic' = reference-parity hand-derived gradients (the CUDA kernels);
    # 'autodiff' = torch.autograd of the cost (machine-precision derivatives);
    # 'numerical' = central differences (the reference's
    # use_numerical_differentiation, map_solver.h:64-69 — O(2n) cost
    # evaluations per gradient, tiny validation problems only). Both of the
    # latter evaluate the cost with plain PyTorch ops.
    diff_mode: str = "analytic"
    split_channels: bool = False
    # Run the whole IRLS solve on the device (irls_solve_fused): the inner
    # solver's steps, the reweighting, the motion refinement and the stop
    # tests replay as CUDA graphs, and the host reads back one small tensor
    # per chunk of steps instead of one per step. Needs no mesh and (on a
    # CUDA device) diff_mode='analytic'; no checkpoint/resume.
    fused_irls: bool = False

    def adjust_thresholds_adaptively(
        self, num_parameters: int, regularization_parameter_sum: float
    ) -> None:
        """Scale stop thresholds by (n_params * sum lambda), only upward
        (``map_solver.cpp:16-26``)."""
        threshold_scale = num_parameters * regularization_parameter_sum
        if threshold_scale < 1.0:
            return
        self.gradient_norm_threshold *= threshold_scale
        self.cost_decrease_threshold *= threshold_scale
        self.parameter_variation_threshold *= threshold_scale


@dataclasses.dataclass
class IRLSMapSolverOptions(MapSolverOptions):
    """IRLS outer-loop options (``irls_map_solver.h:27-35``)."""

    max_num_irls_iterations: int = 20
    irls_cost_difference_threshold: float = 1e-5
    # Joint motion refinement (motion/refinement.py): every N IRLS
    # iterations, Gauss-Newton-refine the per-frame shifts against the
    # current HR estimate and resume the solve with the refined motion. The
    # refined [K, 2] tensor stays on the device and goes straight into the
    # objective kernels. 0 disables (reference behaviour: motion is estimated
    # once and never revisited).
    refine_motion_every: int = 0
    # Gauss-Newton steps per refinement round.
    refine_motion_iterations: int = 2
    # Joint-convergence gate: a converged cost only certifies convergence
    # when the last refinement round moved every shift by less than this
    # (HR px). Raise it for low-texture stacks where Gauss-Newton dithers
    # near the damping floor.
    refine_motion_delta_threshold: float = 1e-4

    def adjust_thresholds_adaptively(
        self, num_parameters: int, regularization_parameter_sum: float
    ) -> None:
        threshold_scale = num_parameters * regularization_parameter_sum
        if threshold_scale < 1.0:
            return
        super().adjust_thresholds_adaptively(
            num_parameters, regularization_parameter_sum
        )
        self.irls_cost_difference_threshold *= threshold_scale
