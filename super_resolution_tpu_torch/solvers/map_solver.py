"""Solver options mirroring ``src/optimization/map_solver.h:28-79`` and
``irls_map_solver.h:14-37``.

The JAX package's kernel-routing fields (``use_pallas_data_term``,
``use_static_shifts``, ``pallas_tile``, ``pallas_shift_bound``,
``pallas_channel_block``, ``fused_irls``) have no counterpart: the port's
objective is the CUDA kernel on a CUDA tensor and the plain version on a CPU
tensor. Motion refinement (``refine_motion_*``) and L-BFGS
(``num_lbfgs_hessian_corrections``) are not ported yet.
"""

from __future__ import annotations

import dataclasses

__all__ = ["MapSolverOptions", "IRLSMapSolverOptions"]


@dataclasses.dataclass
class MapSolverOptions:
    """Options shared by MAP solvers (defaults = reference defaults)."""

    # 'cg' (reference default, strong-Wolfe nonlinear CG) or 'linear_cg' —
    # exact-step CG exploiting the quadratic IRLS inner subproblem: one
    # objective evaluation per iteration with a true re-evaluation every
    # linear_cg_refresh_every iterations. 'lbfgs' is not ported yet.
    least_squares_solver: str = "cg"
    linear_cg_refresh_every: int = 8
    max_num_solver_iterations: int = 50
    gradient_norm_threshold: float = 1e-6
    cost_decrease_threshold: float = 1e-6
    parameter_variation_threshold: float = 1e-6
    # 'analytic' = reference-parity hand-derived gradients. 'autodiff' and
    # 'numerical' are not ported yet.
    diff_mode: str = "analytic"
    split_channels: bool = False

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
