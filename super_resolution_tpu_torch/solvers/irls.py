"""IRLS MAP solver — the production solver (equivalent of
``src/optimization/irls_map_solver.cpp``), single device.

Algorithm (``RunIRLSLoop``, ``irls_map_solver.cpp:45-157``):

1. Initialize per-regularizer IRLS weights to 1.
2. Inner solve: minimize ``s^2 sum_k ||A_k x - y_k||^2 + sum_r lambda_r
   sum_i w_i r_i(x)^2`` with matrix-free CG (see :mod:`least_squares`); every
   evaluation is one call of the fused objective (CUDA kernels on a CUDA
   device, the plain version on the CPU).
3. Reweight ``w_i = 1 / max(1e-5, r_i)`` — L1-via-weighted-L2
   (``irls_map_solver.cpp:128-143``, ``kMinResidualValue`` at :34).
4. Repeat until ``|cost_k - cost_{k+1}| < irls_cost_difference_threshold``
   (adaptively scaled) or ``max_num_irls_iterations``.

With ``refine_motion_every > 0`` the per-frame shifts are refined against the
just-solved estimate at the seam between two inner solves
(:mod:`~super_resolution_tpu_torch.motion.refinement`). ``self.shifts`` is a
float64 ``[K, 2]`` tensor on the solver's device; the refiner's output
replaces it there and the next inner solve hands it to the objective kernels
as it is: nothing is rebuilt and no shift passes through the host. The
refinement's largest change is read back together with the round's cost, one
synchronisation per IRLS round.

``split_channels`` solves each channel independently
(``irls_map_solver.cpp:200-262``); a 3D TV term then sees one band per solve
and is the 2D term, as in the JAX package.

Not ported yet: device meshes, the fused on-device IRLS loop,
checkpoint/resume and the cross-instance solver cache.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from super_resolution_tpu_torch._device import as_chw, as_tensor
from super_resolution_tpu_torch.models.image_model import ImageModel
from super_resolution_tpu_torch.motion.refinement import make_shift_refiner
from super_resolution_tpu_torch.solvers.least_squares import minimize
from super_resolution_tpu_torch.solvers.map_solver import IRLSMapSolverOptions
from super_resolution_tpu_torch.solvers.objective import make_map_value_and_grad
from super_resolution_tpu_torch.solvers.solver import MapSolverBase

__all__ = ["IRLSMapSolver", "IRLSMapSolverOptions"]

# Minimum residual for IRLS reweighting (``irls_map_solver.cpp:34``).
_MIN_RESIDUAL = 1e-5


class IRLSMapSolver(MapSolverBase):
    """MAP super-resolution solver with IRLS-reweighted regularization."""

    def __init__(
        self,
        options: IRLSMapSolverOptions,
        image_model: ImageModel,
        low_res_images,
        print_solver_output: bool = False,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ):
        """``low_res_images``: ``[C, h, w]`` numpy arrays or tensors. The whole
        solve runs on ``device`` in ``dtype``; a CUDA device that is not there
        raises."""
        super().__init__(image_model, low_res_images, print_solver_output, device, dtype)
        self.options = options
        self.last_inner_iterations = 0
        # (wall seconds, CG iterations, objective evaluations) per
        # inner-solver call of the last solve().
        self.last_inner_calls: list[tuple[float, int, int]] = []

        motion = image_model.motion_operator
        k = self.observations.shape[0]
        if motion is not None:
            arr = motion.motion_sequence.as_array()
            if arr.shape[0] < k:
                raise ValueError("Fewer motion shifts than LR frames.")
            shifts = np.asarray(arr[:k], dtype=np.float64)
        else:
            shifts = np.zeros((k, 2))
        # [K, 2] (dx, dy) in HR pixels, float64 on the solver's device.
        # Motion refinement replaces it; later channel rounds and later
        # solve() calls start from the refined motion.
        self.shifts = as_tensor(shifts, self.device, torch.float64)
        blur = image_model.blur_operator
        self.blur_kernel = None if blur is None else np.asarray(blur.kernel)

    def solve(self, initial_estimate) -> torch.Tensor:
        """Run the solver; returns the HR estimate ``[C, H, W]`` on the solver's device."""
        x_full = as_chw(initial_estimate, self.device, self.dtype)
        if tuple(x_full.shape) != self.hr_shape:
            raise ValueError(
                f"Initial estimate shape {tuple(x_full.shape)} != expected {self.hr_shape}"
            )

        c = self.num_channels
        channels_per_split = 1 if self.options.split_channels else c
        num_rounds = c // channels_per_split
        num_data_points = channels_per_split * self.num_pixels
        # Pixels each INNER CALL solves (one channel round) — the per-call
        # normalizer for throughput reporting.
        self.last_inner_pixels = num_data_points

        # Adaptive threshold scaling (``irls_map_solver.cpp:214-216``).
        opts = dataclasses.replace(self.options)
        opts.adjust_thresholds_adaptively(num_data_points, self.regularization_parameter_sum)

        if opts.refine_motion_every < 0 or (opts.refine_motion_every > 0 and opts.refine_motion_iterations < 1):
            raise ValueError(
                "refine_motion_every must be >= 0 and, when refining, refine_motion_iterations >= 1; got "
                f"{opts.refine_motion_every} and {opts.refine_motion_iterations}."
            )

        self.last_inner_iterations = 0
        self.last_inner_calls = []

        results = []
        for i in range(num_rounds):
            ch0, ch1 = i * channels_per_split, (i + 1) * channels_per_split
            observations = self.observations[:, ch0:ch1].contiguous()
            inner = self._build_inner_solver(observations, opts)
            results.append(self._run_irls_loop(inner, x_full[ch0:ch1].contiguous(), observations, opts))
        return torch.cat(results, dim=0)

    # ------------------------------------------------------------------ internals

    def _build_inner_solver(self, observations, opts):
        vg = make_map_value_and_grad(
            observations, self.shifts, self.blur_kernel, self.scale, self.regularizers,
            diff_mode=opts.diff_mode, device=self.device, dtype=self.dtype,
        )

        def inner(x0, weights):
            return minimize(
                vg.prepare(weights, self.shifts),
                x0,
                method=opts.least_squares_solver,
                max_iterations=opts.max_num_solver_iterations,
                gradient_norm_threshold=opts.gradient_norm_threshold,
                cost_decrease_threshold=opts.cost_decrease_threshold,
                parameter_variation_threshold=opts.parameter_variation_threshold,
                linear_cg_refresh_every=opts.linear_cg_refresh_every,
                log_iterations=self.verbose,
            )

        return inner

    def _reweight(self, x):
        return tuple(
            1.0 / torch.clamp(reg.residuals(x), min=_MIN_RESIDUAL)
            for reg, _ in self.regularizers
        )

    def _run_irls_loop(self, inner, x0, observations, opts):
        """IRLS outer loop on the host around the inner solve, with the
        motion-refinement seam after it."""
        regs = self.regularizers
        weights = tuple(torch.ones_like(x0) for _ in regs)
        x = x0
        prev_cost = float("inf")
        iteration = 0
        refine_every = opts.refine_motion_every
        refiner = None
        if refine_every > 0:
            refiner = make_shift_refiner(
                self.blur_kernel, self.scale, num_iterations=opts.refine_motion_iterations
            )
        # inf until a refinement round has actually run: with
        # refine_motion_every > 1 the cost can settle before the first
        # refinement is due, and the loop must not end with the requested
        # refinement never made.
        last_refine_delta = float("inf") if refiner is not None else 0.0
        while True:
            t_inner = time.perf_counter()
            result = inner(x, weights)
            # Skip a refinement whose result could never be used: when the
            # iteration cap fires right after this iteration no further inner
            # solve runs, and refining here would only make self.shifts
            # disagree with the motion that produced the returned x.
            cap_next = opts.max_num_irls_iterations > 0 and iteration + 1 >= opts.max_num_irls_iterations
            refined_now = refiner is not None and (iteration + 1) % refine_every == 0 and not cap_next
            scalars = [result.cost.to(torch.float64)]
            if refined_now:
                # Enqueued before the read-back below, so its scalar rides
                # the round's one synchronisation.
                refined = refiner(result.x, observations, self.shifts).to(torch.float64)
                scalars.append((refined - self.shifts).abs().max())
                self.shifts = refined
            values = torch.stack(scalars).tolist()  # waits for the device: the solve is done
            t_call = time.perf_counter() - t_inner
            cost = values[0]
            if refined_now:
                last_refine_delta = values[1]
                if self.verbose:
                    print(
                        "Refined motion against the HR estimate "
                        f"(max shift change {last_refine_delta:.4g} HR px)."
                    )
            x = result.x
            self.last_inner_calls.append((t_call, result.iterations, result.num_evaluations))
            self.last_inner_iterations += result.iterations
            if not regs and refiner is None:
                if self.verbose:
                    print("Least squares done (no regularization terms to reweight).")
                break
            if regs:
                weights = self._reweight(x)
            cost_difference = prev_cost - cost
            prev_cost = cost
            iteration += 1
            if self.verbose:
                print(
                    f"IRLS Iteration complete (#{iteration}). New loss is {cost} "
                    f"with a difference of {cost_difference}."
                )
            # Converged only if the last refinement no longer moves the
            # motion either: a refinement changes the objective, so the cost
            # alone cannot certify joint convergence.
            if (
                abs(cost_difference) < opts.irls_cost_difference_threshold
                and last_refine_delta < opts.refine_motion_delta_threshold
            ):
                break
            if opts.max_num_irls_iterations > 0 and iteration >= opts.max_num_irls_iterations:
                break
        return x
