"""IRLS MAP solver — the production solver (equivalent of
``src/optimization/irls_map_solver.cpp``), on one device or on a device mesh.

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

With ``mesh=`` (``parallel/mesh.py``) the inner solves run on sharded state:
spatial axes route to the tiled objective with halo exchange, a ``frame``
axis larger than 1 to the frame-sharded objective, anything else to the
band-sharded one (``parallel/``), each launching the fused kernels once per
shard. ``x`` stays sharded from one inner solve to the next. At the seam
between two IRLS rounds the estimate is assembled on the solver's device,
reweighted there by the same code as without a mesh (so the weights are the
single-device ones exactly), and the weights are placed on the shards again;
motion refinement runs there too, on the assembled estimate. ``solve()``
takes and returns global ``[C, H, W]`` tensors. A mesh configuration that
fits none of the sharded objectives raises ``ValueError``: there is no
second path to fall to, and a quiet single-device solve would hide the mesh.

Not ported yet: the fused on-device IRLS loop, checkpoint/resume and the
cross-instance solver cache.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from super_resolution_tpu_torch._device import as_chw, as_tensor
from super_resolution_tpu_torch.models.image_model import ImageModel
from super_resolution_tpu_torch.motion.refinement import make_shift_refiner
from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
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
        mesh=None,
    ):
        """``low_res_images``: ``[C, h, w]`` numpy arrays or tensors. The whole
        solve runs on ``device`` in ``dtype``; a CUDA device that is not there
        raises. ``mesh``: a ``parallel.mesh.Mesh`` (``make_mesh``) to spread
        the inner solves over; ``device`` is then where estimates are taken,
        assembled between rounds and returned."""
        super().__init__(image_model, low_res_images, print_solver_output, device, dtype)
        self.options = options
        self.mesh = mesh
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
        if opts.refine_motion_every > 0 and self.mesh is not None and not self._pure_frame_mesh():
            raise ValueError(
                "refine_motion_every on a mesh requires a pure frame mesh: spatial placements size "
                "their halo from the shifts they were built with, but refinement needs them as "
                "runtime data (the frame-sharded objective carries per-shard shifts)."
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

    def _pure_frame_mesh(self) -> bool:
        """True when every mesh axis but ``frame`` has size 1: the placement
        where the shifts are per-shard runtime data and ``x`` is replicated."""
        from super_resolution_tpu_torch.parallel.mesh import FRAME_AXIS

        return self.mesh is not None and all(n == 1 for name, n in self.mesh.shape.items() if name != FRAME_AXIS)

    def _mesh_objective(self, observations, opts):
        """The sharded objective this mesh routes to, or ``ValueError`` with the reasons."""
        from super_resolution_tpu_torch.parallel.halo import make_tiled_vg
        from super_resolution_tpu_torch.parallel.mesh import BAND_AXIS, COL_AXIS, FRAME_AXIS, ROW_AXIS
        from super_resolution_tpu_torch.parallel.sharded_objective import (
            make_band_sharded_vg,
            make_frame_sharded_vg,
        )

        mesh, regs, scale = self.mesh, tuple(self.regularizers), self.scale
        if opts.diff_mode != "analytic":
            raise NotImplementedError(f"diff_mode {opts.diff_mode!r} is not ported yet; use 'analytic'.")
        k, channels = observations.shape[0], observations.shape[1]
        n_frame, n_band = mesh.size(FRAME_AXIS), mesh.size(BAND_AXIS)
        spatial = ROW_AXIS in mesh.shape or COL_AXIS in mesh.shape
        fusable = (TotalVariationRegularizer, BilateralTotalVariationRegularizer)
        reasons = []
        if spatial:
            path, build = "tiled", make_tiled_vg
            if len(regs) > 1 or any(
                    not isinstance(r, fusable) or getattr(r, "use_3d", False) for r, _ in regs):
                reasons.append("regularizers not tileable (need exactly <=1 2D TV or BTV term)")
            n_row, n_col = mesh.size(ROW_AXIS), mesh.size(COL_AXIS)
            _, h_hr, w_hr = self.hr_shape
            if h_hr % (n_row * scale) or w_hr % (n_col * scale):
                reasons.append(f"HR shape {(h_hr, w_hr)} not divisible into {n_row}x{n_col} scale-aligned tiles")
        else:
            path = "sharded"
            build = make_frame_sharded_vg if n_frame > 1 else make_band_sharded_vg
            if len(regs) > 1 or any(not isinstance(r, fusable) for r, _ in regs):
                reasons.append("regularizers not kernel-fusable (need exactly <=1 TV/BTV term)")
            if n_frame == 1 and BAND_AXIS not in mesh.shape:
                reasons.append("a mesh without spatial axes needs a 'frame' axis larger than 1 or a 'band' axis")
        if channels % n_band:
            reasons.append(f"{channels} channels not divisible by the band axis ({n_band})")
        if k % n_frame:
            reasons.append(f"{k} frames not divisible by the frame axis ({n_frame})")
        if reasons:
            raise ValueError(
                f"The mesh {mesh.shape} cannot run this solve on the {path} objective: " + "; ".join(reasons) + ".")
        return build(mesh, observations, self.shifts, self.blur_kernel, scale, regs, dtype=self.dtype)

    # Between global tensors and the state of an inner solve: the identity
    # without a mesh; _build_inner_solver replaces them on a mesh.
    @staticmethod
    def _place(value):
        return value

    _gather = _place

    def _build_inner_solver(self, observations, opts):
        """``inner(x0, weights) -> MinimizeResult`` on the solve's state."""
        if self.mesh is not None:
            vg = self._mesh_objective(observations, opts)
            self._place, self._gather = vg.place, lambda value: value.to_global(self.device)
        else:
            vg = make_map_value_and_grad(
                observations, self.shifts, self.blur_kernel, self.scale, self.regularizers,
                diff_mode=opts.diff_mode, device=self.device, dtype=self.dtype,
            )

        # Refined motion reaches the objective as data; a mesh other than a
        # pure frame mesh never refines and keeps the shifts it was built with.
        follows_motion = self.mesh is None or self._pure_frame_mesh()

        def inner(x0, weights):
            return minimize(
                vg.prepare(weights, self.shifts if follows_motion else None),
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
        weights = tuple(self._place(torch.ones_like(x0)) for _ in regs)
        x = self._place(x0)  # the solve's state: sharded from here to the return on a mesh
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
            cost_t = result.cost if isinstance(result.cost, torch.Tensor) else result.cost.local(0)
            scalars = [cost_t.to(device=self.device, dtype=torch.float64)]
            # The seam: the estimate in one piece on the solver's device, for
            # the refiner and the reweighting (without a mesh it is x itself).
            x_whole = self._gather(result.x) if (regs or refiner is not None) else None
            if refined_now:
                # Enqueued before the read-back below, so its scalar rides
                # the round's one synchronisation.
                refined = refiner(x_whole, observations, self.shifts).to(torch.float64)
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
                weights = tuple(self._place(w) for w in self._reweight(x_whole))
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
        return x_whole if x_whole is not None else self._gather(x)
