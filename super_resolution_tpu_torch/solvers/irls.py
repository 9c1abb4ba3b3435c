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
On a mesh that spans processes (``parallel/distributed.py``) every process
runs this loop on its own shards; the seam's assembly gathers the pieces of
the other processes (``Sharded.to_global``), so every process reweights the
whole estimate alike and places its own shards' weights, and ``solve()``
returns the whole estimate in every process. On a pure ``frame`` mesh across
processes the motion refinement runs in every process too, on that gathered
estimate and the whole LR stack each process holds: the same bits in, the
same refined shifts out, so every process's frame shards read the same
motion with no further call between processes.

``fused_irls`` runs the whole solve on the device (:func:`irls_solve_fused`,
:class:`FusedIRLS`), as the JAX package's one XLA program does. On a CUDA
device its steps are CUDA graphs (``solvers/graphs.py``): a *chunk* of steps
of the inner solver (``least_squares.linear_cg_step``: ``CHUNK_ITERATIONS``
iterations, a shorter *tail* chunk ending an inner solve at its iteration
cap; ``least_squares.wolfe_step`` for ``cg`` and ``lbfgs``:
``CHUNK_EVALUATIONS`` line-search trials, which no cap can size; each step
frozen once the inner solve is done), the *seam* between two inner solves
(reweighting into the objective's constant buffers, the motion refinement
into its shift buffer when due, and the IRLS stop test), and the *restart*
of the next inner solve. The host replays the chunk until the one small
tensor it reads back says the inner solve is done, then the seam, then reads
the stop test: one read-back per chunk and one per round, where the host
loop reads one per step. The replays compute what the host loop computes,
op for op. On the CPU the same steps run eagerly with the same read-backs.
The captured graphs and their buffers are kept across solver instances in
``_BUILT_SOLVER_CACHE``: a new solver of the same shapes and options copies
its observations, shifts and estimate into the buffers and replays without
capturing again. ``fused_irls`` takes no checkpoint and, on a CUDA device,
no ``diff_mode="numerical"`` (``ValueError``): a step would be a graph of 2n
evaluations of the forward model. ``autodiff`` is captured as the analytic
mode is.

``fused_irls`` on a mesh runs the same steps on the sharded state, around
the sharded objective bound to fixed buffers (``bind_static``): a step
launches every shard's kernels and does every exchange, and its seam does
what the host loop's seam does (assemble the estimate on the solver's
device, reweight, write the weights into the shards' constants, refine on a
pure frame mesh). With every shard on the solver's device the halo exchange
and the band ring are copies on that device, so one graph captures every
shard of a step. A mesh the sharded objectives cannot run raises
``ValueError`` ("fused_irls on this mesh"), as does a mesh over more than
one device or more than one process: one graph per device is not written.

``solve(x0, checkpoint_path, resume)`` saves the host loop's state at every
IRLS seam (``x``, the weights, the round, the previous cost, the refined
shifts) as the JAX package does, and resumes from it.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from collections import OrderedDict

import numpy as np
import torch

from super_resolution_tpu_torch._device import as_chw, as_tensor
from super_resolution_tpu_torch.image.image_data import ImageData
from super_resolution_tpu_torch.models.image_model import ImageModel
from super_resolution_tpu_torch.motion.refinement import make_shift_refiner
from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
from super_resolution_tpu_torch.solvers.graphs import CapturedStep
from super_resolution_tpu_torch.solvers.least_squares import (
    LinearCGSettings,
    blank_state,
    minimize,
    solver_settings,
    solver_steps,
)
from super_resolution_tpu_torch.solvers.map_solver import IRLSMapSolverOptions
from super_resolution_tpu_torch.solvers.objective import make_map_value_and_grad
from super_resolution_tpu_torch.solvers.solver import MapSolverBase

__all__ = ["IRLSMapSolver", "IRLSMapSolverOptions", "irls_solve_fused", "FusedIRLS"]

# Minimum residual for IRLS reweighting (``irls_map_solver.cpp:34``).
_MIN_RESIDUAL = 1e-5

# Linear-CG steps per replay of the fused solve's chunk graph (fewer in the
# chunk that reaches the iteration cap). A step taken after a stop test
# fired costs a frozen evaluation, a chunk costs a read-back: chosen on the
# card among 8, 16 and the whole inner solve (PERF.md, section 5).
CHUNK_ITERATIONS = 8
# Line-search trials (evaluations) of ``cg`` / ``lbfgs`` per replay: an
# iteration takes one to ``max_bracket + max_zoom`` of them.
CHUNK_EVALUATIONS = 8


def _reweight(regs, x):
    """IRLS weights ``1 / max(1e-5, r(x))``, one per regulariser."""
    return tuple(1.0 / torch.clamp(reg.residuals(x), min=_MIN_RESIDUAL) for reg, _ in regs)


def _refinement(refine, x, observations, shifts):
    """One refinement round: the refined ``[K, 2]`` float64 shifts and their
    largest change (0-d), both on the device."""
    refined = refine(x, observations, shifts).to(torch.float64)
    return refined, (refined - shifts).abs().max()


def _indexed(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _check_fusable(options, mesh=None, device=None) -> None:
    if mesh is not None and mesh.spans_processes:
        raise ValueError(
            f"fused_irls on a mesh that spans processes ({mesh.num_processes}) is not ported: a captured step "
            "cannot hold an all-reduce between processes. Use the host loop (fused_irls=False).")
    if mesh is not None and len({_indexed(d) for d in mesh.unique_devices() + ([device] if device else [])}) > 1:
        raise ValueError(
            f"fused_irls on a mesh over more than one device ({[str(d) for d in mesh.unique_devices()]}, the "
            f"solver on {device}) is not ported: one graph per device has never run on a second card. Use "
            "the host loop (fused_irls=False), or a mesh whose shards all live on the solver's device.")
    if options.diff_mode == "numerical" and device is not None and torch.device(device).type == "cuda":
        raise ValueError(
            "fused_irls on a CUDA device does not take diff_mode='numerical': each gradient is 2n cost "
            "evaluations of the plain forward model, tens to hundreds of small operations each, so a captured "
            "step would hold hundreds of graph nodes per pixel. Use the host loop (fused_irls=False).")


class FusedIRLS:
    """The fused IRLS solve of one problem: its steps, captured as CUDA graphs
    on a CUDA device, and the buffers they read and write.

    ``objective``: ``make_map_value_and_grad(...).bind_static()`` (or a
    sharded objective's ``bind_static(device)``), whose constant, shift and
    observation buffers the steps read. ``refiner``: ``(x, shifts) ->
    (refined float64 shifts, max |change|)`` on the device, or ``None``.
    ``x_like``: a global estimate of the solve's shape, dtype and device. The
    buffers are the inner solver's state (``least_squares.LinearCGState`` or
    ``WolfeState``; sharded values on a mesh, ``objective.place(x_like)``
    shows their layout), the IRLS loop's scalars and :attr:`status`, the
    five float64 values the host reads back: inner solve done, IRLS done,
    inner iterations and objective evaluations so far, and the last cost.

    What an entry pins: the objective's observations, one constant buffer
    per regulariser and the shifts; the state's ``x``, ``g`` and ``d`` (and
    for ``cg`` / ``lbfgs`` the line search's best gradient; for ``lbfgs``
    2 (m + 1) more arrays of ``x``'s size, the memory); and the memory pool
    its graphs share, which holds the largest scratch of any one step (each
    evaluation's LR residual, gradient and partials, a step's image-sized
    temporaries) plus the fold state of every captured evaluation.
    chip_smoke.py measures it on an H100: about 130 MB at the flagship
    (1x1000x1000 float32, 4 frames at 4x, ``linear_cg``), 750 MB for RGB
    3x1000x1000 with motion refinement and 260 MB for the 64-band 256x256
    cube (4 frames at 2x), most of the RGB figure the refinement's scratch;
    with 32 entries a cache of RGB solves pins about 24 GB. An entry dropped
    from the cache frees all of it.
    """

    def __init__(self, objective, regularizers, x_like: torch.Tensor, options, refiner=None):
        self.objective = objective
        self.regs = tuple(regularizers)
        self.refiner = refiner
        self.settings = _fused_settings(options)
        self.start_fn, self.step_fn, self.done_fn = solver_steps(self.settings)
        # A linear-CG chunk never runs past the iteration cap (a shorter tail
        # chunk ends the inner solve there); a line search's trials per
        # iteration vary, so its chunks all have one length.
        self.capped = isinstance(self.settings, LinearCGSettings)
        self.chunk_steps = min(CHUNK_ITERATIONS, self.settings.max_iterations) if self.capped else CHUNK_EVALUATIONS
        self.max_irls = options.max_num_irls_iterations or 10_000
        self.refine_every = options.refine_motion_every if refiner is not None else 0
        self.cost_threshold = options.irls_cost_difference_threshold
        self.delta_threshold = options.refine_motion_delta_threshold
        device = x_like.device

        def scalar(kind):
            return torch.zeros((), dtype=kind, device=device)

        self.state = blank_state(self.settings, objective.place(x_like))
        self.x_shape, self.dtype, self.device = tuple(x_like.shape), x_like.dtype, x_like.device
        # The IRLS loop: the last round's cost, rounds done, inner iterations
        # and evaluations of the rounds done, the last refinement's largest
        # shift change, and the stop test.
        self.prev_cost, self.delta = scalar(torch.float64), scalar(torch.float64)
        self.rounds, self.iterations, self.evaluations = (scalar(torch.int64) for _ in range(3))
        self.done = scalar(torch.bool)
        self.status = torch.zeros(5, dtype=torch.float64, device=device)
        buffers = [t for b in (*self.state, self.prev_cost, self.delta, self.rounds, self.iterations,
                               self.evaluations, self.done, self.status) for t in _tensors(b)]
        buffers += objective.buffers
        # One memory pool for all the steps' graphs (see solvers/graphs.py).
        pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self._step = lambda fn: CapturedStep(fn, device, buffers, pool)  # noqa: E731
        self.begin = self._step(self._begin)
        self.restart = self._step(self._restart)
        self.seam = self._step(lambda: self._seam(refine=False))
        self.seam_refine = None if refiner is None else self._step(lambda: self._seam(refine=True))
        # Chunk graphs by their number of steps: ``chunk_steps``, and for
        # linear CG the shorter tail that ends an inner solve at its cap.
        self.chunks: dict[int, CapturedStep] = {}
        self.last_run: dict = {}

    @property
    def steps(self) -> list[CapturedStep]:
        fixed = (self.begin, self.restart, self.seam, self.seam_refine)
        return [s for s in fixed if s is not None] + list(self.chunks.values())

    def _chunk_of(self, n: int) -> CapturedStep:
        step = self.chunks.get(n)
        if step is None:
            step = self.chunks[n] = self._step(lambda: self._chunk(n))
        return step

    # ------------------------------------------------------------ the steps

    def _store(self, state) -> None:
        for buffer, value in zip(self.state, state):
            if value is not buffer:
                buffer.copy_(value)

    def _publish(self) -> None:
        k, evaluations = _one(self.state.k), _one(self.state.evaluations)
        values = (_one(self.done_fn(self.state, self.settings)), self.done, self.iterations + k,
                  self.evaluations + evaluations, _one(self.state.f))
        self.status.copy_(torch.stack([v.to(torch.float64) for v in values]))

    def _restart(self) -> None:
        # A fresh start: the L-BFGS memory is cleared.
        self._store(self.start_fn(self.objective, self.state.x, self.settings))
        self._publish()

    def _begin(self) -> None:
        ones = torch.ones(self.x_shape, dtype=self.dtype, device=self.device)
        self.objective.set_weights(tuple(ones for _ in self.regs))
        self.prev_cost.fill_(math.inf)
        # inf until a refinement round has run: the requested refinement
        # must run before the joint stop test can pass; 0 without one.
        self.delta.fill_(math.inf if self.refiner is not None else 0.0)
        for counter in (self.rounds, self.iterations, self.evaluations):
            counter.zero_()
        self.done.fill_(False)
        self._restart()

    def _chunk(self, n: int) -> None:
        state = self.state
        for _ in range(n):
            state = self.step_fn(self.objective, state, self.settings)
        self._store(state)
        self._publish()

    def _seam(self, refine: bool) -> None:
        # On a mesh: the estimate in one piece on the solver's device, as the host loop's seam has it.
        x = self.objective.gather(self.state.x)
        cost = _one(self.state.f).to(torch.float64)
        self.iterations.add_(_one(self.state.k))
        self.evaluations.add_(_one(self.state.evaluations))
        self.state.k.fill_(0)
        self.state.evaluations.fill_(0)
        if refine:
            shifts, delta = self.refiner(x, self.objective.shifts)
            self.delta.copy_(delta)
            self.objective.set_shifts(shifts)
        if self.regs:
            self.objective.set_weights(_reweight(self.regs, x))
        difference = self.prev_cost - cost
        self.prev_cost.copy_(cost)
        self.rounds.add_(1)
        if self.regs or self.refiner is not None:
            # Converged only if the last refinement no longer moves the
            # motion either, as in the host loop.
            converged = (torch.abs(difference) < self.cost_threshold) & (self.delta < self.delta_threshold)
            self.done.copy_(converged | (self.rounds >= self.max_irls))
        else:
            self.done.fill_(True)  # least squares alone: one inner solve
        self._publish()

    # ------------------------------------------------------------ the host

    def run(self, x0, observations=None, shifts=None):
        """One solve from ``x0``: ``(x, cost, inner iterations, shifts)``, each
        a copy of what the buffers hold at the end. ``observations`` and
        ``shifts``, when given, are copied into the objective's buffers first
        (a solve of another problem of the same shapes). :attr:`last_run`
        then holds per round ``(seconds, iterations, evaluations)`` and the
        chunks, read-backs, replays and evaluations run (frozen steps
        included) of the solve."""
        self.state.x.copy_(self.objective.place(x0))
        if observations is not None:
            self.objective.set_observations(observations)
        if shifts is not None:
            self.objective.set_shifts(shifts)
        replays = sum(s.replays for s in self.steps)
        rounds, chunks, steps, readbacks = [], 0, 0, 0
        iterations = evaluations = 0
        t0 = time.perf_counter()
        self.begin()
        while True:
            k = 0  # iterations of this inner solve, as the last read-back said
            while True:
                # Frozen steps come only after the inner solve is done.
                n = min(self.chunk_steps, self.settings.max_iterations - k) if self.capped else self.chunk_steps
                self._chunk_of(n)()
                chunks, steps, readbacks = chunks + 1, steps + n, readbacks + 1
                inner_done, _, its, _, _ = self.status.tolist()
                k = int(its) - iterations
                if inner_done:
                    break
            r = len(rounds)
            due = self.refine_every > 0 and (r + 1) % self.refine_every == 0 and r + 1 < self.max_irls
            (self.seam_refine if due else self.seam)()
            _, irls_done, its, evals, cost = self.status.tolist()
            readbacks += 1
            t1 = time.perf_counter()
            rounds.append((t1 - t0, int(its) - iterations, int(evals) - evaluations))
            t0, iterations, evaluations = t1, int(its), int(evals)
            if irls_done:
                break
            self.restart()
        self.last_run = {
            "rounds": rounds, "chunks": chunks, "chunk_steps": self.chunk_steps, "readbacks": readbacks,
            "replays": sum(s.replays for s in self.steps) - replays, "iterations": iterations,
            "evaluations": evaluations, "executed_evaluations": len(rounds) + steps,
            "cost": cost,
        }
        return (self.objective.gather(self.state.x).clone(), _one(self.state.f).clone(), iterations,
                self.objective.shifts.clone())

    def late(self) -> bool:
        """Whether the cost fold of any evaluation in any replay stopped
        waiting for a partial (always ``False`` on the CPU). One read-back."""
        flags = [s.late for s in self.steps if s.late is not None]
        return bool(torch.stack(flags).amax()) if flags else False


def _one(value) -> torch.Tensor:
    """A scalar of the state as one tensor: itself, or a sharded scalar's local copy."""
    return value if isinstance(value, torch.Tensor) else value.local(0)


def _tensors(value) -> list[torch.Tensor]:
    """The tensors a state buffer consists of: itself, a sharded value's local tensors, or none."""
    if value is None:
        return []
    return [value] if isinstance(value, torch.Tensor) else value.distinct_parts()


def irls_solve_fused(
    value_and_grad_builder,
    regularizers,
    x0: torch.Tensor,
    options: IRLSMapSolverOptions,
    return_iterations: bool = False,
    shifts0=None,
    refiner=None,
):
    """The whole IRLS solve on the device; the JAX package's function of the same name.

    ``value_and_grad_builder``: the objective made by
    :func:`~super_resolution_tpu_torch.solvers.objective.make_map_value_and_grad`
    (its ``prepare`` is the JAX builder's counterpart; here the solve binds it
    once to buffers, ``bind_static``). Semantics as in the JAX package: no
    regulariser and no refiner is one inner solve; ``max_num_irls_iterations``
    0 means 10 000; the weights are ``1 / max(1e-5, r)``; with ``refiner``
    ``(x, shifts) -> (new_shifts, max|change|)`` (and ``shifts0``) the shifts
    are refined every ``refine_motion_every`` rounds, never when the
    iteration cap is next, and the stop test needs both ``|cost change| <
    irls_cost_difference_threshold`` and the last refinement's change under
    ``refine_motion_delta_threshold`` (infinite until one has run). Returns
    ``(x, cost)``, then the total inner iterations with
    ``return_iterations``, then the refined shifts with ``refiner``.
    Any ``least_squares_solver``. On a CUDA device the steps are captured and
    replayed as CUDA graphs (:class:`FusedIRLS`); :class:`IRLSMapSolver`
    keeps them for later solves.
    """
    if refiner is not None and (shifts0 is None or options.refine_motion_every <= 0):
        raise ValueError("refiner requires shifts0 and options.refine_motion_every > 0.")
    _check_fusable(options, device=x0.device)
    fused = FusedIRLS(value_and_grad_builder.bind_static(), regularizers, x0, options, refiner)
    x, cost, iterations, shifts = fused.run(x0, shifts=None if refiner is None else shifts0)
    out = (x, cost)
    if return_iterations:
        out = out + (iterations,)
    if refiner is not None:
        out = out + (shifts,)
    return out


# Fused solves built ACROSS solver instances: a video window or a repeated
# solve makes a new IRLSMapSolver, and building again would capture again.
# Keyed by everything the graphs bake in: the channels per round, the
# adjusted options (the gradient mode among them), the inner solver's
# settings (method, L-BFGS memory, initial-step mode, line-search
# constants), the regularisers, the blur, the scale, the shapes, dtype and
# device, the chunk lengths (the shifts are buffer data, never baked).
# LRU-capped: each entry pins its buffers and graph pools (FusedIRLS's docstring).
_BUILT_SOLVER_CACHE: OrderedDict = OrderedDict()
_BUILT_SOLVER_CACHE_MAX = 32


def _fused_settings(options):
    """The inner solver's settings of a fused solve with these options."""
    return solver_settings(
        options.least_squares_solver, options.max_num_solver_iterations, options.gradient_norm_threshold,
        options.cost_decrease_threshold, options.parameter_variation_threshold, options.linear_cg_refresh_every,
        options.num_lbfgs_hessian_corrections)


def _regs_signature(regs):
    return tuple((type(r).__name__, tuple(sorted(vars(r).items())), lam) for r, lam in regs)


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

    def solve(self, initial_estimate, checkpoint_path: str | None = None, resume: bool = False):
        """Run the solver; returns the HR estimate ``[C, H, W]`` on the solver's device.

        An ``ImageData`` initial estimate is read through ``.array`` and the
        estimate comes back as an ``ImageData`` in its spectral mode, as in
        the JAX package (``irls.py:582-588``); any other gives a tensor.

        ``checkpoint_path``: the host loop saves its state at every IRLS seam
        to ``{checkpoint_path}.npz`` (``.round{i}.npz`` per channel round of
        ``split_channels``): ``x``, ``prev_cost``, ``iteration``,
        ``weight_{i}`` and, when refining, ``shifts``. ``resume``: start from
        that file where it exists, placed back on the solver's device (and
        on the mesh's shards)."""
        x = self._solve(as_chw(getattr(initial_estimate, "array", initial_estimate), self.device, self.dtype),
                        checkpoint_path, resume)
        if isinstance(initial_estimate, ImageData):
            return ImageData(x, normalize="never", channel_major=True, spectral_mode=initial_estimate.spectral_mode)
        return x

    def _solve(self, x_full, checkpoint_path, resume) -> torch.Tensor:
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
        if opts.fused_irls and checkpoint_path:
            raise ValueError(
                "fused_irls runs the whole IRLS loop on the device with no checkpoint seam; use the host loop "
                "(fused_irls=False) for checkpoint/resume.")
        if opts.fused_irls:
            _check_fusable(opts, self.mesh, self.device)
        if opts.refine_motion_every > 0 and self.mesh is not None and not self._pure_frame_mesh():
            raise ValueError(
                "refine_motion_every on a mesh requires a pure frame mesh: spatial placements size "
                "their halo from the shifts they were built with, but refinement needs them as "
                "runtime data (the frame-sharded objective carries per-shard shifts)."
            )

        self.last_inner_iterations = 0
        self.last_inner_calls = []
        if opts.fused_irls:
            return self._solve_fused(x_full, opts, channels_per_split)

        results = []
        for i in range(num_rounds):
            ch0, ch1 = i * channels_per_split, (i + 1) * channels_per_split
            observations = self.observations[:, ch0:ch1].contiguous()
            inner = self._build_inner_solver(observations, opts)
            ckpt = None
            if checkpoint_path:
                ckpt = f"{checkpoint_path}.round{i}.npz" if num_rounds > 1 else f"{checkpoint_path}.npz"
            results.append(self._run_irls_loop(inner, x_full[ch0:ch1].contiguous(), observations, opts, ckpt,
                                               resume))
        return torch.cat(results, dim=0)

    # ------------------------------------------------------------------ internals

    def _solve_fused(self, x_full, opts, channels_per_split):
        """Each channel round through one cached :class:`FusedIRLS`
        (``last_fused``); ``last_fused_runs`` keeps each round's
        ``FusedIRLS.last_run``."""
        fused = self.last_fused = self._build_fused_solver(opts, channels_per_split)
        self.last_fused_runs = []
        results = []
        for i in range(self.num_channels // channels_per_split):
            ch0, ch1 = i * channels_per_split, (i + 1) * channels_per_split
            x, cost, iterations, shifts = fused.run(x_full[ch0:ch1], self.observations[:, ch0:ch1], self.shifts)
            if opts.refine_motion_every > 0:
                # Later channel rounds and later solve() calls start from the refined motion.
                self.shifts = shifts
            self.last_inner_iterations += iterations
            self.last_inner_calls.extend(fused.last_run["rounds"])
            self.last_fused_runs.append(fused.last_run)
            if self.verbose:
                print(f"Fused IRLS round {i} done; final loss {fused.last_run['cost']}.")
            results.append(x)
        return torch.cat(results, dim=0)

    def _build_fused_solver(self, opts, channels_per_split):
        """The :class:`FusedIRLS` for this solve, from ``_BUILT_SOLVER_CACHE`` or built."""
        k, _, h, w = self.observations.shape
        kern = self.blur_kernel
        mesh = self.mesh
        # A tiled objective sizes its halo from the shifts it is built with, and
        # refuses later shifts that reach further: such a solve is built anew.
        reach = math.ceil(float(self.shifts.abs().max())) if self._spatial_mesh() else None
        key = (
            channels_per_split, repr(opts), _fused_settings(opts), _regs_signature(self.regularizers),
            None if kern is None else (kern.shape, np.asarray(kern, dtype=np.float64).tobytes()),
            self.scale, (k, channels_per_split, h, w), self.dtype, str(self.device), CHUNK_ITERATIONS,
            CHUNK_EVALUATIONS,
            None if mesh is None else (tuple(mesh.shape.items()), tuple(str(d) for d in mesh.devices), reach),
        )
        fused = _BUILT_SOLVER_CACHE.get(key)
        if fused is not None:
            _BUILT_SOLVER_CACHE.move_to_end(key)
            return fused
        observations = torch.zeros((k, channels_per_split, h, w), dtype=self.dtype, device=self.device)
        if mesh is None:
            objective = make_map_value_and_grad(
                observations, self.shifts, kern, self.scale, self.regularizers,
                diff_mode=opts.diff_mode, device=self.device, dtype=self.dtype,
            ).bind_static()
        else:
            try:
                vg = self._mesh_objective(observations, opts)
            except ValueError as exc:
                raise ValueError(f"fused_irls on this mesh: {exc}") from exc
            objective = vg.bind_static(self.device)
        refiner = None
        if opts.refine_motion_every > 0:
            refine = make_shift_refiner(kern, self.scale, num_iterations=opts.refine_motion_iterations)
            refiner = lambda x, shifts: _refinement(refine, x, objective.observations, shifts)  # noqa: E731
        x_like = torch.zeros((channels_per_split,) + self.hr_shape[1:], dtype=self.dtype, device=self.device)
        fused = FusedIRLS(objective, self.regularizers, x_like, opts, refiner)
        _BUILT_SOLVER_CACHE[key] = fused
        while len(_BUILT_SOLVER_CACHE) > _BUILT_SOLVER_CACHE_MAX:
            _BUILT_SOLVER_CACHE.popitem(last=False)
        return fused

    def _pure_frame_mesh(self) -> bool:
        """True when every mesh axis but ``frame`` has size 1: the placement
        where the shifts are per-shard runtime data and ``x`` is replicated."""
        from super_resolution_tpu_torch.parallel.mesh import FRAME_AXIS

        return self.mesh is not None and all(n == 1 for name, n in self.mesh.shape.items() if name != FRAME_AXIS)

    def _spatial_mesh(self) -> bool:
        """True when the mesh tiles the image over ``row`` / ``col``."""
        from super_resolution_tpu_torch.parallel.mesh import COL_AXIS, ROW_AXIS

        return self.mesh is not None and (ROW_AXIS in self.mesh.shape or COL_AXIS in self.mesh.shape)

    def _mesh_objective(self, observations, opts):
        """The sharded objective this mesh routes to, or ``ValueError`` with the reasons."""
        from super_resolution_tpu_torch.parallel.halo import make_tiled_vg
        from super_resolution_tpu_torch.parallel.mesh import BAND_AXIS, COL_AXIS, FRAME_AXIS, ROW_AXIS
        from super_resolution_tpu_torch.parallel.sharded_objective import (
            make_band_sharded_vg,
            make_frame_sharded_vg,
        )

        mesh, regs, scale = self.mesh, tuple(self.regularizers), self.scale
        k, channels = observations.shape[0], observations.shape[1]
        n_frame, n_band = mesh.size(FRAME_AXIS), mesh.size(BAND_AXIS)
        spatial = self._spatial_mesh()
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
        if opts.diff_mode != "analytic":
            reasons.append(f"diff_mode {opts.diff_mode!r} has no sharded objective (the sharded objectives "
                           "launch the analytic kernels per shard)")
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
                memory=opts.num_lbfgs_hessian_corrections,
                linear_cg_refresh_every=opts.linear_cg_refresh_every,
                log_iterations=self.verbose,
            )

        return inner

    def _reweight(self, x):
        return _reweight(self.regularizers, x)

    def _run_irls_loop(self, inner, x0, observations, opts, checkpoint_path=None, resume=False):
        """IRLS outer loop on the host around the inner solve, with the
        motion-refinement seam after it, and optional checkpoint/resume: the
        state saved at the seam (x, the weights, the round, the previous
        cost, the refined shifts) is what the reference's iteration-complete
        hook exposes; the reference itself persists nothing."""
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
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            with np.load(checkpoint_path) as state:
                x = self._place(as_tensor(state["x"], self.device, self.dtype))
                weights = tuple(self._place(as_tensor(state[f"weight_{i}"], self.device, self.dtype))
                                for i in range(len(regs)))
                prev_cost = float(state["prev_cost"])
                iteration = int(state["iteration"])
                if "shifts" in state.files:  # a refined solve checkpoints its evolving shifts
                    self.shifts = as_tensor(state["shifts"], self.device, torch.float64)
            if self.verbose:
                print(f"Resumed IRLS from {checkpoint_path} at iteration {iteration}.")
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
                self.shifts, delta = _refinement(refiner, x_whole, observations, self.shifts)
                scalars.append(delta)
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
            whole_weights = self._reweight(x_whole) if regs else ()
            weights = tuple(self._place(w) for w in whole_weights)
            cost_difference = prev_cost - cost
            prev_cost = cost
            iteration += 1
            if self.verbose:
                print(
                    f"IRLS Iteration complete (#{iteration}). New loss is {cost} "
                    f"with a difference of {cost_difference}."
                )
            if checkpoint_path:
                payload = {"x": (x_whole if x_whole is not None else self._gather(x)).cpu().numpy(),
                           "prev_cost": prev_cost, "iteration": iteration}
                if refiner is not None:
                    payload["shifts"] = self.shifts.cpu().numpy()
                for i, w in enumerate(whole_weights):
                    payload[f"weight_{i}"] = w.cpu().numpy()
                np.savez(checkpoint_path, **payload)
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
