"""Frame- and band-sharded MAP solving over a device mesh.

The counterpart of the JAX package's ``parallel/data_parallel.py``:

- **Frame parallelism**: :func:`shard_problem` splits the LR stack
  ``[K, C, h, w]`` and the shifts ``[K, 2]`` over the ``frame`` axis (and the
  channels over ``band``); the estimate is replicated along ``frame``. One
  evaluation of :func:`make_sharded_map_solver`'s objective launches the
  fused kernels once per shard and makes one ``psum`` of the cost and the
  gradient (``parallel/sharded_objective.py``); the inner solve runs in
  lockstep on every shard, as the JAX package's ``lax.while_loop`` does.
- **Band parallelism**: the channel axis of both ``x`` and the observations.
  :func:`band_split_minimize` solves each band on its own
  (``split_channels`` semantics): one batched solve whose every scalar is per
  band, so each band has its own line search and stop test, and the result
  equals one ``minimize`` per band bit for bit. On a mesh that spans
  processes each process solves the bands that lie wholly in it, with no
  call between processes inside the solve, and two all-gathers at the end
  give every process the whole result.

Where the JAX package annotates shardings and lets the compiler insert the
collectives, the port places the pieces itself (:class:`~.sharded.Sharded`)
and its objective says what crosses (``parallel/collectives.py``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from super_resolution_tpu_torch.parallel import distributed
from super_resolution_tpu_torch.parallel.mesh import BAND_AXIS, COL_AXIS, FRAME_AXIS, ROW_AXIS, Mesh
from super_resolution_tpu_torch.parallel.sharded import Elementwise, Sharded
from super_resolution_tpu_torch.parallel.sharded_objective import (
    OBSERVATIONS_PARTITION,
    X_PARTITION,
    make_sharded_vg,
)
from super_resolution_tpu_torch.solvers import least_squares
from super_resolution_tpu_torch.solvers.least_squares import MinimizeResult, minimize

__all__ = ["shard_problem", "make_sharded_map_solver", "band_split_minimize"]


def _tensor(value, dtype) -> torch.Tensor:
    return value.to(dtype) if isinstance(value, torch.Tensor) else torch.tensor(np.asarray(value), dtype=dtype)


def shard_problem(mesh: Mesh, x0, observations, shifts):
    """Place the problem on the mesh: ``(x0, observations, shifts)`` as
    :class:`Sharded` values. Observations are split over ``frame`` (and
    channels over ``band``), shifts over ``frame``; ``x0`` is split over
    ``band``, replicated along ``frame``. On a ``row`` / ``col`` mesh ``x0``
    and the observations are tiled as well (the port's tiled objective reads
    tiles; the JAX function leaves them replicated there).

    ``x0``: ``[C, H, W]`` tensor (its dtype is the problem's; numpy arrays are
    float32), observations ``[K, C, h, w]``, shifts ``[K, 2]`` (placed as
    float64). Each process places only its own shards.
    """
    x0 = _tensor(x0, torch.float32) if not isinstance(x0, torch.Tensor) else x0
    observations = _tensor(observations, x0.dtype)
    shifts = _tensor(shifts, torch.float64).reshape(-1, 2)
    return (Sharded.from_global(mesh, x0, X_PARTITION),
            Sharded.from_global(mesh, observations, OBSERVATIONS_PARTITION),
            Sharded.from_global(mesh, shifts, {FRAME_AXIS: 0}))


def make_sharded_map_solver(
    mesh: Mesh,
    blur_kernel,
    scale: int,
    regularizers: Sequence[tuple[object, float]] = (),
    max_shift: int = 16,
    method: str = "cg",
    max_iterations: int = 50,
    gradient_norm_threshold: float = 1e-6,
    cost_decrease_threshold: float = 1e-6,
    parameter_variation_threshold: float = 1e-6,
):
    """Build ``solve_step(x0, observations, shifts, weights=()) -> MinimizeResult``.

    ``x0``, ``observations`` and ``shifts`` as :func:`shard_problem` places
    them (global tensors are placed first); ``weights``: per-regulariser IRLS
    weights, global ``[C, H, W]`` tensors or :class:`Sharded`. The inner solve
    is ``minimize`` on the sharded state with the sharded objective (one
    launch per shard and one ``psum`` per evaluation); the result's ``x`` is
    sharded like ``x0``, its ``cost`` and ``grad_norm`` 0-d tensors on this
    process's first shard's device.

    The objective is built once per shape and dtype of the observations and
    reads the placed observations and shifts of each call as they are. On a
    ``row`` / ``col`` mesh its halo width comes from the shifts, so there it
    is built once per set of shift values too. ``max_shift`` is taken for
    the JAX signature's sake and not used: the JAX package sizes its Pallas
    kernel's windows from it, the CUDA kernels take any shift.
    """
    del max_shift  # the CUDA kernels take any shift
    regs = tuple(regularizers)
    built: dict[tuple, Callable] = {}
    spatial = ROW_AXIS in mesh.shape or COL_AXIS in mesh.shape

    def solve_step(x0, observations, shifts, weights=()) -> MinimizeResult:
        if not all(isinstance(v, Sharded) for v in (x0, observations, shifts)):
            x0, observations, shifts = shard_problem(
                mesh, *(v.to_global() if isinstance(v, Sharded) else v for v in (x0, observations, shifts)))
        key = (observations.shape, x0.dtype)
        if spatial:
            key += (tuple(shifts.to_global().reshape(-1).tolist()),)
        vg = built.get(key)
        if vg is None:
            vg = built[key] = make_sharded_vg(mesh, observations, shifts, blur_kernel, scale, regs, dtype=x0.dtype)
        bound = vg.prepare(tuple(weights), shifts=None if spatial else shifts, observations=observations)
        result = minimize(
            bound, x0, method=method, max_iterations=max_iterations,
            gradient_norm_threshold=gradient_norm_threshold, cost_decrease_threshold=cost_decrease_threshold,
            parameter_variation_threshold=parameter_variation_threshold,
        )
        return result._replace(cost=result.cost.local(0), grad_norm=result.grad_norm.local(0))

    return solve_step


class _BandStack(Elementwise):
    """Independent problems stacked along dimension 0, for ``minimize``'s step
    functions: elementwise algebra on the whole stack (one operation for
    every band), dots and the loop's scalars per problem (shape ``[C, 1,
    ...]``, which broadcasts against the stack). Each problem's dot is the
    ``torch.dot`` a lone solve of that problem computes."""

    def __init__(self, tensor: torch.Tensor):
        self.t = tensor

    @classmethod
    def _apply(cls, func, args, kwargs):
        unwrap = lambda a: a.t if isinstance(a, _BandStack) else a  # noqa: E731
        out = func(*[unwrap(a) for a in args], **{k: unwrap(v) for k, v in kwargs.items()})
        return _BandStack(out) if isinstance(out, torch.Tensor) else out

    @property
    def dtype(self) -> torch.dtype:
        return self.t.dtype

    @property
    def ndim(self) -> int:
        return self.t.ndim

    def scalar_shape(self) -> tuple[int, ...]:
        return (self.t.shape[0],) + (1,) * (self.t.ndim - 1)

    def vdot(self, other: "_BandStack") -> torch.Tensor:
        a, b = self.t, other.t
        return torch.stack([torch.dot(a[i].reshape(-1), b[i].reshape(-1)) for i in range(a.shape[0])]).reshape(
            self.scalar_shape())

    def new_full(self, size, value) -> torch.Tensor:
        return torch.full(tuple(size) + self.scalar_shape(), value, dtype=self.t.dtype, device=self.t.device)


def band_split_minimize(value_and_grad_per_band, x0: torch.Tensor, method: str = "cg", **options) -> MinimizeResult:
    """Solve each band of ``x0`` ``[C, H, W]`` on its own (``split_channels``
    semantics, ``irls_map_solver.cpp:200-229``) in ONE batched solve.

    ``value_and_grad_per_band``: ``xc -> (cost, grad)`` on one ``[1, H, W]``
    band, the same for every band (the JAX package's form), or a sequence of
    ``C`` such functions, band ``c``'s own first (its own observations).
    ``options``: ``minimize``'s (``max_iterations``, the three thresholds,
    ``memory``, ``line_search``, ``initial_step_mode``,
    ``linear_cg_refresh_every``).

    One state holds every band; the step is ``minimize``'s, with each
    scalar (step length, ``beta``, cost, line-search state, stop flags) one
    per band. A band whose stop test fired is frozen by the step's mask and
    costs no evaluation: each step evaluates the bands that were still
    running at the last read-back, one call of its function each (2 kernel
    launches on a card), and the step then reads back the C stop flags. So
    band ``c`` takes the iterations, evaluations and values that
    ``minimize(value_and_grad_per_band[c], x0[c:c+1], method, **options)``
    takes, bit for bit.

    Returns a ``MinimizeResult`` whose ``x`` is ``[C, H, W]``, ``cost`` and
    ``grad_norm`` ``[C]`` tensors, and ``iterations``, ``converged`` and
    ``num_evaluations`` lists with one entry per band.

    A :class:`Sharded` ``x0`` is assembled first. On a mesh that spans
    processes each process solves, in one batched solve, the bands whose
    shards all lie in it (a band lies in the shards of its ``band``
    coordinate) and calls only those bands' functions: each band keeps its
    own line search, stop test and dot products, with no call between
    processes during the solve. Two all-gathers then give every process the
    whole result, bit for bit alike (:func:`_gather_bands`). A band whose
    shards lie in more than one process raises ``ValueError``.
    """
    if isinstance(x0, Sharded) and x0.mesh.spans_processes:
        return _band_split_across_processes(value_and_grad_per_band, x0, method, **options)
    if isinstance(x0, Sharded):
        x0 = x0.to_global()
    bands = x0.shape[0]
    functions = (list(value_and_grad_per_band) if isinstance(value_and_grad_per_band, (list, tuple))
                 else [value_and_grad_per_band] * bands)
    if len(functions) != bands:
        raise ValueError(f"{len(functions)} per-band objectives for {bands} bands.")
    settings = least_squares.solver_settings(method, **{
        "max_iterations": 50, "gradient_norm_threshold": 1e-6, "cost_decrease_threshold": 1e-6,
        "parameter_variation_threshold": 1e-6, **options})
    start, step, done = least_squares.solver_steps(settings)
    running = [True] * bands
    frozen_cost = torch.zeros((), dtype=x0.dtype, device=x0.device)
    frozen_grad = torch.zeros((1,) + tuple(x0.shape[1:]), dtype=x0.dtype, device=x0.device)

    def evaluate(x: _BandStack):
        costs, grads = [], []
        for band, (fn, go) in enumerate(zip(functions, running)):
            # A frozen band's step ignores what it is handed: no launch for it.
            cost, grad = fn(x.t[band: band + 1]) if go else (frozen_cost, frozen_grad)
            costs.append(cost.to(x0.dtype))
            grads.append(grad)
        return torch.stack(costs).reshape((bands,) + (1,) * (x0.ndim - 1)), _BandStack(torch.cat(grads))

    state = start(evaluate, _BandStack(x0.contiguous()), settings)
    while True:
        stopped = done(state, settings).reshape(-1).tolist()  # the step's one read-back
        if all(stopped):
            break
        running = [not s for s in stopped]
        state = step(evaluate, state, settings)
    norms = torch.sqrt(state.g.vdot(state.g)).reshape(-1)
    k, evaluations, converged = (v.reshape(-1).tolist() for v in (state.k, state.evaluations, state.converged))
    return MinimizeResult(x=state.x.t, cost=state.f.reshape(-1), grad_norm=norms, iterations=k,
                          converged=[bool(c) for c in converged], num_evaluations=evaluations)


def _band_owners(mesh: Mesh, channels: int) -> list[int]:
    """The process that holds each channel: that of every shard of its
    ``band`` coordinate, or ``ValueError`` where they lie in several."""
    per_band = channels // mesh.size(BAND_AXIS)
    owners = []
    for channel in range(channels):
        band = channel // per_band
        holders = {mesh.processes[i] for i in range(mesh.num_shards) if mesh.coords(i).get(BAND_AXIS, 0) == band}
        if len(holders) > 1:
            raise ValueError(
                f"band_split_minimize across processes: band {channel} lies in the shards of processes "
                f"{sorted(holders)} (mesh {mesh.shape}); each band must lie wholly in one process.")
        owners.append(holders.pop())
    return owners


def _local_bands(x0: Sharded, channels: list[int]) -> torch.Tensor:
    """``channels`` of the value, assembled from this process's shards on its first shard's device."""
    mesh = x0.mesh
    row = {c: i for i, c in enumerate(channels)}
    out = torch.empty((len(channels),) + tuple(x0.shape[1:]), dtype=x0.dtype, device=x0.local(0).device)
    for shard in mesh.local_shards:
        part, view = x0.parts[shard], out
        for axis, dim in x0.partition.items():
            if dim:
                view = view.narrow(dim, mesh.coords(shard)[axis] * part.shape[dim], part.shape[dim])
        first = mesh.coords(shard).get(BAND_AXIS, 0) * part.shape[0]
        for j in range(part.shape[0]):
            view[row[first + j]].copy_(part[j])
    return out


def _band_split_across_processes(functions, x0: Sharded, method: str, **options) -> MinimizeResult:
    mesh = x0.mesh
    channels = x0.shape[0]
    if x0.partition.get(BAND_AXIS) != 0 or any(dim == 0 for axis, dim in x0.partition.items() if axis != BAND_AXIS):
        raise ValueError(f"band_split_minimize takes x0 split along dimension 0 by 'band' only, not {x0.partition}.")
    owners = _band_owners(mesh, channels)
    functions = list(functions) if isinstance(functions, (list, tuple)) else [functions] * channels
    if len(functions) != channels:
        raise ValueError(f"{len(functions)} per-band objectives for {channels} bands.")
    mine = [c for c in range(channels) if owners[c] == mesh.process_index]
    local = band_split_minimize([functions[c] for c in mine], _local_bands(x0, mine), method, **options)
    return _gather_bands(local, owners, mesh)


def _gather_bands(local: MinimizeResult, owners: list[int], mesh: Mesh) -> MinimizeResult:
    """Every process's bands in channel order, in every process: one all-gather
    of each process's estimates with their cost and gradient norm (in the
    estimate's dtype, padded to the most bands a process holds), one of the
    iterations, stop flags and evaluations (int64)."""
    x = local.x
    slots = max(owners.count(p) for p in set(mesh.processes))
    n, pixels = x.shape[0], int(np.prod(x.shape[1:]))
    values = x.new_zeros((slots, pixels + 2))
    values[:n, :pixels] = x.reshape(n, -1)
    values[:n, pixels] = local.cost.to(x.dtype)
    values[:n, pixels + 1] = local.grad_norm.to(x.dtype)
    counters = torch.zeros((slots, 3), dtype=torch.int64)
    for i, row in enumerate(zip(local.iterations, local.converged, local.num_evaluations)):
        counters[i] = torch.tensor([int(v) for v in row])
    values, counters = distributed.all_gather(values), distributed.all_gather(counters.to(x.device))
    order = [(owners[c], owners[:c].count(owners[c])) for c in range(len(owners))]
    rows = torch.stack([values[p, slot] for p, slot in order])
    counts = torch.stack([counters[p, slot] for p, slot in order]).tolist()
    return MinimizeResult(x=rows[:, :pixels].reshape((len(owners),) + tuple(x.shape[1:])),
                          cost=rows[:, pixels].contiguous(), grad_norm=rows[:, pixels + 1].contiguous(),
                          iterations=[c[0] for c in counts], converged=[bool(c[1]) for c in counts],
                          num_evaluations=[c[2] for c in counts])
