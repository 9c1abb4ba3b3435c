"""The MAP objective on a device mesh: the fused kernels once per shard.

Counterpart of the JAX package's ``parallel/pallas_sharded.py`` (whose
``shard_map`` bodies launch the Pallas kernel per device). Each shard holds
its part of the problem on its own device for good — its bands of ``x``, of
the observations and of the IRLS constants, its frames and its rows of the
``[K, 2]`` shift tensor — and one evaluation is one launch of
:func:`~super_resolution_tpu_torch.ops.cuda.degrade.fused_objective` per
shard (the CUDA kernels for shards on a card, the plain version for shards
on the CPU) plus what must cross (``parallel/collectives.py``):

- ``band``: the data term and 2D TV / BTV never mix channels, so only the
  0-d cost is summed. 3D spectral TV couples neighbouring bands: every band
  shard takes the next shard's first band as a read-only halo channel (the
  kernels' spectral-halo mode; zero constants and a zero observation band
  there) and hands the gradient that lands in it back to its owner.
- ``frame``: every shard evaluates its own frames with its own shifts, which
  are runtime data of the kernels. ``x`` and the constants are replicated
  along ``frame``, so each frame shard evaluates the whole regulariser:
  ``lambda`` is divided by the number of frame shards, and cost and gradient
  are summed over ``frame``.
- ``row`` / ``col``: see ``parallel/halo.py``, which builds on
  :func:`make_sharded_vg` too.

The axes compose: one function serves any mesh, the public ones check
that a mesh is of their kind. Not carried over from the JAX module, because
they size or route its TPU kernel only: ``pallas_tile``, ``interpret``,
``phase_io``, ``shift_bound`` and the tile / channel-block choosers.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from super_resolution_tpu_torch._device import as_tensor
from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu_torch.ops.cuda.degrade import fused_objective
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
from super_resolution_tpu_torch.parallel.collectives import (
    halo_gather,
    halo_scatter_sum,
    psum_together,
    spectral_halo_extend,
    spectral_halo_return,
)
from super_resolution_tpu_torch.parallel.mesh import BAND_AXIS, COL_AXIS, FRAME_AXIS, ROW_AXIS, Mesh
from super_resolution_tpu_torch.parallel.sharded import Sharded
from super_resolution_tpu_torch.solvers.least_squares import minimize

__all__ = [
    "required_halo",
    "make_sharded_vg",
    "make_band_sharded_vg",
    "make_frame_sharded_vg",
    "make_band_sharded_solver",
]

X_PARTITION = {BAND_AXIS: 0, ROW_AXIS: 1, COL_AXIS: 2}
OBSERVATIONS_PARTITION = {FRAME_AXIS: 0, BAND_AXIS: 1, ROW_AXIS: 2, COL_AXIS: 3}


def required_halo(max_shift: float, kernel_size: int) -> int:
    """Stencil footprint of warp+blur: ceil(|shift|) + 1 (bilinear) + k//2."""
    return int(math.ceil(abs(max_shift))) + 1 + kernel_size // 2


def _to_numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _placed_shape(mesh: Mesh, placed: Sharded) -> list[int]:
    """The global shape of observations placed as ``data_parallel.shard_problem`` places them."""
    expected = {axis: dim for axis, dim in OBSERVATIONS_PARTITION.items() if mesh.size(axis) > 1}
    if placed.mesh is not mesh or placed.partition != expected:
        raise ValueError("Placed observations must be split over this mesh as shard_problem splits them.")
    return list(placed.shape)


def make_sharded_vg(
    mesh: Mesh,
    observations,
    shifts,
    blur_kernel,
    scale: int,
    regularizers: Sequence[tuple[object, float]] = (),
    dtype: torch.dtype = torch.float32,
):
    """Build ``value_and_grad(x, weights=(), shifts=None) -> (cost, grad)`` over ``mesh``.

    ``observations``: global ``[K, C, H/s, W/s]`` (numpy array or tensor), or
    a :class:`Sharded` placed by ``data_parallel.shard_problem`` (its shards'
    tensors are used as they are where no padding is needed), ``shifts``:
    ``[K, 2]``, ``blur_kernel``: 2D or ``None``. They are split and placed on
    the shards' devices once, here. ``x`` and the IRLS
    ``weights`` are :class:`Sharded` (``value_and_grad.place(tensor)`` makes
    one from a global ``[C, H, W]`` tensor) and so is the result: a
    replicated 0-d cost and a gradient sharded like ``x``. A global tensor
    is accepted for ``x`` as well; cost and gradient then come back as
    global tensors on its device.

    ``value_and_grad.prepare(weights, shifts=None, observations=None)`` binds
    the weights and computes the padded ``lambda * w`` constants once for a
    whole inner solve; ``shifts`` (``[K, 2]``, or placed) replaces the motion
    given here (frame and band meshes only: on a spatial mesh the halo width
    was fixed from the shifts given at build time), ``observations`` (placed,
    of the same shape) the LR stack. ``value_and_grad.bind_static(device)`` binds it once to
    buffers that later calls update in place, for the fused IRLS solve (see
    its docstring).

    One evaluation launches the fused objective once per shard and makes one
    ``psum`` (``collectives.psum_together``): the cost over every shard and,
    with a ``frame`` axis, the gradient over ``frame``, in one all-reduce
    where the mesh spans processes.

    At most one regulariser, 2D / 3D TV or BTV, is fused; 3D TV on a spatial
    mesh is refused (band coupling and spatial tiling would need both halo
    systems at once).
    """
    regs = tuple(regularizers)
    if len(regs) > 1:
        raise ValueError("The fused kernel supports at most one regularizer.")
    fuse_tv = bool(regs) and isinstance(regs[0][0], TotalVariationRegularizer)
    fuse_btv = bool(regs) and isinstance(regs[0][0], BilateralTotalVariationRegularizer)
    if regs and not (fuse_tv or fuse_btv):
        raise ValueError(f"Unsupported regularizer type: {type(regs[0][0])!r}")
    fuse_tv3d = fuse_tv and regs[0][0].use_3d
    spatial = ROW_AXIS in mesh.shape or COL_AXIS in mesh.shape
    if spatial and fuse_tv3d:
        raise ValueError("3D spectral TV is not supported on spatial meshes (band coupling + spatial tiling).")
    unknown = sorted(set(mesh.axis_names) - {FRAME_AXIS, BAND_AXIS, ROW_AXIS, COL_AXIS})
    if unknown:
        raise ValueError(f"Unknown mesh axes: {', '.join(unknown)}")

    n_frame, n_band = mesh.size(FRAME_AXIS), mesh.size(BAND_AXIS)
    n_row, n_col = mesh.size(ROW_AXIS), mesh.size(COL_AXIS)
    s = int(scale)
    placed_obs = observations if isinstance(observations, Sharded) else None
    if placed_obs is not None:
        obs_shape = _placed_shape(mesh, placed_obs)
        obs = None
    else:
        obs = torch.as_tensor(_to_numpy(observations)) if not isinstance(observations, torch.Tensor) else observations
        obs_shape = list(obs.shape)
    if len(obs_shape) != 4:
        raise ValueError(f"Observations must be [K, C, h, w]; got shape {tuple(obs_shape)}.")
    k, c = obs_shape[0], obs_shape[1]
    h_glob, w_glob = obs_shape[2] * s, obs_shape[3] * s
    if k % n_frame:
        raise ValueError(f"{k} frames not divisible by frame axis {n_frame}.")
    if c % n_band:
        raise ValueError(f"{c} channels not divisible by band axis {n_band}.")
    if h_glob % (n_row * s) or w_glob % (n_col * s):
        raise ValueError(f"HR shape {(h_glob, w_glob)} must divide into {n_row}x{n_col} scale-aligned tiles.")
    th, tw = h_glob // n_row, w_glob // n_col
    placed_shifts = shifts if isinstance(shifts, Sharded) else None
    if placed_shifts is not None:
        if placed_shifts.mesh is not mesh or placed_shifts.partition != (
                {FRAME_AXIS: 0} if n_frame > 1 else {}):
            raise ValueError("Placed shifts must be split over this mesh's frame axis as shard_problem splits them.")
        rows = placed_shifts.local(0).shape[0] * n_frame
        # The global values, where they are needed on the host: the halo width.
        shifts_np = placed_shifts.to_global("cpu").numpy() if (ROW_AXIS in mesh.shape or COL_AXIS in mesh.shape) \
            else None
    else:
        shifts_np = np.asarray(_to_numpy(shifts), dtype=np.float64).reshape(-1, 2)
        rows = shifts_np.shape[0]
    if rows != k:
        raise ValueError(f"{rows} shifts for {k} frames.")
    kernel_np = None if blur_kernel is None else np.asarray(_to_numpy(blur_kernel), dtype=np.float64)

    q = 0
    if spatial:
        kernel_size = 0 if kernel_np is None else max(kernel_np.shape)
        data_reach = required_halo(float(np.abs(shifts_np).max()) if k else 0.0, kernel_size)
        reg_reach = regs[0][0].scale_range if fuse_btv else (2 if fuse_tv else 0)
        q = -(-max(data_reach, reg_reach, s) // s) * s  # rounded up to a multiple of s
        if q > min(th, tw):
            raise ValueError(
                f"Stencil halo ({q}) exceeds the local tile size ({th}x{tw}); "
                "use fewer tiles or a larger image (single-hop halo exchange).")
    ql = q // s
    need_halo = fuse_tv3d and n_band > 1
    # x and the constants are replicated along `frame`: every frame shard
    # evaluates the whole regulariser, and cost and gradient are summed over
    # `frame`, so each carries 1 / n_frame of it.
    lam = (regs[0][1] / n_frame) if regs else 0.0
    fused = (fuse_tv or fuse_btv) and lam > 0.0

    def pad_local(t, rim, extra_band):
        return F.pad(t, (rim, rim, rim, rim, 0, int(extra_band))).contiguous()

    def local_observations(placed: Sharded) -> Sharded:
        """Placed observations as the kernels read them: zero where the shard
        owns nothing (the rim, the halo band); the shards' own tensors where
        no padding is needed."""
        if _placed_shape(mesh, placed) != obs_shape:
            raise ValueError(f"Observations of shape {_placed_shape(mesh, placed)}, expected {tuple(obs_shape)}.")
        if ql or need_halo or placed.dtype != dtype:
            return placed.map(lambda t: pad_local(t.to(dtype), ql, need_halo))
        return placed

    if placed_obs is None:
        placed_obs = Sharded.from_global(mesh, obs.to(dtype), OBSERVATIONS_PARTITION)
    obs_sharded = local_observations(placed_obs)

    def place_shifts(values) -> Sharded:
        values = values if isinstance(values, torch.Tensor) else torch.as_tensor(np.asarray(values))
        values = values.to(torch.float64).reshape(-1, 2)
        if values.shape[0] != k:
            raise ValueError(f"{values.shape[0]} shifts for {k} frames.")
        return Sharded.from_global(mesh, values, {FRAME_AXIS: 0})

    shifts_sharded = placed_shifts.to(torch.float64) if placed_shifts is not None else place_shifts(
        torch.as_tensor(shifts_np))
    # The plain version slices by host blur taps; the kernels read them from device memory.
    psf = {d: kernel_np if (kernel_np is None or d.type == "cpu") else as_tensor(kernel_np, d, dtype)
           for d in mesh.unique_devices()}

    shard_args = [{} for _ in range(mesh.num_shards)]
    if spatial:
        # The LR pixels a shard owns: the centre of its extended tile. The
        # same for every shard, as the tiles partition the image.
        owned = torch.zeros((th + 2 * q) // s, (tw + 2 * q) // s, dtype=dtype)
        owned[ql: ql + th // s, ql: ql + tw // s] = 1.0
        masks = {d: owned.to(d) for d in mesh.unique_devices()}
        for i in mesh.local_shards:
            args = shard_args[i]
            coords = mesh.coords(i)
            args.update(origin=(coords.get(ROW_AXIS, 0) * th - q, coords.get(COL_AXIS, 0) * tw - q),
                        global_hw=(h_glob, w_glob), data_mask_lr=masks[mesh.devices[i]])
    if need_halo:
        for args in shard_args:
            args["spectral_halo"] = True

    def place(tensor: torch.Tensor) -> Sharded:
        """A global ``[C, H, W]`` tensor (estimate, weights) as the objective's ``Sharded``."""
        if tuple(tensor.shape) != (c, h_glob, w_glob):
            raise ValueError(f"Expected a [C, H, W] tensor of shape {(c, h_glob, w_glob)}, got {tuple(tensor.shape)}.")
        return Sharded.from_global(mesh, tensor.to(dtype), X_PARTITION)

    def regularizer_kwargs(constants: Sharded | None):
        reg_kwargs = [{} for _ in range(mesh.num_shards)]
        if constants is not None:
            for i in mesh.local_shards:
                if fuse_tv:
                    reg_kwargs[i].update(tv_constants=constants.parts[i], tv_use_3d=fuse_tv3d)
                else:
                    reg_kwargs[i].update(btv_constants=constants.parts[i], btv_range=regs[0][0].scale_range,
                                         btv_decay=regs[0][0].spatial_decay)
        return reg_kwargs

    def bound(motion: Sharded, observations: Sharded, constants: Sharded | None):
        """The objective at these placed shifts, observations and padded ``lambda * w`` constants."""
        reg_kwargs = regularizer_kwargs(constants)

        def evaluate(x: Sharded):
            parts = x.parts
            if spatial:
                parts = halo_gather(mesh, parts, q)
            if need_halo:
                parts = spectral_halo_extend(mesh, parts)
            costs, grads = [None] * mesh.num_shards, [None] * mesh.num_shards
            for i in mesh.local_shards:
                costs[i], grads[i] = fused_objective(
                    parts[i].contiguous(), observations.parts[i], motion.parts[i], psf[mesh.devices[i]], s,
                    **reg_kwargs[i], **shard_args[i])
            sums = psum_together(mesh, [(costs, mesh.axis_names)] + ([(grads, (FRAME_AXIS,))] if n_frame > 1 else []))
            total = sums[0]
            if n_frame > 1:
                grads = sums[1]
            if need_halo:
                grads = spectral_halo_return(mesh, grads)
            if spatial:
                grads = halo_scatter_sum(mesh, grads, q)
            return Sharded(mesh, total), Sharded(mesh, grads, x.partition)

        def call(x):
            if isinstance(x, Sharded):
                return evaluate(x)
            cost, grad = evaluate(place(x))
            return cost.local(0).to(x.device), grad.to_global(x.device)

        return call

    def bind(weights=(), shifts=None, observations=None):
        weights = tuple(weights)
        if shifts is None:
            motion = shifts_sharded
        elif spatial:
            raise ValueError(
                "A spatially tiled objective cannot take new shifts: its halo width was fixed from "
                "the shifts it was built with.")
        else:
            motion = shifts if isinstance(shifts, Sharded) else place_shifts(shifts)
        constants = None
        if fused:
            w = weights[0] if isinstance(weights[0], Sharded) else place(weights[0])
            # Rim and halo band ZERO: every regulariser term is counted by the
            # one shard that owns its pixel.
            constants = (lam * w).map(lambda t: pad_local(t, q, need_halo))
        return bound(motion, obs_sharded if observations is None else local_observations(observations), constants)

    def bind_static(device=None):
        """The objective bound to buffers whose addresses never change, for a
        solve captured into CUDA graphs (the counterpart of
        ``solvers.objective.make_map_value_and_grad(...).bind_static()``; a
        ``device`` holds the global copies, default this process's first
        shard's):

        - ``.constants``: one :class:`Sharded` ``lambda * w`` buffer per
          shard (``(None,)`` without a fused term), zero on the rim and the
          halo band; ``.set_weights(weights)`` writes ``lambda * w`` of the
          global ``[C, H, W]`` weights into the owned part of each, in place;
        - ``.shifts``: a global ``[K, 2]`` float64 buffer on ``device``;
          ``.set_shifts(values)`` writes it and each shard's rows of it
          (on a spatial mesh it raises for shifts that reach past the halo);
        - ``.observations``: a global ``[K, C, h, w]`` buffer on ``device``
          (what a motion refiner reads); ``.set_observations(values)``
          writes it and each shard's part of it;
        - ``.place(x)`` / ``.gather(x)``: a global ``[C, H, W]`` tensor as the
          objective's :class:`Sharded` and back, onto ``device``;
        - ``.buffers``: every tensor the IRLS seam writes (the shifts, global
          and per shard, and the constants).

        Not on a mesh that spans processes: the global buffers would need
        pieces that other processes hold.
        """
        if mesh.spans_processes:
            raise ValueError("bind_static on a mesh that spans processes: not supported.")
        home = mesh.devices[mesh.local_shards[0]] if device is None else torch.device(device)
        observations = obs_sharded.map(torch.clone)
        global_obs = (obs.to(dtype) if obs is not None else placed_obs.to_global()).to(home).clone()
        motion = shifts_sharded.map(torch.clone)
        global_shifts = shifts_sharded.to_global(home)
        constants = None
        if fused:
            # One buffer per (device, piece): replicated along `frame`, as the host loop's constants are.
            shape = (c // n_band + int(need_halo), th + 2 * q, tw + 2 * q)
            made, parts = {}, [None] * mesh.num_shards
            for i in mesh.local_shards:
                key = (mesh.devices[i],) + tuple(mesh.coords(i).get(a, 0) for a in (BAND_AXIS, ROW_AXIS, COL_AXIS))
                if key not in made:
                    made[key] = torch.zeros(shape, dtype=dtype, device=mesh.devices[i])
                parts[i] = made[key]
            constants = Sharded(mesh, parts, X_PARTITION)
        fn = bound(motion, observations, constants)
        rows, cb = k // n_frame, c // n_band

        def piece(shard):
            """The shard's frames, bands, HR rows and HR columns in the global arrays."""
            f, b, i, j = (mesh.coords(shard).get(axis, 0) for axis in (FRAME_AXIS, BAND_AXIS, ROW_AXIS, COL_AXIS))
            return (slice(f * rows, (f + 1) * rows), slice(b * cb, (b + 1) * cb), slice(i * th, (i + 1) * th),
                    slice(j * tw, (j + 1) * tw))

        def for_each_piece(value: Sharded, write):
            """``write(shard, local)`` once per distinct local tensor of ``value``."""
            done = set()
            for shard in mesh.local_shards:
                if id(value.parts[shard]) not in done:
                    done.add(id(value.parts[shard]))
                    write(shard, value.parts[shard])

        def set_weights(weights):
            if constants is not None:
                for_each_piece(constants, lambda shard, part: torch.mul(
                    weights[0][piece(shard)[1:]].to(part.device), lam, out=part[:cb, q: q + th, q: q + tw]))

        def set_shifts(values):
            if spatial and k and required_halo(float(torch.as_tensor(values).abs().max()), kernel_size) > q:
                raise ValueError(
                    f"Shifts reaching {float(torch.as_tensor(values).abs().max())} px need a wider halo than "
                    f"this tiled objective's ({q}), which was sized from the shifts it was built with.")
            global_shifts.copy_(values)
            for_each_piece(motion, lambda shard, part: part.copy_(global_shifts[piece(shard)[0]]))

        def set_observations(values):
            global_obs.copy_(values)

            def write(shard, part):
                frames, bands, hr_rows, hr_cols = piece(shard)
                part[:, :cb, ql: ql + th // s, ql: ql + tw // s].copy_(global_obs[
                    frames, bands, hr_rows.start // s: hr_rows.stop // s, hr_cols.start // s: hr_cols.stop // s])
            for_each_piece(observations, write)

        fn.constants, fn.shifts, fn.observations = (constants,), global_shifts, global_obs
        fn.set_weights, fn.set_shifts, fn.set_observations = set_weights, set_shifts, set_observations
        # What the IRLS seam writes: the shifts, global and per shard, and the constants.
        fn.buffers = (global_shifts, *motion.distinct_parts(), *([] if constants is None else constants.distinct_parts()))
        fn.place = place
        fn.gather = lambda x: x.to_global(home)
        fn.mesh = mesh
        return fn

    def value_and_grad(x, weights=(), shifts=None):
        return bind(weights, shifts)(x)

    value_and_grad.prepare = bind
    value_and_grad.bind_static = bind_static
    value_and_grad.place = place
    value_and_grad.mesh = mesh
    value_and_grad.halo = q
    return value_and_grad


def _sizes(mesh: Mesh) -> str:
    return ", ".join(f"{name}={n}" for name, n in mesh.shape.items())


def make_band_sharded_vg(mesh: Mesh, observations, shifts, blur_kernel, scale: int,
                         regularizers: Sequence[tuple[object, float]] = (), dtype: torch.dtype = torch.float32):
    """The objective with the channels split over the mesh's ``band`` axis
    (see :func:`make_sharded_vg` for the arguments and the result).

    One launch per band shard and one scalar sum per evaluation; with 3D
    spectral TV on more than one band shard, the kernels' spectral-halo mode
    and two one-band exchanges besides.
    """
    if BAND_AXIS not in mesh.shape:
        raise ValueError("Mesh must have a 'band' axis for band sharding.")
    if mesh.size(FRAME_AXIS) != 1 or ROW_AXIS in mesh.shape or COL_AXIS in mesh.shape:
        raise ValueError(
            f"make_band_sharded_vg takes a band mesh, got ({_sizes(mesh)}); use make_frame_sharded_vg "
            "for a frame axis and parallel.halo.make_tiled_vg for row / col axes.")
    return make_sharded_vg(mesh, observations, shifts, blur_kernel, scale, regularizers, dtype)


def make_frame_sharded_vg(mesh: Mesh, observations, shifts, blur_kernel, scale: int,
                          regularizers: Sequence[tuple[object, float]] = (), dtype: torch.dtype = torch.float32):
    """The objective with the frames split over the mesh's ``frame`` axis,
    and the channels over ``band`` if the mesh has one (see
    :func:`make_sharded_vg`).

    Every shard holds ``K / n_frame`` frames and their rows of the shift
    tensor; new shifts (``prepare(weights, shifts)``: motion refined between
    IRLS rounds) are split the same way and reach the kernels as data.
    """
    if FRAME_AXIS not in mesh.shape:
        raise ValueError("Mesh must have a 'frame' axis; use make_band_sharded_vg otherwise.")
    if ROW_AXIS in mesh.shape or COL_AXIS in mesh.shape:
        raise ValueError(
            f"make_frame_sharded_vg takes a frame (x band) mesh, got ({_sizes(mesh)}); use "
            "parallel.halo.make_tiled_vg for row / col axes.")
    return make_sharded_vg(mesh, observations, shifts, blur_kernel, scale, regularizers, dtype)


def make_band_sharded_solver(
    mesh: Mesh,
    observations,
    shifts,
    blur_kernel,
    scale: int,
    regularizers: Sequence[tuple[object, float]] = (),
    method: str = "cg",
    max_iterations: int = 50,
    gradient_norm_threshold: float = 1e-6,
    cost_decrease_threshold: float = 1e-6,
    parameter_variation_threshold: float = 1e-6,
    dtype: torch.dtype = torch.float32,
):
    """Band-sharded solve ``(x0, weights=()) -> MinimizeResult``: ``minimize``
    on the sharded state, every evaluation one launch per band shard. ``x0``
    and the weights are global ``[C, H, W]`` tensors; the result's ``x`` is a
    global tensor on ``x0``'s device, its ``cost`` and ``grad_norm`` 0-d
    tensors there."""
    vg = make_band_sharded_vg(mesh, observations, shifts, blur_kernel, scale, regularizers, dtype)

    def solve(x0: torch.Tensor, weights=()):
        result = minimize(
            vg.prepare(weights), vg.place(x0), method=method, max_iterations=max_iterations,
            gradient_norm_threshold=gradient_norm_threshold, cost_decrease_threshold=cost_decrease_threshold,
            parameter_variation_threshold=parameter_variation_threshold,
        )
        return result._replace(
            x=result.x.to_global(x0.device), cost=result.cost.local(0).to(x0.device),
            grad_norm=result.grad_norm.local(0).to(x0.device))

    return solve
