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
    psum,
    spectral_halo_extend,
    spectral_halo_return,
    sum_to_devices,
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

    ``observations``: global ``[K, C, H/s, W/s]``, ``shifts``: ``[K, 2]``,
    ``blur_kernel``: 2D or ``None`` (numpy arrays or tensors). They are split
    and placed on the shards' devices once, here. ``x`` and the IRLS
    ``weights`` are :class:`Sharded` (``value_and_grad.place(tensor)`` makes
    one from a global ``[C, H, W]`` tensor) and so is the result: a
    replicated 0-d cost and a gradient sharded like ``x``. A global tensor
    is accepted for ``x`` as well; cost and gradient then come back as
    global tensors on its device.

    ``value_and_grad.prepare(weights, shifts=None)`` binds the weights and
    computes the padded ``lambda * w`` constants once for a whole inner
    solve; ``shifts`` replaces the motion given here (frame and band meshes
    only: on a spatial mesh the halo width was fixed from the shifts given
    at build time).

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
    obs = torch.as_tensor(_to_numpy(observations)) if not isinstance(observations, torch.Tensor) else observations
    if obs.ndim != 4:
        raise ValueError(f"Observations must be [K, C, h, w]; got shape {tuple(obs.shape)}.")
    k, c = obs.shape[0], obs.shape[1]
    h_glob, w_glob = obs.shape[2] * s, obs.shape[3] * s
    if k % n_frame:
        raise ValueError(f"{k} frames not divisible by frame axis {n_frame}.")
    if c % n_band:
        raise ValueError(f"{c} channels not divisible by band axis {n_band}.")
    if h_glob % (n_row * s) or w_glob % (n_col * s):
        raise ValueError(f"HR shape {(h_glob, w_glob)} must divide into {n_row}x{n_col} scale-aligned tiles.")
    th, tw = h_glob // n_row, w_glob // n_col
    shifts_np = np.asarray(_to_numpy(shifts), dtype=np.float64).reshape(-1, 2)
    if shifts_np.shape[0] != k:
        raise ValueError(f"{shifts_np.shape[0]} shifts for {k} frames.")
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

    # Observations: zero where the shard owns nothing (the rim, the halo band).
    obs_sharded = Sharded.from_global(mesh, obs.to(dtype), OBSERVATIONS_PARTITION).map(
        lambda t: pad_local(t, ql, need_halo))

    def place_shifts(values) -> Sharded:
        values = values if isinstance(values, torch.Tensor) else torch.as_tensor(np.asarray(values))
        values = values.to(torch.float64).reshape(-1, 2)
        if values.shape[0] != k:
            raise ValueError(f"{values.shape[0]} shifts for {k} frames.")
        return Sharded.from_global(mesh, values, {FRAME_AXIS: 0})

    shifts_sharded = place_shifts(torch.as_tensor(shifts_np))
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
        for i, args in enumerate(shard_args):
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

    def bind(weights=(), shifts=None):
        weights = tuple(weights)
        if shifts is None:
            motion = shifts_sharded
        elif spatial:
            raise ValueError(
                "A spatially tiled objective cannot take new shifts: its halo width was fixed from "
                "the shifts it was built with.")
        else:
            motion = place_shifts(shifts)
        reg_kwargs = [{} for _ in range(mesh.num_shards)]
        if fused:
            w = weights[0] if isinstance(weights[0], Sharded) else place(weights[0])
            # Rim and halo band ZERO: every regulariser term is counted by the
            # one shard that owns its pixel.
            constants = (lam * w).map(lambda t: pad_local(t, q, need_halo))
            for i, kwargs in enumerate(reg_kwargs):
                if fuse_tv:
                    kwargs.update(tv_constants=constants.parts[i], tv_use_3d=fuse_tv3d)
                else:
                    kwargs.update(btv_constants=constants.parts[i], btv_range=regs[0][0].scale_range,
                                  btv_decay=regs[0][0].spatial_decay)

        def evaluate(x: Sharded):
            parts = x.parts
            if spatial:
                parts = halo_gather(mesh, parts, q)
            if need_halo:
                parts = spectral_halo_extend(mesh, parts)
            costs, grads = [], []
            for i, part in enumerate(parts):
                cost, grad = fused_objective(
                    part.contiguous(), obs_sharded.parts[i], motion.parts[i], psf[mesh.devices[i]], s,
                    **reg_kwargs[i], **shard_args[i])
                costs.append(cost)
                grads.append(grad)
            total = sum_to_devices(costs, mesh.devices)
            if n_frame > 1:
                grads = psum(mesh, grads, (FRAME_AXIS,))
            if need_halo:
                grads = spectral_halo_return(mesh, grads)
            if spatial:
                grads = halo_scatter_sum(mesh, grads, q)
            return Sharded(mesh, [total[d] for d in mesh.devices]), Sharded(mesh, grads, x.partition)

        def bound(x):
            if isinstance(x, Sharded):
                return evaluate(x)
            cost, grad = evaluate(place(x))
            return cost.local(0).to(x.device), grad.to_global(x.device)

        return bound

    def value_and_grad(x, weights=(), shifts=None):
        return bind(weights, shifts)(x)

    value_and_grad.prepare = bind
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
