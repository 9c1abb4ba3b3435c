"""Carry the JAX package's problem and solver state across to the port.

The system has no learned weights; what a run owns is its problem (image
model parameters, LR stack, initial estimate) and its solver state (options,
regularizers, IRLS weights, a trained spectral PCA). The JAX package's
objects are handed over as plain dicts and numpy arrays —
``dataclasses.asdict(options)``, ``np.asarray(stack)``, ``seq.as_array()``,
``pca.mean`` / ``pca.basis`` — so this module imports nothing of that
package.

Fields of the JAX ``IRLSMapSolverOptions`` that only route its TPU kernel
are dropped, because the port has one objective path and they cannot change
a result: ``use_pallas_data_term``, ``use_static_shifts``, ``pallas_tile``,
``pallas_shift_bound`` and ``pallas_channel_block``. ``fused_irls``,
``num_lbfgs_hessian_corrections`` and ``diff_mode`` are carried: the port's
solver then runs the fused solve, L-BFGS with that memory, and the
gradient mode asked for.
A JAX ``ImageData`` crosses as its hidden array (``np.asarray(image.hidden_array)``),
its spectral mode's name and its luminance-only flag (:func:`image_data`), and
the JAX ``AdmmSolverOptions`` as ``dataclasses.asdict`` (:func:`admm_options`).
A JAX ``Mesh`` crosses as its axis sizes, ``{name: size}`` in plain ints
(``dict(zip(mesh.axis_names, mesh.devices.shape))``): :func:`mesh` builds
the port's mesh of that shape over the devices given.
One difference follows from dropping ``pallas_shift_bound``: the JAX solver
clips refined shifts to that bound when its TPU kernel is in use, and the
port, whose kernels take any shift, never clips. A key that neither package
knows raises with its name.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from super_resolution_tpu_torch._device import as_chw, as_tensor, resolve_device
from super_resolution_tpu_torch.image.image_data import ImageData, SpectralMode
from super_resolution_tpu_torch.models.image_model import ImageModel, ImageModelParameters
from super_resolution_tpu_torch.motion.motion_shift import MotionShiftSequence
from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
from super_resolution_tpu_torch.parallel.mesh import Mesh, make_mesh
from super_resolution_tpu_torch.solvers.admm import AdmmSolverOptions
from super_resolution_tpu_torch.solvers.irls import IRLSMapSolver
from super_resolution_tpu_torch.solvers.map_solver import IRLSMapSolverOptions
from super_resolution_tpu_torch.spectral.pca import SpectralPCA

__all__ = [
    "DROPPED_OPTION_FIELDS",
    "image_model_parameters",
    "irls_options",
    "admm_options",
    "image_data",
    "regularizers",
    "lr_stack",
    "hr_image",
    "irls_weights",
    "irls_solver",
    "mesh",
    "spectral_pca",
]

# Fields of the JAX options that cannot change a result here: dropped on conversion.
DROPPED_OPTION_FIELDS = (
    "use_pallas_data_term",
    "use_static_shifts",
    "pallas_tile",
    "pallas_shift_bound",
    "pallas_channel_block",
)


def image_model_parameters(params: Mapping) -> ImageModelParameters:
    """``{"scale", "blur_radius", "blur_sigma", "motion_sequence": [K,2] array | None,
    "motion_sequence_path", "noise_sigma", "noise_seed"}`` -> the port's parameters."""
    known = {f.name for f in dataclasses.fields(ImageModelParameters)}
    unknown = sorted(set(params) - known)
    if unknown:
        raise ValueError(f"Unknown image model parameter(s): {', '.join(unknown)}")
    values = dict(params)
    shifts = values.get("motion_sequence")
    if shifts is not None and not isinstance(shifts, MotionShiftSequence):
        pairs = np.asarray(shifts, dtype=np.float64).reshape(-1, 2)
        values["motion_sequence"] = MotionShiftSequence([(float(dx), float(dy)) for dx, dy in pairs])
    return ImageModelParameters(**values)


def irls_options(options: Mapping) -> IRLSMapSolverOptions:
    """``dataclasses.asdict`` of the JAX options -> the port's options."""
    return _options(options, IRLSMapSolverOptions)


def _options(options: Mapping, cls):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(options) - known - set(DROPPED_OPTION_FIELDS))
    if unknown:
        raise ValueError(f"Unknown solver option(s): {', '.join(unknown)}")
    return cls(**{k: v for k, v in options.items() if k in known})


def admm_options(options: Mapping) -> AdmmSolverOptions:
    """``dataclasses.asdict`` of the JAX ``AdmmSolverOptions`` -> the port's
    (the kernel-routing fields dropped, as for :func:`irls_options`)."""
    return _options(options, AdmmSolverOptions)


def image_data(array, spectral_mode_name: str, luminance_only: bool = False, device="cuda",
               dtype: torch.dtype = torch.float32) -> ImageData:
    """A JAX ``ImageData`` -> the port's: its hidden array ``[C, H, W]`` as
    numpy, its spectral mode's name (``image.spectral_mode.name``, e.g.
    ``"COLOR_YCRCB"``) and its luminance-only flag (``image._luminance_only``),
    taken as they are (no normalization)."""
    return ImageData(np.asarray(array), normalize="never", channel_major=True,
                     spectral_mode=SpectralMode[spectral_mode_name], _luminance_only=bool(luminance_only),
                     device=resolve_device(device), dtype=dtype)


def regularizers(specs: Sequence[tuple[str, Mapping, float]]) -> list[tuple[object, float]]:
    """``[(kind, args, lambda)]`` -> ``[(regularizer, lambda)]``.

    ``kind`` is ``"tv"`` (args ``{"use_3d": bool}`` or empty) or ``"btv"``
    (args ``{"scale_range": P, "spatial_decay": a}``).
    """
    out = []
    for kind, args, lam in specs:
        args = dict(args or {})
        if kind == "tv":
            reg = TotalVariationRegularizer(bool(args.pop("use_3d", False)))
        elif kind == "btv":
            reg = BilateralTotalVariationRegularizer(
                int(args.pop("scale_range")), float(args.pop("spatial_decay"))
            )
        else:
            raise ValueError(f"Unknown regularizer kind {kind!r}; options: 'tv', 'btv'")
        if args:
            raise ValueError(f"Unknown argument(s) for regularizer {kind!r}: {', '.join(sorted(args))}")
        out.append((reg, float(lam)))
    return out


def lr_stack(stack, device="cuda", dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LR observations ``[K, C, h, w]`` (or ``[K, h, w]``) -> tensor ``[K, C, h, w]``."""
    t = as_tensor(stack, resolve_device(device), dtype)
    if t.ndim == 3:
        t = t[:, None]
    if t.ndim != 4:
        raise ValueError(f"LR stack must be [K, C, h, w]; got shape {tuple(t.shape)}.")
    return t.contiguous()


def hr_image(image, device="cuda", dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """An HR array (initial estimate, ground truth) -> tensor ``[C, H, W]``."""
    return as_chw(image, resolve_device(device), dtype)


def irls_weights(weights: Sequence, device="cuda", dtype: torch.dtype = torch.float32) -> tuple:
    """Per-regularizer IRLS weight arrays -> tuple of ``[C, H, W]`` tensors."""
    return tuple(hr_image(w, device, dtype) for w in weights)


def mesh(axis_sizes: Mapping[str, int] | None, devices=None) -> Mesh | None:
    """A JAX mesh's ``{axis name: size}`` -> the port's mesh of that shape
    (``None`` stays ``None``). ``devices``: where the shards go, dealt in
    turn (default: every visible CUDA card)."""
    if axis_sizes is None:
        return None
    return make_mesh({str(name): int(size) for name, size in axis_sizes.items()}, devices)


def irls_solver(
    model_parameters: Mapping,
    options: Mapping,
    regularizer_specs: Sequence[tuple[str, Mapping, float]],
    low_res_stack,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    mesh_axis_sizes: Mapping[str, int] | None = None,
    mesh_devices=None,
) -> IRLSMapSolver:
    """The port's solver for a problem stated in the JAX package's terms.

    ``mesh_axis_sizes``: the JAX solver's mesh as ``{axis name: size}``; its
    shards are dealt over ``mesh_devices`` (default: ``[device]``)."""
    model = ImageModel.create(image_model_parameters(model_parameters))
    stack = lr_stack(low_res_stack, device, dtype)
    solver = IRLSMapSolver(
        irls_options(options), model, list(stack), device=device, dtype=dtype,
        mesh=mesh(mesh_axis_sizes, [device] if mesh_devices is None else mesh_devices))
    for reg, lam in regularizers(regularizer_specs):
        solver.add_regularizer(reg, lam)
    return solver


def spectral_pca(mean, basis) -> SpectralPCA:
    """The port's ``SpectralPCA`` from a trained one's ``mean`` ``[C]`` and
    ``basis`` ``[k, C]`` (numpy arrays): both then project identically."""
    return SpectralPCA.from_basis(np.asarray(mean), np.asarray(basis))
