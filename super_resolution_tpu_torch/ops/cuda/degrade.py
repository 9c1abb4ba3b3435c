"""The fused MAP objective: CUDA kernels on a CUDA tensor, plain PyTorch on a CPU tensor.

Replaces the JAX package's one Pallas TPU kernel,
``pallas_data_term_cost_and_grad`` (``ops/pallas/degrade.py``), in its
single-device modes. One call returns cost and gradient of

    s^2 sum_k ||D B M_k x - y_k||^2  [+ sum c r_tv(x)^2 | + sum c r_btv(x)^2]

- ``data_term``      — no regulariser fused;
- ``data_term_tv``   — plus the anisotropic 2D TV term (``ops/tv.py``);
- ``data_term_tv3d`` — plus the 3D spectral TV term (``tv_use_3d``: the TV
  residual gains ``|x[b+1] - x[b]|``, which couples the bands);
- ``data_term_btv``  — plus the bilateral TV term (``ops/btv.py``).

Two further modes of the TPU kernel are properties of every launch here.
Its shift-generic mode: ``shifts`` may be a ``[K, 2]`` tensor that already
lives on the device (a refiner's output) and changes from call to call; a
float64 one is handed to the kernels as it is, a float32 one through one
small device op, and no call copies to the host or synchronises. The TPU
mode's ``shift_bound`` and |shift| buckets have no counterpart: the kernels
take any shift. Its channel-block grid: the CUDA grid has a channel axis, so
a cube of hundreds of bands is one launch with no blocking argument.

:func:`fused_objective` is the wrapper. For a CUDA tensor it launches the
kernels of ``csrc/degrade.cu`` (residual pass, gradient pass, cost reduction)
on the current stream, without synchronising, and adds one to the launch
count of the mode; if the kernels cannot be built or launched it raises. For
a CPU tensor it runs :func:`fused_objective_reference`, the plain version
beside it, and counts nothing. No other condition selects the plain version.

What bounds the kernels on an H100 is memory traffic (``x``, ``y``, the
constants and the gradient each cross device memory once, the LR residual
twice); see the note at the head of ``csrc/degrade.cu`` for the design.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from super_resolution_tpu_torch.ops.blur import blur, blur_adjoint
from super_resolution_tpu_torch.ops.btv import btv_cost_and_grad
from super_resolution_tpu_torch.ops.cuda import build
from super_resolution_tpu_torch.ops.resize import decimate, zero_upsample
from super_resolution_tpu_torch.ops.tv import tv_cost_and_grad
from super_resolution_tpu_torch.ops.warp import translate_static

__all__ = [
    "KERNEL_NAMES",
    "launch_counts",
    "shift_source_counts",
    "reset_launch_counts",
    "fused_objective",
    "fused_objective_reference",
]

KERNEL_NAMES = ("data_term", "data_term_tv", "data_term_btv", "data_term_tv3d")
_MODE_OF = {"data_term": 0, "data_term_tv": 1, "data_term_btv": 2, "data_term_tv3d": 3}

# Launches of each mode's kernels since the last reset. Only
# :func:`fused_objective` on a CUDA tensor adds to these.
launch_counts: dict[str, int] = {name: 0 for name in KERNEL_NAMES}
# Of those launches, how many took their shifts from a tensor already on the
# device ("device": nothing crossed from the host) and how many from host
# values ("host": a [K, 2] copy to the device per call).
shift_source_counts: dict[str, int] = {"device": 0, "host": 0}


def reset_launch_counts() -> None:
    for name in KERNEL_NAMES:
        launch_counts[name] = 0
    for source in shift_source_counts:
        shift_source_counts[source] = 0


def _mode_name(tv_constants, btv_constants, tv_use_3d=False) -> str:
    if tv_constants is not None and btv_constants is not None:
        raise ValueError("Fuse either a TV or a BTV term, not both.")
    if tv_use_3d and tv_constants is None:
        raise ValueError("tv_use_3d needs tv_constants.")
    if tv_constants is not None:
        return "data_term_tv3d" if tv_use_3d else "data_term_tv"
    if btv_constants is not None:
        return "data_term_btv"
    return "data_term"


def _check_problem(x, y, scale, constants):
    if x.ndim != 3 or y.ndim != 4:
        raise ValueError(f"Expected x [C,H,W] and y [K,C,h,w]; got {tuple(x.shape)}, {tuple(y.shape)}.")
    c, h, w = x.shape
    k = y.shape[0]
    if scale < 1 or h % scale or w % scale:
        raise ValueError(f"HR size {(h, w)} is not a multiple of scale {scale}.")
    if tuple(y.shape) != (k, c, h // scale, w // scale) or k < 1:
        raise ValueError(f"LR stack shape {tuple(y.shape)} does not fit x {tuple(x.shape)} at scale {scale}.")
    if constants is not None and constants.shape != x.shape:
        raise ValueError(f"Constants shape {tuple(constants.shape)} != x shape {tuple(x.shape)}.")


def _shift_list(shifts, num_frames: int) -> list[tuple[float, float]]:
    if isinstance(shifts, torch.Tensor):
        shifts = shifts.detach().cpu().numpy()
    arr = np.asarray(shifts, dtype=np.float64).reshape(-1, 2)
    if arr.shape[0] != num_frames:
        raise ValueError(f"{arr.shape[0]} shifts for {num_frames} frames.")
    return [(float(dx), float(dy)) for dx, dy in arr]


def fused_objective_reference(
    x: torch.Tensor,
    y: torch.Tensor,
    shifts,
    blur_kernel,
    scale: int,
    tv_constants: torch.Tensor | None = None,
    btv_constants: torch.Tensor | None = None,
    btv_range: int = 0,
    btv_decay: float = 1.0,
    tv_use_3d: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused objective; any device, any float dtype.

    Built from shifted slices only (no ``conv2d``, no ``grid_sample``): warp,
    blur and their adjoints are zero-filled at the image border one operator
    at a time, exactly as the kernels do. ``shifts`` ``[K, 2]`` of (dx, dy)
    are read on the host (a tensor on a CUDA device is copied back);
    ``blur_kernel`` is a 2D numpy array / tensor or ``None``.
    """
    mode = _mode_name(tv_constants, btv_constants, tv_use_3d)
    _check_problem(x, y, scale, tv_constants if tv_constants is not None else btv_constants)
    s2 = float(scale * scale)
    cost = torch.zeros((), dtype=x.dtype, device=x.device)
    grad = torch.zeros_like(x)
    for k, (dx, dy) in enumerate(_shift_list(shifts, y.shape[0])):
        z = translate_static(x, dx, dy)
        if blur_kernel is not None:
            z = blur(z, blur_kernel)
        r = decimate(z, scale) - y[k]
        cost = cost + torch.sum(r * r)
        g = zero_upsample(r, scale)
        if blur_kernel is not None:
            g = blur_adjoint(g, blur_kernel)
        grad = grad + translate_static(g, -dx, -dy)
    cost, grad = s2 * cost, 2.0 * s2 * grad
    if mode in ("data_term_tv", "data_term_tv3d"):
        c_reg, g_reg = tv_cost_and_grad(x, tv_constants, use_3d=tv_use_3d)
    elif mode == "data_term_btv":
        if btv_range < 1:
            raise ValueError("btv_range must be >= 1 when a BTV term is fused.")
        c_reg, g_reg = btv_cost_and_grad(x, btv_constants, btv_range, btv_decay)
    else:
        return cost, grad
    return cost + c_reg, grad + g_reg


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """``csrc/degrade.cu`` built (at first use) and loaded, signatures declared."""
    lib = build.load("degrade")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.sr_residual_blocks.argtypes = [i] * 5
    lib.sr_gradient_blocks.argtypes = [i] * 3
    lib.sr_max_btv_range.argtypes = []
    lib.sr_data_residual.argtypes = [p, p, p, p] + [i] * 7 + [p, p, i, p]
    lib.sr_objective_gradient.argtypes = [p, p, p, p] + [i] * 8 + [p, i, d, p, p, i, p]
    lib.sr_reduce_cost.argtypes = [p, i, i, d, p, i, p]
    for fn in (lib.sr_residual_blocks, lib.sr_gradient_blocks, lib.sr_max_btv_range,
               lib.sr_data_residual, lib.sr_objective_gradient, lib.sr_reduce_cost):
        fn.restype = ctypes.c_int
    return lib


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        kind = "refused its arguments" if code < 0 else "failed to launch (CUDA error)"
        raise RuntimeError(f"{what} {kind}: code {code}.")


def _launch(x, y, shifts, blur_kernel, scale, mode, constants, btv_range, btv_decay):
    lib = _library()
    device, dtype = x.device, x.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"The CUDA kernels take float32 or float64, got {dtype}.")
    for name, t in (("y", y), ("constants", constants)):
        if t is not None and (t.device != device or t.dtype != dtype):
            raise ValueError(f"{name} is {t.dtype} on {t.device}; x is {dtype} on {device}.")
    for name, t in (("x", x), ("y", y), ("constants", constants)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous.")
    c, h, w = x.shape
    k = y.shape[0]
    from_device = isinstance(shifts, torch.Tensor) and shifts.device == device
    # No copy for a contiguous float64 tensor on the device; one small device
    # op for a float32 one; one host-to-device copy for host values.
    shifts_dev = torch.as_tensor(shifts, dtype=torch.float64, device=device).reshape(-1, 2).contiguous()
    if shifts_dev.shape[0] != k:
        raise ValueError(f"{shifts_dev.shape[0]} shifts for {k} frames.")
    if blur_kernel is None:
        blur_dev, kh, kw = None, 1, 1
    else:
        blur_dev = torch.as_tensor(blur_kernel, dtype=dtype, device=device).contiguous()
        if blur_dev.ndim != 2:
            raise ValueError(f"Blur kernel must be 2D, got shape {tuple(blur_dev.shape)}.")
        kh, kw = blur_dev.shape
    if mode == "data_term_btv" and not 1 <= btv_range <= lib.sr_max_btv_range():
        raise ValueError(f"btv_range must be in [1, {lib.sr_max_btv_range()}], got {btv_range}.")

    n_data = lib.sr_residual_blocks(k, c, h, w, scale)
    n_reg = lib.sr_gradient_blocks(c, h, w) if constants is not None else 0
    residual = torch.empty_like(y)
    grad = torch.empty_like(x)
    partials = torch.empty(n_data + n_reg, dtype=torch.float64, device=device)
    cost = torch.empty((), dtype=dtype, device=device)
    is_double = int(dtype == torch.float64)
    blur_ptr = None if blur_dev is None else blur_dev.data_ptr()
    const_ptr = None if constants is None else constants.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(lib.sr_data_residual(
            x.data_ptr(), y.data_ptr(), shifts_dev.data_ptr(), blur_ptr, kh, kw,
            k, c, h, w, scale, residual.data_ptr(), partials.data_ptr(), is_double, stream,
        ), "sr_data_residual")
        _raise_on(lib.sr_objective_gradient(
            x.data_ptr(), residual.data_ptr(), shifts_dev.data_ptr(), blur_ptr, kh, kw,
            k, c, h, w, scale, _MODE_OF[mode], const_ptr, int(btv_range), float(btv_decay),
            grad.data_ptr(), partials.data_ptr() + 8 * n_data, is_double, stream,
        ), "sr_objective_gradient")
        _raise_on(lib.sr_reduce_cost(
            partials.data_ptr(), n_data, n_reg, float(scale * scale), cost.data_ptr(),
            is_double, stream,
        ), "sr_reduce_cost")
    launch_counts[mode] += 1
    shift_source_counts["device" if from_device else "host"] += 1
    return cost, grad


def fused_objective(
    x: torch.Tensor,
    y: torch.Tensor,
    shifts,
    blur_kernel,
    scale: int,
    tv_constants: torch.Tensor | None = None,
    btv_constants: torch.Tensor | None = None,
    btv_range: int = 0,
    btv_decay: float = 1.0,
    tv_use_3d: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cost (0-d) and gradient ``[C, H, W]`` of the fused MAP objective.

    ``x`` on a CUDA device: the hand-written kernels (float32 or float64,
    contiguous, everything on ``x``'s device) — or an error. ``x`` on the CPU:
    the plain version. ``shifts`` ``[K, 2]`` (dx, dy) may be a tensor on the
    device (no host copy, no synchronisation), a numpy array or a sequence.
    The kernels take them as runtime data of any size and sign, so one build
    serves every motion. ``tv_use_3d`` adds the spectral difference to the
    fused TV term (all bands of ``x`` are coupled; with one band it is the
    2D term).
    """
    if x.device.type == "cpu":
        return fused_objective_reference(
            x, y, shifts, blur_kernel, scale, tv_constants, btv_constants, btv_range, btv_decay,
            tv_use_3d,
        )
    if x.device.type != "cuda":
        raise RuntimeError(f"No fused objective for device {x.device}.")
    mode = _mode_name(tv_constants, btv_constants, tv_use_3d)
    constants = tv_constants if tv_constants is not None else btv_constants
    _check_problem(x, y, scale, constants)
    return _launch(x, y, shifts, blur_kernel, scale, mode, constants, btv_range, btv_decay)
