"""The fused MAP objective: CUDA kernels on a CUDA tensor, plain PyTorch on a CPU tensor.

Replaces the JAX package's one Pallas TPU kernel,
``pallas_data_term_cost_and_grad`` (``ops/pallas/degrade.py``), in all its
modes. One call returns cost and gradient of

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

Two more serve a solve spread over a device mesh (``parallel/``). *Shard
mode* (``origin``, ``global_hw``, ``data_mask_lr``): ``x`` is a halo-extended
tile of a larger image, every border test runs in the image's coordinates,
the data residual counts only on the LR pixels the shard owns, and the
gradient that falls into the rim is returned for the caller's scatter-sum.
*Spectral-halo mode* (``spectral_halo``, with ``tv_use_3d``): the last channel
of ``x`` is a read-only band owned by the next band shard. Launches in these
modes are counted in ``shard_launch_counts`` as well.

:func:`fused_objective` is the wrapper. For a CUDA tensor it launches the
kernels of ``csrc/degrade.cu`` (the residual pass, then the gradient pass,
whose block that starts last sums the cost) on the current stream, without
synchronising, and adds one to the launch count of the mode; if the kernels
cannot be built or launched it raises. Every scale and blur the plain
version takes is launched: where one frame's footprint of ``x`` does not fit
a block's shared memory or the blur does not fit the composite table, the
kernels' DIRECT instantiations take them (:func:`takes_direct`). For
a CPU tensor it runs :func:`fused_objective_reference`, the plain version
beside it, and counts nothing. No other condition selects the plain version.

An evaluation on a CUDA tensor may be captured into a CUDA graph
(``solvers/graphs.py``): it launches on ``torch.cuda.current_stream()``,
which under capture is the capture stream; it neither synchronises nor
copies between host and device when ``shifts`` is a float64 tensor and the
blur a tensor already on the device; and its scratch (LR residual, gradient,
partials, cost) comes from the graph's private memory pool, so a caller that
keeps the cost or the gradient past the graph copies them into buffers of
its own inside the capture. The shared-memory attribute the residual
kernel's larger instantiations need is set on every launch, the warm-up
before a capture included. Python counters see a capture once and a replay
never: the graph records what its capture launched and the fold states
those launches leave (:func:`recording_launches`), adds the launches to the
counters on every replay (:func:`add_counts`), and reads the ``late`` flags.

The least the kernels could take on an H100 is set by memory traffic (``x``,
``y``, the constants and the gradient each cross device memory once, the LR
residual twice); the notes in ``csrc/degrade.cu`` give each kernel's design
and what bounds it as built. :func:`composite_taps` and
:func:`composite_is_exact` describe the merged warp+blur tables the residual
and gradient kernels use away from the image border.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import types

import numpy as np
import torch
import torch.nn.functional as F

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
    "shard_launch_counts",
    "plain_version_calls",
    "reset_launch_counts",
    "add_counts",
    "recording_launches",
    "fused_objective",
    "fused_objective_reference",
    "composite_taps",
    "composite_is_exact",
    "max_btv_range",
    "takes_direct",
    "COMPUTE_KERNELS",
    "kernel_attributes",
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
# Of those launches, how many ran in shard mode (a tile of a larger image) and
# how many in spectral-halo mode (the last channel a read-only band).
shard_launch_counts: dict[str, int] = {"shard_mode": 0, "spectral_halo": 0}
# Calls of the plain version, by anyone, since the last reset.
plain_version_calls: dict[str, int] = {"calls": 0}


_COUNTERS = (launch_counts, shift_source_counts, shard_launch_counts, plain_version_calls)
# Lists that the fold state of every launch is appended to while they are
# open (see :func:`recording_launches`).
_fold_recorders: list[list] = []


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for key in counts:
            counts[key] = 0


def add_counts(delta) -> None:
    """Add a :func:`recording_launches` record's ``counts`` to the counters:
    a replay of a CUDA graph whose capture made those launches makes them
    again."""
    for counts, grown in zip(_COUNTERS, delta):
        for key, n in grown.items():
            counts[key] += n


@contextlib.contextmanager
def recording_launches():
    """Launches made inside the block, taken back out of the counters when
    it ends: the yielded record's ``counts`` (what every counter grew by, for
    :func:`add_counts`) and ``folds`` (each launch's fold state,
    ``FOLD_SLOTS``: tickets and the ``late`` flag). A CUDA graph that
    captures the launches keeps the fold tensors: every replay rewrites them
    in place."""
    before = tuple(dict(counts) for counts in _COUNTERS)
    record = types.SimpleNamespace(counts=None, folds=[])
    _fold_recorders.append(record.folds)
    try:
        yield record
    finally:
        # By identity: an enclosing record's list may compare equal to this one.
        del _fold_recorders[next(i for i, folds in enumerate(_fold_recorders) if folds is record.folds)]
        record.counts = tuple({key: counts[key] - was[key] for key in counts} for counts, was in zip(_COUNTERS, before))
        for counts, was in zip(_COUNTERS, before):
            counts.update(was)


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


def _check_problem(x, y, scale, constants, origin=None, global_hw=None, data_mask_lr=None,
                   spectral_halo=False, tv_use_3d=False):
    """Validate the shapes; returns the tile ``(u0, v0, Hg, Wg)``, which is
    ``(0, 0, H, W)`` for a whole image."""
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
    u0, v0 = (0, 0) if origin is None else (int(origin[0]), int(origin[1]))
    if u0 % scale or v0 % scale:
        raise ValueError(f"origin {(u0, v0)} must be scale-aligned (s={scale}).")
    hg, wg = (h, w) if global_hw is None else (int(global_hw[0]), int(global_hw[1]))
    if hg < scale or wg < scale or hg % scale or wg % scale:
        raise ValueError(f"global_hw {(hg, wg)} must be a positive multiple of scale {scale}.")
    if data_mask_lr is not None and tuple(data_mask_lr.shape) != (h // scale, w // scale):
        raise ValueError(
            f"data_mask_lr shape {tuple(data_mask_lr.shape)} != LR extent {(h // scale, w // scale)}.")
    if spectral_halo and not tv_use_3d:
        raise ValueError("spectral_halo only makes sense with tv_use_3d (the halo band exists for the "
                         "spectral coupling).")
    if spectral_halo and c < 2:
        raise ValueError("spectral_halo needs >= 1 real band + the halo.")
    return u0, v0, hg, wg


def _is_shard_mode(origin, global_hw, data_mask_lr) -> bool:
    return origin is not None or global_hw is not None or data_mask_lr is not None


def _shift_list(shifts, num_frames: int) -> list[tuple[float, float]]:
    if isinstance(shifts, torch.Tensor):
        shifts = shifts.detach().cpu().numpy()
    arr = np.asarray(shifts, dtype=np.float64).reshape(-1, 2)
    if arr.shape[0] != num_frames:
        raise ValueError(f"{arr.shape[0]} shifts for {num_frames} frames.")
    return [(float(dx), float(dy)) for dx, dy in arr]


def _tile_data_term(x, y, shifts, blur_kernel, scale, tile, data_mask_lr, keep_bands):
    """Data-term cost and gradient on a tile of a larger image (shard mode).

    The tile is embedded in a zero canvas wide enough that the canvas's own
    border is out of every operator's reach, so ``x`` is zero beyond the
    tile; the operators' zero borders are then applied as masks in the
    IMAGE's coordinates: a source pixel outside the image is zero, the warp's
    output is zero outside the image before the blur reads it, and ``B^T D^T
    r`` is zero outside the image before the reverse warp reads it.
    """
    u0, v0, hg, wg = tile
    h, w = x.shape[-2], x.shape[-1]
    shift_list = _shift_list(shifts, y.shape[0])
    reach = max([abs(v) for pair in shift_list for v in pair] + [0.0])
    taps = (0, 0) if blur_kernel is None else tuple(np.shape(_kernel_array(blur_kernel)))
    margin = int(np.ceil(reach)) + 2 + max(taps)
    margin = -(-margin // scale) * scale
    rows = u0 - margin + torch.arange(h + 2 * margin, device=x.device)
    cols = v0 - margin + torch.arange(w + 2 * margin, device=x.device)
    inside = (((rows >= 0) & (rows < hg))[:, None] & ((cols >= 0) & (cols < wg))[None, :]).to(x.dtype)
    if data_mask_lr is None:
        lr_rows = u0 // scale + torch.arange(h // scale, device=x.device)
        lr_cols = v0 // scale + torch.arange(w // scale, device=x.device)
        mask = (((lr_rows >= 0) & (lr_rows < hg // scale))[:, None]
                & ((lr_cols >= 0) & (lr_cols < wg // scale))[None, :]).to(x.dtype)
    else:
        mask = torch.as_tensor(data_mask_lr, dtype=x.dtype, device=x.device)
    if keep_bands is not None:
        mask = mask * keep_bands
    pad = (margin, margin, margin, margin)
    crop = (Ellipsis, slice(margin, margin + h), slice(margin, margin + w))
    canvas = F.pad(x, pad) * inside
    cost = torch.zeros((), dtype=x.dtype, device=x.device)
    grad = torch.zeros_like(x)
    for k, (dx, dy) in enumerate(shift_list):
        z = translate_static(canvas, dx, dy) * inside
        if blur_kernel is not None:
            z = blur(z, blur_kernel)
        r = (decimate(z[crop], scale) - y[k]) * mask
        cost = cost + torch.sum(r * r)
        g = F.pad(zero_upsample(r, scale), pad)
        if blur_kernel is not None:
            g = blur_adjoint(g, blur_kernel)
        grad = grad + translate_static(g * inside, -dx, -dy)[crop]
    return cost, grad


def _kernel_array(blur_kernel):
    return blur_kernel.detach().cpu().numpy() if isinstance(blur_kernel, torch.Tensor) else np.asarray(blur_kernel)


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
    origin=None,
    global_hw=None,
    data_mask_lr=None,
    spectral_halo: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused objective; any device, any float dtype.

    Built from shifted slices only (no ``conv2d``, no ``grid_sample``): warp,
    blur and their adjoints are zero-filled at the image border one operator
    at a time, exactly as the kernels do. ``shifts`` ``[K, 2]`` of (dx, dy)
    are read on the host (a tensor on a CUDA device is copied back);
    ``blur_kernel`` is a 2D numpy array / tensor or ``None``. The four shard
    arguments are those of :func:`fused_objective`; with all of them left out
    nothing of the shard-mode code runs.
    """
    plain_version_calls["calls"] += 1
    mode = _mode_name(tv_constants, btv_constants, tv_use_3d)
    tile = _check_problem(x, y, scale, tv_constants if tv_constants is not None else btv_constants,
                          origin, global_hw, data_mask_lr, spectral_halo, tv_use_3d)
    shard = _is_shard_mode(origin, global_hw, data_mask_lr)
    keep_bands = None
    if spectral_halo:  # the halo band is read-only: out of the data term
        keep_bands = torch.ones((x.shape[0], 1, 1), dtype=x.dtype, device=x.device)
        keep_bands[-1] = 0.0
    s2 = float(scale * scale)
    if shard:
        cost, grad = _tile_data_term(x, y, shifts, blur_kernel, scale, tile, data_mask_lr, keep_bands)
    else:
        cost = torch.zeros((), dtype=x.dtype, device=x.device)
        grad = torch.zeros_like(x)
        for k, (dx, dy) in enumerate(_shift_list(shifts, y.shape[0])):
            z = translate_static(x, dx, dy)
            if blur_kernel is not None:
                z = blur(z, blur_kernel)
            r = decimate(z, scale) - y[k]
            if keep_bands is not None:
                r = r * keep_bands
            cost = cost + torch.sum(r * r)
            g = zero_upsample(r, scale)
            if blur_kernel is not None:
                g = blur_adjoint(g, blur_kernel)
            grad = grad + translate_static(g, -dx, -dy)
    cost, grad = s2 * cost, 2.0 * s2 * grad
    where = {"origin": tile[:2], "global_hw": tile[2:]} if shard else {}
    if mode in ("data_term_tv", "data_term_tv3d"):
        c_reg, g_reg = tv_cost_and_grad(x, tv_constants, use_3d=tv_use_3d, **where)
    elif mode == "data_term_btv":
        if btv_range < 1:
            raise ValueError("btv_range must be >= 1 when a BTV term is fused.")
        c_reg, g_reg = btv_cost_and_grad(x, btv_constants, btv_range, btv_decay, **where)
    else:
        return cost, grad
    return cost + c_reg, grad + g_reg


def _warp_taps(dx: float, dy: float) -> list[tuple[int, int, float]]:
    """The bilinear warp out(p) = x(p - (dy, dx)) as taps (row offset, column offset, weight)."""
    iy, ix = math.floor(dy), math.floor(dx)
    fy, fx = dy - iy, dx - ix
    taps = []
    for a, wy in ((0, 1.0 - fy), (1, fy)):
        for b, wx in ((0, 1.0 - fx), (1, fx)):
            if wy * wx != 0.0:
                taps.append((-(iy + a), -(ix + b), wy * wx))
    return taps


def composite_taps(dx: float, dy: float, kernel) -> tuple[list, list]:
    """Warp and blur merged into one tap table, and the adjoint's table.

    Forward: ``(B M x)(p) = sum w x(p + (r, c))`` over the ``(r, c, w)`` of the
    first list; adjoint (``M^T B^T`` as the kernels compute it: the warp by
    ``(-dx, -dy)`` after correlation with ``kernel^T``) likewise with the
    second. Exact only where no border intervenes (:func:`composite_is_exact`);
    the kernels build the same tables per frame on the device.
    """
    if kernel is None:
        blur_taps = blur_t_taps = [(0, 0, 1.0)]
    else:
        k = np.asarray(kernel, dtype=np.float64)
        kt = k.T
        blur_taps = [(i - k.shape[0] // 2, j - k.shape[1] // 2, float(k[i, j]))
                     for i in range(k.shape[0]) for j in range(k.shape[1]) if k[i, j] != 0.0]
        blur_t_taps = [(i - kt.shape[0] // 2, j - kt.shape[1] // 2, float(kt[i, j]))
                       for i in range(kt.shape[0]) for j in range(kt.shape[1]) if kt[i, j] != 0.0]

    def merge(warp, blur_list):
        acc: dict[tuple[int, int], float] = {}
        for wr, wc, ww in warp:
            for br, bc, bw in blur_list:
                acc[wr + br, wc + bc] = acc.get((wr + br, wc + bc), 0.0) + ww * bw
        return [(r, c, w) for (r, c), w in acc.items() if w != 0.0]

    return merge(_warp_taps(dx, dy), blur_taps), merge(_warp_taps(-dx, -dy), blur_t_taps)


def composite_is_exact(shifts, kernel, scale: int, image_hw: tuple[int, int]) -> bool:
    """True when the composite tables equal the two-stage form for this
    geometry everywhere: no decimated sample's blur tap lands outside the
    image at a position whose warp taps read inside it (forward), and no
    gradient pixel's reverse-warp tap lands outside the image at a position
    whose transposed-blur taps hit an LR sample inside it (adjoint). Per axis
    and exact, not conservative. Where it is False the image has a border
    band in which only the two-stage form is right."""
    s = int(scale)
    if kernel is None:
        b_r = b_c = bt_r = bt_c = [0]
    else:
        kh, kw = np.shape(kernel)
        b_r, b_c = [i - kh // 2 for i in range(kh)], [j - kw // 2 for j in range(kw)]
        bt_r, bt_c = [i - kw // 2 for i in range(kw)], [j - kh // 2 for j in range(kh)]  # kernel^T

    def axis_ok(n, b_offs, bt_offs, wf, wa):
        if n % s:
            return False
        m = max([abs(o) for o in b_offs + bt_offs + wf + wa] + [0]) // s + 3
        for q in set(range(0, min(m, n // s))) | set(range(max(0, n // s - m), n // s)):
            for b in b_offs:
                p = s * q + b
                if not 0 <= p < n and any(0 <= p + w0 < n for w0 in wf):
                    return False
        for u in set(range(0, min(m * s, n))) | set(range(max(0, n - m * s), n)):
            for aw in wa:
                p = u + aw
                if not 0 <= p < n and any(0 <= p + bt < n and (p + bt) % s == 0 for bt in bt_offs):
                    return False
        return True

    h, w = int(image_hw[0]), int(image_hw[1])
    for dx, dy in np.asarray(shifts, dtype=np.float64).reshape(-1, 2):
        wf, wa = _warp_taps(float(dx), float(dy)), _warp_taps(-float(dx), -float(dy))
        if not axis_ok(h, b_r, bt_r, [t[0] for t in wf], [t[0] for t in wa]):
            return False
        if not axis_ok(w, b_c, bt_c, [t[1] for t in wf], [t[1] for t in wa]):
            return False
    return True


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """``csrc/degrade.cu`` built (at first use) and loaded, signatures declared."""
    lib = build.load("degrade")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.sr_residual_blocks.argtypes = [i] * 4
    lib.sr_gradient_blocks.argtypes = [i] * 5
    lib.sr_max_btv_range.argtypes = []
    lib.sr_takes_direct.argtypes = [i] * 5
    ints = ctypes.POINTER(ctypes.c_int)
    lib.sr_kernel_attributes.argtypes = [i] * 7 + [ints]
    lib.sr_data_residual.argtypes = [p, p, p, p] + [i] * 7 + [ints, p, i, p, p, i, p, i, p]
    lib.sr_objective_gradient.argtypes = [p, p, p, p] + [i] * 7 + [ints, i, p, i, d, p, p, p, p, i, p]
    for fn in (lib.sr_residual_blocks, lib.sr_gradient_blocks, lib.sr_max_btv_range, lib.sr_takes_direct,
               lib.sr_kernel_attributes, lib.sr_data_residual, lib.sr_objective_gradient):
        fn.restype = ctypes.c_int
    return lib


def max_btv_range() -> int:
    """The largest BTV range the kernels are built for."""
    return _library().sr_max_btv_range()


# The compiled kernels, as the profiler names them, and their number in
# ``sr_kernel_attributes``.
COMPUTE_KERNELS = ("sr_residual_kernel", "sr_gradient_kernel", "sr_btv_gradient_kernel")
# float64 slots past the cost partials for the fold's state: one, whose two
# uint32 are the tickets the gradient launch's blocks took and a flag,
# nonzero if its fold stopped waiting for a partial (the cost is then NaN).
FOLD_SLOTS = 1


def takes_direct(kernel: str, scale: int, blur_shape: tuple[int, int], dtype: torch.dtype) -> bool:
    """Whether a launch of ``kernel`` at this scale and blur (``(1, 1)`` for
    none) takes its DIRECT instantiation, s and blur at run time and no
    staging or composite table: the residual kernel where one frame's
    footprint of ``x`` does not fit a block's shared memory or the blur does
    not fit the composite table, the gradient kernel where the blur does not."""
    kh, kw = blur_shape
    return bool(_library().sr_takes_direct(COMPUTE_KERNELS.index(kernel), scale, kh, kw,
                                           int(dtype == torch.float64)))


def kernel_attributes(kernel: str, scale: int, shard: bool, dtype: torch.dtype, mode: str = "data_term",
                      btv_range: int = 0, blur_size: int = 3, direct: bool = False) -> dict[str, int]:
    """What the compiler gave the instantiation of ``kernel`` (one of
    :data:`COMPUTE_KERNELS`) that serves these arguments
    (``cudaFuncGetAttributes``): registers per thread, local memory bytes per
    thread, static shared memory bytes per block, max threads per block, and
    the blocks an SM holds at once as the kernels are launched.
    Scales 2 and 4 have instantiations of their own and any other scale shares
    one; so do a ``blur_size`` x ``blur_size`` blur of 3 and any other blur
    (the BTV kernel has no blur instantiations). ``mode`` selects the
    gradient kernel's mode, ``btv_range`` the BTV kernel's range; ``direct``
    the residual or gradient kernel's DIRECT instantiation (scale and blur
    then select nothing)."""
    which = COMPUTE_KERNELS.index(kernel)
    selector = btv_range if which == 2 else _MODE_OF[mode]
    out = (ctypes.c_int * 5)()
    _raise_on(_library().sr_kernel_attributes(which, selector, scale, blur_size, int(shard), int(direct),
                                               int(dtype == torch.float64), out), "sr_kernel_attributes")
    return dict(zip(("registers", "local_bytes", "shared_bytes", "max_threads", "blocks_per_sm"), out))


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        kind = "refused its arguments" if code < 0 else "failed to launch (CUDA error)"
        raise RuntimeError(f"{what} {kind}: code {code}.")


def _launch(x, y, shifts, blur_kernel, scale, mode, constants, btv_range, btv_decay,
            tile, shard, data_mask_lr, spectral_halo):
    """Cost, gradient, the cost partials (the residual launch's, then the
    gradient launch's) and the fold's state (``FOLD_SLOTS``) of one
    evaluation on the kernels."""
    device, dtype = x.device, x.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"The CUDA kernels take float32 or float64, got {dtype}.")
    lib = _library()
    if mode == "data_term_btv" and not 1 <= btv_range <= max_btv_range():
        raise ValueError(f"btv_range must be in [1, {max_btv_range()}], got {btv_range}.")
    if data_mask_lr is not None and not isinstance(data_mask_lr, torch.Tensor):
        data_mask_lr = torch.as_tensor(np.asarray(data_mask_lr), dtype=dtype, device=device)
    for name, t in (("y", y), ("constants", constants), ("data_mask_lr", data_mask_lr)):
        if t is not None and (t.device != device or t.dtype != dtype):
            raise ValueError(f"{name} is {t.dtype} on {t.device}; x is {dtype} on {device}.")
    for name, t in (("x", x), ("y", y), ("constants", constants), ("data_mask_lr", data_mask_lr)):
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
    is_double = int(dtype == torch.float64)

    # One cost partial per block of each kernel actually launched (none from
    # the data mode's), then the fold's state: the residual launch zeroes it
    # and marks the gradient launch's slots pending.
    n_data = lib.sr_residual_blocks(c, h, w, scale)
    n_reg = lib.sr_gradient_blocks(_MODE_OF[mode], c, h, w, is_double)
    residual = torch.empty_like(y)
    grad = torch.empty_like(x)
    partials = torch.empty(n_data + n_reg + FOLD_SLOTS, dtype=torch.float64, device=device)
    fold = partials.data_ptr() + 8 * (n_data + n_reg)
    cost = torch.empty((), dtype=dtype, device=device)
    blur_ptr = None if blur_dev is None else blur_dev.data_ptr()
    const_ptr = None if constants is None else constants.data_ptr()
    mask_ptr = None if data_mask_lr is None else data_mask_lr.data_ptr()
    tile_arg = (ctypes.c_int * 4)(*tile)

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(lib.sr_data_residual(
            x.data_ptr(), y.data_ptr(), shifts_dev.data_ptr(), blur_ptr, kh, kw,
            k, c, h, w, scale, tile_arg, mask_ptr, int(spectral_halo), residual.data_ptr(),
            partials.data_ptr(), n_reg, fold, is_double, stream,
        ), "sr_data_residual")
        _raise_on(lib.sr_objective_gradient(
            x.data_ptr(), residual.data_ptr(), shifts_dev.data_ptr(), blur_ptr, kh, kw,
            k, c, h, w, scale, tile_arg, _MODE_OF[mode], const_ptr, int(btv_range), float(btv_decay),
            grad.data_ptr(), partials.data_ptr(), fold, cost.data_ptr(), is_double, stream,
        ), "sr_objective_gradient")
    launch_counts[mode] += 1
    shift_source_counts["device" if from_device else "host"] += 1
    shard_launch_counts["shard_mode"] += int(shard)
    shard_launch_counts["spectral_halo"] += int(spectral_halo)
    for folds in _fold_recorders:
        folds.append(partials[-FOLD_SLOTS:])
    return cost, grad, partials[:-FOLD_SLOTS], partials[-FOLD_SLOTS:]


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
    origin=None,
    global_hw=None,
    data_mask_lr=None,
    spectral_halo: bool = False,
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

    Shard mode — any of ``origin``, ``global_hw``, ``data_mask_lr`` given:
    ``x`` is a halo-extended tile of a larger image. ``origin`` ``(u0, v0)``
    is the image coordinate of ``x[..., 0, 0]`` (negative at the image's
    edges, a multiple of ``scale``), ``global_hw`` the image's extent.
    Warp, blur and their adjoints, the TV differences, the BTV windows and
    BTV's skipped origin pixel are all cut at the IMAGE's border; beyond the
    tile's own array ``x`` reads as zero. ``data_mask_lr`` ``[H/s, W/s]`` of
    0/1 keeps the data residual to the LR pixels the shard owns (default: the
    LR pixels inside the image); ``y`` is the tile's LR stack, zero where the
    shard owns nothing. The gradient covers the whole tile: what falls into
    the rim is the caller's to scatter-sum, and fused constants must be zero
    on the rim so that every regulariser term is counted by one shard.

    ``spectral_halo`` (needs ``tv_use_3d`` and two channels): the last channel
    of ``x`` is a read-only band owned by the next band shard. It is left out
    of the data term; with zero constants there (the caller's duty) its own
    TV terms vanish, the last real band takes its spectral difference against
    it, and the gradient's last channel is the cross-shard ``+G sign(dz)``
    for the owner to add to its first band.
    """
    shard_args = dict(origin=origin, global_hw=global_hw, data_mask_lr=data_mask_lr,
                      spectral_halo=spectral_halo)
    if x.device.type == "cpu":
        return fused_objective_reference(
            x, y, shifts, blur_kernel, scale, tv_constants, btv_constants, btv_range, btv_decay,
            tv_use_3d, **shard_args,
        )
    if x.device.type != "cuda":
        raise RuntimeError(f"No fused objective for device {x.device}.")
    cost, grad, _, _ = _evaluate(x, y, shifts, blur_kernel, scale, tv_constants, btv_constants, btv_range,
                                 btv_decay, tv_use_3d, **shard_args)
    return cost, grad


def _evaluate(x, y, shifts, blur_kernel, scale, tv_constants=None, btv_constants=None, btv_range=0,
              btv_decay=1.0, tv_use_3d=False, origin=None, global_hw=None, data_mask_lr=None,
              spectral_halo=False):
    """:func:`fused_objective` on the kernels, with what its launches leave
    beside the cost and gradient: the cost partials and the fold's state
    (see ``_launch``)."""
    constants = tv_constants if tv_constants is not None else btv_constants
    tile = _check_problem(x, y, scale, constants, tv_use_3d=tv_use_3d, origin=origin, global_hw=global_hw,
                          data_mask_lr=data_mask_lr, spectral_halo=spectral_halo)
    return _launch(x, y, shifts, blur_kernel, scale, _mode_name(tv_constants, btv_constants, tv_use_3d),
                   constants, btv_range, btv_decay, tile, _is_shard_mode(origin, global_hw, data_mask_lr),
                   data_mask_lr, spectral_halo)
