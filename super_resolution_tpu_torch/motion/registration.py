"""Subpixel translational registration via upsampled-DFT phase correlation.

Counterpart of the JAX package's ``motion/registration.py``, which replaced
the reference's BRISK -> FLANN -> RANSAC -> estimateRigidTransform pipeline
(``src/motion/registration.cpp:41-201``). Phase correlation is FFTs and
matrix products (the subpixel refinement is a small matrix-multiply DFT, per
Guizar-Sicairos et al. 2008). The JAX package computes all of it outside its
TPU kernel, so here it is ``torch.fft`` and ``torch.matmul`` on the device,
with the frames (or the blocks of the robust estimator) as a batch dimension.
The accuracy contract is the reference's: recover known shifts within
0.01 px (``test/test_registration.cpp:20``).

Convention matches MotionModule: a shift (dx, dy) means
``frame(r, c) = reference(r - dy, c - dx)`` (content moves down-right), and
:func:`translational_registration` returns shifts such that
``translate(frames[0], dx_k, dy_k) ~= frames[k]``, with frame 0 = (0, 0).

The entry points place their inputs on ``device`` (default ``"cuda"``, which
raises without a card; pass ``device="cpu"`` to run on the CPU) and keep a
floating input's dtype. float32 frames give complex64 spectra; the tests
against the JAX package run in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from super_resolution_tpu_torch._device import resolve_device
from super_resolution_tpu_torch.motion.motion_shift import MotionShift, MotionShiftSequence
from super_resolution_tpu_torch.ops.warp import translate, translate_static

__all__ = [
    "phase_correlation_shift",
    "robust_phase_correlation_shift",
    "translational_registration",
]


def _plane(image, device) -> torch.Tensor:
    """Channel 0 of an image (array, tensor or object with ``.array``) as a 2D
    floating tensor on ``device``, like the reference's keypoint detector
    (``registration.cpp:48-54``)."""
    arr = getattr(image, "array", image)
    t = arr if isinstance(arr, torch.Tensor) else torch.tensor(np.asarray(arr))
    if not t.is_floating_point():
        t = t.to(torch.float32)
    t = t.to(device)
    if t.ndim == 3:
        t = t[0]
    if t.ndim != 2:
        raise ValueError(f"Expected an [H, W] or [C, H, W] image, got shape {tuple(t.shape)}.")
    return t


def _upsampled_dft(data, region, upsample_factor, row_offset, col_offset):
    """Inverse DFT of ``data`` ``[B, H, W]`` on a ``region x region`` grid with
    spacing ``1/upsample_factor`` starting at (row_offset, col_offset) ``[B]``.

    Two small complex matrix products per batch entry instead of a
    zero-padded giant FFT.
    """
    h, w = data.shape[-2:]
    real = row_offset.dtype
    fy = torch.fft.fftfreq(h, dtype=real, device=data.device)
    fx = torch.fft.fftfreq(w, dtype=real, device=data.device)
    steps = torch.arange(region, dtype=real, device=data.device) / upsample_factor
    rows = (row_offset[:, None] + steps)[:, :, None] * fy          # [B, region, H]
    cols = fx[:, None] * (col_offset[:, None] + steps)[:, None, :]  # [B, W, region]
    row_kernel = torch.exp(2j * math.pi * rows)
    col_kernel = torch.exp(2j * math.pi * cols)
    return torch.matmul(torch.matmul(row_kernel, data), col_kernel)


def _phase_correlation_once(ref, img, upsample_factor, lowpass_sigma):
    """One estimate for every pair of a batch: ``ref``, ``img`` ``[B, H, W]``
    -> ``(dx, dy)`` ``[B]``."""
    h, w = ref.shape[-2:]
    real = ref.dtype
    cross = torch.fft.fft2(img) * torch.conj(torch.fft.fft2(ref))
    cross = cross / cross.abs().clamp_min(1e-20)
    # Low-frequency emphasis: bilinear resampling's transfer function has a
    # nonlinear phase at high frequencies (exact only for offsets 0/0.5/1),
    # which biases a fully whitened spectrum. A Gaussian radial weight keeps
    # the refinement in the linear-phase regime.
    fy = torch.fft.fftfreq(h, dtype=real, device=ref.device)[:, None]
    fx = torch.fft.fftfreq(w, dtype=real, device=ref.device)[None, :]
    cross = cross * torch.exp(-(fy * fy + fx * fx) / (2.0 * lowpass_sigma**2))

    # Integer-pixel peak of the correlation surface: frame = translate(ref,
    # dx, dy) makes the peak land at (dy, dx) (mod image size).
    peak = torch.fft.ifft2(cross).abs().flatten(-2).argmax(dim=-1)
    py = torch.div(peak, w, rounding_mode="floor").to(real)
    px = (peak % w).to(real)
    py = torch.where(py > h / 2, py - h, py)
    px = torch.where(px > w / 2, px - w, px)

    # Subpixel refinement: evaluate the correlation on a 1.5-px window around
    # the integer peak at 1/upsample_factor spacing via matrix-multiply DFT.
    region = int(math.ceil(upsample_factor * 1.5))
    r0 = py - (region // 2) / upsample_factor
    c0 = px - (region // 2) / upsample_factor
    sub_peak = _upsampled_dft(cross, region, upsample_factor, r0, c0).abs().flatten(-2).argmax(dim=-1)
    sy = torch.div(sub_peak, region, rounding_mode="floor").to(real)
    sx = (sub_peak % region).to(real)
    return c0 + sx / upsample_factor, r0 + sy / upsample_factor


def _phase_correlation_batch(ref, img, upsample_factor, num_refinement_iterations, lowpass_sigma):
    """``ref`` and ``img`` ``[B, H, W]`` on one device -> ``(dx, dy)`` ``[B]``.

    After the first estimate the reference is re-warped by the running
    estimate (with the same bilinear warp as the imaging model) and the
    residual shift re-estimated: the bilinear resampling bias cancels and
    accuracy lands near ``1/upsample_factor``.
    """
    dx, dy = _phase_correlation_once(ref, img, upsample_factor, lowpass_sigma)
    for _ in range(max(0, num_refinement_iterations - 1)):
        warped = translate(ref, dx, dy)
        ddx, ddy = _phase_correlation_once(warped, img, upsample_factor, lowpass_sigma)
        dx, dy = dx + ddx, dy + ddy
    return dx, dy


def phase_correlation_shift(
    reference,
    frame,
    upsample_factor: int = 256,
    num_refinement_iterations: int = 3,
    lowpass_sigma: float = 0.1,
    device="cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Estimate (dx, dy) such that ``frame ~= translate(reference, dx, dy)``.

    Both images are ``[H, W]`` (channel 0 of a ``[C, H, W]`` image is used).
    Returns two 0-d tensors on ``device``. The JAX package's ``max_shift``
    (a static pad for its traced warp) has no counterpart.
    """
    device = resolve_device(device)
    ref, img = _plane(reference, device), _plane(frame, device)
    dx, dy = _phase_correlation_batch(
        ref[None], img[None].to(ref.dtype), upsample_factor, num_refinement_iterations, lowpass_sigma
    )
    return dx[0], dy[0]


def robust_phase_correlation_shift(
    reference,
    frame,
    block_grid: tuple[int, int] = (3, 3),
    upsample_factor: int = 256,
    num_refinement_iterations: int = 3,
    lowpass_sigma: float = 0.1,
    mad_scale: float = 3.5,
    min_absolute_spread: float = 0.05,
    min_inliers: int = 3,
    device="cuda",
) -> tuple[float, float, np.ndarray]:
    """Outlier-tolerant shift estimation: per-block phase correlation with
    median/MAD consensus.

    Plays the role of the reference's RANSAC stage
    (``registration.cpp:128-157``): a pure global phase correlation assumes
    the translation model holds everywhere, so a corrupted region or a
    locally violated model (occlusion, local motion) biases the single
    estimate. Here the image pair is split into ``block_grid`` blocks, each
    block votes with its own phase-correlation estimate (one batched FFT on
    the device), and votes farther than ``mad_scale`` robust standard
    deviations (1.4826 x MAD) from the per-axis median are rejected on the
    host; the consensus is the per-axis median of the inlier votes.

    The consensus is used for detection and repair, not as the final answer
    (individual blocks see stronger boundary effects than the full image):
    outlier blocks of the frame are replaced by the reference content warped
    by the consensus shift, and the full-image estimator
    (:func:`phase_correlation_shift`) runs on the repaired frame. On clean
    data this is exactly the global estimator. Falls back to the plain
    global estimate when fewer than ``min_inliers`` blocks agree.

    Returns ``(dx, dy, inlier_mask)`` with the mask ordered row-major over
    blocks.
    """
    device = resolve_device(device)
    ref, img = _plane(reference, device), _plane(frame, device)
    img = img.to(ref.dtype)
    h, w = ref.shape
    gy, gx = block_grid
    bh, bw = h // gy, w // gx
    if min(bh, bw) < 16:
        raise ValueError(f"Blocks {bh}x{bw} too small for reliable correlation.")

    def blocks(a):
        a = a[: gy * bh, : gx * bw]
        return a.reshape(gy, bh, gx, bw).permute(0, 2, 1, 3).reshape(-1, bh, bw)

    est = _phase_correlation_batch(
        blocks(ref), blocks(img), upsample_factor, num_refinement_iterations, lowpass_sigma
    )
    dxs, dys = torch.stack(est).to(torch.float64).cpu().numpy()

    med = np.array([np.median(dxs), np.median(dys)])
    mad = np.array([np.median(np.abs(dxs - med[0])), np.median(np.abs(dys - med[1]))])
    tol = np.maximum(mad_scale * 1.4826 * mad, min_absolute_spread)
    inliers = (np.abs(dxs - med[0]) <= tol[0]) & (np.abs(dys - med[1]) <= tol[1])

    def global_estimate(target):
        dx, dy = _phase_correlation_batch(
            ref[None], target[None], upsample_factor, num_refinement_iterations, lowpass_sigma
        )
        return float(dx[0]), float(dy[0]), inliers

    if bool(inliers.all()) or int(inliers.sum()) < min_inliers:
        # Clean data (or degenerate blocks): the plain global estimator.
        return global_estimate(img)

    # Repair: overwrite the outlier blocks with reference content warped by
    # the consensus shift, then estimate globally on the repaired frame. The
    # patched-in content carries exactly the consensus shift, so any residual
    # bias is second-order (patched fraction x consensus error).
    warped = translate_static(ref, float(dxs[inliers].mean()), float(dys[inliers].mean()))
    repaired = img.clone()
    for i in range(gy):
        for j in range(gx):
            if not inliers[i * gx + j]:
                sl = (slice(i * bh, (i + 1) * bh), slice(j * bw, (j + 1) * bw))
                repaired[sl] = warped[sl]
    return global_estimate(repaired)


def translational_registration(
    images,
    upsample_factor: int = 256,
    robust: bool = False,
    block_grid: tuple[int, int] = (3, 3),
    device="cuda",
) -> MotionShiftSequence:
    """Register each frame against frame 0 (frame 0 gets shift (0, 0)).

    Accepts a list of ``[C, H, W]`` / ``[H, W]`` arrays or tensors, or a
    stacked ``[K, ...]`` one. Mirrors ``TranslationalRegistration``
    (``registration.cpp:161-201``) with phase correlation instead of BRISK.
    All frames are estimated in one batch on ``device``; the shifts are read
    back once, into the returned sequence.

    ``robust=True`` uses per-block consensus voting
    (:func:`robust_phase_correlation_shift`): the RANSAC equivalent for data
    with corrupted regions or locally violated translation models.
    """
    device = resolve_device(device)
    frames = [_plane(img, device) for img in images]
    if not frames:
        return MotionShiftSequence()
    ref = frames[0]
    shifts = [MotionShift(0, 0)]
    if len(frames) > 1 and robust:
        for f in frames[1:]:
            dx, dy, _ = robust_phase_correlation_shift(
                ref, f, block_grid=block_grid, upsample_factor=upsample_factor, device=device
            )
            shifts.append(MotionShift(dx, dy))
    elif len(frames) > 1:
        stack = torch.stack(frames[1:]).to(ref.dtype)
        dx, dy = _phase_correlation_batch(
            ref.expand_as(stack), stack, upsample_factor, num_refinement_iterations=3, lowpass_sigma=0.1
        )
        pairs = torch.stack([dx, dy], dim=1).to(torch.float64).cpu().numpy()
        shifts += [MotionShift(float(a), float(b)) for a, b in pairs]
    return MotionShiftSequence(shifts)
