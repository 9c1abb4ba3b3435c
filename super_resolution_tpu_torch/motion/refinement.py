"""Joint motion refinement against the evolving HR estimate.

The reference estimates motion once, from the aliased LR frames
(``registration.cpp:161-201``), and never revisits it: its registration
error is baked into every later solve. With the HR estimate ``x`` partially
solved, the data-term cost

    E_k(dx, dy) = || D B M_{dx,dy} x - y_k ||^2

is a smooth function of each frame's two shift parameters (the bilinear warp
is piecewise linear in the shift, so exact Jacobians exist in closed form),
and a few damped Gauss-Newton steps per frame recover the motion to well
below the one-shot registration error. The solver alternates solve x |
refine shifts | resume; the refined ``[K, 2]`` tensor goes straight back into
the objective kernels, which read their shifts from device memory, so
nothing is rebuilt and nothing passes through the host.

Everything here is plain tensor code on ``x``'s device, all frames at once
(the frame axis is a batch dimension), with no read-back.

Convention: shifts are HR-pixel (dx, dy) rows, ``MotionShift`` semantics
(``frame = translate(reference, dx, dy)``: content moves down-right;
``motion_module.cpp:29-51``). Frame 0 stays pinned to anchor the global
translation gauge (x itself can absorb a common drift otherwise).
"""

from __future__ import annotations

import torch

__all__ = ["refine_shifts", "make_shift_refiner"]


def refine_shifts(
    x: torch.Tensor,
    observations: torch.Tensor,
    shifts: torch.Tensor,
    blur_kernel,
    scale: int,
    num_iterations: int = 3,
    damping: float = 1e-4,
    max_step: float = 0.5,
    pin_first: bool = True,
) -> torch.Tensor:
    """Damped per-frame Gauss-Newton refinement of translational motion.

    ``x``: current HR estimate ``[C, H, W]``; ``observations``: ``[K, C,
    H/s, W/s]``; ``shifts``: ``[K, 2]`` HR-px (dx, dy) starting estimates, a
    tensor on ``x``'s device (or host values). ``blur_kernel`` is a host
    array or ``None``. Returns the refined ``[K, 2]`` shifts in ``x.dtype``
    on ``x``'s device; all sums are taken in ``x.dtype``.

    Each step solves the per-frame 2x2 normal equations ``(J^T J + lam
    diag(J^T J)) d = -J^T r`` with ``J`` the exact Jacobian of the degraded
    prediction in (dx, dy), and clips the step to ``max_step`` HR px: the
    bilinear warp's Jacobian is only piecewise constant, so full-pixel jumps
    would overshoot the linear regime. ``pin_first`` keeps frame 0 at its
    input shift (the gauge anchor; frame 0 is (0, 0) by the registration
    convention). The JAX package's ``max_shift`` sized a static pad and has
    no counterpart: shifts of any size are taken.
    """
    # Imported here: models.image_model itself imports the motion package
    # (MotionShiftSequence), so a module-level import would be circular.
    from super_resolution_tpu_torch.models.image_model import degrade_with_shift_derivatives

    start = torch.as_tensor(shifts, device=x.device).to(x.dtype).reshape(-1, 2)
    k = observations.shape[0]
    if start.shape[0] != k:
        raise ValueError(f"{start.shape[0]} shifts for {k} frames.")
    frames = x.unsqueeze(0).expand(k, *x.shape)
    s = start
    for _ in range(num_iterations):
        pred, j_dx, j_dy = degrade_with_shift_derivatives(frames, s[:, 0], s[:, 1], blur_kernel, scale)
        r = pred - observations
        a11 = (j_dx * j_dx).sum(dim=(1, 2, 3))
        a22 = (j_dy * j_dy).sum(dim=(1, 2, 3))
        a12 = (j_dx * j_dy).sum(dim=(1, 2, 3))
        b1 = -(j_dx * r).sum(dim=(1, 2, 3))
        b2 = -(j_dy * r).sum(dim=(1, 2, 3))
        # Levenberg damping on the diagonal keeps the step well-posed on flat
        # frames (uniform regions: J ~ 0); the additive floor keeps the
        # determinant a normal float32 number there (1e-12 squared is 1e-24).
        a11 = a11 + damping * a11 + 1e-12
        a22 = a22 + damping * a22 + 1e-12
        det = a11 * a22 - a12 * a12
        step = torch.stack([(a22 * b1 - a12 * b2) / det, (a11 * b2 - a12 * b1) / det], dim=1)
        s = s + step.clamp(-max_step, max_step)
    if pin_first:
        s = torch.cat([start[:1], s[1:]])
    return s


def make_shift_refiner(
    blur_kernel,
    scale: int,
    num_iterations: int = 3,
    damping: float = 1e-4,
    max_step: float = 0.5,
):
    """``(x, observations, shifts) -> refined_shifts`` with the settings bound.

    One closure serves every refinement round of a solve: ``x``,
    ``observations`` and ``shifts`` are its arguments, as the objective
    kernels take every shift set.
    """

    def refiner(x, observations, shifts):
        return refine_shifts(
            x, observations, shifts, blur_kernel, scale,
            num_iterations=num_iterations, damping=damping, max_step=max_step,
        )

    return refiner
