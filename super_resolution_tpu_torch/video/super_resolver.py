"""Video super-resolution (functional replacement for the reference's dead
``src/video/super_resolver.{h,cpp}``, which wrapped OpenCV-contrib's BTV-L1
with hardcoded paths and was never used).

Counterpart of the JAX package's ``video/super_resolver.py``: for each
output frame, the frames of a sliding temporal window are registered against
it (phase correlation) and fused by the IRLS MAP solver with a BTV term --
the same math as the reference's BTV-L1 target, built from the framework's
own pieces. Everything runs on the resolver's device (default ``"cuda"``,
which raises without a card): registration, one ``IRLSMapSolver`` per window
(whose shifts are fractional and live on the device, so the BTV kernels
read them from device memory), and the linear upsample that starts it. With
``fused_irls`` the windows share one built fused solve
(``solvers/irls.py``'s cache): the graphs are captured for the first window
and replayed for the others with the new frames and shifts.
"""

from __future__ import annotations

import torch

from super_resolution_tpu_torch._device import as_tensor, resolve_device
from super_resolution_tpu_torch.models.image_model import ImageModel, ImageModelParameters
from super_resolution_tpu_torch.motion.motion_shift import MotionShift, MotionShiftSequence
from super_resolution_tpu_torch.motion.registration import translational_registration
from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu_torch.ops.resize import linear_resize
from super_resolution_tpu_torch.solvers.irls import IRLSMapSolver
from super_resolution_tpu_torch.solvers.map_solver import IRLSMapSolverOptions

__all__ = ["VideoSuperResolver"]


class VideoSuperResolver:
    def __init__(
        self,
        scale: int = 2,
        temporal_window: int = 4,
        blur_radius: int = 3,
        blur_sigma: float = 1.0,
        btv_scale_range: int = 2,
        btv_spatial_decay: float = 0.7,
        regularization_parameter: float = 0.01,
        solver_options: IRLSMapSolverOptions | None = None,
        robust_registration: bool = False,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ):
        self.scale = scale
        self.temporal_window = temporal_window
        self.blur_radius = blur_radius
        self.blur_sigma = blur_sigma
        self.btv_scale_range = btv_scale_range
        self.btv_spatial_decay = btv_spatial_decay
        self.regularization_parameter = regularization_parameter
        # Per-block consensus registration (the RANSAC analog) for streams
        # with corrupted regions or locally violated translation.
        self.robust_registration = robust_registration
        self.solver_options = solver_options or IRLSMapSolverOptions(
            max_num_irls_iterations=3, max_num_solver_iterations=25,
            # Video is not a reference-parity surface (the reference's video
            # wrapper never ran): the exact-step solver, one objective
            # evaluation per iteration.
            least_squares_solver="linear_cg",
        )
        self.device = resolve_device(device)
        self.dtype = dtype
        # The solver of the last window (its inner calls, fused runs, shifts).
        self.last_solver: IRLSMapSolver | None = None

    def super_resolve_frame(self, frames, center_index: int) -> torch.Tensor:
        """Super-resolve one frame of a ``[K, C, h, w]`` stack (array or
        tensor) using its temporal neighbourhood; returns ``[C, H, W]`` on the
        resolver's device."""
        frames = as_tensor(frames, self.device, self.dtype)
        k = frames.shape[0]
        half = self.temporal_window // 2
        lo = max(0, min(center_index - half, k - self.temporal_window))
        window = frames[lo: lo + self.temporal_window]
        # The window, centre frame first, the others in order.
        c = min(center_index - lo, window.shape[0] - 1)
        center = window[c]
        ordered = torch.cat([center[None], window[:c], window[c + 1:]])
        # Registration shifts are in LR pixels; the image model warps the HR
        # estimate: convert to HR pixels (x scale).
        seq_lr = translational_registration(list(ordered), robust=self.robust_registration, device=self.device)
        seq = MotionShiftSequence([MotionShift(s.dx * self.scale, s.dy * self.scale) for s in seq_lr])
        params = ImageModelParameters(
            scale=self.scale,
            blur_radius=self.blur_radius,
            blur_sigma=self.blur_sigma,
            motion_sequence=seq,
        )
        model = ImageModel.create(params)
        solver = IRLSMapSolver(self.solver_options, model, list(ordered), device=self.device, dtype=self.dtype)
        solver.add_regularizer(
            BilateralTotalVariationRegularizer(self.btv_scale_range, self.btv_spatial_decay),
            self.regularization_parameter,
        )
        self.last_solver = solver
        h, w = center.shape[-2] * self.scale, center.shape[-1] * self.scale
        return solver.solve(linear_resize(center, (h, w)))

    def super_resolve(self, frames) -> torch.Tensor:
        """Super-resolve every frame; returns ``[K, C, H, W]`` on the resolver's device."""
        frames = as_tensor(frames, self.device, self.dtype)
        return torch.stack([self.super_resolve_frame(frames, i) for i in range(frames.shape[0])])
