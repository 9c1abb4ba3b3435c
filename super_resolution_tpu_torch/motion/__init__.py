from super_resolution_tpu_torch.motion.motion_shift import (  # noqa: F401
    MotionShift,
    MotionShiftSequence,
)
