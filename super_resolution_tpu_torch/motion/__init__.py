from super_resolution_tpu_torch.motion.motion_shift import (  # noqa: F401
    MotionShift,
    MotionShiftSequence,
)
from super_resolution_tpu_torch.motion.refinement import (  # noqa: F401
    make_shift_refiner,
    refine_shifts,
)
from super_resolution_tpu_torch.motion.registration import (  # noqa: F401
    phase_correlation_shift,
    robust_phase_correlation_shift,
    translational_registration,
)
