from super_resolution_tpu_torch.models.image_model import (  # noqa: F401
    BlurOperator,
    DegradationOperator,
    DownsamplingOperator,
    ImageModel,
    ImageModelParameters,
    MotionOperator,
    NoiseOperator,
    degrade,
    degrade_adjoint,
)
