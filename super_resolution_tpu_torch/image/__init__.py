from super_resolution_tpu_torch.image.image_data import (  # noqa: F401
    ImageData,
    ImageDataReport,
    SpectralMode,
)
from super_resolution_tpu_torch.image.color import bgr_to_ycrcb, ycrcb_to_bgr  # noqa: F401
