"""Pure-function compute operators on ``[..., H, W]`` tensors."""

from super_resolution_tpu_torch.ops.resize import decimate, zero_upsample  # noqa: F401
from super_resolution_tpu_torch.ops.warp import (  # noqa: F401
    translate,
    translate_adjoint,
    translate_static,
)
from super_resolution_tpu_torch.ops.blur import (  # noqa: F401
    blur,
    blur_adjoint,
    correlate2d,
    gaussian_kernel_1d,
    gaussian_kernel_2d,
)
