"""super_resolution_tpu_torch — the PyTorch/CUDA port of super_resolution_tpu.

Same subpackage layout and names as the JAX package, so the counterpart of
each module is found at the same path. The port imports ``torch`` and
``numpy`` only. Arrays keep the JAX package's layout at public functions:
HR estimate ``[C, H, W]``, LR stack ``[K, C, H/s, W/s]``, shifts ``[K, 2]``
with columns (dx, dy).

Ported so far: the single-device MAP solve — image model, fused MAP
objective (hand-written CUDA kernels on a CUDA tensor, their plain PyTorch
version on a CPU tensor), linear-CG / Wolfe-CG inner solvers, IRLS host
loop, PSNR. Everything else raises ``NotImplementedError`` or is absent.

Entry points that place data (``IRLSMapSolver``, ``make_map_value_and_grad``,
``convert``) default to ``device="cuda"`` and raise when no CUDA device is
present; pass ``device="cpu"`` explicitly to run the plain versions.
"""

__version__ = "0.1.0"

from super_resolution_tpu_torch.models.image_model import (  # noqa: F401
    ImageModel,
    ImageModelParameters,
)
from super_resolution_tpu_torch.solvers.irls import IRLSMapSolver  # noqa: F401
from super_resolution_tpu_torch.solvers.map_solver import (  # noqa: F401
    IRLSMapSolverOptions,
    MapSolverOptions,
)
