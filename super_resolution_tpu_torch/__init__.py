"""super_resolution_tpu_torch — the PyTorch/CUDA port of super_resolution_tpu.

Same subpackage layout and names as the JAX package, so the counterpart of
each module is found at the same path. The port imports ``torch`` and
``numpy`` only. Arrays keep the JAX package's layout at public functions:
HR estimate ``[C, H, W]``, LR stack ``[K, C, H/s, W/s]``, shifts ``[K, 2]``
with columns (dx, dy).

Ported so far: the single-device MAP solve — image model, fused MAP
objective (hand-written CUDA kernels on a CUDA tensor, their plain PyTorch
version on a CPU tensor) with a fused 2D TV, 3D spectral TV or BTV term,
the autodiff / numerical gradient modes, linear-CG / Wolfe-CG / L-BFGS inner
solvers, IRLS host loop with checkpoint/resume and the fused IRLS solve
(``fused_irls``: on a CUDA device the inner solver's steps and the IRLS seam
replay as CUDA graphs, ``solvers/graphs.py``, with the built graphs kept
across solver instances), the dense operator-matrix test oracle — with estimated motion
(phase-correlation registration, Gauss-Newton refinement of the shifts
between IRLS rounds) and hyperspectral cubes (many bands in one objective,
spectral PCA), the resizers, PSNR and SSIM — and the same solve on a device
mesh (``parallel``: band, frame and row/col shards with halo exchange,
``IRLSMapSolver(..., mesh=make_mesh(...))``) — and the command-line entry
points (``cli``: ``super_resolve``, ``generate_data``, ``shift_add_fusion``,
``visualize_image``) with what they reach: ``ImageData`` and colour
(``image``), PNG / BMP and ENVI I/O (``utils``, ``spectral.envi``, the
``native`` reader), the Haar wavelet (``wavelet``), ADMM and shift-and-add
(``solvers``) -- and video (``video``: ``VideoSuperResolver``, a sliding
window of registered frames solved with BTV per output frame, and
``VideoLoader``: frame directories; MP4 / QuickTime (``video/mp4.py``),
Matroska / WebM (``video/mkv.py``) and AVI with MPEG-4 Part 2 Simple Profile
video, decoded as ``cv2.VideoCapture`` decodes it by ``utils/mpeg4.py`` and
``native/mpeg4_decoder.cpp`` (FFmpeg's Xvid IDCT for streams it takes for
Xvid's) -- B-VOPs, GMC, quarter-pel, interlaced and data-partitioned streams
raise ``NotImplementedError`` --; Motion-JPEG AVI and Matroska through the
port's baseline JPEG decoder, ``utils/jpeg.py``; uncompressed AVI; VP8 by
``utils/vp8.py`` and VP9 by ``utils/vp9.py`` (``native/vp8_decoder.cpp``,
``native/vp9_decoder.cpp``) from WebM / Matroska, IVF and AVI, VP9 also from
MP4; FFV1 (versions 0-3, 8 bits) by ``utils/ffv1.py`` (``native/ffv1_decoder.cpp``)
from Matroska, AVI, MP4 and QuickTime; H.264 (progressive 8-bit 4:2:0,
I, P and B slices, CAVLC or CABAC, the 8x8 transform, scaling matrices, in
FFmpeg's output order) by ``utils/h264.py`` (``native/h264_decoder.cpp``)
from MP4 (with ``ctts`` composition offsets), Matroska, AVI and raw Annex B
streams; every YUV frame converted to BGR as cv2 converts it, at any size
(``native/swscale_bgr.h``); FFV1 above 8 bits, HuffYUV, HEVC, interlaced
H.264 and other codecs raise), the profiling
utilities (``utils/profiling.py``) and the test comparators
(``utils/testing.py``).

Entry points that place data (``IRLSMapSolver``, ``AdmmSolver``,
``make_map_value_and_grad``, ``translational_registration``, ``ImageData``,
``load_image``, the CLIs, ``convert``, ``VideoLoader``, ``VideoSuperResolver``) default to ``device="cuda"`` and raise
when no CUDA device is present; pass ``device="cpu"`` explicitly to run the
plain versions.
"""

__version__ = "0.1.0"

from super_resolution_tpu_torch.image.image_data import (  # noqa: F401
    ImageData,
    SpectralMode,
)
from super_resolution_tpu_torch.models.image_model import (  # noqa: F401
    ImageModel,
    ImageModelParameters,
)
from super_resolution_tpu_torch.motion.registration import (  # noqa: F401
    translational_registration,
)
from super_resolution_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from super_resolution_tpu_torch.solvers.irls import IRLSMapSolver, irls_solve_fused  # noqa: F401
from super_resolution_tpu_torch.solvers.map_solver import (  # noqa: F401
    IRLSMapSolverOptions,
    MapSolverOptions,
)
from super_resolution_tpu_torch.spectral.pca import SpectralPCA  # noqa: F401
