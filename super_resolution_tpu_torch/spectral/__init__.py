from super_resolution_tpu_torch.spectral.pca import SpectralPCA  # noqa: F401
from super_resolution_tpu_torch.spectral.envi import (  # noqa: F401
    HSIBinaryDataParameters,
    HyperspectralDataLoader,
    read_envi_header,
)
