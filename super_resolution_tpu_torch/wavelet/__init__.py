from super_resolution_tpu_torch.wavelet.haar import (  # noqa: F401
    WaveletCoefficients,
    inverse_wavelet_transform,
    wavelet_transform,
)
