from super_resolution_tpu_torch.spectral.pca import SpectralPCA  # noqa: F401
