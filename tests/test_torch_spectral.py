"""Spectral PCA of the port against the JAX package's, float64 on the CPU.

The same numpy cubes go to both. Basis and mean agree to ``1e-12`` (both run
the same numpy SVD on the same samples), projection and back-projection to
``1e-10`` (a matrix product summed in another order); after
``convert.spectral_pca`` the two objects hold the same arrays exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.spectral import SpectralPCA as JPCA

from super_resolution_tpu_torch import convert
from super_resolution_tpu_torch.image import ImageData, SpectralMode
from super_resolution_tpu_torch.spectral import SpectralPCA


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cube(bands, hw, seed, rank=3):
    """Low spectral rank plus a little noise, like a real cube."""
    rng = np.random.default_rng(seed)
    maps = rng.random((rank, *hw))
    lam = np.linspace(0.0, 1.0, bands)[:, None]
    sigs = np.exp(-((lam - np.linspace(0.2, 0.8, rank)) ** 2) / (2 * 0.2**2))  # [bands, rank]
    cube = np.tensordot(sigs, maps, axes=1) + 0.002 * rng.standard_normal((bands, *hw))
    return cube


@pytest.mark.parametrize("kw", [dict(), dict(num_pca_bands=3), dict(retained_variance=0.999), dict(num_pca_bands=50)])
@pytest.mark.parametrize("num_images", [1, 3])
def test_basis_and_mean_match_jax(kw, num_images):
    cubes = [_cube(12, (10, 14), 30 + i) for i in range(num_images)]
    ours, theirs = SpectralPCA(cubes, **kw), JPCA(cubes, **kw)
    assert ours.num_pca_bands == theirs.num_pca_bands and ours.num_spectral_bands == 12
    np.testing.assert_allclose(ours.mean, theirs.mean, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.basis, theirs.basis, rtol=0, atol=1e-12)
    # Canonical sign: the largest-|.| entry of each component is positive.
    assert (ours.basis[np.arange(ours.num_pca_bands), np.abs(ours.basis).argmax(axis=1)] > 0).all()
    # Tensors train the same basis as arrays.
    again = SpectralPCA([torch.from_numpy(c) for c in cubes], **kw)
    np.testing.assert_array_equal(again.basis, ours.basis)


@pytest.mark.parametrize("k", [2, 4, 12])
def test_projection_matches_jax_after_convert(k):
    cube = _cube(12, (9, 11), 40)
    theirs = JPCA([cube], num_pca_bands=k)
    ours = convert.spectral_pca(theirs.mean, theirs.basis)
    np.testing.assert_array_equal(ours.mean, np.asarray(theirs.mean))
    np.testing.assert_array_equal(ours.basis, np.asarray(theirs.basis))
    x = torch.from_numpy(cube)
    coeffs = ours.project(x)
    jcoeffs = theirs.project(jnp.asarray(cube))
    assert coeffs.shape == (k, 9, 11) and coeffs.dtype == torch.float64
    np.testing.assert_allclose(coeffs.numpy(), np.asarray(jcoeffs), rtol=0, atol=1e-10)
    back = ours.back_project(coeffs)
    np.testing.assert_allclose(back.numpy(), np.asarray(theirs.back_project(jcoeffs)), rtol=0, atol=1e-10)
    if k == 12:  # full rank: the round trip is exact
        np.testing.assert_allclose(back.numpy(), cube, rtol=0, atol=1e-10)


def test_truncated_reconstruction_keeps_a_low_rank_cube():
    cube = _cube(16, (12, 12), 41)
    pca = SpectralPCA([cube], retained_variance=0.999)
    assert pca.num_pca_bands <= 4
    x = torch.from_numpy(cube)
    err = (pca.back_project(pca.project(x)) - x).abs().max()
    assert float(err) < 0.02
    # float32 in, float32 out.
    assert pca.project(x.float()).dtype == torch.float32


def test_image_wrappers_return_tensors():
    """The wrappers return ``ImageData`` over tensors, in the JAX package's spectral modes."""
    cube = _cube(6, (8, 8), 42)
    pca = SpectralPCA([cube], num_pca_bands=2)
    image = pca.get_pca_image(cube, device="cpu", dtype=torch.float64)
    assert isinstance(image, ImageData) and image.spectral_mode == SpectralMode.HYPERSPECTRAL_PCA
    assert isinstance(image.array, torch.Tensor) and image.array.shape == (2, 8, 8)
    assert torch.equal(image.array, pca.project(torch.from_numpy(cube)))
    back = pca.reconstruct_image(image.array.numpy(), device="cpu", dtype=torch.float64)
    assert back.spectral_mode == SpectralMode.HYPERSPECTRAL
    assert torch.equal(back.array, pca.back_project(image.array))
    # An ImageData or a tensor stays on its device.
    assert torch.equal(pca.reconstruct_image(image).array, back.array)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pca.get_pca_image(cube)


def test_pca_rejects_bad_input():
    with pytest.raises(ValueError, match="At least one image"):
        SpectralPCA([])
    with pytest.raises(ValueError, match="retained_variance"):
        SpectralPCA([_cube(4, (6, 6), 1)], retained_variance=1.5)
    with pytest.raises(ValueError, match="Inconsistent"):
        SpectralPCA([_cube(4, (6, 6), 1), _cube(5, (6, 6), 2)])
    with pytest.raises(ValueError, match="mean"):
        convert.spectral_pca(np.zeros(3), np.zeros((2, 4)))
