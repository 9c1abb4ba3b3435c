"""Registration of the port against the JAX package's, float64 on the CPU.

Both sides take three ``argmax`` readings on a grid of ``1/upsample_factor``
px, so a last-bit difference between two FFT libraries can move an estimate
to the neighbouring grid point: port and JAX agree within
``1/upsample_factor`` per axis (they agree exactly on most inputs).
Separately, the reference's accuracy contract (known shifts recovered within
0.01 px, ``test/test_registration.cpp:20``) is held on a seeded band-limited
scene warped by the port's own ``translate``, with the shifts of
``tests/test_registration.py`` (whose image is not in the repo).
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.motion import registration as jreg

from super_resolution_tpu_torch.motion import registration as reg
from super_resolution_tpu_torch.ops.warp import translate_static

CONTRACT = 0.01
UPSAMPLE = 256
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(h, w, seed=3, cutoff=0.12):
    """Random texture, band-limited by a Gaussian in the frequency domain."""
    rng = np.random.default_rng(seed)
    fy, fx = np.fft.fftfreq(h)[:, None], np.fft.fftfreq(w)[None, :]
    spectrum = np.fft.fft2(rng.standard_normal((h, w))) * np.exp(-(fy**2 + fx**2) / (2 * cutoff**2))
    img = np.real(np.fft.ifft2(spectrum))
    return (img - img.min()) / (img.max() - img.min())


SCENE = _scene(120, 136)


def _shifted(dx, dy, scene=SCENE):
    return translate_static(torch.from_numpy(scene), dx, dy).numpy()


@pytest.mark.parametrize("dx,dy", [(0.5, 0.25), (-1.25, 2.75), (3.5, -0.5), (5.0, 5.0), (-5.0, -1.0), (0.0, 0.0)])
def test_phase_correlation_matches_jax_and_holds_the_contract(dx, dy):
    frame = _shifted(dx, dy)
    ours = reg.phase_correlation_shift(SCENE, frame, **CPU)
    theirs = jreg.phase_correlation_shift(jnp.asarray(SCENE), jnp.asarray(frame))
    assert ours[0].dtype == torch.float64 and ours[0].ndim == 0
    for mine, other, true in zip(ours, theirs, (dx, dy)):
        assert abs(float(mine) - float(other)) <= 1.0 / UPSAMPLE + 1e-12
        assert abs(float(mine) - true) <= CONTRACT


def test_translational_registration_matches_jax_on_the_reference_shifts():
    truth = [(0, 0), (0, 1), (2, 0), (5, 5), (-5, -1), (1.5, -2.25)]
    frames = [_shifted(dx, dy) for dx, dy in truth]
    ours = reg.translational_registration(frames, **CPU)
    theirs = jreg.translational_registration([jnp.asarray(f) for f in frames])
    assert len(ours) == len(truth) and (ours[0].dx, ours[0].dy) == (0, 0)
    assert np.abs(ours.as_array() - theirs.as_array()).max() <= 1.0 / UPSAMPLE + 1e-12
    assert np.abs(ours.as_array() - np.asarray(truth, dtype=float)).max() <= CONTRACT
    # A stacked tensor is taken like a list, and an empty input gives an empty sequence.
    again = reg.translational_registration(torch.from_numpy(np.stack(frames)), **CPU)
    np.testing.assert_array_equal(again.as_array(), ours.as_array())
    assert len(reg.translational_registration([], **CPU)) == 0


def test_registration_uses_channel_0_and_takes_float32():
    img3 = np.stack([SCENE, SCENE[::-1], SCENE * 0.5])
    moved = translate_static(torch.from_numpy(img3), 2.0, -1.0)
    est = reg.translational_registration([torch.from_numpy(img3), moved], **CPU)
    assert abs(est[1].dx - 2.0) <= CONTRACT and abs(est[1].dy + 1.0) <= CONTRACT
    est32 = reg.translational_registration([torch.from_numpy(img3).float(), moved.float()], **CPU)
    assert abs(est32[1].dx - 2.0) <= CONTRACT and abs(est32[1].dy + 1.0) <= CONTRACT
    with pytest.raises(ValueError, match="image"):
        reg.translational_registration([np.zeros((2, 2, 8, 8))], **CPU)


def test_robust_registration_on_clean_data_is_the_global_estimate():
    truth = [(0, 0), (5, 5), (0.5, 0.25)]
    frames = [_shifted(dx, dy) for dx, dy in truth]
    ours = reg.translational_registration(frames, robust=True, **CPU)
    theirs = jreg.translational_registration([jnp.asarray(f) for f in frames], robust=True)
    assert np.abs(ours.as_array() - theirs.as_array()).max() <= 1.0 / UPSAMPLE + 1e-12
    assert np.abs(ours.as_array() - np.asarray(truth, dtype=float)).max() <= CONTRACT


def test_robust_registration_votes_out_a_corrupted_block_like_jax():
    dx, dy = 3.0, -2.0
    frame = _shifted(dx, dy).copy()
    bh, bw = frame.shape[0] // 3, frame.shape[1] // 3
    frame[:bh, :bw] = _shifted(-8.0, 7.0)[:bh, :bw]  # content moved the wrong way
    est_dx, est_dy, inliers = reg.robust_phase_correlation_shift(SCENE, frame, **CPU)
    jdx, jdy, jinliers = jreg.robust_phase_correlation_shift(jnp.asarray(SCENE), jnp.asarray(frame))
    assert isinstance(est_dx, float) and inliers.dtype == bool
    np.testing.assert_array_equal(inliers, jinliers)
    assert not inliers[0] and inliers.sum() >= 6
    assert abs(est_dx - jdx) <= 1.0 / UPSAMPLE + 1e-12 and abs(est_dy - jdy) <= 1.0 / UPSAMPLE + 1e-12
    assert abs(est_dx - dx) <= CONTRACT and abs(est_dy - dy) <= CONTRACT


def test_robust_registration_falls_back_with_few_inliers_and_rejects_small_blocks():
    img = np.random.default_rng(0).random((96, 96))
    frame = _shifted(1.5, -0.75, scene=img)
    est_dx, est_dy, _ = reg.robust_phase_correlation_shift(img, frame, block_grid=(2, 2), min_inliers=5, **CPU)
    assert abs(est_dx - 1.5) <= CONTRACT and abs(est_dy + 0.75) <= CONTRACT
    with pytest.raises(ValueError, match="too small"):
        reg.robust_phase_correlation_shift(img, frame, block_grid=(8, 8), **CPU)


def test_registration_has_no_host_fft_path_and_defaults_to_the_card():
    """The JAX package's numpy-FFT fallback is not carried over: every
    transform is ``torch.fft`` on the device the caller named."""
    tree = ast.parse(pathlib.Path(reg.__file__).read_text())
    attrs = {(n.value.id, n.attr) for n in ast.walk(tree)
             if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)}
    assert ("np", "fft") not in attrs and ("numpy", "fft") not in attrs
    assert not hasattr(reg, "_complex_fft_supported") and not hasattr(reg, "_translate_np")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            reg.translational_registration([SCENE, SCENE])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            reg.phase_correlation_shift(SCENE, SCENE)
