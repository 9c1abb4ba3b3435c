"""The port's image model against the JAX package's, float64 on the CPU.

Same numpy inputs on both sides; ``atol 1e-12`` (same arithmetic, summation
order of the blur taps differs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.models import image_model as jmodel
from super_resolution_tpu.motion import MotionShiftSequence as JSequence

from super_resolution_tpu_torch.models import image_model as tmodel
from super_resolution_tpu_torch.motion import MotionShiftSequence

ATOL = 1e-12
SHIFTS = [(0, 0), (1, 1), (-1.5, 0.25), (0.5, -2.0)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _models(scale, blur_radius, blur_sigma, shifts=SHIFTS):
    ours = tmodel.ImageModel.create(tmodel.ImageModelParameters(
        scale=scale, blur_radius=blur_radius, blur_sigma=blur_sigma,
        motion_sequence=MotionShiftSequence(shifts)))
    theirs = jmodel.ImageModel.create(jmodel.ImageModelParameters(
        scale=scale, blur_radius=blur_radius, blur_sigma=blur_sigma,
        motion_sequence=JSequence(shifts)))
    return ours, theirs


def _close(ours, theirs):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0.0, atol=ATOL)


@pytest.mark.parametrize("scale,blur_radius,blur_sigma", [(2, 3, 1.0), (4, 3, 1.5), (2, 0, 0.0), (3, 5, 0.8)])
@pytest.mark.parametrize("index", range(len(SHIFTS)))
def test_apply_and_transpose_match_jax(scale, blur_radius, blur_sigma, index):
    rng = np.random.default_rng(20 + index)
    x = rng.random((2, 24, 36))
    ours, theirs = _models(scale, blur_radius, blur_sigma)
    low = ours.apply(torch.from_numpy(x), index)
    _close(low, theirs.apply(jnp.asarray(x), index))
    r = rng.random(tuple(low.shape))
    _close(ours.apply_transpose(torch.from_numpy(r), index), theirs.apply_transpose(jnp.asarray(r), index))


@pytest.mark.parametrize("dx,dy", [(0.0, 0.0), (1.0, -1.0), (0.75, 1.5), (-2.25, -0.5)])
@pytest.mark.parametrize("with_blur", [True, False])
def test_degrade_and_adjoint_match_jax(dx, dy, with_blur):
    rng = np.random.default_rng(30)
    x = rng.random((3, 16, 20))
    kern = rng.random((3, 3)) if with_blur else None
    jkern = None if kern is None else jnp.asarray(kern)
    low = tmodel.degrade(torch.from_numpy(x), dx, dy, kern, 2)
    _close(low, jmodel.degrade(jnp.asarray(x), dx, dy, jkern, 2))
    r = rng.random(tuple(low.shape))
    _close(
        tmodel.degrade_adjoint(torch.from_numpy(r), dx, dy, kern, 2),
        jmodel.degrade_adjoint(jnp.asarray(r), dx, dy, jkern, 2),
    )


def test_operator_accessors_and_validation():
    ours, theirs = _models(2, 3, 1.0)
    np.testing.assert_array_equal(ours.blur_operator.kernel, theirs.blur_operator.kernel)
    assert ours.motion_operator is not None and ours.downsampling_scale == 2
    no_motion = tmodel.ImageModel.create(tmodel.ImageModelParameters(scale=2))
    assert no_motion.motion_operator is None and no_motion.blur_operator is None
    with pytest.raises(ValueError):
        tmodel.BlurOperator(4, 1.0)
    with pytest.raises(ValueError):
        tmodel.DownsamplingOperator(0)
    # The dense-matrix oracle: JAX's matrix exactly, and its size caps.
    np.testing.assert_array_equal(ours.blur_operator.operator_matrix((4, 4), 0),
                                  theirs.blur_operator.operator_matrix((4, 4), 0))
    with pytest.raises(ValueError, match="too big"):
        ours.blur_operator.operator_matrix((31, 4), 0)
    with pytest.raises(ValueError, match="too big"):
        tmodel.kernel_to_operator_matrix(np.ones((11, 3)), (4, 4))
    with pytest.raises(ValueError, match="no operators"):
        tmodel.ImageModel(2).operator_matrix((4, 4), 0)


def test_noise_operator_uses_an_explicit_generator():
    x = torch.zeros(1, 32, 32, dtype=torch.float64)
    gen = torch.Generator().manual_seed(5)
    a = tmodel.NoiseOperator(5.0, generator=gen).apply(x, 0)
    b = tmodel.NoiseOperator(5.0, generator=torch.Generator().manual_seed(5)).apply(x, 0)
    assert torch.equal(a, b)
    seeded = tmodel.NoiseOperator(5.0, seed=3)
    assert torch.equal(seeded.apply(x, 1), seeded.apply(x, 1))
    assert not torch.equal(seeded.apply(x, 1), seeded.apply(x, 2))
    assert abs(float(a.std()) - 5.0 / 255.0) < 0.2 * 5.0 / 255.0
    assert torch.equal(seeded.apply_transpose(x, 0), x)
    model = tmodel.ImageModel.create(tmodel.ImageModelParameters(scale=2, noise_sigma=2.0, noise_seed=1))
    assert model.apply(x, 0).shape == (1, 16, 16)


# ------------------------------------------------- the operator-matrix oracle
# ``tests/test_image_model.py``'s goldens (``test_image_model.cpp``), held
# exactly, and each matrix equal to the JAX package's.

SMALL_TEST_IMAGE = np.array([[1, 2, 3, 4, 5, 6], [7, 8, 9, 0, 1, 2], [9, 7, 5, 4, 2, 1], [2, 4, 6, 8, 0, 1]],
                            dtype=np.float64)


def test_kernel_to_operator_matrix_golden():
    """Hand-computed 6x6 matrix from ``test_image_model.cpp:49-78``."""
    kernel = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float64)
    mat = tmodel.kernel_to_operator_matrix(kernel, (2, 3))
    expected = np.array([[0, 2, 0, 0, 1, 0], [-2, 0, 2, -1, 0, 1], [0, -2, 0, 0, -1, 0],
                         [0, 1, 0, 0, 2, 0], [-1, 0, 1, -2, 0, 2], [0, -1, 0, 0, -2, 0]], dtype=np.float64)
    np.testing.assert_array_equal(mat, expected)
    np.testing.assert_array_equal(mat, jmodel.kernel_to_operator_matrix(kernel, (2, 3)))
    np.testing.assert_array_equal(mat @ np.array([1, 3, 5, 9, 5, 2.0]), [11, 1, -11, 13, -10, -13])


def test_downsampling_matrix_golden():
    """Selection matrix and its zero-interleaving transpose (``test_image_model.cpp:171-226``)."""
    op, jop = tmodel.DownsamplingOperator(2), jmodel.DownsamplingOperator(2)
    mat = op.operator_matrix((4, 6), 0)
    np.testing.assert_array_equal(mat, jop.operator_matrix((4, 6), 0))
    assert mat.shape == (6, 24)
    np.testing.assert_array_equal(mat @ SMALL_TEST_IMAGE.reshape(-1), [1, 3, 5, 9, 5, 2])
    expected_up = np.zeros((8, 12))
    expected_up[::2, ::2] = SMALL_TEST_IMAGE
    up = op.operator_matrix((8, 12), 0).T
    assert up.shape == (96, 24)
    np.testing.assert_array_equal((up @ SMALL_TEST_IMAGE.reshape(-1)).reshape(8, 12), expected_up)
    np.testing.assert_array_equal(op.apply_transpose(torch.from_numpy(SMALL_TEST_IMAGE), 0).numpy(), expected_up)


def test_motion_matrices_golden():
    """Shift matrices for (0,0), (1,1), (-1,0) (``test_image_model.cpp:229-348``); fractional shifts truncate."""
    shifts = [(0, 0), (1, 1), (-1, 0), (1.75, -0.5)]
    op = tmodel.MotionOperator(MotionShiftSequence(shifts))
    jop = jmodel.MotionOperator(JSequence(shifts))
    np.testing.assert_array_equal(op.operator_matrix((3, 3), 0), np.eye(9))
    expected = np.zeros((9, 9))
    expected[4, 0] = expected[5, 1] = expected[7, 3] = expected[8, 4] = 1
    np.testing.assert_array_equal(op.operator_matrix((3, 3), 1), expected)
    expected = np.zeros((9, 9))
    for out_idx, in_idx in [(0, 1), (1, 2), (3, 4), (4, 5), (6, 7), (7, 8)]:
        expected[out_idx, in_idx] = 1
    np.testing.assert_array_equal(op.operator_matrix((3, 3), 2), expected)
    for k in range(len(shifts)):
        np.testing.assert_array_equal(op.operator_matrix((3, 4), k), jop.operator_matrix((3, 4), k))
    img = np.arange(9, dtype=np.float64).reshape(3, 3) / 10.0
    for k in range(3):  # integer shifts: the warp is the matrix, and its transpose the adjoint
        mat = op.operator_matrix((3, 3), k)
        np.testing.assert_allclose(op.apply(torch.from_numpy(img), k).numpy().reshape(-1), mat @ img.reshape(-1),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(op.apply_transpose(torch.from_numpy(img), k).numpy().reshape(-1),
                                   mat.T @ img.reshape(-1), rtol=0, atol=1e-12)


def test_blur_golden():
    """Standard-kernel blur golden, sigma 0.849321 (``test_image_model.cpp:350-408``)."""
    op = tmodel.BlurOperator(3, 0.849321)
    expected = np.array([[1.875, 3.0, 3.125, 2.625, 2.75, 2.4375], [4.5625, 6.25, 5.3125, 3.1875, 2.3125, 1.9375],
                         [5.0, 6.5, 5.75, 3.875, 1.9375, 0.9375], [2.5625, 3.75, 4.3125, 3.6875, 1.6875, 0.5]])
    mat = op.operator_matrix((4, 6), 0)
    np.testing.assert_array_equal(mat, jmodel.BlurOperator(3, 0.849321).operator_matrix((4, 6), 0))
    for out in (mat @ SMALL_TEST_IMAGE.reshape(-1), mat.T @ SMALL_TEST_IMAGE.reshape(-1)):
        np.testing.assert_allclose(out.reshape(4, 6), expected, rtol=0, atol=0.001)
    np.testing.assert_allclose(op.apply(torch.from_numpy(SMALL_TEST_IMAGE), 0).numpy(), expected, rtol=0,
                               atol=0.001)


def test_model_matrix_composition_order():
    """op3 @ (op2 @ op1), mirroring the gmock test (``test_image_model.cpp:444-488``)."""

    class FixedOperator(tmodel.DegradationOperator):
        def __init__(self, mat):
            self.mat = np.asarray(mat, dtype=np.float64)

        def operator_matrix(self, hw, index):
            return self.mat

    op1 = FixedOperator([[0, 0, 0, -3], [4, 3, 2, 1], [3, 1, 4, 9], [1, 0, 0, 1]])
    op2 = FixedOperator([[0, 2, 0, 5], [1, 1, 1, 1], [0, 0, 0, 0], [1, 2, 3, -4]])
    op3 = FixedOperator([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]])
    model = tmodel.ImageModel(2, [op1, op2, op3])
    expected = np.array([[13, 6, 4, 7], [8, 4, 6, 8], [0, 0, 0, 0]], dtype=np.float64)
    np.testing.assert_array_equal(model.operator_matrix((2, 2), 0), expected)
    np.testing.assert_array_equal(model.model_matrix((2, 2), 0), expected)
    np.testing.assert_array_equal(tmodel.NoiseOperator(1.0).operator_matrix((2, 3), 0), np.eye(6))


def test_full_model_apply_matches_matrix():
    """``A_k x`` through the operators equals the dense ``A_k @ x`` (and the
    adjoint ``A_k^T r``), and ``A_k`` is the JAX package's, for the composed model."""
    shifts = [(0, 0), (1, 0), (0, 1)]
    ours, theirs = _models(2, 3, 1.0, shifts)
    rng = np.random.default_rng(2)
    x = rng.random((8, 8))
    for k in range(len(shifts)):
        a = ours.operator_matrix((8, 8), k)
        np.testing.assert_array_equal(a, theirs.model_matrix((8, 8), k))
        np.testing.assert_allclose(ours.apply(torch.from_numpy(x), k).numpy(), (a @ x.reshape(-1)).reshape(4, 4),
                                   rtol=0, atol=1e-10)
        r = rng.random((4, 4))
        np.testing.assert_allclose(ours.apply_transpose(torch.from_numpy(r), k).numpy(),
                                   (a.T @ r.reshape(-1)).reshape(8, 8), rtol=0, atol=1e-10)
