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
    with pytest.raises(NotImplementedError):
        ours.blur_operator.operator_matrix((4, 4), 0)


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
