"""SSIM and the evaluator classes of the port against the JAX package's.

Same numpy inputs, float64 on the CPU, ``atol 1e-12`` (the same reductions;
only the order of the sums inside ``mean`` differs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu import evaluation as jev

from super_resolution_tpu_torch import evaluation as ev

ATOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(shape, seed, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.random(shape)
    return a, np.clip(a + noise * rng.standard_normal(shape), 0, 1)


@pytest.mark.parametrize("shape,kw", [((3, 8, 9), {}), ((8, 9), {}), ((1, 16, 12), dict(k1=0.02, k2=0.05, image_scale=2.0))])
def test_ssim_matches_jax(shape, kw):
    a, b = _pair(shape, 14)
    ours = ev.ssim(torch.from_numpy(a), b, **kw)
    theirs = jev.ssim(jnp.asarray(a), jnp.asarray(b), **kw)
    assert ours.ndim == 0 and abs(float(ours) - float(theirs)) <= ATOL


def test_ssim_identity_and_symmetry():
    a, b = _pair((2, 10, 10), 15)
    assert abs(float(ev.ssim(a, a)) - 1.0) < 1e-12
    assert abs(float(ev.ssim(a, b)) - float(ev.ssim(b, a))) < 1e-12
    assert float(ev.ssim(a, b)) < 1.0


@pytest.mark.parametrize("cls,jcls", [
    (ev.PeakSignalToNoiseRatioEvaluator, jev.PeakSignalToNoiseRatioEvaluator),
    (ev.StructuralSimilarityEvaluator, jev.StructuralSimilarityEvaluator),
])
@pytest.mark.parametrize("shape", [(2, 12, 10), (2, 6, 5), (2, 18, 20)])
def test_evaluators_match_jax_and_resize_mismatched_input(cls, jcls, shape):
    gt, _ = _pair((2, 12, 10), 16)
    image, _ = _pair(shape, 17)
    ours = cls(gt).evaluate(torch.from_numpy(image))
    theirs = jcls(jnp.asarray(gt)).evaluate(jnp.asarray(image))
    assert isinstance(ours, float) and abs(ours - theirs) <= 1e-10


def test_evaluator_rejects_a_different_channel_count():
    with pytest.raises(ValueError, match="channels"):
        ev.PeakSignalToNoiseRatioEvaluator(np.zeros((3, 4, 4))).evaluate(np.zeros((1, 4, 4)))
    with pytest.raises(NotImplementedError):
        ev.GroundTruthEvaluator(np.zeros((1, 4, 4))).evaluate(np.zeros((1, 4, 4)))
