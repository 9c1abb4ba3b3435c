"""Motion refinement of the port against the JAX package's, float64 on the CPU.

The same numpy image, LR stack and starting shifts go to both
``refine_shifts``. Refined shifts agree to ``1e-9`` HR px: the same
Gauss-Newton steps, with the Jacobian in closed form here and by ``jax.jvp``
there, differ only in the order of the sums, and a 2x2 solve with Levenberg
damping amplifies that by a few orders at most. The closed-form shift
derivatives themselves are held against ``jax.jvp`` to ``1e-12``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.models.image_model import degrade as jdegrade
from super_resolution_tpu.motion.refinement import refine_shifts as jrefine
from super_resolution_tpu.ops.blur import gaussian_kernel_2d

from super_resolution_tpu_torch.models.image_model import degrade, degrade_with_shift_derivatives
from super_resolution_tpu_torch.motion.refinement import make_shift_refiner, refine_shifts
from super_resolution_tpu_torch.ops.warp import translate, translate_with_shift_derivatives

TRUE = np.array([(0, 0), (1.25, 0.5), (-0.75, 1.5), (0.5, -1.25)])
KERNEL = np.asarray(gaussian_kernel_2d(3, 1.0))
TOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _textured_image(c, h, w, seed=5):
    """Band-limited random texture: smooth enough for bilinear-warp physics,
    textured enough that the data term constrains subpixel motion."""
    rng = np.random.default_rng(seed)
    base = rng.random((c, h + 2, w + 2))
    sm = sum(KERNEL[i, j] * base[:, i:i + h, j:j + w] for i in range(3) for j in range(3))
    return (sm - sm.min()) / (sm.max() - sm.min())


def _problem(shifts=TRUE, c=1, hw=(32, 32), scale=2, kernel=KERNEL):
    x = _textured_image(c, *hw)
    xt = torch.from_numpy(x)
    obs = torch.stack([degrade(xt, float(dx), float(dy), kernel, scale) for dx, dy in shifts])
    return x, obs.numpy()


def _both(x, obs, start, kernel=KERNEL, scale=2, **kw):
    ours = refine_shifts(torch.from_numpy(x), torch.from_numpy(obs), torch.from_numpy(start), kernel, scale, **kw)
    theirs = jrefine(jnp.asarray(x), jnp.asarray(obs), jnp.asarray(start),
                     None if kernel is None else jnp.asarray(kernel), scale, **kw)
    assert ours.dtype == torch.float64 and ours.shape == start.shape
    return ours.numpy(), np.asarray(theirs)


@pytest.mark.parametrize("c,iterations", [(1, 3), (3, 1), (1, 2)])
def test_refined_shifts_match_jax_and_recover_the_motion(c, iterations):
    x, obs = _problem(c=c)
    rng = np.random.default_rng(11)
    start = TRUE + np.where(np.arange(4)[:, None] == 0, 0.0, rng.uniform(-0.12, 0.12, (4, 2)))
    ours, theirs = _both(x, obs, start, num_iterations=iterations)
    assert np.abs(ours - theirs).max() < TOL
    assert np.array_equal(ours[0], start[0])  # frame 0 stays pinned
    if iterations == 3:
        assert np.abs(start - TRUE).max() > 0.05
        assert np.abs(ours - TRUE).max() < 0.01


def test_integer_start_shifts_use_the_one_sided_derivative():
    """Registration times the scale can give exactly integer shifts; the
    derivative there is the difference towards the next tap, as ``jax.jvp``
    through ``floor`` gives."""
    true = np.array([(0, 0), (1.2, 0.9), (-0.8, 2.1), (2.15, -1.1)])
    x, obs = _problem(shifts=true)
    start = np.array([(0.0, 0.0), (1.0, 1.0), (-1.0, 2.0), (2.0, -1.0)])
    ours, theirs = _both(x, obs, start, num_iterations=2)
    assert np.abs(ours - theirs).max() < TOL
    assert np.abs(ours - true).max() < np.abs(start - true).max()


def test_flat_frames_stay_finite_like_jax():
    x = np.ones((1, 16, 16))
    obs = np.ones((2, 1, 8, 8))
    start = np.array([[0.0, 0.0], [0.3, -0.2]])
    ours, theirs = _both(x, obs, start, kernel=None)
    assert np.all(np.isfinite(ours))
    assert np.abs(ours - theirs).max() < TOL
    assert np.abs(ours - start).max() <= 0.5 * 3 + 1e-9
    # float32 frames: the additive floor keeps the determinant a normal number.
    out32 = refine_shifts(torch.ones(1, 16, 16), torch.ones(2, 1, 8, 8), torch.tensor(start), None, 2)
    assert out32.dtype == torch.float32 and bool(torch.isfinite(out32).all())


def test_pin_first_and_step_clip_and_damping_match_jax():
    x, obs = _problem()
    start = TRUE + np.array([(0.1, -0.1), (0.9, 0.0), (0.0, -0.9), (0.05, 0.05)])
    ours, theirs = _both(x, obs, start, num_iterations=1, pin_first=False, max_step=0.25, damping=1e-2)
    assert np.abs(ours - theirs).max() < TOL
    assert not np.array_equal(ours[0], start[0])            # frame 0 moves when it is not pinned
    assert np.abs(ours - start).max() <= 0.25 + 1e-12       # one clipped step


def test_shift_refiner_closure_and_input_checks():
    x, obs = _problem()
    start = TRUE + 0.05
    refiner = make_shift_refiner(KERNEL, 2, num_iterations=2)
    xt, ot = torch.from_numpy(x), torch.from_numpy(obs)
    a = refiner(xt, ot, torch.from_numpy(start))
    b = refine_shifts(xt, ot, start, KERNEL, 2, num_iterations=2)  # host values are taken too
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shifts for"):
        refine_shifts(xt, ot, start[:3], KERNEL, 2)


@pytest.mark.parametrize("dx,dy", [(1.25, -0.5), (2.0, -1.0), (0.0, 0.3), (-0.75, 3.0)])
def test_shift_derivatives_match_jax_jvp(dx, dy):
    x = _textured_image(2, 12, 14, seed=9)
    xt = torch.from_numpy(x)
    tdx, tdy = torch.tensor(dx, dtype=torch.float64), torch.tensor(dy, dtype=torch.float64)

    def predict(s):
        return jdegrade(jnp.asarray(x), s[0], s[1], jnp.asarray(KERNEL), 2)

    s = jnp.asarray([dx, dy])
    pred, j_dx = jax.jvp(predict, (s,), (jnp.asarray([1.0, 0.0]),))
    _, j_dy = jax.jvp(predict, (s,), (jnp.asarray([0.0, 1.0]),))
    ours = degrade_with_shift_derivatives(xt, tdx, tdy, KERNEL, 2)
    for mine, theirs in zip(ours, (pred, j_dx, j_dy)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=0, atol=1e-12)
    # The prediction is the ordinary forward model, for tensor and for host shifts.
    np.testing.assert_allclose(ours[0].numpy(), degrade(xt, dx, dy, KERNEL, 2).numpy(), rtol=0, atol=1e-14)
    warped, _, _ = translate_with_shift_derivatives(xt, tdx, tdy)
    assert torch.equal(warped, translate(xt, tdx, tdy))


def test_translate_takes_one_shift_per_batch_entry_without_reading_it_back():
    x = torch.from_numpy(_textured_image(3, 10, 12, seed=10))
    dxs = torch.tensor([0.5, -1.25, 7.0], dtype=torch.float64)
    dys = torch.tensor([2.0, 0.75, -30.0], dtype=torch.float64)
    frames = x.unsqueeze(1).expand(3, 2, 10, 12)
    out = translate(frames, dxs, dys)
    for i in range(3):
        expected = translate(frames[i], float(dxs[i]), float(dys[i]))
        np.testing.assert_allclose(out[i].numpy(), expected.numpy(), rtol=0, atol=1e-15)
    assert torch.count_nonzero(out[2]) == 0  # a shift beyond the image gives zeros
    with pytest.raises(ValueError, match="do not fit"):
        translate(frames, dxs[:2], dys[:2])
