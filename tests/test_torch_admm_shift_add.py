"""The port's ADMM solver, shift-and-add fusion and Haar transform against
the JAX package's, in float64 on the CPU, on the same seeded inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.image import ImageData as JImageData
from super_resolution_tpu.image import SpectralMode as JMode
from super_resolution_tpu.models import ImageModel as JImageModel
from super_resolution_tpu.models import ImageModelParameters as JParameters
from super_resolution_tpu.motion import MotionShiftSequence as JSequence
from super_resolution_tpu.ops.btv import BilateralTotalVariationRegularizer as JBTV
from super_resolution_tpu.ops.tv import TotalVariationRegularizer as JTV
from super_resolution_tpu.solvers import AdmmSolver as JAdmmSolver
from super_resolution_tpu.solvers import AdmmSolverOptions as JAdmmOptions
from super_resolution_tpu.solvers.admm import _g as j_g
from super_resolution_tpu.solvers.admm import _gt as j_gt
from super_resolution_tpu.solvers.admm import admm_solve as j_admm_solve
from super_resolution_tpu.solvers.shift_add import fill_holes as j_fill_holes
from super_resolution_tpu.solvers.shift_add import shift_add_fusion as j_shift_add_fusion
from super_resolution_tpu.wavelet import WaveletCoefficients as JCoefficients
from super_resolution_tpu.wavelet import inverse_wavelet_transform as j_inverse
from super_resolution_tpu.wavelet import wavelet_transform as j_transform

from super_resolution_tpu_torch import convert
from super_resolution_tpu_torch.image import ImageData, SpectralMode
from super_resolution_tpu_torch.models import ImageModel, ImageModelParameters
from super_resolution_tpu_torch.motion import MotionShiftSequence
from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu_torch.ops.cuda import degrade
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
from super_resolution_tpu_torch.solvers import AdmmSolver, AdmmSolverOptions
from super_resolution_tpu_torch.solvers.admm import _g, _gt, admm_solve
from super_resolution_tpu_torch.solvers.shift_add import fill_holes, shift_add_fusion
from super_resolution_tpu_torch.wavelet import WaveletCoefficients, inverse_wavelet_transform, wavelet_transform

CPU = dict(device="cpu", dtype=torch.float64)
SHIFTS = [(0, 0), (1, 1), (0, 1), (1, 0)]
ADMM_TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(c, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    return np.clip(0.5 + 0.3 * np.sin(xx / 3.0) * np.cos(yy / 4.0) + 0.1 * rng.random((c, h, w)), 0, 1)


def _problem(c=1, side=24, shifts=SHIFTS):
    """A 2x problem with a 3x3 blur: the port's and the JAX package's model, LR stack and start."""
    gt = _scene(c, side, side, 60)
    jparams = JParameters(scale=2, blur_radius=3, blur_sigma=1.0, motion_sequence=JSequence(shifts))
    jmodel = JImageModel.create(jparams)
    stack = np.stack([np.asarray(jmodel.apply(jnp.asarray(gt), k)) for k in range(len(shifts))])
    model = ImageModel.create(ImageModelParameters(scale=2, blur_radius=3, blur_sigma=1.0,
                                                   motion_sequence=MotionShiftSequence(shifts)))
    x0 = np.repeat(np.repeat(stack[0], 2, axis=-2), 2, axis=-1)
    return gt, jmodel, model, stack, x0


def test_difference_operator_and_adjoint():
    rng = np.random.default_rng(61)
    x, z = rng.normal(size=(2, 6, 7)), rng.normal(size=(2, 2, 6, 7))
    np.testing.assert_allclose(_g(torch.from_numpy(x)).numpy(), np.asarray(j_g(jnp.asarray(x))), rtol=0, atol=1e-14)
    np.testing.assert_allclose(_gt(torch.from_numpy(z)).numpy(), np.asarray(j_gt(jnp.asarray(z))), rtol=0, atol=1e-14)
    z[0, ..., :, -1] = 0.0
    z[1, ..., -1, :] = 0.0
    lhs = float(torch.sum(_g(torch.from_numpy(x)) * torch.from_numpy(z)))
    rhs = float(torch.sum(torch.from_numpy(x) * _gt(torch.from_numpy(z))))
    assert abs(lhs - rhs) < 1e-10


@pytest.mark.parametrize("tv_lambda", [0.01, 1e-8])
def test_admm_solve_equals_jax(tv_lambda):
    _, jmodel, model, stack, x0 = _problem()
    kernel = np.asarray(model.blur_operator.kernel)
    degrade.reset_launch_counts()
    result = admm_solve(torch.from_numpy(x0), torch.from_numpy(stack), np.asarray(SHIFTS, float), kernel, 2,
                        tv_lambda=tv_lambda, rho=1.0, num_iterations=5, cg_iterations=4)
    # One ADMM iteration is 2 + cg_iterations evaluations of the data term.
    assert degrade.plain_version_calls["calls"] == 5 * (2 + 4)
    jresult = j_admm_solve(jnp.asarray(x0), jnp.asarray(stack), jnp.asarray(SHIFTS, dtype=jnp.float64),
                           jnp.asarray(jmodel.blur_operator.kernel), 2, tv_lambda=tv_lambda, rho=1.0,
                           num_iterations=5, cg_iterations=4)
    jx = np.asarray(jresult.x)
    assert result.iterations == jresult.iterations == 5
    assert np.abs(result.x.numpy() - jx).max() <= ADMM_TOL * np.abs(jx).max()
    for ours, theirs in ((result.primal_residual, jresult.primal_residual),
                         (result.dual_residual, jresult.dual_residual)):
        assert abs(float(ours) - float(theirs)) <= ADMM_TOL * max(1.0, abs(float(theirs)))


@pytest.mark.parametrize("regularized", [True, False])
def test_admm_solver_equals_jax_and_returns_image_data(regularized):
    _, jmodel, model, stack, x0 = _problem(c=3)
    options = {"max_num_solver_iterations": 5, "rho": 0.5, "admm_cg_iterations": 4}
    solver = AdmmSolver(convert.admm_options(options), model, list(stack), **CPU)
    jsolver = JAdmmSolver(JAdmmOptions(**options), jmodel, [jnp.asarray(f) for f in stack])
    if regularized:
        solver.add_regularizer(TotalVariationRegularizer(), 0.02)
        jsolver.add_regularizer(JTV(), 0.02)
    start = ImageData(x0, normalize="never", channel_major=True, spectral_mode=SpectralMode.COLOR_YCRCB, **CPU)
    jstart = JImageData(jnp.asarray(x0), normalize="never", channel_major=True, spectral_mode=JMode.COLOR_YCRCB)
    out, jout = solver.solve(start), jsolver.solve(jstart)
    assert isinstance(out, ImageData) and out.spectral_mode == SpectralMode.COLOR_YCRCB
    assert jout.spectral_mode == JMode.COLOR_YCRCB
    jx = np.asarray(jout.array)
    assert np.abs(out.array.numpy() - jx).max() <= ADMM_TOL * np.abs(jx).max()
    # A tensor start gives a tensor.
    plain = solver.solve(torch.from_numpy(x0))
    assert isinstance(plain, torch.Tensor) and torch.equal(plain, out.array)
    with pytest.raises(ValueError, match="Initial estimate shape"):
        solver.solve(torch.zeros(3, 8, 8, dtype=torch.float64))


@pytest.mark.parametrize("case", ["btv", "tv3d", "two"])
def test_admm_solver_refusals_match_jax(case):
    _, jmodel, model, stack, x0 = _problem()
    solver = AdmmSolver(AdmmSolverOptions(max_num_solver_iterations=1), model, list(stack), **CPU)
    jsolver = JAdmmSolver(JAdmmOptions(max_num_solver_iterations=1), jmodel, [jnp.asarray(f) for f in stack])
    regs = {"btv": [(BilateralTotalVariationRegularizer(2, 0.5), JBTV(2, 0.5))],
            "tv3d": [(TotalVariationRegularizer(True), JTV(use_3d_total_variation=True))],
            "two": [(TotalVariationRegularizer(), JTV()), (TotalVariationRegularizer(), JTV())]}[case]
    for ours, theirs in regs:
        solver.add_regularizer(ours, 0.01)
        jsolver.add_regularizer(theirs, 0.01)
    with pytest.raises(ValueError) as jax_error:
        jsolver.solve(jnp.asarray(x0))
    with pytest.raises(ValueError) as port_error:
        solver.solve(torch.from_numpy(x0))
    assert str(port_error.value) == str(jax_error.value)


# --- shift-and-add --------------------------------------------------------------


@pytest.mark.parametrize("case", ["integer_complete", "fractional", "holes", "colour", "collisions", "no_inpaint"])
def test_shift_add_fusion_equals_jax_exactly(case):
    rng = np.random.default_rng(62)
    shifts = {
        "integer_complete": [(0, 0), (-1, 0), (0, -1), (-1, -1)],
        "fractional": [(0.0, 0.0), (-1.7, 0.4), (0.9, -1.2), (-1.5, -1.99)],
        "holes": [(0, 0), (-1, -1)],
        "colour": [(0, 0), (-1, 0), (0, -1)],
        "collisions": [(0, 0), (2, 0), (0, 0), (-2, -2)],
        "no_inpaint": [(0, 0), (-3, 1)],
    }[case]
    shape = (len(shifts), 3, 7, 9) if case == "colour" else (len(shifts), 7, 9)
    frames = rng.random(shape)
    inpaint = case != "no_inpaint"
    ours = shift_add_fusion(torch.from_numpy(frames), np.asarray(shifts, float), 3, inpaint=inpaint)
    theirs = j_shift_add_fusion(jnp.asarray(frames), np.asarray(shifts, float), 3, inpaint=inpaint)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    as_list = shift_add_fusion([torch.from_numpy(f) for f in frames], shifts, 3, inpaint=inpaint)
    assert torch.equal(as_list, ours)
    with pytest.raises(ValueError, match="number of motion estimates"):
        shift_add_fusion(torch.from_numpy(frames), shifts[:-1], 3)


@pytest.mark.parametrize("num_iterations", [None, 1, 2])
def test_fill_holes_equals_jax_exactly(num_iterations):
    rng = np.random.default_rng(63)
    image = rng.random((2, 15, 17))
    known = rng.random((2, 15, 17)) > 0.85
    known[1] = False
    known[1, 7, 8] = True  # one seed: many sweeps
    ours = fill_holes(torch.from_numpy(image), torch.from_numpy(known), num_iterations)
    theirs = j_fill_holes(jnp.asarray(image), jnp.asarray(known), num_iterations)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


# --- Haar wavelets --------------------------------------------------------------


@pytest.mark.parametrize("shape", [(6, 8), (3, 10, 4), (2, 2, 4, 6)])
def test_haar_forward_and_inverse_equal_jax(shape):
    x = np.random.default_rng(64).normal(size=shape)
    ours, theirs = wavelet_transform(torch.from_numpy(x)), j_transform(jnp.asarray(x))
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.stitched().numpy(), np.asarray(theirs.stitched()), rtol=0, atol=1e-12)
    back = inverse_wavelet_transform(ours)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-12)
    coefficients = [np.random.default_rng(65).normal(size=ours.ll.shape) for _ in range(4)]
    np.testing.assert_allclose(
        inverse_wavelet_transform(WaveletCoefficients(*[torch.from_numpy(c) for c in coefficients])).numpy(),
        np.asarray(j_inverse(JCoefficients(*[jnp.asarray(c) for c in coefficients]))), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="even"):
        wavelet_transform(torch.zeros(5, 4))
