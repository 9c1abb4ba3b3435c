"""The gradient modes (``diff_mode="autodiff"`` / ``"numerical"``,
``finite_difference_grad``) and L-BFGS through ``IRLSMapSolver``, against
the JAX package on the same numpy inputs, float64 on the CPU.

Mirrors ``tests/test_map_solver.py``: the tiny hand-solvable problem under
``lbfgs``, ``autodiff`` and ``numerical`` (port and JAX within ``1e-8`` of
each other and both within ``SOLVER_TOL`` of the truth), and the gradient
cross-checks (analytic against autodiff exactly up to rounding, against
central differences within ``1e-4``). The numerical mode's central
differences divide rounding of the cost by ``2e-6``, so the two packages'
numerical gradients agree to ``1e-7``, not to rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.models import ImageModel as JImageModel
from super_resolution_tpu.models import ImageModelParameters as JParameters
from super_resolution_tpu.motion import MotionShiftSequence as JSequence
from super_resolution_tpu.ops.tv import TotalVariationRegularizer as JTV
from super_resolution_tpu.solvers import IRLSMapSolver as JSolver
from super_resolution_tpu.solvers import IRLSMapSolverOptions as JOptions
from super_resolution_tpu.solvers.objective import data_term_cost as jdata_term_cost
from super_resolution_tpu.solvers.objective import finite_difference_grad as jfinite_difference_grad
from super_resolution_tpu.solvers.objective import make_map_value_and_grad as jmake

from super_resolution_tpu_torch import IRLSMapSolver, IRLSMapSolverOptions, ImageModel, ImageModelParameters
from super_resolution_tpu_torch import make_mesh
from super_resolution_tpu_torch.motion import MotionShiftSequence
from super_resolution_tpu_torch.ops.blur import gaussian_kernel_2d
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
from super_resolution_tpu_torch.solvers import irls as irls_mod
from super_resolution_tpu_torch.solvers.objective import (
    data_term_cost,
    data_term_cost_and_grad,
    finite_difference_grad,
    make_map_value_and_grad,
)

SOLVER_TOL = 0.001   # the reference's kSolverResultErrorTolerance
TOL = 1e-8           # port against JAX, whole solves
SMALL_SHIFTS = [(0, 0), (-1, 0), (0, -1), (-1, -1)]
TV_SHIFTS = [(0, 0), (1, 1), (0.5, -0.25), (1, 0)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _small_data_problem():
    """``test_map_solver.py``'s SmallDataTest: four constant 2x2 frames, exact recovery."""
    lows = [np.full((2, 2), v) for v in (0.4, 0.2, 0.0, 1.0)]
    truth = np.array([[0.4, 0.2, 0.4, 0.2], [0.0, 1.0, 0.0, 1.0]] * 2)
    return lows, truth


def _solve_both(lows, shifts, x0, regs=(), jregs=(), params=None, **fields):
    params = dict(scale=2, **(params or {}))
    model = ImageModel.create(ImageModelParameters(motion_sequence=MotionShiftSequence(shifts), **params))
    solver = IRLSMapSolver(IRLSMapSolverOptions(**fields), model, lows, device="cpu", dtype=torch.float64)
    for reg, lam in regs:
        solver.add_regularizer(reg, lam)
    jmodel = JImageModel.create(JParameters(motion_sequence=JSequence(shifts), **params))
    jsolver = JSolver(JOptions(**fields), jmodel, [jnp.asarray(f) for f in lows])
    for reg, lam in jregs:
        jsolver.add_regularizer(reg, lam)
    return solver, solver.solve(x0).numpy(), jsolver, np.asarray(jsolver.solve(jnp.asarray(x0)))


@pytest.mark.parametrize("fields", [
    dict(least_squares_solver="lbfgs"),
    dict(diff_mode="autodiff"),
    dict(diff_mode="numerical"),
    dict(least_squares_solver="lbfgs", diff_mode="autodiff"),
])
def test_small_data_solves_match_jax(fields):
    lows, truth = _small_data_problem()
    solver, x, jsolver, jx = _solve_both(lows, SMALL_SHIFTS, np.zeros((1, 4, 4)), **fields)
    assert np.abs(x[0] - truth).max() <= SOLVER_TOL
    assert np.abs(x - jx).max() < TOL
    assert solver.last_inner_iterations == jsolver.last_inner_iterations
    assert [c[1:] for c in solver.last_inner_calls] == [c[1:] for c in jsolver.last_inner_calls]


def _tv_problem(hw=(8, 8)):
    rng = np.random.default_rng(31)
    gt = 0.2 + 0.6 * rng.random((1,) + hw)
    model = ImageModel.create(ImageModelParameters(
        scale=2, blur_radius=3, blur_sigma=1.0, motion_sequence=MotionShiftSequence(TV_SHIFTS)))
    return gt, [model.apply(torch.from_numpy(gt), k).numpy() for k in range(len(TV_SHIFTS))]


@pytest.mark.parametrize("mode", ["autodiff", "numerical"])
@pytest.mark.parametrize("method", ["cg", "lbfgs"])
def test_tv_solves_in_the_gradient_modes_match_jax(mode, method):
    """Regularised, blurred, fractional shifts: the modes' cost is the plain
    degradation plus ``sum lambda w r^2``, through the host IRLS loop."""
    gt, lows = _tv_problem()
    fields = dict(diff_mode=mode, least_squares_solver=method, max_num_irls_iterations=2,
                  max_num_solver_iterations=8)
    solver, x, jsolver, jx = _solve_both(
        lows, TV_SHIFTS, np.repeat(np.repeat(lows[0], 2, axis=-2), 2, axis=-1),
        [(TotalVariationRegularizer(), 0.01)], [(JTV(), 0.01)], dict(blur_radius=3, blur_sigma=1.0), **fields)
    assert np.abs(x - jx).max() < TOL
    assert [c[1:] for c in solver.last_inner_calls] == [c[1:] for c in jsolver.last_inner_calls]


def _gradient_problem(seed, c, hw, k):
    rng = np.random.default_rng(seed)
    return rng.random((c,) + hw), rng.random((k, c, hw[0] // 2, hw[1] // 2))


def test_data_term_gradient_vs_autodiff():
    """The analytic gradient is the true gradient for integer shifts; the
    port's autograd of the cost equals JAX's ``jax.grad`` of its own."""
    x, obs = _gradient_problem(11, 2, (8, 8), 3)
    shifts = np.array([[0.0, 0.0], [1.0, 0.0], [-1.0, 2.0]])
    kernel = gaussian_kernel_2d(3, 1.0)
    xt, ot = torch.from_numpy(x), torch.from_numpy(obs)
    cost, grad = data_term_cost_and_grad(xt, ot, shifts, kernel, 2)
    z = xt.clone().requires_grad_(True)
    auto_cost = data_term_cost(z, ot, shifts, kernel, 2)
    (auto_grad,) = torch.autograd.grad(auto_cost, z)
    assert abs(float(cost) - float(auto_cost.detach())) < 1e-10
    assert float((grad - auto_grad).abs().max()) < 1e-9
    jcost, jgrad = jax.value_and_grad(lambda v: jdata_term_cost(
        v, jnp.asarray(obs), jnp.asarray(shifts), jnp.asarray(kernel), 2, max_shift=4))(jnp.asarray(x))
    assert abs(float(auto_cost.detach()) - float(jcost)) <= 1e-12 * float(jcost)
    assert np.abs(auto_grad.numpy() - np.asarray(jgrad)).max() < 1e-12


def test_data_term_gradient_vs_finite_differences():
    x, obs = _gradient_problem(12, 1, (6, 6), 2)
    shifts = np.array([[0.0, 0.0], [1.0, 1.0]])
    xt, ot = torch.from_numpy(x), torch.from_numpy(obs)
    _, grad = data_term_cost_and_grad(xt, ot, shifts, None, 2)
    fd = finite_difference_grad(lambda z: data_term_cost(z, ot, shifts, None, 2), xt, 1e-6)
    assert float((grad - fd).abs().max()) < 1e-4
    jfd = jfinite_difference_grad(
        lambda z: jdata_term_cost(z, jnp.asarray(obs), jnp.asarray(shifts), None, 2, max_shift=3), jnp.asarray(x),
        1e-6)
    assert np.abs(fd.numpy() - np.asarray(jfd)).max() < 1e-7


def test_full_objective_gradient_with_regularizer_vs_finite_differences():
    x, obs = _gradient_problem(13, 1, (6, 6), 2)
    shifts = np.array([[0.0, 0.0], [1.0, 1.0]])
    weights = (torch.from_numpy(np.random.default_rng(14).random((1, 6, 6)) + 0.5),)
    vg = make_map_value_and_grad(obs, shifts, None, 2, [(TotalVariationRegularizer(), 0.1)], device="cpu",
                                 dtype=torch.float64)
    xt = torch.from_numpy(x)
    _, grad = vg(xt, weights)
    fd = finite_difference_grad(lambda z: vg(z, weights)[0], xt, 1e-6)
    assert float((grad - fd).abs().max()) < 1e-4


@pytest.mark.parametrize("mode,grad_tol", [("autodiff", 1e-12), ("numerical", 1e-7)])
def test_value_and_grad_in_each_mode_matches_jax(mode, grad_tol):
    """``make_map_value_and_grad(diff_mode=...)`` on both sides: the same
    cost, and gradients that agree to rounding (autodiff) or to the central
    differences' rounding (numerical); each call and ``prepare`` agree."""
    x, obs = _gradient_problem(15, 1, (8, 8), 4)
    kernel = gaussian_kernel_2d(3, 1.0)
    weights = np.random.default_rng(16).random((1, 8, 8)) + 0.5
    vg = make_map_value_and_grad(obs, TV_SHIFTS, kernel, 2, [(TotalVariationRegularizer(), 0.05)],
                                 diff_mode=mode, device="cpu", dtype=torch.float64)
    jvg = jmake(jnp.asarray(obs), jnp.asarray(TV_SHIFTS, dtype=jnp.float64), jnp.asarray(kernel), 2,
                [(JTV(), 0.05)], max_shift=3, diff_mode=mode)
    cost, grad = vg(torch.from_numpy(x), (torch.from_numpy(weights),))
    jcost, jgrad = jvg(jnp.asarray(x), (jnp.asarray(weights),))
    assert abs(float(cost) - float(jcost)) <= 1e-12 * float(jcost)
    assert np.abs(grad.numpy() - np.asarray(jgrad)).max() < grad_tol
    bound = vg.prepare((torch.from_numpy(weights),))
    cost2, grad2 = bound(torch.from_numpy(x))
    assert float(cost2) == float(cost) and torch.equal(grad2, grad)


@pytest.mark.parametrize("mode", ["autodiff", "numerical"])
def test_fused_solve_in_the_gradient_modes_equals_the_host_loop_on_the_cpu(mode):
    """On the CPU the fused solve runs the gradient modes through the same
    steps as the host loop. On a CUDA device it takes ``autodiff`` (its
    evaluation reads the shifts on the device, nothing on the host) and
    refuses ``numerical`` (2n evaluations a gradient: no graph of a sane size)."""
    gt, lows = _tv_problem()
    model = ImageModel.create(ImageModelParameters(
        scale=2, blur_radius=3, blur_sigma=1.0, motion_sequence=MotionShiftSequence(TV_SHIFTS)))
    out = []
    for fused in (False, True):
        solver = IRLSMapSolver(IRLSMapSolverOptions(diff_mode=mode, fused_irls=fused, max_num_irls_iterations=2,
                                                    max_num_solver_iterations=6), model, lows, device="cpu",
                               dtype=torch.float64)
        solver.add_regularizer(TotalVariationRegularizer(), 0.01)
        out.append((solver, solver.solve(np.zeros_like(gt))))
    (host, x_host), (fused, x_fused) = out
    assert torch.equal(x_host, x_fused)
    assert [c[1:] for c in host.last_inner_calls] == [c[1:] for c in fused.last_inner_calls]
    fusable = IRLSMapSolverOptions(diff_mode=mode, fused_irls=True)
    if mode == "numerical":
        with pytest.raises(ValueError, match="diff_mode='numerical'"):
            irls_mod._check_fusable(fusable, device="cuda")
    else:
        irls_mod._check_fusable(fusable, device="cuda")
    irls_mod._check_fusable(fusable, device="cpu")
    irls_mod._check_fusable(IRLSMapSolverOptions(fused_irls=True), device="cuda")


def test_a_mesh_refuses_the_gradient_modes():
    gt, lows = _tv_problem()
    model = ImageModel.create(ImageModelParameters(scale=2, motion_sequence=MotionShiftSequence(TV_SHIFTS)))
    solver = IRLSMapSolver(IRLSMapSolverOptions(diff_mode="autodiff"), model, lows, device="cpu",
                           dtype=torch.float64, mesh=make_mesh({"frame": 2}, devices=["cpu"]))
    solver.add_regularizer(TotalVariationRegularizer(), 0.01)
    with pytest.raises(ValueError, match="diff_mode 'autodiff'"):
        solver.solve(np.zeros_like(gt))
