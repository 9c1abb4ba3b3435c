"""``minimize`` of the port against the JAX package's on a small MAP problem.

Same numpy inputs, float64 on the CPU. Both sides must take the same number
of iterations and objective evaluations (their loops make the same decisions)
and end within ``1e-8`` of each other in ``x`` (rounding differs only in the
order of sums inside the objective and the dot products).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.ops.btv import BilateralTotalVariationRegularizer as JBTV
from super_resolution_tpu.ops.tv import TotalVariationRegularizer as JTV
from super_resolution_tpu.solvers.least_squares import minimize as jminimize
from super_resolution_tpu.solvers.objective import make_map_value_and_grad as jmake

from super_resolution_tpu_torch.models.image_model import ImageModel, ImageModelParameters
from super_resolution_tpu_torch.motion import MotionShiftSequence
from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
from super_resolution_tpu_torch.solvers.least_squares import (
    LineSearchConfig,
    minimize,
    wolfe_line_search,
)
from super_resolution_tpu_torch.solvers.objective import make_map_value_and_grad

SHIFTS = [(0, 0), (1, 1), (0.5, -0.25), (1, 0)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(c, hw, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: hw[0], : hw[1]]
    base = 0.5 + 0.3 * np.sin(xx / 3.0) * np.cos(yy / 4.0)
    img = np.stack([base + 0.1 * rng.random(hw) for _ in range(c)])
    img[:, hw[0] // 3 : hw[0] // 2, hw[1] // 4 : hw[1] // 2] += 0.3  # an edge
    return np.clip(img, 0.0, 1.0)


def _map_problem(reg, c=1, hw=(24, 28), scale=2, seed=60):
    gt = _scene(c, hw, seed)
    model = ImageModel.create(ImageModelParameters(
        scale=scale, blur_radius=3, blur_sigma=1.0, motion_sequence=MotionShiftSequence(SHIFTS)))
    obs = np.stack([model.apply(torch.from_numpy(gt), k).numpy() for k in range(len(SHIFTS))])
    shifts = np.asarray(SHIFTS, dtype=np.float64)
    kern = model.blur_operator.kernel
    ours_regs, jax_regs = [], []
    if reg == "tv":
        ours_regs, jax_regs = [(TotalVariationRegularizer(), 0.01)], [(JTV(), 0.01)]
    elif reg == "btv":
        ours_regs = [(BilateralTotalVariationRegularizer(2, 0.5), 0.01)]
        jax_regs = [(JBTV(2, 0.5), 0.01)]
    weights = [np.random.default_rng(seed + 1).random(gt.shape) + 0.5 for _ in ours_regs]
    vg = make_map_value_and_grad(obs, shifts, kern, scale, ours_regs, device="cpu", dtype=torch.float64)
    jvg = jmake(jnp.asarray(obs), jnp.asarray(shifts), jnp.asarray(kern), scale, jax_regs, static_shifts=shifts)
    ours = vg.prepare(tuple(torch.from_numpy(w) for w in weights))
    theirs = jvg.prepare(tuple(jnp.asarray(w) for w in weights))
    x0 = np.repeat(np.repeat(obs[0], scale, axis=-2), scale, axis=-1)
    return ours, theirs, x0


@pytest.mark.parametrize("method", ["linear_cg", "cg"])
@pytest.mark.parametrize("reg", [None, "tv", "btv"])
def test_minimize_matches_jax(method, reg):
    ours, theirs, x0 = _map_problem(reg)
    kw = dict(method=method, max_iterations=25)
    res = minimize(ours, torch.from_numpy(x0), **kw)
    jres = jminimize(theirs, jnp.asarray(x0), **kw)
    assert res.iterations == int(jres.iterations)
    assert res.num_evaluations == int(jres.num_evaluations)
    assert res.converged == bool(jres.converged)
    assert np.abs(res.x.numpy() - np.asarray(jres.x)).max() < 1e-8
    assert abs(float(res.cost) - float(jres.cost)) <= 1e-8 * max(1.0, abs(float(jres.cost)))
    assert abs(float(res.grad_norm) - float(jres.grad_norm)) <= 1e-6 * max(1.0, float(jres.grad_norm))


@pytest.mark.parametrize("method", ["linear_cg", "cg"])
def test_minimize_fixed_iterations_with_thresholds_off(method):
    """Thresholds of 0 (the fixed-iteration mode): the gradient-norm and step
    checks leave the linear-CG loop, and both sides run all iterations."""
    ours, theirs, x0 = _map_problem("tv")
    kw = dict(method=method, max_iterations=12, gradient_norm_threshold=0.0,
              cost_decrease_threshold=0.0, parameter_variation_threshold=0.0,
              linear_cg_refresh_every=4)
    res = minimize(ours, torch.from_numpy(x0), **kw)
    jres = jminimize(theirs, jnp.asarray(x0), **kw)
    assert res.iterations == int(jres.iterations) == 12
    assert res.num_evaluations == int(jres.num_evaluations)
    assert np.abs(res.x.numpy() - np.asarray(jres.x)).max() < 1e-8


def test_linear_cg_refresh_is_unconditional():
    """With refresh_every=1 every iteration takes the trial point, even one
    that raises the cost: exactly one evaluation per iteration, as in JAX."""
    ours, theirs, x0 = _map_problem("tv")
    kw = dict(method="linear_cg", max_iterations=6, linear_cg_refresh_every=1,
              gradient_norm_threshold=0.0, cost_decrease_threshold=0.0,
              parameter_variation_threshold=0.0)
    res = minimize(ours, torch.from_numpy(x0), **kw)
    jres = jminimize(theirs, jnp.asarray(x0), **kw)
    assert res.iterations == int(jres.iterations) and res.num_evaluations == res.iterations + 1
    assert np.abs(res.x.numpy() - np.asarray(jres.x)).max() < 1e-8
    true_cost, _ = ours(res.x)
    assert abs(float(true_cost) - float(res.cost)) <= 1e-12 * float(true_cost)


def test_minimize_on_a_quadratic_and_unported_methods():
    a = torch.tensor([[3.0, 1.0], [1.0, 2.0]], dtype=torch.float64)
    b = torch.tensor([1.0, -1.0], dtype=torch.float64)

    def vg(x):
        return 0.5 * x @ a @ x - b @ x, a @ x - b

    for method in ("cg", "linear_cg", "lbfgs"):
        res = minimize(vg, torch.zeros(2, dtype=torch.float64), method=method, max_iterations=20,
                       gradient_norm_threshold=1e-12, cost_decrease_threshold=0.0,
                       parameter_variation_threshold=0.0)
        assert torch.allclose(res.x, torch.linalg.solve(a, b), atol=1e-9)
        already = minimize(vg, torch.linalg.solve(a, b), method=method, gradient_norm_threshold=1e-6)
        assert already.iterations == 0 and already.converged and already.num_evaluations == 1
    with pytest.raises(ValueError):
        minimize(vg, torch.zeros(2), method="newton")


def test_wolfe_line_search_returns_a_wolfe_point():
    ours, _, x0 = _map_problem("tv")
    x = torch.from_numpy(x0)
    f0, g0 = ours(x)
    d = -g0
    dphi0 = float(torch.dot(g0.reshape(-1), d.reshape(-1)))
    cfg = LineSearchConfig(c2=0.4)
    alpha, f_new, g_new, found, evals = wolfe_line_search(
        ours, x, d, float(f0), g0, dphi0, 1.0 / float(torch.linalg.norm(g0)), cfg)
    assert found and alpha > 0 and 1 <= evals <= cfg.max_bracket + cfg.max_zoom
    assert f_new <= float(f0) + cfg.c1 * alpha * dphi0
    assert abs(float(torch.dot(g_new.reshape(-1), d.reshape(-1)))) <= -cfg.c2 * dphi0
