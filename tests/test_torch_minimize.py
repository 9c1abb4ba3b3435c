"""``minimize`` with ``cg`` (every initial-step mode) and ``lbfgs``: the
port's step functions against the JAX package's ``lax.while_loop``.

Same numpy inputs, float64 on the CPU. On the MAP problem both sides make
the same line-search decisions: equal iterations and evaluations, ``x``
within ``1e-10``. On the standalone problems (a quadratic, Rosenbrock) both
must reach the minimum, as ``tests/test_least_squares.py`` asks of the JAX
package: near the minimum the costs differ in their last bits between the
two packages, and an Armijo test decided on rounding may take another
trial there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.solvers.least_squares import minimize as jminimize

from super_resolution_tpu_torch.solvers import least_squares
from super_resolution_tpu_torch.solvers.least_squares import minimize

from test_torch_least_squares import _map_problem

TOL = 1e-10
MODES = [("cg", "scaled"), ("cg", "quadratic"), ("cg", "quadratic_min"), ("lbfgs", "scaled")]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _quadratic_problem(n=16, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    h = a @ a.T + n * np.eye(n)  # well-conditioned SPD
    b = rng.normal(size=n)
    ht, bt = torch.from_numpy(h), torch.from_numpy(b)

    def vg(x):
        return 0.5 * x @ ht @ x - bt @ x, ht @ x - bt

    jh, jb = jnp.asarray(h), jnp.asarray(b)
    return vg, jax.value_and_grad(lambda x: 0.5 * x @ jh @ x - jb @ x), np.linalg.solve(h, b)


def _assert_same(res, jres, tol=TOL):
    assert (res.iterations, res.num_evaluations) == (int(jres.iterations), int(jres.num_evaluations))
    assert res.converged == bool(jres.converged)
    assert np.abs(res.x.numpy() - np.asarray(jres.x)).max() < tol
    assert abs(float(res.cost) - float(jres.cost)) <= tol * max(1.0, abs(float(jres.cost)))


@pytest.mark.parametrize("method,mode", MODES)
@pytest.mark.parametrize("reg", [None, "tv", "btv"])
def test_minimize_matches_jax_on_the_map_problem(reg, method, mode):
    ours, theirs, x0 = _map_problem(reg)
    kw = dict(method=method, max_iterations=25, initial_step_mode=mode)
    _assert_same(minimize(ours, torch.from_numpy(x0), **kw), jminimize(theirs, jnp.asarray(x0), **kw))


@pytest.mark.parametrize("memory", [1, 2])
def test_lbfgs_memory_ring_wraps_as_in_jax(memory):
    """A memory shorter than the solve: the ring is overwritten slot by slot
    and the two-loop recursion walks it newest first, as JAX's does."""
    ours, theirs, x0 = _map_problem("tv")
    kw = dict(method="lbfgs", max_iterations=15, memory=memory, gradient_norm_threshold=0.0,
              cost_decrease_threshold=0.0, parameter_variation_threshold=0.0)
    res = minimize(ours, torch.from_numpy(x0), **kw)
    _assert_same(res, jminimize(theirs, jnp.asarray(x0), **kw))
    assert res.iterations == 15


@pytest.mark.parametrize("method,mode", MODES)
def test_converges_to_quadratic_minimum(method, mode):
    vg, jvg, x_star = _quadratic_problem()
    kw = dict(method=method, max_iterations=200, gradient_norm_threshold=1e-8, cost_decrease_threshold=0.0,
              parameter_variation_threshold=0.0, initial_step_mode=mode)
    res = minimize(vg, torch.zeros(16, dtype=torch.float64), **kw)
    jres = jminimize(jvg, jnp.zeros(16), **kw)
    for x, converged in ((res.x.numpy(), res.converged), (np.asarray(jres.x), bool(jres.converged))):
        np.testing.assert_allclose(x, x_star, atol=1e-5)
        assert converged
    assert res.num_evaluations >= res.iterations + 1


def test_rosenbrock_nonquadratic():
    def rosenbrock(z):
        return (1.0 - z[0]) ** 2 + 100.0 * (z[1] - z[0] * z[0]) ** 2

    def vg(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            f = rosenbrock(z)
            (g,) = torch.autograd.grad(f, z)
        return f.detach(), g

    res = minimize(vg, torch.tensor([-1.2, 1.0], dtype=torch.float64), method="lbfgs", max_iterations=500)
    jres = jminimize(jax.value_and_grad(rosenbrock), jnp.asarray([-1.2, 1.0]), method="lbfgs",
                     max_iterations=500)
    np.testing.assert_allclose(res.x.numpy(), [1.0, 1.0], atol=1e-4)
    np.testing.assert_allclose(np.asarray(jres.x), [1.0, 1.0], atol=1e-4)


@pytest.mark.parametrize("method", ["cg", "lbfgs"])
def test_stopping_rules(method):
    vg, _, _ = _quadratic_problem()
    x0 = torch.zeros(16, dtype=torch.float64)
    # The iteration cap holds exactly when the thresholds are 0.
    capped = minimize(vg, x0, method=method, max_iterations=3, gradient_norm_threshold=0.0,
                      cost_decrease_threshold=0.0, parameter_variation_threshold=0.0)
    assert capped.iterations == 3 and not capped.converged
    # A loose gradient threshold stops early.
    loose = minimize(vg, x0, method=method, max_iterations=200, gradient_norm_threshold=1e-2)
    assert loose.converged and loose.iterations < 200


def test_invalid_options_raise():
    vg, _, _ = _quadratic_problem()
    x0 = torch.zeros(16, dtype=torch.float64)
    with pytest.raises(ValueError, match="initial_step_mode"):
        minimize(vg, x0, initial_step_mode="quadradic")  # a typo must not pass
    with pytest.raises(ValueError, match="CG only"):
        minimize(vg, x0, method="lbfgs", initial_step_mode="quadratic")
    with pytest.raises(ValueError, match="method"):
        minimize(vg, x0, method="newton")
    with pytest.raises(ValueError, match="memory"):
        minimize(vg, x0, method="lbfgs", memory=0)


@pytest.mark.parametrize("method", ["cg", "lbfgs"])
def test_frozen_wolfe_steps_leave_the_state_alone(method):
    """A step taken once the solve is done spends its evaluation and returns
    the state it was given: iterate, search, counts and the L-BFGS memory."""
    ours, _, x0 = _map_problem("tv")
    settings = least_squares.solver_settings(method, 4, 0.0, 0.0, 0.0)
    state = least_squares.wolfe_start(ours, torch.from_numpy(x0), settings)
    while not bool(least_squares.wolfe_done(state, settings)):
        state = least_squares.wolfe_step(ours, state, settings)
    assert int(state.k) == 4
    before = [None if v is None else v.clone() for v in state]
    frozen = least_squares.wolfe_step(ours, state, settings)
    for name, was, now in zip(least_squares.WolfeState._fields, before, frozen):
        if was is None:
            assert now is None
        elif name in ("s_memory", "y_memory", "rho"):
            assert torch.equal(was[:-1], now[:-1]), name  # the last slot takes discarded writes
        else:
            assert torch.equal(was, now), name


@pytest.mark.parametrize("method", ["cg", "lbfgs"])
def test_masked_steps_equal_the_host_loop_bit_for_bit(method):
    """The fused solve's masked steps and the host loop's unmasked ones make
    the same values while the solve runs."""
    ours, _, x0 = _map_problem("btv")
    settings = least_squares.solver_settings(method, 6, 0.0, 0.0, 0.0)
    masked = least_squares.wolfe_start(ours, torch.from_numpy(x0), settings)
    plain = least_squares.wolfe_start(ours, torch.from_numpy(x0), settings)
    while not bool(least_squares.wolfe_done(plain, settings)):
        plain = least_squares.wolfe_step(ours, plain, settings, masked=False)
        masked = least_squares.wolfe_step(ours, masked, settings)
        for name, a, b in zip(least_squares.WolfeState._fields, plain, masked):
            assert a is None or torch.equal(a, b), name


def test_log_iterations_prints_each_iteration(capsys):
    ours, _, x0 = _map_problem(None)
    res = minimize(ours, torch.from_numpy(x0), method="lbfgs", max_iterations=3, log_iterations=True)
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("Iteration complete")]
    assert len(lines) == res.iterations == 3
    assert lines[-1].endswith(f"= {float(res.cost)}")
