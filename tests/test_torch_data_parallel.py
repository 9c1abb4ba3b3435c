"""The port's ``parallel/data_parallel.py`` (``shard_problem``,
``make_sharded_map_solver``, ``band_split_minimize``) against the JAX
package's and against the port's single-device ``minimize``.

The problems of ``tests/test_parallel.py`` (16x16, 8 frames at 2x, blur
3 / 1.0), float64, inputs from seeded numpy, torch pinned to one thread.
The port's shards all live on ``cpu``; JAX runs on the conftest's 8
virtual CPU devices. Tolerances:

- port mesh vs port single device: 1e-8, the JAX test's own bound (the
  sums run in another order; read ~1e-13);
- port mesh vs JAX mesh: 1e-8 at 15 iterations (longer Wolfe-CG runs part
  ways in their line-search counts, ROADMAP.md Queue 3);
- band split vs serial port solves: equal bit for bit (the same operations
  per band), with equal iterations and evaluations per band;
- band split vs JAX's vmapped ``solve_band``: 1e-8.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.models import ImageModel as JImageModel
from super_resolution_tpu.models import ImageModelParameters as JParameters
from super_resolution_tpu.motion import MotionShift as JShift
from super_resolution_tpu.motion import MotionShiftSequence as JSequence
from super_resolution_tpu.ops.tv import TotalVariationRegularizer as JTV
from super_resolution_tpu.parallel import make_mesh as jax_make_mesh
from super_resolution_tpu.parallel import make_sharded_map_solver as jax_make_sharded_map_solver
from super_resolution_tpu.parallel import shard_problem as jax_shard_problem
from super_resolution_tpu.solvers import make_map_value_and_grad as jmake
from super_resolution_tpu.solvers import minimize as jminimize

import super_resolution_tpu_torch.parallel as port_parallel
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
from super_resolution_tpu_torch.parallel import (
    Sharded,
    band_split_minimize,
    collectives,
    make_mesh,
    make_sharded_map_solver,
    shard_problem,
)
from super_resolution_tpu_torch.solvers.least_squares import minimize
from super_resolution_tpu_torch.solvers.objective import make_map_value_and_grad

CPU = ["cpu"]
MESH_TOL = 1e-8
JAX_ITERATIONS = 15


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _problem(c=2, seed=31):
    """``tests/test_parallel.py``'s problem, made by the JAX image model (numpy out)."""
    rng = np.random.default_rng(seed)
    hr = jnp.asarray(rng.random((c, 16, 16)))
    seq = JSequence([JShift(0, 0), JShift(-1, 0), JShift(0, -1), JShift(-1, -1)] * 2)
    model = JImageModel.create(JParameters(scale=2, blur_radius=3, blur_sigma=1.0, motion_sequence=seq))
    obs = jnp.stack([model.apply(hr, k) for k in range(8)])
    return np.asarray(hr), np.asarray(obs), np.asarray(seq.as_array()), np.asarray(model.blur_operator.kernel)


def _single_device(obs, shifts, kernel, regs, weights, x0, iterations):
    vg = make_map_value_and_grad(obs, shifts, kernel, 2, regs, device="cpu", dtype=torch.float64)
    return minimize(vg.prepare(weights), x0, max_iterations=iterations)


def _jax_sharded(axes, regs, weights, iterations, c=2):
    hr, obs, shifts, kernel = _problem(c)
    mesh = jax_make_mesh(axes, jax.devices()[:8])
    placed = jax_shard_problem(mesh, jnp.zeros(hr.shape), jnp.asarray(obs), jnp.asarray(shifts))
    solve = jax_make_sharded_map_solver(mesh, jnp.asarray(kernel), 2, regs, max_shift=4, max_iterations=iterations)
    return np.asarray(solve(*placed, weights).x)


@pytest.mark.parametrize("axes,regularized,iterations", [
    ({"frame": 8}, True, 30),
    ({"frame": 4, "band": 2}, False, 20),
], ids=["frame8-tv", "frame4xband2"])
def test_sharded_map_solver_matches_single_device_and_jax(axes, regularized, iterations):
    hr, obs, shifts, kernel = _problem()
    x0 = torch.zeros(hr.shape, dtype=torch.float64)
    regs = [(TotalVariationRegularizer(), 0.001)] if regularized else []
    weights = (torch.ones_like(x0),) if regularized else ()
    mesh = make_mesh(axes, devices=CPU)
    placed = shard_problem(mesh, x0, obs, shifts)
    assert [v.partition for v in placed] == [
        {"band": 0} if "band" in axes else {}, {a: d for a, d in (("frame", 0), ("band", 1)) if a in axes},
        {"frame": 0}]
    solve = make_sharded_map_solver(mesh, kernel, 2, regs, max_shift=4, max_iterations=iterations)

    collectives.reset_counts()
    out = solve(*placed, weights)
    assert isinstance(out.x, Sharded) and out.x.partition == placed[0].partition
    assert collectives.counts["psum"] == out.num_evaluations    # one psum an evaluation
    ref = _single_device(obs, shifts, kernel, regs, weights, x0, iterations)
    assert (out.iterations, out.num_evaluations) == (ref.iterations, ref.num_evaluations)
    assert float((out.x.to_global() - ref.x).abs().max()) <= MESH_TOL
    assert abs(float(out.cost) - float(ref.cost)) <= MESH_TOL

    # A second call of the same shape: the same bits, the objective not built again.
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(port_parallel.data_parallel, "make_sharded_vg",
                      lambda *a, **k: pytest.fail("the objective was built again"))
        again = solve(*placed, weights)
    assert torch.equal(again.x.to_global(), out.x.to_global())

    jregs = [(JTV(), 0.001)] if regularized else []
    jweights = (jnp.ones(hr.shape),) if regularized else ()
    short = solve(*placed, weights) if iterations == JAX_ITERATIONS else make_sharded_map_solver(
        mesh, kernel, 2, regs, max_iterations=JAX_ITERATIONS)(*placed, weights)
    jx = _jax_sharded(axes, jregs, jweights, JAX_ITERATIONS)
    assert np.abs(short.x.to_global().numpy() - jx).max() <= MESH_TOL


def test_sharded_map_solver_takes_global_tensors_and_new_observations():
    """Global inputs are placed; observations of the same shape reach the built objective as they are."""
    hr, obs, shifts, kernel = _problem()
    x0 = torch.zeros(hr.shape, dtype=torch.float64)
    mesh = make_mesh({"frame": 4}, devices=CPU)
    solve = make_sharded_map_solver(mesh, kernel, 2, max_iterations=10)
    from_global = solve(x0, torch.tensor(obs), shifts)
    placed = solve(*shard_problem(mesh, x0, obs, shifts))
    assert torch.equal(from_global.x.to_global(), placed.x.to_global())
    other = obs[::-1].copy()
    ref = _single_device(other, shifts[::-1].copy(), kernel, [], (), x0, 10)
    out = solve(*shard_problem(mesh, x0, other, shifts[::-1].copy()))
    assert float((out.x.to_global() - ref.x).abs().max()) <= MESH_TOL


# ------------------------------------------------------------------- band split


def _serial(obs, shifts, kernel, x0, method, **options):
    functions = [make_map_value_and_grad(obs[:, c: c + 1], shifts, kernel, 2, device="cpu",
                                         dtype=torch.float64).prepare(()) for c in range(x0.shape[0])]
    return functions, [minimize(f, x0[c: c + 1], method=method, **options) for c, f in enumerate(functions)]


@functools.lru_cache(maxsize=None)
def _jax_band_split(iterations):
    """``tests/test_parallel.py``'s vmapped ``solve_band``."""
    hr, obs, shifts, kernel = _problem(c=4)

    def solve_band(xc, obs_c):
        vg = jmake(obs_c, jnp.asarray(shifts), jnp.asarray(kernel), 2, max_shift=4)
        return jminimize(lambda x: vg(x, ()), xc[None], max_iterations=iterations)

    results = jax.vmap(solve_band)(jnp.zeros(hr.shape), jnp.swapaxes(jnp.asarray(obs), 0, 1)[:, :, None])
    return np.asarray(results.x)[:, 0]


@pytest.mark.parametrize("method", ["cg", "lbfgs", "linear_cg"])
def test_band_split_minimize_equals_serial_band_solves(method):
    hr, obs, shifts, kernel = _problem(c=4)
    x0 = torch.zeros(hr.shape, dtype=torch.float64)
    functions, serial = _serial(obs, shifts, kernel, x0, method, max_iterations=25)
    result = band_split_minimize(functions, x0, method=method, max_iterations=25)
    assert result.x.shape == x0.shape and result.cost.shape == (4,)
    for c, one in enumerate(serial):
        assert torch.equal(result.x[c: c + 1], one.x)
        assert torch.equal(result.cost[c], one.cost) and torch.equal(result.grad_norm[c], one.grad_norm)
        assert (result.iterations[c], result.num_evaluations[c], result.converged[c]) == (
            one.iterations, one.num_evaluations, one.converged)
    if method == "cg":
        jx = _jax_band_split(25)
        assert np.abs(result.x.numpy() - jx).max() <= MESH_TOL


def test_band_split_minimize_is_one_batched_solve():
    """One state for all bands: every step evaluates each running band once,
    so the steps (batched evaluations) are the most any band needs, fewer
    than the serial total; the bands stop at their own iteration counts and a
    stopped band is never evaluated again."""
    hr, obs, shifts, kernel = _problem(c=4)
    x0 = torch.zeros(hr.shape, dtype=torch.float64)
    options = dict(max_iterations=200, cost_decrease_threshold=1e-4)   # the bands stop after 50-65 iterations
    functions, serial = _serial(obs, shifts, kernel, x0, "cg", **options)
    calls = []

    def counted(c, f):
        return lambda x: (calls.append(c), f(x))[1]

    result = band_split_minimize([counted(c, f) for c, f in enumerate(functions)], x0, method="cg", **options)
    assert result.iterations == [one.iterations for one in serial]
    assert result.num_evaluations == [one.num_evaluations for one in serial]
    assert len(set(result.iterations)) > 1 and max(result.iterations) < 200     # their own stop tests
    # Batched evaluations: a new one begins wherever the band order does not rise.
    batched = 1 + sum(1 for a, b in zip(calls, calls[1:]) if b <= a)
    assert batched == max(result.num_evaluations) < sum(one.num_evaluations for one in serial)
    assert [calls.count(c) for c in range(4)] == result.num_evaluations
    # The JAX package's form: one function for every band.
    same = band_split_minimize(functions[0], x0, method="cg", **options)
    assert all(torch.equal(same.x[c: c + 1], serial[0].x) for c in range(4))
    with pytest.raises(ValueError, match="3 per-band objectives for 4 bands"):
        band_split_minimize(functions[:3], x0)


# ------------------------------------------------------------------------ meshes


def test_make_mesh_errors_as_the_jax_package():
    """``tests/test_parallel.py``'s construction errors, on 8 devices: a mesh
    that does not fill them evenly raises; an absorbing axis takes the rest."""
    with pytest.raises(ValueError):
        jax_make_mesh({"frame": 3}, jax.devices()[:8])
    with pytest.raises(ValueError, match="cannot be dealt evenly over 8 devices"):
        make_mesh({"frame": 3}, devices=CPU * 8)
    assert jax_make_mesh({"frame": -1, "band": 2}, jax.devices()[:8]).shape["frame"] == 4
    assert make_mesh({"frame": -1, "band": 2}, devices=CPU * 8).shape["frame"] == 4
    assert make_mesh({"frame": 16}, devices=CPU * 8).num_shards == 16    # shards may outnumber devices
