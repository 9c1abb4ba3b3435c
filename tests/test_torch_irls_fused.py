"""The fused IRLS solve of the port (``irls_solve_fused``,
``IRLSMapSolver(fused_irls=True)``) on the CPU, float64, torch on one thread.

On a CUDA device the fused solve replays its steps as CUDA graphs; on the CPU
the same step functions run eagerly with the same chunked read-backs, so
these tests hold the algorithm the card replays. Three references:

- the JAX package's ``irls_solve_fused`` (its traced objective,
  ``least_squares_solver="linear_cg"``), within ``1e-6`` (the ``TOL`` of
  ``test_torch_irls.py``: same algorithm, sums in another order) with equal
  total inner iterations; with motion refinement, shifts and ``x`` within
  ``1e-6`` (the ``TOL`` of ``test_torch_estimated_motion.py``);
- the port's own host loop, which runs the same steps one read-back at a
  time: within ``1e-12`` (the same ops in the same order: equal in practice)
  with equal iterations and evaluations in every round;
- a fresh build, for a solve that reuses a cached one.

Each JAX configuration is compiled once per module.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.models import ImageModel as JImageModel
from super_resolution_tpu.models import ImageModelParameters as JParameters
from super_resolution_tpu.motion import MotionShiftSequence as JSequence
from super_resolution_tpu.ops.btv import BilateralTotalVariationRegularizer as JBTV
from super_resolution_tpu.ops.tv import TotalVariationRegularizer as JTV
from super_resolution_tpu.solvers import IRLSMapSolver as JSolver
from super_resolution_tpu.solvers import IRLSMapSolverOptions as JOptions
from super_resolution_tpu.solvers.irls import irls_solve_fused as jfused
from super_resolution_tpu.solvers.objective import make_map_value_and_grad as jmake

from super_resolution_tpu_torch import IRLSMapSolver, IRLSMapSolverOptions, ImageModel, ImageModelParameters
from super_resolution_tpu_torch import convert, make_mesh
from super_resolution_tpu_torch.parallel import Mesh
from super_resolution_tpu_torch.motion import MotionShiftSequence
from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
from super_resolution_tpu_torch.solvers import irls as irls_mod
from super_resolution_tpu_torch.solvers import least_squares
from super_resolution_tpu_torch.solvers.irls import irls_solve_fused
from super_resolution_tpu_torch.solvers.objective import make_map_value_and_grad

SHIFTS = [(0, 0), (1, 1), (0.5, -0.25), (1, 0)]
TRUE6 = [(0, 0), (1.25, 0.5), (-0.75, 1.5), (0.5, -1.25), (0.3, 0.9), (-1.1, -0.4)]
PARAMS = dict(scale=2, blur_radius=3, blur_sigma=1.0)
TOL = 1e-6          # against JAX
HOST_TOL = 1e-12    # against the port's host loop


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(c, hw, seed=70):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: hw[0], : hw[1]]
    base = 0.5 + 0.3 * np.sin(xx / 3.0) * np.cos(yy / 4.0)
    img = np.stack([base * (1.0 - 0.2 * i) + 0.05 * rng.random(hw) for i in range(c)])
    img[:, hw[0] // 3: hw[0] // 2, hw[1] // 4: hw[1] // 2] += 0.3
    return np.clip(img, 0.0, 1.0)


def _textured(c, hw, seed=5, cutoff=0.15):
    """Band-limited random texture, as ``test_torch_estimated_motion.py``: the
    data term then pins subpixel motion."""
    rng = np.random.default_rng(seed)
    fy, fx = np.fft.fftfreq(hw[0])[:, None], np.fft.fftfreq(hw[1])[None, :]
    lowpass = np.exp(-(fy**2 + fx**2) / (2 * cutoff**2))
    img = np.real(np.fft.ifft2(np.fft.fft2(rng.standard_normal((c, *hw))) * lowpass))
    return (img - img.min()) / (img.max() - img.min())


def _lows(c, hw, shifts=SHIFTS, scene=_scene):
    model = ImageModel.create(ImageModelParameters(motion_sequence=MotionShiftSequence(shifts), **PARAMS))
    gt = scene(c, hw)
    return model, gt, [model.apply(torch.from_numpy(gt), k).numpy() for k in range(len(shifts))]


REGULARIZERS = {
    "tv": lambda: [(TotalVariationRegularizer(), 0.01)],
    "btv": lambda: [(BilateralTotalVariationRegularizer(2, 0.5), 0.01)],
    "tv3d": lambda: [(TotalVariationRegularizer(True), 0.01)],
    "tv+btv": lambda: [(TotalVariationRegularizer(), 0.01), (BilateralTotalVariationRegularizer(2, 0.5), 0.005)],
    None: lambda: [],
}


def _port_solve(model, lows, regs, x0, start_shifts=None, **fields):
    if start_shifts is not None:
        model = ImageModel.create(ImageModelParameters(
            motion_sequence=MotionShiftSequence([tuple(s) for s in start_shifts]), **PARAMS))
    fields.setdefault("least_squares_solver", "linear_cg")
    solver = IRLSMapSolver(IRLSMapSolverOptions(**fields), model, lows, device="cpu", dtype=torch.float64)
    for reg, lam in regs:
        solver.add_regularizer(reg, lam)
    return solver, solver.solve(x0)


def _host_and_fused(model, lows, regs, x0, **fields):
    host = _port_solve(model, lows, regs, x0, **fields)
    fused = _port_solve(model, lows, regs, x0, fused_irls=True, **fields)
    return host, fused


def _assert_same_solve(host, fused):
    (h, hx), (f, fx) = host, fused
    assert fx.shape == hx.shape and fx.dtype == hx.dtype
    assert float((fx - hx).abs().max()) <= HOST_TOL
    assert torch.abs(f.shifts - h.shifts).max() <= HOST_TOL
    assert f.last_inner_iterations == h.last_inner_iterations
    assert [c[1:] for c in f.last_inner_calls] == [c[1:] for c in h.last_inner_calls]


# --------------------------------------------------------------------- JAX


@functools.lru_cache(maxsize=None)
def _jax_fused(reg, threshold):
    """The JAX package's irls_solve_fused (jitted once) on the 16x16 problem."""
    model, gt, lows = _lows(1, (16, 16))
    jmodel = JImageModel.create(JParameters(motion_sequence=JSequence(SHIFTS), **PARAMS))
    jregs = {"tv": [(JTV(), 0.02)], None: []}[reg]
    options = JOptions(least_squares_solver="linear_cg", max_num_irls_iterations=10, max_num_solver_iterations=12,
                       irls_cost_difference_threshold=threshold)
    options.adjust_thresholds_adaptively(gt.size, sum(lam for _, lam in jregs))
    jvg = jmake(jnp.asarray(np.stack(lows)), jnp.asarray(SHIFTS, dtype=jnp.float64),
                jnp.asarray(jmodel.blur_operator.kernel), 2, jregs, max_shift=3)
    x0 = np.zeros_like(gt)
    x, cost, iterations = jax.jit(
        lambda x: jfused(lambda w: (lambda z: jvg(z, w)), jregs, x, options, return_iterations=True))(
        jnp.asarray(x0))
    return np.asarray(x), float(cost), int(iterations)


@pytest.mark.parametrize("reg", ["tv", None])
def test_irls_solve_fused_matches_jax_and_stops_on_cost_difference(reg):
    """With TV the loose IRLS threshold ends the loop before its cap of 10
    rounds, on both sides; without a regulariser it is one inner solve."""
    threshold = 0.3
    jx, jcost, jiterations = _jax_fused(reg, threshold)
    model, gt, lows = _lows(1, (16, 16))
    regs = [(TotalVariationRegularizer(), 0.02)] if reg == "tv" else []
    options = IRLSMapSolverOptions(least_squares_solver="linear_cg", max_num_irls_iterations=10,
                                   max_num_solver_iterations=12, irls_cost_difference_threshold=threshold)
    options.adjust_thresholds_adaptively(gt.size, sum(lam for _, lam in regs))
    vg = make_map_value_and_grad(np.stack(lows), SHIFTS, model.blur_operator.kernel, 2, regs,
                                 device="cpu", dtype=torch.float64)
    x, cost, iterations = irls_solve_fused(vg, regs, torch.zeros(gt.shape, dtype=torch.float64), options,
                                           return_iterations=True)
    assert np.abs(x.numpy() - jx).max() < TOL
    assert abs(float(cost) - jcost) <= TOL * max(1.0, abs(jcost))
    assert iterations == jiterations
    if reg == "tv":
        # The same stop, and the host loop's rounds, iterations and estimate.
        host, _ = _port_solve(model, lows, regs, np.zeros_like(gt), max_num_irls_iterations=10,
                              max_num_solver_iterations=12, irls_cost_difference_threshold=threshold)
        assert 1 < len(host.last_inner_calls) < 10
        assert host.last_inner_iterations == iterations


@functools.lru_cache(maxsize=None)
def _refinement_problem():
    """tests/test_refinement.py's geometry: 32x32 textured scene, 6 frames at 2x, perturbed start."""
    model, gt, lows = _lows(1, (32, 32), TRUE6, _textured)
    rng = np.random.default_rng(21)
    true = np.asarray(TRUE6, dtype=float)
    start = true + np.where(np.arange(len(true))[:, None] == 0, 0.0, rng.uniform(-0.12, 0.12, true.shape))
    return model, gt, lows, start


REFINE_FIELDS = dict(max_num_irls_iterations=4, max_num_solver_iterations=15, irls_cost_difference_threshold=0.0,
                     refine_motion_every=1)


@functools.lru_cache(maxsize=None)
def _jax_refined():
    _, gt, lows, start = _refinement_problem()
    jmodel = JImageModel.create(JParameters(motion_sequence=JSequence([tuple(s) for s in start]), **PARAMS))
    solver = JSolver(JOptions(use_pallas_data_term=False, least_squares_solver="linear_cg", fused_irls=True,
                              **REFINE_FIELDS), jmodel, [jnp.asarray(f) for f in lows])
    solver.add_regularizer(JTV(), 1e-4)
    x = np.asarray(solver.solve(jnp.zeros(gt.shape)))
    return x, np.asarray(solver.shifts), solver.last_inner_iterations


def test_refinement_in_the_fused_loop_matches_jax_and_the_host_loop():
    model, gt, lows, start = _refinement_problem()
    regs = [(TotalVariationRegularizer(), 1e-4)]
    host, fused = (_port_solve(model, lows, regs, np.zeros_like(gt), start_shifts=start, fused_irls=fused,
                               **REFINE_FIELDS) for fused in (False, True))
    _assert_same_solve(host, fused)
    jx, jshifts, jiterations = _jax_refined()
    solver, x = fused
    assert np.abs(solver.shifts.numpy() - jshifts).max() < TOL
    assert np.abs(x.numpy() - jx).max() < TOL
    assert solver.last_inner_iterations == jiterations
    # Refined: closer to the true motion than the start, frame 0 pinned.
    assert np.abs(solver.shifts.numpy() - np.asarray(TRUE6)).max() < np.abs(start - np.asarray(TRUE6)).max()
    assert np.array_equal(solver.shifts.numpy()[0], start[0])


def test_convert_carries_fused_irls_to_a_fused_solver_that_matches_jax():
    model, gt, lows, start = _refinement_problem()
    jx, jshifts, jiterations = _jax_refined()
    options = dataclasses.asdict(JOptions(use_pallas_data_term=False, least_squares_solver="linear_cg",
                                          fused_irls=True, **REFINE_FIELDS))
    assert "fused_irls" not in convert.DROPPED_OPTION_FIELDS
    params = dict(motion_sequence=start, **PARAMS)
    solver = convert.irls_solver(params, options, [("tv", {}, 1e-4)], np.stack(lows), device="cpu",
                                 dtype=torch.float64)
    assert solver.options.fused_irls
    x = solver.solve(np.zeros_like(gt))
    assert len(solver.last_fused_runs) == 1  # it went the fused way
    assert np.abs(x.numpy() - jx).max() < TOL
    assert np.abs(solver.shifts.numpy() - jshifts).max() < TOL
    assert solver.last_inner_iterations == jiterations


# --------------------------------------------------------- the host loop


@pytest.mark.parametrize(
    "reg,c,fields",
    [
        ("tv", 1, dict(max_num_irls_iterations=3, max_num_solver_iterations=20)),
        ("btv", 1, dict(max_num_irls_iterations=2, max_num_solver_iterations=20, linear_cg_refresh_every=5)),
        ("tv3d", 3, dict(max_num_irls_iterations=2, max_num_solver_iterations=12)),
        ("tv+btv", 1, dict(max_num_irls_iterations=2, max_num_solver_iterations=12)),
        (None, 1, dict(max_num_solver_iterations=30)),
        ("tv", 3, dict(split_channels=True, max_num_irls_iterations=2, max_num_solver_iterations=10)),
    ],
)
def test_fused_solver_matches_the_host_loop(reg, c, fields):
    model, gt, lows = _lows(c, (12, 16))
    x0 = np.repeat(np.repeat(lows[0], 2, axis=-2), 2, axis=-1)
    host, fused = _host_and_fused(model, lows, REGULARIZERS[reg](), x0, **fields)
    _assert_same_solve(host, fused)
    runs = fused[0].last_fused_runs
    assert len(runs) == (c if fields.get("split_channels") else 1)
    cap = fields["max_num_solver_iterations"]
    for run in runs:
        # One read-back per chunk and one per IRLS round; an inner solve that
        # runs to its cap ends in a shorter chunk, with no frozen step.
        assert run["readbacks"] == run["chunks"] + len(run["rounds"])
        if all(its == cap for _, its, _ in run["rounds"]):
            assert run["executed_evaluations"] == run["evaluations"]


def test_fused_convergence_mid_chunk():
    """Inner solves that stop on the cost test after a number of iterations
    that is no multiple of the chunk: the chunk's remaining steps are
    frozen, and every round ends where the host loop's does."""
    model, gt, lows = _lows(1, (16, 24))
    fields = dict(max_num_irls_iterations=3, max_num_solver_iterations=200, cost_decrease_threshold=1e-4)
    x0 = np.repeat(np.repeat(lows[0], 2, axis=-2), 2, axis=-1)
    host, fused = _host_and_fused(model, lows, REGULARIZERS["tv"](), x0, **fields)
    _assert_same_solve(host, fused)
    (run,) = fused[0].last_fused_runs
    per_round = [iterations for _, iterations, _ in run["rounds"]]
    chunk = run["chunk_steps"]
    assert chunk == irls_mod.CHUNK_ITERATIONS and any(its % chunk for its in per_round)
    assert all(its < 200 for its in per_round)  # stopped by the cost test, not the cap
    assert run["chunks"] == sum(its // chunk + 1 for its in per_round)
    assert run["executed_evaluations"] == len(per_round) + run["chunks"] * chunk > run["evaluations"]


def test_frozen_linear_cg_steps_leave_the_state_alone():
    model, gt, lows = _lows(1, (12, 16))
    vg = make_map_value_and_grad(np.stack(lows), SHIFTS, model.blur_operator.kernel, 2,
                                 REGULARIZERS["tv"](), device="cpu", dtype=torch.float64)
    bound = vg.prepare((torch.ones(gt.shape, dtype=torch.float64),))
    settings = least_squares.linear_cg_settings(5, 0.0, 0.0, 0.0, 8)
    state = least_squares.linear_cg_start(bound, torch.zeros(gt.shape, dtype=torch.float64), settings)
    for _ in range(5):
        state = least_squares.linear_cg_step(bound, state, settings)
    assert bool(least_squares.linear_cg_done(state, settings)) and int(state.k) == 5
    frozen = least_squares.linear_cg_step(bound, state, settings)
    for before, after in zip(state, frozen):
        assert torch.equal(before, after)


def test_fused_irls_refuses_a_mesh_and_other_inner_solvers():
    """``cg`` and ``lbfgs`` run fused (and equal the host loop), and so does an
    eligible mesh (``tests/test_torch_irls_fused_mesh.py`` holds every kind);
    a mesh no sharded objective runs, one over more than one device and one
    over more than one process are refused."""
    model, gt, lows = _lows(1, (12, 16))
    for solver_name in ("cg", "lbfgs"):
        host, fused = (_port_solve(model, lows, [], np.zeros_like(gt), least_squares_solver=solver_name,
                                   fused_irls=f, max_num_solver_iterations=12) for f in (False, True))
        _assert_same_solve(host, fused)
        assert torch.equal(host[1], fused[1]) and len(fused[0].last_fused_runs) == 1

    def meshed(mesh, regs=(), **fields):
        solver = IRLSMapSolver(IRLSMapSolverOptions(least_squares_solver="linear_cg", **fields), model, lows,
                               device="cpu", dtype=torch.float64, mesh=mesh)
        for reg, lam in regs:
            solver.add_regularizer(reg, lam)
        return solver, solver.solve(np.zeros_like(gt))

    frames = make_mesh({"frame": 2}, devices=["cpu"])
    (host, x_host), (fused, x_fused) = meshed(frames), meshed(frames, fused_irls=True)
    assert torch.equal(x_fused, x_host) and len(fused.last_fused_runs) == 1
    assert [c[1:] for c in fused.last_inner_calls] == [c[1:] for c in host.last_inner_calls]
    with pytest.raises(ValueError, match="fused_irls on this mesh"):
        meshed(frames, REGULARIZERS["tv+btv"](), fused_irls=True)
    with pytest.raises(ValueError, match="more than one device"):
        meshed(Mesh(["frame"], [2], ["cuda:0", "cuda:1"]), fused_irls=True)
    with pytest.raises(ValueError, match="spans processes"):
        meshed(Mesh(["frame"], [2], ["cpu", "cpu"], processes=[0, 1], process_index=0), fused_irls=True)
    # The default options (``cg``) fuse: one inner solve without a regulariser, the host minimize's.
    vg = make_map_value_and_grad(np.stack(lows), SHIFTS, None, 2, device="cpu", dtype=torch.float64)
    x, cost, iterations = irls_solve_fused(vg, [], torch.zeros(gt.shape, dtype=torch.float64),
                                           IRLSMapSolverOptions(), return_iterations=True)
    host = least_squares.minimize(vg.prepare(()), torch.zeros(gt.shape, dtype=torch.float64))
    assert torch.equal(x, host.x) and torch.equal(cost, host.cost) and iterations == host.iterations
    with pytest.raises(ValueError, match="shifts0"):
        irls_solve_fused(vg, [], torch.zeros(gt.shape, dtype=torch.float64),
                         IRLSMapSolverOptions(least_squares_solver="linear_cg"), refiner=lambda x, s: (s, s.max()))


# ------------------------------------------------- cg and lbfgs, fused


@functools.lru_cache(maxsize=None)
def _jax_fused_wolfe(method):
    """``tests/test_irls_fused.py``'s problem (12x12, TV 0.01, the default
    options but the method) through the JAX package's ``irls_solve_fused``."""
    model, gt, lows = _lows(1, (12, 12), SHIFTS_INT)
    jmodel = JImageModel.create(JParameters(motion_sequence=JSequence(SHIFTS_INT), **PARAMS))
    options = JOptions(least_squares_solver=method, max_num_irls_iterations=4, max_num_solver_iterations=15)
    options.adjust_thresholds_adaptively(gt.size, 0.01)
    jvg = jmake(jnp.asarray(np.stack(lows)), jnp.asarray(SHIFTS_INT, dtype=jnp.float64),
                jnp.asarray(jmodel.blur_operator.kernel), 2, [(JTV(), 0.01)], max_shift=3)
    x, cost, iterations = jax.jit(
        lambda x: jfused(lambda w: (lambda z: jvg(z, w)), [(JTV(), 0.01)], x, options, return_iterations=True))(
        jnp.zeros(gt.shape))
    return np.asarray(x), float(cost), int(iterations)


SHIFTS_INT = [(0, 0), (1, 1), (-1, 0), (0, -1)]


@pytest.mark.parametrize("method", ["cg", "lbfgs"])
def test_fused_wolfe_solve_matches_jax_and_the_host_loop(method):
    """The reference's default solver (and L-BFGS) fused: the JAX package's
    fused solve within 1e-10 with equal iterations; the port's host loop bit
    for bit with equal iterations and evaluations in every round."""
    jx, jcost, jiterations = _jax_fused_wolfe(method)
    model, gt, lows = _lows(1, (12, 12), SHIFTS_INT)
    regs = [(TotalVariationRegularizer(), 0.01)]
    options = IRLSMapSolverOptions(least_squares_solver=method, max_num_irls_iterations=4,
                                   max_num_solver_iterations=15)
    options.adjust_thresholds_adaptively(gt.size, 0.01)
    vg = make_map_value_and_grad(np.stack(lows), SHIFTS_INT, model.blur_operator.kernel, 2, regs, device="cpu",
                                 dtype=torch.float64)
    x, cost, iterations = irls_solve_fused(vg, regs, torch.zeros(gt.shape, dtype=torch.float64), options,
                                           return_iterations=True)
    assert np.abs(x.numpy() - jx).max() < 1e-10
    assert abs(float(cost) - jcost) <= 1e-10 * max(1.0, abs(jcost))
    assert iterations == jiterations
    fields = dict(least_squares_solver=method, max_num_irls_iterations=4, max_num_solver_iterations=15)
    host, fused = (_port_solve(model, lows, regs, np.zeros_like(gt), fused_irls=f, **fields) for f in (False, True))
    _assert_same_solve(host, fused)
    assert torch.equal(host[1], fused[1]) and torch.equal(fused[1], x)


@pytest.mark.parametrize("method", ["cg", "lbfgs"])
@pytest.mark.parametrize(
    "reg,c,fields",
    [
        ("tv", 1, dict(max_num_irls_iterations=3, max_num_solver_iterations=20)),
        ("btv", 1, dict(max_num_irls_iterations=2)),
        ("tv3d", 3, dict(max_num_irls_iterations=2, max_num_solver_iterations=12)),
        (None, 1, dict(max_num_solver_iterations=30)),
        ("tv", 3, dict(split_channels=True, max_num_irls_iterations=2, max_num_solver_iterations=10)),
    ],
)
def test_fused_wolfe_solvers_match_the_host_loop(method, reg, c, fields):
    """Chunks of line-search trials: bit-equal to the host loop, one read-back
    per chunk and per round, and frozen steps only after an inner solve is
    done (fewer than a chunk per round)."""
    model, gt, lows = _lows(c, (12, 16))
    x0 = np.repeat(np.repeat(lows[0], 2, axis=-2), 2, axis=-1)
    host, fused = _host_and_fused(model, lows, REGULARIZERS[reg](), x0, least_squares_solver=method, **fields)
    _assert_same_solve(host, fused)
    assert torch.equal(host[1], fused[1])
    for run in fused[0].last_fused_runs:
        assert run["chunk_steps"] == irls_mod.CHUNK_EVALUATIONS
        assert run["readbacks"] == run["chunks"] + len(run["rounds"])
        assert run["executed_evaluations"] == len(run["rounds"]) + run["chunks"] * run["chunk_steps"]
        assert 0 <= run["executed_evaluations"] - run["evaluations"] < len(run["rounds"]) * run["chunk_steps"]


def test_refinement_in_the_fused_cg_loop_matches_the_host_loop():
    model, gt, lows, start = _refinement_problem()
    fields = dict(REFINE_FIELDS, least_squares_solver="cg")
    host, fused = (_port_solve(model, lows, [(TotalVariationRegularizer(), 1e-4)], np.zeros_like(gt),
                               start_shifts=start, fused_irls=f, **fields) for f in (False, True))
    _assert_same_solve(host, fused)
    assert torch.equal(host[0].shifts, fused[0].shifts) and torch.equal(host[1], fused[1])


def test_frozen_steps_of_a_restarted_lbfgs_solve_clear_the_memory():
    """The restart between two IRLS rounds empties the L-BFGS memory, as the
    host loop's fresh inner solve does: the second round's first search
    tries 1 / |g|, and the replays stay bit-equal."""
    model, gt, lows = _lows(1, (12, 16))
    fields = dict(least_squares_solver="lbfgs", max_num_irls_iterations=2, max_num_solver_iterations=6)
    solver, _ = _port_solve(model, lows, REGULARIZERS["tv"](), np.zeros_like(gt), fused_irls=True, **fields)
    fused = solver.last_fused
    fused.restart()
    assert int(fused.state.pairs) == 0 and not bool(fused.state.s_memory.any())
    assert float(fused.state.search[3]) == pytest.approx(1.0 / float(fused.state.g.norm()), rel=1e-12)


# ---------------------------------------------------------------- the cache


def _cached_solver(shifts, **fields):
    model, gt, lows = _lows(1, (16, 16), shifts)
    options = dict(max_num_irls_iterations=2, max_num_solver_iterations=6, **fields)
    solver, x = _port_solve(model, lows, REGULARIZERS["tv"](), np.zeros_like(gt), fused_irls=True, **options)
    return solver, x


def test_the_cache_serves_a_new_instance_with_other_shifts():
    irls_mod._BUILT_SOLVER_CACHE.clear()
    a, xa = _cached_solver([(0, 0), (1, 1), (0, 1), (1, 0)])
    assert len(irls_mod._BUILT_SOLVER_CACHE) == 1
    (built,) = irls_mod._BUILT_SOLVER_CACHE.values()
    other = [(0, 0), (-1, 0), (0.5, -1), (1, -1)]
    b, xb = _cached_solver(other)
    assert len(irls_mod._BUILT_SOLVER_CACHE) == 1 and next(iter(irls_mod._BUILT_SOLVER_CACHE.values())) is built
    assert not torch.allclose(xa, xb)
    irls_mod._BUILT_SOLVER_CACHE.clear()
    fresh, x_fresh = _cached_solver(other)
    assert next(iter(irls_mod._BUILT_SOLVER_CACHE.values())) is not built
    assert torch.equal(xb, x_fresh) and b.last_inner_calls[0][1:] == fresh.last_inner_calls[0][1:]


def test_other_options_get_their_own_entry_and_the_cap_holds(monkeypatch):
    irls_mod._BUILT_SOLVER_CACHE.clear()
    shifts = [(0, 0), (1, 1), (0, 1), (1, 0)]
    _cached_solver(shifts)
    _cached_solver(shifts, linear_cg_refresh_every=3)
    assert len(irls_mod._BUILT_SOLVER_CACHE) == 2
    monkeypatch.setattr(irls_mod, "_BUILT_SOLVER_CACHE_MAX", 2)
    first = next(iter(irls_mod._BUILT_SOLVER_CACHE))
    _cached_solver(shifts, linear_cg_refresh_every=5)
    assert len(irls_mod._BUILT_SOLVER_CACHE) == 2 and first not in irls_mod._BUILT_SOLVER_CACHE
    irls_mod._BUILT_SOLVER_CACHE.clear()


def test_the_inner_solver_is_part_of_the_key():
    irls_mod._BUILT_SOLVER_CACHE.clear()
    shifts = [(0, 0), (1, 1), (0, 1), (1, 0)]
    for fields in (dict(least_squares_solver="lbfgs"), dict(least_squares_solver="lbfgs",
                   num_lbfgs_hessian_corrections=3), dict(least_squares_solver="cg"),
                   dict(least_squares_solver="cg")):
        _cached_solver(shifts, **fields)
    built = list(irls_mod._BUILT_SOLVER_CACHE.values())
    assert [(e.settings.method, e.settings.memory) for e in built] == [("lbfgs", 5), ("lbfgs", 3), ("cg", 0)]
    assert built[1].state.s_memory.shape[0] == 4  # m + 1 slots
    irls_mod._BUILT_SOLVER_CACHE.clear()
