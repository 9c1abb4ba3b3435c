"""``fused_irls`` on a device mesh, on the CPU: float64, torch on one thread.

The four cases of ``tests/test_irls_fused.py``'s ``TestFusedIrlsOnMeshes``
(band x2; frame x4 with fractional shifts, here also refined; row 2 x col 2;
the ineligible two-regulariser mesh that raises), each fused solve held
``torch.equal`` to the same mesh's host loop with the same iterations and
evaluations in every round, as the one-device fused solve is. The band x2
case (2 x 5) is also held against the JAX package's fused mesh solve, run as
its test runs it (``use_pallas_data_term=True, pallas_tile=8``, the Pallas
kernel in interpret mode), to 1e-8. That kernel sums the cost in float32,
and a Wolfe line search or a cost stop test decides on it, so this case
runs ``linear_cg`` with the stop thresholds at 0: its steps follow the
gradient, which both sides compute in float64. Meshes over more than one device or more
than one process raise ``ValueError`` before anything is built.
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
from super_resolution_tpu.solvers import IRLSMapSolver as JSolver
from super_resolution_tpu.solvers import IRLSMapSolverOptions as JOptions

from super_resolution_tpu_torch import IRLSMapSolver, IRLSMapSolverOptions, ImageModel, ImageModelParameters
from super_resolution_tpu_torch.motion import MotionShift, MotionShiftSequence
from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
from super_resolution_tpu_torch.parallel import Mesh, Sharded, band_split_minimize, make_mesh
from super_resolution_tpu_torch.parallel import data_parallel
from super_resolution_tpu_torch.solvers import irls as irls_mod
from super_resolution_tpu_torch.solvers.least_squares import minimize

JAX_TOL = 1e-8
INTEGER = [(0, 0), (1, 1), (-1, 0), (0, -1)]
FRACTIONAL = [(0, 0), (1.5, 0.5), (-0.75, 1.0), (0.5, -1.25)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _problem(channels=2, frames=4, fractional=False, seed=77, shifts=None):
    """``TestFusedIrlsOnMeshes._problem``: a random scene, its LR frames from the port's image model."""
    rng = np.random.default_rng(seed)
    hr = rng.random((channels, 16, 16))
    base = list(shifts) if shifts else (FRACTIONAL if fractional else INTEGER)[:frames]
    model = ImageModel.create(ImageModelParameters(scale=2, blur_radius=3, blur_sigma=1.0,
                                                   motion_sequence=MotionShiftSequence([MotionShift(*s) for s in base])))
    return hr, model, [model.apply(torch.tensor(hr), k).numpy() for k in range(frames)], base


def _solve(model, lows, hr, mesh, regs, **fields):
    options = IRLSMapSolverOptions(**{"max_num_irls_iterations": 2, "max_num_solver_iterations": 5, **fields})
    solver = IRLSMapSolver(options, model, lows, device="cpu", dtype=torch.float64, mesh=mesh)
    for reg, lam in regs:
        solver.add_regularizer(reg, lam)
    return solver, solver.solve(np.zeros_like(hr))


def _host_and_fused(model, lows, hr, mesh, regs, **fields):
    host, x_host = _solve(model, lows, hr, mesh, regs, **fields)
    fused, x_fused = _solve(model, lows, hr, mesh, regs, fused_irls=True, **fields)
    assert torch.equal(x_fused, x_host)
    assert [c[1:] for c in fused.last_inner_calls] == [c[1:] for c in host.last_inner_calls]
    assert fused.last_inner_iterations == host.last_inner_iterations
    assert torch.equal(fused.shifts, host.shifts)
    assert len(fused.last_fused_runs) == 1 and fused.last_fused_runs[0]["readbacks"] <= (
        fused.last_fused_runs[0]["chunks"] + len(fused.last_fused_runs[0]["rounds"]))
    return host, fused, x_host


TV = [(TotalVariationRegularizer(), 0.01)]
CASES = [
    # name, problem, mesh, regularisers, options
    ("band2-tv", dict(channels=2), {"band": 2}, TV, {}),
    ("band2-tv3d", dict(channels=4), {"band": 2}, [(TotalVariationRegularizer(True), 0.01)], {}),
    ("frame4-fractional-refined", dict(channels=1, fractional=True), {"frame": 4}, TV, dict(refine_motion_every=1)),
    ("row2xcol2-tv", dict(channels=1), {"row": 2, "col": 2}, TV, {}),
    ("row2xcol2-btv", dict(channels=1), {"row": 2, "col": 2}, [(BilateralTotalVariationRegularizer(2, 0.5), 0.01)],
     {}),
    ("frame2xband2-tv", dict(channels=2), {"frame": 2, "band": 2}, TV, {}),
]


@pytest.mark.parametrize("method", ["cg", "linear_cg", "lbfgs"])
@pytest.mark.parametrize("name,problem,axes,regs,fields", CASES, ids=[case[0] for case in CASES])
def test_fused_irls_on_a_mesh_equals_the_mesh_host_loop(name, problem, axes, regs, fields, method):
    hr, model, lows, _ = _problem(**problem)
    mesh = make_mesh(axes, devices=["cpu"])
    host, fused, x = _host_and_fused(model, lows, hr, mesh, regs, least_squares_solver=method, **fields)
    if fields.get("refine_motion_every"):
        assert float((fused.shifts - torch.tensor(FRACTIONAL)).abs().max()) > 1e-6   # the refinement ran
    # A second solver of the same shapes replays the built solve: the same bits.
    again, x_again = _solve(model, lows, hr, mesh, regs, least_squares_solver=method, fused_irls=True, **fields)
    assert again.last_fused is fused.last_fused and torch.equal(x_again, x)


def test_fused_tiled_solvers_with_a_wider_reach_build_their_own_halo():
    """The tiled objective sizes its halo from its shifts (q = 6 for a 1 px
    reach, 8 for 3 px, blur 7x7 at 2x): a second solver of the same shapes
    whose shifts reach further must not replay the first one's narrower halo."""
    mesh = make_mesh({"row": 2, "col": 2}, devices=["cpu"])
    near = _problem(channels=1)
    far = _problem(channels=1, shifts=((0, 0), (3, 1), (-2, 3), (1, -3)))
    _, first, x_near = _host_and_fused(*near[1:3], near[0], mesh, TV)
    _, second, x_far = _host_and_fused(*far[1:3], far[0], mesh, TV)
    assert second.last_fused is not first.last_fused and not torch.equal(x_near, x_far)
    # The built objective itself refuses shifts that reach past its halo.
    with pytest.raises(ValueError, match="wider halo"):
        first.last_fused.objective.set_shifts(torch.tensor(far[3], dtype=torch.float64))


JAX_FIELDS = dict(least_squares_solver="linear_cg", gradient_norm_threshold=0.0, cost_decrease_threshold=0.0,
                  parameter_variation_threshold=0.0, irls_cost_difference_threshold=0.0)


@functools.lru_cache(maxsize=None)
def _jax_band_mesh():
    """``TestFusedIrlsOnMeshes.test_band_mesh``'s fused solve (band x2, 2 x 5, TV 0.01)."""
    rng = np.random.default_rng(77)
    hr = jnp.asarray(rng.random((2, 16, 16)))
    seq = JSequence([JShift(dx, dy) for dx, dy in INTEGER])
    model = JImageModel.create(JParameters(scale=2, blur_radius=3, blur_sigma=1.0, motion_sequence=seq))
    obs = [np.asarray(model.apply(hr, k)) for k in range(4)]
    opts = JOptions(max_num_irls_iterations=2, max_num_solver_iterations=5, use_pallas_data_term=True, pallas_tile=8,
                    fused_irls=True, **JAX_FIELDS)
    solver = JSolver(opts, model, obs, mesh=jax_make_mesh({"band": 2}, jax.devices()[:2]))
    solver.add_regularizer(JTV(), 0.01)
    return np.asarray(solver.solve(jnp.zeros_like(hr)))


def test_fused_band_mesh_matches_the_jax_fused_mesh_solve():
    hr, model, lows, _ = _problem(channels=2)
    _, _, x = _host_and_fused(model, lows, hr, make_mesh({"band": 2}, devices=["cpu"]), TV, **JAX_FIELDS)
    assert np.abs(x.numpy() - _jax_band_mesh()).max() <= JAX_TOL


def test_fused_irls_refuses_what_no_sharded_objective_runs():
    """``test_ineligible_mesh_raises``: two regularisers are not kernel-fusable."""
    hr, model, lows, _ = _problem(channels=2)
    regs = TV + [(TotalVariationRegularizer(True), 0.01)]
    with pytest.raises(ValueError, match="fused_irls on this mesh: .*regularizers not kernel-fusable"):
        _solve(model, lows, hr, make_mesh({"band": 2}, devices=["cpu"]), regs, fused_irls=True)


@pytest.mark.parametrize("devices,solver_device,match", [
    (["cuda:0", "cuda:1"], "cpu", "more than one device"),
    (["cuda:0"], "cpu", "more than one device"),
], ids=["two-cards", "shards-off-the-solver-device"])
def test_fused_irls_refuses_a_mesh_over_several_devices(devices, solver_device, match):
    """Device names only: the check comes before anything is placed."""
    hr, model, lows, _ = _problem(channels=1)
    mesh = Mesh(["frame"], [2], [devices[i % len(devices)] for i in range(2)])
    solver = IRLSMapSolver(IRLSMapSolverOptions(fused_irls=True), model, lows, device=solver_device,
                           dtype=torch.float64, mesh=mesh)
    solver.add_regularizer(*TV[0])
    with pytest.raises(ValueError, match=match):
        solver.solve(np.zeros_like(hr))


def test_fused_irls_refuses_a_mesh_over_several_processes(monkeypatch):
    """A mesh whose frame axis spans two processes, seen from process 0 (no group is formed)."""
    hr, model, lows, _ = _problem(channels=1)
    mesh = Mesh(["frame"], [4], ["cpu"] * 4, processes=[0, 0, 1, 1], process_index=0)
    assert mesh.spans_processes and mesh.local_shards == [0, 1]
    with pytest.raises(ValueError, match="spans processes"):
        irls_mod._check_fusable(IRLSMapSolverOptions(fused_irls=True), mesh, "cpu")
    solver = IRLSMapSolver(IRLSMapSolverOptions(fused_irls=True), model, lows, device="cpu", dtype=torch.float64,
                           mesh=mesh)
    with pytest.raises(ValueError, match="spans processes"):
        solver.solve(np.zeros_like(hr))
    # A band axis across the two processes builds (each holds one band shard's two frame shards) ...
    bands = Mesh(["band", "frame"], [2, 2], ["cpu"] * 4, processes=[0, 0, 1, 1])
    assert bands.local_shards == [0, 1] and bands.spans_processes
    # ... and the band split runs on it: each process solves the band that lies in it. Its two
    # all-gathers are played here: each process's view runs up to them, then process 0 assembles.
    targets = torch.tensor(np.random.default_rng(3).random((2, 4, 4)))
    functions = [lambda x, t=t: (((x - t) ** 2).sum() + (x ** 4).sum(), 2 * (x - t) + 4 * x ** 3) for t in targets]
    x0 = torch.zeros(2, 4, 4, dtype=torch.float64)
    sent, calls = {0: [], 1: []}, []

    class Sent(Exception):
        pass

    def view(rank, all_gather):
        monkeypatch.setattr(data_parallel.distributed, "all_gather", all_gather)
        mesh = Mesh(["band", "frame"], [2, 2], ["cpu"] * 4, processes=[0, 0, 1, 1], process_index=rank)
        return band_split_minimize([lambda x, c=c: (calls.append((rank, c)), functions[c](x))[1] for c in range(2)],
                                   Sharded.from_global(mesh, x0, {"band": 0}), method="cg", max_iterations=30)

    def capture(rank):
        def all_gather(t):  # keeps what this process sends; stops it after its second all-gather
            sent[rank].append(t)
            if len(sent[rank]) == 2:
                raise Sent()
            return torch.stack([t, t])
        return all_gather

    for rank in (0, 1):
        with pytest.raises(Sent):
            view(rank, capture(rank))
    assert {c for r, c in calls if r == 0} == {0} and {c for r, c in calls if r == 1} == {1}
    gathered = iter([torch.stack([sent[0][i], sent[1][i]]) for i in range(2)])
    result = view(0, lambda t: next(gathered))
    for c in range(2):
        alone = minimize(functions[c], x0[c:c + 1], method="cg", max_iterations=30)
        assert torch.equal(result.x[c:c + 1], alone.x) and torch.equal(result.cost[c], alone.cost)
        assert (result.iterations[c], result.num_evaluations[c]) == (alone.iterations, alone.num_evaluations)
