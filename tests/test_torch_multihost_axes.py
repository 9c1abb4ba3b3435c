"""``band``, ``row`` and ``col`` mesh axes across processes, on the CPU.

``parallel/multihost.py``'s ``loopback --mesh`` in worker processes joined
over ``gloo`` on a free localhost port, started twice in all:

- 2 processes: (a) ``{"row": 2, "col": 2}`` with TV and with BTV(2, 0.7) on
  1x16x32 at 2x (a row of tiles a process), (b) ``{"band": 4}`` with 3D TV
  on 4x16x16 (the band ring crosses between bands 1 and 2), (e)
  ``{"frame": 2}`` with the motion refined after the first of two IRLS
  rounds, from shifts moved off the true ones by up to 0.3 HR px, and (f)
  ``band_split_minimize`` with ``x0`` on ``{"band": 4}``, two bands a
  process, ``cg`` with each band's own objective (TV 0.01);
- 4 processes: (c) ``{"row": 2, "col": 2}``, a tile a process, so both axes
  cross and a corner takes two hops, (d) ``{"row": 2, "frame": 2}``, whose
  frame groups and row neighbours both cross.

Each run is float64, one IRLS round of 15 ``linear_cg`` iterations (the
stop thresholds at 0), and the same inner solve through
``make_sharded_map_solver``. Every process's estimate is within 1e-6 of the
port's one-process mesh of the same layout (held in the worker) and of the
JAX package's ``IRLSMapSolver(mesh=make_mesh(...))`` on the suite's virtual
CPU devices (held here, on the same numpy inputs), with the same iterations
and evaluations; every process returns the same bits. Before its solve each
worker holds the exchanges with neighbours in other processes
(``halo_gather``, ``halo_scatter_sum``, the spectral-halo pair) equal bit
for bit to the one-process calls, and ``<G x, y> = <x, G^T y>`` to 1e-12.
The exchanges an evaluation are counted: a crossing axis costs one
exchange to gather and one to scatter. The refined run (e) also holds the
refined shifts, equal in every process, within 1e-6 of the one-process mesh
and of the JAX solver's. The band split (f) holds every band bit for bit
against its ``minimize`` alone and the one-process mesh's band split, with
equal iterations and evaluations, every process returning the same bits, no
all-reduce and two all-gathers, each process evaluating only its own bands;
and within 1e-8 of the JAX package's vmapped band solve. Tests in this
process (no group formed) cover how ``make_mesh`` deals the shards, a
``psum`` whose groups each lie in one process, and a band split whose band
crosses processes, which raises.
"""

import json

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
from super_resolution_tpu.parallel import make_mesh as jax_make_mesh
from super_resolution_tpu.solvers import IRLSMapSolver as JSolver
from super_resolution_tpu.solvers import IRLSMapSolverOptions as JOptions
from super_resolution_tpu.solvers import make_map_value_and_grad as jmake
from super_resolution_tpu.solvers import minimize as jminimize

from super_resolution_tpu_torch.parallel import Mesh, Sharded, band_split_minimize, collectives, make_mesh, multihost

TOLERANCE = 1e-6
SIDE, FRAMES, SCALE, BLUR_SIGMA, LAM, ITERATIONS = 16, 4, 2, 1.0, 0.01, 15
COMMON = ["--device", "cpu", "--dtype", "float64", "--side", str(SIDE), "--frames", str(FRAMES), "--scale",
          str(SCALE), "--blur_sigma", str(BLUR_SIGMA), "--lam", str(LAM), "--method", "linear_cg", "--iterations",
          str(ITERATIONS), "--irls_rounds", "1", "--tolerance", str(TOLERANCE)]
BTV = {"btv_range": 2, "btv_decay": 0.7}
REFINED = {"refine_motion_every": 1, "irls_rounds": 2}
BAND_SPLIT = {"mesh": "band=4", "mode": "band_split", "channels": 4, "method": "cg", "iterations": 25}
# (run's options, exchanges an evaluation in every process)
TWO_PROCESSES = [
    ({"mesh": "row=2,col=2", "regularizer": "tv", "width": 32}, 2),
    ({"mesh": "row=2,col=2", "regularizer": "btv", "width": 32, **BTV}, 2),
    ({"mesh": "band=4", "regularizer": "tv3d", "channels": 4}, 2),
    ({"mesh": "frame=2", "regularizer": "tv", **REFINED}, 0),
    (BAND_SPLIT, 0),
]
FOUR_PROCESSES = [
    ({"mesh": "row=2,col=2", "regularizer": "btv", "width": 32, **BTV}, 4),
    ({"mesh": "row=2,frame=2", "regularizer": "tv", "width": 32}, 2),
]


def _jax_regularizer(run):
    if run["regularizer"] == "btv":
        return JBTV(run["btv_range"], run["btv_decay"])
    return JTV(use_3d_total_variation=run["regularizer"] == "tv3d")


def _jax_solve(run):
    """The JAX package's mesh solve of the run's problem, on the numpy frames the port makes:
    ``(x, inner calls, shifts)``."""
    _, observations, _, _ = multihost.problem(SIDE, FRAMES, SCALE, BLUR_SIGMA, "cpu", torch.float64,
                                              channels=run.get("channels", 1), width=run.get("width", 0))
    lows = observations.numpy()
    axes = multihost.parse_mesh(run["mesh"])
    mesh = jax_make_mesh(axes, jax.devices()[:int(np.prod(list(axes.values())))])
    shifts = multihost.loopback_shifts(FRAMES, bool(run.get("refine_motion_every")))
    model = JImageModel.create(JParameters(scale=SCALE, blur_radius=3, blur_sigma=BLUR_SIGMA,
                                           motion_sequence=JSequence([tuple(row) for row in shifts])))
    options = JOptions(least_squares_solver="linear_cg", max_num_irls_iterations=run.get("irls_rounds", 1),
                       max_num_solver_iterations=ITERATIONS, gradient_norm_threshold=0.0, cost_decrease_threshold=0.0,
                       parameter_variation_threshold=0.0, irls_cost_difference_threshold=0.0,
                       refine_motion_every=run.get("refine_motion_every", 0))
    solver = JSolver(options, model, [jnp.asarray(f) for f in lows], mesh=mesh)
    solver.add_regularizer(_jax_regularizer(run), LAM)
    x0 = np.repeat(np.repeat(lows[0], SCALE, axis=-2), SCALE, axis=-1)
    x = np.asarray(solver.solve(jnp.asarray(x0)))
    return x, [list(call[1:]) for call in solver.last_inner_calls], np.asarray(solver.shifts)


def _jax_band_split(run):
    """The JAX package's vmapped band solve (``tests/test_parallel.py``'s form) of the band split run's problem."""
    _, observations, shifts, kernel = multihost.problem(SIDE, FRAMES, SCALE, BLUR_SIGMA, "cpu", torch.float64,
                                                        channels=run["channels"])
    obs = jnp.asarray(observations.numpy())
    x0 = jnp.repeat(jnp.repeat(obs[0], SCALE, axis=-2), SCALE, axis=-1)

    def solve_band(xc, obs_c):
        vg = jmake(obs_c, jnp.asarray(shifts), jnp.asarray(kernel), SCALE, [(JTV(), LAM)], max_shift=4)
        return jminimize(lambda x: vg(x, (jnp.ones_like(x),)), xc[None], method=run["method"],
                         max_iterations=run["iterations"])

    results = jax.vmap(solve_band)(x0, jnp.swapaxes(obs, 0, 1)[:, :, None])
    return np.asarray(results.x)[:, 0], np.asarray(results.iterations), np.asarray(results.num_evaluations)


def _check_band_split(run, run_results, processes, tmp_path, k):
    label = f"band split on {run['mesh']} over {processes} processes"
    for r in run_results:
        assert r["ok"] and r["bit_equal"] == {"serial": True, "one_process": True}, (label, json.dumps(r))
        # Nothing crosses inside the solve; two all-gathers assemble the result.
        assert r["all_reduce"] == r["exchange"] == 0 and r["all_gather"] == 2, label
        assert r["own_bands"] == [2 * r["process"], 2 * r["process"] + 1], label
        assert r["band_calls"] == r["own_band_evaluations"] == r["plain_version_calls"]["calls"], label
    assert len({r["estimate_sha256"] for r in run_results}) == 1, label
    estimates = [np.load(tmp_path / f"run{k}_{p}.npy") for p in range(processes)]
    assert all(np.array_equal(e, estimates[0]) for e in estimates[1:]), label
    x_jax, iterations, evaluations = _jax_band_split(run)
    assert run_results[0]["iterations"] == iterations.tolist(), label
    assert run_results[0]["evaluations"] == evaluations.tolist(), label
    assert np.abs(estimates[0] - x_jax).max() <= 1e-8, (label, np.abs(estimates[0] - x_jax).max())


def _check(processes, cases, tmp_path):
    runs = [dict(run, save_estimate=str(tmp_path / f"run{k}_")) for k, (run, _) in enumerate(cases)]
    results = multihost.run_processes("loopback", processes, COMMON + ["--runs", json.dumps(runs)], timeout_s=150)
    assert [r[0]["process"] for r in results] == list(range(processes))
    for k, ((run, exchanges), run_results) in enumerate(zip(cases, zip(*results))):
        if run.get("mode") == "band_split":
            _check_band_split(run, run_results, processes, tmp_path, k)
            continue
        label = f"{run['mesh']} {run['regularizer']} over {processes} processes"
        rounds = run.get("irls_rounds", 1)
        for r in run_results:
            assert r["ok"] and r["max_abs_diff"] <= TOLERANCE, (label, json.dumps(r))
            # make_sharded_map_solver: against its one-process mesh, and (one IRLS round: the same
            # problem) against the IRLS estimate.
            assert r["map_solver_max_abs_diff"] <= TOLERANCE, label
            assert rounds > 1 or r["map_solver_vs_irls"] <= TOLERANCE, label
            assert r["exchange_equal"] and r["adjoint_rel_error"] <= 1e-12, (label, r["adjoint_rel_error"])
            assert r["inner_calls"] == r["reference_inner_calls"] == [[ITERATIONS, ITERATIONS + 1]] * rounds, label
            if run.get("refine_motion_every"):
                # The refinement moved the motion, alike in every process and in the one-process mesh.
                assert r["shift_max_abs_diff"] <= TOLERANCE and r["shift_moved"] > 0.01, label
                assert r["shifts"] == run_results[0]["shifts"], label
            shards = int(np.prod(list(r["mesh"].values())))
            assert r["local_shards"] == list(range(r["process"] * shards // processes,
                                                    (r["process"] + 1) * shards // processes)), label
            # On CPU shards every evaluation runs the kernels' plain version once a local shard.
            assert r["plain_version_calls"]["calls"] == len(r["local_shards"]) * r["evaluations"], label
            assert r["exchange_per_evaluation"] == exchanges, label
            assert sum(one["psum"] for one in r["rounds"]) == r["evaluations"], label
            # The reference mesh lies in one process: nothing crosses there.
            assert r["reference_rounds"][0]["all_reduce"] == r["reference_rounds"][0]["exchange"] == 0, label
        assert len({r["estimate_sha256"] for r in run_results}) == 1, label
        assert len({r["all_reduce_per_evaluation"] for r in run_results}) == 1, label
        estimates = [np.load(tmp_path / f"run{k}_{p}.npy") for p in range(processes)]
        assert all(np.array_equal(e, estimates[0]) for e in estimates[1:]), label
        x_jax, calls_jax, shifts_jax = _jax_solve(run)
        assert calls_jax == run_results[0]["inner_calls"], label
        assert np.abs(estimates[0] - x_jax).max() <= TOLERANCE, (label, np.abs(estimates[0] - x_jax).max())
        if run.get("refine_motion_every"):
            shifts = np.load(tmp_path / f"run{k}_0.shifts.npy")
            assert np.abs(shifts - shifts_jax).max() <= TOLERANCE, (label, np.abs(shifts - shifts_jax).max())


@pytest.mark.timeout(240)
def test_row_col_and_band_axes_across_two_processes(tmp_path):
    _check(2, TWO_PROCESSES, tmp_path)


@pytest.mark.timeout(240)
def test_both_tile_axes_and_frame_with_row_across_four_processes(tmp_path):
    _check(4, FOUR_PROCESSES, tmp_path)


def test_a_group_wholly_in_one_process_never_crosses():
    """Process 0's view of ``{"row": 2, "frame": 2}`` over 2 processes (no group formed): each frame
    group lies in one process, so its sum is local, counted once, and nothing crosses; a row of
    tiles a process, and the frames of the other process's row are left alone."""
    mesh = Mesh(["row", "frame"], [2, 2], ["cpu"] * 4, processes=[0, 0, 1, 1], process_index=0)
    assert mesh.local_shards == [0, 1] and mesh.crosses_processes([0, 2]) and not mesh.crosses_processes([0, 1])
    parts = [torch.full((2,), float(i + 1)) for i in range(2)] + [None, None]
    collectives.reset_counts()
    summed, = collectives.psum_together(mesh, [(parts, ("frame",))])
    assert torch.equal(summed[0], torch.full((2,), 3.0)) and summed[0] is summed[1] and summed[2:] == [None, None]
    assert collectives.counts["psum"] == 1 and collectives.counts["all_reduce"] == 0


def test_band_split_whose_band_crosses_processes_raises():
    """``{"row": 2, "band": 2}`` over 2 processes: a row of shards a process, so each band's two row
    tiles lie in both processes and no process can solve a band alone; the refusal comes before any
    call between processes (no group is formed here). An ``x0`` not split by ``band`` (whole in every
    shard, or split by ``row`` alone) is refused alike."""
    mesh = Mesh(["row", "band"], [2, 2], ["cpu"] * 4, processes=[0, 0, 1, 1], process_index=0)
    x0 = Sharded.from_global(mesh, torch.zeros(2, 8, 8, dtype=torch.float64), {"band": 0, "row": 1})
    with pytest.raises(ValueError, match=r"band 0 lies in the shards of processes \[0, 1\]"):
        band_split_minimize(lambda x: (x.sum(), torch.ones_like(x)), x0)
    bands = Mesh(["band"], [2], ["cpu"] * 2, processes=[0, 1], process_index=0)
    for mesh, partition in ((bands, {}), (mesh, {"row": 1})):
        x0 = Sharded.from_global(mesh, torch.zeros(2, 8, 8, dtype=torch.float64), partition)
        with pytest.raises(ValueError, match="split along dimension 0 by 'band' only"):
            band_split_minimize(lambda x: (x.sum(), torch.ones_like(x)), x0)


def test_make_mesh_deals_any_axis_across_processes(monkeypatch):
    """Shards go to the processes in contiguous blocks of shard order, whichever axes that splits."""
    from super_resolution_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "process_count", lambda: 4)
    monkeypatch.setattr(distributed, "process_index", lambda: 2)
    tiles = make_mesh({"row": 2, "col": 2}, devices=["cpu"])
    assert tiles.processes == [0, 1, 2, 3] and tiles.local_shards == [2] and tiles.spans_processes
    bands = make_mesh({"band": 8}, devices=["cpu"])
    assert bands.processes == [0, 0, 1, 1, 2, 2, 3, 3] and bands.local_shards == [4, 5]
    with pytest.raises(ValueError, match="cannot be dealt evenly"):
        make_mesh({"band": 2}, devices=["cpu"])
