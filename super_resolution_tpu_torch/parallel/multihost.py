"""A solve across processes on one host: the loopback checks and the scaling harness.

The port's counterparts of the JAX package's ``experiments/multihost_loopback.py``
and ``bench.py``'s ``bench_scaling``. Each process joins a ``torch.distributed``
group over localhost (:func:`~super_resolution_tpu_torch.parallel.distributed.initialize`),
builds the same seeded problem, and runs ``make_sharded_map_solver`` on a
``frame`` mesh that spans the processes, its own shards on ``--device``::

    python -m super_resolution_tpu_torch.parallel.multihost loopback --processes 2 --device cpu
    python -m super_resolution_tpu_torch.parallel.multihost scaling --shards 1,2,4 --processes 1,2 --device cpu

``loopback``: every process holds the distributed result against its own
single-process solve of the same problem (``minimize`` on the
``make_map_value_and_grad`` objective) and prints one JSON line, with the
data-term kernels' launches by mode and the plain version's calls in its
timed solve; the orchestrator prints ``PASS`` when every process did and
exits 0.

``loopback --mesh`` runs ``IRLSMapSolver(mesh=...)`` on a mesh of any axes
across the processes (``row=2,col=2``, ``band=4``, ``row=2,frame=2``; the
shards are dealt to the processes in contiguous blocks of shard order), with
``--regularizer tv|btv|tv3d``, ``--channels`` and ``--irls_rounds``, and
holds it against the same solve on a one-process mesh of the same layout in
each process (the ``--tolerance`` elementwise; equal iterations and
evaluations in every round). With ``--refine_motion_every N`` the solver
refines the motion every N rounds, starting from shifts moved off the true
ones by a seeded offset of up to ``REFINE_SHIFT_OFFSET`` HR pixels (frame 0
kept), and the refined shifts are held too. Each process also prints, per
IRLS round, the all-reduces and point-to-point exchanges it made and their bytes, the
SHA-256 of its estimate's bytes, and with ``--save_estimate PREFIX`` writes
the estimate to ``PREFIX<rank>.npy`` (and refined shifts to
``PREFIX<rank>.shifts.npy``)::

    python -m super_resolution_tpu_torch.parallel.multihost loopback --processes 2 --device cpu \
        --mesh row=2,col=2 --regularizer btv --width 32 --method linear_cg --iterations 15 --tolerance 1e-6
    python -m super_resolution_tpu_torch.parallel.multihost loopback --processes 2 --device cpu \
        --mesh band=4 --regularizer tv3d --channels 4 --method linear_cg --iterations 15 --tolerance 1e-6
    python -m super_resolution_tpu_torch.parallel.multihost loopback --processes 2 --device cpu --mesh frame=2 \
        --lam 0.01 --irls_rounds 2 --refine_motion_every 1 --method linear_cg --tolerance 1e-6

``loopback --mesh band=4 --mode band_split`` runs ``band_split_minimize``
on ``x0`` placed over the mesh (the upsampled first frame): each band its own
objective (its channel of the frames, TV at ``--lam``), the minimize
defaults' stop thresholds and ``--iterations``; each process holds every
band bit for bit against the same call on a one-process mesh (both timed
warm: every band's objective is first run through a one-iteration
``minimize``, untimed) and its own bands against ``minimize`` on each alone,
and counts the all-reduces (none) and all-gathers (two) the call made across
processes and the evaluations of its own bands::

    python -m super_resolution_tpu_torch.parallel.multihost loopback --processes 2 --device cpu \
        --mesh band=4 --mode band_split --channels 4 --lam 0.01 --method cg --iterations 25

``scaling``: one JSON line per (processes, shards) point: frame-iterations
per second and the collective calls per evaluation, counted where
``parallel/collectives.py`` makes them (``psum``: sums over shards,
``all_reduce``: what crossed between processes). The contract, as the JAX
harness's: the counts per evaluation stay flat as the mesh grows.

Workers are this module started again with ``worker``; the orchestrator
finds a free localhost port, starts them, waits with a timeout, and kills
any that outlive it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from super_resolution_tpu_torch.ops.cuda import degrade
from super_resolution_tpu_torch.parallel import collectives, distributed
from super_resolution_tpu_torch.parallel.data_parallel import make_sharded_map_solver, shard_problem
from super_resolution_tpu_torch.parallel.mesh import BAND_AXIS, COL_AXIS, FRAME_AXIS, ROW_AXIS, Mesh, make_mesh

__all__ = ["problem", "run_processes", "loopback", "scaling", "parser", "main"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LOOPBACK_SHIFTS = [(0, 0), (1, 1), (-1, 0), (0, -1)]
REFINE_SHIFT_OFFSET = 0.3  # HR pixels: how far --refine_motion_every's starting shifts lie off the true ones
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def loopback_shifts(frames: int, moved: bool = False) -> np.ndarray:
    """``[K, 2]`` shifts: the JAX loopback's integer shifts in turn; ``moved``:
    each but frame 0's moved by a seeded offset of up to
    ``REFINE_SHIFT_OFFSET`` HR pixels, for the refiner to move back."""
    shifts = np.asarray([LOOPBACK_SHIFTS[k % len(LOOPBACK_SHIFTS)] for k in range(frames)], dtype=np.float64)
    if not moved:
        return shifts
    offset = np.random.default_rng(13).uniform(-REFINE_SHIFT_OFFSET, REFINE_SHIFT_OFFSET, shifts.shape)
    offset[0] = 0.0
    return shifts + offset


def image_model(frames: int, scale: int, blur_sigma: float, moved: bool = False):
    """The loopback's image model: :func:`loopback_shifts`, a 3x3 Gaussian blur."""
    from super_resolution_tpu_torch.models.image_model import ImageModel, ImageModelParameters
    from super_resolution_tpu_torch.motion import MotionShiftSequence

    sequence = MotionShiftSequence([tuple(row) for row in loopback_shifts(frames, moved)])
    return ImageModel.create(ImageModelParameters(scale=scale, blur_radius=3, blur_sigma=blur_sigma,
                                                  motion_sequence=sequence))


def problem(side: int, frames: int, scale: int, blur_sigma: float, device, dtype, seed: int = 7, channels: int = 1,
            width: int = 0):
    """The loopback's problem, made from ``seed`` alike in every process:
    a random ``channels x side x width`` scene (``width`` 0: ``side``),
    ``frames`` LR frames at ``scale`` through :func:`image_model`.
    Returns ``(ground truth, observations [K, C, h, w], shifts [K, 2], kernel)``."""
    rng = np.random.default_rng(seed)
    hr = torch.tensor(rng.random((channels, side, width or side)), dtype=dtype, device=device)
    model = image_model(frames, scale, blur_sigma)
    observations = torch.stack([model.apply(hr, k) for k in range(frames)])
    shifts = model.motion_operator.motion_sequence.as_array()
    return hr, observations, np.asarray(shifts, dtype=np.float64), np.asarray(model.blur_operator.kernel)


def _regularizers(lam: float):
    from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer

    return [(TotalVariationRegularizer(), lam)] if lam > 0 else []


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _solve_options(args) -> dict:
    return dict(method=args.method, max_iterations=args.iterations, gradient_norm_threshold=0.0,
                cost_decrease_threshold=0.0, parameter_variation_threshold=0.0)


def _distributed_solve(args, mesh, hr, observations, shifts, kernel, weights):
    """The sharded solve once to warm up, then timed: ``(result, x, wall s,
    counts of the timed run)``; the counts are the collectives' and, under
    ``launches`` and ``plain_version_calls``, the data-term kernels' launches by
    mode and the calls of their plain version."""
    options = _solve_options(args)
    solve = make_sharded_map_solver(mesh, kernel, args.scale, _regularizers(args.lam), **options)
    placed = shard_problem(mesh, torch.zeros_like(hr), observations, shifts)
    solve(*placed, weights)
    collectives.reset_counts()
    # Read as differences: a caller in this process keeps its own launch counts.
    launched, plain = dict(degrade.launch_counts), degrade.plain_version_calls["calls"]
    _synchronize(args.device)
    t0 = time.perf_counter()
    result = solve(*placed, weights)
    x = result.x.to_global()
    _synchronize(args.device)
    seconds = time.perf_counter() - t0
    launched = {name: degrade.launch_counts[name] - count for name, count in launched.items()}
    return result, x, seconds, dict(collectives.counts, launches=launched,
                                    plain_version_calls=degrade.plain_version_calls["calls"] - plain)


def _all_reduce_ms(nbytes: int, device, dtype, repeats: int = 20) -> float:
    """Median ms of one all-reduce of a buffer of ``nbytes`` on ``device`` (synchronised around each)."""
    buffer = torch.zeros(max(1, nbytes // torch.tensor([], dtype=dtype).element_size()), dtype=dtype, device=device)
    times = []
    for _ in range(repeats + 2):
        _synchronize(device)
        t0 = time.perf_counter()
        distributed.all_reduce_sum(buffer)
        _synchronize(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times[2:])) * 1e3


def _single_process_solve(args, hr, observations, shifts, kernel):
    """The same problem on one device without a mesh: ``(result, ms per evaluation)``."""
    from super_resolution_tpu_torch.solvers.least_squares import minimize
    from super_resolution_tpu_torch.solvers.objective import make_map_value_and_grad

    vg = make_map_value_and_grad(observations, shifts, kernel, args.scale, _regularizers(args.lam),
                                 device=args.device, dtype=hr.dtype)
    bound = vg.prepare(tuple(torch.ones_like(hr) for _ in _regularizers(args.lam)))
    result = minimize(bound, torch.zeros_like(hr), **_solve_options(args))
    x0 = torch.zeros_like(hr)
    bound(x0)
    _synchronize(args.device)
    t0 = time.perf_counter()
    for _ in range(10):
        bound(x0)
    _synchronize(args.device)
    return result, (time.perf_counter() - t0) / 10 * 1e3


def parse_mesh(text: str) -> dict[str, int]:
    """``"row=2,col=2"`` -> ``{"row": 2, "col": 2}``."""
    return {name.strip(): int(size) for name, size in (item.split("=") for item in text.split(","))}


def irls_regularizer(name: str, btv_range: int, btv_decay: float):
    """The regulariser ``--regularizer`` names: ``tv``, ``tv3d`` or ``btv``."""
    from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
    from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer

    if name == "btv":
        return BilateralTotalVariationRegularizer(btv_range, btv_decay)
    if name in ("tv", "tv3d"):
        return TotalVariationRegularizer(name == "tv3d")
    raise ValueError(f"Unknown regularizer {name!r}; options: tv, tv3d, btv")


def _irls_solve(args, mesh, model, lows, x0):
    """``IRLSMapSolver(mesh=mesh)`` on the loopback's problem once to warm up,
    then timed: ``(solver, x, wall s, per-round counts, launches)``. A round's
    counts are the collectives' calls and bytes between two IRLS seams and
    its evaluations; the launches are the data-term kernels' by mode, their
    shard-mode / spectral-halo launches and the plain version's calls."""
    from super_resolution_tpu_torch.solvers.irls import IRLSMapSolver, IRLSMapSolverOptions

    options = IRLSMapSolverOptions(
        least_squares_solver=args.method, max_num_solver_iterations=args.iterations,
        max_num_irls_iterations=args.irls_rounds, gradient_norm_threshold=0.0, cost_decrease_threshold=0.0,
        parameter_variation_threshold=0.0, irls_cost_difference_threshold=0.0,
        refine_motion_every=args.refine_motion_every)
    solver = IRLSMapSolver(options, model, lows, device=args.device, dtype=DTYPES[args.dtype], mesh=mesh)
    solver.add_regularizer(irls_regularizer(args.regularizer, args.btv_range, args.btv_decay), args.lam)
    shifts0 = solver.shifts.clone()
    solver.solve(x0)
    solver.shifts = shifts0.clone()  # a refining solve leaves its refined motion behind
    rounds = []
    # The seam reweights once a round: read the counts there.
    reweight = solver._reweight
    solver._reweight = lambda x: (rounds.append(dict(collectives.counts)), reweight(x))[1]
    collectives.reset_counts()
    counters = (degrade.launch_counts, degrade.shard_launch_counts, degrade.plain_version_calls)
    before = [dict(c) for c in counters]
    _synchronize(args.device)
    t0 = time.perf_counter()
    x = solver.solve(x0)
    _synchronize(args.device)
    seconds = time.perf_counter() - t0
    launches = {name: {key: counter[key] - was[key] for key in counter} for name, counter, was in zip(
        ("launches", "shard_launches", "plain_version_calls"), counters, before)}
    per_round, previous = [], dict.fromkeys(collectives.counts, 0)
    for snapshot, call in zip(rounds, solver.last_inner_calls):
        per_round.append({name: snapshot[name] - previous[name] for name in snapshot} | {"evaluations": call[2]})
        previous = snapshot
    return solver, x, seconds, per_round, launches


def _map_solve(args, mesh, model, observations, x0) -> torch.Tensor:
    """One inner solve through ``make_sharded_map_solver`` on ``mesh`` from
    ``x0`` with unit IRLS weights (what the first IRLS round solves), gathered."""
    regularizer = irls_regularizer(args.regularizer, args.btv_range, args.btv_decay)
    solve = make_sharded_map_solver(mesh, np.asarray(model.blur_operator.kernel), args.scale, [(regularizer, args.lam)],
                                    **_solve_options(args))
    placed = shard_problem(mesh, x0, observations, model.motion_operator.motion_sequence.as_array())
    return solve(*placed, (torch.ones_like(x0),)).x.to_global()


def _l1_objective(solver, x) -> float:
    """What IRLS minimises (the data term + 2 lambda * the regulariser's
    residuals), through the kernels' plain version on ``x``'s device."""
    cost, _ = degrade.fused_objective_reference(x, solver.observations, solver.shifts, solver.blur_kernel,
                                                solver.scale)
    for reg, lam in solver.regularizers:
        cost = cost + 2.0 * lam * reg.residuals(x).sum()
    return float(cost)


def exchange_check(across: Mesh, alone: Mesh, tile_shape, q: int, device) -> dict:
    """The exchanges of ``parallel/collectives.py`` on ``across`` (a mesh over
    the processes) against the same calls on ``alone`` (its one-process
    twin), on float64 tiles of ``tile_shape`` made from a seed alike in every
    process: ``halo_gather`` / ``halo_scatter_sum`` (``q`` wide) where the
    mesh has ``row`` / ``col``, the spectral-halo pair where it has ``band``.
    Returns ``{"exchange_equal": each of this process's results equal to the
    one-process one bit for bit, "adjoint_rel_error": |<G x, y> - <x, G^T y>|
    / |<G x, y>| over every shard (0 without spatial axes)}``."""
    rng = np.random.default_rng(11)
    n = across.num_shards
    c, h, w = tile_shape

    def tiles(shape):
        return [torch.tensor(rng.random(shape), dtype=torch.float64, device=device) for _ in range(n)]

    def local(parts):
        return [p if across.is_local(i) else None for i, p in enumerate(parts)]

    equal, adjoint = True, 0.0
    if ROW_AXIS in across.shape or COL_AXIS in across.shape:
        x, y = tiles((c, h, w)), tiles((c, h + 2 * q, w + 2 * q))
        gx, gty = collectives.halo_gather(across, local(x), q), collectives.halo_scatter_sum(across, local(y), q)
        gx1, gty1 = collectives.halo_gather(alone, x, q), collectives.halo_scatter_sum(alone, y, q)
        equal = all(torch.equal(gx[i], gx1[i]) and torch.equal(gty[i], gty1[i]) for i in across.local_shards)
        dots = torch.stack([sum(torch.vdot(a[i].reshape(-1), b[i].reshape(-1)) for i in across.local_shards)
                            for a, b in ((gx, y), (x, gty))])
        collectives.all_reduce(dots)
        adjoint = float((dots[0] - dots[1]).abs() / dots[0].abs())
    if BAND_AXIS in across.shape:
        x, y = tiles((c, h, w)), tiles((c + 1, h, w))
        pairs = [(collectives.spectral_halo_extend(across, local(x)), collectives.spectral_halo_extend(alone, x)),
                 (collectives.spectral_halo_return(across, local(y)), collectives.spectral_halo_return(alone, y))]
        equal = equal and all(torch.equal(a[i], b[i]) for a, b in pairs for i in across.local_shards)
    return {"exchange_equal": equal, "adjoint_rel_error": adjoint}


def band_split_loopback(args) -> dict:
    """One process's part of ``loopback --mesh ... --mode band_split``:
    ``band_split_minimize`` with ``x0`` on the mesh across the processes,
    beside each band's ``minimize`` alone and the same call on a one-process
    mesh of the same layout (the group already formed)."""
    from super_resolution_tpu_torch.parallel.data_parallel import band_split_minimize
    from super_resolution_tpu_torch.parallel.sharded import Sharded
    from super_resolution_tpu_torch.parallel.sharded_objective import X_PARTITION
    from super_resolution_tpu_torch.solvers.least_squares import minimize
    from super_resolution_tpu_torch.solvers.objective import make_map_value_and_grad

    dtype = DTYPES[args.dtype]
    sizes = parse_mesh(args.mesh)
    _, observations, shifts, kernel = problem(args.side, args.frames, args.scale, args.blur_sigma, args.device,
                                              dtype, channels=args.channels, width=args.width)
    x0 = observations[0].repeat_interleave(args.scale, dim=-2).repeat_interleave(args.scale, dim=-1).contiguous()
    functions = [make_map_value_and_grad(observations[:, c:c + 1], shifts, kernel, args.scale, _regularizers(args.lam),
                                         device=args.device, dtype=dtype)
                 .prepare(tuple(torch.ones_like(x0[c:c + 1]) for _ in _regularizers(args.lam)))
                 for c in range(args.channels)]
    options = dict(method=args.method, max_iterations=args.iterations)
    across = make_mesh(sizes, devices=[args.device])
    alone = Mesh(list(sizes), list(sizes.values()), [args.device] * across.num_shards)

    def timed(mesh):
        """``band_split_minimize`` with ``x0`` on ``mesh``: (result, wall s, the bands of each call in order)."""
        calls = []
        counted = [lambda x, c=c, f=f: (calls.append(c), f(x))[1] for c, f in enumerate(functions)]
        placed = Sharded.from_global(mesh, x0, X_PARTITION)
        _synchronize(args.device)
        t0 = time.perf_counter()
        result = band_split_minimize(counted, placed, **options)
        _synchronize(args.device)
        return result, time.perf_counter() - t0, calls

    for c, f in enumerate(functions):  # first-call costs, before either side is timed
        minimize(f, x0[c:c + 1], method=args.method, max_iterations=1)
    one, one_seconds, one_calls = timed(alone)
    gathers = []
    gather = distributed.all_gather
    distributed.all_gather = lambda t: (gathers.append(t.numel() * t.element_size()), gather(t))[1]
    collectives.reset_counts()
    counters = (degrade.launch_counts, degrade.plain_version_calls)
    before = [dict(c) for c in counters]
    try:
        result, seconds, calls = timed(across)
    finally:
        distributed.all_gather = gather
    launches = {name: {key: counter[key] - was[key] for key in counter} for name, counter, was in zip(
        ("launches", "plain_version_calls"), counters, before)}
    crossing = dict(collectives.counts)
    mine = sorted(set(calls))
    serial = {c: minimize(functions[c], x0[c:c + 1], **options) for c in mine}  # this process's bands alone
    bit_equal = {
        "serial": all(torch.equal(result.x[c:c + 1], r.x) and torch.equal(result.cost[c], r.cost)
                      and (result.iterations[c], result.num_evaluations[c]) == (r.iterations, r.num_evaluations)
                      for c, r in serial.items()),
        "one_process": (torch.equal(result.x, one.x) and torch.equal(result.cost, one.cost)
                        and result.iterations == one.iterations and result.num_evaluations == one.num_evaluations),
    }
    if args.save_estimate:
        np.save(f"{args.save_estimate}{distributed.process_index()}.npy", result.x.cpu().numpy())
    evaluations = sum(result.num_evaluations[c] for c in mine)
    return {
        "process": distributed.process_index(), "processes": distributed.process_count(), "mode": "band_split",
        "mesh": across.shape, "local_shards": across.local_shards, "channels": args.channels,
        "hw": list(x0.shape[-2:]), "device": str(torch.device(args.device)), "dtype": args.dtype,
        "own_bands": mine, "iterations": result.iterations, "evaluations": result.num_evaluations,
        "own_band_evaluations": evaluations, "band_calls": len(calls),
        "bit_equal": bit_equal, "all_reduce": crossing["all_reduce"], "exchange": crossing["exchange"],
        "all_gather": len(gathers), "all_gather_bytes": sum(gathers), **launches,
        "estimate_sha256": hashlib.sha256(result.x.cpu().numpy().tobytes()).hexdigest(),
        "ok": all(bit_equal.values()) and crossing["all_reduce"] == 0 and len(gathers) == 2
        and len(calls) == evaluations,
        # ms a band evaluation: this process's bands across processes, every band in one process
        "wall_s": seconds, "ms_per_evaluation": seconds / max(1, len(calls)) * 1e3,
        "single_process_wall_s": one_seconds, "single_process_ms_per_evaluation": one_seconds / len(one_calls) * 1e3,
    }


def mesh_loopback(args) -> dict:
    """One process's part of ``loopback --mesh``: ``IRLSMapSolver`` on the
    mesh across the processes beside the same solve on a one-process mesh
    of the same layout (the group already formed)."""
    if args.mode == "band_split":
        return band_split_loopback(args)
    dtype = DTYPES[args.dtype]
    sizes = parse_mesh(args.mesh)
    hr, observations, _, _ = problem(args.side, args.frames, args.scale, args.blur_sigma, args.device, dtype,
                                     channels=args.channels, width=args.width)
    model = image_model(args.frames, args.scale, args.blur_sigma, bool(args.refine_motion_every))
    lows = list(observations)
    x0 = lows[0].repeat_interleave(args.scale, dim=-2).repeat_interleave(args.scale, dim=-1)
    across = make_mesh(sizes, devices=[args.device])
    alone = Mesh(list(sizes), list(sizes.values()), [args.device] * across.num_shards)
    tile = (args.channels // across.size(BAND_AXIS), hr.shape[-2] // across.size(ROW_AXIS),
            hr.shape[-1] // across.size(COL_AXIS))
    checked = exchange_check(across, alone, tile, args.scale, args.device)
    solver, x, seconds, rounds, launches = _irls_solve(args, across, model, lows, x0)
    reference, x_ref, seconds_ref, rounds_ref, _ = _irls_solve(args, alone, model, lows, x0)
    diff = float((x - x_ref).abs().max())
    shift_diff = float((solver.shifts - reference.shifts).abs().max())
    x_map = _map_solve(args, across, model, observations, x0)
    map_diff = float((x_map - _map_solve(args, alone, model, observations, x0)).abs().max())
    evaluations = sum(r["evaluations"] for r in rounds)
    calls, reference_calls = ([c[1:] for c in s.last_inner_calls] for s in (solver, reference))
    ok = (diff <= args.tolerance and map_diff <= args.tolerance and shift_diff <= args.tolerance
          and calls == reference_calls
          and checked["exchange_equal"] and checked["adjoint_rel_error"] <= 1e-12)
    psnr = [float(10 * torch.log10(1.0 / torch.mean((v.to(torch.float64) - hr) ** 2))) for v in (x, x_ref)]
    cost, cost_ref = _l1_objective(solver, x), _l1_objective(reference, x_ref)
    if args.save_estimate:
        np.save(f"{args.save_estimate}{distributed.process_index()}.npy", x.cpu().numpy())
        if args.refine_motion_every:
            np.save(f"{args.save_estimate}{distributed.process_index()}.shifts.npy", solver.shifts.cpu().numpy())
    return {
        "process": distributed.process_index(), "processes": distributed.process_count(),
        "mesh": across.shape, "local_shards": across.local_shards, "channels": args.channels,
        "hw": list(hr.shape[-2:]), "frames": args.frames, "scale": args.scale, "regularizer": args.regularizer,
        "device": str(torch.device(args.device)), "dtype": args.dtype, "backend": args.backend,
        "inner_calls": calls, "reference_inner_calls": reference_calls,
        "evaluations": evaluations, "max_abs_diff": diff, "tolerance": args.tolerance,
        "refine_motion_every": args.refine_motion_every, "shift_max_abs_diff": shift_diff,
        "shifts": solver.shifts.tolist(),
        "shift_moved": float((solver.shifts.cpu() - torch.tensor(loopback_shifts(args.frames, bool(args.refine_motion_every))))
                             .abs().max()),
        # make_sharded_map_solver across processes against the one-process mesh, and (with
        # one IRLS round, which solves the same problem) against the IRLS estimate.
        "map_solver_max_abs_diff": map_diff, "map_solver_vs_irls": float((x_map - x).abs().max()),
        "psnr_db": psnr[0], "reference_psnr_db": psnr[1], "cost_rel_diff": abs(cost - cost_ref) / abs(cost_ref),
        "estimate_sha256": hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest(),
        **checked, "ok": ok,
        "rounds": rounds, "reference_rounds": rounds_ref, **launches,
        "wall_s": seconds, "ms_per_evaluation": seconds / evaluations * 1e3,
        "single_process_ms_per_evaluation": seconds_ref / sum(r["evaluations"] for r in rounds_ref) * 1e3,
        "scalar_all_reduce_ms": _all_reduce_ms(1, args.device, dtype),
        **{f"{name}_per_evaluation": sum(r[name] for r in rounds) / evaluations
           for name in ("all_reduce", "all_reduce_bytes", "exchange", "exchange_bytes")},
    }


def loopback(args) -> dict:
    """One process's part of the loopback check (the group already formed)."""
    if args.mesh:
        return mesh_loopback(args)
    dtype = DTYPES[args.dtype]
    frames = args.frames
    hr, observations, shifts, kernel = problem(args.side, frames, args.scale, args.blur_sigma, args.device, dtype)
    mesh = make_mesh({FRAME_AXIS: args.shards_per_process * distributed.process_count()}, devices=[args.device])
    weights = tuple(torch.ones_like(hr) for _ in _regularizers(args.lam))
    result, x, seconds, counts = _distributed_solve(args, mesh, hr, observations, shifts, kernel, weights)
    reference, evaluation_ms = _single_process_solve(args, hr, observations, shifts, kernel)
    diff = float((x - reference.x).abs().max())
    evaluations = result.num_evaluations
    psnr = [float(10 * torch.log10(1.0 / torch.mean((v.to(torch.float64) - hr) ** 2))) for v in (x, reference.x)]
    nbytes = counts["all_reduce_bytes"] // max(1, counts["all_reduce"])
    return {
        "process": distributed.process_index(), "processes": distributed.process_count(),
        "mesh": mesh.shape, "local_shards": len(mesh.local_shards), "frames": frames, "side": args.side,
        "device": str(torch.device(args.device)), "dtype": args.dtype, "backend": args.backend,
        "iterations": result.iterations, "evaluations": evaluations,
        "reference_iterations": reference.iterations, "reference_evaluations": reference.num_evaluations,
        "max_abs_diff": diff, "tolerance": args.tolerance, "psnr_db": psnr[0], "reference_psnr_db": psnr[1],
        "cost_rel_diff": abs(float(result.cost) - float(reference.cost)) / abs(float(reference.cost)),
        "launches": counts["launches"], "plain_version_calls": counts["plain_version_calls"],
        "ok": diff <= args.tolerance and result.iterations == reference.iterations,
        "wall_s": seconds, "ms_per_evaluation": seconds / evaluations * 1e3,
        "psum_per_evaluation": counts["psum"] / evaluations,
        "all_reduce_per_evaluation": counts["all_reduce"] / evaluations,
        "all_reduce_bytes_per_evaluation": counts["all_reduce_bytes"] / evaluations,
        "all_reduce_ms": _all_reduce_ms(nbytes, args.device, dtype) if counts["all_reduce"] else 0.0,
        "single_process_ms_per_evaluation": evaluation_ms,
    }


def scaling(args) -> list[dict]:
    """One process's part of the scaling points (the group, if any, already formed)."""
    dtype = DTYPES[args.dtype]
    processes = distributed.process_count()
    hr, observations, shifts, kernel = problem(args.side, args.frames, args.scale, args.blur_sigma, args.device,
                                               dtype, seed=5)
    weights = tuple(torch.ones_like(hr) for _ in _regularizers(args.lam))
    points = []
    for shards in (int(n) for n in args.shards.split(",")):
        if shards % processes or args.frames % shards:
            continue
        mesh = make_mesh({FRAME_AXIS: shards}, devices=[args.device])
        result, _, seconds, counts = _distributed_solve(args, mesh, hr, observations, shifts, kernel, weights)
        evaluations = result.num_evaluations
        points.append({
            "processes": processes, "shards": shards, "process": distributed.process_index(),
            "device": str(torch.device(args.device)),
            "frame_iterations_per_s": args.frames * result.iterations / seconds,
            "evaluations": evaluations,
            "psum_per_evaluation": counts["psum"] / evaluations,
            "all_reduce_per_evaluation": counts["all_reduce"] / evaluations,
            "all_reduce_bytes_per_evaluation": counts["all_reduce_bytes"] / evaluations,
        })
    return points


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(command: str, processes: int, argv: list[str], timeout_s: float = 600.0) -> list[dict]:
    """Start ``processes`` workers of ``command`` (``loopback`` / ``scaling``)
    with ``argv``, joined over a free localhost port; wait for all, kill any
    that outlive ``timeout_s``; return what each printed as its last JSON
    line, in rank order. Raises ``RuntimeError`` with the output of a worker
    that failed."""
    address = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")]))}
    workers = [subprocess.Popen(
        [sys.executable, "-m", "super_resolution_tpu_torch.parallel.multihost", "worker", command,
         "--coordinator", address, "--processes", str(processes), "--process_id", str(rank), *argv],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for rank in range(processes)]
    outputs = []
    try:
        deadline = time.monotonic() + timeout_s
        for worker in workers:
            out, err = worker.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outputs.append((worker.returncode, out, err))
    finally:
        for worker in workers:
            if worker.poll() is None:
                worker.kill()
                worker.communicate()
    failed = [(rank, code, out, err) for rank, (code, out, err) in enumerate(outputs) if code != 0]
    if failed:
        rank, code, out, err = failed[0]
        raise RuntimeError(f"{command} worker {rank} exited {code}:\n{out}\n{err}")
    return [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outputs]


def _runs(args) -> list[argparse.Namespace]:
    """One set of options for each entry of ``--runs``: ``args`` with the entry's values in place."""
    return [argparse.Namespace(**{**vars(args), **run}) for run in json.loads(args.runs)]


# The options a worker takes from its orchestrator.
_FORWARDED = ("backend", "device", "dtype", "side", "width", "channels", "frames", "scale", "blur_sigma", "lam",
              "method", "iterations", "shards_per_process", "shards", "tolerance", "mesh", "regularizer", "btv_range",
              "btv_decay", "irls_rounds", "save_estimate", "runs", "mode", "refine_motion_every")


def parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("command", choices=["loopback", "scaling", "worker"])
    parser.add_argument("worker_command", nargs="?", choices=["loopback", "scaling"])
    parser.add_argument("--processes", default="2", help="loopback: a count; scaling: counts, e.g. 1,2")
    parser.add_argument("--process_id", type=int, default=0)
    parser.add_argument("--coordinator", default="")
    parser.add_argument("--backend", default="gloo")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", choices=sorted(DTYPES), default="float64")
    parser.add_argument("--side", type=int, default=16, help="HR side (rows)")
    parser.add_argument("--width", type=int, default=0, help="HR columns (0: --side)")
    parser.add_argument("--channels", type=int, default=1)
    parser.add_argument("--frames", type=int, default=4, help="LR frames")
    parser.add_argument("--scale", type=int, default=2)
    parser.add_argument("--blur_sigma", type=float, default=1.0)
    parser.add_argument("--lam", type=float, default=0.0, help="TV weight (0: the data term alone)")
    parser.add_argument("--method", default="cg")
    parser.add_argument("--iterations", type=int, default=25)
    parser.add_argument("--shards_per_process", type=int, default=2)
    parser.add_argument("--shards", default="1,2,4", help="scaling: frame-mesh sizes")
    parser.add_argument("--tolerance", type=float, default=1e-9)
    parser.add_argument("--mesh", default="", help="loopback: IRLSMapSolver on this mesh, e.g. row=2,col=2")
    parser.add_argument("--regularizer", choices=["tv", "tv3d", "btv"], default="tv", help="--mesh: the regulariser")
    parser.add_argument("--btv_range", type=int, default=2)
    parser.add_argument("--btv_decay", type=float, default=0.7)
    parser.add_argument("--irls_rounds", type=int, default=1)
    parser.add_argument("--mode", choices=["irls", "band_split"], default="irls",
                        help="--mesh: IRLSMapSolver, or band_split_minimize with x0 on the mesh")
    parser.add_argument("--refine_motion_every", type=int, default=0, help="--mesh: refine the motion every N rounds")
    parser.add_argument("--save_estimate", default="", help="--mesh: write the estimate to <prefix><rank>.npy")
    parser.add_argument("--runs", default="", help="several runs in one start of the processes: a JSON list of "
                        "option values, e.g. '[{\"mesh\": \"band=4\", \"regularizer\": \"tv3d\"}]'")
    parser.add_argument("--timeout", type=float, default=600.0)
    return parser


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.command == "worker":
        distributed.initialize(args.coordinator, int(args.processes), args.process_id, backend=args.backend)
        try:
            run = loopback if args.worker_command == "loopback" else scaling
            result = [run(a) for a in _runs(args)] if args.runs else run(args)
        finally:
            distributed.shutdown()
        print(json.dumps(result), flush=True)
        return 0
    forwarded = [item for name in _FORWARDED for item in (f"--{name}", str(getattr(args, name)))]
    if args.command == "loopback":
        results = run_processes("loopback", int(args.processes), forwarded, args.timeout)
        results = [r for result in results for r in (result if args.runs else [result])]
        for result in results:
            print(json.dumps(result), flush=True)
        ok = all(r["ok"] for r in results)
        print("multihost loopback:", "PASS" if ok else "FAIL", flush=True)
        return 0 if ok else 1
    for processes in (int(n) for n in args.processes.split(",")):
        for point in run_processes("scaling", processes, forwarded, args.timeout):
            for row in point:
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
