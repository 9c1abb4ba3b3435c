"""A frame-sharded solve across processes on one host: the loopback check and the scaling harness.

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
from super_resolution_tpu_torch.parallel.mesh import FRAME_AXIS, make_mesh

__all__ = ["problem", "run_processes", "loopback", "scaling", "parser", "main"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LOOPBACK_SHIFTS = [(0, 0), (1, 1), (-1, 0), (0, -1)]
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def problem(side: int, frames: int, scale: int, blur_sigma: float, device, dtype, seed: int = 7):
    """The loopback's problem, made from ``seed`` alike in every process:
    a random ``1 x side x side`` scene, ``frames`` LR frames at ``scale``
    (the JAX loopback's integer shifts in turn), a 3x3 Gaussian blur.
    Returns ``(ground truth, observations [K, 1, h, w], shifts [K, 2], kernel)``."""
    from super_resolution_tpu_torch.models.image_model import ImageModel, ImageModelParameters
    from super_resolution_tpu_torch.motion import MotionShiftSequence

    rng = np.random.default_rng(seed)
    hr = torch.tensor(rng.random((1, side, side)), dtype=dtype, device=device)
    sequence = MotionShiftSequence([LOOPBACK_SHIFTS[k % len(LOOPBACK_SHIFTS)] for k in range(frames)])
    model = ImageModel.create(ImageModelParameters(scale=scale, blur_radius=3, blur_sigma=blur_sigma,
                                                   motion_sequence=sequence))
    observations = torch.stack([model.apply(hr, k) for k in range(frames)])
    return hr, observations, np.asarray(sequence.as_array(), dtype=np.float64), np.asarray(model.blur_operator.kernel)


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


def loopback(args) -> dict:
    """One process's part of the loopback check (the group already formed)."""
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


# The options a worker takes from its orchestrator.
_FORWARDED = ("backend", "device", "dtype", "side", "frames", "scale", "blur_sigma", "lam", "method", "iterations",
              "shards_per_process", "shards", "tolerance")


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
    parser.add_argument("--side", type=int, default=16, help="HR side")
    parser.add_argument("--frames", type=int, default=4, help="LR frames")
    parser.add_argument("--scale", type=int, default=2)
    parser.add_argument("--blur_sigma", type=float, default=1.0)
    parser.add_argument("--lam", type=float, default=0.0, help="TV weight (0: the data term alone)")
    parser.add_argument("--method", default="cg")
    parser.add_argument("--iterations", type=int, default=25)
    parser.add_argument("--shards_per_process", type=int, default=2)
    parser.add_argument("--shards", default="1,2,4", help="scaling: frame-mesh sizes")
    parser.add_argument("--tolerance", type=float, default=1e-9)
    parser.add_argument("--timeout", type=float, default=600.0)
    return parser


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.command == "worker":
        distributed.initialize(args.coordinator, int(args.processes), args.process_id, backend=args.backend)
        try:
            result = loopback(args) if args.worker_command == "loopback" else scaling(args)
        finally:
            distributed.shutdown()
        print(json.dumps(result), flush=True)
        return 0
    forwarded = [item for name in _FORWARDED for item in (f"--{name}", str(getattr(args, name)))]
    if args.command == "loopback":
        results = run_processes("loopback", int(args.processes), forwarded, args.timeout)
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
