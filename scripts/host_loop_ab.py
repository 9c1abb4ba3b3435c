#!/usr/bin/env python3
"""Wall and device time of one tree's host-loop line-search solves, on one NVIDIA GPU.

    python3 scripts/host_loop_ab.py [--root DIR] [--label NAME] [--turns N] [--out FILE]

Imports ``super_resolution_tpu_torch`` from ``DIR`` (default: this checkout;
its kernels are built first if they are not) and runs, float32, through
``IRLSMapSolver``'s host loop (``fused_irls=False``), the solves of
chip_smoke.py that take the ``cg`` line search there:

- ``data_term``: phase 5's data-term solve, the flagship (1x1000x1000, 4
  frames at 4x, blur 3 / 1.5) with no regulariser, ``cg``, 20 iterations and
  the default stop thresholds;
- ``tv``: the flagship TV, ``cg`` 3 x 50 with the stop thresholds at 0 (phase 10);
- ``btv``: the flagship BTV, ``cg`` 2 x 20 (phase 10).

Each solve runs once to warm up, then ``N`` times (wall: median, min, max,
ending in a device synchronise), then once inside a ``torch.profiler``
window for the device busy time and the kernels launched. Prints one JSON
line and appends it to ``FILE`` if given. To compare trees, run them in
turns on the same card (A, B, B, A), one process each; chip_smoke.py's own
helpers (data, options) from this checkout are used for every tree.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _profile(run, device):
    """Device busy ms and kernels launched during ``run()``, from one profiler window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(device)
    busy_us, kernels = 0.0, 0
    for event in prof.key_averages():
        device_us = getattr(event, "device_time_total", None)
        if device_us is None:
            device_us = getattr(event, "cuda_time_total", 0.0)
        if str(getattr(event, "device_type", "")).endswith("CUDA") and device_us > 0:
            busy_us += device_us
            if not event.key.startswith(("Memcpy", "Memset")):
                kernels += event.count
    return busy_us / 1e3, kernels


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=ROOT, help="checkout whose super_resolution_tpu_torch is timed")
    parser.add_argument("--label", default=None)
    parser.add_argument("--turns", type=int, default=5)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import super_resolution_tpu_torch as sr
    from super_resolution_tpu_torch.ops.cuda import build

    if not os.path.abspath(sr.__file__).startswith(root + os.sep):
        raise SystemExit(f"host_loop_ab: imported {sr.__file__}, not the package under {root}")
    if not torch.cuda.is_available():
        print("host_loop_ab: no CUDA device is available", file=sys.stderr)
        return 3
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # finds the package imported above

    device = torch.device("cuda", 0)
    build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    flagship = cs.synthetic_scene(1, 1000, 1000, seed=2026)
    solves = {
        "data_term": (sr.IRLSMapSolverOptions(least_squares_solver="cg", max_num_solver_iterations=20), None),
        "tv": (dataclasses.replace(cs.fixed_iterations(50, 3), least_squares_solver="cg"),
               cs.TotalVariationRegularizer()),
        "btv": (sr.IRLSMapSolverOptions(least_squares_solver="cg", max_num_solver_iterations=20,
                                        max_num_irls_iterations=2), cs.BilateralTotalVariationRegularizer(3, 0.5)),
    }
    result = {"label": args.label or root, "card": card, "torch": torch.__version__, "solves": {}}
    for name, (options, reg) in solves.items():
        def make():
            model, gt, lows = cs.make_observations(flagship, cs.FLAGSHIP_SHIFTS, 4, 3, 1.5, device, torch.float32)
            solver = sr.IRLSMapSolver(dataclasses.replace(options, fused_irls=False), model, lows, device=device,
                                      dtype=torch.float32)
            if reg is not None:
                solver.add_regularizer(reg, 0.01)
            return solver, lows[0].repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1), gt

        walls = []
        for turn in range(args.turns + 1):
            solver, x0, gt = make()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            x = solver.solve(x0)
            torch.cuda.synchronize(device)
            if turn:  # the first solve warms up
                walls.append(time.perf_counter() - t0)
        solver, x0, _ = make()
        busy_ms, kernels = _profile(lambda: solver.solve(x0), device)
        calls = [tuple(c[1:]) for c in solver.last_inner_calls]
        evaluations = sum(c[1] for c in calls)
        result["solves"][name] = {
            "wall_s": float(np.median(walls)), "wall_min_s": min(walls), "wall_max_s": max(walls),
            "device_busy_ms": busy_ms, "kernels": kernels, "kernels_per_evaluation": kernels / evaluations,
            "iterations": sum(c[0] for c in calls), "evaluations": evaluations, "rounds": calls,
            "psnr": float(cs.psnr(x, gt)),
        }
        print(f"{result['label']} {name}: wall {result['solves'][name]['wall_s']:.4f} s "
              f"[{min(walls):.4f}, {max(walls):.4f}], busy {busy_ms:.2f} ms, {kernels} kernels "
              f"({kernels / evaluations:.1f} per evaluation), iterations and evaluations per round {calls}",
              flush=True)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
