#!/usr/bin/env python3
"""Where the time goes in the port's flagship solve, on one NVIDIA GPU.

    python3 scripts/profile_torch_port.py [--side 1000] [--repeats 5] [--out DIR] [--drift]

Runs the fixed-iteration flagship (1 x side x side HR, 4 frames, 4x, 3x3 blur
sigma 1.5, TV 0.01, linear_cg, 3 IRLS rounds x 50 iterations, float32) through
``IRLSMapSolver`` a few times for wall-clock numbers, then once more under
``torch.profiler`` and prints device time by kernel, the device's busy and
idle share of the solve, and the host time per iteration. Writes the same as
JSON to ``DIR/profile_torch_port.json`` (default ``_profile``). Fails
without a CUDA device.

``--drift`` runs another study instead: how far two implementations of the
same TV solve drift apart as the iteration count grows (248x248, the kernels
against the plain version on the card, and the plain version on the card
against the same plain version on the CPU), in max|x difference|, relative
difference of the final L1 objective and PSNR difference. Written to
``DIR/drift_torch_port.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402  (scene and observation helpers)
import super_resolution_tpu_torch as sr  # noqa: E402
from super_resolution_tpu_torch.ops.cuda import degrade  # noqa: E402
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer  # noqa: E402


# Names of the kernels in csrc/degrade.cu, as the profiler reports them.
HAND_KERNELS = ("sr_residual_kernel", "sr_gradient_kernel", "sr_reduce_kernel")


def flagship_solver(side, device):
    gt = chip_smoke.synthetic_scene(1, side, side, seed=2026)
    model, gt_t, lows = chip_smoke.make_observations(
        gt, chip_smoke.FLAGSHIP_SHIFTS, 4, 3, 1.5, device, torch.float32)
    options = sr.IRLSMapSolverOptions(
        least_squares_solver="linear_cg", max_num_solver_iterations=50, max_num_irls_iterations=3,
        gradient_norm_threshold=0.0, cost_decrease_threshold=0.0, parameter_variation_threshold=0.0)
    solver = sr.IRLSMapSolver(options, model, lows, device=device, dtype=torch.float32)
    solver.add_regularizer(TotalVariationRegularizer(), 0.01)
    x0 = lows[0].repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1)
    return solver, x0, gt_t


def timed_solve(solver, x0):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = solver.solve(x0)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, x


def plain_solve(gt_np, options, device, dtype):
    """The TV solve through the plain version on ``device``: (x, L1 objective, PSNR)."""
    model, gt, lows = chip_smoke.make_observations(gt_np, chip_smoke.FLAGSHIP_SHIFTS, 4, 3, 1.5, device, dtype)
    solver = chip_smoke.PlainObjectiveSolver(options, model, lows, device=device, dtype=dtype)
    solver.add_regularizer(TotalVariationRegularizer(), 0.01)
    x = solver.solve(lows[0].repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1))
    return x, chip_smoke._l1_objective(solver, x, 0.01), float(sr.evaluation.psnr(x, gt))


def drift_study(device, out, card, side=248):
    gt_np = chip_smoke.synthetic_scene(1, side, side, seed=7)
    rows = []
    print(f"card: {card}")
    print(f"drift of the {side}x{side} TV solve (linear_cg, fixed iterations per round x rounds)")
    print("dtype    iterations  pair                     max|dx|    rel dObjective  dPSNR dB")
    for dtype in (torch.float32, torch.float64):
        for iterations, rounds in ((10, 1), (20, 1), (50, 1), (100, 1), (50, 3)):
            options = chip_smoke.fixed_iterations(iterations, rounds)
            kernels_vs_plain = chip_smoke.compare_solves(side, options, device, dtype)[:3]
            on_card, on_cpu = (plain_solve(gt_np, options, d, dtype) for d in (device, torch.device("cpu")))
            card_vs_cpu = (float((on_card[0].cpu() - on_cpu[0]).abs().max()),
                           abs(on_card[1] - on_cpu[1]) / abs(on_cpu[1]), abs(on_card[2] - on_cpu[2]))
            for pair, (dx, dobj, dpsnr) in (("kernels vs plain, card", kernels_vs_plain),
                                            ("plain card vs plain cpu", card_vs_cpu)):
                rows.append({"dtype": str(dtype), "iterations": iterations, "rounds": rounds, "pair": pair,
                             "max_abs_dx": dx, "rel_objective_diff": dobj, "psnr_diff_db": dpsnr})
                print(f"{str(dtype)[6:]:8s} {iterations:4d} x {rounds}   {pair:24s} {dx:9.2e}  {dobj:13.2e}  {dpsnr:8.5f}")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "drift_torch_port.json"), "w") as f:
        json.dump({"card": card, "side": side, "rows": rows}, f, indent=1)
    return 0


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--side", type=int, default=1000)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--out", default=os.path.join(ROOT, "_profile"))
    parser.add_argument("--drift", action="store_true", help="run the drift study instead of the profile")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device is available", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    if args.drift:
        return drift_study(device, args.out, card)
    solver, x0, gt = flagship_solver(args.side, device)
    timed_solve(solver, x0)  # build + warm-up

    seconds = []
    for _ in range(args.repeats):
        s, x = timed_solve(solver, x0)
        seconds.append(s)
    iterations = solver.last_inner_iterations
    evaluations = sum(c[2] for c in solver.last_inner_calls)
    pixels = args.side * args.side
    best = min(seconds)

    from torch.profiler import ProfilerActivity, profile

    degrade.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_seconds, _ = timed_solve(solver, x0)
    kernels = {}
    for event in prof.key_averages():
        device_us = getattr(event, "device_time_total", None)
        if device_us is None:
            device_us = getattr(event, "cuda_time_total", 0.0)
        if str(getattr(event, "device_type", "")).endswith("CUDA") and device_us > 0:
            kernels[event.key] = {"calls": event.count, "device_us": device_us}
    busy_us = sum(k["device_us"] for k in kernels.values())
    ours_us = sum(k["device_us"] for name, k in kernels.items() if any(h in name for h in HAND_KERNELS))
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["device_us"])

    report = {
        "card": card, "side": args.side, "iterations": iterations, "evaluations": evaluations,
        "solve_seconds": seconds, "solve_seconds_best": best,
        "mpixel_iterations_per_s": iterations * pixels / best / 1e6,
        "host_us_per_iteration": best / iterations * 1e6,
        "traced_solve_seconds": traced_seconds,
        "device_busy_us": busy_us, "device_busy_share_of_traced_solve": busy_us / (traced_seconds * 1e6),
        "hand_kernels_us": ours_us, "hand_kernels_share_of_busy": ours_us / busy_us if busy_us else None,
        "launches": dict(degrade.launch_counts),
        "psnr_db": float(sr.evaluation.psnr(x, gt)),
        "kernels": [{"name": name, **info} for name, info in top[:25]],
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_torch_port.json"), "w") as f:
        json.dump(report, f, indent=1)

    print(f"card: {card}")
    print(f"flagship {args.side}x{args.side}: {iterations} iterations, {evaluations} evaluations; "
          f"solve seconds {[round(s, 4) for s in seconds]} (best {best:.4f})")
    print(f"  {report['mpixel_iterations_per_s']:.1f} Mpixel-iterations/s, "
          f"{report['host_us_per_iteration']:.1f} us wall per iteration, PSNR {report['psnr_db']:.2f} dB")
    if busy_us == 0:
        print("  the profiler recorded no device time; time with CUDA events instead")
        return 1
    print(f"  traced solve {traced_seconds:.4f} s: device busy {busy_us / 1e3:.2f} ms "
          f"({100 * report['device_busy_share_of_traced_solve']:.1f} %), idle "
          f"{100 * (1 - report['device_busy_share_of_traced_solve']):.1f} %; "
          f"hand-written kernels {ours_us / 1e3:.2f} ms ({100 * ours_us / busy_us:.1f} % of busy)")
    for name, info in top[:12]:
        print(f"  {info['device_us'] / 1e3:9.3f} ms  {info['calls']:6d} calls  "
              f"{info['device_us'] / info['calls']:8.2f} us/call  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
