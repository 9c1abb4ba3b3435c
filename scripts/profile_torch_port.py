#!/usr/bin/env python3
"""Where the time goes in one of the port's solves, on one NVIDIA GPU.

    python3 scripts/profile_torch_port.py [--path flagship|estimated|hyperspectral|hyperspectral3d|
                                                  mesh_band|mesh_tiled|mesh_frame]
                                          [--side 1000] [--repeats 5] [--out DIR] [--drift]

Runs one path's solve through ``IRLSMapSolver`` a few times for wall-clock
numbers, then once more under ``torch.profiler`` and prints device time by
kernel, the device's busy and idle share of the solve, and the host time per
iteration. Writes the same as JSON to ``DIR/profile_torch_port[_PATH].json``
(default ``_profile``). Fails without a CUDA device. The paths, all float32,
linear_cg with a fixed iteration count, are those of ``chip_smoke.py``:

- ``flagship``: 1 x side x side HR, 4 frames, 4x, 3x3 blur sigma 1.5, TV 0.01,
  3 IRLS rounds x 50 iterations;
- ``estimated``: RGB 3 x 1000 x 1000, 4 frames at 4x with fractional shifts
  found by registration, BTV(3, 0.5) 0.01, 4 rounds x 50 iterations with the
  shifts refined between rounds (registration is timed beside the solve);
- ``hyperspectral`` / ``hyperspectral3d``: 64 bands x 256 x 256, 4 frames at
  2x, 2D / 3D spectral TV 0.01, 2 rounds x 20 iterations;
- ``mesh_band`` / ``mesh_tiled`` / ``mesh_frame``: the solve on a device mesh
  of 4 shards dealt over the visible cards (all on the one card where there
  is one): 4 band shards of the 64-band cube with 3D TV; 2x2 tiles of an RGB
  3 x 2048 x 2048 scene, 16 frames at 4x, BTV, 2 rounds x 20 iterations; 4
  frame shards of the ``estimated`` path, 3 rounds x 20 iterations. The same
  solve without a mesh is timed beside it, and the bytes that cross between
  shards per evaluation are reckoned from the shapes.

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

import chip_smoke  # noqa: E402  (scene, observation and solver helpers)
import super_resolution_tpu_torch as sr  # noqa: E402
from super_resolution_tpu_torch.evaluation import psnr  # noqa: E402
from super_resolution_tpu_torch.ops.cuda import degrade  # noqa: E402
from super_resolution_tpu_torch.ops.resize import linear_resize  # noqa: E402
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer  # noqa: E402


# Names of the kernels in csrc/degrade.cu, as the profiler reports them.
HAND_KERNELS = ("sr_residual_kernel", "sr_gradient_kernel", "sr_btv_gradient_kernel", "sr_reduce_kernel")


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


def path_solver(path, side, device):
    """(make_solver, x0, ground truth, extra report fields) for a path.
    ``make_solver()`` gives a fresh solver: a refined solve moves its shifts."""
    if path == "flagship":
        solver, x0, gt = flagship_solver(side, device)
        return (lambda: solver), x0, gt, {}
    if path == "estimated":
        gt, lows = chip_smoke.estimated_motion_problem(device)
        seconds = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            registered = sr.translational_registration(lows, device=device)
            seconds.append(time.perf_counter() - t0)
        shifts = registered.as_array() * 4
        x0 = linear_resize(lows[0], tuple(gt.shape[-2:])).contiguous()
        return (lambda: chip_smoke.estimated_motion_solver(lows, shifts, 1, device)), x0, gt, {
            "registration_seconds": seconds}
    if path.startswith("mesh_"):
        return mesh_path_solver(path, device)
    model, gt, lows = chip_smoke.hyperspectral_problem(device)
    x0 = linear_resize(lows[0], tuple(gt.shape[-2:])).contiguous()
    use_3d = path == "hyperspectral3d"
    return (lambda: chip_smoke.tv_solver(model, lows, use_3d, chip_smoke.fixed_iterations(20, 2), device)), x0, gt, {}


def mesh_path_solver(path, device):
    """As :func:`path_solver` for a meshed path; ``make_solver(mesh=...)``
    takes ``None`` for the same solve on one device. The extra fields hold
    the mesh and the bytes that cross between shards per evaluation."""
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    itemsize = 4
    if path == "mesh_band":
        mesh = sr.make_mesh({"band": 4}, devices)
        model, gt, lows = chip_smoke.hyperspectral_problem(device)
        make = lambda mesh=mesh: chip_smoke.tv_solver(model, lows, True, chip_smoke.fixed_iterations(20, 2), device, mesh=mesh)
        plane = gt.shape[-2] * gt.shape[-1] * itemsize
        crossing = {"spectral_halo_out": 3 * plane, "spectral_halo_back": 3 * plane, "cost_partials": 4 * itemsize}
    elif path == "mesh_tiled":
        mesh = sr.make_mesh({"row": 2, "col": 2}, devices)
        model, gt, lows = chip_smoke.tiled_problem(device)

        def make(mesh=mesh):
            solver = sr.IRLSMapSolver(chip_smoke.fixed_iterations(20, 2), model, lows, device=device, mesh=mesh)
            solver.add_regularizer(chip_smoke.BilateralTotalVariationRegularizer(3, 0.5), 0.01)
            return solver

        c, h, w = gt.shape
        q = chip_smoke._halo_width(chip_smoke.tiled_shifts(), chip_smoke.gaussian_kernel_2d(3, 1.5), 4, 3)
        th, tw = h // 2, w // 2
        # Of a tile's rim, the part inside the image comes from neighbours: q rows, q columns and one corner.
        rim = c * (q * tw + q * th + q * q) * itemsize
        crossing = {"halo_width": q, "halo_gather": 4 * rim, "halo_scatter_sum": 4 * rim, "cost_partials": 4 * itemsize}
    else:
        mesh = sr.make_mesh({"frame": 4}, devices)
        gt, lows = chip_smoke.estimated_motion_problem(device)
        shifts = sr.translational_registration(lows, device=device).as_array() * 4
        make = lambda mesh=mesh: chip_smoke.estimated_motion_solver(lows, shifts, 1, device, 3, 20, mesh=mesh)
        crossing = {"frame_gradient_sum_in": 3 * gt.numel() * itemsize, "frame_gradient_sum_out": 3 * gt.numel() * itemsize,
                    "cost_partials": 4 * itemsize}
    x0 = linear_resize(lows[0], tuple(gt.shape[-2:])).contiguous()
    return make, x0, gt, {"mesh": dict(mesh.shape), "cards": len(devices),
                          "bytes_crossing_between_shards_per_evaluation": crossing}


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
    return x, chip_smoke._l1_objective(solver, x, 0.01), float(psnr(x, gt))


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
    parser.add_argument("--path", default="flagship",
                        choices=("flagship", "estimated", "hyperspectral", "hyperspectral3d",
                                 "mesh_band", "mesh_tiled", "mesh_frame"))
    parser.add_argument("--side", type=int, default=1000, help="HR side of the flagship path")
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
    make_solver, x0, gt, extra = path_solver(args.path, args.side, device)
    timed_solve(make_solver(), x0)  # build + warm-up

    seconds = []
    for _ in range(args.repeats):
        solver = make_solver()
        s, x = timed_solve(solver, x0)
        seconds.append(s)
    iterations = solver.last_inner_iterations
    evaluations = sum(c[2] for c in solver.last_inner_calls)
    pixels = gt.numel()  # values per iteration: bands x H x W
    best = min(seconds)
    if args.path.startswith("mesh_"):
        # The same solve on one device, in turns with nothing else changed.
        timed_solve(make_solver(mesh=None), x0)
        extra["single_device_solve_seconds"] = [timed_solve(make_solver(mesh=None), x0)[0] for _ in range(args.repeats)]
    solver = make_solver()

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
        "card": card, "path": args.path, "shape": list(gt.shape), "iterations": iterations,
        "evaluations": evaluations, **extra,
        "solve_seconds": seconds, "solve_seconds_best": best,
        "mpixel_iterations_per_s": iterations * pixels / best / 1e6,
        "host_us_per_iteration": best / iterations * 1e6,
        "traced_solve_seconds": traced_seconds,
        "device_busy_us": busy_us, "device_busy_share_of_traced_solve": busy_us / (traced_seconds * 1e6),
        "hand_kernels_us": ours_us, "hand_kernels_share_of_busy": ours_us / busy_us if busy_us else None,
        "launches": dict(degrade.launch_counts),
        "shift_sources": dict(degrade.shift_source_counts),
        "shard_launches": dict(degrade.shard_launch_counts),
        "psnr_db": float(psnr(x, gt)),
        "kernels": [{"name": name, **info} for name, info in top[:25]],
    }
    os.makedirs(args.out, exist_ok=True)
    suffix = "" if args.path == "flagship" else f"_{args.path}"
    with open(os.path.join(args.out, f"profile_torch_port{suffix}.json"), "w") as f:
        json.dump(report, f, indent=1)

    print(f"card: {card}")
    print(f"{args.path} {tuple(gt.shape)}: {iterations} iterations, {evaluations} evaluations; "
          f"solve seconds {[round(s, 4) for s in seconds]} (best {best:.4f})")
    for key, value in extra.items():
        print(f"  {key}: {[round(v, 4) for v in value] if isinstance(value, list) else value}")
    print(f"  launches {report['launches']}, of which in the mesh modes {report['shard_launches']}")
    print(f"  {report['mpixel_iterations_per_s']:.1f} Mvalue-iterations/s, "
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
