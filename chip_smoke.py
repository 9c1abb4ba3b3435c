#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version on the card, runs the C++ reference's
golden problems through the kernels, and drives the port's main path — the
IRLS MAP solve — at the flagship size (1x1000x1000 HR, 4 frames, 4x, 3x3
blur). Needs one CUDA device, ``nvcc`` and no network. Every phase that fails
makes the run exit non-zero; nothing falls back to the CPU.

Output: progress lines, then one JSON line ``{"kernels": [...]}`` with each
kernel's error against its plain version, its time and its bound, then the
card's name and power limit as ``nvidia-smi`` gives them, and as the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

try:
    import numpy as np
    import torch

    import super_resolution_tpu_torch as sr
    from super_resolution_tpu_torch.evaluation import psnr
    from super_resolution_tpu_torch.motion import MotionShiftSequence
    from super_resolution_tpu_torch.ops.blur import gaussian_kernel_2d
    from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
    from super_resolution_tpu_torch.ops.cuda import build, degrade
    from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
    from super_resolution_tpu_torch.solvers.least_squares import minimize
except ImportError as exc:  # e.g. this file alone, without the package
    print(f"chip_smoke: cannot import the port: {exc}", file=sys.stderr)
    sys.exit(2)

# Published peaks of one H100 SXM (NVIDIA data sheet): the yardstick for `bound_ms`.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

# Tolerances, kernel vs plain version on the same device: the two differ in
# the order of their sums (and fused multiply-adds), nothing else.
TOLERANCE = {torch.float32: 1e-5, torch.float64: 1e-11}
# An IRLS round may not raise the L1 objective by more than float32 noise.
OBJECTIVE_RISE_TOLERANCE = 1e-5

REPLACES = {
    "data_term": "super_resolution_tpu/ops/pallas/degrade.py:1111",
    "data_term_tv": "super_resolution_tpu/ops/pallas/degrade.py:1256",
    "data_term_btv": "super_resolution_tpu/ops/pallas/degrade.py:1405",
}
SOURCE = "super_resolution_tpu_torch/ops/cuda/csrc/degrade.cu"
FLAGSHIP_SHIFTS = [(0, 0), (1, 1), (0, 1), (1, 0)]


class Failure(Exception):
    pass


def check(condition, message):
    if not condition:
        raise Failure(message)


def log(message):
    print(message, flush=True)


# --------------------------------------------------------------------------- data


def synthetic_scene(c, h, w, seed):
    """Edges and smooth texture in [0, 1], made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    img = np.empty((c, h, w))
    for ch in range(c):
        smooth = 0.5 + 0.2 * np.sin(xx / (17.0 + 3 * ch)) * np.cos(yy / 23.0) + 0.1 * np.sin((xx + yy) / 7.0)
        for _ in range(12):  # rectangles and discs with sharp edges
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            ry, rx = rng.integers(max(2, h // 40), max(3, h // 6)), rng.integers(max(2, w // 40), max(3, w // 6))
            level = rng.uniform(-0.35, 0.35)
            if rng.random() < 0.5:
                smooth[max(0, cy - ry): cy + ry, max(0, cx - rx): cx + rx] += level
            else:
                smooth[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0] += level
        img[ch] = smooth + 0.02 * rng.standard_normal((h, w))
    return np.clip(img, 0.0, 1.0)


def make_observations(gt, shifts, scale, blur_radius, blur_sigma, device, dtype):
    """LR stack through the port's own image model, plus the model."""
    model = sr.ImageModel.create(sr.ImageModelParameters(
        scale=scale, blur_radius=blur_radius, blur_sigma=blur_sigma,
        motion_sequence=MotionShiftSequence(shifts)))
    gt_t = torch.as_tensor(gt, dtype=dtype, device=device)
    lows = [model.apply(gt_t, k).contiguous() for k in range(len(shifts))]
    return model, gt_t, lows


def load_golden(name):
    with open(os.path.join(ROOT, "tests", "golden", name), "rb") as f:
        c, h, w = struct.unpack("iii", f.read(12))
        data = np.frombuffer(f.read(), dtype=np.float64)
    return data.reshape(c, h, w).copy()


# --------------------------------------------------------------------------- phases


def phase_environment():
    log(f"[1/5] environment: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch CUDA {torch.version.cuda}")
    nvcc = build.find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60).stdout
    log("      nvcc: " + version.strip().splitlines()[-1])
    smi = shutil.which("nvidia-smi")
    check(smi is not None, "nvidia-smi not found")
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0 and out.stdout.strip(), f"nvidia-smi failed: {out.stderr}")
    card = out.stdout.strip().splitlines()[0]
    log(f"      card: {card}")
    return card


def phase_build():
    t0 = time.perf_counter()
    results = build.build()
    for name, info in results.items():
        log(f"[2/5] build: csrc/{name}.cu -> {os.path.relpath(info['path'], ROOT)} "
            f"({'built' if info['built'] else 'already built'}, {info['seconds']:.1f} s)")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line.lower():
                log("      " + line.strip())
    log(f"      build total {time.perf_counter() - t0:.1f} s")


def _kernel_problem(c, hw, scale, shifts, kernel, seed, device, dtype):
    rng = np.random.default_rng(seed)
    h, w = hw
    x = rng.random((c, h, w))
    x[:, h // 5: h // 3, w // 4: w // 2] = 0.25   # flat patches: sign(0) = 0
    x[:, :3, :3] = 0.75
    y = rng.random((len(shifts), c, h // scale, w // scale))
    constants = rng.random((c, h, w)) * 0.02
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=device).contiguous()
    return to(x), to(y), np.asarray(shifts, dtype=np.float64), kernel, to(constants)


def _mode_kwargs(name, constants):
    if name == "data_term_tv":
        return {"tv_constants": constants}
    if name == "data_term_btv":
        return {"btv_constants": constants, "btv_range": 3, "btv_decay": 0.5}
    return {}


def _time_launches(fn, device, repeats):
    """Milliseconds of device time per call of ``fn``.

    The wrapper's host side (allocations, ctypes calls) can take longer than
    the kernels, and events around a loop would then time the host. So the
    device is first kept busy with a spin kernel while the host enqueues all
    the calls; the events then bracket back-to-back device work only.
    """
    fn()
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e8))  # ~0.2 s of spinning at the card's clock
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / repeats


def _bound(name, x, y, shifts, kernel, scale, dtype):
    """Least time for one evaluation: each input read once, each output written
    once, and the operations the function needs (each regulariser residual
    counted once per pixel, whatever a kernel chooses to recompute)."""
    itemsize = x.element_size()
    nbytes = (x.numel() + y.numel() + x.numel()) * itemsize          # x, y, grad
    if name != "data_term":
        nbytes += x.numel() * itemsize                                 # constants
    nbytes += shifts.size * 8 + (0 if kernel is None else kernel.size * itemsize) + itemsize
    kh, kw = (1, 1) if kernel is None else kernel.shape
    taps = [sum(1 for wy in ((1 - (dy - np.floor(dy))), dy - np.floor(dy))
                for wx in ((1 - (dx - np.floor(dx))), dx - np.floor(dx)) if wy * wx != 0.0)
            for dx, dy in shifts]
    lr = y.numel() // y.shape[0]
    flops = sum(lr * (kh * kw * (2 * t + 2) + 3) for t in taps)                      # forward + r^2
    hits = -(-kh // scale) * -(-kw // scale)
    flops += sum(x.numel() * (t * (2 * hits + 2) + 1) for t in taps) + x.numel()     # adjoint
    if name == "data_term_tv":
        flops += x.numel() * 30
    elif name == "data_term_btv":
        flops += x.numel() * (15 * 3 + 8 * 6 + 24)   # residual once, 8 overlap terms, own term
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations"), nbytes, flops


def phase_kernels(device):
    """Each kernel against its plain version on the same device."""
    gauss = gaussian_kernel_2d
    lopsided = np.random.default_rng(7).random((4, 3))
    lopsided /= lopsided.sum()
    frac = [(0, 0), (1.25, -0.5), (-2.0, 3.0), (0.5, 0.5), (-0.3, -1.6)]
    mid, big = (252, 332), (1000, 1000)
    cases = [
        (3, mid, 2, frac, gauss(3, 1.0)),
        (1, mid, 4, FLAGSHIP_SHIFTS, None),
        (3, mid, 4, frac, lopsided),
        (1, big, 4, FLAGSHIP_SHIFTS, gauss(3, 1.5)),
        (1, big, 2, frac[:4], gauss(3, 1.0)),
    ]
    worst = {name: 0.0 for name in degrade.KERNEL_NAMES}
    for dtype in (torch.float32, torch.float64):
        tol = TOLERANCE[dtype]
        for i, (c, hw, scale, shifts, kernel) in enumerate(cases):
            x, y, sh, kern, constants = _kernel_problem(c, hw, scale, shifts, kernel, 100 + i, device, dtype)
            for name in degrade.KERNEL_NAMES:
                kw = _mode_kwargs(name, constants)
                cost, grad = degrade.fused_objective(x, y, sh, kern, scale, **kw)
                torch.cuda.synchronize(device)
                ref_cost, ref_grad = degrade.fused_objective_reference(x, y, sh, kern, scale, **kw)
                check(bool(torch.isfinite(cost)) and bool(torch.isfinite(grad).all()),
                      f"{name}: non-finite output")
                cost_err = abs(float(cost) - float(ref_cost)) / abs(float(ref_cost))
                scale_g = float(ref_grad.abs().max())
                abs_err = float((grad - ref_grad).abs().max())
                grad_err = abs_err / scale_g
                if dtype == torch.float32:
                    worst[name] = max(worst[name], abs_err)
                check(cost_err <= tol and grad_err <= tol,
                      f"{name} {dtype} case {i} (C={c}, HR={hw}, s={scale}): cost rel err {cost_err:.3e}, "
                      f"grad err {grad_err:.3e} > {tol:g}")
        log(f"[3/5] kernels: {len(cases)} shapes x 3 modes agree with the plain version in {dtype} (tol {tol:g})")

    # Times at the flagship shape, float32.
    c, hw, scale, shifts, kernel = cases[3]
    x, y, sh, kern, constants = _kernel_problem(c, hw, scale, shifts, kernel, 200, device, torch.float32)
    sh_dev = torch.as_tensor(sh, dtype=torch.float64, device=device)
    kern_dev = torch.as_tensor(kern, dtype=torch.float32, device=device)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    rows = []
    for name in degrade.KERNEL_NAMES:
        kw = _mode_kwargs(name, constants)
        run = lambda: degrade.fused_objective(x, y, sh_dev, kern_dev, scale, **kw)
        plain = lambda: degrade.fused_objective_reference(x, y, sh, kern, scale, **kw)
        ms = _time_launches(run, device, 200)
        plain_ms = _time_launches(plain, device, 10)
        cold = []
        for _ in range(10):  # each launch after the 50 MB L2 was overwritten
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize(device)
            cold.append(start.elapsed_time(end))
        bound_ms, bound_by, nbytes, flops = _bound(name, x, y, sh, kern, scale, torch.float32)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": 0, "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "ms_cold_l2": sorted(cold)[len(cold) // 2],
            "bytes": nbytes, "operations": flops, "shape": f"C={c} HR={hw[0]}x{hw[1]} K={len(shifts)} s={scale} float32",
        })
        log(f"      {name}: {ms:.4f} ms/launch (cold L2 {rows[-1]['ms_cold_l2']:.4f}), plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.5f} ms by {bound_by}")
    return rows


def _golden_solve(lr_names, initial_name, params, regularizer, lam, device):
    lows = [load_golden(n) for n in lr_names]
    solver = sr.IRLSMapSolver(sr.IRLSMapSolverOptions(), sr.ImageModel.create(params), lows,
                              device=device, dtype=torch.float64)
    if regularizer is not None:
        solver.add_regularizer(regularizer, lam)
    return solver.solve(load_golden(initial_name)).cpu().numpy()


def phase_goldens(device):
    """The C++ reference's golden problems through the kernels, float64."""
    seq_a = MotionShiftSequence([(0, 0), (1, 0), (0, 1), (1, 1)])
    seq = MotionShiftSequence(FLAGSHIP_SHIFTS)
    t0 = time.perf_counter()
    ours = _golden_solve([f"icon_lr_{i}.bin" for i in range(4)], "icon_initial.bin",
                         sr.ImageModelParameters(scale=2, motion_sequence=seq_a), None, 0.0, device)
    err_a = float(np.abs(ours - load_golden("icon_unreg_result.bin")).max())
    check(err_a < 1e-3, f"golden A: max abs diff {err_a}")

    ours = _golden_solve([f"dallas_lr_{i}.bin" for i in range(4)], "dallas_initial.bin",
                         sr.ImageModelParameters(scale=2, blur_radius=3, blur_sigma=1.0, motion_sequence=seq),
                         TotalVariationRegularizer(), 0.01, device)
    ref = load_golden("dallas_tv_result.bin")
    agreement = float(psnr(ours, ref))
    check(agreement > 40.0 and np.abs(ours - ref).mean() < 5e-3, f"golden B: agreement {agreement} dB")

    ours = _golden_solve([f"dallas4x_lr_{i}.bin" for i in range(4)], "dallas4x_initial.bin",
                         sr.ImageModelParameters(scale=4, blur_radius=3, blur_sigma=1.5, motion_sequence=seq),
                         BilateralTotalVariationRegularizer(3, 0.5), 0.01, device)
    gt = load_golden("dallas4x_ground_truth.bin")
    psnr_ours = float(psnr(ours, gt))
    psnr_ref = float(psnr(load_golden("dallas4x_btv_result.bin"), gt))
    check(abs(psnr_ours - psnr_ref) <= 0.1, f"golden C: {psnr_ours} dB vs reference {psnr_ref} dB")
    log(f"[4/5] goldens: A max|diff| {err_a:.2e}; B agreement {agreement:.2f} dB; "
        f"C {psnr_ours:.3f} dB vs C++ {psnr_ref:.3f} dB ({time.perf_counter() - t0:.1f} s)")


def _l1_objective(solver, x, lam):
    """What IRLS minimises: data term + 2 lambda * sum of the regulariser's residuals.

    Each round minimises ``D(x) + lambda sum r(x)^2 / r(x_prev)``; as
    ``r^2 / r_prev >= 2 r - r_prev`` with equality at ``x_prev``, that
    majorises this objective up to a constant, so no round may raise it.
    """
    # The plain version: this check must not add to the kernels' launch counts.
    cost, _ = degrade.fused_objective_reference(
        x, solver.observations, solver.shifts, solver.blur_kernel, solver.scale)
    for reg, _ in solver.regularizers:
        cost = cost + 2.0 * lam * reg.residuals(x).sum()
    return float(cost)


class PlainObjectiveSolver(sr.IRLSMapSolver):
    """The same IRLS solve with every evaluation through the plain version
    (one fused TV term), on whatever device the solver was given."""

    def _build_inner_solver(self, observations, opts):
        (_, lam), = self.regularizers

        def inner(x0, weights):
            constants = lam * weights[0]
            return minimize(
                lambda x: degrade.fused_objective_reference(
                    x, observations, self.shifts, self.blur_kernel, self.scale, tv_constants=constants),
                x0, method=opts.least_squares_solver, max_iterations=opts.max_num_solver_iterations,
                gradient_norm_threshold=opts.gradient_norm_threshold,
                cost_decrease_threshold=opts.cost_decrease_threshold,
                parameter_variation_threshold=opts.parameter_variation_threshold,
                linear_cg_refresh_every=opts.linear_cg_refresh_every,
            )

        return inner


def fixed_iterations(iterations, rounds):
    """linear_cg options whose stop thresholds are 0: every round runs ``iterations``."""
    return sr.IRLSMapSolverOptions(
        least_squares_solver="linear_cg", max_num_solver_iterations=iterations, max_num_irls_iterations=rounds,
        gradient_norm_threshold=0.0, cost_decrease_threshold=0.0, parameter_variation_threshold=0.0)


def solve_once(name, gt_np, scale, options, regularizer, lam, device, dtype, solver_class=sr.IRLSMapSolver):
    """One solve from the nearest-neighbour start, with its launch count checked
    against its evaluation count and its L1 objective read after every IRLS round."""
    model, gt, lows = make_observations(gt_np, FLAGSHIP_SHIFTS, scale, 3, 1.5, device, dtype)
    solver = solver_class(options, model, lows, device=device, dtype=dtype)
    if regularizer is not None:
        solver.add_regularizer(regularizer, lam)
    # The solver reweights once after every round: listen there for the round's estimate.
    round_estimates = []
    reweight = solver._reweight
    solver._reweight = lambda x: (round_estimates.append(x), reweight(x))[1]
    nearest = lows[0].repeat_interleave(scale, dim=-2).repeat_interleave(scale, dim=-1)
    before = degrade.launch_counts[name]
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    x = solver.solve(nearest)
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches = degrade.launch_counts[name] - before
    evaluations = sum(call[2] for call in solver.last_inner_calls)
    check(x.shape == gt.shape and bool(torch.isfinite(x).all()), f"{name}: bad output")
    expected = 0 if solver_class is PlainObjectiveSolver else evaluations
    check(launches == expected, f"{name}: {launches} kernel launches, expected {expected}")
    return {
        "x": x, "seconds": seconds, "launches": launches, "evaluations": evaluations,
        "iterations": solver.last_inner_iterations,
        "objectives": [_l1_objective(solver, e, lam) for e in [nearest] + (round_estimates or [x])],
        "psnr": float(psnr(x, gt)), "psnr_nearest": float(psnr(nearest, gt)),
        "inner_calls": solver.last_inner_calls,
    }


def compare_solves(side, options, device, dtype, seed=7):
    """The same TV solve through the kernels and through the plain version on
    the same device: (max|x difference|, relative difference of the final L1
    objectives, difference of the PSNRs in dB, iterations)."""
    gt = synthetic_scene(1, side, side, seed=seed)
    kernels, plain = [
        solve_once("data_term_tv", gt, 4, options, TotalVariationRegularizer(), 0.01, device, dtype, solver_class=cls)
        for cls in (sr.IRLSMapSolver, PlainObjectiveSolver)
    ]
    return (float((kernels["x"] - plain["x"]).abs().max()),
            abs(kernels["objectives"][-1] - plain["objectives"][-1]) / abs(plain["objectives"][-1]),
            abs(kernels["psnr"] - plain["psnr"]), kernels["iterations"])


def phase_main_path(device, rows):
    """The IRLS MAP solve at full width, once per fused objective mode."""
    side = 1000
    gt = synthetic_scene(1, side, side, seed=2026)
    dtype = torch.float32
    # The flagship runs a fixed 3 x 50 iterations; the others stop by the adaptive thresholds.
    runs = [
        ("data_term_tv", fixed_iterations(50, 3), TotalVariationRegularizer(), 0.01),
        ("data_term_btv", sr.IRLSMapSolverOptions(
            least_squares_solver="linear_cg", max_num_solver_iterations=20, max_num_irls_iterations=2),
         BilateralTotalVariationRegularizer(3, 0.5), 0.01),
        ("data_term", sr.IRLSMapSolverOptions(
            least_squares_solver="cg", max_num_solver_iterations=20), None, 0.0),
    ]
    # Warm the allocator and the library with a short solve that is not counted.
    solve_once("data_term_tv", gt, 4, fixed_iterations(2, 1), TotalVariationRegularizer(), 0.01, device, dtype)

    degrade.reset_launch_counts()
    results = {}
    for name, options, reg, lam in runs:
        results[name] = r = solve_once(name, gt, 4, options, reg, lam, device, dtype)
        mpix_it = r["iterations"] * side * side / r["seconds"] / 1e6
        log(f"[5/5] main path {name}: {side}x{side}, {r['iterations']} inner iterations, "
            f"{r['evaluations']} evaluations, {r['launches']} launches, {r['seconds']:.3f} s, "
            f"{mpix_it:.1f} Mpixel-iterations/s, PSNR {r['psnr']:.2f} dB (nearest {r['psnr_nearest']:.2f} dB)")
        log(f"      inner calls (s, iterations, evaluations): "
            f"{[(round(t, 4), i, e) for t, i, e in r['inner_calls']]}; "
            f"L1 objective at the start and after each round: {[float(f'{o:.7g}') for o in r['objectives']]}")
        for before, after in zip(r["objectives"], r["objectives"][1:]):
            check(after <= before * (1.0 + OBJECTIVE_RISE_TOLERANCE),
                  f"{name}: the L1 objective rose across a round, {before} -> {after}")
        check(r["psnr"] >= r["psnr_nearest"] + 1.0,
              f"{name}: PSNR {r['psnr']:.2f} dB does not beat nearest-neighbour {r['psnr_nearest']:.2f} dB by 1 dB")
    counts = dict(degrade.launch_counts)  # read right after the main path
    for row in rows:
        row["launches"] = counts[row["name"]]
        check(row["launches"] > 0, f"the main path never launched {row['name']}")

    # The same solve through the kernels and through the plain version, held
    # pixel by pixel: in float64 over one full-length round, in float32 over
    # 10 iterations only. The TV gradient jumps where a forward difference
    # changes sign, so rounding differences between ANY two implementations
    # (the plain version on two devices as well) grow with the iteration count.
    for dtype2, iterations, tol in ((torch.float32, 10, 1e-3), (torch.float64, 50, 1e-6)):
        diff, _, _, _ = compare_solves(248, fixed_iterations(iterations, 1), device, dtype2)
        log(f"      248x248 solve in {dtype2} ({iterations} iterations), kernels vs plain version on the "
            f"same device: max|diff| {diff:.2e} (tol {tol:g})")
        check(diff <= tol, f"kernel and plain solves differ by {diff} in {dtype2}")
    # The full-length solve, held by where it ends up (the L1 objective) and
    # how good that is (PSNR). Reweighting by 1 / max(1e-5, r) between rounds
    # magnifies the differences again, in float64 as much as in float32, so
    # the two runs end on different, equally good estimates: percent apart in
    # objective, hundredths of a dB in PSNR (scripts/profile_torch_port.py
    # --drift measures both pairs at every length).
    diff, objective_diff, psnr_diff, iterations = compare_solves(248, fixed_iterations(50, 3), device, torch.float32)
    log(f"      248x248 solve in torch.float32 ({iterations} iterations), kernels vs plain version: "
        f"max|diff| {diff:.2e}, final L1 objective differs {objective_diff:.2e} relative (tol 5e-2), "
        f"PSNR differs {psnr_diff:.4f} dB (tol 0.05)")
    check(objective_diff <= 5e-2 and psnr_diff <= 0.05,
          f"full-length kernel and plain solves end apart: objective {objective_diff}, PSNR {psnr_diff} dB")
    return results


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    try:
        card = phase_environment()
        phase_build()
        rows = phase_kernels(device)
        phase_goldens(device)
        phase_main_path(device, rows)
    except Failure as failure:
        print(f"chip_smoke: FAILED: {failure}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
