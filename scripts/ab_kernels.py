#!/usr/bin/env python3
"""Device time of one tree's kernels at the shapes of chip_smoke.py's rows, on one NVIDIA GPU.

    python3 scripts/ab_kernels.py [--root DIR] [--label NAME] [--out FILE] [--study]

Imports ``super_resolution_tpu_torch`` from ``DIR`` (default: this checkout;
its kernels are built first if they are not) and, float32, for every row of
chip_smoke.py's ``kernels`` line at the shape its path gives it (and K7a's
other half, the flagship TV tile), times one evaluation -- residual,
gradient and reduce launches -- back to back behind a spin kernel, and each
hand-written kernel alone from one ``torch.profiler`` window. Prints one JSON
line and appends it to ``FILE`` if given. To compare two trees, run them in
turns on the same card (A, B, B, A), one process each; chip_smoke.py's own
helpers (shapes, data, timing) are used for both.

``--study`` times each kernel instead over a grid of frame counts, modes,
band counts and scales around the rows' shapes (whole images, 3x3 blur,
fractional shifts), to split a kernel's time into what grows with the
frames and what does not.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=ROOT, help="checkout whose super_resolution_tpu_torch is timed")
    parser.add_argument("--label", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--study", action="store_true", help="time the kernels over frames, modes, bands and scales")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import super_resolution_tpu_torch
    from super_resolution_tpu_torch.ops.cuda import build, degrade

    if not os.path.abspath(super_resolution_tpu_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"ab_kernels: imported {super_resolution_tpu_torch.__file__}, not the package under {root}")
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device is available", file=sys.stderr)
        return 3
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # finds the package imported above

    device = torch.device("cuda", 0)
    built = build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    if args.study:
        return study(cs, degrade, device, card, args)
    k7a = next(row for row in cs.ROWS if row["name"] == "shard_mode")
    rows = [dict(row) for row in cs.ROWS] + [dict(k7a, row="K7a flagship TV tile", mode="data_term_tv",
                                                  flagship_tile=True)]
    out = []
    for row in rows:
        c, hw, scale, shifts, kernel, shard = cs.row_shape(row)
        x, y, sh, kern, constants = cs._kernel_problem(c, hw, scale, shifts, kernel, 200, device, torch.float32)
        sh_dev = torch.as_tensor(sh, dtype=torch.float64, device=device)
        kern_dev = torch.as_tensor(kern, dtype=torch.float32, device=device)
        kw = cs._mode_kwargs(row["mode"], constants)
        if shard is not None:
            kw.update(shard(x, y, constants))
        run = lambda: degrade.fused_objective(x, y, sh_dev, kern_dev, scale, **kw)
        ms = cs._time_launches(run, device, 200)
        per_kernel = {name: info["us"] for name, info in cs._kernel_times(run, device).items()}
        out.append({"row": row["row"], "mode": row["mode"], "ms": ms, "per_kernel_us": per_kernel,
                    "shape": f"C={c} HR={hw[0]}x{hw[1]} K={len(shifts)} s={scale}"})
        print(f"{args.label or root}: {row['row']:22s} {ms:.4f} ms  "
              + "  ".join(f"{name} {us:.2f} us" for name, us in per_kernel.items()), flush=True)
    report = {"label": args.label or root, "card": card, "build_seconds": built["degrade"]["seconds"], "rows": out}
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(report) + "\n")
    return 0


def study(cs, degrade, device, card, args):
    import numpy as np
    import torch

    gauss = cs.gaussian_kernel_2d(3, 1.5)
    rng = np.random.default_rng(11)
    out = []
    grid = [(64, (256, 256), 2, k, mode) for k in (1, 2, 4, 8) for mode in ("data_term", "data_term_tv", "data_term_tv3d")]
    grid += [(16, (256, 256), 2, 4, "data_term_tv"), (64, (256, 256), 4, 4, "data_term_tv"),
             (1, (1000, 1000), 4, 1, "data_term_tv"), (1, (1000, 1000), 4, 4, "data_term_tv"),
             (1, (1000, 1000), 4, 16, "data_term_tv"), (3, (1032, 1032), 4, 16, "data_term")]
    for c, hw, scale, frames, mode in grid:
        shifts = np.round(rng.uniform(-2.0, 2.0, size=(frames, 2)) * 8.0) / 8.0
        x, y, sh, kern, constants = cs._kernel_problem(c, hw, scale, shifts, gauss, 210, device, torch.float32)
        sh_dev = torch.as_tensor(sh, dtype=torch.float64, device=device)
        kern_dev = torch.as_tensor(kern, dtype=torch.float32, device=device)
        kw = cs._mode_kwargs(mode, constants)
        run = lambda: degrade.fused_objective(x, y, sh_dev, kern_dev, scale, **kw)
        per_kernel = {name: info["us"] for name, info in cs._kernel_times(run, device).items()}
        out.append({"C": c, "hw": hw, "s": scale, "K": frames, "mode": mode, "per_kernel_us": per_kernel})
        print(f"{args.label or 'study'}: C={c:3d} {hw[0]}x{hw[1]} s={scale} K={frames:2d} {mode:15s} "
              + "  ".join(f"{name} {us:.2f} us" for name, us in per_kernel.items()), flush=True)
    report = {"label": args.label, "card": card, "study": out}
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(report) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
