#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each kernel
against its plain PyTorch version on the card (the BTV gradient kernel over
every range, decay, scale and kind of array it is compiled for; the residual
and data / TV / 3D TV gradient kernels over scales, blurs, shifts, image
sizes, shard tiles and the spectral halo, on both sides of their composite
form's border band, and their DIRECT instantiations at s = 16 / 11 and with
a 33x33 blur; no local memory in any of the 208 instantiations), checks that
an evaluation is two launches whose cost, folded by the gradient launch's
last-starting block, is the same bits every time and equals the host's sum of the
partials, times each row and each kernel alone at the shape its path gives
it (and the DIRECT instantiations at full width), runs the C++ reference's
golden problems through the kernels, and drives the port's paths at full
width:

- the IRLS MAP solve at the flagship size (1x1000x1000 HR, 4 frames, 4x, 3x3
  blur), once per fused objective mode, and with a 33x33 blur beside the
  plain version;
- estimated motion: an RGB 3x1000x1000 scene, 4 frames at 4x with fractional
  shifts, registered by phase correlation, solved with BTV while the shifts
  are refined on the device between IRLS rounds, beside the unrefined and the
  known-motion solves;
- hyperspectral: a 64-band 256x256 cube solved in one objective with 2D and
  with 3D spectral TV, and a 64-band 512x512 cube solved in a 4-component
  PCA space and projected back;
- the solve on a device mesh, its shards dealt over the visible cards (all on
  the one card where there is one): 4 band shards with 3D spectral TV on the
  64-band cube (the kernels' spectral-halo mode), 2x2 tiles with halo
  exchange on an RGB 3x2048x2048 scene with 16 frames and on the flagship
  (shard mode), and 4 frame shards with the motion refined between IRLS
  rounds, each held against the single-device solve; then the same four
  meshes under ``fused_irls`` (one graph a step captures every shard),
  bit-equal to the same mesh's host loop, in turns;
- the fused IRLS solve (``fused_irls``: CUDA graphs of the linear-CG chunk,
  the IRLS seam and the restart) beside the host loop, in turns, on the
  flagship TV and BTV solves, the refined estimated-motion solve and the
  64-band 3D TV solve: the same estimate and shifts bit for bit, the same
  iterations and evaluations, the kernels' launches counted through the
  replays, no late cost fold, one capture across two solver instances, and
  no more read-backs than chunks plus rounds; wall and device time of each,
  and the chunk length;
- the inner solvers with a line search under the fused solve (``cg``, the
  reference's default, and ``lbfgs``: chunks of line-search trials replayed
  as CUDA graphs) beside the host loop, in turns, on the flagship TV and BTV
  solves and (``cg``) the refined estimated-motion solve, held as above and to
  PSNR >= nearest + 1 dB; their wall, device time, read-backs, evaluations
  per iteration, frozen evaluations, graph nodes per step and pinned memory,
  and how far fused ``cg``'s PSNR lies from fused ``linear_cg``'s. The
  goldens also run through the fused solve, and the gradient modes
  (``autodiff``, ``numerical``) on the card against the same solves on the CPU
  (``autodiff`` also through ``fused_irls``, bit-equal to the host loop;
  ``numerical`` held to a bound derived from the problem);
- the command-line entry points (phase 11), each step through ``main(argv)``
  on inputs written by the port's own PNG and ENVI writers: the flagship
  through ``super_resolve`` under ``--fused_irls`` and with the default
  ``cg`` host loop (each bit-equal to the same solve through
  ``IRLSMapSolver``, its TV evaluations counted), ADMM (360 data-term
  evaluations; float64 card against CPU), the RGB scene from a PNG directory
  (registered, refined, BTV on the luminance), the wavelet-domain solve
  (in float64 held element-wise against the same CLI run on the CPU), a
  64-band ENVI cube with 3D TV and in PCA space (native and numpy reads equal,
  and each timed), and ``generate_data``
  then ``shift_add_fusion`` (bit-equal to the CPU); each step's wall time;
- video (phase 12): 12 LR frames of 3x540x960, a seeded scene panned by a
  known fractional drift, written as PNG and loaded by ``VideoLoader``, then
  super-resolved to 3x1080x1920 per output frame by ``VideoSuperResolver``
  with its defaults (window 4, BTV(2, 0.7), 3 x 25 linear CG), host loop and
  ``fused_irls`` in turns: PSNR >= linear upsample + 1 dB on every frame,
  fused bit-equal to the host loop with the graphs captured for the first
  window only, a reduced window in float64 on the card against the CPU
  (with blur, and without blur under motion refinement), the MJPEG fixture
  decoded to the digest the CPU tests recorded; wall per frame, frames/s,
  device busy share from the trace ``utils.profiling.trace`` writes,
  registration per window (its read-backs counted), and one evaluation at
  the video shape beside its bound, each kernel beside its own;
- data parallel (phase 13): ``make_sharded_map_solver`` on a frame x4 mesh of
  the flagship and a frame x2 x band x2 mesh of the 64-band cube, each beside
  ``minimize`` on one device (float32 by iterations, cost and PSNR, float64
  element-wise); ``band_split_minimize`` on the 64-band cube, each band
  against its own serial solve, batched wall beside the serial one; the
  two-process loopback (``parallel/multihost.py``: two processes on the card,
  ``gloo`` between them, one shard each, each held against its own
  one-process solve; all-reduce bytes and ms an evaluation); and the scaling
  harness's collective calls an evaluation over 1 / 2 / 4 shards, flat.

Needs one CUDA device, ``nvcc`` and no network. Every phase that fails makes
the run exit non-zero; nothing falls back to the CPU.

Output: progress lines (ending in each kernel's time per launch beside its
own bound, with launches x gap over the paths), then one JSON line
``{"kernels": [...]}`` with each row's error against its plain version, its
time and its bound, then the
card's name and power limit as ``nvidia-smi`` gives them, and as the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import hashlib
import io
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import warnings
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

try:
    import numpy as np
    import torch

    import super_resolution_tpu_torch as sr
    from super_resolution_tpu_torch.evaluation import psnr
    from super_resolution_tpu_torch.models.image_model import degrade as degrade_op, degrade_adjoint
    from super_resolution_tpu_torch.motion import MotionShiftSequence
    from super_resolution_tpu_torch.motion.refinement import refine_shifts
    from super_resolution_tpu_torch.ops.blur import gaussian_kernel_2d
    from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
    from super_resolution_tpu_torch.ops.cuda import build, degrade
    from super_resolution_tpu_torch.ops.resize import linear_resize
    from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
    from super_resolution_tpu_torch.parallel import (
        Sharded, band_split_minimize, collectives, make_mesh, make_sharded_map_solver, make_sharded_vg, required_halo,
        shard_problem)
    from super_resolution_tpu_torch.solvers.least_squares import minimize
    from super_resolution_tpu_torch.solvers.objective import make_map_value_and_grad
    from super_resolution_tpu_torch.cli import generate_data as generate_data_cli
    from super_resolution_tpu_torch.cli import shift_add_fusion as shift_add_cli
    from super_resolution_tpu_torch.cli import super_resolve as super_resolve_cli
    from super_resolution_tpu_torch.image import ImageData
    from super_resolution_tpu_torch.solvers.admm import admm_solve
    from super_resolution_tpu_torch.spectral import envi
    from super_resolution_tpu_torch.utils.data_loader import load_image, save_image
    from super_resolution_tpu_torch.utils.image_io import read_image
    from super_resolution_tpu_torch import video as sr_video
    from super_resolution_tpu_torch.ops.warp import translate
    from super_resolution_tpu_torch.solvers import graphs
    from super_resolution_tpu_torch.utils.profiling import device_time, trace
    from super_resolution_tpu_torch.video.video_loader import read_avi_frames
except ImportError as exc:  # e.g. this file alone, without the package
    print(f"chip_smoke: cannot import the port: {exc}", file=sys.stderr)
    sys.exit(2)

# The hand-written kernels of csrc/degrade.cu, as the profiler names them.
HAND_KERNELS = ("sr_residual_kernel", "sr_gradient_kernel", "sr_btv_gradient_kernel")

# Published peaks of one H100 SXM (NVIDIA data sheet): the yardstick for `bound_ms`.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

# Tolerances, kernel vs plain version on the same device: the two differ in
# the order of their sums (and fused multiply-adds), nothing else.
TOLERANCE = {torch.float32: 1e-5, torch.float64: 1e-11}
# An IRLS round may not raise the L1 objective by more than float32 noise.
OBJECTIVE_RISE_TOLERANCE = 1e-5

PALLAS = "super_resolution_tpu/ops/pallas/degrade.py"
SOURCE = "super_resolution_tpu_torch/ops/cuda/csrc/degrade.cu"
FLAGSHIP_SHIFTS = [(0, 0), (1, 1), (0, 1), (1, 0)]
ESTIMATED_TRUE_SHIFTS = [(0, 0), (1.5, 0.5), (-0.75, 1.25), (0.5, -1.5)]
# Width of the band left out where a PCA-space solve is scored (see phase_hyperspectral).
PCA_BORDER = 16

# The rows of the `kernels` line: the modes of the TPU kernel (six on one
# device, two for a device mesh), each with the mode of the CUDA kernels that
# serves it and the shape its path gives it. "shift_generic" and "channel_grid" are not modes of the CUDA
# kernels but ways every launch works; their rows are timed and counted on the
# paths that need them (shifts that live and change on the device; 64 bands).
ROWS = [
    dict(row="K1", name="data_term", mode="data_term", replaces=f"{PALLAS}:1111", path="flagship"),
    dict(row="K2", name="data_term_tv", mode="data_term_tv", replaces=f"{PALLAS}:1256", path="flagship"),
    dict(row="K3", name="data_term_btv", mode="data_term_btv", replaces=f"{PALLAS}:1405", path="flagship"),
    dict(row="K4", name="shift_generic", mode="data_term_btv", replaces=f"{PALLAS}:806", path="estimated"),
    dict(row="K5", name="channel_grid", mode="data_term_tv", replaces=f"{PALLAS}:719", path="hyperspectral"),
    dict(row="K6", name="data_term_tv3d", mode="data_term_tv3d", replaces=f"{PALLAS}:1297", path="hyperspectral"),
    dict(row="K7a", name="shard_mode", mode="data_term_btv", replaces=f"{PALLAS}:663", path="mesh"),
    dict(row="K7b", name="spectral_halo", mode="data_term_tv3d", replaces=f"{PALLAS}:650", path="mesh"),
]
TILED_FRAMES = 16   # frames of the tiled RGB scene
# Frames of the BTV sweep's longest stack: more than the 32 whose bilinear
# taps a block of the BTV kernel stages at a time, so that it restages.
BTV_MANY_FRAMES = 35
# Whole images of the BTV sweep, by scale: no side a multiple of any block
# tile, the first of each smaller than the halo of range 8.
BTV_SWEEP_SHAPES = {2: [(6, 10), (50, 66)], 3: [(6, 9), (51, 69)], 4: [(8, 12), (52, 68)]}
# Shard tiles of the BTV sweep: (range, decay, scale, image, frames) cut 3x3.
BTV_SWEEP_TILES = [(1, 0.5, 3, (54, 72), 3), (2, 1.0, 2, (48, 66), 3), (3, 0.5, 4, (48, 72), 3),
                   (5, 1.0, 3, (54, 72), 3), (8, 0.5, 2, (48, 66), 3), (8, 1.0, 4, (48, 72), 3),
                   (3, 0.5, 2, (48, 66), BTV_MANY_FRAMES)]


class Failure(Exception):
    pass


def check(condition, message):
    if not condition:
        raise Failure(message)


def log(message):
    print(message, flush=True)


# --------------------------------------------------------------------------- data


@functools.lru_cache(maxsize=8)
def synthetic_scene(c, h, w, seed):
    """Edges and smooth texture in [0, 1], made with numpy from a seed (kept: callers only read it)."""
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
    log(f"[1/13] environment: python {sys.version.split()[0]}, torch {torch.__version__}, "
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
        log(f"[2/13] build: csrc/{name}.cu -> {os.path.relpath(info['path'], ROOT)} "
            f"({'built' if info['built'] else 'already built'}, {info['seconds']:.1f} s)")
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
    if name == "data_term_tv3d":
        return {"tv_constants": constants, "tv_use_3d": True}
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


def _bound(name, x, y, shifts, kernel, scale, dtype, extra_bytes=0):
    """Least time for one evaluation: each input read once, each output written
    once, and the operations the function needs (each regulariser residual
    counted once per pixel, whatever a kernel chooses to recompute). On a
    tile or a band shard the arrays are the extended ones, rim and halo band
    included; ``extra_bytes`` is the owned-pixel mask.

    Warp and blur are counted as their composite, exact away from the
    border: per frame a (kh + fy) x (kw + fx) kernel (fy, fx = 1 where that
    axis of the shift is fractional), one multiply-add per tap and LR value
    forward, and the same taps once more in the adjoint, whatever form a
    kernel computes them in (the border band, where the two-stage form is
    needed, is left out)."""
    itemsize = x.element_size()
    nbytes = (x.numel() + y.numel() + x.numel()) * itemsize + extra_bytes  # x, y, grad (+ mask)
    if name != "data_term":
        nbytes += x.numel() * itemsize                                 # constants
    nbytes += shifts.size * 8 + (0 if kernel is None else kernel.size * itemsize) + itemsize
    kh, kw = (1, 1) if kernel is None else kernel.shape
    composite = [(kh + int(dy != np.floor(dy))) * (kw + int(dx != np.floor(dx))) for dx, dy in shifts]
    lr = y.numel() // y.shape[0]
    flops = sum(lr * (2 * taps + 3) for taps in composite)     # forward, residual, r^2
    flops += sum(lr * 2 * taps for taps in composite) + x.numel()  # adjoint, 2 s^2 scaling
    if name == "data_term_tv":
        flops += x.numel() * 30
    elif name == "data_term_tv3d":
        flops += x.numel() * 40
    elif name == "data_term_btv":
        flops += x.numel() * (15 * 3 + 8 * 6 + 24)   # residual once, 8 overlap terms, own term
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations"), nbytes, flops


def _errors(out, ref):
    """(relative cost error, gradient error over the largest entry, max abs gradient error)."""
    (cost, grad), (ref_cost, ref_grad) = out, ref
    abs_err = float((grad - ref_grad).abs().max())
    return (abs(float(cost) - float(ref_cost)) / abs(float(ref_cost)),
            abs_err / float(ref_grad.abs().max()), abs_err)


@contextlib.contextmanager
def no_synchronisation(device):
    """PyTorch raises inside this block if a call of its own waits for the
    device or copies between device and host."""
    torch.cuda.synchronize(device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Synchronization debug mode")
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _float32_tap_difference(device):
    """The TPU kernel's shift-generic mode computes its bilinear tap weights
    in ``x.dtype``; the CUDA kernels compute them in float64 and round once.
    The float32 data-term gradient with weights made in float32 (the port's
    tensor-shift warp does that) against the kernels', over its largest entry."""
    shifts = [(0.3, -0.7), (1.1, 1.6), (-0.4, 1.2), (1.9, -0.2)]
    x, y, sh, kern, _ = _kernel_problem(3, (252, 332), 4, shifts, gaussian_kernel_2d(3, 1.5), 301, device,
                                        torch.float32)
    sh32 = torch.as_tensor(sh, dtype=torch.float32, device=device)
    grad32 = torch.zeros_like(x)
    for k in range(len(shifts)):
        residual = degrade_op(x, sh32[k, 0], sh32[k, 1], kern, 4) - y[k]
        grad32 += degrade_adjoint(residual, sh32[k, 0], sh32[k, 1], kern, 4)
    grad32 *= 2.0 * 16
    _, grad = degrade.fused_objective(x, y, sh32, kern, 4)
    return float((grad - grad32).abs().max() / grad32.abs().max())


def _check_shift_generic(device, dtype):
    """K4: the shifts live on the device and change between calls, one build.

    Three shift sets (fractional, negative, up to 9 HR px) go through the
    same loaded library as a CUDA tensor; each call must equal the call with
    the same values given from the host bit for bit, agree with the plain
    version, and neither copy to the host nor synchronise.
    """
    x, y, _, kern, constants = _kernel_problem(3, (252, 332), 4, [(0, 0)] * 4, gaussian_kernel_2d(3, 1.5), 300,
                                               device, dtype)
    kern_dev = torch.as_tensor(kern, dtype=dtype, device=device)
    sets = [
        [(0, 0), (1.5, 0.5), (-0.75, 1.25), (0.5, -1.5)],
        [(0.25, -0.125), (-8.5, 7.75), (3.0, -9.0), (-0.0078125, 0.9921875)],
        [(0, 0), (1.4375, 0.5625), (-0.8125, 1.3125), (0.46875, -1.53125)],
    ]
    tol = TOLERANCE[dtype]
    before = sum(degrade.launch_counts.values())
    degrade.shift_source_counts.update(device=0, host=0)
    for mode in ("data_term_btv", "data_term_tv3d"):
        kw = _mode_kwargs(mode, constants)
        for values in sets:
            host = np.asarray(values, dtype=np.float64)
            # As a refiner leaves them: in x's dtype on the device (these values are exact in float32).
            on_device = torch.as_tensor(host, dtype=dtype, device=device)
            with no_synchronisation(device):
                out = degrade.fused_objective(x, y, on_device, kern_dev, 4, **kw)
            from_host = degrade.fused_objective(x, y, host, kern_dev, 4, **kw)
            torch.cuda.synchronize(device)
            check(float(out[0]) == float(from_host[0]) and torch.equal(out[1], from_host[1]),
                  f"shift-generic {mode} {dtype}: device shifts and host shifts give different bits for {values}")
            cost_err, grad_err, _ = _errors(out, degrade.fused_objective_reference(x, y, host, kern, 4, **kw))
            check(cost_err <= tol and grad_err <= tol,
                  f"shift-generic {mode} {dtype} shifts {values}: cost {cost_err:.3e}, grad {grad_err:.3e} > {tol:g}")
    launches = sum(degrade.launch_counts.values()) - before
    check(degrade.shift_source_counts == {"device": launches // 2, "host": launches // 2},
          f"shift sources miscounted: {degrade.shift_source_counts} for {launches} launches")
    check(len(list(build.build_dir().glob("libdegrade_*.so"))) == 1, "the kernels were built more than once")
    log(f"[3/13] kernels: shift-generic: 3 shift sets x 2 modes as a CUDA tensor in {dtype}, no synchronisation, "
        f"bit-equal to host shifts, one build")


def _device_kernel_times(run, device, repeats=20):
    """Every device kernel ``run`` launches, by the profiler's name: its device
    microseconds per launch and its launches per call, from one short
    ``torch.profiler`` window; ``{}`` if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize(device)
    for _ in range(3):  # a window now and then comes back without device events: take another
        sums = {}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(repeats):
                run()
            torch.cuda.synchronize(device)
        for event in prof.key_averages():
            device_us = getattr(event, "device_time_total", None)
            if device_us is None:
                device_us = getattr(event, "cuda_time_total", 0.0)
            if device_us > 0:
                us, count = sums.get(event.key, (0.0, 0))
                sums[event.key] = (us + device_us, count + event.count)
        if sums:
            break
    return {name: {"us": us / count, "per_call": count / repeats} for name, (us, count) in sums.items()}


def _hand_kernel(name):
    """The hand-written kernel a profiler name is an instantiation of, else None."""
    return next((kernel for kernel in HAND_KERNELS if re.search(rf"(?<!\w){kernel}<", name)), None)


def _kernel_times(run, device, repeats=20):
    """:func:`_device_kernel_times` of the hand-written kernels, by kernel."""
    sums = {}
    for name, info in _device_kernel_times(run, device, repeats).items():
        kernel = _hand_kernel(name)
        if kernel is not None:
            us, per_call = sums.get(kernel, (0.0, 0.0))
            sums[kernel] = (us + info["us"] * info["per_call"], per_call + info["per_call"])
    return {kernel: {"us": us / per_call, "per_call": per_call} for kernel, (us, per_call) in sums.items()}


def _fold_on_host(partials, n_data, scale, dtype):
    """The cost from the partials in the order the gradient launch's folding
    block sums them (``fold_cost`` in csrc/degrade.cu): 1024 slots, slot t
    the sum of partials t, t + 1024, ... in index order (data and
    regulariser apart), a tree over the slots, then fma(s^2, data,
    regulariser) rounded to the type."""
    from fractions import Fraction

    values = partials.double().cpu().numpy()

    def folded(part):
        slots = np.zeros(1024)
        for t in range(1024):
            total = 0.0
            for value in part[t::1024]:
                total += float(value)
            slots[t] = total
        stride = 512
        while stride:
            slots[:stride] = slots[:stride] + slots[stride:2 * stride]
            stride //= 2
        return float(slots[0])

    data, reg = folded(values[:n_data]), folded(values[n_data:])
    exact = Fraction(float(scale * scale)) * Fraction(data) + Fraction(reg)
    return float(np.float32(float(exact))) if dtype == torch.float32 else float(exact)


def _check_fold(row_name, run, args, kw, dtype, device):
    """One evaluation is two launches and no reduction kernel; its cost is the
    same bits when launched again and equals the host's sum of its partials
    in the documented order; every block of the gradient launch took one
    ticket (the data mode's blocks write no partial to count them by), and
    the fold did not stop waiting. Returns the partials' count, their own
    bound and the time of one ``torch.dot`` of partials and weights (s^2 on
    the data partials, 1 on the rest), the one library call that computes
    the same sum."""
    # The profiler now and then drops a record: each kernel at most once per call, both seen, nothing else.
    launched = {name: info["per_call"] for name, info in _device_kernel_times(run, device, 5).items()}
    kinds = [_hand_kernel(name) or name for name in launched]
    check(len(kinds) == 2 and "sr_residual_kernel" in kinds and any(k in kinds for k in HAND_KERNELS[1:])
          and all(per_call <= 1.0 for per_call in launched.values()),
          f"{row_name}: an evaluation launched {launched}, not the residual and the gradient kernel alone")
    x, y, shifts, kernel, scale = args
    cost, _, partials, fold = degrade._evaluate(x, y, shifts, kernel, scale, **kw)
    again, _, partials_again, _ = degrade._evaluate(x, y, shifts, kernel, scale, **kw)
    c, h, w = x.shape
    n_data = degrade._library().sr_residual_blocks(c, h, w, scale)
    host = _fold_on_host(partials, n_data, scale, dtype)
    tickets, late = (int(v) for v in fold.view(torch.int32).cpu())
    check(float(cost) == float(again) and torch.equal(partials, partials_again),
          f"{row_name}: two launches gave different costs or partials")
    check(float(cost) == host, f"{row_name}: the folded cost {float(cost)!r} != the host's sum {host!r}")
    n_reg = partials.numel() - n_data
    check(late == 0 and (tickets == n_reg if n_reg else tickets > 0),
          f"{row_name}: the fold's state says {tickets} tickets for {n_reg} regulariser partials, late {late}")
    weights = torch.ones_like(partials)
    weights[:n_data] = float(scale ** 2)
    dot_ms = _time_launches(lambda: torch.dot(partials, weights), device, 200)
    return {"partials": partials.numel(), "kernels_per_evaluation": launched,
            "bound_us": 8 * partials.numel() / PEAK_BYTES_PER_S * 1e6, "torch_dot_ms": dot_ms}


def _kernel_bounds_us(x, y, constants, mode, partials, extra_bytes=0):
    """Each kernel's own byte bound in microseconds: the residual kernel reads
    x and y and writes r; the gradient kernels read x, r (and the constants),
    write the gradient and, folding the cost, read the partials."""
    x_bytes, y_bytes = x.numel() * x.element_size(), y.numel() * y.element_size()
    gradient = 2 * x_bytes + y_bytes + (0 if mode == "data_term" else x_bytes) + 8 * partials
    us = lambda nbytes: nbytes / PEAK_BYTES_PER_S * 1e6
    return {"sr_residual_kernel": us(x_bytes + 2 * y_bytes + extra_bytes),
            "sr_btv_gradient_kernel" if mode == "data_term_btv" else "sr_gradient_kernel": us(gradient)}


def _time_row(row, c, hw, scale, shifts, kernel, device, flush, shifts_on_device=True, shard=None):
    """Times of one row at the shape its path gives it, float32: the kernels
    (warm and cold L2, and each kernel alone from the profiler beside its own
    bound), the plain version, the bound, and the error against the plain
    version at that shape. ``shard(x, y, constants) -> kwargs`` prepares the
    arrays as a mesh path does (zero rims, a zero halo band) and gives the
    shard arguments of the launch."""
    dtype = torch.float32
    x, y, sh, kern, constants = _kernel_problem(c, hw, scale, shifts, kernel, 200, device, dtype)
    sh_dev = torch.as_tensor(sh, dtype=torch.float64, device=device) if shifts_on_device else sh
    kern_dev = torch.as_tensor(kern, dtype=dtype, device=device)
    kw = _mode_kwargs(row["mode"], constants)
    extra_bytes = 0
    if shard is not None:
        kw.update(shard(x, y, constants))
        mask = kw.get("data_mask_lr")
        extra_bytes = 0 if mask is None else mask.numel() * mask.element_size()
    run = lambda: degrade.fused_objective(x, y, sh_dev, kern_dev, scale, **kw)
    plain = lambda: degrade.fused_objective_reference(x, y, sh, kern, scale, **kw)
    cost_err, grad_err, abs_err = _errors(run(), plain())
    check(cost_err <= TOLERANCE[dtype] and grad_err <= TOLERANCE[dtype],
          f"{row['name']} at its path's shape: cost {cost_err:.3e}, grad {grad_err:.3e}")
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
    bound_ms, bound_by, nbytes, flops = _bound(row["mode"], x, y, sh, kern, scale, dtype, extra_bytes)
    per_kernel = _kernel_times(run, device)
    c_, h_, w_ = x.shape
    lib = degrade._library()
    partials = lib.sr_residual_blocks(c_, h_, w_, scale) + lib.sr_gradient_blocks(
        degrade._MODE_OF[row["mode"]], c_, h_, w_, 0)
    bounds = _kernel_bounds_us(x, y, constants, row["mode"], partials, extra_bytes)
    for name, info in per_kernel.items():
        info["bound_us"] = bounds[name]
    fold = _check_fold(row["name"], run, (x, y, sh_dev, kern_dev, scale), kw, dtype, device)
    row.update({
        "route": "cuda", "source": SOURCE, "launches": 0,
        "max_abs_err": max(row.get("max_abs_err", 0.0), abs_err), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "ms_cold_l2": sorted(cold)[len(cold) // 2], "bytes": nbytes, "operations": flops,
        "shape": f"C={c} HR={hw[0]}x{hw[1]} K={len(shifts)} s={scale} float32", "per_kernel": per_kernel,
        "fold": fold,
    })
    log(f"      {row['row']} {row['name']} ({row['shape']}): {ms:.4f} ms/launch (cold L2 {row['ms_cold_l2']:.4f}), "
        f"plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms by {bound_by}; per kernel (us per launch / own bound): "
        + (", ".join(f"{name} {info['us']:.2f} / {info['bound_us']:.2f}" for name, info in per_kernel.items())
           or "the profiler saw no device time")
        + f"; 2 launches per evaluation, cost folded from {fold['partials']} partials bit-equal to the host's sum "
          f"(own bound {fold['bound_us']:.4f} us; torch.dot {fold['torch_dot_ms'] * 1e3:.2f} us)")
    return x, y, sh, kern, constants


def _halo_width(shifts, kernel, scale, reg_reach):
    """The tiled objective's halo for these shifts (see parallel/halo.py)."""
    reach = required_halo(float(np.abs(np.asarray(shifts, dtype=np.float64)).max()), 0 if kernel is None else kernel.shape[0])
    return -(-max(reach, reg_reach, scale) // scale) * scale


def _check_shard_mode(device, dtype):
    """K7a: the kernels in shard mode against the plain version, on extended
    tiles made as the tiled path makes them (rims gathered from the
    neighbours, zero beyond the image): the four corners and the centre of a
    3x3 tiling, tiles that are not square, integer, negative and fractional
    shifts, s = 2 and 4, no regulariser / TV / BTV(3, 0.5), with the
    owned-pixel mask and with the default mask. Constants are non-zero on
    the rim too, which the path never gives: the harder case."""
    tol = TOLERANCE[dtype]
    mesh = make_mesh({"row": 3, "col": 3}, devices=[device])
    worst, launches = 0.0, 0
    for scale, hw in ((2, (144, 180)), (4, (144, 192))):
        th, tw = hw[0] // 3, hw[1] // 3
        for n, shifts in enumerate(([(0, 0), (1, -2), (-3, 2)], [(0.5, -1.25), (-2.75, 0.3), (1.6, 2.2)])):
            x, y, sh, kern, _ = _kernel_problem(2, hw, scale, shifts, gaussian_kernel_2d(3, 1.0), 400 + n, device, dtype)
            q = _halo_width(sh, kern, scale, 3)
            ql = q // scale
            tiles = collectives.halo_gather(mesh, Sharded.from_global(mesh, x, {"row": 1, "col": 2}).parts, q)
            lows = Sharded.from_global(mesh, y, {"row": 2, "col": 3}).parts
            owned = torch.zeros((th + 2 * q) // scale, (tw + 2 * q) // scale, dtype=dtype, device=device)
            owned[ql: ql + th // scale, ql: ql + tw // scale] = 1.0
            rng = np.random.default_rng(410 + n)
            for shard in (0, 2, 4, 6, 8):
                coords = mesh.coords(shard)
                xt = tiles[shard].contiguous()
                yt = torch.nn.functional.pad(lows[shard], (ql, ql, ql, ql)).contiguous()
                constants = torch.as_tensor(rng.random(tuple(xt.shape)) * 0.02, dtype=dtype, device=device)
                where = dict(origin=(coords["row"] * th - q, coords["col"] * tw - q), global_hw=hw)
                for mode in ("data_term", "data_term_tv", "data_term_btv"):
                    for mask in (owned, None):
                        kw = dict(_mode_kwargs(mode, constants), data_mask_lr=mask, **where)
                        out = degrade.fused_objective(xt, yt, sh, kern, scale, **kw)
                        cost_err, grad_err, abs_err = _errors(
                            out, degrade.fused_objective_reference(xt, yt, sh, kern, scale, **kw))
                        launches += 1
                        worst = max(worst, abs_err)
                        check(cost_err <= (1e-6 if dtype == torch.float32 else tol) and grad_err <= tol,
                              f"shard mode {mode} {dtype} s={scale} shifts {shifts} tile {coords} "
                              f"{'owned mask' if mask is not None else 'default mask'}: cost {cost_err:.3e}, "
                              f"grad {grad_err:.3e} > {tol:g}")
    log(f"[3/13] kernels: shard mode: {launches} launches (5 tiles of a 3x3 tiling x 2 scales x 2 shift sets x 3 modes "
        f"x 2 masks) agree with the plain version in {dtype} (tol {tol:g})")
    return worst


def _check_spectral_halo(device, dtype):
    """K7b: the last channel as a read-only band, C = 2 and 17, against the plain version."""
    tol = TOLERANCE[dtype]
    worst = 0.0
    for c in (2, 17):
        x, y, sh, kern, constants = _kernel_problem(c, (66, 90), 2, [(0, 0), (1.25, -0.5), (-2.0, 3.0)],
                                                    gaussian_kernel_2d(3, 1.0), 420 + c, device, dtype)
        constants[-1] = 0.0
        y[:, -1] = 0.0
        kw = dict(tv_constants=constants, tv_use_3d=True, spectral_halo=True)
        out = degrade.fused_objective(x, y, sh, kern, 2, **kw)
        cost_err, grad_err, abs_err = _errors(out, degrade.fused_objective_reference(x, y, sh, kern, 2, **kw))
        worst = max(worst, abs_err)
        check(cost_err <= tol and grad_err <= tol,
              f"spectral halo {dtype} C={c}: cost {cost_err:.3e}, grad {grad_err:.3e} > {tol:g}")
        plain_tv3d = degrade.fused_objective(x, y, sh, kern, 2, tv_constants=constants, tv_use_3d=True)
        check(not torch.equal(out[1][-1], plain_tv3d[1][-1]), "the halo band was not taken out of the data term")
    log(f"[3/13] kernels: spectral halo: C = 2 and 17 agree with the plain version in {dtype} (tol {tol:g})")
    return worst


def _check_trivial_shard_arguments(device, dtype):
    """origin (0, 0), the image's own extent and no mask: today's launch, bit for bit."""
    hw = (132, 76)
    x, y, sh, kern, constants = _kernel_problem(3, hw, 4, [(0, 0), (1.25, -0.5), (-2.0, 3.0)],
                                                gaussian_kernel_2d(3, 1.5), 430, device, dtype)
    for mode in degrade.KERNEL_NAMES:
        kw = _mode_kwargs(mode, constants)
        plain_launch = degrade.fused_objective(x, y, sh, kern, 4, **kw)
        in_shard_mode = degrade.fused_objective(x, y, sh, kern, 4, origin=(0, 0), global_hw=hw, **kw)
        check(float(plain_launch[0]) == float(in_shard_mode[0]) and torch.equal(plain_launch[1], in_shard_mode[1]),
              f"{mode} {dtype}: trivial shard arguments change the bits")
    log(f"[3/13] kernels: origin (0, 0), global extent = the image, no mask: bit-equal to the plain launch, "
        f"{len(degrade.KERNEL_NAMES)} modes in {dtype}")


def _check_assembled(device, dtype):
    """Tiles and band shards put together by gather / scatter-sum / band ring
    against the unsharded kernels on the whole image."""
    tol = TOLERANCE[dtype]
    cases = [
        ({"row": 2, "col": 3}, 2, (96, 180), 2, ()),
        ({"row": 2, "col": 3}, 2, (96, 180), 2, ((TotalVariationRegularizer(), 0.02),)),
        ({"row": 2, "col": 3}, 2, (96, 192), 4, ((BilateralTotalVariationRegularizer(3, 0.5), 0.02),)),
        ({"band": 4}, 8, (66, 90), 2, ((TotalVariationRegularizer(True), 0.02),)),
        ({"band": 2}, 2, (66, 90), 2, ((TotalVariationRegularizer(True), 0.02),)),
    ]
    shifts = [(0.5, -1.25), (-2.75, 0.3), (1.6, 2.2), (0, 0)]
    for n, (axes, c, hw, scale, regs) in enumerate(cases):
        x, y, sh, kern, weights = _kernel_problem(c, hw, scale, shifts, gaussian_kernel_2d(3, 1.0), 440 + n, device, dtype)
        vg = make_sharded_vg(make_mesh(axes, devices=[device]), y, sh, kern, scale, regs, dtype=dtype)
        kw = {}
        if regs:
            reg, lam = regs[0]
            if isinstance(reg, TotalVariationRegularizer):
                kw = dict(tv_constants=(lam * weights).contiguous(), tv_use_3d=reg.use_3d)
            else:
                kw = dict(btv_constants=(lam * weights).contiguous(), btv_range=3, btv_decay=0.5)
        cost_err, grad_err, _ = _errors(vg(x, (weights,)), degrade.fused_objective(x, y, sh, kern, scale, **kw))
        check(cost_err <= tol and grad_err <= tol,
              f"assembled {axes} {dtype} case {n}: cost {cost_err:.3e}, grad {grad_err:.3e} > {tol:g}")
    log(f"[3/13] kernels: {len(cases)} meshes (2x3 tiles: none / TV / BTV; 4 and 2 band shards with 3D TV) assembled "
        f"by gather, scatter-sum and band ring == the unsharded kernels in {dtype} (tol {tol:g})")


def _check_btv_sweep(device, dtype):
    """The BTV gradient kernel over what it is compiled for, against the
    plain version: P in {1, 2, 3, 5, 8}, decay 0.5 and 1.0, s = 2, 4 and 3
    (the instantiation that takes s at run time), whole images whose sides
    are no multiple of any block tile, one smaller than the P = 8 halo, each
    launched twice for the same bits; then shard tiles (the corners and the
    centre of a 3x3 tiling, owned and default mask, constants non-zero on the
    rim); and a stack of BTV_MANY_FRAMES frames, on a whole image and on
    tiles."""
    tol = TOLERANCE[dtype]
    few = [(0, 0), (1.25, -0.5), (-2.0, 3.0)]
    many = np.round(np.random.default_rng(620).uniform(-3.0, 3.0, size=(BTV_MANY_FRAMES, 2)) * 4.0) / 4.0
    many[0] = 0.0
    shifts_of = {3: few, BTV_MANY_FRAMES: [(float(dx), float(dy)) for dx, dy in many]}
    kern = gaussian_kernel_2d(3, 1.0)
    worst, launches = 0.0, 0

    def held(out, args, kw, what):
        nonlocal worst, launches
        cost_err, grad_err, abs_err = _errors(out, degrade.fused_objective_reference(*args, **kw))
        launches += 1
        worst = max(worst, abs_err)
        check(cost_err <= tol and grad_err <= tol,
              f"BTV sweep {dtype} {what}: cost {cost_err:.3e}, grad {grad_err:.3e} > {tol:g}")

    for P in (1, 2, 3, 5, 8):
        for decay in (0.5, 1.0):
            for scale, shapes in BTV_SWEEP_SHAPES.items():
                for n, hw in enumerate(shapes):
                    x, y, sh, _, constants = _kernel_problem(2, hw, scale, few, kern, 500 + 10 * P + n, device, dtype)
                    kw = dict(btv_constants=constants, btv_range=P, btv_decay=decay)
                    args = (x, y, sh, kern, scale)
                    out = degrade.fused_objective(*args, **kw)
                    again = degrade.fused_objective(*args, **kw)
                    check(float(out[0]) == float(again[0]) and torch.equal(out[1], again[1]),
                          f"BTV sweep {dtype} P={P} s={scale} {hw}: two launches gave different bits")
                    held(out, args, kw, f"P={P} decay={decay} s={scale} whole {hw}")
    for scale, hw in ((2, (50, 66)), (3, (51, 69))):
        x, y, sh, _, constants = _kernel_problem(2, hw, scale, shifts_of[BTV_MANY_FRAMES], kern, 640 + scale, device,
                                                 dtype)
        kw = dict(btv_constants=constants, btv_range=3, btv_decay=0.5)
        held(degrade.fused_objective(x, y, sh, kern, scale, **kw), (x, y, sh, kern, scale), kw,
             f"{BTV_MANY_FRAMES} frames, s={scale}, whole {hw}")
    for P, decay, scale, hw, frames in BTV_SWEEP_TILES:
        mesh = make_mesh({"row": 3, "col": 3}, devices=[device])
        th, tw = hw[0] // 3, hw[1] // 3
        x, y, sh, _, _ = _kernel_problem(2, hw, scale, shifts_of[frames], kern, 600 + P + 100 * (frames > 3), device, dtype)
        q = _halo_width(sh, kern, scale, P)
        ql = q // scale
        tiles = collectives.halo_gather(mesh, Sharded.from_global(mesh, x, {"row": 1, "col": 2}).parts, q)
        lows = Sharded.from_global(mesh, y, {"row": 2, "col": 3}).parts
        owned = torch.zeros((th + 2 * q) // scale, (tw + 2 * q) // scale, dtype=dtype, device=device)
        owned[ql: ql + th // scale, ql: ql + tw // scale] = 1.0
        rng = np.random.default_rng(610 + P)
        for shard in (0, 2, 4, 6, 8):
            coords = mesh.coords(shard)
            xt = tiles[shard].contiguous()
            yt = torch.nn.functional.pad(lows[shard], (ql, ql, ql, ql)).contiguous()
            constants = torch.as_tensor(rng.random(tuple(xt.shape)) * 0.02, dtype=dtype, device=device)
            args = (xt, yt, sh, kern, scale)
            for mask in (owned, None):
                kw = dict(btv_constants=constants, btv_range=P, btv_decay=decay, data_mask_lr=mask,
                          origin=(coords["row"] * th - q, coords["col"] * tw - q), global_hw=hw)
                held(degrade.fused_objective(*args, **kw), args, kw,
                     f"P={P} decay={decay} s={scale} {frames} frames tile {coords} "
                     f"{'owned' if mask is not None else 'default'} mask")
    log(f"[3/13] kernels: BTV sweep: {launches} launches (P 1/2/3/5/8 x decay 0.5/1.0 x s 2/3/4 on 2 whole images "
        f"each, bit-equal when launched twice; {BTV_MANY_FRAMES} frames on 2 whole images; "
        f"{len(BTV_SWEEP_TILES)} x 5 shard tiles x 2 masks, one with {BTV_MANY_FRAMES} frames) agree with the "
        f"plain version in {dtype} (tol {tol:g})")
    return worst


def _check_kernel_attributes():
    """What the compiler gave every instantiation of the three compute kernels
    (cudaFuncGetAttributes): none may use local memory. The residual and
    gradient kernels: float32 / float64 x s 2 / 4 / other x a 3x3 / any other
    blur x whole image / tile (x data / TV / 3D TV for the gradient), and
    their DIRECT instantiations, float32 / float64 x whole image / tile; the
    BTV kernel: float32 / float64 x P 1-8 x s 2 / 4 / other x whole / tile:
    208 in all."""
    table = {}
    for dtype in (torch.float32, torch.float64):
        for shard in (False, True):
            table["sr_residual_kernel", dtype, "direct", shard] = degrade.kernel_attributes(
                "sr_residual_kernel", 0, shard, dtype, direct=True)
            for mode in ("data_term", "data_term_tv", "data_term_tv3d"):
                table["sr_gradient_kernel", mode, dtype, "direct", shard] = degrade.kernel_attributes(
                    "sr_gradient_kernel", 0, shard, dtype, mode=mode, direct=True)
        for scale in (2, 4, 3):
            for shard in (False, True):
                for blur in (3, 5):
                    table["sr_residual_kernel", dtype, scale, blur, shard] = degrade.kernel_attributes(
                        "sr_residual_kernel", scale, shard, dtype, blur_size=blur)
                    for mode in ("data_term", "data_term_tv", "data_term_tv3d"):
                        table["sr_gradient_kernel", mode, dtype, scale, blur, shard] = degrade.kernel_attributes(
                            "sr_gradient_kernel", scale, shard, dtype, mode=mode, blur_size=blur)
                for P in range(1, degrade.max_btv_range() + 1):
                    table["sr_btv_gradient_kernel", dtype, P, scale, shard] = degrade.kernel_attributes(
                        "sr_btv_gradient_kernel", scale, shard, dtype, btv_range=P)
    check(len(table) == 208, f"{len(table)} instantiations, expected 208")
    for key, attributes in table.items():
        check(attributes["local_bytes"] == 0, f"{key} uses local memory: {attributes}")
    for kernel in degrade.COMPUTE_KERNELS:
        mine = [a for key, a in table.items() if key[0] == kernel]
        registers, shared = [a["registers"] for a in mine], [a["shared_bytes"] for a in mine]
        blocks = [a["blocks_per_sm"] for a in mine]
        log(f"[3/13] kernels: {kernel}, {len(mine)} instantiations: 0 bytes of local memory in each; "
            f"{min(registers)}-{max(registers)} registers, {min(shared)}-{max(shared)} bytes of static shared memory, "
            f"{min(blocks)}-{max(blocks)} blocks of 256 threads per SM")
    direct = [a for key, a in table.items() if "direct" in key]
    log(f"[3/13] kernels: of those, the {len(direct)} DIRECT instantiations: "
        f"{min(a['registers'] for a in direct)}-{max(a['registers'] for a in direct)} registers, "
        f"{min(a['blocks_per_sm'] for a in direct)}-{max(a['blocks_per_sm'] for a in direct)} blocks per SM")
    return table


def _row_attributes(row, table):
    """The instantiations that serve a timed row (float32, a 3x3 blur, the row's s, P = 3 for BTV)."""
    scale = 2 if row["path"] in ("hyperspectral",) or row["name"] == "spectral_halo" else 4
    shard = row["name"] == "shard_mode"
    out = {"sr_residual_kernel": table["sr_residual_kernel", torch.float32, scale, 3, shard]}
    if row["mode"] == "data_term_btv":
        out["sr_btv_gradient_kernel"] = table["sr_btv_gradient_kernel", torch.float32, 3, scale, shard]
    else:
        out["sr_gradient_kernel"] = table["sr_gradient_kernel", row["mode"], torch.float32, scale, 3, shard]
    return {name: {key: a[key] for key in ("registers", "shared_bytes", "local_bytes", "blocks_per_sm")}
            for name, a in out.items()}


def _check_composite_sweep(device, dtype):
    """The residual and the data / TV / 3D TV gradient kernels over what they
    are compiled for, against the plain version: s = 2, 4 and 3 (the
    instantiation that takes s at run time); no blur, 1x1, 3x3 (its own
    instantiation), an even 4x4 (anchored at size/2) and 5x5; integer,
    fractional and negative shifts and shifts of up to 9 HR px spread so far
    that the residual kernel stages each frame's footprint in turn, all as a
    CUDA tensor; whole images that are no multiple of any block tile, the
    first smaller than the reach, the second with interior blocks, each
    launched twice for the same bits; a frame count past the frames a block
    holds tables for at once (66 at 3x3, 30 at 5x5); shard tiles with the
    owned-pixel mask and the default one, blur 3x3 / 5x5 / none, fractional
    and +-9 px shifts; the spectral halo. Where ``composite_is_exact`` says
    the composite form is exact on a whole image and where it says a border
    band needs the two-stage form are both counted. Scales and blurs past
    the residual kernel's staging and the composite table: see
    :func:`_check_direct_sweep`."""
    tol = TOLERANCE[dtype]
    rng = np.random.default_rng(700)
    even = rng.random((4, 4))
    blurs = {"none": None, "1x1": np.ones((1, 1)), "3x3": gaussian_kernel_2d(3, 1.0), "4x4": even / even.sum(),
             "5x5": gaussian_kernel_2d(5, 1.5)}
    shift_sets = {
        "integer": [(0, 0), (1, 1), (0, -1), (-2, 1)],
        "fractional": [(0, 0), (1.25, -0.5), (-2.0, 3.0), (-0.75, -1.375)],
        "wide": [(0, 0), (9.0, 9.0), (-9.0, -8.5), (4.5, -8.25)],
    }
    shapes = {2: [(6, 10), (70, 98)], 3: [(6, 9), (69, 99)], 4: [(8, 12), (72, 100)]}
    modes = ("data_term", "data_term_tv", "data_term_tv3d")
    worst, launches, exact = 0.0, 0, {True: 0, False: 0}

    def held(args, kw, what, twice=False):
        nonlocal worst, launches
        out = degrade.fused_objective(*args, **kw)
        if twice:
            again = degrade.fused_objective(*args, **kw)
            check(float(out[0]) == float(again[0]) and torch.equal(out[1], again[1]),
                  f"composite sweep {dtype} {what}: two launches gave different bits")
        host = tuple(a.cpu().numpy() if i == 2 else a for i, a in enumerate(args))
        cost_err, grad_err, abs_err = _errors(out, degrade.fused_objective_reference(*host, **kw))
        launches += 1
        worst = max(worst, abs_err)
        check(cost_err <= tol and grad_err <= tol,
              f"composite sweep {dtype} {what}: cost {cost_err:.3e}, grad {grad_err:.3e} > {tol:g}")

    for scale, hws in shapes.items():
        for blur_name, kern in blurs.items():
            for set_name, shifts in shift_sets.items():
                for n, hw in enumerate(hws):
                    x, y, sh, _, constants = _kernel_problem(2, hw, scale, shifts, kern, 710 + n, device, dtype)
                    exact[degrade.composite_is_exact(sh, kern, scale, hw)] += 1
                    sh_dev = torch.as_tensor(sh, device=device)
                    for mode in modes:
                        held((x, y, sh_dev, kern, scale), _mode_kwargs(mode, constants),
                             f"{mode} s={scale} blur {blur_name} {set_name} shifts whole {hw}", twice=True)
    for blur_name, frames in (("3x3", 66), ("5x5", 30)):
        shifts = np.round(np.random.default_rng(frames).uniform(-3.0, 3.0, size=(frames, 2)) * 4.0) / 4.0
        x, y, sh, kern, constants = _kernel_problem(2, (36, 44), 2, shifts, blurs[blur_name], 720, device, dtype)
        for mode in modes:
            held((x, y, torch.as_tensor(sh, device=device), kern, 2), _mode_kwargs(mode, constants),
                 f"{mode} {frames} frames blur {blur_name}")
    tile_cases = [(blur_name, set_name) for blur_name in ("3x3", "5x5", "none") for set_name in ("fractional", "wide")]
    for scale, hw in ((2, (48, 66)), (3, (54, 72)), (4, (48, 72))):
        mesh = make_mesh({"row": 3, "col": 3}, devices=[device])
        th, tw = hw[0] // 3, hw[1] // 3
        for blur_name, set_name in tile_cases:
            x, y, sh, kern, _ = _kernel_problem(2, hw, scale, shift_sets[set_name], blurs[blur_name], 730 + scale,
                                                device, dtype)
            q = _halo_width(sh, kern, scale, 2)
            ql = q // scale
            tiles = collectives.halo_gather(mesh, Sharded.from_global(mesh, x, {"row": 1, "col": 2}).parts, q)
            lows = Sharded.from_global(mesh, y, {"row": 2, "col": 3}).parts
            owned = torch.zeros((th + 2 * q) // scale, (tw + 2 * q) // scale, dtype=dtype, device=device)
            owned[ql: ql + th // scale, ql: ql + tw // scale] = 1.0
            for shard in (0, 2, 4, 6, 8):
                coords = mesh.coords(shard)
                xt = tiles[shard].contiguous()
                yt = torch.nn.functional.pad(lows[shard], (ql, ql, ql, ql)).contiguous()
                constants = torch.as_tensor(rng.random(tuple(xt.shape)) * 0.02, dtype=dtype, device=device)
                for mask in (owned, None):
                    for mode in modes:
                        kw = dict(_mode_kwargs(mode, constants), data_mask_lr=mask,
                                  origin=(coords["row"] * th - q, coords["col"] * tw - q), global_hw=hw)
                        held((xt, yt, torch.as_tensor(sh, device=device), kern, scale), kw,
                             f"{mode} s={scale} blur {blur_name} {set_name} shifts tile {coords} "
                             f"{'owned' if mask is not None else 'default'} mask")
    for scale, hw in ((2, (66, 90)), (3, (66, 90)), (4, (64, 88))):
        x, y, sh, kern, constants = _kernel_problem(5, hw, scale, shift_sets["fractional"], blurs["3x3"], 740, device,
                                                    dtype)
        constants[-1] = 0.0
        y[:, -1] = 0.0
        held((x, y, torch.as_tensor(sh, device=device), kern, scale),
             dict(tv_constants=constants, tv_use_3d=True, spectral_halo=True), f"spectral halo s={scale}")
    check(exact[True] > 0 and exact[False] > 0, f"the sweep missed one of the composite's cases: {exact}")
    log(f"[3/13] kernels: composite sweep: {launches} launches (s 2/3/4 x blur none/1x1/3x3/4x4/5x5 x integer / "
        f"fractional / wide shifts x 2 whole images x data/TV/3D TV, bit-equal when launched twice; 66 and 30 frames; "
        f"3 scales x 5 shard tiles x blur 3x3/5x5/none x fractional / wide shifts x 2 masks x 3 modes; spectral halo "
        f"at s 2/3/4) agree with the plain version in {dtype} (tol {tol:g}); composite exact on {exact[True]} of the "
        f"whole-image cases, a border band needing the two-stage form on {exact[False]}")
    return worst


def direct_scale(dtype):
    """The least scale whose footprint of x does not fit the residual kernel's
    shared memory at a 3x3 blur: 16 in float32, 11 in float64."""
    return 16 if dtype == torch.float32 else 11


def _check_direct_sweep(device, dtype):
    """The residual and gradient kernels past the staged and tabled
    instantiations, against the plain version: s = 16 (float32) / 11
    (float64) at 3x3, where the residual kernel takes its DIRECT
    instantiation; a 33x33 blur at s = 2 and 4, past the composite table,
    where both do; a 31x31 blur at s = 2, which still fits the table. All four
    modes, integer, fractional and +-9 px shifts on whole images that are no
    multiple of any block tile (each launched twice for the same bits), and
    shard tiles (two corners and the centre of a 3x3 tiling, owned and
    default mask) with fractional and +-9 px shifts. Which instantiation each
    case takes is checked too."""
    tol = TOLERANCE[dtype]
    big = direct_scale(dtype)
    shift_sets = {
        "integer": [(0, 0), (1, 1), (0, -1), (-2, 1)],
        "fractional": [(0, 0), (1.25, -0.5), (-2.0, 3.0), (-0.75, -1.375)],
        "wide": [(0, 0), (9.0, 9.0), (-9.0, -8.5), (4.5, -8.25)],
    }
    # (scale, blur, whole image, tiled image, residual DIRECT, gradient DIRECT)
    cases = [
        (big, gaussian_kernel_2d(3, 1.0), (5 * big, 7 * big), (9 * big, 12 * big), True, False),
        (2, gaussian_kernel_2d(33, 5.0), (70, 98), (96, 120), True, True),   # tiles at least the halo (26-28)
        (4, gaussian_kernel_2d(33, 5.0), (72, 100), (96, 120), True, True),
        (2, gaussian_kernel_2d(31, 5.0), (70, 98), (96, 120), False, False),
    ]
    modes = degrade.KERNEL_NAMES
    worst, launches = 0.0, 0

    def held(args, kw, what, twice=False):
        nonlocal worst, launches
        out = degrade.fused_objective(*args, **kw)
        if twice:
            again = degrade.fused_objective(*args, **kw)
            check(float(out[0]) == float(again[0]) and torch.equal(out[1], again[1]),
                  f"direct sweep {dtype} {what}: two launches gave different bits")
        host = tuple(a.cpu().numpy() if i == 2 else a for i, a in enumerate(args))
        cost_err, grad_err, abs_err = _errors(out, degrade.fused_objective_reference(*host, **kw))
        launches += 1
        worst = max(worst, abs_err)
        check(cost_err <= tol and grad_err <= tol,
              f"direct sweep {dtype} {what}: cost {cost_err:.3e}, grad {grad_err:.3e} > {tol:g}")

    for n, (scale, kern, whole, tiled, residual_direct, gradient_direct) in enumerate(cases):
        size = f"{kern.shape[0]}x{kern.shape[1]}"
        taken = (degrade.takes_direct("sr_residual_kernel", scale, kern.shape, dtype),
                 degrade.takes_direct("sr_gradient_kernel", scale, kern.shape, dtype))
        check(taken == (residual_direct, gradient_direct),
              f"s={scale} blur {size} {dtype}: DIRECT instantiations (residual, gradient) {taken}, expected "
              f"{(residual_direct, gradient_direct)}")
        for set_name, shifts in shift_sets.items():
            x, y, sh, _, constants = _kernel_problem(2, whole, scale, shifts, kern, 760 + n, device, dtype)
            sh_dev = torch.as_tensor(sh, device=device)
            for mode in modes:
                held((x, y, sh_dev, kern, scale), _mode_kwargs(mode, constants),
                     f"{mode} s={scale} blur {size} {set_name} shifts whole {whole}", twice=True)
        mesh = make_mesh({"row": 3, "col": 3}, devices=[device])
        th, tw = tiled[0] // 3, tiled[1] // 3
        for set_name in ("fractional", "wide"):
            x, y, sh, _, _ = _kernel_problem(2, tiled, scale, shift_sets[set_name], kern, 770 + n, device, dtype)
            q = _halo_width(sh, kern, scale, 3)
            ql = q // scale
            tiles = collectives.halo_gather(mesh, Sharded.from_global(mesh, x, {"row": 1, "col": 2}).parts, q)
            lows = Sharded.from_global(mesh, y, {"row": 2, "col": 3}).parts
            owned = torch.zeros((th + 2 * q) // scale, (tw + 2 * q) // scale, dtype=dtype, device=device)
            owned[ql: ql + th // scale, ql: ql + tw // scale] = 1.0
            rng = np.random.default_rng(780 + n)
            for shard, mask in ((0, owned), (4, None), (8, owned)):
                coords = mesh.coords(shard)
                xt = tiles[shard].contiguous()
                yt = torch.nn.functional.pad(lows[shard], (ql, ql, ql, ql)).contiguous()
                constants = torch.as_tensor(rng.random(tuple(xt.shape)) * 0.02, dtype=dtype, device=device)
                for mode in modes:
                    kw = dict(_mode_kwargs(mode, constants), data_mask_lr=mask,
                              origin=(coords["row"] * th - q, coords["col"] * tw - q), global_hw=tiled)
                    held((xt, yt, torch.as_tensor(sh, device=device), kern, scale), kw,
                         f"{mode} s={scale} blur {size} {set_name} shifts tile {coords} "
                         f"{'owned' if mask is not None else 'default'} mask")
    log(f"[3/13] kernels: direct sweep: {launches} launches (s {big} at 3x3, 33x33 at s 2 and 4 -- DIRECT -- and 31x31 "
        f"at s 2 -- the table; integer / fractional / wide shifts x whole images x {len(modes)} modes, bit-equal when "
        f"launched twice; 3 shard tiles x fractional / wide shifts x {len(modes)} modes) agree with the plain version "
        f"in {dtype} (tol {tol:g})")
    return worst


def tiled_shifts():
    """16 fractional shifts (eighths of an HR pixel within +-2), the first zero, from a seed."""
    shifts = np.round(np.random.default_rng(61).uniform(-2.0, 2.0, size=(TILED_FRAMES, 2)) * 8.0) / 8.0
    shifts[0] = 0.0
    return [(float(dx), float(dy)) for dx, dy in shifts]


def _as_tile(q, scale, origin, global_hw):
    """Arrays of a timed row prepared as the tiled path gives them: zero rims, the owned-pixel mask."""
    def shard(x, y, constants):
        ql = q // scale
        owned = torch.zeros(x.shape[-2] // scale, x.shape[-1] // scale, dtype=x.dtype, device=x.device)
        owned[ql:-ql, ql:-ql] = 1.0
        y.mul_(owned)
        rim = torch.zeros_like(x[0])
        rim[q:-q, q:-q] = 1.0
        constants.mul_(rim)
        return dict(origin=origin, global_hw=global_hw, data_mask_lr=owned)
    return shard


def _as_band_shard(x, y, constants):
    """Arrays of a timed row prepared as the band path gives them: zero constants and observations on the halo band."""
    constants[-1] = 0.0
    y[:, -1] = 0.0
    return dict(spectral_halo=True)


def row_shape(row):
    """The arguments the row's path gives the kernels: (channels, HR shape,
    scale, shifts, blur kernel, shard preparation or None). A row with
    ``"flagship_tile"`` set is K7a's other half: a corner tile of the 2x2
    tiling of the flagship with TV."""
    gauss = gaussian_kernel_2d
    if row.get("flagship_tile"):
        q = _halo_width(FLAGSHIP_SHIFTS, gauss(3, 1.5), 4, 2)
        return 1, (500 + 2 * q, 500 + 2 * q), 4, FLAGSHIP_SHIFTS, gauss(3, 1.5), _as_tile(q, 4, (-q, -q), (1000, 1000))
    if row["name"] == "shard_mode":
        # A corner tile of the 2x2 tiling of the RGB 3x2048x2048 scene, rim included.
        q = _halo_width(tiled_shifts(), gauss(3, 1.5), 4, 3)
        side = 1024 + 2 * q
        return 3, (side, side), 4, tiled_shifts(), gauss(3, 1.5), _as_tile(q, 4, (-q, -q), (2048, 2048))
    if row["name"] == "spectral_halo":
        # One of 4 band shards of the 64-band cube: 16 bands and the halo band.
        return 17, (256, 256), 2, FLAGSHIP_SHIFTS, gauss(3, 1.5), _as_band_shard
    if row["path"] == "flagship":
        return 1, (1000, 1000), 4, FLAGSHIP_SHIFTS, gauss(3, 1.5), None
    if row["path"] == "estimated":
        return 3, (1000, 1000), 4, ESTIMATED_TRUE_SHIFTS, gauss(3, 1.5), None
    return 64, (256, 256), 2, FLAGSHIP_SHIFTS, gauss(3, 1.5), None


def time_row_at_path_shape(row, device, flush):
    """:func:`_time_row` at the shape the row's path gives the kernels."""
    c, hw, scale, shifts, kernel, shard = row_shape(row)
    return _time_row(row, c, hw, scale, shifts, kernel, device, flush, shard=shard)


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
        (2, (66, 90), 2, frac, gauss(3, 1.0)),           # neither side a multiple of the block
        (5, (132, 76), 4, frac[:3], lopsided),
        (64, (256, 256), 2, FLAGSHIP_SHIFTS, gauss(3, 1.5)),  # the hyperspectral width
    ]
    worst = {name: 0.0 for name in degrade.KERNEL_NAMES}
    for dtype in (torch.float32, torch.float64):
        tol = TOLERANCE[dtype]
        for i, (c, hw, scale, shifts, kernel) in enumerate(cases):
            x, y, sh, kern, constants = _kernel_problem(c, hw, scale, shifts, kernel, 100 + i, device, dtype)
            outs = {}
            for name in degrade.KERNEL_NAMES:
                kw = _mode_kwargs(name, constants)
                outs[name] = cost, grad = degrade.fused_objective(x, y, sh, kern, scale, **kw)
                torch.cuda.synchronize(device)
                check(bool(torch.isfinite(cost)) and bool(torch.isfinite(grad).all()),
                      f"{name}: non-finite output")
                cost_err, grad_err, abs_err = _errors(
                    outs[name], degrade.fused_objective_reference(x, y, sh, kern, scale, **kw))
                if dtype == torch.float32:
                    worst[name] = max(worst[name], abs_err)
                check(cost_err <= tol and grad_err <= tol,
                      f"{name} {dtype} case {i} (C={c}, HR={hw}, s={scale}): cost rel err {cost_err:.3e}, "
                      f"grad err {grad_err:.3e} > {tol:g}")
            if c == 1:  # one band has no spectral neighbour: the 3D mode is the 2D mode, bit for bit
                check(float(outs["data_term_tv3d"][0]) == float(outs["data_term_tv"][0])
                      and torch.equal(outs["data_term_tv3d"][1], outs["data_term_tv"][1]),
                      f"data_term_tv3d differs from data_term_tv at C=1 (case {i}, {dtype})")
        log(f"[3/13] kernels: {len(cases)} shapes x {len(degrade.KERNEL_NAMES)} modes agree with the plain version "
            f"in {dtype} (tol {tol:g}); tv3d == tv at C=1")
        _check_shift_generic(device, dtype)
        shard_worst = {"shard_mode": _check_shard_mode(device, dtype),
                       "spectral_halo": _check_spectral_halo(device, dtype)}
        if dtype == torch.float32:
            worst.update(shard_worst)
        _check_trivial_shard_arguments(device, dtype)
        _check_assembled(device, dtype)
        btv_worst = _check_btv_sweep(device, dtype)
        composite_worst = _check_composite_sweep(device, dtype)
        direct_worst = _check_direct_sweep(device, dtype)
        if dtype == torch.float32:
            worst["data_term_btv"] = max(worst["data_term_btv"], btv_worst, direct_worst)
            for mode in ("data_term", "data_term_tv", "data_term_tv3d"):
                worst[mode] = max(worst[mode], composite_worst, direct_worst)
    attributes = _check_kernel_attributes()
    tap_difference = _float32_tap_difference(device)
    log(f"[3/13] kernels: float32 gradient with tap weights made in float32 (as the TPU kernel's shift-generic mode "
        f"makes them) vs the kernels' float64 weights rounded once: {tap_difference:.2e} of the largest entry")
    check(tap_difference <= TOLERANCE[torch.float32], f"float32 tap weights move the gradient by {tap_difference}")

    # Times, float32, each row at the shape its path gives it.
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    rows = [dict(row) for row in ROWS]
    for row in rows:
        row["max_abs_err"] = worst[row["name"] if row["path"] == "mesh" else row["mode"]]
        row["instantiations"] = _row_attributes(row, attributes)
        x, y, sh, kern, constants = time_row_at_path_shape(row, device, flush)
        if row["name"] == "shard_mode":
            # Half of K7a's launches are tiles of the flagship with TV: a corner tile of its 2x2 tiling, rim included.
            tv_tile = dict(row, mode="data_term_tv", flagship_tile=True)
            time_row_at_path_shape(tv_tile, device, flush)
            row["flagship_tile_tv"] = {key: tv_tile[key] for key in (
                "shape", "ms", "ms_cold_l2", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "per_kernel")}
        if row["name"] == "data_term_tv":
            # The DIRECT instantiations at full width, on the flagship's mode: a
            # 33x33 blur (residual and gradient), and s = 16 (the residual).
            row["fallbacks"] = []
            for label, hw, scale, kern in (("33x33 blur", (1000, 1000), 4, gauss(33, 5.0)),
                                           ("s=16", (1024, 1024), 16, gauss(3, 1.5))):
                fallback = dict(row, row=f"K2 DIRECT {label}")
                _time_row(fallback, 1, hw, scale, FLAGSHIP_SHIFTS, kern, device, flush)
                row["fallbacks"].append({key: fallback[key] for key in (
                    "row", "shape", "ms", "ms_cold_l2", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                    "per_kernel", "fold")})
        if row["name"] == "channel_grid":
            # 4 M values and tens of thousands of per-block partials: the
            # float32 kernels' cost against the float64 plain version.
            kw = _mode_kwargs(row["mode"], constants)
            cost32 = float(degrade.fused_objective(x, y, sh, kern, 2, **kw)[0])
            cost64 = float(degrade.fused_objective_reference(
                x.double(), y.double(), sh, kern, 2, tv_constants=constants.double())[0])
            row["cost_rel_err_vs_float64"] = abs(cost32 - cost64) / abs(cost64)
            log(f"         float32 cost over {x.numel()} values vs the float64 plain version: "
                f"relative error {row['cost_rel_err_vs_float64']:.2e} (tol 1e-5)")
            check(row["cost_rel_err_vs_float64"] <= 1e-5, "float32 cost of the 64-band cube is off")
    return rows


def _golden_solve(lr_names, initial_name, params, regularizer, lam, device, fused=False):
    lows = [load_golden(n) for n in lr_names]
    solver = sr.IRLSMapSolver(sr.IRLSMapSolverOptions(fused_irls=fused), sr.ImageModel.create(params), lows,
                              device=device, dtype=torch.float64)
    if regularizer is not None:
        solver.add_regularizer(regularizer, lam)
    return solver.solve(load_golden(initial_name)).cpu().numpy()


def phase_goldens(device):
    """The C++ reference's golden problems through the kernels, float64,
    with the default options (``cg``): through the host loop, then through
    the fused solve, which must pass the same checks with the same bits."""
    seq_a = MotionShiftSequence([(0, 0), (1, 0), (0, 1), (1, 1)])
    seq = MotionShiftSequence(FLAGSHIP_SHIFTS)
    host = {}
    for fused in (False, True):
        t0 = time.perf_counter()
        way = "fused" if fused else "host loop"
        ours = _golden_solve([f"icon_lr_{i}.bin" for i in range(4)], "icon_initial.bin",
                             sr.ImageModelParameters(scale=2, motion_sequence=seq_a), None, 0.0, device, fused)
        err_a = float(np.abs(ours - load_golden("icon_unreg_result.bin")).max())
        check(err_a < 1e-3, f"golden A ({way}): max abs diff {err_a}")
        solves = {"A": ours}

        ours = _golden_solve([f"dallas_lr_{i}.bin" for i in range(4)], "dallas_initial.bin",
                             sr.ImageModelParameters(scale=2, blur_radius=3, blur_sigma=1.0, motion_sequence=seq),
                             TotalVariationRegularizer(), 0.01, device, fused)
        ref = load_golden("dallas_tv_result.bin")
        agreement = float(psnr(ours, ref))
        check(agreement > 40.0 and np.abs(ours - ref).mean() < 5e-3, f"golden B ({way}): agreement {agreement} dB")
        solves["B"] = ours

        ours = _golden_solve([f"dallas4x_lr_{i}.bin" for i in range(4)], "dallas4x_initial.bin",
                             sr.ImageModelParameters(scale=4, blur_radius=3, blur_sigma=1.5, motion_sequence=seq),
                             BilateralTotalVariationRegularizer(3, 0.5), 0.01, device, fused)
        gt = load_golden("dallas4x_ground_truth.bin")
        psnr_ours = float(psnr(ours, gt))
        psnr_ref = float(psnr(load_golden("dallas4x_btv_result.bin"), gt))
        check(abs(psnr_ours - psnr_ref) <= 0.1, f"golden C ({way}): {psnr_ours} dB vs reference {psnr_ref} dB")
        solves["C"] = ours
        same = ""
        if fused:
            check(all(np.array_equal(solves[g], host[g]) for g in solves),
                  "goldens: the fused solve differs from the host loop's")
            same = ", each bit-equal to the host loop's"
        host = solves
        log(f"[4/13] goldens ({way}, cg): A max|diff| {err_a:.2e}; B agreement {agreement:.2f} dB; "
            f"C {psnr_ours:.3f} dB vs C++ {psnr_ref:.3f} dB{same} ({time.perf_counter() - t0:.1f} s)")


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


def run_solve(name, solver, x0, gt, lam, shard_counter=None):
    """One solve through ``solver``, with its launch count checked against its
    evaluation count, and the estimate, the shifts and the L1 objective read
    after every IRLS round. ``shard_counter``: which of the kernels' mesh
    modes ("shard_mode", "spectral_halo") every launch of the solve must
    have run in; ``None``: neither."""
    # The solver reweights once after every round: listen there for the round's state.
    round_estimates, round_shifts = [], []
    reweight = solver._reweight
    solver._reweight = lambda x: (round_estimates.append(x), round_shifts.append(solver.shifts), reweight(x))[2]
    device = solver.device
    before = degrade.launch_counts[name]
    before_shard = dict(degrade.shard_launch_counts)
    before_plain = degrade.plain_version_calls["calls"]
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    x = solver.solve(x0)
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches = degrade.launch_counts[name] - before
    evaluations = sum(call[2] for call in solver.last_inner_calls)
    check(x.shape == gt.shape and bool(torch.isfinite(x).all()), f"{name}: bad output")
    # One launch per shard and evaluation; on a mesh, in the mode its path needs.
    shards = 1 if solver.mesh is None else solver.mesh.num_shards
    expected = 0 if isinstance(solver, PlainObjectiveSolver) else shards * evaluations
    check(launches == expected, f"{name}: {launches} kernel launches, expected {expected}")
    for counter, count in degrade.shard_launch_counts.items():
        expected = shards * evaluations if counter == shard_counter else 0
        check(count - before_shard[counter] == expected,
              f"{name}: {count - before_shard[counter]} {counter} launches, expected {expected}")
    if not isinstance(solver, PlainObjectiveSolver):
        check(degrade.plain_version_calls["calls"] == before_plain, f"{name}: the solve called the plain version")
    return {
        "x": x, "seconds": seconds, "launches": launches, "evaluations": evaluations,
        "iterations": solver.last_inner_iterations,
        "objectives": [_l1_objective(solver, e, lam) for e in [x0] + (round_estimates or [x])],
        "psnr": float(psnr(x, gt)), "psnr_start": float(psnr(x0, gt)),
        "inner_calls": solver.last_inner_calls, "shifts": round_shifts,
    }


def solve_once(name, gt_np, scale, options, regularizer, lam, device, dtype, solver_class=sr.IRLSMapSolver):
    """The flagship geometry from the nearest-neighbour start (see :func:`run_solve`)."""
    model, gt, lows = make_observations(gt_np, FLAGSHIP_SHIFTS, scale, 3, 1.5, device, dtype)
    solver = solver_class(options, model, lows, device=device, dtype=dtype)
    if regularizer is not None:
        solver.add_regularizer(regularizer, lam)
    nearest = lows[0].repeat_interleave(scale, dim=-2).repeat_interleave(scale, dim=-1)
    return run_solve(name, solver, nearest, gt, lam)


def check_objective_never_rises(name, objectives):
    for before, after in zip(objectives, objectives[1:]):
        check(after <= before * (1.0 + OBJECTIVE_RISE_TOLERANCE),
              f"{name}: the L1 objective rose across a round, {before} -> {after}")


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


def read_launches(rows, path):
    """The launch counts of the path just driven (counts were set to 0 before it) into its rows."""
    counts = dict(degrade.launch_counts)
    for row in rows:
        if row["path"] == path:
            row["launches"] = counts[row["mode"]]
            check(row["launches"] > 0, f"the {path} path never launched {row['mode']} ({row['row']})")


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
        log(f"[5/13] main path {name}: {side}x{side}, {r['iterations']} inner iterations, "
            f"{r['evaluations']} evaluations, {r['launches']} launches, {r['seconds']:.3f} s, "
            f"{mpix_it:.1f} Mpixel-iterations/s, PSNR {r['psnr']:.2f} dB (nearest {r['psnr_start']:.2f} dB)")
        log(f"      inner calls (s, iterations, evaluations): "
            f"{[(round(t, 4), i, e) for t, i, e in r['inner_calls']]}; "
            f"L1 objective at the start and after each round: {[float(f'{o:.7g}') for o in r['objectives']]}")
        check_objective_never_rises(name, r["objectives"])
        check(r["psnr"] >= r["psnr_start"] + 1.0,
              f"{name}: PSNR {r['psnr']:.2f} dB does not beat nearest-neighbour {r['psnr_start']:.2f} dB by 1 dB")
    read_launches(rows, "flagship")

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
    results["blur33"] = large_blur_solve(gt, device)
    return results


def large_blur_solve(gt_np, device, rounds=2, iterations=10):
    """The flagship with a 33x33 Gaussian blur (sigma 5), past the composite
    table: a TV solve through the kernels' DIRECT instantiations beside the
    same solve through the plain version on the card. The L1 objective may
    not rise across a round, and the two solves must end within 5e-2 of each
    other in it (relative)."""
    dtype = torch.float32
    solves = {}
    for cls in (sr.IRLSMapSolver, PlainObjectiveSolver):
        model, gt, lows = make_observations(gt_np, FLAGSHIP_SHIFTS, 4, 33, 5.0, device, dtype)
        solver = cls(fixed_iterations(iterations, rounds), model, lows, device=device, dtype=dtype)
        solver.add_regularizer(TotalVariationRegularizer(), 0.01)
        nearest = lows[0].repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1)
        solves[cls] = run_solve("data_term_tv", solver, nearest, gt, 0.01)
    ours, plain = solves[sr.IRLSMapSolver], solves[PlainObjectiveSolver]
    check(degrade.takes_direct("sr_gradient_kernel", 4, (33, 33), dtype), "the 33x33 solve missed the DIRECT kernels")
    objective_diff = abs(ours["objectives"][-1] - plain["objectives"][-1]) / abs(plain["objectives"][-1])
    log(f"      {gt_np.shape[-2]}x{gt_np.shape[-1]} TV solve with a 33x33 blur (DIRECT instantiations): "
        f"{ours['iterations']} iterations, {ours['launches']} launches = evaluations, {ours['seconds']:.3f} s "
        f"(plain version {plain['seconds']:.3f} s); PSNR {ours['psnr']:.2f} dB (plain {plain['psnr']:.2f}, nearest "
        f"{ours['psnr_start']:.2f}); L1 objective {[float(f'{o:.7g}') for o in ours['objectives']]}, "
        f"the plain solve's final one {objective_diff:.2e} relative apart (tol 5e-2)")
    check_objective_never_rises("33x33 blur", ours["objectives"])
    check(objective_diff <= 5e-2, f"33x33 blur: kernel and plain solves end {objective_diff} apart in objective")
    return ours


# ----------------------------------------------------------------- estimated motion


def estimated_motion_problem(device, side=1000, dtype=torch.float32):
    """RGB scene and its 4 LR frames at 4x (true fractional shifts, 3x3 blur sigma 1.5)."""
    _, gt, lows = make_observations(synthetic_scene(3, side, side, seed=31), ESTIMATED_TRUE_SHIFTS, 4, 3, 1.5,
                                    device, dtype)
    return gt, lows


def estimated_motion_solver(lows, shifts_hr, refine_every, device, rounds=4, iterations=50, dtype=torch.float32,
                            mesh=None):
    """BTV(3, 0.5) lambda 0.01, linear_cg, ``rounds`` x ``iterations`` fixed, starting from ``shifts_hr``."""
    options = dataclasses.replace(
        fixed_iterations(iterations, rounds), irls_cost_difference_threshold=0.0,
        refine_motion_every=refine_every, refine_motion_iterations=2)
    model = sr.ImageModel.create(sr.ImageModelParameters(
        scale=4, blur_radius=3, blur_sigma=1.5,
        motion_sequence=MotionShiftSequence([(float(dx), float(dy)) for dx, dy in shifts_hr])))
    solver = sr.IRLSMapSolver(options, model, lows, device=device, dtype=dtype, mesh=mesh)
    solver.add_regularizer(BilateralTotalVariationRegularizer(3, 0.5), 0.01)
    return solver


def phase_estimated_motion(device, rows):
    """Register the LR frames, solve with the registered motion, with the
    motion refined between IRLS rounds, and with the true motion."""
    scale = 4
    true = np.asarray(ESTIMATED_TRUE_SHIFTS, dtype=np.float64)
    gt, lows = estimated_motion_problem(device)
    seconds = []
    for _ in range(2):  # the first call also sets up the FFT plans
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        registered = sr.translational_registration(lows, device=device)
        seconds.append(time.perf_counter() - t0)
    estimated = registered.as_array() * scale  # LR px -> HR px
    err_estimated = float(np.abs(estimated - true).max())
    log(f"[6/13] estimated motion: registration of 4 frames {tuple(lows[0].shape)} took {seconds[0]:.3f} s, then "
        f"{seconds[1]:.3f} s; max error {err_estimated:.4f} HR px (limit 0.25)")
    check(err_estimated < 0.25, f"registration is off by {err_estimated} HR px")
    x0 = linear_resize(lows[0], tuple(gt.shape[-2:])).contiguous()

    # From refiner to kernel on the device: neither call may copy to the host or wait for it.
    probe = estimated_motion_solver(lows, estimated, 1, device)
    kern_dev = torch.as_tensor(probe.blur_kernel, dtype=x0.dtype, device=device)
    ones = torch.ones_like(x0)
    with no_synchronisation(device):
        refined = refine_shifts(x0, probe.observations, probe.shifts, probe.blur_kernel, scale, num_iterations=2)
        cost, _ = degrade.fused_objective(x0, probe.observations, refined, kern_dev, scale,
                                          btv_constants=ones, btv_range=3, btv_decay=0.5)
    check(refined.is_cuda and bool(torch.isfinite(cost)), "refiner -> kernel on the device failed")
    refine_ms = _time_launches(
        lambda: refine_shifts(x0, probe.observations, probe.shifts, probe.blur_kernel, scale, num_iterations=2),
        device, 5)
    log(f"      refine_shifts (2 Gauss-Newton steps, 4 frames) -> fused objective with no synchronisation; "
        f"{refine_ms:.2f} ms of device time per refinement")

    degrade.reset_launch_counts()
    results = {}
    for label, shifts, every in (("estimated", estimated, 0), ("refined", estimated, 1), ("known", true, 0)):
        solver = estimated_motion_solver(lows, shifts, every, device)
        results[label] = r = run_solve("data_term_btv", solver, x0, gt, 0.01)
        r["shift_errors"] = [float(np.abs(s.cpu().numpy() - true).max()) for s in r["shifts"]]
        check(solver.shifts.is_cuda and solver.shifts.dtype == torch.float64, "the solver's shifts left the device")
        log(f"      {label} motion: {r['iterations']} iterations, {r['launches']} launches = evaluations, "
            f"{r['seconds']:.3f} s, PSNR {r['psnr']:.2f} dB; max shift error after each round "
            f"{[round(e, 4) for e in r['shift_errors']]}")
    launches = sum(r["launches"] for r in results.values())
    check(degrade.shift_source_counts == {"device": launches, "host": 0},
          f"shifts crossed from the host during the solves: {degrade.shift_source_counts}, {launches} launches")
    read_launches(rows, "estimated")

    linear_db = results["refined"]["psnr_start"]
    err_refined = results["refined"]["shift_errors"][-1]
    log(f"      PSNR ladder: linear upsample {linear_db:.2f} / estimated {results['estimated']['psnr']:.2f} / "
        f"refined {results['refined']['psnr']:.2f} / known motion {results['known']['psnr']:.2f} dB; "
        f"shift error {err_estimated:.4f} -> {err_refined:.4f} HR px")
    check(err_refined <= err_estimated + 0.02, f"refinement made the motion worse: {err_estimated} -> {err_refined}")
    check(results["refined"]["psnr"] >= linear_db + 1.0, "the refined solve does not beat linear upsampling by 1 dB")
    check(results["refined"]["psnr"] >= results["known"]["psnr"] - 0.5,
          "the refined solve is more than 0.5 dB under the known-motion solve")
    check(len(list(build.build_dir().glob("libdegrade_*.so"))) == 1, "the kernels were built more than once")
    return results


# -------------------------------------------------------------------- hyperspectral


def hyperspectral_problem(device, bands=64, side=256, dtype=torch.float32):
    """Correlated bands: one seeded base image times per-band gains; 4 frames at 2x."""
    base = synthetic_scene(1, side, side, seed=41)
    gains = np.random.default_rng(0).uniform(0.5, 1.5, size=(bands, 1, 1))
    model, gt, lows = make_observations(base * gains, FLAGSHIP_SHIFTS, 2, 3, 1.5, device, dtype)
    return model, gt, lows


def pca_problem(device, bands=64, side=512, dtype=torch.float32):
    """A cube of low spectral rank: 4 abundance maps mixed by smooth spectra, plus a little noise."""
    maps = synthetic_scene(4, side, side, seed=51)
    lam = np.linspace(0.0, 1.0, bands)[:, None]
    spectra = np.exp(-((lam - np.array([0.15, 0.4, 0.65, 0.9])) ** 2) / (2 * 0.18**2))  # [bands, 4]
    cube = np.tensordot(spectra, maps, axes=1) + 0.002 * np.random.default_rng(7).standard_normal((bands, side, side))
    return make_observations(cube, FLAGSHIP_SHIFTS, 2, 3, 1.5, device, dtype)


def tv_solver(model, lows, use_3d, options, device, dtype=torch.float32, mesh=None):
    solver = sr.IRLSMapSolver(options, model, lows, device=device, dtype=dtype, mesh=mesh)
    solver.add_regularizer(TotalVariationRegularizer(use_3d), 0.01)
    return solver


def phase_hyperspectral(device, rows):
    """64 bands in one objective with 2D and with 3D spectral TV, then the PCA-space solve."""
    model, gt, lows = hyperspectral_problem(device)
    x0 = linear_resize(lows[0], tuple(gt.shape[-2:])).contiguous()
    degrade.reset_launch_counts()
    results = {}
    for name, use_3d in (("data_term_tv", False), ("data_term_tv3d", True)):
        solver = tv_solver(model, lows, use_3d, fixed_iterations(20, 2), device)
        results[name] = r = run_solve(name, solver, x0, gt, 0.01)
        mvals = r["iterations"] * gt.numel() / r["seconds"] / 1e6
        log(f"[7/13] hyperspectral {name}: {tuple(gt.shape)}, {r['iterations']} iterations, {r['launches']} launches "
            f"= evaluations, {r['seconds']:.3f} s, {mvals:.1f} Mvalue-iterations/s, PSNR {r['psnr']:.2f} dB "
            f"(linear upsample {r['psnr_start']:.2f} dB); L1 objective {[float(f'{o:.7g}') for o in r['objectives']]}")
        check_objective_never_rises(name, r["objectives"])
        check(r["psnr"] >= r["psnr_start"] + 1.0, f"{name}: the 64-band solve does not beat linear upsampling by 1 dB")
    check(float((results["data_term_tv"]["x"] - results["data_term_tv3d"]["x"]).abs().max()) > 1e-4,
          "the spectral term changed nothing")

    # PCA space: project the LR frames, solve the few components, project back.
    model, gt, lows = pca_problem(device)
    t0 = time.perf_counter()
    pca = sr.SpectralPCA(lows, num_pca_bands=4)
    lows_pca = [pca.project(f).contiguous() for f in lows]
    torch.cuda.synchronize(device)
    t_pca = time.perf_counter() - t0
    round_trip = float(psnr(pca.back_project(pca.project(gt)), gt))
    check(round_trip >= 40.0, f"PCA round trip {round_trip:.2f} dB < 40 dB")
    hw = tuple(gt.shape[-2:])
    solver = tv_solver(model, lows_pca, False, fixed_iterations(20, 1), device)
    r = run_solve("data_term_tv", solver, linear_resize(lows_pca[0], hw).contiguous(), pca.project(gt), 0.01)
    solved = pca.back_project(r["x"])
    linear = linear_resize(lows[0], hw)
    # The coefficients have their mean taken off, so the zero borders of warp
    # and blur do not match the projected frames in a band along the border
    # (the method's own behaviour, in the JAX package as here): the solve is
    # scored inside that band, and the whole-image figure is printed beside it.
    b = PCA_BORDER
    inner = (slice(None), slice(b, -b), slice(b, -b))
    solved_db, linear_db = float(psnr(solved[inner], gt[inner])), float(psnr(linear[inner], gt[inner]))
    log(f"[7/13] hyperspectral PCA: {gt.shape[0]} bands -> {pca.num_pca_bands} components in {t_pca:.3f} s (round trip "
        f"{round_trip:.2f} dB); {tuple(r['x'].shape)} solve {r['iterations']} iterations, {r['launches']} launches, "
        f"{r['seconds']:.3f} s; back-projected cube {solved_db:.2f} dB vs linear upsample {linear_db:.2f} dB inside "
        f"a {b}-px border (whole image {float(psnr(solved, gt)):.2f} vs {float(psnr(linear, gt)):.2f} dB)")
    check(solved.shape == gt.shape and bool(torch.isfinite(solved).all()), "PCA: bad output")
    check(solved_db >= linear_db + 1.0, "the PCA-space solve does not beat linear upsampling by 1 dB")
    read_launches(rows, "hyperspectral")
    results["pca"] = r
    return results


# ------------------------------------------------------------------------ the mesh


def tiled_problem(device, dtype=torch.float32, side=2048):
    """RGB scene and its 16 LR frames at 4x (fractional shifts, 3x3 blur sigma 1.5)."""
    return make_observations(synthetic_scene(3, side, side, seed=61), tiled_shifts(), 4, 3, 1.5, device, dtype)


def compare_with_single_device(label, make, mode, shard_counter, mesh, lam, rounds, iterations, rounds64=1):
    """The meshed solve beside the single-device solve through the kernels on
    the same card, iteration thresholds at 0. ``make(dtype, options, mesh) ->
    (solver, x0, gt)``. float64, ``rounds64`` round(s): pixel by pixel; float32,
    the full length: by where it ends (L1 objective, PSNR), as the kernels are
    held against the plain version in phase_main_path."""
    out = {}
    for dtype, n_rounds in ((torch.float32, rounds), (torch.float64, rounds64)):
        options = dataclasses.replace(fixed_iterations(iterations, n_rounds), irls_cost_difference_threshold=0.0)
        single, meshed = [
            run_solve(mode, *make(dtype, options, m), lam, shard_counter=shard_counter if m is not None else None)
            for m in (None, mesh)
        ]
        check([c[1:] for c in single["inner_calls"]] == [c[1:] for c in meshed["inner_calls"]],
              f"{label} {dtype}: iterations and evaluations per round differ: "
              f"{single['inner_calls']} vs {meshed['inner_calls']}")
        diff = float((single["x"] - meshed["x"]).abs().max())
        if dtype == torch.float64:
            log(f"      {label} in float64 ({n_rounds} x {iterations} iterations): meshed vs single-device "
                f"max|diff| {diff:.2e} (tol 1e-6)")
            check(diff <= 1e-6, f"{label}: meshed and single-device float64 solves differ by {diff}")
            if single["shifts"] and meshed["shifts"]:
                moved = float((single["shifts"][-1] - meshed["shifts"][-1]).abs().max())
                check(moved <= 1e-9, f"{label}: refined shifts differ by {moved} HR px between mesh and one device")
            continue
        objective_diff = abs(meshed["objectives"][-1] - single["objectives"][-1]) / abs(single["objectives"][-1])
        psnr_diff = abs(meshed["psnr"] - single["psnr"])
        log(f"[8/13] mesh {label}: {mesh.shape}, {mesh.num_shards} shards, {meshed['iterations']} iterations, "
            f"{meshed['evaluations']} evaluations, {meshed['launches']} launches; {meshed['seconds']:.3f} s meshed vs "
            f"{single['seconds']:.3f} s on one device; PSNR {meshed['psnr']:.2f} dB (start {meshed['psnr_start']:.2f}, "
            f"one device {single['psnr']:.2f}); max|diff| {diff:.2e}, L1 objective differs {objective_diff:.2e} "
            f"relative (tol 5e-2), PSNR {psnr_diff:.4f} dB (tol 0.05)")
        check(objective_diff <= 5e-2 and psnr_diff <= 0.05,
              f"{label}: meshed and single-device solves end apart: objective {objective_diff}, PSNR {psnr_diff} dB")
        check_objective_never_rises(label, meshed["objectives"])
        check(meshed["psnr"] >= meshed["psnr_start"] + 1.0, f"{label}: the meshed solve does not beat its start by 1 dB")
        out = {"meshed": meshed, "single": single}
    return out


def phase_mesh(device, rows):
    """The solve on a device mesh: band shards with the spectral halo, tiles
    with halo exchange, frame shards with refined motion."""
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    log(f"[8/13] mesh: shards are dealt over {len(devices)} visible card(s)")
    degrade.reset_launch_counts()
    results = {}

    def band(dtype, options, mesh):
        model, gt, lows = hyperspectral_problem(device, dtype=dtype)
        return tv_solver(model, lows, True, options, device, dtype, mesh), linear_resize(lows[0], tuple(gt.shape[-2:])).contiguous(), gt

    results["band"] = compare_with_single_device(
        "band x4, 64 bands, 3D TV", band, "data_term_tv3d", "spectral_halo", make_mesh({"band": 4}, devices), 0.01, 2, 20)

    def tiled_rgb(dtype, options, mesh):
        model, gt, lows = tiled_problem(device, dtype)
        solver = sr.IRLSMapSolver(options, model, lows, device=device, dtype=dtype, mesh=mesh)
        solver.add_regularizer(BilateralTotalVariationRegularizer(3, 0.5), 0.01)
        return solver, linear_resize(lows[0], tuple(gt.shape[-2:])).contiguous(), gt

    tiles = make_mesh({"row": 2, "col": 2}, devices)
    results["tiled_rgb"] = compare_with_single_device(
        f"2x2 tiles, RGB 3x2048x2048, {TILED_FRAMES} frames, BTV", tiled_rgb, "data_term_btv", "shard_mode", tiles, 0.01, 2, 20)

    def tiled_flagship(dtype, options, mesh):
        model, gt, lows = make_observations(synthetic_scene(1, 1000, 1000, seed=2026), FLAGSHIP_SHIFTS, 4, 3, 1.5, device, dtype)
        solver = sr.IRLSMapSolver(options, model, lows, device=device, dtype=dtype, mesh=mesh)
        solver.add_regularizer(TotalVariationRegularizer(), 0.01)
        return solver, linear_resize(lows[0], tuple(gt.shape[-2:])).contiguous(), gt

    before = degrade.shard_launch_counts["shard_mode"]
    results["tiled_flagship"] = compare_with_single_device(
        "2x2 tiles, flagship 1x1000x1000, TV", tiled_flagship, "data_term_tv", "shard_mode", tiles, 0.01, 2, 20)
    flagship_tiles = degrade.shard_launch_counts["shard_mode"] - before

    def frames(dtype, options, mesh):
        gt, lows = estimated_motion_problem(device, dtype=dtype)
        estimated = sr.translational_registration(lows, device=device).as_array() * 4
        solver = estimated_motion_solver(lows, estimated, 1, device, options.max_num_irls_iterations,
                                         options.max_num_solver_iterations, dtype, mesh)
        return solver, linear_resize(lows[0], tuple(gt.shape[-2:])).contiguous(), gt

    results["frame"] = compare_with_single_device(
        "frame x4, refined motion, RGB 3x1000x1000, BTV", frames, "data_term_btv", None,
        make_mesh({"frame": 4}, devices), 0.01, 3, 20, rounds64=2)
    refined = results["frame"]["meshed"]["shifts"]
    check(len(refined) == 3 and float((refined[-1] - refined[0]).abs().max()) > 0.0,
          "the frame mesh never refined its motion")

    for row in rows:
        if row["path"] == "mesh":
            row["launches"] = degrade.shard_launch_counts[row["name"]]
            check(row["launches"] > 0, f"the mesh paths never launched the kernels in {row['name']} ({row['row']})")
        if row["name"] == "shard_mode":
            row["launches_by_shape"] = {"rgb_tile_btv": row["launches"] - flagship_tiles,
                                        "flagship_tile_tv": flagship_tiles}
    return results


# ------------------------------------------------------------------- fused IRLS


def _device_busy_ms(run, device):
    """Milliseconds the device spent in kernels during ``run()`` (the sum of
    every kernel's device time in one torch.profiler window, graph replays
    included), or None if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(device)
    return _kernel_ms(prof)


def _kernel_ms(prof):
    """The sum of every kernel's device time in a finished torch.profiler
    window, in ms, or None if the profiler saw no device time."""
    busy = 0.0
    for event in prof.key_averages():
        device_us = getattr(event, "device_time_total", None)
        if device_us is None:
            device_us = getattr(event, "cuda_time_total", 0.0)
        if str(getattr(event, "device_type", "")).endswith("CUDA") and device_us > 0:
            busy += device_us
    return busy / 1e3 if busy > 0 else None


def _reserved_bytes(device):
    """Device memory the caching allocator holds once unused cached blocks
    are given back: live tensors and the private pools of live graphs."""
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(device)


def _timed(solver, x0):
    device = solver.device
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    x = solver.solve(x0)
    torch.cuda.synchronize(device)
    return time.perf_counter() - t0, x


def _fused_solve(solver, x0, mode):
    """One fused solve, with its launches held replay-aware: two kernel
    launches (one count) per evaluation the replays ran, frozen chunk steps
    included, in ``mode`` only, no plain version, no ``late`` flag."""
    before, before_plain = dict(degrade.launch_counts), degrade.plain_version_calls["calls"]
    seconds, x = _timed(solver, x0)
    runs = solver.last_fused_runs
    executed = sum(run["executed_evaluations"] for run in runs)
    grown = {name: degrade.launch_counts[name] - before[name] for name in degrade.launch_counts}
    check(grown == {name: executed if name == mode else 0 for name in grown},
          f"fused {mode}: launches {grown}, but the replays ran {executed} evaluations")
    check(degrade.plain_version_calls["calls"] == before_plain, f"fused {mode}: the solve called the plain version")
    check(not solver.last_fused.late(), f"fused {mode}: a cost fold stopped waiting (late flag) in a replay")
    for run in runs:
        check(run["readbacks"] <= run["chunks"] + len(run["rounds"]),
              f"fused {mode}: {run['readbacks']} read-backs for {run['chunks']} chunks and {len(run['rounds'])} rounds")
    return seconds, x, executed


def _same_solve(label, host, fused, x_host, x_fused):
    """The fused solve against its host-loop twin: the same estimate and
    shifts bit for bit, and the same iterations and evaluations per round."""
    check([c[1:] for c in fused.last_inner_calls] == [c[1:] for c in host.last_inner_calls],
          f"{label}: iterations and evaluations per round differ: {fused.last_inner_calls} vs {host.last_inner_calls}")
    diff = float((x_fused - x_host).abs().max())
    moved = float((fused.shifts - host.shifts).abs().max())
    check(diff == 0.0 and moved == 0.0,
          f"{label}: the fused solve differs from the host loop by {diff:.3e} in x, {moved:.3e} in the shifts")


def fused_problems(device):
    """The solves of the fused phase, float32 at full width: ``{label: (make,
    mode, row)}``, ``make(fused) -> (solver, x0, gt)``, ``row`` the row of the
    ``kernels`` line whose launches the solve makes."""
    dtype = torch.float32
    flagship = synthetic_scene(1, 1000, 1000, seed=2026)

    def flagship_solver(options, reg):
        def make(fused):
            model, gt, lows = make_observations(flagship, FLAGSHIP_SHIFTS, 4, 3, 1.5, device, dtype)
            solver = sr.IRLSMapSolver(dataclasses.replace(options, fused_irls=fused), model, lows, device=device,
                                      dtype=dtype)
            solver.add_regularizer(reg, 0.01)
            return solver, lows[0].repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1), gt
        return make

    gt_rgb, lows_rgb = estimated_motion_problem(device)
    estimated = sr.translational_registration(lows_rgb, device=device).as_array() * 4

    def refined(fused):
        solver = estimated_motion_solver(lows_rgb, estimated, 1, device)
        solver.options.fused_irls = fused
        return solver, linear_resize(lows_rgb[0], tuple(gt_rgb.shape[-2:])).contiguous(), gt_rgb

    model64, gt64, lows64 = hyperspectral_problem(device)

    def bands64(fused):
        options = dataclasses.replace(fixed_iterations(20, 2), fused_irls=fused)
        return (tv_solver(model64, lows64, True, options, device),
                linear_resize(lows64[0], tuple(gt64.shape[-2:])).contiguous(), gt64)

    return {
        "flagship TV 1x1000x1000, 3 x 50": (flagship_solver(fixed_iterations(50, 3), TotalVariationRegularizer()),
                                             "data_term_tv", "K2"),
        "flagship BTV 1x1000x1000, 2 x 20": (flagship_solver(sr.IRLSMapSolverOptions(
            least_squares_solver="linear_cg", max_num_solver_iterations=20, max_num_irls_iterations=2),
            BilateralTotalVariationRegularizer(3, 0.5)), "data_term_btv", "K3"),
        "refined estimated motion RGB 3x1000x1000, 4 x 50": (refined, "data_term_btv", "K4"),
        "64-band 256x256 3D TV, 2 x 20": (bands64, "data_term_tv3d", "K6"),
    }


def phase_fused(device, rows, turns=5, chunk_turns=3):
    """The fused IRLS solve (CUDA graphs of the linear-CG chunk, the IRLS
    seam and the restart) beside the host loop on the same problems, in
    turns: bit-equal estimates and shifts, equal iterations and evaluations,
    launches counted through the replays, no late fold, one capture across
    two solver instances of one shape; wall time, read-backs, graph captures
    and replays of each. Then the chunk length in turns, and last (the
    profiler's tracing can slow later launches) each solve's device busy
    time."""
    from super_resolution_tpu_torch.solvers import graphs, irls as irls_mod

    irls_mod._BUILT_SOLVER_CACHE.clear()
    degrade.reset_launch_counts()
    problems = fused_problems(device)
    results = {}
    launches = {}
    for label, (make, mode, row) in problems.items():
        counted = degrade.launch_counts[mode]
        first, x0, gt = make(True)
        reserved = _reserved_bytes(device)
        captures = graphs.capture_counts["graphs"]
        _, x_first, _ = _fused_solve(first, x0, mode)  # captures
        pinned_mb = (_reserved_bytes(device) - reserved) / 2**20
        captured = graphs.capture_counts["graphs"] - captures
        second, _, _ = make(True)
        _, x_second, _ = _fused_solve(second, x0, mode)
        check(graphs.capture_counts["graphs"] == captures + captured,
              f"{label}: a second solver instance of the same shape captured again")
        reference, _, _ = make(False)
        _, x_ref = _timed(reference, x0)
        _same_solve(label, reference, first, x_ref, x_first)
        _same_solve(label, reference, second, x_ref, x_second)
        host_s, fused_s = [], []
        for _ in range(turns):
            host, _, _ = make(False)
            seconds, x = _timed(host, x0)
            check(torch.equal(x, x_ref), f"{label}: two host-loop solves differ")
            host_s.append(seconds)
            fused, _, _ = make(True)
            seconds, x, executed = _fused_solve(fused, x0, mode)
            _same_solve(label, host, fused, x_ref, x)
            fused_s.append(seconds)
        runs = fused.last_fused_runs
        iterations = fused.last_inner_iterations
        rounds = len(fused.last_inner_calls)
        host_readbacks = iterations + 2 * rounds  # one per iteration and per inner solve's end, one per round
        readbacks = sum(run["readbacks"] for run in runs)
        replays = sum(run["replays"] for run in runs)
        chunks = sum(run["chunks"] for run in runs)
        evaluations = sum(c[2] for c in fused.last_inner_calls)
        values = gt.numel() * iterations
        med_h, med_f = float(np.median(host_s)), float(np.median(fused_s))
        log(f"[9/13] fused {label}: {iterations} iterations, {evaluations} evaluations in {rounds} rounds; "
            f"fused == host loop bit for bit (x and shifts, {turns + 2} pairs)")
        log(f"      wall median host {med_h:.4f} s [{min(host_s):.4f}, {max(host_s):.4f}], fused {med_f:.4f} s "
            f"[{min(fused_s):.4f}, {max(fused_s):.4f}] ({med_h / med_f:.2f}x); "
            f"{values / med_h / 1e6:.0f} -> {values / med_f / 1e6:.0f} Mvalue-iterations/s")
        log(f"      read-backs host {host_readbacks}, fused {readbacks} ({chunks} chunks of up to "
            f"{runs[0]['chunk_steps']} steps + {rounds} rounds); {captured} graphs captured by the first "
            f"instance, 0 by the second; {replays} replays; {executed} evaluations run ({executed - evaluations} "
            f"frozen), {executed} launch counts = {2 * executed} kernel launches; graphs and buffers pin "
            f"{pinned_mb:.0f} MB; PSNR {float(psnr(x, gt)):.2f} dB")
        results[label] = {"host_s": host_s, "fused_s": fused_s, "readbacks": readbacks,
                          "host_readbacks": host_readbacks, "captures": captured, "replays": replays,
                          "pinned_mb": pinned_mb, "psnr": float(psnr(x, gt))}
        # The fused solves' launches (replays counted), the host loop's taken out.
        launches[row] = degrade.launch_counts[mode] - counted - (turns + 1) * evaluations
        check(launches[row] > 0, f"the fused {label} solve never launched {mode} ({row})")
    for row in rows:
        if row["row"] in launches:
            row["launches_fused"] = launches[row["row"]]

    # The chunk length, in turns: frozen steps cost evaluations, chunks cost read-backs.
    default = irls_mod.CHUNK_ITERATIONS
    study = {}
    try:
        for label in ("flagship TV 1x1000x1000, 3 x 50", "flagship BTV 1x1000x1000, 2 x 20",
                      "64-band 256x256 3D TV, 2 x 20"):
            make, mode, _ = problems[label]
            x0 = make(True)[1]
            lengths = sorted({8, 16, make(True)[0].options.max_num_solver_iterations})
            for n in lengths:  # the captures
                irls_mod.CHUNK_ITERATIONS = n
                _fused_solve(make(True)[0], x0, mode)
            for _ in range(chunk_turns):
                for n in lengths:
                    irls_mod.CHUNK_ITERATIONS = n
                    solver = make(True)[0]
                    study.setdefault((label, n), []).append(_fused_solve(solver, x0, mode)[0])
                    frozen = sum(r["executed_evaluations"] - r["evaluations"] for r in solver.last_fused_runs)
                    study[(label, n, "frozen")] = frozen
            log(f"      chunk length, {label} (median of {chunk_turns} in turns): " + ", ".join(
                f"{n} -> {float(np.median(study[(label, n)])):.4f} s ({study[(label, n, 'frozen')]} frozen)"
                for n in lengths))
    finally:
        irls_mod.CHUNK_ITERATIONS = default
    results["chunk_study"] = {f"{key[0]} N={key[1]}": value for key, value in study.items() if len(key) == 2}

    # Device busy time per solve, host loop and fused, from the profiler.
    fmt = lambda ms: "not measured" if ms is None else f"{ms:.2f} ms"  # noqa: E731
    for label, (make, _, _) in problems.items():
        host, x0, _ = make(False)
        host_busy = _device_busy_ms(lambda: host.solve(x0), device)
        fused = make(True)[0]
        fused_busy = _device_busy_ms(lambda: fused.solve(x0), device)
        results[label].update(host_busy_ms=host_busy, fused_busy_ms=fused_busy)
        median = float(np.median(results[label]["fused_s"]))
        share = "" if fused_busy is None else f" ({100 * fused_busy / 1e3 / median:.0f} % of the fused wall median)"
        log(f"      device busy, {label}: host loop {fmt(host_busy)}, fused {fmt(fused_busy)}{share}")
    irls_mod._BUILT_SOLVER_CACHE.clear()
    return results

# ------------------------------------------------ line-search solvers, fused


def _graph_nodes_per_step(step, steps, device):
    """Kernel and copy / set nodes, and device ms, of one replay of a chunk
    graph of ``steps`` steps (from the profiler), per step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize(device)
    kernels = copies = 0
    busy_us = 0.0
    for event in prof.key_averages():
        if not str(getattr(event, "device_type", "")).endswith("CUDA"):
            continue
        device_us = getattr(event, "device_time_total", None)
        if device_us is None:
            device_us = getattr(event, "cuda_time_total", 0.0)
        if device_us <= 0:
            continue
        busy_us += device_us
        if event.key.startswith(("Memcpy", "Memset")):
            copies += event.count
        else:
            kernels += event.count
    return kernels / steps, copies / steps, busy_us / 1e3 / steps


def wolfe_problems(device):
    """The solves of the line-search phase, float32 at full width: ``{label:
    (make, mode, row)}`` as :func:`fused_problems`' (``make(fused) -> (solver,
    x0, gt)``), and the nearest-neighbour start of each for the PSNR floor."""
    dtype = torch.float32
    flagship = synthetic_scene(1, 1000, 1000, seed=2026)

    def flagship_solver(options, reg):
        def make(fused):
            model, gt, lows = make_observations(flagship, FLAGSHIP_SHIFTS, 4, 3, 1.5, device, dtype)
            solver = sr.IRLSMapSolver(dataclasses.replace(options, fused_irls=fused), model, lows, device=device,
                                      dtype=dtype)
            solver.add_regularizer(reg, 0.01)
            return solver, lows[0].repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1), gt
        return make

    def tv(method):
        # 3 x 50 with the stop thresholds at 0, as the linear-CG flagship.
        return dataclasses.replace(fixed_iterations(50, 3), least_squares_solver=method)

    def btv(method):
        return sr.IRLSMapSolverOptions(least_squares_solver=method, max_num_solver_iterations=20,
                                       max_num_irls_iterations=2)

    gt_rgb, lows_rgb = estimated_motion_problem(device)
    estimated = sr.translational_registration(lows_rgb, device=device).as_array() * 4

    def refined(fused):
        solver = estimated_motion_solver(lows_rgb, estimated, 1, device, rounds=2, iterations=20)
        solver.options.fused_irls = fused
        solver.options.least_squares_solver = "cg"
        return solver, linear_resize(lows_rgb[0], tuple(gt_rgb.shape[-2:])).contiguous(), gt_rgb

    problems = {}
    for method in ("cg", "lbfgs"):
        problems[f"flagship TV 1x1000x1000, 3 x 50, {method}"] = (
            flagship_solver(tv(method), TotalVariationRegularizer()), "data_term_tv", "K2")
        problems[f"flagship BTV 1x1000x1000, 2 x 20, {method}"] = (
            flagship_solver(btv(method), BilateralTotalVariationRegularizer(3, 0.5)), "data_term_btv", "K3")
    problems["refined estimated motion RGB 3x1000x1000, 2 x 20, cg"] = (refined, "data_term_btv", "K4")
    nearest = {"K2": None, "K3": None, "K4": lows_rgb[0].repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1)}
    return problems, nearest


# The autodiff solve on the card may lie this far from the same solve on the
# CPU, float64 (the bound of the acceptance criteria).
AUTODIFF_TOLERANCE = 1e-9
# finite_difference_grad's step, and the unit roundoff of float64.
FD_STEP = 1e-6
UNIT_ROUNDOFF = 2.0 ** -53


def _gradient_mode_solver(mode, side, regularizer, where, fused=False):
    """The gradient modes' float64 problem (``side`` x ``side``, 4 frames at
    2x, blur 3 / 1.0), 2 rounds x 10 iterations, and its nearest start."""
    model, _, lows = make_observations(synthetic_scene(1, side, side, seed=5), FLAGSHIP_SHIFTS, 2, 3, 1.0, where,
                                       torch.float64)
    options = sr.IRLSMapSolverOptions(diff_mode=mode, fused_irls=fused, max_num_irls_iterations=2,
                                      max_num_solver_iterations=10)
    solver = sr.IRLSMapSolver(options, model, lows, device=where, dtype=torch.float64)
    if regularizer is not None:
        solver.add_regularizer(regularizer, 0.01)
    return solver, lows[0].repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def _solve_off_the_kernels(solver, x0, label):
    before = dict(degrade.launch_counts)
    x = solver.solve(x0)
    check(dict(degrade.launch_counts) == before, f"the {label} solve launched the analytic kernels")
    return x.cpu(), [c[1:] for c in solver.last_inner_calls]


def _gradient_at(solver, x0, mode):
    """``(cost, gradient)`` of ``solver``'s data term at ``x0`` in ``mode``."""
    vg = make_map_value_and_grad(solver.observations, solver.shifts, solver.blur_kernel, solver.scale, (),
                                    diff_mode=mode, device=x0.device, dtype=torch.float64)
    cost, grad = vg(x0)
    return float(cost), grad.cpu()


def _gradient_mode_solves(device):
    """The gradient modes on the card, float64, each against the same solve
    on the CPU: ``autodiff`` (1x64x64, TV) through the host loop and through
    ``fused_irls`` (captured: bit-equal to the host loop), and ``numerical``
    (1x8x8, data term) held to a bound derived from the problem.

    The numerical bound. Every residual is the same elementwise float64 ops
    on both devices (the forward model is sums of shifted copies: no
    convolution, no reduction), so the cost differs only in the order of each
    frame's ``torch.sum`` over its n LR values: two orders of n nonnegative
    terms lie within 2 (n - 1) u f of each other (u = 2^-53). A central
    difference divides the two costs' differences by 2 h, so a gradient entry
    lies within ``dg = 2 (n - 1) u f / h`` (h = 1e-6): checked at the start.
    The solve's gain from such noise is read on the CPU: the data term is
    quadratic, so central differences have no truncation error there, and the
    numerical solve minus the autodiff solve is the solve's response to
    rounding noise of the measured size |g_fd - g_exact| at the start. The
    solve is held to that gain times ``dg``."""
    from super_resolution_tpu_torch.solvers import graphs

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    tv = TotalVariationRegularizer()
    out, captured = {}, []
    for label, where, fused in (("card", device, False), ("fused", device, True), ("fused", device, True),
                                ("cpu", cpu, False)):
        solver, x0 = _gradient_mode_solver("autodiff", 64, tv, where, fused)
        captures = graphs.capture_counts["graphs"]
        out.setdefault(label, []).append(_solve_off_the_kernels(solver, x0, "autodiff"))
        captured.append(graphs.capture_counts["graphs"] - captures)
    check(captured[1] > 0 and captured[2] == 0,
          f"fused autodiff: {captured[1]} graphs captured by the first instance, {captured[2]} by the second")
    (x_card, calls_card), = out["card"]
    (x_cpu, calls_cpu), = out["cpu"]
    diff = float((x_card - x_cpu).abs().max())
    check(diff <= AUTODIFF_TOLERANCE and calls_card == calls_cpu,
          f"autodiff solve on the card vs the CPU: {diff:.3e} (tol {AUTODIFF_TOLERANCE:g}), rounds {calls_card} vs "
          f"{calls_cpu}")
    for x_fused, calls_fused in out["fused"]:
        check(torch.equal(x_fused, x_card) and calls_fused == calls_card,
              f"fused autodiff solve vs the host loop on the card: {float((x_fused - x_card).abs().max()):.3e}, "
              f"rounds {calls_fused} vs {calls_card}")
    log(f"[10/13] autodiff solve 1x64x64 float64 on the card: within {diff:.2e} (tol {AUTODIFF_TOLERANCE:g}) of the "
        f"CPU's, same iterations and evaluations {calls_card}; fused_irls ({captured[1]} graphs captured, none by a "
        f"second instance) == host loop bit for bit ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    card, x0_card = _gradient_mode_solver("numerical", 8, None, device)
    host, x0 = _gradient_mode_solver("numerical", 8, None, cpu)
    exact, _ = _gradient_mode_solver("autodiff", 8, None, cpu)
    cost, g_cpu = _gradient_at(host, x0, "numerical")
    _, g_card = _gradient_at(card, x0_card, "numerical")
    _, g_exact = _gradient_at(exact, x0, "autodiff")
    n = host.observations[0].numel()
    dg = 2 * (n - 1) * UNIT_ROUNDOFF * cost / FD_STEP
    g_diff = float((g_card - g_cpu).abs().max())
    check(g_diff <= dg, f"numerical gradient at the start, card vs CPU: {g_diff:.3e} > the derived {dg:.3e}")
    x_card, calls_card = _solve_off_the_kernels(card, x0_card, "numerical")
    x_cpu, calls_cpu = _solve_off_the_kernels(host, x0, "numerical")
    x_exact, _ = _solve_off_the_kernels(exact, x0, "autodiff")
    noise = float((g_cpu - g_exact).abs().max())
    gain = float((x_cpu - x_exact).abs().max()) / noise if noise > 0 else 0.0
    bound = gain * dg
    diff = float((x_card - x_cpu).abs().max())
    check(diff <= bound and calls_card == calls_cpu,
          f"numerical solve on the card vs the CPU: {diff:.3e} (derived bound {bound:.3e}), rounds {calls_card} vs "
          f"{calls_cpu}")
    log(f"[10/13] numerical 1x8x8 float64 (n = {n}, f = {cost:.6g}): gradient at the start on the card within "
        f"{g_diff:.3e} of the CPU's (bound 2 (n-1) u f / h = {dg:.3e}); solve within {diff:.3e} (bound: gain "
        f"{gain:.4g} x {dg:.3e} = {bound:.3e}; gain = |x_fd - x_exact| / |g_fd - g_exact| on the CPU, "
        f"{noise:.3e} at the start), same iterations and evaluations {calls_card} "
        f"({time.perf_counter() - t0:.1f} s)")


def phase_wolfe(device, rows, turns=2):
    """The line-search solvers under the fused solve: ``cg`` and ``lbfgs``
    chunks of line-search trials replayed as CUDA graphs, beside the host
    loop that takes the same steps with one read-back per evaluation, in
    turns. Held as the fused phase holds ``linear_cg`` (bit-equal x and
    shifts, equal iterations and evaluations per round, launches counted
    through the replays, no late fold, read-backs <= chunks + rounds, one
    capture across two instances) and to PSNR >= nearest + 1 dB. Logs wall,
    device busy, read-backs, evaluations per iteration, frozen evaluations,
    graph nodes per step and pinned memory; then fused ``cg`` against fused
    ``linear_cg`` in PSNR on the flagship; then the gradient modes."""
    from super_resolution_tpu_torch.solvers import graphs, irls as irls_mod

    irls_mod._BUILT_SOLVER_CACHE.clear()
    t_phase = time.perf_counter()
    problems, nearest = wolfe_problems(device)
    log(f"[10/13] line-search solvers: problems made in {time.perf_counter() - t_phase:.1f} s")
    degrade.reset_launch_counts()
    results, launches = {}, {}
    for label, (make, mode, row) in problems.items():
        t_label = time.perf_counter()
        counted = degrade.launch_counts[mode]
        first, x0, gt = make(True)
        reserved = _reserved_bytes(device)
        captures = graphs.capture_counts["graphs"]
        _, x_first, _ = _fused_solve(first, x0, mode)  # captures
        pinned_mb = (_reserved_bytes(device) - reserved) / 2**20
        captured = graphs.capture_counts["graphs"] - captures
        second, _, _ = make(True)
        _, x_second, _ = _fused_solve(second, x0, mode)
        check(graphs.capture_counts["graphs"] == captures + captured,
              f"{label}: a second solver instance of the same shape captured again")
        reference, _, _ = make(False)
        _, x_ref = _timed(reference, x0)
        _same_solve(label, reference, first, x_ref, x_first)
        _same_solve(label, reference, second, x_ref, x_second)
        host_s, fused_s = [], []
        for _ in range(turns):
            host, _, _ = make(False)
            seconds, x = _timed(host, x0)
            check(torch.equal(x, x_ref), f"{label}: two host-loop solves differ")
            host_s.append(seconds)
            fused, _, _ = make(True)
            seconds, x, executed = _fused_solve(fused, x0, mode)
            _same_solve(label, host, fused, x_ref, x)
            fused_s.append(seconds)
        # The fused solves' launches (replays counted), the host loop's taken out.
        grown = degrade.launch_counts[mode] - counted - (turns + 1) * sum(c[2] for c in host.last_inner_calls)
        check(grown > 0, f"the fused {label} solve never launched {mode} ({row})")
        launches[row] = launches.get(row, 0) + grown
        start = x0 if nearest[row] is None else nearest[row]
        psnr_fused, psnr_start = float(psnr(x, gt)), float(psnr(start, gt))
        check(psnr_fused >= psnr_start + 1.0, f"{label}: PSNR {psnr_fused:.2f} dB, nearest {psnr_start:.2f} dB")
        runs = fused.last_fused_runs
        iterations = fused.last_inner_iterations
        rounds = len(fused.last_inner_calls)
        evaluations = sum(c[2] for c in fused.last_inner_calls)
        host_readbacks = evaluations + rounds  # one per evaluation (the start's included), one per round
        readbacks = sum(run["readbacks"] for run in runs)
        chunks = sum(run["chunks"] for run in runs)
        step = fused.last_fused.chunks[runs[0]["chunk_steps"]]
        kernels, copies, step_ms = _graph_nodes_per_step(step, runs[0]["chunk_steps"], device)
        med_h, med_f = float(np.median(host_s)), float(np.median(fused_s))
        log(f"[10/13] {label}: {iterations} iterations, {evaluations} evaluations ({evaluations / iterations:.2f} "
            f"per iteration, the starts included) in {rounds} rounds; fused == host loop bit for bit "
            f"(x and shifts, {turns + 2} pairs); PSNR {psnr_fused:.2f} dB (nearest {psnr_start:.2f})")
        log(f"      wall median host {med_h:.4f} s [{min(host_s):.4f}, {max(host_s):.4f}], fused {med_f:.4f} s "
            f"[{min(fused_s):.4f}, {max(fused_s):.4f}] ({med_h / med_f:.2f}x); read-backs host {host_readbacks}, "
            f"fused {readbacks} ({chunks} chunks of {runs[0]['chunk_steps']} steps + {rounds} rounds); "
            f"{executed - evaluations} frozen evaluations; {captured} graphs captured, 0 by the second instance; "
            f"pinned {pinned_mb:.0f} MB; a chunk step is {kernels:.1f} kernel + {copies:.1f} copy/set nodes, "
            f"{step_ms:.4f} ms of device time ({time.perf_counter() - t_label:.1f} s)")
        results[label] = {"host_s": host_s, "fused_s": fused_s, "readbacks": readbacks,
                          "host_readbacks": host_readbacks, "pinned_mb": pinned_mb, "psnr": psnr_fused,
                          "evaluations": evaluations, "iterations": iterations, "frozen": executed - evaluations,
                          "kernel_nodes_per_step": kernels, "copy_nodes_per_step": copies, "step_ms": step_ms}
    for row in rows:
        if row["row"] in launches:
            row["launches_fused_line_search"] = launches[row["row"]]

    # Device busy per solve, host loop and fused, from the profiler (last: its tracing can slow later launches).
    t_busy = time.perf_counter()
    fmt = lambda ms: "not measured" if ms is None else f"{ms:.2f} ms"  # noqa: E731
    for label, (make, _, _) in problems.items():
        host, x0, _ = make(False)
        host_busy = _device_busy_ms(lambda: host.solve(x0), device)
        fused = make(True)[0]
        fused_busy = _device_busy_ms(lambda: fused.solve(x0), device)
        results[label].update(host_busy_ms=host_busy, fused_busy_ms=fused_busy)
        median = float(np.median(results[label]["fused_s"]))
        share = "" if fused_busy is None else f" ({100 * fused_busy / 1e3 / median:.0f} % of the fused wall median)"
        log(f"      device busy, {label}: host loop {fmt(host_busy)}, fused {fmt(fused_busy)}{share}")
    log(f"      (device busy measured in {time.perf_counter() - t_busy:.1f} s)")

    # A line, not a check: fused cg against fused linear_cg on the flagship TV.
    linear = dataclasses.replace(fixed_iterations(50, 3), fused_irls=True)
    model, gt, lows = make_observations(synthetic_scene(1, 1000, 1000, seed=2026), FLAGSHIP_SHIFTS, 4, 3, 1.5,
                                        device, torch.float32)
    solver = sr.IRLSMapSolver(linear, model, lows, device=device, dtype=torch.float32)
    solver.add_regularizer(TotalVariationRegularizer(), 0.01)
    x_linear = solver.solve(lows[0].repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1))
    psnr_linear = float(psnr(x_linear, gt))
    psnr_cg = results["flagship TV 1x1000x1000, 3 x 50, cg"]["psnr"]
    log(f"      flagship TV 3 x 50, fused: cg {psnr_cg:.2f} dB, linear_cg {psnr_linear:.2f} dB "
        f"({psnr_cg - psnr_linear:+.2f} dB)")
    results["psnr_cg_minus_linear_cg"] = psnr_cg - psnr_linear
    irls_mod._BUILT_SOLVER_CACHE.clear()
    _gradient_mode_solves(device)
    log(f"[10/13] line-search phase: {time.perf_counter() - t_phase:.1f} s")
    return results


# -------------------------------------------------------------- the entry points

# Phase 11's steps, each driven through a command-line entry point, and the
# rows (kernel modes) each one's launches are read into.
ENTRY_ROWS = {"K1": ("admm",), "K2": ("flagship_fused", "default_cg"), "K4": ("rgb_estimated",),
              "K5": ("wavelet", "envi_pca"), "K6": ("envi_3dtv",)}
ADMM_ITERATIONS, ADMM_CG_ITERATIONS = 30, 10
ADMM_TOLERANCE = 1e-9
WAVELET_TOLERANCE = 1e-9
ENVI_READ_REPEATS = 5


def _cli_step(label, main, argv, card, device):
    """One run of a CLI's ``main(argv)`` on the card inside
    ``degrade.recording_launches()``: (its standard output, wall seconds,
    evaluations by mode, and by where their shifts came from). The plain
    version may not run."""
    out = io.StringIO()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with degrade.recording_launches() as record, contextlib.redirect_stdout(out):
        rc = main(argv)
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    check(rc == 0, f"{label}: the CLI returned {rc}")
    counts, sources, _, plain = record.counts
    check(plain["calls"] == 0, f"{label}: the plain version ran {plain['calls']} times on the card")
    log(f"[11/13] entry point {label}: {seconds:.3f} s wall ({card}); evaluations by mode "
        f"{ {k: v for k, v in counts.items() if v} } (2 kernel launches each)")
    return out.getvalue(), seconds, counts, sources


def _scores(text):
    """The ``PSNR/SSIM score on ...`` lines of the CLI's output."""
    return {line.split(":")[0].strip(): float(line.split(":")[1]) for line in text.splitlines() if "score on" in line}


def _check_psnr(label, text):
    scores = _scores(text)
    up, res = scores["PSNR score on upsampled"], scores["PSNR score on result"]
    check(res >= up + 1.0, f"{label}: PSNR {res:.2f} dB does not beat the upsampled image's {up:.2f} dB by 1 dB")
    return scores


def _envi(path, device="cpu"):
    loader = envi.HyperspectralDataLoader(path + ".config", device=device)
    loader.load_image_from_envi_file()
    return loader.get_image().hidden_array


def _direct_flagship(scene_png, motion_path, options, device):
    """The flagship solve of steps (a) and (b) through ``IRLSMapSolver``
    itself, on the same loaded image: (estimate, evaluations)."""
    params = dict(scale=4, blur_radius=3, blur_sigma=1.5, motion_sequence_path=motion_path)
    hr = load_image(scene_png, device=device)
    model = sr.ImageModel.create(sr.ImageModelParameters(**params))
    lows = [hr._with_array(model.apply(hr.array, i).contiguous()) for i in range(4)]
    solver = sr.IRLSMapSolver(options, model, lows, device=device, dtype=torch.float32)
    solver.add_regularizer(TotalVariationRegularizer(), 0.01)
    x = solver.solve(lows[0].resized(4.0, method="linear"))
    return x.array, sum(call[2] for call in solver.last_inner_calls)


def _admm_card_against_cpu(device, side=256):
    """``admm_solve`` in float64 on the card and on the CPU (the plain
    version): max|difference| over the largest entry."""
    xs = []
    for where in (device, torch.device("cpu")):
        model, gt, lows = make_observations(synthetic_scene(1, side, side, seed=2026), FLAGSHIP_SHIFTS, 4, 3, 1.5,
                                            where, torch.float64)
        x0 = lows[0].repeat_interleave(4, dim=-2).repeat_interleave(4, dim=-1).contiguous()
        xs.append(admm_solve(x0, torch.stack(lows), np.asarray(FLAGSHIP_SHIFTS, dtype=np.float64),
                             model.blur_operator.kernel, 4, tv_lambda=0.01, rho=1.0, num_iterations=ADMM_ITERATIONS,
                             cg_iterations=ADMM_CG_ITERATIONS).x.cpu())
    return float((xs[0] - xs[1]).abs().max()) / float(xs[1].abs().max())


def _wavelet_float64(argv, device):
    """The wavelet-domain CLI run of ``argv`` in float64, on the card and
    on the CPU: {"card": x, "cpu": x}, each the float64 output of
    ``_solve_in_wavelet_domain`` (on the CPU)."""
    real = super_resolve_cli._solve_in_wavelet_domain
    out = {}
    for where in ("card", "cpu"):
        def keep(*args, where=where):
            result = real(*args)
            out[where] = result.hidden_array.cpu()
            return result

        argv_ = argv + ["--dtype", "float64"] + (["--device", "cpu"] if where == "cpu" else [])
        with mock.patch.object(super_resolve_cli, "_solve_in_wavelet_domain", keep), \
                contextlib.redirect_stdout(io.StringIO()):
            check(super_resolve_cli.main(argv_) == 0, f"wavelet: the float64 run on the {where} failed")
        check(out[where].dtype == torch.float64, f"wavelet: the {where} run did not solve in float64")
    return out


def _envi_read_ms(bsq, device):
    """Median milliseconds of a whole-cube read onto the card as the ENVI
    loader makes it (the read, then ``ImageData`` on the device), native and
    through the numpy memmap, each after one warm read (the file in the page
    cache)."""
    times = {}
    for name, read in (("native", envi.read_cube_native), ("memmap", envi.read_cube_numpy)):
        laps = []
        for _ in range(ENVI_READ_REPEATS + 1):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            ImageData(read(*bsq), normalize="never", channel_major=True, device=device)
            torch.cuda.synchronize(device)
            laps.append((time.perf_counter() - t0) * 1e3)
        times[name] = float(np.median(laps[1:]))
    return times


def phase_entry_points(device, rows, card, side=1000, hsi_side=256):
    """The port's command-line entry points at full width, each step run
    through ``main(argv)`` on inputs written by the port's own writers: the
    flagship through ``super_resolve`` under ``--fused_irls`` and with the
    default ``cg`` host loop (both bit-equal to the same solve through
    ``IRLSMapSolver``), ADMM (its evaluation count, and card against CPU in
    float64), the refined RGB scene from a PNG directory, the wavelet-domain
    solve (card against CPU in float64), a 64-band ENVI cube with 3D TV and
    in PCA space (its native and memmap reads timed), and
    ``generate_data`` then ``shift_add_fusion`` (bit-equal to the CPU).
    ``side`` / ``hsi_side``: the HR scenes' and the cube's side."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    steps = {}
    try:
        scene_png = os.path.join(tmp, "scene.png")
        save_image(ImageData(synthetic_scene(1, side, side, seed=2026), channel_major=True, device=device), scene_png)
        motion = os.path.join(tmp, "flagship_shifts.txt")
        MotionShiftSequence(FLAGSHIP_SHIFTS).save_sequence_to_file(motion)
        flagship = ["--data_path", scene_png, "--generate_lr_images", "--number_of_frames", "4",
                    "--upsampling_scale", "4", "--blur_radius", "3", "--blur_sigma", "1.5",
                    "--motion_sequence_path", motion, "--regularizer", "tv", "--regularization_parameter", "0.01",
                    "--evaluators", "psnr,ssim", "--device", str(device)]
        fixed = ["--gradient_norm_threshold", "0", "--cost_decrease_threshold", "0",
                 "--parameter_variation_threshold", "0"]

        # (a) the flagship, fused, and (b) the default options' host loop of cg:
        # each bit-equal to the same solve through IRLSMapSolver.
        for label, extra, options in (
            ("flagship_fused", ["--solver", "linear_cg", "--optimization_iterations", "3", "--solver_iterations", "50",
                                *fixed, "--fused_irls"],
             dataclasses.replace(fixed_iterations(50, 3), fused_irls=True)),
            ("default_cg", ["--solver", "cg", "--optimization_iterations", "2", "--solver_iterations", "20"],
             sr.IRLSMapSolverOptions(least_squares_solver="cg", max_num_solver_iterations=20,
                                     max_num_irls_iterations=2)),
        ):
            result = os.path.join(tmp, f"{label}.bsq")
            text, seconds, counts, _ = _cli_step(label, super_resolve_cli.main,
                                                 flagship + extra + ["--result_path", result], card, device)
            scores = _check_psnr(label, text)
            direct, evaluations = _direct_flagship(scene_png, motion, options, device)
            cli_x = _envi(result)
            same = torch.equal(cli_x, direct.cpu())
            log(f"      {label}: PSNR {scores['PSNR score on result']:.4f} dB (upsampled "
                f"{scores['PSNR score on upsampled']:.4f}), SSIM {scores['SSIM score on result']:.4f}; "
                f"{counts['data_term_tv']} TV evaluations = the direct solve's {evaluations}; bit-equal to the "
                f"direct IRLSMapSolver solve: {same}")
            check(same, f"{label}: the CLI's result differs from the direct solve's "
                        f"(max|diff| {float((cli_x - direct.cpu()).abs().max()):.3e})")
            check(counts["data_term_tv"] == evaluations > 0,
                  f"{label}: {counts['data_term_tv']} TV evaluations counted, the solve made {evaluations}")
            steps[label] = dict(seconds=seconds, counts=counts)
        log(f"      the default options' host loop of cg (2 x 20) took {steps['default_cg']['seconds']:.3f} s against "
            f"{steps['flagship_fused']['seconds']:.3f} s for the fused flagship (3 x 50) ({card})")

        # (c) ADMM: 2 + cg evaluations an iteration, every one on the data-term kernels.
        text, seconds, counts, _ = _cli_step("admm", super_resolve_cli.main, flagship + [
            "--solver", "admm", "--solver_iterations", str(ADMM_ITERATIONS),
            "--admm_cg_iterations", str(ADMM_CG_ITERATIONS)], card, device)
        expected = ADMM_ITERATIONS * (2 + ADMM_CG_ITERATIONS)
        check(counts["data_term"] == expected and sum(counts.values()) == expected,
              f"admm: {counts} evaluations, expected {expected} of the data term")
        scores = _check_psnr("admm", text)
        rel = _admm_card_against_cpu(device)
        log(f"      admm {ADMM_ITERATIONS} x {ADMM_CG_ITERATIONS}: {expected} data-term evaluations = "
            f"{2 * expected} kernel launches; PSNR {scores['PSNR score on result']:.4f} dB (upsampled "
            f"{scores['PSNR score on upsampled']:.4f}); float64 1x256x256 card vs CPU max|diff| / max|x| "
            f"{rel:.3e} (tol {ADMM_TOLERANCE:g})")
        check(rel <= ADMM_TOLERANCE, f"admm: card and CPU differ by {rel:.3e} of the largest entry")
        steps["admm"] = dict(seconds=seconds, counts=counts)

        # (d) the RGB scene of phase 6 from a PNG directory: registered, refined, BTV on the luminance.
        gt, lows = estimated_motion_problem(device, side=side)
        frames = os.path.join(tmp, "rgb_frames")
        os.makedirs(frames)
        for i, low in enumerate(lows):
            save_image(ImageData(low, normalize="never", channel_major=True), os.path.join(frames, f"frame_{i}.png"))
        truth = os.path.join(tmp, "rgb_truth.png")
        save_image(ImageData(gt, normalize="never", channel_major=True), truth)
        text, seconds, counts, sources = _cli_step("rgb_estimated", super_resolve_cli.main, [
            "--data_path", frames, "--ground_truth_image", truth, "--upsampling_scale", "4", "--blur_radius", "3",
            "--blur_sigma", "1.5", "--interpolate_color", "--estimate_motion", "--refine_motion", "1",
            "--regularizer", "btv", "--solver", "linear_cg", "--optimization_iterations", "2",
            "--solver_iterations", "20", "--evaluators", "psnr,ssim", "--verbose", "--device", str(device)],
            card, device)
        check("Refined motion against the HR estimate" in text, "rgb_estimated: the motion was not refined")
        check(counts["data_term_btv"] > 0, "rgb_estimated: the BTV kernels (K4) were never launched")
        check(sources == {"device": counts["data_term_btv"], "host": 0},
              f"rgb_estimated: the shifts of {sources['host']} evaluations crossed from the host")
        scores = _check_psnr("rgb_estimated", text)
        log(f"      rgb_estimated: PSNR {scores['PSNR score on result']:.4f} dB (upsampled "
            f"{scores['PSNR score on upsampled']:.4f})")
        steps["rgb_estimated"] = dict(seconds=seconds, counts=counts)

        # (e) the wavelet domain: the 4 subbands as channels of one solve (K5),
        # in float32 as the CLI's default; then in float64 on the card and on
        # the CPU, held element-wise (the solve's own output, before the
        # float32 ENVI storage).
        wavelet = flagship + ["--solve_in_wavelet_domain", "--solver", "linear_cg", "--optimization_iterations", "2",
                              "--solver_iterations", "20"]
        result = os.path.join(tmp, "wavelet_card.bsq")
        text, seconds, counts, _ = _cli_step("wavelet", super_resolve_cli.main, wavelet + ["--result_path", result],
                                             card, device)
        check(counts["data_term_tv"] > 0, "wavelet: the TV kernels were never launched")
        card_x = _envi(result)
        check(card_x.shape == (1, side, side) and bool(torch.isfinite(card_x).all()), "wavelet: bad output")
        wide = _wavelet_float64(wavelet, device)
        scale = float(wide["cpu"].abs().max())
        rel64 = float((wide["card"] - wide["cpu"]).abs().max()) / scale
        rel32 = float((card_x.double() - wide["card"]).abs().max()) / scale
        # The same float32 run on the CPU (the plain version), for the size of its own rounding.
        with contextlib.redirect_stdout(io.StringIO()):
            check(super_resolve_cli.main(wavelet + ["--result_path", result + ".cpu", "--device", "cpu"]) == 0,
                  "wavelet: the float32 CPU run failed")
        cpu32 = _envi(result + ".cpu").double()
        rel32_cpu = float((cpu32 - wide["cpu"]).abs().max()) / scale
        rel32_apart = float((cpu32 - card_x.double()).abs().max()) / scale
        scores = _scores(text)
        log(f"      wavelet (4 x {side // 2} x {side // 2} subband stack): PSNR {scores['PSNR score on result']:.4f} dB "
            f"(upsampled {scores['PSNR score on upsampled']:.4f}: the wavelet-domain solve does not beat it, in the "
            f"JAX package neither); float64 card vs CPU max|diff| / max|x| {rel64:.3e} (tol {WAVELET_TOLERANCE:g}); "
            f"float32 vs float64: {rel32:.3e} on the card, {rel32_cpu:.3e} on the CPU; float32 card vs CPU "
            f"{rel32_apart:.3e} (float32 rounding carried through the solve)")
        check(rel64 <= WAVELET_TOLERANCE, f"wavelet: card and CPU differ by {rel64:.3e} of the largest entry in float64")
        steps["wavelet"] = dict(seconds=seconds, counts=counts)

        # (f) a 64-band ENVI cube: 3D TV (K6), then the PCA space (K5 on 4 components).
        _, cube, _ = pca_problem(device, side=hsi_side)
        cube_path = os.path.join(tmp, "cube.bsq")
        envi.HyperspectralDataLoader(cube_path).save_image(cube)
        header = envi.read_envi_header(cube_path + ".hdr")
        bands, rows_, cols = header.num_data_bands, header.num_data_rows, header.num_data_cols
        bsq = (cube_path, bands, rows_, cols, (0, bands), (0, rows_), (0, cols), 0, False)
        check(np.array_equal(envi.read_cube_native(*bsq), envi.read_cube_numpy(*bsq)),
              "ENVI: the native and numpy reads differ")
        read_ms = _envi_read_ms(bsq, device)
        log(f"      envi: a {bands}x{rows_}x{cols} float32 cube read whole onto the card, median of "
            f"{ENVI_READ_REPEATS}: native {read_ms['native']:.3f} ms, numpy memmap {read_ms['memmap']:.3f} ms ({card})")
        hsi = ["--data_path", cube_path + ".config", "--generate_lr_images", "--upsampling_scale", "2",
               "--blur_radius", "3", "--blur_sigma", "1.5", "--motion_sequence_path", motion,
               "--regularization_parameter", "0.01", "--solver", "linear_cg", "--optimization_iterations", "2",
               "--solver_iterations", "20", "--evaluators", "psnr", "--device", str(device)]
        text, seconds, counts, _ = _cli_step("envi_3dtv", super_resolve_cli.main, hsi + ["--regularizer", "3dtv"],
                                             card, device)
        check(counts["data_term_tv3d"] > 0, "envi_3dtv: the 3D TV kernels (K6) were never launched")
        scores = _check_psnr("envi_3dtv", text)
        steps["envi_3dtv"] = dict(seconds=seconds, counts=counts)
        result = os.path.join(tmp, "pca.bsq")
        text, seconds, counts, _ = _cli_step("envi_pca", super_resolve_cli.main, hsi + [
            "--solve_in_pca_space", "--num_pca_components", "4", "--result_path", result], card, device)
        check(counts["data_term_tv"] > 0, "envi_pca: the TV kernels (K5) were never launched")
        # Scored inside the border band, as phase 7 scores it (Queue 3 of ROADMAP.md: the
        # projected frames do not fit the zero borders of warp and blur).
        solved = _envi(result)
        gt_cube = load_image(cube_path + ".config", device="cpu").array
        model = sr.ImageModel.create(sr.ImageModelParameters(scale=2, blur_radius=3, blur_sigma=1.5,
                                                             motion_sequence_path=motion))
        linear = linear_resize(model.apply(gt_cube, 0), (hsi_side, hsi_side))
        inner = (slice(None), slice(PCA_BORDER, -PCA_BORDER), slice(PCA_BORDER, -PCA_BORDER))
        solved_db, linear_db = float(psnr(solved[inner], gt_cube[inner])), float(psnr(linear[inner], gt_cube[inner]))
        log(f"      envi: native and numpy reads equal; 3D TV PSNR {scores['PSNR score on result']:.4f} dB (upsampled "
            f"{scores['PSNR score on upsampled']:.4f}); PCA space {solved_db:.4f} dB vs linear {linear_db:.4f} dB "
            f"inside a {PCA_BORDER}-px border (whole image: {_scores(text)})")
        check(solved_db >= linear_db + 1.0, "envi_pca: the PCA-space solve does not beat linear upsampling by 1 dB")
        steps["envi_pca"] = dict(seconds=seconds, counts=counts)

        # (g) generate_data, then shift_add_fusion, on the card and on the CPU: the same bits.
        fused = {}
        for where in (str(device), "cpu"):
            lr_dir = os.path.join(tmp, f"lr_{where}")
            fused[where] = os.path.join(tmp, f"fused_{where}.png")
            gen = ["--input_image", scene_png, "--output_image_dir", lr_dir, "--upsampling_scale", "4",
                   "--blur_radius", "3", "--blur_sigma", "1.5", "--motion_sequence_path", motion, "--device", where]
            fuse = ["--input_image_dir", lr_dir, "--input_motion_sequence", motion, "--upsampling_scale", "4",
                    "--result_path", fused[where], "--device", where]
            if where != "cpu":
                _, seconds, _, _ = _cli_step("generate_data", generate_data_cli.main, gen, card, device)
                _, fuse_seconds, _, _ = _cli_step("shift_add_fusion", shift_add_cli.main, fuse, card, device)
                steps["generate_data"], steps["shift_add_fusion"] = dict(seconds=seconds), dict(seconds=fuse_seconds)
            else:
                with contextlib.redirect_stdout(io.StringIO()):
                    check(generate_data_cli.main(gen) == 0 and shift_add_cli.main(fuse) == 0, "the CPU CLIs failed")
        for i in range(4):
            check(np.array_equal(read_image(os.path.join(tmp, f"lr_{device}", f"low_res_{i}.png")),
                                 read_image(os.path.join(tmp, "lr_cpu", f"low_res_{i}.png"))),
                  f"generate_data: frame {i} differs between card and CPU")
        card_png, cpu_png = read_image(fused[str(device)]), read_image(fused["cpu"])
        check(card_png.shape == (side, side) and np.array_equal(card_png, cpu_png),
              "shift_add_fusion: the card's fused PNG differs from the CPU's")
        log(f"      generate_data -> shift_add_fusion: 4 LR frames and the fused {side}x{side} PNG bit-equal on card and CPU")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for row in rows:
        row["launches_entry_points"] = sum(steps[step]["counts"][row["mode"]] for step in ENTRY_ROWS.get(row["row"], ()))
        check(row["row"] not in ENTRY_ROWS or row["launches_entry_points"] > 0,
              f"the entry points never launched {row['mode']} ({row['row']})")
    log(f"[11/13] entry points: {time.perf_counter() - t_phase:.1f} s; wall by step "
        f"{ {k: round(v['seconds'], 3) for k, v in steps.items()} } ({card}); evaluations by row "
        f"{ {r['row']: r['launches_entry_points'] for r in rows} }")
    return steps


# ------------------------------------------------------------------------- video

VIDEO_FRAMES = 12
VIDEO_LR_HW = (540, 960)        # LR 3x540x960 -> HR 3x1080x1920
VIDEO_SCALE = 2
VIDEO_DRIFT = (0.6, -0.35)      # HR px a frame (dx, dy), plus seeded jitter
VIDEO_JITTER = 0.5
VIDEO_BORDER = 16               # PSNR inside this border; also the scene's margin
VIDEO_SMALL_LR_HW = (135, 240)  # (c): HR 3x270x480 in float64, card against CPU
VIDEO_CENTER = 5
VIDEO_TOLERANCE = 1e-9
VIDEO_TURNS = 3
VIDEO_TRACED_WINDOWS = 3
VIDEO_FIXTURE = os.path.join("tests", "data_torch", "mjpeg_160x120x8.avi")
# The SHA-256 of the port's decode of the fixture, as tests/test_torch_video.py records it.
VIDEO_FIXTURE_SHA256 = "2e73a5dd9b4206cdc215e3c8b8f8fb5cb69678eb48184e53581eaa7d6882f16c"
VIDEO_FIXTURE_SHAPE = (8, 120, 160, 3)


def video_problem(device, dtype, lr_hw=VIDEO_LR_HW, frames=VIDEO_FRAMES, seed=41):
    """A seeded RGB scene panned by a known fractional drift: the ground truth
    of each frame ``[K, 3, H, W]`` and its LR frame ``[K, 3, h, w]`` (blur
    3 / 1.0, decimation by 2 through the port's image model), on ``device``,
    and the true shifts ``[K, 2]`` in HR px."""
    h, w = lr_hw[0] * VIDEO_SCALE, lr_hw[1] * VIDEO_SCALE
    m = VIDEO_BORDER
    rng = np.random.default_rng(seed)
    shifts = np.arange(frames)[:, None] * np.asarray(VIDEO_DRIFT) + rng.uniform(-VIDEO_JITTER, VIDEO_JITTER,
                                                                                 (frames, 2))
    shifts -= shifts.mean(axis=0)  # a pan about the middle of the clip
    scene = torch.as_tensor(synthetic_scene(3, h + 2 * m, w + 2 * m, seed=seed), dtype=dtype, device=device)
    truth = torch.stack([translate(scene, float(dx), float(dy))[:, m:m + h, m:m + w] for dx, dy in shifts])
    model = sr.ImageModel.create(sr.ImageModelParameters(
        scale=VIDEO_SCALE, blur_radius=3, blur_sigma=1.0, motion_sequence=MotionShiftSequence([(0, 0)])))
    lows = torch.stack([model.apply(t, 0) for t in truth]).contiguous()
    return truth, lows, shifts


def _video_run(resolver, stack, device, windows=None):
    """Output frames of ``stack`` through ``resolver.super_resolve_frame``,
    each timed with the device synchronised: (outputs, seconds per frame,
    per window its inner calls and fused runs)."""
    outs, seconds, info = [], [], []
    for i in range(stack.shape[0] if windows is None else windows):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        outs.append(resolver.super_resolve_frame(stack, i))
        torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        solver = resolver.last_solver
        info.append({"calls": [c[1:] for c in solver.last_inner_calls],
                     "evaluations": sum(c[2] for c in solver.last_inner_calls),
                     "runs": solver.last_fused_runs if resolver.solver_options.fused_irls else None,
                     "captures": graphs.capture_counts["graphs"]})
    return torch.stack(outs), seconds, info


def _registration_probe(device):
    """A stand-in for the resolver's ``translational_registration``, as a
    patch to enter, that times each call (device synchronised) and counts the
    synchronizing CUDA operations inside it (``torch.cuda.set_sync_debug_mode``
    warns at each): its read-backs. Returns (patch, seconds, read-backs)."""
    real = sr_video.super_resolver.translational_registration
    seconds, syncs = [], []

    def probe(*args, **kwargs):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                seq = real(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
        syncs.append(sum("synchronizing CUDA operation" in str(w.message) for w in caught))
        return seq

    return mock.patch.object(sr_video.super_resolver, "translational_registration", probe), seconds, syncs


def _trace_device_ms(path):
    """Milliseconds of device work in a Chrome trace written by
    ``utils.profiling.trace``: the sum of its kernel, memcpy and memset
    events, graph replays included; None if it holds none."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    busy = sum(float(e.get("dur", 0.0)) for e in events
               if e.get("ph") == "X" and str(e.get("cat", "")).lower() in ("kernel", "gpu_memcpy", "gpu_memset"))
    return busy / 1e3 if busy > 0 else None


def _median_range(values):
    return f"{float(np.median(values)):.4f} [{min(values):.4f}, {max(values):.4f}]"


def _video_card_against_cpu(device, options, label, blur_radius=3):
    """One window (frame ``VIDEO_CENTER``) of the reduced clip in float64 on
    the card and on the CPU: max|difference| over the largest entry."""
    _, lows, _ = video_problem("cpu", torch.float64, lr_hw=VIDEO_SMALL_LR_HW)
    card, cpu = [sr_video.VideoSuperResolver(solver_options=options, blur_radius=blur_radius, device=where,
                                             dtype=torch.float64).super_resolve_frame(lows.numpy(), VIDEO_CENTER).cpu()
                 for where in (device, torch.device("cpu"))]
    rel = float((card - cpu).abs().max()) / float(cpu.abs().max())
    log(f"      (c) {label}: float64 3x{2 * VIDEO_SMALL_LR_HW[0]}x{2 * VIDEO_SMALL_LR_HW[1]} window of frame "
        f"{VIDEO_CENTER}, card vs CPU max|diff| / max|x| {rel:.3e} (tol {VIDEO_TOLERANCE:g})")
    check(rel <= VIDEO_TOLERANCE, f"video {label}: card and CPU differ by {rel:.3e} of the largest entry")
    return rel


def phase_video(device, rows, card, lr_hw=VIDEO_LR_HW, frames=VIDEO_FRAMES):
    """Video super-resolution at full width: 12 LR frames 3x540x960 written
    as PNG by the port, loaded by ``VideoLoader``, super-resolved to
    3x1080x1920 per output frame by ``VideoSuperResolver`` with the JAX
    defaults (window 4, BTV(2, 0.7), 3 x 25 linear CG), host loop and
    ``fused_irls``: (a) PSNR >= linear + 1 dB inside a 16-px border on every
    frame; (b) fused bit-equal to the host loop, graphs captured for the
    first window only, no late fold, read-backs <= chunks + rounds a window
    and the registration's synchronizing operations counted, one a window; (c) float64 card against CPU on a reduced
    window, with blur and without blur under motion refinement; (d) the
    MJPEG fixture decoded to its recorded digest; (e) wall per frame, host
    loop and fused in turns, and under ``utils.profiling.trace`` the device's
    busy share, registration ms per window, one evaluation's time against
    its bound."""
    from super_resolution_tpu_torch.solvers import irls as irls_mod

    t_phase = time.perf_counter()
    dtype = torch.float32
    results = {}
    truth, lows, _ = video_problem(device, dtype, lr_hw, frames)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_video_")
    try:
        t0 = time.perf_counter()
        for i, low in enumerate(lows):
            save_image(ImageData(low, normalize="never", channel_major=True), os.path.join(tmp, f"frame_{i:03d}.png"))
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        loader = sr_video.VideoLoader(device=device)
        loader.load_frames_from_directory(tmp)
        stack = loader.frame_stack()
        torch.cuda.synchronize(device)
        t_load = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(tuple(stack.shape) == (frames, 3) + tuple(lr_hw) and stack.is_cuda, f"video: frame stack {stack.shape}")
    log(f"[12/13] video: {frames} LR frames {tuple(stack.shape[1:])} written as PNG in {t_write:.2f} s, loaded onto "
        f"the card by VideoLoader in {t_load:.2f} s")

    defaults = sr_video.VideoSuperResolver(device=device).solver_options
    host = sr_video.VideoSuperResolver(device=device)
    fused = sr_video.VideoSuperResolver(solver_options=dataclasses.replace(defaults, fused_irls=True), device=device)

    # (a) + (b): the host loop, then the fused solve, the counts set to 0 just before.
    irls_mod._BUILT_SOLVER_CACHE.clear()
    degrade.reset_launch_counts()
    x_host, _, info_host = _video_run(host, stack, device)
    captures0 = graphs.capture_counts["graphs"]
    probe, _, registration_readbacks = _registration_probe(device)
    with probe:
        x_fused, s_first, info_fused = _video_run(fused, stack, device)
    counts, sources, plain = dict(degrade.launch_counts), dict(degrade.shift_source_counts), \
        dict(degrade.plain_version_calls)
    late = fused.last_solver.last_fused.late()
    executed = sum(r["executed_evaluations"] for w in info_fused for r in w["runs"])
    host_evaluations = sum(w["evaluations"] for w in info_host)
    check(counts == {name: (host_evaluations + executed if name == "data_term_btv" else 0) for name in counts},
          f"video: launches {counts}, expected {host_evaluations} + {executed} BTV evaluations")
    check(sources == {"device": counts["data_term_btv"], "host": 0},
          f"video: the shifts of {sources['host']} evaluations crossed from the host")
    check(plain["calls"] == 0, f"video: the plain version ran {plain['calls']} times on the card")
    check(not late, "video: a cost fold stopped waiting (late flag) in a replay")
    launches_video = counts["data_term_btv"]

    captured = graphs.capture_counts["graphs"] - captures0
    per_window = [info_fused[0]["captures"] - captures0] + [
        b["captures"] - a["captures"] for a, b in zip(info_fused, info_fused[1:])]
    check(per_window[0] > 0 and not any(per_window[1:]),
          f"video: graphs captured per window {per_window}; only the first window may capture")
    for i, (h_info, f_info) in enumerate(zip(info_host, info_fused)):
        check(torch.equal(x_host[i], x_fused[i]),
              f"video frame {i}: fused differs from the host loop by {float((x_host[i] - x_fused[i]).abs().max()):.3e}")
        check(h_info["calls"] == f_info["calls"],
              f"video frame {i}: iterations / evaluations per round {f_info['calls']} vs {h_info['calls']}")
        for run in f_info["runs"]:
            check(run["readbacks"] <= run["chunks"] + len(run["rounds"]),
                  f"video frame {i}: {run['readbacks']} read-backs for {run['chunks']} chunks, {len(run['rounds'])} rounds")
    check(registration_readbacks == [1] * frames,
          f"video: registration read-backs per window {registration_readbacks}, expected one each")
    check(len(irls_mod._BUILT_SOLVER_CACHE) == 1, f"video: {len(irls_mod._BUILT_SOLVER_CACHE)} fused solves built")
    # Captures: all in the first window; the later windows replay.
    replays = [sum(r["replays"] for r in w["runs"]) for w in info_fused]
    chunks = [sum(r["chunks"] for r in w["runs"]) for w in info_fused]
    readbacks = [sum(r["readbacks"] for r in w["runs"]) for w in info_fused]
    rounds = [sum(len(r["rounds"]) for r in w["runs"]) for w in info_fused]
    captures_after_first = graphs.capture_counts["graphs"]
    evaluations = [w["evaluations"] for w in info_host]
    log(f"      (b) fused == host loop bit for bit on all {frames} frames, same iterations and evaluations per round; "
        f"{captured} graphs captured, all in the first window; one fused solve built (the cache served the {frames - 1} "
        f"later windows), "
        f"replays per window {replays}; read-backs per window {readbacks} (chunks {chunks} + rounds {rounds}) + "
        f"registration's {registration_readbacks} (synchronizing operations counted); no late fold; {launches_video} BTV evaluations (K4: shifts from device memory) "
        f"= {2 * launches_video} kernel launches ({host_evaluations} host loop + {executed} fused, frozen included)")

    # (a) PSNR inside the border against the ground truth, beside the linear upsample of the centre frame.
    b = VIDEO_BORDER
    inner = (slice(None), slice(b, -b), slice(b, -b))
    hr = tuple(truth.shape[-2:])
    gains = []
    for i in range(frames):
        res_db = float(psnr(x_host[i][inner], truth[i][inner]))
        lin_db = float(psnr(linear_resize(stack[i], hr)[inner], truth[i][inner]))
        check(bool(torch.isfinite(x_host[i]).all()) and x_host[i].shape == truth[i].shape, f"video frame {i}: bad output")
        check(res_db >= lin_db + 1.0, f"video frame {i}: PSNR {res_db:.2f} dB does not beat linear {lin_db:.2f} + 1 dB")
        gains.append((res_db, lin_db))
    log(f"      (a) PSNR inside a {b}-px border, result / linear upsample of the centre frame, dB: " + ", ".join(
        f"{r:.2f}/{l:.2f}" for r, l in gains))

    # (e) wall per output frame, host loop and fused in turns (the fused graphs captured above).
    walls = {"host": [], "fused": []}
    video_s = {"host": [], "fused": []}
    for _ in range(VIDEO_TURNS):
        for label, resolver in (("host", host), ("fused", fused)):
            out, seconds, _ = _video_run(resolver, stack, device)
            check(torch.equal(out, x_host), f"video: a timed {label} run differs from the first")
            walls[label] += seconds
            video_s[label].append(sum(seconds))
    check(graphs.capture_counts["graphs"] == captures_after_first, "video: a later fused run captured again")
    fps = {label: frames / float(np.median(v)) for label, v in video_s.items()}
    log(f"      (e) wall per output frame (3x{hr[0]}x{hr[1]}, median [min, max] of {VIDEO_TURNS} x {frames}, {card}): "
        f"host loop {_median_range(walls['host'])} s, fused {_median_range(walls['fused'])} s; "
        f"{fps['host']:.2f} / {fps['fused']:.2f} frames/s; evaluations per frame {int(np.median(evaluations))} "
        f"[{min(evaluations)}, {max(evaluations)}] "
        f"(first fused window with its captures: {s_first[0]:.4f} s)")

    # Under utils.profiling.trace: device busy share (from the trace it writes), wall, registration per window.
    probe, registration, _ = _registration_probe(device)
    busy = {}
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        for label, resolver in (("host", host), ("fused", fused)):
            with probe, trace(os.path.join(trace_dir, label)) as log_dir:
                _, seconds, _ = _video_run(resolver, stack, device, windows=VIDEO_TRACED_WINDOWS)
            busy[label] = (_trace_device_ms(os.path.join(log_dir, "trace.json")), sum(seconds) * 1e3)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    fmt = lambda v: "not measured" if v[0] is None else f"{v[0]:.1f} of {v[1]:.1f} ms ({100 * v[0] / v[1]:.0f} %)"  # noqa: E731
    log(f"      (e) under utils.profiling.trace, {VIDEO_TRACED_WINDOWS} windows each: device busy host loop "
        f"{fmt(busy['host'])}, fused {fmt(busy['fused'])}; registration per window (4 frames "
        f"{tuple(stack.shape[1:])}) {_median_range([1e3 * r for r in registration])} ms")

    # One evaluation at the video shape (K4's kernels at s = 2, P = 2): device time, wall, bound, plain version.
    solver = host.last_solver
    x = x_host[VIDEO_CENTER].contiguous()
    y = solver.observations
    sh_dev, sh = solver.shifts, solver.shifts.cpu().numpy()
    kern = solver.blur_kernel
    kern_dev = torch.as_tensor(kern, dtype=dtype, device=device)
    constants = torch.rand(x.shape, generator=torch.Generator(device).manual_seed(5), device=device, dtype=dtype) * 0.02
    kw = {"btv_constants": constants, "btv_range": host.btv_scale_range, "btv_decay": host.btv_spatial_decay}
    run = lambda: degrade.fused_objective(x, y, sh_dev, kern_dev, VIDEO_SCALE, **kw)  # noqa: E731
    plain = lambda: degrade.fused_objective_reference(x, y, sh, kern, VIDEO_SCALE, **kw)  # noqa: E731
    cost_err, grad_err, abs_err = _errors(run(), plain())
    check(cost_err <= TOLERANCE[dtype] and grad_err <= TOLERANCE[dtype],
          f"video shape: cost {cost_err:.3e}, grad {grad_err:.3e} against the plain version")
    ms = _time_launches(run, device, 100)
    plain_ms = _time_launches(plain, device, 3)
    wall_ms = device_time(run, iterations=50, warmup=5) * 1e3
    bound_ms, bound_by, nbytes, flops = _bound("data_term_btv", x, y, sh, kern, VIDEO_SCALE, dtype)
    per_kernel = _kernel_times(run, device)
    c_, h_, w_ = x.shape
    lib = degrade._library()
    partials = lib.sr_residual_blocks(c_, h_, w_, VIDEO_SCALE) + lib.sr_gradient_blocks(
        degrade._MODE_OF["data_term_btv"], c_, h_, w_, 0)
    bounds = _kernel_bounds_us(x, y, constants, "data_term_btv", partials)
    for name, info in per_kernel.items():
        info["bound_us"] = bounds[name]
    video_row = {"shape": f"C=3 HR={hr[0]}x{hr[1]} K=4 s=2 BTV P=2 float32", "ms": ms, "wall_ms": wall_ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": abs_err,
                 "launches": launches_video, "per_kernel": per_kernel}
    log(f"      (e) one evaluation at {video_row['shape']}: {ms:.4f} ms device time (utils.profiling.device_time "
        f"{wall_ms:.4f} ms a call with a synchronise), plain {plain_ms:.2f} ms, bound {bound_ms:.5f} ms by "
        f"{bound_by}; max abs err vs plain {abs_err:.2e}; per kernel (us per launch / own bound): "
        + (", ".join(f"{name} {info['us']:.2f} / {info['bound_us']:.2f}" for name, info in per_kernel.items())
           or "the profiler saw no device time"))
    for row in rows:
        if row["row"] == "K4":
            row["launches_video"] = launches_video
            row["video_shape"] = video_row
            row["max_abs_err"] = max(row["max_abs_err"], abs_err)

    # (c) float64, card against CPU: the JAX defaults, then no blur with the motion refined every round.
    rel_default = _video_card_against_cpu(device, None, "defaults")
    rel_refine = _video_card_against_cpu(device, dataclasses.replace(defaults, refine_motion_every=1),
                                         "blur_radius=0, refine_motion_every=1", blur_radius=0)

    # (d) the MJPEG fixture, decoded on the card's host.
    path = os.path.join(ROOT, VIDEO_FIXTURE)
    decode_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        decoded = read_avi_frames(path)
        decode_s.append(time.perf_counter() - t0)
    digest = hashlib.sha256(np.stack(decoded).tobytes()).hexdigest()
    check(np.stack(decoded).shape == VIDEO_FIXTURE_SHAPE and digest == VIDEO_FIXTURE_SHA256,
          f"video fixture: {np.stack(decoded).shape}, SHA-256 {digest}")
    fixture = sr_video.VideoLoader(device=device)
    fixture.load_frames_from_video(path)
    on_card = fixture.frame_stack()
    check(on_card.is_cuda and torch.equal(on_card.cpu(), torch.from_numpy(
        np.stack([np.moveaxis(f, -1, 0) for f in decoded]).astype(np.float64) / 255.0).to(dtype)),
        "video fixture: the frames on the card differ from the host decode")
    decode_ms = 1e3 * float(np.median(decode_s)) / len(decoded)
    log(f"      (d) MJPEG fixture {VIDEO_FIXTURE}: {len(decoded)} frames {decoded[0].shape}, SHA-256 as recorded by the "
        f"CPU tests; {decode_ms:.2f} ms per frame to decode on the host (median of 3)")

    results.update(walls=walls, fps=fps, busy=busy, registration=registration, evaluations=evaluations,
                   captured=captured, replays=replays, gains=gains, video_row=video_row, decode_ms=decode_ms,
                   rel=(rel_default, rel_refine))
    irls_mod._BUILT_SOLVER_CACHE.clear()
    log(f"[12/13] video: {time.perf_counter() - t_phase:.1f} s ({card})")
    return results


# ------------------------------------------------- the mesh under fused_irls (phase 8, extended)


def _mesh_fused_solve(solver, x0, mode, shard_counter):
    """One fused solve on a mesh, its launches held replay-aware: one count per
    shard and evaluation the replays ran (frozen chunk steps included), in
    ``mode`` and in the mesh mode ``shard_counter`` only, no plain version,
    no ``late`` flag, no more read-backs than chunks plus rounds."""
    before, before_shard = dict(degrade.launch_counts), dict(degrade.shard_launch_counts)
    before_plain = degrade.plain_version_calls["calls"]
    seconds, x = _timed(solver, x0)
    runs = solver.last_fused_runs
    executed = sum(run["executed_evaluations"] for run in runs)
    shards = solver.mesh.num_shards
    grown = {name: degrade.launch_counts[name] - before[name] for name in degrade.launch_counts}
    check(grown == {name: shards * executed if name == mode else 0 for name in grown},
          f"fused mesh {mode}: launches {grown}, but the replays ran {executed} evaluations on {shards} shards")
    for counter, count in degrade.shard_launch_counts.items():
        expected = shards * executed if counter == shard_counter else 0
        check(count - before_shard[counter] == expected,
              f"fused mesh {mode}: {count - before_shard[counter]} {counter} launches, expected {expected}")
    check(degrade.plain_version_calls["calls"] == before_plain, f"fused mesh {mode}: the solve called the plain version")
    check(not solver.last_fused.late(), f"fused mesh {mode}: a cost fold stopped waiting (late flag) in a replay")
    for run in runs:
        check(run["readbacks"] <= run["chunks"] + len(run["rounds"]),
              f"fused mesh {mode}: {run['readbacks']} read-backs for {run['chunks']} chunks and "
              f"{len(run['rounds'])} rounds")
    return seconds, x, executed


def mesh_fused_problems(device):
    """Phase 8's meshed solves, every shard on the card: ``{label: (make, mode,
    shard counter, row)}``, ``make(fused) -> (solver, x0, gt)``."""
    dtype = torch.float32
    model64, gt64, lows64 = hyperspectral_problem(device)
    model_rgb, gt_rgb, lows_rgb = tiled_problem(device)
    flagship = synthetic_scene(1, 1000, 1000, seed=2026)
    model_flag, gt_flag, lows_flag = make_observations(flagship, FLAGSHIP_SHIFTS, 4, 3, 1.5, device, dtype)
    gt_est, lows_est = estimated_motion_problem(device)
    estimated = sr.translational_registration(lows_est, device=device).as_array() * 4
    two_rounds = dataclasses.replace(fixed_iterations(20, 2), irls_cost_difference_threshold=0.0)

    def start(lows, gt):
        return linear_resize(lows[0], tuple(gt.shape[-2:])).contiguous()

    def band(fused):
        solver = tv_solver(model64, lows64, True, dataclasses.replace(two_rounds, fused_irls=fused), device,
                           mesh=make_mesh({"band": 4}, [device]))
        return solver, start(lows64, gt64), gt64

    def tiles(model, lows, gt, reg):
        def make(fused):
            solver = sr.IRLSMapSolver(dataclasses.replace(two_rounds, fused_irls=fused), model, lows, device=device,
                                      dtype=dtype, mesh=make_mesh({"row": 2, "col": 2}, [device]))
            solver.add_regularizer(reg, 0.01)
            return solver, start(lows, gt), gt
        return make

    def frames(fused):
        solver = estimated_motion_solver(lows_est, estimated, 1, device, 3, 20, dtype, make_mesh({"frame": 4}, [device]))
        solver.options.fused_irls = fused
        return solver, start(lows_est, gt_est), gt_est

    return {
        "band x4, 64 bands, 3D TV": (band, "data_term_tv3d", "spectral_halo", "K7b"),
        f"2x2 tiles, RGB 3x2048x2048, {TILED_FRAMES} frames, BTV": (
            tiles(model_rgb, lows_rgb, gt_rgb, BilateralTotalVariationRegularizer(3, 0.5)), "data_term_btv",
            "shard_mode", "K7a"),
        "2x2 tiles, flagship 1x1000x1000, TV": (
            tiles(model_flag, lows_flag, gt_flag, TotalVariationRegularizer()), "data_term_tv", "shard_mode", "K7a"),
        "frame x4, refined motion, RGB 3x1000x1000, BTV": (frames, "data_term_btv", None, "K4"),
    }


def phase_mesh_fused(device, rows, turns=3):
    """``fused_irls`` on phase 8's meshes beside the same mesh's host loop, in
    turns: bit-equal estimates and shifts, equal iterations and evaluations
    per round, launches counted through the replays on every shard, no late
    fold, one capture across two solver instances; walls, read-backs,
    captures, replays and pinned memory of each."""
    from super_resolution_tpu_torch.solvers import irls as irls_mod

    t_phase = time.perf_counter()
    irls_mod._BUILT_SOLVER_CACHE.clear()
    degrade.reset_launch_counts()
    results, launches = {}, {}
    for label, (make, mode, shard_counter, row) in mesh_fused_problems(device).items():
        counted = degrade.launch_counts[mode]
        first, x0, gt = make(True)
        reserved = _reserved_bytes(device)
        captures = graphs.capture_counts["graphs"]
        _, x_first, _ = _mesh_fused_solve(first, x0, mode, shard_counter)   # captures
        pinned_mb = (_reserved_bytes(device) - reserved) / 2**20
        captured = graphs.capture_counts["graphs"] - captures
        second, _, _ = make(True)
        _, x_second, _ = _mesh_fused_solve(second, x0, mode, shard_counter)
        check(graphs.capture_counts["graphs"] == captures + captured,
              f"fused mesh {label}: a second solver instance of the same shape captured again")
        reference, _, _ = make(False)
        _, x_ref = _timed(reference, x0)
        _same_solve(f"fused mesh {label}", reference, first, x_ref, x_first)
        _same_solve(f"fused mesh {label}", reference, second, x_ref, x_second)
        host_s, fused_s = [], []
        for _ in range(turns):
            host, _, _ = make(False)
            seconds, x = _timed(host, x0)
            check(torch.equal(x, x_ref), f"fused mesh {label}: two host-loop solves differ")
            host_s.append(seconds)
            fused, _, _ = make(True)
            seconds, x, executed = _mesh_fused_solve(fused, x0, mode, shard_counter)
            _same_solve(f"fused mesh {label}", host, fused, x_ref, x)
            fused_s.append(seconds)
        runs = fused.last_fused_runs
        iterations, rounds = fused.last_inner_iterations, len(fused.last_inner_calls)
        evaluations = sum(c[2] for c in fused.last_inner_calls)
        readbacks = sum(run["readbacks"] for run in runs)
        replays = sum(run["replays"] for run in runs)
        chunks = sum(run["chunks"] for run in runs)
        shards = fused.mesh.num_shards
        log(f"[8/13] fused mesh {label}: {fused.mesh.shape}, {iterations} iterations, {evaluations} evaluations in "
            f"{rounds} rounds; fused == host loop bit for bit (x and shifts, {turns + 2} pairs)")
        log(f"      wall host {_median_range(host_s)} s, fused {_median_range(fused_s)} s; read-backs host "
            f"{iterations + 2 * rounds}, fused {readbacks} ({chunks} chunks + {rounds} rounds); {captured} graphs "
            f"captured by the first instance, 0 by the second; {replays} replays; {executed} evaluations run "
            f"({executed - evaluations} frozen) x {shards} shards = {shards * executed} launch counts; no late fold; "
            f"pinned {pinned_mb:.0f} MB; PSNR {float(psnr(x, gt)):.2f} dB")
        results[label] = {"host_s": host_s, "fused_s": fused_s, "readbacks": readbacks, "captures": captured,
                          "replays": replays, "pinned_mb": pinned_mb, "executed": executed, "evaluations": evaluations}
        grown = degrade.launch_counts[mode] - counted - (turns + 1) * shards * evaluations
        check(grown > 0, f"the fused mesh {label} solve never launched {mode} ({row})")
        launches[row] = launches.get(row, 0) + grown
    for row in rows:
        if row["row"] in launches:
            row["launches_fused_mesh"] = launches[row["row"]]
    irls_mod._BUILT_SOLVER_CACHE.clear()
    log(f"[8/13] fused mesh: {time.perf_counter() - t_phase:.1f} s")
    return results


# ------------------------------------------------------------- data parallel (phase 13)

FRAME_MESH_TOLERANCE = {torch.float64: 1e-6}     # x, meshed vs one device (PERF.md section 2)
LOOPBACK_TOLERANCE = 1e-6                        # float64, each process against its own one-process solve
MODE_OF = {True: "data_term_tv", False: "data_term"}   # the fused mode of a solve with / without its TV term


def _sharded_against_single(label, make, mesh, method, iterations, device, turns=5):
    """``make_sharded_map_solver`` on ``mesh`` beside ``minimize`` on one
    device with the same objective and start, thresholds 0: float32 at full
    length held by iterations, cost (5e-2 relative) and PSNR (0.05 dB); float64
    held element-wise; walls in turns."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        gt, lows, shifts, kernel, scale, regs = make(dtype)
        observations = torch.stack(lows)
        x0 = linear_resize(lows[0], tuple(gt.shape[-2:])).contiguous()
        weights = tuple(torch.ones_like(gt) for _ in regs)
        options = dict(method=method, max_iterations=iterations, gradient_norm_threshold=0.0,
                       cost_decrease_threshold=0.0, parameter_variation_threshold=0.0)
        solve = make_sharded_map_solver(mesh, kernel, scale, regs, **options)
        placed = shard_problem(mesh, x0, observations, shifts)
        single = make_map_value_and_grad(observations, shifts, kernel, scale, regs, device=device, dtype=dtype)
        bound = single.prepare(weights)
        before = degrade.launch_counts[MODE_OF[bool(regs)]]
        meshed = solve(*placed, weights)
        torch.cuda.synchronize(device)
        per_evaluation = (degrade.launch_counts[MODE_OF[bool(regs)]] - before) / meshed.num_evaluations
        check(per_evaluation == mesh.num_shards,
              f"{label}: {per_evaluation} launch counts an evaluation, expected one a shard ({mesh.num_shards})")
        reference = minimize(bound, x0, **options)
        x_meshed = meshed.x.to_global(device)
        check(meshed.iterations == reference.iterations,
              f"{label} {dtype}: {meshed.iterations} iterations meshed, {reference.iterations} on one device")
        diff = float((x_meshed - reference.x).abs().max())
        if dtype == torch.float64:
            tol = FRAME_MESH_TOLERANCE[dtype]
            log(f"      {label} in float64: meshed vs one device max|diff| {diff:.2e} (tol {tol:g}), "
                f"{meshed.iterations} iterations")
            check(diff <= tol, f"{label}: meshed and single-device float64 solves differ by {diff}")
            continue
        cost_diff = abs(float(meshed.cost) - float(reference.cost)) / abs(float(reference.cost))
        psnr_diff = abs(float(psnr(x_meshed, gt)) - float(psnr(reference.x, gt)))
        check(cost_diff <= 5e-2 and psnr_diff <= 0.05,
              f"{label}: meshed and single-device solves end apart: cost {cost_diff}, PSNR {psnr_diff} dB")
        walls = {"meshed": [], "single": []}
        for _ in range(turns):
            for name, run in (("meshed", lambda: solve(*placed, weights).x.to_global(device)),
                              ("single", lambda: minimize(bound, x0, **options).x)):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize(device)
                walls[name].append(time.perf_counter() - t0)
        log(f"[13/13] (a) make_sharded_map_solver, {label}: {mesh.shape} on one card, {method} {meshed.iterations} "
            f"iterations, {meshed.num_evaluations} evaluations, {per_evaluation:.0f} launch counts an evaluation "
            f"(one device: 1); wall meshed {_median_range(walls['meshed'])} s, one device "
            f"{_median_range(walls['single'])} s (median [min, max] of {turns}, in turns); max|diff| {diff:.2e}, "
            f"cost {cost_diff:.2e} relative (tol 5e-2), PSNR {float(psnr(x_meshed, gt)):.2f} dB, "
            f"{psnr_diff:.4f} dB from one device (tol 0.05)")
        out = {"walls": walls, "launches_per_evaluation": per_evaluation, "psnr_diff": psnr_diff,
               "iterations": meshed.iterations, "evaluations": meshed.num_evaluations}
    return out


def _band_split(device, turns=2, iterations=20):
    """``band_split_minimize`` on the 64-band cube beside 64 serial ``minimize``
    calls, each band with its own objective (its frames, 2D TV 0.01): per band
    the same iterations and evaluations and the same estimate."""
    model, gt, lows = hyperspectral_problem(device)
    observations = torch.stack(lows)
    shifts, kernel = np.asarray(FLAGSHIP_SHIFTS, dtype=np.float64), np.asarray(model.blur_operator.kernel)
    bands = gt.shape[0]
    x0 = linear_resize(lows[0], tuple(gt.shape[-2:])).contiguous()
    functions = [make_map_value_and_grad(observations[:, c: c + 1], shifts, kernel, 2,
                                         [(TotalVariationRegularizer(), 0.01)], device=device)
                 .prepare((torch.ones_like(gt[c: c + 1]),)) for c in range(bands)]
    calls = []
    counted = [lambda x, c=c, f=f: (calls.append(c), f(x))[1] for c, f in enumerate(functions)]
    options = dict(method="cg", max_iterations=iterations)

    def serial():
        return [minimize(f, x0[c: c + 1], **options) for c, f in enumerate(functions)]

    before = degrade.launch_counts["data_term_tv"]
    batched = band_split_minimize(counted, x0, **options)
    torch.cuda.synchronize(device)
    launched = degrade.launch_counts["data_term_tv"] - before
    steps = 1 + sum(1 for a, b in zip(calls, calls[1:]) if b <= a)
    check(launched == len(calls) == sum(batched.num_evaluations),
          f"band split: {launched} launch counts for {len(calls)} band evaluations")
    alone = serial()
    check(batched.iterations == [r.iterations for r in alone]
          and batched.num_evaluations == [r.num_evaluations for r in alone],
          f"band split: iterations / evaluations per band differ from the serial solves: {batched.iterations} vs "
          f"{[r.iterations for r in alone]}")
    serial_x = torch.cat([r.x for r in alone])
    diff = float((batched.x - serial_x).abs().max())
    check(torch.equal(batched.x, serial_x), f"band split: {diff} from the serial solves, not bit-equal")
    walls = {"batched": [], "serial": []}
    for _ in range(turns):
        for name, run in (("batched", lambda: band_split_minimize(functions, x0, **options).x),
                          ("serial", lambda: [r.x for r in serial()])):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize(device)
            walls[name].append(time.perf_counter() - t0)
    log(f"[13/13] (b) band_split_minimize, 64 x 256x256, cg <= {iterations} iterations, TV 0.01: iterations per band "
        f"{min(batched.iterations)}-{max(batched.iterations)}, evaluations {min(batched.num_evaluations)}-"
        f"{max(batched.num_evaluations)}, equal to the serial solves; bit-equal to them; "
        f"{steps} batched evaluations for {len(calls)} band evaluations ({len(calls) / steps:.1f} launch counts "
        f"an evaluation, at most {bands}); wall batched {_median_range(walls['batched'])} s, 64 serial solves "
        f"{_median_range(walls['serial'])} s")
    return {"walls": walls, "steps": steps, "band_evaluations": len(calls), "diff": diff}


def _loopback_on_the_card(device):
    """The two-process loopback, one shard each, ``gloo`` between them, both on
    the card, at the flagship's geometry: in float64, held element-wise against
    each process's one-process solve, and in float32, the flagship's dtype, for
    the all-reduce's bytes and ms (held as (a) holds float32: iterations, cost
    and PSNR). In each process's timed solve every evaluation launches
    ``data_term_tv`` once and never the plain version. Returns the launches."""
    from super_resolution_tpu_torch.parallel import multihost

    index = device.index or 0
    launched = 0
    for dtype, tolerance in (("float64", LOOPBACK_TOLERANCE), ("float32", float("inf"))):
        argv = ["--device", f"cuda:{index}", "--dtype", dtype, "--side", "1000", "--frames", "4", "--scale", "4",
                "--blur_sigma", "1.5", "--lam", "0.01", "--method", "linear_cg", "--iterations", "50",
                "--shards_per_process", "1", "--tolerance", str(tolerance)]
        t0 = time.perf_counter()
        results = multihost.run_processes("loopback", 2, argv, timeout_s=300)
        for r in results:
            check(r["ok"], f"loopback {dtype} process {r['process']}: max|diff| {r['max_abs_diff']} (tol {tolerance}), "
                           f"iterations {r['iterations']} vs {r['reference_iterations']}")
            psnr_diff = abs(r["psnr_db"] - r["reference_psnr_db"])
            check(r["cost_rel_diff"] <= 5e-2 and psnr_diff <= 0.05,
                  f"loopback {dtype} process {r['process']}: cost {r['cost_rel_diff']} relative, PSNR {psnr_diff} dB")
            check(r["all_reduce_per_evaluation"] == 1.0 and r["psum_per_evaluation"] == 1.0,
                  f"loopback {dtype} process {r['process']}: {r['all_reduce_per_evaluation']} all-reduces an evaluation")
            expected = r["local_shards"] * r["evaluations"]
            check(r["launches"] == dict({name: 0 for name in r["launches"]}, data_term_tv=expected)
                  and r["plain_version_calls"] == 0,
                  f"loopback {dtype} process {r['process']}: launches {r['launches']} and "
                  f"{r['plain_version_calls']} plain calls, expected {expected} data_term_tv launches and none")
            launched += r["launches"]["data_term_tv"]
        log(f"[13/13] (d) two-process loopback on the one card (gloo, CUDA tensors): frame x2, one shard a process, "
            f"1x1000x1000 {dtype}, 4 frames at 4x, TV 0.01, linear_cg 50; " + "; ".join(
                f"process {r['process']}: max|diff| {r['max_abs_diff']:.2e} (tol {tolerance:g}), PSNR "
                f"{abs(r['psnr_db'] - r['reference_psnr_db']):.4f} dB and cost {r['cost_rel_diff']:.2e} from one "
                f"process, {r['evaluations']} evaluations, {r['launches']['data_term_tv']} data_term_tv launches, "
                f"{r['plain_version_calls']} plain, {r['ms_per_evaluation']:.2f} ms an evaluation distributed, "
                f"{r['single_process_ms_per_evaluation']:.3f} ms one process, all-reduce "
                f"{r['all_reduce_bytes_per_evaluation'] / 1e6:.6f} MB an evaluation in {r['all_reduce_ms']:.3f} ms"
                for r in results) + f"; {time.perf_counter() - t0:.1f} s with the processes' start")
    return launched


def _scaling_counts(device):
    """The scaling harness in this process over 1 / 2 / 4 frame shards on the card: the collective calls an
    evaluation must stay flat."""
    from super_resolution_tpu_torch.parallel import multihost

    args = multihost.parser().parse_args([
        "scaling", "--device", str(device), "--dtype", "float32", "--side", "1000", "--frames", "4", "--scale",
        "4", "--blur_sigma", "1.5", "--lam", "0.01", "--method", "linear_cg", "--iterations", "10",
        "--shards", "1,2,4"])
    points = multihost.scaling(args)
    check([p["shards"] for p in points] == [1, 2, 4], f"scaling points {points}")
    flat = {(p["psum_per_evaluation"], p["all_reduce_per_evaluation"]) for p in points}
    check(flat == {(1.0, 0.0)}, f"collective calls an evaluation are not flat over 1 / 2 / 4 shards: {points}")
    log("[13/13] (e) scaling harness, flagship, linear_cg 10: " + "; ".join(
        f"{p['shards']} shard(s): {p['frame_iterations_per_s']:.0f} frame-iterations/s, {p['psum_per_evaluation']:.0f} "
        f"psum and {p['all_reduce_per_evaluation']:.0f} all-reduces an evaluation" for p in points)
        + " (one card: no scaling is read from these)")
    return points


def phase_data_parallel(device, rows):
    """``parallel/data_parallel.py`` on the card: frame-sharded solves against
    one device, the batched band split against serial band solves, the
    two-process loopback, and the scaling harness's collective counts."""
    t_phase = time.perf_counter()
    degrade.reset_launch_counts()
    collectives.reset_counts()
    results = {}
    flagship = synthetic_scene(1, 1000, 1000, seed=2026)

    def flagship_problem(dtype):
        model, gt, lows = make_observations(flagship, FLAGSHIP_SHIFTS, 4, 3, 1.5, device, dtype)
        return gt, lows, np.asarray(FLAGSHIP_SHIFTS, dtype=np.float64), np.asarray(model.blur_operator.kernel), 4, [
            (TotalVariationRegularizer(), 0.01)]

    def cube_problem(dtype):
        model, gt, lows = hyperspectral_problem(device, dtype=dtype)
        return gt, lows, np.asarray(FLAGSHIP_SHIFTS, dtype=np.float64), np.asarray(model.blur_operator.kernel), 2, [
            (TotalVariationRegularizer(), 0.01)]

    before = degrade.launch_counts["data_term_tv"]
    results["frame_flagship"] = _sharded_against_single(
        "frame x4, flagship 1x1000x1000, TV 0.01", flagship_problem, make_mesh({"frame": 4}, [device]),
        "linear_cg", 50, device)
    flagship_launches = degrade.launch_counts["data_term_tv"] - before
    before = degrade.launch_counts["data_term_tv"]
    results["frame_band_cube"] = _sharded_against_single(
        "frame x2 x band x2, 64 x 256x256, TV 0.01", cube_problem, make_mesh({"frame": 2, "band": 2}, [device]),
        "linear_cg", 20, device)
    cube_launches = degrade.launch_counts["data_term_tv"] - before
    before = degrade.launch_counts["data_term_tv"]
    results["band_split"] = _band_split(device)
    split_launches = degrade.launch_counts["data_term_tv"] - before
    loopback_launches = results["loopback"] = _loopback_on_the_card(device)
    before = degrade.launch_counts["data_term_tv"]
    results["scaling"] = _scaling_counts(device)
    flagship_launches += degrade.launch_counts["data_term_tv"] - before
    for name, count in (("flagship frame mesh", flagship_launches), ("cube frame x band mesh", cube_launches),
                        ("band split", split_launches)):
        check(count > 0, f"the {name} never launched data_term_tv")
    for row in rows:
        if row["row"] == "K2":
            row["launches_data_parallel"] = flagship_launches + split_launches
            row["launches_loopback"] = loopback_launches
        if row["row"] == "K5":
            row["launches_data_parallel"] = cube_launches
    log(f"[13/13] data parallel: {time.perf_counter() - t_phase:.1f} s")
    return results


def per_kernel_table(rows):
    """Each hand-written kernel on each row: us per launch, its own bound,
    launches on the paths, and launches x (time - bound) in ms -- the ranking
    of what to make faster next."""
    table = []
    for row in rows:
        shapes = [(row, row["launches"])]
        if "flagship_tile_tv" in row:
            shapes = [(row, row["launches_by_shape"]["rgb_tile_btv"]),
                      (dict(row["flagship_tile_tv"], row=row["row"] + " flagship TV tile"),
                       row["launches_by_shape"]["flagship_tile_tv"])]
        if "video_shape" in row:
            shapes.append((dict(row["video_shape"], row=row["row"] + " video"), row["launches_video"]))
        for timed, launches in shapes:
            for name, info in timed["per_kernel"].items():
                table.append({"kernel": name, "row": timed["row"], "us": info["us"], "bound_us": info["bound_us"],
                              "launches": launches, "gap_ms": launches * (info["us"] - info["bound_us"]) / 1e3})
    for kernel in HAND_KERNELS:
        mine = [e for e in table if e["kernel"] == kernel]
        log(f"      {kernel}: {sum(e['launches'] for e in mine)} launches on the paths, launches x gap "
            f"{sum(e['gap_ms'] for e in mine):.2f} ms; " + "; ".join(
                f"{e['row']} {e['us']:.2f} us (bound {e['bound_us']:.2f}) x {e['launches']}" for e in mine))
    return table


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    seconds = {}

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[fn.__name__] = time.perf_counter() - t0
        return out

    try:
        card = timed(phase_environment)
        timed(phase_build)
        rows = timed(phase_kernels, device)
        timed(phase_goldens, device)
        timed(phase_main_path, device, rows)
        timed(phase_estimated_motion, device, rows)
        timed(phase_hyperspectral, device, rows)
        timed(phase_mesh, device, rows)
        timed(phase_mesh_fused, device, rows)
        timed(phase_fused, device, rows)
        timed(phase_wolfe, device, rows)
        timed(phase_entry_points, device, rows, card)
        timed(phase_video, device, rows, card)
        timed(phase_data_parallel, device, rows)
    except Failure as failure:
        print(f"chip_smoke: FAILED: {failure}", file=sys.stderr)
        return 1
    log("per kernel (profiler, float32, warm L2; the own bound by bytes):")
    per_kernel_table(rows)
    log("seconds per phase: " + ", ".join(f"{name} {t:.1f}" for name, t in seconds.items()))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
