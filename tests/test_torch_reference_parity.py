"""The port against the ACTUAL C++ reference solver, on the CPU in float64.

The binaries under ``tests/golden/`` were produced by the original reference
implementation on three configurations; each case feeds the port the
reference's own LR frames and initial estimate and compares convergence
points, with the assertions of ``test_reference_parity.py``:

- A: icon, 4 frames, 2x, no blur, unregularized   (exact-recovery regime)
- B: dallas, 4 frames, 2x, blur 3/1.0, TV 0.01
- C: dallas crop 248^2, 4 frames, 4x, blur 3/1.5, BTV(3, 0.5) 0.01
"""

import os
import struct

import numpy as np
import pytest
import torch

from super_resolution_tpu_torch import IRLSMapSolver, IRLSMapSolverOptions, ImageModel, ImageModelParameters
from super_resolution_tpu_torch.evaluation import psnr
from super_resolution_tpu_torch.motion import MotionShift, MotionShiftSequence
from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def load_golden(name: str) -> np.ndarray:
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        c, h, w = struct.unpack("iii", f.read(12))
        data = np.frombuffer(f.read(), dtype=np.float64)
    return data.reshape(c, h, w)


def _solve(lr_names, initial_name, params, regularizer=None, lam=0.0):
    lows = [load_golden(n) for n in lr_names]
    model = ImageModel.create(params)
    solver = IRLSMapSolver(IRLSMapSolverOptions(), model, lows, device="cpu", dtype=torch.float64)
    if regularizer is not None:
        solver.add_regularizer(regularizer, lam)
    return solver.solve(load_golden(initial_name)).numpy()


def _psnr_between(a, b) -> float:
    return float(psnr(a, b))


def test_icon_unregularized_parity():
    seq = MotionShiftSequence(
        [MotionShift(0, 0), MotionShift(1, 0), MotionShift(0, 1), MotionShift(1, 1)]
    )
    params = ImageModelParameters(scale=2, motion_sequence=seq)
    ours = _solve([f"icon_lr_{i}.bin" for i in range(4)], "icon_initial.bin", params)
    ref = load_golden("icon_unreg_result.bin")
    # Both solvers reach the exact solution; agree to solver tolerance.
    assert np.abs(ours - ref).max() < 1e-3


def test_dallas_tv_parity():
    seq = MotionShiftSequence(
        [MotionShift(0, 0), MotionShift(1, 1), MotionShift(0, 1), MotionShift(1, 0)]
    )
    params = ImageModelParameters(scale=2, blur_radius=3, blur_sigma=1.0, motion_sequence=seq)
    ours = _solve(
        [f"dallas_lr_{i}.bin" for i in range(4)], "dallas_initial.bin", params,
        TotalVariationRegularizer(), 0.01,
    )
    ref = load_golden("dallas_tv_result.bin")
    agreement = _psnr_between(ours, ref)
    assert agreement > 40.0, agreement  # near-identical reconstructions
    assert np.abs(ours - ref).mean() < 5e-3


def test_dallas4x_btv_parity_north_star():
    seq = MotionShiftSequence(
        [MotionShift(0, 0), MotionShift(1, 1), MotionShift(0, 1), MotionShift(1, 0)]
    )
    params = ImageModelParameters(scale=4, blur_radius=3, blur_sigma=1.5, motion_sequence=seq)
    ours = _solve(
        [f"dallas4x_lr_{i}.bin" for i in range(4)], "dallas4x_initial.bin", params,
        BilateralTotalVariationRegularizer(3, 0.5), 0.01,
    )
    ref = load_golden("dallas4x_btv_result.bin")
    gt = load_golden("dallas4x_ground_truth.bin")
    psnr_ours = _psnr_between(ours, gt)
    psnr_ref = _psnr_between(ref, gt)
    # North-star contract: within 0.1 dB PSNR of the C++ reference.
    assert abs(psnr_ours - psnr_ref) <= 0.1, (psnr_ours, psnr_ref)
