"""Checkpoint/resume of the port's IRLS host loop, float64 on the CPU.

Mirrors ``tests/test_checkpoint.py``: a solve interrupted after two IRLS
rounds and resumed from its checkpoint ends where the uninterrupted solve
ends, bit for bit, on one device and on a band mesh; and the port's
``.npz`` payload (``x``, ``prev_cost``, ``iteration``, ``weight_{i}``) is the
JAX package's, to ``1e-12`` (the weights ``1 / max(1e-5, r)`` as their
residuals ``r``), on the same numpy inputs.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.models import ImageModel as JImageModel
from super_resolution_tpu.models import ImageModelParameters as JParameters
from super_resolution_tpu.motion import MotionShiftSequence as JSequence
from super_resolution_tpu.ops.tv import TotalVariationRegularizer as JTV
from super_resolution_tpu.solvers import IRLSMapSolver as JSolver
from super_resolution_tpu.solvers import IRLSMapSolverOptions as JOptions

from super_resolution_tpu_torch import IRLSMapSolver, IRLSMapSolverOptions, ImageModel, ImageModelParameters
from super_resolution_tpu_torch import make_mesh
from super_resolution_tpu_torch.motion import MotionShiftSequence
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer

SHIFTS = [(0, 0), (1, 1), (-1, 0), (0, -1)]
PARAMS = dict(scale=2, blur_radius=3, blur_sigma=1.0)
OPTIONS = dict(irls_cost_difference_threshold=0.0, max_num_solver_iterations=8)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _problem(c=1, shifts=SHIFTS):
    hr = np.random.default_rng(9).random((c, 16, 16))
    model = ImageModel.create(ImageModelParameters(motion_sequence=MotionShiftSequence(shifts), **PARAMS))
    return hr, model, [model.apply(torch.from_numpy(hr), k).numpy() for k in range(len(shifts))]


def _solve(model, lows, max_irls, shape, mesh=None, ckpt=None, resume=False, **fields):
    options = IRLSMapSolverOptions(max_num_irls_iterations=max_irls, **OPTIONS, **fields)
    solver = IRLSMapSolver(options, model, lows, device="cpu", dtype=torch.float64, mesh=mesh)
    solver.add_regularizer(TotalVariationRegularizer(), 0.001)
    return solver, solver.solve(np.zeros(shape), checkpoint_path=ckpt, resume=resume)


def test_resume_equals_uninterrupted(tmp_path):
    hr, model, lows = _problem()
    ckpt = str(tmp_path / "irls")
    _, full = _solve(model, lows, 4, hr.shape)
    _solve(model, lows, 2, hr.shape, ckpt=ckpt)  # interrupted after round 2
    assert os.path.exists(ckpt + ".npz")
    resumed_solver, resumed = _solve(model, lows, 4, hr.shape, ckpt=ckpt, resume=True)
    assert torch.equal(resumed, full)
    assert len(resumed_solver.last_inner_calls) == 2  # rounds 3 and 4 only


def test_resume_on_band_mesh(tmp_path):
    """On a band mesh the checkpoint holds global arrays; the resumed solve
    places them on the shards again and ends where the uninterrupted one does."""
    hr, model, lows = _problem(c=4)
    mesh = make_mesh({"band": 4}, devices=["cpu"])
    ckpt = str(tmp_path / "irls_mesh")
    _, full = _solve(model, lows, 4, hr.shape, mesh=mesh)
    _solve(model, lows, 2, hr.shape, mesh=mesh, ckpt=ckpt)
    _, resumed = _solve(model, lows, 4, hr.shape, mesh=mesh, ckpt=ckpt, resume=True)
    assert torch.equal(resumed, full)
    _, single = _solve(model, lows, 4, hr.shape)
    assert float((resumed - single).abs().max()) < 1e-9


def test_the_payload_is_the_jax_packages(tmp_path):
    hr, model, lows = _problem()
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    _solve(model, lows, 2, hr.shape, ckpt=ours)
    jmodel = JImageModel.create(JParameters(motion_sequence=JSequence(SHIFTS), **PARAMS))
    jsolver = JSolver(JOptions(max_num_irls_iterations=2, **OPTIONS), jmodel, [jnp.asarray(f) for f in lows])
    jsolver.add_regularizer(JTV(), 0.001)
    jsolver.solve(np.zeros(hr.shape), checkpoint_path=theirs)
    with np.load(ours + ".npz") as a, np.load(theirs + ".npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["iteration", "prev_cost", "weight_0", "x"]
        assert int(a["iteration"]) == int(b["iteration"]) == 2
        assert abs(float(a["prev_cost"]) - float(b["prev_cost"])) <= 1e-12 * abs(float(b["prev_cost"]))
        for key in ("x", "weight_0"):
            assert a[key].shape == b[key].shape and a[key].dtype == b[key].dtype
        np.testing.assert_allclose(a["x"], b["x"], rtol=0, atol=1e-12)
        # A weight is 1 / max(1e-5, r): compared as the residual it holds.
        np.testing.assert_allclose(1.0 / a["weight_0"], 1.0 / b["weight_0"], rtol=0, atol=1e-12)


def test_split_channels_checkpoint_each_round(tmp_path):
    hr, model, lows = _problem(c=2)
    ckpt = str(tmp_path / "split")
    _, full = _solve(model, lows, 3, hr.shape, split_channels=True)
    _solve(model, lows, 1, hr.shape, ckpt=ckpt, split_channels=True)
    assert all(os.path.exists(f"{ckpt}.round{i}.npz") for i in range(2)) and not os.path.exists(ckpt + ".npz")
    _, resumed = _solve(model, lows, 3, hr.shape, ckpt=ckpt, resume=True, split_channels=True)
    assert torch.equal(resumed, full)


def test_refined_motion_is_checkpointed_and_restored(tmp_path):
    """A refined solve saves its shifts beside the estimate and a resumed one
    starts from them, float64 on the solver's device."""
    shifts = [(0, 0), (1.2, 0.4), (-0.7, 1.1), (0.4, -0.9)]
    hr, model, lows = _problem(shifts=shifts)
    start = ImageModel.create(ImageModelParameters(
        motion_sequence=MotionShiftSequence([(0, 0), (1, 0.5), (-0.5, 1), (0.5, -1)]), **PARAMS))
    ckpt = str(tmp_path / "refined")
    solver, _ = _solve(start, lows, 3, hr.shape, ckpt=ckpt, refine_motion_every=1)
    with np.load(ckpt + ".npz") as payload:
        saved = payload["shifts"]
    assert np.array_equal(saved, solver.shifts.numpy())
    assert not np.array_equal(saved, start.motion_operator.motion_sequence.as_array())
    # Past its cap already: the resumed solve runs one round, refines nothing.
    resumed, _ = _solve(start, lows, 3, hr.shape, ckpt=ckpt, resume=True, refine_motion_every=1)
    assert resumed.shifts.dtype == torch.float64 and np.array_equal(resumed.shifts.numpy(), saved)
    assert len(resumed.last_inner_calls) == 1


def test_resume_without_a_file_starts_afresh_and_fused_refuses_a_checkpoint(tmp_path):
    hr, model, lows = _problem()
    _, full = _solve(model, lows, 2, hr.shape)
    _, fresh = _solve(model, lows, 2, hr.shape, ckpt=str(tmp_path / "missing"), resume=True)
    assert torch.equal(fresh, full)
    with pytest.raises(ValueError, match="checkpoint"):
        _solve(model, lows, 2, hr.shape, ckpt=str(tmp_path / "fused"), fused_irls=True)
