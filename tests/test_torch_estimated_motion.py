"""The estimated-motion slice as a whole: register, then solve with motion
refinement, port against JAX.

LR frames are made once with numpy inputs and handed to both sides, float64
on the CPU. Registration agrees within ``1/256`` px (see
``test_torch_registration.py``); to hold the solvers against each other on
identical starting motion, both then start from the port's registered shifts.
The JAX solver runs with ``use_pallas_data_term=False`` (its traced-shift
objective). Refined shifts agree within ``1e-6`` HR px and images within
``1e-6`` max abs difference, the tolerance of ``test_torch_irls.py``: the
algorithms are the same, and rounding (order of sums) is amplified by a few
IRLS rounds of CG and Gauss-Newton.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.models import ImageModel as JImageModel
from super_resolution_tpu.models import ImageModelParameters as JParameters
from super_resolution_tpu.motion import MotionShiftSequence as JSequence
from super_resolution_tpu.motion.registration import translational_registration as jregister
from super_resolution_tpu.ops.btv import BilateralTotalVariationRegularizer as JBTV
from super_resolution_tpu.ops.tv import TotalVariationRegularizer as JTV
from super_resolution_tpu.solvers import IRLSMapSolver as JSolver
from super_resolution_tpu.solvers import IRLSMapSolverOptions as JOptions

from super_resolution_tpu_torch import IRLSMapSolver, IRLSMapSolverOptions, ImageModel, ImageModelParameters
from super_resolution_tpu_torch import convert, translational_registration
from super_resolution_tpu_torch.evaluation import psnr
from super_resolution_tpu_torch.motion import MotionShiftSequence
from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu_torch.ops.resize import linear_resize
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer

TRUE6 = [(0, 0), (1.25, 0.5), (-0.75, 1.5), (0.5, -1.25), (0.3, 0.9), (-1.1, -0.4)]
TOL = 1e-6
PARAMS = dict(scale=2, blur_radius=3, blur_sigma=1.0)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(c, h, w, seed=5, cutoff=0.15):
    rng = np.random.default_rng(seed)
    fy, fx = np.fft.fftfreq(h)[:, None], np.fft.fftfreq(w)[None, :]
    lowpass = np.exp(-(fy**2 + fx**2) / (2 * cutoff**2))
    img = np.real(np.fft.ifft2(np.fft.fft2(rng.standard_normal((c, h, w))) * lowpass))
    return (img - img.min()) / (img.max() - img.min())


def _frames(c=1, hw=(32, 32), shifts=TRUE6):
    gt = _scene(c, *hw)
    model = ImageModel.create(ImageModelParameters(motion_sequence=MotionShiftSequence(shifts), **PARAMS))
    return gt, [model.apply(torch.from_numpy(gt), k).numpy() for k in range(len(shifts))]


def _solvers(lows, start, reg, lam, **fields):
    model = ImageModel.create(ImageModelParameters(motion_sequence=MotionShiftSequence(start), **PARAMS))
    jmodel = JImageModel.create(JParameters(motion_sequence=JSequence(start), **PARAMS))
    ours = IRLSMapSolver(IRLSMapSolverOptions(**fields), model, lows, device="cpu", dtype=torch.float64)
    theirs = JSolver(JOptions(use_pallas_data_term=False, **fields), jmodel, [jnp.asarray(f) for f in lows])
    if reg == "tv":
        ours.add_regularizer(TotalVariationRegularizer(), lam)
        theirs.add_regularizer(JTV(), lam)
    elif reg == "btv":
        ours.add_regularizer(BilateralTotalVariationRegularizer(2, 0.5), lam)
        theirs.add_regularizer(JBTV(2, 0.5), lam)
    return ours, theirs


def _perturbed(seed, mag=0.1):
    rng = np.random.default_rng(seed)
    true = np.asarray(TRUE6, dtype=float)
    return true + np.where(np.arange(len(true))[:, None] == 0, 0.0, rng.uniform(-mag, mag, true.shape))


def test_register_then_refined_solve_matches_jax():
    gt, lows = _frames()
    registered = translational_registration(lows, device="cpu")
    jregistered = jregister([jnp.asarray(f) for f in lows])
    assert np.abs(registered.as_array() - jregistered.as_array()).max() <= 1.0 / 256 + 1e-12
    start = registered.as_array() * 2  # LR px -> HR px
    assert np.abs(start - np.asarray(TRUE6)).max() < 0.5

    fields = dict(max_num_irls_iterations=5, max_num_solver_iterations=15,
                  irls_cost_difference_threshold=0.0, refine_motion_every=1)
    ours, theirs = _solvers(lows, [tuple(s) for s in start], "tv", 1e-4, **fields)
    x0 = linear_resize(torch.from_numpy(lows[0]), (32, 32)).numpy()
    x = ours.solve(x0)
    jx = np.asarray(theirs.solve(jnp.asarray(x0)))
    assert isinstance(ours.shifts, torch.Tensor) and ours.shifts.dtype == torch.float64
    assert np.abs(ours.shifts.numpy() - np.asarray(theirs.shifts)).max() < TOL
    assert np.abs(x.numpy() - jx).max() < TOL
    assert [c[1:] for c in ours.last_inner_calls] == [c[1:] for c in theirs.last_inner_calls]
    # The refinement did its work: closer to the true motion than registration was.
    assert np.abs(ours.shifts.numpy() - np.asarray(TRUE6)).max() < np.abs(start - np.asarray(TRUE6)).max()
    assert np.array_equal(ours.shifts.numpy()[0], start[0])


@pytest.mark.parametrize(
    "reg,lam,c,fields",
    [
        ("btv", 1e-3, 1, dict(least_squares_solver="linear_cg", max_num_irls_iterations=4,
                              max_num_solver_iterations=12, refine_motion_every=1)),
        ("tv", 1e-4, 1, dict(max_num_irls_iterations=6, max_num_solver_iterations=10,
                             refine_motion_every=2, refine_motion_iterations=3)),
        ("tv", 1e-4, 2, dict(split_channels=True, max_num_irls_iterations=3,
                             max_num_solver_iterations=8, refine_motion_every=1)),
        (None, 0.0, 1, dict(max_num_irls_iterations=3, max_num_solver_iterations=10, refine_motion_every=1)),
    ],
)
def test_refined_solve_matches_jax(reg, lam, c, fields):
    gt, lows = _frames(c=c)
    start = _perturbed(21)
    ours, theirs = _solvers(lows, [tuple(s) for s in start], reg, lam,
                            irls_cost_difference_threshold=0.0, **fields)
    x0 = np.zeros_like(gt)
    x = ours.solve(x0)
    jx = np.asarray(theirs.solve(jnp.asarray(x0)))
    assert np.abs(ours.shifts.numpy() - np.asarray(theirs.shifts)).max() < TOL
    assert np.abs(x.numpy() - jx).max() < TOL
    assert len(ours.last_inner_calls) == len(theirs.last_inner_calls)
    assert ours.last_inner_iterations == theirs.last_inner_iterations


def test_refinement_beats_the_unrefined_solve_and_leaves_it_untouched_when_off():
    gt, lows = _frames()
    start = _perturbed(21, mag=0.12)
    fields = dict(max_num_irls_iterations=6, max_num_solver_iterations=15, irls_cost_difference_threshold=0.0)
    results = {}
    for every in (0, 1):
        solver, _ = _solvers(lows, [tuple(s) for s in start], "tv", 1e-4, refine_motion_every=every, **fields)
        x = solver.solve(np.zeros_like(gt))
        results[every] = (float(psnr(x, gt)), solver.shifts.numpy())
    assert np.array_equal(results[0][1], start)
    assert np.abs(results[1][1] - np.asarray(TRUE6)).max() < 0.012
    assert results[1][0] > results[0][0] + 10.0


def test_refine_every_two_does_not_exit_before_the_first_refinement_like_jax():
    """A cost that "converges" at once must not end the loop before a due
    refinement has run and settled."""
    gt, lows = _frames()
    start = _perturbed(31)
    fields = dict(max_num_irls_iterations=6, max_num_solver_iterations=15,
                  irls_cost_difference_threshold=1e12, refine_motion_every=2)
    ours, theirs = _solvers(lows, [tuple(s) for s in start], "tv", 1e-4, **fields)
    ours.solve(np.zeros_like(gt))
    theirs.solve(jnp.zeros(gt.shape))
    assert np.abs(ours.shifts.numpy() - start).max() > 1e-3
    assert len(ours.last_inner_calls) == len(theirs.last_inner_calls) > 1
    assert np.abs(ours.shifts.numpy() - np.asarray(theirs.shifts)).max() < TOL


def test_no_refinement_after_the_last_round_and_option_checks():
    gt, lows = _frames()
    start = _perturbed(33)
    solver, _ = _solvers(lows, [tuple(s) for s in start], "tv", 1e-4, max_num_irls_iterations=1,
                         max_num_solver_iterations=5, refine_motion_every=1)
    solver.solve(np.zeros_like(gt))
    assert np.array_equal(solver.shifts.numpy(), start)  # the cap fires next: nothing to refine for
    for bad in (dict(refine_motion_every=-1), dict(refine_motion_every=1, refine_motion_iterations=0)):
        bad_solver, _ = _solvers(lows, [tuple(s) for s in start], "tv", 1e-4, **bad)
        with pytest.raises(ValueError, match="refine_motion"):
            bad_solver.solve(np.zeros_like(gt))


def test_convert_carries_the_refinement_options():
    jopts = JOptions(refine_motion_every=2, refine_motion_iterations=3, refine_motion_delta_threshold=1e-3)
    opts = convert.irls_options(dataclasses.asdict(jopts))
    assert (opts.refine_motion_every, opts.refine_motion_iterations, opts.refine_motion_delta_threshold) == (2, 3, 1e-3)
    defaults, jdefaults = IRLSMapSolverOptions(), JOptions()
    for name in ("refine_motion_every", "refine_motion_iterations", "refine_motion_delta_threshold"):
        assert getattr(defaults, name) == getattr(jdefaults, name)
        assert name not in convert.DROPPED_OPTION_FIELDS
