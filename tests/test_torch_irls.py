"""The slice as a whole: the port's ``IRLSMapSolver`` against the JAX solver.

Same LR frames, initial estimate and options on both sides, float64 on the
CPU. The two solves must agree within ``1e-6`` max abs difference: the
algorithms are the same, and rounding (order of sums in the objective and in
the dot products) is amplified by at most a few IRLS rounds of CG.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.models import ImageModel as JImageModel
from super_resolution_tpu.models import ImageModelParameters as JParameters
from super_resolution_tpu.motion import MotionShiftSequence as JSequence
from super_resolution_tpu.ops.btv import BilateralTotalVariationRegularizer as JBTV
from super_resolution_tpu.ops.tv import TotalVariationRegularizer as JTV
from super_resolution_tpu.solvers import IRLSMapSolver as JSolver
from super_resolution_tpu.solvers import IRLSMapSolverOptions as JOptions

from super_resolution_tpu_torch import IRLSMapSolver, IRLSMapSolverOptions, ImageModel, ImageModelParameters
from super_resolution_tpu_torch.motion import MotionShiftSequence
from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
from super_resolution_tpu_torch.solvers.map_solver import MapSolverOptions

SHIFTS = [(0, 0), (1, 1), (0.5, -0.25), (1, 0)]
TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(c, hw, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: hw[0], : hw[1]]
    base = 0.5 + 0.3 * np.sin(xx / 3.0) * np.cos(yy / 4.0)
    img = np.stack([base * (1.0 - 0.2 * i) + 0.05 * rng.random(hw) for i in range(c)])
    img[:, hw[0] // 3 : hw[0] // 2, hw[1] // 4 : hw[1] // 2] += 0.3
    return np.clip(img, 0.0, 1.0)


def _both_solvers(c, hw, scale, reg, lam=0.01, **option_fields):
    gt = _scene(c, hw, 70)
    params = dict(scale=scale, blur_radius=3, blur_sigma=1.0)
    model = ImageModel.create(ImageModelParameters(motion_sequence=MotionShiftSequence(SHIFTS), **params))
    jmodel = JImageModel.create(JParameters(motion_sequence=JSequence(SHIFTS), **params))
    lows = [model.apply(torch.from_numpy(gt), k).numpy() for k in range(len(SHIFTS))]
    ours = IRLSMapSolver(IRLSMapSolverOptions(**option_fields), model, lows, device="cpu", dtype=torch.float64)
    theirs = JSolver(JOptions(**option_fields), jmodel, [jnp.asarray(low) for low in lows])
    if reg == "tv":
        ours.add_regularizer(TotalVariationRegularizer(), lam)
        theirs.add_regularizer(JTV(), lam)
    elif reg == "btv":
        ours.add_regularizer(BilateralTotalVariationRegularizer(2, 0.5), lam)
        theirs.add_regularizer(JBTV(2, 0.5), lam)
    x0 = np.repeat(np.repeat(lows[0], scale, axis=-2), scale, axis=-1)
    return ours, theirs, x0


@pytest.mark.parametrize(
    "c,scale,reg,fields",
    [
        (1, 2, "tv", dict(max_num_irls_iterations=3, max_num_solver_iterations=15)),
        (1, 2, "btv", dict(max_num_irls_iterations=3, max_num_solver_iterations=15)),
        (1, 2, None, dict(max_num_solver_iterations=30)),
        (1, 4, "tv", dict(least_squares_solver="linear_cg", max_num_irls_iterations=3,
                          max_num_solver_iterations=15)),
        (1, 2, "btv", dict(least_squares_solver="linear_cg", max_num_irls_iterations=2,
                           max_num_solver_iterations=20, linear_cg_refresh_every=5)),
        (3, 2, "tv", dict(split_channels=True, max_num_irls_iterations=2, max_num_solver_iterations=10)),
        (3, 2, "tv", dict(split_channels=False, least_squares_solver="linear_cg",
                          max_num_irls_iterations=2, max_num_solver_iterations=10)),
    ],
)
def test_irls_solve_matches_jax(c, scale, reg, fields):
    ours, theirs, x0 = _both_solvers(c, (24, 32), scale, reg, **fields)
    x = ours.solve(x0)
    jx = np.asarray(theirs.solve(jnp.asarray(x0)))
    assert x.shape == jx.shape and x.dtype == torch.float64
    assert np.abs(x.numpy() - jx).max() < TOL
    assert ours.last_inner_iterations == theirs.last_inner_iterations
    assert [c[1:] for c in ours.last_inner_calls] == [c[1:] for c in theirs.last_inner_calls]


def test_irls_stops_on_cost_difference_like_jax():
    """A loose IRLS threshold ends the outer loop early on both sides."""
    fields = dict(max_num_irls_iterations=10, max_num_solver_iterations=10,
                  irls_cost_difference_threshold=0.3)
    ours, theirs, x0 = _both_solvers(1, (24, 32), 2, "tv", lam=0.02, **fields)
    x = ours.solve(x0)
    jx = np.asarray(theirs.solve(jnp.asarray(x0)))
    assert 1 < len(ours.last_inner_calls) < 10
    assert len(ours.last_inner_calls) == len(theirs.last_inner_calls)
    assert np.abs(x.numpy() - jx).max() < TOL


@pytest.mark.parametrize("cls,jcls", [(MapSolverOptions, None), (IRLSMapSolverOptions, JOptions)])
@pytest.mark.parametrize("n_params,lam_sum", [(1000, 0.01), (10, 0.01), (768, 0.03)])
def test_adaptive_thresholds_scale_only_upward(cls, jcls, n_params, lam_sum):
    opts = cls()
    before = dataclasses.asdict(opts)
    opts.adjust_thresholds_adaptively(n_params, lam_sum)
    scale = n_params * lam_sum if n_params * lam_sum >= 1.0 else 1.0
    names = ["gradient_norm_threshold", "cost_decrease_threshold", "parameter_variation_threshold"]
    if cls is IRLSMapSolverOptions:
        names.append("irls_cost_difference_threshold")
    for name in names:
        assert getattr(opts, name) == before[name] * scale
    if jcls is not None:
        jopts = jcls()
        jopts.adjust_thresholds_adaptively(n_params, lam_sum)
        for name in names:
            assert getattr(opts, name) == getattr(jopts, name)


def test_solver_input_checks_and_geometry():
    ours, _, x0 = _both_solvers(3, (24, 32), 2, "tv")
    assert ours.hr_shape == (3, 24, 32) and ours.image_size == (32, 24)
    assert ours.num_images == 4 and ours.num_pixels == 24 * 32 and ours.num_data_points == 3 * 24 * 32
    assert ours.regularization_parameter_sum == 0.01
    with pytest.raises(ValueError):
        ours.solve(x0[:, :-2])
    model = ImageModel.create(ImageModelParameters(scale=2, motion_sequence=MotionShiftSequence(SHIFTS[:2])))
    with pytest.raises(ValueError):
        IRLSMapSolver(IRLSMapSolverOptions(), model, [np.zeros((1, 4, 4))] * 3, device="cpu")
    with pytest.raises(ValueError):
        IRLSMapSolver(IRLSMapSolverOptions(), model, [], device="cpu")
    with pytest.raises(ValueError):
        IRLSMapSolver(IRLSMapSolverOptions(), model, [np.zeros((1, 4, 4)), np.zeros((1, 4, 6))], device="cpu")
    # 2D frames gain a channel axis; a float32 solve stays float32.
    solver = IRLSMapSolver(IRLSMapSolverOptions(max_num_solver_iterations=2), model,
                           [np.ones((4, 4)), np.ones((4, 4))], device="cpu", dtype=torch.float32)
    out = solver.solve(np.ones((8, 8)))
    assert out.shape == (1, 8, 8) and out.dtype == torch.float32
