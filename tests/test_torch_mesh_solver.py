"""``IRLSMapSolver(mesh=...)``: the solve on a device mesh, port against JAX.

The meshed port (all shards on ``cpu``, float64) is held against the JAX
solver WITHOUT a mesh and against the port without a mesh, on the same numpy
frames and start: images within 1e-7 (the same algorithm and the same sums
in another order; inner solves of at most 15 iterations, because longer
Wolfe-CG runs amplify rounding beyond any fixed tolerance), the same
iterations and evaluations in every inner call, refined shifts within 1e-7
HR px. The JAX solver runs its plain objective (``use_pallas_data_term=False``).
Every mesh configuration that the JAX solver answers with its fallback
warning raises ``ValueError`` here: the port has no second path.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.models import ImageModel as JImageModel
from super_resolution_tpu.models import ImageModelParameters as JParameters
from super_resolution_tpu.motion import MotionShiftSequence as JSequence
from super_resolution_tpu.ops.btv import BilateralTotalVariationRegularizer as JBTV
from super_resolution_tpu.ops.tv import TotalVariationRegularizer as JTV
from super_resolution_tpu.parallel import make_mesh as jax_make_mesh
from super_resolution_tpu.solvers import IRLSMapSolver as JSolver
from super_resolution_tpu.solvers import IRLSMapSolverOptions as JOptions

from super_resolution_tpu_torch import IRLSMapSolver, IRLSMapSolverOptions, ImageModel, ImageModelParameters
from super_resolution_tpu_torch import convert, make_mesh
from super_resolution_tpu_torch.motion import MotionShiftSequence
from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu_torch.ops.resize import linear_resize
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
from super_resolution_tpu_torch.parallel import Mesh

TOL = 1e-7
PARAMS = dict(scale=2, blur_radius=3, blur_sigma=1.0)
FRACTIONAL = [(0, 0), (1.25, 0.5), (-0.75, 1.0), (0.5, -1.25)]
INTEGER = [(0, 0), (1, 1), (0, 1), (1, 0)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(c, h, w, seed=5, cutoff=0.15):
    rng = np.random.default_rng(seed)
    fy, fx = np.fft.fftfreq(h)[:, None], np.fft.fftfreq(w)[None, :]
    lowpass = np.exp(-(fy**2 + fx**2) / (2 * cutoff**2))
    img = np.real(np.fft.ifft2(np.fft.fft2(rng.standard_normal((1, h, w))) * lowpass))
    img = (img - img.min()) / (img.max() - img.min())
    gains = np.linspace(0.6, 1.0, c)[:, None, None]      # correlated bands: dz is small but not zero
    return img * gains + 0.01 * rng.random((c, h, w))


def _frames(c, hw, shifts):
    gt = _scene(c, *hw)
    model = ImageModel.create(ImageModelParameters(motion_sequence=MotionShiftSequence(shifts), **PARAMS))
    return [model.apply(torch.from_numpy(gt), k).numpy() for k in range(len(shifts))]


def _regularizers(kind):
    if kind == "tv":
        return TotalVariationRegularizer(), JTV()
    if kind == "tv3d":
        return TotalVariationRegularizer(True), JTV(use_3d_total_variation=True)
    return BilateralTotalVariationRegularizer(2, 0.5), JBTV(2, 0.5)


def _port_solver(lows, start, kinds, lam, mesh_axes, **fields):
    model = ImageModel.create(ImageModelParameters(motion_sequence=MotionShiftSequence(start), **PARAMS))
    mesh = None if mesh_axes is None else make_mesh(mesh_axes, devices=["cpu"])
    solver = IRLSMapSolver(IRLSMapSolverOptions(**fields), model, lows, device="cpu", dtype=torch.float64, mesh=mesh)
    for kind in kinds:
        solver.add_regularizer(_regularizers(kind)[0], lam)
    return solver


def _jax_solver(lows, start, kinds, lam, mesh=None, **fields):
    model = JImageModel.create(JParameters(motion_sequence=JSequence(start), **PARAMS))
    solver = JSolver(JOptions(**fields), model, [jnp.asarray(f) for f in lows], mesh=mesh)
    for kind in kinds:
        solver.add_regularizer(_regularizers(kind)[1], lam)
    return solver


CASES = [
    # mesh, regulariser, channels, HR size, shifts, solver fields
    ({"band": 4}, "tv3d", 8, (20, 20), INTEGER,
     dict(least_squares_solver="linear_cg", max_num_irls_iterations=3, max_num_solver_iterations=15)),
    ({"band": 2}, "tv3d", 2, (20, 20), FRACTIONAL,
     dict(max_num_irls_iterations=2, max_num_solver_iterations=8)),
    ({"row": 2, "col": 2}, "tv", 1, (32, 48), FRACTIONAL,
     dict(least_squares_solver="linear_cg", max_num_irls_iterations=3, max_num_solver_iterations=15)),
    ({"row": 2, "col": 2}, "btv", 2, (32, 48), FRACTIONAL,
     dict(max_num_irls_iterations=3, max_num_solver_iterations=8)),
    ({"row": 2, "col": 2, "band": 2}, "btv", 2, (32, 48), INTEGER,
     dict(least_squares_solver="linear_cg", max_num_irls_iterations=2, max_num_solver_iterations=10)),
    ({"frame": 4}, "btv", 1, (32, 32), FRACTIONAL,
     dict(least_squares_solver="linear_cg", max_num_irls_iterations=4, max_num_solver_iterations=12,
          refine_motion_every=1)),
    ({"frame": 2}, "tv", 2, (32, 32), FRACTIONAL,
     dict(max_num_irls_iterations=3, max_num_solver_iterations=8, refine_motion_every=1, refine_motion_iterations=3)),
    ({"frame": 2, "band": 2}, "tv3d", 4, (20, 20), FRACTIONAL,
     dict(least_squares_solver="linear_cg", max_num_irls_iterations=2, max_num_solver_iterations=10)),
]


@pytest.mark.parametrize("mesh_axes,kind,c,hw,shifts,fields", CASES,
                         ids=["-".join(f"{k}{v}" for k, v in case[0].items()) + "-" + case[1] for case in CASES])
def test_meshed_solve_matches_jax_and_the_port_without_a_mesh(mesh_axes, kind, c, hw, shifts, fields):
    lows = _frames(c, hw, shifts)
    fields = dict(fields, irls_cost_difference_threshold=0.0)
    start = shifts
    if fields.get("refine_motion_every"):
        rng = np.random.default_rng(3)
        start = [(0.0, 0.0)] + [(dx + rng.uniform(-0.1, 0.1), dy + rng.uniform(-0.1, 0.1)) for dx, dy in shifts[1:]]
    lam = 1e-3
    x0 = linear_resize(torch.from_numpy(lows[0]), hw).numpy()
    meshed = _port_solver(lows, start, [kind], lam, mesh_axes, **fields)
    single = _port_solver(lows, start, [kind], lam, None, **fields)
    theirs = _jax_solver(lows, start, [kind], lam, use_pallas_data_term=False, **fields)
    x_meshed, x_single = meshed.solve(x0), single.solve(x0)
    x_jax = np.asarray(theirs.solve(jnp.asarray(x0)))
    assert isinstance(x_meshed, torch.Tensor) and tuple(x_meshed.shape) == (c, *hw)
    assert float((x_meshed - x_single).abs().max()) < TOL
    assert np.abs(x_meshed.numpy() - x_jax).max() < TOL
    calls = [call[1:] for call in meshed.last_inner_calls]
    assert calls == [call[1:] for call in single.last_inner_calls] == [call[1:] for call in theirs.last_inner_calls]
    assert meshed.last_inner_iterations == single.last_inner_iterations
    if fields.get("refine_motion_every"):
        assert float((meshed.shifts - single.shifts).abs().max()) < TOL
        assert np.abs(meshed.shifts.numpy() - np.asarray(theirs.shifts)).max() < TOL
        assert float((meshed.shifts - torch.tensor(start)).abs().max()) > 1e-3   # the refinement moved them


def test_reweighting_at_the_seam_gives_the_single_device_weights():
    """One IRLS round apart, the weights placed on the shards are the single-device ones, exactly."""
    lows = _frames(1, (32, 48), FRACTIONAL)
    fields = dict(least_squares_solver="linear_cg", max_num_irls_iterations=2, max_num_solver_iterations=5)
    seen = {}
    for label, axes in (("single", None), ("meshed", {"row": 2, "col": 2})):
        solver = _port_solver(lows, FRACTIONAL, ["tv"], 1e-3, axes, **fields)
        reweight = solver._reweight
        solver._reweight = lambda x, keep=seen.setdefault(label, []), f=reweight: (keep.append((x, f(x))), keep[-1][1])[1]
        solver.solve(linear_resize(torch.from_numpy(lows[0]), (32, 48)).numpy())
    (x_single, w_single), (x_meshed, w_meshed) = seen["single"][0], seen["meshed"][0]
    assert float((x_single - x_meshed).abs().max()) < 1e-12
    same = x_single == x_meshed
    assert torch.equal(w_single[0][same], w_meshed[0][same]) or float((w_single[0] - w_meshed[0]).abs().max() / w_single[0].abs().max()) < 1e-6


FALLBACKS = [
    # mesh, regularisers, channels, HR size, the port's reason, what the JAX solver does
    ({"row": 2, "col": 2}, ["tv3d"], 2, (32, 48), "regularizers not tileable", "warns"),
    ({"row": 2, "col": 2}, ["tv", "btv"], 1, (32, 48), "regularizers not tileable", "warns"),
    ({"row": 2, "band": 4}, ["tv"], 2, (32, 48), "2 channels not divisible by the band axis", "warns"),
    ({"row": 2, "frame": 3}, ["tv"], 1, (32, 48), "4 frames not divisible by the frame axis", "warns"),
    ({"band": 2}, ["tv", "btv"], 2, (32, 48), "regularizers not kernel-fusable", "warns"),
    ({"frame": 1}, ["tv"], 1, (32, 48), "needs a 'frame' axis larger than 1 or a 'band' axis", "warns"),
    # Placements that the JAX solver cannot even make (its device_put refuses an uneven split).
    ({"row": 4}, ["tv"], 1, (36, 48), "not divisible into 4x1 scale-aligned tiles", "raises"),
    ({"band": 4}, ["tv"], 2, (32, 48), "2 channels not divisible by the band axis", "raises"),
    ({"frame": 3}, ["btv"], 1, (32, 48), "4 frames not divisible by the frame axis", "raises"),
]


@pytest.mark.parametrize("mesh_axes,kinds,c,hw,reason,jax_answer", FALLBACKS,
                         ids=["-".join(f"{k}{v}" for k, v in case[0].items()) + "-" + "+".join(case[1]) for case in FALLBACKS])
def test_what_jax_answers_with_a_fallback_warning_raises(mesh_axes, kinds, c, hw, reason, jax_answer):
    lows = _frames(c, hw, INTEGER)
    n = int(np.prod(list(mesh_axes.values())))
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual JAX devices")
    jmesh = jax_make_mesh(mesh_axes, jax.devices()[:n])
    if jax_answer == "raises":
        with pytest.raises(ValueError, match="divisible"):
            _jax_solver(lows, INTEGER, kinds, 1e-3, mesh=jmesh)
    else:
        theirs = _jax_solver(lows, INTEGER, kinds, 1e-3, mesh=jmesh)
        with pytest.warns(RuntimeWarning, match="falling back"):   # routing only: nothing is solved
            theirs._build_inner_solver(c, JOptions(use_pallas_data_term=True, pallas_shift_bound=2.0, fused_irls=False))
    ours = _port_solver(lows, INTEGER, kinds, 1e-3, mesh_axes, max_num_irls_iterations=1, max_num_solver_iterations=2)
    with pytest.raises(ValueError, match=reason):
        ours.solve(np.zeros((c, *hw)))


def test_refinement_on_a_mesh_needs_a_pure_frame_mesh():
    lows = _frames(2, (32, 48), FRACTIONAL)
    for axes in ({"row": 2, "col": 2}, {"band": 2}, {"frame": 2, "band": 2}):
        solver = _port_solver(lows, FRACTIONAL, ["tv"], 1e-3, axes, refine_motion_every=1)
        with pytest.raises(ValueError, match="pure frame mesh"):
            solver.solve(np.zeros((2, 32, 48)))


def test_convert_carries_the_mesh():
    lows = _frames(2, (32, 48), INTEGER)
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual JAX devices")
    jmesh = jax_make_mesh({"row": 2, "col": 2}, jax.devices()[:4])
    axis_sizes = {name: int(size) for name, size in zip(jmesh.axis_names, jmesh.devices.shape)}
    mesh = convert.mesh(axis_sizes, devices=["cpu"])
    assert isinstance(mesh, Mesh) and mesh.shape == {"row": 2, "col": 2} and convert.mesh(None) is None
    options = dataclasses.asdict(JOptions(least_squares_solver="linear_cg", max_num_irls_iterations=2,
                                          max_num_solver_iterations=6))
    problem = ({"motion_sequence": np.asarray(INTEGER, dtype=float), **PARAMS}, options, [("tv", {}, 1e-3)], np.stack(lows))
    meshed = convert.irls_solver(*problem, device="cpu", dtype=torch.float64, mesh_axis_sizes=axis_sizes)
    single = convert.irls_solver(*problem, device="cpu", dtype=torch.float64)
    assert meshed.mesh.shape == {"row": 2, "col": 2} and single.mesh is None
    x0 = linear_resize(torch.from_numpy(lows[0]), (32, 48))
    assert float((meshed.solve(x0) - single.solve(x0)).abs().max()) < TOL
