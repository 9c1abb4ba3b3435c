"""The hyperspectral slice as a whole, port against JAX: a many-band cube
solved in one objective with the 3D spectral TV term, and the PCA-space
solve (project the LR cube, solve the few components, back-project).

Six bands, float64 on the CPU, the same numpy LR frames and initial estimate
on both sides. Images agree within ``1e-6`` max abs difference, the tolerance
of ``test_torch_irls.py`` (same algorithm; rounding amplified by a few IRLS
rounds of CG). The JAX solver runs its plain objective
(``use_pallas_data_term=False``).
"""

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
from super_resolution_tpu.spectral import SpectralPCA as JPCA

from super_resolution_tpu_torch import IRLSMapSolver, IRLSMapSolverOptions, ImageModel, ImageModelParameters
from super_resolution_tpu_torch import SpectralPCA, convert
from super_resolution_tpu_torch.evaluation import psnr
from super_resolution_tpu_torch.motion import MotionShiftSequence
from super_resolution_tpu_torch.ops.resize import linear_resize
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer

SHIFTS = [(0, 0), (1, 1), (0, 1), (1, 0)]
PARAMS = dict(scale=2, blur_radius=3, blur_sigma=1.0)
TOL = 1e-6
BANDS, HW = 6, (24, 28)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cube(seed=50):
    """Two abundance maps mixed by smooth spectra, plus a little noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: HW[0], : HW[1]]
    maps = np.stack([0.5 + 0.3 * np.sin(xx / 3.0) * np.cos(yy / 4.0), 0.5 + 0.3 * np.cos(xx / 5.0 + yy / 7.0)])
    maps[0, 8:14, 6:16] += 0.2
    lam = np.linspace(0.0, 1.0, BANDS)[:, None]
    sigs = np.exp(-((lam - np.array([0.25, 0.75])) ** 2) / (2 * 0.3**2))
    return np.clip(np.tensordot(sigs, maps, axes=1) * 0.6 + 0.002 * rng.standard_normal((BANDS, *HW)), 0, 1)


def _frames(cube):
    model = ImageModel.create(ImageModelParameters(motion_sequence=MotionShiftSequence(SHIFTS), **PARAMS))
    return [model.apply(torch.from_numpy(cube), k).numpy() for k in range(len(SHIFTS))]


def _solvers(lows, use_3d, lam=0.01, **fields):
    model = ImageModel.create(ImageModelParameters(motion_sequence=MotionShiftSequence(SHIFTS), **PARAMS))
    jmodel = JImageModel.create(JParameters(motion_sequence=JSequence(SHIFTS), **PARAMS))
    ours = IRLSMapSolver(IRLSMapSolverOptions(**fields), model, lows, device="cpu", dtype=torch.float64)
    theirs = JSolver(JOptions(use_pallas_data_term=False, **fields), jmodel, [jnp.asarray(f) for f in lows])
    ours.add_regularizer(TotalVariationRegularizer(use_3d), lam)
    theirs.add_regularizer(JTV(use_3d), lam)
    return ours, theirs


def _start(lows):
    return linear_resize(torch.from_numpy(lows[0]), HW).numpy()


@pytest.mark.parametrize(
    "use_3d,fields",
    [
        (True, dict(least_squares_solver="linear_cg", max_num_irls_iterations=3, max_num_solver_iterations=12)),
        (True, dict(max_num_irls_iterations=2, max_num_solver_iterations=10)),
        (False, dict(least_squares_solver="linear_cg", max_num_irls_iterations=2, max_num_solver_iterations=12)),
        (True, dict(split_channels=True, max_num_irls_iterations=2, max_num_solver_iterations=6)),
    ],
)
def test_many_band_solve_matches_jax(use_3d, fields):
    cube = _cube()
    lows = _frames(cube)
    ours, theirs = _solvers(lows, use_3d, **fields)
    x0 = _start(lows)
    x = ours.solve(x0)
    jx = np.asarray(theirs.solve(jnp.asarray(x0)))
    assert x.shape == (BANDS, *HW)
    assert np.abs(x.numpy() - jx).max() < TOL
    assert [c[1:] for c in ours.last_inner_calls] == [c[1:] for c in theirs.last_inner_calls]
    assert float(psnr(x, cube)) > float(psnr(x0, cube))


def test_3d_tv_couples_the_bands_and_split_channels_undoes_it():
    cube = _cube()
    lows = _frames(cube)
    fields = dict(least_squares_solver="linear_cg", max_num_irls_iterations=2, max_num_solver_iterations=8)
    x0 = _start(lows)
    solve = lambda use_3d, **kw: _solvers(lows, use_3d, **fields, **kw)[0].solve(x0)
    assert (solve(True) - solve(False)).abs().max() > 1e-4
    # One band per inner solve: the spectral difference is zero, 3D is 2D.
    assert torch.equal(solve(True, split_channels=True), solve(False, split_channels=True))


def test_pca_space_solve_matches_jax():
    cube = _cube()
    lows = _frames(cube)
    jpca = JPCA(lows, num_pca_bands=2)
    pca = SpectralPCA(lows, num_pca_bands=2)
    np.testing.assert_allclose(pca.basis, jpca.basis, rtol=0, atol=1e-12)
    pca = convert.spectral_pca(jpca.mean, jpca.basis)

    lows_pca = [pca.project(torch.from_numpy(f)).numpy() for f in lows]
    jlows_pca = [np.asarray(jpca.project(jnp.asarray(f))) for f in lows]
    for a, b in zip(lows_pca, jlows_pca):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)

    fields = dict(least_squares_solver="linear_cg", max_num_irls_iterations=3, max_num_solver_iterations=12)
    ours, theirs = _solvers(lows_pca, False, lam=0.005, **fields)
    x0 = linear_resize(torch.from_numpy(lows_pca[0]), HW).numpy()
    x_pca = ours.solve(x0)
    jx_pca = theirs.solve(jnp.asarray(x0))
    assert x_pca.shape == (2, *HW)
    assert np.abs(x_pca.numpy() - np.asarray(jx_pca)).max() < TOL
    recon = pca.back_project(x_pca)
    jrecon = np.asarray(jpca.back_project(jx_pca))
    assert recon.shape == (BANDS, *HW)
    assert np.abs(recon.numpy() - jrecon).max() < TOL
    # The PCA coefficients have their mean taken off, so the zero borders of
    # warp and blur no longer match the projected frames there (on both
    # sides alike) and the solve is wrong in a border band. Away from it the
    # solved cube beats linear upsampling of the LR cube.
    inner = (slice(None), slice(8, -8), slice(8, -8))
    assert float(psnr(recon[inner], cube[inner])) > float(psnr(_start(lows)[inner], cube[inner])) + 1.0


def test_convert_builds_a_3d_tv_regulariser():
    (reg, lam), = convert.regularizers([("tv", {"use_3d": True}, 0.02)])
    assert isinstance(reg, TotalVariationRegularizer) and reg.use_3d and lam == 0.02
    (reg2, _), = convert.regularizers([("tv", {}, 0.02)])
    assert not reg2.use_3d
    lows = _frames(_cube())
    solver = convert.irls_solver({**PARAMS, "motion_sequence": np.asarray(SHIFTS, dtype=float)},
                                 {"max_num_irls_iterations": 1, "max_num_solver_iterations": 3},
                                 [("tv", {"use_3d": True}, 0.01)], np.stack(lows), device="cpu", dtype=torch.float64)
    assert solver.regularizers[0][0].use_3d
    assert solver.solve(_start(lows)).shape == (BANDS, *HW)
