"""3D (spectral) total variation: the port's plain versions against the JAX package.

Inputs are made with numpy from a seed and handed to both sides, float64 on
the CPU.

- ``ops/tv.py`` with ``use_3d`` against ``super_resolution_tpu.ops.tv``:
  ``atol 1e-12`` (the same float64 arithmetic in the same order).
- The plain fused objective with ``tv_use_3d`` against the Pallas TPU kernel
  in interpret mode (static shifts, its shift-generic mode with the shifts as
  a traced float64 array, and its channel-block grid): gradient within
  ``1e-10`` of its largest entry (summation order); cost ``rtol 1e-6``,
  because the Pallas kernel accumulates its cost in float32 whatever the
  input type. Each interpret-mode configuration is compiled once (tile 16,
  ``shift_bound`` 2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.ops import tv as jtv
from super_resolution_tpu.ops.pallas.degrade import pallas_data_term_cost_and_grad

from super_resolution_tpu_torch.ops import tv
from super_resolution_tpu_torch.ops.cuda import degrade
from super_resolution_tpu_torch.solvers.objective import make_map_value_and_grad

ATOL = 1e-12
INTEGER = [(0, 0), (1, 1), (0, 1), (1, 0)]
FRACTIONAL = [(0, 0), (0.5, -0.5), (1.25, 0.75)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cube(shape, seed):
    x = np.random.default_rng(seed).random(shape)
    if shape[1] > 5:
        x[:, 2:5, 3:7] = 0.5       # equal neighbours in the plane: sign(0) = 0
    if shape[0] > 2:
        x[1, 5:, :4] = x[2, 5:, :4]  # equal neighbours across bands
    return x


def _close(ours, theirs):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0.0, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 9, 11), (5, 8, 8), (1, 7, 6), (4, 1, 6)])
def test_tv3d_matches_jax(shape):
    x, c = _cube(shape, 10), np.random.default_rng(11).random(shape)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    _close(tv.tv_residuals(xt, use_3d=True), jtv.tv_residuals(jnp.asarray(x), use_3d=True))
    cost, grad = tv.tv_cost_and_grad(xt, ct, use_3d=True)
    jcost, jgrad = jtv.tv_cost_and_grad(jnp.asarray(x), jnp.asarray(c), use_3d=True)
    _close(cost, jcost)
    _close(grad, jgrad)
    reg, jreg = tv.TotalVariationRegularizer(True), jtv.TotalVariationRegularizer(True)
    assert reg.use_3d is True
    _close(reg.residuals(xt), jreg.residuals(jnp.asarray(x)))
    _close(reg.cost_and_grad(xt, ct)[1], jgrad)


def test_tv3d_of_one_band_is_the_2d_term():
    x, c = _cube((1, 9, 11), 12), np.random.default_rng(13).random((1, 9, 11))
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    assert torch.equal(tv.tv_residuals(xt, use_3d=True), tv.tv_residuals(xt))
    for a, b in zip(tv.tv_cost_and_grad(xt, ct, use_3d=True), tv.tv_cost_and_grad(xt, ct)):
        assert torch.equal(a, b)


def test_tv3d_gradient_is_the_derivative_of_its_cost_at_fixed_weights():
    """With ``G = 2 c r`` held fixed the gradient is that of ``sum c r^2``:
    checked against central differences away from kinks."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.random((3, 5, 6)))
    c = torch.from_numpy(rng.random((3, 5, 6)))
    _, grad = tv.tv_cost_and_grad(x, c, use_3d=True)
    eps = 1e-7
    for idx in [(0, 0, 0), (1, 2, 3), (2, 4, 5), (2, 0, 1)]:
        hi, lo = x.clone(), x.clone()
        hi[idx] += eps
        lo[idx] -= eps
        numeric = (tv.tv_cost_and_grad(hi, c, use_3d=True)[0] - tv.tv_cost_and_grad(lo, c, use_3d=True)[0]) / (2 * eps)
        assert abs(float(numeric) - float(grad[idx])) < 1e-6


def _problem(c, hw, scale, shifts, seed):
    rng = np.random.default_rng(seed)
    x = _cube((c, *hw), seed)
    y = rng.random((len(shifts), c, hw[0] // scale, hw[1] // scale))
    kern = rng.random((3, 3))
    kern /= kern.sum()
    return x, y, np.asarray(shifts, dtype=np.float64), kern, rng.random((c, *hw)) * 0.05


def _assert_same(ours, theirs):
    (our_cost, our_grad), (cost, grad) = ours, theirs
    assert degrade.launch_counts == {name: 0 for name in degrade.KERNEL_NAMES}
    assert abs(float(our_cost) - float(cost)) <= 1e-6 * abs(float(cost))
    grad = np.asarray(grad)
    assert np.abs(our_grad.numpy() - grad).max() <= 1e-10 * np.abs(grad).max()


@pytest.mark.parametrize(
    "c,hw,scale,shifts",
    [(5, (32, 32), 2, INTEGER), (3, (22, 26), 2, FRACTIONAL), (1, (20, 20), 2, INTEGER[:2])],
)
def test_plain_tv3d_objective_matches_pallas_interpret(c, hw, scale, shifts):
    x, y, sh, kern, constants = _problem(c, hw, scale, shifts, seed=93)
    theirs = pallas_data_term_cost_and_grad(
        jnp.asarray(x), jnp.asarray(y), sh, kern, scale, tile=16, interpret=True,
        tv_constants=jnp.asarray(constants), tv_use_3d=True,
    )
    ours = degrade.fused_objective(
        torch.from_numpy(x), torch.from_numpy(y), sh, kern, scale,
        tv_constants=torch.from_numpy(constants), tv_use_3d=True,
    )
    _assert_same(ours, theirs)


def test_plain_objective_with_tensor_shifts_matches_pallas_shift_generic():
    """The TPU kernel's shift-generic mode takes the shifts as traced data;
    the port's wrapper takes them as a tensor. Same numbers either way."""
    x, y, sh, kern, constants = _problem(3, (26, 30), 2, [(0, 0), (1.5, -0.5), (-0.75, 1)], seed=99)
    theirs = pallas_data_term_cost_and_grad(
        jnp.asarray(x), jnp.asarray(y), None, kern, 2, tile=16, interpret=True,
        dynamic_shifts=jnp.asarray(sh), shift_bound=2.0,
        tv_constants=jnp.asarray(constants), tv_use_3d=True,
    )
    ours = degrade.fused_objective(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(sh), kern, 2,
        tv_constants=torch.from_numpy(constants), tv_use_3d=True)
    _assert_same(ours, theirs)


def test_plain_many_band_objective_matches_pallas_channel_block():
    """The TPU kernel walks the bands in blocks of a grid axis; the port has
    no such argument. Six bands, blocks of two, fused 2D TV."""
    x, y, sh, kern, constants = _problem(6, (24, 28), 2, [(0, 0), (1.5, -0.5)], seed=105)
    theirs = pallas_data_term_cost_and_grad(
        jnp.asarray(x), jnp.asarray(y), sh, kern, 2, tile=16, interpret=True,
        channel_block=2, tv_constants=jnp.asarray(constants),
    )
    ours = degrade.fused_objective(
        torch.from_numpy(x), torch.from_numpy(y), sh, kern, 2, tv_constants=torch.from_numpy(constants))
    _assert_same(ours, theirs)


def test_fused_tv3d_modes_and_arguments():
    x, y, sh, kern, constants = _problem(2, (8, 8), 2, INTEGER[:2], seed=3)
    xt, yt, ct = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(constants)
    assert "data_term_tv3d" in degrade.KERNEL_NAMES
    with pytest.raises(ValueError, match="tv_use_3d"):
        degrade.fused_objective(xt, yt, sh, kern, 2, tv_use_3d=True)
    with pytest.raises(ValueError, match="tv_use_3d"):
        degrade.fused_objective(xt, yt, sh, kern, 2, btv_constants=ct, btv_range=2, tv_use_3d=True)
    # The source has the mode, beside the 2D one.
    from super_resolution_tpu_torch.ops.cuda import build
    text = (build.CSRC_DIR / "degrade.cu").read_text()
    assert "MODE_TV3D = 3" in text and "gradient_kernel_for_scale<T, MODE_TV3D" in text


@pytest.mark.parametrize("use_3d", [False, True])
def test_objective_fuses_a_tv_term_and_takes_shifts_per_call(use_3d):
    """One 3D TV regulariser is fused (same numbers as data term + plain TV
    term), and ``prepare(weights, shifts)`` swaps the motion without a rebuild."""
    x, y, sh, kern, _ = _problem(3, (12, 16), 2, FRACTIONAL, seed=21)
    weights = (torch.from_numpy(np.random.default_rng(22).random(x.shape)),)
    reg = tv.TotalVariationRegularizer(use_3d)
    vg = make_map_value_and_grad(y, sh, kern, 2, [(reg, 0.01)], device="cpu", dtype=torch.float64)
    xt = torch.from_numpy(x)
    cost, grad = vg(xt, weights)
    d_cost, d_grad = degrade.fused_objective_reference(xt, torch.from_numpy(y), sh, kern, 2)
    r_cost, r_grad = tv.tv_cost_and_grad(xt, 0.01 * weights[0], use_3d=use_3d)
    assert abs(float(cost) - float(d_cost + r_cost)) <= 1e-12 * float(cost)
    assert (grad - (d_grad + r_grad)).abs().max() <= 1e-12 * grad.abs().max()

    other = torch.from_numpy(sh + np.array([[0.0, 0.0], [0.25, -1.0], [-3.5, 0.5]]))
    cost2, grad2 = vg.prepare(weights, other)(xt)
    fresh = make_map_value_and_grad(y, other, kern, 2, [(reg, 0.01)], device="cpu", dtype=torch.float64)
    cost3, grad3 = fresh(xt, weights)
    assert float(cost2) == float(cost3) and torch.equal(grad2, grad3)
    assert float(cost2) != float(cost)
    # Per call as well, and the shifts given when the objective was made are untouched.
    assert torch.equal(vg(xt, weights, other)[1], grad2)
    assert torch.equal(vg(xt, weights)[1], grad)
