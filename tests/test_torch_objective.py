"""The fused objective's plain PyTorch version against the JAX package.

Reference: the unfused JAX functions (``data_term_cost_and_grad_static`` plus
``tv_cost_and_grad`` / ``btv_cost_and_grad``), float64 on the CPU, same numpy
inputs: cost ``rtol 1e-10``, gradient within ``1e-10`` of its largest entry
(summation order). One case for each place where a port goes wrong easily.
The comparison with the Pallas kernel itself is in
``test_torch_objective_pallas.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.ops.btv import btv_cost_and_grad as jbtv_cost_and_grad
from super_resolution_tpu.ops.tv import tv_cost_and_grad as jtv_cost_and_grad
from super_resolution_tpu.solvers.objective import (
    data_term_cost_and_grad_static as jdata_static,
    make_map_value_and_grad as jmake,
)
from super_resolution_tpu.ops.tv import TotalVariationRegularizer as JTV
from super_resolution_tpu.ops.btv import BilateralTotalVariationRegularizer as JBTV

from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu_torch.ops.cuda import degrade
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
from super_resolution_tpu_torch.solvers.objective import (
    data_term_cost_and_grad,
    data_term_cost_and_grad_static,
    make_map_value_and_grad,
)

RTOL = 1e-10
FRACTIONAL = [(0, 0), (1.25, -0.5), (-2, 3), (0.5, 0.5)]
INTEGER = [(0, 0), (1, 1), (0, 1), (-1, 2)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _problem(c, hw, scale, shifts, kernel_shape=(3, 3), seed=0, flat=False):
    rng = np.random.default_rng(seed)
    x = rng.random((c, *hw))
    if flat:  # equal neighbours: sign(0) must be 0
        x[:, 1:6, 2:9] = 0.25
        x[:, :2, :2] = 0.75
    y = rng.random((len(shifts), c, hw[0] // scale, hw[1] // scale))
    kern = None
    if kernel_shape is not None:
        kern = rng.random(kernel_shape)
        kern /= kern.sum()
    constants = rng.random((c, *hw))
    return x, y, np.asarray(shifts, dtype=np.float64), kern, constants


def _ours(x, y, shifts, kern, scale, mode, constants, p=3, a=0.5):
    kw = {}
    if mode == "tv":
        kw = dict(tv_constants=torch.from_numpy(constants))
    elif mode == "btv":
        kw = dict(btv_constants=torch.from_numpy(constants), btv_range=p, btv_decay=a)
    cost, grad = degrade.fused_objective(torch.from_numpy(x), torch.from_numpy(y), shifts, kern, scale, **kw)
    return float(cost), grad.numpy()


def _unfused_jax(x, y, shifts, kern, scale, mode, constants, p=3, a=0.5):
    cost, grad = jdata_static(jnp.asarray(x), jnp.asarray(y), shifts, None if kern is None else jnp.asarray(kern), scale)
    if mode == "tv":
        c, g = jtv_cost_and_grad(jnp.asarray(x), jnp.asarray(constants))
        cost, grad = cost + c, grad + g
    elif mode == "btv":
        c, g = jbtv_cost_and_grad(jnp.asarray(x), jnp.asarray(constants), p, a)
        cost, grad = cost + c, grad + g
    return float(cost), np.asarray(grad)


def _assert_close(ours, theirs, cost_rtol=RTOL):
    (cost, grad), (ref_cost, ref_grad) = ours, theirs
    assert abs(cost - ref_cost) <= cost_rtol * abs(ref_cost), (cost, ref_cost)
    assert np.abs(grad - ref_grad).max() <= RTOL * np.abs(ref_grad).max()


@pytest.mark.parametrize("mode", [None, "tv", "btv"])
@pytest.mark.parametrize("c,hw,scale", [(1, (21 * 2, 13 * 2), 2), (3, (5 * 4, 9 * 4), 4)])
def test_plain_version_matches_unfused_jax(mode, c, hw, scale):
    args = _problem(c, hw, scale, FRACTIONAL, seed=41, flat=True)
    _assert_close(_ours(*args[:4], scale, mode, args[4]), _unfused_jax(*args[:4], scale, mode, args[4]))


# Past the CUDA kernels' staged and tabled instantiations: a scale whose
# footprint of x does not fit a block's shared memory (s = 16), and a blur
# past the composite table (33x33). The plain version is what the kernels are
# held to on the card; here it is held to the JAX package.
BEYOND = {
    "s16": dict(c=1, hw=(64, 48), scale=16, shifts=[(0.5, -0.25), (1.75, 1.25)], kernel_shape=(3, 3)),
    "blur33": dict(c=1, hw=(40, 36), scale=2, shifts=[(0.5, -0.25), (1.75, 1.25)], kernel_shape=(33, 33)),
}


@pytest.mark.parametrize("mode", [None, "tv", "btv"])
@pytest.mark.parametrize("case", sorted(BEYOND))
def test_plain_version_matches_unfused_jax_past_the_staging_and_the_tap_table(case, mode):
    p = BEYOND[case]
    args = _problem(p["c"], p["hw"], p["scale"], p["shifts"], p["kernel_shape"], seed=51, flat=True)
    _assert_close(_ours(*args[:4], p["scale"], mode, args[4]), _unfused_jax(*args[:4], p["scale"], mode, args[4]))


def test_trouble_1_borders_are_zeroed_between_warp_and_blur():
    # A shift that pushes content across the border, on an image so small
    # that every pixel lies in the border band of the 5x5 blur.
    x, y, shifts, kern, constants = _problem(1, (8, 8), 2, [(2.5, -1.5), (-3, 2)], (5, 5), seed=42)
    ours = _ours(x, y, shifts, kern, 2, None, constants)
    _assert_close(ours, _unfused_jax(x, y, shifts, kern, 2, None, constants))
    # Merging warp and blur (warping a zero-padded image, blurring, cropping)
    # is a different function here: the match above is not vacuous.
    pad = 8
    xt = torch.from_numpy(np.pad(x, [(0, 0), (pad, pad), (pad, pad)]))
    yt = torch.from_numpy(np.pad(y, [(0, 0), (0, 0), (pad // 2, pad // 2), (pad // 2, pad // 2)]))
    merged_cost, merged_grad = degrade.fused_objective_reference(xt, yt, shifts, kern, 2)
    assert np.abs(merged_grad.numpy()[:, pad:-pad, pad:-pad] - ours[1]).max() > 1e-3


@pytest.mark.parametrize("shifts", [[(-0.25, -1.75)], [(-3.0, 2.0)], [(2.6, 0.0)], [(0.0, -0.4)]])
def test_trouble_2_warp_direction_and_tap_offsets(shifts):
    args = _problem(2, (12, 16), 2, shifts, None, seed=43)
    _assert_close(_ours(*args[:4], 2, None, args[4]), _unfused_jax(*args[:4], 2, None, args[4]))


@pytest.mark.parametrize("kernel_shape", [(3, 3), (4, 4), (2, 5), (5, 2)])
def test_trouble_3_blur_adjoint_is_correlation_with_transpose(kernel_shape):
    # Non-symmetric taps, even sizes: flipping instead of transposing, or a
    # wrong anchor, changes the gradient.
    args = _problem(1, (16, 20), 2, INTEGER, kernel_shape, seed=44)
    _assert_close(_ours(*args[:4], 2, None, args[4]), _unfused_jax(*args[:4], 2, None, args[4]))


@pytest.mark.parametrize("mode", ["tv", "btv"])
def test_trouble_4_sign_of_zero_is_zero(mode):
    x, y, shifts, kern, constants = _problem(1, (12, 12), 2, INTEGER, seed=45)
    x[:] = 0.5  # every difference is exactly zero
    cost, grad = _ours(x, y, shifts, kern, 2, mode, constants)
    data_cost, data_grad = _ours(x, y, shifts, kern, 2, None, constants)
    assert cost == data_cost
    np.testing.assert_array_equal(grad, data_grad)


@pytest.mark.parametrize("hw", [(4, 4), (6, 10)])
def test_trouble_5_btv_windows_and_origin_skip(hw):
    args = _problem(2, hw, 2, [(0, 0)], None, seed=46)
    ours = _ours(*args[:4], 2, "btv", args[4], p=3, a=0.5)
    _assert_close(ours, _unfused_jax(*args[:4], 2, "btv", args[4], p=3, a=0.5))
    # The exclusive gradient window makes P=1 a term with cost but no gradient.
    cost1, grad1 = _ours(*args[:4], 2, "btv", args[4], p=1, a=0.5)
    cost0, grad0 = _ours(*args[:4], 2, None, args[4])
    assert cost1 > cost0
    np.testing.assert_array_equal(grad1, grad0)


@pytest.mark.parametrize("scale", [2, 4])
def test_trouble_6_data_term_scaled_regulariser_not(scale):
    x, y, shifts, kern, constants = _problem(1, (16, 16), scale, INTEGER, seed=47)
    data_cost, data_grad = _ours(x, y, shifts, kern, scale, None, constants)
    tv_cost, tv_grad = _ours(x, y, shifts, kern, scale, "tv", constants)
    jc, jg = jtv_cost_and_grad(jnp.asarray(x), jnp.asarray(constants))
    assert abs((tv_cost - data_cost) - float(jc)) <= 1e-10 * tv_cost
    np.testing.assert_allclose(tv_grad - data_grad, np.asarray(jg), rtol=0, atol=1e-10 * np.abs(tv_grad).max())
    # s^2 on the data cost: against the explicit residual sum.
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    from super_resolution_tpu_torch.models.image_model import degrade as degrade_one

    plain = sum(float(((degrade_one(xt, dx, dy, kern, scale) - yt[k]) ** 2).sum()) for k, (dx, dy) in enumerate(shifts))
    assert abs(data_cost - scale * scale * plain) <= 1e-12 * data_cost


@pytest.mark.parametrize(
    "regs",
    [
        [],
        [("tv", 0.01)],
        [("btv", 0.02)],
        [("tv", 0.01), ("btv", 0.02)],
        [("tv", 0.0)],
    ],
)
def test_make_map_value_and_grad_matches_jax(regs):
    x, y, shifts, kern, constants = _problem(2, (16, 20), 2, FRACTIONAL, seed=48, flat=True)
    ours_regs = [(TotalVariationRegularizer() if k == "tv" else BilateralTotalVariationRegularizer(2, 0.7), lam) for k, lam in regs]
    jax_regs = [(JTV() if k == "tv" else JBTV(2, 0.7), lam) for k, lam in regs]
    weights = [np.random.default_rng(50 + i).random(x.shape) + 0.5 for i in range(len(regs))]
    vg = make_map_value_and_grad(y, shifts, kern, 2, ours_regs, device="cpu", dtype=torch.float64)
    jvg = jmake(jnp.asarray(y), jnp.asarray(shifts), jnp.asarray(kern), 2, jax_regs, static_shifts=shifts)
    cost, grad = vg(torch.from_numpy(x), tuple(torch.from_numpy(w) for w in weights))
    jcost, jgrad = jvg(jnp.asarray(x), tuple(jnp.asarray(w) for w in weights))
    _assert_close((float(cost), grad.numpy()), (float(jcost), np.asarray(jgrad)))
    bound = vg.prepare(tuple(torch.from_numpy(w) for w in weights))
    cost2, grad2 = bound(torch.from_numpy(x))
    assert float(cost2) == float(cost) and torch.equal(grad2, grad)


def test_data_term_entry_points_and_unported_modes():
    x, y, shifts, kern, _ = _problem(1, (8, 12), 2, INTEGER, seed=49)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    a = data_term_cost_and_grad(xt, yt, shifts, kern, 2)
    b = data_term_cost_and_grad_static(xt, yt, shifts, kern, 2)
    assert float(a[0]) == float(b[0]) and torch.equal(a[1], b[1])
    # The gradient modes: the analytic cost, and its gradient up to rounding
    # (autodiff) or central differences, where the analytic gradient is the
    # true one: integer shifts and a kernel symmetric under transposition
    # and under a half turn (the analytic adjoint correlates with its transpose).
    sym = kern + kern.T
    sym = sym + sym[::-1, ::-1]
    analytic = data_term_cost_and_grad(xt, yt, shifts, sym, 2)
    for mode, tol in (("autodiff", 1e-10), ("numerical", 1e-5)):
        cost, grad = make_map_value_and_grad(y, shifts, sym, 2, diff_mode=mode, device="cpu",
                                             dtype=torch.float64)(xt)
        assert abs(float(cost) - float(analytic[0])) <= 1e-12 * float(analytic[0])
        assert float((grad - analytic[1]).abs().max()) <= tol
    with pytest.raises(ValueError):
        make_map_value_and_grad(y, shifts, kern, 2, diff_mode="other", device="cpu")
    with pytest.raises(ValueError):
        degrade.fused_objective(xt, yt[:, :, :-1], shifts, kern, 2)
    with pytest.raises(ValueError):
        degrade.fused_objective(xt, yt, shifts[:2], kern, 2)
    with pytest.raises(ValueError):
        degrade.fused_objective(xt, yt, shifts, kern, 2, tv_constants=xt, btv_constants=xt)
