"""The port's resizers against the JAX package's, float64 on the CPU.

Same numpy inputs on both sides. ``atol 1e-12``: both compute the same index
plans with numpy and the same weighted sums of selected rows and columns.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# ``ops/__init__`` re-exports a function named ``resize`` that shadows the
# submodule as an attribute, so fetch the submodules by their full names.
jresize = importlib.import_module("super_resolution_tpu.ops.resize")
resize = importlib.import_module("super_resolution_tpu_torch.ops.resize")

ATOL = 1e-12
SIZES = [((12, 10), (24, 20)), ((12, 10), (6, 5)), ((9, 7), (20, 13)), ((8, 8), (3, 11)), ((5, 6), (5, 6)), ((1, 4), (3, 9))]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(ours, theirs):
    assert ours.dtype == torch.float64
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0.0, atol=ATOL)


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
@pytest.mark.parametrize("hw,out_hw", SIZES)
def test_interpolating_resizers_match_jax(method, hw, out_hw):
    x = np.random.default_rng(1).random((2, *hw))
    xt = torch.from_numpy(x)
    _close(resize.resize(xt, out_hw, method), jresize.resize(jnp.asarray(x), out_hw, method))
    fn = getattr(resize, f"{method}_resize")
    _close(fn(xt[0], out_hw), getattr(jresize, f"{method}_resize")(jnp.asarray(x[0]), out_hw))


@pytest.mark.parametrize("hw,out_hw", [((4, 6), (8, 12)), ((4, 6), (12, 12)), ((8, 12), (4, 6)), ((9, 12), (3, 4)), ((9, 13), (4, 6)), ((4, 6), (4, 6))])
def test_additive_resize_matches_jax(hw, out_hw):
    x = np.random.default_rng(2).random((3, *hw))
    xt = torch.from_numpy(x)
    _close(resize.additive_resize(xt, out_hw), jresize.additive_resize(jnp.asarray(x), out_hw))
    _close(resize.resize(xt, out_hw, "additive"), jresize.resize(jnp.asarray(x), out_hw, "additive"))
    if out_hw[0] <= hw[0] and out_hw != hw:
        _close(resize.block_sum_downsample(xt, out_hw), jresize.block_sum_downsample(jnp.asarray(x), out_hw))


def test_additive_round_trip_and_adjointness():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((2, 5, 7)))
    up = resize.additive_resize(x, (15, 21))
    assert torch.equal(resize.additive_resize(up, (5, 7)), x)
    # Additive upsampling is the adjoint of top-left decimation.
    y = torch.from_numpy(rng.random((2, 15, 21)))
    lhs = (resize.decimate(y, 3) * x).sum()
    rhs = (y * resize.zero_upsample(x, 3)).sum()
    assert abs(float(lhs - rhs)) < 1e-12


def test_resize_rejects_what_the_reference_rejects():
    x = torch.zeros(1, 4, 6)
    with pytest.raises(ValueError, match="additive"):
        resize.additive_resize(x, (8, 3))
    with pytest.raises(ValueError, match="Unknown resize method"):
        resize.resize(x, (8, 12), "lanczos")
    with pytest.raises(ValueError):
        resize.zero_upsample(x, 2, (6, 12))


def test_linear_resize_keeps_dtype_and_device_of_its_input():
    x = torch.rand(3, 6, 5, dtype=torch.float32)
    out = resize.linear_resize(x, (12, 10))
    assert out.dtype == torch.float32 and out.shape == (3, 12, 10) and out.device == x.device
    # A constant image stays constant (the taps of each output sum to one).
    flat = resize.cubic_resize(torch.full((1, 4, 4), 0.25, dtype=torch.float64), (9, 7))
    assert (flat - 0.25).abs().max() < 1e-14
