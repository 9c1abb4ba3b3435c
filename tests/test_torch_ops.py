"""The port's operators against the JAX package's, float64 on the CPU.

Inputs are made with numpy from a seed and handed to both sides. Tolerance
``atol 1e-12``: both sides do the same float64 arithmetic, only the order of
a few additions differs (XLA's convolution vs a sum of shifted slices).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.evaluation import psnr as jpsnr
from super_resolution_tpu.motion import MotionShiftSequence as JSequence

from super_resolution_tpu_torch.evaluation import psnr
from super_resolution_tpu_torch.motion import MotionShift, MotionShiftSequence


def _modules(package):
    # ``ops/__init__`` re-exports a function named ``blur`` that shadows the
    # submodule as an attribute, so fetch the submodules by their full names.
    return [importlib.import_module(f"{package}.ops.{name}") for name in ("blur", "btv", "resize", "tv", "warp")]


jblur, jbtv, jresize, jtv, jwarp = _modules("super_resolution_tpu")
blur, btv, resize, tv, warp = _modules("super_resolution_tpu_torch")

ATOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _image(shape, seed):
    return np.random.default_rng(seed).random(shape)


def _close(ours, theirs):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0.0, atol=ATOL)


@pytest.mark.parametrize(
    "dx,dy",
    [(0.0, 0.0), (1.0, 2.0), (-2.0, 1.0), (0.5, -0.5), (1.25, 0.75), (-0.3, -1.6), (3.0, -0.25)],
)
def test_translate_matches_jax(dx, dy):
    x = _image((2, 11, 13), 1)
    xt = torch.from_numpy(x)
    _close(warp.translate_static(xt, dx, dy), jwarp.translate_static(jnp.asarray(x), dx, dy))
    _close(warp.translate(xt, dx, dy), jwarp.translate(jnp.asarray(x), dx, dy))
    _close(
        warp.translate_adjoint(xt, torch.tensor(dx, dtype=torch.float64), torch.tensor(dy, dtype=torch.float64)),
        jwarp.translate_adjoint(jnp.asarray(x), dx, dy),
    )


def test_translate_shift_larger_than_image_is_zero():
    x = torch.from_numpy(_image((1, 4, 5), 2))
    assert torch.count_nonzero(warp.translate_static(x, 7.0, 0.0)) == 0
    assert torch.count_nonzero(warp.translate_static(x, 0.0, -4.0)) == 0
    # The same for a shift that is a tensor (no static pad to outgrow).
    assert torch.count_nonzero(warp.translate(x, torch.tensor(7.0), torch.tensor(0.0))) == 0
    assert torch.count_nonzero(warp.translate(x, torch.tensor(0.5), torch.tensor(-40.0))) == 0


@pytest.mark.parametrize(
    "kernel_shape,seed",
    [((3, 3), 3), ((5, 5), 4), ((4, 4), 5), ((2, 3), 6), ((3, 4), 7), ((1, 1), 8)],
)
def test_blur_and_adjoint_match_jax(kernel_shape, seed):
    x = _image((3, 12, 10), seed)
    kern = _image(kernel_shape, seed + 100)  # not symmetric on purpose
    xt = torch.from_numpy(x)
    _close(blur.blur(xt, kern), jblur.blur(jnp.asarray(x), jnp.asarray(kern)))
    _close(blur.blur_adjoint(xt, kern), jblur.blur_adjoint(jnp.asarray(x), jnp.asarray(kern)))
    _close(blur.correlate2d(xt, torch.from_numpy(kern)), jblur.correlate2d(jnp.asarray(x), jnp.asarray(kern)))


@pytest.mark.parametrize("size,sigma", [(3, 1.0), (3, 1.5), (5, 0.8), (7, 2.0)])
def test_gaussian_kernels_match_jax(size, sigma):
    np.testing.assert_array_equal(blur.gaussian_kernel_1d(size, sigma), jblur.gaussian_kernel_1d(size, sigma))
    np.testing.assert_array_equal(blur.gaussian_kernel_2d(size, sigma), jblur.gaussian_kernel_2d(size, sigma))
    with pytest.raises(ValueError):
        blur.gaussian_kernel_1d(4, 1.0)


@pytest.mark.parametrize("scale", [1, 2, 3, 4])
def test_decimate_and_zero_upsample_match_jax(scale):
    x = _image((2, 12, 24), 9)
    xt = torch.from_numpy(x)
    low = resize.decimate(xt, scale)
    _close(low, jresize.decimate(jnp.asarray(x), scale))
    _close(resize.zero_upsample(low, scale), jresize.zero_upsample(jnp.asarray(low.numpy()), scale))
    _close(
        resize.zero_upsample(low, scale, (12 + 1, 24 + 2)),
        jresize.zero_upsample(jnp.asarray(low.numpy()), scale, (12 + 1, 24 + 2)),
    )


def _with_flat_patches(x):
    # Equal neighbours exercise sign(0) = 0.
    x[:, 2:5, 3:7] = 0.5
    x[:, 0, :] = x[:, 1, :]
    return x


@pytest.mark.parametrize("shape", [(1, 9, 11), (3, 8, 8), (2, 1, 6)])
def test_tv_matches_jax(shape):
    x = _image(shape, 10)
    if shape[1] > 5:
        x = _with_flat_patches(x)
    c = _image(shape, 11)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    _close(tv.tv_residuals(xt), jtv.tv_residuals(jnp.asarray(x)))
    cost, grad = tv.tv_cost_and_grad(xt, ct)
    jcost, jgrad = jtv.tv_cost_and_grad(jnp.asarray(x), jnp.asarray(c))
    _close(cost, jcost)
    _close(grad, jgrad)
    reg = tv.TotalVariationRegularizer()
    _close(reg.residuals(xt), jtv.TotalVariationRegularizer().residuals(jnp.asarray(x)))
    _close(reg.cost_and_grad(xt, ct)[1], jgrad)


@pytest.mark.parametrize("shape", [(3, 9, 11), (2, 8, 8), (6, 4, 5)])
def test_tv_3d_matches_jax(shape):
    x = _with_flat_patches(_image(shape, 16)) if shape[1] > 5 else _image(shape, 16)
    x[-1] = x[0]
    c = _image(shape, 17)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    _close(tv.tv_residuals(xt, use_3d=True), jtv.tv_residuals(jnp.asarray(x), use_3d=True))
    cost, grad = tv.tv_cost_and_grad(xt, ct, use_3d=True)
    jcost, jgrad = jtv.tv_cost_and_grad(jnp.asarray(x), jnp.asarray(c), use_3d=True)
    _close(cost, jcost)
    _close(grad, jgrad)
    reg = tv.TotalVariationRegularizer(use_3d_total_variation=True)
    _close(reg.residuals(xt), jtv.TotalVariationRegularizer(True).residuals(jnp.asarray(x)))
    _close(reg.cost_and_grad(xt, ct)[1], jgrad)
    # The last band has no forward neighbour: its residual is the 2D one.
    assert torch.equal(tv.tv_residuals(xt, use_3d=True)[-1], tv.tv_residuals(xt)[-1])


@pytest.mark.parametrize(
    "shape,scale_range,decay",
    [((1, 9, 11), 3, 0.5), ((3, 8, 8), 2, 0.7), ((2, 10, 7), 1, 1.0), ((1, 3, 3), 3, 0.5)],
)
def test_btv_matches_jax(shape, scale_range, decay):
    x = _image(shape, 12)
    if shape[1] > 5:
        x = _with_flat_patches(x)
    c = _image(shape, 13)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    _close(btv.btv_residuals(xt, scale_range, decay), jbtv.btv_residuals(jnp.asarray(x), scale_range, decay))
    cost, grad = btv.btv_cost_and_grad(xt, ct, scale_range, decay)
    jcost, jgrad = jbtv.btv_cost_and_grad(jnp.asarray(x), jnp.asarray(c), scale_range, decay)
    _close(cost, jcost)
    _close(grad, jgrad)
    reg = btv.BilateralTotalVariationRegularizer(scale_range, decay)
    _close(reg.cost_and_grad(xt, ct)[1], jgrad)
    with pytest.raises(ValueError):
        btv.BilateralTotalVariationRegularizer(0, 0.5)


def test_psnr_matches_jax():
    a, b = _image((3, 8, 9), 14), _image((3, 8, 9), 15)
    _close(psnr(torch.from_numpy(a), b), jpsnr(jnp.asarray(a), jnp.asarray(b)))
    _close(psnr(a[0], b[0]), jpsnr(jnp.asarray(a[0]), jnp.asarray(b[0])))
    assert torch.isinf(psnr(a, a))


def test_motion_shift_sequence_matches_jax(tmp_path):
    pairs = [(0, 0), (1.5, -0.25), (-2, 3)]
    ours, theirs = MotionShiftSequence(pairs), JSequence(pairs)
    np.testing.assert_array_equal(ours.as_array(), theirs.as_array())
    assert ours.max_abs_shift == theirs.max_abs_shift and len(ours) == 3
    assert ours[1] == MotionShift(1.5, -0.25)
    path = tmp_path / "shifts.txt"
    ours.save_sequence_to_file(str(path))
    np.testing.assert_array_equal(JSequence.from_file(str(path)).as_array(), ours.as_array())
    np.testing.assert_array_equal(MotionShiftSequence.from_file(str(path)).as_array(), ours.as_array())
    with pytest.raises(IndexError):
        ours[3]


# --- the CUDA wrapper's own checks (no card needed: they run before the library loads)

from super_resolution_tpu_torch.ops.cuda import build as cuda_build  # noqa: E402
from super_resolution_tpu_torch.ops.cuda import degrade  # noqa: E402


@pytest.fixture
def no_library(monkeypatch):
    """Any reach for the compiled kernels fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA library was reached")
    monkeypatch.setattr(degrade, "_library", refuse)
    monkeypatch.setattr(cuda_build, "load", refuse)


def _wrapper_problem(dtype=torch.float64):
    rng = np.random.default_rng(81)
    x = torch.as_tensor(rng.random((2, 12, 16)), dtype=dtype)
    y = torch.as_tensor(rng.random((3, 2, 6, 8)), dtype=dtype)
    return x, y, [(0, 0), (0.5, -1.25), (2, 1)], x * 0.01


def test_dtype_the_kernels_lack_is_refused_before_the_library(no_library):
    x, y, shifts, constants = _wrapper_problem(torch.float16)
    with pytest.raises(TypeError, match="float32 or float64"):
        degrade._launch(x, y, shifts, None, 2, "data_term_btv", constants, 3, 0.5,
                        (0, 0, 12, 16), False, None, False)


@pytest.mark.parametrize("mode", degrade.KERNEL_NAMES)
def test_cpu_tensor_never_reaches_the_library(no_library, mode):
    x, y, shifts, constants = _wrapper_problem()
    kw = {"data_term": {}, "data_term_tv": {"tv_constants": constants},
          "data_term_tv3d": {"tv_constants": constants, "tv_use_3d": True},
          "data_term_btv": {"btv_constants": constants, "btv_range": 8, "btv_decay": 0.5}}[mode]
    cost, grad = degrade.fused_objective(x, y, shifts, None, 2, **kw)
    ref_cost, ref_grad = degrade.fused_objective_reference(x, y, shifts, None, 2, **kw)
    assert float(cost) == float(ref_cost) and torch.equal(grad, ref_grad)


@pytest.mark.parametrize("mode", degrade.KERNEL_NAMES)
def test_cpu_tile_never_reaches_the_library(no_library, mode):
    x, y, shifts, constants = _wrapper_problem()
    kw = {"data_term": {}, "data_term_tv": {"tv_constants": constants},
          "data_term_tv3d": {"tv_constants": constants, "tv_use_3d": True, "spectral_halo": True},
          "data_term_btv": {"btv_constants": constants, "btv_range": 3, "btv_decay": 0.5}}[mode]
    kw.update(origin=(-2, 4), global_hw=(16, 24))
    cost, grad = degrade.fused_objective(x, y, shifts, None, 2, **kw)
    ref_cost, ref_grad = degrade.fused_objective_reference(x, y, shifts, None, 2, **kw)
    assert degrade.plain_version_calls["calls"] >= 2
    assert float(cost) == float(ref_cost) and torch.equal(grad, ref_grad)


def test_blur_larger_than_the_tap_table_is_refused_before_a_launch(monkeypatch):
    """The residual and gradient kernels hold (kh+1)(kw+1) composite taps per
    frame in a table of the library's size; a larger blur is refused with
    the limit named, before anything is launched."""
    import types
    fake = types.SimpleNamespace(sr_max_composite_taps=lambda: 1024, sr_max_btv_range=lambda: 8)
    monkeypatch.setattr(degrade, "_library", lambda: fake)
    x, y, shifts, constants = _wrapper_problem()
    with pytest.raises(ValueError, match="at most 1024"):
        degrade._launch(x, y, shifts, np.ones((32, 32)) / 1024.0, 2, "data_term_tv", constants, 0, 1.0,
                        (0, 0, 12, 16), False, None, False)


@pytest.mark.parametrize("dtype, largest", [(torch.float32, 15), (torch.float64, 10)])
def test_scale_past_the_residual_kernel_s_staging_is_refused_before_a_launch(monkeypatch, dtype, largest):
    """The residual kernel stages one frame's footprint of x in a block's
    shared memory; a scale whose footprint the library says does not fit is
    refused before anything is launched, with the largest scale that fits
    for that blur and type named."""
    import types
    fits = {(s, is_double) for s in range(1, 16) for is_double in (0, 1) if s <= (10 if is_double else 15)}
    fake = types.SimpleNamespace(sr_max_composite_taps=lambda: 1024, sr_max_btv_range=lambda: 8,
                                 sr_residual_staging=lambda s, kh, kw, is_double: int((s, is_double) in fits))
    monkeypatch.setattr(degrade, "_library", lambda: fake)
    rng = np.random.default_rng(82)
    x = torch.as_tensor(rng.random((1, 16, 32)), dtype=dtype)
    y = torch.as_tensor(rng.random((2, 1, 1, 2)), dtype=dtype)
    with pytest.raises(ValueError, match=f"3x3 blur in {dtype} holds scales up to {largest}; got 16"):
        degrade._launch(x, y, [(0, 0), (1, 1)], np.ones((3, 3)) / 9.0, 16, "data_term", None, 0, 1.0,
                        (0, 0, 16, 32), False, None, False)


def test_wrapper_modes_and_range_are_the_kernel_source_s():
    import re
    text = (cuda_build.CSRC_DIR / "degrade.cu").read_text()
    enum = {name: int(n) for name, n in re.findall(r"MODE_(\w+) = (\d+)", re.search(r"enum Mode \{([^}]*)\}", text).group(1))}
    suffix = {"data_term": "DATA", "data_term_tv": "TV", "data_term_btv": "BTV", "data_term_tv3d": "TV3D"}
    assert {name: enum[suffix[name]] for name in degrade.KERNEL_NAMES} == degrade._MODE_OF
