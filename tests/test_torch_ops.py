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


class _FakeLibrary:
    """Stands in for the compiled library: records what each launch entry
    point is handed, launches nothing."""

    def __init__(self):
        self.calls = []

    def sr_max_btv_range(self):
        return 8

    def sr_residual_blocks(self, c, h, w, s):
        return c * -(-(w // s) // 32) * -(-(h // s) // 8)

    def sr_gradient_blocks(self, mode, c, h, w, is_double):
        return 0 if mode == 0 else c * -(-w // 32) * -(-h // 16)

    def sr_data_residual(self, x, y, shifts, blur, kh, kw, k, c, h, w, s, tile, mask, halo, r, partials, n_reg,
                         fold, is_double, stream):
        self.calls.append(dict(entry="sr_data_residual", s=s, kh=kh, kw=kw, partials=partials, n_reg=n_reg,
                               fold=fold))
        return 0

    def sr_objective_gradient(self, x, r, shifts, blur, kh, kw, k, c, h, w, s, tile, mode, constants, p, decay,
                              grad, partials, fold, cost, is_double, stream):
        self.calls.append(dict(entry="sr_objective_gradient", s=s, kh=kh, kw=kw, mode=mode, partials=partials,
                               fold=fold, cost=cost))
        return 0


@pytest.fixture
def fake_library(monkeypatch):
    """The wrapper's launch path on CPU tensors, the library replaced by a
    :class:`_FakeLibrary` (no device, no stream)."""
    import contextlib
    import types
    fake = _FakeLibrary()
    monkeypatch.setattr(degrade, "_library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    return fake


def test_blur_larger_than_the_tap_table_is_handed_to_the_library(fake_library):
    """A blur past the composite table ((kh+1)(kw+1) > 1024) is no longer
    refused: the wrapper hands it to the library, whose DIRECT
    instantiations take it, with its size as it is."""
    x, y, shifts, constants = _wrapper_problem()
    degrade._launch(x, y, shifts, np.ones((32, 32)) / 1024.0, 2, "data_term_tv", constants, 0, 1.0,
                    (0, 0, 12, 16), False, None, False)
    assert [(c["entry"], c["s"], c["kh"], c["kw"]) for c in fake_library.calls] == [
        ("sr_data_residual", 2, 32, 32), ("sr_objective_gradient", 2, 32, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scale_past_the_residual_kernel_s_staging_is_handed_to_the_library(fake_library, dtype):
    """A scale whose footprint of x does not fit the residual kernel's shared
    memory (16 in float32, 11 in float64 and beyond, at 3x3) is no longer
    refused: the wrapper hands it to the library as it is."""
    rng = np.random.default_rng(82)
    x = torch.as_tensor(rng.random((1, 16, 32)), dtype=dtype)
    y = torch.as_tensor(rng.random((2, 1, 1, 2)), dtype=dtype)
    degrade._launch(x, y, [(0, 0), (1, 1)], np.ones((3, 3)) / 9.0, 16, "data_term", None, 0, 1.0,
                    (0, 0, 16, 32), False, None, False)
    assert [(c["entry"], c["s"], c["kh"], c["kw"]) for c in fake_library.calls] == [
        ("sr_data_residual", 16, 3, 3), ("sr_objective_gradient", 16, 3, 3)]


@pytest.mark.parametrize("mode", degrade.KERNEL_NAMES)
def test_one_evaluation_is_two_launches_sharing_the_counter_slot(fake_library, mode):
    """The residual launch, then the gradient launch that folds the cost: both
    get the same partials buffer and the slots past its partials as the
    fold's state (the ticket counter among them), the residual launch the
    number of the gradient launch's partials, and the gradient launch the cost."""
    x, y, shifts, constants = _wrapper_problem()
    kw = {"data_term": (None, 0), "data_term_tv": (constants, 0), "data_term_tv3d": (constants, 0),
          "data_term_btv": (constants, 3)}[mode]
    cost, grad, partials, fold = degrade._launch(x, y, shifts, None, 2, mode, kw[0], kw[1], 0.5,
                                                 (0, 0, 12, 16), False, None, False)
    residual, gradient = fake_library.calls
    assert (residual["entry"], gradient["entry"]) == ("sr_data_residual", "sr_objective_gradient")
    n_data = fake_library.sr_residual_blocks(2, 12, 16, 2)
    n_reg = fake_library.sr_gradient_blocks(degrade._MODE_OF[mode], 2, 12, 16, 1)
    assert partials.numel() == n_data + n_reg and partials.dtype == torch.float64
    assert residual["partials"] == gradient["partials"] == partials.data_ptr()
    assert residual["fold"] == gradient["fold"] == fold.data_ptr() == partials.data_ptr() + 8 * (n_data + n_reg)
    assert fold.numel() == degrade.FOLD_SLOTS == 1 and fold.dtype == torch.float64
    assert residual["n_reg"] == n_reg  # the slots the residual launch marks pending
    assert gradient["cost"] == cost.data_ptr() and cost.shape == () and grad.shape == x.shape
    assert degrade._MODE_OF[mode] == gradient["mode"]


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("mode", degrade.KERNEL_NAMES)
def test_evaluate_hands_fused_objective_s_arguments_to_one_evaluation(fake_library, mode, shard):
    """``_evaluate`` (what ``fused_objective`` calls on a CUDA tensor) picks
    the mode from the constants given, checks the problem and launches one
    evaluation, in shard mode where a shard argument is given; it returns the
    partials and the fold's state beside the cost and gradient."""
    x, y, shifts, constants = _wrapper_problem()
    kw = {"data_term": {}, "data_term_tv": {"tv_constants": constants},
          "data_term_tv3d": {"tv_constants": constants, "tv_use_3d": True},
          "data_term_btv": {"btv_constants": constants, "btv_range": 3, "btv_decay": 0.5}}[mode]
    if shard:
        kw.update(origin=(-2, 4), global_hw=(16, 24))
    before = dict(degrade.shard_launch_counts)
    cost, grad, partials, fold = degrade._evaluate(x, y, shifts, None, 2, **kw)
    residual, gradient = fake_library.calls
    assert gradient["mode"] == degrade._MODE_OF[mode] and residual["s"] == gradient["s"] == 2
    assert degrade.shard_launch_counts["shard_mode"] - before["shard_mode"] == int(shard)
    assert fold.data_ptr() == partials.data_ptr() + 8 * partials.numel() == gradient["fold"]
    assert cost.shape == () and grad.shape == x.shape


def test_wrapper_modes_and_range_are_the_kernel_source_s():
    import re
    text = (cuda_build.CSRC_DIR / "degrade.cu").read_text()
    enum = {name: int(n) for name, n in re.findall(r"MODE_(\w+) = (\d+)", re.search(r"enum Mode \{([^}]*)\}", text).group(1))}
    suffix = {"data_term": "DATA", "data_term_tv": "TV", "data_term_btv": "BTV", "data_term_tv3d": "TV3D"}
    assert {name: enum[suffix[name]] for name in degrade.KERNEL_NAMES} == degrade._MODE_OF
