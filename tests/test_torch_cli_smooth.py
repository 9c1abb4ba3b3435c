"""``super_resolve`` on a smooth, noise-free scene: the JAX CLI (x64) and the
port's (``--device cpu --dtype float64``) give the same estimate to 1e-9 and
the same PSNR to 1e-9 dB after 2 IRLS rounds x 10 ``linear_cg`` iterations.

A scene without noise has LR pixels that tie exactly, so the linear initial
estimate has neighbours that tie too, and the TV gradient takes ``sign(0) = 0``
there. A last-bit difference in the generated frames turns such a 0 into +-1
and moves the first gradient by about 1e-3; a noisy scene has no ties and
hides it. The blur must therefore round as XLA's CPU convolution does: one
fused multiply-add per tap (``ops/blur.py``)."""

import contextlib
import io

import cv2
import numpy as np
import pytest
import torch

import super_resolution_tpu.solvers as j_solvers
from super_resolution_tpu.cli import super_resolve as j_super_resolve
from super_resolution_tpu.ops.blur import blur as j_blur
from super_resolution_tpu.ops.blur import gaussian_kernel_2d

import super_resolution_tpu_torch.solvers as p_solvers
from super_resolution_tpu_torch.cli import super_resolve
from super_resolution_tpu_torch.ops.blur import blur

TOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch, tmp_path_factory):
    torch.set_num_threads(1)
    monkeypatch.setenv("SRTPU_COMPILE_CACHE", str(tmp_path_factory.getbasetemp() / "jax_cache"))
    monkeypatch.delenv("DISPLAY", raising=False)


def _smooth(side=32):
    yy, xx = np.mgrid[:side, :side]
    return (np.clip(0.5 + 0.3 * np.sin(xx / 3.0) * np.cos(yy / 4.0), 0, 1) * 255).astype(np.uint8)


def _estimates(monkeypatch, solvers_module, sink):
    """Record what ``IRLSMapSolver.solve`` returns, as a float64 array."""
    cls = solvers_module.IRLSMapSolver
    solve = cls.solve

    def recording(self, *args, **kwargs):
        result = solve(self, *args, **kwargs)
        array = getattr(result, "array", None)
        array = result.hidden_array if array is None else array
        sink.append(array.numpy() if isinstance(array, torch.Tensor) else np.asarray(array))
        return result

    monkeypatch.setattr(cls, "solve", recording)


def _psnr(text):
    return float(next(line for line in text.splitlines() if "score on result" in line).split(":")[1])


@pytest.mark.parametrize("rounds,iterations", [(1, 1), (2, 10)])
def test_smooth_scene_float64_estimates_agree(tmp_path, monkeypatch, rounds, iterations):
    cv2.imwrite(str(tmp_path / "smooth.png"), _smooth())
    (tmp_path / "shifts.txt").write_text("0 0\n1 1\n0 1\n1 0\n")
    argv = ["--data_path", str(tmp_path / "smooth.png"), "--generate_lr_images", "--motion_sequence_path",
            str(tmp_path / "shifts.txt"), "--upsampling_scale", "2", "--solver", "linear_cg",
            "--optimization_iterations", str(rounds), "--solver_iterations", str(iterations), "--evaluators", "psnr"]
    estimates, printed = {"jax": [], "port": []}, {}
    _estimates(monkeypatch, j_solvers, estimates["jax"])
    _estimates(monkeypatch, p_solvers, estimates["port"])
    for side, main, extra in (("jax", j_super_resolve.main, []),
                              ("port", super_resolve.main, ["--device", "cpu", "--dtype", "float64"])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(argv + extra) == 0
        printed[side] = out.getvalue()
    theirs, ours = estimates["jax"][-1], estimates["port"][-1]
    assert ours.dtype == theirs.dtype == np.float64
    assert ours.shape == theirs.reshape(ours.shape).shape
    assert np.abs(ours - theirs.reshape(ours.shape)).max() <= TOL
    assert abs(_psnr(printed["jax"]) - _psnr(printed["port"])) <= TOL


def test_blur_rounds_as_xla_convolution():
    """Each tap is one fused multiply-add onto the running sum, in row-major
    tap order: bit-equal to the JAX blur on seeded 8-bit data."""
    rng = np.random.default_rng(13)
    x = rng.integers(0, 256, (2, 24, 20)).astype(np.float64) / 255.0
    for size, sigma in ((3, 1.0), (5, 1.5)):
        kernel = gaussian_kernel_2d(size, sigma)
        ours = blur(torch.from_numpy(x), kernel).numpy()
        assert np.array_equal(ours, np.asarray(j_blur(x, kernel)))
