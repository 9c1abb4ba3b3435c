"""The port's profiling utilities (counterparts of tests/test_profiling.py's)
and its test comparators against the JAX package's: the same booleans on
equal, unequal, cropped and shape-mismatched inputs, numpy arrays, tensors
and ``ImageData`` alike."""

import json
import os

import numpy as np
import pytest
import torch

from super_resolution_tpu.image import ImageData as JImageData
from super_resolution_tpu.utils import testing as jtesting

from super_resolution_tpu_torch.image import ImageData
from super_resolution_tpu_torch.utils import testing
from super_resolution_tpu_torch.utils.profiling import WallClock, device_time, trace


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_wall_clock(capsys):
    with WallClock("test", verbose=False) as t:
        _ = torch.arange(10).sum()
    assert t.elapsed >= 0.0
    with WallClock("spoken"):
        pass
    assert capsys.readouterr().out.startswith("spoken: ")


def test_device_time():
    calls = []
    secs = device_time(lambda x: calls.append((x * 2).sum()), torch.arange(1000.0), iterations=5, warmup=1)
    assert secs > 0 and len(calls) == 6


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir) as where:
        assert where == log_dir
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    matmul = [e for e in events if "matmul" in str(e.get("name", "")) and e.get("ph") == "X"]
    assert matmul and all(float(e["dur"]) >= 0.0 for e in matmul)


def _pairs():
    rng = np.random.default_rng(12)
    a = rng.random((3, 10, 12))
    near = a + 1e-9
    border = a.copy()
    border[:, 0, :] += 1.0  # differs only in the outermost rows
    return {
        "equal": (a, a.copy(), {}),
        "unequal": (a, a + 0.5, {}),
        "within_tolerance": (a, near, {"tolerance": 1e-8}),
        "outside_tolerance": (a, near, {"tolerance": 1e-10}),
        "shape_mismatch": (a, a[:, :9], {}),
        "border_only": (a, border, {}),
    }


@pytest.mark.parametrize("case", list(_pairs()))
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_comparators_answer_as_the_jax_ones(case, as_tensor):
    a, b, kw = _pairs()[case]
    ta, tb = (torch.from_numpy(a), torch.from_numpy(b)) if as_tensor else (a, b)
    assert testing.matrices_equal(ta, tb, verbose=False, **kw) == jtesting.matrices_equal(a, b, verbose=False, **kw)
    if a.shape == b.shape:
        for border in (1, 2):
            assert (testing.matrices_equal_cropped_border(ta, tb, border, **kw)
                    == jtesting.matrices_equal_cropped_border(a, b, border, **kw))
    tol = kw.get("tolerance", 1e-12)
    assert testing.images_equal(ta, tb, tol) == jtesting.images_equal(a, b, tol)
    assert testing.images_equal(ta[0], tb[0], tol) == jtesting.images_equal(a[0], b[0], tol)


def test_comparators_take_image_data_and_print_the_same_diagnostics(capsys):
    rng = np.random.default_rng(13)
    a = rng.random((2, 6, 7))
    b = a.copy()
    b[1, 3, 4] += 0.25
    ours = testing.images_equal(ImageData(a, channel_major=True, device="cpu", dtype=torch.float64),
                                ImageData(b, channel_major=True, device="cpu", dtype=torch.float64))
    mine = capsys.readouterr().out
    theirs = jtesting.images_equal(JImageData(a, channel_major=True), JImageData(b, channel_major=True))
    assert ours is theirs is False and mine == capsys.readouterr().out
    assert mine.startswith("Matrices not equal: max diff 0.25 at ")
    testing.matrices_equal(a, a[:, :5])
    mine = capsys.readouterr().out
    jtesting.matrices_equal(a, a[:, :5])
    assert mine == capsys.readouterr().out == "Matrix shapes differ: (2, 6, 7) vs (2, 5, 7)\n"
