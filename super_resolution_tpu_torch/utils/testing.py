"""Test comparators mirroring ``src/util/test_util.{h,cpp}`` semantics.

The port's copy of the JAX package's ``utils/testing.py``: the same checks
and the same diagnostics, computed in numpy (float64). Inputs may be numpy
arrays, tensors on any device (read through ``.detach().cpu()``) or
``ImageData`` (through its ``array``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "matrices_equal",
    "matrices_equal_cropped_border",
    "images_equal",
]


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def matrices_equal(a, b, tolerance: float = 0.0, verbose: bool = True) -> bool:
    """Elementwise |a-b| <= tolerance with diagnostics (``test_util.cpp:23-81``)."""
    a = _numpy(a)
    b = _numpy(b)
    if a.shape != b.shape:
        if verbose:
            print(f"Matrix shapes differ: {a.shape} vs {b.shape}")
        return False
    diff = np.abs(a - b)
    max_diff = diff.max() if diff.size else 0.0
    ok = bool(max_diff <= tolerance) if tolerance > 0 else bool(np.array_equal(a, b))
    if not ok and verbose:
        loc = np.unravel_index(diff.argmax(), diff.shape)
        print(
            f"Matrices not equal: max diff {max_diff} at {loc} "
            f"(a={a[loc]}, b={b[loc]}, tolerance={tolerance})"
        )
    return ok


def matrices_equal_cropped_border(a, b, border: int, tolerance: float = 0.0) -> bool:
    """Compare excluding a border of the given width (``test_util.cpp:83-102``)."""
    a = _numpy(a)[..., border:-border or None, border:-border or None]
    b = _numpy(b)[..., border:-border or None, border:-border or None]
    return matrices_equal(a, b, tolerance)


def images_equal(img1, img2, tolerance: float = 1e-12) -> bool:
    """Per-channel image comparison (``test_util.cpp:104-134``)."""
    a = _as_chw(img1)
    b = _as_chw(img2)
    if a.shape != b.shape:
        print(f"Image shapes differ: {a.shape} vs {b.shape}")
        return False
    return all(matrices_equal(a[c], b[c], tolerance) for c in range(a.shape[0]))


def _as_chw(img) -> np.ndarray:
    arr = _numpy(getattr(img, "array", img))
    if arr.ndim == 2:
        arr = arr[None]
    return arr
