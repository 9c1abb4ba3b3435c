"""The port's composite warp+blur tables against the JAX package's.

``composite_taps`` and ``composite_is_exact`` are the port's own copies
(``ops/cuda/degrade.py``) of the JAX package's functions
(``super_resolution_tpu/ops/pallas/degrade.py``); the CUDA residual and
gradient kernels build the same tables per frame on the device and use them
where no border intervenes. Held here: the tables and the exactness verdict
equal the JAX functions' on the same arguments (same float arithmetic, so
exactly), and the composite data term equals the port's plain two-stage data
term where the verdict is True and differs, in the band along the border
only, where it is False (float64, ``1e-12`` of the largest entry: summation
order).
"""

import numpy as np
import pytest
import torch

from super_resolution_tpu.ops.pallas.degrade import composite_is_exact as jcomposite_is_exact
from super_resolution_tpu.ops.pallas.degrade import composite_taps as jcomposite_taps

from super_resolution_tpu_torch.ops.blur import gaussian_kernel_2d
from super_resolution_tpu_torch.ops.cuda import degrade

RNG = np.random.default_rng(71)
KERNELS = {
    "none": None,
    "odd 3x3": gaussian_kernel_2d(3, 1.0),
    "even 4x4": RNG.random((4, 4)) / 8.0,
    "lopsided 4x3": RNG.random((4, 3)) / 6.0,
    "5x5": gaussian_kernel_2d(5, 1.5),
}
SHIFT_SETS = {
    "integer": [(0, 0), (1, 1), (0, 1), (1, 0)],
    "fractional, both signs": [(0, 0), (1.25, -0.5), (-2.0, 3.0), (-0.75, -1.5)],
    "large": [(0.5, -9.0), (8.75, 3.25)],
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("shift", [(0.0, 0.0), (1.25, -0.5), (-2.0, 3.0), (-0.375, -1.75)])
def test_composite_taps_match_jax(kernel, shift):
    ours = degrade.composite_taps(*shift, KERNELS[kernel])
    theirs = jcomposite_taps(*shift, KERNELS[kernel])
    for table, jtable in zip(ours, theirs):
        assert sorted(table) == sorted(jtable)


def test_composite_is_exact_matches_jax():
    verdicts = []
    for kernel in KERNELS.values():
        for shifts in SHIFT_SETS.values():
            for scale in (2, 3, 4):
                for hw in ((12, 24), (48, 36), (96, 120)):
                    if hw[0] % scale or hw[1] % scale:
                        continue
                    ours = degrade.composite_is_exact(shifts, kernel, scale, hw)
                    assert ours == jcomposite_is_exact(np.asarray(shifts, dtype=np.float64), kernel, scale, hw)
                    verdicts.append(ours)
    assert any(verdicts) and not all(verdicts)  # both answers were held


def _composite_data_term(x, y, shifts, kernel, scale):
    """s^2 sum_k ||D C_k x - y_k||^2 and its gradient through the composite
    tables alone: x and the upsampled residual read as zero outside the
    image, no border between warp and blur."""
    _, h, w = x.shape

    def apply(img, taps):
        out = np.zeros_like(img)
        for r, c, wt in taps:
            rows, cols = slice(max(0, -r), min(h, h - r)), slice(max(0, -c), min(w, w - c))
            src = (slice(None), slice(rows.start + r, rows.stop + r), slice(cols.start + c, cols.stop + c))
            out[:, rows, cols] += wt * img[src]
        return out

    cost, grad = 0.0, np.zeros_like(x)
    for k, (dx, dy) in enumerate(shifts):
        forward, adjoint = degrade.composite_taps(dx, dy, kernel)
        r = apply(x, forward)[:, ::scale, ::scale] - y[k]
        cost += float((r * r).sum())
        up = np.zeros_like(x)
        up[:, ::scale, ::scale] = r
        grad += apply(up, adjoint)
    return scale * scale * cost, 2.0 * scale * scale * grad


@pytest.mark.parametrize("shifts,kernel,scale,hw", [
    (SHIFT_SETS["integer"], "odd 3x3", 4, (32, 48)),
    ([(0.5, -0.5), (1.0, 0.25)], "odd 3x3", 4, (24, 32)),
    (SHIFT_SETS["fractional, both signs"], "odd 3x3", 2, (24, 30)),
    (SHIFT_SETS["fractional, both signs"], "lopsided 4x3", 3, (27, 33)),
    (SHIFT_SETS["large"], "5x5", 2, (40, 44)),
])
def test_composite_data_term_is_the_two_stage_one_where_exact(shifts, kernel, scale, hw):
    kern = KERNELS[kernel]
    rng = np.random.default_rng(72)
    x = rng.random((2, *hw))
    y = rng.random((len(shifts), 2, hw[0] // scale, hw[1] // scale))
    cost, grad = _composite_data_term(x, y, shifts, kern, scale)
    ref_cost, ref_grad = degrade.fused_objective_reference(torch.from_numpy(x), torch.from_numpy(y), shifts, kern, scale)
    diff = np.abs(grad - ref_grad.numpy())
    tol = 1e-12 * float(ref_grad.abs().max())
    if degrade.composite_is_exact(shifts, kern, scale, hw):
        assert abs(cost - float(ref_cost)) <= 1e-12 * float(ref_cost) and diff.max() <= tol
        return
    # Not exact: the two forms part, and only within reach of the border.
    assert diff.max() > 1e-6 * float(ref_grad.abs().max())
    reach = int(np.ceil(np.abs(np.asarray(shifts, dtype=np.float64)).max())) + 2 + max(np.shape(kern)) + scale
    assert diff[:, reach:-reach, reach:-reach].max() <= tol
