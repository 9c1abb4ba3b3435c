"""The fused objective's plain PyTorch version against the Pallas TPU kernel.

``pallas_data_term_cost_and_grad`` runs in interpret mode, float64 on the
CPU, at sizes that are not a multiple of its tile; the port's plain version
gets the same numpy inputs. Gradient within ``1e-10`` of its largest entry
(summation order); cost ``rtol 1e-6``, because the Pallas kernel accumulates
its cost in float32 whatever the input type. Each interpret-mode
configuration is compiled once.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.ops.pallas.degrade import pallas_data_term_cost_and_grad

from super_resolution_tpu_torch.ops.cuda import degrade

FRACTIONAL = [(0, 0), (1.25, -0.5), (-2, 3), (0.5, 0.5)]
INTEGER = [(0, 0), (1, 1), (0, 1), (-1, 2)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _problem(c, hw, scale, shifts, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((c, *hw))
    x[:, 1:6, 2:9] = 0.25  # equal neighbours: sign(0) must be 0
    x[:, :2, :2] = 0.75
    y = rng.random((len(shifts), c, hw[0] // scale, hw[1] // scale))
    kern = rng.random((3, 3))
    kern /= kern.sum()
    return x, y, np.asarray(shifts, dtype=np.float64), kern, rng.random((c, *hw))


@pytest.mark.parametrize(
    "mode,c,hw,scale,shifts,p",
    [
        (None, 3, (22, 26), 2, FRACTIONAL, 0),
        (None, 1, (20, 28), 4, FRACTIONAL, 0),
        ("tv", 1, (22, 26), 2, FRACTIONAL, 0),
        ("tv", 3, (20, 28), 4, INTEGER, 0),
        ("btv", 1, (22, 26), 2, FRACTIONAL, 2),
        ("btv", 3, (20, 28), 4, INTEGER, 3),
    ],
)
def test_plain_version_matches_pallas_interpret(mode, c, hw, scale, shifts, p):
    x, y, shifts, kern, constants = _problem(c, hw, scale, shifts, seed=40)
    kw = {}
    if mode == "tv":
        kw = dict(tv_constants=jnp.asarray(constants))
    elif mode == "btv":
        kw = dict(btv_constants=jnp.asarray(constants), btv_range=p, btv_decay=0.5)
    cost, grad = pallas_data_term_cost_and_grad(
        jnp.asarray(x), jnp.asarray(y), shifts, kern, scale, tile=16, interpret=True, **kw
    )
    ours = {}
    if mode == "tv":
        ours = dict(tv_constants=torch.from_numpy(constants))
    elif mode == "btv":
        ours = dict(btv_constants=torch.from_numpy(constants), btv_range=p, btv_decay=0.5)
    our_cost, our_grad = degrade.fused_objective(
        torch.from_numpy(x), torch.from_numpy(y), shifts, kern, scale, **ours
    )
    assert degrade.launch_counts == {name: 0 for name in degrade.KERNEL_NAMES}
    assert abs(float(our_cost) - float(cost)) <= 1e-6 * abs(float(cost))
    grad = np.asarray(grad)
    assert np.abs(our_grad.numpy() - grad).max() <= 1e-10 * np.abs(grad).max()
