"""The fused objective's mesh modes (plain versions) against the JAX kernel.

Shard mode: the objective on a halo-extended tile of a larger image, given
the tile's origin, the image's extent and the mask of the LR pixels the tile
owns. Spectral-halo mode: the last channel a read-only band of the next band
shard. The JAX side is ``pallas_data_term_cost_and_grad`` run as its own
tests run it on the CPU (interpret mode, static shifts, static origin), the
port's side the plain version that a CPU tensor reaches; float64, inputs from
seeded numpy. Gradients agree to 1e-8 (as ``tests/test_halo_pallas.py``
holds the JAX paths to each other), costs to 1e-5 relative because the Pallas
kernel accumulates its cost partials in float32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.ops.blur import gaussian_kernel_2d as jax_gaussian
from super_resolution_tpu.ops.pallas.degrade import pallas_data_term_cost_and_grad
from super_resolution_tpu_torch.ops.cuda.degrade import fused_objective, fused_objective_reference

torch.set_num_threads(1)

SCALE = 2
SHIFTS = np.asarray([(0.0, 0.0), (1.25, 0.5), (-1.0, 1.0), (0.5, -1.25)])
KERNEL = np.asarray(jax_gaussian(3, 1.0), dtype=np.float64)
TILING = (3, 3)
TILE = (16, 24)          # not square
HALO = 4                 # roundup_s(max(ceil(1.25) + 1 + 3 // 2, 3, s))


def _tile_problem(position, channels=1, seed=11):
    """The extended tile at ``position`` of a 3x3 tiling, as the tiled path
    makes it: rim from the neighbours, zero beyond the image; observations
    zero-padded by q/s; constants zero on the rim; the owned-pixel mask."""
    rng = np.random.default_rng(seed)
    th, tw = TILE
    hg, wg = TILING[0] * th, TILING[1] * tw
    x = rng.random((channels, hg, wg))
    x[:, 10:20, 30:44] = 0.25   # flat patch: sign(0) = 0
    y = rng.random((len(SHIFTS), channels, hg // SCALE, wg // SCALE))
    constants = rng.random((channels, hg, wg)) * 0.05
    q, ql = HALO, HALO // SCALE
    i, j = position
    xp = np.pad(x, [(0, 0), (q, q), (q, q)])
    x_tile = xp[:, i * th: (i + 1) * th + 2 * q, j * tw: (j + 1) * tw + 2 * q]
    y_tile = np.pad(y[:, :, i * th // SCALE: (i + 1) * th // SCALE, j * tw // SCALE: (j + 1) * tw // SCALE],
                    [(0, 0), (0, 0), (ql, ql), (ql, ql)])
    c_tile = np.pad(constants[:, i * th: (i + 1) * th, j * tw: (j + 1) * tw], [(0, 0), (q, q), (q, q)])
    mask = np.zeros(((th + 2 * q) // SCALE, (tw + 2 * q) // SCALE))
    mask[ql:-ql, ql:-ql] = 1.0
    return dict(x=np.ascontiguousarray(x_tile), y=y_tile, constants=c_tile, mask=mask,
                origin=(i * th - q, j * tw - q), global_hw=(hg, wg))


def _reg_kwargs(kind, constants, convert):
    if kind == "tv":
        return {"tv_constants": convert(constants)}
    if kind == "btv":
        return {"btv_constants": convert(constants), "btv_range": 3, "btv_decay": 0.6}
    return {}


def _assert_close(ours, theirs):
    (cost, grad), (cost_j, grad_j) = ours, theirs
    assert abs(float(cost) - float(cost_j)) <= 1e-5 * max(1.0, abs(float(cost_j)))
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), rtol=0, atol=1e-8)


@pytest.mark.parametrize("reg_kind", ["none", "tv", "btv"])
@pytest.mark.parametrize("position", [(0, 0), (1, 1), (2, 2)], ids=["corner", "inner", "far_corner"])
def test_plain_shard_mode_matches_jax_kernel(position, reg_kind):
    p = _tile_problem(position)
    theirs = pallas_data_term_cost_and_grad(
        jnp.asarray(p["x"]), jnp.asarray(p["y"]), SHIFTS, KERNEL, SCALE, tile=8, interpret=True,
        origin=p["origin"], global_hw=p["global_hw"], data_mask_lr=p["mask"],
        **_reg_kwargs(reg_kind, p["constants"], jnp.asarray))
    ours = fused_objective(
        torch.tensor(p["x"]), torch.tensor(p["y"]), SHIFTS, KERNEL, SCALE,
        origin=p["origin"], global_hw=p["global_hw"], data_mask_lr=torch.tensor(p["mask"]),
        **_reg_kwargs(reg_kind, p["constants"], torch.tensor))
    _assert_close(ours, theirs)


def test_plain_shard_mode_default_mask_matches_jax_kernel():
    """No mask given: the LR pixels inside the image count, rim included."""
    p = _tile_problem((0, 2))
    theirs = pallas_data_term_cost_and_grad(
        jnp.asarray(p["x"]), jnp.asarray(p["y"]), SHIFTS, KERNEL, SCALE, tile=8, interpret=True,
        origin=p["origin"], global_hw=p["global_hw"])
    ours = fused_objective(torch.tensor(p["x"]), torch.tensor(p["y"]), SHIFTS, KERNEL, SCALE,
                           origin=p["origin"], global_hw=p["global_hw"])
    _assert_close(ours, theirs)


@pytest.mark.parametrize("channels", [2, 5])
def test_plain_spectral_halo_matches_jax_kernel(channels):
    rng = np.random.default_rng(21 + channels)
    x = rng.random((channels, 20, 20))
    x[1:, 4:9, 4:9] = x[0, 4:9, 4:9]       # dz == 0 there
    y = rng.random((len(SHIFTS), channels, 10, 10))
    constants = rng.random((channels, 20, 20)) * 0.05
    y[:, -1] = 0.0
    constants[-1] = 0.0
    theirs = pallas_data_term_cost_and_grad(
        jnp.asarray(x), jnp.asarray(y), SHIFTS, KERNEL, SCALE, tile=4, interpret=True,
        tv_constants=jnp.asarray(constants), tv_use_3d=True, spectral_halo=True)
    ours = fused_objective(torch.tensor(x), torch.tensor(y), SHIFTS, KERNEL, SCALE,
                           tv_constants=torch.tensor(constants), tv_use_3d=True, spectral_halo=True)
    _assert_close(ours, theirs)
    # The halo band's own data residual would be D B M x - 0: it must be out.
    with_data = fused_objective(torch.tensor(x), torch.tensor(y), SHIFTS, KERNEL, SCALE,
                                tv_constants=torch.tensor(constants), tv_use_3d=True)
    assert float(with_data[0]) > float(ours[0])
    assert not torch.equal(with_data[1][-1], ours[1][-1])


@pytest.mark.parametrize("mode", ["none", "tv", "tv3d", "btv"])
def test_trivial_shard_arguments_change_nothing(mode):
    """origin (0, 0), the image's own extent and no mask: the unsharded plain result, exactly."""
    rng = np.random.default_rng(31)
    x = torch.tensor(rng.random((2, 32, 48)))
    y = torch.tensor(rng.random((4, 2, 16, 24)))
    constants = torch.tensor(rng.random((2, 32, 48)) * 0.05)
    kwargs = {"none": {}, "tv": {"tv_constants": constants}, "tv3d": {"tv_constants": constants, "tv_use_3d": True},
              "btv": {"btv_constants": constants, "btv_range": 3, "btv_decay": 0.6}}[mode]
    cost, grad = fused_objective_reference(x, y, SHIFTS, KERNEL, SCALE, **kwargs)
    for shard in ({"origin": (0, 0)}, {"global_hw": (32, 48)}, {"origin": (0, 0), "global_hw": (32, 48)}):
        cost_s, grad_s = fused_objective_reference(x, y, SHIFTS, KERNEL, SCALE, **kwargs, **shard)
        assert float(cost_s) == float(cost)
        assert torch.equal(grad_s, grad)


def test_shard_arguments_are_checked():
    x, y = torch.zeros(2, 8, 8, dtype=torch.float64), torch.zeros(1, 2, 4, 4, dtype=torch.float64)
    shifts = [(0.0, 0.0)]
    with pytest.raises(ValueError, match="scale-aligned"):
        fused_objective(x, y, shifts, None, 2, origin=(-3, 0), global_hw=(16, 16))
    with pytest.raises(ValueError, match="data_mask_lr shape"):
        fused_objective(x, y, shifts, None, 2, data_mask_lr=torch.ones(8, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="tv_use_3d"):
        fused_objective(x, y, shifts, None, 2, spectral_halo=True)
    with pytest.raises(ValueError, match="real band"):
        fused_objective(x[:1], y[:, :1], shifts, None, 2, tv_constants=x[:1], tv_use_3d=True, spectral_halo=True)
