"""The port's device mesh, collectives, sharded state and sharded objectives.

All shards live on ``cpu`` (a device may hold several shards), float64,
inputs from seeded numpy, torch pinned to one thread. The sharded objectives
are held against the JAX package's single-device ``make_map_value_and_grad``
on the same arrays: cost within 1e-12 relative, gradient within 1e-10 (both
sides sum the same terms, in another order), and once against the JAX
package's own tiled objective on its virtual CPU devices, with that file's
tolerances (its Pallas kernel sums the cost in float32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from super_resolution_tpu.ops.btv import BilateralTotalVariationRegularizer as JBTV
from super_resolution_tpu.ops.tv import TotalVariationRegularizer as JTV
from super_resolution_tpu.parallel import make_mesh as jax_make_mesh
from super_resolution_tpu.parallel.halo import make_tiled_pallas_vg
from super_resolution_tpu.solvers import make_map_value_and_grad as jax_make_map_value_and_grad

from super_resolution_tpu_torch.ops.blur import gaussian_kernel_2d
from super_resolution_tpu_torch.ops.btv import BilateralTotalVariationRegularizer
from super_resolution_tpu_torch.ops.tv import TotalVariationRegularizer
from super_resolution_tpu_torch.parallel import (
    Mesh,
    Sharded,
    collectives,
    make_band_sharded_solver,
    make_band_sharded_vg,
    make_frame_sharded_vg,
    make_mesh,
    make_sharded_vg,
    make_tiled_vg,
    required_halo,
)
from super_resolution_tpu_torch.solvers.least_squares import minimize
from super_resolution_tpu_torch.solvers.objective import make_map_value_and_grad

SCALE = 2
KERNEL = gaussian_kernel_2d(3, 1.0)
INTEGER = [(0, 0), (1, 1), (-1, 0), (0, -1)]
FRACTIONAL = [(0, 0), (1.25, 0.5), (-0.75, 1.0), (0.5, -1.25)]
CPU = ["cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _problem(c=2, hw=(32, 48), k=4, seed=81):
    rng = np.random.default_rng(seed)
    x = rng.random((c, *hw))
    x[:, 6:12, 10:20] = 0.5   # flat patch: sign(0) = 0
    y = rng.random((k, c, hw[0] // SCALE, hw[1] // SCALE))
    w = rng.random((c, *hw))
    return x, y, w


def _regs(kind):
    """(the port's regularizers, the JAX package's) for one kind."""
    if kind == "tv":
        return [(TotalVariationRegularizer(), 0.05)], [(JTV(), 0.05)]
    if kind == "tv3d":
        return [(TotalVariationRegularizer(True), 0.05)], [(JTV(use_3d_total_variation=True), 0.05)]
    if kind == "btv":
        return [(BilateralTotalVariationRegularizer(2, 0.6), 0.05)], [(JBTV(2, 0.6), 0.05)]
    return [], []


# ---------------------------------------------------------------------- the mesh


def test_make_mesh_deals_shards_over_devices():
    mesh = make_mesh({"row": 2, "col": 2}, devices=CPU)
    assert isinstance(mesh, Mesh) and mesh.num_shards == 4 and mesh.shape == {"row": 2, "col": 2}
    assert [str(d) for d in mesh.devices] == ["cpu"] * 4
    assert mesh.coords(3) == {"row": 1, "col": 1} and mesh.shard_at({"row": 1, "col": 0}) == 2
    assert mesh.neighbor(0, "col", 1) == 1 and mesh.neighbor(0, "row", -1) is None
    assert mesh.neighbor(3, "col", 1, wrap=True) == 2 and mesh.neighbor(0, "band", 1) is None
    assert mesh.groups(["row"]) == [[0, 2], [1, 3]] and mesh.size("frame") == 1


def test_make_mesh_default_axis_and_absorbing_axis():
    assert make_mesh(None, devices=CPU * 3).shape == {"frame": 3}
    assert make_mesh({"frame": -1, "band": 2}, devices=CPU * 4).shape == {"frame": 2, "band": 2}
    with pytest.raises(ValueError, match="At most one mesh axis may be -1"):
        make_mesh({"frame": -1, "band": -1}, devices=CPU * 4)
    with pytest.raises(ValueError, match="4 devices not divisible by 3"):
        make_mesh({"frame": -1, "band": 3}, devices=CPU * 4)
    with pytest.raises(ValueError, match="positive"):
        make_mesh({"frame": 0}, devices=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh({"frame": 2})   # devices=None means the CUDA cards, and there is none here


# ------------------------------------------------------------------ collectives


@pytest.mark.parametrize("border", ["zero", "edge"])
@pytest.mark.parametrize("axes", [{"row": 2, "col": 2}, {"row": 2}, {"col": 3}, {"row": 2, "col": 2, "band": 2}])
def test_halo_scatter_sum_is_the_adjoint_of_halo_gather(axes, border):
    rng = np.random.default_rng(5)
    mesh = make_mesh(axes, devices=CPU)
    partition = {"band": 0, "row": 1, "col": 2}
    q = 3
    x = Sharded.from_global(mesh, torch.tensor(rng.random((2, 24, 36))), partition)
    gathered = collectives.halo_gather(mesh, x.parts, q, border)
    assert all(g.shape[-2:] == (x.parts[i].shape[-2] + 2 * q, x.parts[i].shape[-1] + 2 * q) for i, g in enumerate(gathered))
    g = [torch.tensor(rng.random(tuple(t.shape))) for t in gathered]
    scattered = collectives.halo_scatter_sum(mesh, g, q, border)
    lhs = sum(float((a * b).sum()) for a, b in zip(gathered, g))
    rhs = sum(float((a * b).sum()) for a, b in zip(x.parts, scattered))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("border", ["zero", "edge"])
def test_halo_gather_is_the_padded_image_cut_into_tiles(border):
    rng = np.random.default_rng(6)
    image = rng.random((1, 24, 36))
    mesh = make_mesh({"row": 2, "col": 3}, devices=CPU)
    q = 4
    tiles = collectives.halo_gather(mesh, Sharded.from_global(mesh, torch.tensor(image), {"row": 1, "col": 2}).parts, q, border)
    padded = np.pad(image, [(0, 0), (q, q), (q, q)], mode="constant" if border == "zero" else "edge")
    for shard, tile in enumerate(tiles):
        i, j = mesh.coords(shard)["row"], mesh.coords(shard)["col"]
        np.testing.assert_array_equal(tile.numpy(), padded[:, i * 12: i * 12 + 12 + 2 * q, j * 12: j * 12 + 12 + 2 * q])
    with pytest.raises(ValueError, match="exceeds the local tile size"):
        collectives.halo_gather(mesh, [t[..., :12, :12] for t in tiles], 13)


def test_spectral_halo_ring():
    rng = np.random.default_rng(7)
    mesh = make_mesh({"band": 3}, devices=CPU)
    cube = torch.tensor(rng.random((6, 4, 5)))
    parts = Sharded.from_global(mesh, cube, {"band": 0}).parts
    extended = collectives.spectral_halo_extend(mesh, parts)
    assert [tuple(e.shape) for e in extended] == [(3, 4, 5)] * 3
    assert torch.equal(extended[0][-1], cube[2]) and torch.equal(extended[1][-1], cube[4])
    assert torch.equal(extended[2][-1], cube[5])            # the last shard repeats its own last band: dz == 0
    grads = [torch.tensor(rng.random((3, 4, 5))) for _ in range(3)]
    back = collectives.spectral_halo_return(mesh, grads)
    assert torch.equal(back[0], grads[0][:2])               # nothing flows into the first band of all
    assert torch.equal(back[1][0], grads[1][0] + grads[0][2]) and torch.equal(back[1][1], grads[1][1])
    assert torch.equal(back[2][0], grads[2][0] + grads[1][2])


def test_psum_sums_in_shard_order_over_the_named_axes():
    mesh = make_mesh({"frame": 2, "band": 2}, devices=CPU)
    parts = [torch.tensor(float(10 ** i), dtype=torch.float64) for i in range(4)]
    assert [float(t) for t in collectives.psum(mesh, parts, ("frame",))] == [101.0, 1010.0, 101.0, 1010.0]
    assert [float(t) for t in collectives.psum(mesh, parts, ("frame", "band"))] == [1111.0] * 4


# ---------------------------------------------------------------- sharded state


def test_sharded_round_trip_and_algebra():
    rng = np.random.default_rng(8)
    mesh = make_mesh({"frame": 2, "row": 2, "col": 2}, devices=CPU)
    a_np, b_np = rng.random((2, 8, 12)), rng.random((2, 8, 12))
    partition = {"band": 0, "row": 1, "col": 2}
    a = Sharded.from_global(mesh, torch.tensor(a_np), partition)
    b = Sharded.from_global(mesh, torch.tensor(b_np), partition)
    assert a.partition == {"row": 1, "col": 2} and tuple(a.local(0).shape) == (2, 4, 6)
    assert a.local(0) is a.local(4)                         # replicated along `frame` on one device: one tensor
    assert torch.equal(a.to_global(), torch.tensor(a_np))
    two = a.new_full((), 2.0)
    out = torch.where(a > 0.5, -a + two * b, torch.abs(a - b) / 3.0)
    expected = np.where(a_np > 0.5, -a_np + 2.0 * b_np, np.abs(a_np - b_np) / 3.0)
    np.testing.assert_allclose(out.to_global().numpy(), expected, rtol=0, atol=1e-15)
    # <a, b> counts every pixel once, although `frame` holds two copies.
    dot = a.vdot(b)
    assert dot.partition == {} and abs(float(dot) - float((a_np * b_np).sum())) <= 1e-12
    assert bool(dot > 0.0) and isinstance(1.0 / dot, Sharded)
    with pytest.raises(ValueError, match="not divisible"):
        Sharded.from_global(mesh, torch.zeros(2, 7, 12), partition)
    with pytest.raises(NotImplementedError, match="dropped a partitioned dimension"):
        torch.sum(a)


@pytest.mark.parametrize("method", ["linear_cg", "cg", "lbfgs"])
@pytest.mark.parametrize("axes", [{"row": 2, "col": 2}, {"frame": 2, "band": 2}])
def test_minimize_on_sharded_state_matches_the_global_tensor(axes, method):
    x, y, w = _problem()
    regs, _ = _regs("tv")
    options = dict(method=method, max_iterations=10, gradient_norm_threshold=0.0, cost_decrease_threshold=0.0,
                   parameter_variation_threshold=0.0)
    plain = make_map_value_and_grad(y, FRACTIONAL, KERNEL, SCALE, regs, device="cpu", dtype=torch.float64)
    reference = minimize(plain.prepare((torch.tensor(w),)), torch.tensor(x), **options)
    vg = make_sharded_vg(make_mesh(axes, devices=CPU), y, FRACTIONAL, KERNEL, SCALE, regs, dtype=torch.float64)
    result = minimize(vg.prepare((vg.place(torch.tensor(w)),)), vg.place(torch.tensor(x)), **options)
    assert isinstance(result.x, Sharded) and isinstance(result.cost, Sharded)
    assert (result.iterations, result.num_evaluations) == (reference.iterations, reference.num_evaluations)
    assert float((result.x.to_global() - reference.x).abs().max()) <= 1e-10
    assert abs(float(result.cost) - float(reference.cost)) <= 1e-10 * abs(float(reference.cost))
    assert abs(float(result.grad_norm) - float(reference.grad_norm)) <= 1e-8


# ------------------------------------------------------------ sharded objectives


MESHES = [
    ("band", {"band": 2}, "tv"),
    ("band", {"band": 2}, "btv"),
    ("band", {"band": 2}, "none"),
    ("band", {"band": 4}, "tv3d"),
    ("frame", {"frame": 4}, "tv"),
    ("frame", {"frame": 2}, "tv3d"),
    ("frame", {"frame": 2, "band": 2}, "btv"),
    ("frame", {"frame": 2, "band": 2}, "tv3d"),
    ("tiled", {"row": 2, "col": 2}, "tv"),
    ("tiled", {"row": 2, "col": 2}, "btv"),
    ("tiled", {"row": 2, "col": 2}, "none"),
    ("tiled", {"row": 2}, "btv"),
    ("tiled", {"col": 2}, "tv"),
    ("tiled", {"row": 2, "col": 2, "band": 2}, "tv"),
    ("tiled", {"row": 2, "col": 2, "frame": 2}, "btv"),
]


@pytest.mark.parametrize("shifts", [INTEGER, FRACTIONAL], ids=["integer", "fractional"])
@pytest.mark.parametrize("family,axes,reg_kind", MESHES, ids=[f"{'x'.join(f'{k}{v}' for k, v in a.items())}-{r}" for _, a, r in MESHES])
def test_sharded_objective_matches_jax_single_device(family, axes, reg_kind, shifts):
    c = 4 if reg_kind == "tv3d" else 2
    x, y, w = _problem(c=c)
    regs, jax_regs = _regs(reg_kind)
    cost_j, grad_j = _jax_objective(y, shifts, jax_regs)(jnp.asarray(x), (jnp.asarray(w),) if regs else ())
    build = {"band": make_band_sharded_vg, "frame": make_frame_sharded_vg, "tiled": make_tiled_vg}[family]
    vg = build(make_mesh(axes, devices=CPU), y, shifts, KERNEL, SCALE, regs, dtype=torch.float64)
    weights = (torch.tensor(w),) if regs else ()
    direct = vg(torch.tensor(x), weights)                                    # global tensors in and out
    prepared = vg.prepare(tuple(vg.place(t) for t in weights))(vg.place(torch.tensor(x)))
    assert isinstance(prepared[1], Sharded) and prepared[1].partition == vg.place(torch.tensor(x)).partition
    for cost, grad in (direct, (prepared[0].local(0), prepared[1].to_global())):
        assert abs(float(cost) - float(cost_j)) <= 1e-12 * abs(float(cost_j))
        np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), rtol=0, atol=1e-10)


def _jax_objective(y, shifts, jax_regs):
    return jax_make_map_value_and_grad(
        jnp.asarray(y), jnp.asarray(np.asarray(shifts, dtype=np.float64)), jnp.asarray(KERNEL), SCALE, jax_regs, max_shift=4)


def test_tiled_objective_matches_jax_tiled_objective():
    """The same 2x2 tiling through the JAX package's tiled Pallas objective on 4 of its virtual CPU devices."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual JAX devices")
    x, y, w = _problem(c=1)
    regs, jax_regs = _regs("btv")
    shifts = np.asarray(INTEGER, dtype=np.float64)
    tiled = make_tiled_pallas_vg(
        jax_make_mesh({"row": 2, "col": 2}, jax.devices()[:4]), jnp.asarray(y), shifts, KERNEL, SCALE, jax_regs,
        image_shape=x.shape[-2:], pallas_tile=8)
    cost_j, grad_j = tiled.prepare((jnp.asarray(w),))(jnp.asarray(x))
    vg = make_tiled_vg(make_mesh({"row": 2, "col": 2}, devices=CPU), y, shifts, KERNEL, SCALE, regs, dtype=torch.float64)
    cost, grad = vg(torch.tensor(x), (torch.tensor(w),))
    assert vg.halo == tiled.halo == 4
    assert abs(float(cost) - float(cost_j)) <= 1e-5 * max(1.0, abs(float(cost_j)))
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), rtol=0, atol=1e-8)


def test_frame_mesh_takes_new_shifts_and_tiles_do_not():
    x, y, w = _problem()
    regs, _ = _regs("btv")
    plain = make_map_value_and_grad(y, INTEGER, KERNEL, SCALE, regs, device="cpu", dtype=torch.float64)
    cost_0, grad_0 = plain(torch.tensor(x), (torch.tensor(w),), torch.tensor(FRACTIONAL))
    vg = make_frame_sharded_vg(make_mesh({"frame": 4}, devices=CPU), y, INTEGER, KERNEL, SCALE, regs, dtype=torch.float64)
    cost, grad = vg(torch.tensor(x), (torch.tensor(w),), torch.tensor(FRACTIONAL))
    assert abs(float(cost) - float(cost_0)) <= 1e-12 * abs(float(cost_0))
    assert float((grad - grad_0).abs().max()) <= 1e-10
    tiled = make_tiled_vg(make_mesh({"row": 2}, devices=CPU), y, INTEGER, KERNEL, SCALE, regs, dtype=torch.float64)
    with pytest.raises(ValueError, match="cannot take new shifts"):
        tiled.prepare((torch.tensor(w),), torch.tensor(FRACTIONAL))


def test_halo_width_follows_the_shifts_the_kernel_and_the_regulariser():
    _, y, _ = _problem()
    mesh = make_mesh({"row": 2, "col": 2}, devices=CPU)
    assert required_halo(1.25, 3) == 4 and required_halo(0.0, 0) == 1
    assert make_tiled_vg(mesh, y, INTEGER, KERNEL, SCALE, dtype=torch.float64).halo == 4          # ceil(1) + 1 + 1 -> 4
    assert make_tiled_vg(mesh, y, [(0, 0)] * 4, None, SCALE, dtype=torch.float64).halo == 2       # the scale
    assert make_tiled_vg(mesh, y, [(0, 0)] * 4, None, SCALE, [(BilateralTotalVariationRegularizer(5, 0.5), 0.1)],
                         dtype=torch.float64).halo == 6                                         # P = 5, rounded up
    with pytest.raises(ValueError, match="exceeds the local tile size"):
        make_tiled_vg(mesh, y, [(0, 0), (14.5, 0), (0, 0), (0, 0)], KERNEL, SCALE, dtype=torch.float64)


def test_objectives_refuse_what_they_cannot_run():
    _, y, _ = _problem()
    tv3d, _ = _regs("tv3d")
    tv, _ = _regs("tv")
    args = (y, INTEGER, KERNEL, SCALE)
    with pytest.raises(ValueError, match="3D spectral TV is not supported on spatial meshes"):
        make_tiled_vg(make_mesh({"row": 2, "col": 2}, devices=CPU), *args, tv3d)
    with pytest.raises(ValueError, match="at most one regularizer"):
        make_band_sharded_vg(make_mesh({"band": 2}, devices=CPU), *args, tv + tv)
    with pytest.raises(ValueError, match="Unsupported regularizer type"):
        make_band_sharded_vg(make_mesh({"band": 2}, devices=CPU), *args, [(object(), 0.1)])
    with pytest.raises(ValueError, match="must have a 'band' axis"):
        make_band_sharded_vg(make_mesh({"frame": 2}, devices=CPU), *args)
    with pytest.raises(ValueError, match="takes a band mesh"):
        make_band_sharded_vg(make_mesh({"band": 2, "frame": 2}, devices=CPU), *args)
    with pytest.raises(ValueError, match="must have a 'frame' axis"):
        make_frame_sharded_vg(make_mesh({"band": 2}, devices=CPU), *args)
    with pytest.raises(ValueError, match="'row' or a 'col' axis"):
        make_tiled_vg(make_mesh({"band": 2}, devices=CPU), *args)
    with pytest.raises(ValueError, match="4 frames not divisible by frame axis 3"):
        make_frame_sharded_vg(make_mesh({"frame": 3}, devices=CPU), *args)
    with pytest.raises(ValueError, match="2 channels not divisible by band axis 4"):
        make_band_sharded_vg(make_mesh({"band": 4}, devices=CPU), *args)
    with pytest.raises(ValueError, match="scale-aligned tiles"):
        make_tiled_vg(make_mesh({"col": 16}, devices=CPU), *args)
    with pytest.raises(ValueError, match="Unknown mesh axes"):
        make_sharded_vg(make_mesh({"depth": 2}, devices=CPU), *args)


def test_band_sharded_solver_returns_global_tensors():
    x, y, w = _problem()
    regs, _ = _regs("tv")
    options = dict(method="linear_cg", max_iterations=6, gradient_norm_threshold=0.0, cost_decrease_threshold=0.0,
                   parameter_variation_threshold=0.0)
    solve = make_band_sharded_solver(make_mesh({"band": 2}, devices=CPU), y, INTEGER, KERNEL, SCALE, regs,
                                     dtype=torch.float64, **options)
    result = solve(torch.tensor(x), (torch.tensor(w),))
    plain = make_map_value_and_grad(y, INTEGER, KERNEL, SCALE, regs, device="cpu", dtype=torch.float64)
    reference = minimize(plain.prepare((torch.tensor(w),)), torch.tensor(x), **options)
    assert isinstance(result.x, torch.Tensor) and result.cost.ndim == 0
    assert float((result.x - reference.x).abs().max()) <= 1e-10 and result.iterations == reference.iterations
