"""The port as a package: what it imports, where it runs, what it carries over."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from super_resolution_tpu.models import ImageModel as JImageModel
from super_resolution_tpu.models import ImageModelParameters as JParameters
from super_resolution_tpu.motion import MotionShiftSequence as JSequence
from super_resolution_tpu.ops.btv import BilateralTotalVariationRegularizer as JBTV
from super_resolution_tpu.ops.tv import TotalVariationRegularizer as JTV
from super_resolution_tpu.solvers import IRLSMapSolver as JSolver
from super_resolution_tpu.solvers import IRLSMapSolverOptions as JOptions
from super_resolution_tpu.solvers.objective import make_map_value_and_grad as jmake

import super_resolution_tpu_torch as port
from super_resolution_tpu_torch import convert
from super_resolution_tpu_torch.ops.cuda import build, degrade
from super_resolution_tpu_torch.solvers.objective import make_map_value_and_grad

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "super_resolution_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "super_resolution_tpu", "cv2", "PIL", "osgeo")  # osgeo: GDAL's bindings


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_import_leaves_jax_and_the_jax_package_out():
    code = (
        "import sys\n"
        "import super_resolution_tpu_torch\n"
        "import super_resolution_tpu_torch.convert\n"
        "import super_resolution_tpu_torch.solvers, super_resolution_tpu_torch.ops.cuda.degrade\n"
        "import super_resolution_tpu_torch.image, super_resolution_tpu_torch.utils.data_loader\n"
        "import super_resolution_tpu_torch.utils.visualization, super_resolution_tpu_torch.utils.image_io\n"
        "import super_resolution_tpu_torch.spectral.envi, super_resolution_tpu_torch.native\n"
        "import super_resolution_tpu_torch.wavelet, super_resolution_tpu_torch.solvers.admm\n"
        "import super_resolution_tpu_torch.solvers.shift_add\n"
        "import super_resolution_tpu_torch.cli.super_resolve, super_resolution_tpu_torch.cli.generate_data\n"
        "import super_resolution_tpu_torch.cli.shift_add_fusion, super_resolution_tpu_torch.cli.visualize_image\n"
        "import super_resolution_tpu_torch.video, super_resolution_tpu_torch.utils.jpeg\n"
        "import super_resolution_tpu_torch.utils.profiling, super_resolution_tpu_torch.utils.testing\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'super_resolution_tpu', 'cv2', 'PIL')]\n"
        "assert not bad, bad\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'triton']\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"
    assert "libgdal" not in path.read_text(), f"{path}: loads GDAL (the tests' TIFF writer, not the port's)"


def test_port_uses_no_library_kernel_for_warp_or_blur():
    """No ``conv2d`` / ``grid_sample`` (cuDNN would run a float32 blur in TF32)
    and no ``torch.compile`` anywhere in the port: the objective on the card is
    the hand-written kernels, and the plain version is shifted slices."""
    for path in PORT_FILES:
        if path.name == "chip_smoke.py":
            continue
        tree = ast.parse(path.read_text())
        called = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)} | {
            n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        assert not called & {"conv2d", "grid_sample", "compile", "conv_transpose2d"}, path


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    model = port.ImageModel.create(port.ImageModelParameters(scale=2))
    lows = [np.zeros((1, 4, 4))] * 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.IRLSMapSolver(port.IRLSMapSolverOptions(), model, lows)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_map_value_and_grad(np.zeros((2, 1, 4, 4)), np.zeros((2, 2)), None, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lr_stack(np.zeros((2, 1, 4, 4)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.irls_solver({"scale": 2}, {}, [], np.zeros((2, 1, 4, 4)))
    # Asking for the CPU is the only way onto the CPU.
    port.IRLSMapSolver(port.IRLSMapSolverOptions(), model, lows, device="cpu")


def test_image_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    from super_resolution_tpu_torch.cli import super_resolve
    from super_resolution_tpu_torch.image import ImageData
    from super_resolution_tpu_torch.utils.data_loader import load_image
    from super_resolution_tpu_torch.utils.image_io import write_image

    path = str(tmp_path / "image.png")
    write_image(path, np.zeros((8, 8), np.uint8))
    assert super_resolve.build_parser().parse_args(["--data_path", path]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ImageData(np.zeros((4, 4)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_image(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        super_resolve.main(["--data_path", path, "--generate_lr_images"])
    # Asking for the CPU is the only way onto the CPU.
    assert load_image(path, device="cpu").device.type == "cpu"
    assert ImageData(np.zeros((4, 4)), device="cpu").device.type == "cpu"


def test_video_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    from super_resolution_tpu_torch.video import VideoLoader, VideoSuperResolver

    with pytest.raises(RuntimeError, match="no CUDA device"):
        VideoLoader()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VideoSuperResolver()
    # Asking for the CPU is the only way onto the CPU.
    assert VideoLoader(device="cpu").frame_stack().device.type == "cpu"
    assert VideoSuperResolver(device="cpu").device.type == "cpu"


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(80)
    x = torch.from_numpy(rng.random((1, 8, 8)))
    y = torch.from_numpy(rng.random((2, 1, 4, 4)))
    shifts = [(0, 0), (0.5, 1)]
    degrade.reset_launch_counts()
    for kw in ({}, {"tv_constants": torch.ones_like(x)},
               {"tv_constants": torch.ones_like(x), "tv_use_3d": True},
               {"btv_constants": torch.ones_like(x), "btv_range": 2, "btv_decay": 0.5}):
        cost, grad = degrade.fused_objective(x, y, shifts, None, 2, **kw)
        ref_cost, ref_grad = degrade.fused_objective_reference(x, y, shifts, None, 2, **kw)
        assert float(cost) == float(ref_cost) and torch.equal(grad, ref_grad)
    assert degrade.launch_counts == {"data_term": 0, "data_term_tv": 0, "data_term_btv": 0, "data_term_tv3d": 0}
    assert degrade.shift_source_counts == {"device": 0, "host": 0}


def test_kernel_sources_are_in_the_package_and_build_is_lazy():
    source = build.CSRC_DIR / "degrade.cu"
    text = source.read_text()
    for entry in ("sr_data_residual", "sr_objective_gradient"):
        assert entry in text
    assert "sr_reduce_cost" not in text  # the gradient launch folds the cost
    assert "torch/extension.h" not in text
    assert "arch=compute_90a,code=sm_90a" in " ".join(build.NVCC_FLAGS)
    assert build.build_dir() == REPO / "super_resolution_tpu_torch" / "_build"
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "super_resolution_tpu_torch/_build/" in ignored


# --- state carried across -----------------------------------------------------

SHIFTS = [(0, 0), (1, 1), (0.5, -0.25), (1, 0)]


def _jax_state(reg):
    rng = np.random.default_rng(90)
    yy, xx = np.mgrid[:24, :28]
    gt = np.clip(0.5 + 0.3 * np.sin(xx / 3.0) * np.cos(yy / 4.0) + 0.05 * rng.random((24, 28)), 0, 1)[None]
    jparams = JParameters(scale=2, blur_radius=3, blur_sigma=1.0, motion_sequence=JSequence(SHIFTS))
    jmodel = JImageModel.create(jparams)
    stack = np.stack([np.asarray(jmodel.apply(jnp.asarray(gt), k)) for k in range(len(SHIFTS))])
    jopts = JOptions(least_squares_solver="linear_cg", max_num_irls_iterations=2,
                     max_num_solver_iterations=12, pallas_tile=(512, 1024), fused_irls=False)
    jreg = JTV() if reg == "tv" else JBTV(2, 0.5)
    spec = ("tv", {"use_3d": False}, 0.01) if reg == "tv" else (
        "btv", {"scale_range": 2, "spatial_decay": 0.5}, 0.01)
    # Handed over as plain dicts and numpy arrays.
    params_dict = {f.name: getattr(jparams, f.name) for f in dataclasses.fields(jparams)}
    params_dict["motion_sequence"] = jparams.motion_sequence.as_array()
    x0 = np.repeat(np.repeat(stack[0], 2, axis=-2), 2, axis=-1)
    weights = [rng.random(gt.shape) + 0.5]
    return jmodel, jopts, jreg, params_dict, dataclasses.asdict(jopts), spec, stack, x0, weights


@pytest.mark.parametrize("reg", ["tv", "btv"])
def test_convert_round_trip_same_cost_gradient_and_solve(reg):
    jmodel, jopts, jreg, params_dict, opts_dict, spec, stack, x0, weights = _jax_state(reg)
    kw = dict(device="cpu", dtype=torch.float64)

    params = convert.image_model_parameters(params_dict)
    np.testing.assert_array_equal(params.motion_sequence.as_array(), np.asarray(SHIFTS, dtype=float))
    opts = convert.irls_options(opts_dict)
    assert opts.least_squares_solver == "linear_cg" and opts.max_num_solver_iterations == 12
    assert not hasattr(opts, "pallas_tile")
    regs = convert.regularizers([spec])

    # Same cost and gradient at the initial estimate under given IRLS weights.
    model = port.ImageModel.create(params)
    vg = make_map_value_and_grad(convert.lr_stack(stack, **kw), params.motion_sequence.as_array(),
                                 model.blur_operator.kernel, params.scale, regs, **kw)
    cost, grad = vg(convert.hr_image(x0, **kw), convert.irls_weights(weights, **kw))
    shifts = np.asarray(SHIFTS, dtype=float)
    jvg = jmake(jnp.asarray(stack), jnp.asarray(shifts), jnp.asarray(jmodel.blur_operator.kernel), 2,
                [(jreg, 0.01)], static_shifts=shifts)
    jcost, jgrad = jvg(jnp.asarray(x0), (jnp.asarray(weights[0]),))
    assert abs(float(cost) - float(jcost)) <= 1e-10 * float(jcost)
    assert np.abs(grad.numpy() - np.asarray(jgrad)).max() <= 1e-10 * np.abs(np.asarray(jgrad)).max()

    # Same solve.
    solver = convert.irls_solver(params_dict, opts_dict, [spec], stack, **kw)
    jsolver = JSolver(jopts, jmodel, [jnp.asarray(f) for f in stack])
    jsolver.add_regularizer(jreg, 0.01)
    x = solver.solve(x0)
    jx = np.asarray(jsolver.solve(jnp.asarray(x0)))
    assert np.abs(x.numpy() - jx).max() < 1e-6


def test_convert_names_what_it_cannot_carry():
    opts = dataclasses.asdict(JOptions())
    assert set(convert.DROPPED_OPTION_FIELDS) <= set(opts)
    assert dataclasses.asdict(convert.irls_options(opts)) == {
        k: v for k, v in opts.items() if k not in convert.DROPPED_OPTION_FIELDS
    }
    # Motion refinement is carried, not dropped.
    carried = convert.irls_options({**opts, "refine_motion_every": 2, "refine_motion_iterations": 4})
    assert (carried.refine_motion_every, carried.refine_motion_iterations) == (2, 4)
    assert carried.refine_motion_delta_threshold == opts["refine_motion_delta_threshold"]
    with pytest.raises(ValueError, match="warp_speed"):
        convert.irls_options({**opts, "warp_speed": 9})
    with pytest.raises(ValueError, match="focal_length"):
        convert.image_model_parameters({"scale": 2, "focal_length": 1.0})
    with pytest.raises(ValueError, match="wavelet"):
        convert.regularizers([("wavelet", {}, 0.1)])
    with pytest.raises(ValueError, match="gamma"):
        convert.regularizers([("tv", {"gamma": 1}, 0.1)])
    (reg3d, lam3d), = convert.regularizers([("tv", {"use_3d": True}, 0.1)])
    assert reg3d.use_3d is True and lam3d == 0.1
    jreg3d = JTV(use_3d_total_variation=True)
    cube = np.random.default_rng(91).random((3, 6, 7))
    np.testing.assert_allclose(reg3d.residuals(torch.from_numpy(cube)).numpy(),
                               np.asarray(jreg3d.residuals(jnp.asarray(cube))), rtol=0, atol=1e-12)
    assert convert.lr_stack(np.zeros((3, 4, 4)), device="cpu").shape == (3, 1, 4, 4)
    with pytest.raises(ValueError):
        convert.lr_stack(np.zeros((4, 4)), device="cpu")
